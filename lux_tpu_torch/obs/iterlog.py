"""Per-iteration run telemetry: the ``IterationRecorder`` hook, the
counterpart of ``lux_tpu/obs/iterlog.py``.

Every executor ``run()`` drives one recorder. The contract that keeps a
run's launches and host syncs as they are with telemetry off: engines
call ``flush(iters_done)`` only at points where the host has already
waited for the card (after ``torch.cuda.synchronize`` once per flush
window in the pull family's loop, after the per-iteration counter read
of the push and GAS fixpoints, which waits for the stream) — the
recorder itself never touches device values, and every clock read comes
after that wait, so a window never closes on work still queued. A flush
window spanning n iterations amortizes its wall time over those n
records.

When no knob is set (``LUX_METRICS``, ``LUX_TRACE``, ``LUX_FLIGHT_DIR``,
``LUX_ENGOBS``, ``LUX_LEDGER_DIR``), ``recorder_for()`` returns the
shared ``NULL_RECORDER`` whose every method is a no-op: the executors
then add no synchronisation and no launch.

GTEPS is defined here, once, for every engine and for the CLIs: edges
traversed / iteration time (``gteps()``).
"""

from __future__ import annotations

import time

from lux_tpu_torch.obs import engobs, flight, ledger, metrics, trace
from lux_tpu_torch.obs.spans import SPAN_BUCKETS
from lux_tpu_torch.utils import flags


def gteps(ne: int, iters: int, seconds: float) -> float:
    """Traversed-edges-per-second in units of 1e9: ``ne`` edges visited
    per iteration, ``iters`` iterations, over ``seconds`` of iteration
    (execute) time. The single GTEPS definition for all engines."""
    if seconds <= 0 or iters <= 0:
        return 0.0
    return ne * iters / seconds / 1e9


class _NullRecorder:
    """Disabled-mode recorder: every hook is a constant no-op."""

    enabled = False

    def start(self):
        return self

    def record_compile(self, seconds):
        pass

    def flush(self, iters_done, frontier_sizes=None, active_edges=None,
              residual=None, sparse_flags=None, directions=None):
        pass

    def record_phase(self, iters_done, exchange_s, compute_s, detail=None,
                     frontier=None, branch=None):
        pass

    def set_exchange_bytes(self, per_iter, note=None, parts=None):
        pass

    def set_overlap(self, enabled):
        pass

    def set_useful_bytes(self, per_iter, ratio, note=None):
        pass

    def set_hbm_bytes(self, per_iter):
        pass

    def finish(self):
        return None

    def summary(self):
        return None


NULL_RECORDER = _NullRecorder()


def telemetry_enabled() -> bool:
    # The flight recorder needs iteration records flowing even with no
    # metrics path / trace writer: an armed LUX_FLIGHT_DIR turns the
    # recorders on so in-flight sweeps appear in postmortems. Likewise
    # LUX_ENGOBS: a phase-fenced run exists to be recorded. And an armed
    # run ledger: every run must land a runrec.v1 observation.
    return bool(flags.get("LUX_METRICS")) or trace.enabled() \
        or flight.enabled() or engobs.enabled() or ledger.enabled()


def recorder_for(engine: str, graph, program=None):
    """Recorder for one ``run()`` call: a live ``IterationRecorder`` when
    telemetry is on, else the shared no-op ``NULL_RECORDER``."""
    if not telemetry_enabled():
        return NULL_RECORDER
    prog = type(program).__name__ if program is not None else ""
    return IterationRecorder(
        engine, int(graph.nv), int(graph.ne), program=prog,
    )


def engine_label(ex) -> str:
    """Short engine name for an executor instance (telemetry labels)."""
    name = type(ex).__name__
    return {
        "PullExecutor": "pull",
        "TiledPullExecutor": "tiled",
        "ShardedPullExecutor": "pull_sharded",
        "ShardedTiledExecutor": "tiled_sharded",
        "PushExecutor": "push",
        "ShardedPushExecutor": "push_sharded",
        "MultiSourcePushExecutor": "push_multi",
        "ShardedMultiSourcePushExecutor": "push_multi_sharded",
        "IncrementalExecutor": "incremental",
        "AdaptiveExecutor": "gas",
        "MultiSourceGasExecutor": "gas_multi",
    }.get(name, name.lower())


def note_compile_seconds(ex, seconds: float):
    """Stash warmup/compile seconds on an executor so the next ``run()``
    can report them (warmup happens before the recorder exists)."""
    ex._obs_compile_s = getattr(ex, "_obs_compile_s", 0.0) + float(seconds)


def consume_compile_seconds(ex) -> float:
    s = getattr(ex, "_obs_compile_s", 0.0)
    ex._obs_compile_s = 0.0
    return s


class IterationRecorder:
    """Accumulates per-iteration records for one run; emits trace spans
    and metrics at flush granularity; hands the summary to report.py."""

    enabled = True

    def __init__(self, engine: str, nv: int, ne: int, program: str = ""):
        self.engine = engine
        self.nv = nv
        self.ne = ne
        self.program = program
        self.compile_s = 0.0
        self.execute_s = 0.0
        self.exchange_bytes_per_iter = 0
        self.exchange_note = None
        self.parts = None
        self.useful_bytes_per_iter = None
        self.useful_ratio = None
        self.hbm_bytes_per_iter = None
        self.overlap = False
        self.phase_s = {"exchange": 0.0, "compute": 0.0}
        self.crossovers = []
        self.iterations = []
        self._iters = 0
        self._flushes = 0
        self._t0 = None
        self._t_last = None
        self._last_branch = None
        self._finished = False
        # Metric handles resolved once per run, not once per flush: each
        # registry factory call takes the registry lock (LUX008).
        lbl = {"engine": engine}
        self._m_compile_s = metrics.histogram("lux_compile_seconds", lbl)
        self._m_exch_per_iter = metrics.gauge(
            "lux_exchange_bytes_per_iter", lbl)
        self._m_iters_total = metrics.counter("lux_iterations_total", lbl)
        self._m_iter_s = metrics.histogram("lux_iteration_seconds", lbl)
        self._m_useful_per_iter = metrics.gauge(
            "lux_exchange_useful_bytes_per_iter", lbl)
        self._m_useful_ratio = metrics.gauge(
            "lux_exchange_useful_ratio", lbl)
        self._m_frontier_density = metrics.gauge(
            "lux_frontier_density", lbl)
        # Fenced engine phases live in the sub-millisecond decades —
        # share the span histogram family (and its fine buckets).
        self._h_phase = {
            ph: metrics.histogram(
                "lux_span_seconds", {"span": f"{engine}.{ph}"},
                buckets=SPAN_BUCKETS)
            for ph in ("exchange", "compute")
        }

    def start(self):
        self._t0 = self._t_last = time.perf_counter()
        trace.begin(f"{self.engine}.run", cat="run",
                    args={"program": self.program, "nv": self.nv,
                          "ne": self.ne})
        return self

    def record_compile(self, seconds):
        """Credit compile/warmup time, kept out of every flush window."""
        seconds = float(seconds)
        if seconds <= 0:
            return
        now = time.perf_counter()
        if self._t_last is not None and now - seconds >= self._t0:
            trace.pair(f"{self.engine}.compile", now - seconds, now,
                       cat="compile")
        self.compile_s += seconds
        if self._t_last is not None:
            self._t_last = now
        self._m_compile_s.observe(seconds)

    def set_exchange_bytes(self, per_iter, note=None, parts=None):
        self.exchange_bytes_per_iter = int(per_iter)
        self.exchange_note = note
        if parts is not None:
            self.parts = int(parts)
        self._m_exch_per_iter.set(per_iter)

    def set_overlap(self, enabled):
        """Mark the run's exchange as compute-overlapped (``lux_tpu``'s
        compact path issues the collective before the local-edge
        contribution; the port keeps the mark so records compare, though
        one stream serialises the two). Phase-fenced runs then
        report ``exchange_hidden_frac`` — the fraction of measured
        exchange wall that concurrent compute could cover,
        ``min(exchange_s, compute_s) / exchange_s``. The fenced split
        serializes the phases, so this is the overlap *budget* the fused
        program can exploit, not a direct measurement of it."""
        self.overlap = bool(enabled)

    def set_useful_bytes(self, per_iter, ratio, note=None):
        """Exchange-ledger useful-bytes: of ``exchange_bytes_per_iter``,
        how much lands on rows some receiving part actually reads
        (engobs.useful_exchange over the plan's remote-read index)."""
        self.useful_bytes_per_iter = int(per_iter)
        self.useful_ratio = float(ratio)
        self._m_useful_per_iter.set(per_iter)
        self._m_useful_ratio.set(ratio)
        engobs.note(self.engine, useful_bytes_per_iter=int(per_iter),
                    useful_ratio=float(ratio),
                    exchange_bytes_per_iter=self.exchange_bytes_per_iter)

    def set_hbm_bytes(self, per_iter):
        """First-order HBM bytes moved per iteration (model, not
        measurement) — the roofline ledger's numerator."""
        self.hbm_bytes_per_iter = int(per_iter)

    def _branch_into(self, rec, branch, frontier):
        """Shared frontier/branch bookkeeping for record_phase and the
        sparse_flags flush path: frontier density plus dense/sparse
        crossover records (the ROADMAP item-3 direction signal)."""
        if frontier is not None:
            frontier = int(frontier)
            rec["frontier"] = frontier
            if self.nv:
                rec["frontier_density"] = frontier / self.nv
        if branch is not None:
            rec["branch"] = branch
            if self._last_branch is not None and branch != self._last_branch:
                rec["crossover"] = f"{self._last_branch}->{branch}"
                self.crossovers.append({
                    "iter": rec["iter"], "from": self._last_branch,
                    "to": branch,
                    "frontier_density": rec.get("frontier_density"),
                })
            self._last_branch = branch

    def record_phase(self, iters_done, exchange_s, compute_s, detail=None,
                     frontier=None, branch=None):
        """Record one phase-fenced iteration (LUX_ENGOBS runs): the
        exchange (collective) vs local-compute wall split measured by the
        executor's ``phase_step``. Call right after the phase brackets'
        final host sync; ``iters_done`` is cumulative."""
        iters_done = int(iters_done)
        n = iters_done - self._iters
        if n <= 0:
            return
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        self.execute_s += dt
        self._flushes += 1
        self._iters = iters_done
        exchange_s = float(exchange_s)
        compute_s = float(compute_s)
        self.phase_s["exchange"] += exchange_s
        self.phase_s["compute"] += compute_s
        phased = exchange_s + compute_s
        rec = {
            "iter": iters_done - 1,
            "t_iter_s": dt / n,
            "t_cum_s": self.execute_s,
            "flush_span": self._flushes,
            "active_edges": self.ne,
            "gteps": gteps(self.ne, 1, phased if phased > 0 else dt),
            "exchange_s": exchange_s,
            "compute_s": compute_s,
            "exchange_frac": exchange_s / phased if phased > 0 else 0.0,
        }
        if self.overlap:
            rec["exchange_hidden_frac"] = (
                min(exchange_s, compute_s) / exchange_s
                if exchange_s > 0 else 1.0)
        self._branch_into(rec, branch, frontier)
        if detail:
            rec["phase_detail"] = {
                k: v for k, v in detail.items()
                if isinstance(v, (int, float)) and k not in
                ("exchange", "loadTime")
            }
        self.iterations.append(rec)
        if flight.enabled():
            flight.note_iteration({
                "engine": self.engine, "program": self.program, **rec,
            })
        # Phase brackets run exchange first: backfill the two spans from
        # the sync stamp, and stream the per-iteration series as Chrome
        # counter tracks.
        trace.pair(f"{self.engine}.exchange", now - dt,
                   now - dt + exchange_s, cat="phase")
        trace.pair(f"{self.engine}.compute", now - compute_s, now,
                   cat="phase")
        counters = {"exchange_ms": exchange_s * 1e3,
                    "compute_ms": compute_s * 1e3}
        if "frontier_density" in rec:
            counters["frontier_density"] = rec["frontier_density"]
            self._m_frontier_density.set(rec["frontier_density"])
        trace.counter(f"{self.engine}.phases", counters, cat="phase")
        self._h_phase["exchange"].observe(exchange_s)
        self._h_phase["compute"].observe(compute_s)
        self._m_iters_total.inc(n)
        self._m_iter_s.observe(dt / n)
        engobs.note(self.engine, iter=iters_done - 1,
                    exchange_s=exchange_s, compute_s=compute_s,
                    exchange_frac=rec["exchange_frac"],
                    frontier_density=rec.get("frontier_density"),
                    branch=branch)

    def flush(self, iters_done, frontier_sizes=None, active_edges=None,
              residual=None, sparse_flags=None, directions=None):
        """Record the window since the previous flush. Call only right
        after a host sync; ``iters_done`` is the cumulative iteration
        count for the run so far. ``sparse_flags`` (push fixpoints) marks
        which window iterations took the sparse branch, adding per-record
        branch, frontier-density, and dense/sparse crossover fields.
        ``directions`` (GAS adaptive fixpoints) likewise marks which
        window iterations ran push (1) vs pull (0) — the same branch/
        crossover machinery then records every direction switch."""
        iters_done = int(iters_done)
        n = iters_done - self._iters
        if n <= 0:
            return
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        self.execute_s += dt
        self._flushes += 1
        per = dt / n
        for j in range(n):
            it = self._iters + j
            frontier = None
            if frontier_sizes is not None and j < len(frontier_sizes):
                frontier = int(frontier_sizes[j])
            branch = None
            if sparse_flags is not None and j < len(sparse_flags):
                branch = "sparse" if sparse_flags[j] else "dense"
            if directions is not None and j < len(directions):
                branch = "push" if directions[j] else "pull"
            ae = int(active_edges) if active_edges is not None else self.ne
            rec = {
                "iter": it,
                "t_iter_s": per,
                "t_cum_s": self.execute_s - dt + per * (j + 1),
                "flush_span": self._flushes,
                "active_edges": ae,
                "gteps": gteps(ae, 1, per),
            }
            self._branch_into(rec, branch, frontier)
            if residual is not None and j == n - 1:
                rec["residual"] = float(residual)
            self.iterations.append(rec)
            if flight.enabled():
                flight.note_iteration({
                    "engine": self.engine, "program": self.program, **rec,
                })
        last = self.iterations[-1]
        if "frontier_density" in last:
            self._m_frontier_density.set(last["frontier_density"])
            trace.counter(f"{self.engine}.frontier",
                          {"frontier_density": last["frontier_density"]},
                          cat="phase")
            engobs.note(self.engine, iter=last["iter"],
                        frontier_density=last["frontier_density"],
                        branch=last.get("branch"))
        self._iters = iters_done
        trace.pair(f"{self.engine}.flush", now - dt, now, cat="execute",
                   args={"iters": n, "iters_done": iters_done})
        self._m_iters_total.inc(n)
        self._m_iter_s.observe(per)

    def summary(self) -> dict:
        out = {
            "schema": "lux.run_telemetry.v1",
            "engine": self.engine,
            "program": self.program,
            "nv": self.nv,
            "ne": self.ne,
            "num_iters": self._iters,
            "compile_s": self.compile_s,
            "execute_s": self.execute_s,
            "gteps": gteps(self.ne, self._iters, self.execute_s),
            "exchange_bytes_per_iter": self.exchange_bytes_per_iter,
            "exchange_bytes_total": self.exchange_bytes_per_iter * self._iters,
            "iterations": self.iterations,
        }
        if self.parts is not None:
            out["parts"] = self.parts
        if self.phase_s["exchange"] or self.phase_s["compute"]:
            phased = self.phase_s["exchange"] + self.phase_s["compute"]
            out["phases"] = {
                "exchange_s": self.phase_s["exchange"],
                "compute_s": self.phase_s["compute"],
                "exchange_frac": (self.phase_s["exchange"] / phased
                                  if phased > 0 else 0.0),
            }
            if self.overlap:
                ex_s = self.phase_s["exchange"]
                out["phases"]["exchange_hidden_frac"] = (
                    min(ex_s, self.phase_s["compute"]) / ex_s
                    if ex_s > 0 else 1.0)
        if self.useful_bytes_per_iter is not None:
            out["useful_bytes_per_iter"] = self.useful_bytes_per_iter
            out["useful_ratio"] = self.useful_ratio
        if self.hbm_bytes_per_iter is not None:
            out["hbm_bytes_per_iter"] = self.hbm_bytes_per_iter
        if self.crossovers:
            out["crossovers"] = self.crossovers
        return out

    def finish(self) -> dict:
        """Close the run span and publish the report; idempotent."""
        if self._finished:
            return self.summary()
        self._finished = True
        trace.end(f"{self.engine}.run", cat="run")
        summary = self.summary()
        if self.exchange_bytes_per_iter:
            metrics.counter(
                "lux_exchange_bytes_total", {"engine": self.engine},
            ).inc(summary["exchange_bytes_total"])
        if "phases" in summary:
            engobs.note(self.engine, run_exchange_s=self.phase_s["exchange"],
                        run_compute_s=self.phase_s["compute"],
                        run_exchange_frac=summary["phases"]["exchange_frac"],
                        run_exchange_hidden_frac=summary["phases"].get(
                            "exchange_hidden_frac"),
                        num_iters=self._iters)
        from lux_tpu_torch.obs import report
        report.finalize(summary)
        return summary
