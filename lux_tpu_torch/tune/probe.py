"""One tuner probe: build an executor under a candidate flag overlay,
run a short fixed-iteration burst, and score it from the measured phase
split — never wall-clock alone. The counterpart of
``lux_tpu/tune/probe.py``, with the same scoring.

The overlay (:func:`lux_tpu_torch.utils.flags.overrides`) is the whole trick:
every tunable knob is captured at executor *build* time, so probing a
candidate is "build under the overlay, run, throw the engine away" —
``os.environ`` is never mutated, concurrent serving threads never see
the candidate, and the ``runrec.v1`` record appended for the probe
carries the candidate config (with its own ``config_hash``) because
``flags.snapshot()`` resolves through the same overlay.

Scoring: per-iteration medians of the engobs phase split
(``exchange_s + compute_s``) when the run was phase-fenced, else the
per-iteration wall median, times an instability penalty for direction
switches and exchange self-downgrades — a candidate that flaps
directions or downgrades its frontier send every other iteration is
worse than its phase medians alone suggest. The probe's detail also
carries its build and run seconds on the host clock (reported, not
scored).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, Optional

from lux_tpu_torch.obs import ledger
from lux_tpu_torch.obs.iterlog import IterationRecorder
from lux_tpu_torch.utils import flags

__all__ = ["ProbeResult", "run_probe", "score_summary"]

# Executors whose run() takes a positional iteration count and returns
# the value table; everything else is the (max_iters=, **init_kw) ->
# (state, total) fixpoint family.
_PULL_KINDS = frozenset({"pull", "tiled", "pull_sharded", "tiled_sharded"})

# Fixed flush chunk for every probe rung: per-iteration host-sync
# overhead depends on the chunk, so rungs must not vary it or scores
# stop being comparable across iteration budgets.
_CHUNK = 4


@dataclasses.dataclass
class ProbeResult:
    candidate: Dict[str, str]
    score: float
    iters: int               # iterations actually run
    record_id: Optional[str]  # runrec.v1 id of the tune_probe record
    detail: dict              # phase medians + stability counters


def _median(xs):
    return float(statistics.median(xs)) if xs else 0.0


def score_summary(summary: dict, iters_run: int, switches: int,
                  downgrades: int, penalty: float) -> tuple:
    """(score, detail) for one probe summary. Lower is better: seconds
    per iteration from phase medians, inflated by the instability
    penalty per switch/downgrade event per iteration."""
    records = summary.get("iterations") or []
    # The first record of a cold run can carry dispatch ramp even after
    # warmup; medians over the rest are the robust center.
    if len(records) >= 3:
        records = records[1:]
    ex_med = _median([r["exchange_s"] for r in records
                      if "exchange_s" in r])
    co_med = _median([r["compute_s"] for r in records
                      if "compute_s" in r])
    if ex_med or co_med:
        base = ex_med + co_med
    else:
        base = _median([r["t_iter_s"] for r in records if "t_iter_s" in r])
        if base == 0.0:
            # No per-iteration records at all (recorder disabled run):
            # fall back to run totals so the probe still orders.
            n = max(1, int(summary.get("num_iters") or iters_run or 1))
            base = float(summary.get("execute_s") or 0.0) / n
    events = max(0, int(switches)) + max(0, int(downgrades))
    score = base * (1.0 + penalty * events / max(1, iters_run))
    detail = {
        "exchange_s_med": ex_med,
        "compute_s_med": co_med,
        "t_iter_s_med": base,
        "direction_switches": int(switches),
        "exchange_downgrades": int(downgrades),
        "penalty": float(penalty),
    }
    return float(score), detail


def run_probe(graph, program, engine_kind: str,
              candidate: Dict[str, str], iters: int, *,
              init_kw: Optional[dict] = None,
              program_name: str = "?",
              graph_fingerprint: Optional[str] = None,
              mesh_shape: str = "1",
              rung: int = 0,
              build_kw: Optional[dict] = None) -> ProbeResult:
    """Build + run one candidate for ``iters`` iterations and score it.

    ``build_kw`` goes to :func:`~lux_tpu_torch.analysis.ir.build_executor`
    (``device``; ``mesh`` and a prebuilt partition ``sg`` for the sharded
    kinds, which every probe of a search may share: the partition does
    not depend on a tuner-managed knob). The executor builds its kernels
    in its own ``warmup()`` before the recorded burst, so that set-up
    never pollutes the phase medians — the same reason serving warms
    engines outside the query path.
    """
    from lux_tpu_torch.analysis.ir import build_executor

    init_kw = dict(init_kw or {})
    iters = max(1, int(iters))
    penalty = flags.get_float("LUX_TUNE_PENALTY")
    overlay = dict(candidate)
    overlay["LUX_ENGOBS"] = "1"  # probes exist to be phase-measured
    with flags.overrides(overlay):
        t0 = time.perf_counter()
        ex = build_executor(engine_kind, graph, program, **(build_kw or {}))
        build_s = time.perf_counter() - t0
        rec = IterationRecorder(engine_kind, int(graph.nv), int(graph.ne),
                                program=program_name)
        t0 = time.perf_counter()
        if engine_kind in _PULL_KINDS:
            ex.warmup()
            ex.run(iters, recorder=rec)
            iters_run = iters
        elif "multi" in engine_kind:
            # Multi-source executors take the root list positionally.
            start = int(init_kw.get("start", 0))
            ex.warmup(start=start)
            _, iters_run = ex.run([start], max_iters=iters,
                                  chunk=_CHUNK, recorder=rec)
        else:
            ex.warmup(**init_kw)
            _, iters_run = ex.run(max_iters=iters, recorder=rec,
                                  chunk=_CHUNK, **init_kw)
        rec.finish()
        run_s = time.perf_counter() - t0
        summary = rec.summary()
        switches = getattr(ex, "direction_switches", 0)
        downgrades = getattr(ex, "exchange_downgrades", 0)
        score, detail = score_summary(summary, iters_run, switches,
                                      downgrades, penalty)
        detail["build_s"] = build_s
        detail["run_s"] = run_s
        record_id = ledger.record_run(
            "tune_probe",
            {
                "score": score,
                "iters": int(iters_run),
                "exchange_s_med": detail["exchange_s_med"],
                "compute_s_med": detail["compute_s_med"],
                "t_iter_s_med": detail["t_iter_s_med"],
                "direction_switches": detail["direction_switches"],
                "exchange_downgrades": detail["exchange_downgrades"],
                "build_s": build_s,
                "run_s": run_s,
            },
            graph_fingerprint=graph_fingerprint,
            program=program_name,
            engine_kind=engine_kind,
            mesh_shape=mesh_shape,
            tune={"candidate": dict(candidate), "rung": int(rung)},
        )
    return ProbeResult(dict(candidate), score, int(iters_run), record_id,
                       detail)
