"""Engine performance observatory (``LUX_ENGOBS=1``), the counterpart of
``lux_tpu/obs/engobs.py``.

Three measurement surfaces of the sharded engines:

- **Phase timing.** ``run_pull_phased`` / ``run_push_phased`` /
  ``run_gas_phased`` drive a run through the executor's ``phase_step``,
  whose phases are each timed alone by CUDA events on the card (the host
  clock on the CPU), so every iteration splits into exchange wall time
  against local compute wall time. Timing each phase alone adds a wait
  per phase, so this is a measurement mode: with ``LUX_ENGOBS`` unset
  or ``0`` the executors run their plain loop of steps.
- **Exchange ledger.** ``useful_exchange`` reads the partition's
  remote-read index (``ShardedGraph.remote_read_counts``) and prices
  the exchange against the rows some receiving part actually reads:
  ``ratio`` is the fraction of exchanged bytes that were not waste.
- **Roofline inputs.** ``hbm_bytes_per_iter`` is ``lux_tpu``'s
  first-order per-iteration device-memory traffic model, kept unchanged
  so records of both packages compare; it is not the bytes the port's
  kernels stream (``PERF.md``'s kernel table holds those bounds).

The module also keeps a process-wide "latest per engine" table
(``note``/``latest``) a serving process can publish.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.locks import make_lock

_lock = make_lock("obs.engobs")
_latest: Dict[str, dict] = {}


def enabled() -> bool:
    """True when ``LUX_ENGOBS`` asks for phase-fenced measurement runs.
    Off is the default and costs one flag read per ``run()``."""
    return flags.get_bool("LUX_ENGOBS")


def note(engine: str, **fields):
    """Merge ``fields`` into the process-wide latest-telemetry table for
    ``engine`` (phase split, useful-bytes ratio, frontier density)."""
    with _lock:
        d = _latest.setdefault(engine, {})
        d.update(fields)


def latest() -> Dict[str, dict]:
    """Copy of the latest per-engine telemetry ({} until an instrumented
    run has happened)."""
    with _lock:
        return {k: dict(v) for k, v in _latest.items()}


def reset():
    with _lock:
        _latest.clear()


# -- exchange ledger -------------------------------------------------------


def useful_exchange(sg, row_bytes: int,
                    exchanged_rows: Optional[int] = None) -> Optional[dict]:
    """Price one iteration's exchange against the remote-read index.

    The full path sends each part's whole ``max_nv``-row shard to the
    P-1 others; only the rows some receiver's local edges index are
    useful. Pass ``exchanged_rows`` to price a compacted exchange
    instead. Returns ``{useful_rows, exchanged_rows,
    useful_bytes_per_iter, ratio}`` or None when the partition's edge
    arrays were released and the index was never built.
    """
    counts = sg.remote_read_counts()
    if counts is None:
        return None
    p = sg.num_parts
    if exchanged_rows is None:
        exchanged_rows = p * (p - 1) * sg.max_nv
    exchanged_rows = int(exchanged_rows)
    # Off-diagonal entries only: a part's reads of its own rows never
    # cross the interconnect.
    useful_rows = int(counts.sum() - counts.trace())
    ratio = useful_rows / exchanged_rows if exchanged_rows else 0.0
    return {
        "useful_rows": useful_rows,
        "exchanged_rows": exchanged_rows,
        "useful_bytes_per_iter": useful_rows * int(row_bytes),
        "ratio": ratio,
    }


# -- roofline input model --------------------------------------------------


def hbm_bytes_per_iter(nv: int, ne: int, value_bytes: int = 4,
                       k: int = 1) -> int:
    """First-order device-memory traffic of one dense iteration: per edge
    one gathered value row plus one int32 index read, per vertex one read
    and one write of the value row plus the degree read. A model, not a
    measurement — report.py labels the resulting fractions as such."""
    row = value_bytes * max(k, 1)
    return ne * (row + 4) + nv * (3 * row + 4)


# -- phase-fenced runners --------------------------------------------------


def _split(times: dict) -> tuple:
    """(exchange_s, compute_s) from a phase_step times dict. The sharded
    pull family names its exchange phase "exchange"; the push and GAS
    families' exchange lives in "loadTime"."""
    exchange = 0.0
    compute = 0.0
    for key, val in times.items():
        if not isinstance(val, (int, float)):
            continue
        if key in ("exchange", "loadTime"):
            exchange += val
        else:
            compute += val
    return exchange, compute


def _timed_warmup(ex, fn) -> float:
    """Seconds of ``fn()``, the clock read after the card finished it."""
    t0 = time.perf_counter()
    fn()
    if ex.device.type == "cuda":
        import torch

        torch.cuda.synchronize(ex.device)
    return time.perf_counter() - t0


def run_pull_phased(ex, vals, num_iters: int, rec):
    """Fixed-iteration phase-fenced loop for the sharded pull family
    (ShardedPullExecutor / ShardedTiledExecutor): one exchange/compute
    split per iteration via ``phase_step``. Returns the final values."""
    if not getattr(ex, "_phases_warm", False):
        # The first phase_step builds every phase's kernels: keep that
        # out of the per-iteration walls (phase_step does not consume
        # ``vals``, so the throwaway step leaves them intact).
        rec.record_compile(_timed_warmup(ex, lambda: ex.phase_step(vals)))
        ex._phases_warm = True
    for i in range(int(num_iters)):
        vals, times = ex.phase_step(vals)
        exchange, compute = _split(times)
        rec.record_phase(i + 1, exchange, compute, detail=times)
    return vals


def run_push_phased(ex, state, max_iters, rec):
    """Phase-fenced fixpoint for the sharded push engines: per-iteration
    exchange/compute split plus the frontier count and dense/sparse
    branch from ``phase_step``. Returns (state, iterations_run,
    sparse_iterations)."""
    rec.record_compile(_timed_warmup(ex, lambda: ex.warmup_phases(state)))
    total = 0
    sparse_total = 0
    limit = None if max_iters is None else int(max_iters)
    while limit is None or total < limit:
        state, cnt, times = ex.phase_step(state)
        exchange, compute = _split(times)
        branch = times.get("branch")
        if isinstance(branch, str) and branch.startswith("sparse"):
            sparse_total += 1
        total += 1
        rec.record_phase(total, exchange, compute, frontier=cnt,
                         branch=branch, detail=times)
        if cnt == 0:
            break
    return state, total, sparse_total


def run_gas_phased(ex, state, max_iters, rec):
    """Phase-fenced fixpoint for the sharded direction-adaptive GAS
    engine: per-iteration exchange/compute/merge split, the branch taken
    (``push`` | ``pull`` | ``pull/frontier`` | ``pull/downgraded`` |
    ``pull/dense``), direction switches, and frontier-exchange
    downgrades. Returns (state, iterations_run, push_iterations,
    direction_switches, exchange_downgrades)."""
    rec.record_compile(_timed_warmup(ex, lambda: ex.warmup_phases(state)))
    total = 0
    push_total = 0
    switches = 0
    downgrades = 0
    prev_push = None
    limit = None if max_iters is None else int(max_iters)
    while limit is None or total < limit:
        state, cnt, times = ex.phase_step(state)
        # Metadata, not a wall: pop before _split sums numeric values.
        downgrades += int(times.pop("downgraded", 0) or 0)
        exchange, compute = _split(times)
        branch = times.get("branch")
        is_push = isinstance(branch, str) and branch.startswith("push")
        if is_push:
            push_total += 1
        if prev_push is not None and is_push != prev_push:
            switches += 1
        prev_push = is_push
        total += 1
        rec.record_phase(total, exchange, compute, frontier=cnt,
                         branch=branch, detail=times)
        if cnt == 0:
            break
    return state, total, push_total, switches, downgrades
