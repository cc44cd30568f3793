"""The telemetry hooks every executor's ``run()`` shares: the recorder it
opens, the pull family's loop of steps with one flush per window, and
the flush windows of the fixpoint loops. ``lux_tpu``'s executors inline
the same calls (``engine/pull.py::run_pipelined`` and the chunked
fixpoints of ``engine/push.py`` and ``engine/gas.py``).

With every telemetry knob unset the recorder is ``NULL_RECORDER``, and
these hooks neither synchronise with the card nor launch anything: a
run's launches and host reads are those of the plain loop.
"""

from __future__ import annotations

import contextlib
import time

import torch

from lux_tpu_torch.obs import engobs
from lux_tpu_torch.obs.iterlog import (
    NULL_RECORDER,
    consume_compile_seconds,
    note_compile_seconds,
    recorder_for,
)

# The region of a step on one device, where lux_tpu tags nothing.
NO_REGION = contextlib.nullcontext()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def open_run(ex, engine: str, recorder, hbm_bytes):
    """The recorder of one ``run()`` of ``ex``, started: ``recorder``, or
    one for ``engine`` when it is None. A live one is credited the
    compile seconds ``warmup`` noted and ``hbm_bytes()``, the engine's
    first-order bytes per iteration (``engobs.hbm_bytes_per_iter``)."""
    rec = recorder if recorder is not None else recorder_for(
        engine, ex.graph, ex.program)
    rec.start()
    if rec.enabled:
        rec.record_compile(consume_compile_seconds(ex))
        rec.set_hbm_bytes(hbm_bytes())
    return rec


def note_exchange(rec, ex, dense_note: str, row_bytes=None,
                  note: str = None) -> None:
    """A sharded run's exchange ledger: the bytes ``lux_tpu`` prices
    (``ex.exchange_bytes_per_iter()``), the overlap mark of a packed
    exchange and, with ``row_bytes``, the useful bytes from the
    partition's remote-read index."""
    if not rec.enabled:
        return
    packed = ex._xplan is not None
    rec.set_exchange_bytes(
        ex.exchange_bytes_per_iter(),
        note=note or ("compact_all_to_all" if packed else dense_note),
        parts=ex.num_parts)
    if packed:
        rec.set_overlap(True)
    if row_bytes is not None:
        useful = engobs.useful_exchange(
            ex.sg, row_bytes,
            exchanged_rows=(ex._xplan.exchanged_units_per_iter
                            if packed else None))
        if useful is not None:
            rec.set_useful_bytes(useful["useful_bytes_per_iter"],
                                 useful["ratio"])


def run_steps(step, vals, num_iters: int, flush_every: int, rec, device):
    """``num_iters`` applications of ``step`` to ``vals``. A live
    recorder waits for the card once every ``flush_every`` iterations
    (0: once, at the end) and flushes the window; ``NULL_RECORDER`` adds
    no wait."""
    live = rec.enabled
    for i in range(num_iters):
        vals = step(vals)
        if live and flush_every and (i + 1) % flush_every == 0:
            sync(device)
            rec.flush(i + 1)
    if live and not (flush_every and num_iters % flush_every == 0):
        sync(device)      # the last window, unless it just closed
    rec.flush(num_iters)
    return vals


def timed_warmup(ex, fn) -> None:
    """Run ``fn()`` (a warm-up through the run() path), wait for the
    card, and note its seconds as ``ex``'s compile time for the next
    ``run()``'s recorder."""
    t0 = time.perf_counter()
    fn()
    sync(ex.device)
    note_compile_seconds(ex, time.perf_counter() - t0)


class FlushWindow:
    """The flush windows of a fixpoint loop: ``lux_tpu`` reads one chunk
    of ``chunk`` iterations at a time, so its recorder gets one flush per
    chunk. The port reads its counters every iteration, so the card is
    already waited for; this keeps the chunk's post-step frontier sizes
    and branch flags and flushes at the same iteration counts. ``kind``
    is ``"sparse_flags"`` (push: 1 = sparse) or ``"directions"`` (GAS:
    1 = push)."""

    __slots__ = ("rec", "chunk", "kind", "sizes", "flags")

    def __init__(self, rec, chunk: int, kind: str):
        self.rec = rec
        self.chunk = max(int(chunk), 1)
        self.kind = kind
        self.sizes = []
        self.flags = []

    def step(self, done: int, frontier: int, flag: int) -> None:
        """Iteration ``done`` (1-based) left ``frontier`` active and took
        branch ``flag``."""
        if not self.rec.enabled:
            return
        self.sizes.append(int(frontier))
        self.flags.append(int(flag))
        if done % self.chunk == 0:
            self.close(done)

    def close(self, done: int) -> None:
        self.rec.flush(done, frontier_sizes=self.sizes,
                       **{self.kind: self.flags})
        self.sizes, self.flags = [], []


__all__ = ["NULL_RECORDER", "NO_REGION", "FlushWindow", "note_exchange",
           "open_run", "run_steps", "sync", "timed_warmup"]
