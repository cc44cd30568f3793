"""Wall-clock and phase timing on the card or the host.

:class:`Timer` is the counterpart of ``lux_tpu/utils/timing.py``'s: the
reference brackets its iteration loop with
``Realm::Clock::current_time_in_microseconds`` and prints ``ELAPSED TIME
= %7.7f s`` (pagerank/pagerank.cc:108-118). The executors' ``run()``
methods return with their work still queued on the card, so the timer
waits for the card before it reads the clock.
"""

from __future__ import annotations

import time

import torch

# The one GTEPS definition lives in obs/iterlog.py; the CLIs' GTEPS line
# reads it from here.
from lux_tpu_torch.obs.iterlog import gteps  # noqa: F401


class Timer:
    """``with Timer(device) as t: ...`` sets ``t.elapsed`` (seconds),
    read after the work queued on ``device`` (a CUDA device) finished."""

    def __init__(self, device=None):
        self._device = None if device is None else torch.device(device)

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if (exc_type is None and self._device is not None
                and self._device.type == "cuda"):
            torch.cuda.synchronize(self._device)
        self.elapsed = time.perf_counter() - self.start
        return False

    def print_elapsed(self):
        # Same format string family as the reference (pagerank.cc:117).
        print(f"ELAPSED TIME = {self.elapsed:7.7f} s")


def timed(fn, device: torch.device):
    """(fn(), seconds): CUDA events on the card, the host clock on the
    CPU. Waits for the work to finish either way."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0
