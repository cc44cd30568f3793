"""Phase timing on the card or the host."""

from __future__ import annotations

import time

import torch


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
