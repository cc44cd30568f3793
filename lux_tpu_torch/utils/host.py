"""Host passes split across threads.

numpy releases the GIL in its passes over arrays (arithmetic, gathers,
compares), so parts of one host step run side by side on the host's
CPUs: the incremental executor's invalidation BFS splits a large level
by its edges, and runs the lanes of a multi-source warm start side by
side (``engine/incremental.py``). A caller splits a step so that its
result does not depend on the split: each part writes only its own
output, or only True into a shared mask.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

# A pass over fewer edges than this runs on one thread.
PARALLEL_MIN = 1 << 20


def host_threads() -> int:
    """Threads for the host passes: the CPUs this process may run on."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:
        return os.cpu_count() or 1


def run_parts(fn: Callable, parts: list, threads: Optional[int] = None):
    """``[fn(p) for p in parts]``, on up to ``threads`` threads (default
    :func:`host_threads`)."""
    threads = host_threads() if threads is None else threads
    if threads <= 1 or len(parts) <= 1:
        return [fn(p) for p in parts]
    with ThreadPoolExecutor(min(threads, len(parts))) as pool:
        return list(pool.map(fn, parts))
