"""Result checkers: per-edge fixpoint invariants, the counterpart of
``lux_tpu/engine/check.py``.

The reference validates push results with a GPU kernel counting edges that
violate the app's invariant, printing ``[PASS]``/``[FAIL]`` plus the
mistake count (sssp/sssp_gpu.cu:773-843, components/components_gpu.cu:
767-837). Here it is plain torch over all edges, on ``cuda`` unless
``device`` names another.
"""

from __future__ import annotations

import torch

from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.ops.segment import to_u32_storage, widen_u32
from lux_tpu_torch.utils.platform import resolve_device


def count_violations(graph: Graph, values, program, device=None) -> int:
    """Number of edges violating ``program.edge_invariant``. ``values``
    is numpy uint32 or an int32 storage tensor."""
    dev = resolve_device(device)
    if isinstance(values, torch.Tensor):
        vals = widen_u32(values.to(dev))
    else:
        vals = widen_u32(to_u32_storage(values, dev))
    row_ptr = torch.from_numpy(graph.row_ptr).to(dev)
    src = torch.from_numpy(graph.col_src).to(dev).long()
    dst = torch.repeat_interleave(
        torch.arange(graph.nv, device=dev), row_ptr.diff())
    w = None if graph.weights is None else torch.from_numpy(
        graph.weights).to(dev)
    ok = program.edge_invariant(vals[src], vals[dst], w)
    return int((~ok).sum())


def check(graph: Graph, values, program, verbose: bool = True,
          device=None) -> bool:
    """Print the reference's check verdict; returns True on pass."""
    mistakes = count_violations(graph, values, program, device=device)
    if mistakes == 0:
        if verbose:
            print("[PASS] Check task passed!")
        return True
    if verbose:
        print(f"[FAIL] Check task failed (mistakes = {mistakes})")
    return False
