"""Result checkers: per-edge fixpoint invariants, the counterpart of
``lux_tpu/engine/check.py``.

The reference validates push results with a GPU kernel counting edges that
violate the app's invariant, printing ``[PASS]``/``[FAIL]`` plus the
mistake count (sssp/sssp_gpu.cu:773-843, components/components_gpu.cu:
767-837). Here it is plain torch over all edges, on ``cuda`` unless
``device`` names another.
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.ops.segment import to_u32_storage, widen_u32
from lux_tpu_torch.utils.platform import resolve_device


def _edge_values(values, dev) -> torch.Tensor:
    """Values as the invariants see them: uint32 (numpy uint32 or int32
    storage) widened to int64, float32 as it is."""
    if isinstance(values, torch.Tensor):
        t = values.to(dev)
        return widen_u32(t) if t.dtype == torch.int32 else t
    a = np.asarray(values)
    if a.dtype == np.uint32:
        return widen_u32(to_u32_storage(a, dev))
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy()).to(dev)
    raise ValueError(f"values are uint32 or float32, not {a.dtype}")


def count_violations(graph: Graph, values, program, device=None) -> int:
    """Number of edges violating ``program.edge_invariant``. ``values``
    is numpy uint32 or an int32 storage tensor (uint32 programs), or
    float32 numpy or tensor (DeltaSSSP)."""
    dev = resolve_device(device)
    vals = _edge_values(values, dev)
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
