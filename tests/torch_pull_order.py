"""The summation order of the pull kernels K8 and K9, emulated in torch.

``csrc/pull_sum.cu`` writes each row once over a :class:`RowTasks`
schedule (``csrc/row_pass.cuh``); each hub row of the schedule goes to a
cluster of ``CLUSTER`` blocks of 256 threads (8 warps). K8: a row of at
most ``LANE_MAX`` edges is summed by one lane, any other by the 32 lanes
of a warp; thread t of S takes the row's edges t, t + S, ... in order,
the lanes of a warp are added by an xor butterfly (16, 8, 4, 2, 1), a
hub block's eight warp sums in warp order from 0 and a cluster's block
sums in rank order from 0. K9: a group of five lanes takes an edge, each
lane a fifth of the 20-float row; the six groups of a warp (48 a block
of a hub's cluster) take the row's edges g, g + 6, ... (g + 48 ×
CLUSTER, ...) in order; per edge the dot is each lane's four products
chained from 0 and then the five lanes' partials added in lane order; a
warp's six groups are added in group order from 0, then as K8's.
:func:`ordered_pull_sum` takes every sum in that order on the CPU, so
the tests can hold the order against the plain versions and against
``lux_tpu``, and the card tests the kernels bitwise against it.

K9's fused multiply-adds are taken in float64 and rounded to float32:
the product of two f32 values is exact there, so only a sum that rounds
twice to an f32 tie can differ from the card's single rounding.
"""

import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

import lux_tpu_torch

_SOURCE = (Path(lux_tpu_torch.__file__).parent / "csrc" / "pull_sum.cu"
           ).read_text()


def _constant(name: str) -> int:
    """A ``constexpr int`` of csrc/pull_sum.cu, which fixes the order."""
    return int(re.search(rf"constexpr int {name} = (\d+);", _SOURCE)[1])


WARPS = _constant("kThreads") // 32        # the warps of a block
LANE_MAX = _constant("kLaneMax8")          # K8: a lane's rows
GROUPS = 32 // (_constant("kCfWidth") // 4)   # K9: lane groups of a warp
CLUSTER = {False: _constant("kCluster8"),  # blocks of a hub row, K8
           True: _constant("kCluster9")}   # and K9


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def _butterfly(a: torch.Tensor) -> torch.Tensor:
    """Lane 0's value after the xor butterfly over axis 1 (32 lanes)."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        a = a + a[:, lane ^ off]
    return a[:, 0]


def _in_order(a: torch.Tensor) -> torch.Tensor:
    """The sum from 0 over axis 1, in order."""
    u = torch.zeros_like(a[:, 0])
    for i in range(a.shape[1]):
        u = u + a[:, i]
    return u


def _cf_dot(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """K9's dot: each lane's four products chained from 0, then the five
    partials added in lane order."""
    parts = []
    for j in range(src.shape[1] // 4):
        p = torch.zeros(src.shape[0])
        for k in range(4 * j, 4 * j + 4):
            p = _fma(src[:, k], dst[:, k], p)
        parts.append(p)
    dot = parts[0]
    for p in parts[1:]:
        dot = dot + p
    return dot


def ordered_pull_sum(vals: torch.Tensor, row_ptr, col_src: torch.Tensor,
                     hub_rows, weights: Optional[torch.Tensor] = None,
                     row_base: int = 0) -> torch.Tensor:
    """K8 (``weights`` None: the sum of ``vals[src]``) or K9 (the CF
    edge, (rows, 20) ``vals``) over the rows of ``row_ptr``, (nv,) or
    (nv, K) f32, summed in the kernels' order; ``hub_rows`` are the rows
    the schedule gives a block (``tasks[:n_hub, 0]`` of
    :func:`row_tasks`)."""
    cf = weights is not None
    rp = torch.as_tensor(np.asarray(row_ptr, np.int64))
    nv = rp.shape[0] - 1
    lens = rp.diff()
    hub = torch.zeros(nv, dtype=torch.bool)
    hub[torch.as_tensor(np.asarray(hub_rows, np.int64))] = True
    # Threads (K8) or lane groups (K9) that share a row.
    blocks = CLUSTER[cf]
    if cf:
        stride = torch.where(hub, blocks * WARPS * GROUPS, GROUPS)
    else:
        stride = torch.where(hub, blocks * WARPS * 32,
                             torch.where(lens <= LANE_MAX, 1, 32))
    slot0 = torch.zeros(nv + 1, dtype=torch.int64)
    torch.cumsum(stride, 0, out=slot0[1:])
    row = torch.repeat_interleave(torch.arange(nv), lens)
    pos = torch.arange(int(rp[-1])) - rp[row]
    slot = slot0[row] + pos % stride[row]
    step = pos // stride[row]
    src = vals[col_src.long()]
    if cf:
        err = weights.float() - _cf_dot(src, vals[row + row_base])
    acc = torch.zeros((int(slot0[-1]),) + tuple(vals.shape[1:]))
    for i in range(int(step.max()) + 1 if step.numel() else 0):
        e = torch.nonzero(step == i).flatten()
        s = slot[e]
        if cf:
            acc[s] = _fma(err[e, None], src[e], acc[s])
        else:
            acc[s] = acc[s] + src[e]
    out = torch.zeros((nv,) + tuple(vals.shape[1:]))
    for width in torch.unique(stride).tolist():
        r = torch.nonzero(stride == width).flatten()
        a = acc[slot0[r, None] + torch.arange(width)]
        if width == 1:
            out[r] = a[:, 0]
        elif width in (32, GROUPS):
            out[r] = _butterfly(a) if width == 32 else _in_order(a)
        else:   # a hub: each warp's sum, each block's, the cluster's
            per = width // (WARPS * blocks)
            warps = a.reshape((-1, per) + a.shape[2:])
            warps = _butterfly(warps) if per == 32 else _in_order(warps)
            block = _in_order(warps.reshape((-1, WARPS) + a.shape[2:]))
            out[r] = _in_order(block.reshape((r.numel(), blocks)
                                             + a.shape[2:]))
    return out
