"""Grouped-tail level kernel (K3) and device plan.

The counterpart of ``lux_tpu/ops/merge_tail_kernel.py``. It executes a
:class:`~lux_tpu_torch.ops.merge_tail_plan.GroupedTailPlan`: one pass
per level over a (rows, 128) f32 stream. Output row o reads ONE full
input row per side — ``arow[o]`` / ``brow[o]`` — and the int8 code plane
routes lanes (c >= 0: side-A lane c; c < 0: side-B lane c & 127). Level
0 reads the (nvb, 128) value operand; later levels read the previous
level's stream. The root stream is masked by ``nvalid_root`` and reduced
per destination by ``dst_row_ptr`` (:func:`root_reduce`, kernel K4).

``level_apply`` launches K3 (``csrc/level_apply.cu``, the port of the
Pallas ``level_apply_pallas``) for CUDA tensors and runs
:func:`level_apply_ref` for CPU tensors. The kernel only moves data, so
the two are bitwise equal.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.ops.merge_tail_plan import GroupedTailPlan
from lux_tpu_torch.ops.segment import segment_sum_by_rowptr
from lux_tpu_torch.utils import flags, tracehooks

BLOCK = 128


def grouped_tail_enabled() -> bool:
    """Opt-in flag for the grouped (merge-network) tail phase."""
    return flags.get_bool("LUX_GROUPED_TAIL")


@dataclasses.dataclass(eq=False)
class DeviceGroupedTail:
    """Device-resident grouped-tail plan.

    ``arow``/``brow``/``codes`` are per-level tuples — level 0 first
    (the x2d gather level), root last. Only the root stream carries a
    validity mask; ``dst_row_ptr`` are final-slot segment boundaries
    for the per-destination reduction (K4).
    """

    arow: Tuple[torch.Tensor, ...]    # (S_k,) int32 per level
    brow: Tuple[torch.Tensor, ...]    # (S_k,) int32
    codes: Tuple[torch.Tensor, ...]   # (S_k, 128) int8
    nvalid_root: torch.Tensor         # (S_root,) int32
    dst_row_ptr: torch.Tensor         # (nv+1,) int64 final-slot offsets
    n_levels: int                     # merge levels (excl. level 0)

    @staticmethod
    def build(plan: GroupedTailPlan, device) -> "DeviceGroupedTail":
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        nlev = plan.n_levels
        arow, brow, codes = [], [], []
        for k in range(nlev + 1):
            a, b, c, nv_, _ = plan.level(k)
            arow.append(put(a.astype(np.int32)))
            brow.append(put(b.astype(np.int32)))
            codes.append(put(c.astype(np.int8)))
        return DeviceGroupedTail(
            arow=tuple(arow), brow=tuple(brow), codes=tuple(codes),
            nvalid_root=put(nv_.astype(np.int32)),
            dst_row_ptr=put(np.asarray(plan.dst_row_ptr, np.int64)),
            n_levels=nlev,
        )


def level_apply_ref(x, arow, brow, codes):
    """One network level in plain PyTorch (K3's plain version)."""
    lane = codes.long() & 127
    ga = torch.gather(x[arow.long()], 1, lane)
    gb = torch.gather(x[brow.long()], 1, lane)
    return torch.where(codes >= 0, ga, gb)


@tracehooks.kernel("level_apply")
def level_apply(x, arow, brow, codes):
    """One network level; (S, 128) f32. A level with no rows returns an
    empty stream without a launch."""
    if codes.shape[0] == 0:
        return x.new_zeros((0, BLOCK))
    if x.device.type == "cpu":
        return level_apply_ref(x, arow, brow, codes)
    dev = x.device
    _cuda.check(x, "x", torch.float32, dev, ndim=2)
    if x.shape[1] != BLOCK:
        raise ValueError(f"x must be (rows, {BLOCK}), got {tuple(x.shape)}")
    _cuda.check(arow, "arow", torch.int32, dev, ndim=1)
    _cuda.check(brow, "brow", torch.int32, dev, ndim=1)
    _cuda.check(codes, "codes", torch.int8, dev, ndim=2)
    s = codes.shape[0]
    if codes.shape[1] != BLOCK or arow.shape[0] != s or brow.shape[0] != s:
        raise ValueError("codes must be (S, 128) with S-long arow and brow")
    out = torch.empty((s, BLOCK), dtype=torch.float32, device=dev)
    _cuda.launch(
        "level_apply", "lux_level_apply",
        _cuda.ptr(x), _cuda.ptr(arow), _cuda.ptr(brow), _cuda.ptr(codes),
        s, _cuda.ptr(out), _cuda.stream(dev),
    )
    return out


@tracehooks.kernel("root_reduce")
def root_reduce(x, nvalid_root, dst_row_ptr, out=None):
    """Mask the root stream's pad lanes (the one masking point in the
    network) and reduce to per-destination sums (K4), added into ``out``
    (the strips' sums) when it is given."""
    return segment_sum_by_rowptr(x, dst_row_ptr, nvalid=nvalid_root, out=out)


def grouped_tail_sums(x2d, gt: DeviceGroupedTail, out=None):
    """Per-destination sums of tail-edge source values via the merge
    network; (nv,) f32, added into ``out`` when it is given. Drop-in for
    :func:`~lux_tpu_torch.ops.tiled_spmv.lane_select_tail_sums`."""
    x = x2d.to(torch.float32)
    for k in range(gt.n_levels + 1):
        x = level_apply(x, gt.arow[k], gt.brow[k], gt.codes[k])
    return root_reduce(x, gt.nvalid_root, gt.dst_row_ptr, out)
