"""Sorted-segment sums by CSR offsets (kernel K4, ``segment_sum_rowptr``).

The counterpart of ``lux_tpu/ops/segment.py::segment_sum_by_rowptr``.
That one is a scatter-free cumsum-diff, shaped for the TPU; here the
CUDA kernel (``csrc/segment_sum.cu``) sums each segment directly, and
the plain version is a float64 prefix-sum diff.

Both CUDA segmented sums of this package (this one and the tail gather,
K2) split the elements into :class:`SegmentItems`, contiguous work items
of at most ``item_len`` elements that each lie inside one segment, so a
long segment never serialises one thread group. Pass one sums each item;
pass two sums each segment's items in item order. The order of every
addition is fixed, so results are deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.ops import _cuda

BLOCK = 128
# Elements per work item of the gather/segment sums (K2, K4): 8 threads
# take 8 elements each.
SEG_ITEM = 64


def segment_items(row_ptr: np.ndarray, item_len: int):
    """(item_lo (n_items+1,), row_items (nrows+1,)) int64 for CSR offsets.

    Row v's elements ``[row_ptr[v], row_ptr[v+1])`` are cut into
    ``ceil(len / item_len)`` items; item j spans
    ``[item_lo[j], item_lo[j+1])`` and row v owns items
    ``[row_items[v], row_items[v+1])``. Empty rows own none, so the
    items tile ``[row_ptr[0], row_ptr[-1])`` contiguously.
    """
    row_ptr = np.asarray(row_ptr, np.int64)
    lens = np.diff(row_ptr)
    per_row = -(-lens // item_len)
    row_items = np.zeros(row_ptr.shape[0], np.int64)
    np.cumsum(per_row, out=row_items[1:])
    owner = np.repeat(np.arange(lens.shape[0], dtype=np.int64), per_row)
    k = np.arange(owner.shape[0], dtype=np.int64) - row_items[owner]
    item_lo = np.append(row_ptr[owner] + k * item_len, row_ptr[-1])
    return item_lo.astype(np.int64), row_items


@dataclasses.dataclass(eq=False)
class SegmentItems:
    """Work items of one CSR segmented sum, on the device (see
    :func:`segment_items`); built once per plan on the host."""

    item_lo: torch.Tensor     # (n_items+1,) int64 element offsets
    row_items: torch.Tensor   # (nrows+1,) int64 item offsets per row

    @property
    def n_items(self) -> int:
        return self.item_lo.shape[0] - 1

    @property
    def nrows(self) -> int:
        return self.row_items.shape[0] - 1

    @staticmethod
    def build(row_ptr: np.ndarray, item_len: int, device) -> "SegmentItems":
        lo, ri = segment_items(row_ptr, item_len)
        return SegmentItems(
            item_lo=torch.from_numpy(lo).to(device),
            row_items=torch.from_numpy(ri).to(device),
        )


def prefix_diff_sum(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain per-segment sums of the rows of ``data`` (N, *tail) by CSR
    offsets: float64 prefix sums, then boundary differences, in f32.
    Exact for integral inputs whose prefix stays below 2^53."""
    z = torch.zeros((data.shape[0] + 1,) + tuple(data.shape[1:]),
                    dtype=torch.float64, device=data.device)
    torch.cumsum(data.to(torch.float64), dim=0, out=z[1:])
    g = z[row_ptr.long()]
    return (g[1:] - g[:-1]).to(torch.float32)


def segment_sum_by_rowptr_plain(
    data: torch.Tensor,
    row_ptr: torch.Tensor,
    nvalid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K4's plain version: (nrows,) f32 segment sums of the flattened
    ``data``. With ``nvalid`` (S,), ``data`` is (S, 128) and lanes
    ``>= nvalid[row]`` count as zero."""
    if nvalid is not None:
        lane = torch.arange(BLOCK, device=data.device)
        data = torch.where(lane[None, :] < nvalid[:, None], data, 0.0)
    return prefix_diff_sum(data.reshape(-1), row_ptr)


def segment_sum_by_rowptr(
    data: torch.Tensor,
    row_ptr: torch.Tensor,
    items: Optional[SegmentItems] = None,
    nvalid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum sorted segments given CSR offsets; (nrows,) f32.

    ``row_ptr`` (nrows+1,) int64 gives segment v as
    ``flat[row_ptr[v]:row_ptr[v+1]]`` of the flattened f32 ``data``.
    With ``nvalid`` (S,) int32, ``data`` is (S, 128) and lanes
    ``>= nvalid[row]`` count as zero (the grouped tail's root mask).
    CPU tensors take the plain version; CUDA tensors launch K4 over
    ``items`` (the :class:`SegmentItems` of ``row_ptr``).
    """
    if data.device.type == "cpu":
        return segment_sum_by_rowptr_plain(data, row_ptr, nvalid)
    dev = data.device
    _cuda.check(data, "data", torch.float32, dev)
    _cuda.check(row_ptr, "row_ptr", torch.int64, dev, ndim=1)
    if nvalid is not None:
        _cuda.check(nvalid, "nvalid", torch.int32, dev, ndim=1)
        if data.dim() != 2 or data.shape != (nvalid.shape[0], BLOCK):
            raise ValueError(
                f"masked data must be ({nvalid.shape[0]}, {BLOCK}), "
                f"got {tuple(data.shape)}")
    if items is None:
        raise ValueError("CUDA segment sums need the SegmentItems of row_ptr")
    nrows = row_ptr.shape[0] - 1
    if items.nrows != nrows:
        raise ValueError(f"items cover {items.nrows} rows, row_ptr {nrows}")
    _cuda.check(items.item_lo, "item_lo", torch.int64, dev, ndim=1)
    _cuda.check(items.row_items, "row_items", torch.int64, dev, ndim=1)
    if items.n_items == 0:
        return torch.zeros(nrows, dtype=torch.float32, device=dev)
    partial = torch.empty(items.n_items, dtype=torch.float32, device=dev)
    y = torch.empty(nrows, dtype=torch.float32, device=dev)
    _cuda.launch(
        "segment_sum_rowptr", "lux_segment_sum_rowptr",
        _cuda.ptr(data), _cuda.ptr(nvalid), _cuda.ptr(items.item_lo),
        items.n_items, _cuda.ptr(items.row_items), nrows,
        _cuda.ptr(partial), _cuda.ptr(y), _cuda.stream(dev),
    )
    return y
