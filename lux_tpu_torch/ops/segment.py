"""Segment reductions: sorted-segment sums (K4), the push engine's
relax-and-reduce (K5, ``segment_minmax_relax``), the flat pull
engine's fused edge sums (K8 ``gather_segment_sum``, K9 ``cf_edge_sum``)
and the GAS engine's pull accumulator (K10 ``gas_pull_acc``, over a
frontier bitmask).

The counterpart of ``lux_tpu/ops/segment.py``. There, sums are a
scatter-free cumsum-diff and min/max a block-min hierarchy of segmented
scans, both shaped for the TPU. Here the CUDA kernels reduce each
segment directly: ``csrc/segment_sum.cu`` (K2, K4), ``csrc/pull_sum.cu``
(K8, K9) and ``csrc/gas.cu`` (K10, and K5 on K10's pull). The plain
versions are a float64 prefix-sum diff and a ``scatter_reduce`` over
widened integers.

Long segments must not serialise one thread group. K4 owns rows at
merge-path positions of the row pointer, as K2 does, and sums each from
a stage of the stream in shared memory (a hub row by its whole block).
K5, K8, K9 and K10 write each row once over the :class:`RowTasks`
schedule: a hub row a block (K9: a cluster of blocks), the other rows a
lane or a warp of a warp task, each summed in an order fixed by the
row's length (``csrc/row_pass.cuh``). K1 cuts its cells into
:class:`SegmentItems`. Results are deterministic.

**uint32 values.** The push programs hold uint32 values (SSSP distances,
CC labels), but this PyTorch build implements almost no uint32
arithmetic. So a device value is stored as a ``torch.int32`` tensor
holding the uint32 bit pattern (:func:`to_u32_storage`); the CUDA
kernels read it as ``unsigned int``. Plain versions widen it to int64
in ``[0, 2**32)`` (:func:`widen_u32`) before any arithmetic or
comparison and narrow back to the same bit pattern
(:func:`narrow_u32`). :func:`identity_for` gives identities as values
of that widened domain: the uint32 min identity is ``0xFFFFFFFF``, never
−1. Results leave as numpy uint32 (:func:`u32_to_numpy`).

:func:`csc_counting_merge`, the delta graph's merge, is a numpy copy of
``lux_tpu``'s and runs on the host there too: it is not a kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.utils import tracehooks

BLOCK = 128


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
        return SegmentItems(item_lo=torch.from_numpy(lo).to(device),
                            row_items=torch.from_numpy(ri).to(device))


def _prefix_diff64(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    # The prefix runs along the last axis of the (W, N) transpose: the
    # card scans an outer axis with one thread per column, which takes
    # seconds for N = 2^20 rows of 20 columns.
    tail = tuple(data.shape[1:])
    cols = data.reshape(data.shape[0], math.prod(tail)).t().to(
        torch.float64).contiguous()
    z = torch.zeros((cols.shape[0], data.shape[0] + 1), dtype=torch.float64,
                    device=data.device)
    torch.cumsum(cols, dim=1, out=z[:, 1:])
    g = z[:, row_ptr.long()]
    return (g[:, 1:] - g[:, :-1]).t().reshape((-1,) + tail)


def prefix_diff_sum(data: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Plain per-segment sums of the rows of ``data`` (N, *tail) by CSR
    offsets: float64 prefix sums, then boundary differences, in f32.
    Exact for integral inputs whose prefix stays below 2^53."""
    return _prefix_diff64(data, row_ptr).to(torch.float32)


def segment_sum_by_rowptr_plain(
    data: torch.Tensor,
    row_ptr: torch.Tensor,
    nvalid: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K4's plain version: (nrows, *tail) f32 segment sums of the rows of
    ``data`` (N, *tail), added into ``out`` when it is given. With
    ``nvalid`` (S,), ``data`` is an (S, 128) stream summed flat, and
    lanes ``>= nvalid[row]`` count as zero."""
    if nvalid is not None:
        lane = torch.arange(BLOCK, device=data.device)
        data = torch.where(lane[None, :] < nvalid[:, None], data,
                           0.0).reshape(-1)
    sums = prefix_diff_sum(data, row_ptr)
    return sums if out is None else out.add_(sums)


@tracehooks.kernel("segment_sum_by_rowptr")
def segment_sum_by_rowptr(
    data: torch.Tensor,
    row_ptr: torch.Tensor,
    nvalid: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum sorted segments given CSR offsets; (nrows,) f32.

    ``row_ptr`` (nrows+1,) int64 gives segment v as
    ``flat[row_ptr[v]:row_ptr[v+1]]`` of the 1-D f32 ``data``.
    With ``nvalid`` (S,) int32, ``data`` is (S, 128), summed flat, and
    lanes ``>= nvalid[row]`` count as zero (the grouped tail's root
    mask). With ``out`` (a (nrows,) f32 vector) the sums are added into
    it and ``out`` is returned. CPU tensors take the plain version
    (which also sums (N, K) rows); CUDA tensors launch K4 once, straight
    over the row pointer. K-wide sums of gathered rows are
    :func:`gather_segment_sum`'s.
    """
    if data.device.type == "cpu":
        return segment_sum_by_rowptr_plain(data, row_ptr, nvalid, out)
    dev = data.device
    _cuda.check(data, "data", torch.float32, dev)
    _cuda.check(row_ptr, "row_ptr", torch.int64, dev, ndim=1)
    if nvalid is not None:
        _cuda.check(nvalid, "nvalid", torch.int32, dev, ndim=1)
        if data.dim() != 2 or data.shape != (nvalid.shape[0], BLOCK):
            raise ValueError(
                f"masked data must be ({nvalid.shape[0]}, {BLOCK}), "
                f"got {tuple(data.shape)}")
    elif data.dim() != 1:
        raise ValueError(
            f"unmasked data must be 1-D, got {tuple(data.shape)}")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    nrows = row_ptr.shape[0] - 1
    if out is None:
        out = torch.empty(nrows, dtype=torch.float32, device=dev)
        accumulate = 0
    else:
        _cuda.check(out, "out", torch.float32, dev, ndim=1)
        if out.shape[0] != nrows:
            raise ValueError(f"out must be ({nrows},), got "
                             f"{tuple(out.shape)}")
        accumulate = 1
    if nrows == 0:
        return out
    _cuda.launch(
        "segment_sum_rowptr", "lux_segment_sum_rowptr",
        _cuda.ptr(data), _cuda.ptr(nvalid), data.numel(), _cuda.ptr(row_ptr),
        nrows, accumulate, _cuda.ptr(out), _cuda.stream(dev),
    )
    return out


# -- uint32 values (see the module docstring) -------------------------------

U32_MASK = 0xFFFFFFFF
_U32_TOP = 0x80000000
_TOP_BIT = -(2 ** 31)  # bit 31 of an int32


def to_u32_storage(values, device=None) -> torch.Tensor:
    """The int32 storage tensor of uint32 ``values`` (a numpy array or
    sequence): the same 32-bit patterns, on ``device``."""
    a = np.ascontiguousarray(np.asarray(values, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def u32_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Numpy uint32 values of an int32 storage tensor."""
    return t.detach().cpu().numpy().view(np.uint32)


def widen_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` of an int32 storage tensor."""
    return t.to(torch.int64) & U32_MASK


def narrow_u32(t: torch.Tensor) -> torch.Tensor:
    """int32 storage of int64 values in ``[0, 2**32)``, bit for bit."""
    return (t - ((t & _U32_TOP) << 1)).to(torch.int32)


def identity_for(kind: str, dtype) -> Union[int, float]:
    """Combiner identity as a Python scalar of the value domain.

    The counterpart of ``lux_tpu/ops/segment.py::identity_for``. For
    ``np.uint32`` (the push programs) ``min`` gives ``0xFFFFFFFF`` and
    ``max`` gives 0, as widened int64 values; other integer dtypes give
    their own limits, floats ±inf, and ``sum`` 0."""
    if kind == "sum":
        return 0
    if kind not in ("min", "max"):
        raise ValueError(f"unknown combiner {kind!r}")
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            return float("inf") if kind == "min" else float("-inf")
        info = torch.iinfo(dtype)
    elif np.issubdtype(np.dtype(dtype), np.floating):
        return float("inf") if kind == "min" else float("-inf")
    else:
        info = np.iinfo(np.dtype(dtype))
    return int(info.max) if kind == "min" else int(info.min)


def segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, kind: str = "sum",
                   dtype=None) -> torch.Tensor:
    """Reduce the rows of ``data`` (N, *tail) into ``num_segments``
    slots by ``segment_ids`` (N,); empty segments get the identity of
    ``dtype`` (the value type, default ``data.dtype``: pass ``np.uint32``
    for widened uint32 values). The plain sum/min/max of
    ``lux_tpu/ops/segment.py::segment_reduce``, and K5's plain reduce."""
    ident = identity_for(kind, data.dtype if dtype is None else dtype)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), ident,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
    return out.scatter_reduce_(0, idx.expand_as(data), data, reduce=reduce,
                               include_self=True)


# -- K5: the push engine's dense relax-and-reduce ---------------------------

# Plain relax of each CUDA relax op, on widened uint32 values.
RELAX_OPS = {
    "add1": lambda v, w=None: (v + 1) & U32_MASK,
    "copy": lambda v, w=None: v,
}
COMBINERS = ("min", "max")   # code 0 and 1 of the CUDA kernels
# An edge function (a push relax or a GAS gather): (source values, edge
# weights or None) -> messages.
EdgeFn = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def plain_edge_fn(op: Optional[str], fn: Optional[EdgeFn],
                  ops=RELAX_OPS) -> EdgeFn:
    """The edge function a plain version runs: ``fn`` if given, else the
    plain form of ``op`` in the registry ``ops``."""
    if fn is not None:
        return fn
    if op not in ops:
        raise ValueError(f"unknown edge op {op!r}")
    return ops[op]


def kernel_codes(kind: str, relax_op: Optional[str]):
    """(combiner code, relax code) of the CUDA kernels; a relax op they
    do not know raises ``NotImplementedError``."""
    if relax_op not in RELAX_OPS:
        raise NotImplementedError(
            f"the CUDA relax kernels know relax ops {sorted(RELAX_OPS)}, "
            f"not {relax_op!r}")
    return COMBINERS.index(kind), list(RELAX_OPS).index(relax_op)


def combine_u32(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise min or max of two int32 storage tensors, compared as
    uint32."""
    pick = torch.minimum if kind == "min" else torch.maximum
    return narrow_u32(pick(widen_u32(a), widen_u32(b)))


def pack_words(values: torch.Tensor, frontier: torch.Tensor) -> torch.Tensor:
    """The packed ``value | frontier << 31`` table (int32 storage) of
    values below 2**31; a larger value is a program error, as in
    ``lux_tpu``'s blocked dense path."""
    return torch.where(frontier, values | _TOP_BIT, values)


def unpack_words(packed: torch.Tensor):
    """(values, active) of a packed ``value | frontier << 31`` int32
    table: widened values below 2**31 and a bool frontier."""
    w = widen_u32(packed)
    return w & 0x7FFFFFFF, (w >> 31) != 0


def segment_minmax_relax_plain(
    row_ptr: torch.Tensor,
    col_src: torch.Tensor,
    values: torch.Tensor,
    frontier: Optional[torch.Tensor],
    kind: str,
    relax: EdgeFn,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5's plain version: per CSC destination v, the ``kind`` (min or
    max) over its in-edges of ``relax(val[src], w)`` for active sources,
    the identity elsewhere; (nv,) int32 storage.

    With ``frontier`` None, ``values`` is the packed ``value |
    frontier << 31`` table; else it is the value storage and
    ``frontier`` a bool mask."""
    if frontier is None:
        vals, active = unpack_words(values)
    else:
        vals, active = widen_u32(values), frontier
    src = col_src.long()
    cand = relax(vals[src], weights)
    ident = identity_for(kind, np.uint32)
    cand = torch.where(active[src], cand, ident)
    nv = row_ptr.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(nv, device=row_ptr.device), row_ptr.diff())
    return narrow_u32(segment_reduce(cand, seg, nv, kind, dtype=np.uint32))


@tracehooks.kernel("segment_minmax_relax")
def segment_minmax_relax(
    row_ptr: torch.Tensor,
    col_src: torch.Tensor,
    values: torch.Tensor,
    frontier: Optional[torch.Tensor],
    kind: str,
    relax_op: Optional[str],
    tasks: Optional[RowTasks] = None,
    relax: Optional[EdgeFn] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The push engine's dense iteration: per CSC destination, the min
    or max of the relaxed values of its active in-neighbours (see
    :func:`segment_minmax_relax_plain` for the two input forms), (nv,)
    for ``row_ptr``'s nv rows over a table of at least nv rows that
    ``col_src`` indexes.

    CPU tensors take the plain version with ``relax`` (default: the
    plain form of ``relax_op``). CUDA tensors launch K5 (``csrc/gas.cu``,
    on K10's pull) over ``tasks`` (the :class:`RowTasks` of ``row_ptr``
    by any thresholds; :func:`push_row_tasks` gives K5's own): one call
    that writes every row once (the identity where no source is active),
    reading the packed table directly or, for values and a frontier,
    packing the frontier into bits first. The kernel knows the relax
    only by ``relax_op`` (``"add1"`` or ``"copy"``; neither reads
    weights)."""
    if kind not in COMBINERS:
        raise ValueError(f"segment_minmax_relax: unsupported kind {kind!r}")
    if values.device.type == "cpu":
        return segment_minmax_relax_plain(
            row_ptr, col_src, values, frontier, kind,
            plain_edge_fn(relax_op, relax), weights)
    comb, op = kernel_codes(kind, relax_op)
    dev = values.device
    nv = row_ptr.shape[0] - 1
    _cuda.check(row_ptr, "row_ptr", torch.int64, dev, ndim=1)
    _cuda.check(col_src, "col_src", torch.int32, dev, ndim=1)
    _cuda.check(values, "values", torch.int32, dev, ndim=1)
    if values.shape[0] < nv:
        raise ValueError(f"values must hold at least {nv} rows, got "
                         f"{values.shape[0]}")
    if frontier is not None:
        _cuda.check(frontier, "frontier", torch.bool, dev, ndim=1)
        if frontier.shape != values.shape:
            raise ValueError("frontier and values differ in shape")
    if tasks is None:
        raise ValueError("CUDA segment_minmax_relax needs the RowTasks of "
                         "row_ptr")
    if tasks.nrows != nv:
        raise ValueError(f"tasks cover {tasks.nrows} rows, row_ptr {nv}")
    _cuda.check(tasks.tasks, "tasks", torch.int32, dev, ndim=2)
    acc = torch.empty(nv, dtype=torch.int32, device=dev)
    if nv == 0:
        return acc
    packed = frontier is None
    n_tab = values.shape[0]
    bits = None if packed else torch.empty((n_tab + 31) // 32,
                                           dtype=torch.int32, device=dev)
    _cuda.launch(
        "segment_minmax_relax", "lux_segment_minmax_relax",
        _cuda.ptr(values if packed else None),
        _cuda.ptr(None if packed else values), _cuda.ptr(frontier), n_tab,
        _cuda.ptr(col_src), _cuda.ptr(row_ptr), _cuda.ptr(tasks.tasks),
        tasks.n_tasks, tasks.n_hub, comb, op, _cuda.ptr(bits),
        _cuda.ptr(acc), _cuda.stream(dev),
    )
    return acc


# -- the row schedule of K5, K8, K9 and K10 ----------------------------------

# A warp task: at most TASK_ROWS consecutive rows (one a lane) whose edges
# start inside one window of TASK_EDGES, so it gathers at most twice that;
# a row of more than TASK_EDGES edges is a task alone, and one of more than
# HUB_EDGES takes a whole block (csrc/row_pass.cuh). These are K10's.
TASK_ROWS = 32
TASK_EDGES = 1024
HUB_EDGES = 4096


def row_tasks(row_ptr: np.ndarray, task_edges: int = TASK_EDGES,
              hub_edges: int = HUB_EDGES, task_rows: int = TASK_ROWS):
    """(tasks (n_tasks, 2) int32 [first row, end row), n_hub) for CSR
    offsets: the rows cut into tasks of at most ``task_rows`` rows (at
    most 32, a lane each) whose edges start in one window of
    ``task_edges``, the ``n_hub`` hub rows (more than ``hub_edges``
    edges, each a task alone) first, then the warp tasks in row order.
    A row of more than ``task_edges`` edges is a task alone. The tasks
    partition the rows."""
    if not 1 <= task_rows <= 32:
        raise ValueError(f"task_rows must be 1..32 (a lane a row), "
                         f"got {task_rows}")
    rp = np.asarray(row_ptr, np.int64)
    n = rp.shape[0] - 1
    if n <= 0:
        return np.zeros((0, 2), np.int32), 0
    lens = np.diff(rp)
    alone = lens > min(task_edges, hub_edges)
    win = (rp[:-1] - rp[0]) // task_edges
    idx = np.arange(n, dtype=np.int64)
    cut = np.ones(n, bool)
    cut[1:] = (win[1:] != win[:-1]) | alone[1:] | alone[:-1]
    first = np.maximum.accumulate(np.where(cut, idx, 0))
    cut |= (idx - first) % task_rows == 0
    lo = np.flatnonzero(cut)
    hi = np.append(lo[1:], n)
    hub = (hi - lo == 1) & (lens[lo] > hub_edges)
    order = np.concatenate([np.flatnonzero(hub), np.flatnonzero(~hub)])
    tasks = np.stack([lo[order], hi[order]], axis=1).astype(np.int32)
    return tasks, int(hub.sum())


@dataclasses.dataclass(eq=False)
class RowTasks:
    """The schedule of K5, K8, K9 and K10 over one CSC row pointer (see
    :func:`row_tasks`), on the device; built once per graph on the host.
    Block ``b < n_hub`` sums hub row ``tasks[b]``; the other blocks run
    a warp task a warp, in order."""

    tasks: torch.Tensor   # (n_tasks, 2) int32 [first row, end row)
    n_hub: int
    nrows: int

    @property
    def n_tasks(self) -> int:
        return self.tasks.shape[0]

    @staticmethod
    def build(row_ptr: np.ndarray, device, task_edges: int = TASK_EDGES,
              hub_edges: int = HUB_EDGES) -> "RowTasks":
        tasks, n_hub = row_tasks(row_ptr, task_edges, hub_edges)
        return RowTasks(tasks=torch.from_numpy(tasks).to(device),
                        n_hub=n_hub, nrows=np.asarray(row_ptr).shape[0] - 1)


# K5's RowTasks thresholds (task_edges, hub_edges), from the shape sweep
# (python -m lux_tpu_torch.probes.shapes --only k5): tasks of 256 edges are
# 1-6% faster than K10's 1,024 on one device and on a sharded part.
PUSH_TASK_EDGES = (256, HUB_EDGES)


def push_row_tasks(row_ptr: np.ndarray, device) -> RowTasks:
    """The :class:`RowTasks` of ``row_ptr`` that K5 runs over, with its
    thresholds."""
    return RowTasks.build(row_ptr, device, *PUSH_TASK_EDGES)


# -- K8, K9: the flat pull engine's fused edge sums ---------------------------

CF_WIDTH = 20   # K9 is compiled for CF's width only
SUM_STRATEGIES = ("rowptr", "segment")
# The edge functions the kernels know, by a program's ``edge_op``:
# "copy" is K8's, "cf_sgd" K9's.
PULL_EDGE_OPS = ("copy", "cf_sgd")
# Each kernel's RowTasks thresholds (task_edges, hub_edges), from the
# shape sweep (python -m lux_tpu_torch.probes.shapes). Any thresholds give
# a right sum; they fix which rows a block, a warp or a lane sums, and so
# the order of each sum.
PULL_TASK_EDGES = {"copy": (512, HUB_EDGES),
                   "cf_sgd": (TASK_EDGES, HUB_EDGES)}
# An edge function: (source rows, destination rows, weights or None) of a
# window of edges -> their contributions.
EdgeFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                  torch.Tensor]


def _copy_edge(src, dst, w):
    return src


def _cf_edge(src, dst, w):
    err = w.to(torch.float32) - (src * dst).sum(-1)
    return err[:, None] * src


def pull_row_tasks(row_ptr: np.ndarray, edge_op: Optional[str],
                   device) -> RowTasks:
    """The :class:`RowTasks` of ``row_ptr`` that the kernel of
    ``edge_op`` runs over, with that kernel's thresholds."""
    if edge_op not in PULL_TASK_EDGES:
        raise NotImplementedError(
            f"the CUDA pull kernels know edge ops {PULL_EDGE_OPS}, "
            f"not {edge_op!r}")
    return RowTasks.build(row_ptr, device, *PULL_TASK_EDGES[edge_op])


def pull_sum_plain(
    vals: torch.Tensor,
    row_ptr: torch.Tensor,
    col_src: torch.Tensor,
    weights: Optional[torch.Tensor],
    edge_fn: EdgeFn,
    window: int = 0,
    strategy: str = "rowptr",
    row_base: int = 0,
) -> torch.Tensor:
    """The plain version of K8 and K9, for any sum-combiner pull program:
    per CSC destination v, the sum over its in-edges e of
    ``edge_fn(vals[src_e], vals[row_base + v], w_e)``, (nv, *tail) f32,
    where nv is ``row_ptr``'s row count. ``vals`` is the value table the
    sources index; a part of a sharded graph passes the flat table of
    all parts and the row of its own span as ``row_base``.

    Edges are taken ``window`` at a time (all at once when 0), so at most
    one window of contributions exists, as ``lux_tpu``'s edge-chunked
    path promises. ``strategy="rowptr"`` sums each window by float64
    prefix differences and adds the windows in float64 before one cast
    to f32; ``"segment"`` adds f32 contributions with ``index_add_``
    (``lux_tpu``'s ``segment_reduce`` strategy)."""
    if strategy not in SUM_STRATEGIES:
        raise ValueError(f"unknown sum strategy {strategy!r}")
    nv = row_ptr.shape[0] - 1
    ne = col_src.shape[0]
    rp = row_ptr.long()
    wide = strategy == "rowptr"
    acc = torch.zeros((nv,) + tuple(vals.shape[1:]),
                      dtype=torch.float64 if wide else torch.float32,
                      device=vals.device)
    step = window if window > 0 else max(ne, 1)
    for lo in range(0, ne, step):
        hi = min(lo + step, ne)
        # Rows r0 .. r1-1 own the window's edges.
        bounds = torch.tensor([lo, hi - 1], device=rp.device)
        r0, r1 = torch.searchsorted(rp, bounds, right=True).tolist()
        r0 -= 1
        local = rp[r0:r1 + 1].clamp(lo, hi) - lo
        dst = torch.repeat_interleave(
            torch.arange(r0, r1, device=rp.device), local.diff())
        c = edge_fn(vals[col_src[lo:hi].long()], vals[dst + row_base],
                    None if weights is None else weights[lo:hi])
        if wide:
            acc[r0:r1] += _prefix_diff64(c, local)
        else:
            acc.index_add_(0, dst, c)
    return acc.to(torch.float32)


def gather_segment_sum_plain(vals, row_ptr, col_src, window: int = 0):
    """K8's plain version: :func:`pull_sum_plain` with the copy edge."""
    return pull_sum_plain(vals, row_ptr, col_src, None, _copy_edge, window)


def cf_edge_sum_plain(vals, row_ptr, col_src, weights, window: int = 0,
                      row_base: int = 0):
    """K9's plain version: :func:`pull_sum_plain` with the CF edge."""
    return pull_sum_plain(vals, row_ptr, col_src, weights, _cf_edge, window,
                          row_base=row_base)


def _check_pull_operands(vals, row_ptr, col_src, tasks, row_base: int = 0):
    """Raise unless ``vals`` holds the destination rows ``row_base ..
    row_base + nv - 1`` and ``row_ptr``, ``col_src`` and ``tasks`` (the
    :class:`RowTasks` of ``row_ptr``) are the device operands of a pull
    kernel."""
    dev = vals.device
    nv = row_ptr.shape[0] - 1
    _cuda.check(vals, "vals", torch.float32, dev)
    if vals.dim() == 0 or vals.shape[0] < row_base + nv or row_base < 0:
        raise ValueError(f"vals must hold rows {row_base}.."
                         f"{row_base + nv - 1} (({nv}, ...) on one "
                         f"device), got "
                         f"{tuple(vals.shape)}")
    _cuda.check(row_ptr, "row_ptr", torch.int64, dev, ndim=1)
    _cuda.check(col_src, "col_src", torch.int32, dev, ndim=1)
    if tasks is None:
        raise ValueError("CUDA pull sums need the RowTasks of row_ptr")
    if tasks.nrows != nv:
        raise ValueError(f"tasks cover {tasks.nrows} rows, row_ptr {nv}")
    _cuda.check(tasks.tasks, "tasks", torch.int32, dev, ndim=2)


@tracehooks.kernel("gather_segment_sum")
def gather_segment_sum(vals: torch.Tensor, row_ptr: torch.Tensor,
                       col_src: torch.Tensor,
                       tasks: Optional[RowTasks] = None) -> torch.Tensor:
    """Per CSC destination v, the sum of ``vals[src]`` over its in-edges,
    (nv,) for ``row_ptr``'s nv rows; ``vals`` is the table the sources
    index (nv rows on one device, every part's on a sharded graph). CPU
    tensors take the plain version (rows of any shape); CUDA tensors
    launch K8 (``csrc/pull_sum.cu``) over ``tasks`` (see
    :func:`pull_row_tasks`), for scalar f32 values only."""
    if vals.device.type == "cpu":
        return gather_segment_sum_plain(vals, row_ptr, col_src)
    if vals.dim() != 1:
        raise NotImplementedError(
            f"K8 sums scalar (nv,) values, not {tuple(vals.shape)}")
    _check_pull_operands(vals, row_ptr, col_src, tasks)
    acc = vals.new_empty(row_ptr.shape[0] - 1)
    if tasks.n_tasks == 0:
        return acc
    _cuda.launch(
        "gather_segment_sum", "lux_gather_segment_sum", _cuda.ptr(vals),
        _cuda.ptr(col_src), _cuda.ptr(row_ptr), _cuda.ptr(tasks.tasks),
        tasks.n_tasks, tasks.n_hub, _cuda.ptr(acc),
        _cuda.stream(vals.device),
    )
    return acc


@tracehooks.kernel("cf_edge_sum")
def cf_edge_sum(vals: torch.Tensor, row_ptr: torch.Tensor,
                col_src: torch.Tensor, weights: torch.Tensor,
                tasks: Optional[RowTasks] = None,
                row_base: int = 0) -> torch.Tensor:
    """Per CSC destination v, the sum of ``(w - <vals[src], vals[row_base
    + v]>) * vals[src]`` over its in-edges (collaborative filtering's
    gather), (nv, K) for ``row_ptr``'s nv rows of a (rows, K) table
    ``vals``. CPU tensors take the plain version (any K); CUDA tensors
    launch K9 (``csrc/pull_sum.cu``) over ``tasks`` (see
    :func:`pull_row_tasks`), with int32 ``weights`` and K =
    ``CF_WIDTH``."""
    if vals.device.type == "cpu":
        return cf_edge_sum_plain(vals, row_ptr, col_src, weights,
                                 row_base=row_base)
    if vals.dim() != 2:
        raise ValueError("the CF edge takes (nv, K) K-vectors, got "
                         f"{tuple(vals.shape)}")
    if vals.shape[1] != CF_WIDTH:
        raise NotImplementedError(
            f"K9 is compiled for K = {CF_WIDTH}, not {vals.shape[1]}")
    _check_pull_operands(vals, row_ptr, col_src, tasks, row_base)
    if vals.data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned (rows load as float4)")
    _cuda.check(weights, "weights", torch.int32, vals.device, ndim=1)
    if weights.shape != col_src.shape:
        raise ValueError("weights and col_src differ in shape")
    acc = vals.new_empty((row_ptr.shape[0] - 1, CF_WIDTH))
    if tasks.n_tasks == 0:
        return acc
    _cuda.launch(
        "cf_edge_sum", "lux_cf_edge_sum", _cuda.ptr(vals), _cuda.ptr(col_src),
        _cuda.ptr(weights), _cuda.ptr(row_ptr), _cuda.ptr(tasks.tasks),
        tasks.n_tasks, tasks.n_hub, row_base, _cuda.ptr(acc),
        _cuda.stream(vals.device),
    )
    return acc


@tracehooks.kernel("pull_sum")
def pull_sum(
    vals: torch.Tensor,
    row_ptr: torch.Tensor,
    col_src: torch.Tensor,
    weights: Optional[torch.Tensor],
    edge_op: Optional[str],
    edge_fn: EdgeFn,
    tasks: Optional[RowTasks] = None,
    window: int = 0,
    strategy: str = "rowptr",
    row_base: int = 0,
) -> torch.Tensor:
    """A sum-combiner pull program's per-destination sums, over the rows
    of ``row_ptr`` whose destination values lie at ``row_base`` onward
    in the table ``vals`` (see :func:`pull_sum_plain`).

    CPU tensors take :func:`pull_sum_plain` with the program's edge
    function ``edge_fn``, ``window`` and ``strategy``. CUDA tensors
    launch the kernel of ``edge_op`` over ``tasks``: K8 for ``"copy"``,
    K9 for ``"cf_sgd"``; every window and both strategies give the same
    launch, which materialises no contributions. Another ``edge_op``
    raises ``NotImplementedError`` on the card."""
    if vals.device.type == "cpu":
        return pull_sum_plain(vals, row_ptr, col_src, weights, edge_fn,
                              window, strategy, row_base)
    if edge_op == "copy":
        return gather_segment_sum(vals, row_ptr, col_src, tasks)
    if edge_op == "cf_sgd":
        if weights is None:
            raise ValueError("the cf_sgd edge needs edge weights")
        return cf_edge_sum(vals, row_ptr, col_src, weights, tasks, row_base)
    raise NotImplementedError(
        f"the CUDA pull kernels know edge ops {PULL_EDGE_OPS}, "
        f"not {edge_op!r}")


# -- K10: the GAS engine's pull accumulator ----------------------------------

# Label propagation's hop budget: the low byte of its packed word.
DECAY_HOP_MASK = 0xFF


def _decay(v, w=None):
    hops = v & DECAY_HOP_MASK
    decayed = (v & (U32_MASK ^ DECAY_HOP_MASK)) | (hops - 1)
    # A spent budget sends 0, the max identity (hops - 1 = -1 is dropped).
    return torch.where(hops > 0, decayed, 0)


# The plain edge function of each GAS gather op the CUDA kernels know, by a
# program's ``gather_op``. "add_w" takes f32 values and int32 weights; the
# others take widened uint32 values (int64 in [0, 2**32)) and return the
# same.
GATHER_OPS = {
    **RELAX_OPS,                                    # add1: BFS; copy: CC
    "add_w": lambda v, w: v + w.to(torch.float32),  # DeltaSSSP
    "decay": _decay,                                # label propagation
    "one": lambda v, w=None: torch.ones_like(v),    # k-core
}
F32_GATHER_OPS = ("add_w",)
# The (combiner, gather op) pairs K10 and K11 are compiled for, in the
# order of their op code in csrc/gas.cu.
GAS_KERNEL_OPS = (("min", "add1"), ("max", "copy"), ("min", "add_w"),
                  ("max", "decay"), ("sum", "one"))


def gas_kernel_code(kind: str, gather_op: Optional[str]) -> int:
    """Op code of (combiner, gather op) in the GAS kernels; a pair they
    are not compiled for raises ``NotImplementedError``."""
    try:
        return GAS_KERNEL_OPS.index((kind, gather_op))
    except ValueError:
        raise NotImplementedError(
            f"the CUDA GAS kernels are compiled for (combiner, gather_op) "
            f"in {GAS_KERNEL_OPS}, not {(kind, gather_op)}") from None


def gas_storage_dtype(gather_op: Optional[str]) -> torch.dtype:
    """Storage type of a gather op's values: f32, or int32 words holding
    uint32 bits."""
    return torch.float32 if gather_op in F32_GATHER_OPS else torch.int32


def gas_widen(values: torch.Tensor):
    """(widened values, identity dtype) of GAS storage: int32 words hold
    uint32 values, f32 is itself."""
    if values.dtype == torch.int32:
        return widen_u32(values), np.uint32
    return values, values.dtype


def gas_narrow(acc: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Storage of a widened accumulator: uint32 sums wrap at 2**32."""
    if values.dtype == torch.int32:
        return narrow_u32(acc & U32_MASK)
    return acc


def storage_identity(kind: str, dtype: torch.dtype):
    """The combiner identity as a scalar of storage ``dtype``: int32
    words hold uint32 values, so min's 0xFFFFFFFF is -1."""
    if dtype == torch.int32:
        return -1 if kind == "min" else 0
    return identity_for(kind, dtype)


def gas_identity_storage(kind: str, shape, dtype: torch.dtype, device):
    """An accumulator of GAS storage ``dtype`` holding the identity."""
    return torch.full(shape, storage_identity(kind, dtype), dtype=dtype,
                      device=device)


def gas_pull_acc_plain(
    row_ptr: torch.Tensor,
    col_src: torch.Tensor,
    values: torch.Tensor,
    frontier: torch.Tensor,
    kind: str,
    gather: EdgeFn,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K10's plain version: per CSC destination v (and per column, for
    (rows, K) values), the ``kind`` (min, max or sum) over its in-edges
    of ``gather(val[src], w)`` for sources in the frontier, the identity
    elsewhere; values' storage type, (nv,) or (nv, K) for ``row_ptr``'s
    nv rows.

    ``values`` is int32 storage of uint32 bits (``gather`` then sees
    widened values) or f32; ``frontier`` is bool of the same shape. They
    are the table the sources index: nv rows on one device, every part's
    on a sharded graph."""
    vals, dom = gas_widen(values)
    src = col_src.long()
    w = weights
    if w is not None and values.dim() == 2:
        w = w[:, None]
    msg = gather(vals[src], w)
    msg = torch.where(frontier[src], msg, identity_for(kind, dom))
    nv = row_ptr.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(nv, device=row_ptr.device), row_ptr.diff())
    return gas_narrow(segment_reduce(msg, seg, nv, kind, dtype=dom), values)


# -- K10's frontier bitmask --------------------------------------------------

def frontier_bits_plain(frontier: torch.Tensor) -> torch.Tensor:
    """The frontier as K10 reads it. (n,) or (n, 1) bool: int32 words,
    bit j of word i the flag of vertex 32 i + j (uint32 bits). (n, K)
    bool, K > 1: (n, ceil(K / 8)) uint8, bit j of byte c of row v the
    flag of column 8 c + j."""
    n = frontier.shape[0]
    if frontier.dim() == 1 or frontier.shape[1] == 1:
        bit = torch.arange(32, device=frontier.device)
        f = F.pad(frontier.reshape(-1).to(torch.int64), (0, -n % 32))
        return narrow_u32((f.view(-1, 32) << bit).sum(1))
    bit = torch.arange(8, device=frontier.device)
    nch = -(-frontier.shape[1] // 8)
    f = F.pad(frontier.to(torch.int64), (0, 8 * nch - frontier.shape[1]))
    return (f.view(n, nch, 8) << bit).sum(2).to(torch.uint8)


def frontier_from_bits_plain(bits: torch.Tensor, shape) -> torch.Tensor:
    """The bool frontier of ``shape`` that :func:`frontier_bits_plain`
    packed into ``bits``."""
    n = shape[0]
    if len(shape) == 1 or shape[1] == 1:
        bit = torch.arange(32, device=bits.device)
        f = (widen_u32(bits)[:, None] >> bit) & 1
        return f.reshape(-1)[:n].reshape(shape).bool()
    bit = torch.arange(8, device=bits.device)
    f = (bits.to(torch.int64)[:, :, None] >> bit) & 1
    return f.reshape(n, 8 * bits.shape[1])[:, :shape[1]].bool()


def frontier_bits(frontier: torch.Tensor) -> torch.Tensor:
    """:func:`frontier_bits_plain` by K10's pack kernel (``csrc/gas.cu``)
    on the card; K10 runs the same kernel inside its own call."""
    if frontier.device.type == "cpu":
        return frontier_bits_plain(frontier)
    dev = frontier.device
    _cuda.check(frontier, "frontier", torch.bool, dev)
    if frontier.dim() not in (1, 2):
        raise ValueError(f"frontier must be (n,) or (n, K), got "
                         f"{tuple(frontier.shape)}")
    n = frontier.shape[0]
    k = 1 if frontier.dim() == 1 else frontier.shape[1]
    out = torch.empty(((n + 31) // 32,) if k == 1 else (n, -(-k // 8)),
                      dtype=torch.int32 if k == 1 else torch.uint8,
                      device=dev)
    if n:
        _cuda.launch("frontier_bits", "lux_frontier_bits",
                     _cuda.ptr(frontier), n, k, _cuda.ptr(out),
                     _cuda.stream(dev))
    return out


@tracehooks.kernel("gas_pull_acc")
def gas_pull_acc(
    row_ptr: torch.Tensor,
    col_src: torch.Tensor,
    values: torch.Tensor,
    frontier: torch.Tensor,
    kind: str,
    gather_op: Optional[str],
    tasks: Optional[RowTasks] = None,
    gather: Optional[EdgeFn] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The GAS engine's pull-direction accumulator (see
    :func:`gas_pull_acc_plain`), (nv,) or (nv, K) for ``row_ptr``'s nv
    rows, over a value table of at least nv rows that ``col_src``
    indexes.

    CPU tensors take the plain version with ``gather`` (default: the
    plain form of ``gather_op``). CUDA tensors launch K10
    (``csrc/gas.cu``) over ``tasks`` (the :class:`RowTasks` of
    ``row_ptr``): one call that packs the frontier into bits, then sums
    every row in one pass, writing each row once (the identity where no
    source is active). It knows the edge function only by ``gather_op``
    and is compiled for the pairs of :data:`GAS_KERNEL_OPS`."""
    if values.device.type == "cpu":
        return gas_pull_acc_plain(
            row_ptr, col_src, values, frontier, kind,
            plain_edge_fn(gather_op, gather, GATHER_OPS), weights)
    op = gas_kernel_code(kind, gather_op)
    dev = values.device
    nv = row_ptr.shape[0] - 1
    _cuda.check(row_ptr, "row_ptr", torch.int64, dev, ndim=1)
    _cuda.check(col_src, "col_src", torch.int32, dev, ndim=1)
    _cuda.check(values, "values", gas_storage_dtype(gather_op), dev)
    _cuda.check(frontier, "frontier", torch.bool, dev)
    if values.dim() not in (1, 2) or values.shape[0] < nv:
        raise ValueError(f"values must be (rows,) or (rows, K) with rows "
                         f">= {nv}, got {tuple(values.shape)}")
    if frontier.shape != values.shape:
        raise ValueError("frontier and values differ in shape")
    if gather_op in F32_GATHER_OPS:
        if weights is None:
            raise ValueError(f"gather op {gather_op!r} needs edge weights")
        _cuda.check(weights, "weights", torch.int32, dev, ndim=1)
        if weights.shape != col_src.shape:
            raise ValueError("weights and col_src differ in shape")
    if tasks is None:
        raise ValueError("CUDA gas_pull_acc needs the RowTasks of row_ptr")
    if tasks.nrows != nv:
        raise ValueError(f"tasks cover {tasks.nrows} rows, row_ptr {nv}")
    _cuda.check(tasks.tasks, "tasks", torch.int32, dev, ndim=2)
    acc = torch.empty((nv,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=dev)
    if nv == 0:
        return acc
    n_tab = values.shape[0]
    k = 1 if values.dim() == 1 else values.shape[1]
    bits = torch.empty((n_tab + 31) // 32 if k == 1
                       else (n_tab * -(-k // 8) + 3) // 4,
                       dtype=torch.int32, device=dev)
    _cuda.launch(
        "gas_pull_acc", "lux_gas_pull_acc", _cuda.ptr(values),
        _cuda.ptr(frontier), n_tab, _cuda.ptr(col_src),
        _cuda.ptr(weights if gather_op in F32_GATHER_OPS else None),
        _cuda.ptr(row_ptr), _cuda.ptr(tasks.tasks), tasks.n_tasks,
        tasks.n_hub, k, op, _cuda.ptr(bits), _cuda.ptr(acc),
        _cuda.stream(dev),
    )
    return acc


# -- the delta graph's merge (host, numpy) -------------------------------


def csc_counting_merge(
    row_ptr: np.ndarray,
    col_src: np.ndarray,
    weights,
    keep: np.ndarray,
    ins_dst: np.ndarray,
    ins_src: np.ndarray,
    ins_w,
    nv: int,
):
    """Merge a kept subset of a CSC edge list with sorted inserts, host-side.

    One counting-sort pass instead of a full ``argsort`` over the merged
    edge list: per-destination survivor counts come from the dropped
    edges' destinations, insert counts from a ``bincount``, and every
    insert's final slot is a closed-form offset — kept edges keep their
    base-relative order within each destination segment and fill the
    slots the inserts (pre-sorted by ``(dst, src)``) leave, after them.
    O(ne + ni + nv) with no comparison sort, deterministic by
    construction; the same arrays as ``lux_tpu``'s, which finds each kept
    edge's slot by a search of ``row_ptr`` and a prefix sum over ``keep``
    instead (several times slower at 67 M edges).

    ``keep`` is a boolean mask over the base edges; ``ins_dst``/``ins_src``
    must be sorted by ``(dst, src)``. Returns
    ``(new_row_ptr int64 (nv+1,), new_col_src, new_weights|None)``.
    """
    ni = int(ins_dst.shape[0])
    if weights is None and ins_w is not None:
        raise ValueError("insert weights given for an unweighted base")
    if weights is not None and ni and ins_w is None:
        raise ValueError("weighted base requires insert weights")

    # Destinations of the dropped edges (few) by a search of row_ptr.
    dropped = np.flatnonzero(~keep)
    dropped_dst = np.searchsorted(row_ptr, dropped, side="right") - 1
    kept_per = np.diff(row_ptr).astype(np.int64) - np.bincount(
        dropped_dst, minlength=nv)
    ins_per = np.bincount(ins_dst, minlength=nv).astype(np.int64)

    new_rp = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(kept_per + ins_per, out=new_rp[1:])
    total = int(new_rp[-1])

    new_src = np.empty(total, dtype=col_src.dtype)
    has_w = weights is not None
    new_w = np.empty(total, dtype=weights.dtype) if has_w else None

    is_ins = np.zeros(total, dtype=bool)
    if ni:
        first = np.searchsorted(ins_dst, ins_dst)  # first index of each dst run
        rank = np.arange(ni, dtype=np.int64) - first
        d = ins_dst.astype(np.int64)
        pos_i = new_rp[d] + kept_per[d] + rank
        is_ins[pos_i] = True
        new_src[pos_i] = ins_src.astype(col_src.dtype)
        if has_w:
            new_w[pos_i] = ins_w
    # The kept edges, in base order, fill the other slots in order.
    is_kept = ~is_ins
    new_src[is_kept] = col_src[keep]
    if has_w:
        new_w[is_kept] = weights[keep]
    return new_rp, new_src, new_w
