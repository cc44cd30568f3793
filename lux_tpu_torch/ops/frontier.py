"""The push engine's sparse iteration: frontier queue (K6) and queue
expansion with scatter-combine (K7); and the GAS engine's push-direction
accumulator over the same queue (K11).

The counterpart of the queue code in ``lux_tpu/engine/push.py``
(``_s_load``, ``_queue_edge_slots``, ``_s_comp``, ``_s_update``). There
the queue is static-shape: ``jnp.nonzero(frontier, size=Q)`` padded
with ``nv``, its CSR ranges laid into ``E`` static edge slots by a
marks cumsum, and the candidates scatter-combined with
``.at[dst].min/max``. Here the host already knows the frontier's size
and out-edge total (the engine reads both after every update to choose
its branch), so the queue and the edge slots are sized exactly:

- :func:`frontier_queue` (K6, ``csrc/frontier.cu``) compacts the bool
  frontier into ascending ids ``q`` with per-slot CSR ``start``,
  ``deg`` and the exclusive degree prefix ``offs`` (``cnt + 1`` long);
- :func:`queue_relax_scatter` (K7) expands the queued ranges, relaxes
  each queued vertex's pre-step value and combines it into a copy of
  the values with ``atomicMin``/``atomicMax``, for one receiver or for
  the P receiving parts of a sharded graph at once;
- :func:`gas_push_acc` (K11, ``csrc/gas.cu``) expands the same ranges,
  gathers with the CSR weights and combines into an identity-filled
  accumulator (``lux_tpu/engine/gas.py::AdaptiveExecutor._push_acc``),
  for one receiver or for the P receiving parts of a sharded graph at
  once (``lux_tpu/engine/gas_sharded.py::_push_comp``, one per shard
  there); k-core's sum needs the identity fill.

K7 and K11 are one cooperative launch each (``csrc/gas_ops.cuh``): the
copy or the identity fill, the fold and (f32) the decode, split by grid
barriers on K6's scratch for the stream.

Values are int32 storage of uint32 bit patterns (see
:mod:`lux_tpu_torch.ops.segment`). CPU tensors take the plain versions;
CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.ops.segment import (
    COMBINERS,
    EdgeFn,
    F32_GATHER_OPS,
    GATHER_OPS,
    gas_widen,
    gas_narrow,
    gas_identity_storage,
    gas_kernel_code,
    gas_storage_dtype,
    identity_for,
    kernel_codes,
    narrow_u32,
    plain_edge_fn,
    widen_u32,
)

# K6's scratch, one per (device, stream): a zeroed int64 tensor holding
# the grid barrier's two words and two totals per block (see
# csrc/frontier.cu); the barrier leaves it ready for the next call. K7 and
# K11 wait at the same barrier words: calls on one stream run in turn.
SCRATCH_BLOCKS = 4096
_SCRATCH: Dict[Tuple[int, Optional[int]], torch.Tensor] = {}


# The queue holds int32 ids, as lux_tpu's vertex ids are.
MAX_QUEUE_NV = 2**31 - 1


def _queue_scratch(dev: torch.device, stream: Optional[int]) -> torch.Tensor:
    key = (dev.index, stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        # setdefault keeps one scratch per key when two threads race here.
        scratch = _SCRATCH.setdefault(key, torch.zeros(
            2 + 2 * SCRATCH_BLOCKS, dtype=torch.int64, device=dev))
    return scratch


def frontier_queue_plain(frontier: torch.Tensor, row_ptr: torch.Tensor):
    """K6's plain version: (q int32, start int64, deg int64, offs int64)
    of the frontier's ascending ids, ``offs`` the exclusive prefix of
    ``deg`` with the total last."""
    q = torch.nonzero(frontier).reshape(-1)
    start = row_ptr[q]
    deg = row_ptr[q + 1] - start
    offs = torch.zeros(q.shape[0] + 1, dtype=torch.int64, device=q.device)
    torch.cumsum(deg, 0, out=offs[1:])
    return q.to(torch.int32), start, deg, offs


def frontier_queue(frontier: torch.Tensor, row_ptr: torch.Tensor, cnt: int):
    """The frontier queue of :func:`frontier_queue_plain`. ``cnt`` is the
    frontier's size, which the caller knows; the CUDA kernel fills
    exactly ``cnt`` slots and ``offs[cnt]``, in one cooperative launch.
    A frontier of more than ``2**31 - 1`` vertices raises ``ValueError``:
    the queue's int32 ids cannot hold them. Calls on different streams
    may run at once; each stream has its own scratch."""
    nv = frontier.shape[0]
    if nv > MAX_QUEUE_NV:
        raise ValueError(f"a frontier of {nv} vertices: the queue's int32 "
                         f"ids hold at most {MAX_QUEUE_NV}")
    if frontier.device.type == "cpu":
        return frontier_queue_plain(frontier, row_ptr)
    dev = frontier.device
    _cuda.check(frontier, "frontier", torch.bool, dev, ndim=1)
    _cuda.check(row_ptr, "row_ptr", torch.int64, dev, ndim=1)
    if row_ptr.shape[0] != nv + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries, "
                         f"frontier {nv}")
    q = torch.empty(cnt, dtype=torch.int32, device=dev)
    start = torch.empty(cnt, dtype=torch.int64, device=dev)
    deg = torch.empty(cnt, dtype=torch.int64, device=dev)
    offs = torch.empty(cnt + 1, dtype=torch.int64, device=dev)
    if cnt == 0:
        return q, start, deg, offs.zero_()
    stream = _cuda.stream(dev)
    _cuda.launch(
        "frontier_queue", "lux_frontier_queue",
        _cuda.ptr(frontier), nv, _cuda.ptr(row_ptr),
        _cuda.ptr(_queue_scratch(dev, stream.value)), SCRATCH_BLOCKS, cnt,
        _cuda.ptr(q), _cuda.ptr(start), _cuda.ptr(deg), _cuda.ptr(offs),
        stream,
    )
    return q, start, deg, offs


def queue_edges(q: torch.Tensor, start: torch.Tensor, offs: torch.Tensor):
    """(queue slot, CSR edge position) of every out-edge of the queue."""
    slot = torch.repeat_interleave(
        torch.arange(q.shape[0], device=q.device), offs.diff())
    edge = start[slot] + torch.arange(slot.shape[0], device=q.device) \
        - offs[:-1][slot]
    return slot, edge


def _receivers(start, offs, col_dst, weights, values):
    """Per receiver (start, offs, col_dst, weights or None) and the
    (P, n) view of ``values`` their rows are: one receiver for 1-D
    ranges, P for (P, ...) ones."""
    if start.dim() == 1:
        return ([(start, offs, col_dst, weights)], values.reshape(1, -1))
    return ([(start[p], offs[p], col_dst[p],
              None if weights is None else weights[p])
             for p in range(start.shape[0])],
            values.reshape(start.shape[0], -1))


def queue_relax_scatter_plain(
    q: torch.Tensor,
    start: torch.Tensor,
    offs: torch.Tensor,
    col_dst: torch.Tensor,
    values: torch.Tensor,
    kind: str,
    relax: EdgeFn,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7's plain version: a copy of ``values`` (int32 storage) into
    which, for every out-edge (u -> d) of every queued u,
    ``relax(values.flat[u], w)`` is combined with ``kind`` (min or max)
    at d. ``q`` indexes the flat values. With 1-D ``start``, ``offs``
    and ``col_dst`` (one receiver), d indexes the values; with (P, ...)
    ones (P receivers), receiver p's d index row p of ``values`` as
    (P, n) and its edges are ``col_dst[p]`` (and ``weights[p]``)."""
    recv, rows = _receivers(start, offs, col_dst, weights, values)
    flat = widen_u32(values).reshape(-1)
    new = widen_u32(rows)
    reduce = {"min": "amin", "max": "amax"}[kind]
    for p, (st, of, cd, w) in enumerate(recv):
        slot, edge = queue_edges(q, st, of)
        cand = relax(flat[q.long()[slot]], None if w is None else w[edge])
        new[p] = new[p].scatter_reduce(0, cd[edge].long(), cand,
                                       reduce=reduce, include_self=True)
    return narrow_u32(new).reshape(values.shape)


def queue_relax_scatter(
    q: torch.Tensor,
    start: torch.Tensor,
    offs: torch.Tensor,
    col_dst: torch.Tensor,
    values: torch.Tensor,
    kind: str,
    relax_op: Optional[str],
    total: int,
    relax: Optional[EdgeFn] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The new values of one sparse iteration (see
    :func:`queue_relax_scatter_plain`): a new table of ``values``' shape.
    ``total`` is the queue's out-edge count over all receivers (the sum
    of ``offs[..., -1]``), which the caller knows. A sharded graph's P
    receiving parts go in one call: (P, cnt) ``start``, (P, cnt + 1)
    ``offs``, (P, ne) ``col_dst`` and the (P, max_nv) pre-step values,
    whose flat rows ``q`` holds.

    CPU tensors take the plain version with ``relax`` (default: the
    plain form of ``relax_op``); CUDA tensors launch K7 once, which
    knows the relax only by ``relax_op`` (``"add1"`` or ``"copy"``),
    copies the values into the new table and reads the receivers'
    totals on the card. An empty queue, or one without out-edges,
    launches nothing."""
    if kind not in COMBINERS:
        raise ValueError(f"queue_relax_scatter: unsupported kind {kind!r}")
    if values.device.type == "cpu":
        return queue_relax_scatter_plain(q, start, offs, col_dst, values,
                                         kind, plain_edge_fn(relax_op, relax),
                                         weights)
    comb, op = kernel_codes(kind, relax_op)
    dev = values.device
    _cuda.check(q, "q", torch.int32, dev, ndim=1)
    ranks = 1 if start.dim() == 1 else 2
    parts = 1 if ranks == 1 else start.shape[0]
    _cuda.check(start, "start", torch.int64, dev, ndim=ranks)
    _cuda.check(offs, "offs", torch.int64, dev, ndim=ranks)
    _cuda.check(col_dst, "col_dst", torch.int32, dev, ndim=ranks)
    _cuda.check(values, "values", torch.int32, dev, ndim=ranks)
    cnt = q.shape[0]
    if start.shape[-1] != cnt or offs.shape[-1] != cnt + 1:
        raise ValueError(f"queue of {cnt} slots needs start (..., {cnt}) "
                         f"and offs (..., {cnt + 1})")
    if ranks == 2 and not (offs.shape[0] == col_dst.shape[0]
                           == values.shape[0] == parts):
        raise ValueError(f"{parts} receivers need {parts} rows of offs, "
                         "col_dst and values")
    if total < 0 or total > parts * col_dst.shape[-1]:
        raise ValueError(f"total {total} outside [0, "
                         f"{parts * col_dst.shape[-1]}]")
    if total == 0 or cnt == 0:
        return values.clone()
    out = torch.empty_like(values)
    stream = _cuda.stream(dev)
    _cuda.launch(
        "queue_relax_scatter", "lux_queue_relax_scatter",
        _cuda.ptr(q), _cuda.ptr(start), _cuda.ptr(offs), cnt, parts,
        _cuda.ptr(col_dst), col_dst.shape[-1], _cuda.ptr(values),
        _cuda.ptr(out), values.numel() // parts, total,
        _cuda.ptr(_queue_scratch(dev, stream.value)), comb, op, stream,
    )
    return out


def gas_push_acc_plain(
    q: torch.Tensor,
    start: torch.Tensor,
    offs: torch.Tensor,
    col_dst: torch.Tensor,
    values: torch.Tensor,
    kind: str,
    gather: EdgeFn,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K11's plain version: an identity-filled accumulator of ``values``'
    shape and storage type (int32 words of uint32 bits, or f32) into
    which, for every out-edge (u -> d) of every queued u,
    ``gather(values.flat[u], w)`` is combined with ``kind`` (min, max or
    sum) at d. ``q`` indexes the flat values. With 1-D ``start``,
    ``offs`` and ``col_dst`` (one receiver), d indexes the (nv,) values;
    with (P, ...) ones (P receivers), receiver p's d index row p of the
    (P, n) accumulator and its edges are ``col_dst[p]`` (and
    ``weights[p]``)."""
    recv, rows = _receivers(start, offs, col_dst, weights, values)
    vals, dom = gas_widen(values)
    flat = vals.reshape(-1)
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[kind]
    accs = []
    for st, of, cd, w in recv:
        slot, edge = queue_edges(q, st, of)
        msg = gather(flat[q.long()[slot]], None if w is None else w[edge])
        acc = torch.full(rows.shape[1:], identity_for(kind, dom),
                         dtype=msg.dtype, device=values.device)
        accs.append(acc.scatter_reduce(0, cd[edge].long(), msg,
                                       reduce=reduce, include_self=True))
    return gas_narrow(torch.stack(accs).reshape(values.shape), values)


def gas_push_acc(
    q: torch.Tensor,
    start: torch.Tensor,
    offs: torch.Tensor,
    col_dst: torch.Tensor,
    values: torch.Tensor,
    kind: str,
    gather_op: Optional[str],
    total: int,
    gather: Optional[EdgeFn] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The GAS engine's push-direction accumulator (see
    :func:`gas_push_acc_plain`) over the queue of :func:`frontier_queue`.
    ``total`` is the queue's out-edge count over all receivers (the sum
    of ``offs[..., -1]``), which the caller knows. A sharded graph's P
    receiving parts go in one call: (P, cnt) ``start``, (P, cnt + 1)
    ``offs``, (P, ne) ``col_dst`` and ``weights`` and the (P, max_nv)
    values, whose flat rows ``q`` holds; the accumulator is (P, max_nv).

    CPU tensors take the plain version with ``gather`` (default: the
    plain form of ``gather_op``); CUDA tensors launch K11 once (the
    identity fill of every receiver's row, the fold and, for f32, the
    decode), which knows the edge function only by ``gather_op`` and
    reads ``weights`` (the CSR's) for ``"add_w"``. An empty queue or one
    without out-edges launches nothing."""
    if values.device.type == "cpu":
        return gas_push_acc_plain(
            q, start, offs, col_dst, values, kind,
            plain_edge_fn(gather_op, gather, GATHER_OPS), weights)
    op = gas_kernel_code(kind, gather_op)
    dev = values.device
    ranks = 1 if start.dim() == 1 else 2
    parts = 1 if ranks == 1 else start.shape[0]
    _cuda.check(q, "q", torch.int32, dev, ndim=1)
    _cuda.check(start, "start", torch.int64, dev, ndim=ranks)
    _cuda.check(offs, "offs", torch.int64, dev, ndim=ranks)
    _cuda.check(col_dst, "col_dst", torch.int32, dev, ndim=ranks)
    _cuda.check(values, "values", gas_storage_dtype(gather_op), dev,
                ndim=ranks)
    cnt = q.shape[0]
    if start.shape[-1] != cnt or offs.shape[-1] != cnt + 1:
        raise ValueError(f"queue of {cnt} slots needs start (..., {cnt}) "
                         f"and offs (..., {cnt + 1})")
    if ranks == 2 and not (offs.shape[0] == col_dst.shape[0]
                           == values.shape[0] == parts):
        raise ValueError(f"{parts} receivers need {parts} rows of offs, "
                         "col_dst and values")
    if total < 0 or total > parts * col_dst.shape[-1]:
        raise ValueError(f"total {total} outside [0, "
                         f"{parts * col_dst.shape[-1]}]")
    weighted = gather_op in F32_GATHER_OPS
    if weighted:
        if weights is None:
            raise ValueError(f"gather op {gather_op!r} needs edge weights")
        _cuda.check(weights, "weights", torch.int32, dev, ndim=ranks)
        if weights.shape != col_dst.shape:
            raise ValueError("weights and col_dst differ in shape")
    if total == 0 or cnt == 0:
        return gas_identity_storage(kind, values.shape, values.dtype, dev)
    acc = torch.empty_like(values)
    # One receiver keeps strides of 0, as before the P-receiver form.
    dst_stride = col_dst.shape[-1] if ranks == 2 else 0
    acc_stride = values.shape[-1] if ranks == 2 else 0
    stream = _cuda.stream(dev)
    _cuda.launch(
        "gas_push_acc", "lux_gas_push_acc", _cuda.ptr(q), _cuda.ptr(start),
        _cuda.ptr(offs), cnt, parts, total, _cuda.ptr(col_dst), dst_stride,
        _cuda.ptr(weights if weighted else None), _cuda.ptr(values), op,
        _cuda.ptr(acc), acc_stride, acc.numel(),
        _cuda.ptr(_queue_scratch(dev, stream.value)), stream,
    )
    return acc
