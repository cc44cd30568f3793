"""The parts axis of the sharded engines: in one process on one device,
or over the ranks of a ``torch.distributed`` group.

The counterpart of ``lux_tpu/parallel/mesh.py``. There the P parts of a
sharded graph live on a 1-D ``jax.sharding.Mesh`` of P devices (on a CPU
host, virtual devices: ``lux_tpu/utils/platform.py::virtual_cpu_flags``),
and parts meet only in the collectives of ``shard_map``. Here every
per-part array is stacked along a leading ``(P, ...)`` axis on ONE
device, and :class:`LocalMesh` gives the three collectives the sharded
engines need over that axis. They are the only place where parts meet:

- :meth:`LocalMesh.all_gather`: every part sees every shard. On one
  device the stack already is the flat ``(P * max_nv, *t)`` table, so
  this is a view and moves no byte;
- :meth:`LocalMesh.all_to_all`: block ``q`` of sender ``p`` goes to
  receiver ``q`` (``jax.lax.all_to_all`` with ``split_axis=0,
  concat_axis=0, tiled=True``), one copy on one device;
- :meth:`LocalMesh.reduce_scatter`: receiver ``q`` gets the sum over
  senders of their block ``q`` (``jax.lax.psum_scatter`` with
  ``scatter_dimension=0, tiled=True``), summed in sender order.

On top of them, :class:`CompactExchange` is the compact
(``LUX_EXCHANGE=compact``) exchange of the sharded engines: each
receiver's table of the rows its edges read; :class:`FrontierExchange`
the frontier (``LUX_EXCHANGE=frontier``) exchange of the sharded GAS
engine: of those rows, only the ones whose source is active.

Across processes, :class:`DistMesh` gives the same three methods over
the ranks of a ``torch.distributed`` group
(:func:`~lux_tpu_torch.parallel.multihost.make_global_mesh`), each rank
holding P / W consecutive parts as a ``(P / W, ...)`` stack: the
all-gather is one ``all_gather_into_tensor``, the all-to-all one
``all_to_all_single`` after a local reorder, and the reduce-scatter that
all-to-all followed by the same sum in sender order on the device (never
the backend's own reduction, whose order is the backend's), so a float
result over ranks is bitwise the one-card result. :func:`own_parts` and
:func:`gather_rows` give an executor the parts it holds and the
``(P, k)`` statistics every part sees, on either mesh. One NCCL
communicator cannot hold two ranks on one card, so ranks that share a
card run over ``gloo``, which :class:`DistMesh` stages through pinned
host buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from lux_tpu_torch.graph.partition import ExchangePlan
from lux_tpu_torch.utils import tracehooks
from lux_tpu_torch.utils.platform import resolve_device

PARTS_AXIS = "parts"

# One all-gather into a tensor: ``all_gather_single`` where torch has it
# (its ``all_gather_into_tensor`` is the same call under an older name).
_all_gather_into = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)


def _shard_bytes(x: torch.Tensor) -> int:
    """Bytes of one part's operand of a ``(L, ...)`` stack."""
    return x.numel() * x.element_size() // max(int(x.shape[0]), 1)


def _gather_bytes(mesh, x: torch.Tensor) -> int:
    """The whole mesh's bytes of an all-gather, as ``lux_tpu`` prices
    them: every part receives every other part's operand."""
    p = mesh.num_parts
    return p * (p - 1) * _shard_bytes(x)


def _to_all_bytes(mesh, x: torch.Tensor) -> int:
    """The whole mesh's bytes of an all-to-all (and of a reduce-scatter,
    which sends the same blocks): each part keeps its own 1/P chunk and
    sends the rest."""
    return (mesh.num_parts - 1) * _shard_bytes(x)


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """``num_parts`` parts on one ``device``."""

    num_parts: int
    device: torch.device

    def __post_init__(self):
        if self.num_parts < 1:
            raise ValueError(f"num_parts must be >= 1 (got {self.num_parts})")
        object.__setattr__(self, "device", torch.device(self.device))

    def _check(self, stacked: torch.Tensor, name: str) -> None:
        if stacked.dim() < 2 or stacked.shape[0] != self.num_parts:
            raise ValueError(
                f"{name} takes a ({self.num_parts}, n, ...) stack, got "
                f"{tuple(stacked.shape)}")

    @tracehooks.collective("all_gather", _gather_bytes)
    def all_gather(self, stacked: torch.Tensor) -> torch.Tensor:
        """(P, n, *t) shards → the (P * n, *t) table every part reads,
        as a view (no copy)."""
        self._check(stacked, "all_gather")
        return stacked.view((-1,) + tuple(stacked.shape[2:]))

    @tracehooks.collective("all_to_all", _to_all_bytes)
    def all_to_all(self, blocks: torch.Tensor) -> torch.Tensor:
        """(P, P * cap, *t) → (P, P * cap, *t): row block ``q`` of sender
        ``p`` becomes row block ``p`` of receiver ``q``."""
        self._check(blocks, "all_to_all")
        p = self.num_parts
        if blocks.shape[1] % p:
            raise ValueError(
                f"all_to_all: {blocks.shape[1]} rows per part do not split "
                f"into {p} blocks")
        tail = tuple(blocks.shape[2:])
        cap = blocks.shape[1] // p
        return (blocks.reshape((p, p, cap) + tail).transpose(0, 1)
                .reshape((p, p * cap) + tail))

    @tracehooks.collective("reduce_scatter", _to_all_bytes)
    def reduce_scatter(self, blocks: torch.Tensor) -> torch.Tensor:
        """(P, P * n, *t) → (P, n, *t): receiver ``q`` gets the sum over
        senders ``p`` of row block ``q`` of sender ``p``. The senders are
        added in order 0, 1, ..., P-1, so the result is the same from
        run to run."""
        self._check(blocks, "reduce_scatter")
        p = self.num_parts
        if blocks.shape[1] % p:
            raise ValueError(
                f"reduce_scatter: {blocks.shape[1]} rows per part do not "
                f"split into {p} blocks")
        tail = tuple(blocks.shape[2:])
        per = blocks.reshape((p, p, blocks.shape[1] // p) + tail)
        out = per[0].clone()
        for sender in range(1, p):
            out += per[sender]
        return out


class DistMesh:
    """``num_parts`` parts over the W ranks of the ``torch.distributed``
    group, ``num_parts / W`` consecutive parts a rank on its ``device``.
    ``order`` lists the group's ranks in part order (default: rank
    order); the rank at position s holds parts ``s * L .. s * L + L -
    1``, L = ``num_parts / W``.

    Each collective takes the rank's local ``(L, ...)`` stack and is
    called by every rank. Over ``gloo`` a CUDA tensor is staged: copied
    into a pinned host buffer (one a shape, dtype and direction, kept
    for the mesh's life) with the copy waited for, moved by gloo, and
    copied back to the card; ``staged_bytes`` counts both copies."""

    def __init__(self, num_parts: int, device,
                 order: Optional[Sequence[int]] = None):
        world = dist.get_world_size()
        if num_parts < 1 or num_parts % world:
            raise ValueError(f"num_parts={num_parts} does not split over "
                             f"{world} ranks")
        order = tuple(range(world)) if order is None else tuple(order)
        if sorted(order) != list(range(world)):
            raise ValueError(f"order {order} is not the ranks 0..{world - 1}")
        self.num_parts, self.world = int(num_parts), world
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.parts_per_rank = self.num_parts // world
        slot = order.index(self.rank)
        self.local_parts = range(slot * self.parts_per_rank,
                                 (slot + 1) * self.parts_per_rank)
        # Chunk d of a collective is group rank d's; these reorder chunks
        # between rank order and part (slot) order when the two differ.
        self._slot_of_rank = (None if order == tuple(range(world)) else
                              torch.tensor([order.index(r)
                                            for r in range(world)]))
        self._rank_of_slot = (None if self._slot_of_rank is None
                              else torch.tensor(order))
        self._staged = self.backend == "gloo" and self.device.type == "cuda"
        self._host: Dict[Tuple, torch.Tensor] = {}
        self._pending: Dict[Tuple, torch.cuda.Event] = {}
        self.staged_bytes = 0

    def __repr__(self) -> str:
        return (f"DistMesh(num_parts={self.num_parts}, world={self.world}, "
                f"rank={self.rank}, parts={list(self.local_parts)}, "
                f"backend={self.backend}, device={self.device})")

    def _check(self, stacked: torch.Tensor, name: str) -> None:
        if stacked.dim() < 2 or stacked.shape[0] != self.parts_per_rank:
            raise ValueError(
                f"{name} takes a ({self.parts_per_rank}, n, ...) stack, "
                f"got {tuple(stacked.shape)}")

    def _buffer(self, tag: str, like: torch.Tensor) -> torch.Tensor:
        key = (tag, tuple(like.shape), like.dtype)
        buf = self._host.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._host[key] = buf
        return buf

    def _run(self, fn, out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """``fn(out, inp)`` over the group, staged through pinned host
        buffers for gloo on the card."""
        if not self._staged:
            fn(out, inp)
            return out
        h_in = self._buffer("in", inp)
        h_in.copy_(inp)                      # waits for the copy
        key = ("out", tuple(out.shape), out.dtype)
        h_out = self._buffer("out", out)
        if key in self._pending:             # its last copy to the card
            self._pending.pop(key).synchronize()
        fn(h_out, h_in)
        out.copy_(h_out, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._pending[key] = ev
        self.staged_bytes += (inp.numel() * inp.element_size()
                              + out.numel() * out.element_size())
        return out

    @tracehooks.collective("all_gather", _gather_bytes)
    def all_gather(self, stacked: torch.Tensor) -> torch.Tensor:
        """(L, n, *t) local shards → the (P * n, *t) table every part
        reads, in part order: one all-gather into a tensor
        (``all_gather_into_tensor``)."""
        self._check(stacked, "all_gather")
        inp = stacked.contiguous()
        out = inp.new_empty((self.world,) + tuple(inp.shape))
        if inp.numel():
            self._run(_all_gather_into, out.view(
                (-1,) + tuple(inp.shape[1:])), inp)
        if self._rank_of_slot is not None:
            out = out.index_select(0, self._rank_of_slot.to(out.device))
        return out.view((-1,) + tuple(inp.shape[2:]))

    @tracehooks.collective("all_to_all", _to_all_bytes)
    def all_to_all(self, blocks: torch.Tensor) -> torch.Tensor:
        """(L, P * cap, *t) → (L, P * cap, *t): row block ``q`` of sender
        ``p`` becomes row block ``p`` of receiver ``q``: the senders'
        blocks reordered by receiving rank, then one
        ``all_to_all_single``."""
        self._check(blocks, "all_to_all")
        P, W, L = self.num_parts, self.world, self.parts_per_rank
        if blocks.shape[1] % P:
            raise ValueError(
                f"all_to_all: {blocks.shape[1]} rows per part do not split "
                f"into {P} blocks")
        tail = tuple(blocks.shape[2:])
        cap = blocks.shape[1] // P
        # (sender j, slot s, receiver i) -> (slot s, receiver i, sender j)
        send = blocks.reshape((L, W, L, cap) + tail).permute(
            (1, 2, 0) + tuple(range(3, 4 + len(tail))))
        if self._slot_of_rank is not None:
            send = send.index_select(0, self._slot_of_rank.to(send.device))
        send = send.contiguous()
        got = torch.empty_like(send)
        if send.numel():
            self._run(dist.all_to_all_single, got, send)
        if self._rank_of_slot is not None:
            got = got.index_select(0, self._rank_of_slot.to(got.device))
        # (sending slot, receiver i, sender j) -> receiver i's blocks in
        # sender order s * L + j.
        return got.transpose(0, 1).reshape((L, P * cap) + tail)

    @tracehooks.collective("reduce_scatter", _to_all_bytes)
    def reduce_scatter(self, blocks: torch.Tensor) -> torch.Tensor:
        """(L, P * n, *t) → (L, n, *t): receiver ``q`` gets the sum over
        senders ``p`` of row block ``q`` of sender ``p``, added in order
        0, 1, ..., P-1 on the device after :meth:`all_to_all`, as
        :meth:`LocalMesh.reduce_scatter` adds them."""
        self._check(blocks, "reduce_scatter")
        P = self.num_parts
        if blocks.shape[1] % P:
            raise ValueError(
                f"reduce_scatter: {blocks.shape[1]} rows per part do not "
                f"split into {P} blocks")
        tail = tuple(blocks.shape[2:])
        got = self.all_to_all(blocks)
        per = got.reshape((self.parts_per_rank, P, blocks.shape[1] // P)
                          + tail)
        out = per[:, 0].clone()
        for sender in range(1, P):
            out += per[:, sender]
        return out


AnyMesh = Union[LocalMesh, DistMesh]


def own_parts(mesh: AnyMesh) -> range:
    """The parts this process holds: all of a :class:`LocalMesh`'s, a
    rank's own of a :class:`DistMesh`."""
    if isinstance(mesh, DistMesh):
        return mesh.local_parts
    return range(mesh.num_parts)


def gather_rows(mesh: AnyMesh, rows: torch.Tensor) -> torch.Tensor:
    """(L, k) rows of this process's parts → the (P, k) rows of every
    part, in part order, the same on every rank (the per-part counters a
    decision reads)."""
    if isinstance(mesh, DistMesh):
        return mesh.all_gather(rows).view(mesh.num_parts, -1)
    return rows


def make_mesh(num_parts: Optional[int] = None, device=None) -> LocalMesh:
    """A :class:`LocalMesh` of ``num_parts`` parts on ``device`` (``cuda``
    unless named). ``num_parts`` defaults to the number of visible
    devices of that type, as ``lux_tpu``'s ``make_mesh`` defaults to all
    visible devices; any count runs on the one device."""
    dev = resolve_device(device)
    if num_parts is None:
        num_parts = torch.cuda.device_count() if dev.type == "cuda" else 1
    return LocalMesh(int(num_parts), dev)


def mesh_for(mesh: Optional[AnyMesh], num_parts: Optional[int],
             device) -> AnyMesh:
    """The mesh a sharded executor runs on: ``mesh`` if given (a
    :class:`LocalMesh` or a :class:`DistMesh`; it decides the parts, and
    a ``device`` named beside it must be of its type), else
    :func:`make_mesh` of ``num_parts`` on ``device``."""
    if mesh is None:
        return make_mesh(num_parts, device)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} differs from the mesh's "
                         f"{mesh.device}")
    return mesh


def _put_on(device):
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return put


class CompactExchange:
    """The compact exchange of an :class:`ExchangePlan` over a mesh:
    flat index tables over the stacked ``(L, max_nv, *t)`` arrays of the
    L parts this process holds (:func:`own_parts`), built once.

    Each sender gathers the rows its receivers read (``send_units``,
    clamped to ``max_nv - 1`` like ``lux_tpu``'s gather) with
    ``index_select``, the mesh's ``all_to_all`` moves the blocks, and
    each receiver scatters them by ``recv_pos`` into its own ``(P *
    max_nv + 1)``-row table with ``index_copy_``; the last row takes the
    pad entries and is sliced off. The receiver's own span is written
    from its local shard (as ``lux_tpu/engine/tiled_sharded.py:515``
    does), so every row an edge reads equals the full all-gather's, and
    rows no edge reads hold the pad :meth:`tables` is given (a bool
    frontier: False)."""

    def __init__(self, plan: ExchangePlan, mesh: AnyMesh, max_nv: int):
        P, n = mesh.num_parts, max_nv
        own = own_parts(mesh)
        self.mesh, self.max_nv, self.num_local = mesh, n, len(own)
        rows = P * n + 1
        local = np.arange(len(own), dtype=np.int64)[:, None]
        glob = local + own.start
        send = np.minimum(plan.send_units[own.start:own.stop]
                          .astype(np.int64), n - 1)
        recv = (plan.recv_pos[own.start:own.stop].astype(np.int64)
                + local * rows)
        mine = local * rows + glob * n + np.arange(n, dtype=np.int64)
        put = _put_on(mesh.device)
        # Sender p's gather list addresses only its own shard, receiver
        # q's scatter list only its own table of P * n + 1 rows.
        self.send, self.recv, self.own = (put((send + local * n).ravel()),
                                          put(recv.ravel()),
                                          put(mine.ravel()))

    def tables(self, stacked: torch.Tensor, pad=0) -> torch.Tensor:
        """(L, max_nv, *t) shards -> (L, P * max_nv, *t): row q is the
        flat table receiver q's edges read; rows no edge reads hold
        ``pad`` (the program combiner's identity in the stack's storage,
        as ``lux_tpu`` pads its exchanged candidates)."""
        P, n, L = self.mesh.num_parts, self.max_nv, self.num_local
        tail = tuple(stacked.shape[2:])
        local = stacked.reshape((L * n,) + tail)
        packed = local.index_select(0, self.send)
        got = self.mesh.all_to_all(packed.view((L, -1) + tail))
        buf = stacked.new_full((L * (P * n + 1),) + tail, pad)
        buf.index_copy_(0, self.recv, got.reshape((-1,) + tail))
        buf.index_copy_(0, self.own, local)
        return buf.view((L, P * n + 1) + tail)[:, :-1]


class FrontierExchange:
    """The frontier exchange of an :class:`ExchangePlan` over a mesh, for
    scalar values and a bool frontier of the L parts this process holds:
    per (sender, receiver) pair, only the plan's send rows whose source
    is active this iteration, compacted in send-table order into ``cap``
    sentinel-padded slots (``lux_tpu/engine/gas_sharded.py::
    _frontier_tables``).

    :meth:`widest` is what decides whether an iteration may take it:
    each sender's largest count of active send rows over its receivers.
    An iteration whose count exceeds ``cap`` on any pair takes the
    static compact send instead (the caller's downgrade), so no active
    row is ever cut. :meth:`tables` compacts the active rows (a
    ``cumsum`` and a scatter), gathers their values with
    ``torch.gather``, moves (row id, value) pairs with the mesh's
    ``all_to_all`` and scatters them by ``sender * max_nv + row`` into
    each receiver's table with ``index_copy_``, frontier True. Rows not
    sent keep (pad, False): their sources are inactive, so a pull masks
    them to the combiner identity, as the compact table's do. The
    receiver's own span is written from its shard, as
    :class:`CompactExchange` writes it."""

    def __init__(self, plan: ExchangePlan, mesh: AnyMesh, max_nv: int,
                 cap: int):
        if not 1 <= cap <= plan.capacity:
            raise ValueError(f"frontier capacity {cap} outside [1, "
                             f"{plan.capacity}]")
        P, n = mesh.num_parts, max_nv
        own = own_parts(mesh)
        L = len(own)
        self.mesh, self.max_nv, self.cap, self.num_local = mesh, n, int(
            cap), L
        rows = P * n + 1
        local = np.arange(L, dtype=np.int64)[:, None]
        send = (plan.send_units[own.start:own.stop].astype(np.int64)
                .reshape(L, P, plan.capacity))
        sender = np.arange(P * cap, dtype=np.int64) // cap
        put = _put_on(mesh.device)

        # Sender p's send rows to each receiver (sentinel n), whether each
        # is a real row, and where its frontier flag lies in the flat stack.
        self.send = put(send)
        self.real = put(send < n)
        self.flag_at = put((np.minimum(send, n - 1)
                            + local[:, :, None] * n).reshape(-1))
        # Receiver q's table starts at q * rows of one flat buffer; a
        # block from sender p lands at p * n + row, a pad in the last row.
        self.base = put(local * rows + sender[None, :] * n)
        self.trash = put(local * rows + P * n)
        self.own = put((local * rows + (local + own.start) * n
                        + np.arange(n, dtype=np.int64)).reshape(-1))

    def _active(self, frontier: torch.Tensor) -> torch.Tensor:
        """(L, P, capacity): which send rows have an active source."""
        f = frontier.reshape(-1).index_select(0, self.flag_at)
        return self.real & f.view(self.real.shape)

    def widest(self, frontier: torch.Tensor) -> torch.Tensor:
        """(L,) int64: each sender's largest count of active send rows
        to one receiver."""
        return self._active(frontier).sum(2).amax(1)

    def tables(self, values: torch.Tensor, frontier: torch.Tensor, pad=0):
        """(L, max_nv) values and frontier -> (values table, frontier
        table), each (L, P * max_nv): row q is the flat table receiver
        q's edges read; values of rows not sent are ``pad`` (the
        combiner's identity in the values' storage). Only for an
        iteration whose :meth:`widest` is at most ``cap`` everywhere
        (the rest would be cut)."""
        P, n, cap, L = (self.mesh.num_parts, self.max_nv, self.cap,
                        self.num_local)
        act = self._active(frontier)
        pos = act.cumsum(2) - 1
        keep = act & (pos < cap)
        slot = torch.where(keep, pos, cap)          # cap: a trash column
        rows = torch.full((L, P, cap + 1), n, dtype=torch.int64,
                          device=values.device)
        rows.scatter_(2, slot, torch.where(keep, self.send, n))
        rows = rows[:, :, :cap].reshape(L, P * cap)
        vals = values.gather(1, rows.clamp(max=n - 1))
        got_rows = self.mesh.all_to_all(rows)
        got_vals = self.mesh.all_to_all(vals)
        at = torch.where(got_rows < n, self.base + got_rows,
                         self.trash).reshape(-1)
        width = P * n + 1
        tab_v = values.new_full((L * width,), pad)
        tab_f = frontier.new_zeros(L * width)
        tab_v.index_copy_(0, at, got_vals.reshape(-1))
        tab_f.index_fill_(0, at, True)
        tab_v.index_copy_(0, self.own, values.reshape(-1))
        tab_f.index_copy_(0, self.own, frontier.reshape(-1))
        return (tab_v.view(L, width)[:, :-1], tab_f.view(L, width)[:, :-1])
