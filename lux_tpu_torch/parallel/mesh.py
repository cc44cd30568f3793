"""The parts axis of the sharded engines, in one process on one device.

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
receiver's table of the rows its edges read.

One NCCL communicator cannot hold two ranks on one GPU, so P parts on one
card cannot be P processes. A ``torch.distributed`` backend behind the
same three methods comes with the multihost slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.graph.partition import ExchangePlan
from lux_tpu_torch.utils.platform import resolve_device

PARTS_AXIS = "parts"


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

    def all_gather(self, stacked: torch.Tensor) -> torch.Tensor:
        """(P, n, *t) shards → the (P * n, *t) table every part reads,
        as a view (no copy)."""
        self._check(stacked, "all_gather")
        return stacked.view((-1,) + tuple(stacked.shape[2:]))

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


def make_mesh(num_parts: Optional[int] = None, device=None) -> LocalMesh:
    """A :class:`LocalMesh` of ``num_parts`` parts on ``device`` (``cuda``
    unless named). ``num_parts`` defaults to the number of visible
    devices of that type, as ``lux_tpu``'s ``make_mesh`` defaults to all
    visible devices; any count runs on the one device."""
    dev = resolve_device(device)
    if num_parts is None:
        num_parts = torch.cuda.device_count() if dev.type == "cuda" else 1
    return LocalMesh(int(num_parts), dev)


def mesh_for(mesh: Optional[LocalMesh], num_parts: Optional[int],
             device) -> LocalMesh:
    """The mesh a sharded executor runs on: ``mesh`` if given (it decides
    the parts; a ``device`` named beside it must be of its type), else
    :func:`make_mesh` of ``num_parts`` on ``device``."""
    if mesh is None:
        return make_mesh(num_parts, device)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} differs from the mesh's "
                         f"{mesh.device}")
    return mesh


class CompactExchange:
    """The compact exchange of an :class:`ExchangePlan` over a
    :class:`LocalMesh`: flat index tables over the stacked ``(P, max_nv,
    *t)`` arrays, built once.

    Each sender gathers the rows its receivers read (``send_units``,
    clamped to ``max_nv - 1`` like ``lux_tpu``'s gather) with
    ``index_select``, the mesh's ``all_to_all`` moves the blocks, and
    each receiver scatters them by ``recv_pos`` into its own ``(P *
    max_nv + 1)``-row table with ``index_copy_``; the last row takes the
    pad entries and is sliced off. The receiver's own span is written
    from its local shard (as ``lux_tpu/engine/tiled_sharded.py:515``
    does), so every row an edge reads equals the full all-gather's, and
    rows no edge reads are zero (a bool frontier: False)."""

    def __init__(self, plan: ExchangePlan, mesh: LocalMesh, max_nv: int):
        P, n = mesh.num_parts, max_nv
        self.mesh, self.max_nv = mesh, n
        rows = P * n + 1
        parts = np.arange(P, dtype=np.int64)[:, None]
        send = np.minimum(plan.send_units.astype(np.int64), n - 1)
        recv = plan.recv_pos.astype(np.int64) + parts * rows
        own = parts * rows + parts * n + np.arange(n, dtype=np.int64)

        def put(a):
            return torch.from_numpy(a.reshape(-1)).to(mesh.device)

        # Sender p's gather list addresses only its own shard, receiver
        # q's scatter list only its own table of P * n + 1 rows.
        self.send, self.recv, self.own = (put(send + parts * n), put(recv),
                                          put(own))

    def tables(self, stacked: torch.Tensor) -> torch.Tensor:
        """(P, max_nv, *t) shards -> (P, P * max_nv, *t): row q is the
        flat table receiver q's edges read."""
        P, n = self.mesh.num_parts, self.max_nv
        tail = tuple(stacked.shape[2:])
        local = stacked.reshape((P * n,) + tail)
        packed = local.index_select(0, self.send)
        got = self.mesh.all_to_all(packed.view((P, -1) + tail))
        buf = stacked.new_zeros((P * (P * n + 1),) + tail)
        buf.index_copy_(0, self.recv, got.reshape((-1,) + tail))
        buf.index_copy_(0, self.own, local)
        return buf.view((P, P * n + 1) + tail)[:, :-1]
