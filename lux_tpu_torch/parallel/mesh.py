"""The parts axis of the sharded engines, in one process on one device.

The counterpart of ``lux_tpu/parallel/mesh.py``. There the P parts of a
sharded graph live on a 1-D ``jax.sharding.Mesh`` of P devices (on a CPU
host, virtual devices: ``lux_tpu/utils/platform.py::virtual_cpu_flags``),
and parts meet only in the collectives of ``shard_map``. Here every
per-part array is stacked along a leading ``(P, ...)`` axis on ONE
device, and :class:`LocalMesh` gives the two collectives the pull engine
needs over that axis. They are the only place where parts meet:

- :meth:`LocalMesh.all_gather`: every part sees every shard. On one
  device the stack already is the flat ``(P * max_nv, *t)`` table, so
  this is a view and moves no byte;
- :meth:`LocalMesh.all_to_all`: block ``q`` of sender ``p`` goes to
  receiver ``q`` (``jax.lax.all_to_all`` with ``split_axis=0,
  concat_axis=0, tiled=True``), one copy on one device.

One NCCL communicator cannot hold two ranks on one GPU, so P parts on one
card cannot be P processes. A ``torch.distributed`` backend behind the
same two methods comes with the multihost slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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


def make_mesh(num_parts: Optional[int] = None, device=None) -> LocalMesh:
    """A :class:`LocalMesh` of ``num_parts`` parts on ``device`` (``cuda``
    unless named). ``num_parts`` defaults to the number of visible
    devices of that type, as ``lux_tpu``'s ``make_mesh`` defaults to all
    visible devices; any count runs on the one device."""
    dev = resolve_device(device)
    if num_parts is None:
        num_parts = torch.cuda.device_count() if dev.type == "cuda" else 1
    return LocalMesh(int(num_parts), dev)
