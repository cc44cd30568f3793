"""Multi-process execution: the counterpart of
``lux_tpu/parallel/multihost.py``.

``lux_tpu`` goes multi-node through JAX's distributed runtime: every
process calls ``initialize`` once, then ``make_global_mesh`` gives the
1-D ``parts`` mesh over every device of every process, and the sharded
executors run SPMD over whatever mesh they are handed. Here the runtime
is ``torch.distributed``:

- :func:`initialize` starts the process group (``torchrun``'s
  environment when called bare);
- :func:`make_global_mesh` gives a
  :class:`~lux_tpu_torch.parallel.mesh.DistMesh` of P parts over the W
  ranks of the group, P / W consecutive parts a rank, in
  :func:`ordered_ranks` order (node-major, so neighbouring parts share a
  node, as ``ordered_devices`` makes them share a slice).

A rank that holds several parts is the counterpart of a JAX process that
owns several devices. NCCL refuses two ranks on one card, so ranks that
share a card use ``gloo``, whose collectives the mesh stages through
pinned host buffers. ``lux_tpu``'s ``utils/compat.py`` is a JAX shim and
has no counterpart.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from lux_tpu_torch.parallel.mesh import DistMesh
from lux_tpu_torch.utils.platform import resolve_device

_INFO_KEY = "lux_tpu_torch/rank_info/"


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """Where one rank runs: its host, its index among the host's ranks,
    its rank in the group and, with a card, the card's UUID (empty on
    the CPU)."""

    node: str
    local_rank: int
    rank: int
    card: str = ""


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def _local_rank(rank: int) -> int:
    local = _env_int("LOCAL_RANK")
    if local is not None:
        return local
    per_node = _env_int("LOCAL_WORLD_SIZE")
    return rank % per_node if per_node else rank


def default_backend(world_size: Optional[int] = None) -> str:
    """``nccl`` when every rank of this node has a card of its own,
    else ``gloo``. The node's rank count is ``LOCAL_WORLD_SIZE`` (as
    ``torchrun`` sets it), else the world size."""
    if not torch.cuda.is_available():
        return "gloo"
    per_node = (_env_int("LOCAL_WORLD_SIZE") or world_size
                or _env_int("WORLD_SIZE") or 1)
    return "nccl" if per_node <= torch.cuda.device_count() else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Start ``torch.distributed``'s process group (a no-op if one
    exists, as ``lux_tpu``'s ``initialize`` is once JAX's runtime runs).

    A bare call reads the launcher's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, as
    ``torchrun`` sets them), as a bare ``jax.distributed.initialize()``
    reads the TPU metadata. A one-rank group without ``init_method`` or
    ``MASTER_ADDR`` takes a free port on ``localhost``. ``backend``
    defaults to :func:`default_backend`; for ``nccl`` each rank takes
    the card of its local rank."""
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    backend = backend or default_backend(world_size)
    if (init_method is None and "MASTER_ADDR" not in os.environ
            and world_size == 1):
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    if backend == "nccl":
        count = torch.cuda.device_count()
        if count:
            torch.cuda.set_device(_local_rank(rank or 0) % count)
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method, **kw)


def ordered_ranks(ranks: Sequence, num_parts: Optional[int] = None) -> List:
    """Node-major rank ordering and the shrink validation, as a pure
    function over anything rank-shaped (``node``, ``local_rank`` and
    ``rank`` attributes), the counterpart of ``ordered_devices``: ranks
    of one node are neighbours, so the parts they hold are. Returns the
    full ordered list; raises ``ValueError`` naming the ranks a
    ``num_parts`` below the rank count would leave without a part, since
    every rank must own a piece of the computation."""
    ordered = sorted(ranks, key=lambda r: (str(r.node), r.local_rank,
                                           r.rank))
    if num_parts is not None and num_parts < len(ordered):
        left = sorted(r.rank for r in ordered[num_parts:])
        raise ValueError(
            f"num_parts={num_parts} would leave ranks {left} without a "
            "part; every rank of the group must hold at least one")
    return ordered


def check_nccl_cards(ranks: Sequence[RankInfo], backend: str) -> None:
    """Refuse an ``nccl`` group in which two ranks share one card (NCCL
    cannot hold them); ranks that share a card run over ``gloo``."""
    if backend != "nccl":
        return
    seen = {}
    for r in ranks:
        key = (r.node, r.card)
        if key in seen:
            raise ValueError(
                f"ranks {seen[key]} and {r.rank} share card {r.card} on "
                f"{r.node}: NCCL cannot hold two ranks on one card; "
                "initialize(backend='gloo') for ranks that share a card")
        seen[key] = r.rank


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return ""
    props = torch.cuda.get_device_properties(device)
    return str(getattr(props, "uuid", "")) or f"cuda:{device.index}"


def _exchange_info(mine: RankInfo, world: int) -> List[RankInfo]:
    """Every rank's :class:`RankInfo`, through the group's store: no
    collective of the backend runs before the card check."""
    store = dist.distributed_c10d._get_default_store()
    store.set(f"{_INFO_KEY}{mine.rank}",
              f"{mine.node}\t{mine.local_rank}\t{mine.card}")
    out = []
    for r in range(world):
        node, local, card = store.get(f"{_INFO_KEY}{r}").decode().split(
            "\t")
        out.append(RankInfo(node, int(local), r, card))
    return out


def make_global_mesh(num_parts: Optional[int] = None,
                     device=None) -> DistMesh:
    """A :class:`DistMesh` of ``num_parts`` parts (default: one a rank)
    over the W ranks of the group, each rank holding ``num_parts / W``
    consecutive parts in :func:`ordered_ranks` order, on ``device``
    (default: the card of the rank's local rank; ``cpu`` for the plain
    versions). Refuses a ``num_parts`` that W does not divide, and an
    ``nccl`` group in which two ranks share a card."""
    if not dist.is_initialized():
        raise RuntimeError("make_global_mesh needs initialize() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_parts is None:
        num_parts = world
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda",
                           _local_rank(rank) % torch.cuda.device_count())
    mine = RankInfo(socket.gethostname(), _local_rank(rank), rank,
                    _card(dev))
    infos = _exchange_info(mine, world)
    backend = dist.get_backend()
    check_nccl_cards(infos, backend)
    order = [r.rank for r in ordered_ranks(infos, num_parts)]
    if num_parts % world:
        raise ValueError(f"num_parts={num_parts} does not split over "
                         f"{world} ranks; use a multiple of {world}")
    return DistMesh(num_parts, dev, order=tuple(order))
