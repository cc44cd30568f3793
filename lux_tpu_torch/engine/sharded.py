"""What the sharded executors share: the mesh, the partition, the
exchange mode and the operands of the parts a process holds.

A sharded executor stacks the L parts it holds on the leading axis of
``(L, max_nv, *t)`` arrays: all P parts on one device over a
:class:`~lux_tpu_torch.parallel.mesh.LocalMesh`, or a rank's P / W
consecutive parts over a :class:`~lux_tpu_torch.parallel.mesh.DistMesh`
of W ranks (:func:`~lux_tpu_torch.parallel.multihost.make_global_mesh`).
It launches each kernel once per held part over that part's real
in-edges (``local_row_ptr[p]``, ``src_pidx`` rows of the flat ``(P *
max_nv, *t)`` table of every part). The exchange builds that table: the
mesh's ``all_gather`` (full mode; a view of the stack on one device, one
collective across ranks) or, per receiver, a table of the rows its edges
read (:class:`~lux_tpu_torch.parallel.mesh.CompactExchange`, compact
mode). Every rank builds the whole partition on the host and holds the
same statistics (:func:`~lux_tpu_torch.parallel.mesh.gather_rows`), so
every rank takes the same branch; a sum over all parts is taken in part
order on the host, so results over ranks equal the one-device results
bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.ops.segment import RowTasks, storage_identity
from lux_tpu_torch.parallel.mesh import (
    AnyMesh,
    CompactExchange,
    gather_rows,
    mesh_for,
    own_parts,
)
from lux_tpu_torch.parallel.shard import (
    ShardedGraph,
    resolve_exchange,
    validated_sg,
)
from lux_tpu_torch.utils.logging import get_logger


def dtype_name(dtype) -> str:
    """``np.dtype(dtype).name`` of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


@dataclasses.dataclass(eq=False)
class Part:
    """One part's operands on the device: its CSC offsets, its real
    edges' flat source rows and weights (views of the stacked arrays),
    the first row of its own span in the flat table, and its kernels' row
    tasks (the card only)."""

    row_ptr: torch.Tensor             # (max_nv + 1,) int64
    col_src: torch.Tensor             # (n_e,) int32, rows of the flat table
    weights: Optional[torch.Tensor]   # (n_e,) int32 or None
    row_base: int                     # part * max_nv
    tasks: Optional[RowTasks] = None


class ShardedBase:
    """Mesh, partition, exchange and per-part operands of a sharded
    executor. A subclass calls :meth:`_setup`, then :meth:`_build_parts`
    once its exchange mode is final, and sets ``_row_bytes``, the
    interconnect bytes of one exchanged row. ``parts`` is the range of
    parts this process holds; device arrays hold those parts only."""

    _row_bytes: int

    def _setup(self, graph: Graph, program, mesh: Optional[AnyMesh],
               num_parts: Optional[int], sg: Optional[ShardedGraph],
               device, frontier_ok: bool = False) -> None:
        """The mesh, partition and exchange mode; ``frontier_ok`` (an
        exchange that carries per-iteration activity) lets
        ``LUX_EXCHANGE=frontier`` stay frontier, else it runs compact."""
        if program.needs_weights and graph.weights is None:
            raise ValueError(f"{program.name} requires an edge-weighted graph")
        self.mesh = mesh_for(mesh, num_parts, device)
        self.num_parts = self.mesh.num_parts
        self.parts = own_parts(self.mesh)
        self.device = self.mesh.device
        self.graph = graph
        self.program = program
        self.sg = validated_sg(sg, graph, self.num_parts)
        # The mode is captured here, once; a downgrade is logged.
        self.exchange_mode, self._xplan = resolve_exchange(
            self.sg, get_logger("engine"), frontier_ok=frontier_ok)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _own(self, stacked: np.ndarray) -> np.ndarray:
        """This process's parts of a host (P, ...) stack."""
        return stacked[self.parts.start:self.parts.stop]

    def _put_own(self, stacked: np.ndarray) -> torch.Tensor:
        return self._put(self._own(stacked))

    def _gathered(self, stacked: torch.Tensor) -> torch.Tensor:
        """(L, max_nv, *t) held parts -> the (P, max_nv, *t) stack of
        every part (a view on one device, a collective over ranks)."""
        flat = self.mesh.all_gather(stacked)
        return flat.view((self.num_parts, self.sg.max_nv)
                         + tuple(stacked.shape[2:]))

    def _gather_stats(self, stats: torch.Tensor) -> list:
        """The one host read of an iteration: the (L, k) per-part
        counters of the held parts -> the (P, k) rows of every part, as
        lists, the same on every rank."""
        return gather_rows(self.mesh, stats).tolist()

    def _build_parts(self, schedule: Callable[[np.ndarray, torch.device],
                                              RowTasks]) -> None:
        """The per-part operands and the compact exchange; on the card,
        each part's row tasks by ``schedule(local_row_ptr, device)``, the
        :class:`RowTasks` builder of the kernel the executor runs per
        part."""
        sg = self.sg
        n = sg.max_nv
        on_card = self.device.type != "cpu"
        self.vertex_mask = self._put_own(sg.vertex_mask)
        row_ptr = self._put_own(sg.local_row_ptr.astype(np.int64))
        src_pidx = self._put_own(sg.src_pidx)
        weights = None if sg.weights is None else self._put_own(sg.weights)
        self._parts: List[Part] = []
        for j, q in enumerate(self.parts):
            n_e = int(sg.local_row_ptr[q, -1])
            row_tasks = (schedule(sg.local_row_ptr[q], self.device)
                         if on_card else None)
            self._parts.append(Part(
                row_ptr=row_ptr[j],
                col_src=src_pidx[j, :n_e],
                weights=None if weights is None else weights[j, :n_e],
                row_base=q * n,
                tasks=row_tasks,
            ))
        self._xch = (None if self._xplan is None
                     else CompactExchange(self._xplan, self.mesh, n))

    def _pad(self, stacked: torch.Tensor):
        """What a compact table holds in rows no edge reads: the
        program combiner's identity in ``stacked``'s storage (a bool
        frontier: False), as ``lux_tpu`` pads its exchanged candidates
        (LUX405)."""
        if stacked.dtype == torch.bool:
            return False
        return storage_identity(self.program.combiner, stacked.dtype)

    def _exchange(self, stacked: torch.Tensor) -> torch.Tensor:
        """The flat table(s) the held parts read: the shared (P*max_nv,
        *t) all-gather (full), or (L, P*max_nv, *t), one per held
        receiver (compact)."""
        if self._xch is None:
            return self.mesh.all_gather(stacked)
        return self._xch.tables(stacked, self._pad(stacked))

    def _table(self, flat: Optional[torch.Tensor], q: int):
        """The table of the ``q``-th held part of what :meth:`_exchange`
        returned."""
        return flat if flat is None or self._xch is None else flat[q]

    def _exchange_spec(self, default_dtype=np.uint32) -> dict:
        """The exchange keys of a sharded ``trace_step`` dict, which the
        LUX404-406 rules read (``analysis/ir.py``): the mode, the byte
        claim, the combiner, the exchanged values' dtype, the parts and
        the live compact plan."""
        dt = getattr(self.program, "value_dtype", default_dtype)
        return {"sharded": True, "exchange_mode": self.exchange_mode,
                "exchange_bytes": self.exchange_bytes_per_iter(),
                "combiner": getattr(self.program, "combiner", ""),
                "value_dtype": dtype_name(dt), "num_parts": self.num_parts,
                "plan": self._xplan}

    def exchange_bytes_per_iter(self) -> int:
        """Interconnect bytes of one (dense) iteration's exchange, as
        ``lux_tpu`` prices them. Full: each of the P shards sends its
        max_nv rows of ``_row_bytes`` to the P-1 others. Compact: the
        plan's packed-capacity figure. The figure is the whole mesh's, on
        every rank; on one device neither crosses an interconnect."""
        if self._xplan is not None:
            return self._xplan.exchange_bytes_per_iter(self._row_bytes)
        p = self.num_parts
        return p * (p - 1) * self.sg.max_nv * self._row_bytes
