"""Sharded push executors: the P parts of an edge-balanced partition, on
one device.

The counterparts of ``ShardedPushExecutor`` and
``ShardedMultiSourcePushExecutor`` in ``lux_tpu/engine/push.py``, which
run one part per device of a ``shard_map`` mesh. Here the parts are the
leading axis of stacked ``(P, max_nv)`` values and frontier on one
device (:class:`~lux_tpu_torch.parallel.mesh.LocalMesh`), and each
kernel is launched once per part, as ``lux_tpu`` runs one device per
part, except the sparse branch's K7: one launch for every part.

:class:`ShardedPushExecutor` chooses a branch per iteration exactly as
``lux_tpu`` does: from the largest part's frontier count (``pmax``
there) and the frontier's out-edge total over all parts (``psum``).
The update leaves both as one small ``(P, 2)`` tensor, each part's
count and out-edge total, that the host reads once per iteration; the
read is also the halt check.

- **dense**: the exchange, then one K5 launch
  (``ops/segment.py::segment_minmax_relax``) per part over its real
  in-edges (``local_row_ptr[p]``, ``src_pidx`` rows of the flat table),
  each row written once over the part's ``RowTasks``, into its row of
  the accumulator; then the merge and the pad mask.
  Full exchange: the mesh's ``all_gather``, a view of the stack: of the
  packed ``value | frontier << 31`` words under ``blocked_dense``, else
  of the values and of the frontier. Compact
  (:class:`~lux_tpu_torch.parallel.mesh.CompactExchange`): per receiver
  a table of the rows its edges read, values and frontier bits; its own
  span is written from its shard, so compact equals full bitwise without
  ``lux_tpu``'s per-edge local/remote select;
- **sparse**: each part compacts its frontier into a queue of local ids
  (K6, ``ops/frontier.py::frontier_queue``); the queues in part order
  are the all-gathered queue, as flat rows and global ids, and the flat
  pre-step stack holds their values. For each receiving part, ``start``
  and ``deg`` come from its push CSR (``build_push_csr``, keyed by
  global source) at the global ids and ``offs`` is their prefix, (P,
  cnt) and (P, cnt + 1) tensors; one K7 launch
  (``queue_relax_scatter``) copies the pre-step stack, reads it at the
  queued rows and combines into every part's row of the copy through
  its ``push_dst_local``. It reads the P receivers' edge totals on the
  card, so the host reads nothing more than the iteration's stats. It
  reads pre-step values only, so it gives ``lux_tpu``'s one scatter.

:class:`ShardedMultiSourcePushExecutor` is dense only over ``(P,
max_nv, K)`` lanes: the K-lane exchange, then per part one K10 launch
(``gas_pull_acc``) with K columns over the flat ``(P * max_nv, K)``
table, the merge, the pad mask and one shared count.

On the CPU the kernels' plain versions run. Not ported: ``trace_step``
(ROADMAP A16), the recorder and engobs (A14, A19), and the per-shard
activity list of ``phase_step``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from lux_tpu_torch.engine.push import (
    FixpointLoop,
    LanesLoop,
    PushExecutor,
    PushProgram,
    PushState,
    _make_tiers,
    _sparse_budgets,
    _tier_index,
)
from lux_tpu_torch.engine.sharded import ShardedBase
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.ops.frontier import frontier_queue, queue_relax_scatter
from lux_tpu_torch.ops.segment import (
    RowTasks,
    combine_u32,
    gas_kernel_code,
    gas_pull_acc,
    kernel_codes,
    pack_words,
    push_row_tasks,
    segment_minmax_relax,
    to_u32_storage,
    u32_to_numpy,
)
from lux_tpu_torch.parallel.mesh import LocalMesh
from lux_tpu_torch.parallel.shard import ShardedGraph
from lux_tpu_torch.utils.logging import get_logger


class SparseQueue:
    """The push-direction branch of a sharded executor, shared by
    :class:`ShardedPushExecutor` (K7) and the sharded GAS engine (K11):
    each part's frontier queue (K6) and every receiver's push-CSR ranges
    at the all-gathered queue. Needs ``sg``, ``device`` and ``_put``."""

    sg: ShardedGraph
    device: torch.device

    def _build_queue(self) -> None:
        """The push CSR (``build_push_csr``, keyed by global source) and
        the per-part out-degrees on the device."""
        prp, pdst, pw = self.sg.build_push_csr()
        self.push_row_ptr = self._put(prp.astype(np.int64))
        self.push_dst_local = self._put(pdst)
        self.push_weights = None if pw is None else self._put(pw)
        self.out_degrees = self._put(self.sg.out_degrees)
        # K6 also reads a row pointer into start/deg/offs, which the
        # branch does not use (each receiver expands the queue through
        # its own push CSR, keyed by global id): one zero row pointer
        # serves every part.
        self._queue_row_ptr = torch.zeros(self.sg.max_nv + 1,
                                          dtype=torch.int64,
                                          device=self.device)

    def _queue(self, frontier: torch.Tensor, counts):
        """Each part's frontier queue (K6, none for a part whose count is
        0), in part order: the all-gathered queue as (flat rows int32,
        global ids int64)."""
        n = self.sg.max_nv
        rows, ids = [], []
        for p, cnt in enumerate(counts):
            q = frontier_queue(frontier[p], self._queue_row_ptr, cnt)[0]
            rows.append(q + p * n)
            ids.append(q.long() + int(self.sg.row_left[p]))
        return torch.cat(rows), torch.cat(ids)

    def _ranges(self, ids: torch.Tensor):
        """Every receiver's push-CSR ranges at global ``ids``: (P, cnt)
        ``start`` and their exclusive prefix, (P, cnt + 1) ``offs``."""
        start = self.push_row_ptr[:, ids]
        deg = self.push_row_ptr[:, ids + 1] - start
        return start, torch.nn.functional.pad(deg.cumsum(1), (1, 0))


class _ShardedPush(ShardedBase):
    """The padded uint32 state of the two sharded push executors, whose
    exchanged row is a uint32 value and a frontier byte per lane."""

    def _padded(self, host: np.ndarray):
        """Global (nv, *t) host array -> (P, max_nv, *t) device storage:
        int32 words of uint32 values, or bool."""
        padded = self.sg.to_padded(np.asarray(host))
        if padded.dtype == bool:
            return self._put(padded)
        return to_u32_storage(padded, self.device)

    def gather_values(self, state: PushState) -> np.ndarray:
        """Padded device layout -> global (nv[, K]) host array, numpy
        uint32."""
        return self.sg.from_padded(u32_to_numpy(state.values))


class ShardedPushExecutor(_ShardedPush, SparseQueue, FixpointLoop):
    """Push executor over the ``num_parts`` parts of a :class:`LocalMesh`
    (``cuda`` unless ``device`` or ``mesh`` names another), with the
    single-device engine's two branches chosen per iteration from
    counters over all parts (see the module docstring). ``phase_step``'s
    load is the exchange in the dense branch (packing included) and the
    K6 launches with the queue all-gather in the sparse one.

    ``branch_log`` holds, per iteration of the last ``run()``, (branch,
    frontier count, frontier out-edges, per-part counts) before the
    step; ``queue_log``, per sparse iteration since the last ``run()``,
    (parts that compacted a queue, 1 if the queue has out-edges else 0):
    K6's and K7's launches on the card, from the counts the iteration
    already read."""

    BLOCKED_DENSE_MIN_NE = PushExecutor.BLOCKED_DENSE_MIN_NE

    def __init__(
        self,
        graph: Graph,
        program: PushProgram,
        mesh: Optional[LocalMesh] = None,
        num_parts: Optional[int] = None,
        sparse: bool = True,
        queue_frac: int = 16,       # per-part queue = max_nv/queue_frac + slack
        edge_budget_frac: int = 8,  # per-part edge budget = max_ne/frac
        blocked_dense: Optional[bool] = None,
        sg: Optional[ShardedGraph] = None,
        device=None,
    ):
        self._setup(graph, program, mesh, num_parts, sg, device)
        self._row_bytes = 5
        if self.device.type != "cpu":
            kernel_codes(program.combiner, program.relax_op)
        sg = self.sg
        flat_nv = self.num_parts * sg.max_nv
        packable = (program.value_dtype == np.uint32
                    and getattr(program, "packable_values", False))
        if blocked_dense is None:
            # The packed table has no needed-rows form, so the compact
            # exchange takes precedence when both are viable.
            blocked_dense = (
                self._xplan is None
                and graph.ne >= self.BLOCKED_DENSE_MIN_NE and packable
                and flat_nv < 2**31 and sg.max_ne < 2**31
            )
        elif blocked_dense:
            if self._xplan is not None:
                get_logger("engine").info(
                    "LUX_EXCHANGE=compact has no packed blocked form; "
                    "explicit blocked_dense=True keeps the full exchange")
                self.exchange_mode, self._xplan = "full", None
            if not packable:
                raise ValueError(
                    "blocked_dense needs a program declaring "
                    "packable_values (uint32 values < 2^31); "
                    f"{program.name} does not"
                )
            if flat_nv >= 2**31 or sg.max_ne >= 2**31:
                raise ValueError(
                    "blocked_dense needs P*max_nv and max_ne < 2^31 "
                    f"(got {flat_nv}, {sg.max_ne})"
                )
        self.blocked_dense = bool(blocked_dense)
        self._build_parts(push_row_tasks)
        self.sparse = sparse and graph.ne >= 1024
        self.tiers = []
        if self.sparse:
            self.queue_cap, self.edge_budget = _sparse_budgets(
                sg.max_nv, sg.max_ne, queue_frac, edge_budget_frac)
            self.tiers = _make_tiers(self.queue_cap, self.edge_budget)
            self._build_queue()
        self.sparse_iters = 0
        self.branch_log: List[tuple] = []
        self.queue_log: List[tuple] = []

    # -- the dense branch --------------------------------------------------

    def _dense_load(self, state: PushState):
        """The exchange: K5's input tables, (packed words, None) or
        (values, frontier)."""
        if self.blocked_dense:
            return self._exchange(pack_words(state.values,
                                             state.frontier)), None
        return self._exchange(state.values), self._exchange(state.frontier)

    def _dense_acc(self, loaded) -> torch.Tensor:
        """(P, max_nv) accumulators: one K5 launch per part."""
        prog = self.program
        table, front = loaded
        return torch.stack([
            segment_minmax_relax(
                part.row_ptr, part.col_src, self._table(table, q),
                self._table(front, q), prog.combiner, prog.relax_op,
                part.tasks, relax=prog.relax, weights=part.weights)
            for q, part in enumerate(self._parts)])

    # -- the sparse branch -------------------------------------------------

    def _sparse_load(self, state: PushState, stats):
        """Each part's frontier queue (K6), in part order: the
        all-gathered queue as (flat rows int32, global ids int64)."""
        return self._queue(state.frontier, stats[2])

    def _sparse_new(self, state: PushState, queue, stats) -> torch.Tensor:
        """(P, max_nv) new values: one K7 launch over the queue's
        out-edges in every part's push CSR, each part combining into its
        row of a copy of the values. ``stats[1]``, the frontier's
        out-edges over all parts, is the receivers' edge total."""
        prog = self.program
        rows, ids = queue
        start, offs = self._ranges(ids)
        new = queue_relax_scatter(
            rows, start, offs, self.push_dst_local, state.values,
            prog.combiner, prog.relax_op, stats[1], relax=prog.relax,
            weights=self.push_weights)
        self.queue_log.append((sum(1 for c in stats[2] if c),
                               int(rows.numel() > 0 and stats[1] > 0)))
        return new

    # -- update and the host read ----------------------------------------

    def _stats_tensor(self, frontier: torch.Tensor) -> torch.Tensor:
        """Per part, the frontier's (count, out-edge total) as one (P, 2)
        int64 tensor ((P, 1) counts when the sparse branch is off)."""
        cnt = frontier.sum(1)
        if not self.sparse:
            return cnt[:, None]
        out = torch.where(frontier, self.out_degrees, 0).sum(1)
        return torch.stack([cnt, out], 1)

    @staticmethod
    def _read(stats: torch.Tensor):
        """The one device-to-host read of an iteration: (count, out-edge
        total, per-part counts)."""
        rows = stats.tolist()
        counts = tuple(r[0] for r in rows)
        out_edges = sum(r[1] for r in rows) if len(rows[0]) > 1 else 0
        return sum(counts), out_edges, counts

    def _branch(self, stats) -> int:
        """``lux_tpu``'s choice from the largest part's count and the
        out-edges of all parts."""
        if not self.sparse:
            return 0
        return _tier_index(max(stats[2]), stats[1], self.tiers)

    def _update(self, values: torch.Tensor, new: torch.Tensor):
        new = torch.where(self.vertex_mask, new, values)  # freeze pads
        frontier = new != values
        return PushState(new, frontier), self._stats_tensor(frontier)

    # -- public API --------------------------------------------------------

    def init_state(self, **kw) -> PushState:
        """The program's initial state, padded to (P, max_nv)."""
        prog = self.program
        return PushState(
            self._padded(prog.init_values(self.graph, **kw)),
            self._padded(np.asarray(prog.init_frontier(self.graph, **kw),
                                    dtype=bool)))

    def run(self, max_iters: Optional[int] = None,
            state: Optional[PushState] = None, chunk: int = 16, **init_kw):
        self.queue_log = []
        return super().run(max_iters, state, chunk, **init_kw)


class ShardedMultiSourcePushExecutor(_ShardedPush, LanesLoop):
    """Dense multi-source push over the parts of a :class:`LocalMesh`:
    ``(P, max_nv, K)`` lanes, one K10 launch with K columns per part and
    iteration, one shared halt count (``cuda`` unless ``device`` or
    ``mesh`` names another). Column j of :meth:`gather_values` equals a
    single-source run from root j. ``phase_step``'s load is the K-lane
    exchange."""

    def __init__(
        self,
        graph: Graph,
        program: PushProgram,
        k: int,
        mesh: Optional[LocalMesh] = None,
        num_parts: Optional[int] = None,
        sg: Optional[ShardedGraph] = None,
        device=None,
    ):
        if k < 1:
            raise ValueError(f"batch width k must be >= 1 (got {k})")
        self.k = int(k)
        self._setup(graph, program, mesh, num_parts, sg, device)
        self._row_bytes = 5 * self.k
        if self.device.type != "cpu":
            gas_kernel_code(program.combiner, program.relax_op)
        self._build_parts(RowTasks.build)
        self.sparse_iters = 0   # API parity with the sharded push engine

    def _lanes_storage(self, vals: np.ndarray, fr: np.ndarray) -> PushState:
        return PushState(self._padded(vals), self._padded(fr))

    def _load(self, state: PushState):
        """The K-lane exchange: (values, frontier) tables."""
        return self._exchange(state.values), self._exchange(state.frontier)

    def _acc(self, loaded) -> torch.Tensor:
        """(P, max_nv, K) accumulators: one K10 launch per part."""
        prog = self.program
        table, front = loaded
        return torch.stack([
            gas_pull_acc(part.row_ptr, part.col_src, self._table(table, q),
                         self._table(front, q), prog.combiner,
                         prog.relax_op, part.tasks, gather=prog.relax,
                         weights=part.weights)
            for q, part in enumerate(self._parts)])

    def _update(self, values: torch.Tensor, acc: torch.Tensor):
        new = combine_u32(self.program.combiner, values, acc)
        new = torch.where(self.vertex_mask[:, :, None], new, values)
        frontier = new != values
        return PushState(new, frontier), frontier.sum()

    def values_for(self, state: PushState, j: int) -> np.ndarray:
        """Host copy of lane ``j``'s global value column, numpy uint32."""
        return self.sg.from_padded(u32_to_numpy(state.values[:, :, j]))
