"""Sharded push executors: the P parts of an edge-balanced partition, on
one device or over the ranks of a process group.

The counterparts of ``ShardedPushExecutor`` and
``ShardedMultiSourcePushExecutor`` in ``lux_tpu/engine/push.py``, which
run one part per device of a ``shard_map`` mesh. Here the parts a
process holds are the leading axis of stacked ``(L, max_nv)`` values and
frontier: all P on one device
(:class:`~lux_tpu_torch.parallel.mesh.LocalMesh`) or a rank's P / W
(:class:`~lux_tpu_torch.parallel.mesh.DistMesh`). Each kernel is
launched once per held part, as ``lux_tpu`` runs one device per part,
except the sparse branch's K7: one launch for every held part.

:class:`ShardedPushExecutor` chooses a branch per iteration exactly as
``lux_tpu`` does: from the largest part's frontier count (``pmax``
there) and the frontier's out-edge total over all parts (``psum``).
The update leaves both as one small ``(L, 1 + S)`` tensor, each held
part's count and its frontier's out-edges into the parts of each of the
S processes that hold parts (S = 1 on one device), that the host reads
once per iteration, gathered over ranks into the same ``(P, 1 + S)``
rows on every rank; the read is also the halt check, and its column of
this process gives K7 its receivers' edge total.

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
- **sparse**: each held part compacts its frontier into a queue of
  local ids (K6, ``ops/frontier.py::frontier_queue``); the queues in
  part order are the all-gathered queue, as flat rows and global ids.
  On one device the flat pre-step stack holds their values; across
  ranks each rank's queues and their values travel in one all-gather,
  padded to the largest count (which every rank read) and trimmed, and
  the values ride in a few extra columns of the held parts' rows, where
  the flat rows point (:meth:`SparseQueue._queue`). For each held
  receiving part, ``start`` and ``deg`` come from its push CSR
  (``build_push_csr``, keyed by global source) at the global ids and
  ``offs`` is their prefix, (L, cnt) and (L, cnt + 1) tensors; one K7
  launch (``queue_relax_scatter``) copies the pre-step stack, reads it
  at the queued rows and combines into every held part's row of the
  copy through its ``push_dst_local``. It reads the receivers' edge
  totals on the card, so the host reads nothing more than the
  iteration's stats. It reads pre-step values only, so it gives
  ``lux_tpu``'s one scatter.

:class:`ShardedMultiSourcePushExecutor` is dense only over ``(L,
max_nv, K)`` lanes: the K-lane exchange, then per held part one K10
launch (``gas_pull_acc``) with K columns over the flat ``(P * max_nv,
K)`` table, the merge, the pad mask and one count over all parts.

On the CPU the kernels' plain versions run. Telemetry is ``lux_tpu``'s:
``run`` takes a recorder (one flush per ``chunk``, the exchange ledger,
useful bytes, the byte model), runs phase-fenced under ``LUX_ENGOBS=1``
(``obs/engobs.py``), and a step's exchange and compute are the ``prof``
regions ``lux.push_sharded.*`` (``lux.push_multi_sharded.*``).
``trace_step`` gives the trace tiers (``analysis/ir.py``) one iteration
with both branches. Not ported: the per-shard activity list of
``phase_step``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

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
from lux_tpu_torch.engine.telemetry import note_exchange
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.obs import prof
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
from lux_tpu_torch.parallel.mesh import AnyMesh, gather_rows
from lux_tpu_torch.parallel.shard import ShardedGraph
from lux_tpu_torch.utils.logging import get_logger


class SparseQueue:
    """The push-direction branch of a sharded executor, shared by
    :class:`ShardedPushExecutor` (K7) and the sharded GAS engine (K11):
    each held part's frontier queue (K6), the all-gathered queue and the
    table its values are read from, and every held receiver's push-CSR
    ranges at it. Needs ``sg``, ``parts``, ``mesh``, ``device``,
    ``_put`` and ``_put_own``."""

    sg: ShardedGraph
    device: torch.device

    def _build_queue(self) -> None:
        """The held receivers' push CSR (``build_push_csr``, keyed by
        global source), the held parts' out-degrees and, per vertex of a
        held part, its out-edges into the parts each process holds
        (``_send_degrees``, (L, max_nv, S)) on the device."""
        prp, pdst, pw = self.sg.build_push_csr()
        self.push_row_ptr = self._put_own(prp.astype(np.int64))
        self.push_dst_local = self._put_own(pdst)
        self.push_weights = None if pw is None else self._put_own(pw)
        self.out_degrees = self._put_own(self.sg.out_degrees)
        held, P = len(self.parts), self.sg.num_parts
        self._slot = self.parts.start // held
        if held == P:
            self._send_degrees = self.out_degrees[:, :, None]
        else:
            nv = self.sg.graph.nv
            deg = np.diff(prp[:, :nv + 1].astype(np.int64), axis=1)
            per = deg.reshape(P // held, held, nv).sum(1).T
            self._send_degrees = self._put_own(
                self.sg.to_padded(np.ascontiguousarray(per)))
        # K6 also reads a row pointer into start/deg/offs, which the
        # branch does not use (each receiver expands the queue through
        # its own push CSR, keyed by global id): one zero row pointer
        # serves every part.
        self._queue_row_ptr = torch.zeros(self.sg.max_nv + 1,
                                          dtype=torch.int64,
                                          device=self.device)

    def _send_edges(self, frontier: torch.Tensor) -> torch.Tensor:
        """(L, S) int64: each held part's frontier's out-edges into the
        parts of each process that holds parts."""
        return torch.where(frontier[:, :, None], self._send_degrees,
                           0).sum(1)

    def _queue(self, frontier: torch.Tensor, values: torch.Tensor,
               counts):
        """The frontier queue of every part, in part order, from K6 on
        each held part whose count is not 0: (flat rows int32, global ids
        int64) and, across ranks, the table K7 or K11 reads the rows'
        values from (see :meth:`_table_of`).

        With every part held, the rows index the (P, max_nv) values
        themselves. Across ranks, each rank's queues and their values
        go to every rank in one all-gather of (id, value bits) pairs,
        padded to the largest of ``counts`` (every rank read them) and
        trimmed; the table is then the held values with ``pad`` more
        columns, (L, max_nv + pad), whose tail holds the queue's values
        in queue order, and the rows point there. Columns past max_nv are
        no vertex's, so the kernels write nothing of them a caller
        keeps."""
        n, P = self.sg.max_nv, self.sg.num_parts
        held = [frontier_queue(frontier[j], self._queue_row_ptr,
                               counts[p])[0]
                for j, p in enumerate(self.parts)]
        if len(held) == P:
            rows = [q + p * n for p, q in enumerate(held)]
            ids = [q.long() + int(self.sg.row_left[p])
                   for p, q in enumerate(held)]
            return torch.cat(rows), torch.cat(ids)
        width, L = max(counts), len(held)
        send = torch.zeros((L, width, 2), dtype=torch.int32,
                           device=values.device)
        for j, q in enumerate(held):
            send[j, :q.shape[0], 0] = q
            send[j, :q.shape[0], 1] = values[j].index_select(
                0, q.long()).view(torch.int32)
        got = self.mesh.all_gather(send).view(P, width, 2)
        ids = torch.cat([got[p, :c, 0].long() + int(self.sg.row_left[p])
                         for p, c in enumerate(counts)])
        vals = torch.cat([got[p, :c, 1] for p, c in enumerate(counts)])
        cnt = vals.shape[0]
        pad = -(-cnt // L)
        tail = vals.new_zeros(L * pad)
        tail[:cnt] = vals
        table = torch.cat([values, tail.view(values.dtype).view(L, pad)], 1)
        k = torch.arange(cnt, dtype=torch.int64, device=values.device)
        rows = (k // pad * (n + pad) + n + k % pad).to(torch.int32)
        return rows, ids, table

    @staticmethod
    def _table_of(queue, values: torch.Tensor) -> torch.Tensor:
        """The values table a :meth:`_queue`'s rows index: its third
        entry across ranks, else the held values."""
        return queue[2] if len(queue) > 2 else values

    def _ranges(self, ids: torch.Tensor):
        """Every held receiver's push-CSR ranges at global ``ids``: (L,
        cnt) ``start`` and their exclusive prefix, (L, cnt + 1)
        ``offs``."""
        start = self.push_row_ptr[:, ids]
        deg = self.push_row_ptr[:, ids + 1] - start
        return start, torch.nn.functional.pad(deg.cumsum(1), (1, 0))


_PUSH_REGIONS = (prof.region("lux.push_sharded.exchange"),
                 prof.region("lux.push_sharded.compute"))
_LANES_REGIONS = (prof.region("lux.push_multi_sharded.exchange"),
                  prof.region("lux.push_multi_sharded.compute"))


class PushStats(NamedTuple):
    """One host read of a sharded push frontier's counters."""

    count: int                 # active vertices over all parts
    out_edges: int             # their out-edges over all parts
    counts: Tuple[int, ...]    # active vertices per part
    recv_edges: int            # their out-edges into the held parts


class _ShardedPush(ShardedBase):
    """The padded uint32 state of the two sharded push executors, whose
    exchanged row is a uint32 value and a frontier byte per lane."""

    def _padded(self, host: np.ndarray):
        """Global (nv, *t) host array -> (L, max_nv, *t) device storage
        of the held parts: int32 words of uint32 values, or bool."""
        padded = self._own(self.sg.to_padded(np.asarray(host)))
        if padded.dtype == bool:
            return self._put(padded)
        return to_u32_storage(padded, self.device)

    def gather_values(self, state: PushState) -> np.ndarray:
        """Padded device layout -> global (nv[, K]) host array, numpy
        uint32, on every rank (a collective over ranks)."""
        return self.sg.from_padded(u32_to_numpy(self._gathered(
            state.values)))


class ShardedPushExecutor(_ShardedPush, SparseQueue, FixpointLoop):
    """Push executor over the ``num_parts`` parts of a
    :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` or a
    :class:`~lux_tpu_torch.parallel.mesh.DistMesh` (``cuda`` unless
    ``device`` or ``mesh`` names another), with the
    single-device engine's two branches chosen per iteration from
    counters over all parts (see the module docstring). ``phase_step``'s
    load is the exchange in the dense branch (packing included) and the
    K6 launches with the queue all-gather in the sparse one.

    ``branch_log`` holds, per iteration of the last ``run()``, (branch,
    frontier count, frontier out-edges, per-part counts) before the
    step; ``queue_log``, per sparse iteration since the last ``run()``,
    (held parts that compacted a queue, 1 if the queue has out-edges
    into the held parts else 0): K6's and K7's launches on the card,
    from the counts the iteration already read."""

    BLOCKED_DENSE_MIN_NE = PushExecutor.BLOCKED_DENSE_MIN_NE
    _regions = _PUSH_REGIONS
    _engine = "push_sharded"
    _phase_fenced = True

    def __init__(
        self,
        graph: Graph,
        program: PushProgram,
        mesh: Optional[AnyMesh] = None,
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
        """(L, max_nv) accumulators: one K5 launch per held part."""
        prog = self.program
        table, front = loaded
        return torch.stack([
            segment_minmax_relax(
                part.row_ptr, part.col_src, self._table(table, q),
                self._table(front, q), prog.combiner, prog.relax_op,
                part.tasks, relax=prog.relax, weights=part.weights)
            for q, part in enumerate(self._parts)])

    # -- the sparse branch -------------------------------------------------

    def _sparse_load(self, state: PushState, stats: PushStats):
        """Each held part's frontier queue (K6), all-gathered in part
        order: (flat rows int32, global ids int64[, values table])."""
        return self._queue(state.frontier, state.values, stats.counts)

    def _sparse_new(self, state: PushState, queue,
                    stats: PushStats) -> torch.Tensor:
        """(L, max_nv) new values: one K7 launch over the queue's
        out-edges in every held part's push CSR, each part combining into
        its row of a copy of the values. ``stats.recv_edges``, the
        frontier's out-edges into the held parts, is the receivers' edge
        total."""
        prog = self.program
        rows, ids = queue[:2]
        start, offs = self._ranges(ids)
        new = queue_relax_scatter(
            rows, start, offs, self.push_dst_local,
            self._table_of(queue, state.values),
            prog.combiner, prog.relax_op, stats.recv_edges,
            relax=prog.relax, weights=self.push_weights)
        self.queue_log.append((
            sum(1 for p in self.parts if stats.counts[p]),
            int(rows.numel() > 0 and stats.recv_edges > 0)))
        return new[:, :self.sg.max_nv]

    # -- update and the host read ----------------------------------------

    def _stats_tensor(self, frontier: torch.Tensor) -> torch.Tensor:
        """Per held part, the frontier's count and its out-edges into the
        parts of each process that holds parts, as one (L, 1 + S) int64
        tensor ((L, 1) counts when the sparse branch is off)."""
        cnt = frontier.sum(1)[:, None]
        if not self.sparse:
            return cnt
        return torch.cat([cnt, self._send_edges(frontier)], 1)

    def _read(self, stats: torch.Tensor) -> PushStats:
        """The one device-to-host read of an iteration, the same on every
        rank: the count, the out-edges over all parts, the per-part
        counts and the out-edges into the held parts."""
        rows = self._gather_stats(stats)
        counts = tuple(r[0] for r in rows)
        if len(rows[0]) == 1:
            return PushStats(sum(counts), 0, counts, 0)
        return PushStats(sum(counts), sum(sum(r[1:]) for r in rows), counts,
                         sum(r[1 + self._slot] for r in rows))

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
        """The program's initial state, padded to (L, max_nv)."""
        prog = self.program
        return PushState(
            self._padded(prog.init_values(self.graph, **kw)),
            self._padded(np.asarray(prog.init_frontier(self.graph, **kw),
                                    dtype=bool)))

    def run(self, max_iters: Optional[int] = None,
            state: Optional[PushState] = None, chunk: int = 16,
            recorder=None, **init_kw):
        self.queue_log = []
        return super().run(max_iters, state, chunk, recorder, **init_kw)

    def trace_step(self, **init_kw) -> dict:
        """Trace-tier hook (``analysis/ir.py``): both branches of one
        iteration from the program's initial state
        (:meth:`FixpointLoop._device_step` over every branch), with the
        exchange keys LUX404-406 read. ``lux_tpu`` donates the state;
        this step writes new tensors, so it donates nothing (ROADMAP:
        memck's LUX702)."""
        return self._trace_spec("push_sharded",
                                lambda: self.init_state(**init_kw),
                                **self._exchange_spec())

    def _note_exchange(self, rec) -> None:
        note_exchange(rec, self, "dense_estimate", 5)


class ShardedMultiSourcePushExecutor(_ShardedPush, LanesLoop):
    """Dense multi-source push over the parts of a
    :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` or a
    :class:`~lux_tpu_torch.parallel.mesh.DistMesh`: ``(L, max_nv, K)``
    lanes of the held parts, one K10 launch with K columns per held part
    and iteration, one shared halt count over all parts (``cuda`` unless
    ``device`` or ``mesh`` names another). Column j of
    :meth:`gather_values` equals a single-source run from root j.
    ``phase_step``'s load is the K-lane exchange."""

    _regions = _LANES_REGIONS
    _engine = "push_multi_sharded"
    _phase_fenced = True

    def __init__(
        self,
        graph: Graph,
        program: PushProgram,
        k: int,
        mesh: Optional[AnyMesh] = None,
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

    def _note_exchange(self, rec) -> None:
        note_exchange(rec, self, "dense_estimate", 5 * self.k)

    def _load(self, state: PushState):
        """The K-lane exchange: (values, frontier) tables."""
        return self._exchange(state.values), self._exchange(state.frontier)

    def _acc(self, loaded) -> torch.Tensor:
        """(L, max_nv, K) accumulators: one K10 launch per held part."""
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
        return PushState(new, frontier), gather_rows(
            self.mesh, frontier.sum((1, 2))[:, None]).sum()

    def trace_step(self, start: int = 0, **init_kw) -> dict:
        """Trace-tier hook (``analysis/ir.py``): one K-lane iteration
        from root ``start`` (:meth:`LanesLoop._trace_spec`), with the
        exchange keys LUX404-406 read."""
        return self._trace_spec("push_multi_sharded", start,
                                **self._exchange_spec())

    def values_for(self, state: PushState, j: int) -> np.ndarray:
        """Host copy of lane ``j``'s global value column, numpy uint32,
        on every rank (a collective over ranks)."""
        return self.sg.from_padded(u32_to_numpy(self._gathered(
            state.values[:, :, j])))
