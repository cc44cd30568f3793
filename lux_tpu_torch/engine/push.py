"""Push-model engine: frontier-driven fixpoint iteration, on the GPU.

The counterpart of the single-device ``PushExecutor`` of
``lux_tpu/engine/push.py``. Each iteration relaxes the out-edges of the
active frontier and keeps the vertices whose value changed:

    cand_e = relax(val[src_e])     if frontier[src_e] else identity
    acc_v  = min/max over the in-edges of v
    new_v  = combine(old_v, acc_v)
    frontier'_v = (new_v != old_v)

through one of two branches, chosen per iteration from the frontier's
size and out-edge total exactly as ``lux_tpu`` chooses them
(:func:`_tier_index`):

- **dense** (pull direction): kernel K5 (``ops/segment.py::
  segment_minmax_relax``) over every CSC in-edge, reading each source
  either from the packed ``value | frontier << 31`` table
  (``blocked_dense``) or from the values and the bool frontier;
- **sparse** (push direction): K6 (``ops/frontier.py::frontier_queue``)
  compacts the frontier into a queue, K7 (``queue_relax_scatter``)
  expands the queued out-edges and combines into a copy of the values.

Both branches read only pre-step values, so they give the same state;
the choice changes the work, not the result.

Halting: ``lux_tpu`` runs up to ``chunk`` iterations under one
``lax.while_loop`` and reads one batch of counts per chunk. Here the
update produces the new frontier's count and out-edge total as one small
tensor that the host reads once per iteration; that read is both the
next branch choice and the halt check. ``iterations`` and
``sparse_iters`` equal ``lux_tpu``'s for every ``max_iters`` and
``chunk``.

Values are int32 storage of uint32 bit patterns (see
:mod:`lux_tpu_torch.ops.segment`); :meth:`PushExecutor.values` returns
numpy uint32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.ops.frontier import frontier_queue, queue_relax_scatter
from lux_tpu_torch.ops.segment import (
    SEG_ITEM,
    SegmentItems,
    combine_u32,
    pack_words,
    segment_minmax_relax,
    to_u32_storage,
    u32_to_numpy,
)
from lux_tpu_torch.utils.platform import resolve_device
from lux_tpu_torch.utils.timing import timed


class PushProgram:
    """Frontier-driven vertex program (SSSP, CC, ...).

    ``relax`` and ``edge_invariant`` see values widened to int64 in
    ``[0, 2**32)`` and return the same. ``relax_op`` names the relax for
    the CUDA kernels (``"add1"``: ``v + 1`` wrapping at 2**32;
    ``"copy"``: ``v``); a program without one runs its plain ``relax``
    on the CPU and raises ``NotImplementedError`` on the card."""

    name: str = "push"
    combiner: str = "min"          # 'min' | 'max'
    value_dtype = np.uint32
    needs_weights: bool = False
    rooted: bool = False           # takes a per-query `start` root
    frontier_ok: bool = True
    incremental_ok: bool = False
    # True iff every value the program can hold fits in 31 bits; the
    # packed dense table carries the frontier in bit 31.
    packable_values: bool = False
    relax_op: Optional[str] = None

    def init_values(self, graph: Graph, **kw) -> np.ndarray:
        raise NotImplementedError

    def init_frontier(self, graph: Graph, **kw) -> np.ndarray:
        raise NotImplementedError

    def relax(self, src_vals: torch.Tensor, weights) -> torch.Tensor:
        """Candidate value pushed along an edge from an active source."""
        raise NotImplementedError

    def edge_invariant(self, src_vals, dst_vals, weights) -> torch.Tensor:
        """Per-edge fixpoint invariant for ``check`` (True = ok)."""
        raise NotImplementedError


class PushState(NamedTuple):
    values: torch.Tensor     # (nv,) int32 storage of uint32 values
    frontier: torch.Tensor   # (nv,) bool


def _sparse_budgets(nv: int, ne: int, queue_frac: int, edge_budget_frac: int):
    """(queue capacity, edge budget) for the bounded sparse frontier.
    Mirrors the reference's per-part sparse queue sizing
    (nv/SPARSE_THRESHOLD + slack, push_model.inl:390-412)."""
    return nv // queue_frac + 128, max(ne // edge_budget_frac, 1024)


def _make_tiers(queue_cap: int, edge_budget: int):
    """Ascending (queue, edge budget) size tiers derived from the full
    budgets; per iteration the smallest adequate tier serves."""
    tiers = []
    for div in (64, 8, 1):
        t = (max(queue_cap // div, 256), max(edge_budget // div, 1024))
        if t not in tiers:
            tiers.append(t)
    return tiers


def _tier_index(cnt: int, out_edges: int, tiers) -> int:
    """Branch index: 0 = dense, i >= 1 = tiers[i-1], the smallest tier
    whose queue holds ``cnt`` vertices and whose budget holds
    ``out_edges`` edges (adequacy is monotone in tier size, so the
    count of adequate tiers identifies it)."""
    nadeq = sum(1 for (q, e) in tiers if cnt <= q and out_edges <= e)
    return 0 if nadeq == 0 else len(tiers) - nadeq + 1


def _tier_label(tiers, tier):
    return f"sparse/{tiers[tier - 1][1]}" if tier > 0 else "dense"


class PushExecutor:
    """Single-device push executor with per-iteration branch choice
    (``cuda`` unless ``device`` names another).

    The dense branch serves large frontiers, the sparse branch small
    ones: sparse is taken when the frontier fits the queue AND its
    out-edge total fits the edge budget of a tier (the reference's
    sparse-to-dense overflow fallback, sssp_gpu.cu:462-491).
    """

    # Edge count below which lux_tpu's blocked dense path is off by
    # default; kept so both packages pick the same input form.
    BLOCKED_DENSE_MIN_NE = 1 << 16

    def __init__(
        self,
        graph: Graph,
        program: PushProgram,
        device=None,
        sparse: bool = True,
        queue_frac: int = 16,       # queue capacity = nv/queue_frac + slack
        edge_budget_frac: int = 8,  # edge budget = ne/edge_budget_frac
        blocked_dense: Optional[bool] = None,
    ):
        if program.needs_weights and graph.weights is None:
            raise ValueError(f"{program.name} requires an edge-weighted graph")
        self.graph = graph
        self.program = program
        self.device = resolve_device(device)
        packable = (program.value_dtype == np.uint32
                    and getattr(program, "packable_values", False))
        if blocked_dense is None:
            blocked_dense = (
                graph.ne >= self.BLOCKED_DENSE_MIN_NE and packable
                and graph.nv < 2**31 and graph.ne < 2**31
            )
        elif blocked_dense:
            # The packed table carries the frontier in the value's top bit.
            if not packable:
                raise ValueError(
                    "blocked_dense needs a program declaring "
                    "packable_values (uint32 values < 2^31); "
                    f"{program.name} does not"
                )
            if graph.nv >= 2**31 or graph.ne >= 2**31:
                raise ValueError(
                    "blocked_dense needs nv and ne < 2^31 "
                    f"(got nv={graph.nv}, ne={graph.ne})"
                )
        self.blocked_dense = bool(blocked_dense)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.row_ptr = put(graph.row_ptr.astype(np.int64))
        self.col_src = put(graph.col_src.astype(np.int32))
        self.weights = None if graph.weights is None else put(graph.weights)
        self.items = SegmentItems.build(graph.row_ptr, SEG_ITEM, self.device)
        self.sparse = sparse and graph.ne >= 1024
        self.tiers: List[Tuple[int, int]] = []
        if self.sparse:
            self.queue_cap, self.edge_budget = _sparse_budgets(
                graph.nv, graph.ne, queue_frac, edge_budget_frac
            )
            self.tiers = _make_tiers(self.queue_cap, self.edge_budget)
            csr = graph.csr()
            self.csr_row_ptr = put(csr.row_ptr.astype(np.int64))
            self.csr_col_dst = put(csr.col_dst.astype(np.int32))
            self.csr_weights = (None if csr.weights is None
                                else put(csr.weights))
            self.out_degrees = put(graph.out_degrees.astype(np.int32))
        self.sparse_iters = 0   # sparse-branch count of the last run()
        # Per iteration of the last run(): (branch, frontier count,
        # frontier out-edges) before the step; branch 0 is dense.
        self.branch_log: List[Tuple[int, int, int]] = []

    # -- the two branches ------------------------------------------------

    def _dense_input(self, state: PushState):
        """K5's input: the packed table, or the values and frontier."""
        if self.blocked_dense:
            return pack_words(state.values, state.frontier), None
        return state.values, state.frontier

    def _dense_acc(self, table, front) -> torch.Tensor:
        prog = self.program
        return segment_minmax_relax(
            self.row_ptr, self.col_src, table, front, prog.combiner,
            prog.relax_op, self.items, relax=prog.relax, weights=self.weights,
        )

    def _queue(self, state: PushState, cnt: int):
        return frontier_queue(state.frontier, self.csr_row_ptr, cnt)

    def _scatter(self, state: PushState, queue, out_edges: int):
        prog = self.program
        q, start, _, offs = queue
        return queue_relax_scatter(
            q, start, offs, self.csr_col_dst, state.values, prog.combiner,
            prog.relax_op, out_edges, relax=prog.relax,
            weights=self.csr_weights,
        )

    def _new_values(self, state: PushState, tier: int, stats):
        if tier > 0:
            return self._scatter(state, self._queue(state, stats[0]),
                                 stats[1])
        acc = self._dense_acc(*self._dense_input(state))
        return combine_u32(self.program.combiner, state.values, acc)

    # -- update and the host read ----------------------------------------

    def _stats_tensor(self, frontier: torch.Tensor) -> torch.Tensor:
        """The frontier's (count, out-edge total) as one int64 tensor
        (count only when the sparse branch is off)."""
        cnt = frontier.sum()
        if not self.sparse:
            return cnt.reshape(1)
        out = torch.where(frontier, self.out_degrees, 0).sum()
        return torch.stack([cnt, out])

    def _update(self, old: torch.Tensor, new: torch.Tensor):
        frontier = new != old
        return PushState(new, frontier), self._stats_tensor(frontier)

    @staticmethod
    def _read(stats: torch.Tensor) -> Tuple[int, int]:
        """The one device-to-host read of an iteration."""
        got = stats.tolist()
        return got[0], got[1] if len(got) > 1 else 0

    def _frontier_stats(self, state: PushState) -> Tuple[int, int]:
        return self._read(self._stats_tensor(state.frontier))

    def _branch(self, stats) -> int:
        return _tier_index(*stats, self.tiers) if self.sparse else 0

    def _iterate(self, state: PushState, stats):
        """One iteration from ``state``, whose frontier has ``stats``;
        returns (new state, its stats, branch index)."""
        tier = self._branch(stats)
        new_state, st = self._update(state.values,
                                     self._new_values(state, tier, stats))
        return new_state, self._read(st), tier

    # -- public API --------------------------------------------------------

    def init_state(self, **kw) -> PushState:
        prog = self.program
        vals = to_u32_storage(prog.init_values(self.graph, **kw), self.device)
        fr = np.asarray(prog.init_frontier(self.graph, **kw), dtype=bool)
        return PushState(vals, torch.from_numpy(fr.copy()).to(self.device))

    def values(self, state: PushState) -> np.ndarray:
        """Host copy of the values, numpy uint32."""
        return u32_to_numpy(state.values)

    def step(self, state: PushState):
        """One iteration; returns (new state, new frontier count)."""
        new_state, stats, _ = self._iterate(state,
                                            self._frontier_stats(state))
        return new_state, stats[0]

    def _run(self, state: PushState, max_iters: Optional[int], chunk: int):
        """Iterate until a step leaves an empty frontier or ``max_iters``
        steps ran; returns (state, iterations, branch log). ``chunk``
        keeps ``lux_tpu``'s signature: there it batches host reads, and
        the iterations do not depend on it, except that a non-positive
        chunk runs none."""
        log: List[Tuple[int, int, int]] = []
        if chunk <= 0:
            return state, 0, log
        stats = self._frontier_stats(state)
        while max_iters is None or len(log) < max_iters:
            prev = stats
            state, stats, tier = self._iterate(state, stats)
            log.append((tier,) + prev)
            if stats[0] == 0:
                break
        return state, len(log), log

    def run(self, max_iters: Optional[int] = None,
            state: Optional[PushState] = None, chunk: int = 16, **init_kw):
        """Iterate to fixpoint; returns (final_state, iterations_run). The
        number of iterations the sparse branch served is left in
        ``self.sparse_iters``."""
        if state is None:
            state = self.init_state(**init_kw)
        state, total, self.branch_log = self._run(state, max_iters, chunk)
        self.sparse_iters = sum(1 for b, _, _ in self.branch_log if b > 0)
        return state, total

    def warmup(self, chunk: int = 16, **init_kw):
        """One throwaway iteration through the exact run() path (builds
        the kernels) so timed runs exclude set-up."""
        self._run(self.init_state(**init_kw), 1, chunk)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup_phases(self, state: PushState):
        """Run every phase of both branches once outside any timed
        region. ``state`` is only read."""
        stats = self._frontier_stats(state)
        self._update(state.values, self._new_values(state, 0, stats))
        if self.sparse:
            self._update(state.values, self._new_values(state, 1, stats))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def phase_step(self, state: PushState):
        """One iteration as separately timed phases (CUDA events on the
        card): the reference's `-verbose` breakdown
        (sssp/sssp_gpu.cu:516-518). Dense: load = the packed-table
        build (nothing without ``blocked_dense``), comp = K5, update =
        merge, new frontier and its counts. Sparse: load = K6, comp = K7
        (relax and scatter), update = new frontier and its counts.
        Returns (new state, active count, times)."""
        dev = self.device
        stats = self._frontier_stats(state)
        tier = self._branch(stats)
        times = {}
        if tier > 0:
            queue, times["loadTime"] = timed(
                lambda: self._queue(state, stats[0]), dev)
            new, times["compTime"] = timed(
                lambda: self._scatter(state, queue, stats[1]), dev)

            def finish():
                return self._update(state.values, new)
        else:
            table, times["loadTime"] = timed(
                lambda: self._dense_input(state), dev)
            acc, times["compTime"] = timed(
                lambda: self._dense_acc(*table), dev)

            def finish():
                return self._update(state.values, combine_u32(
                    self.program.combiner, state.values, acc))
        (new_state, st), times["updateTime"] = timed(finish, dev)
        times["branch"] = _tier_label(self.tiers, tier)
        return new_state, self._read(st)[0], times
