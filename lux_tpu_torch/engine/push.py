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
  segment_minmax_relax``) over every CSC in-edge, each row written once
  over the graph's :class:`~lux_tpu_torch.ops.segment.RowTasks` (K5's
  thresholds, built on the card only), reading each source either from
  the packed ``value | frontier << 31`` table (``blocked_dense``) or
  from the values and the bool frontier;
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

:class:`MultiSourcePushExecutor` runs K roots at once over ``(nv, K)``
values, dense only: one K10 launch (``ops/segment.py::gas_pull_acc``)
with K columns per iteration, then the same merge; a program's
``relax_op`` names K10's gather op, as ``engine/gas.py::PushGasAdapter``
maps it.

Values are int32 storage of uint32 bit patterns (see
:mod:`lux_tpu_torch.ops.segment`); :meth:`PushExecutor.values` returns
numpy uint32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lux_tpu_torch.engine.telemetry import (
    NO_REGION,
    NULL_RECORDER,
    FlushWindow,
    open_run,
    sync,
    timed_warmup,
)
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.obs import engobs
from lux_tpu_torch.ops.frontier import frontier_queue, queue_relax_scatter
from lux_tpu_torch.ops.segment import (
    RowTasks,
    combine_u32,
    gas_kernel_code,
    gas_pull_acc,
    pack_words,
    push_row_tasks,
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


class FixpointLoop:
    """The iteration and fixpoint loop of the push executors, over their
    hooks: ``init_state``; ``_stats_tensor`` and ``_read`` (the one host
    read of a frontier's counters, a tuple whose first entry is the
    frontier's size and second its out-edge total); ``_branch`` (0
    dense, i >= 1 sparse tier i); the dense ``_dense_load`` (K5's
    input) and ``_dense_acc``; the sparse ``_sparse_load`` (the queue)
    and ``_sparse_new`` (the new values); and ``_update``.

    A sharded executor names its step's exchange and compute ``prof``
    regions in ``_regions`` and runs phase-fenced under ``LUX_ENGOBS=1``
    (``_phase_fenced``); a run's recorder label is ``_engine``."""

    device: torch.device
    program: PushProgram
    sparse: bool
    tiers: List[Tuple[int, int]]
    _regions = (NO_REGION, NO_REGION)
    _engine = "push"
    _phase_fenced = False    # LUX_ENGOBS=1 runs phase-fenced (sharded)

    def _frontier_stats(self, state: PushState):
        return self._read(self._stats_tensor(state.frontier))

    def _new_values(self, state: PushState, tier: int, stats):
        exchange, compute = self._regions
        if tier > 0:
            with exchange:
                queue = self._sparse_load(state, stats)
            with compute:
                return self._sparse_new(state, queue, stats)
        with exchange:
            loaded = self._dense_load(state)
        with compute:
            acc = self._dense_acc(loaded)
            return combine_u32(self.program.combiner, state.values, acc)

    def _iterate(self, state: PushState, stats):
        """One iteration from ``state``, whose frontier has ``stats``;
        returns (new state, its stats, branch index)."""
        tier = self._branch(stats)
        new = self._new_values(state, tier, stats)
        with self._regions[1]:
            new_state, st = self._update(state.values, new)
        return new_state, self._read(st), tier

    def step(self, state):
        """One iteration; returns (new state, new frontier count)."""
        new_state, stats, _ = self._iterate(state,
                                            self._frontier_stats(state))
        return new_state, stats[0]

    def _run(self, state, max_iters: Optional[int], chunk: int,
             rec=NULL_RECORDER):
        """Iterate until a step leaves an empty frontier or ``max_iters``
        steps ran; returns (state, iterations, branch log). ``chunk``
        keeps ``lux_tpu``'s signature: there it batches host reads, and
        the iterations do not depend on it, except that a non-positive
        chunk runs none. ``rec`` gets one flush per chunk, as there."""
        log: List[tuple] = []
        if chunk <= 0:
            return state, 0, log
        window = FlushWindow(rec, chunk, "sparse_flags")
        stats = self._frontier_stats(state)
        while max_iters is None or len(log) < max_iters:
            prev = stats
            state, stats, tier = self._iterate(state, stats)
            # (branch, count, out-edges[, per-part counts]): a sharded
            # read's fourth entry is the process's own.
            log.append((tier,) + tuple(prev)[:3])
            window.step(len(log), stats[0], tier > 0)
            if stats[0] == 0:
                break
        window.close(len(log))
        return state, len(log), log

    def _hbm_bytes(self) -> int:
        return engobs.hbm_bytes_per_iter(self.graph.nv, self.graph.ne)

    def _note_exchange(self, rec) -> None:
        """A sharded executor's exchange ledger (none on one device)."""

    def run(self, max_iters: Optional[int] = None, state=None,
            chunk: int = 16, recorder=None, **init_kw):
        """Iterate to fixpoint; returns (final_state, iterations_run). The
        number of iterations the sparse branch served is left in
        ``self.sparse_iters``, and each iteration's (branch, counters
        before it) in ``self.branch_log``."""
        if state is None:
            state = self.init_state(**init_kw)
        rec = open_run(self, self._engine, recorder, self._hbm_bytes)
        self._note_exchange(rec)
        if self._phase_fenced and engobs.enabled():
            # Phase-fenced measurement fixpoint of a sharded executor.
            state, total, self.sparse_iters = engobs.run_push_phased(
                self, state, max_iters, rec)
            self.branch_log = []
        else:
            state, total, self.branch_log = self._run(state, max_iters,
                                                      chunk, rec)
            self.sparse_iters = sum(1 for e in self.branch_log if e[0] > 0)
        rec.finish()
        return state, total

    def warmup(self, chunk: int = 16, **init_kw):
        """One throwaway iteration through the exact run() path (builds
        the kernels) so timed runs exclude set-up; its seconds are the
        next run's compile time."""
        timed_warmup(self, lambda: self._run(self.init_state(**init_kw), 1,
                                             chunk))

    def warmup_phases(self, state: PushState):
        """Run every phase of both branches once outside any timed
        region. ``state`` is only read."""
        stats = self._frontier_stats(state)
        self._update(state.values, self._new_values(state, 0, stats))
        if self.sparse:
            self._update(state.values, self._new_values(state, 1, stats))
        sync(self.device)

    def phase_step(self, state: PushState):
        """One iteration as separately timed phases (CUDA events on the
        card): the reference's `-verbose` breakdown
        (sssp/sssp_gpu.cu:516-518). Dense: load = K5's input, comp = K5,
        update = merge, new frontier and its counters. Sparse: load = the
        frontier queue (K6), comp = its relax and scatter (K7), update =
        new frontier and its counters. Returns (new state, active count,
        times)."""
        dev = self.device
        exchange, compute = self._regions
        stats = self._frontier_stats(state)
        tier = self._branch(stats)
        times = {}
        if tier > 0:
            with exchange:
                queue, times["loadTime"] = timed(
                    lambda: self._sparse_load(state, stats), dev)
            with compute:
                new, times["compTime"] = timed(
                    lambda: self._sparse_new(state, queue, stats), dev)

            def finish():
                return self._update(state.values, new)
        else:
            with exchange:
                loaded, times["loadTime"] = timed(
                    lambda: self._dense_load(state), dev)
            with compute:
                acc, times["compTime"] = timed(
                    lambda: self._dense_acc(loaded), dev)

            def finish():
                return self._update(state.values, combine_u32(
                    self.program.combiner, state.values, acc))
        with compute:
            (new_state, st), times["updateTime"] = timed(finish, dev)
        times["branch"] = _tier_label(self.tiers, tier)
        return new_state, self._read(st)[0], times


class PushExecutor(FixpointLoop):
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
        self.tasks = (push_row_tasks(graph.row_ptr, self.device)
                      if self.device.type != "cpu" else None)
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

    def _dense_load(self, state: PushState):
        """K5's input: the packed table (blocked_dense; its build is the
        dense load phase), or the values and frontier."""
        if self.blocked_dense:
            return pack_words(state.values, state.frontier), None
        return state.values, state.frontier

    def _dense_acc(self, loaded) -> torch.Tensor:
        prog = self.program
        table, front = loaded
        return segment_minmax_relax(
            self.row_ptr, self.col_src, table, front, prog.combiner,
            prog.relax_op, self.tasks, relax=prog.relax, weights=self.weights,
        )

    def _sparse_load(self, state: PushState, stats):
        return frontier_queue(state.frontier, self.csr_row_ptr, stats[0])

    def _sparse_new(self, state: PushState, queue, stats):
        prog = self.program
        q, start, _, offs = queue
        return queue_relax_scatter(
            q, start, offs, self.csr_col_dst, state.values, prog.combiner,
            prog.relax_op, stats[1], relax=prog.relax,
            weights=self.csr_weights,
        )

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

    def _branch(self, stats) -> int:
        return _tier_index(*stats, self.tiers) if self.sparse else 0

    # -- public API --------------------------------------------------------

    def init_state(self, **kw) -> PushState:
        prog = self.program
        vals = to_u32_storage(prog.init_values(self.graph, **kw), self.device)
        fr = np.asarray(prog.init_frontier(self.graph, **kw), dtype=bool)
        return PushState(vals, torch.from_numpy(fr.copy()).to(self.device))

    def values(self, state: PushState) -> np.ndarray:
        """Host copy of the values, numpy uint32."""
        return u32_to_numpy(state.values)


class LanesLoop:
    """The iteration and fixpoint loop of the multi-source executors
    over K lanes, dense only, over their hooks: ``_lanes_storage`` (host
    (nv, K) arrays to device state), ``_load`` (the tables K10 reads),
    ``_acc`` and ``_update`` (new state and its frontier count)."""

    device: torch.device
    graph: Graph
    program: PushProgram
    k: int
    _regions = (NO_REGION, NO_REGION)
    _engine = "push_multi"
    _flush_kind = "sparse_flags"   # the recorder's branch: "dense"
    _phase_fenced = False

    def init_state(self, starts) -> PushState:
        """One value/frontier lane per root in ``starts``; fewer than k
        roots are right-padded by repeating the last root (a duplicate
        lane converges identically, so results and iteration counts do
        not change)."""
        starts = list(starts)
        if not 1 <= len(starts) <= self.k:
            raise ValueError(f"need 1..{self.k} roots, got {len(starts)}")
        starts = starts + [starts[-1]] * (self.k - len(starts))
        prog = self.program
        vals = np.stack(
            [prog.init_values(self.graph, start=s) for s in starts], axis=1)
        fr = np.stack(
            [prog.init_frontier(self.graph, start=s) for s in starts], axis=1)
        return self._lanes_storage(vals, fr.astype(bool))

    def step(self, state: PushState):
        """One iteration; returns (new state, new frontier count over all
        lanes)."""
        exchange, compute = self._regions
        with exchange:
            loaded = self._load(state)
        with compute:
            new_state, cnt = self._update(state.values, self._acc(loaded))
        return new_state, int(cnt)

    def _hbm_bytes(self) -> int:
        return engobs.hbm_bytes_per_iter(self.graph.nv, self.graph.ne,
                                         k=self.k)

    def _note_exchange(self, rec) -> None:
        """A sharded executor's exchange ledger (none on one device)."""

    def run(self, starts, max_iters: Optional[int] = None, chunk: int = 16,
            recorder=None, state: Optional[PushState] = None):
        """Run all roots in ``starts`` to their shared fixpoint; returns
        (final state, iterations run). Lane j holds root ``starts[j]``'s
        result. ``state`` starts the sweep from a caller-built state of
        ``init_state``'s shape instead. ``chunk`` keeps ``lux_tpu``'s
        signature (there it batches host reads, and the recorder flushes
        once per chunk here too); a non-positive chunk runs no
        iteration."""
        if state is None:
            state = self.init_state(starts)
        rec = open_run(self, self._engine, recorder, self._hbm_bytes)
        self._note_exchange(rec)
        if self._phase_fenced and engobs.enabled():
            state, total, _ = engobs.run_push_phased(self, state, max_iters,
                                                     rec)
        else:
            state, total = self._run(state, max_iters, chunk, rec)
        rec.finish()
        return state, total

    def _run(self, state: PushState, max_iters: Optional[int], chunk: int,
             rec=NULL_RECORDER):
        total = 0
        if chunk > 0:
            window = FlushWindow(rec, chunk, self._flush_kind)
            while max_iters is None or total < max_iters:
                state, cnt = self.step(state)
                total += 1
                window.step(total, cnt, 0)
                if cnt == 0:
                    break
            window.close(total)
        return state, total

    def warmup(self, chunk: int = 16, start: int = 0):
        """One iteration from ``init_state([start])`` through the run()
        path (builds the kernels) so timed runs exclude set-up, none when
        ``chunk`` is not positive, as in ``run``; its seconds are the
        next run's compile time."""
        timed_warmup(self, lambda: self._run(self.init_state([start]), 1,
                                             chunk))

    def warmup_phases(self, state: PushState):
        """Run every phase once outside any timed region. ``state`` is
        only read."""
        self._update(state.values, self._acc(self._load(state)))
        sync(self.device)

    def phase_step(self, state: PushState):
        """One iteration as separately timed phases (CUDA events on the
        card): load = the tables K10 reads (the exchange of a sharded
        executor; nothing on one device), comp = K10, update = merge, new
        frontier and its count. Returns (new state, active count over
        all lanes, times)."""
        dev, times = self.device, {}
        exchange, compute = self._regions
        with exchange:
            loaded, times["loadTime"] = timed(lambda: self._load(state),
                                              dev)
        with compute:
            acc, times["compTime"] = timed(lambda: self._acc(loaded), dev)
            (new_state, cnt), times["updateTime"] = timed(
                lambda: self._update(state.values, acc), dev)
        times["branch"] = "dense"
        return new_state, int(cnt), times


class MultiSourcePushExecutor(LanesLoop):
    """Dense push executor over K value columns (``cuda`` unless
    ``device`` names another): one sweep serves K root queries, the
    counterpart of ``lux_tpu``'s ``MultiSourcePushExecutor``.

    Each iteration is one K10 launch with K columns (``gas_pull_acc``
    with the program's ``relax_op`` as its gather op), then the min/max
    merge and one host read of the new frontier's count over all lanes.
    Lanes are independent monotone fixpoints, so running all of them
    until every one is quiet only repeats no-op iterations on early
    finishers: column j equals a single-source :class:`PushExecutor` run
    from root j. Dense only (``sparse_iters`` is always 0): the queue
    and the packed table are single-lane shapes."""

    def __init__(self, graph: Graph, program: PushProgram, k: int,
                 device=None):
        if k < 1:
            raise ValueError(f"batch width k must be >= 1 (got {k})")
        if program.needs_weights and graph.weights is None:
            raise ValueError(f"{program.name} requires an edge-weighted graph")
        self.graph = graph
        self.program = program
        self.k = int(k)
        self.device = resolve_device(device)
        on_card = self.device.type != "cpu"
        if on_card:
            # K10 is compiled for (min, add1) and (max, copy) among the
            # push programs' pairs; another pair raises here.
            gas_kernel_code(program.combiner, program.relax_op)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.row_ptr = put(graph.row_ptr.astype(np.int64))
        self.col_src = put(graph.col_src.astype(np.int32))
        self.weights = None if graph.weights is None else put(graph.weights)
        self.tasks = (RowTasks.build(graph.row_ptr, self.device)
                      if on_card else None)
        self.sparse_iters = 0   # API parity with PushExecutor (always 0)

    def _lanes_storage(self, vals: np.ndarray, fr: np.ndarray) -> PushState:
        return PushState(to_u32_storage(vals, self.device),
                         torch.from_numpy(fr).to(self.device))

    def _load(self, state: PushState):
        return state.values, state.frontier

    def _acc(self, loaded) -> torch.Tensor:
        prog = self.program
        table, front = loaded
        return gas_pull_acc(
            self.row_ptr, self.col_src, table, front, prog.combiner,
            prog.relax_op, self.tasks, gather=prog.relax,
            weights=self.weights)

    def _update(self, values: torch.Tensor, acc: torch.Tensor):
        new = combine_u32(self.program.combiner, values, acc)
        frontier = new != values
        return PushState(new, frontier), frontier.sum()

    def values_for(self, state: PushState, j: int) -> np.ndarray:
        """Host copy of lane ``j``'s value column, numpy uint32."""
        return u32_to_numpy(state.values[:, j].contiguous())
