"""Sharded GAS: direction-adaptive gather-apply-scatter over the P parts
of a :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` (one device) or a
:class:`~lux_tpu_torch.parallel.mesh.DistMesh` (the ranks of a process
group).

The counterparts of ``ShardedAdaptiveExecutor`` and
``ShardedMultiSourceGasExecutor`` in ``lux_tpu/engine/gas_sharded.py``,
which run one part per device of a ``shard_map`` mesh. Here the parts a
process holds are the leading axis of stacked ``(L, max_nv)`` values and
frontier, and each kernel is launched once per held part, as
``lux_tpu`` runs one device per part, except the push branch's K11: one
launch for every held receiving part.

:class:`ShardedAdaptiveExecutor` picks a direction per iteration exactly
as ``lux_tpu`` does (``_decide_block``), on counters over all parts: the
density hysteresis on the global frontier count (``psum`` there), and a
push must fit the per-part queue (the largest part's count, ``pmax``)
and the edge budget (the out-edges of all parts, ``psum``). The update
leaves each held part's count, its out-edges into the parts of each
process that holds parts and, in frontier mode, its largest count of
active send rows as one small ``(L, ·)`` tensor that the host reads
once per iteration, gathered over ranks into the same rows on every
rank; that read is the direction decision, the frontier exchange's
admission, the push's edge total and the halt check.

- **pull**: the exchange, then one K10 launch (``ops/segment.py::
  gas_pull_acc``) per part over its real in-edges (``local_row_ptr[p]``,
  ``src_pidx`` rows of the flat table). Full: the mesh's ``all_gather``
  of values and frontier, views of the stacks. Compact
  (:class:`~lux_tpu_torch.parallel.mesh.CompactExchange`): per receiver
  a table of the rows its edges read. Frontier
  (:class:`~lux_tpu_torch.parallel.mesh.FrontierExchange`): of those
  rows only the active ones, when every (sender, receiver) pair's fit
  ``frontier_cap``; else the iteration takes the compact tables and
  counts one downgrade. The receiver's own span is written from its
  shard in both, so they equal full bitwise without ``lux_tpu``'s
  per-edge local/remote select;
- **push**: each held part compacts its frontier into a queue (K6,
  ``ops/frontier.py::frontier_queue``), the queues in part order are
  the all-gathered queue (across ranks with their values,
  :meth:`~lux_tpu_torch.engine.push_sharded.SparseQueue._queue`), and
  each held receiving part's push CSR (keyed by global source) gives its
  ranges at the queued ids; one K11 launch (``gas_push_acc``) folds
  every held receiver's messages into its row of an identity-filled
  ``(L, max_nv)`` accumulator;
- **merge**: ``apply`` and ``scatter`` over the stacked parts, pad
  vertices frozen by ``vertex_mask`` and kept out of the new frontier.

Both directions fold the same messages with an order-free combine, so
values are bitwise equal across directions, exchange modes and part
counts, and equal to the single-device
:class:`~lux_tpu_torch.engine.gas.AdaptiveExecutor`'s. Frontier-less
programs (``PullGasAdapter``) run
:class:`~lux_tpu_torch.engine.pull_sharded.ShardedPullExecutor`'s step:
the values-only exchange and K8 or K9 per part.

:class:`ShardedMultiSourceGasExecutor` is pull only over ``(L, max_nv,
K)`` lanes: the K-lane full or compact exchange (``frontier`` runs
compact, logged), one K10 launch with K columns per held part, the
merge and one count over all parts.

On the CPU the kernels' plain versions run. Telemetry is ``lux_tpu``'s:
``run`` takes a recorder (one flush per ``chunk``, the exchange ledger,
useful bytes, the byte model), ``ShardedAdaptiveExecutor`` runs
phase-fenced under ``LUX_ENGOBS=1`` (``obs/engobs.py``), and a step's
exchange and compute are the ``prof`` regions ``lux.gas_sharded.*``
(``lux.gas_multi_sharded.*``). ``trace_step`` gives the trace tiers
(``analysis/ir.py``) one iteration with every branch. ``chunk``
keeps ``lux_tpu``'s signature: there it batches host reads; here it
sets the recorder's flush windows, and a non-positive chunk runs no
iteration.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lux_tpu_torch.engine.gas import (
    EDGE_BUDGET_FRAC,
    QUEUE_FRAC,
    GasProgram,
    GasState,
    _resolve_mode,
    as_gas,
    check_gas_kernel_covers,
    count_switches,
    is_u32,
)
from lux_tpu_torch.engine.program import PullProgram
from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
from lux_tpu_torch.engine.push import LanesLoop, _sparse_budgets
from lux_tpu_torch.engine.push_sharded import SparseQueue
from lux_tpu_torch.engine.sharded import ShardedBase
from lux_tpu_torch.engine.telemetry import (
    NULL_RECORDER,
    FlushWindow,
    note_exchange,
    open_run,
    sync,
    timed_warmup,
)
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.obs import engobs, prof
from lux_tpu_torch.ops.frontier import gas_push_acc
from lux_tpu_torch.ops.segment import (
    RowTasks,
    gas_narrow,
    gas_pull_acc,
    gas_widen,
    to_u32_storage,
    u32_to_numpy,
)
from lux_tpu_torch.parallel.mesh import AnyMesh, FrontierExchange, gather_rows
from lux_tpu_torch.parallel.shard import ShardedGraph
from lux_tpu_torch.utils import flags, tracehooks
from lux_tpu_torch.utils.timing import timed

_EXCHANGE = prof.region("lux.gas_sharded.exchange")
_COMPUTE = prof.region("lux.gas_sharded.compute")


class Stats(NamedTuple):
    """One host read of a frontier's counters."""

    count: int                 # active vertices over all parts
    out_edges: int             # their out-edges over all parts
    counts: Tuple[int, ...]    # active vertices per part
    widest: int                # largest active send rows of one pair
    #                            (frontier mode; else 0)
    recv_edges: int = 0        # their out-edges into the held parts


class _ShardedGas(ShardedBase):
    """Padded GAS state over the parts: uint32 values as int32 words, or
    f32, and a bool frontier; the merge over the stacked parts."""

    program: GasProgram
    _u32: bool

    def _gas_setup(self, graph: Graph, program: GasProgram,
                   mesh: Optional[AnyMesh], num_parts: Optional[int],
                   sg: Optional[ShardedGraph], device,
                   frontier_ok: bool) -> None:
        """The mesh, partition, exchange mode and per-part operands (K10's
        row tasks on the card)."""
        self._setup(graph, program, mesh, num_parts, sg, device,
                    frontier_ok=frontier_ok)
        self._u32 = is_u32(program.value_dtype)
        if self.device.type != "cpu":
            check_gas_kernel_covers(program)
        self._build_parts(RowTasks.build)

    def _padded(self, host: np.ndarray) -> torch.Tensor:
        """Global (nv, *t) host array -> (L, max_nv, *t) device storage
        of the held parts: bool, int32 words of uint32 values, or f32."""
        padded = self._own(self.sg.to_padded(np.asarray(host)))
        if padded.dtype == bool:
            return self._put(padded)
        if self._u32:
            return to_u32_storage(padded, self.device)
        return self._put(padded.astype(np.float32))

    def gather_values(self, state: GasState) -> np.ndarray:
        """Padded device layout -> global (nv, *t) host array: numpy
        uint32, or f32; on every rank (a collective over ranks)."""
        every = self._gathered(state.values)
        vals = (u32_to_numpy(every) if self._u32
                else every.detach().cpu().numpy())
        return self.sg.from_padded(vals)

    def _merge(self, values: torch.Tensor, acc: torch.Tensor):
        """(new values, new frontier): ``apply`` and ``scatter`` over the
        stacked parts, pad vertices frozen and never active."""
        prog = self.program
        old, _ = gas_widen(values)
        new = prog.apply(old, gas_widen(acc)[0])
        mask = self.vertex_mask.view(
            tuple(self.vertex_mask.shape) + (1,) * (values.dim() - 2))
        new = torch.where(mask, new, old)
        return gas_narrow(new, values), prog.scatter(old, new) & mask

    def _pull_acc(self, loaded) -> torch.Tensor:
        """(L, max_nv[, K]) accumulators: one K10 launch per held part
        over its table (K columns for lanes)."""
        prog = self.program
        table, front = loaded
        return torch.stack([
            gas_pull_acc(part.row_ptr, part.col_src, self._table(table, q),
                         self._table(front, q), prog.combiner,
                         prog.gather_op, part.tasks, gather=prog.gather,
                         weights=part.weights)
            for q, part in enumerate(self._parts)])


class ShardedAdaptiveExecutor(_ShardedGas, SparseQueue):
    """GAS executor over the ``num_parts`` parts of a
    :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` or a
    :class:`~lux_tpu_torch.parallel.mesh.DistMesh` (``cuda`` unless
    ``device`` or ``mesh`` names another) with ``lux_tpu``'s
    per-iteration direction choice (see the module docstring).

    ``direction_log`` holds, per iteration of the last ``run()``,
    (direction, frontier count, frontier out-edges, branch, per-part
    counts) before the step: direction 0 pull, 1 push; the branch as
    :meth:`phase_step` reports it (``push``, ``pull``, ``pull/frontier``,
    ``pull/downgraded``, ``pull/dense``). K10 launches once per held
    part and pull iteration, K6 once per held part with a frontier and
    push iteration, K11 once per push iteration with out-edges into the
    held parts: ``queue_log`` holds, per push iteration since the last
    ``run()``, (held parts that compacted a queue, 1 if K11 launched
    else 0), from the counts the iteration already read."""

    def __init__(
        self,
        graph: Graph,
        program,
        mesh: Optional[AnyMesh] = None,
        num_parts: Optional[int] = None,
        mode: Optional[str] = None,
        queue_frac: int = QUEUE_FRAC,
        edge_budget_frac: int = EDGE_BUDGET_FRAC,
        sg: Optional[ShardedGraph] = None,
        device=None,
    ):
        program = as_gas(program)
        self.mode = "pull" if not program.frontier else _resolve_mode(mode)
        nv = graph.nv
        hi = flags.get_float("LUX_GAS_DENSITY_HI")
        lo = flags.get_float("LUX_GAS_DENSITY_LO")
        if not 0.0 < lo <= hi <= 1.0:
            raise ValueError(
                f"need 0 < LUX_GAS_DENSITY_LO <= LUX_GAS_DENSITY_HI <= 1 "
                f"(got lo={lo}, hi={hi})")
        self.hi_count = max(1, math.ceil(hi * nv))
        self.lo_count = max(0, math.ceil(lo * nv))
        self.frontier_cap = 0
        self._fx: Optional[FrontierExchange] = None
        if not program.frontier:
            inner = getattr(program, "inner", None)
            if not isinstance(inner, PullProgram):
                raise TypeError(
                    f"{program.name}: a frontier-less GAS program runs "
                    "through PullGasAdapter (as_gas of a PullProgram)")
            # The dense pull step (values only; K8/K9 per part), as the
            # single-device AdaptiveExecutor runs PullExecutor's.
            self._pull = ShardedPullExecutor(graph, inner, mesh=mesh,
                                             num_parts=num_parts, sg=sg,
                                             device=device)
            for name in ("mesh", "num_parts", "parts", "device", "sg",
                         "exchange_mode", "_xplan", "_row_bytes"):
                setattr(self, name, getattr(self._pull, name))
            self.graph, self.program, self._u32 = graph, program, False
        else:
            self._gas_setup(graph, program, mesh, num_parts, sg, device,
                            frontier_ok=True)
            # A row is a value and one frontier byte (frontier programs
            # are scalar; a frontier-less one's rows are values only).
            self._row_bytes = np.dtype(program.value_dtype).itemsize + 1
            sg = self.sg
            if self.exchange_mode == "frontier":
                self.frontier_cap = self._xplan.frontier_capacity(
                    frac=flags.get_float("LUX_EXCHANGE_FRONTIER_FRAC"))
                self._fx = FrontierExchange(self._xplan, self.mesh,
                                            sg.max_nv, self.frontier_cap)
            if self.mode != "pull":
                # lux_tpu's budgets over a part: a queue of max_nv /
                # queue_frac + 128 vertices and max_ne / edge_budget_frac
                # edges, sized so every frontier the policy can route to
                # push fits; the queue is per part, so its cap tops out at
                # the part even when hi_count (of the global nv) passes it.
                q_cap, self.edge_budget = _sparse_budgets(
                    sg.max_nv, sg.max_ne, queue_frac, edge_budget_frac)
                self.queue_cap = max(q_cap,
                                     min(self.hi_count, sg.max_nv) + 128)
                self._build_queue()
        # Filled by run(): the per-run direction and exchange ledger.
        self.push_iters = 0
        self.pull_iters = 0
        self.direction_switches = 0
        self.exchange_downgrades = 0
        self.direction_log: List[tuple] = []
        self.queue_log: List[tuple] = []

    # -- the two directions ----------------------------------------------

    def _pull_load(self, state: GasState, send: bool):
        """The pull exchange: (values table, frontier table), through
        the frontier send when ``send``, else the exchange of both."""
        v, f = state.values, state.frontier
        if send:
            return self._fx.tables(v, f, self._pad(v))
        return self._exchange(v), self._exchange(f)

    def _push_load(self, state: GasState, stats: Stats):
        """Each held part's frontier queue (K6), all-gathered in part
        order: (flat rows, global ids[, values table])."""
        return self._queue(state.frontier, state.values, stats.counts)

    def _push_acc(self, state: GasState, queue, stats: Stats):
        """(L, max_nv) accumulators: one K11 launch over the queue's
        out-edges in every held part's push CSR. ``stats.recv_edges``,
        the frontier's out-edges into the held parts, is the receivers'
        total."""
        prog = self.program
        rows, ids = queue[:2]
        start, offs = self._ranges(ids)
        self.queue_log.append((
            sum(1 for p in self.parts if stats.counts[p]),
            int(rows.numel() > 0 and stats.recv_edges > 0)))
        return gas_push_acc(
            rows, start, offs, self.push_dst_local,
            self._table_of(queue, state.values),
            prog.combiner, prog.gather_op, stats.recv_edges,
            gather=prog.gather_push or prog.gather,
            weights=self.push_weights)[:, :self.sg.max_nv]

    def _decide_push(self, stats: Stats, prev_direction: int) -> bool:
        """``lux_tpu``'s direction decision: pinned modes are constants,
        adaptive is the density hysteresis on the global count, and any
        push must fit the per-part queue and the edge budget.
        ``lux_tpu`` sums the out-edges in uint32, here int64: the two
        differ only above 2**32 out-edges."""
        if self.mode == "pull":
            return False
        if self.mode == "push":
            want = True
        elif stats.count >= self.hi_count:
            want = False
        elif stats.count <= self.lo_count:
            want = True
        else:
            want = prev_direction > 0
        return (want and max(stats.counts) <= self.queue_cap
                and stats.out_edges <= self.edge_budget)

    # -- the host read ----------------------------------------------------

    def _stats_tensor(self, frontier: torch.Tensor) -> torch.Tensor:
        """Per held part, the frontier's count, its out-edges into the
        parts of each process that holds parts (unless the executor
        never pushes) and, in frontier mode, the part's largest count of
        active send rows to one receiver: one (L, k) int64 tensor."""
        cols = [frontier.sum(1)[:, None]]
        if self.mode != "pull":
            cols.append(self._send_edges(frontier))
        if self._fx is not None:
            cols.append(self._fx.widest(frontier)[:, None])
        return torch.cat(cols, 1)

    def _read(self, stats: torch.Tensor) -> Stats:
        """The one device-to-host read of an iteration, the same on every
        rank."""
        rows = self._gather_stats(stats)
        counts = tuple(r[0] for r in rows)
        out = recv = 0
        if self.mode != "pull":
            procs = self.num_parts // len(self.parts)
            out = sum(sum(r[1:1 + procs]) for r in rows)
            recv = sum(r[1 + self._slot] for r in rows)
        return Stats(
            sum(counts), out, counts,
            max(r[-1] for r in rows) if self._fx is not None else 0, recv)

    def _frontier_stats(self, state: GasState) -> Stats:
        if not self.program.frontier:
            # Never halts early: run() bounds it.
            return Stats(self.graph.nv, 0, (), 0)
        return self._read(self._stats_tensor(state.frontier))

    # -- one iteration ------------------------------------------------------

    def _pick(self, state: GasState, stats: Stats) -> str:
        """The branch the host takes from a frontier whose counters are
        ``stats``: ``push``, else the pull; in frontier mode the frontier
        send, or its compact downgrade when a part's widest send passes
        the cap."""
        if self._decide_push(stats, state.direction):
            return "push"
        if self.exchange_mode != "frontier":
            return "pull"
        return ("pull/downgraded" if stats.widest > self.frontier_cap
                else "pull/frontier")

    def _branches(self) -> Tuple[str, ...]:
        """Every branch :meth:`_pick` may name."""
        pulls = (("pull/frontier", "pull/downgraded")
                 if self.exchange_mode == "frontier" else ("pull",))
        return (("push",) if self.mode != "pull" else ()) + pulls

    def _device_step(self, state: GasState, stats: Stats,
                     every: bool = False):
        """The device side of one iteration from ``state``, whose
        frontier has ``stats``: the branch :meth:`_pick` names, and with
        ``every`` each of :meth:`_branches`, each a
        :func:`~lux_tpu_torch.utils.tracehooks.alternatives` branch, as
        ``lux_tpu``'s ``lax.cond`` holds them (the trace tiers' step,
        which leaves ``queue_log`` as it was). Returns the picked
        branch's new state and its counters on the device (None for a
        frontier-less program, whose frontier and direction pass
        through); the host's read of them follows."""
        if not self.program.frontier:
            pull = self._pull
            with _EXCHANGE:
                flat = pull._exchange(state.values)
            with _COMPUTE:
                new = pull._update(state.values, pull._comp(flat))
            return state._replace(values=new), None
        pick = self._pick(state, stats)
        accs = {}
        keep = ("queue_log",) if every else ()
        with tracehooks.preserved(self, *keep):
            alt = tracehooks.alternatives()
            for label in self._branches() if every else (pick,):
                with alt.branch(label):
                    if label == "push":
                        with _EXCHANGE:
                            queue = self._push_load(state, stats)
                        with _COMPUTE:
                            accs[label] = self._push_acc(state, queue,
                                                         stats)
                    else:
                        with _EXCHANGE:
                            loaded = self._pull_load(
                                state, label == "pull/frontier")
                        with _COMPUTE:
                            accs[label] = self._pull_acc(loaded)
        with _COMPUTE:
            new, frontier = self._merge(state.values, accs[pick])
        return (GasState(new, frontier, int(pick == "push")),
                self._stats_tensor(frontier))

    def _iterate(self, state: GasState, stats: Stats):
        """One iteration from ``state``, whose frontier has ``stats``;
        returns (new state, its stats, direction, branch)."""
        new_state, st = self._device_step(state, stats)
        if st is None:
            return new_state, stats, 0, "pull/dense"
        # luxlint: disable=LUX001 -- one counter read per iteration, where lux_tpu reads once a chunk (ROADMAP A20)
        return (new_state, self._read(st), new_state.direction,
                self._pick(state, stats))

    # -- driving ----------------------------------------------------------

    def init_state(self, **kw) -> GasState:
        """The program's initial state, padded to (L, max_nv)."""
        prog = self.program
        if not prog.frontier:
            vals = self._pull.init_values()
        else:
            vals = self._padded(prog.init_values(self.graph, **kw))
        fr = self._padded(np.asarray(prog.init_frontier(self.graph, **kw),
                                     dtype=bool))
        return GasState(vals, fr, 0)

    def step(self, state: GasState):
        """One iteration; returns (new state, new frontier count over all
        parts)."""
        new_state, stats, _, _ = self._iterate(state,
                                               self._frontier_stats(state))
        return new_state, stats.count

    def trace_step(self, **init_kw) -> dict:
        """Trace-tier hook (``analysis/ir.py``): :meth:`_device_step`
        over every branch, from the program's initial state and its
        counters (read once, as the step before it ends with), with the
        exchange keys
        LUX404-407 read. ``lux_tpu`` donates the state; this step
        writes new values and a new frontier (a frontier-less program's
        frontier passes through, but not its values), so it donates
        nothing (ROADMAP: memck's LUX702)."""
        def args():
            state = self.init_state(**init_kw)
            return state, self._frontier_stats(state)

        return {"kind": "gas_sharded",
                "call": functools.partial(self._device_step, every=True),
                "args": args,
                "donate": (), "carry": (0,), **self._exchange_spec()}

    def _run(self, state: GasState, max_iters: Optional[int], chunk: int,
             rec=NULL_RECORDER):
        """Iterate until a step leaves an empty frontier or ``max_iters``
        steps ran; returns (state, iterations, direction log). A start
        with an empty frontier still runs one iteration, as in
        ``lux_tpu``. ``rec`` gets one flush per chunk, as there."""
        log: List[tuple] = []
        if chunk <= 0:
            return state, 0, log
        window = FlushWindow(rec, chunk, "directions")
        stats = self._frontier_stats(state)
        while max_iters is None or len(log) < max_iters:
            prev = stats
            state, stats, direction, branch = self._iterate(state, stats)
            log.append((direction, prev.count, prev.out_edges, branch,
                        prev.counts))
            window.step(len(log), stats.count, direction)
            if stats.count == 0:
                break
        window.close(len(log))
        return state, len(log), log

    def run(self, max_iters: Optional[int] = None,
            state: Optional[GasState] = None, chunk: int = 16,
            recorder=None, **init_kw):
        """Iterate to fixpoint (or ``max_iters``); returns (final_state,
        iterations_run). The directions land in ``push_iters``,
        ``pull_iters``, ``direction_switches`` and ``direction_log``,
        frontier-exchange downgrades in ``exchange_downgrades``. Under
        ``LUX_ENGOBS=1`` the run is phase-fenced and ``direction_log``
        stays empty (the recorder holds each iteration's branch)."""
        if not self.program.frontier and max_iters is None:
            raise ValueError(
                f"{self.program.name} is a frontier-less pull program; "
                "run() needs max_iters")
        if state is None:
            state = self.init_state(**init_kw)
        self.queue_log = []
        rec = open_run(self, "gas_sharded", recorder, lambda: (
            engobs.hbm_bytes_per_iter(self.graph.nv, self.graph.ne)))
        note_exchange(rec, self, "dense_estimate", self._row_bytes,
                      note=("frontier_all_to_all"
                            if self.exchange_mode == "frontier" else None))
        if engobs.enabled():
            state, total, pushes, switches, downs = engobs.run_gas_phased(
                self, state, max_iters, rec)
            self.direction_log = []
        else:
            state, total, self.direction_log = self._run(state, max_iters,
                                                         chunk, rec)
            dirs = [e[0] for e in self.direction_log]
            pushes = sum(dirs)
            switches = count_switches(dirs)
            downs = sum(1 for e in self.direction_log
                        if e[3] == "pull/downgraded")
        self.push_iters = pushes
        self.pull_iters = total - pushes
        self.direction_switches = switches
        self.exchange_downgrades = downs
        engobs.note(
            "gas_sharded", program=self.program.name, mode=self.mode,
            exchange=self.exchange_mode, num_parts=self.num_parts,
            num_iters=total, direction_push=pushes,
            direction_pull=total - pushes, direction_switches=switches,
            exchange_downgrades=downs)
        rec.finish()
        return state, total

    def warmup(self, chunk: int = 16, **init_kw):
        """One throwaway iteration through the run() path (builds the
        kernels) so timed runs exclude set-up; its seconds are the next
        run's compile time."""
        timed_warmup(self, lambda: self._run(self.init_state(**init_kw), 1,
                                             chunk))

    def finalize(self, state: GasState) -> dict:
        """Host-side derived outputs of the converged state (numpy)."""
        return self.program.finalize_host(self.graph,
                                          self.gather_values(state))

    def phase_step(self, state: GasState):
        """One iteration as separately timed phases (CUDA events on the
        card). Push: load = K6 per part and the queue all-gather, comp =
        the receivers' ranges and K11. Pull: load = the exchange, comp =
        K10 per part. Dense (frontier-less): load = the values exchange,
        comp = K8/K9 per part. update = the merge and the new frontier's
        counters (apply for dense). Returns (new state, active count,
        times with ``branch`` and ``downgraded``)."""
        dev, times = self.device, {}
        stats = self._frontier_stats(state)
        if not self.program.frontier:
            pull = self._pull
            with _EXCHANGE:
                flat, times["loadTime"] = timed(
                    lambda: pull._exchange(state.values), dev)
            with _COMPUTE:
                acc, times["compTime"] = timed(lambda: pull._comp(flat),
                                               dev)
                new, times["updateTime"] = timed(
                    lambda: pull._update(state.values, acc), dev)
            times["branch"], times["downgraded"] = "pull/dense", 0
            return state._replace(values=new), stats.count, times
        pick = self._pick(state, stats)
        if pick == "push":
            with _EXCHANGE:
                queue, times["loadTime"] = timed(
                    lambda: self._push_load(state, stats), dev)
            with _COMPUTE:
                acc, times["compTime"] = timed(
                    lambda: self._push_acc(state, queue, stats), dev)
        else:
            with _EXCHANGE:
                loaded, times["loadTime"] = timed(
                    lambda: self._pull_load(state, pick == "pull/frontier"),
                    dev)
            with _COMPUTE:
                acc, times["compTime"] = timed(
                    lambda: self._pull_acc(loaded), dev)

        def finish():
            new, frontier = self._merge(state.values, acc)
            return new, frontier, self._read(self._stats_tensor(frontier))

        with _COMPUTE:
            (new, frontier, st), times["updateTime"] = timed(finish, dev)
        times["branch"] = pick
        times["downgraded"] = int(pick == "pull/downgraded")
        return GasState(new, frontier, int(pick == "push")), st.count, times

    def warmup_phases(self, state: GasState):
        """Run every phase of both directions once outside any timed
        region (the frontier send too, where its mode has one). ``state``
        is only read."""
        stats = self._frontier_stats(state)
        if not self.program.frontier:
            self._pull._step(state.values)
        else:
            loaded = self._pull_load(state, False)
            self._merge(state.values, self._pull_acc(loaded))
            if self._fx is not None:
                self._pull_load(state, True)
            if self.mode != "pull":
                self._merge(state.values, self._push_acc(
                    state, self._push_load(state, stats), stats))
        sync(self.device)

    # -- accounting ---------------------------------------------------------

    def _frontier_row_bytes(self) -> int:
        """Frontier-mode packed row: a value and an int32 row id (the
        activity bit rides in the id's sentinel)."""
        return np.dtype(self.program.value_dtype).itemsize + 4

    def frontier_evidence(self) -> Optional[dict]:
        """``lux_tpu``'s LUX407 inputs: the static admission contract of
        the frontier send (None unless in frontier mode). An iteration
        with more than ``frontier_max_sends`` active rows on any pair
        downgrades instead of truncating, and dropped rows are inactive
        (``frontier_fill_active`` 0)."""
        if self.exchange_mode != "frontier":
            return None
        p = self.num_parts
        rb = self._frontier_row_bytes()
        return {
            "frontier_capacity": self.frontier_cap,
            "frontier_max_sends": self.frontier_cap,
            "frontier_row_bytes": rb,
            "frontier_bytes_per_iter": p * (p - 1) * self.frontier_cap * rb,
            "frontier_fill_active": 0,
        }


class ShardedMultiSourceGasExecutor(_ShardedGas, LanesLoop):
    """Dense GAS over the parts of a
    :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` or a
    :class:`~lux_tpu_torch.parallel.mesh.DistMesh` with K value lanes per
    vertex (``cuda`` unless ``device`` or ``mesh`` names another): one
    K10 launch with K columns per held part and iteration serves K root
    queries of a rooted frontier program; column j of
    :meth:`gather_values` equals a single-source run from root j.
    ``LUX_EXCHANGE=frontier`` runs the compact exchange (logged): the
    frontier send is single-lane shaped. ``phase_step``'s load is the
    K-lane exchange."""

    _regions = (prof.region("lux.gas_multi_sharded.exchange"),
                prof.region("lux.gas_multi_sharded.compute"))
    _engine = "gas_multi_sharded"
    _flush_kind = "directions"   # the recorder's branch: "pull"

    def __init__(
        self,
        graph: Graph,
        program,
        k: int,
        mesh: Optional[AnyMesh] = None,
        num_parts: Optional[int] = None,
        sg: Optional[ShardedGraph] = None,
        device=None,
    ):
        if k < 1:
            raise ValueError(f"batch width k must be >= 1 (got {k})")
        program = as_gas(program)
        if not program.frontier:
            raise ValueError(
                f"{program.name} is frontier-less; multi-source batching "
                "needs a rooted frontier program")
        self.k = int(k)
        self._gas_setup(graph, program, mesh, num_parts, sg, device,
                        frontier_ok=False)
        self._row_bytes = self.k * (np.dtype(program.value_dtype).itemsize
                                    + 1)
        self.push_iters = 0          # pull only: always 0
        self.pull_iters = 0
        self.direction_switches = 0
        self.exchange_downgrades = 0

    def _lanes_storage(self, vals: np.ndarray, fr: np.ndarray) -> GasState:
        return GasState(self._padded(vals), self._padded(fr), 0)

    def _load(self, state: GasState):
        """The K-lane exchange: (values, frontier) tables."""
        return self._exchange(state.values), self._exchange(state.frontier)

    def _acc(self, loaded) -> torch.Tensor:
        """(L, max_nv, K) accumulators: one K10 launch per held part."""
        return self._pull_acc(loaded)

    def _update(self, values: torch.Tensor, acc: torch.Tensor):
        new, frontier = self._merge(values, acc)
        return GasState(new, frontier, 0), gather_rows(
            self.mesh, frontier.sum((1, 2))[:, None]).sum()

    def run(self, starts, max_iters: Optional[int] = None, chunk: int = 16,
            recorder=None, state: Optional[GasState] = None):
        """Run all roots in ``starts`` to their shared fixpoint; returns
        (final state, iterations run), the count also in
        ``pull_iters``."""
        state, total = super().run(starts, max_iters, chunk, recorder,
                                   state)
        self.pull_iters = total
        engobs.note("gas_multi_sharded", program=self.program.name,
                    mode="pull", exchange=self.exchange_mode,
                    num_parts=self.num_parts, num_iters=total, lanes=self.k)
        return state, total

    def _note_exchange(self, rec) -> None:
        note_exchange(rec, self, "dense_estimate")

    def trace_step(self, start: int = 0, **init_kw) -> dict:
        """Trace-tier hook (``analysis/ir.py``): one K-lane iteration
        from root ``start`` (:meth:`LanesLoop._trace_spec`), with the
        exchange keys LUX404-406 read."""
        return self._trace_spec("gas_multi_sharded", start,
                                **self._exchange_spec())

    def values_for(self, state: GasState, j: int) -> np.ndarray:
        """Host copy of lane ``j``'s global value column (a collective
        over ranks)."""
        return np.ascontiguousarray(self.gather_values(state)[:, j])

    def finalize_for(self, state: GasState, j: int) -> dict:
        return self.program.finalize_host(self.graph,
                                          self.values_for(state, j))
