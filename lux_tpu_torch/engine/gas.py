"""Gather-apply-scatter (GAS) engine: one program abstraction and a
direction-adaptive executor, on the GPU.

The counterpart of ``lux_tpu/engine/gas.py``. A :class:`GasProgram`
declares

    msg_e    = gather(val[src_e], w_e)        # per edge, either direction
    acc_v    = combine(msg_e for e into v)    # min | max | sum
    new_v    = apply(old_v, acc_v)            # per vertex
    front'_v = scatter(old_v, new_v)          # next iteration's frontier

and :class:`AdaptiveExecutor` builds ``acc`` per iteration in one of two
directions:

- **pull**: kernel K10 (``ops/segment.py::gas_pull_acc``) over every CSC
  in-edge, non-frontier sources masked to the combiner identity;
- **push**: K6 (``ops/frontier.py::frontier_queue``) compacts the
  frontier into a queue, K11 (``gas_push_acc``) expands its CSR
  out-edges into an identity-filled accumulator.

Both fold the same messages with an order-free combine (integer min,
max and sum; f32 min), so the results are bitwise equal across
``pull``, ``push`` and ``adaptive`` schedules. ``apply`` and ``scatter``
are plain torch.

The direction is ``lux_tpu``'s decision (:meth:`AdaptiveExecutor.
_decide_push`), made on the host: like ``PushExecutor``, the executor
reads the frontier's (count, out-edge total) once per iteration, and
that one read is both the direction decision and the halt check. The
hysteresis memory is :attr:`GasState.direction`, which carries across
``run(state=...)``. ``iterations``, ``push_iters``, ``pull_iters`` and
``direction_switches`` equal ``lux_tpu``'s for every mode, ``max_iters``
and ``chunk``.

Program hooks see values as ``PushProgram.relax`` does: uint32 values
widened to int64 in ``[0, 2**32)`` (stored as int32 words of the same
bits, see :mod:`lux_tpu_torch.ops.segment`), f32 values as they are. On
the card a program names its edge function by ``gather_op``
(``ops/segment.py::GATHER_OPS``); the executor refuses at build time a
program whose (combiner, ``gather_op``) the kernels are not compiled
for, whose ``gather`` is defined apart from its ``gather_op``, or that
has a ``gather_push``. Frontier-less programs (``PullGasAdapter``) run a
fixed number of dense pull iterations through
:class:`~lux_tpu_torch.engine.pull.PullExecutor`'s step: K8 or K9 by
``edge_op``.

``run`` records itself as ``lux_tpu``'s does (a recorder flushed once
per ``chunk``, the engobs note of its directions, the compile seconds
``warmup`` notes). Not ported: ``trace_step`` (ROADMAP A16). ``chunk``
keeps ``lux_tpu``'s signature: there it batches host reads; here it
sets the recorder's flush windows, and a non-positive chunk runs no
iteration.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lux_tpu_torch.engine.program import EdgeCtx, PullProgram, VertexCtx
from lux_tpu_torch.engine.pull import PullExecutor, _owner
from lux_tpu_torch.engine.push import PushProgram, _sparse_budgets
from lux_tpu_torch.engine.telemetry import (
    NULL_RECORDER,
    FlushWindow,
    open_run,
    timed_warmup,
)
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.obs import engobs
from lux_tpu_torch.ops.frontier import frontier_queue, gas_push_acc
from lux_tpu_torch.ops.segment import (
    RowTasks,
    gas_kernel_code,
    gas_narrow,
    gas_pull_acc,
    gas_storage_dtype,
    gas_widen,
    to_u32_storage,
    u32_to_numpy,
)
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.platform import resolve_device
from lux_tpu_torch.utils.timing import timed

GAS_MODES = ("pull", "push", "adaptive")
# lux_tpu's push budgets: a queue of nv / QUEUE_FRAC + 128 vertices (at
# least the adaptive band's hi_count + 128) and ne / EDGE_BUDGET_FRAC edges.
QUEUE_FRAC = 16
EDGE_BUDGET_FRAC = 8


def is_u32(dtype) -> bool:
    """True iff a program's ``value_dtype`` is uint32."""
    return not isinstance(dtype, torch.dtype) and np.dtype(dtype) == np.uint32


class GasProgram:
    """One vertex program, two executable directions.

    Frontier programs (``frontier = True``) implement ``init_values`` /
    ``init_frontier`` / ``gather`` and inherit the combiner-merge
    ``apply`` and changed-bitmap ``scatter``; programs with other update
    rules (k-core's decrement) override those. ``finalize_host`` derives
    host outputs (BFS parents, label-prop communities) from the converged
    values in numpy. Frontier-less programs (``frontier = False``, the
    ``PullProgram`` adapter) run a fixed number of dense pull iterations.
    """

    name: str = "gas"
    combiner: str = "min"           # 'min' | 'max' | 'sum'
    value_dtype = np.uint32         # np.uint32 or np.float32
    needs_weights: bool = False
    rooted: bool = False            # takes a per-query `start` root
    frontier: bool = True           # False => fixed-iteration dense pull
    frontier_ok: bool = True
    incremental_ok: bool = False
    # The edge function by the name the CUDA GAS kernels know it
    # (ops/segment.py::GATHER_OPS); the class that sets it must also
    # define ``gather``. A program without one runs its plain ``gather``
    # on the CPU and is refused on the card.
    gather_op: Optional[str] = None

    # A push-direction edge function (lux_tpu's override); None means
    # ``gather``. The card refuses a program that sets one.
    gather_push = None

    # -- frontier-program hooks ------------------------------------------

    def init_values(self, graph: Graph, **kw) -> np.ndarray:
        raise NotImplementedError

    def init_frontier(self, graph: Graph, **kw) -> np.ndarray:
        raise NotImplementedError

    def gather(self, src_vals: torch.Tensor, weights) -> torch.Tensor:
        """Per-edge message from an active source, the one edge function
        both directions run."""
        raise NotImplementedError

    def apply(self, old: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        """The new value from the old one and the accumulated messages;
        the default is the combiner's monotone merge."""
        if self.combiner == "min":
            return torch.minimum(old, acc)
        if self.combiner == "max":
            return torch.maximum(old, acc)
        raise NotImplementedError(
            f"{self.name}: sum-combiner programs must override apply()")

    def scatter(self, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        """Next iteration's frontier (the changed bitmap)."""
        return new != old

    def finalize_host(self, graph: Graph, values: np.ndarray) -> dict:
        return {}

    def edge_invariant(self, src_vals, dst_vals, weights):
        """Per-edge fixpoint invariant for ``check`` (True = ok)."""
        raise NotImplementedError


class GasState(NamedTuple):
    values: torch.Tensor     # (nv,) or (nv, K) storage: int32 words or f32
    frontier: torch.Tensor   # bool, same shape
    direction: int           # direction the PREVIOUS iteration took
    #                          (0 pull, 1 push): the hysteresis memory


# -- adapters -----------------------------------------------------------------


class PushGasAdapter(GasProgram):
    """A PushProgram as a GasProgram: ``relax`` becomes ``gather`` and
    ``relax_op`` its ``gather_op``; the min/max merge and the changed
    bitmap are the defaults."""

    def __init__(self, inner: PushProgram):
        self.inner = inner
        self.name = inner.name
        self.combiner = inner.combiner
        self.value_dtype = inner.value_dtype
        self.needs_weights = inner.needs_weights
        self.rooted = getattr(inner, "rooted", False)
        self.frontier_ok = getattr(inner, "frontier_ok", True)
        self.incremental_ok = getattr(inner, "incremental_ok", False)
        self.gather_op = inner.relax_op

    def init_values(self, graph: Graph, **kw) -> np.ndarray:
        return self.inner.init_values(graph, **kw)

    def init_frontier(self, graph: Graph, **kw) -> np.ndarray:
        return self.inner.init_frontier(graph, **kw)

    def gather(self, src_vals, weights):
        return self.inner.relax(src_vals, weights)

    def edge_invariant(self, src_vals, dst_vals, weights):
        return self.inner.edge_invariant(src_vals, dst_vals, weights)


class PullGasAdapter(GasProgram):
    """A PullProgram as a frontier-less GasProgram: dense pull only, a
    fixed iteration count, run by the PullProgram's own hooks."""

    frontier = False
    frontier_ok = False

    def __init__(self, inner: PullProgram):
        self.inner = inner
        self.name = inner.name
        self.combiner = inner.combiner
        self.value_dtype = inner.value_dtype
        self.needs_weights = inner.needs_weights

    def init_values(self, graph: Graph, **kw) -> np.ndarray:
        return self.inner.init_values(graph)

    def init_frontier(self, graph: Graph, **kw) -> np.ndarray:
        return np.ones(graph.nv, dtype=bool)

    def edge_contrib(self, edge: EdgeCtx) -> torch.Tensor:
        return self.inner.edge_contrib(edge)

    def apply_ctx(self, old, acc, ctx: VertexCtx):
        return self.inner.apply(old, acc, ctx)


def as_gas(program) -> GasProgram:
    """Normalize any registered program model to a GasProgram."""
    if isinstance(program, GasProgram):
        return program
    if isinstance(program, PushProgram):
        return PushGasAdapter(program)
    if isinstance(program, PullProgram):
        return PullGasAdapter(program)
    raise TypeError(f"cannot adapt {type(program).__name__} to a GasProgram")


def check_gas_kernel_covers(program: GasProgram) -> None:
    """Raise ``NotImplementedError`` unless the CUDA GAS kernels compute
    ``program``'s accumulator: a (combiner, ``gather_op``) pair they are
    compiled for, on the op's value type, a ``gather`` defined where
    ``gather_op`` is (for an adapted PushProgram: ``relax`` where
    ``relax_op`` is), and no ``gather_push``."""
    if program.gather_push is not None:
        raise NotImplementedError(
            f"{program.name}: a gather_push runs only on the CPU; the CUDA "
            "kernels gather with gather_op in both directions")
    gas_kernel_code(program.combiner, program.gather_op)
    want = gas_storage_dtype(program.gather_op)
    if (want == torch.int32) != is_u32(program.value_dtype):
        raise NotImplementedError(
            f"{program.name}: gather_op {program.gather_op!r} runs on "
            f"{'uint32' if want == torch.int32 else 'float32'} values, not "
            f"{program.value_dtype}")
    if isinstance(program, PushGasAdapter):
        target, op, fn = program.inner, "relax_op", "relax"
    else:
        target, op, fn = program, "gather_op", "gather"
    if _owner(target, op) is not _owner(target, fn):
        raise NotImplementedError(
            f"{program.name}: {fn} is defined apart from {op} "
            f"{program.gather_op!r}, so the kernel may compute another "
            f"function; set {op} where {fn} is defined")


def _resolve_mode(mode: Optional[str]) -> str:
    mode = mode if mode is not None else flags.get("LUX_GAS")
    if mode not in GAS_MODES:
        raise ValueError(f"LUX_GAS={mode!r}: use one of {'|'.join(GAS_MODES)}")
    return mode


def count_switches(directions) -> int:
    """Direction changes along a run (the first iteration is none)."""
    return sum(1 for a, b in zip(directions, directions[1:]) if a != b)


class _GasBase:
    """Storage and hook plumbing shared by the two GAS executors."""

    graph: Graph
    program: GasProgram
    device: torch.device

    def _setup(self, graph: Graph, program: GasProgram, device) -> bool:
        """Common construction; returns True on the card."""
        if program.needs_weights and graph.weights is None:
            raise ValueError(f"{program.name} requires an edge-weighted graph")
        self.graph = graph
        self.program = program
        self.device = resolve_device(device)
        self._u32 = is_u32(program.value_dtype)
        return self.device.type != "cpu"

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _storage(self, a) -> torch.Tensor:
        if self._u32:
            return to_u32_storage(a, self.device)
        return self._put(np.asarray(a, dtype=np.float32))

    def _to_numpy(self, t: torch.Tensor) -> np.ndarray:
        return u32_to_numpy(t) if self._u32 else t.detach().cpu().numpy()

    def _update(self, values: torch.Tensor, acc: torch.Tensor):
        """(new values, new frontier) from the accumulator."""
        prog = self.program
        old, _ = gas_widen(values)
        new = prog.apply(old, gas_widen(acc)[0])
        return gas_narrow(new, values), prog.scatter(old, new)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# -- the adaptive executor ------------------------------------------------------


class AdaptiveExecutor(_GasBase):
    """Single-device GAS executor with per-iteration direction choice
    (``cuda`` unless ``device`` names another).

    Adaptive hysteresis (density = frontier / nv): density >=
    ``LUX_GAS_DENSITY_HI`` forces pull, density <= ``LUX_GAS_DENSITY_LO``
    forces push, in between the previous direction sticks. A push whose
    frontier does not fit ``lux_tpu``'s static queue and edge budgets
    falls back to pull, in every mode but ``pull``, so the recorded
    directions are the ones ``lux_tpu`` takes. ``direction_log`` holds,
    per iteration of the last run, (direction, frontier count, frontier
    out-edges) before the step.
    """

    def __init__(
        self,
        graph: Graph,
        program: GasProgram,
        device=None,
        mode: Optional[str] = None,
    ):
        on_card = self._setup(graph, program, device)
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
        if not program.frontier:
            inner = getattr(program, "inner", None)
            if not isinstance(inner, PullProgram):
                raise TypeError(
                    f"{program.name}: a frontier-less GAS program runs "
                    "through PullGasAdapter (as_gas of a PullProgram)")
            # The dense pull step (K8/K9 on the card; the card refuses
            # what PullExecutor refuses). lux_tpu's GAS pull is flat.
            self._pull = PullExecutor(graph, inner, device=self.device,
                                      edge_chunk=0)
        else:
            if on_card:
                check_gas_kernel_covers(program)
            self.row_ptr = self._put(graph.row_ptr.astype(np.int64))
            self.col_src = self._put(graph.col_src.astype(np.int32))
            self.weights = (None if graph.weights is None
                            else self._put(graph.weights))
            self.tasks = (RowTasks.build(graph.row_ptr, self.device)
                          if on_card else None)
            if self.mode != "pull":
                # Budgets sized so every frontier the policy can route to
                # push fits (the stay-push band tops out at hi_count).
                q_cap, self.edge_budget = _sparse_budgets(
                    nv, graph.ne, QUEUE_FRAC, EDGE_BUDGET_FRAC)
                self.queue_cap = max(q_cap, self.hi_count + 128)
                csr = graph.csr()
                self.csr_row_ptr = self._put(csr.row_ptr.astype(np.int64))
                self.csr_col_dst = self._put(csr.col_dst.astype(np.int32))
                self.csr_weights = (None if csr.weights is None
                                    else self._put(csr.weights))
                self.out_degrees = self._put(
                    graph.out_degrees.astype(np.int64))
        # Filled by run(): the per-run direction ledger.
        self.push_iters = 0
        self.pull_iters = 0
        self.direction_switches = 0
        self.direction_log: List[Tuple[int, int, int]] = []

    # -- the two directions ----------------------------------------------

    def _pull_acc(self, state: GasState) -> torch.Tensor:
        prog = self.program
        return gas_pull_acc(
            self.row_ptr, self.col_src, state.values, state.frontier,
            prog.combiner, prog.gather_op, self.tasks, gather=prog.gather,
            weights=self.weights)

    def _queue(self, state: GasState, cnt: int):
        return frontier_queue(state.frontier, self.csr_row_ptr, cnt)

    def _push_acc(self, state: GasState, queue, out_edges: int):
        prog = self.program
        q, start, _, offs = queue
        return gas_push_acc(
            q, start, offs, self.csr_col_dst, state.values, prog.combiner,
            prog.gather_op, out_edges,
            gather=prog.gather_push or prog.gather,
            weights=self.csr_weights)

    def _decide_push(self, stats, prev_direction: int) -> bool:
        """``lux_tpu``'s direction decision for the frontier about to
        expand, whose (count, out-edges) are ``stats``: pinned modes are
        constants, adaptive is the density hysteresis, and any push must
        fit the queue and edge budgets."""
        if self.mode == "pull":
            return False
        cnt, out_edges = stats
        if self.mode == "push":
            want = True
        elif cnt >= self.hi_count:
            want = False
        elif cnt <= self.lo_count:
            want = True
        else:
            want = prev_direction > 0
        return want and cnt <= self.queue_cap and out_edges <= self.edge_budget

    # -- update and the host read ----------------------------------------

    def _stats_tensor(self, frontier: torch.Tensor) -> torch.Tensor:
        """The frontier's (count, out-edge total) as one int64 tensor
        (count only when the executor never pushes)."""
        cnt = frontier.sum()
        if self.mode == "pull":
            return cnt.reshape(1)
        return torch.stack([cnt, torch.where(frontier, self.out_degrees,
                                             0).sum()])

    @staticmethod
    def _read(stats: torch.Tensor) -> Tuple[int, int]:
        """The one device-to-host read of an iteration."""
        got = stats.tolist()
        return got[0], got[1] if len(got) > 1 else 0

    def _frontier_stats(self, state: GasState) -> Tuple[int, int]:
        if not self.program.frontier:
            return self.graph.nv, 0    # never halts early: run() bounds it
        return self._read(self._stats_tensor(state.frontier))

    def _iterate(self, state: GasState, stats):
        """One iteration from ``state``, whose frontier has ``stats``;
        returns (new state, its stats, direction taken)."""
        if not self.program.frontier:
            # Frontier and direction pass through unchanged.
            new = self._pull.step(state.values)
            return state._replace(values=new), (self.graph.nv, 0), 0
        push = self._decide_push(stats, state.direction)
        if push:
            acc = self._push_acc(state, self._queue(state, stats[0]),
                                 stats[1])
        else:
            acc = self._pull_acc(state)
        new, frontier = self._update(state.values, acc)
        return (GasState(new, frontier, int(push)),
                self._read(self._stats_tensor(frontier)), int(push))

    # -- driving ----------------------------------------------------------

    def init_state(self, **kw) -> GasState:
        prog = self.program
        if not prog.frontier:
            vals = self._pull.init_values()
        else:
            vals = self._storage(prog.init_values(self.graph, **kw))
        fr = np.asarray(prog.init_frontier(self.graph, **kw), dtype=bool)
        return GasState(vals, torch.from_numpy(fr.copy()).to(self.device), 0)

    def values(self, state: GasState) -> np.ndarray:
        """Host copy of the values: numpy uint32, or f32."""
        return self._to_numpy(state.values)

    def step(self, state: GasState):
        """One iteration; returns (new state, new frontier count)."""
        new_state, stats, _ = self._iterate(state,
                                            self._frontier_stats(state))
        return new_state, stats[0]

    def _run(self, state: GasState, max_iters: Optional[int], chunk: int,
             rec=NULL_RECORDER):
        """Iterate until a step leaves an empty frontier or ``max_iters``
        steps ran; returns (state, iterations, direction log). A start
        with an empty frontier still runs one iteration, as in
        ``lux_tpu``. ``rec`` gets one flush per chunk, as there."""
        log: List[Tuple[int, int, int]] = []
        if chunk <= 0:
            return state, 0, log
        window = FlushWindow(rec, chunk, "directions")
        stats = self._frontier_stats(state)
        while max_iters is None or len(log) < max_iters:
            prev = stats
            state, stats, direction = self._iterate(state, stats)
            log.append((direction,) + prev)
            window.step(len(log), stats[0], direction)
            if stats[0] == 0:
                break
        window.close(len(log))
        return state, len(log), log

    def run(self, max_iters: Optional[int] = None,
            state: Optional[GasState] = None, chunk: int = 16,
            recorder=None, **init_kw):
        """Iterate to fixpoint (or ``max_iters``); returns (final_state,
        iterations_run). The directions land in ``push_iters``,
        ``pull_iters``, ``direction_switches`` and ``direction_log``."""
        if not self.program.frontier and max_iters is None:
            raise ValueError(
                f"{self.program.name} is a frontier-less pull program; "
                "run() needs max_iters")
        if state is None:
            state = self.init_state(**init_kw)
        rec = open_run(self, "gas", recorder, lambda: (
            engobs.hbm_bytes_per_iter(self.graph.nv, self.graph.ne)))
        state, total, self.direction_log = self._run(state, max_iters, chunk,
                                                     rec)
        dirs = [d for d, _, _ in self.direction_log]
        self.push_iters = sum(dirs)
        self.pull_iters = total - self.push_iters
        self.direction_switches = count_switches(dirs)
        engobs.note(
            "gas", program=self.program.name, mode=self.mode,
            num_iters=total, direction_push=self.push_iters,
            direction_pull=self.pull_iters,
            direction_switches=self.direction_switches)
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
        return self.program.finalize_host(self.graph, self.values(state))

    def phase_step(self, state: GasState):
        """One frontier iteration as separately timed phases (CUDA events
        on the card). Push: queue = K6, acc = K11; pull: acc = K10;
        update = apply, scatter and the new frontier's counters. Returns
        (new state, active count, times with the direction)."""
        dev = self.device
        stats = self._frontier_stats(state)
        push = self._decide_push(stats, state.direction)
        times = {}
        if push:
            queue, times["queueTime"] = timed(
                lambda: self._queue(state, stats[0]), dev)
            acc, times["accTime"] = timed(
                lambda: self._push_acc(state, queue, stats[1]), dev)
        else:
            acc, times["accTime"] = timed(lambda: self._pull_acc(state), dev)

        def finish():
            new, frontier = self._update(state.values, acc)
            return new, frontier, self._read(self._stats_tensor(frontier))

        (new, frontier, st), times["updateTime"] = timed(finish, dev)
        times["direction"] = "push" if push else "pull"
        return GasState(new, frontier, int(push)), st[0], times

    def warmup_phases(self, state: GasState):
        """Run every phase of both directions once outside any timed
        region. ``state`` is only read."""
        if not self.program.frontier:
            self._pull.step(state.values)
        else:
            stats = self._frontier_stats(state)
            self._update(state.values, self._pull_acc(state))
            if self.mode != "pull":
                self._update(state.values, self._push_acc(
                    state, self._queue(state, stats[0]), stats[1]))
        self._sync()


class MultiSourceGasExecutor(_GasBase):
    """Dense GAS executor over K value columns: one pull sweep (K10 with
    K columns) serves K root queries of a rooted frontier program. Each
    lane is bitwise equal to a single-source :class:`AdaptiveExecutor`
    run, since every direction builds the same accumulator."""

    def __init__(self, graph: Graph, program: GasProgram, k: int,
                 device=None):
        if k < 1:
            raise ValueError(f"batch width k must be >= 1 (got {k})")
        program = as_gas(program)
        if not program.frontier:
            raise ValueError(
                f"{program.name} is frontier-less; multi-source batching "
                "needs a rooted frontier program")
        on_card = self._setup(graph, program, device)
        if on_card:
            check_gas_kernel_covers(program)
        self.k = int(k)
        self.row_ptr = self._put(graph.row_ptr.astype(np.int64))
        self.col_src = self._put(graph.col_src.astype(np.int32))
        self.weights = (None if graph.weights is None
                        else self._put(graph.weights))
        self.tasks = (RowTasks.build(graph.row_ptr, self.device)
                      if on_card else None)
        self.push_iters = 0          # pull-only: always 0
        self.pull_iters = 0
        self.direction_switches = 0

    def init_state(self, starts) -> GasState:
        """One value/frontier column per root; fewer than k roots are
        right-padded by repeating the last root."""
        starts = list(starts)
        if not 1 <= len(starts) <= self.k:
            raise ValueError(f"need 1..{self.k} roots, got {len(starts)}")
        starts = starts + [starts[-1]] * (self.k - len(starts))
        prog = self.program
        vals = np.stack(
            [prog.init_values(self.graph, start=s) for s in starts], axis=1)
        fr = np.stack(
            [prog.init_frontier(self.graph, start=s) for s in starts], axis=1)
        return GasState(self._storage(vals),
                        torch.from_numpy(fr.astype(bool)).to(self.device), 0)

    def step(self, state: GasState):
        """One iteration; returns (new state, new frontier count over all
        lanes)."""
        prog = self.program
        acc = gas_pull_acc(
            self.row_ptr, self.col_src, state.values, state.frontier,
            prog.combiner, prog.gather_op, self.tasks, gather=prog.gather,
            weights=self.weights)
        new, frontier = self._update(state.values, acc)
        return GasState(new, frontier, 0), int(frontier.sum())

    def run(self, starts, max_iters: Optional[int] = None, chunk: int = 16,
            recorder=None, state: Optional[GasState] = None):
        """Run all roots to their shared fixpoint; column j of
        ``state.values`` is root ``starts[j]``'s result."""
        if state is None:
            state = self.init_state(starts)
        rec = open_run(self, "gas_multi", recorder, lambda: (
            engobs.hbm_bytes_per_iter(self.graph.nv, self.graph.ne,
                                      k=self.k)))
        state, total = self._run(state, max_iters, chunk, rec)
        self.pull_iters = total
        engobs.note("gas_multi", program=self.program.name, mode="pull",
                    num_iters=total, lanes=self.k)
        rec.finish()
        return state, total

    def _run(self, state: GasState, max_iters: Optional[int], chunk: int,
             rec=NULL_RECORDER):
        total = 0
        if chunk > 0:
            window = FlushWindow(rec, chunk, "directions")
            while max_iters is None or total < max_iters:
                state, cnt = self.step(state)
                total += 1
                window.step(total, cnt, 0)
                if cnt == 0:
                    break
            window.close(total)
        return state, total

    def warmup(self, chunk: int = 16, start: int = 0):
        """One iteration of the multi-source fixpoint from
        ``init_state([start])`` (builds the kernels) so timed runs exclude
        set-up, as ``lux_tpu``'s ``warmup``; no iteration when ``chunk``
        is 0, as in ``run``. It leaves no state behind: ``pull_iters``
        stays as the last ``run`` left it; its seconds are the next
        run's compile time."""
        timed_warmup(self, lambda: self._run(self.init_state([start]), 1,
                                             chunk))

    def values_for(self, state: GasState, j: int) -> np.ndarray:
        """Host copy of lane ``j``'s value column."""
        return self._to_numpy(state.values[:, j].contiguous())

    def finalize_for(self, state: GasState, j: int) -> dict:
        return self.program.finalize_host(self.graph,
                                          self.values_for(state, j))
