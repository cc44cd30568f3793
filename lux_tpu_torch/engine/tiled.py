"""Hybrid pull executor: int8 strips + a lane-select tail, on the GPU.

The counterpart of ``lux_tpu/engine/tiled.py``. It runs pull programs
whose edge contribution is the source value itself
(``program.identity_contrib``) with a ``sum`` combiner — SpMV-shaped
iterations like PageRank (the reference stores rank pre-divided by
out-degree precisely so its gather side is an identity sum,
pagerank/pagerank_gpu.cu:90-99).

Internally the executor runs in degree-sorted vertex order (the plan's
"internal" space) and converts at the public API boundary, so callers
see external vertex ids. See :mod:`lux_tpu_torch.ops.tiled_spmv` for the
layout and kernels.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from lux_tpu_torch.engine.program import PullProgram, VertexCtx
from lux_tpu_torch.engine.telemetry import (
    NULL_RECORDER,
    open_run,
    run_steps,
    timed_warmup,
)
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.obs import engobs, metrics
from lux_tpu_torch.ops.merge_tail_kernel import (
    DeviceGroupedTail,
    grouped_tail_enabled,
    level_apply,
    root_reduce,
)
from lux_tpu_torch.ops.merge_tail_plan import plan_grouped_tail
from lux_tpu_torch.ops.tiled_spmv import (
    DeviceHybrid,
    HybridPlan,
    hybrid_spmv,
    load_plan,
    plan_hybrid,
    resolve_pack,
    save_plan,
    strips_sum,
    tail_sum,
    vals_to_x2d,
)
from lux_tpu_torch.utils.platform import resolve_device
from lux_tpu_torch.utils.timing import timed as _timed


def spmv_capable(program: PullProgram) -> bool:
    """True if the strip/lane-select hybrid can run this program
    (sum combiner, edge contribution == source value)."""
    return (
        program.combiner == "sum"
        and getattr(program, "identity_contrib", False)
        and not getattr(program, "value_shape", ())  # scalar values only
    )


def get_cached_plan(
    graph: Graph,
    path: str,
    levels: Sequence[Tuple[int, int]] = ((8, 2),),
    budget_bytes: int = 8 << 30,
    log=None,
    cap: int = 15,
    pack: Optional[bool] = None,
) -> HybridPlan:
    """Load the hybrid plan cached at ``path`` (validating it against the
    graph), else plan and save. Planning is graph-deterministic and costs
    minutes of host time at large scale, so entry points should come
    through here. A failed save (read-only graph dir) degrades to
    planning without a cache. ``pack`` is the caller's nibble-packing
    intent (None = the LUX_PACK_STRIPS env default). Caches are
    interchangeable with the JAX package's."""
    say = log if log is not None else (lambda *_: None)
    load_path = path
    if not os.path.exists(path) and path.endswith(".luxplan"):
        # Round-1 caches used a single .npz at the same key; serve them
        # rather than replanning (load_plan keeps the legacy reader). A
        # replan still saves to the .luxplan path, not the legacy name.
        legacy = path[: -len(".luxplan")] + ".npz"
        if os.path.exists(legacy):
            say(f"serving legacy plan cache {legacy}")
            load_path = legacy
    if os.path.exists(load_path):
        plan = None
        try:
            plan = load_plan(load_path)
        except Exception as e:
            say(f"cached plan {load_path} unreadable ({e!r}) — replanning")
        if plan is not None and (
            plan.nv != graph.nv or plan.total_edges != graph.ne
        ):
            say(
                f"cached plan {load_path} does not match graph "
                f"(nv {plan.nv} vs {graph.nv}, edges {plan.total_edges} "
                f"vs {graph.ne}) — replanning"
            )
            plan = None
        want_rs = tuple(r for r, _ in levels)
        if plan is not None and tuple(l.r for l in plan.levels) != want_rs:
            say(
                f"cached plan {load_path} has cascade r-levels "
                f"{tuple(l.r for l in plan.levels)}, requested {want_rs} "
                "— replanning"
            )
            plan = None
        want_spec = tuple((int(r), int(t)) for r, t in levels)
        if (
            plan is not None
            and plan.levels_spec is not None
            and (
                plan.levels_spec != want_spec
                or plan.budget_bytes != int(budget_bytes)
            )
        ):
            say(
                f"cached plan {load_path} was planned with "
                f"levels={plan.levels_spec} budget={plan.budget_bytes}, "
                f"requested levels={want_spec} budget={int(budget_bytes)} "
                "— replanning"
            )
            plan = None
        # A looser count cap only matters when nibble packing is used.
        if plan is not None and plan.cap > cap and resolve_pack(pack, cap):
            say(
                f"cached plan {load_path} has count cap {plan.cap}, "
                f"requested <= {cap} (nibble packing needs <= 15) "
                "— replanning"
            )
            plan = None
        if plan is not None:
            return plan
    plan = plan_hybrid(graph, levels=levels, budget_bytes=budget_bytes, cap=cap)
    try:
        save_plan(path, plan)
    except OSError as e:
        say(f"could not cache plan at {path}: {e}")
    return plan


def require_spmv_program(program: PullProgram, cls: str, fallback: str):
    """Tiled executors only run sum-combiner programs whose edge
    contribution is the source value (SpMV shape)."""
    if program.combiner != "sum" or not getattr(
        program, "identity_contrib", False
    ):
        raise ValueError(
            f"{cls} requires a sum-combiner program whose "
            f"edge contribution is the source value; {program.name} "
            f"is not (use {fallback})"
        )


class TiledPullExecutor:
    """Executes an identity-contribution sum-combiner pull program via the
    strip/lane-select hybrid SpMV on a single device (``cuda`` unless
    ``device`` names another)."""

    def __init__(
        self,
        graph: Graph,
        program: PullProgram,
        levels: Sequence[Tuple[int, int]] = ((8, 2),),
        budget_bytes: int = 8 << 30,
        plan: Optional[HybridPlan] = None,
        device=None,
        pack: Optional[bool] = None,
    ):
        require_spmv_program(program, "TiledPullExecutor", "PullExecutor")
        self.graph = graph
        self.program = program
        self.device = resolve_device(device)
        self.plan = plan if plan is not None else plan_hybrid(
            graph, levels=levels, budget_bytes=budget_bytes
        )
        p = self.plan
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        self.dhybrid = DeviceHybrid.build(p, self.device, pack=pack)
        self.gtail = None
        self.gtail_stats = None
        if grouped_tail_enabled():
            gplan = plan_grouped_tail(p.tail_sb, p.tail_lane, p.tail_row_ptr)
            self.gtail = DeviceGroupedTail.build(gplan, self.device)
            self.gtail_stats = gplan.stats
            metrics.gauge("lux_grouped_tail_inflation").set(
                gplan.stats["mean_inflation"])
            metrics.counter("lux_grouped_tail_copy_rows").inc(
                gplan.stats["copy_rows"])
            metrics.counter("lux_grouped_tail_merge_rows").inc(
                gplan.stats["merge_rows"])
        self.out_degrees = put(p.out_degrees.astype(np.int32))
        self.in_degrees = put(p.in_degrees.astype(np.int32))
        self.order = put(p.order.astype(np.int64))  # external id at internal pos
        self.rank = put(p.rank.astype(np.int64))    # internal pos of external id
        self._ctx = VertexCtx(
            nv=graph.nv, out_degrees=self.out_degrees,
            in_degrees=self.in_degrees,
        )

    # -- one iteration (internal vertex order) ---------------------------

    def _step(self, vals: torch.Tensor) -> torch.Tensor:
        acc = hybrid_spmv(vals, self.dhybrid, self.gtail)
        return self.program.apply(vals, acc, self._ctx)

    # -- driver ----------------------------------------------------------
    # Every public entry point speaks EXTERNAL vertex ids; only the
    # private _step/_init_internal work in degree-sorted order.

    def _values(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(self.device)

    def _init_internal(self) -> torch.Tensor:
        ext = np.asarray(self.program.init_values(self.graph))
        return self._values(ext[self.plan.order])

    def init_values(self) -> torch.Tensor:
        return self._values(self.program.init_values(self.graph))

    def step(self, vals) -> torch.Tensor:
        """One iteration, external order in and out (the boundary
        converts cost two nv-row gathers — use run() for loops)."""
        internal = self._values(vals)[self.order]
        return self._step(internal)[self.rank]

    def phase_step(self, vals):
        """One iteration dispatched as separately timed phases. Returns
        (new external vals, {phase: seconds}); phases are timed with
        CUDA events on the card.

        Either tail adds into the strips' sums, so ``strips`` and
        ``tail`` time K1 and the tail apart and ``apply`` is the
        program's update alone. With the grouped tail active, ``x2d``
        times the padded operand it reads, and the tail phase runs one
        network level at a time: ``times["tail_level<k>"]`` per level
        (level 0 is the x2d gather level), ``times["tail_root"]`` for the
        masked per-destination reduction (K4, adding into the strips'
        sums), and ``times["tail"]`` the total; each level's seconds also
        go to the ``lux_grouped_tail_level_seconds`` histogram of its
        level."""
        dev = self.device
        nv = self.graph.nv
        dh = self.dhybrid
        times = {}
        internal = self._values(vals)[self.order]
        if self.gtail is None:
            acc, times["strips"] = _timed(
                lambda: strips_sum(internal, dh, nv), dev)
            acc, times["tail"] = _timed(
                lambda: tail_sum(internal, dh, out=acc), dev)
            new, times["apply"] = _timed(
                lambda: self.program.apply(internal, acc, self._ctx), dev)
            return new[self.rank], times
        x2d, times["x2d"] = _timed(lambda: vals_to_x2d(internal, dh), dev)
        acc_s, times["strips"] = _timed(lambda: strips_sum(x2d, dh, nv), dev)
        gt = self.gtail
        x, total = x2d, 0.0
        for k in range(gt.n_levels + 1):
            x, t = _timed(lambda: level_apply(
                x, gt.arow[k], gt.brow[k], gt.codes[k]), dev)
            times[f"tail_level{k}"] = t
            metrics.histogram("lux_grouped_tail_level_seconds",
                              {"level": str(k)}).observe(t)
            total += t
        acc, t = _timed(lambda: root_reduce(
            x, gt.nvalid_root, gt.dst_row_ptr, out=acc_s), dev)
        times["tail_root"] = t
        times["tail"] = total + t
        new, times["apply"] = _timed(
            lambda: self.program.apply(internal, acc, self._ctx), dev)
        return new[self.rank], times

    def warmup(self):
        """One throwaway iteration through every path run() takes; its
        seconds are the next run's compile time."""
        timed_warmup(self, lambda: self.run(1, vals=self.init_values(),
                                            recorder=NULL_RECORDER))

    def run(self, num_iters: int, vals=None, flush_every: int = 8,
            recorder=None) -> torch.Tensor:
        """``num_iters`` iterations; external order in and out. A plain
        loop of steps on device tensors; with telemetry on, one wait for
        the card every ``flush_every`` iterations (0: at the end) closes
        a recorder window."""
        if vals is None:
            internal = self._init_internal()
        else:
            internal = self._values(vals)[self.order]
        rec = open_run(self, "tiled", recorder, lambda: (
            engobs.hbm_bytes_per_iter(self.graph.nv, self.graph.ne)))
        internal = run_steps(self._step, internal, num_iters, flush_every,
                             rec, self.device)
        out = internal[self.rank]
        rec.finish()
        return out
