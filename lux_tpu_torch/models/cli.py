"""The applications' shared command line, the counterpart of
``lux_tpu/models/cli.py``.

Reproduces the reference CLI surface (README.md:41-54, parse_input_args in
each app's main): ``-file`` ``-ni`` ``-start`` ``-check`` ``-verbose``,
prints the memory advisory and ``ELAPSED TIME`` the same way
(pagerank/pagerank.cc:60-118). ``-parts N`` (aliases ``-ng`` and
``-ll:gpu``) runs the sharded executors over N parts of one device;
``-ll:fsize``/``-ll:zsize`` are accepted and ignored. Beyond the
reference: the ``GTEPS`` line and ``-save``/``-resume`` checkpoints,
which load in either package.

The CLIs run on the card; ``LUX_PLATFORM=cpu`` runs them on the CPU with
the kernels' plain versions. Without a card, and without that setting,
they exit with a message.

Telemetry, as ``lux_tpu``'s: ``-metrics PATH`` and ``-trace PATH`` set
``LUX_METRICS`` and ``LUX_TRACE`` (the run's ``lux.run_telemetry.v1``
line with its compile/execute split and per-iteration records; a Chrome
trace_event stream), and ``-profile DIR`` captures the timed run with
``torch.profiler`` into DIR (read it with ``python -m
lux_tpu_torch.tools.prof_summary DIR``). The ``-verbose`` loops drive a
recorder of their own, flushed every iteration.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Tuple

import numpy as np
import torch

from lux_tpu_torch import obs
from lux_tpu_torch.engine.gas import GasProgram
from lux_tpu_torch.engine.push import PushState
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.native import io as native_io
from lux_tpu_torch.obs import prof
from lux_tpu_torch.ops.segment import to_u32_storage
from lux_tpu_torch.utils import checkpoint
from lux_tpu_torch.utils.logging import get_logger
from lux_tpu_torch.utils.platform import platform_device
from lux_tpu_torch.utils.timing import Timer, gteps


def build_parser(name: str, push: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=name, prefix_chars="-")
    p.add_argument("-file", required=True, help="input .lux graph")
    if push:
        p.add_argument(
            "-ni", type=int, default=0,
            help="max iterations (0 = run to fixpoint)",
        )
    else:
        p.add_argument("-ni", type=int, required=True, help="iterations")
    p.add_argument("-start", type=int, default=0, help="SSSP root vertex")
    p.add_argument("-check", action="store_true")
    p.add_argument("-verbose", action="store_true")
    p.add_argument(
        "-parts", "-ng", "-ll:gpu", type=int, default=1, dest="parts",
        help="parts to shard over, all on one device (1 = unsharded); "
        "-ng and -ll:gpu are the reference's aliases for its GPU count "
        "(pagerank.cc:127, README.md:47)",
    )
    # Accepted for drop-in compatibility with the reference's documented
    # invocations (README.md:43-49); Legion memory sizing has no
    # counterpart here — the advisory prints what is needed.
    p.add_argument("-ll:fsize", type=int, dest="ll_fsize",
                   help=argparse.SUPPRESS)
    p.add_argument("-ll:zsize", type=int, dest="ll_zsize",
                   help=argparse.SUPPRESS)
    p.add_argument(
        "-strategy", choices=["rowptr", "segment"], default="rowptr",
        help="sum-combiner reduction strategy (flat pull apps)",
    )
    p.add_argument(
        "-layout", choices=["auto", "flat", "tiled"], default="auto",
        help="pull engine: 'tiled' = strip/lane-select hybrid (the fast "
        "path for SpMV-shaped programs like PageRank), 'flat' = plain "
        "gather engine, 'auto' = tiled when the program supports it",
    )
    p.add_argument(
        "-levels", default="8/2",
        help="tiled layout strip cascade, e.g. '8/2' or '32/8,8/3,2/2'",
    )
    p.add_argument(
        "-tile-mb", type=int, default=8192, dest="tile_mb",
        help="tiled layout strip memory budget (MB)",
    )
    p.add_argument(
        "-plan-cache", dest="plan_cache",
        help="hybrid plan cache path (default: next to the graph file)",
    )
    p.add_argument("-save", help="write checkpoint npz after the run")
    p.add_argument("-resume", help="resume vertex state from checkpoint npz")
    p.add_argument("-profile", help="capture a device-timeline trace of "
                   "the run to DIR (obs/prof.py; parse with python -m "
                   "lux_tpu_torch.tools.prof_summary DIR)")
    p.add_argument(
        "-metrics", "--metrics", dest="metrics",
        help="append the run's telemetry (per-iteration records, "
        "compile/execute split) as one JSON line to PATH "
        "(equivalent to LUX_METRICS=PATH)",
    )
    p.add_argument(
        "-trace", "--trace", dest="trace",
        help="stream Chrome trace_event JSON-lines to PATH "
        "(equivalent to LUX_TRACE=PATH)",
    )
    return p


def setup_telemetry(args) -> None:
    """Map -metrics/-trace onto the LUX_* env vars the obs package is
    gated by, then re-read them."""
    if getattr(args, "metrics", None):
        os.environ["LUX_METRICS"] = args.metrics
    if getattr(args, "trace", None):
        os.environ["LUX_TRACE"] = args.trace
    obs.reconfigure()


def parse_args(program, argv, push: bool):
    """The parsed flags, with the telemetry knobs they name set."""
    args = build_parser(program.name, push=push).parse_args(argv)
    setup_telemetry(args)
    return args


def load_graph(path: str, log) -> Tuple[Graph, torch.device]:
    """The device the run takes (exits without a card unless
    ``LUX_PLATFORM=cpu``) and the graph read from ``path``."""
    dev = platform_device()
    if dev.type == "cuda":
        log.info("torch device: %s (%s)", dev,
                 torch.cuda.get_device_name(dev))
    else:
        log.info("torch device: %s", dev)
    with Timer() as t:
        g = native_io.read_lux(path)
    log.info("loaded %s: nv=%d ne=%d (%.2fs)", path, g.nv, g.ne, t.elapsed)
    return g, dev


def memory_advisory(g, parts: int, value_bytes: int):
    """The reference prints minimum FB/ZC sizes per GPU/node
    (pagerank.cc:60-85, sssp.cc:59-90); here: estimated device memory per
    part."""
    edge_bytes = 8 + (4 if g.weights is not None else 0)  # src idx + seg/ptr
    per_dev = (
        g.ne // max(parts, 1) * edge_bytes
        + g.nv // max(parts, 1) * (value_bytes * 2 + 8)
        + (g.nv * value_bytes * parts if parts > 1 else 0)  # gathered ghosts
    )
    print(
        f"memory advisory: ~{per_dev / 1e6:.0f} MB HBM per device "
        f"({parts} part{'s' if parts != 1 else ''})"
    )


def _parse_levels(spec: str):
    try:
        levels = tuple(
            tuple(int(v) for v in part.split("/"))
            for part in spec.split(",")
        )
        if not all(len(lv) == 2 for lv in levels):
            raise ValueError
        return levels
    except ValueError:
        raise SystemExit(
            f"error: -levels {spec!r} is malformed; expected "
            "'r/thr[,r/thr...]', e.g. '8/2' or '32/8,8/3,2/2'"
        )


def plan_cache_path(args, levels) -> str:
    """Where a tiled run caches its plan: ``-plan-cache``, else next to
    the graph file, keyed by cascade and budget (``lux_tpu``'s key, so
    the two packages share caches)."""
    return args.plan_cache or (
        args.file
        + ".plan_"
        + "_".join(f"{r}x{t}" for r, t in levels)
        + f"_{args.tile_mb}.luxplan"
    )


def _tiled_plan(g, program, args, log):
    """Resolve the hybrid plan for a tiled run (cached next to the graph
    file, keyed by cascade + budget so different configs coexist)."""
    from lux_tpu_torch.engine.tiled import get_cached_plan

    levels = _parse_levels(args.levels)
    with Timer() as t:
        plan = get_cached_plan(
            g, plan_cache_path(args, levels), levels=levels,
            budget_bytes=args.tile_mb << 20, log=log.info
        )
    log.info(
        "hybrid plan: %d strips (%.2f GB), coverage=%.1f%% (%.1fs)",
        plan.num_strips, plan.strip_bytes / 1e9, plan.coverage * 100,
        t.elapsed,
    )
    return plan


def make_executor(g, program, args, dev, log):
    """Pick the engine, on ``dev``. Pull programs default to the tiled
    (strip/lane-select hybrid) executor when the program is SpMV-shaped;
    ``-layout flat`` forces the plain gather engine. ``-parts N > 1``
    takes the sharded executor over N parts of one device."""
    if isinstance(program, GasProgram):
        # The adaptive executor owns its direction choice (LUX_GAS pins
        # it); layout/parts knobs belong to the other engines.
        if args.parts > 1:
            raise SystemExit(
                f"error: {program.name} (a GAS app) is single-device for "
                "now; drop -parts"
            )
        if args.layout != "auto":
            raise SystemExit(
                f"error: -layout {args.layout} has no effect on "
                f"{program.name} (a GAS app); use LUX_GAS=pull|push|adaptive"
            )
        from lux_tpu_torch.engine.gas import AdaptiveExecutor

        return AdaptiveExecutor(g, program, device=dev)
    is_push = hasattr(program, "init_frontier")
    use_tiled = False
    if is_push and args.layout != "auto":
        raise SystemExit(
            f"error: -layout {args.layout} has no effect on "
            f"{program.name} (a push-model app); drop the flag"
        )
    if not is_push:
        from lux_tpu_torch.engine.tiled import spmv_capable

        if args.layout == "tiled":
            if not spmv_capable(program):
                raise SystemExit(
                    f"-layout tiled: {program.name} is not SpMV-shaped "
                    "(needs sum combiner + identity contribution)"
                )
            use_tiled = True
        elif args.layout == "auto":
            use_tiled = spmv_capable(program)

    if args.parts > 1:
        from lux_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.parts, dev)
        if is_push:
            from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor

            return ShardedPushExecutor(g, program, mesh=mesh)
        if use_tiled:
            from lux_tpu_torch.engine.tiled_sharded import (
                ShardedTiledExecutor,
            )

            return ShardedTiledExecutor(
                g, program, mesh=mesh, plan=_tiled_plan(g, program, args, log)
            )
        from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor

        return ShardedPullExecutor(
            g, program, mesh=mesh, sum_strategy=args.strategy
        )
    if is_push:
        from lux_tpu_torch.engine.push import PushExecutor

        return PushExecutor(g, program, device=dev)
    if use_tiled:
        from lux_tpu_torch.engine.tiled import TiledPullExecutor

        return TiledPullExecutor(
            g, program, plan=_tiled_plan(g, program, args, log), device=dev
        )
    from lux_tpu_torch.engine.pull import PullExecutor

    return PullExecutor(g, program, sum_strategy=args.strategy, device=dev)


def final_values(ex, result) -> np.ndarray:
    """The run's values on the host with ``lux_tpu``'s dtypes: float32
    for pull programs, uint32 for push and GAS programs (float32 for
    DeltaSSSP), global vertex order for the sharded executors."""
    if hasattr(ex, "gather_values"):
        return ex.gather_values(result)
    if hasattr(ex, "values"):
        return ex.values(result)
    return result.cpu().numpy()


def print_gteps(g, iters: int, elapsed: float):
    if elapsed > 0 and iters > 0:
        print(
            f"GTEPS = {gteps(g.ne, iters, elapsed):.4f} "
            f"({iters} iters x {g.ne} edges / {elapsed:.4f}s)"
        )


def _phase_detail(ph: dict) -> str:
    return " ".join(f"{k} {v * 1e6:.0f}us" for k, v in ph.items()
                    if isinstance(v, float))


def run_pull_app(program, argv, oracle=None):
    """Runs PageRank or CF. ``oracle(graph, ni) -> values`` enables
    ``-check`` (the reference has no pull-side checker; we add one)."""
    log = get_logger(program.name)
    args = parse_args(program, argv, push=False)
    g, dev = load_graph(args.file, log)
    if program.needs_weights and g.weights is None:
        print(f"error: {program.name} needs a weighted graph", file=sys.stderr)
        return 1
    # The port stores K-vectors unpadded: K f32 words a vertex.
    width = int(np.prod(getattr(program, "value_shape", ()) or (1,)))
    memory_advisory(g, args.parts, 4 * width)
    ex = make_executor(g, program, args, dev, log)

    vals = ex.init_values()
    start_iter = 0
    if args.resume:
        host_vals, start_iter, _ = checkpoint.load(args.resume, g)
        vals = _host_to_device(ex, host_vals)
        log.info("resumed at iteration %d", start_iter)
    remaining = max(args.ni - start_iter, 0)

    # Kernel builds and first launches outside the timed region.
    ex.warmup()

    with prof.trace(args.profile):
        if args.verbose:
            vals, t = _run_pull_verbose(ex, g, program, vals, remaining,
                                        start_iter)
        else:
            with Timer(dev) as t:
                vals = ex.run(remaining, vals=vals)
    t.print_elapsed()
    print_gteps(g, remaining, t.elapsed)

    host_vals = final_values(ex, vals)
    if args.save:
        checkpoint.save(args.save, g, host_vals, args.ni)
        log.info("checkpoint written to %s", args.save)
    if args.check:
        if oracle is None:
            print("[SKIP] no checker for this app")
        else:
            want = oracle(g, args.ni)
            ok = np.allclose(host_vals, want, rtol=1e-3, atol=1e-7)
            print(
                "[PASS] Check task passed!"
                if ok
                else "[FAIL] Check task failed!"
            )
            if not ok:
                return 1
    return 0


def _run_pull_verbose(ex, g, program, vals, remaining, start_iter):
    """Per-iteration timing (the reference's -verbose per-part breakdown,
    sssp_gpu.cu:516-518): each iteration waits for the card. Executors
    with a phase_step split it into phases, each timed alone (so the sum
    runs slower than the plain step). The loop bypasses ``ex.run()``, so
    it drives a recorder of its own, flushed every iteration."""
    dev = ex.device
    has_phases = hasattr(ex, "phase_step")
    if has_phases and remaining:
        ex.phase_step(vals)   # the phases' first launches, untimed
    rec = obs.recorder_for(obs.engine_label(ex), g, program)
    rec.start()
    if rec.enabled:
        rec.record_compile(obs.consume_compile_seconds(ex))
    with Timer(dev) as t:
        for i in range(remaining):
            if has_phases:
                with Timer(dev) as ti:
                    vals, ph = ex.phase_step(vals)
                print(
                    f"iter {start_iter + i}: {_phase_detail(ph)} "
                    f"(total {ti.elapsed*1e3:.3f} ms)"
                )
            else:
                with Timer(dev) as ti:
                    vals = ex.step(vals)
                print(f"iter {start_iter + i}: {ti.elapsed*1e3:.3f} ms")
            rec.flush(i + 1)
    rec.finish()
    return vals, t


# -- host <-> device at the CLI boundary --------------------------------------


def _host_to_push_state(ex, host_vals, host_frontier) -> PushState:
    """A checkpoint's uint32 values and bool frontier as the executor's
    state: int32 words of the uint32 values, padded to (P, max_nv) for a
    sharded executor."""
    if hasattr(ex, "sg"):
        host_vals = ex.sg.to_padded(np.asarray(host_vals))
        host_frontier = ex.sg.to_padded(np.asarray(host_frontier))
    frontier = np.ascontiguousarray(host_frontier, dtype=bool)
    return PushState(to_u32_storage(host_vals, ex.device),
                     torch.from_numpy(frontier).to(ex.device))


def _push_frontier_host(ex, state) -> np.ndarray:
    fr = state.frontier.cpu().numpy()
    if hasattr(ex, "sg"):
        return ex.sg.from_padded(fr)
    return fr


def _host_to_device(ex, host_vals):
    if hasattr(ex, "host_to_device"):
        # Executors owning a padded or reordered device layout convert
        # themselves.
        return ex.host_to_device(host_vals)
    return torch.from_numpy(np.array(host_vals, dtype=np.float32)).to(
        ex.device)


def _run_push_verbose(ex, state, max_iters, start_iter, init_kw):
    """Per-iteration `-verbose` loop for push and GAS apps, reproducing
    the reference's per-GPU breakdown (sssp/sssp_gpu.cu:516-518): the
    active count and the executor's ``phase_step`` phases per iteration,
    with the branch (push: ``dense`` or ``sparse/<edge budget>``) or the
    direction (GAS: ``pull`` or ``push``) it took. Each phase is timed
    alone; the caller ran ``warmup_phases``. The loop bypasses
    ``ex.run()``, so it drives a recorder of its own, flushed every
    iteration."""
    if state is None:
        state = ex.init_state(**init_kw)
    iters = 0
    dev = ex.device
    rec = obs.recorder_for(obs.engine_label(ex), ex.graph, ex.program)
    rec.start()
    if rec.enabled:
        rec.record_compile(obs.consume_compile_seconds(ex))
    with Timer(dev) as t:
        while max_iters is None or iters < max_iters:
            state, cnt, ph = ex.phase_step(state)
            label = ph.get("branch", ph.get("direction"))
            for s in ph.get("shards", ()):
                print(
                    f"iter {start_iter + iters} part {s['part']}: "
                    f"activeNodes {s['activeNodes']} "
                    f"edges {s['edges']} {_phase_detail(ph)} [{label}]"
                )
            print(
                f"iter {start_iter + iters}: activeNodes {cnt} "
                f"{_phase_detail(ph)} [{label}]"
            )
            iters += 1
            rec.flush(iters, frontier_sizes=[cnt])
            if cnt == 0:
                break
    rec.finish()
    return state, iters, t


def run_push_app(program, argv, supports_start: bool):
    from lux_tpu_torch.engine.check import check as run_check

    log = get_logger(program.name)
    args = parse_args(program, argv, push=True)
    if args.resume and isinstance(program, GasProgram):
        # A GAS state carries the direction its last iteration took, the
        # adaptive policy's memory; a checkpoint has no direction.
        print(
            f"error: {program.name} (a GAS app) cannot -resume: the "
            "checkpoint holds no direction, so the adaptive engine cannot "
            "resume it; run from the start",
            file=sys.stderr,
        )
        return 1
    g, dev = load_graph(args.file, log)
    memory_advisory(g, args.parts, 4)
    ex = make_executor(g, program, args, dev, log)
    init_kw = {"start": args.start} if supports_start else {}
    max_iters = args.ni if args.ni > 0 else None

    state = None
    start_iter = 0
    if args.resume:
        host_vals, start_iter, host_frontier = checkpoint.load(args.resume, g)
        if host_frontier is None:
            print(
                "error: push checkpoint has no frontier; cannot resume",
                file=sys.stderr,
            )
            return 1
        state = _host_to_push_state(ex, host_vals, host_frontier)
        log.info("resumed at iteration %d", start_iter)
        if max_iters is not None:
            max_iters = max(max_iters - start_iter, 0)

    # Kernel builds and first launches outside the timed region: one
    # iteration, then every phase of both branches (lux_tpu's warmup
    # compiles its whole loop).
    ex.warmup(**init_kw)
    ex.warmup_phases(ex.init_state(**init_kw))

    with prof.trace(args.profile):
        if args.verbose:
            state, iters, t = _run_push_verbose(
                ex, state, max_iters, start_iter, init_kw
            )
        else:
            with Timer(dev) as t:
                state, iters = ex.run(
                    max_iters=max_iters, state=state, **init_kw
                )
    t.print_elapsed()
    print(f"iterations = {iters}")
    print_gteps(g, iters, t.elapsed)

    host_vals = final_values(ex, state)
    if args.save:
        checkpoint.save(
            args.save, g, host_vals, start_iter + iters,
            frontier=_push_frontier_host(ex, state),
        )
        log.info("checkpoint written to %s", args.save)
    if args.check:
        if not run_check(g, host_vals, program, device=dev):
            return 1
    return 0
