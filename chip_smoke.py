#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lux_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scale 22]

Drives the port's main paths through the entry points a user calls, on
an R-MAT graph of the given scale (edge factor 16, seed 42: the JAX
package's headline graph at the default scale 22). First tiled pull
PageRank in both tail configurations (lane-select, and the grouped
merge-network tail of ``LUX_GROUPED_TAIL=1``):

1. environment: the card, and its name and power limit from nvidia-smi;
2. build: compile the CUDA kernels from ``lux_tpu_torch/csrc``;
3. graph and plans: generate the graph, plan it, build both executors;
4. each kernel against its plain PyTorch version at the main path's
   shapes (K3 bitwise; K1, K2, K4 bitwise on small integers and within
   rtol=5e-5, atol=1e-9 on random floats), with its time, the plain
   version's, a one-call PyTorch yardstick where there is one, and the
   least time the card needs to move the bytes;
5. end to end: ``run(10)`` in both configurations against the f64 oracle
   at rtol=5e-5, atol=1e-9, with every kernel's launch count checked;
6. timing: ms per iteration and GTEPS for both configurations, and the
   per-phase split from ``phase_step``.

Right after phase 6, on phase 3's plan (planning is not repeated), the
sharded tiled engine (``ShardedTiledExecutor``): PageRank over 4 parts
of a ``LocalMesh`` on the card, in the full and compact exchange modes:

3g. the partition (blocks, strips per part and level, tail edges per
    part, ``max_nvb``) and which mode ``LUX_EXCHANGE=compact`` resolves
    to;
4g. K1 and K2 at one part's shapes against their plain versions
    (bitwise on small integers, within rtol=5e-5, atol=1e-9 on random
    floats), with the same timings;
5g. end to end: ``run(10)`` in both modes against phase 5's f64 oracle
    at rtol=5e-5, atol=1e-9, compact equal to full bitwise, K1 once per
    part and level and K2 once per part per iteration;
6g. timing: median of 3 runs after ``warmup``, ms per iteration, GTEPS,
    the ``phase_step`` split (exchange, strips, tail, apply), the device
    busy share, the exchange and the strip merge (``stack_map`` and
    ``reduce_scatter``) alone against their bytes bounds, and the
    phases' peak device memory.

Then the gather probes P2-P7 (``lux_tpu_torch.probes``), phase 4g too:
each probe's entry point as a user runs it, with its launches counted,
then ``block_take`` in its four forms, ``merge4`` and P7's K3 launch
bitwise against their plain versions at the probes' full shapes, each
with its time, the plain version's, one ``torch.gather`` call's where
one computes the same function, and its bytes bound.

Then the push engine (``PushExecutor``): SSSP from vertex 0 on the same
graph and Connected Components on its undirected closure:

3b. push graphs: the closure and both executors;
4b. K5-K7 against their plain versions at the main path's shapes, all
    bitwise, with the same timings;
5b. end to end: both applications to fixpoint, bitwise against the
    vectorised oracles, zero invariant violations, launch counts checked
    against the branch each iteration took;
6b. timing: median of 3 runs to fixpoint, ms per iteration, GTEPS, the
    median phase split per branch, and the cost of the per-iteration
    host read.

Then the flat pull engine (``PullExecutor``): flat PageRank on the same
graph, and Collaborative Filtering on ``bench.py``'s NetFlix-shaped
ratings graph (at scale 22: 480,000 users, 17,777 items, 50,331,648
ratings in both directions, seed 11), which it runs edge-chunked:

3c. pull executors: the ratings graph, both executors, their
    ``edge_chunk`` (0 and ``1 << 20`` at scale 22);
4c. K8 and K9 against their plain versions at the main path's shapes
    (bitwise on small integers; K8 within rtol=5e-5, atol=1e-9 and K9
    within CF's rtol=1e-4, atol=1e-7 on random floats), with the same
    timings;
5c. end to end: flat PageRank ``run(10)`` against phase 5's f64 oracle,
    CF ``run(5)`` against its f64 oracle (computed on the card) at
    rtol=1e-4, atol=1e-7 with the RMSE before and after, launch counts
    checked;
6c. timing: median of 3 runs after ``warmup``, ms per iteration, GTEPS
    (``bench.py``'s definition) and the device busy share.

Then the direction-adaptive GAS engine (``AdaptiveExecutor``,
``MultiSourceGasExecutor``) on ``bench.py``'s GAS rows: BFS from vertex 0
and label propagation on the graph, DeltaSSSP from vertex 0 on its
weighted twin (the same edges; the graph above is this twin without its
weights, generated once), k-core (k = 4) on the undirected closure:

3d. GAS executors (adaptive), and the multi-source BFS executor (k = 8);
4d. K10 and K11 against their plain versions, bitwise, on states taken
    mid-run for every (combiner, type, gather op) of the four programs,
    and K10 with 8 columns, with the same timings;
5d. end to end: each program to its fixpoint in the adaptive, pinned
    pull and pinned push modes, bitwise against its oracle (BFS depths
    and parents, DeltaSSSP distances with zero invariant violations,
    labels and their community count, k-core's frozen degrees and core
    size) and against each other; the multi-source lanes against the
    single-source runs; PageRank through ``PullGasAdapter`` ``run(10)``
    against phase 5's f64 oracle; launch counts checked against the
    direction each iteration took;
6d. timing by ``bench.py``'s ``bench_gas`` discipline (``warmup``, then
    ``run`` with its ``max_iters``, median of 3): ms per iteration,
    GTEPS, push and pull iterations and switches, the device busy share
    and the median phase split per direction.

Then the sharded pull engine (``ShardedPullExecutor``) over 4 parts of
a ``LocalMesh`` on the card: PageRank on the graph in the full and
compact exchange modes, and CF on the ratings graph (whose compact plan
is unprofitable, so compact resolves to full, logged):

3e. shard layouts and executors: part sizes, capacities, resolved modes
    and exchange bytes per iteration;
4e. K8 and K9 on the largest part's slice of the flat table (its
    destinations at ``row_base``) against their plain versions;
5e. end to end: PageRank ``run(10)`` in both modes against phase 5's
    f64 oracle, compact equal to full bitwise, CF ``run(5)`` against
    phase 5c's f64 oracle, K8 and K9 launched once per part and
    iteration; whether each equals the single-device ``PullExecutor``
    bitwise;
6e. timing: median of 3 runs after ``warmup``, ms per iteration, GTEPS,
    the ``phase_step`` split (exchange, comp, update), the device busy
    share, the exchange alone against its bytes bound, the phases' peak
    device memory; then ``dryrun_multichip(4)`` on the card, which also
    runs the sharded push steps.

Then the multi-source and sharded push engines (``MultiSourcePushExecutor``,
``ShardedPushExecutor``, ``ShardedMultiSourcePushExecutor``), over the
same 4 parts: SSSP from vertex 0 on the graph in the full (packed K5
input, ``blocked_dense``) and compact modes, CC on the closure in the
default (full) mode, and 8-lane multi-source SSSP (root 0 and seven
roots drawn with numpy seed 0 among the vertices with out-edges) on one
device and over the parts in both modes:

3f. host set-up: both shard layouts and push CSRs, the executors, their
    modes, ``blocked_dense``, tiers and exchange bytes per iteration in
    both modes;
4f. the kernels at the sharded path's shapes against their plain
    versions, bitwise: K5 for one part's ``row_ptr`` over the packed
    ``(P * max_nv,)`` table (full) and over its receiver's compact table
    of values and frontier; K6 on one part's frontier; K7 reading the
    flat pre-step stack and combining into one part's row through its
    ``push_dst_local``; and K10 with 8 columns over the ``(P * max_nv,
    8)`` table for one part's ``row_ptr``; with the same timings;
5f. end to end, bitwise: sharded SSSP (both modes) and CC against phase
    5b's oracles with zero violations and phase 5b's iteration counts,
    compact equal to full; every multi-source lane against its
    single-source ``PushExecutor`` run; the sharded multi-source runs
    against the single-device one; K5 once per part and dense
    iteration, K6 and K7 once per part with a queue or queued edges, K10
    once (single device) or once per part per iteration;
6f. timing as in phase 6b: ``warmup``, then the median of 3 runs to
    fixpoint on the host clock, ``init_state`` alone, the run from a
    state on the card, the device busy share, the phase split per
    branch, the exchange alone against its bytes bound; the single-device
    numbers of phase 6b beside them; and the phases' peak device memory.

Any failure exits non-zero. Without a card it exits non-zero and prints
no result. The last line is ``{"ok": true, "device": {...}}``; the line
before it lists the kernels as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
F32_FLOPS_PER_S = 67e12    # H100 SXM published f32 rate, outside tensor cores
ITERS = 10
RTOL, ATOL = 5e-5, 1e-9
CF_ITERS = 5
CF_RTOL, CF_ATOL = 1e-4, 1e-7   # tests/test_colfilter.py
SEED = 42


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: int, flops: int):
    """(ms, "bytes" or "operations"): the least time the card needs to
    move ``nbytes`` once and do ``flops`` f32 operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls, after one warm-up call,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_seconds(fn) -> float:
    """Host seconds of ``fn()`` between two device synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_busy(fn, top: int = 6):
    """(ms of device activity, [(name, ms)] of the ``top`` busiest
    kernels) during one ``fn()`` under ``torch.profiler``, or None when
    the profiler records no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    if not by_name:
        return None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), [(n[:60], v) for n, v in ranked]


def check_close(name: str, got, want, rtol=RTOL, atol=ATOL) -> float:
    """Max abs error of ``got`` against ``want``; raises outside
    ``rtol``, ``atol`` (default 5e-5, 1e-9)."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)
    return float(np.max(np.abs(g - w), initial=0.0))


def check_equal(name: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"{name}: not bitwise equal (max diff {diff})")


def check_launches(label: str, counts: dict, want: dict) -> None:
    """Raise unless the launch counts of a main-path run are ``want``
    (every kernel not named there at 0)."""
    full = {**dict.fromkeys(counts, 0), **want}
    if counts != full:
        raise AssertionError(f"{label}: launches {counts}, expected {full}")


def record(kernels, name, source, replaces, err, ms, plain_ms, nbytes, flops,
           lib_ms):
    """Append one kernel's entry of the ``kernels`` JSON line (its
    launches are filled in after the main-path runs) and log it."""
    b_ms, b_by = bound(nbytes, flops)
    kernels.append({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms,
    })
    log(f"[kernel] {name}: max_abs_err={err:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="R-MAT scale (nv = 2**scale, 16 edges per vertex)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    # -- 1. environment ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.graph import Graph
    from lux_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(f"[env] device {kind}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {smi}")

    # -- 2. build -----------------------------------------------------------
    t = time.perf_counter()
    _cuda.library()
    log(f"[build] libluxk.so ready in {time.perf_counter() - t:.1f} s "
        f"({_cuda.BUILD_DIR})")
    nvcc_log = _cuda.BUILD_DIR / "nvcc.log"
    if nvcc_log.exists():
        for line in nvcc_log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log(f"[build] {line.strip()}")

    # -- 3. graph and plans -------------------------------------------------
    # The weighted R-MAT draws its weights from a generator of their own,
    # so dropping them leaves exactly the unweighted graph.
    t = time.perf_counter()
    gw = generate.rmat(args.scale, 16, seed=SEED, weighted=True)
    g = Graph(nv=gw.nv, ne=gw.ne, row_ptr=gw.row_ptr, col_src=gw.col_src)
    t_gen = time.perf_counter() - t
    log(f"[graph] rmat({args.scale}, 16, seed={SEED}, weighted=True): "
        f"nv={g.nv} ne={g.ne} in {t_gen:.1f} s; g is it without weights")
    kernels = []
    totals, oracle, plan = _pagerank_phases(g, dev, kernels)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    # Phases 3g-6g reuse phase 3's plan (planning costs host minutes at
    # scale), so they run here, before the plan is dropped.
    totals.update(_tiled_sharded_phases(g, plan, oracle, dev, kernels))
    peak = max(peak, torch.cuda.max_memory_allocated())
    del plan
    torch.cuda.empty_cache()
    totals.update(_probe_phases(dev, kernels))
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    t = time.perf_counter()
    gu = generate.undirected(g)
    log(f"[push] undirected closure: nv={gu.nv} ne={gu.ne} in "
        f"{time.perf_counter() - t:.1f} s")
    push_totals, push_ctx = _push_phases(g, gu, dev, kernels)
    for name, n in push_totals.items():
        totals[name] += n
    torch.cuda.empty_cache()
    pull_totals, gc, cf_oracle = _pull_phases(g, oracle, args.scale, dev,
                                              kernels)
    for name, n in pull_totals.items():
        totals[name] += n
    torch.cuda.empty_cache()
    for name, n in _gas_phases(g, gw, gu, oracle, dev, kernels).items():
        totals[name] += n
    del gw
    torch.cuda.empty_cache()
    peak = max(peak, torch.cuda.max_memory_allocated())
    for name, n in _sharded_phases(g, oracle, gc, cf_oracle, dev).items():
        totals[name] += n
    peak = max(peak, torch.cuda.max_memory_allocated())
    del gc
    torch.cuda.empty_cache()
    for name, n in _push_sharded_phases(g, gu, push_ctx, dev,
                                        kernels).items():
        totals[name] = totals.get(name, 0) + n
    peak = max(peak, torch.cuda.max_memory_allocated())

    for entry in kernels:
        entry["launches"] = totals[entry["name"]]
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} never ran on the main path")
    log(f"[done] scale {args.scale} in {time.perf_counter() - t_start:.1f} s "
        f"on {smi}; peak device memory {peak / 2**30:.2f} GiB")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _pagerank_phases(g, dev, kernels):
    """Phases 3-6 on the tiled pull path; returns the launch counts of
    its two runs, summed, the f64 oracle of ``run(10)`` and the plan."""
    import torch

    from lux_tpu_torch.engine.tiled import TiledPullExecutor
    from lux_tpu_torch.models.pagerank import PageRank, reference_pagerank
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops.merge_tail_kernel import (
        level_apply,
        level_apply_ref,
        root_reduce,
    )
    from lux_tpu_torch.ops.segment import segment_sum_by_rowptr_plain
    from lux_tpu_torch.ops.tiled_spmv import (
        lane_select_tail_sums,
        lane_select_tail_sums_plain,
        plan_hybrid,
        strip_level_spmv,
        strip_level_spmv_plain,
    )

    t = time.perf_counter()
    plan = plan_hybrid(g)
    t_plan = time.perf_counter() - t
    log(f"[plan] strips={plan.num_strips} strip_bytes={plan.strip_bytes} "
        f"coverage={plan.coverage:.4f} tail_edges={plan.tail_sb.shape[0]} "
        f"in {t_plan:.1f} s")
    t = time.perf_counter()
    ex_lane = TiledPullExecutor(g, PageRank(), plan=plan)
    torch.cuda.synchronize()
    log(f"[plan] lane-select executor built in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    os.environ["LUX_GROUPED_TAIL"] = "1"
    try:
        ex_grp = TiledPullExecutor(g, PageRank(), plan=plan)
    finally:
        del os.environ["LUX_GROUPED_TAIL"]
    torch.cuda.synchronize()
    gt = ex_grp.gtail
    level_rows = [int(c.shape[0]) for c in gt.codes]
    log(f"[plan] grouped plan + executor built in "
        f"{time.perf_counter() - t:.1f} s: merge levels={gt.n_levels} "
        f"stream rows={sum(level_rows)} widest level={max(level_rows)} "
        f"mean inflation={ex_grp.gtail_stats['mean_inflation']:.3f}")

    # -- 4. kernels against their plain versions ----------------------------
    rng = np.random.default_rng(SEED)
    dh = ex_lane.dhybrid
    nvb = dh.nvb
    x_float = torch.from_numpy(
        rng.random((nvb, 128), dtype=np.float32) + np.float32(0.5)).to(dev)
    x_int = torch.from_numpy(
        rng.integers(0, 4, size=(nvb, 128)).astype(np.float32)).to(dev)
    reps = 10

    # K1 strip_spmv, every level of the plan.
    err = 0.0
    for lev in dh.levels:
        for x, exact in ((x_int, True), (x_float, False)):
            got = strip_level_spmv(x, lev)
            want = strip_level_spmv_plain(x, lev.strips, lev.cols, lev.row_ptr)
            if exact:
                check_equal(f"K1 r={lev.r} integral", got, want)
            else:
                err = max(err, check_close(f"K1 r={lev.r}", got, want))
    k1_ms = sum(cuda_ms(lambda: strip_level_spmv(x_float, lev), reps)
                for lev in dh.levels)
    k1_plain = sum(cuda_ms(lambda: strip_level_spmv_plain(
        x_float, lev.strips, lev.cols, lev.row_ptr), 2) for lev in dh.levels)
    k1_bytes = sum(
        lev.strips.numel() + 4 * lev.cols.numel() + 8 * lev.row_ptr.numel()
        + x_float.numel() * 4 + 4 * lev.items.nrows * lev.r
        for lev in dh.levels)
    # Yardstick: the same levels as one cuSPARSE CSR product each.
    k1_lib = 0.0
    for lev in dh.levels:
        csr = _level_csr(lev, nvb, dev)
        xv = x_float.reshape(-1, 1)
        lib_y = (csr @ xv).reshape(-1)
        log(f"[kernel] strip_spmv r={lev.r}: sparse yardstick max diff "
            f"{(lib_y - strip_level_spmv(x_float, lev)).abs().max().item():.3e}")
        k1_lib += cuda_ms(lambda: csr @ xv, reps)
        del csr
    # One multiply-add per strip cell, as the kernel does them.
    k1_flops = sum(2 * lev.strips.numel() for lev in dh.levels)
    record(kernels, "strip_spmv", "lux_tpu_torch/csrc/strip_spmv.cu",
           "lux_tpu/ops/tiled_spmv.py:945", err, k1_ms, k1_plain, k1_bytes,
           k1_flops, k1_lib)

    # K2 tail_gather_sum.
    args2 = (dh.tail_sb, dh.tail_lane, dh.tail_row_ptr)
    check_equal("K2 integral",
                lane_select_tail_sums(x_int, *args2, dh.tail_items),
                lane_select_tail_sums_plain(x_int, *args2))
    err = check_close("K2", lane_select_tail_sums(x_float, *args2,
                                                  dh.tail_items),
                      lane_select_tail_sums_plain(x_float, *args2))
    k2_ms = cuda_ms(lambda: lane_select_tail_sums(
        x_float, *args2, dh.tail_items), reps)
    k2_plain = cuda_ms(lambda: lane_select_tail_sums_plain(x_float, *args2),
                       reps)
    m = dh.tail_sb.numel()
    k2_bytes = 5 * m + 8 * dh.tail_row_ptr.numel() + 4 * x_float.numel() \
        + 4 * g.nv
    cols = (dh.tail_sb.long() << 7) | dh.tail_lane.long()
    tail_csr = torch.sparse_csr_tensor(
        dh.tail_row_ptr, cols, torch.ones(m, device=dev),
        size=(g.nv, nvb * 128))
    xv = x_float.reshape(-1, 1)
    k2_lib = cuda_ms(lambda: tail_csr @ xv, reps)
    del tail_csr, cols
    record(kernels, "tail_gather_sum", "lux_tpu_torch/csrc/segment_sum.cu",
           "lux_tpu/ops/tiled_spmv.py:1027", err, k2_ms, k2_plain, k2_bytes,
           m, k2_lib)

    # K3 level_apply, every level; each level's input is the plain chain's.
    x = x_float
    k3_ms = k3_plain = 0.0
    k3_bytes = 0
    for k in range(gt.n_levels + 1):
        a, b, c = gt.arow[k], gt.brow[k], gt.codes[k]
        if c.shape[0] == 0:
            continue
        want = level_apply_ref(x, a, b, c)
        check_equal(f"K3 level {k}", level_apply(x, a, b, c), want)
        k3_ms += cuda_ms(lambda: level_apply(x, a, b, c), reps)
        k3_plain += cuda_ms(lambda: level_apply_ref(x, a, b, c), reps)
        k3_bytes += 4 * x.numel() + 8 * a.numel() + c.numel() \
            + 4 * want.numel()
        x = want
    record(kernels, "level_apply", "lux_tpu_torch/csrc/level_apply.cu",
           "lux_tpu/ops/merge_tail_kernel.py:112", 0.0, k3_ms, k3_plain,
           k3_bytes, 0, None)

    # K4 segment_sum_rowptr on the root stream, with its lane mask.
    s_root = gt.nvalid_root.shape[0]
    root_f = torch.from_numpy(
        rng.random((s_root, 128), dtype=np.float32) + np.float32(0.5)).to(dev)
    root_i = torch.from_numpy(
        rng.integers(0, 4, size=(s_root, 128)).astype(np.float32)).to(dev)
    rr = (gt.nvalid_root, gt.dst_row_ptr)
    check_equal("K4 integral", root_reduce(root_i, *rr, gt.dst_items),
                segment_sum_by_rowptr_plain(root_i, gt.dst_row_ptr,
                                            gt.nvalid_root))
    err = check_close("K4", root_reduce(root_f, *rr, gt.dst_items),
                      segment_sum_by_rowptr_plain(root_f, gt.dst_row_ptr,
                                                  gt.nvalid_root))
    k4_ms = cuda_ms(lambda: root_reduce(root_f, *rr, gt.dst_items), reps)
    k4_plain = cuda_ms(lambda: segment_sum_by_rowptr_plain(
        root_f, gt.dst_row_ptr, gt.nvalid_root), reps)
    k4_bytes = 4 * root_f.numel() + 4 * s_root \
        + 8 * gt.dst_row_ptr.numel() + 4 * g.nv
    lane = torch.arange(128, device=dev)

    def k4_library():
        live = lane[None, :] < gt.nvalid_root[:, None]
        return torch.segment_reduce(
            torch.where(live, root_f, 0.0).reshape(-1), "sum",
            offsets=gt.dst_row_ptr)

    k4_lib = cuda_ms(k4_library, reps)
    record(kernels, "segment_sum_rowptr", "lux_tpu_torch/csrc/segment_sum.cu",
           "lux_tpu/ops/merge_tail_kernel.py:146", err, k4_ms, k4_plain,
           k4_bytes, root_f.numel(), k4_lib)
    del x_float, x_int, root_f, root_i, x
    torch.cuda.empty_cache()

    # -- 5. end to end, both configurations ---------------------------------
    t = time.perf_counter()
    oracle = reference_pagerank(g, ITERS)
    log(f"[e2e] f64 oracle ({ITERS} iterations) in "
        f"{time.perf_counter() - t:.1f} s")
    # Wrappers skip empty launches: count the levels and tails with work.
    nlev = sum(1 for lev in dh.levels if lev.items.n_items > 0)
    k2_per_iter = int(dh.tail_items.n_items > 0)
    k3_per_iter = sum(1 for c in gt.codes if c.shape[0] > 0)
    none = dict.fromkeys(_cuda.LAUNCHES, 0)
    expected = {
        "lane-select": {**none, "strip_spmv": nlev * ITERS,
                        "tail_gather_sum": k2_per_iter * ITERS},
        "grouped": {**none, "strip_spmv": nlev * ITERS,
                    "level_apply": k3_per_iter * ITERS,
                    "segment_sum_rowptr":
                        int(gt.dst_items.n_items > 0) * ITERS},
    }
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    for label, ex in (("lane-select", ex_lane), ("grouped", ex_grp)):
        _cuda.reset_launches()
        out = ex.run(ITERS)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        out = out.cpu().numpy()
        if out.shape != (g.nv,) or not np.all(np.isfinite(out)):
            raise AssertionError(f"{label}: bad output {out.shape}")
        np.testing.assert_allclose(out, oracle, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label} vs f64 oracle")
        err = float(np.max(np.abs(out.astype(np.float64) - oracle)))
        log(f"[e2e] {label}: run({ITERS}) matches the f64 oracle "
            f"(max abs err {err:.3e}); launches {counts}")
        if counts != expected[label]:
            raise AssertionError(
                f"{label}: launches {counts}, expected {expected[label]}")
        for name, n in counts.items():
            totals[name] += n

        # -- 6. timing ------------------------------------------------------
        ex.warmup()
        vals = ex.init_values()
        ms = cuda_ms(lambda: ex.run(ITERS, vals=vals), 3) / ITERS
        runs = [ex.phase_step(vals)[1] for _ in range(5)]
        phases = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
        log(f"[time] {label}: {ms:.3f} ms/iteration, "
            f"{g.ne / (ms * 1e-3) / 1e9:.3f} GTEPS")
        log(f"[time] {label} phases (ms, median of 5): " + ", ".join(
            f"{k}={v * 1e3:.3f}" for k, v in phases.items()))

    return totals, oracle, plan


def _push_phases(g, gu, dev, kernels):
    """Phases 3b-6b on the push engine (SSSP on ``g``, CC on its closure
    ``gu``); returns the launch counts of its two runs to fixpoint,
    summed, and for phases 3f-6f per application its oracle, iterations,
    sparse iterations and median ms to fixpoint, with the SSSP
    executor."""
    import torch

    from lux_tpu_torch.engine.check import count_violations
    from lux_tpu_torch.engine.push import PushExecutor
    from lux_tpu_torch.models import SSSP, ConnectedComponents
    from lux_tpu_torch.models.components import reference_components
    from lux_tpu_torch.models.sssp import reference_sssp
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import frontier as fq
    from lux_tpu_torch.ops import segment as seg

    # -- 3b. push executors -------------------------------------------------
    apps = {}
    for app, graph, prog, kw in (("sssp", g, SSSP(), {"start": 0}),
                                 ("cc", gu, ConnectedComponents(), {})):
        t = time.perf_counter()
        ex = PushExecutor(graph, prog)
        torch.cuda.synchronize()
        log(f"[push] {app} executor (host CSR, work items, device copy) "
            f"built in {time.perf_counter() - t:.1f} s: nv={graph.nv} "
            f"ne={graph.ne} blocked_dense={ex.blocked_dense} "
            f"sparse={ex.sparse} tiers={ex.tiers}")
        apps[app] = (ex, kw)
    ex_s, ex_c = apps["sssp"][0], apps["cc"][0]
    reps = 10

    # -- 4b. kernels against their plain versions ---------------------------
    # K5 on SSSP's state after 2 iterations and CC's first iteration, in
    # both input forms; the JSON row sums the form the main path runs.
    st_s2, _ = ex_s.run(max_iters=2, start=0)
    k5 = dict.fromkeys(("ms", "plain", "bytes", "ops"), 0.0)
    for label, ex, st in (("sssp after 2 iterations", ex_s, st_s2),
                          ("cc iteration 1", ex_c, ex_c.init_state())):
        prog = ex.program
        relax = seg.RELAX_OPS[prog.relax_op]
        packed = seg.pack_words(st.values, st.frontier)
        forms = {"packed": (packed, None),
                 "unpacked": (st.values, st.frontier)}
        want = seg.segment_minmax_relax_plain(
            ex.row_ptr, ex.col_src, packed, None, prog.combiner, relax)
        times = {}
        for form, (table, front) in forms.items():
            check_equal(f"K5 plain {form} {label}",
                        seg.segment_minmax_relax_plain(
                            ex.row_ptr, ex.col_src, table, front,
                            prog.combiner, relax), want)

            def k5_call(table=table, front=front):
                return seg.segment_minmax_relax(
                    ex.row_ptr, ex.col_src, table, front, prog.combiner,
                    prog.relax_op, ex.items)

            check_equal(f"K5 {form} {label}", k5_call(), want)
            times[form] = cuda_ms(k5_call, reps)
        main_form = "packed" if ex.blocked_dense else "unpacked"
        table, front = forms[main_form]
        plain_ms = cuda_ms(lambda: seg.segment_minmax_relax_plain(
            ex.row_ptr, ex.col_src, table, front, prog.combiner, relax), 2)
        nv, ne = ex.graph.nv, ex.graph.ne
        nbytes = 4 * ne + 8 * (nv + 1) + 4 * nv \
            + (4 if main_form == "packed" else 5) * nv
        log(f"[push] K5 {label}: bitwise in both forms; packed "
            f"{times['packed']:.4f} ms, unpacked {times['unpacked']:.4f} ms, "
            f"plain ({main_form}) {plain_ms:.4f} ms, bytes bound "
            f"{bound(nbytes, ne)[0]:.4f} ms")
        k5["ms"] += times[main_form]
        k5["plain"] += plain_ms
        k5["bytes"] += nbytes
        k5["ops"] += ne
    # No one PyTorch call gathers, masks, relaxes and reduces per segment;
    # torch.segment_reduce has no integer kernels.
    record(kernels, "segment_minmax_relax", "lux_tpu_torch/csrc/push_dense.cu",
           "lux_tpu/engine/push.py:150", 0.0, k5["ms"], k5["plain"],
           k5["bytes"], k5["ops"], None)
    del st_s2, packed, table, front, want
    torch.cuda.empty_cache()

    # K6 and K7 on the sparse-tier frontier of SSSP's run with the most
    # out-edges, and on a synthetic frontier of exactly Q vertices.
    ex_s.run(start=0)
    sparse_at = [(out, i) for i, (b, _, out) in enumerate(ex_s.branch_log)
                 if b > 0]
    if not sparse_at:
        raise AssertionError("SSSP's run took no sparse iteration")
    _, at = max(sparse_at)
    st_run, _ = ex_s.run(max_iters=at, start=0)
    rng = np.random.default_rng(SEED)
    q_cap = ex_s.queue_cap
    pick = rng.choice(g.nv, size=q_cap, replace=False)
    synth = torch.zeros(g.nv, dtype=torch.bool)
    synth[torch.from_numpy(pick)] = True
    st_synth = type(st_run)(st_run.values, synth.to(dev))
    k67 = {}
    for label, st in ((f"sssp iteration {at + 1}", st_run),
                      (f"synthetic Q={q_cap}", st_synth)):
        prog = ex_s.program
        relax = seg.RELAX_OPS[prog.relax_op]
        fr = st.frontier
        cnt = int(fr.sum())
        out = int(torch.where(fr, ex_s.out_degrees, 0).sum())
        rp, col_dst = ex_s.csr_row_ptr, ex_s.csr_col_dst
        want_q = fq.frontier_queue_plain(fr, rp)
        got_q = fq.frontier_queue(fr, rp, cnt)
        for part, got, want in zip(("q", "start", "deg", "offs"), got_q,
                                   want_q):
            check_equal(f"K6 {part} {label}", got, want)
        q, start, _, offs = got_q
        want = fq.queue_relax_scatter_plain(q, start, offs, col_dst,
                                            st.values, prog.combiner, relax)
        check_equal(f"K7 {label}", fq.queue_relax_scatter(
            q, start, offs, col_dst, st.values, prog.combiner, prog.relax_op,
            out), want)
        k6_ms = cuda_ms(lambda: fq.frontier_queue(fr, rp, cnt), reps)
        k6_plain = cuda_ms(lambda: fq.frontier_queue_plain(fr, rp), reps)
        k6_lib = cuda_ms(lambda: torch.nonzero(fr), reps)
        k7_ms = cuda_ms(lambda: fq.queue_relax_scatter(
            q, start, offs, col_dst, st.values, prog.combiner,
            prog.relax_op, out), reps)
        k7_plain = cuda_ms(lambda: fq.queue_relax_scatter_plain(
            q, start, offs, col_dst, st.values, prog.combiner, relax), reps)
        # Yardstick: the scatter alone, one scatter_reduce over int64
        # candidates and destinations built beforehand.
        slot = torch.repeat_interleave(torch.arange(cnt, device=dev),
                                       offs.diff())
        edge = start[slot] + torch.arange(out, device=dev) - offs[:-1][slot]
        dst_e = col_dst[edge].long()
        vals64 = seg.widen_u32(st.values)
        cand = relax(vals64[q.long()[slot]])
        k7_lib = cuda_ms(lambda: vals64.scatter_reduce(
            0, dst_e, cand, reduce="amin", include_self=True), reps)
        del slot, edge, dst_e, cand
        k6_bytes = g.nv + 16 * cnt + 28 * cnt + 8
        k7_bytes = 8 * g.nv + 4 * out + 20 * cnt + 8
        log(f"[push] K6/K7 {label}: cnt={cnt} out_edges={out}; bitwise; "
            f"K6 {k6_ms:.4f} ms (plain {k6_plain:.4f}, torch.nonzero "
            f"{k6_lib:.4f}, bound {bound(k6_bytes, 0)[0]:.4f}); K7 "
            f"{k7_ms:.4f} ms (plain {k7_plain:.4f}, scatter_reduce "
            f"{k7_lib:.4f}, bound {bound(k7_bytes, out)[0]:.4f})")
        if not k67:
            k67 = dict(k6=(k6_ms, k6_plain, k6_bytes, cnt, k6_lib),
                       k7=(k7_ms, k7_plain, k7_bytes, out, k7_lib))
    record(kernels, "frontier_queue", "lux_tpu_torch/csrc/frontier.cu",
           "lux_tpu/engine/push.py:447", 0.0, *k67["k6"])
    record(kernels, "queue_relax_scatter", "lux_tpu_torch/csrc/frontier.cu",
           "lux_tpu/engine/push.py:460", 0.0, *k67["k7"])
    del st_run, st_synth, synth, want, got_q, want_q, q, start, offs, vals64
    torch.cuda.empty_cache()

    # -- 5b. end to end -------------------------------------------------------
    t = time.perf_counter()
    oracles = {"sssp": reference_sssp(g, 0)}
    log(f"[push] sssp oracle (numpy BFS) in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    oracles["cc"] = reference_components(gu)
    log(f"[push] cc oracle (scipy) in {time.perf_counter() - t:.1f} s")
    push_kernels = ("segment_minmax_relax", "frontier_queue",
                    "queue_relax_scatter")
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    ctx = {"sssp_ex": ex_s}
    for app, (ex, kw) in apps.items():
        _cuda.reset_launches()
        st, iters = ex.run(**kw)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        vals = ex.values(st)
        if vals.shape != (ex.graph.nv,) or vals.dtype != np.uint32:
            raise AssertionError(f"{app}: bad output {vals.shape} {vals.dtype}")
        if not np.array_equal(vals, oracles[app]):
            raise AssertionError(
                f"{app}: {int(np.sum(vals != oracles[app]))} values differ "
                "from the oracle")
        viol = count_violations(ex.graph, st.values, ex.program)
        if viol:
            raise AssertionError(f"{app}: {viol} invariant violations")
        branches = ex.branch_log
        dense = sum(1 for b, _, _ in branches if b == 0)
        if dense + ex.sparse_iters != iters:
            raise AssertionError(f"{app}: {dense} dense + {ex.sparse_iters} "
                                 f"sparse != {iters} iterations")
        want = dict.fromkeys(_cuda.LAUNCHES, 0)
        want["segment_minmax_relax"] = dense
        want["frontier_queue"] = sum(1 for b, c, _ in branches if b > 0 and c > 0)
        want["queue_relax_scatter"] = sum(
            1 for b, c, e in branches if b > 0 and c > 0 and e > 0)
        if counts != want:
            raise AssertionError(f"{app}: launches {counts}, expected {want}")
        ctx[app] = {"oracle": oracles[app], "iters": iters,
                    "sparse_iters": ex.sparse_iters}
        log(f"[push] {app}: fixpoint in {iters} iterations "
            f"({ex.sparse_iters} sparse) matches the oracle bitwise, 0 "
            f"violations; branches {[(b, c, e) for b, c, e in branches]}; "
            f"launches { {k: counts[k] for k in push_kernels} }")
        for name, n in counts.items():
            totals[name] += n
    for name in push_kernels:
        if totals[name] <= 0:
            raise AssertionError(f"{name} never ran on the push path")

    # -- 6b. timing -----------------------------------------------------------
    probe = torch.zeros(2, dtype=torch.int64, device=dev)
    reads = []
    for _ in range(100):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.tolist()
        reads.append(time.perf_counter() - t0)
    read_ms = float(np.median(reads)) * 1e3
    log(f"[time] host read of the two frontier counters (16 bytes, idle "
        f"stream): median {read_ms:.4f} ms over 100")
    for app, (ex, kw) in apps.items():
        ex.warmup(**kw)
        secs = [host_seconds(lambda: ex.run(**kw)) for _ in range(3)]
        sec = float(np.median(secs))
        iters = len(ex.branch_log)
        ctx[app]["ms"] = sec * 1e3
        log(f"[time] push {app}: {iters} iterations ({ex.sparse_iters} "
            f"sparse) in {sec * 1e3:.3f} ms (median of 3: "
            f"{[round(x * 1e3, 3) for x in secs]}), "
            f"{sec / iters * 1e3:.3f} ms/iteration, "
            f"{ex.graph.ne * iters / sec / 1e9:.3f} GTEPS; host reads "
            f"{iters + 1} x {read_ms:.4f} ms")
        # The same run split: building the initial state (host arrays
        # copied to the card), and iterating from a state on the card.
        init = float(np.median([host_seconds(lambda: ex.init_state(**kw))
                                for _ in range(3)]))
        st0 = ex.init_state(**kw)
        iter_sec = float(np.median([host_seconds(lambda: ex.run(state=st0))
                                    for _ in range(3)]))
        log(f"[time] push {app}: init_state {init * 1e3:.3f} ms; run from "
            f"a device state {iter_sec * 1e3:.3f} ms, "
            f"{iter_sec / iters * 1e3:.3f} ms/iteration "
            f"(medians of 3)")
        busy = device_busy(lambda: ex.run(state=st0))
        if busy is None:
            log(f"[time] push {app}: device busy share not measured "
                "(the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] push {app}: device busy {busy_ms:.3f} ms of the "
                f"{iter_sec * 1e3:.3f} ms run from a device state "
                f"({busy_ms / (iter_sec * 1e3):.1%}; torch.profiler); top "
                "kernels (ms): " + ", ".join(f"{n}={v:.3f}" for n, v in top))
        st = ex.init_state(**kw)
        ex.warmup_phases(st)
        split = {}
        while True:
            st, cnt, times = ex.phase_step(st)
            branch = "dense" if times.pop("branch") == "dense" else "sparse"
            split.setdefault(branch, []).append(times)
            if cnt == 0:
                break
        for branch, runs in split.items():
            med = {k: float(np.median([r[k] for r in runs])) * 1e3
                   for k in runs[0]}
            log(f"[time] push {app} {branch} phases (ms, median of "
                f"{len(runs)}): " + ", ".join(
                    f"{k}={v:.3f}" for k, v in med.items()))
    return totals, ctx


def _pull_phases(g, pr_oracle, scale, dev, kernels):
    """Phases 3c-6c on the flat pull engine: flat PageRank on ``g`` and
    CF on ``bench.py``'s ratings graph of this scale; returns the launch
    counts of their two runs, summed, the ratings graph and CF's f64
    oracle of ``run(5)``."""
    import torch

    from lux_tpu_torch.engine.pull import DEFAULT_EDGE_CHUNK, PullExecutor
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models import CollaborativeFiltering, PageRank
    from lux_tpu_torch.models.colfilter import K, reference_colfilter, rmse
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import segment as seg
    from lux_tpu_torch.utils import flags

    # -- 3c. pull executors ---------------------------------------------------
    t = time.perf_counter()
    ex_pr = PullExecutor(g, PageRank())
    torch.cuda.synchronize()
    log(f"[pull] flat PageRank executor built in "
        f"{time.perf_counter() - t:.1f} s: edge_chunk={ex_pr.edge_chunk} "
        f"work items={ex_pr.items.n_items}")
    # bench.py's run_cf sizes: NetFlix-shaped at scale 22.
    n_users = min(480_000, 1 << max(scale - 3, 1))
    n_items = max(n_users // 27, 64)
    n_ratings = 12 << scale
    t = time.perf_counter()
    gc = generate.bipartite_ratings(n_users, n_items, n_ratings, seed=11)
    in_deg = gc.in_degrees
    log(f"[pull] bipartite_ratings({n_users}, {n_items}, {n_ratings}, "
        f"seed=11): nv={gc.nv} ne={gc.ne} max in-degree={int(in_deg.max())} "
        f"mean user in-degree={in_deg[:n_users].mean():.1f} in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ex_cf = PullExecutor(gc, CollaborativeFiltering())
    torch.cuda.synchronize()
    auto = gc.ne * K * 4 > flags.get_int("LUX_EDGE_CHUNK_BYTES")
    want_chunk = DEFAULT_EDGE_CHUNK if auto else 0
    log(f"[pull] CF executor built in {time.perf_counter() - t:.1f} s: "
        f"edge_chunk={ex_cf.edge_chunk} (expected {want_chunk}) "
        f"work items={ex_cf.items.n_items}")
    if ex_pr.edge_chunk != 0 or ex_cf.edge_chunk != want_chunk:
        raise AssertionError("the pull executors chose another edge_chunk")

    # -- 4c. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(SEED)
    reps = 10
    nv, ne = g.nv, g.ne
    rp, cs, items = ex_pr.row_ptr, ex_pr.col_src, ex_pr.items
    x_f = torch.from_numpy(
        rng.random(nv, dtype=np.float32) + np.float32(0.5)).to(dev)
    x_i = torch.from_numpy(
        rng.integers(0, 4, size=nv).astype(np.float32)).to(dev)
    check_equal("K8 integral", seg.gather_segment_sum(x_i, rp, cs, items),
                seg.gather_segment_sum_plain(x_i, rp, cs))
    err = check_close("K8", seg.gather_segment_sum(x_f, rp, cs, items),
                      seg.gather_segment_sum_plain(x_f, rp, cs))
    k8_ms = cuda_ms(lambda: seg.gather_segment_sum(x_f, rp, cs, items), reps)
    k8_plain = cuda_ms(lambda: seg.gather_segment_sum_plain(x_f, rp, cs), 2)
    # The function's bytes: col_src, row_ptr and vals read once, the output
    # written once (the work items are the kernel's plan, not its input).
    k8_bytes = 4 * ne + 8 * (nv + 1) + 4 * nv + 4 * nv
    csr = torch.sparse_csr_tensor(rp, cs.long(), torch.ones(ne, device=dev),
                                  size=(nv, nv))
    xv = x_f.reshape(-1, 1)
    diff = (csr @ xv).reshape(-1) - seg.gather_segment_sum(x_f, rp, cs, items)
    log(f"[pull] K8 sparse yardstick max diff {diff.abs().max().item():.3e}")
    k8_lib = cuda_ms(lambda: csr @ xv, reps)
    del csr, xv, diff
    record(kernels, "gather_segment_sum", "lux_tpu_torch/csrc/pull_sum.cu",
           "lux_tpu/engine/pull.py:465", err, k8_ms, k8_plain, k8_bytes, ne,
           k8_lib)

    nvc, nec = gc.nv, gc.ne
    rpc, csc, wc, itc = (ex_cf.row_ptr, ex_cf.col_src, ex_cf.weights,
                         ex_cf.items)
    win = ex_cf.edge_chunk
    v_f = torch.from_numpy(rng.random((nvc, K), dtype=np.float32)
                           * np.float32(0.2) + np.float32(0.12)).to(dev)
    v_i = torch.from_numpy(
        rng.integers(0, 2, size=(nvc, K)).astype(np.float32)).to(dev)
    check_equal("K9 integral", seg.cf_edge_sum(v_i, rpc, csc, wc, itc),
                seg.cf_edge_sum_plain(v_i, rpc, csc, wc, window=win))
    err = check_close("K9", seg.cf_edge_sum(v_f, rpc, csc, wc, itc),
                      seg.cf_edge_sum_plain(v_f, rpc, csc, wc, window=win),
                      rtol=CF_RTOL, atol=CF_ATOL)
    k9_ms = cuda_ms(lambda: seg.cf_edge_sum(v_f, rpc, csc, wc, itc), reps)
    k9_plain = cuda_ms(lambda: seg.cf_edge_sum_plain(v_f, rpc, csc, wc,
                                                     window=win), 2)
    # col_src and weights, row_ptr, the (nv, K) table and the output.
    k9_bytes = 8 * nec + 8 * (nvc + 1) + 2 * 4 * K * nvc
    # Per edge: a K-term dot (2K), the error (1), K scaled adds (2K).
    k9_flops = (4 * K + 1) * nec
    # No one PyTorch call gathers two rows per edge, dots them and sums
    # the scaled rows per destination.
    record(kernels, "cf_edge_sum", "lux_tpu_torch/csrc/pull_sum.cu",
           "lux_tpu/engine/pull.py:489", err, k9_ms, k9_plain, k9_bytes,
           k9_flops, None)
    del x_f, x_i, v_f, v_i
    torch.cuda.empty_cache()

    # -- 5c. end to end -------------------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    _cuda.reset_launches()
    out = ex_pr.run(ITERS)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    out = out.cpu().numpy()
    if out.shape != (nv,) or not np.all(np.isfinite(out)):
        raise AssertionError(f"flat pagerank: bad output {out.shape}")
    np.testing.assert_allclose(out, pr_oracle, rtol=RTOL, atol=ATOL,
                               err_msg="flat pagerank vs f64 oracle")
    err = float(np.max(np.abs(out.astype(np.float64) - pr_oracle)))
    check_launches("flat pagerank", counts, {"gather_segment_sum": ITERS})
    log(f"[pull] flat pagerank: run({ITERS}) matches the f64 oracle (max abs "
        f"err {err:.3e}); launches {counts['gather_segment_sum']}")
    for name, n in counts.items():
        totals[name] += n

    t = time.perf_counter()
    cf_oracle = reference_colfilter(gc, CF_ITERS, device=dev)
    log(f"[pull] CF f64 oracle ({CF_ITERS} iterations, on the card) in "
        f"{time.perf_counter() - t:.1f} s")
    v0 = ex_cf.init_values()
    rmse0 = rmse(gc, v0.cpu().numpy(), device=dev)
    _cuda.reset_launches()
    out = ex_cf.run(CF_ITERS)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    out = out.cpu().numpy()
    if out.shape != (nvc, K) or not np.all(np.isfinite(out)):
        raise AssertionError(f"cf: bad output {out.shape}")
    np.testing.assert_allclose(out, cf_oracle, rtol=CF_RTOL, atol=CF_ATOL,
                               err_msg="cf vs f64 oracle")
    err = float(np.max(np.abs(out.astype(np.float64) - cf_oracle)))
    check_launches("cf", counts, {"cf_edge_sum": CF_ITERS})
    log(f"[pull] cf: run({CF_ITERS}) matches the f64 oracle (max abs err "
        f"{err:.3e}); RMSE {rmse0:.6f} before, "
        f"{rmse(gc, out, device=dev):.6f} after; launches "
        f"{counts['cf_edge_sum']}")
    for name, n in counts.items():
        totals[name] += n

    # -- 6c. timing -----------------------------------------------------------
    for label, ex, graph, iters in (("flat pagerank", ex_pr, g, ITERS),
                                    ("cf", ex_cf, gc, CF_ITERS)):
        ex.warmup()
        vals = ex.init_values()
        secs = [host_seconds(lambda: ex.run(iters, vals=vals))
                for _ in range(3)]
        sec = float(np.median(secs))
        ev_ms = cuda_ms(lambda: ex.run(iters, vals=vals), 3) / iters
        log(f"[time] pull {label}: {sec / iters * 1e3:.3f} ms/iteration, "
            f"{graph.ne * iters / sec / 1e9:.3f} GTEPS (host clock, median "
            f"of 3 runs of {iters}: {[round(x * 1e3, 3) for x in secs]} ms); "
            f"{ev_ms:.3f} ms/iteration by CUDA events (mean of 3)")
        busy = device_busy(lambda: ex.run(iters, vals=vals))
        if busy is None:
            log(f"[time] pull {label}: device busy share not measured (the "
                "profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] pull {label}: device busy {busy_ms:.3f} ms of "
                f"{sec * 1e3:.3f} ms ({busy_ms / (sec * 1e3):.1%}; "
                "torch.profiler); top kernels (ms): "
                + ", ".join(f"{n}={v:.3f}" for n, v in top))
    return totals, gc, cf_oracle


GAS_KERNELS = ("gas_pull_acc", "frontier_queue", "gas_push_acc")


def _gas_expected(log) -> dict:
    """Launches of one GAS run from its direction log: K10 per pull
    iteration; K6 per push iteration with a frontier, K11 per push
    iteration whose frontier has out-edges (the wrappers skip empty
    launches)."""
    return {
        "gas_pull_acc": sum(1 for d, _, _ in log if d == 0),
        "frontier_queue": sum(1 for d, c, _ in log if d == 1 and c > 0),
        "gas_push_acc": sum(1 for d, c, e in log if d == 1 and c > 0 and e > 0),
    }


def _gas_phases(g, gw, gu, pr_oracle, dev, kernels) -> dict:
    """Phases 3d-6d on the GAS engine: BFS and label propagation on
    ``g``, DeltaSSSP on its weighted twin ``gw``, k-core (k = 4) on the
    closure ``gu``; returns the launch counts of the phase 5d runs,
    summed."""
    import torch

    from lux_tpu_torch.engine.check import count_violations
    from lux_tpu_torch.engine.gas import (
        AdaptiveExecutor,
        MultiSourceGasExecutor,
        as_gas,
    )
    from lux_tpu_torch.models import (
        BFS,
        DeltaSSSP,
        KCore,
        LabelPropagation,
        PageRank,
    )
    from lux_tpu_torch.models.bfs import reference_bfs
    from lux_tpu_torch.models.kcore import reference_kcore
    from lux_tpu_torch.models.labelprop import reference_labelprop
    from lux_tpu_torch.models.sssp_delta import reference_sssp_delta
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import frontier as fq
    from lux_tpu_torch.ops import segment as seg

    # -- 3d. GAS executors ----------------------------------------------------
    # name -> (graph, program maker, run kw, bench.py's max_iters)
    apps = {
        "bfs": (g, BFS, {"start": 0}, 32),
        "sssp_delta": (gw, DeltaSSSP, {"start": 0}, 32),
        "labelprop": (g, LabelPropagation, {}, 16),
        "kcore": (gu, lambda: KCore(k=4), {}, 32),
    }
    exs = {}
    for app, (graph, make, kw, _) in apps.items():
        t = time.perf_counter()
        ex = AdaptiveExecutor(graph, make())
        torch.cuda.synchronize()
        log(f"[gas] {app} executor (mode {ex.mode}) built in "
            f"{time.perf_counter() - t:.1f} s: nv={graph.nv} ne={graph.ne} "
            f"hi/lo counts {ex.hi_count}/{ex.lo_count} queue_cap="
            f"{ex.queue_cap} edge_budget={ex.edge_budget}")
        exs[app] = ex
    k_lanes = 8
    rng = np.random.default_rng(SEED)
    has_out = np.flatnonzero(g.out_degrees > 0)
    roots = [0] + sorted(int(r) for r in rng.choice(has_out, k_lanes - 1,
                                                    replace=False))
    t = time.perf_counter()
    mx = MultiSourceGasExecutor(g, BFS(), k=k_lanes)
    torch.cuda.synchronize()
    log(f"[gas] multi-source BFS executor (k={k_lanes}, roots {roots}) "
        f"built in {time.perf_counter() - t:.1f} s")

    # -- 4d. kernels against their plain versions -----------------------------
    reps = 10
    k10 = dict.fromkeys(("ms", "plain", "bytes", "ops", "lib"), 0.0)
    k11 = dict.fromkeys(("ms", "plain", "bytes", "ops", "lib"), 0.0)
    for app, ex in exs.items():
        graph, _, kw, _ = apps[app]
        prog = ex.program
        ex.run(**kw)
        dlog = ex.direction_log
        pulls = [(c, i) for i, (d, c, _) in enumerate(dlog) if d == 0]
        pushes = [(e, i) for i, (d, c, e) in enumerate(dlog)
                  if d == 1 and e > 0]
        log(f"[gas] {app}: adaptive log (direction, count, out-edges) "
            f"{dlog}")
        nv, ne = graph.nv, graph.ne
        weighted = prog.gather_op in seg.F32_GATHER_OPS
        # K10 on the pull iteration with the largest frontier.
        at = max(pulls)[1] if pulls else 0
        st, _ = ex.run(max_iters=at, **kw)
        args = (ex.row_ptr, ex.col_src, st.values, st.frontier,
                prog.combiner)

        def k10_call(args=args, prog=prog, ex=ex):
            return seg.gas_pull_acc(*args, prog.gather_op, ex.items,
                                    weights=ex.weights)

        def k10_plain(args=args, prog=prog, ex=ex):
            return seg.gas_pull_acc_plain(*args, prog.gather,
                                          weights=ex.weights)

        want = k10_plain()
        check_equal(f"K10 {app} iteration {at + 1}", k10_call(), want)
        ms = cuda_ms(k10_call, reps)
        plain_ms = cuda_ms(k10_plain, 2)
        # Yardstick: the reduce alone, one call over messages masked
        # beforehand (torch.segment_reduce has float kernels only, so the
        # uint32 programs take an int64 scatter_reduce).
        vals, dom = seg.gas_widen(st.values)
        src = ex.col_src.long()
        msg = torch.where(st.frontier[src],
                          prog.gather(vals[src], ex.weights),
                          seg.identity_for(prog.combiner, dom))
        if weighted:
            lib_ms = cuda_ms(lambda: torch.segment_reduce(
                msg, prog.combiner, offsets=ex.row_ptr, unsafe=True), reps)
        else:
            dst = torch.repeat_interleave(torch.arange(nv, device=dev),
                                          ex.row_ptr.diff())
            acc0 = torch.full((nv,), seg.identity_for(prog.combiner, dom),
                              dtype=torch.int64, device=dev)
            red = {"min": "amin", "max": "amax", "sum": "sum"}[prog.combiner]
            lib_ms = cuda_ms(lambda: acc0.scatter_reduce(
                0, dst, msg, reduce=red, include_self=True), reps)
            del dst, acc0
        del msg, vals, src, want
        nbytes = 4 * ne + 8 * (nv + 1) + 5 * nv + 4 * nv \
            + (4 * ne if weighted else 0)
        log(f"[gas] K10 {app} ({prog.combiner}, {prog.gather_op}) on "
            f"iteration {at + 1} (frontier {dlog[at][1]}): bitwise; "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, reduce yardstick "
            f"{lib_ms:.4f} ms, bytes bound {bound(nbytes, ne)[0]:.4f} ms")
        for key, v in (("ms", ms), ("plain", plain_ms), ("bytes", nbytes),
                       ("ops", ne), ("lib", lib_ms)):
            k10[key] += v
        # K11 on the push iteration with the most out-edges, and on the
        # pull state above (a large queue); the row times the former.
        cands = [(f"iteration {max(pushes)[1] + 1}",
                  ex.run(max_iters=max(pushes)[1], **kw)[0])] if pushes \
            else []
        cands.append((f"pull-state iteration {at + 1}", st))
        for i, (label, pst) in enumerate(cands):
            fr = pst.frontier
            cnt = int(fr.sum())
            out = int(torch.where(fr, ex.out_degrees, 0).sum())
            q, start, _, offs = fq.frontier_queue(fr, ex.csr_row_ptr, cnt)
            pargs = (q, start, offs, ex.csr_col_dst, pst.values,
                     prog.combiner)

            def k11_call(pargs=pargs, out=out, prog=prog, ex=ex):
                return fq.gas_push_acc(*pargs, prog.gather_op, out,
                                       weights=ex.csr_weights)

            def k11_plain(pargs=pargs, prog=prog, ex=ex):
                return fq.gas_push_acc_plain(*pargs, prog.gather,
                                             weights=ex.csr_weights)

            check_equal(f"K11 {app} {label}", k11_call(), k11_plain())
            check_equal(f"K10 = K11 {app} {label}", k11_call(),
                        seg.gas_pull_acc(ex.row_ptr, ex.col_src, pst.values,
                                         fr, prog.combiner, prog.gather_op,
                                         ex.items, weights=ex.weights))
            ms = cuda_ms(k11_call, reps)
            plain_ms = cuda_ms(k11_plain, 2)
            slot, edge = fq.queue_edges(q, start, offs)
            vals, dom = seg.gas_widen(pst.values)
            msg = prog.gather(vals[q.long()[slot]],
                              None if not weighted else ex.csr_weights[edge])
            dst = ex.csr_col_dst[edge].long()
            acc0 = torch.full((nv,), seg.identity_for(prog.combiner, dom),
                              dtype=msg.dtype, device=dev)
            red = {"min": "amin", "max": "amax", "sum": "sum"}[prog.combiner]
            lib_ms = cuda_ms(lambda: acc0.scatter_reduce(
                0, dst, msg, reduce=red, include_self=True), reps)
            del slot, edge, vals, msg, dst, acc0
            nbytes = 24 * cnt + 8 + 4 * out * (2 if weighted else 1) \
                + 4 * nv
            log(f"[gas] K11 {app} {label}: cnt={cnt} out_edges={out}; "
                f"bitwise, equal to K10; {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, scatter_reduce {lib_ms:.4f} ms, bytes bound "
                f"{bound(nbytes, out)[0]:.4f} ms")
            if i == 0 and pushes:
                for key, v in (("ms", ms), ("plain", plain_ms),
                               ("bytes", nbytes), ("ops", out),
                               ("lib", lib_ms)):
                    k11[key] += v
        del st, cands, args
        torch.cuda.empty_cache()
    # K10 with 8 columns, on the multi-source state with the largest
    # frontier.
    st = mx.init_state(roots)
    best = (int(st.frontier.sum()), 0, st)
    for i in range(1, 32):
        st, cnt = mx.step(st)
        if cnt > best[0]:
            best = (cnt, i, st)
        if cnt == 0:
            break
    cnt, at, st = best
    margs = (mx.row_ptr, mx.col_src, st.values, st.frontier, "min")
    check_equal(f"K10 k={k_lanes} after {at} iterations",
                seg.gas_pull_acc(*margs, "add1", mx.items),
                seg.gas_pull_acc_plain(*margs, BFS().gather))
    ms = cuda_ms(lambda: seg.gas_pull_acc(*margs, "add1", mx.items), reps)
    plain_ms = cuda_ms(lambda: seg.gas_pull_acc_plain(*margs, BFS().gather),
                       2)
    mbytes = 4 * g.ne + 8 * (g.nv + 1) + 9 * g.nv * k_lanes
    log(f"[gas] K10 k={k_lanes} (multi-source BFS, {cnt} active lane "
        f"entries after {at} iterations): bitwise; {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bytes bound {bound(mbytes, g.ne * k_lanes)[0]:.4f}"
        " ms")
    del st, margs, best
    record(kernels, "gas_pull_acc", "lux_tpu_torch/csrc/gas.cu",
           "lux_tpu/engine/gas.py:349", 0.0, k10["ms"], k10["plain"],
           k10["bytes"], k10["ops"], k10["lib"])
    record(kernels, "gas_push_acc", "lux_tpu_torch/csrc/gas.cu",
           "lux_tpu/engine/gas.py:363", 0.0, k11["ms"], k11["plain"],
           k11["bytes"], k11["ops"], k11["lib"])
    torch.cuda.empty_cache()

    # -- 5d. end to end -------------------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)

    def counted(fn):
        _cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        for name, n in counts.items():
            totals[name] += n
        return out, counts

    oracles = {}
    t = time.perf_counter()
    oracles["bfs"] = reference_bfs(g, 0)
    log(f"[gas] bfs oracle (numpy BFS, parents) in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    oracles["sssp_delta"] = reference_sssp_delta(gw, 0)
    log(f"[gas] sssp_delta oracle (scipy Dijkstra) in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    oracles["labelprop"] = reference_labelprop(g)
    log(f"[gas] labelprop oracle (numpy) in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    oracles["kcore"] = reference_kcore(gu, 4)
    log(f"[gas] kcore oracle (numpy peeling) in "
        f"{time.perf_counter() - t:.1f} s")
    for app, (graph, make, kw, _) in apps.items():
        want = oracles[app][0] if app == "bfs" else oracles[app]
        results = {}
        for mode in ("adaptive", "pull", "push"):
            ex = exs[app] if mode == "adaptive" else AdaptiveExecutor(
                graph, make(), mode=mode)
            (st, iters), counts = counted(lambda: ex.run(**kw))
            vals = ex.values(st)
            if vals.shape != (graph.nv,) or vals.dtype != want.dtype:
                raise AssertionError(f"{app} {mode}: bad output "
                                     f"{vals.shape} {vals.dtype}")
            if not np.array_equal(vals, want):
                raise AssertionError(
                    f"{app} {mode}: {int(np.sum(vals != want))} values "
                    "differ from the oracle")
            fin = ex.finalize(st)
            if app == "bfs" and not np.array_equal(fin["parent"],
                                                   oracles["bfs"][1]):
                raise AssertionError(f"bfs {mode}: parents differ")
            if app == "sssp_delta":
                viol = count_violations(graph, st.values, ex.program)
                if viol:
                    raise AssertionError(f"sssp_delta {mode}: {viol} "
                                         "invariant violations")
            ofin = ex.program.finalize_host(graph, want)
            for key, v in ofin.items():
                if not np.array_equal(np.asarray(fin[key]), np.asarray(v)):
                    raise AssertionError(f"{app} {mode}: {key} differs")
            check_launches(f"{app} {mode}", counts,
                           _gas_expected(ex.direction_log))
            results[mode] = (vals, iters, ex.push_iters, ex.pull_iters,
                             ex.direction_switches)
            extra = {k: v for k, v in ofin.items()
                     if not isinstance(v, np.ndarray)}
            log(f"[gas] {app} {mode}: fixpoint in {iters} iterations "
                f"({ex.push_iters} push, {ex.pull_iters} pull, "
                f"{ex.direction_switches} switches) matches the oracle "
                f"bitwise {extra}; launches "
                f"{ {k: counts[k] for k in GAS_KERNELS} }")
            if mode != "adaptive":
                del ex
                torch.cuda.empty_cache()
        for mode in ("pull", "push"):
            if not np.array_equal(results[mode][0], results["adaptive"][0]):
                raise AssertionError(f"{app}: {mode} differs from adaptive")
    # Multi-source lanes against single-source runs.
    (st, iters), counts = counted(lambda: mx.run(roots))
    check_launches("multi-source bfs", counts, {"gas_pull_acc": iters})
    ex = exs["bfs"]
    for j, r in enumerate(roots):
        single, _ = ex.run(start=r)
        if not np.array_equal(mx.values_for(st, j), ex.values(single)):
            raise AssertionError(f"multi-source lane {j} (root {r}) differs")
    log(f"[gas] multi-source bfs: {k_lanes} lanes in {iters} iterations "
        f"equal the single-source runs; launches {counts['gas_pull_acc']}")
    del st, single
    # PageRank through the pull adapter.
    ex_pr = AdaptiveExecutor(g, as_gas(PageRank()))
    (st, iters), counts = counted(lambda: ex_pr.run(max_iters=ITERS))
    out = ex_pr.values(st)
    if out.shape != (g.nv,) or not np.all(np.isfinite(out)):
        raise AssertionError(f"gas pagerank: bad output {out.shape}")
    np.testing.assert_allclose(out, pr_oracle, rtol=RTOL, atol=ATOL,
                               err_msg="gas pagerank vs f64 oracle")
    check_launches("gas pagerank", counts, {"gather_segment_sum": ITERS})
    log(f"[gas] pagerank through PullGasAdapter: run({ITERS}) (mode "
        f"{ex_pr.mode}) matches the f64 oracle (max abs err "
        f"{float(np.max(np.abs(out.astype(np.float64) - pr_oracle))):.3e})")
    del ex_pr, st, out
    for name in GAS_KERNELS:
        if totals[name] <= 0:
            raise AssertionError(f"{name} never ran on the GAS path")
    torch.cuda.empty_cache()

    # -- 6d. timing -----------------------------------------------------------
    for app, (graph, _, kw, max_iters) in apps.items():
        ex = exs[app]
        ex.warmup(**kw)
        secs = [host_seconds(lambda: ex.run(max_iters=max_iters, **kw))
                for _ in range(3)]
        sec = float(np.median(secs))
        iters = len(ex.direction_log)
        log(f"[time] gas {app}: {iters} iterations ({ex.push_iters} push/"
            f"{ex.pull_iters} pull, {ex.direction_switches} switches; "
            f"max_iters {max_iters}) in {sec * 1e3:.3f} ms (median of 3: "
            f"{[round(x * 1e3, 3) for x in secs]}), "
            f"{sec / iters * 1e3:.3f} ms/iteration, "
            f"{graph.ne * iters / sec / 1e9:.3f} GTEPS")
        st0 = ex.init_state(**kw)
        iter_sec = float(np.median([host_seconds(
            lambda: ex.run(max_iters=max_iters, state=st0))
            for _ in range(3)]))
        busy = device_busy(lambda: ex.run(max_iters=max_iters, state=st0))
        if busy is None:
            log(f"[time] gas {app}: run from a device state "
                f"{iter_sec * 1e3:.3f} ms; device busy share not measured "
                "(the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] gas {app}: run from a device state "
                f"{iter_sec * 1e3:.3f} ms; device busy {busy_ms:.3f} ms "
                f"({busy_ms / (iter_sec * 1e3):.1%}; torch.profiler); top "
                "kernels (ms): " + ", ".join(f"{n}={v:.3f}" for n, v in top))
        st = ex.init_state(**kw)
        split = {}
        for _ in range(max_iters):
            st, cnt, times = ex.phase_step(st)
            split.setdefault(times.pop("direction"), []).append(times)
            if cnt == 0:
                break
        for direction, runs in sorted(split.items()):
            med = {k: float(np.median([r[k] for r in runs])) * 1e3
                   for k in runs[0]}
            log(f"[time] gas {app} {direction} phases (ms, median of "
                f"{len(runs)}): " + ", ".join(
                    f"{k}={v:.3f}" for k, v in med.items()))
        del st, st0
    return totals


SHARDED_PARTS = 4


def _sharded_phases(g, pr_oracle, gc, cf_oracle, dev) -> dict:
    """Phases 3e-6e on the sharded pull engine: PageRank on ``g`` in the
    full and compact exchange modes and CF on the ratings graph ``gc``,
    each over ``SHARDED_PARTS`` parts of a ``LocalMesh`` on the card;
    returns the launch counts of the phase 5e runs, summed."""
    import torch

    from lux_tpu_torch.engine.pull import PullExecutor
    from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
    from lux_tpu_torch.entry import dryrun_multichip
    from lux_tpu_torch.models import CollaborativeFiltering, PageRank
    from lux_tpu_torch.models.colfilter import K
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import segment as seg
    from lux_tpu_torch.parallel.mesh import make_mesh
    from lux_tpu_torch.parallel.shard import ShardedGraph, resolve_exchange
    from lux_tpu_torch.utils.logging import get_logger

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P = SHARDED_PARTS
    mesh = make_mesh(P, dev)
    flag = os.environ.get("LUX_EXCHANGE")

    # -- 3e. shard layouts and executors ----------------------------------------
    sgs = {}
    for name, graph, width in (("rmat", g, 1), ("ratings", gc, K)):
        t = time.perf_counter()
        sg = ShardedGraph.build(graph, P)
        plan = sg.exchange_plan()
        built = time.perf_counter() - t
        os.environ["LUX_EXCHANGE"] = "compact"
        mode, _ = resolve_exchange(sg, get_logger("engine"))
        full = P * (P - 1) * sg.max_nv * 4 * width
        log(f"[sharded] {name}: nv={graph.nv} ne={graph.ne} P={P} "
            f"max_nv={sg.max_nv} max_ne={sg.max_ne} part nv="
            f"{sg.local_nv.tolist()} part ne="
            f"{sg.local_row_ptr[:, -1].tolist()}; capacity {plan.capacity} "
            f"(profitable {plan.profitable}), compact resolves to {mode}; "
            f"exchange bytes per iteration at {4 * width} B rows: full "
            f"{full}, compact {plan.exchange_bytes_per_iter(4 * width)}; "
            f"built in {built:.1f} s")
        sgs[name] = sg
    exs = {}
    for label, graph, prog, sg, mode in (
            ("pagerank full", g, PageRank(), sgs["rmat"], "full"),
            ("pagerank compact", g, PageRank(), sgs["rmat"], "compact"),
            ("cf", gc, CollaborativeFiltering(), sgs["ratings"], "full")):
        os.environ["LUX_EXCHANGE"] = mode
        t = time.perf_counter()
        ex = ShardedPullExecutor(graph, prog, mesh=mesh, sg=sg)
        torch.cuda.synchronize()
        log(f"[sharded] {label} executor (LUX_EXCHANGE={mode}, resolved "
            f"{ex.exchange_mode}) built in {time.perf_counter() - t:.1f} s; "
            f"work items per part {[p.items.n_items for p in ex._parts]}; "
            f"exchange_bytes_per_iter {ex.exchange_bytes_per_iter()}")
        if ex.exchange_mode != mode:
            raise AssertionError(f"{label}: resolved {ex.exchange_mode}")
        exs[label] = ex
    if flag is None:
        del os.environ["LUX_EXCHANGE"]
    else:
        os.environ["LUX_EXCHANGE"] = flag

    # -- 4e. K8 and K9 on one part's flat table, against the plain versions ----
    for label, q in (("pagerank compact", P - 1), ("cf", P - 1)):
        ex = exs[label]
        part = ex._parts[q]
        vals = ex.init_values()
        table = ex._table(ex._exchange(vals), q)
        got = seg.pull_sum(table, part.row_ptr, part.col_src, part.weights,
                           ex.program.edge_op, ex._edge_fn, part.items, 0,
                           "rowptr", part.row_base)
        want = seg.pull_sum_plain(table, part.row_ptr, part.col_src,
                                  part.weights, ex._edge_fn, window=1 << 20,
                                  row_base=part.row_base)
        tol = (dict(rtol=CF_RTOL, atol=CF_ATOL) if label == "cf"
               else dict(rtol=RTOL, atol=ATOL))
        err = check_close(f"{label} part {q}", got, want, **tol)
        log(f"[sharded] {label}: part {q}'s kernel (row_base "
            f"{part.row_base}, {part.col_src.numel()} edges) matches its "
            f"plain version (max abs err {err:.3e})")
        del table, got, want

    # -- 5e. end to end ---------------------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    outs = {}
    for label, iters, oracle, tol in (
            ("pagerank full", ITERS, pr_oracle, dict(rtol=RTOL, atol=ATOL)),
            ("pagerank compact", ITERS, pr_oracle,
             dict(rtol=RTOL, atol=ATOL)),
            ("cf", CF_ITERS, cf_oracle, dict(rtol=CF_RTOL, atol=CF_ATOL))):
        ex = exs[label]
        kernel = "cf_edge_sum" if label == "cf" else "gather_segment_sum"
        _cuda.reset_launches()
        out = ex.run(iters)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        got = ex.gather_values(out)
        if got.shape != oracle.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"sharded {label}: bad output {got.shape}")
        np.testing.assert_allclose(got, oracle, err_msg=f"sharded {label}",
                                   **tol)
        err = float(np.max(np.abs(got.astype(np.float64) - oracle)))
        check_launches(f"sharded {label}", counts, {kernel: P * iters})
        log(f"[sharded] {label}: run({iters}) matches the f64 oracle (max "
            f"abs err {err:.3e}); launches {counts[kernel]} = {P} parts x "
            f"{iters} iterations")
        for name, n in counts.items():
            totals[name] += n
        outs[label] = (out, got)
    check_equal("sharded pagerank compact vs full",
                outs["pagerank compact"][0], outs["pagerank full"][0])
    log("[sharded] pagerank: compact equals full bitwise")
    for label, graph, prog, iters in (
            ("pagerank full", g, PageRank(), ITERS),
            ("cf", gc, CollaborativeFiltering(), CF_ITERS)):
        single = PullExecutor(graph, prog).run(iters).cpu().numpy()
        same = np.array_equal(outs[label][1], single)
        log(f"[sharded] {label}: equals the single-device PullExecutor "
            f"bitwise: {same} (max abs diff "
            f"{float(np.max(np.abs(outs[label][1] - single))):.3e})")
        del single
    del outs

    # -- 6e. timing -------------------------------------------------------------
    for label, graph, iters in (("pagerank full", g, ITERS),
                                ("pagerank compact", g, ITERS),
                                ("cf", gc, CF_ITERS)):
        ex = exs[label]
        ex.warmup()
        vals = ex.init_values()
        secs = [host_seconds(lambda: ex.run(iters, vals=vals))
                for _ in range(3)]
        sec = float(np.median(secs))
        ev_ms = cuda_ms(lambda: ex.run(iters, vals=vals), 3) / iters
        runs = [ex.phase_step(vals)[1] for _ in range(5)]
        split = {k: float(np.median([r[k] for r in runs])) * 1e3
                 for k in runs[0]}
        log(f"[time] sharded {label}: {sec / iters * 1e3:.3f} ms/iteration, "
            f"{graph.ne * iters / sec / 1e9:.3f} GTEPS (host clock, median "
            f"of 3 runs of {iters}: {[round(x * 1e3, 3) for x in secs]} ms);"
            f" {ev_ms:.3f} ms/iteration by CUDA events (mean of 3); "
            "phase_step split (ms, median of 5): " + ", ".join(
                f"{k}={v:.3f}" for k, v in split.items()))
        busy = device_busy(lambda: ex.run(iters, vals=vals))
        if busy is None:
            log(f"[time] sharded {label}: device busy share not measured "
                "(the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] sharded {label}: device busy {busy_ms:.3f} ms of "
                f"{sec * 1e3:.3f} ms ({busy_ms / (sec * 1e3):.1%}; "
                "torch.profiler); top kernels (ms): "
                + ", ".join(f"{n}={v:.3f}" for n, v in top))
        # The exchange alone: its input, the (P, max_nv, *t) values, read
        # once, and its output, the tables the parts read, written once.
        x_ms = cuda_ms(lambda: ex._exchange(vals), 10)
        flat = ex._exchange(vals)
        out_bytes = 0 if ex._xplan is None else flat.numel() * 4
        in_bytes = 0 if ex._xplan is None else vals.numel() * 4
        b_ms, _ = bound(in_bytes + out_bytes, 0)
        log(f"[time] sharded {label} exchange ({ex.exchange_mode}): "
            f"{x_ms:.4f} ms (mean of 10, CUDA events) against a bytes bound "
            f"of {b_ms:.4f} ms ({in_bytes + out_bytes} B); "
            f"{ex.exchange_bytes_per_iter()} B per iteration priced as "
            "interconnect bytes")
        del flat, vals
    del exs
    log(f"[sharded] peak device memory of phases 3e-6e "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    _cuda.reset_launches()
    dryrun_multichip(P)
    log(f"[sharded] dryrun_multichip({P}) passed on the card; launches "
        f"{ {k: v for k, v in _cuda.LAUNCHES.items() if v} }; phases 3e-6e "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return totals


MULTI_LANES = 8


def _push_sharded_phases(g, gu, push, dev, kernels) -> dict:
    """Phases 3f-6f on the multi-source and sharded push engines: SSSP
    from vertex 0 on ``g`` over ``SHARDED_PARTS`` parts in the full and
    compact exchange modes, CC on the closure ``gu``, and 8-lane
    multi-source SSSP on one device and over the parts. ``push`` is
    phase 5b's context (oracles, iterations, ms to fixpoint, the SSSP
    executor). Returns the launch counts of the phase 5f runs, summed,
    and under ``<kernel>[split]`` those of the split-table calls."""
    import torch

    from lux_tpu_torch.engine.check import count_violations
    from lux_tpu_torch.engine.push import MultiSourcePushExecutor
    from lux_tpu_torch.engine.push_sharded import (
        ShardedMultiSourcePushExecutor,
        ShardedPushExecutor,
    )
    from lux_tpu_torch.models import SSSP, ConnectedComponents
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops import frontier as fq
    from lux_tpu_torch.ops import segment as seg
    from lux_tpu_torch.parallel.mesh import make_mesh
    from lux_tpu_torch.parallel.shard import ShardedGraph

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P, K = SHARDED_PARTS, MULTI_LANES
    mesh = make_mesh(P, dev)
    flag = os.environ.get("LUX_EXCHANGE")
    reps = 10

    # -- 3f. host set-up ----------------------------------------------------
    sgs = {}
    for name, graph in (("rmat", g), ("closure", gu)):
        t = time.perf_counter()
        sg = ShardedGraph.build(graph, P)
        t_sg = time.perf_counter() - t
        t = time.perf_counter()
        sg.build_push_csr()     # cached on sg: the executors share it
        t_csr = time.perf_counter() - t
        plan = sg.exchange_plan()
        log(f"[push-sharded] {name}: nv={graph.nv} ne={graph.ne} P={P} "
            f"max_nv={sg.max_nv} ({P * sg.max_nv / graph.nv:.3f} nv padded "
            f"rows) max_ne={sg.max_ne} part nv={sg.local_nv.tolist()}; "
            f"layout {t_sg:.1f} s, push CSR {t_csr:.1f} s; compact capacity "
            f"{plan.capacity} (profitable {plan.profitable}); exchange bytes "
            f"per iteration at 5 B rows: full {P * (P - 1) * sg.max_nv * 5},"
            f" compact {plan.exchange_bytes_per_iter(5)}")
        sgs[name] = sg
    rng = np.random.default_rng(0)
    has_out = np.flatnonzero(g.out_degrees > 0)
    roots = [0] + rng.choice(has_out[has_out != 0], K - 1,
                             replace=False).tolist()
    exs = {}
    for label, graph, prog, sg, mode, lanes in (
            ("sssp full", g, SSSP(), sgs["rmat"], "full", 0),
            ("sssp compact", g, SSSP(), sgs["rmat"], "compact", 0),
            ("cc", gu, ConnectedComponents(), sgs["closure"], None, 0),
            ("multi full", g, SSSP(), sgs["rmat"], "full", K),
            ("multi compact", g, SSSP(), sgs["rmat"], "compact", K)):
        if mode is None:
            os.environ.pop("LUX_EXCHANGE", None)
        else:
            os.environ["LUX_EXCHANGE"] = mode
        t = time.perf_counter()
        if lanes:
            ex = ShardedMultiSourcePushExecutor(graph, prog, lanes,
                                                mesh=mesh, sg=sg)
            what = f"k={lanes}"
        else:
            ex = ShardedPushExecutor(graph, prog, mesh=mesh, sg=sg)
            what = (f"blocked_dense={ex.blocked_dense} sparse={ex.sparse} "
                    f"queue_cap={ex.queue_cap} edge_budget="
                    f"{ex.edge_budget} tiers={ex.tiers}")
        torch.cuda.synchronize()
        log(f"[push-sharded] {label} executor (LUX_EXCHANGE="
            f"{mode or 'unset'}, resolved {ex.exchange_mode}) built in "
            f"{time.perf_counter() - t:.1f} s: {what}; "
            f"exchange_bytes_per_iter {ex.exchange_bytes_per_iter()}")
        if ex.exchange_mode != (mode or "full"):
            raise AssertionError(f"{label}: resolved {ex.exchange_mode}")
        exs[label] = ex
    if flag is None:
        os.environ.pop("LUX_EXCHANGE", None)
    else:
        os.environ["LUX_EXCHANGE"] = flag
    t = time.perf_counter()
    mx1 = MultiSourcePushExecutor(g, SSSP(), K)
    torch.cuda.synchronize()
    log(f"[push-sharded] single-device multi-source executor (k={K}) built "
        f"in {time.perf_counter() - t:.1f} s; roots {roots}")

    # -- 4f. the kernels at the sharded path's shapes -----------------------
    # K5 on the dense iteration of the full-mode SSSP run with the largest
    # frontier, for the part with the most edges: over the packed flat
    # table (full) and over its receiver's table of values and frontier
    # (compact).
    ex = exs["sssp full"]
    ex.run(start=0)
    branches = list(ex.branch_log)
    relax = seg.RELAX_OPS["add1"]
    n = ex.sg.max_nv
    dense_at = [(e[1], i) for i, e in enumerate(branches) if e[0] == 0]
    if not dense_at:
        raise AssertionError("sharded SSSP took no dense iteration")
    _, at = max(dense_at)
    st, _ = ex.run(max_iters=at, start=0)
    q = int(np.argmax([pt.col_src.numel() for pt in ex._parts]))
    n_e = ex._parts[q].col_src.numel()
    n_src = int(torch.unique(ex._parts[q].col_src).numel())
    for form, x in (("full", ex), ("compact", exs["sssp compact"])):
        table, front = x._dense_load(st)
        pt = x._parts[q]
        k5_args = (pt.row_ptr, pt.col_src, x._table(table, q),
                   x._table(front, q), "min")

        def k5_call(k5_args=k5_args, items=pt.items):
            return seg.segment_minmax_relax(*k5_args, "add1", items)

        check_equal(f"K5 sharded {form}, part {q}", k5_call(),
                    seg.segment_minmax_relax_plain(*k5_args, relax))
        k5_ms = cuda_ms(k5_call, reps)
        k5_plain = cuda_ms(lambda k5_args=k5_args: (
            seg.segment_minmax_relax_plain(*k5_args, relax)), 2)
        # The part's edges and offsets, its sources' rows of the table
        # (a packed word, or a value and a frontier byte), its output.
        k5_bytes = 4 * n_e + 8 * (n + 1) + 4 * n \
            + (4 if front is None else 5) * n_src
        what = "packed" if front is None else "values and frontier"
        log(f"[push-sharded] K5 {form} ({what}) on SSSP iteration "
            f"{at + 1}, part {q} ({n_e} edges from {n_src} "
            f"sources, a {tuple(k5_args[2].shape)} table): bitwise; "
            f"{k5_ms:.4f} ms (plain {k5_plain:.4f}, bytes bound "
            f"{bound(k5_bytes, n_e)[0]:.4f})")
        record(kernels, f"segment_minmax_relax[sharded {form}]",
               "lux_tpu_torch/csrc/push_dense.cu",
               "lux_tpu/engine/push.py:1110", 0.0, k5_ms, k5_plain,
               k5_bytes, n_e, None)
        del table, front, k5_args
    del st

    # K6 and K7 on the sparse iteration of that run with the most
    # out-edges. K6 on the part with the largest frontier, as the sparse
    # branch calls it; K7 with the flat pre-step stack as values, the
    # receiving part with the most queued edges, its push_dst_local, out
    # its row.
    sparse_at = [(e[2], i) for i, e in enumerate(branches) if e[0] > 0]
    if not sparse_at:
        raise AssertionError("sharded SSSP took no sparse iteration")
    _, at = max(sparse_at)
    st, _ = ex.run(max_iters=at, start=0)
    stats = ex._frontier_stats(st)
    p6 = int(np.argmax(stats[2]))
    fr6, cnt6, rp6 = st.frontier[p6], stats[2][p6], ex._queue_row_ptr
    for name, got, want in zip(("q", "start", "deg", "offs"),
                               fq.frontier_queue(fr6, rp6, cnt6),
                               fq.frontier_queue_plain(fr6, rp6)):
        check_equal(f"K6 sharded {name}, part {p6}", got, want)
    k6_ms = cuda_ms(lambda: fq.frontier_queue(fr6, rp6, cnt6), reps)
    k6_plain = cuda_ms(lambda: fq.frontier_queue_plain(fr6, rp6), reps)
    k6_lib = cuda_ms(lambda: torch.nonzero(fr6), reps)
    k6_bytes = n + 16 * cnt6 + 28 * cnt6 + 8
    log(f"[push-sharded] K6 on SSSP iteration {at + 1}, part {p6} "
        f"({cnt6} of {stats[0]} queued vertices): bitwise; {k6_ms:.4f} ms "
        f"(plain {k6_plain:.4f}, torch.nonzero {k6_lib:.4f}, bytes bound "
        f"{bound(k6_bytes, 0)[0]:.4f})")
    record(kernels, "frontier_queue[sharded]",
           "lux_tpu_torch/csrc/frontier.cu", "lux_tpu/engine/push.py:1206",
           0.0, k6_ms, k6_plain, k6_bytes, cnt6, k6_lib)
    del fr6, rp6
    rows, ids = ex._sparse_load(st, stats)
    start = ex.push_row_ptr[:, ids]
    offs = torch.nn.functional.pad(
        (ex.push_row_ptr[:, ids + 1] - start).cumsum(1), (1, 0))
    totals = offs[:, -1].tolist()
    p = int(np.argmax(totals))
    total, cnt = totals[p], rows.numel()
    flat = st.values.view(-1)
    k7_args = (rows, start[p].contiguous(), offs[p].contiguous(),
               ex.push_dst_local[p], flat, "min")
    want = fq.queue_relax_scatter_plain(*k7_args, relax,
                                        out=st.values[p].clone())
    check_equal(f"K7 split table, part {p}", fq.queue_relax_scatter(
        *k7_args, "add1", total, out=st.values[p].clone()), want)
    out_row = st.values[p].clone()
    k7_ms = cuda_ms(lambda: fq.queue_relax_scatter(
        *k7_args, "add1", total, out=out_row), reps)
    k7_plain = cuda_ms(lambda: fq.queue_relax_scatter_plain(
        *k7_args, relax, out=st.values[p].clone()), reps)
    slot = torch.repeat_interleave(torch.arange(cnt, device=dev),
                                   k7_args[2].diff())
    edge = k7_args[1][slot] + torch.arange(total, device=dev) \
        - k7_args[2][:-1][slot]
    dst_e = ex.push_dst_local[p][edge].long()
    cand = relax(seg.widen_u32(flat)[rows.long()[slot]])
    row64 = seg.widen_u32(st.values[p])
    k7_lib = cuda_ms(lambda: row64.scatter_reduce(
        0, dst_e, cand, reduce="amin", include_self=True), reps)
    n_dst = int(torch.unique(dst_e).numel())
    del slot, edge, dst_e, cand, row64, want
    # The queue's q, start and offs and its values, col_dst at the
    # part's queued edges, and out read and written at their distinct
    # destinations: out is the caller's row, so nothing is copied.
    k7_bytes = 24 * cnt + 8 + 4 * total + 8 * n_dst
    log(f"[push-sharded] K7 split table on SSSP iteration {at + 1} (queue "
        f"{cnt} over {P} parts, part {p} receives {total} of "
        f"{sum(totals)} edges at {n_dst} vertices): bitwise; "
        f"{k7_ms:.4f} ms (plain {k7_plain:.4f}, scatter_reduce "
        f"{k7_lib:.4f}, bytes bound "
        f"{bound(k7_bytes, total)[0]:.4f})")
    record(kernels, "queue_relax_scatter[split]",
           "lux_tpu_torch/csrc/frontier.cu", "lux_tpu/engine/push.py:1214",
           0.0, k7_ms, k7_plain, k7_bytes, total, k7_lib)
    del st, rows, ids, start, offs, flat, k7_args, out_row
    torch.cuda.empty_cache()

    # K10 with K columns over the flat (P * max_nv, K) table, for the
    # part with the most edges, on the multi-source state with the
    # largest frontier.
    mx = exs["multi full"]
    st = mx.init_state(roots)
    best = (int(st.frontier.sum()), 0, st)
    for i in range(1, 32):
        st, c = mx.step(st)
        if c > best[0]:
            best = (c, i, st)
        if c == 0:
            break
    c, at, st = best
    table, front = mx._load(st)
    q = int(np.argmax([pt.col_src.numel() for pt in mx._parts]))
    part = mx._parts[q]
    n_e = part.col_src.numel()
    k10_args = (part.row_ptr, part.col_src, table, front, "min")
    want = seg.gas_pull_acc_plain(*k10_args, SSSP().relax)
    check_equal(f"K10 split table k={K}, part {q}",
                seg.gas_pull_acc(*k10_args, "add1", part.items), want)
    k10_ms = cuda_ms(lambda: seg.gas_pull_acc(*k10_args, "add1",
                                              part.items), reps)
    k10_plain = cuda_ms(lambda: seg.gas_pull_acc_plain(
        *k10_args, SSSP().relax), 2)
    src = part.col_src.long()
    msg = torch.where(front[src], relax(seg.widen_u32(table[src])),
                      seg.identity_for("min", np.uint32))
    dst = torch.repeat_interleave(torch.arange(n, device=dev),
                                  part.row_ptr.diff())[:, None].expand(-1, K)
    acc0 = torch.full((n, K), seg.identity_for("min", np.uint32),
                      dtype=torch.int64, device=dev)
    k10_lib = cuda_ms(lambda: acc0.scatter_reduce(
        0, dst, msg, reduce="amin", include_self=True), reps)
    del src, msg, dst, acc0, want
    k10_bytes = 4 * n_e + 8 * (n + 1) + 5 * g.nv * K + 4 * n * K
    log(f"[push-sharded] K10 split table k={K} on part {q} ({n_e} edges, "
        f"{c} active lane entries after {at} iterations, a "
        f"({P * n}, {K}) table): bitwise; {k10_ms:.4f} ms (plain "
        f"{k10_plain:.4f}, scatter_reduce {k10_lib:.4f}, bytes bound "
        f"{bound(k10_bytes, n_e * K)[0]:.4f})")
    record(kernels, "gas_pull_acc[split]", "lux_tpu_torch/csrc/gas.cu",
           "lux_tpu/engine/push.py:1708", 0.0, k10_ms, k10_plain, k10_bytes,
           n_e * K, k10_lib)
    del st, best, table, front, k10_args
    # B11: K10 with K columns on one device, on the single-device
    # multi-source state with the largest frontier.
    st = mx1.init_state(roots)
    best = (int(st.frontier.sum()), 0, st)
    for i in range(1, 32):
        st, c = mx1.step(st)
        if c > best[0]:
            best = (c, i, st)
        if c == 0:
            break
    c, at, st = best
    b11_args = (mx1.row_ptr, mx1.col_src, st.values, st.frontier, "min")
    check_equal(f"K10 k={K} one device", seg.gas_pull_acc(
        *b11_args, "add1", mx1.items), seg.gas_pull_acc_plain(
            *b11_args, SSSP().relax))
    b11_ms = cuda_ms(lambda: seg.gas_pull_acc(*b11_args, "add1",
                                              mx1.items), reps)
    b11_plain = cuda_ms(lambda: seg.gas_pull_acc_plain(
        *b11_args, SSSP().relax), 2)
    # The same reduce in one PyTorch call: an int64 scatter_reduce of the
    # masked (ne, K) messages, as the split-table row above measures it.
    src = mx1.col_src.long()
    msg = torch.where(st.frontier[src], relax(seg.widen_u32(st.values[src])),
                      seg.identity_for("min", np.uint32))
    dst = torch.repeat_interleave(torch.arange(g.nv, device=dev),
                                  mx1.row_ptr.diff())[:, None].expand(-1, K)
    acc0 = torch.full((g.nv, K), seg.identity_for("min", np.uint32),
                      dtype=torch.int64, device=dev)
    b11_lib = cuda_ms(lambda: acc0.scatter_reduce(
        0, dst, msg, reduce="amin", include_self=True), reps)
    del src, msg, dst, acc0
    b11_bytes = 4 * g.ne + 8 * (g.nv + 1) + 9 * g.nv * K
    log(f"[push-sharded] K10 k={K} on one device (multi-source SSSP, {c} "
        f"active lane entries after {at} iterations): bitwise; "
        f"{b11_ms:.4f} ms (plain {b11_plain:.4f}, scatter_reduce "
        f"{b11_lib:.4f}, bytes bound {bound(b11_bytes, g.ne * K)[0]:.4f})")
    del st, best, b11_args
    torch.cuda.empty_cache()

    # -- 5f. end to end -------------------------------------------------------
    totals = dict.fromkeys(_cuda.LAUNCHES, 0)
    totals.update(dict.fromkeys(
        ("segment_minmax_relax[sharded full]",
         "segment_minmax_relax[sharded compact]", "frontier_queue[sharded]",
         "queue_relax_scatter[split]", "gas_pull_acc[split]"), 0))

    def counted(fn):
        _cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        for name, v in counts.items():
            totals[name] += v
        return out, counts

    finals = {}
    for label, app, kw in (("sssp full", "sssp", {"start": 0}),
                           ("sssp compact", "sssp", {"start": 0}),
                           ("cc", "cc", {})):
        ex = exs[label]
        (st, iters), counts = counted(lambda: ex.run(**kw))
        vals = ex.gather_values(st)
        ref = push[app]
        if vals.shape != (ex.graph.nv,) or vals.dtype != np.uint32:
            raise AssertionError(f"{label}: bad output {vals.shape}")
        if not np.array_equal(vals, ref["oracle"]):
            raise AssertionError(
                f"sharded {label}: {int(np.sum(vals != ref['oracle']))} "
                "values differ from the oracle")
        viol = count_violations(ex.graph, vals, ex.program)
        if viol:
            raise AssertionError(f"sharded {label}: {viol} violations")
        if iters != ref["iters"]:
            raise AssertionError(f"sharded {label}: {iters} iterations, "
                                 f"single-device {ref['iters']}")
        with_edges = sum(1 for pt in ex._parts if pt.col_src.numel())
        dense = iters - ex.sparse_iters
        check_launches(f"sharded {label}", counts, {
            "segment_minmax_relax": with_edges * dense,
            "frontier_queue": sum(k6 for k6, _ in ex.queue_log),
            "queue_relax_scatter": sum(k7 for _, k7 in ex.queue_log)})
        form = "compact" if ex._xch is not None else "full"
        totals[f"segment_minmax_relax[sharded {form}]"] += \
            counts["segment_minmax_relax"]
        totals["frontier_queue[sharded]"] += counts["frontier_queue"]
        totals["queue_relax_scatter[split]"] += counts["queue_relax_scatter"]
        log(f"[push-sharded] {label}: fixpoint in {iters} iterations "
            f"({ex.sparse_iters} sparse; single-device {ref['iters']} "
            f"({ref['sparse_iters']} sparse)) matches the oracle and the "
            f"single-device PushExecutor bitwise, 0 violations; branches "
            f"{[e[:3] for e in ex.branch_log]}; queues (K6, K7 launches) "
            f"{ex.queue_log}; launches K5 {counts['segment_minmax_relax']} "
            f"= {with_edges} parts x {dense} dense, K6 "
            f"{counts['frontier_queue']}, K7 {counts['queue_relax_scatter']}")
        finals[label] = st
    for part in ("values", "frontier"):
        check_equal(f"sharded sssp compact vs full {part}",
                    getattr(finals["sssp compact"], part),
                    getattr(finals["sssp full"], part))
    log("[push-sharded] sssp: compact equals full bitwise (values and "
        "frontier)")
    del finals

    (mst, miters), counts = counted(lambda: mx1.run(roots))
    check_launches("multi-source sssp", counts, {"gas_pull_acc": miters})
    single = push["sssp_ex"]
    longest = 0
    for j, r in enumerate(roots):
        sst, sn = single.run(start=r)
        longest = max(longest, sn)
        if not np.array_equal(mx1.values_for(mst, j), single.values(sst)):
            raise AssertionError(f"multi-source lane {j} (root {r}) differs "
                                 "from its single-source run")
    if miters != longest:
        raise AssertionError(f"multi-source: {miters} iterations, longest "
                             f"single-source run {longest}")
    lanes = seg.u32_to_numpy(mst.values)
    log(f"[push-sharded] multi-source sssp k={K}: {miters} iterations; "
        f"every lane equals its single-source PushExecutor run bitwise "
        f"(longest {longest} iterations); launches K10 "
        f"{counts['gas_pull_acc']}")
    for label in ("multi full", "multi compact"):
        mx = exs[label]
        (st, iters), counts = counted(lambda: mx.run(roots))
        check_launches(f"sharded {label}", counts,
                       {"gas_pull_acc": P * iters})
        totals["gas_pull_acc[split]"] += counts["gas_pull_acc"]
        got = mx.gather_values(st)
        if got.shape != (g.nv, K) or not np.array_equal(got, lanes):
            raise AssertionError(f"sharded {label}: differs from the "
                                 "single-device multi-source run")
        if iters != miters:
            raise AssertionError(f"sharded {label}: {iters} iterations")
        log(f"[push-sharded] {label}: {iters} iterations, equal to the "
            f"single-device multi-source run bitwise; launches K10 "
            f"{counts['gas_pull_acc']} = {P} parts x {iters}")
    del mst, st, lanes

    # -- 6f. timing -----------------------------------------------------------
    for label, app, kw in (("sssp full", "sssp", {"start": 0}),
                           ("sssp compact", "sssp", {"start": 0}),
                           ("cc", "cc", {})):
        ex = exs[label]
        ex.warmup(**kw)
        secs = [host_seconds(lambda: ex.run(**kw)) for _ in range(3)]
        sec = float(np.median(secs))
        iters = len(ex.branch_log)
        init = float(np.median([host_seconds(lambda: ex.init_state(**kw))
                                for _ in range(3)]))
        st0 = ex.init_state(**kw)
        iter_sec = float(np.median([host_seconds(lambda: ex.run(state=st0))
                                    for _ in range(3)]))
        log(f"[time] sharded push {label}: {iters} iterations "
            f"({ex.sparse_iters} sparse) in {sec * 1e3:.3f} ms (median of 3:"
            f" {[round(x * 1e3, 3) for x in secs]}), "
            f"{sec / iters * 1e3:.3f} ms/iteration, "
            f"{ex.graph.ne * iters / sec / 1e9:.3f} GTEPS; init_state "
            f"{init * 1e3:.3f} ms; run from a device state "
            f"{iter_sec * 1e3:.3f} ms; single-device PushExecutor "
            f"{push[app]['ms']:.3f} ms to fixpoint (phase 6b)")
        busy = device_busy(lambda: ex.run(state=st0))
        if busy is None:
            log(f"[time] sharded push {label}: device busy share not "
                "measured (the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] sharded push {label}: device busy {busy_ms:.3f} ms "
                f"of the {iter_sec * 1e3:.3f} ms run from a device state "
                f"({busy_ms / (iter_sec * 1e3):.1%}; torch.profiler); top "
                "kernels (ms): " + ", ".join(f"{n}={v:.3f}" for n, v in top))
        st = ex.init_state(**kw)
        ex.warmup_phases(st)
        split = {}
        while True:
            st, c, times = ex.phase_step(st)
            branch = "dense" if times.pop("branch") == "dense" else "sparse"
            split.setdefault(branch, []).append(times)
            if c == 0:
                break
        for branch, runs in split.items():
            med = {k: float(np.median([r[k] for r in runs])) * 1e3
                   for k in runs[0]}
            log(f"[time] sharded push {label} {branch} phases (ms, median of"
                f" {len(runs)}; load = the exchange): " + ", ".join(
                    f"{k}={v:.3f}" for k, v in med.items()))
        # The dense exchange alone: views in full mode (plus the packing
        # under blocked_dense), the compact tables of values and frontier.
        x_ms = cuda_ms(lambda: ex._dense_load(st0), reps)
        rows_all = P * ex.sg.max_nv
        if ex._xch is not None:
            x_bytes = 5 * rows_all + 5 * P * rows_all
        elif ex.blocked_dense:
            x_bytes = 9 * rows_all
        else:
            x_bytes = 0
        log(f"[time] sharded push {label} exchange ({ex.exchange_mode}, "
            f"blocked_dense={ex.blocked_dense}): {x_ms:.4f} ms (mean of "
            f"{reps}, CUDA events) against a bytes bound of "
            f"{bound(x_bytes, 0)[0]:.4f} ms ({x_bytes} B); "
            f"{ex.exchange_bytes_per_iter()} B per iteration priced as "
            "interconnect bytes")
        del st, st0
    for label, mx in (("multi 1 device", mx1), ("multi full",
                                                exs["multi full"]),
                      ("multi compact", exs["multi compact"])):
        mx.warmup(start=roots[0])
        secs = [host_seconds(lambda: mx.run(roots)) for _ in range(3)]
        sec = float(np.median(secs))
        st0 = mx.init_state(roots)
        iter_sec = float(np.median([
            host_seconds(lambda: mx.run(roots, state=st0))
            for _ in range(3)]))
        runs = []
        st = st0
        while True:
            st, c, times = mx.phase_step(st)
            times.pop("branch")
            runs.append(times)
            if c == 0:
                break
        med = {k: float(np.median([r[k] for r in runs])) * 1e3
               for k in runs[0]}
        log(f"[time] {label} sssp k={K}: {miters} iterations in "
            f"{sec * 1e3:.3f} ms (median of 3: "
            f"{[round(x * 1e3, 3) for x in secs]}), "
            f"{sec / miters * 1e3:.3f} ms/iteration, "
            f"{g.ne * miters / sec / 1e9:.3f} GTEPS ({K} lanes each); run "
            f"from a device state {iter_sec * 1e3:.3f} ms; phases (ms, "
            f"median of {len(runs)}): " + ", ".join(
                f"{k}={v:.3f}" for k, v in med.items()))
        busy = device_busy(lambda: mx.run(roots, state=st0))
        if busy is None:
            log(f"[time] {label}: device busy share not measured (the "
                "profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] {label}: device busy {busy_ms:.3f} ms of the "
                f"{iter_sec * 1e3:.3f} ms run from a device state "
                f"({busy_ms / (iter_sec * 1e3):.1%}; torch.profiler); top "
                "kernels (ms): " + ", ".join(f"{n}={v:.3f}" for n, v in top))
        if label != "multi 1 device":
            x_ms = cuda_ms(lambda: mx._load(st0), reps)
            rows_all = P * mx.sg.max_nv
            x_bytes = (5 * K * rows_all * (P + 1) if mx._xch is not None
                       else 0)
            log(f"[time] {label} exchange ({mx.exchange_mode}): "
                f"{x_ms:.4f} ms (mean of {reps}) against a bytes bound of "
                f"{bound(x_bytes, 0)[0]:.4f} ms ({x_bytes} B); "
                f"{mx.exchange_bytes_per_iter()} B per iteration priced as "
                "interconnect bytes")
        del st, st0
    del exs, mx1
    log(f"[push-sharded] peak device memory of phases 3f-6f "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases "
        f"3f-6f took {time.perf_counter() - t_phase:.1f} s")
    return totals



def _tiled_sharded_phases(g, plan, pr_oracle, dev, kernels) -> dict:
    """Phases 3g-6g on the sharded tiled engine: PageRank on ``g`` over
    ``SHARDED_PARTS`` parts of a ``LocalMesh`` on the card, built on
    phase 3's ``plan``, in the full and compact exchange modes. Returns
    the launch counts of the phase 5g runs under ``strip_spmv[sharded]``
    and ``tail_gather_sum[sharded]``."""
    import torch

    from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor
    from lux_tpu_torch.models.pagerank import PageRank
    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.ops.tiled_spmv import (
        lane_select_tail_sums,
        lane_select_tail_sums_plain,
        strip_level_spmv,
        strip_level_spmv_plain,
    )
    from lux_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P = SHARDED_PARTS
    mesh = make_mesh(P, dev)
    flag = os.environ.get("LUX_EXCHANGE")
    reps = 10

    # -- 3g. the partition and both executors -------------------------------
    exs = {}
    for mode in ("full", "compact"):
        os.environ["LUX_EXCHANGE"] = mode
        t = time.perf_counter()
        ex = ShardedTiledExecutor(g, PageRank(), mesh=mesh, plan=plan)
        torch.cuda.synchronize()
        log(f"[tiled-sharded] LUX_EXCHANGE={mode} resolves to "
            f"{ex.exchange_mode}; executor built in "
            f"{time.perf_counter() - t:.1f} s; exchange_bytes_per_iter "
            f"{ex.exchange_bytes_per_iter()}")
        exs[mode] = ex
    if flag is None:
        del os.environ["LUX_EXCHANGE"]
    else:
        os.environ["LUX_EXCHANGE"] = flag
    ex = exs["full"]
    parts = ex._parts
    strips = [[lev.strips.shape[0] for lev in p.levels] for p in parts]
    log(f"[tiled-sharded] P={P} nvb={plan.nvb} max_nvb={ex.part.max_nvb} "
        f"max_nv={ex.max_nv} ({P * ex.max_nv / g.nv:.3f} x nv padded rows); "
        f"blocks per part {[len(b) for b in ex.part.blocks]}; strips per "
        f"part and level {strips}; tail edges per part "
        f"{[p.tail_sb.numel() for p in parts]}; remote rows read "
        f"{ex._remote_read_counts.tolist()}")

    # -- 4g. K1 and K2 at one part's shapes ---------------------------------
    q = 0
    part = parts[q]
    rng = np.random.default_rng(SEED + 7)
    nvb = plan.nvb
    x_float = torch.from_numpy(
        rng.random((nvb, 128), dtype=np.float32) + np.float32(0.5)).to(dev)
    x_int = torch.from_numpy(
        rng.integers(0, 4, size=(nvb, 128)).astype(np.float32)).to(dev)
    err = 0.0
    for lev in part.levels:
        for x, exact in ((x_int, True), (x_float, False)):
            got = strip_level_spmv(x, lev)
            want = strip_level_spmv_plain(x, lev.strips, lev.cols,
                                          lev.row_ptr)
            if exact:
                check_equal(f"K1 part {q} r={lev.r} integral", got, want)
            else:
                err = max(err, check_close(f"K1 part {q} r={lev.r}", got,
                                           want))
    k1_ms = sum(cuda_ms(lambda: strip_level_spmv(x_float, lev), reps)
                for lev in part.levels)
    k1_plain = sum(cuda_ms(lambda: strip_level_spmv_plain(
        x_float, lev.strips, lev.cols, lev.row_ptr), 2)
        for lev in part.levels)
    k1_bytes = sum(
        lev.strips.numel() + 4 * lev.cols.numel() + 8 * lev.row_ptr.numel()
        + x_float.numel() * 4 + 4 * lev.items.nrows * lev.r
        for lev in part.levels)
    k1_lib = 0.0
    for lev in part.levels:
        csr = _level_csr(lev, nvb, dev)
        xv = x_float.reshape(-1, 1)
        k1_lib += cuda_ms(lambda: csr @ xv, reps)
        del csr
    record(kernels, "strip_spmv[sharded]", "lux_tpu_torch/csrc/strip_spmv.cu",
           "lux_tpu/engine/tiled_sharded.py:539", err, k1_ms, k1_plain,
           k1_bytes, sum(2 * lev.strips.numel() for lev in part.levels),
           k1_lib)
    args2 = (part.tail_sb, part.tail_lane, part.tail_row_ptr)
    check_equal(f"K2 part {q} integral",
                lane_select_tail_sums(x_int, *args2, part.tail_items),
                lane_select_tail_sums_plain(x_int, *args2))
    err = check_close(f"K2 part {q}", lane_select_tail_sums(
        x_float, *args2, part.tail_items),
        lane_select_tail_sums_plain(x_float, *args2))
    k2_ms = cuda_ms(lambda: lane_select_tail_sums(
        x_float, *args2, part.tail_items), reps)
    k2_plain = cuda_ms(lambda: lane_select_tail_sums_plain(x_float, *args2),
                       reps)
    m = part.tail_sb.numel()
    k2_bytes = 5 * m + 8 * part.tail_row_ptr.numel() \
        + 4 * x_float.numel() + 4 * ex.max_nv
    cols = (part.tail_sb.long() << 7) | part.tail_lane.long()
    tail_csr = torch.sparse_csr_tensor(
        part.tail_row_ptr, cols, torch.ones(m, device=dev),
        size=(ex.max_nv, nvb * 128))
    xv = x_float.reshape(-1, 1)
    k2_lib = cuda_ms(lambda: tail_csr @ xv, reps)
    del tail_csr, cols
    record(kernels, "tail_gather_sum[sharded]",
           "lux_tpu_torch/csrc/segment_sum.cu",
           "lux_tpu/engine/tiled_sharded.py:568", err, k2_ms, k2_plain,
           k2_bytes, m, k2_lib)
    log(f"[tiled-sharded] part {q}: K1 over {strips[q]} strips into "
        f"{nvb * 128} rows, K2 over {m} tail edges into {ex.max_nv} rows")
    del x_float, x_int

    # -- 5g. end to end, both modes -------------------------------------------
    k1_per_iter = sum(1 for p in parts for lev in p.levels
                      if lev.items.n_items > 0)
    k2_per_iter = sum(1 for p in parts if p.tail_items.n_items > 0)
    totals = {"strip_spmv[sharded]": 0, "tail_gather_sum[sharded]": 0}
    outs = {}
    for mode, ex in exs.items():
        _cuda.reset_launches()
        out = ex.run(ITERS)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        got = ex.gather_values(out)
        if got.shape != pr_oracle.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"sharded tiled {mode}: bad output "
                                 f"{got.shape}")
        np.testing.assert_allclose(got, pr_oracle, rtol=RTOL, atol=ATOL,
                                   err_msg=f"sharded tiled {mode}")
        err = float(np.max(np.abs(got.astype(np.float64) - pr_oracle)))
        check_launches(f"sharded tiled {mode}", counts, {
            "strip_spmv": k1_per_iter * ITERS,
            "tail_gather_sum": k2_per_iter * ITERS})
        log(f"[tiled-sharded] {mode} (resolved {ex.exchange_mode}): "
            f"run({ITERS}) matches the f64 oracle (max abs err {err:.3e}); "
            f"launches K1 {counts['strip_spmv']} = {k1_per_iter} part-levels"
            f" x {ITERS}, K2 {counts['tail_gather_sum']} = {k2_per_iter} "
            f"parts x {ITERS}")
        totals["strip_spmv[sharded]"] += counts["strip_spmv"]
        totals["tail_gather_sum[sharded]"] += counts["tail_gather_sum"]
        outs[mode] = out
    check_equal("sharded tiled compact vs full", outs["compact"],
                outs["full"])
    log("[tiled-sharded] compact equals full bitwise"
        + ("" if exs["compact"].exchange_mode == "compact" else
           " (compact resolved to full at this size: the same exchange)"))
    del outs

    # -- 6g. timing ---------------------------------------------------------
    for mode, ex in exs.items():
        ex.warmup()
        vals = ex.init_values()
        secs = [host_seconds(lambda: ex.run(ITERS, vals=vals))
                for _ in range(3)]
        sec = float(np.median(secs))
        ev_ms = cuda_ms(lambda: ex.run(ITERS, vals=vals), 3) / ITERS
        runs = [ex.phase_step(vals)[1] for _ in range(5)]
        split = {k: float(np.median([r[k] for r in runs])) * 1e3
                 for k in runs[0]}
        log(f"[time] sharded tiled {mode}: {sec / ITERS * 1e3:.3f} "
            f"ms/iteration, {g.ne * ITERS / sec / 1e9:.3f} GTEPS (host "
            f"clock, median of 3 runs of {ITERS}: "
            f"{[round(x * 1e3, 3) for x in secs]} ms); {ev_ms:.3f} "
            "ms/iteration by CUDA events (mean of 3); phase_step split (ms, "
            "median of 5): " + ", ".join(f"{k}={v:.3f}"
                                          for k, v in split.items()))
        busy = device_busy(lambda: ex.run(ITERS, vals=vals))
        if busy is None:
            log(f"[time] sharded tiled {mode}: device busy share not "
                "measured (the profiler saw no kernels)")
        else:
            busy_ms, top = busy
            log(f"[time] sharded tiled {mode}: device busy {busy_ms:.3f} ms "
                f"of {sec * 1e3:.3f} ms ({busy_ms / (sec * 1e3):.1%}; "
                "torch.profiler); top kernels (ms): "
                + ", ".join(f"{n}={v:.3f}" for n, v in top))
        # The exchange alone: full reads nvb rows of the stacked values at
        # block_map and writes the (nvb, 128) operand; compact also reads
        # the whole stack and writes one operand per part.
        x_ms = cuda_ms(lambda: ex._exchange(vals), reps)
        ops = ex._exchange(vals)
        x_bytes = (2 * nvb * 512 if ex._xch is None
                   else vals.numel() * 4 + ops.numel() * 4)
        # The strip merge alone: the four full-height partials in
        # owner-stacked order, and the reduce_scatter.
        partials = ex._partials(ops)
        merge_ms = cuda_ms(lambda: ex._merge(partials), reps)
        merge_bytes = partials.numel() * 4 + vals.numel() * 4
        log(f"[time] sharded tiled {mode} exchange ({ex.exchange_mode}): "
            f"{x_ms:.4f} ms (mean of {reps}) against a bytes bound of "
            f"{bound(x_bytes, 0)[0]:.4f} ms ({x_bytes} B); strip merge "
            f"(stack_map + reduce_scatter) {merge_ms:.4f} ms against "
            f"{bound(merge_bytes, 0)[0]:.4f} ms; "
            f"{ex.exchange_bytes_per_iter()} B per iteration priced as "
            "interconnect bytes")
        del vals, ops, partials
    del exs, ex, parts, part
    log(f"[tiled-sharded] peak device memory of phases 3g-6g "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases 3g-6g "
        f"took {time.perf_counter() - t_phase:.1f} s")
    return totals


# Launches of each probe kernel when the three probes run: one warm-up
# and 10 timed calls per probe line (P2: 3 lane and 4 row lines; P3, P4,
# P5, its int8 form and P6 one line each), and P7's tiny case plus three
# lines of 11.
PROBE_LAUNCHES = {
    "block_take[axis=1 int32]": 4 * 11, "block_take[axis=1 int8]": 11,
    "block_take[axis=0 int32]": 5 * 11, "block_take[axis=0 int8]": 11,
    "merge4": 11, "level_apply": 1 + 3 * 11,
}


def _probe_phases(dev, kernels) -> dict:
    """Phase 4g on the gather probes P2-P7: each probe's entry point as a
    user runs it (its launches are the main path's), then ``block_take``
    in its four forms, ``merge4`` and P7's K3 launch bitwise against
    their plain versions at the probes' full shapes, timed. Returns the
    probe run's launch counts under the ``kernels`` line's names."""
    import torch

    from lux_tpu_torch.ops import _cuda
    from lux_tpu_torch.probes import dgather, dgather2, merge_kernel
    from lux_tpu_torch.probes import gather as pg

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    for probe in (dgather, dgather2, merge_kernel):
        log(f"[probe] python -m {probe.__name__}")
        probe.main([])
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    check_launches("probes", counts, PROBE_LAUNCHES)
    totals = {k: counts[k] for k in PROBE_LAUNCHES if k != "level_apply"}
    totals["level_apply[probe P7]"] = counts["level_apply"]

    reps = 10
    rng = np.random.default_rng(SEED + 9)
    put = lambda a: torch.from_numpy(a).to(dev)

    def needed(mask_shape, index, dim):
        """Distinct elements the gather reads: ones scattered into a
        mask by the (int64) index along ``dim``."""
        mask = torch.zeros(mask_shape, dtype=torch.bool, device=dev)
        mask.scatter_(dim, index, True)
        return int(mask.sum())

    rows = dgather2.S * dgather2.NB
    x = put(rng.standard_normal((rows, 128), dtype=np.float32))
    forms = (("axis=1 int32", 1, dgather2.S, 128, np.int32,
              "tools/probe_dgather2.py:62"),
             ("axis=1 int8", 1, dgather2.S, 128, np.int8,
              "tools/probe_dgather2.py:91"),
             ("axis=0 int32", 0, 8, 8, np.int32,
              "tools/probe_dgather2.py:110"),
             ("axis=0 int8", 0, 8, 8, np.int8,
              "tools/probe_dgather2.py:110"))
    for label, axis, block, hi, itype, replaces in forms:
        idx = put(rng.integers(0, hi, (rows, 128)).astype(itype))
        got = pg.block_take(x, idx, axis, block)
        check_equal(f"block_take[{label}]", got,
                    pg.block_take_plain(x, idx, axis, block))
        ms = cuda_ms(lambda: pg.block_take(x, idx, axis, block), reps)
        plain = cuda_ms(lambda: pg.block_take_plain(x, idx, axis, block),
                        reps)
        idx64 = idx.long()
        if axis == 1:
            lib = cuda_ms(lambda: torch.gather(x, 1, idx64), reps)
            reads = needed((rows, 128), idx64, 1)
        else:
            shape = (rows // block, block, 128)
            xv, iv = x.view(shape), idx64.view(shape)
            lib = cuda_ms(lambda: torch.gather(xv, 1, iv), reps)
            reads = needed(shape, iv, 1)
        nbytes = 4 * reads + idx.numel() * idx.element_size() + 4 * x.numel()
        log(f"[probe] block_take[{label}] at ({rows}, 128), blocks of "
            f"{block} rows: bitwise; {reads} distinct elements of x read")
        record(kernels, f"block_take[{label}]",
               "lux_tpu_torch/csrc/probe_gather.cu", replaces, 0.0, ms,
               plain, nbytes, 0, lib)
        del idx, idx64, got
    del x

    r = dgather2.R
    cand = put(rng.standard_normal((r, 4, 128), dtype=np.float32))
    lane = put(rng.integers(0, 128, (r, 128), dtype=np.int32))
    sel = put(rng.integers(0, 4, (r, 128), dtype=np.int32))
    check_equal("merge4", pg.merge4(cand, lane, sel),
                pg.merge4_plain(cand, lane, sel))
    ms = cuda_ms(lambda: pg.merge4(cand, lane, sel), reps)
    plain = cuda_ms(lambda: pg.merge4_plain(cand, lane, sel), reps)
    flat = cand.view(r, 512)
    gidx = sel.long() * 128 + lane.long()
    lib = cuda_ms(lambda: torch.gather(flat, 1, gidx), reps)
    reads = needed((r, 512), gidx, 1)
    record(kernels, "merge4", "lux_tpu_torch/csrc/probe_gather.cu",
           "tools/probe_dgather2.py:138", 0.0, ms, plain,
           4 * reads + 8 * lane.numel() + 4 * lane.numel(), 0, lib)
    del cand, lane, sel, flat, gidx

    g_n = merge_kernel.G_RATE
    r_in = 8 * g_n + 8
    stream = put(rng.standard_normal((r_in, 128), dtype=np.float32))
    aoff = put(rng.integers(0, r_in // 8 - 1, g_n).astype(np.int32))
    boff = put(rng.integers(0, r_in // 8 - 1, g_n).astype(np.int32))
    idx = put(rng.integers(-128, 128, (16 * g_n, 128)).astype(np.int8))
    check_equal("merge_level (P7 on K3)",
                pg.merge_level(stream, aoff, boff, idx),
                pg.merge_level_plain(stream, aoff, boff, idx))
    ms = cuda_ms(lambda: pg.merge_level(stream, aoff, boff, idx), reps)
    plain = cuda_ms(lambda: pg.merge_level_plain(stream, aoff, boff, idx),
                    reps)
    v = idx.long()
    src = torch.where(v >= 0, pg.expand_offsets(aoff).long()[:, None],
                      pg.expand_offsets(boff).long()[:, None]) * 128 \
        + (v & 127)
    reads = needed((r_in * 128,), src.view(-1), 0)
    record(kernels, "level_apply[probe P7]",
           "lux_tpu_torch/csrc/level_apply.cu",
           "tools/probe_merge_kernel.py:45", 0.0, ms, plain,
           4 * reads + 8 * g_n + idx.numel() + 4 * idx.numel(), 0, None)
    del stream, aoff, boff, idx, v, src
    log(f"[probe] peak device memory of phase 4g "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; it took "
        f"{time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals

def _level_csr(lev, nvb: int, dev):
    """The strip level as an f32 CSR matrix (nrb*r rows, nvb*128 columns),
    built on the device in chunks of strips. Used only as a yardstick."""
    import torch

    r = lev.r
    rows_of = torch.repeat_interleave(
        torch.arange(lev.row_ptr.numel() - 1, device=dev),
        lev.row_ptr.diff())
    keys, vals = [], []
    chunk = 1 << 18
    for lo in range(0, lev.strips.shape[0], chunk):
        s = lev.strips[lo:lo + chunk]
        t, i, ln = s.nonzero(as_tuple=True)
        row = rows_of[lo + t] * r + i
        col = lev.cols[lo + t].long() * 128 + ln
        keys.append(row * (nvb * 128) + col)
        vals.append(s[t, i, ln].float())
    key = torch.cat(keys)
    val = torch.cat(vals)
    key, perm = key.sort()
    row, col = key // (nvb * 128), key % (nvb * 128)
    nrows = (lev.row_ptr.numel() - 1) * r
    crow = torch.zeros(nrows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.bincount(row, minlength=nrows).cumsum(0)
    return torch.sparse_csr_tensor(crow, col, val[perm],
                                   size=(nrows, nvb * 128))


if __name__ == "__main__":
    sys.exit(main())
