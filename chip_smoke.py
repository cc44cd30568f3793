#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lux_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--scale 22]

Drives the port's main path — tiled pull PageRank on an R-MAT graph of
the given scale (edge factor 16, seed 42: the JAX package's headline
graph at the default scale 22) — through the entry points a user calls,
in both tail configurations (lane-select, and the grouped merge-network
tail of ``LUX_GROUPED_TAIL=1``). Phases:

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


def check_close(name: str, got, want) -> float:
    """Max abs error of ``got`` against ``want``; raises outside
    rtol=5e-5, atol=1e-9."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    return float(np.max(np.abs(g - w), initial=0.0))


def check_equal(name: str, got, want) -> None:
    import torch

    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"{name}: not bitwise equal (max diff {diff})")


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
    from lux_tpu_torch.engine.tiled import TiledPullExecutor
    from lux_tpu_torch.graph import generate
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
        strip_level_spmv,
        strip_level_spmv_plain,
    )

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
    t = time.perf_counter()
    g = generate.rmat(args.scale, 16, seed=SEED)
    t_gen = time.perf_counter() - t
    log(f"[graph] rmat({args.scale}, 16, seed={SEED}): nv={g.nv} ne={g.ne} "
        f"in {t_gen:.1f} s")
    from lux_tpu_torch.ops.tiled_spmv import plan_hybrid

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
    kernels = []

    def record(name, source, replaces, err, ms, plain_ms, nbytes, flops,
               lib_ms):
        b_ms, b_by = bound(nbytes, flops)
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
        }
        kernels.append(entry)
        log(f"[kernel] {name}: max_abs_err={err:.3e} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)}")

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
    record("strip_spmv", "lux_tpu_torch/csrc/strip_spmv.cu",
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
    record("tail_gather_sum", "lux_tpu_torch/csrc/segment_sum.cu",
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
    record("level_apply", "lux_tpu_torch/csrc/level_apply.cu",
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
    record("segment_sum_rowptr", "lux_tpu_torch/csrc/segment_sum.cu",
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
    expected = {
        "lane-select": {"strip_spmv": nlev * ITERS,
                        "tail_gather_sum": k2_per_iter * ITERS,
                        "level_apply": 0, "segment_sum_rowptr": 0},
        "grouped": {"strip_spmv": nlev * ITERS, "tail_gather_sum": 0,
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

    for entry in kernels:
        entry["launches"] = totals[entry["name"]]
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} never ran on the main path")
    log(f"[done] scale {args.scale} in {time.perf_counter() - t_start:.1f} s "
        f"on {smi}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
