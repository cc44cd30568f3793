"""Shape sweep of K2 (``tail_gather_sum``), K10 (``gas_pull_acc``), K8
(``gather_segment_sum``) and K9 (``cf_edge_sum``) on the card.

    python -m lux_tpu_torch.probes.shapes [--scale 22] [--only k8 k9 ...]
                                          [--old-csrc DIR]

Each variant is a copy of ``csrc/segment_sum.cu``, ``csrc/gas.cu`` or
``csrc/pull_sum.cu`` with other tier thresholds (the ``constexpr`` lines
named below), compiled by its own ``nvcc`` (all started together) into
its own library under ``build/lux_tpu_torch/shapes/`` and called through
ctypes as the package's wrappers call the built-in kernels. Every variant
is first held against the plain version (bitwise, or on floats within
the reference tolerances), then timed by CUDA events (mean of 20 calls
after one warm-up), on the R-MAT graph of ``--scale`` (edge factor 16,
seed 42, as ``chip_smoke.py``) or on ``bench.py``'s ratings graph of
that scale:

- K2 over the hybrid plan's tail on one device (x the (nv,) values) and
  over parts 0 and 3 of the P = 4 sharded tiled layout (x the (nvb, 128)
  table), adding into a row vector as the executors do; ``kThreads``,
  ``kBlockItems`` (the rows and edges a block owns), ``kStage`` and
  ``kMinBlocks`` (the resident blocks ``__launch_bounds__`` asks of
  ptxas).
- K10 (min, add1) on the graph's CSC at frontier densities 0.01, 0.1 and
  0.5 with one column, and at 0.1 with 8 columns; ``kThreads``,
  ``kLaneMax``, ``kMinBlocks`` and ``kMinBlocksK`` (one column and K) of
  the kernel and the schedule's ``TASK_EDGES`` and ``HUB_EDGES``.
- K8 on the graph's CSC (random f32 values): ``kLaneMax8``,
  ``kMinBlocks8``, ``kCluster8`` (the blocks of a hub row) and
  ``kStream8`` (evict-first index loads) of ``pull_sum.cu`` and K8's
  schedule thresholds (``task_edges``, ``hub_edges`` of
  ``ops/segment.py::row_tasks``).
- K9 on the NetFlix-shaped ratings graph (``bipartite_ratings`` at
  ``bench.py``'s sizes), over every row, the user rows alone and the item
  rows alone: ``kMinBlocks9``, ``kCluster9``, ``kUnroll9`` (the edges a
  lane group keeps in flight) and K9's schedule thresholds.

With ``--old-csrc DIR``, a directory holding the two-pass
``pull_sum.cu`` and its headers (``lux_tpu_torch/csrc`` of a checkout of
commit 18867e9), that source's K8 and K9 are built and timed first,
at the same shapes: both passes, the item pass alone and the item-sum
pass alone, and K9 over the user and the item rows alone.

``--only`` names the sweeps to run (default: all four). It prints one
line per variant and shape, and the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import re
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.ops import segment as seg

K2_SHAPES = [dict(kThreads=t, kBlockItems=a, kStage=b, kMinBlocks=c)
             for t, a, b, c in (
                 (256, 1024, 1536, 8), (256, 1024, 2048, 8),
                 (256, 1024, 1024, 8), (256, 2048, 2048, 8),
                 (256, 512, 1024, 8), (256, 1024, 1536, 6),
                 (256, 1024, 1536, 1), (128, 512, 768, 16),
                 (128, 1024, 1536, 16), (128, 512, 1024, 12))]
K10_KERNEL_SHAPES = [dict(kThreads=t, kLaneMax=a, kMinBlocks=b,
                          kMinBlocksK=c)
                     for t, a, b, c in ((256, 32, 8, 6), (256, 16, 8, 6),
                                        (256, 32, 6, 8), (256, 32, 1, 1),
                                        (128, 32, 16, 12))]
K10_SCHEDULES = [(1024, 4096), (512, 4096), (2048, 4096),
                 (1024, 8192)]   # (TASK_EDGES, HUB_EDGES)
# (kernel constants, (task_edges, hub_edges)); the first are the built-in.
K8_CASES = [(dict(kLaneMax8=a, kMinBlocks8=b, kCluster8=c, kStream8=d),
             sched) for a, b, c, d, sched in (
                 (32, 6, 1, 1, (512, 4096)), (32, 6, 1, 0, (512, 4096)),
                 (32, 6, 1, 1, (1024, 4096)), (32, 8, 1, 1, (512, 4096)),
                 (32, 4, 1, 1, (512, 4096)), (16, 6, 1, 1, (512, 4096)),
                 (64, 6, 1, 1, (512, 4096)), (32, 6, 2, 1, (512, 4096)),
                 (32, 6, 1, 1, (256, 4096)), (32, 6, 1, 1, (512, 8192)))]
K9_CASES = [(dict(kMinBlocks9=a, kCluster9=b, kUnroll9=c), sched)
            for a, b, c, sched in (
                (4, 2, 6, (1024, 4096)), (4, 1, 6, (1024, 4096)),
                (4, 4, 6, (1024, 4096)), (4, 8, 6, (1024, 4096)),
                (4, 2, 4, (1024, 4096)), (4, 2, 8, (1024, 4096)),
                (3, 2, 6, (1024, 4096)), (5, 2, 6, (1024, 4096)),
                (4, 2, 6, (512, 4096)), (4, 2, 6, (2048, 8192)),
                (4, 2, 6, (1024, 2048)))]
CF_TOL = dict(rtol=1e-4, atol=1e-7)   # tests/test_colfilter.py
PR_TOL = dict(rtol=5e-5, atol=1e-9)   # tests/test_tiled.py
# The two-pass K8 and K9 of commit 18867e9 (--old-csrc): their item
# lengths and C signatures.
OLD_ITEM = {"copy": 64, "cf_sgd": 128}
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
OLD_SIGNATURES = {
    # vals, col_src, item_lo, n_items, row_items, nrows, partial, y, stream
    "lux_gather_segment_sum": (_P, _P, _P, _I64, _P, _I64, _P, _P, _P),
    # vals, col_src, weights, item_lo, item_row, n_items, row_items, nrows,
    # partial, y, stream
    "lux_cf_edge_sum": (_P, _P, _P, _P, _P, _I64, _P, _I64, _P, _P, _P),
}
REPS = 20
OUT = _cuda.BUILD_DIR / "shapes"
SWEEPS = ("k2", "k10", "k8", "k9")


def _ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def _variant_source(name: str, shape: dict) -> str:
    text = (_cuda.CSRC / name).read_text()
    for key, value in shape.items():
        text, n = re.subn(rf"(constexpr int {key} = )\d+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{name}: no single constexpr {key}")
    return text


def build_variants(variants, old_csrc=None):
    """{(source, tag): ctypes library} for (source name, tag, shape), and
    ("old", "pull_sum.cu") for ``old_csrc``'s pull_sum.cu."""
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    nvcc = _cuda._nvcc()
    jobs = []
    for name, tag, shape in variants:
        src = OUT / f"{tag}_{name}"
        src.write_text(_variant_source(name, shape))
        jobs.append(((name, tag), src, _cuda.CSRC, _cuda._SIGNATURES))
    if old_csrc is not None:
        jobs.append((("old", "pull_sum.cu"), old_csrc / "pull_sum.cu",
                     old_csrc, OLD_SIGNATURES))
    procs = []
    for key, src, inc, sigs in jobs:
        lib = OUT / f"lib{'_'.join(key)}.so"
        procs.append((key, lib, sigs, subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, f"-I{inc}", "-shared", str(src), "-o",
             str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, lib, sigs, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for fn, args in sigs.items():
            if hasattr(handle, fn):
                getattr(handle, fn).argtypes = list(args)
                getattr(handle, fn).restype = ctypes.c_int
        libs[key] = handle
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        print(f"[shapes] built {key}: {'; '.join(regs)}", flush=True)
    return libs


def _call(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc}")


def _tails(plan, dev):
    """(label, x length, tail_src, row_ptr): one device, parts 0 and 3."""
    from lux_tpu_torch.engine.tiled_sharded import (
        _ranges_to_indices,
        partition_plan,
    )
    from lux_tpu_torch.ops.tiled_spmv import BLOCK, tail_stream

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out = [("one device", plan.nv,
            tail_stream(plan.tail_sb, plan.tail_lane, dev),
            put(np.asarray(plan.tail_row_ptr, np.int64)))]
    part = partition_plan(plan, 4)
    max_nv = part.max_nvb * BLOCK
    per_v = np.diff(plan.tail_row_ptr).astype(np.int64)
    for p in (0, 3):
        b = part.blocks[p]
        vidx = ((b * BLOCK)[:, None] + np.arange(BLOCK)).ravel()
        vidx = vidx[vidx < plan.nv]
        eidx = _ranges_to_indices(plan.tail_row_ptr[vidx], per_v[vidx])
        rp = np.full(max_nv + 1, eidx.shape[0], np.int64)
        np.cumsum(per_v[vidx], out=rp[1:vidx.shape[0] + 1])
        rp[0] = 0
        out.append((f"part {p} of 4", plan.nvb * BLOCK,
                    tail_stream(plan.tail_sb[eidx], plan.tail_lane[eidx],
                                dev), put(rp)))
    return out


def sweep_k2(libs, plan, dev) -> None:
    from lux_tpu_torch.ops.tiled_spmv import lane_select_tail_sums_plain

    rng = np.random.default_rng(1)
    for label, n_x, src, rp in _tails(plan, dev):
        rows = rp.shape[0] - 1
        x = torch.from_numpy(rng.integers(0, 4, n_x).astype(np.float32)
                             ).to(dev)
        y0 = torch.from_numpy(rng.integers(0, 4, rows).astype(np.float32)
                              ).to(dev)
        want = lane_select_tail_sums_plain(x, src, rp, out=y0.clone())
        for shape in K2_SHAPES:
            fn = libs["segment_sum.cu", _tag("k2", shape)].lux_tail_gather_sum
            y = y0.clone()
            args = (_cuda.ptr(x), _cuda.ptr(src), src.shape[0],
                    _cuda.ptr(rp), rows, 1, _cuda.ptr(y), _cuda.stream(dev))
            _call(fn, *args)
            if not torch.equal(y, want):
                raise AssertionError(f"K2 {shape} {label}: not bitwise")
            print(f"[shapes] K2 {label} ({int(rp[-1])} edges, {rows} rows) "
                  f"{shape}: {_ms(lambda: _call(fn, *args)):.4f} ms",
                  flush=True)


def sweep_k10(libs, g, dev) -> None:
    rp_np = g.row_ptr
    rp = torch.from_numpy(rp_np).to(dev)
    col_src = torch.from_numpy(g.col_src).to(dev)
    rng = np.random.default_rng(2)
    cases = [(1, d) for d in (0.01, 0.1, 0.5)] + [(8, 0.1)]
    for k, dens in cases:
        shape_v = (g.nv,) if k == 1 else (g.nv, k)
        vals = torch.from_numpy(rng.integers(0, 2**31, shape_v)
                                .astype(np.int32)).to(dev)
        front = (torch.rand(shape_v, device=dev) < dens)
        want = seg.gas_pull_acc_plain(rp, col_src, vals, front, "min",
                                      seg.GATHER_OPS["add1"])
        bits = torch.empty(g.nv + 1 if k > 1 else g.nv // 32 + 1,
                           dtype=torch.int32, device=dev)
        for (task_edges, hub), shape in itertools.product(
                K10_SCHEDULES, K10_KERNEL_SHAPES):
            if (task_edges, hub) != K10_SCHEDULES[0] \
                    and shape != K10_KERNEL_SHAPES[0]:
                continue   # the schedules at the built-in kernel shape
            old = seg.TASK_EDGES, seg.HUB_EDGES
            seg.TASK_EDGES, seg.HUB_EDGES = task_edges, hub
            try:
                tasks = seg.RowTasks.build(rp_np, dev)
            finally:
                seg.TASK_EDGES, seg.HUB_EDGES = old
            fn = libs["gas.cu", _tag("k10", shape)].lux_gas_pull_acc
            acc = torch.empty_like(vals)
            args = (_cuda.ptr(vals), _cuda.ptr(front), g.nv,
                    _cuda.ptr(col_src), None, _cuda.ptr(rp),
                    _cuda.ptr(tasks.tasks), tasks.n_tasks, tasks.n_hub, k,
                    0, _cuda.ptr(bits), _cuda.ptr(acc), _cuda.stream(dev))
            _call(fn, *args)
            if not torch.equal(acc, want):
                raise AssertionError(f"K10 {shape} k={k}: not bitwise")
            print(f"[shapes] K10 k={k} density {dens} TASK_EDGES="
                  f"{task_edges} HUB_EDGES={hub} ({tasks.n_hub} hub rows, "
                  f"{tasks.n_tasks} tasks) {shape}: "
                  f"{_ms(lambda: _call(fn, *args)):.4f} ms", flush=True)


def _check(label, got, want, exact, tol) -> None:
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: not bitwise")
    else:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   err_msg=label, **tol)


def _pull_slices(g, n_users):
    """(label, first row, end row) of the pull sweeps: every row, and for
    a ratings graph the user rows and the item rows alone."""
    out = [("all rows", 0, g.nv)]
    if n_users:
        out += [("user rows", 0, n_users), ("item rows", n_users, g.nv)]
    return out


def _pull_operands(g, op, dev, rng):
    """Device (row_ptr, col_src, weights or None) and (exact, values)
    pairs: 0/1 values (sums exact) and floats near CF's start."""
    shape = (g.nv,) if op == "copy" else (g.nv, seg.CF_WIDTH)
    ints = rng.integers(0, 2, size=shape).astype(np.float32)
    floats = (rng.random(shape, dtype=np.float32) * np.float32(0.2)
              + np.float32(0.12))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    w = None if op == "copy" else put(g.weights)
    return ((put(g.row_ptr), put(g.col_src), w),
            [(True, put(ints)), (False, put(floats))])


def _plain(op, vals, rp, cs, w):
    if op == "copy":
        return seg.gather_segment_sum_plain(vals, rp, cs)
    return seg.cf_edge_sum_plain(vals, rp, cs, w, window=1 << 20)


def sweep_pull(libs, g, op, n_users, dev) -> None:
    """K8 (``op`` "copy") or K9 ("cf_sgd"): each case of K8_CASES or
    K9_CASES over each slice of rows, held against the plain version."""
    name = "K8" if op == "copy" else "K9"
    cases = K8_CASES if op == "copy" else K9_CASES
    (rp, cs, w), vals = _pull_operands(g, op, dev, np.random.default_rng(3))
    want = [_plain(op, v, rp, cs, w) for _, v in vals]
    tol = PR_TOL if op == "copy" else CF_TOL
    for label, a, b in _pull_slices(g, n_users):
        rows = rp[a:b + 1]
        n_e = int(rows[-1] - rows[0])
        for shape, (task_edges, hub) in cases:
            tasks = seg.RowTasks.build(g.row_ptr[a:b + 1], dev, task_edges,
                                       hub)
            lib = libs["pull_sum.cu", _tag(name.lower(), shape)]
            acc = torch.empty((b - a,) + tuple(vals[0][1].shape[1:]),
                              device=dev)
            for (exact, v), full in zip(vals, want):
                if op == "copy":
                    args = (_cuda.ptr(v), _cuda.ptr(cs), _cuda.ptr(rows),
                            _cuda.ptr(tasks.tasks), tasks.n_tasks,
                            tasks.n_hub, _cuda.ptr(acc), _cuda.stream(dev))
                    fn = lib.lux_gather_segment_sum
                else:
                    args = (_cuda.ptr(v), _cuda.ptr(cs), _cuda.ptr(w),
                            _cuda.ptr(rows), _cuda.ptr(tasks.tasks),
                            tasks.n_tasks, tasks.n_hub, a, _cuda.ptr(acc),
                            _cuda.stream(dev))
                    fn = lib.lux_cf_edge_sum
                _call(fn, *args)
                _check(f"{name} {shape} {label}", acc, full[a:b], exact, tol)
            print(f"[shapes] {name} {label} ({n_e} edges, {b - a} rows) "
                  f"task_edges={task_edges} hub_edges={hub} "
                  f"({tasks.n_hub} hub rows, {tasks.n_tasks} tasks) {shape}: "
                  f"{_ms(lambda: _call(fn, *args)):.4f} ms", flush=True)


def time_old_pull(lib, g, op, n_users, dev) -> None:
    """The two-pass K8 or K9 (``--old-csrc``) at the same shapes: both
    passes, the item pass alone (no rows to sum) and the item-sum pass
    alone (no items), over each slice of rows."""
    name = "K8" if op == "copy" else "K9"
    (rp, cs, w), vals = _pull_operands(g, op, dev, np.random.default_rng(3))
    exact, v = vals[0]
    want = _plain(op, v, rp, cs, w)
    for label, a, b in _pull_slices(g, n_users):
        lo, ri = seg.segment_items(g.row_ptr[a:b + 1], OLD_ITEM[op])
        n_items, nrows = lo.shape[0] - 1, b - a
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        item_lo, row_items = put(lo), put(ri)
        item_row = put(np.repeat(np.arange(a, b, dtype=np.int32),
                                 np.diff(ri)))
        width = 1 if op == "copy" else seg.CF_WIDTH
        partial = torch.empty(n_items * width, device=dev)
        acc = torch.empty((nrows,) + tuple(v.shape[1:]), device=dev)

        def call(items, rows):
            if op == "copy":
                _call(lib.lux_gather_segment_sum, _cuda.ptr(v), _cuda.ptr(cs),
                      _cuda.ptr(item_lo), items, _cuda.ptr(row_items), rows,
                      _cuda.ptr(partial), _cuda.ptr(acc), _cuda.stream(dev))
            else:
                _call(lib.lux_cf_edge_sum, _cuda.ptr(v), _cuda.ptr(cs),
                      _cuda.ptr(w), _cuda.ptr(item_lo), _cuda.ptr(item_row),
                      items, _cuda.ptr(row_items), rows, _cuda.ptr(partial),
                      _cuda.ptr(acc), _cuda.stream(dev))

        call(n_items, nrows)
        _check(f"old {name} {label}", acc, want[a:b], exact, {})
        times = {part: _ms(lambda: call(*args)) for part, args in (
            ("both passes", (n_items, nrows)),
            ("item pass alone", (n_items, 0)),
            ("item-sum pass alone", (0, nrows)))}
        top = int(np.diff(ri).max(initial=0))
        print(f"[shapes] old {name} {label} ({int(lo[-1] - lo[0])} edges, "
              f"{nrows} rows, {n_items} items of {OLD_ITEM[op]}, at most "
              f"{top} a row): " + ", ".join(
                  f"{k} {t:.4f} ms" for k, t in times.items()), flush=True)


def _tag(kernel: str, shape: dict) -> str:
    return kernel + "_" + "_".join(f"{k}{v}" for k, v in shape.items())


def _kernel_shapes(cases):
    return list({_tag("", s): s for s, _ in cases}.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--only", nargs="+", choices=SWEEPS, default=SWEEPS,
                    help="the sweeps to run")
    ap.add_argument("--old-csrc", type=Path, default=None,
                    help="time the two-pass K8 and K9 of this "
                         "directory's pull_sum.cu first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("shapes: needs a CUDA device")
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.ops.tiled_spmv import plan_hybrid

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[shapes] {smi}", flush=True)
    only = set(args.only)
    t = time.perf_counter()
    variants = []
    if "k2" in only:
        variants += [("segment_sum.cu", _tag("k2", s), s) for s in K2_SHAPES]
    if "k10" in only:
        variants += [("gas.cu", _tag("k10", s), s)
                     for s in K10_KERNEL_SHAPES]
    if "k8" in only:
        variants += [("pull_sum.cu", _tag("k8", s), s)
                     for s in _kernel_shapes(K8_CASES)]
    if "k9" in only:
        variants += [("pull_sum.cu", _tag("k9", s), s)
                     for s in _kernel_shapes(K9_CASES)]
    libs = build_variants(variants, args.old_csrc)
    print(f"[shapes] {len(libs)} variants built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if only & {"k2", "k8", "k10"}:
        t = time.perf_counter()
        g = generate.rmat(args.scale, 16, seed=42)
        print(f"[shapes] rmat({args.scale}, 16) in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        if args.old_csrc is not None and "k8" in only:
            time_old_pull(libs["old", "pull_sum.cu"], g, "copy", 0, dev)
        if "k8" in only:
            sweep_pull(libs, g, "copy", 0, dev)
        if "k10" in only:
            sweep_k10(libs, g, dev)
        if "k2" in only:
            t = time.perf_counter()
            plan = plan_hybrid(g)
            print(f"[shapes] plan in {time.perf_counter() - t:.1f} s",
                  flush=True)
            sweep_k2(libs, plan, dev)
            del plan
        del g
    if "k9" in only:
        # bench.py's run_cf sizes, as chip_smoke.py's phase 3c.
        n_users = min(480_000, 1 << max(args.scale - 3, 1))
        n_items = max(n_users // 27, 64)
        t = time.perf_counter()
        gc = generate.bipartite_ratings(n_users, n_items, 12 << args.scale,
                                        seed=11)
        print(f"[shapes] bipartite_ratings({n_users}, {n_items}, "
              f"{12 << args.scale}, seed=11) in "
              f"{time.perf_counter() - t:.1f} s; max in-degree "
              f"{int(gc.in_degrees.max())}", flush=True)
        if args.old_csrc is not None:
            time_old_pull(libs["old", "pull_sum.cu"], gc, "cf_sgd", n_users,
                          dev)
        sweep_pull(libs, gc, "cf_sgd", n_users, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
