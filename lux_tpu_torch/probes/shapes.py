"""Shape sweep of K2 (``tail_gather_sum``), K10 (``gas_pull_acc``), K8
(``gather_segment_sum``), K9 (``cf_edge_sum``) and K5
(``segment_minmax_relax``) on the card.

    python -m lux_tpu_torch.probes.shapes [--scale 22] [--only k5 k8 ...]
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
- K5 on the push engine's dense states, as ``chip_smoke.py``'s phases
  4b and 4f take them: SSSP from vertex 0 after 2 iterations on the
  graph, CC's first iteration on its undirected closure, and the part
  with the most edges of the 4-part sharded SSSP's dense iteration with
  the largest frontier, over the flat table of every part; in both input
  forms (the packed table, and values with the frontier's bits), over
  ``kThreads``, ``kMinBlocks5``, ``kLaneMax5`` of ``gas.cu`` and the
  schedule's ``TASK_EDGES`` and ``HUB_EDGES``.

- P6 (``merge4``) at the probe's shape, R = 65,536 rows of 4 x 128
  candidates, uniform lanes and selectors: the kernel against one
  ``torch.gather`` over the same candidates, by means of 20 calls and by
  medians of 100 on a held card (``probes/gather.py::median_ms``).

With ``--old-csrc DIR``, a directory holding ``push_dense.cu``,
``probe_gather.cu`` and their header (``lux_tpu_torch/csrc`` of a
checkout of commit a047839), that source's K5 (work items of 64 edges
folded into an identity-filled accumulator with atomics) is built and
timed first, on the same states in both forms, with and without its
fill; and its P6 (four scattered loads a thread) beside the new one.

``--only`` names the sweeps to run (default: all six). It prints one
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
# (kernel constants, (TASK_EDGES, HUB_EDGES)); the first are the built-in.
K5_CASES = [(dict(kThreads=t, kMinBlocks5=b, kLaneMax5=a), sched)
            for t, b, a, sched in (
                (256, 6, 32, (256, 4096)), (256, 8, 32, (256, 4096)),
                (256, 4, 32, (256, 4096)), (128, 12, 32, (256, 4096)),
                (256, 6, 64, (256, 4096)), (256, 6, 16, (256, 4096)),
                (256, 6, 32, (128, 4096)), (256, 6, 32, (512, 4096)),
                (256, 6, 32, (1024, 4096)), (256, 6, 32, (256, 8192)),
                (256, 6, 32, (256, 2048)))]
CF_TOL = dict(rtol=1e-4, atol=1e-7)   # tests/test_colfilter.py
PR_TOL = dict(rtol=5e-5, atol=1e-9)   # tests/test_tiled.py
# K5 and P6 of commit a047839 (--old-csrc): K5's work items and the C
# signatures.
OLD_ITEM = 64
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
OLD_SIGNATURES = {
    # packed, values, frontier, col_src, item_lo, item_row, n_items, comb,
    # relax, acc, stream
    "lux_segment_minmax_relax": (_P, _P, _P, _P, _P, _P, _I64, _INT, _INT,
                                 _P, _P),
    # cand, l, s, R, out, stream: the signature it has now
    "lux_merge4": _cuda._SIGNATURES["lux_merge4"],
}
OLD_SOURCES = {"k5": "push_dense.cu", "p6": "probe_gather.cu"}
REPS = 20
OUT = _cuda.BUILD_DIR / "shapes"
SWEEPS = ("k2", "k10", "k8", "k9", "k5", "p6")


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


def build_variants(variants, old_csrc=None, old_sources=()):
    """{(source, tag): ctypes library} for (source name, tag, shape), and
    ("old", name) for each of ``old_sources`` in ``old_csrc``."""
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    nvcc = _cuda._nvcc()
    jobs = []
    for name, tag, shape in variants:
        src = OUT / f"{tag}_{name}"
        src.write_text(_variant_source(name, shape))
        jobs.append(((name, tag), src, _cuda.CSRC, _cuda._SIGNATURES))
    for name in old_sources:
        jobs.append((("old", name), old_csrc / name, old_csrc,
                     OLD_SIGNATURES))
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


def _k5_states(g, dev):
    """(label, row_ptr numpy, device row_ptr, col_src, values, frontier,
    comb, relax, program) of K5 on chip_smoke.py's states: SSSP from
    vertex 0 after 2 iterations on ``g``, CC's first iteration on its
    undirected closure (built here), and the part with the most edges of
    sharded SSSP's dense iteration with the largest frontier (4 parts,
    full exchange), over the flat table of every part."""
    from lux_tpu_torch.engine.push import PushExecutor
    from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models import SSSP, ConnectedComponents

    out = []
    for label, graph, prog in (("sssp after 2 iterations", g, SSSP()),
                               ("cc iteration 1", None,
                                ConnectedComponents())):
        if graph is None:
            t = time.perf_counter()
            graph = generate.undirected(g)
            print(f"[shapes] undirected closure in "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
        ex = PushExecutor(graph, prog, sparse=False)
        st = (ex.run(max_iters=2, start=0)[0] if prog.rooted
              else ex.init_state())
        out.append((label, graph.row_ptr, ex.row_ptr, ex.col_src, st.values,
                    st.frontier, seg.COMBINERS.index(prog.combiner),
                    list(seg.RELAX_OPS).index(prog.relax_op), prog))
        del ex
    t = time.perf_counter()
    prog = SSSP()
    ex = ShardedPushExecutor(g, prog, num_parts=4)
    ex.run(start=0)
    _, at = max((b[1], i) for i, b in enumerate(ex.branch_log) if b[0] == 0)
    st, _ = ex.run(max_iters=at, start=0)
    q = int(np.argmax([pt.col_src.numel() for pt in ex._parts]))
    pt = ex._parts[q]
    out.append((f"sharded sssp iteration {at + 1}, part {q} of 4",
                ex.sg.local_row_ptr[q], pt.row_ptr, pt.col_src,
                ex._exchange(st.values), ex._exchange(st.frontier), 0, 0,
                prog))
    print(f"[shapes] sharded state in {time.perf_counter() - t:.1f} s",
          flush=True)
    return out


def _k5_want(rp, cs, vals, front, prog):
    return seg.segment_minmax_relax_plain(rp, cs, vals, front,
                                          prog.combiner,
                                          seg.RELAX_OPS[prog.relax_op])


def sweep_k5(libs, states, dev) -> None:
    """Each case of K5_CASES, in both forms, on each state, held bitwise
    against the plain version."""
    for label, rp_np, rp, cs, vals, front, comb, op, prog in states:
        want = _k5_want(rp, cs, vals, front, prog)
        packed = seg.pack_words(vals, front)
        n_tab = vals.shape[0]
        bits = torch.empty((n_tab + 31) // 32, dtype=torch.int32, device=dev)
        active = int(front.sum())
        for shape, (task_edges, hub) in K5_CASES:
            tasks = seg.RowTasks.build(rp_np, dev, task_edges, hub)
            fn = libs["gas.cu", _tag("k5", shape)].lux_segment_minmax_relax
            for form in ("packed", "bits"):
                acc = torch.empty_like(want)
                args = (_cuda.ptr(packed if form == "packed" else None),
                        _cuda.ptr(None if form == "packed" else vals),
                        _cuda.ptr(None if form == "packed" else front),
                        n_tab, _cuda.ptr(cs), _cuda.ptr(rp),
                        _cuda.ptr(tasks.tasks), tasks.n_tasks, tasks.n_hub,
                        comb, op, _cuda.ptr(bits), _cuda.ptr(acc),
                        _cuda.stream(dev))
                _call(fn, *args)
                if not torch.equal(acc, want):
                    raise AssertionError(f"K5 {shape} {form} {label}: "
                                         "not bitwise")
                print(f"[shapes] K5 {label} ({cs.shape[0]} edges, {active} "
                      f"of {n_tab} active) {form} task_edges={task_edges} "
                      f"hub_edges={hub} ({tasks.n_hub} hub rows, "
                      f"{tasks.n_tasks} tasks) {shape}: "
                      f"{_ms(lambda: _call(fn, *args)):.4f} ms", flush=True)


def time_old_k5(lib, states, dev) -> None:
    """K5 of ``--old-csrc`` on the same states, in both forms: its
    identity fill and kernel, as its wrapper ran them, and the kernel
    alone."""
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for label, rp_np, rp, cs, vals, front, comb, op, prog in states:
        want = _k5_want(rp, cs, vals, front, prog)
        lo, ri = seg.segment_items(rp_np, OLD_ITEM)
        item_lo = put(lo)
        item_row = put(np.repeat(np.arange(ri.shape[0] - 1, dtype=np.int32),
                                 np.diff(ri)))
        n_items = lo.shape[0] - 1
        packed = seg.pack_words(vals, front)
        acc = torch.empty_like(want)
        ident = -1 if comb == 0 else 0
        for form in ("packed", "values and a bool frontier"):
            args = (_cuda.ptr(packed if form == "packed" else None),
                    _cuda.ptr(None if form == "packed" else vals),
                    _cuda.ptr(None if form == "packed" else front),
                    _cuda.ptr(cs), _cuda.ptr(item_lo), _cuda.ptr(item_row),
                    n_items, comb, op, _cuda.ptr(acc), _cuda.stream(dev))

            def kernel():
                _call(lib.lux_segment_minmax_relax, *args)

            def both():
                acc.fill_(ident)
                kernel()

            both()
            if not torch.equal(acc, want):
                raise AssertionError(f"old K5 {form} {label}: not bitwise")
            print(f"[shapes] old K5 {label} ({cs.shape[0]} edges, {n_items} "
                  f"items of {OLD_ITEM}) {form}: fill and kernel "
                  f"{_ms(both):.4f} ms, kernel alone "
                  f"{_ms(kernel):.4f} ms", flush=True)


def time_p6(old, dev) -> None:
    """P6 at the probe's shape: the kernel, ``old``'s (None: not timed)
    and one ``torch.gather``, each held bitwise to the plain version."""
    from lux_tpu_torch.probes import dgather2
    from lux_tpu_torch.probes import gather as pg

    r = dgather2.R
    rng = np.random.default_rng(6)
    put = lambda a: torch.from_numpy(a).to(dev)
    cand = put(rng.standard_normal((r, 4, 128), dtype=np.float32))
    lane = put(rng.integers(0, 128, (r, 128), dtype=np.int32))
    sel = put(rng.integers(0, 4, (r, 128), dtype=np.int32))
    want = pg.merge4_plain(cand, lane, sel)
    flat, gidx = cand.view(r, 512), sel.long() * 128 + lane.long()
    out = torch.empty_like(want)
    args = (_cuda.ptr(cand), _cuda.ptr(lane), _cuda.ptr(sel), r,
            _cuda.ptr(out), _cuda.stream(dev))
    calls = {"merge4": lambda: _call(_cuda.library().lux_merge4, *args)}
    if old is not None:
        calls["old merge4"] = lambda: _call(old.lux_merge4, *args)
    calls["torch.gather"] = lambda: torch.gather(flat, 1, gidx)
    for name, fn in calls.items():
        if name != "torch.gather":
            out.zero_()
            fn()
            if not torch.equal(out, want):
                raise AssertionError(f"{name}: not bitwise")
    for rnd in range(2):
        print(f"[shapes] P6 R={r} round {rnd}: " + ", ".join(
            f"{name} {_ms(fn):.4f} ms (mean of {REPS}), "
            f"{pg.median_ms(fn, dev, 100, hold=True):.4f} ms (median of "
            f"100, held)" for name, fn in calls.items()), flush=True)


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
                    help="time the K5 and P6 of this directory's "
                         "push_dense.cu and probe_gather.cu too")
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
    if "k5" in only:
        variants += [("gas.cu", _tag("k5", s), s)
                     for s in _kernel_shapes(K5_CASES)]
    olds = () if args.old_csrc is None else [
        OLD_SOURCES[k] for k in OLD_SOURCES if k in only]
    libs = build_variants(variants, args.old_csrc, olds)
    print(f"[shapes] {len(libs)} variants built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if only & {"k2", "k8", "k10", "k5"}:
        t = time.perf_counter()
        g = generate.rmat(args.scale, 16, seed=42)
        print(f"[shapes] rmat({args.scale}, 16) in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        if "k5" in only:
            states = _k5_states(g, dev)
            if args.old_csrc is not None:
                time_old_k5(libs["old", "push_dense.cu"], states, dev)
            sweep_k5(libs, states, dev)
            del states
            torch.cuda.empty_cache()
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
        sweep_pull(libs, gc, "cf_sgd", n_users, dev)
    if "p6" in only:
        time_p6(libs.get(("old", "probe_gather.cu")), dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
