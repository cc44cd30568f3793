"""Shape sweep of K2 (``tail_gather_sum``), K4 (``segment_sum_rowptr``),
K10 (``gas_pull_acc``), K8 (``gather_segment_sum``), K9
(``cf_edge_sum``), K5 (``segment_minmax_relax``), and K7 and K11
(``queue_relax_scatter``, ``gas_push_acc``: the queue expansion) on the
card.

    python -m lux_tpu_torch.probes.shapes [--scale 22] [--only k4 k7 ...]
                                          [--old-csrc DIR]

Each variant is a copy of ``csrc/`` with other constants in one source
or header (the ``constexpr`` lines named below), its ``.cu`` compiled
by its own ``nvcc`` (all started together) into its own library under
``build/lux_tpu_torch/shapes/`` and called through ctypes as the
package's wrappers call the built-in kernels. Every variant is first
held against the plain version (bitwise, or on floats within the
reference tolerances), then timed by CUDA events (mean of 20 calls after
one warm-up), on the R-MAT graph of ``--scale`` (edge factor 16, seed
42, as ``chip_smoke.py``) or on ``bench.py``'s ratings graph of that
scale:

- K2 over the hybrid plan's tail on one device (x the (nv,) values) and
  over parts 0 and 3 of the P = 4 sharded tiled layout (x the (nvb, 128)
  table), adding into a row vector as the executors do; ``kThreads``,
  ``kBlockItems`` (the rows and edges a block owns), ``kStage`` and
  ``kMinBlocks`` (the resident blocks ``__launch_bounds__`` asks of
  ptxas).
- K4 over the grouped tail's root stream of the same plan (random f32
  values under the plan's lane mask and ``dst_row_ptr``), adding into a
  vector as the executor does: ``kThreads4``, ``kBlockItems4``,
  ``kStage4`` and ``kMinBlocks4`` of ``segment_sum.cu``.
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
- K7 on SSSP's queues, as phase 4b takes them: the first frontier
  (vertex 0), the sparse iteration with the most out-edges and a
  random frontier of the sparse branch's cap (nv // 16 + 128 vertices);
  and the one launch over the four parts of the sharded SSSP's sparse
  iteration with the most out-edges (phase 4f). K11 on the weighted
  graph's CSR with random values, over the frontiers {0}, 5% and 40% of
  the vertices, for (min, add1), DeltaSSSP's f32 (min, add_w) and
  k-core's (sum, one). Both over ``kQueueSlots`` (edge slots a chunk),
  ``kQueueStage`` (queue slots a chunk stages) and ``kQueueMinBlocks`` of
  ``gas_ops.cuh``. On each one-receiver queue the built-in kernel is
  also timed folding into an accumulator prepared beforehand (no copy or
  fill, no decode): what a kept accumulator, reset only where the last
  push touched it, would cost at least.
- P6 (``merge4``) at the probe's shape, R = 65,536 rows of 4 x 128
  candidates, uniform lanes and selectors: the kernel against one
  ``torch.gather`` over the same candidates, by means of 20 calls and by
  medians of 100 on a held card (``probes/gather.py::median_ms``).

With ``--old-csrc DIR``, a directory holding ``segment_sum.cu``,
``frontier.cu``, ``gas.cu`` and their headers (``lux_tpu_torch/csrc``
of a checkout of commit 77017f1), that source's K4 (work items and
partials in two launches, then the add into the strips' sums), K7 (a
clone of the values, then the fold; for the parts, a host read of their
totals and one launch a part) and K11 (an identity fill, then the fold
and, for f32, a decode launch) are built and timed first on the same
inputs, with and without their passes over every word.

``--only`` names the sweeps to run (default: all nine). It prints one
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

from lux_tpu_torch.graph.graph import Graph
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
K4_SHAPES = [dict(kThreads4=t, kBlockItems4=a, kStage4=b, kMinBlocks4=c)
             for t, a, b, c in ((128, 1024, 1536, 12), (256, 1024, 1536, 8),
                                (256, 2048, 3072, 6), (256, 2048, 2560, 6),
                                (256, 2048, 2048, 8), (256, 1536, 2304, 6),
                                (256, 4096, 5120, 4), (512, 4096, 6144, 4),
                                (512, 2048, 3072, 4), (128, 512, 768, 16))]
# (kQueueSlots, kQueueStage, kQueueMinBlocks); the first are the built-in.
# K11 takes the first four.
QUEUE_SHAPES = [dict(kQueueSlots=a, kQueueStage=b, kQueueMinBlocks=c)
                for a, b, c in (
                    (1024, 512, 4), (2048, 512, 4), (1024, 512, 6),
                    (512, 512, 4), (1024, 256, 4), (1024, 1024, 4),
                    (1024, 512, 8), (2048, 512, 2))]
K11_SHAPES = QUEUE_SHAPES[:4]
K11_OPS = (("min", "add1"), ("min", "add_w"), ("sum", "one"))
CF_TOL = dict(rtol=1e-4, atol=1e-7)   # tests/test_colfilter.py
PR_TOL = dict(rtol=5e-5, atol=1e-9)   # tests/test_tiled.py
# K4, K7 and K11 of commit 77017f1 (--old-csrc): their C signatures then.
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
OLD_ITEM = 64   # K4's work items then
OLD_SIGNATURES = {
    # data, nvalid, item_lo, n_items, row_items, nrows, partial, y, stream
    "lux_segment_sum_rowptr": (_P, _P, _P, _I64, _P, _I64, _P, _P, _P),
    # q, start, offs, cnt, total, col_dst, old, out, comb, relax, stream
    "lux_queue_relax_scatter": (_P, _P, _P, _I64, _I64, _P, _P, _P, _INT,
                                _INT, _P),
    # q, start, offs, cnt, total, col_dst, weights, values, op, acc, n_acc,
    # stream
    "lux_gas_push_acc": (_P, _P, _P, _I64, _I64, _P, _P, _P, _INT, _P, _I64,
                         _P),
}
OLD_SOURCES = {"k4": "segment_sum.cu", "k7": "frontier.cu", "k11": "gas.cu"}
REPS = 20
OUT = _cuda.BUILD_DIR / "shapes"
SWEEPS = ("k2", "k4", "k10", "k8", "k9", "k5", "k7", "k11", "p6")


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


def _variant_dir(name: str, tag: str, shape: dict) -> Path:
    """OUT/tag: a copy of csrc/ with each constant of ``shape`` set where
    it is declared: in source ``name``, else in the one header that
    declares it."""
    d = OUT / tag
    d.mkdir(parents=True)
    texts = {f.name: f.read_text() for f in _cuda.CSRC.glob("*.cu*")}
    headers = sorted(f for f in texts if f.endswith(".cuh"))
    for key, value in shape.items():
        pat = rf"(constexpr int {key} = )\d+;"
        where = [f for f in [name] + headers if re.search(pat, texts[f])]
        if not where:
            raise ValueError(f"csrc: no constexpr {key}")
        texts[where[0]], n = re.subn(pat, rf"\g<1>{value};",
                                     texts[where[0]])
        if n != 1:
            raise ValueError(f"{where[0]}: no single constexpr {key}")
    for f, text in texts.items():
        (d / f).write_text(text)
    return d


def build_variants(variants, old_csrc=None, old_sources=()):
    """{(source, tag): ctypes library} for (source name, tag, shape), and
    ("old", name) for each of ``old_sources`` in ``old_csrc``."""
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    nvcc = _cuda._nvcc()
    jobs = []
    for name, tag, shape in variants:
        d = _variant_dir(name, f"{tag}_{name}", shape)
        jobs.append(((name, tag), d / name, d, _cuda._SIGNATURES))
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


def time_p6(dev) -> None:
    """P6 at the probe's shape: the kernel and one ``torch.gather``, the
    kernel held bitwise to the plain version."""
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
    calls = {"merge4": lambda: _call(_cuda.library().lux_merge4, *args),
             "torch.gather": lambda: torch.gather(flat, 1, gidx)}
    calls["merge4"]()
    if not torch.equal(out, want):
        raise AssertionError("merge4: not bitwise")
    for rnd in range(2):
        print(f"[shapes] P6 R={r} round {rnd}: " + ", ".join(
            f"{name} {_ms(fn):.4f} ms (mean of {REPS}), "
            f"{pg.median_ms(fn, dev, 100, hold=True):.4f} ms (median of "
            f"100, held)" for name, fn in calls.items()), flush=True)


# -- K4 ----------------------------------------------------------------------


def _root_stream(plan, dev):
    """(root stream, nvalid, dst_row_ptr, integral stream): the grouped
    tail's root level of ``plan`` with random f32 values (its sums' work
    does not depend on them) and small integers."""
    from lux_tpu_torch.ops.merge_tail_kernel import DeviceGroupedTail
    from lux_tpu_torch.ops.merge_tail_plan import plan_grouped_tail

    t = time.perf_counter()
    gt = DeviceGroupedTail.build(
        plan_grouped_tail(plan.tail_sb, plan.tail_lane, plan.tail_row_ptr),
        dev)
    s = gt.nvalid_root.shape[0]
    print(f"[shapes] grouped plan in {time.perf_counter() - t:.1f} s: root "
          f"stream ({s}, 128), {gt.dst_row_ptr.shape[0] - 1} rows",
          flush=True)
    rng = np.random.default_rng(7)
    return (torch.from_numpy(rng.random((s, 128), dtype=np.float32)).to(dev),
            gt.nvalid_root, gt.dst_row_ptr,
            torch.from_numpy(rng.integers(0, 4, (s, 128)).astype(np.float32)
                             ).to(dev))


def sweep_k4(libs, root, dev, old=None) -> None:
    """Each of K4_SHAPES adding into a vector, held bitwise against the
    plain version on the integral stream; ``old`` (77017f1's library)
    first, with and without the add pass the engine then ran."""
    data, nvalid, rp, ints = root
    rows = rp.shape[0] - 1
    y0 = torch.from_numpy(np.random.default_rng(8).integers(
        0, 4, rows).astype(np.float32)).to(dev)
    want = seg.segment_sum_by_rowptr_plain(ints, rp, nvalid, y0.clone())
    label = f"K4 root stream {tuple(data.shape)}, {rows} rows"
    if old is not None:
        lo, ri = seg.segment_items(rp.cpu().numpy(), OLD_ITEM)
        item_lo, row_items = (torch.from_numpy(a).to(dev) for a in (lo, ri))
        n_items = lo.shape[0] - 1
        partial = torch.empty(n_items, dtype=torch.float32, device=dev)
        part = torch.empty(rows, dtype=torch.float32, device=dev)

        def kernel(x):
            _call(old.lux_segment_sum_rowptr, _cuda.ptr(x), _cuda.ptr(nvalid),
                  _cuda.ptr(item_lo), n_items, _cuda.ptr(row_items), rows,
                  _cuda.ptr(partial), _cuda.ptr(part), _cuda.stream(dev))

        def with_add(x):
            kernel(x)
            return y0 + part

        if not torch.equal(with_add(ints), want):
            raise AssertionError("old K4: not bitwise")
        print(f"[shapes] old {label} ({n_items} items of {OLD_ITEM}): "
              f"both passes {_ms(lambda: kernel(data)):.4f} ms, with the "
              f"add into the strips' sums {_ms(lambda: with_add(data)):.4f}"
              " ms", flush=True)
    for shape in K4_SHAPES:
        fn = libs["segment_sum.cu", _tag("k4", shape)].lux_segment_sum_rowptr
        y = y0.clone()

        def call(x, y=y, fn=fn):
            _call(fn, _cuda.ptr(x), _cuda.ptr(nvalid), x.numel(),
                  _cuda.ptr(rp), rows, 1, _cuda.ptr(y), _cuda.stream(dev))

        call(ints)
        if not torch.equal(y, want):
            raise AssertionError(f"K4 {shape}: not bitwise")
        print(f"[shapes] {label} {shape}: {_ms(lambda: call(data)):.4f} ms",
              flush=True)


# -- K7 and K11: the queue expansion ----------------------------------------


def _k7_states(g, dev):
    """(label, values, q, start, offs, col_dst, total) of K7 on SSSP's
    queues: the first frontier, the sparse iteration with the most
    out-edges, a random frontier of the cap (one receiver each); and the
    four receivers of the sharded SSSP's sparse iteration with the most
    out-edges ((P, cnt) start, (P, cnt + 1) offs, (P, ne) col_dst, (P,
    max_nv) values)."""
    from lux_tpu_torch.engine.push import PushExecutor
    from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor
    from lux_tpu_torch.models import SSSP
    from lux_tpu_torch.ops import frontier as fq

    ex = PushExecutor(g, SSSP())
    ex.run(start=0)
    _, at = max((b[2], i) for i, b in enumerate(ex.branch_log) if b[0] > 0)
    st, _ = ex.run(max_iters=at, start=0)
    pick = np.random.default_rng(42).choice(g.nv, size=ex.queue_cap,
                                            replace=False)
    cap = torch.zeros(g.nv, dtype=torch.bool)
    cap[torch.from_numpy(pick)] = True
    out = []
    for label, vals, fr in (
            ("SSSP's first frontier", *ex.init_state(start=0)),
            (f"SSSP iteration {at + 1}", st.values, st.frontier),
            (f"the cap, {ex.queue_cap} vertices", st.values, cap.to(dev))):
        cnt = int(fr.sum())
        q, start, _, offs = fq.frontier_queue(fr, ex.csr_row_ptr, cnt)
        out.append((label, vals, q, start, offs, ex.csr_col_dst,
                    int(offs[-1])))
    sx = ShardedPushExecutor(g, SSSP(), num_parts=4)
    sx.run(start=0)
    _, at = max((b[2], i) for i, b in enumerate(sx.branch_log) if b[0] > 0)
    st, _ = sx.run(max_iters=at, start=0)
    stats = sx._frontier_stats(st)
    rows, ids = sx._sparse_load(st, stats)
    start = sx.push_row_ptr[:, ids]
    offs = torch.nn.functional.pad(
        (sx.push_row_ptr[:, ids + 1] - start).cumsum(1), (1, 0))
    out.append((f"sharded SSSP iteration {at + 1}, 4 parts", st.values,
                rows, start, offs, sx.push_dst_local, stats[1]))
    return out


def _fold_args(values, q, start, offs, col_dst, total, out, scratch, dev,
               fold_only=False):
    """The C arguments of the new K7 over one or P receivers; with
    ``fold_only`` no word is copied (n = 0: the fold alone, one receiver
    only)."""
    parts = 1 if start.dim() == 1 else start.shape[0]
    n = 0 if fold_only else values.numel() // parts
    return (_cuda.ptr(q), _cuda.ptr(start), _cuda.ptr(offs), q.shape[0],
            parts, _cuda.ptr(col_dst), col_dst.shape[-1], _cuda.ptr(values),
            _cuda.ptr(out), n, total, _cuda.ptr(scratch), 0, 0,
            _cuda.stream(dev))


def sweep_k7(libs, states, dev, old=None) -> None:
    """Each of QUEUE_SHAPES on each state, bitwise against the plain
    version; the built-in kernel also folding alone into a copy made
    beforehand; ``old`` (77017f1's library) first, with its clone (and,
    over the parts, its host read and a launch a part) and without."""
    from lux_tpu_torch.ops import frontier as fq

    scratch = fq._queue_scratch(dev, _cuda.stream(dev).value)
    relax = seg.RELAX_OPS["add1"]
    for label, vals, q, start, offs, col, total in states:
        want = fq.queue_relax_scatter_plain(q, start, offs, col, vals, "min",
                                            relax)
        head = f"K7 {label} (cnt={q.shape[0]}, {total} edges)"
        if old is not None:
            flat = vals.reshape(-1)
            k = old.lux_queue_relax_scatter
            if start.dim() == 1:
                def step(out=None):
                    out = vals.clone() if out is None else out
                    _call(k, _cuda.ptr(q), _cuda.ptr(start), _cuda.ptr(offs),
                          q.shape[0], total, _cuda.ptr(col), _cuda.ptr(vals),
                          _cuda.ptr(out), 0, 0, _cuda.stream(dev))
                    return out
            else:
                def step(out=None):
                    totals = offs[:, -1].tolist()
                    out = vals.clone() if out is None else out
                    for p, tp in enumerate(totals):
                        if tp:
                            _call(k, _cuda.ptr(q), _cuda.ptr(start[p]),
                                  _cuda.ptr(offs[p]), q.shape[0], tp,
                                  _cuda.ptr(col[p]), _cuda.ptr(flat),
                                  _cuda.ptr(out[p]), 0, 0, _cuda.stream(dev))
                    return out
            if not torch.equal(step(), want):
                raise AssertionError(f"old {head}: not bitwise")
            pre = vals.clone()
            print(f"[shapes] old {head}: with its clone"
                  f"{' and host read' if start.dim() > 1 else ''} "
                  f"{_ms(step):.4f} ms, the fold alone "
                  f"{_ms(lambda: step(pre)):.4f} ms", flush=True)
        for i, shape in enumerate(QUEUE_SHAPES):
            fn = libs["frontier.cu", _tag("k7", shape)].lux_queue_relax_scatter
            out = torch.empty_like(vals)
            args = _fold_args(vals, q, start, offs, col, total, out, scratch,
                              dev)
            _call(fn, *args)
            if not torch.equal(out, want):
                raise AssertionError(f"{head} {shape}: not bitwise")
            line = f"{_ms(lambda: _call(fn, *args)):.4f} ms"
            if i == 0 and start.dim() == 1:
                pre = vals.clone()
                alone = _fold_args(vals, q, start, offs, col, total, pre,
                                   scratch, dev, fold_only=True)
                _call(fn, *alone)
                if not torch.equal(pre, want):
                    raise AssertionError(f"{head}: the fold alone differs")
                line += (f"; folding alone into a copy made beforehand "
                         f"{_ms(lambda: _call(fn, *alone)):.4f} ms")
            print(f"[shapes] {head} {shape}: {line}", flush=True)


def _k11_states(gw, dev):
    """(label, q, start, offs, total) of K11 on the weighted graph's CSR,
    and the CSR (col_dst, weights): the frontiers {0}, 5% and 40% of the
    vertices (numpy seed 9)."""
    from lux_tpu_torch.ops import frontier as fq

    csr = gw.csr()
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rp, col, w = put(csr.row_ptr), put(csr.col_dst), put(csr.weights)
    rng = np.random.default_rng(9)
    out = []
    for label, fr in (("frontier {0}", np.arange(gw.nv) == 0),
                      ("5% frontier", rng.random(gw.nv) < 0.05),
                      ("40% frontier", rng.random(gw.nv) < 0.4)):
        cnt = int(fr.sum())
        q, start, _, offs = fq.frontier_queue(put(fr), rp, cnt)
        out.append((label, q, start, offs, int(offs[-1])))
    return out, col, w


def _gas_values(nv, gather_op, dev):
    rng = np.random.default_rng(10)
    if gather_op == "add_w":
        v = rng.integers(0, 10**6, nv).astype(np.float32)
        v[rng.random(nv) < 0.2] = np.inf
        return torch.from_numpy(v).to(dev)
    return seg.to_u32_storage(rng.integers(0, 2**32, nv, dtype=np.uint64)
                              .astype(np.uint32), dev)


def sweep_k11(libs, states, col, w, nv, dev, old=None) -> None:
    """Each of K11_SHAPES on each state for K11_OPS, bitwise against the
    plain version; the built-in kernel also folding alone into an
    accumulator filled beforehand (no fill, no decode); ``old`` first,
    with its fill and without."""
    from lux_tpu_torch.ops import frontier as fq

    scratch = fq._queue_scratch(dev, _cuda.stream(dev).value)
    for label, q, start, offs, total in states:
        for kind, gop in K11_OPS:
            vals = _gas_values(nv, gop, dev)
            op = seg.gas_kernel_code(kind, gop)
            want = fq.gas_push_acc_plain(q, start, offs, col, vals, kind,
                                         seg.GATHER_OPS[gop], w)
            # The accumulator's first words: the identity, or for f32 min
            # the key of +inf (0xFF800000) that the kernels fold into.
            key = seg.gas_identity_storage(kind, vals.shape, vals.dtype,
                                           dev).view(torch.int32).clone()
            if gop == "add_w":
                key.fill_(-8388608)
            head = (f"K11 ({kind}, {gop}) {label} (cnt={q.shape[0]}, "
                    f"{total} edges)")
            base = (_cuda.ptr(q), _cuda.ptr(start), _cuda.ptr(offs),
                    q.shape[0], total, _cuda.ptr(col), _cuda.ptr(w),
                    _cuda.ptr(vals), op)
            if old is not None:
                acc = torch.empty_like(key)

                def step(fill=True):
                    if fill:
                        acc.copy_(key)
                    _call(old.lux_gas_push_acc, *base, _cuda.ptr(acc),
                          acc.numel(), _cuda.stream(dev))

                step()
                if not torch.equal(acc.view(vals.dtype), want):
                    raise AssertionError(f"old {head}: not bitwise")
                print(f"[shapes] old {head}: with its fill "
                      f"{_ms(step):.4f} ms, without "
                      f"{_ms(lambda: step(False)):.4f} ms", flush=True)
            for i, shape in enumerate(K11_SHAPES):
                fn = libs["gas.cu", _tag("k11", shape)].lux_gas_push_acc
                acc = torch.empty_like(vals)
                args = (*base, _cuda.ptr(acc), acc.numel(),
                        _cuda.ptr(scratch), _cuda.stream(dev))
                _call(fn, *args)
                if not torch.equal(acc, want):
                    raise AssertionError(f"{head} {shape}: not bitwise")
                line = f"{_ms(lambda: _call(fn, *args)):.4f} ms"
                if i == 0:
                    pre = key.clone()
                    alone = (*base, _cuda.ptr(pre), 0, _cuda.ptr(scratch),
                             _cuda.stream(dev))
                    line += (f"; folding alone into an accumulator filled "
                             f"beforehand {_ms(lambda: _call(fn, *alone)):.4f}"
                             " ms")
                print(f"[shapes] {head} {shape}: {line}", flush=True)


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
                    help="time the K4, K7 and K11 of this directory's "
                         "segment_sum.cu, frontier.cu and gas.cu too")
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
    for key, source, shapes in (
            ("k2", "segment_sum.cu", K2_SHAPES),
            ("k4", "segment_sum.cu", K4_SHAPES),
            ("k10", "gas.cu", K10_KERNEL_SHAPES),
            ("k8", "pull_sum.cu", _kernel_shapes(K8_CASES)),
            ("k9", "pull_sum.cu", _kernel_shapes(K9_CASES)),
            ("k5", "gas.cu", _kernel_shapes(K5_CASES)),
            ("k7", "frontier.cu", QUEUE_SHAPES),
            ("k11", "gas.cu", K11_SHAPES)):
        if key in only:
            variants += [(source, _tag(key, s), s) for s in shapes]
    olds = () if args.old_csrc is None else [
        OLD_SOURCES[k] for k in OLD_SOURCES if k in only]
    libs = build_variants(variants, args.old_csrc, olds)
    old = lambda k: libs.get(("old", OLD_SOURCES[k]))
    print(f"[shapes] {len(libs)} variants built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if only & {"k2", "k4", "k8", "k10", "k5", "k7", "k11"}:
        t = time.perf_counter()
        gw = generate.rmat(args.scale, 16, seed=42, weighted=True)
        g = Graph(nv=gw.nv, ne=gw.ne, row_ptr=gw.row_ptr,
                  col_src=gw.col_src)
        print(f"[shapes] rmat({args.scale}, 16, weighted=True) in "
              f"{time.perf_counter() - t:.1f} s; g is it without weights",
              flush=True)
        if "k7" in only:
            states = _k7_states(g, dev)
            sweep_k7(libs, states, dev, old("k7"))
            del states
            torch.cuda.empty_cache()
        if "k11" in only:
            states, col, w = _k11_states(gw, dev)
            sweep_k11(libs, states, col, w, gw.nv, dev, old("k11"))
            del states, col, w
            torch.cuda.empty_cache()
        if "k5" in only:
            states = _k5_states(g, dev)
            sweep_k5(libs, states, dev)
            del states
            torch.cuda.empty_cache()
        if "k8" in only:
            sweep_pull(libs, g, "copy", 0, dev)
        if "k10" in only:
            sweep_k10(libs, g, dev)
        if only & {"k2", "k4"}:
            t = time.perf_counter()
            plan = plan_hybrid(g)
            print(f"[shapes] plan in {time.perf_counter() - t:.1f} s",
                  flush=True)
            if "k2" in only:
                sweep_k2(libs, plan, dev)
            if "k4" in only:
                sweep_k4(libs, _root_stream(plan, dev), dev, old("k4"))
            del plan
        del g, gw
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
        time_p6(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
