"""Shape sweep of K2 (``tail_gather_sum``) and K10 (``gas_pull_acc``) on
the card.

    python -m lux_tpu_torch.probes.shapes [--scale 22]

Each variant is a copy of ``csrc/segment_sum.cu`` or ``csrc/gas.cu`` with
other tier thresholds (the ``constexpr`` lines named below), compiled by
its own ``nvcc`` (all started together) into its own library under
``build/lux_tpu_torch/shapes/`` and called through ctypes as the
package's wrappers call the built-in kernels. Every variant is first held
bitwise against the plain version, then timed by CUDA events (mean of 20
calls after one warm-up), on the R-MAT graph of ``--scale`` (edge factor
16, seed 42, as ``chip_smoke.py``):

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

It prints one line per variant and shape, and the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import re
import shutil
import subprocess
import time

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
REPS = 20
OUT = _cuda.BUILD_DIR / "shapes"


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


def build_variants(variants):
    """{(source, tag): ctypes library} for (source name, tag, shape)."""
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    nvcc = _cuda._nvcc()
    procs = []
    for name, tag, shape in variants:
        src = OUT / f"{tag}_{name}"
        src.write_text(_variant_source(name, shape))
        lib = OUT / f"lib{tag}.so"
        procs.append(((name, tag), lib, subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-shared",
             str(src), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, lib, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        handle = ctypes.CDLL(str(lib))
        for fn, args in _cuda._SIGNATURES.items():
            if hasattr(handle, fn):
                getattr(handle, fn).argtypes = list(args)
                getattr(handle, fn).restype = ctypes.c_int
        libs[key] = handle
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


def _tag(kernel: str, shape: dict) -> str:
    return kernel + "_" + "_".join(f"{k}{v}" for k, v in shape.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22)
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
    t = time.perf_counter()
    libs = build_variants(
        [("segment_sum.cu", _tag("k2", s), s) for s in K2_SHAPES]
        + [("gas.cu", _tag("k10", s), s) for s in K10_KERNEL_SHAPES])
    print(f"[shapes] {len(libs)} variants built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    g = generate.rmat(args.scale, 16, seed=42)
    print(f"[shapes] rmat({args.scale}, 16) in {time.perf_counter() - t:.1f}"
          " s", flush=True)
    sweep_k10(libs, g, dev)
    t = time.perf_counter()
    plan = plan_hybrid(g)
    print(f"[shapes] plan in {time.perf_counter() - t:.1f} s", flush=True)
    sweep_k2(libs, plan, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
