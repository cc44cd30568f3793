"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``lux_tpu_torch/csrc/*.cu`` behind a plain C
interface. On first use each source is compiled by its own ``nvcc``
process (all started together) for ``sm_90a``, the objects are linked
into ``build/lux_tpu_torch/libluxk.so`` at the root of the checkout, and
the library is loaded with ctypes. It is rebuilt when the hash of the
sources and flags changes. Pointers and the stream pass as
``ctypes.c_void_p``; every C entry point returns ``cudaGetLastError()``
and :func:`launch` raises if that is not 0.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lux_tpu_torch"
LIB_NAME = "libluxk.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("strip_spmv", "tail_gather_sum", "level_apply", "segment_sum_rowptr",
     "segment_minmax_relax", "frontier_queue", "queue_relax_scatter",
     "gather_segment_sum", "cf_edge_sum", "gas_pull_acc", "gas_push_acc",
     # K10's frontier pack launched alone (K10 runs it inside its call)
     "frontier_bits",
     # the gather probes (lux_tpu_torch/probes), one name per kernel form
     "block_take[axis=0 int32]", "block_take[axis=0 int8]",
     "block_take[axis=1 int32]", "block_take[axis=1 int8]", "merge4"), 0
)

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    # src, cnt, x2d, item_lo, n_items, row_items, nrows, row0, accumulate,
    # partial, y, stream
    "lux_strip_spmv": (_P, _P, _P, _P, _I64, _P, _I64, _I64, _INT, _P, _P,
                       _P),
    # x, src, m4, row_ptr, nrows, accumulate, y, stream
    "lux_tail_gather_sum": (_P, _P, _I64, _P, _I64, _INT, _P, _P),
    # data, nvalid (nullable), n, row_ptr, nrows, accumulate, y, stream
    "lux_segment_sum_rowptr": (_P, _P, _I64, _P, _I64, _INT, _P, _P),
    # x, arow, brow, codes, S, out, stream
    "lux_level_apply": (_P, _P, _P, _P, _I64, _P, _P),
    # packed, values, frontier, n_tab, col_src, row_ptr, tasks, n_tasks,
    # n_hub, comb, relax, bits, acc, stream
    "lux_segment_minmax_relax": (_P, _P, _P, _I64, _P, _P, _P, _I64, _I64,
                                 _INT, _INT, _P, _P, _P),
    # frontier, nv, rp, scratch, scratch_blocks, cap, q, start, deg, offs,
    # stream
    "lux_frontier_queue": (_P, _I64, _P, _P, _I64, _I64, _P, _P, _P, _P,
                           _P),
    # q, start, offs, cnt, parts, col_dst, dst_stride, old, out, n, total,
    # scratch, comb, relax, stream
    "lux_queue_relax_scatter": (_P, _P, _P, _I64, _INT, _P, _I64, _P, _P,
                                _I64, _I64, _P, _INT, _INT, _P),
    # vals, col_src, row_ptr, tasks, n_tasks, n_hub, y, stream
    "lux_gather_segment_sum": (_P, _P, _P, _P, _I64, _I64, _P, _P),
    # vals, col_src, weights, row_ptr, tasks, n_tasks, n_hub, row_base, y,
    # stream
    "lux_cf_edge_sum": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P),
    # values, frontier, n_tab, col_src, weights, row_ptr, tasks, n_tasks,
    # n_hub, k, op, bits, acc, stream
    "lux_gas_pull_acc": (_P, _P, _I64, _P, _P, _P, _P, _I64, _I64, _INT,
                         _INT, _P, _P, _P),
    # frontier, n, k, bits, stream
    "lux_frontier_bits": (_P, _I64, _INT, _P, _P),
    # q, start, offs, cnt, parts, total, col_dst, dst_stride, weights,
    # values, op, acc, acc_stride, n_acc, scratch, stream
    "lux_gas_push_acc": (_P, _P, _P, _I64, _INT, _I64, _P, _I64, _P, _P,
                         _INT, _P, _I64, _I64, _P, _P),
    # x, idx, rows, L, S, axis, idx_bytes, out, stream
    "lux_block_take": (_P, _P, _I64, _INT, _INT, _INT, _INT, _P, _P),
    # cand, l, s, R, out, stream
    "lux_merge4": (_P, _P, _P, _I64, _P, _P),
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels into ``BUILD_DIR/libluxk.so`` unless a build
    of the same sources is already there. Compiler output (including
    ptxas register and spill counts) goes to ``BUILD_DIR/nvcc.log``."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "libluxk.hash"
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="obj."))
    try:
        sources = sorted(CSRC.glob("*.cu"))
        procs = [
            (src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", str(src),
                 "-o", str(tmp / (src.stem + ".o"))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src in sources
        ]
        log, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{out}")
            if p.returncode:
                failed.append(src.name)
        (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", *(str(tmp / (s.stem + ".o")) for s in sources),
             "-o", str(tmp / LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp / LIB_NAME, lib)
        stamp.write_text(digest)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(kernel: str, fn: str, *args) -> None:
    """Call C entry point ``fn``; raise on a CUDA error, else count one
    launch of ``kernel``."""
    rc = getattr(library(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")
    LAUNCHES[kernel] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          device: torch.device, ndim: Optional[int] = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` on
    ``device`` (and of rank ``ndim``, when given)."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
