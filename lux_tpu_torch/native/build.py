"""Lazy build + ctypes binding for ``lux_native.cc``, the counterpart of
``lux_tpu/native/build.py``.

Compiled once with ``g++`` into ``build/lux_tpu_torch/`` at the root of
the checkout (``LUX_NATIVE_CACHE`` names another directory), as
``lux_native_<source hash>.so``, so a changed source builds anew. All
argtypes are configured here — ctypes' default c_int conversion would
truncate 64-bit pointers and sizes (R-MAT 27 has ne = 2^31). A failed
build is recorded (the process falls back to numpy from then on) and
logged once; :func:`available` reports it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "lux_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lux_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None
_FAILED: Optional[str] = None   # why the build failed, once it has
_WARNED = False


def cache_dir() -> Path:
    from lux_tpu_torch.utils import flags

    base = Path(flags.get("LUX_NATIVE_CACHE") or BUILD_DIR)
    base.mkdir(parents=True, exist_ok=True)
    return base


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.lux_load.restype = ctypes.c_int
    lib.lux_load.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.lux_convert_edge_list.restype = ctypes.c_int
    lib.lux_convert_edge_list.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.lux_build_csr.restype = ctypes.c_int
    lib.lux_build_csr.argtypes = [
        ctypes.c_uint32,
        ctypes.c_uint64,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return lib


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return cache_dir() / f"lux_native_{digest}.so"


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the native library. Raises on any
    failure, and on every later call once a build has failed."""
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _FAILED is not None:
            raise RuntimeError(f"native build previously failed: {_FAILED}")
        try:
            so_path = library_path()
            if not so_path.exists():
                cxx = shutil.which(CXX)
                if cxx is None:
                    raise RuntimeError(f"C++ compiler {CXX!r} not found")
                tmp = so_path.with_name(so_path.name + f".tmp{os.getpid()}")
                proc = subprocess.run(
                    [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                    capture_output=True, text=True,
                )
                if proc.returncode:
                    raise RuntimeError(
                        f"{CXX} exited {proc.returncode}: "
                        f"{proc.stderr.strip()[-2000:]}")
                os.replace(tmp, so_path)
            _LIB = _configure(ctypes.CDLL(str(so_path)))
            return _LIB
        except Exception as e:
            _FAILED = repr(e)
            raise


def maybe_library():
    """:func:`load_library` or None — the soft-failure wrapper every
    native call site uses before falling back to numpy. The first
    failure is logged as a warning; later calls return None quietly."""
    global _WARNED
    try:
        return load_library()
    except Exception as e:
        with _LOCK:
            first, _WARNED = not _WARNED, True
        if first:
            from lux_tpu_torch.utils.logging import get_logger

            get_logger("native").warning(
                "native library unavailable, using the numpy paths: %s", e)
        return None


def available() -> bool:
    """True when the native library builds and loads in this process."""
    return maybe_library() is not None


def build_error() -> Optional[str]:
    """Why the build failed, or None (not tried yet, or it worked)."""
    return _FAILED
