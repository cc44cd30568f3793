"""IO entry points: converter / loader, the counterpart of
``lux_tpu/native/io.py``.

Each function prefers the native C++ implementation (built lazily by
:mod:`lux_tpu_torch.native.build`) and falls back to the numpy paths of
:mod:`lux_tpu_torch.graph.format`, which give the same bytes. The CSR
build is ``Graph.csr()`` (``graph/graph.py::Graph._csr_native``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from lux_tpu_torch.graph import format as lux_format
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.native.build import maybe_library

__all__ = ["convert_edge_list", "read_lux"]


def convert_edge_list(
    input_path: str,
    output_path: str,
    nv: int,
    ne: int,
    weighted: bool = False,
) -> None:
    lib = maybe_library()
    if lib is not None:
        # Explicit width wrappers: bare Python ints default to 32-bit c_int
        # and would overflow for ne >= 2**31 (RMAT27 has ne == 2**31).
        rc = lib.lux_convert_edge_list(
            input_path.encode(),
            output_path.encode(),
            ctypes.c_uint32(nv),
            ctypes.c_uint64(ne),
            ctypes.c_int(int(weighted)),
        )
        if rc == 0:
            return
    lux_format.convert_edge_list(input_path, output_path, nv, ne,
                                 weighted=weighted)


def read_lux(path: str, weighted: Optional[bool] = None) -> Graph:
    """Load a .lux graph; the native path does a multithreaded read of
    the mapped file (the host equivalent of the reference's per-part CPU
    load tasks, core/pull_model.inl:253-320)."""
    lib = maybe_library()
    if lib is not None:
        nv, ne, has_w, _ = lux_format.detect_layout(path)
        if weighted is None:
            weighted = has_w
        row_ptr = np.zeros(nv + 1, dtype=np.int64)
        col_src = np.empty(ne, dtype=np.int32)
        w = np.empty(ne, dtype=np.int32) if weighted else None
        # Wrap raw addresses in c_void_p: bare Python ints would be
        # truncated to 32-bit c_int by ctypes' default conversion.
        rc = lib.lux_load(
            path.encode(),
            ctypes.c_uint32(nv),
            ctypes.c_uint64(ne),
            ctypes.c_void_p(row_ptr[1:].ctypes.data),
            ctypes.c_void_p(col_src.ctypes.data),
            ctypes.c_void_p(w.ctypes.data) if w is not None else None,
        )
        if rc == 0:
            lux_format.validate_row_ptr(row_ptr[1:], ne, path)
            return Graph(nv=nv, ne=ne, row_ptr=row_ptr, col_src=col_src,
                         weights=w)
    return lux_format.read_lux(path, weighted=weighted)
