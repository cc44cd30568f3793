"""Host-side graph data model.

The reference (Lux) stores graphs in binary CSC: edges sorted by destination
vertex, with per-vertex *end* offsets (reference: README.md "Graph Format",
tools/converter.cc:108-124). Like the JAX package, this keeps SoA numpy
arrays, not the reference's AoS ``NodeStruct``/``EdgeStruct``
(core/graph.h:26-34); the file is a copy of ``lux_tpu/graph/graph.py``
without its native CSR builder.

Conventions:
- ``row_ptr`` has length ``nv + 1`` with a leading 0 (the reference keeps
  only the ``nv`` end-offsets; we add the implicit 0 so slices are uniform).
- ``col_src[row_ptr[v]:row_ptr[v+1]]`` are the in-neighbors (sources) of
  vertex ``v``.
- ``out_degrees`` counts each vertex's appearances as a source, matching the
  reference's scan task (core/pull_model.inl:322-345) and the converter's
  trailing degree array (tools/converter.cc:84-92).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

V_DTYPE = np.uint32  # V_ID in the reference (pagerank/app.h:21)
E_DTYPE = np.uint64  # E_ID in the reference (pagerank/app.h:22)
W_DTYPE = np.int32   # WeightType in the reference (col_filter/app.h:23)


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` as int64, for integer keys (such
    as vertex ids). Keys in ``[0, 2**31)`` take one in-place sort of
    ``key << 32 | position``: the packed values are distinct, so any sort
    gives the stable order, and numpy's int64 sort is several times
    faster than its stable sort of keys wider than 16 bits (a
    timsort)."""
    keys = np.asarray(keys)
    n = keys.shape[0]
    if n == 0 or n >= 2**32 or keys.min() < 0 or keys.max() >= 2**31:
        return np.argsort(keys, kind="stable").astype(np.int64)
    packed = keys.astype(np.int64) << 32
    packed |= np.arange(n, dtype=np.int64)
    packed.sort()
    packed &= 0xFFFFFFFF
    return packed


@dataclasses.dataclass(eq=False)
class Graph:
    """A host-side CSC graph (in-edges, sorted by destination).

    ``eq=False``: ndarray fields make the generated ``__eq__`` raise; compare
    fields explicitly with ``np.array_equal`` where needed.
    """

    nv: int
    ne: int
    row_ptr: np.ndarray               # int64 (nv+1,), row_ptr[0] == 0
    col_src: np.ndarray               # int32  (ne,) source vertex per in-edge
    weights: Optional[np.ndarray] = None    # int32 (ne,) or None
    _out_degrees: Optional[np.ndarray] = None  # lazily computed
    _csr: Optional["Csr"] = None               # lazily built out-edge view
    _col_dst: Optional[np.ndarray] = None      # lazily expanded CSC dsts

    def __post_init__(self):
        self.nv = int(self.nv)
        self.ne = int(self.ne)
        assert self.row_ptr.shape == (self.nv + 1,)
        assert self.row_ptr[0] == 0 and self.row_ptr[-1] == self.ne
        assert self.col_src.shape == (self.ne,)
        if self.weights is not None:
            assert self.weights.shape == (self.ne,)

    # -- degrees ---------------------------------------------------------

    @property
    def in_degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int64)

    @property
    def out_degrees(self) -> np.ndarray:
        if self._out_degrees is None:
            # Chunked so a memory-mapped col_src (read_lux_mmap at RMAT27
            # scale) is streamed once instead of materialized, and the
            # bincount temp stays bounded; harmless for in-RAM arrays.
            chunk = 1 << 27
            deg = np.zeros(self.nv, dtype=np.int64)
            for s in range(0, self.ne, chunk):
                deg += np.bincount(
                    self.col_src[s : s + chunk], minlength=self.nv
                )
            self._out_degrees = deg
        return self._out_degrees

    @property
    def weighted(self) -> bool:
        return self.weights is not None

    # -- derived views ---------------------------------------------------

    @property
    def col_dst(self) -> np.ndarray:
        """Destination vertex per in-edge (expansion of the CSC segments).

        Cached: executor builds hit this several times, and at RMAT27
        scale each np.repeat is a multi-GB host materialization.
        """
        if self._col_dst is None:
            self._col_dst = np.repeat(
                np.arange(self.nv, dtype=np.int32), self.in_degrees
            )
        return self._col_dst

    def csr(self) -> "Csr":
        """Out-edge (push) view: edges grouped by source.

        The reference builds this per GPU at init time via a degree
        histogram + prefix sum + scatter (sssp/sssp_gpu.cu:550-607);
        here it is a stable argsort by source (the JAX package's numpy
        path, by :func:`stable_argsort`; its native C++ CSR build is not
        ported).
        """
        if self._csr is None:
            self._csr = self._csr_numpy()
        return self._csr

    def _csr_numpy(self) -> "Csr":
        order = stable_argsort(self.col_src)
        dst = self.col_dst[order].astype(np.int32)
        ptr = np.zeros(self.nv + 1, dtype=np.int64)
        np.cumsum(self.out_degrees, out=ptr[1:])
        w = None if self.weights is None else self.weights[order]
        return Csr(row_ptr=ptr, col_dst=dst, weights=w)

    # -- constructors ----------------------------------------------------

    @staticmethod
    def from_edges(
        src: np.ndarray,
        dst: np.ndarray,
        nv: int,
        weights: Optional[np.ndarray] = None,
    ) -> "Graph":
        """Build CSC from an arbitrary edge list (sorts by dst, stable —
        same ordering the reference converter produces, converter.cc:98)."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        ne = src.shape[0]
        order = stable_argsort(dst)
        src_sorted = src[order].astype(np.int32)
        dst_sorted = dst[order]
        row_ptr = np.zeros(nv + 1, dtype=np.int64)
        np.cumsum(np.bincount(dst_sorted, minlength=nv), out=row_ptr[1:])
        w = None if weights is None else np.asarray(weights)[order].astype(W_DTYPE)
        return Graph(nv=nv, ne=ne, row_ptr=row_ptr, col_src=src_sorted, weights=w)

    def __repr__(self):
        return (
            f"Graph(nv={self.nv}, ne={self.ne}, "
            f"weighted={self.weights is not None})"
        )


@dataclasses.dataclass(eq=False)
class Csr:
    """Out-edge view: ``col_dst[row_ptr[u]:row_ptr[u+1]]`` are the
    destinations of u's out-edges."""

    row_ptr: np.ndarray   # int64 (nv+1,)
    col_dst: np.ndarray   # int32 (ne,)
    weights: Optional[np.ndarray] = None
