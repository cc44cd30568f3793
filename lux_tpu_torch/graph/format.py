"""Bit-compatible reader/writer for the ``.lux`` binary CSC format.

Layout (reference: README.md "Graph Format"; writer: tools/converter.cc:108-124;
reader offsets: core/pull_model.inl:296-320):

    nv        uint32  (1)
    ne        uint64  (1)
    row_ptrs  uint64  (nv)    -- *end* offsets; row_ptrs[nv-1] == ne
    col_srcs  uint32  (ne)    -- in-edge sources, edges sorted by dst
    [weights  int32   (ne)]   -- only for weighted graphs (EDGE_WEIGHT apps;
                                 core/pull_model.inl:309-318)
    [degrees  uint32  (nv)]   -- trailing out-degree array written by the
                                 converter but never read back by any app
                                 (converter.cc:123; apps recompute degrees
                                 via the scan task, pull_model.inl:322-345)

All fields little-endian.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from lux_tpu_torch.graph.graph import Graph

FILE_HEADER_SIZE = 12  # sizeof(u32 nv) + sizeof(u64 ne), matches core/graph.h


def detect_layout(path: str) -> Tuple[int, int, bool, bool]:
    """Infer (nv, ne, has_weights, has_degrees) from the header + file size."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        nv = int(np.fromfile(f, dtype="<u4", count=1)[0])
        ne = int(np.fromfile(f, dtype="<u8", count=1)[0])
    base = FILE_HEADER_SIZE + 8 * nv + 4 * ne
    for has_w in (False, True):
        for has_d in (False, True):
            if size == base + (4 * ne if has_w else 0) + (4 * nv if has_d else 0):
                return nv, ne, has_w, has_d
    raise ValueError(
        f"{path}: size {size} inconsistent with header nv={nv} ne={ne}"
    )


def read_lux(path: str, weighted: Optional[bool] = None) -> Graph:
    """Read a ``.lux`` file into a host :class:`Graph`.

    ``weighted=None`` auto-detects from the file size; pass an explicit
    bool to disambiguate the (rare) case where 4*ne == 4*nv and both
    layouts match.
    """
    nv, ne, has_w, has_d = detect_layout(path)
    if weighted is not None and weighted != has_w:
        # The caller overrides auto-detection; the override must still be
        # consistent with the file size.
        size = os.path.getsize(path)
        want = FILE_HEADER_SIZE + 8 * nv + 4 * ne + (4 * ne if weighted else 0)
        if size != want and size != want + 4 * nv:
            raise ValueError(
                f"{path}: weighted={weighted} inconsistent with size {size}"
            )
        has_w = weighted
    with open(path, "rb") as f:
        f.seek(FILE_HEADER_SIZE)
        ends = np.fromfile(f, dtype="<u8", count=nv).astype(np.int64)
        col_src = np.fromfile(f, dtype="<u4", count=ne).astype(np.int32)
        weights = (
            np.fromfile(f, dtype="<i4", count=ne) if has_w else None
        )
    if len(ends) != nv or len(col_src) != ne or (has_w and len(weights) != ne):
        raise ValueError(f"{path}: truncated file")
    row_ptr = np.zeros(nv + 1, dtype=np.int64)
    row_ptr[1:] = ends
    validate_row_ptr(ends, ne, path)
    return Graph(nv=nv, ne=ne, row_ptr=row_ptr, col_src=col_src, weights=weights)


def read_lux_mmap(path: str) -> Graph:
    """Read a ``.lux`` file with the edge array memory-mapped.

    At the reference's headline scale (RMAT27, 2^31 edges = 8.6 GB of
    col_src) a materializing read costs two full copies of host RAM;
    here ``col_src`` stays a read-only ``np.memmap`` view (uint32 —
    consumers slice and convert per partition) and only the (nv+1)
    row_ptr array (1.07 GB at RMAT27) is materialized. Weights, if
    present, are mapped the same way. Out-degrees stay lazy —
    ``Graph.out_degrees`` bincounts in chunks, so a first touch streams
    the mmap once instead of materializing it.
    """
    nv, ne, has_w, _ = detect_layout(path)
    with open(path, "rb") as f:
        f.seek(FILE_HEADER_SIZE)
        ends = np.fromfile(f, dtype="<u8", count=nv).astype(np.int64)
    validate_row_ptr(ends, ne, path)
    row_ptr = np.zeros(nv + 1, dtype=np.int64)
    row_ptr[1:] = ends
    edge_off = FILE_HEADER_SIZE + 8 * nv
    col_src = np.memmap(path, dtype="<u4", mode="r", offset=edge_off,
                        shape=(ne,))
    weights = (
        np.memmap(path, dtype="<i4", mode="r",
                  offset=edge_off + 4 * ne, shape=(ne,))
        if has_w else None
    )
    return Graph(nv=nv, ne=ne, row_ptr=row_ptr, col_src=col_src,
                 weights=weights)


def validate_row_ptr(ends: np.ndarray, ne: int, path: str) -> None:
    """Reject non-monotone end-offsets / wrong edge totals (the reference
    asserts the same on load, pull_model.inl:100-102)."""
    if len(ends) > 0 and (not np.all(np.diff(ends) >= 0) or ends[-1] != ne):
        raise ValueError(f"{path}: non-monotone row_ptrs or bad edge count")


def write_lux(path: str, g: Graph, include_degrees: bool = True) -> None:
    """Write a :class:`Graph` in the reference binary layout."""
    with open(path, "wb") as f:
        np.asarray([g.nv], dtype="<u4").tofile(f)
        np.asarray([g.ne], dtype="<u8").tofile(f)
        g.row_ptr[1:].astype("<u8").tofile(f)
        g.col_src.astype("<u4").tofile(f)
        if g.weights is not None:
            g.weights.astype("<i4").tofile(f)
        if include_degrees:
            g.out_degrees.astype("<u4").tofile(f)


def convert_edge_list(
    input_path: str,
    output_path: str,
    nv: int,
    ne: int,
    weighted: bool = False,
    include_degrees: bool = True,
) -> Graph:
    """Text edge list (``src dst [weight]`` per line) → ``.lux``.

    Python equivalent of the reference converter CLI
    (tools/converter.cc:72-130) and a copy of ``lux_tpu``'s numpy
    converter: the same file, byte for byte.
    """
    ncols = 3 if weighted else 2
    data = np.loadtxt(input_path, dtype=np.int64, max_rows=ne, ndmin=2)
    if data.shape[0] != ne:
        raise ValueError(f"expected {ne} edges, got {data.shape[0]}")
    if data.shape[1] < ncols:
        raise ValueError(
            f"expected {ncols} columns (weighted={weighted}), "
            f"got {data.shape[1]}"
        )
    src, dst = data[:, 0], data[:, 1]
    for name, ids in (("src", src), ("dst", dst)):
        if len(ids) and (ids.min() < 0 or ids.max() >= nv):
            raise ValueError(
                f"{name} ids out of range [0, {nv}): "
                f"[{ids.min()}, {ids.max()}]"
            )
    w = data[:, 2].astype(np.int32) if weighted else None
    g = Graph.from_edges(src, dst, nv=nv, weights=w)
    write_lux(output_path, g, include_degrees=include_degrees)
    return g
