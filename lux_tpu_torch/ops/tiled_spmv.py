"""Hybrid SpMV: int8 strip tiles plus a lane-select tail, on the GPU.

The counterpart of ``lux_tpu/ops/tiled_spmv.py``. The pull engine's hot
loop is ``acc[dst] = Σ vals[src]`` over a static graph (the reference's
``pr_kernel`` gather, pagerank/pagerank_gpu.cu:49-102). The host plan is
the JAX package's, copied so both packages build byte-identical plans:

1. **Strip levels** (:class:`StripLevel`): after a degree-sort relabel,
   dense (r, 128) blocks of the adjacency matrix are stored as int8
   count strips (cells above the cap spill to the tail), sorted by
   destination strip-row.
2. **Tail**: every other edge, CSC-sorted, addressed as
   ``(src >> 7, src & 127)`` into the (nvb, 128) value operand.

The device half is rewritten for Hopper. The card holds no strips: at
R-MAT 22 they average 5.6 nonzero cells (5.9 edges) per 1,024-byte
strip, so a dense strip layout moves 174 bytes per edge. :meth:`DeviceHybrid.build` turns
each level into a destination-major **cell stream** instead: per
destination row ``row * r + i``, its nonzero cells as the source vertex
``cols[t] * 128 + lane`` (int32) and the count (int8), in strip then
lane order, under a CSR row pointer. The tail becomes one int32 stream
of flat source indices, ``(tail_sb << 7) | tail_lane``. The strip kernel
K1 (``csrc/strip_spmv.cu``) is a count-weighted segmented gather-sum
over the cell stream, and the tail kernel K2 (``csrc/segment_sum.cu``) a
CSR segmented gather-sum over the tail stream that adds into K1's
output. Every source index is below nv, so on one device both gather
straight from the ``(nv,)`` values, with no padded ``(nvb, 128)``
operand. Neither needs the JAX package's Z-stream cumsums, boundary
tables or double-single prefixes, which exist to avoid scatters on the
TPU. Each kernel's wrapper runs its plain PyTorch version for CPU
tensors only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.ops.segment import SegmentItems, prefix_diff_sum
from lux_tpu_torch.utils import flags

BLOCK = 128
# Cells per K1 work item: a hub row (tens of thousands of cells at R-MAT 22
# after the degree relabel) spreads over many items. CELL_GROUP threads share an
# item (kGroup in csrc/strip_spmv.cu, which reads 4 cells per 16-byte
# load).
CELL_ITEM = 1024
CELL_GROUP = 4
# Strips uploaded per step of the cell build (256 MB of int8 at r=8);
# a step is extended to the end of its last strip-row.
_BUILD_CHUNK = 1 << 18


# ---------------------------------------------------------------------------
# Host-side planning (a copy of the JAX package's planner)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class StripLevel:
    """Dense (r, 128) int8 count strips at one granularity."""

    r: int
    strips: np.ndarray       # (T, r, 128) int8
    rows: np.ndarray         # (T,) int32 dst strip index (sorted ascending)
    cols: np.ndarray         # (T,) int32 src 128-block index
    # Cached Σ strips so plan validation against graph.ne does not force
    # a full read of a (possibly mmap'd multi-GB) strip array.
    _edges: int = -1

    @property
    def nbytes(self) -> int:
        return self.strips.nbytes

    @property
    def edges(self) -> int:
        if self._edges < 0:
            self._edges = int(self.strips.sum(dtype=np.int64))
        return self._edges


@dataclasses.dataclass(eq=False)
class HybridPlan:
    """Host-side product of :func:`plan_hybrid` (numpy, internal ids).

    "Internal" vertex ids are positions in the degree-sorted order:
    ``order[p]`` is the external id at internal position p and
    ``rank[v]`` the internal position of external vertex v.
    """

    nv: int
    nvb: int                 # number of 128-blocks (nv padded)
    order: np.ndarray        # (nv,) int32
    rank: np.ndarray         # (nv,) int32
    levels: Tuple[StripLevel, ...]
    tail_sb: np.ndarray      # (M,) int32 src >> 7, CSC (dst-sorted) order
    tail_lane: np.ndarray    # (M,) int8  src & 127
    tail_row_ptr: np.ndarray  # (nv+1,) int64
    out_degrees: np.ndarray  # (nv,) int64, internal order
    in_degrees: np.ndarray   # (nv,) int64, internal order
    # Per-cell count cap used at plan time (excess spilled to the tail).
    # cap <= 15 makes every even-r level nibble-packable on the TPU (two
    # strip rows per int8 byte); the card here holds cell streams, so
    # nothing is packed (ROADMAP.md A17). Legacy plans used 127.
    cap: int = 15
    # Planning config, kept so plan caches can detect a changed request
    # (same r-cascade, different thresholds/budget). None/-1 on legacy
    # caches that predate these fields — treated as "unknown, servable".
    levels_spec: Optional[Tuple[Tuple[int, int], ...]] = None
    budget_bytes: int = -1

    @property
    def num_strips(self) -> int:
        return sum(lev.rows.shape[0] for lev in self.levels)

    @property
    def strip_bytes(self) -> int:
        return sum(lev.nbytes for lev in self.levels)

    @property
    def total_edges(self) -> int:
        return self.tail_sb.shape[0] + sum(lev.edges for lev in self.levels)

    @property
    def coverage(self) -> float:
        return 1.0 - self.tail_sb.shape[0] / max(self.total_edges, 1)


def _relabel(graph: Graph, reorder: str):
    nv = graph.nv
    if reorder == "degree":
        deg = graph.in_degrees + graph.out_degrees
        order = np.argsort(-deg, kind="stable").astype(np.int32)
    elif reorder == "natural":
        order = np.arange(nv, dtype=np.int32)
    else:
        raise ValueError(f"unknown reorder {reorder!r}")
    rank = np.empty(nv, np.int32)
    rank[order] = np.arange(nv, dtype=np.int32)
    return order, rank


# Edge-stream chunk for the banded planner passes (edges per chunk);
# per-chunk temporaries are a few int64/int32 arrays of this length.
_PLAN_CHUNK = 1 << 27
# The banded (streamed) counting path turns on above this edge count;
# below it the direct in-memory path is faster and simpler. Both are
# exact and produce identical plans (tested), so the threshold is a
# pure memory/speed trade.
_PLAN_BANDED_MIN_NE = 1 << 28


def _strip_counts_banded(graph: Graph, rank, r: int, nvb: int,
                         min_count: int, chunk: int = _PLAN_CHUNK):
    """(uniq strip ids, counts) for level 0, streamed in edge chunks.

    Exactly the multiset ``np.unique((d//r)*nvb + (s>>7), counts)``
    restricted to counts >= min_count, but without materializing any
    global int64 per-edge array (the direct form peaks at several
    8-byte edge arrays, too much host memory at R-MAT scale 27).
    Strategy: bucket each edge's src-block into
    band-grouped storage (one int32 edge array; the degree relabel
    destroys the CSC dst order, so grouping needs an explicit
    out-of-core pass), then run-length count per band range.

    Dropping counts < min_count here is selection-equivalent to the
    direct path's select-then-filter: strips below min_count can never
    be chosen, and stable tie order among survivors is preserved.

    Bound caveat: the counting batches take whole bands, so a single
    band holding more than ``chunk`` edges is processed in one piece
    (temporaries ~3x its size in int64). After the degree relabel the
    hottest dst rows share band 0, whose edges stay well under the
    2^27 default chunk at R-MAT scale 27, so this stays a documented
    caveat, not a practical limit.
    """
    nv, ne = graph.nv, graph.ne
    nbands = (nv + r - 1) // r
    cs, cd = graph.col_src, graph.col_dst

    band_counts = np.zeros(nbands, np.int64)
    for lo in range(0, ne, chunk):
        b = rank[cd[lo:lo + chunk]] // r
        band_counts += np.bincount(b, minlength=nbands)
    band_off = np.zeros(nbands + 1, np.int64)
    np.cumsum(band_counts, out=band_off[1:])

    sblk_by_band = np.empty(ne, np.int32)
    fill = band_off[:-1].copy()
    for lo in range(0, ne, chunk):
        b = rank[cd[lo:lo + chunk]] // r
        sb = (rank[cs[lo:lo + chunk]] >> 7).astype(np.int32)
        idx = np.argsort(b, kind="stable")
        bs = b[idx]
        run_start = np.concatenate(
            [[0], np.flatnonzero(np.diff(bs)) + 1]
        ).astype(np.int64)
        run_len = np.diff(np.append(run_start, len(bs)))
        within = np.arange(len(bs), dtype=np.int64) - np.repeat(
            run_start, run_len
        )
        sblk_by_band[fill[bs] + within] = sb[idx]
        fill[bs[run_start]] += run_len

    uniq_parts, count_parts = [], []
    b_lo = 0
    while b_lo < nbands:
        b_hi = int(
            np.searchsorted(band_off, band_off[b_lo] + chunk, side="right")
        ) - 1
        b_hi = min(max(b_hi, b_lo + 1), nbands)
        e0, e1 = int(band_off[b_lo]), int(band_off[b_hi])
        if e1 > e0:
            band_of_edge = np.repeat(
                np.arange(b_lo, b_hi, dtype=np.int64),
                band_counts[b_lo:b_hi],
            )
            key = band_of_edge * nvb + sblk_by_band[e0:e1]
            uk, kc = np.unique(key, return_counts=True)
            if min_count > 1:
                keep = kc >= min_count
                uk, kc = uk[keep], kc[keep]
            uniq_parts.append(uk)
            count_parts.append(kc.astype(np.int64))
        b_lo = b_hi
    if not uniq_parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(uniq_parts), np.concatenate(count_parts)


def _cover_chunk(s, d, chosen, r: int, nvb: int, strip_bytes: int):
    """(covered cell keys, tail s, tail d) for one batch of edge ids.

    The single source of truth for the slot/covered/cell coverage
    computation — the direct plan path calls it once over all edges,
    the banded path once per chunk.
    """
    sid = (d // r).astype(np.int64) * nvb + (s >> 7)
    slot = np.searchsorted(chosen, sid)
    covered = slot < len(chosen)
    if len(chosen):
        covered &= np.equal(chosen[np.minimum(slot, len(chosen) - 1)], sid)
    cell = (d % r) * BLOCK + (s & 127)
    key = slot[covered] * strip_bytes + cell[covered]
    return key, s[~covered].astype(np.int32), d[~covered].astype(np.int32)


def _cover_banded(graph: Graph, rank, chosen, r: int, nvb: int,
                  strip_bytes: int, chunk: int = _PLAN_CHUNK):
    """Streamed coverage pass over the whole graph, per edge chunk, so
    only covered keys and the tail int32 ids persist."""
    ne = graph.ne
    cs, cd = graph.col_src, graph.col_dst
    keys, tail_s, tail_d = [], [], []
    for lo in range(0, ne, chunk):
        k, ts, td = _cover_chunk(
            rank[cs[lo:lo + chunk]], rank[cd[lo:lo + chunk]],
            chosen, r, nvb, strip_bytes,
        )
        keys.append(k)
        tail_s.append(ts)
        tail_d.append(td)
    return (
        np.concatenate(keys) if keys else np.zeros(0, np.int64),
        np.concatenate(tail_s) if tail_s else np.zeros(0, np.int32),
        np.concatenate(tail_d) if tail_d else np.zeros(0, np.int32),
    )


def plan_hybrid(
    graph: Graph,
    levels: Sequence[Tuple[int, int]] = ((8, 2),),
    budget_bytes: int = 8 << 30,
    reorder: str = "degree",
    cap: int = 15,
) -> HybridPlan:
    """Partition edges into strip levels + a lane-select tail. Exact.

    ``levels`` is a sequence of ``(r, min_count)`` pairs, consumed in
    order: each level takes the strips (at granularity r x 128) holding
    at least ``min_count`` still-unassigned edges, densest first, within
    what remains of ``budget_bytes`` (booked as unpacked int8 bytes).
    Cells holding more than ``cap`` parallel edges spill the excess to
    the tail; cap <= 15 keeps every even-r level nibble-packable at
    device-build time (opt-in, see DeviceHybrid.build).
    """
    nv = graph.nv
    nvb = (nv + BLOCK - 1) // BLOCK
    order, rank = _relabel(graph, reorder)

    # int32 vertex ids (nv < 2^31 per the format) keep the host arrays
    # half the size of int64; strip ids are computed in int64 where the
    # product can overflow. Above _PLAN_BANDED_MIN_NE
    # edges, level 0 streams the graph through the banded passes instead
    # of materializing s/d/strip_id at all (LUX_PLAN_BANDED=0/1
    # overrides); later levels run on the (much reduced or at least
    # already-paid-for) tail arrays.
    knob = flags.tristate("LUX_PLAN_BANDED")
    banded0 = knob is True or (
        knob is None and graph.ne >= _PLAN_BANDED_MIN_NE
    )
    s = d = None
    if not banded0:
        s = rank[graph.col_src]
        d = rank[graph.col_dst]
    built = []
    remaining = budget_bytes

    for r, min_count in levels:
        if BLOCK % r:
            raise ValueError(f"strip height {r} must divide {BLOCK}")
        if s is None and (graph.ne == 0 or remaining <= 0):
            s = rank[graph.col_src]
            d = rank[graph.col_dst]
        if s is not None and (s.size == 0 or remaining <= 0):
            built.append(StripLevel(
                r=r,
                strips=np.zeros((0, r, BLOCK), np.int8),
                rows=np.zeros(0, np.int32),
                cols=np.zeros(0, np.int32),
            ))
            continue
        # Budget books UNPACKED int8 bytes — nibble packing is an opt-in
        # device-build decision the planner cannot assume; packed builds
        # simply use less device memory than budgeted.
        strip_bytes = r * BLOCK
        if s is None:
            # Banded level 0: counts arrive prefiltered to >= min_count
            # (selection-equivalent to take-then-filter below, since
            # sub-min_count strips are never chosen and stable tie order
            # among survivors is preserved).
            uniq_ids, counts = _strip_counts_banded(
                graph, rank, r, nvb, min_count
            )
            take = np.argsort(-counts, kind="stable")[
                : max(remaining // strip_bytes, 0)
            ]
            chosen = np.sort(uniq_ids[take])
            key, tail_s, tail_d = _cover_banded(
                graph, rank, chosen, r, nvb, strip_bytes
            )
        else:
            strip_id = (d // r).astype(np.int64) * nvb + (s >> 7)
            uniq_ids, counts = np.unique(strip_id, return_counts=True)
            take = np.argsort(-counts, kind="stable")[
                : max(remaining // strip_bytes, 0)
            ]
            take = take[counts[take] >= min_count]
            chosen = np.sort(uniq_ids[take])
            del strip_id
            key, tail_s, tail_d = _cover_chunk(
                s, d, chosen, r, nvb, strip_bytes
            )
        uk, kc = np.unique(key, return_counts=True)
        strips = np.zeros((len(chosen), strip_bytes), np.int8)
        if len(uk):
            strips.ravel()[uk] = np.minimum(kc, cap).astype(np.int8)

        # Count overflow (> cap parallel edges in one cell): keep the excess.
        spill_s = spill_d = np.empty(0, np.int32)
        over = kc > cap
        if over.any():
            reps = (kc[over] - cap).astype(np.int64)
            ok = uk[over]
            sid = chosen[ok // strip_bytes]
            c = ok % strip_bytes
            spill_d = np.repeat(
                (sid // nvb) * r + c // BLOCK, reps
            ).astype(np.int32)
            spill_s = np.repeat(
                (sid % nvb) * BLOCK + (c & 127), reps
            ).astype(np.int32)

        built.append(StripLevel(
            r=r,
            strips=strips.reshape(-1, r, BLOCK),
            rows=(chosen // nvb).astype(np.int32),
            cols=(chosen % nvb).astype(np.int32),
        ))
        remaining -= len(chosen) * strip_bytes
        s = np.concatenate([tail_s, spill_s])
        d = np.concatenate([tail_d, spill_d])

    if s is None:  # banded mode with an empty `levels` sequence
        s = rank[graph.col_src]
        d = rank[graph.col_dst]

    # Tail CSC sort by (d, s): both ids packed into one int64 key and
    # radix-sorted (np.sort stable on ints), much faster than
    # np.lexsort. nv < 2^31 so both ids fit 31 bits.
    vbits = max(int(nv - 1).bit_length(), 1)
    packed = (d.astype(np.int64) << vbits) | s.astype(np.int64)
    packed = np.sort(packed, kind="stable")
    d = (packed >> vbits).astype(np.int32)
    s = (packed & ((1 << vbits) - 1)).astype(np.int32)
    del packed
    tail_row_ptr = np.zeros(nv + 1, np.int64)
    np.cumsum(np.bincount(d, minlength=nv), out=tail_row_ptr[1:])

    return HybridPlan(
        nv=nv,
        nvb=nvb,
        order=order,
        rank=rank,
        levels=tuple(built),
        tail_sb=(s >> 7).astype(np.int32),
        tail_lane=(s & 127).astype(np.int8),
        tail_row_ptr=tail_row_ptr,
        out_degrees=graph.out_degrees[order],
        in_degrees=graph.in_degrees[order],
        cap=cap,
        levels_spec=tuple((int(r), int(t)) for r, t in levels),
        budget_bytes=int(budget_bytes),
    )


_PLAN_ARRAY_FIELDS = (
    "order", "rank", "tail_sb", "tail_lane", "tail_row_ptr",
    "out_degrees", "in_degrees",
)


def save_plan(path: str, plan: HybridPlan) -> None:
    """Persist a plan as a directory of raw ``.npy`` files + ``meta.json``.

    Raw .npy (one array per file) loads via ``np.load(mmap_mode="r")`` —
    effectively instant, paged in at disk bandwidth on first touch.
    ``load_plan`` also reads the legacy single-``.npz`` format. Writes go to a temp
    directory renamed into place so a crashed save never leaves a
    half-written cache that a later run would trust.
    """
    import json
    import os
    import tempfile

    tmp = tempfile.mkdtemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".",
        prefix=os.path.basename(path) + ".tmp.",
    )
    meta = dict(
        nv=plan.nv, nvb=plan.nvb,
        levels=[lev.r for lev in plan.levels],
        level_edges=[lev.edges for lev in plan.levels],
        cap=plan.cap,
        levels_spec=(
            None if plan.levels_spec is None
            else [list(rt) for rt in plan.levels_spec]
        ),
        budget_bytes=plan.budget_bytes,
    )
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    for name in _PLAN_ARRAY_FIELDS:
        np.save(os.path.join(tmp, name + ".npy"), getattr(plan, name))
    for i, lev in enumerate(plan.levels):
        np.save(os.path.join(tmp, f"lev{i}_strips.npy"), lev.strips)
        np.save(os.path.join(tmp, f"lev{i}_rows.npy"), lev.rows)
        np.save(os.path.join(tmp, f"lev{i}_cols.npy"), lev.cols)
    if os.path.isdir(path):
        import shutil

        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)
    os.replace(tmp, path)


def load_plan(path: str, mmap: bool = True) -> HybridPlan:
    """Load a plan saved by :func:`save_plan` (directory format), or a
    legacy round-1 ``.npz`` file. With ``mmap`` (default) arrays are
    memory-mapped read-only — the caller pays disk I/O only for the
    bytes it actually touches, when it touches them."""
    import json
    import os

    if os.path.isdir(path):
        mode = "r" if mmap else None
        ld = lambda name: np.load(
            os.path.join(path, name + ".npy"), mmap_mode=mode
        )
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        lev_edges = meta.get("level_edges", [-1] * len(meta["levels"]))
        levels = tuple(
            StripLevel(
                r=int(r),
                strips=ld(f"lev{i}_strips"),
                rows=ld(f"lev{i}_rows"),
                cols=ld(f"lev{i}_cols"),
                _edges=int(lev_edges[i]),
            )
            for i, r in enumerate(meta["levels"])
        )
        spec = meta.get("levels_spec")
        return HybridPlan(
            nv=int(meta["nv"]), nvb=int(meta["nvb"]),
            levels=levels,
            cap=int(meta.get("cap", 127)),
            levels_spec=(
                None if spec is None
                else tuple((int(r), int(t)) for r, t in spec)
            ),
            budget_bytes=int(meta.get("budget_bytes", -1)),
            **{name: ld(name) for name in _PLAN_ARRAY_FIELDS},
        )

    with np.load(path) as z:
        levels = tuple(
            StripLevel(
                r=int(z[f"lev{i}_r"]),
                strips=z[f"lev{i}_strips"],
                rows=z[f"lev{i}_rows"],
                cols=z[f"lev{i}_cols"],
            )
            for i in range(int(z["nlevels"]))
        )
        return HybridPlan(
            nv=int(z["nv"]), nvb=int(z["nvb"]),
            order=z["order"], rank=z["rank"],
            levels=levels, tail_sb=z["tail_sb"], tail_lane=z["tail_lane"],
            tail_row_ptr=z["tail_row_ptr"],
            out_degrees=z["out_degrees"], in_degrees=z["in_degrees"],
            cap=127,   # legacy .npz plans predate the nibble cap
        )


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------


def resolve_pack(pack, plan_cap: int):
    """One shared gate for the nibble-packing decision: explicit ``pack``
    wins, else the LUX_PACK_STRIPS env opt-in; packing also requires the
    plan's count cap to fit a nibble. An explicit ``pack=True`` that the
    plan cannot satisfy raises — only the env opt-in degrades silently."""
    if pack is None:
        pack = flags.get_bool("LUX_PACK_STRIPS")
    elif pack and plan_cap > 15:
        raise ValueError(
            f"pack=True needs a plan with count cap <= 15 (got cap="
            f"{plan_cap}, a legacy/unpacked plan) — replan with cap<=15"
        )
    return bool(pack) and plan_cap <= 15


def refuse_pack(pack, plan_cap: int) -> None:
    """Raise if nibble packing is asked for: the card holds cell streams,
    not strips, so there is nothing to pack (ROADMAP.md A17)."""
    if resolve_pack(pack, plan_cap):
        raise NotImplementedError(
            "nibble-packed strips (pack=True / LUX_PACK_STRIPS=1) have no "
            "meaning here: the card holds cell streams, not strips "
            "(ROADMAP.md A17)")


@dataclasses.dataclass(eq=False)
class DeviceLevel:
    """One strip level on the device, as a destination-major cell stream.

    The stream covers the destination rows ``[row0, row0 + nrows)`` of
    the level's ``height`` rows (``nvb * 128``). Row ``row0 + k``'s cells
    are ``[row_ptr[k], row_ptr[k+1])``: the flat ``x2d`` index ``src``
    of each cell's source vertex and its count ``cnt``. Both streams are
    padded with zero cells to a multiple of 4, which K1 reads 4 at a
    time. ``items`` cuts the rows into K1 work items of at most
    :data:`CELL_ITEM` cells. ``src_end`` bounds the sources: every
    ``src`` of a cell is below it (0 without cells)."""

    r: int
    src: torch.Tensor        # (C4,) int32 cols[t] * 128 + lane
    cnt: torch.Tensor        # (C4,) int8 count (at most the plan's cap)
    row_ptr: torch.Tensor    # (nrows+1,) int64 cell offsets
    items: SegmentItems
    row0: int
    height: int
    n_cells: int
    src_end: int = 0

    @property
    def nrows(self) -> int:
        return self.row_ptr.shape[0] - 1


def _strip_row_end(rows, t: int, hi: int) -> int:
    """The first strip index past ``t`` that starts a new strip-row (or
    ``hi``), so a build step never splits a strip-row."""
    if t >= hi:
        return hi
    return min(int(np.searchsorted(rows, rows[t - 1], side="right")), hi)


def build_level(lev: StripLevel, nvb: int, device, lo: int = 0,
                hi: Optional[int] = None, band: bool = False) -> DeviceLevel:
    """The cell stream of strips ``[lo, hi)`` of ``lev`` on ``device``.

    Built on ``device`` a step of about :data:`_BUILD_CHUNK` strips at a
    time (whole strip-rows): upload the host strips, take their nonzero
    cells, order them by destination row (a stable sort keeps strip then
    lane order inside a row). ``band`` cuts the row pointer to the rows
    the strips reach (a part of the sharded engine); otherwise it covers
    all ``nvb * 128`` rows."""
    r = lev.r
    n = lev.rows.shape[0]
    hi = n if hi is None else hi
    height = nvb * BLOCK
    rows = lev.rows
    if not band:
        row0, nrows = 0, height
    elif hi > lo:
        row0 = int(rows[lo]) * r
        nrows = (int(rows[hi - 1]) + 1) * r - row0
    else:
        row0, nrows = 0, 0
    counts = torch.zeros(nrows, dtype=torch.int64, device=device)
    srcs, cnts = [], []
    t = lo
    while t < hi:
        e = _strip_row_end(rows, min(t + _BUILD_CHUNK, hi), hi)
        s = torch.from_numpy(np.ascontiguousarray(lev.strips[t:e])).to(device)
        flat = s.view(-1)
        idx = flat.nonzero().squeeze(1)
        strip = idx // (r * BLOCK)
        row_of = torch.from_numpy(
            np.asarray(rows[t:e], np.int64)).to(device)[strip]
        key = row_of * r + (idx // BLOCK) % r - row0
        key, perm = torch.sort(key, stable=True)
        idx, strip = idx[perm], strip[perm]
        col_of = torch.from_numpy(
            np.asarray(lev.cols[t:e], np.int64)).to(device)[strip]
        srcs.append((col_of * BLOCK + idx % BLOCK).to(torch.int32))
        cnts.append(flat[idx])
        counts += torch.bincount(key, minlength=nrows)
        del s, flat, idx, strip, row_of, key, perm, col_of
        t = e
    n_cells = int(sum(c.shape[0] for c in srcs))
    pad = -n_cells % 4
    src = torch.cat(srcs + [torch.zeros(pad, dtype=torch.int32,
                                        device=device)])
    cnt = torch.cat(cnts + [torch.zeros(pad, dtype=torch.int8,
                                        device=device)])
    row_ptr = torch.zeros(nrows + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return DeviceLevel(
        r=r, src=src, cnt=cnt, row_ptr=row_ptr,
        items=SegmentItems.build(row_ptr.cpu().numpy(), CELL_ITEM, device),
        row0=row0, height=height, n_cells=n_cells,
        src_end=int(src[:n_cells].max()) + 1 if n_cells else 0,
    )


def tail_stream(tail_sb: np.ndarray, tail_lane: np.ndarray, device
                ) -> torch.Tensor:
    """The tail as K2 reads it: ``(tail_sb << 7) | tail_lane`` per edge,
    int32, padded with zeros to a multiple of 4 entries (never summed)."""
    m = tail_sb.shape[0]
    src = np.zeros(m + (-m % 4), np.int32)
    src[:m] = (np.asarray(tail_sb, np.int32) << 7) \
        | np.asarray(tail_lane, np.int32)
    return torch.from_numpy(src).to(device)


@dataclasses.dataclass(eq=False)
class DeviceHybrid:
    """A plan on the device: the strip levels as cell streams and the
    tail as one stream of flat source indices (:func:`tail_stream`) in
    CSC order under ``tail_row_ptr``. Every source index of the levels
    and the tail is below ``src_end``."""

    levels: Tuple[DeviceLevel, ...]
    tail_src: torch.Tensor       # (M4,) int32 (sb << 7) | lane, CSC order
    tail_row_ptr: torch.Tensor   # (rows+1,) int64
    nvb: int
    src_end: int

    @staticmethod
    def build(plan: HybridPlan, device, pack=None) -> "DeviceHybrid":
        """Upload ``plan`` to ``device``: each strip level as its cell
        stream (:func:`build_level`), the tail as its source stream.
        ``pack`` (or the LUX_PACK_STRIPS opt-in) is refused
        (:func:`refuse_pack`). Raises if a source index is not below
        ``plan.nv``: the kernels gather straight from the (nv,)
        values."""
        refuse_pack(pack, plan.cap)
        levels = tuple(build_level(lev, plan.nvb, device)
                       for lev in plan.levels)
        m = plan.tail_sb.shape[0]
        tail_end = int(((plan.tail_sb.astype(np.int64) << 7)
                        | plan.tail_lane).max()) + 1 if m else 0
        src_end = max([tail_end] + [lev.src_end for lev in levels])
        if src_end > plan.nv:
            raise ValueError(f"plan reads source {src_end - 1} of "
                             f"{plan.nv} vertices")
        return DeviceHybrid(
            levels=levels,
            tail_src=tail_stream(plan.tail_sb, plan.tail_lane, device),
            tail_row_ptr=torch.from_numpy(np.asarray(
                plan.tail_row_ptr, np.int64)).to(device),
            nvb=plan.nvb,
            src_end=src_end,
        )


# -- K1: strip levels --------------------------------------------------------


def strip_level_spmv_plain(x: torch.Tensor, lev: DeviceLevel,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K1's plain version: each cell's count times its source value,
    then per-row sums by f64 prefix differences, placed at the level's
    rows of a zero ``(height,)`` vector or added into ``out``."""
    n = lev.n_cells
    contrib = lev.cnt[:n].to(torch.float32) \
        * x.reshape(-1)[lev.src[:n].long()]
    sums = prefix_diff_sum(contrib, lev.row_ptr)
    rows = slice(lev.row0, lev.row0 + lev.nrows)
    if out is None:
        out = torch.zeros(lev.height, dtype=torch.float32, device=x.device)
        out[rows] = sums
    else:
        out[rows] += sums
    return out


def strip_level_spmv(x: torch.Tensor, lev: DeviceLevel,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ count · x over each destination row's cells; (height,) f32.

    ``x`` holds the source values, indexed flat: the (nv,) values or the
    (nvb, 128) operand. Rows outside the level's ``[row0, row0 +
    nrows)`` are 0; with ``out`` (a (height,) f32 vector) the level's
    sums are added into it instead, and ``out`` is returned. CPU tensors
    take the plain version; CUDA tensors launch K1
    (``csrc/strip_spmv.cu``).
    """
    if x.device.type == "cpu":
        return strip_level_spmv_plain(x, lev, out)
    dev = x.device
    _cuda.check(x, "x", torch.float32, dev)
    if x.numel() < lev.src_end:
        raise ValueError(f"x has {x.numel()} values; the level reads "
                         f"sources up to {lev.src_end - 1}")
    _cuda.check(lev.src, "src", torch.int32, dev, ndim=1)
    _cuda.check(lev.cnt, "cnt", torch.int8, dev, ndim=1)
    if lev.src.shape != lev.cnt.shape or lev.src.shape[0] % 4 \
            or lev.src.data_ptr() % 16 or lev.cnt.data_ptr() % 4:
        raise ValueError("src and cnt must be aligned streams of one "
                         "length, a multiple of 4")
    _cuda.check(lev.items.item_lo, "item_lo", torch.int64, dev, ndim=1)
    _cuda.check(lev.items.row_items, "row_items", torch.int64, dev, ndim=1)
    if lev.items.nrows != lev.nrows:
        raise ValueError(f"items cover {lev.items.nrows} rows, the level "
                         f"{lev.nrows}")
    if out is not None:
        _cuda.check(out, "out", torch.float32, dev, ndim=1)
        if out.shape[0] != lev.height:
            raise ValueError(f"out must be ({lev.height},), got "
                             f"{tuple(out.shape)}")
    full = lev.row0 == 0 and lev.nrows == lev.height
    if out is None:
        out = (torch.empty if full and lev.items.n_items else torch.zeros)(
            lev.height, dtype=torch.float32, device=dev)
        accumulate = 0
    else:
        accumulate = 1
    if lev.items.n_items == 0:
        return out
    partial = torch.empty(lev.items.n_items, dtype=torch.float32, device=dev)
    _cuda.launch(
        "strip_spmv", "lux_strip_spmv",
        _cuda.ptr(lev.src), _cuda.ptr(lev.cnt), _cuda.ptr(x),
        _cuda.ptr(lev.items.item_lo), lev.items.n_items,
        _cuda.ptr(lev.items.row_items), lev.nrows, lev.row0, accumulate,
        _cuda.ptr(partial), _cuda.ptr(out), _cuda.stream(dev),
    )
    return out


# -- K2: the lane-select tail ------------------------------------------------


def lane_select_tail_sums_plain(
    x: torch.Tensor,
    tail_src: torch.Tensor,
    tail_row_ptr: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2's plain version: gather each tail edge's source value, then
    per-destination sums by f64 prefix differences; added into ``out``
    when it is given."""
    sums = prefix_diff_sum(x.reshape(-1)[tail_src.long()], tail_row_ptr)
    return sums if out is None else out.add_(sums)


def lane_select_tail_sums(
    x: torch.Tensor,
    tail_src: torch.Tensor,
    tail_row_ptr: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-destination sums of tail-edge source values; (rows,) f32.

    ``y[v] = Σ x.flat[tail_src[e]]`` over ``e ∈ [tail_row_ptr[v],
    tail_row_ptr[v+1])``, where ``tail_src`` is the stream of
    :func:`tail_stream` (``(tail_sb << 7) | tail_lane``, padded to a
    multiple of 4) and every index lies inside ``x``. With ``out`` (a
    (rows,) f32 vector) the sums are added into it and ``out`` is
    returned. CPU tensors take the plain version; CUDA tensors launch K2
    (``csrc/segment_sum.cu``), one launch straight over the row pointer.
    """
    if x.device.type == "cpu":
        return lane_select_tail_sums_plain(x, tail_src, tail_row_ptr, out)
    dev = x.device
    _cuda.check(x, "x", torch.float32, dev)
    _cuda.check(tail_src, "tail_src", torch.int32, dev, ndim=1)
    _cuda.check(tail_row_ptr, "tail_row_ptr", torch.int64, dev, ndim=1)
    if tail_src.shape[0] % 4 or tail_src.data_ptr() % 16:
        raise ValueError("tail_src must be a 16-byte aligned stream of a "
                         "multiple of 4 entries")
    nrows = tail_row_ptr.shape[0] - 1
    if out is None:
        out = torch.empty(nrows, dtype=torch.float32, device=dev)
        accumulate = 0
    else:
        _cuda.check(out, "out", torch.float32, dev, ndim=1)
        if out.shape[0] != nrows:
            raise ValueError(f"out must be ({nrows},), got "
                             f"{tuple(out.shape)}")
        accumulate = 1
    if nrows == 0:
        return out
    _cuda.launch(
        "tail_gather_sum", "lux_tail_gather_sum",
        _cuda.ptr(x), _cuda.ptr(tail_src), tail_src.shape[0],
        _cuda.ptr(tail_row_ptr), nrows, accumulate, _cuda.ptr(out),
        _cuda.stream(dev),
    )
    return out


# -- composition -------------------------------------------------------------


def vals_to_x2d(vals: torch.Tensor, dh: DeviceHybrid) -> torch.Tensor:
    """(nv,) values → (nvb, 128) padded gather operand (the grouped
    tail's; K1 and K2 read the values as they are)."""
    pad = dh.nvb * BLOCK - vals.shape[0]
    return F.pad(vals, (0, pad)).reshape(dh.nvb, BLOCK)


def strips_sum(x: torch.Tensor, dh: DeviceHybrid, nv: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ over all strip levels; (nv,) f32 (internal order). ``x`` is
    the (nv,) values or the (nvb, 128) operand. The levels add into
    ``out`` (a (nvb * 128,) f32 vector) when it is given, else into the
    first level's result."""
    acc = out
    for lev in dh.levels:
        acc = strip_level_spmv(x, lev, acc)
    if acc is None:
        return torch.zeros(nv, dtype=torch.float32, device=x.device)
    return acc[:nv]


def tail_sum(x: torch.Tensor, dh: DeviceHybrid,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ over the lane-select tail; (rows,) f32 (internal order), added
    into ``out`` when it is given. ``x`` is the (nv,) values or the
    (nvb, 128) operand."""
    if x.numel() < dh.src_end:
        raise ValueError(f"x has {x.numel()} values; the tail reads "
                         f"sources up to {dh.src_end - 1}")
    return lane_select_tail_sums(x, dh.tail_src, dh.tail_row_ptr, out)


def hybrid_spmv(vals: torch.Tensor, dh: DeviceHybrid,
                gtail=None) -> torch.Tensor:
    """Full Σ vals[src] per destination over all layouts; (nv,) f32 in,
    (nv,) f32 out (internal vertex order). K1 and K2 read ``vals`` as
    they are, and the tail (K2, or the grouped tail's K4) adds its sums
    into the strips'.

    ``gtail`` (a :class:`~lux_tpu_torch.ops.merge_tail_kernel.DeviceGroupedTail`)
    swaps the lane-select tail for the grouped merge-network tail —
    opt-in via LUX_GROUPED_TAIL=1 in the executor; both produce per-dst
    sums of the same tail edge set."""
    nv = vals.shape[0]
    if gtail is not None:
        from lux_tpu_torch.ops.merge_tail_kernel import grouped_tail_sums

        x2d = vals_to_x2d(vals, dh)
        return grouped_tail_sums(x2d, gtail, out=strips_sum(x2d, dh, nv))
    return tail_sum(vals, dh, out=strips_sum(vals, dh, nv))
