"""Production planner for the grouped-tail merge network.

A copy of ``lux_tpu/ops/merge_tail_plan.py`` (numpy only): both packages
must produce the same plan, plane for plane, from the same tail. It is
the vectorized equivalent of the copy-window reference walk in
:mod:`lux_tpu_torch.ops.merge_tail_ref`; the only Python-rate loop is
one array lookup per OUTPUT ROW over a precomputed next-cut jump table.

Pipeline (:func:`plan_grouped_tail`):

1. group tail edges into runs by source block (``tail_sb``) — one
   gathered x2d row then serves up to 128 edges of the run per stream
   row (the whole point of the grouped tail);
2. optional INTERLEAVED splitting of big runs (piece k takes every s-th
   element so every piece spans the full dst range) + size-sorted
   pairing (leaf i of the merge tree is the i-th largest piece, so
   siblings at every level are size-matched);
3. level-0 layout: each leaf dense from an 8-row-aligned base, with
   sub-8-row remainders BIN-PACKED into shared aligned bins — runs
   become two-segment (body + remainder) instead of padding every
   short run to 8 rows;
4. per merge level, the copy-window walk (see
   :func:`merge_tail_ref.schedule_grouped` for the contract): output
   row o reads one full input row per side (``arow[o]``/``brow[o]``)
   and closes on 128 reals or an input-row crossing; single-sided rows
   are COPY rows streaming a drained side at full rate.

The result is a :class:`GroupedTailPlan`: per-level int8 routing
planes + int32 row-offset arrays, flat-concatenated with a
``level_ptr`` so the artifact is a handful of arrays that round-trip
through :func:`save_grouped_plan` / :func:`load_grouped_plan` (same
dir-of-npy + meta.json shape as the tiled plan cache).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

from lux_tpu_torch.ops.merge_tail_ref import BLOCK, _tree_size

# Stream alignment in rows. The JAX package's level kernel indexes whole
# 8-row blocks; the port keeps the same value so plans stay identical.
ALIGN_ROWS = 8
# Interleaved run splitting is OFF by default: under the copy-window
# contract a dominant side streams at full rate, so size skew is nearly
# free and splitting only adds row-granularity overhead. The knob
# remains for distributions where dst-interleaving stalls dominate.
DEFAULT_SPLIT_ROWS = 0    # max leaf piece size in 128-slot rows; 0 = off


@dataclasses.dataclass(eq=False)
class GroupedTailPlan:
    """Host-side grouped-tail plan (numpy, internal vertex ids).

    Levels 0..n_levels are concatenated along the row axis; level k
    spans rows ``level_ptr[k]:level_ptr[k+1]``. Level 0 is the x2d
    gather level (``arow`` = source block id, all-copy); levels >= 1
    read the previous level's output stream.
    """

    n_edges: int
    n_levels: int            # merge levels (tree depth), excl. level 0
    arow: np.ndarray         # (S,) int32 per-row side-A input row
    brow: np.ndarray         # (S,) int32 per-row side-B input row
    codes: np.ndarray        # (S, 128) int8 lane routing plane
    nvalid: np.ndarray       # (S,) int32 reals per row (prefix-dense)
    mode: np.ndarray         # (S,) int8 0=merge 1=copy-A 2=copy-B
    level_ptr: np.ndarray    # (n_levels + 2,) int64 row offsets
    dst_row_ptr: np.ndarray  # (nv + 1,) int64 final-slot dst boundaries
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def level_rows(self) -> np.ndarray:
        return np.diff(self.level_ptr)

    def level(self, k: int) -> Tuple[np.ndarray, ...]:
        s = slice(self.level_ptr[k], self.level_ptr[k + 1])
        return (self.arow[s], self.brow[s], self.codes[s],
                self.nvalid[s], self.mode[s])


# -- skew mitigations --------------------------------------------------

def split_runs_interleaved(run_of, pos_in_run, sizes, max_len: int):
    """Split runs longer than ``max_len`` into interleaved pieces.

    Piece k of a run split s ways takes elements k, k+s, k+2s, ... —
    every piece spans the run's full dst range, which is what makes
    size-sorted pairing effective (dst-RANGE chunks pair into
    disjoint-range siblings that merge sequentially).
    Returns (piece_of, pos_in_piece, piece_sizes); pieces stay
    dst-sorted because they are subsequences.
    """
    sizes = np.asarray(sizes, np.int64)
    nsplit = np.maximum(1, -(-sizes // max(max_len, 1)))   # ceil
    piece_base = np.concatenate([[0], np.cumsum(nsplit)])[:-1]
    s = nsplit[run_of]
    piece_of = piece_base[run_of] + pos_in_run % s
    pos_in_piece = pos_in_run // s
    npieces = int(nsplit.sum())
    piece_sizes = np.zeros(npieces, np.int64)
    np.add.at(piece_sizes, piece_of, 1)
    return piece_of, pos_in_piece, piece_sizes


def pair_runs_sorted(piece_sizes) -> np.ndarray:
    """Tree-leaf assignment: leaf i is the i-th largest piece.

    Descending size order makes siblings size-matched at EVERY level
    (adjacent pairs stay sorted after pairwise summation), which is
    the effective half of the skew mitigation.
    Returns leaf_of_piece (npieces,) int64.
    """
    order = np.argsort(np.asarray(piece_sizes), kind="stable")[::-1]
    leaf_of_piece = np.empty(order.shape[0], np.int64)
    leaf_of_piece[order] = np.arange(order.shape[0])
    return leaf_of_piece


# -- level-0 layout (8-row alignment + remainder bin-packing) ----------

def layout_leaf_streams(leaf_sizes, align_rows: int = ALIGN_ROWS):
    """Slot layout for the leaf streams under the 8-row alignment rule.

    Every leaf's body (whole multiples of ``align_rows`` rows) sits at
    an aligned base; the sub-``align_rows`` remainder row groups are
    first-fit-decreasing bin-packed into shared aligned bins, making
    small leaves two-segment instead of padding each to a full block.
    Returns (body_base, rem_base, body_rows, total_rows): per-leaf row
    bases (rem_base = -1 when there is no remainder).
    """
    leaf_sizes = np.asarray(leaf_sizes, np.int64)
    rows = -(-leaf_sizes // BLOCK)
    if align_rows <= 1:
        base = np.concatenate([[0], np.cumsum(rows)])
        return base[:-1], np.full(rows.shape[0], -1, np.int64), rows, int(
            base[-1])
    rem = rows % align_rows
    body = rows - rem
    body_base = np.concatenate([[0], np.cumsum(body)])[:-1]
    bins_start = int(body.sum())
    # FFD via capacity stacks: O(n) — remainder sizes are 1..align-1,
    # bins have capacity align_rows.
    rem_base = np.full(rows.shape[0], -1, np.int64)
    open_bins = {c: [] for c in range(1, align_rows + 1)}  # free cap -> bases
    next_bin = bins_start
    for leaf in np.argsort(rem, kind="stable")[::-1]:
        r = int(rem[leaf])
        if r == 0:
            continue
        cap = next(
            (c for c in range(r, align_rows + 1) if open_bins[c]), None)
        if cap is None:
            b = next_bin
            next_bin += align_rows
            cap = align_rows
            open_bins[cap].append(b + align_rows)  # store bin END
        end = open_bins[cap].pop()
        rem_base[leaf] = end - cap
        left = cap - r
        if left:
            open_bins[left].append(end)
    return body_base, rem_base, body, next_bin


def _leaf_slots(pos, leaf_of, body_base, rem_base, body_rows):
    """Per-real level-0 (row, lane) from position-in-leaf."""
    body_slots = body_rows[leaf_of] * BLOCK
    in_body = pos < body_slots
    row = np.where(
        in_body,
        body_base[leaf_of] + pos // BLOCK,
        rem_base[leaf_of] + (pos - body_slots) // BLOCK,
    )
    return row.astype(np.int64), (pos % BLOCK).astype(np.int64)


# -- the vectorized copy-window walk (one merge level) -----------------

def _prev_same_group(group) -> np.ndarray:
    """prev[i] = largest j < i with group[j] == group[i], else -1."""
    n = group.shape[0]
    order = np.argsort(group, kind="stable")
    prev = np.full(n, -1, np.int64)
    same = np.empty(n, bool)
    same[:1] = False
    same[1:] = group[order[1:]] == group[order[:-1]]
    prev[order[1:]] = np.where(same[1:], order[:-1], -1)
    return prev


def walk_level(node, side, row, lane, align_rows: int = 1):
    """Schedule one merge level over reals given in merged order.

    Inputs are per-real arrays in GLOBAL merged order (dst-major,
    leaf tiebreak): ``node`` (this level's node id, non-decreasing
    within the processing groups is NOT required — reals are grouped
    by a stable node sort internally), ``side`` (0=A, 1=B), and the
    real's (row, lane) in the level's input stream. Returns
    (planes, out_row, out_lane) with planes = dict of per-out-row
    arrays and out_row/out_lane the real's placement in the output
    stream (global order).

    Walk contract (identical to merge_tail_ref.schedule_grouped): a
    row closes at 128 reals, at a node boundary, or when the merged
    order needs a real whose input row differs from the row its side
    is reading — computed without a per-real loop via a next-cut jump
    table F where F[c] is the first real whose same-side predecessor
    is >= c on a different input row.
    """
    n = node.shape[0]
    if n == 0:
        planes = {
            "arow": np.zeros(0, np.int32), "brow": np.zeros(0, np.int32),
            "codes": np.zeros((0, BLOCK), np.int8),
            "nvalid": np.zeros(0, np.int32), "mode": np.zeros(0, np.int8),
        }
        return planes, np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    order = np.argsort(node, kind="stable")
    nd, sd, rw, ln = node[order], side[order], row[order], lane[order]

    # Node boundaries (forced cuts) and per-real node end.
    starts = np.concatenate([[0], np.flatnonzero(np.diff(nd)) + 1, [n]])
    node_end = np.repeat(starts[1:], np.diff(starts))

    # marker: taking real i in a chunk that already holds its same-side
    # predecessor would cross an input row.
    prev = _prev_same_group(nd * 2 + sd)
    marked = (prev >= 0) & (rw != np.where(prev >= 0, rw[prev], 0))
    # F[c] = min marked i with prev[i] >= c  (suffix-min over prev).
    g = np.full(n + 1, n, np.int64)
    mi = np.flatnonzero(marked)
    if mi.size:
        np.minimum.at(g, prev[mi], mi)
    f = np.minimum.accumulate(g[::-1])[::-1]

    # Cut loop: one lookup per OUTPUT ROW (the only non-vectorized
    # part; ~n/100 iterations).
    cuts = [0]
    c = 0
    while c < n:
        c = min(c + BLOCK, int(f[c]), int(node_end[c]))
        cuts.append(c)
    cuts = np.asarray(cuts, np.int64)
    nchunks = cuts.shape[0] - 1

    rid = np.searchsorted(cuts, np.arange(n), side="right") - 1
    offset = np.arange(n) - cuts[rid]

    # Per-chunk first real of each side -> arow/brow/mode.
    first = np.full((2, nchunks), n, np.int64)
    for s in (0, 1):
        i = np.flatnonzero(sd == s)
        np.minimum.at(first[s], rid[i], i)
    has_a, has_b = first[0] < n, first[1] < n
    ar = np.where(has_a, rw[np.minimum(first[0], n - 1)], 0)
    br = np.where(has_b, rw[np.minimum(first[1], n - 1)], 0)
    arow_c = np.where(has_a, ar, br)
    brow_c = np.where(has_b, br, ar)
    mode_c = np.where(has_a & has_b, 0, np.where(has_a, 1, 2)).astype(np.int8)

    # Output row ids with per-node alignment (pad rows materialized).
    cn = nd[cuts[:-1]]
    cstarts = np.concatenate([[0], np.flatnonzero(np.diff(cn)) + 1, [nchunks]])
    per_node = np.diff(cstarts)
    if align_rows > 1:
        aligned = -(-per_node // align_rows) * align_rows
    else:
        aligned = per_node
    nbase = np.concatenate([[0], np.cumsum(aligned)])
    local = np.arange(nchunks) - np.repeat(cstarts[:-1], per_node)
    grow = np.repeat(nbase[:-1], per_node) + local
    total_rows = int(nbase[-1])

    planes = {
        "arow": np.zeros(total_rows, np.int32),
        "brow": np.zeros(total_rows, np.int32),
        "codes": np.zeros((total_rows, BLOCK), np.int8),
        "nvalid": np.zeros(total_rows, np.int32),
        "mode": np.zeros(total_rows, np.int8),
    }
    planes["arow"][grow] = arow_c.astype(np.int32)
    planes["brow"][grow] = brow_c.astype(np.int32)
    planes["nvalid"][grow] = np.diff(cuts).astype(np.int32)
    planes["mode"][grow] = mode_c
    planes["codes"][grow[rid], offset] = (ln - BLOCK * sd).astype(np.int8)

    out_row = np.empty(n, np.int64)
    out_lane = np.empty(n, np.int64)
    out_row[order] = grow[rid]
    out_lane[order] = offset
    return planes, out_row, out_lane, total_rows


# -- full network ------------------------------------------------------

def plan_merge_network(dst, leaf, row, lane, nleaves: int,
                       align_rows: int = 1):
    """Schedule all merge levels bottom-up from a leaf-stream layout.

    Per-real inputs must be sorted by (dst, leaf) — the global merged
    order. Returns (levels list of plane dicts, final (row, lane),
    per-level row counts). ``nleaves`` fixes the tree width (padded to
    a power of two, floor 2 — same as the reference).
    """
    R = _tree_size(nleaves)
    L = R.bit_length() - 1
    levels, rows_per_level = [], []
    for lev in range(1, L + 1):
        node = leaf >> lev
        side = (leaf >> (lev - 1)) & 1
        planes, row, lane, total = walk_level(
            node, side, row, lane, align_rows=align_rows)
        levels.append(planes)
        rows_per_level.append(total)
    return levels, row, lane, rows_per_level


def plan_grouped_tail(
    tail_sb, tail_lane, tail_row_ptr, *,
    align_rows: int = ALIGN_ROWS,
    split_rows: int = DEFAULT_SPLIT_ROWS,
) -> GroupedTailPlan:
    """Plan the full grouped tail for one hybrid plan's tail edge set.

    Inputs are the tiled plan's tail arrays (CSC / dst-sorted order,
    internal vertex ids): ``tail_sb`` (M,) source block per edge,
    ``tail_lane`` (M,) source lane, ``tail_row_ptr`` (nv+1,) per-dst
    edge offsets.
    """
    tail_sb = np.asarray(tail_sb, np.int64)
    tail_lane = np.asarray(tail_lane, np.int64) & (BLOCK - 1)
    tail_row_ptr = np.asarray(tail_row_ptr, np.int64)
    m = tail_sb.shape[0]
    nv = tail_row_ptr.shape[0] - 1
    dst = np.repeat(np.arange(nv, dtype=np.int64), np.diff(tail_row_ptr))

    # Runs: edges grouped by source block, dst order preserved (the
    # input is dst-sorted; a stable sb sort keeps it within each run).
    order = np.argsort(tail_sb, kind="stable")
    sb_s, lane_s, dst_s = tail_sb[order], tail_lane[order], dst[order]
    uniq, run_of, counts = np.unique(
        sb_s, return_inverse=True, return_counts=True)
    pos_in_run = np.arange(m) - np.concatenate(
        [[0], np.cumsum(counts)])[:-1][run_of]

    if split_rows > 0:
        piece_of, pos, piece_sizes = split_runs_interleaved(
            run_of, pos_in_run, counts, split_rows * BLOCK)
    else:
        piece_of, pos = run_of, pos_in_run
        piece_sizes = counts.astype(np.int64)
    leaf_of_piece = pair_runs_sorted(piece_sizes)
    leaf = leaf_of_piece[piece_of]
    nleaves = piece_sizes.shape[0]
    R = _tree_size(nleaves)
    leaf_sizes = np.zeros(R, np.int64)
    np.add.at(leaf_sizes, leaf, 1)
    leaf_sb = np.zeros(R, np.int64)
    leaf_sb[leaf] = uniq[run_of]

    body_base, rem_base, body_rows, rows0 = layout_leaf_streams(
        leaf_sizes, align_rows)
    row, lane0 = _leaf_slots(pos, leaf, body_base, rem_base, body_rows)

    # Level-0 plane: one x2d row gather per stream row (all copy-A).
    lv0 = {
        "arow": np.zeros(rows0, np.int32),
        "brow": np.zeros(rows0, np.int32),
        "codes": np.zeros((rows0, BLOCK), np.int8),
        "nvalid": np.zeros(rows0, np.int32),
        "mode": np.zeros(rows0, np.int8),
    }
    lv0["arow"][row] = leaf_sb[leaf].astype(np.int32)
    lv0["brow"][row] = lv0["arow"][row]
    lv0["codes"][row, lane0] = lane_s.astype(np.int8)  # lanes 0..127 >= 0
    np.add.at(lv0["nvalid"], row, 1)
    lv0["mode"][lv0["nvalid"] > 0] = 1
    # Positions are dense within each leaf segment, so every level-0
    # row is prefix-dense like the merge levels: nvalid doubles as the
    # live-lane count.

    # Global merged order for the network: (dst, leaf), stable in pos.
    g = np.argsort(leaf + dst_s * R, kind="stable")
    levels, frow, flane, rows_per_level = plan_merge_network(
        dst_s[g], leaf[g], row[g], lane0[g], nleaves,
        align_rows=align_rows)

    # Final-slot dst boundaries (pads between segments are masked to
    # zero on device, so closed ranges are safe to sum).
    final_slot = frow * BLOCK + flane
    rows_root = rows_per_level[-1] if rows_per_level else 0
    if m:
        idx = np.searchsorted(dst_s[g], np.arange(nv + 1))
        dst_row_ptr = np.where(
            idx < m, final_slot[np.minimum(idx, m - 1)],
            rows_root * BLOCK).astype(np.int64)
    else:
        dst_row_ptr = np.zeros(nv + 1, np.int64)

    all_levels = [lv0] + levels
    level_ptr = np.concatenate(
        [[0], np.cumsum([lv["arow"].shape[0] for lv in all_levels])]
    ).astype(np.int64)
    cat = {
        k: (np.concatenate([lv[k] for lv in all_levels])
            if level_ptr[-1] else all_levels[0][k])
        for k in ("arow", "brow", "codes", "nvalid", "mode")
    }
    n_levels = len(levels)

    rows = np.diff(level_ptr).astype(np.float64)
    ideal = max(m, 1) / BLOCK
    per_level_inflation = rows / ideal
    stats = {
        "n_edges": float(m),
        "n_levels": float(n_levels),
        "n_runs": float(uniq.shape[0]),
        "n_leaves": float(nleaves),
        "mean_inflation": float(per_level_inflation.mean())
        if rows.size else 0.0,
        "max_level_inflation": float(per_level_inflation.max())
        if rows.size else 0.0,
        "root_inflation": float(per_level_inflation[-1])
        if rows.size else 0.0,
        "copy_rows": float(np.count_nonzero(cat["mode"] > 0)),
        "merge_rows": float(
            np.count_nonzero((cat["mode"] == 0) & (cat["nvalid"] > 0))),
        "pad_rows": float(np.count_nonzero(cat["nvalid"] == 0)),
        "total_rows": float(level_ptr[-1]),
    }
    return GroupedTailPlan(
        n_edges=m, n_levels=n_levels,
        arow=cat["arow"], brow=cat["brow"], codes=cat["codes"],
        nvalid=cat["nvalid"], mode=cat["mode"],
        level_ptr=level_ptr, dst_row_ptr=dst_row_ptr, stats=stats,
    )


# -- plan cache (same dir-of-npy + meta.json shape as save_plan) -------

_PLAN_ARRAYS = (
    "arow", "brow", "codes", "nvalid", "mode", "level_ptr", "dst_row_ptr",
)
_FORMAT = 1

# Public artifact-format contract (the same in both packages).
PLAN_ARRAYS = _PLAN_ARRAYS
PLAN_FORMAT = _FORMAT


def save_grouped_plan(path: str, plan: GroupedTailPlan) -> None:
    """Write the plan as a directory of raw .npy files + meta.json,
    built in a temp dir and renamed into place (a partially-written
    cache must never be loadable)."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".gtail_plan_", dir=parent)
    try:
        for name in _PLAN_ARRAYS:
            np.save(os.path.join(tmp, name + ".npy"),
                    getattr(plan, name), allow_pickle=False)
        meta = {
            "format": _FORMAT,
            "n_edges": int(plan.n_edges),
            "n_levels": int(plan.n_levels),
            "stats": plan.stats,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        if os.path.isdir(path):
            import shutil
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_grouped_plan(path: str, mmap: bool = True) -> GroupedTailPlan:
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"grouped plan {path}: unknown format {meta.get('format')}")
    arrs = {
        name: np.load(os.path.join(path, name + ".npy"),
                      mmap_mode="r" if mmap else None)
        for name in _PLAN_ARRAYS
    }
    return GroupedTailPlan(
        n_edges=int(meta["n_edges"]), n_levels=int(meta["n_levels"]),
        stats=dict(meta.get("stats", {})), **arrs,
    )
