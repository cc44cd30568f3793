"""Reference (host, unoptimized) scheduler for the merge-network tail.

A copy of ``lux_tpu/ops/merge_tail_ref.py`` (numpy only): a correct,
executable specification of the grouped tail's routing construction.
It is NOT wired into any executor and is not performance code — the
production planner (:mod:`lux_tpu_torch.ops.merge_tail_plan`) vectorizes
the walk, and the device side is the ``level_apply`` kernel
(:mod:`lux_tpu_torch.ops.merge_tail_kernel`).

Model
-----
R runs (R a power of two; empty runs pad the tree), each a dst-sorted
sequence of "reals". Levels ℓ = 1..L (L = log2 R) merge adjacent
subtrees: the side of run r at level ℓ is bit ℓ-1 of r, and the node
(subtree) containing it is r >> ℓ. One device pass per level: output
window w (one 128-lane row) of a node reads EXACTLY input slots
[64w, 64w+64) of each side — so a real's emission window at every
level is forced by its slot at the level below, and all slots derive
from its FINAL position:

    slot_L(x) = f(x)                                (root output slot)
    slot_{ℓ-1}(x) = 64 * (slot_ℓ(x) // 128) + rank of x among reals of
                    its (node, side) within that window   (must be < 64)

The construction is one forward walk over the global dst order,
placing reals at the next final slot whose implied per-(node, side)
window ranks all stay below 64; on overflow the final cursor advances
to the next 128-slot row (the skipped slots are the stall pads).
"""

from __future__ import annotations

import numpy as np

BLOCK = 128
WIN = 64
PAD = -1


def _tree_size(nruns: int) -> int:
    """Power-of-two tree width, minimum 2 so there is always at least
    one merge level (a single run still flows through level 1 paired
    with an empty sibling — L = 0 would schedule phantom levels with
    no nodes)."""
    R = 2
    while R < nruns:
        R *= 2
    return R


def schedule(runs):
    """Assign each real a final-stream position.

    ``runs``: list of dst-sorted 1-D int arrays (may be empty); length
    is padded to a power of two internally. Returns (f, order) where
    ``order`` lists reals as (dst, run, pos) triples in global merged
    dst order (ties by run index) and ``f[i]`` is the final slot of
    ``order[i]``.
    """
    R = _tree_size(len(runs))
    L = R.bit_length() - 1

    # Global merged order: (dst, run, pos)
    items = []
    for r, a in enumerate(runs):
        for p, d in enumerate(np.asarray(a)):
            items.append((int(d), r, p))
    items.sort()
    n = len(items)

    # Per (level, node, side) counters: rank within the current window,
    # plus the window id the counter belongs to.
    q = {}
    win = {}
    f = np.zeros(n, np.int64)
    t = 0                     # next candidate final slot
    for i, (_, r, p) in enumerate(items):
        while True:
            ok = True
            # Derive slots top-down at candidate position t.
            slots = {}
            s = t
            for lev in range(L, 0, -1):
                node = r >> lev
                side = (r >> (lev - 1)) & 1
                w = s // BLOCK
                key = (lev, node, side)
                if win.get(key) != w:
                    rank = 0
                else:
                    rank = q[key]
                if rank >= WIN:
                    ok = False
                    break
                slots[lev] = (key, w, rank)
                s = WIN * w + rank   # slot at level lev-1's output
            if ok:
                break
            t = (t // BLOCK + 1) * BLOCK   # stall: next output row
        # Commit.
        f[i] = t
        for lev, (key, w, rank) in slots.items():
            win[key] = w
            q[key] = rank + 1
        t += 1
    return f, items


def derive_level_slots(runs, f, items):
    """Recompute every real's slot at every level from its final
    position (the mechanical top-down derivation) and return
    per-level dicts {(run, pos): slot}."""
    R = _tree_size(len(runs))
    L = R.bit_length() - 1
    out = {lev: {} for lev in range(0, L + 1)}
    # rank bookkeeping identical to schedule()
    q = {}
    win = {}
    for i, (_, r, p) in enumerate(items):
        s = int(f[i])
        out[L][(r, p)] = s
        for lev in range(L, 0, -1):
            node = r >> lev
            side = (r >> (lev - 1)) & 1
            w = s // BLOCK
            key = (lev, node, side)
            if win.get(key) != w:
                q[key] = 0
                win[key] = w
            rank = q[key]
            q[key] = rank + 1
            s = WIN * w + rank
            out[lev - 1][(r, p)] = s
    return out


def _align_up(x: int, a: int) -> int:
    return -(-x // a) * a if a > 1 else x


def schedule_grouped(runs, align_rows: int = 1):
    """Copy-window (round-5) scheduler: the per-row generalization of
    :func:`schedule` that the production planner vectorizes.

    Instead of deriving every level from one global final-slot walk with
    64-per-side window quotas, each level is scheduled independently,
    bottom-up, against the per-row kernel contract: output row o reads
    ONE full 128-lane input row per side (scalar-prefetched ``arow[o]``,
    ``brow[o]``) and an int8 code plane routes lanes (v >= 0 side A
    lane v, v < 0 side B lane v & 127). A row whose codes are
    single-sided is a COPY row — a drained or dominant side streams at
    full rate (128/row) instead of stalling at the 64/64 merge rate,
    which is the entire point. The
    walk emits a copy row exactly when the next <=128 merged reals are
    single-sided within one input row.

    A row closes when it holds 128 reals or when the merged order
    needs a real from an input row other than the one the row reads
    for that side (the only stall source left). ``align_rows`` pads
    every leaf/node stream base to that many rows (the 8-row
    block constraint; the planner adds remainder bin-packing on top).

    Returns ``(levels, final_items, total_rows)``: ``levels[k]`` is a
    dict of numpy arrays {arow, brow, codes, nvalid, mode} for merge
    level k+1 (mode 0 merge, 1 copy-A, 2 copy-B), ``final_items`` the
    reals as (dst, run, pos, slot) in merged order, ``total_rows`` the
    per-level stream row counts [level0, ..., root].
    """
    R = _tree_size(len(runs))
    L = R.bit_length() - 1

    # Leaf streams: run r dense from an aligned base.
    streams = []
    base = 0
    for r in range(R):
        a = np.asarray(runs[r]) if r < len(runs) else np.empty(0, np.int64)
        streams.append([
            (int(d), r, p, base + p // BLOCK, p % BLOCK)
            for p, d in enumerate(a)
        ])
        base = _align_up(base + (len(a) + BLOCK - 1) // BLOCK, align_rows)
    total_rows = [base]

    levels = []
    for lev in range(1, L + 1):
        arow, brow, codes, nvalid, mode = [], [], [], [], []
        out_streams = []
        ob = 0
        for node in range(R >> lev):
            A, B = streams[2 * node], streams[2 * node + 1]
            out = []
            ia = ib = 0
            while ia < len(A) or ib < len(B):
                ra = A[ia][3] if ia < len(A) else -1
                rb = B[ib][3] if ib < len(B) else -1
                row_codes = np.zeros(BLOCK, np.int8)
                count = 0
                took_a = took_b = False
                while count < BLOCK:
                    ta = A[ia] if ia < len(A) else None
                    tb = B[ib] if ib < len(B) else None
                    if ta is None and tb is None:
                        break
                    # Merged order: (dst, run) — side A holds the lower
                    # run ids of the node, so ties go to A.
                    use_a = tb is None or (
                        ta is not None and ta[:2] <= tb[:2]
                    )
                    if use_a:
                        if ta[3] != ra:
                            break          # next A real is in a later row
                        row_codes[count] = ta[4]
                        out.append((ta[0], ta[1], ta[2], ob, count))
                        ia += 1
                        took_a = True
                    else:
                        if tb[3] != rb:
                            break
                        row_codes[count] = tb[4] - BLOCK
                        out.append((tb[0], tb[1], tb[2], ob, count))
                        ib += 1
                        took_b = True
                    count += 1
                arow.append(ra if took_a else max(rb, 0))
                brow.append(rb if took_b else max(ra, 0))
                codes.append(row_codes)
                nvalid.append(count)
                mode.append(0 if (took_a and took_b) else (1 if took_a else 2))
                ob += 1
            out_streams.append(out)
            # Materialize alignment gap rows so row ids stay physical
            # (nvalid 0: pure pads, contributing nothing).
            while ob != _align_up(ob, align_rows):
                arow.append(0)
                brow.append(0)
                codes.append(np.zeros(BLOCK, np.int8))
                nvalid.append(0)
                mode.append(0)
                ob += 1
        levels.append({
            "arow": np.asarray(arow, np.int32),
            "brow": np.asarray(brow, np.int32),
            "codes": (np.stack(codes) if codes
                      else np.zeros((0, BLOCK), np.int8)),
            "nvalid": np.asarray(nvalid, np.int32),
            "mode": np.asarray(mode, np.int8),
        })
        total_rows.append(ob)
        streams = out_streams

    final_items = [
        (d, r, p, row * BLOCK + lane) for d, r, p, row, lane in streams[0]
    ]
    return levels, final_items, total_rows


def simulate_grouped(runs, values, align_rows: int = 1):
    """Execute the copy-window network with the per-row kernel's exact
    semantics and return (final_stream, final_items).

    Asserts the device contract at every level: codes may only address
    lanes that hold reals (pads are never referenced, so intermediate
    pad lanes can stay garbage on device; only the root is masked by
    ``nvalid``), and the final stream is globally dst-sorted.
    """
    levels, final_items, total_rows = schedule_grouped(runs, align_rows)
    R = _tree_size(len(runs))

    cur = np.zeros((max(total_rows[0], 1), BLOCK), np.float64)
    valid = np.zeros_like(cur, bool)
    base = 0
    for r in range(R):
        a = runs[r] if r < len(runs) else ()
        for p in range(len(a)):
            cur[base + p // BLOCK, p % BLOCK] = values[r][p]
            valid[base + p // BLOCK, p % BLOCK] = True
        base = _align_up(base + (len(a) + BLOCK - 1) // BLOCK, align_rows)

    for k, lv in enumerate(levels):
        lane = lv["codes"].astype(np.int64) & 127
        is_a = lv["codes"] >= 0
        src_row = np.where(is_a, lv["arow"][:, None], lv["brow"][:, None])
        nxt = cur[src_row, lane]
        nvalid = lv["nvalid"]
        iota = np.arange(BLOCK)
        live = iota[None, :] < nvalid[:, None]
        # Contract: every live code addresses a real input lane.
        assert np.all(valid[src_row, lane][live]), (
            "grouped level references a pad lane", k + 1)
        nxt = np.where(live, nxt, 0.0)
        nrows = max(total_rows[k + 1], 1)
        cur = np.zeros((nrows, BLOCK), np.float64)
        cur[: nxt.shape[0]] = nxt
        valid = np.zeros_like(cur, bool)
        valid[: nxt.shape[0]] = live

    dsts = [d for d, _, _, _ in final_items]
    assert all(a <= b for a, b in zip(dsts, dsts[1:])), "dst order broken"
    return cur, final_items


def simulate(runs, values):
    """Execute the network in numpy with the DEVICE KERNEL's semantics
    and return the final stream (values at final slots, zeros at pads).

    ``values``: list of arrays aligned with ``runs`` (the per-real
    contribution values). Each level is applied exactly the way the
    pallas kernel would: output slot o of a node takes input slot
    64*(o//128) + k of side A (k = lane code) or of side B — here
    reconstructed from the per-level slot maps.
    """
    f, items = schedule(runs)
    slots = derive_level_slots(runs, f, items)
    R = _tree_size(len(runs))
    L = R.bit_length() - 1

    # Level-0 streams: one per leaf run (its input layout).
    cur = {}
    for r in range(R):
        cur[r] = np.zeros(BLOCK, np.float64)
    for (r, p), s in slots[0].items():
        if s >= cur[r].shape[0]:
            grow = ((s + BLOCK) // BLOCK) * BLOCK
            cur[r] = np.pad(cur[r], (0, grow - cur[r].shape[0]))
        cur[r][s] = values[r][p]

    # Apply levels: node n at level ℓ merges children 2n (A) and 2n+1
    # (B) of level ℓ-1. Every output slot reads ONE input slot of one
    # side, within the window — emulate via the slot maps.
    for lev in range(1, L + 1):
        nxt = {}
        for node in range(R >> lev):
            nxt[node] = np.zeros(BLOCK, np.float64)
        for (r, p), s in slots[lev].items():
            node = r >> lev
            side = (r >> (lev - 1)) & 1
            s_in = slots[lev - 1][(r, p)]
            # Kernel contract: out slot s reads side input slot s_in
            # with 64*(s//128) <= s_in < 64*(s//128) + 64.
            w = s // BLOCK
            assert WIN * w <= s_in < WIN * w + WIN, (
                "window violation", lev, r, p, s, s_in
            )
            child = 2 * node + side
            v = cur[child][s_in] if s_in < cur[child].shape[0] else 0.0
            if s >= nxt[node].shape[0]:
                grow = ((s + BLOCK) // BLOCK) * BLOCK
                nxt[node] = np.pad(nxt[node], (0, grow - nxt[node].shape[0]))
            nxt[node][s] = v
        cur = nxt
    return cur[0], f, items
