"""Delta graphs: an immutable base CSC plus sorted edit runs; the
counterpart of ``lux_tpu/graph/delta.py``, on the host as there.

The GPU-accelerator survey (arXiv:1902.10130) calls streaming/mutable
graphs the open frontier for graph accelerators. The representation here
is the classic LSM-flavored one: the base CSC never mutates; inserts
accumulate as a ``(dst, src)``-sorted run, deletes as a sorted key set
over the base. ``merged()`` materializes a fresh CSC with one
counting-sort pass
(:func:`lux_tpu_torch.ops.segment.csc_counting_merge`) — O(ne + ni +
nv), no comparison sort — and is bitwise-identical to
``Graph.from_edges`` over the surviving edge list (and to ``lux_tpu``'s
merge of the same edits), so every downstream engine, fingerprint, and
plan sees an ordinary frozen graph.

Semantics (the same as ``lux_tpu``'s; tested in test_torch_delta.py):

- The vertex set is fixed: edits are edge-only. Growing ``nv`` means a
  new base graph, not a delta.
- A delete removes *all* parallel copies of a ``(src, dst)`` pair.
- Within one ``EdgeEdits`` batch, deletes apply before inserts, so
  delete-then-reinsert in a single batch leaves the edge present (as a
  fresh insert).
- Edge keys are ``dst * nv + src`` in int64 — unique for nv < 2**31.5,
  far beyond an in-RAM CSC.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lux_tpu_torch.graph.graph import Graph, W_DTYPE
from lux_tpu_torch.utils.locks import make_lock


def _edge_keys(src: np.ndarray, dst: np.ndarray, nv: int) -> np.ndarray:
    keys = np.asarray(dst).astype(np.int64)     # in place from here on
    keys *= np.int64(nv)
    keys += src
    return keys


def _in_sorted(keys: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``np.isin(keys, table)`` for a sorted, unique int64 ``table`` of
    edge keys, the same mask: a byte map of the keys' multiplicative
    hashes (about 16 slots a table key) passes the few keys that may be
    in the table, and a binary search settles those — about 8x faster
    than ``isin``'s sort of both arrays at 8 M keys against 42 K."""
    out = np.zeros(keys.shape, dtype=bool)
    if not table.size or not keys.size:
        return out
    bits = max(16, int(table.size * 16 - 1).bit_length())
    shift = np.uint64(64 - bits)
    mult = np.uint64(0x9E3779B97F4A7C15)
    mark = np.zeros(1 << bits, dtype=bool)
    mark[(table.view(np.uint64) * mult) >> shift] = True
    h = np.ascontiguousarray(keys).view(np.uint64) * mult
    h >>= shift
    maybe = np.flatnonzero(mark[h])
    del h
    cand = keys[maybe]
    pos = np.searchsorted(table, cand)
    pos[pos == table.size] = 0
    out[maybe] = table[pos] == cand
    return out


@dataclasses.dataclass(frozen=True)
class EdgeEdits:
    """One batch of edge edits: arrays of inserts and deletes.

    ``ins_src``/``ins_dst`` (and optional ``ins_w``) are the edges to add;
    ``del_src``/``del_dst`` the pairs to remove. No ordering requirement —
    :meth:`DeltaGraph.stack` sorts.
    """

    ins_src: np.ndarray
    ins_dst: np.ndarray
    ins_w: Optional[np.ndarray]
    del_src: np.ndarray
    del_dst: np.ndarray

    @staticmethod
    def from_lists(insert=(), delete=()) -> "EdgeEdits":
        """Build from ``[(u, v)]`` / ``[(u, v, w)]`` insert and ``[(u, v)]``
        delete pairs (``u -> v``: u is the source)."""
        ins = list(insert)
        dels = list(delete)
        weighted = bool(ins) and len(ins[0]) == 3
        if any((len(t) == 3) != weighted for t in ins):
            raise ValueError("mixed weighted/unweighted inserts")
        return EdgeEdits(
            ins_src=np.asarray([t[0] for t in ins], dtype=np.int64),
            ins_dst=np.asarray([t[1] for t in ins], dtype=np.int64),
            ins_w=(np.asarray([t[2] for t in ins], dtype=W_DTYPE)
                   if weighted else None),
            del_src=np.asarray([t[0] for t in dels], dtype=np.int64),
            del_dst=np.asarray([t[1] for t in dels], dtype=np.int64),
        )

    @property
    def n_ins(self) -> int:
        return int(self.ins_src.shape[0])

    @property
    def n_del(self) -> int:
        return int(self.del_src.shape[0])

    def validate(self, nv: int) -> None:
        for name, arr in (("ins_src", self.ins_src), ("ins_dst", self.ins_dst),
                          ("del_src", self.del_src), ("del_dst", self.del_dst)):
            if arr.size and (arr.min() < 0 or arr.max() >= nv):
                raise ValueError(
                    f"{name} has vertex ids outside [0, {nv}); edits are "
                    "edge-only — the vertex set is fixed per base graph"
                )


def removed_edges(graph: Graph, del_src: np.ndarray, del_dst: np.ndarray):
    """The ``(src, dst, w|None)`` arrays of edges of ``graph`` that a
    delete batch actually removes (all parallel copies of each pair)."""
    if not len(del_src):
        e = np.zeros(0, dtype=np.int64)
        return e, e, (np.zeros(0, dtype=graph.weights.dtype)
                      if graph.weighted else None)
    keys = _edge_keys(graph.col_src, graph.col_dst, graph.nv)
    hit = _in_sorted(keys, np.unique(_edge_keys(
        np.asarray(del_src), np.asarray(del_dst), graph.nv)))
    idx = np.nonzero(hit)[0]
    return (
        graph.col_src[idx].astype(np.int64),
        graph.col_dst[idx].astype(np.int64),
        graph.weights[idx] if graph.weighted else None,
    )


@dataclasses.dataclass(eq=False)
class DeltaGraph:
    """Immutable base CSC + sorted insert run + sorted delete key set.

    ``stack(edits)`` returns a *new* DeltaGraph (value semantics — a
    snapshot holding this delta never changes under it). ``merged()`` is
    lazy, cached, and thread-safe; with no pending edits it returns the
    base graph object itself so identity (and hence the snapshot
    fingerprint) is preserved across no-op stacks and compactions.
    """

    base: Graph
    ins_src: np.ndarray               # int64, sorted by (dst, src)
    ins_dst: np.ndarray               # int64, sorted by (dst, src)
    ins_w: Optional[np.ndarray]
    del_keys: np.ndarray              # int64, sorted unique, base-relative

    def __post_init__(self):
        self._merge_lock = make_lock("delta.merge")
        self._merged: Optional[Graph] = None

    @staticmethod
    def fresh(base: Graph) -> "DeltaGraph":
        e = np.zeros(0, dtype=np.int64)
        w = np.zeros(0, dtype=base.weights.dtype) if base.weighted else None
        return DeltaGraph(base=base, ins_src=e, ins_dst=e, ins_w=w, del_keys=e)

    # -- sizes -----------------------------------------------------------

    @property
    def n_ins(self) -> int:
        return int(self.ins_src.shape[0])

    @property
    def n_del(self) -> int:
        return int(self.del_keys.shape[0])

    @property
    def delta_edges(self) -> int:
        return self.n_ins + self.n_del

    @property
    def ratio(self) -> float:
        """Pending-edit volume relative to the base edge count — the
        compaction trigger compared against LUX_DELTA_COMPACT_RATIO."""
        return self.delta_edges / max(self.base.ne, 1)

    # -- stacking --------------------------------------------------------

    def stack(self, edits: EdgeEdits) -> "DeltaGraph":
        """Apply one edit batch on top of this delta, returning a new one.

        Deletes land first: they drop matching *pending inserts* and join
        the base delete-key set (kept as stated keys — ``merged()`` masks
        by membership, so keys absent from the base are harmless). Inserts
        are then merge-appended, so a delete-then-reinsert pair inside one
        batch leaves the edge present.
        """
        nv = self.base.nv
        edits.validate(nv)
        if self.base.weighted and edits.n_ins and edits.ins_w is None:
            raise ValueError("weighted base graph requires insert weights")
        if not self.base.weighted and edits.ins_w is not None:
            raise ValueError("insert weights given for an unweighted base")

        ins_src, ins_dst, ins_w = self.ins_src, self.ins_dst, self.ins_w
        del_keys = self.del_keys
        if edits.n_del:
            nk = np.unique(_edge_keys(edits.del_src, edits.del_dst, nv))
            if self.n_ins:
                keep = ~_in_sorted(_edge_keys(ins_src, ins_dst, nv), nk)
                ins_src, ins_dst = ins_src[keep], ins_dst[keep]
                if ins_w is not None:
                    ins_w = ins_w[keep]
            del_keys = np.union1d(del_keys, nk)
        if edits.n_ins:
            new_keys = _edge_keys(edits.ins_src, edits.ins_dst, nv)
            order = np.argsort(new_keys, kind="stable")
            all_src = np.concatenate([ins_src, edits.ins_src[order]])
            all_dst = np.concatenate([ins_dst, edits.ins_dst[order]])
            all_w = (np.concatenate([ins_w, edits.ins_w[order]])
                     if ins_w is not None else None)
            merged_order = np.argsort(
                _edge_keys(all_src, all_dst, nv), kind="stable")
            ins_src = all_src[merged_order]
            ins_dst = all_dst[merged_order]
            if all_w is not None:
                ins_w = all_w[merged_order]
            # Inserts re-deleted by a *later* batch were filtered above;
            # keys they shared with base deletes stay in del_keys, and the
            # fresh inserts still land (inserts are appended post-mask).
        return DeltaGraph(base=self.base, ins_src=ins_src, ins_dst=ins_dst,
                          ins_w=ins_w, del_keys=del_keys)

    # -- materialization -------------------------------------------------

    def merged(self) -> Graph:
        """The delta applied to the base as a fresh frozen CSC (cached)."""
        if self._merged is not None:
            return self._merged
        with self._merge_lock:
            if self._merged is None:
                self._merged = self._materialize()
        return self._merged

    def _materialize(self) -> Graph:
        # Deferred so `import lux_tpu_torch.graph` stays torch-free
        # (ops.segment pulls in torch); only materializing a non-empty
        # delta pays it.
        from lux_tpu_torch.ops.segment import csc_counting_merge

        base = self.base
        if not self.delta_edges:
            return base
        if self.n_del:
            keys = _edge_keys(base.col_src, base.col_dst, base.nv)
            keep = ~_in_sorted(keys, self.del_keys)
        else:
            keep = np.ones(base.ne, dtype=bool)
        rp, src, w = csc_counting_merge(
            base.row_ptr, base.col_src, base.weights, keep,
            self.ins_dst, self.ins_src, self.ins_w, base.nv,
        )
        return Graph(nv=base.nv, ne=int(rp[-1]), row_ptr=rp,
                     col_src=src.astype(base.col_src.dtype), weights=w)
