"""Sharded (padded, stacked) graph layout.

A copy of ``lux_tpu/parallel/shard.py`` (host numpy); tests hold every
array byte-identical to the reference's. The reference gives each GPU a
contiguous vertex range plus its in-edge block (edge-balanced
partitioning, core/pull_model.inl:108-131) and lets Legion materialize
whole-region reads for remote vertex values (pull_model.inl:454-461).
Here, as in ``lux_tpu``:

- every per-part array is padded to the maximum part size and stacked into
  a leading ``(P, ...)`` axis, the parts axis of the mesh
  (:mod:`lux_tpu_torch.parallel.mesh`);
- a remote vertex read indexes the *flattened padded* value array
  ``(P * max_nv,)``; the per-edge index ``src_pidx = part(src) * max_nv +
  local(src)`` is precomputed on the host once (the analogue of the
  reference's per-part ``in_vtxs`` gather list, pagerank_gpu.cu:229-241);
- pad edges point at a trash segment (``dst_local == max_nv``) and lie
  past ``local_row_ptr[max_nv]``, so no row's edge range holds one; pad
  vertices carry ``vertex_mask == False``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lux_tpu_torch.graph.graph import Graph, stable_argsort
from lux_tpu_torch.graph.partition import ExchangePlan, PartitionInfo
from lux_tpu_torch.utils import flags


def exchange_mode() -> str:
    """The requested sharded exchange mode (``LUX_EXCHANGE``), validated.

    Executors capture this at build time, so a flag flip mid-process
    only affects engines built after it."""
    v = (flags.get("LUX_EXCHANGE") or "full").strip().lower()
    if v not in ("full", "compact", "frontier"):
        raise ValueError(
            f"LUX_EXCHANGE={v!r}: use 'full' (whole-shard all_gather), "
            "'compact' (needed-rows packed exchange), or 'frontier' "
            "(active-rows packed exchange with static-compact downgrade)"
        )
    return v


def resolve_exchange(sg: "ShardedGraph", log=None, frontier_ok: bool = False):
    """(mode, plan) an executor should build with: the requested mode,
    downgraded to ``("full", None)`` whenever compaction cannot help —
    P=1 (compaction must be a no-op: the build emits the exact full-mode
    program), released edge arrays (no plan can be derived), or an
    unprofitable plan (densest pair needs >= max_nv rows, so packing
    would move more than the all_gather). ``frontier`` additionally
    needs an executor whose exchange carries per-iteration activity
    (``frontier_ok``) — the frontier-less executors honestly run the
    static compact plan instead. Downgrades are logged, never silent
    (P=1 included, which ``lux_tpu`` does not log)."""
    mode = exchange_mode()
    if mode == "full":
        return "full", None
    if sg.num_parts <= 1:
        # lux_tpu returns here without a note; the port logs this one too.
        if log is not None:
            log.info("LUX_EXCHANGE=%s falling back to full: one part "
                     "exchanges nothing", mode)
        return "full", None
    plan = sg.exchange_plan()
    why = None
    if plan is None:
        why = "edge arrays were released before a plan was built"
    elif not plan.profitable:
        why = (f"capacity {plan.capacity} >= max_nv {sg.max_nv}: packing "
               "would move more rows than the all_gather")
        plan = None
    if plan is None:
        if log is not None:
            log.info("LUX_EXCHANGE=%s falling back to full: %s", mode, why)
        return "full", None
    if mode == "frontier" and not frontier_ok:
        if log is not None:
            log.info(
                "LUX_EXCHANGE=frontier: this executor's exchange has no "
                "per-iteration activity plane; using the static compact plan"
            )
        return "compact", plan
    return mode, plan


def validated_sg(sg: Optional["ShardedGraph"], graph: Graph,
                 num_parts: int) -> "ShardedGraph":
    """A prebuilt partition (``lux_tpu``'s serving layer caches one per
    graph and part count) after checking that it describes this graph
    and mesh; a fresh one when ``sg`` is None. ``lux_tpu``'s
    ``engine/push.py::_validated_sg``."""
    if sg is None:
        return ShardedGraph.build(graph, num_parts)
    if sg.num_parts != num_parts:
        raise ValueError(
            f"prebuilt ShardedGraph has {sg.num_parts} parts, mesh has "
            f"{num_parts}"
        )
    if sg.graph is not graph:
        raise ValueError(
            "prebuilt ShardedGraph was built from a different Graph "
            "object — edge indices and partition bounds would not "
            "match this executor's graph"
        )
    return sg


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(eq=False)
class ShardedGraph:
    """Host-side stacked/padded CSC shards (the executor copies them to
    its device)."""

    graph: Graph
    info: PartitionInfo
    num_parts: int
    max_nv: int                 # padded per-part vertex count
    max_ne: int                 # padded per-part edge count
    # (P, max_ne) stacked edge arrays:
    src_pidx: np.ndarray        # int32 index into flattened (P*max_nv,) values
    src_global: np.ndarray      # int32 global source id (pad: 0)
    dst_local: np.ndarray       # int32 local dst id; == max_nv for pad edges
    edge_mask: np.ndarray       # bool, False on pad edges
    weights: Optional[np.ndarray]   # int32 or None
    # (P, max_nv + 1):
    local_row_ptr: np.ndarray   # int32 CSC offsets within the part's block
    # (P, max_nv):
    out_degrees: np.ndarray     # int32 (global out-degree of each local vtx)
    in_degrees: np.ndarray      # int32
    vertex_mask: np.ndarray     # bool, False on pad vertices
    # (P,):
    local_nv: np.ndarray        # int32 real vertex count per part
    row_left: np.ndarray        # int64 global id of local vertex 0

    @staticmethod
    def build(
        graph: Graph,
        num_parts: int,
        nv_multiple: int = 8,
        ne_multiple: int = 128,
    ) -> "ShardedGraph":
        info = PartitionInfo.build(graph.row_ptr, num_parts)
        P = num_parts
        part_nv = np.array(
            [max(r - l + 1, 0) for (l, r) in info.bounds], dtype=np.int64
        )
        part_ne = np.array(
            [e - s for (s, e) in info.edge_bounds], dtype=np.int64
        )
        max_nv = _round_up(max(int(part_nv.max()), 1), nv_multiple)
        max_ne = _round_up(max(int(part_ne.max()), 1), ne_multiple)

        # Global vertex id → (part, local id). Parts are contiguous ranges,
        # so part(v) = searchsorted over the range starts.
        lefts = np.array(
            [l for (l, r) in info.bounds if r >= l], dtype=np.int64
        )
        nonempty = np.array(
            [i for i, (l, r) in enumerate(info.bounds) if r >= l],
            dtype=np.int64,
        )

        def part_of(v: np.ndarray) -> np.ndarray:
            idx = np.searchsorted(lefts, v, side="right") - 1
            return nonempty[idx]

        row_left_full = np.zeros(P, dtype=np.int64)
        for i, (l, r) in enumerate(info.bounds):
            row_left_full[i] = l

        src_pidx = np.zeros((P, max_ne), dtype=np.int32)
        src_global = np.zeros((P, max_ne), dtype=np.int32)
        dst_local = np.full((P, max_ne), max_nv, dtype=np.int32)
        edge_mask = np.zeros((P, max_ne), dtype=bool)
        weights = (
            np.zeros((P, max_ne), dtype=np.int32)
            if graph.weights is not None
            else None
        )
        local_row_ptr = np.zeros((P, max_nv + 1), dtype=np.int32)
        out_deg = np.zeros((P, max_nv), dtype=np.int32)
        in_deg = np.zeros((P, max_nv), dtype=np.int32)
        vertex_mask = np.zeros((P, max_nv), dtype=bool)

        g_out = graph.out_degrees
        g_in = graph.in_degrees
        for p, ((l, r), (es, ee)) in enumerate(
            zip(info.bounds, info.edge_bounds)
        ):
            n_v = max(r - l + 1, 0)
            n_e = ee - es
            if n_v == 0:
                continue
            # graph.col_src may be an np.memmap at RMAT27 scale
            # (read_lux_mmap) — slice-then-convert keeps host cost to
            # one part's edges at a time, and the local dsts come from
            # the part's row_ptr slice rather than the global col_dst
            # expansion (an 8.6 GB materialization at 2^31 edges).
            srcs = np.asarray(graph.col_src[es:ee]).astype(np.int64)
            sp = part_of(srcs)
            src_pidx[p, :n_e] = (
                sp * max_nv + (srcs - row_left_full[sp])
            ).astype(np.int32)
            src_global[p, :n_e] = srcs.astype(np.int32)
            local_in = np.diff(graph.row_ptr[l : r + 2])
            dst_local[p, :n_e] = np.repeat(
                np.arange(n_v, dtype=np.int32), local_in
            )
            edge_mask[p, :n_e] = True
            if weights is not None:
                weights[p, :n_e] = graph.weights[es:ee]
            local_row_ptr[p, 1 : n_v + 1] = (
                graph.row_ptr[l + 1 : r + 2] - es
            ).astype(np.int32)
            local_row_ptr[p, n_v + 1 :] = n_e
            out_deg[p, :n_v] = g_out[l : r + 1]
            in_deg[p, :n_v] = g_in[l : r + 1]
            vertex_mask[p, :n_v] = True

        return ShardedGraph(
            graph=graph,
            info=info,
            num_parts=P,
            max_nv=max_nv,
            max_ne=max_ne,
            src_pidx=src_pidx,
            src_global=src_global,
            dst_local=dst_local,
            edge_mask=edge_mask,
            weights=weights,
            local_row_ptr=local_row_ptr,
            out_degrees=out_deg,
            in_degrees=in_deg,
            vertex_mask=vertex_mask,
            local_nv=part_nv.astype(np.int32),
            row_left=row_left_full,
        )

    def release_edge_arrays(self):
        """Drop the stacked per-edge host arrays (the ~13 bytes/edge that
        dominate host RSS at RMAT27 scale) once they are resident on
        device. ``to_padded``/``from_padded`` keep working — they only
        need the partition bounds; ``build_push_csr`` does not."""
        self.src_pidx = self.src_global = None
        self.dst_local = self.edge_mask = self.weights = None

    # -- remote-read index ------------------------------------------------

    def remote_read_counts(self) -> Optional[np.ndarray]:
        """(P, P) int64 matrix C where ``C[q, p]`` is the number of
        *distinct* rows of part p's padded shard table that part q's real
        edges gather — the needed-rows index: row q of the all_gather is
        only useful to part q up to ``C[q, :].sum()`` rows out of
        ``P * max_nv`` exchanged. The compact exchange
        (:meth:`exchange_plan`) sends exactly the off-diagonal rows.

        Computed once from ``src_pidx``/``edge_mask`` and cached on the
        instance; returns the cached matrix after
        ``release_edge_arrays``, or None when the arrays were released
        before the index was ever built.
        """
        cached = getattr(self, "_remote_read_counts", None)
        if cached is not None:
            return cached
        if self.src_pidx is None or self.edge_mask is None:
            return None
        P = self.num_parts
        counts = np.zeros((P, P), dtype=np.int64)
        for q in range(P):
            rows = np.unique(self.src_pidx[q][self.edge_mask[q]])
            if rows.size:
                counts[q] += np.bincount(
                    rows // self.max_nv, minlength=P
                ).astype(np.int64)
        self._remote_read_counts = counts
        return counts

    def exchange_plan(self, capacity: Optional[int] = None):
        """Row-granular :class:`ExchangePlan` for the compacted exchange
        (``LUX_EXCHANGE=compact``): per-(sender → receiver) send-row
        index tables derived from the same ``src_pidx``/``edge_mask``
        data that feeds :meth:`remote_read_counts`, padded to one static
        per-pair capacity.

        Cached on the instance (default capacity only) like the
        remote-read index; returns the cached plan after
        ``release_edge_arrays``, or None when the arrays were released
        before a plan was ever built. An explicit ``capacity`` too small
        for the densest pair raises (loud, never truncating)."""
        cached = getattr(self, "_exchange_plan", None)
        if capacity is None and cached is not None:
            return cached
        if self.src_pidx is None or self.edge_mask is None:
            return cached
        plan = ExchangePlan.from_src_pidx(
            self.src_pidx, self.edge_mask, self.max_nv, self.num_parts,
            capacity=capacity,
        )
        if capacity is None:
            self._exchange_plan = plan
        return plan

    # -- push-direction (CSR-by-global-src) view -------------------------

    def build_push_csr(self):
        """Per-shard CSR of the part's edges keyed by *global* source id.

        The reference gives every GPU a full global push row-pointer array
        restricted to its local edge set (the ``nv * numParts`` region,
        core/push_model.inl:321-324,449-465) so any device can expand any
        frontier vertex against its local edges. Same here: shard p's
        ``push_row_ptr`` spans all nv global sources (+2 pad entries so the
        sentinel id ``nv`` reads zero degree), and ``push_dst_local``/
        ``push_weights`` hold the part's edges re-sorted by source.

        Returns (push_row_ptr (P, nv+2) int32, push_dst_local (P, max_ne)
        int32 with pad == max_nv, push_weights (P, max_ne) int32 or None).
        Cached on the instance (callers only read it), so executors that
        share a partition build it once.
        """
        cached = getattr(self, "_push_csr", None)
        if cached is not None:
            return cached
        P, nv = self.num_parts, self.graph.nv
        rp = np.zeros((P, nv + 2), dtype=np.int32)
        dstl = np.full((P, self.max_ne), self.max_nv, dtype=np.int32)
        w = (
            np.zeros((P, self.max_ne), dtype=np.int32)
            if self.weights is not None
            else None
        )
        for p in range(P):
            m = self.edge_mask[p]
            n_e = int(m.sum())
            if n_e == 0:
                continue
            srcs = self.src_global[p, :n_e].astype(np.int64)
            order = stable_argsort(srcs)
            dstl[p, :n_e] = self.dst_local[p, :n_e][order]
            if w is not None:
                w[p, :n_e] = self.weights[p, :n_e][order]
            counts = np.bincount(srcs, minlength=nv)
            rp[p, 1 : nv + 1] = np.cumsum(counts)
            rp[p, nv + 1] = n_e
        self._push_csr = (rp, dstl, w)
        return self._push_csr

    # -- host value layout conversions ----------------------------------

    def to_padded(self, global_vals: np.ndarray) -> np.ndarray:
        """(nv, *t) → (P, max_nv, *t), pad slots zero-filled."""
        trailing = global_vals.shape[1:]
        out = np.zeros(
            (self.num_parts, self.max_nv) + trailing, global_vals.dtype
        )
        for p, (l, r) in enumerate(self.info.bounds):
            if r >= l:
                out[p, : r - l + 1] = global_vals[l : r + 1]
        return out

    def from_padded(self, padded: np.ndarray) -> np.ndarray:
        """(P, max_nv, *t) → (nv, *t)."""
        trailing = padded.shape[2:]
        out = np.zeros((self.graph.nv,) + trailing, padded.dtype)
        for p, (l, r) in enumerate(self.info.bounds):
            if r >= l:
                out[l : r + 1] = padded[p, : r - l + 1]
        return out
