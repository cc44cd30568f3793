"""Label-propagation community detection (GAS model), the counterpart
of ``lux_tpu/models/labelprop.py``.

The monotone max-id formulation with a bounded radius: each vertex
carries a packed ``(label << HOP_BITS) | hops_left`` word, seeded with
its own id and ``RADIUS`` hop credits; a message spends one hop and a
vertex adopts the largest packed word it sees. Every vertex converges to
the largest vertex id within ``RADIUS`` hops, deterministically and
whatever the direction, in at most ``RADIUS + 1`` iterations. The
frontier starts all-dense and collapses as labels settle. On the card
the gather is K10/K11's ``"decay"``.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.engine.gas import GasProgram
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.ops.segment import DECAY_HOP_MASK, GATHER_OPS

RADIUS = 16                 # seed hop budget = max propagation radius
HOP_BITS = 8
HOP_MASK = DECAY_HOP_MASK   # (1 << HOP_BITS) - 1, the gather op's mask
LABEL_BITS = 32 - HOP_BITS  # 24 bits of label (vertex id)


class LabelPropagation(GasProgram):
    name = "labelprop"
    combiner = "max"
    value_dtype = np.uint32
    gather_op = "decay"

    def init_values(self, graph: Graph, **kw) -> np.ndarray:
        if graph.nv >= 1 << LABEL_BITS:
            raise ValueError(
                f"labelprop packs labels into {LABEL_BITS} bits; "
                f"nv={graph.nv} does not fit")
        ids = np.arange(graph.nv, dtype=np.uint32)
        return (ids << HOP_BITS) | np.uint32(RADIUS)

    def init_frontier(self, graph: Graph, **kw) -> np.ndarray:
        return np.ones(graph.nv, dtype=bool)

    def gather(self, src_vals, weights):
        # A spent hop budget propagates 0, the max identity.
        return GATHER_OPS["decay"](src_vals, weights)

    def finalize_host(self, graph: Graph, values: np.ndarray) -> dict:
        labels = (values >> np.uint32(HOP_BITS)).astype(np.uint32)
        return {
            "labels": labels,
            "num_communities": int(np.unique(labels).size),
        }


def reference_labelprop(graph: Graph) -> np.ndarray:
    """Host numpy oracle: ``lux_tpu``'s monotone fixpoint, with its
    ``np.maximum.at`` over the CSC edges replaced by one
    ``np.maximum.reduceat`` over the non-empty CSC rows."""
    nv = graph.nv
    src = graph.col_src
    rows = np.flatnonzero(graph.in_degrees > 0)
    starts = graph.row_ptr[rows]
    vals = (np.arange(nv, dtype=np.uint32) << HOP_BITS) | np.uint32(RADIUS)
    frontier = np.ones(nv, dtype=bool)
    while frontier.any():
        sv = vals[src]
        hops = sv & HOP_MASK
        msg = (sv & ~np.uint32(HOP_MASK)) | ((hops - 1) & HOP_MASK)
        msg = np.where((hops > 0) & frontier[src], msg, 0).astype(np.uint32)
        acc = np.zeros(nv, dtype=np.uint32)
        if rows.size:
            acc[rows] = np.maximum.reduceat(msg, starts)
        new = np.maximum(vals, acc)
        frontier = new != vals
        vals = new
    return vals
