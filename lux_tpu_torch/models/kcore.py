"""k-core decomposition by peeling (GAS model), the counterpart of
``lux_tpu/models/kcore.py``.

Values are live in-degrees; the frontier is the set of vertices removed
this round. A removed vertex fires once, one unit message per out-edge;
survivors subtract the received count and join the next frontier iff
that drops them below k. Removed vertices freeze at their at-removal
degree. The fixpoint's alive set is the k-core. The uint32 subtraction
of a removed vertex may wrap; its result is thrown away by ``apply``'s
where. On the card the gather is K10/K11's ``"one"`` with the sum
combiner (integer atomics, order-free).
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.engine.gas import GasProgram
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.ops.segment import U32_MASK


class KCore(GasProgram):
    name = "kcore"
    combiner = "sum"
    value_dtype = np.uint32
    gather_op = "one"

    def __init__(self, k: int = 2):
        if int(k) < 1:
            raise ValueError(f"kcore needs k >= 1 (got {k})")
        self.k = int(k)

    def init_values(self, graph: Graph, **kw) -> np.ndarray:
        return graph.in_degrees.astype(np.uint32)

    def init_frontier(self, graph: Graph, **kw) -> np.ndarray:
        return (graph.in_degrees < self.k).astype(bool)

    def gather(self, src_vals, weights):
        return torch.ones_like(src_vals)   # one decrement per removed in-edge

    def apply(self, old, acc):
        # Only still-alive vertices absorb decrements (uint32 arithmetic:
        # a frozen vertex's wrapped difference is discarded).
        return torch.where(old >= self.k, (old - acc) & U32_MASK, old)

    def scatter(self, old, new):
        return (old >= self.k) & (new < self.k)

    def finalize_host(self, graph: Graph, values: np.ndarray) -> dict:
        alive = (values >= np.uint32(self.k)).astype(np.uint8)
        return {"alive": alive, "core_size": int(alive.sum())}


def reference_kcore(graph: Graph, k: int = 2) -> np.ndarray:
    """Host numpy peeling oracle with the identical in-degree rule;
    returns the frozen-degree array (values >= k <=> in the k-core).
    ``lux_tpu``'s rounds, each counting the removed vertices' messages
    from their CSR out-edges (work in proportion to the round's
    removals, not to ne)."""
    csr = graph.csr()
    nv = graph.nv
    deg = graph.in_degrees.astype(np.int64).copy()
    frontier = np.flatnonzero(deg < k)
    while frontier.size:
        lo = csr.row_ptr[frontier]
        lens = csr.row_ptr[frontier + 1] - lo
        first = np.cumsum(lens) - lens
        idx = np.arange(int(lens.sum()), dtype=np.int64) \
            + np.repeat(lo - first, lens)
        dec = np.bincount(csr.col_dst[idx], minlength=nv)
        alive = deg >= k
        new = np.where(alive, deg - dec, deg)
        frontier = np.flatnonzero(alive & (new < k))
        deg = new
    return deg.astype(np.uint32)
