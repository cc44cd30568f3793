"""Weighted single-source shortest paths, delta-stepping flavoured (GAS
model), the counterpart of ``lux_tpu/models/sssp_delta.py``.

The monotone chunked Bellman-Ford whose fixpoint equals
delta-stepping's, with the bucket discipline subsumed by the executor's
density-adaptive direction choice. Distances are float32 sums of int
edge weights (1..100 from the generators), so every reachable distance
on the graphs this engine targets is an integer far below 2**24:
float32-exact, which keeps the oracle bitwise-comparable and the
min-combiner order-free. On the card the gather is K10/K11's
``"add_w"`` (f32 min through order-preserving keys; NaN is not
supported).
"""

from __future__ import annotations

import numpy as np
import torch

from lux_tpu_torch.engine.gas import GasProgram
from lux_tpu_torch.graph.graph import Graph


class DeltaSSSP(GasProgram):
    name = "sssp_delta"
    combiner = "min"
    value_dtype = np.float32
    needs_weights = True
    rooted = True
    gather_op = "add_w"

    def init_values(self, graph: Graph, start: int = 0) -> np.ndarray:
        dist = np.full(graph.nv, np.inf, dtype=np.float32)
        dist[start] = 0.0
        return dist

    def init_frontier(self, graph: Graph, start: int = 0) -> np.ndarray:
        fr = np.zeros(graph.nv, dtype=bool)
        fr[start] = True
        return fr

    def gather(self, src_vals, weights):
        return src_vals + weights.to(torch.float32)

    def edge_invariant(self, src_vals, dst_vals, weights):
        return dst_vals <= src_vals + weights.to(torch.float32)


def reference_sssp_delta(graph: Graph, start: int = 0) -> np.ndarray:
    """Host Dijkstra oracle (float32 distances; unreached = +inf): the
    array of ``lux_tpu``'s heapq Dijkstra, computed by
    ``scipy.sparse.csgraph.dijkstra``. Parallel edges collapse to their
    least weight first (scipy would add them). Distances are integer
    sums below 2**24, so the float64 result casts to float32 exactly."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    assert graph.weights is not None
    nv = graph.nv
    w = graph.weights.astype(np.int64)
    if w.size and w.min() < 1:
        # An explicit zero would read as no edge.
        raise ValueError("reference_sssp_delta needs weights >= 1")
    key = graph.col_src.astype(np.int64) * nv + graph.col_dst
    # Sort by (source, destination, weight): one int64 sort when the three
    # pack into 63 bits, as they do at R-MAT scale 22.
    bits = max(int(w.max(initial=0)).bit_length(), 1)
    if (max(nv, 1) ** 2) << bits < 2**63:
        packed = np.sort((key << bits) | w)
        key, w = packed >> bits, packed & ((1 << bits) - 1)
    else:
        order = np.lexsort((w, key))
        key, w = key[order], w[order]
    first = np.ones(key.shape[0], dtype=bool)
    first[1:] = key[1:] != key[:-1]
    key, w = key[first], w[first]
    src = key // nv
    indptr = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=nv), out=indptr[1:])
    adj = csr_matrix((w.astype(np.float64), key - src * nv, indptr),
                     shape=(nv, nv))
    dist = dijkstra(adj, directed=True, indices=start)
    return dist.astype(np.float32)


def main(argv=None):
    """CLI:

        python -m lux_tpu_torch.models.sssp_delta -file g.lux -start R
    """
    from lux_tpu_torch.models.cli import run_push_app

    return run_push_app(DeltaSSSP(), argv, supports_start=True)


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
