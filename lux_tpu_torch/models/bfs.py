"""Breadth-first search with parent derivation (GAS model), the
counterpart of ``lux_tpu/models/bfs.py``.

Depths are the SSSP hop-count fixpoint (the same monotone
min-relaxation, ``sssp_gpu.cu:48-61``), run by the direction-adaptive
GAS executor: the frontier starts as one vertex, grows to a large share
of the graph and collapses again. The parent array is derived on the
host after convergence with a deterministic tie-break (the minimum-id
predecessor on a shortest path), so it is the same across directions
and engines. On the card the gather is K10/K11's ``"add1"``.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.engine.gas import GasProgram
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.models.sssp import reference_sssp
from lux_tpu_torch.ops.segment import U32_MASK


class BFS(GasProgram):
    name = "bfs"
    combiner = "min"
    value_dtype = np.uint32
    rooted = True
    gather_op = "add1"

    def init_values(self, graph: Graph, start: int = 0) -> np.ndarray:
        depth = np.full(graph.nv, graph.nv, dtype=np.uint32)  # inf == nv
        depth[start] = 0
        return depth

    def init_frontier(self, graph: Graph, start: int = 0) -> np.ndarray:
        fr = np.zeros(graph.nv, dtype=bool)
        fr[start] = True
        return fr

    def gather(self, src_vals, weights):
        return (src_vals + 1) & U32_MASK

    def edge_invariant(self, src_vals, dst_vals, weights):
        return dst_vals <= ((src_vals + 1) & U32_MASK)

    def finalize_host(self, graph: Graph, values: np.ndarray) -> dict:
        return {"parent": bfs_parents(graph, values)}


def bfs_parents(graph: Graph, depth: np.ndarray) -> np.ndarray:
    """Minimum-id shortest-path predecessor per reached vertex, from the
    converged depth array (the root parents itself; unreached vertices
    get nv); uint32. ``lux_tpu``'s ``bfs_parents``, with its
    ``np.minimum.at`` over the CSC edges replaced by one
    ``np.minimum.reduceat`` over the CSC rows."""
    nv = graph.nv
    d = depth.astype(np.int64)
    src = graph.col_src.astype(np.int64)
    # Edge (u -> v) is a tree-edge candidate iff depth[u] + 1 == depth[v].
    cand = np.where(d[src] + 1 == d[graph.col_dst], src, nv)
    parent = np.full(nv, nv, dtype=np.int64)
    rows = np.flatnonzero(graph.in_degrees > 0)
    if rows.size:
        parent[rows] = np.minimum.reduceat(cand, graph.row_ptr[rows])
    parent[d == 0] = np.flatnonzero(d == 0)   # the root parents itself
    parent[d >= nv] = nv                      # unreached
    return parent.astype(np.uint32)


def reference_bfs(graph: Graph, start: int = 0):
    """Host oracle: (depth, parent) with the same deterministic
    minimum-id tie-break."""
    depth = reference_sssp(graph, start)
    return depth, bfs_parents(graph, depth)


def main(argv=None):
    """CLI:

        python -m lux_tpu_torch.models.bfs -file g.lux -start R
    """
    from lux_tpu_torch.models.cli import run_push_app

    return run_push_app(BFS(), argv, supports_start=True)


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
