"""Single-source shortest paths (push model, unit weights), the
counterpart of ``lux_tpu/models/sssp.py``.

The reference SSSP is Bellman-Ford over *hop counts*: its push edge struct
carries no weight (sssp/app.h:31) and relaxation is
``min(dist[dst], dist[src] + 1)`` (sssp/sssp_gpu.cu:48-61,86-130). Init:
``dist = nv`` everywhere ("infinity", sssp_gpu.cu:733-744), ``dist[start]
= 0``, frontier = {start}. Checker: ``dist[dst] <= dist[src] + 1`` per
edge (sssp_gpu.cu:794).
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.engine.push import PushProgram
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.ops.segment import U32_MASK


class SSSP(PushProgram):
    name = "sssp"
    combiner = "min"
    value_dtype = np.uint32
    rooted = True
    packable_values = True     # distances <= nv < 2^31
    incremental_ok = True      # monotone min-merge
    relax_op = "add1"

    def init_values(self, graph: Graph, start: int = 0) -> np.ndarray:
        dist = np.full(graph.nv, graph.nv, dtype=np.uint32)  # inf == nv
        dist[start] = 0
        return dist

    def init_frontier(self, graph: Graph, start: int = 0) -> np.ndarray:
        fr = np.zeros(graph.nv, dtype=bool)
        fr[start] = True
        return fr

    def relax(self, src_vals, weights):
        return (src_vals + 1) & U32_MASK

    def edge_invariant(self, src_vals, dst_vals, weights):
        return dst_vals <= ((src_vals + 1) & U32_MASK)


def reference_sssp(graph: Graph, start: int = 0) -> np.ndarray:
    """Host BFS oracle (hop counts; unreached = nv, like the reference):
    the array of ``lux_tpu``'s ``reference_sssp``, computed one level at
    a time with numpy over the CSR."""
    csr = graph.csr()
    dist = np.full(graph.nv, graph.nv, dtype=np.uint32)
    dist[start] = 0
    frontier = np.array([start], dtype=np.int64)
    d = 0
    while frontier.size:
        d += 1
        lo = csr.row_ptr[frontier]
        lens = csr.row_ptr[frontier + 1] - lo
        total = int(lens.sum())
        first = np.cumsum(lens) - lens
        idx = np.arange(total, dtype=np.int64) + np.repeat(lo - first, lens)
        nbr = np.unique(csr.col_dst[idx])
        frontier = nbr[dist[nbr] > d].astype(np.int64)
        dist[frontier] = d
    return dist


def main(argv=None):
    """CLI:

        python -m lux_tpu_torch.models.sssp -file g.lux -start R [-check]
    """
    from lux_tpu_torch.models.cli import run_push_app

    return run_push_app(SSSP(), argv, supports_start=True)


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
