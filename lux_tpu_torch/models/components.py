"""Connected components via label propagation (push model), the
counterpart of ``lux_tpu/models/components.py``.

The reference propagates the **maximum** vertex id along directed edges
(atomicMax, components/components_gpu.cu:59,77,122), initial label = own
vertex id (components_gpu.cu:739), initial frontier = every vertex
(components_gpu.cu:734-737). On a symmetrized graph the fixpoint labels
each component with its largest member id. Checker:
``label[dst] >= label[src]`` per edge (components_gpu.cu:788).
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.engine.push import PushProgram
from lux_tpu_torch.graph.graph import Graph


class ConnectedComponents(PushProgram):
    name = "components"
    combiner = "max"
    value_dtype = np.uint32
    packable_values = True     # labels < nv < 2^31
    incremental_ok = True      # monotone max-merge
    relax_op = "copy"

    def init_values(self, graph: Graph, **kw) -> np.ndarray:
        return np.arange(graph.nv, dtype=np.uint32)

    def init_frontier(self, graph: Graph, **kw) -> np.ndarray:
        return np.ones(graph.nv, dtype=bool)

    def relax(self, src_vals, weights):
        return src_vals

    def edge_invariant(self, src_vals, dst_vals, weights):
        return dst_vals >= src_vals


def reference_components(graph: Graph) -> np.ndarray:
    """Oracle: label = max vertex id of the component, edges treated as
    undirected (the array of ``lux_tpu``'s union-find
    ``reference_components``). scipy labels the components; a stable
    sort by label puts each component's largest id last."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    nv = graph.nv
    adj = csr_matrix(
        (np.ones(graph.ne, dtype=np.int8), graph.col_src, graph.row_ptr),
        shape=(nv, nv),
    )
    ncomp, labels = connected_components(adj, directed=False)
    order = np.argsort(labels, kind="stable")
    last = np.cumsum(np.bincount(labels, minlength=ncomp)) - 1
    return order[last][labels].astype(np.uint32)


def main(argv=None):
    """CLI:

        python -m lux_tpu_torch.models.components -file g.lux [-check]
    """
    from lux_tpu_torch.models.cli import run_push_app

    return run_push_app(ConnectedComponents(), argv, supports_start=False)


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
