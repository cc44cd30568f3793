"""Seeded LUX603 failure, the port's twin of
``tests/gas_fixtures/lux603_push_pull_skew.py``: a ``gather_push``
specialization that drifts from the pull-direction edge function.

Pull relaxes src+1, push relaxes src+2 — the two directions' dense
accumulators diverge on the first frontier edge, so direction-adaptive
execution (a mid-run push<->pull switch) would change answers.
``python -m lux_tpu_torch.tools.luxlint --programs`` over this file must
exit 1 with exactly LUX603 (identity, algebra, annihilation, and
monotonicity all hold; only the duality is broken).
"""

import numpy as np

from lux_tpu_torch.engine.gas import GasProgram
from lux_tpu_torch.ops.segment import U32_MASK


class SkewedDirections(GasProgram):
    name = "push_pull_skew"
    combiner = "min"
    servable = False
    frontier_ok = False   # honest declaration: the directions disagree

    def init_values(self, graph, **kw):
        return (np.arange(graph.nv) % 7).astype(np.uint32)

    def init_frontier(self, graph, **kw):
        return np.ones(graph.nv, dtype=bool)

    def gather(self, src_vals, weights):
        return (src_vals + 1) & U32_MASK

    def gather_push(self, src_vals, weights):
        return (src_vals + 2) & U32_MASK
