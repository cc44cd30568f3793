"""Seeded LUX605 failure, the port's twin of
``tests/gas_fixtures/lux605_clobbering_apply.py``: an ``apply`` that
clobbers state with the accumulator.

``apply(old, acc) = acc`` means a vertex that received no messages —
whose accumulator slot still holds the combiner identity — gets the
identity written over its live value. The scalar identity is a perfect
annihilator (LUX601 passes), but at the *program* level an
identity-only accumulator mutates state, so the frontier machinery
(which skips exactly those vertices) would diverge from the dense
sweep. ``python -m lux_tpu_torch.tools.luxlint --programs`` over this
file must exit 1 with exactly LUX605.
"""

import numpy as np

from lux_tpu_torch.engine.gas import GasProgram


class ClobberingApply(GasProgram):
    name = "clobbering_apply"
    combiner = "min"
    servable = False
    frontier_ok = False   # honest declaration: annihilation is broken

    def init_values(self, graph, **kw):
        return (np.arange(graph.nv) % 7).astype(np.uint32)

    def init_frontier(self, graph, **kw):
        return np.ones(graph.nv, dtype=bool)

    def gather(self, src_vals, weights):
        return src_vals

    def apply(self, old, acc):
        return acc
