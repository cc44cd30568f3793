"""Seeded LUX606 failure, the port's twin of
``tests/gas_fixtures/lux606_overclaimed_frontier.py``: capability drift
between declaration and proof.

A frontier-less dense-pull program (``frontier = False``) declares
``frontier_ok = True`` — but with no frontier machinery there is no
annihilation/duality proof to license, so the derived matrix says
False and the declaration is an over-claim. ``python -m
lux_tpu_torch.tools.luxlint --programs`` over this file must exit 1 with
exactly LUX606 (no algebra rule fires: the frontier proofs are n/a for
a dense program, which is the point).
"""

import numpy as np

from lux_tpu_torch.engine.gas import GasProgram


class OverclaimedDense(GasProgram):
    name = "overclaimed_dense"
    combiner = "sum"
    value_dtype = np.float32
    servable = False
    frontier = False
    frontier_ok = True    # the drift LUX606 must catch

    def init_values(self, graph, **kw):
        return np.zeros(graph.nv, dtype=np.float32)

    def init_frontier(self, graph, **kw):
        return np.ones(graph.nv, dtype=bool)
