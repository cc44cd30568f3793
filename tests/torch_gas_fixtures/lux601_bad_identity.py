"""Seeded LUX601 failure, the port's twin of
``tests/gas_fixtures/lux601_bad_identity.py``: a min-combiner declaring
identity 0.

min(x, 0) == 0 collapses every positive value, so the identity-masked
pull and the sentinel-padded frontier exchange would zero live state.
``python -m lux_tpu_torch.tools.luxlint --programs`` over this file must
exit 1 with exactly LUX601 (the failed identity voids the trace-based
proofs, so LUX603/605 stay silent rather than cascading).
"""

import numpy as np

from lux_tpu_torch.engine.gas import GasProgram


class BadIdentityMin(GasProgram):
    name = "bad_identity_min"
    combiner = "min"
    servable = False
    frontier_ok = False   # honest declaration: only the identity is broken

    def combine_identity(self, dtype):
        return np.zeros((), dtype=dtype)[()]

    def init_values(self, graph, **kw):
        return (np.arange(graph.nv) % 7).astype(np.uint32)

    def init_frontier(self, graph, **kw):
        return np.ones(graph.nv, dtype=bool)

    def gather(self, src_vals, weights):
        return src_vals
