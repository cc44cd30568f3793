"""Seeded LUX604 failure, the port's twin of
``tests/gas_fixtures/lux604_nonmonotone_incremental.py``:
``incremental_ok = True`` without the monotone-convergence proof.

The relax hook emits src - 1.0: messages move *against* the min order
(gather is not inflationary), so a warm start from stale values is not
guaranteed to re-reach the fixpoint — exactly the property
engine/incremental.py's warm-started refresh depends on. ``python -m
lux_tpu_torch.tools.luxlint --programs`` over this file must exit 1 with
exactly LUX604 (every frontier proof — identity, algebra, duality,
annihilation — holds, so ``frontier_ok`` stays honestly True; only the
incremental claim is refuted).
"""

import numpy as np

from lux_tpu_torch.engine.push import PushProgram


class DriftingMin(PushProgram):
    name = "drifting_min"
    combiner = "min"
    value_dtype = np.float32
    servable = False
    incremental_ok = True   # the over-claim LUX604 must refute

    def init_values(self, graph, **kw):
        return (np.arange(graph.nv) % 5).astype(np.float32)

    def init_frontier(self, graph, **kw):
        return np.ones(graph.nv, dtype=bool)

    def relax(self, src_vals, weights):
        return src_vals - 1.0
