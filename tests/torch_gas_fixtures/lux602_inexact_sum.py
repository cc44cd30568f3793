"""Seeded LUX602 failure, the port's twin of
``tests/gas_fixtures/lux602_inexact_sum.py``: a float32 *sum* posing as
a reorderable combiner.

Float addition is not associative — the probe grid's extremes triples
((max + max) + (-max) vs max + (max + (-max))) diverge deterministically
— so segment_reduce reordering and part-order-independent sharded
accumulation are unlicensed. ``python -m lux_tpu_torch.tools.luxlint
--programs`` over this file must exit 1 with exactly LUX602 (the
identity 0.0 is fine, the trace is direction-consistent, annihilation
holds — only the algebra is broken).
"""

import numpy as np

from lux_tpu_torch.engine.gas import GasProgram


class InexactSum(GasProgram):
    name = "inexact_sum"
    combiner = "sum"
    value_dtype = np.float32
    servable = False
    frontier_ok = False   # honest declaration: the algebra is inexact

    def init_values(self, graph, **kw):
        return (np.arange(graph.nv) % 5).astype(np.float32)

    def init_frontier(self, graph, **kw):
        return np.ones(graph.nv, dtype=bool)

    def gather(self, src_vals, weights):
        return src_vals * 0.5

    def apply(self, old, acc):
        return old + acc
