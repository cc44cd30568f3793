"""Driver entry point: one PageRank step of the tiled pull executor.

``entry()`` mirrors the JAX package's ``__graft_entry__.entry()``: an
R-MAT graph of scale 10 and edge factor 8, a :class:`TiledPullExecutor`
with PageRank, and ``(step_fn, example_args)`` where
``step_fn(*example_args)`` runs one iteration in internal vertex order.
"""

from __future__ import annotations

from lux_tpu_torch.engine.program import VertexCtx
from lux_tpu_torch.engine.tiled import TiledPullExecutor
from lux_tpu_torch.graph import generate
from lux_tpu_torch.models import PageRank
from lux_tpu_torch.ops.tiled_spmv import hybrid_spmv


def entry(device=None):
    g = generate.rmat(10, 8, seed=0)
    ex = TiledPullExecutor(g, PageRank(), device=device)

    def forward(vals, dhybrid, out_degrees, in_degrees, gtail=None):
        acc = hybrid_spmv(vals, dhybrid, gtail)
        ctx = VertexCtx(nv=g.nv, out_degrees=out_degrees,
                        in_degrees=in_degrees)
        return ex.program.apply(vals, acc, ctx)

    example_args = (ex._init_internal(), ex.dhybrid, ex.out_degrees,
                    ex.in_degrees, ex.gtail)
    return forward, example_args
