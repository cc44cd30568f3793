"""Entry points, mirroring the JAX package's ``__graft_entry__``.

- ``entry()``: an R-MAT graph of scale 10 and edge factor 8, a
  :class:`TiledPullExecutor` with PageRank, and ``(step_fn,
  example_args)`` where ``step_fn(*example_args)`` runs one iteration in
  internal vertex order.
- ``dryrun_multichip(n)``: the sharded pull engine over ``n`` parts of a
  :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` (one device), checked
  against the f64 oracle.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.engine.program import VertexCtx
from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
from lux_tpu_torch.engine.tiled import TiledPullExecutor
from lux_tpu_torch.graph import generate
from lux_tpu_torch.models import PageRank
from lux_tpu_torch.models.pagerank import reference_pagerank
from lux_tpu_torch.ops.tiled_spmv import hybrid_spmv
from lux_tpu_torch.parallel.mesh import make_mesh


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


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the sharded pull PageRank iteration over ``n_devices`` parts
    on one device (``cuda`` unless ``device`` names another): two steps
    on a small R-MAT, in the exchange mode ``LUX_EXCHANGE`` resolves to,
    held to the f64 oracle at ``__graft_entry__``'s rtol=2e-4. The push
    engine's sharded step is not ported yet; it joins this with the
    sharded push executors."""
    mesh = make_mesh(n_devices, device)
    g = generate.rmat(10, 8, seed=0)
    pull = ShardedPullExecutor(g, PageRank(), mesh=mesh)
    got = pull.gather_values(pull.run(2))
    np.testing.assert_allclose(got, reference_pagerank(g, 2), rtol=2e-4)
    print(f"dryrun_multichip({n_devices}): sharded pull PageRank steps "
          f"executed OK on {mesh} (exchange {pull.exchange_mode}); the "
          "sharded push step joins it with the sharded push executors")
