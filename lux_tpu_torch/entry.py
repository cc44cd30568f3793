"""Entry points, mirroring the JAX package's ``__graft_entry__``.

- ``entry()``: an R-MAT graph of scale 10 and edge factor 8, a
  :class:`TiledPullExecutor` with PageRank, and ``(step_fn,
  example_args)`` where ``step_fn(*example_args)`` runs one iteration in
  internal vertex order.
- ``dryrun_multichip(n)``: the sharded pull, tiled, push and GAS
  engines over ``n`` parts of a
  :class:`~lux_tpu_torch.parallel.mesh.LocalMesh` (one device), checked
  against their oracles.
"""

from __future__ import annotations

import numpy as np

from lux_tpu_torch.engine.gas_sharded import ShardedAdaptiveExecutor
from lux_tpu_torch.engine.program import VertexCtx
from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor
from lux_tpu_torch.engine.tiled import TiledPullExecutor
from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor
from lux_tpu_torch.graph import generate
from lux_tpu_torch.models import BFS, SSSP, ConnectedComponents, PageRank
from lux_tpu_torch.models.bfs import reference_bfs
from lux_tpu_torch.models.components import reference_components
from lux_tpu_torch.models.pagerank import reference_pagerank
from lux_tpu_torch.models.sssp import reference_sssp
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
    """Run the sharded pull, tiled and push engines over ``n_devices``
    parts on one device (``cuda`` unless ``device`` names another), in
    the exchange mode ``LUX_EXCHANGE`` resolves to, on a small R-MAT: two
    pull PageRank steps and two tiled (strip/lane-select) PageRank steps,
    each held to the f64 oracle at ``__graft_entry__``'s rtol=2e-4; then,
    on its undirected closure, push CC to fixpoint and
    push SSSP from vertex 0 with ``__graft_entry__``'s small sparse
    budgets (so the queue branch runs too), each bitwise against its
    oracle; and adaptive BFS from vertex 0 on the closure through the
    sharded GAS engine with half ``lux_tpu``'s edge budget, bitwise
    against ``reference_bfs``, taking both directions."""
    mesh = make_mesh(n_devices, device)
    g = generate.rmat(10, 8, seed=0)
    pull = ShardedPullExecutor(g, PageRank(), mesh=mesh)
    want = reference_pagerank(g, 2)
    got = pull.gather_values(pull.run(2))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    tiled = ShardedTiledExecutor(g, PageRank(), mesh=mesh)
    got = tiled.gather_values(tiled.run(2))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    gsym = generate.undirected(g)
    cc = ShardedPushExecutor(gsym, ConnectedComponents(), mesh=mesh)
    state, _ = cc.run()
    np.testing.assert_array_equal(cc.gather_values(state),
                                  reference_components(gsym))
    sssp = ShardedPushExecutor(gsym, SSSP(), mesh=mesh, queue_frac=4,
                               edge_budget_frac=2)
    state, _ = sssp.run(start=0)
    if sssp.sparse_iters == 0:
        raise AssertionError("the sparse branch did not run")
    np.testing.assert_array_equal(sssp.gather_values(state),
                                  reference_sssp(gsym, 0))
    # Half lux_tpu's edge budget fits the hub's 1,062 out-edges, so the
    # first iteration pushes.
    bfs = ShardedAdaptiveExecutor(gsym, BFS(), mesh=mesh,
                                  edge_budget_frac=2)
    state, _ = bfs.run(start=0)
    if bfs.push_iters == 0 or bfs.pull_iters == 0:
        raise AssertionError(f"sharded BFS took one direction only: "
                             f"{bfs.push_iters} push, {bfs.pull_iters} pull")
    np.testing.assert_array_equal(bfs.gather_values(state),
                                  reference_bfs(gsym, 0)[0])
    print(f"dryrun_multichip({n_devices}): sharded pull and tiled PageRank, "
          f"push CC and SSSP (dense and sparse) and adaptive GAS BFS "
          f"({bfs.push_iters} push, {bfs.pull_iters} pull) steps executed "
          f"OK on {mesh} (exchange {pull.exchange_mode}; tiled exchange "
          f"{tiled.exchange_mode}; GAS exchange {bfs.exchange_mode}, "
          f"{bfs.exchange_downgrades} downgrades)")
