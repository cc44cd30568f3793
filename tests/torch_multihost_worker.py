"""One rank of ``tests/test_torch_multihost.py``'s gloo runs on the CPU.

    python tests/torch_multihost_worker.py RANK WORLD PORT OUT TASK

``TASK`` is ``collectives`` (each :class:`DistMesh` collective held
bitwise against :class:`LocalMesh`'s, in the worker) or ``executors``
(the six sharded executors over a :class:`DistMesh` of 4 parts; every
rank pickles what it got to ``OUT.<rank>`` for the test to hold against
the one-device runs and ``lux_tpu``). Imports neither JAX nor
``lux_tpu``.
"""

from __future__ import annotations

import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lux_tpu_torch.parallel.mesh import (  # noqa: E402
    DistMesh,
    LocalMesh,
    gather_rows,
)
from lux_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize,
    make_global_mesh,
)

CPU = "cpu"
PARTS = 4
DTYPES = (torch.bool, torch.int32, torch.int64, torch.float32)


def graphs(gen):
    """The executors' graphs, made by a ``generate`` module of either
    package (the test makes ``lux_tpu``'s twins)."""
    gw = gen.rmat(8, 8, seed=5, weighted=True)
    return {
        "gw": gw,
        "g": gen.rmat(8, 8, seed=5),
        "gu": gen.undirected(gen.rmat(8, 8, seed=5)),
        "gc": gen.bipartite_ratings(200, 30, 2000, seed=3),
        "cycle": gen.undirected(gen.cycle_graph(20000)),
    }


def _stack(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) < 0.5
    if dtype == torch.float32:
        return torch.randn(shape, generator=g)
    return torch.randint(-2**30, 2**30, shape, generator=g, dtype=dtype)


def _equal(name, got, want):
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: not bitwise equal")


def collectives(world: int) -> None:
    """Every collective of a DistMesh against LocalMesh's over the same
    stack, for P in {4, 8}, each dtype, with and without a trailing
    axis, in rank order and in reversed order."""
    orders = [None] + ([tuple(reversed(range(world)))] if world > 1 else [])
    for P in (4, 8):
        local = LocalMesh(P, CPU)
        for order in orders:
            mesh = (make_global_mesh(P, device=CPU) if order is None
                    else DistMesh(P, CPU, order=order))
            lo, hi = mesh.local_parts.start, mesh.local_parts.stop
            for i, dtype in enumerate(DTYPES):
                for tail in ((), (3,)):
                    seed = 100 * P + 10 * i + len(tail)
                    tag = f"P={P} order={order} {dtype} tail={tail}"
                    full = _stack((P, 5) + tail, dtype, seed)
                    _equal(f"all_gather {tag}", mesh.all_gather(full[lo:hi]),
                           local.all_gather(full))
                    blocks = _stack((P, P * 3) + tail, dtype, seed + 1)
                    _equal(f"all_to_all {tag}",
                           mesh.all_to_all(blocks[lo:hi]),
                           local.all_to_all(blocks)[lo:hi])
                    _equal(f"reduce_scatter {tag}",
                           mesh.reduce_scatter(blocks[lo:hi]),
                           local.reduce_scatter(blocks)[lo:hi])
            rows = _stack((P, 3), torch.int64, P)
            _equal(f"gather_rows P={P} order={order}",
                   gather_rows(mesh, rows[lo:hi]), rows)
    if world > 1:
        # A part count the ranks do not divide, and one that leaves a
        # rank without a part.
        for parts, what in ((world + 1, "does not split"),
                            (world - 1, "without a part")):
            try:
                make_global_mesh(parts, device=CPU)
            except ValueError as e:
                if what not in str(e):
                    raise
            else:
                raise AssertionError(f"make_global_mesh({parts}) over "
                                     f"{world} ranks did not refuse")
    print("collectives ok", flush=True)


def _gas_run(ex, **kw):
    st, iters = ex.run(**kw)
    return {"values": ex.gather_values(st), "iters": iters,
            "log": [e[:4] for e in ex.direction_log],
            "push": ex.push_iters, "pull": ex.pull_iters,
            "down": ex.exchange_downgrades,
            "bytes": ex.exchange_bytes_per_iter()}


def executors(mesh, exchange) -> dict:
    """Every sharded executor over ``mesh``: what each run gives, keyed
    by ``<executor> <program> <mode>``. ``exchange(mode)`` sets
    ``LUX_EXCHANGE``."""
    from lux_tpu_torch.engine.gas_sharded import (
        ShardedAdaptiveExecutor,
        ShardedMultiSourceGasExecutor,
    )
    from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
    from lux_tpu_torch.engine.push_sharded import (
        ShardedMultiSourcePushExecutor,
        ShardedPushExecutor,
    )
    from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models import (
        BFS,
        SSSP,
        CollaborativeFiltering,
        ConnectedComponents,
        DeltaSSSP,
        PageRank,
    )

    G = graphs(generate)
    out = {}
    for mode in ("full", "compact"):
        exchange(mode)
        ex = ShardedPullExecutor(G["g"], PageRank(), mesh=mesh)
        out[f"pull pagerank {mode}"] = {
            "values": ex.gather_values(ex.run(5)),
            "bytes": ex.exchange_bytes_per_iter(), "mode": ex.exchange_mode}
    exchange("full")
    ex = ShardedPullExecutor(G["gc"], CollaborativeFiltering(),
                             mesh=mesh)
    out["pull colfilter full"] = {"values": ex.gather_values(ex.run(3)),
                                  "bytes": ex.exchange_bytes_per_iter()}
    for name, mode in (("g", "full"), ("cycle", "compact")):
        exchange(mode)
        ex = ShardedTiledExecutor(G[name], PageRank(), mesh=mesh,
                                  levels=((8, 1),))
        out[f"tiled pagerank-{name} {mode}"] = {
            "values": ex.gather_values(ex.run(5)),
            "bytes": ex.exchange_bytes_per_iter(), "mode": ex.exchange_mode}
    for prog, gname, mode in (("sssp", "g", "full"),
                              ("sssp", "g", "compact"),
                              ("cc", "gu", "full")):
        exchange(mode)
        program = SSSP() if prog == "sssp" else ConnectedComponents()
        ex = ShardedPushExecutor(G[gname], program, mesh=mesh,
                                 queue_frac=4, edge_budget_frac=2)
        st, iters = ex.run(**({"start": 0} if prog == "sssp" else {}))
        out[f"push {prog} {mode}"] = {
            "values": ex.gather_values(st), "iters": iters,
            "sparse": ex.sparse_iters, "log": ex.branch_log,
            "bytes": ex.exchange_bytes_per_iter(), "mode": ex.exchange_mode}
    exchange("compact")
    ex = ShardedMultiSourcePushExecutor(G["g"], SSSP(), 4, mesh=mesh)
    st, iters = ex.run([0, 3, 17, 40])
    out["push_multi sssp compact"] = {"values": ex.gather_values(st),
                                      "iters": iters,
                                      "bytes": ex.exchange_bytes_per_iter()}
    for prog, mode in (("bfs", "frontier"), ("sssp_delta", "frontier"),
                       ("bfs", "full")):
        exchange(mode)
        program = BFS() if prog == "bfs" else DeltaSSSP()
        ex = ShardedAdaptiveExecutor(G["gw"], program, mesh=mesh,
                                     mode="adaptive")
        out[f"gas {prog} {mode}"] = dict(
            _gas_run(ex, start=1 if prog == "bfs" else 0),
            frontier_cap=ex.frontier_cap, mode=ex.exchange_mode)
    exchange("compact")
    ex = ShardedMultiSourceGasExecutor(G["gw"], BFS(), 4, mesh=mesh)
    st, iters = ex.run([1, 3, 17, 40])
    out["gas_multi bfs compact"] = {"values": ex.gather_values(st),
                                    "iters": iters,
                                    "bytes": ex.exchange_bytes_per_iter()}
    exchange(None)
    return out


def _exchange(mode):
    if mode is None:
        os.environ.pop("LUX_EXCHANGE", None)
    else:
        os.environ["LUX_EXCHANGE"] = mode


def main(argv) -> int:
    rank, world, port, out, task = argv
    rank, world = int(rank), int(world)
    if task == "collectives":
        initialize(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                   world_size=world, rank=rank)
        collectives(world)
    else:
        # As torchrun starts a rank: a bare call reads the environment;
        # a second call is a no-op.
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                          RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        initialize()
        initialize()
        if torch.distributed.get_backend() != "gloo":
            raise AssertionError("a CPU rank's default backend is gloo")
        mesh = make_global_mesh(PARTS, device=CPU)
        got = executors(mesh, _exchange)
        got["parts"] = list(mesh.local_parts)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(got, f)
        print(f"executors ok on parts {list(mesh.local_parts)}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
