"""Port parity: the multi-process mesh (``parallel/multihost.py`` and
``parallel/mesh.py::DistMesh``) against ``LocalMesh`` and lux_tpu.

``ordered_ranks`` and the card check are pure functions, tested as
``tests/test_multihost.py`` tests ``ordered_devices``. The rest runs in
spawned CPU processes over ``gloo`` (``tests/torch_multihost_worker.py``,
each process with its own ``communicate(timeout=...)``):

- every collective of a ``DistMesh`` bitwise against ``LocalMesh``'s,
  for W in {1, 2, 4} ranks, P in {4, 8}, bool, int32, int64 and float32
  (the float reduce-scatter included), and ``make_global_mesh``'s
  refusals;
- the six sharded executors over 2 and 4 ranks (P = 4; ``torchrun``'s
  environment and a bare ``initialize()``): what every rank gathers is
  bitwise the port's one-device ``LocalMesh`` run, with equal
  iterations, sparse iterations, branch and direction ledgers,
  downgrades and ``exchange_bytes_per_iter``, and equal to ``lux_tpu``'s
  sharded executors on the conftest's 8 virtual CPU devices: integer
  and min/max programs bitwise, PageRank at rtol=5e-5, atol=1e-9, CF at
  rtol=1e-4, atol=1e-7. ``lux_tpu``'s sharded GAS ``run()`` of a
  frontier program fails under its JAX (ROADMAP C), so its GAS runs are
  ``phase_step`` loops.
"""

import os
import pickle
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

from lux_tpu.engine import gas_sharded as jgs
from lux_tpu.engine import pull_sharded as jps
from lux_tpu.engine import push as jpush
from lux_tpu.engine import tiled_sharded as jts
from lux_tpu.graph import generate as jgen
from lux_tpu.models import BFS as JBFS
from lux_tpu.models import PageRank as JPageRank
from lux_tpu.models.colfilter import CollaborativeFiltering as JCF
from lux_tpu.models.components import ConnectedComponents as JCC
from lux_tpu.models.sssp import SSSP as JSSSP
from lux_tpu.models.sssp_delta import DeltaSSSP as JDeltaSSSP
from lux_tpu.parallel.mesh import make_mesh as jmake_mesh
from lux_tpu_torch.parallel.mesh import LocalMesh
from lux_tpu_torch.parallel.multihost import (
    RankInfo,
    check_nccl_cards,
    default_backend,
    ordered_ranks,
)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_multihost_worker as worker  # noqa: E402

RANKS = (2, 4)
TIMEOUT_S = 150
TOL = {"pull pagerank": (5e-5, 1e-9), "tiled pagerank": (5e-5, 1e-9),
       "pull colfilter": (1e-4, 1e-7)}
# What each run of tests/torch_multihost_worker.py::executors gives.
KEYS = ("pull pagerank full", "pull pagerank compact", "pull colfilter full",
        "tiled pagerank-g full", "tiled pagerank-cycle compact",
        "push sssp full", "push sssp compact", "push cc full",
        "push_multi sssp compact", "gas bfs frontier",
        "gas sssp_delta frontier", "gas bfs full", "gas_multi bfs compact")


def fake_rank(node, local_rank, rank):
    return types.SimpleNamespace(node=node, local_rank=local_rank, rank=rank)


def test_ordered_ranks_node_major():
    # Shuffled: two nodes x two ranks each, listed out of order. Ranks of
    # one node are neighbours (so are the parts they hold), then by local
    # rank, then by rank.
    ranks = [fake_rank("b", 1, 3), fake_rank("a", 0, 0), fake_rank("b", 0, 2),
             fake_rank("a", 1, 1)]
    got = [(r.node, r.local_rank, r.rank) for r in ordered_ranks(ranks)]
    assert got == [("a", 0, 0), ("a", 1, 1), ("b", 0, 2), ("b", 1, 3)]
    # A launcher that numbers ranks across nodes keeps node-major order.
    ranks = [fake_rank("n1", 0, 0), fake_rank("n0", 0, 1),
             fake_rank("n1", 1, 2), fake_rank("n0", 1, 3)]
    assert [r.rank for r in ordered_ranks(ranks)] == [1, 3, 0, 2]


def test_ordered_ranks_shrink_validation():
    ranks = [fake_rank("a", 0, 0), fake_rank("a", 1, 1),
             fake_rank("b", 0, 2), fake_rank("b", 1, 3)]
    # Every rank keeps a part: fine, at any count of at least W.
    assert len(ordered_ranks(ranks, num_parts=4)) == 4
    assert len(ordered_ranks(ranks, num_parts=8)) == 4
    # Fewer parts than ranks leave the last ranks in order without one.
    with pytest.raises(ValueError, match=r"ranks \[2, 3\]"):
        ordered_ranks(ranks, num_parts=2)


def test_nccl_refuses_two_ranks_on_one_card():
    one_card = [RankInfo("h", 0, 0, "GPU-aa"), RankInfo("h", 1, 1, "GPU-aa")]
    with pytest.raises(ValueError, match="GPU-aa.*gloo"):
        check_nccl_cards(one_card, "nccl")
    # Over gloo they may share it; over nccl each on a card of its own,
    # and the same card name on two hosts is two cards.
    check_nccl_cards(one_card, "gloo")
    check_nccl_cards([RankInfo("h", 0, 0, "GPU-aa"),
                      RankInfo("h", 1, 1, "GPU-bb")], "nccl")
    check_nccl_cards([RankInfo("h0", 0, 0, "cuda:0"),
                      RankInfo("h1", 0, 1, "cuda:0")], "nccl")


def test_default_backend_without_a_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert default_backend(2) == "gloo"


# -- spawned gloo ranks ------------------------------------------------------


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _spawn(world, task, out):
    env = {k: v for k, v in os.environ.items()
           if k not in ("LUX_EXCHANGE", "MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         str(r), str(world), port, str(out), task],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _finish(procs):
    """Each rank's output; a rank that fails or hangs fails the test, and
    no rank outlives it."""
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, lg) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{lg}"
    return logs


@pytest.mark.parametrize("world", [1, 2, 4])
def test_collectives_match_local_mesh(world, tmp_path):
    logs = _finish(_spawn(world, "collectives", tmp_path / "c"))
    assert all("collectives ok" in lg for lg in logs)


def _lux_gas(jg, program, mode, start, monkeypatch):
    """lux_tpu's sharded GAS at P = 4 as a ``phase_step`` loop: (values,
    branches, exchange bytes, frontier cap)."""
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    ex = jgs.ShardedAdaptiveExecutor(jg, program, num_parts=worker.PARTS,
                                     mode="adaptive")
    st = ex.init_state(start=start)
    branches = []
    for _ in range(64):
        st, total, info = ex.phase_step(st)
        branches.append(info["branch"])
        if total == 0:
            break
    return {"values": ex.gather_values(st), "iters": len(branches),
            "branches": branches, "bytes": ex.exchange_bytes_per_iter(),
            "frontier_cap": ex.frontier_cap}


def _lux(monkeypatch) -> dict:
    """lux_tpu's sharded executors at P = 4 on the worker's graphs."""
    G = worker.graphs(jgen)
    mesh = jmake_mesh(worker.PARTS)
    out = {}
    for mode in ("full", "compact"):
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        ex = jps.ShardedPullExecutor(G["g"], JPageRank(), mesh=mesh)
        out[f"pull pagerank {mode}"] = {
            "values": ex.gather_values(ex.run(5)),
            "bytes": ex.exchange_bytes_per_iter()}
    monkeypatch.setenv("LUX_EXCHANGE", "full")
    ex = jps.ShardedPullExecutor(G["gc"], JCF(), mesh=mesh)
    out["pull colfilter full"] = {"values": ex.gather_values(ex.run(3)),
                                  "bytes": ex.exchange_bytes_per_iter()}
    for name, mode in (("g", "full"), ("cycle", "compact")):
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        ex = jts.ShardedTiledExecutor(G[name], JPageRank(), mesh=mesh,
                                      levels=((8, 1),))
        vals = ex.run(5)
        out[f"tiled pagerank-{name} {mode}"] = {
            "values": ex.gather_values(vals),
            "bytes": ex._exchange_bytes_per_iter(vals)}
    for prog, gname, mode in (("sssp", "g", "full"),
                              ("sssp", "g", "compact"),
                              ("cc", "gu", "full")):
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        program = JSSSP() if prog == "sssp" else JCC()
        ex = jpush.ShardedPushExecutor(G[gname], program, mesh=mesh,
                                       queue_frac=4, edge_budget_frac=2)
        st, iters = ex.run(**({"start": 0} if prog == "sssp" else {}))
        out[f"push {prog} {mode}"] = {
            "values": ex.gather_values(st), "iters": iters,
            "sparse": ex.sparse_iters, "bytes": ex.exchange_bytes_per_iter()}
    monkeypatch.setenv("LUX_EXCHANGE", "compact")
    ex = jpush.ShardedMultiSourcePushExecutor(G["g"], JSSSP(), 4, mesh=mesh)
    st, iters = ex.run([0, 3, 17, 40])
    out["push_multi sssp compact"] = {"values": ex.gather_values(st),
                                      "iters": iters,
                                      "bytes": ex.exchange_bytes_per_iter()}
    for prog, mode in (("bfs", "frontier"), ("sssp_delta", "frontier"),
                       ("bfs", "full")):
        out[f"gas {prog} {mode}"] = _lux_gas(
            G["gw"], JBFS() if prog == "bfs" else JDeltaSSSP(), mode,
            1 if prog == "bfs" else 0, monkeypatch)
    monkeypatch.setenv("LUX_EXCHANGE", "compact")
    ex = jgs.ShardedMultiSourceGasExecutor(G["gw"], JBFS(), 4,
                                           num_parts=worker.PARTS)
    st, iters = ex.run([1, 3, 17, 40])
    out["gas_multi bfs compact"] = {"values": ex.gather_values(st),
                                    "iters": iters,
                                    "bytes": ex.exchange_bytes_per_iter()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results for each W, the one-device LocalMesh run,
    lux_tpu's runs): the ranks run while this process computes the
    other two."""
    tmp = tmp_path_factory.mktemp("ranks")
    procs = {w: _spawn(w, "executors", tmp / f"w{w}") for w in RANKS}
    try:
        with pytest.MonkeyPatch.context() as mp:
            local = worker.executors(
                LocalMesh(worker.PARTS, "cpu"),
                lambda m: (mp.delenv("LUX_EXCHANGE", raising=False)
                           if m is None else mp.setenv("LUX_EXCHANGE", m)))
            lux = _lux(mp)
    finally:
        logs = {w: _finish(p) for w, p in procs.items()}
    got = {}
    for w in RANKS:
        got[w] = []
        for r in range(w):
            with open(tmp / f"w{w}.{r}", "rb") as f:
                got[w].append(pickle.load(f))
        assert all("executors ok" in lg for lg in logs[w])
    return got, local, lux


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("world", RANKS)
def test_executor_over_ranks(world, key, runs):
    got, local, lux = runs
    want = local[key]
    parts = [r["parts"] for r in got[world]]
    per = worker.PARTS // world
    assert parts == [list(range(r * per, (r + 1) * per))
                     for r in range(world)]
    # Every rank gathers the one-device run, bitwise, with its ledgers.
    for r, ranks in enumerate(got[world]):
        assert set(ranks[key]) == set(want), (r, key)
        for field, value in want.items():
            assert _same(ranks[key][field], value), (r, key, field)
    # The sparse and push branches ran where the program has them.
    if key.startswith("push ") and "sssp" in key:
        assert 0 < want["sparse"] < want["iters"]
    if key.startswith("gas "):
        assert 0 < want["push"] < want["iters"]
    # And lux_tpu's sharded executor, at its tests' tolerances.
    ref = lux[key]
    assert want["bytes"] == ref["bytes"]
    tol = TOL.get(key.rsplit(" ", 1)[0].split("-")[0])
    if tol is not None:
        np.testing.assert_allclose(want["values"], ref["values"],
                                   rtol=tol[0], atol=tol[1])
        return
    ref_values = np.asarray(ref["values"])
    if ref_values.dtype == np.int32:          # uint32 bits
        ref_values = ref_values.view(np.uint32)
    assert ref_values.dtype == want["values"].dtype
    np.testing.assert_array_equal(want["values"], ref_values)
    assert want["iters"] == ref["iters"]
    if "sparse" in want:
        assert want["sparse"] == ref["sparse"]
    if "branches" in ref:
        assert [e[3] for e in want["log"]] == ref["branches"]
        assert want["down"] == ref["branches"].count("pull/downgraded")
        assert want["push"] == ref["branches"].count("push")
        assert want["frontier_cap"] == ref["frontier_cap"]
