"""Port parity: multi-part serving (``serve/mesh.py`` and the sharded
routes of ``Session``).

The counterparts of tests/test_serve_mesh.py, held against the port's
single-part session (``lux_tpu``'s sharded GAS ``run()`` fails under
JAX 0.9, ROADMAP C): mesh-spec parsing and refusals; the shard-plan
cache (one build per fingerprint, identity rebuilds, eviction, the LRU
bound); a 4-part session bitwise equal to the single-part one on every
app (PageRank within rtol=5e-5, atol=1e-9), with mesh keys; sharded
lanes; zero recompiles on the warm path; a hot swap of the engine mesh
under load; the pool building once under concurrent gets. The parts are
those of a ``LocalMesh`` on the CPU.
"""

import threading

import numpy as np
import pytest

from lux_tpu_torch.graph import DeltaGraph, EdgeEdits, generate
from lux_tpu_torch.models.sssp import SSSP, reference_sssp
from lux_tpu_torch.obs import metrics
from lux_tpu_torch.parallel.mesh import LocalMesh
from lux_tpu_torch.serve import ServeConfig, Session
from lux_tpu_torch.serve.mesh import (MeshSpec, ShardPlanCache,
                                      parse_mesh_spec, serving_mesh)
from lux_tpu_torch.serve.pool import NOT_PORTED, EnginePool


def _cfg(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("window_s", 0.25)
    kw.setdefault("max_queue", 64)
    kw.setdefault("pagerank_iters", 4)
    return ServeConfig(**kw)


def _edits(g, seed, n):
    rng = np.random.default_rng(seed)
    ins = [(int(rng.integers(g.nv)), int(rng.integers(g.nv)))
           for _ in range(n)]
    eidx = rng.choice(g.ne, size=n, replace=False)
    dels = [(int(g.col_src[e]), int(g.col_dst[e])) for e in eidx]
    return EdgeEdits.from_lists(insert=ins, delete=dels)


# -- mesh spec parsing / resolution -------------------------------------


def test_parse_mesh_spec():
    assert parse_mesh_spec("8") == (8,)
    assert parse_mesh_spec("2x4") == (2, 4)
    assert parse_mesh_spec("1") == (1,)
    assert parse_mesh_spec(" 4 x 2 ") == (4, 2)
    assert parse_mesh_spec(4) == (4,)


@pytest.mark.parametrize("bad", ["", "0", "2x0", "-4", "axb", "2x", None])
def test_parse_mesh_spec_rejects(bad):
    with pytest.raises(ValueError):
        parse_mesh_spec(bad)


def test_serving_mesh_resolves_flag(monkeypatch):
    monkeypatch.setenv("LUX_SERVE_MESH", "2x2")
    ms = serving_mesh(device="cpu")
    assert isinstance(ms, MeshSpec)
    assert ms.shape == (2, 2) and ms.num_parts == 4
    assert isinstance(ms.mesh, LocalMesh) and ms.mesh.num_parts == 4
    assert ms.mesh.device.type == "cpu"


def test_serving_mesh_single_part_has_no_mesh():
    ms = serving_mesh("1")
    assert ms.num_parts == 1 and ms.mesh is None


def test_serving_mesh_needs_a_card_or_the_cpu_asked_for(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_mesh("4")


# -- partition-plan cache ------------------------------------------------


def test_plan_cache_shares_one_build_per_fingerprint():
    metrics.reset()
    g = generate.gnp(200, 1200, seed=7)
    pc = ShardPlanCache()
    a = pc.get("fp0", g, 4)
    b = pc.get("fp0", g, 4)
    assert a is b and len(pc) == 1
    c = pc.get("fp0", g, 2)
    assert c is not a and len(pc) == 2
    st = pc.stats()
    assert st["hits"] == 1 and st["misses"] == 2


def test_plan_cache_rebuilds_on_graph_identity_change():
    g1 = generate.gnp(200, 1200, seed=7)
    g2 = generate.gnp(200, 1200, seed=7)
    pc = ShardPlanCache()
    a = pc.get("fp0", g1, 4)
    b = pc.get("fp0", g2, 4)
    assert b is not a and b.graph is g2


def test_plan_cache_evict_fingerprint():
    g = generate.gnp(150, 800, seed=8)
    pc = ShardPlanCache()
    pc.get("old", g, 2)
    pc.get("old", g, 4)
    pc.get("new", g, 2)
    assert pc.evict_fingerprint("old") == 2
    assert len(pc) == 1
    assert pc.evict_fingerprint("gone") == 0


def test_plan_cache_lru_bound(monkeypatch):
    metrics.reset()
    monkeypatch.setenv("LUX_SHARD_PLAN_CACHE", "2")
    g = generate.gnp(150, 800, seed=8)
    pc = ShardPlanCache()
    pc.get("a", g, 2)
    pc.get("b", g, 2)
    pc.get("c", g, 2)
    assert len(pc) == 2
    assert pc.stats()["evicted"] == 1


# -- a 4-part session against the single-part one -------------------------


@pytest.fixture(scope="module", params=[False, True],
                ids=["unweighted", "weighted"])
def pair(request):
    metrics.reset()
    g = generate.rmat(10, 16, seed=42, weighted=request.param)
    with Session(g, _cfg(mesh="1"), device="cpu") as s1, \
            Session(g, _cfg(mesh="2x2"), device="cpu") as s4:
        yield g, s1, s4


# The direction split is each engine's own (the sharded one decides from
# its parts' counters); the answer is not.
DIRECTIONS = ("direction_push", "direction_pull", "direction_switches")


def _same(got, want):
    assert set(got) == set(want)
    assert got["values"].dtype == want["values"].dtype
    for k in set(want) - set(DIRECTIONS):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_sharded_session_serves_the_same_apps(pair):
    _, s1, s4 = pair
    assert s4.meshspec.num_parts == 4 and s4.sharded
    assert s4.APPS == s1.APPS
    # Every pool key carries its session's mesh shape; sharded keys the
    # exchange mode too.
    assert all(k[-1] == (2, 2) and k[-2] == "full" for k in s4.pool.keys())
    assert all(k[-1] == (1,) for k in s1.pool.keys())
    assert s4.stats()["mesh"]["fallbacks"] == {}


@pytest.mark.parametrize("app", ["sssp", "bfs", "sssp_delta"])
def test_sharded_rooted_apps_equal_single_part(pair, app):
    g, s1, s4 = pair
    if app not in s1.APPS:
        with pytest.raises(Exception, match="unknown app"):
            s4.submit(app, start=0)
        return
    for r in (0, 7):
        _same(s4.query(app, start=r, timeout=120),
              s1.query(app, start=r, timeout=120))
    roots = [2, 9, 55, 201]
    futs = [s4.submit(app, start=r) for r in roots]
    jfuts = [s1.submit(app, start=r) for r in roots]
    for f, jf in zip(futs, jfuts):
        _same(f.result(120), jf.result(120))
    if app == "sssp":
        for r, f in zip(roots, futs):
            np.testing.assert_array_equal(f.result()["values"],
                                          reference_sssp(g, r))
    assert any(k[0] in ("push_multi", "gas_multi") and k[2] == app
               for k in s4.pool.keys())


@pytest.mark.parametrize("app,kw", [
    ("components", {}), ("labelprop", {}), ("kcore", {}),
    ("kcore", {"k": 3})], ids=["components", "labelprop", "kcore",
                               "kcore_k3"])
def test_sharded_fixpoints_equal_single_part(pair, app, kw):
    _, s1, s4 = pair
    _same(s4.query(app, timeout=120, **kw), s1.query(app, timeout=120, **kw))


def test_sharded_pagerank_within_tolerance(pair):
    _, s1, s4 = pair
    a = s1.query("pagerank", timeout=120)
    b = s4.query("pagerank", timeout=120)
    assert a["iters"] == b["iters"] == 4
    np.testing.assert_allclose(b["values"], a["values"], rtol=5e-5,
                               atol=1e-9)


def test_sharded_warm_path_zero_recompiles(pair):
    _, _, s4 = pair
    misses = s4.pool.stats()["misses"]
    for _ in range(2):
        s4.query("sssp", start=1, timeout=120)
        s4.query("components", timeout=120)
        s4.query("bfs", start=3, timeout=120)
    st = s4.stats()["pool"]
    assert st["recompiles"] == 0 and st["misses"] == misses
    s4.pool.sentinel.assert_zero_recompiles()


def test_stats_and_statusz_report_mesh(pair):
    _, s1, s4 = pair
    for doc in (s4.stats(), s4.statusz()):
        m = doc["mesh"]
        assert m["spec"] == "2x2"
        assert m["shape"] == [2, 2] and m["num_parts"] == 4
        assert m["pool_entries"].get("2x2", 0) >= 1
        assert m["plans"]["plans"] >= 1
    eb = s4.mesh_exchange_bytes()
    assert {"sssp", "sssp_multi", "components", "pagerank"} <= set(eb)
    assert all(isinstance(v, int) and v > 0 for v in eb.values())
    assert s1.stats()["mesh"]["num_parts"] == 1
    assert s1.mesh_exchange_bytes() == {}
    # The exchange-plan audit is not ported; it reads only engines that
    # carry a compact plan, and a full-exchange engine carries none.
    audits = s4.statusz()["audits"]
    assert audits["exchck"]["status"] == NOT_PORTED
    assert audits["exchck"]["unaudited_builds"] == 0


def test_sharded_hot_swap_retires_engine_mesh_under_load():
    metrics.reset()
    g = generate.rmat(10, 16, seed=414)
    ed = _edits(g, 415, 12)
    new_g = DeltaGraph.fresh(g).stack(ed).merged()
    with Session(g, _cfg(mesh="4", window_s=0.01), warm=False,
                 device="cpu") as s:
        s.query("sssp", start=3, timeout=120)
        s.query("components", timeout=120)
        warmed = len(s.pool)
        errors, results = [], []

        def hammer():
            try:
                for r in (1, 4, 7):
                    results.append(
                        (r, s.query("sssp", start=r, timeout=120)))
            except Exception as e:   # any failure fails the test
                errors.append(repr(e))

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        summary = s.apply_edits(ed)
        for t in threads:
            t.join()
        assert not errors, errors
        assert summary["retired"] >= warmed
        assert summary["plans_evicted"] >= 1
        assert summary["refreshed"] is None   # sharded: evict-only
        out = s.query("sssp", start=3, timeout=120)
        np.testing.assert_array_equal(out["values"],
                                      reference_sssp(new_g, 3))
        for r, res in results:
            v = np.asarray(res["values"])
            ok = (np.array_equal(v, reference_sssp(g, r))
                  or np.array_equal(v, reference_sssp(new_g, r)))
            assert ok, f"root {r} matches neither version"
        assert s.stats()["pool"]["recompiles"] == 0


def test_pool_builds_once_under_concurrent_get_with_mesh_keys():
    metrics.reset()
    g = generate.gnp(200, 1200, seed=416)
    pool = EnginePool("test-mesh")
    built = []

    def factory():
        from lux_tpu_torch.engine.push import PushExecutor

        built.append(1)
        return PushExecutor(g, SSSP(), device="cpu")

    key = ("push", "fp", "sssp", 1, (2, 2))
    got = []
    threads = [
        threading.Thread(target=lambda: got.append(pool.get(key, factory)))
        for _ in range(6)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(built) == 1
    assert all(e is got[0] for e in got)
    assert pool.stats()["misses"] == 1 and pool.stats()["hits"] == 5
    pool.close()
