"""Port parity: the sharded pull engine (PageRank, CF over P parts)
against lux_tpu's.

On the CPU the port's ``ShardedPullExecutor`` runs the plain versions of
K8 and K9 per part; these tests hold it against ``lux_tpu``'s
``ShardedPullExecutor`` on its 8-device virtual CPU mesh and against the
f64 oracles, for P in {1, 2, 4, 8} in the full and compact exchange
modes, at the reference tolerances: PageRank ``rtol=5e-5, atol=1e-9``
(tests/test_tiled.py), CF ``rtol=1e-4, atol=1e-7``
(tests/test_colfilter.py). Compact equals full bitwise, and
``exchange_bytes_per_iter`` equals ``lux_tpu``'s. The kernels on the
card are tested by tests/test_torch_cuda.py.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.engine import pull_sharded as jps
from lux_tpu.engine.program import PullProgram as JPullProgram
from lux_tpu.graph import generate as jgen
from lux_tpu.models import PageRank as JPageRank
from lux_tpu.models.colfilter import CollaborativeFiltering as JCF
from lux_tpu.parallel.mesh import make_mesh as jmake_mesh
from lux_tpu_torch.engine import pull_sharded as tps
from lux_tpu_torch.engine.program import PullProgram
from lux_tpu_torch.engine.pull import PullExecutor
from lux_tpu_torch.entry import dryrun_multichip
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.models import CollaborativeFiltering, PageRank
from lux_tpu_torch.models.colfilter import reference_colfilter
from lux_tpu_torch.models.pagerank import reference_pagerank
from lux_tpu_torch.parallel.mesh import LocalMesh, make_mesh
from lux_tpu_torch.parallel.shard import ShardedGraph

CPU = "cpu"
PARTS = [1, 2, 4, 8]
MODES = ["full", "compact"]
PR_TOL = dict(rtol=5e-5, atol=1e-9)     # tests/test_tiled.py
CF_TOL = dict(rtol=1e-4, atol=1e-7)     # tests/test_colfilter.py
PR_ITERS, CF_ITERS = 10, 5
# app -> (graph maker over a generate module, (lux_tpu, port) programs,
#         iterations, tolerance)
APPS = {
    "pagerank": (lambda m: m.rmat(10, 8, seed=3),
                 lambda: (JPageRank(), PageRank()), PR_ITERS, PR_TOL),
    "cf": (lambda m: m.bipartite_ratings(200, 30, 3000, seed=1),
           lambda: (JCF(), CollaborativeFiltering()), CF_ITERS, CF_TOL),
    # Nearly all edges into part 0; later parts are empty.
    "pagerank_star": (lambda m: m.undirected(m.star_graph(40)),
                      lambda: (JPageRank(), PageRank()), 5, PR_TOL),
}
_GRAPHS = {}
_RUNS = {}


def _graphs(app):
    if app not in _GRAPHS:
        make = APPS[app][0]
        _GRAPHS[app] = (make(jgen), make(tgen))
    return _GRAPHS[app]


def _oracle(app):
    _, tg = _graphs(app)
    iters = APPS[app][2]
    if app == "cf":
        return reference_colfilter(tg, iters)
    return reference_pagerank(tg, iters)


def _jax_run(app, parts, mode, monkeypatch, strategy="rowptr"):
    """lux_tpu's (values, exchange mode, exchange bytes), cached."""
    key = (app, parts, mode, strategy)
    if key not in _RUNS:
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        jg, _ = _graphs(app)
        ex = jps.ShardedPullExecutor(jg, APPS[app][1]()[0],
                                     mesh=jmake_mesh(parts),
                                     sum_strategy=strategy)
        _RUNS[key] = (ex.gather_values(ex.run(APPS[app][2])),
                      ex.exchange_mode, ex.exchange_bytes_per_iter())
    return _RUNS[key]


def _port(app, parts, mode, monkeypatch, **kw):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    _, tg = _graphs(app)
    return tps.ShardedPullExecutor(tg, APPS[app][1]()[1], num_parts=parts,
                                   device=CPU, **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("app", sorted(APPS))
def test_sharded_pull_matches_lux_tpu(app, parts, mode, monkeypatch):
    ex = _port(app, parts, mode, monkeypatch)
    got = ex.gather_values(ex.run(APPS[app][2]))
    want, jmode, jbytes = _jax_run(app, parts, mode, monkeypatch)
    tol = APPS[app][3]
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, _oracle(app), **tol)
    assert ex.exchange_mode == jmode
    assert ex.exchange_bytes_per_iter() == jbytes
    if parts == 1:
        assert (ex.exchange_mode, jbytes) == ("full", 0)


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("app", sorted(APPS))
def test_compact_equals_full_bitwise(app, parts, monkeypatch):
    runs = {}
    for mode in MODES:
        ex = _port(app, parts, mode, monkeypatch)
        runs[mode] = (ex.exchange_mode, ex.run(APPS[app][2]))
    assert runs["full"][0] == "full"
    assert torch.equal(runs["compact"][1], runs["full"][1])


@pytest.mark.parametrize("parts", [2, 8])
@pytest.mark.parametrize("app", ["pagerank", "cf"])
def test_segment_strategy_matches_lux_tpu(app, parts, monkeypatch):
    ex = _port(app, parts, "full", monkeypatch, sum_strategy="segment")
    got = ex.gather_values(ex.run(APPS[app][2]))
    want, _, _ = _jax_run(app, parts, "full", monkeypatch, "segment")
    np.testing.assert_allclose(got, want, **APPS[app][3])


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("app", ["pagerank", "cf"])
def test_sharded_matches_single_device_port(app, parts, monkeypatch):
    # On the CPU each part sums its own float64 prefix, so the sharded
    # result may differ from the single-device one by the f32 rounding
    # of a different prefix; on the card the kernels add the same items
    # in the same order and the two are equal bitwise
    # (tests/test_torch_cuda.py).
    ex = _port(app, parts, "full", monkeypatch)
    _, tg = _graphs(app)
    iters = APPS[app][2]
    single = PullExecutor(tg, APPS[app][1]()[1], device=CPU, edge_chunk=0)
    np.testing.assert_allclose(ex.gather_values(ex.run(iters)),
                               single.run(iters).numpy(), rtol=1e-6,
                               atol=1e-12)


class _MinLabel(PullProgram):
    name = "minlabel"
    combiner = "min"

    def init_values(self, graph):
        return np.arange(graph.nv, dtype=np.float32)

    def edge_contrib(self, edge):
        return edge.src_vals

    def apply(self, old_vals, acc, ctx):
        return torch.minimum(old_vals, acc)


class _JMinLabel(JPullProgram):
    name = "minlabel"
    combiner = "min"

    def init_values(self, graph):
        return np.arange(graph.nv, dtype=np.float32)

    def edge_contrib(self, edge):
        return edge.src_vals

    def apply(self, old_vals, acc, ctx):
        return jnp.minimum(old_vals, acc)


@pytest.mark.parametrize("mode", MODES)
def test_min_combiner_matches_lux_tpu_bitwise(mode, monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    jg, tg = jgen.gnp(300, 1500, seed=4), tgen.gnp(300, 1500, seed=4)
    ex = tps.ShardedPullExecutor(tg, _MinLabel(), num_parts=4, device=CPU)
    jex = jps.ShardedPullExecutor(jg, _JMinLabel(), mesh=jmake_mesh(4))
    assert ex.exchange_mode == jex.exchange_mode == mode
    np.testing.assert_array_equal(ex.gather_values(ex.run(4)),
                                  jex.gather_values(jex.run(4)))


def test_step_phase_step_warmup_and_layout(monkeypatch):
    ex = _port("cf", 4, "compact", monkeypatch)
    v0 = ex.init_values()
    assert v0.shape == (4, ex.sg.max_nv, 20) and v0.dtype == torch.float32
    host = CollaborativeFiltering().init_values(_graphs("cf")[1])
    np.testing.assert_array_equal(ex.gather_values(v0), host)
    one = ex.step(v0)
    new, times = ex.phase_step(v0)
    assert torch.equal(new, one)
    assert sorted(times) == ["comp", "exchange", "update"]
    assert all(t >= 0 for t in times.values())
    assert torch.equal(ex.run(1), one)
    assert torch.equal(ex.run(2), ex.run(1, vals=one))
    ex.warmup()
    # Pad vertices stay frozen at their initial (zero) values.
    pad = ~ex.vertex_mask
    assert torch.count_nonzero(ex.run(3)[pad]) == 0
    with pytest.raises(ValueError, match="values must be"):
        ex.step(v0[:, :-1])


def test_signature_matches_lux_tpu():
    got = list(inspect.signature(tps.ShardedPullExecutor).parameters)
    want = list(inspect.signature(jps.ShardedPullExecutor).parameters)
    assert got == want + ["device"]
    for name in ("init_values", "host_to_device", "step", "phase_step",
                 "warmup", "run", "exchange_bytes_per_iter",
                 "gather_values"):
        assert hasattr(tps.ShardedPullExecutor, name)


def test_refusals(monkeypatch):
    monkeypatch.delenv("LUX_EXCHANGE", raising=False)
    tg = tgen.gnp(60, 300, seed=1)
    with pytest.raises(ValueError, match="edge-weighted"):
        tps.ShardedPullExecutor(tg, CollaborativeFiltering(), num_parts=2,
                                device=CPU)
    with pytest.raises(ValueError, match="sum strategy"):
        tps.ShardedPullExecutor(tg, PageRank(), num_parts=2, device=CPU,
                                sum_strategy="scan")
    with pytest.raises(ValueError, match="3 parts, mesh has 2"):
        tps.ShardedPullExecutor(tg, PageRank(), num_parts=2, device=CPU,
                                sg=ShardedGraph.build(tg, 3))
    with pytest.raises(ValueError, match="different Graph"):
        tps.ShardedPullExecutor(tg, PageRank(), num_parts=2, device=CPU,
                                sg=ShardedGraph.build(
                                    tgen.gnp(60, 300, seed=1), 2))
    with pytest.raises(ValueError, match="differs from the mesh"):
        tps.ShardedPullExecutor(tg, PageRank(), device="meta",
                                mesh=LocalMesh(2, "cpu"))
    # A mesh given decides the parts; a prebuilt sg of the graph is used.
    sg = ShardedGraph.build(tg, 3)
    ex = tps.ShardedPullExecutor(tg, PageRank(), mesh=make_mesh(3, CPU),
                                 num_parts=7, sg=sg)
    assert ex.num_parts == 3 and ex.sg is sg


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tps.ShardedPullExecutor(tgen.gnp(60, 300, seed=1), PageRank(),
                                num_parts=2)


@pytest.mark.parametrize("mode", MODES)
def test_dryrun_multichip_on_cpu(mode, monkeypatch, capsys):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    dryrun_multichip(4, device=CPU)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4)" in out and f"exchange {mode}" in out
