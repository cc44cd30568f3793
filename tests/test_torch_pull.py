"""Port parity: the flat pull engine (CF, flat PageRank) against lux_tpu's.

On the CPU the kernel wrappers of the flat pull engine (K8
``gather_segment_sum``, K9 ``cf_edge_sum``) run their plain PyTorch
versions; these tests hold them against ``lux_tpu``'s segment sums, and
the port's ``PullExecutor`` against ``lux_tpu``'s on JAX's CPU and
against the float64 oracles, on the graphs of tests/test_colfilter.py
and ``rmat(10, 8, seed=3)``. The kernels themselves are tested on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lux_tpu.engine import pull as jpull
from lux_tpu.engine.program import PullProgram as JPullProgram
from lux_tpu.graph import Graph as JGraph
from lux_tpu.graph import generate as jgen
from lux_tpu.models import PageRank as JPageRank
from lux_tpu.models.colfilter import CollaborativeFiltering as JCF
from lux_tpu.models.colfilter import reference_colfilter as jref_cf
from lux_tpu.models.colfilter import rmse as jrmse
from lux_tpu.ops import segment as jseg
from lux_tpu_torch import convert
from lux_tpu_torch.engine import pull as tpull
from lux_tpu_torch.engine.program import PullProgram
from lux_tpu_torch.graph import Graph
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.models import CollaborativeFiltering, PageRank
from lux_tpu_torch.models.colfilter import reference_colfilter, rmse
from lux_tpu_torch.models.pagerank import reference_pagerank
from lux_tpu_torch.ops import segment as tseg

CPU = "cpu"
CF_TOL = dict(rtol=1e-4, atol=1e-7)        # tests/test_colfilter.py
PR_TOL = dict(rtol=5e-5, atol=1e-9)        # tests/test_tiled.py
FLAT_CHUNKED_TOL = dict(rtol=1e-5, atol=1e-8)
# CF's state moves by about 1e-6 to 2.3e-5 from its start in 5
# iterations, under what CF_TOL allows at |v| = 0.22. So the update itself
# is held too: to rtol 1e-3, past three f32 ulps of the values (2^-26
# each near 0.22) that rounding the state every iteration may add.
UPDATE_TOL = dict(rtol=1e-3, atol=3 * 2.0 ** -26)


def assert_update_close(got, want, start):
    """``got - start`` against ``want - start``, in float64."""
    start = np.asarray(start, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64) - start,
                               np.asarray(want, np.float64) - start,
                               **UPDATE_TOL)


def _ratings(n_users=60, n_items=40, ne=800, seed=0):
    """tests/test_colfilter.py's bipartite ratings graph, as edge arrays."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, size=ne)
    i = rng.integers(n_users, n_users + n_items, size=ne)
    w = rng.integers(1, 6, size=ne).astype(np.int32)
    return (np.concatenate([u, i]), np.concatenate([i, u]),
            np.concatenate([w, w]), n_users + n_items)


def cf_graphs(seed):
    src, dst, w, nv = _ratings(seed=seed)
    return (JGraph.from_edges(src, dst, nv=nv, weights=w),
            Graph.from_edges(src, dst, nv=nv, weights=w))


def rmat_graphs():
    return jgen.rmat(10, 8, seed=3), tgen.rmat(10, 8, seed=3)


_JAX_RUNS = {}


def _jax_run(app, seed, iters, edge_chunk, strategy="rowptr"):
    """lux_tpu's PullExecutor values after ``iters`` iterations, cached."""
    key = (app, seed, iters, edge_chunk, strategy)
    if key not in _JAX_RUNS:
        if app == "cf":
            g, prog = cf_graphs(seed)[0], JCF()
        else:
            g, prog = rmat_graphs()[0], JPageRank()
        ex = jpull.PullExecutor(g, prog, sum_strategy=strategy,
                                edge_chunk=edge_chunk)
        _JAX_RUNS[key] = np.asarray(ex.run(iters))
    return _JAX_RUNS[key]


# -- K8 and K9's plain versions against lux_tpu's segment sums --------------


def _operands(g, width, exact, seed=11):
    rng = np.random.default_rng(seed)
    shape = (g.nv,) if width == 1 else (g.nv, width)
    if exact:
        return rng.integers(0, 2, size=shape).astype(np.float32)
    return (rng.random(shape, dtype=np.float32) * np.float32(0.4)
            + np.float32(0.05))


@pytest.mark.parametrize("op,width", [("copy", 1), ("copy", 20),
                                      ("cf_sgd", 20)])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("jsum", ["rowptr", "segment"])
def test_plain_kernels_match_lux_tpu_sums(op, width, exact, jsum):
    _, g = cf_graphs(5)
    vals = _operands(g, width, exact)
    sv = vals[g.col_src]
    if op == "copy":
        contrib = sv
    else:
        err = g.weights.astype(np.float32) - np.sum(sv * vals[g.col_dst],
                                                    axis=-1)
        contrib = err[:, None] * sv
    if jsum == "rowptr":
        want = jseg.segment_sum_by_rowptr(jnp.asarray(contrib),
                                          jnp.asarray(g.row_ptr))
        # lux_tpu sums by an f32 cumsum-diff over the whole stream, so its
        # error grows with the prefix, not the row (ROADMAP C): a few f32
        # ulps of the largest prefix.
        atol = 4 * 2.0 ** -23 * np.abs(np.cumsum(
            contrib, axis=0, dtype=np.float64)).max()
    else:
        want = jseg.segment_reduce(jnp.asarray(contrib),
                                   jnp.asarray(g.col_dst),
                                   num_segments=g.nv, kind="sum")
        atol = 1e-9
    want = np.asarray(want)
    truth = np.zeros(want.shape)
    np.add.at(truth, g.col_dst, contrib.astype(np.float64))
    t = torch.from_numpy
    args = (t(vals), t(g.row_ptr), t(g.col_src))
    if op == "copy":
        outs = [tseg.gather_segment_sum(*args),
                tseg.gather_segment_sum_plain(*args, window=97)]
    else:
        outs = [tseg.cf_edge_sum(*args, t(g.weights)),
                tseg.cf_edge_sum_plain(*args, t(g.weights), window=97)]
    for got in outs:
        assert got.dtype == torch.float32 and got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(), truth)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=5e-5,
                                       atol=atol)
            np.testing.assert_allclose(got.numpy(), truth, rtol=5e-5,
                                       atol=1e-9)


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_k_wide_segment_reduce_matches_lux_tpu(kind):
    _, g = cf_graphs(2)
    rng = np.random.default_rng(3)
    data = rng.integers(-50, 50, size=(g.ne, 20)).astype(np.float32)
    want = jseg.segment_reduce(jnp.asarray(data), jnp.asarray(g.col_dst),
                               num_segments=g.nv, kind=kind)
    got = tseg.segment_reduce(torch.from_numpy(data),
                              torch.from_numpy(g.col_dst), g.nv, kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "sum":
        got = tseg.segment_sum_by_rowptr_plain(torch.from_numpy(data),
                                               torch.from_numpy(g.row_ptr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- routing: edge_chunk equals lux_tpu's -----------------------------------


@pytest.mark.parametrize("graph,chunk", [("cf", 128), ("cf", 1000),
                                         ("rmat", 512), ("rmat", 100000),
                                         ("star", 64), ("star", 4096)])
def test_chunk_boundary_plan_matches_lux_tpu(graph, chunk):
    if graph == "cf":
        jg, g = cf_graphs(5)
    elif graph == "rmat":
        jg, g = rmat_graphs()
    else:
        jg, g = jgen.star_graph(1000), tgen.star_graph(1000)
    try:
        want = jpull._chunk_boundary_plan(jg.row_ptr, jg.ne, chunk)
    except ValueError as e:
        with pytest.raises(ValueError, match="does not compress"):
            tpull._chunk_boundary_plan(g.row_ptr, g.ne, chunk)
        assert "does not compress" in str(e)
        return
    got = tpull._chunk_boundary_plan(g.row_ptr, g.ne, chunk)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("app", ["cf", "pagerank"])
@pytest.mark.parametrize("side", [+1, -1])
def test_auto_edge_chunk_matches_lux_tpu(monkeypatch, app, side):
    if app == "cf":
        (jg, g), prog, jprog, width = cf_graphs(7), CollaborativeFiltering(), \
            JCF(), 20
    else:
        (jg, g), prog, jprog, width = rmat_graphs(), PageRank(), \
            JPageRank(), 1
    monkeypatch.setenv("LUX_EDGE_CHUNK_BYTES", str(g.ne * width * 4 + side))
    ex = tpull.PullExecutor(g, prog, device=CPU)
    assert ex.edge_chunk == jpull.PullExecutor(jg, jprog).edge_chunk
    assert (ex.edge_chunk > 0) == (side < 0)
    if app == "cf" and side < 0:
        np.testing.assert_allclose(ex.run(3).numpy(),
                                   reference_colfilter(g, 3), **CF_TOL)


def test_boundary_dense_auto_chunk_degrades_like_lux_tpu(monkeypatch):
    jg, g = jgen.star_graph(1000), tgen.star_graph(1000)
    monkeypatch.setenv("LUX_EDGE_CHUNK_BYTES", "1")   # force auto-chunked
    with pytest.warns(UserWarning, match="degrading to the flat engine"):
        ex = tpull.PullExecutor(g, PageRank(), device=CPU)
    with pytest.warns(UserWarning):
        jex = jpull.PullExecutor(jg, JPageRank())
    assert ex.edge_chunk == jex.edge_chunk == 0
    np.testing.assert_allclose(ex.run(3).numpy(), np.asarray(jex.run(3)),
                               **PR_TOL)
    for make in (lambda: tpull.PullExecutor(g, PageRank(), device=CPU,
                                            edge_chunk=64),
                 lambda: jpull.PullExecutor(jg, JPageRank(), edge_chunk=64)):
        with pytest.raises(ValueError, match="does not compress"):
            make()


def test_routing_without_refusals_keeps_the_request(monkeypatch):
    # The card's kernels take no windows: a plan that does not compress
    # refuses nothing there, and routes that compress are lux_tpu's.
    g = tgen.star_graph(1000)
    assert tpull.route_edge_chunk(g, PageRank(), 64, refuse=False) == 64
    monkeypatch.setenv("LUX_EDGE_CHUNK_BYTES", "1")
    with pytest.warns(UserWarning, match="degrading to the flat engine"):
        assert tpull.route_edge_chunk(g, PageRank(), refuse=False) == 0
    _, g = cf_graphs(5)
    for chunk in (None, 0, 128):
        assert (tpull.route_edge_chunk(g, CollaborativeFiltering(), chunk,
                                       refuse=False)
                == tpull.route_edge_chunk(g, CollaborativeFiltering(),
                                          chunk))


def test_boundary_dense_auto_chunk_grows_windows_like_lux_tpu(monkeypatch):
    # 1.5M empty rows put 1.5M boundaries in the first 2^20-edge window,
    # so 4 windows do not compress; one window of all 4M edges does.
    empty, ne, hubs = 1_500_000, 4_000_000, 100
    row_ptr = np.concatenate([
        np.zeros(empty + 1, np.int64),
        np.linspace(0, ne, hubs + 1).astype(np.int64)[1:]])
    col_src = np.zeros(ne, np.int32)
    nv = empty + hubs
    g = Graph(nv=nv, ne=ne, row_ptr=row_ptr, col_src=col_src)
    jg = JGraph(nv=nv, ne=ne, row_ptr=row_ptr, col_src=col_src)
    monkeypatch.setenv("LUX_EDGE_CHUNK_BYTES", "1")
    got = tpull.route_edge_chunk(g, PageRank())
    assert got == jpull.PullExecutor(jg, JPageRank()).edge_chunk == ne


# -- end to end against lux_tpu and the oracles -----------------------------


@pytest.mark.parametrize("edge_chunk", [0, 128])
@pytest.mark.parametrize("strategy", ["rowptr", "segment"])
def test_cf_parity(edge_chunk, strategy):
    _, g = cf_graphs(5)
    ex = tpull.PullExecutor(g, CollaborativeFiltering(), strategy,
                            device=CPU, edge_chunk=edge_chunk)
    assert ex.edge_chunk == edge_chunk
    got = ex.run(5).numpy()
    assert got.shape == (g.nv, 20) and got.dtype == np.float32
    start = ex.init_values().numpy()
    want = _jax_run("cf", 5, 5, edge_chunk, strategy)
    oracle = reference_colfilter(g, 5)
    np.testing.assert_allclose(got, want, **CF_TOL)
    np.testing.assert_allclose(got, oracle, **CF_TOL)
    flat = tpull.PullExecutor(g, CollaborativeFiltering(), strategy,
                              device=CPU, edge_chunk=0).run(5).numpy()
    np.testing.assert_allclose(got, flat, **FLAT_CHUNKED_TOL)
    for other in (want, oracle, flat):
        assert_update_close(got, other, start)


@pytest.mark.parametrize("edge_chunk", [0, 512])
def test_pagerank_parity(edge_chunk):
    _, g = rmat_graphs()
    ex = tpull.PullExecutor(g, PageRank(), device=CPU, edge_chunk=edge_chunk)
    got = ex.run(5).numpy()
    np.testing.assert_allclose(got, _jax_run("pagerank", 3, 5, edge_chunk),
                               **PR_TOL)
    np.testing.assert_allclose(got, reference_pagerank(g, 5), **PR_TOL)
    one = ex.step(ex.init_values()).numpy()
    np.testing.assert_allclose(one, reference_pagerank(g, 1), **PR_TOL)


@pytest.mark.parametrize("window", [97, 1 << 22])
def test_cf_oracle_matches_lux_tpu(window):
    jg, g = cf_graphs(5)
    want = jref_cf(jg, 5)
    got = reference_colfilter(g, 5, window=window)
    if window >= g.ne:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        reference_colfilter(g, 5, window=window, device=CPU), want,
        rtol=1e-6, atol=1e-12)


def test_cf_training_reduces_rmse():
    jg, g = cf_graphs(3)
    ex = tpull.PullExecutor(g, CollaborativeFiltering(), device=CPU)
    v0 = ex.init_values().numpy()
    v200 = ex.run(200).numpy()
    assert rmse(g, v200) < rmse(g, v0)
    for v in (v0, v200):
        assert abs(rmse(g, v, window=101) - jrmse(jg, v)) < 1e-12


def test_cf_state_from_lux_tpu_resumes():
    jg, g = cf_graphs(5)
    mid = _jax_run("cf", 5, 2, 0)
    ex = tpull.PullExecutor(g, CollaborativeFiltering(), device=CPU)
    got = ex.run(3, vals=convert.vals_from_numpy(mid, CPU)).numpy()
    want = _jax_run("cf", 5, 5, 0)
    np.testing.assert_allclose(got, want, **CF_TOL)
    assert_update_close(got, want, mid)


# -- refusals ---------------------------------------------------------------


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


def test_refusals_match_lux_tpu():
    jg, g = jgen.gnp(50, 200, seed=1), tgen.gnp(50, 200, seed=1)
    with pytest.raises(ValueError, match="edge-weighted"):
        tpull.PullExecutor(g, CollaborativeFiltering(), device=CPU)
    with pytest.raises(ValueError):
        jpull.PullExecutor(jg, JCF())
    with pytest.raises(ValueError, match="needs a sum combiner"):
        tpull.PullExecutor(g, _MinLabel(), device=CPU, edge_chunk=64)
    with pytest.raises(ValueError, match="needs a sum combiner"):
        jpull.PullExecutor(jg, _JMinLabel(), edge_chunk=64)


def test_min_combiner_flat_matches_lux_tpu():
    jg, g = jgen.gnp(200, 900, seed=4), tgen.gnp(200, 900, seed=4)
    got = tpull.PullExecutor(g, _MinLabel(), device=CPU).run(4).numpy()
    want = np.asarray(jpull.PullExecutor(jg, _JMinLabel()).run(4))
    np.testing.assert_array_equal(got, want)


class _ScaledRank(PageRank):
    # Inherits edge_op="copy" but computes another edge function.
    def edge_contrib(self, edge):
        return 2 * edge.src_vals


class _ScaledRankOp(_ScaledRank):
    edge_op = None


def test_kernel_coverage_check():
    for prog in (PageRank(), CollaborativeFiltering()):
        tpull.check_kernel_covers(prog)
    for prog in (_MinLabel(), _ScaledRank(), _ScaledRankOp()):
        with pytest.raises(NotImplementedError):
            tpull.check_kernel_covers(prog)
    inst = PageRank()
    inst.edge_contrib = lambda edge: 2 * edge.src_vals
    with pytest.raises(NotImplementedError, match="apart from edge_op"):
        tpull.check_kernel_covers(inst)
    # On the CPU the program's own edge function runs.
    _, g = rmat_graphs()
    got = tpull.PullExecutor(g, _ScaledRank(), device=CPU).step(
        PageRank().init_values(g)).numpy()
    ctx = tpull.PullExecutor(g, PageRank(), device=CPU)
    want = PageRank().apply(
        torch.from_numpy(PageRank().init_values(g)),
        2 * tseg.gather_segment_sum_plain(ctx.init_values(), ctx.row_ptr,
                                          ctx.col_src), ctx._ctx).numpy()
    np.testing.assert_allclose(got, want, **PR_TOL)


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, g = cf_graphs(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpull.PullExecutor(g, CollaborativeFiltering())
