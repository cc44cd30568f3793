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
from lux_tpu_torch.parallel.shard import ShardedGraph
from torch_pull_order import ordered_pull_sum

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


# -- K8's and K9's row schedule and summation order ------------------------


def _schedule_graph(name):
    """(row_ptr, col_src, weights, nv of the table, row_base) of one of the
    schedule tests' graphs; "part" is part 1 of a 3-part sharded ratings
    graph, whose destinations lie at row_base = max_nv of the flat
    table."""
    if name == "ratings":
        g = tgen.bipartite_ratings(300, 40, 6000, seed=2)
    elif name == "rmat":
        g = tgen.rmat(10, 8, seed=3, weighted=True)
    elif name == "empty rows":
        rng = np.random.default_rng(4)
        lens = rng.integers(0, 60, 500)
        lens[rng.random(500) < 0.4] = 0
        lens[-30:] = 0
        rp = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        src = rng.integers(0, 500, int(rp[-1]))
        g = Graph.from_edges(src, np.repeat(np.arange(500), lens), nv=500,
                             weights=rng.integers(1, 6, int(rp[-1]))
                             .astype(np.int32))
    elif name == "one hub":
        rng = np.random.default_rng(5)
        ne = 6000
        dst = np.where(rng.random(ne) < 0.8, 7, rng.integers(0, 100, ne))
        g = Graph.from_edges(rng.integers(0, 100, ne), dst, nv=100,
                             weights=rng.integers(1, 6, ne).astype(np.int32))
    else:   # "part"
        g = tgen.bipartite_ratings(300, 40, 6000, seed=2)
        sg = ShardedGraph.build(g, 3)
        n_e = int(sg.local_row_ptr[1, -1])
        return (sg.local_row_ptr[1].astype(np.int64), sg.src_pidx[1, :n_e],
                sg.weights[1, :n_e], 3 * sg.max_nv, sg.max_nv)
    return g.row_ptr, g.col_src, g.weights, g.nv, 0


SCHEDULE_GRAPHS = ["ratings", "rmat", "empty rows", "one hub", "part"]
# Each kernel's thresholds, and small ones that give these graphs rows of
# every kind (a lane, a warp, a block).
SCHEDULES = [("copy", None), ("cf_sgd", None), ("copy", (64, 200)),
             ("cf_sgd", (64, 200))]


def _schedule(rp, op, thresholds):
    task_edges, hub_edges = thresholds or tseg.PULL_TASK_EDGES[op]
    tasks, n_hub = tseg.row_tasks(rp, task_edges, hub_edges)
    return tasks, n_hub, task_edges, hub_edges


@pytest.mark.parametrize("op,thresholds", SCHEDULES)
@pytest.mark.parametrize("name", SCHEDULE_GRAPHS)
def test_pull_row_tasks_partition_the_rows(name, op, thresholds):
    # Hub rows (more than hub_edges edges, one a block) first, then warp
    # tasks of at most 32 consecutive rows in row order, gathering at
    # most 2 * task_edges unless alone; together every row once.
    rp = _schedule_graph(name)[0]
    n, lens = rp.shape[0] - 1, np.diff(rp)
    tasks, n_hub, task_edges, hub_edges = _schedule(rp, op, thresholds)
    seen = np.zeros(n, np.int64)
    for lo, hi in tasks:
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    hubs, warps = tasks[:n_hub], tasks[n_hub:]
    assert np.all(hubs[:, 1] - hubs[:, 0] == 1)
    assert np.array_equal(np.sort(hubs[:, 0]),
                          np.flatnonzero(lens > hub_edges))
    assert np.all(np.diff(warps[:, 0]) > 0)
    size = warps[:, 1] - warps[:, 0]
    assert np.all((size >= 1) & (size <= tseg.TASK_ROWS))
    edges = rp[warps[:, 1]] - rp[warps[:, 0]]
    assert np.all((edges <= 2 * task_edges) | (size == 1))
    if thresholds is None:
        t = tseg.pull_row_tasks(rp, op, CPU)
        assert (t.n_tasks, t.n_hub, t.nrows) == (tasks.shape[0], n_hub, n)
        assert torch.equal(t.tasks, torch.from_numpy(tasks))
    if name == "one hub":
        assert n_hub == 1 and hubs[0, 0] == 7


@pytest.mark.parametrize("op,thresholds", SCHEDULES)
@pytest.mark.parametrize("name", SCHEDULE_GRAPHS)
@pytest.mark.parametrize("exact", [True, False])
def test_kernel_order_matches_plain(name, op, thresholds, exact):
    # The kernels' summation order: bitwise on small integers (every
    # partial sum exact), within the reference tolerances on floats.
    rp, col_src, w, n_tab, base = _schedule_graph(name)
    tasks, n_hub, _, _ = _schedule(rp, op, thresholds)
    rng = np.random.default_rng(len(rp))
    shape = (n_tab,) if op == "copy" else (n_tab, tseg.CF_WIDTH)
    vals = (rng.integers(0, 2, size=shape).astype(np.float32) if exact
            else rng.random(shape, dtype=np.float32) * np.float32(0.2)
            + np.float32(0.12))
    t = torch.from_numpy
    args = (t(vals), t(rp), t(col_src.astype(np.int32)))
    if op == "copy":
        got = ordered_pull_sum(*args, tasks[:n_hub, 0])
        want = tseg.gather_segment_sum_plain(*args)
        tol = PR_TOL
    else:
        got = ordered_pull_sum(*args, tasks[:n_hub, 0], weights=t(w),
                               row_base=base)
        want = tseg.cf_edge_sum_plain(*args, t(w), row_base=base)
        tol = CF_TOL
    assert got.dtype == torch.float32 and got.shape == want.shape
    if exact:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


@pytest.mark.parametrize("app", ["cf", "pagerank"])
@pytest.mark.parametrize("thresholds", [None, (64, 200)])
def test_kernel_order_step_matches_lux_tpu(app, thresholds):
    # One iteration with the sums taken in the kernels' order, against
    # lux_tpu's PullExecutor step from the same state.
    if app == "cf":
        jg = jgen.bipartite_ratings(300, 40, 6000, seed=2)
        g = tgen.bipartite_ratings(300, 40, 6000, seed=2)
        prog, jprog, op, tol = CollaborativeFiltering(), JCF(), "cf_sgd", \
            CF_TOL
    else:
        (jg, g), prog, jprog, op, tol = rmat_graphs(), PageRank(), \
            JPageRank(), "copy", PR_TOL
    ex = tpull.PullExecutor(g, prog, device=CPU)
    tasks, n_hub, _, _ = _schedule(g.row_ptr, op, thresholds)
    vals = ex.init_values()
    acc = ordered_pull_sum(vals, g.row_ptr, ex.col_src, tasks[:n_hub, 0],
                           weights=ex.weights if app == "cf" else None)
    got = prog.apply(vals, acc, ex._ctx).numpy()
    want = np.asarray(jpull.PullExecutor(jg, jprog).step(vals.numpy()))
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got, ex.step(vals).numpy(), **tol)


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
