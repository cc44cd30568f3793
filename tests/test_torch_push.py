"""Port parity: the push engine (SSSP, CC) against lux_tpu's.

On the CPU each kernel wrapper of the push engine (K5
``segment_minmax_relax``, K6 ``frontier_queue``, K7
``queue_relax_scatter``) runs its plain PyTorch version; these tests
hold the port against ``lux_tpu``'s ``PushExecutor`` on JAX's CPU, and
each plain version against the ``lux_tpu`` functions it replaces on the
same states. Every value check is bitwise (uint32), with equal
``iterations`` and ``sparse_iters``. The kernels themselves are tested
on the card by tests/test_torch_cuda.py.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lux_tpu.engine import check as jcheck
from lux_tpu.engine import push as jpush
from lux_tpu.graph import generate as jgen
from lux_tpu.models.components import ConnectedComponents as JCC
from lux_tpu.models.components import reference_components as jref_cc
from lux_tpu.models.sssp import SSSP as JSSSP
from lux_tpu.models.sssp import reference_sssp as jref_sssp
from lux_tpu.ops import segment as jseg
from lux_tpu_torch import convert
from lux_tpu_torch.engine import check as tcheck
from lux_tpu_torch.engine import push as tpush
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.models import SSSP, ConnectedComponents
from lux_tpu_torch.models.components import reference_components
from lux_tpu_torch.models.sssp import reference_sssp
from lux_tpu_torch.ops import frontier as tfq
from lux_tpu_torch.ops import segment as tseg

CPU = torch.device("cpu")

# name -> (graph maker over a generate module, app, executor kw, run kw)
GRAPHS = {
    "path20": (lambda m: m.path_graph(20), "sssp", {}, {"start": 0}),
    "gnp400": (lambda m: m.gnp(400, 2400, seed=3), "sssp", {},
               {"start": 5}),
    "gnp2000_sparse": (lambda m: m.gnp(2000, 16000, seed=21), "sssp",
                       {"queue_frac": 4, "edge_budget_frac": 2},
                       {"start": 0}),
    "gnp700": (lambda m: m.gnp(700, 5000, seed=41), "sssp", {},
               {"start": 0}),
    "gnp1000": (lambda m: m.gnp(1000, 9000, seed=47), "sssp", {},
                {"start": 2}),
    "cc300": (lambda m: m.undirected(m.gnp(300, 500, seed=11)), "cc", {}, {}),
    "cc400_weighted": (
        lambda m: m.undirected(m.gnp(400, 900, seed=43, weighted=True)),
        "cc", {}, {}),
    "rmat10_sssp": (lambda m: m.rmat(10, 8, seed=0), "sssp", {},
                    {"start": 0}),
    "rmat10_cc": (lambda m: m.undirected(m.rmat(10, 8, seed=0)), "cc", {},
                  {}),
}

_JAX_RUNS = {}


def _graphs(name):
    make = GRAPHS[name][0]
    return make(jgen), make(tgen)


def _programs(app):
    return (JSSSP(), SSSP()) if app == "sssp" else (JCC(),
                                                    ConnectedComponents())


def _jax_run(name, blocked, max_iters=None, chunk=16):
    """lux_tpu's (values, iterations, sparse_iters), cached per case."""
    key = (name, blocked, max_iters, chunk)
    if key not in _JAX_RUNS:
        _, app, kw, rkw = GRAPHS[name]
        jg, _ = _graphs(name)
        ex = jpush.PushExecutor(jg, _programs(app)[0], blocked_dense=blocked,
                                **kw)
        st, iters = ex.run(max_iters=max_iters, chunk=chunk, **rkw)
        _JAX_RUNS[key] = (np.asarray(st.values), iters, ex.sparse_iters)
    return _JAX_RUNS[key]


def _port(name, blocked, **extra):
    _, app, kw, rkw = GRAPHS[name]
    _, tg = _graphs(name)
    ex = tpush.PushExecutor(tg, _programs(app)[1], device="cpu",
                            blocked_dense=blocked, **{**kw, **extra})
    return ex, rkw


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_push_executor_matches_lux_tpu(name, blocked):
    ex, rkw = _port(name, blocked)
    assert ex.blocked_dense == blocked
    state, iters = ex.run(**rkw)
    got = ex.values(state)
    want, jiters, jsparse = _jax_run(name, blocked)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert (iters, ex.sparse_iters) == (jiters, jsparse)
    assert len(ex.branch_log) == iters
    assert sum(1 for b, _, _ in ex.branch_log if b > 0) == ex.sparse_iters


def test_both_branches_and_packed_forms_are_exercised():
    # The list above must reach the sparse branch, the dense branch and
    # both dense input forms, or it proves nothing about them.
    ex, rkw = _port("gnp2000_sparse", True)
    ex.run(**rkw)
    assert 0 < ex.sparse_iters < len(ex.branch_log)
    ex, rkw = _port("rmat10_cc", None)
    ex.run(**rkw)
    assert ex.sparse and not ex.blocked_dense and ex.sparse_iters > 0


@pytest.mark.parametrize("name,max_iters,chunk", [
    ("path20", None, 3), ("path20", 7, 3), ("gnp2000_sparse", 2, 16),
    ("gnp2000_sparse", None, 1), ("rmat10_cc", 2, 3), ("gnp400", 0, 16),
    ("gnp400", None, 0),
])
def test_max_iters_and_chunk_match_lux_tpu(name, max_iters, chunk):
    ex, rkw = _port(name, False)
    state, iters = ex.run(max_iters=max_iters, chunk=chunk, **rkw)
    want, jiters, jsparse = _jax_run(name, False, max_iters, chunk)
    np.testing.assert_array_equal(ex.values(state), want)
    assert (iters, ex.sparse_iters) == (jiters, jsparse)


@pytest.mark.parametrize("name", ["gnp2000_sparse", "rmat10_cc"])
def test_state_from_lux_tpu_finishes_in_the_port(name):
    _, app, kw, rkw = GRAPHS[name]
    jg, tg = _graphs(name)
    jex = jpush.PushExecutor(jg, _programs(app)[0], **kw)
    js, _ = jex.run(max_iters=2, **rkw)
    jsparse2 = jex.sparse_iters
    state = convert.push_state_from_numpy(np.asarray(js.values),
                                          np.asarray(js.frontier), CPU)
    vals, fr = convert.push_state_to_numpy(state)
    np.testing.assert_array_equal(vals, np.asarray(js.values))
    np.testing.assert_array_equal(fr, np.asarray(js.frontier))
    ex = tpush.PushExecutor(tg, _programs(app)[1], device="cpu", **kw)
    final, iters = ex.run(state=state)
    want, jiters, jsparse = _jax_run(name, None)
    np.testing.assert_array_equal(ex.values(final), want)
    assert 2 + iters == jiters
    assert jsparse2 + ex.sparse_iters == jsparse


@pytest.mark.parametrize("name,blocked", [("gnp2000_sparse", False),
                                         ("gnp700", True), ("path20", False)])
def test_step_and_phase_step_follow_run(name, blocked):
    # path20 has ne < 1024, so its sparse branch is off: lux_tpu's
    # phase_step raises there (ROADMAP C), the port's reports "dense".
    ex, rkw = _port(name, blocked)
    ex.warmup(**rkw)
    state = ex.init_state(**rkw)
    ex.warmup_phases(state)
    labels, steps = [], ex.init_state(**rkw)
    while True:
        state, cnt, times = ex.phase_step(state)
        steps, scnt = ex.step(steps)
        assert scnt == cnt
        assert torch.equal(steps.values, state.values)
        assert set(times) == {"loadTime", "compTime", "updateTime", "branch"}
        labels.append(times["branch"])
        if cnt == 0:
            break
    final, iters = ex.run(**rkw)
    assert labels == [tpush._tier_label(ex.tiers, b)
                      for b, _, _ in ex.branch_log]
    np.testing.assert_array_equal(ex.values(state), ex.values(final))


# -- host helpers -------------------------------------------------------


@pytest.mark.parametrize("nv,ne,qf,ef", [(2000, 16000, 16, 8),
                                         (4 << 20, 64 << 20, 16, 8),
                                         (300, 1000, 4, 2), (10, 1100, 1, 1)])
def test_budgets_tiers_and_tier_index_match_lux_tpu(nv, ne, qf, ef):
    budgets = tpush._sparse_budgets(nv, ne, qf, ef)
    assert budgets == jpush._sparse_budgets(nv, ne, qf, ef)
    tiers = tpush._make_tiers(*budgets)
    assert tiers == jpush._make_tiers(*budgets)
    cnts = sorted({0, 1} | {q + d for q, _ in tiers for d in (-1, 0, 1)})
    outs = sorted({0, ne} | {e + d for _, e in tiers for d in (-1, 0, 1)})
    for c in cnts:
        for o in outs:
            want = int(jpush._tier_index(jnp.int32(c), jnp.uint32(o), tiers))
            assert tpush._tier_index(c, o, tiers) == want, (c, o)
    assert [tpush._tier_label(tiers, t) for t in range(len(tiers) + 1)] == [
        jpush._tier_label(tiers, t) for t in range(len(tiers) + 1)]


def test_u32_storage_and_identities():
    vals = np.array([0, 1, 2**31 - 1, 2**31, 0xFFFFFFFF], np.uint32)
    t = tseg.to_u32_storage(vals)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tseg.u32_to_numpy(t), vals)
    np.testing.assert_array_equal(tseg.widen_u32(t).numpy(),
                                  vals.astype(np.int64))
    assert torch.equal(tseg.narrow_u32(tseg.widen_u32(t)), t)
    for kind in ("sum", "min", "max"):
        for dt in (np.uint32, np.int32, np.float32):
            want = jseg.identity_for(kind, jnp.dtype(dt))
            assert tseg.identity_for(kind, dt) == want.item()
    assert tseg.identity_for("min", np.uint32) == 0xFFFFFFFF


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_segment_reduce_matches_lux_tpu(kind):
    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(0, 40, size=300)).astype(np.int32)
    ids[ids == 7] = 8                      # segment 7 stays empty
    data = rng.integers(0, 2**32, size=300, dtype=np.uint64).astype(np.uint32)
    if kind == "sum":
        data = data % 1000
    want = jseg.segment_reduce(jnp.asarray(data), jnp.asarray(ids), 41, kind)
    got = tseg.segment_reduce(tseg.widen_u32(tseg.to_u32_storage(data)),
                              torch.from_numpy(ids), 41, kind, np.uint32)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    fdata = rng.standard_normal(300).astype(np.float32)
    want = jseg.segment_reduce(jnp.asarray(fdata), jnp.asarray(ids), 41, kind)
    got = tseg.segment_reduce(torch.from_numpy(fdata), torch.from_numpy(ids),
                              41, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_segment_item_rows_own_their_items():
    # The work items of K1 (segment_items): each lies inside the row that
    # owns it, and the rows own them in order; here items of 64 elements.
    g = tgen.rmat(10, 8, seed=0)
    items = tseg.SegmentItems.build(g.row_ptr, 64, CPU)
    lo, ri = items.item_lo.numpy(), items.row_items.numpy()
    rows = np.repeat(np.arange(g.nv), np.diff(ri))
    assert rows.shape == (items.n_items,) and items.nrows == g.nv
    assert np.all(g.row_ptr[rows] <= lo[:-1])
    assert np.all(lo[1:] <= g.row_ptr[rows + 1])
    assert np.all(np.diff(lo) >= 1)


def _push_row_ptr(name):
    """A CSC row pointer K5 runs over: the push executors' graphs, rows
    with no edges, one row above HUB_EDGES, a sharded part's."""
    g = tgen.rmat(10, 8, seed=0)
    if name == "rmat":
        return g.row_ptr
    if name == "closure":
        return tgen.undirected(g).row_ptr
    if name == "empty rows":
        lens = np.random.default_rng(5).choice([0, 0, 0, 3, 40, 5000], 3000)
        return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    if name == "one row":
        return np.array([0, tseg.HUB_EDGES + 5], np.int64)
    from lux_tpu_torch.parallel.shard import ShardedGraph
    return ShardedGraph.build(g, 4).local_row_ptr[1].astype(np.int64)


@pytest.mark.parametrize("name", ["rmat", "closure", "empty rows",
                                  "one row", "part"])
def test_push_row_tasks_cover_each_row_once(name):
    # K5's schedule: every row in exactly one task, the hub rows (more
    # than hub_edges edges, each alone) first, then warp tasks of at most
    # 32 consecutive rows in row order, gathering at most 2 * task_edges
    # unless alone.
    rp = _push_row_ptr(name)
    n, lens = rp.shape[0] - 1, np.diff(rp)
    task_edges, hub_edges = tseg.PUSH_TASK_EDGES
    t = tseg.push_row_tasks(rp, CPU)
    tasks = t.tasks.numpy()
    assert t.nrows == n and tasks.shape == (t.n_tasks, 2)
    seen = np.zeros(n, np.int64)
    for lo, hi in tasks:
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    hubs, warps = tasks[:t.n_hub], tasks[t.n_hub:]
    assert np.all(hubs[:, 1] - hubs[:, 0] == 1)
    assert np.array_equal(np.sort(hubs[:, 0]),
                          np.flatnonzero(lens > hub_edges))
    assert np.all(np.diff(warps[:, 0]) > 0)
    size = warps[:, 1] - warps[:, 0]
    assert np.all((size >= 1) & (size <= tseg.TASK_ROWS))
    edges = rp[warps[:, 1]] - rp[warps[:, 0]]
    assert np.all((edges <= 2 * task_edges) | (size == 1))
    if name == "one row":
        assert (t.n_hub, t.n_tasks) == (1, 1)
    if name == "empty rows":
        assert np.any(lens == 0) and t.n_hub > 0


def test_push_executors_build_row_tasks_and_no_items(monkeypatch):
    # On the card the push executors give K5 the RowTasks of each CSC
    # they run it over, with K5's thresholds (built here on the CPU from
    # the device the executor names), and no work items; on the CPU,
    # none.
    from lux_tpu_torch.engine import sharded
    from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor

    built = []
    real = tseg.RowTasks.build

    def spy(row_ptr, device, *a):
        built.append(torch.device(device).type)
        return real(row_ptr, CPU, *a)

    monkeypatch.setattr(tseg.RowTasks, "build", staticmethod(spy))
    g = tgen.rmat(10, 8, seed=0)
    for blocked in (True, False):
        ex = tpush.PushExecutor(g, SSSP(), device="meta",
                                blocked_dense=blocked)
        assert not hasattr(ex, "items")
        want = real(g.row_ptr, CPU, *tseg.PUSH_TASK_EDGES)
        assert torch.equal(ex.tasks.tasks, want.tasks)
        sx = ShardedPushExecutor(g, SSSP(), num_parts=4, device="meta",
                                 blocked_dense=blocked)
        for q, part in enumerate(sx._parts):
            want = real(sx.sg.local_row_ptr[q], CPU,
                        *tseg.PUSH_TASK_EDGES)
            assert torch.equal(part.tasks.tasks, want.tasks)
            assert part.tasks.n_hub == want.n_hub
    assert built and set(built) == {"meta"}
    assert "items" not in {f.name for f in
                           sharded.dataclasses.fields(sharded.Part)}
    assert tpush.PushExecutor(g, SSSP(), device="cpu").tasks is None
    cpu = ShardedPushExecutor(g, SSSP(), num_parts=4, device="cpu")
    assert all(part.tasks is None for part in cpu._parts)


# -- plain versions of K5-K7 against the lux_tpu code they replace ----------


def _state(nv, seed, frac, cap=None):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, nv, size=nv).astype(np.uint32)
    vals[rng.random(nv) < 0.3] = nv
    fr = rng.random(nv) < frac
    if cap is not None:
        fr[np.flatnonzero(fr)[cap:]] = False
    return vals, fr


@pytest.mark.parametrize("app", ["sssp", "cc"])
def test_dense_plain_matches_blocked_and_plain_dense(app):
    jg, tg = _graphs("gnp1000" if app == "sssp" else "cc400_weighted")
    jprog, tprog = _programs(app)
    for seed, frac in ((1, 0.3), (2, 1.0), (3, 0.0)):
        vals, fr = _state(jg.nv, seed, frac)
        js = jpush.PushState(jnp.asarray(vals), jnp.asarray(fr))
        want = []
        for blocked in (True, False):
            jex = jpush.PushExecutor(jg, jprog, blocked_dense=blocked)
            dg = jex._dg
            if blocked:
                acc = jex._bd_comp(jex._bd_load(js, dg), dg)
            else:
                acc = jex._d_comp(*jex._d_load(js, dg), dg)
            want.append(np.asarray(acc))
        np.testing.assert_array_equal(want[0], want[1])
        tv, tf = tseg.to_u32_storage(vals), torch.from_numpy(fr)
        rp = torch.from_numpy(tg.row_ptr)
        cs = torch.from_numpy(tg.col_src)
        w = None if tg.weights is None else torch.from_numpy(tg.weights)
        for table, front in ((tv, tf), (tseg.pack_words(tv, tf), None)):
            got = tseg.segment_minmax_relax(rp, cs, table, front,
                                            tprog.combiner, tprog.relax_op,
                                            relax=tprog.relax, weights=w)
            np.testing.assert_array_equal(tseg.u32_to_numpy(got), want[0])
            got = tseg.segment_minmax_relax(rp, cs, table, front,
                                            tprog.combiner, tprog.relax_op)
            np.testing.assert_array_equal(tseg.u32_to_numpy(got), want[0])


@pytest.mark.parametrize("app", ["sssp", "cc"])
def test_sparse_plain_matches_s_load_s_comp_s_update(app):
    jg, tg = _graphs("gnp2000_sparse" if app == "sssp" else "cc400_weighted")
    jprog, tprog = _programs(app)
    jex = jpush.PushExecutor(jg, jprog)
    Q, E = jex.tiers[-1]
    csr = tg.csr()
    rp = torch.from_numpy(csr.row_ptr)
    w = None if csr.weights is None else torch.from_numpy(csr.weights)
    for seed, cap in ((4, 40), (5, 1), (6, 0)):
        vals, fr = _state(jg.nv, seed, 0.05, cap=cap)
        cnt = int(fr.sum())
        js = jpush.PushState(jnp.asarray(vals), jnp.asarray(fr))
        jq, jstart, jdeg = (np.asarray(a) for a in jex._s_load(js, jex._dg, Q))
        tv = tseg.to_u32_storage(vals)
        q, start, deg, offs = tfq.frontier_queue(torch.from_numpy(fr), rp, cnt)
        np.testing.assert_array_equal(q.numpy(), jq[:cnt])
        np.testing.assert_array_equal(start.numpy(), jstart[:cnt])
        np.testing.assert_array_equal(deg.numpy(), jdeg[:cnt])
        assert np.all(jq[cnt:] == jg.nv) and np.all(jdeg[cnt:] == 0)
        np.testing.assert_array_equal(offs.numpy()[1:], np.cumsum(jdeg[:cnt]))
        total = int(offs[-1])
        assert total <= E
        cand, dst = jex._s_comp(js, *jex._s_load(js, jex._dg, Q), jex._dg, E)
        jnew, jcnt = jex._s_update(js, cand, dst)
        for relax in (tprog.relax, None):
            got = tfq.queue_relax_scatter(
                q, start, offs, torch.from_numpy(csr.col_dst), tv,
                tprog.combiner, tprog.relax_op, total, relax=relax, weights=w)
            np.testing.assert_array_equal(tseg.u32_to_numpy(got),
                                          np.asarray(jnew.values))
        assert int((got != tv).sum()) == int(jcnt)


# -- oracles and the checker ------------------------------------------------


@pytest.mark.parametrize("name", ["gnp400", "rmat10_sssp", "path20",
                                  "cc300", "rmat10_cc", "cc400_weighted"])
def test_oracles_and_checker_match_lux_tpu(name):
    _, app, _, rkw = GRAPHS[name]
    jg, tg = _graphs(name)
    jprog, tprog = _programs(app)
    if app == "sssp":
        for start in (rkw["start"], 7):
            want = jref_sssp(jg, start=start)
            got = reference_sssp(tg, start=start)
            assert got.dtype == np.uint32
            np.testing.assert_array_equal(got, want)
    else:
        want = jref_cc(jg)
        got = reference_components(tg)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    assert tcheck.count_violations(tg, got, tprog, device="cpu") == 0
    assert tcheck.check(tg, got, tprog, verbose=False, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        bad = got.copy()
        idx = rng.choice(tg.nv, size=max(tg.nv // 10, 1), replace=False)
        bad[idx] = rng.choice(np.array([0, 1, tg.nv, 0xFFFFFFFF], np.uint32),
                              size=idx.size)
        want_n = jcheck.count_violations(jg, bad, jprog)
        assert tcheck.count_violations(tg, bad, tprog, device="cpu") == want_n
        assert tcheck.count_violations(tg, tseg.to_u32_storage(bad), tprog,
                                       device="cpu") == want_n


def test_sssp_detects_bad_values():
    jg, tg = jgen.gnp(100, 600, seed=1), tgen.gnp(100, 600, seed=1)
    vals = np.ones(tg.nv, np.uint32)
    vals[tg.col_src[0]] = 0
    vals[tg.col_dst[0]] = 5       # 5 > 0 + 1: a violation
    got = tcheck.count_violations(tg, vals, SSSP(), device="cpu")
    assert got >= 1
    assert got == jcheck.count_violations(jg, vals, JSSSP())
    assert not tcheck.check(tg, vals, SSSP(), verbose=False, device="cpu")


# -- guards -----------------------------------------------------------------


class _Unpackable(SSSP):
    packable_values = False


class _JUnpackable(JSSSP):
    packable_values = False


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("graph,tprog,jprog", [
    (types.SimpleNamespace(nv=100, ne=10, weights=None), _Unpackable(),
     _JUnpackable()),
    (types.SimpleNamespace(nv=2**31, ne=10, weights=None), SSSP(), JSSSP()),
    (types.SimpleNamespace(nv=100, ne=2**31, weights=None), SSSP(), JSSSP()),
])
def test_blocked_dense_value_errors_match_lux_tpu(graph, tprog, jprog):
    got = _message(lambda: tpush.PushExecutor(graph, tprog, device="cpu",
                                              blocked_dense=True))
    want = _message(lambda: jpush.PushExecutor(graph, jprog,
                                               blocked_dense=True))
    assert got == want


def test_needs_weights_value_error():
    class Weighted(SSSP):
        needs_weights = True

    with pytest.raises(ValueError, match="edge-weighted"):
        tpush.PushExecutor(tgen.gnp(50, 200, seed=1), Weighted(),
                           device="cpu")


def test_frontier_queue_refuses_more_vertices_than_int32_ids():
    # The queue holds int32 ids; a frontier past 2^31 - 1 vertices raises
    # before anything is read (an expanded view: no memory is touched).
    fr = torch.zeros(1, dtype=torch.bool).expand(2 ** 31)
    rp = torch.zeros(1, dtype=torch.int64).expand(2 ** 31 + 1)
    with pytest.raises(ValueError, match="int32"):
        tfq.frontier_queue(fr, rp, 0)
    small = torch.zeros(2 ** 10, dtype=torch.bool)
    small[-1] = True
    q, start, deg, offs = tfq.frontier_queue(
        small, torch.arange(2 ** 10 + 1, dtype=torch.int64), 1)
    assert q.tolist() == [2 ** 10 - 1] and offs.tolist() == [0, 1]


def test_executor_without_device_or_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpush.PushExecutor(tgen.gnp(50, 200, seed=1), SSSP())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcheck.count_violations(tgen.gnp(50, 200, seed=1),
                                np.zeros(50, np.uint32), SSSP())
