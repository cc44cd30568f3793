"""Port parity: the sharded push engines (``ShardedPushExecutor``,
``ShardedMultiSourcePushExecutor``) against lux_tpu's.

On the CPU the port's executors run the plain versions of K5, K6, K7
and K10 once per part; these tests hold them against ``lux_tpu``'s
executors on its 8-device virtual CPU mesh, for P in {1, 2, 4, 8}, the
full and compact exchange modes and every ``blocked_dense`` setting,
with the sparse branch on and off: values bitwise, equal
``iterations``, ``sparse_iters`` and ``exchange_bytes_per_iter``. The
per-part kernel calls are held against ``lux_tpu``'s per-shard phase
functions on the same states, compact against full bitwise, and the
sharded results against the single-device port. The kernels on the
card are tested by tests/test_torch_cuda.py.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.engine import push as jpush
from lux_tpu.graph import generate as jgen
from lux_tpu.models.components import ConnectedComponents as JCC
from lux_tpu.models.sssp import SSSP as JSSSP
from lux_tpu.parallel.mesh import make_mesh as jmake_mesh
from lux_tpu.parallel.mesh import parts_sharding
from lux_tpu_torch.engine import push as tpush
from lux_tpu_torch.engine import push_sharded as tps
from lux_tpu_torch.entry import dryrun_multichip
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.models import SSSP, ConnectedComponents
from lux_tpu_torch.models.sssp import reference_sssp
from lux_tpu_torch.ops import frontier as tfq
from lux_tpu_torch.ops import segment as tseg
from lux_tpu_torch.parallel.mesh import LocalMesh, make_mesh
from lux_tpu_torch.parallel.shard import ShardedGraph

CPU = "cpu"
PARTS = [1, 2, 4, 8]
MODES = ["full", "compact"]
BLOCKED = [None, True, False]
# name -> (graph maker over a generate module, app, executor kw, run kw)
APPS = {
    # tests/test_push.py:106: late small frontiers take the sparse branch.
    "sssp": (lambda m: m.gnp(2000, 16000, seed=31), "sssp",
             {"queue_frac": 4, "edge_budget_frac": 2}, {"start": 0}),
    # tests/test_push.py:136: weighted CC, dense first, then sparse.
    "cc_weighted": (
        lambda m: m.undirected(m.gnp(600, 1200, seed=33, weighted=True)),
        "cc", {"queue_frac": 2, "edge_budget_frac": 1}, {}),
    # tests/test_push.py:123: one vertex a step, every iteration sparse.
    "path": (lambda m: m.path_graph(1100), "sssp", {"queue_frac": 1},
             {"start": 0}),
}
_GRAPHS = {}
_JAX = {}


def _graphs(name):
    if name not in _GRAPHS:
        make = APPS[name][0]
        _GRAPHS[name] = (make(jgen), make(tgen))
    return _GRAPHS[name]


def _programs(app):
    return (JSSSP(), SSSP()) if app == "sssp" else (JCC(),
                                                    ConnectedComponents())


def _jax_run(name, parts, sparse):
    """lux_tpu's (values, iterations, sparse_iters), cached: neither the
    exchange mode nor the dense input form changes them."""
    key = ("run", name, parts, sparse)
    if key not in _JAX:
        jg, _ = _graphs(name)
        _, app, kw, rkw = APPS[name]
        ex = jpush.ShardedPushExecutor(jg, _programs(app)[0],
                                       mesh=jmake_mesh(parts), sparse=sparse,
                                       **kw)
        state, iters = ex.run(**rkw)
        _JAX[key] = (ex.gather_values(state), iters, ex.sparse_iters)
    return _JAX[key]


def _jax_exchange(name, parts, mode, blocked, monkeypatch):
    """lux_tpu's (exchange mode, exchange bytes) for a build, cached."""
    key = ("xch", name, parts, mode, blocked)
    if key not in _JAX:
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        jg, _ = _graphs(name)
        _, app, kw, _ = APPS[name]
        ex = jpush.ShardedPushExecutor(jg, _programs(app)[0],
                                       mesh=jmake_mesh(parts),
                                       blocked_dense=blocked, **kw)
        _JAX[key] = (ex.exchange_mode, ex.blocked_dense,
                     ex.exchange_bytes_per_iter())
    return _JAX[key]


def _port(name, parts, mode, monkeypatch, **extra):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    _, tg = _graphs(name)
    _, app, kw, rkw = APPS[name]
    ex = tps.ShardedPushExecutor(tg, _programs(app)[1], num_parts=parts,
                                 device=CPU, **{**kw, **extra})
    return ex, rkw


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("blocked", BLOCKED)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", ["sssp", "cc_weighted"])
def test_sharded_push_matches_lux_tpu(name, parts, mode, blocked, sparse,
                                      monkeypatch):
    ex, rkw = _port(name, parts, mode, monkeypatch, blocked_dense=blocked,
                    sparse=sparse)
    state, iters = ex.run(**rkw)
    got = ex.gather_values(state)
    want, jiters, jsparse = _jax_run(name, parts, sparse)
    assert got.dtype == np.uint32 and got.shape == (ex.graph.nv,)
    np.testing.assert_array_equal(got, want)
    assert (iters, ex.sparse_iters) == (jiters, jsparse)
    assert len(ex.branch_log) == iters
    jmode, jblocked, jbytes = _jax_exchange(name, parts, mode, blocked,
                                            monkeypatch)
    assert (ex.exchange_mode, ex.blocked_dense) == (jmode, jblocked)
    assert ex.exchange_bytes_per_iter() == jbytes
    # The single-device port reaches the same fixpoint in as many steps.
    _, tg = _graphs(name)
    single = tpush.PushExecutor(tg, _programs(APPS[name][1])[1], device=CPU,
                                sparse=sparse)
    sstate, siters = single.run(**rkw)
    np.testing.assert_array_equal(got, single.values(sstate))
    assert siters == iters


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("parts", [2, 8])
def test_all_sparse_path_matches_lux_tpu(parts, mode, monkeypatch):
    ex, rkw = _port("path", parts, mode, monkeypatch)
    assert ex.sparse
    calls = []
    real = tps.queue_relax_scatter

    def spy(q, start, offs, *args, **kw):
        # (receivers, whether the call would launch K7 on the card)
        calls.append((start.shape[0] if start.dim() == 2 else 1,
                      q.numel() > 0 and int(offs[..., -1].sum()) > 0))
        return real(q, start, offs, *args, **kw)

    monkeypatch.setattr(tps, "queue_relax_scatter", spy)
    state, iters = ex.run(**rkw)
    want, jiters, jsparse = _jax_run("path", parts, True)
    np.testing.assert_array_equal(ex.gather_values(state), want)
    np.testing.assert_array_equal(want, np.arange(1100, dtype=np.uint32))
    assert iters == ex.sparse_iters == jiters == jsparse == 1100
    # One vertex a step: one part compacts a queue, and one K7 call takes
    # every receiving part; it launches while the queue has out-edges, as
    # queue_log's K7 entry says.
    assert len(ex.queue_log) == len(calls) == 1100
    assert all(k6 == 1 for k6, _ in ex.queue_log[:-1])
    assert all(p == parts for p, _ in calls)
    assert all(launch for _, launch in calls[:-1])
    assert [k7 for _, k7 in ex.queue_log] == [int(x) for _, x in calls]


@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("name", ["sssp", "cc_weighted"])
def test_compact_equals_full_bitwise(name, parts, monkeypatch):
    runs = {}
    for mode in MODES:
        ex, rkw = _port(name, parts, mode, monkeypatch)
        assert ex.exchange_mode == mode
        runs[mode] = ex.run(**rkw) + (ex.branch_log,)
    (full, fi, flog), (comp, ci, clog) = runs["full"], runs["compact"]
    assert torch.equal(comp.values, full.values)
    assert torch.equal(comp.frontier, full.frontier)
    assert (ci, clog) == (fi, flog)


def test_both_branches_and_both_dense_forms_run(monkeypatch):
    # The grid above must reach both branches and both K5 input forms,
    # or it proves nothing about them.
    for blocked in (True, False):
        ex, rkw = _port("sssp", 4, "full", monkeypatch, blocked_dense=blocked)
        ex.run(**rkw)
        assert ex.blocked_dense == blocked
        assert 0 < ex.sparse_iters < len(ex.branch_log)
        assert len(ex.queue_log) == ex.sparse_iters
        # Per iteration: the branch lux_tpu's pmax/psum rule picks.
        for tier, cnt, out, counts in ex.branch_log:
            assert cnt == sum(counts)
            assert tier == tpush._tier_index(max(counts), out, ex.tiers)


def _random_state(sg, seed, frac):
    """A padded uint32 state below 2**31 with pad vertices at zero and
    off the frontier, as (values, frontier) numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = sg.vertex_mask.shape
    vals = rng.integers(0, sg.graph.nv, size=shape).astype(np.uint32)
    vals[rng.random(shape) < 0.3] = sg.graph.nv
    fr = (rng.random(shape) < frac) & sg.vertex_mask
    return np.where(sg.vertex_mask, vals, 0).astype(np.uint32), fr


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["sssp", "cc_weighted"])
def test_per_part_kernels_match_lux_tpu_phases(name, mode, monkeypatch):
    """K5 per part (dense) and K6 + K7 per part with a split table
    (sparse) against lux_tpu's per-shard phase functions on one state."""
    parts = 4
    ex, _ = _port(name, parts, mode, monkeypatch)
    jg, _ = _graphs(name)
    _, app, kw, _ = APPS[name]
    jex = jpush.ShardedPushExecutor(jg, _programs(app)[0],
                                    mesh=jmake_mesh(parts), **kw)
    assert jex.exchange_mode == ex.exchange_mode == mode
    j, dg = jex._sharded_phase_jits(), jex._dg
    sh = parts_sharding(jex.mesh)
    sparse_checked = 0
    for seed, frac in ((1, 0.02), (2, 0.4)):
        vals, fr = _random_state(ex.sg, seed, frac)
        js = jpush.PushState(jax.device_put(jnp.asarray(vals), sh),
                             jax.device_put(jnp.asarray(fr), sh))
        ts = tpush.PushState(tseg.to_u32_storage(vals), torch.from_numpy(fr))
        stats = ex._frontier_stats(ts)
        # Dense.
        loaded = j["d_load"](js, dg)
        acc, _ = (j["d_comp"](js, loaded, dg) if mode == "compact"
                  else j["d_comp"](loaded, dg))
        jnew, _ = j["update"](js, acc, dg)
        tnew, _ = ex._update(ts.values, ex._new_values(ts, 0, stats))
        np.testing.assert_array_equal(tseg.u32_to_numpy(tnew.values),
                                      np.asarray(jnew.values))
        np.testing.assert_array_equal(tnew.frontier.numpy(),
                                      np.asarray(jnew.frontier))
        # Sparse, in the largest tier, which every such state fits.
        top = len(ex.tiers)
        assert tpush._tier_index(max(stats[2]), 0, ex.tiers) >= 1
        if stats[1] > ex.tiers[-1][1]:
            continue
        all_q, all_qv = j[f"s_load{top - 1}"](js, dg)
        cand, dstl, _ = j[f"s_comp{top - 1}"](all_q, all_qv, dg)
        jnew, _ = j["s_update"](js, cand, dstl, dg)
        tnew, _ = ex._update(ts.values, ex._new_values(ts, top, stats))
        np.testing.assert_array_equal(tseg.u32_to_numpy(tnew.values),
                                      np.asarray(jnew.values))
        sparse_checked += 1
    assert sparse_checked


def test_split_table_wrappers():
    """K7 over P receivers: each combines into its own row of a copy of
    the (P, n) values, its candidates read from the flat table at ``q``;
    K10 reads a table of more rows than its output."""
    g = tgen.gnp(300, 2400, seed=5)
    csr = g.csr()
    rp = torch.from_numpy(csr.row_ptr)
    col_dst = torch.from_numpy(csr.col_dst)
    vals = tseg.to_u32_storage(
        np.random.default_rng(0).integers(0, 300, 600).astype(np.uint32))
    fr = torch.zeros(300, dtype=torch.bool)
    fr[::7] = True
    q, start, _, offs = tfq.frontier_queue(fr, rp, int(fr.sum()))
    # The queued rows sit in the second row of a (2, 300) table; the two
    # receivers take the same ranges into other destinations.
    table = vals.clone().reshape(2, 300)
    rows = q + 300
    starts, offss = torch.stack([start, start]), torch.stack([offs, offs])
    cols = torch.stack([col_dst, 299 - col_dst])
    total = 2 * int(offs[-1])
    for kind, relax_op, red in (("min", "add1", "amin"),
                                ("max", "copy", "amax")):
        got = tfq.queue_relax_scatter(rows, starts, offss, cols, table,
                                      kind, relax_op, total)
        assert got.shape == (2, 300)
        assert torch.equal(table, vals.reshape(2, 300))
        # The per-part loop: receiver p's candidates into row p alone.
        flat = tseg.widen_u32(table).reshape(-1)
        relax = tseg.RELAX_OPS[relax_op]
        for p in range(2):
            slot, edge = tfq.queue_edges(rows, starts[p], offss[p])
            want = tseg.widen_u32(table[p]).scatter_reduce(
                0, cols[p][edge].long(), relax(flat[rows.long()[slot]]),
                reduce=red, include_self=True)
            np.testing.assert_array_equal(tseg.u32_to_numpy(got[p]),
                                          want.numpy().astype(np.uint32))
        # One receiver over its own (n,) values is the single-device form.
        one = tfq.queue_relax_scatter(q, start, offs, col_dst, table[1],
                                      kind, relax_op, int(offs[-1]))
        slot, edge = tfq.queue_edges(q, start, offs)
        own = tseg.widen_u32(table[1])
        want = own.scatter_reduce(0, col_dst[edge].long(),
                                  relax(own[q.long()[slot]]), reduce=red,
                                  include_self=True)
        assert one.shape == (300,)
        np.testing.assert_array_equal(tseg.u32_to_numpy(one),
                                      want.numpy().astype(np.uint32))
        assert not torch.equal(one, table[1])
    # K10 over the first 300 rows' CSC, reading a (600, 3) table.
    lanes = torch.stack([vals, vals.flip(0), vals.roll(5)], 1)
    front = torch.rand(600, 3, generator=torch.Generator().manual_seed(1)) < .3
    rpc = torch.from_numpy(g.row_ptr)
    cs = torch.from_numpy(g.col_src)
    acc = tseg.gas_pull_acc(rpc, cs + 300, lanes, front, "min", "add1")
    assert acc.shape == (300, 3)
    assert torch.equal(acc, tseg.gas_pull_acc(rpc, cs, lanes[300:],
                                              front[300:], "min", "add1"))


def test_validated_sg_errors_and_blocked_log(monkeypatch, capsys):
    monkeypatch.delenv("LUX_EXCHANGE", raising=False)
    _, tg = _graphs("cc_weighted")
    cc = ConnectedComponents()
    with pytest.raises(ValueError, match="3 parts, mesh has 2"):
        tps.ShardedPushExecutor(tg, cc, num_parts=2, device=CPU,
                                sg=ShardedGraph.build(tg, 3))
    with pytest.raises(ValueError, match="different Graph"):
        tps.ShardedMultiSourcePushExecutor(
            tg, cc, 2, num_parts=2, device=CPU,
            sg=ShardedGraph.build(_graphs("sssp")[1], 2))
    with pytest.raises(ValueError, match="differs from the mesh"):
        tps.ShardedPushExecutor(tg, cc, device="meta",
                                mesh=LocalMesh(2, "cpu"))
    sg = ShardedGraph.build(tg, 3)
    ex = tps.ShardedPushExecutor(tg, cc, mesh=make_mesh(3, CPU),
                                 num_parts=7, sg=sg)
    assert ex.num_parts == 3 and ex.sg is sg

    class Wide(ConnectedComponents):
        packable_values = False

    with pytest.raises(ValueError, match="packable_values"):
        tps.ShardedPushExecutor(tg, Wide(), num_parts=2, device=CPU,
                                blocked_dense=True)

    class Weighted(SSSP):
        needs_weights = True

    with pytest.raises(ValueError, match="edge-weighted"):
        tps.ShardedPushExecutor(_graphs("sssp")[1], Weighted(), num_parts=2,
                                device=CPU)
    with pytest.raises(ValueError, match="batch width"):
        tps.ShardedMultiSourcePushExecutor(tg, cc, 0, num_parts=2,
                                           device=CPU)
    capsys.readouterr()
    ex, _ = _port("cc_weighted", 4, "compact", monkeypatch,
                  blocked_dense=True)
    assert (ex.exchange_mode, ex.blocked_dense) == ("full", True)
    assert "no packed blocked form" in capsys.readouterr().err


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = _graphs("cc_weighted")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tps.ShardedPushExecutor(tg, ConnectedComponents(), num_parts=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tps.ShardedMultiSourcePushExecutor(tg, SSSP(), 2, num_parts=2)


def test_step_phase_step_warmup_and_layout(monkeypatch):
    ex, rkw = _port("sssp", 4, "compact", monkeypatch)
    s0 = ex.init_state(**rkw)
    n = ex.sg.max_nv
    assert s0.values.shape == s0.frontier.shape == (4, n)
    np.testing.assert_array_equal(
        ex.gather_values(s0), SSSP().init_values(ex.graph, **rkw))
    ex.warmup_phases(s0)
    state, branches = s0, set()
    while True:
        one, cnt = ex.step(state)
        new, pcnt, times = ex.phase_step(state)
        assert torch.equal(new.values, one.values) and cnt == pcnt
        assert torch.equal(new.frontier, one.frontier)
        assert sorted(times) == ["branch", "compTime", "loadTime",
                                 "updateTime"]
        branches.add(times["branch"].split("/")[0])
        state = new
        if cnt == 0:
            break
    assert branches == {"dense", "sparse"}
    full, iters = ex.run(**rkw)
    assert torch.equal(state.values, full.values)
    one, _ = ex.step(s0)
    warm, rest = ex.run(state=one)
    assert rest == iters - 1 and torch.equal(warm.values, full.values)
    # Pad vertices stay frozen at zero, off the frontier.
    pad = ~ex.vertex_mask
    assert torch.count_nonzero(full.values[pad]) == 0
    assert not full.frontier[pad].any()
    ex.warmup(**rkw)
    np.testing.assert_array_equal(ex.gather_values(full),
                                  reference_sssp(ex.graph, 0))


ROOTS = [0, 9, 33, 1500]


def _jax_multi(k, parts, mode, monkeypatch):
    key = ("multi", k, parts, mode)
    if key not in _JAX:
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        jg, _ = _graphs("sssp")
        ex = jpush.ShardedMultiSourcePushExecutor(jg, JSSSP(), k,
                                                  mesh=jmake_mesh(parts))
        state, iters = ex.run(ROOTS[:k])
        _JAX[key] = (ex.gather_values(state), iters,
                     ex.exchange_bytes_per_iter(), ex.exchange_mode)
    return _JAX[key]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_sharded_multi_source_matches_lux_tpu(k, parts, mode, monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    _, tg = _graphs("sssp")
    roots = ROOTS[:max(k - 1, 1)]       # k = 3, 4: a padded batch
    ex = tps.ShardedMultiSourcePushExecutor(tg, SSSP(), k, num_parts=parts,
                                            device=CPU)
    state, iters = ex.run(roots)
    got = ex.gather_values(state)
    assert got.shape == (tg.nv, k) and got.dtype == np.uint32
    want, jiters, jbytes, jmode = _jax_multi(k, parts, mode, monkeypatch)
    padded = roots + [roots[-1]] * (k - len(roots))
    single = tpush.MultiSourcePushExecutor(tg, SSSP(), k, device=CPU)
    sstate, siters = single.run(padded)
    assert ex.exchange_mode == jmode == mode
    assert ex.exchange_bytes_per_iter() == jbytes
    for j, r in enumerate(padded):
        np.testing.assert_array_equal(ex.values_for(state, j),
                                      single.values_for(sstate, j))
        if r in ROOTS[:k]:
            np.testing.assert_array_equal(got[:, j],
                                          want[:, ROOTS.index(r)])
    assert iters == siters
    assert ex.sparse_iters == 0


@pytest.mark.parametrize("mode", MODES)
def test_multi_source_lanes_match_lux_tpu_phases(mode, monkeypatch):
    """K10 per part with K columns over the flat table, against
    lux_tpu's exchange and compute brackets on one state."""
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    jg, tg = _graphs("sssp")
    ex = tps.ShardedMultiSourcePushExecutor(tg, SSSP(), 3, num_parts=4,
                                            device=CPU)
    jex = jpush.ShardedMultiSourcePushExecutor(jg, JSSSP(), 3,
                                               mesh=jmake_mesh(4))
    j = jex._phase_jits()
    sh = parts_sharding(jex.mesh)
    vals, fr = zip(*(_random_state(ex.sg, s, 0.2) for s in (3, 4, 5)))
    vals, fr = np.stack(vals, -1), np.stack(fr, -1)
    js = jpush.PushState(jax.device_put(jnp.asarray(vals), sh),
                         jax.device_put(jnp.asarray(fr), sh))
    av, af = j["exchange"](js, jex._dg)
    jnew, jcnt = j["compute"](js, av, af, jex._dg)
    ts = tpush.PushState(tseg.to_u32_storage(vals), torch.from_numpy(fr))
    tnew, tcnt = ex._update(ts.values, ex._acc(ex._load(ts)))
    np.testing.assert_array_equal(tseg.u32_to_numpy(tnew.values),
                                  np.asarray(jnew.values))
    assert int(tcnt) == int(np.asarray(jcnt).sum())


def test_multi_source_step_phase_step_warmup(monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE", "compact")
    _, tg = _graphs("sssp")
    ex = tps.ShardedMultiSourcePushExecutor(tg, SSSP(), 2, num_parts=4,
                                            device=CPU)
    s0 = ex.init_state([5])
    assert s0.values.shape == (4, ex.sg.max_nv, 2)
    assert torch.equal(s0.values[..., 0], s0.values[..., 1])
    one, cnt = ex.step(s0)
    new, pcnt, times = ex.phase_step(s0)
    assert torch.equal(new.values, one.values) and cnt == pcnt
    assert sorted(times) == ["branch", "compTime", "loadTime", "updateTime"]
    full, iters = ex.run([5, 7])
    warm, rest = ex.run([5, 7], state=ex.step(ex.init_state([5, 7]))[0])
    assert rest == iters - 1 and torch.equal(warm.values, full.values)
    np.testing.assert_array_equal(ex.values_for(full, 1),
                                  reference_sssp(tg, 7))
    assert ex.run([5], chunk=0)[1] == 0 and ex.run([5], max_iters=2)[1] == 2
    ex.warmup(start=3)
    with pytest.raises(ValueError, match="need 1..2 roots"):
        ex.init_state([1, 2, 3])


def test_signatures_match_lux_tpu():
    for mine, theirs in ((tps.ShardedPushExecutor, jpush.ShardedPushExecutor),
                         (tps.ShardedMultiSourcePushExecutor,
                          jpush.ShardedMultiSourcePushExecutor)):
        got = list(inspect.signature(mine).parameters)
        want = list(inspect.signature(theirs).parameters)
        assert got == want + ["device"]
        for name in ("init_state", "step", "phase_step", "run", "warmup",
                     "exchange_bytes_per_iter", "gather_values"):
            assert hasattr(mine, name)
        run = list(inspect.signature(theirs.run).parameters)
        assert list(inspect.signature(mine.run).parameters) == run
    assert hasattr(tps.ShardedPushExecutor, "warmup_phases")
    assert hasattr(tps.ShardedMultiSourcePushExecutor, "values_for")


@pytest.mark.parametrize("mode", MODES)
def test_dryrun_multichip_runs_pull_and_push(mode, monkeypatch, capsys):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    dryrun_multichip(4, device=CPU)
    out = capsys.readouterr().out
    assert "push CC and SSSP" in out and f"exchange {mode}" in out
