"""Port parity: the sharded GAS engines (``ShardedAdaptiveExecutor``,
``ShardedMultiSourceGasExecutor``) against lux_tpu's.

On the CPU the port's executors run the plain versions of K10 (per
part), K6 (per part) and K11 (over the P receivers at once). These tests
use ``tests/test_gas_sharded.py``'s graph, ``rmat(8, 8, seed=5,
weighted=True)`` made by both packages, and hold the port against
``lux_tpu``'s executors on its 8-device virtual CPU mesh:

- per iteration against ``lux_tpu``'s ``ShardedAdaptiveExecutor.
  phase_step`` at P = 4, for the six frontier programs in the full,
  compact and frontier exchange modes: values and frontier bitwise, the
  branch taken and the downgrade flag equal, up to the same fixpoint;
- ``run()`` against the single-device executors of both packages for P
  in {1, 2, 4, 8} (``lux_tpu``'s sharded ``run()`` of a frontier
  program fails under its JAX, in ``push.py::_chunk_while``); the
  frontier-less programs and the multi-source executor against
  ``lux_tpu``'s sharded ``run()``, which works;
- the reference file's edge cases, the host tables (exchange mode,
  ``frontier_cap``, ``exchange_bytes_per_iter``, ``frontier_evidence``),
  K11's P-receiver plain version against P one-receiver calls and
  ``lux_tpu``'s per-shard ``_push_comp``, and the registry.

PageRank is held at rtol=5e-5, atol=1e-9 and CF at rtol=1e-4, atol=1e-7
(their sums run in another order); everything else bitwise. The kernels
on the card are tested by tests/test_torch_cuda.py.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu import models as jmodels
from lux_tpu.engine import gas as jgas
from lux_tpu.engine import gas_sharded as jgs
from lux_tpu.graph import generate as jgen
from lux_tpu.utils import flags as jflags
from lux_tpu_torch import models as tmodels
from lux_tpu_torch.engine import gas as tgas
from lux_tpu_torch.engine import gas_sharded as tgs
from lux_tpu_torch.entry import dryrun_multichip
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.models.bfs import reference_bfs
from lux_tpu_torch.ops import frontier as tfq
from lux_tpu_torch.parallel.mesh import FrontierExchange
from lux_tpu_torch.utils import flags as tflags

CPU = "cpu"
# Per-program init kwargs and, for the frontier-less programs, the
# iteration budget run() requires (tests/test_gas_sharded.py's).
INIT = {
    "pagerank": {}, "sssp": {"start": 1}, "components": {},
    "colfilter": {}, "bfs": {"start": 1}, "sssp_delta": {"start": 0},
    "labelprop": {}, "kcore": {},
}
MAXIT = {"pagerank": 6, "colfilter": 4}
FRONTIER_APPS = ["bfs", "sssp", "sssp_delta", "components", "labelprop",
                 "kcore"]
MODES = ["full", "compact", "frontier"]
PARTS = [1, 2, 4, 8]
TOL = {"pagerank": (5e-5, 1e-9), "colfilter": (1e-4, 1e-7)}
_GRAPHS = {}
_JAX = {}


def _graphs():
    if not _GRAPHS:
        _GRAPHS["g"] = (jgen.rmat(8, 8, seed=5, weighted=True),
                        tgen.rmat(8, 8, seed=5, weighted=True))
    return _GRAPHS["g"]


def _u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _port(name, mode, monkeypatch, parts=4, **kw):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    _, tg = _graphs()
    prog = tgas.as_gas(tmodels.get_program(name))
    return tgs.ShardedAdaptiveExecutor(
        tg, tmodels.get_program(name), num_parts=parts,
        mode="adaptive" if prog.frontier else None, device=CPU, **kw)


def _jax_sharded(name, mode, monkeypatch, parts=4, **kw):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    jg, _ = _graphs()
    prog = jgas.as_gas(jmodels.get_program(name))
    return jgs.ShardedAdaptiveExecutor(
        jg, jmodels.get_program(name), num_parts=parts,
        mode="adaptive" if prog.frontier else None, **kw)


def _jax_phases(name, mode, monkeypatch):
    """lux_tpu's per-iteration (values, frontier, total, branch,
    downgraded) of ``phase_step`` at P = 4, cached."""
    key = ("phases", name, mode)
    if key not in _JAX:
        ex = _jax_sharded(name, mode, monkeypatch)
        st = ex.init_state(**INIT[name])
        steps = []
        for _ in range(64):
            st, total, info = ex.phase_step(st)
            steps.append((np.asarray(st.values), np.asarray(st.frontier),
                          total, info["branch"], info["downgraded"]))
            if total == 0:
                break
        _JAX[key] = steps
    return _JAX[key]


def _jax_single(name, mode="adaptive", start=None):
    """lux_tpu's single-device AdaptiveExecutor (values, iterations)."""
    key = ("single", name, mode, start)
    if key not in _JAX:
        jg, _ = _graphs()
        prog = jgas.as_gas(jmodels.get_program(name))
        kw = dict(INIT[name]) if start is None else {"start": start}
        ex = jgas.AdaptiveExecutor(jg, prog,
                                   mode=mode if prog.frontier else None)
        st, iters = ex.run(max_iters=MAXIT.get(name), **kw)
        _JAX[key] = (np.asarray(st.values), iters)
    return _JAX[key]


# -- per iteration against lux_tpu's phase_step ----------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FRONTIER_APPS)
def test_phase_steps_match_lux_tpu(name, mode, monkeypatch):
    want = _jax_phases(name, mode, monkeypatch)
    ex = _port(name, mode, monkeypatch)
    assert ex.exchange_mode == mode
    st = ex.init_state(**INIT[name])
    branches = []
    for i, (vals, front, total, branch, down) in enumerate(want):
        st, got_total, info = ex.phase_step(st)
        where = f"{name} {mode} iteration {i + 1}"
        np.testing.assert_array_equal(_u32(st.values.numpy()), vals,
                                      err_msg=where)
        np.testing.assert_array_equal(st.frontier.numpy(), front,
                                      err_msg=where)
        assert (got_total, info["branch"], info["downgraded"]) == (
            total, branch, down), where
        branches.append(info["branch"])
    assert got_total == 0
    # Every frontier program pushes at least once on this graph.
    assert "push" in branches
    # run() takes the same branches, and its ledger counts them.
    state, iters = ex.run(**INIT[name])
    assert [e[3] for e in ex.direction_log] == branches
    assert iters == len(want)
    assert ex.push_iters == branches.count("push")
    assert ex.pull_iters == iters - ex.push_iters
    assert ex.exchange_downgrades == branches.count("pull/downgraded")
    assert ex.direction_switches == tgas.count_switches(
        [e[0] for e in ex.direction_log])
    np.testing.assert_array_equal(_u32(state.values.numpy()), want[-1][0])


# -- run() against the single-device executors -----------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", FRONTIER_APPS)
def test_run_matches_single_device(name, parts, mode, monkeypatch):
    ref_vals, ref_iters = _jax_single(name)
    ex = _port(name, mode, monkeypatch, parts=parts)
    st, iters = ex.run(**INIT[name])
    got = ex.gather_values(st)
    assert got.dtype == ref_vals.dtype and got.shape == ref_vals.shape
    np.testing.assert_array_equal(got, ref_vals)
    assert iters == ref_iters
    _, tg = _graphs()
    single = tgas.AdaptiveExecutor(
        tg, tgas.as_gas(tmodels.get_program(name)), device=CPU,
        mode="adaptive")
    sst, siters = single.run(**INIT[name])
    np.testing.assert_array_equal(got, single.values(sst))
    assert siters == iters


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["pagerank", "colfilter"])
def test_frontierless_matches_lux_tpu(name, mode, monkeypatch):
    key = ("frontierless", name, mode)
    if key not in _JAX:
        jex = _jax_sharded(name, mode, monkeypatch, parts=8)
        st, iters = jex.run(max_iters=MAXIT[name])
        _JAX[key] = (jex.gather_values(st), iters, jex.exchange_mode)
    want, jiters, jmode = _JAX[key]
    ex = _port(name, mode, monkeypatch, parts=8)
    assert ex.exchange_mode == jmode != "frontier"
    st, iters = ex.run(max_iters=MAXIT[name])
    got = ex.gather_values(st)
    rtol, atol = TOL[name]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert iters == jiters == MAXIT[name]
    assert ex.direction_log and all(e[3] == "pull/dense"
                                    for e in ex.direction_log)
    # The single-device port within the same tolerance.
    ref, _ = _jax_single(name)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    if mode != "full":
        full = _port(name, "full", monkeypatch, parts=8)
        fst, _ = full.run(max_iters=MAXIT[name])
        assert torch.equal(st.values, fst.values)


def test_frontierless_needs_max_iters_and_the_adapter(monkeypatch):
    ex = _port("pagerank", "full", monkeypatch)
    with pytest.raises(ValueError, match="max_iters"):
        ex.run()
    _, tg = _graphs()

    class Bare(tgas.GasProgram):
        frontier = False

    with pytest.raises(TypeError, match="PullGasAdapter"):
        tgs.ShardedAdaptiveExecutor(tg, Bare(), num_parts=2, device=CPU)


# -- multi-source ------------------------------------------------------------


@pytest.mark.parametrize("name,mode", [("bfs", "full"), ("bfs", "compact"),
                                       ("bfs", "frontier"),
                                       ("sssp_delta", "compact")])
def test_multi_source_matches_lux_tpu(name, mode, monkeypatch):
    roots = [2, 9, 17]
    jg, tg = _graphs()
    key = ("multi", name, mode)
    if key not in _JAX:
        monkeypatch.setenv("LUX_EXCHANGE", mode)
        jmx = jgs.ShardedMultiSourceGasExecutor(
            jg, jmodels.get_program(name), k=4, num_parts=8)
        st, iters = jmx.run(roots)
        _JAX[key] = (jmx.gather_values(st), iters, jmx.exchange_mode)
    want, jiters, jmode = _JAX[key]
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    mx = tgs.ShardedMultiSourceGasExecutor(
        tg, tmodels.get_program(name), k=4, num_parts=8, device=CPU)
    # The K-lane exchange has no single-lane activity plane: frontier
    # runs the static compact plan.
    assert mx.exchange_mode == jmode == ("full" if mode == "full"
                                         else "compact")
    st, iters = mx.run(roots)
    assert iters == jiters and mx.pull_iters == iters
    assert (mx.push_iters, mx.exchange_downgrades) == (0, 0)
    got = mx.gather_values(st)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (tg.nv, 4)
    single = tgas.AdaptiveExecutor(
        tg, tgas.as_gas(tmodels.get_program(name)), device=CPU)
    for j, r in enumerate(roots + [roots[-1]]):
        sst, _ = single.run(start=r)
        np.testing.assert_array_equal(mx.values_for(st, j),
                                      single.values(sst),
                                      err_msg=f"lane {j} root {r}")
        assert mx.finalize_for(st, j).keys() == single.finalize(sst).keys()


def test_multi_source_refusals_step_and_phase_step(monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE", "compact")
    _, tg = _graphs()
    with pytest.raises(ValueError, match="k must be"):
        tgs.ShardedMultiSourceGasExecutor(tg, tmodels.get_program("bfs"), 0,
                                          num_parts=2, device=CPU)
    with pytest.raises(ValueError, match="frontier-less"):
        tgs.ShardedMultiSourceGasExecutor(tg, tmodels.get_program("pagerank"),
                                          2, num_parts=2, device=CPU)
    mx = tgs.ShardedMultiSourceGasExecutor(tg, tmodels.get_program("bfs"), 2,
                                           num_parts=4, device=CPU)
    with pytest.raises(ValueError, match="roots"):
        mx.init_state([1, 2, 3])
    st0 = mx.init_state([1, 5])
    stepped, cnt = mx.step(st0)
    phased, pcnt, times = mx.phase_step(st0)
    assert cnt == pcnt and torch.equal(stepped.values, phased.values)
    assert set(times) == {"loadTime", "compTime", "updateTime", "branch"}
    mx.warmup(start=1)
    assert mx.exchange_bytes_per_iter() == mx._xplan.exchange_bytes_per_iter(
        2 * 5)


# -- the reference file's edge cases ----------------------------------------


@pytest.mark.parametrize("mode", ["compact", "frontier"])
def test_empty_frontier_iteration_is_identity(mode, monkeypatch):
    ex = _port("bfs", mode, monkeypatch)
    state = ex.init_state(start=1)
    empty = tgas.GasState(state.values, state.frontier & False, 0)
    before = ex.gather_values(empty)
    new_state, cnt = ex.step(empty)
    assert cnt == 0
    np.testing.assert_array_equal(ex.gather_values(new_state), before)
    assert not new_state.frontier.any()
    # A run from it still takes one (push) iteration, as lux_tpu's.
    _, iters = ex.run(state=empty)
    assert iters == 1 and ex.direction_log[0][3] == "push"


def test_dense_frontier_self_downgrades(monkeypatch):
    ex = _port("labelprop", "frontier", monkeypatch, parts=8)
    assert ex.exchange_mode == "frontier"
    st, _ = ex.run()
    assert ex.exchange_downgrades >= 1
    assert ex.direction_log[0][3] == "pull/downgraded"
    np.testing.assert_array_equal(ex.gather_values(st),
                                  _jax_single("labelprop")[0])


def test_tiny_capacity_overflow_downgrades_not_truncates(monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE_FRONTIER_FRAC", "0.001")
    ex = _port("bfs", "frontier", monkeypatch, parts=8)
    assert ex.exchange_mode == "frontier" and ex.frontier_cap >= 1
    st, iters = ex.run(start=1)
    assert ex.exchange_downgrades >= 1
    assert iters == _jax_single("bfs")[1]
    np.testing.assert_array_equal(ex.gather_values(st), _jax_single("bfs")[0])


def test_p1_exchange_is_inert(monkeypatch):
    ex = _port("bfs", "frontier", monkeypatch, parts=1)
    assert ex.exchange_mode == "full" and ex._xplan is None
    assert ex.exchange_bytes_per_iter() == 0
    assert ex.frontier_evidence() is None
    st, iters = ex.run(start=1)
    assert iters == _jax_single("bfs")[1]
    np.testing.assert_array_equal(ex.gather_values(st), _jax_single("bfs")[0])


def test_bfs_parent_plane_under_frontier(monkeypatch):
    ex = _port("bfs", "frontier", monkeypatch, parts=8)
    st, _ = ex.run(start=1)
    _, tg = _graphs()
    depth_ref, parent_ref = reference_bfs(tg, start=1)
    np.testing.assert_array_equal(ex.gather_values(st), depth_ref)
    np.testing.assert_array_equal(ex.finalize(st)["parent"], parent_ref)


@pytest.mark.parametrize("mode", ["compact", "frontier"])
@pytest.mark.parametrize("pin", ["push", "pull"])
@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_pinned_directions_parity(name, pin, mode, monkeypatch):
    ref_vals, _ = _jax_single(name, mode=pin)
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    _, tg = _graphs()
    ex = tgs.ShardedAdaptiveExecutor(tg, tmodels.get_program(name),
                                     num_parts=2, mode=pin, device=CPU)
    st, _ = ex.run(**INIT[name])
    np.testing.assert_array_equal(ex.gather_values(st), ref_vals)
    if pin == "pull":
        assert ex.push_iters == 0
    else:
        assert ex.push_iters > 0


def test_adaptive_switches_direction(monkeypatch):
    ex = _port("bfs", "frontier", monkeypatch, parts=8)
    ex.warmup(start=1)
    st, _ = ex.run(start=7)
    assert ex.push_iters > 0 and ex.pull_iters > 0
    assert ex.direction_switches >= 1
    np.testing.assert_array_equal(ex.gather_values(st),
                                  _jax_single("bfs", start=7)[0])


# -- host tables --------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("name", ["bfs", "sssp_delta", "pagerank"])
def test_host_tables_match_lux_tpu(name, parts, mode, monkeypatch):
    jex = _jax_sharded(name, mode, monkeypatch, parts=parts)
    ex = _port(name, mode, monkeypatch, parts=parts)
    assert (ex.exchange_mode, ex.frontier_cap) == (jex.exchange_mode,
                                                   jex.frontier_cap)
    assert ex.exchange_bytes_per_iter() == jex.exchange_bytes_per_iter()
    assert ex.frontier_evidence() == jex.frontier_evidence()
    assert (ex.hi_count, ex.lo_count) == (jex.hi_count, jex.lo_count)
    if ex.program.frontier:
        assert (ex.queue_cap, ex.edge_budget) == (jex.queue_cap,
                                                  jex.edge_budget)
        assert ex._row_bytes == jex._row_bytes()
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    jg, tg = _graphs()
    if name != "pagerank":
        jmx = jgs.ShardedMultiSourceGasExecutor(
            jg, jmodels.get_program(name), k=3, num_parts=parts)
        mx = tgs.ShardedMultiSourceGasExecutor(
            tg, tmodels.get_program(name), k=3, num_parts=parts, device=CPU)
        assert mx.exchange_mode == jmx.exchange_mode
        assert mx.exchange_bytes_per_iter() == jmx.exchange_bytes_per_iter()


def test_frontier_tables_hold_the_active_rows(monkeypatch):
    # The frontier send's tables equal the compact ones on every row an
    # edge reads whose source is active, and are (0, False) on the other
    # rows of remote parts (the receiver's own span is its shard); the
    # widest pair count is the reference's admission input.
    ex = _port("bfs", "frontier", monkeypatch, parts=4)
    jex = _jax_sharded("bfs", "frontier", monkeypatch, parts=4)
    rng = np.random.default_rng(0)
    vals = ex._padded(rng.integers(0, 2**32, ex.graph.nv, dtype=np.uint64)
                      .astype(np.uint32))
    front = ex._padded(rng.random(ex.graph.nv) < 0.05)
    widest = ex._fx.widest(front)
    send = jex._xplan.send_units.reshape(4, 4, -1)
    f = front.numpy()
    act = (send < ex.sg.max_nv) & np.take_along_axis(
        f[:, None, :].repeat(4, 1), np.minimum(send, ex.sg.max_nv - 1), 2)
    np.testing.assert_array_equal(widest.numpy(), act.sum(2).max(1))
    assert int(widest.max()) <= ex.frontier_cap
    tv, tf = ex._fx.tables(vals, front)
    cv, cf = ex._xch.tables(vals), ex._xch.tables(front)
    for q, part in enumerate(ex._parts):
        read = part.col_src.long()
        on = cf[q][read]
        assert torch.equal(tf[q][read], on)
        assert torch.equal(tv[q][read][on], cv[q][read][on])
        remote = read // ex.sg.max_nv != q
        assert not tv[q][read][~on & remote].any()
        own = ~remote
        assert torch.equal(tv[q][read][own], cv[q][read][own])


def test_frontier_exchange_refuses_a_bad_capacity(monkeypatch):
    ex = _port("bfs", "frontier", monkeypatch, parts=4)
    for cap in (0, ex._xplan.capacity + 1):
        with pytest.raises(ValueError, match="frontier capacity"):
            FrontierExchange(ex._xplan, ex.mesh, ex.sg.max_nv, cap)


# -- K11 over P receivers -------------------------------------------------


@pytest.mark.parametrize("name", FRONTIER_APPS)
def test_k11_receivers_match_one_receiver_calls_and_lux_tpu(name,
                                                            monkeypatch):
    ex = _port(name, "full", monkeypatch)
    jex = _jax_sharded(name, "full", monkeypatch)
    ex.run(**INIT[name])
    pushes = [i for i, e in enumerate(ex.direction_log) if e[0] == 1]
    assert pushes
    st, _ = ex.run(max_iters=pushes[-1], **INIT[name]) if pushes[-1] \
        else (ex.init_state(**INIT[name]), 0)
    stats = ex._frontier_stats(st)
    rows, ids = ex._push_load(st, stats)
    got = ex._push_acc(st, (rows, ids), stats)
    prog = ex.program
    start, offs = ex._ranges(ids)
    assert int(offs[:, -1].sum()) == stats.out_edges
    flat = st.values.reshape(-1)
    for p in range(ex.num_parts):
        one = tfq.gas_push_acc(
            rows, start[p], offs[p], ex.push_dst_local[p], flat,
            prog.combiner, prog.gather_op, int(offs[p, -1]),
            weights=None if ex.push_weights is None else ex.push_weights[p])
        assert torch.equal(one[:ex.sg.max_nv], got[p])
        # lux_tpu's per-shard push: the all-gathered queue of global ids
        # and their values, expanded through shard p's push CSR.
        dg = {k: v[p:p + 1] for k, v in jex._dg.items()}
        want = jex._push_comp(jnp.asarray(ids.numpy().astype(np.int32)),
                              jnp.asarray(_u32(flat[rows.long()].numpy())),
                              dg)
        np.testing.assert_array_equal(_u32(got[p].numpy()), np.asarray(want))


# -- API, registry, flags, entry -------------------------------------------


def test_step_phase_step_warmup_and_finalize(monkeypatch):
    for name in ("kcore", "pagerank"):
        ex = _port(name, "frontier", monkeypatch)
        st0 = ex.init_state(**INIT[name])
        ex.warmup_phases(st0)
        ex.warmup(**INIT[name])
        stepped, cnt = ex.step(st0)
        phased, pcnt, times = ex.phase_step(st0)
        assert cnt == pcnt
        assert torch.equal(stepped.values, phased.values)
        assert {"loadTime", "compTime", "updateTime", "branch",
                "downgraded"} <= set(times)
        if name == "kcore":
            st, _ = ex.run()
            fin = ex.finalize(st)
            _, tg = _graphs()
            single = tgas.AdaptiveExecutor(
                tg, tgas.as_gas(tmodels.get_program(name)), device=CPU)
            sst, _ = single.run()
            assert fin["core_size"] == single.finalize(sst)["core_size"]
        else:
            assert times["branch"] == "pull/dense"
    _, iters = ex.run(max_iters=2, chunk=0)
    assert iters == 0


def test_signatures_match_lux_tpu():
    for mine, theirs in ((tgs.ShardedAdaptiveExecutor,
                          jgs.ShardedAdaptiveExecutor),
                         (tgs.ShardedMultiSourceGasExecutor,
                          jgs.ShardedMultiSourceGasExecutor)):
        params = list(inspect.signature(theirs.__init__).parameters)
        assert list(inspect.signature(mine.__init__).parameters) == \
            params + ["device"]
        run = list(inspect.signature(theirs.run).parameters)
        assert sorted(inspect.signature(mine.run).parameters) == sorted(run)
        for method in ("init_state", "step", "warmup", "gather_values",
                       "exchange_bytes_per_iter"):
            assert hasattr(mine, method), method
    for method in ("phase_step", "warmup_phases", "finalize",
                   "frontier_evidence"):
        assert hasattr(tgs.ShardedAdaptiveExecutor, method)
    assert hasattr(tgs.ShardedMultiSourceGasExecutor, "finalize_for")


def test_engine_kinds_match_lux_tpu():
    for name in tmodels.PROGRAMS:
        mine, theirs = tmodels.ENGINE_KINDS[name], jmodels.ENGINE_KINDS[name]
        for kind in ("gas_sharded", "gas_multi_sharded"):
            assert (kind in mine) == (kind in theirs), (name, kind)
        assert "gas_sharded" in mine
        assert ("gas_multi_sharded" in mine) == (name in tmodels.ROOTED_APPS)


def test_frontier_frac_flag_matches_lux_tpu(monkeypatch):
    name = "LUX_EXCHANGE_FRONTIER_FRAC"
    mine, theirs = tflags._flag(name), jflags._flag(name)
    assert (mine.default, mine.doc, mine.kind) == (
        theirs.default, theirs.doc, theirs.kind)
    monkeypatch.setenv(name, "0.5")
    assert tflags.get_float(name) == jflags.get_float(name) == 0.5


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = _graphs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgs.ShardedAdaptiveExecutor(tg, tmodels.get_program("bfs"),
                                    num_parts=2)


@pytest.mark.parametrize("mode", MODES)
def test_dryrun_multichip_runs_the_sharded_gas_bfs(mode, monkeypatch, capsys):
    monkeypatch.setenv("LUX_EXCHANGE", mode)
    dryrun_multichip(4, device=CPU)
    out = capsys.readouterr().out
    assert "adaptive GAS BFS" in out and f"GAS exchange {mode}" in out

