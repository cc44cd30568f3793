"""Port parity: the GAS engine (BFS, DeltaSSSP, label propagation,
k-core, and the push and pull adapters) against lux_tpu's.

On the CPU the GAS kernel wrappers (K10 ``gas_pull_acc``, K6
``frontier_queue``, K11 ``gas_push_acc``) run their plain PyTorch
versions; these tests hold the port's ``AdaptiveExecutor`` and
``MultiSourceGasExecutor`` against ``lux_tpu``'s on JAX's CPU, and each
plain version against the ``lux_tpu`` method it replaces on the same
state. Values are compared bitwise (uint32 and f32), with equal
``iterations``, ``push_iters``, ``pull_iters`` and
``direction_switches``; PageRank through the pull adapter within rtol
5e-5, atol 1e-9. The kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lux_tpu import models as jmodels
from lux_tpu.engine import gas as jgas
from lux_tpu.engine.check import count_violations as jcount
from lux_tpu.graph import generate as jgen
from lux_tpu.graph.graph import Graph as JGraph
from lux_tpu.models import bfs as jbfs
from lux_tpu.models import kcore as jkcore
from lux_tpu.models import labelprop as jlp
from lux_tpu.models import sssp_delta as jsd
from lux_tpu.models.components import ConnectedComponents as JCC
from lux_tpu.models.pagerank import PageRank as JPageRank
from lux_tpu.models.sssp import SSSP as JSSSP
from lux_tpu.utils import flags as jflags
from lux_tpu_torch import convert
from lux_tpu_torch import models as tmodels
from lux_tpu_torch.engine import gas as tgas
from lux_tpu_torch.engine.check import count_violations
from lux_tpu_torch.engine.push import PushExecutor
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.graph.graph import Graph as TGraph
from lux_tpu_torch.models import (
    BFS,
    SSSP,
    ConnectedComponents,
    DeltaSSSP,
    KCore,
    LabelPropagation,
    PageRank,
)
from lux_tpu_torch.models import bfs as tbfs
from lux_tpu_torch.models import kcore as tkcore
from lux_tpu_torch.models import labelprop as tlp
from lux_tpu_torch.models import sssp_delta as tsd
from lux_tpu_torch.models.pagerank import reference_pagerank
from lux_tpu_torch.models.sssp import reference_sssp
from lux_tpu_torch.ops import frontier as tfq
from lux_tpu_torch.ops import segment as tseg
from lux_tpu_torch.utils import flags as tflags

CPU = torch.device("cpu")
RTOL, ATOL = 5e-5, 1e-9

# name -> graph maker over a generate module
GRAPHS = {
    "rmat10": lambda m: m.rmat(10, 8, seed=3, weighted=True),
    "rmat10_u": lambda m: m.undirected(m.rmat(10, 8, seed=3, weighted=True)),
    "gnp400": lambda m: m.gnp(400, 3000, seed=103, weighted=True),
    "gnp300": lambda m: m.gnp(300, 2400, seed=7),
}
_GRAPH_CACHE = {}

# name -> (graph, (lux_tpu program, port program) maker, run kw)
CASES = {
    "bfs_u": ("rmat10_u", lambda: (jbfs.BFS(), BFS()), {"start": 1}),
    "bfs": ("rmat10", lambda: (jbfs.BFS(), BFS()), {"start": 0}),
    "sssp_delta_u": ("rmat10_u", lambda: (jsd.DeltaSSSP(), DeltaSSSP()),
                     {"start": 0}),
    "sssp_delta": ("rmat10", lambda: (jsd.DeltaSSSP(), DeltaSSSP()),
                   {"start": 0}),
    "labelprop_u": ("rmat10_u", lambda: (jlp.LabelPropagation(),
                                         LabelPropagation()), {}),
    "labelprop": ("rmat10", lambda: (jlp.LabelPropagation(),
                                     LabelPropagation()), {}),
    "kcore2_u": ("rmat10_u", lambda: (jkcore.KCore(2), KCore(2)), {}),
    "kcore4_u": ("rmat10_u", lambda: (jkcore.KCore(4), KCore(4)), {}),
    "kcore3": ("rmat10", lambda: (jkcore.KCore(3), KCore(3)), {}),
    "sssp_adapter": ("gnp400", lambda: (jgas.as_gas(JSSSP()),
                                        tgas.as_gas(SSSP())), {"start": 5}),
    "cc_adapter": ("rmat10_u", lambda: (jgas.as_gas(JCC()),
                                        tgas.as_gas(ConnectedComponents())),
                   {}),
}
# Density flags: lux_tpu's defaults, and a band that makes the adaptive
# policy switch often on these small graphs.
DENSITY = {
    "default": {},
    "band": {"LUX_GAS_DENSITY_HI": "0.3", "LUX_GAS_DENSITY_LO": "0.02"},
}
_JAX_RUNS = {}


def _graphs(name):
    if name not in _GRAPH_CACHE:
        make = GRAPHS[name]
        _GRAPH_CACHE[name] = (make(jgen), make(tgen))
    return _GRAPH_CACHE[name]


def _ledger(ex, iters):
    return (iters, ex.push_iters, ex.pull_iters, ex.direction_switches)


def _jax_run(case, mode, density, max_iters=None, chunk=16):
    """lux_tpu's (values, ledger), cached per case."""
    key = (case, mode, density, max_iters, chunk)
    if key not in _JAX_RUNS:
        gname, progs, kw = CASES[case]
        jg, _ = _graphs(gname)
        with jflags.overrides(DENSITY[density]):
            ex = jgas.AdaptiveExecutor(jg, progs()[0], mode=mode)
            st, iters = ex.run(max_iters=max_iters, chunk=chunk, **kw)
        _JAX_RUNS[key] = (np.asarray(st.values), _ledger(ex, iters))
    return _JAX_RUNS[key]


def _port_run(case, mode, density, monkeypatch, max_iters=None, chunk=16):
    gname, progs, kw = CASES[case]
    _, tg = _graphs(gname)
    for name, value in DENSITY[density].items():
        monkeypatch.setenv(name, value)
    ex = tgas.AdaptiveExecutor(tg, progs()[1], device="cpu", mode=mode)
    st, iters = ex.run(max_iters=max_iters, chunk=chunk, **kw)
    return ex, st, _ledger(ex, iters)


@pytest.mark.parametrize("density", sorted(DENSITY))
@pytest.mark.parametrize("mode", tgas.GAS_MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_adaptive_executor_matches_lux_tpu(case, mode, density, monkeypatch):
    ex, st, ledger = _port_run(case, mode, density, monkeypatch)
    want, jledger = _jax_run(case, mode, density)
    got = ex.values(st)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert ledger == jledger
    assert len(ex.direction_log) == ledger[0]
    assert sum(d for d, _, _ in ex.direction_log) == ex.push_iters
    gname, progs, _ = CASES[case]
    jg, tg = _graphs(gname)
    jfin = progs()[0].finalize_host(jg, want)
    tfin = ex.finalize(st)
    assert sorted(tfin) == sorted(jfin)
    for k, v in jfin.items():
        np.testing.assert_array_equal(np.asarray(tfin[k]), np.asarray(v))


def test_cases_switch_direction():
    # The list above must take both directions and switch mid-run, or it
    # proves nothing about the direction ledger.
    switched = {c for c in CASES for d in DENSITY
                if _jax_run(c, "adaptive", d)[1][3] > 0}
    assert {"bfs_u", "sssp_delta_u", "labelprop_u"} <= switched
    both = [c for c in CASES
            if 0 < _jax_run(c, "adaptive", "band")[1][1]
            < _jax_run(c, "adaptive", "band")[1][0]]
    assert len(both) >= 4


@pytest.mark.parametrize("case,mode,max_iters,chunk", [
    ("bfs_u", "adaptive", 2, 16), ("bfs_u", "adaptive", None, 1),
    ("bfs_u", "push", None, 3), ("sssp_delta_u", "adaptive", 2, 3),
    ("labelprop", "adaptive", None, 3), ("kcore2_u", "push", 2, 1),
    ("cc_adapter", "adaptive", 2, 1), ("bfs", "pull", 0, 16),
    ("bfs", "adaptive", None, 0),
])
def test_max_iters_and_chunk_match_lux_tpu(case, mode, max_iters, chunk,
                                           monkeypatch):
    ex, st, ledger = _port_run(case, mode, "band", monkeypatch, max_iters,
                               chunk)
    want, jledger = _jax_run(case, mode, "band", max_iters, chunk)
    np.testing.assert_array_equal(ex.values(st), want)
    assert ledger == jledger


@pytest.mark.parametrize("case", ["bfs_u", "sssp_delta_u", "kcore2_u"])
def test_state_from_lux_tpu_finishes_in_the_port(case, monkeypatch):
    """lux_tpu runs 2 iterations; its state (direction included) finishes
    in the port exactly as it finishes in lux_tpu."""
    gname, progs, kw = CASES[case]
    jg, tg = _graphs(gname)
    for name, value in DENSITY["band"].items():
        monkeypatch.setenv(name, value)
    jex = jgas.AdaptiveExecutor(jg, progs()[0])
    jst, _ = jex.run(max_iters=2, **kw)
    vals, fr, d = (np.asarray(jst.values), np.asarray(jst.frontier),
                   int(jst.direction))
    jend, jiters = jex.run(state=jst)
    tex = tgas.AdaptiveExecutor(tg, progs()[1], device="cpu")
    st = convert.gas_state_from_numpy(vals, fr, d, CPU)
    back = convert.gas_state_to_numpy(st)
    np.testing.assert_array_equal(back[0], vals)
    np.testing.assert_array_equal(back[1], fr)
    assert back[2] == d
    tend, titers = tex.run(state=st)
    np.testing.assert_array_equal(tex.values(tend), np.asarray(jend.values))
    assert _ledger(tex, titers) == _ledger(jex, jiters)
    assert tend.direction == int(jend.direction)


@pytest.mark.parametrize("case", ["bfs_u", "sssp_delta_u", "kcore2_u"])
def test_step_and_phase_step_follow_run(case, monkeypatch):
    ex, want, ledger = _port_run(case, "adaptive", "band", monkeypatch)
    gname, progs, kw = CASES[case]
    st = ex.init_state(**kw)
    phased = ex.init_state(**kw)
    dirs = []
    for _ in range(ledger[0]):
        st, cnt = ex.step(st)
        phased, pcnt, times = ex.phase_step(phased)
        assert pcnt == cnt and phased.direction == st.direction
        assert times["direction"] == ("push" if st.direction else "pull")
        assert set(times) >= {"accTime", "updateTime"}
        dirs.append(st.direction)
    assert cnt == 0
    assert dirs == [d for d, _, _ in ex.direction_log]
    np.testing.assert_array_equal(ex.values(st), ex.values(want))
    np.testing.assert_array_equal(ex.values(phased), ex.values(want))


# -- the plain versions against _pull_acc and _push_acc -------------------


def _acc_states(jg, prog, seed):
    """(name, values, frontier) states exercising the edge cases: a
    random frontier over random values, an empty frontier, a frontier of
    vertices without out-edges, and uint32 values at the top of the
    range (wrapping under add1 and decay)."""
    rng = np.random.default_rng(seed)
    nv = jg.nv
    f32 = prog.value_dtype == jnp.float32
    if f32:
        vals = rng.integers(0, 5000, nv).astype(np.float32)
        vals[rng.random(nv) < 0.2] = np.inf
    else:
        vals = rng.integers(0, 2**32, nv, dtype=np.uint64).astype(np.uint32)
    states = [("random", vals, rng.random(nv) < 0.3),
              ("empty", vals, np.zeros(nv, dtype=bool))]
    sinks = jg.out_degrees == 0
    if sinks.any():
        states.append(("no out-edges", vals, sinks))
    if not f32:
        top = vals.copy()
        top[: nv // 2] = np.uint32(0xFFFFFFFF)
        top[nv // 2: nv // 2 + 8] = np.uint32(0xFFFFFF00)   # hops == 0
        states.append(("uint32 wrap", top, rng.random(nv) < 0.5))
    return states


@pytest.mark.parametrize("case", ["bfs", "sssp_delta_u", "labelprop",
                                  "kcore3", "cc_adapter", "sssp_adapter"])
def test_plain_accumulators_match_pull_acc_and_push_acc(case):
    gname, progs, _ = CASES[case]
    jg, tg = _graphs(gname)
    jprog, tprog = progs()
    # A graph with rows without in-edges and vertices without out-edges.
    assert (jg.in_degrees == 0).any() or gname.startswith("gnp")
    jex = jgas.AdaptiveExecutor(jg, jprog, mode="push")
    tex = tgas.AdaptiveExecutor(tg, tprog, device="cpu", mode="push")
    for label, vals, fr in _acc_states(jg, jprog, seed=len(case)):
        jst = jgas.GasState(jnp.asarray(vals), jnp.asarray(fr), jnp.int32(0))
        st = convert.gas_state_from_numpy(vals, fr, 0, CPU)
        want_pull = np.asarray(jex._pull_acc(jst, jex._dg))
        got = tseg.gas_pull_acc_plain(
            tex.row_ptr, tex.col_src, st.values, st.frontier,
            tprog.combiner, tprog.gather, tex.weights)
        np.testing.assert_array_equal(
            convert.gas_state_to_numpy(st._replace(values=got))[0],
            want_pull, err_msg=f"pull {label}")
        cnt = int(fr.sum())
        if cnt > jex.queue_cap:
            continue   # lux_tpu's static queue would truncate it
        q, start, _, offs = tfq.frontier_queue(st.frontier, tex.csr_row_ptr,
                                               cnt)
        got = tfq.gas_push_acc_plain(
            q, start, offs, tex.csr_col_dst, st.values, tprog.combiner,
            tprog.gather, tex.csr_weights)
        want_push = np.asarray(jex._push_acc(jst, jex._dg))
        np.testing.assert_array_equal(
            convert.gas_state_to_numpy(st._replace(values=got))[0],
            want_push, err_msg=f"push {label}")
        np.testing.assert_array_equal(want_push, want_pull)


@pytest.mark.parametrize("k", [1, 3, 8, 9])
def test_frontier_bits_round_trip(k):
    # K10 reads the frontier as bits: 32 vertices a word for one column,
    # a byte per vertex and chunk of 8 columns for K of them. The plain
    # pack gives back every bool frontier, and the pull accumulator over
    # the frontier read back from the bits is lux_tpu's.
    rng = np.random.default_rng(k)
    for n in (0, 1, 31, 32, 33, 1000):
        for frac in (0.0, 0.3, 1.0):
            shape = (n,) if k == 1 else (n, k)
            fr = torch.from_numpy(rng.random(shape) < frac)
            bits = tseg.frontier_bits_plain(fr)
            if k == 1:
                assert bits.dtype == torch.int32
                assert tuple(bits.shape) == ((n + 31) // 32,)
            else:
                assert bits.dtype == torch.uint8
                assert tuple(bits.shape) == (n, -(-k // 8))
            assert torch.equal(tseg.frontier_bits(fr), bits)
            assert torch.equal(tseg.frontier_from_bits_plain(bits, shape),
                               fr)
    gname, progs, _ = CASES["bfs"]
    jg, tg = _graphs(gname)
    jprog, tprog = progs()
    jex = jgas.AdaptiveExecutor(jg, jprog, mode="pull")
    tex = tgas.AdaptiveExecutor(tg, tprog, device="cpu", mode="pull")
    for label, vals, fr in _acc_states(jg, jprog, seed=k):
        jst = jgas.GasState(jnp.asarray(vals), jnp.asarray(fr), jnp.int32(0))
        st = convert.gas_state_from_numpy(vals, fr, 0, CPU)
        back = tseg.frontier_from_bits_plain(
            tseg.frontier_bits_plain(st.frontier), tuple(fr.shape))
        got = tseg.gas_pull_acc_plain(tex.row_ptr, tex.col_src, st.values,
                                      back, tprog.combiner, tprog.gather)
        np.testing.assert_array_equal(
            convert.gas_state_to_numpy(st._replace(values=got))[0],
            np.asarray(jex._pull_acc(jst, jex._dg)), err_msg=label)


def _row_ptrs():
    rng = np.random.default_rng(3)
    yield "rmat", tgen.rmat(12, 16, seed=1).row_ptr
    lens = rng.integers(0, 40, 5000)
    lens[[3, 4, 900, 4999]] = [20000, 9000, 1500, 8193]
    lens[rng.random(5000) < 0.2] = 0
    yield "hubs", np.concatenate([[0], np.cumsum(lens)])
    yield "empty rows", np.zeros(70, np.int64)
    yield "no rows", np.zeros(1, np.int64)
    yield "one hub", np.array([0, 10 ** 5])


def _strided_edges(lo, hi, mis, stride):
    """The edges each of ``stride`` threads folds in csrc/gas.cu's
    ``strided_row``: head and tail edges outside whole aligned quads (col_src
    starting ``mis`` words past a 16-byte boundary), one a thread, then the
    quads, strided, two a step."""
    qlo, qhi = (lo + mis + 3) >> 2, (hi + mis) >> 2
    head = tail = hi
    if qlo < qhi:
        head, tail = 4 * qlo - mis, 4 * qhi - mis
    out = [[] for _ in range(stride)]
    for t in range(stride):
        if lo + t < head:
            out[t].append(lo + t)
        if tail + t < hi and qlo < qhi:
            out[t].append(tail + t)
        if qlo >= qhi:
            out[t] += list(range(lo + t + stride, hi, stride))
        q = qlo + t
        while q + stride < qhi:
            out[t] += [4 * q - mis + j for j in range(4)]
            out[t] += [4 * (q + stride) - mis + j for j in range(4)]
            q += 2 * stride
        if q < qhi:
            out[t] += [4 * q - mis + j for j in range(4)]
    return out


@pytest.mark.parametrize("name", ["rmat", "hubs", "empty rows", "no rows",
                                  "one hub"])
def test_row_tasks_partition_the_rows(name):
    # K10's schedule: hub rows (one a block) first, then warp tasks of at
    # most 32 consecutive rows in row order; together they cover every
    # row once. A warp task gathers at most 2 * TASK_EDGES edges unless it
    # is one row; no row above HUB_EDGES is left to a warp.
    rp = dict(_row_ptrs())[name]
    n = rp.shape[0] - 1
    lens = np.diff(rp)
    tasks, n_hub = tseg.row_tasks(rp)
    assert tasks.dtype == np.int32 and tasks.shape == (tasks.shape[0], 2)
    seen = np.zeros(n, np.int64)
    for lo, hi in tasks:
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    hubs, warps = tasks[:n_hub], tasks[n_hub:]
    assert np.all(hubs[:, 1] - hubs[:, 0] == 1)
    assert np.all(lens[hubs[:, 0]] > tseg.HUB_EDGES)
    assert n_hub == int((lens > tseg.HUB_EDGES).sum())
    assert np.all(np.diff(warps[:, 0]) > 0)
    size = warps[:, 1] - warps[:, 0]
    assert np.all((size >= 1) & (size <= tseg.TASK_ROWS))
    edges = rp[warps[:, 1]] - rp[warps[:, 0]]
    assert np.all((edges <= 2 * tseg.TASK_EDGES) | (size == 1))
    t = tseg.RowTasks.build(rp, "cpu")
    assert (t.n_tasks, t.n_hub, t.nrows) == (tasks.shape[0], n_hub, n)
    assert torch.equal(t.tasks, torch.from_numpy(tasks))


@pytest.mark.parametrize("stride", [32, 256])
def test_strided_rows_fold_every_edge_once(stride):
    # The index arithmetic of K10's warp and block tiers, for rows of 0 to
    # a few thousand edges at every offset and misalignment of col_src.
    rng = np.random.default_rng(stride)
    cases = [(lo, lo + m) for lo in range(8) for m in range(0, 40)]
    cases += [(int(a), int(a) + int(m)) for a, m in
              zip(rng.integers(0, 10 ** 6, 60), rng.integers(40, 5000, 60))]
    for lo, hi in cases:
        for mis in range(4):
            got = sorted(e for es in _strided_edges(lo, hi, mis, stride)
                         for e in es)
            assert got == list(range(lo, hi)), (lo, hi, mis)


def test_gather_ops_match_lux_tpu_programs():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    u[:300] = np.uint32(0xFFFFFFFF)
    u[300:600] &= np.uint32(0xFFFFFF00)    # hops == 0: decay sends 0
    f = rng.integers(0, 10**6, 4096).astype(np.float32)
    f[:50] = np.inf
    w = rng.integers(1, 101, 4096).astype(np.int32)
    wide = tseg.widen_u32(tseg.to_u32_storage(u))
    for op, jprog in (("add1", jbfs.BFS()), ("decay", jlp.LabelPropagation()),
                      ("one", jkcore.KCore(2))):
        got = tseg.GATHER_OPS[op](wide, None).numpy()
        want = np.asarray(jprog.gather(jnp.asarray(u), None))
        np.testing.assert_array_equal(got.astype(np.uint32), want)
        assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(
        tseg.GATHER_OPS["copy"](wide, None).numpy().astype(np.uint32), u)
    got = tseg.GATHER_OPS["add_w"](torch.from_numpy(f), torch.from_numpy(w))
    want = jsd.DeltaSSSP().gather(jnp.asarray(f), jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_f32_key_identities():
    def key(x):
        b = np.asarray([x], np.float32).view(np.uint32)[0]
        return int(b ^ (0xFFFFFFFF if b >> 31 else 0x80000000))

    # The word the f32 min kernels start an accumulator from.
    assert key(np.inf) == 0xFF800000
    xs = [-np.inf, -3.5, -0.0, 0.0, 1.0, 2.5e30, np.inf]
    assert [key(x) for x in xs] == sorted(key(x) for x in xs)


# -- adapters -------------------------------------------------------------


def test_push_adapter_sssp_matches_push_executor_and_lux_tpu(monkeypatch):
    _, tg = _graphs("gnp400")
    prog = tgas.as_gas(SSSP())
    assert isinstance(prog, tgas.PushGasAdapter) and prog.rooted
    assert prog.gather_op == "add1"
    for mode in tgas.GAS_MODES:
        ex = tgas.AdaptiveExecutor(tg, prog, device="cpu", mode=mode)
        st, _ = ex.run(start=5)
        pst, _ = PushExecutor(tg, SSSP(), device="cpu").run(start=5)
        np.testing.assert_array_equal(ex.values(st), tseg.u32_to_numpy(
            pst.values))
        np.testing.assert_array_equal(ex.values(st), reference_sssp(tg, 5))
        want, jledger = _jax_run("sssp_adapter", mode, "default")
        np.testing.assert_array_equal(ex.values(st), want)


def test_pull_adapter_pagerank_matches_lux_tpu():
    jg, tg = _graphs("gnp300")
    prog = tgas.as_gas(PageRank())
    assert isinstance(prog, tgas.PullGasAdapter) and not prog.frontier
    ex = tgas.AdaptiveExecutor(tg, prog, device="cpu", mode="push")
    assert ex.mode == "pull"    # frontier-less: direction is forced
    st, iters = ex.run(max_iters=20)
    assert iters == 20 and ex.pull_iters == 20 and ex.push_iters == 0
    jex = jgas.AdaptiveExecutor(jg, jgas.as_gas(JPageRank()))
    jst, jiters = jex.run(max_iters=20)
    assert jiters == iters
    got = ex.values(st)
    np.testing.assert_allclose(got, np.asarray(jst.values), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, reference_pagerank(tg, 20), rtol=RTOL,
                               atol=ATOL)


# -- multi-source ---------------------------------------------------------


@pytest.mark.parametrize("case,roots,k", [
    ("bfs_u", [2, 3, 4], 4), ("sssp_delta_u", [0, 7, 9, 11], 4),
    ("sssp_adapter", [5], 3), ("bfs", [0, 1, 2, 3, 4, 5, 6, 7, 8], 9),
])
def test_multi_source_lanes_match_singles_and_lux_tpu(case, roots, k):
    gname, progs, _ = CASES[case]
    jg, tg = _graphs(gname)
    mx = tgas.MultiSourceGasExecutor(tg, progs()[1], k=k, device="cpu")
    st, iters = mx.run(roots)
    jmx = jgas.MultiSourceGasExecutor(jg, progs()[0], k=k)
    jst, jiters = jmx.run(roots)
    assert iters == jiters and mx.pull_iters == iters and mx.push_iters == 0
    for j, r in enumerate(roots):
        ex = tgas.AdaptiveExecutor(tg, progs()[1], device="cpu")
        single, _ = ex.run(start=r)
        lane = mx.values_for(st, j)
        np.testing.assert_array_equal(lane, ex.values(single))
        np.testing.assert_array_equal(lane, jmx.values_for(jst, j))
        fin, jfin = mx.finalize_for(st, j), jmx.finalize_for(jst, j)
        for key, v in jfin.items():
            np.testing.assert_array_equal(fin[key], v)


@pytest.mark.parametrize("case,chunk", [("bfs_u", 16), ("sssp_delta", 16),
                                        ("bfs", 0)])
def test_multi_source_warmup_matches_lux_tpu_and_leaves_no_state(case,
                                                                 chunk):
    want = inspect.signature(jgas.MultiSourceGasExecutor.warmup)
    assert inspect.signature(tgas.MultiSourceGasExecutor.warmup) == want
    gname, progs, _ = CASES[case]
    _, tg = _graphs(gname)
    roots = [0, 3, 5]
    cold = tgas.MultiSourceGasExecutor(tg, progs()[1], k=4, device="cpu")
    st, iters = cold.run(roots)
    warm = tgas.MultiSourceGasExecutor(tg, progs()[1], k=4, device="cpu")
    warm.warmup(chunk=chunk, start=2)
    assert warm.pull_iters == 0
    wst, witers = warm.run(roots)
    warm.warmup()
    assert witers == iters and warm.pull_iters == iters
    assert torch.equal(wst.values, st.values)
    assert torch.equal(wst.frontier, st.frontier)


# -- oracles and checker ----------------------------------------------------


@pytest.mark.parametrize("gname", ["rmat10", "rmat10_u", "gnp400"])
def test_oracles_match_lux_tpu(gname):
    jg, tg = _graphs(gname)
    np.testing.assert_array_equal(tsd.reference_sssp_delta(tg, 0),
                                  jsd.reference_sssp_delta(jg, 0))
    np.testing.assert_array_equal(tlp.reference_labelprop(tg),
                                  jlp.reference_labelprop(jg))
    for k in (2, 3, 4):
        np.testing.assert_array_equal(tkcore.reference_kcore(tg, k),
                                      jkcore.reference_kcore(jg, k))
    for start in (0, 1):
        for got, want in zip(tbfs.reference_bfs(tg, start),
                             jbfs.reference_bfs(jg, start)):
            np.testing.assert_array_equal(got, want)


def test_oracles_on_duplicate_edges_and_empty_rows():
    # Parallel edges of different weights, a self-loop and isolated rows.
    src = np.array([0, 0, 0, 1, 2, 2, 4])
    dst = np.array([1, 1, 2, 2, 2, 3, 5])
    w = np.array([7, 3, 20, 4, 1, 2, 9], dtype=np.int32)
    tg = TGraph.from_edges(src, dst, nv=7, weights=w)
    jg = JGraph.from_edges(src, dst, nv=7, weights=w)
    np.testing.assert_array_equal(tsd.reference_sssp_delta(tg, 0),
                                  jsd.reference_sssp_delta(jg, 0))
    np.testing.assert_array_equal(tlp.reference_labelprop(tg),
                                  jlp.reference_labelprop(jg))
    np.testing.assert_array_equal(tbfs.bfs_parents(tg, reference_sssp(tg, 0)),
                                  jbfs.reference_bfs(jg, 0)[1])


def test_weighted_rmat_twin_has_the_same_edges():
    # chip_smoke.py generates the weighted R-MAT once and drops the weights
    # for the unweighted programs.
    a = tgen.rmat(10, 8, seed=42, weighted=True)
    b = tgen.rmat(10, 8, seed=42)
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col_src, b.col_src)


def test_count_violations_takes_f32_delta_sssp(monkeypatch):
    jg, tg = _graphs("rmat10_u")
    ex = tgas.AdaptiveExecutor(tg, DeltaSSSP(), device="cpu")
    st, _ = ex.run(start=0)
    vals = ex.values(st)
    assert vals.dtype == np.float32
    assert count_violations(tg, vals, DeltaSSSP(), device="cpu") == 0
    assert count_violations(tg, st.values, DeltaSSSP(), device="cpu") == 0
    bad = vals.copy()
    reached = np.flatnonzero(np.isfinite(bad) & (bad > 0))
    bad[reached[:5]] += np.float32(1000)
    got = count_violations(tg, bad, DeltaSSSP(), device="cpu")
    assert got > 0
    assert got == jcount(jg, jnp.asarray(bad), jsd.DeltaSSSP())
    # uint32 programs keep working.
    bst, _ = tgas.AdaptiveExecutor(tg, BFS(), device="cpu").run(start=1)
    assert count_violations(tg, bst.values, BFS(), device="cpu") == 0


# -- refusals, registry, flags ------------------------------------------------


def test_frontierless_run_requires_max_iters():
    g = tgen.gnp(50, 200, seed=1)
    ex = tgas.AdaptiveExecutor(g, tgas.as_gas(PageRank()), device="cpu")
    with pytest.raises(ValueError):
        ex.run()


def test_as_gas_rejects_unknown_model():
    with pytest.raises(TypeError):
        tgas.as_gas(object())


def test_bad_mode_and_density_rejected(monkeypatch):
    g = tgen.gnp(50, 200, seed=1)
    with pytest.raises(ValueError):
        tgas.AdaptiveExecutor(g, BFS(), device="cpu", mode="sideways")
    monkeypatch.setenv("LUX_GAS", "sideways")
    with pytest.raises(ValueError):
        tgas.AdaptiveExecutor(g, BFS(), device="cpu")
    monkeypatch.setenv("LUX_GAS", "push")
    assert tgas.AdaptiveExecutor(g, BFS(), device="cpu").mode == "push"
    monkeypatch.setenv("LUX_GAS_DENSITY_LO", "0.5")
    monkeypatch.setenv("LUX_GAS_DENSITY_HI", "0.1")
    with pytest.raises(ValueError):
        tgas.AdaptiveExecutor(g, BFS(), device="cpu")


def test_weights_and_multi_source_refusals():
    g = tgen.gnp(50, 200, seed=1)
    with pytest.raises(ValueError):
        tgas.AdaptiveExecutor(g, DeltaSSSP(), device="cpu")
    with pytest.raises(ValueError):
        tgas.MultiSourceGasExecutor(g, PageRank(), k=2, device="cpu")
    with pytest.raises(ValueError):
        tgas.MultiSourceGasExecutor(g, BFS(), k=0, device="cpu")
    mx = tgas.MultiSourceGasExecutor(g, BFS(), k=2, device="cpu")
    with pytest.raises(ValueError):
        mx.init_state([1, 2, 3])
    with pytest.raises(ValueError):
        KCore(k=0)


def test_card_refusals():
    # What the executor refuses on the card, decided without one.
    class NoOp(BFS):
        gather_op = None

    class Apart(BFS):
        # Inherits gather_op "add1" but computes another edge function.
        def gather(self, src_vals, weights):
            return src_vals

    class Pushy(BFS):
        def gather_push(self, src_vals, weights):
            return src_vals + 1

    class WrongPair(BFS):
        combiner = "max"

    class WrongType(BFS):
        value_dtype = np.float32

    for prog in (NoOp(), Apart(), Pushy(), WrongPair(), WrongType()):
        with pytest.raises(NotImplementedError):
            tgas.check_gas_kernel_covers(prog)
    for prog in (BFS(), DeltaSSSP(), LabelPropagation(), KCore(3),
                 tgas.as_gas(SSSP()), tgas.as_gas(ConnectedComponents())):
        tgas.check_gas_kernel_covers(prog)

    class RelaxApart(SSSP):
        def relax(self, src_vals, weights):
            return src_vals

    with pytest.raises(NotImplementedError):
        tgas.check_gas_kernel_covers(tgas.as_gas(RelaxApart()))
    with pytest.raises(NotImplementedError):
        tseg.gas_kernel_code("min", "decay")


def test_executor_without_device_or_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tgen.gnp(50, 200, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgas.AdaptiveExecutor(g, BFS())


def test_registry_matches_lux_tpu():
    assert sorted(tmodels.PROGRAMS) == sorted(jmodels.PROGRAMS)
    assert tmodels.ROOTED_APPS == jmodels.ROOTED_APPS == frozenset(
        {"bfs", "sssp", "sssp_delta"})
    for name in tmodels.PROGRAMS:
        assert tmodels.get_program(name).name == name
        got = tmodels.capabilities()[name]
        assert got == {
            k: bool(getattr(jmodels.PROGRAMS[name], k, False))
            for k in ("rooted", "frontier_ok", "incremental_ok")}
    assert tmodels.capability_report()["source"] == "declared"
    with pytest.raises(KeyError):
        tmodels.get_program("nope")
    with pytest.raises(KeyError):
        tmodels.engine_kinds("nope")


def test_engine_kinds_are_ported_subsequences_of_lux_tpu():
    ported = {"pull", "tiled", "push", "gas", "gas_multi", "pull_sharded",
              "push_multi", "push_sharded", "push_multi_sharded",
              "gas_sharded", "gas_multi_sharded"}
    assert sorted(tmodels.ENGINE_KINDS) == sorted(jmodels.ENGINE_KINDS)
    for name, kinds in tmodels.ENGINE_KINDS.items():
        want = tuple(k for k in jmodels.ENGINE_KINDS[name] if k in ported)
        assert kinds == want, name
        assert tmodels.engine_kinds(name) == kinds
        if "gas_multi" in kinds:
            assert name in tmodels.ROOTED_APPS


@pytest.mark.parametrize("name", ["LUX_GAS", "LUX_GAS_DENSITY_HI",
                                  "LUX_GAS_DENSITY_LO"])
def test_gas_flags_match_lux_tpu(name, monkeypatch):
    mine, theirs = tflags._flag(name), jflags._flag(name)
    assert (mine.default, mine.doc, mine.kind) == (
        theirs.default, theirs.doc, theirs.kind)
    monkeypatch.setenv(name, "0.25")
    assert tflags.get(name) == jflags.get(name) == "0.25"
    if mine.kind == "float":
        assert tflags.get_float(name) == jflags.get_float(name) == 0.25
