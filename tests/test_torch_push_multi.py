"""Port parity: the multi-source push engine (``MultiSourcePushExecutor``)
against lux_tpu's.

On the CPU the port's executor runs K10's plain version
(``gas_pull_acc_plain``) with K columns; these tests hold every lane
bitwise against ``lux_tpu``'s ``MultiSourcePushExecutor`` on JAX's CPU
and against the port's single-source ``PushExecutor`` run from that
lane's root, with equal ``iterations``. The kernel itself is tested on
the card by tests/test_torch_cuda.py.
"""

import inspect

import numpy as np
import pytest
import torch

from lux_tpu.engine import push as jpush
from lux_tpu.graph import generate as jgen
from lux_tpu.models.components import ConnectedComponents as JCC
from lux_tpu.models.sssp import SSSP as JSSSP
from lux_tpu_torch.engine import push as tpush
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.models import SSSP, ConnectedComponents

CPU = "cpu"
# name -> graph maker over a generate module
GRAPHS = {
    "rmat10": lambda m: m.rmat(10, 8, seed=2),
    "gnp400_weighted": lambda m: m.gnp(400, 2400, seed=3, weighted=True),
    "path30": lambda m: m.path_graph(30),
}
EIGHT = [0, 5, 17, 100, 3, 9, 29, 1]
# (k, roots): one lane, a batch padded with its last root, a full batch.
BATCHES = [(1, [0]), (3, [0, 7]), (8, EIGHT)]
_GRAPHS = {}
_JAX = {}


def _graphs(name):
    if name not in _GRAPHS:
        make = GRAPHS[name]
        _GRAPHS[name] = (make(jgen), make(tgen))
    return _GRAPHS[name]


def _programs(app):
    return (JSSSP(), SSSP()) if app == "sssp" else (JCC(),
                                                    ConnectedComponents())


def _jax_run(name, app, k, roots, max_iters=None, chunk=16):
    """lux_tpu's (lanes, iterations), cached."""
    key = (name, app, k, tuple(roots), max_iters, chunk)
    if key not in _JAX:
        jg, _ = _graphs(name)
        ex = jpush.MultiSourcePushExecutor(jg, _programs(app)[0], k=k)
        state, iters = ex.run(roots, max_iters=max_iters, chunk=chunk)
        _JAX[key] = ([ex.values_for(state, j) for j in range(k)], iters)
    return _JAX[key]


def _port(name, app, k):
    _, tg = _graphs(name)
    return tpush.MultiSourcePushExecutor(tg, _programs(app)[1], k=k,
                                         device=CPU)


@pytest.mark.parametrize("k,roots", BATCHES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_lanes_match_lux_tpu(name, k, roots):
    ex = _port(name, "sssp", k)
    roots = [r % ex.graph.nv for r in roots]
    state, iters = ex.run(roots)
    want, jiters = _jax_run(name, "sssp", k, roots)
    assert iters == jiters and ex.sparse_iters == 0
    assert state.values.shape == (ex.graph.nv, k)
    for j in range(k):
        got = ex.values_for(state, j)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want[j])


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_lanes_match_single_source_port(name):
    """Each lane equals a single-source PushExecutor run from its root;
    the shared fixpoint runs as long as the slowest lane."""
    _, tg = _graphs(name)
    roots = [r % tg.nv for r in EIGHT]
    ex = _port(name, "sssp", len(roots))
    state, iters = ex.run(roots)
    single = tpush.PushExecutor(tg, SSSP(), device=CPU)
    longest = 0
    for j, r in enumerate(roots):
        st, n = single.run(start=r)
        longest = max(longest, n)
        np.testing.assert_array_equal(ex.values_for(state, j),
                                      single.values(st))
    assert iters == longest


def test_max_combiner_matches_lux_tpu():
    # CC takes no root: every lane is the same label fixpoint (max, copy).
    ex = _port("rmat10", "cc", 3)
    state, iters = ex.run([0, 0, 0])
    want, jiters = _jax_run("rmat10", "cc", 3, [0, 0, 0])
    assert iters == jiters
    for j in range(3):
        np.testing.assert_array_equal(ex.values_for(state, j), want[j])


@pytest.mark.parametrize("max_iters,chunk", [(2, 16), (3, 1), (None, 0),
                                             (0, 16), (100, 2), (None, 3)])
def test_max_iters_and_chunk_match_lux_tpu(max_iters, chunk):
    ex = _port("rmat10", "sssp", 3)
    state, iters = ex.run([0, 7], max_iters=max_iters, chunk=chunk)
    want, jiters = _jax_run("rmat10", "sssp", 3, [0, 7], max_iters, chunk)
    assert iters == jiters
    for j in range(3):
        np.testing.assert_array_equal(ex.values_for(state, j), want[j])


def test_step_phase_step_warm_start_and_warmup():
    ex = _port("rmat10", "sssp", 3)
    s0 = ex.init_state([0, 7])
    # The padded lane repeats the last root.
    assert torch.equal(s0.values[:, 2], s0.values[:, 1])
    one, cnt = ex.step(s0)
    new, pcnt, times = ex.phase_step(s0)
    assert torch.equal(new.values, one.values) and cnt == pcnt
    assert torch.equal(new.frontier, one.frontier)
    assert sorted(times) == ["branch", "compTime", "loadTime", "updateTime"]
    assert times["branch"] == "dense"
    full, iters = ex.run([0, 7])
    warm, rest = ex.run([0, 7], state=one)
    assert rest == iters - 1 and torch.equal(warm.values, full.values)
    ex.warmup(start=3)
    ex.warmup(chunk=0)


def test_refusals():
    _, tg = _graphs("path30")
    with pytest.raises(ValueError, match="batch width"):
        tpush.MultiSourcePushExecutor(tg, SSSP(), k=0, device=CPU)
    ex = _port("path30", "sssp", 2)
    with pytest.raises(ValueError, match="need 1..2 roots"):
        ex.init_state([])
    with pytest.raises(ValueError, match="need 1..2 roots"):
        ex.run([0, 1, 2])

    class Weighted(SSSP):
        needs_weights = True

    with pytest.raises(ValueError, match="edge-weighted"):
        tpush.MultiSourcePushExecutor(tg, Weighted(), k=2, device=CPU)


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = _graphs("path30")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpush.MultiSourcePushExecutor(tg, SSSP(), k=2)


def test_signature_matches_lux_tpu():
    mine, theirs = tpush.MultiSourcePushExecutor, jpush.MultiSourcePushExecutor
    assert list(inspect.signature(mine).parameters) == list(
        inspect.signature(theirs).parameters)
    run = list(inspect.signature(mine.run).parameters)
    assert run == list(inspect.signature(theirs.run).parameters)
    for name in ("init_state", "step", "phase_step", "warmup", "values_for"):
        assert hasattr(mine, name)
    assert list(inspect.signature(mine.warmup).parameters) == list(
        inspect.signature(theirs.warmup).parameters)
