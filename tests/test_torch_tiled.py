"""Port parity: the tiled pull executor and PageRank, lux_tpu vs lux_tpu_torch.

The port runs on the CPU here (``device="cpu"``), where every kernel
wrapper takes its plain PyTorch version. External vertex order in and
out; tolerance rtol=5e-5, atol=1e-9 (tests/test_tiled.py's).
"""

import jax
import numpy as np
import pytest
import torch

from lux_tpu.engine.tiled import TiledPullExecutor as JaxExecutor
from lux_tpu.graph import generate as jgen
from lux_tpu.models.pagerank import PageRank as JaxPageRank
from lux_tpu.models.pagerank import reference_pagerank as jax_reference
from lux_tpu_torch import convert
from lux_tpu_torch.engine.program import PullProgram
from lux_tpu_torch.engine.tiled import TiledPullExecutor, spmv_capable
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.models import PageRank
from lux_tpu_torch.models.pagerank import reference_pagerank

RTOL, ATOL = 5e-5, 1e-9
GRAPHS = {"rmat10_8": (10, 8, 0), "rmat10_14": (10, 14, 3)}
_JAX_RUNS = {}


def _tail_env(monkeypatch, grouped):
    if grouped:
        monkeypatch.setenv("LUX_GROUPED_TAIL", "1")
    else:
        monkeypatch.delenv("LUX_GROUPED_TAIL", raising=False)


def _jax_run(name, grouped):
    """lux_tpu's executor, its init values, one step and run(10)
    (cached: each JAX executor compiles its step and loop once)."""
    key = (name, grouped)
    if key not in _JAX_RUNS:
        with pytest.MonkeyPatch.context() as mp:
            _tail_env(mp, grouped)
            scale, ef, seed = GRAPHS[name]
            ex = JaxExecutor(jgen.rmat(scale, ef, seed=seed), JaxPageRank(),
                             chunk_strips=16, chunk_tail=64)
            assert (ex.gtail is not None) == grouped
            v0 = np.asarray(ex.init_values())
            _JAX_RUNS[key] = (ex, v0, np.asarray(ex.step(v0)),
                              np.asarray(ex.run(10)))
    return _JAX_RUNS[key]


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_step_and_run_match_jax_and_oracle(name, grouped, monkeypatch):
    jex, v0, jstep, jrun = _jax_run(name, grouped)
    _tail_env(monkeypatch, grouped)
    scale, ef, seed = GRAPHS[name]
    g = tgen.rmat(scale, ef, seed=seed)
    ex = TiledPullExecutor(g, PageRank(), device="cpu")
    assert (ex.gtail is not None) == grouped
    np.testing.assert_array_equal(ex.init_values().numpy(), v0)
    step = ex.step(v0)
    assert step.shape == (g.nv,) and step.dtype == torch.float32
    np.testing.assert_allclose(step.numpy(), jstep, rtol=RTOL, atol=ATOL)
    got = ex.run(10).numpy()
    np.testing.assert_allclose(got, jrun, rtol=RTOL, atol=ATOL)
    oracle = reference_pagerank(g, 10)
    np.testing.assert_array_equal(oracle, jax_reference(jex.graph, 10))
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grouped", [False, True])
def test_port_runs_on_a_jax_plan(grouped, monkeypatch):
    jex, v0, jstep, jrun = _jax_run("rmat10_14", grouped)
    _tail_env(monkeypatch, grouped)
    plan = convert.plan_from_numpy(convert.plan_to_numpy(jex.plan))
    ex = TiledPullExecutor(tgen.rmat(10, 14, seed=3), PageRank(), plan=plan,
                           device="cpu")
    vals = convert.vals_from_numpy(v0, "cpu")
    np.testing.assert_allclose(ex.step(vals).numpy(), jstep, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ex.run(10, vals=vals).numpy(), jrun,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grouped", [False, True])
def test_phase_step_matches_step(grouped, monkeypatch):
    _tail_env(monkeypatch, grouped)
    ex = TiledPullExecutor(tgen.rmat(9, 8, seed=2), PageRank(), device="cpu")
    v = ex.init_values()
    out, times = ex.phase_step(v)
    np.testing.assert_array_equal(out.numpy(), ex.step(v).numpy())
    assert {"strips", "tail", "apply"} <= set(times)
    if grouped:
        levels = [f"tail_level{k}" for k in range(ex.gtail.n_levels + 1)]
        assert set(levels + ["tail_root"]) <= set(times)
        assert times["tail"] == pytest.approx(
            sum(times[k] for k in levels) + times["tail_root"])
    ex.warmup()


def test_executor_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TiledPullExecutor(tgen.rmat(8, 4, seed=0), PageRank())


def test_entry_matches_graft_entry():
    import __graft_entry__

    from lux_tpu_torch.entry import entry

    jfn, jargs = __graft_entry__.entry()
    fn, args = entry(device="cpu")
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    want = np.asarray(jax.jit(jfn)(*jargs))
    np.testing.assert_allclose(fn(*args).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_packed_strips_are_not_ported(monkeypatch):
    g = tgen.rmat(8, 4, seed=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TiledPullExecutor(g, PageRank(), device="cpu", pack=True)
    monkeypatch.setenv("LUX_PACK_STRIPS", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TiledPullExecutor(g, PageRank(), device="cpu")


def test_rejects_non_spmv_programs():
    class MinLabel(PullProgram):
        name = "minlabel"
        combiner = "min"

    assert spmv_capable(PageRank()) and not spmv_capable(MinLabel())
    with pytest.raises(ValueError, match="sum-combiner"):
        TiledPullExecutor(tgen.rmat(8, 4, seed=0), MinLabel(), device="cpu")
