"""Port parity: hybrid and grouped-tail plans, lux_tpu vs lux_tpu_torch."""

import numpy as np
import pytest

from lux_tpu.graph import generate as jgen
from lux_tpu.ops import merge_tail_plan as jmtp
from lux_tpu.ops import tiled_spmv as jts
from lux_tpu_torch import convert
from lux_tpu_torch.engine.tiled import get_cached_plan
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.ops import merge_tail_plan as tmtp
from lux_tpu_torch.ops import tiled_spmv as tts

PLAN_ARRAYS = ("order", "rank", "tail_sb", "tail_lane", "tail_row_ptr",
               "out_degrees", "in_degrees")

CASES = {
    "rmat10_8": (lambda m: m.rmat(10, 8, seed=0), ((8, 2),)),
    "rmat10_14_cascade": (lambda m: m.rmat(10, 14, seed=3),
                          ((128, 8), (8, 2))),
    "rmat9_r32": (lambda m: m.rmat(9, 8, seed=3), ((32, 2),)),
    "gnp_r2": (lambda m: m.gnp(500, 4000, seed=7), ((2, 2),)),
    "all_tail": (lambda m: m.rmat(9, 8, seed=5), ((8, 10 ** 9),)),
}


def assert_same_plan(a, b):
    assert (a.nv, a.nvb, a.cap, a.levels_spec, a.budget_bytes) == (
        b.nv, b.nvb, b.cap, b.levels_spec, b.budget_bytes)
    for name in PLAN_ARRAYS:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        assert la.r == lb.r and la.edges == lb.edges
        for name in ("strips", "rows", "cols"):
            x, y = np.asarray(getattr(la, name)), np.asarray(getattr(lb, name))
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("banded", ["0", "1"])
def test_plan_hybrid_byte_identical(case, banded, monkeypatch):
    monkeypatch.setenv("LUX_PLAN_BANDED", banded)
    make, levels = CASES[case]
    a = jts.plan_hybrid(make(jgen), levels=levels)
    b = tts.plan_hybrid(make(tgen), levels=levels)
    assert_same_plan(a, b)


@pytest.mark.parametrize("writer", ["lux_tpu", "lux_tpu_torch"])
def test_luxplan_cross_load(tmp_path, writer):
    g = tgen.rmat(10, 14, seed=3)
    plan = tts.plan_hybrid(g, levels=((128, 8), (8, 2)))
    path = str(tmp_path / "g.luxplan")
    save, load = ((jts.save_plan, tts.load_plan) if writer == "lux_tpu"
                  else (tts.save_plan, jts.load_plan))
    save(path, plan)
    assert_same_plan(load(path), plan)


def test_get_cached_plan_serves_jax_cache(tmp_path):
    g = tgen.rmat(9, 8, seed=1)
    path = str(tmp_path / "g.luxplan")
    jts.save_plan(path, jts.plan_hybrid(jgen.rmat(9, 8, seed=1)))
    msgs = []
    got = get_cached_plan(g, path, log=msgs.append)
    assert msgs == []
    assert_same_plan(got, tts.plan_hybrid(g))
    # A different request replans and overwrites the cache.
    got = get_cached_plan(g, path, levels=((8, 1),), log=msgs.append)
    assert any("replanning" in m for m in msgs)
    assert_same_plan(jts.load_plan(path), got)


def test_convert_carries_jax_plans():
    jplan = jts.plan_hybrid(jgen.rmat(10, 8, seed=0))
    tplan = convert.plan_from_numpy(convert.plan_to_numpy(jplan))
    assert isinstance(tplan, tts.HybridPlan)
    assert_same_plan(tplan, jplan)
    jg = jmtp.plan_grouped_tail(jplan.tail_sb, jplan.tail_lane,
                                jplan.tail_row_ptr)
    tg = convert.grouped_plan_from_numpy(convert.grouped_plan_to_numpy(jg))
    assert isinstance(tg, tmtp.GroupedTailPlan)
    assert_same_grouped(jg, tg)


def assert_same_grouped(a, b):
    assert (a.n_edges, a.n_levels) == (b.n_edges, b.n_levels)
    for name in jmtp.PLAN_ARRAYS:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _random_tail(rng, nsb, nv, m):
    sb = rng.integers(0, nsb, size=m)
    lane = rng.integers(0, 128, size=m)
    dst = np.sort(rng.integers(0, nv, size=m))
    return sb, lane, np.searchsorted(dst, np.arange(nv + 1))


@pytest.mark.parametrize("source", ["rmat10_14", "random", "empty"])
@pytest.mark.parametrize("split_rows", [0, 2])
def test_grouped_plan_plane_for_plane(source, split_rows, tmp_path):
    if source == "rmat10_14":
        p = tts.plan_hybrid(tgen.rmat(10, 14, seed=3))
        tail = (p.tail_sb, p.tail_lane, p.tail_row_ptr)
    else:
        rng = np.random.default_rng(11)
        tail = _random_tail(rng, 40, 600, 0 if source == "empty" else 9000)
    a = jmtp.plan_grouped_tail(*tail, split_rows=split_rows)
    b = tmtp.plan_grouped_tail(*tail, split_rows=split_rows)
    assert_same_grouped(a, b)
    assert a.stats == b.stats
    # Grouped plan caches cross-load.
    jmtp.save_grouped_plan(str(tmp_path / "j"), a)
    tmtp.save_grouped_plan(str(tmp_path / "t"), b)
    assert_same_grouped(tmtp.load_grouped_plan(str(tmp_path / "j")), a)
    assert_same_grouped(jmtp.load_grouped_plan(str(tmp_path / "t")), b)


@pytest.mark.parametrize("align", [1, 8])
def test_reference_walks_match_jax(align):
    # The copied reference scheduler (merge_tail_ref) gives the same
    # schedules and simulated streams in both packages.
    from lux_tpu.ops import merge_tail_ref as jref
    from lux_tpu_torch.ops import merge_tail_ref as tref

    rng = np.random.default_rng(align)
    for _ in range(3):
        runs = [np.sort(rng.integers(0, 40, int(rng.poisson(20))))
                for _ in range(int(rng.integers(1, 9)))]
        values = [rng.standard_normal(len(r)) for r in runs]
        jl, ji, jr = jref.schedule_grouped(runs, align)
        tl, ti, tr = tref.schedule_grouped(runs, align)
        assert (ji, jr) == (ti, tr)
        for a, b in zip(jl, tl):
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(
            jref.simulate_grouped(runs, values, align)[0],
            tref.simulate_grouped(runs, values, align)[0])
        jfinal, jf, _ = jref.simulate(runs, values)
        tfinal, tf, _ = tref.simulate(runs, values)
        np.testing.assert_array_equal(jfinal, tfinal)
        np.testing.assert_array_equal(jf, tf)
