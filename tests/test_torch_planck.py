"""Port parity: the grouped-tail plan tier (LUX201-205) of
``lux_tpu_torch.analysis.planck`` against ``lux_tpu.analysis.planck``,
artifacts across the two packages, and ``luxlint --plans``.

Plans are byte-identical between the packages (tests/test_torch_plan.py),
so on the same plan — from either package's planner, in memory or saved
by either package's ``save_grouped_plan`` — both verifiers must give the
same findings (rule, path, line, message).
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from lux_tpu.analysis import planck as jplanck
from lux_tpu.graph import generate as jgen
from lux_tpu.ops import merge_tail_plan as jmtp
from lux_tpu.ops import tiled_spmv as jts
from lux_tpu_torch.analysis import planck
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.ops import merge_tail_plan as tmtp
from lux_tpu_torch.ops import tiled_spmv as tts

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
JLUXLINT = os.path.join(REPO, "tools", "luxlint.py")

# Every edge in the tail, so the grouped plan carries the whole graph.
ALL_TAIL = ((8, 10 ** 9),)
GRAPHS = {
    "rmat10": lambda m: m.rmat(10, 16, seed=0),
    "small_world": lambda m: m.small_world(4096, k=8, seed=1),
    "star": lambda m: m.star_graph(3000),
}
PLANNERS = {"lux_tpu": (jgen, jts, jmtp), "lux_tpu_torch": (tgen, tts, tmtp)}


def _plan(graph: str, planner: str = "lux_tpu_torch"):
    gen, ts, mtp = PLANNERS[planner]
    hp = ts.plan_hybrid(GRAPHS[graph](gen), levels=ALL_TAIL)
    return mtp.plan_grouped_tail(hp.tail_sb, hp.tail_lane, hp.tail_row_ptr)


def _keys(result):
    return [(f.rule, f.path, f.line, f.col, f.message)
            for f in result.findings]


def _both(plan, path="<plan>"):
    mine = planck.verify_plan(plan, path)
    theirs = jplanck.verify_plan(plan, path)
    assert mine.error is None and theirs.error is None
    assert _keys(mine) == _keys(theirs)
    return {f.rule for f in mine.findings}


def _mutable(plan, **over):
    d = {n: np.array(getattr(plan, n)) for n in planck.PLAN_ARRAYS}
    d.update(n_edges=plan.n_edges, n_levels=plan.n_levels,
             stats=dict(plan.stats))
    d.update(over)
    return types.SimpleNamespace(**d)


def _luxlint(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", *args],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, **(env or {})))


def _summary(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("LUXLINT ")]
    assert lines, stdout
    return json.loads(lines[-1][len("LUXLINT "):])


def test_constants_mirror_the_ports_planner():
    assert planck.PLAN_ARRAYS == tmtp.PLAN_ARRAYS
    assert planck.PLAN_FORMAT == tmtp.PLAN_FORMAT
    assert (planck.PLAN_ARRAYS, planck.PLAN_FORMAT, planck.PLAN_SCHEMA,
            planck.BLOCK, planck.ALIGN_ROWS) == (
        jplanck.PLAN_ARRAYS, jplanck.PLAN_FORMAT, jplanck.PLAN_SCHEMA,
        jplanck.BLOCK, jplanck.ALIGN_ROWS)
    assert [(r.id, r.title) for r in planck.all_plan_rules()] == \
        [(r.id, r.title) for r in jplanck.all_plan_rules()]


@pytest.mark.parametrize("planner", sorted(PLANNERS))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_planner_output_verifies_clean_in_both(graph, planner):
    plan = _plan(graph, planner)
    assert plan.n_edges > 0
    assert _both(plan, f"{graph}@{planner}") == set()


def _corrupt(plan, rule):
    if rule == "LUX201":
        lp = np.array(plan.level_ptr)
        lp[-1] += 8
        return _mutable(plan, level_ptr=lp)
    if rule == "LUX202":
        nv = np.array(plan.nvalid)
        nv[int(np.argmax(nv < planck.BLOCK))] += 1
        return _mutable(plan, nvalid=nv)
    if rule == "LUX203":
        codes = np.array(plan.codes)
        r0 = int(plan.level_ptr[1])
        codes[int(np.argmax(np.asarray(plan.nvalid)[:r0] > 0)), 0] = -5
        return _mutable(plan, codes=codes)
    if rule == "LUX204":
        lp = np.array(plan.level_ptr)
        lp[1] += 1
        return _mutable(plan, level_ptr=lp)
    raise ValueError(rule)


@pytest.mark.parametrize("graph", ["rmat10", "small_world"])
@pytest.mark.parametrize("rule", ["LUX201", "LUX202", "LUX203", "LUX204"])
def test_corruption_gives_lux_tpus_findings(graph, rule):
    got = _both(_corrupt(_plan(graph), rule), f"{graph}/{rule}")
    assert rule in got
    if rule in ("LUX202", "LUX203"):
        assert got == {rule}


def test_copy_rate_bound_is_the_ports_flag(monkeypatch):
    plan = _plan("rmat10")
    monkeypatch.setenv("LUX_PLANCK_INFLATION", "0.01")
    assert _both(plan) == {"LUX205"}
    monkeypatch.delenv("LUX_PLANCK_INFLATION")
    assert _both(plan) == set()


@pytest.mark.parametrize("writer", ["lux_tpu", "lux_tpu_torch"])
def test_artifacts_load_and_verify_across_packages(tmp_path, writer):
    plan = _plan("small_world", writer)
    path = str(tmp_path / "plan")
    (jmtp if writer == "lux_tpu" else tmtp).save_grouped_plan(path, plan)
    for mod in (planck, jplanck):
        loaded = mod.load_plan_artifact(path)
        assert (loaded.n_edges, loaded.n_levels) == (plan.n_edges,
                                                     plan.n_levels)
        for name in planck.PLAN_ARRAYS:
            np.testing.assert_array_equal(np.asarray(getattr(loaded, name)),
                                          np.asarray(getattr(plan, name)))
    # The port's own loader (the executor's) reads the other package's.
    back = (tmtp if writer == "lux_tpu" else jmtp).load_grouped_plan(path)
    np.testing.assert_array_equal(np.asarray(back.codes), plan.codes)
    mine = planck.verify_plan_dirs([path])
    theirs = jplanck.verify_plan_dirs([path])
    assert mine.ok and theirs.ok
    assert mine.summary()["schema"] == "luxlint.plan.v1"
    # A flipped code fails both the same way.
    codes = np.load(os.path.join(path, "codes.npy"))
    r0 = int(plan.level_ptr[1])
    codes[int(np.argmax(np.asarray(plan.nvalid)[:r0] > 0)), 0] = -5
    np.save(os.path.join(path, "codes.npy"), codes)
    mine = planck.verify_plan_dirs([path])
    theirs = jplanck.verify_plan_dirs([path])
    assert [_keys(r) for r in mine.results] == \
        [_keys(r) for r in theirs.results]
    assert {f.rule for f in mine.findings} == {"LUX203"}


def test_unloadable_dirs_are_errors(tmp_path):
    report = planck.verify_plan_dirs([str(tmp_path / "nope")])
    assert not report.ok and "unloadable" in report.results[0].error
    d = tmp_path / "future"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps({"format": 99}))
    report = planck.verify_plan_dirs([str(d)])
    assert not report.ok and "unknown format" in report.results[0].error


def test_cli_plans_equals_tools_luxlint(tmp_path):
    plan = _plan("rmat10")
    good, bad = str(tmp_path / "good"), str(tmp_path / "bad")
    tmtp.save_grouped_plan(good, plan)
    tmtp.save_grouped_plan(bad, _corrupt(plan, "LUX202"))
    ok = _luxlint("--plans", good)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    s = _summary(ok.stdout)
    assert s["schema"] == "luxlint.plan.v1" and s["findings"] == 0
    for args in (("--plans", good, bad), ("--plans", "--json", bad),
                 ("--plans", "--select", "LUX201", bad)):
        mine = _luxlint(*args)
        theirs = subprocess.run([sys.executable, JLUXLINT, *args],
                                capture_output=True, text=True, cwd=REPO)
        assert mine.returncode == theirs.returncode, args
        if "--json" in args:
            a, b = (json.loads(p.stdout[:p.stdout.rindex("LUXLINT")])
                    for p in (mine, theirs))
            a["summary"].pop("elapsed_s")
            b["summary"].pop("elapsed_s")
            assert a == b
        else:
            assert [ln for ln in mine.stdout.splitlines()
                    if ": LUX" in ln] == [ln for ln in theirs.stdout
                                          .splitlines() if ": LUX" in ln]
    one = _luxlint("--plans", bad)
    assert one.returncode == 1
    assert _summary(one.stdout)["by_rule"] == {"LUX202": 1}
    assert _luxlint("--plans").returncode == 2
