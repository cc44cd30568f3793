"""Port parity: the plan half of the exchange tier (LUX401-403, 407) of
``lux_tpu_torch.analysis.exchck`` against ``lux_tpu.analysis.exchck``,
``save_exchange_artifact`` across the two packages, ``luxlint
--exchange`` (registry mode and paths), and the serving pool's exchange
audit.

Exchange plans are byte-identical between the packages
(tests/test_torch_partition.py), so on the same plan and evidence both
verifiers must give the same findings (rule, path, line, message).
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from lux_tpu.analysis import exchck as jexchck
from lux_tpu.graph import generate as jgen
from lux_tpu.graph import partition as jpart
from lux_tpu.obs import engobs as jengobs
from lux_tpu.parallel import shard as jshard
from lux_tpu_torch.analysis import exchck, ir
from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.graph import partition as tpart
from lux_tpu_torch.models import PageRank
from lux_tpu_torch.obs import engobs, metrics
from lux_tpu_torch.parallel import shard as tshard
from lux_tpu_torch.serve.pool import EXCH_AUDIT_STATUS, EnginePool

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
JLUXLINT = os.path.join(REPO, "tools", "luxlint.py")
EXCH_FIXTURES = os.path.join(TESTS, "exch_fixtures")

GRAPHS = {
    "rmat10": lambda m: m.rmat(10, 8, seed=0),
    "small_world": lambda m: m.small_world(1024, k=4, p_rewire=0.05,
                                           seed=7),
    "star": lambda m: m.star_graph(600),
}
PACKAGES = {"lux_tpu": (jgen, jshard, jengobs),
            "lux_tpu_torch": (tgen, tshard, engobs)}
PLAN_FIXTURES = ("lux401_structure", "lux402_coverage",
                 "lux403_profitability", "lux407_frontier")
TRACE_FIXTURES = ("lux404_overlap", "lux405_sentinel", "lux406_bytes")
ROW_BYTES = 8


def _live(graph: str, package: str = "lux_tpu_torch", parts: int = 4):
    """(plan, evidence) of a 4-part partition, as the executors price
    it."""
    gen, shard, obs = PACKAGES[package]
    sg = shard.ShardedGraph.build(GRAPHS[graph](gen), parts)
    plan = sg.exchange_plan()
    ev = {"remote_read_counts": sg.remote_read_counts(),
          "row_bytes": ROW_BYTES,
          "declared_bytes_per_iter": plan.exchange_bytes_per_iter(ROW_BYTES),
          "ledger": obs.useful_exchange(
              sg, ROW_BYTES, exchanged_rows=plan.exchanged_units_per_iter)}
    return plan, ev


def _keys(result):
    return [(f.rule, f.path, f.line, f.col, f.message)
            for f in result.findings]


def _both(plan, path="<exchange-plan>", **ev):
    mine = exchck.verify_exchange_plan(exchck.plan_view(plan, **ev), path)
    theirs = jexchck.verify_exchange_plan(jexchck.plan_view(plan, **ev),
                                          path)
    assert mine.error is None and theirs.error is None
    assert _keys(mine) == _keys(theirs)
    return {f.rule for f in mine.findings}


def _copy(plan, **over):
    d = {n: np.array(getattr(plan, n))
         for n in ("counts", "send_units", "recv_pos")}
    d.update(num_parts=plan.num_parts, max_units=plan.max_units,
             unit_rows=plan.unit_rows, capacity=plan.capacity,
             profitable=plan.profitable)
    d.update(over)
    return types.SimpleNamespace(**d)


def _first_real(plan):
    """(sender, receiver, slot) of a real off-diagonal slot."""
    P, cap = plan.num_parts, plan.capacity
    counts = np.asarray(plan.counts)
    for q in range(P):
        for p in range(P):
            if p != q and counts[q, p] > 0:
                return p, q, 0
    raise AssertionError("plan has no remote rows")


def _luxlint(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", *args],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, **(env or {})))


def _summary(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("LUXLINT ")]
    assert lines, stdout
    return json.loads(lines[-1][len("LUXLINT "):])


# -- the format and the rules ---------------------------------------------


def test_constants_mirror_both_partitions():
    assert exchck.EXCH_ARRAYS == tpart.EXCHANGE_PLAN_ARRAYS \
        == jpart.EXCHANGE_PLAN_ARRAYS
    assert exchck.EXCH_FORMAT == tpart.EXCHANGE_PLAN_FORMAT \
        == jpart.EXCHANGE_PLAN_FORMAT
    assert exchck.EXCHANGE_SCHEMA == jexchck.EXCHANGE_SCHEMA
    assert [(r.id, r.title) for r in exchck.all_exchange_rules()] == \
        [(r.id, r.title) for r in jexchck.all_exchange_rules()]


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_partitioner_plans_verify_clean_in_both(graph, package):
    plan, ev = _live(graph, package)
    assert _both(plan, f"{graph}@{package}", **ev) == set()


def _corrupt(plan, ev, rule):
    p, q, i = _first_real(plan)
    P, cap, mu = plan.num_parts, plan.capacity, plan.max_units
    if rule == "LUX401":
        recv = np.array(plan.recv_pos)
        recv[0, 0] = 0             # an own-pair slot carries a real row
        return _copy(plan, recv_pos=recv), ev
    if rule == "LUX402":
        recv = np.array(plan.recv_pos)
        recv[q, p * cap + i] += 1  # the row lands one slot off
        return _copy(plan, recv_pos=recv), ev
    if rule == "LUX403":
        return plan, dict(ev, declared_bytes_per_iter=ev[
            "declared_bytes_per_iter"] + ROW_BYTES)
    if rule == "LUX407":
        fcap = max(1, cap // 2)
        return plan, dict(ev, frontier_capacity=fcap,
                          frontier_max_sends=fcap, frontier_row_bytes=8,
                          frontier_bytes_per_iter=P * (P - 1) * fcap * 8,
                          frontier_fill_active=2)
    raise ValueError(rule)


@pytest.mark.parametrize("graph", ["small_world", "rmat10"])
@pytest.mark.parametrize("rule", ["LUX401", "LUX402", "LUX403", "LUX407"])
def test_corruption_gives_lux_tpus_findings(graph, rule):
    plan, ev = _live(graph)
    bad, bev = _corrupt(plan, ev, rule)
    got = _both(bad, f"{graph}/{rule}", **bev)
    assert rule in got
    if rule in ("LUX403", "LUX407"):
        assert got == {rule}


@pytest.mark.parametrize("stem", PLAN_FIXTURES)
def test_plan_fixtures_equal_lux_tpu(stem):
    path = os.path.join(EXCH_FIXTURES, stem + ".py")
    assert exchck.fixture_exports(path) == (True, False)
    mine = exchck.load_fixture_plans(path)
    theirs = jexchck.load_fixture_plans(path)
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    rules = set()
    for (name, mv), (_, tv) in zip(mine, theirs):
        a = exchck.verify_exchange_plan(mv, name)
        b = jexchck.verify_exchange_plan(tv, name)
        assert _keys(a) == _keys(b)
        rules |= {f.rule for f in a.findings}
    assert rules == {"LUX" + stem[3:6]}


# -- artifacts -----------------------------------------------------------


@pytest.mark.parametrize("writer", ["lux_tpu", "lux_tpu_torch"])
def test_artifacts_load_and_verify_across_packages(tmp_path, writer):
    plan, ev = _live("small_world", writer)
    d = str(tmp_path / "xplan")
    save = (jpart if writer == "lux_tpu" else tpart).save_exchange_artifact
    save(plan, d, remote_read_counts=ev["remote_read_counts"],
         row_bytes=ROW_BYTES, ledger=ev["ledger"])
    for mod in (exchck, jexchck):
        view = mod.load_exchange_artifact(d)
        assert view.declared_bytes_per_iter == ev["declared_bytes_per_iter"]
        assert view.ledger == {k: (float(v) if k == "ratio" else int(v))
                               for k, v in ev["ledger"].items()}
    mine, theirs = (exchck.verify_exchange_dirs([d]),
                    jexchck.verify_exchange_dirs([d]))
    assert mine.ok and theirs.ok
    assert mine.summary()["schema"] == "luxlint-exchange.v1"
    recv = np.load(os.path.join(d, "recv_pos.npy"))
    p, q, i = _first_real(plan)
    recv[q, p * plan.capacity + i] += 1
    np.save(os.path.join(d, "recv_pos.npy"), recv)
    mine, theirs = (exchck.verify_exchange_dirs([d]),
                    jexchck.verify_exchange_dirs([d]))
    assert [_keys(r) for r in mine.results] == \
        [_keys(r) for r in theirs.results]
    assert {f.rule for f in mine.findings} == {"LUX402"}


def test_artifact_files_equal_lux_tpus(tmp_path):
    plan, ev = _live("small_world")
    jplan, _ = _live("small_world", "lux_tpu")
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    tpart.save_exchange_artifact(plan, a, ev["remote_read_counts"],
                                 ROW_BYTES, ev["ledger"])
    jpart.save_exchange_artifact(jplan, b, ev["remote_read_counts"],
                                 ROW_BYTES, ev["ledger"])
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_unknown_format_is_an_error(tmp_path):
    plan, _ = _live("star")
    d = str(tmp_path / "xplan")
    tpart.save_exchange_artifact(plan, d)
    meta = json.load(open(os.path.join(d, "meta.json")))
    meta["format"] = 99
    json.dump(meta, open(os.path.join(d, "meta.json"), "w"))
    with pytest.raises(ValueError, match="unknown format"):
        exchck.load_exchange_artifact(d)
    report = exchck.verify_exchange_dirs([d])
    assert not report.ok and report.results[0].error


# -- luxlint --exchange ----------------------------------------------------


def test_registry_plans_are_clean_and_name_the_trace_half():
    proc = _luxlint("--exchange", env={"LUX_PLATFORM": "cpu"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    s = _summary(proc.stdout)
    assert s["schema"] == "luxlint-exchange.v1" and s["findings"] == 0
    # The trace half (LUX404-406) runs now: nothing names it unported.
    assert "not ported" not in proc.stderr
    report = ir.run_exchange_matrix(device="cpu")
    names = [r.path for r in report.results]
    assert len(names) == s["files"]
    plans = [n for n in names if n.endswith("/plan")]
    assert all(n.endswith("+compact/plan") or n.endswith("+frontier/plan")
               for n in plans)
    # Every plan's target was traced too, beside the full-mode targets.
    traced = set(names) - set(plans)
    assert {n[:-len("/plan")] for n in plans} <= traced
    assert any("+" not in n for n in traced)
    kinds = {n.split("@")[1].split("+")[0] for n in plans}
    assert kinds == {"pull_sharded", "tiled_sharded", "push_sharded",
                     "push_multi_sharded", "gas_sharded",
                     "gas_multi_sharded"}
    assert any(n.endswith("+frontier/plan") for n in names)


@pytest.mark.parametrize("stem", PLAN_FIXTURES)
def test_cli_plan_fixture_equals_tools_luxlint(stem):
    fix = os.path.join(EXCH_FIXTURES, stem + ".py")
    mine = _luxlint("--exchange", "--json", fix)
    theirs = subprocess.run([sys.executable, JLUXLINT, "--exchange",
                             "--json", fix],
                            capture_output=True, text=True, cwd=REPO)
    assert mine.returncode == theirs.returncode == 1
    a, b = (json.loads(p.stdout[:p.stdout.rindex("LUXLINT")])
            for p in (mine, theirs))
    a["summary"].pop("elapsed_s")
    b["summary"].pop("elapsed_s")
    assert a == b
    assert list(a["summary"]["by_rule"]) == ["LUX" + stem[3:6]]


@pytest.mark.parametrize("stem", TRACE_FIXTURES)
def test_trace_fixtures_are_not_ported_and_never_run(stem):
    fix = os.path.join(EXCH_FIXTURES, stem + ".py")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from lux_tpu_torch.analysis import ir\n"
         f"r = ir.run_exchange_paths([{fix!r}])\n"
         "print('jax' in sys.modules, r.ok)\n"
         "print(r.results[0].error)\n"],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    first, err = proc.stdout.splitlines()[:2]
    assert first == "False False"
    # The port traces torch steps; lux_tpu's jax fixtures are refused
    # unexecuted (their torch counterparts: tests/torch_ir_fixtures/).
    assert "imports jax" in err and "torch_ir_fixtures" in err
    cli = _luxlint("--exchange", fix)
    assert cli.returncode == 1 and "imports jax" in cli.stdout


def test_cli_exchange_select_baseline_and_errors(tmp_path):
    fix = os.path.join(EXCH_FIXTURES, "lux401_structure.py")
    sel = _luxlint("--exchange", fix, "--select", "LUX402")
    assert sel.returncode == 0 and _summary(sel.stdout)["findings"] == 0
    empty = tmp_path / "empty_fixture.py"
    empty.write_text("X = 1\n")
    none = _luxlint("--exchange", str(empty))
    assert none.returncode == 1 and "neither TRACES nor PLANS" in none.stdout
    assert _luxlint("--exchange", "--threads").returncode == 2
    fix3 = os.path.join(EXCH_FIXTURES, "lux403_profitability.py")
    base = str(tmp_path / "exch_baseline.json")
    p1 = _luxlint("--exchange", fix3, "--baseline", base)
    assert p1.returncode == 0 and "baseline written" in p1.stdout
    assert json.load(open(base))["keys"][0].startswith("LUX403")
    p2 = _luxlint("--exchange", fix3, "--baseline", base)
    assert p2.returncode == 0 and "0 new" in p2.stdout


# -- the serving pool's audit ----------------------------------------------


def _corrupt_engine():
    plan, _ = _live("small_world")
    p, q, i = _first_real(plan)
    recv = np.array(plan.recv_pos)
    recv[q, p * plan.capacity + i] += 1
    return types.SimpleNamespace(_xplan=_copy(plan, recv_pos=recv))


def test_pool_audit_counts_a_corrupt_plan():
    metrics.reset()
    pool = EnginePool("test-exch")
    pool.get("k1", _corrupt_engine)
    st = pool.stats()
    assert st["exch_findings"] == 1
    assert metrics.counter("lux_exch_findings_total").value == 1
    a = pool.audits()["exchck"]
    assert a["status"] == EXCH_AUDIT_STATUS
    assert a["audited_builds"] == 1 and a["findings"] == 1
    pool.close()


def test_pool_audit_clean_live_compact_engine(monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE", "compact")
    metrics.reset()
    g = tgen.halo(8, 128, hubs=8)
    pool = EnginePool("test-exch")
    ex = pool.get("k2", lambda: ShardedPullExecutor(
        g, PageRank(), num_parts=8, device="cpu"))
    assert ex._xplan is not None
    st = pool.stats()
    assert st["exch_findings"] == 0 and isinstance(st["exch_findings"], int)
    assert pool.audits()["exchck"]["audited_builds"] == 1
    pool.close()


def test_pool_audit_off_skips(monkeypatch):
    monkeypatch.setenv("LUX_EXCH_POOL_AUDIT", "0")
    metrics.reset()
    pool = EnginePool("test-exch")
    pool.get("k3", _corrupt_engine)
    assert pool.stats()["exch_findings"] == 0
    assert pool.audits()["exchck"]["audited_builds"] == 0
    pool.close()


def test_audit_exchange_survives_garbage():
    ex = types.SimpleNamespace(_xplan=types.SimpleNamespace(garbage=True))
    findings = exchck.audit_exchange(ex, "pool@garbage")
    assert findings and findings[0].rule == "LUX401"
    assert "audit crashed" in findings[0].message
    assert exchck.audit_exchange(types.SimpleNamespace(), "pool@none") == []
