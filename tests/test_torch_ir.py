"""The port's IR tier (``lux_tpu_torch/analysis/ir.py`` over
``analysis/trace.py``): LUX101-105 over a torch trace of each executor's
step, against ``lux_tpu``'s jaxpr tier.

Seeded-violation convention (tests/torch_ir_fixtures/): each
``lux1NN_*.py`` module exposes ``TRACES`` and must make ``luxlint --ir``
exit 1 with exactly its own rule firing, the rule ``lux_tpu``'s fixture
of the same stem (tests/ir_fixtures/) fires. The reference tier runs
under JAX 0.9 with ``jax.core.ClosedJaxpr``/``Jaxpr`` aliased to
``jax.extend.core``'s inside each test (its ``iter_eqns`` looks them up
there); nothing of ``lux_tpu`` is edited.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from lux_tpu_torch.analysis import ir, trace
from lux_tpu_torch.parallel.mesh import LocalMesh
from lux_tpu_torch.utils import tracehooks

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "torch_ir_fixtures")
JAX_FIXTURES = os.path.join(TESTS, "ir_fixtures")
IR_STEMS = ("lux101_dtype_drift", "lux102_host_callback", "lux103_blowup",
            "lux104_donation", "lux105_collective")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("LUX_PLATFORM", "cpu")


def _rules(report):
    return sorted({f.rule for r in report.results for f in r.findings})


def _expected(path):
    """The rule ids of a fixture's ``# expect:`` markers."""
    with open(path, encoding="utf-8") as fh:
        return sorted(set(re.findall(r"# expect: (LUX\d+)", fh.read())))


def _alias_jax(monkeypatch):
    """Run lux_tpu's tier under the installed JAX: its jaxpr walk looks
    for ``jax.core.ClosedJaxpr``/``Jaxpr``, which JAX 0.9 keeps in
    ``jax.extend.core`` only."""
    jax = pytest.importorskip("jax")
    import jax.extend.core as jcore

    monkeypatch.setattr(jax.core, "ClosedJaxpr", jcore.ClosedJaxpr,
                        raising=False)
    monkeypatch.setattr(jax.core, "Jaxpr", jcore.Jaxpr, raising=False)


def _target(call, args, **spec):
    return ir.target_from_spec(spec.pop("name", "unit@test"),
                               dict(spec, call=call, args=args))


def _check(target, rules=None):
    return ir.run_targets([target], rules)


# -- fixtures ---------------------------------------------------------------


@pytest.mark.parametrize("stem", IR_STEMS)
def test_fixture_fires_exactly_its_rule(stem):
    path = os.path.join(FIXTURES, stem + ".py")
    report = ir.run_targets(ir.load_fixture_targets(path))
    assert not report.ok
    assert _rules(report) == _expected(path) == ["LUX" + stem[3:6]]
    assert not [r.error for r in report.results if r.error]


@pytest.mark.parametrize("stem", IR_STEMS)
def test_fixture_matches_lux_tpu(stem, monkeypatch):
    _alias_jax(monkeypatch)
    from lux_tpu.analysis import ir as jir

    path = os.path.join(JAX_FIXTURES, stem + ".py")
    theirs = jir.run_targets(jir.load_fixture_targets(path))
    mine = ir.run_targets(ir.load_fixture_targets(
        os.path.join(FIXTURES, stem + ".py")))
    assert _rules(theirs) == _rules(mine) == _expected(path)
    assert len(theirs.results) == len(mine.results)


# -- the registry -------------------------------------------------------


def test_registry_names_equal_lux_tpu(monkeypatch):
    _alias_jax(monkeypatch)
    from lux_tpu.analysis import ir as jir

    theirs = {name for name, _, _, _ in jir._registry_executors()}
    mine = {name for name, _, _, _ in ir._registry_executors(device=CPU)}
    assert len(theirs) == 59
    assert mine == theirs


@pytest.fixture(scope="module")
def registry():
    """The 59 registry targets on the CPU, built once for the module
    (each trace runs on copies of their args)."""
    return ir.registry_targets(device=CPU)


def test_registry_is_clean(registry):
    targets = registry
    assert len(targets) == 59
    assert {t.kind for t in targets} == {
        "pull", "tiled", "push", "push_multi", "push_incremental", "gas",
        "gas_multi", "pull_sharded", "tiled_sharded", "push_sharded",
        "push_multi_sharded", "gas_sharded", "gas_multi_sharded"}
    report = ir.run_targets(targets)
    assert report.ok, report.format_human()
    assert report.summary()["schema"] == "luxlint.ir.v1"
    assert report.summary()["files"] == 59


def _reused_argnums(tr):
    """Argnums every buffer of which an output of the step reuses."""
    outs = {r.lid for r in tr.out_leaves if isinstance(r, trace.Ref)}
    return {i for i, lids in enumerate(tr.arg_lids) if lids and lids <= outs}


def test_donation_declarations_are_exact(registry):
    seen = 0
    for t in registry:
        tr = ir.trace_target(t)
        assert _reused_argnums(tr) == set(t.donate), t.name
        seen += 1
    assert seen == 59


def test_trace_kernel_nodes_per_kind(registry):
    # Each kind's trace holds its kernels as single nodes, and the
    # sharded ones their collectives with lux_tpu's byte prices.
    want = {"pagerank@tiled": {"lux.strip_level_spmv",
                               "lux.lane_select_tail_sums"},
            # Fewer than 1,024 edges: the push engine has no sparse
            # branch on the registry's graph.
            "sssp@push": {"lux.segment_minmax_relax"},
            "bfs@gas": {"lux.gas_pull_acc", "lux.frontier_queue",
                        "lux.gas_push_acc"},
            "pagerank@pull": {"lux.pull_sum"},
            "colfilter@pull_sharded": {"lux.pull_sum", "all_gather"}}
    got = {t.name: t for t in registry if t.name in want}
    for name, ops in want.items():
        tr = ir.trace_target(got[name])
        assert {op for op, _, _ in trace.kernel_sequence(tr)} == ops, name


# -- rule units (tests/test_ir.py's, over torch steps) -----------------------


def test_lux101_dtype_drift_and_round_trip():
    x = torch.zeros(64)
    drift = _target(lambda v: v.to(torch.bfloat16), (x,))
    assert _rules(_check(drift)) == ["LUX101"]
    wide = _target(lambda v: (v.double() * 2).float(), (x,))
    f = _check(wide).results[0].findings
    assert {g.rule for g in f} == {"LUX101"} and "float64" in f[0].message
    assert all(g.line > 0 for g in f)
    # A 64-bit input makes 64-bit intermediates legitimate.
    legit = _target(lambda v: v * 2, (torch.zeros(8, dtype=torch.float64),))
    assert _check(legit).ok
    # int64 is torch's index dtype, not drift.
    idx = _target(lambda v: v + v.nonzero().sum().float(), (x,))
    assert _check(idx).ok
    # Two carry leaves, one output: the carry cannot round-trip.
    short = _target(lambda a, b: a + b, (x, x), carry=(0, 1))
    msgs = [g.message for g in _check(short).results[0].findings]
    assert len(msgs) == 1 and "cannot round-trip" in msgs[0]
    assert _check(_target(lambda v: v * 0.5, (x,))).ok


@pytest.mark.parametrize("read", ["item", "cpu", "tolist", "float",
                                  "numpy"])
def test_lux102_host_read_inside_a_step(read):
    def step(v):
        s = v.sum()
        if read == "item":
            return v + s.item()
        if read == "float":
            return v + float(s)
        if read == "cpu":
            return v + s.cpu()
        if read == "tolist":
            return v + v.tolist()[0]
        return v + float(v.numpy()[0])

    f = _check(_target(step, (torch.ones(8),))).results[0].findings
    assert f and {g.rule for g in f} == {"LUX102"}
    assert all(g.line > 0 and "host callback `host." in g.message
               for g in f)
    # Outside a trace the hooks are gone and cost nothing.
    assert torch.Tensor.item.__qualname__ != "call"
    assert step(torch.ones(8)).shape == (8,)


def test_lux103_blowup_and_its_override(monkeypatch):
    step = _target(lambda v: torch.outer(v, v).sum(1), (torch.zeros(64),))
    f = _check(step).results[0].findings
    assert [g.rule for g in f] == ["LUX103"]
    assert "64x the step inputs" in f[0].message
    monkeypatch.setenv("LUX_IR_BLOWUP", "100")
    assert _check(step).ok


def test_lux104_donation_honoured_and_unusable():
    def inplace(v):
        return v.mul_(0.85).add_(0.15)

    honoured = _target(inplace, (torch.ones(16),), donate=(0,))
    assert _check(honoured).ok
    unusable = _target(lambda v: v.sum(), (torch.ones(16),), donate=(0,),
                       carry=())
    f = _check(unusable).results[0].findings
    assert [g.rule for g in f] == ["LUX104"]
    assert "1 of 1 donated buffers" in f[0].message
    # Half a state reused is not a donation of the state.
    part = _target(lambda st: (st[0], st[1] + 1),
                   ((torch.ones(4), torch.ones(4)),), donate=(0,))
    assert "1 of 2" in _check(part).results[0].findings[0].message


def test_lux105_collectives_both_ways():
    mesh = LocalMesh(4, CPU)
    x = torch.zeros(4, 8)
    single = _target(lambda v: mesh.all_gather(v).view(4, 8) + 1, (x,))
    f = _check(single).results[0].findings
    assert [g.rule for g in f] == ["LUX105"] and "all_gather" in f[0].message
    assert _check(_target(lambda v: mesh.all_gather(v).view(4, 8) + 1, (x,),
                          sharded=True)).ok
    silent = _target(lambda v: v * 0.85, (x,), sharded=True)
    f = _check(silent).results[0].findings
    assert [g.rule for g in f] == ["LUX105"] and f[0].line == 0
    # reduce_scatter is a collective too (lux_tpu's psum_scatter).
    rs = _target(lambda v: mesh.reduce_scatter(v.repeat(1, 4)), (x,),
                 sharded=True)
    assert _check(rs).ok


def test_trace_failure_is_an_error_not_a_crash():
    def boom(v):
        raise RuntimeError("bad step")

    res = _check(_target(boom, (torch.zeros(2),))).results[0]
    assert res.error and "trace failed" in res.error and not res.findings
    assert tracehooks.current() is None       # the recorder is gone


def test_trace_records_buffers_versions_and_liveness():
    mesh = LocalMesh(2, CPU)

    def step(v):
        t = mesh.all_gather(v)
        out = v.new_full((8,), 3.0)
        out.index_copy_(0, torch.arange(4), t[:4])
        return out.view(2, 4)[:, :-1]

    tr = trace.trace_call(step, (torch.zeros(2, 4),))
    gather = tr.nodes[0]
    assert gather.op == "all_gather" and gather.kind == "collective"
    assert gather.nbytes == 2 * 1 * 16 and gather.fresh == [True]
    copy = next(n for n in tr.nodes if n.op == "aten.index_copy_.default")
    buf = tr.buffers[copy.writes[0].lid]
    assert buf.fill == 3.0 and buf.version == 1 and buf.tainted
    # The collective's rows: tainted, and (like every value computed
    # from the args) input-derived.
    assert copy.data_taint and copy.data_input
    # The view returned aliases the written buffer at its new version.
    assert tr.out_leaves[0].lid == buf.lid and tr.out_leaves[0].version == 1
    arg = tr.buffers[tr.nodes[0].inputs[0].lid]
    assert arg.pinned and arg.arg == 0 and arg.defined_by == 0
    assert buf.defined_by > 0 and buf.last_use >= copy.index


def test_alternatives_and_side_effects_restore():
    class Ex:
        log = [1]

    ex = Ex()

    def step(v):
        with tracehooks.preserved(ex, "log"):
            ex.log.append(2)
            alt = tracehooks.alternatives()
            with alt.branch("a"):
                a = v + 1
            with alt.branch("b"):
                b = v * 2
        return a if b is None else b

    tr = trace.trace_call(step, (torch.zeros(3),))
    assert ex.log == [1]
    assert [n.alt[0][:2] for n in tr.nodes] == [(1, 0), (1, 1)]
    assert tr.groups == {1: 2}


# -- executors: traced steps leave them as they were ------------------------


def _graphs():
    from lux_tpu_torch.graph.generate import rmat, small_world
    from lux_tpu_torch.graph.graph import Graph

    g = rmat(9, 8, seed=3)
    sw = small_world(512, k=4, p_rewire=0.05, seed=5)
    rng = np.random.default_rng(5)
    sww = Graph(nv=sw.nv, ne=sw.ne, row_ptr=sw.row_ptr, col_src=sw.col_src,
                weights=rng.integers(1, 101, sw.ne, dtype=np.int32))
    return g, sw, sww


def _run_to_end(ex, kind):
    if kind in ("pull", "tiled", "pull_sharded", "tiled_sharded"):
        return [ex.run(3)]
    if kind in ("push_multi", "gas_multi", "push_multi_sharded",
                "gas_multi_sharded"):
        st, it = ex.run([0, 1])
        return [st.values, st.frontier, it]
    if kind == "push_incremental":
        old = ex.push.values(ex.push.run()[0])
        st, it, info = ex.run(old, max_iters=4)
        return [st.values, it, info["frontier"], ex.host_seconds.keys()]
    st, it = ex.run(max_iters=6)
    return [st.values, st.frontier, it, getattr(ex, "branch_log", None),
            getattr(ex, "direction_log", None),
            getattr(ex, "queue_log", None)]


@pytest.mark.parametrize("kind,prog,mode", [
    ("pull", "pagerank", ""), ("tiled", "pagerank", ""),
    ("push", "sssp", ""), ("push_multi", "sssp", ""),
    ("push_incremental", "components", ""), ("gas", "bfs", ""),
    ("gas_multi", "sssp_delta", ""), ("pull_sharded", "pagerank", "compact"),
    ("tiled_sharded", "pagerank", ""), ("push_sharded", "sssp", "compact"),
    ("push_multi_sharded", "sssp", "compact"),
    ("gas_sharded", "bfs", "frontier"),
    ("gas_multi_sharded", "sssp_delta", "compact")])
def test_traced_step_leaves_the_executor_unchanged(kind, prog, mode,
                                                   monkeypatch):
    from lux_tpu_torch.models import PROGRAMS, ROOTED_APPS

    if mode:
        monkeypatch.setenv("LUX_EXCHANGE", mode)
    g, sw, sww = _graphs()
    program = PROGRAMS[prog]()
    graph = (sww if program.needs_weights else sw) if mode else (
        sww if program.needs_weights else g)
    kw = {"device": CPU}
    if kind.endswith("sharded"):
        kw["num_parts"] = 4
    ex = ir.build_executor(kind, graph, program, **kw)
    if mode:
        assert ex.exchange_mode == mode
    init = {"start": 0} if prog in ROOTED_APPS else {}
    want = _run_to_end(ex, kind)
    res = ir.check_target(ir.target_from_spec(
        f"{prog}@{kind}", ex.trace_step(**init)), ir.all_ir_rules()
        + ir.exchange_ir_rules())
    assert not res.findings and not res.error, (res.findings, res.error)
    got = _run_to_end(ex, kind)
    for a, b in zip(want, got):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        elif kind != "push_incremental" or not isinstance(a, float):
            assert a == b


# -- the pool -----------------------------------------------------------


def test_pool_runs_and_counts_the_audit():
    from lux_tpu_torch.models import PROGRAMS
    from lux_tpu_torch.obs import metrics
    from lux_tpu_torch.serve.pool import IR_AUDIT_STATUS, EnginePool

    metrics.reset()
    g, _, _ = _graphs()
    pool = EnginePool("ir")
    pool.get(("push",), lambda: ir.build_executor(
        "push", g, PROGRAMS["sssp"](), device=CPU))
    pool.get(("tiled",), lambda: ir.build_executor(
        "tiled", g, PROGRAMS["pagerank"](), device=CPU))

    class Claims:
        """An engine whose step claims a donation it does not make."""

        def trace_step(self, **kw):
            return {"call": lambda v: v.sum(), "args": (torch.ones(4),),
                    "donate": (0,), "carry": ()}

    pool.get(("claims",), Claims)
    audits = pool.audits()["ir"]
    assert audits["status"] == IR_AUDIT_STATUS
    # The two executors donate nothing: their declarations are read and
    # no step runs. The claiming engine's step runs, and is caught.
    assert audits["undonated_builds"] == 2
    assert audits["audited_builds"] == 1 and audits["findings"] == 1
    assert pool.stats()["ir_findings"] == 1
    assert len(pool) == 3
    pool.close()


def test_jax_fixtures_are_refused_unexecuted():
    with pytest.raises(ImportError, match="imports jax"):
        ir.load_fixture_targets(os.path.join(JAX_FIXTURES,
                                             "lux101_dtype_drift.py"))


def test_audit_engine_honours_a_real_donation():
    class Reuses:
        def trace_step(self, **kw):
            return {"call": lambda v: v.mul_(2), "args": (torch.ones(4),),
                    "donate": (0,)}

    assert ir.audit_engine(Reuses(), "pool@reuses") == []
    assert ir.audit_engine(object(), "pool@none") == []


# -- the CLI ------------------------------------------------------------


def _luxlint(*args):
    return subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", *args],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, LUX_PLATFORM="cpu"))


def _main(capsys, *args):
    """luxlint's ``main`` in this process: (rc, stdout, stderr)."""
    from lux_tpu_torch.tools import luxlint

    capsys.readouterr()
    try:
        rc = luxlint.main(list(args))
    except SystemExit as e:        # argparse's refusals
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def _summary(stdout):
    line = [ln for ln in stdout.splitlines() if ln.startswith("LUXLINT ")]
    return json.loads(line[-1][len("LUXLINT "):])


def test_cli_registry_is_clean():
    proc = _luxlint("--ir")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    s = _summary(proc.stdout)
    assert s["schema"] == "luxlint.ir.v1" and s["files"] == 59
    assert s["findings"] == 0 and s["errors"] == 0


def test_cli_fixtures_baseline_and_refusals(tmp_path, capsys):
    paths = [os.path.join(FIXTURES, s + ".py") for s in IR_STEMS]
    proc = _luxlint("--ir", "--json", *paths)
    assert proc.returncode == 1
    doc = json.loads(proc.stdout[:proc.stdout.rindex("LUXLINT")])
    assert sorted(doc["summary"]["by_rule"]) == [
        "LUX" + s[3:6] for s in IR_STEMS]
    # The ratchet and the refusals through ``main`` in this process.
    base = str(tmp_path / "base.json")
    assert _main(capsys, "--ir", "--baseline", base, *paths[:2])[0] == 0
    # Known findings pass the ratchet; a new fixture's escape it.
    rc, out, _ = _main(capsys, "--ir", "--baseline", base, *paths[:3])
    new = [ln for ln in out.splitlines() if ln.endswith("[new]")]
    assert rc == 1
    assert new and all(" LUX103 " in ln for ln in new)
    rc, _, err = _main(capsys, "--memory")
    assert rc == 2 and "memck" in err
    rc, _, err = _main(capsys, "--ir", "--exchange")
    assert rc == 2 and "separate tiers" in err
