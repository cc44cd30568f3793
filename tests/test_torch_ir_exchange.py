"""The trace half of the port's exchange tier: LUX404-406 over a torch
trace of each sharded executor's step (``lux_tpu_torch/analysis/ir.py``),
against ``lux_tpu``'s jaxpr rules.

Seeded-violation convention (tests/torch_ir_fixtures/): each
``lux40N_*.py`` module exposes ``TRACES`` and must make ``luxlint
--exchange`` exit 1 with exactly its own rule firing, the rule
``lux_tpu``'s fixture of the same stem (tests/exch_fixtures/) fires
(under the ``jax.extend.core`` alias set inside the test, as in
tests/test_torch_ir.py).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from lux_tpu_torch.analysis import ir, trace
from lux_tpu_torch.parallel.mesh import CompactExchange, LocalMesh
from lux_tpu_torch.utils import tracehooks

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "torch_ir_fixtures")
JAX_FIXTURES = os.path.join(TESTS, "exch_fixtures")
STEMS = ("lux404_overlap", "lux405_sentinel", "lux406_bytes")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("LUX_PLATFORM", "cpu")


def _rules(report):
    return sorted({f.rule for r in report.results for f in r.findings})


def _target(call, args, **spec):
    spec.setdefault("sharded", True)
    spec.setdefault("exchange_mode", "compact")
    spec.setdefault("num_parts", 4)
    return ir.target_from_spec(spec.pop("name", "unit@exchange"),
                               dict(spec, call=call, args=args))


def _check(target):
    return ir.check_target(target, ir.exchange_ir_rules())


# -- fixtures ---------------------------------------------------------------


@pytest.mark.parametrize("stem", STEMS)
def test_fixture_fires_exactly_its_rule(stem):
    report = ir.run_exchange_paths([os.path.join(FIXTURES, stem + ".py")])
    assert not report.ok and not [r for r in report.results if r.error]
    assert _rules(report) == ["LUX" + stem[3:6]]


@pytest.mark.parametrize("stem", STEMS)
def test_fixture_matches_lux_tpu(stem, monkeypatch):
    jax = pytest.importorskip("jax")
    import jax.extend.core as jcore

    monkeypatch.setattr(jax.core, "ClosedJaxpr", jcore.ClosedJaxpr,
                        raising=False)
    monkeypatch.setattr(jax.core, "Jaxpr", jcore.Jaxpr, raising=False)
    from lux_tpu.analysis import ir as jir

    theirs = jir.run_exchange_paths([os.path.join(JAX_FIXTURES,
                                                  stem + ".py")])
    mine = ir.run_exchange_paths([os.path.join(FIXTURES, stem + ".py")])
    assert _rules(theirs) == _rules(mine) == ["LUX" + stem[3:6]]
    assert theirs.schema == mine.schema == "luxlint-exchange.v1"


# -- the matrix -------------------------------------------------------------


def test_matrix_is_clean_and_traces_every_sharded_target():
    report = ir.run_exchange_matrix(device=CPU)
    assert report.ok, report.format_human()
    names = [r.path for r in report.results]
    assert len(names) == 63      # lux_tpu's matrix: 40 traces, 23 plans
    traced = [n for n in names if not n.endswith("/plan")]
    assert len(traced) == 40
    assert {n.split("@")[1].split("+")[0] for n in traced} == {
        "pull_sharded", "tiled_sharded", "push_sharded",
        "push_multi_sharded", "gas_sharded", "gas_multi_sharded"}
    assert sum(n.endswith("+frontier") for n in traced) == 6


def test_zero_pads_of_min_programs_fire_lux405(monkeypatch):
    # The compact and frontier tables pad with the combiner's identity;
    # the zero pad they had is what LUX405 finds on every min program.
    from lux_tpu_torch.engine.sharded import ShardedBase

    monkeypatch.setattr(ShardedBase, "_pad",
                        lambda self, s: False if s.dtype == torch.bool
                        else 0)
    report = ir.run_exchange_matrix(select={"LUX405"}, device=CPU)
    hit = sorted({r.path for r in report.results if r.findings})
    assert hit and {f.rule for r in report.results
                    for f in r.findings} == {"LUX405"}
    assert all(n.split("@")[0] in ("sssp", "sssp_delta", "bfs")
               for n in hit), hit
    assert "sssp_delta@gas_sharded+frontier" in hit


def test_compact_tables_pad_with_the_identity():
    from lux_tpu_torch.graph.generate import small_world
    from lux_tpu_torch.parallel.shard import ShardedGraph

    g = small_world(256, k=4, p_rewire=0.05, seed=2)
    sg = ShardedGraph.build(g, 4)
    mesh = LocalMesh(4, CPU)
    xch = CompactExchange(sg.exchange_plan(), mesh, sg.max_nv)
    vals = torch.arange(4 * sg.max_nv, dtype=torch.float32).view(4, -1)
    full = mesh.all_gather(vals)
    got = xch.tables(vals, float("inf"))
    read = torch.zeros_like(got, dtype=torch.bool)
    for q in range(4):
        read[q, torch.from_numpy(sg.src_pidx[q, :int(
            sg.local_row_ptr[q, -1])]).long()] = True
    assert torch.equal(got[read], full.expand(4, -1)[read])
    assert torch.isinf(got[~read]).any()


# -- rule units ---------------------------------------------------------


def _mesh_step(local_from_table=False, pad=0.0, own=True):
    mesh = LocalMesh(4, CPU)
    n = 16

    def step(vals):
        tbl = mesh.all_to_all(vals).reshape(-1)
        merged = vals.new_full((vals.numel(),), pad)
        merged.index_copy_(0, torch.arange(n, 2 * n), tbl[n:2 * n])
        if own:
            local = tbl[:n] if local_from_table else vals.reshape(-1)[:n]
            merged.index_copy_(0, torch.arange(n), local * 0.5)
        return merged.view(vals.shape)

    return step, (torch.ones(4, n),)


def test_lux404_merge_proof():
    assert _check(_target(*_mesh_step())).findings == []
    bad = _check(_target(*_mesh_step(local_from_table=True))).findings
    assert [f.rule for f in bad] == ["LUX404"] and bad[0].line > 0
    none = _check(_target(*_mesh_step(own=False))).findings
    assert [f.rule for f in none] == ["LUX404"] and none[0].line == 0
    assert "no local/remote merge point" in none[0].message
    # Full targets carry no merge to prove.
    assert _check(_target(*_mesh_step(own=False),
                          exchange_mode="full")).findings == []


@pytest.mark.parametrize("comb,pad,ok", [
    ("min", float("inf"), True), ("min", 0.0, False),
    ("max", float("-inf"), True), ("max", 0.0, False),
    ("sum", 0.0, True), ("sum", 1.0, False)])
def test_lux405_pad_against_the_combiner(comb, pad, ok):
    f = _check(_target(*_mesh_step(pad=pad), combiner=comb,
                       value_dtype="float32")).findings
    assert (f == []) == ok, f
    if not ok:
        assert [g.rule for g in f] == ["LUX405"]
        assert f"the {comb} identity for float32" in f[0].message


def test_lux405_uint32_words_and_where_pads():
    mesh = LocalMesh(4, CPU)

    def words(pad):
        def step(vals):
            tbl = mesh.all_to_all(vals).reshape(-1)
            merged = vals.new_full((vals.numel(),), pad)
            merged.index_copy_(0, torch.arange(8), tbl[:8])
            merged.index_copy_(0, torch.arange(8, 16), vals.reshape(-1)[:8])
            return merged.view(vals.shape)
        return step

    x = torch.zeros(4, 8, dtype=torch.int32)
    for pad, ok in ((-1, True), (0, False)):
        f = _check(_target(words(pad), (x,), combiner="min",
                           value_dtype="uint32")).findings
        assert (f == []) == ok, (pad, f)

    def where_pad(vals):
        tbl = mesh.all_gather(vals).view(vals.shape)
        return torch.where(tbl < 1e30, tbl, 0.0)

    f = _check(_target(where_pad, (torch.zeros(4, 8),), combiner="min",
                       value_dtype="float32")).findings
    assert "LUX405" in [g.rule for g in f]
    assert any("aten.where" in g.message for g in f)
    # No pad at all beside the exchanged rows: nothing proves them.
    silent = _check(_target(lambda v: mesh.all_gather(v).view(v.shape) * 2,
                            (torch.zeros(4, 8),), combiner="min",
                            value_dtype="float32")).findings
    assert [g.message[:20] for g in silent if g.rule == "LUX405"] == [
        "no min-identity pad "]


def test_lux406_bytes_and_alternatives():
    mesh = LocalMesh(4, CPU)

    def step(vals):
        alt = tracehooks.alternatives()
        with alt.branch("gather"):
            a = mesh.all_gather(vals).view(vals.shape)
        with alt.branch("to_all"):
            b = mesh.all_to_all(vals)
        with alt.branch("none"):
            pass
        return a + b + mesh.all_gather(vals).view(vals.shape)

    x = torch.zeros(4, 16)          # one part's operand: 64 bytes
    tr = ir.trace_target(_target(step, (x,)))
    assert ir._collective_byte_totals(tr) == {
        768 + 768, 768 + 192, 768}
    for claim, ok in ((1536, True), (960, True), (768, True), (1024, False)):
        f = _check(_target(step, (x,), exchange_bytes=claim,
                           exchange_mode="full")).findings
        assert (f == []) == ok, claim
    # reduce_scatter combines; no exchange_bytes model prices it.
    rs = ir.trace_target(_target(lambda v: mesh.reduce_scatter(
        v.repeat(1, 4)), (x,)))
    assert ir._collective_byte_totals(rs) == {0}


def test_sharded_traces_take_every_branch():
    # A frontier-mode GAS target traces push, the frontier send and its
    # compact downgrade as alternatives; its byte claim is the compact
    # figure, one of them.
    t = next(t for t in ir.registry_targets(device=CPU)
             if t.name == "bfs@gas_sharded+frontier")
    tr = ir.trace_target(t)
    labels = {a[2] for n in tr.nodes for a in n.alt}
    assert labels == {"push", "pull/frontier", "pull/downgraded"}
    totals = ir._collective_byte_totals(tr)
    assert t.exchange_bytes in totals and len(totals) == 3


# -- the CLI ------------------------------------------------------------


def _luxlint(*args):
    return subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", *args],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, LUX_PLATFORM="cpu"))


def test_cli_exchange_fixtures():
    # The registry's CLI run (rc 0, 63 results, the trace half named by
    # its targets) is tests/test_torch_exchck.py's.
    paths = [os.path.join(FIXTURES, s + ".py") for s in STEMS]
    proc = _luxlint("--exchange", "--json", *paths)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout[:proc.stdout.rindex("LUXLINT")])
    assert sorted(doc["summary"]["by_rule"]) == ["LUX404", "LUX405",
                                                 "LUX406"]
    assert doc["summary"]["files"] == 3 and not doc["errors"]
