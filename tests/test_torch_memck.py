"""The port's memory tier (``lux_tpu_torch/analysis/memck.py``):
LUX701-706 over a torch trace of each executor's step, its memcap.v1
artifact, the HBM-budgeted pool admission and the tuner's pruning it
feeds, and ``luxlint --memory``, against ``lux_tpu``'s tier.

Seeded-violation convention (tests/torch_mem_fixtures/): each
``lux7NN_*.py`` module seeds one broken contract and must make
``luxlint --memory`` exit 1 with exactly its own rule, the rule
``lux_tpu``'s fixture of the same stem (tests/mem_fixtures/) fires.
``lux_tpu``'s tier runs under JAX 0.9 with ``jax.core.ClosedJaxpr``,
``Jaxpr`` and ``Literal`` aliased to ``jax.extend.core``'s inside each
test; nothing of ``lux_tpu`` is edited. Byte counts and integers compare
exactly.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from lux_tpu_torch.analysis import memck, trace
from lux_tpu_torch.graph import generate
from lux_tpu_torch.obs import metrics
from lux_tpu_torch.ops.segment import RowTasks
from lux_tpu_torch.serve import ServeConfig, Session
from lux_tpu_torch.serve.pool import EnginePool
from lux_tpu_torch.tools import luxlint
from lux_tpu_torch.tune import space
from lux_tpu_torch.utils import tracehooks

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "torch_mem_fixtures")
JAX_FIXTURES = os.path.join(TESTS, "mem_fixtures")
STEMS = ("lux701_malformed_artifact", "lux702_unhonored_donation",
         "lux703_overcommit", "lux704_dishonest_model",
         "lux705_divergent_exchange_claim", "lux706_stale_committed")
JAX_MEMCAP = os.path.join(REPO, "lux_tpu", "analysis", "memcap.json")
CPU = torch.device("cpu")
H100_BYTES = 85_045_231_616   # torch.cuda's total_memory of an H100 80GB


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("LUX_PLATFORM", "cpu")


@pytest.fixture
def jm(monkeypatch):
    """``lux_tpu``'s memck under the installed JAX: its walk looks for
    ``jax.core.ClosedJaxpr``/``Jaxpr``/``Literal``, which JAX 0.9 keeps
    in ``jax.extend.core`` only."""
    jax = pytest.importorskip("jax")
    import jax.extend.core as jcore

    for name in ("ClosedJaxpr", "Jaxpr", "Literal"):
        monkeypatch.setattr(jax.core, name, getattr(jcore, name),
                            raising=False)
    from lux_tpu.analysis import memck as theirs

    return theirs


def _rules(report):
    return sorted({f.rule for f in report.findings})


def _expected(path):
    with open(path, encoding="utf-8") as fh:
        return sorted(set(re.findall(r"# expect: (LUX\d+)", fh.read())))


def _fmt(findings):
    return [(f.rule, f.path, f.line, f.message) for f in findings]


# -- the pure functions, against lux_tpu's ---------------------------------


@pytest.mark.parametrize("elems,nv,ne", [
    (96.0, 96, 400), (400.0, 96, 400), (800.0, 96, 400), (7.0, 96, 400),
    (392.0, 96, 400), (12.0, 12, 50), (65.0, 12, 50), (0.0, 96, 400),
    (128.0, 96, 0), (1e6, 96, 400), (48.0, 96, 400), (150.0, 96, 400)])
def test_classify_equals_lux_tpu(jm, elems, nv, ne):
    assert memck._classify(elems, nv, ne) == jm._classify(elems, nv, ne)


def test_attribute_equals_lux_tpu(jm):
    rng = np.random.default_rng(3)
    snap = [(float(b), float(e), 4) for b, e in zip(
        rng.integers(0, 5000, 40), rng.integers(0, 1000, 40))]
    snap += [(-256.0, 64.0, 4), (384.0, 96.0, 4), (1600.0, 400.0, 4)]
    for nv_p, ne_p in ((96, 400), (12, 50), (1024, 4096)):
        assert memck._attribute(snap, nv_p, ne_p) == \
            jm._attribute(snap, nv_p, ne_p)


@pytest.mark.parametrize("nv,ne,parts,k,k_probe", [
    (96, 400, 1, None, None), (96, 400, 8, None, None),
    (96, 400, 1, 4, 2), (1 << 22, 1 << 26, 4, 8, 4),
    (1 << 22, 1 << 26, 1, 1, 4), (7, 3, 16, None, None),
    (0, 0, 0, None, None)])
def test_eval_model_equals_lux_tpu(jm, nv, ne, parts, k, k_probe):
    for model in ({"per_vertex_bytes": 4.0, "per_edge_bytes": 2.0,
                   "fixed_bytes": 100},
                  {"per_vertex_bytes": 106.666667, "per_edge_bytes": 10.24,
                   "fixed_bytes": -512}):
        assert memck.eval_model(model, nv, ne, parts, k, k_probe) == \
            jm.eval_model(model, nv, ne, parts, k, k_probe)


_GOOD = {"model": {"per_vertex_bytes": 4.0, "per_edge_bytes": 0.0,
                   "fixed_bytes": 8},
         "peak_bytes": 392, "probe": {"nv": 96, "ne": 400}}


@pytest.mark.parametrize("art", [
    None, [], {"targets": []}, {"targets": {}},
    {"targets": {"a@push": 3}},
    {"targets": {"a@push": {"model": {"per_vertex_bytes": 1.0}}}},
    {"targets": {"a@push": dict(_GOOD, model={
        "per_vertex_bytes": float("nan"), "per_edge_bytes": 0.0,
        "fixed_bytes": 1})}},
    {"targets": {"a@push": dict(_GOOD, model={
        "per_vertex_bytes": -1.0, "per_edge_bytes": 0.0,
        "fixed_bytes": 1})}},
    {"targets": {"a@push": dict(_GOOD, peak_bytes=-3, probe={})}},
    {"targets": {"a@push": dict(_GOOD, peak_bytes=3.5)}},
    {"targets": {"a@push": _GOOD}},
])
def test_validate_artifact_equals_lux_tpu(jm, art):
    names = ["a@push", "b@gas"]
    assert _fmt(memck.validate_artifact(art, names, "p")) == \
        _fmt(jm.validate_artifact(art, names, "p"))
    assert _fmt(memck.validate_artifact(art)) == \
        _fmt(jm.validate_artifact(art))


def test_rule_checks_equal_lux_tpu(jm):
    entry = {"model": {"per_vertex_bytes": 4.0, "per_edge_bytes": 2.0,
                       "fixed_bytes": 64},
             "parts": 4, "k": 2, "peak_bytes": 1300,
             "probe": {"nv": 96, "ne": 400}}
    for cap, scales in ((None, [(96, 400)]), (1 << 20, [(96, 400)]),
                        (10_000, [(1 << 22, 1 << 26), (96, 400)])):
        assert _fmt(memck._check_budget("t", entry, cap, scales)) == \
            _fmt(jm._check_budget("t", entry, cap, scales))
    for peak in (0.0, 10.0, 1300.0, 5000.0, 4e6):
        for nv, ne, p, k, kp in ((96, 400, 1, None, None),
                                 (1 << 20, 1 << 24, 4, 4, 2)):
            args = ("t", entry["model"], peak, nv, ne, p, k, kp)
            assert _fmt(memck._check_model_honesty(*args)) == \
                _fmt(jm._check_model_honesty(*args))
    for committed in (None, {"targets": {}},
                      {"targets": {"t": {"model": {}}}},
                      {"targets": {"t": {"k": 2, "model": entry["model"]}}},
                      {"targets": {"t": {"k": 1, "model": {
                          "per_vertex_bytes": 0.0, "per_edge_bytes": 0.0,
                          "fixed_bytes": 1}}}}):
        got = _fmt(memck._check_drift("t", committed, entry))
        want = _fmt(jm._check_drift("t", committed, entry))
        # The regeneration hint names each package's own artifact.
        assert [g[:3] for g in got] == [w[:3] for w in want]
        assert [g[3].replace("lux_tpu_torch/", "lux_tpu/") for g in got] \
            == [w[3] for w in want]


def test_cap_id_and_tamper_check_equal_lux_tpu(jm, tmp_path):
    targets = {"x@push": dict(_GOOD)}
    probe = {"nv": 96, "ne": 400, "seed": 7}
    assert memck._cap_id(targets, probe) == jm._cap_id(targets, probe)
    art = memck.build_memcap(targets, probe)
    path = str(tmp_path / "memcap.json")
    memck.save_memcap(art, path)
    assert memck.load_memcap(path)["id"] == jm.load_memcap(path)["id"] \
        == art["id"]
    doc = json.loads(open(path).read())
    doc["targets"]["x@push"]["peak_bytes"] = 1   # a hand-shrunk footprint
    with open(path, "w") as fh:
        json.dump(doc, fh)
    for mod in (memck, jm):
        with pytest.raises(ValueError, match="content hash"):
            mod.load_memcap(path)
    doc["schema"] = "memcap.v0"
    with open(path, "w") as fh:
        json.dump(doc, fh)
    for mod in (memck, jm):
        with pytest.raises(ValueError, match="schema"):
            mod.load_memcap(path)


def test_artifacts_load_across_packages(jm):
    # The artifact carries across, as tuneconf.v1 does.
    mine = jm.load_memcap(memck.memcap_path())
    assert mine["id"] == memck.load_memcap(memck.memcap_path())["id"]
    theirs = memck.load_memcap(JAX_MEMCAP)
    assert theirs["id"] == "memcap-a0d09a618c75"
    assert set(mine["targets"]) == set(theirs["targets"])
    assert mine["probe"] == theirs["probe"]


@pytest.mark.parametrize("nv,ne,parts,k", [
    (96, 400, 1, 1), (96, 400, 8, 4), (1 << 22, 1 << 26, 4, 8),
    (1 << 22, 1 << 26, 1, 1), (1000, 3, 2, 2)])
def test_predicted_engine_bytes_equals_lux_tpu(jm, nv, ne, parts, k):
    for path in (JAX_MEMCAP, memck.memcap_path()):
        art = memck.load_memcap(path)
        for name in sorted(art["targets"]):
            app, kind = name.split("@", 1)
            kind, _, mode = kind.partition("+")
            for m in {mode, "", "full"}:
                assert memck.predicted_engine_bytes(
                    app, kind, m, nv, ne, parts, k, art=art) == \
                    jm.predicted_engine_bytes(app, kind, m, nv, ne, parts,
                                              k, art=art), (name, m)
        for app, kind in (("nope", "push"), ("nope", "gas_sharded"),
                          ("sssp", "bogus"), ("nope", "bogus")):
            for m in ("", "compact", "frontier"):
                assert memck.predicted_engine_bytes(
                    app, kind, m, nv, ne, parts, k, art=art) == \
                    jm.predicted_engine_bytes(app, kind, m, nv, ne, parts,
                                              k, art=art), (app, kind, m)
    assert memck.predicted_engine_bytes("sssp", "bogus", "", 96, 400, 1,
                                        art=art) is None


def test_budget_and_path_flags_equal_lux_tpu(jm, monkeypatch, tmp_path):
    assert memck.hbm_budget_bytes() is None is jm.hbm_budget_bytes()
    for env in ({"LUX_HBM_BUDGET_BYTES": "12345"},
                {"LUX_HBM_CAPACITY_BYTES": str(1 << 30),
                 "LUX_HBM_BUDGET_FRAC": "0.5"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert memck.hbm_budget_bytes() == jm.hbm_budget_bytes()
    assert memck.hbm_budget_bytes() == 12345
    monkeypatch.delenv("LUX_HBM_BUDGET_BYTES")
    assert memck.hbm_budget_bytes() == 1 << 29
    monkeypatch.setenv("LUX_MEMCAP_DIR", str(tmp_path))
    assert memck.memcap_path() == str(tmp_path / "memcap.json")
    assert memck._committed() is None   # no artifact: admission runs open


# -- the walk, against lux_tpu's _walk_scope --------------------------------


def _steps():
    """name -> (jax step, torch step, numpy args): each allocates the
    same buffers in both packages."""
    from jax import lax
    import jax.numpy as jnp

    x = np.arange(1024, dtype=np.float32)
    y = np.ones(1024, np.float32)
    idx = (np.arange(512) * 7 % 1024).astype(np.int32).reshape(512, 1)
    dn = lax.GatherDimensionNumbers(offset_dims=(),
                                    collapsed_slice_dims=(0,),
                                    start_index_map=(0,))

    def tcond(a, p):
        i = p.to(torch.int32)
        alt, got = tracehooks.alternatives(), {}
        for b in (0, 1):
            with alt.branch(str(b)):
                got[b] = a + 1.0 if b == 0 else a * 2.0
        return got[int(i)]

    return {
        "chain": (lambda a: ((a * 2.0) + 1.0) * 3.0,
                  lambda a: ((a * 2.0) + 1.0) * 3.0, (x,)),
        "gather": (lambda a, i: lax.gather(a, i, dn, (1,),
                                           mode="promise_in_bounds"),
                   lambda a, i: torch.index_select(a, 0, i.reshape(-1)),
                   (x, idx)),
        "reduction": (lambda a, b: (a * b).sum(),
                      lambda a, b: (a * b).sum(), (x, y)),
        "concatenate": (lambda a, b: jnp.concatenate([a + 1.0, b]),
                        lambda a, b: torch.cat([a + 1.0, b]), (x, y)),
        "cond": (lambda a, p: lax.cond(p, lambda v: v * 2.0,
                                       lambda v: v + 1.0, a),
                 tcond, (x, np.array(True))),
    }


def _jax_walk(jm, fn, args):
    import jax

    closed = jax.make_jaxpr(fn)(*args)
    return jm._walk_scope(closed.jaxpr, 1.0)


def _torch_walk(fn, args):
    tr = trace.trace_call(fn, tuple(torch.from_numpy(np.array(a))
                                    for a in args))
    return memck._walk_trace(tr, 1.0)


@pytest.mark.parametrize("name", ["chain", "gather", "reduction",
                                  "concatenate", "cond"])
def test_walk_equals_walk_scope(jm, name):
    jfn, tfn, args = _steps()[name]
    jpeak, jsnap, jin = _jax_walk(jm, jfn, args)
    tpeak, tsnap, tin = _torch_walk(tfn, args)
    assert (tpeak, tin) == (jpeak, jin)
    assert sum(e[0] for e in tsnap) == tpeak
    assert sorted(tsnap) == sorted(jsnap)


def test_view_allocates_nothing(jm):
    # A jaxpr reshape allocates its result; a torch view shares the
    # storage: the peaks differ by exactly the view's bytes.
    x = np.arange(1024, dtype=np.float32)
    jpeak, _, _ = _jax_walk(jm, lambda a: a.reshape(32, 32) + 1.0, (x,))
    tpeak, _, _ = _torch_walk(lambda a: a.reshape(32, 32) + 1.0, (x,))
    assert jpeak - tpeak == x.nbytes


def test_walk_frees_at_last_use_not_at_trace_end():
    x = np.zeros(1024, np.float32)

    def chain(a):
        for _ in range(6):
            a = a * 2.0
        return a

    peak, _, inputs = _torch_walk(chain, (x,))
    # The recorder holds all six results; the walk holds two at a time.
    assert inputs == 4096 and peak == 3 * 4096


def test_alternatives_take_the_costliest_branch():
    x = np.zeros(1024, np.float32)

    def step(a):
        alt = tracehooks.alternatives()
        with alt.branch("small"):
            small = a + 1.0
        with alt.branch("big"):
            big = torch.cat([a, a, a]) * 2.0
        return small + big[:1024]

    peak, _, _ = _torch_walk(step, (x,))
    # Entry 4096; the big branch peaks at cat + product (2 x 12288) over
    # it; small and big survive the group, then the sum.
    assert peak == 4096 + (4096 + 12288) + 2 * 12288


def test_kernel_state_is_left_out():
    # A wrapper's per-stream scratch is left out; a RowTasks schedule is
    # the engine's memory, priced and marked with the rows it covers.
    scratch = torch.zeros(100, dtype=torch.int64)

    @tracehooks.kernel("unit_scratch", extra=lambda *a, **k: [scratch])
    def kern(x, tasks):
        return x + 1.0

    tasks = RowTasks(tasks=torch.zeros(8, 2, dtype=torch.int32), n_hub=0,
                     nrows=8)
    tr = trace.trace_call(lambda x: kern(x, tasks),
                          (torch.zeros(256),))
    state = sorted(b.nbytes for b in tr.buffers.values() if b.kernel_state)
    assert state == [800]
    assert [(b.nbytes, b.rows) for b in tr.buffers.values() if b.rows] \
        == [(64, 8)]
    peak, _, inputs = memck._walk_trace(tr, 1.0)
    assert (peak, inputs) == (2112, 1088)
    assert tr.input_bytes() == 1088 + 800   # LUX103 still sees them


def test_model_prices_whole_units_and_row_schedules():
    # 392 cells lie as near 4 x 96 vertices as 400 edges: taken as the
    # 400 edges they are bounded by. Three tasks over 96 rows: priced at
    # one task a row. The peak stays exact; the constant takes the
    # difference back.
    cells = torch.zeros(392, dtype=torch.int32)
    tasks = RowTasks(tasks=torch.zeros(3, 2, dtype=torch.int32), n_hub=0,
                     nrows=96)

    @tracehooks.kernel("unit_units")
    def kern(v, c, t):
        return v + 1.0

    target = memck.ir.target_from_spec("unit@units", {
        "call": lambda v: kern(v, cells, tasks),
        "args": (torch.zeros(96),), "carry": ()})
    ev = memck.target_peak_bytes(target, {"nv": 96, "ne": 400})
    assert memck._classify(392.0, 96, 400) == "vertex"
    assert ev["peak_bytes"] == 384 + 1568 + 24 + 384
    assert ev["model"] == {"per_vertex_bytes": 16.0, "per_edge_bytes": 4.0,
                           "fixed_bytes": 2360 - 1536 - 1600}
    assert memck.eval_model(ev["model"], 96, 400, 1) == ev["peak_bytes"]
    assert memck._walk_trace(ev["trace"], 1.0)[0] == 2360


def test_donation_report_by_storage_reuse():
    def in_place(vals, deg):
        return vals.add_(deg)

    def fresh(vals, deg):
        return vals + deg

    args = (torch.zeros(64), torch.ones(64))
    for call, aliased, leak in ((in_place, 1, 0), (fresh, 0, 256)):
        target = memck.ir.target_from_spec("t", {
            "call": call, "args": args, "donate": (0,), "carry": (0,)})
        rep = memck._donation_report(target, memck.ir.trace_target(target))
        assert rep == {"declared": 1, "aliased": aliased,
                       "donated_bytes": 256, "leak_bytes": leak,
                       "checked": True}


def test_sharded_steps_price_one_part_and_their_staging():
    from lux_tpu_torch.parallel.mesh import LocalMesh

    mesh = LocalMesh(4, CPU)

    def step(vals):
        table = mesh.all_gather(vals)
        return torch.minimum(vals, table.view(4, 256).amin(dim=0))

    target = memck.ir.target_from_spec("t", {
        "call": step, "args": (torch.zeros(4, 256),),
        "exchange_mode": "full", "num_parts": 4, "sharded": True})
    tr = memck.ir.trace_target(target)
    # The args, the gathered table (a buffer of its own in the trace) and
    # the column minimum; the table is gone before the result is made.
    assert memck._walk_trace(tr, 1.0)[0] == 4096 + 4096 + 1024
    assert memck._walk_trace(tr, 0.25)[0] == (4096 + 4096 + 1024) / 4
    assert memck._staging_bytes(tr, 0.25) == 1024


# -- fixtures ----------------------------------------------------------------


@pytest.mark.parametrize("stem", STEMS)
def test_fixture_fires_exactly_its_rule(stem):
    path = os.path.join(FIXTURES, stem + ".py")
    report = memck.verify_fixture_paths([path])
    assert not report.ok
    assert _rules(report) == _expected(path) == ["LUX" + stem[3:6]]
    assert not any(r.error for r in report.results)


@pytest.mark.parametrize("stem", STEMS)
def test_fixture_matches_lux_tpu(jm, stem):
    path = os.path.join(JAX_FIXTURES, stem + ".py")
    theirs = jm.verify_fixture_paths([path])
    mine = memck.verify_fixture_paths([os.path.join(FIXTURES,
                                                    stem + ".py")])
    assert _rules(theirs) == _rules(mine) == _expected(path)
    assert len(theirs.findings) == len(mine.findings) == 1


def test_jax_fixture_is_refused_unexecuted():
    report = memck.verify_fixture_paths(
        [os.path.join(JAX_FIXTURES, "lux703_overcommit.py")])
    assert not report.findings
    assert "imports jax or lux_tpu" in report.results[0].error


def test_fixture_select_filters_rules():
    path = os.path.join(FIXTURES, "lux704_dishonest_model.py")
    assert memck.verify_fixture_paths([path], select=("LUX701",)).ok


# -- the registry ------------------------------------------------------------


@pytest.fixture(scope="module")
def registry():
    """One registry proof on the CPU, with its sweep, shared by the
    assertions (building and tracing the 59 targets is the cost)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LUX_PLATFORM", "cpu")
        return memck.prove_registry(device=CPU)


def test_registry_is_clean(registry):
    report, art = registry
    assert report.ok, report.format_human()
    assert report.schema == "luxlint-memory.v1"
    assert not any(r.error for r in report.results)
    assert len(report.results) == 59 + 13   # 13 kinds swept


def test_registry_names_equal_lux_tpu(registry):
    _, art = registry
    with open(JAX_MEMCAP) as fh:
        theirs = json.load(fh)["targets"]
    assert len(theirs) == 59
    assert set(art["targets"]) == set(theirs)
    for name, entry in art["targets"].items():
        want = theirs[name]
        for key in ("kind", "exchange_mode", "parts", "k", "value_dtype"):
            assert entry[key] == want[key], (name, key)


def test_registry_reproduces_the_committed_artifact(registry):
    _, art = registry
    committed = memck.load_memcap(memck.memcap_path())
    assert art["id"] == committed["id"]
    assert art["targets"] == committed["targets"]
    assert art["probe"] == {"nv": 96, "ne": 400, "seed": 7,
                            "sweep_factor": 2, "tol": 0.25}


def test_registry_models_bound_their_own_probe(registry):
    _, art = registry
    for name, entry in art["targets"].items():
        pred = memck.eval_model(entry["model"], entry["probe"]["nv"],
                                entry["probe"]["ne"], entry["parts"],
                                k=entry["k"], k_probe=entry["k"])
        assert pred + 1e-6 >= entry["peak_bytes"], name
        assert pred < entry["peak_bytes"] + 1, name


def test_registry_prices_staging_and_no_donation(registry):
    _, art = registry
    for name, entry in art["targets"].items():
        assert (entry["staging_bytes"] > 0) == (entry["parts"] > 1), name
        # No step of the port donates: every carry is priced twice.
        assert entry["donation"] == {"declared": 0, "aliased": 0,
                                     "donated_bytes": 0,
                                     "leak_bytes": 0}, name


def test_registry_fits_an_h100_at_the_bench_scale(registry):
    # LUX703 against the card's capacity, at LUX_BENCH_SCALE=22 and
    # LUX_BENCH_EF=16, as the card's run checks it.
    _, art = registry
    for name, entry in art["targets"].items():
        assert memck._check_budget(name, entry, H100_BYTES,
                                   memck._bench_scales()) == [], name
    assert memck._check_budget(
        "t", art["targets"]["pagerank@tiled"], 1 << 20,
        memck._bench_scales())[0].rule == "LUX703"


# -- luxlint --memory ----------------------------------------------------------


def _main(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = luxlint.main(list(argv))
    out = buf.getvalue()
    line = [ln for ln in out.splitlines() if ln.startswith("LUXLINT ")][-1]
    return rc, out, json.loads(line[8:])


def test_cli_memcap_out_reproduces_the_committed_id(tmp_path):
    out = str(tmp_path / "memcap.json")
    env = dict(os.environ, LUX_PLATFORM="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", "--memory",
         "--memcap-out", out], capture_output=True, text=True, cwd=REPO,
        env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    summary = json.loads(proc.stdout.splitlines()[-1][len("LUXLINT "):])
    assert summary["ok"] and summary["findings"] == 0
    assert summary["files"] == 72
    assert memck.load_memcap(out)["id"] == \
        memck.load_memcap(memck.memcap_path())["id"]


@pytest.mark.parametrize("stem", ["lux703_overcommit", "lux705_divergent"
                                  "_exchange_claim"])
def test_cli_fixture_exits_one_with_its_rule(stem):
    rc, out, summary = _main("--memory",
                             os.path.join(FIXTURES, stem + ".py"))
    assert rc == 1
    assert summary["by_rule"] == {"LUX" + stem[3:6]: 1}
    assert summary["schema"] == "luxlint-memory.v1"


def test_cli_select_and_baseline(tmp_path):
    fix = os.path.join(FIXTURES, "lux704_dishonest_model.py")
    rc, _, summary = _main("--memory", "--select", "LUX701", fix)
    assert rc == 0 and summary["findings"] == 0
    base = str(tmp_path / "memory.baseline.json")
    assert _main("--memory", fix, "--baseline", base)[0] == 0
    assert os.path.exists(base)
    assert _main("--memory", fix, "--baseline", base)[0] == 0
    rc, out, _ = _main("--memory", os.path.join(
        FIXTURES, "lux703_overcommit.py"), "--baseline", base)
    assert rc == 1 and "[new]" in out


def test_cli_tiers_are_exclusive_and_documented(capsys):
    with pytest.raises(SystemExit) as ei:
        luxlint.main(["--memory", "--ir"])
    assert ei.value.code == 2
    assert "separate tiers" in capsys.readouterr().err
    assert luxlint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in memck.all_memory_rules():
        assert f"{rule.id}  {rule.title}" in out


def test_rule_table_equals_lux_tpu(jm):
    assert [(r.id, r.title) for r in memck.all_memory_rules()] == \
        [(r.id, r.title) for r in jm.all_memory_rules()]
    assert (memck.MEMORY_SCHEMA, memck.CAP_SCHEMA, memck.CAP_FILENAME,
            memck.MODEL_FIELDS, memck._OVERFAT_FLOOR_BYTES) == (
        jm.MEMORY_SCHEMA, jm.CAP_SCHEMA, jm.CAP_FILENAME, jm.MODEL_FIELDS,
        jm._OVERFAT_FLOOR_BYTES)
    assert set(memck.__all__) == set(jm.__all__)


# -- the pool's admission, against lux_tpu's ----------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _pools(jm, monkeypatch, budget="1000"):
    from lux_tpu.obs import spans as jspans
    from lux_tpu.serve.pool import EnginePool as JPool
    from lux_tpu_torch.obs import spans

    monkeypatch.setenv("LUX_HBM_BUDGET_BYTES", budget)
    pools = []
    for mod, cls in ((spans, EnginePool), (jspans, JPool)):
        monkeypatch.setattr(mod, "clock", _Clock())
        pools.append(cls(scope="memck-parity"))
    return pools


def _drive(pool, steps):
    """Run ``steps`` ((key, footprint, hit-only)) and record what the
    pool shows after each."""
    out = []
    ev0 = pool.stats()["hbm_evictions"]
    for key, fp in steps:
        try:
            pool.get(key, object, footprint_bytes=fp)
            refused = None
        except Exception as e:
            refused = (type(e).__name__, e.http_status,
                       e.retry_after_s > 0)
        out.append((sorted(map(str, pool.keys())),
                    pool.hbm_resident_bytes(),
                    pool.stats()["hbm_evictions"] - ev0, refused))
    return out


def test_pools_admit_evict_and_refuse_alike(jm, monkeypatch):
    mine, theirs = _pools(jm, monkeypatch)
    steps = [(("a",), 600), (("b",), 300), (("a",), 600), (("c",), 500),
             (("d",), 2000), (("e",), None), (("b",), 300), (("f",), 700),
             (("g",), 1000), (("c",), 500)]
    got = _drive(mine, steps)
    assert got == _drive(theirs, steps)
    assert got[4][3] == ("PoolOverBudgetError", 503, True)
    assert got[3][2] == 1 and got[-1][2] >= 3
    for p in (mine, theirs):
        assert p.stats()["recompiles"] == 0
        p.close()


def test_pools_retire_and_gate_alike(jm, monkeypatch):
    mine, theirs = _pools(jm, monkeypatch)
    for pool in (mine, theirs):
        pool.get(("a", "f1"), object, footprint_bytes=400)
        pool.get(("b", "f2"), object, footprint_bytes=400)
        assert pool.hbm_resident_bytes() == 800
        assert pool.retire(lambda k: k[1] == "f1") == 1
        assert pool.hbm_resident_bytes() == 400
        assert pool.keys() == [("b", "f2")]
    monkeypatch.setenv("LUX_MEM_POOL_ADMIT", "0")
    for pool in (mine, theirs):
        pool.get(("fat",), object, footprint_bytes=5000)   # gated off
        assert len(pool) == 2
        pool.close()
    assert EnginePool().audits()["memck"]["requested"] is False


def test_pool_stats_report_the_tier(monkeypatch):
    monkeypatch.setenv("LUX_HBM_BUDGET_BYTES", "1000")
    pool = EnginePool("memck-stats")
    gauge = metrics.gauge("lux_pool_hbm_resident_bytes")
    pool.get(("a",), object, footprint_bytes=600)
    pool.get(("u",), object)
    assert gauge.value == 600.0
    st = pool.stats()
    assert st["hbm_resident_bytes"] == 600
    memck_block = st["audits"]["memck"]
    assert memck_block["budget_bytes"] == 1000
    assert memck_block["priced_builds"] == 1
    assert memck_block["resident_engines"] == 1
    pool.close()


# -- the tuner's pruning, against lux_tpu's -----------------------------------


@pytest.mark.parametrize("kind", ["push_sharded", "gas_sharded",
                                  "pull_sharded", "tiled", "gas",
                                  "gas_multi_sharded"])
def test_knob_space_prunes_as_lux_tpu(jm, monkeypatch, kind):
    from lux_tpu.tune import space as jspace

    ctx = {"program_name": "sssp" if "gas" not in kind else "bfs",
           "nv": 4096, "ne": 16384, "parts": 8}
    full = space.knob_space(kind)
    assert full == jspace.knob_space(kind)
    assert space.knob_space(kind, **ctx) == jspace.knob_space(kind, **ctx) \
        == full   # no budget on the CPU
    monkeypatch.setenv("LUX_HBM_BUDGET_BYTES", "1")
    pruned = space.knob_space(kind, **ctx)
    assert pruned == jspace.knob_space(kind, **ctx) == [full[0]]


# -- serving -------------------------------------------------------------------


def test_localmesh_session_prices_every_part_on_its_card():
    g = generate.rmat(9, 8, seed=11)
    with Session(g, ServeConfig(mesh="4"), warm=False, device="cpu") as s:
        snap = s._serving
        want = memck.predicted_engine_bytes("sssp", "push_sharded", "full",
                                            g.nv, g.ne, 4)
        assert s._footprint("push", "sssp", snap) == 4 * want
        k = s.config.max_batch
        assert s._footprint("gas_multi", "bfs", snap, k=k) == 4 * \
            memck.predicted_engine_bytes("bfs", "gas_multi_sharded", "full",
                                         g.nv, g.ne, 4, k=k)
    with Session(g, ServeConfig(), warm=False, device="cpu") as s:
        assert s._footprint("push", "sssp", s._serving) == \
            memck.predicted_engine_bytes("sssp", "push", "", g.nv, g.ne, 1)


def test_statusz_memory_block_has_lux_tpu_s_keys(jm):
    from lux_tpu.graph.graph import Graph as JGraph
    from lux_tpu.serve.session import Session as JSession

    src = np.array([0, 1, 2, 3], dtype=np.int64)
    jg = JGraph.from_edges(src, (src + 1) % 4, 4)
    g = generate.gnp(64, 256, seed=5)
    with JSession(jg, warm=False) as js, \
            Session(g, warm=False, device="cpu") as s:
        theirs, mine = js.statusz()["memory"], s.statusz()["memory"]
    assert set(mine) == set(theirs) | {"device_allocated_bytes",
                                       "device_peak_bytes"}
    assert mine["budget_bytes"] is None is theirs["budget_bytes"]
    assert mine["admission"] is True is theirs["admission"]
    assert mine["resident_bytes"] == 0 and mine["evictions"] >= 0
    assert mine["artifact_id"] == memck.load_memcap(
        memck.memcap_path())["id"]


def test_http_sheds_over_budget_builds_and_boots(monkeypatch):
    from lux_tpu_torch.serve.http import serve_in_thread

    monkeypatch.setenv("LUX_HBM_BUDGET_BYTES", "1")
    skips0 = metrics.counter("lux_pool_hbm_warm_skips_total",
                             {"engine": "sssp single"}).value
    g = generate.gnp(200, 1200, seed=301)
    s = Session(g, ServeConfig(max_batch=2, window_s=0.01), device="cpu")
    server, _ = serve_in_thread(s, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert len(s.pool) == 0
        assert metrics.counter("lux_pool_hbm_warm_skips_total",
                               {"engine": "sssp single"}).value == skips0 + 1
        # The server is up; with nothing admitted it reports itself cold.
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert ei.value.code == 503
        health = json.loads(ei.value.read())
        assert health["engines"] == 0 and health["nv"] == g.nv
        req = urllib.request.Request(
            base + "/query", json.dumps({"app": "sssp", "start": 5}).encode(),
            {"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 503
        assert float(ei.value.headers["Retry-After"]) > 0
        body = json.loads(ei.value.read())
        assert body["kind"] == "PoolOverBudgetError"
        sz = json.loads(urllib.request.urlopen(base + "/statusz",
                                               timeout=10).read())
        assert sz["memory"]["budget_bytes"] == 1
        assert sz["memory"]["resident_bytes"] == 0
    finally:
        server.shutdown()
        s.close()


@pytest.mark.parametrize("name", [
    "LUX_MEMCAP_DIR", "LUX_MEM_MODEL_TOL", "LUX_MEM_SWEEP_FACTOR",
    "LUX_MEM_POOL_ADMIT", "LUX_HBM_BUDGET_BYTES", "LUX_HBM_BUDGET_FRAC",
    "LUX_BENCH_SCALE", "LUX_BENCH_EF"])
def test_tier_flags_are_lux_tpu_s(name):
    from lux_tpu.utils import flags as jflags
    from lux_tpu_torch.utils import flags as tflags

    mine, theirs = tflags._flag(name), jflags._flag(name)
    assert (mine.default, mine.kind) == (theirs.default, theirs.kind)
    # The artifact's default path names each package's own file.
    assert mine.doc.replace("lux_tpu_torch/", "lux_tpu/") == theirs.doc
