"""Port parity: the program-contract tier (``analysis/gasck.py``), the
counterpart of tests/test_gasck.py on the port: the LUX601-606 prover,
the gascap.v1 capability artifact, the capability-derived registry and
serving surfaces, the IncrementalExecutor contract gate, the serve-pool
audit and the ``--programs`` CLI of ``python -m
lux_tpu_torch.tools.luxlint``.

Every proof is also held against ``lux_tpu``'s on the same inputs: per
registry program the ``checks``, ``derived``, ``declared`` and
``evidence`` blocks, the artifact id (each package's ``load_capmap``
accepts the other's file), each fixture's finding and the incremental
gate's verdict and message. The hooks run on the CPU here
(``device="cpu"``, ``LUX_PLATFORM=cpu`` for the CLI); the card runs are
in tests/test_torch_cuda.py and ``chip_smoke.py``.

Seeded-violation convention (tests/torch_gas_fixtures/, the twins of
tests/gas_fixtures/): each ``lux6NN_*.py`` module defines one broken
program and must make ``luxlint --programs`` exit 1 with exactly its
own rule firing.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from lux_tpu.analysis import gasck as jgasck
from lux_tpu.models.components import ConnectedComponents as JCC
from lux_tpu.models.sssp import SSSP as JSSSP
from lux_tpu_torch import models as tmodels
from lux_tpu_torch.analysis import gasck
from lux_tpu_torch.engine.gas import AdaptiveExecutor, GasProgram, as_gas
from lux_tpu_torch.engine.incremental import (IncrementalExecutor,
                                              require_incremental)
from lux_tpu_torch.engine.program import ProgramContractError
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.models.bfs import BFS
from lux_tpu_torch.models.components import ConnectedComponents
from lux_tpu_torch.models.sssp import SSSP
from lux_tpu_torch.models.sssp_delta import DeltaSSSP
from lux_tpu_torch.obs import metrics
from lux_tpu_torch.ops.segment import U32_MASK, u32_to_numpy
from lux_tpu_torch.serve.pool import GAS_AUDIT_STATUS, EnginePool
from lux_tpu_torch.utils import flags

CPU = torch.device("cpu")
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GAS_FIXTURES = os.path.join(TESTS, "torch_gas_fixtures")
JGAS_FIXTURES = os.path.join(TESTS, "gas_fixtures")
FIXTURES = [
    ("lux601_bad_identity", "LUX601"),
    ("lux602_inexact_sum", "LUX602"),
    ("lux603_push_pull_skew", "LUX603"),
    ("lux604_nonmonotone_incremental", "LUX604"),
    ("lux605_clobbering_apply", "LUX605"),
    ("lux606_overclaimed_frontier", "LUX606"),
]


def _run_cli(*argv):
    env = {**os.environ, "LUX_PLATFORM": "cpu"}
    return subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", *argv],
        capture_output=True, text=True, cwd=REPO, env=env,
    )


def _summary_line(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("LUXLINT ")]
    assert lines, stdout
    return json.loads(lines[-1][len("LUXLINT "):])


def _rules(report):
    return sorted({f.rule for f in report.findings})


def _ring(nv=12):
    src = np.arange(nv, dtype=np.int64)
    return Graph.from_edges(src, (src + 1) % nv, nv)


@pytest.fixture(scope="module")
def registry():
    """One registry prove of each package shared by the matrix
    assertions."""
    return gasck.prove_registry(device=CPU), jgasck.prove_registry()


# -- probe-grid + scalar-proof units --------------------------------------


def test_probe_grid_extremes_and_hygiene():
    grid = gasck._probe_grid(
        np.array([3.0, -0.0, np.nan], dtype=np.float32),
        np.float32(0.0), np.dtype(np.float32), seed=7)
    assert np.inf in grid and -np.inf in grid
    assert np.finfo(np.float32).max in grid
    assert not np.isnan(grid).any()          # NaN has its own policy probe
    assert not ((grid == 0) & np.signbit(grid)).any()   # no -0.0
    want = jgasck._probe_grid(
        np.array([3.0, -0.0, np.nan], dtype=np.float32),
        np.float32(0.0), np.dtype(np.float32), seed=7)
    assert grid.tobytes() == want.tobytes()


def test_identity_check_rejects_zero_for_min():
    probes = gasck._probe_grid(np.array([], dtype=np.uint32),
                               np.uint32(0), np.dtype(np.uint32), seed=7)
    ok, msg, _ = gasck._check_identity(
        np.minimum, np.uint32(0), probes, np.dtype(np.uint32))
    assert not ok and "p=" in msg


def test_identity_check_accepts_engine_identities():
    for combiner, dtype in (("min", np.uint32), ("sum", np.float32),
                            ("max", np.uint32), ("min", np.float32)):
        ident = gasck._identity_np(combiner, np.dtype(dtype))
        assert ident == jgasck._identity_np(combiner, np.dtype(dtype))
        probes = gasck._probe_grid(np.array([], dtype=dtype), ident,
                                   np.dtype(dtype), seed=7)
        ok, msg, _ = gasck._check_identity(
            gasck._np_op(combiner), ident, probes, np.dtype(dtype))
        assert ok, (combiner, dtype, msg)


def test_identity_check_flags_asymmetric_nan_policy():
    def lopsided(a, b):
        # NaN is absorbed only from the right operand: push and pull
        # would disagree as soon as edge order differs.
        return np.where(np.isnan(np.asarray(b)), a, np.minimum(a, b))
    probes = np.array([0.0, 1.0], dtype=np.float32)
    ok, msg, _ = gasck._check_identity(
        lopsided, np.float32(np.inf), probes, np.dtype(np.float32))
    assert not ok and "NaN" in msg


def test_algebra_float_sum_is_inexact():
    probes = gasck._probe_grid(np.array([], dtype=np.float32),
                               np.float32(0), np.dtype(np.float32), seed=7)
    ok, msg = gasck._check_algebra(np.add, probes, seed=7, triples=16)
    assert not ok and "associative" in msg


def test_algebra_uint_sum_and_minmax_are_exact():
    for op, dtype in ((np.add, np.uint32), (np.minimum, np.uint32),
                      (np.maximum, np.uint32), (np.minimum, np.float32)):
        ident = np.array(0, dtype=dtype)[()]
        probes = gasck._probe_grid(np.array([], dtype=dtype), ident,
                                   np.dtype(dtype), seed=7)
        ok, msg = gasck._check_algebra(op, probes, seed=7, triples=32)
        assert ok, (op.__name__, dtype, msg)


def test_derive_rooted_from_init_hooks():
    g = gasck._seed_graphs(16, 7)["plain"]
    assert gasck._derive_rooted(BFS(), g)
    assert not gasck._derive_rooted(ConnectedComponents(), g)


def test_seed_graphs_equal_lux_tpu():
    for nv in (12, 24):
        mine, theirs = gasck._seed_graphs(nv, 7), jgasck._seed_graphs(nv, 7)
        for key in ("plain", "weighted"):
            a, b = mine[key], theirs[key]
            np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
            np.testing.assert_array_equal(a.col_src, b.col_src)
            np.testing.assert_array_equal(a.col_dst, b.col_dst)
            if key == "weighted":
                np.testing.assert_array_equal(a.weights, b.weights)


def test_call_hook_narrows_u32_and_keeps_float_bits():
    """The hooks see widened uint32 values and their results wrap mod
    2**32, as numpy's (and lux_tpu's jnp) uint32 arithmetic does; f32
    -0.0 and NaN payloads and bools pass bit for bit."""
    top = np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)
    with gasck.hooks_on(CPU):
        seen = gasck._call_hook(lambda v: torch.tensor(v.dtype == torch.int64),
                                top)
        assert bool(seen)
        got = gasck._call_hook(lambda v: v + 1, top)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, top + np.uint32(1))
        got = gasck._call_hook(lambda v: v - 1, top)
        np.testing.assert_array_equal(got, top - np.uint32(1))
        # k-core's wrapping sum of decrements
        acc = np.array([1, 2, 3, 4], dtype=np.uint32)
        got = gasck._call_hook(lambda o, a: (o - a) & U32_MASK, top, acc)
        np.testing.assert_array_equal(got, top - acc)
        f = np.array([-0.0, 0.0, np.inf], dtype=np.float32)
        nan = np.array([0x7FC00001, 0xFFC12345], dtype=np.uint32) \
            .view(np.float32)
        f = np.concatenate([f, nan])
        got = gasck._call_hook(lambda v: v.clone(), f)
        assert got.dtype == np.float32 and got.tobytes() == f.tobytes()
        got = gasck._call_hook(lambda a, b: a != b, top, top[::-1].copy())
        assert got.dtype == bool and got.tolist() == [True] * 4


def test_hooks_need_a_device_or_a_card(monkeypatch):
    """Without a card the hooks run only where the caller names a
    device; a structural refusal needs none, and a proof that could not
    run is not cached as a verdict."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(gasck, "_INCR_CACHE", {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gasck._call_hook(lambda v: v, np.zeros(2, dtype=np.uint32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gasck.prove_registry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gasck.verify_fixture_paths([GAS_FIXTURES])
    with pytest.raises(ProgramContractError, match="relax"):
        gasck.require_incremental(BFS())

    class Fresh(SSSP):
        pass

    with pytest.raises(RuntimeError, match="no CUDA device"):
        gasck.require_incremental(Fresh())
    gasck.require_incremental(Fresh(), CPU)
    with gasck.hooks_on(CPU):
        gasck.require_incremental(ConnectedComponents())


# -- registry proof + derived matrix --------------------------------------


def test_registry_proves_clean(registry):
    (report, _), _ = registry
    assert report.ok
    assert report.schema == "luxlint-programs.v1"
    assert len(report.results) == 8
    assert not any(r.error for r in report.results)


def test_registry_derived_matrix(registry):
    (_, art), _ = registry
    derived = {n: c["derived"] for n, c in art["programs"].items()}
    assert derived["sssp"] == {"rooted": True, "frontier_ok": True,
                               "incremental_ok": True}
    assert derived["components"]["incremental_ok"]
    assert derived["bfs"]["rooted"] and derived["bfs"]["frontier_ok"]
    assert derived["sssp_delta"] == {"rooted": True, "frontier_ok": True,
                                     "incremental_ok": False}
    # Dense pull programs earn no frontier license.
    assert not derived["pagerank"]["frontier_ok"]
    assert not derived["colfilter"]["frontier_ok"]
    assert {n for n, d in derived.items() if d["frontier_ok"]} == {
        "bfs", "components", "kcore", "labelprop", "sssp", "sssp_delta"}


@pytest.mark.parametrize("name", sorted(tmodels.PROGRAMS))
def test_registry_entry_equals_lux_tpu(registry, name):
    (_, art), (_, jart) = registry
    mine, theirs = art["programs"][name], jart["programs"][name]
    for block in ("checks", "derived", "declared", "evidence"):
        assert mine[block] == theirs[block], (name, block)
    assert mine == theirs


def test_registry_matches_committed_artifact(registry):
    """The LUX606 offline ratchet: a capability-changing edit must
    regenerate lux_tpu_torch/analysis/gascap.json or verify fails."""
    (_, art), (_, jart) = registry
    committed = gasck.load_capmap(gasck.capmap_path())
    assert committed["id"] == art["id"] == jart["id"]


def test_artifacts_cross_load():
    """Each package's load_capmap accepts the other's committed file,
    and both hash to one id."""
    mine = gasck.capmap_path()
    theirs = jgasck.capmap_path()
    assert mine != theirs
    a, b = jgasck.load_capmap(mine), gasck.load_capmap(theirs)
    assert a["id"] == b["id"] == gasck.load_capmap(mine)["id"] \
        == jgasck.load_capmap(theirs)["id"] == "gascap-c1c4127df4de"
    assert a["programs"] == b["programs"] and a["probe"] == b["probe"]


# -- seeded fixtures: each fails with exactly its rule --------------------


@pytest.mark.parametrize("stem,rule", FIXTURES)
def test_fixture_fails_with_exactly_its_rule(stem, rule):
    path = os.path.join(GAS_FIXTURES, stem + ".py")
    report = gasck.verify_fixture_paths([path], device=CPU)
    assert not report.ok
    assert _rules(report) == [rule]
    assert not any(r.error for r in report.results)
    want = jgasck.verify_fixture_paths([os.path.join(JGAS_FIXTURES,
                                                     stem + ".py")])
    assert [(f.rule, f.message) for f in report.findings] == [
        (f.rule, f.message) for f in want.findings]


def test_fixture_select_filters_rules():
    path = os.path.join(GAS_FIXTURES, "lux602_inexact_sum.py")
    report = gasck.verify_fixture_paths([path], select=("LUX601",),
                                        device=CPU)
    assert report.ok    # the LUX602 finding is filtered out


def test_unloadable_and_empty_fixtures_are_errors(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("raise ImportError('nope')\n")
    empty = tmp_path / "empty.py"
    empty.write_text("X = 1\n")
    report = gasck.verify_fixture_paths([str(tmp_path)], device=CPU)
    assert not report.ok and len(report.errors) == 2
    assert any("unloadable fixture" in e for e in report.errors)
    assert any("defines no GAS/push/pull programs" in e
               for e in report.errors)


# -- the gather_push seam the prover licenses -----------------------------


def test_engine_push_path_consumes_gather_push():
    """LUX603 exists because the engines really do run gather_push on
    the push branch (on the CPU; the card refuses a program with one):
    a skewed override makes pinned-push diverge from pinned-pull, and an
    equal override keeps them bitwise identical."""
    class Skewed(GasProgram):
        name = "skewed"
        servable = False
        frontier_ok = False

        def init_values(self, graph, **kw):
            v = np.full(graph.nv, graph.nv, dtype=np.uint32)
            v[0] = 0
            return v

        def init_frontier(self, graph, **kw):
            f = np.zeros(graph.nv, dtype=bool)
            f[0] = True
            return f

        def gather(self, src_vals, weights):
            return (src_vals + 1) & U32_MASK

        def gather_push(self, src_vals, weights):
            return (src_vals + 2) & U32_MASK

    class Aligned(Skewed):
        name = "aligned"

        def gather_push(self, src_vals, weights):
            return (src_vals + 1) & U32_MASK

    g = _ring(8)

    def run(prog, mode):
        st, _ = AdaptiveExecutor(g, prog, mode=mode, device=CPU).run(
            max_iters=2)
        return u32_to_numpy(st.values)

    assert not np.array_equal(run(Skewed(), "pull"), run(Skewed(), "push"))
    np.testing.assert_array_equal(run(Aligned(), "pull"),
                                  run(Aligned(), "push"))


# -- gascap.v1 artifact ----------------------------------------------------


def test_capmap_round_trip(tmp_path):
    art = gasck.build_capmap({"x": {"derived": {"rooted": True}}},
                             {"seed": 7})
    path = str(tmp_path / "gascap.json")
    gasck.save_capmap(art, path)
    loaded = gasck.load_capmap(path)
    assert loaded["id"] == art["id"]
    assert loaded["programs"] == art["programs"]
    assert jgasck.load_capmap(path)["id"] == art["id"]


def test_capmap_id_is_content_addressed_not_timestamped():
    a = gasck.build_capmap({"x": {"d": 1}}, {"seed": 7})
    b = gasck.build_capmap({"x": {"d": 1}}, {"seed": 7})
    c = gasck.build_capmap({"x": {"d": 2}}, {"seed": 7})
    assert a["id"] == b["id"]       # created_at excluded from the id
    assert a["id"] != c["id"]
    assert a["id"] == jgasck.build_capmap({"x": {"d": 1}}, {"seed": 7})["id"]


def test_capmap_tamper_rejected(tmp_path):
    art = gasck.build_capmap(
        {"sssp": {"derived": {"incremental_ok": False}}}, {"seed": 7})
    path = str(tmp_path / "gascap.json")
    gasck.save_capmap(art, path)
    doc = json.loads(open(path).read())
    doc["programs"]["sssp"]["derived"]["incremental_ok"] = True
    with open(path, "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(ValueError, match="content hash"):
        gasck.load_capmap(path)
    doc["schema"] = "gascap.v0"
    with open(path, "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(ValueError, match="schema"):
        gasck.load_capmap(path)


def test_capmap_path_honors_flag(tmp_path):
    with flags.overrides({"LUX_GASCAP_DIR": str(tmp_path)}):
        assert gasck.capmap_path() == str(tmp_path / "gascap.json")
    assert gasck.capmap_path() == os.path.join(
        REPO, "lux_tpu_torch", "analysis", "gascap.json")


# -- capability-derived registry surfaces ---------------------------------


def test_models_capabilities_come_from_artifact():
    from lux_tpu import models as jmodels

    rep = tmodels.capability_report(refresh=True)
    assert rep["source"] == "artifact"
    assert rep["error"] is None
    assert rep["artifact_id"].startswith("gascap-")
    assert rep == jmodels.capability_report(refresh=True)
    assert tmodels.rooted_apps() == frozenset({"bfs", "sssp", "sssp_delta"})
    assert tmodels.incremental_ok("sssp")
    assert tmodels.incremental_ok("components")
    assert not tmodels.incremental_ok("bfs")
    assert tmodels.frontier_ok("labelprop")
    assert not tmodels.frontier_ok("pagerank")


def test_models_fall_back_to_declared_when_artifact_missing(tmp_path):
    from lux_tpu import models as jmodels

    try:
        with flags.overrides({"LUX_GASCAP_DIR": str(tmp_path)}):
            rep = tmodels.capability_report(refresh=True)
            assert rep["source"] == "declared"
            assert "artifact missing" in rep["error"]
            # Declarations carry the same bits, so routing still works.
            assert tmodels.rooted_apps() == frozenset(
                {"bfs", "sssp", "sssp_delta"})
        with jflags_overrides({"LUX_GASCAP_DIR": str(tmp_path)}):
            assert rep == jmodels.capability_report(refresh=True)
    finally:
        assert tmodels.capability_report(refresh=True)["source"] == \
            "artifact"
        jmodels.capability_report(refresh=True)


def test_models_reject_tampered_artifact(tmp_path):
    from lux_tpu import models as jmodels

    art = json.loads(open(gasck.capmap_path()).read())
    art["programs"]["sssp"]["derived"]["rooted"] = False
    with open(tmp_path / "gascap.json", "w") as fh:
        json.dump(art, fh)
    try:
        with flags.overrides({"LUX_GASCAP_DIR": str(tmp_path)}):
            rep = tmodels.capability_report(refresh=True)
            assert rep["source"] == "declared"
            assert "artifact rejected" in rep["error"]
        with jflags_overrides({"LUX_GASCAP_DIR": str(tmp_path)}):
            jrep = jmodels.capability_report(refresh=True)
        assert jrep["source"] == "declared"
        assert jrep["programs"] == rep["programs"]
    finally:
        tmodels.capability_report(refresh=True)
        jmodels.capability_report(refresh=True)


def test_models_read_lux_tpu_artifact_under_the_flag(tmp_path):
    """LUX_GASCAP_DIR pointing at a copy of lux_tpu's committed artifact
    is accepted as the port's own."""
    shutil.copy(jgasck.capmap_path(), tmp_path / "gascap.json")
    try:
        with flags.overrides({"LUX_GASCAP_DIR": str(tmp_path)}):
            rep = tmodels.capability_report(refresh=True)
        assert rep["source"] == "artifact" and rep["error"] is None
        assert rep["artifact_id"] == jgasck.load_capmap(
            jgasck.capmap_path())["id"]
    finally:
        tmodels.capability_report(refresh=True)


def jflags_overrides(mapping):
    from lux_tpu.utils import flags as jflags

    return jflags.overrides(mapping)


# -- the IncrementalExecutor contract gate --------------------------------


class Quiet(SSSP):
    """A proven program that does not declare incremental_ok."""
    incremental_ok = False


class JQuiet(JSSSP):
    incremental_ok = False


class Claimant(ConnectedComponents):
    name = "claimant"

    def relax(self, src_vals, weights):
        return (src_vals + 1) & U32_MASK


class JClaimant(JCC):
    name = "claimant"

    def relax(self, src_vals, weights):
        return src_vals + np.uint32(1)


def _fixture_program(root, stem, cls):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_t_{root.split(os.sep)[-1]}_{stem}",
        os.path.join(root, stem + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, cls)


def _gate_cases():
    from lux_tpu import models as jmodels

    cases = [(n, lambda n=n: tmodels.PROGRAMS[n](),
              lambda n=n: jmodels.PROGRAMS[n]())
             for n in sorted(tmodels.PROGRAMS)]
    cases += [
        ("quiet", Quiet, JQuiet),
        ("claimant", Claimant, JClaimant),
        ("lux604_fixture",
         lambda: _fixture_program(GAS_FIXTURES,
                                  "lux604_nonmonotone_incremental",
                                  "DriftingMin")(),
         lambda: _fixture_program(JGAS_FIXTURES,
                                  "lux604_nonmonotone_incremental",
                                  "DriftingMin")()),
    ]
    return cases


def _verdict(fn, prog):
    try:
        fn(prog)
    except TypeError as e:   # both packages' ProgramContractError
        return str(e)
    return None


@pytest.mark.parametrize("name,mine,theirs", _gate_cases(),
                         ids=[c[0] for c in _gate_cases()])
def test_require_incremental_verdict_equals_lux_tpu(name, mine, theirs):
    got = _verdict(lambda p: require_incremental(p, CPU), mine())
    want = _verdict(jgasck.require_incremental, theirs())
    assert got == want
    if got is not None:
        assert "LUX604" in got
        with pytest.raises(ProgramContractError):
            require_incremental(mine(), CPU)


def test_require_incremental_accepts_proven_programs():
    gasck.require_incremental(SSSP(), CPU)
    gasck.require_incremental(ConnectedComponents(), CPU)
    gasck.require_incremental(Quiet(), CPU)


def test_incremental_gate_rejects_programs_without_relax():
    with pytest.raises(ProgramContractError, match="LUX604") as ei:
        IncrementalExecutor(_ring(), BFS(), device=CPU)
    assert "relax" in str(ei.value)
    with pytest.raises(ProgramContractError, match="LUX604"):
        gasck.require_incremental(DeltaSSSP(), CPU)


def test_incremental_gate_names_failed_subcheck():
    # relax moves against the max order (messages exceed their source,
    # so a stale warm start can't be re-reached) -> the gate quotes the
    # inflationarity sub-check, not a generic refusal.
    with pytest.raises(ProgramContractError, match="inflationary"):
        gasck.require_incremental(Claimant(), CPU)
    drifting = _fixture_program(GAS_FIXTURES,
                                "lux604_nonmonotone_incremental",
                                "DriftingMin")
    with pytest.raises(ProgramContractError,
                       match="gather is not inflationary"):
        IncrementalExecutor(_ring(), drifting(), device=CPU)


def test_incremental_proof_runs_once_per_program(monkeypatch):
    calls = []
    real = gasck._incremental_error

    def counted(program):
        calls.append(type(program).__name__)
        return real(program)

    monkeypatch.setattr(gasck, "_incremental_error", counted)
    monkeypatch.setattr(gasck, "_INCR_CACHE", {})

    class Once(SSSP):
        pass

    for _ in range(3):
        IncrementalExecutor(_ring(), Once(), device=CPU)
    assert calls == ["Once"]
    assert gasck.incremental_proofs() == 1


def test_incremental_executor_still_accepts_proven_programs():
    g = _ring(16)
    ref, _ = AdaptiveExecutor(g, as_gas(ConnectedComponents()),
                              device=CPU).run()
    inc = IncrementalExecutor(g, ConnectedComponents(), device=CPU)
    # No-edit refresh from the converged labels: the gate admits the
    # proven program and the warm start reproduces the fixpoint bitwise.
    old = u32_to_numpy(ref.values)
    state, iters, info = inc.run(old)
    np.testing.assert_array_equal(u32_to_numpy(state.values), old)


# -- serve-pool audit + session surfaces ----------------------------------


class BrokenApply(GasProgram):
    name = "pool_broken_apply"
    servable = False
    frontier_ok = False

    def init_values(self, graph, **kw):
        return np.zeros(graph.nv, dtype=np.uint32)

    def init_frontier(self, graph, **kw):
        return np.ones(graph.nv, dtype=bool)

    def gather(self, src_vals, weights):
        return src_vals

    def apply(self, old, acc):
        return acc


def test_pool_audit_is_advisory_and_counted():
    pool = EnginePool(scope="test-gasck")
    try:
        before = pool.stats()["gas_findings"]
        ex = pool.get(("k1",), lambda: types.SimpleNamespace(
            program=BrokenApply(), device=CPU))
        assert ex is not None            # advisory: the build survives
        after = pool.stats()["gas_findings"]
        assert after >= before + 1
        # Cache hit on a second engine for the same program identity.
        pool.get(("k2",), lambda: types.SimpleNamespace(
            program=BrokenApply(), device=CPU))
        assert pool.stats()["gas_findings"] >= after + 1
        audits = pool.audits()["gasck"]
        assert audits["status"] == GAS_AUDIT_STATUS
        assert audits["audited_builds"] == 2
        assert metrics.counter("lux_gas_findings_total").value \
            == pool.stats()["gas_findings"]
    finally:
        pool.close()


def test_pool_audit_findings_equal_lux_tpu():
    from lux_tpu.engine.gas import GasProgram as JGasProgram
    from lux_tpu import models as jmodels

    class JBrokenApply(JGasProgram):
        name = "pool_broken_apply"
        servable = False
        frontier_ok = False

        def init_values(self, graph, **kw):
            return np.zeros(graph.nv, dtype=np.uint32)

        def init_frontier(self, graph, **kw):
            return np.ones(graph.nv, dtype=bool)

        def gather(self, src_vals, weights):
            return src_vals

        def apply(self, old, acc):
            return acc

    def fmt(findings):
        return [(f.rule, f.path, f.message) for f in findings]

    got = gasck.audit_program(BrokenApply(), "pool@x", CPU)
    assert [f.rule for f in got] == ["LUX605"]
    assert fmt(got) == fmt(jgasck.audit_program(JBrokenApply(), "pool@x"))
    for name in sorted(tmodels.PROGRAMS):
        assert gasck.audit_program(tmodels.get_program(name), "p", CPU) \
            == [] == jgasck.audit_program(jmodels.get_program(name), "p")


def test_pool_audit_clean_program_and_flag_gate():
    pool = EnginePool(scope="test-gasck-clean")
    try:
        before = pool.stats()["gas_findings"]
        pool.get(("k",), lambda: types.SimpleNamespace(program=SSSP(),
                                                       device=CPU))
        assert pool.stats()["gas_findings"] == before
        with flags.overrides({"LUX_GAS_POOL_AUDIT": "0"}):
            pool.get(("k3",), lambda: types.SimpleNamespace(
                program=types.SimpleNamespace(combiner="bogus")))
            assert not pool.audits()["gasck"]["requested"]
        assert pool.stats()["gas_findings"] == before   # gated off
        assert pool.audits()["gasck"]["audited_builds"] == 1
    finally:
        pool.close()


def test_session_statusz_programs_block():
    from lux_tpu_torch.serve.session import Session

    # The findings counter is process-global by design (dashboards sum
    # one series); assert the session adds nothing, not absolute zero.
    before = int(metrics.counter("lux_gas_findings_total").value)
    src = np.array([0, 1, 2, 3], dtype=np.int64)
    g = Graph.from_edges(src, (src + 1) % 4, 4)
    with Session(g, warm=False, device="cpu") as s:
        blk = s.statusz()["programs"]
        assert blk["source"] == "artifact"
        assert blk["artifact_id"].startswith("gascap-")
        assert "error" not in blk
        assert blk["capabilities"]["sssp"]["incremental_ok"]
        assert blk["gas_findings"] == before
        assert s.statusz()["counters"]["gas_findings"] == before
        assert s.stats()["programs"]["source"] == "artifact"


# -- the --programs CLI ----------------------------------------------------


def test_cli_registry_clean():
    r = _run_cli("--programs")
    assert r.returncode == 0, r.stdout + r.stderr
    s = _summary_line(r.stdout)
    assert s["schema"] == "luxlint-programs.v1"
    assert s["ok"] and s["findings"] == 0 and s["files"] == 8


def test_cli_fixture_exits_one_with_its_rule():
    r = _run_cli("--programs",
                 os.path.join(GAS_FIXTURES, "lux603_push_pull_skew.py"))
    assert r.returncode == 1
    s = _summary_line(r.stdout)
    assert s["by_rule"] == {"LUX603": 1}
    assert "direction-adaptive execution" in r.stdout


def test_cli_select_subsets_rules():
    r = _run_cli("--programs", "--select", "LUX601",
                 os.path.join(GAS_FIXTURES, "lux602_inexact_sum.py"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert _summary_line(r.stdout)["findings"] == 0


def test_cli_gascap_out_writes_artifact(tmp_path):
    out = str(tmp_path / "gascap.json")
    r = _run_cli("--programs", "--gascap-out", out)
    assert r.returncode == 0, r.stdout + r.stderr
    art = gasck.load_capmap(out)
    assert art["id"] == gasck.load_capmap(gasck.capmap_path())["id"]
    assert jgasck.load_capmap(out)["id"] == art["id"]


def test_cli_baseline_ratchet(tmp_path):
    base = str(tmp_path / "programs.baseline.json")
    fix = os.path.join(GAS_FIXTURES, "lux601_bad_identity.py")
    first = _run_cli("--programs", fix, "--baseline", base)
    assert first.returncode == 0          # snapshot written, run passes
    assert os.path.exists(base)
    second = _run_cli("--programs", fix, "--baseline", base)
    assert second.returncode == 0         # known finding: ratcheted
    third = _run_cli("--programs",
                     os.path.join(GAS_FIXTURES,
                                  "lux605_clobbering_apply.py"),
                     "--baseline", base)
    assert third.returncode == 1          # new finding escapes the ratchet
    assert "[new]" in third.stdout


def test_cli_tiers_are_mutually_exclusive():
    r = _run_cli("--programs", "--ir")
    assert r.returncode == 2
    assert "separate tiers" in r.stderr


def test_cli_list_rules_documents_the_tier():
    r = _run_cli("--list-rules")
    assert r.returncode == 0
    for rule in ("LUX601", "LUX602", "LUX603", "LUX604", "LUX605",
                 "LUX606"):
        assert rule in r.stdout


def test_cli_without_a_card_exits_with_a_message():
    env = {k: v for k, v in os.environ.items() if k != "LUX_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", "--programs"],
        capture_output=True, text=True, cwd=REPO, env=env)
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr and "LUX_PLATFORM=cpu" in r.stderr
