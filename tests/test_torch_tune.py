"""Port parity: the profile-guided auto-tuner (``lux_tpu_torch/tune``),
its artifact checker (``analysis/tuneck.py``, ``tools/luxlint.py``) and
serving under tuned configs.

The counterparts of tests/test_tune.py on the port (the scoped flag
overlay, the knob space, the successive-halving search under a seeded
synthetic cost model, ``tuneconf.v1`` persistence, the TuneCache,
LUX501-504 on seeded corruptions, probe scoring, a tuned session and
its swap), and the port held against ``lux_tpu``: equal candidate lists
for every engine kind, equal scores on equal summaries, identical
artifacts under one injected ``measure``, artifacts loading across the
packages, equal checker findings and luxlint lines, real probes on the
CPU whose executors carry the candidate's knobs, and tuned BFS answers
bitwise equal to the default config's and to ``lux_tpu``'s.
"""

import copy
import json
import math
import os
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

from lux_tpu.analysis import tuneck as jtuneck
from lux_tpu.tune import artifact as jartifact
from lux_tpu.tune import probe as jprobe
from lux_tpu.tune import space as jspace
from lux_tpu.tune.search import tune as jtune
from lux_tpu_torch.analysis import tuneck
from lux_tpu_torch.graph import generate
from lux_tpu_torch.models import ENGINE_KINDS
from lux_tpu_torch.obs import ledger, metrics
from lux_tpu_torch.tune import artifact, probe, space
from lux_tpu_torch.tune.cache import TuneCache, tune_cache
from lux_tpu_torch.tune.search import tune
from lux_tpu_torch.utils import flags

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
LUXLINT = [sys.executable, "-m", "lux_tpu_torch.tools.luxlint"]
JLUXLINT = [sys.executable, os.path.join(REPO, "tools", "luxlint.py")]

FP = "ab12" * 10   # a plausible checkpoint fingerprint
# One creation time for the artifacts both packages must mint alike: a
# minute ago, inside LUX_TUNE_MAX_AGE_S.
CREATED = float(int(time.time()) - 60)
KINDS = sorted({k for kinds in ENGINE_KINDS.values() for k in kinds})

# Deterministic synthetic cost model for the search's injectable
# measure seam: compact exchange is known-better, full (the default)
# is worst, frontier sits between; tiny knob terms totally order the
# table so argmin is unique.
_BASE_COST = {"full": 4.0, "compact": 1.0, "frontier": 2.0}


def _measure(cand, iters, rung):
    c = _BASE_COST[cand.get("LUX_EXCHANGE", "full")]
    c += 0.01 * float(cand.get("LUX_GAS_DENSITY_HI", "0.0625"))
    c += 0.001 * float(cand.get("LUX_GAS_DENSITY_LO", "0.005"))
    c += 0.0001 * float(cand.get("LUX_EXCHANGE_FRONTIER_FRAC", "0.25"))
    c += 0.5 * float(cand.get("LUX_GROUPED_TAIL", "0") == "1")
    return c


def _graph_stub(nv=100, ne=800):
    # tune() with an injected measure only reads graph.nv/graph.ne.
    return types.SimpleNamespace(nv=nv, ne=ne)


def _synthetic_tune(engine_kind="gas_sharded", measure=_measure,
                    tune_fn=tune, **kw):
    kw.setdefault("program_name", "bfs")
    kw.setdefault("graph_fingerprint", FP)
    kw.setdefault("mesh_shape", "2")
    kw.setdefault("device_kind", "cpu")
    return tune_fn(_graph_stub(), object(), engine_kind,
                   measure=measure, **kw)


@pytest.fixture
def tune_dir(tmp_path, monkeypatch):
    """Arm LUX_TUNE_DIR at a fresh store; reset the singleton cache."""
    root = str(tmp_path / "tune")
    monkeypatch.setenv("LUX_TUNE_DIR", root)
    tune_cache().clear()
    yield root
    tune_cache().clear()


# -- flags.overrides ------------------------------------------------------


def test_overrides_scoped_and_nested():
    assert flags.get("LUX_EXCHANGE") == "full"
    with flags.overrides({"LUX_EXCHANGE": "compact"}):
        assert flags.get("LUX_EXCHANGE") == "compact"
        with flags.overrides({"LUX_EXCHANGE": "frontier"}):
            assert flags.get("LUX_EXCHANGE") == "frontier"
        assert flags.get("LUX_EXCHANGE") == "compact"
    assert flags.get("LUX_EXCHANGE") == "full"


def test_overrides_values_stringified_and_typed_accessors():
    with flags.overrides({"LUX_GAS_DENSITY_HI": 0.25,
                          "LUX_TUNE_PROBE_ITERS": 3}):
        assert flags.get("LUX_GAS_DENSITY_HI") == "0.25"
        assert flags.get_float("LUX_GAS_DENSITY_HI") == 0.25
        assert flags.get_int("LUX_TUNE_PROBE_ITERS") == 3


def test_overrides_none_masks_env(monkeypatch):
    monkeypatch.setenv("LUX_EXCHANGE", "compact")
    assert flags.get("LUX_EXCHANGE") == "compact"
    with flags.overrides({"LUX_EXCHANGE": None}):
        assert flags.get("LUX_EXCHANGE") == "full"
    assert flags.get("LUX_EXCHANGE") == "compact"


def test_overrides_undeclared_raises_before_applying():
    with pytest.raises(KeyError, match="undeclared"):
        with flags.overrides({"LUX_EXCHANGE": "compact",
                              "LUX_NO_SUCH_KNOB": "1"}):
            pytest.fail("overlay with a typo'd knob must not enter")
    assert flags.get("LUX_EXCHANGE") == "full"


def test_overrides_thread_isolation():
    """The overlay is context-local: a candidate config being probed in
    one thread must never leak into another (concurrent serving)."""
    seen = {}

    def worker():
        seen["worker"] = flags.get("LUX_EXCHANGE")

    with flags.overrides({"LUX_EXCHANGE": "compact"}):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert flags.get("LUX_EXCHANGE") == "compact"
    assert seen["worker"] == "full"


def test_snapshot_and_config_hash_resolve_through_overlay():
    base_hash = flags.config_hash()
    with flags.overrides({"LUX_EXCHANGE": "compact"}):
        assert flags.snapshot()["LUX_EXCHANGE"] == "compact"
        assert flags.config_hash() != base_hash
    assert flags.config_hash() == base_hash


@pytest.mark.parametrize("name", [
    "LUX_TUNE_DIR", "LUX_TUNE_PROBE_ITERS", "LUX_TUNE_RUNGS",
    "LUX_TUNE_ETA", "LUX_TUNE_SEED", "LUX_TUNE_MAX_CANDIDATES",
    "LUX_TUNE_MAX_AGE_S", "LUX_TUNE_PENALTY", "LUX_TUNE_CACHE",
    "LUX_NATIVE_CACHE"])
def test_tuner_flags_are_lux_tpu_s(name):
    from lux_tpu.utils import flags as jflags

    mine, theirs = flags._flag(name), jflags._flag(name)
    assert (mine.default, mine.kind) == (theirs.default, theirs.kind)


# -- knob space -----------------------------------------------------------


def test_knob_space_default_first_and_deterministic():
    cands = space.knob_space("gas_sharded")
    assert cands[0] == space.default_candidate("gas_sharded")
    assert cands[0]["LUX_EXCHANGE"] == "full"
    assert cands == space.knob_space("gas_sharded")
    modes = {c["LUX_EXCHANGE"] for c in cands}
    assert modes == {"full", "compact", "frontier"}


def test_knob_space_constraint_pruning():
    frac_default = str(flags.default("LUX_EXCHANGE_FRONTIER_FRAC"))
    for cand in space.knob_space("gas_sharded"):
        if cand["LUX_EXCHANGE"] != "frontier":
            assert cand["LUX_EXCHANGE_FRONTIER_FRAC"] == frac_default
        assert float(cand["LUX_GAS_DENSITY_LO"]) \
            < float(cand["LUX_GAS_DENSITY_HI"])


def test_knob_space_kinds():
    assert space.knob_space("pull") == [{}]
    assert space.knob_space("push") == [{}]
    assert len(space.knob_space("tiled")) == 2
    gas = space.knob_space("gas")
    assert all(set(c) == {"LUX_GAS_DENSITY_HI", "LUX_GAS_DENSITY_LO"}
               for c in gas)
    assert len(gas) < len(space.knob_space("gas_sharded"))


def test_knob_space_only_tuner_managed():
    for kind in KINDS:
        for cand in space.knob_space(kind):
            assert set(cand) <= space.TUNER_MANAGED, (kind, cand)


@pytest.mark.parametrize("kind", KINDS)
def test_knob_space_equals_lux_tpu_s(kind):
    """Equal candidate lists, in order, for every engine kind — with and
    without the probe context (the port prunes nothing without a
    budget, as ``lux_tpu`` prunes nothing without one)."""
    assert space.TUNER_MANAGED == jspace.TUNER_MANAGED
    assert space.knob_space(kind) == jspace.knob_space(kind)
    assert space.default_candidate(kind) == jspace.default_candidate(kind)
    ctx = dict(program_name="bfs", nv=1024, ne=16384, parts=4)
    assert space.knob_space(kind, **ctx) == jspace.knob_space(kind, **ctx)


# -- search ---------------------------------------------------------------


def test_tune_same_seed_identical_winner_and_score_table():
    a = _synthetic_tune()
    b = _synthetic_tune()
    assert a["id"] == b["id"]
    assert a["config"] == b["config"]
    assert a["score_table"] == b["score_table"]


def test_tune_finds_known_better_exchange():
    art = _synthetic_tune()
    assert art["config"]["LUX_EXCHANGE"] == "compact", art["config"]
    defaults = [r for r in art["score_table"] if r["candidate_index"] == 0]
    assert defaults, "the all-defaults candidate must always be probed"
    assert defaults[-1]["score"] > art["score"]
    last = max(r["rung"] for r in art["score_table"])
    final = [r for r in art["score_table"] if r["rung"] == last]
    best = min(final, key=lambda r: (r["score"], r["candidate_index"]))
    assert best["config"] == art["config"]


def test_tune_successive_halving_shape():
    art = _synthetic_tune()
    by_rung = {}
    for row in art["score_table"]:
        by_rung.setdefault(row["rung"], []).append(row)
    cap = flags.get_int("LUX_TUNE_MAX_CANDIDATES")
    eta = flags.get_int("LUX_TUNE_ETA")
    iters0 = flags.get_int("LUX_TUNE_PROBE_ITERS")
    assert len(by_rung[0]) == min(cap, len(space.knob_space("gas_sharded")))
    assert len(by_rung[1]) == math.ceil(len(by_rung[0]) / eta)
    assert all(r["iters"] == iters0 for r in by_rung[0])
    assert all(r["iters"] == 2 * iters0 for r in by_rung[1])


def test_tune_subsample_keeps_default_candidate():
    with flags.overrides({"LUX_TUNE_MAX_CANDIDATES": "4"}):
        art = _synthetic_tune()
    assert art["tuner"]["candidates"] == 4
    assert any(r["candidate_index"] == 0 for r in art["score_table"])
    with flags.overrides({"LUX_TUNE_MAX_CANDIDATES": "4"}):
        assert _synthetic_tune()["id"] == art["id"]


def test_tune_lone_candidate_stops_early():
    art = _synthetic_tune("pull", measure=lambda c, i, r: 1.0)
    assert art["config"] == {}
    assert [r["rung"] for r in art["score_table"]] == [0]


def test_tune_select_lands_in_ledger(tmp_path, monkeypatch):
    monkeypatch.setenv("LUX_LEDGER_DIR", str(tmp_path / "ledger"))
    ledger.reset()
    try:
        art = _synthetic_tune()
        recs = ledger.read_all(strict=True)
        selects = [r for r in recs if r["kind"] == "tune_select"]
        assert len(selects) == 1
        assert selects[0]["tune"]["winner"] == art["config"]
        assert art["select_record_id"] == selects[0]["id"]
        assert art["probe_ledger_ids"] == []
    finally:
        ledger.reset()


@pytest.mark.parametrize("kind,cap,rungs", [
    ("gas_sharded", "16", "2"), ("gas_sharded", "5", "3"),
    ("gas", "16", "2"), ("tiled_sharded", "16", "2"), ("pull", "16", "2"),
    ("push_multi_sharded", "16", "1")])
def test_tune_equals_lux_tpu_s(kind, cap, rungs):
    """One injected ``measure``, seed and ``created_at``: the same
    artifact (id, config, score, score table, tuner block) in both
    packages."""
    over = {"LUX_TUNE_MAX_CANDIDATES": cap, "LUX_TUNE_RUNGS": rungs}
    from lux_tpu.utils import flags as jflags

    with flags.overrides(over), jflags.overrides(over):
        mine = _synthetic_tune(kind, created_at=CREATED)
        theirs = _synthetic_tune(kind, created_at=CREATED, tune_fn=jtune)
    for field in ("id", "key", "key_string", "config", "score",
                  "score_table", "graph_meta", "probe_ledger_ids",
                  "created_at", "schema"):
        assert mine[field] == theirs[field], field
    drop = lambda t: {k: v for k, v in t.items() if k != "search_s"}
    assert drop(mine["tuner"]) == drop(theirs["tuner"])


@pytest.mark.parametrize("args", [
    (3, 0, 0, 0.05), (4, 2, 2, 0.5), (2, 0, 0, 0.0), (5, 0, 0, 0.0),
    (6, 1, 0, 0.05)])
def test_score_summary_equals_lux_tpu_s(args):
    rng = np.random.default_rng(args[0])
    summaries = [
        {"iterations": [{"exchange_s": float(a), "compute_s": float(b)}
                        for a, b in rng.random((args[0], 2))]},
        {"iterations": [{"t_iter_s": float(a)} for a in rng.random(args[0])]},
        {"iterations": [], "num_iters": args[0], "execute_s": 3.5},
        {"iterations": [{"compute_s": float(a)} for a in rng.random(3)]
         + [{"t_iter_s": 1.0}]},
    ]
    for summary in summaries:
        assert probe.score_summary(summary, *args) \
            == jprobe.score_summary(summary, *args)


# -- artifact persistence -------------------------------------------------


def test_artifact_roundtrip(tune_dir):
    art = _synthetic_tune()
    path = artifact.save(tune_dir, art)
    assert os.path.basename(path).startswith("tuneconf-")
    assert artifact.load(tune_dir, art["key"]) == art
    other = artifact.make_key("cd34" * 10, "bfs", "gas_sharded", "2", "cpu")
    assert artifact.load(tune_dir, other) is None
    assert artifact.list_artifacts(tune_dir) == [path]


def test_artifact_key_mismatch_raises(tune_dir):
    art = _synthetic_tune()
    path = artifact.save(tune_dir, art)
    edited = dict(art, key_string="tampered")
    with open(path, "w") as f:
        json.dump(edited, f)
    with pytest.raises(ValueError, match="key_string"):
        artifact.load(tune_dir, art["key"])


def test_artifact_bad_schema_raises(tune_dir):
    art = dict(_synthetic_tune(), schema="tuneconf.v0")
    path = os.path.join(tune_dir, "tuneconf-000000000000.json")
    os.makedirs(tune_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(art, f)
    with pytest.raises(ValueError, match="schema"):
        artifact.load_path(path)


@pytest.mark.parametrize("writer", ["port", "lux_tpu"])
def test_artifact_loads_across_packages(tmp_path, writer):
    """The same key string, file name and bytes: an artifact saved by
    either package loads in the other."""
    mine = _synthetic_tune(created_at=CREATED)
    theirs = _synthetic_tune(created_at=CREATED, tune_fn=jtune)
    theirs["tuner"]["search_s"] = mine["tuner"]["search_s"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    if writer == "port":
        path = artifact.save(a, mine)
        assert jartifact.load(a, mine["key"]) == mine
    else:
        path = jartifact.save(a, theirs)
        assert artifact.load(a, theirs["key"]) == theirs
    assert artifact.artifact_path(a, mine["key"]) == path
    other = (jartifact if writer == "port" else artifact).save(
        b, mine if writer == "port" else theirs)
    assert open(path, "rb").read() == open(other, "rb").read()


# -- TuneCache ------------------------------------------------------------


def _art_for(fp, program="bfs"):
    return _synthetic_tune(graph_fingerprint=fp, program_name=program)


def test_cache_disarmed_is_inert(monkeypatch):
    monkeypatch.delenv("LUX_TUNE_DIR", raising=False)
    tc = TuneCache()
    assert not tc.enabled()
    assert tc.get(artifact.make_key(FP, "bfs", "gas_sharded", "2",
                                    "cpu")) is None
    with pytest.raises(RuntimeError, match="LUX_TUNE_DIR"):
        tc.put(_synthetic_tune())


def test_cache_hit_miss_and_disk_reload(tune_dir):
    tc = TuneCache(root=tune_dir)
    art = _art_for(FP)
    tc.put(art)
    assert tc.get(art["key"]) == art
    tc.clear()
    assert len(tc) == 0
    assert tc.get(art["key"])["id"] == art["id"]
    stats = tc.stats()
    assert stats["armed"] and stats["entries"] == 1


def test_cache_lru_eviction(tune_dir):
    tc = TuneCache(root=tune_dir)
    arts = [_art_for(f"{i:02x}" * 20) for i in range(3)]
    with flags.overrides({"LUX_TUNE_CACHE": "2"}):
        for a in arts:
            tc.put(a)
        assert len(tc) == 2
        assert tc.get(arts[0]["key"])["id"] == arts[0]["id"]
        assert os.path.exists(artifact.artifact_path(tune_dir,
                                                     arts[1]["key"]))


def test_cache_evict_fingerprint_keeps_disk(tune_dir):
    tc = TuneCache(root=tune_dir)
    keep_fp = "cd34" * 10
    for program in ("bfs", "labelprop"):
        tc.put(_art_for(FP, program))
    tc.put(_art_for(keep_fp))
    assert tc.evict_fingerprint(FP) == 2
    assert len(tc) == 1
    reloaded = tc.get(_art_for(FP)["key"])
    assert reloaded is not None
    assert reloaded["key"]["graph_fingerprint"] == FP


def test_cache_counters():
    metrics.reset()
    tc = TuneCache(root=None)
    assert {m["name"] for m in metrics.snapshot()} >= {
        "lux_tune_hits_total", "lux_tune_misses_total",
        "lux_tune_evicted_total"}
    assert tc.stats()["hits"] == 0


# -- tuneck (LUX501-504) --------------------------------------------------


def _rule_ids(art):
    res = tuneck.verify_artifact(art)
    assert res.error is None, res.error
    return sorted({f.rule for f in res.findings})


def test_tuneck_clean_artifact():
    assert _rule_ids(_synthetic_tune()) == []


def test_tuneck_lux501_structure():
    art = copy.deepcopy(_synthetic_tune())
    art["schema"] = "tuneconf.v0"
    art["id"] = "not-an-id"
    del art["key"]["device_kind"]
    assert "LUX501" in _rule_ids(art)
    art2 = copy.deepcopy(_synthetic_tune())
    del art2["score_table"][0]["iters"]
    assert "LUX501" in _rule_ids(art2)


def test_tuneck_lux502_knob_domains():
    art = copy.deepcopy(_synthetic_tune())
    art["config"]["LUX_NO_SUCH_KNOB"] = "1"
    art["config"]["LUX_ENGOBS"] = "1"
    assert "LUX502" in _rule_ids(art)
    art2 = copy.deepcopy(_synthetic_tune())
    art2["score_table"][0]["config"] = {"LUX_EXCHANGE": "bogus"}
    assert "LUX502" in _rule_ids(art2)
    art3 = copy.deepcopy(_synthetic_tune())
    art3["config"]["LUX_GAS_DENSITY_HI"] = "0.05"
    art3["config"]["LUX_GAS_DENSITY_LO"] = "0.5"
    findings = tuneck.verify_artifact(art3).findings
    assert any(f.rule == "LUX502" and "hysteresis" in f.message
               for f in findings)


def test_tuneck_lux503_selection():
    art = copy.deepcopy(_synthetic_tune())
    default_row = next(r for r in art["score_table"]
                       if r["candidate_index"] == 0)
    art["config"] = dict(default_row["config"])
    art["score"] = default_row["score"]
    assert "LUX503" in _rule_ids(art)

    art2 = copy.deepcopy(_synthetic_tune())
    art2["probe_ledger_ids"] = ["run-deadbeef"]
    assert _rule_ids(art2) == ["LUX503"]

    art3 = copy.deepcopy(_synthetic_tune())
    for row in art3["score_table"]:
        if row["candidate_index"] == 0:
            row["candidate_index"] = 99
    findings = tuneck.verify_artifact(art3).findings
    assert any(f.rule == "LUX503" and "default candidate" in f.message
               for f in findings)

    art4 = copy.deepcopy(_synthetic_tune())
    art4["score_table"][0]["score"] = float("nan")
    assert "LUX503" in _rule_ids(art4)


def test_tuneck_lux504_staleness():
    old = _synthetic_tune(created_at=1.0)
    assert _rule_ids(old) == ["LUX504"]
    with flags.overrides({"LUX_TUNE_MAX_AGE_S": "0"}):
        assert _rule_ids(old) == []

    art = copy.deepcopy(_synthetic_tune())
    art["created_at"] = art["created_at"] + 86400.0
    assert _rule_ids(art) == ["LUX504"]

    art2 = copy.deepcopy(_synthetic_tune())
    art2["key"]["graph_fingerprint"] = "?"
    art2["key_string"] = artifact.key_string(art2["key"])
    art2["graph_meta"] = {"nv": 0, "ne": -1}
    assert "LUX504" in _rule_ids(art2)


def _corruptions():
    """(name, artifact) fixtures: one clean, the rest each corrupted the
    way the rule tests above corrupt them."""
    base = _synthetic_tune(created_at=CREATED)
    out = [("clean", base)]

    def edit(name, fn):
        a = copy.deepcopy(base)
        fn(a)
        out.append((name, a))

    edit("schema", lambda a: a.update(schema="tuneconf.v0", id="x"))
    edit("key", lambda a: a["key"].pop("device_kind"))
    edit("row", lambda a: a["score_table"][0].pop("iters"))
    edit("knobs", lambda a: a["config"].update(LUX_ENGOBS="1",
                                               LUX_NO_SUCH_KNOB="1"))
    edit("domain", lambda a: a["score_table"][1].update(
        config={"LUX_EXCHANGE": "bogus", "LUX_GAS_DENSITY_HI": "2"}))
    edit("hysteresis", lambda a: a["config"].update(
        LUX_GAS_DENSITY_HI="0.05", LUX_GAS_DENSITY_LO="0.5"))
    edit("ids", lambda a: a.update(probe_ledger_ids=["run-deadbeef"]))
    edit("nan", lambda a: a["score_table"][2].update(score=float("nan")))
    edit("meta", lambda a: a.update(graph_meta={"nv": 0, "ne": -1}))
    edit("future", lambda a: a.update(created_at=4.0e9))
    edit("fingerprint", lambda a: a["key"].update(graph_fingerprint="?",
                                                  mesh_shape="2x"))
    return out


@pytest.mark.parametrize("case", [c[0] for c in _corruptions()])
def test_tuneck_findings_equal_lux_tpu_s(case):
    """The same rule ids, rows and messages from both checkers."""
    art = dict(_corruptions())[case]
    mine = tuneck.verify_artifact(copy.deepcopy(art), "a.json")
    theirs = jtuneck.verify_artifact(copy.deepcopy(art), "a.json")
    assert [f.as_dict() for f in mine.findings] \
        == [f.as_dict() for f in theirs.findings]
    assert mine.error == theirs.error
    assert (case == "clean") == (not mine.findings)


def _luxlint(cmd, *args):
    # No age bound: an age in seconds would differ between two runs.
    env = dict(os.environ, LUX_TUNE_MAX_AGE_S="0")
    return subprocess.run(cmd + list(args), capture_output=True, text=True,
                          cwd=REPO, env=env)


def _lines(proc):
    """stdout without the timings (the summary's elapsed_s)."""
    out = []
    for line in proc.stdout.splitlines():
        if line.startswith("LUXLINT "):
            s = json.loads(line[len("LUXLINT "):])
            s.pop("elapsed_s")
            out.append(s)
        elif not line.startswith("luxlint: "):
            out.append(line)
    return out


def test_luxlint_tune_cli(tune_dir):
    clean = _synthetic_tune()
    artifact.save(tune_dir, clean)
    proc = _luxlint(LUXLINT, "--tune", tune_dir)
    assert proc.returncode == 0, proc.stdout[-500:] + proc.stderr[-500:]
    assert '"findings": 0' in proc.stdout
    corrupt = copy.deepcopy(clean)
    corrupt["key"]["program"] = "labelprop"
    corrupt["key_string"] = artifact.key_string(corrupt["key"])
    corrupt["config"]["LUX_ENGOBS"] = "1"
    artifact.save(tune_dir, corrupt)
    proc = _luxlint(LUXLINT, "--tune", tune_dir)
    assert proc.returncode == 1, proc.stdout[-500:]
    assert "LUX502" in proc.stdout
    # No path: the LUX_TUNE_DIR store.
    assert _luxlint(LUXLINT, "--tune").returncode == 1


def test_luxlint_tune_output_equals_tools_luxlint(tmp_path):
    root = str(tmp_path / "store")
    for name, art in _corruptions():
        if name in ("clean", "knobs", "ids", "meta", "nan"):
            art = copy.deepcopy(art)
            art["key"]["program"] = name
            art["key_string"] = artifact.key_string(art["key"])
            artifact.save(root, art)
    with open(os.path.join(root, "tuneconf-broken.json"), "w") as f:
        f.write("{not json")
    for args in (("--tune", root), ("--tune", "--json", root),
                 ("--tune", "--select", "LUX502", root),
                 ("--tune", str(tmp_path / "empty"))):
        mine, theirs = _luxlint(LUXLINT, *args), _luxlint(JLUXLINT, *args)
        assert mine.returncode == theirs.returncode == 1, args
        if "--json" in args:
            a, b = (json.loads(p.stdout[:p.stdout.rindex("LUXLINT")])
                    for p in (mine, theirs))
            a["summary"].pop("elapsed_s")
            b["summary"].pop("elapsed_s")
            assert a == b
        else:
            assert _lines(mine) == _lines(theirs), args


def test_luxlint_refuses_unported_tiers(monkeypatch):
    # No tier is refused any more: the AST, --threads, --plans,
    # --exchange, --ir and --memory tiers run (--ir and --memory over a
    # torch fixture: its rule fires, rc 1, not the usage error).
    monkeypatch.setenv("LUX_PLATFORM", "cpu")
    fixture = os.path.join(REPO, "tests", "torch_ir_fixtures",
                           "lux104_donation.py")
    proc = _luxlint(LUXLINT, "--ir", fixture)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "LUX104" in proc.stdout
    fixture = os.path.join(REPO, "tests", "torch_mem_fixtures",
                           "lux703_overcommit.py")
    proc = _luxlint(LUXLINT, "--memory", fixture)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert '"by_rule": {"LUX703": 1}' in proc.stdout
    assert "not ported" not in proc.stdout + proc.stderr
    for args in ((), ("--threads",), ("lux_tpu_torch",)):
        proc = _luxlint(LUXLINT, *args)
        assert proc.returncode == 0, (args, proc.stdout + proc.stderr)
    assert _luxlint(LUXLINT, "--plans").returncode == 2   # needs a dir
    both = _luxlint(LUXLINT, "--programs", "--tune")
    assert both.returncode == 2 and "separate tiers" in both.stderr
    listed = _luxlint(LUXLINT, "--list-rules")
    assert listed.returncode == 0
    assert [ln.split()[0] for ln in listed.stdout.splitlines()
            if ln.startswith("LUX")] == (
        [f"LUX{i:03d}" for i in range(1, 11)]
        + [f"LUX{i}" for i in range(201, 206)]
        + [f"LUX{i}" for i in range(301, 306)]
        + ["LUX401", "LUX402", "LUX403", "LUX407"]
        + [f"LUX{i}" for i in range(501, 505)]
        + [f"LUX{i}" for i in range(601, 607)]
        + [f"LUX{i}" for i in range(701, 707)]
        + [f"LUX{i}" for i in range(101, 106)]
        + ["LUX404", "LUX405", "LUX406"])
    assert "not ported" not in listed.stdout


# -- probe scoring --------------------------------------------------------


def test_score_summary_phase_medians_drop_first_record():
    summary = {"iterations": [
        {"exchange_s": 10.0, "compute_s": 10.0},
        {"exchange_s": 1.0, "compute_s": 2.0},
        {"exchange_s": 1.0, "compute_s": 2.0},
    ]}
    score, detail = probe.score_summary(summary, 3, 0, 0, 0.05)
    assert score == pytest.approx(3.0)
    assert detail["exchange_s_med"] == pytest.approx(1.0)
    assert detail["compute_s_med"] == pytest.approx(2.0)


def test_score_summary_instability_penalty():
    summary = {"iterations": [{"exchange_s": 1.0, "compute_s": 1.0},
                              {"exchange_s": 1.0, "compute_s": 1.0}]}
    calm, _ = probe.score_summary(summary, 4, 0, 0, 0.5)
    flappy, detail = probe.score_summary(summary, 4, 2, 2, 0.5)
    assert flappy == pytest.approx(calm * 1.5)
    assert detail["direction_switches"] == 2


def test_score_summary_fallbacks():
    wall = {"iterations": [{"t_iter_s": 2.0}, {"t_iter_s": 4.0}]}
    score, detail = probe.score_summary(wall, 2, 0, 0, 0.0)
    assert score == pytest.approx(3.0)
    assert detail["exchange_s_med"] == 0.0
    totals = {"iterations": [], "num_iters": 5, "execute_s": 10.0}
    score2, _ = probe.score_summary(totals, 5, 0, 0, 0.0)
    assert score2 == pytest.approx(2.0)


# -- real probes on the CPU -----------------------------------------------


def _built(monkeypatch):
    """Capture every executor the probes build."""
    from lux_tpu_torch.analysis import ir

    seen = []
    real = ir.build_executor

    def spy(*a, **kw):
        ex = real(*a, **kw)
        seen.append(ex)
        return ex

    monkeypatch.setattr(ir, "build_executor", spy)
    return seen


@pytest.mark.parametrize("kind,cand", [
    ("gas", {"LUX_GAS_DENSITY_HI": "0.9", "LUX_GAS_DENSITY_LO": "0.05"}),
    ("gas_sharded", {"LUX_EXCHANGE": "compact",
                     "LUX_EXCHANGE_FRONTIER_FRAC": "0.25",
                     "LUX_GAS_DENSITY_HI": "0.25",
                     "LUX_GAS_DENSITY_LO": "0.05"}),
    ("gas_sharded", {"LUX_EXCHANGE": "frontier",
                     "LUX_EXCHANGE_FRONTIER_FRAC": "0.5",
                     "LUX_GAS_DENSITY_HI": "0.0625",
                     "LUX_GAS_DENSITY_LO": "0.005"}),
    ("gas_multi", {"LUX_GAS_DENSITY_HI": "0.25",
                   "LUX_GAS_DENSITY_LO": "0.05"}),
    ("tiled", {"LUX_GROUPED_TAIL": "1"}),
])
def test_run_probe_on_the_cpu_carries_the_candidate(monkeypatch, tmp_path,
                                                    kind, cand):
    """A real probe: the executor is built under the candidate's overlay
    (its thresholds, exchange mode or tail plan are the candidate's), it
    runs phase-fenced, the score is finite and a tune_probe record lands
    in the ledger with the candidate."""
    from lux_tpu_torch.models import BFS, PageRank

    monkeypatch.setenv("LUX_LEDGER_DIR", str(tmp_path / "ledger"))
    ledger.reset()
    seen = _built(monkeypatch)
    if kind == "tiled":
        g, program, init_kw = generate.rmat(10, 8, seed=5), PageRank(), {}
        build_kw = {"device": "cpu"}
    else:
        g = generate.small_world(1024, k=4, p_rewire=0.05, seed=5)
        program, init_kw = BFS(), {"start": 0}
        build_kw = ({"device": "cpu", "num_parts": 4}
                    if kind.endswith("sharded") else {"device": "cpu"})
    try:
        res = probe.run_probe(g, program, kind, cand, 4, init_kw=init_kw,
                              program_name=program.name,
                              graph_fingerprint=FP, rung=1,
                              build_kw=build_kw)
        recs = [r for r in ledger.read_all(strict=True)
                if r["kind"] == "tune_probe"]
    finally:
        ledger.reset()
    (ex,) = seen
    if kind in ("gas", "gas_sharded"):
        assert ex.hi_count == max(1, math.ceil(
            float(cand["LUX_GAS_DENSITY_HI"]) * g.nv))
        assert ex.lo_count == max(0, math.ceil(
            float(cand["LUX_GAS_DENSITY_LO"]) * g.nv))
    if "LUX_EXCHANGE" in cand:
        assert ex.exchange_mode == cand["LUX_EXCHANGE"]
    if kind == "tiled":
        assert ex.gtail is not None
    assert math.isfinite(res.score) and res.score > 0
    assert res.candidate == cand and 1 <= res.iters <= 4
    assert res.detail["build_s"] > 0 and res.detail["run_s"] > 0
    assert res.detail["t_iter_s_med"] > 0
    # The sharded executors run phase-fenced under LUX_ENGOBS=1.
    assert (res.detail["compute_s_med"] > 0) == kind.endswith("sharded")
    assert len(recs) == 1 and recs[0]["id"] == res.record_id
    assert recs[0]["tune"] == {"candidate": cand, "rung": 1}
    assert recs[0]["config"]["LUX_ENGOBS"] in ("1", "True", True)


def test_tune_with_real_probes_on_the_cpu(monkeypatch):
    """tune() over real probes: candidate 0 is the defaults, the winner
    is the argmin of the last rung, the artifact checks clean; which
    candidate wins is not asserted (scores are timings)."""
    from lux_tpu_torch.models import BFS

    g = generate.small_world(512, k=4, p_rewire=0.05, seed=9)
    with flags.overrides({"LUX_TUNE_PROBE_ITERS": "2"}):
        art = tune(g, BFS(), "gas", program_name="bfs",
                   graph_fingerprint=FP, init_kw={"start": 0},
                   build_kw={"device": "cpu"})
    assert art["score_table"][0]["config"] == space.default_candidate("gas")
    assert art["key"]["device_kind"] == "cpu"
    assert tuneck.verify_artifact(art).findings == []
    assert jtuneck.verify_artifact(art).findings == []
    rows = art["score_table"]
    assert {r["rung"] for r in rows} == {0, 1}
    assert all("build_s" in r["detail"] for r in rows)


# -- serving integration --------------------------------------------------


def _session_artifact(g, fp, app="bfs", kind="gas", mesh="1",
                      measure=None):
    """A tuneconf.v1 for ``app`` tuned to a distinctly non-default
    density hysteresis (and, sharded, the compact exchange)."""
    from lux_tpu_torch.obs import report

    def default_measure(cand, iters, rung):
        return (2.0 - float(cand.get("LUX_GAS_DENSITY_HI", "0"))
                - float(cand.get("LUX_GAS_DENSITY_LO", "0"))
                + (cand.get("LUX_EXCHANGE") != "compact"))

    art = tune(g, object(), kind, program_name=app,
               graph_fingerprint=fp, mesh_shape=mesh,
               device_kind=report.device_profile()["device_kind"],
               measure=measure or default_measure)
    assert art["config"]["LUX_GAS_DENSITY_HI"] == "0.9"
    assert art["config"]["LUX_GAS_DENSITY_LO"] == "0.05"
    return art


def _fallbacks():
    return {m["labels"]["app"]: m["value"] for m in metrics.snapshot()
            if m["name"] == "lux_tune_fallback_total"}


def _cfg(**kw):
    from lux_tpu_torch.serve import ServeConfig

    kw.setdefault("max_batch", 4)
    kw.setdefault("window_s", 0.01)
    kw.setdefault("pagerank_iters", 4)
    return ServeConfig(**kw)


def test_session_warmup_applies_tuned_config(tune_dir, monkeypatch):
    from lux_tpu_torch.models.bfs import reference_bfs
    from lux_tpu_torch.serve import Session
    from lux_tpu_torch.serve.http import serve_in_thread
    from lux_tpu_torch.utils.checkpoint import fingerprint_hex

    metrics.reset()
    g = generate.gnp(300, 2000, seed=181)
    art = _session_artifact(g, fingerprint_hex(g))
    tune_cache().put(art)
    with Session(g, _cfg(), device="cpu") as s:
        prov = s.tuned_for("bfs")
        assert prov == {"id": art["id"], "score": art["score"]}
        engine = s._gas_single("bfs")
        assert engine.hi_count == math.ceil(0.9 * g.nv)
        assert engine.lo_count == math.ceil(0.05 * g.nv)
        multi = s._gas_multi("bfs")
        assert multi is s._gas_multi("bfs")
        tb = s.statusz()["tune"]
        assert tb["armed"]
        assert tb["artifacts"]["bfs"]["id"] == art["id"]
        assert tb["artifacts"]["bfs"]["config"] == art["config"]
        assert tb["artifacts"]["bfs"]["probes"] == len(art["score_table"])
        assert "bfs" not in tb["fallbacks"]
        assert "pagerank" in tb["fallbacks"]
        counted = _fallbacks()
        assert set(counted) == set(tb["fallbacks"]) == set(s.APPS) - {"bfs"}
        assert sum(counted.values()) == len(tb["fallbacks"])
        assert s.tuned_for("pagerank") is None
        out = s.query("bfs", start=3, timeout=60)
        depth, _parent = reference_bfs(g, 3)
        np.testing.assert_array_equal(out["values"], depth)
        misses = s.pool.stats()["misses"]
        server, _ = serve_in_thread(s, port=0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            for app, tuned in (("bfs", art["id"]), ("sssp", None)):
                req = urllib.request.Request(
                    base + "/query",
                    json.dumps({"app": app, "start": 3,
                                "digest": True}).encode(),
                    {"Content-Type": "application/json"})
                resp = urllib.request.urlopen(req, timeout=60)
                assert resp.headers.get("X-Lux-Tuned") == tuned
            sz = json.loads(urllib.request.urlopen(
                base + "/statusz", timeout=10).read())
            assert sz["tune"]["artifacts"]["bfs"]["id"] == art["id"]
        finally:
            server.shutdown()
        assert s.pool.stats()["misses"] == misses   # no build after warmup


def test_tuned_bfs_bitwise_default_and_lux_tpu(tune_dir, monkeypatch):
    """Tuned and default sessions give bitwise BFS answers (depths and
    parents, single-lane and batched), and so does ``lux_tpu``'s session
    under the same artifact, which the port wrote."""
    from lux_tpu.graph import generate as jgen
    from lux_tpu.serve import ServeConfig as JServeConfig
    from lux_tpu.serve import Session as JSession
    from lux_tpu.tune import tune_cache as jtune_cache
    from lux_tpu_torch.serve import Session
    from lux_tpu_torch.utils.checkpoint import fingerprint_hex

    g = generate.gnp(300, 2000, seed=183)
    art = _session_artifact(g, fingerprint_hex(g))
    tune_cache().put(art)
    jtune_cache().clear()
    roots = (0, 3, 77, 150)

    def answers(sess):
        futs = [sess.submit("bfs", start=r) for r in roots]
        return [(np.asarray(f.result(60)["values"]),
                 np.asarray(f.result(60)["parent"])) for f in futs] + [
            (np.asarray(sess.query("bfs", start=5, timeout=60)["values"]),
             np.asarray(sess.query("bfs", start=5, timeout=60)["parent"]))]

    try:
        with Session(g, _cfg(), device="cpu") as s:
            assert s.tuned_for("bfs")["id"] == art["id"]
            tuned = answers(s)
        with JSession(jgen.gnp(300, 2000, seed=183),
                      JServeConfig(max_batch=4, window_s=0.01,
                                   pagerank_iters=4)) as js:
            assert js.tuned_for("bfs")["id"] == art["id"]
            theirs = answers(js)
        monkeypatch.delenv("LUX_TUNE_DIR")
        tune_cache().clear()
        with Session(g, _cfg(), device="cpu") as s:
            assert s.tuned_for("bfs") is None
            assert s.statusz()["tune"]["armed"] is False
            default = answers(s)
    finally:
        jtune_cache().clear()
    for a, b, c in zip(tuned, default, theirs):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def test_session_swap_evicts_tuned_config(tune_dir):
    from lux_tpu_torch.graph import EdgeEdits
    from lux_tpu_torch.obs import report
    from lux_tpu_torch.serve import Session
    from lux_tpu_torch.utils.checkpoint import fingerprint_hex

    metrics.reset()
    g = generate.gnp(300, 2000, seed=182)
    old_fp = fingerprint_hex(g)
    tune_cache().put(_session_artifact(g, old_fp))
    with Session(g, _cfg(), device="cpu") as s:
        assert s.tuned_for("bfs") is not None
        before = _fallbacks().get("bfs", 0)
        out = s.apply_edits(EdgeEdits.from_lists(insert=[(0, g.nv - 1),
                                                         (1, g.nv - 2)]))
        assert s.fingerprint != old_fp
        assert out["tunes_evicted"] >= 2   # the cache entry and the app's
        assert s.tuned_for("bfs") is None
        tb = s.statusz()["tune"]
        assert "bfs" in tb["fallbacks"]
        assert tb["artifacts"] == {}
        assert _fallbacks()["bfs"] == before + 1   # the new version's
        key = artifact.make_key(old_fp, "bfs", "gas", "1",
                                report.device_profile()["device_kind"])
        assert os.path.exists(artifact.artifact_path(tune_dir, key))


def test_sharded_session_builds_under_the_tuned_exchange(tune_dir):
    """Over a 2-part serving mesh the tuned BFS engines are built with
    the artifact's exchange mode and thresholds, the pool key carries
    the mode, and the answers equal a single-part default session's."""
    from lux_tpu_torch.serve import Session
    from lux_tpu_torch.utils.checkpoint import fingerprint_hex

    g = generate.small_world(1024, k=4, p_rewire=0.05, seed=11)
    with flags.overrides({"LUX_TUNE_MAX_CANDIDATES": "64"}):
        art = _session_artifact(g, fingerprint_hex(g), kind="gas_sharded",
                                mesh="2")
    assert art["config"]["LUX_EXCHANGE"] == "compact"
    tune_cache().put(art)
    with Session(g, _cfg(mesh="2"), device="cpu") as s:
        assert s.tuned_for("bfs")["id"] == art["id"]
        engine = s._gas_single("bfs")
        assert engine.exchange_mode == "compact"
        assert engine.hi_count == math.ceil(0.9 * g.nv)
        assert any("compact" in k for k in s.pool._engines
                   if "bfs" in k)
        tuned = s.query("bfs", start=7, timeout=60)
    tune_cache().clear()
    with Session(g, _cfg(), device="cpu") as s:
        plain = s.query("bfs", start=7, timeout=60)
    np.testing.assert_array_equal(tuned["values"], plain["values"])
    np.testing.assert_array_equal(tuned["parent"], plain["parent"])


def test_corrupt_artifact_refuses_to_serve(tune_dir):
    """A file at the key that does not load raises at warmup: a corrupt
    artifact never silently becomes a fallback to defaults."""
    from lux_tpu_torch.serve import Session
    from lux_tpu_torch.utils.checkpoint import fingerprint_hex

    g = generate.gnp(120, 600, seed=184)
    art = _session_artifact(g, fingerprint_hex(g))
    path = artifact.save(tune_dir, art)
    with open(path, "w") as f:
        json.dump(dict(art, key_string="tampered"), f)
    with pytest.raises(ValueError, match="key_string"):
        Session(g, _cfg(), device="cpu")
