"""Port parity: the run recorder (``obs/iterlog.py``) on every executor.

The same R-MAT graph (scale 9, edge factor 8, seed 5) made by both
packages goes through each of the 13 executors that record a run
(``tests/torch_obs_cases.py``), once
with ``LUX_METRICS`` and ``LUX_TRACE`` set to the port's files and once
to ``lux_tpu``'s (on the conftest's virtual CPU devices), and the two
records must agree in every field that does not hold a time:

- the ``lux.run_telemetry.v1`` summary: engine, program, nv, ne,
  num_iters, parts, the exchange bytes, useful bytes and ratio, the HBM
  byte model and the crossovers;
- per iteration: iter, flush_span, active_edges, branch, frontier,
  frontier_density and crossover;
- the trace file's (name, cat, ph) multiset;
- the metrics snapshot's names, labels and kinds, and every counter's
  value.

The push and GAS fixpoints run with ``chunk=2``, so several flush
windows close. ``lux_tpu``'s ``ShardedAdaptiveExecutor.run()`` fails
under its JAX (ROADMAP C, the known gap), so that case drives
``lux_tpu``'s ``phase_step`` with a recorder set up and flushed the way
its ``run()`` and ``_run_sharded_gas_fixpoint`` do
(``lux_tpu/engine/gas_sharded.py:623-669, 926-963``), as
tests/test_torch_gas_sharded.py holds its values.

The flag table, the loggers, the device-profile rows, the flight dump
(read by ``tools/flight_summary.py``) and the SLO windows are held
here too.
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_obs_cases import (
    CASES,
    CHUNK,
    CPU,
    PULL_FAMILY,
    _bfs,
    _pagerank,
    _sssp,
    graphs,
)

from lux_tpu import obs as jobs
from lux_tpu.engine import gas as jgas
from lux_tpu.engine import gas_sharded as jgs
from lux_tpu.engine import push as jpush
from lux_tpu.engine import tiled as jtiled
from lux_tpu.obs import slo as jslo
from lux_tpu.ops.tiled_spmv import plan_hybrid as jplan
from lux_tpu_torch import obs as tobs
from lux_tpu_torch.engine import gas as tgas
from lux_tpu_torch.engine import gas_sharded as tgs
from lux_tpu_torch.engine import push as tpush
from lux_tpu_torch.engine import tiled as ttiled
from lux_tpu_torch.obs import flight as tflight
from lux_tpu_torch.obs import report as treport
from lux_tpu_torch.obs import slo as tslo
from lux_tpu_torch.ops.tiled_spmv import plan_hybrid as tplan
from lux_tpu_torch.utils import flags as tflags
from lux_tpu_torch.utils import logging as tlogging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUMMARY_KEYS = ("schema", "engine", "program", "nv", "ne", "num_iters",
                "parts", "exchange_bytes_per_iter", "exchange_bytes_total",
                "useful_bytes_per_iter", "useful_ratio",
                "hbm_bytes_per_iter", "crossovers")
ITER_KEYS = ("iter", "flush_span", "active_edges", "branch", "frontier",
             "frontier_density", "crossover")
OBS = {"jax": jobs, "torch": tobs}


@pytest.fixture
def telemetry(tmp_path, monkeypatch):
    """``capture(pkg, run)``: ``run()`` with LUX_METRICS and LUX_TRACE set
    to ``pkg``'s files and its metrics registry fresh; returns (result,
    the run records, the trace events, the metrics snapshot). The trace
    writers are closed again afterwards."""
    for name in ("LUX_METRICS", "LUX_TRACE", "LUX_ENGOBS",
                 "LUX_FLIGHT_DIR", "LUX_LEDGER_DIR"):
        monkeypatch.delenv(name, raising=False)

    def capture(pkg, run):
        m = tmp_path / f"{pkg}_metrics.jsonl"
        t = tmp_path / f"{pkg}_trace.jsonl"
        for p in (m, t):
            if p.exists():
                p.unlink()
        os.environ["LUX_METRICS"] = str(m)
        os.environ["LUX_TRACE"] = str(t)
        OBS[pkg].reconfigure()
        OBS[pkg].metrics.reset()
        try:
            out = run()
            snap = OBS[pkg].metrics.snapshot()
        finally:
            del os.environ["LUX_METRICS"], os.environ["LUX_TRACE"]
            OBS[pkg].reconfigure()
        recs = [json.loads(ln) for ln in m.read_text().splitlines()
                if ln.strip()]
        events = [json.loads(ln) for ln in t.read_text().splitlines()
                  if ln.strip()]
        return out, recs, events, snap

    yield capture
    for pkg in OBS:
        OBS[pkg].reconfigure()


def _fixed(rec: dict) -> dict:
    out = {k: rec.get(k) for k in SUMMARY_KEYS}
    out["iterations"] = [{k: it.get(k) for k in ITER_KEYS}
                         for it in rec["iterations"]]
    return out


def _events(events) -> collections.Counter:
    return collections.Counter(
        (e.get("name"), e.get("cat"), e.get("ph")) for e in events)


def _metrics(snap) -> dict:
    """name, labels, kind -> counter value (None for gauges and
    histograms)."""
    return {(m["name"], tuple(sorted(m["labels"].items())), m["kind"]):
            (m["value"] if m["kind"] == "counter" else None) for m in snap}


def assert_same_run(got, want):
    """The port's (records, events, metrics) against lux_tpu's."""
    recs, events, snap = got
    jrecs, jevents, jsnap = want
    assert len(recs) == len(jrecs) >= 1
    for r, j in zip(recs, jrecs):
        assert r["schema"] == "lux.run_telemetry.v1"
        assert _fixed(r) == _fixed(j)
        assert r["compile_s"] >= 0 and r["execute_s"] > 0
    assert _events(events) == _events(jevents)
    assert _metrics(snap) == _metrics(jsnap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recorder_equals_lux_tpus(telemetry, case):
    make = CASES[case]
    jrun, trun = make("jax"), make("torch")
    (jvals, jiters), *want = telemetry("jax", jrun)
    (tvals, titers), *got = telemetry("torch", trun)
    assert titers == jiters
    if case in PULL_FAMILY:
        np.testing.assert_allclose(tvals, jvals, rtol=5e-5, atol=1e-9)
    else:
        np.testing.assert_array_equal(tvals, jvals)
    assert_same_run(got, want)
    rec = got[0][-1]
    assert rec["engine"] == ("incremental" if case.startswith("incr")
                             else case)
    if case in PULL_FAMILY:
        # run(10) at the default flush_every=8: two flush windows.
        assert {it["flush_span"] for it in rec["iterations"]} == {1, 2}
    else:
        spans = [it["flush_span"] for it in rec["iterations"]]
        assert spans == [i // CHUNK + 1 for i in range(len(spans))]


def test_null_recorder_when_every_knob_is_unset(monkeypatch):
    for name in ("LUX_METRICS", "LUX_TRACE", "LUX_ENGOBS",
                 "LUX_FLIGHT_DIR", "LUX_LEDGER_DIR"):
        monkeypatch.delenv(name, raising=False)
    tobs.reconfigure()
    _, tg = graphs()
    assert not tobs.telemetry_enabled()
    assert tobs.recorder_for("tiled", tg) is tobs.NULL_RECORDER
    for name in ("LUX_METRICS", "LUX_ENGOBS", "LUX_FLIGHT_DIR",
                 "LUX_LEDGER_DIR"):
        with tflags.overrides({name: "1" if name == "LUX_ENGOBS"
                               else "/nonexistent"}):
            assert tobs.telemetry_enabled(), name
            rec = tobs.recorder_for("tiled", tg)
            assert isinstance(rec, tobs.IterationRecorder)


def test_engine_labels_are_lux_tpus():
    jg, tg = graphs()
    pairs = [
        (jtiled.TiledPullExecutor(jg, _pagerank("jax"), plan=jplan(jg)),
         ttiled.TiledPullExecutor(tg, _pagerank("torch"), plan=tplan(tg),
                                  device=CPU)),
        (jpush.PushExecutor(jg, _sssp("jax")),
         tpush.PushExecutor(tg, _sssp("torch"), device=CPU)),
        (jgas.AdaptiveExecutor(jg, _bfs("jax")),
         tgas.AdaptiveExecutor(tg, _bfs("torch"), device=CPU)),
        (jgs.ShardedAdaptiveExecutor(jg, _bfs("jax"), num_parts=2),
         tgs.ShardedAdaptiveExecutor(tg, _bfs("torch"), num_parts=2,
                                     device=CPU)),
    ]
    for j, t in pairs:
        assert tobs.engine_label(t) == jobs.engine_label(j)
    assert tobs.gteps(100, 3, 2.0) == jobs.gteps(100, 3, 2.0)


def test_iteration_recorder_math_equals_lux_tpus():
    """The recorder alone, fed the same calls, writes the same records
    (times aside)."""
    out = []
    for mod in (jobs, tobs):
        rec = mod.IterationRecorder("push", 100, 1000, program="SSSP")
        rec.start()
        rec.flush(2, frontier_sizes=[5, 50], sparse_flags=[1, 0])
        rec.flush(3, frontier_sizes=[0], sparse_flags=[1], residual=0.5)
        rec.record_phase(4, 0.01, 0.02, frontier=3, branch="sparse/8",
                         detail={"compTime": 0.02, "loadTime": 0.01})
        rec.set_exchange_bytes(64, parts=2)
        rec.set_overlap(True)
        s = rec.summary()
        out.append(({k: s.get(k) for k in SUMMARY_KEYS},
                    [{k: v for k, v in it.items()
                      if k in ITER_KEYS or k == "residual"}
                     for it in s["iterations"]],
                    sorted(s["phases"])))
    assert out[0] == out[1]
    assert tobs.NULL_RECORDER.finish() is None
    assert not tobs.NULL_RECORDER.enabled


# -- flags, loggers, report ------------------------------------------------------


def test_flag_table_has_the_obs_flags():
    from lux_tpu.utils import flags as jflags

    for name in ("LUX_METRICS", "LUX_LOG", "LUX_ENGOBS", "LUX_FLIGHT_DIR",
                 "LUX_FLIGHT_CAPACITY", "LUX_STATUSZ_WINDOWS",
                 "LUX_PROF_DIR", "LUX_LEDGER_DIR", "LUX_LEDGER_ROTATE_BYTES",
                 "LUX_HBM_PEAK_GBPS", "LUX_ICI_PEAK_GBPS",
                 "LUX_HBM_CAPACITY_BYTES", "LUX_TRACE", "LUX_SPANS"):
        assert tflags.declared(name), name
        assert tflags.default(name) == jflags.default(name), name
    assert set(tflags.names()) <= set(jflags.names())
    # Of the tuner, bench, serving and lint-tier families the port
    # declares the tuner's flags (tune/), the program-contract tier's
    # (analysis/gasck.py), the memory tier's (analysis/memck.py, with
    # the two bench knobs its LUX703 reads), the trace tiers'
    # LUX_IR_BLOWUP and the serving knobs (the serve pool reads the
    # audit and admission flags).
    assert {n for n in tflags.names()
            if n.startswith(("LUX_TUNE", "LUX_BENCH", "LUX_SERVE",
                             "LUX_MEM", "LUX_GASCK", "LUX_GASCAP",
                             "LUX_IR", "LUX_HBM_BUDGET"))} == {
        n for n in jflags.names()
        if n.startswith(("LUX_TUNE", "LUX_GASCK", "LUX_GASCAP", "LUX_MEM",
                         "LUX_HBM_BUDGET"))} | {
        "LUX_SERVE_MESH", "LUX_IR_POOL_AUDIT", "LUX_IR_BLOWUP",
        "LUX_BENCH_SCALE", "LUX_BENCH_EF"}
    for name in ("LUX_GASCK_SEED", "LUX_GASCK_TRIPLES", "LUX_GASCK_NV",
                 "LUX_MEMCAP_DIR", "LUX_MEM_MODEL_TOL",
                 "LUX_MEM_SWEEP_FACTOR", "LUX_HBM_BUDGET_BYTES",
                 "LUX_HBM_BUDGET_FRAC", "LUX_BENCH_SCALE", "LUX_BENCH_EF"):
        assert tflags.default(name) == jflags.default(name), name
        assert tflags._flag(name).kind == jflags._flag(name).kind, name
    table = tflags.table()
    assert table.splitlines()[0].split()[:3] == ["flag", "kind", "default"]
    assert len(table.splitlines()) == len(tflags.names()) + 1
    snap = tflags.snapshot()
    assert list(snap) == list(tflags.names())
    with tflags.overrides({"LUX_GAS": "pull", "LUX_METRICS": None}):
        assert tflags.get("LUX_GAS") == "pull"
        assert tflags.snapshot()["LUX_GAS"] == "pull"
        with tflags.overrides({"LUX_GAS": "push"}):
            assert tflags.get("LUX_GAS") == "push"
        assert tflags.get("LUX_GAS") == "pull"
    with pytest.raises(KeyError):
        with tflags.overrides({"LUX_NOT_A_FLAG": 1}):
            pass


def test_flag_table_prints(tmp_path):
    r = subprocess.run([sys.executable, "-m", "lux_tpu_torch.utils.flags"],
                       cwd=ROOT, capture_output=True, text=True, check=True)
    assert "LUX_LEDGER_DIR" in r.stdout and "LUX_ENGOBS" in r.stdout


def test_log_level_follows_lux_log(monkeypatch):
    import logging

    log = tlogging.perf_logger()
    assert log.name == "lux_tpu_torch.perf"
    monkeypatch.setenv("LUX_LOG", "ERROR")
    tobs.reconfigure()
    assert logging.getLogger("lux_tpu_torch").level == logging.ERROR
    monkeypatch.setenv("LUX_LOG", "debug")
    tlogging.reconfigure()
    assert logging.getLogger("lux_tpu_torch").level == logging.DEBUG
    monkeypatch.delenv("LUX_LOG")
    tlogging.reconfigure()
    assert logging.getLogger("lux_tpu_torch").level == logging.INFO
    assert len(logging.getLogger("lux_tpu_torch").handlers) == 1


def test_device_profile_rows(monkeypatch):
    for name in ("LUX_HBM_PEAK_GBPS", "LUX_ICI_PEAK_GBPS",
                 "LUX_HBM_CAPACITY_BYTES"):
        monkeypatch.delenv(name, raising=False)
    cpu = treport.device_profile("cpu")
    assert (cpu["hbm_peak_gbps"], cpu["ici_peak_gbps"],
            cpu["hbm_capacity_bytes"], cpu["known"]) == (None, None, None,
                                                         True)
    card = treport.device_profile("NVIDIA H100 80GB HBM3")
    assert card["hbm_peak_gbps"] == 3350.0 and card["known"]
    assert card["ici_peak_gbps"] is None
    unknown = treport.device_profile("Some Accelerator")
    assert unknown["hbm_peak_gbps"] is None and not unknown["known"]
    monkeypatch.setenv("LUX_HBM_PEAK_GBPS", "1000")
    monkeypatch.setenv("LUX_ICI_PEAK_GBPS", "50")
    monkeypatch.setenv("LUX_HBM_CAPACITY_BYTES", str(1 << 30))
    over = treport.device_profile("Some Accelerator")
    assert (over["hbm_peak_gbps"], over["ici_peak_gbps"],
            over["hbm_capacity_bytes"]) == (1000.0, 50.0, 1 << 30)
    assert treport.device_profile()["device_kind"] == (
        torch.cuda.get_device_name() if torch.cuda.is_available()
        else "cpu")


def test_roofline_fractions(monkeypatch):
    for name in ("LUX_HBM_PEAK_GBPS", "LUX_ICI_PEAK_GBPS"):
        monkeypatch.delenv(name, raising=False)
    summary = {"num_iters": 10, "execute_s": 1.0,
               "hbm_bytes_per_iter": 335_000_000_000,
               "exchange_bytes_per_iter": 8_000_000_000, "parts": 4}
    monkeypatch.setattr(treport, "_kind_cache", ["NVIDIA H100 80GB HBM3"])
    roof = treport.roofline(summary)
    assert roof["hbm_gbps"] == pytest.approx(3350.0)
    assert roof["hbm_frac"] == pytest.approx(1.0)
    assert roof["ici_frac"] is None and roof["ici_note"] == "one card"
    assert roof["ici_gbps_per_chip"] == pytest.approx(20.0)
    monkeypatch.setenv("LUX_ICI_PEAK_GBPS", "40")
    assert treport.roofline(summary)["ici_frac"] == pytest.approx(0.5)
    monkeypatch.setattr(treport, "_kind_cache", ["Some Accelerator"])
    monkeypatch.delenv("LUX_ICI_PEAK_GBPS")
    roof = treport.roofline(summary)
    assert roof["hbm_frac"] is None and roof["ici_frac"] is None
    summary.update(schema="lux.run_telemetry.v1", engine="tiled",
                   program="PageRank", nv=1, ne=2, compile_s=0.0,
                   gteps=0.0, exchange_bytes_total=0, iterations=[],
                   roofline=roof)
    assert "one card" in treport._format_table(summary)


def test_read_last(tmp_path):
    p = tmp_path / "m.jsonl"
    p.write_text('{"a": 1}\n{"a": 2}\n\n')
    assert treport.read_last(str(p)) == {"a": 2}
    (tmp_path / "empty").write_text("")
    with pytest.raises(ValueError):
        treport.read_last(str(tmp_path / "empty"))


# -- flight recorder and SLO windows ---------------------------------------------


def test_flight_dump_reads_in_flight_summary(tmp_path, monkeypatch,
                                             telemetry):
    monkeypatch.setenv("LUX_FLIGHT_DIR", str(tmp_path / "flight"))
    tflight.reset()
    tflight.add_context("engine", lambda: {"parts": 4})
    tflight.add_context("broken", lambda: 1 / 0)
    try:
        _, tg = graphs()
        ex = tpush.PushExecutor(tg, _sssp("torch"), device=CPU)
        ex.run(start=0)       # the armed flight recorder turns records on
        assert tflight.counts()["iterations"] >= 1
        path = tflight.dump("test", detail="a dump", force=True)
        assert tflight.dump("test") is None          # debounced
    finally:
        tflight.remove_context("engine")
        tflight.remove_context("broken")
    doc = json.loads(open(path).read())
    assert doc["schema"] == "flight.v1"
    assert doc["context"]["engine"] == {"parts": 4}
    assert "error" in doc["context"]["broken"]
    assert doc["flags"]["LUX_FLIGHT_DIR"] == str(tmp_path / "flight")
    assert doc["iterations"][0]["engine"] == "push"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "flight_summary.py"),
         str(tmp_path / "flight")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "test" in r.stdout and "push" in r.stdout
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "flight_summary.py"),
         path, "--json"], capture_output=True, text=True)
    assert r.returncode == 0 and json.loads(r.stdout)
    monkeypatch.delenv("LUX_FLIGHT_DIR")
    assert tflight.dump("test", force=True) is None


def test_flight_capacity_reconfigure(monkeypatch):
    monkeypatch.setenv("LUX_FLIGHT_DIR", "/nonexistent")
    monkeypatch.setenv("LUX_FLIGHT_CAPACITY", "3")
    tflight.reconfigure()
    try:
        for i in range(5):
            tflight.note_iteration({"iter": i})
        assert tflight.counts()["iterations"] == 3
        assert tflight.counts()["capacity"] == 3
    finally:
        monkeypatch.delenv("LUX_FLIGHT_CAPACITY")
        tflight.reconfigure()
        tflight.reset()


def test_slo_windows_equal_lux_tpus(monkeypatch):
    rng = np.random.default_rng(3)
    times = np.cumsum(rng.uniform(0.0, 2.0, 400))
    lats = rng.lognormal(-4.0, 1.0, 400)
    snaps = []
    for mod in (jslo, tslo):
        clock = {"t": 0.0}
        w = mod.SloWindows(windows=(60.0, 300.0), now=lambda: clock["t"])
        for i, (t, v) in enumerate(zip(times, lats)):
            clock["t"] = float(t)
            w.observe("sssp" if i % 3 else "bfs", float(v))
        snaps.append(w.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["60s"]["sssp"]["count"] > 0
    monkeypatch.setenv("LUX_STATUSZ_WINDOWS", "300, 5,x,-1")
    assert tslo.windows_from_flags() == jslo.windows_from_flags() == (
        5.0, 300.0)
    monkeypatch.setenv("LUX_STATUSZ_WINDOWS", "")
    assert tslo.windows_from_flags() == (60.0, 300.0)
