"""Port parity: the device-timeline profiler (``obs/prof.py``) on
torch.profiler's Chrome traces.

The parser is fed synthetic traces in torch's format, one per case of
``tests/test_prof.py`` (merge and intersect, two-phase union and
overlap, nested regions, zero-length events, out-of-order timestamps,
several devices, a missing ``dur``, a non-numeric ``ts`` or a non-object
event, host regions, unknown kernels, a truncated gzip, a bare event
list and a missing file), and must give the right interval math or a
loud ``ProfileParseError``. Device work is the ``kernel`` /
``gpu_memcpy`` / ``gpu_memset`` events; a kernel's region is the
innermost ``lux.*`` ``gpu_user_annotation`` covering it on its stream,
else the ``lux.*`` host span covering the CUDA launch with its
``correlation`` id. Every report passes ``lux_tpu.obs.prof.validate`` as well as the
port's. A real CPU capture of the sharded pull path has no device
streams and counts its ``lux.*`` regions as host regions; it reads in
``python -m lux_tpu_torch.tools.prof_summary``.
"""

import gzip
import json
import os
import signal
import subprocess
import sys

import pytest

from lux_tpu.obs import prof as jprof
from lux_tpu_torch import models as tmodels
from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.obs import prof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX, CO = "lux.test.exchange", "lux.test.compute"
HOST = 4242            # the host process's pid in the synthetic traces


def kern(name, ts, dur, pid=0, corr=None, cat="kernel", tid=7):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
         "ts": ts, "args": {"device": pid, "stream": tid}}
    if dur is not None:
        e["dur"] = dur
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def gpu_range(name, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": "gpu_user_annotation", "name": name,
            "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": {}}


def host(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": HOST,
            "tid": tid, "ts": ts, "dur": dur, "args": {"External id": 1}}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": HOST, "tid": tid, "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def parse(events, **kw):
    rep = prof.parse_events({"traceEvents": events}, **kw)
    assert jprof.validate(json.loads(json.dumps(rep))) is not None
    return rep


def phased(ex=(0, 10), co=(5, 10), pid=0):
    """An exchange kernel and a compute kernel on two streams of one
    device, each inside its range."""
    return [gpu_range(EX, ex[0], ex[1], pid), kern("nccl", *ex, pid=pid),
            gpu_range(CO, co[0], co[1], pid, tid=8),
            kern("k1", *co, pid=pid, tid=8)]


# -- interval algebra ----------------------------------------------------------


def test_merge_coalesces_and_drops_empty():
    assert prof.merge_intervals([(5, 7), (0, 2), (1, 3), (7, 7)]) == \
        [(0.0, 3.0), (5.0, 7.0)] == jprof.merge_intervals(
            [(5, 7), (0, 2), (1, 3), (7, 7)])
    assert prof.union_total([(0.0, 3.0), (5.0, 7.0)]) == 5.0


def test_intersect_merged():
    a = prof.merge_intervals([(0, 10)])
    b = prof.merge_intervals([(2, 4), (6, 8), (9, 12)])
    assert prof.intersect_merged(a, b) == [(2.0, 4.0), (6.0, 8.0),
                                          (9.0, 10.0)]


# -- classification and the union/intersection math ------------------------------


def test_two_phase_union_and_overlap():
    rep = parse(phased())
    d = rep["devices"]["0"]
    assert d["exchange_us"] == 10 and d["compute_us"] == 10
    assert d["overlap_us"] == 5 and d["union_us"] == 15
    assert d["realized_hidden_frac"] == 0.5
    assert rep["realized_hidden_frac"] == 0.5
    assert rep["tags"] == [CO, EX]
    assert {t["op"]: t["tag"] for t in rep["top_ops"]} == {"nccl": EX,
                                                           "k1": CO}


def test_nested_regions_do_not_double_count():
    rep = parse([gpu_range(EX, 0, 10), kern("nccl", 0, 10),
                 kern("nccl", 2, 4), kern("nccl", 3, 2)])
    assert rep["devices"]["0"]["exchange_us"] == 10
    # The innermost of nested ranges tags a kernel.
    rep = parse([gpu_range(CO, 0, 100), gpu_range(EX, 10, 10),
                 kern("a", 12, 5), kern("b", 50, 5)])
    d = rep["devices"]["0"]
    assert d["exchange_us"] == 5 and d["compute_us"] == 5


def test_zero_length_events_are_harmless():
    rep = parse([gpu_range(EX, 5, 0), kern("nccl", 5, 0),
                 gpu_range(CO, 0, 4), kern("k1", 0, 4)])
    d = rep["devices"]["0"]
    assert d["exchange_us"] == 0 and d["compute_us"] == 4
    assert d["realized_hidden_frac"] is None


def test_out_of_order_timestamps():
    evs = [gpu_range(CO, 100, 10), kern("k1", 100, 10),
           gpu_range(EX, 0, 10), kern("nccl", 0, 10),
           gpu_range(CO, 4, 2, tid=8), kern("k1", 4, 2, tid=8)]
    d = parse(evs)["devices"]["0"]
    assert d["exchange_us"] == 10 and d["compute_us"] == 12
    assert d["overlap_us"] == 2
    assert d["span_us"] == 110


def test_multi_device_streams_stay_separate():
    rep = parse([gpu_range(EX, 0, 10, pid=0), kern("nccl", 0, 10, pid=0),
                 gpu_range(CO, 0, 10, pid=1), kern("k1", 0, 10, pid=1),
                 {"ph": "M", "name": "process_name", "pid": 1,
                  "args": {"name": "GPU 1"}}])
    assert set(rep["devices"]) == {"0", "1"}
    assert rep["devices"]["0"]["overlap_us"] == 0
    assert rep["devices"]["1"]["overlap_us"] == 0
    assert rep["devices"]["1"]["device"] == "GPU 1"
    assert rep["realized_hidden_frac"] == 0.0


def test_missing_dur_counts_as_instant():
    d = parse([gpu_range(EX, 0, 10), kern("nccl", 0, 10),
               gpu_range(CO, 3, 0), kern("k1", 3, None)])["devices"]["0"]
    assert d["compute_us"] == 0 and d["exchange_us"] == 10


def test_non_numeric_ts_is_loud():
    with pytest.raises(prof.ProfileParseError, match="non-numeric"):
        parse([kern("nccl", "soon", 10)])


def test_non_object_event_is_loud():
    with pytest.raises(prof.ProfileParseError, match="non-object"):
        parse(["not-an-event"])


def test_host_regions_never_join_device_unions():
    rep = parse([host("lux.serve.execute", 0, 100)] + phased(co=(20, 10)))
    assert rep["devices"]["0"]["overlap_us"] == 0
    assert rep["host_regions"]["lux.serve.execute"]["count"] == 1
    assert "lux.serve.execute" in rep["tags"]
    assert set(rep["devices"]) == {"0"}


def test_non_lux_host_spans_ignored():
    rep = parse([host("SomeFrameworkSpan", 0, 50),
                 {"ph": "X", "cat": "cpu_op", "name": "aten::add",
                  "pid": HOST, "tid": 1, "ts": 1, "dur": 3}])
    assert rep["host_regions"] == {} and rep["devices"] == {}


def test_unknown_kernels_count_busy_not_phase():
    rep = parse([kern("copy", 0, 10), kern("memcpy HtoD", 20, 5,
                                           cat="gpu_memcpy"),
                 kern("memset", 30, 1, cat="gpu_memset")])
    d = rep["devices"]["0"]
    assert d["busy_us"] == 16 and d["span_us"] == 31
    assert d["exchange_us"] == 0 and d["compute_us"] == 0
    assert d["idle_frac"] == pytest.approx(1 - 16 / 31)


def test_launch_correlation_tags_a_kernel_outside_device_ranges():
    rep = parse([host(EX, 40, 20), launch(50, corr=7), kern("k", 100, 10,
                                                            corr=7),
                 host(CO, 70, 20, tid=2), launch(75, corr=8, tid=2),
                 kern("k", 200, 4, corr=8),
                 launch(95, corr=9), kern("untagged", 300, 1, corr=9)])
    d = rep["devices"]["0"]
    assert d["exchange_us"] == 10 and d["compute_us"] == 4
    assert d["busy_us"] == 15


def test_device_range_wins_over_the_launch_join():
    rep = parse([host(EX, 40, 20), launch(50, corr=7),
                 gpu_range(CO, 100, 10), kern("k", 100, 10, corr=7)])
    assert rep["devices"]["0"]["compute_us"] == 10


def test_gzip_truncated_artifact_is_loud(tmp_path):
    whole = gzip.compress(json.dumps(
        {"traceEvents": [kern("k1", 0, 10)] * 100}).encode())
    p = tmp_path / "t.pt.trace.json.gz"
    p.write_bytes(whole[:len(whole) // 2])
    with pytest.raises(prof.ProfileParseError):
        prof.parse(str(p))


def test_bare_event_list_and_missing_file(tmp_path):
    p = tmp_path / "bare.json"
    p.write_text(json.dumps([gpu_range(CO, 0, 4), kern("k1", 0, 4)]))
    assert prof.parse(str(p))["devices"]["0"]["compute_us"] == 4
    with pytest.raises(prof.ProfileParseError):
        prof.find_trace_artifact(str(tmp_path))   # no trace artifact
    with pytest.raises(prof.ProfileParseError):
        prof.parse(str(tmp_path / "missing.pt.trace.json.gz"))
    (tmp_path / "x.json").write_text(json.dumps({"no": "events"}))
    with pytest.raises(prof.ProfileParseError, match="traceEvents"):
        prof.load_chrome_trace(str(tmp_path / "x.json"))


def test_validate_rejects_broken_invariants():
    rep = parse(phased())
    bad = json.loads(json.dumps(rep))
    bad["devices"]["0"]["union_us"] = 3.0
    with pytest.raises(prof.ProfileParseError, match="union"):
        prof.validate(bad)
    worse = json.loads(json.dumps(rep))
    worse["realized_hidden_frac"] = 1.5
    with pytest.raises(prof.ProfileParseError, match="outside"):
        prof.validate(worse)
    with pytest.raises(prof.ProfileParseError):
        prof.validate({"schema": "profile.v0"})


def test_steps_cross_check_blocks():
    rep = parse([kern("k1", 0, 2_000_000)], steps=4,
                iterlog_summary={"num_iters": 4, "execute_s": 2.0})
    st = rep["steps"]
    assert st["captured"] == 4
    assert st["steps_per_s"] == pytest.approx(2.0)
    assert st["iterlog"]["steps_per_s"] == pytest.approx(2.0)
    text = prof.format_report(rep)
    assert "steps: 4 captured" in text and "iterlog cross-check" in text


# -- region names and capture windows ------------------------------------------------


def test_region_rejects_bad_names():
    for bad in ("pull.exchange", "lux.Pull", "lux.", "LUX.x", "lux x"):
        with pytest.raises(ValueError):
            prof.region(bad)
    r = prof.region("lux.pull_sharded.exchange")
    with r:                       # no capture live: nothing is recorded
        with r:
            pass


def test_trace_of_a_falsy_dir_is_inert():
    with prof.trace(None):
        pass
    with prof.trace(""):
        pass


def _sharded_run():
    g = tgen.rmat(8, 8, seed=5)
    ex = ShardedPullExecutor(g, tmodels.get_program("pagerank"),
                             num_parts=4, device="cpu")
    return lambda: ex.run(3)


def test_cpu_capture_of_the_sharded_path(tmp_path, monkeypatch):
    run = _sharded_run()
    monkeypatch.delenv("LUX_PROF_DIR", raising=False)
    with pytest.raises(ValueError, match="not armed"):
        prof.profile_window(run)
    out, rep = prof.profile_window(
        run, dirname=str(tmp_path / "prof"), steps=3,
        iterlog_summary=lambda: {"num_iters": 3, "execute_s": 0.5})
    assert out.shape[0] == 4
    assert rep["devices"] == {}
    assert rep["host_regions"]["lux.pull_sharded.exchange"]["count"] == 3
    assert rep["host_regions"]["lux.pull_sharded.compute"]["count"] == 3
    assert rep["tags"] == ["lux.pull_sharded.compute",
                           "lux.pull_sharded.exchange"]
    assert rep["steps"]["captured"] == 3
    assert rep["steps"]["iterlog"]["steps_per_s"] == 6.0
    assert prof.latest() is rep and prof.latest_realized() is None
    jprof.validate(json.loads(json.dumps(rep)))
    art = prof.find_trace_artifact(rep["capture_dir"])
    assert art.endswith(".pt.trace.json.gz")
    # Outside a capture the regions record nothing again.
    with prof.trace(str(tmp_path / "again")):
        pass
    assert prof.parse_dir(str(tmp_path / "again"))["host_regions"] == {}
    for argv, want in (([], "profile.v1 device timeline"),
                       (["--json"], '"schema": "profile.v1"'),
                       (["--validate"], "")):
        r = subprocess.run(
            [sys.executable, "-m", "lux_tpu_torch.tools.prof_summary",
             rep["capture_dir"], *argv], cwd=ROOT, capture_output=True,
            text=True)
        assert r.returncode == 0, r.stderr
        assert want in r.stdout
    bad = tmp_path / "bad.pt.trace.json.gz"
    bad.write_bytes(b"\x1f\x8b\x08garbage")
    r = subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.prof_summary",
         str(bad)], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 1 and "INVALID" in r.stderr


def test_one_capture_at_a_time(tmp_path):
    def nested():
        with pytest.raises(prof.CaptureBusyError):
            prof.profile_window(lambda: None, dirname=str(tmp_path / "b"))
        return 1

    out, _ = prof.profile_window(nested, dirname=str(tmp_path / "a"))
    assert out == 1


def test_sigusr2_toggles_a_capture(tmp_path, monkeypatch):
    monkeypatch.setenv("LUX_PROF_DIR", str(tmp_path))
    old = signal.getsignal(signal.SIGUSR2)
    try:
        assert prof.install_signal_handler()
        run = _sharded_run()
        os.kill(os.getpid(), signal.SIGUSR2)     # start
        run()
        os.kill(os.getpid(), signal.SIGUSR2)     # stop, parse, publish
    finally:
        signal.signal(signal.SIGUSR2, old)
    rep = prof.latest()
    assert rep["host_regions"]["lux.pull_sharded.compute"]["count"] == 3
    with open(os.path.join(rep["capture_dir"], "profile_v1.json")) as f:
        assert json.load(f)["schema"] == "profile.v1"
    monkeypatch.delenv("LUX_PROF_DIR")
    prof._toggle_capture()                        # unarmed: ignored
