"""Port parity: serving (``serve/``) and the recompile sentinel.

The counterparts of tests/test_serve.py on the port (admission control,
batch formation, the pool, the cache's LRU and byte budget, bad queries,
no rebuild and zero recompiles after warmup, the HTTP front end), and
the port's ``Session`` held against ``lux_tpu``'s on the same R-MAT 10
and its weighted twin: the same served apps, rooted and fixpoint tuples;
SSSP, CC, BFS, DeltaSSSP, label propagation and k-core bitwise with
equal iteration counts (and direction splits, parents, communities,
core flags) for several roots, single-lane and batched; PageRank within
rtol=5e-5, atol=1e-9. On the CPU the engines run the kernels' plain
versions; the card runs are in tests/test_torch_cuda.py.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from lux_tpu.graph import generate as jgen
from lux_tpu.serve import ServeConfig as JServeConfig
from lux_tpu.serve import Session as JSession
from lux_tpu_torch.analysis.sentinel import RecompileError, RecompileSentinel
from lux_tpu_torch.graph import generate
from lux_tpu_torch.models.pagerank import reference_pagerank
from lux_tpu_torch.models.sssp import reference_sssp
from lux_tpu_torch.obs import metrics
from lux_tpu_torch.ops import _cuda
from lux_tpu_torch.serve import (
    BadQueryError,
    DeadlineExceededError,
    EnginePool,
    MicroBatcher,
    QueueFullError,
    Request,
    ResultCache,
    ServeConfig,
    Session,
)
from lux_tpu_torch.serve.pool import (EXCH_AUDIT_STATUS, GAS_AUDIT_STATUS,
                                      NOT_PORTED)

ROOTS = (0, 5, 77, 300)


def _cfg(cls=ServeConfig, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("window_s", 0.25)
    kw.setdefault("max_queue", 64)
    kw.setdefault("pagerank_iters", 4)
    return cls(**kw)


# -- admission control ----------------------------------------------------


def _stalled_batcher(max_queue, max_batch=1):
    """A batcher whose executor blocks until released (deterministic
    queue-full / deadline scenarios without timing races)."""
    release = threading.Event()
    started = threading.Event()

    def execute(batch):
        started.set()
        release.wait(10)
        for r in batch:
            r.future.set_result("done")

    b = MicroBatcher(execute, max_batch=max_batch, window_s=0.01,
                     max_queue=max_queue)
    return b, release, started


def test_queue_full_rejects_with_backpressure():
    metrics.reset()
    b, release, started = _stalled_batcher(max_queue=2)
    try:
        first = b.submit(Request(app="x", payload=None, batch_key=None))
        assert started.wait(5), "worker never picked up a request"
        q1 = b.submit(Request(app="x", payload=None, batch_key=None))
        q2 = b.submit(Request(app="x", payload=None, batch_key=None))
        t0 = time.monotonic()
        with pytest.raises(QueueFullError):
            b.submit(Request(app="x", payload=None, batch_key=None))
        assert time.monotonic() - t0 < 1.0, "rejection blocked"
        assert metrics.counter("lux_serve_rejected_total").value == 1
        release.set()
        assert first.result(10) == "done"
        assert q1.result(10) == "done" and q2.result(10) == "done"
    finally:
        release.set()
        b.close()


def test_deadline_expired_requests_are_shed():
    metrics.reset()
    b, release, started = _stalled_batcher(max_queue=8)
    try:
        blocker = b.submit(Request(app="x", payload=None, batch_key=None))
        assert started.wait(5)
        expired = b.submit(Request(
            app="x", payload=None, batch_key=None,
            deadline=time.monotonic() - 0.001,
        ))
        fresh = b.submit(Request(
            app="x", payload=None, batch_key=None,
            deadline=time.monotonic() + 30,
        ))
        release.set()
        with pytest.raises(DeadlineExceededError):
            expired.result(10)
        assert fresh.result(10) == "done"
        assert blocker.result(10) == "done"
        assert metrics.counter(
            "lux_serve_deadline_expired_total").value == 1
    finally:
        release.set()
        b.close()


def test_batcher_forms_multi_request_batches():
    sizes = []
    done = threading.Event()

    def execute(batch):
        sizes.append([r.payload for r in batch])
        for r in batch:
            r.future.set_result(len(batch))
        if len(sizes) >= 2:
            done.set()

    b = MicroBatcher(execute, max_batch=8, window_s=0.25, max_queue=32)
    try:
        futs = [
            b.submit(Request(app="s", payload=i, batch_key="A"))
            for i in range(4)
        ]
        other = b.submit(Request(app="s", payload="b0", batch_key="B"))
        assert done.wait(10)
        assert futs[0].result(5) == 4
        assert other.result(5) == 1
        assert sizes[0] == [0, 1, 2, 3] and sizes[1] == ["b0"]
    finally:
        b.close()


# -- pool, cache, sentinel ------------------------------------------------


def test_engine_pool_builds_once():
    metrics.reset()
    pool = EnginePool()
    builds = []
    k = ("push", "fp", "sssp", 1)
    a = pool.get(k, lambda: builds.append(1) or object())
    bb = pool.get(k, lambda: builds.append(1) or object())
    assert a is bb and builds == [1]
    st = pool.stats()
    audits = st.pop("audits")
    # lux_tpu's dict, but for the footprint model, which is not ported.
    # The program-algebra and exchange-plan audits run; their counters
    # are process-global, as lux_tpu's are, and exch_findings is an int.
    gas = metrics.counter("lux_gas_findings_total").value
    assert st == {"engines": 1, "hits": 1, "misses": 1, "retired": 0,
                  "warmup_compiles": 0, "recompiles": 0,
                  "ir_findings": 0, "exch_findings": 0,
                  "gas_findings": gas, "hbm_resident_bytes": None,
                  "hbm_evictions": 0}
    assert audits["exchck"]["status"] == EXCH_AUDIT_STATUS
    assert audits["exchck"]["audited_builds"] == 0   # no plan carried
    assert audits["gasck"]["status"] == GAS_AUDIT_STATUS
    assert audits["gasck"]["audited_builds"] == 0   # no program carried
    assert audits["memck"]["status"].startswith(NOT_PORTED)
    pool.close()


def test_pool_audits_off_read_zero(monkeypatch):
    for flag in ("LUX_IR_POOL_AUDIT", "LUX_EXCH_POOL_AUDIT",
                 "LUX_GAS_POOL_AUDIT", "LUX_MEM_POOL_ADMIT"):
        monkeypatch.setenv(flag, "0")
    pool = EnginePool("audits-off")
    st = pool.stats()
    assert st["exch_findings"] == 0 and st["gas_findings"] == 0
    assert not any(a["requested"] for a in st["audits"].values())
    pool.close()


def test_pool_counts_builds_the_audits_would_read():
    class Prog:
        pass

    class Ex:
        program = Prog()
        _xplan = object()

    metrics.reset()
    pool = EnginePool("audits")
    pool.get(("a",), Ex)
    pool.get(("b",), Prog)
    audits = pool.audits()
    # The exchange audit read the build carrying a plan; a plan it cannot
    # read is one finding, and the advisory audit let the build be.
    assert audits["exchck"]["audited_builds"] == 1
    assert audits["exchck"]["findings"] == 1
    assert pool.stats()["exch_findings"] == 1
    # The program audit ran on the build carrying a program; Prog is no
    # program gasck can adapt, and the advisory audit let the build be.
    assert audits["gasck"]["audited_builds"] == 0
    assert len(pool) == 2
    assert audits["ir"]["requested"]
    pool.close()


def test_result_cache_lru_evicts_oldest():
    metrics.reset()
    c = ResultCache(capacity=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    st = c.stats()
    assert st["evictions"] == 1 and st["size"] == 2


def test_result_cache_evicts_by_value_bytes():
    metrics.reset()
    c = ResultCache(capacity=256, capacity_bytes=10_000)
    c.put("a", np.zeros(1024, np.float32))
    c.put("b", np.zeros(1024, np.float32))
    assert c.get("a") is not None
    c.put("c", np.zeros(1024, np.float32))
    assert c.get("b") is None
    assert c.get("a") is not None and c.get("c") is not None
    st = c.stats()
    assert st["size"] == 2 and st["bytes"] == 8192
    assert st["capacity_bytes"] == 10_000 and st["evictions"] == 1
    c.put("d", {"values": np.zeros(512, np.float32), "iters": 3})
    assert c.stats()["bytes"] >= 8192 - 4096 + 2048


def test_result_cache_oversized_entry_occupies_whole_budget():
    metrics.reset()
    c = ResultCache(capacity=4, capacity_bytes=1000)
    c.put("small", np.zeros(8, np.float32))
    c.put("huge", np.zeros(4096, np.float32))
    assert c.get("huge") is not None
    assert c.get("small") is None
    c.put("next", np.zeros(8, np.float32))
    assert c.get("huge") is None
    assert c.get("next") is not None


def test_sentinel_counts_expect_and_watch_regions():
    metrics.reset()
    s = RecompileSentinel("test-regions")
    try:
        assert s.available
        with s.expect("k1"):
            _cuda._compiled("load")
            _cuda._compiled("nvcc")
        _cuda._compiled("load")            # outside any region: ignored
        with s.watch("k1"):
            pass
        assert s.compiles() == 2 and s.compiles("k1") == 2
        assert s.recompiles() == 0
        s.assert_zero_recompiles()
        with s.expect("k2"), s.watch("k2"):
            _cuda._compiled("load")        # innermost region decides
        assert s.recompiles() == 1 and s.recompiles("k2") == 1
        with pytest.raises(RecompileError):
            s.assert_zero_recompiles()
        st = s.stats()
        assert st["per_key"] == {"k1": {"warmup": 2},
                                 "k2": {"serve": 1}}
        assert metrics.counter("lux_xla_compiles_total", {
            "scope": "test-regions", "key": "k2",
            "phase": "serve"}).value == 1
    finally:
        s.close()


def test_sentinel_regions_are_per_thread():
    s = RecompileSentinel("test-threads")
    try:
        with s.watch("main"):
            t = threading.Thread(target=_cuda._compiled, args=("load",))
            t.start()
            t.join()
        assert s.recompiles() == 0 and s.compiles() == 0
    finally:
        s.close()


def test_launch_counts_hold_under_threads(monkeypatch):
    """Serving launches kernels from several threads at once (batcher,
    swap warm, refresh): no count may be lost. A stand-in library whose
    entry point returns 0 takes the place of the card's."""
    import sys

    class Lib:
        @staticmethod
        def lux_fake():
            return 0

    monkeypatch.setattr(_cuda, "library", lambda: Lib)
    _cuda.reset_launches()
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _cuda.launch("frontier_queue", "lux_fake") for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _cuda.LAUNCHES["frontier_queue"] == n_threads * per
    _cuda.reset_launches()


# -- one served graph, both packages ---------------------------------------


def _graphs(weighted):
    g = generate.rmat(10, 16, seed=42, weighted=weighted)
    jg = jgen.rmat(10, 16, seed=42, weighted=weighted)
    np.testing.assert_array_equal(g.row_ptr, jg.row_ptr)
    np.testing.assert_array_equal(g.col_src, jg.col_src)
    return g, jg


@pytest.fixture(scope="module", params=[False, True],
                ids=["unweighted", "weighted"])
def pair(request):
    metrics.reset()
    g, jg = _graphs(request.param)
    with Session(g, _cfg(), device="cpu") as s, \
            JSession(jg, _cfg(JServeConfig)) as js:
        yield g, s, js


def test_session_serves_lux_tpu_s_apps(pair):
    _, s, js = pair
    assert s.APPS == js.APPS
    assert s._gas_rooted == js._gas_rooted
    assert s._gas_fixpoints == js._gas_fixpoints
    assert ("sssp_delta" in s.APPS) == s.graph.weighted


def _same(got, want):
    """Values bitwise with their dtype, and every other key equal
    (iterations, root, direction split, host finalisations)."""
    assert set(got) == set(want)
    assert got["values"].dtype == want["values"].dtype
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("app", ["sssp", "bfs", "sssp_delta"])
def test_session_rooted_apps_equal_lux_tpu(pair, app):
    """One root at a time (the single-lane engines), then the four
    together inside one window (the K-lane sweep)."""
    _, s, js = pair
    if app not in js.APPS:
        with pytest.raises(BadQueryError, match="unknown app"):
            s.submit(app, start=0)
        return
    for r in ROOTS[:2]:
        _same(s.query(app, start=r, timeout=60),
              js.query(app, start=r, timeout=60))
    futs = [s.submit(app, start=r) for r in ROOTS[2:]]
    jfuts = [js.submit(app, start=r) for r in ROOTS[2:]]
    for f, jf in zip(futs, jfuts):
        _same(f.result(60), jf.result(60))


@pytest.mark.parametrize("app,kw", [
    ("components", {}), ("labelprop", {}), ("kcore", {}),
    ("kcore", {"k": 3})], ids=["components", "labelprop", "kcore",
                               "kcore_k3"])
def test_session_fixpoints_equal_lux_tpu(pair, app, kw):
    _, s, js = pair
    _same(s.query(app, timeout=60, **kw), js.query(app, timeout=60, **kw))


@pytest.mark.parametrize("ni", [4, 7])
def test_session_pagerank_equals_lux_tpu(pair, ni):
    g, s, js = pair
    got = s.query("pagerank", ni=ni, timeout=60)
    want = js.query("pagerank", ni=ni, timeout=60)
    assert got["iters"] == want["iters"] == ni
    assert got["values"].dtype == want["values"].dtype
    np.testing.assert_allclose(got["values"], want["values"], rtol=5e-5,
                               atol=1e-9)
    np.testing.assert_allclose(got["values"], reference_pagerank(g, ni),
                               rtol=1e-3, atol=1e-7)


def test_session_cached_fixpoints_hit(pair):
    _, s, _ = pair
    s.query("pagerank", timeout=60)
    before = s.cache.stats()["hits"]
    s.query("pagerank", timeout=60)
    assert s.cache.stats()["hits"] == before + 1


def test_session_rejects_bad_queries(pair):
    _, s, _ = pair
    with pytest.raises(BadQueryError):
        s.submit("no_such_app")
    with pytest.raises(BadQueryError):
        s.submit("colfilter")                  # not servable
    with pytest.raises(BadQueryError):
        s.submit("sssp")                       # missing start
    with pytest.raises(BadQueryError):
        s.submit("sssp", start=10**9)          # out of range
    with pytest.raises(BadQueryError):
        s.submit("bfs", start=-1)
    with pytest.raises(BadQueryError):
        s.submit("pagerank", ni=0)
    with pytest.raises(BadQueryError):
        s.submit("kcore", k="x")


def test_session_no_rebuild_after_warmup(pair):
    _, s, _ = pair
    misses = s.pool.stats()["misses"]
    s.query("sssp", start=33, timeout=60)
    s.query("bfs", start=34, timeout=60)
    s.query("labelprop", timeout=60)
    s.query("pagerank", timeout=60)
    assert s.pool.stats()["misses"] == misses


def test_session_zero_recompiles_after_first_batch(pair):
    _, s, _ = pair
    sent = s.pool.sentinel
    s.query("sssp", start=7, timeout=60)
    for f in [s.submit("sssp", start=r) for r in (3, 4, 6)]:
        f.result(60)
    s.query("components", timeout=60)
    s.query("sssp", start=101, timeout=60)
    for f in [s.submit("sssp", start=r) for r in (102, 103, 104)]:
        f.result(60)
    s.query("pagerank", ni=5, timeout=60)
    sent.assert_zero_recompiles()
    assert s.pool.stats()["recompiles"] == 0
    # The sentinel is live in the serving region: a compile there (here
    # the library-load hook, called by hand) counts as a recompile.
    key = next(k for k in s._served_keys if k[0] == "push")
    with sent.watch(key):
        _cuda._compiled("load")
    assert s.pool.stats()["recompiles"] == 1
    assert s.statusz()["counters"]["recompiles"] == 1


def test_stats_and_statusz_say_what_is_not_ported(pair):
    _, s, _ = pair
    st, sz = s.stats(), s.statusz()
    assert st["device"] == "cpu"
    # The program audit ran over every build, and the registry's
    # programs are clean: no finding beyond what the process had.
    gas = metrics.counter("lux_gas_findings_total").value
    assert st["pool"]["gas_findings"] == gas
    assert sz["counters"]["gas_findings"] == gas
    assert sz["programs"]["gas_findings"] == gas
    assert sz["programs"]["source"] == "artifact"
    assert sz["audits"]["gasck"]["status"] == GAS_AUDIT_STATUS
    assert sz["audits"]["gasck"]["audited_builds"] == st["pool"]["misses"]
    assert sz["audits"]["exchck"]["status"] == EXCH_AUDIT_STATUS
    # One device runs full exchanges: no build carries a compact plan.
    assert sz["audits"]["exchck"]["audited_builds"] == 0
    assert st["pool"]["exch_findings"] == \
        metrics.counter("lux_exch_findings_total").value
    for name in ("exchck", "gasck"):
        assert sz["audits"][name]["requested"]
    mem = sz["memory"]
    assert mem["budget_bytes"] is None and mem["admission"]
    assert mem["reason"].startswith(NOT_PORTED)
    assert mem["device_peak_bytes"] is None
    assert sz["tune"]["armed"] is False and sz["tune"]["artifacts"] == {}
    assert sz["tune"]["cache"]["armed"] is False
    json.dumps(sz)   # the /statusz payload must serialise


# -- refusals ---------------------------------------------------------------


def test_session_refuses_the_unported_tuner(monkeypatch, tmp_path):
    """The tuner is ported: an armed LUX_TUNE_DIR serves (every app a
    counted fallback on an empty store), and what the session refuses is
    a tuneconf.v1 that exists for its key but does not load."""
    from lux_tpu_torch.obs import report
    from lux_tpu_torch.tune import artifact, tune_cache
    from lux_tpu_torch.utils.checkpoint import fingerprint_hex

    monkeypatch.setenv("LUX_TUNE_DIR", str(tmp_path))
    tune_cache().clear()
    metrics.reset()
    g = generate.gnp(50, 200, seed=1)
    with Session(g, _cfg(), device="cpu") as s:
        tb = s.statusz()["tune"]
        assert tb["armed"] and tb["artifacts"] == {}
        assert set(tb["fallbacks"]) == set(s.APPS)
    key = artifact.make_key(fingerprint_hex(g), "bfs", "gas", "1",
                            report.device_profile()["device_kind"])
    with open(artifact.artifact_path(str(tmp_path), key), "w") as f:
        f.write('{"schema": "tuneconf.v0"}')
    tune_cache().clear()
    with pytest.raises(ValueError, match="schema"):
        Session(g, device="cpu")
    tune_cache().clear()


def test_session_needs_a_card_or_the_cpu_asked_for(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = generate.gnp(50, 200, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(g, warm=False)


def test_http_main_refuses_without_a_card(monkeypatch, tmp_path):
    import torch

    from lux_tpu_torch.graph import write_lux
    from lux_tpu_torch.serve import http

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LUX_PLATFORM", raising=False)
    path = tmp_path / "g.lux"
    write_lux(str(path), generate.gnp(50, 200, seed=1))
    with pytest.raises(SystemExit, match="LUX_PLATFORM=cpu"):
        http.main(["-file", str(path), "-port", "0"])


@pytest.mark.parametrize("name", [
    "LUX_SHARD_PLAN_CACHE", "LUX_INCREMENTAL", "LUX_SNAPSHOT_WARM_TIMEOUT",
    "LUX_EDIT_QUEUE_MAX", "LUX_RESULT_CACHE_BYTES", "LUX_BREAKER_THRESHOLD",
    "LUX_BREAKER_COOLDOWN_MS", "LUX_RETRY_MAX", "LUX_RETRY_BACKOFF_MS",
    "LUX_IR_POOL_AUDIT", "LUX_EXCH_POOL_AUDIT", "LUX_GAS_POOL_AUDIT",
    "LUX_MEM_POOL_ADMIT", "LUX_SERVE_MESH", "LUX_TUNE_DIR"])
def test_serving_flags_are_lux_tpu_s(name):
    from lux_tpu.utils import flags as jflags
    from lux_tpu_torch.utils import flags as tflags

    mine, theirs = tflags._flag(name), jflags._flag(name)
    assert (mine.default, mine.kind) == (theirs.default, theirs.kind)
    if name not in ("LUX_SERVE_MESH", "LUX_TUNE_DIR"):
        assert mine.doc == theirs.doc


# -- HTTP front end -------------------------------------------------------


def _get(base, path):
    return json.loads(urllib.request.urlopen(base + path, timeout=10).read())


def _post(base, payload, timeout=60):
    req = urllib.request.Request(
        base + "/query", json.dumps(payload).encode(),
        {"Content-Type": "application/json"},
    )
    resp = urllib.request.urlopen(req, timeout=timeout)
    return json.loads(resp.read()), dict(resp.headers)


def test_http_end_to_end():
    import hashlib

    from lux_tpu_torch.serve.http import serve_in_thread

    g = generate.gnp(200, 1200, seed=301)
    gas_before = metrics.counter("lux_gas_findings_total").value
    s = Session(g, _cfg(max_batch=2, window_s=0.01, pagerank_iters=3),
                device="cpu")
    server, _ = serve_in_thread(s, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = _get(base, "/healthz")
        assert health["ok"] and health["nv"] == g.nv
        assert health["device"] == "cpu"

        want = reference_sssp(g, 5)
        out, hdr = _post(base, {"app": "sssp", "start": 5, "full": True})
        np.testing.assert_array_equal(np.asarray(out["values"], np.uint32),
                                      want)
        assert hdr["X-Lux-Snapshot"] == "0" and "X-Lux-Cost" in hdr
        out, _ = _post(base, {"app": "sssp", "start": 5, "digest": True})
        assert out["sha256"] == hashlib.sha256(
            want.dtype.str.encode() + want.tobytes()).hexdigest()
        out, _ = _post(base, {"app": "bfs", "start": 5, "targets": [0, 5]})
        assert out["values"][1] == 0 and len(out["parent"]) == 2

        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"app": "sssp"})
        assert ei.value.code == 400

        assert _get(base, "/stats")["pool"]["misses"] >= 1
        sz = _get(base, "/statusz")
        assert sz["counters"]["recompiles"] == 0
        assert sz["audits"]["gasck"]["status"] == GAS_AUDIT_STATUS
        assert sz["audits"]["gasck"]["findings"] == gas_before
        assert sz["programs"]["source"] == "artifact"
        assert _get(base, "/costz")["schema"] == "costz.v1"
        prom = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert "lux_xla_compiles_total" in prom
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base, "/nope")
        assert ei.value.code == 404
    finally:
        server.shutdown()
        s.close()
