"""Port parity: graceful degradation in serving, the counterparts of
tests/test_robustness.py on the port: bounded retry, the circuit
breaker's lifecycle (alone and through a ``Session``), stale-while-
revalidate serving after a failed warm, the WAL-backed edit queue, and
the shed responses of the HTTP front end (``Retry-After``,
``X-Lux-Degraded``, per-code request counts). On the CPU."""

import json
import time
import urllib.error
import urllib.request

import pytest

from lux_tpu_torch.graph import EdgeEdits, generate
from lux_tpu_torch.obs import metrics
from lux_tpu_torch.serve import (CircuitBreaker, CircuitOpenError,
                                 ServeConfig, Session, SnapshotSwapError)
from lux_tpu_torch.serve.breaker import CLOSED, HALF_OPEN, OPEN
from lux_tpu_torch.serve.errors import (DeadlineExceededError, QueueFullError)
from lux_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


def _cfg(**kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("window_s", 0.001)
    kw.setdefault("pagerank_iters", 3)
    return ServeConfig(**kw)


def _graph(seed=21):
    return generate.gnp(100, 600, seed=seed)


# -- error taxonomy --------------------------------------------------------


def test_shed_errors_carry_retry_after():
    assert QueueFullError("x").retry_after_s == 1.0
    assert DeadlineExceededError("x").retry_after_s == 1.0
    assert SnapshotSwapError("x").retry_after_s == 2.0
    e = CircuitOpenError("x", retry_after_s=0.75)
    assert e.http_status == 503 and e.retry_after_s == 0.75


# -- breaker unit ----------------------------------------------------------


def test_breaker_opens_at_threshold(monkeypatch):
    monkeypatch.setenv("LUX_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("LUX_BREAKER_COOLDOWN_MS", "60000")
    br = CircuitBreaker(lambda key: True)
    key = ("sssp", "fp")
    for _ in range(2):
        br.record_failure(key, error=RuntimeError("boom"))
    br.check(key)                         # still closed
    assert br.state(key) == CLOSED
    br.record_failure(key, error=RuntimeError("boom"))
    assert br.state(key) == OPEN
    with pytest.raises(CircuitOpenError) as ei:
        br.check(key)
    assert ei.value.retry_after_s > 0
    s = br.stats()
    assert s["open"] == 1
    assert s["entries"][str(key)]["consecutive"] == 3
    assert "boom" in s["entries"][str(key)]["last_error"]


def test_breaker_success_resets_consecutive(monkeypatch):
    monkeypatch.setenv("LUX_BREAKER_THRESHOLD", "3")
    br = CircuitBreaker(lambda key: True)
    key = ("a", "b")
    br.record_failure(key)
    br.record_failure(key)
    br.record_success(key)
    br.record_failure(key)
    br.record_failure(key)
    assert br.state(key) == CLOSED        # never hit 3 in a row


def test_breaker_halfopen_probe_closes(monkeypatch):
    monkeypatch.setenv("LUX_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("LUX_BREAKER_COOLDOWN_MS", "50")
    probed = []

    def probe(key):
        probed.append(key)
        return True

    br = CircuitBreaker(probe)
    key = ("sssp", "fp")
    br.record_failure(key)
    assert br.state(key) == OPEN
    time.sleep(0.08)
    # Cooldown elapsed: this check flips to half-open, launches the
    # single-flight probe, and STILL sheds (probe hasn't reported).
    with pytest.raises(CircuitOpenError):
        br.check(key)
    br.drain_probes()
    assert probed == [key]
    assert br.state(key) == CLOSED
    br.check(key)                         # closed: no raise
    t = br.stats()["transitions"]
    assert t[OPEN] >= 1 and t[HALF_OPEN] >= 1 and t[CLOSED] >= 1


def test_breaker_failed_probe_reopens(monkeypatch):
    monkeypatch.setenv("LUX_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("LUX_BREAKER_COOLDOWN_MS", "50")
    br = CircuitBreaker(lambda key: (_ for _ in ()).throw(RuntimeError()))
    key = ("k",)
    br.record_failure(key)
    time.sleep(0.08)
    with pytest.raises(CircuitOpenError):
        br.check(key)
    br.drain_probes()
    assert br.state(key) == OPEN          # probe failed: cooldown restarts
    with pytest.raises(CircuitOpenError):
        br.check(key)


# -- session retry / breaker integration -----------------------------------


def test_transient_engine_fault_is_retried_away(monkeypatch):
    monkeypatch.setenv("LUX_RETRY_MAX", "2")
    monkeypatch.setenv("LUX_RETRY_BACKOFF_MS", "5")
    metrics.reset()
    g = _graph()
    with Session(g, _cfg(), warm=False, device="cpu") as s:
        # Exactly two injected failures: attempts 1+2 fail, attempt 3
        # answers — the client never sees the blip.
        faults.arm("serve.engine.execute:raise:1.0:2")
        out = s.query("sssp", start=3, timeout=60)
        assert out["values"].shape == (g.nv,)
        assert metrics.counter("lux_serve_retries_total",
                               {"app": "sssp"}).value == 2
        assert s.breaker.state(("sssp", s.fingerprint)) == CLOSED


def test_breaker_full_cycle_through_session(monkeypatch):
    monkeypatch.setenv("LUX_RETRY_MAX", "0")
    monkeypatch.setenv("LUX_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("LUX_BREAKER_COOLDOWN_MS", "60000")
    g = _graph()
    with Session(g, _cfg(), warm=True, device="cpu") as s:
        bkey = ("sssp", s.fingerprint)
        faults.arm("serve.engine.execute:raise:1.0")
        for start in (1, 2):              # distinct roots: no cache hits
            with pytest.raises(faults.FaultInjected):
                s.query("sssp", start=start, timeout=60)
        assert s.breaker.state(bkey) == OPEN
        # Open: shed synchronously, before the queue.
        with pytest.raises(CircuitOpenError):
            s.submit("sssp", start=3)
        assert s.statusz()["breaker"]["open"] == 1

        # Heal the engine, shrink the cooldown (flags re-read per call),
        # and let the half-open probe rebuild + prove the pool entry.
        faults.disarm()
        monkeypatch.setenv("LUX_BREAKER_COOLDOWN_MS", "1")
        time.sleep(0.01)
        with pytest.raises(CircuitOpenError):
            s.submit("sssp", start=3)
        s.breaker.drain_probes()
        assert s.breaker.state(bkey) == CLOSED
        out = s.query("sssp", start=3, timeout=60)
        assert out["values"].shape == (g.nv,)
        # Probe compiles count as expected warmup, not recompiles.
        assert s.pool.stats()["recompiles"] == 0


def test_serve_error_is_not_retried(monkeypatch):
    monkeypatch.setenv("LUX_RETRY_MAX", "3")
    metrics.reset()
    g = _graph()
    with Session(g, _cfg(), warm=False, device="cpu") as s:
        with pytest.raises(Exception, match="out of range"):
            s.query("sssp", start=10**9, timeout=60)
        assert metrics.counter("lux_serve_retries_total",
                               {"app": "sssp"}).value == 0


# -- stale-while-revalidate ------------------------------------------------


def test_failed_warm_serves_stale_then_revalidates():
    g = _graph()
    with Session(g, _cfg(), warm=False, device="cpu") as s:
        before = s.query("sssp", start=0, timeout=60)
        faults.arm("snapshot.warm:raise:1.0:1")
        with pytest.raises(SnapshotSwapError):
            s.apply_edits(EdgeEdits.from_lists(insert=[(0, 7), (1, 9)]))
        faults.disarm()
        # Version 0 still answers; the session says so.
        assert s.version == 0
        assert s.degraded is not None
        assert s.degraded["failed_version"] == 1
        again = s.query("sssp", start=0, timeout=60)
        assert again["values"].shape == before["values"].shape
        # Revalidate: the minted version is still the store head; flush
        # retries the warm WITHOUT re-applying the edits.
        out = s.flush_edits()
        assert out["version"] == 1 and s.version == 1
        assert s.degraded is None
        assert s.store.current().version == 1


def test_enqueue_coalesces_and_autoflushes(monkeypatch):
    monkeypatch.setenv("LUX_EDIT_QUEUE_MAX", "3")
    g = _graph()
    with Session(g, _cfg(), warm=False, device="cpu") as s:
        r1 = s.enqueue_edits(EdgeEdits.from_lists(insert=[(0, 5)]))
        r2 = s.enqueue_edits(EdgeEdits.from_lists(insert=[(1, 6)]))
        assert (r1["pending"], r2["pending"]) == (1, 2)
        assert s.version == 0                 # nothing swapped yet
        r3 = s.enqueue_edits(EdgeEdits.from_lists(insert=[(2, 7)]))
        # Third enqueue crossed LUX_EDIT_QUEUE_MAX: ONE swap folds all 3.
        assert r3["version"] == 1 and s.version == 1
        assert s.graph.ne == g.ne + 3
        assert s.flush_edits()["noop"] is True


# -- HTTP contract ---------------------------------------------------------


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.status, dict(r.headers), json.loads(r.read())


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_http_degraded_header_breaker_503_and_request_counts(monkeypatch):
    from lux_tpu_torch.serve.http import serve_in_thread

    monkeypatch.setenv("LUX_RETRY_MAX", "0")
    monkeypatch.setenv("LUX_BREAKER_THRESHOLD", "1")
    monkeypatch.setenv("LUX_BREAKER_COOLDOWN_MS", "60000")
    metrics.reset()
    g = _graph()
    s = Session(g, _cfg(), warm=False, device="cpu")
    server, thread = serve_in_thread(s)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        code, hdrs, body = _post(base, "/query", {"app": "sssp",
                                                  "start": 0})
        assert code == 200 and "X-Lux-Degraded" not in hdrs

        # Trip the breaker: one failure at threshold 1, then shed.
        faults.arm("serve.engine.execute:raise:1.0")
        code, hdrs, body = _post(base, "/query", {"app": "sssp",
                                                  "start": 1})
        assert code == 500 and body["kind"] == "FaultInjected"
        code, hdrs, body = _post(base, "/query", {"app": "sssp",
                                                  "start": 2})
        assert code == 503 and body["kind"] == "CircuitOpenError"
        assert float(hdrs["Retry-After"]) > 0
        # /statusz must stay JSON-serializable with rules armed (the
        # armed FaultRules are rendered as dicts, not dataclasses).
        code, _, statusz = _get(base, "/statusz")
        assert code == 200
        assert statusz["faults"]["armed"][0]["point"] == \
            "serve.engine.execute"
        assert statusz["faults"]["injected"]["serve.engine.execute:raise"] >= 1
        faults.disarm()

        # Degraded serving: a failed warm leaves the marker header on
        # every response until a later swap lands.
        faults.arm("snapshot.warm:raise:1.0:1")
        code, hdrs, body = _post(base, "/snapshot",
                                 {"insert": [[0, 9], [3, 8]]})
        assert code == 503 and body["kind"] == "SnapshotSwapError"
        assert float(hdrs["Retry-After"]) > 0
        faults.disarm()
        code, hdrs, body = _get(base, "/healthz")
        assert hdrs["X-Lux-Degraded"] == "1"
        assert hdrs["X-Lux-Snapshot"] == "0"

        code, hdrs, body = _post(base, "/snapshot", {"flush": True})
        assert code == 200 and body["version"] == 1
        code, hdrs, body = _get(base, "/healthz")
        assert "X-Lux-Degraded" not in hdrs
        assert hdrs["X-Lux-Snapshot"] == "1"

        # Every terminal response landed in the per-code counter.
        assert metrics.counter("lux_requests_total",
                               {"code": "200"}).value >= 2
        assert metrics.counter("lux_requests_total",
                               {"code": "503"}).value >= 2
        assert metrics.counter("lux_requests_total",
                               {"code": "500"}).value >= 1
    finally:
        server.shutdown()
        s.close()


def test_http_queue_true_enqueues_without_swap(monkeypatch):
    from lux_tpu_torch.serve.http import serve_in_thread

    monkeypatch.setenv("LUX_EDIT_QUEUE_MAX", "100")
    g = _graph()
    s = Session(g, _cfg(), warm=False, device="cpu")
    server, thread = serve_in_thread(s)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        code, hdrs, body = _post(base, "/snapshot",
                                 {"insert": [[0, 9]], "queue": True})
        assert code == 200 and body == {"queued": True, "pending": 1,
                                        "version": 0}
        code, hdrs, body = _post(base, "/snapshot", {"flush": True})
        assert code == 200 and body["version"] == 1
    finally:
        server.shutdown()
        s.close()
