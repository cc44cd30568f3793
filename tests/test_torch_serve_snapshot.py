"""Port parity: the serving hot swap (``Session.apply_edits``).

The counterparts of tests/test_snapshot_serve.py on R-MAT 10: the swap
flips the version and serves the edited graph; it evicts the old
version's cache and retires its engines; the incremental refresh leaves
cached SSSP roots and components bitwise equal to from-scratch runs and
to ``lux_tpu``'s refresh of the same cache (same fingerprints, same
summaries); ``LUX_INCREMENTAL=0`` evicts only; a warm timeout aborts the
swap while the old version keeps serving; in-flight queries survive the
swap with zero recompiles; bad edits are refused; the HTTP snapshot
endpoints work.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from lux_tpu.graph import EdgeEdits as JEdits
from lux_tpu.graph import generate as jgen
from lux_tpu.serve import ServeConfig as JServeConfig
from lux_tpu.serve import Session as JSession
from lux_tpu_torch.graph import DeltaGraph, EdgeEdits, generate
from lux_tpu_torch.models.components import reference_components
from lux_tpu_torch.models.sssp import reference_sssp
from lux_tpu_torch.obs import metrics
from lux_tpu_torch.serve import (BadQueryError, ServeConfig, Session,
                                 SnapshotSwapError)


def _cfg(cls=ServeConfig, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("window_s", 0.01)
    kw.setdefault("max_queue", 64)
    kw.setdefault("pagerank_iters", 4)
    return cls(**kw)


def _rmat(m, seed):
    return m.rmat(10, 16, seed=seed)


def _edit_lists(g, seed, n):
    rng = np.random.default_rng(seed)
    ins = [(int(rng.integers(g.nv)), int(rng.integers(g.nv)))
           for _ in range(n)]
    eidx = rng.choice(g.ne, size=n, replace=False)
    dels = [(int(g.col_src[e]), int(g.col_dst[e])) for e in eidx]
    return ins, dels


def _edits(g, seed, n, cls=EdgeEdits):
    ins, dels = _edit_lists(g, seed, n)
    return cls.from_lists(insert=ins, delete=dels)


def _session(g, **kw):
    return Session(g, _cfg(**kw), device="cpu")


def test_apply_edits_flips_version_and_serves_new_graph():
    metrics.reset()
    g = _rmat(generate, 401)
    with _session(g) as s:
        assert s.version == 0
        base_fp = s.fingerprint
        s.query("sssp", start=3, timeout=60)
        ed = _edits(g, 402, 15)
        summary = s.apply_edits(ed)
        assert (s.version, summary["version"]) == (1, 1)
        assert summary["old_fingerprint"] == base_fp
        assert s.fingerprint == summary["fingerprint"] != base_fp
        for k in ("apply_s", "warm_s", "refresh_s", "flip_s", "swap_s"):
            assert summary[k] >= 0.0
        new_g = DeltaGraph.fresh(g).stack(ed).merged()
        assert s.graph.ne == new_g.ne == summary["ne"]
        out = s.query("sssp", start=3, timeout=60)
        np.testing.assert_array_equal(out["values"],
                                      reference_sssp(new_g, 3))
        info = s.snapshot_info()
        assert info["version"] == 1
        assert [h["version"] for h in info["history"]] == [0, 1]
        assert s.stats()["snapshot"]["version"] == 1
        assert metrics.counter("lux_snapshot_applies_total").value == 1


def test_swap_evicts_old_cache_and_retires_old_engines():
    metrics.reset()
    g = _rmat(generate, 403)
    with _session(g) as s:
        old_fp = s.fingerprint
        s.query("sssp", start=1, timeout=60)
        s.query("components", timeout=60)
        s.query("pagerank", timeout=60)
        engines_before = s.pool.stats()["engines"]
        summary = s.apply_edits(_edits(g, 404, 10))
        assert summary["evicted"] >= 3   # sssp + components + pagerank
        assert summary["retired"] == engines_before  # all v0 engines
        assert not any(
            isinstance(k, tuple) and len(k) > 1 and k[0] == old_fp
            for k in s.cache.keys()
        )
        assert not any(k[1] == old_fp for k in s.pool.keys())
        assert s.pool.stats()["retired"] == engines_before
        assert s.cache.stats()["invalidations"] == summary["evicted"]


def test_incremental_refresh_equals_scratch_and_lux_tpu():
    """With LUX_INCREMENTAL the swap re-populates cached SSSP roots and
    components under the new fingerprint from warm starts: the answers
    right after the swap are cache hits, bitwise equal to from-scratch
    runs and to ``lux_tpu``'s refreshed cache."""
    metrics.reset()
    g, jg = _rmat(generate, 405), _rmat(jgen, 405)
    roots = [2, 9, 55]
    with _session(g) as s, JSession(jg, _cfg(JServeConfig)) as js:
        for sess in (s, js):
            for r in roots:
                sess.query("sssp", start=r, timeout=60)
            sess.query("components", timeout=60)
        summary = s.apply_edits(_edits(g, 406, 10))
        jsummary = js.apply_edits(_edits(jg, 406, 10, JEdits))
        assert summary["refreshed"]["sssp"] == len(roots)
        assert summary["refreshed"]["components"] == 1
        assert summary["refreshed"] == jsummary["refreshed"]
        for k in ("version", "fingerprint", "old_fingerprint", "nv", "ne",
                  "evicted", "retired"):
            assert summary[k] == jsummary[k], k
        new_g = s.graph
        hits_before = s.cache.stats()["hits"]
        for r in roots:
            out = s.query("sssp", start=r, timeout=60)
            want = js.query("sssp", start=r, timeout=60)
            assert out["incremental"] is want["incremental"] is True
            assert out["iters"] == want["iters"]
            np.testing.assert_array_equal(out["values"], want["values"])
            np.testing.assert_array_equal(out["values"],
                                          reference_sssp(new_g, r))
        assert s.cache.stats()["hits"] == hits_before + len(roots)
        out = s.query("components", timeout=60)
        want = js.query("components", timeout=60)
        assert out["incremental"] is True and out["iters"] == want["iters"]
        np.testing.assert_array_equal(out["values"], want["values"])
        scratch, _ = s._components_engine().run()
        np.testing.assert_array_equal(
            out["values"], s._components_engine().values(scratch))


def test_incremental_refresh_components_on_the_closure():
    g = generate.undirected(_rmat(generate, 407))
    with _session(g) as s:
        s.query("components", timeout=60)
        ins, dels = _edit_lists(g, 408, 8)
        ins = [p for (u, v) in ins for p in ((u, v), (v, u))]
        dels = [p for (u, v) in dels for p in ((u, v), (v, u))]
        summary = s.apply_edits(EdgeEdits.from_lists(insert=ins,
                                                     delete=dels))
        assert summary["refreshed"]["components"] == 1
        out = s.query("components", timeout=60)
        np.testing.assert_array_equal(out["values"],
                                      reference_components(s.graph))


def test_lux_incremental_off_is_evict_only(monkeypatch):
    monkeypatch.setenv("LUX_INCREMENTAL", "0")
    metrics.reset()
    g = _rmat(generate, 409)
    with _session(g) as s:
        s.query("sssp", start=5, timeout=60)
        summary = s.apply_edits(_edits(g, 410, 5))
        assert summary["refreshed"] is None
        assert summary["evicted"] >= 1
        out = s.query("sssp", start=5, timeout=60)
        assert "incremental" not in out
        np.testing.assert_array_equal(out["values"],
                                      reference_sssp(s.graph, 5))


def test_warm_timeout_aborts_swap_and_old_version_keeps_serving(
        monkeypatch):
    metrics.reset()
    g = _rmat(generate, 411)
    with _session(g) as s:
        fp0 = s.fingerprint
        stall = threading.Event()
        real_warmup = s.warmup

        def slow_warmup(snap=None):
            if snap is not None and snap.version > 0:
                stall.wait(5)   # longer than warm_timeout below
            return real_warmup(snap)

        monkeypatch.setattr(s, "warmup", slow_warmup)
        with pytest.raises(SnapshotSwapError, match="still serving"):
            s.apply_edits(_edits(g, 412, 5), warm_timeout=0.05)
        stall.set()
        assert s.version == 0 and s.fingerprint == fp0
        assert s.degraded["failed_version"] == 1
        assert metrics.counter("lux_snapshot_aborts_total").value == 1
        out = s.query("sssp", start=2, timeout=60)   # v0 still serves
        np.testing.assert_array_equal(out["values"], reference_sssp(g, 2))
        # Revalidate: the minted version is the store head; a flush
        # re-warms and flips onto it.
        summary = s.flush_edits()
        assert summary["version"] == 1 and s.degraded is None


def test_in_flight_queries_survive_swap_zero_recompiles():
    """Queries admitted before/during the swap all succeed, each bound
    to exactly one snapshot: its answer is version N's or N+1's, and a
    thread that has seen N+1's never sees N's again."""
    metrics.reset()
    g = _rmat(generate, 413)
    with _session(g, window_s=0.05) as s:
        sent = s.pool.sentinel
        s.query("sssp", start=0, timeout=60)
        for f in [s.submit("sssp", start=r) for r in (1, 2, 3, 4)]:
            f.result(60)
        ed = _edits(g, 414, 10)
        new_g = DeltaGraph.fresh(g).stack(ed).merged()
        want = {v: {r: reference_sssp(gr, r) for r in range(40)}
                for v, gr in ((0, g), (1, new_g))}

        errors, stop = [], threading.Event()

        def pound(t):
            i, seen = t, 0
            while not stop.is_set():
                r = i % 40
                try:
                    out = s.query("sssp", start=r, timeout=60)
                    got = [v for v in (0, 1)
                           if np.array_equal(out["values"], want[v][r])]
                    if not got or got[-1] < seen:
                        errors.append((r, got, seen))
                    seen = max(seen, got[0]) if got else seen
                except Exception as e:   # any failure fails the test
                    errors.append(e)
                i += 3

        threads = [threading.Thread(target=pound, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        summary = s.apply_edits(ed)
        for f in [s.submit("sssp", start=r) for r in (5, 6, 7, 8)]:
            f.result(60)
        stop.set()
        for t in threads:
            t.join(30)
        assert not errors, errors[:3]
        assert summary["version"] == 1
        out = s.query("sssp", start=9, timeout=60)
        np.testing.assert_array_equal(out["values"], want[1][9])
        sent.assert_zero_recompiles()
        assert s.pool.stats()["recompiles"] == 0


def test_apply_edits_validates_input():
    g = generate.gnp(100, 500, seed=413)
    with _session(g) as s:
        with pytest.raises(BadQueryError, match="EdgeEdits"):
            s.apply_edits([(0, 1)])
        with pytest.raises(BadQueryError, match="vertex ids outside"):
            s.apply_edits(EdgeEdits.from_lists(insert=[(0, g.nv)]))
        with pytest.raises(BadQueryError, match="EdgeEdits"):
            s.enqueue_edits("nope")
        assert s.version == 0


def test_enqueue_then_flush_folds_one_swap(monkeypatch):
    monkeypatch.setenv("LUX_EDIT_QUEUE_MAX", "8")
    g = _rmat(generate, 415)
    with _session(g) as s:
        a, b = _edits(g, 416, 4), _edits(g, 417, 4)
        assert s.enqueue_edits(a)["pending"] == 1
        assert s.enqueue_edits(b)["pending"] == 2
        assert s.version == 0
        summary = s.flush_edits()
        assert summary["version"] == 1 and summary["refreshed"] is None
        new_g = DeltaGraph.fresh(g).stack(a).stack(b).merged()
        assert s.graph.ne == new_g.ne
        assert s.flush_edits()["noop"] is True


# -- HTTP front end -------------------------------------------------------


def _post(base, path, payload, timeout=60):
    req = urllib.request.Request(
        base + path, json.dumps(payload).encode(),
        {"Content-Type": "application/json"},
    )
    resp = urllib.request.urlopen(req, timeout=timeout)
    return json.loads(resp.read()), dict(resp.headers)


def test_http_snapshot_endpoints_and_header():
    from lux_tpu_torch.serve.http import serve_in_thread

    g = generate.gnp(200, 1200, seed=415)
    s = _session(g, max_batch=2)
    server, _ = serve_in_thread(s, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        out, hdr = _post(base, "/query",
                         {"app": "sssp", "start": 5, "full": True})
        assert hdr["X-Lux-Snapshot"] == "0"
        np.testing.assert_array_equal(
            np.asarray(out["values"], np.uint32), reference_sssp(g, 5))

        resp = urllib.request.urlopen(base + "/snapshot", timeout=10)
        info = json.loads(resp.read())
        assert info["version"] == 0 and info["ne"] == g.ne

        rng = np.random.default_rng(416)
        ins = [[int(rng.integers(g.nv)), int(rng.integers(g.nv))]
               for _ in range(8)]
        dels = [[int(g.col_src[e]), int(g.col_dst[e])]
                for e in rng.choice(g.ne, size=8, replace=False)]
        summary, hdr = _post(base, "/snapshot",
                             {"insert": ins, "delete": dels})
        assert summary["version"] == 1
        assert hdr["X-Lux-Snapshot"] == "1"

        new_g = DeltaGraph.fresh(g).stack(
            EdgeEdits.from_lists(
                insert=[tuple(p) for p in ins],
                delete=[tuple(p) for p in dels])).merged()
        out, hdr = _post(base, "/query",
                         {"app": "sssp", "start": 5, "full": True})
        assert hdr["X-Lux-Snapshot"] == "1"
        np.testing.assert_array_equal(
            np.asarray(out["values"], np.uint32),
            reference_sssp(new_g, 5))

        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/snapshot", {"insert": [[0, g.nv + 7]]})
        assert ei.value.code == 400
        queued, _ = _post(base, "/snapshot",
                          {"insert": [[1, 2]], "queue": True})
        assert queued["queued"] and queued["pending"] == 1
        flushed, hdr = _post(base, "/snapshot", {"flush": True})
        assert flushed["version"] == 2 and hdr["X-Lux-Snapshot"] == "2"
        assert json.loads(urllib.request.urlopen(
            base + "/snapshot", timeout=10).read())["version"] == 2
    finally:
        server.shutdown()
        s.close()
