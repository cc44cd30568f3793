"""Port parity: delta graphs, the counting merge, the snapshot store, and
the host utilities they stand on (flags, locks, metrics, trace, spans).

The same seeded edits go through ``lux_tpu``'s and the port's
``DeltaGraph``/``SnapshotStore``; the merged graphs (``row_ptr``,
``col_src``, weights), ``removed_edges``, the ``csc_counting_merge``
outputs and the fingerprints must be byte-identical, and both must equal
a from-scratch ``Graph.from_edges`` over the surviving edges (the
comparator of tests/test_delta.py). Everything here is host numpy; no
kernel runs.
"""

import threading
import zlib

import numpy as np
import pytest

from lux_tpu.graph import DeltaGraph as JDelta
from lux_tpu.graph import EdgeEdits as JEdits
from lux_tpu.graph import SnapshotStore as JStore
from lux_tpu.graph import generate as jgen
from lux_tpu.graph.delta import removed_edges as jremoved
from lux_tpu.obs import metrics as jmetrics
from lux_tpu.ops.segment import csc_counting_merge as jmerge
from lux_tpu.utils import checkpoint as jcheckpoint
from lux_tpu.utils import flags as jflags
from lux_tpu_torch import graph as tgraph
from lux_tpu_torch.graph import DeltaGraph, EdgeEdits, Graph, SnapshotStore
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.graph.delta import _edge_keys, removed_edges
from lux_tpu_torch.obs import metrics, spans, trace
from lux_tpu_torch.ops.segment import csc_counting_merge
from lux_tpu_torch.utils import checkpoint, locks
from lux_tpu_torch.utils import flags as tflags


def _edit_lists(g, rng, n_ins, n_del, weighted=False):
    ins = [
        (int(rng.integers(g.nv)), int(rng.integers(g.nv)))
        + ((int(rng.integers(1, 10)),) if weighted else ())
        for _ in range(n_ins)
    ]
    dels = []
    if n_del:
        eidx = rng.choice(g.ne, size=min(n_del, g.ne), replace=False)
        dels = [(int(g.col_src[e]), int(g.col_dst[e])) for e in eidx]
    return ins, dels


def _naive_merge(g, ins, dels):
    """Mask deleted pairs, append sorted inserts, rebuild with
    Graph.from_edges (stable sort by dst)."""
    if dels:
        dk = np.unique(_edge_keys(
            np.array([d[0] for d in dels]), np.array([d[1] for d in dels]),
            g.nv))
        keep = ~np.isin(_edge_keys(g.col_src, g.col_dst, g.nv), dk)
    else:
        keep = np.ones(g.ne, dtype=bool)
    i_s = np.array([i[0] for i in ins], dtype=np.int64)
    i_d = np.array([i[1] for i in ins], dtype=np.int64)
    order = np.argsort(_edge_keys(i_s, i_d, g.nv), kind="stable")
    w = None
    if g.weighted:
        i_w = np.array([i[2] for i in ins], dtype=g.weights.dtype)
        w = np.concatenate([g.weights[keep], i_w[order]])
    return Graph.from_edges(
        np.concatenate([g.col_src[keep].astype(np.int64), i_s[order]]),
        np.concatenate([g.col_dst[keep].astype(np.int64), i_d[order]]),
        g.nv, weights=w,
    )


def _same_graph(a, b):
    assert a.nv == b.nv and a.ne == b.ne
    for name in ("row_ptr", "col_src"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    if a.weights is None or b.weights is None:
        assert a.weights is None and b.weights is None
    else:
        assert a.weights.dtype == b.weights.dtype
        np.testing.assert_array_equal(a.weights, b.weights)


FAMILIES = {
    "rmat": lambda m, s: m.rmat(7, 8, seed=s),
    "small_world": lambda m, s: m.small_world(256, 6, 0.1, seed=s),
    "gnp_weighted": lambda m, s: m.gnp(200, 1500, seed=s, weighted=True),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("kind", ["inserts", "deletes", "mixed", "empty"])
def test_merged_equals_lux_tpu_and_naive_rebuild(family, kind):
    """For insert-only, delete-only, mixed and empty batches: the port's
    merge, ``lux_tpu``'s and a from-scratch rebuild are byte-identical,
    and so are both packages' fingerprints and ``removed_edges``."""
    jg, g = FAMILIES[family](jgen, 3), FAMILIES[family](tgen, 3)
    _same_graph(jg, g)
    rng = np.random.default_rng(zlib.crc32(f"{family}/{kind}".encode()))
    n = max(1, g.ne // 50)
    ins, dels = _edit_lists(
        g, rng, n if kind in ("inserts", "mixed") else 0,
        n if kind in ("deletes", "mixed") else 0, weighted=g.weighted)
    ed = EdgeEdits.from_lists(insert=ins, delete=dels)
    m = DeltaGraph.fresh(g).stack(ed).merged()
    jm = JDelta.fresh(jg).stack(JEdits.from_lists(insert=ins,
                                                  delete=dels)).merged()
    _same_graph(m, jm)
    _same_graph(m, _naive_merge(g, ins, dels))
    assert checkpoint.fingerprint_hex(m) == jcheckpoint.fingerprint_hex(jm)
    got, want = removed_edges(g, ed.del_src, ed.del_dst), jremoved(
        jg, ed.del_src, ed.del_dst)
    for x, y in zip(got, want):
        if y is None:
            assert x is None
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("weighted", [False, True])
def test_csc_counting_merge_equals_lux_tpu(weighted):
    """The counting merge itself, on a random keep mask and sorted
    inserts: the same three arrays, dtypes included."""
    g = tgen.gnp(300, 2500, seed=17, weighted=weighted)
    rng = np.random.default_rng(17)
    keep = rng.random(g.ne) < 0.9
    n = 40
    src = rng.integers(0, g.nv, n).astype(np.int64)
    dst = rng.integers(0, g.nv, n).astype(np.int64)
    order = np.argsort(_edge_keys(src, dst, g.nv), kind="stable")
    src, dst = src[order], dst[order]
    w = rng.integers(1, 9, n).astype(np.int32) if weighted else None
    got = csc_counting_merge(g.row_ptr, g.col_src, g.weights, keep, dst,
                             src, w, g.nv)
    want = jmerge(g.row_ptr, g.col_src, g.weights, keep, dst, src, w, g.nv)
    for x, y in zip(got, want):
        if y is None:
            assert x is None
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_stacked_batches_equal_lux_tpu():
    """Three batches stacked in turn (a later delete dropping a pending
    insert, a re-insert after a base delete): the pending runs and the
    delete keys equal ``lux_tpu``'s at every step."""
    g, jg = tgen.rmat(7, 8, seed=9), jgen.rmat(7, 8, seed=9)
    rng = np.random.default_rng(9)
    d, jd = DeltaGraph.fresh(g), JDelta.fresh(jg)
    first_ins = None
    for step in range(3):
        ins, dels = _edit_lists(g, rng, 12, 6)
        if step == 1:
            dels.append(first_ins[0])
        if step == 2:
            ins.append(dels[0])
        first_ins = first_ins or ins
        d = d.stack(EdgeEdits.from_lists(insert=ins, delete=dels))
        jd = jd.stack(JEdits.from_lists(insert=ins, delete=dels))
        for name in ("ins_src", "ins_dst", "del_keys"):
            np.testing.assert_array_equal(getattr(d, name), getattr(jd, name))
        assert d.ratio == jd.ratio
        _same_graph(d.merged(), jd.merged())


def test_empty_delta_returns_base_identity():
    g = tgen.rmat(7, 8, seed=1)
    assert DeltaGraph.fresh(g).merged() is g


def test_delete_removes_all_parallel_copies():
    g = Graph.from_edges(np.array([0, 0, 1]), np.array([1, 1, 2]), 3)
    m = DeltaGraph.fresh(g).stack(
        EdgeEdits.from_lists(delete=[(0, 1)])).merged()
    assert m.ne == 1
    np.testing.assert_array_equal(m.col_src, [1])


def test_delete_then_reinsert_single_batch_keeps_edge():
    g = Graph.from_edges(np.array([0, 1]), np.array([1, 2]), 3)
    m = DeltaGraph.fresh(g).stack(
        EdgeEdits.from_lists(insert=[(0, 1)], delete=[(0, 1)])).merged()
    assert m.ne == 2
    assert (_edge_keys(m.col_src, m.col_dst, m.nv) == 0 + 1 * 3).sum() == 1


def test_stack_is_value_semantics():
    g = tgen.gnp(100, 600, seed=7)
    d0 = DeltaGraph.fresh(g)
    d1 = d0.stack(EdgeEdits.from_lists(insert=[(1, 2)]))
    assert d0.merged() is g
    assert d1.merged().ne == g.ne + 1


def test_edit_refusals_match_lux_tpu():
    """The same ValueErrors, with the same messages, in both packages."""
    cases = [
        (lambda m: m.gnp(50, 200, seed=3), dict(insert=[(0, 50)])),
        (lambda m: m.gnp(50, 200, seed=3, weighted=True),
         dict(insert=[(0, 1)])),
        (lambda m: m.gnp(50, 200, seed=3), dict(insert=[(0, 1, 5)])),
    ]
    for make, kw in cases:
        with pytest.raises(ValueError) as mine:
            DeltaGraph.fresh(make(tgen)).stack(EdgeEdits.from_lists(**kw))
        with pytest.raises(ValueError) as theirs:
            JDelta.fresh(make(jgen)).stack(JEdits.from_lists(**kw))
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="mixed weighted"):
        EdgeEdits.from_lists(insert=[(0, 1), (1, 2, 3)])
    g = tgen.gnp(20, 60, seed=1, weighted=True)
    ins = np.array([1], dtype=np.int64)
    with pytest.raises(ValueError):
        csc_counting_merge(g.row_ptr, g.col_src, g.weights,
                           np.ones(g.ne, dtype=bool), ins, ins, None, g.nv)


def test_removed_edges_reports_actual_copies():
    g = Graph.from_edges(np.array([0, 0, 1]), np.array([1, 1, 2]), 3)
    rs, rd, rw = removed_edges(g, np.array([0]), np.array([1]))
    assert list(rs) == [0, 0] and list(rd) == [1, 1] and rw is None
    rs, _, _ = removed_edges(g, np.array([2]), np.array([0]))   # absent
    assert rs.size == 0


def test_graph_package_exports_lux_tpu_names():
    import lux_tpu.graph as jgraph

    assert set(jgraph.__all__) <= set(tgraph.__all__)


# -- snapshot store ---------------------------------------------------------


def _apply_both(batches, ratio, monkeypatch):
    """The batches through a store of each package. Each background
    compaction is joined before the next batch: a version stacks on the
    compacted anchor or on the pending one depending on which comes
    first, and the merged graph (the order of a row's edges) with it."""
    monkeypatch.setenv("LUX_DELTA_COMPACT_RATIO", str(ratio))
    g, jg = tgen.rmat(7, 8, seed=5), jgen.rmat(7, 8, seed=5)
    st, jst = SnapshotStore(g), JStore(jg)
    for ins, dels in batches:
        st.apply(EdgeEdits.from_lists(insert=ins, delete=dels))
        jst.apply(JEdits.from_lists(insert=ins, delete=dels))
        st.drain_compactions()
        jst.drain_compactions()
    return st, jst


@pytest.mark.parametrize("ratio", [0.5, 0.0])
def test_store_versions_history_and_compaction_equal_lux_tpu(ratio,
                                                             monkeypatch):
    """The same batches through both stores: versions, history (pending
    edits, ratio, compacted past ``LUX_DELTA_COMPACT_RATIO`` or not),
    fingerprints and graphs equal at every version."""
    rng = np.random.default_rng(5)
    g = tgen.rmat(7, 8, seed=5)
    batches = [_edit_lists(g, rng, 6, 3) for _ in range(3)]
    st, jst = _apply_both(batches, ratio, monkeypatch)
    assert st.history() == jst.history()
    assert all(h["compacted"] == (ratio == 0.0 or h["version"] == 0)
               for h in st.history())
    for v in range(4):
        assert st.get(v).fingerprint == jst.get(v).fingerprint
        _same_graph(st.get(v).graph, jst.get(v).graph)
    with pytest.raises(KeyError):
        st.get(7)


def test_version_past_the_ratio_is_compacted_before_the_next(monkeypatch):
    """Without waiting for the background thread, a version past
    ``LUX_DELTA_COMPACT_RATIO`` is re-anchored before the next stacks on
    it (the next version's delta holds its own batch alone); below the
    ratio the next stacks on the same anchor. The second batch is small
    enough (4 of 1,024 edges) that no thread compacts its version."""
    g = tgen.rmat(7, 8, seed=5)
    rng = np.random.default_rng(4)
    b1 = EdgeEdits.from_lists(*_edit_lists(g, rng, 12, 6))
    b2 = EdgeEdits.from_lists(*_edit_lists(g, rng, 3, 1))
    for ratio, anchored in ((0.01, False), (0.5, True)):
        monkeypatch.setenv("LUX_DELTA_COMPACT_RATIO", str(ratio))
        st = SnapshotStore(g)
        s1 = st.apply(b1)
        s2 = st.apply(b2)
        assert s1.compact_due is not anchored and not s2.compact_due
        assert (s2.delta.base is g) is anchored
        if not anchored:
            assert s1.compacted and s2.delta.base is s1.graph
        st.drain_compactions()


def test_compaction_preserves_fingerprint_and_graph():
    g = tgen.rmat(7, 8, seed=6)
    st = SnapshotStore(g)
    s1 = st.apply(EdgeEdits.from_lists(
        insert=[(0, 1), (2, 3)],
        delete=[(int(g.col_src[0]), int(g.col_dst[0]))]))
    g1, fp1 = s1.graph, s1.fingerprint
    s1.compact()
    assert s1.compacted and s1.graph is g1 and s1.fingerprint == fp1
    assert s1.delta.delta_edges == 0
    assert s1.delta.stack(
        EdgeEdits.from_lists(insert=[(5, 6)])).merged().ne == g1.ne + 1
    st.drain_compactions()


def test_background_compaction_fires_its_callback(monkeypatch):
    monkeypatch.setenv("LUX_DELTA_COMPACT_RATIO", "0.0")
    st = SnapshotStore(tgen.gnp(100, 500, seed=9))
    fired = threading.Event()
    s1 = st.apply(EdgeEdits.from_lists(insert=[(1, 2)]),
                  on_compact=lambda s: fired.set())
    assert fired.wait(10.0), "background compaction never ran"
    st.drain_compactions()
    assert s1.compacted
    assert s1.fingerprint == checkpoint.fingerprint_hex(s1.graph)
    assert metrics.counter("lux_snapshot_compactions_total").value >= 1


# -- flags, locks, metrics, trace, spans ------------------------------------

NEW_FLAGS = ("LUX_LOCKWATCH", "LUX_LOCK_HOLD_WARN_MS",
             "LUX_DELTA_COMPACT_RATIO", "LUX_FAULTS", "LUX_FAULTS_SEED",
             "LUX_WAL_DIR", "LUX_TRACE", "LUX_SPANS")


@pytest.mark.parametrize("name", NEW_FLAGS)
def test_flags_are_lux_tpu_s(name):
    """Names, defaults, kinds and docs are ``lux_tpu``'s, but for
    ``LUX_WAL_DIR``'s doc: in ``lux_tpu`` the serving Session reads it,
    and the port, which has no Session yet, has its SnapshotStore read
    it, which its doc says."""
    mine, theirs = tflags._flag(name), jflags._flag(name)
    assert (mine.name, mine.default, mine.kind) == (
        theirs.name, theirs.default, theirs.kind)
    if name == "LUX_WAL_DIR":
        assert "Session" not in mine.doc
        assert "SnapshotStore made without a wal_dir" in mine.doc
    else:
        assert mine.doc == theirs.doc


def test_wal_dir_flag_arms_the_store(tmp_path, monkeypatch):
    """A store made without a ``wal_dir`` logs to ``LUX_WAL_DIR``, and
    ``recover`` without one replays it; "" opts out; with the flag unset
    there is no WAL and ``recover`` refuses."""
    g = tgen.rmat(7, 8, seed=5)
    rng = np.random.default_rng(3)
    ins, dels = _edit_lists(g, rng, 6, 3)
    monkeypatch.setenv("LUX_WAL_DIR", str(tmp_path))
    st = SnapshotStore(g)
    snap = st.apply(EdgeEdits.from_lists(insert=ins, delete=dels))
    assert st.wal_stats()["records"] == 2
    assert (tmp_path / "lux.wal").exists()
    head = SnapshotStore.recover(g).current()
    assert (head.version, head.fingerprint) == (1, snap.fingerprint)
    assert SnapshotStore(g, wal_dir="").wal_stats() is None
    monkeypatch.delenv("LUX_WAL_DIR")
    assert SnapshotStore(g).wal_stats() is None
    with pytest.raises(ValueError, match="LUX_WAL_DIR"):
        SnapshotStore.recover(g)
    st.drain_compactions()


def test_metrics_registry_equals_lux_tpu_s():
    """The same operations on a fresh registry of each package give the
    same snapshot and the same Prometheus text."""
    regs = [metrics.MetricsRegistry(), jmetrics.MetricsRegistry()]
    for r in regs:
        r.counter("lux_wal_records_total", {"kind": "edits"}).inc(3)
        r.gauge("lux_frontier").set(2.5)
        h = r.histogram("lux_lock_hold_seconds", {"lock": "wal"},
                        buckets=locks.LOCK_BUCKETS)
        for v in (1e-6, 3e-4, 0.2, 7.0):
            h.observe(v)
        assert r.counter("lux_wal_records_total",
                         {"kind": "edits"}) is r.counter(
            "lux_wal_records_total", {"kind": "edits"})
        with pytest.raises(TypeError):
            r.gauge("lux_wal_records_total", {"kind": "edits"})
    assert regs[0].snapshot() == regs[1].snapshot()
    assert metrics.render_prometheus(regs[0].snapshot()) == \
        jmetrics.render_prometheus(regs[1].snapshot())
    h = regs[0].histogram("lux_lock_hold_seconds", {"lock": "wal"})
    assert h.quantile(0.5) == regs[1].histogram(
        "lux_lock_hold_seconds", {"lock": "wal"}).quantile(0.5)


def test_lockwatch_sees_an_inversion(monkeypatch):
    monkeypatch.setenv("LUX_LOCKWATCH", "1")
    watch = locks.LockWatch()
    a = locks.WatchedLock("test.a", watch)
    b = locks.WatchedLock("test.b", watch)
    assert isinstance(locks.make_lock("test.c"), locks.WatchedLock)
    with a:
        with b:
            assert watch.held() == ["test.a", "test.b"]
    watch.assert_no_inversions()
    with b:
        with a:
            pass
    inv = watch.inversions()
    assert len(inv) == 1 and inv[0]["cycle"][0] == "test.b"
    with pytest.raises(AssertionError, match="inversion"):
        watch.assert_no_inversions()
    assert locks.hold_quantile("test.a", 0.5) is not None
    monkeypatch.setenv("LUX_LOCKWATCH", "0")
    assert not isinstance(locks.make_lock("test.d"), locks.WatchedLock)


def test_spans_and_trace(tmp_path, monkeypatch):
    """A root span mints a trace id that nested spans, ``adopt`` on
    another thread and the finished record share; with ``LUX_TRACE`` set
    the Chrome trace holds their B/E pairs."""
    path = tmp_path / "trace.jsonl"
    monkeypatch.setenv("LUX_TRACE", str(path))
    trace.reconfigure()
    got = []
    spans.add_sink(got.append)
    try:
        with spans.span("outer", n=1) as tid:
            with spans.span("inner") as tid2:
                assert tid2 == tid == spans.current_trace_id()
            seen = []

            def work():
                with spans.adopt(tid):
                    with spans.span("worker"):
                        seen.append(spans.current_trace_id())

            t = threading.Thread(target=work)
            t.start()
            t.join()
            assert seen == [tid]
        assert spans.current_trace_id() is None
    finally:
        spans.remove_sink(got.append)
        monkeypatch.delenv("LUX_TRACE")
        trace.reconfigure()
    (rec,) = [r for r in got if r["trace_id"] == tid]
    assert sorted(s["name"] for s in rec["spans"]) == ["inner", "outer",
                                                       "worker"]
    text = path.read_text()
    assert '"name":"outer"' in text and '"ph":"E"' in text
    assert '"lux_tpu_torch"' in text
