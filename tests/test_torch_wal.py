"""Port parity: the edit WAL and the fault points that test it.

A WAL written by either package must replay in the other, in both
directions, to the same version and fingerprint with the same graph and
the same re-staged batches; the same appends give the same bytes on
disk. Torn, corrupt and CRC-damaged records behave as in ``lux_tpu``,
each package driven through its own ``faults``. Follows
tests/test_wal.py; the serving session's crash test waits for the
port's serve/ (ROADMAP A13) and is made here on the store.
"""

import os
import shutil
import struct
import time

import numpy as np
import pytest

from lux_tpu.graph import DeltaGraph as JDelta
from lux_tpu.graph import EdgeEdits as JEdits
from lux_tpu.graph import generate as jgen
from lux_tpu.graph import wal as jwal
from lux_tpu.graph.snapshot import SnapshotStore as JStore
from lux_tpu.utils import faults as jfaults
from lux_tpu_torch.graph import DeltaGraph, EdgeEdits, generate
from lux_tpu_torch.graph import wal as twal
from lux_tpu_torch.graph.snapshot import SnapshotStore
from lux_tpu_torch.graph.wal import (MAGIC, RecoveryResult, Wal,
                                     WalCorruptError, read_records, replay)
from lux_tpu_torch.utils import checkpoint, faults

# package -> (generate, EdgeEdits, SnapshotStore, wal module, faults)
PKGS = {
    "port": (generate, EdgeEdits, SnapshotStore, twal, faults),
    "lux_tpu": (jgen, JEdits, JStore, jwal, jfaults),
}
OTHER = {"port": "lux_tpu", "lux_tpu": "port"}


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()


def _graph(gen=generate, seed=11):
    return gen.gnp(120, 700, seed=seed)


def _lists(g, seed, n=10):
    rng = np.random.default_rng(seed)
    ins = [(int(rng.integers(g.nv)), int(rng.integers(g.nv)))
           for _ in range(n)]
    eidx = rng.choice(g.ne, size=n // 2, replace=False)
    dels = [(int(g.col_src[e]), int(g.col_dst[e])) for e in eidx]
    return ins, dels


def _edits(g, seed, n=10, cls=EdgeEdits):
    ins, dels = _lists(g, seed, n)
    return cls.from_lists(insert=ins, delete=dels)


def _same_graph(a, b):
    assert a.nv == b.nv and a.ne == b.ne
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col_src, b.col_src)
    assert a.col_src.dtype == b.col_src.dtype


def _same_edits(a, b):
    for name in ("ins_src", "ins_dst", "del_src", "del_dst"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.ins_w is None) == (b.ins_w is None)
    if a.ins_w is not None:
        np.testing.assert_array_equal(a.ins_w, b.ins_w)


# -- the bytes on disk -------------------------------------------------------


def test_same_appends_same_bytes(tmp_path, monkeypatch):
    """Edits (plain and weighted) and commits appended by each package
    give byte-identical files. ``np.savez`` stamps each archive member
    with the wall clock, so the clock is held still."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    g = _graph()
    fp = checkpoint.fingerprint_hex(g)
    paths = []
    for pkg, mod in (("port", twal), ("lux_tpu", jwal)):
        cls = PKGS[pkg][1]
        w = mod.Wal(str(tmp_path / pkg))
        assert w.append_edits(_edits(g, 1, cls=cls), fp) == 1
        w.append_edits(cls.from_lists(insert=[(0, 1, 7), (2, 3, 9)],
                                      delete=[(4, 5)]), fp)
        assert w.append_commit(1, "f" * 64) == 3
        paths.append(w.path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        mine, theirs = a.read(), b.read()
    assert mine.startswith(MAGIC) and mine == theirs


def test_append_and_read_roundtrip(tmp_path):
    g = _graph()
    fp = checkpoint.fingerprint_hex(g)
    w = Wal(str(tmp_path))
    e = _edits(g, 1)
    assert w.append_edits(e, fp) == 1
    assert w.append_commit(1, "f" * 64) == 2
    recs, torn = read_records(w.path)
    assert not torn and [r.kind for r in recs] == ["edits", "commit"]
    assert recs[0].base_fp == fp
    _same_edits(recs[0].edits, e)
    assert recs[1].version == 1 and recs[1].fingerprint == "f" * 64
    assert w.stats()["records"] == 2
    w2 = Wal(str(tmp_path))      # reopening resumes the numbering
    assert w2.append_commit(2, "e" * 64) == 3


@pytest.mark.parametrize("writer", ["port", "lux_tpu"])
def test_records_read_across_packages(tmp_path, writer):
    """Each package reads the other's records: kinds, sequence numbers,
    chains, versions and the edit arrays (weights included)."""
    gen, cls, _, mod, _ = PKGS[writer]
    w = mod.Wal(str(tmp_path))
    e = cls.from_lists(insert=[(0, 1, 7), (2, 3, 9)], delete=[(4, 5)])
    w.append_edits(e, "a" * 64)
    w.append_commit(4, "b" * 64)
    for pkg in ("port", "lux_tpu"):
        recs, torn = PKGS[pkg][3].read_records(w.path)
        assert not torn
        assert [(r.kind, r.seq, r.base_fp, r.version, r.fingerprint)
                for r in recs] == [("edits", 1, "a" * 64, None, None),
                                   ("commit", 2, None, 4, "b" * 64)]
        _same_edits(recs[0].edits, e)


# -- replay across the packages ------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "lux_tpu"])
def test_wal_replays_in_the_other_package(tmp_path, writer, monkeypatch):
    """Two committed batches and one logged but uncommitted: the other
    package recovers the same version, fingerprint and graph, re-stages
    the batch, and its next apply mints the writer's next version.

    Each version is compacted before the next is minted, as replay
    mints them (see test_replay_of_versions_on_one_anchor_fails_alike
    for a store that stacks versions on one anchor)."""
    monkeypatch.setenv("LUX_DELTA_COMPACT_RATIO", "0.0")
    gen, cls, store_cls, _, _ = PKGS[writer]
    g = _graph(gen)
    store = store_cls(g, wal_dir=str(tmp_path))
    store.apply(_edits(g, 1, cls=cls))
    store.drain_compactions()
    store.apply(_edits(g, 2, cls=cls))
    store.drain_compactions()
    head = store.current()
    store.enqueue(_edits(g, 3, cls=cls))
    nxt = store.apply()
    store.drain_compactions()

    reader = OTHER[writer]
    rgen, rcls, rstore_cls, rmod, _ = PKGS[reader]
    # The log as it stood before the third batch was minted: cut the
    # final commit record off a copy.
    copy = tmp_path / "copy"
    copy.mkdir()
    shutil.copy(os.path.join(str(tmp_path), "lux.wal"), copy / "lux.wal")
    recs, _ = rmod.read_records(str(copy / "lux.wal"))
    last = recs[-1]
    assert last.kind == "commit" and last.version == 3
    with open(copy / "lux.wal", "rb") as f:
        buf = f.read()
    payloads, end, _ = rmod._scan(buf)
    os.truncate(copy / "lux.wal", end - len(payloads[-1]) - 8)

    rec = rstore_cls.recover(_graph(rgen), str(copy))
    rhead = rec.current()
    assert rhead.version == head.version == 2
    assert rhead.fingerprint == head.fingerprint
    _same_graph(rhead.graph, head.graph)
    assert rec.pending_edits() == 1
    _same_edits(rec.pending_batches()[0], _edits(g, 3, cls=rcls))
    snap = rec.apply()
    assert snap.version == 3 and snap.fingerprint == nxt.fingerprint
    _same_graph(snap.graph, nxt.graph)

    full = rmod.replay(_graph(rgen), str(tmp_path))
    assert full.version == 3 and full.fingerprint == nxt.fingerprint
    assert full.replayed == 3 and full.pending == () and not full.truncated


@pytest.mark.parametrize("writer", ["port", "lux_tpu"])
def test_replay_of_versions_on_one_anchor_fails_alike(tmp_path, writer):
    """Below the compaction ratio a store stacks version N+1 on the same
    delta anchor as N, so the merge puts every pending insert of a row
    in one sorted run. ``lux_tpu``'s replay re-anchors on each committed
    graph and sorts each batch's inserts after the earlier ones: once
    two batches insert into one row out of order, its replayed commit's
    fingerprint differs from the logged one and it refuses the log, from
    either package's store. The port's replay rebuilds each version on
    the anchor the store used and recovers version 3 bitwise, and its
    recovered store mints the writer's version 4."""
    gen, cls, store_cls, _, _ = PKGS[writer]
    g = _graph(gen)
    store = store_cls(g, wal_dir=str(tmp_path))
    for seed in (1, 2, 3):
        store.apply(_edits(g, seed, cls=cls))
    store.drain_compactions()
    assert [h["version"] for h in store.history()] == [0, 1, 2, 3]
    head = store.current()
    with pytest.raises(jwal.WalCorruptError,
                       match="commit seq 6 .version 3. replays"):
        jwal.replay(_graph(jgen), str(tmp_path))
    r = replay(_graph(), str(tmp_path))
    assert (r.version, r.fingerprint, r.replayed) == (
        3, head.fingerprint, 3)
    _same_graph(r.graph, head.graph)
    assert r.delta.base.ne == g.ne       # still stacked on version 0

    copy = tmp_path / "copy"
    shutil.copytree(str(tmp_path), str(copy), ignore=shutil.ignore_patterns(
        "copy"))
    nxt = store.apply(_edits(g, 4, cls=cls))
    rec = SnapshotStore.recover(_graph(), str(copy))
    mine = rec.apply(_edits(g, 4))
    assert mine.version == nxt.version == 4
    assert mine.fingerprint == nxt.fingerprint
    _same_graph(mine.graph, nxt.graph)
    store.drain_compactions()
    rec.drain_compactions()


@pytest.mark.parametrize("write_ratio,read_ratio", [("0.5", "0.0"),
                                                    ("0.0", "0.5")])
def test_replay_under_another_ratio(tmp_path, monkeypatch, write_ratio,
                                    read_ratio):
    """A log written under another ``LUX_DELTA_COMPACT_RATIO`` than the
    reader's still replays: where the anchor the reader's ratio names
    does not give the logged fingerprint, replay takes the other one.
    Written at 0.5 every version stacks on version 0; at 0.0 each is
    re-anchored on the one before (what ``lux_tpu``'s replay assumes)."""
    monkeypatch.setenv("LUX_DELTA_COMPACT_RATIO", write_ratio)
    g = _graph()
    store = SnapshotStore(g, wal_dir=str(tmp_path))
    for seed in (1, 2, 3):
        store.apply(_edits(g, seed))
    store.drain_compactions()
    head = store.current()
    monkeypatch.setenv("LUX_DELTA_COMPACT_RATIO", read_ratio)
    r = replay(_graph(), str(tmp_path))
    assert (r.version, r.fingerprint) == (3, head.fingerprint)
    _same_graph(r.graph, head.graph)
    if write_ratio == "0.0":
        jr = jwal.replay(_graph(jgen), str(tmp_path))
        assert (jr.version, jr.fingerprint) == (3, head.fingerprint)


def test_replay_no_log_returns_base(tmp_path):
    g = _graph()
    r = replay(g, str(tmp_path))
    assert isinstance(r, RecoveryResult)
    assert r.graph is g and r.version == 0 and r.pending == ()


def test_store_recovery_is_bitwise_identical(tmp_path):
    g = _graph()
    store = SnapshotStore(g, wal_dir=str(tmp_path))
    e1, e2 = _edits(g, 1), _edits(g, 2)
    store.apply(e1)
    store.apply(e2)
    head = store.current()
    expect = DeltaGraph.fresh(g).stack(e1).merged()
    expect = DeltaGraph.fresh(expect).stack(e2).merged()
    rhead = SnapshotStore.recover(_graph(), str(tmp_path)).current()
    assert rhead.version == head.version == 2
    assert rhead.fingerprint == head.fingerprint
    _same_graph(rhead.graph, expect)
    stats = store.wal_stats()
    assert stats["records"] == 4 and stats["seq"] == 4


def test_replay_wrong_base_raises(tmp_path):
    g = _graph()
    SnapshotStore(g, wal_dir=str(tmp_path)).apply(_edits(g, 1))
    with pytest.raises(WalCorruptError, match="does not chain"):
        replay(_graph(seed=99), str(tmp_path))


def test_replay_skips_compacted_prefix_and_compact(tmp_path):
    g = _graph()
    store = SnapshotStore(g, wal_dir=str(tmp_path))
    store.apply(_edits(g, 1))
    mid = store.current()
    store.apply(_edits(g, 2))
    head = store.current()
    r = replay(mid.graph, str(tmp_path))
    assert r.version == 2 and r.fingerprint == head.fingerprint
    assert r.skipped >= 1
    jr = jwal.replay(JDelta.fresh(_graph(jgen)).stack(
        _edits(g, 1, cls=JEdits)).merged(), str(tmp_path))
    assert (jr.version, jr.fingerprint, jr.skipped) == (
        r.version, r.fingerprint, r.skipped)
    assert store._wal.compact(mid.fingerprint) == 2
    r = replay(mid.graph, str(tmp_path))
    assert r.version == 2 and r.skipped == 0
    with pytest.raises(ValueError, match="no commit record"):
        store._wal.compact("0" * 64)


# -- torn, corrupt and damaged records, in both packages -----------------------


def _two_edits(mod, cls, d, g):
    w = mod.Wal(str(d))
    w.append_edits(_edits(g, 1, cls=cls), "a" * 64)
    first = os.path.getsize(w.path)
    w.append_edits(_edits(g, 2, cls=cls), "a" * 64)
    return w, first


@pytest.mark.parametrize("pkg", ["port", "lux_tpu"])
def test_torn_final_record_is_truncated(tmp_path, pkg):
    gen, cls, _, mod, _ = PKGS[pkg]
    w, first = _two_edits(mod, cls, tmp_path, _graph(gen))
    os.truncate(w.path, first + 9)
    for reader in PKGS.values():
        recs, torn = reader[3].read_records(w.path)
        assert torn and len(recs) == 1
    w2 = Wal(str(tmp_path))      # the port's open repairs either's file
    assert os.path.getsize(w2.path) == first
    w2.append_commit(1, "b" * 64)
    recs, torn = jwal.read_records(w2.path)
    assert not torn and [r.kind for r in recs] == ["edits", "commit"]


@pytest.mark.parametrize("where", ["final", "interior"])
def test_damaged_bytes_as_lux_tpu(tmp_path, where):
    """A flipped byte in the final frame is a torn tail; one in an
    earlier frame raises ``WalCorruptError``, in both readers."""
    w, first = _two_edits(twal, EdgeEdits, tmp_path, _graph())
    at = (os.path.getsize(w.path) - 1 if where == "final"
          else len(MAGIC) + struct.calcsize("<II") + 40)
    with open(w.path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))
    if where == "final":
        for reader in (twal, jwal):
            recs, torn = reader.read_records(w.path)
            assert torn and len(recs) == 1
    else:
        with pytest.raises(WalCorruptError, match="CRC mismatch"):
            read_records(w.path)
        with pytest.raises(jwal.WalCorruptError, match="CRC mismatch"):
            jwal.read_records(w.path)


@pytest.mark.parametrize("pkg", ["port", "lux_tpu"])
def test_injected_corruption_is_crc_detectable(tmp_path, pkg):
    """``wal.fsync:corrupt`` through each package's own faults: the
    damaged record fails its CRC mid-file in both readers."""
    gen, cls, _, mod, flt = PKGS[pkg]
    g = _graph(gen)
    w = mod.Wal(str(tmp_path))
    with flt.injected("wal.fsync:corrupt:1.0:1"):
        w.append_edits(_edits(g, 1, cls=cls), "a" * 64)
    w.append_commit(1, "b" * 64)
    assert flt.counts().get("wal.fsync:corrupt") >= 1
    with pytest.raises(WalCorruptError):
        read_records(w.path)
    with pytest.raises(jwal.WalCorruptError):
        jwal.read_records(w.path)


def test_bad_magic_raises(tmp_path):
    p = os.path.join(str(tmp_path), "lux.wal")
    with open(p, "wb") as f:
        f.write(b"NOTAWAL!" + b"\x00" * 32)
    with pytest.raises(WalCorruptError, match="magic"):
        read_records(p)


@pytest.mark.parametrize("at", ["edits", "commit"])
def test_crash_at_fsync_recovers_the_last_commit(tmp_path, at):
    """A crash fault at the WAL write escapes ``except Exception``; the
    recovered store is the last committed version, with the batch
    re-staged when its edits record was durable before the crash."""
    g = _graph()
    store = SnapshotStore(g, wal_dir=str(tmp_path))
    store.apply(_edits(g, 5))
    committed = store.current().fingerprint
    if at == "commit":
        store.enqueue(_edits(g, 6))
    faults.arm("wal.fsync:crash:1.0")
    with pytest.raises(faults.CrashPoint):
        store.apply(_edits(g, 6) if at == "edits" else None)
    faults.disarm()
    rec = SnapshotStore.recover(_graph(), str(tmp_path))
    assert rec.current().version == 1
    assert rec.current().fingerprint == committed
    assert rec.pending_edits() == (1 if at == "commit" else 0)
    jrec = JStore.recover(_graph(jgen), str(tmp_path))
    assert jrec.current().fingerprint == committed
    assert jrec.pending_edits() == rec.pending_edits()


# -- the fault registry ----------------------------------------------------------


def test_faults_fire_as_lux_tpu_s():
    """One spec and seed arm both registries alike: the same draws fire,
    the same fire caps hold, the same corruption comes back."""
    spec = "serve.engine.execute:raise:0.4:5,wal.fsync:corrupt:0.5"
    fired = []
    for flt in (faults, jfaults):
        flt.arm(spec, seed=7)
        seq = []
        for i in range(40):
            try:
                out = flt.point("serve.engine.execute")
                seq.append(out)
            except flt.FaultInjected as e:
                assert e.point == "serve.engine.execute"
                seq.append("raise")
            seq.append(flt.point("wal.fsync", data=b"abcdefgh" * (i + 1)))
        fired.append(seq)
        flt.disarm()
    assert fired[0] == fired[1]
    assert fired[0].count("raise") == 5
    arr = np.arange(9, dtype=np.int32)
    np.testing.assert_array_equal(faults._corrupt(arr), jfaults._corrupt(arr))
    for bad in ("nope:raise:1.0", "wal.fsync:explode:1.0",
                "wal.fsync:raise:2", "wal.fsync:delay_ms:1.0"):
        with pytest.raises(ValueError) as mine:
            faults.parse(bad)
        with pytest.raises(ValueError) as theirs:
            jfaults.parse(bad)
        assert str(mine.value) == str(theirs.value)
    assert faults.POINTS == jfaults.POINTS and faults.KINDS == jfaults.KINDS
