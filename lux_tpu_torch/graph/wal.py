"""Crash-safe write-ahead log of :class:`EdgeEdits` batches (format v1);
the counterpart of ``lux_tpu/graph/wal.py``, with the same bytes on disk,
so a log written by either package replays in the other.

Snapshots live in RAM, so without a log a process crash loses every edit
applied since the base checkpoint. The WAL follows the standard database
recipe — *log the edit, fsync, only then mint the version* — so on
restart :func:`replay` reconstructs a bitwise-identical graph from the
base plus the log. The base fingerprint is
:func:`lux_tpu_torch.utils.checkpoint.fingerprint_hex`, equal to
``lux_tpu``'s for the same graph.

Format v1 (``<wal_dir>/lux.wal``)::

    LUXWAL1\\n                                  # 8-byte magic
    [u32 len][u32 crc32(payload)][payload]      # repeated frames, LE

Each payload is an uncompressed ``np.savez`` archive holding a JSON
``meta`` record plus the edit arrays. Two record kinds:

- ``edits``  — one EdgeEdits batch, chained on ``base_fp``: the
  checkpoint fingerprint of the *last committed* graph state it applies
  to. Appended (and fsync'd) by ``SnapshotStore.enqueue`` **before** any
  version is minted.
- ``commit`` — version N+1 was minted from every ``edits`` record since
  the previous commit; carries the materialized graph's fingerprint so
  replay can verify parity record-by-record.

Torn-write policy: a frame that stops at end-of-file — short header,
short payload, or CRC mismatch *on the final frame* — is a torn tail
from a crash mid-append. Both :class:`Wal` open and :func:`replay`
truncate it and carry on (the edit was never acknowledged). A CRC
mismatch anywhere *before* the final frame means the log itself rotted
and raises :class:`WalCorruptError` — silently skipping interior records
would replay a wrong graph.

Fingerprint chaining makes compaction safe: :func:`replay` skips leading
records until one chains onto the fingerprint of the graph it was given,
so a log whose prefix was folded into a newer base checkpoint (or
dropped by :meth:`Wal.compact`) still replays exactly the un-compacted
suffix.

Anchors: a store stacks version N+1 on version N's delta, so the merge
sorts all inserts into a row since the delta's anchor as one run, unless
N's pending edits passed ``LUX_DELTA_COMPACT_RATIO`` and N was
re-anchored on its merged graph first (graph/snapshot.py). The two
give the same edges in another order within a row, so :func:`replay`
rebuilds each commit on the anchor the store used (see
:func:`_refold`); ``lux_tpu``'s replay re-anchors on every commit and
refuses a log whose versions stacked on one anchor once two batches
insert into a row out of order. The records are the same either way.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from lux_tpu_torch.graph.delta import DeltaGraph, EdgeEdits
from lux_tpu_torch.graph.graph import Graph, W_DTYPE
from lux_tpu_torch.utils import checkpoint, faults, flags
from lux_tpu_torch.utils.locks import make_lock
from lux_tpu_torch.utils.logging import get_logger

MAGIC = b"LUXWAL1\n"
_FRAME = struct.Struct("<II")   # payload length, crc32(payload)

_log = get_logger("wal")


class WalCorruptError(RuntimeError):
    """The log is damaged somewhere replay cannot safely skip: a CRC or
    decode failure before the final frame, a record that does not chain
    on the preceding state, or a commit whose replayed fingerprint
    disagrees with the logged one."""


@dataclasses.dataclass(frozen=True)
class WalRecord:
    kind: str                        # "edits" | "commit"
    seq: int
    base_fp: Optional[str] = None    # edits: fingerprint chained on
    version: Optional[int] = None    # commit: version minted
    fingerprint: Optional[str] = None  # commit: fingerprint of that version
    edits: Optional[EdgeEdits] = None


@dataclasses.dataclass(frozen=True)
class RecoveryResult:
    graph: Graph            # state as of the last commit record (or base)
    version: int            # last committed WAL version (0 = none)
    fingerprint: str
    pending: Tuple[EdgeEdits, ...]   # logged but uncommitted batches
    replayed: int           # edits records folded into `graph`
    skipped: int            # already-compacted records before the anchor
    truncated: bool         # a torn tail record was dropped
    # The delta the last committed version was rebuilt as (its merged
    # graph is `graph`): a recovered store stacks the next version on it,
    # as the writer would have. None = a fresh delta over `graph`.
    delta: Optional[DeltaGraph] = None


def _pack(meta: dict, arrays: dict) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
             **arrays)
    return bio.getvalue()


def _unpack(payload: bytes) -> WalRecord:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta["kind"] == "commit":
            return WalRecord(kind="commit", seq=int(meta["seq"]),
                             version=int(meta["version"]),
                             fingerprint=meta["fingerprint"])
        edits = EdgeEdits(
            ins_src=z["ins_src"].astype(np.int64),
            ins_dst=z["ins_dst"].astype(np.int64),
            ins_w=z["ins_w"].astype(W_DTYPE) if meta["weighted"] else None,
            del_src=z["del_src"].astype(np.int64),
            del_dst=z["del_dst"].astype(np.int64),
        )
        return WalRecord(kind="edits", seq=int(meta["seq"]),
                         base_fp=meta["base_fp"], edits=edits)


def _scan(buf: bytes) -> Tuple[List[bytes], int, bool]:
    """Split ``buf`` into CRC-verified frame payloads.

    Returns ``(payloads, valid_end, torn)`` where ``valid_end`` is the
    offset just past the last intact frame. Raises WalCorruptError for
    damage anywhere before the final frame (see module docstring)."""
    if not buf.startswith(MAGIC):
        raise WalCorruptError("bad WAL magic (not a lux.wal v1 file)")
    off, n = len(MAGIC), len(buf)
    payloads: List[bytes] = []
    while off < n:
        if off + _FRAME.size > n:
            return payloads, off, True          # torn header
        ln, crc = _FRAME.unpack_from(buf, off)
        end = off + _FRAME.size + ln
        if end > n:
            return payloads, off, True          # torn payload
        payload = buf[off + _FRAME.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            if end >= n:
                return payloads, off, True      # corrupted tail == torn
            raise WalCorruptError(
                f"CRC mismatch at offset {off} before end of log")
        payloads.append(payload)
        off = end
    return payloads, off, False


def read_records(path: str) -> Tuple[List[WalRecord], bool]:
    """Decode every intact record of ``path``; torn tails are dropped
    (flag returned), interior damage raises :class:`WalCorruptError`."""
    with open(path, "rb") as f:
        buf = f.read()
    payloads, _, torn = _scan(buf)
    records = []
    for i, p in enumerate(payloads):
        try:
            records.append(_unpack(p))
        except WalCorruptError:
            raise
        except Exception as e:
            # CRC passed but the archive will not decode: the bytes we
            # wrote were bad (e.g. corruption injected pre-CRC), which no
            # amount of tail-truncation makes safe to skip.
            raise WalCorruptError(
                f"record {i} failed to decode: {e!r}") from e
    return records, torn


class Wal:
    """Append-only handle over one ``lux.wal`` file.

    Appends are serialized under ``make_lock("wal")`` and each record is
    flushed + fsync'd before :meth:`append_edits`/:meth:`append_commit`
    return — durability is the whole point. Opening an existing file
    truncates a torn tail in place (the crash-recovery contract) and
    resumes the sequence numbering.
    """

    def __init__(self, wal_dir: str, name: str = "lux.wal"):
        os.makedirs(wal_dir, exist_ok=True)
        self.path = os.path.join(wal_dir, name)
        self._lock = make_lock("wal")
        self._seq = 0
        self._records = 0
        if not os.path.exists(self.path):
            with open(self.path, "wb") as f:
                f.write(MAGIC)
                f.flush()
                os.fsync(f.fileno())
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        payloads, valid_end, torn = _scan(buf)
        if torn:
            _log.warning("wal %s: truncating torn tail (%d -> %d bytes)",
                         self.path, len(buf), valid_end)
            os.truncate(self.path, valid_end)
            self._metric("lux_wal_truncated_total").inc()
        self._records = len(payloads)
        if payloads:
            self._seq = _unpack(payloads[-1]).seq

    @staticmethod
    def _metric(name: str, labels: Optional[dict] = None):
        from lux_tpu_torch.obs import metrics
        return metrics.counter(name, labels)

    # -- appends ---------------------------------------------------------

    def append_edits(self, edits: EdgeEdits, base_fp: str) -> int:
        """Durably log one batch chained on ``base_fp``; returns its seq."""
        meta = {"kind": "edits", "seq": 0, "base_fp": base_fp,
                "weighted": edits.ins_w is not None}
        arrays = {"ins_src": edits.ins_src, "ins_dst": edits.ins_dst,
                  "del_src": edits.del_src, "del_dst": edits.del_dst,
                  "ins_w": (edits.ins_w if edits.ins_w is not None
                            else np.zeros(0, dtype=W_DTYPE))}
        return self._append("edits", meta, arrays)

    def append_commit(self, version: int, fingerprint: str) -> int:
        """Mark every edits record since the last commit as minted."""
        meta = {"kind": "commit", "seq": 0, "version": int(version),
                "fingerprint": fingerprint}
        return self._append("commit", meta, {})

    def _append(self, kind: str, meta: dict, arrays: dict) -> int:
        with self._lock:
            self._seq += 1
            meta["seq"] = self._seq
            payload = _pack(meta, arrays)
            crc = zlib.crc32(payload) & 0xFFFFFFFF
            # CRC is computed on the intended bytes *before* the fault
            # point, so an injected `corrupt` lands as a CRC-detectable
            # torn/rotted write — exactly what recovery must survive.
            payload = faults.point("wal.fsync", data=payload)
            with open(self.path, "ab") as f:
                f.write(_FRAME.pack(len(payload), crc))
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            self._records += 1
            seq = self._seq
        self._metric("lux_wal_records_total", {"kind": kind}).inc()
        self._metric("lux_wal_bytes_total").inc(
            _FRAME.size + len(payload))
        return seq

    # -- reads / maintenance ---------------------------------------------

    def records(self) -> List[WalRecord]:
        recs, _ = read_records(self.path)
        return recs

    def stats(self) -> dict:
        with self._lock:
            return {"path": self.path, "records": self._records,
                    "seq": self._seq,
                    "bytes": os.path.getsize(self.path)}

    def compact(self, upto_fingerprint: str) -> int:
        """Drop every record up to (and including) the last commit whose
        fingerprint is ``upto_fingerprint`` — callable once that state is
        durable elsewhere (e.g. a base checkpoint). Returns the number of
        records dropped. Atomic: rewrite + fsync + rename.

        Replay from that state rebuilds later versions on it as their
        anchor, so cut only at a version the store re-anchored on (one
        past ``LUX_DELTA_COMPACT_RATIO``, or the last): a later version
        stacked on an earlier anchor may order a row's inserts otherwise
        and no longer replay."""
        with self._lock:
            recs, _ = read_records(self.path)
            cut = None
            for i, r in enumerate(recs):
                if r.kind == "commit" and r.fingerprint == upto_fingerprint:
                    cut = i
            if cut is None:
                raise ValueError(
                    f"no commit record with fingerprint {upto_fingerprint!r}")
            keep = recs[cut + 1:]
            with open(self.path, "rb") as f:
                buf = f.read()
            payloads, _, _ = _scan(buf)
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(MAGIC)
                for p in payloads[cut + 1:]:
                    f.write(_FRAME.pack(len(p), zlib.crc32(p) & 0xFFFFFFFF))
                    f.write(p)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._records = len(keep)
            return cut + 1


def _refold(anchor: DeltaGraph, graph: Graph, batches: List[EdgeEdits],
            ratio: float, rec: WalRecord) -> DeltaGraph:
    """The delta of the version ``rec`` commits: ``batches`` stacked on
    the previous committed version's delta ``anchor`` (whose merged graph
    is ``graph``), or on a fresh delta over ``graph`` if the store
    re-anchored first. The store's rule, with this process's
    ``ratio``, names the one to try first; the other is tried when the
    fingerprint disagrees (a writer under another ratio, or one that
    re-anchored on every version). Raises if neither reproduces
    ``rec``'s fingerprint."""
    fresh = DeltaGraph.fresh(graph)
    if not anchor.delta_edges:
        starts = (fresh,)
    elif anchor.ratio > ratio:
        starts = (fresh, anchor)
    else:
        starts = (anchor, fresh)
    fps = []
    for delta in starts:
        for e in batches:
            delta = delta.stack(e)
        fp = checkpoint.fingerprint_hex(delta.merged())
        if fp == rec.fingerprint:
            return delta
        fps.append(fp)
    raise WalCorruptError(
        f"commit seq {rec.seq} (version {rec.version}) replays to "
        f"{fps[0][:12]}… but the log recorded {rec.fingerprint[:12]}…")


def replay(base: Graph, wal_dir: str, name: str = "lux.wal"
           ) -> RecoveryResult:
    """Reconstruct the last committed graph state from ``base`` + the log.

    Records are verified as they fold: every ``edits`` record must chain
    on the current fingerprint and every ``commit`` record's fingerprint
    must match the replayed graph bit-for-bit (the checkpoint fingerprint
    hashes the CSC arrays), each version rebuilt on the anchor its store
    stacked it on (:func:`_refold`). Leading records that predate
    ``base`` — compacted away into it — are skipped until the chain
    anchors; a log that never anchors cannot belong to this graph and
    raises."""
    path = os.path.join(wal_dir, name)
    base_fp = checkpoint.fingerprint_hex(base)
    if not os.path.exists(path):
        return RecoveryResult(graph=base, version=0, fingerprint=base_fp,
                              pending=(), replayed=0, skipped=0,
                              truncated=False, delta=DeltaGraph.fresh(base))
    records, torn = read_records(path)
    ratio = flags.get_float("LUX_DELTA_COMPACT_RATIO")
    cur_fp = base_fp
    anchor = DeltaGraph.fresh(base)
    committed, version = base, 0
    pending: List[EdgeEdits] = []
    anchored, skipped, replayed = False, 0, 0
    for r in records:
        if not anchored:
            if r.kind == "commit" and r.fingerprint == cur_fp:
                anchored, version = True, r.version
                continue
            if not (r.kind == "edits" and r.base_fp == cur_fp):
                skipped += 1
                continue
            anchored = True   # first record chaining on base: process it
        if r.kind == "edits":
            if r.base_fp != cur_fp:
                raise WalCorruptError(
                    f"edits seq {r.seq} chains on {r.base_fp[:12]}… but the "
                    f"replayed state is {cur_fp[:12]}…")
            pending.append(r.edits)
            replayed += 1
        else:
            anchor = _refold(anchor, committed, pending, ratio, r)
            committed, version, cur_fp = anchor.merged(), r.version, \
                r.fingerprint
            pending = []
    if records and not anchored:
        raise WalCorruptError(
            "log does not chain onto the given base graph "
            f"(base fingerprint {base_fp[:12]}…)")
    if replayed or pending:
        Wal._metric("lux_wal_replayed_total").inc(replayed)
    _log.info("wal replay: %d records -> version %d (%d skipped, "
              "%d pending%s)", replayed, version, skipped, len(pending),
              ", torn tail dropped" if torn else "")
    return RecoveryResult(graph=committed, version=version,
                          fingerprint=cur_fp, pending=tuple(pending),
                          replayed=replayed, skipped=skipped, truncated=torn,
                          delta=anchor)
