"""Run ledger: durable, append-only ``runrec.v1`` observations; the
counterpart of ``lux_tpu/obs/ledger.py``, with the same bytes on disk,
so a ledger directory written by either package reads in the other.

Every other obs surface is ephemeral — engobs tables, the metrics
registry, flight rings all go with the process. The ledger is the
durable side: when ``LUX_LEDGER_DIR`` is set, every engine run (via
report.finalize) appends ONE JSON line keyed by

    (graph_fingerprint, program, engine_kind, mesh_shape, config_hash)

where ``config_hash`` comes from :func:`flags.config_hash`, the port's
own behaviour flags. A record is therefore a reproducible (config ->
metrics) observation.

Storage follows the WAL idiom (graph/wal.py), line-oriented so
concurrent ``O_APPEND`` writers interleave safely at line granularity:

    LUXRR1 <crc32-hex8> <json>\\n

- Segments are ``runrec-NNNNNN.jsonl`` under the ledger dir; a segment
  at or past ``LUX_LEDGER_ROTATE_BYTES`` is sealed and the next number
  opens.
- Reopen-for-append validates the tail: a torn FINAL line (missing
  newline, bad frame, or bad CRC — the crash-mid-write shapes) is
  truncated away; an interior bad line is real corruption and raises on
  strict reads (lenient reads skip and count it).
- ``latest.json`` (atomic temp+rename) maps each key string to its most
  recent record id — a best-effort index, always rebuildable by
  scanning the segments.

Unarmed (no ``LUX_LEDGER_DIR``), :func:`record_run` is a None return
and no file is ever touched — the zero-cost default.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.locks import make_lock

__all__ = [
    "LedgerCorruptError", "RunLedger", "enabled", "record_run",
    "read_all", "validate_dir", "key_string", "reset",
]

SCHEMA = "runrec.v1"
_PREFIX = "LUXRR1"
_SEG_FMT = "runrec-{:06d}.jsonl"
_INDEX = "latest.json"


class LedgerCorruptError(RuntimeError):
    """An interior (non-tail) ledger line failed its CRC frame."""


def enabled() -> bool:
    return bool(flags.get("LUX_LEDGER_DIR"))


def key_string(graph_fingerprint: str, program: str, engine_kind: str,
               mesh_shape: str, config_hash: str) -> str:
    return "|".join(
        (graph_fingerprint, program, engine_kind, mesh_shape, config_hash)
    )


def _frame(payload: bytes) -> bytes:
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return b"%s %08x %s\n" % (_PREFIX.encode(), crc, payload)


def _parse_line(line: bytes) -> Optional[dict]:
    """Decode one framed line; None when the frame or CRC is bad."""
    parts = line.split(b" ", 2)
    if len(parts) != 3 or parts[0] != _PREFIX.encode():
        return None
    try:
        want = int(parts[1], 16)
    except ValueError:
        return None
    if (zlib.crc32(parts[2]) & 0xFFFFFFFF) != want:
        return None
    try:
        return json.loads(parts[2])
    except ValueError:
        return None


def _scan_segment(path: str) -> Tuple[List[dict], int, int, bool]:
    """(records, keep_end_offset, interior_bad, torn_tail).

    ``torn_tail`` covers the crash-mid-append shapes — a final chunk
    with no newline, or a CRC-bad FINAL complete line — both
    recoverable by truncating to ``keep_end_offset``. ``interior_bad``
    counts CRC-bad lines that valid lines FOLLOW: real corruption, not
    a torn write, so repair never truncates it away.
    """
    with open(path, "rb") as f:
        buf = f.read()
    parsed: List[Tuple[int, Optional[dict]]] = []   # (end_offset, record)
    pos = 0
    torn = False
    while pos < len(buf):
        nl = buf.find(b"\n", pos)
        if nl < 0:
            torn = True                  # no newline: torn tail
            break
        parsed.append((nl + 1, _parse_line(buf[pos:nl])))
        pos = nl + 1
    if parsed and not torn and parsed[-1][1] is None:
        torn = True                      # bad final line: torn, drop it
        parsed.pop()
    records = [r for _end, r in parsed if r is not None]
    interior_bad = sum(1 for _end, r in parsed if r is None)
    keep_end = parsed[-1][0] if parsed else 0
    return records, keep_end, interior_bad, torn


class RunLedger:
    """Append/read handle on one ledger directory. Thread-safe within
    the process; cross-process appends stay line-atomic via O_APPEND."""

    def __init__(self, root: str):
        self.root = root
        self._lock = make_lock("obs.ledger")
        self._seq = 0
        os.makedirs(root, exist_ok=True)

    # -- segment bookkeeping ------------------------------------------

    def segments(self) -> List[str]:
        try:
            names = sorted(
                n for n in os.listdir(self.root)
                if n.startswith("runrec-") and n.endswith(".jsonl")
            )
        except OSError:
            return []
        return [os.path.join(self.root, n) for n in names]

    def _active_segment(self) -> str:
        segs = self.segments()
        rotate = flags.get_int("LUX_LEDGER_ROTATE_BYTES")
        if segs:
            last = segs[-1]
            try:
                if os.path.getsize(last) < rotate:
                    return last
            except OSError:
                pass
            num = int(os.path.basename(last)[7:13]) + 1
        else:
            num = 0
        return os.path.join(self.root, _SEG_FMT.format(num))

    def _repair_tail(self, path: str):
        """WAL reopen policy: truncate a torn final line before the
        next append lands after it (interior corruption is left for
        readers to report — truncating it would silently drop records
        that valid later lines prove were once durable)."""
        if not os.path.exists(path):
            return
        _records, keep_end, interior_bad, torn = _scan_segment(path)
        if torn and interior_bad == 0:
            size = os.path.getsize(path)
            if keep_end < size:
                with open(path, "r+b") as f:
                    f.truncate(keep_end)

    # -- append / read ------------------------------------------------

    def append(self, record: dict) -> str:
        with self._lock:
            rid = record.get("id")
            if not rid:
                self._seq += 1
                rid = "rr-%x-%06x-%x" % (
                    os.getpid(), self._seq, int(time.time()) & 0xFFFFFF
                )
                record = dict(record, id=rid)
            path = self._active_segment()
            self._repair_tail(path)
            payload = json.dumps(
                record, sort_keys=True, separators=(",", ":")
            ).encode("utf-8")
            with open(path, "ab") as f:
                f.write(_frame(payload))   # one write: line-atomic
                f.flush()
                os.fsync(f.fileno())
            key = record.get("key_string")
            if key:
                self._update_index(key, rid, os.path.basename(path))
            return rid

    def _update_index(self, key: str, rid: str, segment: str):
        idx_path = os.path.join(self.root, _INDEX)
        idx = self.read_index()
        idx[key] = {"record_id": rid, "segment": segment}
        tmp = idx_path + ".tmp.%d" % os.getpid()
        try:
            with open(tmp, "w") as f:
                json.dump(idx, f, indent=1, sort_keys=True)
            os.replace(tmp, idx_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def read_index(self) -> Dict[str, dict]:
        try:
            with open(os.path.join(self.root, _INDEX)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def latest(self, key: str) -> Optional[dict]:
        """Most recent record for a key string (index fast path, full
        scan fallback — the index is best-effort)."""
        ref = self.read_index().get(key)
        hit = None
        for rec in self.iter_records():
            if rec.get("key_string") == key:
                if ref and rec.get("id") == ref.get("record_id"):
                    return rec
                hit = rec
        return hit

    def iter_records(self, strict: bool = False) -> Iterator[dict]:
        for path in self.segments():
            records, _end, interior_bad, _torn = _scan_segment(path)
            if interior_bad and strict:
                raise LedgerCorruptError(
                    f"{path}: {interior_bad} interior crc-bad line(s)"
                )
            for rec in records:
                yield rec

    def read(self, strict: bool = False) -> List[dict]:
        return list(self.iter_records(strict=strict))

    def validate(self) -> Dict[str, int]:
        """(ok, interior_bad, torn) counts across all segments."""
        ok = bad = torn_n = 0
        for path in self.segments():
            records, _end, interior_bad, torn = _scan_segment(path)
            ok += len(records)
            bad += interior_bad
            torn_n += 1 if torn else 0
        return {"ok": ok, "interior_bad": bad, "torn_segments": torn_n,
                "segments": len(self.segments())}


# -- module-level singleton (the armed ledger) ------------------------

_LEDGER: Optional[RunLedger] = None
_LOCK = make_lock("obs.ledger.singleton")


def _ledger() -> Optional[RunLedger]:
    global _LEDGER
    root = flags.get("LUX_LEDGER_DIR")
    if not root:
        return None
    with _LOCK:
        if _LEDGER is None or _LEDGER.root != root:
            _LEDGER = RunLedger(root)
        return _LEDGER


def reset():
    """Drop the cached handle (tests repoint LUX_LEDGER_DIR)."""
    global _LEDGER
    with _LOCK:
        _LEDGER = None


def record_run(kind: str, metrics: dict, *,
               graph_fingerprint: Optional[str] = None,
               program: str = "?", engine_kind: str = "?",
               mesh_shape: str = "1", **extra) -> Optional[str]:
    """Append one runrec.v1 observation; None when unarmed.

    ``graph_fingerprint`` defaults to a weak nv/ne-derived key when the
    caller only has a run summary (engine feed-in via report.finalize);
    serve/bench paths pass the real checkpoint.fingerprint_hex.
    """
    led = _ledger()
    if led is None:
        return None
    if graph_fingerprint is None:
        graph_fingerprint = "nv%s-ne%s" % (
            metrics.get("nv", "?"), metrics.get("ne", "?")
        )
    chash = flags.config_hash()
    key = key_string(graph_fingerprint, program, engine_kind,
                     str(mesh_shape), chash)
    record = {
        "schema": SCHEMA,
        "kind": kind,
        "at": time.time(),
        "key": {
            "graph_fingerprint": graph_fingerprint,
            "program": program,
            "engine_kind": engine_kind,
            "mesh_shape": str(mesh_shape),
            "config_hash": chash,
        },
        "key_string": key,
        "config": flags.snapshot(),
        "metrics": metrics,
    }
    if extra:
        record.update(extra)
    try:
        return led.append(record)
    except OSError:
        return None      # a full disk must never fail the run it logs


def read_all(root: Optional[str] = None, strict: bool = False) -> List[dict]:
    """All records under ``root`` (default: the armed dir); [] unarmed."""
    if root:
        return RunLedger(root).read(strict=strict)
    led = _ledger()
    return led.read(strict=strict) if led else []


def validate_dir(root: str) -> Dict[str, int]:
    return RunLedger(root).validate()
