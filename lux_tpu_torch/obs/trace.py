"""Chrome trace_event writer (JSON-lines), gated by ``LUX_TRACE=<path>``;
a copy of ``lux_tpu/obs/trace.py``.

Each line is one event object from the Trace Event Format that Perfetto
and chrome://tracing consume. We write JSON-lines rather than the
``{"traceEvents": [...]}`` envelope so a crashed run still leaves a
parseable prefix; ``lux_tpu``'s ``tools/trace_summary.py --to-chrome``
(the format is the same) wraps a file in the envelope for direct UI
loading (Perfetto's JSON importer also accepts a bare event array).

Timestamps are microseconds of ``time.perf_counter()`` since module
import, so spans recorded retrospectively from perf_counter stamps
(``pair``) land on the same clock as live ``span``/``begin``/``end``
events. Stdlib-only.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from contextlib import contextmanager

from ..utils import flags
from ..utils.locks import make_lock

_EPOCH = time.perf_counter()

_lock = make_lock("obs.trace")
_path = None
_writer = None


def _open_writer(path):
    global _path, _writer
    if _writer is not None:
        try:
            _writer.close()
        except OSError:
            pass
    _writer = None
    _path = path
    if path:
        # Line-buffered so a killed run keeps every completed event.
        _writer = open(path, "w", buffering=1)
        _emit_locked({
            "ph": "M", "name": "process_name", "pid": os.getpid(), "tid": 0,
            "args": {"name": "lux_tpu_torch"},
        })


def reconfigure():
    """Re-read ``LUX_TRACE`` (CLI flags set the env var then call this)."""
    with _lock:
        path = flags.get("LUX_TRACE") or None
        if path != _path or (path and _writer is None):
            _open_writer(path)


def enabled() -> bool:
    return _writer is not None


def _now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def _emit_locked(ev: dict):
    if _writer is not None:
        _writer.write(json.dumps(ev, separators=(",", ":")) + "\n")


def _emit(ev: dict):
    with _lock:
        _emit_locked(ev)


def _base(name, cat):
    return {
        "name": name, "cat": cat, "pid": os.getpid(),
        "tid": threading.get_ident() & 0x7FFFFFFF,
    }


def begin(name: str, cat: str = "lux", args: dict = None):
    if _writer is None:
        return
    ev = _base(name, cat)
    ev.update(ph="B", ts=_now_us())
    if args:
        ev["args"] = args
    _emit(ev)


def end(name: str, cat: str = "lux", args: dict = None):
    if _writer is None:
        return
    ev = _base(name, cat)
    ev.update(ph="E", ts=_now_us())
    if args:
        ev["args"] = args
    _emit(ev)


def pair(name: str, t0: float, t1: float, cat: str = "lux", args: dict = None):
    """Record a completed span from two ``time.perf_counter()`` stamps.

    The engines time work with perf_counter and only know the span after a
    host sync returns; this backfills matching B/E events at the stamped
    times instead of the (later) emission time.
    """
    if _writer is None:
        return
    b = _base(name, cat)
    e = dict(b)
    b.update(ph="B", ts=(t0 - _EPOCH) * 1e6)
    if args:
        b["args"] = args
    e.update(ph="E", ts=(t1 - _EPOCH) * 1e6)
    with _lock:
        _emit_locked(b)
        _emit_locked(e)


def async_begin(name: str, id_: str, cat: str = "lux", args: dict = None,
                ts: float = None):
    """Async-span start (ph "b"): events with one ``id`` form a request
    lane in Perfetto regardless of which thread emits them — the serve
    layer keys these by trace-id so one query's admission, batch, engine,
    and cache phases line up even though three threads touch it."""
    if _writer is None:
        return
    ev = _base(name, cat)
    ev.update(ph="b", id=id_, ts=_now_us() if ts is None else ts)
    if args:
        ev["args"] = args
    _emit(ev)


def async_end(name: str, id_: str, cat: str = "lux", args: dict = None,
              ts: float = None):
    """Async-span end (ph "e"); matched to its "b" by (name, cat, id)."""
    if _writer is None:
        return
    ev = _base(name, cat)
    ev.update(ph="e", id=id_, ts=_now_us() if ts is None else ts)
    if args:
        ev["args"] = args
    _emit(ev)


def async_pair(name: str, id_: str, t0: float, t1: float, cat: str = "lux",
               args: dict = None):
    """Retrospective async span from two perf_counter stamps (the
    queue-wait span is only known at dequeue)."""
    if _writer is None:
        return
    async_begin(name, id_, cat, args, ts=(t0 - _EPOCH) * 1e6)
    async_end(name, id_, cat, None, ts=(t1 - _EPOCH) * 1e6)


def counter(name: str, values: dict, cat: str = "lux", ts: float = None):
    """Counter event (ph "C"): Perfetto renders each key of ``values`` as
    a stacked track under ``name``. The engine observatory streams
    per-iteration series this way (exchange/compute seconds, frontier
    density, useful-bytes ratio); ``ts`` is an optional perf_counter
    stamp for retrospective points."""
    if _writer is None:
        return
    ev = _base(name, cat)
    ev.update(ph="C", ts=_now_us() if ts is None else (ts - _EPOCH) * 1e6,
              args={k: v for k, v in values.items()
                    if isinstance(v, (int, float))})
    _emit(ev)


def instant(name: str, cat: str = "lux", args: dict = None):
    if _writer is None:
        return
    ev = _base(name, cat)
    ev.update(ph="i", ts=_now_us(), s="t")
    if args:
        ev["args"] = args
    _emit(ev)


@contextmanager
def span(name: str, cat: str = "lux", **args):
    """Context manager emitting a B/E pair around the block (host-side
    work only — device work must be synced before exit to be credited)."""
    begin(name, cat, args or None)
    try:
        yield
    finally:
        end(name, cat)


def _close():
    with _lock:
        if _writer is not None:
            try:
                _writer.close()
            except OSError:
                pass


atexit.register(_close)

# Honor LUX_TRACE already present at import (env-var-only usage, no CLI).
reconfigure()
