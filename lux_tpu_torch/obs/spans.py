"""Request-scoped spans: one trace-id through the whole serve path; a
copy of ``lux_tpu/obs/spans.py``. In the port the snapshot store's
``enqueue``, ``apply`` and background compaction open them so far.

A query crosses three threads — the HTTP handler thread (admission,
cache probe), the batcher worker (queue-wait, batch assembly, engine
execute), and back — and whole-run telemetry (iterlog) cannot say where
*one request's* time went. This module threads a trace-id through that
path:

- ``span(name, **attrs)`` — context manager. With no ambient trace-id it
  opens a ROOT span: a fresh trace-id is minted, propagated via a
  contextvar, and the trace's record is finalized (and handed to sinks,
  e.g. the flight recorder) when the root exits. Nested spans join the
  ambient trace.
- ``adopt(trace_id)`` — continue a trace on another thread (the batcher
  worker adopts the lead request's trace-id before executing a batch).
- ``complete(name, dur_s, ...)`` — record a span retrospectively
  (queue-wait is only known at dequeue).

Every span emits three things: a sync B/E pair on its own thread lane
plus an async "b"/"e" pair keyed by trace-id in the Chrome trace
(obs/trace.py — Perfetto draws the request as one lane across threads),
and a ``lux_span_seconds{span=...}`` histogram observation.

Clock helpers live here too: ``lux_tpu``'s LUX006 bans direct
``time.*`` clock reads in serve/ and engine/ so every latency number and
span shares one clock pair — ``clock()`` (perf_counter, durations and
trace stamps) and ``monotonic()`` (deadlines, wall scheduling).

Gated by ``LUX_SPANS`` (default on); when off, ``span`` is a
pass-through and nothing is recorded. Pure stdlib.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, List, Optional

from ..utils import flags
from ..utils.locks import make_lock
from . import metrics, trace

_TRACE_ID: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "lux_trace_id", default=None
)
_seq = itertools.count(1)

_lock = make_lock("obs.spans")
# trace_id -> open trace record; bounded so an abandoned future can never
# grow this without limit (oldest open trace is dropped, not dumped).
_MAX_OPEN = 1024
_open: "OrderedDict[str, dict]" = OrderedDict()
_sinks: List[Callable[[dict], None]] = []

# Span-latency buckets: engine phases run ~10us (a fenced exchange on a
# tiny mesh) through serve phases to seconds (cold engine sweep). The
# old bounds jumped 1e-4 -> 5e-4 -> 1e-3, collapsing the sub-millisecond
# band the engine observatory lives in into three coarse buckets; the
# 2-5-10 ladder below keeps quantile interpolation within ~2.5x of truth
# down to 10us while the top decades stay serving-scale.
SPAN_BUCKETS = (
    1e-5, 2e-5, 5e-5, 1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 5.0, 30.0,
    float("inf"),
)


# -- clock discipline (the LUX006 contract) --------------------------------


def clock() -> float:
    """Duration/trace clock (perf_counter): same epoch as obs/trace.py
    stamps, so retrospective spans land where live ones do."""
    return time.perf_counter()


def monotonic() -> float:
    """Deadline/scheduling clock (monotonic): comparable across threads,
    immune to wall-clock steps."""
    return time.monotonic()


# -- trace-id plumbing -----------------------------------------------------


def enabled() -> bool:
    return flags.get_bool("LUX_SPANS")


def current_trace_id() -> Optional[str]:
    return _TRACE_ID.get()


def new_trace_id() -> str:
    return f"lux-{os.getpid():x}-{next(_seq):06x}"


def _begin_trace(tid: str) -> dict:
    rec = {
        "trace_id": tid,
        "started_unix_s": time.time(),
        "started_pc_s": clock(),
        "spans": [],
    }
    with _lock:
        _open[tid] = rec
        while len(_open) > _MAX_OPEN:
            _open.popitem(last=False)
    return rec


def _finish_trace(tid: str):
    with _lock:
        rec = _open.pop(tid, None)
        sinks = list(_sinks)
    if rec is None:
        return
    rec["finished_pc_s"] = clock()
    rec["duration_s"] = rec["finished_pc_s"] - rec["started_pc_s"]
    for fn in sinks:
        try:
            fn(rec)
        except Exception:   # a broken sink must never fail a request
            pass


def _note_span(tid, name, t0, t1, attrs):
    with _lock:
        rec = _open.get(tid)
        if rec is None:     # root already finished (late batch tail)
            return
        rec["spans"].append({
            "name": name,
            "t0_s": round(t0 - rec["started_pc_s"], 9),
            "dur_s": round(t1 - t0, 9),
            "thread": threading.current_thread().name,
            **({"attrs": attrs} if attrs else {}),
        })


def add_sink(fn: Callable[[dict], None]):
    """Register a completed-trace consumer (flight recorder)."""
    with _lock:
        if fn not in _sinks:
            _sinks.append(fn)


def remove_sink(fn: Callable[[dict], None]):
    with _lock:
        if fn in _sinks:
            _sinks.remove(fn)


# -- the span API ----------------------------------------------------------


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a phase of the current request. Root when no trace is
    ambient: mints the trace-id and finalizes the trace record on exit."""
    if not enabled():
        yield None
        return
    tid = _TRACE_ID.get()
    token = None
    root = tid is None
    if root:
        tid = new_trace_id()
        token = _TRACE_ID.set(tid)
        _begin_trace(tid)
    t0 = clock()
    trace.begin(name, cat="span", args=dict(attrs, trace_id=tid) if attrs
                else {"trace_id": tid})
    trace.async_begin(name, tid, cat="span", args=attrs or None)
    try:
        yield tid
    finally:
        t1 = clock()
        trace.async_end(name, tid, cat="span")
        trace.end(name, cat="span")
        metrics.histogram(
            "lux_span_seconds", {"span": name}, buckets=SPAN_BUCKETS
        ).observe(t1 - t0)
        _note_span(tid, name, t0, t1, attrs)
        if root:
            _TRACE_ID.reset(token)
            _finish_trace(tid)


@contextlib.contextmanager
def adopt(trace_id: Optional[str]):
    """Continue ``trace_id`` on this thread (batcher worker executing a
    request admitted elsewhere). No-op when ``trace_id`` is None; never
    finalizes the trace — the originating root (or ``open_trace``
    finisher) owns that."""
    if not enabled() or trace_id is None:
        yield
        return
    token = _TRACE_ID.set(trace_id)
    try:
        yield
    finally:
        _TRACE_ID.reset(token)


def complete(name: str, dur_s: float, end: Optional[float] = None,
             trace_id: Optional[str] = None, **attrs):
    """Record a span retrospectively: it ended at ``end`` (perf_counter
    stamp; default now) and lasted ``dur_s``."""
    if not enabled():
        return
    tid = trace_id if trace_id is not None else _TRACE_ID.get()
    t1 = clock() if end is None else end
    t0 = t1 - max(0.0, dur_s)
    if tid is not None:
        trace.async_pair(name, tid, t0, t1, cat="span", args=attrs or None)
    trace.pair(name, t0, t1, cat="span", args=attrs or None)
    metrics.histogram(
        "lux_span_seconds", {"span": name}, buckets=SPAN_BUCKETS
    ).observe(t1 - t0)
    if tid is not None:
        _note_span(tid, name, t0, t1, attrs)


def open_trace():
    """Explicitly opened trace for callers that cannot scope the request
    in one ``with`` block (Session.submit returns a Future): returns
    ``(trace_id, finish)``; call ``finish()`` when the request resolves.
    Finishing twice (or racing a dropped record) is a no-op."""
    if not enabled():
        return None, lambda: None
    tid = new_trace_id()
    _begin_trace(tid)
    return tid, lambda: _finish_trace(tid)


def activate(trace_id: Optional[str]):
    """Set the ambient trace-id; returns a token for ``deactivate``."""
    return _TRACE_ID.set(trace_id)


def deactivate(token):
    _TRACE_ID.reset(token)
