"""Flight recorder: bounded postmortem rings + flight.v1 dumps; the
counterpart of ``lux_tpu/obs/flight.py``, writing the same format.

When a serving process sheds a deadline (504), rejects on backpressure
(429), throws inside an engine, or receives SIGUSR1, the interesting
state is what happened *just before* — and by then the registry
histograms have averaged it away. This module keeps two bounded rings:

- the last N completed request traces (fed by obs/spans.py as a sink);
- the last N engine iteration records (fed by IterationRecorder.flush),
  so an in-flight sweep's per-iteration tail is visible even though its
  run-level summary never finalized.

``dump(reason)`` writes one self-contained ``flight.v1`` JSON to
``LUX_FLIGHT_DIR``: both rings, a metrics-registry snapshot, every
registered context block (the serve Session registers sentinel state and
pool/batcher stats), and the full LUX_* flag table of the port — everything a
postmortem needs with no access to the dead process.
``tools/flight_summary.py`` renders it.

Armed by ``LUX_FLIGHT_DIR``; unarmed, every hook is a cheap predicate.
Ring capacity is ``LUX_FLIGHT_CAPACITY``. Dumps are debounced per reason
(an overloaded server sheds thousands of deadlines per second; one dump
a second carries the same evidence). Stdlib only.
"""

from __future__ import annotations

import json
import os
import signal
import time
import itertools
from collections import deque
from typing import Callable, Dict, Optional

from lux_tpu_torch.obs import metrics, spans
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.locks import make_lock

DEBOUNCE_S = 1.0

_lock = make_lock("obs.flight")
_capacity = int(flags.default("LUX_FLIGHT_CAPACITY"))
_traces: deque = deque(maxlen=_capacity)
_iterations: deque = deque(maxlen=_capacity)
_context: Dict[str, Callable[[], dict]] = {}
_last_dump: Dict[str, float] = {}
# Filename uniqueness within one millisecond (forced back-to-back dumps).
_dump_seq = itertools.count()


def enabled() -> bool:
    return bool(flags.get("LUX_FLIGHT_DIR"))


def reconfigure():
    """Re-read LUX_FLIGHT_CAPACITY (tests and CLIs set env post-import);
    resizing keeps the newest records."""
    global _capacity, _traces, _iterations
    cap = max(1, flags.get_int("LUX_FLIGHT_CAPACITY"))
    with _lock:
        if cap != _capacity:
            _capacity = cap
            _traces = deque(_traces, maxlen=cap)
            _iterations = deque(_iterations, maxlen=cap)


def reset():
    """Drop rings and debounce state (tests)."""
    with _lock:
        _traces.clear()
        _iterations.clear()
        _last_dump.clear()


def note_trace(record: dict):
    """Spans sink: remember one completed request trace."""
    if not enabled():
        return
    with _lock:
        _traces.append(record)


def note_iteration(record: dict):
    """Remember one engine iteration record (IterationRecorder.flush)."""
    if not enabled():
        return
    with _lock:
        _iterations.append(record)


def add_context(name: str, provider: Callable[[], dict]):
    """Register a context block for every future dump (e.g. the serve
    Session's sentinel stats). Re-registering a name replaces it."""
    with _lock:
        _context[name] = provider


def remove_context(name: str):
    with _lock:
        _context.pop(name, None)


def counts() -> dict:
    with _lock:
        return {"traces": len(_traces), "iterations": len(_iterations),
                "capacity": _capacity}


def _flag_table() -> dict:
    return {name: flags.get(name) for name in flags.names()}


def dump(reason: str, detail: Optional[str] = None,
         force: bool = False) -> Optional[str]:
    """Write one flight.v1 postmortem; returns the path, or None when
    unarmed or debounced. Never raises — a postmortem failure must not
    compound the failure being recorded."""
    directory = flags.get("LUX_FLIGHT_DIR")
    if not directory:
        return None
    now = spans.monotonic()
    with _lock:
        if not force and now - _last_dump.get(reason, -DEBOUNCE_S) < DEBOUNCE_S:
            return None
        _last_dump[reason] = now
        traces = list(_traces)
        iterations = list(_iterations)
        providers = dict(_context)
    context = {}
    for name, provider in providers.items():
        try:
            context[name] = provider()
        except Exception as e:
            context[name] = {"error": repr(e)}
    doc = {
        "schema": "flight.v1",
        "reason": reason,
        "detail": detail,
        "unix_time_s": time.time(),
        "pid": os.getpid(),
        "traces": traces,
        "iterations": iterations,
        "metrics": metrics.snapshot(),
        "context": context,
        "flags": _flag_table(),
    }
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(
            directory,
            f"flight-{int(time.time() * 1e3)}-{os.getpid()}"
            f"-{next(_dump_seq):04d}-{reason}.json",
        )
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, default=str)
        return path
    except OSError:
        return None


def install_signal_handler(signum=None) -> bool:
    """SIGUSR1 -> dump("sigusr1"): postmortem-on-demand for a live
    server. Returns False where signals cannot be installed (non-main
    thread, platforms without SIGUSR1)."""
    if signum is None:
        signum = getattr(signal, "SIGUSR1", None)
        if signum is None:
            return False

    def _handler(_sig, _frame):
        dump("sigusr1", force=True)

    try:
        signal.signal(signum, _handler)
        return True
    except ValueError:
        return False


# Completed traces flow in via the spans layer; the sink gates itself on
# enabled(), so an unarmed process pays one predicate per root span.
spans.add_sink(note_trace)
