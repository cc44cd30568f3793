"""Per-key circuit breaker for the serving engines.

Retry-with-backoff (serve/session.py) absorbs *transient* engine
failures; a persistently broken executor — poisoned compile cache, bad
device state, a plan that faults on this graph — would still eat every
request's deadline one retry loop at a time. The breaker is the standard
fix: track consecutive failures per key ``(program, fingerprint)`` and,
past ``LUX_BREAKER_THRESHOLD``, shed that program instantly with
:class:`CircuitOpenError` (HTTP 503 + ``Retry-After``) while a
background *half-open probe* rebuilds the pool entry and proves one
execution before traffic returns.

State machine (per key)::

    closed --threshold consecutive failures--> open
    open   --LUX_BREAKER_COOLDOWN_MS elapsed--> half_open (probe launched)
    half_open --probe succeeds--> closed
    half_open --probe fails----> open (cooldown restarts)

Discipline: state transitions happen only under ``make_lock("breaker")``;
the probe itself (an engine rebuild + execution) runs on a tracked
background thread *outside* the lock, so the breaker can never hold its
lock across an engine build and never takes the pool lock while
holding its own (no new lock-order edges). Probe threads are joined by
:meth:`drain_probes` (Session.close), as ``drain_compactions`` joins
the snapshot store's.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, List

from lux_tpu_torch.obs import metrics, spans
from lux_tpu_torch.serve.errors import CircuitOpenError
from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.locks import make_lock

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class _Entry:
    __slots__ = ("state", "consecutive", "opened_at", "probing", "opens",
                 "last_error")

    def __init__(self):
        self.state = CLOSED
        self.consecutive = 0
        self.opened_at = 0.0
        self.probing = False
        self.opens = 0
        self.last_error = None


class CircuitBreaker:
    """Thread-safe breaker keyed by an arbitrary hashable (the session
    keys it by ``(app, snapshot fingerprint)``).

    ``probe`` is called on a background thread with the tripped key once
    per half-open transition; it should rebuild whatever the key names
    and return True iff one execution succeeded. Threshold/cooldown are
    read from the flags registry per call, so tests and operators can
    retune a live process.
    """

    def __init__(self, probe: Callable[[Hashable], bool]):
        self._probe = probe
        self._lock = make_lock("breaker")
        self._entries: Dict[Hashable, _Entry] = {}
        self._probe_threads: List[threading.Thread] = []
        self._transitions = {
            s: metrics.counter("lux_breaker_transitions_total", {"to": s})
            for s in (OPEN, HALF_OPEN, CLOSED)
        }
        self._open_gauge = metrics.gauge("lux_breaker_open")

    @staticmethod
    def _threshold() -> int:
        return max(1, flags.get_int("LUX_BREAKER_THRESHOLD"))

    @staticmethod
    def _cooldown_s() -> float:
        return max(0.0, flags.get_float("LUX_BREAKER_COOLDOWN_MS")) / 1e3

    def _shift(self, entry: _Entry, state: str) -> None:
        # Called under self._lock.
        entry.state = state
        self._transitions[state].inc()
        tripped = self._entries.values()  # luxlint: guarded-by=_lock
        self._open_gauge.set(sum(1 for e in tripped if e.state != CLOSED))

    # -- hot path --------------------------------------------------------

    def check(self, key: Hashable) -> None:
        """Raise :class:`CircuitOpenError` while ``key`` is tripped; on
        cooldown expiry, flip to half-open and launch the single-flight
        probe (requests keep shedding until it reports back)."""
        # Lock-free fast path (one GIL-atomic dict probe per request):
        # any non-CLOSED hit is re-read under _lock before a decision.
        # luxlint: disable=LUX301 -- a stale probe only costs one retry
        entry = self._entries.get(key)
        if entry is None or entry.state == CLOSED:
            return
        now = spans.monotonic()
        cooldown = self._cooldown_s()
        launch = False
        with self._lock:
            entry = self._entries[key]
            if entry.state == CLOSED:
                return
            if (entry.state == OPEN and not entry.probing
                    and now - entry.opened_at >= cooldown):
                self._shift(entry, HALF_OPEN)
                entry.probing = True
                launch = True
            state = entry.state
            retry_after = max(0.05, entry.opened_at + cooldown - now)
        if launch:
            t = threading.Thread(target=self._run_probe, args=(key,),
                                 name="lux-breaker-probe", daemon=True)
            with self._lock:
                self._probe_threads.append(t)
            t.start()
        raise CircuitOpenError(
            f"circuit {state} for {key!r} "
            f"({self._threshold()} consecutive engine failures); "
            "background probe will close it",
            retry_after_s=round(retry_after, 3),
        )

    def record_failure(self, key: Hashable, error=None) -> None:
        """One terminal engine failure (post-retry) on ``key``."""
        with self._lock:
            entry = self._entries.setdefault(key, _Entry())
            entry.consecutive += 1
            entry.last_error = repr(error) if error is not None else None
            if (entry.state == CLOSED
                    and entry.consecutive >= self._threshold()):
                entry.opened_at = spans.monotonic()
                entry.opens += 1
                self._shift(entry, OPEN)

    def record_success(self, key: Hashable) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.consecutive = 0

    # -- probe side ------------------------------------------------------

    def _run_probe(self, key: Hashable) -> None:
        ok = False
        err = None
        with spans.span("serve.breaker_probe", key=str(key)):
            try:
                ok = bool(self._probe(key))
            except Exception as e:
                err = repr(e)
        with self._lock:
            entry = self._entries.setdefault(key, _Entry())
            entry.probing = False
            if ok:
                entry.consecutive = 0
                self._shift(entry, CLOSED)
            else:
                entry.opened_at = spans.monotonic()
                entry.last_error = err or entry.last_error
                self._shift(entry, OPEN)

    def drain_probes(self, timeout: float = 30.0) -> None:
        """Join outstanding probe threads (tests / Session.close)."""
        with self._lock:
            threads = list(self._probe_threads)
        for t in threads:
            t.join(timeout)
        with self._lock:
            self._probe_threads = [
                t for t in self._probe_threads if t.is_alive()
            ]

    # -- introspection ---------------------------------------------------

    def state(self, key: Hashable) -> str:
        with self._lock:
            entry = self._entries.get(key)
            return entry.state if entry is not None else CLOSED

    def stats(self) -> dict:
        """Per-key breaker state for /statusz and flight-recorder dumps."""
        with self._lock:
            entries = {
                str(k): {
                    "state": e.state,
                    "consecutive": e.consecutive,
                    "opens": e.opens,
                    "probing": e.probing,
                    "last_error": e.last_error,
                }
                for k, e in self._entries.items()
            }
        return {
            "threshold": self._threshold(),
            "cooldown_ms": self._cooldown_s() * 1e3,
            "open": sum(1 for e in entries.values()
                        if e["state"] != CLOSED),
            "transitions": {s: int(c.value)
                            for s, c in self._transitions.items()},
            "entries": entries,
        }
