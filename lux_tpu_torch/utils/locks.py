"""Named locks + the LockWatch runtime sentinel, a copy of
``lux_tpu/utils/locks.py``.

Every lock in the graph and obs layers is built through
:func:`make_lock` so it carries a stable name. Normally that is all the
factory does — it returns a bare ``threading.Lock`` with zero overhead.
Under ``LUX_LOCKWATCH=1`` each lock is wrapped so the process observes
its own locking discipline while it runs:

- **order graph** — whenever a thread acquires lock B while holding lock
  A, the edge A→B is recorded (with a one-time acquisition stack). If
  the reverse path B→…→A was ever observed, that is a lock-order
  inversion: two threads interleaving those paths can deadlock. The
  inversion is recorded with both stacks and counted in
  ``lux_lock_inversions_total``.
- **contention histograms** — ``lux_lock_wait_seconds{lock}`` (time
  blocked in acquire) and ``lux_lock_hold_seconds{lock}`` (time held)
  are mirrored into the metrics registry (``obs/metrics.py``), so a
  snapshot of it shows which lock is hot.
- **hold warnings** — a hold longer than ``LUX_LOCK_HOLD_WARN_MS`` logs
  one warning and bumps ``lux_lock_hold_warnings_total{lock}``.

The static half of this tier is ``analysis/threads.py`` (LUX301–LUX305,
``python -m lux_tpu_torch.tools.luxlint --threads``); this module is the
runtime witness for what the AST cannot see — actual interleavings.

Import discipline: this module is imported by ``lux_tpu_torch.obs``
modules at module scope, so it must not import ``lux_tpu_torch.obs`` at
*its* module scope — metrics wiring is imported lazily, only when a
watched lock is actually constructed (obs.metrics is stdlib-only and
already initialized by then).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple

from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.logging import get_logger

__all__ = ["make_lock", "WatchedLock", "LockWatch", "WATCH",
           "LOCK_BUCKETS"]

# Lock waits/holds run ~100ns (uncontended obs counters) to seconds
# (engine builds under the pool lock); the default seconds-oriented
# histogram bounds would collapse everything interesting into one
# bucket.
LOCK_BUCKETS = (1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1,
                0.5, 1.0, 5.0, 30.0, float("inf"))

_STACK_LIMIT = 8   # frames kept per recorded acquisition site


def _site_stack() -> List[str]:
    """A trimmed acquisition stack (drops this module's own frames)."""
    frames = traceback.format_stack(limit=_STACK_LIMIT + 2)
    return [f.rstrip() for f in frames
            if "/utils/locks.py" not in f.split(",")[0]][-_STACK_LIMIT:]


class LockWatch:
    """Process-wide observer: per-thread held-lock stacks + the observed
    lock-order graph with online cycle (inversion) detection.

    The watcher's own lock is deliberately a bare ``threading.Lock`` —
    it is the substrate the watched locks report into, and watching it
    would recurse.
    """

    def __init__(self):
        self._glock = threading.Lock()
        self._tls = threading.local()
        # (held_name, acquired_name) -> first-observation record
        self._edges: Dict[Tuple[str, str], dict] = {}
        # held_name -> set of names acquired under it
        self._order: Dict[str, Set[str]] = {}
        self._inversions: List[dict] = []
        self._inverted: Set[Tuple[str, str]] = set()

    # -- per-thread stack --------------------------------------------------

    def _stack(self) -> List[Tuple[str, float]]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held(self) -> List[str]:
        """Names of locks the calling thread currently holds, outermost
        first."""
        return [name for name, _ in self._stack()]

    # -- recording ---------------------------------------------------------

    def note_acquired(self, name: str) -> None:
        stack = self._stack()
        held = [h for h, _ in stack if h != name]
        stack.append((name, time.perf_counter()))
        if not held:
            return
        with self._glock:
            for h in held:
                key = (h, name)
                if key in self._edges:
                    self._edges[key]["count"] += 1
                    continue
                site = _site_stack()
                self._edges[key] = {
                    "held": h, "acquired": name, "count": 1,
                    "thread": threading.current_thread().name,
                    "stack": site,
                }
                self._order.setdefault(h, set()).add(name)
                self._check_inversion(h, name, site)

    def note_released(self, name: str) -> Optional[float]:
        """Pop the newest matching stack entry; returns the hold time in
        seconds, or None if this thread never recorded the acquire."""
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _, t_acq = stack.pop(i)
                return time.perf_counter() - t_acq
        return None

    def _check_inversion(self, held: str, acquired: str,
                         site: List[str]) -> None:
        """Called with _glock held, right after adding edge held→acquired:
        a pre-existing path acquired→…→held closes a cycle."""
        path = self._path(acquired, held)
        if path is None:
            return
        pair = tuple(sorted((held, acquired)))
        if pair in self._inverted:
            return
        self._inverted.add(pair)
        other = self._edges.get((path[0], path[1]))
        record = {
            "cycle": [held, acquired] + path[1:],
            "held": held,
            "acquired": acquired,
            "thread": threading.current_thread().name,
            "stack": site,
            "prior_stack": other["stack"] if other else [],
            "prior_thread": other["thread"] if other else None,
        }
        self._inversions.append(record)
        self._metric("counter", "lux_lock_inversions_total").inc()
        get_logger("locks").error(
            "lock-order inversion: %s acquired while holding %s, but the "
            "order %s was observed earlier (cycle %s)",
            acquired, held, " -> ".join(path), " -> ".join(record["cycle"]),
        )

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src→…→dst in the observed order graph, or None."""
        seen = {src}
        frontier = [[src]]
        while frontier:
            path = frontier.pop()
            for nxt in self._order.get(path[-1], ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(path + [nxt])
        return None

    @staticmethod
    def _metric(kind: str, name: str, labels: Optional[dict] = None, **kw):
        from lux_tpu_torch.obs import metrics   # lazy: see module docstring
        return getattr(metrics, kind)(name, labels, **kw)

    # -- introspection -----------------------------------------------------

    def inversions(self) -> List[dict]:
        with self._glock:
            return list(self._inversions)

    def assert_no_inversions(self) -> None:
        inv = self.inversions()
        if inv:
            lines = [
                f"  cycle {' -> '.join(r['cycle'])} "
                f"(thread {r['thread']})" for r in inv
            ]
            raise AssertionError(
                f"LockWatch observed {len(inv)} lock-order inversion(s):\n"
                + "\n".join(lines)
            )

    def stats(self) -> dict:
        with self._glock:
            return {
                "edges": len(self._edges),
                "inversions": len(self._inversions),
                "order": {h: sorted(v) for h, v in self._order.items()},
            }

    def reset(self) -> None:
        """Drop all observed state (tests; the per-thread stacks of live
        threads are left alone — they reflect locks actually held)."""
        with self._glock:
            self._edges.clear()
            self._order.clear()
            self._inversions.clear()
            self._inverted.clear()


WATCH = LockWatch()


class WatchedLock:
    """``threading.Lock`` wrapper reporting to a :class:`LockWatch`.

    Histogram objects are cached at construction so the release path
    never touches the metrics registry's own (bare) lock — observing a
    watched lock must not acquire another lock.
    """

    __slots__ = ("name", "_inner", "_watch", "_wait_h", "_hold_h",
                 "_warns")

    def __init__(self, name: str, watch: Optional[LockWatch] = None):
        self.name = name
        self._inner = threading.Lock()
        self._watch = watch if watch is not None else WATCH
        labels = {"lock": name}
        self._wait_h = LockWatch._metric(
            "histogram", "lux_lock_wait_seconds", labels,
            buckets=LOCK_BUCKETS)
        self._hold_h = LockWatch._metric(
            "histogram", "lux_lock_hold_seconds", labels,
            buckets=LOCK_BUCKETS)
        self._warns = LockWatch._metric(
            "counter", "lux_lock_hold_warnings_total", labels)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._wait_h.observe(time.perf_counter() - t0)
            self._watch.note_acquired(self.name)
        return ok

    def release(self) -> None:
        hold = self._watch.note_released(self.name)
        self._inner.release()
        if hold is None:
            return
        self._hold_h.observe(hold)
        warn_s = flags.get_float("LUX_LOCK_HOLD_WARN_MS") / 1e3
        if warn_s > 0 and hold > warn_s:
            self._warns.inc()
            get_logger("locks").warning(
                "lock %s held %.3fs (> LUX_LOCK_HOLD_WARN_MS=%.0fms)",
                self.name, hold, warn_s * 1e3,
            )

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"WatchedLock({self.name!r}, locked={self.locked()})"


def make_lock(name: str):
    """A named lock: bare ``threading.Lock`` normally, a
    :class:`WatchedLock` reporting into :data:`WATCH` under
    ``LUX_LOCKWATCH=1``.

    The flag is read at construction — locks created at import time need
    the env var set before import, which is also why the wrapper costs
    nothing when off.
    """
    if flags.get_bool("LUX_LOCKWATCH"):
        return WatchedLock(name)
    return threading.Lock()


def hold_quantile(name: str, q: float) -> Optional[float]:
    """The ``lux_lock_hold_seconds{lock=name}`` quantile, or None if the
    lock has no observations (e.g. LockWatch off)."""
    h = LockWatch._metric("histogram", "lux_lock_hold_seconds",
                          {"lock": name}, buckets=LOCK_BUCKETS)
    return h.quantile(q) if h.count else None
