"""Seeded, deterministic fault injection, a copy of
``lux_tpu/utils/faults.py`` (the same points, kinds, spec grammar and
seeded draws, so one ``LUX_FAULTS`` spec fires alike in both packages).

The failure paths of graph/wal.py and engine/incremental.py (and, once
ported, serve/) need an engine to raise, a disk to stall, or a write to
tear on demand. This registry does that with *named fault points*
laced through those layers::

    faults.point("serve.engine.execute")          # maybe raise/delay/crash
    payload = faults.point("wal.fsync", data=payload)   # maybe corrupt

A point is a zero-cost no-op until armed: the hot path pays one module-
global bool check and returns. Arming happens through the ``LUX_FAULTS``
spec (read once via :func:`reconfigure`, never per call) or the
programmatic :func:`arm` / :func:`injected` API::

    LUX_FAULTS="serve.engine.execute:raise:0.25,batcher.assemble:delay_ms:1.0:2"

Spec grammar: ``point:kind:prob[:arg]``, comma-separated. Kinds:

- ``raise``    — raise :class:`FaultInjected` (a transient engine error;
  the serve retry/breaker machinery is expected to absorb it). ``arg``
  (optional int) caps how many times the rule fires — ``raise:1.0:2``
  injects exactly two failures then goes quiet, which is how tests model
  a transient blip.
- ``delay_ms`` — sleep ``arg`` milliseconds (slow device / slow disk).
- ``corrupt``  — flip one byte/element of the ``data`` payload handed to
  the point and return the corrupted copy (torn/bit-rotted write).
  ``arg`` caps fire count like ``raise``.
- ``crash``    — raise :class:`CrashPoint`, a ``BaseException``: no
  ``except Exception`` handler (retry, batch recovery, warm threads) may
  absorb it, modeling sudden process death at that instruction. ``arg``
  caps fire count.

Determinism: each armed rule owns a ``random.Random`` seeded from
``(LUX_FAULTS_SEED, point, kind)``, so a given spec + seed fires on the
same draw sequence every run (thread interleaving can still reorder
*which request* sees a given draw; invariants, not exact victims, are
what chaos runs assert).

Fired injections are counted per ``(point, kind)`` both locally
(:func:`counts`) and in the metrics registry
(``lux_faults_injected_total{point,kind}``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Dict, List, Optional, Tuple

from lux_tpu_torch.utils import flags
from lux_tpu_torch.utils.locks import make_lock
from lux_tpu_torch.utils.logging import get_logger

__all__ = [
    "POINTS", "KINDS", "FaultInjected", "CrashPoint", "FaultRule",
    "parse", "arm", "disarm", "reconfigure", "armed", "counts",
    "injected", "point",
]

# The registered fault points. point() only accepts these names, so a
# typo'd lace site fails loudly the first time it is armed instead of
# silently never firing. The serve/ points are lux_tpu's; the port laces
# wal.fsync and serve.engine.execute (engine/incremental.py) so far.
POINTS = (
    "serve.engine.execute",   # engine run inside the batcher (serve/session.py)
    "pool.build",             # executor build/compile (serve/pool.py)
    "snapshot.warm",          # hot-swap warmup of version N+1 (serve/session.py)
    "cache.put",              # result-cache insert (serve/cache.py)
    "wal.fsync",              # WAL record write+fsync (graph/wal.py)
    "batcher.assemble",       # batch formation on the worker (serve/batcher.py)
)

KINDS = ("raise", "delay_ms", "corrupt", "crash")


class FaultInjected(RuntimeError):
    """A ``raise``-kind fault fired: a *transient* engine/IO failure the
    degradation machinery (retry, breaker, cache bypass) should absorb."""

    def __init__(self, point_name: str):
        super().__init__(f"injected fault at {point_name}")
        self.point = point_name


class CrashPoint(BaseException):
    """A ``crash``-kind fault fired: simulated sudden process death.

    Deliberately a ``BaseException`` so no ``except Exception`` handler
    (retry loops, batch recovery, warm threads) can absorb it — only the
    test/chaos harness that armed it catches it, then exercises the
    recovery path (WAL replay) as a fresh process would.
    """

    def __init__(self, point_name: str):
        super().__init__(f"injected crash at {point_name}")
        self.point = point_name


@dataclasses.dataclass(frozen=True)
class FaultRule:
    point: str
    kind: str
    prob: float
    arg: Optional[float] = None   # delay_ms: milliseconds; others: max fires


class _Armed:
    """One armed rule plus its private seeded RNG and fire budget."""

    def __init__(self, rule: FaultRule, seed: int):
        self.rule = rule
        self.rng = random.Random(f"{seed}:{rule.point}:{rule.kind}")
        self.fires_left = (
            None if rule.kind == "delay_ms" or not rule.arg
            else int(rule.arg)
        )


_enabled = False
_lock = make_lock("faults")
_armed_rules: Dict[str, List[_Armed]] = {}
_counts: Dict[Tuple[str, str], int] = {}
_log = get_logger("faults")


def parse(spec: str) -> List[FaultRule]:
    """``point:kind:prob[:arg]`` comma list -> validated rules."""
    rules: List[FaultRule] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) not in (3, 4):
            raise ValueError(
                f"bad fault spec {part!r}: want point:kind:prob[:arg]"
            )
        name, kind, prob = bits[0], bits[1], bits[2]
        if name not in POINTS:
            raise ValueError(
                f"unknown fault point {name!r}; registered: {list(POINTS)}"
            )
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; kinds: {list(KINDS)}"
            )
        try:
            p = float(prob)
        except ValueError:
            raise ValueError(f"bad probability {prob!r} in {part!r}") from None
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"probability {p} outside [0, 1] in {part!r}")
        arg = None
        if len(bits) == 4:
            try:
                arg = float(bits[3])
            except ValueError:
                raise ValueError(f"bad arg {bits[3]!r} in {part!r}") from None
            if arg < 0:
                raise ValueError(f"negative arg {arg} in {part!r}")
        if kind == "delay_ms" and arg is None:
            raise ValueError(f"delay_ms needs an arg (ms) in {part!r}")
        rules.append(FaultRule(name, kind, p, arg))
    return rules


def arm(spec, seed: Optional[int] = None) -> int:
    """Arm rules (a spec string or an iterable of :class:`FaultRule`),
    replacing whatever was armed before. Returns the armed rule count."""
    global _enabled
    rules = parse(spec) if isinstance(spec, str) else list(spec)
    if seed is None:
        seed = flags.get_int("LUX_FAULTS_SEED")
    with _lock:
        _armed_rules.clear()
        for r in rules:
            _armed_rules.setdefault(r.point, []).append(_Armed(r, seed))
        _enabled = bool(_armed_rules)
    if rules:
        _log.info("faults armed: %s (seed=%d)",
                  ",".join(f"{r.point}:{r.kind}:{r.prob}" +
                           (f":{r.arg:g}" if r.arg is not None else "")
                           for r in rules), seed)
    return len(rules)


def disarm() -> None:
    """Back to the zero-cost no-op path (fire counts are kept)."""
    global _enabled
    with _lock:
        _armed_rules.clear()
        _enabled = False


def reconfigure() -> int:
    """(Re-)read ``LUX_FAULTS``/``LUX_FAULTS_SEED`` and arm accordingly.

    Runs once at import (so any process started with ``LUX_FAULTS`` set
    is faulted without code cooperation) and again from tests/tools that
    mutate the env — never by the hot path."""
    spec = flags.get("LUX_FAULTS") or ""
    if not spec.strip():
        disarm()
        return 0
    return arm(spec)


def armed() -> Tuple[FaultRule, ...]:
    with _lock:
        return tuple(a.rule for rules in _armed_rules.values()
                     for a in rules)


def counts() -> Dict[str, int]:
    """Fired-injection counts as ``{"point:kind": n}`` (since import)."""
    with _lock:
        return {f"{p}:{k}": n for (p, k), n in sorted(_counts.items())}


@contextlib.contextmanager
def injected(spec, seed: Optional[int] = None):
    """Arm ``spec`` for the block, restoring the previous arming after —
    the test-suite idiom for scoped injection."""
    with _lock:
        prev = [a.rule for rules in _armed_rules.values() for a in rules]
    arm(spec, seed=seed)
    try:
        yield
    finally:
        arm(prev)


def point(name: str, data=None):
    """One fault point. Returns ``data`` (possibly corrupted when a
    ``corrupt`` rule fires); may sleep, raise :class:`FaultInjected`, or
    raise :class:`CrashPoint`. When nothing is armed this is one bool
    check and a return."""
    if not _enabled:
        return data
    return _fire(name, data)


def _fire(name: str, data):
    with _lock:
        armed_here = _armed_rules.get(name)
        if not armed_here:
            return data
        actions = []
        for a in armed_here:
            if a.fires_left is not None and a.fires_left <= 0:
                continue
            if a.rng.random() >= a.rule.prob:
                continue
            if a.fires_left is not None:
                a.fires_left -= 1
            key = (name, a.rule.kind)
            _counts[key] = _counts.get(key, 0) + 1
            actions.append(a.rule)
    for rule in actions:
        _count_metric(rule)
        if rule.kind == "delay_ms":
            time.sleep(rule.arg / 1e3)
        elif rule.kind == "corrupt":
            data = _corrupt(data)
        elif rule.kind == "crash":
            _log.error("fault point %s: injected CRASH", name)
            raise CrashPoint(name)
        else:   # raise
            raise FaultInjected(name)
    return data


def _count_metric(rule: FaultRule) -> None:
    # Lazy import: utils must stay importable before obs wires up
    # (mirrors utils/locks.py's discipline).
    try:
        from lux_tpu_torch.obs import metrics
        metrics.counter("lux_faults_injected_total",
                        {"point": rule.point, "kind": rule.kind}).inc()
    except Exception:
        # Injection must work even if the metrics registry is absent
        # (partial import during interpreter teardown).
        pass


def _corrupt(data):
    """Flip one byte/element of ``data`` (bytes or ndarray), returning a
    corrupted *copy*; anything else is returned unchanged."""
    if isinstance(data, (bytes, bytearray)) and len(data):
        buf = bytearray(data)
        # Past the frame head so record *payloads*, not just lengths,
        # get exercised; position is deterministic per payload length.
        pos = len(buf) // 2
        buf[pos] ^= 0xFF
        return bytes(buf)
    try:
        import numpy as np
        if isinstance(data, np.ndarray) and data.size:
            out = data.copy()
            flat = out.reshape(-1)
            flat[flat.shape[0] // 2] = ~flat[flat.shape[0] // 2] \
                if np.issubdtype(out.dtype, np.integer) else -flat[flat.shape[0] // 2]
            return out
    except Exception:
        pass
    return data


# Import-time arming (the obs/trace.py idiom): every entry point — the
# serve CLI, app CLIs, bare scripts — honors LUX_FAULTS from the
# environment; with it unset this is the no-op disarm.
reconfigure()
