"""Recompile sentinel: counts compile-like work per executor key, by
phase.

``lux_tpu``'s :class:`RecompileSentinel` counts XLA backend compiles
through JAX's monitoring event. The port compiles no graphs: its kernels
are built once by ``nvcc`` and loaded with ctypes
(``ops/_cuda.py``). What can land inside a serving region is that build
(``"nvcc"``, when the sources changed) and the load of the library into
the process (``"load"``, once per process); ``_cuda.add_compile_hook``
reports both, on the thread that does them, and they are what this
sentinel counts. A ``torch.compile`` graph or a CUDA-graph capture, were
the port to add one, would report through the same hook.

serve/pool.py builds engines under ``expect(key)`` and the session
serves queries under ``watch(key)``; any compile landing in a watch
region is a recompile — the serving layer's "zero recompiles after
warmup" claim, machine-checked. Counters mirror onto the obs metrics
registry as ``lux_xla_compiles_total{scope,key,phase}``, the name
``/metrics`` consumers of ``lux_tpu`` read.

``lux_tpu``'s ``HostTransferGuard`` is not ported (ROADMAP A16).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

from lux_tpu_torch.obs import metrics
from lux_tpu_torch.ops import _cuda

_SENTINELS = set()
_SENTINELS_LOCK = threading.Lock()
_LISTENER_STATE = {"installed": False}


def _dispatch(what: str):
    with _SENTINELS_LOCK:
        active = list(_SENTINELS)
    for s in active:
        s._on_compile()


def _ensure_listener() -> bool:
    """Install the process-wide compile listener once; it dispatches to
    whatever sentinels are alive."""
    with _SENTINELS_LOCK:
        if not _LISTENER_STATE["installed"]:
            _LISTENER_STATE["installed"] = True
            _cuda.add_compile_hook(_dispatch)
    return True


class RecompileError(AssertionError):
    """A compile happened in a region that promised zero recompiles."""


class RecompileSentinel:
    """Per-key compile counter with warmup/serve phase attribution.

    Compiles are attributed to the innermost active region on the
    calling thread (the kernels are built and loaded on the thread that
    first launches one): ``expect(key)`` regions absorb warmup compiles,
    ``watch(key)`` regions count recompiles. Compiles outside any region
    are ignored — unrelated traffic must not pollute the serving
    evidence.
    """

    def __init__(self, scope: str = "default"):
        self.scope = scope
        self.available = _ensure_listener()
        self._counts: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        # Registered eagerly so a clean sentinel still exports the
        # family at 0 — /metrics scrapes alert on the serve-phase count
        # going nonzero, not on its absence.
        metrics.counter(
            "lux_xla_compiles_total",
            {"scope": scope, "key": "_all", "phase": "serve"},
        )
        with _SENTINELS_LOCK:
            _SENTINELS.add(self)

    def close(self):
        with _SENTINELS_LOCK:
            _SENTINELS.discard(self)

    # -- region plumbing -------------------------------------------------

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def _region(self, phase: str, key):
        st = self._stack()
        st.append((phase, str(key)))
        try:
            yield self
        finally:
            st.pop()

    def expect(self, key):
        """Region where compiles are expected (build + warmup)."""
        return self._region("warmup", key)

    def watch(self, key):
        """Region that promises zero compiles (post-warmup serving)."""
        return self._region("serve", key)

    def _on_compile(self):
        st = getattr(self._tls, "stack", None)
        if not st:
            return
        phase, key = st[-1]
        with self._lock:
            self._counts[(key, phase)] = self._counts.get((key, phase), 0) + 1
        metrics.counter(
            "lux_xla_compiles_total",
            {"scope": self.scope, "key": key, "phase": phase},
        ).inc()

    # -- readout ---------------------------------------------------------

    def compiles(self, key=None, phase: str = "warmup") -> int:
        with self._lock:
            return sum(
                c for (k, p), c in self._counts.items()
                if p == phase and (key is None or k == str(key))
            )

    def recompiles(self, key=None) -> int:
        """Compiles observed inside watch regions (should stay 0)."""
        return self.compiles(key, phase="serve")

    def stats(self) -> dict:
        with self._lock:
            per_key: Dict[str, Dict[str, int]] = {}
            for (k, p), c in self._counts.items():
                per_key.setdefault(k, {})[p] = c
        return {
            "available": self.available,
            "warmup_compiles": self.compiles(),
            "recompiles": self.recompiles(),
            "per_key": per_key,
        }

    def assert_zero_recompiles(self, key=None):
        n = self.recompiles(key)
        if n:
            raise RecompileError(
                f"{n} compile(s) after warmup in scope "
                f"{self.scope!r}: {self.stats()['per_key']}"
            )
