"""Runtime discipline sentinels, the counterpart of
``lux_tpu/analysis/sentinel.py``: the recompile sentinel and the host
transfer guard.

:class:`RecompileSentinel` counts compile-like work per executor key, by
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

:class:`HostTransferGuard` is LUX001 at run time: a context manager that
fails any device->host transfer or device sync issued inside a guarded
iteration region. Tests and ``chip_smoke.py`` wrap the region between
intended sync points to prove the loop body is transfer-free.
"""

from __future__ import annotations

import contextlib
import sys
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


class HostTransferError(AssertionError):
    """A device->host transfer happened inside a guarded region."""


class HostTransferGuard:
    """Fail device->host transfers inside a guarded iteration region.

    Patches the port's sync entry points: ``torch.cuda.synchronize``,
    ``Event.synchronize`` and ``Stream.synchronize`` of ``torch.cuda``,
    and ``engine/telemetry.py::sync`` (in every loaded module that bound
    it by name). It also arms a ``TorchDispatchMode`` that raises on
    every device->host read of a CUDA tensor: ``aten._local_scalar_dense``
    (behind ``.item()``, ``float()``, ``int()`` and ``bool()``) and copies
    to the CPU (``aten._to_copy`` to a CPU device, behind ``.cpu()``,
    ``.to("cpu")``, ``.tolist()`` and ``.numpy(force=True)``, and
    ``aten.copy_`` into a CPU tensor). A bare ``.numpy()`` of a CUDA
    tensor is refused by torch itself before any transfer. On the CPU
    there is no device boundary, so the patched entry points are the
    enforcement, as ``lux_tpu``'s guard enforces its patched entry points
    on a CPU backend.

    Single-thread use: the dispatch mode covers the entering thread, and
    the patched entry points are process-wide while the guard is active.
    Entry points are restored on exit. ``allow()`` (reentrant) opens a
    window for an intended sync point::

        with HostTransferGuard() as g:
            for _ in range(n):
                vals = ex.step(vals)     # must stay on the card
            with g.allow():
                torch.cuda.synchronize()
    """

    def __init__(self, label: str = ""):
        self.label = label
        self._depth = 0          # allow() nesting
        self._saved = None
        self._mode = None

    def _blocked(self, what: str):
        raise HostTransferError(
            f"{what} inside HostTransferGuard"
            + (f" [{self.label}]" if self.label else "")
            + " — device->host transfer in a guarded iteration region"
        )

    def _guarded(self, what: str, real):
        guard = self

        def call(*args, **kwargs):
            if guard._depth == 0:
                guard._blocked(what)
            return real(*args, **kwargs)

        return call

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        from lux_tpu_torch.engine import telemetry

        targets = [(torch.cuda, "synchronize", "torch.cuda.synchronize"),
                   (torch.cuda.Event, "synchronize", "Event.synchronize"),
                   (torch.cuda.Stream, "synchronize", "Stream.synchronize")]
        targets += [(mod, "sync", "telemetry.sync")
                    for name, mod in list(sys.modules.items())
                    if name.startswith("lux_tpu_torch")
                    and getattr(mod, "sync", None) is telemetry.sync]
        self._saved = [(owner, attr, getattr(owner, attr))
                       for owner, attr, _ in targets]
        for (owner, attr, what), (_, _, real) in zip(targets, self._saved):
            setattr(owner, attr, self._guarded(what, real))
        guard = self
        aten = torch.ops.aten

        class _DeviceToHost(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if guard._depth == 0:
                    what = guard._reads(func, args, kwargs, aten)
                    if what is not None:
                        guard._blocked(what)
                return func(*args, **kwargs)

        self._mode = _DeviceToHost()
        self._mode.__enter__()
        return self

    @staticmethod
    def _reads(func, args, kwargs, aten):
        """The device->host read ``func`` would make, else None."""
        def cuda(t):
            return getattr(t, "is_cuda", False)

        if func is aten._local_scalar_dense.default and cuda(args[0]):
            return "a scalar read of a CUDA tensor (.item/float/int/bool)"
        if func is aten._to_copy.default and cuda(args[0]):
            dev = kwargs.get("device")
            if dev is not None and dev.type == "cpu":
                return "a copy of a CUDA tensor to the CPU (.cpu/.tolist)"
        if func is aten.copy_.default and len(args) > 1 and \
                cuda(args[1]) and not cuda(args[0]):
            return "a copy of a CUDA tensor into a CPU tensor"
        return None

    def __exit__(self, *exc):
        mode, self._mode = self._mode, None
        mode.__exit__(*exc)
        for owner, attr, real in self._saved:
            setattr(owner, attr, real)
        self._saved = None
        return False

    @contextlib.contextmanager
    def allow(self):
        """Window for an intended sync point inside the guard."""
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
