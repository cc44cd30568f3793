"""The marks that the trace tiers record, set in the layers they trace.

The public kernel wrappers (``ops/``) are decorated with :func:`kernel`
and the mesh collectives (``parallel/``) with :func:`collective`; the
engines enter their host-chosen branches through :func:`alternatives`
and keep a traced step free of side effects with :func:`preserved`.
:mod:`lux_tpu_torch.analysis.trace` attaches a recorder while a trace is
live and records what these marks report. This module holds only the
marks and the live recorder's slot, so the layers that carry them
depend on nothing above them.

With no trace live, a decorated wrapper costs one global check per
call. A trace covers the thread that attaches it.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import threading
from typing import Callable, Optional

__all__ = ["alternatives", "attach", "collective", "current", "detach",
           "kernel", "preserved"]

# Recorders attached in the process: the one global a wrapper checks.
_LIVE = 0
_STATE = threading.local()       # .trace: the thread's live recorder


def current():
    """The thread's live recorder, or None."""
    return getattr(_STATE, "trace", None)


def attach(rec) -> int:
    """Make ``rec`` the thread's live recorder; returns how many are
    live in the process. The caller serialises :func:`attach` and
    :func:`detach`."""
    global _LIVE
    if current() is not None:
        raise RuntimeError("a trace is already live in this thread")
    _LIVE += 1
    _STATE.trace = rec
    return _LIVE


def detach() -> int:
    """Drop the thread's live recorder; returns how many stay live."""
    global _LIVE
    _STATE.trace = None
    _LIVE -= 1
    return _LIVE


def _record(op: str, kind: str, fn, args, kwargs, nbytes: int = 0,
            extra=None):
    rec = current()
    if rec is None or rec.fold:
        return fn(*args, **kwargs)
    return rec.call(op, kind, fn, args, kwargs, nbytes, extra)


def kernel(name: str, extra: Optional[Callable] = None):
    """Decorate a public kernel wrapper: under a live trace, one
    ``lux.<name>`` node with the tensors it reads and writes, its inner
    ops (the plain twin's on the CPU) folded into it. ``extra(*args,
    **kwargs)``, called after the kernel, names tensors it reads that
    are no argument (a cached scratch)."""
    op = "lux." + name

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _LIVE:
                return fn(*args, **kwargs)
            return _record(op, "kernel", fn, args, kwargs, extra=extra)
        return wrapper
    return deco


def collective(name: str, price: Callable):
    """Decorate a mesh's collective method: under a live trace, one
    ``name`` node whose ``nbytes`` is ``price(mesh, operand)``, the
    whole mesh's bytes as ``lux_tpu`` prices them
    (``ir.py::_collective_byte_totals``)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, x, *args, **kwargs):
            if not _LIVE:
                return fn(self, x, *args, **kwargs)
            return _record(name, "collective", fn, (self, x) + args,
                           kwargs, nbytes=price(self, x))
        return wrapper
    return deco


class _Alternatives:
    def __init__(self, rec):
        self.rec = rec
        self.group = 0
        if rec is not None:
            self.group = len(rec.groups) + 1
            rec.groups[self.group] = 0
        self.n = 0

    @contextlib.contextmanager
    def branch(self, label: str = ""):
        """One alternative; ``label`` names it for a reader."""
        rec = self.rec
        if rec is None:
            yield
            return
        rec.alt.append((self.group, self.n, label))
        self.n += 1
        rec.groups[self.group] = self.n
        try:
            yield
        finally:
            rec.alt.pop()


def alternatives() -> _Alternatives:
    """The branches one host decision picks among, each entered with
    ``.branch(label)``; their nodes are alternatives to each other
    (``lux_tpu``'s ``cond`` branches). Outside a trace it records
    nothing."""
    return _Alternatives(current())


@contextlib.contextmanager
def preserved(obj, *attrs: str):
    """Restore ``obj``'s ``attrs`` on exit, lists and dicts in place (a
    caller holding one sees it as it was): a traced step leaves its
    executor as it found it."""
    saved = {a: (getattr(obj, a), copy.copy(getattr(obj, a)))
             for a in attrs if hasattr(obj, a)}
    try:
        yield
    finally:
        for a, (orig, snap) in saved.items():
            if isinstance(orig, list):
                orig[:] = snap
            elif isinstance(orig, dict):
                orig.clear()
                orig.update(snap)
            else:
                orig = snap
            setattr(obj, a, orig)
