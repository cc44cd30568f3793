"""Warm-engine pool: built executors keyed so repeats never rebuild.

The CLI path (models/cli.py) builds a fresh executor — graph upload,
row schedules, the kernels' first launch — per invocation; a served
query must not. The pool keys an executor by everything that changes
what it runs: (program name, graph fingerprint, engine kind, parts,
batch width, mesh shape), builds it at most once, warms it (the first
run's set-up outside any request), and hands the same object to every
subsequent query.

Evidence that the contract holds comes at two levels: hit/miss counters
(an engine was or wasn't rebuilt) and a
:class:`~lux_tpu_torch.analysis.sentinel.RecompileSentinel` counting the
compile-like work of the process (the kernel library's build and load)
per key — builds run under ``expect(key)``, the session executes queries
under ``watch(key)``, and any compile landing in a watch region is a
recompile the stats (and the serve tests) flag.

``lux_tpu``'s pool also audits every build (the IR donation audit, the
exchange-plan audit, the program-algebra audit) and admits builds under
an HBM budget priced by its memcap.v1 footprint model. The three audits
run here as there, advisory: the IR audit (``analysis/ir.py``, LUX104
over the engine's ``trace_step``, its findings counted in
``lux_ir_findings_total``; no step of the port donates yet, so a build's
declaration is read and no step runs), the program-algebra audit
(``analysis/gasck.py``, LUX601/602/605, counted in
``lux_gas_findings_total``) and the exchange-plan audit
(``analysis/exchck.py``, LUX401-403/407 over the live compact plan of a
sharded engine, counted in ``lux_exch_findings_total``). The footprint
model is not ported (ROADMAP A16): with no budget to derive, admission
takes ``lux_tpu``'s own branch for that case and admits every build.

Engine work on a card runs on a CUDA stream of the calling thread's own
(:func:`engine_stream`): the port's cooperative kernels keep one queue
scratch per (device, stream), so two threads sharing the default stream
could interleave one another's launches through it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Hashable

import torch

from lux_tpu_torch.analysis.sentinel import RecompileSentinel
from lux_tpu_torch.obs import metrics, spans
from lux_tpu_torch.utils import faults, flags
from lux_tpu_torch.utils.locks import make_lock
from lux_tpu_torch.utils.logging import get_logger

NOT_PORTED = "not ported (ROADMAP A16)"
GAS_AUDIT_STATUS = ("ported: LUX601/602/605 on every build carrying a "
                    "program (analysis/gasck.py)")
EXCH_AUDIT_STATUS = ("ported: LUX401-403/407 on every build carrying a "
                     "compact exchange plan (analysis/exchck.py)")
IR_AUDIT_STATUS = ("ported: LUX104 on every build with a trace_step, "
                   "its step run where it donates (analysis/ir.py)")

_STREAMS = threading.local()


@contextlib.contextmanager
def engine_stream(device):
    """Run the block on this thread's own CUDA stream on ``device`` and
    wait for that stream on exit, so whatever the block produced (device
    tensors included) is complete before another thread's stream reads
    it; a no-op off the card. Nested uses on one thread share the
    stream."""
    if device is None or torch.device(device).type != "cuda":
        yield None
        return
    dev = torch.device(device)
    per = getattr(_STREAMS, "by_device", None)
    if per is None:
        per = _STREAMS.by_device = {}
    stream = per.get(dev.index)
    if stream is None:
        stream = per[dev.index] = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        try:
            yield stream
        finally:
            stream.synchronize()


class EnginePool:
    """Thread-safe keyed singleton store for warmed executors."""

    def __init__(self, scope: str = "serve"):
        self._engines = {}
        self._lock = make_lock("pool")
        self.log = get_logger("serve")
        self._hits = metrics.counter("lux_serve_pool_hits_total")
        self._misses = metrics.counter("lux_serve_pool_misses_total")
        # Created eagerly so a clean pool still exports 0 — the serve
        # dashboards alert on this going nonzero, not on its absence.
        self._ir_findings = metrics.counter("lux_ir_findings_total")
        self._exch_findings = metrics.counter("lux_exch_findings_total")
        self._gas_findings = metrics.counter("lux_gas_findings_total")
        self._retired = metrics.counter("lux_serve_pool_retired_total")
        # Builds the IR, exchange-plan and program-algebra audits read;
        # the IR audit runs a step only where it donates.
        self._ir_audited = 0
        self._ir_undonated = 0
        self._exch_audited = 0
        self._gas_audited = 0
        self.sentinel = RecompileSentinel(scope)

    def get(self, key: Hashable, factory: Callable[[], object]):
        """The executor for ``key``, building (and warming, if the
        executor has a ``warmup``) via ``factory`` on first request.

        ``lux_tpu``'s pool first admits the build under an HBM budget
        priced by the memcap.v1 footprint model, and admits freely when
        no budget can be derived. The model is not ported (ROADMAP A16),
        so no build is priced and every build takes that branch.

        The build runs under the lock: concurrent first requests for one
        key must not build twice. On a card the building thread's stream
        is waited for before the engine is published, so a thread of
        another stream never reads a half-uploaded graph."""
        with self._lock:
            ex = self._engines.get(key)
            if ex is not None:
                self._hits.inc()
                return ex
            self._misses.inc()
            # spans.span: a build triggered by a live request joins that
            # request's trace; warmup builds root their own.
            with spans.span("serve.engine_build", key=str(key)):
                with self.sentinel.expect(key):
                    faults.point("pool.build")
                    ex = factory()
                    if hasattr(ex, "warmup"):
                        # First-build warmup deliberately holds the lock:
                        # releasing would let a concurrent request build
                        # the same engine twice.
                        # luxlint: disable=LUX303 -- single-build guarantee needs the lock
                        ex.warmup()
                    dev = getattr(ex, "device", None)
                    if dev is not None and dev.type == "cuda":
                        torch.cuda.current_stream(dev).synchronize()
            self._audit(key, ex)
            self._audit_exchange(key, ex)
            self._audit_programs(key, ex)
            self._engines[key] = ex
            return ex

    def _audit(self, key: Hashable, ex) -> None:
        """LUX104 donation audit on the freshly built engine
        (``analysis/ir.py::audit_engine``): its ``trace_step``'s
        declaration, and where it donates, one unrecorded step whose
        outputs must reuse the donated storage (``audited_builds``). A
        step that donates nothing has nothing to audit: its declaration
        is read, no state is built and no step runs
        (``undonated_builds``). A finding means an iteration buffer the
        engine thinks it reuses is copied every step — flagged once at
        build time (``lux_ir_findings_total``), never per query.
        Advisory: a failed audit never takes a build down."""
        if not flags.get_bool("LUX_IR_POOL_AUDIT"):
            return
        if not hasattr(ex, "trace_step"):
            return
        from lux_tpu_torch.analysis import ir
        try:
            target = ir.engine_target(ex, f"pool@{key}")
            if not target.donate:
                self._ir_undonated += 1
                return
            with engine_stream(getattr(ex, "device", None)):
                findings = ir.audit_target(target)
        # luxlint: disable=LUX007 -- advisory audit: a failed trace must never take down a build
        except Exception:
            return
        self._ir_audited += 1
        for f in findings:
            self._ir_findings.inc()
            self.log.warning("EnginePool: %s", f.format())

    def _audit_exchange(self, key: Hashable, ex) -> None:
        """LUX401-403/407 plan audit on the freshly built engine: pure
        numpy over the live ExchangePlan tables, nothing run on the card.
        A finding means the packed exchange this engine is about to serve
        with drops or duplicates rows — flagged once at build time
        (``lux_exch_findings_total``), never per query."""
        if not flags.get_bool("LUX_EXCH_POOL_AUDIT"):
            return
        if getattr(ex, "_xplan", None) is None:
            return
        from lux_tpu_torch.analysis import exchck
        findings = exchck.audit_exchange(ex, f"pool@{key}")
        self._exch_audited += 1
        for f in findings:
            self._exch_findings.inc()
            self.log.warning("EnginePool: %s", f.format())

    def _audit_programs(self, key: Hashable, ex) -> None:
        """LUX601/602/605 program-algebra audit on the freshly built
        engine: probe-grid identity/exactness/annihilation, the hooks on
        the engine's device, no graph trace (gasck caches per program
        identity, so the k-th engine for a program costs a dict lookup).
        A finding means the combiner algebra this engine's masking and
        sharded accumulation rely on does not hold — flagged once at
        build time (``lux_gas_findings_total``), never per query. The
        audit is advisory: a build survives its findings, and a failed
        probe never takes a build down."""
        if not flags.get_bool("LUX_GAS_POOL_AUDIT"):
            return
        prog = getattr(ex, "program", None)
        if prog is None:
            return
        from lux_tpu_torch.analysis import gasck
        try:
            findings = gasck.audit_program(
                prog, f"pool@{key}", getattr(ex, "device", None))
        # luxlint: disable=LUX007 -- advisory audit: a failed probe must never take down a build
        except Exception:
            return
        self._gas_audited += 1
        for f in findings:
            self._gas_findings.inc()
            self.log.warning("EnginePool: %s", f.format())

    def retire(self, predicate: Callable[[Hashable], bool]) -> int:
        """Drop every engine whose key satisfies ``predicate`` (hot-swap:
        the session retires all engines keyed by the outgoing snapshot's
        fingerprint once in-flight queries drain). Dropped executors are
        released to GC — device buffers for a dead snapshot's graph are
        the largest thing a swap frees."""
        with self._lock:
            victims = [k for k in self._engines if predicate(k)]
            for k in victims:
                del self._engines[k]
            if victims:
                self._retired.inc(len(victims))
        return len(victims)

    def __len__(self) -> int:
        with self._lock:
            return len(self._engines)

    def keys(self) -> list:
        """Snapshot of the live engine keys (observability: /statusz
        groups pool entries by the mesh-shape key component)."""
        with self._lock:
            return list(self._engines)

    def audits(self) -> dict:
        """Each build-time audit and the admission of ``lux_tpu``'s pool:
        the flag that asks for it, whether it asks, and what the port
        does about it."""
        with self._lock:
            ir_audited, ir_undonated, exch_audited, gas_audited = (
                self._ir_audited, self._ir_undonated, self._exch_audited,
                self._gas_audited)
        out = {"ir": {"flag": "LUX_IR_POOL_AUDIT",
                      "requested": flags.get_bool("LUX_IR_POOL_AUDIT"),
                      "status": IR_AUDIT_STATUS,
                      "audited_builds": ir_audited,
                      "undonated_builds": ir_undonated,
                      "findings": int(self._ir_findings.value)}}
        out["exchck"] = {"flag": "LUX_EXCH_POOL_AUDIT",
                         "requested": flags.get_bool("LUX_EXCH_POOL_AUDIT"),
                         "status": EXCH_AUDIT_STATUS,
                         "audited_builds": exch_audited,
                         "findings": int(self._exch_findings.value)}
        out["gasck"] = {"flag": "LUX_GAS_POOL_AUDIT",
                        "requested": flags.get_bool("LUX_GAS_POOL_AUDIT"),
                        "status": GAS_AUDIT_STATUS,
                        "audited_builds": gas_audited,
                        "findings": int(self._gas_findings.value)}
        out["memck"] = {
            "flag": "LUX_MEM_POOL_ADMIT",
            "requested": flags.get_bool("LUX_MEM_POOL_ADMIT"),
            "status": NOT_PORTED + ": no HBM budget can be derived, so "
                      "every build is admitted"}
        return out

    def stats(self) -> dict:
        return {
            "engines": len(self),
            "hits": int(self._hits.value),
            "misses": int(self._misses.value),
            "retired": int(self._retired.value),
            "warmup_compiles": self.sentinel.compiles(),
            "recompiles": self.sentinel.recompiles(),
            "ir_findings": int(self._ir_findings.value),
            "exch_findings": int(self._exch_findings.value),
            "gas_findings": int(self._gas_findings.value),
            # No build is priced (see get), so none is resident by the
            # model's account and none was evicted for the budget.
            "hbm_resident_bytes": None,
            "hbm_evictions": 0,
            "audits": self.audits(),
        }

    def close(self):
        self.sentinel.close()
