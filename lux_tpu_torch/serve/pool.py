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

Every build is audited as ``lux_tpu``'s pool audits it, advisory: the
IR audit (``analysis/ir.py``, LUX104 over the engine's ``trace_step``,
its findings counted in ``lux_ir_findings_total``; no step of the port
donates yet, so a build's declaration is read and no step runs), the
program-algebra audit (``analysis/gasck.py``, LUX601/602/605, counted in
``lux_gas_findings_total``) and the exchange-plan audit
(``analysis/exchck.py``, LUX401-403/407 over the live compact plan of a
sharded engine, counted in ``lux_exch_findings_total``).

Residency is HBM-budgeted as in ``lux_tpu``: callers that know an
engine's predicted footprint (the memcap.v1 admission formula,
``analysis/memck.py::predicted_engine_bytes``) pass it to :meth:`get`,
and the pool admits the build only if the summed resident bytes fit the
budget (``LUX_HBM_BUDGET_BYTES``, default the card's capacity x
``LUX_HBM_BUDGET_FRAC``; none on the CPU, whose profile has no
capacity), evicting cold engines by footprint-weighted LRU first. An
engine that cannot fit even in an empty pool is refused with
:class:`~lux_tpu_torch.serve.errors.PoolOverBudgetError` (HTTP 503 +
Retry-After). Warm hits never evict, so the zero-rebuild contract on
repeat traffic is untouched by the budget.

Admission is advisory until ROADMAP C6 is repaired: the formula it
trusts under-predicts some engines on the card at R-MAT 22 (the
grouped-tail tiled engine, which it prices as the lane-select one, and
the compact sharded engines), so a budget that admits a build does not
yet prove the card holds it.

The budget is one card's, and a footprint is what a build holds on the
card its parts live on. The formula is per device: one part's share of
a graph over P parts. A :class:`~lux_tpu_torch.parallel.mesh.LocalMesh`
holds all P parts on one card, so the session prices a sharded build at
``len(own_parts(mesh))`` (here P) times the per-device formula; a
:class:`~lux_tpu_torch.parallel.mesh.DistMesh` rank prices its own
parts only (``serve/session.py::Session._footprint``).

Engine work on a card runs on a CUDA stream of the calling thread's own
(:func:`engine_stream`): the port's cooperative kernels keep one queue
scratch per (device, stream), so two threads sharing the default stream
could interleave one another's launches through it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Hashable, Optional

import torch

from lux_tpu_torch.analysis.sentinel import RecompileSentinel
from lux_tpu_torch.obs import metrics, spans
from lux_tpu_torch.serve.errors import PoolOverBudgetError
from lux_tpu_torch.utils import faults, flags
from lux_tpu_torch.utils.locks import make_lock
from lux_tpu_torch.utils.logging import get_logger

MEM_ADMIT_STATUS = ("ported: every priced build admitted under the HBM "
                    "budget, cold engines evicted by footprint-weighted "
                    "LRU (analysis/memck.py)")
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
        # HBM residency accounting: predicted resident bytes per key
        # (memcap.v1 admission formula) + last-hit clock for the
        # footprint-weighted LRU.
        self._resident = {}
        self._last_hit = {}
        self._hbm_gauge = metrics.gauge("lux_pool_hbm_resident_bytes")
        self._hbm_evictions = metrics.counter(
            "lux_pool_hbm_evictions_total")
        self._priced = 0
        # Builds the IR, exchange-plan and program-algebra audits read;
        # the IR audit runs a step only where it donates.
        self._ir_audited = 0
        self._ir_undonated = 0
        self._exch_audited = 0
        self._gas_audited = 0
        self.sentinel = RecompileSentinel(scope)

    def get(self, key: Hashable, factory: Callable[[], object],
            footprint_bytes: Optional[int] = None):
        """The executor for ``key``, building (and warming, if the
        executor has a ``warmup``) via ``factory`` on first request.

        ``footprint_bytes`` is the build's predicted resident footprint
        on its card (memcap.v1); when given, admission runs first —
        evicting cold engines until the build fits the HBM budget, or
        raising :class:`PoolOverBudgetError` if it never can. Hits skip
        admission entirely (and refresh the key's LRU clock).

        The build runs under the lock: concurrent first requests for one
        key must not build twice. On a card the building thread's stream
        is waited for before the engine is published, so a thread of
        another stream never reads a half-uploaded graph."""
        with self._lock:
            ex = self._engines.get(key)
            if ex is not None:
                self._hits.inc()
                self._last_hit[key] = spans.clock()
                return ex
            self._admit(key, footprint_bytes)
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
            self._last_hit[key] = spans.clock()
            if footprint_bytes is not None:
                self._priced += 1
                self._resident[key] = int(footprint_bytes)
                self._hbm_gauge.set(float(sum(self._resident.values())))
            return ex

    def _admit(self, key: Hashable, footprint_bytes: Optional[int]):
        """Fit ``footprint_bytes`` under the HBM budget, evicting cold
        engines by footprint-weighted LRU (idle_seconds x bytes,
        coldest-and-fattest first). Caller holds the lock. No-op when
        admission is disabled, unpriced, or unbudgeted. Advisory: the
        footprints it sums come from a model that under-predicts some
        engines on the card (ROADMAP C6)."""
        if footprint_bytes is None:
            return
        if not flags.get_bool("LUX_MEM_POOL_ADMIT"):
            return
        from lux_tpu_torch.analysis import memck
        budget = memck.hbm_budget_bytes()
        if budget is None:
            return
        need = int(footprint_bytes)
        if need > budget:
            raise PoolOverBudgetError(
                f"engine {key!r} predicted footprint {need} B exceeds "
                f"the per-device HBM budget {budget} B even with an "
                "empty pool (LUX_HBM_BUDGET_BYTES / "
                "LUX_HBM_BUDGET_FRAC)")
        now = spans.clock()
        while sum(self._resident.values()) + need > budget:
            victims = [k for k in self._resident if k in self._engines]
            if not victims:
                # Remaining residency belongs to nothing evictable
                # (stale accounting); drop it rather than deadlock.
                self._resident = {k: v for k, v in self._resident.items()
                                  if k in self._engines}
                if sum(self._resident.values()) + need <= budget:
                    break
                raise PoolOverBudgetError(
                    f"engine {key!r} predicted footprint {need} B does "
                    f"not fit the HBM budget {budget} B and no resident "
                    "engine remains to evict")
            coldest = max(
                victims,
                key=lambda k: (now - self._last_hit.get(k, 0.0))
                * max(1, self._resident[k]))
            del self._engines[coldest]
            self._resident.pop(coldest, None)
            self._last_hit.pop(coldest, None)
            self._retired.inc()
            self._hbm_evictions.inc()
            self.log.info("EnginePool: evicted %r for %r under the HBM "
                          "budget %d B", coldest, key, budget)
        self._hbm_gauge.set(float(sum(self._resident.values())))

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
                self._resident.pop(k, None)
                self._last_hit.pop(k, None)
            if victims:
                self._retired.inc(len(victims))
                self._hbm_gauge.set(float(sum(self._resident.values())))
        return len(victims)

    def __len__(self) -> int:
        with self._lock:
            return len(self._engines)

    def keys(self) -> list:
        """Snapshot of the live engine keys (observability: /statusz
        groups pool entries by the mesh-shape key component)."""
        with self._lock:
            return list(self._engines)

    def hbm_resident_bytes(self) -> int:
        """Summed memcap.v1-predicted bytes of the resident engines
        (only engines admitted with a footprint contribute)."""
        with self._lock:
            return int(sum(self._resident.values()))

    def audits(self) -> dict:
        """Each build-time audit and the admission of ``lux_tpu``'s pool:
        the flag that asks for it, whether it asks, and what the port
        does about it."""
        with self._lock:
            ir_audited, ir_undonated, exch_audited, gas_audited = (
                self._ir_audited, self._ir_undonated, self._exch_audited,
                self._gas_audited)
            priced, resident = self._priced, len(self._resident)
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
        from lux_tpu_torch.analysis import memck
        out["memck"] = {"flag": "LUX_MEM_POOL_ADMIT",
                        "requested": flags.get_bool("LUX_MEM_POOL_ADMIT"),
                        "status": MEM_ADMIT_STATUS,
                        "budget_bytes": memck.hbm_budget_bytes(),
                        "priced_builds": priced,
                        "resident_engines": resident,
                        "evictions": int(self._hbm_evictions.value)}
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
            "hbm_resident_bytes": self.hbm_resident_bytes(),
            "hbm_evictions": int(self._hbm_evictions.value),
            "audits": self.audits(),
        }

    def close(self):
        self.sentinel.close()
