"""Programmatic serving session: graph loaded once, engines warm, queries
answered through the micro-batcher.

Query routing:

- ``sssp`` (root queries, the dominant online traversal workload) —
  batchable: K concurrent roots inside one batching window run as ONE
  dense multi-source sweep over ``(nv, K)`` values; a batch of one runs
  on the adaptive single-source ``PushExecutor`` (its sparse tiers beat a
  1-lane dense sweep). Both executors live in the warm pool, so neither
  path is rebuilt after warmup.
- ``pagerank`` — served from the LRU cache of converged results (one
  fixpoint array answers every client at a given iteration count); cache
  misses run the pull executor once.
- ``components`` — root-free like PageRank: one converged labeling is
  cached and sliced per query.
- the GAS programs of the registry: rooted ones (``bfs``,
  ``sssp_delta``) batch like ``sssp``; root-free ones (``labelprop``,
  ``kcore``) are cached fixpoints.

Every result cache key embeds the graph fingerprint
(utils/checkpoint.fingerprint), so answers can never leak across graphs.

Dynamic graphs: the session serves one
:class:`~lux_tpu_torch.graph.snapshot.SnapshotStore` version at a time.
``apply_edits`` stacks an edit batch into version N+1, warms its engines
on a background thread (the old version keeps serving the whole time),
optionally refreshes cached fixpoints incrementally from version N's
values, then atomically flips the serving pointer and rides a barrier
request through the FIFO batcher — by the time the barrier executes,
every in-flight version-N query has been answered, so the barrier can
retire N's engines and evict its cache entries without failing anyone.

The counterpart of ``lux_tpu/serve/session.py``. The session runs on
``cuda`` unless ``device`` names another. Every thread that launches
engine work — the batcher, the hot swap's warm thread, the thread that
called ``apply_edits`` (incremental refresh), a profile capture's HTTP
thread, a breaker probe — does so on a CUDA stream of its own
(``serve/pool.py::engine_stream``) and waits for it before its results
leave the thread.

Profile-guided tuning (``tune/``): with ``LUX_TUNE_DIR`` set, warmup
resolves each served app's ``tuneconf.v1`` artifact for the snapshot
before any engine builds, and every build of that app's engines — in
whichever thread does it: the warmup, a swap's warm thread, a refresh,
a breaker rebuild — runs under the artifact's flag overlay, so the
tuned knobs are captured at build and a query adds no work. An app
without an artifact is a counted fallback to defaults
(``lux_tune_fallback_total{app}``); a swap evicts the old fingerprint's
tuned configs with its engines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.graph.snapshot import Snapshot, SnapshotStore
from lux_tpu_torch.obs import engobs, flight, ledger, metrics, prof, slo, spans
from lux_tpu_torch.serve.batcher import MicroBatcher, Request
from lux_tpu_torch.serve.breaker import CircuitBreaker
from lux_tpu_torch.serve.cache import ResultCache
from lux_tpu_torch.serve.cost import CostAccounts, QueryCost
from lux_tpu_torch.serve.errors import (BadQueryError, QueueFullError,
                                        ServeError, SnapshotSwapError)
from lux_tpu_torch.serve.mesh import plan_cache, serving_mesh
from lux_tpu_torch.serve.pool import EnginePool, engine_stream
from lux_tpu_torch.utils import faults, flags
from lux_tpu_torch.utils.locks import make_lock
from lux_tpu_torch.utils.logging import get_logger
from lux_tpu_torch.utils.platform import resolve_device


class ServeConfig:
    """Serving knobs (one object so the HTTP CLI, tools, and tests agree
    on defaults)."""

    def __init__(
        self,
        max_batch: int = 8,          # K: multi-source lanes per sweep
        window_s: float = 0.003,     # batching window
        max_queue: int = 64,         # admission queue bound
        cache_capacity: int = 256,   # LRU entries
        default_deadline_s: Optional[float] = None,
        pagerank_iters: int = 20,    # served fixpoint depth
        mesh: Optional[str] = None,  # serving mesh spec; None = LUX_SERVE_MESH
    ):
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self.max_queue = int(max_queue)
        self.cache_capacity = int(cache_capacity)
        self.default_deadline_s = default_deadline_s
        self.pagerank_iters = int(pagerank_iters)
        self.mesh = mesh


def _host_values(ex, state) -> np.ndarray:
    """Host-side per-vertex values from an executor state: sharded
    executors unpad their stacked shards (``gather_values``); flat ones
    read theirs back (``values``), both with ``lux_tpu``'s dtypes."""
    if hasattr(ex, "gather_values"):
        return np.asarray(ex.gather_values(state))
    return np.asarray(ex.values(state))


class Session:
    """One served graph: load once, keep engines warm, answer queries.

    Thread-safe: ``submit``/``query`` may be called from any number of
    request threads; engine work funnels through the batcher thread.
    """

    APPS = ("sssp", "components", "pagerank")

    def __init__(
        self,
        graph: Union[Graph, str, SnapshotStore],
        config: Optional[ServeConfig] = None,
        warm: bool = True,
        device=None,
    ):
        self.log = get_logger("serve")
        self.config = config or ServeConfig()
        self.device = resolve_device(device)
        # Resolve the serving mesh up front: engine pool keys embed its
        # shape, so one session serves one mesh for its whole lifetime
        # (P > 1 routes every engine build through the sharded executors
        # + the shard-plan cache).
        self.meshspec = serving_mesh(self.config.mesh, self.device)
        self.graph_path: Optional[str] = None
        if isinstance(graph, SnapshotStore):
            # Crash recovery: serve a store rebuilt by
            # SnapshotStore.recover(base, wal_dir) as-is.
            self.store = graph
        else:
            if isinstance(graph, str):
                from lux_tpu_torch.native import io as native_io

                self.graph_path = graph
                graph = native_io.read_lux(graph)
            self.store = SnapshotStore(graph,
                                       wal_dir=flags.get("LUX_WAL_DIR"))
        self._serving = self.store.current()  # luxlint: publish=_swap_lock
        # The served app list derives from the program registry (every
        # ``servable`` program routes: rooted GAS apps through the
        # micro-batcher, GAS fixpoints through the result cache;
        # weighted-only programs drop off when the graph is unweighted)
        # — shadowing the class-level legacy triple.
        self.APPS, self._gas_rooted, self._gas_fixpoints = (
            self._compute_apps())
        self._degraded = None  # luxlint: publish=_swap_lock
        self._swap_lock = make_lock("session.swap")
        self.breaker = CircuitBreaker(self._breaker_probe)
        self.pool = EnginePool()
        self.cache = ResultCache(self.config.cache_capacity)
        self.batcher = MicroBatcher(
            self._execute_batch,
            max_batch=self.config.max_batch,
            window_s=self.config.window_s,
            max_queue=self.config.max_queue,
        )
        self._requests = metrics.counter("lux_serve_requests_total")
        self._latency = metrics.histogram("lux_serve_request_seconds")
        # app -> reason for every engine that had to drop from the mesh
        # to a single-part build; /statusz turns a non-empty dict into a
        # warning. Leaf lock: writes happen inside pool builds (pool lock
        # held), reads on the /statusz thread — never nest another lock
        # inside.
        self._fallback_lock = make_lock("session.mesh_fallback")
        self._mesh_fallbacks: Dict[str, str] = {}
        # Profile-guided tuning (tune/): (fingerprint, app) ->
        # tuneconf.v1 artifact resolved at warmup. Entries are immutable
        # and only ever swapped whole; reads and writes share the leaf
        # fallback lock.
        self._tuned: Dict[tuple, dict] = {}
        self._tune_fallbacks: Dict[str, str] = {}
        self.slo = slo.SloWindows()
        self.costs = CostAccounts()
        self._served_keys = set()   # batcher-thread only
        self._closed = False
        self._flight_name = f"session:{self.fingerprint[:12]}"
        flight.add_context(self._flight_name, self._flight_context)
        if warm:
            self.warmup()

    # -- serving snapshot ------------------------------------------------

    @property
    def graph(self) -> Graph:
        """The currently served graph (version ``self.version``)."""
        return self._serving.graph

    @property
    def fingerprint(self) -> str:
        return self._serving.fingerprint

    @property
    def version(self) -> int:
        return self._serving.version

    @property
    def degraded(self) -> Optional[dict]:
        """Non-None while the session serves stale: the last attempt to
        warm version N+1 failed, so version N keeps answering (HTTP
        responses carry ``X-Lux-Degraded``). Cleared by the next
        successful swap."""
        return self._degraded

    # -- engines ---------------------------------------------------------

    def _engine_key(self, kind: str, snap: Snapshot, extra=()) -> tuple:
        # The trailing mesh-shape component makes the key the full
        # (program, fingerprint, batch width, mesh shape) tuple: a warm
        # sharded engine can never answer for a single-part one (or for
        # a different mesh), and /statusz groups pool entries by it.
        # Sharded keys also carry the exchange mode captured at build
        # (LUX_EXCHANGE): a full-exchange engine warmed before a flag
        # flip must not answer for compact — the pool warms a fresh
        # entry instead. When the app serves under a tuned config, the
        # artifact's exchange mode wins over the ambient flag: warmup
        # builds inside the tuned overlay and query threads run outside
        # it, so only the artifact keeps the two key computations
        # identical (a mismatch would miss the pool and rebuild per
        # query).
        key = (kind, snap.fingerprint) + tuple(extra)
        if self.sharded:
            from lux_tpu_torch.parallel.shard import exchange_mode

            art = self._tuned_art(extra[0] if extra else None, snap)
            mode = (art or {}).get("config", {}).get("LUX_EXCHANGE") \
                or exchange_mode()
            key = key + (mode,)
        return key + (self.meshspec.shape,)

    @property
    def sharded(self) -> bool:
        return self.meshspec.num_parts > 1

    def _shard_plan(self, snap: Snapshot):
        """The snapshot's partition plan from the process-wide cache —
        every sharded engine for (fingerprint, parts) shares one O(ne)
        host build, and the hot-swap drain evicts it with the engines."""
        return plan_cache().get(
            snap.fingerprint, snap.graph, self.meshspec.num_parts
        )

    def _sharded_kw(self, snap: Snapshot) -> dict:
        return {"mesh": self.meshspec.mesh, "sg": self._shard_plan(snap)}

    def _footprint(self, kind: str, app: str, snap: Snapshot,
                   k: int = 1) -> Optional[int]:
        """Predicted resident bytes of one engine build on the card —
        the committed memcap.v1 admission formula
        (analysis/memck.predicted_engine_bytes), resolved under the
        same exchange mode the engine key carries. The formula is per
        device (one part's share); a sharded build holds its mesh's own
        parts on this card (all P of a LocalMesh), so it is priced at
        that many times the formula. None (pool admits freely) when
        admission is off, the artifact prices nothing for this build, or
        pricing itself fails — pricing is advisory input to admission,
        never a reason a build can't start."""
        if not flags.get_bool("LUX_MEM_POOL_ADMIT"):
            return None
        try:
            from lux_tpu_torch.analysis import memck

            mode, held = "", 1
            rkind = kind + "_sharded" if self.sharded else kind
            if self.sharded:
                from lux_tpu_torch.parallel.mesh import own_parts
                from lux_tpu_torch.parallel.shard import exchange_mode

                art = self._tuned_art(app, snap)
                mode = (art or {}).get("config", {}).get("LUX_EXCHANGE") \
                    or exchange_mode()
                held = len(own_parts(self.meshspec.mesh))
            pred = memck.predicted_engine_bytes(
                app, rkind, mode, snap.graph.nv, snap.graph.ne,
                self.meshspec.num_parts, k=k)
            return None if pred is None else pred * held
        # luxlint: disable=LUX007 -- advisory pricing must never block a build
        except Exception:
            return None

    def _sssp_single(self, snap: Optional[Snapshot] = None):
        from lux_tpu_torch.models.sssp import SSSP

        snap = snap or self._serving
        if self.sharded:
            from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor

            def build():
                return ShardedPushExecutor(snap.graph, SSSP(),
                                           **self._sharded_kw(snap))
        else:
            from lux_tpu_torch.engine.push import PushExecutor

            def build():
                return PushExecutor(snap.graph, SSSP(), device=self.device)
        return self.pool.get(self._engine_key("push", snap, ("sssp", 1)),
                             self._tuned_build("sssp", snap, build),
                             footprint_bytes=self._footprint(
                                 "push", "sssp", snap))

    def _sssp_multi(self, snap: Optional[Snapshot] = None):
        from lux_tpu_torch.models.sssp import SSSP

        snap = snap or self._serving
        k = self.config.max_batch
        if self.sharded:
            from lux_tpu_torch.engine.push_sharded import (
                ShardedMultiSourcePushExecutor)

            def build():
                return ShardedMultiSourcePushExecutor(
                    snap.graph, SSSP(), k=k, **self._sharded_kw(snap))
        else:
            from lux_tpu_torch.engine.push import MultiSourcePushExecutor

            def build():
                return MultiSourcePushExecutor(snap.graph, SSSP(), k=k,
                                               device=self.device)
        return self.pool.get(
            self._engine_key("push_multi", snap, ("sssp", k)),
            self._tuned_build("sssp", snap, build),
            footprint_bytes=self._footprint("push_multi", "sssp", snap, k=k))

    def _components_engine(self, snap: Optional[Snapshot] = None):
        from lux_tpu_torch.models.components import ConnectedComponents

        snap = snap or self._serving
        if self.sharded:
            from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor

            def build():
                return ShardedPushExecutor(snap.graph, ConnectedComponents(),
                                           **self._sharded_kw(snap))
        else:
            from lux_tpu_torch.engine.push import PushExecutor

            def build():
                return PushExecutor(snap.graph, ConnectedComponents(),
                                    device=self.device)
        return self.pool.get(
            self._engine_key("push", snap, ("components", 1)),
            self._tuned_build("components", snap, build),
            footprint_bytes=self._footprint("push", "components", snap))

    def _pagerank_engine(self, snap: Optional[Snapshot] = None):
        from lux_tpu_torch.models.cli import make_executor
        from lux_tpu_torch.models.pagerank import PageRank

        snap = snap or self._serving

        def build():
            if self.graph_path is None or snap.version > 0:
                # The tiled fast path persists its hybrid plan next to
                # the graph file; an in-memory graph has none, and an
                # edited snapshot no longer matches the on-disk plan —
                # both serve from the (sharded, when P > 1) pull engine.
                if self.sharded:
                    from lux_tpu_torch.engine.pull_sharded import \
                        ShardedPullExecutor

                    return ShardedPullExecutor(snap.graph, PageRank(),
                                               **self._sharded_kw(snap))
                from lux_tpu_torch.engine.pull import PullExecutor

                return PullExecutor(snap.graph, PageRank(),
                                    device=self.device)
            import argparse

            # Reuse the CLI's engine-selection policy (tiled when
            # SpMV-shaped; -parts folds the serving mesh) with serving
            # defaults; the plan cache key is the CLI's.
            args = argparse.Namespace(
                parts=self.meshspec.num_parts, layout="auto",
                strategy="rowptr", levels="8/2", tile_mb=8192,
                plan_cache=None, file=self.graph_path,
            )
            return make_executor(snap.graph, PageRank(), args, self.device,
                                 self.log)

        return self.pool.get(
            self._engine_key("pull", snap, ("pagerank",)),
            self._tuned_build("pagerank", snap, build),
            footprint_bytes=self._footprint("pull", "pagerank", snap))

    # -- GAS apps (direction-optimizing adaptive executor) ----------------

    def _compute_apps(self):
        """(apps, rooted_gas, fixpoint_gas) derived from the registry.

        The legacy triple keeps its order (and its dedicated push/pull
        routes below); programs beyond it serve through the adaptive GAS
        executor. Anything marked ``servable = False`` (colfilter: needs
        a bipartite ratings graph, not the served one) is skipped, as are
        weight-consuming programs when the serving graph has no weights.
        """
        from lux_tpu_torch.engine.gas import GasProgram
        from lux_tpu_torch.models import PROGRAMS, capabilities

        weighted = self._serving.graph.weighted
        caps = capabilities()
        legacy = list(Session.APPS)
        apps, rooted, fixpoints = [], [], []
        for name in legacy + sorted(set(PROGRAMS) - set(legacy)):
            cls = PROGRAMS[name]
            if not getattr(cls, "servable", True):
                continue
            if getattr(cls, "needs_weights", False) and not weighted:
                continue
            if name in legacy:
                apps.append(name)
                continue
            if not issubclass(cls, GasProgram):
                continue   # no GAS route for it; not served
            apps.append(name)
            # Rooted routing (multi-source batching vs result-cache
            # fixpoints) follows the capability matrix.
            if caps.get(name, {}).get("rooted",
                                      getattr(cls, "rooted", False)):
                rooted.append(name)
            else:
                fixpoints.append(name)
        return tuple(apps), tuple(rooted), tuple(fixpoints)

    def _gas_program(self, app: str, extra=()):
        """Instantiate the GAS program for ``app``; ``extra`` carries
        per-engine parameters beyond the defaults (kcore's k)."""
        from lux_tpu_torch.engine.gas import as_gas
        from lux_tpu_torch.models import get_program

        if app == "kcore" and extra:
            from lux_tpu_torch.models.kcore import KCore

            return as_gas(KCore(k=int(extra[0])))
        return as_gas(get_program(app))

    def _gas_key_extra(self, app: str, extra=()) -> tuple:
        return (app,) + tuple(extra) + (1,)

    def _note_mesh_fallback(self, app: str, why: str) -> None:
        """Record that ``app`` dropped from the mesh to a single-part
        engine: counter for dashboards, dict for the /statusz warning,
        log line for the operator reading the console."""
        metrics.counter(
            "lux_serve_mesh_fallback_total", {"app": app}).inc()
        with self._fallback_lock:
            self._mesh_fallbacks[app] = why
        self.log.warning(
            "mesh fallback: %s serves on one part of a %d-part mesh: %s",
            app, self.meshspec.num_parts, why)

    def _gas_single(self, app: str, snap: Optional[Snapshot] = None,
                    extra=()):
        from lux_tpu_torch.engine.gas import AdaptiveExecutor

        snap = snap or self._serving
        key = self._engine_key("gas", snap, self._gas_key_extra(app, extra))

        def flat():
            return AdaptiveExecutor(snap.graph, self._gas_program(app, extra),
                                    device=self.device)

        price = self._footprint("gas", app, snap)
        if not self.sharded:
            return self.pool.get(key, self._tuned_build(app, snap, flat),
                                 footprint_bytes=price)
        from lux_tpu_torch.engine.gas_sharded import ShardedAdaptiveExecutor

        def build():
            try:
                return ShardedAdaptiveExecutor(
                    snap.graph, self._gas_program(app, extra),
                    **self._sharded_kw(snap))
            except Exception as e:
                # A single-part answer is still correct; a dead app is
                # not. But the drop must be loud: counted, warned on
                # /statusz, and visible in the log — never silent.
                self._note_mesh_fallback(app, repr(e))
                return flat()

        return self.pool.get(key, self._tuned_build(app, snap, build),
                             footprint_bytes=price)

    def _gas_multi(self, app: str, snap: Optional[Snapshot] = None):
        from lux_tpu_torch.engine.gas import MultiSourceGasExecutor
        from lux_tpu_torch.models import get_program

        snap = snap or self._serving
        k = self.config.max_batch
        key = self._engine_key("gas_multi", snap, (app, k))

        def flat():
            return MultiSourceGasExecutor(snap.graph, get_program(app), k=k,
                                          device=self.device)

        price = self._footprint("gas_multi", app, snap, k=k)
        if not self.sharded:
            return self.pool.get(key, self._tuned_build(app, snap, flat),
                                 footprint_bytes=price)
        from lux_tpu_torch.engine.gas_sharded import (
            ShardedMultiSourceGasExecutor)

        def build():
            try:
                return ShardedMultiSourceGasExecutor(
                    snap.graph, get_program(app), k=k,
                    **self._sharded_kw(snap))
            except Exception as e:
                self._note_mesh_fallback(app + "_multi", repr(e))
                return flat()

        return self.pool.get(key, self._tuned_build(app, snap, build),
                             footprint_bytes=price)

    # -- profile-guided tuning (tune/) -------------------------------------

    def _tune_engine_kind(self, app: str) -> str:
        """The engine kind a tune artifact for ``app`` is keyed under:
        the app's primary serving executor. Layout choice is part of
        the key on purpose — each layout tunes separately."""
        if app == "pagerank":
            base = "pull"
        elif app in ("sssp", "components"):
            base = "push"
        else:
            base = "gas"
        return base + ("_sharded" if self.sharded else "")

    def _tuned_art(self, app, snap: Snapshot) -> Optional[dict]:
        with self._fallback_lock:
            return self._tuned.get((snap.fingerprint, app))

    def _tuned_overlay(self, app: str, snap: Snapshot):
        """Scoped flag overlay applying ``app``'s tuned config so an
        engine *build* captures the tuned knobs (every tuner-managed
        flag is capture-at-build — the tuned path adds no per-query
        work); a no-op when the app serves under defaults."""
        art = self._tuned_art(app, snap)
        if art is None:
            return contextlib.nullcontext()
        return flags.overrides(art["config"])

    def _tuned_build(self, app: str, snap: Snapshot, build):
        """Wrap an engine builder so every pool miss — warmup, a swap's
        warm thread, a refresh, a breaker rebuild, the first use of a
        sibling key — constructs under ``app``'s tuned overlay, entered
        in the thread that builds (the overlay is context-local and
        does not follow a build into another thread)."""
        def wrapped():
            with self._tuned_overlay(app, snap):
                return build()
        return wrapped

    def _load_tuned(self, snap: Snapshot) -> dict:
        """Resolve each served app's ``tuneconf.v1`` artifact for
        ``snap`` from the TuneCache before its engines build. A miss is
        a counted fallback to defaults (``lux_tune_fallback_total``,
        the /statusz tune block) — never silent; an unarmed tuner
        (LUX_TUNE_DIR unset) shows as ``armed: false`` there instead.
        An artifact that exists but does not load raises: a corrupt
        artifact must never silently become a fallback."""
        from lux_tpu_torch.obs import report
        from lux_tpu_torch.tune import key_string, make_key, tune_cache

        tc = tune_cache()
        found: Dict[str, str] = {}
        if not tc.enabled():
            return found
        device_kind = report.device_profile()["device_kind"]
        for app in self.APPS:
            key = make_key(snap.fingerprint, app,
                           self._tune_engine_kind(app),
                           self._mesh_label(), device_kind)
            art = tc.get(key)
            if art is None:
                metrics.counter(
                    "lux_tune_fallback_total", {"app": app}).inc()
                with self._fallback_lock:
                    self._tune_fallbacks[app] = (
                        f"no tuneconf.v1 for {snap.fingerprint[:12]}; "
                        "serving defaults")
                self.log.info(
                    "tune fallback: %s v%d serves under default config "
                    "(no artifact for key %r)", app, snap.version,
                    key_string(key))
                continue
            with self._fallback_lock:
                self._tuned[(snap.fingerprint, app)] = art
                self._tune_fallbacks.pop(app, None)
            found[app] = art["id"]
            self.log.info(
                "tuned config %s for %s v%d: %s (score %.3gs/iter, %d "
                "probes)", art["id"], app, snap.version, art["config"],
                art["score"], len(art.get("score_table") or ()))
        return found

    def tuned_for(self, app: str) -> Optional[dict]:
        """Tune provenance for ``app`` on the serving snapshot
        (``{id, score}`` or None) — the HTTP layer stamps the
        ``X-Lux-Tuned`` response header from it."""
        art = self._tuned_art(str(app), self._serving)
        if art is None:
            return None
        return {"id": art["id"], "score": art["score"]}

    def _tune_block(self) -> dict:
        """The /statusz ``tune`` view: per-app artifact provenance
        (id, score, config, probe count, age), counted fallbacks, cache
        health."""
        from lux_tpu_torch.tune import tune_cache

        snap = self._serving
        # Artifact created_at is unix wall time (tune/artifact.py), so
        # the age math needs the wall clock, not the span epoch.
        now = time.time()  # luxlint: disable=LUX006 -- age vs artifact created_at needs unix wall time
        with self._fallback_lock:
            arts = {app: a for (fp, app), a in self._tuned.items()
                    if fp == snap.fingerprint}
            fallbacks = dict(self._tune_fallbacks)
        return {
            "armed": tune_cache().enabled(),
            "artifacts": {
                app: {"id": a["id"], "score": a["score"],
                      "config": a["config"],
                      "probes": len(a.get("score_table") or ()),
                      "age_s": round(now - float(a.get("created_at",
                                                       now)), 1)}
                for app, a in sorted(arts.items())
            },
            "fallbacks": fallbacks,
            "cache": tune_cache().stats(),
        }

    # -- capabilities and memory views -------------------------------------

    def _programs_block(self) -> dict:
        """The /statusz ``programs`` view: where routing's capability
        matrix came from (the gascap.v1 artifact, or the declarations
        and why), the per-program bits, and the pool's program-audit
        findings."""
        from lux_tpu_torch.models import capability_report

        rep = capability_report()
        return {
            "source": rep["source"],
            "artifact_id": rep["artifact_id"],
            **({"error": rep["error"]} if rep.get("error") else {}),
            "capabilities": rep["programs"],
            "gas_findings": self.pool.stats()["gas_findings"],
        }

    def _memory_block(self) -> dict:
        """The /statusz ``memory`` view: the HBM budget admission runs
        under, the summed memcap.v1-predicted resident bytes, eviction
        pressure, and where the formula came from (artifact id + device
        capacity); with the bytes the caching allocator holds now and at
        its peak (None off the card)."""
        from lux_tpu_torch.analysis import memck
        from lux_tpu_torch.obs import report

        p = self.pool.stats()
        art = memck._committed()
        try:
            budget = memck.hbm_budget_bytes()
        # luxlint: disable=LUX007 -- a broken budget derivation must not break /statusz
        except Exception:
            budget = None
        on_card = self.device.type == "cuda"
        return {
            "admission": flags.get_bool("LUX_MEM_POOL_ADMIT"),
            "budget_bytes": budget,
            "resident_bytes": p["hbm_resident_bytes"],
            "evictions": p["hbm_evictions"],
            "artifact_id": (art or {}).get("id"),
            "hbm_capacity_bytes": report.device_profile()
            .get("hbm_capacity_bytes"),
            "device_allocated_bytes": (
                int(torch.cuda.memory_allocated(self.device))
                if on_card else None),
            "device_peak_bytes": (
                int(torch.cuda.max_memory_allocated(self.device))
                if on_card else None),
        }

    def warmup(self, snap: Optional[Snapshot] = None):
        """Build + warm every served engine before traffic arrives (for
        ``snap``, default the serving snapshot — the hot-swap warms the
        incoming version through this same path). After this, the pool
        miss counter is the rebuild count: the smoke test asserts it
        stays flat across the query phase."""
        snap = snap or self._serving
        t_warm0 = spans.clock()
        # Resolve tuned configs BEFORE any engine builds: each app's
        # engines construct inside its tuned overlay, so the tuner's
        # knobs (all capture-at-build) are baked into the warm engines
        # and the query path builds nothing new.
        tuned = self._load_tuned(snap)
        from lux_tpu_torch.models import capability_report
        caps = capability_report()
        if caps.get("error"):
            self.log.warning("program capabilities: declared fallback "
                             "(%s)", caps["error"])
        else:
            self.log.info("program capabilities: %s %s", caps["source"],
                          caps.get("artifact_id"))

        # An engine the HBM budget refuses must not abort warmup (and
        # with it server boot): warm what fits, count the skips, and let
        # queries for the rest shed per-request with the typed 503.
        def _warm(label, build, *args, **kw):
            from lux_tpu_torch.serve.errors import PoolOverBudgetError

            with _timed(self.log, f"warmup {label}"):
                try:
                    build(*args, **kw)
                except PoolOverBudgetError as e:
                    metrics.counter("lux_pool_hbm_warm_skips_total",
                                    {"engine": label}).inc()
                    self.log.warning("warmup %s skipped: %s", label, e)

        with spans.span("serve.warmup", version=snap.version), \
                engine_stream(self.device):
            faults.point("snapshot.warm")
            _warm("sssp single", self._sssp_single, snap)
            _warm("sssp multi", self._sssp_multi, snap)
            _warm("components", self._components_engine, snap)
            _warm("pagerank", self._pagerank_engine, snap)
            for app in self._gas_rooted:
                _warm(f"{app} gas", self._gas_single, app, snap)
                _warm(f"{app} gas multi", self._gas_multi, app, snap)
            for app in self._gas_fixpoints:
                # kcore's default k is baked into the warm engine key so
                # default-parameter queries hit it; non-default k builds
                # (and warms) a sibling engine on first use.
                extra = (2,) if app == "kcore" else ()
                _warm(f"{app} gas", self._gas_single, app, snap,
                      extra=extra)
        # One durable observation per warmed snapshot: what this config
        # paid to get every served engine built and resident.
        ledger.record_run(
            "serve_warmup",
            {"warm_s": spans.clock() - t_warm0, "version": snap.version,
             "nv": int(snap.graph.nv), "ne": int(snap.graph.ne),
             "apps": list(self.APPS),
             "pool": self.pool.stats()},
            graph_fingerprint=snap.fingerprint, program="serve",
            engine_kind="warmup", mesh_shape=self._mesh_label(),
            tuned=tuned,
        )

    def _mesh_label(self) -> str:
        return "x".join(map(str, self.meshspec.shape))

    # -- query front door ------------------------------------------------

    def submit(
        self,
        app: str,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
        **params,
    ) -> Future:
        """Admit one query; returns a Future resolving to a dict with at
        least ``values`` (np.ndarray) and ``iters``. Raises
        ``BadQueryError`` on malformed queries and ``QueueFullError``
        under overload; the Future raises ``DeadlineExceededError`` when
        shed. ``tenant`` labels the query's cost record (X-Lux-Tenant
        upstream; unlabeled traffic books to the default tenant)."""
        if self._closed:
            raise BadQueryError("session is closed")
        app = str(app)
        if app not in self.APPS:
            raise BadQueryError(
                f"unknown app {app!r}; serving {list(self.APPS)}"
            )
        cost = QueryCost(tenant, app)
        self._requests.inc()
        metrics.counter(
            "lux_serve_requests_total", {"app": app}
        ).inc()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        deadline = (
            spans.monotonic() + deadline_s if deadline_s is not None
            else None
        )
        t0 = spans.clock()
        # Programmatic callers have no HTTP root span: the session mints
        # the trace and closes its record when the future resolves, so
        # batcher/engine spans still share one trace-id.
        finish = None
        token = None
        if spans.current_trace_id() is None and spans.enabled():
            tid, finish = spans.open_trace()
            token = spans.activate(tid)
        # One read of the serving pointer per request: everything below
        # (cache keys, batch keys, engine lookups) binds to this snapshot,
        # so a hot-swap mid-request can never mix versions.
        snap = self._serving
        try:
            # Shed instantly while this (app, fingerprint)'s breaker is
            # open — no queue slot, no batcher time for an engine known
            # to be failing (503 + Retry-After upstream).
            self.breaker.check((app, snap.fingerprint))
            if app == "sssp":
                fut = self._submit_rooted(app, params, deadline, snap, cost)
            elif app == "components":
                fut = self._submit_cached_fixpoint(
                    app, ("components",),
                    lambda dl=None: self._run_components(snap, dl),
                    deadline, snap, cost,
                )
            elif app == "pagerank":
                ni = int(params.get("ni", self.config.pagerank_iters))
                if ni < 1:
                    raise BadQueryError(
                        f"pagerank ni must be >= 1 (got {ni})"
                    )
                fut = self._submit_cached_fixpoint(
                    app, ("pagerank", ni),
                    lambda dl=None: self._run_pagerank(ni, snap, dl),
                    deadline, snap, cost,
                )
            elif app in self._gas_rooted:
                fut = self._submit_rooted(app, params, deadline, snap, cost)
            elif app == "kcore":
                try:
                    k = int(params.get("k", 2))
                except (TypeError, ValueError):
                    raise BadQueryError("kcore k must be an integer")
                if k < 1:
                    raise BadQueryError(
                        f"kcore k must be >= 1 (got {k})"
                    )
                fut = self._submit_cached_fixpoint(
                    app, ("kcore", k),
                    lambda dl=None: self._run_gas_fixpoint(
                        app, snap, dl, extra=(k,)),
                    deadline, snap, cost,
                )
            else:
                # Remaining registry-derived fixpoints (labelprop today).
                fut = self._submit_cached_fixpoint(
                    app, (app,),
                    lambda dl=None: self._run_gas_fixpoint(app, snap, dl),
                    deadline, snap, cost,
                )
        except BaseException:
            if token is not None:
                spans.deactivate(token)
            if finish is not None:
                finish()
            raise
        if token is not None:
            spans.deactivate(token)

        def _done(f, app=app, t0=t0, finish=finish, cost=cost):
            dt = spans.clock() - t0
            self._latency.observe(dt)
            self.slo.observe(app, dt)
            # The batcher thread finished filling the cost record before
            # it resolved the future; book it to the tenant now (shed or
            # failed queries still consumed admission — they book their
            # accumulated, possibly zero, engine spend).
            cost.latency_s = dt
            self.costs.observe(cost)
            if finish is not None:
                finish()

        fut._lux_cost = cost   # readers: HTTP front door (X-Lux-Cost)
        fut.add_done_callback(_done)
        return fut

    def query(self, app: str, timeout: Optional[float] = None, **params):
        """Synchronous ``submit``; blocks for the result."""
        return self.submit(app, **params).result(timeout=timeout)

    def _submit_rooted(self, app: str, params: dict, deadline,
                       snap: Snapshot, cost: QueryCost) -> Future:
        """Rooted apps (sssp, and the rooted GAS apps bfs, sssp_delta)
        share the micro-batch machinery: per-root result cache,
        fingerprinted batch key, K-lane dense sweep when a window
        coalesces."""
        try:
            start = int(params["start"])
        except (KeyError, TypeError, ValueError):
            raise BadQueryError(f"{app} needs an integer 'start' root")
        nv = snap.graph.nv
        if not 0 <= start < nv:
            raise BadQueryError(
                f"{app} start {start} out of range [0, {nv})"
            )
        key = (snap.fingerprint, app, start)
        hit = self.cache.get(key)
        if hit is not None:
            cost.outcome = "hit"     # zero engine spend: the cache paid
            fut: Future = Future()
            fut.set_result(hit)
            return fut
        # The batch key embeds the snapshot fingerprint: queries straddling
        # a hot-swap can never share one dense sweep across two graphs.
        req = Request(
            app=app, payload=(snap, start),
            batch_key=(app, snap.fingerprint, self.config.max_batch),
            deadline=deadline, cost=cost,
        )
        return self.batcher.submit(req)

    def _submit_cached_fixpoint(self, app, key_tail, run, deadline,
                                snap: Snapshot, cost: QueryCost) -> Future:
        key = (snap.fingerprint,) + tuple(key_tail)
        hit = self.cache.get(key)
        if hit is not None:
            cost.outcome = "hit"
            fut: Future = Future()
            fut.set_result(hit)
            return fut
        req = Request(app=app, payload=(key, run), batch_key=None,
                      deadline=deadline, cost=cost)
        return self.batcher.submit(req)

    # -- batcher executor callback ---------------------------------------

    @contextlib.contextmanager
    def _watched(self, key):
        """Recompile-sentinel region for one engine execution, on this
        thread's stream. A key's first served execution counts as
        warmup; every later execution promises zero compiles — the "zero
        recompiles after the first batch" serving contract."""
        # luxlint: disable=LUX301 -- _served_keys is batcher-thread-only
        if key in self._served_keys:
            with self.pool.sentinel.watch(key), engine_stream(self.device):
                yield
        else:
            with self.pool.sentinel.expect(key), \
                    engine_stream(self.device):
                yield
            # luxlint: disable=LUX301 -- _watched only runs on the batcher thread
            self._served_keys.add(key)

    def _engine_execute(self, app: str, snap: Snapshot, key, deadline, fn):
        """One engine execution with fault injection, bounded
        retry-with-backoff, and circuit-breaker accounting.

        Transient (non-ServeError) failures retry up to LUX_RETRY_MAX
        times with doubling LUX_RETRY_BACKOFF_MS backoff, clamped by the
        batch's deadline — a retry that could not start before the
        deadline fails now instead of burning engine time on an answer
        nobody is waiting for. Terminal failures feed the breaker for
        ``(app, fingerprint)``; successes reset it."""
        bkey = (app, snap.fingerprint)
        attempts = 1 + max(0, flags.get_int("LUX_RETRY_MAX"))
        backoff_s = max(0.0, flags.get_float("LUX_RETRY_BACKOFF_MS")) / 1e3
        for attempt in range(1, attempts + 1):
            try:
                with self._watched(key):
                    faults.point("serve.engine.execute")
                    with prof.region("lux.serve.execute"):
                        out = fn()
            except ServeError:
                raise             # shed/typed errors are not engine faults
            except Exception as e:
                exhausted = attempt >= attempts or (
                    deadline is not None
                    and spans.monotonic() + backoff_s > deadline)
                if exhausted:
                    self.breaker.record_failure(bkey, error=e)
                    raise
                metrics.counter("lux_serve_retries_total",
                                {"app": app}).inc()
                self.log.warning(
                    "engine %s attempt %d/%d failed (%r); retrying in "
                    "%d ms", app, attempt, attempts, e,
                    int(backoff_s * 1e3))
                time.sleep(backoff_s)
                backoff_s *= 2
            else:
                self.breaker.record_success(bkey)
                return out

    def _charge_batch(self, batch: List[Request], ex, iters: int,
                      engine_s: float, switches: int = 0) -> None:
        """Split one engine execution's cost evenly across the batch so
        per-query charges sum to the batch totals (the /costz parity
        invariant). Exchange bytes come from the sharded executor's
        dense estimate; single-part engines exchange nothing."""
        n = max(1, len(batch))
        exch_total = 0
        fn = getattr(ex, "exchange_bytes_per_iter", None)
        if fn is not None:
            try:
                exch_total = int(fn()) * int(iters)
            except Exception:
                exch_total = 0
        for i, r in enumerate(batch):
            if r.cost is None:
                continue
            # Integer bytes: the first member absorbs the remainder so
            # the shares sum exactly to the total.
            share = exch_total // n + (exch_total % n if i == 0 else 0)
            r.cost.charge(
                iterations=int(iters), engine_s=engine_s / n,
                exchange_bytes=share, direction_switches=int(switches),
            )

    def _cache_put(self, key, value) -> None:
        """Cache insert that degrades instead of failing the request: a
        computed answer is never thrown away because the cache hiccuped
        (serving correctness never depends on the cache — a failed put
        only costs a future recompute)."""
        try:
            self.cache.put(key, value)
        except Exception as e:
            metrics.counter("lux_serve_cache_put_errors_total").inc()
            self.log.warning("cache put failed for %r: %r", key, e)

    def _execute_batch(self, batch: List[Request]):
        # The batcher thread's engine work, pool misses included, runs on
        # its own stream.
        with engine_stream(self.device):
            self._execute(batch)

    def _execute(self, batch: List[Request]):
        if batch[0].app == "sssp":
            self._execute_sssp_batch(batch)
            return
        if batch[0].app in self._gas_rooted:
            self._execute_gas_batch(batch)
            return
        if batch[0].app == "_drain":
            # Hot-swap barrier: FIFO ordering means every request admitted
            # before the swap flipped the serving pointer has already been
            # executed by the time this runs — retiring the old version's
            # state here can fail no in-flight query.
            batch[0].future.set_result(batch[0].payload())
            return
        # Unbatchable request (singleton list): cached fixpoint runner.
        (key, run) = batch[0].payload
        cost = batch[0].cost
        hit = self.cache.get(key)   # raced submits may have filled it
        if hit is None:
            t0 = spans.clock()
            hit = run(batch[0].deadline)
            if cost is not None:
                cost.charge(
                    iterations=int(hit.get("iters", 0)),
                    engine_s=spans.clock() - t0,
                    direction_switches=int(
                        hit.get("direction_switches", 0)),
                )
            self._cache_put(key, hit)
        elif cost is not None:
            cost.outcome = "hit"     # a raced submit filled the cache
        batch[0].future.set_result(hit)

    @staticmethod
    def _batch_deadline(batch: List[Request]) -> Optional[float]:
        """A retry must respect the tightest deadline riding the batch."""
        deadlines = [r.deadline for r in batch if r.deadline is not None]
        return min(deadlines) if deadlines else None

    def _lanes(self, ex, state, n: int) -> list:
        """The first ``n`` lanes of a multi-source state on the host.
        Sharded lanes: one gather + unpad for the whole batch, then
        column slices — not ``n`` separate transfers."""
        if hasattr(ex, "gather_values"):
            allv = ex.gather_values(state)
            return [np.ascontiguousarray(allv[:, j]) for j in range(n)]
        return [ex.values_for(state, j) for j in range(n)]

    def _execute_sssp_batch(self, batch: List[Request]):
        snap = batch[0].payload[0]   # batch_key pins one snapshot per batch
        roots = [r.payload[1] for r in batch]
        deadline = self._batch_deadline(batch)
        if len(batch) == 1:
            key = self._engine_key("push", snap, ("sssp", 1))
            ex = self._sssp_single(snap)

            def run_engine():
                with spans.span("serve.engine", app="sssp", engine="push",
                                lanes=1):
                    state, iters = ex.run(start=roots[0])
                    return [_host_values(ex, state)], int(iters)
        else:
            key = self._engine_key(
                "push_multi", snap, ("sssp", self.config.max_batch)
            )
            ex = self._sssp_multi(snap)

            def run_engine():
                with spans.span("serve.engine", app="sssp",
                                engine="push_multi", lanes=len(roots)):
                    state, iters = ex.run(roots)
                    return self._lanes(ex, state, len(roots)), int(iters)
        t0 = spans.clock()
        results, iters = self._engine_execute(
            "sssp", snap, key, deadline, run_engine)
        self._charge_batch(batch, ex, iters, spans.clock() - t0)
        for r, root, vals in zip(batch, roots, results):
            out = {"values": vals, "iters": iters, "start": root}
            self._cache_put((snap.fingerprint, "sssp", root), out)
            r.future.set_result(out)

    def _execute_gas_batch(self, batch: List[Request]):
        """Rooted GAS batch: one lane runs the direction-adaptive engine
        (and reports its push/pull split); a coalesced window runs the
        K-lane dense multi-source sweep. Per-root host finalization
        (BFS parents, ...) merges into each result dict."""
        app = batch[0].app
        snap = batch[0].payload[0]
        roots = [r.payload[1] for r in batch]
        deadline = self._batch_deadline(batch)
        prog = self._gas_program(app)
        if len(batch) == 1:
            key = self._engine_key("gas", snap, self._gas_key_extra(app))
            ex = self._gas_single(app, snap)

            def run_engine():
                with spans.span("serve.engine", app=app, engine="gas",
                                lanes=1):
                    state, iters = ex.run(start=roots[0])
                    dirs = {
                        "direction_push": int(ex.push_iters),
                        "direction_pull": int(ex.pull_iters),
                        "direction_switches": int(ex.direction_switches),
                    }
                    return [_host_values(ex, state)], int(iters), dirs
        else:
            key = self._engine_key(
                "gas_multi", snap, (app, self.config.max_batch)
            )
            ex = self._gas_multi(app, snap)

            def run_engine():
                with spans.span("serve.engine", app=app,
                                engine="gas_multi", lanes=len(roots)):
                    state, iters = ex.run(roots)
                    return self._lanes(ex, state, len(roots)), int(iters), {}
        t0 = spans.clock()
        results, iters, dirs = self._engine_execute(
            app, snap, key, deadline, run_engine)
        self._charge_batch(batch, ex, iters, spans.clock() - t0,
                           switches=dirs.get("direction_switches", 0))
        for r, root, vals in zip(batch, roots, results):
            out = {"values": vals, "iters": iters, "start": root}
            out.update(dirs)
            out.update(prog.finalize_host(snap.graph, vals))
            self._cache_put((snap.fingerprint, app, root), out)
            r.future.set_result(out)

    def _run_components(self, snap: Snapshot,
                        deadline: Optional[float] = None) -> dict:
        ex = self._components_engine(snap)
        key = self._engine_key("push", snap, ("components", 1))

        def run_engine():
            with spans.span("serve.engine", app="components",
                            engine="push"):
                state, iters = ex.run()
                return {"values": _host_values(ex, state),
                        "iters": int(iters)}

        return self._engine_execute("components", snap, key, deadline,
                                    run_engine)

    def _run_pagerank(self, ni: int, snap: Snapshot,
                      deadline: Optional[float] = None) -> dict:
        from lux_tpu_torch.models.cli import final_values

        ex = self._pagerank_engine(snap)
        key = self._engine_key("pull", snap, ("pagerank",))

        def run_engine():
            with spans.span("serve.engine", app="pagerank", engine="pull",
                            iters=ni):
                vals = ex.run(ni)
                return {"values": final_values(ex, vals), "iters": ni}

        return self._engine_execute("pagerank", snap, key, deadline,
                                    run_engine)

    def _run_gas_fixpoint(self, app: str, snap: Snapshot,
                          deadline: Optional[float] = None,
                          extra=()) -> dict:
        """Root-free GAS fixpoint (labelprop, kcore): one adaptive run
        to convergence, host finalization merged into the cached dict."""
        ex = self._gas_single(app, snap, extra=extra)
        key = self._engine_key("gas", snap, self._gas_key_extra(app, extra))
        prog = self._gas_program(app, extra)

        def run_engine():
            with spans.span("serve.engine", app=app, engine="gas"):
                state, iters = ex.run()
                vals = _host_values(ex, state)
                out = {
                    "values": vals, "iters": int(iters),
                    "direction_push": int(ex.push_iters),
                    "direction_pull": int(ex.pull_iters),
                    "direction_switches": int(ex.direction_switches),
                }
                out.update(prog.finalize_host(snap.graph, vals))
                return out

        return self._engine_execute(app, snap, key, deadline, run_engine)

    # -- circuit-breaker probe ---------------------------------------------

    def _breaker_probe(self, bkey) -> bool:
        """Half-open probe (background thread): rebuild the tripped
        program's pool entry and prove ONE execution before the breaker
        closes and traffic returns. Runs under the sentinel's expect —
        a rebuild is warmup."""
        app, fp = bkey
        snap = self._serving
        if snap.fingerprint != fp:
            return True   # that snapshot swapped away; nothing to rebuild
        if app == "sssp":
            key = self._engine_key("push", snap, ("sssp", 1))
            get, run = self._sssp_single, (lambda ex: ex.run(start=0))
        elif app == "components":
            key = self._engine_key("push", snap, ("components", 1))
            get, run = self._components_engine, (lambda ex: ex.run())
        elif app in self._gas_rooted:
            key = self._engine_key("gas", snap, self._gas_key_extra(app))

            def get(s):
                return self._gas_single(app, s)

            def run(ex):
                return ex.run(start=0)
        elif app in self._gas_fixpoints:
            extra = (2,) if app == "kcore" else ()
            key = self._engine_key(
                "gas", snap, self._gas_key_extra(app, extra))

            def get(s):
                return self._gas_single(app, s, extra=extra)

            def run(ex):
                return ex.run()
        else:
            key = self._engine_key("pull", snap, ("pagerank",))
            get, run = self._pagerank_engine, (lambda ex: ex.run(1))
        with spans.span("serve.breaker_probe", app=app), \
                engine_stream(self.device):
            self.pool.retire(lambda k: k == key)
            ex = get(snap)
            with self.pool.sentinel.expect(("probe",) + key):
                faults.point("serve.engine.execute")
                run(ex)
        return True

    # -- snapshot hot-swap -----------------------------------------------

    def apply_edits(self, edits, warm_timeout: Optional[float] = None) -> dict:
        """Apply an edit batch and hot-swap serving onto version N+1.

        Sequence (one swap at a time; version N serves throughout):

        1. ``store.apply(edits)`` mints version N+1 (compaction, if the
           delta crossed LUX_DELTA_COMPACT_RATIO, proceeds in its own
           background thread — readers are unaffected either way);
        2. N+1's engines build + warm on a background warm thread,
           bounded by LUX_SNAPSHOT_WARM_TIMEOUT — on timeout or error the
           swap aborts with :class:`SnapshotSwapError` and N keeps
           serving *degraded* (see :attr:`degraded`; N+1 stays minted
           and durable — retry with :meth:`flush_edits`, never by
           re-sending the same edits);
        3. with LUX_INCREMENTAL, cached components/SSSP fixpoints are
           refreshed by warm-started incremental runs and stored under
           N+1's fingerprint *before* the flip (PageRank entries are
           evicted, not refreshed: its served semantics are
           ni-iterations-from-init, which a warm start cannot reproduce
           mid-trajectory — misses recompute on demand);
        4. the serving pointer flips (atomic assignment; every request
           reads it once at admission);
        5. a barrier request rides the FIFO batcher behind all remaining
           version-N work, then retires N's engines and evicts its cache
           entries — zero failed in-flight queries by construction.

        With a WAL armed (LUX_WAL_DIR), ``edits`` is appended (CRC-framed,
        fsync'd) *before* version N+1 is minted, so a crash anywhere in
        the swap loses nothing: :meth:`SnapshotStore.recover` replays the
        log to the exact minted state.

        Returns a summary dict (versions, fingerprints, eviction counts,
        incremental-refresh counts, timings).
        """
        from lux_tpu_torch.graph.delta import EdgeEdits

        if not isinstance(edits, EdgeEdits):
            raise BadQueryError("apply_edits takes an EdgeEdits batch")
        return self._swap_entry(edits, edits, warm_timeout)

    def enqueue_edits(self, edits) -> dict:
        """Durably queue one batch behind the WAL *without* swapping.

        Many small batches coalesce and the next :meth:`flush_edits` (or
        ``apply_edits``) folds them into ONE hot-swap — one warm, one
        flip, one drain. Auto-flushes once LUX_EDIT_QUEUE_MAX batches are
        pending."""
        from lux_tpu_torch.graph.delta import EdgeEdits

        if self._closed:
            raise BadQueryError("session is closed")
        if not isinstance(edits, EdgeEdits):
            raise BadQueryError("enqueue_edits takes an EdgeEdits batch")
        try:
            pending = self.store.enqueue(edits)
        except ValueError as e:
            raise BadQueryError(str(e)) from None
        metrics.gauge("lux_serve_pending_edits").set(pending)
        if pending >= max(1, flags.get_int("LUX_EDIT_QUEUE_MAX")):
            return self.flush_edits()
        return {"queued": True, "pending": pending,
                "version": self.version}

    def flush_edits(self, warm_timeout: Optional[float] = None) -> dict:
        """Fold every enqueued batch into one hot-swap (no-op if none).

        Incremental cache refresh applies when exactly one batch is
        pending (the refresh needs the batch's edge lists); multi-batch
        flushes degrade to evict-only, which is always correct.

        This is also the *revalidate* half of stale-while-revalidate:
        after an aborted swap the minted version is still the store head
        (its edits are durable), so a flush with an empty queue re-warms
        and flips onto it rather than re-applying anything."""
        batches = self.store.pending_batches()
        if not batches and self.store.current().version == self.version:
            return {"queued": False, "pending": 0, "version": self.version,
                    "noop": True}
        refresh = batches[0] if len(batches) == 1 else None
        return self._swap_entry(None, refresh, warm_timeout)

    def _swap_entry(self, edits, refresh_edits,
                    warm_timeout: Optional[float]) -> dict:
        if self._closed:
            raise BadQueryError("session is closed")
        if warm_timeout is None:
            warm_timeout = flags.get_float("LUX_SNAPSHOT_WARM_TIMEOUT")
        with self._swap_lock:
            t_swap0 = spans.clock()
            old = self._serving
            finish = None
            token = None
            if spans.current_trace_id() is None and spans.enabled():
                tid, finish = spans.open_trace()
                token = spans.activate(tid)
            try:
                with spans.span("serve.snapshot_swap",
                                old_version=old.version):
                    summary = self._swap(old, edits, refresh_edits,
                                         warm_timeout, t_swap0)
            finally:
                if token is not None:
                    spans.deactivate(token)
                if finish is not None:
                    finish()
            return summary

    def _swap(self, old: Snapshot, edits, refresh_edits,
              warm_timeout: float, t_swap0: float) -> dict:
        try:
            snap = self.store.apply(edits)
        except ValueError as e:
            raise BadQueryError(str(e)) from None
        metrics.gauge("lux_serve_pending_edits").set(0)
        if snap.version == old.version:
            # flush_edits raced another flush; the queue was empty.
            return {"queued": False, "pending": 0, "version": old.version,
                    "noop": True}
        apply_s = spans.clock() - t_swap0

        # Warm version N+1's engines off-thread so a stuck build can't
        # wedge the session; the sentinel sees the builds as expected
        # warmup (pool.get wraps them in expect(key)).
        hbm_evictions0 = self.pool.stats()["hbm_evictions"]
        warm_err: List[BaseException] = []
        tid = spans.current_trace_id()

        def _warm():
            with spans.adopt(tid):
                with spans.span("serve.snapshot_warm",
                                version=snap.version):
                    try:
                        self.warmup(snap)
                    except BaseException as e:   # surfaced to the caller
                        warm_err.append(e)

        t_warm0 = spans.clock()
        warm_thread = threading.Thread(
            target=_warm, name=f"lux-snapshot-warm-v{snap.version}",
            daemon=True,
        )
        warm_thread.start()
        warm_thread.join(warm_timeout)
        warm_s = spans.clock() - t_warm0
        if warm_err and isinstance(warm_err[0], faults.CrashPoint):
            # An injected crash is process death, not a degradable
            # failure: re-raise it past every handler (BaseException) so
            # the harness exercises WAL recovery. The edits are already
            # durable — logged and committed before the warm started.
            raise warm_err[0]
        if warm_thread.is_alive() or warm_err:
            metrics.counter("lux_snapshot_aborts_total").inc()
            why = (f"warmup timed out after {warm_timeout:.1f}s"
                   if warm_thread.is_alive()
                   else f"warmup failed: {warm_err[0]!r}")
            self.log.error("snapshot swap v%d -> v%d aborted: %s",
                           old.version, snap.version, why)
            self._mark_degraded(why, old, snap)
            flight.dump("snapshot_swap_aborted", detail=why)
            raise SnapshotSwapError(
                f"snapshot v{snap.version} not swapped in ({why}); "
                f"v{old.version} still serving"
            )

        refreshed = None
        t_ref0 = spans.clock()
        # Sharded serving degrades to evict-only: the incremental
        # executor warm-starts flat single-device states, which don't
        # compose with the padded per-shard layout. Eviction is always
        # correct — the warmed mesh of N+1 engines is already in the
        # pool by this point, so the flip still costs zero rebuilds.
        if (flags.get_bool("LUX_INCREMENTAL") and refresh_edits is not None
                and self.meshspec.num_parts == 1):
            try:
                refreshed = self._incremental_refresh(old, snap,
                                                      refresh_edits)
            except Exception as e:
                # The refresh is an optimization over evict-and-recompute;
                # a minted, durable version must not be abandoned because
                # warm-starting caches failed. Degrade to evict-only.
                metrics.counter("lux_serve_refresh_errors_total").inc()
                flight.dump("incremental_refresh_failed", detail=repr(e))
                self.log.warning(
                    "incremental refresh v%d failed (%r); serving "
                    "evict-only", snap.version, e)
                refreshed = None
        refresh_s = spans.clock() - t_ref0

        # The atomic flip: requests admitted after this line bind to N+1.
        t_flip0 = spans.clock()
        self._serving = snap  # luxlint: guarded-by=_swap_lock -- apply_edits holds it
        self._degraded = None  # luxlint: guarded-by=_swap_lock -- _swap_entry holds it
        metrics.gauge("lux_serve_degraded").set(0.0)
        metrics.gauge("lux_snapshot_version").set(float(snap.version))
        metrics.counter("lux_snapshot_applies_total").inc()

        drained = self._drain_behind(old)
        flip_s = spans.clock() - t_flip0
        # HBM-budget evictions during this swap's warm: N+1's engines
        # admitting over N's residents show up here (and as
        # X-Lux-Evicted on the HTTP swap response).
        drained["hbm_evicted"] = (self.pool.stats()["hbm_evictions"]
                                  - hbm_evictions0)
        swap_s = spans.clock() - t_swap0
        metrics.histogram("lux_snapshot_swap_seconds").observe(swap_s)
        self.log.info(
            "snapshot swap v%d -> v%d in %.2fs (apply %.2fs, warm %.2fs, "
            "refresh %.2fs, flip+drain %.2fs; evicted %d cache entries, "
            "retired %d engines)",
            old.version, snap.version, swap_s, apply_s, warm_s, refresh_s,
            flip_s, drained["evicted"], drained["retired"],
        )
        return {
            "old_version": old.version,
            "version": snap.version,
            "old_fingerprint": old.fingerprint,
            "fingerprint": snap.fingerprint,
            "nv": snap.graph.nv,
            "ne": snap.graph.ne,
            "delta_ratio": round(snap.ratio, 6),
            "apply_s": apply_s,
            "warm_s": warm_s,
            "refresh_s": refresh_s,
            "flip_s": flip_s,
            "swap_s": swap_s,
            "refreshed": refreshed,
            **drained,
        }

    def _mark_degraded(self, why: str, old: Snapshot,
                       snap: Snapshot) -> None:
        """Stale-while-revalidate: ``old`` keeps serving, responses grow
        an X-Lux-Degraded header until a later swap lands."""
        self._degraded = {  # luxlint: guarded-by=_swap_lock -- _swap holds it
            "reason": why, "stale_version": old.version,
            "failed_version": snap.version, "since": spans.clock(),
        }
        metrics.gauge("lux_serve_degraded").set(1.0)

    def _drain_behind(self, old: Snapshot) -> dict:
        """Ride a barrier through the FIFO batcher behind every remaining
        version-``old`` request, then retire that version's state."""
        old_fp = old.fingerprint

        def _retire() -> dict:
            evicted = self.cache.evict_fingerprint(old_fp)
            retired = self.pool.retire(
                lambda k: isinstance(k, tuple) and len(k) > 1
                and k[1] == old_fp
            )
            # _served_keys is batcher-thread-only state and the barrier
            # runs on the batcher thread: prune without a lock.
            # luxlint: disable=LUX301 -- barrier runs on the batcher thread
            stale = {k for k in self._served_keys
                     if isinstance(k, tuple) and len(k) > 1
                     and k[1] == old_fp}
            # luxlint: disable=LUX301 -- barrier runs on the batcher thread
            self._served_keys -= stale
            # The outgoing snapshot's partition plans go with its
            # engines — a sharded swap atomically replaces the whole
            # mesh of engines plus the host-side plan they shared.
            plans = plan_cache().evict_fingerprint(old_fp)
            # Tuned configs are fingerprint-keyed like shard plans:
            # version N's artifacts must not influence N+1's engine keys
            # or overlays (the disk artifacts stay — they are evidence).
            from lux_tpu_torch.tune import tune_cache

            tunes = tune_cache().evict_fingerprint(old_fp)
            with self._fallback_lock:
                stale_tunes = [k for k in self._tuned if k[0] == old_fp]
                for k in stale_tunes:
                    del self._tuned[k]
            return {"evicted": evicted, "retired": retired,
                    "plans_evicted": plans,
                    "tunes_evicted": tunes + len(stale_tunes)}

        while True:
            try:
                fut = self.batcher.submit(Request(
                    app="_drain", payload=_retire, batch_key=None,
                ))
                break
            except QueueFullError:
                # The queue is full of real traffic; the barrier must
                # still land (it frees the old snapshot), so back off
                # briefly and retry — admission is FIFO either way.
                time.sleep(0.01)
        return fut.result()

    def _incremental_refresh(self, old: Snapshot, snap: Snapshot,
                             edits) -> dict:
        """Warm-start cached fixpoints from version N's values and store
        them under N+1's fingerprint before the flip.

        Components and cached SSSP roots refresh bitwise (monotone push
        programs; engine/incremental.py proves the warm start exact).
        Cached SSSP roots ride the dense (nv, K) multi-source sweep in
        K-wide batches — the same warmed engine the serving path uses,
        so the refresh builds nothing.
        """
        from lux_tpu_torch.engine.incremental import IncrementalExecutor
        from lux_tpu_torch.graph.delta import removed_edges
        from lux_tpu_torch.models import incremental_ok
        from lux_tpu_torch.models.components import ConnectedComponents
        from lux_tpu_torch.models.sssp import SSSP

        removed = removed_edges(old.graph, edits.del_src, edits.del_dst)
        inserted = (edits.ins_src, edits.ins_dst)
        out = {"components": 0, "sssp": 0, "touched_frac": None}

        with spans.span("serve.incremental_refresh", version=snap.version), \
                engine_stream(self.device):
            # Warm-start eligibility is the program's declared license
            # (models.incremental_ok); a program without it falls back to
            # the cold recompute path instead of tripping the
            # IncrementalExecutor contract gate mid-swap.
            cc_hit = (self.cache.get((old.fingerprint, "components"))
                      if incremental_ok("components") else None)
            if cc_hit is not None:
                ex = self._components_engine(snap)
                inc = IncrementalExecutor(
                    snap.graph, ConnectedComponents(), push=ex
                )
                key = self._engine_key("push", snap, ("components", 1))
                with self.pool.sentinel.expect(("incremental",) + key), \
                        spans.span("serve.incremental", app="components"):
                    state, iters, info = inc.run(
                        cc_hit["values"], removed=removed,
                        inserted=inserted,
                    )
                self._cache_put(
                    (snap.fingerprint, "components"),
                    {"values": ex.values(state),
                     "iters": int(iters), "incremental": True},
                )
                out["components"] = 1
                out["touched_frac"] = info["touched_frac"]

            roots = [
                k[2] for k in self.cache.keys()
                if isinstance(k, tuple) and len(k) == 3
                and k[0] == old.fingerprint and k[1] == "sssp"
            ] if incremental_ok("sssp") else []
            if roots:
                k_w = self.config.max_batch
                multi = self._sssp_multi(snap)
                inc = IncrementalExecutor(snap.graph, SSSP(),
                                          push=self._sssp_single(snap),
                                          multi=multi)
                mkey = self._engine_key("push_multi", snap, ("sssp", k_w))
                for i in range(0, len(roots), k_w):
                    lane_roots, olds = [], []
                    for r in roots[i:i + k_w]:
                        hit = self.cache.get((old.fingerprint, "sssp", r))
                        if hit is not None:   # LRU may race entries away
                            lane_roots.append(r)
                            olds.append(hit["values"])
                    if not lane_roots:
                        continue
                    with self.pool.sentinel.expect(
                            ("incremental",) + mkey), \
                            spans.span("serve.incremental", app="sssp",
                                       lanes=len(lane_roots)):
                        state, iters, info = inc.run_multi(
                            lane_roots, olds, removed=removed,
                            inserted=inserted,
                        )
                    for j, r in enumerate(lane_roots):
                        self._cache_put(
                            (snap.fingerprint, "sssp", r),
                            {"values": multi.values_for(state, j),
                             "iters": int(iters), "start": r,
                             "incremental": True},
                        )
                    out["sssp"] += len(lane_roots)
                    out["touched_frac"] = info["touched_frac"]
        return out

    def snapshot_info(self) -> dict:
        """The /snapshot GET payload: serving version + store history."""
        snap = self._serving
        return {
            "version": snap.version,
            "fingerprint": snap.fingerprint,
            "nv": snap.graph.nv,
            "ne": snap.graph.ne,
            "delta_ratio": round(snap.ratio, 6),
            "compacted": snap.compacted,
            "history": self.store.history(),
            "pending_edits": self.store.pending_edits(),
            "wal": self.store.wal_stats(),
        }

    # -- introspection / lifecycle ---------------------------------------

    def _mesh_block(self) -> dict:
        """The serving-mesh view shared by ``stats`` and ``/statusz``:
        mesh spec/shape plus live pool entries grouped by the mesh-shape
        component of their key (a hot-swap mid-drain shows both the
        incoming and outgoing mesh populations here)."""
        by_shape: Dict[str, int] = {}
        for k in self.pool.keys():
            shape = (k[-1] if isinstance(k, tuple) and k
                     and isinstance(k[-1], tuple) else None)
            label = "x".join(map(str, shape)) if shape else "?"
            by_shape[label] = by_shape.get(label, 0) + 1
        with self._fallback_lock:
            fallbacks = dict(self._mesh_fallbacks)
        return {
            "spec": self.meshspec.spec,
            "shape": list(self.meshspec.shape),
            "num_parts": self.meshspec.num_parts,
            "pool_entries": by_shape,
            "plans": plan_cache().stats(),
            # Apps that could not build on the mesh and dropped to a
            # single-part engine (correct answers, none of the scaling).
            # Empty is the healthy state.
            "fallbacks": fallbacks,
            **({"warning": "mesh fallback active: "
                           + ", ".join(sorted(fallbacks))}
               if fallbacks else {}),
            # Latest engine-observatory telemetry per engine ({} until an
            # instrumented run has happened in this process).
            "engobs": self._engobs_block(),
        }

    @staticmethod
    def _engobs_block() -> dict:
        """engobs.latest() with the overlap number labeled for what it
        is: ``exchange_hidden_frac`` is a host-clock *budget* (an upper
        bound — phase fencing serializes the overlap it prices), so each
        record carries a note saying so, plus the device-measured
        ``realized_hidden_frac`` from the latest profile.v1 capture when
        one exists in this process."""
        realized = prof.latest_realized()
        out = {}
        for kind, rec in engobs.latest().items():
            rec = dict(rec)
            if "exchange_hidden_frac" in rec \
                    or "run_exchange_hidden_frac" in rec:
                rec["exchange_hidden_frac_note"] = "budget (upper bound)"
                if realized is not None:
                    rec["realized_hidden_frac"] = realized
            out[kind] = rec
        return out

    def profile_capture(self, steps: int = 8) -> dict:
        """Run a programmatic device-timeline capture window (the
        ``POST /profilez`` handler): ``steps`` PageRank steps on the
        serving engine under ``torch.profiler``, parsed into a
        ``profile.v1`` report. Requires ``LUX_PROF_DIR``; raises
        ``prof.CaptureBusyError`` when a capture is already running. The
        kernels carry their ``prof`` regions' tags (device ranges), so
        the report needs no op maps."""
        steps = max(1, min(int(steps), 64))
        with engine_stream(self.device):
            ex = self._pagerank_engine()
            ex.warmup()
            vals = ex.init_values()

            def drive():
                v = vals
                for _ in range(steps):
                    v = ex.step(v)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                return v

            _, rep = prof.profile_window(drive, steps=steps)
        # A capture is a (config -> realized overlap) observation too:
        # the compact headline numbers go into the ledger (the full
        # profile.v1 artifact stays under LUX_PROF_DIR).
        ledger.record_run(
            "profile",
            {"steps": steps,
             "realized_hidden_frac": rep.get("realized_hidden_frac"),
             "devices": len(rep.get("devices") or {}),
             "nv": int(self.graph.nv), "ne": int(self.graph.ne)},
            graph_fingerprint=self.fingerprint, program="PageRank",
            engine_kind="profilez", mesh_shape=self._mesh_label(),
        )
        return rep

    def costz(self) -> dict:
        """Per-tenant cost accounting (the ``/costz`` payload)."""
        out = self.costs.snapshot()
        out["config"] = {"hash": flags.config_hash()}
        return out

    def mesh_exchange_bytes(self) -> dict:
        """Per-app dense-estimate exchange bytes per iteration for the
        warm sharded engines ({} on a single-part mesh)."""
        if not self.sharded:
            return {}
        out = {}
        for app, get_engine in (
            ("sssp", self._sssp_single),
            ("sssp_multi", self._sssp_multi),
            ("components", self._components_engine),
            ("pagerank", self._pagerank_engine),
        ):
            ex = get_engine()
            fn = getattr(ex, "exchange_bytes_per_iter", None)
            if fn is not None:
                out[app] = int(fn())
        # GAS engines report only when already warm: this accessor must
        # stay cheap (no surprise builds from an evidence request).
        snap = self._serving
        warm = set(self.pool.keys())
        for app in tuple(self._gas_rooted) + tuple(self._gas_fixpoints):
            extra = (2,) if app == "kcore" else ()
            key = self._engine_key(
                "gas", snap, self._gas_key_extra(app, extra))
            if key not in warm:
                continue
            ex = self._gas_single(app, extra=extra)
            fn = getattr(ex, "exchange_bytes_per_iter", None)
            if fn is not None:
                out["gas_" + app] = int(fn())
        return out

    def stats(self) -> dict:
        snap = self._serving
        s = {
            "graph": {"nv": snap.graph.nv, "ne": snap.graph.ne,
                      "fingerprint": snap.fingerprint},
            "snapshot": {"version": snap.version,
                         "delta_ratio": round(snap.ratio, 6),
                         "compacted": snap.compacted},
            "device": str(self.device),
            "pool": self.pool.stats(),
            "cache": self.cache.stats(),
            "batcher": self.batcher.stats(),
            "mesh": self._mesh_block(),
            "tune": self._tune_block(),
            "programs": self._programs_block(),
            "memory": self._memory_block(),
            "requests": int(self._requests.value),
        }
        if self._latency.count:
            s["latency_s"] = {
                "count": self._latency.count,
                "p50": self._latency.quantile(0.5),
                "p99": self._latency.quantile(0.99),
            }
        return s

    def statusz(self) -> dict:
        """Rolling operational view (the /statusz payload): windowed
        SLO quantiles per app, queue pressure, cache efficiency, batch
        width, the shed/reject/recompile counters that page, and the
        pool's audits and its HBM admission."""
        b = self.batcher.stats()
        c = self.cache.stats()
        p = self.pool.stats()
        probes = c["hits"] + c["misses"]
        return {
            "windows": self.slo.snapshot(),
            # The behavioral flag config this process serves under —
            # two /statusz payloads with different hashes are not
            # comparable evidence (ledger A/B pairing keys on it too).
            "config": {"hash": flags.config_hash()},
            "costs": self.costs.totals(),
            "snapshot": {"version": self.version,
                         "fingerprint": self.fingerprint,
                         "pending_edits": self.store.pending_edits()},
            "breaker": self.breaker.stats(),
            "degraded": self._degraded,
            "faults": {"armed": [dataclasses.asdict(r)
                                 for r in faults.armed()],
                       "injected": faults.counts()},
            "queue": {"depth": b["queue_depth"],
                      "capacity": b["queue_capacity"]},
            "cache_hit_rate": (c["hits"] / probes) if probes else None,
            "batch_size": self.batcher.batch_histogram(),
            "mesh": self._mesh_block(),
            "tune": self._tune_block(),
            "programs": self._programs_block(),
            "memory": self._memory_block(),
            "audits": p["audits"],
            # Latest adaptive-executor direction split (push/pull iters,
            # mid-run switches) per GAS engine kind; {} until one runs.
            "gas": {kind: rec for kind, rec in engobs.latest().items()
                    if kind.startswith("gas")},
            "counters": {
                "requests": int(self._requests.value),
                "rejected": b["rejected"],
                "deadline_expired": b["deadline_expired"],
                "warmup_compiles": p["warmup_compiles"],
                "recompiles": p["recompiles"],
                "ir_findings": p["ir_findings"],
                "gas_findings": p["gas_findings"],
            },
            "flight": flight.counts(),
        }

    def _flight_context(self) -> dict:
        """Context block stamped into every flight.v1 postmortem."""
        return {
            "graph": {"nv": self.graph.nv, "ne": self.graph.ne,
                      "fingerprint": self.fingerprint},
            "snapshot": {"version": self.version},
            "pool": self.pool.stats(),
            "cache": self.cache.stats(),
            "batcher": self.batcher.stats(),
            "sentinel": self.pool.sentinel.stats(),
            "breaker": self.breaker.stats(),
            "degraded": self._degraded,
            "costs": self.costs.totals(),
        }

    def close(self):
        if not self._closed:
            self._closed = True
            flight.remove_context(self._flight_name)
            self.batcher.close()
            self.breaker.drain_probes()
            self.pool.close()
            self.store.drain_compactions()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _timed:
    def __init__(self, log, what):
        self.log, self.what = log, what

    def __enter__(self):
        self.t0 = spans.clock()

    def __exit__(self, *exc):
        self.log.info(
            "%s: %.2fs", self.what, spans.clock() - self.t0
        )
