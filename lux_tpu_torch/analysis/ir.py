"""The executor registry of the IR tier and the plan half of the
exchange tier, the counterpart of the parts of ``lux_tpu/analysis/ir.py``
that trace nothing.

``lux_tpu``'s IR tier traces every registered program on every capable
executor kind and runs its jaxpr rules (LUX101-105, and the exchange
dataflow rules LUX404-406) over the traces. Those wait for a torch
mechanism in place of jaxpr liveness (ROADMAP A16). What is here:

- :func:`build_executor`, one executor of any kind in
  ``models.ENGINE_KINDS``, which the tuner's probes build under their
  flag overlays (``tune/probe.py``);
- the registry matrix (:func:`_registry_executors` over
  :func:`_tiny_graph` and :func:`_compact_graph`), and the evidence a
  live plan is verified with (:func:`_exchange_row_bytes`,
  :func:`_plan_evidence`);
- ``luxlint --exchange``'s plan half: :func:`run_exchange_matrix` (the
  LUX401-403/407 plan rules over every live compact plan of the sharded
  registry executors, from each executor's ``_xplan``) and
  :func:`run_exchange_paths` (saved artifacts and ``PLANS`` fixtures).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from lux_tpu_torch.analysis.core import FileResult, LintReport

__all__ = ["build_executor", "run_exchange_matrix", "run_exchange_paths"]

# Parts of every sharded registry executor: ``lux_tpu``'s tier runs on 8
# virtual CPU devices, and its sharded executors default to all of them.
REGISTRY_PARTS = 8

# What ``--exchange`` cannot check yet, named in its report.
TRACE_RULES_NOT_PORTED = ("LUX404-406 (the exchange dataflow rules over "
                          "the traced step) are not ported (ROADMAP A16, "
                          "the trace tiers)")


def build_executor(kind: str, graph, program, **kw):
    """One executor of the given kind over (graph, program) — the same
    constructions the CLIs and serving use, defaults throughout. ``kw``
    goes to the constructor: ``device`` for every kind (``cuda`` unless
    named); ``mesh`` and a prebuilt partition ``sg`` for the sharded
    kinds (``tiled_sharded`` takes a ``plan`` instead of an ``sg``).
    The multi-source kinds take K = 4 lanes, as ``lux_tpu``'s."""
    if kind == "pull":
        from lux_tpu_torch.engine.pull import PullExecutor
        return PullExecutor(graph, program, **kw)
    if kind == "tiled":
        from lux_tpu_torch.engine.tiled import TiledPullExecutor
        return TiledPullExecutor(graph, program, **kw)
    if kind == "push":
        from lux_tpu_torch.engine.push import PushExecutor
        return PushExecutor(graph, program, **kw)
    if kind == "push_multi":
        from lux_tpu_torch.engine.push import MultiSourcePushExecutor
        return MultiSourcePushExecutor(graph, program, k=4, **kw)
    if kind == "push_incremental":
        from lux_tpu_torch.engine.incremental import IncrementalExecutor
        return IncrementalExecutor(graph, program, **kw)
    if kind == "pull_sharded":
        from lux_tpu_torch.engine.pull_sharded import ShardedPullExecutor
        return ShardedPullExecutor(graph, program, **kw)
    if kind == "tiled_sharded":
        from lux_tpu_torch.engine.tiled_sharded import ShardedTiledExecutor
        return ShardedTiledExecutor(graph, program, **kw)
    if kind == "push_sharded":
        from lux_tpu_torch.engine.push_sharded import ShardedPushExecutor
        return ShardedPushExecutor(graph, program, **kw)
    if kind == "push_multi_sharded":
        from lux_tpu_torch.engine.push_sharded import (
            ShardedMultiSourcePushExecutor)
        return ShardedMultiSourcePushExecutor(graph, program, k=4, **kw)
    if kind == "gas":
        from lux_tpu_torch.engine.gas import AdaptiveExecutor, as_gas
        return AdaptiveExecutor(graph, as_gas(program), **kw)
    if kind == "gas_multi":
        from lux_tpu_torch.engine.gas import MultiSourceGasExecutor
        return MultiSourceGasExecutor(graph, program, k=4, **kw)
    if kind == "gas_sharded":
        from lux_tpu_torch.engine.gas_sharded import ShardedAdaptiveExecutor
        return ShardedAdaptiveExecutor(graph, program, **kw)
    if kind == "gas_multi_sharded":
        from lux_tpu_torch.engine.gas_sharded import (
            ShardedMultiSourceGasExecutor)
        return ShardedMultiSourceGasExecutor(graph, program, k=4, **kw)
    raise ValueError(f"unknown executor kind {kind!r}")


def _tiny_graph(weighted: bool, seed: int):
    """Small synthetic graph: big enough to exercise every code path's
    shapes, small enough that building executors stays milliseconds."""
    from lux_tpu_torch.graph.generate import gnp

    return gnp(96, 400, seed=seed, weighted=weighted)


def _compact_graph(kind: str, weighted: bool, seed: int):
    """Graph whose partition actually engages the compact exchange: the
    row-granular engines need read locality (small_world's ring plus a
    contiguous edge-balanced partition leaves only boundary reads), the
    tiled engine needs hub concentration (rmat's Kronecker skew keeps
    strip reads on the few hub blocks). The tiny gnp used for the plain
    targets is all-remote at this size, which would fall back to full
    and silently shrink the audit's coverage of the compact plans."""
    from lux_tpu_torch.graph.generate import rmat, small_world
    from lux_tpu_torch.graph.graph import Graph

    if kind == "tiled_sharded":
        return rmat(12, 8, seed=seed, weighted=weighted)
    g = small_world(1024, k=4, p_rewire=0.05, seed=seed)
    if weighted:
        rng = np.random.default_rng(seed)
        g = Graph(nv=g.nv, ne=g.ne, row_ptr=g.row_ptr, col_src=g.col_src,
                  weights=rng.integers(1, 101, g.ne, dtype=np.int32))
    return g


def _registry_executors(include_sharded: bool = True,
                        sharded_only: bool = False, device=None):
    """Yield ``(name, kind, executor, init_kw)`` for every registered
    program x capable executor on ``device`` (``cuda`` unless named).
    Sharded kinds take :data:`REGISTRY_PARTS` parts and are built twice:
    once with the default full exchange and once under
    ``LUX_EXCHANGE=compact`` (``{name}@{kind}+compact``), and the
    adaptive GAS kind a third time under ``LUX_EXCHANGE=frontier``, so
    the audits cover the packed exchange too."""
    from lux_tpu_torch.models import PROGRAMS, ROOTED_APPS, engine_kinds
    from lux_tpu_torch.utils import flags
    from lux_tpu_torch.utils.logging import get_logger

    def build(kind, graph, program):
        kw = {"device": device}
        if kind.endswith("sharded"):
            kw["num_parts"] = REGISTRY_PARTS
        return build_executor(kind, graph, program, **kw)

    for i, name in enumerate(sorted(PROGRAMS)):
        program = PROGRAMS[name]()
        weighted = bool(getattr(program, "needs_weights", False))
        graph = None
        init_kw = {"start": 0} if name in ROOTED_APPS else {}
        for kind in engine_kinds(name):
            sharded = kind.endswith("sharded")
            if sharded and not include_sharded:
                continue
            if sharded_only and not sharded:
                continue
            if graph is None:
                graph = _tiny_graph(weighted=weighted, seed=7 + i)
            ex = build(kind, graph, program)
            yield f"{name}@{kind}", kind, ex, init_kw
            if not sharded:
                continue
            with flags.overrides({"LUX_EXCHANGE": "compact"}):
                exc = build(kind, _compact_graph(kind, weighted, 7 + i),
                            program)
            if getattr(exc, "exchange_mode", "full") != "compact":
                # Coverage loss must be visible, not silent.
                get_logger("luxlint").warning(
                    "%s@%s+compact fell back to the full exchange; "
                    "its compact plan is unaudited", name, kind)
                continue
            yield f"{name}@{kind}+compact", kind, exc, init_kw
            if kind != "gas_sharded":
                continue
            # The adaptive GAS engine additionally carries the
            # frontier-compacted send (LUX_EXCHANGE=frontier): build it
            # too so LUX407 covers the activity-packed exchange.
            with flags.overrides({"LUX_EXCHANGE": "frontier"}):
                exf = build(kind, _compact_graph(kind, weighted, 7 + i),
                            program)
            if getattr(exf, "exchange_mode", "full") != "frontier":
                # Frontier-less programs downgrade to compact by design
                # (no activity plane to pack); only a frontier program
                # landing elsewhere is lost coverage.
                if getattr(exf.program, "frontier", False):
                    get_logger("luxlint").warning(
                        "%s@%s+frontier fell back to %s; its frontier "
                        "evidence is unaudited", name, kind,
                        exf.exchange_mode)
                continue
            yield f"{name}@{kind}+frontier", kind, exf, init_kw


# Value-row byte price per exchanged unit row for each plan-carrying
# executor kind — the same figures the engines' exchange_bytes_per_iter
# models use (pull and GAS: the program's row width; push: 4 B uint32
# value + 1 B bool frontier per lane; tiled: float32 elements).
def _exchange_row_bytes(kind: str, ex) -> Optional[int]:
    if kind in ("pull_sharded", "gas_sharded", "gas_multi_sharded"):
        return int(ex._row_bytes)
    if kind == "push_sharded":
        return 5
    if kind == "push_multi_sharded":
        return 5 * int(ex.k)
    if kind == "tiled_sharded":
        return 4
    return None


def _plan_evidence(kind: str, ex, plan) -> dict:
    """LUX402/403 evidence for a live plan-carrying executor: the
    remote-read counts matrix, the row price, and the exchange ledger
    exactly as the observatory would publish it."""
    from lux_tpu_torch.obs import engobs

    row_bytes = _exchange_row_bytes(kind, ex)
    counts = None
    ledger = None
    sg = getattr(ex, "sg", None)
    if sg is not None and hasattr(sg, "remote_read_counts"):
        counts = sg.remote_read_counts()
        if counts is not None and row_bytes is not None:
            ledger = engobs.useful_exchange(
                sg, row_bytes,
                exchanged_rows=plan.exchanged_units_per_iter)
    if counts is None:
        counts = getattr(ex, "_remote_read_counts", None)
        if counts is not None and row_bytes is not None:
            # The tiled executor's block-granular ledger (its run()
            # computes the same figures inline).
            c = np.asarray(counts, np.int64)
            exchanged = plan.exchanged_units_per_iter * plan.unit_rows
            useful = int(c.sum() - np.trace(c))
            ledger = {
                "useful_rows": useful,
                "exchanged_rows": exchanged,
                "useful_bytes_per_iter": useful * row_bytes,
                "ratio": useful / max(exchanged, 1),
            }
    out = {"remote_read_counts": counts, "row_bytes": row_bytes,
           "ledger": ledger}
    # Frontier-exchange evidence (LUX407), present only on the adaptive
    # GAS executor built under LUX_EXCHANGE=frontier.
    fe = getattr(ex, "frontier_evidence", None)
    if callable(fe):
        out.update(fe() or {})
    return out


def _plan_rules(select):
    from lux_tpu_torch.analysis import exchck

    return [r for r in exchck.all_exchange_rules()
            if select is None or r.id in select]


def run_exchange_matrix(select=None, device=None) -> LintReport:
    """``luxlint --exchange`` with no paths: the LUX401-403/407 plan
    rules over each live compact plan of the sharded registry executors
    on ``device`` (reported as ``{target}/plan``), read from each
    executor's ``_xplan``. ``lux_tpu``'s run also traces every full and
    compact target for LUX404-406; that half is not ported."""
    from lux_tpu_torch.analysis import exchck

    rules = _plan_rules(select)
    # Executor construction is environment setup, not verification —
    # kept outside the timer as lux_tpu's tier does.
    staged = [(name, kind, ex) for name, kind, ex, _ in
              _registry_executors(sharded_only=True, device=device)
              if getattr(ex, "_xplan", None) is not None]
    results: List[FileResult] = []
    t0 = time.perf_counter()
    for name, kind, ex in staged:
        plan = ex._xplan
        view = exchck.plan_view(
            plan, declared_bytes_per_iter=ex.exchange_bytes_per_iter(),
            **_plan_evidence(kind, ex, plan))
        results.append(exchck.verify_exchange_plan(
            view, f"{name}/plan", rules))
    return LintReport(results, time.perf_counter() - t0,
                      schema=exchck.EXCHANGE_SCHEMA)


def run_exchange_paths(paths: Sequence[str], select=None) -> LintReport:
    """``luxlint --exchange`` over explicit paths: saved exchange-artifact
    directories (of either package) and ``.py`` fixtures exposing
    ``PLANS``. A fixture's ``TRACES`` (LUX404-406) cannot be checked yet:
    a fixture with only ``TRACES`` is reported as an error saying so, and
    is never executed (such fixtures import jax)."""
    import os

    from lux_tpu_torch.analysis import exchck

    t0 = time.perf_counter()
    rules = _plan_rules(select)
    results: List[FileResult] = []
    for path in paths:
        if os.path.isdir(path):
            try:
                view = exchck.load_exchange_artifact(path)
            except Exception as e:
                results.append(FileResult(
                    path, [], [],
                    error=f"{path}: unloadable plan: {e!r}"))
                continue
            results.append(exchck.verify_exchange_plan(view, path, rules))
            continue
        try:
            has_plans, has_traces = exchck.fixture_exports(path)
            plans = exchck.load_fixture_plans(path) if has_plans else []
        except Exception as e:
            results.append(FileResult(
                path, [], [], error=f"{path}: unloadable fixture: {e!r}"))
            continue
        if not plans:
            why = (f"{path}: TRACES only; " + TRACE_RULES_NOT_PORTED
                   if has_traces else
                   f"{path}: fixture exposes neither TRACES nor PLANS")
            results.append(FileResult(path, [], [], error=why))
            continue
        results.extend(exchck.verify_exchange_plan(v, nm, rules)
                       for nm, v in plans)
    return LintReport(results, time.perf_counter() - t0,
                      schema=exchck.EXCHANGE_SCHEMA)
