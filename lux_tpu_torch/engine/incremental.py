"""Incremental recompute: warm-start push fixpoints from a prior snapshot;
the counterpart of ``lux_tpu/engine/incremental.py``.

Gunrock's frontier-operator framing (arXiv:1501.05387) makes incremental
recompute a non-event: a fixpoint engine that already advances a frontier
doesn't care whether the frontier came from ``init_frontier`` or from the
set of vertices an edit batch touched. This module computes that touched
set on the host, as ``lux_tpu`` does, and hands the push executors a warm
:class:`~lux_tpu_torch.engine.push.PushState` on their device: K5, K6
and K7 run it for :meth:`IncrementalExecutor.run`, K10 with K columns
for :meth:`IncrementalExecutor.run_multi`.

Invalidation (the only subtle part) is per monotone-combiner program
(SSSP min, components max):

- *Seeds*: a removed edge ``u -> v`` invalidates ``v`` iff it supported
  v's old value — ``relax(old[u], w) == old[v]`` and ``old[v]`` is not
  v's init value (init values need no support; an unreached SSSP vertex
  holds its init ``nv``).
- *Propagation*: a BFS over the NEW graph's out-edges resets ``b`` when a
  reset vertex ``a`` supported ``old[b]`` through a surviving edge, using
  the ORIGINAL old values for every support test.
- Reset vertices restart from their init values; everything else keeps
  its old fixpoint value. The frontier is the reset vertices, their
  in-neighbours in the new graph and the inserted edges' sources.

``lux_tpu`` evaluates ``relax`` through jnp on the host; here the
program's own ``relax`` runs on CPU tensors of the host values, widened
to int64 as the push programs' hooks take them, so every support test
compares exactly as ``lux_tpu``'s.

The warm start is sound for programs whose merge is idempotent and
monotone, ``apply`` the combiner's merge, and ``relax`` inflationary and
monotone: ``lux_tpu``'s LUX604 proof (``analysis/gasck.py``), which its
executor requires. Until that lint is ported (ROADMAP A16),
:func:`require_incremental` gates on the program's declarations: a
``relax``, a frontier, and ``incremental_ok``.

PageRank is not a monotone push program; :func:`incremental_pagerank`
warm-starts the pull iteration (K8) from the previous ranks (re-divided
by the new out-degrees) and runs to an L-inf tolerance instead.

A warm run records itself under the engine label ``incremental``
(``recorder_for``), as ``lux_tpu``'s does. Not ported: ``trace_step``,
the luxlint-IR hook (ROADMAP A16).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.engine.program import ProgramContractError
from lux_tpu_torch.engine.push import (MultiSourcePushExecutor, PushExecutor,
                                       PushState)
from lux_tpu_torch.graph.graph import Graph
from lux_tpu_torch.obs import recorder_for
from lux_tpu_torch.ops.segment import to_u32_storage
from lux_tpu_torch.utils import faults, host


def require_incremental(program) -> None:
    """Raise :class:`ProgramContractError` unless ``program`` may be
    warm-started: it has a host ``relax``, a frontier, and declares
    ``incremental_ok``. The first two are ``lux_tpu``'s own refusals;
    the declaration stands in for its LUX604 proof until A16."""
    from lux_tpu_torch.engine.gas import as_gas

    name = getattr(program, "name", type(program).__name__)
    why = None
    if not callable(getattr(program, "relax", None)):
        why = ("no host relax hook — IncrementalExecutor re-relaxes "
               "invalidated columns on the host, so a relax(src_vals, "
               "weights) method is part of the incremental contract")
    elif not bool(as_gas(program).frontier):
        why = ("frontier-less programs have no activation signal to "
               "warm-start from")
    elif not getattr(program, "incremental_ok", False):
        why = "the program does not declare incremental_ok"
    if why is not None:
        raise ProgramContractError(
            f"{name}: LUX604 monotone-convergence: {why} (the port gates "
            "on the program's declarations until the LUX604 proof arrives "
            "with A16; ROADMAP A10)")


def _relax_np(program, vals: np.ndarray, w) -> np.ndarray:
    """The program's relax on host values (uint32 widened to int64, on
    CPU tensors over the same memory); the result as numpy."""
    v = np.asarray(vals)
    if v.dtype == np.uint32:
        v = v.astype(np.int64)
    out = program.relax(torch.from_numpy(np.ascontiguousarray(v)),
                        None if w is None else torch.from_numpy(
                            np.ascontiguousarray(w)))
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _gather_slices(ptr: np.ndarray, ids: np.ndarray):
    """Flat indices of ``[ptr[i], ptr[i+1])`` for every i in ``ids``, and
    the counts (``lux_tpu``'s returns ``np.repeat(ids, counts)`` in their
    place) — the vectorized adjacency expansion used by the host BFS (no
    per-vertex Python loop)."""
    starts = ptr[ids]
    counts = (ptr[ids + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    if not total:
        return np.zeros(0, dtype=np.int64), counts
    offs = np.repeat(starts.astype(np.int64) - (np.cumsum(counts) - counts),
                     counts)
    offs += np.arange(total, dtype=np.int64)
    return offs, counts


def _each_run(ptr: np.ndarray, ids: np.ndarray, fn, threads: int) -> None:
    """``fn(run)`` for runs of the sorted ``ids`` that split their
    adjacency (by ``ptr``) into about equal edge counts, one a thread
    (``utils/host.py``); one run when the edges are few. Each run writes
    only True into shared masks, so the result does not depend on the
    split."""
    deg = ptr[ids + 1] - ptr[ids]
    total = int(deg.sum())
    parts = min(threads, total // host.PARALLEL_MIN + 1, ids.size)
    if parts <= 1:
        fn(ids)
        return
    cuts = np.searchsorted(np.cumsum(deg), total * np.arange(1, parts)
                           // parts)
    host.run_parts(fn, np.split(ids, cuts), threads)


def invalidate(program, graph: Graph, old_values: np.ndarray,
               init_values: np.ndarray, rem_src, rem_dst,
               rem_w, threads: Optional[int] = None) -> np.ndarray:
    """Boolean mask of vertices whose old values lose support under the
    edit batch (see module docstring for the exact rule).

    ``lux_tpu``'s BFS, with the same mask: a level's candidates are
    relaxed once per source vertex when the graph has no weights (relax
    is elementwise, so that is the per-edge value repeated), its next
    frontier is collected by a mask instead of a sort, since a level can
    hold most of the graph's edges, and a large level is split over
    ``threads`` threads (default: the host's CPUs)."""
    threads = host.host_threads() if threads is None else threads
    nv = graph.nv
    reset = np.zeros(nv, dtype=bool)
    rem_src = np.asarray(rem_src, dtype=np.int64)
    rem_dst = np.asarray(rem_dst, dtype=np.int64)
    if rem_src.size:
        cand = _relax_np(program, old_values[rem_src], rem_w)
        hit = (cand == old_values[rem_dst]) & (
            old_values[rem_dst] != init_values[rem_dst]
        )
        frontier = np.unique(rem_dst[hit])
    else:
        frontier = np.zeros(0, dtype=np.int64)
    reset[frontier] = True
    csr = graph.csr()
    level = np.zeros(nv, dtype=bool)

    def expand(run):
        idx, counts = _gather_slices(csr.row_ptr, run)
        if not idx.size:
            return
        b = csr.col_dst[idx]
        if csr.weights is None:
            cand = np.repeat(_relax_np(program, old_values[run], None),
                             counts)
        else:
            cand = _relax_np(program, np.repeat(old_values[run], counts),
                             csr.weights[idx])
        ob = old_values[b]
        hit = (cand == ob) & (ob != init_values[b]) & ~reset[b]
        level[b[hit]] = True

    while frontier.size:
        level[:] = False
        _each_run(csr.row_ptr, frontier, expand, threads)
        frontier = np.flatnonzero(level)
        reset[frontier] = True
    return reset


def _warm_column(program, graph: Graph, old_values: np.ndarray,
                 removed, inserted, threads: Optional[int] = None,
                 **init_kw):
    """(values, frontier, n_reset) for one root/lane, host-side."""
    threads = host.host_threads() if threads is None else threads
    old_values = np.asarray(old_values)
    init_values = np.asarray(program.init_values(graph, **init_kw))
    if old_values.shape != init_values.shape:
        raise ValueError(
            f"old values shape {old_values.shape} != graph shape "
            f"{init_values.shape}; snapshots never change nv"
        )
    rem_src, rem_dst, rem_w = removed if removed is not None else ((), (), None)
    reset = invalidate(program, graph, old_values, init_values,
                       rem_src, rem_dst, rem_w, threads)
    vals = np.where(reset, init_values, old_values).astype(old_values.dtype)
    fr = np.zeros(graph.nv, dtype=bool)
    ridx = np.nonzero(reset)[0]
    fr[ridx] = True

    def refill(run):
        # In-neighbors of the reset region in the NEW graph: the vertices
        # whose surviving values refill it.
        idx, _ = _gather_slices(graph.row_ptr, run)
        fr[graph.col_src[idx]] = True

    if ridx.size:
        _each_run(graph.row_ptr, ridx, refill, threads)
    if inserted is not None and len(inserted[0]):
        fr[np.asarray(inserted[0], dtype=np.int64)] = True
    return vals, fr, int(ridx.size)


class IncrementalExecutor:
    """Warm-started push fixpoints over an edit batch (``cuda`` unless
    ``device`` names another).

    Wraps a :class:`PushExecutor` and optionally a
    :class:`MultiSourcePushExecutor` for the NEW graph; ``run``/
    ``run_multi`` take the previous snapshot's fixpoint values plus the
    ``removed``/``inserted`` edge arrays and drive the wrapped engines
    from the warm state, which goes to their device as their own
    ``init_state`` does.

    ``removed`` is ``(src, dst, w|None)`` of the base edges actually
    removed (see :func:`lux_tpu_torch.graph.delta.removed_edges`);
    ``inserted`` is ``(src, dst[, w])`` of the edges added.
    """

    def __init__(self, graph: Graph, program,
                 push: Optional[PushExecutor] = None,
                 multi: Optional[MultiSourcePushExecutor] = None,
                 k: Optional[int] = None, device=None):
        require_incremental(program)
        self.graph = graph
        self.program = program
        self.push = push if push is not None else PushExecutor(
            graph, program, device=device
        )
        self.device = self.push.device
        self.multi = multi
        if self.multi is None and k is not None:
            self.multi = MultiSourcePushExecutor(graph, program, k,
                                                 device=self.device)
        # Host seconds of the last warm state: the invalidation (with the
        # warm values and frontier) and the upload to the device.
        self.host_seconds = {"invalidation": 0.0, "upload": 0.0}

    def _upload(self, t0: float, make):
        """``make()``'s device state, with the seconds since ``t0`` (the
        host work before it) and of the upload noted."""
        t1 = time.perf_counter()
        state = make()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.host_seconds = {"invalidation": t1 - t0,
                             "upload": time.perf_counter() - t1}
        return state

    # -- single source ---------------------------------------------------

    def warm_state(self, old_values, removed=None, inserted=None, **init_kw):
        """Device-resident warm ``PushState`` + an info dict
        (``reset``/``frontier``/``touched_frac``)."""
        t0 = time.perf_counter()
        vals, fr, n_reset = _warm_column(
            self.program, self.graph, old_values, removed, inserted,
            **init_kw
        )
        state = self._upload(t0, lambda: PushState(
            to_u32_storage(vals, self.device),
            torch.from_numpy(fr).to(self.device)))
        info = {
            "reset": n_reset,
            "frontier": int(fr.sum()),
            "touched_frac": float(fr.sum() / max(self.graph.nv, 1)),
        }
        return state, info

    def run(self, old_values, removed=None, inserted=None,
            max_iters: Optional[int] = None, chunk: int = 16,
            recorder=None, **init_kw):
        """Fixpoint from the warm state; returns ``(state, iters, info)``
        with ``state.values`` bitwise-equal to a from-scratch run."""
        faults.point("serve.engine.execute")
        state, info = self.warm_state(old_values, removed, inserted,
                                      **init_kw)
        if recorder is None:
            # Label the warm-started fixpoint as this engine's run, not
            # the wrapped push executor's.
            recorder = recorder_for("incremental", self.graph, self.program)
        state, iters = self.push.run(max_iters=max_iters, state=state,
                                     chunk=chunk, recorder=recorder)
        return state, iters, info

    # -- multi source (dense (nv, K) sweep) ------------------------------

    def run_multi(self, starts, old_columns, removed=None, inserted=None,
                  max_iters: Optional[int] = None, chunk: int = 16,
                  recorder=None):
        """Warm the K-lane sweep: lane j restarts root ``starts[j]`` from
        ``old_columns[j]``. Fewer than k roots are right-padded exactly
        like ``init_state``."""
        if self.multi is None:
            raise ValueError("no MultiSourcePushExecutor attached")
        faults.point("serve.engine.execute")
        starts = list(starts)
        cols = list(old_columns)
        if len(starts) != len(cols):
            raise ValueError("one old-value column per root required")
        if not 1 <= len(starts) <= self.multi.k:
            raise ValueError(
                f"need 1..{self.multi.k} roots, got {len(starts)}"
            )
        pad = self.multi.k - len(starts)
        starts = starts + [starts[-1]] * pad
        cols = cols + [cols[-1]] * pad
        t0 = time.perf_counter()

        def lane(j):
            # The lanes run side by side, each on one thread.
            return _warm_column(self.program, self.graph, cols[j], removed,
                                inserted, threads=1, start=starts[j])

        got = host.run_parts(lane, list(range(len(starts))))
        vals_cols = [v for v, _, _ in got]
        fr_cols = [f for _, f, _ in got]
        resets = sum(r for _, _, r in got)
        vals, fr = np.stack(vals_cols, axis=1), np.stack(fr_cols, axis=1)
        state = self._upload(t0, lambda: self.multi._lanes_storage(vals, fr))
        fsum = int(sum(int(f.sum()) for f in fr_cols))
        info = {
            "reset": resets,
            "frontier": fsum,
            "touched_frac": float(
                fsum / max(self.graph.nv * self.multi.k, 1)
            ),
        }
        if recorder is None:
            recorder = recorder_for("incremental", self.graph, self.program)
        state, iters = self.multi.run(starts, max_iters=max_iters,
                                      chunk=chunk, state=state,
                                      recorder=recorder)
        return state, iters, info

    # -- warm-up ------------------------------------------------------------

    def warmup(self, chunk: int = 16, **init_kw):
        """The wrapped push executor's ``warmup``."""
        self.push.warmup(chunk=chunk, **init_kw)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def incremental_pagerank(executor, old_stored, old_out_degrees, ni: int,
                         tol: float = 1e-7, chunk: int = 8):
    """Warm-start PageRank on ``executor``'s (new) graph from the
    previous snapshot's stored ranks (numpy or a tensor).

    The pull engine stores ranks pre-divided by out-degree; degrees
    change under edits, so the warm vector is the previous *true* ranks
    re-divided by the NEW degrees, computed on the host as ``lux_tpu``
    does. Iterates in ``chunk`` steps until the stored vector moves less
    than ``tol`` (L-inf) or ``ni`` iterations. The stop test runs on the
    executor's device and reads one float a chunk: abs and max are exact
    in f32, so it decides as ``lux_tpu``'s host copy does, and the pull
    step does not consume its input, so ``prev`` stays on the device.

    Returns ``(stored_values, iters_run)``, the values as numpy f32.
    """
    from lux_tpu_torch.models.pagerank import true_ranks

    g = executor.graph
    true = true_ranks(_host(old_stored), _host(old_out_degrees))
    new_deg = g.out_degrees
    warm = np.where(new_deg == 0, true,
                    true / np.maximum(new_deg, 1)).astype(np.float32)
    vals = torch.from_numpy(warm).to(executor.device)
    iters = 0
    while iters < ni:
        step = min(chunk, ni - iters)
        prev = vals
        vals = executor.run(step, vals=prev)
        iters += step
        if float((vals - prev).abs().max()) < tol:
            break
    return _host(vals), iters
