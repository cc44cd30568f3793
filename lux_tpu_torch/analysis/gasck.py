"""gasck: the program-algebra prover behind ``luxlint --programs``, the
counterpart of ``lux_tpu/analysis/gasck.py`` (the same rules, titles,
messages, probe grids, seeded graphs and ``gascap.v1`` artifact, so
both packages derive the same capability matrix and each accepts the
other's artifact).

Every correctness guarantee the engine family leans on — sentinel
annihilation for ``LUX_EXCHANGE=frontier``, part-order-independent
sharded accumulation, push<->pull bitwise duality, incremental
warm-start soundness — rests on algebraic properties of each
:class:`GasProgram`'s combiner that used to be hand-declared class
attrs or a docstring proof. This tier proves them offline, on seeded
probe graphs and per-dtype probe grids, and *derives* the capability
matrix instead of trusting declarations:

- LUX601 combiner-identity: the declared init/sentinel value
  annihilates under ``combine`` over a per-dtype probe grid including
  +-inf, dtype extremes, and a symmetric NaN-propagation policy.
- LUX602 combiner-algebra: associativity + commutativity over seeded
  probe triples — the license for ``segment_reduce`` reordering and
  part-order-independent sharded accumulation.
- LUX603 direction-duality: the push and pull accumulators are
  bitwise-equal on every iteration of a seeded trace — the
  AdaptiveExecutor / ShardedAdaptiveExecutor eligibility gate.
- LUX604 monotone-convergence: idempotence, merge-apply agreement, and
  gather inflation/monotonicity w.r.t. the declared order — the
  machine-checked form of the proof engine/incremental.py used to
  carry in its docstring.
- LUX605 frontier annihilation: applying an identity-filled
  accumulator leaves state bitwise unchanged and scatters an empty
  frontier — the program-level ``frontier_ok`` license complementing
  the trace-level LUX405.
- LUX606 capability-declaration drift: declared ``rooted`` /
  ``servable`` / ``frontier_ok`` / ``incremental_ok`` attrs must match
  the derived proof matrix (over- and under-claiming both flagged).

Proof results persist as a content-addressed ``gascap.v1`` artifact
(the committed ``analysis/gascap.json``, written by ``python -m
lux_tpu_torch.tools.luxlint --programs --gascap-out``);
``lux_tpu_torch.models`` derives ``ROOTED_APPS`` and the capability
matrix from it, the serving pool audits every build against the
probe-grid rules, and ``IncrementalExecutor`` refuses a program whose
LUX604 proof fails (:func:`require_incremental`). Checks are
interdependent (a failed identity voids the trace-based proofs), so one
driver, :func:`prove_program`, runs them in dependency order; the rule
classes here are metadata for ``--list-rules``.

The algebra runs in host numpy. The program hooks run as the engines
run them: on torch tensors on a device (:func:`hooks_on`; the card
unless the caller names another), uint32 values widened to int64 and
their results narrowed mod 2**32 (``_call_hook``). Module import stays
numpy + stdlib; torch arrives with the first hook, so ``--list-rules``
and artifact loading never pay for it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import hashlib
import importlib.util
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from lux_tpu_torch.analysis.core import FileResult, Finding, LintReport
from lux_tpu_torch.utils import flags

PROGRAMS_SCHEMA = "luxlint-programs.v1"
CAP_SCHEMA = "gascap.v1"
CAP_FILENAME = "gascap.json"

_MAX_ITERS = 32          # trace cap; probe graphs converge far earlier
_PROBE_CAP = 48          # per-program combine-probe grid bound
_SNAP_CAP = 6            # state snapshots fed to the LUX605 check

__all__ = [
    "PROGRAMS_SCHEMA", "CAP_SCHEMA", "CAP_FILENAME", "ProgramRule",
    "all_program_rules", "prove_program", "prove_registry",
    "verify_registry", "verify_fixture_paths", "build_capmap",
    "save_capmap", "load_capmap", "capmap_path", "audit_program",
    "require_incremental", "incremental_proofs", "hooks_on",
]


@dataclasses.dataclass(frozen=True)
class ProgramRule:
    id: str
    title: str
    doc: str


PROGRAM_RULES = (
    ProgramRule(
        "LUX601", "combiner-identity",
        "the declared init/sentinel value annihilates under combine "
        "over a per-dtype probe grid (incl. +-inf, extremes) with a "
        "symmetric NaN policy — the license for identity-masked pull "
        "and sentinel-padded frontier exchange"),
    ProgramRule(
        "LUX602", "combiner-algebra",
        "combine is exactly associative and commutative over seeded "
        "probe triples — the license for segment_reduce reordering "
        "and part-order-independent sharded accumulation"),
    ProgramRule(
        "LUX603", "direction-duality",
        "push and pull accumulators are bitwise-equal on every "
        "iteration of seeded probe-graph traces — the adaptive/"
        "sharded-adaptive executor eligibility gate"),
    ProgramRule(
        "LUX604", "monotone-convergence",
        "idempotent merge, apply == combine, and inflationary+monotone "
        "gather w.r.t. the declared order — required before "
        "IncrementalExecutor may warm-start from stale state"),
    ProgramRule(
        "LUX605", "frontier-annihilation",
        "applying an identity-filled accumulator leaves state bitwise "
        "unchanged and scatters an empty frontier — the program-level "
        "frontier_ok license (complements trace-level LUX405)"),
    ProgramRule(
        "LUX606", "capability-drift",
        "declared rooted/servable/frontier_ok/incremental_ok attrs "
        "exactly match the derived proof matrix; over- and "
        "under-claiming both flagged"),
)


def all_program_rules() -> List[ProgramRule]:
    return list(PROGRAM_RULES)


# -- numpy-side algebra helpers -------------------------------------------


def _np_op(combiner: str):
    try:
        return {"min": np.minimum, "max": np.maximum, "sum": np.add}[combiner]
    except KeyError:
        raise ValueError(f"unknown combiner {combiner!r}") from None


def _bitwise_eq(a: np.ndarray, b: np.ndarray) -> bool:
    a = np.asarray(a)
    b = np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


_HOOK_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "gasck_hook_device", default=None)


@contextlib.contextmanager
def hooks_on(device=None):
    """Run the program hooks of the block on ``device``. Given none, the
    block keeps an outer block's device, else its first hook takes the
    card (and raises without one, as every entry point of the port
    does)."""
    if device is None:
        yield
        return
    import torch

    tok = _HOOK_DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _HOOK_DEVICE.reset(tok)


def _hook_device(device=None):
    """``device``, else an outer :func:`hooks_on` block's, else the card
    (raising without one)."""
    from lux_tpu_torch.utils.platform import resolve_device

    if device is None:
        device = _HOOK_DEVICE.get()
    return resolve_device(device)


def _call_hook(fn, *args) -> np.ndarray:
    """Run a program hook the way the engines present values to it, and
    return a host numpy array: numpy inputs become torch tensors on the
    hook device, uint32 ones widened to int64 (``ops/segment.py::
    gas_widen``); when a uint32 input came in, an int64 result goes back
    narrowed mod 2**32 to uint32, as numpy's uint32 ufuncs wrap. Floats
    and bools pass bit for bit."""
    import torch

    dev = _hook_device()
    wide = False
    conv = []
    for a in args:
        if isinstance(a, np.ndarray):
            if a.dtype == np.uint32:
                wide = True
                a = a.astype(np.int64)
            a = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        conv.append(a)
    out = fn(*conv)
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu().numpy()
    out = np.asarray(out)
    if wide and out.dtype == np.int64:
        out = (out & 0xFFFFFFFF).astype(np.uint32)
    return out


def _np_dtype(value_dtype) -> np.dtype:
    """A program's ``value_dtype`` (numpy, or torch for the pull
    programs) as a numpy dtype."""
    if type(value_dtype).__module__ == "torch":
        import torch

        return torch.empty(0, dtype=value_dtype).numpy().dtype
    return np.dtype(value_dtype)


def _identity_np(combiner: str, dtype: np.dtype):
    """The engine's own identity (ops/segment.py), as a numpy scalar —
    the proof must use the exact value the executors mask with."""
    from lux_tpu_torch.ops.segment import identity_for

    return np.asarray(identity_for(combiner, dtype)).astype(dtype)[()]


def _dtype_extremes(dtype: np.dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.floating):
        fi = np.finfo(dtype)
        return np.array(
            [0.0, 1.0, -1.0, 0.5, 1e-3, 65536.0,
             fi.max, -fi.max, np.inf, -np.inf], dtype=dtype)
    ii = np.iinfo(dtype)
    return np.array(
        [0, 1, 2, ii.max // 2, ii.max - 1, ii.max], dtype=dtype)


def _clean_probes(p: np.ndarray) -> np.ndarray:
    """NaN gets its own symmetric-policy probe, and -0.0 is excluded
    everywhere: np.minimum/np.maximum return the *second* operand on an
    equal compare, so +-0.0 would fail bitwise commutativity without
    telling us anything about the program."""
    if np.issubdtype(p.dtype, np.floating):
        p = p[~np.isnan(p)]
        p = p[~((p == 0) & np.signbit(p))]
    return np.unique(p)


def _probe_grid(values: np.ndarray, ident, dtype: np.dtype,
                seed: int) -> np.ndarray:
    """Combine-probe grid: trace-reachable values + dtype extremes +
    the identity, deduped, -0.0/NaN-cleaned, capped at _PROBE_CAP
    (extremes and identity always survive the cap)."""
    vals = _clean_probes(values.ravel().astype(dtype, copy=False))
    if vals.size > _PROBE_CAP:
        rng = np.random.default_rng(seed)
        vals = vals[np.sort(rng.choice(vals.size, _PROBE_CAP,
                                       replace=False))]
    return _clean_probes(np.concatenate(
        [vals, _dtype_extremes(dtype), np.array([ident], dtype=dtype)]))


# -- the individual proofs ------------------------------------------------


def _check_identity(combine, ident, probes: np.ndarray,
                    dtype: np.dtype) -> Tuple[bool, str, Optional[str]]:
    """(ok, counterexample, nan_policy). ``combine`` is the effective
    scalar combine (custom hook or the builtin op); failure text quotes
    the first violating probe."""
    ia = np.full_like(probes, ident)
    with np.errstate(all="ignore"):
        left = np.asarray(combine(ia, probes))
        right = np.asarray(combine(probes, ia))
    for got, side in ((left, "combine(ident, p)"), (right, "combine(p, ident)")):
        if not _bitwise_eq(got.astype(probes.dtype, copy=False), probes):
            bad = np.flatnonzero(
                np.frombuffer(got.astype(probes.dtype).tobytes(), np.uint8)
                .reshape(probes.size, -1)
                != np.frombuffer(probes.tobytes(), np.uint8)
                .reshape(probes.size, -1))
            i = int(bad[0]) // max(1, probes.dtype.itemsize)
            return (False,
                    f"{side} != p at p={probes[i]!r}: got "
                    f"{got.reshape(-1)[i]!r} (ident={ident!r})", None)
    if not np.issubdtype(dtype, np.floating):
        return True, "", None
    nan = np.array([np.nan], dtype=dtype)
    ione = np.array([ident], dtype=dtype)
    with np.errstate(all="ignore"):
        l = np.asarray(combine(nan, ione))
        r = np.asarray(combine(ione, nan))
    if not _bitwise_eq(l, r):
        return (False,
                f"asymmetric NaN policy: combine(NaN, ident)={l[0]!r} but "
                f"combine(ident, NaN)={r[0]!r}", None)
    return True, "", ("propagate" if np.isnan(l[0]) else "absorb")


def _check_algebra(op, probes: np.ndarray, seed: int,
                   triples: int) -> Tuple[bool, str]:
    """Exact (bitwise) associativity + commutativity of the builtin op
    over the full extremes cube plus ``triples`` seeded random triples
    drawn from the probe grid."""
    ext = _clean_probes(np.concatenate(
        [_dtype_extremes(probes.dtype),
         probes[:1] if probes.size else probes]))
    ga, gb, gc = np.meshgrid(ext, ext, ext, indexing="ij")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(1, probes.size), size=(3, max(1, triples)))
    a = np.concatenate([ga.ravel(), probes[idx[0]]])
    b = np.concatenate([gb.ravel(), probes[idx[1]]])
    c = np.concatenate([gc.ravel(), probes[idx[2]]])
    with np.errstate(all="ignore"):
        lhs = op(op(a, b), c)
        rhs = op(a, op(b, c))
    if not _bitwise_eq(lhs, rhs):
        i = int(np.flatnonzero(
            lhs.view(np.uint8).reshape(a.size, -1)
            != rhs.view(np.uint8).reshape(a.size, -1))[0]) \
            // max(1, lhs.dtype.itemsize)
        return (False,
                f"not associative at (a={a[i]!r}, b={b[i]!r}, c={c[i]!r}): "
                f"(a+b)+c={lhs[i]!r} != a+(b+c)={rhs[i]!r}")
    with np.errstate(all="ignore"):
        ab = op(a, b)
        ba = op(b, a)
    if not _bitwise_eq(ab, ba):
        i = int(np.flatnonzero(
            ab.view(np.uint8).reshape(a.size, -1)
            != ba.view(np.uint8).reshape(a.size, -1))[0]) \
            // max(1, ab.dtype.itemsize)
        return (False,
                f"not commutative at (a={a[i]!r}, b={b[i]!r}): "
                f"{ab[i]!r} != {ba[i]!r}")
    return True, ""


@dataclasses.dataclass
class _Trace:
    duality_ok: bool
    mismatch: str           # first push/pull divergence, "" if none
    snaps: List[np.ndarray]
    gather_in: np.ndarray   # frontier-source state values (trace-reachable)
    msgs: np.ndarray        # in-play gather outputs
    iters: int
    converged: bool


def _trace(gas, graph, start: int, ident, op,
           max_iters: int = _MAX_ITERS) -> _Trace:
    """Run the fixpoint in numpy, computing BOTH direction's
    accumulators each iteration exactly as the engine builds them
    (engine/gas.py _pull_acc / _push_acc): pull gathers every CSC edge
    and masks non-frontier messages to the identity; push gathers only
    frontier-selected edges (through ``gather_push`` when declared)
    into an identity-filled accumulator."""
    src = graph.col_src.astype(np.int64)
    dst = graph.col_dst.astype(np.int64)
    w = graph.weights
    vals = np.asarray(gas.init_values(graph, start=start))
    front = np.asarray(gas.init_frontier(graph, start=start)).astype(bool)
    push_gather = getattr(gas, "gather_push", None)
    snaps = [vals.copy()]
    gin: List[np.ndarray] = []
    msgs: List[np.ndarray] = []
    duality_ok, mismatch, converged = True, "", False
    it = 0
    for it in range(max_iters):
        if not front.any():
            converged = True
            break
        sel = front[src]
        m = np.asarray(_call_hook(gas.gather, vals[src], w)) \
            .astype(vals.dtype, copy=False)
        masked = m.copy()
        masked[~sel] = ident
        acc_pull = np.full(graph.nv, ident, dtype=vals.dtype)
        with np.errstate(all="ignore"):
            op.at(acc_pull, dst, masked)
        # Push side: gather_push (when declared) is evaluated over the
        # same fixed-shape full edge list and selected after — an edge
        # function is elementwise, so the frontier slice is bitwise
        # identical, and the hook runs once an iteration on one
        # fixed-shape tensor whatever the frontier's size. Without a
        # declared gather_push the push direction runs the very same
        # edge function, so the pull messages are reused as-is.
        mp_full = (np.asarray(_call_hook(push_gather, vals[src], w))
                   .astype(vals.dtype, copy=False)
                   if push_gather is not None else m)
        acc_push = np.full(graph.nv, ident, dtype=vals.dtype)
        with np.errstate(all="ignore"):
            op.at(acc_push, dst[sel], mp_full[sel])
        if duality_ok and not _bitwise_eq(acc_pull, acc_push):
            duality_ok = False
            bad = int(np.flatnonzero(
                acc_pull.view(np.uint8).reshape(graph.nv, -1)
                != acc_push.view(np.uint8).reshape(graph.nv, -1))[0]) \
                // max(1, vals.dtype.itemsize)
            mismatch = (f"iter {it} vertex {bad}: pull={acc_pull[bad]!r} "
                        f"push={acc_push[bad]!r}")
        if sel.any():
            gin.append(np.unique(vals[front]))
            msgs.append(np.unique(m[sel]))
        new = np.asarray(_call_hook(gas.apply, vals, acc_pull)) \
            .astype(vals.dtype, copy=False)
        front = np.asarray(_call_hook(gas.scatter, vals, new)).astype(bool)
        vals = new
        snaps.append(vals.copy())
    empty = np.array([], dtype=vals.dtype)
    return _Trace(
        duality_ok, mismatch, snaps,
        np.unique(np.concatenate(gin)) if gin else empty,
        np.unique(np.concatenate(msgs)) if msgs else empty,
        it + (0 if converged else 1), converged)


def _check_annihilation(gas, snaps: Sequence[np.ndarray],
                        ident) -> Tuple[bool, str]:
    """LUX605: an identity-only accumulator must leave state bitwise
    unchanged and scatter nothing — a vertex that received no messages
    must not move."""
    picks = list(snaps[:1]) + list(snaps[-(_SNAP_CAP - 1):]) \
        if len(snaps) > _SNAP_CAP else list(snaps)
    for k, s in enumerate(picks):
        acc = np.full_like(s, ident)
        new = np.asarray(_call_hook(gas.apply, s, acc)) \
            .astype(s.dtype, copy=False)
        if not _bitwise_eq(new, s):
            bad = int(np.flatnonzero(
                new.view(np.uint8).reshape(s.size, -1)
                != s.view(np.uint8).reshape(s.size, -1))[0]) \
                // max(1, s.dtype.itemsize)
            return (False,
                    f"apply(state, identity-acc) mutates state snapshot "
                    f"{k} at vertex {bad}: {s[bad]!r} -> {new[bad]!r}")
        fired = np.asarray(_call_hook(gas.scatter, s, new)).astype(bool)
        if fired.any():
            return (False,
                    f"scatter fires {int(fired.sum())} vertices on an "
                    f"identity-only accumulator (snapshot {k})")
    return True, ""


def _check_monotone(gas, op, ident, gather_in: np.ndarray,
                    msgs: np.ndarray) -> Tuple[bool, str]:
    """LUX604 sub-checks, in order: monotone combiner; idempotent
    combine; apply == combiner merge; gather inflationary and monotone
    w.r.t. the order, over trace-reachable state values only (dtype
    extremes would manufacture uint wraparound the fixpoint can never
    reach)."""
    if gas.combiner not in ("min", "max"):
        return (False,
                f"combiner {gas.combiner!r} is not a monotone merge "
                "order (needs min or max)")
    probes = _clean_probes(np.concatenate(
        [gather_in, msgs, np.array([ident], dtype=gather_in.dtype)])) \
        if gather_in.size else np.array([ident])
    if not _bitwise_eq(op(probes, probes), probes):
        return False, "combine is not idempotent over the probe grid"
    accs = _clean_probes(np.concatenate(
        [msgs, np.array([ident], dtype=probes.dtype)])) \
        if msgs.size else probes
    x = np.repeat(probes, accs.size)
    a = np.tile(accs, probes.size)
    got = np.asarray(_call_hook(gas.apply, x, a)) \
        .astype(probes.dtype, copy=False)
    want = op(x, a)
    if not _bitwise_eq(got, want):
        i = int(np.flatnonzero(
            got.view(np.uint8).reshape(x.size, -1)
            != want.view(np.uint8).reshape(x.size, -1))[0]) \
            // max(1, got.dtype.itemsize)
        return (False,
                f"apply(old={x[i]!r}, acc={a[i]!r})={got[i]!r} is not the "
                f"{gas.combiner}-merge {want[i]!r}")
    if not gather_in.size:
        return False, "no trace-reachable gather inputs to probe"
    s = np.sort(gather_in)
    wprobes: List[Optional[np.ndarray]] = [None]
    if gas.needs_weights:
        wprobes = [np.full(s.shape, wv, dtype=np.int32)
                   for wv in (1, 2, 50, 100)]
    for wp in wprobes:
        g = np.asarray(_call_hook(gas.gather, s, wp)) \
            .astype(s.dtype, copy=False)
        wtxt = "" if wp is None else f" (weight {int(wp[0])})"
        if not _bitwise_eq(op(g, s), s):
            i = int(np.flatnonzero(
                op(g, s).view(np.uint8).reshape(s.size, -1)
                != s.view(np.uint8).reshape(s.size, -1))[0]) \
                // max(1, s.dtype.itemsize)
            return (False,
                    f"gather is not inflationary{wtxt}: "
                    f"gather({s[i]!r})={g[i]!r} moves against the "
                    f"{gas.combiner} order")
        if g.size > 1 and not bool(np.all(g[:-1] <= g[1:])):
            i = int(np.flatnonzero(g[:-1] > g[1:])[0])
            return (False,
                    f"gather is not monotone{wtxt}: inputs "
                    f"{s[i]!r} <= {s[i + 1]!r} but messages "
                    f"{g[i]!r} > {g[i + 1]!r}")
    return True, ""


def _derive_rooted(gas, graph) -> bool:
    try:
        v0 = np.asarray(gas.init_values(graph, start=0))
        f0 = np.asarray(gas.init_frontier(graph, start=0))
        v1 = np.asarray(gas.init_values(graph, start=1))
        f1 = np.asarray(gas.init_frontier(graph, start=1))
    except TypeError:
        return False
    return not (_bitwise_eq(v0, v1) and _bitwise_eq(f0, f1))


# -- seed graphs ----------------------------------------------------------


def _seed_graphs(nv: int, seed: int) -> Dict[str, object]:
    """Deterministic probe graphs: a ring (every vertex reachable) plus
    3*nv random edges, in an unweighted and a same-structure weighted
    (1..100, the generate.py convention) variant."""
    from lux_tpu_torch.graph.graph import Graph

    rng = np.random.default_rng(seed)
    ring_src = np.arange(nv, dtype=np.int64)
    ring_dst = (ring_src + 1) % nv
    extra = rng.integers(0, nv, size=(2, 3 * nv))
    src = np.concatenate([ring_src, extra[0]])
    dst = np.concatenate([ring_dst, extra[1]])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.integers(1, 101, size=src.size).astype(np.int32)
    return {
        "plain": Graph.from_edges(src, dst, nv),
        "weighted": Graph.from_edges(src, dst, nv, weights=w),
    }


# -- the per-program driver -----------------------------------------------


def _declared_caps(raw) -> Dict[str, bool]:
    return {
        "rooted": bool(getattr(raw, "rooted", False)),
        "servable": bool(getattr(raw, "servable", True)),
        "frontier_ok": bool(getattr(raw, "frontier_ok", False)),
        "incremental_ok": bool(getattr(raw, "incremental_ok", False)),
    }


def prove_program(name: str, program, graphs: Dict[str, object],
                  path: str, seed: int = 7, triples: int = 64,
                  device=None) -> Tuple[FileResult, dict]:
    """Prove one program's algebra, its hooks on ``device``; returns the
    lint result and its gascap.v1 capability entry. Checks run in
    dependency order: a failed identity (LUX601) voids every trace-based
    proof, so those are skipped (derived capabilities go False) rather
    than reported as cascading noise."""
    with hooks_on(_hook_device(device)):
        return _prove_program(name, program, graphs, path, seed, triples)


def _prove_program(name, program, graphs, path, seed,
                   triples) -> Tuple[FileResult, dict]:
    findings: List[Finding] = []

    def fail(rule: str, msg: str) -> None:
        findings.append(Finding(rule, path, 0, 0, f"{name}: {msg}"))

    caps: dict = {"combiner": "?", "value_dtype": "?", "frontier": False,
                  "declared": {}, "derived": {}, "checks": {},
                  "evidence": {}}
    try:
        from lux_tpu_torch.engine.gas import as_gas

        raw = program() if isinstance(program, type) else program
        gas = as_gas(raw)
        combiner = gas.combiner
        dtype = _np_dtype(gas.value_dtype)
        op = _np_op(combiner)
        declared = _declared_caps(raw)
        graph = graphs["weighted"] if gas.needs_weights else graphs["plain"]
        ident_builtin = _identity_np(combiner, dtype)
        ident_fn = getattr(gas, "combine_identity", None)
        ident = (np.asarray(ident_fn(dtype)).astype(dtype)[()]
                 if callable(ident_fn) else ident_builtin)
        custom = getattr(gas, "combine", None)
        combine = ((lambda a, b: _call_hook(custom, a, b))
                   if callable(custom) else op)

        init_v = np.asarray(gas.init_values(graph, start=0))
        frontier = bool(gas.frontier) and init_v.ndim == 1
        derived_rooted = _derive_rooted(gas, graph)

        probes = _probe_grid(init_v, ident, dtype, seed)
        id_ok, id_msg, nan_policy = _check_identity(
            combine, ident, probes, dtype)

        traces: List[_Trace] = []
        if frontier and id_ok:
            roots = [0, 1] if derived_rooted else [0]
            traces = [_trace(gas, graph, s, ident, op) for s in roots]
            reach = np.concatenate(
                [init_v] + [t.gather_in for t in traces]
                + [t.msgs for t in traces])
            probes = _probe_grid(reach, ident, dtype, seed)
            id_ok, id_msg, nan_policy = _check_identity(
                combine, ident, probes, dtype)
        if frontier and not id_ok:
            fail("LUX601",
                 f"identity is not an annihilator — {id_msg}; "
                 "identity-masked pull and sentinel-padded frontier "
                 "exchange would corrupt values")

        alg_ok, alg_msg = _check_algebra(op, probes, seed, triples)
        if frontier and not alg_ok:
            fail("LUX602",
                 f"combine is not exact over the probe grid — {alg_msg}; "
                 "segment_reduce reordering and part-order-independent "
                 "sharded accumulation are unlicensed")
        if callable(custom):
            got = np.asarray(_call_hook(
                custom, probes, probes[::-1].copy())) \
                .astype(dtype, copy=False)
            if not _bitwise_eq(got, op(probes, probes[::-1])):
                fail("LUX602",
                     f"declared combine() disagrees with the builtin "
                     f"{combiner!r} the engines actually run")

        duality_ok = bool(traces) and all(t.duality_ok for t in traces)
        if frontier and id_ok and traces and not duality_ok:
            first = next(t for t in traces if not t.duality_ok)
            fail("LUX603",
                 f"push and pull accumulators diverge ({first.mismatch}); "
                 "direction-adaptive execution is unlicensed")

        annihil_ok, annihil_msg = False, "no trace"
        if traces:
            annihil_ok, annihil_msg = True, ""
            for t in traces:
                ok, msg = _check_annihilation(gas, t.snaps, ident)
                if not ok:
                    annihil_ok, annihil_msg = False, msg
                    break
        if frontier and id_ok and traces and not annihil_ok:
            fail("LUX605",
                 f"identity does not annihilate at the program level — "
                 f"{annihil_msg}; frontier_ok is unlicensed")

        monotone_ok, monotone_msg = False, "no trace"
        if traces and id_ok:
            gin = np.unique(np.concatenate([t.gather_in for t in traces]))
            msgs = np.unique(np.concatenate([t.msgs for t in traces]))
            monotone_ok, monotone_msg = _check_monotone(
                gas, op, ident, gin, msgs)
        has_relax = callable(getattr(raw, "relax", None))
        derived_incr = monotone_ok and has_relax
        if declared["incremental_ok"]:
            if not monotone_ok:
                fail("LUX604",
                     f"declared incremental_ok but the monotone-"
                     f"convergence proof fails — {monotone_msg}")
            elif not has_relax:
                fail("LUX604",
                     "declared incremental_ok but the program has no "
                     "host relax hook for column re-relaxation")
        elif derived_incr:
            fail("LUX606",
                 "capability under-claim: the monotone proof holds and a "
                 "relax hook exists, but incremental_ok is declared "
                 "False — declare it (or the serving layer will refuse "
                 "warm-started refresh it is entitled to)")

        derived_frontier_ok = (frontier and id_ok and alg_ok
                               and duality_ok and annihil_ok)
        if derived_rooted != declared["rooted"]:
            fail("LUX606",
                 f"rooted drift: declared {declared['rooted']} but "
                 f"init_values/init_frontier "
                 f"{'do' if derived_rooted else 'do not'} depend on "
                 "start")
        if declared["frontier_ok"] != derived_frontier_ok:
            fail("LUX606",
                 f"frontier_ok drift: declared {declared['frontier_ok']} "
                 f"but the proof matrix derives {derived_frontier_ok}")
        if declared["servable"] and frontier and not derived_frontier_ok:
            fail("LUX606",
                 "servable over-claim: a frontier program without the "
                 "derived frontier_ok license must not be exposed "
                 "through the serving frontier lane")

        caps = {
            "combiner": combiner,
            "value_dtype": str(dtype),
            "frontier": bool(gas.frontier),
            "declared": declared,
            "derived": {
                "rooted": bool(derived_rooted),
                "frontier_ok": bool(derived_frontier_ok),
                "incremental_ok": bool(derived_incr),
            },
            "checks": {
                "identity": bool(id_ok),
                "exact_combiner": bool(alg_ok),
                "duality": bool(duality_ok),
                "annihilation": bool(annihil_ok),
                "monotone": bool(monotone_ok),
            },
            "evidence": {
                "probes": int(probes.size),
                "iters": int(sum(t.iters for t in traces)),
                "roots": [0, 1] if (traces and derived_rooted) else
                         ([0] if traces else []),
                "nan_policy": nan_policy,
                "monotone_detail": monotone_msg,
            },
        }
    except Exception as e:   # a broken program must report, not crash the tier
        return FileResult(
            path, [], [],
            error=f"{path}: {name}: prover crashed: {e!r}"), caps
    findings.sort(key=lambda f: (f.rule, f.message))
    return FileResult(path, findings, []), caps


def _filter_select(result: FileResult,
                   select: Optional[Sequence[str]]) -> None:
    if select:
        keep = tuple(select)
        result.findings = [f for f in result.findings
                           if f.rule.startswith(keep)]


# -- registry + fixture drivers -------------------------------------------


def prove_registry(select: Optional[Sequence[str]] = None,
                   device=None) -> Tuple[LintReport, dict]:
    """Prove all registered programs, their hooks on ``device``; returns
    (report, gascap.v1 dict)."""
    t0 = time.perf_counter()
    from lux_tpu_torch import models

    device = _hook_device(device)

    seed = flags.get_int("LUX_GASCK_SEED")
    nv = flags.get_int("LUX_GASCK_NV")
    triples = flags.get_int("LUX_GASCK_TRIPLES")
    graphs = _seed_graphs(nv, seed)
    results: List[FileResult] = []
    programs_block: Dict[str, dict] = {}
    for name in sorted(models.PROGRAMS):
        res, caps = prove_program(
            name, models.PROGRAMS[name], graphs,
            f"<registry:{name}>", seed=seed, triples=triples,
            device=device)
        _filter_select(res, select)
        results.append(res)
        programs_block[name] = caps
    art = build_capmap(programs_block,
                       {"seed": seed, "nv": nv, "triples": triples})
    return (LintReport(results, time.perf_counter() - t0,
                       schema=PROGRAMS_SCHEMA), art)


def verify_registry(select: Optional[Sequence[str]] = None,
                    capmap_out: Optional[str] = None,
                    device=None) -> LintReport:
    report, art = prove_registry(select, device=device)
    if capmap_out and report.ok:
        save_capmap(art, capmap_out)
    return report


_FIXTURE_SEQ = [0]


def _load_fixture_programs(path: str) -> List[Tuple[str, object]]:
    from lux_tpu_torch.engine.gas import GasProgram
    from lux_tpu_torch.engine.program import PullProgram
    from lux_tpu_torch.engine.push import PushProgram

    _FIXTURE_SEQ[0] += 1
    modname = f"_gasck_fixture_{_FIXTURE_SEQ[0]}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)   # type: ignore[union-attr]
    if isinstance(getattr(mod, "PROGRAMS", None), dict):
        return sorted(mod.PROGRAMS.items())
    out = []
    for v in vars(mod).values():
        if (isinstance(v, type) and v.__module__ == modname
                and issubclass(v, (GasProgram, PushProgram, PullProgram))):
            out.append((getattr(v, "name", v.__name__), v))
    return sorted(out)


def verify_fixture_paths(paths: Sequence[str],
                         select: Optional[Sequence[str]] = None,
                         device=None) -> LintReport:
    """Prove programs defined in standalone .py files (the seeded
    failing fixtures under tests/torch_gas_fixtures/), their hooks on
    ``device``."""
    from lux_tpu_torch.analysis.core import iter_python_files

    t0 = time.perf_counter()
    device = _hook_device(device)
    seed = flags.get_int("LUX_GASCK_SEED")
    graphs = _seed_graphs(flags.get_int("LUX_GASCK_NV"), seed)
    triples = flags.get_int("LUX_GASCK_TRIPLES")
    results: List[FileResult] = []
    for path in iter_python_files(paths):
        try:
            progs = _load_fixture_programs(path)
        except Exception as e:
            results.append(FileResult(
                path, [], [], error=f"{path}: unloadable fixture: {e!r}"))
            continue
        if not progs:
            results.append(FileResult(
                path, [], [],
                error=f"{path}: defines no GAS/push/pull programs"))
            continue
        for name, prog in progs:
            res, _ = prove_program(name, prog, graphs, path,
                                   seed=seed, triples=triples,
                                   device=device)
            _filter_select(res, select)
            results.append(res)
    return LintReport(results, time.perf_counter() - t0,
                      schema=PROGRAMS_SCHEMA)


# -- the gascap.v1 artifact -----------------------------------------------


def _cap_id(programs: dict, probe: dict) -> str:
    blob = json.dumps({"probe": probe, "programs": programs},
                      sort_keys=True)
    return "gascap-" + hashlib.sha1(blob.encode()).hexdigest()[:12]


def build_capmap(programs: dict, probe: dict) -> dict:
    return {
        "schema": CAP_SCHEMA,
        "id": _cap_id(programs, probe),
        "probe": probe,
        "programs": programs,
        "created_at": time.time(),
    }


def save_capmap(art: dict, path: str) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(art, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def load_capmap(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        art = json.load(fh)
    if art.get("schema") != CAP_SCHEMA:
        raise ValueError(
            f"{path}: schema {art.get('schema')!r}, expected {CAP_SCHEMA!r}")
    want = _cap_id(art.get("programs") or {}, art.get("probe") or {})
    if art.get("id") != want:
        raise ValueError(
            f"{path}: id {art.get('id')!r} does not match content hash "
            f"{want!r} (tampered or hand-edited capability artifact)")
    return art


def capmap_path() -> str:
    d = flags.get("LUX_GASCAP_DIR")
    if d:
        return os.path.join(d, CAP_FILENAME)
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        CAP_FILENAME)


# -- consumers: pool audit + the incremental gate -------------------------


def _program_key(obj) -> tuple:
    cls = type(obj)
    extras = tuple(sorted(
        (k, v) for k, v in vars(obj).items()
        if isinstance(v, (int, float, str, bool))))
    return (cls.__module__, cls.__qualname__, extras)


_POOL_AUDIT_CACHE: Dict[tuple, List[Finding]] = {}


def audit_program(program, label: str = "<pool>",
                  device=None) -> List[Finding]:
    """Light LUX601/602/605 audit for serving pool builds: probe-grid
    algebra only, no graph trace — cheap enough to run on every engine
    build, cached per program identity. The hooks run on ``device``
    (the engine's)."""
    from lux_tpu_torch.engine.gas import as_gas

    gas = as_gas(program)
    key = _program_key(gas)
    if key in _POOL_AUDIT_CACHE:
        return [dataclasses.replace(f, path=label)
                for f in _POOL_AUDIT_CACHE[key]]
    with hooks_on(device):
        findings = _audit_findings(gas, label)
    _POOL_AUDIT_CACHE[key] = findings
    return findings


def _audit_findings(gas, label: str) -> List[Finding]:
    findings: List[Finding] = []
    name = getattr(gas, "name", type(gas).__name__)
    combiner = gas.combiner
    dtype = _np_dtype(gas.value_dtype)
    op = _np_op(combiner)
    ident_fn = getattr(gas, "combine_identity", None)
    ident = (np.asarray(ident_fn(dtype)).astype(dtype)[()]
             if callable(ident_fn)
             else _identity_np(combiner, dtype))
    custom = getattr(gas, "combine", None)
    probes = _probe_grid(np.array([], dtype=dtype), ident, dtype, seed=0)
    id_ok, id_msg, _ = _check_identity(
        (lambda a, b: _call_hook(custom, a, b)) if callable(custom)
        else op, ident, probes, dtype)
    if not id_ok:
        findings.append(Finding(
            "LUX601", label, 0, 0,
            f"{name}: identity is not an annihilator — {id_msg}"))
    if gas.frontier:
        alg_ok, alg_msg = _check_algebra(op, probes, seed=0, triples=16)
        if not alg_ok:
            findings.append(Finding(
                "LUX602", label, 0, 0,
                f"{name}: combine is not exact — {alg_msg}"))
        if id_ok:
            ok, msg = _check_annihilation(gas, [probes], ident)
            if not ok:
                findings.append(Finding(
                    "LUX605", label, 0, 0,
                    f"{name}: identity does not annihilate at the "
                    f"program level — {msg}"))
    return findings


_INCR_CACHE: Dict[tuple, Optional[str]] = {}
_INCR_GRAPHS: Dict[str, object] = {}


def require_incremental(program, device=None) -> None:
    """Gate for IncrementalExecutor: raise :class:`ProgramContractError`
    naming the failed LUX604 sub-check unless the program carries a
    host relax hook AND passes the monotone-convergence proof on a
    seeded probe graph, its hooks on ``device`` (the executor's).
    Cached per program identity — the proof runs once per process, not
    per executor."""
    from lux_tpu_torch.engine.program import ProgramContractError

    key = _program_key(program)
    if key not in _INCR_CACHE:
        with hooks_on(device):
            _INCR_CACHE[key] = _incremental_error(program)
    err = _INCR_CACHE[key]
    if err:
        raise ProgramContractError(err)


def incremental_proofs() -> int:
    """How many programs' incremental proofs this process has run."""
    return len(_INCR_CACHE)


def _incremental_error(program) -> Optional[str]:
    from lux_tpu_torch.engine.gas import as_gas

    name = getattr(program, "name", type(program).__name__)
    if not callable(getattr(program, "relax", None)):
        return (f"{name}: LUX604 monotone-convergence: no host relax hook "
                "— IncrementalExecutor re-relaxes invalidated columns on "
                "the host, so a relax(src_vals, weights) method is part "
                "of the incremental contract")
    gas = as_gas(program)
    if not bool(gas.frontier):
        return (f"{name}: LUX604 monotone-convergence: frontier-less "
                "programs have no activation signal to warm-start from")
    _hook_device()   # no card and no device: raised, not a cached verdict
    try:
        gkey = "weighted" if gas.needs_weights else "plain"
        if gkey not in _INCR_GRAPHS:
            _INCR_GRAPHS.update(
                _seed_graphs(12, flags.get_int("LUX_GASCK_SEED")))
        graph = _INCR_GRAPHS[gkey]
        op = _np_op(gas.combiner)
        dtype = _np_dtype(gas.value_dtype)
        ident = _identity_np(gas.combiner, dtype)
        t = _trace(gas, graph, 0, ident, op)
        ok, reason = _check_monotone(gas, op, ident, t.gather_in, t.msgs)
    except Exception as e:
        return (f"{name}: LUX604 monotone-convergence: proof crashed "
                f"({e!r})")
    if not ok:
        return f"{name}: LUX604 monotone-convergence: {reason}"
    return None
