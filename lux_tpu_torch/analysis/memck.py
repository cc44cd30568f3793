"""luxlint --memory for the port: static HBM-footprint contracts
(LUX701-706) over a torch trace of each executor's step; the
counterpart of ``lux_tpu/analysis/memck.py``, with its rules, ids,
titles, schemas, artifact and public names.

Every capacity question the serving and tuning layers ask — "does this
engine fit?", "how many graphs can stay resident?" — is answered here
*offline*, by walking the traces the trace tiers already record
(``analysis/trace.py``, one run of ``trace_step`` on real tensors), not
by trying it and running out of memory.

The core is a storage-level liveness walk in schedule order over every
registry target's trace (:func:`_walk_trace`, the counterpart of
``_walk_scope`` over a jaxpr):

- a *pinned* buffer (an example arg, the executor's device graph) and
  every output of the step stay live for the whole step; an
  intermediate is live from :attr:`Buffer.defined_by` to
  :attr:`Buffer.last_use`, never as long as the trace itself keeps it
  (the recorder holds every tensor until it ends);
- a torch view (``reshape``, slicing, ``.view``) allocates no storage,
  where a jaxpr ``reshape`` allocates; the walk counts storages, not
  tensors, and an in-place write (a new version of one storage)
  allocates nothing;
- the branches of one :func:`~lux_tpu_torch.utils.tracehooks.
  alternatives` group are exclusive: each is walked from the group's
  entry, the group adds the costliest branch's peak over the entry plus
  the buffers that outlive the group, as ``_walk_scope`` prices a
  ``cond`` (its branch outputs and the cond's outputs both). A plain
  walk would sum the branches;
- the scratch K6, K7 and K11 keep per (device, stream)
  (``ops/frontier.py``) is shared by every engine of the process, not
  one engine's footprint, and is left out (``Buffer.kernel_state``), so
  the card and the CPU, whose plain versions have none, price one step
  alike; ``lux_tpu``'s walk never sees Pallas/XLA scratch either. An
  engine's row schedules (``ops/segment.py::RowTasks``) are its own
  memory and priced: the engines build them on every device, so the CPU
  derivation prices what the card holds.

Sharded targets run on a :class:`~lux_tpu_torch.parallel.mesh.LocalMesh`,
which holds every part's buffers on one card as ``(P, ...)`` stacks:
each buffer is priced at ``1/P`` of its bytes, the scale ``lux_tpu``
applies to global avals, so a peak is **per device** (per part). A
collective's result is a buffer of its own in the trace, also where one
card makes it a view; the walk prices it as one.

Donation uses LUX104's storage-reuse test (``ir.py::DonationAudit``),
not HLO aliasing: an output that reuses a donated arg's storage is that
buffer, so the walk counts it once (the credit ``lux_tpu`` subtracts is
structural here); a donated arg that no output reuses is LUX702, and the
walk prices both copies. No step of the port donates yet (ROADMAP A), so
every registry carry is priced twice, where ``lux_tpu``'s donated carry
is credited once: one of two reasons the committed ``memcap.json`` has
another id than ``lux_tpu``'s ``memcap-a0d09a618c75``. The other is that
``lux_tpu``'s file comes from jaxprs, which JAX 0.9 can no longer
re-derive (ROADMAP). The port's file is derived on the CPU with
``lux_tpu``'s probe block (nv 96, ne 400, seed 7, sweep factor 2, tol
0.25): ``python -m lux_tpu_torch.tools.luxlint --memory --memcap-out
lux_tpu_torch/analysis/memcap.json`` with ``LUX_PLATFORM=cpu``.

Each peak decomposes, by attributing every live-at-peak buffer to the
probe graph's per-part vertex/edge counts, into ``lux_tpu``'s
closed-form model (with two buffers priced at their bound first,
:func:`_model_entries`: an edge array shortened by merged duplicate
edges, and a row schedule)

    f(nv, ne, P, K, exchange_mode) =
        per_vertex_bytes * ceil(nv/P) + per_edge_bytes * ceil(ne/P)
        + fixed_bytes

(:func:`eval_model`), whose honesty LUX704 proves by re-tracing one
representative per engine kind at a swept scale. The models persist as
the content-addressed ``memcap.v1`` artifact, and
:func:`predicted_engine_bytes` is the admission formula the serving
pool (``serve/pool.py``) and the tuner's pruning (``tune/space.py``)
consult.

Rules:

- **LUX701 footprint-structure** — the memcap.v1 artifact and every
  model in it are well-formed, and every current registry target is
  covered;
- **LUX702 donation-leak** — a donated arg whose storage no output of
  the step reuses keeps both copies live; flagged and priced;
- **LUX703 peak-vs-budget** — the derived model at the declared bench
  scales (LUX_BENCH_SCALE/LUX_BENCH_EF) must fit the device-profile
  capacity (``obs/report.py::device_profile``; the H100's row reads the
  card's);
- **LUX704 model-honesty** — the closed-form formula upper-bounds the
  traced peak within LUX_MEM_MODEL_TOL across a scale sweep;
- **LUX705 exchange-staging** — full/compact/frontier staging buffers
  are counted in the peak and cross-checked against
  ``exchange_bytes_per_iter()`` / ``frontier_evidence()``;
- **LUX706 residency-drift** — the committed artifact's admission
  formula still reproduces the freshly traced peaks.

Fixture modules (``luxlint --memory <paths>``) may define any of
``TARGETS`` (name -> trace-spec dict, with ``nv``/``ne`` probe dims),
``MODELS``, ``CAPACITY_BYTES`` (+ optional ``SCALES``), ``MEMCAP`` and
``COMMITTED``, as ``lux_tpu``'s do. A fixture that imports jax or
``lux_tpu`` is refused unexecuted (``ir.load_fixture_targets``'s test).
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from lux_tpu_torch.analysis import ir
from lux_tpu_torch.analysis import trace as tr
from lux_tpu_torch.analysis.core import (FileResult, Finding, LintReport,
                                         iter_python_files)
from lux_tpu_torch.utils import flags

MEMORY_SCHEMA = "luxlint-memory.v1"
CAP_SCHEMA = "memcap.v1"
CAP_FILENAME = "memcap.json"

# Every model entry must carry exactly these (LUX701).
MODEL_FIELDS = ("per_vertex_bytes", "per_edge_bytes", "fixed_bytes")

# LUX704's over-fat arm only fires when the absolute slack also clears
# this floor: probe graphs are ~100 vertices, so small buffers quantise
# into the linear terms and over-predict re-traces by a few dozen KiB —
# noise, not a model that rejects admissible engines.
_OVERFAT_FLOOR_BYTES = 1 << 20

# lux_tpu's probe block: the registry's graphs and the sweep.
PROBE = {"nv": 96, "ne": 400, "seed": 7}

__all__ = [
    "MEMORY_SCHEMA", "CAP_SCHEMA", "CAP_FILENAME", "MemRule",
    "all_memory_rules", "prove_registry", "verify_registry",
    "verify_fixture_paths", "build_memcap", "save_memcap", "load_memcap",
    "memcap_path", "eval_model", "predicted_engine_bytes",
    "hbm_budget_bytes", "target_peak_bytes",
]


@dataclasses.dataclass(frozen=True)
class MemRule:
    id: str
    title: str
    doc: str


MEMORY_RULES = (
    MemRule(
        "LUX701", "footprint-structure",
        "the memcap.v1 artifact and every closed-form model in it are "
        "well-formed (finite coefficients, positive peaks, positive "
        "probe dims) and every current registry target has an entry — "
        "a new program or engine kind fails verify until the artifact "
        "is regenerated"),
    MemRule(
        "LUX702", "donation-leak",
        "every donated carry buffer must be reused by an output of the "
        "step (storage identity, LUX104's test); an unhonored donation "
        "keeps both copies live, silently doubling the carry's share of "
        "peak — flagged AND priced into the footprint (extends LUX104 "
        "from audited to priced)"),
    MemRule(
        "LUX703", "peak-vs-budget",
        "the derived footprint model evaluated at the declared bench "
        "scales must fit the device-profile HBM capacity "
        "(hbm_capacity_bytes, LUX_HBM_CAPACITY_BYTES override); "
        "overcommit fails closed before any shard ships"),
    MemRule(
        "LUX704", "model-honesty",
        "the closed-form f(nv, ne, P, K, mode) must upper-bound the "
        "traced per-device peak within LUX_MEM_MODEL_TOL across a "
        "scale sweep — this formula is what serving admission trusts"),
    MemRule(
        "LUX705", "exchange-staging",
        "full/compact/frontier exchange staging buffers must be "
        "counted in the traced peak and the engine's "
        "exchange_bytes_per_iter() claim must match the collectives "
        "the traced step actually moves (frontier_evidence() "
        "internally consistent)"),
    MemRule(
        "LUX706", "residency-drift",
        "serving's admission formula (the committed memcap.v1 models "
        "behind predicted_engine_bytes) must still reproduce freshly "
        "traced peaks within LUX_MEM_MODEL_TOL; drift fails verify "
        "until the artifact is regenerated"),
)


def all_memory_rules() -> List[MemRule]:
    return list(MEMORY_RULES)


def _f(rule: str, path: str, message: str, line: int = 0) -> Finding:
    return Finding(rule, path, line, 0, message)


def _mib(n: float) -> str:
    return f"{n / 2**20:.2f} MiB"


# -- the liveness walk over a torch trace --------------------------------


def _entry(buf: tr.Buffer, scale: float) -> Tuple[float, float, int]:
    """(scaled bytes, scaled element count, itemsize) of one storage."""
    itemsize = max(1, buf.dtype.itemsize)
    return (buf.nbytes * scale, buf.nbytes / itemsize * scale, itemsize)


def _items(nodes: Sequence[tr.Node], depth: int = 0) -> list:
    """The nodes as a tree in execution order: a node is ``("node",
    node)``, the nodes of one alternatives group at ``depth`` are
    ``("group", last node index, [branch items...])``."""
    out, i = [], 0
    while i < len(nodes):
        n = nodes[i]
        if len(n.alt) <= depth:
            out.append(("node", n))
            i += 1
            continue
        group, branches, j = n.alt[depth][0], {}, i
        while (j < len(nodes) and len(nodes[j].alt) > depth
               and nodes[j].alt[depth][0] == group):
            branches.setdefault(nodes[j].alt[depth][1], []).append(nodes[j])
            j += 1
        out.append(("group", nodes[j - 1].index,
                    [_items(b, depth + 1) for _, b in sorted(
                        branches.items())]))
        i = j
    return out


def _walk_items(items, trace, scale: float, keep: set, live: Dict,
                current: float):
    """Walk one scope from ``live`` (lid -> entry, updated in place) and
    its ``current`` bytes: returns (peak, snapshot lids at the peak,
    current at the end, the lids allocated here and still live). Only
    buffers allocated in this scope are freed here; a scope's survivors
    pass to its parent."""
    bufs = trace.buffers
    owned = set()
    peak, snap = current, list(live)

    def free(upto: int) -> float:
        gone = [lid for lid in owned
                if lid not in keep and bufs[lid].last_use <= upto]
        out = 0.0
        for lid in gone:
            out += live.pop(lid)[0]
            owned.discard(lid)
        return out

    for item in items:
        if item[0] == "node":
            node = item[1]
            alloc = [r.lid for r, fresh in zip(node.outputs, node.fresh)
                     if fresh and not bufs[r.lid].kernel_state]
            cand = current + sum(_entry(bufs[lid], scale)[0]
                                 for lid in alloc)
            if cand > peak:
                peak, snap = cand, list(live) + alloc
            for lid in alloc:
                live[lid] = _entry(bufs[lid], scale)
                owned.add(lid)
            current = cand - free(node.index)
            continue
        _, end, branches = item
        extra, extra_snap, survivors = 0.0, [], []
        for branch in branches:
            sub_live = dict(live)
            p_sub, s_sub, _, kept = _walk_items(branch, trace, scale, keep,
                                                sub_live, current)
            if p_sub - current > extra:
                extra = p_sub - current
                extra_snap = [lid for lid in s_sub if lid not in live]
            survivors += [(lid, sub_live[lid]) for lid in kept]
        surv = sum(e[0] for _, e in survivors)
        cand = current + surv + extra
        if cand > peak:
            peak = cand
            snap = list(live) + [lid for lid, _ in survivors] + extra_snap
        for lid, e in survivors:
            live[lid] = e
            owned.add(lid)
        current = current + surv - free(end)
    return peak, snap, current, [lid for lid in owned if lid in live]


def _walk_lids(trace: tr.Trace, scale: float):
    """Schedule-order liveness over one trace: ``(peak_bytes, the lids
    live at the peak program point, input_bytes)``."""
    bufs = trace.buffers
    keep = {r.lid for r in trace.out_leaves if isinstance(r, tr.Ref)}
    live = {lid: _entry(b, scale) for lid, b in bufs.items()
            if b.pinned and not b.kernel_state}
    # An output the step makes is live from its node on (``keep``: never
    # freed); one that is a pinned buffer (returned in place or as a
    # view) is live throughout.
    input_bytes = sum(e[0] for e in live.values())
    peak, snap, _, _ = _walk_items(_items(trace.nodes), trace, scale, keep,
                                   live, input_bytes)
    return peak, snap, input_bytes


def _walk_trace(trace: tr.Trace, scale: float):
    """Schedule-order liveness over one trace.

    Returns ``(peak_bytes, snapshot, input_bytes)`` where ``snapshot``
    is the list of (bytes, elems, itemsize) entries live at the peak
    program point: ``_walk_scope``'s triple. Pinned buffers (the step's
    inputs) and the step's outputs stay live; intermediates free at
    their last use; a kernel's per-stream scratch is left out (see the
    module docstring)."""
    peak, snap, input_bytes = _walk_lids(trace, scale)
    return peak, [_entry(trace.buffers[lid], scale) for lid in snap], \
        input_bytes


def _staging_items(items, trace, scale: float) -> float:
    total = 0.0
    for item in items:
        if item[0] == "node":
            node = item[1]
            if ir._is_data_collective(node):
                total += sum(_entry(trace.buffers[r.lid], scale)[0]
                             for r, fresh in zip(node.outputs, node.fresh)
                             if fresh)
        elif item[2]:
            total += max(_staging_items(b, trace, scale) for b in item[2])
    return total


def _staging_bytes(trace: tr.Trace, scale: float) -> float:
    """Scaled bytes of the buffers the step's data collectives
    (``ir._is_data_collective``) materialize, as ``lux_tpu`` sums their
    result avals (alternatives branches: max). A node's ``nbytes`` is
    the whole mesh's wire price, LUX406's and LUX705's claim check's,
    not a buffer."""
    return _staging_items(_items(trace.nodes), trace, scale)


def _donation_report(target: ir.TraceTarget, trace: tr.Trace) -> dict:
    """Storage-reuse accounting for the target's donated args (LUX104's
    test over the trace): how many donated leaves exist, how many an
    output of the step reuses, and the byte leak of the rest."""
    outs = {r.lid for r in trace.out_leaves if isinstance(r, tr.Ref)}
    leaves, pos = [], 0
    for i, a in enumerate(target.example_args()):
        n = len(tr.leaves(a))
        if i in target.donate:
            leaves += [x for x in trace.in_leaves[pos:pos + n]
                       if isinstance(x, tr.Ref)]
        pos += n
    declared = len(leaves)
    total_bytes = int(sum(trace.buffers[x.lid].nbytes for x in leaves))
    aliased = sum(1 for x in leaves if x.lid in outs)
    rep = {"declared": declared, "aliased": aliased,
           "donated_bytes": total_bytes, "leak_bytes": 0,
           "checked": declared > 0}
    if aliased < declared:
        # As lux_tpu prices an unhonored donation: the whole carry.
        rep["leak_bytes"] = total_bytes
    return rep


# -- attribution -> the closed-form model ---------------------------------


def _classify(elems: float, nv_p: int, ne_p: int) -> str:
    """vertex | edge | fixed: which probe unit this buffer scales
    with, by relative distance to an integer multiple."""
    best_kind, best_dist = "fixed", 0.5
    for kind, unit in (("vertex", nv_p), ("edge", ne_p)):
        if unit <= 0 or elems <= 0:
            continue
        r = elems / unit
        m = round(r)
        if m < 1:
            continue
        dist = abs(r - m) / r
        if dist < best_dist - 1e-9:
            best_kind, best_dist = kind, dist
    return best_kind


def _attribute(snapshot, nv_p: int, ne_p: int) -> Tuple[float, float, float]:
    per_vertex = per_edge = fixed = 0.0
    for bytes_s, elems_s, _ in snapshot:
        kind = _classify(abs(elems_s), nv_p, ne_p)
        if kind == "edge":
            per_edge += bytes_s / ne_p
        elif kind == "vertex":
            per_vertex += bytes_s / nv_p
        else:
            fixed += bytes_s
    return per_vertex, per_edge, fixed


def eval_model(model: dict, nv: int, ne: int, parts: int,
               k: Optional[int] = None,
               k_probe: Optional[int] = None) -> float:
    """Per-device predicted peak bytes of one entry's model at the
    given scale. ``k`` lanes beyond the probe's scale the
    vertex-proportional term (lane state is (nv, K)-shaped); the graph
    tables in the edge term are lane-independent."""
    parts = max(1, int(parts))
    nv_p = max(1, math.ceil(int(nv) / parts))
    ne_p = max(1, math.ceil(int(ne) / parts))
    pv = float(model["per_vertex_bytes"])
    if k and k_probe and int(k) != int(k_probe):
        pv *= max(1.0, float(k) / float(k_probe))
    out = (pv * nv_p + float(model["per_edge_bytes"]) * ne_p
           + float(model["fixed_bytes"]))
    return max(0.0, out)


# A RowTasks task: two int32 row bounds.
_TASK_BYTES = 8


def _dist(elems: float, unit: int) -> float:
    """``_classify``'s relative distance of ``elems`` to its nearest
    whole multiple of ``unit`` (1.0 where there is none)."""
    if unit <= 0 or elems <= 0 or round(elems / unit) < 1:
        return 1.0
    r = elems / unit
    return abs(r - round(r)) / r


def _model_entries(trace: tr.Trace, lids, scale: float, nv_p: int,
                   ne_p: int) -> list:
    """The buffers live at the peak as the model prices them: the port's
    change to ``lux_tpu``'s derivation, for two kinds of buffer a jaxpr
    of ``lux_tpu`` does not hold. The peak itself stays exact.

    - A buffer :func:`_classify` puts at ``m`` vertices or edges is
      priced at no less than ``m`` whole units, and one equally near
      both is taken as edges, the unit that grows faster at the bench
      scale (16 edges a vertex against the probe's 4.17). The tiled
      engine keeps one cell per distinct (source, destination) pair: the
      probe graph lists 10 of its 400 edges twice (390 cells, padded to
      392, as near 4 x 96 as 400), the sweep's 12 of 800. Priced at its
      bytes as vertices, the stream missed the sweep's traced peak by 32
      bytes (LUX704); at 400 edges, it costs its bound, one cell an
      edge.
    - A :class:`~lux_tpu_torch.ops.segment.RowTasks` schedule holds a
      task for every few rows or edges, too few at the probe to scale
      with either (3 tasks over 96 rows), and so priced as a constant it
      missed the sweep. It is priced at its bound, one task a row, as
      vertices; every schedule of the step (one a part on a mesh) is one
      entry.

    The calibrated constant takes the difference back, so the model
    still meets its own probe's peak."""
    out, rows = [], 0.0
    for lid in lids:
        buf = trace.buffers[lid]
        if buf.rows:
            rows += buf.rows * scale
            continue
        bytes_s, elems_s, itemsize = _entry(buf, scale)
        kind = _classify(abs(elems_s), nv_p, ne_p)
        if kind == "vertex" and abs(_dist(elems_s, ne_p)
                                    - _dist(elems_s, nv_p)) <= 1e-9:
            kind = "edge"
        if kind != "fixed":
            unit = nv_p if kind == "vertex" else ne_p
            elems_s = round(elems_s / unit) * unit
            bytes_s = max(bytes_s, elems_s * itemsize)
        out.append((bytes_s, elems_s, itemsize))
    if rows:
        out.append((rows * _TASK_BYTES, rows, _TASK_BYTES))
    return out


def target_peak_bytes(target: ir.TraceTarget, meta: dict,
                      trace: Optional[tr.Trace] = None) -> dict:
    """Derive one target's footprint evidence from its trace (traced
    here when none is given): the per-device peak in exact bytes, as
    ``_walk_scope`` prices avals, the attribution-derived model (over
    :func:`_model_entries`), staging bytes, and the donation report.
    Raises on trace failure."""
    if trace is None:
        trace = ir.trace_target(target)
    parts = max(1, int(meta.get("parts", 1)))
    scale = 1.0 / parts if parts > 1 else 1.0
    peak, lids, _ = _walk_lids(trace, scale)
    nv_p = max(1, math.ceil(int(meta["nv"]) / parts))
    ne_p = max(1, math.ceil(int(meta["ne"]) / parts))
    pv, pe, _ = _attribute(_model_entries(trace, lids, scale, nv_p, ne_p),
                           nv_p, ne_p)
    pv, pe = max(0.0, round(pv, 6)), max(0.0, round(pe, 6))
    # Calibrate the constant term against the *rounded* peak the
    # artifact persists, so the model bounds peak_bytes exactly at the
    # probe scale (calibrating against the float peak can land the
    # prediction a sub-byte hair under its own ceil).
    peak_i = int(math.ceil(peak))
    fixed = int(math.ceil(peak_i - pv * nv_p - pe * ne_p))
    return {
        "trace": trace,
        "peak_bytes": peak_i,
        "model": {"per_vertex_bytes": pv, "per_edge_bytes": pe,
                  "fixed_bytes": fixed},
        "staging_bytes": int(math.ceil(_staging_bytes(trace, scale))),
        "donation": _donation_report(target, trace),
    }


# -- per-target rules -----------------------------------------------------


def _bench_scales() -> List[Tuple[int, int]]:
    scale = flags.get_int("LUX_BENCH_SCALE")
    ef = flags.get_int("LUX_BENCH_EF")
    nv = 1 << scale
    return [(nv, nv * ef)]


def _capacity_bytes() -> Optional[int]:
    from lux_tpu_torch.obs import report

    cap = report.device_profile().get("hbm_capacity_bytes")
    return int(cap) if cap else None


def _check_budget(name: str, entry: dict, capacity: Optional[int],
                  scales: Sequence[Tuple[int, int]]) -> List[Finding]:
    if not capacity:
        return []
    out = []
    for nv, ne in scales:
        pred = eval_model(entry["model"], nv, ne, entry["parts"],
                          k=entry["k"], k_probe=entry["k"])
        if pred > capacity:
            out.append(_f(
                "LUX703", name,
                f"predicted per-device peak {_mib(pred)} at bench scale "
                f"nv={nv} ne={ne} exceeds the device HBM capacity "
                f"{_mib(capacity)} — overcommit fails closed here, not "
                "on-device"))
    return out


def _check_model_honesty(name: str, model: dict, traced_peak: float,
                         nv: int, ne: int, parts: int,
                         k: Optional[int] = None,
                         k_probe: Optional[int] = None) -> List[Finding]:
    tol = flags.get_float("LUX_MEM_MODEL_TOL")
    pred = eval_model(model, nv, ne, parts, k=k, k_probe=k_probe)
    if pred + 1e-6 < traced_peak:
        return [_f(
            "LUX704", name,
            f"model predicts {_mib(pred)} at nv={nv} ne={ne} P={parts} "
            f"but the traced peak is {_mib(traced_peak)} — the formula "
            "serving trusts under-estimates the footprint")]
    if (traced_peak > 0 and pred > traced_peak * (1.0 + tol)
            and pred - traced_peak > _OVERFAT_FLOOR_BYTES):
        return [_f(
            "LUX704", name,
            f"model predicts {_mib(pred)} at nv={nv} ne={ne} P={parts} "
            f"vs traced peak {_mib(traced_peak)} — slack exceeds "
            f"LUX_MEM_MODEL_TOL={tol:g}; an over-fat model rejects "
            "admissible engines")]
    return []


def _check_staging(name: str, target: ir.TraceTarget, trace: tr.Trace,
                   evidence: Optional[dict], staging: float,
                   parts: int) -> List[Finding]:
    out: List[Finding] = []
    mode = target.exchange_mode
    if mode in ("full", "compact", "frontier") and parts > 1:
        if staging <= 0:
            out.append(_f(
                "LUX705", name,
                f"{mode}-exchange target stages no data-collective "
                "buffers in the traced step — the exchange cost is "
                "missing from the peak accounting"))
        claim = target.exchange_bytes
        if claim is not None:
            totals = ir._collective_byte_totals(trace)
            if totals and claim not in totals:
                shown = sorted(totals)[:4]
                out.append(_f(
                    "LUX705", name,
                    f"exchange_bytes_per_iter() claims {claim} B/iter "
                    f"but the traced collectives move {shown} — the "
                    "staging the peak prices and the claim serving "
                    "reports have diverged"))
    if evidence:
        p = parts
        want = (p * (p - 1) * int(evidence.get("frontier_max_sends", 0))
                * int(evidence.get("frontier_row_bytes", 0)))
        got = int(evidence.get("frontier_bytes_per_iter", -1))
        if got != want or int(evidence.get("frontier_fill_active", 0)):
            out.append(_f(
                "LUX705", name,
                f"frontier_evidence() is internally inconsistent "
                f"(bytes_per_iter {got} vs P*(P-1)*max_sends*row_bytes "
                f"= {want}, fill_active "
                f"{evidence.get('frontier_fill_active')}) — the "
                "frontier staging bound cannot be trusted in the peak"))
    return out


_REGEN = ("regenerate with `luxlint --memory --memcap-out "
          "lux_tpu_torch/analysis/memcap.json`")


def _check_drift(name: str, committed: Optional[dict], entry: dict
                 ) -> List[Finding]:
    if committed is None:
        return []
    tol = flags.get_float("LUX_MEM_MODEL_TOL")
    cent = (committed.get("targets") or {}).get(name)
    if cent is None:
        return [_f(
            "LUX701", name,
            f"registry target {name!r} has no entry in the committed "
            f"memcap.v1 — {_REGEN}")]
    try:
        pred = eval_model(cent["model"], entry["probe"]["nv"],
                          entry["probe"]["ne"], entry["parts"],
                          k=entry["k"], k_probe=cent.get("k"))
    except (KeyError, TypeError, ValueError) as e:
        return [_f("LUX701", name,
                   f"committed memcap.v1 entry is malformed: {e!r}")]
    peak = float(entry["peak_bytes"])
    if pred + 1e-6 < peak or (peak > 0 and pred > peak * (1.0 + tol)):
        return [_f(
            "LUX706", name,
            f"committed admission formula predicts {_mib(pred)} but a "
            f"fresh trace peaks at {_mib(peak)} (tol "
            f"LUX_MEM_MODEL_TOL={tol:g}) — serving admits against a "
            "stale footprint; regenerate the memcap.v1 artifact")]
    return []


def validate_artifact(art, expect_names: Optional[Sequence[str]] = None,
                      path: str = "<memcap>") -> List[Finding]:
    """LUX701 structure checks over one memcap.v1-shaped dict."""
    out: List[Finding] = []
    if not isinstance(art, dict) or not isinstance(art.get("targets"),
                                                   dict):
        return [_f("LUX701", path,
                   "artifact is not a dict with a 'targets' mapping")]
    targets = art["targets"]
    if not targets:
        out.append(_f("LUX701", path, "artifact covers zero targets"))
    for name in sorted(targets):
        entry = targets[name]
        if not isinstance(entry, dict):
            out.append(_f("LUX701", path,
                          f"entry {name!r} is not a mapping"))
            continue
        model = entry.get("model")
        if not isinstance(model, dict) or sorted(model) != sorted(
                MODEL_FIELDS):
            out.append(_f(
                "LUX701", path,
                f"entry {name!r} model must carry exactly "
                f"{MODEL_FIELDS}, got "
                f"{sorted(model) if isinstance(model, dict) else model!r}"))
            continue
        bad = [fld for fld in MODEL_FIELDS
               if not isinstance(model[fld], (int, float))
               or not math.isfinite(float(model[fld]))]
        if bad or float(model["per_vertex_bytes"]) < 0 \
                or float(model["per_edge_bytes"]) < 0:
            out.append(_f(
                "LUX701", path,
                f"entry {name!r} has non-finite or negative model "
                f"coefficients ({ {f: model.get(f) for f in MODEL_FIELDS} })"
            ))
            continue
        peak = entry.get("peak_bytes")
        probe = entry.get("probe") or {}
        if not isinstance(peak, int) or peak <= 0:
            out.append(_f(
                "LUX701", path,
                f"entry {name!r} peak_bytes must be a positive int, "
                f"got {peak!r}"))
        if int(probe.get("nv") or 0) <= 0 or int(probe.get("ne") or 0) <= 0:
            out.append(_f(
                "LUX701", path,
                f"entry {name!r} probe dims must be positive "
                f"(got {probe!r})"))
    if expect_names:
        missing = sorted(set(expect_names) - set(targets))
        for name in missing:
            out.append(_f(
                "LUX701", path,
                f"registry target {name!r} is not covered by the "
                "artifact — every traced target must be priced"))
    return out


# -- registry + fixture runners -------------------------------------------


def _filter_select(result: FileResult,
                   select: Optional[Sequence[str]]) -> None:
    if select:
        keep = tuple(select)
        result.findings = [f for f in result.findings
                           if f.rule.startswith(keep)]


def _target_meta(ex, spec: dict, kind: str) -> dict:
    g = getattr(ex, "graph", None)
    parts = max(1, int(spec.get("num_parts", 0)
                       or getattr(ex, "num_parts", 1) or 1))
    fe = None
    fef = getattr(ex, "frontier_evidence", None)
    if callable(fef):
        try:
            fe = fef()
        # luxlint: disable=LUX007 -- evidence is advisory input, never fatal
        except Exception:
            fe = None
    return {
        "kind": kind,
        "nv": int(spec.get("nv", getattr(g, "nv", 0)) or 0),
        "ne": int(spec.get("ne", getattr(g, "ne", 0)) or 0),
        "parts": parts,
        "k": int(spec.get("k", getattr(ex, "k", 1) or 1)),
        "mode": str(spec.get("exchange_mode", "")),
        "frontier_evidence": fe or spec.get("frontier_evidence"),
    }


def _harvest(name: str, target: ir.TraceTarget, meta: dict,
             trace: Optional[tr.Trace] = None
             ) -> Tuple[Optional[dict], Optional[str]]:
    """Trace one target (unless its trace is given) and walk it — the
    evidence the rules consume. Registry callers run this in the untimed
    staging phase alongside executor construction; fixture targets
    harvest inline."""
    if meta["nv"] <= 0 or meta["ne"] <= 0:
        return None, (f"{name}: no probe graph dims (nv/ne) to "
                      "attribute the footprint against")
    try:
        return target_peak_bytes(target, meta, trace), None
    except Exception as e:   # traced user code: anything can raise
        return None, f"{name}: trace failed: {e!r}"


def _prove_target(name: str, target: ir.TraceTarget, meta: dict,
                  committed: Optional[dict],
                  capacity: Optional[int],
                  scales: Sequence[Tuple[int, int]],
                  ev: Optional[dict] = None,
                  err: Optional[str] = None
                  ) -> Tuple[FileResult, Optional[dict]]:
    if ev is None and err is None:
        ev, err = _harvest(name, target, meta)
    if ev is None:
        return FileResult(name, [], [], error=err), None
    findings: List[Finding] = []
    don = ev["donation"]
    if don["declared"] and don["checked"] and don["leak_bytes"]:
        findings.append(_f(
            "LUX702", name,
            f"{don['declared'] - don['aliased']} of {don['declared']} "
            "donated carry buffers are not reused by any output of the "
            "step — both copies stay live, adding "
            f"{_mib(don['leak_bytes'])} to the per-device peak (donation "
            "priced, not just audited)"))
    findings.extend(_check_staging(
        name, target, ev["trace"], meta.get("frontier_evidence"),
        ev["staging_bytes"], meta["parts"]))
    entry = {
        "kind": meta["kind"],
        "exchange_mode": meta["mode"],
        "parts": meta["parts"],
        "k": meta["k"],
        "value_dtype": target.value_dtype,
        "probe": {"nv": meta["nv"], "ne": meta["ne"]},
        "peak_bytes": ev["peak_bytes"],
        "staging_bytes": ev["staging_bytes"],
        "model": ev["model"],
        "donation": {k: don[k] for k in
                     ("declared", "aliased", "donated_bytes",
                      "leak_bytes")},
    }
    findings.extend(_check_budget(name, entry, capacity, scales))
    findings.extend(_check_drift(name, committed, entry))
    return FileResult(name, findings, []), entry


def stage_target(name: str, kind: str, ex, init_kw: dict) -> tuple:
    """One registry executor's (name, target, meta), its example args
    built: what a caller that keeps its own trace of the step (the trace
    tiers on the card) hands back to :func:`prove_staged`."""
    spec = ex.trace_step(**init_kw)
    target = ir.target_from_spec(name, spec)
    target.example_args()
    return name, target, _target_meta(ex, spec, kind)


def _stage_registry(device=None) -> List[tuple]:
    """Build every registry executor on ``device`` (``ir.
    _registry_executors``, the executors ``--ir`` traces), capture its
    trace spec, and trace and walk its step once.

    Executor construction and the trace are environment setup, not
    verification, so callers keep them outside the proof timer, the
    ``ir.run_*`` precedent."""
    staged = []
    for name, kind, ex, init_kw in ir._registry_executors(device=device):
        name, target, meta = stage_target(name, kind, ex, init_kw)
        ev, err = _harvest(name, target, meta)
        staged.append((name, target, meta, ev, err))
    return staged


def _sweep_targets(factor: int, device=None) -> List[tuple]:
    """One representative per engine kind, rebuilt on a probe graph
    ``factor`` x the base scale (LUX704's re-trace)."""
    from lux_tpu_torch.graph.generate import gnp
    from lux_tpu_torch.models import PROGRAMS, ROOTED_APPS, engine_kinds

    seen = set()
    out = []
    for i, name in enumerate(sorted(PROGRAMS)):
        program = PROGRAMS[name]()
        weighted = bool(getattr(program, "needs_weights", False))
        init_kw = {"start": 0} if name in ROOTED_APPS else {}
        for kind in engine_kinds(name):
            if kind in seen:
                continue
            seen.add(kind)
            graph = gnp(PROBE["nv"] * factor, PROBE["ne"] * factor,
                        seed=PROBE["seed"] + i, weighted=weighted)
            kw = {"device": device}
            if kind.endswith("sharded"):
                kw["num_parts"] = ir.REGISTRY_PARTS
            try:
                ex = ir.build_executor(kind, graph, program, **kw)
            # luxlint: disable=LUX007 -- a kind that cannot build at the swept scale is reported, not fatal
            except Exception:
                continue
            tname, target, meta = stage_target(f"{name}@{kind}", kind, ex,
                                               init_kw)
            ev, err = _harvest(tname, target, meta)
            out.append((tname, target, meta, ev, err))
    return out


def _load_committed() -> Tuple[Optional[dict], Optional[str]]:
    try:
        return load_memcap(memcap_path()), None
    except Exception as e:   # missing or tampered: one loud finding
        return None, repr(e)


def prove_staged(staged: Sequence[tuple], swept: Sequence[tuple] = (),
                 select: Optional[Sequence[str]] = None,
                 check_committed: bool = True,
                 capacity: Optional[int] = None,
                 scales: Optional[Sequence[Tuple[int, int]]] = None
                 ) -> Tuple[LintReport, dict]:
    """The rules over staged targets (``(name, target, meta, ev, err)``,
    ``ev`` the harvested evidence) and the sweep's; returns (report,
    memcap.v1). ``capacity`` defaults to the device profile's,
    ``scales`` to the bench scales."""
    t0 = time.perf_counter()
    committed, committed_err = (_load_committed() if check_committed
                                else (None, None))
    if capacity is None:
        capacity = _capacity_bytes()
    if scales is None:
        scales = _bench_scales()
    results: List[FileResult] = []
    targets_block: Dict[str, dict] = {}
    for name, target, meta, ev, err in staged:
        res, entry = _prove_target(name, target, meta, committed,
                                   capacity, scales, ev=ev, err=err)
        if entry is not None:
            targets_block[name] = entry
            # LUX704 at the base scale: the calibrated model must
            # reproduce its own probe (catches attribution bugs).
            res.findings.extend(_check_model_honesty(
                name, entry["model"], entry["peak_bytes"],
                meta["nv"], meta["ne"], meta["parts"]))
        _filter_select(res, select)
        results.append(res)
    # LUX704 sweep: the base-scale model must bound a re-trace at
    # factor x the probe, one representative per engine kind.
    for name, _target, meta, ev, err in swept:
        entry = targets_block.get(name)
        if entry is None:
            continue
        if ev is None:
            results.append(FileResult(
                f"{name}+sweep", [], [], error=f"sweep: {err}"))
            continue
        res = FileResult(f"{name}+sweep", _check_model_honesty(
            name, entry["model"], ev["peak_bytes"],
            meta["nv"], meta["ne"], meta["parts"],
            k=meta["k"], k_probe=entry["k"]), [])
        _filter_select(res, select)
        results.append(res)
    art = build_memcap(targets_block, dict(
        PROBE, sweep_factor=max(2, flags.get_int("LUX_MEM_SWEEP_FACTOR")),
        tol=flags.get_float("LUX_MEM_MODEL_TOL")))
    structural = validate_artifact(art, path="<memcap:derived>")
    if committed is not None:
        structural += validate_artifact(
            committed, expect_names=sorted(targets_block),
            path="<memcap:committed>")
    elif check_committed:
        structural.append(_f(
            "LUX701", "<memcap:committed>",
            f"committed memcap.v1 unusable ({committed_err}) — {_REGEN}"))
    if structural:
        res = FileResult("<memcap>", structural, [])
        _filter_select(res, select)
        results.append(res)
    return (LintReport(results, time.perf_counter() - t0,
                       schema=MEMORY_SCHEMA), art)


def prove_registry(select: Optional[Sequence[str]] = None,
                   check_committed: bool = True, device=None
                   ) -> Tuple[LintReport, dict]:
    """Walk every traced registry target on ``device`` (``cuda`` unless
    named) and the LUX_MEM_SWEEP_FACTOR sweep; returns (report,
    memcap.v1).

    ``check_committed=False`` skips the committed-artifact rules
    (LUX701 coverage, LUX706 drift) — the regeneration path, where
    staleness is exactly what is being fixed."""
    staged = _stage_registry(device)
    factor = max(2, flags.get_int("LUX_MEM_SWEEP_FACTOR"))
    swept = _sweep_targets(factor, device)
    return prove_staged(staged, swept, select, check_committed)


def verify_registry(select: Optional[Sequence[str]] = None,
                    memcap_out: Optional[str] = None,
                    device=None) -> LintReport:
    report, art = prove_registry(select,
                                 check_committed=memcap_out is None,
                                 device=device)
    if memcap_out and report.ok:
        save_memcap(art, memcap_out)
    return report


_FIXTURE_SEQ = [0]


def _load_fixture(path: str):
    if ir._imports_jax(path):
        raise ImportError(
            f"{path} imports jax or lux_tpu: the port traces torch "
            "steps (its fixtures are tests/torch_mem_fixtures/); run "
            "tools/luxlint.py for this one")
    _FIXTURE_SEQ[0] += 1
    modname = f"_memck_fixture_{_FIXTURE_SEQ[0]}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)   # type: ignore[union-attr]
    return mod


class _NoExecutor:
    """Fixture targets carry their own dims; nothing to introspect."""


def verify_fixture_paths(paths: Sequence[str],
                         select: Optional[Sequence[str]] = None
                         ) -> LintReport:
    """Check standalone fixture modules (tests/torch_mem_fixtures/) —
    each rule only engages when the fixture supplies its inputs, so a
    fixture fails with exactly the rule it seeds."""
    t0 = time.perf_counter()
    results: List[FileResult] = []
    for path in iter_python_files(paths):
        try:
            mod = _load_fixture(path)
        except Exception as e:
            results.append(FileResult(
                path, [], [], error=f"{path}: unloadable fixture: {e!r}"))
            continue
        targets = getattr(mod, "TARGETS", None) or {}
        models = getattr(mod, "MODELS", None) or {}
        memcap = getattr(mod, "MEMCAP", None)
        committed = getattr(mod, "COMMITTED", None)
        capacity = getattr(mod, "CAPACITY_BYTES", None)
        scales = getattr(mod, "SCALES", None)
        if not targets and memcap is None:
            results.append(FileResult(
                path, [], [],
                error=f"{path}: defines neither TARGETS nor MEMCAP"))
            continue
        findings: List[Finding] = []
        if memcap is not None:
            findings.extend(validate_artifact(
                memcap, expect_names=sorted(targets), path=path))
        for name in sorted(targets):
            spec = dict(targets[name])
            target = ir.target_from_spec(name, spec)
            meta = _target_meta(_NoExecutor(), spec, spec.get("kind", ""))
            res, entry = _prove_target(
                name, target, meta, committed,
                int(capacity) if capacity else None,
                [tuple(s) for s in scales] if scales
                else ([(meta["nv"], meta["ne"])] if capacity else []))
            findings.extend(res.findings)
            if res.error:
                results.append(FileResult(path, [], [], error=res.error))
            if entry is not None and name in models:
                findings.extend(_check_model_honesty(
                    name, models[name], entry["peak_bytes"],
                    meta["nv"], meta["ne"], meta["parts"]))
        res = FileResult(path, findings, [])
        _filter_select(res, select)
        results.append(res)
    return LintReport(results, time.perf_counter() - t0,
                      schema=MEMORY_SCHEMA)


# -- the memcap.v1 artifact -----------------------------------------------


def _cap_id(targets: dict, probe: dict) -> str:
    blob = json.dumps({"probe": probe, "targets": targets},
                      sort_keys=True)
    return "memcap-" + hashlib.sha1(blob.encode()).hexdigest()[:12]


def build_memcap(targets: dict, probe: dict) -> dict:
    return {
        "schema": CAP_SCHEMA,
        "id": _cap_id(targets, probe),
        "probe": probe,
        "targets": targets,
        "created_at": time.time(),  # luxlint: disable=LUX006 -- artifact timestamp is unix wall time
    }


def save_memcap(art: dict, path: str) -> str:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(art, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def load_memcap(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        art = json.load(fh)
    if art.get("schema") != CAP_SCHEMA:
        raise ValueError(
            f"{path}: schema {art.get('schema')!r}, expected {CAP_SCHEMA!r}")
    want = _cap_id(art.get("targets") or {}, art.get("probe") or {})
    if art.get("id") != want:
        raise ValueError(
            f"{path}: id {art.get('id')!r} does not match content hash "
            f"{want!r} (tampered or hand-edited footprint artifact)")
    return art


def memcap_path() -> str:
    d = flags.get("LUX_MEMCAP_DIR")
    if d:
        return os.path.join(d, CAP_FILENAME)
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        CAP_FILENAME)


# -- consumers: the serving admission formula -----------------------------

# (path, mtime) -> artifact; the committed file changes once per
# regeneration, so a stat per lookup is the whole invalidation story.
_COMMITTED_CACHE: Dict[Tuple[str, float], Optional[dict]] = {}


def _committed() -> Optional[dict]:
    path = memcap_path()
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return None
    key = (path, mtime)
    if key not in _COMMITTED_CACHE:
        _COMMITTED_CACHE.clear()
        try:
            _COMMITTED_CACHE[key] = load_memcap(path)
        except (OSError, ValueError):
            # Tampered/unreadable: admission runs open (None) and
            # luxlint --memory is the gate that fails loudly.
            _COMMITTED_CACHE[key] = None
    return _COMMITTED_CACHE[key]


def predicted_engine_bytes(app: str, kind: str, exchange_mode: str,
                           nv: int, ne: int, parts: int, k: int = 1,
                           art: Optional[dict] = None) -> Optional[int]:
    """Serving's admission formula: per-device predicted resident bytes
    for one engine build, from the committed memcap.v1 models. None
    when no artifact (or no matching entry) is available — admission
    then runs open; LUX706 keeps this formula honest against fresh
    traces."""
    art = art if art is not None else _committed()
    if art is None:
        return None
    targets = art.get("targets") or {}
    names = [f"{app}@{kind}"]
    if exchange_mode in ("compact", "frontier"):
        names.insert(0, f"{app}@{kind}+{exchange_mode}")
    entry = next((targets[n] for n in names if n in targets), None)
    if entry is None:
        # Unknown app under a known kind: price it as the costliest
        # same-kind entry (upper-bound bias, never a free pass).
        same = [e for t, e in targets.items()
                if t.split("@", 1)[-1].split("+", 1)[0] == kind]
        if not same:
            return None
        entry = max(same, key=lambda e: e.get("peak_bytes", 0))
    try:
        return int(eval_model(entry["model"], nv, ne, parts,
                              k=k, k_probe=entry.get("k")))
    except (KeyError, TypeError, ValueError):
        return None


def hbm_budget_bytes() -> Optional[int]:
    """The per-device HBM budget the pool admits under:
    LUX_HBM_BUDGET_BYTES when set, else device-profile capacity x
    LUX_HBM_BUDGET_FRAC; None (no budget — admit freely) when neither
    yields a positive number."""
    b = flags.get_int("LUX_HBM_BUDGET_BYTES")
    if b > 0:
        return b
    cap = _capacity_bytes()
    if not cap:
        return None
    return int(cap * flags.get_float("LUX_HBM_BUDGET_FRAC"))
