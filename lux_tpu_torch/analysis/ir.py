"""luxlint's trace tiers over the port: the IR rules (LUX101-105) and
the exchange dataflow rules (LUX404-406) over a torch trace of each
executor's real step; the counterpart of ``lux_tpu/analysis/ir.py``.

``lux_tpu`` traces every registered program on every capable executor
kind to a jaxpr and walks its equations. Here the step is traced by
:func:`~lux_tpu_torch.analysis.trace.trace_call`: it runs once, on the
target's device (the card unless the caller asks for the CPU), and its
aten ops, kernels (``lux.<kernel>``), mesh collectives and host reads
are the nodes the rules walk, numbered 1.. in execution order (a
finding's line; 0 is a target-level finding):

- LUX101 dtype-drift: a carry leaf whose dtype differs between the
  step's input and output, or a 64-bit float (or complex) value made
  from no 64-bit input. int64 is torch's index dtype (every ``long()``,
  ``sum`` of a bool, ``nonzero``, ``cumsum``) and is not counted: a
  jaxpr without x64 has no int64 to count either;
- LUX102 host-callback: a host read inside the step (``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, a scalar read, a copy to the
  CPU, ``torch.cuda.synchronize``): a device->host round trip per
  iteration. The push and GAS loops' one counter read an iteration is
  not part of the traced step (their ``trace_step`` stops before it);
- LUX103 footprint-blowup: a buffer a node makes larger than
  ``LUX_IR_BLOWUP`` x the step's input bytes (the example args and every
  pinned buffer the step reads: the device graph, scratch);
- LUX104 donation-audit: an arg declared in ``donate`` whose storage no
  output of the step reuses, by storage identity (the counterpart of
  reading the lowered module's aliasing);
- LUX105 collective-audit: a collective in a single-shard trace, or a
  sharded trace with none (on one card ``LocalMesh.all_gather`` is a
  view, and still one collective node).

Executors participate by ``trace_step(**init_kw)`` returning
``lux_tpu``'s plain dict (no dependency on this module)::

    {"kind": "pull",            # executor kind, for the target name
     "call": fn,                # callable(*args) -> the step's outputs
     "args": (vals,),           # example args (copies are traced), or
                                # a callable that builds them
     "donate": (),              # argnums whose storage an output reuses
     "carry": (0,),             # argnums whose leaves are the carry
     "sharded": False}          # True when collectives are expected

with ``fn`` accepted for ``call``. The executors give ``args`` as a
builder, called when a trace first needs them, so that a reader of the
declaration alone (the pool's LUX104 audit of a step that donates
nothing) builds no state. The sharded executors add
``exchange_mode``, ``exchange_bytes``, ``combiner``, ``value_dtype``,
``num_parts`` and ``plan``. The contract relied on by LUX101: the
step's flattened outputs begin with the new carry, leaf for leaf against
the flattened carry args.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lux_tpu_torch.analysis import trace as tr
from lux_tpu_torch.analysis.core import FileResult, Finding, LintReport
from lux_tpu_torch.utils import flags

__all__ = ["IR_SCHEMA", "TraceTarget", "all_ir_rules", "audit_engine",
           "audit_target", "build_executor", "check_target",
           "engine_target", "exchange_ir_rules", "load_fixture_targets",
           "registry_targets", "run_exchange_matrix", "run_exchange_paths",
           "run_targets", "target_from_spec", "trace_target"]

IR_SCHEMA = "luxlint.ir.v1"

# Node names of the cross-device collectives (LUX105) and of the data
# plane (LUX404-406): the collectives that MOVE value rows between
# parts. reduce_scatter combines (psum_scatter's place) and is priced
# by no exchange_bytes_per_iter model.
COLLECTIVE_PRIMS = ("all_gather", "all_to_all", "reduce_scatter")
DATA_COLLECTIVE_PRIMS = tr.DATA_COLLECTIVES

# Parts of every sharded registry executor: ``lux_tpu``'s tier runs on 8
# virtual CPU devices, and its sharded executors default to all of them.
REGISTRY_PARTS = 8


@dataclasses.dataclass
class TraceTarget:
    """One traceable step: a callable + example args + audit metadata."""

    name: str                       # e.g. "pagerank@pull"
    call: Callable                  # callable(*args) -> step outputs
    args: object = ()               # example args, or their builder
    donate: Tuple[int, ...] = ()    # argnums whose storage an output reuses
    carry: Tuple[int, ...] = (0,)   # argnums whose leaves are the carry
    sharded: bool = False           # collectives expected iff True
    # Exchange-tier metadata (LUX404-406); plan-carrying sharded
    # executors expose these in their trace dicts, everything else
    # leaves the defaults and the LUX40x rules skip the target.
    exchange_mode: str = ""   # "full" / "compact" / "frontier" ("" = flat)
    exchange_bytes: Optional[int] = None  # exchange_bytes_per_iter claim
    combiner: str = ""              # program combiner ("min"/"max"/"sum")
    value_dtype: str = ""           # dtype of the exchanged value rows
    num_parts: int = 0              # mesh parts the step is mapped over
    plan: object = None             # the live ExchangePlan (compact only)
    kind: str = ""                  # executor kind

    def example_args(self) -> tuple:
        """The example args, built on first use where the spec gave a
        builder."""
        if callable(self.args):
            self.args = tuple(self.args())
        return self.args


def _args_of(args):
    return args if callable(args) else tuple(args)


def target_from_spec(name: str, spec: dict) -> TraceTarget:
    """Normalize an executor's (or fixture's) trace dict to a target."""
    call = spec.get("call", spec.get("fn"))
    if call is None:
        raise ValueError(f"trace spec {name!r} has neither 'call' nor 'fn'")
    eb = spec.get("exchange_bytes")
    return TraceTarget(
        name=name, call=call, args=_args_of(spec.get("args", ())),
        donate=tuple(spec.get("donate", ())),
        carry=tuple(spec.get("carry", (0,))),
        sharded=bool(spec.get("sharded", False)),
        exchange_mode=str(spec.get("exchange_mode", "")),
        exchange_bytes=None if eb is None else int(eb),
        combiner=str(spec.get("combiner", "")),
        value_dtype=str(spec.get("value_dtype", "")),
        num_parts=int(spec.get("num_parts", 0)),
        plan=spec.get("plan"),
        kind=str(spec.get("kind", "")),
    )


def trace_target(target: TraceTarget) -> tr.Trace:
    """Run the target's step once, on copies of its example args, under
    the recorder."""
    return tr.trace_call(target.call, tr.clone_args(target.example_args()))


def _dname(dtype: torch.dtype) -> str:
    """A torch dtype's name as numpy spells it (``float32``,
    ``bfloat16``)."""
    return str(dtype).replace("torch.", "")


def _storage_dtype(value_dtype: str) -> Optional[torch.dtype]:
    """The torch storage of a program's value dtype: uint32 values live
    in int32 words (``ops/segment.py``)."""
    if not value_dtype:
        return None
    if value_dtype == "uint32":
        return torch.int32
    return getattr(torch, value_dtype, None)


# -- the rules ----------------------------------------------------------

class IRRule:
    """One IR rule: an id, a one-line doc, a check over a trace."""

    id = "LUX100"
    title = "base ir rule"
    doc = ""

    def check(self, trace, target: TraceTarget) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, target: TraceTarget, line: int, message: str) -> Finding:
        # `line` is the 1-based node ordinal of the trace (0 = a
        # target-level finding with no single node to blame).
        return Finding(self.id, target.name, line, 0, message)


def _carry_leaves(target: TraceTarget, trace) -> list:
    """The flat input leaves of the carry args (args flatten in order)."""
    out, pos = [], 0
    for i, a in enumerate(target.example_args()):
        n = len(tr.leaves(a))
        if i in target.carry:
            out.extend(trace.in_leaves[pos:pos + n])
        pos += n
    return out


def _dtype_of(leaf):
    return getattr(leaf, "dtype", None)


class DtypeDrift(IRRule):
    id = "LUX101"
    title = "dtype-drift"
    doc = ("carry dtype must be identical between loop input and output; "
           "no silent promotion to 64-bit dtypes inside the step")

    @staticmethod
    def _wide(dtype) -> bool:
        # int64 is torch's index dtype; see the module docstring.
        return isinstance(dtype, torch.dtype) and (
            dtype.is_complex or (dtype.is_floating_point
                                 and dtype.itemsize >= 8))

    def check(self, trace, target: TraceTarget) -> Iterable[Finding]:
        carry = _carry_leaves(target, trace)
        outs = trace.out_leaves
        if len(carry) > len(outs):
            yield self.finding(
                target, 0,
                f"carry has {len(carry)} leaves but the step returns "
                f"only {len(outs)} outputs — the carry cannot round-"
                "trip through this step",
            )
            return
        for j, leaf in enumerate(carry):
            din, dout = _dtype_of(leaf), _dtype_of(outs[j])
            if din is not None and dout is not None and din != dout:
                yield self.finding(
                    target, 0,
                    f"carry leaf {j} enters as {_dname(din)} and "
                    f"leaves as {_dname(dout)} — every iteration "
                    "converts (or retraces) the carry",
                )
        if any(self._wide(_dtype_of(x)) for x in trace.in_leaves):
            return   # 64-bit inputs make 64-bit intermediates legitimate
        for node in trace.nodes:
            for r, fresh in zip(node.outputs, node.fresh):
                if fresh and self._wide(r.dtype):
                    yield self.finding(
                        target, node.index,
                        f"`{node.op}` silently promotes to "
                        f"{_dname(r.dtype)} with no 64-bit input — "
                        "x64 drift doubles HBM for the affected values",
                    )


class HostCallback(IRRule):
    id = "LUX102"
    title = "host-callback"
    doc = ("no host read (.item/.tolist/.cpu/.numpy, a scalar read, "
           "torch.cuda.synchronize) inside a hot-path step (hidden host "
           "round trip per iteration)")

    def check(self, trace, target: TraceTarget) -> Iterable[Finding]:
        for node in trace.nodes:
            if node.kind == "host":
                yield self.finding(
                    target, node.index,
                    f"host callback `{node.op}` in the traced step — "
                    "every iteration stalls on a device->host->device "
                    "round trip",
                )


class FootprintBlowup(IRRule):
    id = "LUX103"
    title = "footprint-blowup"
    doc = ("no traced intermediate may exceed LUX_IR_BLOWUP x the "
           "step's total input bytes (static per-node cost model)")

    def check(self, trace, target: TraceTarget) -> Iterable[Finding]:
        ratio = flags.get_float("LUX_IR_BLOWUP")
        base = trace.input_bytes()
        limit = ratio * max(base, 1)
        for node in trace.nodes:
            for r, fresh in zip(node.outputs, node.fresh):
                if fresh and r.nbytes > limit:
                    yield self.finding(
                        target, node.index,
                        f"`{node.op}` materializes {r.shape} "
                        f"{_dname(r.dtype)} "
                        f"({r.nbytes / 2**20:.1f} MiB) = "
                        f"{r.nbytes / max(base, 1):.0f}x the step inputs "
                        f"(limit {ratio:g}x, LUX_IR_BLOWUP)",
                    )


class DonationAudit(IRRule):
    id = "LUX104"
    title = "donation-audit"
    doc = ("every donated arg's storage must be reused by an output of "
           "the step (else the donation buys nothing and HBM holds two "
           "copies)")

    def check(self, trace, target: TraceTarget) -> Iterable[Finding]:
        if not target.donate:
            return
        donated = set()
        for i in target.donate:
            if i < len(trace.arg_lids):
                donated |= trace.arg_lids[i]
        expected = len(donated)
        if expected == 0:
            return
        reused = {r.lid for r in trace.out_leaves if isinstance(r, tr.Ref)}
        missing = len(donated - reused)
        if missing:
            yield self.finding(
                target, 0,
                f"{missing} of {expected} donated buffers are not aliased "
                "to any output — the executable copies instead of reusing "
                "them",
            )


class CollectiveAudit(IRRule):
    id = "LUX105"
    title = "collective-audit"
    doc = ("collectives (all_gather/all_to_all/reduce_scatter) must not "
           "appear in single-shard traces and must appear in sharded "
           "exchange traces")

    @staticmethod
    def _is_collective(node) -> bool:
        return node.kind == "collective" and node.op in COLLECTIVE_PRIMS

    def check(self, trace, target: TraceTarget) -> Iterable[Finding]:
        seen = [n for n in trace.nodes if self._is_collective(n)]
        if target.sharded and not seen:
            yield self.finding(
                target, 0,
                "sharded exchange trace contains no collective — shards "
                "never communicate, so every shard computes on stale "
                "neighbor values",
            )
        if not target.sharded:
            for n in seen:
                yield self.finding(
                    target, n.index,
                    f"collective `{n.op}` in a single-shard trace — "
                    "either dead cross-device traffic or a program "
                    "traced with the wrong executor",
                )


def all_ir_rules() -> List[IRRule]:
    return [
        DtypeDrift(),
        HostCallback(),
        FootprintBlowup(),
        DonationAudit(),
        CollectiveAudit(),
    ]


# -- the exchange tier: collective-dataflow rules (LUX404-406) ----------
#
# The trace half of ``luxlint --exchange``. The plan tables are verified
# in analysis/exchck.py (LUX401-403, 407); these rules prove what only
# the traced step can show: that the local contribution is data-
# independent of the collective (the overlap contract), that pad values
# annihilate under the program's combiner, and that the advertised
# per-iteration collective bytes match what the step moves.


def _is_data_collective(node) -> bool:
    return node.kind == "collective" and node.op in DATA_COLLECTIVE_PRIMS


def _merges(trace) -> List[Tuple[int, list]]:
    """(buffer, its write nodes) of every local/remote merge point: a
    buffer that holds a data collective's result and meets a second
    data side in place. A buffer made by a collective and written
    (``dynamic_update_slice``'s place), or written twice with one write
    whose inputs came from a collective (``select_n``'s place), is
    one."""
    writes = {}
    for node in trace.nodes:
        for w in node.writes:
            writes.setdefault(w.lid, []).append(node)
    out = []
    for lid, nodes in writes.items():
        b = trace.buffers[lid]
        made_by = trace.nodes[b.defined_by - 1] if b.defined_by else None
        gathered = made_by is not None and _is_data_collective(made_by)
        if gathered or (len(nodes) > 1 and any(n.taint for n in nodes)):
            out.append((lid, nodes))
    return out


def _combiner_identity(combiner: str, dtype) -> Optional[float]:
    """The annihilator value for a combiner over ``dtype`` — mirrors
    ops/segment.identity_for."""
    dt = np.dtype(dtype)
    if combiner == "sum":
        return 0.0
    if combiner == "min":
        return float(np.inf) if dt.kind == "f" else float(np.iinfo(dt).max)
    if combiner == "max":
        return float(-np.inf) if dt.kind == "f" else float(np.iinfo(dt).min)
    return None


class OverlapProof(IRRule):
    id = "LUX404"
    title = "overlap-proof"
    doc = ("compact targets must merge an untainted input-derived local "
           "contribution against the collective's result — proves the "
           "local-edge work is data-independent of the exchange")

    def check(self, trace, target: TraceTarget) -> Iterable[Finding]:
        """``lux_tpu``'s merge points are a ``select_n`` on an
        ``axis_index`` predicate and a ``dynamic_update_slice`` at an
        axis offset. The port's merge is an in-place write into a buffer
        that holds the collective's result: ``CompactExchange.tables``'
        two ``index_copy_`` (the remote rows from the ``all_to_all``,
        then the own span from the local shard) and
        ``FrontierExchange.tables``' value and frontier tables. The
        merge is proven iff one write's data is an untainted function
        of the step's own args: the local contribution."""
        # Frontier targets keep the compact plan's packed all_to_all as
        # the downgrade branch, so the same merge proof applies.
        if target.exchange_mode not in ("compact", "frontier"):
            return
        if not any(_is_data_collective(n) for n in trace.nodes):
            return   # no exchange traced at all — LUX105's finding
        good, bad = [], []
        for _, nodes in _merges(trace):
            local = any(n.data is not None and n.data_input
                        and not n.data_taint for n in nodes)
            (good if local else bad).append(nodes[0])
        if good:
            return   # overlap proven: local side never waits on the wire
        if bad:
            node = bad[0]
            yield self.finding(
                target, node.index,
                f"local/remote merge `{node.op}` consumes the "
                "collective's result on every data side — the local-edge "
                "contribution transitively depends on the exchange, so "
                "the advertised compute/communication overlap cannot "
                "exist",
            )
        else:
            yield self.finding(
                target, 0,
                "no local/remote merge point found downstream of the "
                "data collective — cannot prove the local-edge "
                "contribution is independent of the exchange",
            )


class SentinelAnnihilator(IRRule):
    id = "LUX405"
    title = "sentinel-annihilator"
    doc = ("pad values merged into the exchanged data path must be the "
           "program combiner's identity (+inf/int-max for min, 0 for "
           "sum) so sentinel traffic can never reach a result")

    def check(self, trace, target: TraceTarget) -> Iterable[Finding]:
        """``lux_tpu``'s pads are the constant case of a ``select_n``
        whose other case carries exchanged candidates (and, for sums,
        the fill a ``scatter`` adds into). The port's pad is the fill of
        a buffer made by a constant creation op (``new_full``,
        ``zeros``, ...: ``CompactExchange``'s table, ``FrontierExchange``'s
        value table) that an in-place write then fills with the
        collective's rows, and the constant case of a ``torch.where``
        whose other case carries them. uint32 values are compared as
        uint32 (their int32 words, ``-1`` for min's ``0xFFFFFFFF``)."""
        if target.exchange_mode not in ("compact", "frontier") or \
                target.combiner not in ("min", "max", "sum"):
            return
        comb = target.combiner
        vdt = _storage_dtype(target.value_dtype)
        vnp = np.dtype(target.value_dtype) if target.value_dtype else None
        bufs = trace.buffers
        wrong, found, seen_pad = [], False, set()

        def pad(node, lid, dt, val):
            nonlocal found
            if dt == torch.bool or (vdt is not None and dt != vdt):
                return   # frontier masks / index planes: not the values
            vt = vnp if vnp is not None else np.dtype(_dname(dt))
            if vt == np.uint32 and dt == torch.int32:
                val = int(val) & 0xFFFFFFFF
            ident = _combiner_identity(comb, vt)
            if float(val) == ident:
                found = True
            elif lid not in seen_pad:
                seen_pad.add(lid)
                wrong.append((node, float(val), ident, vt))

        saw = False
        for node in trace.nodes:
            if _is_data_collective(node):
                saw = True
            for w in node.writes:
                b = bufs[w.lid]
                if b.fill is not None and (node.taint or node.data_taint):
                    pad(node, w.lid, b.dtype, b.fill)
            if node.op.startswith("aten.where.") and len(node.args) == 3:
                cases = node.args[1:]
                if not any(bufs[c.lid].tainted for c in cases):
                    continue
                for c in cases:
                    b = bufs[c.lid]
                    if b.fill is not None and c.version == b.fill_version:
                        pad(node, c.lid, node.outputs[0].dtype, b.fill)
        for node, val, ident, dt in wrong:
            yield self.finding(
                target, node.index,
                f"pad constant {val:g} flows into the exchanged data "
                f"path through `{node.op}` but the {comb} identity for "
                f"{np.dtype(dt).name} is {ident:g} — sentinel slots leak "
                "into results",
            )
        if saw and not wrong and not found:
            yield self.finding(
                target, 0,
                f"no {comb}-identity pad constant guards the exchanged "
                "candidates — cannot prove sentinel traffic is "
                "annihilated before the combiner",
            )


def _collective_byte_totals(trace, nodes=None, depth: int = 0) -> set:
    """Set of possible per-iteration data-collective byte totals of one
    step. A set, not a number: :func:`~lux_tpu_torch.analysis.trace.
    alternatives` branches are execution ALTERNATIVES (the host's
    direction and branch choice), so each contributes its own total;
    everything else composes additively. Each collective node carries
    the whole mesh's bytes as ``lux_tpu`` prices them: all_gather
    ``P * (P-1) * operand``, all_to_all ``(P-1) * operand``, operand one
    part's array."""
    nodes = trace.nodes if nodes is None else nodes
    totals = {0}
    groups = {}
    for n in nodes:
        if len(n.alt) > depth:
            g, b = n.alt[depth][:2]
            groups.setdefault(g, {}).setdefault(b, []).append(n)
        elif _is_data_collective(n):
            totals = {t + n.nbytes for t in totals}
    for g, branches in groups.items():
        alts = set()
        for b in range(max(trace.groups.get(g, 0), len(branches))):
            alts |= _collective_byte_totals(trace, branches.get(b, []),
                                            depth + 1)
        totals = {t + a for t in totals for a in alts}
        if len(totals) > 1024:   # runaway-branch backstop
            totals = set(sorted(totals)[:1024])
    return totals


class ExchangeByteAccounting(IRRule):
    id = "LUX406"
    title = "exchange-byte-accounting"
    doc = ("the executor's exchange_bytes_per_iter claim must equal the "
           "per-iteration data-collective bytes derived from the traced "
           "step")

    def check(self, trace, target: TraceTarget) -> Iterable[Finding]:
        """Compares the claim with the collective nodes' bytes
        (:func:`_collective_byte_totals`)."""
        if target.exchange_bytes is None or target.num_parts < 2:
            return
        totals = _collective_byte_totals(trace)
        if int(target.exchange_bytes) not in totals:
            shown = ", ".join(str(t) for t in sorted(totals)[:8])
            yield self.finding(
                target, 0,
                f"executor claims exchange_bytes_per_iter = "
                f"{target.exchange_bytes} but the traced step's data "
                f"collectives move {{{shown}}} bytes per iteration "
                "(all_gather P*(P-1)*operand, all_to_all (P-1)*operand; "
                "alternative branches are alternatives) — the byte model "
                "drifted from the exchange the step performs",
            )


def exchange_ir_rules(select=None) -> List[IRRule]:
    rules: List[IRRule] = [
        OverlapProof(), SentinelAnnihilator(), ExchangeByteAccounting(),
    ]
    if select:
        rules = [r for r in rules if r.id in select]
    return rules


# -- runner -------------------------------------------------------------

def check_target(target: TraceTarget, rules: Sequence[IRRule],
                 keep: Optional[list] = None) -> FileResult:
    """Trace one target and run the given rules over its trace; a trace
    that fails is the target's error. ``keep`` collects the trace."""
    try:
        trace = trace_target(target)
    except Exception as e:   # traced user code: anything can raise
        return FileResult(
            target.name, [], [],
            error=f"{target.name}: trace failed: {e!r}")
    if keep is not None:
        keep.append(trace)
    findings: List[Finding] = []
    errors: List[str] = []
    for rule in rules:
        try:
            findings.extend(rule.check(trace, target))
        except Exception as e:
            errors.append(f"{target.name}: {rule.id} crashed: {e!r}")
    findings.sort(key=lambda f: (f.line, f.rule))
    return FileResult(
        target.name, findings, [], error="; ".join(errors) or None)


def run_targets(targets: Sequence[TraceTarget],
                rules: Optional[Sequence[IRRule]] = None) -> LintReport:
    """Trace every target and run the IR rules over the traces."""
    t0 = time.perf_counter()
    if rules is None:
        rules = all_ir_rules()
    results = [check_target(t, rules) for t in targets]
    return LintReport(results, time.perf_counter() - t0, schema=IR_SCHEMA)


# -- the registry trace matrix ------------------------------------------

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


def registry_targets(include_sharded: bool = True,
                     device=None) -> List[TraceTarget]:
    """Trace targets for every registered program x capable executor on
    ``device`` (``cuda`` unless named; see ``_registry_executors`` for
    the compact and frontier variants). Their example args are built
    beside their executors."""
    out = []
    for name, _, ex, init_kw in _registry_executors(include_sharded,
                                                    device=device):
        out.append(target_from_spec(name, ex.trace_step(**init_kw)))
        out[-1].example_args()
    return out


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
    """``luxlint --exchange`` with no paths: the LUX404-406 dataflow
    rules over every full, compact and frontier sharded registry target
    on ``device`` (``cuda`` unless named), plus the LUX401-403/407 plan
    rules over each live compact plan (reported as ``{target}/plan``)."""
    from lux_tpu_torch.analysis import exchck

    ir_rules = exchange_ir_rules(select)
    plan_rules = _plan_rules(select)
    # Executor construction is environment setup, not verification —
    # kept outside the timer as lux_tpu's tier does.
    staged = list(_registry_executors(sharded_only=True, device=device))
    results: List[FileResult] = []
    t0 = time.perf_counter()
    for name, kind, ex, init_kw in staged:
        t = target_from_spec(name, ex.trace_step(**init_kw))
        results.append(check_target(t, ir_rules))
        if t.plan is not None:
            view = exchck.plan_view(
                t.plan, declared_bytes_per_iter=t.exchange_bytes,
                **_plan_evidence(kind, ex, t.plan))
            results.append(exchck.verify_exchange_plan(
                view, f"{name}/plan", plan_rules))
    return LintReport(results, time.perf_counter() - t0,
                      schema=exchck.EXCHANGE_SCHEMA)


def run_exchange_paths(paths: Sequence[str], select=None) -> LintReport:
    """``luxlint --exchange`` over explicit paths: ``.py`` fixtures
    exposing ``TRACES`` (LUX404-406) and/or ``PLANS`` (plan rules), and
    saved exchange-artifact directories (of either package). A fixture
    that imports jax is reported as an error and never executed: the
    port traces torch steps only."""
    from lux_tpu_torch.analysis import exchck

    t0 = time.perf_counter()
    ir_rules = exchange_ir_rules(select)
    plan_rules = _plan_rules(select)
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
            results.append(
                exchck.verify_exchange_plan(view, path, plan_rules))
            continue
        try:
            has_plans, has_traces = exchck.fixture_exports(path)
            targets = load_fixture_targets(path) if has_traces else []
            plans = exchck.load_fixture_plans(path) if has_plans else []
        except Exception as e:
            results.append(FileResult(
                path, [], [], error=f"{path}: unloadable fixture: {e!r}"))
            continue
        if not targets and not plans:
            results.append(FileResult(
                path, [], [],
                error=f"{path}: fixture exposes neither TRACES nor PLANS"))
            continue
        results.extend(check_target(t, ir_rules) for t in targets)
        results.extend(exchck.verify_exchange_plan(v, nm, plan_rules)
                       for nm, v in plans)
    return LintReport(results, time.perf_counter() - t0,
                      schema=exchck.EXCHANGE_SCHEMA)


def _imports_jax(path: str) -> bool:
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        if any(n == "jax" or n.startswith("jax.") or n == "lux_tpu"
               or n.startswith("lux_tpu.") for n in names):
            return True
    return False


def load_fixture_targets(path: str) -> List[TraceTarget]:
    """Targets from a fixture module exposing ``TRACES`` (a list of
    trace dicts with a ``name`` key) — the seeded-violation harness. A
    module that imports jax or ``lux_tpu`` (``lux_tpu``'s own fixtures)
    raises ``ImportError`` unexecuted."""
    import importlib.util

    if _imports_jax(path):
        raise ImportError(
            f"{path} imports jax or lux_tpu: the port traces torch "
            "steps (its fixtures are tests/torch_ir_fixtures/); run "
            "tools/luxlint.py for this one")
    modname = "_luxlint_ir_fixture_" + \
        os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load fixture module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    traces = getattr(mod, "TRACES", None)
    if not traces:
        raise ValueError(f"fixture {path} exposes no TRACES")
    return [
        target_from_spec(t.get("name", f"{path}#{i}"), t)
        for i, t in enumerate(traces)
    ]


def engine_target(engine, name: str, **init_kw) -> Optional[TraceTarget]:
    """The executor's ``trace_step`` as a target whose example args are
    not built yet (None without ``trace_step``)."""
    ts = getattr(engine, "trace_step", None)
    if ts is None:
        return None
    return target_from_spec(name, ts(**init_kw))


def audit_target(target: TraceTarget) -> List[Finding]:
    """LUX104 on a target that donates: its step runs once, unrecorded,
    and its outputs' storage is held against the donated args'."""
    rule = DonationAudit()
    try:
        trace = tr.bare_call(target.call,
                             tr.clone_args(target.example_args()))
        return list(rule.check(trace, target))
    except Exception as e:
        return [Finding(rule.id, target.name, 0, 0,
                        f"donation audit crashed: {e!r}")]


def audit_engine(engine, name: str, **init_kw) -> List[Finding]:
    """Build-time donation audit of one executor (serve/pool.py hook):
    LUX104 only. A target that donates nothing has nothing to audit,
    and neither its args are built nor its step run; one that does runs
    its step once (:func:`audit_target`). Engines without
    ``trace_step`` are silently fine."""
    target = engine_target(engine, name, **init_kw)
    if target is None or not target.donate:
        return []
    return audit_target(target)
