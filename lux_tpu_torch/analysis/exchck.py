"""exchck: static verifier for ExchangePlan tables (the plan half of the
exchange tier), the counterpart of ``lux_tpu/analysis/exchck.py``.

The compact exchange path (LUX_EXCHANGE=compact) replaces the full
per-part all-gather with a packed exchange driven by pure data — the
``ExchangePlan`` tables in graph/partition.py — that the unchanged
compute bodies then trust blindly. A wrong table silently
corrupts results (a dropped row reads the zero-filled receive buffer;
a misrouted row reads a neighbor's value), so the tables are verified
statically, as a full proof rather than the bitwise-parity smoke's
sampling:

- LUX401 structure: scalar bounds (capacity/max_units/unit_rows >= 1),
  static table shapes ``(P, P*capacity)``, integer dtypes, capacity
  holds the densest (sender, receiver) pair, diagonal pairs all
  sentinel, and prefix density — the first ``counts[q, p]`` slots of a
  pair are real, every later slot is the sentinel on BOTH sides, so pad
  traffic and real traffic can never share a slot.
- LUX402 coverage/conservation: per off-diagonal pair the real send
  rows are strictly ascending (hence each sent exactly once) and
  ``recv_pos`` scatters row r of sender p to flat index
  ``p * max_units + r`` — exactly where the unchanged compute bodies
  index — with all real receive positions distinct per receiver. With
  ``remote_read_counts`` attached, ``counts * unit_rows`` must equal
  that matrix elementwise: every remote row the receiver's real edges
  read crosses the wire exactly once. Together these are a permutation
  proof, not a sample.
- LUX403 profitability-honesty: the packed bytes the plan prices
  (``exchanged_units_per_iter * unit_rows * row_bytes``) must equal the
  executor's declared ``exchange_bytes_per_iter``, the ``profitable``
  claim must match ``capacity < max_units``, and the exchange ledger's
  ``useful_bytes_per_iter`` model (obs/engobs.useful_exchange) must
  re-derive from the counts matrix — so the advertised packed-vs-useful
  ratio can never drift from the code that computes it.
- LUX407 frontier-coverage (plans carrying frontier evidence only —
  the LUX_EXCHANGE=frontier activity-packed send): the frontier
  capacity must fit inside the static compact capacity (the frontier
  send reuses the compact plan's routing, only shorter), the
  executor's per-pair send slots must fit that capacity, the packer
  must never truncate active rows (``frontier_fill_active == 0`` — a
  dense frontier downgrades to the compact send instead of dropping
  rows), and the advertised frontier bytes must re-derive from
  ``P * (P-1) * slots * frontier_row_bytes``.

numpy + stdlib only, mirroring planck.py: plans are host arrays and a
verifier must not drag in torch. Findings (rule, path, message) equal
``lux_tpu``'s on the same plan, and each package's artifact loads in the
other. The trace half of the tier (LUX404-406, dataflow rules over the
traced step) is ``analysis/ir.py``'s, over ``analysis/trace.py``'s
torch traces.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
import types
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from lux_tpu_torch.analysis.core import FileResult, Finding, LintReport

EXCHANGE_SCHEMA = "luxlint-exchange.v1"

# Mirror of the artifact format (graph/partition.EXCHANGE_PLAN_ARRAYS /
# EXCHANGE_PLAN_FORMAT). Duplicated on purpose, like planck's mirror of
# the grouped-plan format: this module must verify saved artifacts from
# a cold torch-free interpreter. tests/test_torch_exchck.py asserts the
# two stay identical.
EXCH_ARRAYS = ("counts", "send_units", "recv_pos")
EXCH_FORMAT = 1


def plan_view(plan, remote_read_counts=None, row_bytes: Optional[int] = None,
              declared_bytes_per_iter: Optional[int] = None,
              ledger: Optional[dict] = None,
              frontier_capacity: Optional[int] = None,
              frontier_max_sends: Optional[int] = None,
              frontier_row_bytes: Optional[int] = None,
              frontier_bytes_per_iter: Optional[int] = None,
              frontier_fill_active: Optional[int] = None
              ) -> types.SimpleNamespace:
    """Wrap an in-memory ExchangePlan (or anything attribute-compatible)
    plus optional evidence into the namespace the LUX40x rules read.

    ``remote_read_counts`` is the ShardedGraph value-row matrix (LUX402
    conservation); ``row_bytes``/``declared_bytes_per_iter``/``ledger``
    feed the LUX403 pricing checks; the ``frontier_*`` fields are the
    adaptive GAS engine's frontier-exchange evidence (LUX407). Evidence
    left as None skips only the checks that need it."""
    def _i(x):
        return None if x is None else int(x)

    return types.SimpleNamespace(
        num_parts=int(plan.num_parts),
        max_units=int(plan.max_units),
        unit_rows=int(plan.unit_rows),
        capacity=int(plan.capacity),
        counts=np.asarray(plan.counts),
        send_units=np.asarray(plan.send_units),
        recv_pos=np.asarray(plan.recv_pos),
        profitable=bool(getattr(plan, "profitable",
                                int(plan.capacity) < int(plan.max_units))),
        remote_read_counts=(None if remote_read_counts is None
                            else np.asarray(remote_read_counts)),
        row_bytes=_i(row_bytes),
        declared_bytes_per_iter=_i(declared_bytes_per_iter),
        ledger=dict(ledger) if ledger is not None else None,
        frontier_capacity=_i(frontier_capacity),
        frontier_max_sends=_i(frontier_max_sends),
        frontier_row_bytes=_i(frontier_row_bytes),
        frontier_bytes_per_iter=_i(frontier_bytes_per_iter),
        frontier_fill_active=_i(frontier_fill_active),
    )


def load_exchange_artifact(path: str, mmap: bool = True
                           ) -> types.SimpleNamespace:
    """torch-free loader for a saved exchange-plan directory
    (graph/partition.save_exchange_artifact, of either package)."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("format") != EXCH_FORMAT:
        raise ValueError(
            f"exchange plan {path}: unknown format {meta.get('format')}")
    arrs = {
        name: np.load(os.path.join(path, name + ".npy"),
                      mmap_mode="r" if mmap else None,
                      allow_pickle=False)
        for name in EXCH_ARRAYS
    }
    rrc_path = os.path.join(path, "remote_read_counts.npy")
    rrc = (np.load(rrc_path, mmap_mode="r" if mmap else None,
                   allow_pickle=False)
           if os.path.exists(rrc_path) else None)
    view = plan_view(
        types.SimpleNamespace(
            num_parts=meta["num_parts"], max_units=meta["max_units"],
            unit_rows=meta["unit_rows"], capacity=meta["capacity"],
            profitable=meta.get(
                "profitable",
                int(meta["capacity"]) < int(meta["max_units"])),
            **arrs,
        ),
        remote_read_counts=rrc,
        row_bytes=meta.get("row_bytes"),
        declared_bytes_per_iter=meta.get("exchange_bytes_per_iter"),
        ledger=meta.get("ledger"),
    )
    return view


class ExchRule:
    """One exchange-plan rule; ``line`` in findings is the receiver part
    index + 1 (0 = a plan-level finding)."""

    id = "LUX400"
    title = "base exchange rule"
    doc = ""

    def check(self, view, path: str) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, path: str, receiver: int, message: str) -> Finding:
        return Finding(self.id, path, receiver, 0, message)


def _tables(view) -> Tuple[np.ndarray, np.ndarray]:
    """send/recv reshaped to (P, P, capacity); raises on shape drift
    (reported by LUX401, defended against by the others)."""
    P, cap = view.num_parts, view.capacity
    return (np.asarray(view.send_units).reshape(P, P, cap),
            np.asarray(view.recv_pos).reshape(P, P, cap))


def _shape_ok(view) -> bool:
    P, cap = view.num_parts, view.capacity
    return (P >= 1 and cap >= 1 and view.max_units >= 1
            and view.unit_rows >= 1
            and np.asarray(view.counts).shape == (P, P)
            and np.asarray(view.send_units).shape == (P, P * cap)
            and np.asarray(view.recv_pos).shape == (P, P * cap))


class ExchStructure(ExchRule):
    id = "LUX401"
    title = "exchange-structure"
    doc = ("static (P, P*capacity) tables, capacity holds the densest "
           "pair, diagonal all sentinel, prefix-dense real slots "
           "disjoint from sentinel pads")

    def check(self, view, path: str) -> Iterable[Finding]:
        P = view.num_parts
        for name in ("num_parts", "max_units", "unit_rows", "capacity"):
            if int(getattr(view, name)) < 1:
                yield self.finding(
                    path, 0, f"{name} = {getattr(view, name)}, must be >= 1")
                return
        counts = np.asarray(view.counts)
        if counts.shape != (P, P):
            yield self.finding(
                path, 0, f"counts shape {counts.shape} != ({P}, {P})")
            return
        if counts.dtype.kind not in "iu":
            yield self.finding(
                path, 0, f"counts dtype {counts.dtype} is not integral")
            return
        if counts.size and counts.min() < 0:
            yield self.finding(path, 0, "counts contains negative entries")
            return
        cap = view.capacity
        for name in ("send_units", "recv_pos"):
            a = np.asarray(getattr(view, name))
            if a.shape != (P, P * cap):
                yield self.finding(
                    path, 0,
                    f"{name} shape {a.shape} != ({P}, {P * cap}) — the "
                    "static all_to_all layout (zero-recompile contract)")
                return
            if a.dtype.kind not in "iu":
                yield self.finding(
                    path, 0, f"{name} dtype {a.dtype} is not integral")
                return
        send, recv = _tables(view)
        mu = view.max_units
        if send.min() < 0 or send.max() > mu:
            yield self.finding(
                path, 0,
                f"send_units out of [0, {mu}] (sentinel {mu}): "
                f"min {int(send.min())}, max {int(send.max())}")
        if recv.min() < 0 or recv.max() > P * mu:
            yield self.finding(
                path, 0,
                f"recv_pos out of [0, {P * mu}] (trash row {P * mu}): "
                f"min {int(recv.min())}, max {int(recv.max())}")
        diag = np.arange(P)
        if np.any(send[diag, diag] != mu) or \
                np.any(recv[diag, diag] != P * mu):
            yield self.finding(
                path, 0,
                "diagonal (p == p) table slots carry real entries — own "
                "rows never cross the wire")
        off = counts - np.diag(np.diag(counts))
        required = int(off.max()) if P > 1 else 0
        if cap < required:
            yield self.finding(
                path, 0,
                f"capacity {cap} cannot hold the {required} needed units "
                "of the densest (sender, receiver) pair — the exchange "
                "is truncated")
            return
        # Prefix density: for each (sender p -> receiver q) pair the
        # first counts[q, p] slots are real and EVERY later slot is the
        # sentinel on both sides. n indexed as counts.T because tables
        # are laid out sender-major: send[p, q] pairs with counts[q, p].
        lanes = np.arange(cap)
        n = counts.T[:, :, None]                   # (sender, receiver, 1)
        realzone = lanes[None, None, :] < n
        offmask = ~np.eye(P, dtype=bool)[:, :, None]
        aligned = recv_t(recv)                     # [p, q, i] sender-major
        pad_leak = ((send != mu) | (aligned != P * mu)) \
            & ~realzone & offmask
        if np.any(pad_leak):
            bad = np.argwhere(pad_leak.any(axis=2))
            p, q = (int(x) for x in bad[0])
            yield self.finding(
                path, q + 1,
                f"{int(pad_leak.any(axis=2).sum())} pairs carry real "
                f"entries in the sentinel zone (first: sender {p} -> "
                f"receiver {q} beyond counts[{q}, {p}] = "
                f"{int(counts[q, p])}) — pad and real slots must be "
                "disjoint")
        real_hole = ((send == mu) | (aligned == P * mu)) \
            & realzone & offmask
        if np.any(real_hole):
            bad = np.argwhere(real_hole.any(axis=2))
            p, q = (int(x) for x in bad[0])
            yield self.finding(
                path, q + 1,
                f"{int(real_hole.any(axis=2).sum())} pairs carry "
                f"sentinels inside the real prefix (first: sender {p} "
                f"-> receiver {q}, counts[{q}, {p}] = "
                f"{int(counts[q, p])}) — the pair's rows are not "
                "prefix-dense")


def recv_t(recv: np.ndarray) -> np.ndarray:
    """Receiver tables aligned to sender-major layout: element
    [p, q, i] is where RECEIVER q scatters slot i from SENDER p
    (recv_pos is receiver-major: recv[q, p, i])."""
    return recv.transpose(1, 0, 2)


class ExchCoverage(ExchRule):
    id = "LUX402"
    title = "exchange-coverage"
    doc = ("permutation proof: real send rows strictly ascending, "
           "recv_pos == sender * max_units + row, receive positions "
           "distinct per receiver; counts * unit_rows == "
           "remote_read_counts when attached")

    def check(self, view, path: str) -> Iterable[Finding]:
        if not _shape_ok(view):
            return   # LUX401 territory
        P, cap, mu = view.num_parts, view.capacity, view.max_units
        counts = np.asarray(view.counts, np.int64)
        off = counts - np.diag(np.diag(counts))
        if cap < (int(off.max()) if P > 1 else 0):
            return   # truncated tables; LUX401 already reports it
        send, recv = _tables(view)
        aligned = recv_t(recv)                    # [p, q, i] sender-major
        lanes = np.arange(cap)
        realzone = (lanes[None, None, :] < counts.T[:, :, None]) \
            & ~np.eye(P, dtype=bool)[:, :, None]
        # (a) strictly ascending real send rows per pair: each needed
        # row appears at most once in the pair's stream.
        nondec = (np.diff(send, axis=2) <= 0) & realzone[:, :, 1:]
        if np.any(nondec):
            p, q = (int(x) for x in np.argwhere(nondec.any(axis=2))[0])
            yield self.finding(
                path, q + 1,
                f"send_units[{p} -> {q}] is not strictly ascending in "
                "its real prefix — a row is duplicated or unsorted, so "
                "it is not sent exactly once")
        # (b) scatter alignment: received slot i of sender p lands at
        # flat index p * max_units + send_row — the exact position the
        # unchanged compute bodies read for that remote row.
        want = (np.arange(P, dtype=np.int64)[:, None, None] * mu
                + send.astype(np.int64))
        misrouted = (aligned.astype(np.int64) != want) & realzone
        if np.any(misrouted):
            p, q = (int(x) for x in np.argwhere(misrouted.any(axis=2))[0])
            i = int(np.flatnonzero(misrouted[p, q])[0])
            yield self.finding(
                path, q + 1,
                f"recv_pos[{q}, sender {p}, slot {i}] scatters row "
                f"{int(send[p, q, i])} to flat index "
                f"{int(aligned[p, q, i])}, compute reads it at "
                f"{int(want[p, q, i])} — the row is misrouted")
        # (c) per-receiver distinctness: no two real slots of receiver q
        # scatter to the same flat position (a collision would let one
        # sender's row overwrite another's).
        for q in range(P):
            pos = aligned[:, q][realzone[:, q]]
            if pos.size != np.unique(pos).size:
                yield self.finding(
                    path, q + 1,
                    f"receiver {q} has colliding recv_pos slots — two "
                    "exchanged rows scatter to the same flat index")
        # (d) conservation against the remote-read index: every remote
        # value row the receiver's real edges read is exchanged exactly
        # once, nothing more.
        rrc = view.remote_read_counts
        if rrc is not None:
            rrc = np.asarray(rrc, np.int64)
            got = counts * view.unit_rows
            if rrc.shape != got.shape:
                yield self.finding(
                    path, 0,
                    f"remote_read_counts shape {rrc.shape} != counts "
                    f"shape {got.shape}")
            elif np.any(got != rrc):
                q, p = (int(x) for x in np.argwhere(got != rrc)[0])
                yield self.finding(
                    path, q + 1,
                    f"plan exchanges {int(got[q, p])} value rows for "
                    f"(receiver {q}, sender {p}) but the remote-read "
                    f"index requires {int(rrc[q, p])} — a needed row is "
                    "dropped or sent twice")


class ExchProfitability(ExchRule):
    id = "LUX403"
    title = "exchange-profitability"
    doc = ("declared exchange_bytes_per_iter == capacity pricing; "
           "profitable iff capacity < max_units; ledger useful-bytes "
           "model re-derives from the counts matrix")

    def check(self, view, path: str) -> Iterable[Finding]:
        if not _shape_ok(view):
            return   # LUX401 territory
        P = view.num_parts
        units = P * (P - 1) * view.capacity
        packed_rows = units * view.unit_rows
        profitable = view.capacity < view.max_units
        if bool(view.profitable) != profitable:
            yield self.finding(
                path, 0,
                f"plan claims profitable={view.profitable} but capacity "
                f"{view.capacity} vs max_units {view.max_units} says "
                f"{profitable} — the fallback decision is lying")
        declared = view.declared_bytes_per_iter
        rb = view.row_bytes
        if declared is not None and rb is None:
            # No independent row price: the declared figure must still
            # be an exact multiple of the packed row count.
            if packed_rows and declared % packed_rows:
                yield self.finding(
                    path, 0,
                    f"declared exchange_bytes_per_iter {declared} is not "
                    f"a multiple of the {packed_rows} packed value rows "
                    "the plan moves per iteration")
        if rb is not None:
            packed_bytes = packed_rows * rb
            if declared is not None and declared != packed_bytes:
                yield self.finding(
                    path, 0,
                    f"declared exchange_bytes_per_iter {declared} != "
                    f"plan pricing {packed_bytes} ({units} units x "
                    f"{view.unit_rows} rows x {rb} B) — the advertised "
                    "byte figure drifted from the tables")
            full_bytes = P * (P - 1) * view.max_units * view.unit_rows * rb
            if profitable and packed_bytes >= full_bytes:
                yield self.finding(
                    path, 0,
                    f"profitable plan prices {packed_bytes} B >= the "
                    f"full all-gather's {full_bytes} B")
        counts = np.asarray(view.counts, np.int64)
        useful_rows = int(counts.sum() - np.trace(counts)) * view.unit_rows
        if useful_rows > packed_rows:
            yield self.finding(
                path, 0,
                f"the counts matrix requires {useful_rows} useful value "
                f"rows per iteration but the plan only moves "
                f"{packed_rows} — capacity cannot cover the advertised "
                "useful traffic")
        led = view.ledger
        if led is not None:
            checks = [("useful_rows", useful_rows),
                      ("exchanged_rows", packed_rows)]
            if rb is not None:
                checks.append(("useful_bytes_per_iter", useful_rows * rb))
            for key, want in checks:
                got = led.get(key)
                if got is not None and int(got) != want:
                    yield self.finding(
                        path, 0,
                        f"ledger {key} = {int(got)} but the counts "
                        f"matrix re-derives {want} — the "
                        "useful_bytes_per_iter model drifted from the "
                        "plan")
            ratio = led.get("ratio")
            if ratio is not None and packed_rows:
                want_ratio = useful_rows / packed_rows
                if abs(float(ratio) - want_ratio) > 1e-9:
                    yield self.finding(
                        path, 0,
                        f"ledger ratio {float(ratio):.6f} != re-derived "
                        f"useful/exchanged {want_ratio:.6f}")


class FrontierCoverage(ExchRule):
    id = "LUX407"
    title = "frontier-coverage"
    doc = ("frontier-exchange evidence must be admissible: frontier "
           "capacity within [1, capacity], per-pair send slots within "
           "that capacity, zero truncated active rows (dense frontiers "
           "downgrade, never drop), and the advertised frontier bytes "
           "re-derived from P * (P-1) * slots * frontier_row_bytes")

    def check(self, view, path: str) -> Iterable[Finding]:
        fcap = getattr(view, "frontier_capacity", None)
        if fcap is None:
            return   # no frontier evidence attached; nothing to verify
        if not _shape_ok(view):
            return   # LUX401 territory
        P = view.num_parts
        if not 1 <= fcap <= view.capacity:
            yield self.finding(
                path, 0,
                f"frontier_capacity {fcap} outside [1, {view.capacity}] "
                "— the frontier send must reuse (a prefix of) the "
                "compact plan's per-pair slots, never exceed them")
            return
        sends = getattr(view, "frontier_max_sends", None)
        if sends is not None and not 0 <= sends <= fcap:
            yield self.finding(
                path, 0,
                f"frontier_max_sends {sends} exceeds frontier_capacity "
                f"{fcap} — the packer can emit more rows than the "
                "admissibility check budgets, so active rows truncate")
        fill = getattr(view, "frontier_fill_active", None)
        if fill:
            yield self.finding(
                path, 0,
                f"frontier_fill_active = {int(fill)}: the packer "
                "truncated active rows instead of downgrading to the "
                "static compact send — results can silently drop "
                "frontier vertices")
        frb = getattr(view, "frontier_row_bytes", None)
        fbytes = getattr(view, "frontier_bytes_per_iter", None)
        if frb is not None and frb < 1:
            yield self.finding(
                path, 0, f"frontier_row_bytes {frb} must be >= 1")
        elif fbytes is not None and frb is not None:
            slots = fcap if sends is None else sends
            want = P * (P - 1) * slots * frb
            if int(fbytes) != want:
                yield self.finding(
                    path, 0,
                    f"frontier_bytes_per_iter {fbytes} != re-derived "
                    f"{want} (P*(P-1) pairs x {slots} slots x {frb} B) "
                    "— the frontier byte model drifted from the packer")


def all_exchange_rules() -> List[ExchRule]:
    return [ExchStructure(), ExchCoverage(), ExchProfitability(),
            FrontierCoverage()]


def verify_exchange_plan(view, path: str = "<exchange-plan>",
                         rules: Optional[Sequence[ExchRule]] = None
                         ) -> FileResult:
    """Run the LUX40x plan rules over one plan view."""
    if rules is None:
        rules = all_exchange_rules()
    findings: List[Finding] = []
    errors: List[str] = []
    for rule in rules:
        try:
            findings.extend(rule.check(view, path))
        except Exception as e:   # corrupted arrays can break numpy ops
            errors.append(f"{path}: {rule.id} crashed: {e!r}")
    findings.sort(key=lambda f: (f.line, f.rule))
    return FileResult(path, findings, [], error="; ".join(errors) or None)


def verify_exchange_dirs(paths: Sequence[str],
                         rules: Optional[Sequence[ExchRule]] = None
                         ) -> LintReport:
    """Load (mmap) and verify saved exchange-plan directories."""
    t0 = time.perf_counter()
    results: List[FileResult] = []
    for path in paths:
        try:
            view = load_exchange_artifact(path, mmap=True)
        except Exception as e:
            results.append(FileResult(
                path, [], [], error=f"{path}: unloadable plan: {e!r}"))
            continue
        results.append(verify_exchange_plan(view, path, rules))
    return LintReport(results, time.perf_counter() - t0,
                      schema=EXCHANGE_SCHEMA)


def load_fixture_plans(path: str) -> List[Tuple[str, types.SimpleNamespace]]:
    """Load a fixture module exposing ``PLANS`` — a list of dicts with
    a ``name`` plus the plan_view keyword fields (tests/exch_fixtures
    idiom). Returns [] when the module has no PLANS (it may carry only
    TRACES for the IR half of the tier). The module is executed: callers
    that must not run a TRACES-only module (it imports jax) check
    :func:`fixture_exports` first."""
    spec = importlib.util.spec_from_file_location(
        "exch_fixture_" + os.path.basename(path).removesuffix(".py"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out: List[Tuple[str, types.SimpleNamespace]] = []
    for entry in getattr(mod, "PLANS", []):
        entry = dict(entry)
        name = entry.pop("name")
        plan = entry.pop("plan")
        out.append((f"{path}::{name}", plan_view(plan, **entry)))
    return out


def fixture_exports(path: str) -> Tuple[bool, bool]:
    """(defines PLANS, defines TRACES) of a fixture module, read from its
    source without executing it."""
    import ast

    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    names = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        names.update(t.id for t in targets if isinstance(t, ast.Name))
    return "PLANS" in names, "TRACES" in names


def audit_exchange(engine, name: str) -> List[Finding]:
    """Build-time audit for a plan-carrying executor (EnginePool hook,
    LUX_EXCH_POOL_AUDIT). Duck-typed and advisory: engines without a
    compact plan audit to zero findings."""
    plan = getattr(engine, "_xplan", None)
    if plan is None:
        return []
    try:
        counts = None
        sg = getattr(engine, "sg", None)
        if sg is not None and hasattr(sg, "remote_read_counts"):
            counts = sg.remote_read_counts()
        if counts is None:
            counts = getattr(engine, "_remote_read_counts", None)
        declared = None
        bytes_fn = getattr(engine, "exchange_bytes_per_iter", None)
        if callable(bytes_fn):
            try:
                declared = int(bytes_fn())
            except Exception:
                declared = None
        fe = getattr(engine, "frontier_evidence", None)
        frontier = (fe() or {}) if callable(fe) else {}
        view = plan_view(plan, remote_read_counts=counts,
                         declared_bytes_per_iter=declared, **frontier)
        res = verify_exchange_plan(view, path=name)
    # luxlint: disable=LUX007 -- advisory audit: a malformed plan must surface as a finding, never take down an engine build
    except Exception as e:
        return [Finding("LUX401", name, 0, 0, f"audit crashed: {e!r}")]
    findings = list(res.findings)
    if res.error:
        findings.append(Finding("LUX401", name, 0, 0,
                                f"audit crashed: {res.error}"))
    return findings
