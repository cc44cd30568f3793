"""planck: static verifier for saved GroupedTailPlan artifacts, the
counterpart of ``lux_tpu/analysis/planck.py``.

A grouped-tail plan (ops/merge_tail_plan.py) is pure data — a handful
of numpy arrays a device kernel (K3, ``csrc/level_apply.cu``) will trust
blindly. A corrupted
or stale cache directory must therefore be rejected BEFORE anything
executes it, from the structural contract alone:

- LUX201 structure: ``level_ptr`` starts at 0, is monotone, covers
  exactly the row arrays; ``dst_row_ptr`` is monotone inside the root
  level's slot range; shapes/dtypes match the artifact contract.
- LUX202 conservation: every level's stream carries every real exactly
  once (per-level sum(nvalid) == n_edges) — a dropped or duplicated
  real is silent numerical corruption downstream.
- LUX203 code-plane contract: int8 codes, prefix-dense rows (lanes
  beyond nvalid are zero), side-B lanes negative / side-A non-negative
  per the row's mode, copy rows single-sided (arow == brow), level 0
  all-copy with non-negative codes.
- LUX204 alignment: every level's row count is a multiple of the 8-row
  block unit the planner pads each level to (``lux_tpu``'s Mosaic
  BlockSpecs assume it; plans are byte-identical between the packages).
- LUX205 copy-window rate: per-level stream inflation (rows per level /
  ceil(n_edges/128)) stays below ``LUX_PLANCK_INFLATION`` — the bound
  that distinguishes the copy-window schedule (~1.1x measured) from the
  pre-fix 24-27x skew blowup.

numpy + stdlib only (plans are host arrays; a verifier must not drag in
torch). All checks are vectorized: a >=1M-real plan verifies in well
under a second, mmap-friendly. An artifact saved by either package's
``save_grouped_plan`` verifies here and gives the same findings as
under ``lux_tpu``'s planck.
"""

from __future__ import annotations

import json
import os
import time
import types
from typing import Iterable, List, Optional, Sequence

import numpy as np

from lux_tpu_torch.analysis.core import FileResult, Finding, LintReport
from lux_tpu_torch.utils import flags

PLAN_SCHEMA = "luxlint.plan.v1"

BLOCK = 128       # lanes per stream row (ops/merge_tail_ref.BLOCK)
ALIGN_ROWS = 8    # level row unit (ops/merge_tail_plan)

# Mirror of the artifact format (ops/merge_tail_plan.PLAN_ARRAYS /
# PLAN_FORMAT). Duplicated on purpose: importing lux_tpu_torch.ops pulls
# torch, and ``luxlint --plans`` must verify a 1M-real artifact in under
# two seconds from a cold interpreter. tests/test_torch_planck.py asserts
# the two stay identical.
PLAN_ARRAYS = (
    "arow", "brow", "codes", "nvalid", "mode", "level_ptr", "dst_row_ptr",
)
PLAN_FORMAT = 1


def load_plan_artifact(path: str, mmap: bool = True):
    """torch-free loader for a saved grouped-plan directory. Returns an
    object attribute-compatible with GroupedTailPlan as far as the
    LUX2xx rules read it."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("format") != PLAN_FORMAT:
        raise ValueError(
            f"grouped plan {path}: unknown format {meta.get('format')}")
    arrs = {
        name: np.load(os.path.join(path, name + ".npy"),
                      mmap_mode="r" if mmap else None,
                      allow_pickle=False)
        for name in PLAN_ARRAYS
    }
    return types.SimpleNamespace(
        n_edges=int(meta["n_edges"]), n_levels=int(meta["n_levels"]),
        stats=dict(meta.get("stats", {})), **arrs,
    )


class PlanRule:
    """One artifact rule; ``line`` in findings is the level index + 1
    (0 = a plan-level finding)."""

    id = "LUX200"
    title = "base plan rule"
    doc = ""

    def check(self, plan, path: str) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, path: str, level: int, message: str) -> Finding:
        return Finding(self.id, path, level, 0, message)


def _levels(plan) -> int:
    """Number of level segments the row arrays are cut into."""
    return max(len(plan.level_ptr) - 1, 0)


class PlanStructure(PlanRule):
    id = "LUX201"
    title = "plan-structure"
    doc = ("level_ptr/dst_row_ptr monotone and in range; array shapes "
           "and dtypes match the GroupedTailPlan contract")

    def check(self, plan, path: str) -> Iterable[Finding]:
        lp = np.asarray(plan.level_ptr)
        s = int(np.asarray(plan.arow).shape[0])
        if lp.ndim != 1 or lp.shape[0] != plan.n_levels + 2:
            yield self.finding(
                path, 0,
                f"level_ptr has {lp.shape} entries, expected "
                f"n_levels+2 = {plan.n_levels + 2}",
            )
            return
        if lp[0] != 0:
            yield self.finding(path, 0, f"level_ptr[0] = {lp[0]}, not 0")
        if np.any(np.diff(lp) < 0):
            yield self.finding(path, 0, "level_ptr is not monotone")
            return
        if lp[-1] != s:
            yield self.finding(
                path, 0,
                f"level_ptr[-1] = {lp[-1]} but the row arrays hold {s} "
                "rows — the level cut does not cover the artifact",
            )
        for name in ("brow", "nvalid", "mode"):
            a = np.asarray(getattr(plan, name))
            if a.shape != (s,):
                yield self.finding(
                    path, 0,
                    f"{name} shape {a.shape} != arow shape ({s},)")
        codes = np.asarray(plan.codes)
        if codes.shape != (s, BLOCK):
            yield self.finding(
                path, 0, f"codes shape {codes.shape} != ({s}, {BLOCK})")
        if np.asarray(plan.arow).size and (
            np.asarray(plan.arow).min() < 0 or
            np.asarray(plan.brow).min() < 0
        ):
            yield self.finding(path, 0, "negative arow/brow input row")
        # Levels >= 1 read the PREVIOUS level's output stream: their
        # input rows must address inside it.
        for k in range(1, _levels(plan)):
            lo, hi = int(lp[k]), int(lp[k + 1])
            prev_rows = int(lp[k]) - int(lp[k - 1])
            if hi > lo and prev_rows > 0:
                amax = int(np.asarray(plan.arow)[lo:hi].max(initial=0))
                bmax = int(np.asarray(plan.brow)[lo:hi].max(initial=0))
                if max(amax, bmax) >= prev_rows:
                    yield self.finding(
                        path, k + 1,
                        f"level {k} reads input row "
                        f"{max(amax, bmax)} but level {k - 1} has only "
                        f"{prev_rows} rows",
                    )
        drp = np.asarray(plan.dst_row_ptr)
        if drp.size:
            if np.any(np.diff(drp) < 0):
                yield self.finding(path, 0, "dst_row_ptr is not monotone")
            nlev = _levels(plan)
            root_rows = int(lp[nlev] - lp[nlev - 1]) if nlev >= 1 else 0
            if drp.max(initial=0) > root_rows * BLOCK:
                yield self.finding(
                    path, 0,
                    f"dst_row_ptr reaches slot {int(drp.max())} beyond "
                    f"the root level's {root_rows * BLOCK} slots",
                )


class PlanConservation(PlanRule):
    id = "LUX202"
    title = "plan-conservation"
    doc = ("every real is routed exactly once per level: "
           "sum(nvalid) == n_edges in every level segment")

    def check(self, plan, path: str) -> Iterable[Finding]:
        lp = np.asarray(plan.level_ptr)
        nvalid = np.asarray(plan.nvalid, np.int64)
        if lp.ndim != 1 or lp.shape[0] < 2 or np.any(np.diff(lp) < 0) or \
                (lp.size and lp[-1] > nvalid.shape[0]):
            return   # structure is broken; LUX201 already reports it
        for k in range(_levels(plan)):
            got = int(nvalid[int(lp[k]):int(lp[k + 1])].sum())
            if got != plan.n_edges:
                yield self.finding(
                    path, k + 1,
                    f"level {k} routes {got} reals, plan claims "
                    f"{plan.n_edges} — a real was dropped or duplicated",
                )


class PlanCodePlane(PlanRule):
    id = "LUX203"
    title = "plan-code-plane"
    doc = ("int8 prefix-dense code planes; lane signs match the row "
           "mode (A >= 0, B < 0); copy rows single-sided; level 0 "
           "all-copy")

    def check(self, plan, path: str) -> Iterable[Finding]:
        codes = np.asarray(plan.codes)
        nvalid = np.asarray(plan.nvalid, np.int64)
        mode = np.asarray(plan.mode)
        arow = np.asarray(plan.arow)
        brow = np.asarray(plan.brow)
        if codes.dtype != np.int8:
            yield self.finding(
                path, 0,
                f"codes dtype {codes.dtype}, contract is int8 at rest")
        if codes.ndim != 2 or codes.shape[0] != nvalid.shape[0]:
            return   # LUX201 territory
        if nvalid.size and (nvalid.min() < 0 or nvalid.max() > BLOCK):
            yield self.finding(
                path, 0,
                f"nvalid out of [0, {BLOCK}] "
                f"(min {int(nvalid.min())}, max {int(nvalid.max())})")
            return
        if mode.size and not np.isin(mode, (0, 1, 2)).all():
            yield self.finding(
                path, 0, "mode contains values outside {0, 1, 2}")
            return
        lanes = np.arange(codes.shape[1])
        beyond = codes * (lanes[None, :] >= nvalid[:, None])
        if np.any(beyond != 0):
            rows = int(np.count_nonzero(beyond.any(axis=1)))
            yield self.finding(
                path, 0,
                f"{rows} rows carry nonzero codes beyond nvalid — rows "
                "must be prefix-dense (pads read as lane 0 on device)",
            )
        live = lanes[None, :] < nvalid[:, None]
        neg = (codes < 0) & live
        pos = (codes >= 0) & live
        bad_a = (mode == 1) & neg.any(axis=1)
        bad_b = (mode == 2) & pos.any(axis=1)
        if np.any(bad_a):
            yield self.finding(
                path, 0,
                f"{int(bad_a.sum())} copy-A rows carry negative (side-B) "
                "lane codes")
        if np.any(bad_b):
            yield self.finding(
                path, 0,
                f"{int(bad_b.sum())} copy-B rows carry non-negative "
                "(side-A) lane codes")
        mixed = (mode == 0) & (nvalid > 0)
        halfmerge = mixed & ~(neg.any(axis=1) & pos.any(axis=1))
        if np.any(halfmerge):
            yield self.finding(
                path, 0,
                f"{int(halfmerge.sum())} merge rows draw from only one "
                "side — they should be copy rows (mode 1/2)")
        single = (mode > 0) & (arow != brow)
        if np.any(single):
            yield self.finding(
                path, 0,
                f"{int(single.sum())} copy rows have arow != brow — copy "
                "windows stream exactly one input row")
        lp = np.asarray(plan.level_ptr)
        if lp.ndim == 1 and lp.shape[0] >= 2 and lp[0] == 0 and \
                not np.any(np.diff(lp) < 0) and lp[-1] <= mode.shape[0]:
            r0 = int(lp[1])
            lv0_mode = mode[:r0]
            lv0_live = nvalid[:r0] > 0
            if np.any(lv0_mode[lv0_live] != 1):
                yield self.finding(
                    path, 1,
                    "level 0 contains non-copy rows — the x2d gather "
                    "level is all copy-A by construction")
            if np.any((codes[:r0] < 0) & live[:r0]):
                yield self.finding(
                    path, 1,
                    "level 0 carries negative lane codes — source lanes "
                    "are 0..127")


class PlanAlignment(PlanRule):
    id = "LUX204"
    title = "plan-alignment"
    doc = (f"every level's row count is a multiple of {ALIGN_ROWS} "
           "(the block unit the planner pads every level to)")

    def check(self, plan, path: str) -> Iterable[Finding]:
        lp = np.asarray(plan.level_ptr)
        if lp.ndim != 1 or lp.shape[0] < 2 or np.any(np.diff(lp) < 0):
            return
        rows = np.diff(lp)
        for k in range(rows.shape[0]):
            if rows[k] % ALIGN_ROWS:
                yield self.finding(
                    path, k + 1,
                    f"level {k} has {int(rows[k])} rows — not a multiple "
                    f"of {ALIGN_ROWS}, so the kernel's 8-row blocks read "
                    "across the level boundary",
                )


class PlanCopyRate(PlanRule):
    id = "LUX205"
    title = "plan-copy-rate"
    doc = ("per-level stream inflation (rows / ceil(n_edges/128)) below "
           "LUX_PLANCK_INFLATION — the copy-window rate bound")

    def check(self, plan, path: str) -> Iterable[Finding]:
        lp = np.asarray(plan.level_ptr)
        if lp.ndim != 1 or lp.shape[0] < 2 or np.any(np.diff(lp) < 0):
            return
        bound = flags.get_float("LUX_PLANCK_INFLATION")
        ideal = max(-(-int(plan.n_edges) // BLOCK), 1)
        rows = np.diff(lp)
        for k in range(rows.shape[0]):
            inflation = rows[k] / ideal
            if inflation > bound:
                yield self.finding(
                    path, k + 1,
                    f"level {k} streams {int(rows[k])} rows = "
                    f"{inflation:.2f}x the ideal {ideal} — above the "
                    f"{bound:g}x copy-window rate bound "
                    "(LUX_PLANCK_INFLATION); this plan predates the "
                    "copy-window schedule or was built from skewed "
                    "inputs without it",
                )


def all_plan_rules() -> List[PlanRule]:
    return [
        PlanStructure(),
        PlanConservation(),
        PlanCodePlane(),
        PlanAlignment(),
        PlanCopyRate(),
    ]


def verify_plan(plan, path: str = "<plan>",
                rules: Optional[Sequence[PlanRule]] = None) -> FileResult:
    """Run the LUX2xx rules over one in-memory GroupedTailPlan."""
    if rules is None:
        rules = all_plan_rules()
    findings: List[Finding] = []
    errors: List[str] = []
    for rule in rules:
        try:
            findings.extend(rule.check(plan, path))
        except Exception as e:   # corrupted arrays can break numpy ops
            errors.append(f"{path}: {rule.id} crashed: {e!r}")
    findings.sort(key=lambda f: (f.line, f.rule))
    return FileResult(path, findings, [], error="; ".join(errors) or None)


def verify_plan_dirs(paths: Sequence[str],
                     rules: Optional[Sequence[PlanRule]] = None
                     ) -> LintReport:
    """Load (mmap) and verify saved plan directories."""
    t0 = time.perf_counter()
    results: List[FileResult] = []
    for path in paths:
        try:
            plan = load_plan_artifact(path, mmap=True)
        except Exception as e:
            results.append(FileResult(
                path, [], [], error=f"{path}: unloadable plan: {e!r}"))
            continue
        results.append(verify_plan(plan, path, rules))
    return LintReport(results, time.perf_counter() - t0, schema=PLAN_SCHEMA)
