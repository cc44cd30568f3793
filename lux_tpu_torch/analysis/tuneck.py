"""tuneck: static verifier for persisted ``tuneconf.v1`` artifacts, the
counterpart of ``lux_tpu/analysis/tuneck.py`` (the same rules, messages
and report schema, so both packages' checkers agree on any artifact).

A tune artifact is the configuration a serving process will trust
blindly at warmup — a corrupted, hand-edited, or stale one must be
rejected offline, from the artifact alone, before anything builds
engines under it. Like planck for grouped-tail plans:

- LUX501 structure: schema/id/key/key_string/score/score_table/tuner
  shapes match the tuneconf.v1 contract.
- LUX502 knob domains: every configured flag is declared in the
  registry AND tuner-managed (space.TUNER_MANAGED), and its value
  parses inside the flag's legal domain — an artifact must not be able
  to smuggle an arbitrary env var into a serving process.
- LUX503 selection consistency: the winner is the argmin of the final
  rung's score table (score, then candidate index — the search's own
  tie-break), scores are finite and non-negative, the default
  candidate (index 0) was probed, and ``probe_ledger_ids`` matches the
  score table's recorded probe record ids exactly.
- LUX504 staleness: ``created_at`` is sane and within
  ``LUX_TUNE_MAX_AGE_S``; the key's graph fingerprint, mesh shape, and
  graph_meta are well-formed — a config tuned for some *other* graph
  must not pass as evidence for this one.

stdlib + the flag registry only (no torch, no numpy): ``luxlint --tune``
must verify a directory of artifacts from a cold interpreter in
milliseconds. ``line`` in findings is the 1-based score-table row
(0 = an artifact-level finding).
"""

from __future__ import annotations

import math
import os
import re
import time
from typing import Iterable, List, Optional, Sequence

from lux_tpu_torch.analysis.core import FileResult, Finding, LintReport
from lux_tpu_torch.tune import artifact as tart
from lux_tpu_torch.tune.space import TUNER_MANAGED
from lux_tpu_torch.utils import flags

TUNE_SCHEMA = "luxlint-tune.v1"

_ID_RE = re.compile(r"^tune-[0-9a-f]{12}$")
_MESH_RE = re.compile(r"^\d+(x\d+)*$")
_BOOLISH = frozenset({"", "0", "1", "true", "false", "yes", "no",
                      "on", "off"})

__all__ = ["TUNE_SCHEMA", "TuneRule", "all_tune_rules", "verify_artifact",
           "verify_artifact_paths"]


class TuneRule:
    id = "LUX500"
    title = "base tune rule"
    doc = ""

    def check(self, art: dict, path: str) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, path: str, row: int, message: str) -> Finding:
        return Finding(self.id, path, row, 0, message)


class TuneStructure(TuneRule):
    id = "LUX501"
    title = "tune-structure"
    doc = ("schema, content-derived id, complete key + consistent "
           "key_string, and score-table row shapes match the "
           "tuneconf.v1 contract")

    def check(self, art: dict, path: str) -> Iterable[Finding]:
        if art.get("schema") != tart.SCHEMA:
            yield self.finding(
                path, 0,
                f"schema {art.get('schema')!r}, expected {tart.SCHEMA!r}")
        if not _ID_RE.match(str(art.get("id", ""))):
            yield self.finding(
                path, 0, f"id {art.get('id')!r} is not tune-<12 hex>")
        key = art.get("key")
        if not isinstance(key, dict) \
                or sorted(key) != sorted(tart.KEY_FIELDS):
            yield self.finding(
                path, 0,
                f"key fields {sorted(key) if isinstance(key, dict) else key!r}"
                f" != {sorted(tart.KEY_FIELDS)}")
            return
        if art.get("key_string") != tart.key_string(key):
            yield self.finding(
                path, 0,
                f"key_string {art.get('key_string')!r} does not match key "
                f"{tart.key_string(key)!r}")
        if not isinstance(art.get("config"), dict):
            yield self.finding(path, 0, "config is not an object")
        if not isinstance(art.get("score"), (int, float)):
            yield self.finding(path, 0, "score is not a number")
        tuner = art.get("tuner")
        if not isinstance(tuner, dict) or not {"seed", "rungs",
                                               "eta"} <= set(tuner):
            yield self.finding(
                path, 0, "tuner block missing seed/rungs/eta provenance")
        table = art.get("score_table")
        if not isinstance(table, list) or not table:
            yield self.finding(path, 0, "score_table missing or empty")
            return
        for i, row in enumerate(table):
            missing = {"config", "score", "iters", "rung",
                       "candidate_index"} - set(row)
            if missing:
                yield self.finding(
                    path, i + 1,
                    f"score_table row missing {sorted(missing)}")


class TuneKnobDomains(TuneRule):
    id = "LUX502"
    title = "tune-knob-domains"
    doc = ("every configured flag (winner and probed rows) is declared, "
           "tuner-managed, and valued inside its legal domain")

    def _check_config(self, path: str, row: int, config) -> Iterable[Finding]:
        if not isinstance(config, dict):
            yield self.finding(path, row, "config is not an object")
            return
        for name, value in sorted(config.items()):
            if not flags.declared(name):
                yield self.finding(
                    path, row, f"{name} is not a declared flag")
                continue
            if name not in TUNER_MANAGED:
                yield self.finding(
                    path, row,
                    f"{name} is declared but not tuner-managed "
                    "(space.TUNER_MANAGED)")
                continue
            v = str(value)
            if name == "LUX_EXCHANGE" \
                    and v not in ("full", "compact", "frontier"):
                yield self.finding(
                    path, row,
                    f"LUX_EXCHANGE={v!r} not in full/compact/frontier")
            elif name in ("LUX_EXCHANGE_FRONTIER_FRAC",
                          "LUX_GAS_DENSITY_HI", "LUX_GAS_DENSITY_LO"):
                try:
                    x = float(v)
                except ValueError:
                    yield self.finding(path, row, f"{name}={v!r} not a float")
                    continue
                if not (0.0 < x <= 1.0):
                    yield self.finding(
                        path, row, f"{name}={x} outside (0, 1]")
            elif name == "LUX_GROUPED_TAIL" \
                    and v.strip().lower() not in _BOOLISH:
                yield self.finding(
                    path, row, f"LUX_GROUPED_TAIL={v!r} not boolean")
        hi = config.get("LUX_GAS_DENSITY_HI")
        lo = config.get("LUX_GAS_DENSITY_LO")
        if hi is not None and lo is not None:
            try:
                if float(lo) >= float(hi):
                    yield self.finding(
                        path, row,
                        f"hysteresis inverted: lo {lo} >= hi {hi} "
                        "(would flap every iteration)")
            except ValueError:
                pass

    def check(self, art: dict, path: str) -> Iterable[Finding]:
        yield from self._check_config(path, 0, art.get("config"))
        for i, tbl_row in enumerate(art.get("score_table") or []):
            if isinstance(tbl_row, dict):
                yield from self._check_config(
                    path, i + 1, tbl_row.get("config"))


class TuneSelection(TuneRule):
    id = "LUX503"
    title = "tune-selection"
    doc = ("winner = argmin(score, candidate_index) of the final rung; "
           "scores finite; default candidate probed; probe_ledger_ids "
           "exactly the score table's record ids")

    def check(self, art: dict, path: str) -> Iterable[Finding]:
        table = [r for r in (art.get("score_table") or [])
                 if isinstance(r, dict)
                 and isinstance(r.get("score"), (int, float))
                 and "rung" in r and "candidate_index" in r]
        if not table:
            return   # LUX501 already rejects the shape
        for i, row in enumerate(art.get("score_table") or []):
            s = row.get("score") if isinstance(row, dict) else None
            if not isinstance(s, (int, float)) or not math.isfinite(s) \
                    or s < 0:
                yield self.finding(
                    path, i + 1, f"score {s!r} not a finite non-negative "
                    "number")
        if not any(r["candidate_index"] == 0 for r in table):
            yield self.finding(
                path, 0,
                "default candidate (index 0) never probed: the artifact "
                "carries no tuned-vs-default delta")
        last = max(r["rung"] for r in table)
        final = [r for r in table if r["rung"] == last]
        best = min(final, key=lambda r: (r["score"], r["candidate_index"]))
        if best.get("config") != art.get("config"):
            yield self.finding(
                path, 0,
                f"winner config {art.get('config')!r} is not the final "
                f"rung's argmin {best.get('config')!r}")
        if isinstance(art.get("score"), (int, float)) \
                and art["score"] != best["score"]:
            yield self.finding(
                path, 0,
                f"artifact score {art['score']!r} != winning probe score "
                f"{best['score']!r}")
        want_ids = [r.get("probe_record_id")
                    for r in (art.get("score_table") or [])
                    if isinstance(r, dict) and r.get("probe_record_id")]
        got_ids = art.get("probe_ledger_ids")
        if got_ids != want_ids:
            yield self.finding(
                path, 0,
                f"probe_ledger_ids ({len(got_ids or [])}) != score "
                f"table's recorded probe ids ({len(want_ids)})")
        if want_ids and len(set(want_ids)) != len(want_ids):
            yield self.finding(path, 0, "duplicate probe record ids")


class TuneStaleness(TuneRule):
    id = "LUX504"
    title = "tune-staleness"
    doc = ("created_at sane and within LUX_TUNE_MAX_AGE_S; fingerprint/"
           "mesh/graph_meta well-formed — a config tuned for another "
           "graph or epoch is not evidence for this one")

    def check(self, art: dict, path: str) -> Iterable[Finding]:
        now = time.time()
        at = art.get("created_at")
        if not isinstance(at, (int, float)) or not math.isfinite(at):
            yield self.finding(path, 0, f"created_at {at!r} not a timestamp")
        else:
            if at > now + 300.0:
                yield self.finding(
                    path, 0, f"created_at {at} is in the future")
            max_age = flags.get_float("LUX_TUNE_MAX_AGE_S")
            if max_age > 0 and now - at > max_age:
                yield self.finding(
                    path, 0,
                    f"artifact is {now - at:.0f}s old, past the "
                    f"LUX_TUNE_MAX_AGE_S={max_age:.0f}s staleness bound: "
                    "re-tune against the current graph")
        key = art.get("key")
        if isinstance(key, dict):
            fp = str(key.get("graph_fingerprint", ""))
            if not fp or fp == "?" or " " in fp:
                yield self.finding(
                    path, 0, f"graph_fingerprint {fp!r} is not a "
                    "checkpoint fingerprint")
            mesh = str(key.get("mesh_shape", ""))
            if not _MESH_RE.match(mesh):
                yield self.finding(
                    path, 0, f"mesh_shape {mesh!r} is not N or PxQ")
            for field in ("program", "engine_kind", "device_kind"):
                if not str(key.get(field, "")):
                    yield self.finding(path, 0, f"key.{field} is empty")
        meta = art.get("graph_meta")
        if not isinstance(meta, dict) \
                or not all(isinstance(meta.get(k), int) and meta[k] > 0
                           for k in ("nv", "ne")):
            yield self.finding(
                path, 0, f"graph_meta {meta!r} lacks positive nv/ne")


def all_tune_rules() -> List[TuneRule]:
    return [TuneStructure(), TuneKnobDomains(), TuneSelection(),
            TuneStaleness()]


def verify_artifact(art: dict, path: str = "<tuneconf>",
                    rules: Optional[Sequence[TuneRule]] = None
                    ) -> FileResult:
    """Run the LUX5xx rules over one loaded artifact dict."""
    if rules is None:
        rules = all_tune_rules()
    findings: List[Finding] = []
    errors: List[str] = []
    for rule in rules:
        try:
            findings.extend(rule.check(art, path))
        except Exception as e:   # a malformed artifact must report, not crash
            errors.append(f"{path}: {rule.id} crashed: {e!r}")
    findings.sort(key=lambda f: (f.line, f.rule))
    return FileResult(path, findings, [], error="; ".join(errors) or None)


def verify_artifact_paths(paths: Sequence[str],
                          rules: Optional[Sequence[TuneRule]] = None
                          ) -> LintReport:
    """Verify tuneconf.v1 files and/or directories of them."""
    t0 = time.perf_counter()
    files: List[str] = []
    results: List[FileResult] = []
    for p in paths:
        if os.path.isdir(p):
            found = tart.list_artifacts(p)
            if not found:
                results.append(FileResult(
                    p, [], [],
                    error=f"{p}: no tuneconf-*.json artifacts"))
            files.extend(found)
        else:
            files.append(p)
    for path in files:
        try:
            art = tart.load_path(path)
        except Exception as e:
            results.append(FileResult(
                path, [], [], error=f"{path}: unloadable artifact: {e!r}"))
            continue
        results.append(verify_artifact(art, path, rules))
    return LintReport(results, time.perf_counter() - t0,
                      schema=TUNE_SCHEMA)
