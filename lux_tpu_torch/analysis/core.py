"""Lint findings and reports, the part of ``lux_tpu/analysis/core.py``
the tune-artifact and program-contract tiers (``tuneck.py``,
``gasck.py``) use: :class:`Finding`, :class:`FileResult` and
:class:`LintReport`, with the same fields, summary payload and human and
JSON output, and :func:`iter_python_files`. The AST rule engine
(``Rule``, suppressions, the file runner) comes with the AST tiers
(ROADMAP A16).

Deliberately stdlib-only: ``luxlint --tune`` verifies a directory of
artifacts from a cold interpreter, so nothing here imports torch or
numpy.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

__all__ = ["Finding", "FileResult", "LintReport", "iter_python_files"]


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str       # rule id, e.g. LUX501
    path: str       # file path as given to the runner
    line: int       # 1-based (a tune artifact: its score-table row)
    col: int        # 0-based
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FileResult:
    path: str
    findings: List[Finding]
    suppressed: List[Finding]
    error: Optional[str] = None   # read/load error, reported as-is


def iter_python_files(paths: Sequence[str]) -> List[str]:
    """The ``.py`` files of ``paths``: files as given, directories
    walked in sorted order (skipping ``__pycache__``, ``.git`` and
    ``build``)."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", "build")
                )
                out.extend(
                    os.path.join(root, f) for f in sorted(files)
                    if f.endswith(".py")
                )
        elif p.endswith(".py"):
            out.append(p)
    return out


@dataclasses.dataclass
class LintReport:
    results: List[FileResult]
    elapsed_s: float
    # Each tier stamps its own schema so one grep distinguishes which
    # pass produced a line.
    schema: str = "luxlint.v1"

    @property
    def findings(self) -> List[Finding]:
        return [f for r in self.results for f in r.findings]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for r in self.results for f in r.suppressed]

    @property
    def errors(self) -> List[str]:
        return [r.error for r in self.results if r.error]

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors

    def summary(self) -> dict:
        """One-line greppable summary payload."""
        by_rule: Dict[str, int] = {}
        for f in self.findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        return {
            "schema": self.schema,
            "files": len(self.results),
            "findings": len(self.findings),
            "suppressed": len(self.suppressed),
            "errors": len(self.errors),
            "by_rule": dict(sorted(by_rule.items())),
            "elapsed_s": round(self.elapsed_s, 3),
            "ok": self.ok,
        }

    def to_json(self) -> str:
        return json.dumps({
            "summary": self.summary(),
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [f.as_dict() for f in self.suppressed],
            "errors": self.errors,
        }, indent=2, sort_keys=True)

    def format_human(self) -> str:
        lines = [f.format() for f in self.findings]
        lines.extend(f"{e} (syntax error)" for e in self.errors)
        s = self.summary()
        lines.append(
            f"luxlint: {s['files']} files, {s['findings']} findings "
            f"({s['suppressed']} suppressed) in {s['elapsed_s']}s"
        )
        return "\n".join(lines)
