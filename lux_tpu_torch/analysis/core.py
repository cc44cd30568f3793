"""luxlint rule engine, the counterpart of ``lux_tpu/analysis/core.py``:
findings, suppressions, the file runner and the report, with the same
fields, summary payload and human and JSON output.

Deliberately stdlib-only (ast + re + json): the AST and concurrency
tiers walk the whole package and must finish in seconds, and
``luxlint --tune`` verifies a directory of artifacts from a cold
interpreter, so nothing here imports torch or numpy. Rules are AST
visitors over one file at a time; cross-file state (the declared-flag
set) is loaded once per run and handed to rules via
:class:`FileContext`.

Suppressions are inline, per line, per rule::

    torch.cuda.synchronize()  # luxlint: disable=LUX001 -- one sync/flush

``disable=all`` silences every rule on that line. A comment-only line
directly above the finding also counts (multi-line calls put the marker
where it reads best). Suppressed findings are counted and reported —
silence is visible, never free.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set

__all__ = ["Finding", "FileContext", "FileResult", "LintReport", "Rule",
           "iter_python_files", "load_declared_flags", "run_paths",
           "run_source", "suppressions_for"]

_SUPPRESS_RE = re.compile(
    r"#\s*luxlint:\s*disable=([A-Za-z0-9_,\s]+?)(?:\s*--.*)?$"
)


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


class FileContext:
    """Per-file state handed to every rule's ``check``."""

    def __init__(self, path: str, source: str,
                 declared_flags: Optional[Set[str]] = None):
        self.path = path
        # Rules scope by path fragment (e.g. "engine/"); normalize so the
        # same rule set works on Windows-style separators and relpaths.
        self.posix_path = path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.declared_flags = declared_flags if declared_flags is not None \
            else set()


class Rule:
    """One lint rule: an id, a one-line doc, and an AST check."""

    id = "LUX000"
    title = "base rule"
    doc = ""

    def applies_to(self, ctx: FileContext) -> bool:
        return True

    def check(self, tree: ast.Module, ctx: FileContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, message: str) -> Finding:
        return Finding(self.id, ctx.path, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), message)


def suppressions_for(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """Map 1-based line number -> set of suppressed rule ids ({'all'}
    for blanket disables). A comment-only line extends its suppression
    to the following line."""
    out: Dict[int, Set[str]] = {}
    for i, raw in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
        out.setdefault(i, set()).update(ids)
        if raw.lstrip().startswith("#"):
            out.setdefault(i + 1, set()).update(ids)
    return out


def _is_suppressed(f: Finding, supp: Dict[int, Set[str]]) -> bool:
    ids = supp.get(f.line)
    return bool(ids) and ("all" in ids or f.rule in ids)


@dataclasses.dataclass
class FileResult:
    path: str
    findings: List[Finding]
    suppressed: List[Finding]
    error: Optional[str] = None   # syntax/read/load error, reported as-is


def run_source(source: str, path: str, rules: Sequence[Rule],
               declared_flags: Optional[Set[str]] = None) -> FileResult:
    """Run ``rules`` over one file's source, splitting the findings into
    kept and suppressed."""
    ctx = FileContext(path, source, declared_flags)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return FileResult(path, [], [], error=f"{path}:{e.lineno}: {e.msg}")
    supp = suppressions_for(ctx.lines)
    kept: List[Finding] = []
    quiet: List[Finding] = []
    for rule in rules:
        if not rule.applies_to(ctx):
            continue
        for f in rule.check(tree, ctx):
            (quiet if _is_suppressed(f, supp) else kept).append(f)
    kept.sort(key=lambda f: (f.line, f.col, f.rule))
    return FileResult(path, kept, quiet)


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


def load_declared_flags() -> Set[str]:
    """Declared LUX_* flag names from the port's central registry.

    flags.py is stdlib-only by contract, so importing it is cheap and
    keeps the lint's view identical to the runtime's."""
    from lux_tpu_torch.utils import flags

    return set(flags.names())


def run_paths(paths: Sequence[str], rules: Sequence[Rule],
              declared_flags: Optional[Set[str]] = None) -> LintReport:
    """Run ``rules`` over every ``.py`` file of ``paths``."""
    t0 = time.perf_counter()
    if declared_flags is None:
        declared_flags = load_declared_flags()
    results = []
    for path in iter_python_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            results.append(FileResult(path, [], [], error=f"{path}: {e}"))
            continue
        results.append(run_source(source, path, rules, declared_flags))
    return LintReport(results, time.perf_counter() - t0)
