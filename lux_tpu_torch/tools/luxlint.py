"""luxlint for the port: the tiers of ``tools/luxlint.py`` over the
port's tree — source text, saved host arrays, program algebra, and the
trace tiers over a torch trace of each executor's step.

Usage:
    python -m lux_tpu_torch.tools.luxlint           # AST tier (LUX001-010)
                                                  # over lux_tpu_torch and
                                                  # chip_smoke.py
    python -m lux_tpu_torch.tools.luxlint path.py dir/  # lint targets
    python -m lux_tpu_torch.tools.luxlint --changed  # only files changed
                                                  # vs git HEAD
    python -m lux_tpu_torch.tools.luxlint --threads  # concurrency tier
                                                  # (LUX301-305) over
                                                  # lux_tpu_torch
    python -m lux_tpu_torch.tools.luxlint --plans DIR...  # verify saved
                                                  # GroupedTailPlan
                                                  # artifacts (LUX201-205)
    python -m lux_tpu_torch.tools.luxlint --ir      # IR tier: trace every
                                                  # registered program x
                                                  # executor's step, run
                                                  # LUX101-105
    python -m lux_tpu_torch.tools.luxlint --ir f.py  # trace a module's
                                                  # TRACES list
    python -m lux_tpu_torch.tools.luxlint --exchange  # every sharded
                                                  # registry executor: its
                                                  # traced step (LUX404-
                                                  # 406) and compact plan
                                                  # (LUX401-403, 407)
    python -m lux_tpu_torch.tools.luxlint --exchange DIR|f.py  # verify
                                                  # saved exchange-plan
                                                  # artifacts / TRACES and
                                                  # PLANS fixtures
    python -m lux_tpu_torch.tools.luxlint --tune DIR...  # verify saved
                                                  # tuneconf.v1 artifacts
                                                  # (LUX501-504)
    python -m lux_tpu_torch.tools.luxlint --tune  # the LUX_TUNE_DIR store
    python -m lux_tpu_torch.tools.luxlint --programs     # prove each
                                                  # registry program's GAS
                                                  # algebra + derive the
                                                  # capability matrix
                                                  # (LUX601-606)
    python -m lux_tpu_torch.tools.luxlint --programs f.py  # prove the
                                                  # programs of fixture
                                                  # modules instead
    python -m lux_tpu_torch.tools.luxlint --programs --gascap-out F
    python -m lux_tpu_torch.tools.luxlint --json / --select LUX001 / ...
    python -m lux_tpu_torch.tools.luxlint --baseline F ...  # snapshot/
                                                  # compare: only findings
                                                  # absent from F fail
    python -m lux_tpu_torch.tools.luxlint --list-rules

The AST, concurrency and plan tiers run on the host and import no torch
for the checks themselves. The executors of registry ``--ir`` and
``--exchange``, the steps they trace and the program hooks of
``--programs`` run on the card, or on the CPU with ``LUX_PLATFORM=cpu``
(a step that fails to trace on the card is an error, never retried on
the CPU). The output and exit status are ``tools/luxlint.py``'s: one
line per finding, a human summary line and one greppable ``LUXLINT
{...}`` summary line; exit 0 clean, 1 on findings, syntax errors, failed
traces or unloadable artifacts and fixtures, 2 on a usage error (tiers
are mutually exclusive). Not ported (ROADMAP A16): ``--memory``
(LUX701-706), which exits 2 with a message saying so.

Suppress an AST- or threads-tier finding inline, with a reason:
    x.item()  # luxlint: disable=LUX001 -- intended once-per-run sync
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

from lux_tpu_torch.utils import flags

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The AST tier's default tree; the concurrency tier's is the package.
DEFAULT_TARGETS = ("lux_tpu_torch", "chip_smoke.py")
THREAD_TARGETS = ("lux_tpu_torch",)

_UNPORTED = ("memory",)
_TIERS = ("ir", "plans", "threads", "exchange", "tune", "programs") \
    + _UNPORTED
# Files whose change can change a traced step: --changed runs the trace
# tiers' registry only when one of them did.
_TRACE_RELEVANT = tuple(f"lux_tpu_torch/{d}" for d in (
    "engine/", "parallel/", "graph/", "analysis/", "models", "obs/",
    "ops/"))

_SPAN_CACHE: dict = {}


def _changed_paths() -> list:
    """Python files changed vs HEAD (staged + unstaged + untracked)."""
    out = set()
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            text = subprocess.run(cmd, cwd=_REPO, capture_output=True,
                                  text=True, check=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"luxlint: --changed: {' '.join(cmd)} failed: {e}",
                  file=sys.stderr)
            return []
        for line in text.splitlines():
            if line.endswith(".py"):
                p = os.path.join(_REPO, line)
                if os.path.isfile(p):
                    out.add(p)
    return sorted(out)


def _span_hash(path: str, line: int) -> str:
    """Content hash of the finding's source span: sha1 (16 hex chars) of
    the stripped text of the flagged line. Returns "" when the path is
    virtual (registry targets, artifacts) or the line is out of
    range."""
    if line < 1:
        return ""
    if path not in _SPAN_CACHE:
        try:
            with open(path, "rb") as fh:
                _SPAN_CACHE[path] = fh.read().splitlines()
        except OSError:
            _SPAN_CACHE[path] = None
    lines = _SPAN_CACHE[path]
    if lines is None or line > len(lines):
        return ""
    return hashlib.sha1(lines[line - 1].strip()).hexdigest()[:16]


def _baseline_key(path: str, f) -> str:
    """Ratchet key: (rule, path, source-span hash), the message where
    there is no source line to hash."""
    span = _span_hash(path, f.line)
    return f"{f.rule}\t{path}\t{span or f.message}"


def _apply_baseline(report, baseline_path: str) -> int:
    """Snapshot-or-compare. Missing file: write current findings, pass.
    Present: fail only on findings whose _baseline_key is new (or on
    errors)."""
    current = {}
    for res in report.results:
        for f in res.findings:
            current.setdefault(_baseline_key(res.path, f), []).append((res, f))
    if not os.path.exists(baseline_path):
        with open(baseline_path, "w") as fh:
            json.dump({"schema": report.schema + ".baseline",
                       "keys": sorted(current)}, fh, indent=0)
        print(f"luxlint: baseline written: {baseline_path} "
              f"({len(current)} finding keys)")
        return 0
    with open(baseline_path) as fh:
        known = set(json.load(fh).get("keys", ()))
    new = sorted(k for k in current if k not in known)
    errors = [r for r in report.results if r.error]
    for k in new:
        res, f = current[k][0]
        print(f"{res.path}:{f.line}:{f.col}: {f.rule} {f.message}  [new]")
    print(f"luxlint: baseline {baseline_path}: {len(new)} new / "
          f"{len(current)} total findings, {len(errors)} errors")
    return 1 if new or errors else 0


def _select(select: str):
    return {s.strip() for s in select.split(",") if s.strip()} or None


def _clean_skip(schema: str, why: str) -> int:
    print(f"luxlint: --changed: {why}")
    print("LUXLINT " + json.dumps(
        {"schema": schema, "files": 0, "findings": 0, "errors": 0,
         "ok": True}, sort_keys=True))
    return 0


def _run_plans(paths, select: str):
    from lux_tpu_torch.analysis import planck
    rules = planck.all_plan_rules()
    want = _select(select)
    if want:
        rules = [r for r in rules if r.id in want]
    return planck.verify_plan_dirs(paths, rules)


def _run_ir(paths, select: str):
    """IR tier (LUX101-105): with paths, the ``TRACES`` of fixture
    modules; with none, every registered program x executor, built and
    traced on the card unless ``LUX_PLATFORM=cpu``."""
    from lux_tpu_torch.analysis import ir
    from lux_tpu_torch.analysis.core import FileResult, LintReport

    rules = ir.all_ir_rules()
    want = _select(select)
    if want:
        rules = [r for r in rules if r.id in want]
    if not paths:
        from lux_tpu_torch.utils.platform import platform_device
        return ir.run_targets(ir.registry_targets(device=platform_device()),
                              rules)
    targets, broken = [], []
    for p in paths:
        try:
            targets.extend(ir.load_fixture_targets(p))
        except Exception as e:
            broken.append(FileResult(
                p, [], [], error=f"{p}: unloadable fixture: {e!r}"))
    report = ir.run_targets(targets, rules)
    return LintReport(broken + report.results, report.elapsed_s,
                      schema=report.schema)


def _run_exchange(paths, select: str):
    """Exchange tier: with paths, saved artifact directories and
    ``TRACES``/``PLANS`` fixtures; with none, every sharded registry
    executor, built and traced on the card unless ``LUX_PLATFORM=cpu``:
    its traced step (LUX404-406) and its live compact plan (LUX401-403,
    407)."""
    from lux_tpu_torch.analysis import ir

    want = _select(select)
    if paths:
        return ir.run_exchange_paths(paths, select=want)
    from lux_tpu_torch.utils.platform import platform_device
    return ir.run_exchange_matrix(select=want, device=platform_device())


def _run_tune(paths, select: str):
    from lux_tpu_torch.analysis import tuneck
    rules = tuneck.all_tune_rules()
    want = _select(select)
    if want:
        rules = [r for r in rules if r.id in want]
    return tuneck.verify_artifact_paths(paths, rules)


def _run_programs(paths, select: str, gascap_out: str):
    """Program-contract tier (LUX601-606), the hooks on the card unless
    ``LUX_PLATFORM=cpu``. With no paths, the registered programs, and a
    clean run writes the gascap.v1 artifact when --gascap-out names a
    file; with paths, the programs of fixture modules."""
    from lux_tpu_torch.analysis import gasck
    from lux_tpu_torch.utils.platform import platform_device

    dev = platform_device()
    want = None
    if select:
        want = tuple(s.strip() for s in select.split(",") if s.strip())
    if paths:
        return gasck.verify_fixture_paths(paths, select=want, device=dev)
    return gasck.verify_registry(select=want,
                                 capmap_out=gascap_out or None, device=dev)


def _list_rules() -> None:
    from lux_tpu_torch.analysis import (exchck, gasck, ir, planck, rules,
                                        threads, tuneck)
    for r in (rules.all_rules() + planck.all_plan_rules()
              + threads.all_thread_rules() + exchck.all_exchange_rules()
              + list(tuneck.all_tune_rules()) + gasck.all_program_rules()
              + ir.all_ir_rules() + ir.exchange_ir_rules()):
        print(f"{r.id}  {r.title}\n       {r.doc}")
    print("not ported (ROADMAP A16): LUX701-706 (--memory); of LUX002 "
          "and LUX003, lux_tpu's jax.jit donation and Pallas BlockSpec "
          "halves have no counterpart")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="luxlint", description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {DEFAULT_TARGETS}; "
                         f"with --threads: {THREAD_TARGETS}); with --ir: "
                         "fixture modules defining TRACES; with --plans: "
                         "saved plan artifact dirs; with --exchange: saved "
                         "exchange-plan dirs or TRACES/PLANS fixtures; with "
                         "--tune: tuneconf.v1 artifact files or "
                         "directories (default: LUX_TUNE_DIR); with "
                         "--programs: fixture modules defining programs")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON on stdout")
    ap.add_argument("--select", default="",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--ir", action="store_true",
                    help="run the IR tier (LUX101-105) over a torch trace "
                         "of every registered program x executor's step, "
                         "or over the TRACES of the given fixture modules")
    ap.add_argument("--plans", action="store_true",
                    help="verify saved GroupedTailPlan artifact dirs "
                         "(LUX201-205; torch-free, mmap load)")
    ap.add_argument("--threads", action="store_true",
                    help="run the concurrency tier (LUX301-305): thread-"
                         "shared state, lock-order graph, blocking-under-"
                         "lock, unjoined threads, publish discipline")
    ap.add_argument("--exchange", action="store_true",
                    help="run the exchange tier (LUX401-407): the "
                         "collective dataflow of every sharded registry "
                         "executor's traced step (LUX404-406) and "
                         "ExchangePlan structure/coverage/profitability "
                         "and frontier coverage of its compact plan; with "
                         "paths, verify saved exchange artifacts or "
                         "fixture modules")
    ap.add_argument("--tune", action="store_true",
                    help="verify saved tuneconf.v1 auto-tuner artifacts "
                         "(LUX501-504: structure, knob domains, selection "
                         "consistency, staleness)")
    ap.add_argument("--programs", action="store_true",
                    help="run the program-contract tier (LUX601-606): "
                         "prove combiner identity/exactness, push/pull "
                         "duality, frontier annihilation, and monotone "
                         "convergence for every registered program and "
                         "derive the gascap.v1 capability matrix; with "
                         "paths, prove fixture-module programs instead")
    ap.add_argument("--gascap-out", default="", metavar="FILE",
                    help="with --programs (registry mode): write the "
                         "derived gascap.v1 capability artifact here when "
                         "the run is clean")
    ap.add_argument("--changed", action="store_true",
                    help="AST/threads tiers: restrict to .py files changed "
                         "vs git HEAD (plus untracked); the threads tier "
                         "still builds its lock-order graph over the whole "
                         "package; --ir/--exchange registry: run only when "
                         "a file a traced step runs changed")
    ap.add_argument("--baseline", default="",
                    help="snapshot file: if missing, write current findings "
                         "and pass; if present, fail only on new findings")
    for tier in _UNPORTED:
        ap.add_argument(f"--{tier}", action="store_true",
                        help="not ported (ROADMAP A16, memck)")
    args = ap.parse_args(argv)

    if sum(getattr(args, t) for t in _TIERS) > 1:
        ap.error(", ".join(f"--{t}" for t in _TIERS)
                 + " are separate tiers; run them separately")
    if args.list_rules:
        _list_rules()
        return 0
    asked = [t for t in _UNPORTED if getattr(args, t)]
    if asked:
        ap.error(f"--{asked[0]} is not ported to lux_tpu_torch (ROADMAP "
                 "A16, memck): run tools/luxlint.py for it")

    if (args.ir or args.exchange) and args.changed and not args.paths:
        # The registries verify live engine behaviour, not file text:
        # skip them unless a file a traced step runs changed.
        if not [p for p in _changed_paths()
                if os.path.relpath(p, _REPO).startswith(_TRACE_RELEVANT)]:
            from lux_tpu_torch.analysis.exchck import EXCHANGE_SCHEMA
            from lux_tpu_torch.analysis.ir import IR_SCHEMA
            return _clean_skip(IR_SCHEMA if args.ir else EXCHANGE_SCHEMA,
                               "no trace-relevant files modified")
    if args.ir:
        report = _run_ir(args.paths, args.select)
    elif args.exchange:
        report = _run_exchange(args.paths, args.select)
    elif args.plans:
        if not args.paths:
            ap.error("--plans requires at least one artifact directory")
        report = _run_plans(args.paths, args.select)
    elif args.tune:
        paths = args.paths
        if not paths and flags.get("LUX_TUNE_DIR"):
            paths = [flags.get("LUX_TUNE_DIR")]
        if not paths:
            ap.error("--tune requires at least one artifact file or "
                     "directory")
        report = _run_tune(paths, args.select)
    elif args.programs:
        report = _run_programs(args.paths, args.select, args.gascap_out)
    elif args.threads:
        from lux_tpu_torch.analysis.threads import (all_thread_rules,
                                                    run_threads)
        select = _select(args.select)
        if select:
            unknown = select - {r.id for r in all_thread_rules()}
            if unknown:
                ap.error(f"unknown rule id(s): {sorted(unknown)}")
        tree = [os.path.join(_REPO, t) for t in THREAD_TARGETS]
        if args.changed:
            paths = _changed_paths()
            if not paths:
                return _clean_skip("luxlint-threads.v1",
                                   "no modified .py files")
            graph_paths = tree   # order graph stays whole-tree
        elif args.paths:
            paths = graph_paths = args.paths
        else:
            paths = graph_paths = tree
        report = run_threads(paths, select=select, graph_paths=graph_paths)
    else:
        from lux_tpu_torch.analysis.core import run_paths
        from lux_tpu_torch.analysis.rules import all_rules
        rules = all_rules()
        want = _select(args.select)
        if want:
            unknown = want - {r.id for r in rules}
            if unknown:
                ap.error(f"unknown rule id(s): {sorted(unknown)}")
            rules = [r for r in rules if r.id in want]
        if args.changed:
            paths = _changed_paths()
            if not paths:
                return _clean_skip("luxlint.v1", "no modified .py files")
        else:
            paths = args.paths or [os.path.join(_REPO, t)
                                   for t in DEFAULT_TARGETS]
        report = run_paths(paths, rules)
    if args.json:
        print(report.to_json())
    else:
        print(report.format_human())
    print("LUXLINT " + json.dumps(report.summary(), sort_keys=True))
    if args.baseline:
        return _apply_baseline(report, args.baseline)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
