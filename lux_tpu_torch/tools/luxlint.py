"""luxlint for the port: the tune-artifact and program-contract tiers of
``tools/luxlint.py``.

Usage:
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
    python -m lux_tpu_torch.tools.luxlint --baseline F ...  # snapshot/
                                                  # compare: only findings
                                                  # absent from F fail
    python -m lux_tpu_torch.tools.luxlint --list-rules

The program hooks of ``--programs`` run on the card, or on the CPU with
``LUX_PLATFORM=cpu``. The output and exit status are ``tools/luxlint.py``'s:
one line per finding, a human summary line and one greppable
``LUXLINT {...}`` summary line; exit 0 clean, 1 on findings or
unloadable artifacts and fixtures, 2 on a usage error (tiers are
mutually exclusive). The other tiers (AST, threads, IR, grouped-tail
plans, exchange, memory) are not ported (ROADMAP A16): asking for one
exits 2 with a message saying so.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

from lux_tpu_torch.utils import flags

_UNPORTED = ("ir", "plans", "threads", "exchange", "memory")
_TIERS = ("tune", "programs") + _UNPORTED

_SPAN_CACHE: dict = {}


def _span_hash(path: str, line: int) -> str:
    """Content hash of the finding's source span: sha1 (16 hex chars) of
    the stripped text of the flagged line. Returns "" when the path is
    virtual (registry programs, artifacts) or the line is out of
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


def _run_tune(paths, select: str):
    from lux_tpu_torch.analysis import tuneck
    rules = tuneck.all_tune_rules()
    if select:
        want = {s.strip() for s in select.split(",") if s.strip()}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="luxlint", description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help="with --tune: tuneconf.v1 artifact files or "
                         "directories (default: LUX_TUNE_DIR); with "
                         "--programs: fixture modules defining programs")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON on stdout")
    ap.add_argument("--select", default="",
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
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
    ap.add_argument("--baseline", default="",
                    help="snapshot file: if missing, write current findings "
                         "and pass; if present, fail only on new findings")
    for tier in _UNPORTED:
        ap.add_argument(f"--{tier}", action="store_true",
                        help="not ported (ROADMAP A16)")
    args = ap.parse_args(argv)

    if sum(getattr(args, t) for t in _TIERS) > 1:
        ap.error("--tune, --programs, " + ", ".join(
            f"--{t}" for t in _UNPORTED) + " are separate tiers; run them "
            "separately")
    if args.list_rules:
        from lux_tpu_torch.analysis import gasck, tuneck
        for r in list(tuneck.all_tune_rules()) + gasck.all_program_rules():
            print(f"{r.id}  {r.title}\n       {r.doc}")
        return 0
    asked = [t for t in _UNPORTED if getattr(args, t)]
    if asked or not (args.tune or args.programs):
        tier = f"--{asked[0]}" if asked else "the AST tier"
        ap.error(f"{tier} is not ported to lux_tpu_torch (ROADMAP A16); "
                 "only --tune and --programs are: run tools/luxlint.py "
                 "for the others")
    if args.tune:
        paths = args.paths
        if not paths and flags.get("LUX_TUNE_DIR"):
            paths = [flags.get("LUX_TUNE_DIR")]
        if not paths:
            ap.error("--tune requires at least one artifact file or "
                     "directory")
        report = _run_tune(paths, args.select)
    else:
        report = _run_programs(args.paths, args.select, args.gascap_out)
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
