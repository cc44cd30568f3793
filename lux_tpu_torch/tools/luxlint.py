"""luxlint for the port: the tune-artifact tier of ``tools/luxlint.py``.

Usage:
    python -m lux_tpu_torch.tools.luxlint --tune DIR...  # verify saved
                                                  # tuneconf.v1 artifacts
                                                  # (LUX501-504)
    python -m lux_tpu_torch.tools.luxlint --tune  # the LUX_TUNE_DIR store
    python -m lux_tpu_torch.tools.luxlint --tune --json DIR
    python -m lux_tpu_torch.tools.luxlint --list-rules

The output and exit status are ``tools/luxlint.py --tune``'s: one line
per finding, a human summary line and one greppable ``LUXLINT {...}``
summary line; exit 0 clean, 1 on findings or unloadable artifacts, 2 on
a usage error. The other tiers (AST, threads, IR, grouped-tail plans,
exchange, programs, memory) are not ported (ROADMAP A16): asking for one
exits 2 with a message saying so.
"""

from __future__ import annotations

import argparse
import json
import sys

from lux_tpu_torch.utils import flags

_UNPORTED = ("ir", "plans", "threads", "exchange", "programs", "memory")


def _run_tune(paths, select: str):
    from lux_tpu_torch.analysis import tuneck
    rules = tuneck.all_tune_rules()
    if select:
        want = {s.strip() for s in select.split(",") if s.strip()}
        rules = [r for r in rules if r.id in want]
    return tuneck.verify_artifact_paths(paths, rules)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="luxlint", description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help="with --tune: tuneconf.v1 artifact files or "
                         "directories (default: LUX_TUNE_DIR)")
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
    for tier in _UNPORTED:
        ap.add_argument(f"--{tier}", action="store_true",
                        help="not ported (ROADMAP A16)")
    args = ap.parse_args(argv)

    if args.list_rules:
        from lux_tpu_torch.analysis import tuneck
        for r in tuneck.all_tune_rules():
            print(f"{r.id}  {r.title}\n       {r.doc}")
        return 0
    asked = [t for t in _UNPORTED if getattr(args, t)]
    if asked or not args.tune:
        tier = f"--{asked[0]}" if asked else "the AST tier"
        ap.error(f"{tier} is not ported to lux_tpu_torch (ROADMAP A16); "
                 "only --tune is: run tools/luxlint.py for the others")
    paths = args.paths
    if not paths and flags.get("LUX_TUNE_DIR"):
        paths = [flags.get("LUX_TUNE_DIR")]
    if not paths:
        ap.error("--tune requires at least one artifact file or "
                 "directory")
    report = _run_tune(paths, args.select)
    if args.json:
        print(report.to_json())
    else:
        print(report.format_human())
    print("LUXLINT " + json.dumps(report.summary(), sort_keys=True))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
