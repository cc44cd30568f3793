"""Render / validate ``profile.v1`` device-timeline reports of the port;
the counterpart of ``tools/prof_summary.py``.

    python -m lux_tpu_torch.tools.prof_summary DIR [--json | --validate]

Input (positional PATH), any of:

- a ``profile_v1.json`` report written by a capture window (the SIGUSR2
  toggle);
- a raw ``*.pt.trace.json.gz`` Chrome-trace artifact (torch.profiler;
  the CLIs' ``-profile DIR`` writes one);
- a capture directory — the newest trace artifact under it is parsed.

Default output is the human table (``obs/prof.py`` ``format_report``:
per-device exchange/compute/overlap interval unions, the
device-measured ``realized_hidden_frac``, idle fraction, top ops,
steps-per-second cross-check). ``--json`` prints the validated report
JSON instead; ``--validate`` prints nothing and exits 0/1. Parsing is
stdlib-only (json + gzip); a truncated or malformed artifact fails loudly with
``ProfileParseError``, never a half-filled report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from lux_tpu_torch.obs import prof


def load_report(path: str, top_k: int) -> dict:
    """PATH -> validated profile.v1 report (see module docstring for
    the accepted shapes)."""
    if os.path.isdir(path):
        return prof.parse_dir(path, top_k=top_k)
    if path.endswith(".json") and not path.endswith(".trace.json"):
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema") == "profile.v1":
            return prof.validate(doc)
        # A bare (uncompressed) Chrome trace dump also arrives as .json.
        return prof.parse_events(doc, top_k=top_k)
    return prof.parse(path, top_k=top_k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="profile_v1.json | *.trace.json.gz | "
                    "capture directory")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the validated report JSON")
    ap.add_argument("--validate", action="store_true",
                    help="validate only: no output, exit 0/1")
    ap.add_argument("--top-k", type=int, default=10,
                    help="op-table rows when parsing a raw trace")
    args = ap.parse_args(argv)

    try:
        rep = load_report(args.path, args.top_k)
    except (prof.ProfileParseError, OSError, json.JSONDecodeError) as e:
        print(f"INVALID {args.path}: {e}", file=sys.stderr)
        return 1
    if args.validate:
        print(f"valid profile.v1: {args.path}", file=sys.stderr)
        return 0
    if args.as_json:
        print(json.dumps(rep, indent=1, sort_keys=True))
    else:
        print(prof.format_report(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
