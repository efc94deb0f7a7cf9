"""CLI: ``python -m repro_torch.obs validate <trace.json>``.

Counterpart of ``python -m repro.obs``: checks the Chrome-trace artifact
a ``REPRO_OBS=trace`` run produced (``chip_smoke.py`` phase 10 runs it on
its trace).  ``--require name`` (repeatable)
additionally asserts a span name is present; ``--require-prefix`` any
span with the prefix.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.export import validate_chrome_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="validate a Chrome-trace JSON file")
    v.add_argument("path")
    v.add_argument("--require", action="append", default=[],
                   metavar="NAME", help="span name that must be present")
    v.add_argument("--require-prefix", action="append", default=[],
                   metavar="PREFIX",
                   help="at least one span name must start with PREFIX")
    args = ap.parse_args(argv)

    try:
        summary = validate_chrome_trace(args.path)
    except (OSError, ValueError, KeyError) as exc:
        print(f"INVALID: {exc}", file=sys.stderr)
        return 1
    names = set(summary["names"])
    missing = [n for n in args.require if n not in names]
    for pfx in args.require_prefix:
        if not any(n.startswith(pfx) for n in names):
            missing.append(f"{pfx}*")
    if missing:
        print(f"INVALID: {args.path} has no span(s): {missing}; "
              f"present: {sorted(names)}", file=sys.stderr)
        return 1
    print(f"OK: {args.path} -- {summary['events']} events, "
          f"max depth {summary['max_depth']}, "
          f"{len(names)} distinct spans")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
