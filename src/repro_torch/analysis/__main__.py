"""``python -m repro_torch.analysis`` -- audit plans and source from the
shell.

Counterpart of ``python -m repro.analysis``, with its flags and exit
codes.  Modes (combinable; ``--all`` = ``--grid --lint``):

  --grid          plan + audit the full route grid (serial|staged|mesh x
                  rank1|panel x lookahead on/off, estimators incl. grad);
                  each plan runs once under the op recorder
  --lint          AST lint over --src (default: the repro_torch package
                  dir)
  --aot DIR       audit every exported plan artifact in DIR

``--device`` (the port's flag, as ``python -m repro_torch.serve`` has
it) picks where the grid and the artifacts run: the card unless
``cpu``.  The grid's mesh entries run on one gloo rank there.

Findings pass through the committed allowlist
(``src/repro_torch/analysis/allowlist.toml`` unless ``--allowlist``
overrides); waived findings stay in the report as ``info``.  Exit
status: 1 when any error-severity finding survives (``--strict`` also
promotes warnings), else 0.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static audit of repro_torch plans and source")
    ap.add_argument("--all", action="store_true",
                    help="run the plan grid and the AST lint")
    ap.add_argument("--grid", action="store_true",
                    help="audit the engine/estimator plan grid")
    ap.add_argument("--lint", action="store_true",
                    help="run the AST lint over --src")
    ap.add_argument("--aot", metavar="DIR",
                    help="audit exported plan artifacts in DIR")
    ap.add_argument("--n", type=int, default=32,
                    help="matrix side for the plan grid (default 32)")
    ap.add_argument("--src", action="append", default=None, metavar="PATH",
                    help="source roots for --lint (repeatable; default: "
                         "the installed repro_torch package)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass ids (default: all defaults)")
    ap.add_argument("--allowlist", default=None, metavar="TOML",
                    help="waiver file (default: the committed allowlist)")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="ignore every allowlist entry")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full AuditReport as JSON ('-' = stdout)")
    ap.add_argument("--strict", action="store_true",
                    help="treat warnings as errors for the exit status")
    ap.add_argument("--device", default=None,
                    help="where --grid and --aot run (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.all:
        args.grid = args.lint = True
    if not (args.grid or args.lint or args.aot):
        ap.error("nothing to do: pass --all, --grid, --lint, and/or --aot")

    from repro_torch import analysis

    pass_ids = tuple(args.passes.split(",")) if args.passes else None
    if pass_ids:
        unknown = [p for p in pass_ids if p not in analysis.PASSES]
        if unknown:
            ap.error(f"unknown pass id(s) {unknown}; have "
                     f"{sorted(analysis.PASSES)}")

    report = analysis.AuditReport()
    if args.grid:
        report.extend(analysis.audit_grid(pass_ids=pass_ids, n=args.n,
                                          device=args.device))
    if args.lint:
        roots = [Path(p) for p in args.src] if args.src else \
            [Path(analysis.__file__).resolve().parents[1]]
        root = roots[0].parent if len(roots) == 1 else None
        report.extend(analysis.lint_paths(roots, root=root))
    if args.aot:
        report.extend(analysis.audit_aot_dir(args.aot, pass_ids=pass_ids,
                                             device=args.device))

    if not args.no_allowlist:
        allowlist_path = args.allowlist or analysis.DEFAULT_ALLOWLIST
        report = analysis.apply_allowlist(
            report, analysis.load_allowlist(allowlist_path))

    if args.json:
        payload = report.to_json()
        if args.json == "-":
            print(payload)
        else:
            Path(args.json).write_text(payload + "\n")

    if args.json != "-":
        print(report.summary())

    failed = bool(report.errors) or (args.strict and report.warnings)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
