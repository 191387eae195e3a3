"""lanelint CLI — ``python -m repro_torch.analysis.lint``.

Counterpart of ``repro.analysis.lint``.  Runs both layers (the footprint
rules R1–R4 over every registry cell and the composed steps; the AST
rules A0–A4 over ``src/repro_torch/**``), applies the baseline
suppression file, and reports:

  exit 0   no unsuppressed findings (stale baseline entries warn)
  exit 1   unsuppressed findings (printed, errors first)
  exit 2   the lint itself failed (bad baseline, a rank crashed, …)

Flags:
  --ast-only / --cells-only  run a single layer
  --baseline PATH            baseline file (default: repo-root
                             lint_baseline_torch.json)
  --no-baseline              ignore the baseline entirely
  --update-baseline          write the current findings to the baseline
                             (preserving existing reasons) and exit 0
  -v / --verbose             per-cell/per-step footprint progress

The cell and step sweeps run on spawned 8-rank gloo worlds on the CPU,
as ``repro``'s lowers on 8 host CPU devices: the lint checks what the
code issues, it is not a run of the system, so it neither looks for a
card nor falls back from one.
"""
from __future__ import annotations

import argparse
import sys


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static communication-invariant analysis "
                    "(lanelint): footprint rules + AST rules")
    layer = ap.add_mutually_exclusive_group()
    layer.add_argument("--ast-only", action="store_true",
                       help="run only the A0-A4 AST rules")
    layer.add_argument("--cells-only", action="store_true",
                       help="run only the R1-R4 footprint rules")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="baseline suppression file (default: repo-root "
                         "lint_baseline_torch.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write current findings to the baseline "
                         "(existing reasons preserved) and exit 0")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap.parse_args(argv)


def _collect(args) -> list:
    findings = []
    if not args.ast_only:
        from .rules import run_cell_rules, run_step_rules
        if args.verbose:
            print("== footprint rules (R1-R4): registry cells ==",
                  flush=True)
        findings += run_cell_rules(verbose=args.verbose)
        if args.verbose:
            print("== footprint rules (R1): steps ==", flush=True)
        findings += run_step_rules(verbose=args.verbose)
    if not args.cells_only:
        from .astlint import run_ast_rules
        if args.verbose:
            print("== AST rules (A0-A4): src/repro_torch/** ==", flush=True)
        findings += run_ast_rules()
    return findings


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    from .baseline import (apply_baseline, default_baseline_path,
                           load_baseline, save_baseline)
    from .diagnostics import format_findings
    try:
        findings = _collect(args)
        if args.update_baseline:
            path = save_baseline(findings, args.baseline)
            print(f"lanelint: wrote {len(findings)} suppression(s) to "
                  f"{path}")
            return 0
        baseline = {} if args.no_baseline \
            else load_baseline(args.baseline)
    except Exception as e:  # noqa: BLE001 — exit-code contract
        print(f"lanelint: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        if args.verbose:
            import traceback
            traceback.print_exc()
        return 2
    unsuppressed, stale = apply_baseline(findings, baseline)
    for key in stale:
        print(f"WARNING stale baseline entry {key} — the finding no "
              f"longer occurs; delete it from "
              f"{args.baseline or default_baseline_path()}")
    if unsuppressed:
        print(format_findings(unsuppressed))
        print(f"lanelint: {len(unsuppressed)} finding(s) "
              f"({len(findings) - len(unsuppressed)} suppressed, "
              f"{len(stale)} stale suppression(s))")
        return 1
    print(f"lanelint: clean ({len(findings)} suppressed, "
          f"{len(stale)} stale suppression(s))" if findings or stale
          else "lanelint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
