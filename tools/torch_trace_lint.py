#!/usr/bin/env python
"""Trace-contract gate of the PyTorch port: AST lint + step audit.

Twin of ``tools/trace_lint.py`` for ``src/repro_torch``. Two layers, one
exit code:

1. **AST lint** (`repro_torch.analysis.astcheck`) — stdlib-only scan of
   ``src/repro_torch`` for host/device-split violations, host syncs and
   RNG in device-side methods, unfrozen spec dataclasses and statics-key
   completeness. Runs first, before torch is imported.
2. **Step audit** (`repro_torch.analysis.traceaudit`) — runs every
   audit grid's static groups for 12 steps on ``--device`` and gates K1
   entries (and, on the card, launches and host syncs), f64->f32
   demotions, output dtypes and group counts against the committed
   ``src/repro_torch/analysis/trace_audit.json``.

Usage:
  python tools/torch_trace_lint.py                 # both layers, on the card
  python tools/torch_trace_lint.py --device cpu    # both layers, on the CPU
  python tools/torch_trace_lint.py --ast-only      # source lint only
  python tools/torch_trace_lint.py --audit-only    # step audit only
  python tools/torch_trace_lint.py --device cpu --update-audit
                                                   # refresh the pin
  python tools/torch_trace_lint.py PATH [PATH...]  # lint given paths only

``--device cuda`` (the default) raises when there is no card: the audit
never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def run_ast_lint(paths: "list[pathlib.Path]") -> int:
    from repro_torch.analysis.astcheck import lint_paths

    findings = lint_paths(paths, root=ROOT)
    for f in findings:
        print(f"  {f}")
    scanned = ", ".join(str(p) for p in paths)
    if findings:
        print(f"torch-trace-lint[ast]: {len(findings)} finding(s) in {scanned}")
        return 1
    print(f"torch-trace-lint[ast]: clean ({scanned})")
    return 0


def run_step_audit(update: bool, device: str) -> int:
    from repro_torch.analysis import traceaudit

    report = traceaudit.audit_report(device=device)
    if update:
        traceaudit.write_baseline(report)
        print(
            f"torch-trace-lint[audit]: pinned {len(report)} grids to "
            f"{traceaudit.DEFAULT_BASELINE.relative_to(ROOT)}"
        )
        # A refresh still gates the unconditional contracts: it must
        # never pin a lost K1 path, a host sync or an f32 output.
        failures, _ = traceaudit.compare_report(report, None)
    else:
        baseline = traceaudit.load_baseline()
        if baseline is None:
            print(
                "torch-trace-lint[audit]: WARNING no pinned report — run "
                "with --device cpu --update-audit to pin"
            )
        failures, notes = traceaudit.compare_report(report, baseline)
        for n in notes:
            print(f"  note: {n}")
    for f in failures:
        print(f"  FAIL: {f}")
    if failures:
        print(f"torch-trace-lint[audit]: {len(failures)} contract failure(s)")
        return 1
    n_sigs = sum(len(e["signatures"]) for e in report.values())
    print(
        f"torch-trace-lint[audit]: {len(report)} grids / {n_sigs} static "
        f"groups clean on {device}"
    )
    return 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "paths", nargs="*", type=pathlib.Path,
        help="files/dirs to AST-lint (default: src/repro_torch)",
    )
    ap.add_argument("--ast-only", action="store_true",
                    help="skip the step audit")
    ap.add_argument("--audit-only", action="store_true",
                    help="skip the AST lint")
    ap.add_argument("--update-audit", action="store_true",
                    help="rewrite src/repro_torch/analysis/trace_audit.json")
    ap.add_argument("--device", default="cuda",
                    help="device of the step audit (default cuda)")
    args = ap.parse_args(argv)
    if args.ast_only and args.audit_only:
        ap.error("--ast-only contradicts --audit-only")
    if args.ast_only and args.update_audit:
        ap.error("--ast-only contradicts --update-audit")

    rc = 0
    if not args.audit_only:
        paths = args.paths or [ROOT / "src" / "repro_torch"]
        rc |= run_ast_lint([pathlib.Path(p) for p in paths])
    if not args.ast_only and not args.paths:
        rc |= run_step_audit(update=args.update_audit, device=args.device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
