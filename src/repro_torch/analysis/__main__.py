"""CLI: `python -m repro_torch.analysis [paths...]`.

Exit codes: 0 clean (or every finding grandfathered / --no-fail-on-new),
1 non-baselined findings, 2 baseline integrity error (bad version, or a
grandfathered finding inside a bit-exactness-critical subtree).  The
contract pass runs on the card unless `--device cpu` asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.findings import (assert_clean_subtrees,
                                           load_baseline, split_by_baseline,
                                           write_baseline)
from repro_torch.analysis.runner import DEFAULT_BASELINE, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static checks for key discipline (KEY*), host-sync "
                    "hygiene (TRC*) and shape contracts (SHP*).")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs for the AST passes (default: "
                         "src/repro_torch)")
    ap.add_argument("--passes", default="keys,trace,contracts",
                    help="comma-separated subset of keys,trace,contracts")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the contract pass's fake tensors "
                         "(default: %(default)s)")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE,
                    help="grandfathered-findings file "
                         "(default: %(default)s)")
    ap.add_argument("--fail-on-new", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="exit 1 when a finding is not in the baseline "
                         "(default: on)")
    ap.add_argument("--json", type=Path, default=None, metavar="OUT",
                    help="write findings + timing as JSON")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline to the current findings "
                         "and exit 0")
    args = ap.parse_args(argv)

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    bad = [p for p in passes if p not in ("keys", "trace", "contracts")]
    if bad:
        ap.error(f"unknown passes: {bad}")

    findings, timing = run_all(args.paths or None, passes=passes,
                               device=args.device)

    try:
        baseline = load_baseline(args.baseline)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    clean_errors = assert_clean_subtrees(baseline)
    new, old = split_by_baseline(findings, baseline)

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    for f in new:
        print(f.format())
    for f in old:
        print(f"{f.format()}  [baselined]")
    for err in clean_errors:
        print(f"error: {err}", file=sys.stderr)

    per_pass = "  ".join(f"{k}={v:.2f}s" for k, v in timing.items()
                         if k != "total")
    print(f"repro_torch.analysis: {len(findings)} finding(s) "
          f"({len(new)} new, {len(old)} baselined) in "
          f"{timing['total']:.2f}s  [{per_pass}]")

    if args.json:
        args.json.write_text(json.dumps(
            {"findings": [f.to_dict() for f in findings],
             "new": [f.to_dict() for f in new],
             "baselined": [f.to_dict() for f in old],
             "timing_s": timing}, indent=1) + "\n")

    if clean_errors:
        return 2
    if args.fail_on_new and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
