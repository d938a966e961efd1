"""CLI for the port's static passes: ``python -m repro_torch.analysis``
(counterpart of ``python -m repro.analysis``): the lock lint and the
reachability report, ``--rules lock,dead`` (both by default).

Prints findings as ``file:line RULE message`` and a one-line summary.
``--check`` (the gate) exits non-zero on any finding that is neither
inline-waived nor informational (DEAD002); the port keeps no baseline.

Stdlib only: runs without torch installed (AST walks).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.analysis import concurrency, deadcode

    here = os.path.dirname(os.path.abspath(__file__))
    default_src = os.path.dirname(here)                   # src/repro_torch

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="lock-discipline lint + reachability report of the "
                    "PyTorch port")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any finding not waived inline "
                         "(the gate)")
    ap.add_argument("--root", default=default_src,
                    help="package source tree to analyze "
                         "(default: the repro_torch package)")
    ap.add_argument("--rules", default="lock,dead",
                    help="comma-set of passes to run: lock,dead")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print inline-waived findings")
    args = ap.parse_args(argv)

    src_root = os.path.abspath(args.root)
    repo_root = os.path.dirname(os.path.dirname(src_root))
    passes = {p.strip() for p in args.rules.split(",") if p.strip()}
    findings = []
    if "lock" in passes:
        findings += concurrency.lint_tree(src_root, repo_root)
    if "dead" in passes:
        findings += deadcode.lint(repo_root, src_root)
    failing = [f for f in findings if not f.waived and not f.advice]
    for f in findings:
        if not f.waived or args.show_waived:
            print(f.format())
    n_info = sum(1 for f in findings if f.advice)
    print(f"repro_torch.analysis: {len(failing)} failing finding(s), "
          f"{sum(1 for f in findings if f.waived)} waived, {n_info} "
          "informational")
    return 1 if args.check and failing else 0


if __name__ == "__main__":
    sys.exit(main())
