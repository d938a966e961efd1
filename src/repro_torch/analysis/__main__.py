"""CLI for the port's lock lint: ``python -m repro_torch.analysis``
(counterpart of ``python -m repro.analysis``).

Prints findings as ``file:line RULE message`` and a one-line summary.
``--check`` (the gate) exits non-zero on any finding that is not
inline-waived; the port keeps no baseline.

Stdlib only: runs without torch installed (an AST walk).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.analysis import concurrency

    here = os.path.dirname(os.path.abspath(__file__))
    default_src = os.path.dirname(here)                   # src/repro_torch

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="lock-discipline lint of the PyTorch port")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any finding not waived inline "
                         "(the gate)")
    ap.add_argument("--root", default=default_src,
                    help="package source tree to analyze "
                         "(default: the repro_torch package)")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print inline-waived findings")
    args = ap.parse_args(argv)

    src_root = os.path.abspath(args.root)
    repo_root = os.path.dirname(os.path.dirname(src_root))
    findings = concurrency.lint_tree(src_root, repo_root)
    failing = [f for f in findings if not f.waived]
    for f in findings:
        if not f.waived or args.show_waived:
            print(f.format())
    print(f"repro_torch.analysis: {len(failing)} failing finding(s), "
          f"{len(findings) - len(failing)} waived")
    return 1 if args.check and failing else 0


if __name__ == "__main__":
    sys.exit(main())
