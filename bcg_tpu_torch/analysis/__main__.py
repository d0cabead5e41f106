"""CLI: ``python -m bcg_tpu_torch.analysis [paths...]``.

Exit status: 0 = no unsuppressed findings and no parse errors; 1
otherwise.  Unused baseline entries are reported on stderr (full-tree
runs only — a partial run never visits most baselined files) but never
affect the exit status; the load-bearing check lives in
``tests/test_torch_analysis.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from bcg_tpu_torch.analysis.core import (
    analyze_paths,
    baseline_path,
    build_program,
    default_paths,
    load_baseline,
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bcg_tpu_torch.analysis",
        description="static checker over the PyTorch port (bcg_tpu_torch)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to analyze (default: the port and chip_smoke.py)",
    )
    parser.add_argument(
        "--baseline", default=None,
        help=f"baseline JSON (default: {baseline_path()})",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="report every finding, ignoring the baseline",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable output",
    )
    parser.add_argument(
        "--show-baselined", action="store_true",
        help="also list findings matched by the baseline",
    )
    parser.add_argument(
        "--locks", action="store_true",
        help="print the thread-root × lock table and lock-acquisition "
             "order edges instead of running the rules",
    )
    args = parser.parse_args(argv)

    if args.locks:
        prog = build_program(args.paths or default_paths())
        print(prog.locks_report())
        return 0

    baseline = [] if args.no_baseline else load_baseline(args.baseline)
    result = analyze_paths(paths=args.paths or default_paths(), baseline=baseline)

    if args.as_json:
        # Every finding carries its disposition so downstream tooling
        # (scripts/lint.py --diff, CI annotators) never has to join the
        # two lists to learn whether an entry is new debt.
        print(json.dumps({
            "files_scanned": result.files_scanned,
            "findings": [
                {**f.__dict__, "status": "new"} for f in result.findings
            ],
            "baselined": [
                {**f.__dict__, "status": "baselined"}
                for f in result.baselined
            ],
            "unused_baseline": [e.__dict__ for e in result.unused_baseline],
            "parse_errors": result.parse_errors,
        }, indent=2))
    else:
        for f in result.findings:
            print(f.format())
        if args.show_baselined:
            for f in result.baselined:
                print(f"[baselined] {f.format()}")
        for err in result.parse_errors:
            print(f"parse error: {err}", file=sys.stderr)
        # A partial run (explicit paths / --diff) never visits most
        # baselined files — "unused" is only meaningful on the full tree.
        if not args.paths:
            for e in result.unused_baseline:
                print(
                    f"unused baseline entry: {e.rule} {e.path} {e.content!r}",
                    file=sys.stderr,
                )
        print(
            f"{result.files_scanned} files, {len(result.findings)} findings "
            f"({len(result.baselined)} baselined)",
            file=sys.stderr,
        )
    if result.findings or result.parse_errors:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
