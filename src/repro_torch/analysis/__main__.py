"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exits 1 on any unsuppressed finding (or unparseable file), 0 otherwise.
``--json`` writes the full machine-readable report (findings,
suppressions, rule catalog, the facts read from the port), with the keys
of ``python -m repro.analysis --json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.core import analyze_paths, default_roots, rule_catalog


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the PyTorch/CUDA port (sharding / "
        "kernels / determinism / step purity)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to analyze (default: src/repro_torch, "
        "chip_smoke.py and tests/{test_torch_*,torch_*}.py, whichever "
        "exist)",
    )
    parser.add_argument(
        "--json", metavar="FILE", dest="json_out",
        help="write the full report as JSON ('-' for stdout)",
    )
    parser.add_argument(
        "--include-fixtures", action="store_true",
        help="also analyze analysis_fixtures directories (the known-bad "
        "corpus)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--exit-zero", action="store_true",
        help="always exit 0 (report-only mode)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(rule_catalog().items()):
            print(f"{rule}: {desc}")
        return 0

    paths = args.paths or default_roots()
    if not paths:
        print("no paths to analyze", file=sys.stderr)
        return 1

    report = analyze_paths(paths, include_fixtures=args.include_fixtures)

    for f in [*report.errors, *report.findings]:
        print(f.format())

    if args.json_out:
        payload = json.dumps(report.to_dict(), indent=2, sort_keys=True)
        if args.json_out == "-":
            print(payload)
        else:
            Path(args.json_out).write_text(payload + "\n")

    n_bad = len(report.findings) + len(report.errors)
    print(
        f"repro_torch.analysis: {report.n_files} files, {n_bad} finding(s), "
        f"{len(report.suppressed)} suppressed "
        f"[axes from {report.facts.source or 'builtin defaults'}, "
        f"{len(report.facts.kernel_entries)} kernel entries]",
        file=sys.stderr,
    )
    if args.exit_zero:
        return 0
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
