"""CLI: ``python -m tools.torch_lint [root] [options]``.

Exit codes as ``python -m tools.dnzlint``: 0 clean (after pragmas and
the baseline), 1 new findings, 2 a usage or registry error.  The text
and ``--format=json`` reports are that CLI's; ``--fault-site-table``,
``--replay-path-table`` and ``--metric-catalog`` print the port's tables
(``docs/port.md`` embeds them) and exit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from tools import torch_lint
from tools.dnzlint import load_baseline
from tools.dnzlint.__main__ import _report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tools.torch_lint",
        description="tools/dnzlint's passes over the PyTorch/CUDA port "
                    "with its own registries (docs/port.md)")
    ap.add_argument("root", nargs="?", default=str(torch_lint.ROOT),
                    help="package directory to scan (default: "
                         "denormalized_tpu_torch)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (show every finding)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also list findings absorbed by pragmas/baseline")
    ap.add_argument("--report", default=None, metavar="FILE",
                    help="also write the JSON report to FILE")
    ap.add_argument("--fault-site-table", action="store_true",
                    help="print the port's fault-site table and exit")
    ap.add_argument("--replay-path-table", action="store_true",
                    help="print the port's replay-path table and exit")
    ap.add_argument("--metric-catalog", action="store_true",
                    help="print the port's metric-catalog table and exit")
    args = ap.parse_args(argv)

    root = Path(args.root)
    if not root.is_dir():
        print(f"torch_lint: {root} is not a directory", file=sys.stderr)
        return 2
    if args.fault_site_table:
        print(torch_lint.fault_site_table(root))
        return 0
    if args.replay_path_table:
        print(torch_lint.replay_path_table())
        return 0
    if args.metric_catalog:
        print(torch_lint.metric_catalog(root))
        return 0

    t0 = time.perf_counter()
    try:
        new, suppressed, stale = torch_lint.run(
            root, baseline=not args.no_baseline)
    except (ValueError, SyntaxError) as e:
        print(f"torch_lint: {e}", file=sys.stderr)
        return 2
    wall_s = time.perf_counter() - t0
    n_base = (0 if args.no_baseline else
              len(load_baseline(torch_lint.REGISTRIES["baseline_path"])))
    report = _report(new, suppressed, stale, n_base, wall_s, root)
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2) + "\n")
    if args.format == "json":
        print(json.dumps(report, indent=2))
        return 1 if new else 0
    for f in sorted(new, key=lambda f: (f.path, f.line, f.rule)):
        print(f.render())
    if args.show_suppressed:
        for f in sorted(suppressed, key=lambda f: (f.path, f.line, f.rule)):
            print(f"suppressed: {f.render()}")
    for rule, file, symbol in sorted(stale):
        print(f"stale baseline entry: ({rule}, {file}, {symbol}) matched "
              "no finding — delete it", file=sys.stderr)
    print(f"torch_lint: {len(new)} new finding(s), {len(suppressed)} "
          f"suppressed ({n_base} baseline entrie(s), rest pragmas), "
          f"{len(stale)} stale baseline entrie(s) [{wall_s:.1f}s]",
          file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
