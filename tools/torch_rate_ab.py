"""Rows/s of the PyTorch port's main path in two or more checkouts, side by
side on one NVIDIA card, with checkpointing off.

    python3 tools/torch_rate_ab.py --tree A --tree B [--reps 3] [--seed 0]

Each checkout runs in a child process of its own, in the order A, B, B, A
(for three trees A, B, C, C, B, A).  A child imports that checkout's
``chip_smoke.py`` and package, builds its kernels, makes the
emit_measurements stream of chip_smoke phase 4 (8M rows, 131,072-row
batches, 10 keys) from ``--seed``, and runs phase 4's job (``auto``: the
dense kernel on every batch) and phase 8's (``partial_merge``) ``--reps``
times each, every run checked against the numpy oracle by chip_smoke's own
``run_checked``.  The last line is one JSON object: per tree, the rows/s of
every run of each phase in run order, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def child(args) -> None:
    sys.path.insert(0, args.child)
    import torch

    import chip_smoke as cs
    from denormalized_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cuda_build.build_all()
    card = cs.card_line()
    ts, kid, val = cs.gen_stream(cs.TOTAL_ROWS, cs.BATCH_ROWS, cs.NUM_KEYS,
                                 args.seed)
    batches = cs.to_batches(ts, kid, val, cs.BATCH_ROWS, cs.NUM_KEYS)
    out = {"tree": args.child, "card": card, "phase4": [], "phase8": []}
    for _ in range(args.reps):
        for phase, strategy in ((4, "auto"), (8, "partial_merge")):
            r = cs.run_checked(device, phase, "tumbling", strategy, batches,
                               (ts, kid, val), cs.NUM_KEYS, card)
            out[f"phase{phase}"].append(r["rows_per_s"])
    print("RESULT " + json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return 0
    if len(args.tree) < 2:
        ap.error("give at least two --tree checkouts")
    order = args.tree + args.tree[::-1]
    results: dict[str, dict] = {t: {"phase4": [], "phase8": []}
                                for t in args.tree}
    card = None
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(tree),
             "--reps", str(args.reps), "--seed", str(args.seed)],
            cwd=tree, capture_output=True, text=True,
        )
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            print(f"torch_rate_ab: the child in {tree} failed "
                  f"(exit {proc.returncode})", file=sys.stderr)
            return 1
        res = json.loads(next(line[7:] for line in proc.stdout.splitlines()
                              if line.startswith("RESULT ")))
        card = res["card"]
        for phase in ("phase4", "phase8"):
            results[tree][phase] += res[phase]
    print(json.dumps({"card": card, "rows_per_s": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
