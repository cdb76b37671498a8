"""The emission compaction of two or more checkouts of the PyTorch port,
side by side on one NVIDIA card: its kernel's device time, the wrapper's
time and ``read_slot_compact``'s wall.

    python3 tools/torch_compact_ab.py --tree A --tree B [--seed 0]

Each checkout runs in a child process of its own, in the order A, B, B, A
(for three trees A, B, C, C, B, A).  A child imports that checkout's
``chip_smoke.py`` and package, builds its ``csrc/compact_slot.cu``, and
for every case of its ``COMPACT_CASES`` (the seeded rings of chip_smoke
phase 25, G = 131,072) checks ``compact_slot`` against the plain version
bit for bit, then measures:
- ``ms``: the device time of one compaction, every compaction kernel and
  memset of a call summed (torch.profiler, the last 50 of 70 calls), with
  those device operations a call (``ops``);
- ``host_ms``: the wrapper's time a call (chip_smoke's ``time_ms`` over
  200 calls, the median of five such runs);
- ``enqueue_ms``: the host's cost of one call alone, the least over 20
  runs of 50 back-to-back calls on the host clock (a synchronize after
  each run, outside the time), so that other work on the host's cores
  shows less than in ``host_ms``;
- ``parts``: where the checkout's wrapper has the one-arena layout, the
  enqueue time of each of its steps alone (the checks, the current
  stream, the arena, the pointer table, the views, ``_launch`` with all
  but the checks and the stream, and the whole call);
- ``read_ms``: the host wall of one ``segment_agg.read_slot_compact``
  (the kernel, the count, the prefix copies to the host).
The last line is one JSON object: per tree, each case's numbers in run
order, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

KERNEL = "compact_slot_"


def device_ms(cs, fn, n: int = 50, warm: int = 20) -> tuple[float, int]:
    """(device ms a call, device operations a call) from one profiler
    session: the last n calls' compaction kernels and memsets, a call's
    operations counted by distinct name."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(cs.PROFILER_TRIES):
        def run():
            for _ in range(warm + n):
                fn()

        evts = sorted((e for e in cs.device_events(cs.profile(run))
                       if KERNEL in e.name or "memset" in e.name.lower()),
                      key=lambda e: e.time_range.start)
        per_call = len({e.name for e in evts}) or 1
        if len(evts) >= per_call * n:
            last = evts[-per_call * n:]
            return (sum(e.time_range.elapsed_us() for e in last) / n / 1e3,
                    per_call)
    raise AssertionError("the profiler missed the compaction's operations")


def enqueue_ms(fn, calls: int = 50, runs: int = 20) -> float:
    """The least host time a call over ``runs`` runs of ``calls`` calls."""
    import torch

    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t)
    torch.cuda.synchronize()
    return best / calls * 1e3


def wrapper_parts(ck, counts, planes) -> dict:
    """{step: enqueue ms} of the wrapper's steps, or {} for a wrapper
    without ``layout``."""
    import torch

    if not hasattr(ck, "layout"):
        return {}
    dev, G = counts.device, counts.numel()
    lay = ck.layout(tuple(p.dtype for p in planes), G)
    arena = torch.empty(lay.nbytes, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks = min(ck.tiles_of(G), ck._max_blocks(dev.index or 0))
    steps = {
        "check": lambda: ck._check(counts, planes),
        "stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "arena": lambda: ck.alloc_outputs(G, planes, dev),
        "table": lambda: ck.plane_table(planes, lay, arena.data_ptr()),
        "views": lambda: lay.views(arena),
        "launch": lambda: ck._launch(counts, planes, stream, blocks),
        "whole": lambda: ck.compact_slot_groups(counts, planes),
    }
    return {name: enqueue_ms(fn) for name, fn in steps.items()}


def child(args) -> None:
    sys.path.insert(0, args.child)
    import torch

    import chip_smoke as cs
    from denormalized_tpu_torch.ops import compact_slot as ck
    from denormalized_tpu_torch.ops import segment_agg as sa

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = {"tree": args.child, "card": cs.card_line(), "cases": {}}
    for i, (name, (share, accum)) in enumerate(cs.COMPACT_CASES.items()):
        spec, host = cs.compact_case(share, accum, args.seed + 10 + i)
        state = sa.import_state(spec, host, device)
        counts = state["count_star"][1]
        planes = [state[c.label][1] for c in spec.components]
        n, gids, outs = ck.compact_slot(counts, planes)
        rn, rgids, routs = ck.compact_slot_reference(counts, planes)
        k = int(n.item())
        ok = k == int(rn.item()) and torch.equal(gids[:k], rgids) and all(
            torch.equal(o[:k], r) or torch.equal(
                o[:k].view(torch.int64 if o.element_size() == 8
                           else torch.int32),
                r.view(torch.int64 if r.element_size() == 8
                       else torch.int32))
            for o, r in zip(outs, routs))
        if not ok:
            raise AssertionError(f"{args.child} {name}: compact_slot "
                                 f"differs from its plain version")

        def kernel():
            ck.compact_slot(counts, planes)

        ms, per_call = device_ms(cs, kernel)
        for _ in range(5):
            sa.read_slot_compact(spec, state, 1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            sa.read_slot_compact(spec, state, 1)
        read_ms = (time.perf_counter() - t) / 50 * 1e3
        out["cases"][name] = dict(
            active=k, ms=ms, ops=per_call,
            host_ms=statistics.median(cs.time_ms(kernel, device, iters=200)
                                      for _ in range(5)),
            enqueue_ms=enqueue_ms(kernel),
            parts=wrapper_parts(ck, counts, planes), read_ms=read_ms)
    print("RESULT " + json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return 0
    if len(args.tree) < 2:
        ap.error("give at least two --tree checkouts")
    results: dict[str, list] = {t: [] for t in args.tree}
    card = None
    for tree in args.tree + args.tree[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(tree), "--seed", str(args.seed)],
            cwd=tree, capture_output=True, text=True,
        )
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
            print(f"torch_compact_ab: the child in {tree} failed "
                  f"(exit {proc.returncode})", file=sys.stderr)
            return 1
        res = json.loads(next(line[7:] for line in proc.stdout.splitlines()
                              if line.startswith("RESULT ")))
        card = res["card"]
        results[tree].append(res["cases"])
        for name, c in res["cases"].items():
            print(f"{tree} {name}: device {c['ms']:.5f} ms "
                  f"({c['ops']} device operation(s) a call), wrapper "
                  f"{c['host_ms']:.4f} ms (enqueue {c['enqueue_ms']:.4f}), "
                  f"read_slot_compact {c['read_ms']:.4f} ms, steps "
                  f"{ {k: round(v, 4) for k, v in c['parts'].items()} } "
                  f"({card})", flush=True)
    print(json.dumps({"card": card, "trees": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
