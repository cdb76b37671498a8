"""Run chosen phases of ``chip_smoke.py`` alone on one NVIDIA card: the
first run of new kernels and phases, without phases 1-23 before them.

    python3 tools/torch_phase_probe.py [STEP ...]

Steps (default: all, in this order): ``25k`` the compaction kernel against
its plain version, ``7`` the merge kernels' cases (float64 ones included),
``24`` the checkpointed join SIGKILLed and restored, ``24h`` a join
snapshot and restore at 100K keys a side, ``25`` config 3 with emission
compaction, ``25j`` config 4 at 100K keys with emission compaction, ``26`` the variance family, ``27`` config 3 in float64, ``28``
the host pipeline, ``29`` phase 21's job over an Avro topic, ``30`` the
CSV job and ``explain(analyze=True)``.  It builds every kernel (printing ptxas' register and
shared-memory lines), makes phase 4's and phase 10's streams from seed 0,
and calls the same ``chip_smoke`` functions as the full script, each
step checked as there.  A failing step is printed with its traceback and
the next one runs; the exit code is 1 if any step failed.  Where a phase
prints its rows/s beside another phase's, the other is not run here and
reads 1.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = ("25k", "7", "24", "24h", "25", "25j", "26", "27", "28", "29", "30")


def main(argv: list[str]) -> int:
    import torch

    import chip_smoke as cs
    from denormalized_tpu_torch.native.build import load as load_native
    from denormalized_tpu_torch.ops import cuda_build
    from denormalized_tpu_torch.ops.interner import native_interner

    if not torch.cuda.is_available():
        print("torch_phase_probe: no CUDA device", file=sys.stderr)
        return 1
    steps = argv or list(STEPS)
    unknown = sorted(set(steps) - set(STEPS))
    if unknown:
        print(f"torch_phase_probe: unknown steps {unknown}", file=sys.stderr)
        return 2
    t0 = time.time()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = cs.card_line()
    cs.log(card)
    load_native("partial_agg")
    native_interner()
    load_native("lsmkv")
    for name, text in cuda_build.build_all().items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                cs.log(f"  nvcc {name}: {line.strip()}")
    cs.log(f"built in {time.time() - t0:.1f} s")
    seed = 0
    stream = cs.gen_stream(cs.TOTAL_ROWS, cs.BATCH_ROWS, cs.NUM_KEYS, seed)
    batches = cs.to_batches(*stream, cs.BATCH_ROWS, cs.NUM_KEYS)
    hs = cs.gen_stream(cs.TOTAL_ROWS, cs.HIGHCARD_BATCH_ROWS,
                       cs.HIGHCARD_KEYS, seed + 4)
    hb = cs.to_batches(*hs, cs.HIGHCARD_BATCH_ROWS, cs.HIGHCARD_KEYS)
    no_rates = {"auto": 1.0, "partial_merge": 1.0, "tumbling": 1.0,
                "highcard": 1.0}

    def side(s, batch_rows, keys):
        st = cs.gen_stream(cs.TOTAL_ROWS, batch_rows, keys, s)
        return cs.to_batches(*st, batch_rows, keys), st

    run = {
        "25k": lambda: cs.phase_compact_kernel(device, seed + 10, card),
        "7": lambda: cs.phase_merge_kernel(device, seed + 3, card),
        "24": lambda: cs.phase_join_ckpt(
            device, seed, (batches, stream),
            side(seed + 1, cs.BATCH_ROWS, cs.NUM_KEYS), card),
        "24h": lambda: cs.phase_join_ckpt_highcard(
            device, (hb, hs),
            side(seed + 6, cs.HIGHCARD_BATCH_ROWS, cs.HIGHCARD_KEYS), card),
        "25": lambda: cs.phase_compact_highcard(device, hb, hs, no_rates,
                                                card),
        "25j": lambda: cs.phase_compact_join(
            device, (hb, hs),
            side(seed + 6, cs.HIGHCARD_BATCH_ROWS, cs.HIGHCARD_KEYS), card),
        "26": lambda: cs.phase_variance(device, batches, stream, card),
        "27": lambda: cs.phase_f64(device, hb, hs, card),
        "28": lambda: cs.phase_host_pipeline(
            device, {"tumbling": (batches, stream, cs.NUM_KEYS),
                     "highcard": (hb, hs, cs.HIGHCARD_KEYS)}, no_rates,
            card),
        "29": lambda: cs.phase_kafka_e2e(device, stream, card, fmt="avro",
                                         phase=29),
        "30": lambda: cs.phase_csv_explain(device, batches, stream, card),
    }
    failed = []
    for step in steps:
        t = time.time()
        try:
            run[step]()
        except Exception as e:  # report it and run the next step
            failed.append(step)
            cs.log(f"STEP {step} FAILED: {e!r}")
            traceback.print_exc(file=sys.stdout)
        cs.log(f"step {step} took {time.time() - t:.1f} s")
    cs.log(f"probe done in {time.time() - t0:.1f} s; failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
