"""Run chosen phases of ``chip_smoke.py`` alone on one NVIDIA card: the
first run of new kernels and phases, without phases 1-23 before them.

    python3 tools/torch_phase_probe.py [STEP ...]

Steps (default: all, in this order): ``25k`` the compaction kernel against
its plain version, ``7`` the merge kernels' cases (float64 ones included),
``24`` the checkpointed join SIGKILLed and restored, ``24h`` a join
snapshot and restore at 100K keys a side, ``25`` config 3 with emission
compaction, ``25j`` config 4 at 100K keys with emission compaction, ``26`` the variance family, ``27`` config 3 in float64, ``28``
the host pipeline, ``29`` phase 21's job over an Avro topic, ``30`` the
CSV job, ``explain(analyze=True)`` and the optimizer-off run, ``31``
UDAFs, ``32`` sessions, ``33u``/``33s`` the UDAF and session jobs
SIGKILLed and restored, ``34`` SIGTERM to a live ``print_stream`` child
(over phase 22's chunks, made here at 1M rows/s), ``35`` config 3 under a
48 MiB state budget, ``36`` config 1 under a budget, ``37c`` phase 35's
budgeted job SIGKILLed and restored with and without the budget, ``37j``
config 4 at 100K keys under a budget, ``37h`` the UDAF and session jobs
under a budget, ``38`` the multi-query sweep (Q = 1, 10, 100 shared
against independent device windows, and Q = 10 at config 3's shape),
``39`` query_dense with its control and join_dense (over phase 38's
stream, made here), ``40`` the sketch lanes of approx_scale, ``41`` live
registration across a SIGKILL over Kafka, ``45`` the cluster runtime at
cluster_scale's shape (n = 1, 2, 4 and the single-process run), ``46``
config 3's shape over 4 workers through ``partial_merge``, ``47`` partial
recovery from a SIGKILL and a torn exchange frame, then a full restart
rescaled to n = 2, ``48`` config 1 on 2 and 4 shards of the card
(partial/final, the key-sharded partial merge, two_level at 2 x 2),
``49`` config 3 on 2 and 4 shards (key-sharded, the key-sharded partial
merge with compaction), ``50`` the merge and compaction kernels on a
shard's plane, ``51`` a key-sharded checkpoint at n = 4 restored into
n = 2 and one device, ``52`` ``dryrun_multichip(4, "cuda:0")``, ``53``
the port's soak (``tools/torch_soak.py``: ``simple`` and ``join``),
``54`` the cold tier's soak (``bigstate``), ``55`` the cluster soak.  It builds every kernel (printing ptxas' register and
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
import sysconfig
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = ("25k", "7", "24", "24h", "25", "25j", "26", "27", "28", "29", "30",
         "31", "32", "33u", "33s", "34", "35", "36", "37c", "37j", "37h",
         "38", "39", "40", "41", "45", "46", "47", "48", "49", "50", "51",
         "52", "53", "54", "55")


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
    # the live path's libraries too, as chip_smoke.py's phase 2 builds
    # them, so no step times a g++ build
    load_native("json_parser")
    load_native("kafka_client", ("-lz",))
    load_native("pyassemble", (f"-I{sysconfig.get_paths()['include']}",),
                pydll=True)
    load_native("avro_parser")
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

    def lat_chunks():
        lat = cs.gen_stream(cs.LAT_ROWS, cs.LAT_CHUNK, cs.NUM_KEYS, seed + 7)
        return cs.encode_topic(lat, cs.KAFKA_PARTITIONS, None,
                               cs.LAT_CHUNK), lat

    def mq_feed():
        st = cs.gen_stream(cs.MQ_ROWS, cs.BATCH_ROWS, cs.MQ_KEYS, seed + 14)
        return cs.to_batches(*st, cs.BATCH_ROWS, cs.MQ_KEYS), st

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
        "31": lambda: cs.phase_udaf(device, batches, stream, card),
        "32": lambda: cs.phase_sessions(device, seed + 12, card),
        "33u": lambda: cs.phase_host_ckpt(device, seed, "udaf", card),
        "33s": lambda: cs.phase_host_ckpt(device, seed + 12, "session",
                                          card),
        "34": lambda: cs.phase_sigterm(device, cs.EVENTS_PER_SEC,
                                       *lat_chunks(), card),
        "35": lambda: cs.phase_spill_highcard(device, seed + 13, card),
        "36": lambda: cs.phase_spill_cfg1(device, batches, stream, card),
        "37c": lambda: cs.phase_spill_ckpt(device, seed + 13,
                                           cs.spill_feed(seed + 13), card),
        "37j": lambda: cs.phase_spill_join(
            device, (hb, hs),
            side(seed + 6, cs.HIGHCARD_BATCH_ROWS, cs.HIGHCARD_KEYS), card),
        "37h": lambda: cs.phase_spill_host(device, seed + 12, card),
        "38": lambda: cs.phase_multi_query(device, seed + 14, card),
        "39": lambda: cs.phase_query_dense(device, seed + 14, *mq_feed(),
                                           card),
        "40": lambda: cs.phase_sketches(device, seed + 15, card),
        "41": lambda: cs.phase_live_registration(device, seed + 16, card),
        "45": lambda: cs.phase_cluster_scale(card),
        "46": lambda: cs.phase_cluster_highcard(card),
        "47": lambda: cs.phase_cluster_recovery(card),
        "48": lambda: cs.phase_sharded_cfg1(device, batches, stream,
                                            no_rates, card),
        "49": lambda: cs.phase_sharded_highcard(device, hb, hs, no_rates,
                                                card),
        "50": lambda: cs.phase_shard_kernels(device, seed + 17, hs, card),
        "51": lambda: cs.phase_sharded_ckpt(device, hb, hs, card),
        "52": lambda: cs.phase_sharded_dryrun(device, card),
        "53": lambda: cs.phase_torch_soak(card),
        "54": lambda: cs.phase_bigstate_soak(card),
        "55": lambda: cs.phase_cluster_soak(card),
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
