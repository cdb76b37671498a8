"""Chip smoke test of the PyTorch/CUDA port (denormalized_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed N]

Phases:
1. the card's name and power limit (nvidia-smi) and the torch/CUDA
   versions;
2. the build of every CUDA kernel of ``denormalized_tpu_torch/csrc/`` from
   the sources in the checkout (one nvcc per source, all started together)
   and, meanwhile, of the two native host libraries (``native/``, g++): the
   partial-aggregation reducer and the interner, whose lane it prints;
3. the fused dense window kernel (``dense_update``) against its plain
   PyTorch version (``dense_update_reference``) on two copies of one seeded
   ring that wraps past W, at B = 131,072: ``main_hot`` (the main path's
   own traffic: 10 live groups, rows in time order over 1-2 slots, no
   nulls), ``main``, ``sliding`` (k = 5) and ``edge`` (G = 2048, V = 2),
   the last three with nulls, NaN behind the null mask, valid NaNs,
   dropped and late rows and out-of-range slots: counts, min and max
   exact, sums to rtol=1e-5.  Each case gives the kernel's device time
   (torch.profiler by kernel name; where the card's tracer misses the
   launches in three sessions, CUDA event pairs around launches queued
   behind a device spin, and the line says which), the wrapper's time a
   call (``host_ms``), the plain version's time and the bound from the
   case's own data;
4. the main path end to end: the emit_measurements stream (8M rows,
   131,072-row batches, 10 keys, event time at 1M events/s, made from
   --seed with numpy) through Context(EngineConfig(device="cuda",
   device_strategy="auto")) in a 1 s tumbling count/min/max/avg by
   sensor_name, checked against a numpy float64 oracle, with every batch
   on the dense kernel; then the same job again with torch.profiler over
   batches 10-29: the device's busy and idle share, the top device and
   host ops, and kernel launches per batch (one dense kernel a batch; the
   stretch is run again, up to three times, where the tracer misses
   launches);
5. the sliding job (1 s window, 200 ms slide, count+avg, filter avg > 45)
   over ~2M rows, the same way;
6. the scatter path (``segment_agg.update_state``) on the card against the
   CPU on one batch with valid NaNs in several cells;
7. the stripe-fold kernels (``merge_partials``) against their plain version
   (``merge_partials_reference``) on seeded rings and seeded stripes packed
   by the port's own ``HostPartialStripe``: ``cfg1_dense`` (the config-1
   stripe: G = 128, 10 live groups, 1-2 units, dense, lean), ``sliding_k5``
   (1 s / 200 ms, valid NaNs, NaNs already in the ring), ``ragged_compact``
   (500 ms / 200 ms: SUB = 2, k = 3; the compact layout with nulls,
   compensated), ``ragged_dense`` (the same fan-out, dense, with nulls),
   ``cfg3_compact`` (100K live groups over 2 units at config 3's G, where
   the stripe packs compact), ``cfg3_dense`` (the same groups in a
   131,072-wide ring, where it packs dense) and ``cfg3_shard`` (one shard
   of a key-sharded ring: a stripe over G_total = 2 x 131,072 groups, the
   ring holding the upper half, g_shift = 131,072): counts, min and max
   exact, sums to rtol=1e-5.  Each case prints the kernel it takes
   (tumbling, gather or scatter), requires two launches on identical rings
   to leave bit-identical rings where the kernel has no atomics, and says
   whether those rings equal the plain version's on the CPU bit for bit;
   device time (as in phase 3), wrapper time, plain time and bound;
8. config 1 (the phase-4 stream) through ``device_strategy="partial_merge"``
   against the numpy oracle: rows/s, host prep, merges, kernel launches
   (equal to the merges), bytes to the card, and the native reducer's and
   interner's counters (no batch on the numpy reducer);
9. config 2 (the phase-5 stream) through ``partial_merge`` the same way;
10. config 3 (bench.py ``highcard``: 100K keys, sum and avg, 524,288-row
    batches, 8M rows) through ``partial_merge`` and through ``auto`` (row
    shipping, the scatter path at this G) on the same seeded stream, both
    against the numpy oracle, with their rows/s side by side;
11. config 5 (checkpoint and restore) on config 1's stream: this script
    re-invoked as a child (private ``--ckpt-*`` flags) runs the phase-4
    job checkpointed to a fresh store with a barrier every 8 batches,
    commits two epochs and is SIGKILLed with more than a third of the
    stream unread; a second child restores on the same store (the ring
    onto the card) and runs to the end.  The union of both children's
    rows against the oracle; the restart's reads, its dense launches on
    the restored ring and its time to recover; then one uninterrupted
    checkpointed run beside phase 4's rows/s;
12. config 5 at config 3's state size (100K keys, ``partial_merge``): a
    crash after a committed epoch and a restore onto the card, held
    against the oracle, with each step of a snapshot timed (clone, copy to
    the host, host wait, pack, frame + CRC + put, fsync, commit, restore)
    and a profile showing the copy to the host on a stream other than the
    kernels';
13. the snapshot race: 50 rounds of ``export_start`` on a seeded ring, 20
    dense updates and 20 merge folds queued at once, ``export_finish`` —
    every snapshot bit-identical to the synchronous export before it.
14. config 4 (bench.py ``join``): phase 4's stream and one made from
    --seed + 1, each through a window (avg(reading) by sensor_name, 1 s
    tumbling, ``auto``: the dense kernel every batch, the two windows on two
    pump threads), the right side renamed to hs/hws/hwe, an inner join on
    (sensor_name, window_start_time) = (hs, hws), checked against the numpy
    oracle: rows/s over both streams beside phase 4's, the dense launches of
    each window (61 each, 122 in all), the join's rows and its build, probe,
    gather and queue-wait times; then the same run under torch.profiler:
    the device's busy share and whether the two sides' kernels overlapped;
15. config 4 at config 3's key count: phase 10's stream and one made from
    --seed + 6 (100K keys a side, 524,288-row batches), through ``auto``
    (the scatter path at this G) and ``partial_merge``, each against the
    oracle, with the join's resident rows and bytes at the end and the
    adaptation policy's counts;
16. config 4 as ``examples/stream_join.py --expressions`` writes it, over
    phase 14's two streams through ``auto``: ``join_on`` with
    upper(sensor_name) == upper(humidity_sensor) (hidden key columns
    computed after each window), the window starts equal and the residual
    average_humidity > average_temperature - 100, against the oracle
    after the residual (no hidden column may reach the output): rows/s
    beside phase 14's, the join's stage times, the dense launches (122)
    and the host time of ``upper``;
17. the same query at config 3's key count over phase 15's streams
    (``auto``): rows/s beside phase 15's and ``upper``'s time over ~100K
    window rows a side;
18. bench.py's ``join_skew`` shape, uncut: a zipf(1.2) side (10,000 keys)
    band-joined (±50 ms) against a mostly-uniform side with a 0.0004 share
    of the hottest key, 500,000 rows a side in 8,192-row batches, once
    adaptive and once static: the same rows in both runs, as many pairs as
    a numpy searchsorted oracle counts, adaptations > 0 in the adaptive
    run, and both rows/s with their ratio (host code on the card's host);
19. the projection half of ``examples/functions_tour.py`` over phase 4's
    first 15 batches: lower(replace(...)), a three-branch CASE,
    date_trunc and a length filter feeding the dense window grouped by
    (sensor, band), against the oracle: rows/s, host prep, and the host
    time of each string map and of CASE;
20. ``Expr.eval_torch`` on the card: sqrt(abs), round (half away from
    zero), a three-branch CASE, casts, isnan and nanvl over 1M seeded
    float32 / int64 rows, each result on the card and equal to the host
    ``eval`` (rtol=1e-6 for sqrt, exact for the rest), with its time;
21. bench.py's ``kafka_e2e`` through the port's live path: phase 4's
    stream JSON-encoded (readings to 6 decimals, as bench.py writes them)
    into a 4-partition topic of the port's own mock broker
    (``testing/mock_kafka.py``), interleaved by partition, then
    ``from_topic`` → the dense window with
    ``source_idle_timeout_ms=1000``, after a warm-up on a broker of its
    own: the native wire client and JSON parser, four prefetch workers,
    per-partition and idle watermarks.  Every closable window against the
    oracle; late rows 0; no Python-decoded or salvaged row; dense launches
    = the window's batches: rows/s, wall, batch sizes, host prep, decode
    and fetch seconds, supervised restarts;
22. BASELINE's window latency: a paced producer thread feeds 24 windows
    of event time to a fresh topic at min(1M, 0.6 x phase 21's rows/s)
    rows a second (bench.py's rule; each 8,192-row chunk at the wall time
    of its last event), and a window's latency is its emission's wall
    minus the wall of its close: p50, p99, max over 22 samples;
23. config 5 over Kafka: the first 6 s of phase 22's stream fed at its
    pace; a checkpointed child (the script re-invoked with private
    ``--kafka-*`` flags) is SIGKILLed after an epoch committed past its
    second window, and a second child restores the store and runs until
    the union of both children's rows covers every closable window: the
    union against the oracle, no full reprocess, the time to recover;
24. configs 4 and 5 together: phase 14's join in a child (the script
    re-invoked with private ``--join-*`` flags), checkpointed every 8 left
    batches, SIGKILLed after two committed epochs with more than a third
    of both streams unread; a second child restores (both windows' rings
    onto the card, the join's retained rows re-interned) and runs to the
    end.  The union of both children's joined rows against phase 14's
    oracle, the time to recover, the join snapshot's bytes, pack, put and
    commit ms; then one snapshot and restore of the join's state at phase
    15's 100K keys a side, in this process, timed;
25. the compaction kernel (``compact_slot``, ``csrc/compact_slot.cu``, one
    single-pass launch with decoupled look-back) against its plain version
    (``compact_slot_reference``) on seeded rings at G = 131,072 with 0,
    0.1%, 10%, 76% (100K cells, config 3's shape; also on a float64 ring)
    and 100% of the cells active, five planes with nulls and NaNs: exact,
    one launch a call by the profiler's kernel names, with device time,
    wrapper time, ``read_slot_compact``'s wall, bound and the library
    sequence's time (nonzero + index_select a plane); then config
    3 with ``emission_compaction=True`` through ``auto`` and
    ``partial_merge`` against the oracle, beside phase 10's rows/s, the
    kernel's launches equal to the windows emitted; then config 4 at
    config 3's key count (phase 15's streams) with compaction, where both
    windows emit from their own threads, against the oracle, launches
    equal to both windows' emissions;
26. the variance family: phase 4's job with stddev, stddev_pop, var and
    var_pop of ``reading`` through ``auto`` and ``partial_merge``, against
    a numpy float64 oracle at rtol=1e-3 (counts, min and max exact; dense
    launches = batches, merge launches = merges), then values ~1.7e12 with
    sigma 1000, the stddev within 800-1200;
27. float64: phase 7 carries three float64 cases (``cfg3_f64``, the
    scatter kernel's ``ragged_compact_f64`` and the gather kernel's
    ``sliding_k5_f64``, sums to rtol=1e-12); config 3 with
    ``accum_dtype=torch.float64`` through ``auto`` (scatter) and
    ``partial_merge`` (the merge kernel's f64 instantiation, launches
    counted), sums and averages at rtol=1e-10 of the float64 oracle, and
    the same stream in float32 shown to miss that bound;
28. the host pipeline and asynchronous emission: configs 1 and 3 through
    ``partial_merge`` with ``host_pipeline=True`` and the card's default
    emit lag against the oracle, beside phases 8 and 10, with the emission
    blocks drained a trigger later counted and every merge (the worker
    thread's included) launched on the main thread's stream;
29. phase 21 over Avro: phase 4's stream as ``Measurement`` Avro records
    (tests/test_kafka.py's record, encoded with numpy: zigzag varints,
    length-prefixed names, the union branch before each float64 reading)
    in 4 partitions, ``from_topic(encoding="avro", avro_schema=...)`` →
    the config-1 window through the native Avro parser: every closable
    window against the oracle, late rows 0, no Python-decoded row, dense
    launches = window batches; rows/s beside phase 21's;
30. examples/csv_streaming.py's job through the port's ``CsvSource`` over
    a CSV of phase 4's first 15 batches against the oracle (dense launches
    = window batches); ``explain(analyze=True)`` of config 1 on the card
    with checkpointing set through ``EngineConfig.set`` (the analyzed plan
    carries the window's device steps, every one a dense launch; no epoch
    committed: a checkpointed run after it restores nothing).

Then one JSON line with each kernel's launches on its main path (phase 4
for the dense kernel, phase 8 for the merge kernel, phase 25's config 3
run for the compaction kernel, phase 27's for the f64 merge, each counted
from 0 just before the run; for the dense kernel also its launches on
phase 11's restored ring, both windows' launches under phase 14's join and
phase 16's join_on, phase 19's window, phase 21's Kafka job, phase 29's
Avro topic and phase 30's analyze run), its
largest error against the plain version, its device time, the wrapper's
time, the plain version's time, the library call's (for the compaction
kernel the nonzero + index_select sequence) and the least time the card
could take (for the merge kernels also each phase-7 case's kernel, times,
bound and bit-identity, under ``cases``), and as the last line
``{"ok": true, "device": {...}}``.
Any failure ends the run with a non-zero exit and no result.  Without CUDA
it exits 1 at once.
"""

from __future__ import annotations

import time

T_START = time.time()  # phase 11 times a child's restart from here

import argparse
import contextlib
import json
import subprocess
import sys
import threading

import numpy as np
import torch

# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

EVENT_T0 = 1_700_000_000_000
EVENTS_PER_SEC = 1_000_000
TOTAL_ROWS = 8_000_000
BATCH_ROWS = 131_072
NUM_KEYS = 10
SLIDING_ROWS = 2_000_000
# config 3 (bench.py highcard)
HIGHCARD_KEYS = 100_000
HIGHCARD_BATCH_ROWS = 524_288


def log(msg: str) -> None:
    print(msg, flush=True)


# -- data ------------------------------------------------------------------


def gen_stream(total_rows: int, batch_rows: int, num_keys: int, seed: int):
    """The emit_measurements stream as bench.py's ``gen_batches`` makes it:
    per batch, sorted event times over the batch's share of event time at
    1M events/s, uniformly drawn sensor names, normal(50, 10) readings.
    → (ts int64, key index int64, reading float64) arrays over the whole
    stream."""
    rng = np.random.default_rng(seed)
    n_batches = total_rows // batch_rows
    ms_per_batch = max(1, int(batch_rows / EVENTS_PER_SEC * 1000))
    ts, kid, val = [], [], []
    for b in range(n_batches):
        base = EVENT_T0 + b * ms_per_batch
        ts.append(np.sort(base + rng.integers(0, ms_per_batch, batch_rows)))
        kid.append(rng.integers(0, num_keys, batch_rows))
        val.append(rng.normal(50.0, 10.0, batch_rows))
    return np.concatenate(ts), np.concatenate(kid), np.concatenate(val)


def to_batches(ts, kid, val, batch_rows: int, num_keys: int):
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema

    schema = Schema(
        [
            Field("occurred_at_ms", DataType.INT64, nullable=False),
            Field("sensor_name", DataType.STRING, nullable=False),
            Field("reading", DataType.FLOAT64),
        ]
    )
    keys = np.array([f"sensor_{i}" for i in range(num_keys)], dtype=object)
    return [
        RecordBatch(
            schema,
            [ts[i : i + batch_rows], keys[kid[i : i + batch_rows]],
             val[i : i + batch_rows]],
        )
        for i in range(0, len(ts), batch_rows)
    ]


# -- helpers ---------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, device, iters: int = 20) -> float:
    """Mean time a call of ``iters`` back-to-back calls of ``fn()``, by
    CUDA events, after two warm-up runs: the device's time where the device
    is the slower side, the host's cost a call where the host is (as for a
    short kernel behind its Python wrapper)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def window_exec_of(ctx):
    from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec

    node = ctx._last_physical
    while not isinstance(node, StreamingWindowExec):
        (node,) = node.children
    return node


# -- profiler helpers ------------------------------------------------------


def device_events(prof):
    """The device-side events (kernels, copies, fills) of a profile."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda]


def profile(fn):
    """Run ``fn()`` under torch.profiler (CPU and CUDA activities), ending
    in a synchronize → the profile."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    with prof_ctx(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


PROFILER_TRIES = 3


def profiled_launches(fn, kernel: str, n: int, warm: int):
    """The device events of ``kernel`` that the profiler records over
    ``warm + n`` calls of ``fn()``, in launch order.  Raises if it records
    more than ``warm + n`` (a call launched the kernel more than once)."""

    def run():
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        for _ in range(n):
            fn()

    evts = sorted((e for e in device_events(profile(run)) if kernel in e.name),
                  key=lambda e: e.time_range.start)
    if len(evts) > warm + n:
        raise AssertionError(
            f"the profiler recorded {len(evts)} {kernel} launches for "
            f"{warm + n} calls: a call launched the kernel more than once"
        )
    return evts


def queued_event_ms(fn, n: int) -> float:
    """Device time of one call of ``fn()`` by CUDA events, apart from the
    host's cost: ``n`` calls between two events, queued behind a device
    spin that outlasts their enqueue so that the card runs them back to
    back → the events' time over ``n``.  Raises if the host was still
    enqueueing when the spin ended."""
    spin = 1 << 20
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(spin)
    ev[1].record()
    torch.cuda.synchronize()
    spin_ms_per_cycle = ev[0].elapsed_time(ev[1]) / spin
    enqueue_ms = 1.0
    for _ in range(2):  # the first pass sizes the spin for the second
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(int(4 * enqueue_ms / spin_ms_per_cycle))
        ev[1].record()
        for _ in range(n):
            fn()
        ev[2].record()
        enqueue_ms = max((time.perf_counter() - t0) * 1e3, 1.0)
        torch.cuda.synchronize()
    spun_ms = ev[0].elapsed_time(ev[1])
    if enqueue_ms >= spun_ms:
        raise AssertionError(
            f"the {n} calls took {enqueue_ms:.3f} ms to enqueue, longer than "
            f"the {spun_ms:.3f} ms spin before them: their time would hold "
            f"the host's cost"
        )
    return ev[1].elapsed_time(ev[2]) / n


def kernel_device_ms(fn, kernel: str, n: int = 50, warm: int = 5):
    """Device time of the one ``kernel`` launch ``fn()`` makes, apart from
    the wrapper's host cost → (ms, how).  By the profiler: its mean over
    the last ``n`` of ``warm + n`` profiled launches by kernel name (the
    tracer may miss a launch as it starts).  The card's tracer sometimes
    records none of a session's launches; after ``PROFILER_TRIES`` sessions
    short of ``n`` the time is taken by ``queued_event_ms`` instead, and
    ``how`` says which."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        evts = profiled_launches(fn, kernel, n, warm)
        if len(evts) >= n:
            ms = sum(e.time_range.elapsed_us() for e in evts[-n:]) / n / 1e3
            return ms, "profiler"
        log(f"the profiler recorded {len(evts)} {kernel} launches of "
            f"{warm + n}, fewer than the {n} timed")
    return queued_event_ms(fn, n), "CUDA events"


# -- phase 3: the dense window kernel against its plain version ----------------

DENSE_KERNEL = "dense_window_update_kernel"
MAIN_AGGS = [("count", 0), ("min", 0), ("max", 0), ("avg", 0)]


def seeded_ring(spec, rng):
    """Host planes of a ring already holding readings like the batch's:
    0-4 rows a cell, their sums, and min/max where a cell has rows (the
    identities elsewhere).  Sums stay positive, as sums of these readings
    are: a relative tolerance is meaningless on a sum that cancels to
    near zero."""
    W, G = spec.window_slots, spec.group_capacity
    counts = rng.integers(0, 5, (W, G)).astype(np.int32)
    host = {}
    for c in spec.components:
        if c.kind == "count":
            host[c.label] = counts
        elif c.kind == "sum":
            host[c.label] = (counts * rng.normal(50, 10, (W, G))).astype(
                np.float32)
        elif c.kind == "sumc":  # the low half of a compensated sum
            host[c.label] = rng.normal(0, 1e-4, (W, G)).astype(np.float32)
        else:
            fill = np.inf if c.kind == "min" else -np.inf
            host[c.label] = np.where(
                counts > 0, rng.normal(50, 10, (W, G)), fill
            ).astype(np.float32)
    return host


def dense_case(name: str, seed: int):
    """One phase-3 case at the main path's B = 131,072 → (spec, host ring,
    host batch (values, colvalid, win_rel, rem, gid, row_valid), base_mod,
    min_win_rel).  Every ring wraps past W: its rows start near W - 1.

    - main_hot: the main path's own traffic, as phase 4 feeds it: G = 128
      with 10 live groups, rows in time order over 131 ms that cross one
      window boundary (1-2 ring slots), no nulls;
    - main, sliding (k = 5), edge (G = 2048, V = 2): rows spread over
      ~12 slots with nulls, NaN behind the null mask, valid NaNs, dropped
      and late rows, slots below min_win_rel or K_ACTIVE past it, and NaNs
      already in the ring."""
    from denormalized_tpu_torch.ops import segment_agg as sa

    rng = np.random.default_rng(seed)
    B, W = BATCH_ROWS, 16
    G, V, slide, lo, base_mod = {
        "main_hot": (128, 1, 1000, 3, 12),
        "main": (128, 1, 1000, 1, 13),
        "sliding": (128, 1, 200, 2, 10),
        "edge": (2048, 2, 1000, 0, 11),
    }[name]
    aggs = MAIN_AGGS + ([("min", 1), ("max", 1), ("avg", 1)] if V > 1 else [])
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(aggs)), num_value_cols=V,
        window_slots=W, group_capacity=G, length_ms=1000, slide_ms=slide,
    )
    values = rng.normal(50.0, 10.0, (B, V)).astype(np.float32)
    if name == "main_hot":
        ms = 900 + np.sort(rng.integers(0, 131, B))
        win_rel = (lo + ms // slide).astype(np.int32)
        rem = (ms % slide).astype(np.int32)
        gid = rng.integers(0, 10, B).astype(np.int32)
        colvalid = np.ones((B, V), bool)
        row_valid = np.ones(B, bool)
    else:
        win_rel = rng.integers(-1, 13, B).astype(np.int32)
        rem = rng.integers(0, slide, B).astype(np.int32)
        gid = rng.integers(0, G, B).astype(np.int32)
        colvalid = rng.random((B, V)) > 0.1
        values[~colvalid & (rng.random((B, V)) < 0.5)] = np.nan
        nan_rows = rng.integers(0, B, 4)
        values[nan_rows, 0], colvalid[nan_rows, 0] = np.nan, True
        win_rel[nan_rows] = lo + 1
        row_valid = rng.random(B) > 0.05
        row_valid[nan_rows] = True
    host = seeded_ring(spec, rng)
    if name != "main_hot":
        # NaNs already in the ring, in rows the batch folds into: they stay
        slots = (base_mod + lo + rng.integers(0, 8, 8)) % W
        for label in ("min_0", "max_0"):
            host[label][slots, rng.integers(0, G, 8)] = np.nan
    batch = (values, colvalid, win_rel, rem, gid, row_valid)
    return spec, host, batch, base_mod, lo


def compare_rings(spec, got, want, what: str) -> float:
    """Counts, min and max exact (NaN where NaN); sums to rtol=1e-5 (float
    atomics reorder them; rtol=1e-12 in a float64 ring), a compensated sum
    as hi + lo.  → largest absolute error over finite sums."""
    rtol = 1e-12 if spec.accum_dtype == torch.float64 else 1e-5
    worst = 0.0
    labels = {c.label for c in spec.components}
    for c in spec.components:
        if c.kind == "sumc":
            continue  # compared with its hi below
        a = got[c.label].cpu().numpy()
        b = want[c.label].cpu().numpy()
        lo = f"sumc_{c.col}"
        if c.kind == "sum" and lo in labels:
            a = a.astype(np.float64) + got[lo].cpu().numpy()
            b = b.astype(np.float64) + want[lo].cpu().numpy()
        if c.kind == "sum":
            np.testing.assert_allclose(a, b, rtol=rtol,
                                       err_msg=f"{what}: {c.label}")
            fin = np.isfinite(a) & np.isfinite(b)
            if fin.any():
                worst = max(worst, float(np.abs(a[fin] - b[fin]).max()))
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {c.label}")
    return worst


def fused_bound(spec, batch, min_win_rel: int):
    """Least time for one fused dense update on this batch's data: the
    bytes over the HBM rate or the updates over the f32 rate, whichever is
    longer.  Bytes: the batch read once, B·(5V + 9) (values f32, colvalid
    and row_valid u8, win_rel and gid int32), plus B·4 of rem where some
    fan-out needs it (L % S ≠ 0), plus every component of each (slot,
    group) cell the batch's rows land in, read and written once (4 B
    each way).  Updates: per counted (row, fan-out) a row count, then a
    count, sum, min and max per value column.  → (ms, what bounds it)."""
    from denormalized_tpu_torch.ops.dense_window import K_ACTIVE

    values, _colvalid, win_rel, rem, gid, row_valid = batch
    B, V = values.shape
    L, S, W, G = (spec.length_ms, spec.slide_ms, spec.window_slots,
                  spec.group_capacity)
    k = spec.length_units
    need_rem = L - (k - 1) * S < S
    cells, counted = [], 0
    for i in range(k):
        wr = win_rel.astype(np.int64) - i
        j = wr - min_win_rel
        ok = (row_valid & (wr >= 0) & (wr < W) & (gid >= 0) & (gid < G)
              & (j >= 0) & (j < K_ACTIVE))
        if L - i * S < S:
            ok &= rem < L - i * S
        counted += int(ok.sum())
        cells.append(j[ok] * G + gid[ok])
    n_cells = len(np.unique(np.concatenate(cells)))
    nbytes = (B * (5 * V + 9) + (4 * B if need_rem else 0)
              + 8 * n_cells * len(spec.components))
    ops = counted * (1 + 4 * V)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(device, seed: int):
    """→ {case: {ms, host_ms, plain_ms, max_abs_err, bound_ms,
    bound_by}}."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import segment_agg as sa

    out = {}
    for i, name in enumerate(("main_hot", "main", "sliding", "edge")):
        spec, host, batch, base_mod, lo = dense_case(name, seed + i)
        args = [torch.from_numpy(a).to(device) for a in batch]
        B, V = batch[0].shape
        got = sa.import_state(spec, host, device)
        want = sa.import_state(spec, host, device)
        before = dw.dense_window_launches
        dw.dense_update(spec, got, *args, base_mod, min_win_rel=lo)
        torch.cuda.synchronize(device)
        launched = dw.dense_window_launches - before
        if launched != 1:
            raise AssertionError(f"{name}: {launched} kernel launches, not 1")
        dw.dense_update_reference(spec, want, *args, base_mod, min_win_rel=lo)
        err = compare_rings(spec, got, want, name)

        scratch = sa.import_state(spec, host, device)

        def kernel():
            dw.dense_update(spec, scratch, *args, base_mod, min_win_rel=lo)

        def plain():
            dw.dense_update_reference(spec, scratch, *args, base_mod,
                                      min_win_rel=lo)

        ms, ms_by = kernel_device_ms(kernel, DENSE_KERNEL)
        host_ms = time_ms(kernel, device, iters=200)
        plain_ms = time_ms(plain, device)
        bound_ms, bound_by = fused_bound(spec, batch, lo)
        out[name] = dict(ms=ms, ms_by=ms_by, host_ms=host_ms,
                         plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by)
        g_tile = dw.group_tile(spec.group_capacity, V)
        resident = dw._resident_blocks(device.index, V, g_tile)
        log(f"phase 3 kernel {name} B={B} G={spec.group_capacity} V={V} "
            f"k={spec.length_units} (group tile {g_tile}, {resident} blocks "
            f"resident on the card): ring matches the plain version "
            f"(max_abs_err={err:.3g}), device {ms:.5f} ms ({ms_by}), "
            f"host_ms {host_ms:.4f}, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}), launches {launched}")
    return out


# -- phases 4 and 5: the port end to end ------------------------------------


_ORACLES: dict = {}


def oracle(ts, kid, val, length_ms, slide_ms, num_keys):
    """numpy float64 oracle: {(window_start, key index): (count, min, max,
    avg)} over every window a row falls in; min/max over the f32-rounded
    readings (what the ring holds).  Kept per stream and window shape (the
    stream's arrays are held with it, so their ids stay theirs)."""
    key = (id(ts), id(kid), id(val), length_ms, slide_ms, num_keys)
    hit = _ORACLES.get(key)
    if hit is None:
        hit = _ORACLES[key] = ((ts, kid, val), _oracle(
            ts, kid, val, length_ms, slide_ms, num_keys))
    return hit[1]


def _oracle(ts, kid, val, length_ms, slide_ms, num_keys):
    k = -(-length_ms // slide_ms)
    units = ts // slide_ms
    rem = ts - units * slide_ms
    v32 = val.astype(np.float32).astype(np.float64)
    codes, vals, vals32 = [], [], []
    for i in range(k):
        ok = rem < length_ms - i * slide_ms
        codes.append((units[ok] - i) * num_keys + kid[ok])
        vals.append(val[ok])
        vals32.append(v32[ok])
    code = np.concatenate(codes)
    v = np.concatenate(vals)
    v32 = np.concatenate(vals32)
    order = np.argsort(code, kind="stable")
    code, v, v32 = code[order], v[order], v32[order]
    starts = np.flatnonzero(np.r_[True, code[1:] != code[:-1]])
    cnt = np.diff(np.r_[starts, len(code)])
    out = {}
    for c, n, s, mn, mx in zip(
        code[starts].tolist(), cnt.tolist(),
        np.add.reduceat(v, starts).tolist(),
        np.minimum.reduceat(v32, starts).tolist(),
        np.maximum.reduceat(v32, starts).tolist(),
    ):
        j, key = divmod(c, num_keys)
        out[(j * slide_ms, key)] = (n, mn, mx, s / n)
    return out


def job_stream(device, batches, job: str, on_read=None, strategy="auto",
               **cfg):
    """The ``tumbling``, ``sliding`` or ``highcard`` job over ``batches``
    through ``device_strategy=strategy``, not yet run → (ctx, DataStream).
    ``on_read(ctx, i)``, where given, runs before batch i is read."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device),
                                     device_strategy=strategy, **cfg))
    if on_read is None:
        source = MemorySource.from_batches(
            batches, timestamp_column="occurred_at_ms")
    else:
        source = hooked_source(batches, lambda i: on_read(ctx, i))
    src = ctx.from_source(source)
    col = tt.col
    if job == "highcard":
        ds = src.window(
            ["sensor_name"],
            [F.sum(col("reading")).alias("sum"),
             F.avg(col("reading")).alias("avg")],
            1000,
        )
    elif job == "sliding":
        ds = src.window(
            ["sensor_name"],
            [F.count(col("reading")).alias("cnt"),
             F.avg(col("reading")).alias("avg")],
            1000, 200,
        ).filter(col("avg") > 45.0)
    else:
        ds = src.window(
            ["sensor_name"],
            [F.count(col("reading")).alias("count"),
             F.min(col("reading")).alias("min"),
             F.max(col("reading")).alias("max"),
             F.avg(col("reading")).alias("average")],
            1000,
        )
    return ctx, ds


def run_job(device, batches, job: str, on_read=None, strategy="auto", **cfg):
    """Run :func:`job_stream`'s job to its end → (ctx, result, wall s)."""
    ctx, ds = job_stream(device, batches, job, on_read, strategy, **cfg)
    t0 = time.perf_counter()
    res = ds.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return ctx, res, wall


def check_dispatch(ctx, n_batches: int, what: str):
    backend = window_exec_of(ctx).backend
    if backend.dense_updates != n_batches or backend.scatter_updates != 0:
        raise AssertionError(
            f"{what}: dense_updates={backend.dense_updates}, "
            f"scatter_updates={backend.scatter_updates}, batches={n_batches}"
        )


def tumbling_rows(res) -> dict:
    """{(window_start, key index): (count, min, max, avg)} of the
    tumbling job's emitted rows."""
    return {
        (ws, int(name[7:])): (c, mn, mx, a)  # "sensor_<i>"
        for ws, name, c, mn, mx, a in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor_name").tolist(),
            res.column("count").tolist(), res.column("min").tolist(),
            res.column("max").tolist(), res.column("average").tolist(),
        )
    }


def check_tumbling(res, exp, num_keys):
    return check_tumbling_rows(tumbling_rows(res), exp)


def check_tumbling_rows(got, exp):
    """The same row set as the oracle; counts, min and max exact, avg to
    rtol=1e-4."""
    if set(got) != set(exp):
        raise AssertionError(
            f"row sets differ: {len(got)} emitted vs {len(exp)} expected"
        )
    for k, (c, mn, mx, a) in exp.items():
        gc, gmn, gmx, ga = got[k]
        if (gc, gmn, gmx) != (c, mn, mx):
            raise AssertionError(f"{k}: got {got[k]}, expected {exp[k]}")
        if not np.isclose(ga, a, rtol=1e-4, atol=0):
            raise AssertionError(f"{k}: avg {ga} vs oracle {a}")
    return len(got)


def check_sliding(res, exp, num_keys):
    keys = {f"sensor_{i}": i for i in range(num_keys)}
    got = {
        (ws, keys[name]): (c, a)
        for ws, name, c, a in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor_name").tolist(),
            res.column("cnt").tolist(), res.column("avg").tolist(),
        )
    }
    for k, (c, _mn, _mx, a) in exp.items():
        # a window whose f64 average sits within the f32 tolerance of the
        # filter threshold may fall either side of it
        borderline = np.isclose(a, 45.0, rtol=1e-4, atol=0)
        if k in got:
            gc, ga = got[k]
            if gc != c or not np.isclose(ga, a, rtol=1e-4, atol=0):
                raise AssertionError(f"{k}: got {got[k]}, expected {(c, a)}")
        elif a > 45.0 and not borderline:
            raise AssertionError(f"{k}: missing (avg {a} > 45)")
    extra = [k for k in got if k not in exp or not (
        exp[k][3] > 45.0 or np.isclose(exp[k][3], 45.0, rtol=1e-4, atol=0)
    )]
    if extra:
        raise AssertionError(f"unexpected rows {extra[:5]}")
    return len(got)


def highcard_rows(res) -> dict:
    """{(window_start, key index): (sum, avg)} of config 3's rows."""
    return {
        (ws, int(name[7:])): (sm, a)  # "sensor_<i>"
        for ws, name, sm, a in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor_name").tolist(),
            res.column("sum").tolist(), res.column("avg").tolist(),
        )
    }


def check_highcard(res, exp, num_keys):
    return check_highcard_rows(highcard_rows(res), exp)


def check_highcard_rows(got, exp):
    """Config 3's rows: the same row set as the oracle, sum and avg to
    rtol=1e-4 (f32 sums on the card)."""
    if set(got) != set(exp):
        raise AssertionError(
            f"row sets differ: {len(got)} emitted vs {len(exp)} expected"
        )
    keys = list(exp)
    assert_close_rows(keys, [got[k] for k in keys],
                      [(exp[k][3] * exp[k][0], exp[k][3]) for k in keys])
    return len(got)


def assert_close_rows(keys, got, want, rtol=1e-4) -> None:
    """Row i of ``got`` within ``rtol`` of row i of ``want``, every column
    (one vectorized comparison; raises naming the first row that is
    not)."""
    g = np.asarray(got, dtype=np.float64)
    w = np.asarray(want, dtype=np.float64)
    ok = np.isclose(g, w, rtol=rtol, atol=0).all(axis=1)
    if not ok.all():
        i = int(np.flatnonzero(~ok)[0])
        raise AssertionError(f"{keys[i]}: got {tuple(g[i])}, expected "
                             f"{tuple(w[i])}")


JOB_NAMES = {"tumbling": "tumbling 1s", "sliding": "sliding 1s/200ms",
             "highcard": "highcard 1s, 100K keys"}


def run_checked(device, phase, job, strategy, batches, stream, num_keys,
                card, **cfg):
    """Run one job with every kernel count set to 0 just before it, check
    it against the numpy oracle and how it dispatched → {rows_per_s, wall,
    launches: {kernel: n}}."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp

    ts, kid, val = stream
    name = f"{JOB_NAMES[job]} via {strategy}"
    dw.dense_window_launches = 0
    mp.merge_partials_launches = 0
    ctx, res, wall = run_job(device, batches, job, strategy=strategy, **cfg)
    launches = {"dense_window": dw.dense_window_launches,
                "merge_partials": mp.merge_partials_launches}
    op = window_exec_of(ctx)
    backend = op.backend
    m = op.metrics()
    if strategy == "partial_merge":
        stripe = backend.stripe
        if launches["merge_partials"] != backend.merges or backend.merges == 0:
            raise AssertionError(
                f"{name}: {launches['merge_partials']} merge kernel launches "
                f"for {backend.merges} merges")
        if stripe.numpy_batches != 0 or stripe.native_batches == 0:
            raise AssertionError(
                f"{name}: native_batches={stripe.native_batches}, "
                f"numpy_batches={stripe.numpy_batches}")
        dispatch = (f"merges={backend.merges} merge kernel launches="
                    f"{launches['merge_partials']}, native reducer batches "
                    f"{stripe.native_batches}, numpy reducer batches "
                    f"{stripe.numpy_batches}, host reduce "
                    f"{stripe.reduce_s:.3f} s, stripe packing "
                    f"{stripe.pack_s:.3f} s")
    elif job == "highcard":
        if backend.scatter_updates != len(batches) or backend.dense_updates:
            raise AssertionError(
                f"{name}: dense_updates={backend.dense_updates}, "
                f"scatter_updates={backend.scatter_updates}")
        dispatch = f"scatter_updates={backend.scatter_updates} dense_updates=0"
    else:
        check_dispatch(ctx, len(batches), name)
        if launches["dense_window"] == 0:
            raise AssertionError(f"{name}: the dense kernel never launched")
        dispatch = (f"dense_updates={len(batches)} scatter_updates=0 "
                    f"kernel launches={launches['dense_window']}")
    exp = oracle(ts, kid, val, 1000, 200 if job == "sliding" else 1000,
                 num_keys)
    check = {"tumbling": check_tumbling, "sliding": check_sliding,
             "highcard": check_highcard}[job]
    rows_out = check(res, exp, num_keys)
    interner = op._interner
    log(f"phase {phase} {name}: {len(ts)} rows in {len(batches)} batches, "
        f"{rows_out} window rows match the oracle, {dispatch}, wall "
        f"{wall:.3f} s, {len(ts) / wall:.0f} rows/s, window host prep "
        f"{m['host_prep_s']:.3f} s, {m['bytes_h2d']} B to and "
        f"{m['bytes_d2h']} B from the card, interner lane "
        f"{interner.lanes[0]} ({interner.native_calls} native calls), "
        f"strategy {m['strategy_resolved']} ({card})")
    return {"rows_per_s": len(ts) / wall, "wall": wall, "launches": launches}


def phase_job(device, seed, total_rows, batch_rows, num_keys, job, strategy,
              phase, card):
    ts, kid, val = gen_stream(total_rows, batch_rows, num_keys, seed)
    batches = to_batches(ts, kid, val, batch_rows, num_keys)
    out = run_checked(device, phase, job, strategy, batches, (ts, kid, val),
                      num_keys, card)
    return out, batches, (ts, kid, val)


# -- phase 4: where the tumbling wall goes ---------------------------------

PROFILE_FIRST, PROFILE_END = 10, 30  # batches 10..29 are profiled


class HookedReader:
    """A partition reader that calls ``on_read(i)`` before handing out batch
    i — by then batch i - 1 has been through the whole plan, its emission
    included.  Its offsets are the wrapped reader's (checkpoints persist
    and restore them)."""

    def __init__(self, reader, on_read):
        self._reader, self._on_read, self._n = reader, on_read, 0

    def read(self, timeout_s=None):
        self._on_read(self._n)
        self._n += 1
        return self._reader.read(timeout_s)

    def offset_snapshot(self):
        return self._reader.offset_snapshot()

    def offset_restore(self, snap):
        self._reader.offset_restore(snap)


def hooked_source(batches, on_read):
    from denormalized_tpu_torch.sources.memory import MemorySource

    class HookedSource(MemorySource):
        def partitions(self):
            return [HookedReader(r, on_read) for r in super().partitions()]

    return HookedSource([batches], timestamp_column="occurred_at_ms")


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def run_stretch(device, batches, begin, end):
    """The tumbling job again, with ``begin()`` called before batch
    PROFILE_FIRST is read and ``end()`` before batch PROFILE_END is (after
    a synchronize each) → {wall_s, prep_s, launches} of that stretch."""
    from denormalized_tpu_torch.ops import dense_window as dw

    st = {}

    def on_read(ctx, i):
        if i not in (PROFILE_FIRST, PROFILE_END):
            return
        torch.cuda.synchronize(device)
        prep = window_exec_of(ctx).metrics()["host_prep_s"]
        if i == PROFILE_FIRST:
            begin()
            st.update(t0=time.perf_counter(), prep0=prep,
                      n0=dw.dense_window_launches)
        else:
            st.update(wall_s=time.perf_counter() - st["t0"],
                      prep_s=prep - st["prep0"],
                      launches=dw.dense_window_launches - st["n0"])
            end()

    run_job(device, batches, "tumbling", on_read)
    n = PROFILE_END - PROFILE_FIRST
    if "wall_s" not in st:
        raise AssertionError("the profiled stretch did not complete")
    if st["launches"] != n:
        raise AssertionError(
            f"stretch: {st['launches']} dense launches for {n} batches"
        )
    return st


def phase_profile(device, batches, card) -> None:
    """Run the tumbling job again with torch.profiler over batches
    PROFILE_FIRST..PROFILE_END-1 and print the split of that stretch: the
    device's busy and idle share, the five device ops that take the most
    time, kernel launches per batch (the dense step must be one), and the
    host-side ops."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    n = PROFILE_END - PROFILE_FIRST
    for _ in range(PROFILER_TRIES):
        prof = prof_ctx(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        st = run_stretch(device, batches, prof.start, prof.stop)
        dev = device_events(prof)
        dense = [e for e in dev if DENSE_KERNEL in e.name]
        if len(dense) > n:
            raise AssertionError(
                f"profiler: {len(dense)} dense kernels for {n} dense batches"
            )
        if len(dense) == n:
            break
        log(f"phase 4 profile: the profiler recorded {len(dense)} dense "
            f"kernels of {n} and {len(dev)} device events")
    else:
        # the launches were counted by run_stretch; only the split is lost
        log(f"phase 4 profile: device split not measured (the profiler "
            f"missed launches in {PROFILER_TRIES} runs)")
        return
    wall_ms = st["wall_s"] * 1e3
    log(f"phase 4 profile batches {PROFILE_FIRST}-{PROFILE_END - 1}: "
        f"{wall_ms:.3f} ms wall under the profiler ({wall_ms / n:.4f} ms a "
        f"batch), window host prep {st['prep_s'] * 1e3 / n:.4f} ms a batch, "
        f"dense launches {st['launches']} for {n} batches ({card})")

    def ms(evts):
        return sum(e.time_range.elapsed_us() for e in evts) / 1e3

    busy_ms = union_us((e.time_range.start, e.time_range.end) for e in dev) / 1e3
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    h2d = [e for e in dev if e.name.startswith("Memcpy HtoD")]
    log(f"phase 4 profile device: busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.2f}% busy, "
        f"{100 * (1 - busy_ms / wall_ms):.2f}% idle), "
        f"{len(kernels) / n:.2f} kernel launches a batch, "
        f"{len(dense) / n:.2f} of them the dense kernel "
        f"({ms(dense) / n:.5f} ms a batch), host-to-card copies "
        f"{ms(h2d) / n:.5f} ms a batch")
    by_name = {}
    for e in dev:
        by_name.setdefault(e.name, []).append(e)
    for name, evts in sorted(by_name.items(), key=lambda kv: -ms(kv[1]))[:5]:
        log(f"phase 4 profile top device op: {ms(evts):.4f} ms in "
            f"{len(evts)} calls: {name[:100]}")
    cpu_top = sorted(
        (a for a in prof.key_averages() if a.self_cpu_time_total > 0),
        key=lambda a: -a.self_cpu_time_total)[:5]
    for a in cpu_top:
        log(f"phase 4 profile top host op: {a.self_cpu_time_total / 1e3:.4f}"
            f" ms self in {a.count} calls: {a.key[:100]}")


# -- phase 6: the scatter path keeps a valid NaN -------------------------------


def phase_scatter_nan(device, seed: int):
    """segment_agg.update_state (the scatter path) on the card and on the
    CPU on one seeded ring and batch with valid NaNs in several cells — some
    before, some after the cell's other values, some in cells whose ring
    value is already NaN — and the two rings
    compared: counts, min and max exact (NaN where NaN), sums to
    rtol=1e-5.  Also reports what torch's own scatter_reduce_ amin/amax do
    with a NaN on the card."""
    from denormalized_tpu_torch.ops import segment_agg as sa

    probe = {}
    for how in ("amin", "amax"):
        t = torch.zeros(2, device=device)
        src = torch.tensor([1.0, float("nan"), float("nan"), 1.0],
                           device=device)
        t.scatter_reduce_(0, torch.tensor([0, 0, 1, 1], device=device), src,
                          reduce=how)
        probe[how] = t.cpu().tolist()
    rng = np.random.default_rng(seed)
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(MAIN_AGGS)), num_value_cols=1,
        window_slots=16, group_capacity=128, length_ms=1000, slide_ms=1000,
    )
    host = seeded_ring(spec, rng)
    for label in ("min_0", "max_0"):  # NaNs already in touched cells
        host[label][15, :4] = np.nan
    B = 4096
    values = rng.normal(50.0, 10.0, (B, 1)).astype(np.float32)
    colvalid = rng.random((B, 1)) > 0.1
    values[~colvalid & (rng.random((B, 1)) < 0.5)] = np.nan
    win_rel = rng.integers(-1, 4, B).astype(np.int32)
    gid = rng.integers(0, 32, B).astype(np.int32)
    for r in (0, 1, 2, B // 2, B - 2, B - 1):  # NaN first, middle and last
        values[r, 0], colvalid[r, 0], win_rel[r] = np.nan, True, 1
    batch = (values, colvalid, win_rel, np.zeros(B, np.int32), gid,
             np.ones(B, bool))
    log(f"phase 6 torch scatter_reduce_ on the card, [1, NaN] and [NaN, 1] "
        f"into one zero cell each: amin {probe['amin']}, amax "
        f"{probe['amax']}")
    rings = []
    for dev in (device, torch.device("cpu")):
        ring = sa.import_state(spec, host, dev)
        sa.update_state(spec, ring, *(torch.from_numpy(a).to(dev)
                                      for a in batch), 14)
        rings.append(ring)
    compare_rings(spec, *rings, "scatter path, card vs CPU")
    nan_cells = int(np.isnan(rings[0]["min_0"].cpu().numpy()).sum())
    log(f"phase 6 scatter path with valid NaNs: the card's ring matches the "
        f"CPU's ({nan_cells} NaN min cells)")


# -- phase 7: the merge kernel against its plain version ----------------------

# the three kernels of csrc/merge_partials.cu: merge_partials_tumbling_kernel,
# merge_partials_gather_kernel and merge_partials_scatter_kernel
MERGE_KERNEL = "merge_partials_"
HIGHCARD_AGGS = [("sum", 0), ("avg", 0)]
# case: (length, slide, G, live groups, first unit, units, rows, nulls,
#        valid NaNs, compensated, aggregates)
MERGE_CASES = {
    "cfg1_dense": (1000, 1000, 128, 10, 3, 2, BATCH_ROWS, False, False,
                   False, MAIN_AGGS),
    "sliding_k5": (1000, 200, 128, 10, 2, 4, BATCH_ROWS, False, True, False,
                   MAIN_AGGS),
    "ragged_compact": (500, 200, 8192, 50, 4, 3, BATCH_ROWS, True, False,
                       True, MAIN_AGGS),
    # the same SUB = 2, k = 3 fan-out over 3 units x 2 x 128 cells: dense
    "ragged_dense": (500, 200, 128, 10, 4, 3, BATCH_ROWS, True, False, False,
                     MAIN_AGGS),
    # config 3's own stripe: at its G (2 x 100K keys, rounded up to 128)
    # the 100K live groups fill half the span, so it packs compact
    "cfg3_compact": (1000, 1000, 2 * HIGHCARD_KEYS + 64, HIGHCARD_KEYS, 5, 2,
                     2 * HIGHCARD_BATCH_ROWS, False, False, False,
                     HIGHCARD_AGGS),
    # the same 100K live groups in a 131,072-wide ring pack dense
    "cfg3_dense": (1000, 1000, 131_072, HIGHCARD_KEYS, 5, 2,
                   2 * HIGHCARD_BATCH_ROWS, False, False, False,
                   HIGHCARD_AGGS),
    # one shard of a key-sharded ring: the stripe spans G_total = 2 x G
    # groups (100K live keys in each half), the ring holds the upper half
    # (g_shift = G); it packs dense
    "cfg3_shard": (1000, 1000, 131_072, 2 * HIGHCARD_KEYS, 5, 2,
                   2 * HIGHCARD_BATCH_ROWS, False, False, False,
                   HIGHCARD_AGGS),
    # float64 rings (accum_dtype=torch.float64): config 3's compact stripe
    # (tumbling), and the fan-out shapes of the scatter and gather kernels
    "cfg3_f64": (1000, 1000, 2 * HIGHCARD_KEYS + 64, HIGHCARD_KEYS, 5, 2,
                 2 * HIGHCARD_BATCH_ROWS, False, False, False,
                 HIGHCARD_AGGS),
    "ragged_compact_f64": (500, 200, 8192, 50, 4, 3, BATCH_ROWS, True, False,
                           True, MAIN_AGGS),
    "sliding_k5_f64": (1000, 200, 128, 10, 2, 4, BATCH_ROWS, False, True,
                       False, MAIN_AGGS),
}
# the cases whose ring is float64
MERGE_F64 = ("cfg3_f64", "ragged_compact_f64", "sliding_k5_f64")
# shards of the stripe's group space, for the cases that hold one shard
MERGE_SHARDS = {"cfg3_shard": 2}
MERGE_DENSE = ("cfg1_dense", "sliding_k5", "ragged_dense", "cfg3_dense",
               "cfg3_shard", "sliding_k5_f64")


def merge_case(name: str, seed: int):
    """One phase-7 case → (spec, host ring, SUB, (packed, a_pad, u_base,
    lean, dense), G_total, g_shift): seeded rows in time order folded into
    the port's own HostPartialStripe and packed by it, and a seeded ring
    (W = 16) whose sums are sums of positive readings.  ``cfg3_compact``'s
    G is config 3's (min_group_capacity = 2 × 100K keys, rounded up to
    128).  A sharded case's stripe spans ``G_total`` = shards × G groups,
    its live keys split evenly over the shards, and the ring holds the
    last shard."""
    from denormalized_tpu_torch.ops import segment_agg as sa
    from denormalized_tpu_torch.ops.host_partial import HostPartialStripe

    (L, S, G, keys, u0, span, B, nulls, nans, compensated,
     aggs) = MERGE_CASES[name]
    shards = MERGE_SHARDS.get(name, 1)
    rng = np.random.default_rng(seed)
    comps = sa.components_for(aggs)
    if compensated:
        comps = sa.with_compensation(comps)
    spec = sa.WindowKernelSpec(
        components=tuple(comps), num_value_cols=1, window_slots=16,
        group_capacity=G, length_ms=L, slide_ms=S, compensated=compensated,
        accum_dtype=torch.float64 if name in MERGE_F64 else torch.float32,
    )
    ms = np.sort(rng.integers(0, span * S, B))
    units = (u0 + ms // S).astype(np.int64)
    rem = (ms % S).astype(np.int32)
    key = rng.integers(0, keys, B)
    per_shard = keys // shards
    gid = (key % per_shard + (key // per_shard) * G).astype(np.int32)
    vals = rng.normal(50.0, 10.0, (B, 1))
    colvalid = None
    if nulls:
        colvalid = rng.random((B, 1)) > 0.1
        vals[~colvalid & (rng.random((B, 1)) < 0.5)] = np.nan
    if nans:
        vals[rng.integers(0, B, 4), 0] = np.nan  # valid NaNs
    stripe = HostPartialStripe(spec, shards * G)
    stripe.add_batch(units, rem, gid, vals, colvalid, None)
    base_mod = int(rng.integers(0, 16))
    taken = stripe.take_packed(base_mod)
    if taken[4] != (name in MERGE_DENSE):
        raise AssertionError(f"{name}: the stripe packed in the other layout")
    host = seeded_ring(spec, rng)
    if nans:
        # NaNs already in the ring, in rows the stripe folds into
        for label in ("min_0", "max_0"):
            host[label][(base_mod + u0 + rng.integers(0, span, 8)) % 16,
                        rng.integers(0, keys, 8)] = np.nan
    return spec, host, stripe.SUB, taken, shards * G, (shards - 1) * G


def merge_bound(spec, SUB: int, packed: np.ndarray, a_pad: int, dense: bool,
                G_total: int, g_shift: int):
    """Least time for one merge on this stripe's data: the bytes over the
    HBM rate or the updates over the f32 rate, whichever is longer.  Bytes:
    the two header slots; the row-count plane of every cell (it tells a
    live cell from an empty one or padding) — in the dense layout only of
    the cells in the ring's shard, whose group is their position; the
    compact index of every non-empty cell; for each live cell of the
    shard, its other value planes; plus every component of each ring cell
    the live cells land in, read and written once (8 B; 16 B for a float64
    plane).  An empty or
    padding cell holds only fold identities, so its other planes need not
    be read.  Updates: one a ring plane per (live cell, fan-out) that
    lands.  → (ms, what bounds it, ring cells touched)."""
    W, cap, k = spec.window_slots, spec.group_capacity, spec.length_units
    planes = packed if dense else packed[1:]
    flat = np.arange(a_pad) if dense else packed[0, :a_pad].astype(np.int64)
    g = flat % G_total - g_shift
    in_shard = (flat >= 0) & (g >= 0) & (g < cap)
    nonempty = (planes[0, :a_pad] != 0) & (flat >= 0)
    live = nonempty & in_shard
    n_live = int(live.sum())
    if dense:
        stripe_bytes = 4 * int(in_shard.sum()) + 8
    else:
        stripe_bytes = 4 * a_pad + 8 + 4 * int(nonempty.sum())
    stripe_bytes += 4 * n_live * (planes.shape[0] - 1)
    flat, g = flat[live], g[live]
    us = flat // G_total
    s, u = us % SUB, us // SUB
    u_base_rel, base_mod = int(packed[0, a_pad]), int(packed[0, a_pad + 1])
    cells, updates = [], 0
    n_planes = len(spec.components)
    for f in range(k):
        w = u_base_rel + u - f
        ok = (w >= 0) & (w < W)
        if SUB == 2 and f == k - 1:
            ok &= s == 0
        cells.append(((base_mod + w[ok]) % W) * cap + g[ok])
        updates += int(ok.sum()) * n_planes
    n_cells = len(np.unique(np.concatenate(cells)))
    cell_bytes = sum(2 * (4 if c.kind == "count" else
                          torch.empty(0, dtype=spec.accum_dtype).element_size())
                     for c in spec.components)
    nbytes = stripe_bytes + n_cells * cell_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = updates / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", n_cells
    return t_ops, "operations", n_cells


def bit_diff(a: dict, b: dict) -> dict:
    """The planes of two rings that differ bit for bit (NaN payloads
    included) → {label: (cells that differ, of them cells that differ
    other than as two NaNs)}."""
    out = {}
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        bits = torch.int64 if x.element_size() == 8 else torch.int32
        ne = x.view(bits) != y.view(bits)
        if ne.any():
            both_nan = (torch.isnan(x) & torch.isnan(y)
                        if x.is_floating_point() else torch.zeros_like(ne))
            out[k] = (int(ne.sum()), int((ne & ~both_nan).sum()))
    return out


def phase_merge_kernel(device, seed: int, card: str):
    """→ {case: {branch, ms, host_ms, plain_ms, max_abs_err, bound_ms,
    bound_by, repeat_bit_equal, cpu_bit_equal}}.  Each case: the kernel
    against its plain version on the card; the kernel launched again on
    an identical ring, whose planes must equal the first bit for bit in
    the branches without atomics; and whether they also equal the plain
    version's on the CPU bit for bit."""
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.ops import segment_agg as sa

    out = {}
    for i, name in enumerate(MERGE_CASES):
        (spec, host, SUB, (packed_np, a_pad, _u, lean, dense), G_total,
         g_shift) = merge_case(name, seed + i)
        branch = mp.merge_branch(spec, dense)
        shift = dict(G_total=G_total, g_shift=g_shift)
        packed = torch.from_numpy(packed_np).to(device)
        got = sa.import_state(spec, host, device)
        again = sa.import_state(spec, host, device)
        want = sa.import_state(spec, host, device)
        before = mp.merge_partials_launches
        mp.merge_partials(spec, SUB, a_pad, lean, dense, got, packed, **shift)
        mp.merge_partials(spec, SUB, a_pad, lean, dense, again, packed,
                          **shift)
        torch.cuda.synchronize(device)
        if mp.merge_partials_launches - before != 2:
            raise AssertionError(f"{name}: the merge kernel did not launch "
                                 f"once a call")
        sa.merge_partials_reference(spec, SUB, a_pad, lean, dense, want,
                                    packed, **shift)
        err = compare_rings(spec, got, want, name)
        repeat_equal = not bit_diff(got, again)
        if branch != "scatter" and not repeat_equal:
            raise AssertionError(f"{name}: two launches of the {branch} "
                                 f"kernel left rings that differ")
        cpu = sa.import_state(spec, host, "cpu")
        sa.merge_partials_reference(spec, SUB, a_pad, lean, dense, cpu,
                                    torch.from_numpy(packed_np), **shift)
        cpu_diff = bit_diff(got, cpu)
        cpu_equal = not cpu_diff
        differ = (f" (cells that differ, as other than two NaNs: {cpu_diff})"
                  if cpu_diff else "")

        scratch = sa.import_state(spec, host, device)

        def kernel():
            mp.merge_partials(spec, SUB, a_pad, lean, dense, scratch, packed,
                              **shift)

        def plain():
            sa.merge_partials_reference(spec, SUB, a_pad, lean, dense,
                                        scratch, packed, **shift)

        ms, ms_by = kernel_device_ms(kernel, MERGE_KERNEL)
        host_ms = time_ms(kernel, device, iters=200)
        plain_ms = time_ms(plain, device)
        bound_ms, bound_by, n_cells = merge_bound(spec, SUB, packed_np, a_pad,
                                                  dense, G_total, g_shift)
        out[name] = dict(branch=branch, ms=ms, ms_by=ms_by, host_ms=host_ms,
                         plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                         bound_by=bound_by, repeat_bit_equal=repeat_equal,
                         cpu_bit_equal=cpu_equal)
        log(f"phase 7 merge {name}: {branch} kernel, "
            f"{'dense' if dense else 'compact'} "
            f"{'lean' if lean else 'full'} stripe {tuple(packed.shape)} int32 "
            f"(a_pad {a_pad}), SUB={SUB} k={spec.length_units} "
            f"G={spec.group_capacity} G_total={G_total} g_shift={g_shift} "
            f"compensated={spec.compensated}, {n_cells} ring cells touched: "
            f"ring matches the plain version (max_abs_err={err:.3g}), two "
            f"launches bit-identical: {repeat_equal}, bit-identical to the "
            f"plain version on the CPU: {cpu_equal}{differ}; "
            f"device {ms:.5f} ms "
            f"({ms_by}), host_ms {host_ms:.4f}, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}) ({card})")
    return out


# -- phase 10: config 3, partial_merge against row shipping -------------------


def phase_highcard(device, seed: int, card: str):
    """Config 3 through partial_merge and through auto (row shipping) on
    the same seeded stream, both checked against the oracle → (rows/s by
    strategy, batches, stream)."""
    stream = gen_stream(TOTAL_ROWS, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS, seed)
    batches = to_batches(*stream, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS)
    # bench.py highcard's capacity: G covers every key from the first batch
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    rates = {}
    for strategy in ("partial_merge", "auto"):
        rates[strategy] = run_checked(
            device, 10, "highcard", strategy, batches, stream,
            HIGHCARD_KEYS, card, **cfg)["rows_per_s"]
    log(f"phase 10 config 3 rows/s side by side: partial_merge "
        f"{rates['partial_merge']:.0f}, row shipping (auto) "
        f"{rates['auto']:.0f} ({card})")
    return rates, batches, stream


# -- phases 11-13: checkpoint and restore (config 5) --------------------------

CKPT_EVERY = 8  # reads between forced barriers (phases 11 and 12)
CKPT_PAUSE_READS = 2  # reads the killed child makes after its 2nd commit


def ckpt_config(path: str) -> dict:
    """EngineConfig knobs of a checkpointed run on a fresh store; barriers
    are forced from a source hook, not by the orchestrator's clock."""
    return dict(checkpoint=True, checkpoint_interval_s=1e9,
                state_backend_path=path)


def read_jsonl(path) -> list:
    out = []
    try:
        with open(path) as f:
            for raw in f:
                try:
                    out.append(json.loads(raw))
                except json.JSONDecodeError:
                    pass  # a line torn by the kill
    except FileNotFoundError:
        pass
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ring_nbytes(backend) -> int:
    return sum(t.numel() * t.element_size() for t in backend._state.values())


def ckpt_child(args) -> int:
    """Phase 11's child: the tumbling job over phase 4's stream (made from
    --seed) through ``auto``, checkpointed to ``--ckpt-child`` with a
    barrier every CKPT_EVERY reads.  One flushed JSON line per emitted
    window row, per committed epoch, and for the restore; with
    ``--ckpt-pause-after N`` it stops reading CKPT_PAUSE_READS reads after
    its N-th commit and waits for its SIGKILL."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.state import checkpoint as ck

    t_main = time.time()  # the script's imports are done
    device = torch.device(args.ckpt_device)
    ts, kid, val = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, args.seed)
    batches = to_batches(ts, kid, val, BATCH_ROWS, NUM_KEYS)
    t_data = time.time()
    out = open(args.ckpt_out, "a", buffering=1)

    def line(**kw):
        out.write(json.dumps(kw) + "\n")

    st = {"restored": False, "commits": [], "after": 0}

    def on_read(ctx, i):
        coord = ctx.last_checkpointing()[0]
        if not st["restored"]:
            st["restored"] = True
            root = ctx._last_physical
            ids = ck.assign_node_ids(root)
            src = next(ids[id(op)] for op in ck.walk(root) if not op.children)
            offsets = ck.get_json(coord, f"offsets_{src}")
            devices = {t.device.type for t in
                       window_exec_of(ctx).backend._state.values()}
            line(event="restored", t=time.time(), t_start=T_START,
                 t_main=t_main, t_data=t_data,
                 epoch=coord.restored_epoch, ring_devices=sorted(devices),
                 pos=offsets["partitions"][0]["pos"] if offsets else 0)
        e = coord.committed_epoch
        if e is not None and e != coord.restored_epoch and (
                e not in st["commits"]):
            st["commits"].append(e)
            line(event="commit", epoch=e, read=i)
        if args.ckpt_pause_after and len(st["commits"]) >= args.ckpt_pause_after:
            st["after"] += 1
            if st["after"] > CKPT_PAUSE_READS:
                line(event="paused", read=i)
                while True:  # until the parent's SIGKILL
                    time.sleep(1)
        if i % CKPT_EVERY == CKPT_EVERY - 1:
            ctx.last_checkpointing()[1].trigger_now()

    ctx, ds = job_stream(device, batches, "tumbling", on_read, "auto",
                         **ckpt_config(args.ckpt_child))
    dw.dense_window_launches = 0
    first = True
    for b in ds.stream():
        rows = tumbling_rows(b)
        if first and rows:
            first = False
            line(event="first_row", t=time.time())
        for (ws, k), (c, mn, mx, a) in rows.items():
            line(event="row", ws=ws, k=k, c=c, mn=mn, mx=mx, a=a)
    sync(device)
    op = window_exec_of(ctx)
    m = op.metrics()
    line(event="done", batches=m["batches_in"], launches=dw.dense_window_launches,
         dense_updates=op.backend.dense_updates,
         scatter_updates=op.backend.scatter_updates, snapshots=m["snapshots"])
    return 0


def phase_ckpt_sigkill(device, seed: int, batches, stream, tumbling, card):
    """Phase 11: config 5 on config 1's stream.  A child commits two epochs
    and is SIGKILLed with more than a third of the stream unread; a second
    child restores on the same store and runs to the end.  The union of
    their rows against the oracle; the restart's reads, dense launches and
    time to recover; then one uninterrupted checkpointed run in this
    process against phase 4's rows/s → the restart's dense launches."""
    import os
    import shutil
    import signal
    import tempfile

    from denormalized_tpu_torch.state.lsm import close_global_state_backend

    n_batches = len(batches)
    exp = oracle(*stream, 1000, 1000, NUM_KEYS)
    work = tempfile.mkdtemp(prefix="dnz_ckpt_")
    state = os.path.join(work, "state")
    procs = []

    def spawn(name, *extra):
        out = os.path.join(work, f"{name}.jsonl")
        err = open(os.path.join(work, f"{name}.err"), "w")
        t = time.time()
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--ckpt-device", str(device), "--ckpt-child", state,
             "--ckpt-out", out, *extra],
            stdout=subprocess.DEVNULL, stderr=err,
        )
        procs.append(p)
        return p, out, t

    def tail(name):
        with open(os.path.join(work, f"{name}.err")) as f:
            return f.read()[-3000:]

    try:
        pa, out_a, _ = spawn("a", "--ckpt-pause-after", "2")
        deadline = time.time() + 300
        while not any(d["event"] == "paused" for d in read_jsonl(out_a)):
            if pa.poll() is not None:
                raise AssertionError(
                    f"phase 11: child A exited ({pa.returncode}) before its "
                    f"second commit: {tail('a')}")
            if time.time() > deadline:
                raise AssertionError("phase 11: child A never paused")
            time.sleep(0.05)
        os.kill(pa.pid, signal.SIGKILL)
        pa.wait(60)
        a = read_jsonl(out_a)
        commits = [d for d in a if d["event"] == "commit"]
        unread = n_batches - a[-1]["read"]  # paused before that read
        if pa.returncode != -signal.SIGKILL or len(commits) != 2 or (
                unread < n_batches / 3):
            raise AssertionError(
                f"phase 11: child A rc {pa.returncode}, {len(commits)} "
                f"commits, {unread} of {n_batches} batches unread")
        pb, out_b, t_spawn = spawn("b")
        if pb.wait(600) != 0:
            raise AssertionError(f"phase 11: child B failed: {tail('b')}")
        b = read_jsonl(out_b)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(60)
        shutil.rmtree(work, ignore_errors=True)

    restored, done = b[0], b[-1]
    first = next(d for d in b if d["event"] == "first_row")

    def rows(lines):
        return {(d["ws"], d["k"]): (d["c"], d["mn"], d["mx"], d["a"])
                for d in lines if d["event"] == "row"}

    rows_a, rows_b = rows(a), rows(b)
    union = dict(rows_a)
    union.update(rows_b)
    check_tumbling_rows(union, exp)
    if restored["epoch"] != commits[-1]["epoch"]:
        raise AssertionError(f"phase 11: restored epoch {restored['epoch']},"
                             f" last commit {commits[-1]['epoch']}")
    if restored["ring_devices"] != [device.type]:
        raise AssertionError(f"phase 11: restored ring on "
                             f"{restored['ring_devices']}")
    if not len(rows_b) < len(exp):
        raise AssertionError("phase 11: the restart emitted every window")
    if not (done["batches"] == n_batches - restored["pos"]
            == done["launches"] == done["dense_updates"]
            and done["scatter_updates"] == 0 and restored["pos"] > 0):
        raise AssertionError(f"phase 11: restart read from {restored['pos']}"
                             f": {done}")
    log(f"phase 11 config 5 (config 1 stream, auto, barrier every "
        f"{CKPT_EVERY} batches): child A committed epochs "
        f"{[d['epoch'] for d in commits]} and was SIGKILLed with {unread} of "
        f"{n_batches} batches unread, {len(rows_a)} rows emitted; child B "
        f"restored epoch {restored['epoch']} at batch {restored['pos']} onto "
        f"the card, read {done['batches']} batches with {done['launches']} "
        f"dense kernel launches on the restored ring, took "
        f"{done['snapshots']} snapshots, emitted {len(rows_b)} rows; the "
        f"union matches the oracle ({len(exp)} rows); time to "
        f"recover: {restored['t'] - t_spawn:.3f} s from spawn to restore "
        f"done ({restored['t_start'] - t_spawn:.3f} s to the script's first "
        f"line, {restored['t_main'] - restored['t_start']:.3f} s of imports, "
        f"{restored['t_data'] - restored['t_main']:.3f} s making the stream, "
        f"{restored['t'] - restored['t_data']:.3f} s of CUDA start, kernel "
        f"loads and the restore), {first['t'] - t_spawn:.3f} s to the first "
        f"emission ({card})")

    from denormalized_tpu_torch import obs

    path = tempfile.mkdtemp(prefix="dnz_ckpt1_")
    commit_ms = obs.histogram("dnz_checkpoint_commit_ms")
    c0, s0 = commit_ms.count, commit_ms.sum
    try:
        def on_read(ctx, i):
            if i % CKPT_EVERY == CKPT_EVERY - 1:
                ctx.last_checkpointing()[1].trigger_now()

        ctx, res, wall = run_job(device, batches, "tumbling", on_read,
                                 "auto", **ckpt_config(path))
        check_tumbling(res, exp, NUM_KEYS)
        m = window_exec_of(ctx).metrics()
        close_global_state_backend()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    commits, commit_s = commit_ms.count - c0, commit_ms.sum - s0
    if m["snapshots"] == 0:
        raise AssertionError("phase 11: the checkpointed run took no snapshot")
    n = m["snapshots"]
    log(f"phase 11 uninterrupted checkpointed run: {len(stream[0]) / wall:.0f}"
        f" rows/s against phase 4's {tumbling['rows_per_s']:.0f} (wall "
        f"{wall:.3f} s), {n} snapshots of {m['snapshot_bytes'] / n:.0f} B, a "
        f"snapshot's host wait {m['snapshot_wait_s'] / n * 1e3:.3f} ms, pack "
        f"{m['snapshot_pack_s'] / n * 1e3:.3f} ms, frame+CRC+put "
        f"{m['snapshot_put_s'] / n * 1e3:.3f} ms, {commits} commits of "
        f"{commit_s / max(commits, 1):.3f} ms (manifest, fsync, record, "
        f"fsync) ({card})")
    return done["launches"]


def chrome_gpu_events(prof, path):
    """GPU events of a profile from its Chrome trace → [(category, name,
    stream, start µs, dur µs)]."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            stream = e.get("args", {}).get("stream", e.get("tid"))
            out.append((e["cat"], e["name"], stream, e["ts"], e["dur"]))
    return out


def snapshot_streams(device, op, work: str, seed: int):
    """Profile one snapshot of ``op`` with merge kernels queued behind its
    clone → the streams and device times of the copy to the host, the clone
    and the kernels, or None where the profiler missed them.  Raises if the
    export has no side stream or its copy shares the kernels' stream."""
    import os

    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.ops import segment_agg as sa

    mspec, mhost, SUB, (packed_np, a_pad, _u, lean, dense), *_ = merge_case(
        "cfg1_dense", seed)
    scratch = sa.import_state(mspec, mhost, device)
    packed = torch.from_numpy(packed_np).to(device)

    epochs = iter(range(100, 200))

    def snapshot_under_kernels():
        op._snapshot(next(epochs))
        for _ in range(5):
            mp.merge_partials(mspec, SUB, a_pad, lean, dense, scratch, packed)
        list(op._release_snapshot())

    snapshot_under_kernels()  # warm, and the backend makes its side stream
    side = op.backend._side
    main = torch.cuda.current_stream(device)
    if side is None or side.cuda_stream == main.cuda_stream:
        raise AssertionError("phase 12: the export has no side stream")
    for _ in range(PROFILER_TRIES):
        evts = chrome_gpu_events(profile(snapshot_under_kernels),
                                 os.path.join(work, "trace.json"))
        d2h = [e for e in evts if "DtoH" in e[1]]
        clone = [e for e in evts if "DtoD" in e[1]]
        kern = [e for e in evts if MERGE_KERNEL in e[1]]
        if d2h and clone and kern:
            streams = dict(
                d2h={e[2] for e in d2h}, clone={e[2] for e in clone},
                kernels={e[2] for e in kern},
                d2h_ms=sum(e[4] for e in d2h) / 1e3,
                clone_ms=sum(e[4] for e in clone) / 1e3,
                overlap=any(k[3] < d[3] + d[4] and d[3] < k[3] + k[4]
                            for k in kern for d in d2h))
            if streams["d2h"] & (streams["kernels"] | streams["clone"]):
                raise AssertionError(f"phase 12: the copy to the host shares "
                                     f"a stream with the kernels: {streams}")
            return streams
        log(f"phase 12 profile: the profiler recorded {len(d2h)} copies to "
            f"the host, {len(clone)} clone copies and {len(kern)} merge "
            f"kernels")
    log(f"phase 12 profile: streams not measured (the profiler missed "
        f"events in {PROFILER_TRIES} runs); the side stream "
        f"{side.cuda_stream:#x} is not the kernels' {main.cuda_stream:#x}")
    return None


def ckpt_steps(device, op, work: str, seed: int, card: str) -> dict:
    """Each step of a snapshot of ``op``'s live state (the crashed run's
    ring, interner and stripe), on a fresh store: the clone's device time;
    the snapshot path itself three times (start, host wait, pack,
    frame+CRC+put), the fsync and the commit; the restore (read and verify,
    unpack, import onto the card); and a profile showing which stream the
    copy to the host runs on."""
    import os
    import zlib

    from denormalized_tpu_torch.ops import segment_agg as sa
    from denormalized_tpu_torch.state import checkpoint as ck
    from denormalized_tpu_torch.state.lsm import LsmStore
    from denormalized_tpu_torch.state.serialization import unpack_snapshot

    backend = op.backend
    clone_ms = queued_event_ms(lambda: sa.clone_state(backend._state), 20)
    store = LsmStore(os.path.join(work, "steps"))
    if not store.is_native:
        raise AssertionError("phase 12: the native LSM store did not build")
    coord = ck.CheckpointCoordinator(store)
    key = "window_steps"
    op._ckpt = (coord, key)
    steps = {k: [] for k in ("start", "wait", "pack", "put", "crc", "fsync",
                             "commit")}
    for epoch in (1, 2, 3):
        m0 = dict(op.metrics())
        t0 = time.perf_counter()
        op._snapshot(epoch)
        steps["start"].append(time.perf_counter() - t0)
        list(op._release_snapshot())
        m1 = op.metrics()
        for k in ("wait", "pack", "put"):
            steps[k].append(m1[f"snapshot_{k}_s"] - m0[f"snapshot_{k}_s"])
        blob_bytes = m1["snapshot_bytes"] - m0["snapshot_bytes"]
        framed = store.get(f"{key}@{epoch}")
        t0 = time.perf_counter()
        zlib.crc32(framed)
        steps["crc"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        store.flush()
        steps["fsync"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        coord.commit(epoch)
        steps["commit"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    raw = coord.get_snapshot(key)
    t1 = time.perf_counter()
    meta, arrays = unpack_snapshot(raw)
    t2 = time.perf_counter()
    op.load_state(arrays, meta["interner"], meta["first_open"],
                  meta["max_win_seen"], meta["watermark_ms"],
                  meta["any_nulls_seen"])
    sync(device)
    t3 = time.perf_counter()
    restore = {"read": t1 - t0, "unpack": t2 - t1, "import": t3 - t2}
    if {t.device.type for t in op.backend._state.values()} != {device.type}:
        raise AssertionError("phase 12: the imported ring is not on the card")

    streams = snapshot_streams(device, op, work, seed)
    store.close()
    ms = {k: 1e3 * sum(v) / len(v) for k, v in steps.items()}
    nbytes = ring_nbytes(op.backend)
    log(f"phase 12 snapshot steps ({len(op.backend._state)} ring planes of "
        f"{op._spec.window_slots} x {op.backend.group_capacity} = {nbytes} B, "
        f"{len(op._interner)} interned keys, snapshot blob {blob_bytes} B; "
        f"mean of 3): clone {clone_ms:.4f} ms on the device; start "
        f"{ms['start']:.3f} ms (stripe merge, meta and interner capture, "
        f"clone and side-stream copy queued); host wait in export_finish "
        f"{ms['wait']:.3f} ms; pack {ms['pack']:.3f} ms; frame+CRC+LSM put "
        f"{ms['put']:.3f} ms (CRC alone {ms['crc']:.3f} ms); fsync "
        f"{ms['fsync']:.3f} ms; commit {ms['commit']:.3f} ms; restore: read "
        f"and verify {restore['read'] * 1e3:.3f} ms, unpack "
        f"{restore['unpack'] * 1e3:.3f} ms, import onto the card "
        f"{restore['import'] * 1e3:.3f} ms ({card})")
    if streams is not None:
        log(f"phase 12 profile: copy to the host on stream(s) "
            f"{sorted(streams['d2h'])} ({streams['d2h_ms']:.4f} ms on the "
            f"device, {nbytes / streams['d2h_ms'] / 1e6:.2f} GB/s), the clone "
            f"on {sorted(streams['clone'])} ({streams['clone_ms']:.4f} ms), the "
            f"merge kernels on {sorted(streams['kernels'])}; a kernel ran "
            f"during the copy: {streams['overlap']} ({card})")
    return dict(ms, clone_ms=clone_ms, restore=restore, streams=streams)


def phase_ckpt_highcard(device, seed: int, batches, stream, card):
    """Phase 12: config 5 at config 3's state size, in this process: a
    barrier before read 6, a crash (the iterator closed) right after its
    commit, the step timing on the crashed operator's state, then a restore
    on the same store onto the card through ``partial_merge``, held with
    the crashed run's rows against the oracle."""
    import os
    import shutil
    import tempfile

    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.logical import plan as lp
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.physical.base import Marker
    from denormalized_tpu_torch.physical.simple_execs import CollectSink
    from denormalized_tpu_torch.runtime import executor
    from denormalized_tpu_torch.state import checkpoint as ck
    from denormalized_tpu_torch.state.lsm import close_global_state_backend
    from denormalized_tpu_torch.state.orchestrator import Orchestrator

    exp = oracle(*stream, 1000, 1000, HIGHCARD_KEYS)
    work = tempfile.mkdtemp(prefix="dnz_ckpt3_")
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS,
               **ckpt_config(os.path.join(work, "state")))

    def build(on_read=None):
        ctx, ds = job_stream(device, batches, "highcard", on_read,
                             "partial_merge", **cfg)
        root = executor.build_physical(lp.Sink(ds._plan, CollectSink()), ctx)
        orch = Orchestrator(interval_s=1e9)
        t0 = time.perf_counter()
        coord = ck.wire_checkpointing(root, ctx, orch)
        return root, orch, coord, time.perf_counter() - t0

    try:
        hold = {}
        root, orch, coord, _ = build(
            lambda ctx, i: i == 6 and hold["orch"].trigger_now())
        hold["orch"] = orch
        rows_a, epoch = {}, None
        it = root.run()
        for item in it:
            if isinstance(item, RecordBatch):
                rows_a.update(highcard_rows(item))
            if isinstance(item, Marker):
                coord.commit(item.epoch)
                epoch = item.epoch
                break
        if epoch is None:
            raise AssertionError("phase 12: no epoch committed")
        op = root.input_op
        snap = op.metrics()
        steps = ckpt_steps(device, op, work, seed, card)
        it.close()  # the crash
        orch.stop()
        close_global_state_backend()

        mp.merge_partials_launches = 0
        root, orch, coord, restore_s = build()
        op = root.input_op
        devices = {t.device.type for t in op.backend._state.values()}
        if coord.restored_epoch != epoch or devices != {device.type} or (
                op.backend.strategy_name != "partial_merge"):
            raise AssertionError(
                f"phase 12: restored epoch {coord.restored_epoch} of {epoch},"
                f" ring on {devices}, {op.backend.strategy_name}")
        rows_b = {}
        t0 = time.perf_counter()
        for item in root.run():
            if isinstance(item, RecordBatch):
                rows_b.update(highcard_rows(item))
        sync(device)
        wall = time.perf_counter() - t0
        orch.stop()
        close_global_state_backend()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    union = dict(rows_a)
    union.update(rows_b)
    check_highcard_rows(union, exp)
    m = op.metrics()
    # partial_merge holds emission up to emit_lag_ms of wall time, so the
    # crashed run may have emitted nothing before its barrier: the restart
    # then rightly emits every window.  What it must never do is emit a
    # window the crashed run had emitted, or read the whole stream again.
    again = rows_a.keys() & rows_b.keys()
    if again or m["batches_in"] >= len(batches):
        raise AssertionError(
            f"phase 12: the restart reprocessed the stream ({len(again)} "
            f"rows emitted again, {len(rows_a)} before the crash, "
            f"{len(rows_b)} after; {m['batches_in']} of {len(batches)} "
            f"batches read after the restore)")
    if op.backend.merges == 0 or mp.merge_partials_launches != op.backend.merges:
        raise AssertionError(
            f"phase 12: {mp.merge_partials_launches} merge launches for "
            f"{op.backend.merges} merges")
    log(f"phase 12 config 5 at config 3's size ({HIGHCARD_KEYS} keys, "
        f"partial_merge): "
        f"crashed after committing epoch {epoch} ({snap['batches_in']} "
        f"batches in, {snap['snapshots']} snapshot of "
        f"{snap['snapshot_bytes']} B); the restart restored it onto the card "
        f"in {restore_s * 1e3:.3f} ms (verify, read, unpack, import), read "
        f"{m['batches_in']} batches with {op.backend.merges} merges (= merge "
        f"kernel launches) in {wall:.3f} s (window host prep "
        f"{m['host_prep_s']:.3f} s, host reduce "
        f"{op.backend.stripe.reduce_s:.3f} s, stripe packing "
        f"{op.backend.stripe.pack_s:.3f} s), emitted {len(rows_b)} rows in "
        f"{m['windows_emitted']} windows; the union matches the oracle "
        f"({len(exp)} rows) ({card})")
    return dict(steps, restore_s=restore_s)


def race_case(seed: int):
    """Phase 13's ring and updates → (spec, host ring, dense batch,
    base_mod, min_win_rel, SUB, packed stripe, a_pad, lean, dense): a
    W = 512, G = 2048 ring (20 MB in 5 planes, so its copy to the host
    outlasts the updates queued behind it), a 131,072-row batch over 2
    slots and every group, and a stripe of the same rows over 2 units."""
    from denormalized_tpu_torch.ops import segment_agg as sa
    from denormalized_tpu_torch.ops.host_partial import HostPartialStripe

    rng = np.random.default_rng(seed)
    W, G, B = 512, 2048, BATCH_ROWS
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(MAIN_AGGS)), num_value_cols=1,
        window_slots=W, group_capacity=G, length_ms=1000, slide_ms=1000,
    )
    ms = np.sort(rng.integers(0, 2000, B))
    units = (3 + ms // 1000).astype(np.int64)
    rem = (ms % 1000).astype(np.int32)
    gid = rng.integers(0, G, B).astype(np.int32)
    vals = rng.normal(50.0, 10.0, (B, 1))
    batch = (vals.astype(np.float32), np.ones((B, 1), bool),
             units.astype(np.int32), rem, gid, np.ones(B, bool))
    base_mod = 500  # the ring wraps: slots 503 and 504, then 0 and 1
    stripe = HostPartialStripe(spec, G)
    stripe.add_batch(units, rem, gid, vals, None, None)
    packed, a_pad, _u, lean, dense = stripe.take_packed(base_mod + 9)
    return (spec, seeded_ring(spec, rng), batch, base_mod, 3, stripe.SUB,
            packed, a_pad, lean, dense)


def phase_snapshot_race(device, seed: int, card, rounds: int = 50):
    """Phase 13: export_start on a seeded ring, then at once, with no
    synchronisation, 20 dense updates and 20 merge folds of the live ring;
    export_finish must return, bit for bit, the synchronous export taken
    just before export_start.  Each round builds a fresh ring (the previous
    one freed) and allocates ring-sized tensors while the copy is in
    flight, so the caching allocator reuses memory."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.parallel.sharded_state import (
        SingleDeviceWindowState,
    )

    (spec, host, batch, base_mod, lo, SUB, packed_np, a_pad, lean,
     dense) = race_case(seed)
    args = [torch.from_numpy(a).to(device) for a in batch]
    packed = torch.from_numpy(packed_np).to(device)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for r in range(rounds):
        backend = SingleDeviceWindowState(spec, device, "auto")
        backend.import_(host if r == 0 else seeded_ring(spec, rng))
        want = backend.export()
        handle = backend.export_start()
        junk = [torch.full_like(t, -1) for t in backend._state.values()]
        for _ in range(20):
            dw.dense_update(spec, backend._state, *args, base_mod,
                            min_win_rel=lo)
            mp.merge_partials(spec, SUB, a_pad, lean, dense, backend._state,
                              packed)
        got = backend.export_finish(handle)
        after = backend.export()
        for label, w in want.items():
            if got[label].tobytes() != w.tobytes():
                raise AssertionError(
                    f"phase 13 round {r}: the snapshot's {label} differs "
                    f"from the export before export_start")
            if np.array_equal(after[label], w):
                raise AssertionError(
                    f"phase 13 round {r}: the updates left {label} unchanged")
        del junk, handle, got
    wall = time.perf_counter() - t0
    nbytes = sum(a.nbytes for a in host.values())
    log(f"phase 13 snapshot race: {rounds} rounds of export_start on a "
        f"{spec.window_slots} x {spec.group_capacity} ring ({nbytes} B in "
        f"{len(host)} planes), 20 dense updates and 20 merge folds queued at "
        f"once, export_finish: every snapshot bit-identical to the export "
        f"before export_start, every plane changed by the updates ({wall:.3f}"
        f" s) ({card})")


# -- phases 14-15: the windowed stream-stream join (config 4) -----------------


def join_stream(device, left_batches, right_batches, strategy, on_read=None,
                **cfg):
    """bench.py's ``join`` query, not yet run → (ctx, DataStream): two
    streams, avg(reading) by sensor_name in 1 s tumbling windows, the right
    side's sensor/start/end renamed to hs/hws/hwe, an inner join on
    (sensor_name, window_start_time) = (hs, hws).  ``on_read(ctx, side,
    i)``, where given, runs before side 0 (left) or 1 (right) reads its
    batch i."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device),
                                     device_strategy=strategy, **cfg))
    col = tt.col

    def side(batches, name, agg):
        if on_read is None:
            source = MemorySource.from_batches(
                batches, timestamp_column="occurred_at_ms")
        else:
            sid = 0 if name == "bench_t" else 1
            source = hooked_source(batches, lambda i: on_read(ctx, sid, i))
        return ctx.from_source(source, name=name).window(
            ["sensor_name"], [F.avg(col("reading")).alias(agg)], 1000)

    right = (
        side(right_batches, "bench_h", "avg_h")
        .with_column_renamed("sensor_name", "hs")
        .with_column_renamed("window_start_time", "hws")
        .with_column_renamed("window_end_time", "hwe")
    )
    ds = side(left_batches, "bench_t", "avg_t").join(
        right, "inner", ["sensor_name", "window_start_time"], ["hs", "hws"])
    return ctx, ds


def join_ops(ctx):
    """(join operator, [left window, right window]) of the last plan."""
    from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec
    from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec

    def find(op, cls):
        if isinstance(op, cls):
            return op
        for c in op.children:
            got = find(c, cls)
            if got is not None:
                return got
        return None

    join = find(ctx._last_physical, StreamingJoinExec)
    return join, [find(c, StreamingWindowExec) for c in join.children]


def join_rows(res) -> dict:
    """{(window_start, key index): (avg_t, avg_h)} of joined rows; raises
    on a row whose two sides disagree on the key or one joined twice."""
    ws = res.column("window_start_time").tolist()
    names = res.column("sensor_name").tolist()
    if res.column("hs").tolist() != names or res.column("hws").tolist() != ws:
        raise AssertionError("joined rows disagree on their keys")
    got = {}
    for w, name, a, b in zip(ws, names, res.column("avg_t").tolist(),
                             res.column("avg_h").tolist()):
        key = (w, int(name[7:]))  # "sensor_<i>"
        if key in got:
            raise AssertionError(f"{key} joined twice")
        got[key] = (a, b)
    return got


def check_join(res, left_stream, right_stream, num_keys) -> int:
    return check_join_rows(join_rows(res), left_stream, right_stream,
                           num_keys)


def check_join_rows(got, left_stream, right_stream, num_keys) -> int:
    """The joined rows against the numpy float64 oracle: the same
    (window_start, sensor) row set as the windows both sides hold, both
    averages to rtol=1e-4 → rows."""
    lo = oracle(*left_stream, 1000, 1000, num_keys)
    ro = oracle(*right_stream, 1000, 1000, num_keys)
    exp = {k: (lo[k][3], ro[k][3]) for k in lo.keys() & ro.keys()}
    if set(got) != set(exp):
        raise AssertionError(
            f"row sets differ: {len(got)} joined vs {len(exp)} expected")
    keys = list(exp)
    assert_close_rows(keys, [got[k] for k in keys], [exp[k] for k in keys])
    return len(got)


def run_join(device, phase, strategy, left, right, num_keys, card,
             query=None, check=None, **cfg):
    """Config 4 over two streams with every kernel count set to 0 just
    before it, checked against the oracle → {rows_per_s, wall, launches,
    ctx, join metrics}.  ``query`` builds the job (bench.py's ``join`` by
    default) and ``check`` holds its rows against the oracle."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp

    query = query or join_stream
    check = check or check_join
    (lb, ls), (rb, rs) = left, right
    rows = len(ls[0]) + len(rs[0])
    ctx, ds = query(device, lb, rb, strategy, **cfg)
    dw.dense_window_launches = 0
    mp.merge_partials_launches = 0
    t0 = time.perf_counter()
    res = ds.collect()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = {"dense_window": dw.dense_window_launches,
                "merge_partials": mp.merge_partials_launches}
    join, windows = join_ops(ctx)
    per_side = []
    for w, batches in zip(windows, (lb, rb)):
        b = w.backend
        if strategy == "partial_merge":
            if b.stripe.numpy_batches or not b.stripe.native_batches:
                raise AssertionError(f"phase {phase}: a side folded on numpy")
            per_side.append(f"{b.merges} merges")
        elif num_keys == NUM_KEYS:
            if b.dense_updates != len(batches) or b.scatter_updates:
                raise AssertionError(
                    f"phase {phase}: dense_updates={b.dense_updates}, "
                    f"scatter_updates={b.scatter_updates}, batches "
                    f"{len(batches)}")
            per_side.append(f"{b.dense_updates} dense launches")
        else:
            if b.scatter_updates != len(batches):
                raise AssertionError(f"phase {phase}: scatter_updates="
                                     f"{b.scatter_updates}")
            per_side.append(f"{b.scatter_updates} scatter steps")
        if w._interner.lanes[0] != "native-pyobject":
            raise AssertionError(f"phase {phase}: interner lane "
                                 f"{w._interner.lanes}")
    if strategy == "partial_merge":
        merges = sum(w.backend.merges for w in windows)
        if launches["merge_partials"] != merges:
            raise AssertionError(f"phase {phase}: {launches['merge_partials']}"
                                 f" merge launches for {merges} merges")
    elif num_keys == NUM_KEYS and launches["dense_window"] != sum(
            len(b) for b in (lb, rb)):
        raise AssertionError(f"phase {phase}: {launches['dense_window']} "
                             f"dense launches for {len(lb) + len(rb)} batches")
    joined = check(res, ls, rs, num_keys)
    m = join.metrics()
    log(f"phase {phase} config 4 via {strategy}: {len(ls[0])} + {len(rs[0])} "
        f"rows in {len(lb)} + {len(rb)} batches, {joined} joined rows match "
        f"the oracle, left window {per_side[0]}, right window {per_side[1]} "
        f"(kernel launches {launches}), wall {wall:.3f} s, "
        f"{rows / wall:.0f} rows/s over both streams; join: {m['rows_in']} "
        f"rows in {m['batches_in']} batches, {m['rows_out']} out, build "
        f"{m['build_s'] * 1e3:.3f} ms, probe {m['probe_s'] * 1e3:.3f} ms, "
        f"gather {m['gather_s'] * 1e3:.3f} ms, evict "
        f"{m['evict_s'] * 1e3:.3f} ms, policy {m['policy_s'] * 1e3:.3f} ms, "
        f"waiting on the merged queue {m['queue_wait_s']:.3f} s "
        f"({100 * m['queue_wait_s'] / wall:.1f}% of the wall); window host "
        f"prep {windows[0].metrics()['host_prep_s']:.3f} s + "
        f"{windows[1].metrics()['host_prep_s']:.3f} s, "
        f"{windows[0].metrics()['bytes_h2d']} + "
        f"{windows[1].metrics()['bytes_h2d']} B to the card ({card})")
    return {"rows_per_s": rows / wall, "wall": wall, "launches": launches,
            "ctx": ctx, "join": m}


def phase_join_profile(device, left, right, card) -> None:
    """Phase 14's run again under torch.profiler: the device's busy share
    of the wall, and whether the two windows' dense kernels (two pump
    threads, each on its thread's current stream) overlapped or ran one
    after another, by the Chrome trace's streams and times."""
    import os
    import shutil
    import tempfile

    n = len(left[0]) + len(right[0])
    work = tempfile.mkdtemp(prefix="chip_smoke_join_")
    try:
        for _ in range(PROFILER_TRIES):
            ctx, ds = join_stream(device, left[0], right[0], "auto")
            holder = {}

            def run():
                t0 = time.perf_counter()
                ds.collect()
                torch.cuda.synchronize(device)
                holder["wall"] = time.perf_counter() - t0

            evts = chrome_gpu_events(profile(run),
                                     os.path.join(work, "trace.json"))
            dense = [e for e in evts if DENSE_KERNEL in e[1]]
            if len(dense) > n:
                raise AssertionError(f"phase 14 profile: {len(dense)} dense "
                                     f"kernels for {n} batches")
            if len(dense) == n:
                break
            log(f"phase 14 profile: the profiler recorded {len(dense)} dense"
                f" kernels of {n} and {len(evts)} device events")
        else:
            log(f"phase 14 profile: device split not measured (the profiler "
                f"missed launches in {PROFILER_TRIES} runs)")
            return
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall_ms = holder["wall"] * 1e3
    busy_ms = union_us((e[3], e[3] + e[4]) for e in evts) / 1e3
    spans = sorted((e[3], e[3] + e[4]) for e in dense)
    dense_sum = sum(e - s for s, e in spans) / 1e3
    dense_union = union_us(spans) / 1e3
    overlaps = sum(1 for (_s0, e0), (s1, _e1) in zip(spans, spans[1:])
                   if s1 < e0)
    log(f"phase 14 profile: wall {wall_ms:.3f} ms under the profiler, device "
        f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}% busy, "
        f"{100 * (1 - busy_ms / wall_ms):.2f}% idle); {len(dense)} dense "
        f"kernels on stream(s) {sorted({e[2] for e in dense})}, "
        f"{dense_sum:.4f} ms summed, {dense_union:.4f} ms as a union, "
        f"{overlaps} overlapping pairs: the two sides' kernels "
        f"{'overlapped' if overlaps else 'ran one after another'} ({card})")


def phase_join(device, seed, batches, stream, tumbling, card):
    """Phase 14: config 4 at bench.py's shape — phase 4's stream on the
    left, one made from --seed + 1 on the right — through auto, checked
    against the oracle, then profiled → the run's dense launches."""
    right_stream = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, seed + 1)
    right = (to_batches(*right_stream, BATCH_ROWS, NUM_KEYS), right_stream)
    out = run_join(device, 14, "auto", (batches, stream), right, NUM_KEYS,
                   card)
    log(f"phase 14 rows/s side by side: config 4 {out['rows_per_s']:.0f} "
        f"over both streams, config 1 (phase 4) {tumbling['rows_per_s']:.0f}"
        f" ({card})")
    phase_join_profile(device, (batches, stream), right, card)
    return out, right


def phase_join_highcard(device, seed, batches, stream, rates, card):
    """Phase 15: config 4 at config 3's key count — phase 10's stream on
    the left, one made from --seed + 6 on the right — through auto (the
    scatter path at this G) and partial_merge, each against the oracle;
    the join holds ~100K rows a window a side, with the policy live."""
    right_stream = gen_stream(TOTAL_ROWS, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS,
                              seed + 6)
    right = (to_batches(*right_stream, HIGHCARD_BATCH_ROWS, HIGHCARD_KEYS),
             right_stream)
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    rates = dict(rates)
    for strategy in ("auto", "partial_merge"):
        out = run_join(device, 15, strategy, (batches, stream), right,
                       HIGHCARD_KEYS, card, **cfg)
        join, _ = join_ops(out["ctx"])
        info = join.state_info()
        ad = info["adaptations"]
        log(f"phase 15 via {strategy}: join state at the end "
            f"{info['slot_live']} resident rows ({info['sides']['left']['rows']}"
            f" + {info['sides']['right']['rows']}), {info['state_bytes']} B, "
            f"{info['live_keys']} live keys, {info['interner_keys_total']} "
            f"interned; policy {ad['by_action']['adapt']} adapts, "
            f"{ad['by_action']['fold']} folds, {info['hot_keys']} hot keys; "
            f"{out['rows_per_s']:.0f} rows/s against config 3's "
            f"{rates[strategy]:.0f} (phase 10, one stream) ({card})")
        rates[f"join_{strategy}"] = out["rows_per_s"]
    return rates, right


# -- phases 16-20: the expression layer, join_on and band joins --------------


@contextlib.contextmanager
def timed_functions(*labels):
    """Host time and rows of the scalar functions named in ``labels``
    (``"case"`` for CASE) while the block runs, summed over every call on
    any thread → {label: {"s", "rows", "calls"}}.  A call's time excludes
    the timed calls nested in it (``lower(replace(x))`` counts each once).
    It wraps the host evaluators of ``ScalarFunctionExpr`` and
    ``CaseExpr`` for the block."""
    from denormalized_tpu_torch.logical.expr import CaseExpr, ScalarFunctionExpr

    acc = {name: {"s": 0.0, "rows": 0, "calls": 0} for name in labels}
    lock = threading.Lock()
    nested = threading.local()  # per thread: time of timed callees
    originals = {cls: cls.eval for cls in (ScalarFunctionExpr, CaseExpr)}

    def wrap(cls):
        orig = originals[cls]

        def ev(self, batch):
            name = getattr(self, "fname", "case")
            if name not in acc:
                return orig(self, batch)
            outer = getattr(nested, "s", 0.0)
            nested.s = 0.0
            t0 = time.perf_counter()
            try:
                out = orig(self, batch)
            finally:
                dt = time.perf_counter() - t0
                inner, nested.s = nested.s, outer + dt
            with lock:
                acc[name]["s"] += dt - inner
                acc[name]["rows"] += batch.num_rows
                acc[name]["calls"] += 1
            return out

        return ev

    for cls in originals:
        cls.eval = wrap(cls)
    try:
        yield acc
    finally:
        for cls, orig in originals.items():
            cls.eval = orig


def expressions_stream(device, left_batches, right_batches, strategy, **cfg):
    """Config 4 as ``examples/stream_join.py --expressions`` writes it, not
    yet run → (ctx, DataStream): two 1 s windows of avg(reading) by
    sensor_name, the right side renamed to humidity_sensor /
    humidity_window_start_time / humidity_window_end_time, and ``join_on``
    with upper(sensor_name) == upper(humidity_sensor), the window starts
    equal, and the residual average_humidity > average_temperature - 100."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device),
                                     device_strategy=strategy, **cfg))
    col = tt.col

    def side(batches, name, agg):
        return ctx.from_source(
            MemorySource.from_batches(batches,
                                      timestamp_column="occurred_at_ms"),
            name=name,
        ).window([col("sensor_name")], [F.avg(col("reading")).alias(agg)],
                 1000)

    humidity = (
        side(right_batches, "humidity", "average_humidity")
        .with_column_renamed("sensor_name", "humidity_sensor")
        .with_column_renamed("window_start_time", "humidity_window_start_time")
        .with_column_renamed("window_end_time", "humidity_window_end_time")
    )
    ds = side(left_batches, "temperature", "average_temperature").join_on(
        humidity, "inner", [
            F.upper(col("sensor_name")) == F.upper(col("humidity_sensor")),
            col("window_start_time") == col("humidity_window_start_time"),
            col("average_humidity")
            > col("average_temperature") - F.lit(100.0),
        ])
    return ctx, ds


EXPRESSIONS_COLUMNS = [
    "sensor_name", "average_temperature", "window_start_time",
    "window_end_time", "humidity_sensor", "average_humidity",
    "humidity_window_start_time", "humidity_window_end_time",
]


def check_join_expressions(res, left_stream, right_stream, num_keys) -> int:
    """The --expressions join against the numpy float64 oracle: the
    (window_start, sensor) windows both sides hold whose averages pass the
    residual, both averages to rtol=1e-4, and no hidden key column in the
    output → rows."""
    names = res.schema.without_internal().names
    if names != EXPRESSIONS_COLUMNS:
        raise AssertionError(f"output columns {names}, hidden keys leaked?")
    lo = oracle(*left_stream, 1000, 1000, num_keys)
    ro = oracle(*right_stream, 1000, 1000, num_keys)
    both = lo.keys() & ro.keys()
    exp = {k: (lo[k][3], ro[k][3]) for k in both
           if ro[k][3] > lo[k][3] - 100.0}
    ws = res.column("window_start_time").tolist()
    sensors = res.column("sensor_name").tolist()
    if (res.column("humidity_sensor").tolist() != sensors
            or res.column("humidity_window_start_time").tolist() != ws):
        raise AssertionError("joined rows disagree on their keys")
    got = {}
    for w, name, a, b in zip(ws, sensors,
                             res.column("average_temperature").tolist(),
                             res.column("average_humidity").tolist()):
        key = (w, int(name[7:]))  # "sensor_<i>"
        if key in got:
            raise AssertionError(f"{key} joined twice")
        got[key] = (a, b)
    if set(got) != set(exp):
        raise AssertionError(
            f"row sets differ: {len(got)} joined vs {len(exp)} expected")
    for k, (a, b) in exp.items():
        ga, gb = got[k]
        if not (np.isclose(ga, a, rtol=1e-4, atol=0)
                and np.isclose(gb, b, rtol=1e-4, atol=0)):
            raise AssertionError(f"{k}: got {got[k]}, expected {(a, b)}")
    log(f"  residual: {len(both)} windows held by both sides, "
        f"{len(both) - len(exp)} dropped by average_humidity > "
        f"average_temperature - 100")
    return len(got)


def phase_join_expressions(device, left, right, plain, card):
    """Phase 16: config 4 as the reference's --expressions example writes
    it, over phase 14's two streams through ``auto`` → the dense launches
    of its run."""
    with timed_functions("upper") as acc:
        out = run_join(device, 16, "auto", left, right, NUM_KEYS, card,
                       query=expressions_stream,
                       check=check_join_expressions)
    up = acc["upper"]
    log(f"phase 16 rows/s side by side: config 4 --expressions "
        f"{out['rows_per_s']:.0f}, plain keys (phase 14) "
        f"{plain['rows_per_s']:.0f}, ratio "
        f"{out['rows_per_s'] / plain['rows_per_s']:.3f}; upper over "
        f"{up['rows']} window rows in {up['calls']} calls "
        f"{up['s'] * 1e3:.3f} ms ({card})")
    return out["launches"]["dense_window"]


def phase_join_expressions_highcard(device, left, right, rates, card):
    """Phase 17: the --expressions query at config 3's key count, over
    phase 15's two streams (100K keys a side) through ``auto``."""
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    with timed_functions("upper") as acc:
        out = run_join(device, 17, "auto", left, right, HIGHCARD_KEYS, card,
                       query=expressions_stream,
                       check=check_join_expressions, **cfg)
    up = acc["upper"]
    log(f"phase 17 rows/s side by side: config 4 --expressions at 100K keys "
        f"{out['rows_per_s']:.0f}, plain keys (phase 15 auto) "
        f"{rates['join_auto']:.0f}, ratio "
        f"{out['rows_per_s'] / rates['join_auto']:.3f}; upper over "
        f"{up['rows']} window rows in {up['calls']} calls "
        f"{up['s'] * 1e3:.3f} ms, {1e9 * up['s'] / max(up['rows'], 1):.0f} "
        f"ns a row ({card})")


# bench.py join_skew (bench.py:1807-1935), uncut
SKEW_ROWS_SIDE = 500_000
SKEW_BATCH = 8_192
SKEW_KEYSPACE = 10_000
SKEW_DIM_DENSITY = 0.0004
SKEW_BAND = 50


def skew_feed(seed: int, shape: str):
    """One side of bench.py's join_skew: event time 1 ms a row from
    EVENT_T0, keys zipf(1.2) rejection-sampled onto 10,000 keys ("zipf") or
    uniform with a 0.0004 share of key 1 ("dim") → (ts, key, value)."""
    rng = np.random.default_rng(seed)
    ts = EVENT_T0 + np.arange(SKEW_ROWS_SIDE, dtype=np.int64)
    keys = np.empty(SKEW_ROWS_SIDE, dtype=np.int64)
    for start in range(0, SKEW_ROWS_SIDE, SKEW_BATCH):
        n = min(SKEW_BATCH, SKEW_ROWS_SIDE - start)
        if shape == "zipf":
            out = np.empty(n, dtype=np.int64)
            filled = 0
            while filled < n:
                draw = rng.zipf(1.2, n - filled)
                draw = draw[draw <= SKEW_KEYSPACE]
                out[filled:filled + len(draw)] = draw
                filled += len(draw)
        else:
            cel = rng.random(n) < SKEW_DIM_DENSITY
            out = np.where(cel, 1, rng.integers(2, SKEW_KEYSPACE + 1, n))
        keys[start:start + n] = out
    return ts, keys, rng.random(SKEW_ROWS_SIDE)


def skew_batches(stream, names):
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema

    schema = Schema([Field(names[0], DataType.TIMESTAMP_MS, nullable=False),
                     Field(names[1], DataType.INT64, nullable=False),
                     Field(names[2], DataType.FLOAT64)])
    ts, keys, vals = stream
    return [RecordBatch(schema, [ts[i:i + SKEW_BATCH], keys[i:i + SKEW_BATCH],
                                 vals[i:i + SKEW_BATCH]])
            for i in range(0, len(ts), SKEW_BATCH)]


def skew_oracle_pairs(left, right) -> int:
    """Pairs with equal keys and |ts - ts2| <= 50: per key, the right
    timestamps sorted, counted around each left row by searchsorted."""
    lts, lk, _ = left
    rts, rk, _ = right
    span = 1 << 21  # > the stream's 500,000 ms, so keys never overlap
    rc = np.sort(rk * span + (rts - EVENT_T0))
    base = lk * span + (lts - EVENT_T0)
    return int((np.searchsorted(rc, base + SKEW_BAND, side="right")
                - np.searchsorted(rc, base - SKEW_BAND, side="left")).sum())


def run_skew(device, left, right, adaptive: bool):
    """The band join once → (rows/s over both sides, sorted pair rows,
    join state_info, join metrics)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(
        device=str(device), join_adaptive=adaptive,
        join_adapt_interval_s=0.25, join_retention_ms=600_000))
    lsrc = ctx.from_source(MemorySource.from_batches(
        skew_batches(left, ("ts", "k", "v")), timestamp_column="ts"),
        name="skew_l")
    rsrc = ctx.from_source(MemorySource.from_batches(
        skew_batches(right, ("ts2", "k2", "w")), timestamp_column="ts2"),
        name="skew_r")
    ds = lsrc.join(rsrc, "inner", ["k"], ["k2"],
                   band=("ts", "ts2", -SKEW_BAND, SKEW_BAND))
    t0 = time.perf_counter()
    res = ds.collect()
    wall = time.perf_counter() - t0
    cols = [np.asarray(res.column(n)) for n in ("ts", "k", "v", "ts2", "k2",
                                                "w")]
    if not np.array_equal(cols[1], cols[4]):
        raise AssertionError("phase 18: a pair joined unequal keys")
    if np.any(np.abs(cols[0] - cols[3]) > SKEW_BAND):
        raise AssertionError("phase 18: a pair lies outside the band")
    order = np.lexsort((cols[3], cols[0]))
    rows = np.stack([c[order].astype(np.float64) for c in cols])
    join, _ = join_ops(ctx)
    return (2 * SKEW_ROWS_SIDE / wall, rows, join.state_info(),
            join.metrics(), wall)


def phase_join_skew(device, seed, card):
    """Phase 18: bench.py's join_skew shape (a zipf(1.2) left side, a
    mostly-uniform right side with a thin share of the hottest key,
    500,000 rows a side in 8,192-row batches, band ±50 ms), once adaptive
    and once with ``join_adaptive=False``: both emit the same multiset,
    equal in count to a numpy oracle's pairs, and the adaptive run
    adapts.  Host code on the card's host."""
    left = skew_feed(seed + 7, "zipf")
    right = skew_feed(seed + 8, "dim")
    want = skew_oracle_pairs(left, right)
    a_rate, a_rows, a_info, a_m, a_wall = run_skew(device, left, right, True)
    s_rate, s_rows, _s_info, s_m, s_wall = run_skew(device, left, right,
                                                    False)
    if a_rows.shape != s_rows.shape or not np.array_equal(a_rows, s_rows):
        raise AssertionError(f"phase 18: adaptive and static runs emit "
                             f"different rows ({a_rows.shape[1]} vs "
                             f"{s_rows.shape[1]})")
    if a_rows.shape[1] != want:
        raise AssertionError(f"phase 18: {a_rows.shape[1]} pairs, the "
                             f"oracle counts {want}")
    ad = a_info["adaptations"]
    if ad["total"] <= 0:
        raise AssertionError("phase 18: the adaptive run never adapted")
    top = np.bincount(left[1]).max() / SKEW_ROWS_SIDE
    log(f"phase 18 join_skew (bench.py shape): {SKEW_ROWS_SIDE} rows a side "
        f"in {SKEW_BATCH}-row batches, top key {100 * top:.1f}% of the "
        f"left rows, {want} pairs match the oracle and are equal in both "
        f"modes; adaptive {a_rate:.0f} rows/s (wall {a_wall:.3f} s; "
        f"{ad['total']} adaptations: {ad['by_action']}, "
        f"{a_info['hot_keys']} hot keys, {a_info['hot_bytes']} hot B; "
        f"probe {a_m['probe_s']:.3f} s, gather {a_m['gather_s']:.3f} s, "
        f"policy {a_m['policy_s']:.3f} s), static {s_rate:.0f} rows/s "
        f"(wall {s_wall:.3f} s; probe {s_m['probe_s']:.3f} s, gather "
        f"{s_m['gather_s']:.3f} s), adaptive / static "
        f"{a_rate / s_rate:.3f} (the reference's bench gate, >= 3, is "
        f"logged, not enforced) ({card})")


FUNCTIONS_BATCHES = 15
BANDS = ("hot", "cold", "mild")


def functions_stream(device, batches, **cfg):
    """The projection half of ``examples/functions_tour.py`` feeding a
    window through ``auto``, not yet run → (ctx, DataStream)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device), **cfg))
    col, lit = tt.col, tt.lit
    ds = (
        ctx.from_source(MemorySource.from_batches(
            batches, timestamp_column="occurred_at_ms"))
        .with_column("sensor",
                     F.lower(F.replace("sensor_name", "Sensor_", "s")))
        .with_column("band", F.when(col("reading") > 25.0, lit("hot"))
                     .when(col("reading") < 15.0, lit("cold"))
                     .otherwise(lit("mild")))
        .with_column("minute", F.date_trunc("minute", col("occurred_at_ms")))
        .filter(F.length("sensor") >= 2)
        .window(["sensor", "band"],
                [F.count(col("reading")).alias("n"),
                 F.avg(col("reading")).alias("mean")], 1000)
    )
    return ctx, ds


def phase_functions(device, batches, stream, card):
    """Phase 19: scalar functions and CASE feeding the dense window (a
    two-column group key) over phase 4's first 15 batches, against the
    numpy oracle → the dense launches of its run."""
    from denormalized_tpu_torch.ops import dense_window as dw

    batches = batches[:FUNCTIONS_BATCHES]
    n = sum(b.num_rows for b in batches)
    ts, kid, val = (a[:n] for a in stream)
    ctx, ds = functions_stream(device, batches)
    dw.dense_window_launches = 0
    with timed_functions("replace", "lower", "length", "case") as acc:
        t0 = time.perf_counter()
        res = ds.collect()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    launches = dw.dense_window_launches
    op = window_exec_of(ctx)
    b = op.backend
    if b.dense_updates != len(batches) or b.scatter_updates or \
            launches != len(batches):
        raise AssertionError(
            f"phase 19: dense_updates={b.dense_updates}, scatter_updates="
            f"{b.scatter_updates}, dense launches {launches} for "
            f"{len(batches)} batches")
    band = np.where(val > 25.0, 0, np.where(val < 15.0, 1, 2))
    exp = oracle(ts, kid * len(BANDS) + band, val, 1000, 1000,
                 NUM_KEYS * len(BANDS))
    got = {}
    for w, sensor, bd, cnt, mean in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor").tolist(), res.column("band").tolist(),
            res.column("n").tolist(), res.column("mean").tolist()):
        key = (w, int(sensor[7:]) * len(BANDS) + BANDS.index(bd))
        if key in got:
            raise AssertionError(f"phase 19: {key} emitted twice")
        got[key] = (cnt, mean)
    if set(got) != set(exp):
        raise AssertionError(f"phase 19: {len(got)} window rows, the oracle "
                             f"has {len(exp)}")
    for k, (cnt, mean) in got.items():
        e = exp[k]
        if cnt != e[0] or not np.isclose(mean, e[3], rtol=1e-4, atol=0):
            raise AssertionError(f"phase 19: {k}: got {(cnt, mean)}, "
                                 f"expected {(e[0], e[3])}")
    m = op.metrics()
    maps = ", ".join(
        f"{name} {a['s'] * 1e3:.1f} ms over {a['rows']} rows "
        f"({1e9 * a['s'] / max(a['rows'], 1):.0f} ns a row)"
        for name, a in acc.items())
    total = sum(a["s"] for a in acc.values())
    log(f"phase 19 functions into the dense window: {n} rows in "
        f"{len(batches)} batches, {len(got)} (window, sensor, band) rows "
        f"match the oracle, {launches} dense launches, wall {wall:.3f} s, "
        f"{n / wall:.0f} rows/s; window host prep {m['host_prep_s']:.3f} s; "
        f"string maps and CASE {total:.3f} s ({100 * total / wall:.1f}% of "
        f"the wall): {maps} ({card})")
    return launches


def phase_eval_torch(device, seed, card):
    """Phase 20: ``Expr.eval_torch`` on the card against the host ``eval``
    of the same trees over the same seeded float32 / int64 columns."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema

    n = 1 << 20
    rng = np.random.default_rng(seed)
    v = rng.normal(0.0, 20.0, n).astype(np.float32)
    v[:8] = [2.5, -2.5, 0.5, -0.5, 1.5, -1.5, 3.5, -3.5]
    v[rng.integers(8, n, 64)] = np.nan
    w = rng.uniform(0.1, 500.0, n).astype(np.float32)
    i = rng.integers(-100_000, 100_000, n).astype(np.int64)
    batch = RecordBatch(
        Schema([Field("v", DataType.FLOAT32), Field("w", DataType.FLOAT32),
                Field("i", DataType.INT64)]), [v, w, i])
    cols = {k: torch.from_numpy(a).to(device)
            for k, a in (("v", v), ("w", w), ("i", i))}
    col, lit = tt.col, tt.lit
    cases = {
        "sqrt(abs(v))": (F.sqrt(F.abs("v")), 1e-6),
        "round(v)": (F.round("v"), None),
        "case3": (F.when(col("v") > 10.0, lit(1.0))
                  .when(col("v") < -10.0, lit(-1.0)).otherwise(lit(0.0)),
                  None),
        # the host multiplies by a float64 literal, the card in float32:
        # casts compare on the column itself
        "cast(w, int64)": (col("w").cast(DataType.INT64), None),
        "cast(i, float32)": (col("i").cast(DataType.FLOAT32), None),
        "isnan(v)": (F.isnan("v"), None),
        "nanvl(v, -1)": (F.nanvl("v", lit(-1.0)), None),
    }
    lines = []
    for name, (e, rtol) in cases.items():
        got = e.eval_torch(cols)
        if got.device != device:
            raise AssertionError(f"phase 20 {name}: result on {got.device}")
        host = np.asarray(e.eval(batch))
        dev = got.cpu().numpy()
        if dev.shape != host.shape:
            raise AssertionError(f"phase 20 {name}: {dev.shape} vs "
                                 f"{host.shape}")
        if rtol is None:
            ok = np.array_equal(dev.astype(np.float64),
                                host.astype(np.float64), equal_nan=True)
        else:
            ok = np.allclose(dev, host, rtol=rtol, atol=0, equal_nan=True)
        if not ok:
            bad = np.flatnonzero(~np.isclose(dev, host, rtol=rtol or 0,
                                             atol=0, equal_nan=True))[:5]
            raise AssertionError(f"phase 20 {name}: rows {bad.tolist()}: "
                                 f"{dev[bad].tolist()} vs {host[bad].tolist()}")
        ms = time_ms(lambda e=e: e.eval_torch(cols), device)
        t0 = time.perf_counter()
        e.eval(batch)
        host_ms = (time.perf_counter() - t0) * 1e3
        # bytes bound: each column the tree reads once, its result once
        moved = (sum(cols[c].element_size() for c in e.columns_referenced())
                 + got.element_size()) * n
        lines.append(
            f"{name} {ms:.4f} ms, bound {moved / HBM_BYTES_PER_S * 1e3:.5f} "
            f"ms (bytes), host eval {host_ms:.3f} ms "
            f"({'exact' if rtol is None else f'rtol={rtol}'})")
    if not (np.asarray(F.round("v").eval_torch(cols)[:8].cpu())
            == [3.0, -3.0, 1.0, -1.0, 2.0, -2.0, 4.0, -4.0]).all():
        raise AssertionError("phase 20: round is not half away from zero")
    log(f"phase 20 eval_torch on the card: {len(cases)} trees over {n} rows "
        f"equal the host eval, every result on {device}: {'; '.join(lines)} "
        f"({card})")


# -- phases 21-23: the live Kafka path ---------------------------------------

KAFKA_PARTITIONS = 4
KAFKA_RECORDS_PER_BATCH = 512  # MockKafkaBroker.produce_batched's default
KAFKA_WARM_ROWS = 3 * EVENTS_PER_SEC  # three windows of event time
KAFKA_DEADLINE_S = 240.0
LAT_ROWS = 24 * EVENTS_PER_SEC  # 24 windows → 22 latency samples
LAT_CHUNK = 8192  # rows a paced append, over all partitions
CKPT_KAFKA_ROWS = 6 * EVENTS_PER_SEC  # phase 23's feed: 6 windows
E2E_COLUMNS = ("occurred_at_ms", "sensor_name", "reading")


def _varint_table(n: int):
    """Unsigned LEB128 varints of 0..n-1 → ((n, 3) uint8 bytes, lengths)."""
    v = np.arange(n, dtype=np.int64)
    if n > 1 << 21:
        raise ValueError("varint table covers values below 2**21")
    out = np.zeros((n, 3), np.uint8)
    lens = 1 + (v >= 1 << 7) + (v >= 1 << 14)
    for j in range(3):
        more = lens > j + 1
        out[:, j] = ((v >> (7 * j)) & 0x7F) | (more << 7)
    return out, lens.astype(np.int64)


def _concat_pieces(pieces, n: int):
    """Row-wise concatenation of byte pieces → (flat uint8 data, int64
    offsets (n + 1)).  A piece is ``(matrix, lengths)``: row i takes the
    first ``lengths[i]`` bytes of the matrix's row i (a 1-row matrix and
    an int length broadcast).  One boolean compress of the side-by-side
    matrices keeps each row's pieces in order."""
    mats, masks, lens = [], [], []
    for mat, ln in pieces:
        ln = np.broadcast_to(np.asarray(ln, np.int64), (n,))
        w = mat.shape[1]
        mats.append(np.broadcast_to(mat, (n, w)))
        masks.append(np.arange(w)[None, :] < ln[:, None])
        lens.append(ln)
    data = np.concatenate(mats, axis=1)[np.concatenate(masks, axis=1)]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(np.sum(lens, axis=0), out=offs[1:])
    return data, offs


def _const(b: bytes):
    return np.frombuffer(b, np.uint8)[None, :], len(b)


def _digits(x, width: int):
    """Fixed-width decimal digits of non-negative int64 ``x`` → (n, width)
    ASCII, most significant first."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((x[:, None] // p[None, :]) % 10 + 48).astype(np.uint8)


def json_pieces(ts, kid, micro, key_names):
    """The pieces (see :func:`_concat_pieces`) of the emit_measurements
    JSON records of bench.py's ``_json_payloads``
    (``{"occurred_at_ms":T,"sensor_name":"K","reading":R}``) for
    ``len(ts)`` rows at once: ``micro`` is the reading in integer
    millionths, written as ``I.FFFFFF`` (bench.py rounds to 6 decimals
    too), which a correctly-rounded parser reads back as exactly
    ``micro / 1e6``."""
    if len(ts) and (ts.min() < 10 ** 12 or ts.max() >= 10 ** 13):
        raise ValueError("event times must have 13 digits")
    names = [k.encode() for k in key_names]
    name_mat = np.zeros((len(names), max(map(len, names))), np.uint8)
    for i, nb in enumerate(names):
        name_mat[i, : len(nb)] = np.frombuffer(nb, np.uint8)
    name_len = np.array([len(nb) for nb in names], np.int64)
    a = np.abs(micro)
    ip, fp = a // 1_000_000, a % 1_000_000
    width = max(1, len(str(int(ip.max(initial=0)))))
    nd = 1 + np.floor(np.log10(np.maximum(ip, 1))).astype(np.int64)
    # left-align the integer digits: row i's start at width - nd[i]
    gather = np.minimum(np.arange(width)[None, :] + (width - nd)[:, None],
                        width - 1)
    return [
        _const(b'{"occurred_at_ms":'),
        (_digits(ts, 13), 13),
        _const(b',"sensor_name":"'),
        (name_mat[kid], name_len[kid]),
        _const(b'","reading":'),
        (np.full((1, 1), ord("-"), np.uint8), (micro < 0).astype(np.int64)),
        (np.take_along_axis(_digits(ip, width), gather, axis=1), nd),
        _const(b"."),
        (_digits(fp, 6), 6),
        _const(b"}"),
    ]


#: the Avro record of phase 29 (tests/test_kafka.py:584-593's
#: ``Measurement``)
MEASUREMENT_AVRO = {
    "type": "record",
    "name": "Measurement",
    "fields": [
        {"name": "occurred_at_ms",
         "type": {"type": "long", "logicalType": "timestamp-millis"}},
        {"name": "sensor_name", "type": "string"},
        {"name": "reading", "type": ["null", "double"]},
    ],
}


def _zigzag_varints(x):
    """Avro's zigzag varints of int64 ``x`` → ((n, 10) uint8, lengths)."""
    z = (x.astype(np.int64) << 1) ^ (x.astype(np.int64) >> 63)
    z = z.view(np.uint64)
    lens = np.ones(len(z), np.int64)
    for j in range(1, 10):
        lens += z >= np.uint64(1) << np.uint64(7 * j)
    out = np.zeros((len(z), 10), np.uint8)
    for j in range(10):
        more = lens > j + 1
        out[:, j] = ((z >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(
            np.uint8) | (more.astype(np.uint8) << 7)
    return out, lens


def avro_pieces(ts, kid, val, key_names):
    """The pieces (see :func:`_concat_pieces`) of ``Measurement`` Avro
    records (MEASUREMENT_AVRO) for ``len(ts)`` rows at once: the event
    time as a zigzag varint, the sensor name as a zigzag length and its
    bytes, then the union's branch 1 (zigzag 1 = 0x02) and the reading as
    8 little-endian bytes of its float64 — the bytes
    ``avro_codec.encode_record`` writes (tests/test_torch_avro.py)."""
    names = [k.encode() for k in key_names]
    name_mat = np.zeros((len(names), max(map(len, names))), np.uint8)
    for i, nb in enumerate(names):
        name_mat[i, : len(nb)] = np.frombuffer(nb, np.uint8)
    name_len = np.array([len(nb) for nb in names], np.int64)
    nvar, nvar_len = _zigzag_varints(name_len)
    reading = np.ascontiguousarray(val, dtype="<f8").view(np.uint8).reshape(
        -1, 8)
    return [
        _zigzag_varints(ts),
        (nvar[kid], nvar_len[kid]),
        (name_mat[kid], name_len[kid]),
        _const(b"\x02"),
        (reading, 8),
    ]


def kafka_record_batches(payload, n: int, records_per_batch: int,
                         broker_ts: int, base_offset: int = 0):
    """Magic-2 record batches of ``n`` records whose values are the pieces
    ``payload`` (:func:`json_pieces`), ``records_per_batch`` a batch, byte
    for byte what ``MockKafkaBroker.produce_batched``/``stage_batched``
    encode (zero CRC, every record at ``broker_ts``) → [(first offset,
    records, bytes)]."""
    import struct

    if n == 0:
        return []
    vt, vl = _varint_table(1 << 16)
    vlen = sum(np.broadcast_to(np.asarray(ln, np.int64), (n,))
               for _, ln in payload)
    off_delta = np.arange(n, dtype=np.int64) % records_per_batch
    # zigzag of a non-negative x is 2x; the null key is zigzag(-1) = 1
    body = 1 + 1 + vl[2 * off_delta] + 1 + vl[2 * vlen] + vlen + 1
    rec, rec_offs = _concat_pieces([
        (vt[2 * body], vl[2 * body]),
        _const(b"\x00\x00"),  # attributes, timestamp delta 0
        (vt[2 * off_delta], vl[2 * off_delta]),
        _const(b"\x01"),  # null key
        (vt[2 * vlen], vl[2 * vlen]),
        *payload,
        _const(b"\x00"),  # no headers
    ], n)
    out = []
    raw = rec.tobytes()
    for first in range(0, n, records_per_batch):
        k = min(records_per_batch, n - first)
        section = raw[rec_offs[first]:rec_offs[first + k]]
        head = struct.pack(">hiqqqhii", 0, k - 1, broker_ts, broker_ts,
                           -1, -1, -1, k)
        enc = (struct.pack(">qiib", base_offset + first,
                           len(head) + len(section) + 9, -1, 2)
               + struct.pack(">I", 0) + head + section)
        out.append((base_offset + first, k, enc))
    return out


def staged_entries(batches, broker_ts: int) -> list:
    """Broker log entries of encoded record batches, in the shape of
    ``MockKafkaBroker.stage_batched``'s (a batch's bytes on its first
    offset, the followers empty; payloads are not kept)."""
    import itertools

    entries = []
    for first, k, enc in batches:
        entries.append((first, broker_ts, None, enc))
        entries.extend(zip(range(first + 1, first + k),
                           itertools.repeat(broker_ts),
                           itertools.repeat(None), itertools.repeat(b"")))
    return entries


def micro_of(val):
    """Readings in integer millionths, as bench.py's JSON rounds them."""
    return np.rint(val * 1e6).astype(np.int64)


def encode_topic(stream, parts: int, records_per_batch: int,
                 chunk_rows: int | None = None, fmt: str = "json"):
    """The stream's JSON records (``fmt="avro"``: its ``Measurement`` Avro
    records, readings as their float64), row i to partition i % parts (bench.py's
    interleave, which keeps every partition's event-time range aligned),
    as broker entries → per partition a list of entry lists: one list for
    the whole partition, or one a ``chunk_rows // parts``-record chunk
    (each chunk one record batch, as bench.py's paced feed stages them)."""
    from concurrent.futures import ThreadPoolExecutor

    ts, kid, val = stream
    micro = micro_of(val)
    names = [f"sensor_{i}" for i in range(int(kid.max()) + 1)]
    step = (chunk_rows // parts) if chunk_rows else records_per_batch
    # encode in slices of whole record batches (bounded memory)
    span = max(step, (1 << 19) // step * step)

    def encode(p):
        t, k, m = ts[p::parts], kid[p::parts], micro[p::parts]
        v = val[p::parts]
        per = []
        for a in range(0, len(t), span):
            if fmt == "avro":
                pieces = avro_pieces(t[a:a + span], k[a:a + span],
                                     v[a:a + span], names)
            else:
                pieces = json_pieces(t[a:a + span], k[a:a + span],
                                     m[a:a + span], names)
            per += kafka_record_batches(pieces, len(t[a:a + span]), step,
                                        EVENT_T0, a)
        if chunk_rows:
            return [staged_entries([b], EVENT_T0) for b in per]
        return staged_entries(per, EVENT_T0)

    # numpy releases the interpreter lock in the bulk steps: a thread a
    # partition
    with ThreadPoolExecutor(parts) as pool:
        return list(pool.map(encode, range(parts)))


class FeedClock:
    """Shared wall ↔ event-time mapping (bench.py's ``_FeedClock``):
    wall(E) = t0 + (E - EVENT_T0) / 1000 scaled by the feed pace (events
    a second; the stream holds 1M rows an event-second, so a slower pace
    stretches event time onto the wall)."""

    def __init__(self, pace_events_per_sec: float):
        self.t0 = None
        self.scale = EVENTS_PER_SEC / float(pace_events_per_sec)

    def start(self):
        if self.t0 is None:
            self.t0 = time.perf_counter()
        return self.t0

    def wall_of(self, event_ms: float) -> float:
        return self.t0 + (event_ms - EVENT_T0) / 1000.0 * self.scale


class GcFence:
    """bench.py's ``_GcFence``: move the harness's permanent objects (the
    staged records) out of the collector's scan set, and record the
    collections that still run, so their pauses are reported, not charged
    to the engine unseen.  ``install()``/``remove()``; ``remove()`` is
    idempotent."""

    def __init__(self, pauses: list):
        self._pauses = pauses
        self._t0 = 0.0
        self._installed = False

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self._pauses.append((time.perf_counter() - self._t0) * 1000.0)

    def install(self):
        import gc

        gc.collect()
        gc.freeze()
        gc.callbacks.append(self._cb)
        self._installed = True

    def remove(self):
        import gc

        if not self._installed:
            return
        self._installed = False
        gc.callbacks.remove(self._cb)
        gc.unfreeze()


def consume_bounded(fn, deadline_s: float, label: str, on_timeout=None):
    """bench.py's ``_consume_bounded``: run the blocking consumer ``fn`` on
    a daemon thread with a hard wall deadline; past it, ``on_timeout``
    (the broker's teardown) unsticks the abandoned consumer so it cannot
    keep fetching into the next phase, and the phase fails."""
    result: dict = {}

    def run():
        try:
            result["value"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            result["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(deadline_s)
    if th.is_alive():
        if on_timeout is not None:
            on_timeout()
            th.join(30.0)
        raise AssertionError(f"{label}: no result within {deadline_s:.0f} s")
    if "error" in result:
        raise result["error"]
    return result.get("value")


def e2e_schema():
    from denormalized_tpu_torch.common.schema import DataType, Field, Schema

    return Schema([
        Field("occurred_at_ms", DataType.INT64, nullable=False),
        Field("sensor_name", DataType.STRING, nullable=False),
        Field("reading", DataType.FLOAT64),
    ])


def kafka_stream(device, bootstrap, topic,
                 aggs=("count", "min", "max", "avg"), fmt="json", **cfg):
    """bench.py's ``kafka_e2e`` pipeline: ``from_topic`` (JSON, or with
    ``fmt="avro"`` MEASUREMENT_AVRO records; event time from
    occurred_at_ms) → 1 s tumbling window by sensor_name, with a 1 s
    idleness policy → (ctx, DataStream)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F

    cfg.setdefault("source_idle_timeout_ms", 1000)
    ctx = tt.Context(tt.EngineConfig(device=str(device), **cfg))
    names = {"count": "count", "min": "min", "max": "max", "avg": "average"}
    payload = (dict(encoding="avro", avro_schema=MEASUREMENT_AVRO)
               if fmt == "avro" else dict(schema=e2e_schema()))
    ds = ctx.from_topic(
        topic, bootstrap_servers=bootstrap,
        timestamp_column="occurred_at_ms", **payload,
    ).window(
        ["sensor_name"],
        [getattr(F, a)(tt.col("reading")).alias(names[a]) for a in aggs],
        1000,
    )
    return ctx, ds


def make_broker(topic, entries=None):
    """A started mock broker (the port's own ``testing/mock_kafka.py``)
    with ``topic`` over KAFKA_PARTITIONS partitions, holding ``entries``
    (per partition) when given."""
    from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

    broker = MockKafkaBroker().start()
    broker.create_topic(topic, partitions=KAFKA_PARTITIONS)
    for p, e in enumerate(entries or ()):
        broker.append_staged(topic, p, e)
    return broker


def source_exec_of(ctx):
    from denormalized_tpu_torch.physical.simple_execs import SourceExec

    node = ctx._last_physical
    while not isinstance(node, SourceExec):
        (node,) = node.children
    return node


def closable_rows(stream, exp):
    """The oracle's rows of every window that can close (its end at or
    before the stream's last event: the idle hint moves event time only
    to the max seen) → (rows, last closable window start)."""
    max_ts = int(stream[0].max())
    rows = {k: v for k, v in exp.items() if k[0] + 1000 <= max_ts}
    return rows, max(k[0] for k in rows)


def check_native_path(ctx, what: str, fmt: str = "json"):
    """The native wire client and the native JSON (``fmt="avro"``: Avro)
    parser carried every row: each reader decodes through
    ``NativeJsonParser`` (``NativeAvroParser``) with no Python-decode or
    salvaged row, and the client and parser libraries are the ones built
    from ``native/kafka_client.cpp`` and ``native/<fmt>_parser.cpp``."""
    from denormalized_tpu_torch.formats.native_avro import NativeAvroParser
    from denormalized_tpu_torch.formats.native_json import NativeJsonParser
    from denormalized_tpu_torch.native import build as native_build

    parser = NativeAvroParser if fmt == "avro" else NativeJsonParser
    src = source_exec_of(ctx)
    readers = [w.reader for w in src._pump.workers]
    for r in readers:
        if type(r._decoder._native) is not parser:
            raise AssertionError(f"{what}: a reader decodes without "
                                 f"{parser.__name__}")
        if r.decode_fallback_rows() or r.salvaged_rows:
            raise AssertionError(
                f"{what}: {r.decode_fallback_rows()} rows through the Python "
                f"decoder, {r.salvaged_rows} salvaged")
    want = {"kafka_client", f"{fmt}_parser"}
    libs = [k for k in native_build._CACHE if k[0] in want]
    if {k[0] for k in libs} != want:
        raise AssertionError(f"{what}: native libraries loaded: {libs}")
    return src.metrics()


def phase_kafka_e2e(device, stream, card, fmt="json", phase=21):
    """Phase 21: bench.py's ``kafka_e2e`` on phase 4's stream: its JSON
    records produced into a 4-partition topic, interleaved by partition,
    then ``from_topic`` → the dense window on the card through the native
    client, the native parser and four prefetch workers, after a warm-up
    on a broker of its own.  Every closable window against the oracle;
    late rows 0, no Python-decoded row, dense launches = the window's
    batches → rows/s.  Phase 29 runs it with ``fmt="avro"``: the stream
    as MEASUREMENT_AVRO records (readings exact float64), decoded by the
    native Avro parser."""
    from denormalized_tpu_torch.common.constants import WINDOW_START_COLUMN
    from denormalized_tpu_torch.ops import dense_window as dw

    ts, kid, val = stream
    t0 = time.perf_counter()
    entries = encode_topic(stream, KAFKA_PARTITIONS, KAFKA_RECORDS_PER_BATCH,
                           fmt=fmt)
    warm = encode_topic(tuple(a[:KAFKA_WARM_ROWS] for a in stream),
                        KAFKA_PARTITIONS, KAFKA_RECORDS_PER_BATCH, fmt=fmt)
    encode_s = time.perf_counter() - t0
    # JSON carries readings to 6 decimals; Avro carries the float64
    exp = oracle(ts, kid, val if fmt == "avro" else np.round(val, 6), 1000,
                 1000, NUM_KEYS)
    need, last_ws = closable_rows(stream, exp)
    warm_last = closable_rows(tuple(a[:KAFKA_WARM_ROWS] for a in stream),
                              exp)[1]

    def drain(ds, stop_ws, rows):
        it = ds.stream()
        try:
            for b in it:
                if b.num_rows and b.schema.has(WINDOW_START_COLUMN):
                    rows.update(tumbling_rows(b))
                    if int(np.max(b.column(WINDOW_START_COLUMN))) >= stop_ws:
                        return True
        finally:
            it.close()
        raise AssertionError(f"phase {phase}: the stream ended")

    wbroker = make_broker("warm", warm)
    try:
        _, wds = kafka_stream(device, wbroker.bootstrap, "warm", fmt=fmt)
        consume_bounded(lambda: drain(wds, warm_last, {}), 120.0,
                        f"phase {phase} warm-up", on_timeout=wbroker.stop)
    finally:
        wbroker.stop()
    del warm
    broker = make_broker("e2e", entries)
    got: dict = {}
    try:
        dw.dense_window_launches = 0
        t0 = time.perf_counter()
        ctx, ds = kafka_stream(device, broker.bootstrap, "e2e", fmt=fmt)
        consume_bounded(lambda: drain(ds, last_ws, got), KAFKA_DEADLINE_S,
                        f"phase {phase}", on_timeout=broker.stop)
        sync(device)
        wall = time.perf_counter() - t0
        launches = dw.dense_window_launches
        src = check_native_path(ctx, f"phase {phase}", fmt)
    finally:
        broker.stop()
    check_tumbling_rows(got, need)
    op = window_exec_of(ctx)
    m = op.metrics()
    b = op.backend
    if m["late_rows"]:
        raise AssertionError(f"phase {phase}: {m['late_rows']} late rows")
    if not (launches == m["batches_in"] == b.dense_updates > 0
            and b.scatter_updates == 0):
        raise AssertionError(
            f"phase {phase}: {launches} dense launches, {m['batches_in']} window "
            f"batches, dense_updates={b.dense_updates}, scatter_updates="
            f"{b.scatter_updates}")
    rate = len(ts) / wall
    log(f"phase {phase} kafka_e2e (from_topic, {KAFKA_PARTITIONS} partitions, "
        f"{fmt.upper()}, native client + parser, prefetch workers, auto): {len(ts)} "
        f"rows produced ({encode_s:.1f} s to encode), {len(got)} window rows "
        f"of every closable window match the oracle, wall {wall:.3f} s to "
        f"the last closable window, {rate:.0f} rows/s (bench.py's measure: "
        f"every produced row over that wall), {src['rows_out']} rows out of "
        f"the source by then; window batches "
        f"{m['batches_in']} of {m['rows_in']} rows (source batches of "
        f"{src['batch_rows_min']}-{src['batch_rows_max']} rows), dense "
        f"launches {launches}, late_rows {m['late_rows']}, "
        f"decode_fallback_rows {src['decode_fallback_rows']}, salvaged "
        f"{src['salvaged_rows']}, prefetch_restarts "
        f"{src['prefetch_restarts']}; window host prep "
        f"{m['host_prep_s']:.3f} s, decode {src['decode_s']:.3f} s and fetch "
        f"{src['fetch_s']:.3f} s summed over the {KAFKA_PARTITIONS} reader "
        f"threads; interner lane {op._interner.lanes[0]} ({card})")
    return {"rows_per_s": rate, "wall": wall, "launches": launches}


def phase_kafka_latency(device, seed, rows_per_s, card):
    """Phase 22: BASELINE's window latency.  A paced producer thread feeds
    a fresh topic at min(1M, 0.6 x phase 21's rows/s) rows a second
    (bench.py's rule), a LAT_CHUNK-row chunk at a time; latency = the wall
    of a window's emission − the wall of its close, one sample per
    window → (pace, staged chunks, stream) for phase 23."""
    from denormalized_tpu_torch.common.constants import WINDOW_END_COLUMN

    pace = min(EVENTS_PER_SEC, 0.6 * rows_per_s)
    stream = gen_stream(LAT_ROWS, LAT_CHUNK, NUM_KEYS, seed)
    t0 = time.perf_counter()
    staged = encode_topic(stream, KAFKA_PARTITIONS, None, LAT_CHUNK)
    encode_s = time.perf_counter() - t0
    n_chunks = max(len(s) for s in staged)
    # a chunk is due at the wall time of its last event (bench.py's feed
    # assumes exactly 1M rows an event-second, 2.4% off gen_stream's
    # 8 ms a 8,192-row chunk, and lags ~24 ms more each window)
    due_ms = stream[0][LAT_CHUNK - 1::LAT_CHUNK]
    n_windows = LAT_ROWS // EVENTS_PER_SEC - 2
    clock = FeedClock(pace)
    pauses: list = []
    fence = GcFence(pauses)
    broker = make_broker("lat")
    stop = threading.Event()

    def feed():
        clock.start()
        for ci in range(n_chunks):
            due = clock.wall_of(float(due_ms[ci]))
            if stop.wait(max(0.0, due - time.perf_counter())):
                return
            for p in range(KAFKA_PARTITIONS):
                if ci < len(staged[p]):
                    broker.append_staged("lat", p, staged[p][ci])
        feed_end[0] = time.perf_counter()

    lats: list = []
    seen: set = set()
    feed_end = [None]
    feeder = threading.Thread(target=feed, daemon=True)
    try:
        ctx, ds = kafka_stream(device, broker.bootstrap, "lat",
                               aggs=("count", "avg"))
        fence.install()

        def sample():
            it = ds.stream()
            feeder.start()
            try:
                for b in it:
                    now = time.perf_counter()
                    if not b.num_rows or not b.schema.has(WINDOW_END_COLUMN):
                        continue
                    for e in np.unique(np.asarray(b.column(WINDOW_END_COLUMN))):
                        if int(e) not in seen:
                            seen.add(int(e))
                            lats.append((now - clock.wall_of(float(e))) * 1e3)
                    if len(seen) >= n_windows:
                        return True
            finally:
                it.close()
            raise AssertionError("phase 22: the stream ended")

        consume_bounded(sample, LAT_ROWS / pace + 120, "phase 22",
                        on_timeout=broker.stop)
        m = window_exec_of(ctx).metrics()
        src = source_exec_of(ctx).metrics()
    finally:
        stop.set()
        fence.remove()
        broker.stop()
        if feeder.is_alive():
            feeder.join(30)
    a = np.asarray(lats)
    if len(a) < 20 or m["late_rows"]:
        raise AssertionError(f"phase 22: {len(a)} samples, "
                             f"{m['late_rows']} late rows")
    slope = float(np.polyfit(np.arange(a.size), a, 1)[0])
    fed = (f"{len(stream[0]) / (feed_end[0] - clock.t0):.0f} rows/s fed"
           if feed_end[0] else "the feed was cut at the last sample")
    log(f"phase 22 window latency (paced from_topic, {KAFKA_PARTITIONS} "
        f"partitions, count+avg, 1 s tumbling; {LAT_ROWS} rows over "
        f"{LAT_ROWS // EVENTS_PER_SEC} s of event time, {encode_s:.1f} s to "
        f"encode): pace {pace:.0f} rows/s ({fed}), {a.size} samples, p50 "
        f"{np.percentile(a, 50):.2f} ms, p99 {np.percentile(a, 99):.2f} ms, "
        f"max {a.max():.2f} ms, drift {slope:.2f} ms a window, gc pauses "
        f"{len(pauses)} (max {max(pauses, default=0.0):.1f} ms), late_rows "
        f"{m['late_rows']}; window batches {m['batches_in']} of "
        f"{m['rows_in'] / max(1, m['batches_in']):.0f} rows on average "
        f"(source batches of {src['batch_rows_min']}-"
        f"{src['batch_rows_max']} rows), window host prep "
        f"{m['host_prep_s']:.3f} s, decode {src['decode_s']:.3f} s over the "
        f"reader threads ({card})")
    return pace, staged, stream


def kafka_child(args) -> int:
    """Phase 23's child: the kafka_e2e job checkpointed to
    ``--kafka-child`` (barriers every 0.5 s) over the parent's broker.  One
    flushed JSON line per emitted window row, per committed epoch, and for
    the restore (a watcher thread sees the coordinator once the executor
    has wired and restored it)."""
    from denormalized_tpu_torch.common.constants import WINDOW_START_COLUMN

    t_main = time.time()
    device = torch.device(args.ckpt_device)
    out = open(args.kafka_out, "a", buffering=1)
    lock = threading.Lock()

    def line(**kw):
        with lock:
            out.write(json.dumps(kw) + "\n")

    ctx, ds = kafka_stream(device, args.kafka_broker, args.kafka_topic,
                           checkpoint=True,
                           checkpoint_interval_s=0.5,
                           state_backend_path=args.kafka_child)

    def watch():
        while ctx.last_checkpointing()[0] is None:
            time.sleep(0.005)
        coord = ctx.last_checkpointing()[0]
        line(event="restored", t=time.time(), t_start=T_START,
             t_main=t_main, epoch=coord.restored_epoch)
        seen = coord.restored_epoch
        while True:
            e = coord.committed_epoch
            if e is not None and e != seen:
                seen = e
                line(event="commit", epoch=e, t=time.time())
            time.sleep(0.01)

    threading.Thread(target=watch, daemon=True).start()
    line(event="ready", t=time.time())
    first = True
    for b in ds.stream():
        if not b.num_rows or not b.schema.has(WINDOW_START_COLUMN):
            continue
        rows = tumbling_rows(b)
        if first:
            first = False
            line(event="first_row", t=time.time())
        t = time.time()
        for (ws, k), (c, mn, mx, a) in rows.items():
            line(event="row", ws=ws, k=k, c=c, mn=mn, mx=mx, a=a, t=t)
    return 0


def phase_kafka_ckpt(device, pace, staged, stream, card):
    """Phase 23: config 5 over Kafka (the twin of tests/test_checkpoint.py's
    SIGKILL test on the card).  Phase 22's first CKPT_KAFKA_ROWS rows are
    fed to a fresh topic at phase 22's pace; a checkpointed child is
    SIGKILLed after it committed an epoch past its first two windows; a
    second child restores on the same store and runs until the union of
    both children's rows covers every closable window.  The union equals
    the oracle, the restart re-emits fewer windows than the oracle has
    (no full reprocess) → the time to recover."""
    import os
    import shutil
    import signal
    import tempfile

    n_chunks = CKPT_KAFKA_ROWS // LAT_CHUNK
    sub = tuple(a[: n_chunks * LAT_CHUNK] for a in stream)
    exp = oracle(sub[0], sub[1], np.round(sub[2], 6), 1000, 1000, NUM_KEYS)
    need, _ = closable_rows(sub, exp)
    work = tempfile.mkdtemp(prefix="dnz_kafka_ckpt_")
    state = os.path.join(work, "state")
    broker = make_broker("ckpt")
    clock = FeedClock(pace)
    stop = threading.Event()
    procs = []

    due_ms = sub[0][LAT_CHUNK - 1::LAT_CHUNK]

    def feed():
        clock.start()
        for ci in range(n_chunks):
            due = clock.wall_of(float(due_ms[ci]))
            if stop.wait(max(0.0, due - time.perf_counter())):
                return
            for p in range(KAFKA_PARTITIONS):
                broker.append_staged("ckpt", p, staged[p][ci])

    def spawn(name):
        out = os.path.join(work, f"{name}.jsonl")
        err = open(os.path.join(work, f"{name}.err"), "w")
        t = time.time()
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ckpt-device",
             str(device), "--kafka-child", state, "--kafka-broker",
             broker.bootstrap, "--kafka-topic", "ckpt", "--kafka-out", out],
            stdout=subprocess.DEVNULL, stderr=err,
        )
        procs.append(p)
        return p, out, t

    def tail(name):
        with open(os.path.join(work, f"{name}.err")) as f:
            return f.read()[-3000:]

    def wait_for(p, name, out, cond, what, timeout=180):
        deadline = time.time() + timeout
        while True:
            lines = read_jsonl(out)
            if cond(lines):
                return lines
            if p.poll() is not None:
                raise AssertionError(f"phase 23: child {name} exited "
                                     f"({p.returncode}) {what}: {tail(name)}")
            if time.time() > deadline:
                raise AssertionError(f"phase 23: child {name} {what}")
            time.sleep(0.05)

    def rows(lines):
        return {(d["ws"], d["k"]): (d["c"], d["mn"], d["mx"], d["a"])
                for d in lines if d["event"] == "row"}

    feeder = threading.Thread(target=feed, daemon=True)
    try:
        pa, out_a, _ = spawn("a")
        wait_for(pa, "a", out_a, lambda ls: any(
            d["event"] == "ready" for d in ls), "before it was ready")
        feeder.start()

        def killable(ls):
            # a commit logged 0.2 s after the second window's first row:
            # that epoch's barrier passed the window after both windows
            # emitted, so the restart resumes past them
            first_t: dict = {}
            for d in ls:
                if d["event"] == "row":
                    first_t.setdefault(d["ws"], d["t"])
            if len(first_t) < 2:
                return False
            t2 = sorted(first_t.items())[1][1]
            return any(d["event"] == "commit" and d["t"] > t2 + 0.2
                       for d in ls)

        wait_for(pa, "a", out_a, killable, "never committed after two "
                 "windows")
        os.kill(pa.pid, signal.SIGKILL)
        pa.wait(60)
        a = read_jsonl(out_a)
        commits = [d["epoch"] for d in a if d["event"] == "commit"]
        pb, out_b, t_spawn = spawn("b")

        def covered(ls):
            union = rows(a)
            union.update(rows(ls))
            return set(need) <= set(union)

        b = wait_for(pb, "b", out_b, covered, "never covered every closable "
                     "window", timeout=300)
        os.kill(pb.pid, signal.SIGKILL)
        pb.wait(60)
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(60)
        broker.stop()
        shutil.rmtree(work, ignore_errors=True)
    restored = next(d for d in b if d["event"] == "restored")
    first = next(d for d in b if d["event"] == "first_row")
    rows_a, rows_b = rows(a), rows(b)
    union = dict(rows_a)
    union.update(rows_b)
    check_tumbling_rows({k: v for k, v in union.items() if k in need}, need)
    if restored["epoch"] != commits[-1]:
        raise AssertionError(f"phase 23: restored epoch {restored['epoch']}, "
                             f"child A's last commit {commits[-1]}")
    if not set(rows_a) - set(rows_b):
        raise AssertionError("phase 23: the restart re-emitted every window "
                             "child A emitted (a full reprocess)")
    log(f"phase 23 config 5 over Kafka ({CKPT_KAFKA_ROWS} rows fed at "
        f"{pace:.0f} rows/s to {KAFKA_PARTITIONS} partitions, barriers every "
        f"0.5 s): child A committed {len(commits)} epochs, emitted "
        f"{len(rows_a)} rows and was SIGKILLed; child B restored epoch "
        f"{restored['epoch']} and emitted {len(rows_b)} rows; the union "
        f"matches the oracle on all {len(need)} rows of the closable windows; "
        f"{len(set(rows_a) - set(rows_b))} of A's rows were not re-emitted; "
        f"time to recover: {restored['t'] - t_spawn:.3f} s from spawn to "
        f"restore done ({restored['t_start'] - t_spawn:.3f} s to the "
        f"script's first line, {restored['t_main'] - restored['t_start']:.3f}"
        f" s of imports), {first['t'] - t_spawn:.3f} s to the first emission "
        f"({card})")


# -- phase 24: configs 4 and 5 together (a checkpointed join) -----------------

JOIN_CKPT_PAUSE_READS = 2  # left reads the killed child makes after commit 2


def join_child(args) -> int:
    """Phase 24's child: phase 14's join (phase 4's stream on the left, one
    from --seed + 1 on the right, ``auto``) checkpointed to
    ``--join-child`` with a barrier every CKPT_EVERY left reads.  One
    flushed JSON line per joined row, per committed epoch (with the join's
    snapshot counters and the commit histogram so far), and for the
    restore; with ``--join-pause-after N`` both sources stop reading
    JOIN_CKPT_PAUSE_READS left reads after the N-th commit, until the
    parent's SIGKILL."""
    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.state import checkpoint as ck

    t_main = time.time()
    device = torch.device(args.ckpt_device)
    left = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, args.seed)
    right = gen_stream(TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, args.seed + 1)
    lb = to_batches(*left, BATCH_ROWS, NUM_KEYS)
    rb = to_batches(*right, BATCH_ROWS, NUM_KEYS)
    t_data = time.time()
    out = open(args.join_out, "a", buffering=1)
    lock = threading.RLock()  # on_read writes lines while holding it
    commit_ms = obs.histogram("dnz_checkpoint_commit_ms")

    def line(**kw):
        with lock:
            out.write(json.dumps(kw) + "\n")

    st = {"restored": False, "commits": [], "after": 0, "paused": False}

    def on_read(ctx, side, i):
        coord = ctx.last_checkpointing()[0]
        with lock:
            if not st["restored"]:
                st["restored"] = True
                root = ctx._last_physical
                ids = ck.assign_node_ids(root)
                pos = []
                for op in ck.walk(root):
                    if not op.children:
                        off = ck.get_json(coord, f"offsets_{ids[id(op)]}")
                        pos.append(off["partitions"][0]["pos"] if off else 0)
                line(event="restored", t=time.time(), t_start=T_START,
                     t_main=t_main, t_data=t_data,
                     epoch=coord.restored_epoch, pos=pos,
                     restore_s=join_ops(ctx)[0].metrics()["restore_s"])
            if side == 0:
                e = coord.committed_epoch
                if e is not None and e != coord.restored_epoch and (
                        e not in st["commits"]):
                    st["commits"].append(e)
                    m = join_ops(ctx)[0].metrics()
                    line(event="commit", epoch=e, read=i,
                         snapshots=m["snapshots"],
                         snapshot_bytes=m["snapshot_bytes"],
                         pack_s=m["snapshot_pack_s"],
                         put_s=m["snapshot_put_s"], commits=commit_ms.count,
                         commit_ms=commit_ms.sum)
                if args.join_pause_after and (
                        len(st["commits"]) >= args.join_pause_after):
                    st["after"] += 1
                    if st["after"] > JOIN_CKPT_PAUSE_READS:
                        st["paused"] = True
                        line(event="paused", read=i)
                if i % CKPT_EVERY == CKPT_EVERY - 1:
                    ctx.last_checkpointing()[1].trigger_now()
        while st["paused"]:  # both sides, until the parent's SIGKILL
            time.sleep(1)

    ctx, ds = join_stream(device, lb, rb, "auto", on_read,
                          **ckpt_config(args.join_child))
    dw.dense_window_launches = 0
    first = True
    for b in ds.stream():
        rows = join_rows(b)
        if first and rows:
            first = False
            line(event="first_row", t=time.time())
        for (ws, k), (a, h) in rows.items():
            line(event="row", ws=ws, k=k, a=a, h=h)
    sync(device)
    join, windows = join_ops(ctx)
    m = join.metrics()
    line(event="done", batches=[w.metrics()["batches_in"] for w in windows],
         launches=dw.dense_window_launches,
         dense_updates=[w.backend.dense_updates for w in windows],
         snapshots=m["snapshots"], snapshot_bytes=m["snapshot_bytes"],
         pack_s=m["snapshot_pack_s"], put_s=m["snapshot_put_s"],
         commits=commit_ms.count, commit_ms=commit_ms.sum)
    return 0


def phase_join_ckpt(device, seed: int, left, right, card):
    """Phase 24: configs 4 and 5 together on phase 14's streams.  A child
    commits two epochs and is SIGKILLed with more than a third of both
    streams unread; a second child restores the join (both windows' rings
    onto the card, the join's retained rows re-interned) and runs to the
    end.  The union of their joined rows against phase 14's oracle; the
    time to recover; the snapshot's bytes and pack, put and commit times."""
    import os
    import shutil
    import signal
    import tempfile

    (lb, ls), (_rb, rs) = left, right
    n_batches = len(lb)
    work = tempfile.mkdtemp(prefix="dnz_join_ckpt_")
    state = os.path.join(work, "state")
    procs = []

    def spawn(name, *extra):
        out = os.path.join(work, f"{name}.jsonl")
        err = open(os.path.join(work, f"{name}.err"), "w")
        t = time.time()
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--ckpt-device", str(device), "--join-child", state,
             "--join-out", out, *extra],
            stdout=subprocess.DEVNULL, stderr=err,
        )
        procs.append(p)
        return p, out, t

    def tail(name):
        with open(os.path.join(work, f"{name}.err")) as f:
            return f.read()[-3000:]

    try:
        pa, out_a, _ = spawn("a", "--join-pause-after", "2")
        deadline = time.time() + 300
        while not any(d["event"] == "paused" for d in read_jsonl(out_a)):
            if pa.poll() is not None:
                raise AssertionError(
                    f"phase 24: child A exited ({pa.returncode}) before its "
                    f"second commit: {tail('a')}")
            if time.time() > deadline:
                raise AssertionError("phase 24: child A never paused")
            time.sleep(0.05)
        os.kill(pa.pid, signal.SIGKILL)
        pa.wait(60)
        a = read_jsonl(out_a)
        commits = [d for d in a if d["event"] == "commit"]
        # paused before that left read (rows of batches read before the
        # pause may still follow the line)
        unread = n_batches - next(
            d["read"] for d in a if d["event"] == "paused")
        if pa.returncode != -signal.SIGKILL or len(commits) != 2 or (
                unread < n_batches / 3):
            raise AssertionError(
                f"phase 24: child A rc {pa.returncode}, {len(commits)} "
                f"commits, {unread} of {n_batches} left batches unread")
        pb, out_b, t_spawn = spawn("b")
        if pb.wait(600) != 0:
            raise AssertionError(f"phase 24: child B failed: {tail('b')}")
        b = read_jsonl(out_b)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(60)
        shutil.rmtree(work, ignore_errors=True)

    restored, done = b[0], b[-1]
    first = next(d for d in b if d["event"] == "first_row")

    def rows(lines):
        return {(d["ws"], d["k"]): (d["a"], d["h"])
                for d in lines if d["event"] == "row"}

    rows_a, rows_b = rows(a), rows(b)
    union = dict(rows_a)
    union.update(rows_b)
    joined = check_join_rows(union, ls, rs, NUM_KEYS)
    if restored["epoch"] != commits[-1]["epoch"]:
        raise AssertionError(f"phase 24: restored epoch {restored['epoch']},"
                             f" last commit {commits[-1]['epoch']}")
    if not len(rows_b) < joined or min(restored["pos"]) == 0:
        raise AssertionError(f"phase 24: the restart reprocessed the stream "
                             f"({len(rows_b)} of {joined} rows, restored at "
                             f"{restored['pos']})")
    read_b = sum(done["batches"])
    if not (read_b == done["launches"] == sum(done["dense_updates"])
            == 2 * n_batches - sum(restored["pos"])):
        raise AssertionError(f"phase 24: restart read from "
                             f"{restored['pos']}: {done}")
    last = commits[-1]
    log(f"phase 24 configs 4 and 5 together (phase 14's join, auto, barrier "
        f"every {CKPT_EVERY} left batches): child A committed epochs "
        f"{[d['epoch'] for d in commits]} and was SIGKILLed with {unread} of "
        f"{n_batches} left batches unread, {len(rows_a)} joined rows "
        f"emitted; child B restored epoch {restored['epoch']} at batches "
        f"{restored['pos']} (join restore {restored['restore_s'] * 1e3:.3f} "
        f"ms: read, unpack, re-intern, rebuild), read {done['batches']} "
        f"batches with {done['launches']} dense launches, emitted "
        f"{len(rows_b)} rows; the union matches the oracle ({joined} joined "
        f"rows); time to recover: {restored['t'] - t_spawn:.3f} s from "
        f"spawn to restore done ({restored['t_main'] - restored['t_start']:.3f}"
        f" s of imports, {restored['t_data'] - restored['t_main']:.3f} s "
        f"making the streams), {first['t'] - t_spawn:.3f} s to the first "
        f"joined row; child A's join snapshots: {last['snapshots']} of "
        f"{last['snapshot_bytes'] / max(last['snapshots'], 1):.0f} B, pack "
        f"{last['pack_s'] / max(last['snapshots'], 1) * 1e3:.3f} ms, "
        f"frame+CRC+put {last['put_s'] / max(last['snapshots'], 1) * 1e3:.3f}"
        f" ms, {last['commits']} commits of "
        f"{last['commit_ms'] / max(last['commits'], 1):.3f} ms; child B: "
        f"{done['snapshots']} snapshots ({card})")


def phase_join_ckpt_highcard(device, left, right, card):
    """Phase 24, second half: config 4 at phase 15's 100K keys a side
    (``auto``), in this process: a barrier before left read 8, a crash
    right after its commit, then a restore on the same store and a run to
    the end; the union of the two runs' joined rows against the oracle,
    with the join's snapshot (bytes, pack, put) and restore timed."""
    import os
    import shutil
    import tempfile

    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.common.record_batch import RecordBatch
    from denormalized_tpu_torch.logical import plan as lp
    from denormalized_tpu_torch.physical.base import Marker
    from denormalized_tpu_torch.physical.simple_execs import CollectSink
    from denormalized_tpu_torch.runtime import executor
    from denormalized_tpu_torch.state import checkpoint as ck
    from denormalized_tpu_torch.state.lsm import close_global_state_backend
    from denormalized_tpu_torch.state.orchestrator import Orchestrator

    (lb, ls), (rb, rs) = left, right
    work = tempfile.mkdtemp(prefix="dnz_join_ckpt3_")
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS,
               **ckpt_config(os.path.join(work, "state")))
    commit_ms = obs.histogram("dnz_checkpoint_commit_ms")

    def build(on_read=None):
        ctx, ds = join_stream(device, lb, rb, "auto", on_read, **cfg)
        root = executor.build_physical(lp.Sink(ds._plan, CollectSink()), ctx)
        ctx._last_physical = root
        orch = Orchestrator(interval_s=1e9)
        coord = ck.wire_checkpointing(root, ctx, orch)
        ctx._checkpointing = (coord, orch)
        return ctx, root, orch, coord

    try:
        hold = {}

        def trigger(ctx, side, i):
            if side == 0 and i == 8:
                hold["orch"].trigger_now()

        ctx, root, orch, coord = build(trigger)
        hold["orch"] = orch
        rows_a, epoch = {}, None
        c0, s0 = commit_ms.count, commit_ms.sum
        it = root.run()
        for item in it:
            if isinstance(item, RecordBatch):
                rows_a.update(join_rows(item))
            if isinstance(item, Marker):
                coord.commit(item.epoch)
                epoch = item.epoch
                break
        if epoch is None:
            raise AssertionError("phase 24 (100K keys): no epoch committed")
        snap = join_ops(ctx)[0].metrics()
        commit = (commit_ms.sum - s0) / max(commit_ms.count - c0, 1)
        it.close()  # the crash
        orch.stop()
        close_global_state_backend()

        ctx, root, orch, coord = build()
        rows_b = {}
        t0 = time.perf_counter()
        for item in root.run():
            if isinstance(item, RecordBatch):
                rows_b.update(join_rows(item))
        sync(device)
        wall = time.perf_counter() - t0
        orch.stop()
        close_global_state_backend()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    join, windows = join_ops(ctx)
    m = join.metrics()
    union = dict(rows_a)
    union.update(rows_b)
    joined = check_join_rows(union, ls, rs, HIGHCARD_KEYS)
    if coord.restored_epoch != epoch or m["restore_s"] == 0:
        raise AssertionError(f"phase 24 (100K keys): restored epoch "
                             f"{coord.restored_epoch} of {epoch}")
    log(f"phase 24 config 4 at {HIGHCARD_KEYS} keys a side (auto): a "
        f"snapshot of the join's state at epoch {epoch} ({snap['rows_in']} "
        f"rows in): {snap['snapshot_bytes']} B, pack "
        f"{snap['snapshot_pack_s'] * 1e3:.3f} ms, frame+CRC+put "
        f"{snap['snapshot_put_s'] * 1e3:.3f} ms, commit {commit:.3f} ms; "
        f"the restore {m['restore_s'] * 1e3:.3f} ms (read, unpack, "
        f"re-intern, rebuild); the restarted run read "
        f"{[w.metrics()['batches_in'] for w in windows]} batches in "
        f"{wall:.3f} s; the union matches the oracle ({joined} joined rows, "
        f"{len(rows_a)} before the crash, {len(rows_b)} after) ({card})")
    return dict(snapshot_bytes=snap["snapshot_bytes"],
                pack_ms=snap["snapshot_pack_s"] * 1e3,
                put_ms=snap["snapshot_put_s"] * 1e3, commit_ms=commit,
                restore_ms=m["restore_s"] * 1e3)


# -- phase 25: the compaction kernel ------------------------------------------

COMPACT_KERNEL = "compact_slot_"
COMPACT_G = 131_072
# case: (active share, ring float type)
COMPACT_CASES = {
    "none": (0.0, torch.float32),
    "sparse_0.1pct": (0.001, torch.float32),
    "share_10pct": (0.1, torch.float32),
    "cfg3_76pct": (HIGHCARD_KEYS / COMPACT_G, torch.float32),
    "full": (1.0, torch.float32),
    "cfg3_76pct_f64": (HIGHCARD_KEYS / COMPACT_G, torch.float64),
}


def compact_case(share: float, accum, seed: int):
    """A seeded (4, COMPACT_G) ring of count/sum/min/max/avg planes whose
    slot 1 has ``share`` of its cells active (exactly round(share·G),
    at seeded places), with nulls (per-column counts below the row
    counts), valid NaNs and ±inf extrema → (spec, host ring)."""
    from denormalized_tpu_torch.ops import segment_agg as sa

    rng = np.random.default_rng(seed)
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(
            [("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 0)])),
        num_value_cols=1, window_slots=4, group_capacity=COMPACT_G,
        length_ms=1000, slide_ms=1000, accum_dtype=accum)
    fdt = np.float64 if accum == torch.float64 else np.float32
    W, G = 4, COMPACT_G
    active = np.zeros((W, G), bool)
    for w in range(W):
        active[w, rng.choice(G, int(round(share * G)), replace=False)] = True
    rc = np.where(active, rng.integers(1, 40, (W, G)), 0).astype(np.int32)
    host = {"count_star": rc,
            "count_0": np.maximum(rc - rng.integers(0, 2, (W, G)), 0
                                  ).astype(np.int32),
            "sum_0": np.where(active, rc * rng.normal(50, 10, (W, G)), 0
                              ).astype(fdt)}
    for kind, fill in (("min", np.inf), ("max", -np.inf)):
        host[f"{kind}_0"] = np.where(active, rng.normal(50, 10, (W, G)),
                                     fill).astype(fdt)
    for label in ("sum_0", "min_0", "max_0"):
        host[label][1, rng.choice(G, 4, replace=False)] = np.nan
    return spec, host


def compact_bound(counts_row, planes) -> float:
    """Least time for one compaction: the bytes over the HBM rate — the
    row-count plane read once (G × 4 B), and for each active cell its gid
    written (4 B) and its value in every other plane read and written once
    (the row count is written too)."""
    k = int((counts_row > 0).sum())
    per_cell = 4 + 4 + sum(2 * p.element_size() for p in planes[1:])
    return (4 * counts_row.numel() + k * per_cell) / HBM_BYTES_PER_S * 1e3


def compact_device_ms(fn, n: int = 50, warm: int = 20):
    """Device time of one compaction by the profiler, apart from the
    wrapper → (ms, how, kernel names).  A compaction is ONE launch: the
    profiler must record a single compaction kernel name and no more
    compaction kernels than calls.  After PROFILER_TRIES sessions short of
    n calls' kernels, by ``queued_event_ms``.  The tracer can miss a
    session's first ~20 launches, hence the long warm-up."""
    fn()
    torch.cuda.synchronize()
    names: set = set()
    for _ in range(PROFILER_TRIES):
        def run():
            for _ in range(warm):
                fn()
            torch.cuda.synchronize()
            for _ in range(n):
                fn()

        evts = sorted((e for e in device_events(profile(run))
                       if COMPACT_KERNEL in e.name),
                      key=lambda e: e.time_range.start)
        names |= {e.name for e in evts}
        if len(names) > 1 or len(evts) > warm + n:
            raise AssertionError(f"the profiler recorded {len(evts)} "
                                 f"compaction kernels of {len(names)} names "
                                 f"for {warm + n} calls: {sorted(names)}")
        if len(evts) >= n:
            last = evts[-n:]
            return (sum(e.time_range.elapsed_us() for e in last) / n / 1e3,
                    "profiler", sorted(names))
        log(f"the profiler recorded {len(evts)} compaction kernels of "
            f"{warm + n}, fewer than the {n} timed")
    return queued_event_ms(fn, n), "CUDA events", sorted(names)


def read_compact_ms(spec, state, slot: int, device, iters: int = 50
                    ) -> float:
    """Host wall of one ``segment_agg.read_slot_compact`` (the kernel, the
    count's read, the prefix copies and their one synchronize), after a
    warm-up, over ``iters`` calls."""
    from denormalized_tpu_torch.ops import segment_agg as sa

    for _ in range(5):
        sa.read_slot_compact(spec, state, slot)
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    for _ in range(iters):
        sa.read_slot_compact(spec, state, slot)
    return (time.perf_counter() - t) / iters * 1e3


def phase_compact_kernel(device, seed: int, card: str):
    """Phase 25, first half: ``compact_slot`` against its plain version on
    seeded rings at G = 131,072 and every active share of COMPACT_CASES:
    the same count, gids and plane values bit for bit (it is a copy) → per
    case {ms, ms_by, host_ms, plain_ms, library_ms, bound_ms, active}."""
    from denormalized_tpu_torch.ops import compact_slot as cs
    from denormalized_tpu_torch.ops import segment_agg as sa

    out = {}
    for i, (name, (share, accum)) in enumerate(COMPACT_CASES.items()):
        spec, host = compact_case(share, accum, seed + i)
        state = sa.import_state(spec, host, device)
        labels = [c.label for c in spec.components]
        counts = state["count_star"][1]
        planes = [state[lb][1] for lb in labels]
        before = cs.compact_slot_launches
        n, gids, outs = cs.compact_slot(counts, planes)
        torch.cuda.synchronize(device)
        if cs.compact_slot_launches - before != 1:
            raise AssertionError(f"phase 25 {name}: the kernel did not "
                                 f"launch once")
        rn, rgids, routs = cs.compact_slot_reference(counts, planes)
        k = int(n.item())
        if k != int(rn.item()) or k != int(round(share * COMPACT_G)):
            raise AssertionError(f"phase 25 {name}: {k} active, the plain "
                                 f"version {int(rn.item())}")
        if not torch.equal(gids[:k], rgids):
            raise AssertionError(f"phase 25 {name}: gids differ")
        for lb, o, r in zip(labels, outs, routs):
            ib = torch.int64 if o.element_size() == 8 else torch.int32
            if not torch.equal(o[:k].view(ib), r.view(ib)):
                raise AssertionError(f"phase 25 {name}: plane {lb} differs")

        def kernel():
            cs.compact_slot(counts, planes)

        def plain():
            cs.compact_slot_reference(counts, planes)

        def library():
            idx = torch.nonzero(counts > 0).squeeze(1)
            for p in planes:
                p.index_select(0, idx)

        ms, ms_by, names = compact_device_ms(kernel)
        out[name] = dict(
            active=k, ms=ms, ms_by=ms_by, kernel_names=names,
            host_ms=time_ms(kernel, device, iters=200),
            read_ms=read_compact_ms(spec, state, 1, device),
            plain_ms=time_ms(plain, device), library_ms=time_ms(library, device),
            bound_ms=compact_bound(counts, planes), bound_by="bytes",
            max_abs_err=0.0)
        c = out[name]
        log(f"phase 25 compact_slot {name}: G={COMPACT_G}, {k} active cells "
            f"({100 * k / COMPACT_G:.2f}%), {len(planes)} planes "
            f"({str(accum).replace('torch.', '')} ring): count, gids and "
            f"every plane equal the plain version bit for bit; device "
            f"{c['ms']:.5f} ms ({ms_by}, one launch a call: {names}), "
            f"wrapper {c['host_ms']:.4f} ms, read_slot_compact "
            f"{c['read_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, library "
            f"sequence (nonzero + index_select a plane) "
            f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.6f} ms "
            f"(bytes) ({card})")
    return out


def phase_compact_highcard(device, batches, stream, rates, card):
    """Phase 25, second half: config 3 (phase 10's stream) with
    ``emission_compaction=True`` through ``auto`` and ``partial_merge``,
    each against the oracle, with the compaction kernel's launches equal
    to the windows emitted → {strategy: {rows_per_s, launches}}."""
    from denormalized_tpu_torch.ops import compact_slot as cs

    ts, kid, val = stream
    exp = oracle(ts, kid, val, 1000, 1000, HIGHCARD_KEYS)
    out = {}
    for strategy in ("auto", "partial_merge"):
        cs.compact_slot_launches = 0
        ctx, res, wall = run_job(device, batches, "highcard",
                                 strategy=strategy, emission_compaction=True,
                                 min_group_capacity=2 * HIGHCARD_KEYS)
        launches = cs.compact_slot_launches
        check_highcard(res, exp, HIGHCARD_KEYS)
        op = window_exec_of(ctx)
        m = op.metrics()
        if launches == 0 or launches != m["windows_emitted"]:
            raise AssertionError(f"phase 25 config 3 via {strategy}: "
                                 f"{launches} compaction launches for "
                                 f"{m['windows_emitted']} windows emitted")
        out[strategy] = dict(rows_per_s=len(ts) / wall, launches=launches)
        log(f"phase 25 config 3 with emission_compaction via {strategy}: "
            f"{len(ts)} rows, {res.num_rows} window rows match the oracle, "
            f"{launches} compaction launches = {m['windows_emitted']} windows "
            f"emitted, {m['bytes_d2h']} B from the card, wall {wall:.3f} s, "
            f"{len(ts) / wall:.0f} rows/s against phase 10's "
            f"{rates[strategy]:.0f} without compaction ({card})")
    return out


def phase_compact_join(device, left, right, card) -> int:
    """Phase 25, third part: config 4 at config 3's key count (phase 15's
    streams) with ``emission_compaction=True`` through ``auto``.  Each
    window emits on its own pump thread, both onto one stream, so the two
    queue compactions at once.  Against the oracle, with the compaction
    launches equal to both windows' emissions → launches."""
    from denormalized_tpu_torch.ops import compact_slot as cs

    cs.compact_slot_launches = 0
    out = run_join(device, 25, "auto", left, right, HIGHCARD_KEYS, card,
                   emission_compaction=True,
                   min_group_capacity=2 * HIGHCARD_KEYS)
    launches = cs.compact_slot_launches
    _, windows = join_ops(out["ctx"])
    emitted = [w.metrics()["windows_emitted"] for w in windows]
    if launches == 0 or launches != sum(emitted):
        raise AssertionError(f"phase 25 config 4: {launches} compaction "
                             f"launches for {emitted} windows emitted")
    log(f"phase 25 config 4 with emission_compaction: {launches} compaction "
        f"launches = {emitted[0]} + {emitted[1]} windows emitted by the two "
        f"sides' threads, joined rows match the oracle, "
        f"{out['rows_per_s']:.0f} rows/s ({card})")
    return launches


# -- phase 26: the variance family ---------------------------------------------

VAR_NAMES = ("sd", "sdp", "va", "vp")


def variance_stream(device, batches, strategy, **cfg):
    """Phase 4's job with stddev, stddev_pop, var and var_pop of
    ``reading`` added, not yet run → (ctx, DataStream)."""
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device),
                                     device_strategy=strategy, **cfg))
    r = tt.col("reading")
    ds = ctx.from_source(MemorySource.from_batches(
        batches, timestamp_column="occurred_at_ms")).window(
        ["sensor_name"],
        [F.count(r).alias("count"), F.min(r).alias("min"),
         F.max(r).alias("max"), F.avg(r).alias("average"),
         F.stddev(r).alias("sd"), F.stddev_pop(r).alias("sdp"),
         F.var(r).alias("va"), F.var_pop(r).alias("vp")],
        1000)
    return ctx, ds


def variance_oracle(ts, kid, val, num_keys) -> dict:
    """{(window_start, key): (sample sd, pop sd, sample var, pop var)} in
    float64, two passes (mean, then squared deviations), ddof 1 for the
    sample kinds."""
    code = (ts // 1000) * num_keys + kid
    order = np.argsort(code, kind="stable")
    c, v = code[order], val[order]
    starts = np.flatnonzero(np.r_[True, c[1:] != c[:-1]])
    n = np.diff(np.r_[starts, len(c)]).astype(np.float64)
    mean = np.add.reduceat(v, starts) / n
    m2 = np.add.reduceat((v - np.repeat(mean, n.astype(np.int64))) ** 2,
                         starts)
    with np.errstate(invalid="ignore", divide="ignore"):
        va = np.where(n > 1, m2 / np.maximum(n - 1, 1), np.nan)
        vp = m2 / n
    out = {}
    for cc, a, b, x, y in zip(c[starts].tolist(), np.sqrt(va).tolist(),
                              np.sqrt(vp).tolist(), va.tolist(), vp.tolist()):
        j, key = divmod(cc, num_keys)
        out[(j * 1000, key)] = (a, b, x, y)
    return out


def phase_variance(device, batches, stream, card):
    """Phase 26: the variance family on phase 4's stream through ``auto``
    (the dense kernel: V = 3, the reading and its two pivot-shifted
    columns) and ``partial_merge``, against the numpy float64 oracle at
    rtol=1e-3 (counts, min and max exact, avg at rtol=1e-4); the dense
    launches equal the batches, the merge launches the merges.  Then the
    epoch-magnitude case of tests/test_functions.py:305 on the card."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp

    ts, kid, val = stream
    exp = oracle(ts, kid, val, 1000, 1000, NUM_KEYS)
    vexp = variance_oracle(ts, kid, val, NUM_KEYS)
    out = {}
    for strategy in ("auto", "partial_merge"):
        ctx, ds = variance_stream(device, batches, strategy)
        dw.dense_window_launches = 0
        mp.merge_partials_launches = 0
        t0 = time.perf_counter()
        res = ds.collect()
        sync(device)
        wall = time.perf_counter() - t0
        op = window_exec_of(ctx)
        b = op.backend
        if strategy == "auto":
            if not (dw.dense_window_launches == b.dense_updates
                    == len(batches)) or b.scatter_updates:
                raise AssertionError(
                    f"phase 26 auto: {dw.dense_window_launches} dense "
                    f"launches, dense_updates={b.dense_updates}, scatter="
                    f"{b.scatter_updates}, batches {len(batches)}")
            dispatch = f"{dw.dense_window_launches} dense launches"
        else:
            if mp.merge_partials_launches != b.merges or not b.merges:
                raise AssertionError(f"phase 26 partial_merge: "
                                     f"{mp.merge_partials_launches} merge "
                                     f"launches for {b.merges} merges")
            dispatch = f"{b.merges} merges = merge launches"
        check_tumbling(res, exp, NUM_KEYS)
        worst = 0.0
        for ws, name, *vs in zip(res.column("window_start_time").tolist(),
                                 res.column("sensor_name").tolist(),
                                 *(res.column(c).tolist() for c in VAR_NAMES)):
            want = vexp[(ws, int(name[7:]))]
            for got, w in zip(vs, want):
                if not np.isclose(got, w, rtol=1e-3, atol=0):
                    raise AssertionError(f"phase 26 {strategy} {(ws, name)}:"
                                         f" {vs} vs {want}")
                worst = max(worst, abs(got / w - 1))
        out[strategy] = dict(rows_per_s=len(ts) / wall,
                             launches=dw.dense_window_launches)
        log(f"phase 26 variance via {strategy}: {len(ts)} rows, "
            f"{res.num_rows} window rows: counts, min, max exact, avg "
            f"rtol=1e-4, stddev/stddev_pop/var/var_pop within rtol=1e-3 of "
            f"the float64 oracle (worst {worst:.3g}), pivot "
            f"{op._var_shift}, {dispatch}, value columns "
            f"{op._spec.num_value_cols}, wall {wall:.3f} s, "
            f"{len(ts) / wall:.0f} rows/s ({card})")

    # epoch magnitude: the naive s2 - s^2/c cancels to 0 here
    rng = np.random.default_rng(7)
    n = 2048
    e_ts = np.concatenate([np.sort(EVENT_T0 + b * 500 + rng.integers(0, 500, n))
                           for b in range(4)])
    e_val = 1.7e12 + rng.normal(0.0, 1000.0, 4 * n)
    e_batches = to_batches(e_ts, np.zeros(4 * n, np.int64), e_val, n, 1)
    for strategy in ("auto", "partial_merge"):
        _ctx, ds = variance_stream(device, e_batches, strategy)
        res = ds.collect()
        sds = res.column("sd").tolist()
        if not sds or not all(800.0 < x < 1200.0 for x in sds):
            raise AssertionError(f"phase 26 epoch magnitude via {strategy}: "
                                 f"stddev {sds}")
        log(f"phase 26 epoch magnitude via {strategy}: values ~1.7e12 with "
            f"sigma 1000 over {len(sds)} windows: stddev "
            f"{', '.join(f'{x:.1f}' for x in sds)} (800-1200) ({card})")
    return out


# -- phase 27: float64 rings ---------------------------------------------------


def f64_oracle(ts, kid, val, num_keys, values_f32: bool) -> dict:
    """{(window_start, key): (count, sum)} in float64 over the values the
    ring receives: the f32-rounded readings on row shipping (rows ship as
    f32 and widen on the card, the JAX package's rule), the readings
    themselves through partial_merge (the host reduces in f64)."""
    v = val.astype(np.float32).astype(np.float64) if values_f32 else val
    code = (ts // 1000) * num_keys + kid
    order = np.argsort(code, kind="stable")
    c, v = code[order], v[order]
    starts = np.flatnonzero(np.r_[True, c[1:] != c[:-1]])
    n = np.diff(np.r_[starts, len(c)])
    sums = np.add.reduceat(v, starts)
    return {(int(cc) // num_keys * 1000, int(cc) % num_keys): (int(k), float(s))
            for cc, k, s in zip(c[starts], n, sums)}


def phase_f64(device, batches, stream, card):
    """Phase 27: config 3 with ``accum_dtype=torch.float64`` through
    ``auto`` (the scatter path: the dense kernel is f32 only) and
    ``partial_merge`` (the merge kernel's f64 instantiation, launches
    counted), sums and averages against the float64 oracle at rtol=1e-10;
    the same stream in f32 misses that bound, and its worst error says by
    how much → the partial_merge run's merge launches."""
    from denormalized_tpu_torch.ops import merge_partials as mp

    ts, kid, val = stream
    cfg = dict(min_group_capacity=2 * HIGHCARD_KEYS)
    out = {}
    for strategy in ("auto", "partial_merge"):
        want = f64_oracle(ts, kid, val, HIGHCARD_KEYS,
                          values_f32=strategy == "auto")
        errs = {}
        for accum in (torch.float64, torch.float32):
            mp.merge_partials_launches = 0
            ctx, res, wall = run_job(device, batches, "highcard",
                                     strategy=strategy, accum_dtype=accum,
                                     **cfg)
            launches = mp.merge_partials_launches
            op = window_exec_of(ctx)
            got = highcard_rows(res)
            if set(got) != set(want):
                raise AssertionError(f"phase 27 {strategy}: row sets differ")
            keys = list(want)
            g = np.asarray([got[k] for k in keys], dtype=np.float64)
            w = np.asarray([want[k] for k in keys], dtype=np.float64)
            worst = float(max(np.abs(g[:, 0] / w[:, 1] - 1).max(),
                              np.abs(g[:, 1] / (w[:, 1] / w[:, 0]) - 1).max()))
            errs[accum] = worst
            if accum == torch.float64:
                planes = {str(t.dtype) for lb, t in op.backend._state.items()
                          if not lb.startswith("count")}
                if worst > 1e-10 or planes != {"torch.float64"}:
                    raise AssertionError(f"phase 27 {strategy} f64: worst "
                                         f"relative error {worst:.3g}, "
                                         f"planes {planes}")
                b = op.backend
                if strategy == "partial_merge":
                    if launches != b.merges or not b.merges:
                        raise AssertionError(f"phase 27: {launches} merge "
                                             f"launches for {b.merges} merges")
                    out["launches"] = launches
                    dispatch = f"{b.merges} merges = f64 merge launches"
                else:
                    if b.scatter_updates != len(batches) or b.dense_updates:
                        raise AssertionError(f"phase 27 auto f64: scatter="
                                             f"{b.scatter_updates}")
                    dispatch = f"{b.scatter_updates} scatter steps"
                out[strategy] = dict(rows_per_s=len(ts) / wall)
                f64_wall = wall
        if errs[torch.float32] <= 1e-10:
            raise AssertionError(f"phase 27 {strategy}: the f32 ring met the "
                                 f"f64 bound ({errs[torch.float32]:.3g})")
        log(f"phase 27 config 3 in float64 via {strategy}: {len(ts)} rows, "
            f"{len(want)} window rows, sums and averages within "
            f"{errs[torch.float64]:.3g} of the float64 oracle (bound 1e-10; "
            f"the same stream in float32: {errs[torch.float32]:.3g}), "
            f"{dispatch}, wall {f64_wall:.3f} s, {len(ts) / f64_wall:.0f} "
            f"rows/s ({card})")
    return out


# -- phase 28: the host pipeline and asynchronous emission ---------------------


def phase_host_pipeline(device, jobs, rates, card):
    """Phase 28: config 1 and config 3 through ``partial_merge`` with
    ``host_pipeline=True`` and the default emit lag (200 ms on the card),
    against the oracle, beside phases 8 and 10; every merge, the worker
    thread's included, launched on the main thread's stream.  A replay-
    speed run may close no window within the 200 ms lag before its end of
    stream (then every window leaves at the end, block reads unused), so
    config 3 runs once more with a 1 ms lag: each trigger reads its closed
    windows as blocks and drains them at the next trigger, asynchronously
    — there at least one block must have drained a trigger later."""
    from denormalized_tpu_torch.ops import merge_partials as mp

    main_stream = torch.cuda.current_stream(device).cuda_stream
    out = {}
    runs = [("tumbling", None), ("highcard", None), ("highcard", 1)]
    for job, lag in runs:
        batches, stream, num_keys = jobs[job]
        ts, kid, val = stream
        cfg = (dict(min_group_capacity=2 * HIGHCARD_KEYS)
               if job == "highcard" else {})
        if lag is not None:
            cfg["emit_lag_ms"] = lag
        mp.merge_partials_launches = 0
        ctx, res, wall = run_job(device, batches, job,
                                 strategy="partial_merge", host_pipeline=True,
                                 **cfg)
        exp = oracle(ts, kid, val, 1000, 1000, num_keys)
        check = check_highcard if job == "highcard" else check_tumbling
        n_rows = check(res, exp, num_keys)
        op = window_exec_of(ctx)
        b, m = op.backend, op.metrics()
        sites = dict(b.merge_sites)
        streams = {st for (_thread, st) in sites}
        worker = sum(n for (thread, _st), n in sites.items()
                     if thread != threading.main_thread().name)
        if streams != {main_stream} or mp.merge_partials_launches != b.merges:
            raise AssertionError(f"phase 28 {job}: merges on streams "
                                 f"{sites}, main stream {main_stream}; "
                                 f"{mp.merge_partials_launches} launches for "
                                 f"{b.merges} merges")
        if lag is not None and m["emit_blocks_deferred"] == 0:
            raise AssertionError(f"phase 28 {job} (emit lag {lag} ms): no "
                                 f"emission block was drained a trigger later")
        label = job if lag is None else f"{job}_lag{lag}"
        out[label] = dict(rows_per_s=len(ts) / wall, worker_merges=worker,
                          deferred=m["emit_blocks_deferred"])
        log(f"phase 28 {JOB_NAMES[job]} via partial_merge with host_pipeline"
            f" (emit lag {'default' if lag is None else f'{lag} ms'}): "
            f"{len(ts)} rows, {n_rows} window rows match the oracle, "
            f"{b.merges} merges ({worker} on the worker thread), all on the "
            f"main thread's stream {main_stream}; {m['emit_blocks']} emission "
            f"blocks read, {m['emit_blocks_deferred']} drained a trigger "
            f"later; wall {wall:.3f} s, {len(ts) / wall:.0f} rows/s against "
            f"{rates[job]:.0f} without the pipeline (phase "
            f"{8 if job == 'tumbling' else 10}) ({card})")
    if not any(r["worker_merges"] for r in out.values()):
        raise AssertionError("phase 28: no merge ran on the worker thread")
    return out


# -- phase 30: CSV, explain(analyze=True), EngineConfig.set -------------------

CSV_BATCHES = 15  # phase 4's first batches written to the CSV


def csv_text(ts, kid, val) -> bytes:
    """examples/csv_streaming.py's CSV (header, then
    ``occurred_at_ms,sensor_name,reading`` a row) of the rows, readings to
    6 decimals as bench.py's JSON writes them, encoded with numpy."""
    names = [f"sensor_{i}" for i in range(int(kid.max()) + 1)]
    reading = json_pieces(ts, kid, micro_of(val), names)[5:9]
    name_mat = np.zeros((len(names), max(map(len, names))), np.uint8)
    for i, nb in enumerate(n.encode() for n in names):
        name_mat[i, : len(nb)] = np.frombuffer(nb, np.uint8)
    name_len = np.array([len(n) for n in names], np.int64)
    data, _ = _concat_pieces([
        (_digits(ts, 13), 13), _const(b","),
        (name_mat[kid], name_len[kid]), _const(b","),
        *reading, _const(b"\n"),
    ], len(ts))
    return b"occurred_at_ms,sensor_name,reading\n" + data.tobytes()


def phase_csv_explain(device, batches, stream, card):
    """Phase 30: (1) examples/csv_streaming.py's job (1 s count/avg by
    sensor_name) through the port's ``CsvSource`` over a CSV of phase 4's
    first CSV_BATCHES batches, against the oracle, dense launches = the
    window's batches; (2) ``explain(analyze=True)`` of config 1's job on
    the card with checkpointing configured by ``EngineConfig.set``
    (``denormalized_config.checkpoint``): the analyzed plan carries the
    window's device steps, all of them dense launches, and no epoch is
    committed — a checkpointed run on the same store afterwards restores
    nothing and processes every batch → {csv_rows_per_s, launches}."""
    import contextlib
    import io
    import shutil
    import tempfile

    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.sources.csv import CsvSource
    from denormalized_tpu_torch.state.lsm import close_global_state_backend

    n = CSV_BATCHES * BATCH_ROWS
    ts, kid, val = (a[:n] for a in stream)
    work = tempfile.mkdtemp(prefix="dnz_csv_")
    try:
        path = f"{work}/readings.csv"
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            f.write(csv_text(ts, kid, val))
        write_s = time.perf_counter() - t0
        exp = oracle(ts, kid, np.round(val, 6), 1000, 1000, NUM_KEYS)
        dw.dense_window_launches = 0
        t0 = time.perf_counter()
        ctx = tt.Context(tt.EngineConfig(device=str(device)))
        src = CsvSource(path, timestamp_column="occurred_at_ms")
        load_s = time.perf_counter() - t0
        res = ctx.from_source(src).window(
            [tt.col("sensor_name")],
            [F.count(tt.col("reading")).alias("count"),
             F.avg(tt.col("reading")).alias("avg")], 1000).collect()
        sync(device)
        wall = time.perf_counter() - t0
        launches = dw.dense_window_launches
        got = {(ws, int(name[7:])): (c, a) for ws, name, c, a in zip(
            res.column("window_start_time").tolist(),
            res.column("sensor_name").tolist(),
            res.column("count").tolist(), res.column("avg").tolist())}
        if set(got) != set(exp):
            raise AssertionError(f"phase 30 CSV: {len(got)} window rows, "
                                 f"the oracle {len(exp)}")
        keys = sorted(exp)
        if [got[k][0] for k in keys] != [exp[k][0] for k in keys]:
            raise AssertionError("phase 30 CSV: counts differ")
        assert_close_rows(keys, [(got[k][1],) for k in keys],
                          [(exp[k][3],) for k in keys])
        op = window_exec_of(ctx)
        m = op.metrics()
        if not (launches == m["batches_in"] == op.backend.dense_updates > 0):
            raise AssertionError(f"phase 30 CSV: {launches} dense launches "
                                 f"for {m['batches_in']} window batches")
        log(f"phase 30 csv_streaming job (CsvSource, {n} rows of phase 4's "
            f"first {CSV_BATCHES} batches, {len(got)} window rows = the "
            f"oracle): CSV written in {write_s:.2f} s, read and parsed in "
            f"{load_s:.2f} s, wall {wall:.3f} s with the read "
            f"({n / wall:.0f} rows/s), window batches {m['batches_in']} = "
            f"dense launches {launches} ({card})")

        # explain(analyze=True) with checkpointing set by its config name
        store = f"{work}/state"

        def checkpointed(ctx):
            cfg = ctx.config
            cfg.set("denormalized_config.checkpoint", True)
            cfg.set("checkpoint_interval_s", 0.05)
            cfg.set("state_backend_path", store)
            if not (cfg.checkpoint is True
                    and cfg.state_backend_path == store):
                raise AssertionError("phase 30: EngineConfig.set did not "
                                     "set")
            return cfg

        dw.dense_window_launches = 0
        ctx, ds = job_stream(device, batches, "tumbling")
        cfg = checkpointed(ctx)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            ds.explain(analyze=True)
        sync(device)
        explain_s = time.perf_counter() - t0
        launches = dw.dense_window_launches
        text = out.getvalue()
        analyzed = text.split("== physical plan (analyzed) ==\n", 1)[1]
        window_line = next(line for line in analyzed.splitlines()
                           if "StreamingWindowExec" in line)
        if (f"device_steps={len(batches)}" not in window_line
                or launches != len(batches)
                or window_exec_of(ctx).backend.dense_updates != launches):
            raise AssertionError(f"phase 30 explain: {launches} dense "
                                 f"launches, window line {window_line!r}")
        if ctx.last_checkpointing() != (None, None) or cfg.checkpoint is not True:
            raise AssertionError("phase 30 explain: the analyze run "
                                 "checkpointed or changed the config")
        close_global_state_backend()
        ctx2, ds2 = job_stream(device, batches, "tumbling")
        checkpointed(ctx2)
        res = ds2.collect()
        coord, _ = ctx2.last_checkpointing()
        close_global_state_backend()
        if coord is None or coord.restored_epoch is not None:
            raise AssertionError("phase 30: the run after explain restored "
                                 f"epoch {getattr(coord, 'restored_epoch', None)}")
        if int(np.sum(res.column("count"))) != len(stream[0]):
            raise AssertionError("phase 30: the run after explain did not "
                                 "read the whole stream")
        log(f"phase 30 explain(analyze=True) of config 1 on {device} "
            f"({explain_s:.3f} s): {len(text.splitlines())} lines printed; "
            f"the window's line {window_line.strip()!r}; {launches} dense "
            f"launches; no epoch committed (the checkpointed run after it, "
            f"set by EngineConfig.set('denormalized_config.checkpoint', "
            f"True), restored nothing and counted all {len(stream[0])} rows)"
            f" ({card})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"csv_rows_per_s": n / wall, "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 11's child process (the script re-invoked on a state path)
    ap.add_argument("--ckpt-child", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-out", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-pause-after", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-device", default="cuda:0", help=argparse.SUPPRESS)
    # phase 23's child (the script re-invoked against the parent's broker)
    ap.add_argument("--kafka-child", help=argparse.SUPPRESS)
    ap.add_argument("--kafka-broker", help=argparse.SUPPRESS)
    ap.add_argument("--kafka-topic", help=argparse.SUPPRESS)
    ap.add_argument("--kafka-out", help=argparse.SUPPRESS)
    # phase 24's child (the script re-invoked on a state path)
    ap.add_argument("--join-child", help=argparse.SUPPRESS)
    ap.add_argument("--join-out", help=argparse.SUPPRESS)
    ap.add_argument("--join-pause-after", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ckpt_child:
        return ckpt_child(args)
    if args.kafka_child:
        return kafka_child(args)
    if args.join_child:
        return join_child(args)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    card = card_line()
    log(card)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"on {torch.cuda.get_device_name(0)}")

    import sysconfig
    from concurrent.futures import ThreadPoolExecutor

    from denormalized_tpu_torch.native.build import load as load_native
    from denormalized_tpu_torch.ops import cuda_build
    from denormalized_tpu_torch.ops.interner import native_interner

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the host libraries build with g++ while nvcc runs
        # (and the live path's: the JSON parser, the wire client, which
        # links zlib, and the row assembler)
        host = pool.submit(lambda: (
            load_native("partial_agg"), native_interner(),
            load_native("lsmkv"), load_native("json_parser"),
            load_native("kafka_client", ("-lz",)),
            load_native("pyassemble", (
                f"-I{sysconfig.get_paths()['include']}",), pydll=True),
            load_native("avro_parser")))
        reports = cuda_build.build_all()
        interner = host.result()[1]
    if interner is None:
        raise AssertionError("the native interner did not build")
    log(f"phase 2: built {', '.join(sorted(reports))} and the host "
        f"libraries partial_agg, interner (lane {interner.lane}), lsmkv, "
        f"json_parser, kafka_client (-lz), pyassemble and avro_parser in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                log(f"  nvcc {name}: {line.strip()}")

    kern = phase_kernels(device, args.seed)
    tumbling, batches, stream = phase_job(
        device, args.seed, TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, "tumbling",
        "auto", 4, card,
    )
    phase_profile(device, batches, card)
    _, sliding_batches, sliding_stream = phase_job(
        device, args.seed + 1, SLIDING_ROWS, BATCH_ROWS, NUM_KEYS, "sliding",
        "auto", 5, card,
    )
    phase_scatter_nan(device, args.seed + 2)
    merge = phase_merge_kernel(device, args.seed + 3, card)
    cfg1_pm = run_checked(device, 8, "tumbling", "partial_merge", batches,
                          stream, NUM_KEYS, card)
    log(f"phase 8 config 1 rows/s side by side: partial_merge "
        f"{cfg1_pm['rows_per_s']:.0f}, row shipping (auto, phase 4) "
        f"{tumbling['rows_per_s']:.0f} ({card})")
    run_checked(device, 9, "sliding", "partial_merge", sliding_batches,
                sliding_stream, NUM_KEYS, card)
    highcard_rates, highcard_batches, highcard_stream = phase_highcard(
        device, args.seed + 4, card)
    restored_launches = phase_ckpt_sigkill(device, args.seed, batches, stream,
                                           tumbling, card)
    phase_ckpt_highcard(device, args.seed + 4, highcard_batches,
                        highcard_stream, card)
    phase_snapshot_race(device, args.seed + 5, card)
    plain_join, join_right = phase_join(device, args.seed, batches, stream,
                                        tumbling, card)
    join_rates, highcard_right = phase_join_highcard(
        device, args.seed + 4, highcard_batches, highcard_stream,
        highcard_rates, card)
    expressions_launches = phase_join_expressions(
        device, (batches, stream), join_right, plain_join, card)
    phase_join_expressions_highcard(
        device, (highcard_batches, highcard_stream), highcard_right,
        join_rates, card)
    phase_join_skew(device, args.seed, card)
    functions_launches = phase_functions(device, batches, stream, card)
    phase_eval_torch(device, args.seed + 9, card)
    kafka = phase_kafka_e2e(device, stream, card)
    pace, staged, lat_stream = phase_kafka_latency(
        device, args.seed + 7, kafka["rows_per_s"], card)
    phase_kafka_ckpt(device, pace, staged, lat_stream, card)
    phase_join_ckpt(device, args.seed, (batches, stream), join_right, card)
    phase_join_ckpt_highcard(
        device, (highcard_batches, highcard_stream), highcard_right, card)
    compact = phase_compact_kernel(device, args.seed + 10, card)
    compact_runs = phase_compact_highcard(device, highcard_batches,
                                          highcard_stream, highcard_rates,
                                          card)
    compact_join = phase_compact_join(
        device, (highcard_batches, highcard_stream), highcard_right, card)
    phase_variance(device, batches, stream, card)
    f64 = phase_f64(device, highcard_batches, highcard_stream, card)
    phase_host_pipeline(
        device,
        {"tumbling": (batches, stream, NUM_KEYS),
         "highcard": (highcard_batches, highcard_stream, HIGHCARD_KEYS)},
        {"tumbling": cfg1_pm["rows_per_s"],
         "highcard": highcard_rates["partial_merge"]}, card)
    avro = phase_kafka_e2e(device, stream, card, fmt="avro", phase=29)
    log(f"phase 29 rows/s side by side: Avro {avro['rows_per_s']:.0f}, JSON "
        f"(phase 21) {kafka['rows_per_s']:.0f} ({card})")
    csv_run = phase_csv_explain(device, batches, stream, card)

    hot = kern["main_hot"]
    m1 = merge["cfg1_dense"]
    m64 = merge["cfg3_f64"]
    c76 = compact["cfg3_76pct"]
    print(json.dumps({"kernels": [{
        "name": "dense_window",
        "route": "cuda",
        "source": "denormalized_tpu_torch/csrc/dense_window.cu",
        "replaces": "denormalized_tpu/ops/pallas_window.py:42",
        "launches": tumbling["launches"]["dense_window"],
        "max_abs_err": max(k["max_abs_err"] for k in kern.values()),
        # device time of one launch at main_hot, apart from the wrapper
        "ms": hot["ms"],
        "ms_by": hot["ms_by"],
        "plain_ms": hot["plain_ms"],
        "bound_ms": hot["bound_ms"],
        "bound_by": hot["bound_by"],
        "library_ms": None,
        # the wrapper's time a call, CUDA events over back-to-back calls
        "host_ms": hot["host_ms"],
        "main_ms": kern["main"]["ms"],
        "main_host_ms": kern["main"]["host_ms"],
        # launches on the restored ring by phase 11's restarted child
        "restored_launches": restored_launches,
        # launches of both windows under phase 14's join (61 a side)
        "join_launches": plain_join["launches"]["dense_window"],
        # both windows under phase 16's join_on (61 a side), and phase
        # 19's window behind the scalar functions (15 batches)
        "join_expressions_launches": expressions_launches,
        "functions_launches": functions_launches,
        # launches on phase 21's kafka_e2e run, one a window batch
        "kafka_launches": kafka["launches"],
        # ... on phase 29's Avro topic, and under phase 30's
        # explain(analyze=True) of config 1
        "avro_launches": avro["launches"],
        "explain_launches": csv_run["launches"],
    }, {
        "name": "merge_partials",
        "route": "cuda",
        "source": "denormalized_tpu_torch/csrc/merge_partials.cu",
        "replaces": "denormalized_tpu/ops/segment_agg.py:365",
        # launches on config 1 through partial_merge (phase 8)
        "launches": cfg1_pm["launches"]["merge_partials"],
        "max_abs_err": max(k["max_abs_err"] for k in merge.values()),
        # device time of one launch at cfg1_dense, apart from the wrapper
        "ms": m1["ms"],
        "ms_by": m1["ms_by"],
        "plain_ms": m1["plain_ms"],
        "bound_ms": m1["bound_ms"],
        "bound_by": m1["bound_by"],
        "library_ms": None,
        "host_ms": m1["host_ms"],
        "cfg3_ms": merge["cfg3_compact"]["ms"],
        "cfg3_bound_ms": merge["cfg3_compact"]["bound_ms"],
        # every phase-7 case: its kernel, device time, bound, wrapper and
        # plain times, and its rings' bit-identity across two launches and
        # to the plain version on the CPU
        "cases": {name: {key: case[key] for key in (
            "branch", "ms", "ms_by", "bound_ms", "bound_by", "host_ms",
            "plain_ms", "max_abs_err", "repeat_bit_equal", "cpu_bit_equal")}
            for name, case in merge.items() if name not in MERGE_F64},
    }, {
        "name": "compact_slot",
        "route": "cuda",
        "source": "denormalized_tpu_torch/csrc/compact_slot.cu",
        "replaces": "denormalized_tpu/ops/segment_agg.py:623",
        # the design since the two-launch kernel was replaced
        "redesigned": "one single-pass launch, decoupled look-back",
        # launches on config 3 with emission_compaction (phase 25, auto):
        # one a window emitted
        "launches": compact_runs["auto"]["launches"],
        "max_abs_err": 0.0,
        # device time of one compaction (one launch) at config 3's shape:
        # 100K of 131,072 cells active, five planes
        "ms": c76["ms"],
        "ms_by": c76["ms_by"],
        "plain_ms": c76["plain_ms"],
        "bound_ms": c76["bound_ms"],
        "bound_by": c76["bound_by"],
        # nonzero + index_select a plane: no single torch call compacts
        "library_ms": c76["library_ms"],
        "host_ms": c76["host_ms"],
        # one segment_agg.read_slot_compact: kernel, count, prefix copies
        "read_ms": c76["read_ms"],
        "partial_merge_launches": compact_runs["partial_merge"]["launches"],
        # both windows of config 4 at 100K keys, emitting from two threads
        "join_launches": compact_join,
        "cases": {name: {key: case[key] for key in (
            "active", "ms", "ms_by", "host_ms", "read_ms", "plain_ms",
            "library_ms", "bound_ms")} for name, case in compact.items()},
    }, {
        "name": "merge_partials_f64",
        "route": "cuda",
        "source": "denormalized_tpu_torch/csrc/merge_partials.cu",
        "replaces": "denormalized_tpu/ops/segment_agg.py:365",
        # launches on config 3 in float64 through partial_merge (phase 27)
        "launches": f64["launches"],
        "max_abs_err": max(merge[n]["max_abs_err"] for n in MERGE_F64),
        # device time of one launch at cfg3_f64, apart from the wrapper
        "ms": m64["ms"],
        "ms_by": m64["ms_by"],
        "plain_ms": m64["plain_ms"],
        "bound_ms": m64["bound_ms"],
        "bound_by": m64["bound_by"],
        "library_ms": None,
        "host_ms": m64["host_ms"],
        "cases": {name: {key: merge[name][key] for key in (
            "branch", "ms", "ms_by", "bound_ms", "bound_by", "host_ms",
            "plain_ms", "max_abs_err", "repeat_bit_equal", "cpu_bit_equal")}
            for name in MERGE_F64},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
