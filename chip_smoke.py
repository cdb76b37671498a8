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
    adaptation policy's counts.

Then one JSON line with each kernel's launches on its main path (phase 4
for the dense kernel, phase 8 for the merge kernel, each counted from 0
just before the run; for the dense kernel also its launches on phase 11's
restored ring, and both windows' launches under phase 14's join), its
largest error against the plain version, its device
time, the wrapper's time, the plain version's time and the least time the
card could take (for the merge kernels also each phase-7 case's kernel,
times, bound and bit-identity, under ``cases``), and as the last line
``{"ok": true, "device": {...}}``.
Any failure ends the run with a non-zero exit and no result.  Without CUDA
it exits 1 at once.
"""

from __future__ import annotations

import time

T_START = time.time()  # phase 11 times a child's restart from here

import argparse
import json
import subprocess
import sys

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
    atomics reorder them), a compensated sum as hi + lo.  → largest
    absolute error over finite sums."""
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
            np.testing.assert_allclose(a, b, rtol=1e-5,
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


def oracle(ts, kid, val, length_ms, slide_ms, num_keys):
    """numpy float64 oracle: {(window_start, key index): (count, min, max,
    avg)} over every window a row falls in; min/max over the f32-rounded
    readings (what the ring holds)."""
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
    for k, (c, _mn, _mx, a) in exp.items():
        gs, ga = got[k]
        if not (np.isclose(gs, a * c, rtol=1e-4, atol=0)
                and np.isclose(ga, a, rtol=1e-4, atol=0)):
            raise AssertionError(f"{k}: got {got[k]}, expected {(a * c, a)}")
    return len(got)


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
}
# shards of the stripe's group space, for the cases that hold one shard
MERGE_SHARDS = {"cfg3_shard": 2}
MERGE_DENSE = ("cfg1_dense", "sliding_k5", "ragged_dense", "cfg3_dense",
               "cfg3_shard")


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
    the live cells land in, read and written once (8 B).  An empty or
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
    nbytes = stripe_bytes + 8 * n_cells * n_planes
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
        ne = x.view(torch.int32) != y.view(torch.int32)
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


def join_stream(device, left_batches, right_batches, strategy, **cfg):
    """bench.py's ``join`` query, not yet run → (ctx, DataStream): two
    streams, avg(reading) by sensor_name in 1 s tumbling windows, the right
    side's sensor/start/end renamed to hs/hws/hwe, an inner join on
    (sensor_name, window_start_time) = (hs, hws)."""
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
        ).window(["sensor_name"], [F.avg(col("reading")).alias(agg)], 1000)

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


def check_join(res, left_stream, right_stream, num_keys) -> int:
    """The joined rows against the numpy float64 oracle: the same
    (window_start, sensor) row set as the windows both sides hold, both
    averages to rtol=1e-4 → rows."""
    lo = oracle(*left_stream, 1000, 1000, num_keys)
    ro = oracle(*right_stream, 1000, 1000, num_keys)
    exp = {k: (lo[k][3], ro[k][3]) for k in lo.keys() & ro.keys()}
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
    if set(got) != set(exp):
        raise AssertionError(
            f"row sets differ: {len(got)} joined vs {len(exp)} expected")
    for k, (a, b) in exp.items():
        ga, gb = got[k]
        if not (np.isclose(ga, a, rtol=1e-4, atol=0)
                and np.isclose(gb, b, rtol=1e-4, atol=0)):
            raise AssertionError(f"{k}: got {got[k]}, expected {(a, b)}")
    return len(got)


def run_join(device, phase, strategy, left, right, num_keys, card, **cfg):
    """Config 4 over two streams with every kernel count set to 0 just
    before it, checked against the oracle → {rows_per_s, wall, launches,
    ctx, join metrics}."""
    from denormalized_tpu_torch.ops import dense_window as dw
    from denormalized_tpu_torch.ops import merge_partials as mp

    (lb, ls), (rb, rs) = left, right
    rows = len(ls[0]) + len(rs[0])
    ctx, ds = join_stream(device, lb, rb, strategy, **cfg)
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
    joined = check_join(res, ls, rs, num_keys)
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
    return out["launches"]["dense_window"]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # phase 11's child process (the script re-invoked on a state path)
    ap.add_argument("--ckpt-child", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-out", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-pause-after", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-device", default="cuda:0", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ckpt_child:
        return ckpt_child(args)
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

    from concurrent.futures import ThreadPoolExecutor

    from denormalized_tpu_torch.native.build import load as load_native
    from denormalized_tpu_torch.ops import cuda_build
    from denormalized_tpu_torch.ops.interner import native_interner

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the host libraries build with g++ while nvcc runs
        host = pool.submit(lambda: (load_native("partial_agg"),
                                    native_interner(), load_native("lsmkv")))
        reports = cuda_build.build_all()
        _, interner, _ = host.result()
    if interner is None:
        raise AssertionError("the native interner did not build")
    log(f"phase 2: built {', '.join(sorted(reports))} and the host "
        f"libraries partial_agg, interner (lane {interner.lane}) and lsmkv "
        f"in {time.perf_counter() - t0:.1f} s")
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
    join_launches = phase_join(device, args.seed, batches, stream, tumbling,
                               card)
    phase_join_highcard(device, args.seed + 4, highcard_batches,
                        highcard_stream, highcard_rates, card)

    hot = kern["main_hot"]
    m1 = merge["cfg1_dense"]
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
        "join_launches": join_launches,
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
            for name, case in merge.items()},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
