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
7. the stripe-fold kernel (``merge_partials``) against its plain version
   (``merge_partials_reference``) on seeded rings and seeded stripes packed
   by the port's own ``HostPartialStripe``: ``cfg1_dense`` (the config-1
   stripe: G = 128, 10 live groups, 1-2 units, dense, lean), ``sliding_k5``
   (1 s / 200 ms, valid NaNs, NaNs already in the ring), ``ragged_compact``
   (500 ms / 200 ms: SUB = 2, k = 3; the compact layout with nulls,
   compensated), ``cfg3_compact`` (100K live groups over 2 units at config
   3's G, where the stripe packs compact) and ``cfg3_dense`` (the same
   groups in a 131,072-wide ring, where it packs dense): counts, min and
   max exact, sums to rtol=1e-5; device time (as in phase 3), wrapper
   time, plain time and bound;
8. config 1 (the phase-4 stream) through ``device_strategy="partial_merge"``
   against the numpy oracle: rows/s, host prep, merges, kernel launches
   (equal to the merges), bytes to the card, and the native reducer's and
   interner's counters (no batch on the numpy reducer);
9. config 2 (the phase-5 stream) through ``partial_merge`` the same way;
10. config 3 (bench.py ``highcard``: 100K keys, sum and avg, 524,288-row
    batches, 8M rows) through ``partial_merge`` and through ``auto`` (row
    shipping, the scatter path at this G) on the same seeded stream, both
    against the numpy oracle, with their rows/s side by side.

Then one JSON line with each kernel's launches on its main path (phase 4
for the dense kernel, phase 8 for the merge kernel, each counted from 0
just before the run), its largest error against the plain version, its
device time, the wrapper's time, the plain version's time and the least
time the card could take, and as the last line ``{"ok": true, "device":
{...}}``.  Any failure ends the run with a non-zero exit and no result.
Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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


def run_job(device, batches, job: str, on_read=None, strategy="auto", **cfg):
    """The ``tumbling``, ``sliding`` or ``highcard`` job over ``batches``
    through ``device_strategy=strategy`` → (ctx, result, wall s).
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


def check_tumbling(res, exp, num_keys):
    keys = {f"sensor_{i}": i for i in range(num_keys)}
    got = {}
    for ws, name, c, mn, mx, a in zip(
        res.column("window_start_time").tolist(),
        res.column("sensor_name").tolist(),
        res.column("count").tolist(), res.column("min").tolist(),
        res.column("max").tolist(), res.column("average").tolist(),
    ):
        got[(ws, keys[name])] = (c, mn, mx, a)
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


def check_highcard(res, exp, num_keys):
    """Config 3's rows: the same row set as the oracle, sum and avg to
    rtol=1e-4 (f32 sums on the card)."""
    got = {}
    for ws, name, sm, a in zip(
        res.column("window_start_time").tolist(),
        res.column("sensor_name").tolist(),
        res.column("sum").tolist(), res.column("avg").tolist(),
    ):
        got[(ws, int(name[7:]))] = (sm, a)  # "sensor_<i>"
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
    included."""

    def __init__(self, reader, on_read):
        self._reader, self._on_read, self._n = reader, on_read, 0

    def read(self, timeout_s=None):
        self._on_read(self._n)
        self._n += 1
        return self._reader.read(timeout_s)


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

MERGE_KERNEL = "merge_partials_kernel"
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
    # config 3's own stripe: at its G (2 x 100K keys, rounded up to 128)
    # the 100K live groups fill half the span, so it packs compact
    "cfg3_compact": (1000, 1000, 2 * HIGHCARD_KEYS + 64, HIGHCARD_KEYS, 5, 2,
                     2 * HIGHCARD_BATCH_ROWS, False, False, False,
                     HIGHCARD_AGGS),
    # the same 100K live groups in a 131,072-wide ring pack dense
    "cfg3_dense": (1000, 1000, 131_072, HIGHCARD_KEYS, 5, 2,
                   2 * HIGHCARD_BATCH_ROWS, False, False, False,
                   HIGHCARD_AGGS),
}


def merge_case(name: str, seed: int):
    """One phase-7 case → (spec, host ring, SUB, (packed, a_pad, u_base,
    lean, dense)): seeded rows in time order folded into the port's own
    HostPartialStripe and packed by it, and a seeded ring (W = 16) whose
    sums are sums of positive readings.  ``cfg3_compact``'s G is config
    3's (min_group_capacity = 2 × 100K keys, rounded up to 128)."""
    from denormalized_tpu_torch.ops import segment_agg as sa
    from denormalized_tpu_torch.ops.host_partial import HostPartialStripe

    (L, S, G, keys, u0, span, B, nulls, nans, compensated,
     aggs) = MERGE_CASES[name]
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
    gid = rng.integers(0, keys, B).astype(np.int32)
    vals = rng.normal(50.0, 10.0, (B, 1))
    colvalid = None
    if nulls:
        colvalid = rng.random((B, 1)) > 0.1
        vals[~colvalid & (rng.random((B, 1)) < 0.5)] = np.nan
    if nans:
        vals[rng.integers(0, B, 4), 0] = np.nan  # valid NaNs
    stripe = HostPartialStripe(spec, G)
    stripe.add_batch(units, rem, gid, vals, colvalid, None)
    base_mod = int(rng.integers(0, 16))
    taken = stripe.take_packed(base_mod)
    if taken[4] != name.endswith(("dense", "k5")):
        raise AssertionError(f"{name}: the stripe packed in the other layout")
    host = seeded_ring(spec, rng)
    if nans:
        # NaNs already in the ring, in rows the stripe folds into
        for label in ("min_0", "max_0"):
            host[label][(base_mod + u0 + rng.integers(0, span, 8)) % 16,
                        rng.integers(0, keys, 8)] = np.nan
    return spec, host, stripe.SUB, taken


def merge_bound(spec, SUB: int, packed: np.ndarray, a_pad: int, dense: bool):
    """Least time for one merge on this stripe's data: the bytes over the
    HBM rate or the updates over the f32 rate, whichever is longer.  Bytes:
    the row-count plane of every cell (it tells a live cell from an empty
    one or padding) and the two header slots; for each live cell, its other
    value planes and, in the compact layout, its index; plus every
    component of each ring cell the live cells land in, read and written
    once (8 B).  An empty or padding cell holds only fold identities, so
    its other planes need not be read.  Updates: one a ring plane per (live
    cell, fan-out) that lands.  → (ms, what bounds it, ring cells
    touched)."""
    W, G, k = spec.window_slots, spec.group_capacity, spec.length_units
    planes = packed if dense else packed[1:]
    flat = np.arange(a_pad) if dense else packed[0, :a_pad].astype(np.int64)
    live = (planes[0, :a_pad] != 0) & (flat >= 0)
    n_live = int(live.sum())
    stripe_bytes = 4 * a_pad + 8 + 4 * n_live * (
        planes.shape[0] - 1 + (0 if dense else 1))
    flat = flat[live]
    g, us = flat % G, flat // G
    s, u = us % SUB, us // SUB
    u_base_rel, base_mod = int(packed[0, a_pad]), int(packed[0, a_pad + 1])
    cells, updates = [], 0
    n_planes = len(spec.components)
    for f in range(k):
        w = u_base_rel + u - f
        ok = (w >= 0) & (w < W)
        if SUB == 2 and f == k - 1:
            ok &= s == 0
        cells.append(((base_mod + w[ok]) % W) * G + g[ok])
        updates += int(ok.sum()) * n_planes
    n_cells = len(np.unique(np.concatenate(cells)))
    nbytes = stripe_bytes + 8 * n_cells * n_planes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = updates / F32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", n_cells
    return t_ops, "operations", n_cells


def phase_merge_kernel(device, seed: int, card: str):
    """→ {case: {ms, host_ms, plain_ms, max_abs_err, bound_ms, bound_by}}."""
    from denormalized_tpu_torch.ops import merge_partials as mp
    from denormalized_tpu_torch.ops import segment_agg as sa

    out = {}
    for i, name in enumerate(MERGE_CASES):
        spec, host, SUB, (packed_np, a_pad, _u, lean, dense) = merge_case(
            name, seed + i)
        packed = torch.from_numpy(packed_np).to(device)
        got = sa.import_state(spec, host, device)
        want = sa.import_state(spec, host, device)
        before = mp.merge_partials_launches
        mp.merge_partials(spec, SUB, a_pad, lean, dense, got, packed)
        torch.cuda.synchronize(device)
        if mp.merge_partials_launches - before != 1:
            raise AssertionError(f"{name}: the merge kernel did not launch once")
        sa.merge_partials_reference(spec, SUB, a_pad, lean, dense, want,
                                    packed)
        err = compare_rings(spec, got, want, name)

        scratch = sa.import_state(spec, host, device)

        def kernel():
            mp.merge_partials(spec, SUB, a_pad, lean, dense, scratch, packed)

        def plain():
            sa.merge_partials_reference(spec, SUB, a_pad, lean, dense,
                                        scratch, packed)

        ms, ms_by = kernel_device_ms(kernel, MERGE_KERNEL)
        host_ms = time_ms(kernel, device, iters=200)
        plain_ms = time_ms(plain, device)
        bound_ms, bound_by, n_cells = merge_bound(spec, SUB, packed_np, a_pad,
                                                  dense)
        out[name] = dict(ms=ms, ms_by=ms_by, host_ms=host_ms,
                         plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                         bound_by=bound_by)
        log(f"phase 7 merge {name}: {'dense' if dense else 'compact'} "
            f"{'lean' if lean else 'full'} stripe {tuple(packed.shape)} int32 "
            f"(a_pad {a_pad}), SUB={SUB} k={spec.length_units} "
            f"G={spec.group_capacity} compensated={spec.compensated}, "
            f"{n_cells} ring cells touched: ring matches the plain version "
            f"(max_abs_err={err:.3g}), device {ms:.5f} ms ({ms_by}), "
            f"host_ms {host_ms:.4f}, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}) ({card})")
    return out


# -- phase 10: config 3, partial_merge against row shipping -------------------


def phase_highcard(device, seed: int, card: str):
    """Config 3 through partial_merge and through auto (row shipping) on
    the same seeded stream, both checked against the oracle."""
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
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
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
                                    native_interner()))
        reports = cuda_build.build_all()
        _, interner = host.result()
    if interner is None:
        raise AssertionError("the native interner did not build")
    log(f"phase 2: built {', '.join(sorted(reports))} and the host "
        f"libraries partial_agg and interner (lane {interner.lane}) in "
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
    phase_highcard(device, args.seed + 4, card)

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
