"""Chip smoke test of the PyTorch/CUDA port (denormalized_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed N]

Phases, each printing one line:
1. the card's name and power limit (nvidia-smi) and the torch/CUDA
   versions;
2. the build of every CUDA kernel of ``denormalized_tpu_torch/csrc/`` from
   the sources in the checkout (one nvcc per source, all started together);
3. the dense window kernel against its plain PyTorch version on the card,
   at the main path's shapes, the sliding fan-out and the G=2048 edge, each
   with nulls, NaN behind the null mask, dropped rows (rel = -1) and
   rel >= K_ACTIVE: counts, min and max exact, sums to rtol=1e-5;
4. the main path end to end: the emit_measurements stream (8M rows,
   131,072-row batches, 10 keys, event time at 1M events/s, made from
   --seed with numpy) through Context(EngineConfig(device="cuda",
   device_strategy="auto")) in a 1 s tumbling count/min/max/avg by
   sensor_name, checked against a numpy float64 oracle, with every batch
   on the dense kernel;
5. the sliding job (1 s window, 200 ms slide, count+avg, filter avg > 45)
   over ~2M rows, the same way.

Then one JSON line with each kernel's launches on the main path, its
largest error against the plain version, its time, the plain version's
time and the least time the card could take, and as the last line
``{"ok": true, "device": {...}}``.  Any failure ends the run with a
non-zero exit and no result.  Without CUDA it exits 1 at once.
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
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events,
    after two warm-up runs."""
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


# -- phase 3: kernel vs plain version ----------------------------------------


def kernel_case(B, G, V, KREL, seed, device):
    """Inputs at the given shapes with nulls, NaN behind the null mask,
    dropped rows (rel = -1) and rel >= K_ACTIVE.  Each row's rel columns
    name distinct slots, as dense_update builds them."""
    from denormalized_tpu_torch.ops.dense_window import K_ACTIVE

    rng = np.random.default_rng(seed)
    values = rng.normal(50.0, 10.0, (B, V)).astype(np.float32)
    colvalid = (rng.random((B, V)) > 0.1).astype(np.float32)
    values[(colvalid == 0) & (rng.random((B, V)) < 0.5)] = np.nan
    first = rng.integers(-1, K_ACTIVE + 2, B)
    rel = (first[:, None] + np.arange(KREL)[None, :]).astype(np.int32)
    rel[rng.random(B) < 0.05] = -1
    gid = rng.integers(0, G, B).astype(np.int32)
    return tuple(
        torch.from_numpy(a).to(device) for a in (values, colvalid, rel, gid)
    )


def compare_partials(got, want, what: str) -> float:
    """Counts, min and max exact (NaN where NaN); sums to rtol=1e-5 (float
    atomics reorder them).  → largest absolute error over finite cells."""
    names = ("rowcnt", "cnt", "sum", "min", "max")
    worst = 0.0
    for name, a, b in zip(names, got, want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if name == "sum":
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")
        fin = np.isfinite(a) & np.isfinite(b)
        if fin.any():
            worst = max(worst, float(np.abs(a[fin] - b[fin]).max()))
    return worst


def phase_kernels(device, seed: int):
    from denormalized_tpu_torch.ops import dense_window as dw

    cases = [
        ("main", 131_072, 128, 1, 1),
        ("sliding", 131_072, 128, 1, 5),
        ("edge", 131_072, 2048, 2, 1),
    ]
    worst, timing = 0.0, {}
    for i, (name, B, G, V, KREL) in enumerate(cases):
        args = kernel_case(B, G, V, KREL, seed + i, device)
        before = dw.dense_window_launches
        got = dw.dense_partials(*args, G)
        torch.cuda.synchronize(device)
        launched = dw.dense_window_launches - before
        want = dw.dense_partials_reference(*args, G)
        torch.cuda.synchronize(device)
        err = compare_partials(got, want, name)
        worst = max(worst, err)
        k_ms = time_ms(lambda: dw.dense_partials(*args, G), device)
        p_ms = time_ms(lambda: dw.dense_partials_reference(*args, G), device)
        if name == "main":
            timing = {"ms": k_ms, "plain_ms": p_ms, "shape": (B, G, V, KREL)}
        log(f"phase 3 kernel {name} B={B} G={G} V={V} KREL={KREL}: "
            f"match (max_abs_err={err:.3g}), kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, launches {launched}")
        if launched != 1:
            raise AssertionError(f"{name}: {launched} kernel launches, not 1")
    return worst, timing


def bound(B, G, V, KREL):
    """Least time for the dense partials at these shapes: each input read
    once (values, colvalid f32; rel, gid int32), each output written once,
    over the HBM rate; and the arithmetic (per row and rel column: a row
    count, then a count, sum, min and max per value column) over the f32
    rate.  → (ms, what bounds it)."""
    from denormalized_tpu_torch.ops.dense_window import K_ACTIVE

    nbytes = B * (8 * V + 4 * KREL + 4) + 4 * K_ACTIVE * G * (1 + 4 * V)
    ops = B * KREL * (1 + 4 * V)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def run_job(device, batches, sliding: bool):
    import denormalized_tpu_torch as tt
    from denormalized_tpu_torch.api import functions as F
    from denormalized_tpu_torch.sources.memory import MemorySource

    ctx = tt.Context(tt.EngineConfig(device=str(device), device_strategy="auto"))
    src = ctx.from_source(
        MemorySource.from_batches(batches, timestamp_column="occurred_at_ms")
    )
    col = tt.col
    if sliding:
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


def phase_job(device, seed, total_rows, batch_rows, num_keys, sliding, card):
    from denormalized_tpu_torch.ops import dense_window as dw

    ts, kid, val = gen_stream(total_rows, batch_rows, num_keys, seed)
    batches = to_batches(ts, kid, val, batch_rows, num_keys)
    dw.dense_window_launches = 0
    ctx, res, wall = run_job(device, batches, sliding)
    launches = dw.dense_window_launches
    name = "sliding 1s/200ms" if sliding else "tumbling 1s"
    check_dispatch(ctx, len(batches), name)
    if device.type == "cuda" and launches == 0:
        raise AssertionError(f"{name}: the dense kernel never launched")
    exp = oracle(ts, kid, val, 1000, 200 if sliding else 1000, num_keys)
    rows_out = (check_sliding if sliding else check_tumbling)(
        res, exp, num_keys
    )
    m = window_exec_of(ctx).metrics()
    log(f"phase {5 if sliding else 4} {name}: {len(ts)} rows in "
        f"{len(batches)} batches, {rows_out} window rows match the oracle, "
        f"dense_updates={len(batches)} scatter_updates=0 "
        f"kernel launches={launches}, wall {wall:.3f} s, "
        f"{len(ts) / wall:.0f} rows/s, window host prep "
        f"{m['host_prep_s']:.3f} s, {m['bytes_h2d']} B to and "
        f"{m['bytes_d2h']} B from the card ({card})")
    return launches, len(ts) / wall, wall


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

    from denormalized_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    log(f"phase 2: built {', '.join(sorted(reports))} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                log(f"  nvcc {name}: {line.strip()}")

    worst, timing = phase_kernels(device, args.seed)
    launches, rows_per_s, wall = phase_job(
        device, args.seed, TOTAL_ROWS, BATCH_ROWS, NUM_KEYS, False, card
    )
    phase_job(
        device, args.seed + 1, SLIDING_ROWS, BATCH_ROWS, NUM_KEYS, True, card
    )

    bound_ms, bound_by = bound(*timing["shape"])
    print(json.dumps({"kernels": [{
        "name": "dense_window",
        "route": "cuda",
        "source": "denormalized_tpu_torch/csrc/dense_window.cu",
        "replaces": "denormalized_tpu/ops/pallas_window.py:42",
        "launches": launches,
        "max_abs_err": worst,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
