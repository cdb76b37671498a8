"""The window operator's remaining options in the port, held against the
JAX package: emission compaction (``emission_compaction``, the compaction
kernel's plain version ``compact_slot_reference``), float64 rings
(``accum_dtype``), the host pipeline (``host_pipeline``) and asynchronous
emission.

- twin of ``tests/test_sliding_and_growth.py:288``: compaction on and off
  give the same rows, on a sparse ring (capacity far beyond the live keys);
- ``segment_agg.read_slot_compact`` against the JAX package's on seeded
  rings at several active shares, bit for bit (it is a copy);
- twins of ``tests/test_partial_merge.py:151`` and ``:162``: the host
  pipeline's rows equal the synchronous path's, and a failure on its
  worker surfaces on the stream's thread;
- asynchronous emission (a block drained a trigger after it was read)
  gives the same rows in the same order as synchronous emission;
- float64 rings against a numpy float64 oracle at rtol=1e-12 on the
  scatter path and through the merge's plain version, and against the JAX
  package run with x64 on — in a subprocess, so x64 never leaks into this
  process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.ops import segment_agg as jsa
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.ops import compact_slot as cs
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.parallel import sharded_state as ss
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

REPO = Path(__file__).resolve().parents[1]
T0 = 1_700_000_000_000


def feed(seed, n_batches=24, rows=400, keys=10, span=250, nulls=False,
         loc=50.0, scale=10.0):
    """tests/test_partial_merge.py's sensor batches as raw arrays:
    [(ts, names, values, valid or None)]."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * span + rng.integers(0, span, rows))
        names = rng.choice([f"s{i}" for i in range(keys)], size=rows)
        vals = rng.normal(loc, scale, rows)
        valid = rng.random(rows) > 0.15 if nulls else None
        out.append((ts.astype(np.int64), names.astype(object), vals, valid))
    return out


def port_batches(raw):
    schema = TSchema([TField("occurred_at_ms", TType.INT64, nullable=False),
                      TField("sensor_name", TType.STRING, nullable=False),
                      TField("reading", TType.FLOAT64)])
    return [TBatch(schema, [t, k, v], None if m is None else [None, None, m])
            for t, k, v, m in raw]


def jax_batches(raw):
    schema = JSchema([JField("occurred_at_ms", JType.INT64, nullable=False),
                      JField("sensor_name", JType.STRING, nullable=False),
                      JField("reading", JType.FLOAT64)])
    return [JBatch(schema, [t, k, v], None if m is None else [None, None, m])
            for t, k, v, m in raw]


def std_aggs(F, col):
    c = col("reading")
    return [F.count(c).alias("cnt"), F.min(c).alias("mn"),
            F.max(c).alias("mx"), F.avg(c).alias("av"), F.sum(c).alias("sm")]


def keyed(result) -> dict:
    """{(window start, sensor): {column: value}} in emission order."""
    out = {}
    names = [n for n in result.schema.names if n != "sensor_name"]
    for i in range(result.num_rows):
        key = (int(result.column("window_start_time")[i]),
               str(result.column("sensor_name")[i]))
        assert key not in out, f"duplicate emission {key}"
        out[key] = {n: result.column(n)[i] for n in names}
    return out


def run_port(raw, length=1000, slide=None, **cfg):
    ctx = tt.Context(tt.EngineConfig(device="cpu", **cfg))
    res = ctx.from_source(
        TSource.from_batches(port_batches(raw),
                             timestamp_column="occurred_at_ms")
    ).window(["sensor_name"], std_aggs(TF, tt.col), length, slide).collect()
    return keyed(res), ctx


def run_jax(raw, length=1000, slide=None, **cfg):
    ctx = jt.Context(JConfig(**cfg))
    res = ctx.from_source(
        JSource.from_batches(jax_batches(raw),
                             timestamp_column="occurred_at_ms")
    ).window(["sensor_name"], std_aggs(JF, jt.col), length, slide).collect()
    return keyed(res)


def assert_parity(a: dict, b: dict, rtol=1e-6) -> None:
    """tests/test_partial_merge.py's _assert_parity: same keys, exact
    non-floats, floats to ``rtol`` (NaN where NaN)."""
    assert set(a) == set(b), (set(a) ^ set(b))
    for k in a:
        for name, va in a[k].items():
            vb = b[k][name]
            if isinstance(va, (float, np.floating)):
                if np.isnan(va) and np.isnan(vb):
                    continue
                assert vb == pytest.approx(va, rel=rtol, abs=1e-9), (
                    k, name, va, vb)
            else:
                assert va == vb, (k, name, va, vb)


def window_exec(ctx):
    node = ctx._last_physical
    while type(node).__name__ != "StreamingWindowExec":
        (node,) = node.children
    return node


# -- emission compaction ------------------------------------------------------


@pytest.mark.parametrize("strategy", ["scatter", "auto", "partial_merge"])
def test_emission_compaction_parity(monkeypatch, strategy):
    """Twin of tests/test_sliding_and_growth.py:288: compaction on a sparse
    ring (min_group_capacity 4096, 9 live keys, 1 s / 500 ms) emits what
    the full read emits, and what the JAX package emits with compaction
    on; each emitted window went through the compaction kernel's plain
    version once."""
    raw = feed(17, n_batches=10, rows=512, keys=9, span=400, loc=5.0,
               scale=2.0)
    calls = []
    real = cs.compact_slot_reference
    monkeypatch.setattr(cs, "compact_slot_reference",
                        lambda *a: calls.append(1) or real(*a))
    cfg = dict(min_group_capacity=4096, device_strategy=strategy)
    off, _ = run_port(raw, 1000, 500, **cfg)
    assert not calls
    on, ctx = run_port(raw, 1000, 500, emission_compaction=True, **cfg)
    assert on and list(on) == list(off)
    # the full read finalizes avg on the device in f32, compaction on the
    # host in f64: the JAX test's own rounding (5 decimals) allows that
    assert_parity(off, on)
    op = window_exec(ctx)
    assert op._finals_specs is None  # compaction turns device finals off
    assert len(calls) == op.metrics()["windows_emitted"] == len(
        {k[0] for k in on})
    jax_on = run_jax(raw, 1000, 500, emission_compaction=True,
                     min_group_capacity=4096)
    assert_parity(jax_on, on)


def seeded_ring(G, share, seed, accum=torch.float32):
    """A spec with count/sum/min/max/avg planes (+ compensation) and a
    seeded (4, G) ring in which ``share`` of slot 2's cells are active;
    valid NaNs, ±inf extrema and negative zeros in some cells."""
    rng = np.random.default_rng(seed)
    comps = sa.with_compensation(sa.components_for(
        [("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 1)]))
    spec = sa.WindowKernelSpec(
        components=tuple(comps), num_value_cols=2, window_slots=4,
        group_capacity=G, length_ms=1000, slide_ms=1000, accum_dtype=accum,
        compensated=True)
    dt = np.float64 if accum == torch.float64 else np.float32
    active = rng.random((4, G)) < share
    counts = np.where(active, rng.integers(1, 9, (4, G)), 0).astype(np.int32)
    host = {}
    for c in spec.components:
        if c.kind == "count":
            host[c.label] = counts.copy()
        elif c.kind in ("sum", "sumc"):
            host[c.label] = np.where(active, rng.normal(50, 10, (4, G)),
                                     0).astype(dt)
        else:
            fill = np.inf if c.kind == "min" else -np.inf
            host[c.label] = np.where(active, rng.normal(50, 10, (4, G)),
                                     fill).astype(dt)
    for label in ("min_0", "max_0", "sum_0"):
        host[label][2, rng.integers(0, G, 3)] = np.nan
    host["min_0"][2, rng.integers(0, G, 2)] = -0.0
    return spec, host


@pytest.mark.parametrize("share", [0.0, 0.001, 0.1, 0.76, 1.0])
def test_read_slot_compact_matches_the_jax_package(share):
    """segment_agg.read_slot_compact (the compaction kernel's plain version
    on the CPU) against the JAX package's on the same seeded ring: the
    same active gids in ascending order and the same component values, bit
    for bit; the ring itself is left as it was."""
    G = 4096
    spec, host = seeded_ring(G, share, seed=int(share * 1000) + 1)
    state = sa.import_state(spec, host, "cpu")
    gids, rows = sa.read_slot_compact(spec, state, 2)
    jspec = jsa.WindowKernelSpec(
        components=tuple(jsa.with_compensation(jsa.components_for(
            [("count", 0), ("sum", 0), ("min", 0), ("max", 0),
             ("avg", 1)]))),
        num_value_cols=2, window_slots=4, group_capacity=G, length_ms=1000,
        slide_ms=1000, compensated=True)
    jgids, jrows = jsa.read_slot_compact(jspec, jsa.import_state(jspec, host),
                                         2)
    want = np.nonzero(host["count_star"][2] > 0)[0]
    np.testing.assert_array_equal(gids, want)
    np.testing.assert_array_equal(gids, np.asarray(jgids))
    assert gids.dtype == np.int32
    assert set(rows) == set(jrows) == {c.label for c in spec.components}
    for label, arr in rows.items():
        np.testing.assert_array_equal(arr.view(np.uint8),
                                      np.asarray(jrows[label]).view(np.uint8),
                                      err_msg=label)
    for label, plane in state.items():
        np.testing.assert_array_equal(plane.numpy(), host[label])


@pytest.mark.parametrize("accum", [torch.float32, torch.float64])
def test_compact_slot_reference_is_a_stable_copy(accum):
    """The plain version moves the active cells in ascending gid and counts
    them; 4- and 8-byte planes alike, NaN payloads and -0.0 kept."""
    spec, host = seeded_ring(1024, 0.3, seed=4, accum=accum)
    state = sa.import_state(spec, host, "cpu")
    labels = [c.label for c in spec.components]
    n, gids, outs = cs.compact_slot(state["count_star"][2],
                                    [state[lb][2] for lb in labels])
    want = np.nonzero(host["count_star"][2] > 0)[0]
    assert n.dtype == torch.int32 and int(n) == len(want)
    np.testing.assert_array_equal(gids.numpy(), want)
    for lb, o in zip(labels, outs):
        np.testing.assert_array_equal(o.numpy().view(np.uint8),
                                      host[lb][2][want].view(np.uint8))


# -- host pipeline ---------------------------------------------------------------


def test_partial_host_pipeline_parity():
    """Twin of tests/test_partial_merge.py:151: host_pipeline=True moves
    backend.accumulate onto a worker thread; the rows equal the
    synchronous path's bit for bit (same stripes, same merges) across
    growth (200 keys from a 128-wide ring) and null batches, and the JAX
    package's pipelined run at its parity tolerance."""
    raw = feed(0, keys=200, nulls=True)
    a, _ = run_port(raw, 1000, 250, device_strategy="partial_merge")
    b, ctx = run_port(raw, 1000, 250, device_strategy="partial_merge",
                      host_pipeline=True)
    assert_parity(a, b, rtol=0)
    op = window_exec(ctx)
    assert op.metrics()["grow_events"] > 0
    assert op._acc_exec is None  # the worker was shut down at the end
    assert_parity(run_jax(raw, 1000, 250, device_strategy="partial_merge",
                          host_pipeline=True), b)


def test_partial_host_pipeline_error_propagates(monkeypatch):
    """Twin of tests/test_partial_merge.py:162: a failure inside the
    worker-threaded accumulate surfaces on the stream's thread."""
    raw = feed(0, n_batches=8)
    orig = ss._HostPartialMixin.accumulate
    calls = {"n": 0}

    def boom(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected stripe failure")
        return orig(self, *a, **k)

    monkeypatch.setattr(ss._HostPartialMixin, "accumulate", boom)
    with pytest.raises(RuntimeError, match="injected stripe failure"):
        run_port(raw, 1000, device_strategy="partial_merge",
                 host_pipeline=True)


def test_host_pipeline_failure_raises_once_at_the_next_fence():
    """A failed accumulation raises at the next fence (``_join_acc``) or
    submission, and only once: the fence after it is clean."""
    from denormalized_tpu_torch.runtime import executor as texec

    raw = feed(1, n_batches=2)
    ctx = tt.Context(tt.EngineConfig(device="cpu",
                                     device_strategy="partial_merge",
                                     host_pipeline=True))
    ds = ctx.from_source(TSource.from_batches(
        port_batches(raw), timestamp_column="occurred_at_ms")).window(
        ["sensor_name"], std_aggs(TF, tt.col), 1000)
    op = texec.build_physical(ds._plan, ctx)
    while type(op).__name__ != "StreamingWindowExec":
        (op,) = op.children

    def fail(*_a):
        raise ValueError("worker failed")

    op._backend.accumulate = fail
    try:
        op._submit_acc()
        with pytest.raises(ValueError, match="worker failed"):
            op._join_acc()
        op._join_acc()  # raised once, not again
        op._submit_acc()
        op._acc_future.exception()  # let the task fail
        with pytest.raises(ValueError, match="worker failed"):
            op._submit_acc()  # the next submission surfaces it
    finally:
        op._acc_future = None
        op._shutdown_acc()


# -- asynchronous emission --------------------------------------------------------


def test_async_emission_same_rows_same_order():
    """partial_merge with a non-zero emit lag drains each block a trigger
    after it was read; a lag far beyond the run makes the deferral depend
    on the stripe's span alone, not the clock.  The rows leave in the same
    window order as with synchronous emission (lag 0), counts, min and max
    exact, sums to rtol=1e-6 (merges group other windows)."""
    raw = feed(5, n_batches=30, keys=12)
    sync, ctx0 = run_port(raw, 1000, 250, device_strategy="partial_merge",
                          emit_lag_ms=0)
    deferred, ctx1 = run_port(raw, 1000, 250, device_strategy="partial_merge",
                              emit_lag_ms=10**9)
    assert list(sync) == list(deferred)
    assert_parity(sync, deferred)
    m0, m1 = window_exec(ctx0).metrics(), window_exec(ctx1).metrics()
    assert m0["emit_blocks_deferred"] == 0 and m0["emit_blocks"] > 0
    assert m1["emit_blocks_deferred"] == m1["emit_blocks"] > 0
    starts = [k[0] for k in deferred]
    assert starts == sorted(starts)


# -- float64 rings ------------------------------------------------------------------


def f64_oracle(raw, values_f32: bool) -> dict:
    """(window start, sensor) → (count, sum) in float64 over the
    values the ring receives: the f32-rounded readings on row shipping (the
    JAX package's rule: rows ship as f32 and widen on the device), the
    readings themselves through partial_merge (the host reduces in f64)."""
    acc: dict = {}
    for ts, names, vals, _m in raw:
        v = vals.astype(np.float32).astype(np.float64) if values_f32 else vals
        for t, k, x in zip(ts.tolist(), names.tolist(), v.tolist()):
            key = (t // 1000 * 1000, k)
            c, s = acc.get(key, (0, []))
            s.append(x)
            acc[key] = (c + 1, s)
    return {k: (c, float(np.sum(np.asarray(s, np.float64))))
            for k, (c, s) in acc.items()}


@pytest.mark.parametrize("strategy", ["scatter", "auto", "partial_merge"])
def test_f64_ring_matches_a_float64_oracle(strategy):
    """accum_dtype=torch.float64: 'auto' takes the scatter path (the dense
    kernel is f32 only), partial_merge the merge's plain version on f64
    planes; sums and averages of values ~1e6 (σ = 1) to rtol=1e-12 of a
    float64 oracle, where an f32 ring misses by ~1e-7."""
    raw = feed(8, n_batches=16, keys=6, loc=1e6, scale=1.0)
    got, ctx = run_port(raw, device_strategy=strategy,
                        accum_dtype=torch.float64)
    op = window_exec(ctx)
    assert all(t.dtype == (torch.int32 if lb.startswith("count")
                           else torch.float64)
               for lb, t in op.backend._state.items())
    if strategy != "partial_merge":
        assert op.backend.scatter_updates > 0 and op.backend.dense_updates == 0
    want = f64_oracle(raw, values_f32=strategy != "partial_merge")
    assert set(got) == set(want)
    for k, (c, s) in want.items():
        assert got[k]["cnt"] == c
        np.testing.assert_allclose(got[k]["sm"], s, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got[k]["av"], s / c, rtol=1e-12, atol=0)
    f32, _ = run_port(raw, device_strategy=strategy)
    worst = max(abs(f32[k]["sm"] / want[k][1] - 1) for k in want)
    assert worst > 1e-10  # the same bound fails an f32 ring


def test_f64_ring_matches_the_jax_package_under_x64():
    """The JAX package with jax_enable_x64 on (in a child process: x64 is
    process-wide in JAX) through scatter and partial_merge, against the
    port's f64 runs: the same rows, counts exact, sums to rtol=1e-12."""
    raw = feed(9, n_batches=10, keys=5, loc=1e6, scale=1.0)
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "import jax\n"
        "import jax.numpy as jnp\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_window_options import feed, run_jax\n"
        "raw = feed(9, n_batches=10, keys=5, loc=1e6, scale=1.0)\n"
        "out = {}\n"
        "for s in ('scatter', 'partial_merge'):\n"
        "    rows = run_jax(raw, device_strategy=s, accum_dtype=jnp.float64)\n"
        "    out[s] = [[k[0], k[1], int(v['cnt']), float(v['sm'])]"
        " for k, v in rows.items()]\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_rows = json.loads(proc.stdout.strip().splitlines()[-1])
    for s in ("scatter", "partial_merge"):
        got, _ = run_port(raw, device_strategy=s, accum_dtype=torch.float64)
        want = {(ws, k): (c, sm) for ws, k, c, sm in jax_rows[s]}
        assert set(got) == set(want), s
        for key, (c, sm) in want.items():
            assert got[key]["cnt"] == c
            np.testing.assert_allclose(got[key]["sm"], sm, rtol=1e-12,
                                       atol=0, err_msg=f"{s} {key}")


def test_f64_merge_plain_version_keeps_hi_and_lo():
    """merge_partials_reference on an f64 ring folds the stripe's hi + lo
    f32 pair in f64, as the JAX package's merge_partials_body does under
    x64: the ring's sums equal the host's f64 sums to ~1e-14."""
    from denormalized_tpu_torch.ops.host_partial import HostPartialStripe
    from denormalized_tpu_torch.ops.merge_partials import merge_partials

    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for([("sum", 0), ("max", 0)])),
        num_value_cols=1, window_slots=8, group_capacity=128,
        length_ms=1000, slide_ms=250, accum_dtype=torch.float64)
    rng = np.random.default_rng(3)
    n = 20_000
    units = rng.integers(0, 6, n).astype(np.int64)
    gid = rng.integers(0, 50, n).astype(np.int32)
    vals = rng.normal(3e9, 5.0, (n, 1))
    stripe = HostPartialStripe(spec, 128)
    stripe.add_batch(units, rng.integers(0, 250, n).astype(np.int32), gid,
                     vals, None, None)
    packed, a_pad, _u, lean, dense = stripe.take_packed(0)
    state = sa.init_state(spec, "cpu")
    merge_partials(spec, stripe.SUB, a_pad, lean, dense, state,
                   torch.from_numpy(packed))
    want = np.zeros((8, 128))
    for f in range(spec.length_units):
        np.add.at(want, ((units - f) % 8, gid), vals[:, 0] * (units - f >= 0))
    got = state["sum_0"].numpy()
    live = want != 0
    np.testing.assert_allclose(got[live], want[live], rtol=1e-13, atol=0)
