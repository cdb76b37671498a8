"""The port's ``partial_merge`` path end to end against the JAX package's:
the same seeded batches through ``denormalized_tpu`` Context(EngineConfig(
device_strategy="partial_merge")) on the CPU — the oracle — and
``denormalized_tpu_torch`` Context(EngineConfig(device="cpu",
device_strategy="partial_merge")).  Port twins of tests/test_partial_merge.py:
window shapes, nulls, the lean → full layout switch, ungrouped, late rows,
growth, compensated sums, a giant-span batch, ±inf/NaN/f32 overflow, and
the numpy reducer vs the native one; plus the strategy routing and the
emit-lag default per device.  The same row set, counts and extrema exact
(NaN where NaN), sums and averages to rtol=1e-5 (f32 ring adds in another
order)."""

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
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.ops import host_partial as thp
from denormalized_tpu_torch.ops import merge_partials as tmp
from denormalized_tpu_torch.ops import segment_agg as tsa
from denormalized_tpu_torch.parallel import sharded_state as tss
from denormalized_tpu_torch.physical import window_exec as twe
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec
from denormalized_tpu_torch.runtime.executor import build_physical
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000
AGGS = ("cnt", "mn", "mx", "av", "sm")


def _job(pkg, raw, length, slide=None, strategy="partial_merge",
         groups=("sensor_name",), **cfg):
    """Run the job over ``raw`` = [(ts, names, readings, mask|None)] with
    one package → ({(window_start, *keys): {agg: value}}, port window
    operator or None)."""
    if pkg == "jax":
        Schema, Field, DT, Batch, Source, F, col = (
            JSchema, JField, JType, JBatch, JSource, JF, jt.col)
        ctx = jt.Context(JConfig(device_strategy=strategy, **cfg))
    else:
        Schema, Field, DT, Batch, Source, F, col = (
            TSchema, TField, TType, TBatch, TSource, TF, tt.col)
        ctx = tt.Context(tt.EngineConfig(device="cpu", device_strategy=strategy,
                                         **cfg))
    schema = Schema([
        Field("occurred_at_ms", DT.INT64, nullable=False),
        Field("sensor_name", DT.STRING, nullable=False),
        Field("reading", DT.FLOAT64),
    ])
    batches = [
        Batch(schema, [np.asarray(ts, np.int64), np.asarray(names, object),
                       np.asarray(vals, np.float64)], [None, None, mask])
        for ts, names, vals, mask in raw
    ]
    ds = ctx.from_source(
        Source.from_batches(batches, timestamp_column="occurred_at_ms")
    ).window(
        list(groups),
        [F.count(col("reading")).alias("cnt"),
         F.min(col("reading")).alias("mn"),
         F.max(col("reading")).alias("mx"),
         F.avg(col("reading")).alias("av"),
         F.sum(col("reading")).alias("sm")],
        length, slide,
    )
    res = ds.collect()
    out = {}
    for i in range(res.num_rows):
        key = (int(res.column("window_start_time")[i]),) + tuple(
            res.column(g)[i] for g in groups)
        assert key not in out, f"duplicate emission {key}"
        out[key] = {a: res.column(a)[i] for a in AGGS}
    op = None
    if pkg == "torch":
        op = ctx._last_physical
        while not isinstance(op, StreamingWindowExec):
            (op,) = op.children
    return out, op


def _assert_same(want, got, rtol=1e-5):
    assert set(want) == set(got), (set(want) ^ set(got))
    for k, w in want.items():
        g = got[k]
        assert w["cnt"] == g["cnt"], (k, w, g)
        np.testing.assert_array_equal([w["mn"], w["mx"]], [g["mn"], g["mx"]],
                                      err_msg=str(k))
        np.testing.assert_allclose([w["sm"], w["av"]], [g["sm"], g["av"]],
                                   rtol=rtol, err_msg=str(k))


def _compare(raw, length, slide=None, **kw):
    """JAX partial_merge vs the port's → (JAX rows, port window operator)."""
    want, _ = _job("jax", raw, length, slide, **kw)
    got, op = _job("torch", raw, length, slide, **kw)
    assert want, "the job emitted nothing"
    _assert_same(want, got)
    assert op.backend.strategy_name == "partial_merge"
    m = op.metrics()
    assert m["partial_merges"] == op.backend.merges > 0
    assert m["device_steps"] == op.backend.merges
    return want, op


def _stream(seed, n_batches=24, rows=400, keys=10, span=250, nulls=False,
            t0=T0):
    rng = np.random.default_rng(seed)
    raw = []
    for b in range(n_batches):
        ts = np.sort(t0 + b * span + rng.integers(0, span, rows))
        names = np.array([f"s{i}" for i in rng.integers(0, keys, rows)],
                         dtype=object)
        vals = rng.normal(50.0, 10.0, rows)
        mask = None
        if nulls:
            mask = rng.random(rows) > 0.15
            vals[~mask & (rng.random(rows) < 0.5)] = np.nan  # behind mask
        raw.append((ts, names, vals, mask))
    return raw


@pytest.mark.parametrize(
    "length,slide", [(1000, None), (1000, 250), (500, 200)],
    ids=["tumbling", "sliding_divisible", "sliding_ragged"],
)
def test_partial_merge_matches_jax(length, slide):
    _, op = _compare(_stream(0), length, slide)
    # the CPU ran the plain version: the kernel's counter never moved
    assert tmp.merge_partials_launches == 0


def test_partial_with_nulls():
    _compare(_stream(1, nulls=True), 1000)


def test_partial_lean_to_full_transition(monkeypatch):
    """Null-free stripes pack lean, the first null switches to the full
    layout; counts in the null windows count valid rows only."""
    layouts = []
    orig = thp.HostPartialStripe.take_packed

    def spy(self, base_mod):
        r = orig(self, base_mod)
        if r is not None:
            layouts.append(r[3])
        return r

    monkeypatch.setattr(thp.HostPartialStripe, "take_packed", spy)
    clean = _stream(3, n_batches=12)
    dirty = [(ts + 12 * 250, n, v, m)
             for ts, n, v, m in _stream(4, n_batches=12, nulls=True)]
    want, _ = _compare(clean + dirty, 1000)
    assert True in layouts and False in layouts
    rows = {}
    for ts, names, _v, _m in clean + dirty:
        for t, nm in zip(ts.tolist(), names.tolist()):
            rows[(t // 1000 * 1000, nm)] = rows.get((t // 1000 * 1000, nm), 0) + 1
    assert any(v["cnt"] < rows[k] for k, v in want.items())


def test_partial_ungrouped():
    want, _ = _compare(_stream(5), 1000, groups=())
    assert len(want) > 3


def test_partial_late_rows_dropped():
    raw = _stream(6, n_batches=12)
    rng = np.random.default_rng(9)
    late = (np.sort(T0 + rng.integers(0, 200, 100)),
            np.array(["s0", "s1"] * 50, dtype=object),
            rng.normal(0, 1, 100), None)
    _, op = _compare(raw[:8] + [late] + raw[8:], 1000)
    assert op.metrics()["late_rows"] == 100


def test_partial_sliding_late_rows_freeze_then_accumulate():
    """A sliding job with rows behind the watermark whose units feed still
    open windows: closable windows emit first, then the batch folds."""
    raw = _stream(7, n_batches=16, span=300)
    ts, names, vals, mask = raw[9]
    raw[9] = (np.sort(ts - (np.arange(len(ts)) % 3) * 700), names, vals, mask)
    _, op = _compare(raw, 1000, 200, emit_lag_ms=10_000)
    assert op.metrics()["late_rows"] > 0  # some rows sat behind the watermark


def test_partial_growth():
    """G and W growth mid-stream: the stripe merges before each regrow."""
    rng = np.random.default_rng(3)
    raw = []
    for b in range(30):
        ts = np.sort(T0 + b * 200 + rng.integers(0, 200, 300))
        hi = 20 + b * 12  # cardinality ramps past the 128 default capacity
        names = np.array([f"k{i}" for i in rng.integers(0, hi, 300)],
                         dtype=object)
        raw.append((ts, names, rng.normal(10.0, 3.0, 300), None))
    want, op = _compare(raw, 1000)
    assert len({k[1] for k in want}) > 128
    assert op.metrics()["grow_events"] > 0


def test_partial_compensated():
    _, op = _compare(_stream(8), 1000, 250, compensated_sums=True)
    assert op.backend.spec.compensated
    assert any(c.kind == "sumc" for c in op.backend.spec.components)


def test_partial_giant_span_batch():
    """One batch over 40 slide units (> U_MAX = 16) is chunk-folded."""
    rng = np.random.default_rng(13)
    n = 40_000
    raw = [(np.sort(T0 + rng.integers(0, 40_000, n)),
            np.array([f"s{i}" for i in rng.integers(0, 6, n)], dtype=object),
            rng.normal(1.0, 0.1, n), None)]
    want, op = _compare(raw, 1000)
    assert len({k[0] for k in want}) >= 39
    assert op.backend.merges >= 3


@pytest.mark.parametrize("special", ["f32_overflow", "inf", "nan"])
def test_partial_nonfinite_values(special):
    """f32-overflowing sums and ±inf readings end at +inf, never NaN; a
    valid NaN poisons min and max — on both packages."""
    n = 400
    ts = np.arange(T0, T0 + n, dtype=np.int64)
    names = np.array(["a", "b"] * (n // 2), dtype=object)
    vals = np.ones(n)
    if special == "f32_overflow":
        vals[:] = 1e38
    elif special == "inf":
        vals[3] = np.inf
    else:
        vals[7] = np.nan  # key 'b'
    tail = (np.arange(T0 + 2000, T0 + 2064, dtype=np.int64),
            np.array(["a"] * 64, dtype=object), np.ones(64), None)
    want, _ = _compare([(ts, names, vals, None), tail], 1000)
    ws = T0 // 1000 * 1000
    if special == "nan":
        assert np.isnan(want[(ws, "b")]["mn"]) and np.isnan(want[(ws, "b")]["mx"])
    else:
        assert np.isposinf(want[(ws, "b")]["sm"])


def test_partial_numpy_reducer_matches_native(monkeypatch):
    raw = _stream(10, nulls=True)
    native, op = _job("torch", raw, 500, 200)
    assert op.backend.stripe.native_batches > 0
    assert op.backend.stripe.numpy_batches == 0
    monkeypatch.setattr(thp, "_native", lambda: None)
    numpy_rows, op = _job("torch", raw, 500, 200)
    assert op.backend.stripe.numpy_batches > 0
    assert op.backend.stripe.native_batches == 0
    _assert_same(native, numpy_rows, rtol=1e-6)


def _ts_field():
    return TField("occurred_at_ms", TType.INT64, nullable=False)


def _spec():
    return tsa.WindowKernelSpec(
        components=tuple(tsa.components_for([("count", 0), ("sum", 0)])),
        num_value_cols=1, window_slots=4, group_capacity=128,
        length_ms=1000, slide_ms=1000,
    )


def test_auto_stays_row_shipping_and_partial_merge_resolves():
    """'auto' keeps row shipping on every device (the JAX package's rule
    for a co-located GPU); 'partial_merge' resolves to the host-partial
    backend."""
    auto = tss.make_sharded_state(_spec(), "cpu", "auto")
    assert type(auto) is tss.SingleDeviceWindowState
    assert not auto.accumulates_host
    assert auto.strategy_name.startswith("row_shipping")
    pm = tss.make_sharded_state(_spec(), "cpu", "partial_merge")
    assert isinstance(pm, tss.PartialMergeWindowState)
    assert pm.accumulates_host and pm.strategy_name == "partial_merge"
    with pytest.raises(RuntimeError, match="accumulate"):
        pm.update()
    # through the public API, the default config ships rows
    _, op = _job("torch", _stream(11, n_batches=4), 1000, strategy="auto")
    assert not op.backend.accumulates_host
    assert op.metrics()["partial_merges"] == 0


@pytest.mark.parametrize("device, lag_s", [("cpu", 0.0), ("cuda", 0.2),
                                           ("cuda:1", 0.2)])
def test_emit_lag_default_per_device(monkeypatch, device, lag_s):
    """emit_lag_ms=None is 0 on the CPU and 200 ms on the card; an explicit
    value wins.  (The ring is built on the CPU here: only the rule is
    under test.)"""
    monkeypatch.setattr(
        twe, "make_sharded_state",
        lambda spec, _dev, strategy, *mesh: tss.make_sharded_state(
            spec, "cpu", strategy, *mesh),
    )
    ctx = tt.Context(tt.EngineConfig(device="cpu"))
    ds = ctx.from_source(
        TSource.from_batches(
            [TBatch(TSchema([_ts_field(), TField("sensor_name", TType.STRING),
                             TField("reading", TType.FLOAT64)]),
                    [np.array([T0]), np.array(["a"], dtype=object),
                     np.array([1.0])])],
            timestamp_column="occurred_at_ms",
        )
    ).window(["sensor_name"], [TF.count(tt.col("reading")).alias("c")], 1000)
    for cfg_lag, want in ((None, lag_s), (35, 0.035)):
        ctx.config = tt.EngineConfig(device=device,
                                     device_strategy="partial_merge",
                                     emit_lag_ms=cfg_lag)
        op = build_physical(ds._plan, ctx)
        while not isinstance(op, StreamingWindowExec):
            (op,) = op.children
        assert op._emit_lag_s == want
        assert op._device == torch.device(device)
