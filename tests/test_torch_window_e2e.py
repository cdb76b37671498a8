"""The whole window job, JAX package vs the port: the same seeded batches
through ``denormalized_tpu`` Context(EngineConfig(device_strategy=s)) and
``denormalized_tpu_torch`` Context(EngineConfig(device="cpu")) must emit
the same row set with exact counts and extrema, and sums/avg to rtol=1e-5
(f32 sums in another order — the repo's dense-vs-scatter tolerance).  A
spy on the port's ``dense_update`` proves the dense path ran."""

import numpy as np
import pytest

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
from denormalized_tpu_torch.ops import dense_window as dw
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000


def _job(pkg, raw, slide, strategy, post_filter):
    """Run the job over ``raw`` = [(ts, names, readings, mask)] with one
    package; → ({(window_start, key): row}, port window operator or None)."""
    if pkg == "jax":
        Schema, Field, DT, Batch, Source, F, col = (
            JSchema, JField, JType, JBatch, JSource, JF, jt.col)
        ctx = jt.Context(JConfig(device_strategy=strategy))
    else:
        Schema, Field, DT, Batch, Source, F, col = (
            TSchema, TField, TType, TBatch, TSource, TF, tt.col)
        ctx = tt.Context(tt.EngineConfig(device="cpu", device_strategy=strategy))
    schema = Schema([
        Field("occurred_at_ms", DT.INT64, nullable=False),
        Field("sensor_name", DT.STRING, nullable=False),
        Field("reading", DT.FLOAT64),
    ])
    batches = [
        Batch(schema, [ts, names, vals], [None, None, mask])
        for ts, names, vals, mask in raw
    ]
    ds = ctx.from_source(
        Source.from_batches(batches, timestamp_column="occurred_at_ms")
    ).window(
        ["sensor_name"],
        [F.count(col("reading")).alias("cnt"),
         F.sum(col("reading")).alias("s"),
         F.min(col("reading")).alias("mn"),
         F.max(col("reading")).alias("mx"),
         F.avg(col("reading")).alias("a"),
         F.count().alias("rows")],
        1000, slide,
    )
    if post_filter:
        ds = ds.filter(col("a") > 50.0)
    res = ds.collect()
    out = {}
    for i in range(res.num_rows):
        key = (int(res.column("window_start_time")[i]),
               res.column("sensor_name")[i])
        assert key not in out, key
        out[key] = tuple(
            res.column(c)[i] for c in ("cnt", "s", "mn", "mx", "a", "rows")
        )
    return out


def _assert_same(jax_rows, port_rows):
    assert set(jax_rows) == set(port_rows)
    for k, j in jax_rows.items():
        p = port_rows[k]
        assert (j[0], j[5]) == (p[0], p[5]), (k, j, p)  # counts exact
        np.testing.assert_array_equal([j[2], j[3]], [p[2], p[3]], err_msg=str(k))
        np.testing.assert_allclose([j[1], j[4]], [p[1], p[4]], rtol=1e-5,
                                   err_msg=str(k))


def _compare(raw, slide=None, jax_strategy="scatter", post_filter=False,
             expect_dense=True, monkeypatch=None):
    calls = {"n": 0}
    orig = dw.dense_update

    def spy(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(dw, "dense_update", spy)
    port_rows = _job("torch", raw, slide, "auto", post_filter)
    jax_rows = _job("jax", raw, slide, jax_strategy, post_filter)
    assert (calls["n"] > 0) == expect_dense, calls
    assert jax_rows, "the job emitted nothing"
    _assert_same(jax_rows, port_rows)
    return jax_rows


def _stream(seed, n_batches=8, n=400, keys=23, span_ms=600, nulls=False):
    rng = np.random.default_rng(seed)
    raw = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * span_ms + rng.integers(0, span_ms, n))
        names = np.array(
            [f"k{i}" for i in rng.integers(0, keys, n)], dtype=object
        )
        vals = rng.normal(50, 10, n)
        mask = None
        if nulls:
            mask = rng.random(n) > 0.2
            vals[~mask & (rng.random(n) < 0.5)] = np.nan  # NaN behind mask
        raw.append((ts, names, vals, mask))
    return raw


@pytest.mark.parametrize("slide", [None, 500, 200], ids=["tumbling", "s500", "s200"])
@pytest.mark.parametrize("jax_strategy", ["scatter", "pallas_dense"])
def test_window_job_matches_jax(slide, jax_strategy, monkeypatch):
    _compare(_stream(7), slide, jax_strategy, monkeypatch=monkeypatch)


def test_nulls_and_late_rows(monkeypatch):
    raw = _stream(11, nulls=True)
    # a batch entirely behind the watermark (late rows dropped), then one
    # straddling it
    ts, names, vals, mask = raw[2]
    raw.insert(5, (ts - 1500, names, vals, mask))
    ts, names, vals, mask = raw[6]
    raw.insert(7, (np.sort(ts - np.arange(len(ts)) % 2 * 1200), names, vals, mask))
    rows = _compare(raw, 500, monkeypatch=monkeypatch)
    assert any(r[0] < r[5] for r in rows.values())  # some nulls counted out


def test_group_growth_in_first_batch(monkeypatch):
    # more than 128 keys in the FIRST batch: G grows 128 → 256 → 512
    _compare(_stream(13, n_batches=4, n=900, keys=300), 200,
             monkeypatch=monkeypatch)


def test_window_growth_one_batch_spans_many_windows(monkeypatch):
    # one batch spanning > 16 windows: W grows, and that batch exceeds the
    # dense span (scatter) while the others stay dense
    raw = _stream(17, n_batches=6)
    ts, names, vals, mask = raw[3]
    raw[3] = (np.sort(ts[0] + np.linspace(0, 25_000, len(ts)).astype(np.int64)),
              names, vals, mask)
    raw[4:] = [(t + 26_000, n, v, m) for t, n, v, m in raw[4:]]
    _compare(raw, None, monkeypatch=monkeypatch)


def test_post_window_filter(monkeypatch):
    rows = _compare(_stream(19), 200, post_filter=True, monkeypatch=monkeypatch)
    assert all(r[4] > 50.0 for r in rows.values())
