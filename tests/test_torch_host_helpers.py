"""The port's host helpers against the JAX package's: ``GeneratorSource``
(twins of tests/test_tumbling_window.py:120 and
tests/test_review_regressions.py:89), the ``RecordBatch`` pyarrow, pandas
and dict bridges (twins of tests/test_arrow_interop.py), and the
per-operator ``collect_metrics`` / ``log_metrics`` the executor logs at a
run's end."""

import logging

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.errors import SchemaError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.sources.memory import GeneratorSource, MemorySource

T0 = 1_700_000_000_000


def _sensor_schema(pkg="torch"):
    S, F, D = (Schema, Field, DataType) if pkg == "torch" else (
        JSchema, JField, JType)
    return S([F("occurred_at_ms", D.INT64, nullable=False),
              F("sensor_name", D.STRING, nullable=False),
              F("reading", D.FLOAT64)])


def _sensor(ts, names, vals, pkg="torch"):
    B = RecordBatch if pkg == "torch" else JBatch
    return B(_sensor_schema(pkg), [np.asarray(ts, np.int64),
                                   np.asarray(names, object),
                                   np.asarray(vals, np.float64)])


# -- GeneratorSource ------------------------------------------------------


def test_incremental_emission_before_close():
    """Twin of tests/test_tumbling_window.py:120: windows emit as the
    watermark passes them, not only at end of stream."""
    batches = [_sensor([T0 + i * 300 + j for j in range(3)], ["x"] * 3,
                       [1.0] * 3) for i in range(12)]
    fed = []

    def gen():
        for b in batches:
            fed.append(1)
            yield b

    ctx = tt.Context(tt.EngineConfig(device="cpu"))
    src = GeneratorSource(_sensor_schema(), [gen],
                          timestamp_column="occurred_at_ms", unbounded=False)
    assert not src.unbounded and src.name == "generator"
    ds = ctx.from_source(src).window(
        ["sensor_name"], [TF.count(tt.col("reading")).alias("cnt")], 1000)
    emitted_at, rows = [], 0
    for batch in ds.stream():
        emitted_at.append(len(fed))
        rows += batch.num_rows
    assert rows == 4
    assert emitted_at[0] < len(batches), "first window only emitted at EOS"
    assert sum(1 for e in emitted_at if e < len(batches)) >= 3


def test_generator_partitions_match_jax():
    """Two generator partitions through a window: the same rows in both
    packages, and the partition readers count the batches they served."""
    from denormalized_tpu.sources.memory import GeneratorSource as JGen

    def factories(pkg):
        def part(lead):
            def gen():
                for b in range(4):
                    yield _sensor(T0 + lead + b * 250 + np.arange(50),
                                  [f"k{b % 3}"] * 50, np.arange(50.0), pkg)
            return gen
        return [part(0), part(100)]

    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            ctx, F, col, G = jt.Context(), JF, jt.col, JGen
        else:
            ctx, F, col, G = (tt.Context(tt.EngineConfig(device="cpu")), TF,
                              tt.col, GeneratorSource)
        src = G(_sensor_schema(pkg), factories(pkg),
                timestamp_column="occurred_at_ms", unbounded=False)
        res = ctx.from_source(src).window(
            ["sensor_name"], [F.count(col("reading")).alias("c"),
                              F.sum(col("reading")).alias("s")], 1000,
        ).collect()
        out[pkg] = sorted(zip(res.column("window_start_time").tolist(),
                              res.column("sensor_name").tolist(),
                              res.column("c").tolist(),
                              res.column("s").tolist()))
    assert out["torch"] == out["jax"] and out["torch"]
    reader = GeneratorSource(_sensor_schema(), factories("torch")).partitions()[0]
    while reader.read() is not None:
        pass
    assert reader.offset_snapshot() == {"count": 4}


def test_source_error_propagates():
    """Twin of tests/test_review_regressions.py:89: a connector failure
    mid-stream raises, not truncates silently."""
    schema = Schema([Field("ts", DataType.INT64, nullable=False),
                     Field("k", DataType.STRING, nullable=False),
                     Field("v", DataType.FLOAT64)])

    def kv(ts, k, v):
        return RecordBatch(schema, [np.asarray(ts, np.int64),
                                    np.asarray(k, object), np.asarray(v)])

    def boom():
        yield kv([T0], ["a"], [1.0])
        raise RuntimeError("broker gone")

    def ok():
        for i in range(50):
            yield kv([T0 + i], ["b"], [1.0])

    ctx = tt.Context(tt.EngineConfig(device="cpu"))
    src = GeneratorSource(schema, [boom, ok], timestamp_column="ts",
                          unbounded=True)
    # the port's collect() refuses an unbounded source up front: read it
    # as a stream
    with pytest.raises(RuntimeError, match="broker gone"):
        for _ in ctx.from_source(src).stream():
            pass


# -- RecordBatch bridges ----------------------------------------------------


def _flat_batch(pkg="torch"):
    S, F, D, B = ((Schema, Field, DataType, RecordBatch) if pkg == "torch"
                  else (JSchema, JField, JType, JBatch))
    schema = S([F("ts", D.TIMESTAMP_MS, nullable=False),
                F("name", D.STRING, nullable=False),
                F("reading", D.FLOAT64), F("n", D.INT64), F("ok", D.BOOL)])
    return B(schema, [
        np.array([1000, 2000, 3000], dtype=np.int64),
        np.array(["a", "béta", "c"], dtype=object),
        np.array([0.5, 0.0, -2.5]),
        np.array([7, 0, 9], dtype=np.int64),
        np.array([True, False, True]),
    ], masks=[None, None, np.array([True, False, True]),
              np.array([True, False, True]), None])


def _same(a, b):
    """Two batches (either package) hold the same schema, values and
    masks."""
    assert [(f.name, f.dtype.name, f.nullable) for f in a.schema] == [
        (f.name, f.dtype.name, f.nullable) for f in b.schema]
    for name in a.schema.names:
        ma, mb = a.mask(name), b.mask(name)
        assert (ma is None) == (mb is None), name
        if ma is not None:
            np.testing.assert_array_equal(ma, mb)
        va, vb = a.column(name), b.column(name)
        assert va.dtype == vb.dtype, name
        assert va.tolist() == vb.tolist(), name


def test_pyarrow_roundtrip_matches_jax():
    """Twin of tests/test_arrow_interop.py:58."""
    back = RecordBatch.from_pyarrow(_flat_batch().to_pyarrow())
    _same(back, JBatch.from_pyarrow(_flat_batch("jax").to_pyarrow()))
    for name in ("reading", "n"):
        np.testing.assert_array_equal(back.mask(name), [True, False, True])


def test_from_pyarrow_external_batch():
    """Twin of :75: a batch pyarrow built directly, nulls and a timestamp
    column."""
    rb = pa.RecordBatch.from_pydict({
        "k": pa.array(["x", None, "z"]),
        "v": pa.array([1.5, 2.5, None]),
        "t": pa.array([1, 2, 3], type=pa.timestamp("ms")),
        "i": pa.array([4, None, 6], type=pa.int32()),
        "f": pa.array([1.0, 2.0, 3.0], type=pa.float32()),
        "b": pa.array([True, None, False]),
    })
    b = RecordBatch.from_pyarrow(rb)
    _same(b, JBatch.from_pyarrow(rb))
    assert b.schema.field("t").dtype is DataType.TIMESTAMP_MS
    assert b.column("k").tolist() == ["x", None, "z"]
    assert b.mask("v").tolist() == [True, True, False]


def test_from_pyarrow_table_and_nested():
    """Twin of :93 and :188: a chunked Table slice and STRUCT/LIST
    columns."""
    t = pa.Table.from_batches([
        pa.RecordBatch.from_pydict({"g": pa.array([{"lat": 1.0}]),
                                    "tags": pa.array([["a", "b"]])}),
        pa.RecordBatch.from_pydict({"g": pa.array([{"lat": 2.0}]),
                                    "tags": pa.array([[]], type=pa.list_(pa.string()))}),
    ])
    b = RecordBatch.from_pyarrow(t)
    _same(b, JBatch.from_pyarrow(t))
    assert b.column("tags").tolist() == [["a", "b"], []]
    assert b.schema.field("g").dtype is DataType.STRUCT


def test_from_pyarrow_normalizes_us_ns_timestamps():
    """Twin of :172."""
    rb = pa.RecordBatch.from_pydict({
        "us": pa.array([1_700_000_000_000_000], type=pa.timestamp("us")),
        "ns": pa.array([1_700_000_000_000_000_000], type=pa.timestamp("ns")),
    })
    b = RecordBatch.from_pyarrow(rb)
    assert b.column("us").tolist() == [1_700_000_000_000]
    assert b.column("ns").tolist() == [1_700_000_000_000]


def test_from_pyarrow_rejects_uint64():
    """Twin of :217."""
    rb = pa.RecordBatch.from_pydict({"u": pa.array([2**63 + 5], type=pa.uint64())})
    with pytest.raises(SchemaError):
        RecordBatch.from_pyarrow(rb)
    with pytest.raises(SchemaError, match="unsupported arrow type"):
        RecordBatch.from_pyarrow(pa.RecordBatch.from_pydict(
            {"d": pa.array([b"x"], type=pa.binary())}))


def test_to_pandas_matches_jax():
    pd = pytest.importorskip("pandas")
    got, want = _flat_batch().to_pandas(), _flat_batch("jax").to_pandas()
    pd.testing.assert_frame_equal(got, want)
    assert got["reading"].isna().tolist() == [False, True, False]


@pytest.mark.parametrize("data", [
    {"a": [1, 2, 3], "s": ["x", "y", "z"], "f": [0.5, 1.5, 2.5],
     "b": [True, False, True]},
    {"o": np.array([True, False], dtype=object), "u": np.array(["p", "q"])},
])
def test_from_pydict_matches_jax(data):
    _same(RecordBatch.from_pydict(data), JBatch.from_pydict(data))


def test_from_pydict_with_schema_and_drop():
    schema = Schema([Field("a", DataType.INT64), Field("v", DataType.FLOAT64)])
    b = RecordBatch.from_pydict({"a": [1, 2], "v": [1, 2], "x": [0, 0]}, schema)
    assert b.column("v").dtype == np.float64 and b.schema.names == ["a", "v"]
    with pytest.raises(SchemaError, match="missing column 'v'"):
        RecordBatch.from_pydict({"a": [1]}, schema)
    dropped = _flat_batch().drop(["name", "ok"])
    _same(dropped, _flat_batch("jax").drop(["name", "ok"]))
    assert dropped.schema.names == ["ts", "reading", "n"]
    np.testing.assert_array_equal(dropped.mask("n"), [True, False, True])


# -- collect_metrics / log_metrics -----------------------------------------


def test_collect_metrics_keys_match_jax(caplog):
    """Per-operator metrics keyed by the checkpoint DFS ids — the same ids
    the JAX package reports — and logged at a run's end while tracing is
    on."""
    from denormalized_tpu.runtime.tracing import collect_metrics as jcollect
    from denormalized_tpu_torch.runtime import tracing

    batches = [_sensor(T0 + b * 400 + np.arange(100), ["a", "b"] * 50,
                       np.arange(100.0)) for b in range(6)]
    jbatches = [_sensor(T0 + b * 400 + np.arange(100), ["a", "b"] * 50,
                        np.arange(100.0), "jax") for b in range(6)]
    ctx = tt.Context(tt.EngineConfig(device="cpu"))
    ctx.from_source(MemorySource.from_batches(
        batches, timestamp_column="occurred_at_ms")).filter(
        tt.col("reading") > 5).window(
        ["sensor_name"], [TF.count(tt.col("reading")).alias("c")], 1000
    ).collect()
    from denormalized_tpu.sources.memory import MemorySource as JSource

    jctx = jt.Context()
    jctx.from_source(JSource.from_batches(
        jbatches, timestamp_column="occurred_at_ms")).filter(
        jt.col("reading") > 5).window(
        ["sensor_name"], [JF.count(jt.col("reading")).alias("c")], 1000
    ).collect()
    got = tracing.collect_metrics(ctx._last_physical)
    want = jcollect(jctx._last_physical)
    assert sorted(got) == sorted(want)
    win = next(k for k in got if k.endswith("StreamingWindowExec"))
    assert got[win]["rows_in"] == want[win]["rows_in"] == 6 * 94

    old = tracing._TRACING
    try:
        tracing.enable_tracing()
        with caplog.at_level(logging.INFO, logger="denormalized_tpu_torch"):
            ctx.from_source(MemorySource.from_batches(
                batches, timestamp_column="occurred_at_ms"), name="m2").window(
                ["sensor_name"], [TF.count(tt.col("reading")).alias("c")], 1000
            ).collect()
    finally:
        tracing._TRACING = old
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("metrics ")]
    assert any("StreamingWindowExec" in m and "rows_in" in m for m in lines)
