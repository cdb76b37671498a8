"""Sharded windows end to end: twins of the JAX package's mesh tests, each
job run through both packages' ``Context`` on the same seeded batches —
the JAX package over its 8 virtual CPU devices, the port with every shard
on the CPU (``EngineConfig(device="cpu", mesh_devices=…)``).  Counts, row
sets and extrema exact; f32 sums and averages to rtol=1e-5.  Also the
port's multichip dry run (``denormalized_tpu_torch/testing/multichip.py``)
at n = 2, 4 and 8."""

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
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000


def _raw(seed, n_batches, n, span, keys, nulls=False, spread=None):
    """Seeded (ts, keys, readings, valid) batches; ``spread(b)`` widens the
    key space batch by batch."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * span + rng.integers(0, span, n)).astype(np.int64)
        hi = keys if spread is None else spread(b)
        names = np.array([f"s{i}" for i in rng.integers(0, hi, n)], dtype=object)
        vals = rng.normal(50, 10, n)
        valid = (rng.random(n) > 0.15) if nulls else None
        out.append((ts, names, vals, valid))
    return out


def _batches(pkg, raw):
    Schema, Field, DT, Batch = (
        (JSchema, JField, JType, JBatch) if pkg == "jax"
        else (TSchema, TField, TType, TBatch)
    )
    schema = Schema([
        Field("occurred_at_ms", DT.INT64, nullable=False),
        Field("sensor_name", DT.STRING, nullable=False),
        Field("reading", DT.FLOAT64),
    ])
    return [Batch(schema, [ts, k, v], None if m is None else [None, None, m])
            for ts, k, v, m in raw]


AGGS = ("count", "sum", "min", "max", "avg")


def _job(pkg, raw, length, slide=None, aggs=AGGS, **cfg):
    """{(window start, key): (agg values…)} of one bounded job."""
    if pkg == "jax":
        ctx, F, col, Src = jt.Context(JConfig(**cfg)), JF, jt.col, JSource
    else:
        ctx, F, col, Src = (tt.Context(tt.EngineConfig(device="cpu", **cfg)),
                            TF, tt.col, TSource)
    res = ctx.from_source(
        Src.from_batches(_batches(pkg, raw), timestamp_column="occurred_at_ms")
    ).window(
        ["sensor_name"],
        [getattr(F, a)(col("reading")).alias(a) for a in aggs],
        length, slide,
    ).collect()
    out = {}
    for i in range(res.num_rows):
        k = (int(res.column("window_start_time")[i]),
             str(res.column("sensor_name")[i]))
        assert k not in out, f"duplicate emission {k}"
        out[k] = tuple(float(res.column(a)[i]) for a in aggs)
    return out, ctx


def _assert_same(got, want, aggs=AGGS):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for k, w in want.items():
        g = got[k]
        for a, x, y in zip(aggs, g, w):
            if a in ("count", "min", "max"):
                assert x == y or (np.isnan(x) and np.isnan(y)), (k, a, x, y)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-5, err_msg=f"{k} {a}")


def _window_op(ctx):
    from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec

    op = ctx._last_physical
    while not isinstance(op, StreamingWindowExec):
        op = op.children[0]
    return op


def _shard_cfg(strategy, n=8, **kw):
    return dict(mesh_devices=n, shard_strategy=strategy,
                mesh_slices=2 if strategy == "two_level" else None, **kw)


@pytest.mark.parametrize("strategy", ["key_sharded", "partial_final", "two_level"])
def test_sharded_matches_single_device(strategy):
    """Twin of tests/test_sharded_state.py:72: the port's layout equals the
    JAX package's layout and the port's single-device run."""
    raw = _raw(11, 10, 512, 400, 300)
    want, _ = _job("jax", raw, 1000, **_shard_cfg(strategy))
    got, ctx = _job("torch", raw, 1000, **_shard_cfg(strategy))
    _assert_same(got, want)
    single, _ = _job("torch", raw, 1000)
    _assert_same(got, single)
    b = _window_op(ctx).backend
    assert b.strategy_name == strategy
    assert b.shard_scatter == [10] * 8


@pytest.mark.parametrize("strategy", ["key_sharded", "partial_final", "two_level"])
def test_sharded_growth(strategy):
    """Twin of :94: 5,000 keys grow G past 8 x 128 under the mesh (export,
    re-lay out, import with the same mesh); the per-shard counts carry
    across the rebuilds."""
    raw = _raw(12, 4, 4000, 500, 5000)
    want, _ = _job("jax", raw, 1000, aggs=("count", "sum"), **_shard_cfg(strategy))
    got, ctx = _job("torch", raw, 1000, aggs=("count", "sum"),
                    **_shard_cfg(strategy))
    _assert_same(got, want, ("count", "sum"))
    op = _window_op(ctx)
    assert op.metrics()["grow_events"] > 0
    assert op.backend.group_capacity % (128 * 8) == 0
    assert op.backend.shard_scatter == [4] * 8


def test_sharded_partial_merge_late_data_sliding():
    """Twin of :125: the key-sharded partial merge applies the single-device
    freeze-then-accumulate late-data rule on a sliding window."""
    raw = _raw(21, 4, 256, 600, 40)
    rng = np.random.default_rng(5)
    late = np.sort(T0 + rng.integers(600, 2400, 256)).astype(np.int64)
    raw.append((late, np.array([f"s{i}" for i in rng.integers(0, 40, 256)],
                               dtype=object), rng.normal(50, 10, 256), None))
    aggs = ("count", "sum")
    want, _ = _job("jax", raw, 1000, 250, aggs, mesh_devices=8,
                   device_strategy="partial_merge")
    got, ctx = _job("torch", raw, 1000, 250, aggs, mesh_devices=8,
                    device_strategy="partial_merge")
    _assert_same(got, want, aggs)
    single, _ = _job("torch", raw, 1000, 250, aggs)
    _assert_same(got, single, aggs)
    b = _window_op(ctx).backend
    assert b.strategy_name == "partial_merge/key_sharded"
    assert b.shard_merges == [b.merges] * 8 and b.merges > 0


@pytest.mark.parametrize("n", [2, 4, 8])
def test_partial_merge_key_sharded_mesh(n):
    """Twin of tests/test_partial_merge.py:351: cardinality ramps past the
    initial capacity, so growth re-lays the key-sharded partial merge."""
    raw = _raw(23, 20, 768, 300, None, spread=lambda b: 100 + b * 80)
    want, _ = _job("jax", raw, 1000, mesh_devices=8,
                   device_strategy="partial_merge")
    got, ctx = _job("torch", raw, 1000, mesh_devices=n,
                    device_strategy="partial_merge")
    assert len({k[1] for k in want}) > 1024
    _assert_same(got, want)
    assert _window_op(ctx).metrics()["grow_events"] > 0


def test_partial_merge_key_sharded_sliding():
    """Twin of tests/test_partial_merge.py:367 (k = 3 windows of 500/200
    ms)."""
    raw = _raw(0, 20, 400, 250, 10)
    want, _ = _job("jax", raw, 500, 200, device_strategy="scatter")
    got, _ = _job("torch", raw, 500, 200, mesh_devices=8,
                  device_strategy="partial_merge")
    _assert_same(got, want)


@pytest.mark.parametrize("option", ["device_finalize", "emission_compaction"])
def test_partial_merge_sharded_emission(option):
    """Twins of tests/test_partial_merge.py's finals (:457) and compaction
    (:475) over the mesh, with nulls: the shards' finals and compacted
    slots join on the host."""
    raw = _raw(0, 20, 400, 250, 10, nulls=True)
    want, _ = _job("jax", raw, 1000, mesh_devices=8,
                   device_strategy="partial_merge", **{option: True})
    got, ctx = _job("torch", raw, 1000, mesh_devices=8,
                    device_strategy="partial_merge", **{option: True})
    _assert_same(got, want)
    b = _window_op(ctx).backend
    if option == "emission_compaction":
        windows = _window_op(ctx).metrics()["windows_emitted"]
        assert b.shard_compactions == [windows] * 8


def test_partition_skew_on_partial_merge_mesh():
    """Partition watermarks (hint-driven, first_open rebased down) over the
    key-sharded partial merge: the skewed replay stays lossless."""
    from test_torch_partition_watermarks import _skew_counts, _skewed_source

    got, late = _skew_counts("torch", _skewed_source, mesh_devices=4,
                             device_strategy="partial_merge")
    for w in range(0, 4000, 1000):
        assert got.get((w, "a")) == 1000 and got.get((w, "b")) == 1000
    assert late == 0


@pytest.mark.parametrize("strategy", ["key_sharded", "partial_final"])
def test_sharded_state_survives_partition_skew(strategy):
    """Twin of tests/test_partition_watermarks.py:458."""
    from test_torch_partition_watermarks import _skew_counts, _skewed_source

    (jgot, jlate), (tgot, tlate) = (
        _skew_counts(pkg, _skewed_source, mesh_devices=8, shard_strategy=strategy)
        for pkg in ("jax", "torch"))
    assert tgot == jgot
    for w in range(0, 4000, 1000):
        assert tgot.get((w, "a")) == 1000, (strategy, w)
        assert tgot.get((w, "b")) == 1000, (strategy, w)
    assert tlate == jlate == 0


def test_partial_final_non_pow2_mesh():
    """Twin of tests/test_session_out_of_order.py:156: three shards split
    padded batches evenly."""
    rng = np.random.default_rng(3)
    raw = [(np.sort(T0 + b * 500 + rng.integers(0, 500, 100)).astype(np.int64),
            np.array(["x"] * 100, dtype=object), rng.normal(0, 1, 100), None)
           for b in range(5)]
    for pkg in ("jax", "torch"):
        got, _ = _job(pkg, raw, 1000, aggs=("count",), mesh_devices=3,
                      shard_strategy="partial_final")
        assert sum(v[0] for v in got.values()) == 500


def test_session_and_udaf_windows_ignore_the_mesh():
    """Sessions and accumulator windows are host operators: a mesh changes
    nothing for them, in either package."""
    raw = _raw(7, 6, 60, 800, 4)

    def sessions(pkg, **cfg):
        if pkg == "jax":
            ctx, F, col, Src = jt.Context(JConfig(**cfg)), JF, jt.col, JSource
        else:
            ctx, F, col, Src = (tt.Context(tt.EngineConfig(device="cpu", **cfg)),
                                TF, tt.col, TSource)
        res = ctx.from_source(Src.from_batches(
            _batches(pkg, raw), timestamp_column="occurred_at_ms")
        ).session_window(["sensor_name"], [F.count(col("reading")).alias("c")],
                         gap_ms=300).collect()
        return sorted(zip(res.column("sensor_name").tolist(),
                          res.column("window_start_time").tolist(),
                          res.column("c").tolist()))

    want = sessions("jax", mesh_devices=8)
    assert sessions("torch", mesh_devices=8) == want == sessions("torch")

    def distinct(pkg, **cfg):
        # approx_distinct lowers to its accumulator: UdafWindowExec
        if pkg == "jax":
            ctx, F, col, Src = jt.Context(JConfig(**cfg)), JF, jt.col, JSource
        else:
            ctx, F, col, Src = (tt.Context(tt.EngineConfig(device="cpu", **cfg)),
                                TF, tt.col, TSource)
        res = ctx.from_source(Src.from_batches(
            _batches(pkg, raw), timestamp_column="occurred_at_ms")
        ).window(["sensor_name"], [F.approx_distinct(col("reading")).alias("d")],
                 1000).collect()
        assert type(ctx._last_physical.input_op).__name__ == "UdafWindowExec"
        return sorted(zip(res.column("sensor_name").tolist(),
                          res.column("window_start_time").tolist(),
                          res.column("d").tolist()))

    want = distinct("jax", mesh_devices=8)
    assert distinct("torch", mesh_devices=8) == want == distinct("torch")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_port_dryrun_multichip(n):
    """The port's dry run passes its value-parity check on the CPU."""
    from denormalized_tpu_torch.testing.multichip import (
        dryrun_layouts,
        dryrun_multichip,
    )

    backends = dryrun_multichip(n, "cpu")
    assert sorted(backends) == sorted(dryrun_layouts(n))
    for name, b in backends.items():
        if name == "partial_merge":
            assert b.shard_merges == [b.merges] * n and b.merges > 0
        else:
            assert b.shard_scatter == [b.scatter_updates] * n
