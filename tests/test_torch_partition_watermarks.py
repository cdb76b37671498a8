"""Per-partition watermarks (``EngineConfig.partition_watermarks``), JAX
package vs the port: the same seeded multi-partition sources through
``denormalized_tpu`` and ``denormalized_tpu_torch``
(``EngineConfig(device="cpu")``) must count the same rows.  Twins of
``tests/test_partition_watermarks.py`` (bounded skew exact and under the
legacy rule, join sides under skew, partitioned join replay), a
single-device analogue of its sharded-state test over the port's device
strategies, and the source's own item stream and tracker held against the
JAX package's.  Counts are exact."""

from types import SimpleNamespace

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
from denormalized_tpu.physical import simple_execs as jsx
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.physical import simple_execs as tsx
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000
PKGS = ("jax", "torch")


def ns(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        return SimpleNamespace(
            ctx=lambda **kw: jt.Context(JConfig(**kw)), Schema=JSchema,
            Field=JField, DT=JType, Batch=JBatch, Source=JSource, F=JF,
            col=jt.col, sx=jsx,
        )
    return SimpleNamespace(
        ctx=lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)),
        Schema=TSchema, Field=TField, DT=TType, Batch=TBatch, Source=TSource,
        F=TF, col=tt.col, sx=tsx,
    )


def _schema(p):
    return p.Schema([
        p.Field("occurred_at_ms", p.DT.INT64, nullable=False),
        p.Field("sensor_name", p.DT.STRING, nullable=False),
        p.Field("reading", p.DT.FLOAT64),
    ])


def _batch(p, ts, names, vals):
    return p.Batch(_schema(p), [np.asarray(ts, np.int64),
                                np.asarray(names, object),
                                np.asarray(vals, np.float64)])


def _span_batch(p, ms_lo, ms_hi, key, step=1):
    ts = np.arange(T0 + ms_lo, T0 + ms_hi, step, dtype=np.int64)
    return _batch(p, ts, [key] * len(ts), np.ones(len(ts)))


def _skewed_source(p):
    """Both partitions cover [0, 4000) ms; partition 0 advances 1000 ms a
    batch, partition 1 500 ms a batch, so round-robin exhausts partition 0
    first (the reference test's source)."""
    p0 = [_span_batch(p, lo, lo + 1000, "a") for lo in range(0, 4000, 1000)]
    p1 = [_span_batch(p, lo, lo + 500, "b") for lo in range(0, 4000, 500)]
    return p.Source([p0, p1], timestamp_column="occurred_at_ms")


def _probe_source(p):
    """Two partitions of 5 batches of 200 rows, partition 0's event time
    5 s ahead of partition 1's."""
    parts = []
    for lead in (5000, 0):
        parts.append([
            _batch(p, T0 + lead + b * 200 + np.arange(200), ["s"] * 200,
                   np.ones(200))
            for b in range(5)])
    return p.Source(parts, timestamp_column="occurred_at_ms")


def _counts(ds) -> dict:
    got = {}
    for b in ds.stream():
        if not b.schema.has("window_start_time"):
            continue
        for i in range(b.num_rows):
            k = (int(b.column("window_start_time")[i]) - T0,
                 str(b.column("sensor_name")[i]))
            got[k] = got.get(k, 0) + int(b.column("c")[i])
    return got


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _late_rows(ctx) -> int:
    return sum(op.metrics().get("late_rows", 0)
               for op in _walk(ctx._last_physical))


def _skew_counts(pkg, source_of, **cfg):
    p = ns(pkg)
    ctx = p.ctx(**cfg)
    ds = ctx.from_source(source_of(p)).window(
        ["sensor_name"], [p.F.count(p.col("reading")).alias("c")], 1000)
    return _counts(ds), _late_rows(ctx)


def test_bounded_skew_exact_with_partition_watermarks():
    """Twin of tests/test_partition_watermarks.py:82: 'auto' turns the
    tracker on for a bounded source of two partitions, and no row of the
    slower partition drops."""
    (jgot, jlate), (tgot, tlate) = (
        _skew_counts(pkg, _skewed_source) for pkg in PKGS)
    assert tgot == jgot
    for w in range(0, 4000, 1000):
        assert tgot.get((w, "a")) == 1000
        assert tgot.get((w, "b")) == 1000
    assert tlate == jlate == 0


def test_bounded_skew_drops_under_legacy_semantics():
    """Twin of :94: with ``partition_watermarks=False`` both packages
    late-drop the same rows of partition 1."""
    (jgot, jlate), (tgot, tlate) = (
        _skew_counts(pkg, _skewed_source, partition_watermarks=False)
        for pkg in PKGS)
    assert tgot == jgot
    for w in range(0, 4000, 1000):
        assert tgot.get((w, "a")) == 1000
    assert tlate == jlate > 0
    assert sum(v for (w, k), v in tgot.items() if k == "b") < 4000


@pytest.mark.parametrize("partition_watermarks,rows", [
    ("auto", 2000), (True, 2000), (False, 1000)])
def test_two_partition_probe(partition_watermarks, rows):
    """Partition 0's event time 5 s ahead of partition 1's: both packages
    count every row with per-partition watermarks and late-drop partition
    1 under the legacy max-of-min rule."""
    (jgot, jlate), (tgot, tlate) = (
        _skew_counts(pkg, _probe_source,
                     partition_watermarks=partition_watermarks)
        for pkg in PKGS)
    assert tgot == jgot
    assert sum(tgot.values()) == rows
    assert tlate == jlate == 2000 - rows


@pytest.mark.parametrize("partition_watermarks", ["auto", False])
def test_source_items_match_the_jax_package(partition_watermarks):
    """The port's SourceExec yields the JAX package's items on the skewed
    source: the announcement first, then each batch with the partition
    hint it advances, in the same order (no hints at all under False)."""

    def items(pkg):
        p = ns(pkg)
        out = []
        src = p.sx.SourceExec(_skewed_source(p),
                              partition_watermarks=partition_watermarks)
        for it in src.run():
            if isinstance(it, (JBatch, TBatch)):
                ts = np.asarray(it.column("occurred_at_ms"))
                out.append(("batch", int(ts.min()), int(ts.max())))
            elif type(it).__name__ == "WatermarkHint":
                out.append(("hint", int(it.ts_ms), it.kind))
            else:
                out.append((type(it).__name__,))
        return out

    jitems, titems = (items(pkg) for pkg in PKGS)
    assert titems == jitems
    hints = [i for i in titems if i[0] == "hint"]
    assert bool(hints) == (partition_watermarks == "auto")


@pytest.mark.parametrize("seed", range(4))
def test_tracker_matches_the_jax_package(seed):
    """The tracker alone, fed one seeded sequence of observe/finish/advance
    calls over 3 partitions by both packages: the same hints."""
    rng = np.random.default_rng(seed)
    jp, tp = ns("jax"), ns("torch")
    jtrk = jsx._PartitionWatermarks(3, None)
    ttrk = tsx._PartitionWatermarks(3)
    finished = set()

    def read_one(p, ts):
        src = p.Source([[_batch(p, ts, ["k"] * len(ts), np.ones(len(ts)))]],
                       timestamp_column="occurred_at_ms")
        return src.partitions()[0].read()  # canonical timestamp column

    def hint(h):
        return None if h is None else (int(h.ts_ms), h.kind)

    seen = []
    # every partition speaks once first, then a seeded mix of calls
    for step in range(43):
        i = step if step < 3 else int(rng.integers(0, 3))
        op = "observe" if step < 3 else rng.choice(
            ["observe", "observe", "advance", "finish"])
        if op == "observe" and i not in finished:
            ts = T0 + int(rng.integers(0, 5000)) + np.arange(
                int(rng.integers(1, 5)))
            got = (jtrk.observe(i, read_one(jp, ts)),
                   ttrk.observe(i, read_one(tp, ts)))
        elif op == "finish":
            finished.add(i)
            got = (jtrk.finish(i), ttrk.finish(i))
        else:
            got = (jtrk.advance(), ttrk.advance())
        assert hint(got[1]) == hint(got[0])
        seen.append(hint(got[1]))
    assert any(seen)


def _join_skew_rows(pkg):
    p = ns(pkg)
    ctx = p.ctx()
    right = [_span_batch(p, 0, 4000, "a", step=100)]
    lds = ctx.from_source(_skewed_source(p), name="pl").window(
        ["sensor_name"], [p.F.count(p.col("reading")).alias("lc")], 1000)
    rds = (
        ctx.from_source(p.Source([right], timestamp_column="occurred_at_ms"),
                        name="pr")
        .window(["sensor_name"], [p.F.count(p.col("reading")).alias("rc")],
                1000)
        .with_column_renamed("sensor_name", "rs")
        .with_column_renamed("window_start_time", "rws")
        .with_column_renamed("window_end_time", "rwe")
    )
    res = lds.join(
        rds, "inner", ["sensor_name", "window_start_time"], ["rs", "rws"]
    ).collect()
    got = {}
    for i in range(res.num_rows):
        got[(str(res.column("sensor_name")[i]),
             int(res.column("window_start_time")[i]) - T0)] = (
            int(res.column("lc")[i]), int(res.column("rc")[i]))
    return got, _late_rows(ctx)


def test_join_sides_survive_partition_skew():
    """Twin of :298: a skewed two-partition join side keeps every window
    of its slow partition (nothing in the plan late-drops)."""
    (jgot, jlate), (tgot, tlate) = (_join_skew_rows(pkg) for pkg in PKGS)
    assert tgot == jgot
    for w in range(0, 4000, 1000):
        assert tgot.get(("a", w)) == (1000, 10)
    assert tlate == jlate == 0


def _replay_sides(seed):
    """The reference test's seeded sides: 1-3 partitions each of ragged
    batches over [0, 4000) ms → (L, left parts, right parts) as raw
    arrays."""
    rng = np.random.default_rng(seed)
    L = int(rng.choice([500, 1000]))
    span = 4000

    def make_side(n_parts):
        parts = []
        for _ in range(n_parts):
            batches, pos = [], 0
            while pos < span:
                width = int(rng.integers(100, 1500))
                hi = min(pos + width, span)
                n = int(rng.integers(1, 40))
                ts = np.sort(rng.integers(pos, hi, n)) + T0
                ks = rng.choice(["a", "b", "c"], n)
                batches.append((ts, list(ks)))
                pos = hi + int(rng.integers(0, 300))
            parts.append(batches)
        return parts

    return (L, make_side(int(rng.integers(1, 4))),
            make_side(int(rng.integers(1, 4))))


def _replay_join(pkg, seed, L, left_parts, right_parts):
    p = ns(pkg)

    def source(parts):
        return p.Source(
            [[_batch(p, ts, ks, np.ones(len(ts))) for ts, ks in part]
             for part in parts],
            timestamp_column="occurred_at_ms")

    ctx = p.ctx()
    lds = ctx.from_source(source(left_parts), name=f"jl{seed}").window(
        ["sensor_name"], [p.F.count(p.col("reading")).alias("lc")], L)
    rds = (
        ctx.from_source(source(right_parts), name=f"jr{seed}")
        .window(["sensor_name"], [p.F.count(p.col("reading")).alias("rc")],
                L)
        .with_column_renamed("sensor_name", "rs")
        .with_column_renamed("window_start_time", "rws")
        .with_column_renamed("window_end_time", "rwe")
    )
    res = lds.join(
        rds, "inner", ["sensor_name", "window_start_time"], ["rs", "rws"]
    ).collect()
    return {
        (int(res.column("window_start_time")[i]) - T0,
         str(res.column("sensor_name")[i])): (
            int(res.column("lc")[i]), int(res.column("rc")[i]))
        for i in range(res.num_rows)
    }


@pytest.mark.parametrize("seed", range(12))
def test_partitioned_join_replay_is_lossless(seed):
    """Twin of :342: both join inputs are skewed multi-partition windowed
    streams; both packages emit the inner join of the two sides' lossless
    window counts."""
    L, left_parts, right_parts = _replay_sides(seed)

    def window_oracle(parts):
        want = {}
        for part in parts:
            for ts, ks in part:
                for t, k in zip(ts, ks):
                    key = ((int(t) // L) * L - T0, str(k))
                    want[key] = want.get(key, 0) + 1
        return want

    lw, rw = window_oracle(left_parts), window_oracle(right_parts)
    expect = {k: (lw[k], rw[k]) for k in lw if k in rw}
    jgot, tgot = (_replay_join(pkg, seed, L, left_parts, right_parts)
                  for pkg in PKGS)
    assert tgot == jgot == expect


@pytest.mark.parametrize("strategy", ["scatter", "auto", "partial_merge"])
def test_device_strategies_survive_partition_skew(strategy):
    """Single-device analogue of :458: hints drive the watermark whatever
    the port's device strategy; the skewed replay stays lossless, as in
    the JAX package on its single-device path."""
    (jgot, jlate), (tgot, tlate) = (
        _skew_counts(pkg, _skewed_source, device_strategy=strategy)
        for pkg in PKGS)
    assert tgot == jgot
    for w in range(0, 4000, 1000):
        assert tgot.get((w, "a")) == 1000
        assert tgot.get((w, "b")) == 1000
    assert tlate == jlate == 0
