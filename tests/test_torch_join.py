"""The stream-stream join, JAX package vs the port: the same seeded batches
through ``denormalized_tpu`` and ``denormalized_tpu_torch``
(``EngineConfig(device="cpu")``) must emit the same rows.  Twins of
``tests/test_join.py``, plus bench.py's config-4 query (two windowed
streams joined on (sensor, window start)) at a small size.

Rows are compared as sorted row sets: the two pump threads interleave at
random, so output order differs from run to run in both packages.  Keys,
counts and passthrough values must match exactly; window averages (f32
sums in another order) to rtol=1e-5."""

from types import SimpleNamespace

import numpy as np
import pytest

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.errors import PlanError as JPlanError
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical import plan as jlp
from denormalized_tpu.physical.join_exec import StreamingJoinExec as JJoin
from denormalized_tpu.physical.simple_execs import CollectSink as JSink
from denormalized_tpu.runtime import executor as jexec
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.errors import PlanError as TPlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec as TJoin
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000
PKGS = ("jax", "torch")
AVG_RTOL = 1e-5  # f32 window sums in another order (the window e2e rule)


def ns(pkg: str, **cfg) -> SimpleNamespace:
    """One package's API surface and a fresh Context built with ``cfg``."""
    if pkg == "jax":
        return SimpleNamespace(
            ctx=jt.Context(JConfig(**cfg)), Schema=JSchema, Field=JField,
            DT=JType, Batch=JBatch, Source=JSource, F=JF, col=jt.col,
            PlanError=JPlanError, lp=jlp, Sink=JSink, executor=jexec,
            Join=JJoin,
        )
    return SimpleNamespace(
        ctx=tt.Context(tt.EngineConfig(device="cpu", **cfg)), Schema=TSchema,
        Field=TField, DT=TType, Batch=TBatch, Source=TSource, F=TF,
        col=tt.col, PlanError=TPlanError, lp=tlp, Sink=TSink,
        executor=texec, Join=TJoin,
    )


def canon(res, cols) -> list[tuple]:
    """Rows as tuples over ``cols`` (None for a null), sorted by their
    exact (non-float) cells, then their floats."""
    out = []
    for i in range(res.num_rows):
        row = []
        for c in cols:
            m = res.mask(c)
            v = res.column(c)[i]
            if m is not None and not m[i]:
                row.append(None)
            elif isinstance(v, (float, np.floating)):
                row.append(float(v))
            elif isinstance(v, (int, np.integer)):
                row.append(int(v))
            else:
                row.append(str(v))
        out.append(tuple(row))

    def key(r):
        exact = tuple(repr(x) for x in r if not isinstance(x, float))
        return exact, tuple(x for x in r if isinstance(x, float))

    return sorted(out, key=key)


def assert_same_rows(a: list[tuple], b: list[tuple], rtol: float = 0.0):
    assert len(a) == len(b), (len(a), len(b))
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert np.isclose(x, y, rtol=rtol, atol=0), (ra, rb)
            else:
                assert x == y, (ra, rb)


# -- windowed joins (the stream_join example; bench.py config 4) ------------


def _reading_batches(p, seed, n_batches, rows, keys, ms_per_batch, shift=0.0):
    rng = np.random.default_rng(seed)
    schema = p.Schema([
        p.Field("occurred_at_ms", p.DT.INT64, nullable=False),
        p.Field("sensor_name", p.DT.STRING, nullable=False),
        p.Field("reading", p.DT.FLOAT64),
    ])
    names = np.array(keys, dtype=object)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * ms_per_batch + rng.integers(0, ms_per_batch, rows))
        out.append(p.Batch(schema, [
            ts, names[rng.integers(0, len(keys), rows)],
            rng.normal(50.0, 10.0, rows) + shift,
        ]))
    return out


def _window_join(p, left_batches, right_batches, left_agg, right_agg,
                 rename, how="inner"):
    """Two windowed streams joined on (sensor, window start); ``rename``
    maps the right side's sensor/start/end columns."""
    col, F = p.col, p.F
    left = p.ctx.from_source(
        p.Source.from_batches(left_batches, timestamp_column="occurred_at_ms"),
        name="left",
    ).window(["sensor_name"], [F.avg(col("reading")).alias(left_agg)], 1000)
    right = p.ctx.from_source(
        p.Source.from_batches(right_batches, timestamp_column="occurred_at_ms"),
        name="right",
    ).window(["sensor_name"], [F.avg(col("reading")).alias(right_agg)], 1000)
    for old in ("sensor_name", "window_start_time", "window_end_time"):
        right = right.with_column_renamed(old, rename[old])
    return left.join(
        right, how, ["sensor_name", "window_start_time"],
        [rename["sensor_name"], rename["window_start_time"]],
    )


HUMIDITY = {"sensor_name": "humidity_sensor",
            "window_start_time": "humidity_window_start_time",
            "window_end_time": "humidity_window_end_time"}
BENCH = {"sensor_name": "hs", "window_start_time": "hws",
         "window_end_time": "hwe"}


def test_windowed_stream_join():
    """Twin of test_join.py::test_windowed_stream_join: three sensors,
    500 ms batches, the right stream shifted by +100."""
    cols = ["sensor_name", "avg_temperature", "window_start_time",
            "window_end_time", "humidity_sensor", "avg_humidity",
            "humidity_window_start_time", "humidity_window_end_time"]
    got = {}
    for pkg in PKGS:
        p = ns(pkg)
        keys = ["s0", "s1", "s2"]
        res = _window_join(
            p, _reading_batches(p, 3, 8, 200, keys, 500),
            _reading_batches(p, 4, 8, 200, keys, 500, shift=100.0),
            "avg_temperature", "avg_humidity", HUMIDITY,
        ).collect()
        got[pkg] = canon(res, cols)
        assert res.num_rows > 0
        assert (res.column("sensor_name") == res.column("humidity_sensor")).all()
        assert (
            res.column("window_start_time")
            == res.column("humidity_window_start_time")
        ).all()
        assert (
            res.column("avg_humidity") - res.column("avg_temperature")
        ).mean() > 90
    assert_same_rows(got["jax"], got["torch"], AVG_RTOL)


@pytest.mark.parametrize("strategy", ["auto", "scatter", "partial_merge"])
def test_config4_bench_query(strategy):
    """bench.py's config-4 query (``join``) at a small size: two streams
    of 10 sensors, 24 batches of 2,048 rows over 250 ms each, avg by
    sensor in 1 s windows, the right side renamed to hs/hws/hwe, inner
    join on (sensor_name, window_start_time) = (hs, hws).  The port's
    windows run each strategy; the JAX package its default."""
    keys = [f"sensor_{i}" for i in range(10)]
    cols = ["sensor_name", "avg_t", "window_start_time", "window_end_time",
            "hs", "avg_h", "hws", "hwe"]
    got = {}
    for pkg in PKGS:
        p = ns(pkg) if pkg == "jax" else ns(pkg, device_strategy=strategy)
        res = _window_join(
            p, _reading_batches(p, 0, 24, 2048, keys, 250),
            _reading_batches(p, 1, 24, 2048, keys, 250),
            "avg_t", "avg_h", BENCH,
        ).collect()
        got[pkg] = canon(res, cols)
    # 6 s of event time x 10 sensors, every window on both sides
    assert len(got["torch"]) == 60
    assert_same_rows(got["jax"], got["torch"], AVG_RTOL)


# -- raw (unwindowed) joins -------------------------------------------------


def _raw_sources(p, L_rows, R_rows):
    """Two raw sources from (ts, key, value) row tuples."""
    SL = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                   p.Field("k", p.DT.STRING, nullable=False),
                   p.Field("v", p.DT.FLOAT64)])
    SR = p.Schema([p.Field("ts2", p.DT.INT64, nullable=False),
                   p.Field("k2", p.DT.STRING, nullable=False),
                   p.Field("w", p.DT.FLOAT64)])

    def rb(schema, rows):
        cols = list(zip(*rows))
        return p.Batch(schema, [np.asarray(cols[0], np.int64),
                                np.asarray(cols[1], object),
                                np.asarray(cols[2], np.float64)])

    left = p.ctx.from_source(
        p.Source.from_batches([rb(SL, b) for b in L_rows],
                              timestamp_column="ts"), name="jl")
    right = p.ctx.from_source(
        p.Source.from_batches([rb(SR, b) for b in R_rows],
                              timestamp_column="ts2"), name="jr")
    return left, right


def _both(L_rows, R_rows, how, cols, **kw):
    """The raw join through both packages → (jax rows, port rows)."""
    out = []
    for pkg in PKGS:
        p = ns(pkg)
        left, right = _raw_sources(p, L_rows, R_rows)
        filt = kw.get("filter")
        res = left.join(right, how, ["k"], ["k2"],
                        filter=None if filt is None else filt(p.col)).collect()
        out.append(canon(res, cols))
    return out


PAIR_COLS = ["ts", "k", "v", "ts2", "w"]
LEFT_COLS = ["ts", "k", "v"]


def test_left_join_emits_unmatched():
    schema_rows = lambda ts, ks, vs: list(zip(ts, ks, vs))  # noqa: E731
    got = {}
    for pkg in PKGS:
        p = ns(pkg)
        S = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                      p.Field("k", p.DT.STRING, nullable=False),
                      p.Field("v", p.DT.FLOAT64)])

        def mk(rows):
            ts, ks, vs = zip(*rows)
            return p.Batch(S, [np.asarray(ts, np.int64),
                               np.asarray(ks, object), np.asarray(vs)])

        left = p.ctx.from_source(p.Source.from_batches(
            [mk(schema_rows([T0, T0 + 10], ["a", "b"], [1.0, 2.0]))],
            timestamp_column="ts"), name="left")
        right = (
            p.ctx.from_source(p.Source.from_batches(
                [mk(schema_rows([T0 + 5], ["a"], [9.0]))],
                timestamp_column="ts"), name="right")
            .with_column_renamed("k", "rk")
            .with_column_renamed("ts", "rts")
            .with_column_renamed("v", "rv")
        )
        res = left.join(right, "left", ["k"], ["rk"]).collect()
        rows = {res.column("k")[i]: i for i in range(res.num_rows)}
        assert set(rows) == {"a", "b"}
        assert float(res.column("rv")[rows["a"]]) == 9.0
        assert res.mask("rv") is not None and not res.mask("rv")[rows["b"]]
        got[pkg] = canon(res, ["k", "v", "rk", "rts", "rv"])
    assert got["jax"] == got["torch"]


def test_raw_join_duplicate_key_chains():
    """Duplicate keys within AND across batches: the full cross product
    per key, in both packages and against a brute-force oracle."""
    L_rows = [
        [(T0 + 1, "a", 1.0), (T0 + 2, "a", 2.0), (T0 + 3, "b", 3.0)],
        [(T0 + 10, "a", 4.0), (T0 + 11, "c", 5.0)],
    ]
    R_rows = [
        [(T0 + 1, "a", 10.0), (T0 + 2, "b", 20.0)],
        [(T0 + 12, "a", 30.0), (T0 + 13, "a", 40.0), (T0 + 14, "z", 50.0)],
    ]
    j, t = _both(L_rows, R_rows, "inner", PAIR_COLS)
    assert j == t
    want = sorted(
        (lk, lv, rw)
        for (_, lk, lv) in (r for b in L_rows for r in b)
        for (_, rk, rw) in (r for b in R_rows for r in b)
        if lk == rk
    )
    assert sorted((r[1], r[2], r[4]) for r in t) == want


EVICT_GAP = 400_000  # > the default 300 s retention: forces eviction
EVICT_L = [
    [(T0 + 1, "old", 1.0)],
    [(T0 + EVICT_GAP, "new", 2.0), (T0 + EVICT_GAP + 1, "new", 3.0)],
    [(T0 + EVICT_GAP + 1000, "new", 4.0)],
]
EVICT_R = [
    [(T0 + 2, "none", 0.0)],
    [(T0 + EVICT_GAP + 5, "new", 10.0)],
    # 'old' arrives after eviction: must NOT match the evicted left row
    [(T0 + EVICT_GAP + 1001, "old", 20.0), (T0 + EVICT_GAP + 1002, "new", 30.0)],
]


def test_raw_join_eviction_rebuild_keeps_matching():
    """After eviction drops old batches, the rebuilt chain arrays still
    match retained rows and never resurrect evicted ones."""
    j, t = _both(EVICT_L, EVICT_R, "inner", PAIR_COLS)
    assert j == t
    assert sorted((r[1], r[2], r[4]) for r in t) == sorted(
        [("new", 2.0, 10.0), ("new", 3.0, 10.0), ("new", 4.0, 10.0),
         ("new", 2.0, 30.0), ("new", 3.0, 30.0), ("new", 4.0, 30.0)]
    )


@pytest.mark.parametrize("how", ["left", "right", "full"])
def test_outer_joins_emit_evicted_and_eos_unmatched(how):
    """Outer joins over the eviction feed: unmatched rows surface
    null-padded at eviction or at EOS, the same in both packages."""
    j, t = _both(EVICT_L, EVICT_R, how, PAIR_COLS)
    assert j == t
    assert any(None in r for r in t)


def test_raw_join_residual_filter():
    """A residual filter over matched pairs keeps only accepted pairs."""
    L_rows = [[(T0 + 1, "a", 1.0), (T0 + 2, "b", 50.0), (T0 + 3, "a", 20.0)]]
    R_rows = [[(T0 + 3, "a", 10.0), (T0 + 4, "b", 10.0)]]
    j, t = _both(L_rows, R_rows, "inner", PAIR_COLS,
                 filter=lambda col: col("w") > col("v"))
    assert j == t == [(T0 + 1, "a", 1.0, T0 + 3, 10.0)]


def test_raw_join_key_dtype_mismatch_rejected():
    for pkg in PKGS:
        p = ns(pkg)
        left, right = _raw_sources(p, [[(T0, "a", 1.0)]], [[(T0, "a", 2.0)]])
        with pytest.raises(p.PlanError, match="dtype mismatch"):
            # string key joined against a numeric column
            left.join(right, "inner", ["k"], ["ts2"]).collect()


def _find_join(op, Join):
    if isinstance(op, Join):
        return op
    for c in op.children:
        r = _find_join(c, Join)
        if r is not None:
            return r
    return None


def test_raw_join_reinterning_bounds_key_state():
    """UUID-style keys: every row a new key.  After eviction the join
    re-keys, so interner state is bounded by retention, and results stay
    right across the rebuild — in both packages."""
    step = 100_000
    L_rows, R_rows = [], []
    uid = 0
    for b in range(40):
        lb, rb_ = [], []
        for i in range(50):
            lb.append((T0 + b * step + i, f"u{uid}", float(uid)))
            rb_.append((T0 + b * step + i, f"u{uid}", float(uid) * 10))
            uid += 1
        L_rows.append(lb)
        R_rows.append(rb_)
    results = []
    for pkg in PKGS:
        p = ns(pkg)
        left, right = _raw_sources(p, L_rows, R_rows)
        ds = left.join(right, "inner", ["k"], ["k2"])
        sink = p.Sink()
        root = p.executor.build_physical(p.lp.Sink(ds._plan, sink), p.ctx)
        j = _find_join(root, p.Join)
        j._reintern_min = 64
        for _ in root.run():
            pass
        res = sink.result()
        got = {res.column("k")[i]: (float(res.column("v")[i]),
                                    float(res.column("w")[i]))
               for i in range(res.num_rows)}
        assert len(got) == 2000, len(got)
        assert all(w == v * 10 for v, w in got.values())
        # re-keyed: retention (~300 s = 4 batches of 50 keys) keeps the
        # interner far below the 2000 keys ever seen
        assert len(j._interner) < 1000, len(j._interner)
        results.append(canon(res, PAIR_COLS))
    assert results[0] == results[1]


# -- existence joins (semi / anti) -------------------------------------------


def test_left_semi_join_emits_matching_left_rows_once():
    L_rows = [
        [(T0 + 1, "a", 1.0), (T0 + 2, "b", 2.0)],
        [(T0 + 500, "a", 3.0), (T0 + 501, "c", 4.0)],
        [(T0 + 1000, "d", 5.0)],
    ]
    R_rows = [
        [(T0 + 3, "a", 10.0), (T0 + 4, "a", 11.0)],  # dup matches: 1 emit
        [(T0 + 600, "c", 12.0)],
        [(T0 + 1100, "zz", 13.0)],
    ]
    j, t = _both(L_rows, R_rows, "semi", LEFT_COLS)
    assert j == t == sorted(
        [(T0 + 1, "a", 1.0), (T0 + 500, "a", 3.0), (T0 + 501, "c", 4.0)],
        key=lambda r: (repr(r[0]), repr(r[1]), r[2]),
    )


def test_left_anti_join_emits_matchless_left_rows():
    L_rows = [
        [(T0 + 1, "a", 1.0), (T0 + 2, "b", 2.0)],
        [(T0 + 500, "c", 3.0), (T0 + 501, "b", 4.0)],
    ]
    R_rows = [
        [(T0 + 3, "a", 10.0)],
        [(T0 + 600, "c", 12.0), (T0 + 601, "c", 13.0)],
    ]
    j, t = _both(L_rows, R_rows, "anti", LEFT_COLS)
    assert j == t == [(T0 + 2, "b", 2.0), (T0 + 501, "b", 4.0)]


@pytest.mark.parametrize("how, want", [
    ("semi", [(T0 + 1, "a", 1.0)]),
    ("anti", [(T0 + 2, "b", 50.0)]),
])
def test_semi_join_filter_gates_existence(how, want):
    """A key-equal pair rejected by the filter is not a match, for semi
    and anti alike."""
    L_rows = [[(T0 + 1, "a", 1.0), (T0 + 2, "b", 50.0)]]
    R_rows = [[(T0 + 3, "a", 10.0), (T0 + 4, "b", 10.0)]]
    j, t = _both(L_rows, R_rows, how, LEFT_COLS,
                 filter=lambda col: col("w") > col("v"))
    assert j == t == want


@pytest.mark.parametrize("how, want", [
    ("right_semi", [(T0 + 3, "a")]),
    ("RightAnti", [(T0 + 4, "x")]),
])
def test_right_semi_anti_normalize_by_swapping(how, want):
    """RightSemi(a,b) == LeftSemi(b,a): the output is RIGHT-side rows."""
    L_rows = [[(T0 + 1, "a", 1.0), (T0 + 2, "b", 2.0)]]
    R_rows = [[(T0 + 3, "a", 10.0), (T0 + 4, "x", 11.0)]]
    j, t = _both(L_rows, R_rows, how, ["ts2", "k2"])
    assert j == t == want


def test_anti_join_watermark_eviction_is_final():
    """A left row that ages past the horizon unmatched emits as anti THEN;
    a matching right row arriving later neither retracts it nor matches."""
    L_rows = [
        [(T0 + 1, "old", 1.0)],
        [(T0 + EVICT_GAP, "new", 2.0)],
        [(T0 + EVICT_GAP + 1000, "new", 3.0)],
    ]
    R_rows = [
        [(T0 + 2, "none", 0.0)],
        [(T0 + EVICT_GAP + 5, "new", 10.0)],
        [(T0 + EVICT_GAP + 1001, "old", 20.0)],
    ]
    j, t = _both(L_rows, R_rows, "anti", LEFT_COLS)
    assert j == t == [(T0 + 1, "old", 1.0)]


def test_semi_join_filter_ambiguous_shared_name_rejected():
    """A semi join FILTER naming a column both sides carry raises; shared
    equi-keys and untouched shared names stay fine."""
    for pkg in PKGS:
        p = ns(pkg)
        S = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                      p.Field("k", p.DT.STRING, nullable=False),
                      p.Field("v", p.DT.FLOAT64)])

        def src(name):
            rb = p.Batch(S, [np.asarray([T0], np.int64),
                             np.asarray(["a"], object), np.asarray([1.0])])
            return p.ctx.from_source(
                p.Source.from_batches([rb], timestamp_column="ts"), name=name)

        with pytest.raises(p.PlanError, match="ambiguous"):
            src("l").join(src("r"), "semi", ["k"], ["k"],
                          filter=p.col("v") > 0.5)
        assert src("l1").join(src("r1"), "semi", ["k"], ["k"]).collect(
        ).num_rows == 1
        assert src("l2").join(src("r2"), "semi", ["k"], ["k"],
                              filter=p.col("k") == "a").collect().num_rows == 1


# -- shaping a side before a join -------------------------------------------


@pytest.mark.parametrize("shape", [
    lambda ds, col: ds.select_columns("k", "v"),
    lambda ds, col: ds.with_column("v2", col("v") * 2.0),
    lambda ds, col: ds.with_column("v", col("v") + 1.0),
    lambda ds, col: ds.drop_columns("v"),
    lambda ds, col: ds.drop_columns(["k"]),
    lambda ds, col: ds.with_column_renamed("k", "key"),
], ids=["select_columns", "with_column_add", "with_column_replace",
        "drop_columns", "drop_columns_list", "with_column_renamed"])
def test_column_shaping_methods(shape):
    """select_columns / with_column / drop_columns / with_column_renamed
    give the JAX package's schema and rows."""
    got = []
    for pkg in PKGS:
        p = ns(pkg)
        left, _ = _raw_sources(
            p, [[(T0 + 1, "a", 1.0), (T0 + 2, "b", 2.5)]], [[(T0, "a", 0.0)]])
        ds = shape(left, p.col)
        res = ds.collect()
        names = ds.schema().names
        got.append((names, canon(res, names)))
    assert got[0] == got[1]


# -- band joins and join_on ---------------------------------------------------


def test_band_join_and_join_on_not_yet_ported():
    """Kept under its first name: band joins and join_on, which the port
    once refused, run and give the JAX package's rows (the full twins are
    in tests/test_torch_join_band.py)."""
    L = [[(T0, "a", 1.0), (T0 + 20, "a", 3.0)]]
    R = [[(T0 + 5, "a", 2.0)]]
    got = []
    for pkg in PKGS:
        p = ns(pkg)
        left, right = _raw_sources(p, L, R)
        banded = left.join(right, "inner", ["k"], ["k2"],
                           band=("ts", "ts2", -10, 10)).collect()
        left, right = _raw_sources(p, L, R)
        on = left.join_on(right, "inner", [p.col("k") == p.col("k2")]).collect()
        cols = ["ts", "k", "v", "ts2", "w"]
        got.append((canon(banded, cols), canon(on, cols)))
    assert got[0] == got[1]
    assert got[1][0] == [(T0, "a", 1.0, T0 + 5, 2.0)]
    assert len(got[1][1]) == 2
