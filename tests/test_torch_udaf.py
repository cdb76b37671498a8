"""User-defined and accumulator-backed aggregates in the port
(``physical/udaf_exec.py``, ``api/udaf.py``, ``api/builtin_accumulators.py``)
held against the JAX package on the same seeded batches.

Twins of ``tests/test_session_and_udaf.py::test_udaf_window`` and of
``examples/udaf_example.py``'s job (a ``ReadingSpread`` accumulator and
``count``, 1 s tumbling by ``sensor_name``, over batches and over the mock
broker), every accumulator-backed constructor of ``api/functions.py``'s
``__all__`` in a sliding window and in a session window, the approximate
kinds lowered to their accumulators, ``kind="partition"`` hints and late
rows through a stub input, re-interning, and a kill/restore whose snapshot
(its JSON, unpacked) equals the JAX operator's for the same input.

Both packages run the same host numpy code in the same order, so rows
are compared EXACTLY (NaN equal to NaN), floats included: a difference
would be a porting fault, not rounding.
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.api.udaf import Accumulator as JAccumulator
from denormalized_tpu.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical import plan as jlp
from denormalized_tpu.physical import base as jbase
from denormalized_tpu.physical.simple_execs import CollectSink as JSink
from denormalized_tpu.physical.udaf_exec import UdafWindowExec as JUdafExec
from denormalized_tpu.runtime import executor as jexec
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu.state import lsm as jlsm
from denormalized_tpu.state.checkpoint import wire_checkpointing as jwire
from denormalized_tpu.state.orchestrator import Orchestrator as JOrch
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.api.udaf import Accumulator as TAccumulator
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.physical import base as tbase
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.physical.udaf_exec import UdafWindowExec as TUdafExec
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state import lsm as tlsm
from denormalized_tpu_torch.state.checkpoint import wire_checkpointing as twire
from denormalized_tpu_torch.state.orchestrator import Orchestrator as TOrch

T0 = 1_700_000_000_000
PKGS = ("jax", "torch")


def _spread_cls(base):
    class ReadingSpread(base):
        """examples/udaf_example.py's accumulator: max − min per window."""

        def __init__(self):
            self.lo = float("inf")
            self.hi = float("-inf")

        def update(self, values):
            if len(values):
                self.lo = min(self.lo, float(values.min()))
                self.hi = max(self.hi, float(values.max()))

        def merge(self, states):
            self.lo = min(self.lo, states[0])
            self.hi = max(self.hi, states[1])

        def state(self):
            return [self.lo, self.hi]

        def evaluate(self):
            return self.hi - self.lo if self.hi >= self.lo else 0.0

    return ReadingSpread


def _weighted_cls(base):
    class WeightedObservation(base):
        """tests/test_session_and_udaf.py's running mean accumulator."""

        def __init__(self):
            self.total = 0.0
            self.n = 0

        def update(self, values):
            self.total += float(values.sum())
            self.n += len(values)

        def merge(self, states):
            self.total += states[0]
            self.n += states[1]

        def state(self):
            return [self.total, self.n]

        def evaluate(self):
            return self.total / self.n if self.n else 0.0

    return WeightedObservation


def api(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        return SimpleNamespace(
            ctx=lambda **kw: jt.Context(JConfig(**kw)), Schema=JSchema,
            Field=JField, DT=JType, Batch=JBatch, Source=JSource, F=JF,
            col=jt.col, lp=jlp, Sink=JSink, executor=jexec, wire=jwire,
            Orch=JOrch, base=jbase, close=jlsm.close_global_state_backend,
            Udaf=JUdafExec, Spread=_spread_cls(JAccumulator),
            Weighted=_weighted_cls(JAccumulator),
        )
    return SimpleNamespace(
        ctx=lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)),
        Schema=TSchema, Field=TField, DT=TType, Batch=TBatch, Source=TSource,
        F=TF, col=tt.col, lp=tlp, Sink=TSink, executor=texec, wire=twire,
        Orch=TOrch, base=tbase, close=tlsm.close_global_state_backend,
        Udaf=TUdafExec, Spread=_spread_cls(TAccumulator),
        Weighted=_weighted_cls(TAccumulator),
    )


def feed(seed, n_batches=8, n=400, span=700, keys=5, null_share=0.1):
    """Seeded batches of (ts, sensor, reading, weight, bits, flag, valid):
    sorted event times reaching 400 ms behind the batch's start, a share
    of readings null."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * span + rng.integers(-400, span, n)).astype(
            np.int64
        )
        ks = np.array([f"s{i}" for i in rng.integers(0, keys, n)], object)
        v = np.round(rng.normal(20.0, 5.0, n), 3)
        w = rng.uniform(0.5, 2.0, n)
        bits = rng.integers(0, 256, n).astype(np.int64)
        flag = rng.random(n) < 0.7
        valid = rng.random(n) >= null_share
        out.append((ts, ks, v, w, bits, flag, valid))
    return out


def schema_of(p):
    D = p.DT
    return p.Schema([
        p.Field("ts", D.INT64, nullable=False),
        p.Field("sensor", D.STRING, nullable=False),
        p.Field("v", D.FLOAT64),
        p.Field("w", D.FLOAT64, nullable=False),
        p.Field("bits", D.INT64, nullable=False),
        p.Field("flag", D.BOOL, nullable=False),
    ])


def batches_of(p, raw):
    s = schema_of(p)
    return [
        p.Batch(s, [ts, ks, v, w, bits, flag],
                None if valid.all() else [None, None, valid, None, None, None])
        for ts, ks, v, w, bits, flag, valid in raw
    ]


def source(p, raw, name="udaf_src"):
    return p.ctx().from_source(
        p.Source.from_batches(batches_of(p, raw), timestamp_column="ts"),
        name=name,
    )


def _cell(x):
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_cell(e) for e in x)
    if isinstance(x, (float, np.floating)):
        return "nan" if x != x else float(x)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


def table(res) -> list[tuple]:
    """Every row of a result, cells normalized (NaN equal to NaN, lists
    as tuples), in emission order."""
    names = res.schema.without_internal().names
    return [
        tuple(_cell(res.column(n)[i]) for n in names)
        for i in range(res.num_rows)
    ]


# -- each accumulator-backed constructor of functions.__all__ ---------------

CONSTRUCTORS = {
    "median": lambda F, c: F.median(c("v")),
    "approx_median": lambda F, c: F.approx_median(c("v")),
    "array_agg": lambda F, c: F.array_agg(c("v")),
    "first_value": lambda F, c: F.first_value(c("v")),
    "last_value": lambda F, c: F.last_value(c("v")),
    "nth_value": lambda F, c: F.nth_value(c("v"), 2),
    "string_agg": lambda F, c: F.string_agg(c("sensor"), "|"),
    "approx_distinct": lambda F, c: F.approx_distinct(c("v")),
    "approx_top_k": lambda F, c: F.approx_top_k(c("bits"), 3),
    "count_distinct": lambda F, c: F.count_distinct(c("bits")),
    "percentile_cont": lambda F, c: F.percentile_cont(c("v"), 0.9),
    "approx_percentile_cont":
        lambda F, c: F.approx_percentile_cont(c("v"), 0.25),
    "approx_percentile_cont_with_weight":
        lambda F, c: F.approx_percentile_cont_with_weight(c("v"), c("w"), 0.5),
    "bit_and": lambda F, c: F.bit_and(c("bits")),
    "bit_or": lambda F, c: F.bit_or(c("bits")),
    "bit_xor": lambda F, c: F.bit_xor(c("bits")),
    "bool_and": lambda F, c: F.bool_and(c("flag")),
    "bool_or": lambda F, c: F.bool_or(c("flag")),
    **{
        stat: (lambda s: lambda F, c: getattr(F, s)(c("v"), c("w")))(stat)
        for stat in (
            "corr", "covar", "covar_pop", "covar_samp", "regr_avgx",
            "regr_avgy", "regr_count", "regr_intercept", "regr_r2",
            "regr_slope", "regr_sxx", "regr_sxy", "regr_syy",
        )
    },
}


def test_constructor_table_covers_every_accumulator_aggregate():
    """``__all__`` lists the aggregates first, through ``regr_syy``: every
    one the ring cannot run is in the table, so each is held against the
    JAX package below."""
    ring = {"count", "count_star", "sum", "min", "max", "avg", "mean",
            "stddev", "stddev_samp", "stddev_pop", "var", "var_samp",
            "var_sample", "var_pop"}
    aggs = TF.__all__[: TF.__all__.index("regr_syy") + 1]
    assert sorted(set(aggs) - ring) == sorted(CONSTRUCTORS)


def _job(p, raw, name, shape):
    c = p.col
    aggs = [
        CONSTRUCTORS[name](p.F, c).alias("a"),
        p.F.count(c("v")).alias("n"),
    ]
    ds = source(p, raw)
    if shape == "sliding":
        return ds.window(["sensor"], aggs, 1000, 500)
    return ds.session_window(["sensor"], aggs, 150)


@pytest.mark.parametrize("shape", ["sliding", "session"])
@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_accumulator_aggregate_matches_jax(name, shape):
    raw = feed(11, n_batches=5, n=200)
    got = {pkg: table(_job(api(pkg), raw, name, shape).collect())
           for pkg in PKGS}
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) > 5


def test_approximate_kinds_lower_to_their_accumulators():
    """Off the slice path an approximate aggregate runs its exact
    accumulator: the port's plan holds a UdafWindowExec, and
    approx_median equals median row for row."""
    raw = feed(12, n_batches=4, n=300)
    p = api("torch")
    res = source(p, raw).window(
        ["sensor"],
        [TF.approx_median(tt.col("v")).alias("am"),
         TF.median(tt.col("v")).alias("m")],
        1000,
    ).collect()
    am, m = res.column("am"), res.column("m")
    assert np.array_equal(am, m, equal_nan=True)
    ds = source(p, raw).window(
        ["sensor"], [TF.approx_distinct(tt.col("v")).alias("d")], 1000)
    from denormalized_tpu_torch.planner.planner import Planner

    phys = Planner(ds._ctx.config).create_physical_plan(ds.optimized_plan())
    assert "UdafWindowExec" in phys.display()


# -- tests/test_session_and_udaf.py::test_udaf_window -----------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_udaf_window(pkg):
    p = api(pkg)
    D = p.DT
    s = p.Schema([p.Field("occurred_at_ms", D.INT64, nullable=False),
                  p.Field("sensor_name", D.STRING, nullable=False),
                  p.Field("reading", D.FLOAT64)])

    def mk(ts, ks, vs):
        return p.Batch(s, [np.asarray(ts, np.int64), np.asarray(ks, object),
                           np.asarray(vs, np.float64)])

    batches = [
        mk([T0 + 10, T0 + 20], ["a", "b"], [1.0, 10.0]),
        mk([T0 + 600, T0 + 2500], ["a", "a"], [3.0, 0.0]),
    ]
    my_mean = p.F.udaf(p.Weighted, D.FLOAT64, "my_mean")
    res = (
        p.ctx().from_source(
            p.Source.from_batches(batches, timestamp_column="occurred_at_ms"))
        .window(["sensor_name"],
                [my_mean(p.col("reading")).alias("m"),
                 p.F.count(p.col("reading")).alias("c")], 1000)
        .collect()
    )
    got = {
        (res.column("sensor_name")[i], int(res.column("window_start_time")[i])):
        (float(res.column("m")[i]), int(res.column("c")[i]))
        for i in range(res.num_rows)
    }
    assert got[("a", T0)] == (2.0, 2)  # mean(1, 3)
    assert got[("b", T0)] == (10.0, 1)
    assert got[("a", T0 + 2000)] == (0.0, 1)


# -- examples/udaf_example.py's job ----------------------------------------


def _spread_job(p, ds):
    spread = p.F.udaf(p.Spread, p.DT.FLOAT64, "reading_spread")
    return ds.window(
        [p.col("sensor")],
        [spread(p.col("v")).alias("spread"),
         p.F.count(p.col("v")).alias("count")],
        1000,
    )


def spread_oracle(raw):
    """(window start, sensor) → (spread, count) over the rows a monotonic
    min-ts watermark keeps (a row is late once its window closed)."""
    out: dict = {}
    wm = None
    first_open = None
    for ts, ks, v, _w, _b, _f, valid in raw:
        units = ts // 1000
        if first_open is None:
            first_open = int(units.min())
        for t, k, x, ok, u in zip(ts.tolist(), ks.tolist(), v.tolist(),
                                  valid.tolist(), units.tolist()):
            if u < first_open:
                continue
            lo, hi, n = out.get((u * 1000, k), (np.inf, -np.inf, 0))
            if ok:
                lo, hi, n = min(lo, x), max(hi, x), n + 1
            out[(u * 1000, k)] = (lo, hi, n)
        bmin = int(ts.min())
        wm = bmin if wm is None else max(wm, bmin)
        while (first_open + 1) * 1000 <= wm:
            first_open += 1
    return {
        key: (hi - lo if hi >= lo else 0.0, n)
        for key, (lo, hi, n) in out.items()
    }


def test_udaf_example_job_matches_jax_and_oracle():
    raw = feed(3, n_batches=10, n=500, keys=10)
    got = {pkg: _spread_job(api(pkg), source(api(pkg), raw)).collect()
           for pkg in PKGS}
    assert table(got["torch"]) == table(got["jax"])
    res = got["torch"]
    rows = {
        (int(ws), k): (float(sp), int(n))
        for ws, k, sp, n in zip(res.column("window_start_time"),
                                res.column("sensor"), res.column("spread"),
                                res.column("count"))
    }
    want = spread_oracle(raw)
    assert set(rows) == set(want)
    for key, (sp, n) in want.items():
        assert rows[key][1] == n, key
        assert rows[key][0] == pytest.approx(sp, rel=1e-12), key


def _mock_broker(pkg):
    if pkg == "jax":
        from denormalized_tpu.testing.mock_kafka import MockKafkaBroker
    else:
        from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker
    return MockKafkaBroker()


def test_udaf_example_over_the_mock_broker():
    """The example as written: from_topic → spread + count → stream, in
    both packages over their own mock broker holding the same JSON
    records; every closable window (start + 1 s ≤ max ts) emits the same
    rows."""
    rng = np.random.default_rng(4)
    n = 4000
    ts = T0 + np.sort(rng.integers(0, 6000, n))
    sensors = [f"sensor_{i}" for i in rng.integers(0, 6, n)]
    readings = np.round(rng.normal(20, 5, n), 3)
    msgs = [
        json.dumps({"occurred_at_ms": int(t), "sensor_name": s,
                    "reading": float(r)}).encode()
        for t, s, r in zip(ts, sensors, readings)
    ]
    closable = {ws for ws in range(T0, T0 + 6000, 1000)
                if ws + 1000 <= int(ts.max())}
    out = {}
    for pkg in PKGS:
        p = api(pkg)
        broker = _mock_broker(pkg).start()
        try:
            broker.create_topic("temperature", partitions=2)
            for part in range(2):
                broker.produce("temperature", part, msgs[part::2],
                               ts_ms=T0)
            ctx = p.ctx(source_idle_timeout_ms=300)
            ds = ctx.from_topic(
                "temperature",
                sample_json=json.dumps({"occurred_at_ms": 1,
                                        "sensor_name": "a", "reading": 1.0}),
                bootstrap_servers=broker.bootstrap,
                timestamp_column="occurred_at_ms",
            )
            spread = p.F.udaf(p.Spread, p.DT.FLOAT64, "reading_spread")
            ds = ds.window(
                [p.col("sensor_name")],
                [spread(p.col("reading")).alias("spread"),
                 p.F.count(p.col("reading")).alias("count")],
                1000,
            )
            rows = {}
            it = ds.stream()
            deadline = time.time() + 30
            for batch in it:
                for i in range(batch.num_rows):
                    ws = int(batch.column("window_start_time")[i])
                    rows[(ws, str(batch.column("sensor_name")[i]))] = (
                        float(batch.column("spread")[i]),
                        int(batch.column("count")[i]),
                    )
                if {k[0] for k in rows} >= closable or time.time() > deadline:
                    break
            it.close()
            out[pkg] = {k: v for k, v in rows.items() if k[0] in closable}
        finally:
            broker.stop()
    assert {k[0] for k in out["torch"]} == closable
    assert out["torch"] == out["jax"]


# -- hints, late rows, re-interning, through a stub input -------------------


class _Feed:
    """Stub input operator replaying a fixed StreamItem sequence."""

    def __init__(self, items, schema, eos):
        self._items, self.schema, self._eos = items, schema, eos

    @property
    def children(self):
        return []

    def run(self):
        yield from self._items
        yield self._eos


def _stub_items(p, raw, hints):
    s = schema_of(p)
    fields = list(s.fields) + [
        p.Field(CANONICAL_TIMESTAMP_COLUMN, p.DT.TIMESTAMP_MS, nullable=False)
    ]
    s2 = p.Schema(fields)
    items = []
    for b, (ts, ks, v, w, bits, flag, valid) in enumerate(raw):
        items.append(p.Batch(
            s2, [ts, ks, v, w, bits, flag, ts.copy()],
            [None, None, valid, None, None, None, None]))
        if hints and b % 2 == 1:
            items.append(p.base.WatermarkHint(
                int(ts.min()) - 300, kind=hints))
    return s2, items


def _drive(p, raw, hints=None, reintern_min=None):
    s2, items = _stub_items(p, raw, hints)
    if hints == "partition":
        items.insert(0, p.base.WatermarkHint(p.base.WM_ANNOUNCE,
                                             kind="partition"))
    spread = p.F.udaf(p.Spread, p.DT.FLOAT64, "spread")
    op = p.Udaf(
        _Feed(items, s2, p.base.EOS), [p.col("sensor")],
        [spread(p.col("v")).alias("sp"), p.F.count(p.col("v")).alias("n"),
         p.F.median(p.col("v")).alias("med")],
        jlp.WindowType.SLIDING if p.lp is jlp else tlp.WindowType.SLIDING,
        1000, 500,
    )
    if reintern_min is not None:
        op._reintern_min = reintern_min
    out = []
    for item in op.run():
        if isinstance(item, p.Batch):
            out.append(("batch", table(item)))
        elif isinstance(item, p.base.WatermarkHint):
            out.append(("hint", item.ts_ms, item.kind))
    return op, out


@pytest.mark.parametrize("hints", [None, "idle", "partition"])
def test_udaf_operator_hints_and_late_rows_match_jax(hints):
    raw = feed(21, n_batches=8, n=120, span=900)
    for b in (4, 6, 7):
        # five stragglers whose windows the watermark closed: late rows
        ts, *cols = raw[b]
        old = np.full(5, T0 + (b - 4) * 900, np.int64)
        raw[b] = (np.concatenate([old, ts]),
                  *(np.concatenate([c[:5], c]) for c in cols))
    (jop, jout), (top, tout) = (_drive(api(pkg), raw, hints) for pkg in PKGS)
    assert tout == jout
    assert top.metrics() == jop.metrics()
    assert top.metrics()["late_rows"] > 0 or hints == "partition"


def test_udaf_reintern_keeps_rows_and_shrinks_the_interner():
    """With the threshold lowered, closed keys leave the interner: the
    port's rows still equal the JAX operator's (which re-interns the same
    way), and its interner holds only the open windows' keys."""
    raw = []
    rng = np.random.default_rng(8)
    for b in range(12):
        n = 64
        ts = np.sort(T0 + b * 1000 + rng.integers(0, 900, n)).astype(np.int64)
        ks = np.array([f"k{b}_{i % 20}" for i in range(n)], object)
        raw.append((ts, ks, rng.normal(0, 1, n), np.ones(n),
                    np.zeros(n, np.int64), np.ones(n, bool),
                    np.ones(n, bool)))
    (jop, jout), (top, tout) = (
        _drive(api(pkg), raw, reintern_min=30) for pkg in PKGS
    )
    assert tout == jout
    assert len(top._interner) == len(jop._interner) < 12 * 20


# -- checkpoints ------------------------------------------------------------


def _ckpt_pipeline(p, ctx, raw):
    spread = p.F.udaf(p.Spread, p.DT.FLOAT64, "reading_spread")
    return ctx.from_source(
        p.Source.from_batches(batches_of(p, raw), timestamp_column="ts"),
        name="udaf_ckpt",
    ).window(
        ["sensor"],
        [spread(p.col("v")).alias("spread"),
         p.F.median(p.col("v")).alias("med"),
         p.F.array_agg(p.col("bits")).alias("arr"),
         p.F.count(p.col("v")).alias("n")],
        1000, 500,
    )


def _run_until_marker(p, path, raw, cut_after):
    """Run a checkpointed pipeline, force a barrier after ``cut_after``
    items, commit it at the root and stop (the kill) → (rows emitted,
    snapshot key, the committed snapshot's JSON)."""
    ctx = p.ctx(checkpoint=True, checkpoint_interval_s=9999,
                state_backend_path=path)
    root = p.executor.build_physical(
        p.lp.Sink(_ckpt_pipeline(p, ctx, raw)._plan, p.Sink()), ctx)
    orch = p.Orch(interval_s=9999)
    coord = p.wire(root, ctx, orch)
    op = next(o for o in _walk(root) if isinstance(o, p.Udaf))
    rows = []
    it = root.run()
    for i, item in enumerate(it):
        if isinstance(item, p.Batch):
            rows += table(item)
        if i == cut_after:
            orch.trigger_now()
        if isinstance(item, p.base.Marker):
            coord.commit(item.epoch)
            break
    it.close()
    key = op._ckpt[1]
    snap = json.loads(coord.get_snapshot(key).decode())
    p.close()
    return rows, key, snap


def _walk(op):
    yield op
    for c in op.children:
        yield from _walk(c)


def _resume(p, path, raw):
    ctx = p.ctx(checkpoint=True, checkpoint_interval_s=9999,
                state_backend_path=path)
    try:
        return table(_ckpt_pipeline(p, ctx, raw).collect())
    finally:
        p.close()


def test_udaf_kill_restore_snapshot_equals_jax(tmp_path):
    """The same cut in both packages writes the same snapshot (key and
    unpacked JSON: watermark, window cursor, every frame's key values and
    accumulator states in emission order; the epoch number aside, which is
    the orchestrator's clock), and the restored port run
    completes the stream: the union of both runs equals the uninterrupted
    run."""
    raw = feed(31, n_batches=10, n=150)
    golden = table(_ckpt_pipeline(api("torch"), api("torch").ctx(), raw)
                   .collect())
    cut = {}
    for pkg in PKGS:
        cut[pkg] = _run_until_marker(api(pkg), str(tmp_path / pkg), raw, 4)
    assert cut["torch"][1] == cut["jax"][1]
    assert cut["torch"][1].startswith("udafwin_")
    # the epoch number is the orchestrator's clock; everything else is state
    snaps = {pkg: dict(cut[pkg][2]) for pkg in PKGS}
    for snap in snaps.values():
        snap.pop("epoch")
    assert snaps["torch"] == snaps["jax"]
    assert snaps["torch"]["frames"]
    assert cut["torch"][0] == cut["jax"][0]
    rest = _resume(api("torch"), str(tmp_path / "torch"), raw)
    union = {r[:2] + (r[-3],): r for r in cut["torch"][0] + rest}
    want = {r[:2] + (r[-3],): r for r in golden}
    assert union == want


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_udaf_snapshot_restores_across_packages(tmp_path, writer, reader):
    raw = feed(32, n_batches=10, n=150)
    path = str(tmp_path / "state")
    rows_a, _key, _snap = _run_until_marker(api(writer), path, raw, 5)
    rest = _resume(api(reader), path, raw)
    golden = table(_ckpt_pipeline(api(reader), api(reader).ctx(), raw)
                   .collect())
    union = {r[:2] + (r[-3],): r for r in rows_a + rest}
    assert union == {r[:2] + (r[-3],): r for r in golden}


def test_cold_tier_spills_and_restores_like_the_jax_package(tmp_path):
    """The cold tier: under a budget the spread window's groups spill to
    the LSM and come back, the rows equal the unbudgeted run's and the JAX
    package's, with the same spill and reload counts.  Then a snapshot holding a spilled group (a
    ``states=None`` placeholder in its frame and a referenced block)
    restores in both packages, with a tier (the marker stays, its block
    re-seeded) and without one (the states load in place), the group at
    its recorded position."""
    from denormalized_tpu.planner.planner import Planner as JPlanner
    from denormalized_tpu.state import tiering as jtier
    from denormalized_tpu.state.lsm import LsmStore as JLsm

    from denormalized_tpu_torch.planner.planner import Planner as TPlanner
    from denormalized_tpu_torch.state import tiering as ttier
    from denormalized_tpu_torch.state.lsm import LsmStore as TLsm
    from denormalized_tpu_torch.state.serialization import pack_snapshot

    raw = feed(1, n_batches=10, n=200, keys=60)
    got, stats = {}, {}
    for pkg in PKGS:
        p = api(pkg)
        for budget in (None, 6_000):
            cfg = {} if budget is None else dict(
                state_backend_path=str(tmp_path / pkg),
                state_budget_bytes=budget)
            ctx = p.ctx(**cfg)
            spread = p.F.udaf(p.Spread, p.DT.FLOAT64, "spread")
            res = ctx.from_source(
                p.Source.from_batches(batches_of(p, raw),
                                      timestamp_column="ts"),
            ).window(["sensor"], [spread(p.col("v")).alias("s")],
                     1000).collect()
            got[pkg, budget] = table(res)
            if budget is not None:
                node = next(iter(ctx._last_spill._stats))
                stats[pkg] = ctx._last_spill.spill_stats(node)
                p.close()
    assert got["torch", 6_000] == got["torch", None] == got["jax", 6_000]
    assert stats["torch"]["spill_blocks_total"] > 0
    assert stats["torch"] == stats["jax"]

    key = "udafwin_1_UdafWindowExec"
    block = pack_snapshot({"keys": [["s0"]],
                           "entries": {"0": [[0, [[2.0, 7.0]]]]},
                           "windows": [0], "groups": 1}, {})

    class Coord:
        def get_snapshot(self, k):
            if k == f"{key}:spill:b0":
                return block
            return json.dumps({
                "epoch": 1, "first_open": 0, "max_win_seen": 0,
                "watermark": 0,
                "frames": {"0": [[["s0"], None], [["s1"], [[1.0, 3.0]]]]},
                "spill_blocks": [0],
            }).encode()

    restored = {}
    for pkg, Lsm, tier, Planner in (("jax", JLsm, jtier, JPlanner),
                                    ("torch", TLsm, ttier, TPlanner)):
        p = api(pkg)
        for with_tier in (False, True):
            ds = source(p, feed(1, n_batches=2, n=10)).window(
                ["sensor"],
                [p.F.udaf(p.Spread, p.DT.FLOAT64, "spread")(p.col("v"))],
                1000)
            op = Planner(ds._ctx.config).create_physical_plan(ds._plan)
            assert isinstance(op, p.Udaf)
            store = None
            if with_tier:
                store = Lsm(str(tmp_path / f"restore_{pkg}"))
                ctrl = tier.SpillController(store, budget_bytes=1 << 20)
                op.enable_spill("1_UdafWindowExec", ctrl)
            op.enable_checkpointing("1_UdafWindowExec", Coord(), None)
            frame = op._frames[0]
            keys = [str(op._interner.keys_of(np.asarray([g]))[0][0])
                    for g in frame]
            if with_tier:
                assert op._tier.any_spilled
                assert type(frame[next(iter(frame))]).__name__ == "_Spilled"
                op._tier.reload_for_window(0)
                ctrl.close()
                store.close()
            restored[pkg, with_tier] = [
                (k, accs[0].evaluate()) for k, accs in zip(keys, frame.values())
            ]
    assert restored["torch", False] == [("s0", 5.0), ("s1", 2.0)]
    assert len({tuple(v) for v in restored.values()}) == 1, restored


# -- the datafusion import shim ---------------------------------------------


def test_datafusion_shim_reexports_the_port_api():
    from denormalized_tpu_torch.datafusion import Accumulator, col, udaf
    from denormalized_tpu_torch.datafusion import functions as f
    from denormalized_tpu_torch.datafusion.functions import count

    import denormalized_tpu.datafusion as jdf
    import denormalized_tpu_torch.datafusion as tdf

    assert Accumulator is TAccumulator and f is TF and count is TF.count
    assert udaf is TF.udaf and col is tt.col
    assert tdf.__all__ == jdf.__all__
