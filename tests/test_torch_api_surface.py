"""The port's API surface against the JAX package's: the plan printers
(``print_schema``, ``print_plan``, ``optimized_plan``,
``print_physical_plan``, ``explain``, ``explain_analyze``, ``__str__``),
``Context.table``, ``EngineConfig.set``, the CSV source and
``FeastDataStream``.  The same query is built in both packages over the
same batches; the logical and optimized plan texts must be equal, and the
physical plans the same operator tree.  Twins of
tests/test_examples_and_misc.py's CSV, functions-tour, Feast and
explain-analyze tests run on ``EngineConfig(device="cpu")``."""

import csv
import json
import threading
import time

import numpy as np
import pytest

import denormalized_tpu as jx
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JEngineConfig
from denormalized_tpu.common.errors import PlanError as JPlanError
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JD
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.sources.csv import CsvSource as JCsvSource
from denormalized_tpu.sources.memory import MemorySource as JMemorySource
import denormalized_tpu_torch as tt
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common import columns as tcols
from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.sources.csv import CsvSource
from denormalized_tpu_torch.sources.memory import MemorySource
from denormalized_tpu_torch.state.lsm import close_global_state_backend

T0 = 1_700_000_000_000


class Pkg:
    """One package's entry points, so a query is written once."""

    def __init__(self, mod, F, config_cls, schema_cls, field_cls, dtype_cls,
                 batch_cls, memory_cls, **ctx_cfg):
        self.mod, self.F, self.EngineConfig = mod, F, config_cls
        self.Schema, self.Field, self.DataType = schema_cls, field_cls, dtype_cls
        self.Batch, self.Memory = batch_cls, memory_cls
        self.ctx_cfg = ctx_cfg

    def context(self, **cfg):
        return self.mod.Context(self.EngineConfig(**self.ctx_cfg, **cfg))

    def batch(self, ts, names, readings):
        D = self.DataType
        schema = self.Schema([
            self.Field("occurred_at_ms", D.INT64, nullable=False),
            self.Field("sensor_name", D.STRING, nullable=False),
            self.Field("reading", D.FLOAT64),
        ])
        return self.Batch(schema, [np.asarray(ts, np.int64),
                                   np.asarray(names, object),
                                   np.asarray(readings, np.float64)])

    def stream(self, ctx, batches, name="sensors"):
        return ctx.from_source(self.Memory.from_batches(
            batches, timestamp_column="occurred_at_ms"), name=name)


PORT = Pkg(tt, TF, tt.EngineConfig, Schema, Field, DataType, RecordBatch,
           MemorySource, device="cpu")
JAX = Pkg(jx, JF, JEngineConfig, JSchema, JField, JD, JBatch, JMemorySource)


def _batches(pkg, n=6):
    rng = np.random.default_rng(5)
    return [pkg.batch(T0 + i * 400 + np.arange(50),
                      [f"s{k}" for k in rng.integers(0, 4, 50)],
                      rng.normal(50, 10, 50)) for i in range(n)]


def q_tumbling(pkg, ctx):
    F, col = pkg.F, pkg.mod.col
    return pkg.stream(ctx, _batches(pkg)).window(
        ["sensor_name"],
        [F.count(col("reading")).alias("count"),
         F.min(col("reading")).alias("min"),
         F.max(col("reading")).alias("max"),
         F.avg(col("reading")).alias("average")], 1000)


def q_sliding_filter(pkg, ctx):
    F, col = pkg.F, pkg.mod.col
    return pkg.stream(ctx, _batches(pkg)).window(
        ["sensor_name"], [F.count(col("reading")).alias("cnt"),
                          F.avg(col("reading")).alias("avg")],
        1000, 200).filter(col("avg") > 45.0)


def q_projection(pkg, ctx):
    """The projection half of examples/functions_tour.py, then its window
    with the ported aggregates."""
    F, col, lit = pkg.F, pkg.mod.col, pkg.mod.lit
    return (
        pkg.stream(ctx, _batches(pkg))
        .with_column("sensor", F.lower(F.replace("sensor_name", "s", "S")))
        .with_column("band", F.when(col("reading") > 55.0, lit("hot"))
                     .when(col("reading") < 45.0, lit("cold"))
                     .otherwise(lit("mild")))
        .filter(F.length("sensor") >= 2)
        .select("occurred_at_ms", "sensor", "band", "reading")
        .window(["sensor", "band"],
                [F.count(col("reading")).alias("n"),
                 F.avg(col("reading")).alias("mean"),
                 F.stddev(col("reading")).alias("sd")], 1000)
        .filter(col("n") > 1)
    )


def q_join(pkg, ctx):
    F, col = pkg.F, pkg.mod.col
    left = pkg.stream(ctx, _batches(pkg), "left").window(
        ["sensor_name"], [F.avg(col("reading")).alias("avg")], 1000)
    right = pkg.stream(ctx, _batches(pkg), "right").window(
        ["sensor_name"], [F.count(col("reading")).alias("cnt")], 1000
    ).with_column_renamed("sensor_name", "r_sensor").with_column_renamed(
        "window_start_time", "r_ws").with_column_renamed(
        "window_end_time", "r_we")
    return left.join(right, "inner", ["sensor_name", "window_start_time"],
                     ["r_sensor", "r_ws"])


def q_udaf(pkg, ctx):
    """A window holding accumulator aggregates (the UDAF operator)."""
    F, col = pkg.F, pkg.mod.col
    return pkg.stream(ctx, _batches(pkg)).with_column(
        "r2", col("reading") * 2.0).window(
        ["sensor_name"], [F.median(col("reading")).alias("med"),
                          F.count(col("r2")).alias("n")], 1000)


def q_session(pkg, ctx):
    F, col = pkg.F, pkg.mod.col
    return pkg.stream(ctx, _batches(pkg)).filter(
        col("reading") > 40.0).session_window(
        ["sensor_name"], [F.count(col("reading")).alias("n"),
                          F.array_agg(col("reading")).alias("arr")], 150)


QUERIES = {"tumbling": q_tumbling, "sliding_filter": q_sliding_filter,
           "projection": q_projection, "join": q_join, "udaf": q_udaf,
           "session": q_session}


def _tree(text: str) -> list[tuple[int, str]]:
    """(depth, operator name) of each line of a physical plan."""
    return [((len(line) - len(line.lstrip())) // 2,
             line.strip().split("(")[0]) for line in text.splitlines()]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_plan_text_matches_the_jax_package(name):
    """The logical and optimized plan texts are the JAX package's, the
    physical plan the same operator tree and, where no backend is named,
    the same labels."""
    q = QUERIES[name]
    tds, jds = q(PORT, PORT.context()), q(JAX, JAX.context())
    assert tds.logical_plan().display() == jds.logical_plan().display()
    assert tds.optimized_plan().display() == jds.optimized_plan().display()
    tphys = tds._physical_display(tds.optimized_plan())
    jphys = jds._physical_display(jds.optimized_plan())
    assert _tree(tphys) == _tree(jphys)
    assert tphys == jphys
    assert str(tds) == repr(tds) == repr(jds)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_printers_print_what_the_jax_package_prints(name, capsys):
    """print_schema, print_plan, print_physical_plan and explain() print
    the JAX package's text for the same query, and chain."""
    q = QUERIES[name]
    outs = []
    for pkg in (PORT, JAX):
        ds = q(pkg, pkg.context())
        assert ds.print_schema() is ds
        assert ds.print_plan() is ds
        assert ds.print_physical_plan() is ds
        assert ds.explain() is ds
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "== optimized plan ==" in outs[0]
    assert "== physical plan ==" in outs[0]


def test_engine_config_set_as_the_jax_package():
    """EngineConfig.set takes the reference's ``denormalized_config.``
    spelling or the bare name, returns the config, and raises PlanError on
    an unknown key — as the JAX package's does."""
    for cfg, err in ((tt.EngineConfig(device="cpu"), PlanError),
                     (JEngineConfig(), JPlanError)):
        assert cfg.set("denormalized_config.checkpoint", True) is cfg
        assert cfg.checkpoint is True
        cfg.set("checkpoint_interval_s", 2.5)
        assert cfg.checkpoint_interval_s == 2.5
        with pytest.raises(err, match="unknown config key"):
            cfg.set("denormalized_config.no_such_knob", 1)


def _rows(res):
    names = res.schema.without_internal().names
    return sorted(
        tuple(repr(np.asarray(res.column(n)[i]).tolist()) if isinstance(
            res.column(n)[i], (list, np.ndarray)) else res.column(n)[i]
              for n in names)
        for i in range(res.num_rows)
    )


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return a == pytest.approx(b, rel=1e-5, nan_ok=True)
    return a == b


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_optimizer_off_as_the_jax_package(name, capsys):
    """ROADMAP §C2: ``EngineConfig(optimizer=False)`` (or its
    ``denormalized_config.optimizer`` key) runs the plan as written.  With
    it off both packages print the same plan texts (the optimized plan is
    the logical one), the physical plans agree, and the rows equal the
    optimizer-on run's: exactly within a package, to the f32 ring's
    rtol=1e-5 across packages."""
    q = QUERIES[name]
    out = {}
    for pkg in (PORT, JAX):
        off = pkg.context(optimizer=False)
        assert pkg.context().config.set(
            "denormalized_config.optimizer", False).optimizer is False
        ds = q(pkg, off)
        assert ds.optimized_plan().display() == ds.logical_plan().display()
        ds.explain()
        text = capsys.readouterr().out
        on_rows = _rows(q(pkg, pkg.context()).collect())
        off_ctx = pkg.context(optimizer=False)
        off_rows = _rows(q(pkg, off_ctx).collect())
        assert off_rows == on_rows
        # the operator tree the executor built for the run
        out[pkg] = (text, off_rows, off_ctx._last_physical.display())
    assert out[PORT][0] == out[JAX][0]
    assert out[PORT][2] == out[JAX][2]
    assert len(out[PORT][1]) == len(out[JAX][1]) > 0
    for a, b in zip(out[PORT][1], out[JAX][1]):
        assert all(_close(x, y) for x, y in zip(a, b)), (a, b)


def test_context_table_and_str_as_the_jax_package():
    """Context.table returns the registered source and raises PlanError on
    an unknown name; str(ctx) is repr(ctx), listing the tables."""
    for pkg, err in ((PORT, PlanError), (JAX, JPlanError)):
        ctx = pkg.context()
        src = pkg.Memory.from_batches(_batches(pkg, 1),
                                      timestamp_column="occurred_at_ms")
        ctx.from_source(src, name="t1")
        assert ctx.table("t1") is src
        with pytest.raises(err, match="unknown table"):
            ctx.table("nope")
        assert str(ctx) == repr(ctx)
        assert "tables=[t1]" in str(ctx)


# -- twins of tests/test_examples_and_misc.py ------------------------------


def _write_csv(path, rows, seed=3):
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["occurred_at_ms", "sensor_name", "reading"])
        for i in range(rows):
            w.writerow([T0 + i, f"sensor_{rng.integers(5)}",
                        f"{rng.normal(50, 10):.4f}"])


def test_csv_streaming_example(tmp_path, capsys):
    """Twin of tests/test_examples_and_misc.py:39: examples/csv_streaming.py's
    job (a 10,000-row CSV → 1 s count/avg by sensor_name → print_stream)
    through the port's CsvSource; every row counted once, and the same
    window rows as the JAX package's job on the same file."""
    path = tmp_path / "in.csv"
    _write_csv(path, 10_000)
    rows = {}
    for pkg, src_cls in ((PORT, CsvSource), (JAX, JCsvSource)):
        ctx = pkg.context()
        col, F = pkg.mod.col, pkg.F
        ds = ctx.from_source(src_cls(str(path),
                                     timestamp_column="occurred_at_ms")
                             ).window([col("sensor_name")],
                                      [F.count(col("reading")).alias("count"),
                                       F.avg(col("reading")).alias("avg")],
                                      1000)
        ds.print_stream()
        lines = [json.loads(line) for line in
                 capsys.readouterr().out.splitlines() if line.startswith("{")]
        assert sum(r["count"] for r in lines) == 10_000
        assert {"sensor_name", "count", "avg", "window_start_time"} <= set(
            lines[0])
        rows[pkg] = {(r["window_start_time"], r["sensor_name"]):
                     (r["count"], r["avg"]) for r in lines}
    assert rows[PORT].keys() == rows[JAX].keys()
    for k, (c, a) in rows[JAX].items():
        assert rows[PORT][k][0] == c
        assert rows[PORT][k][1] == pytest.approx(a, rel=1e-6)


def _tour(pkg, broker, capsys):
    """examples/functions_tour.py's query over ``broker``'s topic: explain,
    then stream every closable window (start + 1 s <= max ts) → rows by
    (window, sensor, band)."""
    col, lit, F = pkg.mod.col, pkg.mod.lit, pkg.F
    ctx = pkg.context(source_idle_timeout_ms=400)
    ds = (
        ctx.from_topic(
            "readings",
            sample_json=json.dumps({"occurred_at_ms": 1,
                                    "sensor_name": "a", "reading": 1.0}),
            bootstrap_servers=broker.bootstrap,
            timestamp_column="occurred_at_ms")
        .with_column("sensor",
                     F.lower(F.replace("sensor_name", "Sensor_", "s")))
        .with_column("band", F.when(col("reading") > 25.0, lit("hot"))
                     .when(col("reading") < 15.0, lit("cold"))
                     .otherwise(lit("mild")))
        .with_column("minute",
                     F.date_trunc("minute", col("occurred_at_ms")))
        .filter(F.length("sensor") >= 2)
        .window(["sensor", "band"],
                [F.count(col("reading")).alias("n"),
                 F.avg(col("reading")).alias("mean"),
                 F.stddev(col("reading")).alias("sd"),
                 F.median(col("reading")).alias("med"),
                 F.approx_distinct(col("reading")).alias("distinct")], 1000)
        .filter(col("n") > 1)
    )
    ds.explain()
    rows = {}
    it = ds.stream()
    deadline = time.time() + 30
    for batch in it:
        for i in range(batch.num_rows):
            rows[(int(batch.column("window_start_time")[i]),
                  str(batch.column("sensor")[i]),
                  str(batch.column("band")[i]))] = tuple(
                batch.column(c)[i] for c in ("n", "mean", "sd", "med",
                                             "distinct"))
            print(f"sd={rows[max(rows)][2]:5.2f} med={rows[max(rows)][3]:6.2f}"
                  f" distinct={rows[max(rows)][4]}")
        if {k[0] for k in rows} >= set(range(T0, T0 + 7000, 1000)) or (
                time.time() > deadline):
            break
    it.close()
    print(f"{len(rows)} window rows emitted")
    return rows


def test_functions_tour_example(capsys):
    """Twin of tests/test_examples_and_misc.py:55: the tour's query,
    median and approx_distinct included (the UDAF operator carries the
    whole window once an accumulator aggregate is in it), over each
    package's mock broker holding the same 800 records, through
    ``explain()`` and the stream.  Every closable window has the same rows
    in both packages: counts, medians and HyperLogLog estimates exactly,
    avg and stddev to rtol=1e-12 (both fold the same f64 host moments)."""
    from denormalized_tpu.testing.mock_kafka import (
        MockKafkaBroker as JBroker,
    )
    from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

    rng = np.random.default_rng(0)
    msgs = [json.dumps({
        "occurred_at_ms": T0 + i * 10,
        "sensor_name": f"Sensor_{i % 4}",
        "reading": float(np.round(rng.normal(20, 5), 3)),
    }).encode() for i in range(800)]
    rows = {}
    for pkg, broker_cls in ((PORT, MockKafkaBroker), (JAX, JBroker)):
        broker = broker_cls().start()
        try:
            broker.create_topic("readings", partitions=1)
            broker.produce("readings", 0, msgs, ts_ms=T0)
            rows[pkg] = _tour(pkg, broker, capsys)
        finally:
            broker.stop()
        out = capsys.readouterr().out
        assert "window rows emitted" in out
        assert "== optimized plan ==" in out
        assert "sd=" in out and "med=" in out and "distinct=" in out
    closable = {k for k in rows[JAX] if k[0] + 1000 <= T0 + 7990}
    assert closable and closable <= set(rows[PORT])
    for k in closable:
        (n, mean, sd, med, d), (jn, jmean, jsd, jmed, jd) = (
            rows[PORT][k], rows[JAX][k])
        assert (n, med, d) == (jn, jmed, jd), k
        assert mean == pytest.approx(jmean, rel=1e-12), k
        assert sd == pytest.approx(jsd, rel=1e-12), k


def test_csv_source_inference(tmp_path):
    """Twin of tests/test_examples_and_misc.py:62: types inferred, the
    empty reading null, strings as a StringColumn with the same values as
    the JAX package's object column."""
    p = tmp_path / "x.csv"
    p.write_text("ts,name,v,ok\n1,a,1.5,true\n2,b,,false\n")
    src = CsvSource(str(p), timestamp_column="ts")
    schema = src.schema
    assert schema.field("ts").dtype is DataType.INT64
    assert schema.field("v").dtype is DataType.FLOAT64
    assert schema.field("ok").dtype is DataType.BOOL
    assert schema.field("name").dtype is DataType.STRING
    batch = src.partitions()[0].read()
    assert batch.num_rows == 2
    m = batch.mask("v")
    assert m is not None and m.tolist() == [True, False]
    assert isinstance(batch.column("name"), tcols.StringColumn)
    jb = JCsvSource(str(p), timestamp_column="ts").partitions()[0].read()
    assert tcols.as_numpy(batch.column("name")).tolist() == list(
        jb.column("name"))
    assert [f.name for f in schema] == [f.name for f in jb.schema]


def test_csv_empty_fields_are_null_strings(tmp_path):
    """An empty text field is null in the port's StringColumn, where the
    JAX package masks it (its value ``""`` under a False mask)."""
    p = tmp_path / "y.csv"
    p.write_text("ts,name\n1,a\n2,\n3,c\n")
    batch = CsvSource(str(p), timestamp_column="ts").partitions()[0].read()
    jb = JCsvSource(str(p), timestamp_column="ts").partitions()[0].read()
    assert batch.mask("name").tolist() == jb.mask("name").tolist() == [
        True, False, True]
    assert tcols.as_numpy(batch.column("name")).tolist() == ["a", None, "c"]


def test_feast_data_stream():
    """Twin of tests/test_examples_and_misc.py:79: the metaclass keeps
    chaining Feast-typed and write_feast_feature pushes every batch (a fake
    store: Feast itself is optional, as in the JAX package)."""
    from denormalized_tpu_torch.api.feast_data_stream import FeastDataStream

    batches = [PORT.batch([T0 + i * 300 + j for j in range(3)], ["x"] * 3,
                          [1.0] * 3) for i in range(8)]
    ds = PORT.stream(PORT.context(), batches)
    fds = FeastDataStream.from_data_stream(ds).window(
        ["sensor_name"], [TF.count(tt.col("reading")).alias("cnt")], 1000)
    assert isinstance(fds, FeastDataStream)
    assert isinstance(fds.filter(tt.col("cnt") > 0), FeastDataStream)

    class FakeStore:
        def __init__(self):
            self.pushes = []

        def push(self, name, df):
            self.pushes.append((name, df))

    store = FakeStore()
    fds.write_feast_feature(store, "sensor_stats")
    assert store.pushes and store.pushes[0][0] == "sensor_stats"
    assert sum(int(np.sum(df["cnt"])) for _, df in store.pushes) == 24


def _explain_batches(pkg):
    return [pkg.batch([T0, T0 + 700, T0 + 1500], ["a", "b", "a"],
                      [1.0, 2.0, 3.0])]


def test_explain_analyze(capsys):
    """Twin of tests/test_examples_and_misc.py:141: explain(analyze=True)
    runs into a discard sink and prints the physical plan with each
    operator's metrics, then the doctor's ranked report;
    explain_analyze() returns the doctor's report, with the JAX package's
    node ids in the same order, and with ``doctor_enabled=False`` the
    metrics dump (the JAX package's text then)."""
    ds = PORT.stream(PORT.context(), _explain_batches(PORT)).window(
        ["sensor_name"], [TF.count(tt.col("reading")).alias("c")], 1000)
    assert ds.explain(analyze=True) is ds
    text = capsys.readouterr().out
    assert "== physical plan (analyzed) ==" in text
    analyzed = text.split("== physical plan (analyzed) ==", 1)[1]
    analyzed, ranked = analyzed.split("== bottleneck report ==", 1)
    assert "rows_in=3" in analyzed or "rows_out=3" in analyzed
    assert "[" in analyzed
    assert "bottleneck:" in ranked and "rule:" in ranked
    report = ds.explain_analyze(print_output=False)
    assert capsys.readouterr().out == ""
    assert report.startswith("== q") and "bottleneck:" in report

    def node_ids(rep):
        return [ln.split()[0] for ln in rep.splitlines()[1:]
                if ln.strip() and ln.strip()[0].isdigit()]

    jds_doc = JAX.stream(JAX.context(), _explain_batches(JAX)).window(
        ["sensor_name"], [JF.count(jx.col("reading")).alias("c")], 1000)
    jranked = jds_doc.explain_analyze(print_output=False)
    assert node_ids(report) == node_ids(jranked) != []
    off = PORT.stream(PORT.context(doctor_enabled=False),
                      _explain_batches(PORT)).window(
        ["sensor_name"], [TF.count(tt.col("reading")).alias("c")], 1000)
    plain = off.explain_analyze(print_output=False)
    assert plain.splitlines()[0].startswith("SinkExec(CallbackSink)")
    assert _tree(plain) == _tree(analyzed.strip())
    jds = JAX.stream(JAX.context(doctor_enabled=False),
                     _explain_batches(JAX)).window(
        ["sensor_name"], [JF.count(jx.col("reading")).alias("c")], 1000)
    jreport = jds.explain_analyze(print_output=False)
    assert _tree(plain) == _tree(jreport)


def _ckpt_ds(pkg, ctx, n):
    return pkg.stream(ctx, [
        pkg.batch([T0 + i, T0 + 1500 + i], ["a", "b"], [1.0, 2.0])
        for i in range(n)]).window(
        ["sensor_name"], [pkg.F.count(pkg.mod.col("reading")).alias("c")],
        1000)


def test_explain_analyze_does_not_commit_checkpoints(tmp_path, capsys):
    """Twin of tests/test_examples_and_misc.py:167: with checkpointing on,
    an analyze run commits no epoch, and a real run after it reads the
    whole stream."""
    cfg = tt.EngineConfig(device="cpu", checkpoint=True,
                          checkpoint_interval_s=9999,
                          state_backend_path=str(tmp_path / "state"))
    ctx = tt.Context(cfg)
    _ckpt_ds(PORT, ctx, 4).explain(analyze=True)
    assert cfg.checkpoint is True
    assert ctx.last_checkpointing() == (None, None)
    capsys.readouterr()
    close_global_state_backend()
    out = _ckpt_ds(PORT, tt.Context(cfg), 4).collect()
    assert int(np.sum(out.column("c"))) == 8
    close_global_state_backend()


def test_explain_analyze_never_mutates_shared_config(tmp_path, capsys):
    """Twin of tests/test_examples_and_misc.py:207: the analyze run's
    checkpoint override is per execution; a sampler thread never sees the
    shared EngineConfig's ``checkpoint`` flip."""
    cfg = tt.EngineConfig(device="cpu", checkpoint=True,
                          checkpoint_interval_s=9999,
                          state_backend_path=str(tmp_path / "state"))
    ds = _ckpt_ds(PORT, tt.Context(cfg), 8)
    observed_false = threading.Event()
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            if cfg.checkpoint is not True:
                observed_false.set()
                return

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        ds.explain(analyze=True)
    finally:
        stop.set()
        t.join(5)
        capsys.readouterr()
        close_global_state_backend()
    assert not observed_false.is_set()
