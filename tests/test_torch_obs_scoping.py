"""Per-query registry scoping and the metrics-off null path of the port,
held against the JAX package's.

Twins of ``tests/test_obs_scoping.py`` and the disabled-path tests of
``tests/test_obs.py``:

- two queries running at once in one process, one with metrics on and
  one off, keep separate series: the off query binds only the shared
  falsy NULL and adds nothing to the registry (as in the JAX package);
- the thread-local binding stack nests, and an out-of-order exit removes
  the right entry; a worker thread binding inside a captured registry
  lands there;
- the prefetch workers of a live source of two partitions, and a reader
  rebuilt on a worker thread after a crash, bind into their query's
  registry, not the process default; so do the join's pump threads;
- a query's JSONL exporter snapshots that query's registry;
- with metrics off, every handle of every operator is falsy, the
  window's per-batch observability calls allocate nothing (tracemalloc),
  and the rows equal the metrics-on run's and the JAX package's.
"""

from __future__ import annotations

import json
import threading
import tracemalloc

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
from denormalized_tpu_torch import obs
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.obs import statewatch
from denormalized_tpu_torch.obs.jsonl import read_stream
from denormalized_tpu_torch.obs.registry import NULL, MetricsRegistry
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec
from denormalized_tpu_torch.runtime import faults
from denormalized_tpu_torch.runtime.prefetch import PrefetchPump
from denormalized_tpu_torch.sources.kafka import KafkaTopicBuilder
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state.checkpoint import walk
from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

T0 = 1_700_000_000_000

PKG = {
    "jax": dict(mod=jt, F=JF, Schema=JSchema, Field=JField, DT=JType,
                Batch=JBatch, Source=JSource,
                ctx=lambda **kw: jt.Context(JConfig(**kw))),
    "torch": dict(mod=tt, F=TF, Schema=TSchema, Field=TField, DT=TType,
                  Batch=TBatch, Source=TSource,
                  ctx=lambda **kw: tt.Context(
                      tt.EngineConfig(device="cpu", **kw))),
}


@pytest.fixture
def registry():
    reg = MetricsRegistry(enabled=True)
    prev = obs.use_registry(reg)
    yield reg
    obs.use_registry(prev)


def _source(a, n_batches=8, rows=200, seed=0):
    rng = np.random.default_rng(seed)
    schema = a["Schema"]([
        a["Field"]("occurred_at_ms", a["DT"].INT64, nullable=False),
        a["Field"]("sensor_name", a["DT"].STRING, nullable=False),
        a["Field"]("reading", a["DT"].FLOAT64),
    ])
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 400 + rng.integers(0, 400, rows))
        names = rng.choice([f"sensor_{i}" for i in range(5)],
                           rows).astype(object)
        out.append(a["Batch"](schema, [ts, names,
                                       rng.normal(50.0, 10.0, rows)]))
    return a["Source"].from_batches(out, timestamp_column="occurred_at_ms")


def _run(name, enabled, n_batches=8, seed=0):
    a = PKG[name]
    col, F = a["mod"].col, a["F"]
    ctx = a["ctx"](metrics_enabled=enabled)
    out = ctx.from_source(_source(a, n_batches=n_batches, seed=seed)).window(
        [col("sensor_name")],
        [F.count(col("reading")).alias("c"), F.max(col("reading")).alias("m")],
        1000).collect()
    return ctx, out


def _window_op(ctx):
    for op in walk(ctx._last_physical):
        if isinstance(op, StreamingWindowExec):
            return op
    raise AssertionError("no window operator")


def _rows(out):
    return sorted(zip(
        np.asarray(out.column("window_start_time")).tolist(),
        [str(k) for k in out.column("sensor_name")],
        np.asarray(out.column("c")).tolist(),
        np.asarray(out.column("m")).tolist(),
    ))


def test_concurrent_queries_with_mixed_enablement_keep_separate_series(
    registry,
):
    results: dict = {}
    barrier = threading.Barrier(2, timeout=30)

    def run(key, enabled, seed):
        barrier.wait()
        results[key] = _run("torch", enabled, n_batches=12, seed=seed)

    ta = threading.Thread(target=run, args=("a", True, 1))
    tb = threading.Thread(target=run, args=("b", False, 2))
    ta.start()
    tb.start()
    ta.join(timeout=60)
    tb.join(timeout=60)
    win_a = _window_op(results["a"][0])
    win_b = _window_op(results["b"][0])
    assert win_a._obs_rows_in is not NULL
    assert win_a._obs_rows_in.value == 12 * 200
    assert win_b._obs_rows_in is NULL and win_b._obs_batch_ms is NULL
    assert win_b._sw is statewatch.NULL_WATCH
    assert registry.counter(
        "dnz_op_rows_in_total", op="window").value == 12 * 200
    for key in ("a", "b"):
        assert _window_op(results[key][0]).metrics()["rows_in"] == 12 * 200


def test_disabled_query_binds_nothing(registry):
    _run("torch", False)
    assert registry.instruments() == []
    _run("torch", True)
    assert registry.counter(
        "dnz_op_rows_in_total", op="window").value == 8 * 200


def test_bound_registry_nesting_and_out_of_order_exit():
    default = obs.current_registry()
    r1, r2 = MetricsRegistry(enabled=True), MetricsRegistry(enabled=True)
    cm1 = obs.bound_registry(r1)
    cm1.__enter__()
    cm2 = obs.bound_registry(r2)
    cm2.__enter__()
    assert obs.current_registry() is r2
    cm1.__exit__(None, None, None)
    assert obs.current_registry() is r2
    cm2.__exit__(None, None, None)
    assert obs.current_registry() is default


def test_worker_thread_binds_into_captured_registry(registry):
    captured = MetricsRegistry(enabled=True)
    bound = {}

    def worker(reg):
        with obs.bound_registry(reg):
            bound["c"] = obs.counter("dnz_op_rows_in_total", op="capture")

    t = threading.Thread(target=worker, args=(captured,))
    t.start()
    t.join(timeout=10)
    assert bound["c"] is captured.counter("dnz_op_rows_in_total",
                                          op="capture")
    assert registry.instruments() == []


def test_prefetch_workers_bind_into_their_query_registry(registry):
    """Readers, pump workers and a reader rebuilt ON the worker thread
    after an injected crash bind into the registry the pump was built
    under."""
    broker = MockKafkaBroker().start()
    try:
        broker.create_topic("scope", partitions=2)
        for p in range(2):
            broker.produce_batched("scope", p, [json.dumps({
                "ts": T0 + i, "p": p, "i": i, "v": 1.0}).encode()
                for i in range(400)])
        query = MetricsRegistry(enabled=True)
        with obs.bound_registry(query):
            src = (KafkaTopicBuilder(broker.bootstrap).with_topic("scope")
                   .infer_schema_from_json(
                       '{"ts": 1, "p": 1, "i": 1, "v": 1.0}')
                   .with_timestamp_column("ts")
                   .with_option("max.batch.rows", 64).build_reader())
            readers = src.partitions()
            pump = PrefetchPump(readers,
                                reader_factories=src.partition_factories(),
                                source_name="scope")
        faults.arm({"rules": [{"site": "kafka.fetch", "kind": "error",
                               "after": 2, "times": 1,
                               "message": "injected crash"}]})
        pump.start()
        try:
            seen = 0
            for _idx, _snap, batch in pump.drain(total_rows=800):
                seen += batch.num_rows
        finally:
            faults.disarm()
            pump.stop(join_timeout_s=5.0)
            for r in readers:
                r.close()
        assert seen == 800
    finally:
        broker.stop()
    snap = query.snapshot()
    assert pump.restart_stats()["restarts"] >= 1
    assert sum(v for k, v in snap.items()
               if k.startswith("dnz_prefetch_restarts_total")) >= 1
    assert any(k.startswith("dnz_kafka_consumer_lag_rows") for k in snap)
    assert any(k.startswith("dnz_prefetch_queue_depth") for k in snap)
    assert registry.instruments() == []


def test_join_pump_threads_bind_into_the_query_registry(registry):
    """The join runs each input on a pump thread; the windows there bind
    their hot-key gauges lazily, from that thread, into the query's
    registry."""
    a = PKG["torch"]
    col, F = tt.col, TF
    query = MetricsRegistry(enabled=True)
    ctx = a["ctx"]()

    def side(seed, name, agg):
        return ctx.from_source(_source(a, n_batches=10, seed=seed),
                               name=name).window(
            ["sensor_name"], [F.avg(col("reading")).alias(agg)], 1000)

    right = (side(2, "h", "avg_h")
             .with_column_renamed("sensor_name", "hs")
             .with_column_renamed("window_start_time", "hws")
             .with_column_renamed("window_end_time", "hwe"))
    with obs.bound_registry(query):
        out = side(1, "t", "avg_t").join(
            right, "inner", ["sensor_name", "window_start_time"],
            ["hs", "hws"]).collect()
    assert out.num_rows > 0
    snap = query.snapshot()
    hot = [k for k in snap if k.startswith("dnz_state_hot_key_share")]
    assert any("StreamingWindowExec" in k for k in hot), hot
    assert snap['dnz_op_rows_in_total{op="join"}'] > 0
    assert registry.instruments() == []


def test_exporters_scope_to_the_query_registry(registry, tmp_path):
    registry.counter("dnz_op_rows_in_total", op="preexisting").add(7)
    path = tmp_path / "obs.jsonl"
    a = PKG["torch"]
    ctx = a["ctx"](metrics_enabled=False, metrics_jsonl_path=str(path),
                   metrics_jsonl_interval_s=0.05)
    ctx.from_source(_source(a)).window(
        [tt.col("sensor_name")], [TF.count(tt.col("reading")).alias("c")],
        1000).collect()
    snaps = read_stream(path)
    assert snaps and all(s["metrics"] == {} for s in snaps)


def test_metrics_off_null_path_allocates_nothing_and_rows_match():
    ctx_off, out_off = _run("torch", False)
    _ctx_on, out_on = _run("torch", True)
    _jctx, out_j = _run("jax", False)
    assert _rows(out_off) == _rows(out_on)
    rj = sorted(zip(
        np.asarray(out_j.column("window_start_time")).tolist(),
        [str(k) for k in out_j.column("sensor_name")],
        np.asarray(out_j.column("c")).tolist(),
        np.asarray(out_j.column("m")).tolist(),
    ))
    assert [r[:3] for r in _rows(out_off)] == [r[:3] for r in rj]
    assert np.allclose([r[3] for r in _rows(out_off)], [r[3] for r in rj],
                       rtol=1e-5)
    # every handle of every operator is the falsy NULL
    for op in walk(ctx_off._last_physical):
        for attr, v in vars(op).items():
            if attr.startswith("_obs_") and attr not in (
                    "_obs_reg", "_obs_source_label"):
                handles = v.values() if isinstance(v, dict) else [v]
                assert all(h is NULL for h in handles), (op, attr)
        assert not getattr(op, "_sw", None)
    win = _window_op(ctx_off)
    gid = np.arange(512, dtype=np.int32) % 5

    def per_batch():
        # the window's per-batch observability calls, as _process_batch,
        # _trigger and the emission funnel make them
        win._obs_rows_in.add(512)
        win._obs_late.add(3)
        win._sw.update(gid)
        if win._obs_wm_lag:
            win._obs_wm_lag.set(1.0)
        win._obs_windows.add(1)
        if win._obs_emit_lag:
            win._obs_emit_lag.observe(2.0)
        win._obs_batch_ms.observe(0.5)

    for _ in range(10):
        per_batch()
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(5000):
            per_batch()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [s for s in after.compare_to(before, "filename")
             if "denormalized_tpu_torch" in s.traceback[0].filename
             and s.size_diff > 0]
    assert grown == [], grown[:3]
