"""The port's Kafka stack (``sources/kafka.py``, ``native/kafka_client.cpp``,
``testing/mock_kafka.py``) against the JAX package's: twins of
tests/test_kafka.py without Avro or security (the wire client against the
mock broker, compressed batches, poison records, a broker outage, fetch
splitting with exact offsets, projection pushdown, the positional
``from_topic`` order, ``sink_kafka``), and ``from_topic`` → window in both
packages over the same seeded topic with equal rows.  Also the sinks, the
refusal of ``collect()`` on a live stream, the teardown of a closed
stream, the Kafka fault sites, and chip_smoke.py's numpy record encoder
against the mock broker's own."""

import io
import json
import sys
import threading
import time

import numpy as np
import pytest

import denormalized_tpu as jx
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JEngineConfig
from denormalized_tpu.sources.kafka import KafkaClient as JKafkaClient
from denormalized_tpu.testing import mock_kafka as jmock
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common import columns as tcols
from denormalized_tpu_torch.common.constants import WINDOW_START_COLUMN
from denormalized_tpu_torch.common.errors import PlanError, SourceError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.physical import simple_execs
from denormalized_tpu_torch.runtime import faults
from denormalized_tpu_torch.sources.kafka import (
    KafkaClient,
    KafkaSinkWriter,
    KafkaTopicBuilder,
)
from denormalized_tpu_torch.testing.mock_kafka import (
    MockKafkaBroker,
    build_record_batch,
    parse_record_batches,
)

T0 = 1_700_000_000_000
SAMPLE = json.dumps({"occurred_at_ms": 1, "sensor_name": "a", "reading": 1.0})
DEADLINE_S = 30.0


@pytest.fixture
def broker():
    b = MockKafkaBroker().start()
    yield b
    b.stop()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


def _reader(broker, topic, sample=SAMPLE, **opts):
    b = (KafkaTopicBuilder(broker.bootstrap).with_topic(topic)
         .infer_schema_from_json(sample).with_timestamp_column("occurred_at_ms"))
    for k, v in opts.items():
        b = b.with_option(k, v)
    return b.build_reader()


def test_record_batch_codec_roundtrip():
    records = [(1000, b"hello"), (1001, b""), (1002, "日本".encode())]
    blob = build_record_batch(7, records)
    assert blob == jmock.build_record_batch(7, records)
    assert parse_record_batches(blob) == records


def test_native_client_metadata_offsets_produce_fetch(broker):
    broker.create_topic("t1", partitions=3)
    c, jc = KafkaClient(broker.bootstrap), JKafkaClient(broker.bootstrap)
    assert c.partition_count("t1") == jc.partition_count("t1") == 3
    assert c.list_offset("t1", 0, -2) == c.list_offset("t1", 0, -1) == 0
    payloads = [json.dumps({"i": i}).encode() for i in range(100)]
    c.produce("t1", 0, payloads[:60])
    c.produce("t1", 0, payloads[60:])
    assert c.list_offset("t1", 0, -1) == jc.list_offset("t1", 0, -1) == 100
    got, ts, next_off = c.fetch("t1", 0, 0, max_wait_ms=10)
    jgot, jts, jnext = jc.fetch("t1", 0, 0, max_wait_ms=10)
    assert got == jgot == payloads and next_off == jnext == 100
    assert ts.tolist() == jts.tolist()
    assert c.fetch("t1", 0, 42, max_wait_ms=10)[0] == payloads[42:]
    t = time.time()
    assert c.fetch("t1", 0, 100, max_wait_ms=80)[0] == []
    assert time.time() - t >= 0.05
    c.close()
    jc.close()
    with pytest.raises(SourceError, match="closed"):
        c.partition_count("t1")


@pytest.mark.parametrize("codec", [1, 2, 3, 4],
                         ids=["gzip", "snappy", "lz4", "zstd"])
def test_compressed_batches(broker, codec):
    if codec == 4:
        pytest.importorskip("zstandard")
    broker.create_topic("z", partitions=1)
    payloads = [json.dumps({"i": i, "pad": "x" * 100}).encode()
                for i in range(50)]
    broker.produce("z", 0, payloads[:25], ts_ms=123, codec=codec)
    broker.produce("z", 0, payloads[25:], ts_ms=123, codec=codec)
    c = KafkaClient(broker.bootstrap)
    got, ts, next_off = c.fetch("z", 0, 0, max_wait_ms=10)
    while len(got) < 50:
        more, _, next_off = c.fetch("z", 0, next_off, max_wait_ms=10)
        got += more
    assert got == payloads and next_off == 50 and list(ts[:25]) == [123] * 25
    assert c.fetch("z", 0, 30, max_wait_ms=10)[0][:20] == payloads[30:]
    c.close()


def test_mixed_codec_fetch_preserves_offset_order(broker):
    pytest.importorskip("zstandard")
    broker.create_topic("mix", partitions=1)
    broker.produce("mix", 0, [b'{"i": 0}', b'{"i": 1}'], ts_ms=1, codec=4)
    broker.produce("mix", 0, [b'{"i": 2}', b'{"i": 3}'], ts_ms=2)
    broker.produce("mix", 0, [b'{"i": 4}'], ts_ms=3, codec=4)
    c = KafkaClient(broker.bootstrap)
    seen, off = [], 0
    for _ in range(6):
        got, _, off = c.fetch("mix", 0, off, max_wait_ms=10)
        seen.extend(got)
        if len(seen) >= 5:
            break
    assert seen == [b'{"i": %d}' % i for i in range(5)] and off == 5
    c.close()


def _topic(broker, name, parts, rows=6000, span_ms=6000, seed=11):
    """A seeded emit_measurements topic, row i to partition i % parts
    (pre-produced: the idle hint closes the windows)."""
    rng = np.random.default_rng(seed)
    ts = T0 + np.sort(rng.integers(0, span_ms, rows))
    kid = rng.integers(0, 5, rows)
    val = np.round(rng.normal(50, 10, rows), 3)
    broker.create_topic(name, partitions=parts)
    for p in range(parts):
        broker.produce_batched(name, p, [json.dumps({
            "occurred_at_ms": int(t), "sensor_name": f"s{k}", "reading": float(v),
        }).encode() for t, k, v in zip(ts[p::parts], kid[p::parts],
                                       val[p::parts])], records_per_batch=97)
    return ts, kid, val


def _window_rows(pkg, broker, topic, last_ws, **cfg):
    """from_topic → 1 s count/min/max/avg window in ``pkg`` until the
    window at ``last_ws`` emitted → {(ws, key): row}."""
    cfg.setdefault("source_idle_timeout_ms", 300)
    if pkg == "jax":
        ctx, Fn, col = jx.Context(JEngineConfig(**cfg)), JF, jx.col
    else:
        ctx = tt.Context(tt.EngineConfig(device="cpu", **cfg))
        Fn, col = TF, tt.col
    ds = ctx.from_topic(topic, SAMPLE, broker.bootstrap, "occurred_at_ms").window(
        ["sensor_name"],
        [Fn.count(col("reading")).alias("c"), Fn.min(col("reading")).alias("mn"),
         Fn.max(col("reading")).alias("mx"), Fn.avg(col("reading")).alias("a")],
        1000,
    )
    rows = {}
    deadline = time.time() + DEADLINE_S
    it = ds.stream()
    try:
        for b in it:
            for ws, k, c, mn, mx, a in zip(
                    np.asarray(b.column(WINDOW_START_COLUMN)).tolist(),
                    tcols.as_numpy(b.column("sensor_name")).tolist(),
                    np.asarray(b.column("c")).tolist(),
                    np.asarray(b.column("mn")).tolist(),
                    np.asarray(b.column("mx")).tolist(),
                    np.asarray(b.column("a")).tolist()):
                rows[(ws, k)] = (c, mn, mx, a)
            if max((w for w, _ in rows), default=0) >= last_ws or (
                    time.time() > deadline):
                break
    finally:
        it.close()
    return rows, ctx


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_from_topic_window_matches_the_jax_package(broker, parts):
    """The same seeded topic through both packages (one partition: the
    in-thread reader; several: the prefetch workers) → the same closable
    windows, equal to a numpy oracle."""
    ts, kid, val = _topic(broker, "temperature", parts)
    last_ws = (int(ts.max()) // 1000 - 1) * 1000
    got, ctx = _window_rows("torch", broker, "temperature", last_ws)
    want, _ = _window_rows("jax", broker, "temperature", last_ws)
    closable = {k for k in want if k[0] <= last_ws}
    assert {k for k in got if k[0] <= last_ws} == closable
    for k in closable:
        g, w = got[k], want[k]
        assert g[:3] == w[:3], k
        assert np.isclose(g[3], w[3], rtol=1e-5), k
        sel = ((ts // 1000) * 1000 == k[0]) & (kid == int(k[1][1:]))
        assert g[0] == int(sel.sum())
    src = ctx._last_physical
    while not isinstance(src, simple_execs.SourceExec):
        (src,) = src.children
    m = src.metrics()
    assert m["decode_fallback_rows"] == 0 and m["salvaged_rows"] == 0
    assert (src._pump is not None) == (parts > 1)


def test_projection_pushdown_into_json_reader(broker):
    """A wide topic feeding a 2-column window decodes only the columns it
    reads, in both packages' optimized plans."""
    from denormalized_tpu.logical import optimizer as jopt
    from denormalized_tpu.logical import plan as jlp
    from denormalized_tpu_torch.logical import optimizer as topt
    from denormalized_tpu_torch.logical import plan as tlp

    broker.create_topic("wide", partitions=1)
    sample = json.dumps({"occurred_at_ms": 1, "sensor_name": "a", "reading": 1.0,
                         **{f"extra{j}": 1.0 for j in range(10)}})

    def scan_names(ctx, lp, opt, Fn, col):
        ds = ctx.from_topic("wide", sample, broker.bootstrap, "occurred_at_ms")
        ds = ds.window(["sensor_name"], [Fn.sum(col("reading")).alias("s")], 1000)
        node = opt.optimize(lp.Sink(ds._plan, None))
        while not isinstance(node, lp.Scan):
            (node,) = node.children
        return sorted(node.source.schema.names)

    got = scan_names(tt.Context(tt.EngineConfig(device="cpu")), tlp, topt, TF,
                     tt.col)
    assert got == scan_names(jx.Context(), jlp, jopt, JF, jx.col)
    assert "extra0" not in got and {"sensor_name", "reading"} <= set(got)

    rows = [json.dumps({"occurred_at_ms": T0 + i * 20, "sensor_name": f"s{i % 3}",
                        "reading": float(i), **{f"extra{j}": j * 1.5
                                                for j in range(10)}}).encode()
            for i in range(200)]
    # a far-future row closes every window of the 200
    rows.append(json.dumps({"occurred_at_ms": T0 + 10_000, "sensor_name": "s0",
                            "reading": 0.0}).encode())
    broker.produce("wide", 0, rows, ts_ms=T0)
    res, _ = _window_rows("torch", broker, "wide", T0 + 3000)
    assert sum(r[0] for k, r in res.items() if k[0] < T0 + 4000) == 200


def test_poison_message_does_not_livelock(broker):
    """A malformed payload is skipped in place: its co-fetched good record
    arrives, nothing raises, later records flow, and the skip is counted."""
    broker.create_topic("poison", partitions=1)
    good = json.dumps({"occurred_at_ms": T0, "sensor_name": "a",
                       "reading": 1.0}).encode()
    broker.produce("poison", 0, [good, b'{"occurred_at_ms": oops}'], ts_ms=T0)
    for c in range(4):
        broker.produce("poison", 0, [json.dumps({
            "occurred_at_ms": T0 + 500 + c * 500, "sensor_name": "a",
            "reading": 2.0}).encode()], ts_ms=T0)
    reader = _reader(broker, "poison").partitions()[0]
    rows, readings = 0, []
    deadline = time.time() + DEADLINE_S
    while time.time() < deadline and rows < 5:
        b = reader.read(timeout_s=0.2)
        rows += b.num_rows
        readings.extend(np.asarray(b.column("reading")).tolist())
    assert rows == 5 and readings[0] == 1.0
    assert reader.salvaged_rows == 1 and reader.decode_fallback_rows() == 0
    reader.close()


def test_broker_outage_recovery():
    b1 = MockKafkaBroker().start()
    port = b1.port
    b1.create_topic("r", 1)
    b1.produce("r", 0, [json.dumps({"occurred_at_ms": T0, "sensor_name": "a",
                                    "reading": 1.0}).encode()], ts_ms=T0)
    reader = _reader(b1, "r").partitions()[0]
    assert reader.read(timeout_s=0.1).num_rows == 1
    b1.stop()
    time.sleep(0.1)
    assert all(reader.read(timeout_s=0.05).num_rows == 0 for _ in range(3))
    b2 = MockKafkaBroker(port=port).start()
    try:
        b2.create_topic("r", 1)
        b2.produce("r", 0, [json.dumps({
            "occurred_at_ms": T0 + 100 * i, "sensor_name": "a",
            "reading": float(i)}).encode() for i in (1, 2)], ts_ms=T0)
        got, deadline = 0, time.time() + DEADLINE_S
        while time.time() < deadline and got == 0:
            got += reader.read(timeout_s=0.2).num_rows
        assert got >= 1
    finally:
        reader.close()
        b2.stop()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_fetch_splitting_bounded_batches_exact_offsets(broker, native):
    """Fetches larger than max.batch.rows yield bounded batches whose
    offset snapshots land exactly on slice boundaries, on the native parse
    and the Python decode path (a childless struct the parser declines)."""
    broker.create_topic("split", partitions=1)
    total, cap = 1000, 256
    if native:
        msgs = [b'{"occurred_at_ms": %d, "sensor_name": "s", "reading": %d}'
                % (T0 + i, i) for i in range(total)]
        sample = SAMPLE
    else:
        msgs = [b'{"occurred_at_ms": %d, "meta": {"k%d": %d}}' % (T0 + i, i, i)
                for i in range(total)]
        sample = json.dumps({"occurred_at_ms": 1, "meta": {}})
    broker.produce_batched("split", 0, msgs)
    src = _reader(broker, "split", sample, **{"max.batch.rows": str(cap)})
    reader = src.partitions()[0]
    assert (reader._decoder._native is not None) == native
    sizes, snaps, ts = [], [], []
    deadline = time.time() + DEADLINE_S
    while sum(sizes) < total and time.time() < deadline:
        b = reader.read(timeout_s=0.1)
        if b.num_rows == 0:
            continue
        sizes.append(b.num_rows)
        snaps.append(reader.offset_snapshot()["offset"])
        ts.extend(np.asarray(b.column("occurred_at_ms")).tolist())
    assert sum(sizes) == total and max(sizes) <= cap
    assert snaps == list(np.cumsum(sizes))
    assert ts == [T0 + i for i in range(total)]
    assert (reader.decode_fallback_rows() == 0) == native
    reader2 = src.partitions()[0]
    reader2.offset_restore({"offset": snaps[1]})
    b = reader2.read(timeout_s=0.5)
    while b.num_rows == 0:
        b = reader2.read(timeout_s=0.5)
    assert int(b.column("occurred_at_ms")[0]) == T0 + sum(sizes[:2])
    reader.close()
    reader2.close()


def test_from_topic_positional_order_matches_reference(broker):
    """(topic, sample_json, bootstrap_servers, timestamp_column, group_id):
    a positional call binds the timestamp column, so windows anchor at the
    payload's event time, not the broker's wall clock."""
    broker.create_topic("postest", partitions=1)
    broker.produce("postest", 0, [json.dumps({
        "occurred_at_ms": T0 + i * 5, "sensor_name": "a", "reading": 1.0,
    }).encode() for i in range(500)])
    res, _ = _window_rows("torch", broker, "postest", T0)
    assert (T0, "a") in res


def test_sink_kafka_and_the_callback_sink(broker):
    """sink_kafka produces one JSON row a window row (read back from the
    broker); sink() hands the callback batches without internal columns
    and with strings materialized."""
    ts, kid, val = _topic(broker, "in", 1, rows=400, span_ms=4000)
    broker.create_topic("out", partitions=1)
    ctx = tt.Context(tt.EngineConfig(device="cpu", source_idle_timeout_ms=300))
    ds = ctx.from_topic("in", SAMPLE, broker.bootstrap, "occurred_at_ms").window(
        ["sensor_name"], [TF.count(tt.col("reading")).alias("c")], 1000)
    def run_sink():
        # a live job never ends: it runs until the broker goes away at
        # teardown, when its reader gives up reconnecting
        try:
            ds.sink_kafka(broker.bootstrap, "out")
        except SourceError:
            pass

    th = threading.Thread(target=run_sink, daemon=True)
    th.start()
    want = {(int(w), f"s{k}") for w, k in zip((ts // 1000) * 1000, kid)
            if w + 1000 <= ts.max()}
    deadline = time.time() + DEADLINE_S
    rows = []
    while time.time() < deadline:
        rows = [json.loads(pl) for _, _, pl in broker.log("out", 0)]
        if {(r["window_start_time"], r["sensor_name"]) for r in rows} >= want:
            break
        time.sleep(0.05)
    got = {(r["window_start_time"], r["sensor_name"]): r["c"] for r in rows}
    assert set(got) >= want
    for w, k in want:
        assert got[(w, k)] == int((((ts // 1000) * 1000 == w)
                                   & (kid == int(k[1:]))).sum())
    seen = []
    sink = simple_execs.CallbackSink(seen.append)
    col = tcols.StringColumn.from_objects(np.array(["x", None], dtype=object))
    sch = Schema([Field("s", DataType.STRING), Field(
        "_streaming_internal_metadata.canonical_timestamp",
        DataType.TIMESTAMP_MS)])
    sink.write(RecordBatch(sch, [col, np.array([1, 2])]))
    assert seen[0].schema.names == ["s"]
    assert seen[0].columns[0].dtype == object
    assert seen[0].to_pydict() == {"s": ["x", None]}


def test_print_sink_matches_the_jax_package():
    from denormalized_tpu.common.record_batch import RecordBatch as JRB
    from denormalized_tpu.common.schema import DataType as JD
    from denormalized_tpu.common.schema import Field as JFld
    from denormalized_tpu.common.schema import Schema as JS
    from denormalized_tpu.physical.simple_execs import PrintSink as JPrint

    vals = [np.array([1, 2]), np.array(["a", "b"], dtype=object),
            np.array([0.5, 1.5], dtype=np.float32), np.array([True, False])]
    names = ["i", "s", "f", "b"]
    types = ["INT64", "STRING", "FLOAT32", "BOOL"]
    out, jout = io.StringIO(), io.StringIO()
    simple_execs.PrintSink(out).write(RecordBatch(
        Schema([Field(n, DataType[t]) for n, t in zip(names, types)]),
        [vals[0], tcols.StringColumn.from_objects(vals[1]), *vals[2:]]))
    JPrint(jout).write(JRB(JS([JFld(n, JD[t]) for n, t in zip(names, types)]),
                           vals))
    assert out.getvalue() == jout.getvalue()
    assert json.loads(out.getvalue().splitlines()[1]) == {
        "i": 2, "s": "b", "f": 1.5, "b": False}


def test_collect_on_a_live_stream_raises_and_pyarrow_is_checked(broker,
                                                                 monkeypatch):
    broker.create_topic("live", partitions=1)
    ctx = tt.Context(tt.EngineConfig(device="cpu"))
    ds = ctx.from_topic("live", SAMPLE, broker.bootstrap, "occurred_at_ms")
    with pytest.raises(PlanError, match="unbounded"):
        ds.collect()
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(PlanError, match="pyarrow"):
        ds.sink(lambda b: None, as_pyarrow=True)


def test_closing_the_stream_stops_workers_and_closes_clients(broker):
    _topic(broker, "close", 4, rows=800, span_ms=800)
    ctx = tt.Context(tt.EngineConfig(device="cpu", source_idle_timeout_ms=300))
    ds = ctx.from_topic("close", SAMPLE, broker.bootstrap, "occurred_at_ms")
    it = ds.stream()
    assert next(it).num_rows > 0
    src = ctx._last_physical
    readers = [w.reader for w in src._pump.workers]
    assert all(r._client is not None for r in readers)
    it.close()
    assert all(r._client is None for r in readers)
    assert not any(w._thread.is_alive() for w in src._pump.workers)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("prefetch-")]


def test_kafka_fault_sites(broker):
    """kafka.produce raises with the plan's message; sink.write is absorbed
    by the sink's bounded retry; kafka.fetch with a transport marker takes
    the reader's reconnect path; decode escapes the reader."""
    broker.create_topic("f", partitions=1)
    c = KafkaClient(broker.bootstrap)
    faults.arm({"rules": [{"site": "kafka.produce", "kind": "error",
                           "times": 1, "message": "injected produce"}]})
    with pytest.raises(SourceError, match="injected produce"):
        c.produce("f", 0, [b"{}"])
    c.produce("f", 0, [b"{}"])
    c.close()
    faults.arm({"rules": [{"site": "sink.write", "kind": "error", "times": 1}]})
    w = KafkaSinkWriter(broker.bootstrap, "f")
    w.write(RecordBatch(Schema([Field("x", DataType.INT64)]), [np.array([7])]))
    assert w.sink_retries == 1 and broker.log("f", 0)[-1][2] == b'{"x": 7}'
    w.close()
    broker.produce("f", 0, [json.dumps({"occurred_at_ms": T0, "sensor_name": "a",
                                        "reading": 1.0}).encode()], ts_ms=T0)
    reader = _reader(broker, "f").partitions()[0]
    reader.offset_restore({"offset": 2})
    faults.arm({"rules": [
        {"site": "kafka.fetch", "kind": "error", "times": 1,
         "message": "recv: injected flap"},
        {"site": "decode", "kind": "error", "after": 0, "times": 1},
    ]})
    assert reader.read(timeout_s=0.05).num_rows == 0  # reconnecting
    with pytest.raises(SourceError, match="injected fault at decode"):
        reader.read(timeout_s=0.5)
    reader.close()


def test_chip_smoke_encoder_matches_the_mock_broker():
    """chip_smoke.py's numpy encoder writes the record batches the mock
    broker's own ``stage_batched`` writes for the same payloads, and the
    native parser reads each reading back as exactly micro / 1e6."""
    import chip_smoke as cs
    from denormalized_tpu_torch.formats.json_codec import JsonDecoder

    rng = np.random.default_rng(4)
    n = 1500
    ts = T0 + np.sort(rng.integers(0, 3000, n))
    kid = rng.integers(0, 12, n)
    micro = cs.micro_of(rng.normal(50, 30, n))
    micro[:3] = [-1_500_000, 0, 999_999]
    names = [f"sensor_{i}" for i in range(12)]
    pieces = cs.json_pieces(ts, kid, micro, names)
    got = cs.kafka_record_batches(pieces, n, 512, T0, base_offset=7)
    data, offs = cs._concat_pieces(pieces, n)
    payloads = [data[offs[i]:offs[i + 1]].tobytes() for i in range(n)]
    assert payloads[0].startswith(b'{"occurred_at_ms":') and \
        b'"reading":-1.500000}' in payloads[0]
    want = MockKafkaBroker.stage_batched(payloads, T0, 512, base_offset=7)
    assert [e for _, _, e in got] == [enc for _, _, _, enc in want if enc]
    entries = cs.staged_entries(got, T0)
    assert [e[0] for e in entries] == [e[0] for e in want]
    dec = JsonDecoder(cs.e2e_schema())
    for p in payloads:
        dec.push(p)
    b = dec.flush()
    assert np.asarray(b.column("reading")).tolist() == (micro / 1e6).tolist()
    assert np.asarray(b.column("occurred_at_ms")).tolist() == ts.tolist()
    assert tcols.as_numpy(b.column("sensor_name")).tolist() == \
        [names[k] for k in kid]
