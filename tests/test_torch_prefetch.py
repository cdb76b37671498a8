"""The port's prefetch engine (``denormalized_tpu_torch/runtime/
prefetch.py``) over its Kafka readers: twins of
tests/test_prefetch_pipeline.py (the native calls release the interpreter
lock; the prefetch path yields the rows, order and offsets of a serial
drive, and of the JAX package's; a restore mid-prefetch replays no row
twice; fetch coalescing and its exact split offsets) and of
tests/test_prefetch_supervisor.py (supervised restarts lose and replay no
row, the restart budget escalates and heals, a restarting partition is
never idle, stop() leaves no thread, get_live's liveness backstop, the
metrics on SourceExec), and the state tier's backpressure gate."""

import ctypes
import json
import threading
import time

import numpy as np
import pytest

from denormalized_tpu.physical.simple_execs import SourceExec as JSourceExec
from denormalized_tpu.sources.kafka import KafkaTopicBuilder as JBuilder
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.common.errors import SourceError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.physical.base import Marker, WatermarkHint
from denormalized_tpu_torch.physical.simple_execs import SourceExec
from denormalized_tpu_torch.runtime import faults
from denormalized_tpu_torch.runtime.prefetch import (
    PrefetchPump,
    PrefetchRestartExhausted,
)
from denormalized_tpu_torch.sources.kafka import KafkaClient, KafkaTopicBuilder
from denormalized_tpu_torch.state import tiering
from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

T0 = 1_700_000_000_000
SAMPLE = '{"ts": 1, "p": 1, "i": 1, "v": 1.0}'


@pytest.fixture
def broker():
    b = MockKafkaBroker().start()
    try:
        yield b
    finally:
        b.stop()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


def _produce_chunk(broker, topic, part, chunk_idx, rows):
    broker.produce_batched(topic, part, [json.dumps({
        "ts": T0 + (chunk_idx * rows + r) * 7, "p": part,
        "i": chunk_idx * rows + r, "v": float((chunk_idx * rows + r) % 13),
    }).encode() for r in range(rows)], ts_ms=T0)


def _source(broker, topic, builder=KafkaTopicBuilder, **opts):
    b = (builder(broker.bootstrap).with_topic(topic)
         .infer_schema_from_json(SAMPLE).with_timestamp_column("ts"))
    for k, v in opts.items():
        b = b.with_option(k, v)
    return b.build_reader()


def _fill(broker, topic, parts, rows_per_part, chunk=64):
    broker.create_topic(topic, partitions=parts)
    for p in range(parts):
        for base in range(0, rows_per_part, chunk):
            broker.produce_batched(topic, p, [
                json.dumps({"ts": T0 + i * 3, "p": p, "i": i, "v": 1.0}).encode()
                for i in range(base, min(base + chunk, rows_per_part))
            ], ts_ms=T0)


def _drain_rows(pump, total_rows, deadline_s=30.0):
    seen = {}
    for _idx, _snap, batch in pump.drain(
            total_rows=total_rows, deadline=time.monotonic() + deadline_s):
        seen.setdefault(int(batch.column("p")[0]), []).extend(
            int(v) for v in batch.column("i"))
    return seen


# -- the interpreter lock -------------------------------------------------


def test_native_libs_loaded_gil_releasing():
    """Every native library the workers call is a CDLL (the lock is
    released around each call); only the row assembler, which builds
    Python objects, holds it (a PyDLL)."""
    import sysconfig

    from denormalized_tpu_torch.native.build import load

    for name, flags in (("kafka_client", ("-lz",)), ("json_parser", ())):
        lib = load(name, flags)
        assert isinstance(lib, ctypes.CDLL) and not isinstance(lib, ctypes.PyDLL)
    asm = load("pyassemble", (f"-I{sysconfig.get_paths()['include']}",),
               pydll=True)
    assert isinstance(asm, ctypes.PyDLL)


def test_blocking_fetch_releases_gil(broker):
    """Two clients long-poll an empty topic at once: ~0.5 s each inside the
    native client, well under 1 s together."""
    broker.create_topic("gil", partitions=2)
    clients = [KafkaClient(broker.bootstrap) for _ in range(2)]
    try:
        for p, c in enumerate(clients):
            c.fetch("gil", p, 0, max_wait_ms=1)
        threads = [threading.Thread(target=lambda p=p: clients[p].fetch(
            "gil", p, 0, max_wait_ms=500)) for p in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert time.perf_counter() - t0 < 0.85
    finally:
        for c in clients:
            c.close()


# -- the prefetch path against a serial drive and the JAX package ---------

N_PARTS, CHUNK_ROWS, N_CHUNKS = 3, 200, 8
TOTAL = N_PARTS * CHUNK_ROWS * N_CHUNKS


def _drive(exec_, feeder):
    """Drain a SourceExec → (rows per partition, yielded offsets,
    watermark violations)."""
    per_part = {p: [] for p in range(N_PARTS)}
    hint_max, violations = None, []
    gen = exec_.run()
    deadline = time.monotonic() + 60
    for item in gen:
        assert time.monotonic() < deadline, "prefetch drain stalled"
        if isinstance(item, WatermarkHint) or type(item).__name__ == (
                "WatermarkHint"):
            if item.kind == "partition" and not item.is_announcement:
                hint_max = max(hint_max or 0, item.ts_ms)
            continue
        if item.__class__.__name__ == "RecordBatch" and item.num_rows:
            ts = np.asarray(item.column(CANONICAL_TIMESTAMP_COLUMN))
            if hint_max is not None and int(ts.min()) < hint_max:
                violations.append((int(ts.min()), hint_max))
            p = int(np.asarray(item.column("p"))[0])
            per_part[p].extend(np.asarray(item.column("i")).tolist())
            if sum(len(v) for v in per_part.values()) >= TOTAL:
                next(gen)  # run the post-yield offset bookkeeping
                break
    yielded = sorted((dict(s) for s in exec_._yielded_offsets),
                     key=lambda s: s["partition"])
    gen.close()
    feeder.join(30)
    return per_part, yielded, violations


def test_staggered_prefetch_matches_serial_and_the_jax_package(broker):
    """Partitions with staggered broker latency through the prefetch
    path: rows, per-partition order and final offsets equal a serial
    drive and the JAX package's prefetch path; no partition hint runs
    ahead of rows still being yielded."""
    out = {}
    for pkg, (Exec, builder) in {"torch": (SourceExec, KafkaTopicBuilder),
                                 "jax": (JSourceExec, JBuilder)}.items():
        topic = f"stag_{pkg}"
        broker.create_topic(topic, partitions=N_PARTS)
        for p in range(N_PARTS):
            broker.fetch_delay_s[(topic, p)] = 0.005 * (p + 1)

        def feed(topic=topic):
            for j in range(N_CHUNKS):
                for p in range(N_PARTS):
                    _produce_chunk(broker, topic, p, j, CHUNK_ROWS)
                time.sleep(0.015)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        exec_ = Exec(_source(broker, topic, builder), idle_timeout_ms=400,
                     partition_watermarks=True)
        out[pkg] = _drive(exec_, feeder)
    per_part, yielded, violations = out["torch"]
    for p in range(N_PARTS):
        assert per_part[p] == list(range(CHUNK_ROWS * N_CHUNKS))
    assert yielded == [{"partition": p, "offset": CHUNK_ROWS * N_CHUNKS}
                       for p in range(N_PARTS)]
    assert not violations
    assert out["torch"][:2] == out["jax"][:2]


def test_restore_mid_prefetch_replays_no_row_twice(broker):
    """A restore from a barrier's offsets, with batches buffered past it
    when the stream died, yields exactly the complement of what was
    consumed before the barrier."""
    topic, n_rows = "restore", 3000
    broker.create_topic(topic, partitions=2)
    for p in range(2):
        _produce_chunk(broker, topic, p, 0, n_rows)
        broker.fetch_delay_s[(topic, p)] = 0.002 * (p + 1)
    src = _source(broker, topic, **{"max.batch.rows": "256",
                                    "fetch.coalesce.rows": "0"})
    exec_ = SourceExec(src, partition_watermarks=False)
    calls = [0]

    def barrier_poll():
        calls[0] += 1
        return calls[0] // 5 if calls[0] % 5 == 0 else None

    exec_._barrier_poll = barrier_poll
    seen = {0: [], 1: []}
    snap_at, seen_at = None, None
    gen = exec_.run()
    deadline = time.monotonic() + 60
    for item in gen:
        assert time.monotonic() < deadline
        if isinstance(item, Marker):
            snap_at = [dict(s) for s in exec_._yielded_offsets]
            seen_at = {p: len(v) for p, v in seen.items()}
        elif isinstance(item, RecordBatch) and item.num_rows:
            seen[int(item.column("p")[0])].extend(
                np.asarray(item.column("i")).tolist())
            if snap_at is not None and sum(map(len, seen.values())) >= 3500:
                break
    gen.close()
    assert snap_at is not None
    readers = {r._partition: r for r in src.partitions()}
    for s in snap_at:
        readers[s["partition"]].offset_restore(s)
    for p, r in readers.items():
        got = seen[p][: seen_at[p]]
        deadline = time.monotonic() + 30
        while len(got) < n_rows:
            assert time.monotonic() < deadline
            b = r.read(timeout_s=0.05)
            if b.num_rows:
                got.extend(np.asarray(b.column("i")).tolist())
        assert got == list(range(n_rows)), p
        r.close()


def _drain_counting(reader, n):
    rows, batches = [], 0
    deadline = time.monotonic() + 30
    while len(rows) < n:
        assert time.monotonic() < deadline
        b = reader.read(timeout_s=0.05)
        if b.num_rows:
            rows.extend(np.asarray(b.column("i")).tolist())
            batches += 1
    return rows, batches


def test_fetch_coalescing_combines_small_fetches(broker):
    broker.create_topic("coal", partitions=1)
    n = 600
    broker.produce_batched("coal", 0, [json.dumps(
        {"ts": T0 + i, "p": 0, "i": i, "v": 1.0}).encode() for i in range(n)],
        ts_ms=T0, records_per_batch=4)
    broker.fetch_max_bytes_clamp = 256
    (r0,) = _source(broker, "coal", **{"fetch.coalesce.rows": "0"}).partitions()
    rows0, batches0 = _drain_counting(r0, n)
    (r1,) = _source(broker, "coal", **{"fetch.coalesce.rows": "512"}).partitions()
    rows1, batches1 = _drain_counting(r1, n)
    assert rows0 == rows1 == list(range(n))
    assert r1.offset_snapshot()["offset"] == n and r1.caught_up() is True
    assert batches1 * 3 <= batches0


def test_coalescing_preserves_split_offsets(broker):
    broker.create_topic("coalsplit", partitions=1)
    n = 900
    broker.produce_batched("coalsplit", 0, [json.dumps(
        {"ts": T0 + i, "p": 0, "i": i, "v": 1.0}).encode() for i in range(n)],
        ts_ms=T0, records_per_batch=64)
    broker.fetch_max_bytes_clamp = 3000
    (reader,) = _source(broker, "coalsplit", **{
        "fetch.coalesce.rows": "4096", "max.batch.rows": "128"}).partitions()
    rows = []
    deadline = time.monotonic() + 30
    while len(rows) < n:
        assert time.monotonic() < deadline
        b = reader.read(timeout_s=0.05)
        if not b.num_rows:
            continue
        assert b.num_rows <= 128
        rows.extend(np.asarray(b.column("i")).tolist())
        assert reader.offset_snapshot()["offset"] == len(rows)
    assert rows == list(range(n))


# -- the supervisor ---------------------------------------------------------


def test_worker_crash_recovers_no_lost_no_replayed_rows(broker):
    parts, rows = 2, 1500
    _fill(broker, "sup", parts, rows)
    src = _source(broker, "sup", **{"max.batch.rows": 128,
                                    "fetch.coalesce.rows": 0})
    faults.arm({"rules": [
        {"site": "kafka.fetch", "kind": "error", "times": 1,
         "message": "injected worker crash A"},
        {"site": "kafka.fetch", "kind": "error", "after": 2, "times": 1,
         "message": "injected worker crash B"},
    ]})
    pump = PrefetchPump(src.partitions(),
                        reader_factories=src.partition_factories(),
                        restart_budget=5).start()
    try:
        seen = _drain_rows(pump, parts * rows)
    finally:
        assert pump.stop(join_timeout_s=5.0) == []
    for p in range(parts):
        assert seen[p] == list(range(rows))
    stats = pump.restart_stats()
    assert 1 <= stats["restarts"] <= 2 and stats["last_errors"], stats


def test_decode_fault_restarts_the_worker(broker):
    """A decode-site fault escapes the reader after its fetch advanced;
    the supervisor reseeks the rebuilt reader to the last enqueued
    snapshot, so no row is lost."""
    _fill(broker, "dec", 1, 700)
    src = _source(broker, "dec", **{"max.batch.rows": 128})
    faults.arm({"rules": [{"site": "decode", "kind": "error",
                           "times": 1}]})
    pump = PrefetchPump(src.partitions(),
                        reader_factories=src.partition_factories()).start()
    try:
        seen = _drain_rows(pump, 700)
    finally:
        pump.stop(join_timeout_s=5.0)
    assert seen[0] == list(range(700))
    assert pump.restart_stats()["restarts"] == 1


def test_restart_budget_exhausted_escalates_structured_failure(broker):
    _fill(broker, "dead", 1, 200)
    src = _source(broker, "dead")
    faults.arm({"rules": [{"site": "kafka.fetch", "kind": "error",
                           "message": "injected permanent failure"}]})
    pump = PrefetchPump(src.partitions(),
                        reader_factories=src.partition_factories(),
                        restart_budget=2).start()
    try:
        with pytest.raises(PrefetchRestartExhausted) as ei:
            for _ in pump.drain(total_rows=200, deadline=time.monotonic() + 20):
                pass
        assert ei.value.partition == 0 and ei.value.attempts == 2
        assert "injected permanent failure" in str(ei.value.last_error)
    finally:
        pump.stop(join_timeout_s=5.0)


def test_without_factories_crash_surfaces_verbatim(broker):
    _fill(broker, "nofac", 1, 100)
    src = _source(broker, "nofac")
    faults.arm({"rules": [{"site": "kafka.fetch", "kind": "error", "times": 1,
                           "message": "injected crash (unsupervised)"}]})
    pump = PrefetchPump(src.partitions()).start()
    try:
        with pytest.raises(SourceError, match="unsupervised"):
            for _ in pump.drain(total_rows=100, deadline=time.monotonic() + 20):
                pass
    finally:
        pump.stop(join_timeout_s=5.0)
    with pytest.raises(ValueError, match="0 reader factories"):
        PrefetchPump(src.partitions(), reader_factories=[])


def test_restart_budget_heals_after_crash_free_interval(broker):
    _fill(broker, "heal", 1, 400)
    src = _source(broker, "heal")
    faults.arm({"rules": [
        {"site": "kafka.fetch", "kind": "error", "times": 1,
         "message": "injected hiccup one"},
        {"site": "kafka.fetch", "kind": "error", "after": 15, "times": 1,
         "message": "injected hiccup two"},
    ]})
    pump = PrefetchPump(src.partitions(),
                        reader_factories=src.partition_factories(),
                        restart_budget=1, global_restart_budget=1,
                        restart_heal_s=0.3).start()
    try:
        assert _drain_rows(pump, 400)[0] == list(range(400))
        deadline = time.monotonic() + 10
        while pump.workers[0].restarts < 2:
            assert time.monotonic() < deadline, pump.restart_stats()
            time.sleep(0.05)
    finally:
        faults.disarm()
        pump.stop(join_timeout_s=5.0)


def test_restarting_partition_never_judged_idle(broker):
    _fill(broker, "idlepin", 1, 500)
    src = _source(broker, "idlepin")
    faults.arm({"rules": [{"site": "kafka.fetch", "kind": "error",
                           "message": "injected permanent-ish failure"}]})
    pump = PrefetchPump(src.partitions(),
                        reader_factories=src.partition_factories(),
                        restart_budget=50, global_restart_budget=50).start()
    try:
        deadline = time.monotonic() + 5
        saw = False
        while time.monotonic() < deadline:
            w = pump.workers[0]
            if w.restarts >= 1:
                saw = True
                assert w.activity()[3] is False
                assert not w.reader_quiet() and not pump.quiet()
                if w.restarts >= 3:
                    break
            time.sleep(0.02)
        assert saw
    finally:
        faults.disarm()
        pump.stop(join_timeout_s=5.0)


def test_stop_joins_workers_and_drains_queue(broker):
    _fill(broker, "stopt", 2, 300)
    before = {t.name for t in threading.enumerate()}
    pump = PrefetchPump(_source(broker, "stopt").partitions()).start()
    time.sleep(0.5)
    assert pump.stop(join_timeout_s=5.0) == []
    leaked = {n for n in {t.name for t in threading.enumerate()} - before
              if n.startswith("prefetch-")}
    assert not leaked and pump._q.qsize() == 0


def test_supervisor_metrics_visible_in_source_exec(broker):
    parts, rows = 2, 600
    _fill(broker, "supm", parts, rows)
    src = _source(broker, "supm", **{"max.batch.rows": 64,
                                     "fetch.coalesce.rows": 0})
    faults.arm({"rules": [{"site": "kafka.fetch", "kind": "error", "after": 1,
                           "times": 1, "message": "injected worker crash"}]})
    exec_ = SourceExec(src, idle_timeout_ms=200)
    n = 0
    it = exec_.run()
    deadline = time.monotonic() + 30
    for item in it:
        assert time.monotonic() < deadline
        if isinstance(item, RecordBatch):
            n += item.num_rows
        if n >= parts * rows:
            break
    it.close()
    m = exec_.metrics()
    assert m["rows_out"] == parts * rows
    assert m["prefetch_restarts"] == 1
    assert m["prefetch_restarted_partitions"] == 1 and m["prefetch_last_errors"]
    assert m["batch_rows_max"] <= 64 and m["decode_fallback_rows"] == 0


def test_get_live_liveness_backstop():
    pump = PrefetchPump([object()], queue_budget=4)
    w = pump.workers[0]
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    w._thread = t
    with pytest.raises(SourceError, match="without an end-of-stream"):
        pump.get_live(timeout_s=0.2)
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, daemon=True)
    t.start()
    w._thread = t
    try:
        threading.Thread(target=lambda: (time.sleep(0.35), pump._q.put(
            (0, {"pos": 1}, None, 0.0))), daemon=True).start()
        assert pump.get_live(timeout_s=0.15) == (0, {"pos": 1}, None)
    finally:
        stop.set()


def test_backpressure_gate_pauses_the_workers(broker):
    """While a holder engages the state tier's gate each worker pauses a
    bounded slice before a read; released, it reads at full speed."""
    _fill(broker, "bp", 1, 64)
    assert tiering.backpressure_pause() is False
    holder = (1, "node")
    assert tiering._gate_set(holder, True) is True
    try:
        assert tiering.pressure_engaged() is True
        t = time.perf_counter()
        assert tiering.backpressure_pause(0.05) is True
        assert time.perf_counter() - t >= 0.04
        pump = PrefetchPump(_source(broker, "bp").partitions()).start()
        try:
            assert _drain_rows(pump, 64)[0] == list(range(64))
        finally:
            pump.stop(join_timeout_s=5.0)
    finally:
        tiering._gate_set(holder, False)
    assert tiering.pressure_engaged() is False
