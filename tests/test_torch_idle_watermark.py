"""Idle and per-partition watermarks of the port's live sources, against
the JAX package's: twins of tests/test_idle_watermark.py (the idle hint
closes a quiet topic's final windows and no window past the max seen; a
forwarded hint stays below open windows; the idle hint forces a deferred
partial_merge emission), tests/test_partition_queue_idle_race.py (the
reader-activity gate: enqueued backlog and known broker backlog are never
idle-excluded, the first-read hold is bounded, the idle hint waits for
reader-side quiet) and tests/test_partition_watermarks.py:110 and :167
(a catch-up skew drops no row; an empty partition does not stall)."""

import json
import threading
import time

import numpy as np
import pytest

import denormalized_tpu as jx
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JEngineConfig
from denormalized_tpu.common.record_batch import RecordBatch as JRB
from denormalized_tpu.common.schema import DataType as JD
from denormalized_tpu.common.schema import Field as JFld
from denormalized_tpu.common.schema import Schema as JS
from denormalized_tpu.physical import simple_execs as jse
from denormalized_tpu.sources.base import (
    attach_canonical_timestamp as j_attach,
)
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.physical import simple_execs as tse
from denormalized_tpu_torch.physical.base import WM_ANNOUNCE, WatermarkHint
from denormalized_tpu_torch.runtime import executor
from denormalized_tpu_torch.sources.base import (
    PartitionReader,
    Source,
    attach_canonical_timestamp,
    canonicalize_schema,
)
from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

T0 = 1_700_000_000_000
SAMPLE = json.dumps({"occurred_at_ms": 1, "sensor_name": "a", "reading": 0.5})
SCH = Schema([Field("occurred_at_ms", DataType.INT64, nullable=False),
              Field("v", DataType.FLOAT64)])
JSCH = JS([JFld("occurred_at_ms", JD.INT64, nullable=False),
           JFld("v", JD.FLOAT64)])


@pytest.fixture
def broker():
    b = MockKafkaBroker().start()
    yield b
    b.stop()


def _batch(ts0, n=64, step=1, pkg="torch"):
    ts = np.arange(ts0, ts0 + n * step, step, dtype=np.int64)
    if pkg == "jax":
        return j_attach(JRB(JSCH, [ts, np.zeros(n)]), "occurred_at_ms",
                        fallback_ms=ts0)
    return attach_canonical_timestamp(
        RecordBatch(SCH, [ts, np.zeros(n)]), "occurred_at_ms", fallback_ms=ts0)


# -- the tracker and the idle gate, against the JAX package's -------------


def _script(pkg, activity, timeout_ms, steps):
    """Feed one scripted sequence to a package's tracker → its hints."""
    mod = jse if pkg == "jax" else tse
    pwm = mod._PartitionWatermarks(2, timeout_ms, activity=activity)
    out = []
    for op, arg in steps:
        if op == "sleep":
            time.sleep(arg)
            continue
        h = pwm.observe(arg[0], _batch(arg[1], pkg=pkg)) if op == "observe" \
            else pwm.advance()
        out.append(None if h is None else (h.ts_ms, h.kind))
    return out


@pytest.mark.parametrize("case", ["known_backlog", "time_based", "first_read"])
def test_tracker_matches_the_jax_package(case):
    long_ago = time.monotonic() - 60.0
    if case == "known_backlog":
        # caught_up False holds the min with nothing enqueued and a stale
        # stamp; once the partition produces, the min starts at its rows
        state = {1: (False, long_ago, True, False)}

        def activity(i):
            return (False, time.monotonic(), True, True) if i == 0 \
                else state[1]

        steps = [("observe", (0, T0 + 10_000)), ("sleep", 0.25),
                 ("advance", None)]
        want = [None, None]
    elif case == "time_based":
        def activity(i):
            return (False, time.monotonic(), True, True) if i == 0 else (
                False, long_ago, True, True)

        steps = [("observe", (0, T0 + 10_000)), ("sleep", 0.15),
                 ("advance", None)]
        want = [None, (T0 + 10_000, "partition")]
    else:
        def activity(i):
            return (False, time.monotonic(), i == 0, True)

        steps = [("observe", (0, T0 + 10_000)), ("sleep", 0.3),
                 ("advance", None)]
        want = [None, (T0 + 10_000, "partition")]
    timeout = 50 if case == "first_read" else 100
    got = _script("torch", activity, timeout, steps)
    assert got == want
    if case == "known_backlog":
        state[1] = (False, time.monotonic(), True, True)
        pwm = tse._PartitionWatermarks(2, 100, activity=activity)
        assert pwm.observe(0, _batch(T0 + 10_000)) is None
        h = pwm.observe(1, _batch(T0))
        assert (h.ts_ms, h.kind) == (T0, "partition")
        state[1] = (False, long_ago, True, False)
    assert got == _script("jax", activity, timeout, steps)


def test_idle_hint_gated_on_reader_quiet():
    for mod in (tse, jse):
        quiet = {"v": False}
        idle = mod._IdleTracker(50, quiet=lambda: quiet["v"])
        idle.observe_rows(_batch(T0 + 10_000, pkg="jax" if mod is jse
                                 else "torch"))
        time.sleep(0.12)
        assert idle.maybe_hint() is None
        quiet["v"] = True
        h = idle.maybe_hint()
        assert h.ts_ms == T0 + 10_000 + 63 and h.kind == "idle"
        assert idle.maybe_hint() is None  # one hint an idle period


# -- the shared-queue race (scripted readers on the prefetch path) --------


class _ScriptedReader(PartitionReader):
    def __init__(self, batches, initial_delay_s=0.0):
        self._batches = list(batches)
        self._delay = initial_delay_s
        self._started = time.monotonic()

    def read(self, timeout_s=None):
        if self._delay and time.monotonic() - self._started < self._delay:
            time.sleep(min(timeout_s or 0.05, 0.05))
            return RecordBatch.empty(SCH)
        if self._batches:
            return self._batches.pop(0)
        time.sleep(timeout_s or 0.05)
        return attach_canonical_timestamp(
            RecordBatch.empty(SCH), "occurred_at_ms", fallback_ms=T0)


class _TwoPartSource(Source):
    name = "race"

    def __init__(self, factory):
        self._factory = factory
        self._schema = canonicalize_schema(SCH)

    @property
    def schema(self):
        return self._schema

    def partitions(self):
        return self._factory()

    @property
    def unbounded(self):
        return True


class _StalledReader(_ScriptedReader):
    """Returns its first batch at once, then spends ``stall_s`` inside the
    next read before it returns the rest: a reader that did not run (a
    loaded host, or a consumer holding the GIL) while its rows waited."""

    def __init__(self, batches, stall_s):
        super().__init__(batches)
        self._stall_s = stall_s
        self._reads = 0

    def read(self, timeout_s=None):
        self._reads += 1
        if self._reads == 2:
            time.sleep(self._stall_s)
        return super().read(timeout_s)


def _race(strip_activity: bool, stall_s: float | None = None):
    """Partition A bursts 20 batches over ~20 s of event time; B enqueues 5
    batches of OLDER event time ~80 ms later (or its first at once and the
    rest after a read that takes ``stall_s``); the consumer takes ~40 ms
    an item → (violations, B's rows seen)."""
    a = [_batch(T0 + 10_000 + i * 1000) for i in range(20)]
    b = [_batch(T0 + i * 50) for i in range(5)]
    b_reader = (_ScriptedReader(b, initial_delay_s=0.08) if stall_s is None
                else _StalledReader(b, stall_s))
    exec_ = tse.SourceExec(
        _TwoPartSource(lambda: [_ScriptedReader(a), b_reader]),
        idle_timeout_ms=300, partition_watermarks=True)
    if strip_activity:
        orig = exec_._partition_wm_tracker
        exec_._partition_wm_tracker = lambda n, activity=None: orig(n)
    max_hint, violations, saw_b = None, [], 0
    deadline = time.monotonic() + 10
    it = exec_.run()
    for item in it:
        if time.monotonic() > deadline:
            break
        if isinstance(item, WatermarkHint):
            if item.kind == "partition" and not item.is_announcement:
                max_hint = max(max_hint or 0, item.ts_ms)
            continue
        if isinstance(item, RecordBatch) and item.num_rows:
            bmin = int(np.min(item.column(CANONICAL_TIMESTAMP_COLUMN)))
            if bmin < T0 + 9_000:
                saw_b += item.num_rows
            if max_hint is not None and bmin < max_hint:
                violations.append((bmin, max_hint))
            time.sleep(0.04)
            if saw_b >= 5 * 64:
                break
    it.close()
    return violations, saw_b


def test_enqueued_backlog_never_idle_excluded():
    violations, saw_b = _race(strip_activity=False)
    assert saw_b == 5 * 64 and not violations


def test_stalled_reader_never_idle_excluded():
    """The port asks more than the JAX package here: a partition is idle
    only once its reader has itself seen the timeout's worth of nothing.
    B's reader spends 2 s (about 7 timeouts) inside one read after its
    first rows; judged by its stale enqueue stamp it would leave the min,
    A's rows would carry the watermark past B's and B's would come late."""
    violations, saw_b = _race(strip_activity=False, stall_s=2.0)
    assert saw_b == 5 * 64 and not violations


def test_detector_catches_consumer_side_idleness():
    violations, _ = _race(strip_activity=True)
    assert violations


# -- live topics through both packages -------------------------------------


def _produce_then_quiet(broker, topic, parts, rows_per_part=600):
    """Rows over ~2.4 s of event time, then silence."""
    broker.create_topic(topic, partitions=parts)
    for chunk in range(4):
        for p in range(parts):
            broker.produce(topic, p, [json.dumps({
                "occurred_at_ms": T0 + chunk * 600 + i * (600 // (rows_per_part // 4)),
                "sensor_name": f"s{i % 3}", "reading": 1.0,
            }).encode() for i in range(rows_per_part // 4)])


def _ctx(pkg, **cfg):
    if pkg == "jax":
        return jx.Context(JEngineConfig(**cfg)), JF, jx.col
    return tt.Context(tt.EngineConfig(device="cpu", **cfg)), TF, tt.col


def _counts(pkg, broker, topic, done, deadline_s=25, **cfg):
    ctx, Fn, col = _ctx(pkg, **cfg)
    ds = ctx.from_topic(topic, SAMPLE, broker.bootstrap, "occurred_at_ms") \
        .window(["sensor_name"], [Fn.count(col("reading")).alias("c")], 1000)
    got = {}
    it = ds.stream()
    deadline = time.time() + deadline_s
    try:
        for b in it:
            for ws, k, c in zip(np.asarray(b.column("window_start_time")).tolist(),
                                np.asarray(b.column("sensor_name")).tolist(),
                                np.asarray(b.column("c")).tolist()):
                got[(ws - T0, str(k))] = got.get((ws - T0, str(k)), 0) + c
            if done(got) or time.time() > deadline:
                break
    finally:
        it.close()
    return got, ctx


@pytest.mark.parametrize("parts", [1, 2])
def test_idle_timeout_closes_final_windows(broker, parts):
    """The idle hint closes the last complete window of a quiet topic and
    nothing past the max timestamp seen, in both packages."""
    _produce_then_quiet(broker, f"quiet{parts}", parts)
    res = {}
    for pkg in ("torch", "jax"):
        res[pkg], _ = _counts(pkg, broker, f"quiet{parts}",
                              lambda g: any(w == 1000 for w, _ in g),
                              source_idle_timeout_ms=400)
    starts = {w for w, _ in res["torch"]}
    assert 0 in starts and 1000 in starts and 2000 not in starts
    assert res["torch"] == res["jax"]


def _first_hint(broker, topic, pkg_cfg, kind=None):
    ctx, Fn, col = _ctx("torch", **pkg_cfg)
    ds = ctx.from_topic(topic, SAMPLE, broker.bootstrap, "occurred_at_ms") \
        .window(["sensor_name"], [Fn.count(col("reading")).alias("c")], 1000)
    root = executor.build_physical(lp.Sink(ds._plan, tse.CollectSink()), ctx)
    gen = root.run()
    starts, hint = set(), None
    deadline = time.time() + 20
    for item in gen:
        if isinstance(item, RecordBatch) and item.num_rows:
            starts |= {int(v) - T0 for v in item.column("window_start_time")}
        if isinstance(item, WatermarkHint) and item.ts_ms > WM_ANNOUNCE and (
                kind is None or item.kind == kind):
            hint = item.ts_ms
            break
        if time.time() > deadline:
            break
    gen.close()
    return starts, hint


def test_forwarded_hint_clamped_below_open_windows(broker):
    _produce_then_quiet(broker, "quiet_clamp", 2)
    starts, hint = _first_hint(broker, "quiet_clamp",
                               dict(source_idle_timeout_ms=400))
    assert hint is not None and hint < T0 + 2000
    assert all(T0 + s <= hint for s in starts)


def test_idle_hint_forces_deferred_emission(broker):
    _produce_then_quiet(broker, "quiet_defer", 2)
    starts, hint = _first_hint(
        broker, "quiet_defer",
        dict(source_idle_timeout_ms=400, device_strategy="partial_merge",
             emit_lag_ms=10_000), kind="idle")
    assert 0 in starts and 1000 in starts
    assert hint is not None and hint < T0 + 2000


def test_kafka_catchup_skew_no_drops(broker):
    """tests/test_partition_watermarks.py:110: partition 0's backlog is all
    there, partition 1 trails in event time; per-partition watermarks drop
    no row of the three closable windows."""
    broker.create_topic("skew", partitions=2)

    def mk(lo, hi):
        return [json.dumps({"occurred_at_ms": T0 + ms, "sensor_name": "x",
                            "reading": 1.0}).encode() for ms in range(lo, hi)]

    broker.produce_batched("skew", 0, mk(0, 4000))

    def slow_feed():
        for lo in range(0, 4000, 500):
            broker.produce_batched("skew", 1, mk(lo, lo + 500))
            time.sleep(0.15)

    th = threading.Thread(target=slow_feed, daemon=True)
    th.start()
    got, ctx = _counts("torch", broker, "skew", lambda g: all(
        g.get((w, "x")) == 2000 for w in range(0, 3000, 1000)),
        source_idle_timeout_ms=500)
    th.join(10)
    assert all(got.get((w, "x")) == 2000 for w in range(0, 3000, 1000)), got
    node = ctx._last_physical
    assert node.metrics()["late_rows"] == 0


def test_empty_partition_does_not_stall(broker):
    """tests/test_partition_watermarks.py:167: a partition that never
    produces leaves the min after the idle timeout."""
    broker.create_topic("halfquiet", partitions=2)

    def feed():
        for chunk in range(4):
            broker.produce("halfquiet", 0, [json.dumps({
                "occurred_at_ms": T0 + chunk * 800 + i, "sensor_name": "k",
                "reading": 1.0}).encode() for i in range(0, 800, 2)], ts_ms=T0)
            time.sleep(0.1)

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    got, _ = _counts("torch", broker, "halfquiet", lambda g: {0, 1000, 2000}
                     <= {w for w, _ in g}, source_idle_timeout_ms=400)
    th.join(10)
    assert {0, 1000, 2000} <= {w for w, _ in got}
    assert got[(0, "k")] == 500  # 400 rows of chunk 0, 100 of chunk 1


def test_unbounded_without_idle_keeps_legacy_semantics(broker):
    """'auto' turns partition watermarks on for a live source only with an
    idle timeout: without one no kind="partition" hint appears."""
    broker.create_topic("nohints", partitions=2)
    for p in range(2):
        broker.produce("nohints", p, [json.dumps({
            "occurred_at_ms": T0 + i, "sensor_name": "a", "reading": 1.0,
        }).encode() for i in range(50)])
    src = tse.SourceExec(tt.Context(tt.EngineConfig(device="cpu")).from_topic(
        "nohints", SAMPLE, broker.bootstrap, "occurred_at_ms")._plan.source)
    rows, kinds = 0, set()
    it = src.run()
    deadline = time.time() + 10
    for item in it:
        if isinstance(item, WatermarkHint):
            kinds.add(item.kind)
        elif isinstance(item, RecordBatch):
            rows += item.num_rows
        if rows >= 100 or time.time() > deadline:
            break
    it.close()
    assert rows == 100 and "partition" not in kinds
