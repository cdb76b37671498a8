"""The port's pipeline doctor (``denormalized_tpu_torch/obs/doctor``) held
against the JAX package's on the same seeded input.

Twins of ``tests/test_doctor.py`` and the doctor half of
``tests/test_statewatch.py``:

- the plan snapshot has the JAX package's node ids, labels, parents and
  children; ``rank()`` on fixed inputs gives identical output; in a job
  with a throttled UDF both packages name the same top suspect;
- lineage over the port's mock broker with 2 partitions samples the same
  (source, partition, offset, event time) records, with the same hop node
  ids, in both packages; session emissions close chains;
- ``statedoc`` gives the same verdicts for the same state sequence, with a
  state budget and with a spilling cold tier;
- ``explain(analyze=True)`` prints the ranked report;
- the HTTP surface (``/healthz``, ``/queries``, ``/queries/<id>/plan``,
  ``/state``, ``/lineage``, the profiler) live during a job, scrapes
  racing teardown never 5xx, a setup failure stops started exporters,
  the doctor's opt-out;
- no tensor on an exporter thread: while a window job runs, ``/metrics``
  and ``/queries/<id>/state`` are scraped from other threads, and a guard
  on the ring's tensors fails the test if any thread but the query's
  touches them.

HTTP servers bind 127.0.0.1:0.  Everything compared across packages is a
count, an id or host arithmetic by the same code, so it is compared
exactly.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.obs.doctor import attribution as jattr
from denormalized_tpu.obs.doctor import statedoc as jstatedoc
from denormalized_tpu.obs.statewatch import StateWatch as JWatch
from denormalized_tpu.physical import simple_execs as jse
from denormalized_tpu.sources.kafka import KafkaTopicBuilder as JBuilder
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.obs.doctor import attribution as tattr
from denormalized_tpu_torch.obs.doctor import get_query
from denormalized_tpu_torch.obs.doctor import statedoc as tstatedoc
from denormalized_tpu_torch.obs.statewatch import StateWatch as TWatch
from denormalized_tpu_torch.physical import simple_execs as tse
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec
from denormalized_tpu_torch.sources.kafka import KafkaTopicBuilder as TBuilder
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state.checkpoint import walk
from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

T0 = 1_700_000_000_000

PKG = {
    "jax": dict(mod=jt, F=JF, se=jse, Schema=JSchema, Field=JField,
                DT=JType, Batch=JBatch, Source=JSource, Builder=JBuilder,
                ctx=lambda **kw: jt.Context(JConfig(**kw))),
    "torch": dict(mod=tt, F=TF, se=tse, Schema=TSchema, Field=TField,
                  DT=TType, Batch=TBatch, Source=TSource, Builder=TBuilder,
                  ctx=lambda **kw: tt.Context(
                      tt.EngineConfig(device="cpu", **kw))),
}


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


def _window_ds(a, ctx, **src):
    col, F = a["mod"].col, a["F"]
    return ctx.from_source(_source(a, **src)).window(
        [col("sensor_name")], [F.count(col("reading")).alias("count")], 1000)


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


# -- the plan and the attribution ------------------------------------------


def test_plan_snapshot_equals_the_jax_package():
    shapes = []
    for name in ("jax", "torch"):
        a = PKG[name]
        a["se"]._SOURCE_SERIES_ORDINALS.clear()
        ctx = a["ctx"]()
        ds = _window_ds(a, ctx).filter(a["mod"].col("count") > 0)
        ds.collect()
        snap = ctx._last_doctor.snapshot()
        assert snap["state"] == "finished"
        shapes.append([
            (n["node_id"], n["label"], n["parent"], n["children"],
             n["rows_in"], n["batches"])
            for n in snap["nodes"]
        ])
        assert snap["attribution"]["bottleneck"] in {
            n["node_id"] for n in snap["nodes"]
        }
    assert shapes[1] == shapes[0]


RANK_CASES = [
    ([{"node_id": "0_Sink", "label": "sink", "children": ["1_Win"],
       "busy_ms": 5.0, "input_wait_ms": 100.0},
      {"node_id": "1_Win", "label": "win", "children": ["2_Src"],
       "busy_ms": 40.0, "input_wait_ms": 55.0},
      {"node_id": "2_Src", "label": "src", "children": [],
       "busy_ms": 0.0, "input_wait_ms": 0.0}], 110.0),
    ([{"node_id": "0_J", "label": "join", "children": ["1_W", "3_W"],
       "busy_ms": 12.5, "input_wait_ms": 80.0},
      {"node_id": "1_W", "label": "w", "children": ["2_S"],
       "busy_ms": 30.0, "input_wait_ms": 10.0},
      {"node_id": "2_S", "label": "s", "children": [],
       "busy_ms": 2.0, "input_wait_ms": 0.0},
      {"node_id": "3_W", "label": "w", "children": ["4_S"],
       "busy_ms": 45.0, "input_wait_ms": 20.0},
      {"node_id": "4_S", "label": "s", "children": [],
       "busy_ms": 0.0, "input_wait_ms": 0.0}], 100.0),
    ([], 1.0),
]


@pytest.mark.parametrize("case", range(len(RANK_CASES)))
def test_rank_equals_the_jax_package(case):
    nodes, wall = RANK_CASES[case]
    got = tattr.rank([dict(n) for n in nodes], wall_ms=wall)
    assert got == jattr.rank([dict(n) for n in nodes], wall_ms=wall)
    assert tattr.ATTRIBUTION_RULE == jattr.ATTRIBUTION_RULE
    if case == 0:
        by_id = {r["node_id"]: r for r in got}
        assert by_id["2_Src"]["attributed_wait_ms"] == pytest.approx(55.0)
        assert [r["node_id"] for r in got] == ["2_Src", "1_Win", "0_Sink"]


def test_throttled_udf_named_top_suspect_in_both_packages():
    tops = []
    for name in ("jax", "torch"):
        a = PKG[name]
        col, F = a["mod"].col, a["F"]

        def throttle(vals):
            # 80 ms x 16 batches: decisively above the rest of the plan,
            # the window's work under a loaded host included
            time.sleep(0.08)
            return vals

        slow = F.udf(throttle, a["DT"].FLOAT64, "throttle")
        ctx = a["ctx"]()
        (ctx.from_source(_source(a, n_batches=16))
         .with_column("reading", slow(col("reading")))
         .window([col("sensor_name")],
                 [F.count(col("reading")).alias("count")], 1000)
         .collect())
        snap = ctx._last_doctor.snapshot()
        top = snap["attribution"]["suspects"][0]
        assert "ProjectExec" in top["node_id"], snap["attribution"]
        assert top["busy_ms"] >= 1000.0
        tops.append(top["node_id"])
    assert tops[0] == tops[1]


def test_explain_analyze_prints_the_ranked_report(capsys):
    a = PKG["torch"]
    ctx = a["ctx"]()
    text = _window_ds(a, ctx).explain_analyze()
    assert "bottleneck:" in text and "rule:" in text
    assert "StreamingWindowExec" in text and "rows/s=" in text
    assert text in capsys.readouterr().out
    _window_ds(a, ctx).explain(analyze=True)
    out = capsys.readouterr().out
    assert "== bottleneck report ==" in out and "bottleneck:" in out


# -- lineage ---------------------------------------------------------------

SAMPLE = json.dumps({"occurred_at_ms": 1, "sensor_name": "a", "reading": 1.0})


def _topic(broker, name, parts=2, rows=3000, span_ms=8000, seed=7):
    rng = np.random.default_rng(seed)
    ts = T0 + np.sort(rng.integers(0, span_ms, rows))
    kid = rng.integers(0, 5, rows)
    broker.create_topic(name, partitions=parts)
    for p in range(parts):
        broker.produce_batched(name, p, [json.dumps({
            "occurred_at_ms": int(t), "sensor_name": f"s{k}",
            "reading": float(k),
        }).encode() for t, k in zip(ts[p::parts], kid[p::parts])],
            records_per_batch=97)
    return ts


def _lineage(name, broker, topic, last_ws):
    a = PKG[name]
    a["se"]._SOURCE_SERIES_ORDINALS.clear()
    ctx = a["ctx"](source_idle_timeout_ms=300, lineage_sample_every=97,
                   lineage_max_samples=100_000)
    reader = (a["Builder"](broker.bootstrap).with_topic(topic)
              .infer_schema_from_json(SAMPLE)
              .with_timestamp_column("occurred_at_ms")
              .with_option("max.batch.rows", 256)
              .with_option("fetch.coalesce.rows", 0)
              .build_reader())
    col, F = a["mod"].col, a["F"]
    ds = ctx.from_source(reader, name=topic).window(
        ["sensor_name"], [F.count(col("reading")).alias("c")], 1000)
    deadline = time.time() + 30
    it = ds.stream()
    try:
        for b in it:
            ws = np.asarray(b.column("window_start_time"))
            if (len(ws) and int(ws.max()) >= last_ws) or (
                    time.time() > deadline):
                break
    finally:
        it.close()
    chains = ctx._last_doctor.lineage.chains()
    horizon = last_ws + 1000
    return sorted(
        (c["source"], c["partition"], json.dumps(c["offset"], sort_keys=True),
         c["event_time_ms"], tuple(sorted({h["node_id"] for h in c["hops"]})))
        for c in chains if c["event_time_ms"] < horizon
    ), chains


def test_lineage_over_two_partitions_equals_the_jax_package():
    broker = MockKafkaBroker().start()
    try:
        ts = _topic(broker, "lineage_t")
        last_ws = (int(ts.max()) // 1000 - 1) * 1000
        got, chains = _lineage("torch", broker, "lineage_t", last_ws)
        want, _ = _lineage("jax", broker, "lineage_t", last_ws)
    finally:
        broker.stop()
    assert got == want
    assert {g[1] for g in got} == {0, 1} and len(got) >= 20
    done = [c for c in chains if c["emissions"]]
    assert done
    for c in done:
        e = c["emissions"][0]
        assert e["window_start_ms"] <= c["event_time_ms"] < e["window_end_ms"]
        assert "StreamingWindowExec" in e["node_id"]


def test_lineage_session_chain_and_trace_flows(tmp_path):
    a = PKG["torch"]
    col, F = a["mod"].col, a["F"]
    path = tmp_path / "trace.json"
    ctx = a["ctx"](lineage_sample_every=150, trace_path=str(path))
    ctx.from_source(_source(a)).session_window(
        [col("sensor_name")], [F.count(col("reading")).alias("c")], 300,
    ).collect()
    done = [c for c in ctx._last_doctor.lineage.chains() if c["emissions"]]
    assert done
    for c in done:
        e = c["emissions"][0]
        assert "SessionWindowExec" in e["node_id"]
        assert e["window_start_ms"] <= c["event_time_ms"] < e["window_end_ms"]
    flows = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") in ("s", "t", "f")]
    assert flows and all(e["name"] == "lineage" for e in flows)


# -- statedoc --------------------------------------------------------------


class _FakeOp:
    """A stateful operator whose state_info() walks a fixed sequence."""

    def __init__(self, watch_cls, nid, infos, samples):
        self.nid = nid
        self._infos = infos
        self._i = 0
        self._sw = watch_cls("f")
        for t, v in samples:
            self._sw.record_sample(v, t=t)

    def state_info(self):
        return dict(self._infos[min(self._i, len(self._infos) - 1)])

    def _state_watch_views(self):
        return []


def _verdict_sequence(statedoc, watch_cls, budget):
    now = 1_000_000.0
    grow = [{"op": "session", "state_bytes": 10_000 + 2_000 * k,
             "live_keys": 10 + k, "retention_unit_ms": 300,
             "oldest_event_lag_ms": 100 * k} for k in range(6)]
    leak = [{"op": "window", "state_bytes": 4096, "live_keys": 3,
             "retention_unit_ms": 1000, "oldest_event_lag_ms": 3000 * k}
            for k in range(6)]
    spill = [{"op": "join", "state_bytes": 50_000, "live_keys": 40,
              "spilled_bytes": 9000 * k,
              "spill": {"recent_spill_blocks": 2 * k,
                        "recent_reload_blocks": 3 * k}}
             for k in range(6)]
    out = []
    for step in range(6):
        nodes = []
        for nid, infos, slope in (("1_S", grow, 2000.0), ("2_W", leak, 0.0),
                                  ("3_J", spill, 0.0)):
            samples = [(now + t, infos[0]["state_bytes"] + slope * t)
                       for t in range(step + 1)]
            op = _FakeOp(watch_cls, nid, infos, samples)
            op._i = step
            info = op.state_info()
            node = {"node_id": nid, "label": "Fake", **info}
            fc = op._sw.forecast()
            if fc is not None:
                node["forecast"] = fc
            nodes.append(node)
        out.append(statedoc.verdicts(nodes, budget))
    return out


@pytest.mark.parametrize("budget", [None, 40_000])
def test_statedoc_verdicts_equal_the_jax_package(budget):
    got = _verdict_sequence(tstatedoc, TWatch, budget)
    want = _verdict_sequence(jstatedoc, JWatch, budget)
    assert got == want
    kinds = {v["kind"] for step in got for v in step}
    assert {"retention-leak", "spill-thrashing"} <= kinds
    assert "unbounded-session-growth" in kinds
    if budget is not None:
        assert "state-budget-pressure" in kinds
    assert tstatedoc.rules_text() == jstatedoc.rules_text()


def _budget_job(name, tmp_path):
    a = PKG[name]
    col, F = a["mod"].col, a["F"]
    ctx = a["ctx"](state_budget_bytes=20_000,
                   state_backend_path=str(tmp_path / name))
    rng = np.random.default_rng(9)
    schema = a["Schema"]([
        a["Field"]("occurred_at_ms", a["DT"].INT64, nullable=False),
        a["Field"]("sensor_name", a["DT"].STRING, nullable=False),
        a["Field"]("reading", a["DT"].FLOAT64),
    ])
    batches = []
    for b in range(16):
        ts = np.sort(T0 + b * 1000 + rng.integers(0, 300, 400))
        names = np.array([f"k{i}" for i in rng.integers(0, 400, 400)],
                         dtype=object)
        batches.append(a["Batch"](schema, [ts, names,
                                           rng.normal(50, 5, 400)]))
    src = a["Source"].from_batches(batches, timestamp_column="occurred_at_ms")
    ctx.from_source(src).session_window(
        [col("sensor_name")], [F.count(col("reading")).alias("c")], 5000,
    ).collect()
    st = ctx._last_doctor.state_snapshot()
    nodes = [n for n in st["nodes"] if "spill" in n]
    return nodes, st


def test_statedoc_over_a_spilling_cold_tier_equals_the_jax_package(tmp_path):
    """The same budgeted session job spills in both packages: the frozen
    /state nodes carry the same spill accounting and the verdicts the
    same kinds."""
    from denormalized_tpu.state.lsm import (
        close_global_state_backend as jclose,
    )
    from denormalized_tpu_torch.state.lsm import close_global_state_backend

    try:
        got, st_t = _budget_job("torch", tmp_path)
    finally:
        close_global_state_backend()
    try:
        want, st_j = _budget_job("jax", tmp_path)
    finally:
        jclose()
    assert got and want

    def spill_view(nodes):
        return [(n["node_id"], n["spilled_bytes"], n["spilled_keys"],
                 n["spill"]["spill_blocks_total"],
                 n["spill"]["reload_blocks_total"])
                for n in nodes]

    assert spill_view(got) == spill_view(want)
    assert got[0]["spill"]["spill_blocks_total"] >= 1
    assert [v["kind"] for v in st_t["verdicts"]] == [
        v["kind"] for v in st_j["verdicts"]]


# -- the HTTP surface ------------------------------------------------------


def test_endpoints_live_during_a_job():
    a = PKG["torch"]
    ctx = a["ctx"](prometheus_port=0, lineage_sample_every=100)
    it = _window_ds(a, ctx, n_batches=12).stream()
    try:
        next(it)
        base = f"http://127.0.0.1:{ctx._last_exporters.prometheus.port}"
        status, ctype, body = _get(f"{base}/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        queries = json.loads(_get(f"{base}/queries")[2])["queries"]
        qid = [q for q in queries if q["state"] == "running"][0]["query_id"]
        plan = json.loads(_get(f"{base}/queries/{qid}/plan")[2])
        ids = {n["node_id"] for n in plan["nodes"]}
        assert any("StreamingWindowExec" in n for n in ids)
        assert plan["attribution"]["bottleneck"] in ids
        state = json.loads(_get(f"{base}/queries/{qid}/state")[2])
        (win,) = [n for n in state["nodes"] if n["op"] == "window"]
        assert win["device_state_bytes"] > 0 and win["sketches"]
        lineage = json.loads(_get(f"{base}/queries/{qid}/lineage")[2])
        assert lineage["sample_every"] == 100
        status, _, body = _get(f"{base}/queries/{qid}/profile/start?hz=200")
        assert json.loads(body)["profiling"] is True
        for _ in range(4):
            next(it, None)
        stopped = json.loads(_get(f"{base}/queries/{qid}/profile/stop")[2])
        assert stopped["profiling"] is False
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/queries/nope/plan")
        assert ei.value.code == 404
    finally:
        for _ in it:
            pass
    handle = ctx._last_doctor
    assert get_query(handle.query_id) is handle
    assert handle.root is None and handle.snapshot()["state"] == "finished"
    assert handle.start_profiler() is None


def test_scrapes_racing_teardown_never_5xx():
    a = PKG["torch"]
    ctx = a["ctx"](prometheus_port=0, lineage_sample_every=100)
    it = _window_ds(a, ctx, n_batches=20).stream()
    next(it)
    base = f"http://127.0.0.1:{ctx._last_exporters.prometheus.port}"
    qid = json.loads(_get(f"{base}/queries")[2])["queries"][0]["query_id"]
    paths = ["/metrics", "/healthz", "/queries", f"/queries/{qid}/plan",
             f"/queries/{qid}/state", f"/queries/{qid}/lineage"]
    bad: list = []
    down = threading.Event()

    def hammer(path):
        while not down.is_set():
            try:
                if _get(base + path, timeout=5)[0] >= 500:
                    bad.append(path)
            except urllib.error.HTTPError as e:
                if e.code >= 500:
                    bad.append((path, e.code))
            except (urllib.error.URLError, ConnectionError, OSError):
                down.set()

    threads = [threading.Thread(target=hammer, args=(p,), daemon=True)
               for p in paths]
    for t in threads:
        t.start()
    for _ in it:
        pass
    down.wait(timeout=30)
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_setup_failure_stops_started_exporters():
    a = PKG["torch"]
    ctx = a["ctx"](prometheus_port=0, lineage_sample_every=-1)
    with pytest.raises(ValueError, match="lineage_sample_every"):
        _window_ds(a, ctx).collect()
    port = ctx._last_exporters.prometheus.port
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _get(f"http://127.0.0.1:{port}/healthz", timeout=2)
    ctx2 = a["ctx"](prometheus_port=0, lineage_sample_every=-1)
    with pytest.raises(ValueError, match="lineage_sample_every"):
        next(_window_ds(a, ctx2).stream())


def test_doctor_disabled_opt_out():
    a = PKG["torch"]
    ctx = a["ctx"](doctor_enabled=False)
    assert _window_ds(a, ctx).collect().num_rows > 0
    assert ctx._last_doctor is None
    text = _window_ds(a, ctx).explain_analyze(print_output=False)
    assert "StreamingWindowExec" in text and "bottleneck:" not in text


# -- no tensor on an exporter thread ---------------------------------------


class _RingGuard(torch.Tensor):
    """A ring tensor that records every torch call made on it from a
    thread other than ``owner``."""

    owner: int = 0
    own_calls: int = 0
    foreign: list = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if threading.get_ident() == cls.owner:
            cls.own_calls += 1
        else:
            cls.foreign.append(
                (threading.current_thread().name, getattr(func, "__name__",
                                                          str(func))))
        return super().__torch_function__(func, types, args, kwargs or {})


def test_exporter_threads_never_touch_a_ring_tensor():
    a = PKG["torch"]
    ctx = a["ctx"](prometheus_port=0, metrics_jsonl_interval_s=0.01)
    it = _window_ds(a, ctx, n_batches=30).stream()
    first = next(it)
    assert first.num_rows
    (win,) = [op for op in walk(ctx._last_physical)
              if isinstance(op, StreamingWindowExec)]
    _RingGuard.owner = threading.get_ident()
    _RingGuard.own_calls = 0
    _RingGuard.foreign = []
    backend = win.backend
    backend._state = {k: v.as_subclass(_RingGuard)
                      for k, v in backend._state.items()}
    base = f"http://127.0.0.1:{ctx._last_exporters.prometheus.port}"
    qid = ctx._last_doctor.query_id
    scraped = {"metrics": 0, "state": 0}
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                _get(f"{base}/metrics")
                scraped["metrics"] += 1
                st = json.loads(_get(f"{base}/queries/{qid}/state")[2])
                assert st["nodes"]
                scraped["state"] += 1
            except (urllib.error.URLError, ConnectionError, OSError):
                return

    threads = [threading.Thread(target=scrape, name=f"scraper{i}",
                                daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    try:
        for _ in it:
            time.sleep(0.01)  # leave the scrapers room between batches
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert scraped["metrics"] >= 2 and scraped["state"] >= 2, scraped
    # the guard is live: the query's own thread did touch the ring
    assert _RingGuard.own_calls > 0
    assert _RingGuard.foreign == [], _RingGuard.foreign[:5]
    info = win.state_info()
    assert info["device_state_bytes"] == sum(
        t.nbytes for t in backend._state.values())


def test_state_scrapes_never_read_a_running_query_s_interner(monkeypatch):
    """The operator thread grows the native key table without a lock, so
    the doctor's /state must name hot keys from the names that thread
    cached, never from the interner (a read racing the table's growth
    reads freed memory or another key's value).  Scraped while a window
    interns thousands of new string keys a batch."""
    from denormalized_tpu_torch.ops import interner as ti

    a = PKG["torch"]
    owner = threading.get_ident()
    foreign: list = []

    def guard(fn):
        def run(self, *args, **kw):
            if threading.get_ident() != owner:
                foreign.append((threading.current_thread().name,
                                fn.__name__))
            return fn(self, *args, **kw)
        return run

    for cls, name in ((ti.ColumnInterner, "_sync_native_values"),
                      (ti.ColumnInterner, "intern_array"),
                      (ti.GroupInterner, "keys_of"),
                      (ti.GroupInterner, "intern")):
        monkeypatch.setattr(cls, name, guard(getattr(cls, name)))
    schema = a["Schema"]([
        a["Field"]("occurred_at_ms", a["DT"].INT64, nullable=False),
        a["Field"]("sensor_name", a["DT"].STRING, nullable=False),
        a["Field"]("reading", a["DT"].FLOAT64),
    ])
    rng = np.random.default_rng(3)
    batches, sent = [], set()
    for b in range(24):
        ts = np.sort(T0 + b * 400 + rng.integers(0, 400, 4000))
        # a hot key on every batch, and 3,000 keys never seen before
        names = np.array(["hot"] * 1000 + [f"k{b}_{i}" for i in range(3000)],
                         dtype=object)
        sent.update(names.tolist())
        batches.append(a["Batch"](schema, [ts, names,
                                           rng.normal(50.0, 10.0, 4000)]))
    ctx = a["ctx"](prometheus_port=0)
    col, F = a["mod"].col, a["F"]
    it = ctx.from_source(
        a["Source"].from_batches(batches, timestamp_column="occurred_at_ms")
    ).window([col("sensor_name")], [F.count(col("reading")).alias("count")],
             1000).stream()
    rows = [next(it)]
    base = f"http://127.0.0.1:{ctx._last_exporters.prometheus.port}"
    qid = ctx._last_doctor.query_id
    hot_seen: list = []
    scrapes = [0]
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                st = json.loads(_get(f"{base}/queries/{qid}/state")[2])
            except (urllib.error.URLError, ConnectionError, OSError):
                return
            for n in st["nodes"]:
                for sk in n.get("sketches", {}).values():
                    hot_seen.extend(h["key"] for h in sk["hot_keys"])
            scrapes[0] += 1

    threads = [threading.Thread(target=scrape, name=f"scraper{i}",
                                daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    try:
        for b in it:
            rows.append(b)
            # a scrape completes between every two emissions
            seen, deadline = scrapes[0], time.monotonic() + 10
            while scrapes[0] == seen and time.monotonic() < deadline:
                time.sleep(0.002)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert scrapes[0] >= len(rows) - 1, (scrapes, len(rows))
    assert foreign == [], foreign[:5]
    assert "hot" in hot_seen, hot_seen[:8]
    (win,) = [op for op in walk(ctx._last_physical)
              if isinstance(op, StreamingWindowExec)]
    assert win._interner._col_interners[0]._native_active
    keys = [k for b in rows for k in b.column("sensor_name").tolist()]
    assert set(keys) <= sent
    final = ctx._last_doctor.state_snapshot()
    (node,) = [n for n in final["nodes"] if n.get("sketches")]
    assert node["sketches"]["all"]["hot_keys"][0]["key"] == "hot"