"""The port's observability layer (``denormalized_tpu_torch/obs``) held
against the JAX package's on the same seeded input.

Twins of ``tests/test_obs.py``, ``tests/test_obs_integration.py`` and
``tests/test_readers_edges.py``:

- the catalog equals the JAX package's (names, kinds, help, buckets);
- the registry's semantics (re-binding, buckets and quantiles, the
  catalog check, ``gauge_fn`` re-binding, the falsy allocation-free null
  path), each instrument's snapshot equal to the JAX package's for the
  same observations;
- the exporters: the Prometheus text of two registries fed the same
  observations is byte-equal; a JSONL stream written by one package reads
  through the other's ``obs/readers.py`` with equal fits; the span
  recorder's Chrome trace; a job's trace holds the JAX package's span
  names;
- the registry after a run: config 1 (``auto``), config 3
  (``partial_merge``), config 4 (two windows joined), a session job, a
  UDAF job and a ``run_queries`` job run in each package; the sets of
  (instrument, labels) are equal, every counter exactly, and every
  histogram's count.

Tolerance: every compared number is a count or a host value computed by
the same code in both packages, so the comparisons are exact.
"""

from __future__ import annotations

import gc
import json
import sys
import time
import urllib.request

import numpy as np
import pytest

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu import obs as jobs
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.api.udaf import Accumulator as JAcc
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.obs import jsonl as jjsonl
from denormalized_tpu.obs import prometheus as jprom
from denormalized_tpu.obs import readers as jreaders
from denormalized_tpu.obs.catalog import INSTRUMENTS as J_INSTRUMENTS
from denormalized_tpu.physical import simple_execs as jse
from denormalized_tpu.runtime.multi_query import run_queries as jrun
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch import obs as tobs
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.api.udaf import Accumulator as TAcc
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.obs import catalog as tcatalog
from denormalized_tpu_torch.obs import jsonl as tjsonl
from denormalized_tpu_torch.obs import prometheus as tprom
from denormalized_tpu_torch.obs import readers as treaders
from denormalized_tpu_torch.obs.registry import NULL, MetricsRegistry
from denormalized_tpu_torch.obs.spans import SpanRecorder
from denormalized_tpu_torch.physical import simple_execs as tse
from denormalized_tpu_torch.runtime.multi_query import run_queries as trun
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000


class _MeanJ(JAcc):
    def __init__(self):
        self.s, self.n = 0.0, 0

    def update(self, values):
        v = np.asarray(values, dtype=np.float64)
        self.s += float(v.sum())
        self.n += len(v)

    def merge(self, states):
        self.s += states[0]
        self.n += states[1]

    def state(self):
        return [self.s, self.n]

    def evaluate(self):
        return self.s / self.n if self.n else None


class _MeanT(TAcc):
    def __init__(self):
        self.s, self.n = 0.0, 0

    def update(self, values):
        v = np.asarray(values, dtype=np.float64)
        self.s += float(v.sum())
        self.n += len(v)

    def merge(self, states):
        self.s += states[0]
        self.n += states[1]

    def state(self):
        return [self.s, self.n]

    def evaluate(self):
        return self.s / self.n if self.n else None


PKG = {
    "jax": dict(mod=jt, F=JF, obs=jobs, se=jse, run=jrun, Schema=JSchema,
                Field=JField, DT=JType, Batch=JBatch, Source=JSource,
                Mean=_MeanJ, ctx=lambda **kw: jt.Context(JConfig(**kw))),
    "torch": dict(mod=tt, F=TF, obs=tobs, se=tse, run=trun, Schema=TSchema,
                  Field=TField, DT=TType, Batch=TBatch, Source=TSource,
                  Mean=_MeanT,
                  ctx=lambda **kw: tt.Context(
                      tt.EngineConfig(device="cpu", **kw))),
}


def _raw(seed=0, n_batches=8, rows=200, n_keys=5, ms_per_batch=400):
    rng = np.random.default_rng(seed)
    keys = np.array([f"sensor_{i}" for i in range(n_keys)], object)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * ms_per_batch
                     + rng.integers(0, ms_per_batch, rows))
        out.append((ts, keys[rng.integers(0, n_keys, rows)],
                    rng.normal(50.0, 10.0, rows)))
    return out


def _source(a, raw):
    schema = a["Schema"]([
        a["Field"]("occurred_at_ms", a["DT"].INT64, nullable=False),
        a["Field"]("sensor_name", a["DT"].STRING, nullable=False),
        a["Field"]("reading", a["DT"].FLOAT64),
    ])
    return a["Source"].from_batches(
        [a["Batch"](schema, [ts, ks, vs]) for ts, ks, vs in raw],
        timestamp_column="occurred_at_ms",
    )


# -- the catalog -----------------------------------------------------------


def test_catalog_equals_the_jax_package():
    """Names, kinds, help strings and bucket layouts: the catalog is
    data, copied whole (the cluster declarations included)."""
    assert tcatalog.INSTRUMENTS == J_INSTRUMENTS
    from denormalized_tpu.obs.catalog import declaration as jdecl

    for name in J_INSTRUMENTS:
        assert tcatalog.declaration(name) == jdecl(name), name
    assert tobs.INSTRUMENTS is tcatalog.INSTRUMENTS


# -- instruments -----------------------------------------------------------


def test_counter_gauge_semantics():
    reg = MetricsRegistry(enabled=True)
    c = reg.counter("dnz_op_rows_in_total", op="t")
    c.add(3)
    c.add()
    assert c.value == 4
    g = reg.gauge("dnz_watermark_lag_ms", op="t")
    g.set(17.5)
    assert g.value == 17.5
    assert reg.counter("dnz_op_rows_in_total", op="t") is c
    assert reg.counter("dnz_op_rows_in_total", op="u") is not c


def test_histogram_snapshot_equals_the_jax_package():
    """Buckets, exact min/max, interpolated quantiles: the same
    observations give the JAX package's snapshot."""
    vals = np.random.default_rng(3).lognormal(0.0, 2.0, 500).tolist()
    snaps = []
    for name in ("jax", "torch"):
        reg = PKG[name]["obs"].MetricsRegistry(enabled=True)
        h = reg.histogram("dnz_op_batch_ms", op="t")
        for v in vals + [0.1, 100.0]:
            h.observe(v)
        snaps.append(reg.snapshot())
        if name == "torch":
            assert h.count == 502 and sum(h.counts) == 502
            assert h.quantile(1.0) == h.vmax
            assert h.quantile(0.0) >= h.vmin
    assert snaps[0] == snaps[1]
    assert tcatalog.exp_bounds(
        {"start": 0.05, "factor": 2.0, "count": 5}
    ) == [0.05, 0.1, 0.2, 0.4, 0.8]


def test_bind_validates_against_catalog():
    reg = MetricsRegistry(enabled=True)
    with pytest.raises(KeyError, match="not declared"):
        reg.counter("dnz_not_declared_total")
    with pytest.raises(TypeError, match="declared as a histogram"):
        reg.counter("dnz_op_batch_ms")


def test_gauge_fn_rebind_replaces_callback():
    reg = MetricsRegistry(enabled=True)
    g = reg.gauge_fn("dnz_decode_fallback_rows", lambda: 5, source="s")
    assert g.value == 5.0
    g2 = reg.gauge_fn("dnz_decode_fallback_rows", lambda: 9, source="s")
    assert g2 is g and g.value == 9.0
    reg.gauge_fn("dnz_decode_fallback_rows", lambda: 1 / 0, source="s")
    assert g.value == 0.0


def test_disabled_registry_hands_out_falsy_nulls():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("dnz_op_rows_in_total", op="x")
    h = reg.histogram("dnz_op_batch_ms", op="x")
    g = reg.gauge("dnz_watermark_lag_ms", op="x")
    f = reg.gauge_fn("dnz_decode_fallback_rows", lambda: 1, source="s")
    assert c is NULL and h is NULL and g is NULL and f is NULL
    assert not c
    c.add(5)
    h.observe(1.0)
    g.set(2.0)
    assert c.value == 0 and h.quantile(0.5) is None
    assert reg.instruments() == []
    assert tobs.disabled_registry().counter("dnz_op_rows_in_total") is NULL


def test_disabled_instrument_call_allocates_nothing():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("dnz_op_rows_in_total", op="x")
    h = reg.histogram("dnz_op_batch_ms", op="x")
    for _ in range(10):
        c.add(1)
        h.observe(2.0)
    gc.collect()
    before = sys.getallocatedblocks()
    for _ in range(5000):
        c.add(1)
        h.observe(2.0)
    after = sys.getallocatedblocks()
    assert after - before <= 2, f"disabled path allocated {after - before}"


# -- the exporters ---------------------------------------------------------


def _feed(reg):
    reg.counter("dnz_op_rows_in_total", op="w").add(12)
    h = reg.histogram("dnz_op_batch_ms", op="w")
    for v in (0.5, 5.0, 50.0, 0.049, 1e9):
        h.observe(v)
    reg.gauge("dnz_kafka_consumer_lag_rows", topic="t", partition="0").set(42)
    reg.gauge("dnz_watermark_lag_ms", op='we"ird\nname').set(1.25)
    reg.gauge_fn("dnz_state_bytes", lambda: 4096, node="1_Win")
    reg.histogram("dnz_emit_event_lag_ms", op="window")


def test_prometheus_text_is_byte_equal_to_the_jax_package():
    rj = jobs.MetricsRegistry(enabled=True)
    rt = MetricsRegistry(enabled=True)
    _feed(rj)
    _feed(rt)
    text = tprom.render(rt)
    assert text == jprom.render(rj)
    assert 'op="we\\"ird\\nname"' in text
    assert 'dnz_op_batch_ms_bucket{op="w",le="+Inf"} 5' in text
    for name, (kind, *_r) in J_INSTRUMENTS.items():
        assert f"# TYPE {name} {kind}" in text, name


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_jsonl_reads_across_packages(tmp_path, writer):
    """A JSONL stream written by one package reads through the other's
    readers: the same snapshots, merged histograms, counter timeline and
    least-squares fit."""
    wmod = tjsonl if writer == "torch" else jjsonl
    rmods = (treaders, jreaders)
    reg = PKG[writer]["obs"].MetricsRegistry(enabled=True)
    h = reg.histogram("dnz_emit_event_lag_ms", op="window")
    for v in (1.0, 2.0, 4.0, 80.0):
        h.observe(v)
    c = reg.counter("dnz_op_rows_in_total", op="window")
    state = [1000.0]
    reg.gauge_fn("dnz_state_bytes", lambda: state[0], node="1_W")
    path = tmp_path / "obs.jsonl"
    snap = wmod.JsonlSnapshotter(str(path), reg, interval_s=0.03).start()
    for _ in range(6):
        c.add(5)
        state[0] += 500.0
        time.sleep(0.04)
    snap.stop()
    got = []
    for r in rmods:
        snaps = r.read_stream(path)
        assert len(snaps) >= 3
        stats = snaps[-1]["metrics"]['dnz_emit_event_lag_ms{op="window"}']
        merged = r.merge_histogram([stats, stats])
        tl = r.counter_timeline(snaps, "dnz_op_rows_in_total")
        pts = [(s["t"], s["metrics"]['dnz_state_bytes{node="1_W"}'])
               for s in snaps]
        fit = r.linear_forecast(pts, budget=10_000.0)
        got.append((snaps, merged, tl, fit))
        assert stats["count"] == 4 and stats["max"] == 80.0
        assert merged["count"] == 8
        assert sum(e["delta"] for e in tl) == 30
        assert fit is not None and fit["slope_bytes_per_s"] > 0
    assert got[0] == got[1]


def test_readers_edges_equal_the_jax_package(tmp_path):
    """Twins of tests/test_readers_edges.py: disjoint bucket layouts are
    skipped whole, torn JSONL lines are dropped, and both packages'
    readers give the same answers."""

    def hist(bounds, values):
        counts = [0] * (len(bounds) + 1)
        for v in values:
            i = 0
            while i < len(bounds) and v > bounds[i]:
                i += 1
            counts[i] += 1
        return {"count": len(values), "sum": float(sum(values)),
                "min": min(values), "max": max(values), "bounds": bounds,
                "bucket_counts": counts}

    a = hist([1.0, 2.0, 4.0], [0.5, 1.5, 3.0, 3.5])
    b = hist([100.0, 200.0, 400.0], [150.0, 250.0])
    c = hist([1.0, 2.0, 4.0], [3.0, 8.0])
    line = lambda t, m: json.dumps(  # noqa: E731
        {"event": "obs", "t": t, "metrics": m})
    p = tmp_path / "obs.jsonl"
    p.write_text(line(1.0, {"a": 1}) + "\n" + line(2.0, {"a": 2})[:20]
                 + "\n" + line(3.0, {"a": 3}) + "\n" + '{"t": 4.0}\n'
                 + line(5.0, {"a": 5})[:30])
    out = []
    for r in (treaders, jreaders):
        m1 = r.merge_histogram([a, b])
        assert m1["count"] == a["count"] and m1["max"] == a["max"]
        assert r.merge_histogram([b, a])["count"] == b["count"]
        assert r.merge_histogram([a, c])["count"] == 6
        assert r.merge_histogram([]) is None
        q = r.quantile_from_buckets([1.0, 2.0], [0, 0, 5], 5, 0.5,
                                    vmin=10.0, vmax=20.0)
        assert 10.0 <= q <= 20.0
        snaps = r.read_stream(p)
        assert [s["t"] for s in snaps] == [1.0, 3.0]
        assert r.read_stream(tmp_path / "missing.jsonl") == []
        out.append((m1, q, snaps, r.last_stats(snaps, "a")))
    assert out[0] == out[1]


def test_span_recorder_ring_and_chrome_trace():
    rec = SpanRecorder(capacity=4)
    for i in range(6):
        rec.record(f"s{i}", time.perf_counter(), 0.001, {"i": i})
    assert [e[2] for e in rec.events()] == ["s2", "s3", "s4", "s5"]
    trace = rec.to_chrome_trace()
    assert set(trace) == {"traceEvents", "displayTimeUnit"}
    for ev in trace["traceEvents"]:
        assert ev["ph"] in ("X", "i") and ev["ts"] >= 0
    json.dumps(trace)


def test_span_records_error_status():
    from denormalized_tpu_torch.obs import spans as obs_spans
    from denormalized_tpu_torch.runtime import tracing

    rec = obs_spans.enable_span_recording(16)
    try:
        with pytest.raises(ValueError):
            with tracing.span("unit.test_span", partition=3):
                raise ValueError("boom")
        with tracing.span("unit.ok_span", partition=4):
            pass
    finally:
        obs_spans.disable_span_recording()
    by_name = {e[2]: e for e in rec.events()}
    assert by_name["unit.test_span"][6]["error"] == "ValueError"
    assert by_name["unit.test_span"][6]["partition"] == 3
    assert "error" not in (by_name["unit.ok_span"][6] or {})


def _job_trace(name, tmp_path, **cfg):
    a = PKG[name]
    path = tmp_path / f"{name}_trace.json"
    ctx = a["ctx"](trace_path=str(path), **cfg)
    ctx.from_source(_source(a, _raw())).window(
        [a["mod"].col("sensor_name")],
        [a["F"].count(a["mod"].col("reading")).alias("c")], 1000,
    ).collect()
    assert a["obs"].spans.recorder() is None  # the job uninstalled it
    return json.loads(path.read_text())


def test_job_trace_has_the_jax_package_span_names(tmp_path):
    names = []
    for name in ("jax", "torch"):
        trace = _job_trace(name, tmp_path)
        evs = trace["traceEvents"]
        assert evs and all(e["ph"] in ("X", "i", "s", "t", "f") for e in evs)
        names.append({e["name"] for e in evs})
    assert names[0] == names[1]
    assert "window.process_batch" in names[1]


def test_prometheus_endpoint_scraped_while_the_job_runs():
    a = PKG["torch"]
    ctx = a["ctx"](prometheus_port=0)
    it = ctx.from_source(_source(a, _raw(n_batches=12))).window(
        [tt.col("sensor_name")], [TF.count(tt.col("reading")).alias("c")],
        1000).stream()
    try:
        next(it)
        port = ctx._last_exporters.prometheus.port
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5
        ) as r:
            text = r.read().decode()
        assert r.status == 200
        assert 'dnz_op_rows_in_total{op="window"}' in text
    finally:
        for _ in it:
            pass


# -- the registry after a run ----------------------------------------------


def _job(name, kind):
    """Run one small job of ``kind`` in package ``name`` under a fresh
    registry → its snapshot."""
    a = PKG[name]
    col, F = a["mod"].col, a["F"]
    a["se"]._SOURCE_SERIES_ORDINALS.clear()
    reg = a["obs"].MetricsRegistry(enabled=True)
    prev = a["obs"].use_registry(reg)
    try:
        if kind == "config1":
            a["ctx"]().from_source(_source(a, _raw(n_keys=10))).window(
                [col("sensor_name")],
                [F.count(col("reading")).alias("c"),
                 F.min(col("reading")).alias("mn"),
                 F.max(col("reading")).alias("mx"),
                 F.avg(col("reading")).alias("av")], 1000).collect()
        elif kind == "config3":
            a["ctx"](device_strategy="partial_merge").from_source(
                _source(a, _raw(n_keys=3000, rows=2000, seed=4))).window(
                [col("sensor_name")],
                [F.count(col("reading")).alias("c"),
                 F.avg(col("reading")).alias("av")], 1000).collect()
        elif kind == "config4":
            ctx = a["ctx"]()

            def side(raw, src, agg):
                return ctx.from_source(_source(a, raw), name=src).window(
                    ["sensor_name"], [F.avg(col("reading")).alias(agg)],
                    1000)

            right = (side(_raw(seed=2), "bench_h", "avg_h")
                     .with_column_renamed("sensor_name", "hs")
                     .with_column_renamed("window_start_time", "hws")
                     .with_column_renamed("window_end_time", "hwe"))
            side(_raw(seed=1), "bench_t", "avg_t").join(
                right, "inner", ["sensor_name", "window_start_time"],
                ["hs", "hws"]).collect()
        elif kind == "session":
            a["ctx"]().from_source(_source(a, _raw())).session_window(
                [col("sensor_name")], [F.count(col("reading")).alias("c")],
                300).collect()
        elif kind == "udaf":
            mean = F.udaf(a["Mean"], a["DT"].FLOAT64, name="mean")
            a["ctx"]().from_source(_source(a, _raw())).window(
                [col("sensor_name")], [mean(col("reading")).alias("m")],
                1000).collect()
        elif kind == "run_queries":
            ctx = a["ctx"]()
            base = ctx.from_source(_source(a, _raw(n_batches=12)),
                                   name="mq_feed")
            qs = [(base.window(["sensor_name"],
                               [F.count(col("reading")).alias("c")],
                               L, S), lambda _b: None)
                  for L, S in ((2000, 1000), (3000, 1000), (4000, 2000))]
            rep = a["run"](ctx, qs)
            assert rep["shared_queries"] == 3
            assert len(rep["groups"][0]["query_ids"]) == 3
    finally:
        a["obs"].use_registry(prev)
    return reg.snapshot()


#: counters that must match exactly (the rest are compared too)
EXACT = ("dnz_op_rows_in_total", "dnz_op_rows_out_total",
         "dnz_windows_emitted_total", "dnz_late_rows_total")


def _hot_keys_by_node(snap):
    """The hot-key gauges refresh at most once a second from each
    operator's thread (in either package), so which keys, and for a join
    which side, hold a series depends on the run's wall time: the family
    is compared by node, without its ``key`` and ``side`` labels."""
    import re

    out = {}
    for k, v in snap.items():
        if k.startswith("dnz_state_hot_key_share"):
            k = re.sub(r'(key="[^"]*",|,side="(left|right)")', "", k)
        out[k] = v
    return out


@pytest.mark.parametrize("kind", ["config1", "config3", "config4",
                                  "session", "udaf", "run_queries"])
def test_registry_after_a_run_equals_the_jax_package(kind):
    sj = _hot_keys_by_node(_job("jax", kind))
    st = _hot_keys_by_node(_job("torch", kind))
    assert set(st) == set(sj), (
        f"only port: {sorted(set(st) - set(sj))}; "
        f"only JAX: {sorted(set(sj) - set(st))}"
    )
    seen = set()
    for series, vj in sj.items():
        vt = st[series]
        name = series.split("{", 1)[0]
        seen.add(name)
        if isinstance(vj, dict):
            assert vt["count"] == vj["count"], series
            assert vt["bounds"] == vj["bounds"], series
        elif name.endswith("_total"):
            assert vt == vj, series
    assert "dnz_op_rows_in_total" in seen
    if kind != "run_queries":
        assert "dnz_windows_emitted_total" in seen
    else:
        assert {"dnz_slice_rows_total", "dnz_slice_folds_total"} <= seen
