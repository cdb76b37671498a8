"""The port's state observatory (``denormalized_tpu_torch/obs/statewatch.py``)
held against the JAX package's on the same gids and the same jobs.

Twins of ``tests/test_statewatch.py``:

- the sketches: one StateWatch of each package fed the same gid stream
  (small batches, sampled batches beyond ``SKETCH_ROW_CAP``, decay steps)
  holds the same HyperLogLog registers, the same Space-Saving top keys,
  counts, error bounds and total, and the same summary;
- block sampling scales counts back to row units and rotates over a
  batch's tail; skew factor and hot keys; the falsy null watch and
  ``make_watch`` following the bound registry's enablement;
- the growth ring and ``linear_forecast``;
- a job's accounting: the window, session and UDAF operators'
  ``state_info()`` after the same run equals the JAX package's, as do
  their sketches' hot keys, the doctor's ``/state`` nodes and verdicts,
  and the per-node state gauges and hot-key series.

Tolerance: everything compared is host integer or float64 arithmetic by
the same code in both packages, so the comparisons are exact.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu import obs as jobs
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.obs import statewatch as jsw
from denormalized_tpu.obs.readers import linear_forecast as j_forecast
from denormalized_tpu.physical import simple_execs as jse
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu.state.checkpoint import walk as jwalk
from denormalized_tpu_torch import obs as tobs
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.obs import statewatch as tsw
from denormalized_tpu_torch.obs.readers import linear_forecast
from denormalized_tpu_torch.obs.registry import MetricsRegistry
from denormalized_tpu_torch.physical import simple_execs as tse
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state.checkpoint import walk as twalk

T0 = 1_700_000_000_000

PKG = {
    "jax": dict(mod=jt, F=JF, obs=jobs, se=jse, walk=jwalk, Schema=JSchema,
                Field=JField, DT=JType, Batch=JBatch, Source=JSource,
                ctx=lambda **kw: jt.Context(JConfig(**kw))),
    "torch": dict(mod=tt, F=TF, obs=tobs, se=tse, walk=twalk,
                  Schema=TSchema, Field=TField, DT=TType, Batch=TBatch,
                  Source=TSource,
                  ctx=lambda **kw: tt.Context(
                      tt.EngineConfig(device="cpu", **kw))),
}


def _summary(w):
    s = w.summary(live_keys=5000, resolve=lambda g: [f"k{int(x)}" for x in g])
    s.pop("sketch_update_ms_total")  # wall time, not state
    return s


# -- the sketches against the JAX package ----------------------------------


@pytest.mark.parametrize("decay", [0, jsw.JOIN_SKETCH_DECAY_ROWS])
def test_sketches_equal_the_jax_package(decay):
    """HLL registers and Space-Saving top keys, counts, error bounds and
    total equal the JAX package's for the same gids, across small
    batches, sampled batches and decay steps."""
    assert tsw.SKETCH_ROW_CAP == jsw.SKETCH_ROW_CAP
    assert tsw.JOIN_SKETCH_DECAY_ROWS == jsw.JOIN_SKETCH_DECAY_ROWS
    rng = np.random.default_rng(11)
    j = jsw.StateWatch("w", decay_every=decay)
    t = tsw.StateWatch("w", decay_every=decay)
    for i in range(40):
        n = (20_000, 3000, tsw.SKETCH_ROW_CAP + 600)[i % 3]
        g = np.where(rng.random(n) < 0.25, 7,
                     rng.zipf(1.3, n) % 5000).astype(np.int32)
        j.update(g)
        t.update(g)
    assert t.sketch.total == j.sketch.total
    for a, b in zip(j.sketch.top(64), t.sketch.top(64)):
        assert a.tolist() == b.tolist()
    assert np.array_equal(t.hll.registers, j.hll.registers)
    assert t.distinct_estimate() == j.distinct_estimate()
    assert t.update_batches == j.update_batches == 40
    assert _summary(t) == _summary(j)
    assert t.skew_factor(5000) == j.skew_factor(5000)


def test_block_sampling_scales_counts_back_to_row_units():
    sw = tsw.StateWatch("t")
    n = tsw.SKETCH_ROW_CAP * 6
    g = np.random.default_rng(3).integers(0, 2, size=n).astype(np.int64)
    sw.update(g)
    assert sw.sketch.total == n
    _gids, counts, _errs = sw.sketch.top(2)
    assert counts.sum() == pytest.approx(n, rel=0.25)
    for c in counts:
        assert c / n == pytest.approx(0.5, abs=0.1)
    one = tsw.StateWatch("t")
    m = tsw.SKETCH_ROW_CAP + 600
    one.update(np.zeros(m, dtype=np.int64))
    _g, c1, _e = one.sketch.top(1)
    assert 0.95 <= c1[0] / one.sketch.total <= 1.05


def test_block_sampling_rotation_covers_batch_tail():
    sw = tsw.StateWatch("t")
    n = tsw.SKETCH_ROW_CAP + 4000
    g = np.zeros(n, dtype=np.int64)
    g[-4000:] = 7
    for _ in range(20):
        sw.update(g)
    gids, counts, _ = sw.sketch.top(2)
    assert 7 in gids.tolist(), gids
    i = gids.tolist().index(7)
    assert counts[i] / sw.sketch.total == pytest.approx(4000 / n, rel=0.5)


def test_skew_factor_and_hot_keys():
    sw = tsw.StateWatch("t")
    g = np.concatenate([np.full(500, 3), np.arange(4, 54).repeat(10)])
    sw.update(g)
    hot = sw.hot_keys(3, resolve=lambda gids: [f"k{int(x)}" for x in gids])
    assert hot[0]["key"] == "k3"
    assert hot[0]["share"] == pytest.approx(0.5, abs=0.02)
    assert sw.skew_factor(live_keys=51) == pytest.approx(25.5, rel=0.1)
    info = {"live_keys": 200, "sides": {"left": {"live_keys": 100},
                                        "right": {"live_keys": 100}}}
    assert tsw.side_live_keys(info, "left") == 100
    assert tsw.side_live_keys(info, None) == 200
    assert tsw.arrays_nbytes(np.zeros(4, np.int64), None,
                             np.zeros(3, np.int32)) == 44


def test_null_watch_and_make_watch_follow_enablement():
    nw = tsw.NULL_WATCH
    assert not nw
    nw.update(np.arange(10))
    nw.record_sample(100)
    assert nw.forecast(10) is None
    assert nw.summary()["enabled"] is False
    assert nw.summary().keys() == jsw.NULL_WATCH.summary().keys()
    reg = MetricsRegistry(enabled=True)
    with tobs.bound_registry(reg):
        assert isinstance(tsw.make_watch("x"), tsw.StateWatch)
    with tobs.bound_registry(tobs.disabled_registry()):
        assert tsw.make_watch("x") is tsw.NULL_WATCH


# -- the growth ring -------------------------------------------------------


def test_linear_forecast_equals_the_jax_package():
    cases = [
        ([(10.0 + i, 1000.0 + 100 * i) for i in range(5)], 11_400),
        ([(0, 5), (1, 5), (2, 5)], 100),
        ([(0, 100), (1, 200)], 150),
        ([(0, 1)], None),
        ([], None),
        ([(t, 50.0 * t + (t % 3)) for t in range(30)], 5000),
    ]
    for pts, budget in cases:
        assert linear_forecast(pts, budget=budget) == j_forecast(
            pts, budget=budget
        )
    fc = linear_forecast(cases[0][0], budget=11_400)
    assert fc["slope_bytes_per_s"] == pytest.approx(100.0)
    assert fc["time_to_budget_s"] == pytest.approx(100.0, rel=0.01)


def test_growth_ring_samples_rate_limited_and_fit():
    sw = tsw.StateWatch("g")
    now = time.time()
    for k in range(10):
        sw.record_sample(1000 + 100 * k, t=now + k)
    sw.record_sample(5000, t=now + 9.05)  # inside the 0.2 s rate limit
    assert len(sw.samples) == 10
    fc = sw.forecast(budget_bytes=3000)
    assert fc["slope_bytes_per_s"] == pytest.approx(100.0)
    assert fc["time_to_budget_s"] == pytest.approx(11.0, rel=0.02)


# -- a job's accounting against the JAX package ----------------------------


def _source(a, seed=21, n_batches=12, rows=200, keys=7):
    rng = np.random.default_rng(seed)
    schema = a["Schema"]([
        a["Field"]("occurred_at_ms", a["DT"].INT64, nullable=False),
        a["Field"]("sensor_name", a["DT"].STRING, nullable=False),
        a["Field"]("reading", a["DT"].FLOAT64),
    ])
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 1000 + rng.integers(0, 300, rows))
        # key s0 carries about half the rows: a hot key for the sketch
        names = np.array(
            [f"s{i}" for i in np.where(rng.random(rows) < 0.5, 0,
                                       rng.integers(0, keys, rows))],
            dtype=object,
        )
        out.append(a["Batch"](schema, [ts, names, rng.normal(50, 5, rows)]))
    return a["Source"].from_batches(out, timestamp_column="occurred_at_ms")


def _stateful(a, root):
    return [op for op in a["walk"](root)
            if op.state_info() is not None]


def _run_and_watch(name, kind):
    a = PKG[name]
    col, F = a["mod"].col, a["F"]
    a["se"]._SOURCE_SERIES_ORDINALS.clear()
    reg = a["obs"].MetricsRegistry(enabled=True)
    prev = a["obs"].use_registry(reg)
    try:
        ctx = a["ctx"](emit_on_close=False)
        ds = ctx.from_source(_source(a))
        aggs = [F.count(col("reading")).alias("c")]
        if kind == "window":
            ds = ds.window([col("sensor_name")], aggs, 1000)
        elif kind == "session":
            ds = ds.session_window([col("sensor_name")], aggs, 300)
        elif kind == "udaf":
            ds = ds.window([col("sensor_name")],
                           [F.median(col("reading")).alias("m")], 1000)
        ds.collect()
        handle = ctx._last_doctor
        ops = _stateful(a, ctx._last_physical)
        infos = []
        for op in ops:
            info = dict(op.state_info())
            info.pop("adaptations", None)
            infos.append(info)
        sk = [
            (side, w.hot_keys(4, resolve=r), w.distinct_estimate(),
             w.sketch.total)
            for op in ops for side, w, r in op._state_watch_views()
        ]
        state = handle.state_snapshot()
        series = {k for k in reg.snapshot() if k.startswith("dnz_state_")}
    finally:
        a["obs"].use_registry(prev)
    return infos, sk, state, series


@pytest.mark.parametrize("kind", ["window", "session", "udaf"])
def test_job_accounting_equals_the_jax_package(kind):
    """After the same run, each stateful operator's state_info(), its
    sketches' hot keys and totals, the doctor's /state nodes and the
    bound dnz_state_* series equal the JAX package's."""
    ij, skj, stj, serj = _run_and_watch("jax", kind)
    it, skt, stt, sert = _run_and_watch("torch", kind)
    assert it == ij
    assert skt == skj and skt, skt
    assert skt[0][1][0]["key"] == "s0"  # the hot key, named
    assert sert == serj
    assert any(s.startswith("dnz_state_hot_key_share") for s in sert)

    def nodes(st):
        """The /state nodes without the growth fit (wall-clock samples)
        and the sketches' update time."""
        out = []
        for n in st["nodes"]:
            n = {k: v for k, v in n.items() if k != "forecast"}
            for s in n.get("sketches", {}).values():
                s.pop("sketch_update_ms_total", None)
            out.append(n)
        return out

    assert nodes(stt) == nodes(stj)
    assert [v["kind"] for v in stt["verdicts"]] == [
        v["kind"] for v in stj["verdicts"]
    ]
