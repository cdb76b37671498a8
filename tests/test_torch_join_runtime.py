"""What the join slice adds around the operator: watermark hints through
the window and the stateless operators, two window operators on two pump
threads, the refusal to checkpoint a join, and a kernel build that is safe
from two threads.  Twins hold the port against the JAX package on the same
items."""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.constants import CANONICAL_TIMESTAMP_COLUMN as JTS
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical.plan import WindowType as JWindowType
from denormalized_tpu.physical import base as jbase
from denormalized_tpu.physical.window_exec import StreamingWindowExec as JWindow
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN as TTS
from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical.plan import WindowType as TWindowType
from denormalized_tpu_torch.ops import cuda_build
from denormalized_tpu_torch.ops import host_partial as hp
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.ops.interner import GroupInterner
from denormalized_tpu_torch.physical import base as tbase
from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec
from denormalized_tpu_torch.physical.simple_execs import (
    CollectSink,
    FilterExec,
    ProjectExec,
    SinkExec,
)
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec as TWindow
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000
PKGS = ("jax", "torch")


def ns(pkg: str, strategy: str = "auto") -> SimpleNamespace:
    if pkg == "jax":
        return SimpleNamespace(
            Schema=JSchema, Field=JField, DT=JType, Batch=JBatch, TS=JTS,
            base=jbase, Window=JWindow, WT=JWindowType, F=JF, col=jt.col,
            Source=JSource, ctx=lambda **kw: jt.Context(JConfig(**kw)),
            window_kw={"device_strategy": "scatter"},
        )
    return SimpleNamespace(
        Schema=TSchema, Field=TField, DT=TType, Batch=TBatch, TS=TTS,
        base=tbase, Window=TWindow, WT=TWindowType, F=TF, col=tt.col,
        Source=TSource,
        ctx=lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)),
        window_kw={"device": "cpu", "device_strategy": strategy},
    )


def _stub(p, items):
    """An operator whose run() yields ``items`` (built per package)."""
    schema = p.Schema([
        p.Field(p.TS, p.DT.TIMESTAMP_MS, nullable=False),
        p.Field("k", p.DT.STRING, nullable=False),
        p.Field("v", p.DT.FLOAT64),
    ])

    class Stub(p.base.ExecOperator):
        def __init__(self):
            self.schema = schema

        def run(self):
            for it in items(p, schema):
                yield it

    return Stub()


def _batch(p, schema, t_lo, t_hi, n, seed):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(t_lo, t_hi, n)).astype(np.int64)
    keys = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)]
    return p.Batch(schema, [ts, keys, rng.integers(0, 100, n).astype(np.float64)])


def _hint_feed(p, schema):
    """Partition-mode hints: an announcement, a batch of window 10, a hint
    at 8,500 (floor window 8), a batch over windows 5-9 (5-7 are behind
    the watermark and late, 8-9 rebase first_open down), a hint closing
    windows 8-11, a batch of window 12, an idle hint at 20,000, EOS."""
    H = p.base.WatermarkHint
    yield H(p.base.WM_ANNOUNCE, kind="partition")
    yield _batch(p, schema, 10_000, 11_000, 64, 1)
    yield H(8_500, kind="partition")
    yield _batch(p, schema, 5_000, 10_000, 64, 2)
    yield H(12_000, kind="partition")
    yield _batch(p, schema, 12_000, 13_000, 64, 3)
    yield H(20_000)
    yield p.base.EOS


def _drive_window(p, feed):
    col, F = p.col, p.F
    w = p.Window(
        _stub(p, feed), [col("k")],
        [F.count(col("v")).alias("n"), F.sum(col("v")).alias("s")],
        p.WT.TUMBLING, 1000, None, **p.window_kw,
    )
    out = []
    for it in w.run():
        if isinstance(it, p.base.WatermarkHint):
            out.append(("hint", int(it.ts_ms), it.kind))
        elif isinstance(it, p.base.EndOfStream):
            out.append(("eos",))
        else:
            rows = sorted(zip(
                it.column("window_start_time").tolist(),
                it.column("k").tolist(), it.column("n").tolist(),
                it.column("s").tolist()))
            out.append(("batch", rows))
    return out, w.metrics()["late_rows"]


@pytest.mark.parametrize("strategy", ["auto", "scatter", "partial_merge"])
def test_window_takes_partition_and_idle_hints_like_the_jax_package(strategy):
    """The port's window (each strategy) and the JAX package's, fed the
    same items: the same emissions and forwarded (clamped) hints, in the
    same order, the same late rows — hint-driven watermarks, the rebase of
    first_open for older windows (under partial_merge after merging the
    stripe), and the idle hint's forced close."""
    (jout, jlate), (tout, tlate) = (
        _drive_window(ns(pkg, strategy), _hint_feed) for pkg in PKGS)
    assert tout == jout
    assert tlate == jlate > 0
    starts = [r[0] for kind, *rest in tout if kind == "batch"
              for r in rest[0]]
    assert 8_000 in starts and 9_000 in starts  # rebased, not late-dropped
    assert 5_000 not in starts  # behind the watermark: late
    assert tout[0] == ("hint", tbase.WM_ANNOUNCE, "partition")


def _join_then_window(p):
    """Raw join of two streams whose left rows arrive out of step with the
    right, then a 1 s window over the joined pairs by key."""
    ctx = p.ctx()
    SL = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                   p.Field("k", p.DT.STRING, nullable=False),
                   p.Field("v", p.DT.FLOAT64)])
    SR = p.Schema([p.Field("ts2", p.DT.INT64, nullable=False),
                   p.Field("k2", p.DT.STRING, nullable=False),
                   p.Field("w", p.DT.FLOAT64)])
    rng = np.random.default_rng(7)
    keys = np.array([f"k{i}" for i in range(5)], dtype=object)

    def batches(schema, n_batches, span):
        out = []
        for b in range(n_batches):
            ts = np.sort(T0 + b * span + rng.integers(0, span, 50))
            out.append(p.Batch(schema, [ts, keys[rng.integers(0, 5, 50)],
                                        rng.integers(0, 9, 50).astype(float)]))
        return out

    # the right side runs 8x faster through event time: its late batches
    # match left rows many windows back
    left = ctx.from_source(p.Source.from_batches(
        batches(SL, 12, 1000), timestamp_column="ts"), name="l")
    right = ctx.from_source(p.Source.from_batches(
        batches(SR, 12, 125), timestamp_column="ts2"), name="r")
    res = left.join(right, "inner", ["k"], ["k2"]).window(
        ["k"], [p.F.count(p.col("w")).alias("n"),
                p.F.sum(p.col("w")).alias("s")], 1000,
    ).collect()
    rows = sorted(zip(res.column("window_start_time").tolist(),
                      res.column("k").tolist(), res.column("n").tolist(),
                      res.column("s").tolist()))
    return rows, ctx._last_physical


def test_join_then_window_drops_no_pair():
    """A window above a join takes its announcement and clamped hints, so
    no joined pair is dropped as late, whatever the pump interleave — the
    same windows as the JAX package."""
    (jrows, _), (trows, root) = (_join_then_window(ns(pkg)) for pkg in PKGS)
    assert trows == jrows and trows
    window = root.input_op
    assert isinstance(window, TWindow)
    assert window._src_watermarks
    assert window.metrics()["late_rows"] == 0
    assert isinstance(window.input_op, StreamingJoinExec)
    joined = window.input_op.metrics()["rows_out"]
    assert sum(r[2] for r in trows) == joined


def test_stateless_operators_forward_hints_and_the_sink_skips_them():
    p = ns("torch")
    H = tbase.WatermarkHint
    items = [H(tbase.WM_ANNOUNCE, kind="partition"), H(5, kind="partition"),
             H(9), tbase.Marker(3), tbase.EOS]

    def feed(p, schema):
        yield _batch(p, schema, 0, 1000, 8, 0)
        yield from items

    stub = _stub(p, feed)
    proj = ProjectExec(stub, [p.col(TTS), p.col("k"), p.col("v")],
                       stub.schema)
    filt = FilterExec(proj, p.col("v") >= 0.0)
    sink = CollectSink()
    out = list(SinkExec(filt, sink).run())
    assert out[1:] == items  # forwarded unchanged, in order
    assert len(sink.batches) == 1 and sink.batches[0].num_rows == 8


def test_hints_reach_collect_and_stream_without_output():
    """The executor's root loops skip hints: collect() and stream() of a
    join (which announces and emits hints) return only batches."""
    for how in ("collect", "stream"):
        ctx = tt.Context(tt.EngineConfig(device="cpu"))
        S = TSchema([TField("ts", TType.INT64, nullable=False),
                     TField("k", TType.STRING, nullable=False)])
        S2 = TSchema([TField("ts2", TType.INT64, nullable=False),
                      TField("k2", TType.STRING, nullable=False)])
        mk = lambda s, t: TBatch(s, [np.array([t], np.int64),  # noqa: E731
                                     np.array(["a"], object)])
        ds = ctx.from_source(TSource.from_batches(
            [mk(S, T0), mk(S, T0 + 10)], timestamp_column="ts"), name="l"
        ).join(ctx.from_source(TSource.from_batches(
            [mk(S2, T0 + 1), mk(S2, T0 + 11)], timestamp_column="ts2"),
            name="r"), "inner", ["k"], ["k2"])
        if how == "collect":
            assert ds.collect().num_rows == 4
        else:
            got = list(ds.stream())
            assert all(isinstance(b, TBatch) for b in got)
            assert sum(b.num_rows for b in got) == 4


# -- two windows on two pump threads -----------------------------------------


@pytest.mark.parametrize("strategy", ["auto", "partial_merge"])
def test_two_windows_on_two_pump_threads_use_the_native_host_code(strategy):
    """Config 4's shape on the CPU: each window under the join runs on its
    own pump thread with its own native interner (and, under
    partial_merge, its own native reducer); both stay on the native lanes
    and the joined rows match the JAX package's."""
    got = {}
    for pkg in PKGS:
        p = ns(pkg)
        ctx = p.ctx() if pkg == "jax" else p.ctx(device_strategy=strategy)
        S = p.Schema([p.Field("occurred_at_ms", p.DT.INT64, nullable=False),
                      p.Field("sensor_name", p.DT.STRING, nullable=False),
                      p.Field("reading", p.DT.FLOAT64)])
        keys = np.array([f"sensor_{i}" for i in range(200)], dtype=object)

        def feed(seed):
            rng = np.random.default_rng(seed)
            return [p.Batch(S, [
                np.sort(T0 + b * 200 + rng.integers(0, 200, 4096)),
                keys[rng.integers(0, 200, 4096)],
                rng.normal(50.0, 10.0, 4096)]) for b in range(20)]

        def side(name, seed, agg):
            return ctx.from_source(p.Source.from_batches(
                feed(seed), timestamp_column="occurred_at_ms"), name=name
            ).window(["sensor_name"],
                     [p.F.avg(p.col("reading")).alias(agg)], 1000)

        right = side("h", 1, "avg_h").with_column_renamed(
            "sensor_name", "hs").with_column_renamed(
            "window_start_time", "hws").with_column_renamed(
            "window_end_time", "hwe")
        res = side("t", 0, "avg_t").join(
            right, "inner", ["sensor_name", "window_start_time"],
            ["hs", "hws"]).collect()
        got[pkg] = sorted(zip(
            res.column("window_start_time").tolist(),
            res.column("sensor_name").tolist(),
            res.column("avg_t").tolist(), res.column("avg_h").tolist()))
        if pkg == "torch":
            join = ctx._last_physical.input_op
            windows = [_find_window(c) for c in join.children]
            assert len(windows) == 2
            for w in windows:
                assert w._interner.lanes[0].startswith("native")
                if strategy == "partial_merge":
                    st = w.backend.stripe
                    assert st.native_batches == 20 and st.numpy_batches == 0
    assert len(got["torch"]) == 4 * 200
    assert [r[:2] for r in got["torch"]] == [r[:2] for r in got["jax"]]
    np.testing.assert_allclose(
        np.array([r[2:] for r in got["torch"]]),
        np.array([r[2:] for r in got["jax"]]), rtol=1e-5, atol=0)


def _find_window(op):
    if isinstance(op, TWindow):
        return op
    for c in op.children:
        w = _find_window(c)
        if w is not None:
            return w
    return None


def test_native_host_code_has_no_shared_state_across_threads():
    """Eight threads, each with its own native interner and stripe
    reducer, hammered with a short switch interval: every thread's ids and
    partials equal the same work done alone."""
    rng = np.random.default_rng(11)
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for([("sum", 0), ("count", 0)])),
        num_value_cols=1, window_slots=16, group_capacity=1024,
        length_ms=1000, slide_ms=1000,
    )
    feeds = []
    for t in range(8):
        names = np.array([f"t{t % 3}_{i}" for i in range(500)], dtype=object)
        feeds.append([
            (names[rng.integers(0, 500, 2000)],
             rng.integers(0, 4, 2000).astype(np.int64),
             rng.normal(size=(2000, 1)))
            for _ in range(12)])

    def work(feed):
        it = GroupInterner(1)
        st = hp.HostPartialStripe(spec, 1024)
        ids = []
        for names, units, vals in feed:
            g = it.intern([names])
            ids.append(g.copy())
            st.add_batch(units, np.zeros(len(g), np.int32), g, vals,
                         None, None)
        return ids, st.take_packed(0)[0].copy(), st.native_batches

    want = [work(f) for f in feeds]
    got = [None] * len(feeds)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(i):
            got[i] = work(feeds[i])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(feeds))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    for (wi, wp, wn), (gi, gp, gn) in zip(want, got):
        assert wn == gn == 12
        assert all((a == b).all() for a, b in zip(wi, gi))
        np.testing.assert_array_equal(wp, gp)


# -- checkpointing a join, and the kernel build ------------------------------


def test_checkpointing_a_join_plan_is_refused(tmp_path):
    ctx = tt.Context(tt.EngineConfig(
        device="cpu", checkpoint=True, state_backend_path=str(tmp_path)))
    S = TSchema([TField("ts", TType.INT64, nullable=False),
                 TField("k", TType.STRING, nullable=False)])
    S2 = TSchema([TField("ts2", TType.INT64, nullable=False),
                  TField("k2", TType.STRING, nullable=False)])
    rb = lambda s: TBatch(s, [np.array([T0], np.int64),  # noqa: E731
                              np.array(["a"], object)])
    ds = ctx.from_source(TSource.from_batches([rb(S)], timestamp_column="ts"),
                         name="l").join(
        ctx.from_source(TSource.from_batches([rb(S2)], timestamp_column="ts2"),
                        name="r"), "inner", ["k"], ["k2"])
    with pytest.raises(PlanError, match="checkpointing a join is not yet"):
        ds.collect()
    # nothing was opened or committed under the path
    assert not any(tmp_path.iterdir())


def test_kernel_load_from_many_threads_builds_once(monkeypatch, tmp_path):
    """Eight threads load one kernel for the first time at once: one build
    runs (nvcc is stubbed: there is none here), every thread gets the
    library, and build_all takes the same lock."""
    builds = []

    def fake_start(name):
        out = tmp_path / f"lib{name}.so"
        if out.exists():
            return out, None
        builds.append(name)
        time.sleep(0.05)  # widen the window two unlocked builders race in
        return out, ("nvcc", out)

    def fake_finish(name, out, pending):
        if pending is not None:
            out.write_text("built")
        return ""

    monkeypatch.setattr(cuda_build, "_start", fake_start)
    monkeypatch.setattr(cuda_build, "_finish", fake_finish)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(cuda_build, "sources", lambda: ["a", "b"])
    cuda_build.load.cache_clear()
    got = []
    try:
        threads = [threading.Thread(
            target=lambda: got.append(cuda_build.load("dense_window")))
            for _ in range(8)]
        threads.append(threading.Thread(target=cuda_build.build_all))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        cuda_build.load.cache_clear()
    assert sorted(builds) == ["a", "b", "dense_window"]
    assert len(got) == 8 and set(got) == {str(tmp_path / "libdense_window.so")}
