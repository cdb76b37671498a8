"""Checkpoint and restore of the stream-stream join (configs 4 and 5
together), the port held against the JAX package.

Each test crashes a checkpointed join right after an aligned barrier
committed (the generator is closed, as the JAX package's tests crash
theirs), restores on the same store and runs to the end; the union of both
runs' rows must cover the golden (the JAX package's uninterrupted run) with
no spurious row.  Twins of ``tests/test_checkpoint.py:759`` (join kill and
restore) and ``:960`` (semi join, exactly once), of
``tests/test_join_interval.py:359`` (banded: band values ride the
snapshot) and of the kill/restore half of
``tests/test_join_adaptive.py:437`` (hot blocks rebuilt from their
representatives); then cross-restores both ways with identical emissions,
and a JAX snapshot written under a state budget (its cold tier spilled at
the cut) restored by the port with and without a budget.

Rows are compared as sets: two pump threads interleave at random.  Window
averages to rel=1e-5 (f32 sums in another order), the JAX tests' own
tolerance; passthrough columns exactly.
"""

from __future__ import annotations

import shutil
import threading
from collections import Counter
from types import SimpleNamespace

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
from denormalized_tpu.logical import plan as jlp
from denormalized_tpu.physical.base import Marker as JMarker
from denormalized_tpu.physical.simple_execs import CollectSink as JSink
from denormalized_tpu.runtime import executor as jexec
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu.state import lsm as jlsm
from denormalized_tpu.state.checkpoint import wire_checkpointing as jwire
from denormalized_tpu.state.orchestrator import Orchestrator as JOrch
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.physical.base import Marker as TMarker
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state import lsm as tlsm
from denormalized_tpu_torch.state.checkpoint import wire_checkpointing as twire
from denormalized_tpu_torch.state.orchestrator import Orchestrator as TOrch
from denormalized_tpu_torch.state.tiering import attach_spill as tattach
from denormalized_tpu_torch.state.serialization import unpack_snapshot

T0 = 1_700_000_000_000
AVG_REL = 1e-5


def api(pkg: str) -> SimpleNamespace:
    """One package's surface: its Context factory (config knobs as
    keywords; the port's on the CPU) and the pieces a checkpointed run
    needs."""
    if pkg == "jax":
        return SimpleNamespace(
            ctx=lambda **kw: jt.Context(JConfig(**kw)), Schema=JSchema,
            Field=JField, DT=JType, Batch=JBatch, Source=JSource, F=JF,
            col=jt.col, lp=jlp, Sink=JSink, executor=jexec, wire=jwire,
            Orch=JOrch, Marker=JMarker, close=jlsm.close_global_state_backend,
        )
    return SimpleNamespace(
        ctx=lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)),
        Schema=TSchema, Field=TField, DT=TType, Batch=TBatch, Source=TSource,
        F=TF, col=tt.col, lp=tlp, Sink=TSink, executor=texec, wire=twire,
        Orch=TOrch, Marker=TMarker, close=tlsm.close_global_state_backend,
    )


def ckpt(path) -> dict:
    return dict(checkpoint=path is not None, checkpoint_interval_s=9999,
                state_backend_path=path)


def crash_after_commit(p, ctx, ds, trigger=lambda i, root: i == 1,
                       after_trigger=lambda: None):
    """Run ``ds`` checkpointed: trigger a barrier when ``trigger(items
    seen, root)`` first holds (then call ``after_trigger()``), commit the
    epoch whose marker reaches the root, then crash (close the generator)
    → (emitted batches, root)."""
    sink = p.Sink()
    root = p.executor.build_physical(p.lp.Sink(ds._plan, sink), ctx)
    orch = p.Orch(interval_s=9999)
    coord = p.wire(root, ctx, orch)
    it = root.run()
    out, seen, armed, committed = [], 0, False, False
    for item in it:
        if isinstance(item, (JBatch, TBatch)):
            out.append(item)
        if not armed and trigger(seen, root):
            orch.trigger_now()
            after_trigger()
            armed = True
        if isinstance(item, p.Marker):
            coord.commit(item.epoch)
            committed = True
            break
        seen += 1
    it.close()
    orch.stop()
    p.close()
    assert committed, "the barrier never aligned before the end of stream"
    return out, root


class GatedReader:
    """A partition reader that, before batch ``at``, waits (up to 60 s)
    for ``gate``; offsets are the wrapped reader's."""

    def __init__(self, reader, gate, at):
        self._reader, self._gate, self._at, self._n = reader, gate, at, 0

    def read(self, timeout_s=None):
        if self._n == self._at:
            self._gate.wait(60)
        self._n += 1
        return self._reader.read(timeout_s)

    def offset_snapshot(self):
        return self._reader.offset_snapshot()

    def offset_restore(self, snap):
        self._reader.offset_restore(snap)

    def __getattr__(self, name):
        return getattr(self._reader, name)


def gated(src, gate, at):
    """``src`` with every partition reader waiting before batch ``at``
    until ``gate`` is set (``src`` unchanged when ``gate`` is None).  A
    crashed run sets the gate when it triggers its barrier: otherwise a
    starved pump thread lets the other side read to its end first, and the
    join (no consistent cut once a side finished) drops the barrier."""
    if gate is None:
        return src
    first = src.partitions
    src.partitions = lambda: [GatedReader(r, gate, at) for r in first()]
    return src


def restore_and_run(p, ctx, ds, before_run=None):
    """Restore ``ds`` from the committed epoch and run it to the end →
    (emitted batches, root)."""
    sink = p.Sink()
    root = p.executor.build_physical(p.lp.Sink(ds._plan, sink), ctx)
    orch = p.Orch(interval_s=9999)
    coord = p.wire(root, ctx, orch)
    assert coord.committed_epoch is not None
    if before_run is not None:
        before_run(root)
    out = [i for i in root.run() if isinstance(i, (JBatch, TBatch))]
    orch.stop()
    p.close()
    return out, root


def find_join(root):
    stack = [root]
    while stack:
        cur = stack.pop()
        if type(cur).__name__ == "StreamingJoinExec":
            return cur
        stack.extend(cur.children)
    raise AssertionError("no join in the plan")


# -- config 4's query: two windowed streams joined on (sensor, window) -------


def sensor_raw(seed, shift, n_batches=40, n=160):
    """Seeded batches of 400 ms of event time each; enough of them that the
    pump queues (8 items) hold the sources back and a barrier triggered at
    the root's second item lands mid-stream."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 400 + rng.integers(0, 400, n))
        keys = np.array([f"s{i}" for i in rng.integers(0, 6, n)], dtype=object)
        out.append((ts.astype(np.int64), keys, rng.normal(50, 5, n) + shift))
    return out


def sensor_batches(p, raw):
    schema = p.Schema([
        p.Field("occurred_at_ms", p.DT.INT64, nullable=False),
        p.Field("sensor_name", p.DT.STRING, nullable=False),
        p.Field("reading", p.DT.FLOAT64),
    ])
    return [p.Batch(schema, [ts, k, v]) for ts, k, v in raw]


#: the batch of each side before which a crashed run's sources wait for
#: its barrier (of sensor_raw's 40)
SENSOR_GATE_AT = 12


def window_join(p, ctx, t_raw, h_raw, gate=None):
    col, F = p.col, p.F
    left = ctx.from_source(
        gated(p.Source.from_batches(sensor_batches(p, t_raw),
                                    timestamp_column="occurred_at_ms"),
              gate, SENSOR_GATE_AT),
        name="jk_t",
    ).window(["sensor_name"], [F.avg(col("reading")).alias("avg_t")], 1000)
    right = (
        ctx.from_source(
            gated(p.Source.from_batches(sensor_batches(p, h_raw),
                                        timestamp_column="occurred_at_ms"),
                  gate, SENSOR_GATE_AT),
            name="jk_h",
        )
        .window(["sensor_name"], [F.avg(col("reading")).alias("avg_h")], 1000)
        .with_column_renamed("sensor_name", "hs")
        .with_column_renamed("window_start_time", "hws")
        .with_column_renamed("window_end_time", "hwe")
    )
    return left.join(
        right, "inner", ["sensor_name", "window_start_time"], ["hs", "hws"]
    )


def join_windows(batches) -> dict:
    out = {}
    for r in batches:
        for ws, k, a, b in zip(r.column("window_start_time").tolist(),
                               r.column("sensor_name").tolist(),
                               r.column("avg_t").tolist(),
                               r.column("avg_h").tolist()):
            out[(int(ws), str(k))] = (float(a), float(b))
    return out


def assert_windows(got: dict, golden: dict) -> None:
    assert set(got) == set(golden), sorted(set(got) ^ set(golden))[:5]
    for k, (a, b) in golden.items():
        assert got[k][0] == pytest.approx(a, rel=AVG_REL), k
        assert got[k][1] == pytest.approx(b, rel=AVG_REL), k


@pytest.fixture(scope="module")
def sensor_feed():
    t_raw, h_raw = sensor_raw(41, 0), sensor_raw(42, 100)
    golden = join_windows(
        [window_join(api("jax"), api("jax").ctx(emit_lag_ms=0), t_raw,
                     h_raw).collect()]
    )
    assert len(golden) > 8
    return t_raw, h_raw, golden


@pytest.mark.parametrize("strategy", ["auto", "scatter", "partial_merge"])
def test_join_kill_and_restore(tmp_path, sensor_feed, strategy):
    """Twin of tests/test_checkpoint.py:759 (single device): kill after a
    committed aligned barrier, restore, and the union of the join's
    emissions covers every golden pair without a full reprocess."""
    t_raw, h_raw, golden = sensor_feed
    p = api("torch")
    path = str(tmp_path / "state")
    cfg = dict(device_strategy=strategy, **ckpt(path))
    ctx_a = p.ctx(**cfg)
    gate = threading.Event()
    a, _ = crash_after_commit(
        p, ctx_a, window_join(p, ctx_a, t_raw, h_raw, gate=gate),
        after_trigger=gate.set)
    ctx_b = p.ctx(**cfg)
    b, _ = restore_and_run(p, ctx_b, window_join(p, ctx_b, t_raw, h_raw))
    got_a, got_b = join_windows(a), join_windows(b)
    both = dict(got_a)
    both.update(got_b)
    assert_windows(both, golden)
    assert len(got_b) < len(golden) or not got_a


def test_semi_join_kill_and_restore_exactly_once(tmp_path):
    """Twin of tests/test_checkpoint.py:960: the matched flags are the
    record of what a semi join emitted, so after a crash at a committed
    barrier the restored run emits exactly the matching left rows not yet
    emitted — union equal to the golden, no row twice."""
    t0 = 1_700_000_000_000

    def raw(seed, keyspace):
        r = np.random.default_rng(seed)
        out = []
        for b in range(48):
            ts = np.sort(t0 + b * 400 + r.integers(0, 400, 60))
            keys = np.array([f"k{i}" for i in r.integers(0, keyspace, 60)],
                            dtype=object)
            out.append((ts.astype(np.int64), keys, r.normal(0, 1, 60)))
        return out

    l_raw, r_raw = raw(1, 40), raw(2, 20)
    gate = threading.Event()

    def source(p, raw_side, gate):
        return gated(p.Source.from_batches(sensor_batches(p, raw_side),
                                           timestamp_column="occurred_at_ms"),
                     gate, 12)

    def pipeline(p, ctx, gate=None):
        left = ctx.from_source(source(p, l_raw, gate), name="sj_l")
        right = ctx.from_source(source(p, r_raw, gate), name="sj_r")
        return left.join(right, "semi", ["sensor_name"], ["sensor_name"])

    def rows_of(batches):
        return Counter(
            (int(ts), str(k), round(float(v), 6))
            for b in batches
            for ts, k, v in zip(b.column("occurred_at_ms").tolist(),
                                b.column("sensor_name").tolist(),
                                b.column("reading").tolist())
        )

    j = api("jax")
    golden = rows_of([pipeline(j, j.ctx()).collect()])
    assert golden and max(golden.values()) == 1
    p = api("torch")
    path = str(tmp_path / "state_semi")
    ctx_a = p.ctx(**ckpt(path))
    a, _ = crash_after_commit(p, ctx_a, pipeline(p, ctx_a, gate=gate),
                              after_trigger=gate.set)
    ctx_b = p.ctx(**ckpt(path))
    b, _ = restore_and_run(p, ctx_b, pipeline(p, ctx_b))
    combined = rows_of(a) + rows_of(b)
    assert set(combined) == set(golden), sorted(set(golden) ^ set(combined))[:5]
    assert not {k: c for k, c in combined.items() if c != 1}


# -- banded joins and hot blocks ----------------------------------------------


def keyed_schemas(p, value_dt):
    ls = p.Schema([p.Field("ts", p.DT.TIMESTAMP_MS, nullable=False),
                   p.Field("k", p.DT.STRING, nullable=False),
                   p.Field("lv", value_dt(p))])
    rs = p.Schema([p.Field("ts2", p.DT.TIMESTAMP_MS, nullable=False),
                   p.Field("k2", p.DT.STRING, nullable=False),
                   p.Field("rv", value_dt(p))])
    return ls, rs


def keyed_streams(p, ctx, l_raw, r_raw, value_dt, gate=None, at=12):
    """The two keyed sources; with ``gate``, each waits before batch ``at``
    for it (:func:`gated`)."""
    ls, rs = keyed_schemas(p, value_dt)

    def mk(schema, raw):
        return [p.Batch(schema, [np.asarray(t, np.int64),
                                 np.asarray(k, object), np.asarray(v)])
                for t, k, v in raw]

    left = ctx.from_source(
        gated(p.Source.from_batches(mk(ls, l_raw), timestamp_column="ts"),
              gate, at), name="il")
    right = ctx.from_source(
        gated(p.Source.from_batches(mk(rs, r_raw), timestamp_column="ts2"),
              gate, at), name="ir")
    return left, right


KEY_CODES: dict[str, int] = {}


def pairs(batches) -> np.ndarray:
    """The joined pairs of ``batches`` as the sorted distinct rows of an
    (n, 5) float64 matrix (ts, key code, lv, ts2, rv): a skewed feed joins
    millions of pairs, which numpy sorts in a fraction of what a set of
    tuples takes.  Key codes come from one table for the whole module, so
    equal keys get equal codes in every call."""
    cols = []
    for b in batches:
        keys = np.asarray(b.column("k"), dtype=object)
        code = np.fromiter(
            (KEY_CODES.setdefault(str(x), len(KEY_CODES)) for x in keys),
            dtype=np.float64, count=len(keys))
        cols.append(np.stack([
            np.asarray(b.column("ts"), np.float64), code,
            np.asarray(b.column("lv"), np.float64),
            np.asarray(b.column("ts2"), np.float64),
            np.asarray(b.column("rv"), np.float64),
        ], axis=1))
    return distinct(np.concatenate(cols) if cols else np.empty((0, 5)))


def distinct(rows: np.ndarray) -> np.ndarray:
    """Sorted distinct rows of a float matrix (lexicographic)."""
    rows = rows[np.lexsort(rows.T[::-1])]
    keep = np.ones(len(rows), dtype=bool)
    keep[1:] = (rows[1:] != rows[:-1]).any(axis=1)
    return rows[keep]


def union(*parts) -> np.ndarray:
    return distinct(np.concatenate(parts))


def band_feed(seed, nb=24, n=80):
    rr = np.random.default_rng(seed)
    t = T0
    out = []
    for _ in range(nb):
        ts = np.sort(t + rr.integers(0, 300, n))
        t += 300
        out.append((ts, np.array([f"k{i}" for i in rr.integers(0, 5, n)],
                                 dtype=object), rr.integers(0, 100, n)))
    return out


def test_banded_join_kill_restore_byte_identical(tmp_path):
    """Twin of tests/test_join_interval.py:359: band values, the band
    watermark and the batch band maxima come from the snapshot, and the
    restored banded join continues exactly."""
    l_raw, r_raw = band_feed(1), band_feed(2)
    int_dt = lambda p: p.DT.INT64  # noqa: E731

    def mk(p, path, gate=None):
        ctx = p.ctx(join_adaptive=True, join_adapt_interval_s=0.0,
                    **ckpt(path))
        left, right = keyed_streams(p, ctx, l_raw, r_raw, int_dt, gate)
        return ctx, left.join(right, "inner", ["k"], ["k2"],
                              band=("ts", "ts2", -50, 50))

    j = api("jax")
    golden = pairs([mk(j, None)[1].collect()])
    p = api("torch")
    path = str(tmp_path / "state")
    gate = threading.Event()
    ctx_a, ds_a = mk(p, path, gate)
    a, root_a = crash_after_commit(
        p, ctx_a, ds_a, trigger=lambda i, root: i == 0,
        after_trigger=gate.set)
    cut = [(s.band_wm, list(s.batch_band_max)) for s in find_join(root_a)._sides]
    ctx_b, ds_b = mk(p, path)
    seen = {}

    def capture(root):
        # the restored sides before any new row: band state from the blob
        join = find_join(root)
        real = join._restore

        def restore(sides):
            real(sides)
            seen["state"] = [(s.band_wm, list(s.batch_band_max),
                              s.row_band is not None) for s in sides]

        join._restore = restore

    b, _ = restore_and_run(p, ctx_b, ds_b, before_run=capture)
    assert [st[2] for st in seen["state"]] == [True, True]
    # band watermark as at the cut, batch maxima of the retained batches
    for (wm, maxima), (rwm, rmaxima, _) in zip(cut, seen["state"]):
        assert rwm == wm
        assert set(rmaxima) <= set(maxima)
    assert np.array_equal(union(pairs(a), pairs(b)), golden)


def skewed(seed, nb=20, rows=300, hot_share=0.25, keys=30):
    """tests/test_join_adaptive.py's skewed feed: one celebrity key takes
    a quarter of the rows."""
    rng = np.random.default_rng(seed)
    t = T0
    out = []
    for _ in range(nb):
        ts = t + np.arange(rows, dtype=np.int64)
        t += rows
        hot = rng.random(rows) < hot_share
        ks = np.where(hot, "celebrity",
                      rng.integers(0, keys, rows).astype(str)).astype(object)
        out.append((ts, ks, rng.random(rows)))
    return out


def test_hot_blocks_restore_from_their_representatives(tmp_path):
    """The kill/restore half of tests/test_join_adaptive.py:437: a cut
    taken once the policy adapted a key carries hot-block representatives;
    the restored join rebuilds those blocks before its first batch (its
    policy frozen, so the layout can only come from the snapshot), and the
    union of emissions covers the unadapted golden."""
    # the policy acts after 4,096 sketched rows a side (~21 of 30 batches):
    # the rest keeps both sources alive when the barrier comes
    l_raw, r_raw = skewed(1, nb=30, rows=200), skewed(2, nb=30, rows=200)
    f64 = lambda p: p.DT.FLOAT64  # noqa: E731

    def mk(p, adaptive, path, gate=None):
        ctx = p.ctx(join_adaptive=adaptive, join_adapt_interval_s=0.0,
                    **ckpt(path))
        # a crashed run's sources wait before batch 25 for the barrier
        left, right = keyed_streams(p, ctx, l_raw, r_raw, f64, gate, 25)
        return ctx, left.join(right, "inner", ["k"], ["k2"])

    j = api("jax")
    golden = pairs([mk(j, False, None)[1].collect()])
    p = api("torch")
    path = str(tmp_path / "state")
    gate = threading.Event()
    ctx_a, ds_a = mk(p, True, path, gate)

    def adapted(_i, root):
        return find_join(root)._policy.adaptations_total > 0

    a, root_a = crash_after_commit(p, ctx_a, ds_a, trigger=adapted,
                                   after_trigger=gate.set)
    assert any(s.hot.nslots for s in find_join(root_a)._sides)
    ctx_b, ds_b = mk(p, True, path)
    hot_at_start = {}

    def freeze(root):
        join = find_join(root)
        join._policy.interval_s = 1e9
        real = join._restore

        def restore(sides):
            real(sides)
            hot_at_start["slots"] = [int(s.hot.nslots) for s in sides]
            hot_at_start["rows"] = [int(s.hot.rows_total()) for s in sides]

        join._restore = restore

    b, _ = restore_and_run(p, ctx_b, ds_b, before_run=freeze)
    assert sum(hot_at_start["slots"]) > 0, hot_at_start
    assert sum(hot_at_start["rows"]) > 0, hot_at_start
    assert np.array_equal(union(pairs(a), pairs(b)), golden)


# -- one package writes, the other restores ------------------------------------


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_restore_gives_identical_emissions(tmp_path, sensor_feed, writer):
    """One package crashes after a committed barrier; the store is copied,
    and each package restores one copy: both restored runs emit the same
    (window, sensor) rows with the same averages, and with the crashed
    run's rows they cover the golden."""
    t_raw, h_raw, golden = sensor_feed
    w = api(writer)
    path = str(tmp_path / "state")
    ctx_a = w.ctx(emit_lag_ms=0, **ckpt(path))
    gate = threading.Event()
    a, _ = crash_after_commit(
        w, ctx_a, window_join(w, ctx_a, t_raw, h_raw, gate=gate),
        after_trigger=gate.set)
    copy = str(tmp_path / "state_copy")
    shutil.copytree(path, copy)
    restored = {}
    for pkg, store in (("jax", path), ("torch", copy)):
        r = api(pkg)
        ctx = r.ctx(emit_lag_ms=0, **ckpt(store))
        got, root = restore_and_run(r, ctx, window_join(r, ctx, t_raw, h_raw))
        restored[pkg] = join_windows(got)
    assert set(restored["jax"]) == set(restored["torch"])
    for k, (x, y) in restored["jax"].items():
        assert restored["torch"][k][0] == pytest.approx(x, rel=AVG_REL), k
        assert restored["torch"][k][1] == pytest.approx(y, rel=AVG_REL), k
    both = join_windows(a)
    both.update(restored["torch"])
    assert_windows(both, golden)
    assert len(restored["torch"]) < len(golden) or not join_windows(a)


def test_cross_restore_of_a_banded_join_with_hot_blocks(tmp_path):
    """Both directions on a banded, adapted join: the JAX package's
    snapshot restores into the port and the port's into the JAX package,
    each restored run's pairs equal to the other package's restore of the
    same store, and with the crashed run's pairs to the golden."""
    l_raw, r_raw = skewed(3, nb=30, rows=200), skewed(4, nb=30, rows=200)
    f64 = lambda p: p.DT.FLOAT64  # noqa: E731

    def mk(p, path, gate=None):
        ctx = p.ctx(join_adaptive=True, join_adapt_interval_s=0.0,
                    **ckpt(path))
        left, right = keyed_streams(p, ctx, l_raw, r_raw, f64, gate, 25)
        return ctx, left.join(right, "inner", ["k"], ["k2"],
                              band=("ts", "ts2", -400, 400))

    golden = pairs([mk(api("jax"), None)[1].collect()])
    for writer in ("jax", "torch"):
        w = api(writer)
        path = str(tmp_path / f"state_{writer}")
        gate = threading.Event()
        ctx_a, ds_a = mk(w, path, gate)
        a, _ = crash_after_commit(
            w, ctx_a, ds_a,
            trigger=lambda _i, root: find_join(root)._policy.adaptations_total > 0,
            after_trigger=gate.set)
        copy = path + "_copy"
        shutil.copytree(path, copy)
        got = {}
        for pkg, store in (("jax", path), ("torch", copy)):
            r = api(pkg)
            ctx_b, ds_b = mk(r, store)
            b, _ = restore_and_run(r, ctx_b, ds_b)
            got[pkg] = pairs(b)
        assert np.array_equal(got["jax"], got["torch"]), writer
        assert np.array_equal(union(pairs(a), got["torch"]), golden), writer


def test_jax_snapshot_spilled_at_the_cut_restores(tmp_path):
    """A JAX join checkpointed under a state budget holds a v2 snapshot
    (``meta["spill"]``: blocks of retained rows in the cold tier, per-row
    gids and the interner).  The port restores it — with a budget (the
    tier map re-arms, blocks streamed into the spill namespace) and
    without one (spilled batches load resident) — and runs to the end: the
    same pairs as the JAX package's own restore of the same store, and
    with the crashed run's pairs the golden."""
    from denormalized_tpu.state.tiering import attach_spill

    from denormalized_tpu_torch.state.checkpoint import assign_node_ids

    # long enough that the pumps are still mid-stream at the barrier
    l_raw, r_raw = skewed(5, nb=60, rows=120), skewed(6, nb=60, rows=120)
    f64 = lambda p: p.DT.FLOAT64  # noqa: E731

    def query(p, ctx):
        left, right = keyed_streams(p, ctx, l_raw, r_raw, f64)
        return left.join(right, "inner", ["k"], ["k2"])

    j = api("jax")
    golden = pairs([query(j, j.ctx(join_adaptive=False)).collect()])
    path = str(tmp_path / "lsm")
    ctx = j.ctx(join_adaptive=False, state_budget_bytes=25_000, **ckpt(path))
    ds = query(j, ctx)
    root = jexec.build_physical(jlp.Sink(ds._plan, JSink()), ctx)
    spill = attach_spill(root, ctx)
    orch = JOrch(interval_s=9999)
    coord = jwire(root, ctx, orch)
    it = root.run()
    crashed, committed = [], False
    for i, item in enumerate(it):
        if isinstance(item, JBatch):
            crashed.append(item)
        if i == 3:
            orch.trigger_now()
        if isinstance(item, JMarker):
            coord.commit(item.epoch)
            committed = True
            break
    it.close()
    spill.close()
    orch.stop()
    jlsm.close_global_state_backend()
    assert committed

    got = {}
    for name, pkg, budget in (("jax", "jax", None),
                              ("torch", "torch", None),
                              ("torch_budget", "torch", 25_000)):
        store = str(tmp_path / f"copy_{name}")
        shutil.copytree(path, store)
        p = api(pkg)
        cfg = dict(join_adaptive=False, **ckpt(store))
        if budget is not None:
            cfg["state_budget_bytes"] = budget
        ctx_b = p.ctx(**cfg)
        ds_b = query(p, ctx_b)
        root_b = p.executor.build_physical(p.lp.Sink(ds_b._plan, p.Sink()),
                                           ctx_b)
        spill_b = (attach_spill if pkg == "jax" else tattach)(root_b, ctx_b)
        orch_b = p.Orch(interval_s=9999)
        coord_b = p.wire(root_b, ctx_b, orch_b)
        join = find_join(root_b)
        if pkg == "torch":
            blob = coord_b.get_snapshot(
                f"join_{assign_node_ids(root_b)[id(join)]}")
            assert unpack_snapshot(blob)[0].get("spill") is not None, (
                "nothing spilled at the cut")
        out = [b for b in root_b.run() if isinstance(b, (JBatch, TBatch))]
        if budget is not None:
            assert join._tier is not None
            assert join._tier.ctrl.spill_stats(join._tier.node_id)[
                "reload_blocks_total"] > 0
            spill_b.close()
        orch_b.stop()
        p.close()
        got[name] = pairs(out)
    assert np.array_equal(got["torch"], got["jax"])
    assert np.array_equal(got["torch_budget"], got["jax"])
    assert np.array_equal(union(pairs(crashed), got["torch"]), golden)
