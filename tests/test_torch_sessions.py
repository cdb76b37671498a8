"""Session windows in the port (``physical/session_exec.py``,
``physical/session_reference.py``, ``ops/session_table.py`` and the
recycling interner) held against the JAX package on the same seeded input.

Twins of the session tests of ``tests/test_session_and_udaf.py`` (four),
``tests/test_session_vectorized.py`` (all fourteen, with their seeds),
``tests/test_session_out_of_order.py`` (the first five; the sixth, a
mesh test, is in ``tests/test_torch_sharded_jobs.py``),
``tests/test_session_properties.py`` (all
three; hypothesis with ``derandomize=True``, so the examples are the same
every run) and ``tests/test_session_checkpoint_soa.py`` (both, the
reference-interop one included), plus the live path (a mock-broker topic,
whose keys arrive as ``StringColumn``s), ``FeastDataStream``,
``emit_on_close=False``, ``DENORMALIZED_SESSION_REFERENCE=1`` through
``Context`` and the cold tier (a budgeted run and the restore of a spilled
block, with and without a budget).

Both packages run the same host numpy code in the same order, so a port
row equals the JAX row EXACTLY, floats included.  Where the JAX tests
hold the vectorized operator against the reference one they allow
rel=1e-9 (reduceat against a sequential fold); the twins keep that bar.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical import plan as jlp
from denormalized_tpu.ops.interner import RecyclingGroupInterner as JRecycling
from denormalized_tpu.physical import base as jbase
from denormalized_tpu.physical.session_exec import SessionWindowExec as JSess
from denormalized_tpu.physical.session_reference import (
    ReferenceSessionWindowExec as JRefSess,
)
from denormalized_tpu.physical.simple_execs import CollectSink as JSink
from denormalized_tpu.runtime import executor as jexec
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu.state import lsm as jlsm
from denormalized_tpu.state.checkpoint import wire_checkpointing as jwire
from denormalized_tpu.state.orchestrator import Orchestrator as JOrch
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.columns import StringColumn
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.ops.interner import RecyclingGroupInterner
from denormalized_tpu_torch.physical import base as tbase
from denormalized_tpu_torch.physical.session_exec import SessionWindowExec
from denormalized_tpu_torch.physical.session_reference import (
    ReferenceSessionWindowExec,
)
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state import lsm as tlsm
from denormalized_tpu_torch.state.checkpoint import wire_checkpointing as twire
from denormalized_tpu_torch.state.orchestrator import Orchestrator as TOrch

sys.path.insert(0, str(Path(__file__).parent))
from test_session_properties import (  # noqa: E402
    partitioned_session_case,
    session_case,
    session_oracle,
)

T0 = 1_700_000_000_000
PKGS = ("jax", "torch")


def api(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        return SimpleNamespace(
            ctx=lambda **kw: jt.Context(JConfig(**kw)), Schema=JSchema,
            Field=JField, DT=JType, Batch=JBatch, Source=JSource, F=JF,
            col=jt.col, lp=jlp, Sink=JSink, executor=jexec, wire=jwire,
            Orch=JOrch, base=jbase, close=jlsm.close_global_state_backend,
            Sess=JSess, RefSess=JRefSess, Recycling=JRecycling,
        )
    return SimpleNamespace(
        ctx=lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)),
        Schema=TSchema, Field=TField, DT=TType, Batch=TBatch, Source=TSource,
        F=TF, col=tt.col, lp=tlp, Sink=TSink, executor=texec, wire=twire,
        Orch=TOrch, base=tbase, close=tlsm.close_global_state_backend,
        Sess=SessionWindowExec, RefSess=ReferenceSessionWindowExec,
        Recycling=RecyclingGroupInterner,
    )


def _cell(x):
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_cell(e) for e in x)
    if isinstance(x, (float, np.floating)):
        return "nan" if x != x else float(x)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


def table(res) -> list[tuple]:
    names = res.schema.without_internal().names
    return [
        tuple(_cell(res.column(n)[i]) for n in names)
        for i in range(res.num_rows)
    ]


# -- plain tables through Context ------------------------------------------


def kv_schema(p):
    return p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                     p.Field("k", p.DT.STRING, nullable=False),
                     p.Field("v", p.DT.FLOAT64)])


def kv(p, ts, ks, vs):
    return p.Batch(kv_schema(p), [np.asarray(ts, np.int64),
                                  np.asarray(ks, object),
                                  np.asarray(vs, np.float64)])


def run_session(p, raw, aggs, gap_ms, **cfg):
    """``raw``: [(ts, keys, values)] → the collected result."""
    batches = [kv(p, *b) for b in raw]
    return (
        p.ctx(**cfg).from_source(
            p.Source.from_batches(batches, timestamp_column="ts"))
        .session_window(["k"], aggs(p.F, p.col), gap_ms)
        .collect()
    )


def both(raw, aggs, gap_ms, **cfg):
    """Run the job in both packages → the port's result; asserts the
    rows are the JAX package's exactly."""
    res = {pkg: run_session(api(pkg), raw, aggs, gap_ms, **cfg)
           for pkg in PKGS}
    assert table(res["torch"]) == table(res["jax"])
    return res["torch"]


# -- tests/test_session_and_udaf.py ----------------------------------------


def test_session_window_gap_split():
    raw = [
        ([T0, T0 + 150, T0 + 300, T0 + 100, T0 + 500],
         ["a", "a", "a", "b", "b"], [1.0, 2.0, 3.0, 10.0, 20.0]),
        ([T0 + 900, T0 + 2000, T0 + 2100, T0 + 9000],
         ["b", "a", "a", "z"], [30.0, 4.0, 5.0, 0.0]),
    ]
    res = both(raw, lambda F, c: [F.count(c("v")).alias("cnt"),
                                  F.sum(c("v")).alias("s")], 500)
    got = {
        (res.column("k")[i], int(res.column("window_start_time")[i])): (
            int(res.column("cnt")[i]), float(res.column("s")[i]),
            int(res.column("window_end_time")[i]))
        for i in range(res.num_rows)
    }
    assert got[("a", T0)] == (3, 6.0, T0 + 300 + 500)
    assert got[("a", T0 + 2000)] == (2, 9.0, T0 + 2100 + 500)
    assert got[("b", T0 + 100)] == (3, 60.0, T0 + 900 + 500)
    assert ("z", T0 + 9000) in got


def test_session_window_with_collection_aggregates():
    raw = [
        ([T0 + 0, T0 + 100], ["a", "a"], [5.0, 1.0]),
        # out-of-order bridge: arrives later, merges the session downward
        ([T0 + 50, T0 + 20_000], ["a", "w"], [3.0, 0.0]),
        ([T0 + 40_000], ["w"], [0.0]),
    ]
    res = both(raw, lambda F, c: [F.median(c("v")).alias("med"),
                                  F.array_agg(c("v")).alias("arr"),
                                  F.count(c("v")).alias("c")], 5_000)
    i = list(res.column("k")).index("a")
    assert int(res.column("c")[i]) == 3
    assert float(res.column("med")[i]) == 3.0
    assert sorted(res.column("arr")[i]) == [1.0, 3.0, 5.0]


def test_session_order_sensitive_accumulators_keep_arrival_order():
    raw = [
        ([T0], ["a"], [1.0]),
        ([T0 + 100], ["a"], [2.0]),
        ([T0 + 200], ["a"], [3.0]),
        ([T0 + 20_000], ["w"], [0.0]),
    ]
    res = both(raw, lambda F, c: [F.first_value(c("v")).alias("fv"),
                                  F.last_value(c("v")).alias("lv"),
                                  F.array_agg(c("v")).alias("arr")], 5_000)
    i = list(res.column("k")).index("a")
    assert float(res.column("fv")[i]) == 1.0
    assert float(res.column("lv")[i]) == 3.0
    assert list(res.column("arr")[i]) == [1.0, 2.0, 3.0]


def _kill_restore(p, path, pipeline, cut_after):
    """Run A: a barrier after ``cut_after`` items, committed, then stop
    hard.  Run B: restore on the same path and run to the end.  → (rows
    of A, rows of B)."""
    emitted_a, emitted_b = [], []
    try:
        cfg = dict(checkpoint=True, checkpoint_interval_s=9999,
                   state_backend_path=path)
        ctx_a = p.ctx(**cfg)
        root_a = p.executor.build_physical(
            p.lp.Sink(pipeline(p, ctx_a)._plan, p.Sink()), ctx_a)
        orch_a = p.Orch(interval_s=9999)
        coord_a = p.wire(root_a, ctx_a, orch_a)
        it = root_a.run()
        for i, item in enumerate(it):
            if isinstance(item, p.Batch):
                emitted_a += table(item)
            if i == cut_after:
                orch_a.trigger_now()
            if isinstance(item, p.base.Marker):
                coord_a.commit(item.epoch)
                break
        it.close()
        p.close()
        ctx_b = p.ctx(**cfg)
        root_b = p.executor.build_physical(
            p.lp.Sink(pipeline(p, ctx_b)._plan, p.Sink()), ctx_b)
        coord_b = p.wire(root_b, ctx_b, p.Orch(interval_s=9999))
        assert coord_b.committed_epoch is not None
        for item in root_b.run():
            if isinstance(item, p.Batch):
                emitted_b += table(item)
            if isinstance(item, p.base.EndOfStream):
                break
    finally:
        p.close()
    return emitted_a, emitted_b


def test_session_collection_aggregates_survive_kill_restore(tmp_path):
    rng = np.random.default_rng(9)
    raw = []
    for b in range(10):
        n = 20
        ts = np.sort(T0 + b * 800 + rng.integers(0, 200, n))
        ks = [f"s{i % 3}" for i in range(n)]
        raw.append((ts, ks, rng.integers(0, 50, n).astype(np.float64)))

    def pipeline(p, ctx):
        return ctx.from_source(
            p.Source.from_batches([kv(p, *b) for b in raw],
                                  timestamp_column="ts"), name="sacc",
        ).session_window(["k"], [p.F.array_agg(p.col("v")).alias("arr")],
                         300)

    def by_key(rows):
        # (key, start) → sorted array: arrival order across a restore is
        # the uninterrupted run's, sorted as the JAX test compares
        return {(r[0], r[2]): sorted(r[1]) for r in rows}

    golden = {pkg: by_key(table(pipeline(api(pkg), api(pkg).ctx())
                                .collect())) for pkg in PKGS}
    assert golden["torch"] == golden["jax"]
    a, b = _kill_restore(api("torch"), str(tmp_path / "state"), pipeline, 1)
    combined = by_key(a)
    combined.update(by_key(b))
    assert combined == golden["torch"]


# -- tests/test_session_vectorized.py --------------------------------------


class _FeedOp:
    """Stub input operator replaying a fixed StreamItem sequence."""

    def __init__(self, items, schema, eos):
        self._items, self.schema, self._eos = items, schema, eos

    @property
    def children(self):
        return []

    def run(self):
        yield from self._items
        yield self._eos


def stub_schema(p, key_type=None):
    return p.Schema([
        p.Field("ts", p.DT.INT64, nullable=False),
        p.Field("k", key_type or p.DT.STRING, nullable=False),
        p.Field("v", p.DT.FLOAT64),
        p.Field(CANONICAL_TIMESTAMP_COLUMN, p.DT.TIMESTAMP_MS, nullable=False),
    ])


def items_of(p, raw, key_type=None):
    """``raw``: [("b", ts, keys, values, mask) | ("h", ts)] → one package's
    StreamItems (batches carry the canonical timestamp column)."""
    s = stub_schema(p, key_type)
    out = []
    for r in raw:
        if r[0] == "h":
            out.append(p.base.WatermarkHint(r[1]))
            continue
        _, ts, ks, vs, m = r
        t = np.asarray(ts, np.int64)
        keys = ks if isinstance(ks, StringColumn) else np.asarray(ks)
        out.append(p.Batch(s, [t, keys, np.asarray(vs, np.float64), t.copy()],
                           [None, None, m, None]))
    return s, out


def braw(ts, ks, vs, m=None):
    return ("b", ts, np.asarray(ks, object), vs, m)


def BUILTIN_AGGS(F, c):
    return [F.count(c("v")).alias("cnt"), F.sum(c("v")).alias("s"),
            F.min(c("v")).alias("mn"), F.max(c("v")).alias("mx"),
            F.avg(c("v")).alias("av"), F.stddev(c("v")).alias("sd")]


def UDAF_AGGS(F, c):
    return [F.array_agg(c("v")).alias("arr"),
            F.first_value(c("v")).alias("fv"),
            F.last_value(c("v")).alias("lv"),
            F.median(c("v")).alias("med"), F.count(c("v")).alias("cnt")]


def drive(pkg, ref, raw, aggs=BUILTIN_AGGS, gap_ms=500, key_type=None):
    """One operator over the items → (per-emission key sets, rows in
    emission order, the operator)."""
    p = api(pkg)
    s, items = items_of(p, raw, key_type)
    cls = p.RefSess if ref else p.Sess
    op = cls(_FeedOp(items, s, p.base.EOS), [p.col("k")],
             aggs(p.F, p.col), gap_ms)
    cycles, rows = [], []
    for item in op.run():
        if isinstance(item, p.Batch):
            t = table(item)
            rows += t
            cycles.append(sorted(((r[0], r[-2]) for r in t), key=repr))
    return cycles, rows, op


def _approx_equal(g, w):
    if isinstance(w, float) and isinstance(g, float):
        return g == pytest.approx(w, rel=1e-9, abs=1e-9)
    if isinstance(w, tuple):
        return len(g) == len(w) and all(map(_approx_equal, g, w))
    return g == w


def assert_parity(raw, aggs=BUILTIN_AGGS, gap_ms=500, check_cycles=True):
    """The port's vectorized operator: rows and emission cycles equal the
    JAX package's vectorized operator exactly, and the port's reference
    operator's to the JAX test's rel=1e-9 (and the same sessions closing
    in the same cycles)."""
    tc, tr, _ = drive("torch", False, raw, aggs, gap_ms)
    jc, jr, _ = drive("jax", False, raw, aggs, gap_ms)
    assert (tc, tr) == (jc, jr)
    rc, rr, _ = drive("torch", True, raw, aggs, gap_ms)
    got = sorted(tr, key=lambda r: (r[0], r[-2], r[-1]))
    want = sorted(rr, key=lambda r: (r[0], r[-2], r[-1]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _approx_equal(g, w), (g, w)
    if check_cycles:
        assert tc == rc


def gen_items(seed, n_batches=6, keys=("a", "b", "c", "d"), with_hints=False,
              nulls=False):
    """test_session_vectorized.py's seeded workload: bursty per-key
    traffic, out-of-order rows (down to late), occasional idle hints."""
    rng = np.random.default_rng(seed)
    items = []
    base = 0
    for _ in range(n_batches):
        n = int(rng.integers(1, 40))
        base += int(rng.integers(0, 900))
        offs = rng.integers(-1500, 900, n)
        ts = np.sort(np.maximum(0, base + offs) + T0)
        ks = rng.choice(np.asarray(keys, object), n)
        vs = rng.normal(50.0, 10.0, n)
        vmask = rng.random(n) > 0.25 if nulls else None
        items.append(braw(ts, ks, vs, vmask))
        if with_hints and rng.random() < 0.4:
            items.append(("h", T0 + base + int(rng.integers(0, 500))))
    return items


@pytest.mark.parametrize("seed", range(12))
def test_differential_builtin_aggregates(seed):
    assert_parity(gen_items(seed))


@pytest.mark.parametrize("seed", range(12, 18))
def test_differential_with_null_values(seed):
    assert_parity(gen_items(seed, nulls=True))


@pytest.mark.parametrize("seed", range(18, 24))
def test_differential_with_idle_hints(seed):
    assert_parity(gen_items(seed, with_hints=True))


@pytest.mark.parametrize("seed", range(24, 30))
def test_differential_udaf_sessions(seed):
    """Accumulator sessions: arrays (their order included), first/last,
    median and count exactly equal across the port's two operators and
    the JAX package's vectorized one, in the same emission cycles."""
    raw = gen_items(seed, keys=("a", "b"))
    tc, tr, _ = drive("torch", False, raw, UDAF_AGGS)
    jc, jr, _ = drive("jax", False, raw, UDAF_AGGS)
    rc, rr, _ = drive("torch", True, raw, UDAF_AGGS)
    assert (tc, tr) == (jc, jr)
    key = lambda r: (r[0], r[-2], r[-1])  # noqa: E731
    assert sorted(tr, key=key) == sorted(rr, key=key)
    assert tc == rc


def test_differential_high_cardinality_segments():
    rng = np.random.default_rng(99)
    keys = [f"k{i}" for i in range(300)]
    items = []
    base = 0
    for _ in range(4):
        n = 600
        base += 700
        ts = np.sort(T0 + base + rng.integers(-800, 800, n))
        ks = rng.choice(np.asarray(keys, object), n)
        items.append(braw(ts, ks, rng.normal(0, 1, n)))
    assert_parity(items, gap_ms=300)


def test_differential_multi_open_session_bridges():
    items = [
        braw([T0 + 1000, T0 + 4000, T0 + 1100, T0 + 4100],
             ["a", "a", "b", "b"], [1.0, 4.0, 1.0, 4.0]),
        braw([T0 + 2500, T0 + 2600], ["a", "b"], [2.5, 2.6]),
        braw([T0 + 20_000], ["z"], [0.0]),
    ]
    assert_parity(items, gap_ms=2000)


def test_differential_late_salvage_chain():
    items = [
        braw([T0 + 100_000], ["a"], [1.0]),
        braw([T0 + 105_000], ["w"], [0.0]),
        braw([T0 + 91_000, T0 + 82_000, T0 + 106_000], ["a", "a", "w"],
             [5.0, 3.0, 0.0]),
        braw([T0 + 125_000], ["w"], [0.0]),
    ]
    assert_parity(items, gap_ms=10_000)


def test_gid_reuse_after_close():
    items = [
        braw([T0 + 100, T0 + 200], ["a", "a"], [1.0, 2.0]),
        braw([T0 + 5000], ["b"], [10.0]),
        braw([T0 + 5100, T0 + 5200], ["c", "a"], [7.0, 3.0]),
        braw([T0 + 50_000], ["w"], [0.0]),
    ]
    assert_parity(items)
    _, _, op = drive("torch", False, items)
    _, _, jop = drive("jax", False, items)
    # keys ever seen: a, b, c, a again, w — a's first gid was recycled
    assert op._interner.capacity == jop._interner.capacity <= 4


@pytest.mark.parametrize("pkg", PKGS)
def test_recycling_interner_unit(pkg):
    it = api(pkg).Recycling(1)
    g1 = it.intern([np.asarray(["a", "b", "a"], object)])
    assert g1.tolist() == [0, 1, 0]
    it.release(np.asarray([0]))
    assert len(it) == 1
    g2 = it.intern([np.asarray(["c", "b"], object)])
    assert g2.tolist() == [0, 1]
    assert [x.tolist() for x in it.keys_of(np.asarray([0, 1]))] == [["c", "b"]]
    it.release(np.asarray([0, 0]))
    g3 = it.intern([np.asarray(["a"], object)])
    assert g3.tolist() == [0]


@pytest.mark.parametrize("pkg", PKGS)
def test_recycling_interner_multi_column(pkg):
    it = api(pkg).Recycling(2)
    g = it.intern(
        [np.asarray(["x", "y", "x"], object), np.asarray([1, 2, 1], np.int64)]
    )
    assert g.tolist() == [0, 1, 0]
    it.release(np.asarray([1]))
    g2 = it.intern(
        [np.asarray(["y", "y"], object), np.asarray([3, 2], np.int64)]
    )
    assert sorted(g2.tolist()) == [1, 2]
    assert it.capacity == 3 and len(it) == 3
    ka, kb = it.keys_of(np.asarray([g2[0], g2[1]]))
    assert ka.tolist() == ["y", "y"] and kb.tolist() == [3, 2]


def test_recycling_interner_takes_the_string_column_lane():
    """Live keys arrive as StringColumns: the recycling interner interns
    them off their offsets and bytes (the column interner's lane, as the
    GroupInterner does) and gives the ids the object column gets."""
    vals = ["sensor_1", "sensor_2", "sensor_1", "x", "sensor_2"]
    a, b = RecyclingGroupInterner(1), RecyclingGroupInterner(1)
    ga = a.intern([StringColumn.from_objects(np.asarray(vals, object))])
    gb = b.intern([np.asarray(vals, object)])
    assert ga.tolist() == gb.tolist() == [0, 1, 0, 2, 1]
    assert a.lanes == b.lanes
    a.release(np.asarray([1]))
    g2 = a.intern([StringColumn.from_objects(np.asarray(["y", "x"], object))])
    assert g2.tolist() == [1, 2]
    assert a.keys_of(np.asarray([0, 1, 2]))[0].tolist() == [
        "sensor_1", "y", "x"]


def test_builtin_path_does_no_per_row_python():
    rng = np.random.default_rng(3)
    items, base = [], 0
    for _ in range(6):
        n = int(rng.integers(10, 60))
        ts = np.sort(T0 + base + rng.integers(0, 800, n))
        base = int(ts.max()) - T0
        ks = rng.choice(np.asarray(["a", "b", "c"], object), n)
        items.append(braw(ts, ks, rng.normal(0, 1, n)))
    _, _, op = drive("torch", False, items)
    _, _, jop = drive("jax", False, items)
    m = op.metrics()
    assert m == jop.metrics()
    assert m["rows_in"] == sum(len(it[1]) for it in items)
    assert m["late_rows"] == 0 and m["salvage_rows_scanned"] == 0


def test_salvage_scope_is_late_keys_only():
    items = [
        braw([T0 + 100], ["a"], [1.0]),
        braw([T0 + 10_000], ["b"], [1.0]),
        braw([T0 + 200] + [T0 + 10_500 + i for i in range(50)],
             ["a"] + ["c"] * 50, [9.9] * 51),
    ]
    _, _, op = drive("torch", False, items, gap_ms=1000)
    assert op.metrics()["salvage_rows_scanned"] == 1


def test_nan_group_keys_form_one_session():
    def run_counts(pkg, raw):
        p = api(pkg)
        _, rows, _ = drive(pkg, False, raw,
                           lambda F, c: [F.count(c("v")).alias("c")], 100,
                           key_type=p.DT.FLOAT64)
        return sorted(r[1] for r in rows)

    one = [("b", np.asarray([T0, T0 + 10, T0 + 20]),
            np.asarray([np.nan, np.nan, 1.0]), np.ones(3), None)]
    cross = [("b", np.asarray([T0]), np.asarray([np.nan]), np.ones(1), None),
             ("b", np.asarray([T0 + 50]), np.asarray([np.nan]), np.ones(1),
              None)]
    for pkg in PKGS:
        assert run_counts(pkg, one) == [1, 2]
        assert run_counts(pkg, cross) == [2]


def test_no_composite_hash_collisions():
    keys = [f"key_{i}" for i in range(2000)]
    rng = np.random.default_rng(5)
    n = 4000
    ks = rng.choice(np.asarray(keys, object), n)
    ts = np.sort(T0 + rng.integers(0, 200, n))
    items = [braw(ts, ks, np.ones(n)), braw([T0 + 100_000], ["w"], [0.0])]
    aggs = lambda F, c: [F.count(c("v")).alias("c")]  # noqa: E731
    _, rows, _ = drive("torch", False, items, aggs)
    _, jrows, _ = drive("jax", False, items, aggs)
    assert rows == jrows
    want: dict = {}
    for k in ks.tolist():
        want[k] = want.get(k, 0) + 1
    want["w"] = 1
    assert {r[0]: r[1] for r in rows} == want


# -- tests/test_session_out_of_order.py (the first five) --------------------


def _cnt_sum(F, c):
    return [F.count(c("v")).alias("cnt"), F.sum(c("v")).alias("s")]


def test_out_of_order_does_not_split_session():
    raw = [
        ([T0 + 1000, T0 + 2000], ["a", "w"], [1.0, 0.0]),
        ([T0 + 20_000, T0 + 2100], ["a", "w"], [2.0, 0.0]),
        ([T0 + 5000, T0 + 2200], ["a", "w"], [4.0, 0.0]),
    ]
    res = both(raw, _cnt_sum, 10_000)
    a = sorted(
        (int(res.column("window_start_time")[i]) - T0,
         int(res.column("cnt")[i]), float(res.column("s")[i]))
        for i in range(res.num_rows) if res.column("k")[i] == "a"
    )
    assert a == [(1000, 2, 5.0), (20_000, 1, 2.0)]


def test_bridging_segment_merges_open_sessions():
    raw = [([T0 + 1000, T0 + 4000], ["a", "a"], [1.0, 4.0]),
           ([T0 + 2500], ["a"], [2.5])]
    res = both(raw, _cnt_sum, 2000)
    assert res.num_rows == 1
    assert int(res.column("cnt")[0]) == 3
    assert float(res.column("s")[0]) == 7.5
    assert int(res.column("window_start_time")[0]) == T0 + 1000
    assert int(res.column("window_end_time")[0]) == T0 + 4000 + 2000


def test_session_late_rows_dropped_and_counted():
    raw = [([T0 + 100], ["a"], [1.0]), ([T0 + 10_000], ["b"], [1.0]),
           ([T0 + 200], ["a"], [99.0])]
    res = both(raw, lambda F, c: [F.sum(c("v")).alias("s")], 1000)
    by_key = {res.column("k")[i]: float(res.column("s")[i])
              for i in range(res.num_rows)}
    assert by_key["a"] == 1.0


def _a_row(res):
    i = list(res.column("k")).index("a")
    return (int(res.column("cnt")[i]), float(res.column("s")[i]),
            int(res.column("window_start_time")[i]) - T0,
            int(res.column("window_end_time")[i]) - T0)


def test_session_late_row_merging_open_session_is_kept():
    raw = [
        ([T0 + 100_000], ["a"], [1.0]),
        ([T0 + 105_000], ["w"], [0.0]),
        ([T0 + 90_000, T0 + 106_000], ["a", "w"], [5.0, 0.0]),
        ([T0 + 125_000], ["w"], [0.0]),
    ]
    assert _a_row(both(raw, _cnt_sum, 10_000)) == (2, 6.0, 90_000, 110_000)


def test_session_late_chain_to_open_session_is_kept():
    raw = [
        ([T0 + 100_000], ["a"], [1.0]),
        ([T0 + 105_000], ["w"], [0.0]),
        ([T0 + 91_000, T0 + 82_000, T0 + 106_000], ["a", "a", "w"],
         [5.0, 3.0, 0.0]),
        ([T0 + 125_000], ["w"], [0.0]),
    ]
    assert _a_row(both(raw, _cnt_sum, 10_000))[:3] == (3, 9.0, 82_000)


# -- tests/test_session_properties.py ---------------------------------------


@settings(max_examples=30, deadline=None, derandomize=True)
@given(session_case())
def test_session_engine_matches_oracle(case):
    gap, raw = case
    res = both(raw, _cnt_sum, gap)
    got = {}
    for i in range(res.num_rows):
        key = (res.column("k")[i], int(res.column("window_start_time")[i]))
        assert key not in got, f"duplicate session {key}"
        got[key] = (int(res.column("window_end_time")[i]),
                    int(res.column("cnt")[i]),
                    round(float(res.column("s")[i]), 4))
    assert got == session_oracle(raw, gap)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(partitioned_session_case())
def test_partitioned_session_replay_is_lossless(case):
    gap, parts = case
    got = {}
    for pkg in PKGS:
        p = api(pkg)
        res = (
            p.ctx().from_source(p.Source(
                [[kv(p, *b) for b in part] for part in parts],
                timestamp_column="ts"))
            .session_window(["k"], _cnt_sum(p.F, p.col), gap_ms=gap)
            .collect()
        )
        got[pkg] = {
            (res.column("k")[i], int(res.column("window_start_time")[i])): (
                int(res.column("window_end_time")[i]),
                int(res.column("cnt")[i]),
                round(float(res.column("s")[i]), 4))
            for i in range(res.num_rows)
        }
    rows_by_key: dict = {}
    for part in parts:
        for ts, ks, vs in part:
            for t, k, v in zip(ts, ks, vs):
                rows_by_key.setdefault(k, []).append((t, v))
    want = {}
    for k, rows in rows_by_key.items():
        rows.sort()
        seg = [rows[0]]
        for t, v in rows[1:] + [(None, None)]:
            if t is not None and t - seg[-1][0] <= gap:
                seg.append((t, v))
                continue
            want[(k, seg[0][0])] = (seg[-1][0] + gap, len(seg),
                                    round(sum(x[1] for x in seg), 4))
            seg = [(t, v)]
    assert got["torch"] == got["jax"] == want


@settings(max_examples=40, deadline=None, derandomize=True)
@given(session_case())
def test_vectorized_matches_reference_operator(case):
    gap, raw = case
    assert_parity([braw(ts, ks, vs) for ts, ks, vs in raw], gap_ms=gap)


# -- tests/test_session_checkpoint_soa.py -----------------------------------

SESSION_GAP_MS = 300


def _burst_ts(ts):
    """tools/soak.py burst_ts: each second's events in its first 600 ms."""
    sec = (ts // 1000) * 1000
    return sec + ((ts - sec) * 3) // 5


def soa_raw(n_batches=14, rows=400, n_keys=7, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        base = T0 + b * 250
        ts = np.sort(_burst_ts(base + rng.integers(0, 250, rows)))
        ks = [f"sensor_{i}" for i in rng.integers(0, n_keys, rows)]
        out.append((ts, ks, rng.normal(50.0, 10.0, rows)))
    return out


def _soa_pipeline(raw):
    def pipeline(p, ctx):
        return ctx.from_source(
            p.Source.from_batches([kv(p, *b) for b in raw],
                                  timestamp_column="ts"), name="soa_ckpt",
        ).session_window(
            ["k"],
            [p.F.count(p.col("v")).alias("count"),
             p.F.min(p.col("v")).alias("min"),
             p.F.max(p.col("v")).alias("max"),
             p.F.avg(p.col("v")).alias("average"),
             p.F.stddev(p.col("v")).alias("sd")],
            SESSION_GAP_MS,
        )
    return pipeline


def _keyed(rows):
    return {(r[0], r[-2], r[-1]): r for r in rows}


def test_soa_session_store_kill_restore_byte_identical(tmp_path):
    """The union of the killed and the restored run equals the
    uninterrupted run EXACTLY, and the uninterrupted run equals the JAX
    package's."""
    raw = soa_raw()
    pipeline = _soa_pipeline(raw)
    golden = {pkg: _keyed(table(pipeline(api(pkg), api(pkg).ctx())
                                .collect())) for pkg in PKGS}
    assert golden["torch"] == golden["jax"]
    a, b = _kill_restore(api("torch"), str(tmp_path / "state"), pipeline, 2)
    combined = _keyed(a)
    combined.update(_keyed(b))
    assert combined == golden["torch"]


@pytest.mark.parametrize("writer,reader", [
    ("vectorized", "reference"), ("reference", "vectorized"),
    ("jax", "torch"), ("torch", "jax"),
])
def test_soa_snapshot_interoperates_with_reference(tmp_path, monkeypatch,
                                                    writer, reader):
    """A snapshot restores into the other operator (the port's vectorized
    and reference operators, both ways) and into the other package (both
    ways): the same sessions, exact count/min/max and bounds, avg to
    1e-12 and sd to 1e-9 relative, the JAX test's bar for a restore
    across operators (they fold floats in different orders)."""
    raw = soa_raw(rows=120, n_keys=4, seed=3)
    pipeline = _soa_pipeline(raw)
    golden = _keyed(table(pipeline(api("torch"), api("torch").ctx())
                          .collect()))
    path = str(tmp_path / "state")
    pkg_a = "jax" if writer == "jax" else "torch"
    pkg_b = "jax" if reader == "jax" else "torch"

    def use(mode):
        if mode == "reference":
            monkeypatch.setenv("DENORMALIZED_SESSION_REFERENCE", "1")
        else:
            monkeypatch.delenv("DENORMALIZED_SESSION_REFERENCE",
                               raising=False)

    use(writer)
    rows_a, _ = _kill_restore_first_half(api(pkg_a), path, pipeline)
    use(reader)
    p = api(pkg_b)
    try:
        rows_b = table(pipeline(p, p.ctx(
            checkpoint=True, checkpoint_interval_s=9999,
            state_backend_path=path)).collect())
    finally:
        p.close()
    got = _keyed(rows_a)
    got.update(_keyed(rows_b))
    assert set(got) == set(golden)
    for k, w in golden.items():
        g = got[k]
        assert g[:4] == w[:4], k  # key, count, min, max
        assert abs(g[4] - w[4]) <= 1e-12 * max(1.0, abs(w[4])), k
        assert abs(g[5] - w[5]) <= 1e-9 * max(1.0, abs(w[5])), k


def _kill_restore_first_half(p, path, pipeline):
    cfg = dict(checkpoint=True, checkpoint_interval_s=9999,
               state_backend_path=path)
    ctx = p.ctx(**cfg)
    root = p.executor.build_physical(
        p.lp.Sink(pipeline(p, ctx)._plan, p.Sink()), ctx)
    orch = p.Orch(interval_s=9999)
    coord = p.wire(root, ctx, orch)
    rows = []
    it = root.run()
    try:
        for i, item in enumerate(it):
            if isinstance(item, p.Batch):
                rows += table(item)
            if i == 0:
                orch.trigger_now()
            if isinstance(item, p.base.Marker):
                coord.commit(item.epoch)
                break
    finally:
        it.close()
        p.close()
    return rows, coord


# -- the rest of the surface ------------------------------------------------


@pytest.mark.parametrize("reference", [False, True])
def test_session_reference_switch_through_context(monkeypatch, reference):
    """``DENORMALIZED_SESSION_REFERENCE=1`` (the JAX package's switch)
    plans the reference operator in both packages, with the same rows."""
    if reference:
        monkeypatch.setenv("DENORMALIZED_SESSION_REFERENCE", "1")
    else:
        monkeypatch.delenv("DENORMALIZED_SESSION_REFERENCE", raising=False)
    raw = [(ts, ks, vs) for _, ts, ks, vs, _m in gen_items(5)]
    res = both(raw, BUILTIN_AGGS, 500)
    assert res.num_rows > 0
    p = api("torch")
    ds = p.ctx().from_source(p.Source.from_batches(
        [kv(p, *b) for b in raw], timestamp_column="ts")).session_window(
        ["k"], [TF.count(tt.col("v"))], 500)
    from denormalized_tpu_torch.planner.planner import Planner

    op = Planner(ds._ctx.config).create_physical_plan(ds._plan)
    assert type(op) is (ReferenceSessionWindowExec if reference
                        else SessionWindowExec)


@pytest.mark.parametrize("kind", ["session", "udaf", "window"])
def test_emit_on_close_off_as_the_jax_package(kind):
    """``EngineConfig(emit_on_close=False)``: end of stream emits only
    what the watermark closed — the same rows as the JAX package, fewer
    than with the flush."""
    raw = [(ts, ks, vs) for _, ts, ks, vs, _m in gen_items(7)]
    res = {}
    for pkg in PKGS:
        p = api(pkg)
        for flush in (True, False):
            ds = p.ctx(emit_on_close=flush).from_source(
                p.Source.from_batches([kv(p, *b) for b in raw],
                                      timestamp_column="ts"))
            c = p.col
            if kind == "session":
                ds = ds.session_window(["k"], [p.F.count(c("v"))], 500)
            elif kind == "udaf":
                ds = ds.window(["k"], [p.F.median(c("v")),
                                       p.F.count(c("v"))], 1000)
            else:
                ds = ds.window(["k"], [p.F.count(c("v")),
                                       p.F.max(c("v"))], 1000)
            res[(pkg, flush)] = table(ds.collect())
    assert res[("torch", False)] == res[("jax", False)]
    assert res[("torch", True)] == res[("jax", True)]
    assert len(res[("torch", False)]) < len(res[("torch", True)])


def test_feast_data_stream_session_window():
    from denormalized_tpu_torch.api.feast_data_stream import FeastDataStream

    p = api("torch")
    raw = [(ts, ks, vs) for _, ts, ks, vs, _m in gen_items(9)]
    ds = p.ctx().from_source(p.Source.from_batches(
        [kv(p, *b) for b in raw], timestamp_column="ts"))
    fds = FeastDataStream(ds._plan, ds._ctx).session_window(
        ["k"], [TF.count(tt.col("v")).alias("cnt")], 500)
    assert isinstance(fds, FeastDataStream)
    want = run_session(api("jax"), raw,
                       lambda F, c: [F.count(c("v")).alias("cnt")], 500)
    assert table(fds.collect()) == table(want)


def test_session_window_over_the_mock_broker():
    """The live path: a 2-partition JSON topic (keys decode to
    StringColumns) → session_window → stream, in both packages over their
    own broker holding the same records.  Every session the idle hint can
    close (last + gap <= max ts) arrives, with the rows of an interval
    oracle over all records, the same in both packages."""
    from denormalized_tpu.testing.mock_kafka import (
        MockKafkaBroker as JBroker,
    )
    from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker

    rng = np.random.default_rng(13)
    n = 3000
    ts = np.sort(_burst_ts(T0 + rng.integers(0, 6000, n)))
    ks = np.asarray([f"sensor_{i}" for i in rng.integers(0, 8, n)], object)
    vs = np.round(rng.normal(20, 5, n), 3)
    msgs = [json.dumps({"occurred_at_ms": int(t), "sensor_name": k,
                        "reading": float(v)}).encode()
            for t, k, v in zip(ts, ks, vs)]
    max_ts = int(ts.max())
    want = {}
    for k in sorted(set(ks.tolist())):
        sel = ks == k
        kt, kv_ = ts[sel], vs[sel]
        cut = np.nonzero(np.diff(kt) > SESSION_GAP_MS)[0] + 1
        for st, sv in zip(np.split(kt, cut), np.split(kv_, cut)):
            end = int(st[-1]) + SESSION_GAP_MS
            if end <= max_ts:
                want[(k, int(st[0]))] = (len(st), float(sv.max()), end)
    out = {}
    for pkg, broker_cls in (("torch", MockKafkaBroker), ("jax", JBroker)):
        p = api(pkg)
        broker = broker_cls().start()
        try:
            broker.create_topic("sessions", partitions=2)
            for part in range(2):
                broker.produce("sessions", part, msgs[part::2], ts_ms=T0)
            ds = p.ctx(source_idle_timeout_ms=300).from_topic(
                "sessions",
                sample_json=json.dumps({"occurred_at_ms": 1,
                                        "sensor_name": "a",
                                        "reading": 1.0}),
                bootstrap_servers=broker.bootstrap,
                timestamp_column="occurred_at_ms",
            ).session_window(
                ["sensor_name"],
                [p.F.count(p.col("reading")).alias("n"),
                 p.F.max(p.col("reading")).alias("mx"),
                 p.F.median(p.col("reading")).alias("med")],
                SESSION_GAP_MS,
            )
            rows = {}
            it = ds.stream()
            deadline = time.time() + 30
            for batch in it:
                for r in table(batch):
                    rows[(r[0], r[-2])] = r
                if set(want) <= set(rows) or time.time() > deadline:
                    break
            it.close()
            out[pkg] = {k: rows[k] for k in want if k in rows}
        finally:
            broker.stop()
    assert set(out["torch"]) == set(want)
    assert out["torch"] == out["jax"]
    for k, (cnt, mx, end) in want.items():
        r = out["torch"][k]
        assert (r[1], r[2], r[-1]) == (cnt, mx, end), k


def test_cold_tier_spills_and_restores_like_the_jax_package(tmp_path):
    """The cold tier: under a budget the session job's cold keys spill to
    the LSM and reload, the rows equal the unbudgeted run's and the JAX
    package's, with the same spill and reload counts.  Then a snapshot
    referencing a spilled block of open sessions restores in both packages
    — with a tier (the block re-seeded into the spill namespace, its key
    kept out of gid recycling) and without one (the sessions load back
    into the table) — and the restored run's rows are the same."""
    from denormalized_tpu.planner.planner import Planner as JPlanner
    from denormalized_tpu.state import tiering as jtier
    from denormalized_tpu.state.lsm import LsmStore as JLsm

    from denormalized_tpu_torch.planner.planner import Planner as TPlanner
    from denormalized_tpu_torch.state import tiering as ttier
    from denormalized_tpu_torch.state.lsm import LsmStore as TLsm
    from denormalized_tpu_torch.state.serialization import pack_snapshot

    rng = np.random.default_rng(21)
    raw = []
    for b in range(12):
        ts = np.sort(T0 + b * 250 + rng.integers(0, 250, 200))
        raw.append((ts, [f"k{i}" for i in rng.integers(0, 300, 200)],
                    rng.normal(50, 10, 200)))

    def aggs(F, c):
        return [F.count(c("v")).alias("n"), F.max(c("v")).alias("mx")]

    got, stats = {}, {}
    for pkg in PKGS:
        p = api(pkg)
        for budget in (None, 12_000):
            cfg = {} if budget is None else dict(
                state_backend_path=str(tmp_path / pkg),
                state_budget_bytes=budget)
            ctx = p.ctx(**cfg)
            res = ctx.from_source(p.Source.from_batches(
                [kv(p, *b) for b in raw], timestamp_column="ts"),
            ).session_window(["k"], aggs(p.F, p.col), 300).collect()
            got[pkg, budget] = table(res)
            if budget is not None:
                node = next(iter(ctx._last_spill._stats))
                stats[pkg] = ctx._last_spill.spill_stats(node)
                p.close()
    assert got["torch", 12_000] == got["torch", None] == got["jax", 12_000]
    assert stats["torch"]["spill_blocks_total"] > 0
    assert stats["torch"] == stats["jax"]

    key = "session_1_SessionWindowExec"
    one = np.ones((1, 1))
    block = pack_snapshot(
        {"keys": [["cold"]], "accs": None, "n": 1, "min_start": T0 - 100,
         "min_last": T0 - 50, "max_last": T0 - 50},
        {"start": np.asarray([T0 - 100]), "last": np.asarray([T0 - 50]),
         "row_count": np.asarray([2]), "counts": 2 * one.astype(np.int64),
         "sums": 9.0 * one, "mins": 4.0 * one, "maxs": 5.0 * one,
         "means": 4.5 * one, "m2s": 0.5 * one,
         "owner": np.zeros(1, np.int32)})

    class Coord:
        def get_snapshot(self, k):
            if k == f"{key}:spill:b0":
                return block
            return json.dumps({"epoch": 1, "watermark": T0 - 400,
                               "sessions": [], "spill_blocks": [0]}).encode()

    restored = {}
    for pkg, Lsm, tier, Planner in (("jax", JLsm, jtier, JPlanner),
                                    ("torch", TLsm, ttier, TPlanner)):
        p = api(pkg)
        for with_tier in (False, True):
            ds = p.ctx().from_source(p.Source.from_batches(
                [kv(p, *b) for b in raw[:2]], timestamp_column="ts"),
            ).session_window(["k"], aggs(p.F, p.col), 300)
            op = Planner(ds._ctx.config).create_physical_plan(ds._plan)
            store = ctrl = None
            if with_tier:
                store = Lsm(str(tmp_path / f"restore_{pkg}"))
                ctrl = tier.SpillController(store, budget_bytes=1 << 20)
                op.enable_spill("1_SessionWindowExec", ctrl)
            op.enable_checkpointing("1_SessionWindowExec", Coord(), None)
            if with_tier:
                assert op._tier.any_spilled and op._tier.spilled_keys == 1
            out = []
            for item in op.run():
                if isinstance(item, p.Batch):
                    out.extend(table(item))
            if with_tier:
                ctrl.close()
                store.close()
            restored[pkg, with_tier] = out
    cold = [r for r in restored["torch", False] if r[0] == "cold"]
    assert [r[1:3] for r in cold] == [(2, 5.0)]
    assert len({tuple(v) for v in restored.values()}) == 1

