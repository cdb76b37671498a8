"""The port's multi-query runtime (``runtime/multi_query.py`` over
``physical/slice_exec.py``) held against the JAX package on the same seeded
batches.

Twins of ``tests/test_multi_query.py``: ``run_queries`` at Q = 10 over
bench.py's ``multi_query`` spec cycle (8 sliding specs, 5 s to 60 s
windows, 1-10 s slides, count/sum/avg), every member's rows against the
JAX package's and against an independent slice oracle pinned to the
group's unit; the report against the JAX package's (``query_ids`` count
alike, the ids themselves are each process's doctor counters); a variance group (the pivot); mixed
aggregates (an add-only member of a group whose union carries extrema);
the fallbacks (a UDAF query and a query over another source run through
the port's normal executor); ``sharing=False``; the
``slice_windows=True`` single-query path (tumbling, sliding, nulls)
against the JAX package's slice path and against the device ring on the
CPU; and ``approx_native`` on and off.

Tolerance: shared, single-subscriber and oracle rows are host float64
folds in both packages, so they are compared EXACTLY (``==``, NaN equal to
NaN).  The fallback queries run the port's normal executor: the device
window's f32 ring against the JAX package's f32 ring is held to rtol=1e-5
(counts, keys and windows exact), the UDAF operator exactly; the slice
path against the f32 ring likewise to rtol=1e-5.
"""

from __future__ import annotations

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
from denormalized_tpu.runtime.multi_query import run_queries as jrun
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.runtime.multi_query import run_queries as trun
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000
SPEC_CYCLE = [
    (5_000, 1_000), (10_000, 1_000), (30_000, 5_000), (10_000, 2_000),
    (60_000, 10_000), (15_000, 3_000), (20_000, 4_000), (8_000, 2_000),
]

PKG = {
    "jax": dict(col=jt.col, F=JF, run=jrun, Schema=JSchema, Field=JField,
                DT=JType, Batch=JBatch, Source=JSource,
                ctx=lambda **kw: jt.Context(JConfig(**kw))),
    "torch": dict(col=tt.col, F=TF, run=trun, Schema=TSchema, Field=TField,
                  DT=TType, Batch=TBatch, Source=TSource,
                  ctx=lambda **kw: tt.Context(
                      tt.EngineConfig(device="cpu", **kw))),
}


def _raw(seed=3, n_batches=40, rows=600, n_keys=16, null_frac=0.0,
         ms_per_batch=1000):
    """bench.py's gen_batches shape (sorted event times a batch, keys
    ``sensor_<i>``, readings N(50, 10)) at a test's size."""
    rng = np.random.default_rng(seed)
    keys = np.array([f"sensor_{i}" for i in range(n_keys)], object)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * ms_per_batch
                     + rng.integers(0, ms_per_batch, rows))
        names = keys[rng.integers(0, n_keys, rows)]
        vals = rng.normal(50.0, 10.0, rows)
        valid = rng.random(rows) >= null_frac
        out.append((ts, names, vals, valid))
    return out


def _source(a, raw):
    schema = a["Schema"]([
        a["Field"]("occurred_at_ms", a["DT"].INT64, nullable=False),
        a["Field"]("sensor_name", a["DT"].STRING, nullable=False),
        a["Field"]("reading", a["DT"].FLOAT64),
    ])
    return a["Source"].from_batches(
        [a["Batch"](schema, [ts, ks, vs],
                    None if valid.all() else [None, None, valid])
         for ts, ks, vs, valid in raw],
        timestamp_column="occurred_at_ms",
    )


def _cell(x):
    if isinstance(x, (list, tuple)):
        return tuple(_cell(p) for p in x)
    if isinstance(x, (float, np.floating)):
        return "nan" if x != x else float(x)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


def _rows(batches, names):
    out = []
    for b in batches:
        for i in range(b.num_rows):
            out.append(tuple(_cell(b.column(n)[i]) for n in names))
    return out


AGG_SETS = {
    "bench": lambda F, c: [F.count(c("reading")).alias("c"),
                           F.sum(c("reading")).alias("s"),
                           F.avg(c("reading")).alias("av")],
    "extrema": lambda F, c: [F.count(c("reading")).alias("c"),
                             F.min(c("reading")).alias("mn"),
                             F.max(c("reading")).alias("mx"),
                             F.avg(c("reading")).alias("av")],
    "variance": lambda F, c: [F.count(c("reading")).alias("c"),
                              F.stddev(c("reading")).alias("sd"),
                              F.var_pop(c("reading")).alias("vp")],
}


def _names(aggs):
    return ["sensor_name"] + [a.name for a in aggs] + [
        "window_start_time", "window_end_time"]


def _run_group(pkg, raw, n_q, agg_sets, sharing=True, **cfg):
    """Q queries cycling the bench's specs over ONE base DataStream (the
    share key is the scan's source identity) → (report, rows per query)."""
    a = PKG[pkg]
    ctx = a["ctx"](**cfg)
    base = ctx.from_source(_source(a, raw), name="mq_feed")
    outs = [[] for _ in range(n_q)]
    queries, names = [], []
    for i in range(n_q):
        aggs = AGG_SETS[agg_sets[i % len(agg_sets)]](a["F"], a["col"])
        L, S = SPEC_CYCLE[i % len(SPEC_CYCLE)]
        queries.append((base.window(["sensor_name"], aggs, L, S),
                        outs[i].append))
        names.append(_names(aggs))
    rep = a["run"](ctx, queries, sharing=sharing)
    return rep, [_rows(o, n) for o, n in zip(outs, names)]


def _strip_ids(rep):
    return {**rep, "groups": [
        {k: v for k, v in g.items() if k != "query_ids"} for g in rep["groups"]
    ]}


def _oracle(raw, agg_set, L, S, **cfg):
    a = PKG["torch"]
    aggs = AGG_SETS[agg_set](a["F"], a["col"])
    ds = a["ctx"](slice_windows=True, **cfg).from_source(
        _source(a, raw), name="mq_feed"
    ).window(["sensor_name"], aggs, L, S)
    return _rows(list(ds.stream()), _names(aggs))


@pytest.mark.parametrize("agg_sets", [("bench",), ("variance",),
                                      ("bench", "extrema")])
def test_run_queries_q10_equals_jax_and_oracles(agg_sets):
    raw = _raw()
    rep_j, rows_j = _run_group("jax", raw, 10, agg_sets)
    rep_t, rows_t = _run_group("torch", raw, 10, agg_sets)
    ids_t = rep_t["groups"][0]["query_ids"]
    assert len(set(ids_t)) == len(rep_j["groups"][0]["query_ids"]) == 10
    assert _strip_ids(rep_t) == _strip_ids(rep_j)
    assert rep_t["shared_queries"] == 10
    assert rep_t["groups"][0]["unit_ms"] == 1000
    assert all(rows_j), [len(r) for r in rows_j]
    for q in range(10):
        assert rows_t[q] == rows_j[q], f"query {q}"
    # each member against its own from-start slice oracle, pinned to the
    # group's unit (and, in a mixed group, to the lexsort lane the union's
    # extrema force on its add-only members); no stddev in this check: the
    # variance pivot is chosen from the first rows the store SEES
    mixed = len(agg_sets) > 1
    for q in range(10):
        agg_set = agg_sets[q % len(agg_sets)]
        if agg_set == "variance":
            continue
        L, S = SPEC_CYCLE[q % len(SPEC_CYCLE)]
        want = _oracle(raw, agg_set, L, S, slice_unit_ms=1000,
                       slice_sort_lane=mixed and agg_set == "bench")
        assert rows_t[q] == want, f"query {q} left its oracle"


def test_fallbacks_run_the_ports_normal_executor():
    """A UDAF query, a query over another source and a session query fall
    back; the shareable pair shares.  The ring fallback runs the port's
    device window (here its plain CPU version) against the JAX package's
    f32 ring at rtol=1e-5; the UDAF and session fallbacks are host code,
    exact."""
    raw = _raw(seed=5, n_batches=20)
    got = {}
    for pkg, a in PKG.items():
        F, c = a["F"], a["col"]
        ctx = a["ctx"]()
        base = ctx.from_source(_source(a, raw), name="mq_feed")
        other = ctx.from_source(_source(a, raw), name="other_feed")
        outs = [[] for _ in range(5)]
        bench = AGG_SETS["bench"](F, c)
        qs = [
            (base.window(["sensor_name"], bench, 5000, 1000), outs[0].append),
            (base.window(["sensor_name"], bench, 10000, 2000),
             outs[1].append),
            (base.window(["sensor_name"],
                         [F.median(c("reading")).alias("med")], 3000, 1000),
             outs[2].append),
            (other.filter(c("reading") > 45.0).window(
                ["sensor_name"], bench, 4000, 2000), outs[3].append),
            (base.session_window(["sensor_name"],
                                 [F.count(c("reading")).alias("c")], 700),
             outs[4].append),
        ]
        rep = a["run"](ctx, qs)
        names = [_names(bench), _names(bench),
                 _names([F.median(c("reading")).alias("med")]),
                 _names(bench), None]
        rows = [_rows(outs[i], names[i]) for i in range(4)]
        rows.append(_rows(outs[4], ["sensor_name", "c", "window_start_time",
                                    "window_end_time"]))
        got[pkg] = (_strip_ids(rep), rows)
    (rep_j, rows_j), (rep_t, rows_t) = got["jax"], got["torch"]
    assert rep_t == rep_j
    assert [g["members"] for g in rep_t["groups"]] == [[0, 1], [2], [3], [4]]
    assert rep_t["independent_queries"] == 3
    for q in (0, 1, 2, 4):
        assert rows_t[q] == rows_j[q], f"query {q}"
    _close(rows_t[3], rows_j[3])


def _close(a, b, rtol=1e-5):
    """Rows equal in keys, windows and counts; floats within rtol."""
    assert len(a) == len(b) and a
    for ra, rb in zip(sorted(a), sorted(b)):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert x == pytest.approx(y, rel=rtol, abs=1e-9), (ra, rb)
            else:
                assert x == y, (ra, rb)


def test_sharing_off_equals_the_jax_package():
    raw = _raw(seed=9, n_batches=16)
    rep_j, rows_j = _run_group("jax", raw, 4, ("bench",), sharing=False)
    rep_t, rows_t = _run_group("torch", raw, 4, ("bench",), sharing=False)
    assert _strip_ids(rep_t) == _strip_ids(rep_j)
    assert rep_t["independent_queries"] == 4
    for q in range(4):
        _close(rows_t[q], rows_j[q])


# -- the single-query slice path ---------------------------------------------


@pytest.mark.parametrize("shape", ["sliding", "tumbling", "nulls"])
def test_slice_windows_single_query_path(shape):
    raw = _raw(seed=11, n_batches=20, null_frac=0.2 if shape == "nulls"
               else 0.0)
    L, S = (2000, None) if shape == "tumbling" else (3000, 1000)
    rows = {}
    for pkg, a in PKG.items():
        for cfg in ({"slice_windows": True}, {}):
            aggs = AGG_SETS["extrema"](a["F"], a["col"]) + [
                a["F"].stddev(a["col"]("reading")).alias("sd")]
            ds = a["ctx"](**cfg).from_source(
                _source(a, raw), name="feed"
            ).window(["sensor_name"], aggs, L, S)
            rows[pkg, bool(cfg)] = _rows(list(ds.stream()), _names(aggs))
    # the slice path: equal to the JAX package's, bit for bit
    assert rows["torch", True] == rows["jax", True]
    # against the f32 ring (the port's, on the CPU): counts exact
    _close(rows["torch", True], rows["torch", False], rtol=1e-4)


def test_slice_windows_plans_the_slice_operator():
    from denormalized_tpu_torch.physical.slice_exec import SliceWindowExec
    from denormalized_tpu_torch.physical.window_exec import (
        StreamingWindowExec,
    )
    from denormalized_tpu_torch.runtime.executor import build_physical

    a = PKG["torch"]
    raw = _raw(n_batches=2)
    for cfg, cls in (({"slice_windows": True, "slice_unit_ms": 500},
                      SliceWindowExec), ({}, StreamingWindowExec)):
        ctx = a["ctx"](**cfg)
        ds = ctx.from_source(_source(a, raw), name="feed").window(
            ["sensor_name"], AGG_SETS["bench"](a["F"], a["col"]), 3000, 1000
        )
        op = build_physical(ds._plan, ctx)
        assert isinstance(op, cls)
        if cls is SliceWindowExec:
            assert op.unit_ms == 500


@pytest.mark.parametrize("native", [True, False])
def test_approx_native_on_and_off_equal_the_jax_package(native):
    """The exact control of ``approx_scale``: with ``approx_native`` off
    the sketch kinds lower to their accumulators (the UDAF operator); on,
    they fold as sketch planes.  Either way the rows equal the JAX
    package's, and the exact columns ride along unchanged."""
    raw = _raw(seed=17, n_batches=10, rows=400, n_keys=4)
    rows = {}
    for pkg, a in PKG.items():
        F, c = a["F"], a["col"]
        aggs = [F.approx_distinct(c("reading")).alias("nd"),
                F.approx_median(c("reading")).alias("med"),
                F.approx_top_k(c("sensor_name"), 3).alias("top"),
                F.count(c("reading")).alias("c"),
                F.sum(c("reading")).alias("s")]
        ds = a["ctx"](slice_windows=True, slice_unit_ms=250,
                      approx_native=native).from_source(
            _source(a, raw), name="feed"
        ).window(["sensor_name"], aggs, 1000, 250)
        rows[pkg] = _rows(list(ds.stream()), _names(aggs))
    assert rows["torch"] and rows["torch"] == rows["jax"]


def test_approx_without_accumulator_refuses_with_the_reference_text():
    """An approximate aggregate whose accumulator is missing plans natively
    on the slice path and is refused elsewhere, with the JAX package's
    text."""
    from denormalized_tpu_torch.common.errors import PlanError
    from denormalized_tpu_torch.logical.expr import AggregateExpr
    from denormalized_tpu_torch.runtime.executor import build_physical

    a = PKG["torch"]
    raw = _raw(n_batches=2)
    agg = AggregateExpr("approx_distinct", a["col"]("reading"), "nd")
    assert agg.udaf is None
    ok = a["ctx"](slice_windows=True)
    build_physical(ok.from_source(_source(a, raw), name="feed").window(
        ["sensor_name"], [agg], 1000, None)._plan, ok)
    bad = a["ctx"]()
    with pytest.raises(PlanError, match="has no accumulator fallback and the "
                       "plan cannot take the slice path"):
        build_physical(bad.from_source(_source(a, raw), name="feed").window(
            ["sensor_name"], [agg], 1000, None)._plan, bad)


@pytest.mark.parametrize("field", ["slice_windows", "slice_unit_ms",
                                   "slice_sort_lane", "approx_native",
                                   "mq_subsumption"])
def test_engine_config_fields_defaults_and_set(field):
    """The five multi-query knobs: the JAX package's defaults, settable by
    their ``denormalized_config.`` names."""
    cfg = tt.EngineConfig(device="cpu")
    assert getattr(cfg, field) == getattr(JConfig(), field)
    value = 500 if field == "slice_unit_ms" else not getattr(cfg, field)
    cfg.set(f"denormalized_config.{field}", value)
    assert getattr(cfg, field) == value
