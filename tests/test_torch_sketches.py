"""The port's sketch kernels (``denormalized_tpu_torch/ops/sketches.py``)
held against the JAX package's on the same seeded numpy input.

Twins of ``tests/test_sketches.py``: the stable hash lanes (numeric,
datetime, object with ``None`` and a validity mask, and the port's
``StringColumn`` against the object array of the same strings), the
HyperLogLog register planes and their estimates, the Space-Saving planes of
``approx_top_k`` with their mergeable-summaries union, the KLL compactor
planes with their fold and quantile finalize, the windowed
``SpaceSaving`` summary, and the slice path's approximate aggregates end
to end.

Tolerance: none.  Both packages run the same host numpy operations in the
same order, so every plane, estimate and emitted row must be EQUAL (NaN
equal to NaN); a difference is a porting fault.  The documented error
bounds (docs/approx_aggregates.md) are checked against an exact oracle
separately.
"""

from __future__ import annotations

import numpy as np
import pytest

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.ops import sketches as jsk
from denormalized_tpu.ops.segment_agg import components_for as jcomps
from denormalized_tpu.ops.slice_store import SliceStore as JStore
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.columns import StringColumn
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.ops import sketches as tsk
from denormalized_tpu_torch.ops.segment_agg import components_for as tcomps
from denormalized_tpu_torch.ops.slice_store import SliceStore as TStore
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000


def _eq_planes(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k], equal_nan=True), k


# -- stable hash lanes --------------------------------------------------------


def _lanes(rng):
    n = 600
    f = rng.normal(0.0, 1e6, n)
    f[::17] = np.nan
    f[::23] = -0.0
    strs = np.array([f"u{i}" for i in rng.integers(0, 50, n)], object)
    with_none = strs.copy()
    with_none[::11] = None
    return {
        "float64": (f, None),
        "float32": (f.astype(np.float32), None),
        "int64_big": (
            rng.integers(-(2**62), 2**62, n, dtype=np.int64), None
        ),
        "int32": (rng.integers(-5, 5, n).astype(np.int32), None),
        "bool": (rng.random(n) < 0.5, None),
        "datetime": (
            (T0 + rng.integers(0, 10**6, n)).astype("datetime64[ms]"), None
        ),
        "object": (strs, None),
        "object_none": (with_none, None),
        "object_masked": (with_none, rng.random(n) < 0.8),
    }


@pytest.mark.parametrize("lane", list(_lanes(np.random.default_rng(0))))
def test_stable_hash_lanes_equal(lane):
    col, valid = _lanes(np.random.default_rng(1))[lane]
    got = tsk.stable_hash64(col, valid)
    want = jsk.stable_hash64(col, valid)
    assert got.dtype == want.dtype == np.uint64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_string_column_hashes_as_the_object_lane(masked):
    """The trap of this slice: the port's string columns are
    ``StringColumn``s.  They must reach the object lane, each unique value
    hashing to the JAX package's blake2b64 of its UTF-8 bytes, nulls as
    ``repr(None)``."""
    rng = np.random.default_rng(5)
    vals = [f"café-{i}" for i in rng.integers(0, 40, 300)]
    obj = np.array(vals, object)
    validity = rng.random(300) >= 0.1
    obj_null = obj.copy()
    obj_null[~validity] = None
    sc = StringColumn.from_objects(obj_null)
    assert isinstance(sc, StringColumn)
    valid = validity if masked else None
    got = tsk.stable_hash64(sc, valid)
    want = jsk.stable_hash64(obj_null, valid)
    assert np.array_equal(got, want)
    # per value: the blake2b of the UTF-8 bytes, None as repr(None)
    for i in (0, 1, int(np.flatnonzero(~validity)[0])):
        v = obj_null[i]
        if masked and v is None:
            continue
        assert got[i] == np.uint64(jsk.blake2b64(v))


# -- HyperLogLog --------------------------------------------------------------


@pytest.mark.parametrize("p", [4, 11, 12])
def test_hll_planes_and_estimates_equal(p):
    rng = np.random.default_rng(p)
    planes = {}
    for name, sk in (("jax", jsk), ("torch", tsk)):
        plane = np.zeros((7, 1 << p), dtype=np.int8)
        r = np.random.default_rng(p)
        for _ in range(5):
            n = 3000
            gids = r.integers(0, 7, n).astype(np.int64)
            h = sk.stable_hash64(r.integers(0, 20_000, n).astype(np.int64))
            sk.hll_accumulate(plane, gids, h)
        planes[name] = (plane, sk.hll_estimate(plane))
    assert np.array_equal(planes["jax"][0], planes["torch"][0])
    assert np.array_equal(planes["jax"][1], planes["torch"][1])
    # the class (statewatch's summary) agrees with the plane kernel
    g = rng.integers(0, 10**9, 5000)
    a, b = jsk.Hll(p), tsk.Hll(p)
    a.update(g)
    b.update(g)
    assert np.array_equal(a.registers, b.registers)
    assert a.estimate() == b.estimate()


def test_hll_spec_fold_equal():
    rng = np.random.default_rng(9)
    slots_j, slots_t = [], []
    for _u in range(4):
        sj = jsk.HllSpec("sk0", 1).init_planes(8)
        st = tsk.HllSpec("sk0", 1).init_planes(8)
        gids = np.sort(rng.integers(0, 8, 500)).astype(np.int64)
        h = jsk.stable_hash64(rng.integers(0, 900, 500).astype(np.int64))
        valid = rng.random(500) < 0.9
        jsk.HllSpec("sk0", 1).accumulate_unit(sj, 8, gids, h, valid)
        tsk.HllSpec("sk0", 1).accumulate_unit(st, 8, gids, h, valid)
        slots_j.append(sj)
        slots_t.append(st)
    fj = jsk.HllSpec("sk0", 1).fold(slots_j, 8)
    ft = tsk.HllSpec("sk0", 1).fold(slots_t, 8)
    _eq_planes(fj, ft)
    gids = np.arange(8)
    assert np.array_equal(
        jsk.HllSpec("sk0", 1).finalize(fj, gids),
        tsk.HllSpec("sk0", 1).finalize(ft, gids),
    )


# -- Space-Saving / approx_top_k ----------------------------------------------


def _zipf(rng, n, nkeys, a=1.3):
    return np.minimum(rng.zipf(a, n), nkeys).astype(np.int64) - 1


def test_space_saving_windowed_equal():
    rng = np.random.default_rng(11)
    a = jsk.SpaceSaving(32, decay_every=5000)
    b = tsk.SpaceSaving(32, decay_every=5000)
    for _ in range(12):
        g = _zipf(rng, 1500, 400)
        a.update(g)
        b.update(g)
        for x, y in zip(a.top(16), b.top(16)):
            assert np.array_equal(x, y)
        assert a.total == b.total


def test_topk_planes_and_merge_equal():
    rng = np.random.default_rng(13)
    js, ts = jsk.TopKSpec("sk0", 0, 3), tsk.TopKSpec("sk0", 0, 3)
    slots = {"jax": [], "torch": []}
    for _u in range(5):
        gids = np.sort(rng.integers(0, 6, 2000)).astype(np.int64)
        vids = _zipf(rng, 2000, 900)
        valid = rng.random(2000) < 0.95
        for name, spec in (("jax", js), ("torch", ts)):
            s = spec.init_planes(6)
            spec.accumulate_unit(s, 6, gids, vids, valid)
            slots[name].append(s)
    for u in range(5):
        _eq_planes(slots["jax"][u], slots["torch"][u])
    fj = js.fold(slots["jax"], 6)
    ft = ts.fold(slots["torch"], 6)
    _eq_planes(fj, ft)
    for g in range(6):
        cj = js.cell_top(fj["sk0|k"][g], fj["sk0|c"][g], fj["sk0|e"][g])
        ct = ts.cell_top(ft["sk0|k"][g], ft["sk0|c"][g], ft["sk0|e"][g])
        for x, y in zip(cj, ct):
            assert np.array_equal(x, y)
    # the union alone, with an empty side (identity) and a full one
    empty = ts.init_planes(6)
    for out_j, out_t in zip(
        jsk.topk_merge(fj["sk0|k"], fj["sk0|c"], fj["sk0|e"],
                       empty["sk0|k"], empty["sk0|c"], empty["sk0|e"]),
        tsk.topk_merge(ft["sk0|k"], ft["sk0|c"], ft["sk0|e"],
                       empty["sk0|k"], empty["sk0|c"], empty["sk0|e"]),
    ):
        assert np.array_equal(out_j, out_t)


# -- KLL quantiles -------------------------------------------------------------


@pytest.mark.parametrize("K", [16, 512])
def test_kll_planes_fold_and_quantiles_equal(K):
    rng = np.random.default_rng(K)
    js, ts = jsk.KllSpec("sk1", 0, K), tsk.KllSpec("sk1", 0, K)
    slots = {"jax": [], "torch": []}
    for _u in range(4):
        n = 1500
        gids = np.sort(rng.integers(0, 3, n)).astype(np.int64)
        vals = rng.normal(0.0, 10.0, n)
        valid = rng.random(n) < 0.9
        for name, spec in (("jax", js), ("torch", ts)):
            s = spec.init_planes(3)
            spec.accumulate_unit(s, 3, gids, vals, valid)
            slots[name].append(s)
    for u in range(4):
        _eq_planes(slots["jax"][u], slots["torch"][u])
    fj = js.fold(slots["jax"], 3)
    ft = ts.fold(slots["torch"], 3)
    _eq_planes(fj, ft)
    gids = np.arange(3)
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        assert np.array_equal(
            js.finalize_quantile(fj, gids, q),
            ts.finalize_quantile(ft, gids, q),
            equal_nan=True,
        )


def test_store_with_sketch_planes_equal_and_restores_across_packages():
    """One slice store with HLL + KLL planes beside a sum, fed the same
    sorted batches in both packages: folds equal; each package's snapshot
    arrays restore into the other's store and keep folding equal."""
    rng = np.random.default_rng(37)
    rounds = []
    for r in range(5):
        n = 800
        units = np.sort(rng.integers(r, r + 3, n))
        gids = rng.integers(0, 6, n).astype(np.int64)
        values = rng.normal(10, 3, (n, 2))
        valid = np.ones((n, 2), dtype=bool)
        hashes = jsk.stable_hash64(rng.integers(0, 4000, n).astype(np.int64))
        order = np.argsort(units.astype(np.int64) * 16 + gids, kind="stable")
        rounds.append((units, gids, values, valid, order, hashes))
    specs = [("sum", 0), ("sketch", 1, None)]

    def store(pkg):
        sk, Store, comps = (
            (jsk, JStore, jcomps) if pkg == "jax" else (tsk, TStore, tcomps)
        )
        return Store(
            comps(specs), 1000,
            sketches=(sk.HllSpec("sk0", 1), sk.KllSpec("sk1", 0, 64)),
        )

    def feed(st, rs):
        for units, gids, values, valid, order, hashes in rs:
            st.accumulate(units, gids, values, valid, 6, order=order,
                          aux={1: hashes})

    a, b = store("jax"), store("torch")
    feed(a, rounds[:3])
    feed(b, rounds[:3])
    _eq_planes(a.fold(0, 10), b.fold(0, 10))
    snap_a, snap_b = a.snapshot_arrays(6), b.snapshot_arrays(6)
    _eq_planes(snap_a, snap_b)
    # cross restore: the JAX package's arrays into the port, and back
    b2, a2 = store("torch"), store("jax")
    b2.restore_arrays({k: v.copy() for k, v in snap_a.items()}, 6)
    a2.restore_arrays({k: v.copy() for k, v in snap_b.items()}, 6)
    feed(b2, rounds[3:])
    feed(a2, rounds[3:])
    feed(a, rounds[3:])
    _eq_planes(a.fold(0, 10), b2.fold(0, 10))
    _eq_planes(a.fold(0, 10), a2.fold(0, 10))
    assert a.sketch_nbytes() == b2.sketch_nbytes() == a2.sketch_nbytes()


# -- the slice path's approximate aggregates end to end --------------------


def _api(pkg):
    if pkg == "jax":
        return (jt, JF, JSchema, JField, JType, JBatch, JSource,
                lambda **kw: jt.Context(jt.api.context.EngineConfig(**kw)))
    return (tt, TF, TSchema, TField, TType, TBatch, TSource,
            lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)))


def _raw(seed=7, n_batches=12, rows=500, n_vals=400, null_frac=0.0,
         strings=False):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 1000 + rng.integers(0, 1000, rows))
        ks = np.asarray([f"s{i}" for i in rng.integers(0, 2, rows)], object)
        if strings:
            vs = np.asarray(
                [f"u{i}" for i in rng.integers(0, n_vals, rows)], object
            )
        else:
            vs = rng.integers(0, n_vals, rows).astype(np.float64)
        valid = rng.random(rows) >= null_frac
        out.append((ts, ks, vs, valid))
    return out


def _aggs(F, col, strings=False):
    if strings:
        return [
            F.approx_distinct(col("v")).alias("nd"),
            F.approx_top_k(col("v"), 2).alias("top"),
        ]
    return [
        F.approx_distinct(col("v")).alias("nd"),
        F.approx_median(col("v")).alias("med"),
        F.approx_percentile_cont(col("v"), 0.9).alias("p90"),
        F.approx_top_k(col("v"), 3).alias("top"),
        F.sum(col("v")).alias("s"),
    ]


def _cell(c):
    if isinstance(c, (list, tuple)):
        return tuple(_cell(p) for p in c)
    if isinstance(c, (float, np.floating)):
        return "nan" if c != c else float(c)
    if isinstance(c, np.integer):
        return int(c)
    return c


def _run(pkg, raw, strings=False, L=2000, S=1000, **cfg):
    mod, F, Schema, Field, DT, Batch, Source, ctx_of = _api(pkg)
    schema = Schema([
        Field("ts", DT.INT64, nullable=False),
        Field("k", DT.STRING, nullable=False),
        Field("v", DT.STRING if strings else DT.FLOAT64),
    ])
    batches = [
        Batch(schema, [ts, ks, vs],
              None if valid.all() else [None, None, valid])
        for ts, ks, vs, valid in raw
    ]
    aggs = _aggs(F, mod.col, strings)
    ds = ctx_of(**cfg).from_source(
        Source.from_batches(batches, timestamp_column="ts"), name="feed"
    ).window(["k"], aggs, L, S)
    rows = []
    for b in ds.stream():
        for i in range(b.num_rows):
            rows.append(
                (b.column("k")[i], int(b.column("window_start_time")[i]))
                + tuple(_cell(b.column(a.name)[i]) for a in aggs)
            )
    return rows


NATIVE = dict(slice_windows=True, slice_unit_ms=1000)


@pytest.mark.parametrize(
    "case",
    ["numeric", "nulls", "strings", "strings_nulls", "lowered"],
)
def test_slice_path_approx_rows_equal_across_packages(case):
    strings = case.startswith("strings")
    null_frac = 0.25 if case.endswith("nulls") else 0.0
    raw = _raw(seed=len(case), null_frac=null_frac, strings=strings,
               n_vals=300 if strings else 400)
    cfg = dict(NATIVE)
    if case == "lowered":
        cfg["approx_native"] = False
    j = _run("jax", raw, strings=strings, **cfg)
    t = _run("torch", raw, strings=strings, **cfg)
    assert j and j == t


def test_slice_path_tracks_the_exact_accumulators_within_bounds():
    """docs/approx_aggregates.md's bounds against the exact accumulator
    path (the default config lowers every sketch kind to its UDAF)."""
    raw = _raw()
    native = {r[:2]: r[2:] for r in _run("torch", raw, **NATIVE)}
    exact = {r[:2]: r[2:] for r in _run("torch", raw)}
    assert set(native) == set(exact)
    for key in native:
        nd_n, med_n, p90_n, top_n, s_n = native[key]
        nd_e, med_e, p90_e, _top_e, s_e = exact[key]
        assert abs(nd_n - nd_e) <= max(4, 0.066 * nd_e), (key, nd_n, nd_e)
        assert abs(med_n - med_e) <= 0.05 * 400, key
        assert abs(p90_n - p90_e) <= 0.05 * 400, key
        assert 0 < len(top_n) <= 3
        assert s_n == s_e


def test_sketch_state_constant_in_cardinality():
    from denormalized_tpu_torch.physical.simple_execs import SourceExec
    from denormalized_tpu_torch.physical.slice_exec import (
        SliceSubscriber,
        SliceWindowExec,
    )

    def bytes_for(n_vals):
        raw = _raw(seed=3, n_vals=n_vals)
        schema = TSchema([
            TField("ts", TType.INT64, nullable=False),
            TField("k", TType.STRING, nullable=False),
            TField("v", TType.FLOAT64),
        ])
        src = SourceExec(TSource.from_batches(
            [TBatch(schema, [ts, ks, vs]) for ts, ks, vs, _ in raw],
            timestamp_column="ts",
        ))
        op = SliceWindowExec(
            src, [tt.col("k")],
            [SliceSubscriber(_aggs(TF, tt.col), 2000, 1000)], unit_ms=1000,
        )
        peak = 0
        for _ in op.run():
            peak = max(peak, op.state_info()["sketch_bytes"])
        return peak

    assert bytes_for(40) == bytes_for(4000) > 0
