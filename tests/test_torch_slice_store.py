"""The port's slice store (``denormalized_tpu_torch/ops/slice_store.py``)
held against the JAX package's on the same seeded numpy input.

Twins of ``tests/test_slice_store.py``: ``slice_segment_bounds`` (negative
units too), ``fold_slices``, both accumulation lanes (the lexsort +
``reduceat`` lane and the add-only ``bincount`` lane, and the guard that
sends a sparse span back to sorting), the pinned sort lane, a shared
precomputed order and a masked subset of it, capacity growth, folds over
ranges, ``prune`` and ``snapshot_arrays``/``restore_arrays`` across the
two packages, plus a brute-force oracle per cell.

Tolerance: none.  The store is host float64/int64 numpy in both packages,
the same operations in the same order, so every partial, fold and snapshot
array must be EQUAL (NaN equal to NaN), and the per-cell counts, minima and
maxima equal the brute force; the brute force's sums are a Python loop in
row order, so they are held to rtol=1e-12.
"""

from __future__ import annotations

import numpy as np
import pytest

from denormalized_tpu.ops import slice_store as jss
from denormalized_tpu.ops.segment_agg import components_for as jcomps
from denormalized_tpu_torch.ops import slice_store as tss
from denormalized_tpu_torch.ops.segment_agg import components_for as tcomps

SPECS = {
    "extrema": [("count", 0), ("sum", 0), ("min", 0), ("max", 0)],
    "add_only": [("count", 0), ("sum", 0), ("avg", 1)],
    "variance": [("var", 0, 1), ("count", None)],
}


def _store(pkg, specs, unit=1000, **kw):
    mod, comps = (jss, jcomps) if pkg == "jax" else (tss, tcomps)
    return mod.SliceStore(comps(specs), unit, **kw)


def _feed(seed=0, n=5000, n_units=7, n_gids=23, null_frac=0.1, u0=0):
    rng = np.random.default_rng(seed)
    units = (u0 + rng.integers(0, n_units, n)).astype(np.int64)
    gids = rng.integers(0, n_gids, n).astype(np.int32)
    vals = rng.normal(100.0, 30.0, (n, 2))
    valid = rng.random((n, 2)) >= null_frac
    return units, gids, vals, valid


def _eq(a: dict | None, b: dict | None) -> None:
    assert (a is None) == (b is None)
    if a is None:
        return
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def _both(specs, feeds, ngroups, chunks=4, **kw):
    out = []
    for pkg in ("jax", "torch"):
        st = _store(pkg, specs, **kw)
        segs = []
        for units, gids, vals, valid in feeds:
            edges = np.linspace(0, len(units), chunks + 1).astype(int)
            for a, b in zip(edges[:-1], edges[1:]):
                segs.append(st.accumulate(
                    units[a:b], gids[a:b], vals[a:b], valid[a:b], ngroups
                ))
        out.append((st, segs))
    return out


@pytest.mark.parametrize("neg", [False, True])
def test_segment_bounds_equal(neg):
    units, gids, _v, _ok = _feed(seed=3, u0=-5 if neg else 0)
    a = jss.slice_segment_bounds(units, gids, 32)
    b = tss.slice_segment_bounds(units, gids, 32)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("kind", ["count", "sum", "min", "max"])
def test_fold_slices_equal(kind):
    rng = np.random.default_rng(4)
    stack = rng.normal(0, 1e3, (9, 40))
    if kind == "count":
        stack = rng.integers(0, 100, (9, 40)).astype(np.int64)
    assert np.array_equal(
        jss.fold_slices(kind, stack), tss.fold_slices(kind, stack)
    )


@pytest.mark.parametrize("lanes", ["extrema", "add_only", "variance",
                                   "add_only_pinned"])
def test_accumulate_both_lanes_equal(lanes):
    pinned = lanes.endswith("_pinned")
    specs = SPECS[lanes.removesuffix("_pinned")]
    feeds = [_feed(seed=s, u0=2 * s) for s in range(3)]
    (js, jsegs), (ts, tsegs) = _both(specs, feeds, 23,
                                     force_sort_lane=pinned)
    assert js.add_only == ts.add_only == (lanes in ("add_only", "variance"))
    assert jsegs == tsegs
    assert js.live_units() == ts.live_units()
    assert js.rows_accumulated == ts.rows_accumulated
    assert js.nbytes() == ts.nbytes()
    for u0 in range(0, 8, 2):
        for width in (1, 3, 5):
            _eq(js.fold(u0, u0 + width), ts.fold(u0, u0 + width))
    assert js.fold(100, 110) is None and ts.fold(100, 110) is None


def test_dense_lane_guard_falls_back_on_sparse_span():
    """A wildly out-of-order add-only batch (span * capacity > 4x rows)
    sorts instead: same lane choice, same bits, in both packages."""
    rng = np.random.default_rng(8)
    units = np.concatenate(
        (rng.integers(0, 3, 500), rng.integers(10_000, 10_003, 500))
    ).astype(np.int64)
    gids = rng.integers(0, 40, 1000).astype(np.int32)
    vals = rng.normal(5, 2, (1000, 2))
    valid = np.ones((1000, 2), bool)
    (js, _), (ts, _) = _both(SPECS["add_only"], [(units, gids, vals, valid)],
                             40, chunks=1)
    assert js.live_units() == ts.live_units()
    for u in js.live_units():
        _eq(js.fold(u, u + 1), ts.fold(u, u + 1))


def test_shared_order_and_masked_subset_equal():
    """The shared pipeline's one sort per batch: a precomputed stable
    order, and a residual mask applied in sorted order, give the same
    partials in both packages (and the subset equals sorting it alone)."""
    from denormalized_tpu.physical.slice_exec import (
        masked_sorted_order as jmask,
    )
    from denormalized_tpu.physical.slice_exec import (
        shared_sort_order as jorder,
    )
    from denormalized_tpu_torch.physical.slice_exec import (
        masked_sorted_order as tmask,
    )
    from denormalized_tpu_torch.physical.slice_exec import (
        shared_sort_order as torder,
    )

    units, gids, vals, valid = _feed(seed=12)
    keep = vals[:, 0] > 100.0
    oj, ot = jorder(units, gids), torder(units, gids)
    assert np.array_equal(oj, ot)
    assert np.array_equal(jmask(oj, keep), tmask(ot, keep))
    stores = {}
    for pkg, order in (("jax", jmask(oj, keep)), ("torch", tmask(ot, keep))):
        st = _store(pkg, SPECS["extrema"], force_sort_lane=True)
        st.accumulate(units, gids, vals, valid, 23, order=order)
        alone = _store(pkg, SPECS["extrema"], force_sort_lane=True)
        alone.accumulate(units[keep], gids[keep], vals[keep], valid[keep], 23)
        _eq(st.fold(0, 7), alone.fold(0, 7))
        stores[pkg] = st
    _eq(stores["jax"].fold(0, 7), stores["torch"].fold(0, 7))


def test_accumulate_matches_brute_force_per_cell():
    units, gids, vals, valid = _feed(seed=1, n=3000)
    st = _store("torch", SPECS["extrema"])
    st.accumulate(units, gids, vals, valid, 23)
    comps = {c.kind: c.label for c in st.components if c.col == 0}
    for (u, g) in {(int(a), int(b)) for a, b in zip(units, gids)}:
        m = (units == u) & (gids == g)
        ok = valid[m, 0]
        v = vals[m, 0][ok]
        slot = st.fold(u, u + 1)
        assert slot[comps["count"]][g] == len(v)
        if len(v):
            assert slot[comps["min"]][g] == v.min()
            assert slot[comps["max"]][g] == v.max()
            assert slot[comps["sum"]][g] == pytest.approx(
                sum(v.tolist()), rel=1e-12
            )


def test_capacity_growth_prune_and_snapshot_across_packages():
    specs = SPECS["extrema"]
    small = _feed(seed=20, n_gids=10)
    big = _feed(seed=21, n_gids=300, u0=3)
    later = _feed(seed=22, n_gids=300, u0=6)
    (js, _), (ts, _) = _both(specs, [small, big], 300)
    assert js.capacity == ts.capacity == 512
    assert js.prune(4) == ts.prune(4)
    assert js.live_units() == ts.live_units()
    sj, st = js.snapshot_arrays(300), ts.snapshot_arrays(300)
    _eq(sj, st)
    # each package restores the other's arrays and keeps folding equal
    rj, rt = _store("jax", specs), _store("torch", specs)
    rj.restore_arrays({k: v.copy() for k, v in st.items()}, 300)
    rt.restore_arrays({k: v.copy() for k, v in sj.items()}, 300)
    for st_ in (js, ts, rj, rt):
        st_.accumulate(*later, 300)
    for u0 in range(4, 13):
        want = js.fold(u0, u0 + 3)
        for other in (ts, rj, rt):
            _eq(want, other.fold(u0, u0 + 3))
