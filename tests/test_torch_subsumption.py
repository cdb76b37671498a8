"""The port's predicate-implication checker and sharing pass
(``denormalized_tpu_torch/planner/{predicates,sharing}.py``) held against
the JAX package's.

Twins of ``tests/test_subsumption.py`` and of the sharing half of
``tests/test_multi_query.py``: ``analyze`` (intervals, value sets, opaque
conjuncts), ``implies`` on every boundary case, ``weakest``,
``predicate_signature`` and ``conjoin``, then ``detect_sharing``'s groups,
members, units, residual filters, signatures and fallback reasons on the
same query sets built in both packages, and the end-to-end differential of
a subsumption group (residual re-filters, NaN and null rows in the filter
column) against per-query slice oracles and against the JAX package.

Tolerance: none.  Planning is symbolic, so every answer must be equal;
the emitted rows are host float64 folds in both packages and must be equal
too (NaN equal to NaN).
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
from denormalized_tpu.planner import predicates as jpr
from denormalized_tpu.planner.sharing import detect_sharing as jdetect
from denormalized_tpu.runtime.multi_query import run_queries as jrun
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.planner import predicates as tpr
from denormalized_tpu_torch.planner.sharing import detect_sharing as tdetect
from denormalized_tpu_torch.runtime.multi_query import run_queries as trun
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000
NAN = float("nan")

PKG = {
    "jax": dict(col=jt.col, F=JF, pr=jpr, detect=jdetect, run=jrun,
                Schema=JSchema, Field=JField, DT=JType, Batch=JBatch,
                Source=JSource,
                ctx=lambda **kw: jt.Context(JConfig(**kw))),
    "torch": dict(col=tt.col, F=TF, pr=tpr, detect=tdetect, run=trun,
                  Schema=TSchema, Field=TField, DT=TType, Batch=TBatch,
                  Source=TSource,
                  ctx=lambda **kw: tt.Context(
                      tt.EngineConfig(device="cpu", **kw))),
}

# (P, Q, implies(P, Q)) as factories over (col, F): the reference's
# boundary, nesting, NaN-literal and opaque cases
PAIRS = {
    "gt_gt": (lambda c, F: c("v") > 5.0, lambda c, F: c("v") > 4.0, True),
    "ge_gt": (lambda c, F: c("v") >= 5.0, lambda c, F: c("v") > 4.0, True),
    "gt_ge_same": (lambda c, F: c("v") > 5.0, lambda c, F: c("v") >= 5.0,
                   True),
    "ge_gt_same": (lambda c, F: c("v") >= 5.0, lambda c, F: c("v") > 5.0,
                   False),
    "gt_looser": (lambda c, F: c("v") > 4.0, lambda c, F: c("v") > 5.0,
                  False),
    "lt_le": (lambda c, F: c("v") < 5.0, lambda c, F: c("v") <= 5.0, True),
    "le_lt": (lambda c, F: c("v") <= 5.0, lambda c, F: c("v") < 5.0, False),
    "two_sided": (
        lambda c, F: (c("v") < 3.0) & (c("v") > 2.0),
        lambda c, F: (c("v") > 1.0) & (c("v") < 4.0), True),
    "two_sided_rev": (
        lambda c, F: (c("v") > 1.0) & (c("v") < 4.0),
        lambda c, F: (c("v") > 2.0) & (c("v") < 3.0), False),
    "eq_in": (lambda c, F: c("k") == "a",
              lambda c, F: F.in_list(c("k"), ["a", "b"]), True),
    "in_eq": (lambda c, F: F.in_list(c("k"), ["a", "b"]),
              lambda c, F: c("k") == "a", False),
    "in_interval": (lambda c, F: F.in_list(c("v"), [2.0, 3.0]),
                    lambda c, F: c("v") > 1.0, True),
    "in_leaks": (lambda c, F: F.in_list(c("v"), [1.0, 2.0]),
                 lambda c, F: c("v") > 1.0, False),
    "other_col": (lambda c, F: c("v") > 5.0, lambda c, F: c("k") == "a",
                  False),
    "extra_col": (lambda c, F: (c("v") > 5.0) & (c("k") == "a"),
                  lambda c, F: c("v") > 0.0, True),
    "nan_lit": (lambda c, F: c("v") > NAN, lambda c, F: c("v") > 0.0,
                False),
    "nan_same": (lambda c, F: c("v") > NAN, lambda c, F: c("v") > NAN,
                 True),
    "or_same": (lambda c, F: (c("v") > 5.0) | (c("k") == "a"),
                lambda c, F: (c("v") > 5.0) | (c("k") == "a"), True),
    "or_other": (lambda c, F: (c("v") > 5.0) | (c("k") == "a"),
                 lambda c, F: (c("v") > 5.0) | (c("k") == "b"), False),
    "range_or": (lambda c, F: c("v") > 5.0,
                 lambda c, F: (c("v") > 5.0) | (c("k") == "a"), False),
}


def _cons_view(cons):
    def end(x):
        return repr(x) if isinstance(x, (int, float, str)) else type(x).__name__

    return (
        {
            k: (end(iv.lo), iv.lo_strict, end(iv.hi), iv.hi_strict)
            for k, iv in cons.intervals.items()
        },
        {k: sorted(map(repr, s)) for k, s in cons.sets.items()},
        sorted(cons.opaque),
    )


@pytest.mark.parametrize("case", list(PAIRS))
def test_analyze_and_implies_equal(case):
    p_of, q_of, want = PAIRS[case]
    got = {}
    for pkg, a in PKG.items():
        p, q = p_of(a["col"], a["F"]), q_of(a["col"], a["F"])
        cp, cq = a["pr"].analyze([p]), a["pr"].analyze([q])
        got[pkg] = (
            a["pr"].implies(cp, cq), _cons_view(cp), _cons_view(cq),
            a["pr"].predicate_signature([p, q]),
            repr(a["pr"].conjoin([p, q])),
        )
    assert got["jax"] == got["torch"]
    assert got["torch"][0] is want


def test_weakest_and_empty_predicates_equal():
    for a in PKG.values():
        c, pr = a["col"], a["pr"]
        chains = [[c("v") > 5.0], [c("v") > 1.0], [c("v") > 3.0]]
        assert pr.weakest([pr.analyze(x) for x in chains]) == 1
        incomparable = [[c("v") > 5.0], [c("v") < 1.0]]
        assert pr.weakest([pr.analyze(x) for x in incomparable]) is None
        assert pr.implies(pr.analyze([c("v") > 0.0]), pr.analyze([]))
        assert not pr.implies(pr.analyze([]), pr.analyze([c("v") > 0.0]))
        assert pr.conjoin([]) is None


# -- the sharing pass ---------------------------------------------------------


def _raw(seed=41, n_batches=12, rows=300, null_frac=0.0, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 1000 + rng.integers(0, 1000, rows))
        ks = np.asarray([f"s{i}" for i in rng.integers(0, 5, rows)], object)
        vs = rng.normal(10.0, 4.0, rows)
        if nan_frac:
            vs[rng.random(rows) < nan_frac] = np.nan
        valid = rng.random(rows) >= null_frac
        out.append((ts, ks, vs, valid))
    return out


def _source(a, raw):
    schema = a["Schema"]([
        a["Field"]("ts", a["DT"].INT64, nullable=False),
        a["Field"]("k", a["DT"].STRING, nullable=False),
        a["Field"]("v", a["DT"].FLOAT64),
    ])
    return a["Source"].from_batches(
        [a["Batch"](schema, [ts, ks, vs],
                    None if valid.all() else [None, None, valid])
         for ts, ks, vs, valid in raw],
        timestamp_column="ts",
    )


def _aggs(a):
    F, c = a["F"], a["col"]
    return [F.count(c("v")).alias("c"), F.sum(c("v")).alias("s")]


# query sets: each entry is (filter or None, L, S, kind) with kind one of
# "plain", "udaf" (an accumulator aggregate), "session", "other_src",
# "other_keys"
QUERY_SETS = {
    "boundary": [(lambda c, F: c("v") > 5.0, 3000, 1000, "plain"),
                 (lambda c, F: c("v") >= 5.0, 3000, 1000, "plain")],
    "disjoint": [(lambda c, F: c("v") > 5.0, 3000, 1000, "plain"),
                 (lambda c, F: c("v") < 5.0, 3000, 1000, "plain")],
    "widen": [(lambda c, F: c("v") > 5.0, 3000, 1000, "plain"),
              (lambda c, F: c("v") > 1.0, 4000, 2000, "plain"),
              (lambda c, F: c("v") > 3.0, 6000, 3000, "plain")],
    "mixed_fallbacks": [
        (None, 5000, 1000, "plain"),
        (None, 10000, 2000, "plain"),
        (None, 3000, 1000, "udaf"),
        (None, 3000, None, "session"),
        (None, 3000, 1000, "other_src"),
        (None, 3000, 1000, "other_keys"),
        (lambda c, F: c("k") == "s1", 8000, 2000, "plain"),
    ],
    "cost_rejected": [(None, 60_000, 7, "plain"),
                      (None, 60_000, 1000, "plain")],
}


def _plans(a, raw, qs):
    ctx = a["ctx"]()
    base = ctx.from_source(_source(a, raw), name="feed")
    other = ctx.from_source(_source(a, raw), name="feed2")
    c, F = a["col"], a["F"]
    plans = []
    for flt, L, S, kind in qs:
        ds = other if kind == "other_src" else base
        if flt is not None:
            ds = ds.filter(flt(c, F))
        keys = ["v"] if kind == "other_keys" else ["k"]
        if kind == "udaf":
            aggs = [F.median(c("v")).alias("m")]
        else:
            aggs = _aggs(a)
        if kind == "session":
            w = ds.session_window(keys, aggs, L)
        else:
            w = ds.window(keys, aggs, L, S)
        plans.append(w._plan)
    return plans


def _groups_view(groups):
    return [
        (g.members, g.shared, g.unit_ms, g.reason,
         [None if f is None else repr(f) for f in g.filters],
         g.filter_sigs, g.base_sig)
        for g in groups
    ]


@pytest.mark.parametrize("subsumption", [True, False])
@pytest.mark.parametrize("qset", list(QUERY_SETS))
def test_detect_sharing_groups_and_reasons_equal(qset, subsumption):
    raw = _raw(n_batches=2)
    views = {
        pkg: _groups_view(a["detect"](
            _plans(a, raw, QUERY_SETS[qset]), subsumption=subsumption
        ))
        for pkg, a in PKG.items()
    }
    assert views["jax"] == views["torch"]
    shared = [v for v in views["torch"] if v[1]]
    if qset == "widen" and subsumption:
        # base = the v > 1 member: no residual; the others re-filter
        assert shared[0][0] == [0, 1, 2]
        assert shared[0][4][1] is None
        assert None not in (shared[0][4][0], shared[0][4][2])
    if qset == "disjoint" or not subsumption and qset != "mixed_fallbacks":
        assert not shared
    if qset == "mixed_fallbacks":
        # the k == "s1" member implies the unfiltered base and joins it;
        # the UDAF, session, other-source and other-key queries fall back
        assert shared[0][0] == ([0, 1, 6] if subsumption else [0, 1])
        assert [v[0] for v in views["torch"] if not v[1]] == (
            [[2], [3], [4], [5]] if subsumption else [[2], [3], [4], [5], [6]]
        )


@pytest.mark.parametrize("null_frac,nan_frac", [(0.0, 0.0), (0.15, 0.1)])
def test_shared_residuals_equal_across_packages_and_oracles(
    null_frac, nan_frac
):
    """A subsumption group with residual re-filters: each member's rows
    equal the JAX package's and the member's own slice oracle (unit pinned
    to the group's, the lexsort lane pinned for residual members)."""
    raw = _raw(seed=43, n_batches=14, null_frac=null_frac,
               nan_frac=nan_frac)
    filters = [
        lambda c, F: c("v") > 6.0,
        lambda c, F: (c("v") > 8.0) & (c("v") < 14.0),
        lambda c, F: F.in_list(c("k"), ["s0", "s1"]) & (c("v") > 9.0),
    ]

    def rows_of(b, acc):
        for i in range(b.num_rows):
            acc.append((b.column("k")[i], int(b.column("window_start_time")[i]),
                        int(b.column("c")[i]), float(b.column("s")[i])))

    outs = {}
    for pkg, a in PKG.items():
        ctx = a["ctx"]()
        base = ctx.from_source(_source(a, raw), name="feed")
        accs = [[] for _ in filters]
        qs = [
            (base.filter(f(a["col"], a["F"])).window(
                ["k"], _aggs(a), 3000, 1000), accs[i].append)
            for i, f in enumerate(filters)
        ]
        report = a["run"](ctx, qs)
        assert report["shared_queries"] == 3
        assert report["groups"][0]["members"] == [0, 1, 2]
        rows = []
        for acc in accs:
            r = []
            for b in acc:
                rows_of(b, r)
            rows.append(r)
        outs[pkg] = rows
    assert outs["jax"] == outs["torch"]
    a = PKG["torch"]
    for i, f in enumerate(filters):
        octx = a["ctx"](slice_windows=True, slice_unit_ms=1000,
                        slice_sort_lane=(i != 0))
        ods = octx.from_source(_source(a, raw), name="feed").filter(
            f(a["col"], a["F"])
        ).window(["k"], _aggs(a), 3000, 1000)
        oracle = []
        for b in ods.stream():
            rows_of(b, oracle)
        # the oracle interns only its own rows, so its row order differs
        assert sorted(outs["torch"][i]) == sorted(oracle), f"query {i}"
