"""Live query registration on the port's shared slice pipeline
(``runtime/multi_query.py::SharedPipeline`` over
``physical/slice_exec.py``), held against the JAX package.

Twins of ``tests/test_live_registration.py``, each scenario run in BOTH
packages on the same seeded feed and the same event-time schedule:

- a same-filter joiner backfills from retained slices;
- a joiner whose residual predicate opens a new filter class is exact
  from past the max ingested event time;
- a leaving member leaves the survivor undisturbed;
- the BASE (weakest-predicate) member leaving narrows the shared ingest;
- unshareable registrations are refused at ``register()`` with the same
  messages;
- eight threads register at once (dense unique tags, every sink fed).

Tolerance: none.  Each query's rows equal the JAX package's and, from
its first exact window, its independent from-start slice oracle (pinned
to the group's 1 s unit, and to the lexsort lane for residual members):
host float64 folds, compared with ``==``.
"""

from __future__ import annotations

import sys
import threading
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_mq_twins import (  # noqa: E402
    PKGS,
    T0,
    aggs,
    base_of,
    first_exact_start,
    raw_feed,
    sink,
)


def _oracle(p, raw, L, S, *, flt=None, sort_lane=False):
    ctx = p.ctx(slice_windows=True, slice_unit_ms=1000,
                slice_sort_lane=sort_lane)
    ds = base_of(p, ctx, raw)
    if flt is not None:
        ds = ds.filter(flt(p.col))
    out = {}
    f = sink(out)
    for b in ds.window(["k"], aggs(p), L, S).stream():
        f(b)
    return out


def _both(scenario):
    got = {name: scenario(p) for name, p in PKGS.items()}
    assert got["jax"] == got["torch"]
    return got["torch"]


def test_live_attach_backfills_exact_windows():
    raw = raw_feed(31)
    when = T0 + 8_000

    def scenario(p):
        got0, got1 = {}, {}
        ctx = p.ctx()
        base = base_of(p, ctx, raw)
        sp = p.mq.SharedPipeline(
            ctx, [(base.window(["k"], aggs(p), 3000, 1000), sink(got0))]
        )
        tag = sp.register(base.window(["k"], aggs(p), 2000, 1000),
                          sink(got1), label="joiner", when_ts=when)
        assert tag == 1
        sp.run()
        return got0, got1, first_exact_start(sp, tag), sp.root.metrics()

    got0, got1, j_start, m = _both(scenario)
    p = PKGS["torch"]
    oracle1 = _oracle(p, raw, 2000, 1000)
    assert got1 == {k: v for k, v in oracle1.items() if k[1] >= j_start}
    # the warm-up reached back: exact windows that closed before the join
    assert any(k[2] <= when for k in got1)
    assert got0 == _oracle(p, raw, 3000, 1000)
    assert m["subscribers"] == 2


def test_live_attach_residual_filter_exact_from_attach():
    raw = raw_feed(32)
    when = T0 + 9_000

    def scenario(p):
        got0, got1 = {}, {}
        ctx = p.ctx()
        base = base_of(p, ctx, raw)
        sp = p.mq.SharedPipeline(
            ctx, [(base.window(["k"], aggs(p), 3000, 1000), sink(got0))]
        )
        tag = sp.register(
            base.filter(p.col("v") > 12.0).window(["k"], aggs(p), 2000, 1000),
            sink(got1), when_ts=when,
        )
        sp.run()
        return got0, got1, first_exact_start(sp, tag), sp.root.metrics()

    _got0, got1, j_start, m = _both(scenario)
    assert j_start >= when - 2000
    oracle1 = _oracle(PKGS["torch"], raw, 2000, 1000,
                      flt=lambda c: c("v") > 12.0, sort_lane=True)
    expect1 = {k: v for k, v in oracle1.items() if k[1] >= j_start}
    assert expect1 and got1 == expect1
    assert m["filter_classes"] == 2


def test_live_detach_survivor_unaffected():
    raw = raw_feed(33)
    when = T0 + 10_000

    def scenario(p):
        got0, got1 = {}, {}
        ctx = p.ctx()
        base = base_of(p, ctx, raw)
        sp = p.mq.SharedPipeline(ctx, [
            (base.window(["k"], aggs(p), 3000, 1000), sink(got0)),
            (base.window(["k"], aggs(p), 2000, 1000), sink(got1)),
        ])
        sp.deregister(1, when_ts=when)
        sp.run()
        return got0, got1, sp.root.metrics()["subscribers"]

    got0, got1, subs = _both(scenario)
    p = PKGS["torch"]
    assert got0 == _oracle(p, raw, 3000, 1000)
    oracle1 = _oracle(p, raw, 2000, 1000)
    assert got1 and set(got1) < set(oracle1)
    assert all(got1[k] == oracle1[k] for k in got1)
    assert max(k[2] for k in got1) <= when + 2000
    assert subs == 1


@pytest.mark.parametrize("deregister_base", [False, True])
def test_detach_of_base_member_narrows_shared_ingest(deregister_base):
    raw = raw_feed(36)

    def scenario(p):
        got0, got1 = {}, {}
        ctx = p.ctx()
        base = base_of(p, ctx, raw)
        sp = p.mq.SharedPipeline(ctx, [
            (base.filter(p.col("v") > 5.0).window(
                ["k"], aggs(p), 3000, 1000), sink(got0)),
            (base.filter(p.col("v") > 12.0).window(
                ["k"], aggs(p), 2000, 1000), sink(got1)),
        ])
        if deregister_base:
            sp.deregister(0, when_ts=T0 + 10_000)
        sp.run()
        return got0, got1, sp.root.metrics()

    got0, got1, m = _both(scenario)
    p = PKGS["torch"]
    assert m["rows_in"] > 0
    if deregister_base:
        assert m["rows_ingested"] < m["rows_in"]
        assert m["filter_classes"] == 1
    else:
        assert m["rows_ingested"] == m["rows_in"]
        assert m["filter_classes"] == 2
    oracle1 = _oracle(p, raw, 2000, 1000, flt=lambda c: c("v") > 12.0,
                      sort_lane=True)
    assert got1 == oracle1
    oracle0 = _oracle(p, raw, 3000, 1000, flt=lambda c: c("v") > 5.0,
                      sort_lane=True)
    if deregister_base:
        assert got0 and set(got0) < set(oracle0)
        assert all(got0[k] == oracle0[k] for k in got0)
        assert max(k[2] for k in got0) <= T0 + 10_000 + 3000
    else:
        assert got0 == oracle0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_register_rejects_unshareable(pkg):
    p = PKGS[pkg]
    raw = raw_feed(34, n_batches=4)
    ctx = p.ctx()
    base = base_of(p, ctx, raw)
    seed = base.filter(p.col("v") > 10.0).window(["k"], aggs(p), 3000, 1000)
    sp = p.mq.SharedPipeline(ctx, [(seed, sink({}))])
    with pytest.raises(p.PlanError, match="source, projection and group"):
        sp.register(base.window([], aggs(p), 3000, 1000), sink({}))
    with pytest.raises(p.PlanError, match="cannot widen"):
        sp.register(base.filter(p.col("v") > 5.0).window(
            ["k"], aggs(p), 2000, 1000), sink({}))
    with pytest.raises(p.PlanError, match="tile"):
        sp.register(base.filter(p.col("v") > 10.0).window(
            ["k"], aggs(p), 1500, 500), sink({}))
    with pytest.raises(p.PlanError, match="cannot join a shared pipeline"):
        sp.register(base.filter(p.col("v") > 10.0).window(
            ["k"], [p.F.median(p.col("v")).alias("m")], 2000, 1000),
            sink({}))
    tag = sp.register(base.filter(p.col("v") > 15.0).window(
        ["k"], aggs(p), 2000, 1000), sink({}))
    assert tag == 1


def test_register_from_eight_threads():
    """register() from eight threads at once (before the drive): tags are
    dense and unique, and every joiner's sink is fed — the same rows in
    both packages."""
    raw = raw_feed(38, n_batches=12)

    def scenario(p):
        ctx = p.ctx()
        base = base_of(p, ctx, raw)
        outs = {0: {}}
        sp = p.mq.SharedPipeline(
            ctx, [(base.window(["k"], aggs(p), 3000, 1000), sink(outs[0]))]
        )
        tags = {}
        barrier = threading.Barrier(8)

        def reg(i):
            acc = {}
            barrier.wait()
            t = sp.register(
                base.window(["k"], aggs(p), 1000 * (1 + i % 4), 1000),
                sink(acc), when_ts=T0 + 2_000,
            )
            tags[i] = (t, acc)

        ths = [threading.Thread(target=reg, args=(i,)) for i in range(8)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        assert sorted(t for t, _ in tags.values()) == list(range(1, 9))
        sp.run()
        # rows per window length (the tag order is the threads' race)
        by_len = {}
        for i, (_t, acc) in tags.items():
            assert acc, i
            by_len.setdefault(1000 * (1 + i % 4), []).append(acc)
        for accs in by_len.values():
            assert all(a == accs[0] for a in accs)
        return outs[0], {L: accs[0] for L, accs in sorted(by_len.items())}

    _both(scenario)
