"""Shared stream-join inputs across queries in the port: ONE
``StreamingJoinExec`` feeding a shared slice pipeline, with the join's
shared-group cost attribution (``enable_shared_attribution``,
``shared_cost_ms``, the ``dnz_mq_join_*`` instruments), held against the
JAX package.

Twins of ``tests/test_shared_join.py``: an inner group with a residual over
a right-side column, a left-outer group, an equi+band group over late rows
with band-aware eviction, skew adaptation inside a shared group with the
measured attribution, live register/deregister over a join-fed pipeline,
and a mid-epoch stop + restore of a join-fed group.

Determinism: the sequential pump (all of the left feed, then the right)
or the lockstep pump (left and right batch for batch) makes the join's
emission order reproducible; readings are integer-valued so window folds
are exact in any pair order.

Tolerance: none.  Each query's rows equal the JAX package's and its
independent join+window slice oracle (unit and lexsort lane pinned):
host float64 folds, compared with ``==``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_mq_twins import (  # noqa: E402
    PKGS,
    T0,
    aggs,
    drive_with_schedule,
    first_exact_start,
    lockstep_pump,
    sequential_pump,
    sink,
)

COLS = ("c", "s", "mn", "mx", "av", "sw")


def _feed(seed, nb, n, *, keys=4, epoch_keys=True, jitter=0):
    rr = np.random.default_rng(seed)
    out = []
    for b in range(nb):
        base = T0 + b * 1000
        ts = (base + rr.integers(-jitter, 1000, n) if jitter
              else np.sort(base + rr.integers(0, 1000, n)))
        if jitter:
            ts[0] = base
        vs = rr.integers(0, 100, n)
        rows = []
        for a, v in zip(ts, vs):
            i = int(rr.integers(0, keys))
            key = f"k{i}e{int(a) // 1000}" if epoch_keys else f"k{i}"
            rows.append((int(a), key, float(v)))
        out.append(rows)
    return out


def _joined(p, ctx, Lb, Rb, *, join_type="inner", band=None):
    D = p.DT
    ls = p.Schema([p.Field("ts", D.TIMESTAMP_MS, nullable=False),
                   p.Field("k", D.STRING, nullable=False),
                   p.Field("v", D.FLOAT64)])
    rs = p.Schema([p.Field("ts2", D.TIMESTAMP_MS, nullable=False),
                   p.Field("k2", D.STRING, nullable=False),
                   p.Field("w", D.FLOAT64)])

    def mk(schema, rows):
        cols = list(zip(*rows))
        return p.Batch(schema, [np.asarray(cols[0], np.int64),
                                np.asarray(cols[1], object),
                                np.asarray(cols[2], np.float64)])

    left = ctx.from_source(p.Source.from_batches(
        [mk(ls, b) for b in Lb], timestamp_column="ts"), name="jl")
    right = ctx.from_source(p.Source.from_batches(
        [mk(rs, b) for b in Rb], timestamp_column="ts2"), name="jr")
    return left.join(right, join_type, ["k"], ["k2"], band=band)


def _cfg(p, **kw):
    kw.setdefault("join_retention_ms", 10**9)
    kw.setdefault("join_adaptive", False)
    kw.setdefault("partition_watermarks", False)
    return p.ctx(**kw)


def _aggs(p):
    return aggs(p, COLS)


def _oracle(p, Lb, Rb, L, S, *, flt=None, join_type="inner", band=None,
            **kw):
    ctx = _cfg(p, slice_windows=True, slice_unit_ms=1000,
               slice_sort_lane=True, **kw)
    ds = _joined(p, ctx, Lb, Rb, join_type=join_type, band=band)
    if flt is not None:
        ds = ds.filter(flt(p.col))
    out = {}
    f = sink(out, COLS)
    for b in ds.window(["k"], _aggs(p), L, S).stream():
        f(b)
    return out


def _w_gt(c):
    return c("w") > 50.0


def _both(monkeypatch, pump, scenario):
    got = {}
    for name, p in PKGS.items():
        with monkeypatch.context() as m:
            pump(m, p)
            got[name] = scenario(p)
    assert got["jax"] == got["torch"]
    return got["torch"]


@pytest.mark.parametrize("join_type", ["inner", "left"])
def test_shared_join_group_matches_independent(monkeypatch, join_type):
    Lb = _feed(1, 20, 80, keys=4)
    Rb = _feed(2, 20, 10, keys=4 if join_type == "inner" else 2)
    kw = {} if join_type == "inner" else {"join_retention_ms": 2500}

    def scenario(p):
        ctx = _cfg(p, **kw)
        joined = _joined(p, ctx, Lb, Rb, join_type=join_type)
        outs = [{}, {}, {}]
        rep = p.mq.run_queries(ctx, [
            (joined.window(["k"], _aggs(p), 3000, 1000), sink(outs[0], COLS)),
            (joined.window(["k"], _aggs(p), 5000, 1000), sink(outs[1], COLS)),
            (joined.filter(_w_gt(p.col)).window(["k"], _aggs(p), 2000, 1000),
             sink(outs[2], COLS)),
        ])
        rep = {**rep, "groups": [
            {k: v for k, v in g.items() if k != "query_ids"}
            for g in rep["groups"]]}
        return rep, outs

    rep, outs = _both(monkeypatch, sequential_pump, scenario)
    (g,) = rep["groups"]
    assert g["shared"] and g["members"] == [0, 1, 2] and g["unit_ms"] == 1000
    p = PKGS["torch"]
    with monkeypatch.context() as m:
        sequential_pump(m, p)
        for out, (L, S, flt) in zip(outs, [(3000, 1000, None),
                                           (5000, 1000, None),
                                           (2000, 1000, _w_gt)]):
            assert out and out == _oracle(p, Lb, Rb, L, S, flt=flt,
                                          join_type=join_type, **kw)


def test_shared_band_join_late_rows_and_eviction(monkeypatch):
    late = 400
    Lb = _feed(5, 20, 60, epoch_keys=False, jitter=late)
    Rb = _feed(6, 20, 10, epoch_keys=False, jitter=late)
    band = ("ts", "ts2", -300, 300)
    kw = {"join_band_slack_ms": late}

    def scenario(p):
        ctx = _cfg(p, **kw)
        joined = _joined(p, ctx, Lb, Rb, band=band)
        outs = [{}, {}]
        sp = p.mq.SharedPipeline(ctx, [
            (joined.window(["k"], _aggs(p), 3000, 1000), sink(outs[0], COLS)),
            (joined.filter(_w_gt(p.col)).window(["k"], _aggs(p), 2000, 1000),
             sink(outs[1], COLS)),
        ])
        sp.run()
        join = p.mq._find_shared_join(sp.root)
        return outs, join._metrics["evicted"]

    outs, evicted = _both(monkeypatch, sequential_pump, scenario)
    assert evicted > 0
    p = PKGS["torch"]
    with monkeypatch.context() as m:
        sequential_pump(m, p)
        assert outs[0] == _oracle(p, Lb, Rb, 3000, 1000, band=band, **kw)
        assert outs[1] == _oracle(p, Lb, Rb, 2000, 1000, flt=_w_gt,
                                  band=band, **kw)


def test_skew_adaptation_and_attribution_inside_shared_group(monkeypatch):
    def celeb(seed, nb, n):
        rg = np.random.default_rng(seed)
        out = []
        for b in range(nb):
            base = T0 + b * 1000
            ts = np.sort(base + rg.integers(0, 1000, n))
            rows = []
            for a, v in zip(ts, rg.integers(0, 100, n)):
                hot = rg.random() < 0.25
                key = "celebrity" if hot else f"k{int(rg.integers(0, 30))}"
                rows.append((int(a), key, float(v)))
            out.append(rows)
        return out

    Lb, Rb = celeb(8, 18, 300), celeb(9, 18, 40)
    band = ("ts", "ts2", -400, 400)
    kw = {"join_adaptive": True, "join_adapt_interval_s": 0.0}
    facts = {}

    def scenario(p):
        ctx = _cfg(p, **kw)
        joined = _joined(p, ctx, Lb, Rb, band=band)
        outs = [{}, {}]
        sp = p.mq.SharedPipeline(ctx, [
            (joined.window(["k"], _aggs(p), 3000, 1000), sink(outs[0], COLS)),
            (joined.filter(_w_gt(p.col)).window(["k"], _aggs(p), 2000, 1000),
             sink(outs[1], COLS)),
        ])
        sp.run()
        facts[p.name] = (p.mq._find_shared_join(sp.root), sp.root)
        return outs

    outs = _both(monkeypatch, sequential_pump, scenario)
    join, root = facts["torch"]
    assert join._policy.adaptations_total >= 1
    assert join._shared_attr
    assert join.shared_cost_ms() > 0.0
    assert join.metrics()["shared_cost_ms"] == join.shared_cost_ms()
    assert set(join._stage_ms) == {"build", "probe", "gather"}
    assert all(v > 0.0 for v in join._stage_ms.values())
    fr = root.shared_fractions()
    assert set(fr) == {0, 1}
    assert abs(sum(fr.values()) - 1.0) < 1e-9
    # the instruments the shared join feeds (port registry)
    from denormalized_tpu_torch import obs

    snap = obs.registry().snapshot()
    assert snap['dnz_mq_join_stage_ms{stage="probe"}']["count"] > 0
    assert snap["dnz_mq_join_fanout_rows_total"] > 0
    p = PKGS["torch"]
    with monkeypatch.context() as m:
        sequential_pump(m, p)
        assert outs[0] == _oracle(p, Lb, Rb, 3000, 1000, band=band)
        assert outs[1] == _oracle(p, Lb, Rb, 2000, 1000, flt=_w_gt,
                                  band=band)


def test_single_query_join_keeps_attribution_off():
    p = PKGS["torch"]
    Lb, Rb = _feed(1, 4, 40), _feed(2, 4, 10)
    ctx = _cfg(p)
    res = _joined(p, ctx, Lb, Rb).window(
        ["k"], _aggs(p), 2000, 1000).collect()
    assert res.num_rows > 0
    from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec
    from denormalized_tpu_torch.state.checkpoint import walk

    (join,) = [op for op in walk(ctx._last_physical)
               if isinstance(op, StreamingJoinExec)]
    assert not join._shared_attr
    assert "shared_cost_ms" not in join.metrics()
    assert join.shared_cost_ms() == 0.0


def test_live_join_and_leave_on_shared_join_pipeline(monkeypatch):
    Lb, Rb = _feed(10, 20, 80), _feed(11, 20, 10)
    kw = {"join_retention_ms": 2000}
    when = T0 + 8_000

    def scenario(p):
        ctx = _cfg(p, **kw)
        joined = _joined(p, ctx, Lb, Rb)
        got = [{}, {}, {}]
        sp = p.mq.SharedPipeline(ctx, [
            (joined.window(["k"], _aggs(p), 3000, 1000), sink(got[0], COLS)),
            (joined.window(["k"], _aggs(p), 2000, 2000), sink(got[1], COLS)),
        ])
        tag = sp.register(joined.window(["k"], _aggs(p), 2000, 1000),
                          sink(got[2], COLS), label="joiner", when_ts=when)
        assert tag == 2
        sp.deregister(1, when_ts=T0 + 12_000)
        sp.run()
        return got, first_exact_start(sp, tag), sp.root.metrics()[
            "subscribers"]

    got, j_start, subs = _both(monkeypatch, sequential_pump, scenario)
    assert subs == 2
    p = PKGS["torch"]
    with monkeypatch.context() as m:
        sequential_pump(m, p)
        oracle2 = _oracle(p, Lb, Rb, 2000, 1000, **kw)
        assert got[2] == {k: v for k, v in oracle2.items()
                          if k[1] >= j_start}
        assert any(k[2] <= when for k in got[2])
        assert got[0] == _oracle(p, Lb, Rb, 3000, 1000, **kw)
        oracle1 = _oracle(p, Lb, Rb, 2000, 2000, **kw)
    assert got[1] and set(got[1]) < set(oracle1)
    assert all(got[1][k] == oracle1[k] for k in got[1])


def _schedule(p, sp, joined, outs):
    t1 = sp.register(joined.window(["k"], _aggs(p), 2000, 2000),
                     sink(outs.setdefault(1, {}), COLS), when_ts=T0 + 4_000)
    sp.deregister(t1, when_ts=T0 + 9_000)
    t2 = sp.register(
        joined.filter(_w_gt(p.col)).window(["k"], _aggs(p), 2000, 1000),
        sink(outs.setdefault(2, {}), COLS), when_ts=T0 + 11_000,
    )
    assert (t1, t2) == (1, 2)


def test_kill_restore_shared_join_group_byte_identical(tmp_path, monkeypatch):
    """A stop mid-epoch after a live join and a completed join+leave, then
    restore + replay of the same schedule: per query, the union equals an
    uninterrupted run — in both packages, with equal unions."""
    Lb, Rb = _feed(12, 40, 60), _feed(13, 40, 10)

    def scenario(p):
        state_dir = str(tmp_path / p.name)

        def mk(path):
            kw = {"join_retention_ms": 2000}
            if path is not None:
                kw.update(checkpoint=True, checkpoint_interval_s=9999,
                          state_backend_path=path)
            ctx = _cfg(p, **kw)
            return ctx, _joined(p, ctx, Lb, Rb)

        golden = {0: {}}
        ctx_g, joined_g = mk(None)
        sp_g = p.mq.SharedPipeline(ctx_g, [(joined_g.window(
            ["k"], _aggs(p), 3000, 1000), sink(golden[0], COLS))])
        _schedule(p, sp_g, joined_g, golden)
        drive_with_schedule(p, sp_g, golden, cols=COLS)
        assert golden[1] and golden[2]
        got = {0: {}}
        try:
            ctx_a, joined_a = mk(state_dir)
            sp_a = p.mq.SharedPipeline(ctx_a, [(joined_a.window(
                ["k"], _aggs(p), 3000, 1000), sink(got[0], COLS))])
            _schedule(p, sp_a, joined_a, got)
            orch_a = p.Orch(interval_s=9999)
            coord_a = p.wire(sp_a.root, ctx_a, orch_a)
            assert drive_with_schedule(p, sp_a, got, kill_after_committed=6,
                                       orch=orch_a, coord=coord_a, cols=COLS)
            p.close()
            ctx_b, joined_b = mk(state_dir)
            sp_b = p.mq.SharedPipeline(ctx_b, [(joined_b.window(
                ["k"], _aggs(p), 3000, 1000), sink(got[0], COLS))])
            _schedule(p, sp_b, joined_b, got)
            orch_b = p.Orch(interval_s=9999)
            coord_b = p.wire(sp_b.root, ctx_b, orch_b)
            assert coord_b.committed_epoch is not None
            assert 2 in sp_b.root._orphans and 1 in sp_b.root._departed
            join_b = p.mq._find_shared_join(sp_b.root)
            assert coord_b.get_snapshot(join_b._ckpt[1]) is not None
            drive_with_schedule(p, sp_b, got, cols=COLS)
            assert 2 in {s.tag for s in sp_b.root._subs}
            assert not sp_b.root._orphans
        finally:
            p.close()
        for tag in (0, 1, 2):
            assert got[tag] == golden[tag], tag
        return golden

    _both(monkeypatch, lockstep_pump, scenario)
