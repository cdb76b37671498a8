"""Kill/restore of the port's shared slice pipelines, and slice snapshots
across the two packages.

Twins of ``tests/test_multi_query_checkpoint.py`` and of the kill/restore
half of ``tests/test_live_registration.py``, each run as a WRITER × READER
matrix: run A (one package) commits one epoch, keeps emitting past it and
stops hard (the mid-epoch progress a SIGKILL loses); run B (the same or
the other package) restores the committed ``slice_{node_id}`` snapshot and
drives to the end.  Per query, the union of both runs' windows must equal
the uninterrupted oracle.  Covered: three fold cadences with stddev (the
variance pivot rides the snapshot); sketch planes (HLL registers, KLL
levels, Space-Saving planes and the value-id interner); a live
registration schedule (a joiner's cursor kept as an orphan and adopted by
tag, a departed tag replayed as a no-op); the per-query cursors; and the
snapshot each package writes at the same cut, which must be equal (meta
without the wall-clock epoch, and every array).

Tolerance: none.  Restored folds are host float64 in both packages, so the
unions equal the oracles with ``==``, sketch estimates included.
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
    base_of,
    drive_with_schedule,
    sink,
)

#: three fold cadences over one 500 ms gcd slice
SPECS = [(3000, 1000), (4000, 2000), (1000, 500)]
MATRIX = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]


def _raw(seed, n_batches=24, rows=300, n_keys=5, integer=False):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 500 + rng.integers(0, 500, rows))
        ks = np.asarray([f"s{i}" for i in rng.integers(0, n_keys, rows)],
                        object)
        vs = (rng.integers(0, 50, rows).astype(np.float64) if integer
              else rng.normal(10.0, 3.0, rows))
        out.append((ts, ks, vs))
    return out


def _aggs(p, kind):
    F, c = p.F, p.col
    if kind == "approx":
        return [F.approx_distinct(c("v")).alias("nd"),
                F.approx_median(c("v")).alias("med"),
                F.approx_top_k(c("v"), 3).alias("top"),
                F.sum(c("v")).alias("s")]
    return aggs(p) + [F.stddev(c("v")).alias("sd")]


COLS = {"plain": ("c", "s", "mn", "mx", "av", "sd"),
        "approx": ("nd", "med", "top", "s")}


def _rows_of(batch, acc, cols):
    for i in range(batch.num_rows):
        key = (batch.column("k")[i], int(batch.column("window_start_time")[i]),
               int(batch.column("window_end_time")[i]))
        row = []
        for c in cols:
            v = batch.column(c)[i]
            row.append(tuple(tuple(x) for x in v) if isinstance(v, list)
                       else float(v))
        acc[key] = tuple(row)


def _root(p, ctx, raw, kind):
    from denormalized_tpu.planner.sharing import detect_sharing as jd
    from denormalized_tpu_torch.planner.sharing import detect_sharing as td

    base = base_of(p, ctx, raw)
    plans = [base.window(["k"], _aggs(p, kind), L, S)._plan for L, S in SPECS]
    groups = (jd if p.name == "jax" else td)(plans)
    assert len(groups) == 1 and groups[0].shared
    return p.mq.build_shared_root(ctx, groups[0])


def _oracles(raw, kind):
    p = PKGS["torch"]
    out = []
    for L, S in SPECS:
        ds = base_of(p, p.ctx(slice_windows=True, slice_unit_ms=500),
                     raw).window(["k"], _aggs(p, kind), L, S)
        acc = {}
        for b in ds.stream():
            _rows_of(b, acc, COLS[kind])
        out.append(acc)
    assert all(out)
    return out


def _ckpt_cfg(path):
    return dict(checkpoint=True, checkpoint_interval_s=9999,
                state_backend_path=path)


def _run_a(p, raw, kind, path, got, *, trigger_at=8, kill_after=9):
    """Commit one epoch after ``trigger_at`` emissions, emit
    ``kill_after`` more, stop hard → the root (its cursors at the stop)."""
    ctx = p.ctx(**_ckpt_cfg(path))
    root = _root(p, ctx, raw, kind)
    orch = p.Orch(interval_s=9999)
    coord = p.wire(root, ctx, orch)
    emissions, committed, post, triggered = 0, False, 0, False
    it = root.run()
    for item in it:
        if isinstance(item, p.SubBatch):
            _rows_of(item.batch, got[item.tag], COLS[kind])
            emissions += 1
            if committed:
                post += 1
                if post >= kill_after:
                    break
        if emissions == trigger_at and not triggered:
            # ONE barrier: a second one would stay queued on the source's
            # channel and cut the next run at its start
            orch.trigger_now()
            triggered = True
        if isinstance(item, p.Marker):
            coord.commit(item.epoch)
            committed = True
    it.close()
    assert committed and post >= kill_after
    p.close()
    return root


@pytest.mark.parametrize("writer,reader", MATRIX)
@pytest.mark.parametrize("kind", ["plain", "approx"])
def test_shared_kill_restore_union_equals_oracles(tmp_path, writer, reader,
                                                  kind):
    raw = _raw(5 if kind == "plain" else 7, integer=kind == "approx")
    oracles = _oracles(raw, kind)
    path = str(tmp_path / "state")
    got = [dict() for _ in SPECS]
    pa, pb = PKGS[writer], PKGS[reader]
    try:
        _run_a(pa, raw, kind, path, got)
        ctx = pb.ctx(**_ckpt_cfg(path))
        root = _root(pb, ctx, raw, kind)
        coord = pb.wire(root, ctx, pb.Orch(interval_s=9999))
        assert coord.committed_epoch is not None
        for item in root.run():
            if isinstance(item, pb.SubBatch):
                _rows_of(item.batch, got[item.tag], COLS[kind])
    finally:
        pa.close()
        pb.close()
    for q in range(len(SPECS)):
        assert got[q] == oracles[q], q


@pytest.mark.parametrize("writer,reader", MATRIX)
def test_restore_resumes_each_querys_own_cursor(tmp_path, writer, reader):
    raw = _raw(9, n_batches=16)
    path = str(tmp_path / "state")
    pa, pb = PKGS[writer], PKGS[reader]
    try:
        ctx = pa.ctx(**_ckpt_cfg(path))
        root_a = _root(pa, ctx, raw, "plain")
        orch = pa.Orch(interval_s=9999)
        coord = pa.wire(root_a, ctx, orch)
        emissions = 0
        it = root_a.run()
        for item in it:
            if isinstance(item, pa.SubBatch):
                emissions += 1
            if emissions == 10:
                orch.trigger_now()
                emissions += 1
            if isinstance(item, pa.Marker):
                coord.commit(item.epoch)
                break
        cursors = list(root_a._next_win)
        it.close()
        pa.close()
        ctx_b = pb.ctx(**_ckpt_cfg(path))
        root_b = _root(pb, ctx_b, raw, "plain")
        pb.wire(root_b, ctx_b, pb.Orch(interval_s=9999))
        assert root_b._next_win == cursors
        starts = [nw * SPECS[q][1] for q, nw in enumerate(root_b._next_win)]
        assert len(set(starts)) > 1
    finally:
        pa.close()
        pb.close()


def test_both_packages_write_the_same_snapshot(tmp_path):
    """The same feed and the same cut: the ``slice_0`` blob each package
    commits unpacks to equal meta (the epoch, a wall-clock stamp, aside)
    and equal arrays."""
    from denormalized_tpu.state.serialization import unpack_snapshot as ju
    from denormalized_tpu_torch.state.serialization import (
        unpack_snapshot as tu,
    )

    raw = _raw(11, n_batches=16, integer=True)
    snaps = {}
    for name, p in PKGS.items():
        path = str(tmp_path / name)
        got = [dict() for _ in SPECS]
        try:
            root = _run_a(p, raw, "approx", path, got, kill_after=1)
            ctx = p.ctx(**_ckpt_cfg(path))
            probe = _root(p, ctx, raw, "approx")
            coord = p.wire(probe, ctx, p.Orch(interval_s=9999))
            blob = coord.get_snapshot(probe._ckpt[1])
            assert root._ckpt[1] == probe._ckpt[1] == "slice_0_SliceWindowExec"
        finally:
            p.close()
        meta, arrays = (ju if name == "jax" else tu)(blob)
        meta.pop("epoch")
        snaps[name] = (meta, arrays)
    (mj, aj), (mt, at) = snaps["jax"], snaps["torch"]
    assert mj == mt
    assert sorted(aj) == sorted(at) and aj
    for k in aj:
        assert np.array_equal(aj[k], at[k], equal_nan=True), k


# -- a live registration schedule across the kill ---------------------------


def _schedule(p, sp, base, outs):
    """A short-lived query joins at +4s and leaves at +9s; a residual
    joiner at +11s outlives the run (event-time thresholds: the schedule
    lands at the same stream positions on every replay)."""
    t1 = sp.register(base.window(["k"], aggs(p), 2000, 2000),
                     sink(outs.setdefault(1, {})), when_ts=T0 + 4_000)
    sp.deregister(t1, when_ts=T0 + 9_000)
    t2 = sp.register(
        base.filter(p.col("v") > 12.0).window(["k"], aggs(p), 2000, 1000),
        sink(outs.setdefault(2, {})), when_ts=T0 + 11_000,
    )
    assert (t1, t2) == (1, 2)


def _golden(raw):
    p = PKGS["torch"]
    golden = {0: {}}
    ctx = p.ctx()
    base = base_of(p, ctx, raw)
    sp = p.mq.SharedPipeline(
        ctx, [(base.window(["k"], aggs(p), 3000, 1000), sink(golden[0]))]
    )
    _schedule(p, sp, base, golden)
    drive_with_schedule(p, sp, golden)
    assert golden[1] and golden[2]
    return golden


@pytest.mark.parametrize("writer,reader", MATRIX)
def test_kill_restore_with_live_joins_orphans_and_departed(tmp_path, writer,
                                                           reader):
    from torch_mq_twins import raw_feed

    raw = raw_feed(35, n_batches=24)
    golden = _golden(raw)
    path = str(tmp_path / "state")
    pa, pb = PKGS[writer], PKGS[reader]
    got = {0: {}}
    try:
        ctx_a = pa.ctx(**_ckpt_cfg(path))
        base_a = base_of(pa, ctx_a, raw)
        sp_a = pa.mq.SharedPipeline(ctx_a, [(base_a.window(
            ["k"], aggs(pa), 3000, 1000), sink(got[0]))])
        _schedule(pa, sp_a, base_a, got)
        orch_a = pa.Orch(interval_s=9999)
        coord_a = pa.wire(sp_a.root, ctx_a, orch_a)
        assert drive_with_schedule(pa, sp_a, got, kill_after_committed=6,
                                   orch=orch_a, coord=coord_a)
        pa.close()
        ctx_b = pb.ctx(**_ckpt_cfg(path))
        base_b = base_of(pb, ctx_b, raw)
        sp_b = pb.mq.SharedPipeline(ctx_b, [(base_b.window(
            ["k"], aggs(pb), 3000, 1000), sink(got[0]))])
        _schedule(pb, sp_b, base_b, got)
        coord_b = pb.wire(sp_b.root, ctx_b, pb.Orch(interval_s=9999))
        assert coord_b.committed_epoch is not None
        # the joiner's cursor waits as an orphan; the departed tag is known
        assert 2 in sp_b.root._orphans
        assert 1 in sp_b.root._departed
        drive_with_schedule(pb, sp_b, got)
        assert 2 in {s.tag for s in sp_b.root._subs}
        assert not sp_b.root._orphans
    finally:
        pa.close()
        pb.close()
    for tag in (0, 1, 2):
        assert got[tag] == golden[tag], tag


@pytest.mark.parametrize("pkg", list(PKGS))
def test_restore_refuses_a_changed_subscriber(tmp_path, pkg):
    """A subscriber whose window spec changed since the checkpoint is
    refused loudly (docs/multi_query.md, "Checkpoint layout")."""
    p = PKGS[pkg]
    raw = _raw(13, n_batches=12)
    path = str(tmp_path / "state")
    try:
        _run_a(p, raw, "plain", path, [dict() for _ in SPECS], kill_after=1)
        ctx = p.ctx(**_ckpt_cfg(path))
        base = base_of(p, ctx, raw)
        # same unit (500 ms), member 1's slide changed: 4000/2000 → 4000/1000
        changed = [(3000, 1000), (4000, 1000), (1000, 500)]
        sp = p.mq.SharedPipeline(ctx, [
            (base.window(["k"], _aggs(p, "plain"), L, S), sink({}))
            for L, S in changed
        ])
        with pytest.raises(p.StateError, match="does not match its snapshot"):
            p.wire(sp.root, ctx, p.Orch(interval_s=9999))
    finally:
        p.close()
