"""The port's sharded window layouts (``denormalized_tpu_torch/parallel/
sharded_state.py``) against the JAX package's on the same seeded rings and
batches.  The JAX side runs its layouts over its 8 virtual CPU devices
(tests/conftest.py); the port's shards all sit on the CPU.  Each layout at
n = 2, 4 and 8 (two_level at 2x2 and 2x4) imports a seeded ring, takes
batches (rows, or host partials for partial_merge), and is read slot by
slot, by block, by finals and by compaction, reset and exported — every
read compared with the JAX layout's, and the port layout's ring with the
port's single-device ring fed the same.  Counts, row sets and extrema
exact; f32 sums to rtol=1e-5."""

import jax
import numpy as np
import pytest

from denormalized_tpu.ops import segment_agg as jsa
from denormalized_tpu.parallel import mesh as jmesh
from denormalized_tpu.parallel import sharded_state as jss
from denormalized_tpu_torch.ops import segment_agg as tsa
from denormalized_tpu_torch.parallel import mesh as tmesh
from denormalized_tpu_torch.parallel import sharded_state as tss

AGGS = (("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 1),
        ("count", None))
FINALS = (("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 1))

# (layout, shards): two_level at 2 slices x n/2 key shards
CASES = [(lay, n) for lay in ("key_sharded", "partial_final", "partial_merge")
         for n in (2, 4, 8)] + [("two_level", 4), ("two_level", 8)]
CLASSES = {
    "key_sharded": "KeyShardedWindowState",
    "partial_final": "PartialFinalWindowState",
    "partial_merge": "KeyShardedPartialMergeWindowState",
    "two_level": "TwoLevelWindowState",
}


def _specs(G=256, W=16, length=1000, slide=200):
    kw = dict(num_value_cols=2, window_slots=W, group_capacity=G,
              length_ms=length, slide_ms=slide)
    return (
        jsa.WindowKernelSpec(components=tuple(jsa.components_for(AGGS)), **kw),
        tsa.WindowKernelSpec(components=tuple(tsa.components_for(AGGS)), **kw),
    )


def _meshes(layout, n):
    if layout == "two_level":
        return (jmesh.make_mesh_2d(2, n // 2, devices=jax.devices()[:n]),
                tmesh.make_mesh_2d(2, n // 2, devices=["cpu"] * n))
    return (jmesh.make_mesh(n, devices=jax.devices()),
            tmesh.make_mesh(n, devices=["cpu"] * n))


def _pair(layout, n, **spec_kw):
    """The JAX layout and the port's, built by each package's factory."""
    jspec, tspec = _specs(**spec_kw)
    jm, tm = _meshes(layout, n)
    strategy = "auto" if layout == "partial_merge" else layout
    dstrat = "partial_merge" if layout == "partial_merge" else "scatter"
    j = jss.make_sharded_state(jspec, jm, strategy, dstrat)
    t = tss.make_sharded_state(tspec, "cpu", dstrat, tm, strategy)
    assert type(j).__name__ == type(t).__name__ == CLASSES[layout]
    assert j.strategy_name == t.strategy_name
    assert j.group_capacity == t.group_capacity
    return jspec, tspec, j, t


def _ring(spec, rng):
    """Seeded (W, G) planes: counts with sums of the same positive readings
    (so f32 sums do not cancel), extrema half at their init value."""
    W, G = spec.window_slots, spec.group_capacity
    host = {}
    for c in spec.components:
        if c.kind == "count":
            host[c.label] = rng.integers(0, 5, (W, G)).astype(np.int32)
        elif c.kind == "sum":
            host[c.label] = rng.uniform(10, 100, (W, G)).astype(np.float32)
        else:
            fill = np.inf if c.kind == "min" else -np.inf
            host[c.label] = np.where(
                rng.random((W, G)) < 0.5, fill, rng.normal(50, 10, (W, G))
            ).astype(np.float32)
    return host


def _rows(rng, G, W, slide, B=512):
    """One padded row batch: late (-1) and overflow (W) rows, a padding
    tail, nulls behind the column mask."""
    win_rel = np.clip(rng.integers(-2, W + 2, B), -1, W).astype(np.int32)
    rem = rng.integers(0, slide, B).astype(np.int32)
    gid = rng.integers(0, G, B).astype(np.int32)
    row_valid = np.ones(B, bool)
    row_valid[-40:] = False
    values = rng.uniform(10, 90, (B, 2)).astype(np.float32)
    colvalid = rng.random((B, 2)) > 0.1
    return values, colvalid, win_rel, rem, gid, row_valid


def _partials(rng, G, B=600):
    """One host-partial batch: slide units 0..5, f64 readings."""
    return (
        rng.integers(0, 6, B).astype(np.int64),
        rng.integers(0, 200, B).astype(np.int32),
        rng.integers(0, G, B).astype(np.int32),
        rng.uniform(10, 90, (B, 2)),
        rng.random((B, 2)) > 0.1,
        None,
    )


def _feed(layout, backends, rng, G, W, slide, n_batches=3, base_mod=5):
    for _ in range(n_batches):
        if layout == "partial_merge":
            batch = _partials(rng, G)
            for b in backends:
                b.accumulate(*batch, base_mod)
                b.flush_pending()
        else:
            batch = _rows(rng, G, W, slide)
            for b in backends:
                b.update(*batch, base_mod)


def _assert_planes(spec, got: dict, want: dict, exact_sums=False):
    for c in spec.components:
        a, b = np.asarray(got[c.label]), np.asarray(want[c.label])
        assert a.shape == b.shape, (c.label, a.shape, b.shape)
        if c.kind == "sum" and not exact_sums:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=c.label)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c.label)


def _assert_ring_dtypes(tspec, planes):
    for c in tspec.components:
        want = np.int32 if c.kind == "count" else np.float32
        assert planes[c.label].dtype == want, c.label


@pytest.mark.parametrize("layout, n", CASES, ids=[f"{a}-{b}" for a, b in CASES])
def test_layout_matches_jax(layout, n):
    jspec, tspec, j, t = _pair(layout, n)
    G, W, slide = jspec.group_capacity, jspec.window_slots, jspec.slide_ms
    rng = np.random.default_rng(n * 7 + len(layout))
    host = _ring(jspec, rng)
    j.import_(host)
    t.import_(host)
    _assert_planes(jspec, t.export(), j.export(), exact_sums=True)

    single = (tss.PartialMergeWindowState(tspec, "cpu")
              if layout == "partial_merge"
              else tss.SingleDeviceWindowState(tspec, "cpu", "scatter"))
    single.import_(host)
    _feed(layout, (j, t, single), rng, G, W, slide)

    # every slot, read alone
    for slot in range(W):
        _assert_planes(jspec, t.read_slot(slot), j.read_slot(slot))
    exported = t.export()
    _assert_ring_dtypes(tspec, exported)
    _assert_planes(jspec, exported, j.export())
    # the port's layout holds the single-device ring
    _assert_planes(jspec, exported, single.export())

    # per-shard counters: a scatter step or a merge in every shard
    if layout == "partial_merge":
        assert t.shard_merges == [t.merges] * n == [3] * n
        assert t.shard_scatter == [0] * n
    else:
        assert t.shard_scatter == [3] * n and t.scatter_updates == 3

    # emission: a block of 4 slots (component planes), then reset
    jb = j.read_reset_block_finish(j.read_reset_block_start(2, 4))
    tb = t.read_reset_block_finish(t.read_reset_block_start(2, 4))
    _assert_planes(jspec, tb, jb)
    t.reset_slot(9)
    j.reset_slot(9)
    _assert_planes(jspec, t.export(), j.export())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_partial_merge_emission_matches_jax(n):
    """The key-sharded partial merge's per-shard emission joined on the
    host: component blocks bounded by the live-group bucket, finals with
    the active mask, and compaction (one launch a shard, gids ascending)
    equal the JAX layout's global programs."""
    jspec, tspec, j, t = _pair("partial_merge", n, G=2048)
    rng = np.random.default_rng(40 + n)
    for b in (j, t):
        b.prepare_finals(FINALS)
    _feed("partial_merge", (j, t), rng, 1500, 16, 200)
    live = 1500  # bucket 2048: every shard holds part of it
    jf = j.read_reset_block_finish(j.read_reset_block_finals_start(0, 2, live))
    tf = t.read_reset_block_finish(t.read_reset_block_finals_start(0, 2, live))
    bits = np.unpackbits(np.asarray(jf[jsa.ACTIVE_BITS]), axis=1)
    np.testing.assert_array_equal(tf[tsa.ACTIVE_MASK],
                                  bits[:, :2048].astype(bool))
    for i in range(len(FINALS)):
        key = f"__final_{i}__"
        np.testing.assert_allclose(tf[key], np.asarray(jf[key]), rtol=1e-5,
                                   equal_nan=True, err_msg=key)
    # a narrow live set: only the first shard's block crosses
    jb = j.read_reset_block_finish(j.read_reset_block_start(2, 2, 100))
    tb = t.read_reset_block_finish(t.read_reset_block_start(2, 2, 100))
    _assert_planes(jspec, tb, jb)
    assert tb["count_star"].shape == (2, 1024)
    for slot in (4, 5, 6):
        jg, jr = j.read_slot_compact(slot)
        tg, tr = t.read_slot_compact(slot)
        np.testing.assert_array_equal(tg, jg)
        assert (np.diff(tg) > 0).all()
        _assert_planes(jspec, tr, jr)
    assert t.shard_compactions == [3] * n


@pytest.mark.parametrize("layout", ["key_sharded", "partial_final",
                                    "two_level", "partial_merge"])
def test_write_slots_and_restore_into_other_layouts(layout):
    """Snapshots are merged (W, G_total) planes: one taken at n = 4
    restores into n = 2, into one device and into every other layout, and
    whole-slot writes (the cold tier's reload) land as in the
    single-device ring."""
    jspec, tspec = _specs(G=512)
    rng = np.random.default_rng(3)
    host = _ring(tspec, rng)
    src = tss.make_sharded_state(
        tspec, "cpu",
        "partial_merge" if layout == "partial_merge" else "scatter",
        (tmesh.make_mesh_2d(2, 2, devices=["cpu"] * 4)
         if layout == "two_level"
         else tmesh.make_mesh(4, devices=["cpu"] * 4)),
        "auto" if layout == "partial_merge" else layout,
    )
    src.import_(host)
    planes = {k: rng.uniform(1, 9, (2, 512)).astype(v.dtype)
              for k, v in host.items()}
    src.write_slots([3, 7], planes)
    want = {k: v.copy() for k, v in host.items()}
    for k in want:
        want[k][[3, 7]] = planes[k]
    snap = src.export()
    _assert_planes(tspec, snap, want, exact_sums=True)
    targets = [tss.SingleDeviceWindowState(tspec, "cpu", "scatter")]
    for lay, m in (("key_sharded", tmesh.make_mesh(2, devices=["cpu"] * 2)),
                   ("partial_final", tmesh.make_mesh(2, devices=["cpu"] * 2)),
                   ("two_level", tmesh.make_mesh_2d(2, 1, devices=["cpu"] * 2))):
        targets.append(tss.make_sharded_state(tspec, "cpu", "scatter", m, lay))
    for b in targets:
        b.import_(snap)
        _assert_planes(tspec, b.export(), want, exact_sums=True)
    # the JAX layout restores the port's snapshot too
    jb = jss.make_sharded_state(jspec, jmesh.make_mesh(4), "key_sharded",
                                "scatter")
    jb.import_(snap)
    _assert_planes(tspec, jb.export(), want, exact_sums=True)


def test_batch_must_split_over_the_partial_layouts():
    _, tspec = _specs()
    t = tss.make_sharded_state(tspec, "cpu", "scatter",
                               tmesh.make_mesh(3, devices=["cpu"] * 3),
                               "partial_final")
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="do not split"):
        t.update(*_rows(rng, 256, 16, 200, B=512), 0)
    t.update(*_rows(rng, 256, 16, 200, B=513), 0)
    assert t.shard_scatter == [1, 1, 1]
