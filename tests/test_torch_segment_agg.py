"""The port's ring programs (``denormalized_tpu_torch/ops/segment_agg.py``)
against the JAX package's (``denormalized_tpu/ops/segment_agg.py``) on the
same seeded rings and batches: the scatter ``update_state`` (tumbling,
k=5 sliding, L % S != 0) with late, out-of-range, null and padding rows,
the emission gathers (lean and full), the finals, and slot read/reset and
export/import.  Counts, min and max exact; sums to rtol=1e-5 (f32 sums in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denormalized_tpu.ops import segment_agg as jsa
from denormalized_tpu_torch.ops import segment_agg as tsa

AGGS = (("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 1),
        ("count", None))


def _specs(length_ms, slide_ms, W=16, G=128):
    kw = dict(num_value_cols=2, window_slots=W, group_capacity=G,
              length_ms=length_ms, slide_ms=slide_ms)
    return (
        jsa.WindowKernelSpec(components=tuple(jsa.components_for(AGGS)), **kw),
        tsa.WindowKernelSpec(components=tuple(tsa.components_for(AGGS)), **kw),
    )


def _ring(spec, rng):
    W, G = spec.window_slots, spec.group_capacity
    host = {}
    for c in spec.components:
        if c.kind == "count":
            host[c.label] = rng.integers(0, 5, (W, G)).astype(np.int32)
        elif c.kind == "sum":
            host[c.label] = rng.normal(0, 100, (W, G)).astype(np.float32)
        else:
            fill = np.inf if c.kind == "min" else -np.inf
            host[c.label] = np.where(
                rng.random((W, G)) < 0.5, fill, rng.normal(50, 10, (W, G))
            ).astype(np.float32)
    return host


def _batch(rng, W, slide_ms, B=600):
    win_rel = rng.integers(-2, W + 2, B).astype(np.int32)  # late + overflow
    win_rel = np.clip(win_rel, -1, W).astype(np.int32)  # as window_exec does
    rem = rng.integers(0, slide_ms, B).astype(np.int32)
    gid = rng.integers(0, 120, B).astype(np.int32)
    row_valid = np.ones(B, bool)
    row_valid[-50:] = False
    values = rng.normal(50, 10, (B, 2)).astype(np.float32)
    colvalid = rng.random((B, 2)) > 0.1
    values[~colvalid & (rng.random((B, 2)) < 0.5)] = np.nan  # behind mask
    return values, colvalid, win_rel, rem, gid, row_valid


def _assert_planes(spec, got: dict, want: dict):
    assert set(got) == set(want)
    for c in spec.components:
        a, b = np.asarray(got[c.label]), np.asarray(want[c.label])
        assert a.dtype == b.dtype and a.shape == b.shape, c.label
        if c.kind == "sum":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=c.label)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c.label)


@pytest.mark.parametrize(
    "length_ms, slide_ms", [(1000, 1000), (1000, 200), (1000, 300)],
    ids=["tumbling", "k5", "L_mod_S"],
)
def test_update_state_matches_jax(length_ms, slide_ms):
    jspec, tspec = _specs(length_ms, slide_ms)
    rng = np.random.default_rng(slide_ms)
    host = _ring(jspec, rng)
    batch = _batch(rng, jspec.window_slots, slide_ms)
    base_mod = 11
    want = jsa.update_state(
        jspec, {k: jnp.asarray(v) for k, v in host.items()},
        *(jnp.asarray(a) for a in batch), jnp.asarray(base_mod, jnp.int32),
    )
    tstate = tsa.import_state(tspec, host, "cpu")
    got = tsa.update_state(
        tspec, tstate, *(torch.from_numpy(a) for a in batch), base_mod
    )
    assert got is tstate  # in place
    _assert_planes(tspec, tsa.export_state(got), jsa.export_state(want))


@pytest.mark.parametrize(
    "length_ms, slide_ms", [(1000, 1000), (1000, 200), (1000, 300)],
    ids=["tumbling", "k5", "L_mod_S"],
)
def test_compensated_update_matches_jax(length_ms, slide_ms):
    """Compensated sums: the batch scatters into fresh partials, folded
    into (hi, lo) = ('sum', 'sumc') by TwoSum.  Counts and extrema exact;
    hi and hi + lo to rtol=1e-5."""
    kw = dict(num_value_cols=2, window_slots=16, group_capacity=128,
              length_ms=length_ms, slide_ms=slide_ms, compensated=True)
    jspec = jsa.WindowKernelSpec(
        components=tuple(jsa.with_compensation(jsa.components_for(AGGS))),
        **kw)
    tspec = tsa.WindowKernelSpec(
        components=tuple(tsa.with_compensation(tsa.components_for(AGGS))),
        **kw)
    assert [c.label for c in tspec.components] == [
        c.label for c in jspec.components]
    rng = np.random.default_rng(slide_ms + 1)
    host = _ring(jspec, rng)
    for c in jspec.components:
        if c.kind == "sumc":
            host[c.label] = rng.normal(0, 1e-4, (16, 128)).astype(np.float32)
    batch = _batch(rng, 16, slide_ms)
    want = jsa.export_state(jsa.update_state(
        jspec, {k: jnp.asarray(v) for k, v in host.items()},
        *(jnp.asarray(a) for a in batch), jnp.asarray(5, jnp.int32),
    ))
    got = tsa.export_state(tsa.update_state(
        tspec, tsa.import_state(tspec, host, "cpu"),
        *(torch.from_numpy(a) for a in batch), 5,
    ))
    for c in tspec.components:
        a, b = got[c.label], np.asarray(want[c.label])
        assert a.dtype == b.dtype, c.label
        if c.kind == "sum":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=c.label)
            lo = tsa.AggComponent("sumc", c.col).label
            np.testing.assert_allclose(
                a.astype(np.float64) + got[lo], b.astype(np.float64) + want[lo],
                rtol=1e-5, err_msg=lo)
            assert np.any(got[lo] != host[lo])  # the fold wrote lo
        elif c.kind != "sumc":
            np.testing.assert_array_equal(a, b, err_msg=c.label)


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
@pytest.mark.parametrize("n, first_slot, g_bucket", [(1, 3, 128), (4, 14, 64)])
def test_gather_and_reset_matches_jax(lean, n, first_slot, g_bucket):
    jspec, tspec = _specs(1000, 200)
    host = _ring(jspec, np.random.default_rng(n + first_slot))
    jstate, jout = jsa._gather_and_reset(
        jspec, n, g_bucket, {k: jnp.asarray(v) for k, v in host.items()},
        jnp.asarray(first_slot, jnp.int32), lean,
    )
    tstate = tsa.import_state(tspec, host, "cpu")
    tout = tsa._gather_and_reset(tspec, n, g_bucket, tstate, first_slot, lean)
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    _assert_planes(tspec, tsa.export_state(tstate), jsa.export_state(jstate))


@pytest.mark.parametrize("n, first_slot, g_bucket", [(2, 5, 128), (8, 12, 64)])
def test_finals_and_reset_matches_jax(n, first_slot, g_bucket):
    jspec, tspec = _specs(1000, 1000)
    rng = np.random.default_rng(first_slot)
    host = _ring(jspec, rng)
    # empty cells: zero row count, init extrema → NaN finals, inactive
    host["count_star"][first_slot % 16, :40] = 0
    host["count_1"][first_slot % 16, :60] = 0
    jstate, jout = jsa._finals_and_reset(
        jspec, AGGS, n, g_bucket, {k: jnp.asarray(v) for k, v in host.items()},
        jnp.asarray(first_slot, jnp.int32),
    )
    tstate = tsa.import_state(tspec, host, "cpu")
    tout = tsa._finals_and_reset(tspec, AGGS, n, g_bucket, tstate, first_slot)
    # the JAX package packs the active mask big-endian; the port ships the
    # mask itself — the unpacked bits must be the same
    bits = np.unpackbits(np.asarray(jout[jsa.ACTIVE_BITS]), axis=1)
    np.testing.assert_array_equal(
        tout[tsa.ACTIVE_MASK].numpy(), bits[:, :g_bucket].astype(bool)
    )
    for i, (kind, _col) in enumerate(AGGS):
        a, b = tout[f"__final_{i}__"].numpy(), np.asarray(jout[f"__final_{i}__"])
        assert a.dtype == b.dtype, (kind, a.dtype, b.dtype)
        if kind in ("sum", "avg"):
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=kind)
        else:
            np.testing.assert_array_equal(a, b, err_msg=kind)
    _assert_planes(tspec, tsa.export_state(tstate), jsa.export_state(jstate))


def test_read_reset_slot_and_import_padding_match_jax():
    jspec, tspec = _specs(1000, 500)
    host = _ring(jspec, np.random.default_rng(5))
    jstate = {k: jnp.asarray(v) for k, v in host.items()}
    tstate = tsa.import_state(tspec, host, "cpu")
    for slot in (0, 7, 15):
        want = jsa.read_slot(jspec, jstate, slot)
        got = tsa.read_slot(tspec, tstate, slot)
        _assert_planes(tspec, got, want)
    jstate = jsa.reset_slot(jspec, jstate, jnp.asarray(7, jnp.int32))
    tsa.reset_slot(tspec, tstate, 7)
    _assert_planes(tspec, tsa.export_state(tstate), jsa.export_state(jstate))
    # import pads a smaller host snapshot into a larger (W, G) ring
    jbig, tbig = _specs(1000, 500, W=32, G=256)
    want = jsa.export_state(jsa.import_state(jbig, host))
    got = tsa.export_state(tsa.import_state(tbig, host, "cpu"))
    _assert_planes(tbig, got, want)
