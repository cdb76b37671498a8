"""The port's host stripe (``denormalized_tpu_torch/ops/host_partial.py``)
against the JAX package's (``denormalized_tpu/ops/host_partial.py``): the
same seeded batches folded into both, and ``take_packed`` must return the
SAME BYTES — compact and dense layouts, lean and full, SUB 1 and 2, several
take cycles, f32 overflow and ±inf/NaN sums in ``_split_sum``.  Each
package's native reducer (``native/partial_agg.cpp``) and its numpy version
are held against each other as well: counts and extrema exact, sums to
rtol=1e-12."""

import numpy as np
import pytest
import torch

from denormalized_tpu.ops import host_partial as jhp
from denormalized_tpu.ops import segment_agg as jsa
from denormalized_tpu_torch.ops import host_partial as thp
from denormalized_tpu_torch.ops import segment_agg as tsa

AGGS = (("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 1))


def _specs(length_ms, slide_ms, G, compensated=False):
    def comps(sa):
        c = sa.components_for(AGGS)
        return tuple(sa.with_compensation(c) if compensated else c)

    kw = dict(num_value_cols=2, window_slots=16, group_capacity=G,
              length_ms=length_ms, slide_ms=slide_ms, compensated=compensated)
    return (
        jsa.WindowKernelSpec(components=comps(jsa), **kw),
        tsa.WindowKernelSpec(components=comps(tsa), **kw),
    )


def _batches(seed, slide_ms, keys, n_batches=4, B=500, nulls=False,
             special=None):
    """Seeded (units, rem, gid, values64, colvalid|None, keep|None)
    batches over 1-3 slide units each, with a keep mask on one batch."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        units = (7 + b + rng.integers(0, 3, B)).astype(np.int64)
        rem = rng.integers(0, slide_ms, B).astype(np.int32)
        gid = rng.integers(0, keys, B).astype(np.int32)
        vals = rng.normal(50.0, 10.0, (B, 2))
        if special == "overflow":
            vals[: B // 2, 0] = 3e38  # f32 overflow in one cell's sum
            gid[: B // 2] = 1
        elif special == "nonfinite":
            vals[3, 0], vals[4, 0], vals[5, 1] = np.inf, -np.inf, np.nan
        colvalid = None
        if nulls:
            colvalid = rng.random((B, 2)) > 0.2
            vals[~colvalid & (rng.random((B, 2)) < 0.5)] = np.nan
        keep = rng.random(B) > 0.1 if b == 1 else None
        out.append((units, rem, gid, vals, colvalid, keep))
    return out


CASES = {
    # name: (length, slide, G, keys, nulls, special)
    "dense_lean_sub1": (1000, 1000, 128, 10, False, None),
    "dense_full_sub2": (500, 200, 128, 40, True, None),
    "compact_lean_sub2": (500, 200, 16384, 5, False, None),
    "compact_full_sub1": (1000, 250, 16384, 7, True, None),
    "f32_overflow": (1000, 1000, 128, 10, False, "overflow"),
    "inf_nan": (1000, 200, 16384, 10, True, "nonfinite"),
}


def _fold(stripe, batches, base_mod):
    """Fold the batches, taking the stripe after the second and the last
    → the list of take_packed results."""
    taken = []
    for i, b in enumerate(batches):
        stripe.add_batch(*b)
        if i in (1, len(batches) - 1):
            taken.append(stripe.take_packed(base_mod + i))
    return taken


def _run(case, lane, monkeypatch):
    length, slide, G, keys, nulls, special = CASES[case]
    jspec, tspec = _specs(length, slide, G)
    batches = _batches(7, slide, keys, nulls=nulls, special=special)
    if lane == "numpy":
        monkeypatch.setattr(jhp, "_LIB", None)
        monkeypatch.setattr(jhp, "_LIB_TRIED", True)
        monkeypatch.setattr(thp, "_native", lambda: None)
    jstripe = jhp.HostPartialStripe(jspec, G)
    tstripe = thp.HostPartialStripe(tspec, G)
    return _fold(jstripe, batches, 3), _fold(tstripe, batches, 3), tstripe


def _assert_same(jt, tt):
    assert len(jt) == len(tt)
    for j, t in zip(jt, tt):
        jp, ja, ju, jl, jd = j
        tp, ta, tu, tl, td = t
        assert (ta, tu, tl, td) == (ja, ju, jl, jd)
        assert tp.dtype == np.int32 and tp.shape == jp.shape
        assert tp.tobytes() == jp.tobytes()


@pytest.mark.parametrize("lane", ["native", "numpy"])
@pytest.mark.parametrize("case", list(CASES))
def test_take_packed_is_byte_identical_to_jax(case, lane, monkeypatch):
    jt, tt, stripe = _run(case, lane, monkeypatch)
    _assert_same(jt, tt)
    if lane == "native":
        assert stripe.native_batches == 4 and stripe.numpy_batches == 0
    else:
        assert stripe.numpy_batches == 4 and stripe.native_batches == 0
    layouts = {t[4] for t in tt}
    lean = {t[3] for t in tt}
    length, slide, G, keys, nulls, special = CASES[case]
    assert layouts == {G == 128}  # the layout each case is named for
    assert lean == {not nulls}


def _decode(stripe, taken):
    """A packed stripe → its index row (compact) and {label: f64 plane},
    each sum as hi + lo."""
    packed, a_pad, _u, lean, dense = taken
    rows = packed[:, :a_pad]
    index = None if dense else rows[0]
    planes = rows if dense else rows[1:]
    out, pi = {}, 0
    for c in stripe._packed_components(lean):
        f = planes[pi].view(np.float32).astype(np.float64)
        if c.kind == "sum":
            f = f + planes[pi + 1].view(np.float32).astype(np.float64)
            pi += 1
        out[c.label] = f
        pi += 1
    return index, out


@pytest.mark.parametrize("case", list(CASES))
def test_native_reducer_matches_numpy(case, monkeypatch):
    """Counts, min and max exact; sums to rtol=1e-12 (np.bincount and the
    native loop round their f64 sums differently in the last bits)."""
    _, native, stripe = _run(case, "native", monkeypatch)
    _, numpy_lane, _ = _run(case, "numpy", monkeypatch)
    for a, b in zip(native, numpy_lane):
        assert a[1:] == b[1:]
        ia, pa = _decode(stripe, a)
        ib, pb = _decode(stripe, b)
        np.testing.assert_array_equal(ia, ib)
        for label in pa:
            if label.startswith("sum"):
                np.testing.assert_allclose(pa[label], pb[label], rtol=1e-12)
            else:
                np.testing.assert_array_equal(pa[label], pb[label])


def test_split_sum_overflow_and_nonfinite():
    """f32 overflow of a finite sum → (+inf, 0); ±inf and NaN sums → (x,
    0); an f64 ring refuses an overflowing sum, as in the JAX package."""
    src = np.array([1.5, 3e38 * 2, np.inf, -np.inf, np.nan, 1e-40, -7.25])
    for compensated in (False, True):
        jspec, tspec = _specs(1000, 1000, 128, compensated)
        j = jhp.HostPartialStripe(jspec, 128)._split_sum(src)
        t = thp.HostPartialStripe(tspec, 128)._split_sum(src)
        for a, b in zip(j, t):
            assert a.tobytes() == b.tobytes()
    hi, lo = (x.view(np.float32) for x in t)
    assert np.isposinf(hi[1]) and lo[1] == 0 and np.isnan(hi[4]) and lo[4] == 0
    f64 = tsa.WindowKernelSpec(
        components=tspec.components, num_value_cols=2, window_slots=16,
        group_capacity=128, length_ms=1000, slide_ms=1000,
        accum_dtype=torch.float64,
    )
    with pytest.raises(OverflowError, match="float32 range"):
        thp.HostPartialStripe(f64, 128)._split_sum(src)


@pytest.mark.parametrize("lean", [False, True])
def test_dense_noop_and_buckets_match_jax(lean):
    for G in (128, 2048, 200_064):
        jspec, tspec = _specs(500, 200, G)
        j = jhp.HostPartialStripe(jspec, G)
        t = thp.HostPartialStripe(tspec, G)
        assert t.transfer_buckets() == j.transfer_buckets()
        assert t.n_planes(lean) == j.n_planes(lean)
        a_pad = t.transfer_buckets()[-1]
        assert t.dense_noop(a_pad, lean).tobytes() == (
            j.dense_noop(a_pad, lean).tobytes()
        )
    assert thp.NEUTRAL_BITS == jhp.NEUTRAL_BITS
