"""The port's dense window update (``ops/dense_window.py``) against the JAX
package's Pallas kernel (``ops/pallas_window.py``, interpret mode on the
CPU): the partials of ``dense_partials`` and the ring after
``dense_update`` + ``merge_partials``.  On the CPU the wrapper runs its
plain version; ``chip_smoke.py`` holds the CUDA kernel against that plain
version on the card.

Tolerances: counts, min and max exact (NaN where NaN); sums to rtol=1e-5,
the repo's own dense-vs-scatter tolerance (tests/test_pallas_dense.py) —
the two sum the same f32 values in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denormalized_tpu.ops import pallas_window as pw
from denormalized_tpu.ops import segment_agg as jsa
from denormalized_tpu_torch.ops import dense_window as dw
from denormalized_tpu_torch.ops import segment_agg as tsa

K = dw.K_ACTIVE


def _inputs(B, G, V, KREL, seed):
    """Seeded inputs with nulls, NaN behind the null mask, a valid NaN,
    dropped rows (rel = -1) and rel >= K_ACTIVE.  A row's rel columns name
    distinct slots, as dense_update builds them."""
    rng = np.random.default_rng(seed)
    values = rng.normal(50.0, 10.0, (B, V)).astype(np.float32)
    colvalid = (rng.random((B, V)) > 0.15).astype(np.float32)
    values[(colvalid == 0) & (rng.random((B, V)) < 0.5)] = np.nan
    # one VALID NaN: its cell's sum, min and max become NaN
    values[3, 0], colvalid[3, 0] = np.nan, 1.0
    first = rng.integers(-1, K + 2, B)
    rel = (first[:, None] + np.arange(KREL)[None, :]).astype(np.int32)
    rel[rng.random(B) < 0.05] = -1
    rel[3] = np.arange(KREL)  # the valid NaN's row lands in the ring
    gid = rng.integers(0, G, B).astype(np.int32)
    return values, colvalid, rel, gid


def _assert_partials(got, want):
    for name, a, b in zip(("rowcnt", "cnt", "sum", "min", "max"), got, want):
        a = np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name == "sum":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# a covering set of B ∈ {256, 1024}, G ∈ {128, 256}, V ∈ {1, 2},
# KREL ∈ {1, 5}: every pair of values of any two factors appears (each case
# compiles the interpret-mode Pallas kernel anew, so not the full product)
@pytest.mark.parametrize(
    "B, G, V, KREL",
    [
        (256, 128, 1, 1),
        (256, 256, 2, 5),
        (1024, 128, 2, 5),
        (1024, 256, 1, 5),
        (1024, 256, 2, 1),
    ],
)
def test_dense_partials_match_pallas(B, G, V, KREL):
    values, colvalid, rel, gid = _inputs(B, G, V, KREL, seed=B + G + V + KREL)
    want = pw._dense_partials(
        jnp.asarray(values), jnp.asarray(colvalid), jnp.asarray(rel),
        jnp.asarray(gid), G=G, V=V, KREL=KREL, interpret=True,
    )
    got = dw.dense_partials(
        torch.from_numpy(values), torch.from_numpy(colvalid),
        torch.from_numpy(rel), torch.from_numpy(gid), G,
    )
    assert np.isnan(np.asarray(got[3])[:, 0]).any()  # the valid NaN landed
    _assert_partials([g.numpy() for g in got], [np.asarray(w) for w in want])


AGGS = [("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 0)]


def _specs(length_ms, slide_ms, W=16, G=128):
    j = jsa.WindowKernelSpec(
        components=tuple(jsa.components_for(AGGS)), num_value_cols=1,
        window_slots=W, group_capacity=G, length_ms=length_ms,
        slide_ms=slide_ms,
    )
    t = tsa.WindowKernelSpec(
        components=tuple(tsa.components_for(AGGS)), num_value_cols=1,
        window_slots=W, group_capacity=G, length_ms=length_ms,
        slide_ms=slide_ms,
    )
    return j, t


def _seeded_ring(spec, rng):
    """A ring already holding data in some slots."""
    W, G = spec.window_slots, spec.group_capacity
    host = {}
    for c in spec.components:
        if c.kind == "count":
            host[c.label] = rng.integers(0, 5, (W, G)).astype(np.int32)
        elif c.kind == "sum":
            host[c.label] = rng.normal(0, 100, (W, G)).astype(np.float32)
        elif c.kind == "min":
            host[c.label] = np.where(
                rng.random((W, G)) < 0.5, np.inf, rng.normal(50, 10, (W, G))
            ).astype(np.float32)
        else:
            host[c.label] = np.where(
                rng.random((W, G)) < 0.5, -np.inf, rng.normal(50, 10, (W, G))
            ).astype(np.float32)
    return host


@pytest.mark.parametrize(
    "length_ms, slide_ms", [(1000, 1000), (1000, 200), (1000, 300)],
    ids=["tumbling", "k5", "L_mod_S"],
)
def test_dense_update_and_merge_match_pallas(length_ms, slide_ms):
    jspec, tspec = _specs(length_ms, slide_ms)
    rng = np.random.default_rng(length_ms + slide_ms)
    host = _seeded_ring(jspec, rng)
    B, k = 512, jspec.length_units
    win_rel = rng.integers(0, 4, B).astype(np.int32)
    win_rel[:5] = -1  # late rows
    rem = rng.integers(0, slide_ms, B).astype(np.int32)
    gid = rng.integers(0, 100, B).astype(np.int32)
    row_valid = np.ones(B, bool)
    row_valid[-40:] = False  # padding
    values = rng.normal(50, 10, (B, 1)).astype(np.float32)
    colvalid = rng.random((B, 1)) > 0.1
    values[~colvalid[:, 0] & (rng.random(B) < 0.5), 0] = np.nan
    base_mod, lo = 13, max(0 - (k - 1), 0)

    jstate = {lbl: jnp.asarray(a) for lbl, a in host.items()}
    jout = pw.dense_update(
        jspec, jstate, jnp.asarray(values), jnp.asarray(colvalid),
        jnp.asarray(win_rel), jnp.asarray(rem), jnp.asarray(gid),
        jnp.asarray(row_valid), jnp.asarray(base_mod, jnp.int32),
        min_win_rel=lo, interpret=True,
    )
    tstate = tsa.import_state(tspec, host, "cpu")
    tout = dw.dense_update(
        tspec, tstate, *(torch.from_numpy(a) for a in (
            values, colvalid, win_rel, rem, gid, row_valid)),
        base_mod, min_win_rel=lo,
    )
    assert tout is tstate  # updated in place
    for c in jspec.components:
        a, b = tout[c.label].numpy(), np.asarray(jout[c.label])
        assert a.dtype == b.dtype, (c.label, a.dtype, b.dtype)
        if c.kind == "sum":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=c.label)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c.label)


@pytest.mark.parametrize(
    "G, length_ms, slide_ms",
    [(2048, 1000, 1000), (2176, 1000, 1000), (128, 1000, 125),
     (128, 1000, 111)],
)
def test_dense_supported_limits_match_the_jax_package(G, length_ms, slide_ms):
    """Same limits (G ≤ 2048, length_units ≤ 8), so both packages dispatch
    the same batches; on the card groups tile so any G within the limit
    fits shared memory."""
    jspec, tspec = _specs(length_ms, slide_ms, G=G)
    assert dw.dense_supported(tspec) == pw.dense_supported(jspec)
    tile = dw.group_tile(G, 2)
    assert 4 * K * tile * (1 + 4 * 2) <= dw.SMEM_BUDGET_BYTES
