"""The port's stripe fold against the JAX package's: the same packed stripe
(built by the port's ``HostPartialStripe``, whose bytes equal the JAX
package's — tests/test_torch_host_partial.py) folded into the same seeded
ring by ``denormalized_tpu_torch.ops.merge_partials.merge_partials`` (on
CPU tensors: its plain version ``segment_agg.merge_partials_reference``)
and by ``denormalized_tpu.ops.segment_agg.merge_partials`` — and, for a
ring that holds one shard of a wider group space (``G_total = 2·cap``,
``g_shift`` ∈ {0, cap}), by ``merge_partials_body`` jitted on the CPU.
Counts, min and max exact (NaN where NaN); sums to rtol=1e-5 (f32 adds in
another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denormalized_tpu.ops import segment_agg as jsa
from denormalized_tpu_torch.ops import host_partial as thp
from denormalized_tpu_torch.ops import merge_partials as tmp
from denormalized_tpu_torch.ops import segment_agg as tsa

AGGS = (("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 1))

# name: (length, slide, W, G, keys, first unit, units spanned, nulls,
#        valid NaNs, compensated)
CASES = {
    # dense layout, lean (no nulls), one unit past the ring's phase
    "tumbling": (1000, 1000, 16, 128, 10, 3, 2, False, False, False),
    # k=5 sliding, full layout, valid NaNs and NaNs already in the ring
    "k5_nan": (1000, 200, 16, 128, 30, 2, 4, True, True, False),
    # L % S != 0 (SUB=2, k=3), compact layout with -1 padding, compensated
    "ragged_compact_compensated": (500, 200, 16, 16384, 9, 4, 3, True,
                                   False, True),
    # windows outside [0, W): units from -2 past the ring's end are dropped
    "slot_out_of_range": (1000, 250, 8, 128, 12, -2, 12, False, False,
                          False),
    # a ring smaller than the fan-out: W=4 < k=5
    "W_lt_k": (1000, 200, 4, 128, 6, -1, 6, True, False, False),
    # compact tumbling with valid NaNs (G large, few keys)
    "compact_nan": (1000, 1000, 16, 16384, 7, 1, 2, False, True, False),
    # L % S != 0 (SUB=2, k=3) in the dense layout: 3 units x 2 x 128 cells
    "ragged_dense": (500, 200, 16, 128, 9, 1, 3, True, False, False),
    # compact tumbling at a 100K-scale G (2^17 groups), few rows
    "compact_100k": (1000, 1000, 8, 131_072, 100_000, 2, 2, False, False,
                     False),
}
# the kernel each case takes on the card (ops/merge_partials.merge_branch)
BRANCH = {"tumbling": "tumbling", "k5_nan": "gather",
          "ragged_compact_compensated": "scatter",
          "slot_out_of_range": "scatter", "W_lt_k": "gather",
          "compact_nan": "tumbling", "ragged_dense": "gather",
          "compact_100k": "tumbling"}


def _specs(length, slide, W, G, compensated):
    def comps(sa):
        c = sa.components_for(AGGS)
        return tuple(sa.with_compensation(c) if compensated else c)

    kw = dict(num_value_cols=2, window_slots=W, group_capacity=G,
              length_ms=length, slide_ms=slide, compensated=compensated)
    return (
        jsa.WindowKernelSpec(components=comps(jsa), **kw),
        tsa.WindowKernelSpec(components=comps(tsa), **kw),
    )


def _ring(spec, rng, nan_cells: bool):
    """Host planes: 0-4 rows a cell, sums of positive readings (no
    cancellation under rtol), extrema where a cell has rows."""
    W, G = spec.window_slots, spec.group_capacity
    counts = rng.integers(0, 5, (W, G)).astype(np.int32)
    host = {}
    for c in spec.components:
        if c.kind == "count":
            host[c.label] = counts
        elif c.kind == "sum":
            host[c.label] = (counts * rng.normal(50, 10, (W, G))).astype(
                np.float32)
        elif c.kind == "sumc":
            host[c.label] = rng.normal(0, 1e-5, (W, G)).astype(np.float32)
        else:
            fill = np.inf if c.kind == "min" else -np.inf
            host[c.label] = np.where(
                counts > 0, rng.normal(50, 10, (W, G)), fill
            ).astype(np.float32)
    if nan_cells:
        for label in ("min_0", "max_0"):
            host[label][rng.integers(0, W, 6), rng.integers(0, 8, 6)] = np.nan
    return host


def _packed(tspec, case_args, rng, B=3000):
    """One stripe of ``B`` seeded rows through the port's HostPartialStripe
    → take_packed's (packed, a_pad, u_base, lean, dense)."""
    (_L, slide, _W, G, keys, u0, span, nulls, nans, _c) = case_args
    units = (u0 + rng.integers(0, span, B)).astype(np.int64)
    units[:2] = (u0, u0 + span - 1)  # the whole span
    rem = rng.integers(0, slide, B).astype(np.int32)
    gid = rng.integers(0, keys, B).astype(np.int32)
    vals = rng.normal(50.0, 10.0, (B, 2))
    colvalid = None
    if nulls:
        colvalid = rng.random((B, 2)) > 0.2
        vals[~colvalid & (rng.random((B, 2)) < 0.5)] = np.nan
    if nans:
        rows = rng.integers(0, B, 3)
        vals[rows, 0] = np.nan
        if colvalid is not None:
            colvalid[rows, 0] = True
    stripe = thp.HostPartialStripe(tspec, G)
    stripe.add_batch(units, rem, gid, vals, colvalid, None)
    return stripe.take_packed(int(rng.integers(0, tspec.window_slots))), stripe


def span_cells(args) -> int:
    """Cells of the stripe's span: ≤ 1024 packs dense at G = 128."""
    length, slide, _W, G, _k, _u0, span, *_ = args
    return span * G * (1 if length % slide == 0 else 2)


@pytest.mark.parametrize("case", list(CASES))
def test_merge_partials_matches_jax(case):
    args = CASES[case]
    length, slide, W, G, *_rest, compensated = args
    jspec, tspec = _specs(length, slide, W, G, compensated)
    rng = np.random.default_rng(sum(map(ord, case)))
    (packed, a_pad, _u, lean, dense), stripe = _packed(tspec, args, rng)
    assert dense == ("compact" not in case and span_cells(args) <= 1024)
    if not dense:
        assert (packed[0, :a_pad] == -1).any()  # padding cells
    host = _ring(tspec, rng, nan_cells=case.endswith("nan"))

    jstate = {k: jnp.asarray(v) for k, v in host.items()}
    jout = jsa.merge_partials(jspec, stripe.SUB, a_pad, lean, dense, jstate,
                              jnp.asarray(packed))
    tstate = tsa.import_state(tspec, host, "cpu")
    before = tmp.merge_partials_launches
    tout = tmp.merge_partials(tspec, stripe.SUB, a_pad, lean, dense, tstate,
                              torch.from_numpy(packed))
    assert tout is tstate  # in place
    assert tmp.merge_partials_launches == before  # the plain version ran
    assert tmp.merge_branch(tspec, dense) == BRANCH[case]

    changed = False
    for c in tspec.components:
        got = tout[c.label].numpy()
        want = np.asarray(jout[c.label])
        changed |= not np.array_equal(got, host[c.label], equal_nan=True)
        if c.kind in ("sum", "sumc"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                       err_msg=c.label)
        else:
            np.testing.assert_array_equal(got, want, err_msg=c.label)
    assert changed


# jitted on the CPU as the key-sharded merge calls it, per shard
_jax_body = functools.partial(jax.jit, static_argnums=(0, 1, 2, 5, 7, 8))(
    jsa.merge_partials_body
)

# name: the CASES tuple of a stripe over G_total = 2 x cap groups, where
# G is the ring's cap
SHIFT_CASES = {
    # dense: 2 units x 256 groups, both halves live
    "dense_tumbling": (1000, 1000, 16, 128, 256, 3, 2, False, False, False),
    # dense, k=5 sliding, nulls
    "dense_k5": (1000, 200, 16, 128, 256, 2, 4, True, False, False),
    # compact (few rows over 2 x 8192 groups), valid NaNs
    "compact_tumbling": (1000, 1000, 16, 8192, 16384, 1, 2, False, True,
                         False),
    # compact, SUB=2, compensated
    "compact_ragged": (500, 200, 16, 8192, 16384, 4, 3, True, False, True),
}
# rows of a stripe: few enough over 16,384 groups for the compact layout
SHIFT_ROWS = {"dense_tumbling": 3000, "dense_k5": 3000,
              "compact_tumbling": 400, "compact_ragged": 400}


@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("case", list(SHIFT_CASES))
def test_group_shift_matches_merge_partials_body(case, shard):
    """A ring of ``cap`` groups holding shard ``shard`` of a stripe over
    ``G_total = 2·cap`` groups: the port's fold (plain version, through the
    wrapper) against the JAX body with the same ``G_total`` and
    ``g_shift``.  The other shard's cells are dropped."""
    args = SHIFT_CASES[case]
    length, slide, W, cap, *_rest, compensated = args
    G_total, g_shift = 2 * cap, shard * cap
    jspec, tspec = _specs(length, slide, W, cap, compensated)
    rng = np.random.default_rng(sum(map(ord, case)) + shard)
    (packed, a_pad, _u, lean, dense), stripe = _packed(
        tspec, args[:3] + (G_total,) + args[4:], rng, SHIFT_ROWS[case])
    assert dense == case.startswith("dense")
    # live cells in both shards
    flat = np.arange(a_pad) if dense else packed[0, :a_pad]
    gid = (flat % G_total)[(packed[0 if dense else 1, :a_pad] != 0)
                           & (flat >= 0)]
    assert (gid < cap).any() and (gid >= cap).any()
    host = _ring(tspec, rng, nan_cells=False)

    jstate = {k: jnp.asarray(v) for k, v in host.items()}
    jout = _jax_body(jspec, stripe.SUB, a_pad, jstate, jnp.asarray(packed),
                     G_total, jnp.asarray(g_shift, jnp.int32), lean, dense)
    tout = tmp.merge_partials(tspec, stripe.SUB, a_pad, lean, dense,
                              tsa.import_state(tspec, host, "cpu"),
                              torch.from_numpy(packed), G_total=G_total,
                              g_shift=g_shift)
    changed = False
    for c in tspec.components:
        got = tout[c.label].numpy()
        want = np.asarray(jout[c.label])
        changed |= not np.array_equal(got, host[c.label], equal_nan=True)
        if c.kind in ("sum", "sumc"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0,
                                       err_msg=c.label)
        else:
            np.testing.assert_array_equal(got, want, err_msg=c.label)
    assert changed

    # the shard's fold is the whole-space fold's columns [g_shift, +cap)
    wide_j, wide_t = _specs(length, slide, W, G_total, compensated)
    wide = {k: np.zeros((W, G_total), v.dtype) for k, v in host.items()}
    for k, v in host.items():
        wide[k][:, g_shift:g_shift + cap] = v
    full = tsa.merge_partials_reference(
        wide_t, stripe.SUB, a_pad, lean, dense,
        tsa.import_state(wide_t, wide, "cpu"), torch.from_numpy(packed))
    for c in tspec.components:
        np.testing.assert_array_equal(
            tout[c.label].numpy(),
            full[c.label].numpy()[:, g_shift:g_shift + cap], err_msg=c.label)


def test_group_shift_rejects_bad_arguments():
    _jspec, tspec = _specs(1000, 1000, 16, 128, False)
    state = tsa.init_state(tspec, "cpu")
    packed = torch.zeros((4, 1026), dtype=torch.int32)
    for kw in ({"G_total": 0}, {"g_shift": -1}):
        with pytest.raises(ValueError):
            tmp.merge_partials(tspec, 1, 1024, True, True, state, packed,
                               **kw)


def test_launch_table_is_kept_per_ring():
    """The wrapper validates a ring's planes and builds its launch table
    once, and builds a new one for a ring whose planes were replaced (a
    regrown, restored or imported ring)."""
    _jspec, tspec = _specs(1000, 200, 16, 128, True)
    cpu = torch.device("cpu")
    ring = tsa.init_state(tspec, cpu)
    table, n = tmp._launch_table(tspec, False, ring, cpu)
    again, _ = tmp._launch_table(tspec, False, ring, cpu)
    assert again is table
    assert n == len(tmp.merge_ops(tspec, False)[0])
    sums = [op for op in table if op.kind == tmp._OP_KIND["sum"]]
    assert [op.dst_lo for op in sums] == [
        ring[f"sumc_{c}"].data_ptr() for c in (0, 1)]  # compensated
    lean, _ = tmp._launch_table(tspec, True, ring, cpu)
    assert lean is not table  # the lean layout reads other planes
    new_ring = tsa.import_state(tspec, tsa.export_state(ring), cpu)
    fresh, _ = tmp._launch_table(tspec, False, new_ring, cpu)
    assert fresh is not table
    assert fresh[0].dst == new_ring["count_star"].data_ptr()
    bad = dict(new_ring, min_0=torch.zeros((16, 64)))
    with pytest.raises(ValueError):
        tmp._launch_table(tspec, False, bad, cpu)
