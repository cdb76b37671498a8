"""The port's stripe fold against the JAX package's: the same packed stripe
(built by the port's ``HostPartialStripe``, whose bytes equal the JAX
package's — tests/test_torch_host_partial.py) folded into the same seeded
ring by ``denormalized_tpu_torch.ops.merge_partials.merge_partials`` (on
CPU tensors: its plain version ``segment_agg.merge_partials_reference``)
and by ``denormalized_tpu.ops.segment_agg.merge_partials``.  Counts, min
and max exact (NaN where NaN); sums to rtol=1e-5 (f32 adds in another
order)."""

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
}


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


def _packed(tspec, case_args, rng):
    """One stripe of seeded rows through the port's HostPartialStripe →
    take_packed's (packed, a_pad, u_base, lean, dense)."""
    (_L, slide, _W, G, keys, u0, span, nulls, nans, _c) = case_args
    B = 3000
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
