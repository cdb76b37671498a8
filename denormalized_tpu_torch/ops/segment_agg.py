"""Device-resident windowed segment aggregation — the ring buffer programs.

Counterpart of ``denormalized_tpu/ops/segment_agg.py`` in PyTorch.  One set
of ``(num_window_slots, group_capacity)`` accumulator tensors, one per
primitive component, lives on the device for *all* open windows:

- window slots form a ring over the window index (slide index), so sliding
  windows fan out on-device without duplicating row data;
- group keys arrive as dense int32 ids from the host interner
  (:mod:`denormalized_tpu_torch.ops.interner`);
- nulls are neutralized per aggregate kind (0 for sum, ±inf for min/max)
  with ``torch.where`` — select, never multiply, so a NaN behind a null
  mask cannot reach a sum;
- where the JAX package donates buffers, these functions update the ring
  tensors IN PLACE (``index_add_``, ``scatter_reduce_``, slice assignment);
- late rows (window < first_open), ring overflow and padding rows are
  dropped.  torch has no ``mode="drop"``, so they are masked out BEFORE
  indexing: an out-of-range flat index would raise or land in another cell.

Every function except :func:`finalize` and the variance helpers runs on
the ring's device.  Counts are int32 and sums/min/max ``accum_dtype``
(float32 by default, float64 with ``EngineConfig.accum_dtype``), as in the
JAX package; nothing widens silently.

:func:`read_slot_compact` reads one slot through the compaction kernel
(``ops/compact_slot.py``): the active count first, then a power-of-two
prefix of the compacted buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.logical.expr import VAR_KINDS


@dataclass(frozen=True)
class AggComponent:
    """One primitive accumulator buffer.  Composite aggregates decompose:
    avg = sum + count (exactly as DataFusion's AvgGroupsAccumulator does)."""

    kind: str  # 'count' | 'sum' | 'sumc' | 'min' | 'max'
    col: int | None  # value-column index; None = row count (count(*))

    @property
    def label(self) -> str:
        return f"{self.kind}_{'star' if self.col is None else self.col}"


# presence counter: always first so emission knows which groups are active
ROW_COUNT = AggComponent("count", None)


def variance_result(
    kind: str, c: np.ndarray, s: np.ndarray, s2: np.ndarray
) -> np.ndarray:
    """Variance finalize: ``s``/``s2`` are Σ(x−K) and Σ(x−K)² for a
    constant shift K near the data's magnitude, so the ``s2 − s²/c``
    subtraction does not cancel catastrophically (with K=0 and epoch-scale
    values the two terms agree to ~24 digits); the shift cancels exactly
    in the algebra."""
    c = np.asarray(c, np.float64)
    s = np.asarray(s, np.float64)
    s2 = np.asarray(s2, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        m2 = np.maximum(s2 - s * s / np.maximum(c, 1), 0.0)
    return variance_from_m2(kind, c, m2)


def variance_from_m2(kind: str, c, m2):
    """Variance finalize from (count, M2) moments: ``*_pop`` divides by c,
    the sample kinds by c − 1 (NaN below 2 rows); ``stddev*`` takes the
    square root."""
    c = np.asarray(c, np.float64)
    m2 = np.asarray(m2, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        if kind.endswith("_pop"):
            v = np.where(c > 0, m2 / np.maximum(c, 1), np.nan)
        else:
            v = np.where(c > 1, m2 / np.maximum(c - 1, 1), np.nan)
    return np.sqrt(v) if kind.startswith("stddev") else v


def chan_merge(n1, mean1, m21, n2, mean2, m22):
    """Chan et al.'s parallel combine of (count, mean, M2) moment pairs —
    stable at any magnitude, exact merge algebra."""
    n = n1 + n2
    if n == 0:
        return 0.0, 0.0, 0.0
    delta = mean2 - mean1
    mean = mean1 + delta * n2 / n
    m2 = m21 + m22 + delta * delta * n1 * n2 / n
    return n, mean, m2


def components_for(aggs: list[tuple]) -> list[AggComponent]:
    """Decompose aggregate specs into deduped primitive components.

    Entries are ``(kind, value_col)`` — or, for the variance family,
    ``(kind, shifted_col, shifted_sq_col)``: the caller registers two value
    columns holding (x−K) and (x−K)² for a pivot K it picks from the first
    data it sees (see :func:`variance_result`).  ``avg`` → sum + count;
    variance → sum + count + sum of squares over the shifted columns."""
    comps: list[AggComponent] = [ROW_COUNT]
    for spec in aggs:
        kind, col = spec[0], spec[1]
        if kind == "count":
            wanted = [AggComponent("count", col)]
        elif kind == "avg":
            wanted = [AggComponent("sum", col), AggComponent("count", col)]
        elif kind in VAR_KINDS:
            wanted = [
                AggComponent("sum", col),
                AggComponent("count", col),
                AggComponent("sum", spec[2]),
            ]
        elif kind in ("sum", "min", "max"):
            wanted = [AggComponent(kind, col)]
        else:
            raise PlanError(
                f"aggregate kind {kind!r} not yet ported to "
                "denormalized_tpu_torch"
            )
        for c in wanted:
            if c not in comps:
                comps.append(c)
    return comps


def with_compensation(comps: list[AggComponent]) -> list[AggComponent]:
    """Add a low-order ('sumc') companion for every 'sum' component —
    storage for compensated accumulation (see :func:`update_state`)."""
    out = list(comps)
    for c in comps:
        if c.kind == "sum":
            out.append(AggComponent("sumc", c.col))
    return out


def read_sum(rows: dict[str, np.ndarray], col: int) -> np.ndarray:
    """A column's total from an emitted row set: hi + lo when compensated
    (lo absent → plain)."""
    hi = rows[AggComponent("sum", col).label].astype(np.float64)
    lo = rows.get(AggComponent("sumc", col).label)
    return hi if lo is None else hi + lo.astype(np.float64)


@dataclass(frozen=True)
class WindowKernelSpec:
    """Static configuration of one window ring.

    Window indexing: windows are identified by their *slide index* ``j``,
    covering ``[j*slide_ms, j*slide_ms + length_ms)`` in epoch milliseconds.
    The host rebases indices to ``win_rel = j - first_open`` so the device
    works in small int32s; ring slots use the *absolute* index mod W via
    ``base_mod``."""

    components: tuple[AggComponent, ...]
    num_value_cols: int
    window_slots: int  # W — ring size over open window indices
    group_capacity: int  # G — padded group-id capacity (multiple of 128)
    length_ms: int
    slide_ms: int
    accum_dtype: Any = torch.float32
    # compensated summation: each batch's contribution is scattered into a
    # fresh per-batch partial, then folded into the running (hi, lo) pair
    # ('sum', 'sumc') with an exact TwoSum — cross-batch rounding vanishes,
    # leaving only intra-batch scatter rounding
    compensated: bool = False

    @property
    def length_units(self) -> int:
        """k = number of windows each row fans out to."""
        return -(-self.length_ms // self.slide_ms)

    def init_dtype(self, comp: AggComponent) -> torch.dtype:
        return torch.int32 if comp.kind == "count" else self.accum_dtype

    def init_value(self, comp: AggComponent) -> float:
        if comp.kind in ("count", "sum", "sumc"):
            return 0
        if comp.kind == "min":
            return float("inf")
        if comp.kind == "max":
            return float("-inf")
        raise ValueError(comp.kind)


def init_state(
    spec: WindowKernelSpec, device: torch.device | str
) -> dict[str, torch.Tensor]:
    """Allocate the device-resident accumulator buffers: one (W, G) tensor
    per primitive component."""
    shape = (spec.window_slots, spec.group_capacity)
    return {
        c.label: torch.full(
            shape, spec.init_value(c), dtype=spec.init_dtype(c), device=device
        )
        for c in spec.components
    }


def _apply_component(
    comp: AggComponent,
    flat: torch.Tensor,  # (W*G,) view of the component's ring
    idx: torch.Tensor,  # (n,) int64 flat cell index of the kept rows
    values: torch.Tensor,  # (n, V) accum dtype, kept rows only
    colvalid: torch.Tensor,  # (n, V) bool, kept rows only
) -> None:
    if comp.kind == "count":
        if comp.col is None:
            inc = torch.ones(idx.shape, dtype=flat.dtype, device=flat.device)
        else:
            inc = colvalid[:, comp.col].to(flat.dtype)
        flat.index_add_(0, idx, inc)
        return
    v = values[:, comp.col]
    ok = colvalid[:, comp.col]
    if comp.kind == "sum":
        flat.index_add_(0, idx, torch.where(ok, v, torch.zeros_like(v)))
    elif comp.kind == "min":
        flat.scatter_reduce_(
            0, idx, torch.where(ok, v, torch.full_like(v, float("inf"))),
            reduce="amin",
        )
    elif comp.kind == "max":
        flat.scatter_reduce_(
            0, idx, torch.where(ok, v, torch.full_like(v, float("-inf"))),
            reduce="amax",
        )
    else:
        raise ValueError(comp.kind)


def update_state(
    spec: WindowKernelSpec,
    state: dict[str, torch.Tensor],
    values: torch.Tensor,  # (B, V)
    colvalid: torch.Tensor,  # (B, V) bool
    win_rel: torch.Tensor,  # (B,) int32: slide-index of row minus first_open
    rem_ms: torch.Tensor,  # (B,) int32: ts - slide_index*slide (in [0, S))
    gid: torch.Tensor,  # (B,) int32 dense group ids from the host interner
    row_valid: torch.Tensor,  # (B,) bool (padding rows false)
    base_mod: int,  # first_open % W (ring phase)
) -> dict[str, torch.Tensor]:
    """The scatter path: scatter the batch into every window frame it
    belongs to, updating ``state`` in place.  A row with slide-index ``t``
    belongs to windows ``t-k+1 .. t`` (k = length_units).

    Compensated mode scatters the 'sum' components into fresh per-batch
    partials and folds each into its (hi, lo) = ('sum', 'sumc') pair once
    at the end by Knuth's TwoSum, written as separate ops in the reference
    order (nothing reassociates them)."""
    W = spec.window_slots
    G = spec.group_capacity
    values = values.to(spec.accum_dtype)
    gid64 = gid.long()
    # compensated mode: the sum components scatter into these partials
    targets = dict(state)
    if spec.compensated:
        for comp in spec.components:
            if comp.kind == "sum":
                targets[comp.label] = torch.zeros_like(state[comp.label])
    for i in range(spec.length_units):
        wr = win_rel - i  # rebased index of the i-th window this row feeds
        # membership: window covers the row iff i*S + rem < L; late rows
        # (wr < 0) and ring overflow (wr >= W) are masked out
        ok = row_valid & (wr >= 0) & (wr < W)
        if spec.length_ms - i * spec.slide_ms < spec.slide_ms:
            ok = ok & (rem_ms < spec.length_ms - i * spec.slide_ms)
        ok = ok & (gid64 >= 0) & (gid64 < G)
        keep = torch.nonzero(ok).squeeze(1)
        slot = (wr[keep].long() + base_mod) % W
        idx = slot * G + gid64[keep]
        vals_k = values[keep]
        valid_k = colvalid[keep]
        for comp in spec.components:
            if comp.kind == "sumc":
                continue  # written only by the TwoSum fold below
            _apply_component(
                comp, targets[comp.label].view(-1), idx, vals_k, valid_k
            )
    if spec.compensated:
        for comp in spec.components:
            if comp.kind != "sum":
                continue
            lo_label = AggComponent("sumc", comp.col).label
            hi, lo, p = state[comp.label], state[lo_label], targets[comp.label]
            # Knuth TwoSum: s + e == hi + p exactly
            s = hi + p
            t = s - hi
            e = (hi - (s - t)) + (p - t)
            hi.copy_(s)
            lo.add_(e)
    return state


def lean_skippable(c: AggComponent) -> bool:
    """Whether ``c``'s plane is omitted from the LEAN gather layout and
    aliased to the row-count plane (a null-free stream's per-column counts
    equal its row counts cell for cell)."""
    return c.kind == "count" and c.col is not None


def lean_possible(spec: WindowKernelSpec) -> bool:
    """Whether the lean layout differs from the full one for this spec."""
    return any(lean_skippable(c) for c in spec.components)


def merge_partials_reference(
    spec: WindowKernelSpec,
    SUB: int,
    a_pad: int,
    lean: bool,
    dense: bool,
    state: dict[str, torch.Tensor],
    packed: torch.Tensor,  # int32, (P+1, a_pad+2) compact / (P, a_pad+2) dense
    G_total: int | None = None,
    g_shift: int = 0,
) -> dict[str, torch.Tensor]:
    """Fold a packed host stripe (``ops/host_partial.py``) into the ring in
    place — the plain PyTorch version of the kernels
    ``csrc/merge_partials.cu`` (wrapper
    :func:`denormalized_tpu_torch.ops.merge_partials.merge_partials`), and
    what the JAX package's ``merge_partials_body`` computes.  The ring holds
    groups ``[g_shift, g_shift + G)`` of the stripe's ``G_total``-wide group
    space (one device: ``G_total = G``, ``g_shift = 0``, the defaults); a
    cell whose group falls outside is dropped.

    ``packed`` is an int32 carrier: ``u_base_rel`` (stripe unit 0 relative
    to first_open) and ``base_mod`` (first_open % W) sit in row 0's two
    tail slots.  The compact layout's row 0 holds flat cell indices
    ``((u*SUB)+s)*G_total + g`` (−1 = padding) and its value planes start
    at row 1; the dense layout has no index row (cell i is flat index i,
    padding fold-neutral) and its planes start at row 0.  Value planes are f32
    bitcasts: one per count/min/max component (counts go to the int32
    rings), two per sum (hi, lo) — both added to 'sum', or lo to 'sumc' in
    compensated mode.  ``lean`` aliases every per-column count to the
    row-count plane.  Unit u's partial feeds windows u-k+1..u; with SUB = 2
    sub-bucket 1 is left out of the oldest.  A window outside [0, W) is
    dropped, never clamped."""
    W, G = spec.window_slots, spec.group_capacity
    G_total = G if G_total is None else G_total
    u_base_rel = int(packed[0, a_pad])
    base_mod = int(packed[0, a_pad + 1])
    dev = packed.device
    if dense:
        flat = torch.arange(a_pad, dtype=torch.long, device=dev)
        valid = torch.ones(a_pad, dtype=torch.bool, device=dev)
    else:
        idx = packed[0, :a_pad].long()
        valid = idx >= 0
        flat = torch.clamp(idx, min=0)
    g = flat % G_total - g_shift
    valid = valid & (g >= 0) & (g < G)
    us = flat // G_total
    s = us % SUB
    u = us // SUB
    plane0 = 0 if dense else 1

    def f32_plane(pi: int) -> torch.Tensor:
        return packed[plane0 + pi, :a_pad].contiguous().view(torch.float32)

    for i in range(spec.length_units):
        ok = valid
        if SUB == 2 and i == spec.length_units - 1:
            ok = ok & (s == 0)
        w_rel = u_base_rel + u - i
        ok = ok & (w_rel >= 0) & (w_rel < W)
        keep = torch.nonzero(ok).squeeze(1)
        cell = ((base_mod + w_rel[keep]) % W) * G + g[keep]
        pi = 0
        for comp in spec.components:
            if comp.kind == "sumc":
                continue
            buf = state[comp.label].view(-1)
            if comp.kind == "sum":
                hi = f32_plane(pi)[keep].to(buf.dtype)
                lo = f32_plane(pi + 1)[keep].to(buf.dtype)
                buf.index_add_(0, cell, hi)
                if spec.compensated:
                    lo_buf = state[AggComponent("sumc", comp.col).label]
                    lo_buf.view(-1).index_add_(0, cell, lo)
                else:
                    # two adds keep most of the host f64 precision even in
                    # an f32 ring
                    buf.index_add_(0, cell, lo)
                pi += 2
                continue
            if lean and lean_skippable(comp):
                pv = f32_plane(0)[keep]  # alias the row-count plane
            else:
                pv = f32_plane(pi)[keep]
                pi += 1
            if comp.kind == "count":
                buf.index_add_(0, cell, pv.to(buf.dtype))
            else:
                buf.scatter_reduce_(
                    0, cell, pv.to(buf.dtype),
                    reduce="amin" if comp.kind == "min" else "amax",
                )
    return state


def _read_and_reset_slots(
    spec: WindowKernelSpec,
    n: int,
    g_bucket: int,
    state: dict[str, torch.Tensor],
    first_slot: int,
):
    """Copy of ``n`` consecutive ring slots (``:g_bucket`` group prefix) of
    EVERY component, and re-initialization of those slots in place — the
    shared read+reset core of both emission paths."""
    W = spec.window_slots
    any_state = next(iter(state.values()))
    slots = (
        first_slot + torch.arange(n, dtype=torch.long, device=any_state.device)
    ) % W
    comp = {}
    for c in spec.components:
        buf = state[c.label]
        comp[c.label] = buf[slots, :g_bucket]  # advanced index: a copy
        # only the transferred prefix needs resetting: cells beyond the
        # live-group prefix were never written
        buf[slots, :g_bucket] = spec.init_value(c)
    return comp


def _gather_and_reset(
    spec: WindowKernelSpec,
    n: int,
    g_bucket: int,
    state: dict[str, torch.Tensor],
    first_slot: int,
    lean: bool = False,
) -> dict[str, torch.Tensor]:
    """Read ``n`` consecutive ring slots AND reset them.  ``lean`` omits
    per-column count planes (the host aliases them back to the row
    count)."""
    comp = _read_and_reset_slots(spec, n, g_bucket, state, first_slot)
    return {
        c.label: comp[c.label]
        for c in spec.components
        if not (lean and lean_skippable(c))
    }


# aggregate kinds whose final value is cheap elementwise math over the
# component planes — eligible for on-device finalization at emission
BASIC_FINAL_KINDS = ("count", "sum", "min", "max", "avg")

# key of the active-group mask in a finals emission block.  The JAX package
# packs it big-endian with jnp.packbits; torch has no packbits, so the port
# ships the (n, g_bucket) bool mask itself — emission reads it as the
# unpacked bits, so the emitted rows are the same.
ACTIVE_MASK = "__active__"


def finals_possible(agg_specs: tuple) -> bool:
    """True when every output aggregate can be finalized on device (the
    variance family needs the host's pivot-shifted f64 algebra)."""
    return all(s[0] in BASIC_FINAL_KINDS for s in agg_specs)


def _finals_and_reset(
    spec: WindowKernelSpec,
    agg_specs: tuple,
    n: int,
    g_bucket: int,
    state: dict[str, torch.Tensor],
    first_slot: int,
) -> dict[str, torch.Tensor]:
    """Emission with on-device finalization: read ``n`` ring slots, compute
    the FINAL output columns (count/sum/min/max/avg) and the active-group
    mask on device, reset the slots, and return only the finals."""
    comp = _read_and_reset_slots(spec, n, g_bucket, state, first_slot)
    rc = comp[ROW_COUNT.label]
    out = {ACTIVE_MASK: rc > 0}

    def cnt_of(col):
        lbl = AggComponent("count", col).label
        return comp[lbl] if lbl in comp else rc

    def sum_of(col):
        hi = comp[AggComponent("sum", col).label]
        lo = comp.get(AggComponent("sumc", col).label)
        return hi if lo is None else hi + lo

    nan = torch.tensor(float("nan"), dtype=spec.accum_dtype, device=rc.device)
    for i, s in enumerate(agg_specs):
        kind, col = s[0], s[1]
        if kind == "count":
            f = cnt_of(col)
        elif kind == "sum":
            f = sum_of(col)
        elif kind == "avg":
            c = cnt_of(col)
            # int32 count / f32 sum → f32, as jnp's promotion does
            f = torch.where(
                c > 0, sum_of(col) / torch.clamp(c, min=1).to(spec.accum_dtype),
                nan,
            )
        elif kind == "min":
            v = comp[AggComponent("min", col).label]
            f = torch.where(torch.isposinf(v), nan, v)
        elif kind == "max":
            v = comp[AggComponent("max", col).label]
            f = torch.where(torch.isneginf(v), nan, v)
        else:  # pragma: no cover — guarded by finals_possible
            raise ValueError(kind)
        out[f"__final_{i}__"] = f
    return out


def reset_slot(
    spec: WindowKernelSpec, state: dict[str, torch.Tensor], slot: int
) -> dict[str, torch.Tensor]:
    """Re-initialize one ring slot after its window was emitted."""
    for comp in spec.components:
        state[comp.label][slot] = spec.init_value(comp)
    return state


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` — always a copy, also on the CPU, where
    ``.cpu().numpy()`` would alias ring memory the next in-place update or
    reset overwrites."""
    return t.to("cpu", copy=True).numpy()


def read_slot(
    spec: WindowKernelSpec, state: dict[str, torch.Tensor], slot: int
) -> dict[str, np.ndarray]:
    """Fetch one window's accumulator rows to host (G-sized vectors only —
    results, never raw rows)."""
    return {c.label: to_host(state[c.label][slot]) for c in spec.components}


def read_slot_compact(
    spec: WindowKernelSpec, state: dict[str, torch.Tensor], slot: int,
    capacity: int | None = None,
) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """→ (active gids ascending, component rows aligned to them).

    Two-phase transfer: the compaction kernel (``ops/compact_slot.py``)
    moves the slot's active cells to the front on the device; the scalar
    active count k crosses first, then a power-of-two prefix (capped at
    ``capacity``, default G) of the compacted buffers, cut to k on the
    host.  On the card the prefixes of each dtype's buffer cross in one
    ``non_blocking`` copy into pinned host memory, and the stream is
    synchronized once for all of them."""
    from denormalized_tpu_torch.ops.compact_slot import compact_slot_groups

    comps = spec.components
    n, groups = compact_slot_groups(
        state[ROW_COUNT.label][slot], [state[c.label][slot] for c in comps]
    )
    k = int(n.item())
    bucket = 0 if k == 0 else min(
        1 << (k - 1).bit_length(), capacity or spec.group_capacity
    )
    host = _prefixes_to_host(groups, bucket, k, len(comps))
    return host[0], {c.label: h for c, h in zip(comps, host[1:])}


def _prefixes_to_host(groups, bucket: int, k: int, n_planes: int
                      ) -> list[np.ndarray]:
    """The first ``bucket`` columns of each (rows, L) buffer on the host,
    cut to k → [gids, each plane's row].  From the card, one
    ``non_blocking`` copy a buffer into pinned memory on the current
    stream, then one synchronize for all of them (the rows are numpy
    views that keep the pinned memory alive); on the CPU, copies."""
    cuda = groups[0][0].device.type == "cuda"
    host = []
    for buf, idx in groups:
        if cuda:
            dst = torch.empty((len(idx), bucket), dtype=buf.dtype,
                              pin_memory=True)
            dst.copy_(buf[:, :bucket], non_blocking=True)
        else:
            dst = buf[:, :bucket].clone()
        host.append((dst, idx))
    if cuda:
        torch.cuda.current_stream(groups[0][0].device).synchronize()
    out: list = [None] * (n_planes + 1)
    for dst, idx in host:
        rows = dst.numpy()
        for r, i in enumerate(idx):
            out[i + 1] = rows[r, :k]
    return out


def export_state(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Full device→host snapshot: ``(W, G)`` numpy planes keyed by
    component label — the layout both packages export."""
    return {k: to_host(v) for k, v in state.items()}


def clone_state(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """On-device copy of the window ring, queued on the current stream —
    the snapshot source of an asynchronous export.  The dense and merge
    kernels update the live ring in place, so an export copies this clone,
    never the ring: any update queued after the clone cannot reach it
    (the JAX package's ``clone_state``, which copies so donated update
    programs cannot touch the snapshot)."""
    return {k: v.clone() for k, v in state.items()}


def import_state(
    spec: WindowKernelSpec,
    host_state: dict[str, np.ndarray],
    device: torch.device | str,
) -> dict[str, torch.Tensor]:
    """Rebuild device state from a host snapshot (this package's or the JAX
    package's ``export_state``), padding up to the spec's (possibly larger)
    capacity — used on G/W growth, on restore and to carry a JAX ring into
    the port.  The ring is filled with its init values on ``device`` and
    each host plane copied once into its corner."""
    state = init_state(spec, device)
    for comp in spec.components:
        buf = state[comp.label]
        src = host_state.get(comp.label)
        if src is not None:
            w = min(src.shape[0], buf.shape[0])
            g = min(src.shape[1], buf.shape[1])
            # np.array copies: a host snapshot may be a read-only view
            buf[:w, :g] = torch.from_numpy(np.array(src[:w, :g])).to(
                device=buf.device, dtype=buf.dtype
            )
    return state


def finalize(
    agg_specs: list[tuple],
    rows: dict[str, np.ndarray],
    active: np.ndarray,
) -> list[np.ndarray]:
    """Host-side final evaluation of one emitted window from its primitive
    component rows.  ``active`` is the boolean mask of live group slots."""
    outs: list[np.ndarray] = []
    for spec in agg_specs:
        kind, col = spec[0], spec[1]
        if kind in VAR_KINDS:
            outs.append(
                variance_result(
                    kind,
                    rows[AggComponent("count", col).label][active],
                    read_sum(rows, col)[active],
                    read_sum(rows, spec[2])[active],
                )
            )
        elif kind == "count":
            label = AggComponent("count", col).label
            outs.append(rows[label][active].astype(np.int64))
        elif kind == "sum":
            outs.append(read_sum(rows, col)[active])
        elif kind == "avg":
            s = read_sum(rows, col)[active]
            c = rows[AggComponent("count", col).label][active].astype(np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                outs.append(np.where(c > 0, s / np.maximum(c, 1), np.nan))
        elif kind == "min":
            v = rows[AggComponent("min", col).label][active].astype(np.float64)
            outs.append(np.where(np.isposinf(v), np.nan, v))
        elif kind == "max":
            v = rows[AggComponent("max", col).label][active].astype(np.float64)
            outs.append(np.where(np.isneginf(v), np.nan, v))
        else:
            raise ValueError(kind)
    return outs
