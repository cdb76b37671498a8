"""Host-side partial-aggregation stripe for the ``partial_merge`` device
strategy — counterpart of ``denormalized_tpu/ops/host_partial.py``.

The window operator can ship every decoded row to the device (row
shipping: ``scatter`` / ``pallas_dense``) or reduce each batch on the host
first and ship only sufficient statistics (this module).  The host keeps a
*stripe*: per-(slide-unit, sub, group) accumulators covering the slide
units touched since the last device merge.  :meth:`HostPartialStripe.
take_packed` packs the stripe into one int32 matrix, which the device merge
(:func:`denormalized_tpu_torch.ops.merge_partials.merge_partials`, the
hand-written kernel ``csrc/merge_partials.cu``) folds into the window ring
— the sliding fan-out happens there, so the host never replicates rows per
overlapping window.

The hot loop is the native single-pass reducer ``native/partial_agg.cpp``
(f64 on the host); :meth:`HostPartialStripe._add_numpy` is its plain numpy
version, taken when the native build fails (logged) and counted in
``numpy_batches``.  ``take_packed`` is byte-for-byte the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import time

import numpy as np
import torch

from denormalized_tpu_torch.ops import segment_agg as sa

_log = logging.getLogger(__name__)


@functools.cache
def _native() -> ctypes.CDLL | None:
    """The native reducer, or None (logged) when it cannot be built."""
    from denormalized_tpu_torch.native.build import NativeBuildError, load

    try:
        lib = load("partial_agg")
    except (NativeBuildError, OSError) as e:
        _log.warning(
            "native partial_agg unavailable (%s: %s) — host partial "
            "aggregation runs the numpy path", type(e).__name__, e,
        )
        return None
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.partial_window_agg.restype = i64
    lib.partial_window_agg.argtypes = [
        p, p, p, p, p,  # win_rel int64, sub u8|NULL, gid int32, values f64, colvalid u8|NULL
        i64, i32, i32, i32, i32,  # n, V, U, SUB, G
        p, p, p, p, p,  # row_cnt int64, cnt int64, sum f64, mn f64, mx f64
    ]
    return lib


def _ptr(a: np.ndarray | None):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


# fold-neutral int32 bit patterns for min/max planes in the DENSE packed
# layout (which has no validity mask)
NEUTRAL_BITS = {
    "min": np.float32(np.inf).view(np.int32),
    "max": np.float32(-np.inf).view(np.int32),
}


class HostPartialStripe:
    """Accumulates per-(slide-unit, sub, group) partials between device
    merges.

    ``u_base`` is the slide index (relative to the operator's first open
    window) of stripe row 0; rows hold units ``u_base .. u_base + U - 1``.
    ``SUB`` is 2 when ``length % slide != 0`` (rows near the end of a unit
    belong to one fewer window — see partial_agg.cpp), else 1.
    """

    # stripe capacity in slide units; a span wider than this forces a flush
    U_MAX = 16
    # counts per cell are shipped as exact-in-f32 integers, so a stripe
    # may never exceed 2^24 rows between merges (the backend flushes
    # earlier)
    MAX_STRIPE_ROWS = 1 << 24
    # cap on U*SUB*G cells per stripe: bounds the transfer bucket
    MAX_STRIPE_CELLS = 1 << 19

    def __init__(self, spec: sa.WindowKernelSpec, group_capacity: int):
        self.spec = spec
        self.G = group_capacity
        self.V = max(spec.num_value_cols, 1)
        self.SUB = 1 if spec.length_ms % spec.slide_ms == 0 else 2
        self.u_base: int | None = None
        self.u_hi = 0  # highest stripe-relative unit written (span - 1)
        self.rows = 0
        # True once ANY value column in this stripe had a null: decides
        # between the lean packed layout (per-column count planes aliased
        # to the row-count plane) and the full layout
        self.nulls_seen = False
        # batches folded by each lane, and host seconds spent folding rows
        # (add_batch) and packing stripes (take_packed)
        self.native_batches = 0
        self.numpy_batches = 0
        self.reduce_s = 0.0
        self.pack_s = 0.0
        U, S, G, V = self.U_MAX, self.SUB, self.G, self.V
        self.row_cnt = np.zeros((U, S, G), np.int64)
        self.cnt = np.zeros((V, U, S, G), np.int64)
        self.sum = np.zeros((V, U, S, G), np.float64)
        self.mn = np.full((V, U, S, G), np.inf)
        self.mx = np.full((V, U, S, G), -np.inf)

    # -- ingestion -----------------------------------------------------
    def add_batch(
        self,
        units: np.ndarray,      # (n) int64 slide indices
        rem: np.ndarray,        # (n) int32 ts - unit*slide
        gid: np.ndarray,        # (n) int32
        values64: np.ndarray,   # (n, V) f64
        colvalid: np.ndarray | None,  # (n, V) bool or None (all valid)
        keep: np.ndarray | None,      # (n) bool rows to fold (None = all)
    ) -> None:
        if len(units) == 0:
            return
        t0 = time.perf_counter()
        if keep is not None and not keep.all():
            units, rem, gid, values64 = (
                units[keep], rem[keep], gid[keep], values64[keep]
            )
            if colvalid is not None:
                colvalid = colvalid[keep]
            if len(units) == 0:
                return
        n = len(units)
        if colvalid is not None and not self.nulls_seen and not colvalid.all():
            self.nulls_seen = True
        if self.u_base is None:
            self.u_base = int(units.min())
        rel = np.asarray(units, np.int64) - self.u_base
        self.u_hi = max(self.u_hi, int(rel.max()))
        sub = None
        if self.SUB == 2:
            # rows with rem >= L - (k-1)*S miss the oldest overlapping
            # window (see partial_agg.cpp header)
            edge = (
                self.spec.length_ms
                - (self.spec.length_units - 1) * self.spec.slide_ms
            )
            sub = (np.asarray(rem) >= edge).astype(np.uint8)
        lib = _native()
        if lib is not None:
            cv = (
                None if colvalid is None
                else np.ascontiguousarray(colvalid, np.uint8)
            )
            gid_c = np.ascontiguousarray(gid, np.int32)
            vals_c = np.ascontiguousarray(values64, np.float64)
            lib.partial_window_agg(
                _ptr(rel), _ptr(sub), _ptr(gid_c), _ptr(vals_c), _ptr(cv),
                n, self.V, self.U_MAX, self.SUB, self.G,
                _ptr(self.row_cnt), _ptr(self.cnt), _ptr(self.sum),
                _ptr(self.mn), _ptr(self.mx),
            )
            self.native_batches += 1
        else:
            self._add_numpy(rel, sub, gid, values64, colvalid)
            self.numpy_batches += 1
        self.rows += n
        self.reduce_s += time.perf_counter() - t0

    def _add_numpy(self, rel, sub, gid, values64, colvalid):
        """Plain numpy version of the native reducer: bincount for counts
        and sums, sort + reduceat for extrema (NaN propagates)."""
        ok = (rel >= 0) & (rel < self.U_MAX) & (gid >= 0) & (gid < self.G)
        rel = rel[ok]
        gid = np.asarray(gid)[ok]
        vals = values64[ok]
        s = sub[ok].astype(np.int64) if sub is not None else 0
        cell = (rel * self.SUB + s) * self.G + gid
        cells = self.U_MAX * self.SUB * self.G
        self.row_cnt.reshape(-1)[:] += np.bincount(cell, minlength=cells)
        cv = colvalid[ok] if colvalid is not None else None
        order = np.argsort(cell, kind="stable")
        cell_s = cell[order]
        for v in range(self.V):
            x = vals[:, v]
            m = cv[:, v] if cv is not None else None
            cm = cell if m is None else cell[m]
            xm = x if m is None else x[m]
            self.cnt[v].reshape(-1)[:] += np.bincount(cm, minlength=cells)
            self.sum[v].reshape(-1)[:] += np.bincount(
                cm, weights=xm, minlength=cells
            )
            xs = x[order]
            if m is not None:
                ms = m[order]
                cs2, xs2 = cell_s[ms], xs[ms]
            else:
                cs2, xs2 = cell_s, xs
            if len(cs2):
                starts = np.flatnonzero(np.r_[True, cs2[1:] != cs2[:-1]])
                mins = np.minimum.reduceat(xs2, starts)
                maxs = np.maximum.reduceat(xs2, starts)
                uc = cs2[starts]
                flat_mn = self.mn[v].reshape(-1)
                flat_mx = self.mx[v].reshape(-1)
                flat_mn[uc] = np.minimum(flat_mn[uc], mins)
                flat_mx[uc] = np.maximum(flat_mx[uc], maxs)

    # -- hand-off ------------------------------------------------------
    def is_empty(self) -> bool:
        return self.rows == 0

    def _component_plane(self, c: sa.AggComponent) -> np.ndarray:
        if c.kind == "count":
            return self.row_cnt if c.col is None else self.cnt[c.col]
        if c.kind == "sum":
            return self.sum[c.col]
        if c.kind == "min":
            return self.mn[c.col]
        if c.kind == "max":
            return self.mx[c.col]
        raise ValueError(c.kind)

    def transfer_buckets(self) -> list[int]:
        """The fixed set of padded transfer sizes this stripe uses:
        {1024, bound/4, bound/2, bound} (pow2) where bound covers the
        largest possible active-cell count — the JAX package's set, kept so
        both packages pack identically."""
        bound_cells = min(
            max(self.MAX_STRIPE_CELLS, self.G * self.SUB),
            self.G * self.SUB * self.U_MAX,
        )
        bound = 1 << max(0, (bound_cells - 1)).bit_length()
        return sorted(
            {1024, max(1024, bound // 4), max(1024, bound // 2), bound}
        )

    def _packed_components(self, lean: bool):
        """The components a packed stripe carries, in plane order."""
        return [
            c for c in self.spec.components
            if c.kind != "sumc" and not (lean and sa.lean_skippable(c))
        ]

    def n_planes(self, lean: bool) -> int:
        """Value planes in a packed stripe of this spec: two per sum
        (hi/lo split), one per other component; lean omits per-column
        count planes (aliased to the row count on the device)."""
        return sum(
            2 if c.kind == "sum" else 1 for c in self._packed_components(lean)
        )

    def take_packed(
        self, base_mod: int
    ) -> tuple[np.ndarray, int, int, bool, bool] | None:
        """Pack the stripe into the single int32 matrix the device merge
        consumes, then reset.  → ``(packed, a_pad, u_base, lean, dense)``,
        or None when empty.

        Value planes are f32 bitcast to int32: one plane per count/min/max
        component (counts are exact in f32 under MAX_STRIPE_ROWS) and TWO
        per sum — the f64 host sum split into (hi, lo) f32.  ``u_base`` and
        ``base_mod`` ride in the two tail slots of row 0.  ``lean`` says
        per-column count planes were omitted (null-free stripe).

        Two layouts, chosen per stripe by transferred bytes:

        * **compact** (``dense=False``): ``(P + 1, a_pad + 2)`` — row 0
          holds the active flat cell indices ``((u*SUB)+s)*G + g``
          (pad = −1), value planes follow;
        * **dense** (``dense=True``): ``(P, a_pad + 2)`` — no index row;
          cell i is flat index i over the first ``used`` units, pad cells
          carry fold-neutral values (count 0, sum 0, min +inf, max −inf).
        """
        t0 = time.perf_counter()
        try:
            return self._take_packed(base_mod)
        finally:
            self.pack_s += time.perf_counter() - t0

    def _take_packed(
        self, base_mod: int
    ) -> tuple[np.ndarray, int, int, bool, bool] | None:
        """take_packed without its timer."""
        if self.rows == 0:
            return None
        used = self.u_hi + 1
        active = np.flatnonzero(self.row_cnt[:used].reshape(-1) > 0)
        A = len(active)
        lean = not self.nulls_seen and sa.lean_possible(self.spec)
        n_planes = self.n_planes(lean)
        buckets = self.transfer_buckets()
        a_pad = next((b for b in buckets if b >= A), 1 << (A - 1).bit_length())
        cells_d = used * self.SUB * self.G
        a_pad_d = next((b for b in buckets if b >= cells_d), None)
        # dense only when a bucket covers the span AND it moves fewer
        # bytes than compact (index row included)
        if a_pad_d is not None and n_planes * a_pad_d < (n_planes + 1) * a_pad:
            return self._take_packed_dense(base_mod, used, a_pad_d, lean,
                                           n_planes)
        rows: list[np.ndarray] = []
        for c in self._packed_components(lean):
            src = self._component_plane(c)[:used].reshape(-1)[active]
            if c.kind == "sum":
                rows.extend(self._split_sum(src))
            else:
                rows.append(
                    np.ascontiguousarray(src, np.float64)
                    .astype(np.float32).view(np.int32)
                )
        packed = np.zeros((len(rows) + 1, a_pad + 2), np.int32)
        packed[0, :A] = active
        packed[0, A:a_pad] = -1
        packed[0, a_pad] = self.u_base
        packed[0, a_pad + 1] = base_mod
        for i, r in enumerate(rows):
            packed[i + 1, :A] = r
        u_base = self._reset_after_take(used)
        return packed, a_pad, u_base, lean, False

    def dense_noop(self, a_pad: int, lean: bool) -> np.ndarray:
        """An all-padding DENSE packed matrix: every cell fold-neutral —
        count/sum planes zero, min/max planes +inf/−inf bit patterns (the
        plane order of ``_take_packed_dense``).  No path of the port calls
        it: it is kept so that its bytes stay held against the JAX
        package's, which folds it to compile its merge ahead of time."""
        packed = np.zeros((self.n_planes(lean), a_pad + 2), np.int32)
        pi = 0
        for c in self._packed_components(lean):
            if c.kind in NEUTRAL_BITS:
                packed[pi, :a_pad] = NEUTRAL_BITS[c.kind]
            pi += 2 if c.kind == "sum" else 1
        return packed

    def _split_sum(self, src: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(hi, lo) f32 split of a host f64 sum plane, int32-bitcast —
        exact for f32 accumulators, ~1e-14 relative for f64 ones."""
        # overflow-to-inf in the cast and inf - inf below are deliberate
        # (handled by the nonfin branch)
        with np.errstate(invalid="ignore", over="ignore"):
            hi = src.astype(np.float32)
            lo = (src - hi.astype(np.float64)).astype(np.float32)
        # a finite f64 sum beyond f32 range becomes (±inf, ∓inf) and would
        # fold to NaN; ±inf is the right answer for an f32 accumulator,
        # but an f64 one would have held the value — refuse loudly
        nonfin = ~np.isfinite(hi)
        if nonfin.any():
            over = nonfin & np.isfinite(src)
            if over.any() and self.spec.accum_dtype == torch.float64:
                raise OverflowError(
                    "partial_merge cannot transport f64 sums beyond "
                    "float32 range (~3.4e38); use "
                    "device_strategy='scatter' for this workload"
                )
            # overflow and genuine ±inf/NaN sums leave lo meaningless
            # (inf - inf = NaN): zero it so the device fold yields the
            # scatter path's ±inf/NaN
            lo[nonfin] = 0.0
        return hi.view(np.int32), lo.view(np.int32)

    def _take_packed_dense(
        self, base_mod: int, used: int, a_pad: int, lean: bool, n_planes: int
    ) -> tuple[np.ndarray, int, int, bool, bool]:
        """Dense (index-free) pack: plane p at row p, cell i = flat index
        i over the first ``used`` units, pad cells fold-neutral."""
        cells = used * self.SUB * self.G
        packed = np.zeros((n_planes, a_pad + 2), np.int32)
        pi = 0
        for c in self._packed_components(lean):
            src = self._component_plane(c)[:used].reshape(-1)
            if c.kind == "sum":
                packed[pi, :cells], packed[pi + 1, :cells] = self._split_sum(src)
                pi += 2
                continue
            packed[pi, :cells] = (
                np.ascontiguousarray(src, np.float64)
                .astype(np.float32).view(np.int32)
            )
            if c.kind in NEUTRAL_BITS and cells < a_pad:
                packed[pi, cells:a_pad] = NEUTRAL_BITS[c.kind]
            pi += 1
        packed[0, a_pad] = self.u_base
        packed[0, a_pad + 1] = base_mod
        u_base = self._reset_after_take(used)
        return packed, a_pad, u_base, lean, True

    def _reset_after_take(self, used: int) -> int:
        """Reset the stripe in place, touching only the unit rows it used
        → the taken u_base."""
        u_base = self.u_base
        self.u_base = None
        self.u_hi = 0
        self.rows = 0
        self.row_cnt[:used] = 0
        self.cnt[:, :used] = 0
        self.sum[:, :used] = 0.0
        self.mn[:, :used] = np.inf
        self.mx[:, :used] = -np.inf
        self.nulls_seen = False
        return u_base
