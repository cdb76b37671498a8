"""Shared slice-level window aggregation — the multi-query kernel;
counterpart of ``denormalized_tpu/ops/slice_store.py``, the same host
numpy operations in the same order.

A sliding window ``[j*S, j*S + L)`` is a union of NON-OVERLAPPING slices
of width ``g = gcd(S, L)`` (for a set of concurrent window specs, ``g`` is
the gcd over every spec's slide AND length), so raw rows are aggregated
exactly once per slice — every window, of every concurrently registered
query on the same feed, then FOLDS its answer from ``L/g`` slice partials
instead of re-scanning rows per overlap.  Where the device ring fans each
row out to its ``k`` overlapping windows (O(k) work per row), the slice
store pays O(1) per row and O(L/g) per *emitted window*.

Representation: one dense per-gid array per primitive
:class:`~denormalized_tpu_torch.ops.segment_agg.AggComponent` per live
slice unit, fed by ``np.{add,minimum,maximum}.reduceat`` over one lexsort
per batch, or by one ``bincount`` per component for add-only component
sets.  Sums — including the variance family's pivot-shifted moment
columns — fold across slices by exact addition; under a shared constant
pivot the Chan combine's delta terms cancel identically, so the additive
fold IS the exact Chan merge of the per-slice moments.  min/max fold by
elementwise min/max.  Everything is float64/int64 on the host, never
torch: two runs that accumulate the same batches in the same order
produce bit-identical folds, in either package — what makes shared-vs-
independent, kill/restore and cross-package emission comparisons exact
(docs/multi_query.md, "Numeric contract").
"""

from __future__ import annotations

from time import perf_counter

import numpy as np

from denormalized_tpu_torch.ops.segment_agg import AggComponent

#: per-component fold-neutral init values (mirrors WindowKernelSpec
#: .init_value, in host f64/int64)
_F64 = np.float64
_I64 = np.int64


def _init_for(comp: AggComponent):
    if comp.kind == "count":
        return np.zeros(0, dtype=_I64)
    if comp.kind == "sum":
        return np.zeros(0, dtype=_F64)
    if comp.kind == "min":
        return np.full(0, np.inf, dtype=_F64)
    if comp.kind == "max":
        return np.full(0, -np.inf, dtype=_F64)
    raise ValueError(comp.kind)


def _fill_value(comp: AggComponent):
    if comp.kind == "count":
        return 0
    if comp.kind == "sum":
        return 0.0
    if comp.kind == "min":
        return np.inf
    if comp.kind == "max":
        return -np.inf
    raise ValueError(comp.kind)


def slice_segment_bounds(units, gids, capacity):
    """One lexsort + boundary scan for a whole batch: rows keyed by
    ``(slide_unit, gid)`` collapse to per-segment runs whose partials
    reduceat computes in one pass each.  Returns ``(order, starts,
    seg_units, seg_gids)`` where ``order`` sorts the batch, ``starts``
    are the segment start offsets into the sorted batch, and
    ``seg_units``/``seg_gids`` name each segment's slice cell."""
    key = units.astype(np.int64) * np.int64(capacity) + gids.astype(np.int64)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    edges = np.flatnonzero(ks[1:] != ks[:-1]) + 1
    starts = np.concatenate((np.zeros(1, dtype=np.int64), edges))
    seg_key = ks[starts]
    # floor-div/mod recover (unit, gid) exactly for negative units too
    return order, starts, seg_key // capacity, seg_key % capacity


def fold_slices(kind: str, stack: np.ndarray) -> np.ndarray:
    """Combine a ``(n_units, G)`` stack of slice partials into one
    ``(G,)`` window partial — adds for counts/sums (exact Chan combine
    under the store's shared pivot), elementwise min/max for extrema.
    Deterministic: the same stack always folds to the same bits, the
    invariant the byte-identical emission guarantees ride on."""
    if kind in ("count", "sum"):
        return np.add.reduce(stack, axis=0)
    if kind == "min":
        return np.minimum.reduce(stack, axis=0)
    if kind == "max":
        return np.maximum.reduce(stack, axis=0)
    raise ValueError(kind)


class SliceStore:
    """Per-(slide-unit, gid) partial aggregates for one shared feed.

    ``components`` is the deduped union of primitive components every
    subscriber's aggregates decompose into
    (:func:`segment_agg.components_for`); gids come from the shared
    :class:`~denormalized_tpu.ops.interner.GroupInterner`, so one store
    serves every window spec folding from it."""

    def __init__(
        self,
        components,
        unit_ms: int,
        *,
        force_sort_lane: bool = False,
        sketches=(),
    ) -> None:
        if unit_ms <= 0:
            raise ValueError(f"slice unit must be positive, got {unit_ms}")
        self.components = tuple(components)
        #: SketchSpec layouts riding this store's slice units — frozen at
        #: construction so every unit (and every restore) carries the
        #: same planes; see ops/sketches.py
        self.sketches = tuple(sketches)
        self.unit_ms = int(unit_ms)
        # unit -> {component label -> (capacity,) array}
        self._units: dict[int, dict[str, np.ndarray]] = {}
        self._cap = 0
        self.rows_accumulated = 0
        self.sketch_rows = 0
        self.sketch_update_s = 0.0
        self._itemsize_total = 8 * len(self.components)
        self._comp_labels = frozenset(c.label for c in self.components)
        # add-only component sets (counts + sums, no extrema) take the
        # sort-free bincount lane in accumulate(); min/max need ordered
        # segments, so their presence keeps the lexsort lane.
        # ``force_sort_lane`` pins the lexsort lane regardless: a shared
        # group whose component UNION carries extrema always sorts, so
        # an add-only member's independent byte-identity oracle must be
        # able to match that lane (EngineConfig(slice_sort_lane=True)).
        # Sketch planes always sort: their per-cell update sequences
        # must be a pure function of the (unit, gid) segment order.
        self._add_only = (
            not force_sort_lane
            and not self.sketches
            and all(c.kind in ("count", "sum") for c in self.components)
        )

    # -- accounting ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._units)

    @property
    def add_only(self) -> bool:
        """True when this store may take the sort-free bincount lane —
        callers precomputing a shared sort permutation must NOT hand it
        to an add-only store (the dense lane's bits differ)."""
        return self._add_only

    @property
    def capacity(self) -> int:
        return self._cap

    def nbytes(self) -> int:
        return (
            len(self._units) * self._cap * self._itemsize_total
            + self.sketch_nbytes()
        )

    def sketch_nbytes(self) -> int:
        """Exact bytes held by sketch planes across live units — O(1) in
        value cardinality by construction (the doctor reports this next
        to the unbounded exact-accumulator growth it replaces)."""
        if not self.sketches:
            return 0
        total = 0
        for slot in self._units.values():
            for label, arr in slot.items():
                if label not in self._comp_labels:
                    total += arr.nbytes
        return total

    def live_units(self) -> list[int]:
        return sorted(self._units)

    # -- capacity --------------------------------------------------------
    def _ensure_capacity(self, ngroups: int) -> None:
        if ngroups <= self._cap:
            return
        new_cap = 1 << max(4, (ngroups - 1).bit_length())
        for slot in self._units.values():
            for comp in self.components:
                old = slot[comp.label]
                arr = np.full(
                    new_cap, _fill_value(comp), dtype=old.dtype
                )
                arr[: len(old)] = old
                slot[comp.label] = arr
            for spec in self.sketches:
                for label in [k for k in slot if spec.owns(k)]:
                    old = slot[label]
                    arr = np.full(
                        (new_cap,) + old.shape[1:],
                        spec.fill_for(label),
                        dtype=old.dtype,
                    )
                    arr[: old.shape[0]] = old
                    slot[label] = arr
        self._cap = new_cap

    def _new_unit(self) -> dict[str, np.ndarray]:
        slot = {}
        for comp in self.components:
            init = _init_for(comp)
            slot[comp.label] = np.full(
                self._cap, _fill_value(comp), dtype=init.dtype
            )
        for spec in self.sketches:
            slot.update(spec.init_planes(self._cap))
        return slot

    # -- hot path: per-batch accumulation --------------------------------
    def accumulate(
        self,
        units: np.ndarray,
        gids: np.ndarray,
        values64: np.ndarray,
        colvalid: np.ndarray,
        ngroups: int,
        *,
        order: np.ndarray | None = None,
        aux: dict[int, np.ndarray] | None = None,
    ) -> int:
        """Fold one batch's rows into their slice partials.  ``units``
        are slide-unit indices (``ts // unit_ms``), ``gids`` dense group
        ids, ``values64`` the ``(n, V)`` f64 value matrix (variance
        columns already pivot-shifted by the caller — the same transform
        StreamingWindowExec applies), ``colvalid`` per-cell validity.

        ``order``, when given, is a precomputed stable ``(unit, gid)``
        sort permutation — the full batch's, or an order-preserving
        masked subset of it (row indices into the batch arrays).  The
        store then skips its own lexsort and folds exactly the rows
        ``order`` names, in that order.  A stable subset of a stable
        sort IS the subset's stable sort, so the per-segment row
        sequences (and hence the reduceat bits) are identical to
        sorting the subset directly — the shared pipeline exploits this
        to pay ONE sort per batch across every residual filter class.

        ``aux`` carries per-row sketch source lanes keyed by value
        column: uint64 stable hashes (HLL) or dense value-interner ids
        (top-K), indexed by the same batch row positions as
        ``values64``.  Required when the store carries a spec whose
        ``uses`` is not ``"f64"``.
        Returns the number of distinct slice segments touched."""
        n = len(units) if order is None else len(order)
        if n == 0:
            return 0
        self._ensure_capacity(max(ngroups, 1))
        cap = self._cap
        if order is None:
            if self._add_only:
                u_min = int(units.min())
                span = int(units.max()) - u_min + 1
                # dense-cell guard: a wildly out-of-order batch whose
                # unit span dwarfs its row count falls back to sorting
                if span * cap <= 4 * max(n, 1024):
                    return self._accumulate_dense(
                        units, gids, values64, colvalid, u_min, span
                    )
            order, starts, seg_u, seg_g = slice_segment_bounds(
                units, gids, cap
            )
        else:
            ks = units[order].astype(np.int64) * np.int64(
                cap
            ) + gids[order].astype(np.int64)
            edges = np.flatnonzero(ks[1:] != ks[:-1]) + 1
            starts = np.concatenate((np.zeros(1, dtype=np.int64), edges))
            seg_key = ks[starts]
            seg_u = seg_key // cap
            seg_g = seg_key % cap
        row_counts = np.diff(np.append(starts, n))
        # per-component segment partials (one reduceat per component);
        # gather-then-select equals select-then-gather elementwise, so
        # both order paths produce the same bits
        seg_vals: dict[str, np.ndarray] = {}
        for comp in self.components:
            if comp.kind == "count" and comp.col is None:
                seg_vals[comp.label] = row_counts.astype(_I64)
                continue
            if comp.kind == "count":
                v = colvalid[order, comp.col].astype(_I64)
                seg_vals[comp.label] = np.add.reduceat(v, starts)
                continue
            col = values64[order, comp.col]
            ok = colvalid[order, comp.col]
            if comp.kind == "sum":
                v = np.where(ok, col, 0.0)
                seg_vals[comp.label] = np.add.reduceat(v, starts)
            elif comp.kind == "min":
                v = np.where(ok, col, np.inf)
                seg_vals[comp.label] = np.minimum.reduceat(v, starts)
            elif comp.kind == "max":
                v = np.where(ok, col, -np.inf)
                seg_vals[comp.label] = np.maximum.reduceat(v, starts)
            else:  # pragma: no cover — components_for never emits others
                raise ValueError(comp.kind)
        # scatter segment partials into per-unit arrays: segments are
        # sorted by (unit, gid), so distinct units form contiguous runs;
        # within one unit the gids are unique → plain fancy indexing
        u_edges = np.flatnonzero(seg_u[1:] != seg_u[:-1]) + 1
        u_starts = np.concatenate((np.zeros(1, dtype=np.int64), u_edges))
        u_ends = np.append(u_edges, len(seg_u))
        units_list = seg_u[u_starts]
        for i, u in enumerate(units_list.tolist()):
            lo, hi = int(u_starts[i]), int(u_ends[i])
            g = seg_g[lo:hi]
            slot = self._units.get(u)
            if slot is None:
                slot = self._new_unit()
                self._units[u] = slot
            for comp in self.components:
                arr = slot[comp.label]
                seg = seg_vals[comp.label][lo:hi]
                if comp.kind in ("count", "sum"):
                    arr[g] += seg
                elif comp.kind == "min":
                    arr[g] = np.minimum(arr[g], seg)
                else:
                    arr[g] = np.maximum(arr[g], seg)
            if self.sketches:
                # rows of this unit, in segment (gid-ascending) order —
                # the per-cell sequences every sketch kernel requires
                ts = perf_counter()
                r0 = int(starts[lo])
                r1 = int(starts[hi]) if hi < len(starts) else n
                rows = order[r0:r1]
                g_rows = gids[rows]
                for spec in self.sketches:
                    if spec.uses == "f64":
                        col = values64[rows, spec.vcol]
                    else:
                        col = aux[spec.vcol][rows]
                    spec.accumulate_unit(
                        slot, cap, g_rows, col,
                        colvalid[rows, spec.vcol],
                    )
                self.sketch_update_s += perf_counter() - ts
        if self.sketches:
            self.sketch_rows += n
        self.rows_accumulated += n
        return len(seg_u)

    def _accumulate_dense(
        self, units, gids, values64, colvalid, u_min: int, span: int
    ) -> int:
        """Sort-free lane for add-only component sets: one ``bincount``
        per component over dense ``(unit, gid)`` cell indices.  NOT
        bit-identical to the lexsort lane (bincount adds strictly in
        row order; reduceat may fold a long segment pairwise), but the
        lane choice is a pure function of the component set and the
        batch's unit span — two runs over the same feed with the same
        aggregates always take the same lane, which is what the
        byte-identical emission guarantees actually require."""
        n = len(units)
        cap = self._cap
        rel = (units - u_min).astype(np.int64)
        idx = rel * cap + gids.astype(np.int64)
        ncells = span * cap
        per_comp: dict[str, np.ndarray] = {}
        for comp in self.components:
            if comp.kind == "count" and comp.col is None:
                per_comp[comp.label] = np.bincount(idx, minlength=ncells)
            elif comp.kind == "count":
                per_comp[comp.label] = np.bincount(
                    idx,
                    weights=colvalid[:, comp.col].astype(np.float64),
                    minlength=ncells,
                ).astype(_I64)
            else:  # sum
                per_comp[comp.label] = np.bincount(
                    idx,
                    weights=np.where(
                        colvalid[:, comp.col], values64[:, comp.col], 0.0
                    ),
                    minlength=ncells,
                )
        touched = np.flatnonzero(np.bincount(rel, minlength=span))
        for r in touched.tolist():
            u = u_min + r
            slot = self._units.get(u)
            if slot is None:
                slot = self._new_unit()
                self._units[u] = slot
            lo = r * cap
            for comp in self.components:
                slot[comp.label] += per_comp[comp.label][lo:lo + cap]
        self.rows_accumulated += n
        return int(len(touched))

    # -- fold: window emission -------------------------------------------
    def fold(self, u_start: int, u_end: int) -> dict[str, np.ndarray] | None:
        """Combine slice partials over units ``[u_start, u_end)`` into
        one window's component rows (the shape
        :func:`segment_agg.finalize` consumes).  None when no slice in
        the range holds data — the window is empty for every group."""
        present = [
            self._units[u] for u in range(u_start, u_end) if u in self._units
        ]
        if not present:
            return None
        out: dict[str, np.ndarray] = {}
        if len(present) == 1:
            slot = present[0]
            for comp in self.components:
                out[comp.label] = slot[comp.label].copy()
        else:
            for comp in self.components:
                stack = np.stack([slot[comp.label] for slot in present])
                out[comp.label] = fold_slices(comp.kind, stack)
        # sketch planes merge across units in ascending unit order — a
        # pure function of the feed, so shared / independent / restored
        # runs fold identical bits
        for spec in self.sketches:
            out.update(spec.fold(present, self._cap))
        return out

    # -- retention -------------------------------------------------------
    def prune(self, min_unit: int) -> int:
        """Drop every slice below ``min_unit`` — no subscriber's open or
        future window can reference them (the caller computes the floor
        over ALL subscribers' cursors and watermark floors)."""
        dead = [u for u in self._units if u < min_unit]
        for u in dead:
            del self._units[u]
        return len(dead)

    # -- checkpoint integration ------------------------------------------
    def snapshot_arrays(self, ngroups: int) -> dict[str, np.ndarray]:
        """Pack every live slice's arrays (trimmed to the live group
        prefix) under ``u<unit>|<label>`` keys — the epoch snapshot's
        array payload."""
        ngroups = max(1, min(ngroups, self._cap) if self._cap else 1)
        out = {}
        for u, slot in self._units.items():
            for comp in self.components:
                out[f"u{u}|{comp.label}"] = slot[comp.label][:ngroups]
            if self.sketches:
                # sketch planes (incl. dynamically allocated quantile
                # levels) trim to the live gid prefix on axis 0
                for label, arr in slot.items():
                    if label not in self._comp_labels:
                        out[f"u{u}|{label}"] = arr[:ngroups]
        return out

    def restore_arrays(
        self, arrays: dict[str, np.ndarray], ngroups: int
    ) -> None:
        """Rebuild the store from a snapshot's array payload (exact:
        the arrays are the f64/i64 partials as accumulated)."""
        self._units = {}
        self._cap = 0
        self.rows_accumulated = 0
        self._ensure_capacity(max(ngroups, 1))
        for key, arr in arrays.items():
            u_str, label = key.split("|", 1)
            u = int(u_str[1:])
            slot = self._units.get(u)
            if slot is None:
                slot = self._new_unit()
                self._units[u] = slot
            if label not in slot:
                # dynamically allocated sketch plane (quantile level):
                # ask the owning spec for a fresh full-capacity array
                for spec in self.sketches:
                    if spec.owns(label):
                        slot[label] = spec.alloc_label(label, self._cap)
                        break
            slot[label][: len(arr)] = arr
