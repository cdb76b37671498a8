"""SoA open-session store — flat numpy state for the session operator.

The StreamBox-HBM-style structure-of-arrays replacement for the old
``dict[key_tuple, list[_Session]]`` store: every open session is one SLOT in
a set of parallel flat arrays (interval bounds + one column per running
aggregate component), sessions of the same group chain through
``head[gid] -> link[slot] -> ...`` exactly like the join's ``_SideState``
chained-array row store, and closed slots recycle through a free list.  All
bulk operations — gathering the open sessions of the gids a batch touches,
scattering merged sessions back, scanning for watermark-expired sessions —
are numpy gathers/scatters; no per-session Python objects exist at steady
state.

Aggregate layout per slot (V = number of float value columns):

- ``start``/``last``: session interval bounds (event-time ms)
- ``row_count``: rows in the session (count(*))
- ``counts``/``sums``/``mins``/``maxs``: per-column null-aware primitives
- ``means``/``m2s``: Welford/Chan moments for the variance family

UDAF/collection accumulators are inherently per-session Python objects;
they live OUTSIDE the arrays in a ``{slot: [Accumulator, ...]}`` dict that
follows slot alloc/free.

Copy of ``denormalized_tpu/ops/session_table.py`` for the port.
"""

from __future__ import annotations

import numpy as np


class SessionTable:
    """Slot-per-open-session SoA store with per-gid chains + free list."""

    __slots__ = (
        "num_value_cols",
        "start",
        "last",
        "row_count",
        "counts",
        "sums",
        "mins",
        "maxs",
        "means",
        "m2s",
        "gid",
        "link",
        "live",
        "head",
        "accs",
        "_free",
        "_hwm",
    )

    def __init__(self, num_value_cols: int, slot_capacity: int = 1024) -> None:
        self.num_value_cols = V = int(num_value_cols)
        cap = max(int(slot_capacity), 16)
        self.start = np.zeros(cap, dtype=np.int64)
        self.last = np.zeros(cap, dtype=np.int64)
        self.row_count = np.zeros(cap, dtype=np.int64)
        self.counts = np.zeros((cap, V), dtype=np.int64)
        self.sums = np.zeros((cap, V), dtype=np.float64)
        self.mins = np.zeros((cap, V), dtype=np.float64)
        self.maxs = np.zeros((cap, V), dtype=np.float64)
        self.means = np.zeros((cap, V), dtype=np.float64)
        self.m2s = np.zeros((cap, V), dtype=np.float64)
        self.gid = np.full(cap, -1, dtype=np.int32)
        self.link = np.full(cap, -1, dtype=np.int32)
        self.live = np.zeros(cap, dtype=bool)
        self.head = np.full(1024, -1, dtype=np.int32)
        self.accs: dict[int, list] = {}
        self._free: list[int] = []
        self._hwm = 0  # slots ever allocated (free-listed ones included)

    # -- capacity --------------------------------------------------------
    def __len__(self) -> int:
        return self._hwm - len(self._free)

    def ensure_gids(self, num_gids: int) -> None:
        cap = len(self.head)
        if num_gids <= cap:
            return
        while cap < num_gids:
            cap *= 2
        new = np.full(cap, -1, dtype=np.int32)
        new[: len(self.head)] = self.head
        self.head = new

    def _ensure_slots(self, need: int) -> None:
        cap = len(self.start)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in (
            "start", "last", "row_count", "counts", "sums", "mins", "maxs",
            "means", "m2s", "gid", "link", "live",
        ):
            old = getattr(self, name)
            shape = (cap,) + old.shape[1:]
            if name == "gid" or name == "link":
                new = np.full(shape, -1, dtype=old.dtype)
            else:
                new = np.zeros(shape, dtype=old.dtype)
            new[: self._hwm] = old[: self._hwm]
            setattr(self, name, new)

    def shrink_to_fit(self, min_capacity: int = 1024) -> None:
        """Re-pack the live slots into the smallest power-of-two capacity
        of at least twice them (and ``min_capacity``), when that halves the
        arrays or more (so a table shrinks at a quarter full and grows
        when full): after the cold tier spills, the arrays follow the
        resident sessions, not their high-water mark.  Slot ids are
        renumbered in ascending order; chains, heads and accumulators
        follow them, so every per-gid order is kept."""
        n = len(self)
        cap = len(self.start)
        new_cap = max(int(min_capacity), 16,
                      1 << max(2 * n - 1, 1).bit_length())
        if new_cap * 2 > cap:
            return
        live = self.live_slots()
        remap = np.full(cap, -1, dtype=np.int64)
        remap[live] = np.arange(n)
        for name in (
            "start", "last", "row_count", "counts", "sums", "mins", "maxs",
            "means", "m2s", "gid", "link", "live",
        ):
            old = getattr(self, name)
            shape = (new_cap,) + old.shape[1:]
            new = (np.full(shape, -1, dtype=old.dtype)
                   if name in ("gid", "link")
                   else np.zeros(shape, dtype=old.dtype))
            new[:n] = old[live]
            setattr(self, name, new)
        link = self.link[:n]
        self.link[:n] = np.where(link >= 0, remap[link], -1)
        self.head = np.where(self.head >= 0, remap[self.head], -1).astype(
            np.int32)
        self.accs = {int(remap[s]): v for s, v in self.accs.items()}
        self._free = []
        self._hwm = n

    # -- slot lifecycle --------------------------------------------------
    def alloc(self, k: int) -> np.ndarray:
        """k fresh slot indices: free-listed slots first, then new ones."""
        reuse = min(k, len(self._free))
        out = np.empty(k, dtype=np.int64)
        if reuse:
            out[:reuse] = self._free[-reuse:]
            del self._free[-reuse:]
        fresh = k - reuse
        if fresh:
            self._ensure_slots(self._hwm + fresh)
            out[reuse:] = np.arange(self._hwm, self._hwm + fresh)
            self._hwm += fresh
        return out

    def free(self, slots: np.ndarray) -> None:
        """Release slots (the caller has already unlinked their chains)."""
        if len(slots) == 0:
            return
        self.live[slots] = False
        self.gid[slots] = -1
        self.link[slots] = -1
        if self.accs:
            for s in slots.tolist():
                self.accs.pop(s, None)
        self._free.extend(int(s) for s in slots.tolist())

    # -- chains ----------------------------------------------------------
    def chain(self, gids: np.ndarray, slots: np.ndarray) -> None:
        """Link ``slots`` into their per-gid chains (join _SideState trick:
        one stable sort; within a same-gid run each slot links to its
        predecessor, the first links to the gid's previous head, the last
        becomes the new head)."""
        n = len(gids)
        if n == 0:
            return
        order = np.argsort(gids, kind="stable")
        gs = np.asarray(gids)[order]
        ss = np.asarray(slots)[order].astype(np.int32)
        first = np.empty(n, dtype=bool)
        first[0] = True
        first[1:] = gs[1:] != gs[:-1]
        linkv = np.empty(n, dtype=np.int32)
        linkv[~first] = ss[:-1][~first[1:]]
        linkv[first] = self.head[gs[first]]
        self.link[ss] = linkv
        last = np.empty(n, dtype=bool)
        last[-1] = True
        last[:-1] = first[1:]
        self.head[gs[last]] = ss[last]

    def open_slots_of(self, gids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """All open slots of the given gids: (slots, owner_pos) where
        ``owner_pos[i]`` indexes into ``gids``.  Vectorized chain walk —
        one hop per iteration across ALL queried gids simultaneously (the
        join-probe pattern); iterations = max open sessions per key,
        almost always 1."""
        k = len(gids)
        if k == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e
        cur = self.head[np.asarray(gids)].astype(np.int64)
        pos = np.arange(k, dtype=np.int64)
        out_s: list[np.ndarray] = []
        out_p: list[np.ndarray] = []
        while True:
            m = cur >= 0
            if not m.any():
                break
            cur = cur[m]
            pos = pos[m]
            out_s.append(cur)
            out_p.append(pos)
            cur = self.link[cur].astype(np.int64)
        if not out_s:
            e = np.empty(0, dtype=np.int64)
            return e, e
        return np.concatenate(out_s), np.concatenate(out_p)

    def remove_slots(self, slots: np.ndarray) -> np.ndarray:
        """Unlink + free ``slots``; returns the gids left with NO open
        session (candidates for interner gid recycling).  Chains of the
        affected gids are rebuilt from their surviving slots."""
        if len(slots) == 0:
            return np.empty(0, dtype=np.int64)
        affected = np.unique(self.gid[slots]).astype(np.int64)
        all_slots, owner = self.open_slots_of(affected)
        rm = np.zeros(len(self.start), dtype=bool)
        rm[slots] = True
        keep = ~rm[all_slots]
        self.head[affected] = -1
        self.chain(affected[owner[keep]], all_slots[keep])
        self.free(np.asarray(slots))
        return affected[self.head[affected] == -1]

    # -- accounting (obs/statewatch.py) ----------------------------------
    def per_slot_nbytes(self) -> int:
        """Exact bytes one slot occupies across the parallel arrays —
        the restore-invariant unit of the session operator's live-state
        accounting (live bytes = live slots x this; allocated capacity
        is reported separately, it may differ across a restore)."""
        V = self.num_value_cols
        return int(
            self.start.itemsize
            + self.last.itemsize
            + self.row_count.itemsize
            + self.gid.itemsize
            + self.link.itemsize
            + self.live.itemsize
            + V
            * (
                self.counts.itemsize
                + self.sums.itemsize
                + self.mins.itemsize
                + self.maxs.itemsize
                + self.means.itemsize
                + self.m2s.itemsize
            )
        )

    def capacity_nbytes(self) -> int:
        """Actually-allocated storage (all slots, live or free, plus the
        per-gid head index)."""
        return sum(
            int(a.nbytes)
            for a in (
                self.start, self.last, self.row_count, self.counts,
                self.sums, self.mins, self.maxs, self.means, self.m2s,
                self.gid, self.link, self.live, self.head,
            )
        )

    # -- cold-tier eviction hooks (state/tiering.py) ---------------------
    #: the per-slot payload arrays a spill block carries (gid/link/live
    #: are structural and re-derived at reload; accs ride the block meta)
    SPILL_FIELDS = (
        "start", "last", "row_count", "counts", "sums", "mins", "maxs",
        "means", "m2s",
    )

    def extract_slots(self, slots: np.ndarray) -> dict[str, np.ndarray]:
        """Gather the payload arrays of ``slots`` (one vectorized take
        per field) for cold-tier serialization.  The caller follows up
        with :meth:`remove_slots` — extract is read-only."""
        return {
            name: getattr(self, name)[slots].copy()
            for name in self.SPILL_FIELDS
        }

    def inject_slots(
        self, gids: np.ndarray, fields: dict[str, np.ndarray]
    ) -> np.ndarray:
        """Re-admit previously extracted sessions: allocate slots,
        scatter every payload field, and chain them into their gids'
        lists.  Returns the slot indices (for accumulator re-attach)."""
        n = len(gids)
        slots = self.alloc(n)
        for name in self.SPILL_FIELDS:
            getattr(self, name)[slots] = fields[name]
        self.gid[slots] = gids
        self.live[slots] = True
        self.chain(np.asarray(gids, dtype=np.int64), slots)
        return slots

    # -- scans -----------------------------------------------------------
    def live_slots(self) -> np.ndarray:
        return np.nonzero(self.live[: self._hwm])[0]

    def expired_slots(self, gap_ms: int, watermark: int) -> np.ndarray:
        idx = self.live_slots()
        if len(idx) == 0:
            return idx
        return idx[self.last[idx] + gap_ms <= watermark]
