"""Symmetric streaming hash join — counterpart of
``denormalized_tpu/physical/join_exec.py``.

The reference gets stream-stream joins from DataFusion's join over two
windowed streams (datastream.rs:126-177; examples/examples/stream_join.rs
joins two windowed aggregates on (sensor, window bounds)).  This operator
builds a table per side and probes the opposite table as batches arrive
from either input; its state is host memory (numpy), while the windows
below it keep their rings on the device.

Build and probe are vectorized: join keys intern through ONE shared
:class:`GroupInterner` (both sides see the same dense ids), and each side
keeps its rows as chained arrays — ``head[gid]`` points at the side's newest
row for a key and ``link[row]`` at the previous one.  Inserts chain a whole
batch with one stable sort over its gids; probes walk all chains at once,
one chain hop per numpy iteration.

Memory is bounded by watermark-driven eviction: a row matches rows whose
event time is within ``retention_ms`` of the join watermark (the min of
both sides' watermarks), then evicts — and, for outer joins, is emitted
unmatched at eviction or EOS.  Both children run on pump threads
(:mod:`runtime.pump`), so a slow side cannot stall the other: with two
windows below, both rings update on the card from two threads, each on its
thread's current stream.

Hot-key sub-partitioning: when the closed-loop policy
(:mod:`obs.doctor.actions`) names a key hot from the intern-time
Space-Saving sketch, :meth:`_SideState.adapt` moves that key's rows out of
the chains into a dense contiguous block (:class:`_HotStore`), and probes
against it become one mask + one multi-arange gather.  Pair ORDER is part
of the operator contract — probe-major, newest build row first per probe
row — and both layouts produce it exactly, so an adapted run's emissions
equal the unadapted run's.

Banded (interval) joins: a :class:`~logical.plan.JoinBand` keeps a pair
only when ``left_expr - right_expr`` lands in ``[lower_ms, upper_ms]``.
Each side caches its band value per row (float64, NaN for a null, which
matches nothing) at insert, and the band filter runs on the probe's index
arrays before any row is gathered.  With ``band_slack_ms`` set, eviction
also drops whole batches whose band values can no longer meet a future
row of the other side (:func:`band_evict_mask`).

Checkpointing: at an ALIGNED marker (both inputs delivered it) the join
writes both sides' retained rows, ``matched`` flags, batch boundaries,
watermarks, band state and hot-block representatives under
``join_{node_id}``, in the JAX package's meta and array layout, so either
package restores the other's snapshot; a restore re-interns the keys and
rebuilds the chains and hot blocks.

Cold tier (``enable_spill``, under a state budget): :class:`_JoinTier`
spills whole retained batches a side to the LSM — the chained index arrays
stay resident, they are the probe structure — and reloads a batch only
when a probe hit, an unmatched emission or a checkpoint needs its rows.
While any batch is spilled the snapshot takes the JAX package's v2 layout
(per-row gids and the interner ride along; spilled batches are referenced
blocks), which either package restores, with a budget or without one.

Shared-group cost attribution (``enable_shared_attribution``): when the
join feeds a shared slice pipeline (runtime/multi_query.py), its build,
probe and gather times also go to ``_stage_ms`` and the
``dnz_mq_join_stage_ms``/``dnz_mq_join_fanout_rows_total`` instruments,
and ``shared_cost_ms()`` hands their total to the slice operator, which
apportions it across subscribers by kept rows.

Observability: ``op="join"`` instruments, a state watch per side (with
metrics off the adaptive path owns live sketches fed every 4th batch),
the merged queue's wait as the doctor's input wait, and record-lineage
hops at the merge point.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import deque
from typing import Iterator

import numpy as np

from denormalized_tpu_torch import obs
from denormalized_tpu_torch.common.columns import as_numpy
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.common.errors import PlanError, StateError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema
from denormalized_tpu_torch.logical.expr import Expr, column_validity
from denormalized_tpu_torch.logical.plan import JoinKind
from denormalized_tpu_torch.obs import statewatch
from denormalized_tpu_torch.ops.interner import GroupInterner
from denormalized_tpu_torch.physical.base import (
    EOS,
    WM_ANNOUNCE,
    EndOfStream,
    ExecOperator,
    Marker,
    StreamItem,
    WatermarkHint,
)
from denormalized_tpu_torch.runtime.tracing import logger
from denormalized_tpu_torch.state import tiering


def band_evict_mask(
    batch_max_ts: np.ndarray,
    horizon: int,
    batch_band_max: np.ndarray | None,
    band_horizon: float | None,
) -> np.ndarray:
    """Whole-batch eviction verdicts from the cached per-batch maxima: a
    batch drops when every retained row is older than the time horizon
    OR — for interval joins — its band maximum sits so far behind the
    other side's band watermark that no future row can land in band.  One
    vectorized compare over the cached maxima; retained rows are never
    rescanned here."""
    drop = batch_max_ts < horizon
    if band_horizon is not None and batch_band_max is not None:
        drop = drop | (batch_band_max < band_horizon)
    return drop


class _HotStore:
    """Dense hot-key sub-partitions for one join side.

    One pooled int64 row-id buffer holds every hot key's block as a
    contiguous run with slack: per slot ``(gid, start, len, cap)``, plus a
    gid→slot ``lookup`` array sized like the side's ``head``.  Appends
    write in place into the slack; a full block relocates to the pool tail
    with doubled capacity.  Block rows are ALWAYS ascending global row ids
    — migration selects rows in insert order and appends only add newer
    rows — so one representative row per block rebuilds the layout.
    """

    __slots__ = (
        "pool", "used", "slot_gid", "slot_start", "slot_len", "slot_cap",
        "nslots", "lookup",
    )

    def __init__(self) -> None:
        self.pool = np.zeros(1024, dtype=np.int64)
        self.used = 0
        self.slot_gid = np.full(8, -1, dtype=np.int64)
        self.slot_start = np.zeros(8, dtype=np.int64)
        self.slot_len = np.zeros(8, dtype=np.int64)
        self.slot_cap = np.zeros(8, dtype=np.int64)
        self.nslots = 0
        self.lookup = np.full(1024, -1, dtype=np.int64)  # gid -> slot

    # -- bookkeeping -----------------------------------------------------
    def ensure_gids(self, max_gid: int) -> None:
        cap = len(self.lookup)
        if max_gid < cap:
            return
        while cap <= max_gid:
            cap *= 2
        new = np.full(cap, -1, dtype=np.int64)
        new[: len(self.lookup)] = self.lookup
        self.lookup = new

    def contains(self, gid: int) -> bool:
        return 0 <= gid < len(self.lookup) and self.lookup[gid] >= 0

    def gids(self) -> np.ndarray:
        return self.slot_gid[: self.nslots].copy()

    def rows_total(self) -> int:
        return int(self.slot_len[: self.nslots].sum())

    def rows_all(self) -> np.ndarray:
        """Every hot row id (per-slot order, slots concatenated)."""
        if self.nslots == 0:
            return np.empty(0, dtype=np.int64)
        return np.concatenate([
            self.pool[self.slot_start[s]: self.slot_start[s]
                      + self.slot_len[s]]
            for s in range(self.nslots)
        ])

    def reps(self) -> list[int]:
        """One representative row id (the block's OLDEST row) per
        non-empty block."""
        return [
            int(self.pool[self.slot_start[s]])
            for s in range(self.nslots)
            if self.slot_len[s] > 0
        ]

    def clear(self) -> None:
        if self.nslots:
            self.lookup[self.slot_gid[: self.nslots]] = -1
        self.slot_gid[: self.nslots] = -1
        self.slot_len[: self.nslots] = 0
        self.nslots = 0
        self.used = 0

    # -- growth ----------------------------------------------------------
    def _compact(self) -> None:
        """Repack every block contiguous at the head of a fresh pool
        (reclaims relocation holes and removed blocks' slack)."""
        need = int(
            np.maximum(64, 2 * self.slot_len[: self.nslots]).sum()
        )
        if need > len(self.pool):
            return  # not enough room even compacted — caller grows
        new_pool = np.zeros(len(self.pool), dtype=np.int64)
        new_start = self.slot_start.copy()
        new_used = 0
        for s in range(self.nslots):
            ln = int(self.slot_len[s])
            cap = max(64, 2 * ln)
            new_pool[new_used: new_used + ln] = self.pool[
                self.slot_start[s]: self.slot_start[s] + ln
            ]
            new_start[s] = new_used
            self.slot_cap[s] = cap
            new_used += cap
        self.pool = new_pool
        self.slot_start = new_start
        self.used = new_used

    def _ensure_pool(self, extra: int) -> None:
        if self.used + extra <= len(self.pool):
            return
        live = self.rows_total()
        if live + 2 * extra + 64 * max(self.nslots, 1) <= len(self.pool) // 2:
            self._compact()
            if self.used + extra <= len(self.pool):
                return
        cap = len(self.pool)
        while self.used + extra > cap:
            cap *= 2
        new = np.zeros(cap, dtype=np.int64)
        new[: self.used] = self.pool[: self.used]
        self.pool = new

    def _ensure_slots(self) -> None:
        if self.nslots < len(self.slot_gid):
            return
        cap = 2 * len(self.slot_gid)
        for name in ("slot_gid", "slot_start", "slot_len", "slot_cap"):
            old = getattr(self, name)
            new = np.full(cap, -1, dtype=np.int64) if name == "slot_gid" \
                else np.zeros(cap, dtype=np.int64)
            new[: self.nslots] = old[: self.nslots]
            setattr(self, name, new)

    # -- mutation --------------------------------------------------------
    def adopt(self, gid: int, rows: np.ndarray) -> None:
        """Open a block for ``gid`` with the given (ascending) rows."""
        n = len(rows)
        cap = max(64, 2 * n)
        self._ensure_pool(cap)
        self._ensure_slots()
        s = self.nslots
        start = self.used
        self.pool[start: start + n] = rows
        self.slot_gid[s] = gid
        self.slot_start[s] = start
        self.slot_len[s] = n
        self.slot_cap[s] = cap
        self.used += cap
        self.nslots += 1
        self.ensure_gids(gid)
        self.lookup[gid] = s

    def append(self, slot: int, rows: np.ndarray) -> None:
        """Append (ascending, newer-than-existing) rows to a block,
        relocating it to the tail with doubled capacity when full."""
        n = len(rows)
        ln = int(self.slot_len[slot])
        if ln + n > self.slot_cap[slot]:
            cap = max(64, 2 * (ln + n))
            self._ensure_pool(cap)
            old = self.pool[
                self.slot_start[slot]: self.slot_start[slot] + ln
            ].copy()
            start = self.used
            self.pool[start: start + ln] = old
            self.slot_start[slot] = start
            self.slot_cap[slot] = cap
            self.used += cap
        start = int(self.slot_start[slot])
        self.pool[start + ln: start + ln + n] = rows
        self.slot_len[slot] = ln + n

    def remove(self, gid: int) -> np.ndarray:
        """Close a block and return its rows (ascending); the pool hole is
        reclaimed by the next compaction."""
        s = int(self.lookup[gid])
        rows = self.pool[
            self.slot_start[s]: self.slot_start[s] + self.slot_len[s]
        ].copy()
        self.lookup[gid] = -1
        last = self.nslots - 1
        if s != last:
            for name in ("slot_gid", "slot_start", "slot_len", "slot_cap"):
                getattr(self, name)[s] = getattr(self, name)[last]
            self.lookup[self.slot_gid[s]] = s
        self.slot_gid[last] = -1
        self.slot_len[last] = 0
        self.nslots = last
        return rows

    # -- probe -----------------------------------------------------------
    def slot_of(self, gids: np.ndarray) -> np.ndarray:
        """Per-probe-row hot slot index (-1 = cold), bounds-safe for gids
        past the lookup's current capacity."""
        lk = self.lookup
        safe = np.minimum(gids.astype(np.int64), len(lk) - 1)
        return np.where(gids < len(lk), lk[safe], -1)

    def probe_pairs(
        self, slots: np.ndarray, p_idx: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """All (probe_row, build_row) pairs for hot probe rows: one
        multi-arange over the contiguous blocks — probe-major, newest build
        row first per probe row (the chain walk's order)."""
        lens = self.slot_len[slots]
        nz = lens > 0
        if not nz.all():
            slots = slots[nz]
            p_idx = p_idx[nz]
            lens = lens[nz]
        total = int(lens.sum())
        if total == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e.copy()
        pp = np.repeat(p_idx, lens)
        ends = np.cumsum(lens)
        k = np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)
        bstart = np.repeat(self.slot_start[slots], lens)
        blen = np.repeat(lens, lens)
        bb = self.pool[bstart + (blen - 1 - k)]
        return pp, bb

    def nbytes(self) -> int:
        """Live accounting bytes: hot row ids only (pool slack and the gid
        lookup are capacity, excluded)."""
        return self.rows_total() * int(self.pool.itemsize)


class _SideState:
    """Chained-array row store for one join side."""

    __slots__ = (
        "batches",
        "batch_max_ts",
        "batch_band_max",
        "band_wm",
        "head",
        "link",
        "row_bi",
        "row_ri",
        "row_gid",
        "matched",
        "row_band",
        "hot",
        "count",
        "watermark",
        "src_watermarks",
        "done",
    )

    def __init__(self, with_band: bool = False) -> None:
        self.batches: list[RecordBatch] = []  # retained row storage
        self.batch_max_ts: list[int] = []  # cached per-batch max event time
        # band-aware eviction bookkeeping (interval joins): per-batch max
        # FINITE band value (NaN matches nothing, so an all-NaN batch is
        # -inf, band-dead at once), and this side's band watermark — the
        # max over batches of the min finite band value, the band-space
        # analog of the event-time watermark.  The OTHER side's rows whose
        # band reach lies below band_wm - slack can never match a future
        # row of this side.
        self.batch_band_max: list[float] = []
        self.band_wm: float | None = None
        self.head = np.full(1024, -1, dtype=np.int64)  # gid -> newest row
        self.link = np.empty(1024, dtype=np.int64)  # row -> older same-key row
        self.row_bi = np.empty(1024, dtype=np.int32)
        self.row_ri = np.empty(1024, dtype=np.int32)
        self.row_gid = np.empty(1024, dtype=np.int32)
        self.matched = np.zeros(1024, dtype=bool)
        # cached band-expression value per row (interval joins); NaN = a
        # null band value, which matches nothing
        self.row_band = np.empty(1024, dtype=np.float64) if with_band else None
        self.hot = _HotStore()
        self.count = 0
        self.watermark: int | None = None
        # True once this side's input sent a kind="partition" hint: batch
        # min-ts no longer advances this side's watermark
        self.src_watermarks = False
        self.done = False

    def _ensure_rows(self, n: int) -> None:
        need = self.count + n
        cap = len(self.link)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        names = ["link", "row_bi", "row_ri", "row_gid"]
        if self.row_band is not None:
            names.append("row_band")
        for name in names:
            old = getattr(self, name)
            new = np.empty(cap, dtype=old.dtype)
            new[: self.count] = old[: self.count]
            setattr(self, name, new)
        m = np.zeros(cap, dtype=bool)
        m[: self.count] = self.matched[: self.count]
        self.matched = m

    def ensure_gids(self, max_gid: int) -> None:
        cap = len(self.head)
        if max_gid < cap:
            return
        while cap <= max_gid:
            cap *= 2
        new = np.full(cap, -1, dtype=np.int64)
        new[: len(self.head)] = self.head
        self.head = new

    def _chain(self, gids: np.ndarray, rows: np.ndarray) -> None:
        """Link ``rows`` (ascending global ids) into the per-key chains with
        one stable sort: within a same-gid run each row links to its
        predecessor, the run's first row links to the key's previous head,
        and the run's last row becomes the new head."""
        n = len(gids)
        if n == 0:
            return
        order = np.argsort(gids, kind="stable")
        gs = gids[order]
        rs = rows[order]
        first = np.empty(n, dtype=bool)
        first[0] = True
        first[1:] = gs[1:] != gs[:-1]
        linkv = np.empty(n, dtype=np.int64)
        linkv[~first] = rs[:-1][~first[1:]]
        linkv[first] = self.head[gs[first]]
        self.link[rs] = linkv
        last = np.empty(n, dtype=bool)
        last[-1] = True
        last[:-1] = first[1:]
        self.head[gs[last]] = rs[last]

    def insert(
        self,
        batch: RecordBatch,
        gids: np.ndarray,
        band_vals: np.ndarray | None = None,
    ) -> None:
        """Append a batch and chain its rows.  Rows whose key holds a hot
        sub-partition append to that block instead of the chains."""
        n = len(gids)
        self._ensure_rows(n)
        self.ensure_gids(int(gids.max()) if n else 0)
        base = self.count
        bi = len(self.batches)
        self.batches.append(batch)
        self.batch_max_ts.append(
            int(
                np.asarray(
                    batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64
                ).max()
            )
            if batch.num_rows
            else np.iinfo(np.int64).min
        )
        self.row_bi[base : base + n] = bi
        self.row_ri[base : base + n] = np.arange(n, dtype=np.int32)
        self.row_gid[base : base + n] = gids
        self.matched[base : base + n] = False
        if self.row_band is not None:
            self.row_band[base : base + n] = band_vals
            fin = band_vals[~np.isnan(band_vals)]
            if len(fin):
                self.batch_band_max.append(float(fin.max()))
                bmin = float(fin.min())
                self.band_wm = (
                    bmin if self.band_wm is None else max(self.band_wm, bmin)
                )
            else:
                self.batch_band_max.append(float("-inf"))
        self.count += n
        rows = np.arange(base, base + n, dtype=np.int64)
        if self.hot.nslots:
            slots = self.hot.slot_of(gids)
            hm = slots >= 0
            if hm.any():
                self._append_hot(slots[hm], rows[hm])
                rows = rows[~hm]
                gids = gids[~hm]
        self._chain(gids, rows)

    def _append_hot(self, slots: np.ndarray, rows: np.ndarray) -> None:
        """Route a batch's hot rows into their blocks: one segmented pass
        grouping by slot (iterates the distinct hot keys of the batch)."""
        order = np.argsort(slots, kind="stable")
        ss = slots[order]
        rr = rows[order]
        bounds = np.nonzero(
            np.concatenate(([True], ss[1:] != ss[:-1]))
        )[0]
        ends = np.append(bounds[1:], len(ss))
        for b0, b1 in zip(bounds.tolist(), ends.tolist()):
            self.hot.append(int(ss[b0]), rr[b0:b1])

    def rebuild(
        self,
        batches: list[RecordBatch],
        batch_max_ts: list[int],
        gids: np.ndarray,
        bis: np.ndarray,
        ris: np.ndarray,
        matched: np.ndarray,
        band: np.ndarray | None = None,
    ) -> None:
        """Replace all chained state with the given rows (insert order).
        Hot sub-partitions are cleared — callers that keep keys hot
        re-adopt them via :meth:`rehot` right after."""
        self.batches = batches
        self.batch_max_ts = batch_max_ts
        self.head.fill(-1)
        self.hot.clear()
        self.count = 0
        m = len(gids)
        self._ensure_rows(m)
        if m:
            self.ensure_gids(int(gids.max()))
        self.row_bi[:m] = bis
        self.row_ri[:m] = ris
        self.row_gid[:m] = gids
        self.matched[:m] = matched
        self.batch_band_max = []
        if self.row_band is not None:
            self.row_band[:m] = band
            # per-batch band maxima recomputed from the retained rows:
            # eviction is whole-batch, so each retained batch keeps all its
            # rows and the maxima equal the originals.  band_wm is a
            # monotone high-water mark over every batch ever inserted and
            # survives the rebuild untouched
            if m:
                bounds = np.nonzero(
                    np.concatenate(([True], bis[1:] != bis[:-1]))
                )[0]
                vals = np.asarray(band[:m], dtype=np.float64)
                vals = np.where(np.isnan(vals), float("-inf"), vals)
                self.batch_band_max = [
                    float(x) for x in np.maximum.reduceat(vals, bounds)
                ]
        self.count = m
        self._chain(gids, np.arange(m, dtype=np.int64))

    # -- hot-key sub-partitioning ---------------------------------------
    def adapt(self, gid: int) -> bool:
        """Migrate one key's rows out of the hash chains into a dense hot
        block.  The chain is unlinked wholesale (``head[gid] = -1`` — stale
        ``link`` entries are unreachable); block rows are the key's rows in
        insert order."""
        gid = int(gid)
        if self.hot.contains(gid):
            return False
        rows = np.nonzero(
            self.row_gid[: self.count] == gid
        )[0].astype(np.int64)
        self.hot.adopt(gid, rows)
        if gid < len(self.head):
            self.head[gid] = -1
        return True

    def fold(self, gid: int) -> None:
        """De-adapt: fold a decayed hot block back into the chains."""
        gid = int(gid)
        rows = self.hot.remove(gid)
        if len(rows):
            self._chain(
                np.full(len(rows), gid, dtype=np.int64), rows
            )

    def rehot(self, hot_gids) -> None:
        """Re-adopt hot keys after a :meth:`rebuild` renumbered rows
        (eviction, re-intern): each key's block is exactly its rows in
        insert order.  ONE membership-mask + grouping pass over
        ``row_gid`` covers every hot key."""
        self.hot.clear()
        gids_arr = np.unique(np.asarray(list(hot_gids), dtype=np.int64))
        if len(gids_arr) == 0:
            return
        rg = self.row_gid[: self.count].astype(np.int64, copy=False)
        mark = np.zeros(int(gids_arr.max()) + 1, dtype=bool)
        mark[gids_arr] = True
        safe = np.minimum(rg, len(mark) - 1)
        rows = np.nonzero((rg < len(mark)) & mark[safe])[0].astype(np.int64)
        # stable grouping keeps each key's rows ascending (insert order)
        order = np.argsort(rg[rows], kind="stable")
        rs = rows[order]
        gs = rg[rows][order]
        bounds = np.nonzero(
            np.concatenate(([True], gs[1:] != gs[:-1]))
        )[0] if len(rs) else np.empty(0, dtype=np.int64)
        ends = np.append(bounds[1:], len(rs))
        seen = set()
        for b0, b1 in zip(bounds.tolist(), ends.tolist()):
            g = int(gs[b0])
            seen.add(g)
            self.hot.adopt(g, rs[b0:b1])
        for g in gids_arr.tolist():
            if g not in seen:
                # a hot key whose rows all evicted keeps its (empty) block
                # — it stays hot until the policy folds it
                self.hot.adopt(int(g), np.empty(0, dtype=np.int64))
        for g in gids_arr.tolist():
            if g < len(self.head):
                self.head[g] = -1

    def probe(self, gids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """All (probe_row, build_row) pairs for the batch, PROBE-MAJOR:
        ordered by probe row, newest build row first within one probe row.
        Cold keys walk every chain at once (one hop per numpy iteration);
        hot keys expand their contiguous blocks in one multi-arange.  Both
        layouts produce the identical order."""
        n = len(gids)
        safe = np.minimum(gids.astype(np.int64), len(self.head) - 1)
        cur = np.where(gids < len(self.head), self.head[safe], -1)
        p = np.arange(n, dtype=np.int64)
        outs_p: list[np.ndarray] = []
        outs_b: list[np.ndarray] = []
        while True:
            m = cur >= 0
            if not m.any():
                break
            p = p[m]
            cur = cur[m]
            outs_p.append(p)
            outs_b.append(cur)
            cur = self.link[cur]
        if outs_p:
            cp = np.concatenate(outs_p)
            cb = np.concatenate(outs_b)
            if len(outs_p) > 1:
                # the walk yields hop-major; hop h IS the newest-first rank
                # within a probe row, and hop blocks are nested prefixes of
                # the probe set, so a pair's destination is start[p] + hop
                counts = np.bincount(cp, minlength=n)
                start = np.cumsum(counts) - counts
                hop_of = np.repeat(
                    np.arange(len(outs_p), dtype=np.int64),
                    [len(o) for o in outs_p],
                )
                dest = start[cp] + hop_of
                op_ = np.empty_like(cp)
                ob_ = np.empty_like(cb)
                op_[dest] = cp
                ob_[dest] = cb
                cp, cb = op_, ob_
        else:
            cp = np.empty(0, dtype=np.int64)
            cb = cp.copy()
        if not self.hot.nslots:
            return cp, cb
        slots = self.hot.slot_of(gids)
        hm = slots >= 0
        if not hm.any():
            return cp, cb
        hp, hb = self.hot.probe_pairs(
            slots[hm], np.nonzero(hm)[0].astype(np.int64)
        )
        if len(cp) == 0:
            return hp, hb
        if len(hp) == 0:
            return cp, cb
        return self.merge_pairs(cp, cb, hp, hb)

    @staticmethod
    def merge_pairs(
        cp: np.ndarray, cb: np.ndarray, hp: np.ndarray, hb: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Merge two probe-major pair streams over DISJOINT probe rows into
        one probe-major stream — searchsorted offsets + two scatters."""
        off_c = np.searchsorted(hp, cp)
        off_h = np.searchsorted(cp, hp)
        out_p = np.empty(len(cp) + len(hp), dtype=np.int64)
        out_b = np.empty(len(cp) + len(hp), dtype=np.int64)
        ic = np.arange(len(cp), dtype=np.int64) + off_c
        ih = np.arange(len(hp), dtype=np.int64) + off_h
        out_p[ic] = cp
        out_b[ic] = cb
        out_p[ih] = hp
        out_b[ih] = hb
        return out_p, out_b

    def gather(self, build_rows: np.ndarray) -> RecordBatch:
        """Materialize build-side rows (columns and masks) in order."""
        bis = self.row_bi[build_rows]
        ris = self.row_ri[build_rows]
        order = np.argsort(bis, kind="stable")
        inv = np.empty(len(order), dtype=np.int64)
        inv[order] = np.arange(len(order))
        bounds = np.nonzero(
            np.concatenate(([True], bis[order][1:] != bis[order][:-1]))
        )[0]
        ends = np.append(bounds[1:], len(order))
        pieces = []
        for b0, b1 in zip(bounds, ends):
            sel = order[b0:b1]
            pieces.append(
                self.batches[int(bis[sel[0]])].take(
                    ris[sel].astype(np.int64)
                )
            )
        merged = pieces[0] if len(pieces) == 1 else RecordBatch.concat(pieces)
        # back to probe-pair order
        return merged.take(inv)


class _JoinTier:
    """Cold tier of one streaming join: spills whole retained batches (the
    row payload — the chained index arrays stay resident, they ARE the
    probe structure) per side into the LSM, reloading a batch only when a
    probe hit, an outer-join unmatched emission, or a checkpoint needs its
    rows.  Cold rank: least-recently reloaded first, oldest event time as
    the tiebreak — retention-horizon rows evicted cold can die in the LSM
    without ever being read back.

    The newest batch of each side is never spilled (it is the batch the
    operator is processing)."""

    __slots__ = (
        "op", "node_id", "ctrl", "clock", "touch", "est", "blocks",
        "spilled_bytes", "spilled_rows", "_next",
    )

    #: estimated row-array overhead per retained row (link/bi/ri/gid/
    #: matched across the chained arrays)
    ROW_OVERHEAD = 32

    def __init__(self, op: "StreamingJoinExec", node_id: str, ctrl) -> None:
        self.op = op
        self.node_id = node_id
        self.ctrl = ctrl
        self.clock = 0
        # per side, aligned with side.batches: touch stamp + cached
        # accounting-bytes estimate; spilled-block map {bi: {...}}
        self.touch: list[list[int]] = [[], []]
        self.est: list[list[int]] = [[], []]
        self.blocks: list[dict[int, dict]] = [{}, {}]
        self.spilled_bytes = 0
        self.spilled_rows = 0
        self._next = 0
        ctrl.register(node_id, op, self.resident_bytes)

    def _side_idx(self, side) -> int:
        return 0 if side is self.op._sides[0] else 1

    def resident_bytes(self) -> int:
        """Cheap per-batch budget input: cached per-batch estimates of the
        RESIDENT batches plus the row-array overhead.  May run on another
        operator's thread: the list references are read once and the index
        bounded, so racing an append tears to a one-batch underestimate,
        never an IndexError."""
        sides = self.op._sides
        if sides is None:
            return 0
        total = 0
        for sid, side in enumerate(sides):
            est = self.est[sid]
            batches = side.batches
            for bi in range(min(len(batches), len(est))):
                if batches[bi] is not None:
                    total += est[bi]
            total += side.count * self.ROW_OVERHEAD
        return total

    @property
    def any_spilled(self) -> bool:
        return bool(self.blocks[0]) or bool(self.blocks[1])

    def note_insert(self, side_id: int, batch: RecordBatch) -> None:
        self.clock += 1
        self.touch[side_id].append(self.clock)
        self.est[side_id].append(statewatch.rb_nbytes(batch))

    # -- reload-on-touch --------------------------------------------------
    def ensure_rows_resident(self, side, build_rows: np.ndarray) -> None:
        """Reload every spilled batch the given build rows live in — called
        right before ``gather`` materializes them."""
        sid = self._side_idx(side)
        if not self.blocks[sid] or len(build_rows) == 0:
            return
        for bi in np.unique(side.row_bi[build_rows]).tolist():
            if int(bi) in self.blocks[sid]:
                self._reload(sid, side, int(bi))
        self._write_manifest()

    def _reload(self, sid: int, side, bi: int) -> None:
        meta = self.blocks[sid].pop(bi)
        raw = self.ctrl.get_block(self.node_id, meta["id"])
        schema = (self.op.left if sid == 0 else self.op.right).schema
        side.batches[bi] = tiering.rb_from_blob(raw, schema)[0]
        self.clock += 1
        self.touch[sid][bi] = self.clock
        self.spilled_bytes -= meta["bytes"]
        self.spilled_rows -= meta["rows"]
        self.ctrl.note_reload(self.node_id, 1, len(raw))
        self.ctrl.delete_block(self.node_id, meta["id"])
        self.op._state_info_cache = None

    # -- eviction interplay ----------------------------------------------
    def evict_prepare(self, side, drop_bi: np.ndarray, um: np.ndarray | None) -> None:
        """Before the eviction gather: reload dropped spilled batches that
        still owe unmatched emissions; DELETE the rest unread (cold rows
        dying at the horizon never come back from the LSM)."""
        sid = self._side_idx(side)
        if not self.blocks[sid]:
            return
        n = side.count
        needed: set[int] = set()
        if um is not None and um.any():
            needed = set(np.unique(side.row_bi[:n][um]).tolist())
        for bi in drop_bi.tolist():
            if int(bi) not in self.blocks[sid]:
                continue
            if int(bi) in needed:
                self._reload(sid, side, int(bi))
            else:
                meta = self.blocks[sid].pop(int(bi))
                self.spilled_bytes -= meta["bytes"]
                self.spilled_rows -= meta["rows"]
                self.ctrl.delete_block(self.node_id, meta["id"])
        self._write_manifest()

    def evict_remap(self, side, drop_set: np.ndarray, remap_bi) -> None:
        """After ``rebuild`` renumbered batch indices, renumber the touch
        stamps, estimates and block map the same way."""
        sid = self._side_idx(side)
        self.touch[sid] = [
            t for bi, t in enumerate(self.touch[sid]) if not drop_set[bi]
        ]
        self.est[sid] = [
            e for bi, e in enumerate(self.est[sid]) if not drop_set[bi]
        ]
        if self.blocks[sid]:
            self.blocks[sid] = {
                int(remap_bi[bi]): meta
                for bi, meta in self.blocks[sid].items()
            }

    # -- eviction ---------------------------------------------------------
    def maybe_spill(self) -> None:
        need = self.ctrl.over_budget()
        if need <= 0:
            self.ctrl.relax(self.node_id)
            return
        sides = self.op._sides
        # (stamp, max_ts, sid, bi) of every resident, spillable batch — the
        # NEWEST batch of each side stays resident, and a batch holding hot
        # sub-partition rows is a LAST RESORT: a hot block is probed every
        # batch, so spilling it would thrash, but a key present in every
        # batch must not make the budget unenforceable either
        cands = []
        hot_cands = []
        for sid, side in enumerate(sides):
            newest = len(side.batches) - 1
            hot_bis: set[int] = set()
            if side.hot.nslots:
                ra = side.hot.rows_all()
                if len(ra):
                    hot_bis = set(np.unique(side.row_bi[ra]).tolist())
            for bi, b in enumerate(side.batches):
                if b is None or bi == newest or b.num_rows == 0:
                    continue
                target = hot_cands if bi in hot_bis else cands
                target.append(
                    (self.touch[sid][bi], side.batch_max_ts[bi], sid, bi)
                )
        cands.sort()
        hot_cands.sort()
        cands += hot_cands
        freed = 0
        spilled_any = False
        for _stamp, _mx, sid, bi in cands:
            if freed >= need:
                break
            try:
                self._spill(sid, sides[sid], bi)
            except StateError as e:
                # failed eviction put: the batch stays resident; degrade
                # rather than kill the query
                logger.warning(
                    "spill: join eviction put failed (%s) — batch stays "
                    "resident", e,
                )
                break
            freed += self.blocks[sid][bi]["est"]
            spilled_any = True
        if spilled_any:
            self._write_manifest()
            self.op._state_info_cache = None
            tiering.release_freed_memory()
        self.ctrl.check_pressure(self.node_id)

    def _spill(self, sid: int, side, bi: int) -> None:
        batch = side.batches[bi]
        blob = tiering.rb_to_blob(
            batch, extra_meta={"max_ts": int(side.batch_max_ts[bi])}
        )
        block_id = f"s{sid}b{self._next}"
        self._next += 1
        nbytes = self.ctrl.put_block(self.node_id, block_id, blob)
        self.blocks[sid][bi] = {
            "id": block_id,
            "bytes": nbytes,
            "rows": batch.num_rows,
            "est": statewatch.rb_nbytes(batch),
        }
        side.batches[bi] = None
        self.spilled_bytes += nbytes
        self.spilled_rows += batch.num_rows
        self.ctrl.note_spill(self.node_id, 1, nbytes)

    def _write_manifest(self) -> None:
        self.ctrl.write_manifest(
            self.node_id,
            [m["id"] for s in self.blocks for m in s.values()],
        )

    def info(self) -> dict:
        return {
            "spilled_bytes": self.spilled_bytes,
            "spilled_keys": self.spilled_rows,
            "spilled_blocks": len(self.blocks[0]) + len(self.blocks[1]),
            "spill": self.ctrl.spill_stats(self.node_id),
        }

    # -- checkpoint integration -------------------------------------------
    def snapshot_refs(self, coord, key: str, epoch: int) -> list[dict]:
        refs = []
        for sid in (0, 1):
            for bi in sorted(self.blocks[sid]):
                meta = self.blocks[sid][bi]
                self.ctrl.copy_block_to_epoch(
                    coord, key, epoch, self.node_id, meta["id"]
                )
                refs.append({
                    "side": sid, "bi": bi, "id": meta["id"],
                    "bytes": meta["bytes"], "rows": meta["rows"],
                    "est": meta["est"],
                })
        return refs

    def restore_block(self, coord, key: str, ref: dict) -> None:
        """Epoch blob → spill namespace; the tier map entry re-armed
        without materializing the rows."""
        raw = self.ctrl.restore_block_from_epoch(
            coord, key, self.node_id, ref["id"]
        )
        sid, bi = int(ref["side"]), int(ref["bi"])
        self.blocks[sid][bi] = {
            "id": ref["id"], "bytes": len(raw),
            "rows": int(ref["rows"]), "est": int(ref["est"]),
        }
        self.spilled_bytes += len(raw)
        self.spilled_rows += int(ref["rows"])
        self._next = max(self._next, int(ref["id"].rsplit("b", 1)[1]) + 1)

    def align_touch(self, sides) -> None:
        """After a restore rebuilt the batch lists, re-seed the touch
        stamps (everything equally cold; reload order then follows event
        time) and the per-batch byte estimates."""
        for sid, side in enumerate(sides):
            self.touch[sid] = [0] * len(side.batches)
            self.est[sid] = [
                self.blocks[sid][bi]["est"] if b is None
                else statewatch.rb_nbytes(b)
                for bi, b in enumerate(side.batches)
            ]


class StreamingJoinExec(ExecOperator):
    def __init__(
        self,
        left: ExecOperator,
        right: ExecOperator,
        kind: JoinKind,
        left_keys: list[str],
        right_keys: list[str],
        filter_expr: Expr | None,
        schema: Schema,
        *,
        retention_ms: int = 300_000,
        band=None,
        band_slack_ms: int | None = None,
        adaptive: bool = True,
        adapt_interval_s: float = 1.0,
    ) -> None:
        if len(left_keys) != len(right_keys) or not left_keys:
            raise PlanError("join requires equal non-empty key lists")
        self.left = left
        self.right = right
        self.kind = kind
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.filter_expr = filter_expr
        self.schema = schema
        self.retention_ms = retention_ms
        # band (interval) predicate: left_expr - right_expr must land in
        # [lower_ms, upper_ms] for a pair to join (logical.plan.JoinBand)
        self.band = band
        # band-aware eviction slack (EngineConfig.join_band_slack_ms); None
        # keeps retention-only eviction
        self._band_slack_ms = band_slack_ms
        if band is not None:
            if band.lower_ms is None and band.upper_ms is None:
                raise PlanError(
                    "join band needs at least one bound (both lower_ms "
                    "and upper_ms are None)"
                )
            for e, side_schema, label in (
                (band.left_expr, left.schema, "left"),
                (band.right_expr, right.schema, "right"),
            ):
                missing = e.columns_referenced() - set(side_schema.names)
                if missing:
                    raise PlanError(
                        f"join band {label} expression references "
                        f"{sorted(missing)} not present on the {label} "
                        "input"
                    )
        # equi-key dtype compatibility: the shared interner assigns ids per
        # column (numeric dict vs string table), so joining a STRING key
        # against a numeric key would silently collide unrelated ids
        for lk, rk in zip(left_keys, right_keys):
            lf = left.schema.field(lk)
            rf = right.schema.field(rk)
            ok = lf.dtype is rf.dtype or (
                lf.dtype.is_numeric and rf.dtype.is_numeric
            )
            if not ok:
                raise PlanError(
                    f"join key dtype mismatch: {lk}: {lf.dtype} vs "
                    f"{rk}: {rf.dtype}"
                )
        # per-stage host time (s) and row counts: queue wait on the merged
        # pump queue, build (intern + sketch + insert), probe (index walk),
        # gather (pair materialization + filter), evict, adaptation policy
        self._metrics = {
            "rows_in": 0, "batches_in": 0, "rows_out": 0, "evicted": 0,
            "queue_wait_s": 0.0, "build_s": 0.0, "probe_s": 0.0,
            "gather_s": 0.0, "evict_s": 0.0, "policy_s": 0.0,
            # checkpoints: snapshots written, their bytes, the host's time
            # packing them and writing them (frame + CRC + LSM put), and
            # the restore's time (read, unpack, re-intern, rebuild)
            "snapshots": 0, "snapshot_bytes": 0, "snapshot_pack_s": 0.0,
            "snapshot_put_s": 0.0, "restore_s": 0.0,
        }
        self.bind_obs("join")
        # state observatory: one heavy-hitter/cardinality sketch pair PER
        # SIDE, windowed (decay_every) so the policy's shares track recent
        # traffic
        self._sw = statewatch.make_watch(
            "join", decay_every=statewatch.JOIN_SKETCH_DECAY_ROWS
        )
        self._sw_right = statewatch.make_watch(
            "join", decay_every=statewatch.JOIN_SKETCH_DECAY_ROWS
        )
        # with metrics off make_watch hands out the null watch, so the
        # adaptive path owns real sketches instead, fed every 4th batch
        # of a side (the policy decides at second granularity)
        self._sw_sample = 0
        self._sw_batches = [0, 0]
        self._sides = None  # run()'s live (_SideState, _SideState) pair
        # checkpointing (enable_checkpointing): (coordinator, state key)
        self._ckpt: tuple | None = None
        # cold tier (state/tiering.py): set by enable_spill
        self._tier: _JoinTier | None = None
        # closed-loop skew adaptation: the policy runs on the join's own
        # thread between batches
        self._policy = None
        if adaptive:
            from denormalized_tpu_torch.obs.doctor.actions import (
                JoinAdaptationPolicy,
            )

            self._policy = JoinAdaptationPolicy(interval_s=adapt_interval_s)
            if not self._sw:
                self._sw = statewatch.StateWatch(
                    "join", decay_every=statewatch.JOIN_SKETCH_DECAY_ROWS
                )
                self._sw_right = statewatch.StateWatch(
                    "join", decay_every=statewatch.JOIN_SKETCH_DECAY_ROWS
                )
                self._sw_sample = 4
        self._obs_rows_out = obs.counter("dnz_op_rows_out_total", op="join")
        # shared-group cost attribution (runtime/multi_query.py): when a
        # join feeds a shared slice pipeline, its MEASURED build/probe/
        # gather time is apportioned across subscribers by kept-rows
        # share instead of 1/N.  Off by default: the single-query path
        # never feeds the stage ledger
        self._shared_attr = False
        self._stage_ms = {"build": 0.0, "probe": 0.0, "gather": 0.0}
        self._obs_mq_stage = {
            s: obs.histogram("dnz_mq_join_stage_ms", stage=s)
            for s in ("build", "probe", "gather")
        }
        self._obs_mq_fanout = obs.counter("dnz_mq_join_fanout_rows_total")
        # adaptation counters pre-bound per (action, side)
        self._obs_adapt = {
            (a, s): obs.counter(
                "dnz_join_adaptations_total", action=a, side=s
            )
            for a in ("adapt", "fold")
            for s in ("left", "right")
        }
        # re-keying threshold (tests lower it to force the path)
        self._reintern_min = 262_144
        # ONE interner for the join: both sides' keys map to the same ids
        self._interner = GroupInterner(len(left_keys))
        # output column plan: all left fields, then right fields minus
        # canonical-ts and shared equi-keys (mirrors lp.Join schema logic)
        left_names = set(left.schema.names)
        self._right_out = [
            f.name
            for f in right.schema
            if f.name != CANONICAL_TIMESTAMP_COLUMN and f.name not in left_names
        ]
        # existence joins output LEFT rows only — self.schema is the left
        # schema — but the join FILTER still evaluates over matched pairs,
        # so pair assembly uses this schema (== self.schema for every
        # other kind)
        self._existence = kind in (JoinKind.LEFT_SEMI, JoinKind.LEFT_ANTI)
        if self._existence:
            self._pair_schema = Schema(
                list(left.schema.fields)
                + [right.schema.field(n) for n in self._right_out]
            )
        else:
            self._pair_schema = schema

    @property
    def children(self):
        return [self.left, self.right]

    def _label(self):
        on = ", ".join(f"{l}={r}" for l, r in zip(self.left_keys, self.right_keys))
        return f"StreamingJoinExec({self.kind.value} on {on})"

    # -- cold tier (state/tiering.py) -----------------------------------
    def enable_spill(self, node_id: str, controller) -> None:
        self._tier = _JoinTier(self, node_id, controller)

    def metrics(self):
        m = dict(self._metrics)
        sides = self._sides
        if sides is not None:
            m["hot_keys"] = sum(int(s.hot.nslots) for s in sides)
        if self._policy is not None:
            m["adaptations"] = self._policy.adaptations_total
        if self._shared_attr:
            m["shared_cost_ms"] = self.shared_cost_ms()
        return m

    # -- shared-group cost attribution (runtime/multi_query.py) ---------
    def enable_shared_attribution(self) -> None:
        """Turn on the build/probe/gather stage ledger so a shared
        pipeline can apportion the join's measured cost across
        subscribers (slice_exec.shared_fractions)."""
        self._shared_attr = True

    def shared_cost_ms(self) -> float:
        """Total measured join time (build + probe + gather, ms) since
        attribution was enabled — the upstream cost the shared slice
        operator folds into its per-subscriber attribution."""
        return float(sum(self._stage_ms.values()))

    # -- state accounting (read from the join's thread or after the run) --
    def _side_state_info(self, side: _SideState) -> dict:
        n = side.count
        per_row = int(
            side.link.itemsize + side.row_bi.itemsize
            + side.row_ri.itemsize + side.row_gid.itemsize + 1  # matched
        )
        if side.row_band is not None:
            per_row += int(side.row_band.itemsize)
        # spilled batches sit as None placeholders: their rows cost the
        # LSM, not RAM
        batch_bytes = sum(
            statewatch.rb_nbytes(b) for b in side.batches if b is not None
        )
        # hot sub-partitions, counted apart (hot_bytes): hot row ids + each
        # hot row's proportional share of its batch's bytes
        hot_keys = int(side.hot.nslots)
        hot_rows = side.hot.rows_total()
        hot_bytes = side.hot.nbytes() + hot_rows * per_row
        if hot_rows:
            cnt = np.bincount(
                side.row_bi[side.hot.rows_all()], minlength=len(side.batches)
            )
            for bi in np.nonzero(cnt)[0]:
                b = side.batches[int(bi)]
                if b is not None and b.num_rows:
                    hot_bytes += int(
                        statewatch.rb_nbytes(b) * (int(cnt[bi]) / b.num_rows)
                    )
        live_k = int(np.count_nonzero(side.head >= 0)) + hot_keys
        oldest = min(side.batch_max_ts) if side.batch_max_ts else None
        return {
            "rows": n,
            "batches": len(side.batches),
            "state_bytes": (
                batch_bytes + n * per_row
                + live_k * statewatch.KEY_EST_BYTES + side.hot.nbytes()
            ),
            "live_keys": live_k,
            "hot_keys": hot_keys,
            "hot_rows": hot_rows,
            "hot_bytes": hot_bytes,
            "oldest_event_ms": oldest,
            "watermark_ms": side.watermark,
        }

    def state_info(self) -> dict:
        sides = self._sides
        if sides is None:
            return {
                "op": "join", "state_bytes": 0, "live_keys": 0,
                "slot_capacity": 0, "slot_live": 0,
                "retention_unit_ms": self.retention_ms,
            }
        L = self._side_state_info(sides[0])
        R = self._side_state_info(sides[1])
        wms = [s["watermark_ms"] for s in (L, R) if s["watermark_ms"] is not None]
        olds = [s["oldest_event_ms"] for s in (L, R) if s["oldest_event_ms"] is not None]
        info = {
            "op": "join",
            "state_bytes": L["state_bytes"] + R["state_bytes"],
            "live_keys": L["live_keys"] + R["live_keys"],
            "hot_bytes": L["hot_bytes"] + R["hot_bytes"],
            "hot_keys": L["hot_keys"] + R["hot_keys"],
            "interner_keys_total": len(self._interner),
            "slot_capacity": int(len(sides[0].link) + len(sides[1].link)),
            "slot_live": L["rows"] + R["rows"],
            "retention_unit_ms": self.retention_ms,
            "sides": {"left": L, "right": R},
        }
        if self._tier is not None:
            info.update(self._tier.info())
        if self._policy is not None:
            info["adaptations"] = {
                "total": self._policy.adaptations_total,
                "by_action": dict(self._policy.counts),
                "recent": list(self._policy.events)[-8:],
            }
        if wms and olds:
            info["watermark_ms"] = min(wms)
            info["oldest_event_ms"] = min(olds)
            info["oldest_event_lag_ms"] = max(
                0, int(min(wms)) - int(min(olds))
            )
        return info

    def _state_watch_views(self):
        if not self._sw:
            return []
        from denormalized_tpu_torch.ops.interner import display_keys

        resolve = lambda g: display_keys(self._interner, g)  # noqa: E731
        return [
            ("left", self._sw, resolve),
            ("right", self._sw_right, resolve),
        ]

    # ------------------------------------------------------------------
    def _gids_of(self, batch: RecordBatch, names: list[str]) -> np.ndarray:
        return self._interner.intern([batch.column(n) for n in names])

    def _band_vals(self, batch: RecordBatch, is_left: bool) -> np.ndarray:
        """One side's band-expression values for a batch, as float64 with
        NaN where the expression reads a null (NaN compares False against
        both bounds, so a null band value matches nothing)."""
        e = self.band.left_expr if is_left else self.band.right_expr
        v = np.asarray(as_numpy(e.eval(batch)), dtype=np.float64)
        m = column_validity(e, batch)
        if m is not None and not m.all():
            v = v.copy()
            v[~np.asarray(m, dtype=bool)] = np.nan
        return v

    def _band_keep(
        self,
        probe_band: np.ndarray,
        p_idx: np.ndarray,
        build: _SideState,
        b_rows: np.ndarray,
        probe_is_left: bool,
    ) -> np.ndarray:
        """The band filter over equi-probe pairs: index arithmetic on the
        cached per-row band values, before any row gather."""
        pv = probe_band[p_idx]
        bv = build.row_band[b_rows]
        diff = pv - bv if probe_is_left else bv - pv
        lo = self.band.lower_ms
        hi = self.band.upper_ms
        if lo is not None and hi is not None:
            return (diff >= lo) & (diff <= hi)
        if lo is not None:
            return diff >= lo
        return diff <= hi

    def _probe(
        self,
        probe_batch: RecordBatch,
        probe_gids: np.ndarray,
        build: _SideState,
        probe_is_left: bool,
        probe_base: int,
        probe_side: _SideState,
        probe_band: np.ndarray | None = None,
    ) -> RecordBatch | None:
        """Join a new batch against the opposite side's table.  Rows are
        marked 'matched' (outer-join bookkeeping) only AFTER the band and
        the join filter accept the pair — an equi-hit either rejects must
        still surface as unmatched in an outer join.  ``probe_base`` is the
        probe side's row count BEFORE this batch inserted (its rows' global
        ids)."""
        p_idx, b_rows = build.probe(probe_gids)
        if len(p_idx) == 0:
            return None
        if self.band is not None:
            kb = self._band_keep(
                probe_band, p_idx, build, b_rows, probe_is_left
            )
            if not kb.all():
                p_idx = p_idx[kb]
                b_rows = b_rows[kb]
            if len(p_idx) == 0:
                return None
        if self._existence and self.filter_expr is None:
            # no pair materializes downstream and no filter reads one: the
            # index arrays alone decide existence
            return self._existence_probe(
                probe_batch, p_idx, b_rows,
                np.ones(len(p_idx), dtype=bool), probe_is_left,
                probe_base, probe_side, build,
            )
        tg = time.perf_counter()
        if self._tier is not None:
            # membership pre-probe: any spilled batch a hit landed in
            # reloads before the gather (nothing spilled: one check)
            self._tier.ensure_rows_resident(build, b_rows)
        p_take = probe_batch.take(p_idx)
        b_take = build.gather(b_rows)
        if probe_is_left:
            lt, rt = p_take, b_take
        else:
            lt, rt = b_take, p_take
        cols = [lt.column(n) for n in self.left.schema.names]
        masks = [lt.mask(n) for n in self.left.schema.names]
        cols += [rt.column(n) for n in self._right_out]
        masks += [rt.mask(n) for n in self._right_out]
        out = RecordBatch(self._pair_schema, cols, masks)
        keep = np.ones(out.num_rows, dtype=bool)
        if self.filter_expr is not None:
            keep = np.asarray(self.filter_expr.eval(out), dtype=bool)
        if self._existence:
            res = self._existence_probe(
                probe_batch, p_idx, b_rows, keep, probe_is_left,
                probe_base, probe_side, build,
            )
            dg = time.perf_counter() - tg
            self._metrics["gather_s"] += dg
            if self._shared_attr:
                self._stage_ms["gather"] += dg * 1e3
            return res
        if not keep.all():
            out = out.filter(keep)
        # mark matched pairs that survived the filter
        probe_side.matched[probe_base + p_idx[keep]] = True
        build.matched[b_rows[keep]] = True
        dg = time.perf_counter() - tg
        self._metrics["gather_s"] += dg
        if self._shared_attr:
            self._stage_ms["gather"] += dg * 1e3
        return out if out.num_rows else None

    def _existence_probe(
        self, probe_batch, p_idx, b_rows, keep, probe_is_left,
        probe_base, probe_side, build,
    ) -> RecordBatch | None:
        """Semi/anti probe: only the LEFT side's matched flags matter.  Semi
        emits each left row at most once: on arrival when it matches
        retained right rows, or on the matched flag's False→True transition
        when a later right batch probes it.  Anti emits nothing here
        (unmatched left rows surface at eviction/EOS)."""
        pk = p_idx[keep]
        bk = b_rows[keep]
        if probe_is_left:
            # this batch's left rows are new: any filtered match emits now
            probe_side.matched[probe_base + pk] = True
            build.matched[bk] = True
            if self.kind is JoinKind.LEFT_SEMI and len(pk):
                return probe_batch.take(np.unique(pk))
            return None
        # probe is the right side: matching LEFT rows live in `build`
        pre = build.matched[bk].copy()
        build.matched[bk] = True
        probe_side.matched[probe_base + pk] = True
        if self.kind is JoinKind.LEFT_SEMI:
            newly = np.unique(bk[~pre])
            if len(newly):
                if self._tier is not None:
                    self._tier.ensure_rows_resident(build, newly)
                return build.gather(newly)
        return None

    # ------------------------------------------------------------------
    def _evict(
        self,
        side: _SideState,
        is_left: bool,
        horizon: int,
        band_horizon: float | None = None,
    ):
        """Drop batches wholly older than the horizon — or, for interval
        joins, wholly below the band horizon — emit unmatched rows for
        outer joins, and rebuild the chained arrays over the retained
        rows.  Batch ages come from the cached per-batch max timestamps
        and band maxima — no rescans of retained data."""
        if not side.batches:
            return []
        drop_set = band_evict_mask(
            np.asarray(side.batch_max_ts, dtype=np.int64),
            horizon,
            np.asarray(side.batch_band_max, dtype=np.float64)
            if band_horizon is not None and side.batch_band_max else None,
            band_horizon,
        )
        if not drop_set.any():
            return []
        drop_bi = np.nonzero(drop_set)[0]
        n = side.count
        row_dropped = drop_set[side.row_bi[:n]]
        unmatched: list[RecordBatch] = []
        um = (
            row_dropped & ~side.matched[:n]
            if self._emits_unmatched(is_left)
            else None
        )
        if self._tier is not None:
            # dropped spilled batches owing unmatched emissions reload; the
            # rest die in the LSM without ever being read back
            self._tier.evict_prepare(side, drop_bi, um)
        if um is not None:
            for bi in drop_bi:
                sel = um & (side.row_bi[:n] == bi)
                if sel.any():
                    unmatched.append(
                        side.batches[bi].take(
                            side.row_ri[:n][sel].astype(np.int64)
                        )
                    )
        self._metrics["evicted"] += int(row_dropped.sum())

        keep_rows = ~row_dropped
        remap_bi = np.cumsum(~drop_set) - 1  # old bi -> new bi
        hot_gids = side.hot.gids() if side.hot.nslots else None
        side.rebuild(
            [b for bi, b in enumerate(side.batches) if not drop_set[bi]],
            [
                mx
                for bi, mx in enumerate(side.batch_max_ts)
                if not drop_set[bi]
            ],
            side.row_gid[:n][keep_rows].copy(),
            remap_bi[side.row_bi[:n][keep_rows]].astype(np.int32),
            side.row_ri[:n][keep_rows].copy(),
            side.matched[:n][keep_rows].copy(),
            band=(
                side.row_band[:n][keep_rows].copy()
                if side.row_band is not None else None
            ),
        )
        if hot_gids is not None:
            # eviction renumbered rows but not gids: re-adopt each hot key's
            # (possibly now empty) block so it stays hot
            side.rehot(hot_gids)
        if self._tier is not None:
            self._tier.evict_remap(side, drop_set, remap_bi)
        return unmatched

    def _evict_horizon(self, sides) -> Iterator[RecordBatch]:
        """Evict both sides against the joint watermark horizon (emitting
        null-padded unmatched rows for outer joins) — shared by the
        per-batch path and WatermarkHint handling."""
        if sides[0].watermark is None or sides[1].watermark is None:
            return
        t0 = time.perf_counter()
        horizon = (
            min(sides[0].watermark, sides[1].watermark) - self.retention_ms
        )
        # band-aware horizons: a pair joins iff left_band - right_band ∈
        # [lower_ms, upper_ms], so a LEFT row with band value L only ever
        # matches right rows with R ≥ L - upper … R ≤ L - lower.  Future
        # right rows carry band values ≥ right.band_wm - slack, so L is
        # dead once L < right.band_wm + lower_ms - slack (needs lower_ms:
        # without it an arbitrarily large future R still lands in band);
        # symmetrically a RIGHT row R is dead once R < left.band_wm -
        # upper_ms - slack (needs upper_ms)
        band_h: list[float | None] = [None, None]
        if self.band is not None and self._band_slack_ms is not None:
            slack = self._band_slack_ms
            if self.band.lower_ms is not None and sides[1].band_wm is not None:
                band_h[0] = sides[1].band_wm + self.band.lower_ms - slack
            if self.band.upper_ms is not None and sides[0].band_wm is not None:
                band_h[1] = sides[0].band_wm - self.band.upper_ms - slack
        out = []
        for (s, l), bh in zip(((sides[0], True), (sides[1], False)), band_h):
            for ub in self._evict(s, l, horizon, band_horizon=bh):
                padded = self._null_padded(ub, l)
                self._metrics["rows_out"] += padded.num_rows
                out.append(padded)
        # interner growth is keyed by DISTINCT keys ever seen; once it
        # dwarfs the retained rows (UUID-style keys), re-key from scratch
        # so memory stays bounded by retention, not stream lifetime
        retained = sides[0].count + sides[1].count
        if len(self._interner) > max(self._reintern_min, 4 * retained) and not (
            # re-interning reads every retained batch's key columns:
            # reloading the cold tier for it would defeat the spill, so it
            # waits until the cold set drains (eviction keeps the interner
            # bounded by retention regardless)
            self._tier is not None and self._tier.any_spilled
        ):
            self._reintern(sides)
        self._metrics["evict_s"] += time.perf_counter() - t0
        yield from out

    def _reintern(self, sides) -> None:
        """Re-key the join from a FRESH interner over the retained batches
        and re-chain both sides — amortized O(rows retained)."""
        self._interner = GroupInterner(len(self.left_keys))
        # the gid space just reset: old sketch entries name dead ids
        self._sw.reset_sketches()
        self._sw_right.reset_sketches()
        for side_id, side in enumerate(sides):
            names = self.left_keys if side_id == 0 else self.right_keys
            n = side.count
            # hot blocks survive via representative rows: row ids are
            # stable here (same batches, same order), only gid VALUES
            # change.  Empty blocks have no rep and lose hot status
            hot_reps = side.hot.reps() if side.hot.nslots else None
            if side.batches:
                gids = np.concatenate(
                    [self._gids_of(b, names) for b in side.batches]
                ).astype(np.int32)
            else:
                gids = np.empty(0, dtype=np.int32)
            side.head = np.full(1024, -1, dtype=np.int64)
            side.rebuild(
                side.batches,
                side.batch_max_ts,
                gids,
                side.row_bi[:n].copy(),
                side.row_ri[:n].copy(),
                side.matched[:n].copy(),
                band=(
                    side.row_band[:n].copy()
                    if side.row_band is not None else None
                ),
            )
            if hot_reps:
                side.rehot(np.unique(gids[np.asarray(hot_reps)]))

    def _emits_unmatched(self, is_left: bool) -> bool:
        if self.kind is JoinKind.FULL:
            return True
        if self.kind is JoinKind.LEFT_ANTI:
            # anti = left rows proven matchless: emitted when the horizon
            # passes them still unmatched (or at EOS); output is left-schema
            # rows, so _null_padded is a pass-through
            return is_left
        if self.kind is JoinKind.LEFT_SEMI:
            return False
        return (self.kind is JoinKind.LEFT) == is_left and self.kind in (
            JoinKind.LEFT,
            JoinKind.RIGHT,
        )

    def _null_padded(self, batch: RecordBatch, is_left: bool) -> RecordBatch:
        """Pad the missing side with nulls for outer-join unmatched rows."""
        n = batch.num_rows
        cols, masks = [], []
        for f in self.schema:
            if batch.schema.has(f.name):
                cols.append(batch.column(f.name))
                masks.append(batch.mask(f.name))
            else:
                cols.append(np.zeros(n, dtype=f.dtype.to_numpy()))
                masks.append(np.zeros(n, dtype=bool))
        return RecordBatch(self.schema, cols, masks)

    # -- checkpointing ---------------------------------------------------
    # Snapshot = both sides' retained rows (+ matched flags, batch
    # boundaries, watermarks, band values, hot-block representatives) at an
    # ALIGNED marker; keys, gids and chains are re-derived on restore by
    # re-interning, so the interner itself is never serialized.
    def enable_checkpointing(self, node_id: str, coord, orch) -> None:
        self._ckpt = (coord, f"join_{node_id}")

    def _snapshot(self, epoch: int, sides) -> None:
        from denormalized_tpu_torch.state.serialization import pack_snapshot

        coord, key = self._ckpt
        t0 = time.perf_counter()  # dnzlint: allow(replay-impure) the snapshot's time, observability only: the time never feeds the snapshot's bytes
        spilled = self._tier is not None and self._tier.any_spilled
        meta: dict = {"epoch": epoch, "sides": []}
        arrays: dict[str, np.ndarray] = {}
        if spilled:
            # v2 (cold tier active): spilled blocks are referenced from
            # this snapshot and their payloads committed under the SAME
            # epoch; per-row gids + the shared interner ride along so a
            # restore never materializes cold rows to re-intern them
            meta["interner"] = self._interner.snapshot()
            meta["spill"] = {
                "blocks": self._tier.snapshot_refs(coord, key, epoch)
            }
        for sid, (side, schema) in enumerate(
            zip(sides, (self.left.schema, self.right.schema))
        ):
            n = side.count
            resident = [b for b in side.batches if b is not None]
            rows = RecordBatch.concat(resident) if resident else None
            side_meta = {
                "watermark": side.watermark,
                "count": n,
                "strings": {},
                "masked": [],
            }
            if side.band_wm is not None:
                # band-aware eviction resumes exactly: the band watermark
                # rides the snapshot, batch band maxima rebuild from the
                # persisted per-row band values
                side_meta["band_wm"] = side.band_wm
            if rows is not None:
                # insert order == row-array order (v2: resident rows only)
                self._pack_side_cols(sid, rows, schema, side_meta, arrays)
            if n and (rows is not None or spilled):
                arrays[f"s{sid}_matched"] = side.matched[:n].copy()
                # per-batch boundaries: restore keeps the original batch
                # granularity, or whole-batch eviction by max ts would
                # retain (and match) rows past retention_ms
                arrays[f"s{sid}_row_bi"] = side.row_bi[:n].copy()
                arrays[f"s{sid}_batch_max_ts"] = np.asarray(
                    side.batch_max_ts, dtype=np.int64
                )
                if spilled:
                    arrays[f"s{sid}_row_gid"] = side.row_gid[:n].copy()
                if side.row_band is not None:
                    arrays[f"s{sid}_band"] = side.row_band[:n].copy()
            if side.hot.nslots:
                # one representative row a non-empty hot block: blocks hold
                # ascending row ids, so each rebuilds from its rep's gid
                side_meta["hot_reps"] = side.hot.reps()
            meta["sides"].append(side_meta)
        blob = pack_snapshot(meta, arrays)
        t1 = time.perf_counter()  # dnzlint: allow(replay-impure) the pack time, observability only: the time never feeds the snapshot's bytes
        coord.put_snapshot(key, epoch, blob)
        t2 = time.perf_counter()  # dnzlint: allow(replay-impure) the put time, observability only: the time never feeds the snapshot's bytes
        m = self._metrics
        m["snapshots"] += 1  # dnzlint: allow(snapshot-asym) the operator's metrics counter, not a payload key
        m["snapshot_bytes"] += len(blob)  # dnzlint: allow(snapshot-asym) the operator's metrics counter, not a payload key
        m["snapshot_pack_s"] += t1 - t0  # dnzlint: allow(snapshot-asym) the operator's metrics counter, not a payload key
        m["snapshot_put_s"] += t2 - t1  # dnzlint: allow(snapshot-asym) the operator's metrics counter, not a payload key

    def _restore(self, sides) -> None:
        """Continue from the committed epoch's snapshot, if there is one:
        the v1 layout re-interns the retained rows, the cold tier's v2
        layout (``meta["spill"]``) takes its interner and per-row gids from
        the blob (:meth:`_restore_v2`)."""
        from denormalized_tpu_torch.state.serialization import unpack_snapshot

        coord, key = self._ckpt
        t0 = time.perf_counter()  # dnzlint: allow(replay-impure) the restore's time, observability only
        blob = coord.get_snapshot(key)
        if blob is None:
            return
        meta, arrays = unpack_snapshot(blob)
        if meta.get("spill") is not None:
            self._restore_v2(coord, key, meta, arrays, sides)
        else:
            self._restore_v1(meta, arrays, sides)
            if self._tier is not None:
                # a v1 snapshot restored into a budgeted run: the tier's
                # per-batch touch/est lists must cover the rebuilt batch
                # lists, or the first budget check indexes past them
                self._tier.align_touch(sides)
        self._metrics["restore_s"] += time.perf_counter() - t0  # dnzlint: allow(replay-impure) the restore's time, observability only

    @staticmethod
    def _pack_side_cols(sid, rows, schema, side_meta, arrays) -> None:
        """One side's retained-row columns into the snapshot: columnar
        string/nested columns store their raw buffers, plain object columns
        the JSON ``strings`` lane."""
        from denormalized_tpu_torch.common.columns import (
            Column,
            column_to_arrays,
        )

        for f in schema:
            col = rows.column(f.name)
            if isinstance(col, Column):
                side_meta.setdefault("columnar", {})[f.name] = (
                    column_to_arrays(col, f"s{sid}_cc_{f.name}_", arrays)
                )
            else:
                colv = np.asarray(col)
                if colv.dtype == object:
                    side_meta["strings"][f.name] = [
                        None if v is None else str(v) for v in colv
                    ]
                else:
                    arrays[f"s{sid}_col_{f.name}"] = colv
            mask = rows.mask(f.name)
            # a columnar column packs its validity already
            if mask is not None and mask is not getattr(
                col, "validity", None
            ):
                side_meta["masked"].append(f.name)
                arrays[f"s{sid}_mask_{f.name}"] = np.asarray(
                    mask, dtype=bool
                )

    @staticmethod
    def _unpack_side_cols(sid, schema, side_meta, arrays) -> RecordBatch:
        """Inverse of :meth:`_pack_side_cols`."""
        from denormalized_tpu_torch.common.columns import column_from_arrays

        colspecs = side_meta.get("columnar", {})
        cols, masks = [], []
        for f in schema:
            if f.name in colspecs:
                cols.append(
                    column_from_arrays(
                        colspecs[f.name], f"s{sid}_cc_{f.name}_", arrays
                    )
                )
            elif f.name in side_meta["strings"]:
                vals = side_meta["strings"][f.name]
                arr = np.empty(len(vals), dtype=object)
                arr[:] = vals
                cols.append(arr)
            else:
                cols.append(arrays[f"s{sid}_col_{f.name}"])
            if f.name in side_meta["masked"]:
                masks.append(arrays.get(f"s{sid}_mask_{f.name}"))
            else:
                masks.append(getattr(cols[-1], "validity", None))
        return RecordBatch(schema, cols, masks)

    def _restore_v1(self, meta, arrays, sides) -> None:
        for sid, (side, schema, names) in enumerate(
            zip(
                sides,
                (self.left.schema, self.right.schema),
                (self.left_keys, self.right_keys),
            )
        ):
            side_meta = meta["sides"][sid]
            side.watermark = side_meta["watermark"]
            # a snapshot without band_wm leaves band-aware eviction off
            # until new batches re-establish the band watermark
            side.band_wm = side_meta.get("band_wm")
            n = int(side_meta["count"])
            if n == 0:
                continue
            merged = self._unpack_side_cols(sid, schema, side_meta, arrays)
            gids = self._gids_of(merged, names).astype(np.int32)
            # split back into the ORIGINAL batches: rows are stored in
            # (batch, row) insert order, so each batch is one run of bis
            bis = arrays[f"s{sid}_row_bi"].astype(np.int32)
            batch_max_ts = [
                int(x) for x in arrays[f"s{sid}_batch_max_ts"]
            ]
            starts = np.concatenate(([True], bis[1:] != bis[:-1]))
            bounds = np.nonzero(starts)[0]
            ends = np.append(bounds[1:], n)
            batches = [
                merged.take(np.arange(b0, b1, dtype=np.int64))
                for b0, b1 in zip(bounds, ends)
            ]
            ris = np.concatenate(
                [np.arange(b1 - b0, dtype=np.int32)
                 for b0, b1 in zip(bounds, ends)]
            )
            # renumber batch indices to positions in `batches`
            new_bi = np.cumsum(starts) - 1
            band = None
            if self.band is not None:
                band = arrays.get(f"s{sid}_band")
                if band is None:
                    # the snapshot predates the band predicate (the plan
                    # gained one since the cut): evaluate it over the
                    # restored rows, as the JAX package does
                    band = np.concatenate(
                        [self._band_vals(b, sid == 0) for b in batches]
                    )
            side.rebuild(
                batches,
                [batch_max_ts[int(bis[b0])] for b0 in bounds],
                gids,
                new_bi.astype(np.int32),
                ris,
                arrays[f"s{sid}_matched"].astype(bool),
                band=band,
            )
            reps = side_meta.get("hot_reps") or []
            if reps:
                side.rehot(
                    np.unique(gids[np.asarray(reps, dtype=np.int64)])
                )

    def _restore_v2(self, coord, key, meta, arrays, sides) -> None:
        """Restore a cold-tier snapshot: the interner and per-row gids come
        from the blob (no re-intern), resident batches rebuild from the
        resident-row concat, and spilled batches re-arm as tier-map
        placeholders — their payloads stream epoch → spill namespace one at
        a time.  Without a tier (the budget was removed since) spilled
        batches materialize resident instead."""
        self._interner = GroupInterner.restore(meta["interner"])
        by_side: list[dict[int, dict]] = [{}, {}]
        for ref in meta["spill"]["blocks"]:
            by_side[int(ref["side"])][int(ref["bi"])] = ref
        for sid, (side, schema) in enumerate(
            zip(sides, (self.left.schema, self.right.schema))
        ):
            side_meta = meta["sides"][sid]
            side.watermark = side_meta["watermark"]
            side.band_wm = side_meta.get("band_wm")
            n = int(side_meta["count"])
            if n == 0:
                continue
            bis = arrays[f"s{sid}_row_bi"].astype(np.int32)
            batch_max_ts = [int(x) for x in arrays[f"s{sid}_batch_max_ts"]]
            gids = arrays[f"s{sid}_row_gid"].astype(np.int32)
            # the resident-row concat (absent when every batch spilled)
            resident_rows = n - sum(
                int(r["rows"]) for r in by_side[sid].values()
            )
            merged = (
                self._unpack_side_cols(sid, schema, side_meta, arrays)
                if resident_rows > 0 else None
            )
            starts = np.concatenate(([True], bis[1:] != bis[:-1]))
            bounds = np.nonzero(starts)[0]
            ends = np.append(bounds[1:], n)
            batches: list[RecordBatch | None] = []
            cursor = 0
            for new_bi, (b0, b1) in enumerate(zip(bounds, ends)):
                ref = by_side[sid].get(int(bis[b0]))
                if ref is None:
                    ln = int(b1 - b0)
                    batches.append(merged.take(
                        np.arange(cursor, cursor + ln, dtype=np.int64)
                    ))
                    cursor += ln
                elif self._tier is not None:
                    self._tier.restore_block(coord, key, {**ref, "bi": new_bi})
                    batches.append(None)
                else:
                    raw = coord.get_snapshot(f"{key}:spill:{ref['id']}")
                    if raw is None:
                        raise StateError(
                            "checkpoint references spilled join block "
                            f"{ref['id']!r} but the epoch holds no such "
                            "snapshot"
                        )
                    batches.append(tiering.rb_from_blob(raw, schema)[0])
            ris = np.concatenate(
                [np.arange(b1 - b0, dtype=np.int32)
                 for b0, b1 in zip(bounds, ends)]
            )
            band = None
            if self.band is not None:
                band = arrays.get(f"s{sid}_band")
                if band is None:
                    raise StateError(
                        "banded join restoring a cold-tier snapshot "
                        "without band values — the snapshot predates the "
                        "band predicate and spilled rows cannot be "
                        "re-evaluated"
                    )
            side.rebuild(
                batches,
                [batch_max_ts[int(bis[b0])] for b0 in bounds],
                gids,
                (np.cumsum(starts) - 1).astype(np.int32),
                ris,
                arrays[f"s{sid}_matched"].astype(bool),
                band=band,
            )
            reps = side_meta.get("hot_reps") or []
            if reps:
                side.rehot(np.unique(gids[np.asarray(reps, dtype=np.int64)]))
        if self._tier is not None:
            self._tier.align_touch(sides)
            self._tier._write_manifest()

    # ------------------------------------------------------------------
    def run(self) -> Iterator[StreamItem]:
        from denormalized_tpu_torch.runtime.pump import spawn_pump

        with_band = self.band is not None
        sides = (_SideState(with_band), _SideState(with_band))
        self._sides = sides
        if self._ckpt is not None:
            self._restore(sides)
        m = self._metrics
        q: queue_mod.Queue = queue_mod.Queue(maxsize=8)
        done = threading.Event()
        for side_id, op in ((0, self.left), (1, self.right)):
            spawn_pump(
                q,
                done,
                op.run,
                sentinel=(side_id, EOS),
                wrap=lambda item, s=side_id: (s, item),
            )
        markers_seen: dict[int, int] = {}
        # barrier alignment: once one side delivered epoch E's marker, its
        # further items are buffered until the other side's E-marker
        # arrives, so no post-marker row of one side folds into state
        # before the cut
        blocked = [False, False]
        pending: deque[tuple[int, StreamItem]] = deque()
        # downstream event-time contract: joined rows can be as old as the
        # eviction horizon (a retained row matches a fresh probe), so a
        # downstream window advancing on raw batch mins would late-drop
        # legitimate pairs.  The join ANNOUNCES hint mode before its first
        # output and emits the joint low watermark (min(watermarks) −
        # retention) whenever it advances
        wm_announced = False
        wm_emitted: int | None = None
        try:
            while not (sides[0].done and sides[1].done):
                if pending and not (blocked[0] or blocked[1]):
                    side_id, item = pending.popleft()
                else:
                    # the merged queue is this operator's upstream handoff:
                    # time blocked here is the doctor's queue wait
                    t0_wait = time.perf_counter()
                    side_id, item = q.get()
                    dw = time.perf_counter() - t0_wait
                    m["queue_wait_s"] += dw
                    self._note_input_wait(dw)
                    if blocked[side_id] and not isinstance(
                        item, BaseException
                    ):
                        pending.append((side_id, item))
                        continue
                side, other = sides[side_id], sides[1 - side_id]
                is_left = side_id == 0
                if isinstance(item, BaseException):
                    raise item
                if isinstance(item, WatermarkHint):
                    if item.kind == "partition":
                        side.src_watermarks = True
                        if item.is_announcement:
                            yield item  # pure mode announcement
                            continue
                    # watermark advance on this side so the joint horizon
                    # can move and retained rows evict.  Downstream sees
                    # the JOINT low watermark, clamped by retention: rows
                    # above the horizon can still match a resuming side
                    # and produce output with their older timestamps
                    if side.watermark is None or item.ts_ms > side.watermark:
                        side.watermark = item.ts_ms
                    yield from self._evict_horizon(sides)
                    if (
                        sides[0].watermark is not None
                        and sides[1].watermark is not None
                    ):
                        yield WatermarkHint(
                            min(sides[0].watermark, sides[1].watermark)
                            - self.retention_ms,
                            kind=item.kind,
                        )
                    continue
                if isinstance(item, EndOfStream):
                    if side.done:
                        continue
                    side.done = True
                    if self._ckpt is None:
                        # without checkpointing markers are pure pass-
                        # throughs: flush any the live side(s) delivered
                        live = sum(1 for s in sides if not s.done)
                        for epoch in sorted(
                            e for e, c in markers_seen.items() if c >= live
                        ):
                            markers_seen.pop(epoch, None)
                            yield Marker(epoch)
                    else:
                        # a finished side takes part in no later barrier,
                        # so an epoch committed from here on would be an
                        # inconsistent cut (that side replays in full on
                        # restore while the join re-inserts its retained
                        # rows): drop pending markers; the last epoch both
                        # sides reached stays the recovery point
                        markers_seen.clear()
                    blocked[0] = blocked[1] = False
                    continue
                if isinstance(item, Marker):
                    c = markers_seen.get(item.epoch, 0) + 1
                    if self._ckpt is not None and (
                        sides[0].done or sides[1].done
                    ):
                        continue  # no consistent two-input cut (see EOS)
                    # align markers: forward once both sides delivered it
                    live = sum(1 for s in sides if not s.done)
                    if c >= live:
                        markers_seen.pop(item.epoch, None)
                        if self._ckpt is not None:
                            self._snapshot(item.epoch, sides)
                        yield item
                        blocked[0] = blocked[1] = False
                    else:
                        markers_seen[item.epoch] = c
                        blocked[side_id] = True
                    continue
                batch: RecordBatch = item
                if batch.num_rows == 0:
                    continue
                m["rows_in"] += batch.num_rows
                m["batches_in"] += 1
                self._obs_rows_in.add(batch.num_rows)
                if self._dr_lineage is not None:
                    # record-lineage hop (the generic _doctor_input hook
                    # cannot see through the merged queue)
                    self._dr_lineage.hop(self._dr_node_id, batch)
                t0_batch = time.perf_counter()
                gids = self._gids_of(
                    batch, self.left_keys if is_left else self.right_keys
                )
                nb = self._sw_batches[side_id]
                self._sw_batches[side_id] = nb + 1
                if not self._sw_sample or nb % self._sw_sample == 0:
                    (self._sw if is_left else self._sw_right).update(gids)
                band_vals = (
                    self._band_vals(batch, is_left)
                    if self.band is not None else None
                )
                # insert BEFORE probing: the probe targets the OTHER side
                # (no self-match) and the matched[] marks it writes for
                # this batch's rows must not be cleared by a later insert
                probe_base = side.count
                side.insert(batch, gids, band_vals)
                if self._tier is not None:
                    self._tier.note_insert(side_id, batch)
                t1 = time.perf_counter()
                m["build_s"] += t1 - t0_batch
                g0 = m["gather_s"]
                out = self._probe(
                    batch, gids, other, is_left, probe_base, side, band_vals
                )
                # _probe accumulated its gather sub-phase itself; the rest
                # of the call is index-probe time
                gather_d = m["gather_s"] - g0
                tp = max(time.perf_counter() - t1 - gather_d, 0.0)
                m["probe_s"] += tp
                if self._shared_attr:
                    tb = (t1 - t0_batch) * 1e3
                    self._stage_ms["build"] += tb
                    self._stage_ms["probe"] += tp * 1e3
                    self._obs_mq_stage["build"].observe(tb)
                    self._obs_mq_stage["probe"].observe(tp * 1e3)
                    self._obs_mq_stage["gather"].observe(gather_d * 1e3)
                    if out is not None:
                        self._obs_mq_fanout.add(out.num_rows)
                self._note_batch(t0_batch, batch.num_rows)
                if out is not None:
                    if not wm_announced:
                        # switch downstream to hint-driven watermarks
                        # BEFORE any joined rows
                        wm_announced = True
                        yield WatermarkHint(WM_ANNOUNCE, kind="partition")
                    m["rows_out"] += out.num_rows
                    self._obs_rows_out.add(out.num_rows)
                    yield out
                # watermark & eviction
                if not side.src_watermarks:
                    bmin = int(
                        np.asarray(
                            batch.column(CANONICAL_TIMESTAMP_COLUMN),
                            dtype=np.int64,
                        ).min()
                    )
                    if side.watermark is None or bmin > side.watermark:
                        side.watermark = bmin
                yield from self._evict_horizon(sides)
                if (
                    wm_announced
                    and sides[0].watermark is not None
                    and sides[1].watermark is not None
                ):
                    low = (
                        min(sides[0].watermark, sides[1].watermark)
                        - self.retention_ms
                    )
                    if wm_emitted is None or low > wm_emitted:
                        wm_emitted = low
                        yield WatermarkHint(low, kind="partition")
                if self._tier is not None:
                    self._tier.maybe_spill()
                if self._policy is not None:
                    # closed loop: layout mutations run on the join's own
                    # thread between batches, never racing the probe
                    tp = time.perf_counter()
                    self._policy.maybe_tick(self, sides)
                    m["policy_s"] += time.perf_counter() - tp
            # EOS: flush unmatched for outer joins
            for s, l in ((sides[0], True), (sides[1], False)):
                if self._emits_unmatched(l):
                    for ub in self._evict(s, l, np.iinfo(np.int64).max):
                        padded = self._null_padded(ub, l)
                        m["rows_out"] += padded.num_rows
                        yield padded
            yield EOS
        finally:
            done.set()
