"""Session windows — per-key gap-separated windows, fully vectorized.

The reference *declares* session windows (``StreamingWindowType::Session``,
logical_plan/streaming_window.rs:69-74) but its operator hits ``todo!()`` at
runtime (streaming_window.rs window-assignment session arm).  This operator
implements them: a session for key k is a maximal run of events where
consecutive timestamps are ≤ ``gap_ms`` apart; the window closes (and emits)
when the watermark passes ``last_ts + gap_ms``.

Sessions are data-dependent (no static window grid), so state lives
host-side — but "host-side" no longer means "Python objects".  The hot path
is zero per-row Python for the built-in aggregates
(count/sum/min/max/avg/stddev):

1. group keys intern to dense gids through
   :class:`~denormalized_tpu_torch.ops.interner.RecyclingGroupInterner` (the same
   native PyObject fast path the tumbling operator and the join use; closed
   keys' gids recycle through a free list).  This also FIXES a correctness
   bug of the pre-vectorization operator: its salted 64-bit ``hash(tuple)``
   composite could collide and silently merge two distinct keys' segments —
   dense interner ids cannot collide.
2. per-batch segmenting is one lexsort by (gid, ts) + boundary scan, and ALL
   segment partials (counts/sums/mins/maxs + masked Chan moment columns)
   come out of single ``np.<ufunc>.reduceat`` passes — no Python loop over
   segments, no per-segment objects.
3. open sessions live in a :class:`~denormalized_tpu_torch.ops.session_table
   .SessionTable`: a StreamBox-HBM-style SoA slot store (flat numpy arrays
   start/last/counts/sums/mins/maxs/means/m2s, per-gid chains like the
   join's ``_SideState``, slot free list).  Merging a batch's boundary
   segments into open sessions — including out-of-order bridges that fuse
   several open sessions — is ONE combined interval-merge sweep: gather the
   touched gids' open sessions, sort the union with the new segments by
   (gid, start), find merged runs with a segmented running max
   (``start − runmax(last) > gap`` starts a run), fold each run with
   reduceat, scatter back.  Watermark close/emit is a vectorized scan of
   the live slots.
4. the late-row salvage path keeps its per-row arrival-order semantics but
   only rows whose KEY has a candidate open interval walk it; every other
   row stays on the vectorized path.

UDAF/collection aggregates keep the accumulator-per-segment contract (user
code is inherently per-segment Python); they ride the same segmenting and
the same SoA store, with their accumulators in a slot-keyed side dict.

The pre-vectorization operator is preserved verbatim as
``physical/session_reference.py`` (``DENORMALIZED_SESSION_REFERENCE=1``
selects it) and serves as the differential oracle.

Counterpart of ``denormalized_tpu/physical/session_exec.py``: host numpy in
both packages, so the port runs the same code.  Checkpoints write the JAX
package's JSON blob under ``session_{node_id}`` and restore either
package's (or the reference operator's).  Under a state budget
(``enable_spill``) :class:`_SessionTier` moves the coldest keys' open
sessions to the LSM and back, as the JAX package's does.
"""

from __future__ import annotations

from typing import Iterator

import itertools
import json
import time

import numpy as np

from denormalized_tpu_torch.common.constants import (
    CANONICAL_TIMESTAMP_COLUMN,
    WINDOW_END_COLUMN,
    WINDOW_START_COLUMN,
)
from denormalized_tpu_torch.common.errors import PlanError, StateError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.logical.expr import (
    VAR_KINDS,
    AggregateExpr,
    Expr,
    column_validity,
)
from denormalized_tpu_torch.obs import statewatch
from denormalized_tpu_torch.ops.interner import (
    RecyclingGroupInterner,
    interner_accounting,
)
from denormalized_tpu_torch.ops.segment_agg import variance_from_m2
from denormalized_tpu_torch.ops.session_table import SessionTable
from denormalized_tpu_torch.physical.base import (
    EOS,
    EndOfStream,
    ExecOperator,
    Marker,
    StreamItem,
    WatermarkHint,
)
from denormalized_tpu_torch.runtime.tracing import logger
from denormalized_tpu_torch.state import tiering
from denormalized_tpu_torch.state.checkpoint import get_json, jsonable
from denormalized_tpu_torch.state.serialization import (
    pack_snapshot,
    unpack_snapshot,
)


def _segmented_cummax(vals: np.ndarray, seg_start: np.ndarray) -> np.ndarray:
    """Inclusive cumulative max of ``vals`` within segments whose first
    elements are flagged by ``seg_start``.  Offset trick: key each value as
    ``seg_id * stride + (v - min)`` so one ``np.maximum.accumulate`` can
    never carry a maximum across a segment boundary (every later segment's
    keys exceed every earlier segment's).  Falls back to a per-segment loop
    in the (practically unreachable) case the keyed range would overflow
    int64."""
    n = len(vals)
    if n == 0:
        return vals.copy()
    seg_id = np.cumsum(seg_start, dtype=np.int64) - 1
    base = int(vals.min())
    r = vals.astype(np.int64) - base
    stride = int(r.max()) + 1
    if int(seg_id[-1] + 1) * stride < 2**62:
        off = seg_id * stride
        return np.maximum.accumulate(off + r) - off + base
    out = np.empty_like(vals)
    bounds = np.nonzero(seg_start)[0]
    for b0, b1 in zip(bounds, np.append(bounds[1:], n)):
        out[b0:b1] = np.maximum.accumulate(vals[b0:b1])
    return out


#: resident sessions a checkpoint encodes at a time (``_snapshot``)
SNAPSHOT_CHUNK = 1024


class _SessionTier:
    """Cold tier of one session operator: evicts the coldest gids' open
    sessions (whole-gid granularity, blocks of up to
    ``tiering.SPILL_BLOCK_SLOTS`` slots) out of the SoA table into the
    LSM, and reloads them when a batch touches their keys, the watermark
    reaches their gap, or the stream ends.

    Invariant: a gid is either fully resident or fully spilled — touch
    reloads BEFORE any merge, so the table never holds a partial view of a
    spilled key.  Spilled gids keep their interner entries (the key → gid
    mapping is the membership filter's index), and the operator's release
    sites filter them out so a spilled gid is never recycled out from
    under its block (reload re-interns key VALUES, so even a restore —
    which rebuilds the gid space — maps blocks back correctly)."""

    __slots__ = (
        "op", "node_id", "ctrl", "cold", "any_spilled", "spilled_bytes",
        "spilled_keys", "_block_of", "_blocks", "_next",
    )

    def __init__(self, op: "SessionWindowExec", node_id: str, ctrl) -> None:
        self.op = op
        self.node_id = node_id
        self.ctrl = ctrl
        self.cold = tiering.ColdTracker()
        self.any_spilled = False
        self.spilled_bytes = 0
        self.spilled_keys = 0
        self._block_of = np.full(1024, -1, dtype=np.int64)
        self._blocks: dict[int, dict] = {}
        self._next = 0
        ctrl.register(node_id, op, self.resident_bytes)

    def resident_bytes(self) -> int:
        """O(1) resident estimate for the per-batch budget check (live
        slots x exact per-slot bytes + the per-object estimates — the
        state_info formula without its live-slot scans)."""
        op = self.op
        T = op._table
        return (
            len(T) * T.per_slot_nbytes()
            + len(T.accs) * statewatch.ACC_EST_BYTES
            + len(op._interner) * statewatch.KEY_EST_BYTES
        )

    def _ensure_maps(self, n: int) -> None:
        self.cold.ensure(n)
        cap = len(self._block_of)
        if n <= cap:
            return
        while cap < n:
            cap *= 2
        new = np.full(cap, -1, dtype=np.int64)
        new[: len(self._block_of)] = self._block_of
        self._block_of = new

    # -- hot path: membership filter + touch stamp -----------------------
    def touch(self, gids: np.ndarray) -> np.ndarray | None:
        """Stamp the batch's gids hot and return the block ids any of
        them live in (None when the cold set is empty: one scatter and one
        attribute check)."""
        self._ensure_maps(self.op._interner.capacity)
        self.cold.touch(gids)
        if not self.any_spilled:
            return None
        b = self._block_of[gids]
        hit = b[b >= 0]
        if len(hit) == 0:
            return None
        return np.unique(hit)

    def touch_and_reload(self, gids: np.ndarray) -> None:
        """Reload every block the batch's gids live in."""
        hits = self.touch(gids)
        if hits is not None:
            for bid in hits.tolist():
                self._reload_block(int(bid))
            self._write_manifest()

    # -- eviction ---------------------------------------------------------
    def maybe_spill(self, protect_gids: np.ndarray) -> None:
        need = self.ctrl.over_budget()
        if need <= 0:
            self.ctrl.relax(self.node_id)
            return
        op = self.op
        T = op._table
        live = T.live_slots()
        spilled_any = False
        if len(live):
            per_slot = max(T.per_slot_nbytes(), 1)
            self._ensure_maps(op._interner.capacity)
            protect = np.zeros(len(self._block_of), dtype=bool)
            protect[protect_gids] = True
            live_gids = T.gid[live].astype(np.int64)
            cand = live_gids[~protect[live_gids]]
            if len(cand):
                u, counts = np.unique(cand, return_counts=True)
                order = np.argsort(self.cold.last_touch[u], kind="stable")
                u = u[order]
                counts = counts[order]
                csum = np.cumsum(counts)
                need_slots = -(-need // per_slot)
                k = int(np.searchsorted(csum, need_slots)) + 1
                k = min(k, len(u))
                chosen, chosen_counts = u[:k], counts[:k]
                # chunk the chosen gids into <= SPILL_BLOCK_SLOTS-slot
                # blocks (spill cadence, never per row)
                start = 0
                acc = 0
                for i in range(len(chosen)):
                    acc += int(chosen_counts[i])
                    if acc >= tiering.SPILL_BLOCK_SLOTS or i == len(chosen) - 1:
                        try:
                            self._spill_chunk(chosen[start : i + 1])
                        except StateError as e:
                            # a failed eviction put leaves the chunk
                            # resident: degrade, never kill the query over
                            # a spill write
                            logger.warning(
                                "spill: session eviction put failed "
                                "(%s) — chunk stays resident", e,
                            )
                            break
                        spilled_any = True
                        start, acc = i + 1, 0
                if spilled_any:
                    self._write_manifest()
                    T.shrink_to_fit()
                    op._state_info_cache = None
                    tiering.release_freed_memory()
        self.ctrl.check_pressure(self.node_id)

    def _spill_chunk(self, gids_chunk: np.ndarray) -> None:
        op = self.op
        T = op._table
        slots, owner = T.open_slots_of(gids_chunk)
        if len(slots) == 0:
            return
        fields = T.extract_slots(slots)
        accs_meta = None
        if op._udafs:
            accs_meta = [
                [acc.state() for acc in T.accs[int(s)]]
                if int(s) in T.accs
                else None
                for s in slots.tolist()
            ]
        keys = op._interner.keys_of(gids_chunk)
        meta = {
            "keys": jsonable([list(c) for c in keys]),
            "accs": jsonable(accs_meta),
            "n": int(len(slots)),
            "min_start": int(fields["start"].min()),
            "min_last": int(fields["last"].min()),
            "max_last": int(fields["last"].max()),
        }
        arrays = dict(fields)
        arrays["owner"] = owner.astype(np.int32)
        bid = self._next
        self._next += 1
        # durable FIRST: the slots leave the table only once the block is
        # in the LSM
        nbytes = self.ctrl.put_block(
            self.node_id, f"b{bid}", pack_snapshot(meta, arrays)
        )
        T.remove_slots(slots)  # freed gids stay interned (spilled)
        self._block_of[gids_chunk] = bid
        self._blocks[bid] = {
            "gids": gids_chunk.copy(),
            "bytes": nbytes,
            "min_start": meta["min_start"],
            "min_last": meta["min_last"],
            "max_last": meta["max_last"],
        }
        self.any_spilled = True
        self.spilled_bytes += nbytes
        self.spilled_keys += int(len(gids_chunk))
        self.ctrl.note_spill(self.node_id, 1, nbytes)

    # -- reload -----------------------------------------------------------
    def _reload_block(self, bid: int) -> None:
        meta = self._blocks.pop(bid)
        raw = self.ctrl.get_block(self.node_id, f"b{bid}")
        chunk_gids = self.op._inject_block(*unpack_snapshot(raw))
        self._ensure_maps(self.op._interner.capacity)
        self._block_of[meta["gids"]] = -1
        self._block_of[chunk_gids] = -1  # restore path: gids re-assigned
        self.any_spilled = bool(self._blocks)
        self.spilled_bytes -= meta["bytes"]
        self.spilled_keys -= int(len(meta["gids"]))
        self.ctrl.note_reload(self.node_id, 1, len(raw))
        self.ctrl.delete_block(self.node_id, f"b{bid}")
        self.op._state_info_cache = None

    def reload_for_watermark(self, watermark: int) -> None:
        """Blocks holding ANY gap-expired session reload so the close sweep
        sees them — emission timing (and so output) stays that of the
        unbudgeted run."""
        if not self.any_spilled:
            return
        gap = self.op.gap_ms
        due = [
            bid for bid, m in self._blocks.items()
            if m["min_last"] + gap <= watermark
        ]
        for bid in due:
            self._reload_block(bid)
        if due:
            self._write_manifest()

    def reload_all(self) -> None:
        for bid in list(self._blocks):
            self._reload_block(bid)
        self._write_manifest()

    def _write_manifest(self) -> None:
        self.ctrl.write_manifest(
            self.node_id, [f"b{b}" for b in self._blocks]
        )

    # -- guards + accounting ---------------------------------------------
    def filter_releasable(self, gids: np.ndarray) -> np.ndarray:
        """Never recycle a gid whose sessions live in the cold tier."""
        if not self.any_spilled or len(gids) == 0:
            return gids
        return gids[self._block_of[gids] < 0]

    def min_start(self) -> int | None:
        if not self._blocks:
            return None
        return min(m["min_start"] for m in self._blocks.values())

    def info(self) -> dict:
        return {
            "spilled_bytes": self.spilled_bytes,
            "spilled_keys": self.spilled_keys,
            "spilled_blocks": len(self._blocks),
            "spill": self.ctrl.spill_stats(self.node_id),
        }

    # -- checkpoint integration -------------------------------------------
    def snapshot_refs(self, coord, key: str, epoch: int) -> list[int]:
        bids = sorted(self._blocks)
        for bid in bids:
            self.ctrl.copy_block_to_epoch(
                coord, key, epoch, self.node_id, f"b{bid}"
            )
        return bids

    def restore_refs(self, coord, key: str, bids: list[int]) -> None:
        """Rebuild the tier map from a committed epoch: each block's
        payload streams back into the spill namespace (one at a time), its
        keys re-intern into the fresh gid space, and the membership maps
        re-arm — the cold tier is never materialized in RAM."""
        op = self.op
        for bid in bids:
            raw = self.ctrl.restore_block_from_epoch(
                coord, key, self.node_id, f"b{bid}"
            )
            bmeta = unpack_snapshot(raw)[0]
            key_cols = tiering.key_columns_from_meta(bmeta["keys"])
            chunk_gids = op._interner.intern(key_cols).astype(np.int64)
            self._ensure_maps(op._interner.capacity)
            op._table.ensure_gids(op._interner.capacity)
            self._block_of[chunk_gids] = bid
            self._blocks[bid] = {
                "gids": chunk_gids,
                "bytes": len(raw),
                "min_start": int(bmeta["min_start"]),
                "min_last": int(bmeta["min_last"]),
                "max_last": int(bmeta["max_last"]),
            }
            self.spilled_bytes += len(raw)
            self.spilled_keys += int(len(chunk_gids))
            self._next = max(self._next, bid + 1)
        self.any_spilled = bool(self._blocks)
        self._write_manifest()


class SessionWindowExec(ExecOperator):
    def __init__(
        self,
        input_op: ExecOperator,
        group_exprs: list[Expr],
        aggr_exprs: list[AggregateExpr],
        gap_ms: int,
        *,
        emit_on_close: bool = True,
        name: str = "session_window",
    ) -> None:
        if not group_exprs:
            raise PlanError("session windows require at least one group key")
        self.input_op = input_op
        self.group_exprs = list(group_exprs)
        self.aggr_exprs = list(aggr_exprs)
        self.gap_ms = int(gap_ms)
        self.emit_on_close = emit_on_close
        self.name = name

        in_schema = input_op.schema
        self._value_exprs: list[Expr] = []
        keys: dict[str, int] = {}

        def value_idx(e: Expr) -> int:
            k = repr(e)
            if k not in keys:
                keys[k] = len(self._value_exprs)
                self._value_exprs.append(e)
            return keys[k]

        # accumulator (UDAF/collection) aggregates ride their own per-
        # session Accumulator instances; their args never enter the float
        # value matrix (they may be strings)
        self._udafs = []  # list of AggregateExpr with kind == "udaf"
        self._agg_specs: list[tuple] = []
        for a in self.aggr_exprs:
            if a.kind == "udaf":
                self._agg_specs.append(("udaf", len(self._udafs)))
                self._udafs.append(a)
                continue
            if a.arg is None:
                self._agg_specs.append((a.kind, None))
                continue
            self._agg_specs.append((a.kind, value_idx(a.arg)))

        fields = [g.out_field(in_schema) for g in self.group_exprs]
        fields += [a.out_field(in_schema) for a in self.aggr_exprs]
        fields += [
            Field(WINDOW_START_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
            Field(WINDOW_END_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
            Field(CANONICAL_TIMESTAMP_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
        ]
        self.schema = Schema(fields)

        self._interner = RecyclingGroupInterner(len(self.group_exprs))
        self._table = SessionTable(len(self._value_exprs))
        self._watermark: int | None = None
        # True once a kind="partition" hint arrived: batch min-ts no
        # longer advances the watermark (replay-skew safety)
        self._src_watermarks = False
        self._ckpt: tuple | None = None
        #: framed bytes of this operator's last checkpoint document
        self.last_snapshot_bytes = 0
        # cold tier (state/tiering.py): installed by enable_spill when a
        # state budget + backend are configured; None = all-resident
        self._tier: _SessionTier | None = None
        self._metrics = {
            "rows_in": 0,
            "sessions_emitted": 0,
            "late_rows": 0,
            "salvage_rows_scanned": 0,
        }
        from denormalized_tpu_torch import obs

        self.bind_obs("session")
        # state observatory: heavy-hitter/cardinality sketches fed dense
        # gids per batch (the falsy null watch with metrics off)
        self._sw = statewatch.make_watch("session")
        self._obs_late = obs.counter("dnz_late_rows_total", op="session")
        self._obs_windows = obs.counter(
            "dnz_windows_emitted_total", op="session"
        )
        self._obs_emit_lag = obs.histogram(
            "dnz_emit_event_lag_ms", op="session"
        )
        self._obs_wm_lag = obs.gauge("dnz_watermark_lag_ms", op="session")
        self._obs_wm_lag_hist = obs.histogram(
            "dnz_watermark_lag_hist_ms", op="session"
        )

    @property
    def children(self):
        return [self.input_op]

    def metrics(self):
        return dict(self._metrics)

    def _label(self):
        return (
            f"SessionWindowExec(gap={self.gap_ms}ms, "
            f"groups=[{', '.join(g.name for g in self.group_exprs)}])"
        )

    def enable_spill(self, node_id: str, controller) -> None:
        self._tier = _SessionTier(self, node_id, controller)

    # -- state observatory (obs/statewatch.py) --------------------------
    def state_info(self) -> dict:
        T = self._table
        live = T.live_slots()
        n_live = int(len(live))
        acc_objs = (
            sum(len(v) for v in T.accs.values()) if T.accs else 0
        )
        keys = interner_accounting(self._interner)
        wm = self._watermark
        oldest = int(T.start[live].min()) if n_live else None
        if self._tier is not None:
            tmin = self._tier.min_start()
            if tmin is not None:
                oldest = tmin if oldest is None else min(oldest, tmin)
        info = {
            "op": "session",
            # live accounting only (restore-invariant by construction):
            # exact numpy storage per live slot + documented per-object
            # estimates for interned keys and accumulator objects
            "state_bytes": (
                n_live * T.per_slot_nbytes()
                + keys["live_keys"] * statewatch.KEY_EST_BYTES
                + acc_objs * statewatch.ACC_EST_BYTES
            ),
            # the portion the cold tier can actually evict: slot storage
            # + accumulators.  The interned-key index stays resident by
            # design (it IS the spill membership filter) — the documented
            # resident floor of a budgeted run (docs/state_spill.md)
            "evictable_bytes": (
                n_live * T.per_slot_nbytes()
                + acc_objs * statewatch.ACC_EST_BYTES
            ),
            "capacity_bytes": T.capacity_nbytes(),
            "slot_capacity": int(len(T.start)),
            "slot_live": n_live,
            "acc_objects": acc_objs,
            "oldest_event_ms": oldest,
            "watermark_ms": wm,
            "retention_unit_ms": self.gap_ms,
            **keys,
        }
        if wm is not None and oldest is not None:
            info["oldest_event_lag_ms"] = max(0, int(wm) - oldest)
        if self._tier is not None:
            info.update(self._tier.info())
        return info

    def _state_watch_views(self):
        if not self._sw:
            return []
        from denormalized_tpu_torch.ops.interner import display_keys

        return [
            (None, self._sw, lambda g: display_keys(self._interner, g))
        ]

    # ------------------------------------------------------------------
    def _make_accs(self) -> list | None:
        if not self._udafs:
            return None
        return [a.udaf.make() for a in self._udafs]

    # -- late-row salvage (the ONLY per-row path; scoped to keys with a
    # -- candidate open interval) --------------------------------------
    def _salvage_late(
        self, ts: np.ndarray, gids: np.ndarray, late: np.ndarray
    ) -> np.ndarray:
        """Decide per-row, in ARRIVAL order, which late rows merge into a
        still-open (or this-batch-created) session of their key — exactly
        as row-at-a-time processing would (Flink event-time session
        semantics: a late row within gap of an open session belongs to it;
        only true closed singletons drop).  Returns the updated ``late``
        mask.  Only rows whose key has at least one late row this batch
        walk the loop; all other rows never leave the vectorized path."""
        gap_ms = self.gap_ms
        T = self._table
        aff_gids = np.unique(gids[late])
        # interval views of the affected keys' open sessions
        views: dict[int, list[list[int]]] = {int(g): [] for g in aff_gids}
        slots, owner = T.open_slots_of(aff_gids)
        starts = T.start[slots]
        lasts = T.last[slots]
        for i, pos in enumerate(owner.tolist()):
            views[int(aff_gids[pos])].append([int(starts[i]), int(lasts[i])])
        aff_mask = np.zeros(self._interner.capacity, dtype=bool)
        aff_mask[aff_gids] = True
        rows = np.nonzero(aff_mask[gids])[0]
        self._metrics["salvage_rows_scanned"] += len(rows)
        late = late.copy()
        for i in rows.tolist():
            iv_list = views[int(gids[i])]
            t = int(ts[i])
            hit = [
                iv
                for iv in iv_list
                if t - iv[1] <= gap_ms and iv[0] - t <= gap_ms
            ]
            if late[i]:
                if not hit:
                    continue  # true closed singleton: stays dropped
                late[i] = False
            merged = [
                min([t] + [iv[0] for iv in hit]),
                max([t] + [iv[1] for iv in hit]),
            ]
            views[int(gids[i])] = [
                iv for iv in iv_list if iv not in hit
            ] + [merged]
        return late

    # -- vectorized batch path ------------------------------------------
    def _process_batch(self, batch: RecordBatch) -> Iterator[RecordBatch]:
        n = batch.num_rows
        if n == 0:
            return
        self._metrics["rows_in"] += n
        self._obs_rows_in.add(n)
        ts = np.asarray(batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64)
        key_cols = [g.eval(batch) for g in self.group_exprs]
        gids = self._interner.intern(key_cols)
        self._sw.update(gids)
        if self._tier is not None:
            # membership pre-probe + reload-on-touch: any spilled gid of
            # this batch comes back resident BEFORE merging
            self._tier.touch_and_reload(gids)
        self._table.ensure_gids(self._interner.capacity)
        vals = (
            np.stack(
                [np.asarray(e.eval(batch), dtype=np.float64) for e in self._value_exprs],
                axis=1,
            )
            if self._value_exprs
            else np.zeros((n, 0))
        )
        valid = np.ones_like(vals, dtype=bool)
        for ci, e in enumerate(self._value_exprs):
            m = column_validity(e, batch)
            if m is not None:
                valid[:, ci] = m

        # accumulator-aggregate argument columns (raw dtypes) + masks
        udaf_cols: list[list[np.ndarray]] = []
        udaf_masks: list[np.ndarray | None] = []
        for a in self._udafs:
            udaf_cols.append([np.asarray(e.eval(batch)) for e in a.udaf.args])
            udaf_masks.append(
                column_validity(a.udaf.args[0], batch) if a.udaf.args else None
            )
        # watermark advances from the RAW batch min (late rows included —
        # they only keep the min lower, and the reference's
        # RecordBatchWatermark is computed over the whole batch); computing
        # it after the late-filter would let a dropped row inflate the
        # watermark and mis-drop later on-time rows
        raw_min = int(ts.min())

        dropped_gids: np.ndarray | None = None
        if self._watermark is not None:
            late = ts + self.gap_ms <= self._watermark
            if late.any():
                late = self._salvage_late(ts, gids, late)
            n_late = int(late.sum())
            if n_late:
                self._metrics["late_rows"] += n_late
                self._obs_late.add(n_late)
                dropped_gids = np.unique(gids[late])
                keep = ~late
                ts = ts[keep]
                gids = gids[keep]
                vals = vals[keep]
                valid = valid[keep]
                udaf_cols = [[c[keep] for c in cols] for cols in udaf_cols]
                udaf_masks = [
                    m[keep] if m is not None else None for m in udaf_masks
                ]
                n = len(ts)

        if n:
            # vectorized per-key segmenting: sort by (gid, ts), then one
            # reduceat per aggregate primitive over key-run + intra-batch
            # gap boundaries
            order = np.lexsort((ts, gids))
            ts_s = ts[order]
            g_s = gids[order]
            vals_s = vals[order]
            valid_s = valid[order]
            boundary = np.empty(n, dtype=bool)
            boundary[0] = True
            boundary[1:] = (g_s[1:] != g_s[:-1]) | (
                (ts_s[1:] - ts_s[:-1]) > self.gap_ms
            )
            bounds = np.nonzero(boundary)[0]
            lens = np.diff(np.append(bounds, n))
            seg_gid = g_s[bounds].astype(np.int64)
            seg_first = ts_s[bounds]
            seg_last = ts_s[np.append(bounds[1:], n) - 1]
            seg_rows = lens.astype(np.int64)
            # null-neutralize per aggregate kind (same semantics as the
            # device kernel: nulls excluded from count/sum/min/max)
            seg_counts = np.add.reduceat(
                valid_s.astype(np.int64), bounds, axis=0
            )
            seg_sums = np.add.reduceat(
                np.where(valid_s, vals_s, 0.0), bounds, axis=0
            )
            seg_mins = np.minimum.reduceat(
                np.where(valid_s, vals_s, np.inf), bounds, axis=0
            )
            seg_maxs = np.maximum.reduceat(
                np.where(valid_s, vals_s, -np.inf), bounds, axis=0
            )
            with np.errstate(invalid="ignore", divide="ignore"):
                seg_means = np.where(
                    seg_counts > 0,
                    seg_sums / np.maximum(seg_counts, 1),
                    0.0,
                )
            centered = vals_s - np.repeat(seg_means, lens, axis=0)
            seg_m2s = np.add.reduceat(
                np.where(valid_s, centered * centered, 0.0), bounds, axis=0
            )
            seg_accs = None
            if self._udafs:
                # accumulator-per-segment contract: user code runs once per
                # (key, segment) — inherently Python, and only here
                seg_accs = []
                for b0, b1 in zip(bounds.tolist(), np.append(bounds[1:], n).tolist()):
                    accs = self._make_accs()
                    seg_idx = order[b0:b1]
                    for acc, cols, am in zip(accs, udaf_cols, udaf_masks):
                        chunk = [c[seg_idx] for c in cols]
                        if am is not None:
                            ok = am[seg_idx]
                            chunk = [c[ok] for c in chunk]
                        acc.update(*chunk)
                    seg_accs.append(accs)
            self._merge_segments(
                seg_gid, seg_first, seg_last, seg_rows, seg_counts,
                seg_sums, seg_mins, seg_maxs, seg_means, seg_m2s, seg_accs,
            )

        # watermark advance + close expired sessions — skipped under
        # per-partition watermarks: the authoritative advance arrives as
        # a kind="partition" hint right after this batch
        if not self._src_watermarks:
            yield from self._advance_and_close(raw_min)
        if dropped_gids is not None:
            # a key whose only-ever rows were dropped-late holds no state:
            # recycle its gid immediately instead of leaking it
            idle = dropped_gids[self._table.head[dropped_gids] == -1]
            if self._tier is not None:
                idle = self._tier.filter_releasable(idle)
            if len(idle):
                self._interner.release(idle)
        if self._tier is not None:
            self._tier.maybe_spill(gids)

    def _merge_segments(
        self,
        seg_gid: np.ndarray,
        seg_first: np.ndarray,
        seg_last: np.ndarray,
        seg_rows: np.ndarray,
        seg_counts: np.ndarray,
        seg_sums: np.ndarray,
        seg_mins: np.ndarray,
        seg_maxs: np.ndarray,
        seg_means: np.ndarray,
        seg_m2s: np.ndarray,
        seg_accs: list | None,
    ) -> None:
        """One combined interval-merge sweep: union the touched gids' open
        sessions with the batch segments, sort by (gid, start), split into
        merged runs where ``start − running_max(last) > gap`` (sessions
        stay open until the watermark passes ``last + gap`` — closing on
        gap-at-arrival would mis-split out-of-order data, so a segment may
        bridge several open sessions), fold every run with reduceat, and
        scatter the merged sessions back into the SoA table."""
        T = self._table
        S = len(seg_gid)
        touched = np.unique(seg_gid)
        ex_slots, ex_owner = T.open_slots_of(touched)
        E = len(ex_slots)
        M = E + S
        cg = np.concatenate([touched[ex_owner], seg_gid])
        cstart = np.concatenate([T.start[ex_slots], seg_first])
        clast = np.concatenate([T.last[ex_slots], seg_last])
        cnew = np.zeros(M, dtype=bool)
        cnew[E:] = True
        # tie-break (cnew last): at equal start the EXISTING session sorts
        # first — order-sensitive accumulator folds keep arrival order
        order = np.lexsort((cnew, cstart, cg))
        g2 = cg[order]
        st2 = cstart[order]
        la2 = clast[order]
        newg = np.empty(M, dtype=bool)
        newg[0] = True
        newg[1:] = g2[1:] != g2[:-1]
        runmax = _segmented_cummax(la2, newg)
        boundary = newg.copy()
        boundary[1:] |= (st2[1:] - runmax[:-1]) > self.gap_ms
        rb = np.nonzero(boundary)[0]
        runlens = np.diff(np.append(rb, M))
        crow = np.concatenate([T.row_count[ex_slots], seg_rows])[order]
        ccnt = np.concatenate([T.counts[ex_slots], seg_counts], axis=0)[order]
        csum = np.concatenate([T.sums[ex_slots], seg_sums], axis=0)[order]
        cmin = np.concatenate([T.mins[ex_slots], seg_mins], axis=0)[order]
        cmax = np.concatenate([T.maxs[ex_slots], seg_maxs], axis=0)[order]
        cmean = np.concatenate([T.means[ex_slots], seg_means], axis=0)[order]
        cm2 = np.concatenate([T.m2s[ex_slots], seg_m2s], axis=0)[order]
        out_gid = g2[rb]
        out_start = st2[rb]
        out_last = np.maximum.reduceat(la2, rb)
        out_row = np.add.reduceat(crow, rb)
        out_cnt = np.add.reduceat(ccnt, rb, axis=0)
        out_sum = np.add.reduceat(csum, rb, axis=0)
        out_min = np.minimum.reduceat(cmin, rb, axis=0)
        out_max = np.maximum.reduceat(cmax, rb, axis=0)
        # k-way Chan moment combine (exact algebra of chan_merge):
        # M2 = Σ m2_i + Σ n_i (μ_i − μ)²  with  μ = Σ n_i μ_i / Σ n_i
        cntf = ccnt.astype(np.float64)
        wmean = np.add.reduceat(cntf * cmean, rb, axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            out_mean = np.where(
                out_cnt > 0, wmean / np.maximum(out_cnt, 1), 0.0
            )
        centered = cmean - np.repeat(out_mean, runlens, axis=0)
        out_m2 = np.add.reduceat(cm2 + cntf * centered * centered, rb, axis=0)
        single = runlens == 1
        if single.any():
            # identity folds must not re-round a stored moment pair
            out_mean[single] = cmean[rb[single]]
            out_m2[single] = cm2[rb[single]]
        new_accs = None
        if self._udafs:
            # per-RUN accumulator fold (runs only; Python is unavoidable —
            # accumulator state is opaque user code).  Order-sensitive
            # accumulators (first/last_value, array_agg) must see EXACTLY
            # the fold order of sequential processing, including the quirk
            # that a mid-batch merge can lower a session's start and change
            # which member is the next merge's base — so replay the
            # reference algorithm per run: for each new segment in ts
            # order, merge its within-gap hits base-oldest-first, then the
            # segment's own partial last.
            cref = np.concatenate(
                [ex_slots, -np.arange(1, S + 1, dtype=np.int64)]
            )[order]
            cnew2 = cnew[order]
            new_accs = []
            for b0, b1 in zip(rb.tolist(), np.append(rb[1:], M).tolist()):
                refs = cref[b0:b1]
                news = cnew2[b0:b1]
                # live mini-set of [start, last, accs] for this run;
                # existing sessions seed it (they are pairwise >gap apart)
                sess = [
                    [int(st2[b0 + i]), int(la2[b0 + i]),
                     T.accs.pop(int(refs[i]))]
                    for i in range(b1 - b0)
                    if not news[i]
                ]
                for i in range(b1 - b0):
                    if not news[i]:
                        continue
                    first = int(st2[b0 + i])
                    last = int(la2[b0 + i])
                    part = seg_accs[-int(refs[i]) - 1]
                    hits = [
                        s for s in sess
                        if first - s[1] <= self.gap_ms
                        and s[0] - last <= self.gap_ms
                    ]
                    if not hits:
                        sess.append([first, last, part])
                        continue
                    hits.sort(key=lambda s: s[0])
                    base = hits[0]
                    for s in hits[1:]:
                        for acc, other in zip(base[2], s[2]):
                            acc.merge(other.state())
                    for acc, p in zip(base[2], part):
                        acc.merge(p.state())
                    base[0] = min(base[0], first)
                    base[1] = max([last] + [s[1] for s in hits])
                    sess = [s for s in sess if s not in hits[1:]]
                # the run IS one merged session (transitive closure), so
                # exactly one survivor remains; fold defensively if not
                accs = sess[0][2]
                for s in sess[1:]:  # pragma: no cover — unreachable
                    for acc, other in zip(accs, s[2]):
                        acc.merge(other.state())
                new_accs.append(accs)
        # scatter back: every touched gid's open set is rewritten wholesale
        T.free(ex_slots)
        T.head[touched] = -1
        slots = T.alloc(len(rb))
        T.start[slots] = out_start
        T.last[slots] = out_last
        T.row_count[slots] = out_row
        T.counts[slots] = out_cnt
        T.sums[slots] = out_sum
        T.mins[slots] = out_min
        T.maxs[slots] = out_max
        T.means[slots] = out_mean
        T.m2s[slots] = out_m2
        T.gid[slots] = out_gid
        T.live[slots] = True
        T.chain(out_gid, slots)
        if new_accs is not None:
            for s, a in zip(slots.tolist(), new_accs):
                T.accs[int(s)] = a

    # -- close + emit ----------------------------------------------------
    def _advance_and_close(self, candidate_wm: int) -> Iterator[RecordBatch]:
        """Monotonic watermark advance, then emit every session whose gap
        has expired — shared by the per-batch path and idle-source
        WatermarkHint handling.  One vectorized scan of the live slots."""
        if self._watermark is None or candidate_wm > self._watermark:
            self._watermark = candidate_wm
        if self._obs_wm_lag:
            lag = time.time() * 1000.0 - self._watermark
            self._obs_wm_lag.set(lag)
            self._obs_wm_lag_hist.observe(lag)
        if self._tier is not None:
            # gap-expired cold blocks come back resident so this sweep
            # closes them on the watermark the all-resident run does
            self._tier.reload_for_watermark(self._watermark)
        expired = self._table.expired_slots(self.gap_ms, self._watermark)
        if len(expired) == 0:
            return
        order = np.lexsort(
            (self._table.gid[expired], self._table.start[expired])
        )
        expired = expired[order]
        out = self._emit_slots(expired)
        freed = self._table.remove_slots(expired)
        if self._tier is not None:
            freed = self._tier.filter_releasable(freed)
        if len(freed):
            # closed keys' dense ids go back to the interner free list
            self._interner.release(freed)
        yield out

    def _emit_slots(self, slots: np.ndarray) -> RecordBatch:
        T = self._table
        m = len(slots)
        self._metrics["sessions_emitted"] += m
        self._obs_windows.add(m)
        if self._obs_emit_lag:
            # one sample per emission sweep, at the OLDEST session's end
            # (start-of-last-row + gap): the conservative bound
            self._obs_emit_lag.observe(
                time.time() * 1000.0
                - (float(T.last[slots].min()) + self.gap_ms)
            )
        if self._dr_lineage is not None:
            # a sampled row belongs to the session whose [start, last +
            # gap) interval holds its event time
            self._dr_lineage.emitted(
                self._dr_node_id,
                np.asarray(T.start[slots], dtype=np.int64),
                np.asarray(T.last[slots], dtype=np.int64) + self.gap_ms,
            )
        in_schema = self.input_op.schema
        key_vals = self._interner.keys_of(T.gid[slots])
        cols: list[np.ndarray] = []
        for ci, g in enumerate(self.group_exprs):
            f = g.out_field(in_schema)
            vals = np.asarray(key_vals[ci], dtype=object)
            if f.dtype.is_numeric:
                vals = vals.astype(f.dtype.to_numpy())
            cols.append(vals)
        with np.errstate(invalid="ignore", divide="ignore"):
            for ai, spec in enumerate(self._agg_specs):
                kind, col_i = spec[0], spec[1]
                if kind == "udaf":
                    vals_out = [
                        T.accs[int(s)][col_i].evaluate() for s in slots.tolist()
                    ]
                    arr = np.empty(m, dtype=object)
                    for vi, v in enumerate(vals_out):
                        arr[vi] = v
                    f = self.aggr_exprs[ai].out_field(in_schema)
                    if f.dtype.is_numeric:
                        arr = arr.astype(f.dtype.to_numpy())
                    cols.append(arr)
                elif kind in VAR_KINDS:
                    cols.append(
                        variance_from_m2(
                            kind, T.counts[slots, col_i], T.m2s[slots, col_i]
                        )
                    )
                elif kind == "count":
                    cols.append(
                        (
                            T.row_count[slots]
                            if col_i is None
                            else T.counts[slots, col_i]
                        ).astype(np.int64)
                    )
                elif kind == "sum":
                    cols.append(T.sums[slots, col_i].copy())
                elif kind == "avg":
                    c = T.counts[slots, col_i]
                    cols.append(
                        np.where(
                            c > 0,
                            T.sums[slots, col_i] / np.maximum(c, 1),
                            np.nan,
                        )
                    )
                elif kind == "min":
                    v = T.mins[slots, col_i]
                    cols.append(np.where(np.isposinf(v), np.nan, v))
                elif kind == "max":
                    v = T.maxs[slots, col_i]
                    cols.append(np.where(np.isneginf(v), np.nan, v))
                else:
                    raise PlanError(f"session window does not support {kind}")
        starts = T.start[slots].astype(np.int64)
        ends = (T.last[slots] + self.gap_ms).astype(np.int64)
        # cast agg outputs to declared dtypes
        out_cols = []
        for f, c in zip(self.schema.fields[: len(cols)], cols):
            out_cols.append(
                c if c.dtype == object else c.astype(f.dtype.to_numpy())
            )
        out_cols += [starts, ends, starts.copy()]
        return RecordBatch(self.schema, out_cols)

    # -- checkpointing (SoA store → the dict-era JSON blob, unchanged
    # -- format: snapshots interoperate with the reference operator) ------
    def enable_checkpointing(self, node_id: str, coord, orch) -> None:
        self._ckpt = (coord, f"session_{node_id}")
        snap = get_json(coord, self._ckpt[1])
        if snap is None:
            return
        self._watermark = snap["watermark"]
        self._restore_sessions(snap["sessions"])
        bids = snap.get("spill_blocks") or []
        if bids:
            if self._tier is not None:
                # rebuild the tier map (blocks stream epoch → spill
                # namespace one at a time; cold state stays cold)
                self._tier.restore_refs(coord, self._ckpt[1], bids)
            else:
                # budget removed since the checkpoint: load the cold tier
                # back resident
                self._restore_spilled_resident(coord, self._ckpt[1], bids)

    def _restore_spilled_resident(self, coord, key: str, bids: list) -> None:
        for bid in bids:
            raw = coord.get_snapshot(f"{key}:spill:b{bid}")
            if raw is None:
                raise StateError(
                    f"checkpoint references spilled session block b{bid} "
                    "but the epoch holds no such snapshot"
                )
            self._inject_block(*unpack_snapshot(raw))

    def _inject_block(self, bmeta: dict, arrays: dict) -> np.ndarray:
        """Re-admit one spilled block's sessions: re-intern its key values
        (the gid space may have been rebuilt, or a gid recycled, since),
        inject its slots and re-merge its accumulator states → the block's
        gids in this run."""
        key_cols = tiering.key_columns_from_meta(bmeta["keys"])
        chunk_gids = self._interner.intern(key_cols).astype(np.int64)
        T = self._table
        T.ensure_gids(self._interner.capacity)
        slots = T.inject_slots(
            chunk_gids[arrays["owner"]],
            {k: arrays[k] for k in T.SPILL_FIELDS},
        )
        if bmeta.get("accs"):
            for s, states in zip(slots.tolist(), bmeta["accs"]):
                if states is None:
                    continue
                accs = self._make_accs()
                for acc, st in zip(accs, states):
                    acc.merge(st)
                T.accs[int(s)] = accs
        return chunk_gids

    def _restore_sessions(self, entries: list) -> None:
        self._interner = RecyclingGroupInterner(len(self.group_exprs))
        self._table = SessionTable(len(self._value_exprs))
        # sketches do NOT ride the snapshot: the gid space is reassigned
        # here, so they restart and re-warm from live traffic (accuracy
        # note in docs/observability.md); exact accounting is recomputed
        # from the restored table and matches pre-kill immediately
        self._sw.reset_sketches()
        if not entries:
            return
        key_cols = []
        for c in range(len(self.group_exprs)):
            lst = [e[0][c] for e in entries]
            arr = np.asarray(lst)
            if arr.dtype.kind not in "ifbM":
                # strings (or mixed objects): rebuild from the ORIGINAL
                # values — np.asarray may have stringified them
                arr = np.empty(len(lst), dtype=object)
                arr[:] = lst
            key_cols.append(arr)
        gids = self._interner.intern(key_cols)
        T = self._table
        T.ensure_gids(self._interner.capacity)
        slots = T.alloc(len(entries))
        V = len(self._value_exprs)
        for i, entry in enumerate(entries):
            slot = int(slots[i])
            key_list, start, last, agg = entry[:4]
            acc_states = entry[4] if len(entry) > 4 else None
            T.start[slot] = start
            T.last[slot] = last
            T.row_count[slot] = agg["count"]
            T.counts[slot] = agg["counts"]
            T.sums[slot] = agg["sums"]
            T.mins[slot] = agg["mins"]
            T.maxs[slot] = agg["maxs"]
            T.means[slot] = agg.get("means", [0.0] * V)
            T.m2s[slot] = agg.get("m2s", [0.0] * V)
            T.gid[slot] = gids[i]
            T.live[slot] = True
            accs = self._make_accs()
            if accs is not None:
                if acc_states is not None:
                    for acc, st in zip(accs, acc_states):
                        acc.merge(st)
                T.accs[slot] = accs
        T.chain(gids.astype(np.int64), slots)

    def _snapshot_entries(self, slots: np.ndarray) -> list:
        """The checkpoint document's ``sessions`` entries of ``slots``:
        ``[key values, start, last, aggregates, accumulator states]``."""
        T = self._table
        key_cols = self._interner.keys_of(T.gid[slots])
        keys = (zip(*(c.tolist() for c in key_cols)) if key_cols
                else itertools.repeat(()))
        cols = zip(
            T.start[slots].tolist(), T.last[slots].tolist(),
            T.row_count[slots].tolist(), T.counts[slots].tolist(),
            T.sums[slots].tolist(), T.mins[slots].tolist(),
            T.maxs[slots].tolist(), T.means[slots].tolist(),
            T.m2s[slots].tolist(), slots.tolist(),
        )
        return [
            [list(key), start, last,
             {"count": count, "counts": counts, "sums": sums, "mins": mins,
              "maxs": maxs, "means": means, "m2s": m2s},
             [acc.state() for acc in T.accs[s]] if s in T.accs else None]
            for key, (start, last, count, counts, sums, mins, maxs, means,
                      m2s, s) in zip(keys, cols)
        ]

    def _snapshot(self, epoch: int) -> None:
        """One JSON document: the epoch, the watermark, every resident
        session (ordered by start, then gid) and the spilled blocks' ids.
        The sessions are encoded ``SNAPSHOT_CHUNK`` at a time, so the
        Python objects alive at once are one chunk's, not ~2.5 KB for
        every resident session; the bytes are ``json.dumps`` of the whole
        document's."""
        coord, key = self._ckpt
        T = self._table
        live = T.live_slots()
        live = live[np.lexsort((T.gid[live], T.start[live]))]
        head = json.dumps(
            jsonable({"epoch": epoch, "watermark": self._watermark}))
        parts = [head[:-1].encode(), b', "sessions": [']
        for lo in range(0, len(live), SNAPSHOT_CHUNK):
            chunk = json.dumps(jsonable(
                self._snapshot_entries(live[lo:lo + SNAPSHOT_CHUNK])))
            parts += [b", "] * (lo > 0) + [chunk[1:-1].encode()]
        parts.append(b"]")
        if self._tier is not None and self._tier.any_spilled:
            # spilled + resident state commit under ONE epoch: block
            # payloads re-put (CRC-framed, manifest-listed) under
            # epoch-suffixed keys, referenced here by id
            refs = self._tier.snapshot_refs(coord, key, epoch)
            parts.append(
                b', "spill_blocks": ' + json.dumps(jsonable(refs)).encode())
        parts.append(b"}")
        self.last_snapshot_bytes = coord.put_snapshot(key, epoch, parts)
        del parts  # freed before the tier hands the pages back
        if self._tier is not None:
            tiering.release_freed_memory()

    def run(self) -> Iterator[StreamItem]:
        for item in self._doctor_input():
            if isinstance(item, RecordBatch):
                # materialized inside the busy bracket: the histogram
                # measures this operator's work, not downstream's
                t0 = time.perf_counter()
                out = list(self._process_batch(item))
                self._note_batch(t0, item.num_rows)
                yield from out
            elif isinstance(item, WatermarkHint):
                if item.kind == "partition":
                    self._src_watermarks = True
                    if item.is_announcement:
                        yield item  # pure mode announcement
                        continue
                yield from self._advance_and_close(item.ts_ms)
                # emissions stamp canonical ts with the session START:
                # forward clamped below every still-open session's start
                # AND below watermark - gap — the lateness rule accepts
                # out-of-order rows down to watermark - gap + 1, and such
                # a row can START (or merge a session down to) exactly
                # there, so that is the true output low bound
                live = self._table.live_slots()
                floor = (
                    self._watermark - self.gap_ms
                    if self._watermark is not None
                    else item.ts_ms
                )
                lows = [item.ts_ms, floor]
                if len(live):
                    lows.append(int(self._table.start[live].min()) - 1)
                if self._tier is not None:
                    tmin = self._tier.min_start()
                    if tmin is not None:
                        # spilled sessions are still open sessions: the
                        # forward promise stays below their starts too
                        lows.append(tmin - 1)
                yield WatermarkHint(min(lows), kind=item.kind)
            elif isinstance(item, Marker):
                if self._ckpt is not None:
                    self._snapshot(item.epoch)
                yield item
            elif isinstance(item, EndOfStream):
                if self._tier is not None:
                    # the final flush emits EVERY open session, cold ones
                    # included
                    self._tier.reload_all()
                live = self._table.live_slots()
                if self.emit_on_close and len(live):
                    order = np.lexsort(
                        (self._table.gid[live], self._table.start[live])
                    )
                    yield self._emit_slots(live[order])
                yield EOS
                return
