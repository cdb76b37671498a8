"""Reference (pre-vectorization) session operator — the differential oracle.

This is the row/segment-at-a-time implementation the vectorized
``SessionWindowExec`` replaced: per-row ``hash(tuple)`` composite keys, one
Python iteration + ``_Agg`` of Python lists per (key, segment), and open
sessions as a dict of Python objects.  It is kept VERBATIM (class renamed)
for two jobs:

- the differential oracle for ``tests/test_session_vectorized.py`` and the
  ``session_scale`` bench phase's before/after comparison;
- an escape hatch: ``DENORMALIZED_SESSION_REFERENCE=1`` makes the planner
  build this operator instead of the vectorized one.

Known defect (by design left in place — it is what the rewrite fixes): the
salted 64-bit ``hash(tuple)`` composite can collide and silently merge
segments of two distinct keys; the interner's dense ids cannot.

Counterpart of ``denormalized_tpu/physical/session_reference.py``, with
its observability hooks (``op="session_ref"``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from denormalized_tpu_torch.common.constants import (
    CANONICAL_TIMESTAMP_COLUMN,
    WINDOW_END_COLUMN,
    WINDOW_START_COLUMN,
)
from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.logical.expr import (
    VAR_KINDS,
    AggregateExpr,
    Expr,
    column_validity,
)
from denormalized_tpu_torch.obs import statewatch
from denormalized_tpu_torch.ops.segment_agg import chan_merge, variance_from_m2
from denormalized_tpu_torch.physical.base import (
    EOS,
    EndOfStream,
    ExecOperator,
    Marker,
    StreamItem,
    WatermarkHint,
)
from denormalized_tpu_torch.state.checkpoint import get_json, put_json


@dataclass
class _Agg:
    """Mergeable running aggregate for one session.  Variance uses
    Welford/Chan moments (means/m2s) — numerically stable at any value
    magnitude, merged exactly by ``segment_agg.chan_merge``."""

    count: int = 0
    counts: list[int] = field(default_factory=list)  # per value col
    sums: list[float] = field(default_factory=list)
    mins: list[float] = field(default_factory=list)
    maxs: list[float] = field(default_factory=list)
    means: list[float] = field(default_factory=list)
    m2s: list[float] = field(default_factory=list)


@dataclass
class _Session:
    start: int
    last: int
    agg: _Agg
    # one Accumulator per UDAF/collection aggregate (None when none exist)
    accs: list | None = None


class ReferenceSessionWindowExec(ExecOperator):
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

        # per key: open sessions sorted by start (usually exactly one)
        self._sessions: dict[tuple, list[_Session]] = {}
        self._watermark: int | None = None
        # True once a kind="partition" hint arrived: batch min-ts no
        # longer advances the watermark (replay-skew safety)
        self._src_watermarks = False
        self._ckpt: tuple | None = None
        self._metrics = {"rows_in": 0, "sessions_emitted": 0, "late_rows": 0}
        from denormalized_tpu_torch import obs

        self.bind_obs("session_ref")
        # state observatory: the oracle operator has no interner, so it
        # assigns its own sequential key ids for the sketches (per-row
        # Python is this operator's nature — it is the slow reference)
        self._sw = statewatch.make_watch("session_ref")
        self._sw_ids: dict = {}
        self._sw_keys: list = []
        self._obs_late = obs.counter("dnz_late_rows_total", op="session_ref")
        self._obs_windows = obs.counter(
            "dnz_windows_emitted_total", op="session_ref"
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

    def _sw_intern_rows(self, key_cols, n: int) -> np.ndarray:
        """Sequential key ids for the sketches (the oracle has no dense
        interner; ids never recycle, so attribution is alias-free).
        When keys-ever-seen dwarfs the live key population the map is
        dropped and the sketches re-warm — the same bounded-memory
        policy the join/udaf re-intern applies; without it a churning
        differential soak would grow this display-only map forever."""
        if len(self._sw_ids) > 4 * max(len(self._sessions), 1024):
            self._sw.reset_sketches()
            self._sw_ids = {}
            self._sw_keys = []
        ids = np.empty(n, dtype=np.int64)
        d = self._sw_ids
        keys_list = self._sw_keys
        for i in range(n):
            k = tuple(kc[i] for kc in key_cols)
            j = d.get(k)
            if j is None:
                j = len(keys_list)
                d[k] = j
                keys_list.append(k)
            ids[i] = j
        return ids

    def state_info(self) -> dict:
        sessions = self._sessions
        n_sessions = 0
        acc_objs = 0
        oldest = None
        for lst in list(sessions.values()):
            n_sessions += len(lst)
            for s in lst:
                if s.accs:
                    acc_objs += len(s.accs)
                if oldest is None or s.start < oldest:
                    oldest = s.start
        live_keys = len(sessions)
        V = len(self._value_exprs)
        # one _Session: interval + 6 per-column aggregate lists (the
        # dict-era layout this operator preserves verbatim)
        per_session = 96 + V * 6 * 8
        wm = self._watermark
        info = {
            "op": "session_ref",
            "state_bytes": (
                n_sessions * per_session
                + live_keys * statewatch.KEY_EST_BYTES
                + acc_objs * statewatch.ACC_EST_BYTES
            ),
            "live_keys": live_keys,
            "key_capacity": live_keys,
            "free_gids": 0,
            "slot_capacity": n_sessions,
            "slot_live": n_sessions,
            "acc_objects": acc_objs,
            "oldest_event_ms": oldest,
            "watermark_ms": wm,
            "retention_unit_ms": self.gap_ms,
        }
        if wm is not None and oldest is not None:
            info["oldest_event_lag_ms"] = max(0, int(wm) - int(oldest))
        return info

    def _state_watch_views(self):
        if not self._sw:
            return []

        def resolve(gids):
            from denormalized_tpu_torch.ops.interner import format_key_tuple

            keys_list = self._sw_keys
            return [
                format_key_tuple(keys_list[g])
                if 0 <= g < len(keys_list) else None
                for g in np.asarray(gids).tolist()
            ]

        return [(None, self._sw, resolve)]

    # ------------------------------------------------------------------
    def _make_accs(self) -> list | None:
        if not self._udafs:
            return None
        return [a.udaf.make() for a in self._udafs]

    # ------------------------------------------------------------------
    @staticmethod
    def _merge_agg(a: _Agg, p: _Agg) -> None:
        a.count += p.count
        for i in range(len(a.sums)):
            _, a.means[i], a.m2s[i] = chan_merge(
                a.counts[i], a.means[i], a.m2s[i],
                p.counts[i], p.means[i], p.m2s[i],
            )
            a.counts[i] += p.counts[i]
            a.sums[i] += p.sums[i]
            a.mins[i] = min(a.mins[i], p.mins[i])
            a.maxs[i] = max(a.maxs[i], p.maxs[i])

    def _merge_rows(
        self,
        key: tuple,
        ts_sorted: np.ndarray,
        partial: _Agg,
        partial_accs: list | None = None,
    ):
        """Merge one batch segment [first, last] into the per-key OPEN
        session set.  Sessions stay open until the watermark passes
        ``last + gap`` — closing on gap-at-arrival would mis-split
        out-of-order data, so a segment may bridge (merge) several open
        sessions (standard event-time session-merge)."""
        first, last = int(ts_sorted[0]), int(ts_sorted[-1])
        open_list = self._sessions.setdefault(key, [])
        keep: list[_Session] = []
        hits: list[_Session] = []
        for s in open_list:
            # within-gap overlap in either direction → merge
            if first - s.last <= self.gap_ms and s.start - last <= self.gap_ms:
                hits.append(s)
            else:
                keep.append(s)
        if not hits:
            keep.append(_Session(first, last, partial, partial_accs))
        else:
            # the OLDEST session is the merge base and the new partial folds
            # in LAST: order-sensitive accumulators (first/last_value,
            # array_agg) keep arrival order, and the per-batch merge copies
            # only the new partial's state — not the session's accumulated
            # state — so long sessions stay O(rows), not quadratic
            hits.sort(key=lambda s: s.start)
            base = hits[0]
            for s in hits[1:]:
                self._merge_agg(base.agg, s.agg)
                if base.accs is not None:
                    for acc, other in zip(base.accs, s.accs):
                        acc.merge(other.state())
            self._merge_agg(base.agg, partial)
            if base.accs is not None and partial_accs is not None:
                for acc, p in zip(base.accs, partial_accs):
                    acc.merge(p.state())
            base.start = min(base.start, first)
            base.last = max(base.last, last, *(s.last for s in hits[1:]))
            keep.append(base)
        keep.sort(key=lambda s: s.start)
        self._sessions[key] = keep

    def _process_batch(self, batch: RecordBatch) -> Iterator[RecordBatch]:
        n = batch.num_rows
        if n == 0:
            return
        self._metrics["rows_in"] += n
        self._obs_rows_in.add(n)
        ts = np.asarray(batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64)
        key_cols = [np.asarray(g.eval(batch), dtype=object) for g in self.group_exprs]
        if self._sw:
            self._sw.update(self._sw_intern_rows(key_cols, n))
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

        # late rows: a row with ts+gap <= watermark would close as a
        # singleton — but if it lies within gap of a STILL-OPEN session for
        # its key it belongs to that session (Flink event-time session
        # semantics: the merged session closes later).  So salvage
        # open-session-mergeable rows and drop only true closed singletons.
        if self._watermark is not None:
            late = ts + self.gap_ms <= self._watermark
            if late.any():
                # decide per-row in ARRIVAL order against a live interval
                # view that also tracks this batch's on-time rows for the
                # affected keys: an earlier row (late or on-time) can extend
                # a session into range of a later late row, exactly as
                # row-at-a-time processing would.  Kept rows then flow
                # through the normal segment/merge machinery, which
                # reproduces the same merged aggregates.
                gap_ms = self.gap_ms
                late_keys = {
                    tuple(kc[i] for kc in key_cols)
                    for i in np.nonzero(late)[0]
                }
                views = {
                    k: [[s.start, s.last] for s in self._sessions.get(k, ())]
                    for k in late_keys
                }
                for i in range(n):
                    key = tuple(kc[i] for kc in key_cols)
                    iv_list = views.get(key)
                    if iv_list is None:
                        continue
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
                    views[key] = [
                        iv for iv in iv_list if iv not in hit
                    ] + [merged]
            n_late = int(late.sum())
            if n_late:
                self._metrics["late_rows"] += n_late
                self._obs_late.add(n_late)
                keep = ~late
                ts = ts[keep]
                key_cols = [kc[keep] for kc in key_cols]
                vals = vals[keep]
                valid = valid[keep]
                udaf_cols = [[c[keep] for c in cols] for cols in udaf_cols]
                udaf_masks = [
                    m[keep] if m is not None else None for m in udaf_masks
                ]
                n = len(ts)
                if n == 0:
                    return

        # vectorized per-key segmenting: sort by (key, ts), then reduceat over
        # key-run + intra-batch gap boundaries
        composite = np.fromiter(
            (hash(tuple(kc[i] for kc in key_cols)) for i in range(n)),
            dtype=np.int64,
            count=n,
        )
        order = np.lexsort((ts, composite))
        ts_s = ts[order]
        comp_s = composite[order]
        vals_s = vals[order]
        valid_s = valid[order]
        key_rows = [kc[order] for kc in key_cols]
        # boundaries: new key run or gap within same key
        newkey = np.empty(n, dtype=bool)
        newkey[0] = True
        newkey[1:] = comp_s[1:] != comp_s[:-1]
        gap = np.empty(n, dtype=bool)
        gap[0] = True
        gap[1:] = (ts_s[1:] - ts_s[:-1]) > self.gap_ms
        bounds = np.nonzero(newkey | gap)[0]
        ends = np.append(bounds[1:], n)
        for b0, b1 in zip(bounds, ends):
            key = tuple(kr[b0] for kr in key_rows)
            seg_vals = vals_s[b0:b1]
            seg_valid = valid_s[b0:b1]
            # null-neutralize per aggregate kind (same semantics as the
            # device kernel: nulls excluded from count/sum/min/max)
            seg_counts = seg_valid.sum(axis=0)
            seg_sums = np.where(seg_valid, seg_vals, 0.0).sum(axis=0)
            with np.errstate(invalid="ignore", divide="ignore"):
                seg_means = np.where(
                    seg_counts > 0, seg_sums / np.maximum(seg_counts, 1), 0.0
                )
                seg_m2s = np.where(
                    seg_valid, (seg_vals - seg_means) ** 2, 0.0
                ).sum(axis=0)
            partial = _Agg(
                count=int(b1 - b0),
                counts=[int(c) for c in seg_counts],
                sums=[float(s) for s in seg_sums],
                mins=[
                    float(s)
                    for s in np.where(seg_valid, seg_vals, np.inf).min(axis=0)
                ],
                maxs=[
                    float(s)
                    for s in np.where(seg_valid, seg_vals, -np.inf).max(axis=0)
                ],
                means=[float(m) for m in seg_means],
                m2s=[float(m) for m in seg_m2s],
            )
            partial_accs = self._make_accs()
            if partial_accs is not None:
                seg_rows = order[b0:b1]
                for acc, cols, am in zip(partial_accs, udaf_cols, udaf_masks):
                    chunk = [c[seg_rows] for c in cols]
                    if am is not None:
                        ok = am[seg_rows]
                        chunk = [c[ok] for c in chunk]
                    acc.update(*chunk)
            self._merge_rows(key, ts_s[b0:b1], partial, partial_accs)

        # watermark advance + close expired sessions — skipped under
        # per-partition watermarks: the authoritative advance arrives as
        # a kind="partition" hint right after this batch
        if not self._src_watermarks:
            yield from self._advance_and_close(raw_min)

    def _advance_and_close(self, candidate_wm: int) -> Iterator[RecordBatch]:
        """Monotonic watermark advance, then emit every session whose gap
        has expired — shared by the per-batch path and idle-source
        WatermarkHint handling."""
        if self._watermark is None or candidate_wm > self._watermark:
            self._watermark = candidate_wm
        closed: list[tuple[tuple, _Session]] = []
        for k in list(self._sessions):
            still: list[_Session] = []
            for s in self._sessions[k]:
                if s.last + self.gap_ms <= self._watermark:
                    closed.append((k, s))
                else:
                    still.append(s)
            if still:
                self._sessions[k] = still
            else:
                del self._sessions[k]
        if closed:
            yield self._emit(closed)

    def _emit(self, closed: list[tuple[tuple, _Session]]) -> RecordBatch:
        self._metrics["sessions_emitted"] += len(closed)
        self._obs_windows.add(len(closed))
        m = len(closed)
        cols: list[np.ndarray] = []
        in_schema = self.input_op.schema
        for ci, g in enumerate(self.group_exprs):
            f = g.out_field(in_schema)
            vals = np.array([k[ci] for k, _ in closed], dtype=object)
            if f.dtype.is_numeric:
                vals = vals.astype(f.dtype.to_numpy())
            cols.append(vals)
        for ai, spec in enumerate(self._agg_specs):
            kind, col_i = spec[0], spec[1]
            if kind == "udaf":
                vals_out = [s.accs[col_i].evaluate() for _, s in closed]
                arr = np.empty(len(vals_out), dtype=object)
                for vi, v in enumerate(vals_out):
                    arr[vi] = v
                f = self.aggr_exprs[ai].out_field(self.input_op.schema)
                if f.dtype.is_numeric:
                    arr = arr.astype(f.dtype.to_numpy())
                cols.append(arr)
            elif kind in VAR_KINDS:
                cols.append(
                    variance_from_m2(
                        kind,
                        np.array([s.agg.counts[col_i] for _, s in closed]),
                        np.array([s.agg.m2s[col_i] for _, s in closed]),
                    )
                )
            elif kind == "count":
                cols.append(
                    np.array(
                        [
                            s.agg.count if col_i is None else s.agg.counts[col_i]
                            for _, s in closed
                        ],
                        dtype=np.int64,
                    )
                )
            elif kind == "sum":
                cols.append(np.array([s.agg.sums[col_i] for _, s in closed]))
            elif kind == "avg":
                cols.append(
                    np.array(
                        [
                            s.agg.sums[col_i] / s.agg.counts[col_i]
                            if s.agg.counts[col_i]
                            else np.nan
                            for _, s in closed
                        ]
                    )
                )
            elif kind == "min":
                v = np.array([s.agg.mins[col_i] for _, s in closed])
                cols.append(np.where(np.isposinf(v), np.nan, v))
            elif kind == "max":
                v = np.array([s.agg.maxs[col_i] for _, s in closed])
                cols.append(np.where(np.isneginf(v), np.nan, v))
            else:
                raise PlanError(f"session window does not support {kind}")
        starts = np.array([s.start for _, s in closed], dtype=np.int64)
        ends = np.array([s.last + self.gap_ms for _, s in closed], dtype=np.int64)
        # cast agg outputs to declared dtypes
        out_cols = []
        for f, c in zip(self.schema.fields[: len(cols)], cols):
            out_cols.append(
                c if c.dtype == object else c.astype(f.dtype.to_numpy())
            )
        out_cols += [starts, ends, starts.copy()]
        return RecordBatch(self.schema, out_cols)

    # -- checkpointing (host dict state → JSON blob) ----------------------
    def enable_checkpointing(self, node_id: str, coord, orch) -> None:
        # node ids embed the CLASS name (checkpoint.assign_node_ids); map
        # this class's back to the production operator's so snapshots
        # interoperate in both directions (same plan position, same key)
        node_id = node_id.replace(
            "ReferenceSessionWindowExec", "SessionWindowExec"
        )
        self._ckpt = (coord, f"session_{node_id}")
        snap = get_json(coord, self._ckpt[1])
        if snap is None:
            return
        self._watermark = snap["watermark"]
        self._sessions = {}
        for entry in snap["sessions"]:
            key_list, start, last, agg = entry[:4]
            acc_states = entry[4] if len(entry) > 4 else None
            accs = self._make_accs()
            if accs is not None and acc_states is not None:
                for acc, st in zip(accs, acc_states):
                    acc.merge(st)
            s = _Session(
                start,
                last,
                _Agg(
                    count=agg["count"],
                    counts=list(agg["counts"]),
                    sums=list(agg["sums"]),
                    mins=list(agg["mins"]),
                    maxs=list(agg["maxs"]),
                    means=list(agg.get("means", [0.0] * len(agg["sums"]))),
                    m2s=list(agg.get("m2s", [0.0] * len(agg["sums"]))),
                ),
                accs,
            )
            self._sessions.setdefault(tuple(key_list), []).append(s)

    def _snapshot(self, epoch: int) -> None:
        coord, key = self._ckpt
        sessions = [
            [list(k), s.start, s.last,
             {
                 "count": s.agg.count,
                 "counts": s.agg.counts,
                 "sums": s.agg.sums,
                 "mins": [float(m) for m in s.agg.mins],
                 "maxs": [float(m) for m in s.agg.maxs],
                 "means": [float(m) for m in s.agg.means],
                 "m2s": [float(m) for m in s.agg.m2s],
             },
             [acc.state() for acc in s.accs] if s.accs is not None else None]
            for k, lst in self._sessions.items()
            for s in lst
        ]
        put_json(
            coord, key, epoch,
            {"epoch": epoch, "watermark": self._watermark, "sessions": sessions},
        )

    def run(self) -> Iterator[StreamItem]:
        for item in self._doctor_input():
            if isinstance(item, RecordBatch):
                # materialized inside the busy bracket, as in the
                # vectorized operator
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
                open_starts = [
                    s.start
                    for lst in self._sessions.values()
                    for s in lst
                ]
                floor = (
                    self._watermark - self.gap_ms
                    if self._watermark is not None
                    else item.ts_ms
                )
                yield WatermarkHint(
                    min(
                        [item.ts_ms, floor]
                        + [st - 1 for st in open_starts]
                    ),
                    kind=item.kind,
                )
            elif isinstance(item, Marker):
                if self._ckpt is not None:
                    self._snapshot(item.epoch)
                yield item
            elif isinstance(item, EndOfStream):
                if self.emit_on_close and self._sessions:
                    closed = [
                        (k, s)
                        for k, lst in self._sessions.items()
                        for s in lst
                    ]
                    closed.sort(key=lambda e: e[1].start)
                    self._sessions.clear()
                    yield self._emit(closed)
                yield EOS
                return
