"""Slice-folding window operator — one ingest, N concurrent window specs;
counterpart of ``denormalized_tpu/physical/slice_exec.py``.

``SliceWindowExec`` is the execution half of the multi-query engine
(docs/multi_query.md): it accumulates per-(group, slide-unit) partials
ONCE per input batch into a shared :class:`SliceStore` and lets every
subscribed window spec — tumbling, sliding, and any number of
concurrently registered queries over the same source+filter+keys — fold
its windows from those partials.  A sliding window composes ``L/g``
slice partials by exact addition (the constant-pivot Chan combine; see
ops/slice_store.py) instead of re-aggregating raw rows per overlap, and
``N`` shareable queries pay ONE ingest+decode+aggregate pass instead of
``N``.

Two modes:

- **single-subscriber** (the planner's ``EngineConfig(slice_windows=
  True)`` fast path): a drop-in for :class:`StreamingWindowExec` on
  foldable aggregates — emissions flow as plain RecordBatches;
- **tagged** (the multi-query runtime): emissions are wrapped in
  :class:`SubscriberBatch` carrying the subscriber index, and the
  shared drive loop (runtime/multi_query.py) routes each to its query's
  sink.

The store is host float64/int64 numpy in both packages, never a torch
tensor: its byte-identity contract rests on a fixed fold order, so it
stays off the card, as the JAX package keeps it off the TPU.  Both
packages' emissions are equal bit for bit on the same feed.

Checkpointing takes ONE snapshot per epoch under ``slice_{node_id}``, in
the JAX package's meta and array layout (either package restores the
other's): the slice store's partials, the shared interner, the watermark,
and every subscriber's emission cursor — restore resumes each query
exactly where its own emissions stopped (per-query cursors matched by
tag, one store).  Semantics (late drop against the per-subscriber open
floor, per-partition watermark rebase, idle hints, EOS flush) mirror
StreamingWindowExec so a query moved between the operators sees the same
windows.  The slice operator has no cold tier (no ``enable_spill``), as in
the JAX package.

Observability: ``bind_obs("slice_window")``, the state observatory's
watch fed the batch's gids at intern time, the doctor's input-wait
bracket, every ``dnz_slice_*``, ``dnz_mq_*`` and ``dnz_sketch_*``
instrument, and the subscriber's doctor query id on lineage emissions.
"""

from __future__ import annotations

import math
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
    SKETCH_AGG_KINDS,
    VAR_KINDS,
    AggregateExpr,
    Column as _ColExpr,
    Expr,
)
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.ops.interner import GroupInterner
from denormalized_tpu_torch.ops.slice_store import SliceStore
from denormalized_tpu_torch.physical.base import (
    EOS,
    EndOfStream,
    ExecOperator,
    Marker,
    StreamItem,
    WatermarkHint,
)
from denormalized_tpu_torch.physical.window_exec import (
    watermark_floor,
    window_output_low_watermark,
)

#: aggregate kinds whose windows fold exactly from slice partials —
#: the sketch kinds fold within their documented error bounds via
#: mergeable sketch planes (ops/sketches.py), sharing like any other
#: foldable aggregate (subsumption groups, shared joins, live attach)
FOLDABLE_KINDS = frozenset(
    ("count", "sum", "min", "max", "avg")
    + tuple(VAR_KINDS)
    + tuple(SKETCH_AGG_KINDS)
)


@dataclass
class SliceSubscriber:
    """One window spec folding from the shared slice store."""

    aggr_exprs: list
    length_ms: int
    slide_ms: int
    tag: int = 0
    label: str | None = None
    #: residual predicate re-applied per row before this subscriber's
    #: slice partials accumulate (subsumption sharing: the group
    #: ingests under the WEAKEST member predicate; members with a
    #: strictly stronger predicate re-filter here).  None = the
    #: subscriber's predicate IS the base predicate — no re-filter.
    filter_expr: Expr | None = None
    #: full-predicate signature (checkpoint identity of this
    #: subscriber's filter, planner/predicates.predicate_signature)
    filter_sig: str = ""
    # filled by the operator: per-subscriber agg specs over the SHARED
    # value-column space, and the output schema
    agg_specs: list = field(default_factory=list)
    schema: Schema | None = None
    #: any agg spec is a ("sketch", …) entry — the emit path splits
    #: finalization between scalar components and sketch planes
    has_sketch: bool = False


class SubscriberBatch:
    """A tagged emission in multi-subscriber (shared) mode: ``tag`` is
    the subscriber index, ``batch`` the per-query emission."""

    __slots__ = ("tag", "batch")

    def __init__(self, tag: int, batch: RecordBatch) -> None:
        self.tag = tag
        self.batch = batch


def refilter_gid_mask(gid: np.ndarray, gid_pass: np.ndarray) -> np.ndarray:
    """Per-row residual mask from per-gid pass bits: one gather over
    dense interned gids.  The re-filter hot path for residual
    predicates over the group-key columns — the predicate itself is
    evaluated once per NEW gid (``_extend_gid_pass``), never per row."""
    return gid_pass[gid]


def shared_sort_order(units: np.ndarray, gid: np.ndarray) -> np.ndarray:
    """ONE stable ``(unit, gid)`` sort permutation for a whole batch,
    shared by every sort-lane filter class.  The key multiplier only
    has to separate gids (any value > max gid yields the same ordering
    relation), so the permutation is identical to the one each class's
    store would compute with its own capacity — classes reuse it
    instead of re-sorting."""
    mult = np.int64(max(int(gid.max()) + 1, 1)) if len(gid) else np.int64(1)
    key = units.astype(np.int64) * mult + gid.astype(np.int64)
    return np.argsort(key, kind="stable")


def masked_sorted_order(order: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Subset a stable sort permutation by a residual mask, preserving
    sort order — the per-class re-filter between the shared sort and
    that class's slice-store accumulate.  A stable subset of a stable
    sort IS the subset's stable sort, so the re-filtered member's folds
    stay byte-comparable to an independent oracle that sorts its
    filtered rows directly."""
    return order[mask[order]]


class _FilterClass:
    """One residual-predicate class inside a shared pipeline:
    subscribers whose full predicate equals the group's base predicate
    form class ``""`` (no re-filter, the shared ingest already applied
    it); each strictly stronger predicate gets its own class that
    re-filters the shared pass into its own slice partials.  Residual
    classes force the store's lexsort lane so an independent oracle
    (whose interner capacity differs) can match the fold lane by
    pinning ``EngineConfig(slice_sort_lane=True)``."""

    __slots__ = (
        "sig", "pred", "gid_lane", "gid_pass", "store", "exact_from_unit",
        "rows_kept",
    )

    def __init__(self, sig, pred, gid_lane, store) -> None:
        self.sig = sig
        self.pred = pred
        self.gid_lane = gid_lane
        self.gid_pass = np.zeros(0, dtype=bool)
        self.store = store
        # rows this class accumulated (post re-filter): the demand side
        # of upstream-cost attribution — a member whose residual keeps
        # 90% of a shared join's output is charged 90% of the join's
        # probe/build/gather time, not 1/N (shared_fractions)
        self.rows_kept = 0
        # first slice unit this class's partials are complete from: None
        # for classes present since the start of the stream, else the
        # unit after the max event time ingested when a mid-stream
        # attach opened the class.  EVERY member's first exact window
        # clamps past it — the floor is a property of the class's
        # partials, not of whichever joiner happened to create it
        self.exact_from_unit: int | None = None


class SliceWindowExec(ExecOperator):
    def __init__(
        self,
        input_op: ExecOperator,
        group_exprs: list[Expr],
        subscribers: list[SliceSubscriber],
        *,
        emit_on_close: bool = True,
        tagged: bool = False,
        unit_ms: int | None = None,
        sort_lane: bool = False,
        name: str = "slice_window",
    ) -> None:
        if not subscribers:
            raise PlanError("SliceWindowExec needs at least one subscriber")
        self.input_op = input_op
        self.group_exprs = list(group_exprs)
        self._subs = list(subscribers)
        self.emit_on_close = emit_on_close
        self._tagged = tagged
        self.name = name

        in_schema = input_op.schema
        # shared deduped value-column space across ALL subscribers (the
        # StreamingWindowExec dedup, widened to N aggregate lists).
        # ``_value_keys`` persists so live-attached subscribers can
        # resolve their aggregates against the SAME column space.
        self._value_exprs: list[Expr] = []
        self._value_transforms: list[str | None] = []
        self._var_shift: dict[str, float] = {}
        self._value_keys: dict = {}
        # sketch specs deduped across subscribers by (kind, value col,
        # params): two queries asking approx_distinct(v) share ONE HLL
        # plane, like any other deduped component.  Insertion order
        # assigns sids, so shared and restored runs label planes alike.
        self._sketch_specs: dict[tuple, object] = {}
        # dense value-id interner for approx_top_k lanes (lazy — only
        # pipelines carrying a top-k sketch pay for it)
        self._vid_interner: GroupInterner | None = None

        unit = 0
        for sub in self._subs:
            self._prepare_subscriber(sub, grow=True)
            unit = math.gcd(
                unit, math.gcd(sub.length_ms, sub.slide_ms)
            )
        if unit_ms is not None:
            # explicit slice-width pin: the fold grouping is part of a
            # query's numeric contract (f64 sums round per fold tree),
            # so an independent oracle comparing against a shared run
            # pins the shared group's unit here.  Any divisor of the
            # natural gcd is valid — slices still tile every window.
            if unit_ms <= 0 or unit % int(unit_ms):
                raise PlanError(
                    f"slice_unit_ms={unit_ms} must divide every "
                    f"subscriber's window length and slide (gcd {unit}ms)"
                )
            unit = int(unit_ms)
        self.unit_ms = unit
        all_specs = [s for sub in self._subs for s in sub.agg_specs]
        self._components = tuple(sa.components_for(all_specs))
        self._force_sort_lane = bool(sort_lane)

        self._grouped = len(self.group_exprs) > 0
        self._interner = (
            GroupInterner(len(self.group_exprs)) if self._grouped else None
        )
        # per-filter-class slice stores: one store per residual
        # predicate class; subscribers map to their class object
        self._classes: list[_FilterClass] = []
        self._sub_class: list[_FilterClass] = [
            self._class_for(sub) for sub in self._subs
        ]
        # live-registration state: pending attach/detach ops applied at
        # batch boundaries on the operator thread, per-sub cost ledger
        # for actual-fraction attribution, backfill-exactness tracking
        import threading

        self._ops_lock = threading.Lock()
        self._pending_ops: list = []
        self._sub_cost_ms: list[float] = [0.0] * len(self._subs)
        self._first_exact: list[int | None] = [None] * len(self._subs)
        self._first_ts: int | None = None
        self._exact_floor_unit: int | None = None
        self._orphans: dict[int, dict] = {}
        self._orphan_class_arrays: dict[str, tuple] = {}
        self._departed: set[int] = set()
        # base re-derivation (weakest-member departure): a predicate
        # every survivor's own filter implies, applied to arriving rows
        # BEFORE intern/value-eval/sort — the upstream plan still runs
        # the original (wider) base filter, but rows no survivor can
        # reach stop paying the ingest path (set_ingest_pred)
        self._ingest_pred: Expr | None = None
        # measured upstream shared cost (ms) — a shared join's
        # probe/build/gather ledger, apportioned across subscribers by
        # their classes' kept-rows demand in shared_fractions()
        self._upstream_cost_fn = None
        # fired after a detach completes (tag already removed, unowned
        # classes dropped, slices pruned) — the multi-query runtime
        # re-derives the ingest base from survivors here
        self.on_detach = None
        # single-subscriber mode exposes that subscriber's schema (the
        # planner drop-in contract); tagged mode has no single schema —
        # downstream is the multi-query drive loop, not an operator
        self.schema = self._subs[0].schema

        # streaming state
        self._ckpt: tuple | None = None
        self._next_win: list[int | None] = [None] * len(self._subs)
        self._watermark_ms: int | None = None
        self._src_watermarks = False
        self._max_ts: int | None = None
        self._metrics = {
            "rows_in": 0,
            "rows_ingested": 0,
            "batches_in": 0,
            "late_rows": 0,
            "windows_emitted": 0,
            "slice_folds": 0,
            "slices_live": 0,
            "slices_pruned": 0,
            "subscribers": len(self._subs),
        }

        from denormalized_tpu_torch import obs
        from denormalized_tpu_torch.obs import statewatch

        self.bind_obs("slice_window")
        self._sw = statewatch.make_watch("slice_window")
        self._obs_late = obs.counter("dnz_late_rows_total", op="slice_window")
        self._obs_windows = obs.counter(
            "dnz_windows_emitted_total", op="slice_window"
        )
        self._obs_emit_lag = obs.histogram(
            "dnz_emit_event_lag_ms", op="slice_window"
        )
        self._obs_wm_lag = obs.gauge("dnz_watermark_lag_ms", op="slice_window")
        self._obs_wm_lag_hist = obs.histogram(
            "dnz_watermark_lag_hist_ms", op="slice_window"
        )
        self._obs_slice_rows = obs.counter("dnz_slice_rows_total")
        self._obs_slice_units = obs.gauge("dnz_slice_units")
        self._obs_slice_subs = obs.gauge("dnz_slice_subscribers")
        self._obs_folds = obs.counter("dnz_slice_folds_total")
        self._obs_fold_ms = obs.histogram("dnz_slice_fold_ms")
        self._obs_slice_subs.set(len(self._subs))
        # per-subscriber emit lag: the aggregate histogram above sums
        # over subscribers, so a slow query hiding inside a shared
        # pipeline was unattributable — one gauge per query fixes that
        self._obs_mq_emit_lag = [
            obs.gauge(
                "dnz_mq_emit_lag_ms",
                query=sub.label if sub.label is not None else f"q{q}",
            )
            for q, sub in enumerate(self._subs)
        ]
        # query-dense serving instruments: live subscriber count (moves
        # on attach/detach), windows served from retained slices at
        # attach, and the per-batch residual re-filter cost
        self._obs_mq_live = obs.gauge("dnz_mq_subscribers_live")
        self._obs_mq_backfill = obs.counter("dnz_mq_backfill_windows_total")
        self._obs_refilter_ms = obs.histogram("dnz_mq_refilter_ms")
        self._obs_mq_live.set(len(self._subs))
        # sketch-plane instruments (rows through sketch kernels, exact
        # plane bytes, per-batch kernel time) — per-batch deltas of the
        # stores' own counters, summed over filter classes
        self._obs_sketch_rows = obs.counter("dnz_sketch_rows_total")
        self._obs_sketch_bytes = obs.gauge("dnz_sketch_state_bytes")
        self._obs_sketch_ms = obs.histogram("dnz_sketch_update_ms")
        self._sketch_rows_seen = 0
        self._sketch_upd_seen = 0.0

    # -- subscriber / filter-class plumbing ------------------------------
    @property
    def _store(self) -> SliceStore:
        """The base filter class's store (legacy single-class view —
        state accounting and tests address it directly)."""
        return self._classes[0].store

    def _prepare_subscriber(self, sub: SliceSubscriber, *, grow: bool) -> None:
        """Normalize one subscriber's window spec and resolve its
        aggregates against the shared value-column space.  With
        ``grow=False`` (live attach) the value space is frozen: an
        aggregate needing a column the group never ingested raises —
        the caller falls back to an independent pipeline."""
        in_schema = self.input_op.schema

        def col_idx(e: Expr, transform: str | None) -> int:
            k = (transform, repr(e))
            if k not in self._value_keys:
                if not grow:
                    raise PlanError(
                        f"subscriber aggregate over {e!r} needs a value "
                        "column the shared group does not ingest — "
                        "attach requires aggregates over the group's "
                        "existing column space"
                    )
                self._value_keys[k] = len(self._value_exprs)
                self._value_exprs.append(e)
                self._value_transforms.append(transform)
            return self._value_keys[k]

        sub.slide_ms = int(sub.slide_ms) if sub.slide_ms else int(
            sub.length_ms
        )
        sub.length_ms = int(sub.length_ms)
        if sub.length_ms <= 0 or sub.slide_ms <= 0:
            raise PlanError(
                "window length and slide must be positive for the "
                f"slice path (got L={sub.length_ms} S={sub.slide_ms})"
            )
        specs: list[tuple] = []
        for a in sub.aggr_exprs:
            if not isinstance(a, AggregateExpr):
                raise PlanError(f"{a!r} is not an aggregate expression")
            if a.kind not in FOLDABLE_KINDS:
                raise PlanError(
                    f"aggregate kind {a.kind!r} does not fold from "
                    "slice partials (UDAFs run in UdafWindowExec)"
                )
            if a.arg is None:
                specs.append((a.kind, None))
            elif a.kind in SKETCH_AGG_KINDS:
                specs.append(self._sketch_spec_for(a, col_idx, grow))
            elif a.kind in sa.VAR_KINDS:
                specs.append(
                    (
                        a.kind,
                        col_idx(a.arg, "shift"),
                        col_idx(a.arg, "shift_sq"),
                    )
                )
            else:
                specs.append((a.kind, col_idx(a.arg, None)))
        sub.agg_specs = specs
        sub.has_sketch = any(s[0] == "sketch" for s in specs)
        fields = [g.out_field(in_schema) for g in self.group_exprs]
        fields += [a.out_field(in_schema) for a in sub.aggr_exprs]
        fields += [
            Field(
                WINDOW_START_COLUMN, DataType.TIMESTAMP_MS, nullable=False
            ),
            Field(
                WINDOW_END_COLUMN, DataType.TIMESTAMP_MS, nullable=False
            ),
            Field(
                CANONICAL_TIMESTAMP_COLUMN,
                DataType.TIMESTAMP_MS,
                nullable=False,
            ),
        ]
        sub.schema = Schema(fields)

    def _sketch_spec_for(self, a: AggregateExpr, col_idx, grow: bool) -> tuple:
        """Resolve one sketch aggregate to its (deduped) SketchSpec and
        value lane.  Specs dedup by (family, value column, params) —
        concurrent queries asking the same sketch over the same column
        share one plane per slice cell.  With ``grow=False`` (live
        attach) a spec the group never planned raises: sketch planes
        exist per slice unit from the unit's creation, so a mid-stream
        joiner can only ride planes already maintained."""
        from denormalized_tpu_torch.ops import sketches as skx

        if a.kind == "approx_distinct":
            vcol = col_idx(a.arg, "hash")
            key = ("hll", vcol, ())
            q = None
        elif a.kind == "approx_top_k":
            k = int(a.params[0]) if a.params else 10
            vcol = col_idx(a.arg, "vid")
            key = ("topk", vcol, (k,))
            q = None
        else:  # approx_percentile_cont / approx_median
            q = float(a.params[0]) if a.params else 0.5
            vcol = col_idx(a.arg, None)
            key = ("kll", vcol, ())
        spec = self._sketch_specs.get(key)
        if spec is None:
            if not grow:
                raise PlanError(
                    f"subscriber aggregate {a.kind}({a.arg!r}) needs a "
                    "sketch plane the shared group does not maintain — "
                    "attach requires sketches the group already plans"
                )
            sid = f"sk{len(self._sketch_specs)}"
            if key[0] == "hll":
                spec = skx.HllSpec(sid, vcol)
            elif key[0] == "topk":
                spec = skx.TopKSpec(sid, vcol, key[2][0])
            else:
                spec = skx.KllSpec(sid, vcol)
            self._sketch_specs[key] = spec
        if q is None:
            return ("sketch", vcol, spec)
        return ("sketch", vcol, spec, q)

    def _class_for(self, sub: SliceSubscriber) -> _FilterClass:
        """Find or create the filter class for one subscriber's
        residual predicate."""
        sig = "" if sub.filter_expr is None else repr(sub.filter_expr)
        for cls in self._classes:
            if cls.sig == sig:
                return cls
        gid_lane = False
        if sig and self._grouped:
            key_names = {
                g.name for g in self.group_exprs if isinstance(g, _ColExpr)
            }
            gid_lane = (
                len(key_names) == len(self.group_exprs)
                and sub.filter_expr.columns_referenced() <= key_names
            )
        store = SliceStore(
            self._components,
            self.unit_ms,
            # residual classes always sort: their independent oracles
            # run a DIFFERENT interner (own gid space/capacity), so the
            # dense-lane guard could diverge — the lexsort lane's fold
            # order is capacity-independent (oracle pins
            # EngineConfig(slice_sort_lane=True) to match)
            force_sort_lane=self._force_sort_lane or bool(sig),
            sketches=tuple(self._sketch_specs.values()),
        )
        cls = _FilterClass(sig, sub.filter_expr, gid_lane, store)
        self._classes.append(cls)
        return cls

    def _extend_gid_pass(self, cls: _FilterClass, ngroups: int) -> None:
        """Evaluate a gid-lane class's residual predicate over the
        interner keys of gids not yet classified (new groups only —
        O(new keys), never O(rows))."""
        start = len(cls.gid_pass)
        if ngroups <= start:
            return
        new = np.arange(start, ngroups, dtype=np.int64)
        key_vals = self._interner.keys_of(new)
        fields = [g.out_field(self.input_op.schema) for g in self.group_exprs]
        kb = RecordBatch(Schema(fields), list(key_vals))
        passed = np.asarray(cls.pred.eval(kb), dtype=bool)
        cls.gid_pass = np.concatenate((cls.gid_pass, passed))

    def shared_fractions(self) -> dict[int, float]:
        """Measured per-subscriber share of this pipeline's work, keyed
        by subscriber tag — the doctor's actual-fraction attribution
        for shared pipelines (re-filter + per-class accumulate + fold
        cost differs across subscribers, so 1/N would lie).

        When the shared input is itself a measured operator (a shared
        ``StreamingJoinExec`` reporting probe/build/gather time via
        ``_upstream_cost_fn``), that upstream cost is apportioned by
        each subscriber's share of kept rows: a member whose residual
        keeps 90% of the join output caused ~90% of the join's gather
        fan-out, and is attributed accordingly."""
        total = sum(self._sub_cost_ms)
        n = max(len(self._subs), 1)
        up = 0.0
        if self._upstream_cost_fn is not None:
            try:
                up = float(self._upstream_cost_fn())
            except Exception:  # dnzlint: allow(broad-except) doctor attribution is best-effort: a torn upstream metrics read mid-teardown degrades to measured-only shares, it never fails the pipeline
                up = 0.0
        if total <= 0.0 and up <= 0.0:
            return {sub.tag: 1.0 / n for sub in self._subs}
        kept = [0.0] * len(self._subs)
        if up > 0.0:
            for cls in self._classes:
                owners = [
                    q for q, c in enumerate(self._sub_class) if c is cls
                ]
                if owners and cls.rows_kept:
                    share = cls.rows_kept / len(owners)
                    for q in owners:
                        kept[q] = share
            ktot = sum(kept)
            if ktot > 0.0:
                kept = [k / ktot for k in kept]
            else:
                kept = [1.0 / n] * len(self._subs)
        denom = total + up
        return {
            sub.tag: (self._sub_cost_ms[q] + up * kept[q]) / denom
            for q, sub in enumerate(self._subs)
        }

    # -- live registration (attach/detach at slice boundaries) -----------
    def request_attach(self, sub: SliceSubscriber, when_ts: int | None = None):
        """Queue a mid-stream subscription (any thread).  The operator
        thread applies it at the next batch boundary — with ``when_ts``
        set, at the first batch whose min event time reaches it, so a
        replayed request lands at the same stream position after a
        kill/restore (event time is deterministic; arrival time isn't)."""
        with self._ops_lock:
            self._pending_ops.append(("attach", sub, when_ts))

    def request_detach(self, tag: int, when_ts: int | None = None):
        """Queue a mid-stream unsubscription (any thread)."""
        with self._ops_lock:
            self._pending_ops.append(("detach", tag, when_ts))

    def _drain_ops(self, upcoming_ts: int | None) -> Iterator:
        """Apply pending attach/detach ops whose event-time threshold
        the upcoming batch reaches (``None`` = end of stream: apply
        everything).  Yields backfilled window emissions from attaches."""
        with self._ops_lock:
            if not self._pending_ops:
                return
            ready, rest = [], []
            for op in self._pending_ops:
                when = op[2]
                if upcoming_ts is None or when is None or when <= upcoming_ts:
                    ready.append(op)
                else:
                    rest.append(op)
            self._pending_ops = rest
        for kind, payload, _when in ready:
            if kind == "attach":
                for b in self.attach(payload):
                    yield b
            else:
                self.detach(payload)

    def attach(self, sub: SliceSubscriber, *, warm: bool = True) -> list:
        """Attach a subscriber mid-stream and warm it from the slice
        store's retained partials.  Returns the backfilled window
        emissions (windows the gcd slices already cover exactly).

        Exactness contract: the first exact window j* is the max of the
        joiner's anchor at the stream's first event time and the ceiling
        of the highest prune/late-drop floor ever applied — everything
        from j* on folds from complete slices, so backfilled windows and
        all later ones are byte-identical to an independent from-start
        pipeline.  A joiner whose residual predicate opens a NEW filter
        class has no retained partials to warm from, so its j* addition-
        ally clamps past the max event time already ingested."""
        from denormalized_tpu_torch import obs

        if sub.tag in self._departed:
            # replay idempotence: this tag joined AND left before the
            # restored checkpoint — re-applying its registration
            # schedule must not re-attach it
            return []
        if any(s.tag == sub.tag for s in self._subs):
            raise PlanError(f"subscriber tag {sub.tag} is already attached")
        self._prepare_subscriber(sub, grow=False)
        if sub.length_ms % self.unit_ms or sub.slide_ms % self.unit_ms:
            raise PlanError(
                f"window {sub.length_ms}ms/{sub.slide_ms}ms does not "
                f"tile the shared group's {self.unit_ms}ms slices — "
                "attach requires length and slide divisible by the unit"
            )
        needed = set(sa.components_for(sub.agg_specs))
        if not needed <= set(self._components):
            raise PlanError(
                "subscriber aggregates need slice components "
                f"{sorted(needed - set(self._components))} the shared "
                "store does not maintain"
            )
        sig = "" if sub.filter_expr is None else repr(sub.filter_expr)
        fresh = all(c.sig != sig for c in self._classes)
        cls = self._class_for(sub)
        if fresh:
            stash = self._orphan_class_arrays.pop(cls.sig, None)
            if stash is not None:
                # a restored checkpoint carried this class's partials
                # (its only owners were late joiners) — revive them
                # along with the class's exactness floor (the original
                # class may itself have opened mid-stream)
                st_arrays, st_ngroups, st_efu = stash
                cls.store.restore_arrays(st_arrays, st_ngroups)
                cls.exact_from_unit = st_efu
            elif self._max_ts is not None:
                # genuinely new residual class mid-stream: its partials
                # only cover data from here on — record the floor ON
                # THE CLASS so later same-class joiners inherit it
                cls.exact_from_unit = self._max_ts // self.unit_ms + 1
        self._subs.append(sub)
        q = len(self._subs) - 1
        self._sub_class.append(cls)
        self._sub_cost_ms.append(0.0)
        self._next_win.append(None)
        self._first_exact.append(None)
        self._obs_mq_emit_lag.append(
            obs.gauge(
                "dnz_mq_emit_lag_ms",
                query=sub.label if sub.label is not None else f"q{sub.tag}",
            )
        )
        self._obs_mq_live.set(len(self._subs))
        self._obs_slice_subs.set(len(self._subs))
        emitted: list = []
        rec = self._orphans.pop(sub.tag, None)
        if rec is not None:
            if (
                rec["filter_sig"] != sub.filter_sig
                or int(rec["length_ms"]) != sub.length_ms
                or int(rec["slide_ms"]) != sub.slide_ms
            ):
                from denormalized_tpu_torch.common.errors import StateError

                raise StateError(
                    f"re-attaching subscriber tag {sub.tag} does not "
                    "match its checkpointed record (filter signature or "
                    "window spec changed)"
                )
            # replayed registration after restore: adopt the cursor the
            # checkpoint carried — no backfill, those windows emitted
            nw = rec["next_win"]
            self._next_win[q] = None if nw is None else int(nw)
            fe = rec.get("first_exact")
            self._first_exact[q] = None if fe is None else int(fe)
        elif warm and self._first_ts is not None:
            j_star = self._anchor(q, self._first_ts)
            if self._exact_floor_unit is not None:
                j_star = max(
                    j_star,
                    -(-(self._exact_floor_unit * self.unit_ms)
                      // sub.slide_ms),
                )
            if cls.exact_from_unit is not None:
                # the class opened mid-stream: no partials predate its
                # creation, so exactness starts past everything the
                # stream had ingested by then — for every member, not
                # just the joiner that opened it
                j_star = max(
                    j_star,
                    -(-(cls.exact_from_unit * self.unit_ms)
                      // sub.slide_ms),
                )
            self._first_exact[q] = j_star
            wm = self._wm_floor(q)
            if wm is not None and wm > j_star:
                for j in range(j_star, wm):
                    b = self._emit_window(q, j)
                    if b is not None:
                        emitted.append(b)
                self._obs_mq_backfill.add(wm - j_star)
            self._next_win[q] = max(j_star, wm) if wm is not None else j_star
        return emitted

    def detach(self, tag: int) -> None:
        """Detach a subscriber; drop its cursor, ledger, and any filter
        class no survivor owns, then prune slices only it retained."""
        matches = [q for q, s in enumerate(self._subs) if s.tag == tag]
        if not matches:
            if tag in self._departed:
                return  # replayed detach of an already-departed tag
            raise PlanError(f"no attached subscriber has tag {tag}")
        if len(self._subs) == 1:
            raise PlanError(
                "cannot detach the last subscriber — stop the pipeline "
                "instead"
            )
        q = matches[0]
        self._departed.add(tag)
        del self._subs[q]
        del self._next_win[q]
        del self._sub_class[q]
        del self._sub_cost_ms[q]
        del self._first_exact[q]
        del self._obs_mq_emit_lag[q]
        owned = {id(c) for c in self._sub_class}
        self._classes = [c for c in self._classes if id(c) in owned]
        floor = self._floor_unit()
        if floor is not None:
            self._metrics["slices_pruned"] += sum(
                cls.store.prune(floor) for cls in self._classes
            )
        self._obs_mq_live.set(len(self._subs))
        self._obs_slice_subs.set(len(self._subs))
        if self.on_detach is not None:
            self.on_detach(tag)

    def set_ingest_pred(self, pred: Expr | None) -> None:
        """Narrow (or clear) the ingest predicate applied to arriving
        rows before intern/value-eval/sort.  The caller (the
        multi-query runtime's base re-derivation) guarantees every
        surviving subscriber's full predicate implies ``pred``, so
        dropped rows are rows NO survivor's class would keep — partials
        stay byte-identical while rows only the departed base member
        could reach stop paying the ingest path.  Takes effect at the
        next batch; the re-derivation fires at a batch boundary (the
        detach drain), so no in-flight batch is split."""
        self._ingest_pred = pred

    # ------------------------------------------------------------------
    @property
    def children(self):
        return [self.input_op]

    def metrics(self):
        m = dict(self._metrics)
        m["slices_live"] = max(len(c.store) for c in self._classes)
        m["subscribers"] = len(self._subs)
        m["filter_classes"] = len(self._classes)
        return m

    def _label(self):
        specs = ", ".join(
            f"{s.length_ms}ms/{s.slide_ms}ms" for s in self._subs[:4]
        )
        if len(self._subs) > 4:
            specs += f", … ({len(self._subs)} total)"
        return (
            f"SliceWindowExec(unit={self.unit_ms}ms, windows=[{specs}], "
            f"groups=[{', '.join(g.name for g in self.group_exprs)}])"
        )

    # -- state observatory (obs/statewatch.py) ---------------------------
    def state_info(self) -> dict:
        from denormalized_tpu_torch.obs import statewatch as swm

        live_keys = len(self._interner) if self._interner is not None else (
            1 if self._max_ts is not None else 0
        )
        store_bytes = sum(c.store.nbytes() for c in self._classes)
        # the approx_top_k value→vid interner is NOT a sketch plane: it
        # grows with distinct VALUES (one dict entry + boxed key each),
        # the one cardinality-linear structure on the sketch lane —
        # account it like any other interned key so budget/growth
        # verdicts see it (docs/approx_aggregates.md)
        vid_keys = (
            len(self._vid_interner) if self._vid_interner is not None else 0
        )
        units = self._store.live_units()
        oldest = units[0] * self.unit_ms if units else None
        wm = self._watermark_ms
        info = {
            "op": "slice_window",
            "state_bytes": store_bytes
            + (live_keys + vid_keys) * swm.KEY_EST_BYTES,
            "vid_interner_keys": vid_keys,
            "slice_store_bytes": store_bytes,
            # exact sketch-plane bytes (already inside state_bytes via
            # the stores' nbytes) — O(1) per gid in value cardinality,
            # the doctor's contrast to unbounded exact accumulators
            "sketch_bytes": sum(
                c.store.sketch_nbytes() for c in self._classes
            ),
            "live_keys": live_keys,
            "slot_capacity": int(self._store.capacity),
            "slot_live": live_keys,
            "slices_live": max(len(c.store) for c in self._classes),
            "subscribers": len(self._subs),
            "filter_classes": len(self._classes),
            "retention_unit_ms": max(s.length_ms for s in self._subs),
            "oldest_event_ms": oldest,
            "watermark_ms": wm,
        }
        if wm is not None and oldest is not None:
            info["oldest_event_lag_ms"] = max(0, int(wm) - int(oldest))
        return info

    def _state_watch_views(self):
        if not self._sw:
            return []
        if self._interner is None:
            return [(None, self._sw, None)]
        from denormalized_tpu_torch.ops.interner import display_keys

        return [
            (None, self._sw, lambda g: display_keys(self._interner, g))
        ]

    # -- cursor / retention arithmetic -----------------------------------
    def _anchor(self, q: int, ts_min: int) -> int:
        """First window of subscriber ``q`` overlapping ``ts_min``."""
        sub = self._subs[q]
        return (ts_min - sub.length_ms) // sub.slide_ms + 1

    def _wm_floor(self, q: int) -> int | None:
        if self._watermark_ms is None:
            return None
        sub = self._subs[q]
        return int(
            watermark_floor(self._watermark_ms, sub.length_ms, sub.slide_ms)
        )

    def _floor_unit(self) -> int | None:
        """Lowest slice unit any subscriber's open (or rebased-open)
        window may still fold — rows below it are late for EVERY
        subscriber and slices below it are prunable.  Under per-
        partition watermarks a slower partition may rebase a cursor
        back down to the watermark floor, so the floor accounts for
        that exactly like StreamingWindowExec's rebase rule."""
        lows = []
        for q, sub in enumerate(self._subs):
            nw = self._next_win[q]
            if nw is None:
                return None
            low_j = nw
            if self._src_watermarks:
                f = self._wm_floor(q)
                if f is not None:
                    low_j = min(low_j, f)
            lows.append(low_j * sub.slide_ms // self.unit_ms)
        return min(lows)

    # -- per-batch processing --------------------------------------------
    def _eval_values(
        self, batch: RecordBatch, n: int
    ) -> tuple[np.ndarray, np.ndarray, dict[int, np.ndarray]]:
        from denormalized_tpu_torch.logical.expr import column_validity

        V = max(len(self._value_exprs), 1)
        values64 = np.zeros((n, V), dtype=np.float64)
        colvalid = np.ones((n, V), dtype=bool)
        aux: dict[int, np.ndarray] = {}
        for j, e in enumerate(self._value_exprs):
            tr = self._value_transforms[j]
            if tr in ("hash", "vid"):
                # sketch source lanes: never forced through float64 (a
                # string column would not survive the cast, and an
                # int64 beyond 2^53 would lose identity).  The f64
                # matrix column stays 0 — no scalar component reads it.
                m = column_validity(e, batch)
                if m is not None:
                    colvalid[:, j] = m
                col = e.eval(batch)
                if tr == "hash":
                    from denormalized_tpu_torch.ops.sketches import stable_hash64

                    aux[j] = stable_hash64(col, m)
                else:
                    aux[j] = self._intern_vids(col, m, n)
                continue
            raw = np.asarray(e.eval(batch), dtype=np.float64)
            m = column_validity(e, batch)
            if m is not None:
                colvalid[:, j] = m
            if tr is not None:
                # variance pivot shift: identical rule to
                # StreamingWindowExec — the first finite valid value ever
                # seen for this expression pins K, so shared and
                # independent runs over the same feed shift identically
                key = repr(e)
                K = self._var_shift.get(key)
                if K is None:
                    valid_vals = raw[colvalid[:, j]] if m is not None else raw
                    finite = valid_vals[np.isfinite(valid_vals)]
                    if len(finite):
                        K = float(finite[0])
                        self._var_shift[key] = K
                    else:
                        K = 0.0
                raw = raw - K
                if tr == "shift_sq":
                    raw = raw * raw
            values64[:, j] = raw
        return values64, colvalid, aux

    def _intern_vids(
        self, col, valid: np.ndarray | None, n: int
    ) -> np.ndarray:
        """Dense value ids for an approx_top_k lane: the exec-owned
        single-column interner assigns ids in first-seen order over the
        SHARED (base-predicate) row stream, so every subscriber's
        summary speaks the same id space and ``keys_of`` recovers the
        original values at emission.  Invalid rows get id 0 and are
        masked out by ``colvalid`` before the sketch kernel runs."""
        if self._vid_interner is None:
            self._vid_interner = GroupInterner(1)
        out = np.zeros(n, dtype=np.int64)
        if valid is None:
            out[:] = self._vid_interner.intern([col])
        else:
            idx = np.flatnonzero(valid)
            if len(idx):
                sub = (
                    col.take(idx)
                    if hasattr(col, "take")
                    else np.asarray(col)[idx]
                )
                out[idx] = self._vid_interner.intern([sub])
        return out

    def _process_batch(self, batch: RecordBatch) -> Iterator:
        n = batch.num_rows
        if n == 0:
            return
        t_shared0 = time.perf_counter()
        self._metrics["rows_in"] += n
        self._metrics["batches_in"] += 1
        self._obs_rows_in.add(n)
        ts = np.asarray(
            batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64
        )
        units = ts // self.unit_ms
        ts_min = int(ts.min())
        ts_max = int(ts.max())
        if self._first_ts is None:
            self._first_ts = ts_min
        self._max_ts = ts_max if self._max_ts is None else max(
            self._max_ts, ts_max
        )
        for q in range(len(self._subs)):
            if self._next_win[q] is None:
                self._next_win[q] = self._anchor(q, ts_min)
            elif self._src_watermarks:
                # per-partition watermarks: a slower partition's earlier
                # windows stay legitimate until the min-driven watermark
                # closes them — rebase the cursor down to the watermark
                # floor (never below it: those windows genuinely emitted),
                # and never below the subscriber's exactness floor: a
                # mid-stream joiner's windows before first_exact can
                # never fold completely (its class has no partials
                # there), and out-of-order upstream output — a shared
                # join's probe emissions carry retained rows older than
                # the frontier — would otherwise drag the cursor into
                # that inexact range and emit truncated windows
                anchor = self._anchor(q, ts_min)
                if anchor < self._next_win[q]:
                    f = self._wm_floor(q)
                    new = anchor if f is None else max(anchor, f)
                    fe = self._first_exact[q]
                    if fe is not None:
                        new = max(new, fe)
                    if new < self._next_win[q]:
                        self._next_win[q] = new
        if self._ingest_pred is not None:
            # re-derived (narrowed) base after the weakest member left:
            # rows failing every survivor's predicate skip the ingest
            # path entirely.  Watermark/cursor bookkeeping above already
            # used the FULL batch's ts_min/ts_max, so trigger timing is
            # unchanged — only the accumulated row set narrows, and
            # those rows belonged to no survivor's class.
            keep_in = np.asarray(self._ingest_pred.eval(batch), dtype=bool)
            if not keep_in.all():
                if not keep_in.any():
                    if not self._src_watermarks:
                        if (
                            self._watermark_ms is None
                            or ts_min > self._watermark_ms
                        ):
                            self._watermark_ms = ts_min
                    yield from self._trigger()
                    return
                batch = batch.take(np.nonzero(keep_in)[0])
                ts = ts[keep_in]
                units = units[keep_in]
                n = batch.num_rows
        self._metrics["rows_ingested"] += n
        # group ids for every row (keys intern regardless of lateness,
        # matching StreamingWindowExec)
        if self._grouped:
            key_cols = [g.eval(batch) for g in self.group_exprs]
            gid = self._interner.intern(key_cols)
            ngroups = len(self._interner)
        else:
            gid = np.zeros(n, dtype=np.int32)
            ngroups = 1
        self._sw.update(gid)
        values64, colvalid, aux = self._eval_values(batch, n)

        # residual re-filter masks, one per filter class, computed over
        # the FULL batch (row-lane predicates need batch alignment)
        # before the late-drop subset below
        t_ref0 = time.perf_counter()
        masks: list[np.ndarray | None] = []
        for cls in self._classes:
            if cls.pred is None:
                masks.append(None)
            elif cls.gid_lane:
                self._extend_gid_pass(cls, ngroups)
                masks.append(refilter_gid_mask(gid, cls.gid_pass))
            else:
                masks.append(np.asarray(cls.pred.eval(batch), dtype=bool))
        refilter_ms = (time.perf_counter() - t_ref0) * 1e3
        if len(self._classes) > 1 or self._classes[0].pred is not None:
            self._obs_refilter_ms.observe(refilter_ms)

        floor = self._floor_unit()
        if floor is not None:
            if (
                self._exact_floor_unit is None
                or floor > self._exact_floor_unit
            ):
                self._exact_floor_unit = floor
            keep = units >= floor
            n_late = int((~keep).sum())
            if n_late:
                self._metrics["late_rows"] += n_late
                self._obs_late.add(n_late)
                units = units[keep]
                gid = gid[keep]
                values64 = values64[keep]
                colvalid = colvalid[keep]
                aux = {j: a[keep] for j, a in aux.items()}
                masks = [m if m is None else m[keep] for m in masks]
        # shared ingest cost (intern + sketch + value eval + masks)
        # splits evenly; per-class accumulate cost charges that class's
        # subscribers — the ledger behind shared_fractions()
        nsubs = max(len(self._subs), 1)
        shared_ms = (time.perf_counter() - t_shared0) * 1e3 / nsubs
        for q in range(len(self._subs)):
            self._sub_cost_ms[q] += shared_ms
        if len(units):
            # one stable (unit, gid) sort serves every sort-lane class:
            # a residual mask applied in sorted order IS that class's
            # own stable sort, so N filter classes pay one argsort
            order_full: np.ndarray | None = None
            for ci, cls in enumerate(self._classes):
                t_cls0 = time.perf_counter()
                m = masks[ci]
                if m is None:
                    if cls.store.add_only:
                        # dense bincount lane — no sort to share
                        cls.store.accumulate(
                            units, gid, values64, colvalid, ngroups
                        )
                    else:
                        if order_full is None:
                            order_full = shared_sort_order(units, gid)
                        cls.store.accumulate(
                            units, gid, values64, colvalid, ngroups,
                            order=order_full, aux=aux,
                        )
                    rows = len(units)
                else:
                    if not m.any():
                        continue
                    if order_full is None:
                        order_full = shared_sort_order(units, gid)
                    o_sub = masked_sorted_order(order_full, m)
                    cls.store.accumulate(
                        units, gid, values64, colvalid, ngroups,
                        order=o_sub, aux=aux,
                    )
                    rows = len(o_sub)
                if ci == 0:
                    self._obs_slice_rows.add(rows)
                cls.rows_kept += rows
                cls_ms = (time.perf_counter() - t_cls0) * 1e3
                owners = [
                    q for q, c in enumerate(self._sub_class) if c is cls
                ]
                if owners:
                    share = cls_ms / len(owners)
                    for q in owners:
                        self._sub_cost_ms[q] += share
            if self._sketch_specs:
                rows_t = sum(c.store.sketch_rows for c in self._classes)
                upd_t = sum(c.store.sketch_update_s for c in self._classes)
                self._obs_sketch_rows.add(rows_t - self._sketch_rows_seen)
                self._obs_sketch_ms.observe(
                    (upd_t - self._sketch_upd_seen) * 1e3
                )
                self._sketch_rows_seen = rows_t
                self._sketch_upd_seen = upd_t
                self._obs_sketch_bytes.set(
                    sum(c.store.sketch_nbytes() for c in self._classes)
                )

        if not self._src_watermarks:
            if self._watermark_ms is None or ts_min > self._watermark_ms:
                self._watermark_ms = ts_min
        yield from self._trigger()

    # -- emission --------------------------------------------------------
    def _trigger(self) -> Iterator:
        if self._obs_wm_lag and self._watermark_ms is not None:
            lag = time.time() * 1000.0 - self._watermark_ms
            self._obs_wm_lag.set(lag)
            self._obs_wm_lag_hist.observe(lag)
        if self._watermark_ms is None:
            return
        for q, sub in enumerate(self._subs):
            nw = self._next_win[q]
            if nw is None:
                continue
            wm_win = self._wm_floor(q)
            while nw < wm_win:
                b = self._emit_window(q, nw)
                nw += 1
                if b is not None:
                    yield b
            self._next_win[q] = nw
        floor = self._floor_unit()
        if floor is not None:
            if (
                self._exact_floor_unit is None
                or floor > self._exact_floor_unit
            ):
                self._exact_floor_unit = floor
            self._metrics["slices_pruned"] += sum(
                cls.store.prune(floor) for cls in self._classes
            )
        # gauge AFTER the prune: the exported number is the retained
        # slice count the catalog text promises, not the pre-prune peak
        self._obs_slice_units.set(
            max(len(cls.store) for cls in self._classes)
        )

    def _emit_window(self, q: int, j: int):
        sub = self._subs[q]
        t0 = time.perf_counter()
        u0 = j * sub.slide_ms // self.unit_ms
        u1 = (j * sub.slide_ms + sub.length_ms) // self.unit_ms
        rows = self._sub_class[q].store.fold(u0, u1)
        self._metrics["slice_folds"] += 1
        self._obs_folds.add(1)
        if rows is None:
            self._sub_cost_ms[q] += (time.perf_counter() - t0) * 1e3
            return None
        ngroups = len(self._interner) if self._grouped else 1
        counts = rows[sa.ROW_COUNT.label]
        active = counts > 0
        active[ngroups:] = False
        if not active.any():
            self._sub_cost_ms[q] += (time.perf_counter() - t0) * 1e3
            return None
        gids = np.nonzero(active)[0].astype(np.int32)
        if sub.has_sketch:
            finals = [
                self._finalize_sketch(s, rows, gids)
                if s[0] == "sketch"
                else sa.finalize([s], rows, active)[0]
                for s in sub.agg_specs
            ]
        else:
            finals = sa.finalize(sub.agg_specs, rows, active)
        batch = self._assemble_emission(sub, j, gids, finals)
        if self._obs_mq_emit_lag[q]:
            self._obs_mq_emit_lag[q].set(
                time.time() * 1000.0 - (j * sub.slide_ms + sub.length_ms)
            )
        fold_ms = (time.perf_counter() - t0) * 1e3
        self._sub_cost_ms[q] += fold_ms
        self._obs_fold_ms.observe(fold_ms)
        self._metrics["windows_emitted"] += 1
        if self._tagged:
            return SubscriberBatch(sub.tag, batch)
        return batch

    def _finalize_sketch(
        self, spec_t: tuple, rows: dict, gids: np.ndarray
    ) -> np.ndarray:
        """Finalize one sketch aggregate's column for the active gids of
        an emitted window from the folded sketch planes."""
        spec = spec_t[2]
        if spec.kind == "hll":
            return spec.finalize(rows, gids)
        if spec.kind == "kll":
            return spec.finalize_quantile(rows, gids, spec_t[3])
        # topk: per-gid [[value, count], …] rows, count-desc — value ids
        # translate back through the exec's value interner
        ka = rows[f"{spec.sid}|k"]
        ca = rows[f"{spec.sid}|c"]
        ea = rows[f"{spec.sid}|e"]
        out = np.empty(len(gids), dtype=object)
        for i, gi in enumerate(np.asarray(gids).tolist()):
            vids, cnts, _errs = spec.cell_top(ka[gi], ca[gi], ea[gi])
            if len(vids):
                kv = self._vid_interner.keys_of(vids.astype(np.int64))[0]
                vals = np.asarray(kv).tolist()
            else:
                vals = []
            out[i] = [
                [v, int(c)] for v, c in zip(vals, cnts.tolist())
            ]
        return out

    def _assemble_emission(
        self, sub: SliceSubscriber, j: int, gids: np.ndarray, finals: list
    ) -> RecordBatch:
        in_schema = self.input_op.schema
        cols: list[np.ndarray] = []
        if self._grouped:
            key_vals = self._interner.keys_of(gids)
            for g, kv in zip(self.group_exprs, key_vals):
                f = g.out_field(in_schema)
                if f.dtype.is_numeric:
                    kv = np.asarray(kv.tolist(), dtype=f.dtype.to_numpy())
                cols.append(kv)
        for a, arr in zip(sub.aggr_exprs, finals):
            f = a.out_field(in_schema)
            arr = np.asarray(arr)
            if f.dtype.is_numeric:
                # LIST outputs (approx_top_k) stay object arrays — same
                # rule UdafWindowExec applies to non-numeric finals
                arr = arr.astype(f.dtype.to_numpy())
            cols.append(arr)
        m = len(gids)
        start = np.full(m, j * sub.slide_ms, dtype=np.int64)
        end = np.full(
            m, j * sub.slide_ms + sub.length_ms, dtype=np.int64
        )
        cols += [start, end, start.copy()]
        self._obs_windows.add(1)
        if self._obs_emit_lag:
            self._obs_emit_lag.observe(
                time.time() * 1000.0 - (j * sub.slide_ms + sub.length_ms)
            )
        if self._dr_lineage is not None:
            # shared pipelines tag the emission with the subscriber's
            # doctor query id, so /queries/<id>/lineage attributes the
            # chain to the right member query
            qids = getattr(self, "_dr_mq_qids", None)
            self._dr_lineage.emitted(
                self._dr_node_id,
                j * sub.slide_ms,
                j * sub.slide_ms + sub.length_ms,
                query=None if qids is None else qids.get(sub.tag),
            )
        return RecordBatch(sub.schema, cols)

    def _output_low_watermark(self, hint_ts: int) -> int:
        lows = []
        for q, sub in enumerate(self._subs):
            lows.append(
                window_output_low_watermark(
                    self._next_win[q],
                    sub.slide_ms,
                    sub.length_ms,
                    hint_ts,
                    wm_ms=self._watermark_ms if self._src_watermarks else None,
                )
            )
        return min(lows)

    # -- checkpointing ----------------------------------------------------
    def enable_checkpointing(self, node_id: str, coord, orch) -> None:
        self._ckpt = (coord, f"slice_{node_id}")
        self._restore()

    def _snapshot(self, epoch: int) -> None:
        from denormalized_tpu_torch.state.serialization import pack_snapshot

        coord, key = self._ckpt
        ngroups = len(self._interner) if self._grouped else 1
        meta = {
            "epoch": epoch,
            "unit_ms": self.unit_ms,
            "next_win": list(self._next_win),
            "watermark_ms": self._watermark_ms,
            "src_watermarks": self._src_watermarks,
            "max_ts": self._max_ts,
            "var_shift": dict(self._var_shift),
            "ngroups": ngroups,
            "interner": self._interner.snapshot() if self._grouped else None,
            # top-k value-id space: ids are first-seen-order dense, so
            # the summaries in the planes are meaningless without it
            "vid_interner": (
                self._vid_interner.snapshot()
                if self._vid_interner is not None
                else None
            ),
            # live-registration payload: per-subscriber identity records
            # (tag + filter signature + join cursor) and the per-class
            # array layout — restore matches cursors by TAG, never by
            # position, so a mid-stream joiner's kill/restore is exact
            "first_ts": self._first_ts,
            "exact_floor_unit": self._exact_floor_unit,
            "departed": sorted(self._departed),
            "classes": [cls.sig for cls in self._classes],
            "class_exact_from": [
                cls.exact_from_unit for cls in self._classes
            ],
            "subs": [
                {
                    "tag": sub.tag,
                    "label": sub.label,
                    "length_ms": sub.length_ms,
                    "slide_ms": sub.slide_ms,
                    "filter_sig": sub.filter_sig,
                    "class_sig": self._sub_class[q].sig,
                    "next_win": self._next_win[q],
                    "first_exact": self._first_exact[q],
                }
                for q, sub in enumerate(self._subs)
            ],
        }
        arrays: dict[str, np.ndarray] = {}
        for ci, cls in enumerate(self._classes):
            for k, arr in cls.store.snapshot_arrays(ngroups).items():
                # class 0 keeps the legacy un-prefixed key space so
                # pre-subsumption snapshots stay restorable
                arrays[k if ci == 0 else f"c{ci}|{k}"] = arr
        coord.put_snapshot(key, epoch, pack_snapshot(meta, arrays))

    def _restore(self) -> None:
        from denormalized_tpu_torch.common.errors import StateError
        from denormalized_tpu_torch.state.serialization import unpack_snapshot

        coord, key = self._ckpt
        blob = coord.get_snapshot(key)
        if blob is None:
            return
        meta, arrays = unpack_snapshot(blob)
        if int(meta["unit_ms"]) != self.unit_ms:
            raise StateError(
                f"slice snapshot unit {meta['unit_ms']}ms does not match "
                f"the plan's {self.unit_ms}ms — the subscriber set changed "
                "incompatibly since the checkpoint"
            )
        self._watermark_ms = meta["watermark_ms"]
        self._src_watermarks = bool(meta.get("src_watermarks"))
        self._max_ts = meta["max_ts"]
        self._var_shift = dict(meta.get("var_shift") or {})
        vsnap = meta.get("vid_interner")
        if vsnap is not None:
            self._vid_interner = GroupInterner.restore(vsnap)
        self._first_ts = meta.get("first_ts")
        efu = meta.get("exact_floor_unit")
        self._exact_floor_unit = None if efu is None else int(efu)
        self._departed = {int(t) for t in meta.get("departed") or ()}
        if self._grouped and meta["interner"] is not None:
            self._interner = GroupInterner.restore(meta["interner"])
            # gid-lane pass bits re-derive lazily from the restored
            # interner on the next batch
            for cls in self._classes:
                cls.gid_pass = np.zeros(0, dtype=bool)
        ngroups = int(meta.get("ngroups") or 1)
        recs = meta.get("subs")
        if recs is None:
            # legacy (pre-live-registration) snapshot: positional
            # cursors, single filter class
            self._next_win = [
                None if v is None else int(v) for v in meta["next_win"]
            ]
            if len(self._next_win) != len(self._subs):
                raise StateError(
                    f"slice snapshot carries {len(self._next_win)} emission "
                    f"cursors but the plan subscribes "
                    f"{len(self._subs)} queries"
                )
            self._store.restore_arrays(arrays, ngroups)
            return
        by_tag = {int(r["tag"]): r for r in recs}
        for q, sub in enumerate(self._subs):
            rec = by_tag.pop(sub.tag, None)
            if rec is None:
                raise StateError(
                    f"slice snapshot has no cursor for subscriber tag "
                    f"{sub.tag} — subscribers present at restore must "
                    "predate the checkpoint (late joiners attach AFTER "
                    "restore and adopt their cursor then)"
                )
            if (
                rec["filter_sig"] != sub.filter_sig
                or int(rec["length_ms"]) != sub.length_ms
                or int(rec["slide_ms"]) != sub.slide_ms
            ):
                raise StateError(
                    f"subscriber tag {sub.tag} does not match its "
                    "snapshot record (filter signature or window spec "
                    "changed since the checkpoint)"
                )
            nw = rec["next_win"]
            self._next_win[q] = None if nw is None else int(nw)
            fe = rec.get("first_exact")
            self._first_exact[q] = None if fe is None else int(fe)
        # cursors of subscribers not in the current plan: retained for
        # adoption when the (replayed) live registration re-attaches
        self._orphans = by_tag
        if by_tag:
            from denormalized_tpu_torch.runtime.tracing import logger

            logger.info(
                "slice restore retained %d orphan cursor(s) awaiting "
                "re-attachment: %s", len(by_tag),
                ", ".join(
                    f"tag {t} ({r.get('label') or 'unlabeled'}, "
                    f"class {r.get('class_sig') or '?'})"
                    for t, r in sorted(by_tag.items())
                ),
            )
        # split arrays back into per-class stores by snapshot class
        # index, matching classes by residual signature
        snap_sigs = [str(s) for s in meta.get("classes") or [""]]
        snap_efu = meta.get("class_exact_from") or [None] * len(snap_sigs)
        per_class: list[dict[str, np.ndarray]] = [
            {} for _ in snap_sigs
        ]
        for k, arr in arrays.items():
            if k.startswith("c") and "|" in k:
                head, rest = k.split("|", 1)
                if head[1:].isdigit() and "|" in rest:
                    per_class[int(head[1:])][rest] = arr
                    continue
            per_class[0][k] = arr
        live_sigs = {cls.sig: cls for cls in self._classes}
        self._orphan_class_arrays = {}
        for ci, sig in enumerate(snap_sigs):
            efu = snap_efu[ci] if ci < len(snap_efu) else None
            efu = None if efu is None else int(efu)
            cls = live_sigs.get(sig)
            if cls is not None:
                cls.store.restore_arrays(per_class[ci], ngroups)
                cls.exact_from_unit = efu
            else:
                # no live subscriber folds this class yet — stash the
                # partials (and the class's exactness floor) for the
                # re-attaching joiner to revive
                self._orphan_class_arrays[sig] = (per_class[ci], ngroups, efu)

    # -- stream loop -----------------------------------------------------
    def run(self) -> Iterator[StreamItem]:
        from denormalized_tpu_torch.runtime.tracing import span

        for item in self._doctor_input():
            if isinstance(item, RecordBatch):
                # dnzlint: allow(unguarded) boundary fast-path peek: truthiness load is atomic and _drain_ops re-checks _pending_ops under _ops_lock; a stale miss just defers the op to the next batch boundary
                if self._pending_ops and item.num_rows:
                    # live attach/detach lands at batch boundaries; ops
                    # carrying an event-time threshold fire exactly when
                    # the stream reaches it (deterministic under replay)
                    up = int(
                        np.asarray(
                            item.column(CANONICAL_TIMESTAMP_COLUMN),
                            dtype=np.int64,
                        ).min()
                    )
                    yield from self._drain_ops(up)
                t0 = time.perf_counter()
                with span(
                    "slice_window.process_batch",
                    op=self.name,
                    rows=item.num_rows,
                ):
                    out = list(self._process_batch(item))
                self._note_batch(t0, item.num_rows)
                yield from out
            elif isinstance(item, WatermarkHint):
                if item.kind == "partition":
                    self._src_watermarks = True
                    if item.is_announcement:
                        yield item
                        continue
                    if (
                        self._watermark_ms is None
                        or item.ts_ms > self._watermark_ms
                    ):
                        self._watermark_ms = item.ts_ms
                        yield from self._trigger()
                    yield WatermarkHint(
                        min(
                            item.ts_ms,
                            self._output_low_watermark(item.ts_ms),
                        ),
                        kind="partition",
                    )
                    continue
                if (
                    self._watermark_ms is None
                    or item.ts_ms > self._watermark_ms
                ):
                    self._watermark_ms = item.ts_ms
                    yield from self._trigger()
                yield WatermarkHint(
                    min(item.ts_ms, self._output_low_watermark(item.ts_ms))
                )
            elif isinstance(item, Marker):
                if self._ckpt is not None:
                    self._snapshot(item.epoch)
                yield item
            elif isinstance(item, EndOfStream):
                yield from self._drain_ops(None)
                if self.emit_on_close and self._max_ts is not None:
                    for q, sub in enumerate(self._subs):
                        nw = self._next_win[q]
                        if nw is None:
                            continue
                        while nw * sub.slide_ms <= self._max_ts:
                            b = self._emit_window(q, nw)
                            nw += 1
                            if b is not None:
                                yield b
                        self._next_win[q] = nw
                yield EOS
                return
