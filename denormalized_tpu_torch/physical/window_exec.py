"""Streaming windowed-aggregation operator — counterpart of
``denormalized_tpu/physical/window_exec.py``.

One operator covers grouped and ungrouped windows (ungrouped is the G=1
degenerate case).  Per input batch (host side, all vectorized):
1. evaluate group-key and value expressions;
2. intern keys → dense int32 group ids (:class:`GroupInterner`);
3. compute each row's slide-index and rebase against ``first_open``;
   rows of already-emitted windows are late and dropped;
4. row shipping: pad to a power-of-two bucket and run the device step on
   the ring (the dense kernel or the scatter program); ``partial_merge``:
   fold the batch (f64) into the backend's host stripe, dropping rows
   behind the watermark, and merge the stripe into the ring before any
   emission, growth or end of stream (see
   :mod:`denormalized_tpu_torch.parallel.sharded_state`);
5. advance the watermark (monotonic max of batch min-timestamps) and emit
   every window whose end ≤ watermark, synchronously: read and reset that
   block of ring slots on the device, finalize, and build the output batch.
   Under ``partial_merge`` emission waits up to ``emit_lag_ms`` so a
   replay-speed feed closes several windows per merge.

Capacity is elastic: group capacity G and ring size W double when the
interner or the event-time skew outgrow them (export, re-lay out, import).

Not ported yet: the cold tier, checkpointing, the host pipeline thread,
emission compaction, watermark hints, asynchronous emission and the
variance aggregates.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from denormalized_tpu_torch.common.constants import (
    CANONICAL_TIMESTAMP_COLUMN,
    WINDOW_END_COLUMN,
    WINDOW_START_COLUMN,
)
from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.logical.expr import (
    AggregateExpr,
    Expr,
    column_validity,
)
from denormalized_tpu_torch.logical.plan import WindowType
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.ops.host_partial import HostPartialStripe
from denormalized_tpu_torch.ops.interner import GroupInterner
from denormalized_tpu_torch.parallel.sharded_state import make_sharded_state
from denormalized_tpu_torch.physical.base import (
    EOS,
    EndOfStream,
    ExecOperator,
    StreamItem,
)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _round_capacity(g: int) -> int:
    """Round a group capacity up to a multiple of 128."""
    return -(-g // 128) * 128


def watermark_floor(wm_ms: int, length_ms: int, slide_ms: int) -> int:
    """First slide index NOT closed by watermark ``wm_ms``."""
    return (wm_ms - length_ms) // slide_ms + 1


class StreamingWindowExec(ExecOperator):
    def __init__(
        self,
        input_op: ExecOperator,
        group_exprs: list[Expr],
        aggr_exprs: list[AggregateExpr],
        window_type: WindowType,
        length_ms: int,
        slide_ms: int | None,
        *,
        device: torch.device | str,
        device_finalize: bool = True,
        min_group_capacity: int = 128,
        min_window_slots: int = 16,
        min_batch_bucket: int = 256,
        device_strategy: str = "auto",
        compensated_sums: bool = False,
        partial_merge_rows: int = 4_000_000,
        emit_lag_ms: int | None = None,
    ) -> None:
        if window_type is WindowType.SESSION:
            raise PlanError(
                "session windows not yet ported to denormalized_tpu_torch"
            )
        self.input_op = input_op
        self.group_exprs = list(group_exprs)
        self.aggr_exprs = list(aggr_exprs)
        self.window_type = window_type
        self.length_ms = int(length_ms)
        self.slide_ms = int(slide_ms) if slide_ms else self.length_ms
        self._min_batch_bucket = min_batch_bucket
        self._device = torch.device(device)

        in_schema = input_op.schema
        # deduped value columns: one device column per distinct agg argument
        self._value_exprs: list[Expr] = []
        keys: dict[str, int] = {}

        def value_idx(e: Expr) -> int:
            k = repr(e)
            if k not in keys:
                keys[k] = len(self._value_exprs)
                self._value_exprs.append(e)
            return keys[k]

        self._agg_specs: list[tuple] = []
        for a in self.aggr_exprs:
            if a.arg is None:
                self._agg_specs.append((a.kind, None))
            else:
                self._agg_specs.append((a.kind, value_idx(a.arg)))
        comps = sa.components_for(self._agg_specs)
        if compensated_sums:
            comps = sa.with_compensation(comps)
        components = tuple(comps)

        self._grouped = len(self.group_exprs) > 0
        self._interner = (
            GroupInterner(len(self.group_exprs)) if self._grouped else None
        )
        self._device_strategy = device_strategy
        self._spec = sa.WindowKernelSpec(
            components=components,
            num_value_cols=len(self._value_exprs),
            window_slots=min_window_slots,
            group_capacity=_round_capacity(
                min_group_capacity if self._grouped else 128
            ),
            length_ms=self.length_ms,
            slide_ms=self.slide_ms,
            compensated=compensated_sums,
        )
        self._backend = make_sharded_state(
            self._spec, self._device, device_strategy
        )
        # on-device finalization: emission ships final output planes + an
        # active mask instead of raw component planes
        self._finals_specs = (
            tuple(self._agg_specs)
            if device_finalize and sa.finals_possible(tuple(self._agg_specs))
            else None
        )
        if self._finals_specs is not None:
            self._backend.prepare_finals(self._finals_specs)

        # schema: group cols + agg cols + window bounds (+ canonical ts)
        fields = [g.out_field(in_schema) for g in self.group_exprs]
        fields += [a.out_field(in_schema) for a in self.aggr_exprs]
        fields += [
            Field(WINDOW_START_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
            Field(WINDOW_END_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
            Field(CANONICAL_TIMESTAMP_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
        ]
        self.schema = Schema(fields)

        # partial_merge pacing: emission waits up to emit_lag_s after a
        # window becomes closable, so a replay-speed feed closes several
        # windows per merge; a real-time feed's stripe is older than the
        # lag when its window closes and emits at once.  None = the JAX
        # package's rule per backend: 0 on the CPU (merges cost a memcpy,
        # and deferral would hold a paused stream's last windows until the
        # next batch), 200 ms on an accelerator
        if emit_lag_ms is None:
            emit_lag_ms = 0 if self._device.type == "cpu" else 200
        self._emit_lag_s = emit_lag_ms / 1000.0
        self._merge_rows = partial_merge_rows
        self._stripe_wall: float | None = None

        # streaming state
        self._first_open: int | None = None  # lowest non-emitted slide index
        self._max_win_seen: int = -1
        self._watermark_ms: int | None = None
        # monotone: True once any value column carried a null.  While
        # False, emission gathers skip per-column count planes (they equal
        # the row-count plane) — see _gather_and_reset(lean=True)
        self._any_nulls_seen = False
        self._metrics = {
            "rows_in": 0,
            "batches_in": 0,
            "late_rows": 0,
            "windows_emitted": 0,
            "device_steps": 0,
            "partial_merges": 0,
            "grow_events": 0,
            "host_prep_s": 0.0,
        }

    # ------------------------------------------------------------------
    @property
    def children(self):
        return [self.input_op]

    @property
    def backend(self):
        """The window-state backend currently holding the ring."""
        return self._backend

    def metrics(self):
        m = dict(self._metrics)
        if self._backend.accumulates_host:
            # merges also happen inside accumulate() (stripe-span
            # overflow): read them off the backend
            m["partial_merges"] = self._backend.merges
            m["device_steps"] = self._backend.merges
        m["bytes_h2d"] = self._backend.bytes_h2d
        m["bytes_d2h"] = self._backend.bytes_d2h
        m["strategy_resolved"] = self._backend.strategy_name
        return m

    # -- state carried across -------------------------------------------
    def load_state(
        self,
        host_state: dict[str, np.ndarray],
        interner_snapshot: dict | None,
        first_open: int | None,
        max_win_seen: int,
        watermark_ms: int | None,
        any_nulls_seen: bool = True,
    ) -> None:
        """Continue from a ring exported by this package or the JAX package
        (``(W, G)`` numpy planes keyed by component label) plus the group
        interner's snapshot and the operator's window bookkeeping."""
        W, G = next(iter(host_state.values())).shape
        self._spec = sa.WindowKernelSpec(
            components=self._spec.components,
            num_value_cols=self._spec.num_value_cols,
            # W stays as carried: a window's slot is its absolute index mod W
            window_slots=int(W),
            group_capacity=_round_capacity(max(int(G), self._spec.group_capacity)),
            length_ms=self.length_ms,
            slide_ms=self.slide_ms,
            accum_dtype=self._spec.accum_dtype,
            compensated=self._spec.compensated,
        )
        self._replace_backend()
        self._backend.import_(host_state)
        if self._grouped and interner_snapshot is not None:
            self._interner = GroupInterner.restore(interner_snapshot)
        self._first_open = first_open
        self._max_win_seen = max_win_seen
        self._watermark_ms = watermark_ms
        self._any_nulls_seen = any_nulls_seen

    def _replace_backend(self) -> None:
        old = self._backend
        self._backend = make_sharded_state(
            self._spec, self._device, self._device_strategy
        )
        # link-traffic and dispatch counters live on the backend instance;
        # a replacement carries them so they cover the whole run
        self._backend.bytes_h2d += old.bytes_h2d
        self._backend.bytes_d2h += old.bytes_d2h
        self._backend.dense_updates += old.dense_updates
        self._backend.scatter_updates += old.scatter_updates
        if self._backend.accumulates_host:
            self._backend.merges += old.merges
            new, prev = self._backend.stripe, old.stripe
            new.native_batches += prev.native_batches
            new.numpy_batches += prev.numpy_batches
            new.reduce_s += prev.reduce_s
            new.pack_s += prev.pack_s
        if self._finals_specs is not None:
            self._backend.prepare_finals(self._finals_specs)

    # -- capacity management --------------------------------------------
    def _grow(self, *, window_slots: int | None = None, group_capacity: int | None = None):
        # host partials are laid out for the old G/W: merge them into the
        # ring before exporting it
        self._backend.flush_pending()
        host = self._backend.export()
        old = self._spec
        self._spec = sa.WindowKernelSpec(
            components=old.components,
            num_value_cols=old.num_value_cols,
            window_slots=window_slots or old.window_slots,
            group_capacity=group_capacity or old.group_capacity,
            length_ms=old.length_ms,
            slide_ms=old.slide_ms,
            accum_dtype=old.accum_dtype,
            compensated=old.compensated,
        )
        if window_slots and self._first_open is not None:
            # ring phase changes with W: re-lay out slots by absolute window
            # index.  Only windows the old ring could actually hold are live.
            hi = min(self._max_win_seen, self._first_open + old.window_slots - 1)
            remapped = {}
            for c in self._spec.components:
                buf = host[c.label]
                nbuf = np.full(
                    (self._spec.window_slots, self._spec.group_capacity),
                    self._spec.init_value(c),
                    dtype=buf.dtype,
                )
                for j in range(self._first_open, hi + 1):
                    nbuf[j % self._spec.window_slots, : buf.shape[1]] = buf[
                        j % old.window_slots
                    ]
                remapped[c.label] = nbuf
            host = remapped
        self._replace_backend()
        self._backend.import_(host)
        self._metrics["grow_events"] += 1

    def _ensure_capacity(self, max_win_rel: int):
        cap = self._backend.group_capacity
        if self._grouped and len(self._interner) > 0.9 * cap:
            self._grow(
                group_capacity=_round_capacity(
                    _next_pow2(int(len(self._interner) * 2))
                )
            )
        if max_win_rel >= self._spec.window_slots:
            self._grow(window_slots=_next_pow2(max_win_rel + 2))

    # -- per-batch processing -------------------------------------------
    def _process_batch(self, batch: RecordBatch) -> Iterator[RecordBatch]:
        t0 = time.perf_counter()
        n = batch.num_rows
        if n == 0:
            return
        self._metrics["rows_in"] += n
        self._metrics["batches_in"] += 1
        S = self.slide_ms
        ts = np.asarray(batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64)
        units, rem64 = np.divmod(ts, S)  # one pass for quotient+remainder
        rem = rem64.astype(np.int32)

        if self._first_open is None:
            # windows overlapping the first data: back to units.min() - k + 1
            self._first_open = int(units.min()) - self._spec.length_units + 1
        first = self._first_open
        win_rel64 = units - first
        self._max_win_seen = max(self._max_win_seen, int(units.max()))
        late = int((win_rel64 < 0).sum())
        if late:
            self._metrics["late_rows"] += late

        # group ids — intern BEFORE the capacity check so G always covers
        # every id this batch scatters
        if self._grouped:
            key_cols = [g.eval(batch) for g in self.group_exprs]
            gid = self._interner.intern(key_cols)
        else:
            gid = np.zeros(n, dtype=np.int32)
        self._ensure_capacity(int(win_rel64.max()))

        # value matrix + per-column validity: f64 when the backend
        # accumulates on the host (the stripe keeps f64), else f32 (what
        # the ring accumulates)
        V = self._spec.num_value_cols
        host_dtype = (
            np.float64 if self._backend.accumulates_host else np.float32
        )
        values = np.zeros((n, max(V, 1)), dtype=host_dtype)
        colvalid = np.ones((n, max(V, 1)), dtype=bool)
        any_invalid = False
        for j, e in enumerate(self._value_exprs):
            values[:, j] = e.eval(batch)
            m = column_validity(e, batch)
            if m is not None:
                colvalid[:, j] = m
                any_invalid = any_invalid or not m.all()
        if any_invalid:
            self._any_nulls_seen = True

        if self._backend.accumulates_host:
            yield from self._accumulate(
                t0, units, win_rel64, late, rem, gid, values,
                colvalid if any_invalid else None,
            )
        else:
            self._ship_rows(t0, n, first, win_rel64, rem, gid, values,
                            colvalid)

        # watermark: monotonic max of batch min-ts (reference semantics)
        bmin = int(ts.min())
        if self._watermark_ms is None or bmin > self._watermark_ms:
            self._watermark_ms = bmin
        yield from self._trigger()

    def _ship_rows(self, t0, n, first, win_rel64, rem, gid, values, colvalid):
        """Row shipping: pad the batch to a pow2 bucket and run one device
        step on it."""
        win_rel = np.clip(win_rel64, -1, self._spec.window_slots).astype(np.int32)
        # pad to a pow2 bucket: padding rows are invalid (row_valid False)
        Bp = max(self._min_batch_bucket, _next_pow2(n))
        row_valid = np.zeros(Bp, dtype=bool)
        row_valid[:n] = True

        def pad(a, fill=0):
            if a.shape[0] == Bp:
                return a
            out = np.full((Bp,) + a.shape[1:], fill, dtype=a.dtype)
            out[:n] = a
            return out

        on_time = win_rel64 >= 0
        self._metrics["host_prep_s"] += time.perf_counter() - t0
        self._backend.update(
            pad(values),
            pad(colvalid),
            pad(win_rel, fill=-1),
            pad(rem),
            pad(gid),
            row_valid,
            first % self._spec.window_slots,
            # span of the ON-TIME rows only: late rows are dropped by both
            # kernels and must not widen the dense-path span
            min_win_rel=int(win_rel64[on_time].min()) if on_time.any() else 0,
            max_win_rel=int(win_rel64.max()),
        )
        self._metrics["device_steps"] += 1

    def _accumulate(self, t0, units, win_rel64, late, rem, gid, values64,
                    colvalid) -> Iterator[RecordBatch]:
        """partial_merge: fold the batch into the host stripe; the device
        sees it at the next merge.  Rows are dropped against the
        WATERMARK (windows already closable), not first_open, so emission
        deferral cannot make drop semantics depend on the wall clock —
        this is where the row-shipping path's first_open would sit, since
        it emits every closable window at once."""
        first = self._first_open
        keep = None
        closable_pre = self._closable()
        if late or closable_pre:
            keep = win_rel64 >= closable_pre
            if closable_pre and self._spec.length_units > 1:
                # a kept row's unit partial feeds EVERY window holding that
                # unit, closable (deferred) ones included, and the stripe
                # cannot take it back per window: freeze-then-accumulate —
                # emit every closable window now, then rebase against the
                # advanced first_open.  Only rows behind the watermark can
                # straddle, so a sorted feed never takes this path
                lows = win_rel64 - (self._spec.length_units - 1)
                if bool((keep & (lows < closable_pre)).any()):
                    yield from self._trigger(force=True)
                    first = self._first_open
                    win_rel64 = units - first
                    closable_pre = self._closable()  # 0 after emission
                    keep = win_rel64 >= closable_pre
            n_drop = int((~keep).sum())
            if n_drop:
                self._metrics["late_rows"] += n_drop - late
            else:
                keep = None
        if self._backend.pending_rows == 0:
            self._stripe_wall = time.perf_counter()
        self._backend.accumulate(
            win_rel64, rem, gid, values64, colvalid, keep,
            first % self._spec.window_slots,
        )
        self._metrics["host_prep_s"] += time.perf_counter() - t0

    # -- emission --------------------------------------------------------
    def _closable(self) -> int:
        if self._watermark_ms is None or self._first_open is None:
            return 0
        wm_win = watermark_floor(
            self._watermark_ms, self.length_ms, self.slide_ms
        )
        return max(0, int(wm_win) - self._first_open)

    def _trigger(self, force: bool = False) -> Iterator[RecordBatch]:
        """Emit every window whose end ≤ watermark (trigger_windows,
        grouped_window_agg_stream.rs:220-253), synchronously.

        With a host-accumulating backend the stripe is merged first, and
        emission waits up to ``emit_lag_ms`` after the stripe began, while
        it stays under ``partial_merge_rows`` and can take another slide
        unit.  ``force`` skips the wait: ingest uses it to freeze closable
        windows before a batch whose rows would otherwise leak into
        them."""
        n_close = self._closable()
        if self._backend.accumulates_host:
            if n_close == 0:
                if self._backend.pending_rows >= self._merge_rows:
                    self._backend.flush_pending()
                return
            age = time.perf_counter() - (self._stripe_wall or 0.0)
            if (
                not force
                and age < self._emit_lag_s
                and self._backend.pending_rows < self._merge_rows
                and self._stripe_fits_more()
            ):
                return
            self._backend.flush_pending()
        while n_close > 0:
            # pow2 block sizes, as in the JAX package's program ladder
            n = 1 << min(3, (n_close).bit_length() - 1)
            n = min(n, self._spec.window_slots)
            live = len(self._interner) if self._grouped else 1
            first_slot = self._first_open % self._spec.window_slots
            block = self._backend.read_reset_block_finals(
                first_slot, n, live_groups=live
            )
            if block is not None:
                yield from self._emit_finals_block(self._first_open, n, block)
            else:
                block = self._backend.read_reset_block(
                    first_slot, n, live_groups=live,
                    lean=(
                        not self._any_nulls_seen
                        and sa.lean_possible(self._spec)
                    ),
                )
                yield from self._emit_component_block(self._first_open, n, block)
            self._first_open += n
            n_close -= n

    def _stripe_fits_more(self) -> bool:
        """Can the stripe still take the next slide unit without
        overflowing its span?  (Else wait no longer: merge and emit.)"""
        span_now = self._max_win_seen - self._first_open + 1
        return span_now + 1 < HostPartialStripe.U_MAX

    def _emit_finals_block(self, j0: int, n: int, block) -> Iterator[RecordBatch]:
        """Finals block: one plane per output aggregate + the active mask;
        no host-side finalize needed."""
        ngroups = len(self._interner) if self._grouped else 1
        mask = block[sa.ACTIVE_MASK]
        for i in range(n):
            active = mask[i].copy()
            active[ngroups:] = False
            if not active.any():
                continue
            gids = np.nonzero(active)[0].astype(np.int32)
            finals = [
                block[f"__final_{k}__"][i][gids]
                for k in range(len(self.aggr_exprs))
            ]
            self._metrics["windows_emitted"] += 1
            yield self._assemble_emission(j0 + i, gids, finals)

    def _emit_component_block(self, j0: int, n: int, block) -> Iterator[RecordBatch]:
        # lean gathers omit per-column count planes (null-free stream:
        # they equal the row-count plane) — alias them back
        for c in self._spec.components:
            if c.kind == "count" and c.label not in block:
                block[c.label] = block[sa.ROW_COUNT.label]
        for i in range(n):
            b = self._finalize_rows(
                j0 + i, {label: arr[i] for label, arr in block.items()}
            )
            if b is not None:
                yield b

    def _emit_window(self, j: int) -> RecordBatch | None:
        slot = j % self._spec.window_slots
        rows = self._backend.read_slot(slot)
        self._backend.reset_slot(slot)
        return self._finalize_rows(j, rows)

    def _finalize_rows(self, j: int, rows: dict) -> RecordBatch | None:
        """Finalize one window's component planes into an emission batch."""
        counts = rows[sa.ROW_COUNT.label]
        ngroups = len(self._interner) if self._grouped else 1
        active = counts > 0
        active[ngroups:] = False
        if not active.any():
            return None
        self._metrics["windows_emitted"] += 1
        gids = np.nonzero(active)[0].astype(np.int32)
        return self._assemble_emission(
            j, gids, sa.finalize(self._agg_specs, rows, active)
        )

    def _assemble_emission(
        self, j: int, gids: np.ndarray, finals: list
    ) -> RecordBatch:
        """Group-key columns from the interner, finalized aggregate columns
        (cast to output dtypes), window bounds + canonical timestamp."""
        cols: list[np.ndarray] = []
        if self._grouped:
            key_vals = self._interner.keys_of(gids)
            for g, kv in zip(self.group_exprs, key_vals):
                f = g.out_field(self.input_op.schema)
                if f.dtype.is_numeric:
                    kv = np.asarray(kv.tolist(), dtype=f.dtype.to_numpy())
                cols.append(kv)
        for a, arr in zip(self.aggr_exprs, finals):
            f = a.out_field(self.input_op.schema)
            cols.append(np.asarray(arr).astype(f.dtype.to_numpy()))
        m = len(gids)
        start = np.full(m, j * self.slide_ms, dtype=np.int64)
        end = np.full(m, j * self.slide_ms + self.length_ms, dtype=np.int64)
        cols += [start, end, start.copy()]
        return RecordBatch(self.schema, cols)

    # -- stream loop -----------------------------------------------------
    def run(self) -> Iterator[StreamItem]:
        for item in self.input_op.run():
            if isinstance(item, RecordBatch):
                yield from list(self._process_batch(item))
            elif isinstance(item, EndOfStream):
                # bounded input: merge the stripe, flush every open window
                if self._first_open is not None:
                    self._backend.flush_pending()
                    for j in range(self._first_open, self._max_win_seen + 1):
                        b = self._emit_window(j)
                        if b is not None:
                            yield b
                    self._first_open = self._max_win_seen + 1
                yield EOS
                return
