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
   every window whose end ≤ watermark: read and reset that block of ring
   slots on the device, copy it to the host on a side stream, finalize, and
   build the output batch.  Row shipping drains each block in the trigger
   that read it; under ``partial_merge`` with a non-zero ``emit_lag_ms``
   the drain waits for the NEXT trigger, so the copy overlaps ingest, and
   emission waits up to ``emit_lag_ms`` so a replay-speed feed closes
   several windows per merge.  With ``emission_compaction`` each window is
   read alone through the compaction kernel: only its active groups (a
   power-of-two prefix of them) cross to the host.

Options: ``emit_on_close`` (False: end of stream emits only the windows
the watermark closed, not every open one), ``accum_dtype`` (float32 or
float64 rings; float64 row shipping takes the scatter path, the dense
kernel being f32 only), the variance
family (``stddev``/``var`` and their ``_pop`` forms: two value columns a
variance argument, (x−K) and (x−K)² for a pivot K taken from the first
finite value seen, finalized on the host in f64), and ``host_pipeline``
(``partial_merge``: the native reduction of batch N runs on a worker thread
while the main thread evaluates and interns batch N+1, launching any merge
on the operator's own CUDA stream; every other backend access fences on
the worker first, and a worker's failure surfaces at the next fence).

Watermark hints: after a ``kind="partition"`` :class:`WatermarkHint` (a
join announces that mode before its first output) batch minima no longer
advance the watermark, only hints do, and a batch whose windows lie below
``first_open`` but not below the watermark rebases ``first_open`` down
instead of late-dropping them.  Each hint is forwarded clamped below the
start of any window this operator can still emit (emissions are stamped
with the window start), so an operator above does not late-drop them.

Capacity is elastic: group capacity G and ring size W double when the
interner or the event-time skew outgrow them (export, re-lay out, import).

Observability: the operator binds ``op="window"`` instruments (rows in,
batch time, input wait, late rows, windows emitted, emission and
watermark lag) and a state watch fed the batch's gids at intern time.
``state_info()`` derives the ring's bytes from the kernel spec, so an
exporter's or the doctor's thread never reads a tensor.

Checkpointing: on a :class:`Marker` the operator merges the host stripe,
starts an export of the ring that later in-place updates cannot change
(``export_start``: a device clone copied to the host on a side stream),
captures its host bookkeeping and holds the marker; the next item's device
work is queued, then the export is awaited, packed and written under the
marker's epoch, and the marker released before any output of that item.
Restore rebuilds the backend for the snapshot's W and G and imports the
ring onto the engine's device.

Cold tier (``enable_spill``, wired by ``state/tiering.py::attach_spill``
under ``EngineConfig.state_budget_bytes``): :class:`_WindowTier` moves the
oldest watermark-deferred windows' slots off the card into the LSM, and
brings them back when rows land in them; a spilled window the watermark
closes emits from its stored planes, finalized on the host.
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
from denormalized_tpu_torch.common.errors import PlanError, StateError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.logical.expr import (
    VAR_KINDS,
    AggregateExpr,
    Expr,
    column_validity,
)
from denormalized_tpu_torch.logical.plan import WindowType
from denormalized_tpu_torch.obs import statewatch
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.ops.host_partial import HostPartialStripe
from denormalized_tpu_torch.ops.interner import GroupInterner
from denormalized_tpu_torch.parallel.sharded_state import make_sharded_state
from denormalized_tpu_torch.physical.base import (
    EOS,
    EndOfStream,
    ExecOperator,
    Marker,
    StreamItem,
    WatermarkHint,
)
from denormalized_tpu_torch.runtime.tracing import logger, span
from denormalized_tpu_torch.state import tiering
from denormalized_tpu_torch.state.serialization import (
    pack_snapshot,
    unpack_snapshot,
)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _round_capacity(g: int, n_dev: int = 1) -> int:
    """Round a group capacity up so every shard is a multiple of 128 lanes
    (and the total divides evenly over the mesh)."""
    unit = 128 * n_dev
    return -(-g // unit) * unit


def watermark_floor(wm_ms: int, length_ms: int, slide_ms: int) -> int:
    """First slide index NOT closed by watermark ``wm_ms``."""
    return (wm_ms - length_ms) // slide_ms + 1


def window_output_low_watermark(
    first_open: int | None, slide_ms: int, length_ms: int, hint_ts: int,
    wm_ms: int | None = None,
) -> int:
    """Strict lower bound (minus one) on the start of any window the
    operator can still emit, given no further input rows at or before
    ``hint_ts``.  With open windows that is the first open slot's start;
    with none, the earliest window a future row (> hint_ts) could land in.

    Under hint-driven watermarks ``first_open`` is NOT monotone (a batch of
    older windows may rebase it down to the watermark floor), so pass
    ``wm_ms`` and the bound uses min(first_open, floor)."""
    if first_open is not None:
        low_first = first_open
        if wm_ms is not None:
            low_first = min(
                low_first, watermark_floor(wm_ms, length_ms, slide_ms)
            )
        return low_first * slide_ms - 1
    min_future_start = ((hint_ts + 1 - length_ms) // slide_ms + 1) * slide_ms
    return min_future_start - 1


def _ring_bytes(spec: sa.WindowKernelSpec, windows: int) -> int:
    """The JAX package's charge for ``windows`` ring slots: every component
    plane at the accumulator dtype's item size (the int32 count planes
    included).  The item size comes from the torch dtype: a float64 ring
    is charged 8 bytes a cell, as the JAX package charges its x64 ring."""
    return (
        len(spec.components) * windows * spec.group_capacity
        * spec.accum_dtype.itemsize
    )


class _WindowTier:
    """Cold tier of one window operator: spills the OLDEST contiguous
    prefix of open-but-not-closable windows (watermark-deferred frames
    whose rows have stopped arriving) off the card into the LSM, then
    advances ``first_open`` past them so the ring stops reserving slots for
    the skew span.  A spilled window

    - emits from its stored planes when the watermark closes it, through
      the host finalize (``_finalize_rows``);
    - reloads into the ring — ``first_open`` lowers back, as in the
      hint-driven rebase — when a batch lands rows in it, so drop semantics
      match the all-resident run; only the reloaded slots are written on
      the card (one indexed copy a plane, ``write_slots``);
    - rides checkpoints as an epoch-referenced block.

    Invariant: every spilled window lies strictly below ``first_open``.
    When the resident span allows, the ring rebuilds at a smaller W."""

    __slots__ = (
        "op", "node_id", "ctrl", "any_spilled", "spilled_bytes",
        "_blocks", "_next", "reload_ms", "emitted",
    )

    def __init__(self, op: "StreamingWindowExec", node_id: str, ctrl) -> None:
        self.op = op
        self.node_id = node_id
        self.ctrl = ctrl
        self.any_spilled = False
        self.spilled_bytes = 0
        self._blocks: dict[int, dict] = {}  # window index -> meta
        self._next = 0
        # host wall of each reload (LSM reads, unpack, slot writes queued)
        self.reload_ms: list[float] = []
        self.emitted = 0  # windows emitted from their stored planes
        ctrl.register(node_id, op, self.resident_bytes)

    def resident_bytes(self) -> int:
        op = self.op
        keys = len(op._interner) if op._interner is not None else 1
        return (
            _ring_bytes(op._spec, op._spec.window_slots)
            + keys * statewatch.KEY_EST_BYTES
        )

    # -- touch / reload ---------------------------------------------------
    def touch_and_reload(self, lo_win: int, hi_win: int) -> None:
        """Reload every spilled window the incoming batch's rows can land
        in (windows [lo_win, hi_win]) BEFORE the operator computes its
        rows' ring offsets — else they would read as late and drop.
        Reloading lowers ``first_open`` to the lowest touched window, so
        every spilled window above it comes back too (the invariant), as
        does one a hint-driven rebase left at or above ``first_open``."""
        if not self.any_spilled:
            return
        first = self.op._first_open
        due = [j for j in self._blocks if lo_win <= j <= hi_win or j >= first]
        if not due:
            return
        lo = min(due)
        self._reload(sorted(j for j in self._blocks if j >= lo))
        self._write_manifest()

    def _reload(self, js: list[int]) -> None:
        t0 = time.perf_counter()  # dnzlint: allow(replay-impure) reload_ms, observability only: the time never feeds a plane
        op = self.op
        op._flush()
        new_first = min(min(js), op._first_open)
        # ring capacity must cover [new_first, max_win_seen] BEFORE the base
        # lowers: _grow attributes slots to windows from first_open up
        op._ensure_capacity(op._max_win_seen - new_first)
        op._first_open = new_first
        planes = []
        for j in js:
            meta = self._blocks.pop(j)
            raw = self.ctrl.get_block(self.node_id, meta["id"])
            planes.append(unpack_snapshot(raw)[1])
            self.spilled_bytes -= meta["bytes"]
            self.ctrl.note_reload(self.node_id, 1, len(raw))
            self.ctrl.delete_block(self.node_id, meta["id"])
        op._write_windows(js, planes)
        self.any_spilled = bool(self._blocks)
        op._state_info_cache = None
        self.reload_ms.append((time.perf_counter() - t0) * 1e3)  # dnzlint: allow(replay-impure) reload_ms, observability only

    # -- eviction ---------------------------------------------------------
    def maybe_spill(self, hot_lo_win: int) -> None:
        """Spill the prefix [first_open, min(hot_lo_win, …)) when over
        budget — the windows old enough that the current batch no longer
        feeds them.  Runs AFTER the trigger, so closable windows have
        already emitted and the prefix is genuinely deferred-open."""
        need = self.ctrl.over_budget()
        if need <= 0:
            self.ctrl.relax(self.node_id)
            return
        op = self.op
        spec = op._spec
        if op._first_open is not None:
            per_window = max(_ring_bytes(spec, 1), 1)
            hi = min(int(hot_lo_win), op._max_win_seen + 1)
            cut = min(op._first_open + -(-need // per_window), hi)
            if cut > op._first_open:
                # the stripe holds rows of these windows: merge it first
                # (under partial_merge a launch of the merge kernel)
                op._flush()
                spilled_any = False
                W = spec.window_slots
                for j in range(op._first_open, cut):
                    # read_slot is a blocking copy to fresh host memory,
                    # ordered after the merge on the kernels' stream; the
                    # block is durable before reset_slot is queued
                    rows = op._backend.read_slot(j % W)
                    block_id = f"w{self._next}"
                    blob = pack_snapshot({"window": int(j)}, rows)
                    try:
                        nbytes = self.ctrl.put_block(
                            self.node_id, block_id, blob
                        )
                    except StateError as e:
                        logger.warning(
                            "spill: window eviction put failed (%s) — "
                            "window %d stays resident this pass", e, j,
                        )
                        break
                    self._next += 1
                    op._backend.reset_slot(j % W)
                    self._blocks[j] = {"id": block_id, "bytes": nbytes}
                    self.spilled_bytes += nbytes
                    self.ctrl.note_spill(self.node_id, 1, nbytes)
                    op._first_open = j + 1
                    self.any_spilled = True
                    spilled_any = True
                if spilled_any:
                    self._write_manifest()
                    self._maybe_shrink()
                    op._state_info_cache = None
                    tiering.release_freed_memory()
        self.ctrl.check_pressure(self.node_id)

    def _maybe_shrink(self) -> None:
        """Rebuild the ring at a smaller W once the resident span allows it
        — the allocation shrink (spilling alone frees slots logically)."""
        op = self.op
        span = max(op._max_win_seen - op._first_open + 2, 1)
        new_w = max(_next_pow2(span), 16)
        if new_w < op._spec.window_slots:
            op._grow(window_slots=new_w)

    # -- emission ---------------------------------------------------------
    def due_windows(self, wm_floor: int) -> list[int]:
        """Spilled windows the watermark has closed, ascending — they emit
        before any ring emission of the same trigger (ascending-window
        output order)."""
        if not self.any_spilled:
            return []
        return sorted(j for j in self._blocks if j < wm_floor)

    def emit_rows(self, j: int) -> dict:
        """Load and drop one due window's component planes."""
        meta = self._blocks.pop(j)
        raw = self.ctrl.get_block(self.node_id, meta["id"])
        arrays = unpack_snapshot(raw)[1]
        self.spilled_bytes -= meta["bytes"]
        self.any_spilled = bool(self._blocks)
        self.ctrl.note_reload(self.node_id, 1, len(raw))
        self.ctrl.delete_block(self.node_id, meta["id"])
        self._write_manifest()
        self.emitted += 1
        return arrays

    def _write_manifest(self) -> None:
        self.ctrl.write_manifest(
            self.node_id, [m["id"] for m in self._blocks.values()]
        )

    def info(self) -> dict:
        return {
            "spilled_bytes": self.spilled_bytes,
            "spilled_keys": 0,
            "spilled_blocks": len(self._blocks),
            "spilled_windows": sorted(self._blocks),
            "windows_emitted_from_store": self.emitted,
            "spill": self.ctrl.spill_stats(self.node_id),
        }

    # -- checkpoint integration -------------------------------------------
    def snapshot_refs(self, coord, key: str, epoch: int) -> dict:
        refs = {}
        for j in sorted(self._blocks):
            meta = self._blocks[j]
            self.ctrl.copy_block_to_epoch(
                coord, key, epoch, self.node_id, meta["id"]
            )
            refs[str(j)] = meta["id"]
        return refs

    def restore_refs(self, coord, key: str, refs: dict) -> None:
        for j_str, block_id in refs.items():
            raw = self.ctrl.restore_block_from_epoch(
                coord, key, self.node_id, block_id
            )
            self._blocks[int(j_str)] = {"id": block_id, "bytes": len(raw)}
            self.spilled_bytes += len(raw)
            self._next = max(self._next, int(block_id[1:]) + 1)
        self.any_spilled = bool(self._blocks)
        self._write_manifest()


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
        accum_dtype: torch.dtype = torch.float32,
        emission_compaction: bool = False,
        device_finalize: bool = True,
        min_group_capacity: int = 128,
        min_window_slots: int = 16,
        min_batch_bucket: int = 256,
        device_strategy: str = "auto",
        compensated_sums: bool = False,
        partial_merge_rows: int = 4_000_000,
        emit_lag_ms: int | None = None,
        host_pipeline: bool = False,
        emit_on_close: bool = True,
        mesh=None,
        shard_strategy: str = "auto",
    ) -> None:
        if window_type is WindowType.SESSION:
            raise PlanError(
                "session windows are handled by SessionWindowExec"
            )
        self.emit_on_close = emit_on_close
        self.input_op = input_op
        self.group_exprs = list(group_exprs)
        self.aggr_exprs = list(aggr_exprs)
        self.window_type = window_type
        self.length_ms = int(length_ms)
        self.slide_ms = int(slide_ms) if slide_ms else self.length_ms
        self._min_batch_bucket = min_batch_bucket
        self._device = torch.device(device)
        if accum_dtype not in (torch.float32, torch.float64):
            raise PlanError(
                f"accum_dtype must be torch.float32 or torch.float64, got "
                f"{accum_dtype!r}"
            )

        in_schema = input_op.schema
        # deduped value columns: one device column per distinct agg argument
        self._value_exprs: list[Expr] = []
        keys: dict[str, int] = {}

        def value_idx(e: Expr) -> int:
            k = repr(e)
            if k not in keys:
                keys[k] = len(self._value_exprs)
                self._value_exprs.append(e)
                self._value_transforms.append(None)
            return keys[k]

        # variance columns are SHIFTED on the host by a pivot K picked from
        # the first data (see segment_agg.variance_result): transforms[j]
        # is None | "shift" | "shift_sq", and _var_shift maps the source
        # expression's repr to its pivot (checkpointed with the operator)
        self._value_transforms: list[str | None] = []
        self._var_shift: dict[str, float] = {}

        def shifted_idx(e: Expr, transform: str) -> int:
            k = (transform, repr(e))
            if k not in keys:
                keys[k] = len(self._value_exprs)
                self._value_exprs.append(e)
                self._value_transforms.append(transform)
            return keys[k]

        self._agg_specs: list[tuple] = []
        for a in self.aggr_exprs:
            if a.arg is None:
                self._agg_specs.append((a.kind, None))
            elif a.kind in VAR_KINDS:
                self._agg_specs.append((
                    a.kind,
                    shifted_idx(a.arg, "shift"),
                    shifted_idx(a.arg, "shift_sq"),
                ))
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
        self._mesh = mesh
        self._shard_strategy = shard_strategy
        self._spec = sa.WindowKernelSpec(
            components=components,
            num_value_cols=len(self._value_exprs),
            window_slots=min_window_slots,
            group_capacity=_round_capacity(
                min_group_capacity if self._grouped else 128, self._n_dev
            ),
            length_ms=self.length_ms,
            slide_ms=self.slide_ms,
            accum_dtype=accum_dtype,
            compensated=compensated_sums,
        )
        self._backend = make_sharded_state(
            self._spec, self._device, device_strategy, mesh, shard_strategy
        )
        self._emission_compaction = emission_compaction
        # on-device finalization: emission ships final output planes + an
        # active mask instead of raw component planes.  Compaction takes
        # its own trigger branch, which reads component planes
        self._finals_specs = (
            tuple(self._agg_specs)
            if device_finalize
            and not emission_compaction
            and sa.finals_possible(tuple(self._agg_specs))
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
        # emission blocks dispatched but not yet drained:
        # (first window, n, handle, is_finals)
        self._pending_emit: list[tuple] = []
        # host pipeline (partial_merge): backend.accumulate runs on ONE
        # worker thread (the native reduction releases the interpreter
        # lock), so batch N's reduction overlaps batch N+1's host prep; the
        # single worker keeps stripe mutation serialized, and _join_acc()
        # fences before any other backend access
        self._host_pipeline = host_pipeline
        self._acc_exec = None
        self._acc_future = None
        self._acc_error: BaseException | None = None

        # streaming state
        self._first_open: int | None = None  # lowest non-emitted slide index
        self._max_win_seen: int = -1
        self._watermark_ms: int | None = None
        # True once a kind="partition" WatermarkHint arrived: batch min-ts
        # no longer advances the watermark
        self._src_watermarks = False
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
            # emission blocks read, and those drained a trigger later
            "emit_blocks": 0,
            "emit_blocks_deferred": 0,
            # checkpoints: snapshots written, their packed bytes, and the
            # host's time waiting for the export, packing, and writing
            # (frame + CRC + LSM put)
            "snapshots": 0,
            "snapshot_bytes": 0,
            "snapshot_wait_s": 0.0,
            "snapshot_pack_s": 0.0,
            "snapshot_put_s": 0.0,
        }
        # checkpointing (enable_checkpointing): (coordinator, state key),
        # the snapshot whose export is in flight, and the marker it holds
        self._ckpt: tuple | None = None
        self._pending_snapshot: tuple | None = None
        self._held_marker: Marker | None = None
        # cold tier (state/tiering.py): set by enable_spill
        self._tier: _WindowTier | None = None
        # registry instruments, bound once under the query's registry so
        # the per-batch path is attribute adds only (falsy NULLs with
        # metrics off)
        from denormalized_tpu_torch import obs

        self.bind_obs("window")
        # the host pipeline's worker binds into the registry this
        # operator was built under, not the process default
        self._obs_reg = obs.current_registry()
        # state observatory sketches, fed the batch's dense gids on the
        # host right after intern time
        self._sw = statewatch.make_watch("window")
        self._obs_late = obs.counter("dnz_late_rows_total", op="window")
        self._obs_windows = obs.counter(
            "dnz_windows_emitted_total", op="window"
        )
        self._obs_emit_lag = obs.histogram(
            "dnz_emit_event_lag_ms", op="window"
        )
        self._obs_wm_lag = obs.gauge("dnz_watermark_lag_ms", op="window")
        self._obs_wm_lag_hist = obs.histogram(
            "dnz_watermark_lag_hist_ms", op="window"
        )

    # ------------------------------------------------------------------
    @property
    def children(self):
        return [self.input_op]

    @property
    def backend(self):
        """The window-state backend currently holding the ring."""
        return self._backend

    @property
    def _n_dev(self) -> int:
        """Shards of the mesh (1 without one)."""
        return 1 if self._mesh is None else self._mesh.size

    def _label(self):
        w = f"{self.window_type.value} {self.length_ms}ms"
        if self.slide_ms != self.length_ms:
            w += f"/{self.slide_ms}ms"
        return (
            f"StreamingWindowExec({w}, groups=[{', '.join(g.name for g in self.group_exprs)}], "
            f"aggs=[{', '.join(a.name for a in self.aggr_exprs)}])"
        )

    # -- cold tier (state/tiering.py) -----------------------------------
    def enable_spill(self, node_id: str, controller) -> None:
        self._tier = _WindowTier(self, node_id, controller)

    def state_info(self) -> dict:
        """The JAX operator's accounting: the ring is a dense allocation,
        so its footprint is the component-plane volume whatever the
        occupancy, plus the per-key estimate; with a cold tier, its spilled
        windows, bytes and stats."""
        spec = self._spec
        device_bytes = _ring_bytes(spec, spec.window_slots)
        live_keys = (
            len(self._interner) if self._interner is not None
            else (1 if self._first_open is not None else 0)
        )
        open_windows = (
            max(0, self._max_win_seen - self._first_open + 1)
            if self._first_open is not None
            else 0
        )
        oldest = (
            self._first_open * self.slide_ms
            if self._first_open is not None and open_windows
            else None
        )
        wm = self._watermark_ms
        info = {
            "op": "window",
            "state_bytes": device_bytes + live_keys * statewatch.KEY_EST_BYTES,
            "device_state_bytes": device_bytes,
            "live_keys": live_keys,
            "slot_capacity": int(spec.group_capacity),
            "slot_live": live_keys,
            "open_windows": open_windows,
            "window_slots": int(spec.window_slots),
            "retention_unit_ms": self.length_ms,
            "oldest_event_ms": oldest,
            "watermark_ms": wm,
        }
        if wm is not None and oldest is not None:
            info["oldest_event_lag_ms"] = max(0, int(wm) - int(oldest))
        if self._tier is not None:
            info.update(self._tier.info())
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
        var_shift: dict | None = None,
    ) -> None:
        """Continue from a ring exported by this package or the JAX package
        (``(W, G)`` numpy planes keyed by component label) plus the group
        interner's snapshot, the operator's window bookkeeping and the
        variance pivots the ring's shifted sums were taken under."""
        self._join_acc()
        W, G = next(iter(host_state.values())).shape
        self._spec = sa.WindowKernelSpec(
            components=self._spec.components,
            num_value_cols=self._spec.num_value_cols,
            # W stays as carried: a window's slot is its absolute index mod W
            window_slots=int(W),
            group_capacity=_round_capacity(
                max(int(G), self._spec.group_capacity), self._n_dev
            ),
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
        self._var_shift = dict(var_shift or {})

    def _replace_backend(self) -> None:
        old = self._backend
        self._backend = make_sharded_state(
            self._spec, self._device, self._device_strategy, self._mesh,
            self._shard_strategy,
        )
        # link-traffic and dispatch counters (per shard on a mesh) live on
        # the backend instance; a replacement carries them so they cover
        # the whole run
        self._backend.carry_counters(old)
        if self._finals_specs is not None:
            self._backend.prepare_finals(self._finals_specs)

    # -- capacity management --------------------------------------------
    def _grow(self, *, window_slots: int | None = None, group_capacity: int | None = None):
        # host partials are laid out for the old G/W: merge them into the
        # ring before exporting it
        self._flush()
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
                    _next_pow2(int(len(self._interner) * 2)), self._n_dev
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
        self._obs_rows_in.add(n)
        S = self.slide_ms
        ts = np.asarray(batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64)
        units, rem64 = np.divmod(ts, S)  # one pass for quotient+remainder
        rem = rem64.astype(np.int32)

        if self._first_open is None:
            # windows overlapping the first data: back to units.min() - k + 1
            self._first_open = int(units.min()) - self._spec.length_units + 1
        elif self._src_watermarks:
            anchor = int(units.min()) - self._spec.length_units + 1
            if anchor < self._first_open:
                self._rebase_first_open(anchor)
        if self._tier is not None:
            # reload-on-touch BEFORE the ring offsets: a spilled window
            # this batch's rows can land in comes back into the ring
            # (first_open lowers with it), so nothing reads as late that
            # the all-resident run would have accepted
            self._tier.touch_and_reload(
                int(units.min()) - self._spec.length_units + 1,
                int(units.max()),
            )
        first = self._first_open
        win_rel64 = units - first
        self._max_win_seen = max(self._max_win_seen, int(units.max()))
        late = int((win_rel64 < 0).sum())
        if late:
            self._metrics["late_rows"] += late
            self._obs_late.add(late)

        # group ids — intern BEFORE the capacity check so G always covers
        # every id this batch scatters
        if self._grouped:
            key_cols = [g.eval(batch) for g in self.group_exprs]
            gid = self._interner.intern(key_cols)
        else:
            gid = np.zeros(n, dtype=np.int32)
        self._sw.update(gid)
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
            m = column_validity(e, batch)
            if m is not None:
                colvalid[:, j] = m
                any_invalid = any_invalid or not m.all()
            tr = self._value_transforms[j]
            if tr is None:
                values[:, j] = e.eval(batch)
            else:
                values[:, j] = self._shifted(e, batch, tr, m)

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

        # watermark: monotonic max of batch min-ts (reference semantics),
        # unless hints drive it
        if not self._src_watermarks:
            bmin = int(ts.min())
            if self._watermark_ms is None or bmin > self._watermark_ms:
                self._watermark_ms = bmin
        yield from self._trigger()
        if self._tier is not None:
            # after the trigger: closable windows have emitted, so the
            # [first_open, this batch's lowest window) prefix is the
            # watermark-deferred cold span
            self._tier.maybe_spill(
                int(units.min()) - self._spec.length_units + 1
            )

    def _write_windows(self, js: list[int], planes: list[dict]) -> None:
        """Write the stored component planes of windows ``js`` into their
        ring slots (``j % W``): whole slots, each block's G cells and the
        init value past them (a block written before G grew is narrower),
        one indexed copy a plane on the device."""
        spec = self._spec
        G = spec.group_capacity
        host = {}
        for c in spec.components:
            plane = np.full((len(js), G), spec.init_value(c),
                            dtype=planes[0][c.label].dtype)
            for i, arrays in enumerate(planes):
                arr = arrays[c.label]
                plane[i, : arr.shape[0]] = arr
            host[c.label] = plane
        self._backend.write_slots([j % spec.window_slots for j in js], host)

    def _shifted(self, e: Expr, batch: RecordBatch, transform: str,
                 valid: np.ndarray | None) -> np.ndarray:
        """A variance moment column: (x − K), or its square, in f64, with K
        the first finite valid value ever seen for ``e`` (the s2 − s²/c
        finalize then never cancels catastrophically; exact for any K).
        An all-null or non-finite warm-up batch shifts by 0 and caches
        nothing, so a later batch still sets a magnitude-matched pivot."""
        raw = np.asarray(e.eval(batch), dtype=np.float64)
        key = repr(e)
        K = self._var_shift.get(key)
        if K is None:
            vals = raw if valid is None else raw[valid]
            finite = vals[np.isfinite(vals)]
            K = 0.0
            if len(finite):
                K = float(finite[0])
                self._var_shift[key] = K
        raw = raw - K
        return raw * raw if transform == "shift_sq" else raw

    def _rebase_first_open(self, anchor: int) -> None:
        """Hint-driven watermarks: the first batch anchored ``first_open``
        to ITS windows, but older windows stay legitimate until the
        watermark closes them.  Lower ``first_open`` to the watermark floor
        (never below it: triggers advance exactly to the floor, so anything
        below was genuinely closed and stays late)."""
        wm_floor = (
            watermark_floor(self._watermark_ms, self.length_ms, self.slide_ms)
            if self._watermark_ms is not None
            else anchor
        )
        new_first = max(anchor, int(wm_floor))
        if new_first >= self._first_open:
            return
        # the stripe's units are relative to the OLD first_open: fold it
        # into the ring before the base moves
        self._flush()
        # the widened span needs ring capacity, grown BEFORE the base
        # moves: _grow attributes old slots to windows first_open..
        # first_open+W-1, so lowering first would alias a re-admitted low
        # window with a live high one
        self._ensure_capacity(self._max_win_seen - new_first)
        self._first_open = new_first

    def _output_low_watermark(self, hint_ts: int) -> int:
        return window_output_low_watermark(
            self._first_open, self.slide_ms, self.length_ms, hint_ts,
            wm_ms=self._watermark_ms if self._src_watermarks else None,
        )

    def _ship_rows(self, t0, n, first, win_rel64, rem, gid, values, colvalid):
        """Row shipping: pad the batch to a pow2 bucket and run one device
        step on it."""
        win_rel = np.clip(win_rel64, -1, self._spec.window_slots).astype(np.int32)
        # pad to a pow2 bucket, divisible by the mesh so the partial
        # layouts split rows evenly: padding rows are invalid (row_valid
        # False)
        Bp = max(self._min_batch_bucket, _next_pow2(n))
        Bp = -(-Bp // self._n_dev) * self._n_dev
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
                self._obs_late.add(n_drop - late)
            else:
                keep = None
        if (
            self._acc_future is None or self._acc_future.done()
        ) and self._backend.pending_rows == 0:
            self._stripe_wall = time.perf_counter()
        acc_args = (win_rel64, rem, gid, values64, colvalid, keep,
                    first % self._spec.window_slots)
        if self._host_pipeline:
            self._submit_acc(*acc_args)
        else:
            self._backend.accumulate(*acc_args)
        self._metrics["host_prep_s"] += time.perf_counter() - t0

    # -- host pipeline ----------------------------------------------------
    def _join_acc(self) -> None:
        """Wait for the in-flight host accumulation.  Every backend access
        other than pacing reads (``pending_rows``) fences here: the stripe
        and the ring are consistent only between worker tasks.  A worker's
        failure is raised here, once."""
        f, self._acc_future = self._acc_future, None
        if f is not None:
            try:
                f.result()  # re-raises the worker's failure on this thread
            finally:
                # read the flag after the wait: an earlier task may set it
                # while we wait on the latest; clearing it keeps f's own
                # failure from being raised again by a later fence
                err, self._acc_error = self._acc_error, None
        else:
            err, self._acc_error = self._acc_error, None
        if err is not None:
            # a superseded task failed though the latest one succeeded: the
            # stream must not go on over a half-updated stripe
            raise err

    def _submit_acc(self, *args) -> None:
        """Queue one batch's accumulation on the worker.  It launches any
        merge on the stream this thread's kernels and emission use (torch's
        current stream is per thread)."""
        if self._acc_error is not None:
            err, self._acc_error = self._acc_error, None
            raise err
        if self._acc_exec is None:
            from concurrent.futures import ThreadPoolExecutor

            self._acc_exec = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="window-acc"
            )
        backend = self._backend
        stream = (
            torch.cuda.current_stream(self._device)
            if self._device.type == "cuda" else None
        )

        from denormalized_tpu_torch import obs

        reg = self._obs_reg

        def run():
            try:
                with obs.bound_registry(reg):
                    if stream is None:
                        backend.accumulate(*args)
                    else:
                        with torch.cuda.stream(stream):
                            backend.accumulate(*args)
            except BaseException as e:  # surfaced by _join_acc/_submit_acc
                self._acc_error = e
                raise

        self._acc_future = self._acc_exec.submit(run)

    def _shutdown_acc(self) -> None:
        """Stop the worker: join its last task, so a failure in the
        stream's final batches still surfaces, and release the thread."""
        ex, self._acc_exec = self._acc_exec, None
        if ex is not None:
            try:
                self._join_acc()
            finally:
                ex.shutdown(wait=True)

    def _flush(self) -> None:
        """Fence on the worker, then fold the host stripe into the ring."""
        self._join_acc()
        self._backend.flush_pending()

    # -- emission --------------------------------------------------------
    def _closable(self) -> int:
        if self._watermark_ms is None or self._first_open is None:
            return 0
        wm_win = watermark_floor(
            self._watermark_ms, self.length_ms, self.slide_ms
        )
        return max(0, int(wm_win) - self._first_open)

    def _drain_pending(self) -> Iterator[RecordBatch]:
        """Materialize the emission blocks dispatched earlier (their copies
        to the host ran meanwhile on the side stream), in window order."""
        if not self._pending_emit:
            return
        pending, self._pending_emit = self._pending_emit, []
        for j0, n, handle, is_finals in pending:
            block = self._backend.read_reset_block_finish(handle)
            if is_finals:
                yield from self._emit_finals_block(j0, n, block)
            else:
                yield from self._emit_component_block(j0, n, block)

    def _trigger(self, force: bool = False) -> Iterator[RecordBatch]:
        """Emit every window whose end ≤ watermark (trigger_windows,
        grouped_window_agg_stream.rs:220-253).

        Blocks a previous trigger dispatched drain first.  With a
        host-accumulating backend the stripe is merged first, and emission
        waits up to ``emit_lag_ms`` after the stripe began, while it stays
        under ``partial_merge_rows`` and can take another slide unit;
        ``force`` skips the wait (ingest uses it to freeze closable windows
        before a batch whose rows would otherwise leak into them).  Row
        shipping, and a zero emit lag, drain the blocks this trigger read
        before it returns; otherwise they drain at the next trigger (or
        marker, idle hint or end of stream), so their copy overlaps
        ingest."""
        yield from self._drain_pending()
        if (
            self._tier is not None
            and self._tier.any_spilled
            and self._watermark_ms is not None
        ):
            # spilled windows the watermark closed emit from their stored
            # planes — all lie below first_open, so the output stays in
            # ascending window order
            wmf = int(watermark_floor(
                self._watermark_ms, self.length_ms, self.slide_ms
            ))
            for j in self._tier.due_windows(wmf):
                b = self._finalize_rows(j, self._tier.emit_rows(j))
                if b is not None:
                    yield b
        if self._obs_wm_lag and self._watermark_ms is not None:
            # watermark lag (wall − watermark) at this trigger: the gauge
            # keeps the latest, the histogram the distribution
            lag = time.time() * 1000.0 - self._watermark_ms
            self._obs_wm_lag.set(lag)
            self._obs_wm_lag_hist.observe(lag)
        n_close = self._closable()
        if self._backend.accumulates_host:
            if n_close == 0:
                if self._backend.pending_rows >= self._merge_rows:
                    self._flush()
                return
            age = time.perf_counter() - (self._stripe_wall or 0.0)
            if (
                not force
                and age < self._emit_lag_s
                and self._backend.pending_rows < self._merge_rows
                and self._stripe_fits_more()
            ):
                return
            self._flush()
        if self._emission_compaction:
            # one window at a time, each read through the compaction kernel
            for _ in range(n_close):
                b = self._emit_window(self._first_open)
                self._first_open += 1
                if b is not None:
                    yield b
            return
        while n_close > 0:
            # pow2 block sizes, as in the JAX package's program ladder
            n = 1 << min(3, (n_close).bit_length() - 1)
            n = min(n, self._spec.window_slots)
            live = len(self._interner) if self._grouped else 1
            first_slot = self._first_open % self._spec.window_slots
            handle = self._backend.read_reset_block_finals_start(
                first_slot, n, live_groups=live
            )
            is_finals = handle is not None
            if not is_finals:
                handle = self._backend.read_reset_block_start(
                    first_slot, n, live_groups=live,
                    lean=(
                        not self._any_nulls_seen
                        and sa.lean_possible(self._spec)
                    ),
                )
            self._pending_emit.append((self._first_open, n, handle, is_finals))
            self._metrics["emit_blocks"] += 1
            self._first_open += n
            n_close -= n
        if not self._backend.accumulates_host or self._emit_lag_s == 0:
            # row shipping emits in the same trigger; with a zero lag (the
            # CPU's default) there is nothing to overlap, and deferring
            # would hold a paused live stream's output until its next batch
            yield from self._drain_pending()
        else:
            self._metrics["emit_blocks_deferred"] += len(self._pending_emit)

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
        """Read, reset and finalize one window's slot — under emission
        compaction through the compaction kernel, so only the window's
        active groups cross to the host."""
        slot = j % self._spec.window_slots
        if not self._emission_compaction:
            with span("window.emit", op="window", window=j * self.slide_ms):
                rows = self._backend.read_slot(slot)
                self._backend.reset_slot(slot)
            return self._finalize_rows(j, rows)
        with span("window.emit", op="window", window=j * self.slide_ms):
            compacted = self._backend.read_slot_compact(slot)
            if compacted is None:
                # a row-shipping sharded layout does not compact: the whole
                # slot crosses, as in the JAX package
                rows = self._backend.read_slot(slot)
            self._backend.reset_slot(slot)
        if compacted is None:
            return self._finalize_rows(j, rows)
        gids, rows = compacted
        # rows hold only the active groups, in ascending gid; the interner
        # bound guard of the full path applies
        ngroups = len(self._interner) if self._grouped else 1
        in_bounds = gids < ngroups
        if not in_bounds.all():
            gids = gids[in_bounds]
            rows = {label: arr[in_bounds] for label, arr in rows.items()}
        if len(gids) == 0:
            return None
        self._metrics["windows_emitted"] += 1
        active = np.ones(len(gids), dtype=bool)
        return self._assemble_emission(
            j, gids.astype(np.int32), sa.finalize(self._agg_specs, rows, active)
        )

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
        self._obs_windows.add(1)
        if self._obs_emit_lag:
            # event-time emission latency, stamped where every emission
            # path funnels through
            self._obs_emit_lag.observe(
                time.time() * 1000.0 - (j * self.slide_ms + self.length_ms)
            )
        if self._dr_lineage is not None:
            # sampled record lineage: close every chain whose tagged row
            # fell inside this window
            self._dr_lineage.emitted(
                self._dr_node_id,
                j * self.slide_ms,
                j * self.slide_ms + self.length_ms,
            )
        return RecordBatch(self.schema, cols)

    # -- checkpointing ----------------------------------------------------
    # Snapshot = ring planes + interner + watermark scalars, taken at an
    # aligned in-band marker (the JAX package's layout, so either package
    # restores the other's snapshot).
    def enable_checkpointing(self, node_id: str, coord, orch) -> None:
        self._ckpt = (coord, f"window_{node_id}")
        self._restore()

    def _snapshot(self, epoch: int) -> None:
        """Start epoch ``epoch``'s snapshot without waiting for the device:
        merge the host stripe (host state the ring does not hold yet),
        start the ring's export, and capture the host bookkeeping now —
        it changes with the very next batch."""
        self._flush()
        # dnzlint: allow(snapshot-asym) window_slots and group_capacity are for the JAX package's restore, which rebuilds its spec from them (cross-package restores) and cluster/rescale.py; this restore takes W and G from the planes' shapes
        meta = {
            "epoch": epoch,
            "first_open": self._first_open,
            "max_win_seen": self._max_win_seen,
            "watermark_ms": self._watermark_ms,
            "window_slots": self._spec.window_slots,
            "group_capacity": self._backend.group_capacity,
            "interner": self._interner.snapshot() if self._grouped else None,
            # variance pivots: shifted sums are only comparable under the
            # same K, so K survives a restart with the state it shifted
            "var_shift": dict(self._var_shift),
            "any_nulls_seen": self._any_nulls_seen,
        }
        if self._tier is not None and self._tier.any_spilled:
            coord, key = self._ckpt
            # spilled window planes commit under this SAME epoch; the ring
            # export below holds only the resident windows
            meta["spill_windows"] = self._tier.snapshot_refs(
                coord, key, epoch
            )
        self._pending_snapshot = (
            epoch, meta, self._backend, self._backend.export_start()
        )

    def _release_snapshot(self) -> Iterator[Marker]:
        """Wait for a pending snapshot's export, write it, and release its
        held marker.  Runs before any output derived from post-marker input
        leaves this operator: a downstream operator that saw such output
        before the marker would snapshot state ahead of ours."""
        if self._pending_snapshot is not None:
            epoch, meta, backend, handle = self._pending_snapshot
            self._pending_snapshot = None
            coord, key = self._ckpt
            m = self._metrics
            with span("window.snapshot", epoch=epoch, key=key):
                t0 = time.perf_counter()  # dnzlint: allow(replay-impure) the snapshot's times, observability only: the time never feeds the snapshot's bytes
                planes = backend.export_finish(handle)
                t1 = time.perf_counter()  # dnzlint: allow(replay-impure) the snapshot's times, observability only: the time never feeds the snapshot's bytes
                blob = pack_snapshot(meta, planes)
                t2 = time.perf_counter()  # dnzlint: allow(replay-impure) the snapshot's times, observability only: the time never feeds the snapshot's bytes
                coord.put_snapshot(key, epoch, blob)
                t3 = time.perf_counter()  # dnzlint: allow(replay-impure) the snapshot's times, observability only: the time never feeds the snapshot's bytes
            m["snapshots"] += 1  # dnzlint: allow(snapshot-asym) the operator's metrics counter, not a payload key
            m["snapshot_bytes"] += len(blob)  # dnzlint: allow(snapshot-asym) the operator's metrics counter, not a payload key
            m["snapshot_wait_s"] += t1 - t0  # dnzlint: allow(snapshot-asym) the operator's metrics counter, not a payload key
            m["snapshot_pack_s"] += t2 - t1  # dnzlint: allow(snapshot-asym) the operator's metrics counter, not a payload key
            m["snapshot_put_s"] += t3 - t2  # dnzlint: allow(snapshot-asym) the operator's metrics counter, not a payload key
        if self._held_marker is not None:
            marker, self._held_marker = self._held_marker, None
            yield marker

    def _restore(self) -> None:
        """Continue from the committed epoch's snapshot, if there is one:
        the backend is rebuilt for its W and G and the ring imported onto
        the engine's device (``load_state``).  Spilled windows the snapshot
        references re-arm the cold tier's map, or, with no tier (the budget
        was removed since), go back into the ring."""
        coord, key = self._ckpt
        blob = coord.get_snapshot(key)
        if blob is None:
            return
        meta, arrays = unpack_snapshot(blob)
        self.load_state(
            arrays,
            meta["interner"],
            meta["first_open"],
            meta["max_win_seen"],
            meta["watermark_ms"],
            # restored state may hold counts < row counts (nulls before
            # the kill); unless the snapshot says otherwise, stay on full
            # gathers
            bool(meta.get("any_nulls_seen", True)),
            meta.get("var_shift"),
        )
        refs = meta.get("spill_windows")
        if refs:
            if self._tier is not None:
                self._tier.restore_refs(coord, key, refs)
            else:
                self._restore_spilled_resident(coord, key, refs)

    def _restore_spilled_resident(self, coord, key: str, refs: dict) -> None:
        """Budget removed since the checkpoint: the spilled windows' planes
        go back into the ring (first_open lowers to cover them)."""
        js = sorted(int(k) for k in refs)
        new_first = min(js + ([self._first_open]
                              if self._first_open is not None else []))
        self._ensure_capacity(self._max_win_seen - new_first)
        self._first_open = new_first
        planes = []
        for j in js:
            raw = coord.get_snapshot(f"{key}:spill:{refs[str(j)]}")
            if raw is None:
                raise StateError(
                    f"checkpoint references spilled window {j} but the "
                    "epoch holds no such snapshot"
                )
            planes.append(unpack_snapshot(raw)[1])
        self._write_windows(js, planes)

    # -- stream loop -----------------------------------------------------
    def run(self) -> Iterator[StreamItem]:
        try:
            yield from self._run_inner()
        finally:
            self._shutdown_acc()

    def _run_inner(self) -> Iterator[StreamItem]:
        for item in self._doctor_input():
            if isinstance(item, RecordBatch):
                # the batch's device work queues behind a pending export's
                # clone, so the export's copy overlaps it; the held marker
                # still leaves before any of the batch's output.  The
                # emissions are materialized INSIDE the busy bracket (their
                # copy to the host waits for the card), so the histogram
                # measures this operator's own work, not time suspended
                # downstream; nothing here synchronizes the device
                t0 = time.perf_counter()
                with span(
                    "window.process_batch", op="window", rows=item.num_rows
                ):
                    out = list(self._process_batch(item))
                self._note_batch(t0, item.num_rows)
                yield from self._release_snapshot()
                yield from out
            elif isinstance(item, WatermarkHint):
                yield from self._on_hint(item)
            elif isinstance(item, Marker):
                # blocks read before the marker leave before it
                yield from self._drain_pending()
                yield from self._release_snapshot()  # an earlier epoch
                if self._ckpt is not None:
                    self._snapshot(item.epoch)
                    self._held_marker = item
                else:
                    yield item
            elif isinstance(item, EndOfStream):
                # pending blocks are closed windows: they emit first
                yield from self._drain_pending()
                yield from self._release_snapshot()
                # bounded input: merge the stripe, flush every open window
                # (unless emit_on_close is off: then only the windows the
                # watermark closed, drained above, leave)
                if self.emit_on_close and self._first_open is not None:
                    self._flush()
                    if self._tier is not None:
                        # spilled windows all lie below first_open: they
                        # emit first, keeping ascending order
                        for j in self._tier.due_windows(
                            self._max_win_seen + 1
                        ):
                            b = self._finalize_rows(
                                j, self._tier.emit_rows(j)
                            )
                            if b is not None:
                                yield b
                    for j in range(self._first_open, self._max_win_seen + 1):
                        b = self._emit_window(j)
                        if b is not None:
                            yield b
                    self._first_open = self._max_win_seen + 1
                else:
                    # no flush ran: still fence the worker, so a failed
                    # accumulation cannot be swallowed
                    self._join_acc()
                yield EOS
                return

    def _on_hint(self, item: WatermarkHint) -> Iterator[StreamItem]:
        """Advance event time to the hint, close what is ready, and forward
        the hint clamped below this operator's lowest possible future
        emission timestamp.  An idle hint forces emission and drains the
        blocks it read: no next item may come to drain them."""
        if item.kind == "partition":
            # authoritative watermark: from now on batch min-ts must not
            # advance it
            self._src_watermarks = True
            if item.is_announcement:
                yield item  # pure mode announcement
                return
        # a held marker reaches downstream before any output of this hint
        yield from self._release_snapshot()
        if self._watermark_ms is None or item.ts_ms > self._watermark_ms:
            self._watermark_ms = item.ts_ms
            # partition hints arrive continuously (one per advancing
            # batch), so the emit-lag deferral keeps working; an idle
            # period delivers exactly ONE hint, so it forces emission
            idle = item.kind != "partition"
            yield from self._trigger(force=idle)
            if idle:
                yield from self._drain_pending()
        yield WatermarkHint(
            min(item.ts_ms, self._output_low_watermark(item.ts_ms)),
            kind=item.kind,
        )
