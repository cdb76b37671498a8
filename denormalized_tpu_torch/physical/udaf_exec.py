"""Windowed aggregation with user-defined (Python) accumulators —
counterpart of ``denormalized_tpu/physical/udaf_exec.py``.

The reference evaluates Python UDAFs through its vendored datafusion-python
layer — each group's accumulator is a Python object called under the GIL
(py-denormalized python/denormalized/datafusion/udf.py).  Such state cannot
live on the card, so this operator keeps the windowing semantics of
:class:`StreamingWindowExec` (slide-index windows, monotonic min-ts
watermark, late-data drop, ``kind="partition"`` hints) but holds
per-(window, group) ``Accumulator`` instances on the host.  Built-in
aggregates mixed into the same ``window()`` call run as numpy running
aggregates beside them (:class:`_BuiltinAcc`); the planner routes a window
with ANY accumulator aggregate here.  In the JAX package this operator is
host numpy too: the port runs the same code.

Checkpoints write the JAX package's JSON blob under ``udafwin_{node_id}``
(key values, not gids, so a restore re-interns them), and restore either
package's.  Under a state budget (``enable_spill``) :class:`_UdafTier`
moves the coldest groups' accumulator states to the LSM, leaving
order-keeping :data:`SPILLED` markers in the frames, as the JAX package's
does.
"""

from __future__ import annotations

from typing import Iterator

import time

import numpy as np

from denormalized_tpu_torch.common.columns import as_key_column
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
from denormalized_tpu_torch.ops.interner import GroupInterner
from denormalized_tpu_torch.ops.segment_agg import chan_merge, variance_from_m2
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
from denormalized_tpu_torch.runtime.tracing import logger
from denormalized_tpu_torch.state import tiering
from denormalized_tpu_torch.state.checkpoint import get_json, jsonable, put_json
from denormalized_tpu_torch.state.serialization import (
    pack_snapshot,
    unpack_snapshot,
)


class _BuiltinAcc:
    """numpy running aggregate for builtin kinds inside the UDAF exec.
    Variance keeps Welford/Chan moments (mean, M2) — stable at any value
    magnitude — merged via ``segment_agg.chan_merge``."""

    __slots__ = ("kind", "count", "sum", "mean", "m2", "min", "max")

    def __init__(self, kind: str):
        self.kind = kind
        self.count = 0
        self.sum = 0.0
        self.mean = 0.0
        self.m2 = 0.0
        self.min = np.inf
        self.max = -np.inf

    def update(self, v: np.ndarray):
        self.count += len(v)
        if self.kind in ("sum", "avg") or self.kind in VAR_KINDS:
            self.sum += float(v.sum())
            if self.kind in VAR_KINDS and len(v):
                x = v.astype(np.float64)
                cm = float(x.mean())
                cm2 = float(((x - cm) ** 2).sum())
                n_prev = self.count - len(v)
                _, self.mean, self.m2 = chan_merge(
                    n_prev, self.mean, self.m2, len(v), cm, cm2
                )
        elif self.kind == "min" and len(v):
            self.min = min(self.min, float(v.min()))
        elif self.kind == "max" and len(v):
            self.max = max(self.max, float(v.max()))

    def evaluate(self):
        if self.kind in VAR_KINDS:
            return float(variance_from_m2(self.kind, self.count, self.m2))
        return {
            "count": self.count,
            "sum": self.sum,
            "avg": self.sum / self.count if self.count else np.nan,
            "min": self.min if np.isfinite(self.min) else np.nan,
            "max": self.max if np.isfinite(self.max) else np.nan,
        }[self.kind]

    def state(self):
        return [
            self.count, self.sum, float(self.min), float(self.max),
            self.mean, self.m2,
        ]

    def merge(self, s):
        _, self.mean, self.m2 = chan_merge(
            self.count, self.mean, self.m2,
            s[0], s[4] if len(s) > 4 else 0.0, s[5] if len(s) > 5 else 0.0,
        )
        self.count += s[0]
        self.sum += s[1]
        self.min = min(self.min, s[2])
        self.max = max(self.max, s[3])


class _Spilled:
    """In-place marker for a frame group whose accumulators live in the
    cold tier.  The dict ENTRY stays (so reload restores the group at its
    original position and emission row order matches the all-resident
    run); only the accumulator objects leave RAM."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return "<spilled>"


SPILLED = _Spilled()


class _UdafTier:
    """Cold tier of one UDAF window operator: evicts the coldest gids'
    accumulator states (across every open window they appear in) to the
    LSM, leaving order-preserving markers in the frames; reloads when a
    batch touches the key or the window emits."""

    __slots__ = (
        "op", "node_id", "ctrl", "cold", "any_spilled", "spilled_bytes",
        "spilled_groups", "_block_of", "_blocks", "_next",
    )

    def __init__(self, op: "UdafWindowExec", node_id: str, ctrl) -> None:
        self.op = op
        self.node_id = node_id
        self.ctrl = ctrl
        self.cold = tiering.ColdTracker()
        self.any_spilled = False
        self.spilled_bytes = 0
        self.spilled_groups = 0  # (window, gid) entries in the cold tier
        self._block_of = np.full(1024, -1, dtype=np.int64)
        self._blocks: dict[int, dict] = {}
        self._next = 0
        ctrl.register(node_id, op, self.resident_bytes)

    def resident_bytes(self) -> int:
        """Real accumulator sizes (``state_nbytes`` where implemented, so
        unbounded collectors report their true growth) plus the per-key
        and per-frame estimates.  ``list()`` copies: this may run on
        another operator's thread while this one inserts or pops frames."""
        op = self.op
        acc_bytes = 0
        try:
            for f in list(op._frames.values()):
                for accs in list(f.values()):
                    if accs is SPILLED:
                        continue
                    for acc in accs:
                        acc_bytes += statewatch.acc_nbytes(acc)
        except RuntimeError:
            # torn read mid-mutation: the flat estimate for this sample
            groups = sum(len(f) for f in list(op._frames.values()))
            acc_bytes = (
                (groups - self.spilled_groups)
                * max(len(op.aggr_exprs), 1)
                * statewatch.ACC_EST_BYTES
            )
        keys = len(op._interner) if op._interner is not None else 0
        return (acc_bytes + keys * statewatch.KEY_EST_BYTES
                + len(op._frames) * 64)

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

    def _capacity(self) -> int:
        return len(self.op._interner) if self.op._interner is not None else 1

    # -- hot path ---------------------------------------------------------
    def touch_and_reload(self, gids: np.ndarray) -> None:
        self._ensure_maps(self._capacity())
        self.cold.touch(gids)
        if not self.any_spilled:
            return
        b = self._block_of[gids]
        hit = b[b >= 0]
        if len(hit) == 0:
            return
        for bid in np.unique(hit).tolist():
            self._reload_block(int(bid))
        self._write_manifest()

    def reload_gid(self, gid: int) -> None:
        """Lazy reload for a marker met outside the batched touch path."""
        bid = int(self._block_of[gid]) if gid < len(self._block_of) else -1
        if bid >= 0:
            self._reload_block(bid)
            self._write_manifest()

    def reload_for_window(self, j: int) -> None:
        """Reload every block holding entries of window ``j`` before it
        emits — emission content and row order match the all-resident run
        exactly."""
        if not self.any_spilled:
            return
        due = [bid for bid, m in self._blocks.items() if j in m["windows"]]
        for bid in due:
            self._reload_block(bid)
        if due:
            self._write_manifest()

    # -- eviction ---------------------------------------------------------
    def maybe_spill(self, protect_gids: np.ndarray) -> None:
        need = self.ctrl.over_budget()
        if need <= 0:
            self.ctrl.relax(self.node_id)
            return
        op = self.op
        # live resident groups + REAL bytes a gid (spill cadence only):
        # evicting by true size frees the budget in as few blocks as
        # possible when accumulator growth is skewed
        per_gid: dict[int, int] = {}
        per_gid_bytes: dict[int, int] = {}
        for frame in op._frames.values():
            for g, accs in frame.items():
                if accs is not SPILLED:
                    per_gid[g] = per_gid.get(g, 0) + 1
                    per_gid_bytes[g] = per_gid_bytes.get(g, 0) + sum(
                        statewatch.acc_nbytes(a) for a in accs
                    )
        self._ensure_maps(self._capacity())
        protect = np.zeros(len(self._block_of), dtype=bool)
        protect[protect_gids] = True
        cand = np.asarray(
            [g for g in per_gid if not protect[g]], dtype=np.int64
        )
        spilled_any = False
        if len(cand):
            cand = self.cold.order_cold(cand)
            counts = np.asarray([per_gid[int(g)] for g in cand])
            csum = np.cumsum(np.asarray([per_gid_bytes[int(g)] for g in cand]))
            k = min(int(np.searchsorted(csum, need)) + 1, len(cand))
            # chunk into blocks of <= SPILL_BLOCK_SLOTS entries
            start = 0
            acc = 0
            for i in range(k):
                acc += int(counts[i])
                if acc >= tiering.SPILL_BLOCK_SLOTS or i == k - 1:
                    try:
                        self._spill_chunk(cand[start : i + 1])
                    except StateError as e:
                        # failed eviction put: the accumulators stay
                        # resident; degrade, never kill the query
                        logger.warning(
                            "spill: udaf eviction put failed (%s) — "
                            "chunk stays resident", e,
                        )
                        break
                    spilled_any = True
                    start, acc = i + 1, 0
        if spilled_any:
            self._write_manifest()
            self.op._state_info_cache = None
            tiering.release_freed_memory()
        self.ctrl.check_pressure(self.node_id)

    def _spill_chunk(self, gids_chunk: np.ndarray) -> None:
        op = self.op
        chunk_set = set(int(g) for g in gids_chunk)
        entries: dict[str, list] = {}
        to_mark: list[tuple[dict, int]] = []
        windows: set[int] = set()
        n_groups = 0
        for j, frame in op._frames.items():
            row = []
            for g in frame:
                if int(g) in chunk_set and frame[g] is not SPILLED:
                    row.append([int(g), [acc.state() for acc in frame[g]]])
                    to_mark.append((frame, int(g)))
            if row:
                entries[str(j)] = row
                windows.add(int(j))
                n_groups += len(row)
        if n_groups == 0:
            return
        if op._interner is not None:
            keys = op._interner.keys_of(np.asarray(gids_chunk, dtype=np.int64))
            keys_meta = jsonable([list(c) for c in keys])
        else:
            keys_meta = None
        # entries name gids by CHUNK POSITION, so a restore (fresh gid
        # space) maps them through the re-interned keys
        pos = {int(g): i for i, g in enumerate(gids_chunk)}
        for row in entries.values():
            for e in row:
                e[0] = pos[e[0]]
        meta = {
            "keys": keys_meta,
            "entries": jsonable(entries),
            "windows": sorted(windows),
            "groups": n_groups,
        }
        bid = self._next
        # durable FIRST: the accumulators are replaced by markers only once
        # their states are in the LSM
        nbytes = self.ctrl.put_block(
            self.node_id, f"b{bid}", pack_snapshot(meta, {})
        )
        self._next += 1
        for frame, g in to_mark:
            frame[g] = SPILLED
        self._block_of[gids_chunk] = bid
        self._blocks[bid] = {
            "gids": np.asarray(gids_chunk, dtype=np.int64).copy(),
            "windows": windows,
            "bytes": nbytes,
            "groups": n_groups,
        }
        self.any_spilled = True
        self.spilled_bytes += nbytes
        self.spilled_groups += n_groups
        self.ctrl.note_spill(self.node_id, 1, nbytes)

    # -- reload -----------------------------------------------------------
    def _reload_block(self, bid: int) -> None:
        meta = self._blocks.pop(bid)
        raw = self.ctrl.get_block(self.node_id, f"b{bid}")
        chunk_gids = self.op._merge_block(unpack_snapshot(raw)[0])
        self._ensure_maps(self._capacity())
        self._block_of[meta["gids"]] = -1
        self._block_of[chunk_gids] = -1  # restore path: fresh gid space
        self.any_spilled = bool(self._blocks)
        self.spilled_bytes -= meta["bytes"]
        self.spilled_groups -= meta["groups"]
        self.ctrl.note_reload(self.node_id, 1, len(raw))
        self.ctrl.delete_block(self.node_id, f"b{bid}")
        self.op._state_info_cache = None

    def _write_manifest(self) -> None:
        self.ctrl.write_manifest(
            self.node_id, [f"b{b}" for b in self._blocks]
        )

    def info(self) -> dict:
        return {
            "spilled_bytes": self.spilled_bytes,
            "spilled_keys": self.spilled_groups,
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
        op = self.op
        for bid in bids:
            raw = self.ctrl.restore_block_from_epoch(
                coord, key, self.node_id, f"b{bid}"
            )
            bmeta = unpack_snapshot(raw)[0]
            chunk_gids = op._block_gids(bmeta)
            self._ensure_maps(self._capacity())
            windows: set[int] = set()
            groups = 0
            for j_str, row in bmeta["entries"].items():
                frame = op._frames.setdefault(int(j_str), {})
                windows.add(int(j_str))
                for posi, _states in row:
                    frame[int(chunk_gids[int(posi)])] = SPILLED
                    groups += 1
            self._block_of[chunk_gids] = bid
            self._blocks[bid] = {
                "gids": chunk_gids.copy(),
                "windows": windows,
                "bytes": len(raw),
                "groups": groups,
            }
            self.spilled_bytes += len(raw)
            self.spilled_groups += groups
            self._next = max(self._next, bid + 1)
        self.any_spilled = bool(self._blocks)
        self._write_manifest()


class UdafWindowExec(ExecOperator):
    def __init__(
        self,
        input_op: ExecOperator,
        group_exprs: list[Expr],
        aggr_exprs: list[AggregateExpr],
        window_type: WindowType,
        length_ms: int,
        slide_ms: int | None,
        *,
        emit_on_close: bool = True,
        name: str = "udaf_window",
    ) -> None:
        if window_type is WindowType.SESSION:
            raise PlanError(
                "session windows route to SessionWindowExec (which handles "
                "accumulator aggregates directly)"
            )
        self.input_op = input_op
        self.group_exprs = list(group_exprs)
        self.aggr_exprs = list(aggr_exprs)
        self.window_type = window_type
        self.length_ms = int(length_ms)
        self.slide_ms = int(slide_ms) if slide_ms else self.length_ms
        self.emit_on_close = emit_on_close
        self.name = name
        self._k = -(-self.length_ms // self.slide_ms)

        in_schema = input_op.schema
        fields = [g.out_field(in_schema) for g in self.group_exprs]
        fields += [a.out_field(in_schema) for a in self.aggr_exprs]
        fields += [
            Field(WINDOW_START_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
            Field(WINDOW_END_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
            Field(CANONICAL_TIMESTAMP_COLUMN, DataType.TIMESTAMP_MS, nullable=False),
        ]
        self.schema = Schema(fields)

        # frames: window index j -> { dense group id -> [acc per agg] }.
        # Keys intern through a GroupInterner (the machinery the device
        # window uses) so per-batch grouping is one lexsort over int
        # arrays; checkpoints store the key VALUES, re-interned on restore
        self._interner = (
            GroupInterner(len(self.group_exprs)) if self.group_exprs else None
        )
        self._frames: dict[int, dict[int, list]] = {}
        self._ckpt: tuple | None = None
        # cold tier (state/tiering.py): set by enable_spill
        self._tier: _UdafTier | None = None
        self._first_open: int | None = None
        self._max_win_seen = -1
        self._watermark: int | None = None
        # True once a kind="partition" hint arrived: batch min-ts no
        # longer advances the watermark (replay-skew safety)
        self._src_watermarks = False
        self._metrics = {"rows_in": 0, "windows_emitted": 0, "late_rows": 0}
        from denormalized_tpu_torch import obs

        self.bind_obs("udaf")
        # state observatory sketches, fed dense gids per batch
        self._sw = statewatch.make_watch("udaf")
        self._obs_late = obs.counter("dnz_late_rows_total", op="udaf")
        self._obs_windows = obs.counter(
            "dnz_windows_emitted_total", op="udaf"
        )
        self._obs_emit_lag = obs.histogram(
            "dnz_emit_event_lag_ms", op="udaf"
        )
        self._obs_wm_lag = obs.gauge("dnz_watermark_lag_ms", op="udaf")
        self._obs_wm_lag_hist = obs.histogram(
            "dnz_watermark_lag_hist_ms", op="udaf"
        )

    @property
    def children(self):
        return [self.input_op]

    def metrics(self):
        return dict(self._metrics)

    def _label(self):
        return f"UdafWindowExec({self.window_type.value} {self.length_ms}ms)"

    def enable_spill(self, node_id: str, controller) -> None:
        self._tier = _UdafTier(self, node_id, controller)

    def state_info(self) -> dict:
        """Exact group and accumulator counts; bytes from each
        accumulator's own ``state_nbytes()`` (the documented flat
        estimate for accumulators without one) plus the per-key and
        per-frame estimates — the JAX operator's accounting."""
        frames = self._frames
        groups_total = 0
        acc_bytes = 0
        live_gids: set[int] = set()
        for f in list(frames.values()):
            # spilled markers keep their entries, but their accumulators
            # live in the LSM (reported as spilled_keys and spilled_bytes)
            for g, accs in list(f.items()):
                if accs is SPILLED:
                    continue
                groups_total += 1
                live_gids.add(g)
                for acc in accs:
                    acc_bytes += statewatch.acc_nbytes(acc)
        live_keys = len(live_gids)
        oldest = (
            self._first_open * self.slide_ms
            if self._first_open is not None and frames
            else None
        )
        wm = self._watermark
        info = {
            "op": "udaf",
            "state_bytes": (
                acc_bytes + live_keys * statewatch.KEY_EST_BYTES
                + len(frames) * 64
            ),
            "live_keys": live_keys,
            "slot_capacity": groups_total,
            "slot_live": groups_total,
            "open_windows": len(frames),
            "acc_objects": groups_total * len(self.aggr_exprs),
            "retention_unit_ms": self.length_ms,
            "oldest_event_ms": oldest,
            "watermark_ms": wm,
        }
        if self._interner is not None:
            info["interner_keys_total"] = len(self._interner)
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

    def _make_accs(self) -> list:
        return [
            a.udaf.make() if a.kind == "udaf" else _BuiltinAcc(a.kind)
            for a in self.aggr_exprs
        ]

    def _process_batch(self, batch: RecordBatch) -> Iterator[RecordBatch]:
        n = batch.num_rows
        if n == 0:
            return
        self._metrics["rows_in"] += n
        self._obs_rows_in.add(n)
        S = self.slide_ms
        ts = np.asarray(batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64)
        units = ts // S
        anchor = int(units.min()) - self._k + 1
        if self._first_open is None:
            self._first_open = anchor
        elif self._src_watermarks and anchor < self._first_open:
            # per-partition watermarks: a slower partition's earlier
            # windows stay legitimate until the min-driven watermark
            # closes them (frames are dicts keyed by absolute window
            # index, so lowering the cursor just re-admits them); anything
            # below the watermark floor was closed and stays late
            wm_floor = (
                watermark_floor(self._watermark, self.length_ms, self.slide_ms)
                if self._watermark is not None
                else anchor
            )
            self._first_open = max(anchor, int(wm_floor))
        self._max_win_seen = max(self._max_win_seen, int(units.max()))

        if self._interner is not None:
            # raw dtypes (the device window's calling convention): numeric
            # and bool keys take the interner's exact-value path, string
            # columns its offsets-and-bytes lane
            gids = self._interner.intern(
                [as_key_column(g.eval(batch)) for g in self.group_exprs]
            ).astype(np.int64)
        else:
            gids = np.zeros(n, dtype=np.int64)
        self._sw.update(gids)
        if self._tier is not None:
            # membership pre-probe + reload-on-touch BEFORE the frame loop:
            # touched markers come back resident
            self._tier.touch_and_reload(gids)

        arg_cols: list[list[np.ndarray]] = []
        arg_masks: list[np.ndarray | None] = []
        for a in self.aggr_exprs:
            if a.kind == "udaf":
                arg_cols.append([np.asarray(e.eval(batch)) for e in a.udaf.args])
                arg_masks.append(
                    column_validity(a.udaf.args[0], batch)
                    if a.udaf.args else None
                )
            elif a.arg is not None:
                arg_cols.append([np.asarray(a.arg.eval(batch), dtype=np.float64)])
                arg_masks.append(column_validity(a.arg, batch))
            else:
                arg_cols.append([np.zeros(n)])
                arg_masks.append(None)

        # group rows by (window fan-out, dense gid): one lexsort per
        # fan-out step, runs found by boundary diff — no per-row Python
        for i in range(self._k):
            win = units - i
            in_window = (win >= self._first_open) & (
                (ts - win * S) < self.length_ms
            )
            if i == 0:
                late = (win < self._first_open) & (
                    (ts - win * S) < self.length_ms
                )
                n_late = int(late.sum())
                self._metrics["late_rows"] += n_late
                if n_late:
                    self._obs_late.add(n_late)
            idx = np.nonzero(in_window)[0]
            if len(idx) == 0:
                continue
            wsel = win[idx]
            gsel = gids[idx]
            order = np.lexsort((gsel, wsel))
            ws = wsel[order]
            gs = gsel[order]
            m = len(order)
            bounds = np.nonzero(
                np.concatenate(
                    ([True], (ws[1:] != ws[:-1]) | (gs[1:] != gs[:-1]))
                )
            )[0]
            ends = np.append(bounds[1:], m)
            for b0, b1 in zip(bounds, ends):
                rows = idx[order[b0:b1]]
                frame = self._frames.setdefault(int(ws[b0]), {})
                gid = int(gs[b0])
                accs = frame.get(gid)
                if accs is SPILLED:
                    # the touch-time reload covers every batch gid; a
                    # marker here means the block map missed it
                    self._tier.reload_gid(gid)
                    accs = frame.get(gid)
                if accs is None:
                    accs = self._make_accs()
                    frame[gid] = accs
                for a, acc, cols, am in zip(
                    self.aggr_exprs, accs, arg_cols, arg_masks
                ):
                    chunk = [c[rows] for c in cols]
                    if am is not None:
                        valid = am[rows]
                        chunk = [c[valid] for c in chunk]
                    if a.kind == "udaf":
                        acc.update(*chunk)
                    else:
                        acc.update(chunk[0])

        if not self._src_watermarks:
            bmin = int(ts.min())
            if self._watermark is None or bmin > self._watermark:
                self._watermark = bmin
        yield from self._trigger()
        if self._tier is not None:
            self._tier.maybe_spill(gids)

    def _trigger(self) -> Iterator[RecordBatch]:
        if self._watermark is None or self._first_open is None:
            return
        if self._obs_wm_lag:
            lag = time.time() * 1000.0 - self._watermark
            self._obs_wm_lag.set(lag)
            self._obs_wm_lag_hist.observe(lag)
        while self._first_open * self.slide_ms + self.length_ms <= self._watermark:
            b = self._emit(self._first_open)
            self._first_open += 1
            if b is not None:
                yield b
        self._maybe_reintern()

    # re-keying threshold (tests lower it to force the path)
    _reintern_min = 262_144

    def _maybe_reintern(self) -> None:
        """Frames free their accumulators when windows emit, but the
        interner only ever grows — re-key from the LIVE groups when
        distinct-keys-ever-seen dwarfs them, so host memory follows open
        windows, not stream lifetime (the join's policy too)."""
        if self._interner is None:
            return
        if self._tier is not None and self._tier.any_spilled:
            # re-keying would strand the blocks' gid maps; it waits until
            # the cold set drains (emission drains it steadily)
            return
        # cheap threshold first: do not build the live set on every
        # trigger just to no-op
        if len(self._interner) <= self._reintern_min:
            return
        live: set[int] = set()
        for frame in self._frames.values():
            live.update(frame.keys())
        if len(self._interner) <= 4 * max(len(live), 1):
            return
        # the gid space is about to reset: the sketch restarts
        self._sw.reset_sketches()
        old = self._interner
        new = GroupInterner(len(self.group_exprs))
        gids_sorted = sorted(live)
        if gids_sorted:
            key_arrays = old.keys_of(np.asarray(gids_sorted, dtype=np.int64))
            in_schema = self.input_op.schema
            cols = []
            for g, arr in zip(self.group_exprs, key_arrays):
                f = g.out_field(in_schema)
                # keys_of yields object arrays; restore the column's real
                # dtype so numeric keys re-enter the exact-value path
                cols.append(
                    np.asarray(arr.tolist(), dtype=f.dtype.to_numpy())
                    if f.dtype.is_numeric
                    else arr
                )
            new_gids = new.intern(cols)
            remap = dict(zip(gids_sorted, (int(x) for x in new_gids)))
            self._frames = {
                j: {remap[g]: accs for g, accs in fr.items()}
                for j, fr in self._frames.items()
            }
        self._interner = new

    def _emit(self, j: int) -> RecordBatch | None:
        if self._tier is not None:
            # blocks holding entries of this window reload first — markers
            # resolve in place, so the emission order is kept
            self._tier.reload_for_window(j)
        frame = self._frames.pop(j, None)
        if not frame:
            return None
        self._metrics["windows_emitted"] += 1
        self._obs_windows.add(1)
        if self._obs_emit_lag:
            self._obs_emit_lag.observe(
                time.time() * 1000.0 - (j * self.slide_ms + self.length_ms)
            )
        if self._dr_lineage is not None:
            self._dr_lineage.emitted(
                self._dr_node_id,
                j * self.slide_ms,
                j * self.slide_ms + self.length_ms,
            )
        m = len(frame)
        items = list(frame.items())
        cols: list[np.ndarray] = []
        in_schema = self.input_op.schema
        if self.group_exprs:
            key_arrays = self._interner.keys_of(
                np.asarray([g for g, _ in items], dtype=np.int64)
            )
            for g, vals in zip(self.group_exprs, key_arrays):
                f = g.out_field(in_schema)
                if f.dtype.is_numeric:
                    vals = np.asarray(vals.tolist(), dtype=f.dtype.to_numpy())
                cols.append(vals)
        for ai, a in enumerate(self.aggr_exprs):
            f = a.out_field(in_schema)
            # element-wise fill: np.array(list_of_lists, dtype=object) would
            # build a 2-D array when every list has the same length
            arr = np.empty(m, dtype=object)
            for vi, (_, accs) in enumerate(items):
                arr[vi] = accs[ai].evaluate()
            if f.dtype.is_numeric:
                arr = arr.astype(f.dtype.to_numpy())
            cols.append(arr)
        start = np.full(m, j * self.slide_ms, dtype=np.int64)
        end = np.full(m, j * self.slide_ms + self.length_ms, dtype=np.int64)
        cols += [start, end, start.copy()]
        return RecordBatch(self.schema, cols)

    # -- checkpointing: accumulator state() lists, the capability the
    # reference prototypes in SerializableAccumulator
    # (accumulators/serializable_accumulator.rs:10-68) ------------------
    def enable_checkpointing(self, node_id: str, coord, orch) -> None:
        self._ckpt = (coord, f"udafwin_{node_id}")
        snap = get_json(coord, self._ckpt[1])
        if snap is None:
            return
        self._first_open = snap["first_open"]
        self._max_win_seen = snap["max_win_seen"]
        self._watermark = snap["watermark"]
        self._frames = {}
        for j_str, groups in snap["frames"].items():
            frame: dict[int, list] = {}
            for key_list, states in groups:
                if self._interner is not None:
                    gid = int(
                        self._interner.intern(
                            [np.asarray([v]) for v in key_list]
                        )[0]
                    )
                else:
                    gid = 0
                if states is None:
                    # spilled at the cut: the marker holds the group's
                    # recorded position (the tier restore, or the resident
                    # load below, overwrites it IN PLACE, so the emission
                    # row order is the uninterrupted run's)
                    frame[gid] = SPILLED
                    continue
                accs = self._make_accs()
                for acc, st in zip(accs, states):
                    acc.merge(st)
                frame[gid] = accs
            self._frames[int(j_str)] = frame
        bids = snap.get("spill_blocks") or []
        if bids:
            if self._tier is not None:
                self._tier.restore_refs(coord, self._ckpt[1], bids)
            else:
                self._restore_spilled_resident(coord, self._ckpt[1], bids)

    def _restore_spilled_resident(self, coord, key: str, bids: list) -> None:
        """Budget removed since the checkpoint: the cold tier's blocks load
        back resident."""
        for bid in bids:
            raw = coord.get_snapshot(f"{key}:spill:b{bid}")
            if raw is None:
                raise StateError(
                    f"checkpoint references spilled UDAF block b{bid} "
                    "but the epoch holds no such snapshot"
                )
            self._merge_block(unpack_snapshot(raw)[0])

    def _block_gids(self, bmeta: dict) -> np.ndarray:
        """A spilled block's gids in this run: its key values re-interned
        (the gid space may have been rebuilt since)."""
        if bmeta["keys"] is not None and self._interner is not None:
            key_cols = tiering.key_columns_from_meta(bmeta["keys"])
            return self._interner.intern(key_cols).astype(np.int64)
        return np.zeros(1, dtype=np.int64)

    def _merge_block(self, bmeta: dict) -> np.ndarray:
        """Load one spilled block's accumulator states into the frames,
        each replacing its marker IN PLACE (dict order, so emission row
        order, is the all-resident run's) → the block's gids."""
        chunk_gids = self._block_gids(bmeta)
        for j_str, row in bmeta["entries"].items():
            frame = self._frames.setdefault(int(j_str), {})
            for posi, states in row:
                accs = self._make_accs()
                for acc, st in zip(accs, states):
                    acc.merge(st)
                frame[int(chunk_gids[int(posi)])] = accs
        return chunk_gids

    def _snapshot(self, epoch: int) -> None:
        # put_json's `jsonable` converts numpy scalars and arrays in both
        # keys and user accumulator state() payloads
        coord, key = self._ckpt
        # frames persist key VALUES (stable across restarts), not gids;
        # one keys_of call a frame.  Dict order IS emission row order, so
        # each frame's groups are recorded in position
        frames = {}
        for j, frame in self._frames.items():
            gids = list(frame.keys())
            if self._interner is not None and gids:
                key_arrays = self._interner.keys_of(
                    np.asarray(gids, dtype=np.int64)
                )
                keys_per_gid = [
                    [col[i] for col in key_arrays] for i in range(len(gids))
                ]
            else:
                keys_per_gid = [[] for _ in gids]
            # a spilled marker persists in position as states=None: its
            # states commit under this SAME epoch in a referenced block
            frames[str(j)] = [
                [
                    kv,
                    None if frame[g] is SPILLED
                    else [acc.state() for acc in frame[g]],
                ]
                for g, kv in zip(gids, keys_per_gid)
            ]
        snap = {
            "epoch": epoch,
            "first_open": self._first_open,
            "max_win_seen": self._max_win_seen,
            "watermark": self._watermark,
            "frames": frames,
        }
        if self._tier is not None and self._tier.any_spilled:
            snap["spill_blocks"] = self._tier.snapshot_refs(coord, key, epoch)
        put_json(coord, key, epoch, snap)

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
                if self._watermark is None or item.ts_ms > self._watermark:
                    self._watermark = item.ts_ms
                    yield from self._trigger()
                # emissions stamp canonical ts with the window START:
                # forward clamped below the lowest still-emittable start
                # so downstream never late-drops our output
                low = window_output_low_watermark(
                    self._first_open, self.slide_ms, self.length_ms,
                    item.ts_ms,
                    wm_ms=self._watermark if self._src_watermarks else None,
                )
                yield WatermarkHint(min(item.ts_ms, low), kind=item.kind)
            elif isinstance(item, Marker):
                if self._ckpt is not None:
                    self._snapshot(item.epoch)
                yield item
            elif isinstance(item, EndOfStream):
                if self.emit_on_close and self._first_open is not None:
                    for j in range(self._first_open, self._max_win_seen + 1):
                        b = self._emit(j)
                        if b is not None:
                            yield b
                    self._first_open = self._max_win_seen + 1
                yield EOS
                return
