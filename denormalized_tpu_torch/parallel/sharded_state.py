"""Window-state backends — counterpart of
``denormalized_tpu/parallel/sharded_state.py``.

:class:`SingleDeviceWindowState` holds the ring on one explicit ``device``
(``cuda`` or, for the tests, ``cpu``) and ships rows to it every batch.  Per
batch it runs the dense kernel (``ops/dense_window.py``) where the spec and
the batch allow it, else the scatter program (``ops/segment_agg.py``) — the
JAX package's per-batch rule, counted in ``dense_updates`` and
``scatter_updates`` (and, over every backend of the process, in the module's
``scatter_steps``, as ``dense_window_launches`` counts the kernel's).

:class:`PartialMergeWindowState` (``device_strategy='partial_merge'``)
reduces each batch on the host into a stripe of per-(slide unit, sub,
group) partials (``ops/host_partial.py``) and folds the packed stripe into
the same ring with one launch of the merge kernel
(``ops/merge_partials.py``) a merge, counted in ``merges``; on a card the
stripe crosses through a reusable pinned host buffer.

Checkpoints export the ring without stopping ingest:
:meth:`SingleDeviceWindowState.export_start` clones the ring on the current
stream and copies the clone to pinned host memory on a side stream;
:meth:`~SingleDeviceWindowState.export_finish` waits for that copy alone.
Emission reads blocks of slots the same way
(:meth:`~SingleDeviceWindowState.read_reset_block_start` /
:meth:`~SingleDeviceWindowState.read_reset_block_finish`), so the window
operator can drain a block a trigger later, and
:meth:`~SingleDeviceWindowState.read_slot_compact` moves only a slot's
active cells, through the compaction kernel.

The sharded layouts run over a :class:`~denormalized_tpu_torch.parallel.
mesh.Mesh`, one ring shard a mesh position, each a
:class:`SingleDeviceWindowState` on its position's device (several shards
may share a device).  Each of the JAX package's ``shard_map`` programs is a
plain function over the shards' tensors:

- :class:`KeyShardedWindowState` — shard i owns groups ``[i·G_local,
  (i+1)·G_local)``; the batch is copied once to each distinct device and
  every shard rebases the gids and masks the other shards' rows before its
  scatter step.  Reads join the shards' columns.
- :class:`KeyShardedPartialMergeWindowState` — ``partial_merge`` over the
  key-sharded ring: the host stripe spans the global group space, and each
  shard folds its own block from the replicated stripe with one merge
  launch (``g_shift = i·G_local``).  Emission (component blocks, finals,
  compaction) runs per shard and is joined on the host.
- :class:`PartialFinalWindowState` — rows split evenly over the shards,
  each holding a full ``(W, G)`` ring; a read folds one slot over the
  shards (sum for count/sum, min, max) on the lead shard's device.
- :class:`TwoLevelWindowState` — a 2-D ``(slices, keys)`` mesh: rows split
  over slices, keys sharded within a slice; a read folds over slices.

Sharded row shipping runs the scatter program, as the JAX package's
sharded updates do.  Snapshots are merged ``(W, G_total)`` planes, the JAX
package's format, so a snapshot restores into any layout; the partial
layouts load it into their lead shard.  Per-shard counts of scatter steps,
merges and compactions live in each layout's ``shard_scatter``,
``shard_merges`` and ``shard_compactions``.  In a multi-process job
(``parallel/distributed.py``) a layout holds only its process's shards and
its reads fold across processes with collectives.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace

import numpy as np
import torch

from denormalized_tpu_torch.ops import dense_window as dw
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.ops.host_partial import HostPartialStripe
from denormalized_tpu_torch.ops.merge_partials import merge_partials
from denormalized_tpu_torch.parallel.mesh import KEY_AXIS, SLICE_AXIS, Mesh

#: steps of the scatter program over every backend of the process
#: (``chip_smoke.py`` sets it to 0 before a run and reads it after)
scatter_steps = 0
_STEPS_LOCK = threading.Lock()  # two window operators step from two threads


class WindowStateBackend:
    """Interface the window operator drives."""

    spec: sa.WindowKernelSpec
    # link-traffic accounting (numpy-payload bytes handed to/from the
    # device)
    bytes_h2d: int = 0
    bytes_d2h: int = 0
    # True for backends that take host partials through accumulate()
    # instead of rows through update()
    accumulates_host = False

    @property
    def strategy_name(self) -> str:
        """What actually executes."""
        return type(self).__name__

    @property
    def group_capacity(self) -> int:
        """Total group-id capacity visible to the host interner."""
        raise NotImplementedError

    def update(
        self, values, colvalid, win_rel, rem, gid, row_valid, base_mod,
        min_win_rel: int | None = None, max_win_rel: int | None = None,
    ):
        raise NotImplementedError

    def flush_pending(self) -> None:
        """Fold pending host partials into the ring (row shipping holds
        none)."""

    def read_reset_block(self, first_slot: int, n: int) -> dict[str, np.ndarray]:
        """Read and reset n consecutive ring slots → ``(n, G)`` planes; the
        default is a per-slot loop (the row-shipping sharded layouts)."""
        rows = []
        for i in range(n):
            slot = (first_slot + i) % self.spec.window_slots
            rows.append(self.read_slot(slot))
            self.reset_slot(slot)
        return {label: np.stack([r[label] for r in rows]) for label in rows[0]}

    # -- emission: start dispatches a block's gather+reset and its copy to
    # the host and returns a handle; finish materializes it.  The default
    # is synchronous: start does the work
    def read_reset_block_start(
        self, first_slot: int, n: int, live_groups=None, lean=False
    ):
        """Start reading and resetting n consecutive ring slots (component
        planes)."""
        return self.read_reset_block(first_slot, n)

    def read_reset_block_finish(self, handle) -> dict[str, np.ndarray]:
        return handle

    def prepare_finals(self, agg_specs: tuple) -> None:
        """Announce the output aggregate specs for on-device
        finalization."""

    def read_reset_block_finals_start(
        self, first_slot: int, n: int, live_groups=None
    ):
        """Start a finals emission (final output planes + active mask, see
        segment_agg._finals_and_reset) for n ring slots — or None when
        finals were not prepared (caller takes the component path)."""
        return None

    def read_slot(self, slot: int) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def read_slot_compact(self, slot: int):
        """(active gids ascending, aligned component rows) of one slot,
        compacted on the device — or None where the layout does not compact
        (the caller then reads the whole slot)."""
        return None

    def reset_slot(self, slot: int) -> None:
        raise NotImplementedError

    def write_slots(self, slots: list[int], planes: dict[str, np.ndarray]) -> None:
        """Overwrite whole ring slots from ``(len(slots), G)`` host planes."""
        raise NotImplementedError

    def export(self) -> dict[str, np.ndarray]:
        """(W, G) host snapshot for growth and for carrying state across."""
        raise NotImplementedError

    # -- checkpoint export: start returns a handle, finish the planes.  The
    # default is synchronous
    def export_start(self):
        return self.export()

    def export_finish(self, handle) -> dict[str, np.ndarray]:
        return handle

    def import_(self, host_state: dict[str, np.ndarray]) -> None:
        raise NotImplementedError

    def carry_counters(self, old: "WindowStateBackend") -> None:
        """Add the counters of ``old``, the backend this one replaces on a
        growth or restore, so they cover the whole run."""
        self.bytes_h2d += old.bytes_h2d
        self.bytes_d2h += old.bytes_d2h


@dataclass
class AsyncExport:
    """A copy to the host in flight (an export, or an emission block): the
    host planes and, on a CUDA ring, the device tensors they copy (ring
    clones, gathered slots; kept referenced until the copy is done) and the
    event the side stream records after the last copy into the planes'
    pinned buffers.  On the CPU the planes are already numpy and there is
    no event."""

    host: dict
    clones: dict[str, torch.Tensor] | None = None
    done: torch.cuda.Event | None = None


class SingleDeviceWindowState(WindowStateBackend):
    def __init__(
        self,
        spec: sa.WindowKernelSpec,
        device: torch.device | str,
        device_strategy: str = "scatter",
    ):
        self.spec = spec
        self.device = torch.device(device)
        self._state = sa.init_state(spec, self.device)
        self.device_strategy = device_strategy
        self._finals_specs: tuple | None = None
        self._side: torch.cuda.Stream | None = None  # export copies
        # actual dispatch counts: 'pallas_dense'/'auto' fall back to the
        # scatter program per batch when the kernel doesn't support the
        # spec or the batch shape — strategy_name reports what RAN
        self.dense_updates = 0
        self.scatter_updates = 0

    @property
    def strategy_name(self) -> str:
        if self.device_strategy == "scatter":
            return "row_shipping:scatter"
        if self.dense_updates and self.scatter_updates:
            return "row_shipping:dense+scatter"
        if self.dense_updates:
            return "row_shipping:dense"
        if self.scatter_updates:
            return "row_shipping:scatter"
        return f"row_shipping:{self.device_strategy} (no batches yet)"

    @property
    def group_capacity(self) -> int:
        return self.spec.group_capacity

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def update(
        self, values, colvalid, win_rel, rem, gid, row_valid, base_mod,
        min_win_rel: int | None = None, max_win_rel: int | None = None,
    ):
        host = (values, colvalid, win_rel, rem, gid, row_valid)
        self.bytes_h2d += sum(int(np.asarray(a).nbytes) for a in host)
        values, colvalid, win_rel, rem, gid, row_valid = (
            self._to_device(a) for a in host
        )
        # 'auto' runs the dense kernel wherever it fits, on the card and on
        # the CPU alike (the JAX package's rule for a co-located GPU)
        try_dense = self.device_strategy in ("pallas_dense", "auto")
        if try_dense and min_win_rel is not None:
            lo = max(min_win_rel - (self.spec.length_units - 1), 0)
            span_ok = (
                max_win_rel is not None and max_win_rel - lo < dw.K_ACTIVE
            )
            tile_ok = values.shape[0] % dw.TILE == 0
            if dw.dense_supported(self.spec) and span_ok and tile_ok:
                self.dense_updates += 1
                dw.dense_update(
                    self.spec, self._state, values, colvalid, win_rel, rem,
                    gid, row_valid, int(base_mod), min_win_rel=lo,
                )
                return
        global scatter_steps
        self.scatter_updates += 1
        with _STEPS_LOCK:
            scatter_steps += 1
        sa.update_state(
            self.spec, self._state, values, colvalid, win_rel, rem, gid,
            row_valid, int(base_mod),
        )

    def read_slot(self, slot: int) -> dict[str, np.ndarray]:
        out = sa.read_slot(self.spec, self._state, slot)
        self.bytes_d2h += sum(int(a.nbytes) for a in out.values())
        return out

    def read_slot_compact(self, slot: int):
        """One slot's active cells through the compaction kernel → (gids
        ascending, aligned component rows)."""
        gids, rows = sa.read_slot_compact(self.spec, self._state, slot)
        self._count_compact_d2h(gids, rows, self.spec.group_capacity)
        return gids, rows

    def _count_compact_d2h(self, gids, rows, capacity) -> None:
        """A compact read moves the power-of-two BUCKET covering the k
        active groups (cut to k on the host after the copy), plus the
        count."""
        k = len(gids)
        if k == 0:
            self.bytes_d2h += 4
            return
        bucket = min(1 << (k - 1).bit_length(), capacity)
        per_elem = gids.dtype.itemsize + sum(
            a.dtype.itemsize for a in rows.values()
        )
        self.bytes_d2h += 4 + bucket * per_elem

    def reset_slot(self, slot: int) -> None:
        sa.reset_slot(self.spec, self._state, slot)

    def write_slots(self, slots: list[int], planes: dict[str, np.ndarray]) -> None:
        """Overwrite whole ring slots from the host: ``planes[label]`` is
        ``(len(slots), G)``, row i going to slot ``slots[i]`` — one copy to
        the device and one indexed copy a plane, on the current stream (the
        cold tier's reload writes only the slots it brings back, never the
        whole ring)."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        for label, arr in planes.items():
            ring = self._state[label]
            self.bytes_h2d += int(arr.nbytes)
            src = torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=self.device, dtype=ring.dtype
            )
            ring.index_copy_(0, idx, src)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def _host_copy_start(self, tensors: dict[str, torch.Tensor]) -> AsyncExport:
        """Start copying ``tensors`` to the host without waiting for them.

        On a CUDA ring: record an event on the current stream (where the
        kernels that wrote the tensors run, so it follows them), and on
        this backend's side stream wait for it and copy each tensor into a
        pinned host buffer.  The tensors stay referenced in the handle and
        are marked as used on the side stream, so the caching allocator
        cannot hand their memory to a later kernel's output while the copy
        reads it.  Pinned buffers come from torch's caching host allocator:
        a buffer is reused only once the arrays of an earlier finish are
        freed and its copy has completed.  A failed pinned allocation
        raises.  On the CPU the copy is synchronous."""
        if self.device.type != "cuda":
            return AsyncExport({k: sa.to_host(v) for k, v in tensors.items()})
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        side = self._side_stream()
        host = {}
        with torch.cuda.stream(side):
            side.wait_event(ready)
            for label, t in tensors.items():
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                t.record_stream(side)
                host[label] = buf
        done = torch.cuda.Event()
        done.record(side)
        return AsyncExport(host, tensors, done)

    def _host_copy_finish(self, handle: AsyncExport) -> dict[str, np.ndarray]:
        """Wait for a copy started by :meth:`_host_copy_start` (its event,
        not the whole device) → numpy planes."""
        if handle.done is not None:
            handle.done.synchronize()
        out = {label: np.asarray(buf) for label, buf in handle.host.items()}
        self.bytes_d2h += sum(int(a.nbytes) for a in out.values())
        return out

    def read_reset_block_start(
        self, first_slot: int, n: int, live_groups=None, lean=False
    ) -> AsyncExport:
        """Fused gather+reset of n ring slots, limited to the live-group
        bucket (see :meth:`_live_bucket`), on the current stream; their
        copy to the host runs on the side stream after the gather."""
        if n > self.spec.window_slots:  # slots must be distinct
            raise ValueError(f"{n} slots from a {self.spec.window_slots}-slot ring")
        return self._host_copy_start(
            sa._gather_and_reset(
                self.spec, n, self._live_bucket(live_groups), self._state,
                first_slot, lean,
            )
        )

    def read_reset_block_finish(self, handle: AsyncExport) -> dict[str, np.ndarray]:
        return self._host_copy_finish(handle)

    def prepare_finals(self, agg_specs: tuple) -> None:
        self._finals_specs = tuple(agg_specs)

    def _live_bucket(self, live_groups) -> int:
        """Transferred group width: pow2 of the interner's live size
        (floor 1024), capped at capacity — gids are interner-dense, so
        every cell at index ≥ live_groups is still at its init value."""
        g_bucket = self.group_capacity
        if live_groups is not None:
            g_bucket = min(
                g_bucket,
                max(1024, 1 << max(0, int(live_groups) - 1).bit_length()),
            )
        return g_bucket

    def read_reset_block_finals_start(
        self, first_slot: int, n: int, live_groups=None
    ) -> AsyncExport | None:
        if self._finals_specs is None:
            return None
        if n > self.spec.window_slots:
            raise ValueError(f"{n} slots from a {self.spec.window_slots}-slot ring")
        return self._host_copy_start(
            sa._finals_and_reset(
                self.spec, self._finals_specs, n,
                self._live_bucket(live_groups), self._state, first_slot,
            )
        )

    def export(self) -> dict[str, np.ndarray]:
        return sa.export_state(self._state)

    def export_start(self):
        """Start an export that later in-place updates cannot change: clone
        every plane on the current stream (where the kernels run, so the
        clone is ordered before any later update) and copy the clones to
        the host on the side stream (:meth:`_host_copy_start`).  On the CPU
        the export is a synchronous copy."""
        if self.device.type != "cuda":
            return AsyncExport(sa.export_state(self._state))
        return self._host_copy_start(sa.clone_state(self._state))

    def export_finish(self, handle: AsyncExport) -> dict[str, np.ndarray]:
        """Wait for an export's copy (its event, not the whole device) →
        ``(W, G)`` numpy planes keyed by component label."""
        return self._host_copy_finish(handle)

    def import_(self, host_state: dict[str, np.ndarray]) -> None:
        self._state = sa.import_state(self.spec, host_state, self.device)

    def carry_counters(self, old: WindowStateBackend) -> None:
        super().carry_counters(old)
        self.dense_updates += getattr(old, "dense_updates", 0)
        self.scatter_updates += getattr(old, "scatter_updates", 0)


class _StripeStager:
    """Moves packed stripes to one device.  On a card a stripe goes through
    one reusable pinned host buffer, copied with ``non_blocking`` on the
    current stream (the kernels' stream, so a merge launched next on it
    waits for the copy); the host waits for the event of the buffer's
    previous copy before writing it again."""

    def __init__(self, device: torch.device):
        self.device = device
        self._staging: torch.Tensor | None = None
        self._staged: torch.cuda.Event | None = None

    def stage(self, packed: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.from_numpy(packed)
        if self._staged is not None:
            self._staged.synchronize()
        if self._staging is None or self._staging.numel() < packed.size:
            self._staging = torch.empty(
                1 << max(0, packed.size - 1).bit_length(), dtype=torch.int32,
                pin_memory=True,
            )
        host = self._staging[: packed.size].view(packed.shape)
        np.copyto(host.numpy(), packed)
        out = torch.empty(packed.shape, dtype=torch.int32, device=self.device)
        out.copy_(host, non_blocking=True)
        if self._staged is None:
            self._staged = torch.cuda.Event()
        self._staged.record(torch.cuda.current_stream(self.device))
        return out


class _HostPartialMixin:
    """Host-stripe machinery of the partial_merge backends: batch chunk
    folding and flush orchestration.  The concrete class provides
    ``_merge(packed, a_pad, lean, dense)``."""

    accumulates_host = True

    def _init_host_partial(self, stripe_group_capacity: int) -> None:
        self._stripe = HostPartialStripe(self.spec, stripe_group_capacity)
        self._pending_base_mod = 0
        self.merges = 0

    @property
    def stripe(self) -> HostPartialStripe:
        return self._stripe

    @property
    def pending_rows(self) -> int:
        return self._stripe.rows

    def update(self, *a, **k):
        raise RuntimeError(
            "partial_merge backend consumes host partials via accumulate(); "
            "the operator must not ship rows to it"
        )

    def accumulate(
        self, units_rel, rem, gid, values64, colvalid, keep, base_mod
    ) -> None:
        """Fold one batch into the host stripe, flushing and chunking so no
        row is ever dropped: a batch spanning more slide units than a
        stripe can hold is folded in unit-range chunks with a merge between
        them."""
        units_rel = np.asarray(units_rel, np.int64)
        stripe = self._stripe
        # units a stripe may span: both the U_MAX ring and the transfer
        # cell cap (at least one unit)
        span_u = max(
            1,
            min(
                stripe.U_MAX,
                stripe.MAX_STRIPE_CELLS // max(1, stripe.G * stripe.SUB),
            ),
        )
        if keep is None and len(units_rel):
            # steady state: no keep mask and the whole batch fits the
            # current stripe — one fold, no boolean scans.  Anything that
            # needs a flush falls through to the chunk loop below
            u_min = int(units_rel.min())
            u_max = int(units_rel.max())
            base = stripe.u_base if not stripe.is_empty() else u_min
            if (
                u_min >= base
                and u_max <= base + span_u - 1
                and (
                    stripe.is_empty()
                    or stripe.rows + len(units_rel) <= stripe.MAX_STRIPE_ROWS
                )
            ):
                if stripe.is_empty():
                    self._pending_base_mod = int(base_mod)
                stripe.add_batch(units_rel, rem, gid, values64, colvalid, None)
                return
        remaining = (
            np.ones(len(units_rel), bool) if keep is None else keep.copy()
        )
        while remaining.any():
            u0 = int(units_rel[remaining].min())
            if not stripe.is_empty() and (
                u0 < stripe.u_base or stripe.rows >= stripe.MAX_STRIPE_ROWS
            ):
                self.flush_pending()
            base = stripe.u_base if not stripe.is_empty() else u0
            chunk = (
                remaining
                & (units_rel >= base)
                & (units_rel <= base + span_u - 1)
            )
            n_chunk = int(chunk.sum())
            if n_chunk == 0 or (
                not stripe.is_empty()
                and stripe.rows + n_chunk > stripe.MAX_STRIPE_ROWS
            ):
                self.flush_pending()
                continue
            if stripe.is_empty():
                self._pending_base_mod = int(base_mod)
            stripe.add_batch(units_rel, rem, gid, values64, colvalid, chunk)
            remaining &= ~chunk

    def flush_pending(self) -> None:
        """Pack the stripe and fold it into the ring (one merge)."""
        taken = self._stripe.take_packed(self._pending_base_mod)
        if taken is None:
            return
        packed, a_pad, _u_base, lean, dense = taken
        self.bytes_h2d += int(packed.nbytes)
        self._merge(packed, a_pad, lean, dense)
        self.merges += 1

    def carry_counters(self, old) -> None:
        super().carry_counters(old)
        self.merges += old.merges
        new, prev = self._stripe, old.stripe
        new.native_batches += prev.native_batches
        new.numpy_batches += prev.numpy_batches
        new.reduce_s += prev.reduce_s
        new.pack_s += prev.pack_s


class PartialMergeWindowState(_HostPartialMixin, SingleDeviceWindowState):
    """Host edge-reduction + device merge (the ``partial_merge``
    strategy): rows are reduced on the host into per-(slide unit, sub,
    group) partials (native C++ single pass, ``ops/host_partial.py``) and
    the device folds each stripe into the ring with ONE transfer and ONE
    kernel launch.  Emission, growth and export are the scatter path's."""

    def __init__(self, spec: sa.WindowKernelSpec, device: torch.device | str):
        super().__init__(spec, device, "scatter")
        self._init_host_partial(spec.group_capacity)
        self._stager = _StripeStager(self.device)
        # merges by (thread name, CUDA stream handle) they launched from:
        # a host pipeline's worker must launch on the operator's stream
        self.merge_sites: dict[tuple[str, int], int] = {}

    @property
    def strategy_name(self) -> str:
        return "partial_merge"

    def _merge(
        self, packed: np.ndarray, a_pad: int, lean: bool, dense: bool
    ) -> None:
        if self.device.type == "cuda":
            site = (threading.current_thread().name,
                    torch.cuda.current_stream(self.device).cuda_stream)
            self.merge_sites[site] = self.merge_sites.get(site, 0) + 1
        merge_partials(
            self.spec, self._stripe.SUB, a_pad, lean, dense, self._state,
            self._stager.stage(packed),
        )

    def read_slot_compact(self, slot: int):
        """The stripe folds into the ring first: the compacted slot must
        hold every row ingested so far."""
        self.flush_pending()
        return super().read_slot_compact(slot)




# ---------------------------------------------------------------------------
# sharded layouts


def _count_scatter() -> None:
    global scatter_steps
    with _STEPS_LOCK:
        scatter_steps += 1


def _local_spec(spec: sa.WindowKernelSpec, n_key: int) -> sa.WindowKernelSpec:
    """The spec of one key shard: G_local = G_total / n_key."""
    return replace(spec, group_capacity=spec.group_capacity // n_key)


def _mask_to_key_shard(G_local: int, shard: int, gid: torch.Tensor,
                       row_valid: torch.Tensor):
    """Rebase global group ids onto key shard ``shard``'s block and mask out
    every other shard's rows — the one place the key-sharded "exchange
    rides the broadcast" is implemented (the 1-D and 2-D layouts use it)."""
    local = gid - shard * G_local
    mine = row_valid & (local >= 0) & (local < G_local)
    return local.clamp(0, G_local - 1), mine


def _merge_slot_over(
    spec: sa.WindowKernelSpec, rows: list[dict[str, torch.Tensor]],
    device: torch.device,
) -> dict[str, torch.Tensor]:
    """Final merge of one window row over shard partials on ``device``: sum
    for count/sum/sumc, min, max — the reference's Final stage; the one
    fold both partial layouts use."""
    out = {}
    for c in spec.components:
        st = torch.stack([r[c.label].to(device) for r in rows])
        if c.kind in ("count", "sum", "sumc"):
            out[c.label] = st.sum(0, dtype=st.dtype)
        elif c.kind == "min":
            out[c.label] = st.amin(0)
        else:
            out[c.label] = st.amax(0)
    return out


def _fold_partials_host(
    spec: sa.WindowKernelSpec, host: dict, axis: int = 0
) -> dict:
    """Host fold of stacked shard partial planes along ``axis`` (the export
    path's counterpart of :func:`_merge_slot_over`); counts keep the ring's
    int32."""
    out = {}
    for c in spec.components:
        b = host[c.label]
        if c.kind in ("count", "sum", "sumc"):
            out[c.label] = b.sum(axis=axis, dtype=b.dtype)
        elif c.kind == "min":
            out[c.label] = b.min(axis=axis)
        else:
            out[c.label] = b.max(axis=axis)
    return out


def _init_planes(spec: sa.WindowKernelSpec, shape: tuple) -> dict:
    """Host planes of ``shape`` at each component's init value — the fold
    identity (0, +inf, -inf)."""
    return {
        c.label: sa.to_host(
            torch.full(shape, spec.init_value(c), dtype=spec.init_dtype(c))
        )
        for c in spec.components
    }


# -- collectives of a multi-process mesh ------------------------------------


def _coll_device() -> torch.device:
    """Where collective buffers live: the card under NCCL, else the CPU."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce_planes(spec: sa.WindowKernelSpec, planes: dict) -> dict:
    """Fold host planes over every process of the job by component kind
    (SUM, MIN, MAX); each process passes its local fold, with the fold
    identity where it holds no shard."""
    import torch.distributed as dist

    ops = {"count": dist.ReduceOp.SUM, "sum": dist.ReduceOp.SUM,
           "sumc": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}
    dev = _coll_device()
    out = {}
    for c in spec.components:
        t = torch.from_numpy(np.ascontiguousarray(planes[c.label])).to(dev)
        dist.all_reduce(t, op=ops[c.kind])
        out[c.label] = sa.to_host(t)
    return out


def _gather_blocks(mesh: Mesh, local: dict[int, dict]) -> dict[int, dict]:
    """Every shard's host planes on every process: one ``all_gather`` a
    label of each process's stacked local planes (each process holds as
    many shards of one shape).  A one-process mesh returns ``local``."""
    if not mesh.spans_processes:
        return local
    import torch.distributed as dist

    dev = _coll_device()
    world = dist.get_world_size()
    order = sorted(local)
    where = [np.flatnonzero(mesh.ranks.ravel() == r) for r in range(world)]
    out: dict[int, dict] = {}
    for label in local[order[0]]:
        a = np.stack([local[i][label] for i in order])
        flag = a.dtype == bool  # gloo has no bool collectives
        t = torch.from_numpy(a.view(np.uint8) if flag else a).to(dev)
        bufs = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(bufs, t)
        for r, buf in enumerate(bufs):
            arr = sa.to_host(buf)
            if flag:
                arr = arr.view(bool)
            for k, pos in enumerate(where[r]):
                out.setdefault(int(pos), {})[label] = arr[k]
    return out


class _ShardedLayout(WindowStateBackend):
    """The shards this process holds — one :class:`SingleDeviceWindowState`
    a mesh position, keyed by its flat index — and the per-shard counts of
    scatter steps, merges and compactions.  ``scatter_updates`` counts the
    batches shipped (each a scatter step in every shard)."""

    dense_updates = 0  # sharded row shipping runs the scatter program

    def _init_shards(self, mesh: Mesh, local_spec: sa.WindowKernelSpec) -> None:
        self.mesh = mesh
        self.n = mesh.size
        # this process's shards by flat mesh index
        self.shards: dict[int, SingleDeviceWindowState] = {
            i: SingleDeviceWindowState(local_spec, d, "scatter")
            for i, d in enumerate(mesh.devices.flat)
            if mesh.is_local(i)
        }
        self.scatter_updates = 0
        self.shard_scatter = [0] * self.n
        self.shard_merges = [0] * self.n
        self.shard_compactions = [0] * self.n

    def _copy_rows(self, host: tuple, idx) -> dict:
        """``host`` arrays on each distinct device of shards ``idx``, copied
        once a device (not once a shard)."""
        nbytes = sum(int(np.asarray(a).nbytes) for a in host)
        out = {}
        for i in idx:
            d = self.shards[i].device
            if d not in out:
                out[d] = tuple(
                    torch.from_numpy(np.ascontiguousarray(a)).to(d)
                    for a in host
                )
                self.bytes_h2d += nbytes
        return out

    def _step(self, i: int, values, colvalid, win_rel, rem, gid, row_valid,
              base_mod) -> None:
        """One scatter step of shard ``i`` on its ring."""
        self.shard_scatter[i] += 1
        _count_scatter()
        sa.update_state(
            self.spec, self.shards[i]._state, values, colvalid, win_rel, rem,
            gid, row_valid, int(base_mod),
        )

    def _row_split(self, values, parts: int) -> int:
        """Rows a part when a batch splits evenly ``parts`` ways (the
        operator pads batches to a multiple of the mesh size)."""
        B = int(np.shape(values)[0])
        if B % parts:
            raise ValueError(f"{B} rows do not split over {parts} parts")
        return B // parts

    def reset_slot(self, slot: int) -> None:
        for sh in self.shards.values():
            sh.reset_slot(slot)

    def carry_counters(self, old: WindowStateBackend) -> None:
        super().carry_counters(old)
        self.scatter_updates += old.scatter_updates
        if getattr(old, "n", None) == self.n:
            for name in ("shard_scatter", "shard_merges", "shard_compactions"):
                setattr(self, name, [
                    a + b for a, b in zip(getattr(self, name), getattr(old, name))
                ])


class KeyShardedWindowState(_ShardedLayout):
    """Group axis sharded over the mesh; batch replicated; no per-batch
    collectives."""

    strategy_name = "key_sharded"

    def __init__(self, spec: sa.WindowKernelSpec, mesh: Mesh):
        # spec is the GLOBAL spec; each shard holds G_total / n
        n = mesh.size
        if spec.group_capacity % n:
            raise ValueError(
                f"group capacity {spec.group_capacity} is not divisible by "
                f"the mesh size {n}"
            )
        self.spec = _local_spec(spec, n)
        self._init_shards(mesh, self.spec)

    @property
    def group_capacity(self) -> int:
        return self.spec.group_capacity * self.n

    def update(
        self, values, colvalid, win_rel, rem, gid, row_valid, base_mod,
        min_win_rel=None, max_win_rel=None,
    ):
        self.scatter_updates += 1
        on = self._copy_rows(
            (values, colvalid, win_rel, rem, gid, row_valid), self.shards
        )
        G = self.spec.group_capacity
        for i, sh in self.shards.items():
            v, cv, wr, rm, g, rv = on[sh.device]
            local_gid, mine = _mask_to_key_shard(G, i, g, rv)
            self._step(i, v, cv, wr, rm, local_gid, mine, base_mod)

    def _join(self, parts: dict[int, dict], axis: int) -> dict[str, np.ndarray]:
        """The shards' planes side by side along the group ``axis`` (from
        every process of the job)."""
        parts = _gather_blocks(self.mesh, parts)
        order = sorted(parts)
        return {
            label: np.concatenate([parts[i][label] for i in order], axis=axis)
            for label in parts[order[0]]
        }

    def read_slot(self, slot: int) -> dict[str, np.ndarray]:
        out = self._join(
            {i: sh.read_slot(slot) for i, sh in self.shards.items()}, 0
        )
        self.bytes_d2h += sum(int(a.nbytes) for a in out.values())
        return out

    def write_slots(self, slots: list[int], planes: dict[str, np.ndarray]) -> None:
        G = self.spec.group_capacity
        for i, sh in self.shards.items():
            sh.write_slots(
                slots, {k: a[:, i * G:(i + 1) * G] for k, a in planes.items()}
            )

    def export(self) -> dict[str, np.ndarray]:
        """Merged ``(W, G_total)`` planes."""
        return self._join({i: sh.export() for i, sh in self.shards.items()}, 1)

    def export_start(self):
        """Each shard's asynchronous export (a ring clone copied on its
        side stream)."""
        return {i: sh.export_start() for i, sh in self.shards.items()}

    def export_finish(self, handle) -> dict[str, np.ndarray]:
        out = self._join(
            {i: self.shards[i].export_finish(h) for i, h in handle.items()}, 1
        )
        self.bytes_d2h += sum(int(a.nbytes) for a in out.values())
        return out

    def import_(self, host_state: dict[str, np.ndarray]) -> None:
        """Load merged ``(W, G)`` planes: each shard takes its block of
        columns, padded with init values past the snapshot's width."""
        G = self.spec.group_capacity
        for i, sh in self.shards.items():
            sh.import_(
                {k: a[:, i * G:(i + 1) * G] for k, a in host_state.items()}
            )


class KeyShardedPartialMergeWindowState(_HostPartialMixin, KeyShardedWindowState):
    """partial_merge over the key-sharded ring: host stripes cover the
    GLOBAL group space, the packed stripe is copied once to each distinct
    device, and every shard merges its own group block with one launch of
    the merge kernel (``G_total``, ``g_shift = i·G_local``).  Emission
    gathers, finals and compaction run per shard and join on the host."""

    strategy_name = "partial_merge/key_sharded"

    def __init__(self, spec: sa.WindowKernelSpec, mesh: Mesh):
        super().__init__(spec, mesh)
        self._init_host_partial(self.group_capacity)
        self._stagers = {
            sh.device: _StripeStager(sh.device) for sh in self.shards.values()
        }
        self._finals_specs: tuple | None = None

    def _merge(
        self, packed: np.ndarray, a_pad: int, lean: bool, dense: bool
    ) -> None:
        on = {d: st.stage(packed) for d, st in self._stagers.items()}
        self.bytes_h2d += int(packed.nbytes) * (len(on) - 1)
        G = self.spec.group_capacity
        for i, sh in self.shards.items():
            merge_partials(
                self.spec, self._stripe.SUB, a_pad, lean, dense, sh._state,
                on[sh.device], G_total=self.group_capacity, g_shift=i * G,
            )
            self.shard_merges[i] += 1

    _live_bucket = SingleDeviceWindowState._live_bucket
    _count_compact_d2h = SingleDeviceWindowState._count_compact_d2h

    def prepare_finals(self, agg_specs: tuple) -> None:
        self._finals_specs = tuple(agg_specs)

    def _block_start(self, n: int, live_groups, program) -> dict:
        """Start ``program(shard, width)`` on each shard holding part of the
        live-group bucket (every shard in full across processes, so their
        blocks gather alike), its copy to the host on the shard's side
        stream → {shard: handle}."""
        if n > self.spec.window_slots:  # slots must be distinct
            raise ValueError(f"{n} slots from a {self.spec.window_slots}-slot ring")
        G = self.spec.group_capacity
        bucket = self._live_bucket(live_groups)
        handles = {}
        for i, sh in self.shards.items():
            width = G if self.mesh.spans_processes else min(G, bucket - i * G)
            if width > 0:
                handles[i] = sh._host_copy_start(program(sh, width))
        return handles

    def read_reset_block_start(
        self, first_slot: int, n: int, live_groups=None, lean=False
    ) -> dict:
        return self._block_start(n, live_groups, lambda sh, g: sa._gather_and_reset(
            self.spec, n, g, sh._state, first_slot, lean,
        ))

    def read_reset_block_finals_start(
        self, first_slot: int, n: int, live_groups=None
    ) -> dict | None:
        if self._finals_specs is None:
            return None
        return self._block_start(n, live_groups, lambda sh, g: sa._finals_and_reset(
            self.spec, self._finals_specs, n, g, sh._state, first_slot,
        ))

    def read_reset_block_finish(self, handle: dict) -> dict[str, np.ndarray]:
        """The shards' blocks joined along the group axis: finals' active
        masks are bool planes, so the shards' masks join as they are."""
        out = self._join(
            {i: self.shards[i]._host_copy_finish(h) for i, h in handle.items()},
            1,
        )
        self.bytes_d2h += sum(int(a.nbytes) for a in out.values())
        return out

    def read_slot_compact(self, slot: int):
        """One compaction launch a shard; each shard's gids offset by its
        block, so they stay ascending when joined.  The stripe folds into
        the ring first."""
        self.flush_pending()
        G = self.spec.group_capacity
        parts = []
        for i, sh in self.shards.items():
            gids, rows = sa.read_slot_compact(self.spec, sh._state, slot)
            self.shard_compactions[i] += 1
            self._count_compact_d2h(gids, rows, G)
            parts.append((i, gids + i * G, rows))
        if self.mesh.spans_processes:
            import torch.distributed as dist

            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, parts)
            parts = sorted((p for ps in every for p in ps), key=lambda p: p[0])
        gids = np.concatenate([p[1] for p in parts])
        rows = {
            label: np.concatenate([p[2][label] for p in parts])
            for label in parts[0][2]
        }
        return gids, rows


class PartialFinalWindowState(_ShardedLayout):
    """Rows data-parallel across shards; a full ring a shard; the merge
    runs only at emission."""

    strategy_name = "partial_final"

    def __init__(self, spec: sa.WindowKernelSpec, mesh: Mesh):
        self.spec = spec
        self._init_shards(mesh, spec)

    @property
    def group_capacity(self) -> int:
        return self.spec.group_capacity

    def update(
        self, values, colvalid, win_rel, rem, gid, row_valid, base_mod,
        min_win_rel=None, max_win_rel=None,
    ):
        self.scatter_updates += 1
        per = self._row_split(values, self.n)
        host = (values, colvalid, win_rel, rem, gid, row_valid)
        for i in self.shards:
            part = tuple(a[i * per:(i + 1) * per] for a in host)
            (rows,) = self._copy_rows(part, [i]).values()
            self._step(i, *rows, base_mod)

    def read_slot(self, slot: int) -> dict[str, np.ndarray]:
        lead = self.shards[min(self.shards)].device
        rows = [
            {c.label: sh._state[c.label][slot] for c in self.spec.components}
            for sh in self.shards.values()
        ]
        out = {
            k: sa.to_host(v)
            for k, v in _merge_slot_over(self.spec, rows, lead).items()
        }
        if self.mesh.spans_processes:
            out = _all_reduce_planes(self.spec, out)
        self.bytes_d2h += sum(int(a.nbytes) for a in out.values())
        return out

    def write_slots(self, slots: list[int], planes: dict[str, np.ndarray]) -> None:
        """The lead shard takes the planes; every other shard's slots go
        back to init, so the fold over shards returns the planes."""
        for i, sh in self.shards.items():
            if i == 0:
                sh.write_slots(slots, planes)
            else:
                for s in slots:
                    sh.reset_slot(s)

    def export(self) -> dict[str, np.ndarray]:
        """Merged ``(W, G)`` planes (folded on the host)."""
        parts = [sh.export() for sh in self.shards.values()]
        out = _fold_partials_host(
            self.spec, {k: np.stack([p[k] for p in parts]) for k in parts[0]}
        )
        if self.mesh.spans_processes:
            out = _all_reduce_planes(self.spec, out)
        return out

    def import_(self, host_state: dict[str, np.ndarray]) -> None:
        """The merged snapshot into shard 0, init elsewhere: the per-kind
        fold reproduces it exactly."""
        for i, sh in self.shards.items():
            sh.import_(host_state if i == 0 else {})


class TwoLevelWindowState(_ShardedLayout):
    """2-D ``(slices, keys)`` layout composing the two 1-D ones: rows
    data-parallel across slices (merged only at emission), state
    key-sharded within each slice.  Shard ``(s, k)`` sits at flat index
    ``s·n_keys + k``."""

    strategy_name = "two_level"

    def __init__(self, spec: sa.WindowKernelSpec, mesh: Mesh):
        if SLICE_AXIS not in mesh.axis_names or KEY_AXIS not in mesh.axis_names:
            raise ValueError(
                f"two_level needs a ({SLICE_AXIS}, {KEY_AXIS}) mesh; got "
                f"{mesh.axis_names}"
            )
        self.n_slices = mesh.shape[SLICE_AXIS]
        self.n_keys = mesh.shape[KEY_AXIS]
        if spec.group_capacity % self.n_keys:
            raise ValueError(
                f"group capacity {spec.group_capacity} not divisible by "
                f"{self.n_keys} key shards"
            )
        self.spec = _local_spec(spec, self.n_keys)
        self._init_shards(mesh, self.spec)

    @property
    def group_capacity(self) -> int:
        return self.spec.group_capacity * self.n_keys

    def update(
        self, values, colvalid, win_rel, rem, gid, row_valid, base_mod,
        min_win_rel=None, max_win_rel=None,
    ):
        self.scatter_updates += 1
        per = self._row_split(values, self.n_slices)
        G = self.spec.group_capacity
        host = (values, colvalid, win_rel, rem, gid, row_valid)
        for s in range(self.n_slices):
            mine = [i for i in self.shards if i // self.n_keys == s]
            if not mine:
                continue
            on = self._copy_rows(
                tuple(a[s * per:(s + 1) * per] for a in host), mine
            )
            for i in mine:
                v, cv, wr, rm, g, rv = on[self.shards[i].device]
                local_gid, m = _mask_to_key_shard(G, i % self.n_keys, g, rv)
                self._step(i, v, cv, wr, rm, local_gid, m, base_mod)

    def _block(self, k: int) -> list[SingleDeviceWindowState]:
        """This process's shards of key block ``k`` (one a slice)."""
        return [sh for i, sh in self.shards.items() if i % self.n_keys == k]

    def _over_blocks(self, fold_block, shape: tuple) -> dict[str, np.ndarray]:
        """Each key block folded over slices by ``fold_block`` (init values
        where this process holds none of it), joined along the group axis,
        then folded over the job's processes."""
        blocks = [
            fold_block(shards) if shards else _init_planes(self.spec, shape)
            for shards in map(self._block, range(self.n_keys))
        ]
        out = {
            label: np.concatenate([b[label] for b in blocks], axis=-1)
            for label in blocks[0]
        }
        if self.mesh.spans_processes:
            out = _all_reduce_planes(self.spec, out)
        return out

    def read_slot(self, slot: int) -> dict[str, np.ndarray]:
        def fold(shards):
            rows = [
                {c.label: sh._state[c.label][slot] for c in self.spec.components}
                for sh in shards
            ]
            merged = _merge_slot_over(self.spec, rows, shards[0].device)
            return {k: sa.to_host(v) for k, v in merged.items()}

        out = self._over_blocks(fold, (self.spec.group_capacity,))
        self.bytes_d2h += sum(int(a.nbytes) for a in out.values())
        return out

    def write_slots(self, slots: list[int], planes: dict[str, np.ndarray]) -> None:
        """Slice 0 takes the planes, each key shard its block; the other
        slices' slots go back to init."""
        G = self.spec.group_capacity
        for i, sh in self.shards.items():
            if i < self.n_keys:
                k = i % self.n_keys
                sh.write_slots(
                    slots, {n: a[:, k * G:(k + 1) * G] for n, a in planes.items()}
                )
            else:
                for s in slots:
                    sh.reset_slot(s)

    def export(self) -> dict[str, np.ndarray]:
        """Merged ``(W, G_total)`` planes (the cross-slice fold on the
        host)."""
        def fold(shards):
            parts = [sh.export() for sh in shards]
            return _fold_partials_host(
                self.spec, {k: np.stack([p[k] for p in parts]) for k in parts[0]}
            )

        return self._over_blocks(
            fold, (self.spec.window_slots, self.spec.group_capacity)
        )

    def import_(self, host_state: dict[str, np.ndarray]) -> None:
        """The merged snapshot into slice 0 (each key shard its block),
        init elsewhere."""
        G = self.spec.group_capacity
        for i, sh in self.shards.items():
            k = i % self.n_keys
            sh.import_(
                {n: a[:, k * G:(k + 1) * G] for n, a in host_state.items()}
                if i < self.n_keys else {}
            )


def make_sharded_state(
    spec: sa.WindowKernelSpec,
    device: torch.device | str,
    device_strategy: str = "auto",
    mesh: Mesh | None = None,
    strategy: str = "auto",
) -> WindowStateBackend:
    """Pick a layout, with the JAX package's choices and refusals.  One
    device (no mesh, or a mesh of one): row shipping for 'scatter',
    'pallas_dense' and 'auto' ('auto' = dense where supported, the JAX
    package's rule for a co-located GPU, on the card and on the CPU alike),
    host partials for 'partial_merge'.  A 2-D mesh takes 'two_level' only;
    on a 1-D mesh 'partial_merge' gives the key-sharded partial merge, and
    'auto' gives partial/final up to 4,096 groups (duplicate small state,
    shard rows) and key-sharded above (shard large state, replicate
    rows)."""
    if device_strategy not in ("scatter", "pallas_dense", "auto", "partial_merge"):
        raise ValueError(
            f"unknown device strategy {device_strategy!r} (expected "
            "'scatter', 'pallas_dense', 'partial_merge' or 'auto')"
        )
    if mesh is None or mesh.size == 1:
        dev = device if mesh is None else mesh.devices.flat[0]
        if device_strategy == "partial_merge":
            return PartialMergeWindowState(spec, dev)
        return SingleDeviceWindowState(spec, dev, device_strategy)
    if SLICE_AXIS in mesh.axis_names:
        # 2-D (slices, keys) mesh: the two_level layout is the only one
        # shaped for it
        if strategy not in ("auto", "two_level"):
            raise ValueError(
                f"strategy {strategy!r} does not fit a 2-D "
                f"({SLICE_AXIS}, {KEY_AXIS}) mesh — use 'two_level'/'auto'"
            )
        if device_strategy == "partial_merge":
            raise ValueError(
                "partial_merge composes with the 1-D key-sharded mesh "
                "(host partials already ARE the slice axis); use "
                "mesh_devices without mesh_slices"
            )
        return TwoLevelWindowState(spec, mesh)
    if strategy == "two_level":
        raise ValueError(
            "two_level needs a 2-D mesh — set EngineConfig.mesh_slices"
        )
    if device_strategy == "partial_merge":
        # host partials already split Partial/Final on the host, so the
        # mesh holds the (large) group space
        return KeyShardedPartialMergeWindowState(spec, mesh)
    if strategy == "auto":
        strategy = (
            "partial_final" if spec.group_capacity <= 4096 else "key_sharded"
        )
    if strategy == "partial_final":
        return PartialFinalWindowState(spec, mesh)
    if strategy == "key_sharded":
        return KeyShardedWindowState(spec, mesh)
    raise ValueError(f"unknown shard strategy {strategy!r}")
