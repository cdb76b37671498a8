"""Window-state backends — counterpart of
``denormalized_tpu/parallel/sharded_state.py``, single device only.

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

The sharded layouts (key-sharded, partial/final, two-level) are not ported
yet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from denormalized_tpu_torch.ops import dense_window as dw
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.ops.host_partial import HostPartialStripe
from denormalized_tpu_torch.ops.merge_partials import merge_partials

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

    # -- emission: start dispatches a block's gather+reset and its copy to
    # the host and returns a handle; finish materializes it
    def read_reset_block_start(
        self, first_slot: int, n: int, live_groups=None, lean=False
    ):
        """Start reading and resetting n consecutive ring slots (component
        planes)."""
        raise NotImplementedError

    def read_reset_block_finish(self, handle) -> dict[str, np.ndarray]:
        raise NotImplementedError

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
        compacted on the device."""
        raise NotImplementedError

    def reset_slot(self, slot: int) -> None:
        raise NotImplementedError

    def write_slots(self, slots: list[int], planes: dict[str, np.ndarray]) -> None:
        """Overwrite whole ring slots from ``(len(slots), G)`` host planes."""
        raise NotImplementedError

    def export(self) -> dict[str, np.ndarray]:
        """(W, G) host snapshot for growth and for carrying state across."""
        raise NotImplementedError

    def import_(self, host_state: dict[str, np.ndarray]) -> None:
        raise NotImplementedError


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


class _HostPartialMixin:
    """Host-stripe machinery of the partial_merge backend: batch chunk
    folding and flush orchestration.  The concrete class provides
    ``_merge(packed, a_pad, lean, dense)``; ``PartialMergeWindowState`` is
    its one user until the key-sharded layout is ported."""

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


class PartialMergeWindowState(_HostPartialMixin, SingleDeviceWindowState):
    """Host edge-reduction + device merge (the ``partial_merge``
    strategy): rows are reduced on the host into per-(slide unit, sub,
    group) partials (native C++ single pass, ``ops/host_partial.py``) and
    the device folds each stripe into the ring with ONE transfer and ONE
    kernel launch.  Emission, growth and export are the scatter path's."""

    def __init__(self, spec: sa.WindowKernelSpec, device: torch.device | str):
        super().__init__(spec, device, "scatter")
        self._init_host_partial(spec.group_capacity)
        # on a card: the pinned host buffer stripes cross in, and the event
        # recorded after the last copy out of it
        self._staging: torch.Tensor | None = None
        self._staged: torch.cuda.Event | None = None
        # merges by (thread name, CUDA stream handle) they launched from:
        # a host pipeline's worker must launch on the operator's stream
        self.merge_sites: dict[tuple[str, int], int] = {}

    @property
    def strategy_name(self) -> str:
        return "partial_merge"

    def _stage_stripe(self, packed: np.ndarray) -> torch.Tensor:
        """The packed stripe on the ring's device.  On a card it goes
        through one reusable pinned host buffer, copied with
        ``non_blocking`` on the current stream (the kernels' stream, so the
        merge launched next on it waits for the copy); the host waits for
        the event of the buffer's previous copy before writing it again."""
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

    def _merge(
        self, packed: np.ndarray, a_pad: int, lean: bool, dense: bool
    ) -> None:
        if self.device.type == "cuda":
            site = (threading.current_thread().name,
                    torch.cuda.current_stream(self.device).cuda_stream)
            self.merge_sites[site] = self.merge_sites.get(site, 0) + 1
        merge_partials(
            self.spec, self._stripe.SUB, a_pad, lean, dense, self._state,
            self._stage_stripe(packed),
        )

    def read_slot_compact(self, slot: int):
        """The stripe folds into the ring first: the compacted slot must
        hold every row ingested so far."""
        self.flush_pending()
        return super().read_slot_compact(slot)


def make_sharded_state(
    spec: sa.WindowKernelSpec,
    device: torch.device | str,
    device_strategy: str = "auto",
) -> WindowStateBackend:
    """The single-device branch of the JAX package's factory: row shipping
    for 'scatter', 'pallas_dense' and 'auto' ('auto' = dense where
    supported, the JAX package's rule for a co-located GPU, on the card and
    on the CPU alike); host partials for 'partial_merge'."""
    if device_strategy == "partial_merge":
        return PartialMergeWindowState(spec, device)
    if device_strategy not in ("scatter", "pallas_dense", "auto"):
        raise ValueError(
            f"unknown device strategy {device_strategy!r} (expected "
            "'scatter', 'pallas_dense', 'partial_merge' or 'auto')"
        )
    return SingleDeviceWindowState(spec, device, device_strategy)
