"""Tiered state: budgeted cold-state spill to the LSM.

Counterpart of ``denormalized_tpu/state/tiering.py``.  When a query's
accounted live state crosses ``EngineConfig(state_budget_bytes)``, a
per-query :class:`SpillController` evicts the COLDEST blocks of keyed state
(coldest-by-last-touch, vectorized block granularity, never the keys the
current batch is touching) out of RAM — or, for the window ring, off the
card — into the :class:`~denormalized_tpu_torch.state.lsm.LsmStore` under a
namespaced key space, and reloads them when a later batch, a watermark
close or a checkpoint touches them.

Layering:

- **This module** owns the generic machinery: budget arithmetic over the
  operators' cheap resident estimates, the namespaced block store
  (``spill/{node_id}/{block_id}`` keys — no ``@`` suffix, so checkpoint
  epoch GC never collects them), per-node spill manifests, the cold-rank
  helper (:class:`ColdTracker`), RecordBatch blob packing, spill/reload
  volume and latency metrics, the per-node stats a spill-thrashing verdict
  reads (:class:`_NodeStats`), and the end-of-line backpressure gate the
  prefetch workers poll.
- **The operators** own the state layouts, so each implements its own
  adapter (an ``enable_spill(node_id, controller)`` hook): the session
  operator spills cold gid blocks of its SoA slot table, the join spills
  cold retained batches a side, the UDAF operator spills cold groups'
  accumulator states (frame order kept by in-place markers), and the window
  operator spills cold watermark-deferred ring slots from the card.

Block payloads are :func:`~denormalized_tpu_torch.state.serialization
.pack_snapshot` blobs, the JAX package's bytes, so a checkpoint holding
spilled blocks restores in either package.  Spilled blocks are referenced
from the owning operator's snapshot and copied under the SAME epoch
(:meth:`SpillController.copy_block_to_epoch`): CRC-framed, listed in the
epoch manifest, verified and collected like every other blob.  Restore
streams each block back into the spill namespace, one at a time.

Degradation ladder: over budget → spill cold blocks down to
``SPILL_LOW_RATIO`` of the budget; a failed spill write keeps the block
resident (it logs, and the stats count no spill); nothing cold left and
still over the hard ceiling → engage END-OF-LINE BACKPRESSURE: every
prefetch worker of the process pauses a bounded slice before each read, so
the broker-side backlog absorbs the burst.  The gate releases as soon as
accounted state drops back under budget.

One budgeted query per state backend path: a second controller attached
to the same path sweeps the first's ``spill/`` namespace.
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from collections import deque

import numpy as np

from denormalized_tpu_torch import obs
from denormalized_tpu_torch.common.errors import StateError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.runtime import faults
from denormalized_tpu_torch.runtime.tracing import logger
from denormalized_tpu_torch.state.serialization import (
    pack_snapshot,
    unpack_snapshot,
)

#: key namespace for spilled blocks.  Deliberately ``@``-free: checkpoint
#: epoch GC (state/checkpoint.py epoch_of_key) parses ``{key}@{epoch}``
#: suffixes, so spill keys are invisible to it by construction.
SPILL_PREFIX = "spill/"

#: gid-granular adapters (session/udaf) group cold keys into blocks of at
#: most this many slots/groups — one LSM value per block, vectorized
#: gather/scatter at spill and reload
SPILL_BLOCK_SLOTS = 8192

#: spill target: evict down to this fraction of the budget, so one spill
#: pass buys headroom instead of re-triggering on the next batch
SPILL_LOW_RATIO = 0.8

#: hard ceiling multiplier: accounted state above budget x this with no
#: cold state left to evict escalates to prefetch backpressure
HARD_CEILING_RATIO = 1.25

#: rolling window for the spill-thrashing stats
THRASH_WINDOW_S = 60.0

#: bounded transient-StateError retries on reload reads (a reloaded block
#: is the only copy of its state)
_RELOAD_ATTEMPTS = 3


def release_freed_memory() -> None:
    """Hand the pages the allocator freed but holds back to the system
    (glibc's ``malloc_trim(0)``; nothing elsewhere).  A tier calls it
    after a spill round, where the slots, blocks and copies it just
    dropped would otherwise stay in the process's RSS as free-but-held
    heap, so a budgeted job's RSS follows its resident state."""
    global _MALLOC_TRIM
    if _MALLOC_TRIM is None:
        import ctypes

        try:
            _MALLOC_TRIM = ctypes.CDLL(None).malloc_trim
        except (OSError, AttributeError):
            _MALLOC_TRIM = False
    if _MALLOC_TRIM:
        _MALLOC_TRIM(0)


_MALLOC_TRIM = None


# -- end-of-line backpressure gate ----------------------------------------
# Module-level so the prefetch workers can poll it with one global read;
# engaged/released under a lock, keyed by (controller, node) so two
# queries' gates never mask each other's release.  Process-wide: while ANY
# budgeted query is over its hard ceiling, every prefetch worker of the
# process throttles (the one-budgeted-query-per-backend scope).

_GATE_LOCK = threading.Lock()
_GATE_HOLDERS: set[tuple[int, str]] = set()
_GATE_ENGAGED = False  # lock-free fast-path mirror of bool(_GATE_HOLDERS)


def pressure_engaged() -> bool:
    """Lock-free fast path for the prefetch read loop: one global load
    when no controller has ever escalated."""
    return _GATE_ENGAGED


def backpressure_pause(slice_s: float = 0.05) -> bool:
    """One bounded pause slice for a producer loop under state pressure.
    Returns True when it actually paused — callers keep their own loop
    (checking shutdown flags between slices) instead of blocking here."""
    if not _GATE_ENGAGED:
        return False
    time.sleep(slice_s)
    return True


def _gate_set(holder: tuple[int, str], engaged: bool) -> bool:
    """Add/remove one holder; returns True when this call flipped the
    global gate state (edge, not level — callers count escalations)."""
    global _GATE_ENGAGED
    with _GATE_LOCK:
        before = bool(_GATE_HOLDERS)
        if engaged:
            _GATE_HOLDERS.add(holder)
        else:
            _GATE_HOLDERS.discard(holder)
        _GATE_ENGAGED = bool(_GATE_HOLDERS)
        return before != _GATE_ENGAGED and engaged


# -- cold tracking ---------------------------------------------------------


class ColdTracker:
    """Vectorized per-id last-touch clock.

    One int64 cell per dense id; ``touch`` stamps a batch's ids with a
    monotonically increasing batch clock (one scatter, no per-row Python).
    Cold candidates rank by ``last_touch`` ascending — ids never touched
    rank coldest (stamp 0)."""

    __slots__ = ("clock", "last_touch")

    def __init__(self, capacity: int = 1024) -> None:
        self.clock = 0
        self.last_touch = np.zeros(max(int(capacity), 16), dtype=np.int64)

    def ensure(self, n: int) -> None:
        cap = len(self.last_touch)
        if n <= cap:
            return
        while cap < n:
            cap *= 2
        new = np.zeros(cap, dtype=np.int64)
        new[: len(self.last_touch)] = self.last_touch
        self.last_touch = new

    def touch(self, ids: np.ndarray) -> None:
        self.clock += 1
        self.last_touch[ids] = self.clock

    def order_cold(self, candidates: np.ndarray) -> np.ndarray:
        """``candidates`` sorted coldest-first (stable, so equal stamps
        keep a deterministic id order)."""
        if len(candidates) == 0:
            return candidates
        return candidates[
            np.argsort(self.last_touch[candidates], kind="stable")
        ]


# -- RecordBatch <-> blob --------------------------------------------------


def rb_to_blob(batch: RecordBatch, extra_meta: dict | None = None) -> bytes:
    """Pack one RecordBatch into a self-describing blob.  Columnar string
    and nested columns pack their raw buffers (offsets + bytes, the
    exchange frames' codec: a ``StringColumn`` stays columnar and never
    round-trips through Python values); plain object columns keep the JSON
    ``strings`` lane."""
    from denormalized_tpu_torch.common.columns import Column, column_to_arrays

    meta: dict = {"strings": {}, "masked": [], "rows": batch.num_rows}
    if extra_meta:
        meta["extra"] = extra_meta
    arrays: dict[str, np.ndarray] = {}
    colspecs: dict[str, dict] = {}
    for f in batch.schema:
        col = batch.column(f.name)
        if isinstance(col, Column):
            colspecs[f.name] = column_to_arrays(col, f"cc_{f.name}_", arrays)
        elif np.asarray(col).dtype == object:
            meta["strings"][f.name] = [
                None if v is None else str(v) for v in np.asarray(col)
            ]
        else:
            arrays[f"col_{f.name}"] = np.asarray(col)
        m = batch.mask(f.name)
        # a columnar column's validity already rides its own buffers
        if m is not None and m is not getattr(col, "validity", None):
            meta["masked"].append(f.name)
            arrays[f"mask_{f.name}"] = np.asarray(m, dtype=bool)
    if colspecs:
        meta["columnar"] = colspecs
    return pack_snapshot(meta, arrays)


def rb_from_blob(blob: bytes, schema) -> tuple[RecordBatch, dict | None]:
    """Inverse of :func:`rb_to_blob` (the schema comes from the owner:
    spilled blocks carry none) → (batch, extra meta)."""
    from denormalized_tpu_torch.common.columns import column_from_arrays

    meta, arrays = unpack_snapshot(blob)
    colspecs = meta.get("columnar", {})
    cols, masks = [], []
    for f in schema:
        if f.name in colspecs:
            cols.append(
                column_from_arrays(colspecs[f.name], f"cc_{f.name}_", arrays)
            )
        elif f.name in meta["strings"]:
            vals = meta["strings"][f.name]
            arr = np.empty(len(vals), dtype=object)
            arr[:] = vals
            cols.append(arr)
        else:
            cols.append(arrays[f"col_{f.name}"])
        if f.name in meta["masked"]:
            masks.append(arrays.get(f"mask_{f.name}"))
        else:
            # columnar columns surface their own validity as the mask
            masks.append(getattr(cols[-1], "validity", None))
    return RecordBatch(schema, cols, masks), meta.get("extra")


def key_columns_from_meta(cols: list[list]) -> list[np.ndarray]:
    """Interner-ready key columns from JSON-round-tripped value lists:
    numeric, bool and datetime kinds re-enter the exact-value path,
    everything else (strings, mixed objects) stays an object array built
    element-wise so ``np.asarray`` cannot stringify it."""
    out = []
    for lst in cols:
        arr = np.asarray(lst)
        if arr.dtype.kind not in "ifbM":
            arr = np.empty(len(lst), dtype=object)
            arr[:] = lst
        out.append(arr)
    return out


# -- per-node stats (the spill-thrashing signal) ---------------------------


class _NodeStats:
    """One node's spill/reload accounting + rolling thrash window.

    Lock-guarded: ``note`` runs on the owning operator's thread, while
    ``snapshot``/``recent`` may be read from any other (a state endpoint, a
    sampler): iterating the deque while the operator appends would
    raise."""

    __slots__ = (
        "spill_blocks", "reload_blocks", "spill_bytes", "reload_bytes",
        "events", "backpressure", "_lock",
    )

    def __init__(self) -> None:
        self.spill_blocks = 0
        self.reload_blocks = 0
        self.spill_bytes = 0
        self.reload_bytes = 0
        self.backpressure = 0
        # (wall, kind, blocks) ring for the rolling thrash ratio
        self.events: deque = deque(maxlen=4096)
        self._lock = threading.Lock()

    def note(self, kind: str, blocks: int, nbytes: int) -> None:
        now = time.time()
        with self._lock:
            if kind == "spill":
                self.spill_blocks += blocks
                self.spill_bytes += nbytes
            else:
                self.reload_blocks += blocks
                self.reload_bytes += nbytes
            self.events.append((now, kind, blocks))

    def _recent_locked(self) -> tuple[int, int]:
        cutoff = time.time() - THRASH_WINDOW_S
        s = r = 0
        for t, kind, blocks in self.events:
            if t < cutoff:
                continue
            if kind == "spill":
                s += blocks
            else:
                r += blocks
        return s, r

    def recent(self) -> tuple[int, int]:
        """(spills, reloads) inside the rolling window."""
        with self._lock:
            return self._recent_locked()

    def snapshot(self) -> dict:
        with self._lock:
            s, r = self._recent_locked()
            return {
                "spill_blocks_total": self.spill_blocks,
                "reload_blocks_total": self.reload_blocks,
                "spill_bytes_total": self.spill_bytes,
                "reload_bytes_total": self.reload_bytes,
                "recent_spill_blocks": s,
                "recent_reload_blocks": r,
                "backpressure_engagements": self.backpressure,
            }


# -- the controller --------------------------------------------------------


class SpillController:
    """Per-query spill coordinator shared by every tier adapter.

    Owns the budget arithmetic (from each adapter's cheap resident
    estimate), the namespaced block store on the LSM backend, per-node
    manifests, metrics, and the backpressure escalation.  Operators
    register at wire time and call their tier's ``maybe_spill`` from their
    own thread after each batch — all state mutation stays single-writer on
    the operator thread; the controller only guards the cross-thread gate
    bookkeeping."""

    def __init__(self, backend, budget_bytes: int) -> None:
        self.backend = backend
        self.budget = int(budget_bytes)
        self._ops: dict[str, weakref.ref] = {}
        self._resident_fns: dict[str, object] = {}
        self._stats: dict[str, _NodeStats] = {}
        self._closed = False
        self._obs_spill_ms = obs.histogram("dnz_spill_op_ms", op="spill")
        self._obs_reload_ms = obs.histogram("dnz_spill_op_ms", op="reload")
        self._obs_spill_blocks = obs.counter(
            "dnz_spill_blocks_total", op="spill"
        )
        self._obs_reload_blocks = obs.counter(
            "dnz_spill_blocks_total", op="reload"
        )
        self._obs_backpressure = obs.counter("dnz_spill_backpressure_total")

    # -- registration ----------------------------------------------------
    def register(self, node_id: str, op, resident_fn) -> None:
        """``resident_fn`` is the adapter's CHEAP resident-bytes estimate —
        the budget check runs once per batch, so it must not walk live
        state the way the exact ``state_info()`` accounting does."""
        self._ops[node_id] = weakref.ref(op)
        self._resident_fns[node_id] = resident_fn
        self._stats[node_id] = _NodeStats()

    def sweep_namespace(self) -> None:
        """Delete every leftover ``spill/`` key (a previous incarnation's
        cold tier — checkpoint restore re-copies the committed epoch's
        blocks, anything else is unreachable garbage)."""
        try:
            for kb in list(self.backend.keys()):
                if kb.startswith(SPILL_PREFIX.encode()):
                    self.backend.delete(kb)
        except StateError as e:
            logger.warning("spill: startup namespace sweep failed: %s", e)

    # -- block I/O -------------------------------------------------------
    @staticmethod
    def block_key(node_id: str, block_id: str) -> str:
        return f"{SPILL_PREFIX}{node_id}/{block_id}"

    def put_block(self, node_id: str, block_id: str, payload: bytes) -> int:
        """Store one cold block; returns the stored byte count.  A torn
        fault here truncates the payload exactly like ``lsm.put`` — the
        reload path detects it via the pack magic/shape and fails loudly
        instead of resurrecting half a block."""
        key = self.block_key(node_id, block_id)
        payload = faults.inject("lsm.spill_put", key=key, payload=payload)
        t0 = time.perf_counter()
        self.backend.put(key, payload)
        self._obs_spill_ms.observe((time.perf_counter() - t0) * 1e3)
        self._obs_spill_blocks.add(1)
        return len(payload)

    def _read_block_raw(self, key: str) -> bytes:
        """Retried block read shared by reload and the epoch-copy path
        (no metrics — callers attribute the read themselves)."""
        last: StateError | None = None
        raw = None
        for attempt in range(_RELOAD_ATTEMPTS):
            try:
                # the fault site sits INSIDE the retry: an injected (or
                # real) transient read error heals like a backend hiccup
                faults.inject("lsm.spill_get", key=key)
                raw = self.backend.get(key)
                last = None
                break
            except StateError as e:
                last = e
                if attempt < _RELOAD_ATTEMPTS - 1:
                    time.sleep(0.01 * (attempt + 1))  # dnzlint: allow(replay-impure) reload-retry backoff — timing never feeds block bytes
        if last is not None:
            raise last
        if raw is None:
            raise StateError(
                f"spilled state block {key!r} missing from the backend — "
                "cold tier lost state that was evicted from RAM"
            )
        return raw

    def get_block(self, node_id: str, block_id: str) -> bytes:
        """Load one spilled block (bounded transient retry — the block is
        the ONLY copy of that state; a missing/torn blob is fatal)."""
        key = self.block_key(node_id, block_id)
        t0 = time.perf_counter()
        raw = self._read_block_raw(key)
        self._obs_reload_ms.observe((time.perf_counter() - t0) * 1e3)
        self._obs_reload_blocks.add(1)
        return raw

    def delete_block(self, node_id: str, block_id: str) -> None:
        try:
            self.backend.delete(self.block_key(node_id, block_id))
        except StateError as e:
            # unreachable garbage at worst — the next run's namespace sweep
            # collects it; a delete hiccup must not fail a reload
            logger.warning(
                "spill: delete of reloaded block %s/%s failed: %s",
                node_id, block_id, e,
            )

    def write_manifest(self, node_id: str, block_ids: list[str]) -> None:
        """Persist one node's live-block list (debuggability and the
        sweep's ground truth; NOT the recovery source — checkpoints
        reference blocks from the epoch manifest).  Best-effort: a manifest
        write failure degrades observability, never the data path."""
        key = f"{SPILL_PREFIX}{node_id}/manifest"
        payload = json.dumps(sorted(block_ids)).encode()
        try:
            payload = faults.inject("spill.manifest", key=key, payload=payload)
            self.backend.put(key, payload)
        except StateError as e:
            logger.warning("spill: manifest write for %s failed: %s", node_id, e)

    # -- checkpoint integration ------------------------------------------
    def copy_block_to_epoch(
        self, coord, state_key: str, epoch: int, node_id: str, block_id: str
    ) -> None:
        """Reference one spilled block from checkpoint epoch ``epoch``: the
        payload is re-put through ``put_snapshot`` (CRC-framed, listed in
        the epoch manifest) under a block-scoped state key — spilled and
        resident state commit under ONE epoch.

        The payload is integrity-checked FIRST: a block torn on its way
        into the LSM would otherwise be framed with a valid CRC over the
        torn bytes and commit a poisoned epoch that verifies clean; failing
        the snapshot here keeps the previous intact epoch the recovery
        point.  Reads through the raw path: an epoch copy is not a reload,
        and the reload counters must not move with every checkpoint."""
        raw = self._read_block_raw(self.block_key(node_id, block_id))
        try:
            unpack_snapshot(raw)
        except Exception as e:  # dnzlint: allow(broad-except) any unpack failure (bad magic, short buffer, JSON) means a corrupt block — the epoch must not commit it
            raise StateError(
                f"spilled block {block_id!r} of {node_id!r} failed "
                f"integrity verification before epoch commit: {e}"
            ) from e
        coord.put_snapshot(f"{state_key}:spill:{block_id}", epoch, raw)

    def restore_block_from_epoch(
        self, coord, state_key: str, node_id: str, block_id: str
    ) -> bytes:
        """Read one block's payload back out of the committed epoch and
        re-seed the run-time spill namespace with it (the tier map rebuild
        path — one block resident at a time)."""
        raw = coord.get_snapshot(f"{state_key}:spill:{block_id}")
        if raw is None:
            raise StateError(
                f"checkpoint references spilled block {block_id!r} of "
                f"{state_key!r} but the epoch holds no such snapshot"
            )
        self.backend.put(self.block_key(node_id, block_id), raw)
        return raw

    # -- budget arithmetic ------------------------------------------------
    def total_state_bytes(self) -> int:
        """Current resident bytes across every registered operator, from
        the adapters' cheap estimators.

        Estimators may belong to operators running on OTHER threads (a
        join's pumps): a torn read there degrades to an underestimate for
        one check rather than killing the calling operator's batch."""
        total = 0
        for node_id, ref in self._ops.items():
            if ref() is None:
                continue
            try:
                total += int(self._resident_fns[node_id]())
            except (RuntimeError, IndexError, ValueError):
                # a cross-thread estimator racing its owner's mutation
                # (dict or list resized under it): one stale check
                pass
        return total

    def over_budget(self) -> int:
        """Bytes to shed to reach the spill target (0 = under budget)."""
        total = self.total_state_bytes()
        if total <= self.budget:
            return 0
        return total - int(self.budget * SPILL_LOW_RATIO)

    def note_spill(self, node_id: str, blocks: int, nbytes: int) -> None:
        self._stats[node_id].note("spill", blocks, nbytes)

    def note_reload(self, node_id: str, blocks: int, nbytes: int) -> None:
        self._stats[node_id].note("reload", blocks, nbytes)

    def spill_stats(self, node_id: str) -> dict | None:
        st = self._stats.get(node_id)
        return st.snapshot() if st is not None else None

    # -- escalation -------------------------------------------------------
    def check_pressure(self, node_id: str) -> None:
        """The post-spill-pass epilogue every adapter runs: still above the
        hard ceiling → escalate to backpressure, otherwise release this
        node's hold."""
        total = self.total_state_bytes()
        if total > self.hard_ceiling():
            self.escalate(node_id, total - self.budget)
        else:
            self.relax(node_id)

    def escalate(self, node_id: str, over_bytes: int) -> None:
        """Spill could not keep up (nothing cold left to evict, state still
        above the hard ceiling): engage end-of-line backpressure on the
        prefetch workers instead of growing without bound."""
        if _gate_set((id(self), node_id), True):
            self._stats[node_id].backpressure += 1
            self._obs_backpressure.add(1)
            logger.warning(
                "spill: node %s is %d bytes over the hard state ceiling "
                "with no evictable cold state — engaging prefetch "
                "backpressure (sources pause; broker backlog absorbs)",
                node_id, over_bytes,
            )

    def relax(self, node_id: str) -> None:
        _gate_set((id(self), node_id), False)

    def hard_ceiling(self) -> int:
        return int(self.budget * HARD_CEILING_RATIO)

    def close(self) -> None:
        """Query teardown: release every gate this controller holds and
        drop the spill namespace (cold state of a finished query is
        unreachable; checkpointed copies live under their epochs)."""
        if self._closed:
            return
        self._closed = True
        for node_id in list(self._stats):
            self.relax(node_id)
        if getattr(self.backend, "_closed", False):
            return
        try:
            self.sweep_namespace()
        except StateError as e:  # the backend closed under the sweep
            logger.warning("spill: teardown sweep skipped: %s", e)


# -- wiring ----------------------------------------------------------------


def spill_active(config) -> bool:
    """Spill engages when a budget AND a state backend are configured (and
    ``state_spill`` is not off).  A budget without a backend has nowhere
    to spill to: the tier stays off, unless ``state_spill=True`` asked for
    it, which raises."""
    mode = getattr(config, "state_spill", "auto")
    if mode is False or mode == "off":
        return False
    budget = getattr(config, "state_budget_bytes", None)
    path = getattr(config, "state_backend_path", None)
    if not budget or not path:
        if mode is True and budget:
            raise StateError(
                "state_spill=True requires state_backend_path "
                "(Context.with_state_backend) — the cold tier lives in "
                "the LSM state backend"
            )
        return False
    return True


def attach_spill(root, ctx):
    """Walk the physical plan and enable the cold tier on every operator
    that implements ``enable_spill`` → the controller (the caller closes it
    at query end), or None when spill is not configured or no operator
    takes it.  Runs BEFORE checkpoint wiring: restore rebuilds each tier
    map through the adapter installed here."""
    if not spill_active(ctx.config):
        return None
    from denormalized_tpu_torch.state.checkpoint import assign_node_ids, walk
    from denormalized_tpu_torch.state.lsm import (
        initialize_global_state_backend,
    )

    backend = initialize_global_state_backend(ctx.config.state_backend_path)
    controller = SpillController(backend, int(ctx.config.state_budget_bytes))
    controller.sweep_namespace()
    ids = assign_node_ids(root)
    wired = 0
    for op in walk(root):
        hook = getattr(op, "enable_spill", None)
        if hook is not None:
            hook(ids[id(op)], controller)
            wired += 1
    if wired == 0:
        controller.close()
        return None
    return controller
