"""Checkpoint wiring: connect the orchestrator, the state backend, and the
physical plan.

Counterpart of ``denormalized_tpu/state/checkpoint.py`` for one process:
the same keys, framing, manifests, retention and fallback, so either
package restores the other's store, windows' and joins' snapshots alike.
In a cluster worker, the cluster coordinator's abort of an in-flight epoch
drops that epoch's blobs (:meth:`CheckpointCoordinator.note_aborted`).

Mirrors the reference's checkpoint topology (SURVEY.md §3.4): sources persist
their offsets when a barrier passes (kafka_stream_read.rs:275-289) and window
streams persist watermark + frames (grouped_window_agg_stream.rs:355-418),
all keyed by ``{node_id}_{partition}`` tags in the state backend; on startup
operators probe the backend by tag and restore
(kafka_stream_read.rs:110-140, grouped_window_agg_stream.rs:160-211).  The
fork's ``node_id`` plumbing (``with_node_id``) becomes a deterministic DFS
numbering of the physical plan here — stable across runs because the plan is
rebuilt deterministically from the same query.

Atomicity — an improvement over the reference's fire-and-forget puts
(slatedb.rs:60-66): snapshots for barrier epoch ``E`` are written under
epoch-suffixed keys ``{key}@{E}`` as the in-band marker passes each
operator; when the marker drains at the plan root, the executor calls
:meth:`CheckpointCoordinator.commit`, which writes the epoch's key
manifest, fsyncs the store, and only then writes the ``committed_epoch``
record (also fsynced).  Restore reads the committed epoch and loads
exactly that epoch's snapshots — a half-written barrier (crash between
operator snapshots) is invisible, so recovery never mixes epochs.

Integrity + fallback (the self-healing half): every snapshot blob is
framed with a small header (magic, version, CRC32, length) written by
:meth:`put_snapshot` and verified on read; commit retains the last
``RETAINED_EPOCHS`` committed epochs instead of GC-ing N-1 immediately;
restore verifies ALL snapshots of the committed epoch up front (manifest
completeness + per-blob CRC) and falls back to the previous committed
epoch — with a loud warning and ``restored_from_fallback`` set — when any
blob is corrupt, torn, or missing, so one bad write degrades recovery to
an older cut instead of bricking it.  Pre-header (legacy) blobs and
manifest-less epochs still load.  Transient ``StateError`` during commit
is retried a bounded number of times (``commit_retries`` counts them)
before surfacing.

Consistency: barriers flow in-band (see orchestrator.py), so on single-input
chains the snapshot is an aligned cut and recovery is exactly-once w.r.t.
engine state; emission to sinks remains at-least-once (windows that closed
after the last barrier re-emit on recovery), matching the reference.
"""

from __future__ import annotations

import json
import struct
import time
import zlib

from denormalized_tpu_torch import obs
from denormalized_tpu_torch.common.errors import StateError
from denormalized_tpu_torch.physical.base import ExecOperator
from denormalized_tpu_torch.runtime import faults
from denormalized_tpu_torch.runtime.tracing import logger
from denormalized_tpu_torch.state.lsm import initialize_global_state_backend
from denormalized_tpu_torch.state.orchestrator import (
    CheckpointBarrier,
    Orchestrator,
)

_COMMIT_KEY = "committed_epoch"
_HISTORY_KEY = "committed_epoch_history"

#: committed epochs kept on disk — the fallback depth.  2 = one corrupt
#: committed epoch can always fall back to an intact predecessor.
RETAINED_EPOCHS = 2

# snapshot blob framing: magic + version + payload CRC32 + payload length.
# Verification is how a torn/corrupt blob is DETECTED instead of being
# json-decoded into garbage (or half-garbage) at restore.  Blobs that do
# not start with the magic are legacy pre-header snapshots and pass
# through verbatim — existing checkpoints stay readable.
_SNAP_MAGIC = b"DNZ1"
_SNAP_HDR = struct.Struct("<4sBII")
_SNAP_VERSION = 1

_COMMIT_ATTEMPTS = 3  # transient-StateError retries inside commit


def epoch_of_key(kb: bytes) -> int | None:
    """Epoch suffix of a ``{key}@{epoch}`` store key, or None — the ONE
    place the suffix grammar is parsed (GC, discovery, and verification
    must never disagree about which keys belong to an epoch)."""
    k = kb.decode("utf-8", "replace")
    sep = k.rfind("@")
    if sep < 0:
        return None
    try:
        return int(k[sep + 1:])
    except ValueError:
        return None


def frame_snapshot(blob: bytes | list[bytes]) -> bytes:
    """Wrap a snapshot payload, whole or as its pieces in order, in the
    integrity header (pieces are joined once, behind the header)."""
    parts = blob if isinstance(blob, list) else [blob]
    crc = 0
    for p in parts:
        crc = zlib.crc32(p, crc)
    return b"".join([_SNAP_HDR.pack(
        _SNAP_MAGIC, _SNAP_VERSION, crc, sum(map(len, parts))), *parts])


def unframe_snapshot(raw: bytes) -> tuple[bool, bytes | None]:
    """→ (intact, payload).  Headerless (legacy) blobs are intact by
    definition — there is nothing to verify them against."""
    if not raw.startswith(_SNAP_MAGIC):
        # a framed blob torn to < 4 bytes loses the magic itself; every
        # such cut leaves a strict prefix of the magic (incl. b"") — that
        # is corruption, not a legacy payload
        if len(raw) < len(_SNAP_MAGIC) and _SNAP_MAGIC.startswith(raw):
            return False, None
        return True, raw
    if len(raw) < _SNAP_HDR.size:
        return False, None
    magic, version, crc, length = _SNAP_HDR.unpack_from(raw)
    payload = raw[_SNAP_HDR.size:]
    if (
        version != _SNAP_VERSION
        or len(payload) != length
        or zlib.crc32(payload) != crc
    ):
        return False, None
    return True, payload


def walk(op: ExecOperator):
    yield op
    for c in op.children:
        yield from walk(c)


def assign_node_ids(root: ExecOperator) -> dict[int, str]:
    """Deterministic DFS-preorder node ids (the fork's node_id analog)."""
    ids: dict[int, str] = {}
    for i, op in enumerate(walk(root)):
        ids[id(op)] = f"{i}_{type(op).__name__}"
    return ids


class CheckpointCoordinator:
    """Epoch-aware snapshot IO shared by all operators of one query."""

    def __init__(self, backend):
        self.backend = backend
        self.commit_retries = 0
        self._obs_commit_ms = obs.histogram("dnz_checkpoint_commit_ms")
        self._obs_snap_bytes = obs.histogram(
            "dnz_checkpoint_snapshot_bytes"
        )
        self._obs_epoch = obs.gauge("dnz_checkpoint_committed_epoch")
        self._obs_retries = obs.counter(
            "dnz_checkpoint_commit_retries_total"
        )
        #: True when the committed epoch failed integrity verification and
        #: recovery degraded to an older retained epoch
        self.restored_from_fallback = False
        committed, commit_corrupt = self._read_committed()
        history = self._read_history(committed)
        selected = self._select_restore_epoch(
            committed, history, commit_corrupt
        )
        # retained history after selection: epochs at or below the
        # recovery point, capped at the retention window.  A REJECTED
        # newer epoch must leave, but older intact epochs must STAY —
        # a torn commit record repaired to the newest intact epoch keeps
        # its full safety margin instead of collapsing to depth 1 (which
        # would GC an intact epoch a second crash might still need)
        kept = (
            sorted(
                set(e for e in history if e <= selected) | {selected}
            )[-RETAINED_EPOCHS:]
            if selected is not None else []
        )
        if selected is not None and selected != committed:
            # make the fallback decision DURABLE before any GC touches the
            # rejected epoch: a crash before the next commit must land on
            # this same (intact) epoch, not re-read a commit record whose
            # blobs are gone and "restore" empty state.  Retried like
            # commit's writes — a transient hiccup here would otherwise
            # abort a recovery that has already found an intact epoch.
            last: StateError | None = None
            for attempt in range(_COMMIT_ATTEMPTS):
                try:
                    backend.put(_COMMIT_KEY, str(selected).encode())
                    backend.put(
                        _HISTORY_KEY, json.dumps(kept).encode()
                    )
                    backend.flush()
                    last = None
                    break
                except StateError as e:
                    last = e
                    if attempt < _COMMIT_ATTEMPTS - 1:
                        time.sleep(0.01 * (attempt + 1))
            if last is not None:
                raise last
        self.committed_epoch: int | None = selected
        #: the epoch this run RECOVERED from, frozen at construction —
        #: committed_epoch moves with every new commit, but transactional
        #: sinks need the recovery point itself: output the previous
        #: incarnation wrote with an in-flight epoch beyond this value is
        #: exactly the uncommitted suffix a restore regenerates, and a
        #: recovery reader must discard it (truncate-on-restore)
        self.restored_epoch: int | None = selected
        self.committed_history: list[int] = kept
        self._epoch_keys: dict[int, list[str]] = {}
        #: epochs inherited from previous incarnations (restored history)
        #: — commit-time GC must sweep these too once they leave the
        #: retention window; in-memory _epoch_keys only knows THIS
        #: incarnation's writes
        self._known_epochs: set[int] = set(self.committed_history)
        if selected is not None:
            self._gc_stale_epochs()

    def _gc_stale_epochs(self) -> None:
        """Startup GC: drop epoch-suffixed keys outside the retained
        history — snapshots of a half-written (never committed) barrier,
        the corrupt epoch a fallback just skipped, and epochs a previous
        incarnation wrote but never lived to GC (in-process bookkeeping
        dies with the process; this scan is the cross-restart sweep)."""
        keep = set(self.committed_history)
        if self.committed_epoch is not None:
            keep.add(self.committed_epoch)
        for kb in list(self.backend.keys()):
            epoch = epoch_of_key(kb)
            if epoch is not None and epoch not in keep:
                self.backend.delete(kb)

    # -- restore-time integrity ------------------------------------------
    def _read_committed(self) -> tuple[int | None, bool]:
        """→ (epoch, record_corrupt).  A missing record is a fresh store;
        a PRESENT-but-unparseable record is a torn commit — the two must
        never be conflated (a torn record with intact snapshots on disk
        should recover or fail loudly, not silently restart empty)."""
        raw = self._get_verified_read(_COMMIT_KEY)
        if raw is None:
            return None, False
        try:
            return int(raw.decode()), False
        except ValueError:
            # torn commit record: fall through to the history (the epoch
            # it pointed at was mid-commit anyway — not a safe cut)
            logger.warning(
                "checkpoint: committed_epoch record unreadable (%r) — "
                "consulting %s", raw[:32], _HISTORY_KEY,
            )
            return None, True

    def _get_verified_read(self, key: str) -> bytes | None:
        """Backend read with a bounded transient-error retry, used by
        every recovery-critical read (commit record, history, manifest
        probes, epoch verification): these are the paths whose failure
        either aborts recovery outright or durably discards an epoch
        (pointer rewrite + GC), so a momentary hiccup must not throw away
        an intact checkpoint — same courtesy commit() gives its writes."""
        last: StateError | None = None
        for attempt in range(_COMMIT_ATTEMPTS):
            try:
                return self.backend.get(key)
            except StateError as e:
                last = e
                if attempt < _COMMIT_ATTEMPTS - 1:
                    time.sleep(0.01 * (attempt + 1))  # dnzlint: allow(replay-impure) transient-error backoff — timing never feeds stored bytes
        raise last

    def _read_history(self, committed: int | None) -> list[int]:
        raw = self._get_verified_read(_HISTORY_KEY)
        history: list[int] = []
        if raw is not None:
            try:
                history = [int(e) for e in json.loads(raw.decode())]
            except (ValueError, TypeError):
                logger.warning("checkpoint: epoch history unreadable")
        if committed is not None and committed not in history:
            history.append(committed)
        return sorted(set(history))

    def _probe_manifest(self, epoch: int) -> bool:
        """Discovery-time manifest probe.  A persistently unreadable
        manifest demotes the epoch to the legacy (manifest-less) ordering
        instead of aborting discovery — _verify_epoch still does the
        authoritative (retried) read before the epoch is ever selected."""
        try:
            return self._get_verified_read(f"manifest@{epoch}") is not None
        except StateError:
            return False

    def _discover_epochs(self) -> list[int]:
        """Epochs present as key suffixes on disk, newest first — the
        last resort when the commit record is torn and no history key
        exists (pre-history checkpoints)."""
        epochs = {
            e for kb in self.backend.keys()
            if (e := epoch_of_key(kb)) is not None
        }
        return sorted(epochs, reverse=True)

    def _select_restore_epoch(
        self,
        committed: int | None,
        history: list[int],
        commit_corrupt: bool = False,
    ) -> int | None:
        """Verify candidate epochs newest-first; the first fully-intact
        one becomes the recovery point."""
        if committed is None and not history and not commit_corrupt:
            return None  # fresh store
        candidates = sorted(set(history), reverse=True)
        if committed is not None and committed not in candidates:
            candidates.insert(0, committed)
        if not candidates:
            # torn commit record on a history-less (legacy) store: the
            # snapshots themselves may be intact — discover their epochs
            # from the keys rather than silently restarting empty, and
            # fail LOUDLY (like the pre-history code did) if nothing
            # usable exists.  Ordering matters: an epoch WITH a manifest
            # is provably complete (the manifest is written only after
            # every operator snapshotted), so newest-manifested-first;
            # manifest-less epochs are legacy and completeness is
            # unknowable — the NEWEST one may be a half-written barrier
            # (a mixed cut), while under legacy GC-on-commit the OLDEST
            # epoch on disk is the committed one, so those try
            # oldest-first.
            discovered = self._discover_epochs()  # newest-first
            with_manifest = [
                e for e in discovered if self._probe_manifest(e)
            ]
            legacy = [e for e in discovered if e not in set(with_manifest)]
            candidates = with_manifest + list(reversed(legacy))
            if not candidates:
                raise StateError(
                    "committed_epoch record unreadable and no epoch "
                    "snapshots found — refusing to silently restore "
                    "empty state"
                )
        for epoch in candidates:
            ok, why = self._verify_epoch(epoch)
            if ok:
                if commit_corrupt or (
                    committed is not None and epoch != committed
                ):
                    self.restored_from_fallback = True
                    logger.warning(
                        "checkpoint: RESTORING FROM FALLBACK epoch %d — "
                        "committed epoch %s failed integrity "
                        "verification; windows since that cut will "
                        "re-emit (at-least-once sink contract)",
                        epoch,
                        committed if committed is not None
                        else "(record unreadable)",
                    )
                return epoch
            logger.warning(
                "checkpoint: epoch %d failed verification (%s)", epoch, why
            )
        raise StateError(
            f"no intact checkpoint epoch among {candidates}: every "
            "retained epoch has a corrupt, torn, or missing snapshot"
        )

    def _verify_epoch(self, epoch: int) -> tuple[bool, str | None]:
        """Verify EVERY snapshot of one epoch up front: completeness via
        the commit-time manifest (when present), integrity via the blob
        header.  Manifest-less epochs (legacy) verify whatever
        epoch-suffixed keys exist — headerless blobs pass vacuously."""
        try:
            raw = self._get_verified_read(f"manifest@{epoch}")
        except StateError as e:
            return False, f"manifest unreadable: {e}"
        if raw is not None:
            try:
                keys = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                return False, "manifest corrupt"
            if not keys:
                # same invariant as the manifest-less 'seen == 0' check
                # below: a committed epoch always has snapshots, and an
                # empty manifest would otherwise verify vacuously and
                # restore empty state while claiming success
                return False, "manifest lists no snapshots"
            for key in keys:
                try:
                    blob = self._get_verified_read(f"{key}@{epoch}")
                except StateError as e:
                    # a PERSISTENT read error (retries exhausted) fails
                    # the epoch and lets fallback try the next one — it
                    # must not abort recovery outright
                    return False, f"snapshot {key!r} unreadable: {e}"
                if blob is None:
                    return False, f"snapshot {key!r} missing"
                ok, _ = unframe_snapshot(blob)
                if not ok:
                    return False, f"snapshot {key!r} corrupt or torn"
            return True, None
        seen = 0
        try:
            all_keys = self.backend.keys()
        except StateError as e:
            return False, f"key scan failed: {e}"
        for kb in all_keys:
            if epoch_of_key(kb) != epoch or kb.startswith(b"manifest@"):
                continue
            try:
                blob = self._get_verified_read(kb)
            except StateError as e:
                return False, f"snapshot {kb!r} unreadable: {e}"
            ok, _ = unframe_snapshot(blob) if blob is not None else (False, None)
            if not ok:
                return False, f"snapshot {kb!r} corrupt or torn"
            seen += 1
        if seen == 0:
            # a committed epoch ALWAYS has snapshots (sources persist
            # offsets at minimum); manifest-less AND key-less means the
            # epoch's blobs are gone — selecting it would restore empty
            # state while claiming success
            return False, "no snapshots found for epoch"
        return True, None

    # -- write side ------------------------------------------------------
    def put_snapshot(self, key: str, epoch: int, blob: bytes | list[bytes]
                     ) -> int:
        """Frame and store one snapshot blob (or its pieces, in order) →
        the framed byte count."""
        framed = frame_snapshot(blob)
        self._obs_snap_bytes.observe(len(framed))
        # per-state-key last-snapshot size: the aggregate histogram says
        # "restores got bigger", this gauge says WHICH operator's blob
        # grew (keys embed the node id, e.g. window_1_StreamingWindowExec).
        # Bound lazily per key — binding is idempotent and runs at epoch
        # cadence, on the operator thread that owns the series.
        obs.gauge(
            "dnz_checkpoint_last_snapshot_bytes", key=key
        ).set(len(framed))
        self.backend.put(f"{key}@{epoch}", framed)
        self._epoch_keys.setdefault(epoch, []).append(key)
        return len(framed)

    def commit(self, epoch: int) -> None:
        """Marker drained at the root: make epoch E durable (manifest →
        fsync → commit record + history → fsync), then GC epochs beyond
        the retention window.  Transient backend errors retry — a commit
        is the one place a momentary hiccup must not kill the query."""
        manifest = json.dumps(
            sorted(set(self._epoch_keys.get(epoch, [])))
        ).encode()
        new_history = sorted(
            set(h for h in self.committed_history if h < epoch) | {epoch}
        )[-RETAINED_EPOCHS:]
        t0_commit = time.perf_counter()  # dnzlint: allow(replay-impure) commit-latency metric — observability only, not manifest bytes
        last_err = None
        for attempt in range(1, _COMMIT_ATTEMPTS + 1):
            try:
                faults.inject("checkpoint.commit")
                self.backend.put(f"manifest@{epoch}", manifest)
                self.backend.flush()
                self.backend.put(_COMMIT_KEY, str(epoch).encode())
                self.backend.put(
                    _HISTORY_KEY, json.dumps(new_history).encode()
                )
                self.backend.flush()
                last_err = None
                break
            except StateError as e:
                last_err = e
                self.commit_retries += 1
                self._obs_retries.add(1)
                logger.warning(
                    "checkpoint commit epoch %d: %s (attempt %d/%d)",
                    epoch, e, attempt, _COMMIT_ATTEMPTS,
                )
                if attempt < _COMMIT_ATTEMPTS:
                    time.sleep(0.01 * attempt)  # dnzlint: allow(replay-impure) commit-retry backoff — timing never feeds stored bytes
        if last_err is not None:
            raise last_err
        self._obs_commit_ms.observe((time.perf_counter() - t0_commit) * 1e3)  # dnzlint: allow(replay-impure) commit-latency metric — observability only
        self._obs_epoch.set(epoch)
        retained = set(new_history)
        self.committed_epoch = epoch
        self.committed_history = new_history
        # Only epochs BELOW the committing one are stale: a later barrier
        # can already have snapshots on disk while E is still aligning
        # (as the JAX package's threaded join inputs do), and deleting
        # them would leave commit(E+1) a partial manifest.
        stale = {
            e
            for e in (set(self._epoch_keys) | self._known_epochs) - retained
            if e < epoch
        }
        try:
            for old in sorted(stale):
                keys = self._epoch_keys.pop(old, None)
                if keys is None:
                    # a prior incarnation's epoch: its key list lives in
                    # the manifest (always present post-manifest code; a
                    # legacy manifest-less epoch waits for the next
                    # startup sweep)
                    raw = self.backend.get(f"manifest@{old}")
                    if raw is None:
                        continue
                    try:
                        keys = json.loads(raw.decode())
                    except (ValueError, UnicodeDecodeError):
                        keys = []
                for key in keys:
                    self.backend.delete(f"{key}@{old}")
                self.backend.delete(f"manifest@{old}")
        except StateError as e:
            # the commit record is already durable at this point; GC is
            # best-effort cleanup and the next startup sweep collects any
            # leftovers — a hiccup here must not abort the query
            logger.warning(
                "checkpoint commit epoch %d: post-commit GC failed (%s) — "
                "leftover epochs will be swept at next startup", epoch, e,
            )
        self._known_epochs = retained | {epoch}

    def note_aborted(self, epoch: int) -> None:
        """The cluster coordinator aborted in-flight epoch ``epoch`` (a
        peer died before the barrier aligned everywhere; the number is
        never reused — epochs are VALUES here, not dense indexes, and
        commit/GC/history already tolerate gaps).  Eagerly drop any blobs
        this worker wrote for it — source offsets persisted at the barrier
        poll, early keyed snapshots — instead of letting them linger until
        the next commit's sweep.  Best-effort and race-tolerant: a put
        landing after the delete is collected by that later sweep; an
        epoch at or below the committed point is ignored (it is durable,
        not abortable)."""
        if self.committed_epoch is not None and epoch <= self.committed_epoch:
            return
        keys = self._epoch_keys.pop(epoch, []) or []
        self._known_epochs.discard(epoch)
        try:
            for key in keys:
                self.backend.delete(f"{key}@{epoch}")
            self.backend.delete(f"manifest@{epoch}")
        except StateError:
            # cleanup only — the startup sweep or the next commit's GC
            # collects leftovers; an abort must never fail the worker
            pass

    # -- read side -------------------------------------------------------
    def get_snapshot(self, key: str) -> bytes | None:
        if self.committed_epoch is None:
            return None
        # retried like every other recovery-critical read: one transient
        # hiccup must not abort a restore of a verified-intact epoch
        raw = self._get_verified_read(f"{key}@{self.committed_epoch}")
        if raw is None:
            return None
        ok, payload = unframe_snapshot(raw)
        if not ok:
            # construction verified this epoch; reaching here means the
            # store changed underneath us — surface, never feed an
            # operator half a snapshot
            raise StateError(
                f"snapshot {key!r}@{self.committed_epoch} failed "
                "integrity verification"
            )
        return payload


def wire_checkpointing(
    root: ExecOperator, ctx, orch: Orchestrator
) -> CheckpointCoordinator:
    path = ctx.config.state_backend_path
    if not path:
        raise StateError(
            "checkpoint=True requires state_backend_path "
            "(Context.with_state_backend)"
        )
    backend = initialize_global_state_backend(path)
    coord = CheckpointCoordinator(backend)
    ids = assign_node_ids(root)
    for op in walk(root):
        node_id = ids[id(op)]
        hook = getattr(op, "enable_checkpointing", None)
        if hook is not None:
            hook(node_id, coord, orch)
    return coord


def make_barrier_poll(channel):
    """Source-side poll: returns an epoch when a barrier is pending."""

    def poll():
        msg = channel.poll()
        if isinstance(msg, CheckpointBarrier):
            return msg.epoch
        return None

    return poll


def jsonable(v):
    """Recursively convert numpy scalars/arrays for json.dumps."""
    import numpy as np

    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return [jsonable(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): jsonable(x) for k, x in v.items()}
    return v


def put_json(coord: CheckpointCoordinator, key: str, epoch: int, obj) -> None:
    coord.put_snapshot(key, epoch, json.dumps(jsonable(obj)).encode())


def get_json(coord: CheckpointCoordinator, key: str):
    raw = coord.get_snapshot(key)
    return None if raw is None else json.loads(raw.decode())
