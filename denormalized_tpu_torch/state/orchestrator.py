"""Checkpoint barrier orchestrator.

Mirror of the reference's ``Orchestrator`` (crates/orchestrator/src/
orchestrator.rs:30-80): a background worker that accepts stream
registrations and broadcasts ``CheckpointBarrier(epoch_millis)`` to every
registered channel on a fixed cadence (10s in the reference, :58).

Difference by design: the reference delivers barriers out-of-band to EVERY
operator, giving only approximate consistency (SURVEY.md §3.4).  Here only
SOURCES register; the barrier enters the dataflow as an in-band
:class:`~denormalized_tpu_torch.physical.base.Marker` right after the batch the
source is currently emitting, and every downstream operator snapshots when
the marker reaches it — an aligned (Chandy-Lamport-consistent) cut on
single-input chains.

Counterpart of ``denormalized_tpu/state/orchestrator.py``, unchanged.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from denormalized_tpu_torch.state import channel_manager as cm

ORCHESTRATOR_TAG = "orchestrator"


@dataclass(frozen=True)
class RegisterStream:
    tag: str


@dataclass(frozen=True)
class CheckpointBarrier:
    epoch: int


class Orchestrator:
    _seq = 0

    def __init__(self, interval_s: float = 10.0):
        self.interval_s = interval_s
        self._registered: set[str] = set()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # per-instance control tag: concurrent queries in one process must
        # not steal each other's RegisterStream messages
        Orchestrator._seq += 1
        self._control_tag = f"{ORCHESTRATOR_TAG}_{Orchestrator._seq}"
        self._control = cm.create_channel(self._control_tag)
        self.epochs_sent = 0
        self._last_epoch = 0
        self._epoch_lock = threading.Lock()

    def _next_epoch(self) -> int:
        """Strictly increasing epoch: wall-clock millis, bumped past the
        previous value when two barriers land in the same millisecond (or
        the clock steps back) — identical epochs would collide checkpoint
        keys ``{key}@{epoch}`` across distinct cuts and double-count in the
        join's per-epoch marker alignment.  Locked: trigger_now runs on the
        caller's thread concurrently with the cadence thread."""
        with self._epoch_lock:
            e = max(self._last_epoch + 1, int(time.time() * 1000))
            self._last_epoch = e
            return e

    def register(self, tag: str) -> cm.Channel:
        """Register a stream; returns its barrier channel (sources poll it)."""
        ch = cm.create_channel(tag)
        self._control.send(RegisterStream(tag))
        return ch

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        last = time.monotonic()
        while not self._stop.is_set():
            # drain control messages (RegisterStream)
            while True:
                msg = self._control.poll()
                if msg is None:
                    break
                if isinstance(msg, RegisterStream):
                    self._registered.add(msg.tag)
            if time.monotonic() - last >= self.interval_s:
                last = time.monotonic()
                epoch = self._next_epoch()
                for tag in list(self._registered):
                    ch = cm.get_sender(tag)
                    if ch is not None:
                        ch.send(CheckpointBarrier(epoch))
                self.epochs_sent += 1
            self._stop.wait(min(0.05, self.interval_s / 4))

    def trigger_now(self) -> int:
        """Force an immediate barrier (tests / graceful shutdown)."""
        while True:
            msg = self._control.poll()
            if msg is None:
                break
            if isinstance(msg, RegisterStream):
                self._registered.add(msg.tag)
        epoch = self._next_epoch()
        for tag in list(self._registered):
            ch = cm.get_sender(tag)
            if ch is not None:
                ch.send(CheckpointBarrier(epoch))
        self.epochs_sent += 1
        return epoch

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        # drop this query's channels so a later run reusing the same node-id
        # tags doesn't receive stale barriers
        cm.remove_channel(self._control_tag)
        for tag in self._registered:
            cm.remove_channel(tag)
        self._registered.clear()
