"""Global tag-addressed channel registry.

Mirror of the reference's ``channel_manager``
(crates/orchestrator/src/channel_manager/mod.rs:19-51): a process-global map
of unbounded channels addressed by string tag (``"orchestrator"``,
``"{node_id}_{partition}"``), with ``create_channel`` / ``get_sender`` /
take-once ``take_receiver`` semantics.  Queues stand in for crossbeam
channels; the orchestrator broadcasts barriers through it and sources poll
their tagged channel between batches.  Counterpart of
``denormalized_tpu/state/channel_manager.py``, unchanged.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

_LOCK = threading.RLock()
_CHANNELS: dict[str, "Channel"] = {}


class Channel:
    def __init__(self, tag: str):
        self.tag = tag
        self._q: queue.Queue = queue.Queue()
        self._receiver_taken = False

    def send(self, item) -> None:
        self._q.put(item)

    def poll(self):
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None


def create_channel(tag: str) -> Channel:
    with _LOCK:
        ch = _CHANNELS.get(tag)
        if ch is None:
            ch = Channel(tag)
            _CHANNELS[tag] = ch
        return ch


def get_sender(tag: str) -> Optional[Channel]:
    with _LOCK:
        return _CHANNELS.get(tag)


def take_receiver(tag: str) -> Optional[Channel]:
    """Take-once receiver semantics (mod.rs:40-47)."""
    with _LOCK:
        ch = _CHANNELS.get(tag)
        if ch is None or ch._receiver_taken:
            return None
        ch._receiver_taken = True
        return ch


def remove_channel(tag: str) -> None:
    with _LOCK:
        _CHANNELS.pop(tag, None)


def all_tags() -> list[str]:
    with _LOCK:
        return list(_CHANNELS)
