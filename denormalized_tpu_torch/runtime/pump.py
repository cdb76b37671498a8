"""Shutdown-safe queue pumps for multi-input operators — counterpart of
``denormalized_tpu/runtime/pump.py``.

``StreamingJoinExec`` runs each input side on a pump thread: a producer
that

- never blocks forever on a bounded queue (it re-checks the consumer's
  ``done`` event while waiting),
- surfaces exceptions as queue items so the consumer re-raises them instead
  of mistaking a dead producer for clean end-of-input,
- always delivers a final ``sentinel``,
- binds instruments into the metrics registry current where the pump was
  spawned (the query's), not the process default, whatever the thread.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Callable, Iterable


def checked_put(
    q: queue_mod.Queue, done: threading.Event, item, timeout: float = 0.1
) -> bool:
    """Bounded put that keeps observing ``done``; False if shutdown won."""
    while not done.is_set():
        try:
            q.put(item, timeout=timeout)
            return True
        except queue_mod.Full:
            continue
    return False


def spawn_pump(
    q: queue_mod.Queue,
    done: threading.Event,
    items: Callable[[], Iterable],
    sentinel,
    wrap: Callable = lambda x: x,
) -> threading.Thread:
    """Start a daemon thread feeding ``wrap(item)`` for each item of
    ``items()`` into ``q``; exceptions are enqueued wrapped too; ``sentinel``
    is always enqueued last (pre-wrapped by the caller)."""
    from denormalized_tpu_torch import obs

    reg = obs.current_registry()

    def run():
        try:
            with obs.bound_registry(reg):
                for item in items():
                    if not checked_put(q, done, wrap(item)):
                        return
        except BaseException as e:  # dnzlint: allow(broad-except) not swallowed — the exception is enqueued as data and the consumer re-raises it (see module docstring)
            checked_put(q, done, wrap(e))
        finally:
            checked_put(q, done, sentinel)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t
