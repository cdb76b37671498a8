"""End-of-line backpressure gate of the state tier.

Counterpart of the gate in ``denormalized_tpu/state/tiering.py``
(``pressure_engaged``/``backpressure_pause`` and the holder set behind
them): while any holder has engaged it, every prefetch worker of the
process pauses a bounded slice before each read, so a query over its
memory ceiling slows its sources instead of halting them.  The spill
controller that engages it is not ported yet (ROADMAP §A item 7), so
nothing in the port engages the gate today; the prefetch workers read it
as the JAX package's do.

Module-level so the prefetch workers can poll it with one global read;
engaged/released under a lock, keyed by (controller, node) so two
queries' gates never mask each other's release.
"""

from __future__ import annotations

import threading
import time

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
