"""Ring-buffered structured span recorder → Chrome trace-event JSON.

Replaces the log-line spans of ``runtime/tracing.py`` as the machine
half of tracing: every :func:`~denormalized_tpu_torch.runtime.tracing.span`
records a complete ("ph": "X") event here when a recorder is installed,
and fault injections land as instant ("ph": "i") events on the same
stream, so one dump shows the whole pipeline — batch processing, window
emits, checkpoint snapshots, prefetch restarts, injected faults — on a
per-thread timeline loadable in Perfetto (ui.perfetto.dev) or
chrome://tracing.

The ring is a preallocated slot list written lock-free per event under
the GIL (index reservation is a single ``itertools.count`` step, which
is atomic); the newest ``capacity`` events win.  Timestamps are
microseconds on the perf_counter clock, normalized so the earliest
retained event sits at t=0.
"""

from __future__ import annotations

import itertools
import json
import threading
import time


class SpanRecorder:
    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._slots: list = [None] * capacity
        self._next = itertools.count()
        self._t0 = time.perf_counter()

    # -- write side (hot-ish: per span, never per row) -------------------
    def record(
        self,
        name: str,
        t0_s: float,
        dur_s: float,
        args: dict | None = None,
        error: str | None = None,
    ) -> None:
        """One complete span: ``t0_s`` from ``time.perf_counter()``."""
        if error is not None:
            args = dict(args or ())
            args["error"] = error
        idx = next(self._next)
        self._slots[idx % self.capacity] = (
            idx, "X", name, t0_s, dur_s, threading.get_ident(), args or None,
        )

    def instant(self, name: str, args: dict | None = None) -> None:
        """One instant event (fault injections, restarts)."""
        idx = next(self._next)
        self._slots[idx % self.capacity] = (
            idx, "i", name, time.perf_counter(), 0.0,
            threading.get_ident(), args or None,
        )

    def flow(self, name: str, flow_id: int, phase: str,
             args: dict | None = None) -> None:
        """One flow event: ``phase`` is ``"s"`` (start), ``"t"`` (step)
        or ``"f"`` (finish).  Events sharing ``(name, flow_id)`` render
        as connected arrows in Perfetto — how sampled record lineage
        (obs/doctor/lineage.py) draws ingest → operator → emission
        chains on the same stream as the engine's spans."""
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
        idx = next(self._next)
        self._slots[idx % self.capacity] = (
            idx, phase, name, time.perf_counter(), float(flow_id),
            threading.get_ident(), args or None,
        )

    # -- read side -------------------------------------------------------
    def events(self) -> list[tuple]:
        """Retained events, oldest first (slots carry their sequence
        number, so ring order reconstructs without a shared counter
        read racing the writers)."""
        return sorted(
            (s for s in self._slots if s is not None), key=lambda e: e[0]
        )

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        events = self.events()
        base = min((e[3] for e in events), default=self._t0)
        out = []
        for _idx, ph, name, t0, dur, tid, args in events:
            ev = {
                "ph": ph,
                "name": name,
                "pid": 1,
                "tid": tid,
                "ts": round((t0 - base) * 1e6, 1),
                "cat": name.split(".", 1)[0],
            }
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 1)
            if ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if ph in ("s", "t", "f"):
                # flow events reuse the dur slot as the flow id; "e"
                # binds the finish arrow to the enclosing slice's end
                ev["id"] = int(dur)
                if ph == "f":
                    ev["bp"] = "e"
            if args:
                ev["args"] = args
            if args and "error" in args:
                ev["cname"] = "terrible"  # red in the trace viewer
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


# -- process-global recorder (mirrors the tracing/fault globals) ----------

_RECORDER: SpanRecorder | None = None


def enable_span_recording(capacity: int = 65536) -> SpanRecorder:
    """Install (or replace) the process recorder; spans and fault
    events start landing in it immediately."""
    global _RECORDER
    _RECORDER = SpanRecorder(capacity)
    return _RECORDER


def disable_span_recording() -> None:
    global _RECORDER
    _RECORDER = None


def recorder() -> SpanRecorder | None:
    return _RECORDER
