"""Periodic JSONL snapshots of the registry — counterpart of
``denormalized_tpu/obs/jsonl.py``, writing the same format, so either
package's readers read either's stream.

One line per interval::

    {"event": "obs", "t": <epoch s>, "metrics": {<series>: <value|stats>}}

Counters/gauges snapshot as scalars; histograms as stats dicts carrying
their raw bucket layout (``bounds`` + ``bucket_counts``) so a
multi-process consumer — the soak parent reading every killed segment's
stream — can merge counts across processes and re-derive percentiles
over the union (:func:`merge_histogram`, the read-side counterpart).

The writer is a daemon thread flushing line-buffered, so a SIGKILLed
child still leaves its last completed snapshot behind (same contract as
the soak's chaos events).  ``stop()`` writes one final snapshot for
clean exits.
"""

from __future__ import annotations

import json
import threading
import time

from denormalized_tpu_torch.obs.readers import (  # noqa: F401 (re-exported)
    counter_timeline,
    last_stats,
    merge_histogram,
    read_stream,
)
from denormalized_tpu_torch.obs.registry import MetricsRegistry


class JsonlSnapshotter:
    def __init__(
        self,
        path: str,
        registry: MetricsRegistry,
        interval_s: float = 1.0,
    ):
        self._path = path
        self._registry = registry
        self._interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="obs-jsonl"
        )

    def start(self) -> "JsonlSnapshotter":
        self._thread.start()
        return self

    def _write_once(self, f) -> None:
        snap = self._registry.snapshot()
        f.write(json.dumps({
            "event": "obs", "t": time.time(), "metrics": snap,
        }) + "\n")

    def _run(self) -> None:
        with open(self._path, "a", buffering=1) as f:
            while not self._stop.wait(self._interval_s):
                self._write_once(f)
            self._write_once(f)  # final snapshot on clean stop

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


# -- read side --------------------------------------------------------------


# The read-side helpers (read_stream / last_stats / merge_histogram /
# counter_timeline) live in :mod:`denormalized_tpu_torch.obs.readers`, a
# stdlib-only module, and are re-exported here for in-process consumers.
