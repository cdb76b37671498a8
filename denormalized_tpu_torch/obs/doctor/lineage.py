"""Sampled record lineage: "why is this window late" as a lookup.

A configurable sample of rows (``EngineConfig(lineage_sample_every=N)``:
every Nth row per partition, capped at ``lineage_max_samples`` live
samples) is tagged at ingest with ``(source, partition, offset snapshot,
event time)``.  The tag is threaded through the pipeline:

- **ingest** — ``SourceExec`` registers the sample the moment the batch
  leaves the reader, with the reader's own post-batch offset snapshot
  (the same snapshot checkpoint barriers persist, so the recorded offset
  is replay-exact);
- **hops** — every operator's instrumented input handoff
  (``ExecOperator._doctor_input``) records the first wall-clock moment a
  batch whose event-time range covers the sample reached that operator
  (batch-granular by design: the vectorized kernels never see per-row
  Python, so lineage must not reintroduce it);
- **emission** — stateful operators report every emitted window's
  ``[start, end)``; a sample lands in the window containing its event
  time, closing the chain.

Each stage also lands a flow event (``ph: s/t/f`` sharing the sample id)
on the span stream, so a Perfetto trace draws the chain as arrows
across threads — and the whole chain set is queryable live via
``GET /queries/<id>/lineage``.

Hot-path contract: with lineage off (the default) the only cost is one
``is None`` check per stream item.  With it on, the per-batch cost is an
O(rows) min/max over the timestamp column plus an O(live samples)
vectorized compare — documented in docs/observability.md.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.obs import spans as obs_spans


class LineageTracker:
    """Per-query sample store.  Mutated from the consumer thread AND the
    join's pump threads, so mutation is lock-protected; the lock only
    ever guards plain list/array bookkeeping (no blocking calls)."""

    def __init__(self, sample_every: int, max_samples: int = 256):
        if sample_every < 1:
            raise ValueError(
                f"lineage_sample_every must be >= 1, got {sample_every}"
            )
        self.sample_every = int(sample_every)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        #: sample id -> record dict (the chain under assembly)
        self._samples: dict[int, dict] = {}
        #: rows seen per (source, partition) — drives every-Nth sampling
        self._seen: dict[tuple, int] = {}
        #: parallel arrays rebuilt on ingest for vectorized matching
        self._live_ids: list[int] = []
        self._live_ts = np.empty(0, dtype=np.int64)
        #: (sample id, node id) hop dedup
        self._hopped: set[tuple] = set()
        self.sampled_total = 0

    # -- ingest (SourceExec) ---------------------------------------------
    def ingest(self, source: str, partition: int, offset_snapshot: dict,
               batch) -> None:
        key = (source, partition)
        prev = self._seen.get(key, 0)
        n = batch.num_rows
        self._seen[key] = prev + n
        first = (-prev) % self.sample_every
        # dnzlint: allow(unguarded) racy fullness peek only skips work early; the insert loop re-checks max_samples under _lock before every admit
        if first >= n or len(self._samples) >= self.max_samples:
            return
        ts_col = np.asarray(
            batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64
        )
        rec = obs_spans.recorder()
        now = time.time()
        with self._lock:
            for idx in range(first, n, self.sample_every):
                if len(self._samples) >= self.max_samples:
                    break
                sid = next(self._ids)
                self._samples[sid] = {
                    "id": sid,
                    "source": source,
                    "partition": int(partition),
                    "offset": dict(offset_snapshot or {}),
                    "row_in_batch": int(idx),
                    "event_time_ms": int(ts_col[idx]),
                    "ingest_wall": now,
                    "hops": [],
                    "emissions": [],
                }
                self.sampled_total += 1
                if rec is not None:
                    rec.flow("lineage", sid, "s", {
                        "source": source, "partition": int(partition),
                        "event_time_ms": int(ts_col[idx]),
                    })
            self._rebuild_live()

    def _rebuild_live(self) -> None:
        self._live_ids = list(self._samples)
        self._live_ts = np.fromiter(
            (self._samples[i]["event_time_ms"] for i in self._live_ids),
            dtype=np.int64, count=len(self._live_ids),
        )

    # -- operator handoff ------------------------------------------------
    def hop(self, node_id: str | None, batch) -> None:
        """Record the first arrival of each covered sample at a node.
        Matching is by event-time-range containment — exact before any
        aggregation, approximate after (emissions re-stamp event time),
        which is why emission matching is a separate explicit call."""
        # dnzlint: allow(unguarded) racy liveness peek only skips the column decode; matching below re-reads _live_ids/_live_ts as a consistent pair under _lock
        if not self._live_ids or node_id is None:
            return
        if not batch.schema.has(CANONICAL_TIMESTAMP_COLUMN):
            return
        ts = np.asarray(
            batch.column(CANONICAL_TIMESTAMP_COLUMN), dtype=np.int64
        )
        if not len(ts):
            return
        mn, mx = int(ts.min()), int(ts.max())
        rec = obs_spans.recorder()
        now = time.time()
        with self._lock:
            # _live_ts indices resolve through _live_ids — both rebuilt
            # together under _lock, so the pair must be read under it
            # too or a concurrent ingest leaves the indices pointing
            # into a different generation of the id list
            hit = (self._live_ts >= mn) & (self._live_ts <= mx)
            if not hit.any():
                return
            for i in np.nonzero(hit)[0]:
                sid = self._live_ids[int(i)]
                s = self._samples.get(sid)
                if s is None or (sid, node_id) in self._hopped:
                    continue
                self._hopped.add((sid, node_id))
                s["hops"].append({"node_id": node_id, "wall": now})
                if rec is not None:
                    rec.flow("lineage", sid, "t", {"node_id": node_id})

    # -- emission (stateful operators) ------------------------------------
    def emitted(
        self, node_id: str | None, start_ms, end_ms, query: str | None = None
    ) -> None:
        """One emitted window ``[start_ms, end_ms)`` (scalars or equal-
        length arrays for a multi-window sweep, e.g. a session close
        cycle).  Every live sample whose event time the window contains
        gains an emission link — completing its ingest → emission chain.
        ``query`` tags the link with the subscriber query id when a
        SHARED pipeline emits for one of its member queries, so one
        tracker serves every member's ``/lineage`` view."""
        # dnzlint: allow(unguarded) racy liveness peek only skips work; the matching loop reads _live_ids/_live_ts under _lock
        if not self._live_ids or node_id is None:
            return
        starts = np.atleast_1d(np.asarray(start_ms, dtype=np.int64))
        ends = np.atleast_1d(np.asarray(end_ms, dtype=np.int64))
        rec = obs_spans.recorder()
        now = time.time()
        with self._lock:
            for i, sid in enumerate(self._live_ids):
                ts = int(self._live_ts[i])
                win = np.nonzero((starts <= ts) & (ts < ends))[0]
                if not len(win):
                    continue
                s = self._samples.get(sid)
                if s is None:
                    continue
                w = int(win[0])
                link = {
                    "node_id": node_id,
                    "window_start_ms": int(starts[w]),
                    "window_end_ms": int(ends[w]),
                    "wall": now,
                    "emit_lag_ms": round(now * 1000.0 - int(ends[w]), 3),
                }
                if query is not None:
                    link["query"] = query
                s["emissions"].append(link)
                if rec is not None:
                    rec.flow("lineage", sid, "f", {
                        "node_id": node_id,
                        "window_start_ms": int(starts[w]),
                        "window_end_ms": int(ends[w]),
                    })

    # -- read side ---------------------------------------------------------
    def chains(self, window_start_ms: int | None = None,
               source: str | None = None,
               query: str | None = None) -> list[dict]:
        """Assembled chains, optionally filtered to samples that landed
        in the window starting at ``window_start_ms`` (the "why is this
        window late" lookup), to one source, or — for a shared pipeline
        whose tracker serves several member queries — to samples with an
        emission tagged for ``query`` (untagged emission links, e.g.
        from a non-shared downstream operator, stay in every member's
        view)."""
        with self._lock:
            out = [dict(s) for s in self._samples.values()]
        if source is not None:
            out = [s for s in out if s["source"] == source]
        if query is not None:
            out = [
                dict(
                    s,
                    emissions=[
                        e for e in s["emissions"]
                        if e.get("query") in (None, query)
                    ],
                )
                for s in out
                if any(
                    e.get("query") in (None, query)
                    for e in s["emissions"]
                ) or not s["emissions"]
            ]
        if window_start_ms is not None:
            out = [
                s for s in out
                if any(
                    e["window_start_ms"] == window_start_ms
                    for e in s["emissions"]
                )
            ]
        return out
