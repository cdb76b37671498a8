"""Typed metric instruments, their catalog, and the registry that owns them.

Counterpart of ``denormalized_tpu/obs/registry.py``, cut to what the
checkpoint path reads: counters, gauges and histograms that keep a sum and
a count, bound once by name and labels and then updated with one attribute
write.  Instruments carry no locks: each bound handle has one writer.  The
JAX package's buckets, quantiles, pull gauges and exporters (Prometheus,
JSONL, spans) are not ported.
"""

from __future__ import annotations

import threading

#: every instrument the port binds: name → (kind, help); the names and
#: kinds are the JAX package's
INSTRUMENTS: dict[str, tuple[str, str]] = {
    "dnz_lsm_op_ms": (
        "histogram",
        "latency of one LSM state-backend operation, labeled "
        "op=put|get|flush",
    ),
    "dnz_lsm_replay_truncated_total": (
        "counter",
        "torn segment tails dropped by LSM startup replay (pure-Python "
        "engine only)",
    ),
    "dnz_checkpoint_commit_ms": (
        "histogram",
        "duration of a checkpoint commit (manifest + fsync + commit "
        "record + fsync + GC)",
    ),
    "dnz_checkpoint_snapshot_bytes": (
        "histogram",
        "size of one operator snapshot blob as persisted (framed)",
    ),
    "dnz_checkpoint_committed_epoch": (
        "gauge",
        "the last durably committed checkpoint epoch",
    ),
    "dnz_checkpoint_commit_retries_total": (
        "counter",
        "transient StateErrors absorbed by the bounded commit retry",
    ),
    "dnz_op_rows_out_total": (
        "counter",
        "rows leaving a physical operator (source or join emission)",
    ),
    "dnz_join_adaptations_total": (
        "counter",
        "hot-key sub-partition layout changes applied by the join's "
        "closed-loop policy, labeled action=adapt|fold and side=left|right",
    ),
    "dnz_checkpoint_last_snapshot_bytes": (
        "gauge",
        "size of the most recent snapshot blob persisted under one state "
        "key (framed bytes), labeled key=<node-scoped state key>",
    ),
    # -- live sources (sources/kafka.py, runtime/prefetch.py) -----------
    "dnz_prefetch_queue_depth": (
        "gauge",
        "rowful batches enqueued but not yet consumed for one "
        "partition's prefetch buffer (the bounded per-partition buffer is "
        "full when depth == depth limit)",
    ),
    "dnz_prefetch_restarts_total": (
        "counter",
        "supervised prefetch-worker restarts (crash + rebuild + reseek)",
    ),
    "dnz_prefetch_queue_dwell_ms": (
        "histogram",
        "time a rowful batch sat in the prefetch ready queue between "
        "worker enqueue and consumer dequeue (sustained growth means the "
        "consumer thread is the bottleneck, not ingest)",
    ),
    "dnz_kafka_consumer_lag_rows": (
        "gauge",
        "records between this reader's cursor and the partition high "
        "watermark reported by the last fetch response (0 = caught up)",
    ),
    "dnz_source_salvaged_rows": (
        "gauge",
        "poison records skipped by per-record salvage decode, labeled "
        "source= and partition=",
    ),
    "dnz_sink_retries_total": (
        "counter",
        "transient produce errors absorbed by the Kafka sink's bounded "
        "exp-backoff retry",
    ),
    # -- the cold tier (state/tiering.py) --------------------------------
    "dnz_spill_op_ms": (
        "histogram",
        "latency of one cold-tier block operation, labeled "
        "op=spill|reload (spill = LSM put of one evicted block; reload = "
        "LSM get on touch, excluding re-merge)",
    ),
    "dnz_spill_blocks_total": (
        "counter",
        "cold-tier blocks moved, labeled op=spill|reload — a reload "
        "rate tracking the spill rate is the spill-thrashing signal",
    ),
    "dnz_spill_backpressure_total": (
        "counter",
        "escalations to end-of-line prefetch backpressure because "
        "accounted state exceeded the hard ceiling with no evictable "
        "cold state left",
    ),
    # -- the multi-query engine (physical/slice_exec.py, the shared
    # join's attribution in physical/join_exec.py) ----------------------
    "dnz_windows_emitted_total": (
        "counter",
        "windows/sessions emitted by a stateful operator",
    ),
    "dnz_late_rows_total": (
        "counter",
        "rows dropped late (behind the watermark) by a stateful operator",
    ),
    "dnz_watermark_lag_ms": (
        "gauge",
        "wall clock minus the operator's event-time watermark at the "
        "last trigger — how far event time trails real time (includes "
        "the replay offset when replaying historical data)",
    ),
    "dnz_watermark_lag_hist_ms": (
        "histogram",
        "distribution of wall-minus-watermark samples taken at every "
        "trigger (the max over a run is the peak watermark lag)",
    ),
    "dnz_emit_event_lag_ms": (
        "histogram",
        "end-to-end event-time emission latency: wall clock minus "
        "window end, observed once per emitted window (for a replayed "
        "feed this includes the constant replay offset; consumers "
        "subtract their feed anchor — see tools/soak.py)",
    ),
    "dnz_mq_emit_lag_ms": (
        "gauge",
        "per-subscriber end-to-end emission lag of a shared slice "
        "pipeline: wall clock minus window end at that query's last "
        "emitted window, labeled query=<subscriber label> — attributes "
        "shared-pipeline lag to the individual query (the aggregate "
        "dnz_emit_event_lag_ms histogram sums over subscribers)",
    ),
    "dnz_slice_rows_total": (
        "counter",
        "rows folded into shared slice partials by a SliceWindowExec — "
        "each row is aggregated ONCE here regardless of how many "
        "overlapping windows or subscriber queries later fold it",
    ),
    "dnz_slice_units": (
        "gauge",
        "live slice units (slide-unit partial rows) resident in one "
        "shared slice store — bounded by the longest subscriber window "
        "plus watermark lag over the gcd slice width",
    ),
    "dnz_slice_subscribers": (
        "gauge",
        "window specs (concurrent queries) folding their windows from "
        "one shared slice store — 1 on the single-query fast path",
    ),
    "dnz_slice_folds_total": (
        "counter",
        "window folds served from slice partials (one per closable "
        "window per subscriber, including folds that found no active "
        "groups and emitted nothing)",
    ),
    "dnz_slice_fold_ms": (
        "histogram",
        "latency of one window fold: combining L/gcd slice partials + "
        "finalize + emission assembly for one subscriber's window",
    ),
    "dnz_sketch_rows_total": (
        "counter",
        "rows fed through slice-store sketch kernels (HLL / Space-"
        "Saving / quantile compactor planes) by a SliceWindowExec — "
        "counted once per batch over all filter classes, so a row a "
        "residual class re-accumulates counts again (it ran the kernel "
        "again)",
    ),
    "dnz_sketch_state_bytes": (
        "gauge",
        "exact bytes held by sketch planes across a SliceWindowExec's "
        "live slices — constant in value cardinality by construction "
        "(the contrast to unbounded exact distinct/median accumulator "
        "growth the doctor's state verdicts flag)",
    ),
    "dnz_sketch_update_ms": (
        "histogram",
        "per-batch time inside sketch accumulate kernels (all planes, "
        "all filter classes) — the marginal ingest cost of approximate "
        "aggregates riding a shared slice pipeline",
    ),
    "dnz_mq_subscribers_live": (
        "gauge",
        "subscriber queries currently attached to one shared slice "
        "pipeline — moves on live attach/detach, unlike "
        "dnz_slice_subscribers it counts the instantaneous registry "
        "(after mid-stream joins and leaves), not the planning-time set",
    ),
    "dnz_mq_backfill_windows_total": (
        "counter",
        "windows served to a mid-stream joiner from the slice store's "
        "RETAINED partials at attach time — each one is a window the "
        "query got without replaying the stream, exact from the gcd "
        "slices already covering it",
    ),
    "dnz_mq_refilter_ms": (
        "histogram",
        "per-batch cost of the residual re-filter masks in a shared "
        "slice pipeline (predicate-subsumption sharing): evaluating "
        "each stronger member's own predicate over the batch — or over "
        "NEW interner keys only on the gid lane — before per-class "
        "accumulation; observed only when a residual class exists",
    ),
    "dnz_mq_join_stage_ms": (
        "histogram",
        "per-batch time one SHARED join spent in each stage, labeled "
        "stage=build|probe|gather (build = intern+insert, probe = "
        "equi/band index probe, gather = pair materialization+filter) "
        "— observed only when the join feeds a shared slice pipeline "
        "(enable_shared_attribution); feeds the doctor's measured-cost "
        "attribution across subscriber queries",
    ),
    "dnz_mq_join_fanout_rows_total": (
        "counter",
        "joined rows fanned out from one shared StreamingJoinExec into "
        "its group's slice pipeline — rows every subscriber's residual "
        "class then re-filters, vs dnz_op_rows_out_total{op=join} which "
        "also counts unshared joins",
    ),
}


class Counter:
    """Monotone counter.  One writer per bound handle."""

    __slots__ = ("name", "labels", "value")
    kind = "counter"

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value.  One writer per bound handle."""

    __slots__ = ("name", "labels", "value")
    kind = "gauge"

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Sum and count of the observed values."""

    __slots__ = ("name", "labels", "sum", "count")
    kind = "histogram"

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1


_CLASSES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def series_name(name: str, labels: tuple) -> str:
    if not labels:
        return name
    body = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{body}}}"


class MetricsRegistry:
    """Owns every bound instrument.  Binding is keyed ``(name, sorted
    labels)``: re-binding a series returns the same instrument."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, object] = {}

    def _bind(self, want_kind: str, name: str, labels: dict):
        entry = INSTRUMENTS.get(name)
        if entry is None:
            raise KeyError(
                f"instrument {name!r} is not declared in "
                "denormalized_tpu_torch/obs/registry.py INSTRUMENTS"
            )
        if entry[0] != want_kind:
            raise TypeError(
                f"instrument {name!r} is declared as a {entry[0]}, bound "
                f"as a {want_kind}"
            )
        key = (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = _CLASSES[want_kind](name, key[1])
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._bind("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._bind("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._bind("histogram", name, labels)

    def snapshot(self) -> dict:
        """Series name → value for counters and gauges, ``{"count",
        "sum"}`` for histograms."""
        with self._lock:
            insts = list(self._instruments.values())
        out: dict[str, object] = {}
        for inst in insts:
            key = series_name(inst.name, inst.labels)
            if isinstance(inst, Histogram):
                out[key] = {"count": inst.count, "sum": inst.sum}
            else:
                out[key] = inst.value
        return out
