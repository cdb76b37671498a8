"""The instrument catalog — every metric the engine emits, declared once:
a copy of ``denormalized_tpu/obs/catalog.py`` (names, kinds, help strings
and bucket layouts; ``tests/test_torch_obs.py`` holds the two equal).
Binding a name that keys nothing here raises.  The cluster runtime
(``cluster/exchange.py``, ``cluster/runtime.py``, ``cluster/coordinator.py``)
binds the ``dnz_exchange_*`` and ``dnz_cluster_*`` instruments.

Naming convention:

- every name matches ``^dnz_[a-z][a-z0-9_]*$``;
- counters end in ``_total`` (Prometheus counter convention);
- histograms end in a unit suffix: ``_ms``, ``_s``, ``_bytes`` or
  ``_rows``;
- every entry carries a non-trivial help string.

Entries are ``name: (kind, help[, buckets])`` where ``kind`` is
``"counter"`` / ``"gauge"`` / ``"histogram"`` and ``buckets`` (histograms
only) is an exponential layout ``{"start": s, "factor": f, "count": n}``
producing bounds ``s, s*f, s*f^2, ...`` plus the implicit +Inf bucket.
"""

from __future__ import annotations

# exponential bucket layouts (see exp_bounds): latencies from 50µs to
# ~7min, sizes from 256B to ~4GB, row counts from 1 to ~1B — wide enough
# that a soak never saturates the top bucket and percentile estimates
# stay meaningful
MS_BUCKETS = {"start": 0.05, "factor": 2.0, "count": 23}
BYTES_BUCKETS = {"start": 256.0, "factor": 4.0, "count": 12}
ROWS_BUCKETS = {"start": 1.0, "factor": 4.0, "count": 15}

INSTRUMENTS: dict[str, tuple] = {
    # -- per-operator (physical/*) -------------------------------------
    "dnz_op_rows_in_total": (
        "counter",
        "rows entering a physical operator, labeled op=<operator>",
    ),
    "dnz_op_rows_out_total": (
        "counter",
        "rows leaving a physical operator (source/join/sink emission)",
    ),
    "dnz_op_batch_ms": (
        "histogram",
        "wall time one operator spent processing one input batch "
        "(eval + device dispatch + emission assembly; excludes time "
        "spent suspended in downstream operators)",
        MS_BUCKETS,
    ),
    "dnz_windows_emitted_total": (
        "counter",
        "windows/sessions emitted by a stateful operator",
    ),
    "dnz_late_rows_total": (
        "counter",
        "rows dropped late (behind the watermark) by a stateful operator",
    ),
    # -- watermark / end-to-end latency (stamped at window emit) --------
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
        MS_BUCKETS,
    ),
    "dnz_emit_event_lag_ms": (
        "histogram",
        "end-to-end event-time emission latency: wall clock minus "
        "window end, observed once per emitted window (for a replayed "
        "feed this includes the constant replay offset; consumers "
        "subtract their feed anchor — see tools/soak.py)",
        MS_BUCKETS,
    ),
    # -- ingest (runtime/prefetch.py, sources/kafka.py) -----------------
    "dnz_prefetch_queue_depth": (
        "gauge",
        "rowful batches enqueued but not yet consumed for one "
        "partition's prefetch buffer (backpressure: the bounded "
        "per-partition double buffer is full when depth == depth limit)",
    ),
    "dnz_prefetch_restarts_total": (
        "counter",
        "supervised prefetch-worker restarts (crash + rebuild + reseek)",
    ),
    "dnz_kafka_consumer_lag_rows": (
        "gauge",
        "records between this reader's cursor and the partition high "
        "watermark reported by the last fetch response (broker-side "
        "backlog; 0 = caught up)",
    ),
    "dnz_decode_fallback_rows": (
        "gauge",
        "rows decoded through the ~30x-slower Python fallback path "
        "instead of the native columnar parser (registry view of the "
        "SourceExec.metrics() counter)",
    ),
    # -- state (state/lsm.py, state/checkpoint.py) ----------------------
    "dnz_lsm_op_ms": (
        "histogram",
        "latency of one LSM state-backend operation, labeled "
        "op=put|get|flush",
        MS_BUCKETS,
    ),
    "dnz_checkpoint_commit_ms": (
        "histogram",
        "duration of a checkpoint commit (manifest + fsync + commit "
        "record + fsync + GC)",
        MS_BUCKETS,
    ),
    "dnz_checkpoint_snapshot_bytes": (
        "histogram",
        "size of one operator snapshot blob as persisted (framed)",
        BYTES_BUCKETS,
    ),
    "dnz_checkpoint_committed_epoch": (
        "gauge",
        "the last durably committed checkpoint epoch",
    ),
    "dnz_checkpoint_commit_retries_total": (
        "counter",
        "transient StateErrors absorbed by the bounded commit retry "
        "(registry view of CheckpointCoordinator.commit_retries)",
    ),
    "dnz_lsm_replay_truncated_total": (
        "counter",
        "torn segment tails dropped by LSM startup replay (registry "
        "view of LsmStore.replay_truncated; pure-Python engine only)",
    ),
    # -- pipeline doctor (obs/doctor, docs/observability.md) ------------
    "dnz_op_input_wait_ms": (
        "histogram",
        "time an operator spent suspended waiting for its upstream to "
        "yield the next stream item — the doctor's queue-wait signal "
        "(high wait + low busy = this stage is starved by upstream)",
        MS_BUCKETS,
    ),
    "dnz_prefetch_queue_dwell_ms": (
        "histogram",
        "time a rowful batch sat in the prefetch ready queue between "
        "worker enqueue and consumer dequeue (handoff dwell: sustained "
        "growth means the consumer thread is the bottleneck, not ingest)",
        MS_BUCKETS,
    ),
    # -- state observatory (obs/statewatch.py, docs/observability.md) ---
    "dnz_state_bytes": (
        "gauge",
        "live bytes of keyed state held by one stateful operator "
        "(restore-invariant accounting: exact numpy storage for live "
        "slots/rows plus documented per-object estimates for Python "
        "accumulators and interned keys), labeled node=<plan node id>",
    ),
    "dnz_state_live_keys": (
        "gauge",
        "keys/groups currently holding live state in one stateful "
        "operator, labeled node=<plan node id>",
    ),
    "dnz_state_slots": (
        "gauge",
        "slot-table shape of one stateful operator, labeled node= and "
        "kind=capacity|live — occupancy vs allocated capacity (a low "
        "ratio means the table grew for a churn spike and has not "
        "shrunk back)",
    ),
    "dnz_state_oldest_event_lag_ms": (
        "gauge",
        "operator watermark minus the oldest retained event time — how "
        "far back live state reaches; sustained growth beyond a few "
        "window/gap/retention units is the retention-leak signal",
    ),
    "dnz_state_hot_key_share": (
        "gauge",
        "estimated state-mass share of one Space-Saving-tracked hot "
        "key (labeled node=, key=, and side= for joins); only the "
        "current top-K are refreshed, keys that fall out read 0",
    ),
    "dnz_state_skew_factor": (
        "gauge",
        "top-1 key share x live keys for one stateful operator: ~1 on "
        "a uniform key distribution, >>1 when one key dominates (the "
        "adaptive-join sub-partitioning trigger signal)",
    ),
    "dnz_checkpoint_last_snapshot_bytes": (
        "gauge",
        "size of the most recent snapshot blob persisted under one "
        "state key (framed bytes), labeled key=<node-scoped state key> "
        "— restore-size regressions are attributable to one operator",
    ),
    # -- tiered state / spill (state/tiering.py) ------------------------
    "dnz_state_spilled_bytes": (
        "gauge",
        "bytes of one stateful operator's keyed state currently resident "
        "in the cold LSM tier instead of RAM (payload bytes as stored), "
        "labeled node=<plan node id>",
    ),
    "dnz_state_spilled_keys": (
        "gauge",
        "keys/groups (join: retained rows) whose state currently lives "
        "in the cold LSM tier, labeled node=<plan node id>",
    ),
    "dnz_spill_op_ms": (
        "histogram",
        "latency of one cold-tier block operation, labeled "
        "op=spill|reload (spill = serialize + LSM put of one evicted "
        "block; reload = LSM get on touch, excluding re-merge)",
        MS_BUCKETS,
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
    # -- closed-loop skew adaptation (obs/doctor/actions.py) ------------
    "dnz_join_adaptations_total": (
        "counter",
        "hot-key sub-partition layout changes applied by the join's "
        "closed-loop policy, labeled action=adapt|fold and "
        "side=left|right — the first doctor verdict that acts instead "
        "of reporting (each change also lands as a Perfetto instant "
        "event)",
    ),
    # -- multi-query slice store (physical/slice_exec.py) ---------------
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
        MS_BUCKETS,
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
        MS_BUCKETS,
    ),
    # -- query-dense serving: live registration + subsumption --------
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
        MS_BUCKETS,
    ),
    # -- query-dense joins: shared StreamingJoinExec ----------------
    "dnz_mq_join_stage_ms": (
        "histogram",
        "per-batch time one SHARED join spent in each stage, labeled "
        "stage=build|probe|gather (build = intern+insert, probe = "
        "equi/band index probe, gather = pair materialization+filter) "
        "— observed only when the join feeds a shared slice pipeline "
        "(enable_shared_attribution); feeds the doctor's measured-cost "
        "attribution across subscriber queries",
        MS_BUCKETS,
    ),
    "dnz_mq_join_fanout_rows_total": (
        "counter",
        "joined rows fanned out from one shared StreamingJoinExec into "
        "its group's slice pipeline — rows every subscriber's residual "
        "class then re-filters, vs dnz_op_rows_out_total{op=join} which "
        "also counts unshared joins",
    ),
    # -- sink (sources/kafka.py KafkaSinkWriter) ------------------------
    "dnz_sink_retries_total": (
        "counter",
        "transient produce errors absorbed by the sink's bounded "
        "exp-backoff retry (registry view of KafkaSinkWriter."
        "sink_retries) — a rising rate means the output broker is "
        "flapping even though segments still succeed",
    ),
    # -- source salvage (sources/kafka.py _salvage_decode) --------------
    "dnz_source_salvaged_rows": (
        "gauge",
        "poison records skipped by per-record salvage decode (the fetch "
        "kept its co-fetched good rows; these were undecodable and "
        "dropped), labeled source= and partition= — invisible data loss "
        "otherwise",
    ),
    # -- fault injection (runtime/faults.py) ----------------------------
    "dnz_fault_injections_total": (
        "counter",
        "fault-plan rules fired, labeled site=<injection site> — the "
        "chaos event stream's counter view (timeline derivable from "
        "successive JSONL snapshots)",
    ),
    # -- cluster exchange (cluster/exchange.py) -------------------------
    "dnz_exchange_frames_total": (
        "counter",
        "exchange frames moved, labeled dir=send|recv and edge=src->dst "
        "(recv aggregates per receiving worker) — barrier and watermark "
        "frames included, loopback excluded",
    ),
    "dnz_exchange_bytes_total": (
        "counter",
        "framed exchange bytes moved (wire size incl. header+CRC on "
        "send, payload on recv), labeled like dnz_exchange_frames_total",
    ),
    "dnz_exchange_send_ms": (
        "histogram",
        "wall time one framed exchange send spent in sendall — rising "
        "percentiles mean the peer's edge queue (backpressure) or the "
        "socket buffer is the bottleneck, not this worker's ingest",
        MS_BUCKETS,
    ),
    "dnz_exchange_edge_depth": (
        "gauge",
        "decoded frames queued on one inbound exchange edge awaiting "
        "the keyed half (labeled edge=src->dst); pinned at the bound "
        "while an edge is barrier-blocked during alignment",
    ),
    "dnz_exchange_reconnects_total": (
        "counter",
        "successful redials of a down exchange edge (labeled "
        "edge=src->dst): each one is a tear or peer death the sender "
        "survived by buffering and resuming in place",
    ),
    "dnz_exchange_replayed_frames_total": (
        "counter",
        "buffered frames re-sent on a resumed exchange edge (labeled "
        "edge=src->dst) — the receiver's rejoin ledgers dedupe them, "
        "so replay volume is a recovery-cost signal, not a "
        "correctness one",
    ),
    "dnz_exchange_edges_down": (
        "gauge",
        "inbound exchange edges currently disconnected on one worker "
        "(labeled worker=id); nonzero while a peer is dead or "
        "mid-rejoin — the degraded-edge doctor verdict reads this",
    ),
    "dnz_cluster_recovery_ms": (
        "histogram",
        "wall time from detecting a worker death to its respawn "
        "reporting ready with the rejoin handshake complete — the "
        "partial-recovery latency the full-cluster fallback is "
        "measured against",
        MS_BUCKETS,
    ),
    "dnz_cluster_worker_restarts_total": (
        "counter",
        "single-worker partial respawns ordered by the coordinator "
        "(labeled worker=id); full-cluster restarts do NOT count here "
        "— a rising series on one worker label points at a sick host "
        "or a poisoned partition subset",
    ),
}


def exp_bounds(spec: dict) -> list[float]:
    """Materialize an exponential bucket layout into ascending upper
    bounds (the +Inf bucket is implicit)."""
    start = float(spec["start"])
    factor = float(spec["factor"])
    count = int(spec["count"])
    return [start * factor**i for i in range(count)]


def declaration(name: str) -> tuple:
    """(kind, help, bounds|None) for a declared instrument; raises
    KeyError with the catalog pointer for unknown names — binding an
    undeclared instrument is a programming error."""
    try:
        entry = INSTRUMENTS[name]
    except KeyError:
        raise KeyError(
            f"instrument {name!r} is not declared in "
            "denormalized_tpu_torch/obs/catalog.py (every metric name must "
            "be declared with a help string)"
        ) from None
    kind, help_str = entry[0], entry[1]
    bounds = exp_bounds(entry[2]) if kind == "histogram" else None
    return kind, help_str, bounds
