"""Session context — the framework entry point.

Counterpart of ``denormalized_tpu/api/context.py``: builds the session,
registers sources as named tables and hands out :class:`DataStream`
builders.  :class:`EngineConfig` carries the knobs the ported window path
reads, plus an explicit ``device``: the device rule of the whole package,
``optimizer`` (the logical optimizer on or off), ``emit_on_close`` (flush
the open windows and sessions at end of stream), the checkpoint knobs
(``checkpoint``, ``checkpoint_interval_s``, ``state_backend_path``, or
:meth:`Context.with_state_backend`), the cold tier's
``state_budget_bytes`` and ``state_spill``, the
join knobs (``join_retention_ms``, ``join_adaptive``,
``join_adapt_interval_s``, ``join_band_slack_ms``),
``partition_watermarks``, ``source_idle_timeout_ms``, the window
operator's ``accum_dtype``, ``emission_compaction`` and ``host_pipeline``,
the multi-query engine's ``slice_windows``, ``slice_unit_ms``,
``slice_sort_lane``, ``approx_native`` and ``mq_subsumption``, and the
observability knobs (``metrics_enabled``, ``prometheus_port``,
``metrics_jsonl_path``, ``metrics_jsonl_interval_s``, ``trace_path``,
``trace_events``, ``doctor_enabled``, ``lineage_sample_every``,
``lineage_max_samples``, ``profiler_hz``).
:meth:`Context.from_topic` reads a Kafka topic (JSON or Avro payloads);
:meth:`Context.table` returns a registered source and
:meth:`EngineConfig.set` sets a knob by its ``denormalized_config.`` name.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.sources.base import Source


@dataclass
class EngineConfig:
    """Engine tuning knobs (the ported subset of the JAX package's
    EngineConfig)."""

    # where the window ring and its kernels run.  "cuda" (the default)
    # needs a CUDA device: without one Context() raises rather than carry
    # on on the CPU.  "cpu" runs the same programs with the kernels' plain
    # PyTorch versions (the tests use it); "cuda:N" picks a card.
    device: str = "cuda"
    # logical optimizer (projection pruning, filter pushdown, project
    # merge): False runs the plan as written
    optimizer: bool = True
    # checkpointing (denormalized_config.checkpoint): barriers every
    # checkpoint_interval_s (orchestrator.rs:58), snapshots in the LSM
    # store at state_backend_path
    checkpoint: bool = False
    checkpoint_interval_s: float = 10.0
    state_backend_path: str | None = None
    # tiered state (state/tiering.py): with a budget AND a state backend,
    # stateful operators evict their coldest window slots (off the card),
    # retained join batches, sessions and accumulators to the LSM once
    # their accounted state crosses state_budget_bytes, and reload them on
    # touch.  state_spill 'auto' (default) = active exactly when both are
    # set; False keeps the budget inert; True additionally REQUIRES a
    # backend path (a loud error instead of an inert budget).  One
    # budgeted query per backend path
    state_budget_bytes: int | None = None
    state_spill: bool | str = "auto"
    # per-batch device step:
    #   'scatter'       — ship rows, scatter them into the window ring
    #   'pallas_dense'  — ship rows, the dense low-cardinality kernel
    #                     (ops/dense_window.py; name kept from the JAX
    #                     package), falling back per batch to scatter when
    #                     G or the batch's window span exceeds its limits
    #   'auto'          — the same as 'pallas_dense' here, on the card and
    #                     on the CPU (the JAX package's rule for a
    #                     co-located GPU)
    #   'partial_merge' — reduce each batch on the host (native
    #                     partial_agg.cpp, f64) into a stripe of partials
    #                     and fold the stripe into the ring with one launch
    #                     of the merge kernel (ops/merge_partials.py)
    device_strategy: str = "auto"
    # partial_merge pacing: merge the host stripe after this many rows even
    # if no window closed, and defer emission up to emit_lag_ms after a
    # window becomes closable, so replay-speed runs close several windows
    # per merge.  None = 0 on the CPU, 200 ms on the card
    partial_merge_rows: int = 4_000_000
    emit_lag_ms: int | None = None
    # partial_merge: run backend.accumulate (the native stripe reduction,
    # which releases the interpreter lock) on a worker thread, so batch N's
    # reduction overlaps batch N+1's eval/intern; the worker launches any
    # merge on the operator's CUDA stream
    host_pipeline: bool = False
    # the ring's float type: torch.float32 (the default) or torch.float64
    # (sums, min and max in f64; row shipping then takes the scatter path,
    # the dense kernel being f32 only, and partial_merge the merge kernel's
    # f64 instantiation).  No x64 switch is needed, as torch has f64
    accum_dtype: torch.dtype = torch.float32
    # device-side emission compaction: each closed window is read alone,
    # its active groups moved to the front on the device
    # (csrc/compact_slot.cu), and only a power-of-two prefix covering them
    # crosses to the host instead of every group of the ring; turns
    # device_finalize off
    emission_compaction: bool = False
    # compensated (hi, lo) f32 sums: each batch (scatter path) or each
    # merge (partial_merge) folds into the pair by an exact TwoSum; the
    # dense kernel does not take such a spec (it falls back to scatter)
    compensated_sums: bool = False
    # stream-stream joins: retained rows match while within this much event
    # time of the joint watermark, then evict (outer joins emit them
    # unmatched)
    join_retention_ms: int = 300_000
    # closed-loop skew adaptation (obs/doctor/actions.py): a key whose
    # sketched share crosses the skewed-join-side thresholds moves into a
    # dense hot sub-partition, and folds back on decay.  Emissions are
    # identical either way — a layout, not a semantics switch
    join_adaptive: bool = True
    join_adapt_interval_s: float = 1.0
    # band-aware eviction for banded (interval) joins: a retained row whose
    # band value lies more than this slack below the OTHER side's band
    # watermark (the max over its batches of the min band value) can never
    # match a future row, so its batch evicts ahead of retention.  The slack
    # absorbs band-space lateness as allowed lateness absorbs event-time
    # lateness: 0 is exact for band values in order on each side.  None
    # (the default) keeps retention-only eviction
    join_band_slack_ms: int | None = None
    # per-partition watermarks: the source-level watermark is the MIN over
    # each partition's own max-of-batch-min-ts, so one fast-draining
    # partition cannot race the watermark ahead and drop the slower
    # partitions' backlog as late (replay skew; the reference's global
    # max-of-min rule shares this flaw).  'auto' (default) enables it for
    # bounded sources of several partitions (a finished partition leaves
    # the min); True forces it on, False keeps the max-of-min rule
    partition_watermarks: bool | str = "auto"
    # idle sources: when EVERY partition of a live source has produced no
    # rows for this long, emit a WatermarkHint advancing event time to the
    # max timestamp seen, so windows over a quiet topic still close (the
    # last partial window stays open: event time moves only to the max
    # seen).  None (default) = reference behavior: the last windows of a
    # quiet stream wait for more data forever.  With it set, 'auto'
    # partition watermarks also cover live sources of several partitions
    # (quiet partitions leave the min instead of stalling it)
    source_idle_timeout_ms: int | None = None
    min_batch_bucket: int = 256
    min_group_capacity: int = 128
    min_window_slots: int = 16
    # end of a bounded stream: flush every window (and session) still
    # open; False emits only what the watermark closed
    emit_on_close: bool = True
    # on-device finalization: emission ships the FINAL output columns
    # (count/sum/min/max/avg) plus the active-group mask instead of the raw
    # component planes
    device_finalize: bool = True

    # -- observability (obs/, the JAX package's defaults) -----------------
    # typed registry instruments across every layer (per-operator batch
    # time and rows, watermark and emission lag, Kafka consumer lag,
    # prefetch depth, checkpoint and LSM timings).  False binds every
    # handle to the shared falsy no-op NULL: the hot paths do nothing
    metrics_enabled: bool = True
    # Prometheus text exposition on a stdlib HTTP server (127.0.0.1); 0 =
    # an ephemeral port (ctx._last_exporters.prometheus.port), None = off.
    # The server also mounts the doctor's /queries surface
    prometheus_port: int | None = None
    # periodic JSONL registry snapshots; None = off
    metrics_jsonl_path: str | None = None
    metrics_jsonl_interval_s: float = 1.0
    # Chrome trace-event JSON (Perfetto) dumped at the end of the job from
    # the ring-buffered span recorder; None = off.  trace_events sizes the
    # ring (newest events win; 0 = 65536)
    trace_path: str | None = None
    trace_events: int = 0
    # the pipeline doctor (obs/doctor): every job registers its physical
    # plan with per-operator busy and input-wait time and a ranked
    # bottleneck attribution (/queries, explain(analyze=True)); False
    # opts a job out
    doctor_enabled: bool = True
    # sampled record lineage: tag every Nth row of each partition at
    # ingest with (source, partition, offset, event time) and follow it
    # into window emission (/queries/<id>/lineage).  None = off
    lineage_sample_every: int | None = None
    lineage_max_samples: int = 256
    # the on-demand sampling profiler's rate (started over HTTP or by
    # QueryHandle.start_profiler())
    profiler_hz: float = 100.0

    # -- the multi-query engine (docs/multi_query.md) ---------------------
    # slice-folding window path: tumbling/sliding windows with foldable
    # aggregates run on SliceWindowExec — per-(group, slide-unit) partials
    # accumulated once per batch on the HOST in float64, windows folded
    # from slice partials instead of scattering each row into every
    # overlapping window on the card.  The multi-query runtime
    # (runtime/multi_query.py) always uses it; True here also applies it
    # to single queries planned through the normal executor.  Default
    # False: the device ring stays the single-query default (slice folds
    # are f64, so emitted floats can differ from the f32 ring in the last
    # bits)
    slice_windows: bool = False
    # explicit slice width for the slice path (must divide the window's
    # length AND slide; None = their gcd).  The fold grouping is part of a
    # query's numeric contract — f64 sums round per fold tree — so an
    # independent oracle compared byte for byte against a shared group
    # pins the group's gcd unit here
    slice_unit_ms: int | None = None
    # pin the slice store's lexsort accumulation lane (add-only component
    # sets otherwise take the bincount lane, which associates long-segment
    # adds differently).  A shared group whose aggregate UNION carries
    # min/max always sorts, so an add-only member's byte-identity oracle
    # sets this True to match
    slice_sort_lane: bool = False
    # approximate aggregates (approx_distinct / approx_top_k /
    # approx_percentile_cont / approx_median) as first-class sketch planes
    # on the slice path — constant state per group whatever the value
    # cardinality (ops/sketches.py).  Only with slice_windows=True; False
    # lowers them to their exact accumulator UDAFs everywhere
    approx_native: bool = True
    # predicate-subsumption sharing in the multi-query runtime: a query
    # whose filter is provably implied by another's joins that query's
    # share group, ingesting once under the weakest member predicate with
    # a residual re-filter per stronger member (planner/predicates.py).
    # False keeps exact-signature matching only
    mq_subsumption: bool = True

    def resolved_device(self) -> torch.device:
        """The device the engine runs on; raises when CUDA is asked for and
        absent (the package never falls back to the CPU on its own)."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise PlanError(
                f"EngineConfig.device={self.device!r} but no CUDA device is "
                "available (torch.cuda.is_available() is False); pass "
                "EngineConfig(device='cpu') to run on the CPU"
            )
        if dev.type not in ("cuda", "cpu"):
            raise PlanError(f"unsupported device {self.device!r}")
        return dev

    def set(self, key: str, value) -> "EngineConfig":
        """String-keyed setter, the reference's SessionConfig::set spelling
        (``denormalized_config.checkpoint``): the prefix is optional; an
        unknown key raises :class:`PlanError`."""
        k = key.removeprefix("denormalized_config.")
        if not hasattr(self, k):
            raise PlanError(f"unknown config key {key!r}")
        setattr(self, k, value)
        return self


class Context:
    """Session factory: registers sources, builds streams."""

    def __init__(self, config: EngineConfig | None = None) -> None:
        self.config = config or EngineConfig()
        self.device = self.config.resolved_device()
        self._tables: dict[str, Source] = {}
        # set by the executor when a job starts
        self._checkpointing: tuple = (None, None)
        # the last job's SpillController (None without a budgeted tier);
        # spill_stats(node_id) reads a node's spill and reload counts
        self._last_spill = None
        # the last job's running exporters (None when none opted in) and
        # its doctor handle (None with doctor_enabled=False)
        self._last_exporters = None
        self._last_doctor = None

    def __repr__(self) -> str:
        return (
            f"Context(tables=[{', '.join(sorted(self._tables))}], "
            f"device={self.device})"
        )

    def __str__(self) -> str:
        return self.__repr__()

    def with_state_backend(self, path: str) -> "Context":
        """Checkpoint to the LSM store at ``path`` (turns checkpointing
        on; a restart on the same path restores the committed epoch)."""
        self.config.state_backend_path = path
        self.config.checkpoint = True
        return self

    def last_checkpointing(self) -> tuple:
        """The checkpoint coordinator and barrier orchestrator of the last
        job this context started → ``(coordinator, orchestrator)``, both
        None when checkpointing was off.  ``coordinator.committed_epoch``
        and ``coordinator.restored_epoch`` read its epochs;
        ``orchestrator.trigger_now()`` forces a barrier while it runs."""
        return self._checkpointing

    def register_source(self, name: str, source: Source) -> None:
        self._tables[name] = source

    def from_source(self, source: Source, name: str | None = None):
        from denormalized_tpu_torch.api.data_stream import DataStream

        name = name or source.name
        self.register_source(name, source)
        return DataStream(lp.Scan(name, source, source.schema), self)

    def from_topic(
        self,
        topic: str,
        sample_json: str | None = None,
        bootstrap_servers: str = "localhost:9092",
        timestamp_column: str | None = None,
        group_id: str = "denormalized-tpu",
        encoding: str = "json",
        schema=None,
        avro_schema=None,
        timestamp_unit: str | None = None,
    ):
        """Kafka source entry point (PyContext::from_topic): the schema is
        an explicit Schema or inferred from ``sample_json``.  The
        parameter ORDER is the reference wrapper's (topic, sample_json,
        bootstrap_servers, timestamp_column, group_id), so a positional
        ``from_topic("t", sample, server, "occurred_at_ms")`` binds the
        timestamp column.  For ``encoding="avro"`` the schema derives from
        ``avro_schema`` (an Avro record declaration, JSON text or dict)."""
        from denormalized_tpu_torch.sources.kafka import KafkaTopicBuilder

        builder = (
            KafkaTopicBuilder(bootstrap_servers)
            .with_topic(topic)
            .with_encoding(encoding)
            .with_group_id(group_id)
        )
        if timestamp_column:
            builder = builder.with_timestamp_column(timestamp_column)
        if timestamp_unit:
            builder = builder.with_timestamp_unit(timestamp_unit)
        if avro_schema is not None:
            # conflicting arguments are errors, not silent overrides
            if schema is not None:
                raise PlanError(
                    "pass either schema= or avro_schema=, not both (the "
                    "Avro declaration defines the schema)"
                )
            if encoding.lower() != "avro":
                raise PlanError(
                    f"avro_schema= conflicts with encoding={encoding!r}"
                )
            builder = builder.with_avro_schema(avro_schema)
        elif schema is not None:
            builder = builder.with_schema(schema)
        elif sample_json is not None:
            builder = builder.infer_schema_from_json(sample_json)
        return self.from_source(builder.build_reader(), name=topic)

    def table(self, name: str) -> Source:
        """The source registered under ``name``."""
        if name not in self._tables:
            raise PlanError(f"unknown table {name!r}")
        return self._tables[name]
