"""Session context — the framework entry point.

Counterpart of ``denormalized_tpu/api/context.py``: builds the session,
registers sources as named tables and hands out :class:`DataStream`
builders.  :class:`EngineConfig` carries the knobs the ported window path
reads, plus an explicit ``device``: the device rule of the whole package,
and the checkpoint knobs (``checkpoint``, ``checkpoint_interval_s``,
``state_backend_path``, or :meth:`Context.with_state_backend`) and the
join knobs (``join_retention_ms``, ``join_adaptive``,
``join_adapt_interval_s``, ``join_band_slack_ms``),
``partition_watermarks`` and ``source_idle_timeout_ms``.
:meth:`Context.from_topic` reads a Kafka topic (JSON payloads).
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
    # checkpointing (denormalized_config.checkpoint): barriers every
    # checkpoint_interval_s (orchestrator.rs:58), snapshots in the LSM
    # store at state_backend_path
    checkpoint: bool = False
    checkpoint_interval_s: float = 10.0
    state_backend_path: str | None = None
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
    # on-device finalization: emission ships the FINAL output columns
    # (count/sum/min/max/avg) plus the active-group mask instead of the raw
    # component planes
    device_finalize: bool = True

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


class Context:
    """Session factory: registers sources, builds streams."""

    def __init__(self, config: EngineConfig | None = None) -> None:
        self.config = config or EngineConfig()
        self.device = self.config.resolved_device()
        self._tables: dict[str, Source] = {}
        # set by the executor when a job starts
        self._checkpointing: tuple = (None, None)

    def __repr__(self) -> str:
        return (
            f"Context(tables=[{', '.join(sorted(self._tables))}], "
            f"device={self.device})"
        )

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
        timestamp column.  Avro (``encoding="avro"``/``avro_schema=``)
        raises: it is not ported yet."""
        from denormalized_tpu_torch.formats import unported_avro
        from denormalized_tpu_torch.sources.kafka import KafkaTopicBuilder

        if avro_schema is not None or encoding.lower() == "avro":
            raise unported_avro()
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
        if schema is not None:
            builder = builder.with_schema(schema)
        elif sample_json is not None:
            builder = builder.infer_schema_from_json(sample_json)
        return self.from_source(builder.build_reader(), name=topic)
