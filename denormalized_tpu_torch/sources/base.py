"""Source connector abstraction.

Mirror of the reference's source seam: a ``TableProvider`` whose scan yields
one ``PartitionStream`` per Kafka partition (topic_reader.rs:25-80,
stream_table.rs:57-65).  A :class:`Source` describes schema + partitioning;
each :class:`PartitionReader` is an independent cursor that the source exec
drives (on threads for live connectors).

Counterpart of ``denormalized_tpu/sources/base.py``.

Every source attaches the canonical event-time column
(``CANONICAL_TIMESTAMP_COLUMN``) exactly like the reference's
``KafkaStreamRead`` attaches ``canonical_timestamp`` from either the broker
timestamp or a designated payload column (kafka_stream_read.rs:222-266).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.common.errors import SourceError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema

# timestamp_unit spellings → canonical unit (kafka_config.rs:42 declares
# the event-time column's unit; without it a seconds- or
# microseconds-resolution topic silently mis-windows by 1000x)
_TS_UNITS = {
    "s": "s", "sec": "s", "second": "s", "seconds": "s",
    "ms": "ms", "millisecond": "ms", "milliseconds": "ms",
    "us": "us", "microsecond": "us", "microseconds": "us",
    "ns": "ns", "nanosecond": "ns", "nanoseconds": "ns",
}


def validate_ts_unit(unit: str | None) -> str:
    """Canonicalize a timestamp_unit spelling; raise loudly at BUILD time
    for unsupported units (not per-batch, deep in the read loop)."""
    canon = _TS_UNITS.get((unit or "ms").strip().lower())
    if canon is None:
        raise SourceError(
            f"unsupported timestamp_unit {unit!r}; expected one of "
            "s / ms / us / ns"
        )
    return canon


def normalize_ts_to_ms(col, unit: str | None):
    """Event-time column → canonical epoch-milliseconds int64.  Float
    columns scale before truncation (a float-seconds column must not lose
    its sub-second part)."""
    unit = validate_ts_unit(unit)
    if unit == "ms":
        return np.asarray(col, dtype=np.int64)
    a = np.asarray(col)
    if unit == "s":
        if a.dtype.kind == "f":
            return np.round(a * 1000.0).astype(np.int64)
        return a.astype(np.int64, copy=False) * 1000
    div = 1000 if unit == "us" else 1_000_000
    if a.dtype.kind == "f":
        return np.round(a / div).astype(np.int64)
    return a.astype(np.int64, copy=False) // div


def canonicalize_schema(user_schema: Schema) -> Schema:
    """User schema + internal event-time column (the reference's
    ``create_canonical_schema``, kafka_config.rs:186-214)."""
    if user_schema.has(CANONICAL_TIMESTAMP_COLUMN):
        return user_schema
    return user_schema.append(
        Field(CANONICAL_TIMESTAMP_COLUMN, DataType.TIMESTAMP_MS, nullable=False)
    )


def attach_canonical_timestamp(
    batch: RecordBatch,
    timestamp_column: str | None,
    fallback_ms: int,
    timestamp_unit: str | None = "ms",
) -> RecordBatch:
    """Attach event time: from ``timestamp_column`` when configured
    (normalized from ``timestamp_unit`` to epoch-ms), else the ingestion
    time (the Kafka-broker-timestamp analog, always ms)."""
    if batch.schema.has(CANONICAL_TIMESTAMP_COLUMN):
        return batch
    if timestamp_column is not None:
        ts = normalize_ts_to_ms(batch.column(timestamp_column), timestamp_unit)
    else:
        ts = np.full(batch.num_rows, fallback_ms, dtype=np.int64)
    return batch.with_column(
        Field(CANONICAL_TIMESTAMP_COLUMN, DataType.TIMESTAMP_MS, nullable=False), ts
    )


class PartitionReader:
    """Cursor over one source partition."""

    def read(self, timeout_s: float | None = None) -> Optional[RecordBatch]:
        """Next batch, or None when the partition is exhausted (bounded
        sources) / the timeout elapsed (live sources return empty batches)."""
        raise NotImplementedError

    # -- checkpoint hooks (reference BatchReadMetadata offsets,
    # kafka_stream_read.rs:49-65,275-289) -------------------------------
    def offset_snapshot(self) -> dict:
        return {}

    def offset_restore(self, snap: dict) -> None:
        pass

    # -- optional decode-path observability ------------------------------
    def decode_fallback_rows(self) -> int:
        """Rows this reader decoded through a pure-Python fallback path
        (native parser unavailable, or the schema has a shape the native
        shredder declines).  Aggregated into ``SourceExec.metrics()`` so
        a topic silently riding the slower decode path is visible — 0 for
        readers with no payload decode stage (memory)."""
        return 0

    # -- optional backlog report ----------------------------------------
    def caught_up(self) -> bool | None:
        """Does this reader KNOW whether more data is already waiting at
        the source?  ``False`` = yes, backlog exists (the prefetch
        engine then never judges the partition idle, even mid-fetch);
        ``True`` = the cursor is at the source's frontier; ``None``
        (default) = no backlog knowledge — idleness falls back to the
        wall-clock-since-last-rows judgment."""
        return None


class Source:
    name: str = "source"

    @property
    def schema(self) -> Schema:
        """Canonical schema (includes internal timestamp column)."""
        raise NotImplementedError

    def partitions(self) -> list[PartitionReader]:
        raise NotImplementedError

    def partition_factories(self) -> "list | None":
        """Optional per-partition reader factories for the prefetch
        supervisor: element ``i`` is a zero-arg callable rebuilding
        partition ``i``'s reader after its worker crashed (the supervisor
        then seeks the fresh reader to the last enqueued offset snapshot
        via ``offset_restore``).  ``None`` (default) disables supervised
        restarts for this source — a worker crash surfaces as a query
        error."""
        return None

    @property
    def unbounded(self) -> bool:
        return True

    def with_projection(self, names: set[str]) -> "Source | None":
        """Reader-level projection pushdown: return a copy of this source
        that only DECODES the named columns, or None when unsupported (the
        optimizer then projects above the Scan).  Implementations retain
        their timestamp column regardless of ``names``."""
        return None
