"""In-memory / replay sources.

The deliberate test seam the reference lacks (SURVEY.md §4: its de-facto
integration test is running examples against a live Kafka docker image).  A
:class:`MemorySource` replays pre-built batches deterministically, partitioned
like a Kafka topic.  Counterpart of ``denormalized_tpu/sources/memory.py``
(the generator source is not ported yet).
"""

from __future__ import annotations

import time
from typing import Sequence

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema
from denormalized_tpu_torch.sources.base import (
    PartitionReader,
    Source,
    attach_canonical_timestamp,
    canonicalize_schema,
    validate_ts_unit,
)


class _MemoryPartition(PartitionReader):
    def __init__(
        self,
        batches: Sequence[RecordBatch],
        timestamp_column: str | None,
        timestamp_unit: str = "ms",
    ) -> None:
        self._batches = list(batches)
        self._pos = 0
        self._ts_col = timestamp_column
        self._ts_unit = timestamp_unit

    def read(self, timeout_s: float | None = None):
        while self._pos < len(self._batches):
            b = self._batches[self._pos]
            self._pos += 1
            b = attach_canonical_timestamp(
                b, self._ts_col, fallback_ms=int(time.time() * 1000),
                timestamp_unit=self._ts_unit,
            )
            return b
        return None


class MemorySource(Source):
    """Replayable bounded source over per-partition batch lists."""

    def __init__(
        self,
        partition_batches: Sequence[Sequence[RecordBatch]],
        timestamp_column: str | None = None,
        name: str = "memory",
        timestamp_unit: str = "ms",
    ) -> None:
        if not partition_batches or not any(len(p) for p in partition_batches):
            raise ValueError("MemorySource needs at least one batch")
        self._parts = [list(p) for p in partition_batches]
        self._ts_col = timestamp_column
        self._ts_unit = validate_ts_unit(timestamp_unit)
        self.name = name
        first = next(b for p in self._parts for b in p)
        user_schema = first.schema
        self._schema = canonicalize_schema(user_schema)

    @staticmethod
    def from_batches(
        batches: Sequence[RecordBatch],
        timestamp_column: str | None = None,
        num_partitions: int = 1,
        name: str = "memory",
        timestamp_unit: str = "ms",
    ) -> "MemorySource":
        parts: list[list[RecordBatch]] = [[] for _ in range(num_partitions)]
        for i, b in enumerate(batches):
            parts[i % num_partitions].append(b)
        return MemorySource(parts, timestamp_column, name, timestamp_unit)

    @property
    def schema(self) -> Schema:
        return self._schema

    def partitions(self) -> list[PartitionReader]:
        return [
            _MemoryPartition(p, self._ts_col, self._ts_unit)
            for p in self._parts
        ]

    @property
    def unbounded(self) -> bool:
        return False
