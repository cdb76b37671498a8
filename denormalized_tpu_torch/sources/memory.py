"""In-memory / replay sources.

The deliberate test seam the reference lacks (SURVEY.md §4: its de-facto
integration test is running examples against a live Kafka docker image).  A
:class:`MemorySource` replays pre-built batches deterministically, partitioned
like a Kafka topic; :class:`GeneratorSource` synthesizes load in-process (the
`emit_measurements` analog, examples/examples/emit_measurements.rs:17-84)
without a broker.  Counterpart of ``denormalized_tpu/sources/memory.py``.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Sequence

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

    def offset_snapshot(self) -> dict:
        return {"pos": self._pos}

    def offset_restore(self, snap: dict) -> None:
        self._pos = int(snap.get("pos", 0))


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


class _GeneratorPartition(PartitionReader):
    def __init__(
        self,
        gen: Iterable[RecordBatch],
        timestamp_column: str | None,
        timestamp_unit: str = "ms",
    ) -> None:
        self._it = iter(gen)
        self._ts_col = timestamp_column
        self._ts_unit = timestamp_unit
        self._count = 0

    def read(self, timeout_s: float | None = None):
        try:
            b = next(self._it)
        except StopIteration:
            return None
        self._count += 1
        return attach_canonical_timestamp(
            b, self._ts_col, fallback_ms=int(time.time() * 1000),
            timestamp_unit=self._ts_unit,
        )

    def offset_snapshot(self) -> dict:
        return {"count": self._count}


class GeneratorSource(Source):
    """Synthesized stream: one generator factory per partition."""

    def __init__(
        self,
        user_schema: Schema,
        partition_factories: Sequence[Callable[[], Iterable[RecordBatch]]],
        timestamp_column: str | None = None,
        unbounded: bool = True,
        name: str = "generator",
        timestamp_unit: str = "ms",
    ) -> None:
        self._schema = canonicalize_schema(user_schema)
        self._factories = list(partition_factories)
        self._ts_col = timestamp_column
        self._ts_unit = validate_ts_unit(timestamp_unit)
        self._unbounded = unbounded
        self.name = name

    @property
    def schema(self) -> Schema:
        return self._schema

    def partitions(self) -> list[PartitionReader]:
        return [
            _GeneratorPartition(f(), self._ts_col, self._ts_unit)
            for f in self._factories
        ]

    @property
    def unbounded(self) -> bool:
        return self._unbounded
