"""Packaged cluster job factories: the cluster_scale shape (int64 keys)
and the soak shape (string keys).

Counterpart of ``denormalized_tpu/cluster/benchjob.py``, with the same
feeds.  Worker processes import this by name
("denormalized_tpu_torch.cluster.benchjob:<factory>"), so the factories
must rebuild the identical deterministic source from job_args alone — the
same contract as the test jobs (tests/torch_cluster_jobs.py).  A job's
``engine`` overrides (``job_args["engine"]``) reach every worker and the
single-process oracle alike.

The bench job uses int64 keys (vectorized hash lane, no per-row
Python); the soak job uses string keys (the crc32 lane) and
integer-valued readings so every aggregate is exact in f32
accumulators regardless of exchange arrival order — the property the
exactly-once comparison needs (docs/cluster.md#determinism).
"""

from __future__ import annotations

import time

import numpy as np

from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.sources.base import (
    PartitionReader,
    Source,
    attach_canonical_timestamp,
    canonicalize_schema,
)

T0 = 1_700_000_000_000

BENCH_SCHEMA = Schema([
    Field("k", DataType.INT64, nullable=False),
    Field("v", DataType.FLOAT64, nullable=False),
    Field("ts", DataType.TIMESTAMP_MS, nullable=False),
])

SOAK_SCHEMA = Schema([
    Field("k", DataType.STRING, nullable=False),
    Field("v", DataType.FLOAT64, nullable=False),
    Field("ts", DataType.TIMESTAMP_MS, nullable=False),
])


class _SynthReader(PartitionReader):
    """Deterministic batch generator: in-order timestamps, keys spread
    over the key space, integer readings.  Seekable (pos-based) so
    checkpoint restore replays exactly."""

    def __init__(self, part: int, args: dict, string_keys: bool) -> None:
        self.part = part
        self.args = args
        self.string_keys = string_keys
        self._pos = 0
        self._n = int(args.get("batches", 50))
        self._pace_s = float(args.get("pace_s", 0.0))

    def _batch(self, b: int) -> RecordBatch:
        a = self.args
        rows = int(a.get("rows", 8192))
        keys = int(a.get("keys", 1024))
        span = int(a.get("batch_span_ms", 250))
        base = T0 + b * span
        i = np.arange(rows, dtype=np.int64)
        ts = base + (i * span) // rows
        kid = (i * 7 + self.part * 3 + b) % keys
        v = ((i + self.part + b) % 16).astype(np.float64)
        if self.string_keys:
            k = np.array([f"s{x:05d}" for x in kid], dtype=object)
        else:
            k = kid
        schema = SOAK_SCHEMA if self.string_keys else BENCH_SCHEMA
        return RecordBatch(schema, [k, v, ts])

    def read(self, timeout_s=None):
        if self._pos >= self._n:
            return None
        if self._pace_s:
            time.sleep(self._pace_s)
        b = self._batch(self._pos)
        self._pos += 1
        return attach_canonical_timestamp(b, "ts", fallback_ms=0)

    def offset_snapshot(self) -> dict:
        return {"pos": self._pos}

    def offset_restore(self, snap: dict) -> None:
        self._pos = int(snap.get("pos", 0))


class SynthSource(Source):
    def __init__(self, args: dict, string_keys: bool) -> None:
        self._args = dict(args)
        self._string_keys = string_keys
        self.name = "cluster_bench" if not string_keys else "cluster_soak"
        self._schema = canonicalize_schema(
            SOAK_SCHEMA if string_keys else BENCH_SCHEMA
        )

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def unbounded(self) -> bool:
        return False

    def partitions(self) -> list[PartitionReader]:
        return [
            _SynthReader(p, self._args, self._string_keys)
            for p in range(int(self._args.get("partitions", 4)))
        ]


def _pipeline(ds, args: dict):
    from denormalized_tpu_torch import col
    from denormalized_tpu_torch.api import functions as F

    return ds.window(
        [col("k")],
        [
            F.count(col("v")).alias("count"),
            F.sum(col("v")).alias("total"),
            F.min(col("v")).alias("lo"),
            F.max(col("v")).alias("hi"),
        ],
        int(args.get("window_ms", 1000)),
    )


def bench_job(args: dict) -> dict:
    return {
        "source": SynthSource(args, string_keys=False),
        "pipeline": lambda ds: _pipeline(ds, args),
        "engine": args.get("engine") or {},
    }


def soak_job(args: dict) -> dict:
    return {
        "source": SynthSource(args, string_keys=True),
        "pipeline": lambda ds: _pipeline(ds, args),
        "engine": args.get("engine") or {},
    }


def oracle_rows(args: dict, string_keys: bool) -> list[tuple]:
    """Uninterrupted single-process oracle → canonical sorted tuples."""
    from denormalized_tpu_torch.api.context import Context, EngineConfig
    from denormalized_tpu_torch.common.constants import (
        WINDOW_END_COLUMN,
        WINDOW_START_COLUMN,
    )

    config = EngineConfig()
    for k, v in (args.get("engine") or {}).items():
        config.set(k, v)
    config.partition_watermarks = True
    ctx = Context(config)
    src = SynthSource(args, string_keys=string_keys)
    got = _pipeline(ctx.from_source(src), args).collect()
    out = []
    for i in range(got.num_rows):
        out.append((
            int(got.column(WINDOW_START_COLUMN)[i]),
            int(got.column(WINDOW_END_COLUMN)[i]),
            str(got.column("k")[i]),
            int(got.column("count")[i]),
            float(got.column("total")[i]),
            float(got.column("lo")[i]),
            float(got.column("hi")[i]),
        ))
    return sorted(out)


def canonical_row(rec: dict) -> tuple:
    from denormalized_tpu_torch.common.constants import (
        WINDOW_END_COLUMN,
        WINDOW_START_COLUMN,
    )

    return (
        int(rec[WINDOW_START_COLUMN]),
        int(rec[WINDOW_END_COLUMN]),
        str(rec["k"]),
        int(rec["count"]),
        float(rec["total"]),
        float(rec["lo"]),
        float(rec["hi"]),
    )
