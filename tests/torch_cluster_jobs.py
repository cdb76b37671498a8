"""Job factories for the port's cluster tests: the counterpart of
``tests/cluster_jobs.py`` over ``denormalized_tpu_torch``, with the same
feed, so a port cluster and a JAX cluster run the same seeded job.

Imported BY PORT WORKER PROCESSES via ClusterSpec.job
("torch_cluster_jobs:<fn>" with sys_path pointing at tests/), so it
imports nothing of the JAX package (a worker's modules stay clean) and
everything here is module-level and deterministic from job_args alone.
A job's ``engine`` overrides come from ``job_args["engine"]``; the CPU
tests pass ``{"device": "cpu"}`` there.

Values are small integers (stored in float64 columns) so every
aggregate (count/sum/min/max/avg) is EXACT in the engine's f32
accumulators regardless of exchange arrival order."""

from __future__ import annotations

import atexit
import json
import os
import sys
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

SCHEMA = Schema([
    Field("k", DataType.STRING, nullable=False),
    Field("v", DataType.FLOAT64, nullable=False),
    Field("ts", DataType.TIMESTAMP_MS, nullable=False),
])


def partition_arrays(part: int, args: dict):
    """Deterministic batches for one partition: in-order timestamps,
    string keys spread over the key space, integer-valued readings.

    With ``skew_divisor`` set, partition 0's event time advances that
    many times slower — its early windows stay open (the min-watermark
    stalls on it), so a small ``state_budget_bytes`` forces the window
    tier to spill the deferred prefix (the skew-span case), which
    is how the spilled-rescale test gets spilled state AT the cut."""
    n_batches = int(args.get("batches", 12))
    rows = int(args.get("rows", 64))
    keys = int(args.get("keys", 13))
    span_ms = int(args.get("batch_span_ms", 250))
    skew_div = int(args.get("skew_divisor", 1) or 1)
    out = []
    for b in range(n_batches):
        base = T0 + b * span_ms
        if part == 0 and skew_div > 1:
            base = T0 + (b * span_ms) // skew_div
        i = np.arange(rows, dtype=np.int64)
        ts = base + (i * span_ms) // rows
        kid = (i * 7 + part * 3 + b) % keys
        k = np.array([f"s{x:04d}" for x in kid], dtype=object)
        v = ((i + part + b) % 16).astype(np.float64)
        out.append((ts, k, v))
    return out


class _PacedReader(PartitionReader):
    def __init__(self, part: int, args: dict) -> None:
        self._arrays = partition_arrays(part, args)
        self._pos = 0
        self._pace_s = float(args.get("pace_s", 0.0))
        if part == 0 and args.get("pace_skew_s") is not None:
            self._pace_s = float(args["pace_skew_s"])
        # optional mid-stream silence for partition 0: batches keep
        # NOT arriving while its watermark contribution pins the min —
        # the spill test's way of holding a deferred window prefix cold
        # (and untouched) across several barriers
        self._pause_after = (
            int(args["p0_pause_after"])
            if part == 0 and args.get("p0_pause_after") is not None
            else None
        )
        self._pause_s = float(args.get("p0_pause_s", 0.0))

    def read(self, timeout_s=None):
        if self._pos >= len(self._arrays):
            return None
        if self._pause_after is not None and self._pos == self._pause_after:
            self._pause_after = None  # once, not on replay re-reads
            time.sleep(self._pause_s)
        if self._pace_s:
            time.sleep(self._pace_s)
        ts, k, v = self._arrays[self._pos]
        self._pos += 1
        batch = RecordBatch(SCHEMA, [k, v, ts.astype(np.int64)])
        return attach_canonical_timestamp(batch, "ts", fallback_ms=0)

    def offset_snapshot(self) -> dict:
        return {"pos": self._pos}

    def offset_restore(self, snap: dict) -> None:
        self._pos = int(snap.get("pos", 0))


class PacedMemorySource(Source):
    """Replayable, seekable, optionally paced synthetic source."""

    def __init__(self, args: dict) -> None:
        self._args = dict(args)
        self.name = "cluster_synth"
        self._schema = canonicalize_schema(SCHEMA)

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def unbounded(self) -> bool:
        # "unbounded" routes multi-partition workers through the
        # threaded prefetch pump (barrier polls stay responsive while a
        # slow reader sleeps); the readers still finish, and the pump
        # converts all-readers-done into EOS
        return bool(self._args.get("unbounded", False))

    def partitions(self) -> list[PartitionReader]:
        return [
            _PacedReader(p, self._args)
            for p in range(int(self._args.get("partitions", 4)))
        ]


def make_source(args: dict) -> PacedMemorySource:
    return PacedMemorySource(args)


def apply_pipeline(ds, args: dict):
    from denormalized_tpu_torch import col
    from denormalized_tpu_torch.api import functions as F

    return ds.window(
        [col("k")],
        [
            F.count(col("v")).alias("count"),
            F.sum(col("v")).alias("total"),
            F.min(col("v")).alias("lo"),
            F.max(col("v")).alias("hi"),
            F.avg(col("v")).alias("mean"),
        ],
        int(args.get("window_ms", 1000)),
    )


def windowed_job(args: dict) -> dict:
    return {
        "source": make_source(args),
        "pipeline": lambda ds: apply_pipeline(ds, args),
        "engine": args.get("engine") or {},
    }


def oracle_rows(args: dict) -> list[tuple]:
    """Single-process oracle: run the identical query in-process and
    return canonical row tuples (sorted)."""
    from denormalized_tpu_torch.api.context import Context, EngineConfig
    from denormalized_tpu_torch.common.constants import (
        WINDOW_END_COLUMN,
        WINDOW_START_COLUMN,
    )

    config = EngineConfig()
    for k, v in (args.get("engine") or {}).items():
        # oracle ignores cluster-only knobs that need a store
        if k in ("state_budget_bytes",):
            continue
        config.set(k, v)
    config.partition_watermarks = True
    ctx = Context(config)
    ds = apply_pipeline(ctx.from_source(make_source(args)), args)
    got = ds.collect()
    rows = []
    for i in range(got.num_rows):
        rows.append(canonical_row({
            "k": str(got.column("k")[i]),
            "count": int(got.column("count")[i]),
            "total": float(got.column("total")[i]),
            "lo": float(got.column("lo")[i]),
            "hi": float(got.column("hi")[i]),
            "mean": float(got.column("mean")[i]),
            WINDOW_START_COLUMN: int(got.column(WINDOW_START_COLUMN)[i]),
            WINDOW_END_COLUMN: int(got.column(WINDOW_END_COLUMN)[i]),
        }))
    return sorted(rows)


def canonical_row(rec: dict) -> tuple:
    """One emission row → canonical comparable tuple (drops the epoch
    tag; field order fixed)."""
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
        float(rec["mean"]),
    )


def numpy_oracle(args: dict) -> list[tuple]:
    """The job's windows computed straight from ``partition_arrays`` with
    numpy: every row of every partition lands in its tumbling window (the
    feed has no late rows under partition watermarks) → canonical sorted
    tuples (``mean`` as an f32 quotient; compare it with
    :func:`assert_rows_match`, as windows flushed at the end of the
    stream average in f64)."""
    from denormalized_tpu_torch.common.constants import (
        WINDOW_END_COLUMN,
        WINDOW_START_COLUMN,
    )

    length = int(args.get("window_ms", 1000))
    ts, keys, vals = [], [], []
    for p in range(int(args.get("partitions", 4))):
        for t, k, v in partition_arrays(p, args):
            ts.append(t)
            keys.append(k)
            vals.append(v)
    ts = np.concatenate(ts)
    keys = np.concatenate(keys)
    vals = np.concatenate(vals)
    start = ts - ts % length
    names, kid = np.unique(keys.astype(str), return_inverse=True)
    cells = {}
    order = np.lexsort((kid, start))
    cell = np.stack([start[order], kid[order]], axis=1)
    bounds = np.flatnonzero(np.any(np.diff(cell, axis=0) != 0, axis=1)) + 1
    for seg in np.split(order, bounds):
        v = vals[seg]
        total = float(v.sum())
        n = len(seg)
        cells[(int(start[seg[0]]), int(kid[seg[0]]))] = (
            n, total, float(v.min()), float(v.max()),
            float(np.float32(total) / np.float32(n)),
        )
    return sorted(canonical_row({
        WINDOW_START_COLUMN: s0,
        WINDOW_END_COLUMN: s0 + length,
        "k": str(names[k]),
        "count": n, "total": total, "lo": lo, "hi": hi, "mean": mean,
    }) for (s0, k), (n, total, lo, hi, mean) in cells.items())


def _write_module_probe(path: str) -> None:
    bad = sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.") or m == "denormalized_tpu"
        or m.startswith("denormalized_tpu.")
    )
    with open(f"{path}.{os.getpid()}", "w") as f:
        json.dump({"bad": bad, "n_modules": len(sys.modules)}, f)


def isolated_job(args: dict) -> dict:
    """``windowed_job`` that writes, when its worker process exits, the
    jax / JAX-package modules it holds to ``args["probe"]``.<pid>."""
    atexit.register(_write_module_probe, args["probe"])
    return windowed_job(args)


def assert_rows_match(got: list[tuple], want: list[tuple],
                      rtol: float = 1e-6) -> None:
    """Sorted canonical rows equal: window, key, count, sum, min and max
    exactly (integer readings make the f32 sums exact), the mean to
    ``rtol``."""
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert g[:7] == w[:7], (g, w)
        assert abs(g[7] - w[7]) <= rtol * abs(w[7]), (g, w)
