"""The port's multichip dry run — the twin of ``dryrun_multichip`` in the
repo's ``__graft_entry__.py``: one streaming job through every sharded
layout over an ``n_devices``-shard mesh on ``device``, each held value for
value against the single-device golden.

The feed is 4 batches of ``64·n_devices`` rows over 37 keys with
quarter-integer readings in [0, 32): every per-group sum and shifted
second moment is exact in float32, so a difference from the golden is a
fault of the layout's merge, not float noise.  Counts, minima and maxima
must match exactly, averages and standard deviations to a relative 1e-9.
The layouts are ``key_sharded``, ``partial_final`` (with compensated
sums), ``partial_merge`` (the key-sharded partial merge) and, for an even
``n_devices`` of at least 4, ``two_level`` on 2 slices.

Run it with ``python -m denormalized_tpu_torch.testing.multichip [n]
[device]`` (defaults 4 and ``cuda:0``: every shard on the one card).
"""

from __future__ import annotations

import numpy as np

from denormalized_tpu_torch import Context, EngineConfig, col
from denormalized_tpu_torch.api import functions as F
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec
from denormalized_tpu_torch.sources.memory import MemorySource

FIELDS = ("cnt", "mn", "mx", "avg", "sd")


def dryrun_batches(n_devices: int) -> list[RecordBatch]:
    """The dry run's seeded feed."""
    schema = Schema([
        Field("occurred_at_ms", DataType.INT64, nullable=False),
        Field("sensor_name", DataType.STRING, nullable=False),
        Field("reading", DataType.FLOAT64),
    ])
    rng = np.random.default_rng(0)
    t0 = 1_700_000_000_000
    batches = []
    for b in range(4):
        n = 64 * n_devices
        ts = np.sort(t0 + b * 700 + rng.integers(0, 700, n))
        batches.append(RecordBatch(schema, [
            ts,
            rng.choice([f"s{i}" for i in range(37)], n).astype(object),
            rng.integers(0, 128, n) / 4.0,
        ]))
    return batches


def dryrun_layouts(n_devices: int) -> list[str]:
    layouts = ["key_sharded", "partial_final", "partial_merge"]
    if n_devices % 2 == 0 and n_devices >= 4:
        layouts.append("two_level")
    return layouts


def layout_config(strategy: str, n_devices: int, device: str) -> EngineConfig:
    """The engine config the dry run gives ``strategy``."""
    return EngineConfig(
        device=device,
        mesh_devices=n_devices,
        mesh_slices=2 if strategy == "two_level" else None,
        shard_strategy="key_sharded" if strategy == "partial_merge" else strategy,
        device_strategy=(
            "partial_merge" if strategy == "partial_merge" else "scatter"
        ),
        compensated_sums=(strategy == "partial_final"),
    )


def run_pipeline(cfg: EngineConfig, batches, name: str):
    """→ (the result batch, {(window start, key): (cnt, mn, mx, avg, sd)},
    the window operator's backend)."""
    ctx = Context(cfg)
    res = ctx.from_source(
        MemorySource.from_batches(batches, timestamp_column="occurred_at_ms"),
        name=name,
    ).window(
        ["sensor_name"],
        [
            F.count(col("reading")).alias("cnt"),
            F.min(col("reading")).alias("mn"),
            F.max(col("reading")).alias("mx"),
            F.avg(col("reading")).alias("avg"),
            F.stddev(col("reading")).alias("sd"),
        ],
        1000,
    ).collect()
    op = ctx._last_physical
    while not isinstance(op, StreamingWindowExec):
        op = op.children[0]
    rows = {}
    for i in range(res.num_rows):
        k = (int(res.column("window_start_time")[i]),
             str(res.column("sensor_name")[i]))
        rows[k] = tuple(float(res.column(c)[i]) for c in FIELDS)
    return res, rows, op.backend


def assert_value_parity(strategy: str, rows: dict, golden: dict) -> None:
    assert rows.keys() == golden.keys(), (
        f"{strategy}: window/key set diverges from the single-device golden "
        f"(missing {list(golden.keys() - rows.keys())[:3]}, extra "
        f"{list(rows.keys() - golden.keys())[:3]})"
    )
    for k, want in golden.items():
        got = rows[k]
        for j, label in enumerate(("count", "min", "max")):
            assert got[j] == want[j], (
                f"{strategy} {k}: {label} {got[j]} != {want[j]}"
            )
        for label, g, w in (("avg", got[3], want[3]), ("sd", got[4], want[4])):
            if np.isnan(w) and np.isnan(g):
                continue  # single-sample stddev: NaN on every path
            rel = abs(g - w) / max(abs(w), 1e-30)
            assert rel <= 1e-9, (
                f"{strategy} {k}: {label} {g!r} vs golden {w!r} "
                f"(rel {rel:.2e} > 1e-9)"
            )


def dryrun_multichip(n_devices: int, device: str = "cuda:0") -> dict:
    """Every sharded layout over ``n_devices`` shards on ``device`` against
    the single-device golden → {layout: its backend} (per-shard counters
    included).  Raises AssertionError on any difference."""
    batches = dryrun_batches(n_devices)
    _, golden, _ = run_pipeline(EngineConfig(device=device), batches,
                                "dryrun_golden")
    assert golden, "single-device golden emitted no windows"
    expect = sum(b.num_rows for b in batches)
    backends = {}
    for strategy in dryrun_layouts(n_devices):
        res, rows, backend = run_pipeline(
            layout_config(strategy, n_devices, device), batches,
            f"dryrun_{strategy}",
        )
        assert res.num_rows > 0, f"{strategy}: no windows emitted"
        total = sum(int(c) for c in res.column("cnt"))
        assert total == expect, f"{strategy}: {total} != {expect}"
        sds = np.asarray(res.column("sd"), dtype=np.float64)
        assert np.isfinite(sds[np.asarray(res.column("cnt")) > 1]).all(), (
            f"{strategy}: stddev produced non-finite values"
        )
        assert_value_parity(strategy, rows, golden)
        backends[strategy] = backend
    print(f"dryrun_multichip({n_devices}, {device}): all shardings "
          f"value-parity OK vs single-device golden")
    return backends


if __name__ == "__main__":
    import sys

    dryrun_multichip(
        int(sys.argv[1]) if len(sys.argv) > 1 else 4,
        sys.argv[2] if len(sys.argv) > 2 else "cuda:0",
    )
