"""Helpers shared by the multi-query twins (``tests/test_torch_live_
registration.py``, ``test_torch_shared_join.py``,
``test_torch_multi_query_checkpoint.py``): one namespace per package with
the classes a test builds a shared pipeline from, seeded feeds as raw numpy
columns (each package builds its own batches from them), and row
extraction into dicts keyed by (key, window start, window end).
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.errors import PlanError as JPlanError
from denormalized_tpu.common.errors import StateError as JStateError
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.physical.base import Marker as JMarker
from denormalized_tpu.physical.slice_exec import SubscriberBatch as JSubBatch
from denormalized_tpu.runtime import multi_query as jmq
from denormalized_tpu.runtime import pump as jpump
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu.state import lsm as jlsm
from denormalized_tpu.state.checkpoint import wire_checkpointing as jwire
from denormalized_tpu.state.orchestrator import Orchestrator as JOrch
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.errors import PlanError as TPlanError
from denormalized_tpu_torch.common.errors import StateError as TStateError
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.physical.base import Marker as TMarker
from denormalized_tpu_torch.physical.slice_exec import (
    SubscriberBatch as TSubBatch,
)
from denormalized_tpu_torch.runtime import multi_query as tmq
from denormalized_tpu_torch.runtime import pump as tpump
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state import lsm as tlsm
from denormalized_tpu_torch.state.checkpoint import (
    wire_checkpointing as twire,
)
from denormalized_tpu_torch.state.orchestrator import Orchestrator as TOrch

T0 = 1_700_000_000_000

PKGS = {
    "jax": SimpleNamespace(
        name="jax", col=jt.col, F=JF, Schema=JSchema, Field=JField, DT=JType,
        Batch=JBatch, Source=JSource, mq=jmq, Marker=JMarker,
        SubBatch=JSubBatch, wire=jwire, Orch=JOrch, pump=jpump,
        close=jlsm.close_global_state_backend, PlanError=JPlanError,
        StateError=JStateError,
        ctx=lambda **kw: jt.Context(JConfig(**kw)),
    ),
    "torch": SimpleNamespace(
        name="torch", col=tt.col, F=TF, Schema=TSchema, Field=TField,
        DT=TType, Batch=TBatch, Source=TSource, mq=tmq, Marker=TMarker,
        SubBatch=TSubBatch, wire=twire, Orch=TOrch, pump=tpump,
        close=tlsm.close_global_state_backend, PlanError=TPlanError,
        StateError=TStateError,
        ctx=lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)),
    ),
}


def raw_feed(seed, n_batches=20, rows=300, n_keys=6, ms=1000):
    """(ts, k, v) a batch: sorted event times, keys ``s<i>``, readings
    N(10, 3)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * ms + rng.integers(0, ms, rows))
        ks = np.asarray([f"s{i}" for i in rng.integers(0, n_keys, rows)],
                        object)
        vs = rng.normal(10.0, 3.0, rows)
        out.append((ts, ks, vs))
    return out


def source(p, raw, name="feed"):
    schema = p.Schema([
        p.Field("ts", p.DT.INT64, nullable=False),
        p.Field("k", p.DT.STRING, nullable=False),
        p.Field("v", p.DT.FLOAT64),
    ])
    return p.Source.from_batches(
        [p.Batch(schema, list(cols)) for cols in raw], timestamp_column="ts"
    )


def base_of(p, ctx, raw):
    return ctx.from_source(source(p, raw), name="feed")


def aggs(p, cols=("c", "s", "mn", "mx", "av"), over="v"):
    """count/sum/min/max/avg of ``over`` (no stddev: a residual member's
    variance pivot comes from the shared ingest's first rows, its oracle's
    from its own — the documented exclusion from byte identity)."""
    F, c = p.F, p.col
    make = {
        "c": lambda: F.count(c(over)).alias("c"),
        "s": lambda: F.sum(c(over)).alias("s"),
        "mn": lambda: F.min(c(over)).alias("mn"),
        "mx": lambda: F.max(c(over)).alias("mx"),
        "av": lambda: F.avg(c(over)).alias("av"),
        "sw": lambda: F.sum(c("w")).alias("sw"),
    }
    return [make[n]() for n in cols]


AGG_COLS = ("c", "s", "mn", "mx", "av")


def rows_of(batch, acc, cols=AGG_COLS):
    for i in range(batch.num_rows):
        key = (
            batch.column("k")[i],
            int(batch.column("window_start_time")[i]),
            int(batch.column("window_end_time")[i]),
        )
        vals = []
        for c in cols:
            m = batch.mask(c)
            vals.append(
                None if m is not None and not m[i]
                else float(batch.column(c)[i])
            )
        acc[key] = tuple(vals)


def sink(acc, cols=AGG_COLS):
    lock = threading.Lock()

    def f(b):
        with lock:
            rows_of(b, acc, cols)

    return f


def first_exact_start(sp, tag):
    root = sp.root
    for q, sub in enumerate(root._subs):
        if sub.tag == tag:
            fe = root._first_exact[q]
            assert fe is not None
            return fe * sub.slide_ms
    raise AssertionError(f"tag {tag} not attached")


def sequential_pump(monkeypatch, p):
    """Deterministic join drive: the pump threads enqueue strictly in
    spawn order (all of the left source, then all of the right)."""
    real_put = p.pump.checked_put
    threads: list[threading.Thread] = []

    def fake_spawn(q, done, items, sentinel, wrap=lambda x: x):
        idx = len(threads)

        def run():
            if idx:
                threads[idx - 1].join()
            try:
                for item in items():
                    if not real_put(q, done, wrap(item)):
                        return
            finally:
                real_put(q, done, sentinel)

        th = threading.Thread(target=run, daemon=True)
        threads.append(th)
        th.start()
        return th

    monkeypatch.setattr(p.pump, "spawn_pump", fake_spawn)


def lockstep_pump(monkeypatch, p):
    """Deterministic drive with both join sides live: the two pumps of a
    join alternate batch for batch (left, right, left, …), so mid-stream
    barriers align and commit."""
    real_put = p.pump.checked_put
    cv = threading.Condition()
    spawned = [0]
    turn: dict[int, int] = {}
    live: dict[int, int] = {}

    def fake_spawn(q, done, items, sentinel, wrap=lambda x: x):
        with cv:
            idx = spawned[0]
            spawned[0] += 1
            pair, side = idx // 2, idx % 2
            turn.setdefault(pair, 0)
            live[pair] = live.get(pair, 0) + 1

        def run():
            try:
                for item in items():
                    with cv:
                        while live[pair] > 1 and turn[pair] % 2 != side:
                            cv.wait(0.05)
                    if not real_put(q, done, wrap(item)):
                        return
                    with cv:
                        turn[pair] = side + 1
                        cv.notify_all()
            finally:
                with cv:
                    live[pair] -= 1
                    cv.notify_all()
                real_put(q, done, sentinel)

        th = threading.Thread(target=run, daemon=True)
        th.start()
        return th

    monkeypatch.setattr(p.pump, "spawn_pump", fake_spawn)


def drive_with_schedule(p, sp, outs, *, kill_after_committed=None,
                        orch=None, coord=None, joiner_tag=2,
                        cols=AGG_COLS):
    """Pump ``sp.root``, routing tagged emissions into ``outs[tag]``; with
    a kill budget, trigger ONE epoch once ``joiner_tag`` emits, commit it,
    keep going for the budget, then stop hard (mid-epoch progress lost)."""
    committed = triggered = False
    post_commit = 0
    it = sp.root.run()
    for item in it:
        if isinstance(item, p.SubBatch):
            acc = outs.get(item.tag)
            if acc is not None:
                rows_of(item.batch, acc, cols)
            if kill_after_committed is None:
                continue
            if item.tag == joiner_tag and not triggered and orch is not None:
                # ONE barrier: a second would stay queued on the source's
                # channel and cut the next run at its start
                orch.trigger_now()
                triggered = True
            if committed:
                post_commit += 1
                if post_commit >= kill_after_committed:
                    it.close()
                    return True
        elif isinstance(item, p.Marker) and coord is not None:
            coord.commit(item.epoch)
            committed = True
    return committed
