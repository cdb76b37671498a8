"""Checkpoint and restore of the port's window path, held against the JAX
package: the LSM store, the snapshot format, the channel registry, kill and
restore of the window job (``auto``, ``scatter`` and ``partial_merge``,
tumbling and sliding), repeated cycles on one store, a real SIGKILL of a
child process, stores written by one package and restored by the other,
and the asynchronous export on the CPU.

Each window job's golden is the JAX package's uninterrupted run on the same
seeded batches.  Counts, min and max exact; sums to rtol=1e-4, atol=1e-6 —
the JAX package's own kill/restore tolerance (tests/test_checkpoint.py),
since a restored ring folds in another order than an uninterrupted one.

Run as a script (``python tests/test_torch_checkpoint.py --child ...``) this
file is the SIGKILL test's child: a checkpointed port job that writes one
flushed JSON line per emitted window row and per committed epoch.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import denormalized_tpu_torch as tt
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.constants import WINDOW_START_COLUMN
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.parallel.sharded_state import make_sharded_state
from denormalized_tpu_torch.physical.base import Marker as TMarker
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state import channel_manager as cm
from denormalized_tpu_torch.state import checkpoint as tck
from denormalized_tpu_torch.state import lsm as tlsm
from denormalized_tpu_torch.state.orchestrator import Orchestrator as TOrch
from denormalized_tpu_torch.state.serialization import (
    pack_snapshot,
    unpack_snapshot,
)

T0 = 1_700_000_000_000
TOL = dict(rtol=1e-4, atol=1e-6)


# -- data and pipelines ----------------------------------------------------


def raw_stream(seed, n_batches, n=200, span_ms=400, n_keys=7):
    """Seeded batches: sorted event times over ``span_ms`` a batch, keys
    ``s0``..``s{n_keys-1}``, normal(50, 5) readings → [(ts, keys, vals)]."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * span_ms + rng.integers(0, span_ms, n))
        keys = np.array(
            [f"s{i}" for i in rng.integers(0, n_keys, n)], dtype=object
        )
        out.append((ts.astype(np.int64), keys, rng.normal(50, 5, n)))
    return out


def port_batches(raw):
    schema = TSchema([
        TField("occurred_at_ms", TType.INT64, nullable=False),
        TField("sensor_name", TType.STRING, nullable=False),
        TField("reading", TType.FLOAT64),
    ])
    return [TBatch(schema, [ts, k, v]) for ts, k, v in raw]


def jax_batches(raw):
    from denormalized_tpu.common.record_batch import RecordBatch
    from denormalized_tpu.common.schema import DataType, Field, Schema

    schema = Schema([
        Field("occurred_at_ms", DataType.INT64, nullable=False),
        Field("sensor_name", DataType.STRING, nullable=False),
        Field("reading", DataType.FLOAT64),
    ])
    return [RecordBatch(schema, [ts, k, v]) for ts, k, v in raw]


def port_pipeline(ctx, batches, slide_ms=None, source=None):
    src = source or TSource.from_batches(
        batches, timestamp_column="occurred_at_ms"
    )
    return ctx.from_source(src, name="ckpt_src").window(
        ["sensor_name"],
        [
            TF.count(tt.col("reading")).alias("cnt"),
            TF.sum(tt.col("reading")).alias("s"),
            TF.min(tt.col("reading")).alias("mn"),
        ],
        1000, slide_ms,
    )


def jax_pipeline(ctx, batches, slide_ms=None):
    from denormalized_tpu import col
    from denormalized_tpu.api import functions as F
    from denormalized_tpu.sources.memory import MemorySource

    return ctx.from_source(
        MemorySource.from_batches(batches, timestamp_column="occurred_at_ms"),
        name="ckpt_src",
    ).window(
        ["sensor_name"],
        [
            F.count(col("reading")).alias("cnt"),
            F.sum(col("reading")).alias("s"),
            F.min(col("reading")).alias("mn"),
        ],
        1000, slide_ms,
    )


def port_cfg(path, strategy="auto"):
    return tt.EngineConfig(
        device="cpu", device_strategy=strategy,
        checkpoint=path is not None, checkpoint_interval_s=9999,
        state_backend_path=path,
    )


def jax_cfg(path):
    from denormalized_tpu.api.context import EngineConfig

    return EngineConfig(
        checkpoint=path is not None, checkpoint_interval_s=9999,
        state_backend_path=path, emit_lag_ms=0,
    )


def windows_of(result) -> dict:
    """{(window_start, key): (count, sum, min)} of one emitted batch."""
    return {
        (int(ws), str(k)): (int(c), float(s), float(mn))
        for ws, k, c, s, mn in zip(
            result.column(WINDOW_START_COLUMN).tolist(),
            result.column("sensor_name").tolist(),
            result.column("cnt").tolist(),
            result.column("s").tolist(),
            result.column("mn").tolist(),
        )
    }


def jax_golden(raw, slide_ms=None) -> dict:
    """The JAX package's uninterrupted run over the same batches."""
    from denormalized_tpu import Context

    return windows_of(
        jax_pipeline(Context(jax_cfg(None)), jax_batches(raw), slide_ms)
        .collect()
    )


def assert_union_matches(golden, *runs):
    union = {}
    for r in runs:
        union.update(r)
    assert set(union) == set(golden)
    for k, want in golden.items():
        got = union[k]
        assert (got[0], got[2]) == (want[0], want[2]), (k, got, want)
        np.testing.assert_allclose(got[1], want[1], err_msg=str(k), **TOL)


@pytest.fixture(autouse=True)
def _clean_global_backends():
    yield
    tlsm.close_global_state_backend()
    from denormalized_tpu.state.lsm import close_global_state_backend

    close_global_state_backend()


# -- crash after a committed epoch, restore ---------------------------------


def port_run_until_commit(state_dir, batches, strategy="auto", slide_ms=None,
                          trigger_at=(1,), commits=1):
    """Run the port's job with barriers forced after the root has seen the
    items numbered in ``trigger_at``; crash (close the iterator, drop the
    store) right after ``commits`` committed epochs → (emitted, epochs)."""
    ctx = tt.Context(port_cfg(state_dir, strategy))
    root = texec.build_physical(
        tlp.Sink(port_pipeline(ctx, batches, slide_ms)._plan, TSink()), ctx
    )
    orch = TOrch(interval_s=9999)
    coord = tck.wire_checkpointing(root, ctx, orch)
    emitted, epochs, seen = {}, [], 0
    it = root.run()
    for item in it:
        if isinstance(item, TBatch):
            emitted.update(windows_of(item))
        if seen in trigger_at:
            orch.trigger_now()
        if isinstance(item, TMarker):
            coord.commit(item.epoch)
            epochs.append(item.epoch)
            if len(epochs) == commits:
                break
        seen += 1
    it.close()  # crash
    orch.stop()
    tlsm.close_global_state_backend()
    return emitted, epochs


def port_run_to_end(state_dir, batches, strategy="auto", slide_ms=None):
    """A fresh run on ``state_dir`` (restoring its committed epoch) to the
    end of the stream → (emitted, coordinator, window operator)."""
    ctx = tt.Context(port_cfg(state_dir, strategy))
    res = port_pipeline(ctx, batches, slide_ms).collect()
    tlsm.close_global_state_backend()
    window = ctx._last_physical.input_op
    return windows_of(res), ctx.last_checkpointing()[0], window


@pytest.mark.parametrize(
    "strategy, slide_ms",
    [("auto", None), ("scatter", None), ("partial_merge", None),
     ("auto", 200)],
    ids=["auto", "scatter", "partial_merge", "sliding"],
)
def test_kill_and_restore(tmp_path, strategy, slide_ms):
    """Crash after one committed epoch; a fresh run on the same store
    resumes from it, and the union of both runs' windows is the JAX
    package's uninterrupted run."""
    raw = raw_stream(21, 12)
    batches = port_batches(raw)
    state = str(tmp_path / "state")
    a, epochs = port_run_until_commit(state, batches, strategy, slide_ms)
    assert epochs
    b, coord, window = port_run_to_end(state, batches, strategy, slide_ms)
    assert coord.restored_epoch == epochs[0]
    golden = jax_golden(raw, slide_ms)
    assert_union_matches(golden, a, b)
    # the restored run did not reprocess from scratch
    assert len(b) < len(golden)
    assert window.backend.strategy_name.startswith(
        {"auto": "row_shipping:dense", "scatter": "row_shipping:scatter",
         "partial_merge": "partial_merge"}[strategy]
    )
    assert window.metrics()["rows_in"] < sum(len(r[0]) for r in raw)


def test_store_key_set_is_the_jax_packages(tmp_path):
    """The DFS node ids — class names and child order — key the store:
    the port writes exactly the keys the JAX package writes for the same
    query."""
    from denormalized_tpu import Context as JContext
    from denormalized_tpu.logical import plan as jlp
    from denormalized_tpu.physical.simple_execs import CollectSink
    from denormalized_tpu.runtime import executor as jexec
    from denormalized_tpu.state.checkpoint import assign_node_ids

    raw = raw_stream(5, 8)
    jctx = JContext(jax_cfg(None))
    jroot = jexec.build_physical(
        jlp.Sink(jax_pipeline(jctx, jax_batches(raw))._plan, CollectSink()),
        jctx,
    )
    want_ids = list(assign_node_ids(jroot).values())
    ctx = tt.Context(port_cfg(None))
    root = texec.build_physical(
        tlp.Sink(port_pipeline(ctx, port_batches(raw))._plan, TSink()), ctx
    )
    assert list(tck.assign_node_ids(root).values()) == want_ids
    state = str(tmp_path / "state")
    _, (epoch,) = port_run_until_commit(state, port_batches(raw))
    store = tlsm.LsmStore(state)
    keys = {k.decode() for k in store.keys()}
    store.close()
    assert keys == {
        "committed_epoch", "committed_epoch_history", f"manifest@{epoch}",
        f"offsets_3_SourceExec@{epoch}",
        f"window_1_StreamingWindowExec@{epoch}",
    }
    assert want_ids[1] == "1_StreamingWindowExec"
    assert want_ids[3] == "3_SourceExec"


@pytest.mark.parametrize(
    "shape", ["window", "select_then_window", "filter_then_window",
              "stacked_selects", "filter_after_window"],
)
def test_physical_plans_match_the_jax_packages(shape):
    """The port runs the JAX package's optimizer rules, so a query's
    physical plan — class names and child order, the checkpoint node ids
    — is the JAX package's."""
    from denormalized_tpu import Context as JContext
    from denormalized_tpu import col as jcol
    from denormalized_tpu.api import functions as JF
    from denormalized_tpu.logical import plan as jlp
    from denormalized_tpu.physical.simple_execs import CollectSink
    from denormalized_tpu.runtime import executor as jexec
    from denormalized_tpu.sources.memory import MemorySource
    from denormalized_tpu.state.checkpoint import assign_node_ids

    raw = raw_stream(5, 2)

    def build(pkg):
        if pkg == "jax":
            ctx, col, F = JContext(jax_cfg(None)), jcol, JF
            src = ctx.from_source(MemorySource.from_batches(
                jax_batches(raw), timestamp_column="occurred_at_ms"))
        else:
            ctx, col, F = tt.Context(port_cfg(None)), tt.col, TF
            src = ctx.from_source(TSource.from_batches(
                port_batches(raw), timestamp_column="occurred_at_ms"))
        if shape == "select_then_window":
            src = src.select(col("sensor_name"), col("reading"))
        elif shape == "filter_then_window":
            src = src.filter(col("reading") > 40.0)
        elif shape == "stacked_selects":
            src = src.select(
                col("sensor_name"), (col("reading") * 2.0).alias("r2"),
                col("occurred_at_ms"),
            ).select(col("sensor_name"), col("r2").alias("reading"))
        ds = src.window(
            ["sensor_name"],
            [F.count(col("reading")).alias("cnt"),
             F.avg(col("reading")).alias("avg")],
            1000,
        )
        if shape == "filter_after_window":
            ds = ds.filter(col("avg") > 45.0)
        if pkg == "jax":
            root = jexec.build_physical(
                jlp.Sink(ds._plan, CollectSink()), ctx)
            return list(assign_node_ids(root).values()), ds.collect()
        root = texec.build_physical(tlp.Sink(ds._plan, TSink()), ctx)
        return list(tck.assign_node_ids(root).values()), ds.collect()

    (jids, jres), (tids, tres) = build("jax"), build("port")
    assert tids == jids
    assert tres.num_rows == jres.num_rows > 0
    np.testing.assert_array_equal(tres.column("cnt"), jres.column("cnt"))


@pytest.mark.parametrize("seed", [3, 17, 29])
def test_repeated_kill_restore_cycles(tmp_path, seed):
    """Several crash/restore cycles on ONE store, each committing a new
    epoch at a random point: a restored run checkpoints anew over the
    state it restored.  The union of all cycles is the JAX golden."""
    rng = np.random.default_rng(seed)
    raw = raw_stream(seed, 24, n=150, span_ms=300, n_keys=6)
    batches = port_batches(raw)
    golden = jax_golden(raw)
    state = str(tmp_path / "state")
    cycles, last_epoch, emitted_before = [], None, 0
    for cycle in range(5):
        ctx = tt.Context(port_cfg(state))
        root = texec.build_physical(
            tlp.Sink(port_pipeline(ctx, batches)._plan, TSink()), ctx
        )
        orch = TOrch(interval_s=9999)
        coord = tck.wire_checkpointing(root, ctx, orch)
        if cycle:
            assert coord.committed_epoch is not None
            assert coord.committed_epoch >= last_epoch
        crash_after = int(rng.integers(1, 5))
        emitted, crashed, seen = {}, False, 0
        it = root.run()
        for item in it:
            if isinstance(item, TBatch):
                emitted.update(windows_of(item))
            if seen == crash_after:
                orch.trigger_now()
            if isinstance(item, TMarker):
                coord.commit(item.epoch)
                last_epoch = item.epoch
                if cycle < 4:
                    crashed = True
                    break
            seen += 1
        it.close()
        orch.stop()
        tlsm.close_global_state_backend()
        if cycle and emitted_before:
            assert len(emitted) < len(golden)  # no reprocessing
        cycles.append(emitted)
        emitted_before += len(emitted)
        if not crashed:
            break
    assert not crashed, "the stream never ran to its end in 5 cycles"
    assert_union_matches(golden, *cycles)


# -- a real SIGKILL ------------------------------------------------------------

CHILD_BATCHES = 40
BARRIER_EVERY = 4  # reads


class HookedReader:
    """A partition reader calling ``on_read(i)`` before read i, offsets
    forwarded (the checkpoint persists and restores them)."""

    def __init__(self, reader, on_read):
        self._reader, self._on_read, self._n = reader, on_read, 0

    def read(self, timeout_s=None):
        self._on_read(self._n)
        self._n += 1
        return self._reader.read(timeout_s)

    def offset_snapshot(self):
        return self._reader.offset_snapshot()

    def offset_restore(self, snap):
        self._reader.offset_restore(snap)


def child_main(argv) -> None:
    """The SIGKILL test's child: the window job over the seeded batches,
    checkpointed to ``--state`` with a barrier every BARRIER_EVERY reads;
    one flushed JSON line per emitted window row and per committed epoch.
    With ``--pause-after N`` it stops reading two reads after its N-th
    commit and waits to be killed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--pause-after", type=int, default=0)
    args = ap.parse_args(argv)
    batches = port_batches(raw_stream(11, CHILD_BATCHES))
    ctx = tt.Context(port_cfg(args.state))
    out = open(args.out, "a", buffering=1)
    seen = {"epochs": set(), "after": 0, "restored": False}

    def line(**kw):
        out.write(json.dumps(kw) + "\n")

    def on_read(i):
        coord = ctx.last_checkpointing()[0]
        if not seen["restored"]:
            seen["restored"] = True
            ids = tck.assign_node_ids(ctx._last_physical)
            src = next(ids[id(op)] for op in tck.walk(ctx._last_physical)
                       if not op.children)
            offsets = tck.get_json(coord, f"offsets_{src}")
            line(event="restored", epoch=coord.restored_epoch,
                 pos=offsets["partitions"][0]["pos"] if offsets else 0)
        e = coord.committed_epoch
        if e is not None and e != coord.restored_epoch and (
            e not in seen["epochs"]
        ):
            seen["epochs"].add(e)
            line(event="commit", epoch=e)
        if args.pause_after and len(seen["epochs"]) >= args.pause_after:
            seen["after"] += 1
            if seen["after"] > 2:
                line(event="paused", read=i)
                while True:  # until SIGKILL
                    time.sleep(1)
        if i % BARRIER_EVERY == BARRIER_EVERY - 1:
            ctx.last_checkpointing()[1].trigger_now()

    class Hooked(TSource):
        def partitions(self):
            return [HookedReader(r, on_read) for r in super().partitions()]

    source = Hooked([batches], timestamp_column="occurred_at_ms")
    for b in port_pipeline(ctx, batches, source=source).stream():
        for (ws, k), (c, s, mn) in windows_of(b).items():
            line(event="row", ws=ws, k=k, c=c, s=s, mn=mn)
    window = ctx._last_physical  # stream(): the window is the root
    line(event="done", batches=window.metrics()["batches_in"],
         dense_updates=window.backend.dense_updates)


def read_lines(path) -> list[dict]:
    out = []
    try:
        with open(path) as f:
            for raw in f:
                try:
                    out.append(json.loads(raw))
                except json.JSONDecodeError:
                    pass  # a line torn by the kill
    except FileNotFoundError:
        pass
    return out


def test_sigkill_child_restores(tmp_path):
    """A child process runs the checkpointed job, commits two epochs, and
    gets a real SIGKILL (no finally block runs) with a third of its batches
    unread; a second child on the same store restores the committed epoch
    and runs to the end.  The union of both children's rows is the JAX
    golden, and the second child read fewer batches than the stream."""
    state, out_a, out_b = (str(tmp_path / n) for n in ("state", "a", "b"))
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))

    def spawn(out, *extra):
        return subprocess.Popen(
            [sys.executable, __file__, "--child", "--state", state,
             "--out", out, *extra],
            env=env, stderr=subprocess.PIPE, text=True,
        )

    child = spawn(out_a, "--pause-after", "2")
    try:
        deadline = time.time() + 120
        while not any(d["event"] == "paused" for d in read_lines(out_a)):
            assert child.poll() is None, child.stderr.read()
            assert time.time() < deadline, "child A never paused"
            time.sleep(0.05)
        os.kill(child.pid, signal.SIGKILL)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait(10)
    assert child.returncode == -signal.SIGKILL
    a = read_lines(out_a)
    commits = [d["epoch"] for d in a if d["event"] == "commit"]
    assert len(commits) == 2
    # killed with at least a third of the stream unread
    assert a[-1]["read"] <= CHILD_BATCHES - CHILD_BATCHES // 3
    child = spawn(out_b)
    _, err = child.communicate(timeout=120)
    assert child.returncode == 0, err
    b = read_lines(out_b)
    restored, done = b[0], b[-1]
    assert (restored["event"], restored["epoch"]) == ("restored", commits[-1])
    assert done["event"] == "done"
    # the restart read the batches after the committed offset, each through
    # the dense update on the restored ring
    assert 0 < restored["pos"] < CHILD_BATCHES
    assert done["batches"] == CHILD_BATCHES - restored["pos"]
    assert done["dense_updates"] == done["batches"]

    def rows(lines):
        return {
            (d["ws"], d["k"]): (d["c"], d["s"], d["mn"])
            for d in lines if d["event"] == "row"
        }

    golden = jax_golden(raw_stream(11, CHILD_BATCHES))
    assert_union_matches(golden, rows(a), rows(b))
    assert len(rows(b)) < len(golden)


# -- one package writes, the other restores ------------------------------------


def test_pack_snapshot_byte_identical_across_packages():
    from denormalized_tpu.state import serialization as jser

    rng = np.random.default_rng(4)
    meta = {"epoch": 7, "first_open": -3, "watermark_ms": T0,
            "interner": {"columns": [["a", "b"]], "rows": [[0], [1]]},
            "var_shift": {}, "any_nulls_seen": False}
    arrays = {
        "count_star": rng.integers(0, 9, (16, 128)).astype(np.int32),
        "sum_0": rng.normal(size=(16, 128)).astype(np.float32),
        "min_0": np.full((16, 128), np.inf, np.float32),
    }
    blob = pack_snapshot(meta, arrays)
    assert blob == jser.pack_snapshot(meta, arrays)
    m2, a2 = jser.unpack_snapshot(blob)
    assert m2 == meta
    for k in arrays:
        np.testing.assert_array_equal(a2[k], arrays[k])


def jax_run_until_commit(state_dir, batches):
    """The JAX package's twin of :func:`port_run_until_commit` (one
    barrier, crash after its commit)."""
    from denormalized_tpu import Context
    from denormalized_tpu.common.record_batch import RecordBatch
    from denormalized_tpu.logical import plan as jlp
    from denormalized_tpu.physical.base import Marker
    from denormalized_tpu.physical.simple_execs import CollectSink
    from denormalized_tpu.runtime import executor as jexec
    from denormalized_tpu.state.checkpoint import wire_checkpointing
    from denormalized_tpu.state.lsm import close_global_state_backend
    from denormalized_tpu.state.orchestrator import Orchestrator

    ctx = Context(jax_cfg(state_dir))
    root = jexec.build_physical(
        jlp.Sink(jax_pipeline(ctx, batches)._plan, CollectSink()), ctx
    )
    orch = Orchestrator(interval_s=9999)
    coord = wire_checkpointing(root, ctx, orch)
    emitted, seen, epoch = {}, 0, None
    it = root.run()
    for item in it:
        if isinstance(item, RecordBatch):
            emitted.update(windows_of(item))
        if seen == 1:
            orch.trigger_now()
        if isinstance(item, Marker):
            coord.commit(item.epoch)
            epoch = item.epoch
            break
        seen += 1
    it.close()
    orch.stop()
    close_global_state_backend()
    return emitted, epoch


def test_port_restores_a_jax_checkpoint(tmp_path):
    """The JAX package crashes after a committed epoch; the port restores
    from the same store and finishes the job."""
    raw = raw_stream(31, 12)
    state = str(tmp_path / "state")
    a, epoch = jax_run_until_commit(state, jax_batches(raw))
    assert epoch is not None
    store = tlsm.LsmStore(state)
    keys = {k.decode() for k in store.keys()}
    store.close()
    assert keys == {
        "committed_epoch", "committed_epoch_history", f"manifest@{epoch}",
        f"offsets_3_SourceExec@{epoch}",
        f"window_1_StreamingWindowExec@{epoch}",
    }
    b, coord, window = port_run_to_end(state, port_batches(raw))
    assert coord.restored_epoch == epoch
    golden = jax_golden(raw)
    assert_union_matches(golden, a, b)
    assert len(b) < len(golden)
    assert window.metrics()["rows_in"] < sum(len(r[0]) for r in raw)


def test_jax_restores_a_port_checkpoint(tmp_path):
    """The reverse: the port crashes after a committed epoch, the JAX
    package restores from the same store and finishes."""
    from denormalized_tpu import Context
    from denormalized_tpu.state.lsm import close_global_state_backend

    raw = raw_stream(37, 12)
    state = str(tmp_path / "state")
    a, (epoch,) = port_run_until_commit(state, port_batches(raw))
    ctx = Context(jax_cfg(state))
    b = windows_of(jax_pipeline(ctx, jax_batches(raw)).collect())
    close_global_state_backend()
    assert ctx._last_coord.restored_epoch == epoch
    golden = jax_golden(raw)
    assert_union_matches(golden, a, b)
    assert len(b) < len(golden)


# -- the store, the format and the registry ---------------------------------


def test_lsm_roundtrip_and_recovery(tmp_path):
    s = tlsm.LsmStore(str(tmp_path / "kv"))
    s.put("a", b"1")
    s.put("b", b"22")
    s.put("a", b"111")
    s.delete("b")
    assert s.get("a") == b"111" and s.get("b") is None
    s.close()
    s2 = tlsm.LsmStore(str(tmp_path / "kv"))
    assert s2.get("a") == b"111" and len(s2) == 1
    for i in range(100):
        s2.put(f"k{i}", bytes([i]))
    s2.compact()
    assert s2.get("k42") == bytes([42]) and s2.get("a") == b"111"
    s2.close()
    s3 = tlsm.LsmStore(str(tmp_path / "kv"))
    assert len(s3) == 101
    s3.close()


@pytest.mark.parametrize("engine", ["native", "python"])
def test_lsm_torn_tail_recovery(tmp_path, engine):
    # the pure-Python engine is built directly: its replay counts the tear
    open_store = tlsm.LsmStore if engine == "native" else tlsm._PyLsm
    s = open_store(str(tmp_path / "kv"))
    if engine == "native":
        assert s.is_native
    s.put(b"good", b"value")
    s.flush()
    s.close()
    segs = sorted((tmp_path / "kv").glob("seg-*.log"))
    with open(segs[-1], "ab") as f:
        f.write(b"\x01\x02\x03garbage")  # a torn write
    s2 = open_store(str(tmp_path / "kv"))
    assert s2.get(b"good") == b"value"
    if engine == "python":
        assert s2.replay_truncated == 1
    s2.put(b"after", b"x")
    assert s2.get(b"after") == b"x"
    s2.close()


def test_lsm_store_opens_across_packages(tmp_path):
    """The on-disk format is the JAX package's: each opens the other's
    store."""
    from denormalized_tpu.state.lsm import LsmStore as JLsm

    s = tlsm.LsmStore(str(tmp_path / "kv"))
    s.put("from_port", b"\x00\xffp")
    s.close()
    j = JLsm(str(tmp_path / "kv"))
    assert j.get("from_port") == b"\x00\xffp"
    j.put("from_jax", b"j")
    j.close()
    s = tlsm.LsmStore(str(tmp_path / "kv"))
    assert s.get("from_jax") == b"j" and len(s) == 2
    s.close()


def test_snapshot_pack_roundtrip():
    meta = {"watermark": 123, "nested": {"a": [1, 2]}}
    arrays = {
        "sums": np.arange(12, dtype=np.float32).reshape(3, 4),
        "counts": np.ones((2, 2), dtype=np.int32),
    }
    m2, a2 = unpack_snapshot(pack_snapshot(meta, arrays))
    assert m2 == meta
    np.testing.assert_array_equal(a2["sums"], arrays["sums"])
    np.testing.assert_array_equal(a2["counts"], arrays["counts"])


def test_channel_manager_semantics():
    ch = cm.create_channel("t1")
    assert cm.create_channel("t1") is ch
    assert cm.get_sender("t1") is ch
    assert cm.take_receiver("t1") is ch
    assert cm.take_receiver("t1") is None  # take-once
    cm.remove_channel("t1")
    assert cm.get_sender("t1") is None


@pytest.mark.parametrize("strategy", ["auto", "partial_merge"])
def test_checkpoint_metrics_reach_the_registry(tmp_path, strategy):
    """The store and the coordinator report into the obs registry: one
    commit, two snapshot puts (offsets and ring), the committed epoch and
    each state key's last blob size."""
    from denormalized_tpu_torch import obs

    def counts():
        snap = obs.registry().snapshot()
        return {k: v["count"] for k, v in snap.items() if isinstance(v, dict)}

    before = counts()
    _, (epoch,) = port_run_until_commit(
        str(tmp_path / "state"), port_batches(raw_stream(5, 8)),
        strategy=strategy,
    )
    snap = obs.registry().snapshot()
    grew = {k: n - before.get(k, 0) for k, n in counts().items()}
    assert grew["dnz_checkpoint_commit_ms"] == 1
    assert snap["dnz_checkpoint_committed_epoch"] == epoch
    assert grew['dnz_lsm_op_ms{op="put"}'] >= 2
    assert grew['dnz_lsm_op_ms{op="flush"}'] == 2
    assert grew["dnz_checkpoint_snapshot_bytes"] == 2
    ring = snap[
        'dnz_checkpoint_last_snapshot_bytes{key="window_1_StreamingWindowExec"}'
    ]
    assert ring > snap[
        'dnz_checkpoint_last_snapshot_bytes{key="offsets_3_SourceExec"}'
    ] > 0


# -- the asynchronous export on the CPU ---------------------------------------


@pytest.mark.parametrize("strategy", ["auto", "partial_merge"])
def test_export_start_finish_is_export_before_later_updates(strategy):
    """export_start's planes are export()'s at that moment: an update made
    between export_start and export_finish does not show in them."""
    rng = np.random.default_rng(8)
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for(
            [("count", 0), ("sum", 0), ("min", 0)])),
        num_value_cols=1, window_slots=16, group_capacity=128,
        length_ms=1000, slide_ms=1000,
    )
    backend = make_sharded_state(spec, "cpu", strategy)
    host = {
        "count_star": rng.integers(0, 5, (16, 128)).astype(np.int32),
        "count_0": rng.integers(0, 5, (16, 128)).astype(np.int32),
        "sum_0": rng.normal(50, 10, (16, 128)).astype(np.float32),
        "min_0": rng.normal(50, 10, (16, 128)).astype(np.float32),
    }
    backend.import_(host)
    before = backend.export()
    handle = backend.export_start()
    B = 256
    gid = rng.integers(0, 128, B).astype(np.int32)
    vals = rng.normal(0, 10, (B, 1))
    rem = np.zeros(B, np.int32)
    if strategy == "partial_merge":
        backend.accumulate(np.full(B, 3, np.int64), rem, gid, vals, None,
                           None, 0)
        backend.flush_pending()
    else:
        backend.update(vals.astype(np.float32), np.ones((B, 1), bool),
                       np.full(B, 3, np.int32), rem, gid, np.ones(B, bool),
                       0, min_win_rel=3, max_win_rel=3)
    d2h = backend.bytes_d2h
    got = backend.export_finish(handle)
    assert backend.bytes_d2h - d2h == sum(a.nbytes for a in got.values())
    after = backend.export()
    assert not np.array_equal(after["sum_0"], before["sum_0"])
    assert set(got) == set(before)
    for k in before:
        np.testing.assert_array_equal(got[k], before[k])


def test_restored_ring_lives_on_the_engine_device(tmp_path):
    """The restore imports the ring onto the engine's device (the card in
    chip_smoke.py's phase 12; the CPU here) through the configured
    strategy's backend."""
    raw = raw_stream(41, 10)
    state = str(tmp_path / "state")
    port_run_until_commit(state, port_batches(raw), "partial_merge")
    ctx = tt.Context(port_cfg(state, "partial_merge"))
    root = texec.build_physical(
        tlp.Sink(port_pipeline(ctx, port_batches(raw))._plan, TSink()), ctx
    )
    orch = TOrch(interval_s=9999)
    tck.wire_checkpointing(root, ctx, orch)
    orch.stop()
    window = root.input_op
    assert window.backend.strategy_name == "partial_merge"
    assert window._first_open is not None
    for t in window.backend._state.values():
        assert t.device == torch.device("cpu")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child_main(sys.argv[2:])
