"""Checkpoint integrity and epoch fallback of the port — twins of the JAX
package's tests/test_checkpoint_integrity.py: framed and verified blobs,
retention of two committed epochs, fallback to the previous epoch when a
committed blob is corrupt, torn or missing, a torn commit record, faults
injected at the commit and the LSM put, and a fallback restore whose
emissions are bit-identical to a direct restore of the previous epoch."""

import json
import shutil

import numpy as np
import pytest

import denormalized_tpu_torch as tt
from denormalized_tpu_torch.api import functions as F
from denormalized_tpu_torch.common.constants import WINDOW_START_COLUMN
from denormalized_tpu_torch.common.errors import StateError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.physical.base import Marker
from denormalized_tpu_torch.physical.simple_execs import CollectSink
from denormalized_tpu_torch.runtime import executor, faults
from denormalized_tpu_torch.sources.memory import MemorySource
from denormalized_tpu_torch.state.checkpoint import (
    CheckpointCoordinator,
    frame_snapshot,
    unframe_snapshot,
    wire_checkpointing,
)
from denormalized_tpu_torch.state.lsm import (
    LsmStore,
    close_global_state_backend,
)
from denormalized_tpu_torch.state.orchestrator import Orchestrator


@pytest.fixture(autouse=True)
def _clean_global_backend():
    yield
    faults.disarm()
    close_global_state_backend()


# -- unit level ------------------------------------------------------------


def test_snapshot_blobs_framed_and_verified(tmp_path):
    be = LsmStore(str(tmp_path / "kv"))
    coord = CheckpointCoordinator(be)
    coord.put_snapshot("offsets_0", 5, b'{"partitions": [1, 2]}')
    raw = be.get("offsets_0@5")
    assert raw.startswith(b"DNZ1") and raw != b'{"partitions": [1, 2]}'
    coord.commit(5)
    be.close()
    be2 = LsmStore(str(tmp_path / "kv"))
    coord2 = CheckpointCoordinator(be2)
    assert coord2.committed_epoch == 5
    assert not coord2.restored_from_fallback
    assert coord2.get_snapshot("offsets_0") == b'{"partitions": [1, 2]}'
    be2.close()


def test_framing_is_the_jax_packages():
    from denormalized_tpu.state import checkpoint as jck

    blob = b"\x00payload\xff" * 7
    assert frame_snapshot(blob) == jck.frame_snapshot(blob)
    assert unframe_snapshot(jck.frame_snapshot(blob)) == (True, blob)
    assert unframe_snapshot(frame_snapshot(blob)[:-1]) == (False, None)
    assert unframe_snapshot(b"DN") == (False, None)  # torn below the magic


def test_commit_retains_last_two_epochs(tmp_path):
    be = LsmStore(str(tmp_path / "kv"))
    coord = CheckpointCoordinator(be)
    for epoch in (1, 2, 3):
        coord.put_snapshot("k", epoch, f"blob{epoch}".encode())
        coord.commit(epoch)
    assert coord.committed_history == [2, 3]
    assert be.get("k@1") is None and be.get("manifest@1") is None
    assert be.get("k@2") is not None and be.get("k@3") is not None
    be.close()


def test_corrupt_committed_epoch_falls_back_to_previous(tmp_path):
    be = LsmStore(str(tmp_path / "kv"))
    coord = CheckpointCoordinator(be)
    for epoch in (1, 2):
        coord.put_snapshot("offsets_0", epoch, f"snap{epoch}".encode())
        coord.commit(epoch)
    # torn write at the committed epoch: header present, payload truncated
    be.put("offsets_0@2", frame_snapshot(b"snap2")[:-2])
    be.flush()
    be.close()
    be2 = LsmStore(str(tmp_path / "kv"))
    coord2 = CheckpointCoordinator(be2)
    assert coord2.restored_from_fallback
    assert coord2.committed_epoch == coord2.restored_epoch == 1
    assert coord2.get_snapshot("offsets_0") == b"snap1"
    be2.close()


def test_missing_snapshot_blob_falls_back(tmp_path):
    """The manifest makes a missing blob detectable, not only a corrupt
    one."""
    be = LsmStore(str(tmp_path / "kv"))
    coord = CheckpointCoordinator(be)
    for epoch in (1, 2):
        coord.put_snapshot("offsets_0", epoch, b"a")
        coord.put_snapshot("window_1", epoch, b"b")
        coord.commit(epoch)
    be.delete("window_1@2")
    be.flush()
    be.close()
    be2 = LsmStore(str(tmp_path / "kv"))
    coord2 = CheckpointCoordinator(be2)
    assert coord2.restored_from_fallback and coord2.committed_epoch == 1
    be2.close()


def test_torn_commit_record_keeps_retention_depth(tmp_path):
    """A torn commit record is repaired to the newest intact epoch from
    the history, which keeps both retained epochs: a second crash that
    corrupts the repaired-to epoch still falls back."""
    be = LsmStore(str(tmp_path / "kv"))
    coord = CheckpointCoordinator(be)
    for epoch in (1, 2):
        coord.put_snapshot("offsets_0", epoch, f"snap{epoch}".encode())
        coord.commit(epoch)
    be.put("committed_epoch", b"2x-torn")
    be.flush()
    be.close()
    be2 = LsmStore(str(tmp_path / "kv"))
    coord2 = CheckpointCoordinator(be2)
    assert coord2.committed_epoch == 2
    assert coord2.committed_history == [1, 2]
    assert be2.get("offsets_0@1") is not None
    be2.close()
    be3 = LsmStore(str(tmp_path / "kv"))
    be3.put("offsets_0@2", frame_snapshot(b"snap2")[:-2])
    be3.flush()
    be3.close()
    be4 = LsmStore(str(tmp_path / "kv"))
    coord4 = CheckpointCoordinator(be4)
    assert coord4.restored_from_fallback and coord4.committed_epoch == 1
    assert coord4.get_snapshot("offsets_0") == b"snap1"
    be4.close()


def test_all_retained_epochs_corrupt_raises(tmp_path):
    be = LsmStore(str(tmp_path / "kv"))
    coord = CheckpointCoordinator(be)
    for epoch in (1, 2):
        coord.put_snapshot("offsets_0", epoch, b"x")
        coord.commit(epoch)
    for epoch in (1, 2):
        be.put(f"offsets_0@{epoch}", frame_snapshot(b"x")[:-1])
    be.flush()
    be.close()
    be2 = LsmStore(str(tmp_path / "kv"))
    with pytest.raises(StateError, match="no intact checkpoint epoch"):
        CheckpointCoordinator(be2)
    be2.close()


# -- faults at the commit and the LSM put --------------------------------------


def test_transient_commit_error_is_retried(tmp_path):
    be = LsmStore(str(tmp_path / "kv"))
    coord = CheckpointCoordinator(be)
    coord.put_snapshot("k", 1, b"blob")
    plan = faults.arm({"rules": [
        {"site": "checkpoint.commit", "kind": "error", "times": 2}]})
    coord.commit(1)
    assert coord.commit_retries == 2
    assert [r.fired for r in plan.rules] == [2]
    faults.disarm()
    be.close()
    be2 = LsmStore(str(tmp_path / "kv"))
    assert CheckpointCoordinator(be2).committed_epoch == 1
    be2.close()


def test_torn_snapshot_put_falls_back(tmp_path):
    """A fault plan tears the newest epoch's blob as it is written; the
    restore verifies the epoch, finds the tear, and takes the previous
    one."""
    be = LsmStore(str(tmp_path / "kv"))
    coord = CheckpointCoordinator(be)
    coord.put_snapshot("window_1", 1, b"snap1" * 40)
    coord.commit(1)
    plan = faults.arm({"rules": [
        {"site": "lsm.put", "kind": "torn", "key_substr": "window_1@",
         "times": 1}]})
    coord.put_snapshot("window_1", 2, b"snap2" * 40)
    faults.disarm()
    assert plan.rules[0].fired == 1
    coord.commit(2)
    be.close()
    be2 = LsmStore(str(tmp_path / "kv"))
    coord2 = CheckpointCoordinator(be2)
    assert coord2.restored_from_fallback and coord2.committed_epoch == 1
    assert coord2.get_snapshot("window_1") == b"snap1" * 40
    be2.close()


# -- end to end: the fallback restore is the previous epoch's restore ----------


def _batches():
    rng = np.random.default_rng(77)
    schema = Schema([
        Field("occurred_at_ms", DataType.INT64, nullable=False),
        Field("sensor_name", DataType.STRING, nullable=False),
        Field("reading", DataType.FLOAT64),
    ])
    out = []
    for b in range(14):
        n = 150
        ts = np.sort(1_700_000_000_000 + b * 400 + rng.integers(0, 400, n))
        keys = np.array(
            [f"s{i}" for i in rng.integers(0, 6, n)], dtype=object
        )
        out.append(RecordBatch(schema, [ts, keys, rng.normal(50, 5, n)]))
    return out


def _root(state_dir, batches):
    ctx = tt.Context(tt.EngineConfig(
        device="cpu", checkpoint=True, checkpoint_interval_s=9999,
        state_backend_path=state_dir,
    ))
    ds = ctx.from_source(
        MemorySource.from_batches(batches, timestamp_column="occurred_at_ms"),
        name="fb_src",
    ).window(
        ["sensor_name"],
        [F.count(tt.col("reading")).alias("cnt"),
         F.sum(tt.col("reading")).alias("s"),
         F.min(tt.col("reading")).alias("mn")],
        1000,
    )
    root = executor.build_physical(lp.Sink(ds._plan, CollectSink()), ctx)
    orch = Orchestrator(interval_s=9999)
    return root, orch, wire_checkpointing(root, ctx, orch)


def _emissions(state_dir, batches):
    """Restore at ``state_dir``'s committed epoch and run to the end →
    (every emitted row with its floats as exact hex, coordinator)."""
    root, orch, coord = _root(state_dir, batches)
    rows = []
    for item in root.run():
        if isinstance(item, RecordBatch):
            for i in range(item.num_rows):
                rows.append((
                    int(item.column(WINDOW_START_COLUMN)[i]),
                    str(item.column("sensor_name")[i]),
                    int(item.column("cnt")[i]),
                    float(item.column("s")[i]).hex(),
                    float(item.column("mn")[i]).hex(),
                ))
    orch.stop()
    close_global_state_backend()
    return rows, coord


def test_fallback_restore_byte_identical_to_direct_previous_epoch(tmp_path):
    """Crash with two committed epochs and tear one blob of the later: the
    fallback restore emits bit-identically to a restore pointed straight
    at the earlier epoch."""
    batches = _batches()
    state = str(tmp_path / "state")
    root, orch, coord = _root(state, batches)
    committed, items = [], 0
    it = root.run()
    for item in it:
        if items in (1, 4):
            orch.trigger_now()
        if isinstance(item, Marker):
            coord.commit(item.epoch)
            committed.append(item.epoch)
            if len(committed) == 2:
                break  # crash with two committed epochs on disk
        items += 1
    it.close()
    orch.stop()
    close_global_state_backend()
    e1, e2 = committed

    corrupt_dir = str(tmp_path / "corrupt")
    control_dir = str(tmp_path / "control")
    shutil.copytree(state, corrupt_dir)
    shutil.copytree(state, control_dir)
    be = LsmStore(corrupt_dir)
    manifest = json.loads(be.get(f"manifest@{e2}").decode())
    assert manifest == ["offsets_3_SourceExec",
                        "window_1_StreamingWindowExec"]
    victim = manifest[-1]  # the window's ring snapshot
    blob = be.get(f"{victim}@{e2}")
    be.put(f"{victim}@{e2}", blob[: len(blob) // 2])
    be.flush()
    be.close()
    be = LsmStore(control_dir)
    be.put("committed_epoch", str(e1).encode())
    be.put("committed_epoch_history", json.dumps([e1]).encode())
    be.flush()
    be.close()

    rows_fallback, coord_fb = _emissions(corrupt_dir, batches)
    assert coord_fb.restored_from_fallback
    assert coord_fb.restored_epoch == e1
    rows_control, coord_ctl = _emissions(control_dir, batches)
    assert not coord_ctl.restored_from_fallback
    assert coord_ctl.restored_epoch == e1
    assert rows_fallback == rows_control
    assert len(rows_fallback) > 0
