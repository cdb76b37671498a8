"""Multi-process sharded layouts on ``torch.distributed`` — twins of
tests/test_multiprocess_distributed.py.  Each test spawns CPU processes
that join one gloo process group over a local TCP address
(``parallel/distributed.py::init_distributed``) and build the job's mesh
with ``global_mesh``, each process holding its own shards.  Children hold
the shards they own against numpy oracles, and the reads that fold across
processes (``all_gather`` for key-sharded reads, ``all_reduce`` for the
partial layouts) against the global oracle on every process.  Each process
runs under a timeout of its own."""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


def _free_addr() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return addr


def _spawn_job(tmp_path, child_src, n_procs, shards_per_proc, extra=(),
               name="child"):
    addr = _free_addr()
    script = tmp_path / f"{name}.py"
    script.write_text(child_src)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    return [
        subprocess.Popen(
            [sys.executable, str(script), addr, str(i), str(n_procs),
             str(shards_per_proc), *map(str, extra)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(tmp_path),
        )
        for i in range(n_procs)
    ]


def _collect(procs, timeout=TIMEOUT_S):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# the children's common head: join the job, build the global mesh and a
# count/sum spec of W=8, G=256
_HEAD = r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)
addr, pid, nprocs, per = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
args = sys.argv[5:]

from denormalized_tpu_torch.parallel.distributed import (
    global_mesh, init_distributed, local_device_count,
)
import torch.distributed as dist

init_distributed(coordinator_address=addr, num_processes=nprocs, process_id=pid)
assert dist.get_world_size() == nprocs and dist.get_backend() == "gloo"
assert local_device_count() == torch.cuda.device_count()
mesh = global_mesh(devices=["cpu"] * per)
N = mesh.devices.size
assert N == nprocs * per and mesh.spans_processes

from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.parallel import sharded_state as ss
from denormalized_tpu_torch.parallel.mesh import make_mesh_2d

W, G = 8, 256
spec = sa.WindowKernelSpec(
    components=tuple(sa.components_for([("count", 0), ("sum", 0)])),
    num_value_cols=1, window_slots=W, group_capacity=G,
    length_ms=1000, slide_ms=1000,
)


def batch(seed, B=512):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(10.0, 1.0, (B, 1)).astype(np.float32),
        np.ones((B, 1), bool),
        rng.integers(0, 4, B).astype(np.int32),
        np.zeros(B, np.int32),
        rng.integers(0, G, B).astype(np.int32),
        np.ones(B, bool),
        0,
    )


def count_oracle(batches):
    exp = np.zeros((W, G), np.int64)
    for b in batches:
        np.add.at(exp, (b[2], b[4]), 1)
    return exp


def local_counts(st):
    return {i: np.asarray(sh._state["count_0"]) for i, sh in st.shards.items()}
"""

_LAYOUT_CHILD = _HEAD + r"""
layout = args[0]
b = batch(7)
oracle = count_oracle([b])
checked = 0
if layout == "key_sharded":
    st = ss.KeyShardedWindowState(spec, mesh)
    st.update(*b)
    Gl = G // N
    for i, got in local_counts(st).items():
        np.testing.assert_array_equal(got, oracle[:, i * Gl:(i + 1) * Gl])
        checked += 1
    # key-sharded reads gather every process's block
    np.testing.assert_array_equal(st.read_slot(2)["count_0"], oracle[2])
    np.testing.assert_array_equal(st.export()["count_0"], oracle)
elif layout == "partial_merge":
    st = ss.KeyShardedPartialMergeWindowState(spec, mesh)
    single = ss.PartialMergeWindowState(spec, "cpu")
    for be in (st, single):
        be.prepare_finals((("count", 0), ("sum", 0)))
        be.accumulate(b[2].astype(np.int64), b[3], b[4],
                      b[0].astype(np.float64), b[1], None, 0)
        be.flush_pending()
    ref = single.export()
    Gl = G // N
    for i, sh in st.shards.items():
        for label, plane in sh.export().items():
            np.testing.assert_allclose(plane, ref[label][:, i * Gl:(i + 1) * Gl],
                                       rtol=1e-6, atol=1e-6)
        checked += 1
    # emission gathered across processes: compaction, finals, blocks
    gids, rows = st.read_slot_compact(1)
    sg, srows = single.read_slot_compact(1)
    np.testing.assert_array_equal(gids, sg)
    np.testing.assert_array_equal(rows["count_0"], srows["count_0"])
    assert st.shard_compactions[pid * per] == 1
    fin = st.read_reset_block_finish(st.read_reset_block_finals_start(0, 2, 200))
    sfin = single.read_reset_block_finish(
        single.read_reset_block_finals_start(0, 2, 200))
    np.testing.assert_array_equal(fin[sa.ACTIVE_MASK], sfin[sa.ACTIVE_MASK])
    np.testing.assert_allclose(fin["__final_1__"], sfin["__final_1__"], rtol=1e-6)
    blk = st.read_reset_block_finish(st.read_reset_block_start(2, 2, 200))
    sblk = single.read_reset_block_finish(single.read_reset_block_start(2, 2, 200))
    np.testing.assert_array_equal(blk["count_0"], sblk["count_0"])
elif layout == "partial_final":
    st = ss.PartialFinalWindowState(spec, mesh)
    st.update(*b)
    per_rows = len(b[2]) // N  # rows split over the global shards in order
    for i, got in local_counts(st).items():
        sel = slice(i * per_rows, (i + 1) * per_rows)
        exp = np.zeros((W, G), np.int64)
        np.add.at(exp, (b[2][sel], b[4][sel]), 1)
        np.testing.assert_array_equal(got, exp)
        checked += 1
    # the layout's one collective: the emission fold, on every process
    np.testing.assert_array_equal(st.read_slot(2)["count_0"], oracle[2])
    np.testing.assert_array_equal(st.export()["count_0"], oracle)
elif layout == "two_level":
    st = ss.TwoLevelWindowState(spec, make_mesh_2d(2, N // 2, devices=mesh))
    st.update(*b)
    per_rows = len(b[2]) // 2  # rows split across the slice axis in order
    Gl = G // (N // 2)
    for i, got in local_counts(st).items():
        s, k = divmod(i, N // 2)
        sel = slice(s * per_rows, (s + 1) * per_rows)
        exp = np.zeros((W, G), np.int64)
        np.add.at(exp, (b[2][sel], b[4][sel]), 1)
        np.testing.assert_array_equal(got, exp[:, k * Gl:(k + 1) * Gl])
        checked += 1
    np.testing.assert_array_equal(st.read_slot(2)["count_0"], oracle[2])
    np.testing.assert_array_equal(st.export()["count_0"], oracle)
else:
    raise SystemExit(f"unknown layout {layout}")
assert checked == per, checked
print(f"LAYOUT-OK layout={layout} pid={pid} shards={checked}", flush=True)
dist.destroy_process_group()
"""


def _run_layout(tmp_path, layout, n_procs, per):
    procs = _spawn_job(tmp_path, _LAYOUT_CHILD, n_procs, per, (layout,),
                       name=f"layout_{layout}")
    outs = _collect(procs)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{layout} process {i} failed:\n{out[-3000:]}"
        assert f"LAYOUT-OK layout={layout} pid={i}" in out, out[-2000:]


def test_two_process_key_sharded_step(tmp_path):
    """Twin of tests/test_multiprocess_distributed.py:134: two processes of
    four shards each, one key-sharded step, every owned shard and the
    gathered reads against the oracle."""
    _run_layout(tmp_path, "key_sharded", 2, 4)


@pytest.mark.parametrize(
    "layout", ["key_sharded", "partial_merge", "partial_final", "two_level"]
)
def test_four_process_layouts(tmp_path, layout):
    """Twin of :299: every layout across 4 processes x 2 shards = 8."""
    _run_layout(tmp_path, layout, 4, 2)


_KILL_RESTORE_CHILD = _HEAD + r"""
import os
import signal
import time

phase, snapdir = args[0], args[1]
st = ss.KeyShardedWindowState(spec, mesh)
Gl = G // N
batches = [batch(100 + i, 256) for i in range(6)]
if phase == "A":
    for b in batches[:3]:
        st.update(*b)
    # bank THIS process's shards: the per-process snapshot files an aligned
    # barrier would write
    payload = {f"{label}|{i * Gl}|{(i + 1) * Gl}": plane
               for i, sh in st.shards.items()
               for label, plane in sh.export().items()}
    path = os.path.join(snapdir, f"snap_p{pid}.npz")
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)
    print(f"SNAP-BANKED pid={pid}", flush=True)
    deadline = time.time() + 60
    while time.time() < deadline and not all(
        os.path.exists(os.path.join(snapdir, f"snap_p{p}.npz"))
        for p in range(nprocs)
    ):
        time.sleep(0.05)
    if pid == nprocs - 1:
        os.kill(os.getpid(), signal.SIGKILL)  # crash mid-stream
    # survivors stream past the snapshot (key-sharded updates need no
    # collective, so a dead peer does not stop them)
    for b in batches[3:]:
        st.update(*b)
    print(f"SURVIVOR-DONE pid={pid}", flush=True)
    os._exit(0)  # no group teardown: a peer is dead

# phase B: a fresh job assembles the global snapshot from every process's
# file, restores, replays the rest and checks against the full oracle
host_state = {}
for p in range(nprocs):
    with np.load(os.path.join(snapdir, f"snap_p{p}.npz")) as z:
        for key in z.files:
            label, g0, g1 = key.split("|")
            buf = host_state.setdefault(label, np.zeros((W, G), z[key].dtype))
            buf[:, int(g0):int(g1)] = z[key]
st.import_(host_state)
for b in batches[3:]:
    st.update(*b)
oracle = count_oracle(batches)
checked = 0
for i, got in local_counts(st).items():
    np.testing.assert_array_equal(got, oracle[:, i * Gl:(i + 1) * Gl])
    checked += 1
np.testing.assert_array_equal(st.export()["count_0"], oracle)
print(f"RESTORED-OK pid={pid} shards={checked}", flush=True)
dist.destroy_process_group()
"""


def test_kill_restore_across_process_boundaries(tmp_path):
    """Twin of :477: a 4-process key-sharded job banks per-process shard
    snapshots, one process SIGKILLs itself, the survivors stream on; a
    fresh 4-process job assembles the global state from the files,
    restores, replays the remainder, and every process's shards and the
    gathered export match the whole stream's oracle."""
    snapdir = tmp_path / "snaps"
    snapdir.mkdir()
    procs = _spawn_job(tmp_path, _KILL_RESTORE_CHILD, 4, 2, ("A", snapdir),
                       name="kill_a")
    outs = _collect(procs)
    assert procs[-1].returncode == -signal.SIGKILL, outs[-1][-2000:]
    for i, (p, out) in enumerate(zip(procs[:-1], outs[:-1])):
        assert p.returncode == 0, f"survivor {i} failed:\n{out[-3000:]}"
        assert f"SURVIVOR-DONE pid={i}" in out, out[-2000:]
    for i, out in enumerate(outs):
        assert f"SNAP-BANKED pid={i}" in out, out[-2000:]
    assert len(list(snapdir.glob("snap_p*.npz"))) == 4

    procs_b = _spawn_job(tmp_path, _KILL_RESTORE_CHILD, 4, 2, ("B", snapdir),
                         name="kill_b")
    outs_b = _collect(procs_b)
    for i, (p, out) in enumerate(zip(procs_b, outs_b)):
        assert p.returncode == 0, f"restore process {i} failed:\n{out[-3000:]}"
        assert f"RESTORED-OK pid={i}" in out, out[-2000:]


_JOB_CHILD = _HEAD + r"""
import denormalized_tpu_torch as tt
from denormalized_tpu_torch.api import functions as F
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec
from denormalized_tpu_torch.sources.memory import MemorySource

layout = args[0]
T0 = 1_700_000_000_000
AGGS = ("count", "sum", "min", "max")
schema = Schema([
    Field("occurred_at_ms", DataType.INT64, nullable=False),
    Field("sensor_name", DataType.STRING, nullable=False),
    Field("reading", DataType.FLOAT64),
])
rng = np.random.default_rng(5)
raw = []
for b in range(8):
    ts = np.sort(T0 + b * 250 + rng.integers(0, 250, 300)).astype(np.int64)
    # the key space widens batch by batch: the ring grows mid-stream
    names = np.array([f"s{i}" for i in rng.integers(0, 100 + 150 * b, 300)],
                     dtype=object)
    raw.append((ts, names, rng.normal(50, 10, 300)))


def job(**cfg):
    ctx = tt.Context(tt.EngineConfig(device="cpu", **cfg))
    res = ctx.from_source(MemorySource.from_batches(
        [RecordBatch(schema, list(r)) for r in raw],
        timestamp_column="occurred_at_ms",
    )).window(
        ["sensor_name"], [getattr(F, a)(tt.col("reading")).alias(a) for a in AGGS],
        1000, 500,
    ).collect()
    out = {}
    for i in range(res.num_rows):
        k = (int(res.column("window_start_time")[i]),
             str(res.column("sensor_name")[i]))
        out[k] = tuple(float(res.column(a)[i]) for a in AGGS)
    op = ctx._last_physical
    while not isinstance(op, StreamingWindowExec):
        op = op.children[0]
    return out, op


cfg = {
    "key_sharded": dict(mesh_devices=N, shard_strategy="key_sharded"),
    "partial_final": dict(mesh_devices=N, shard_strategy="partial_final"),
    "two_level": dict(mesh_devices=N, mesh_slices=2),
    "partial_merge": dict(mesh_devices=N, device_strategy="partial_merge"),
}[layout]
want, _ = job(device_strategy="partial_merge" if layout == "partial_merge"
              else "scatter")
got, op = job(**cfg)
be = op.backend
assert be.mesh.spans_processes and sorted(be.shards) == [
    i for i in range(N) if i // per == pid], sorted(be.shards)
assert op.metrics()["grow_events"] > 0
assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
for k, w in want.items():
    for a, x, y in zip(AGGS, got[k], w):
        if a == "sum":
            np.testing.assert_allclose(x, y, rtol=1e-5, err_msg=f"{k} {a}")
        else:
            assert x == y, (k, a, x, y)
steps = be.shard_merges if layout == "partial_merge" else be.shard_scatter
assert all(steps[i] > 0 for i in be.shards), steps
if layout == "key_sharded":
    # a shard count the processes cannot split evenly is refused
    try:
        job(mesh_devices=N - 1)
    except ValueError as e:
        assert f"multiple of the job's {nprocs} processes" in str(e), e
    else:
        raise AssertionError(f"mesh_devices={N - 1} planned over {nprocs}")
print(f"JOB-OK layout={layout} pid={pid} rows={len(got)}", flush=True)
dist.destroy_process_group()
"""


@pytest.mark.parametrize(
    "layout", ["key_sharded", "partial_final", "two_level", "partial_merge"]
)
def test_context_job_across_processes(tmp_path, layout):
    """A ``Context`` job under a process group: the planner builds the
    job's mesh (``EngineConfig(mesh_devices=4)`` over 2 processes of 2
    shards), each process holds its own shards, the ring grows mid-stream,
    and every process emits the one-process job's rows and values."""
    procs = _spawn_job(tmp_path, _JOB_CHILD, 2, 2, (layout,),
                       name=f"job_{layout}")
    outs = _collect(procs)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{layout} process {i} failed:\n{out[-3000:]}"
        assert f"JOB-OK layout={layout} pid={i}" in out, out[-2000:]


def test_distributed_helpers_single_process():
    """Twin of tests/test_sharded_state.py:178: without a job the helpers
    are no-ops over this process's cards; without a card the default
    devices raise rather than fall back to the CPU."""
    from denormalized_tpu_torch.parallel.distributed import (
        global_mesh,
        init_distributed,
        local_device_count,
        local_devices,
    )

    init_distributed()  # nothing multi-process requested
    assert local_device_count() == torch.cuda.device_count()
    if torch.cuda.is_available():
        mesh = global_mesh()
        assert mesh.devices.size == local_device_count()
        assert not mesh.spans_processes
        assert list(mesh.devices.flat) == local_devices()
    else:
        with pytest.raises(RuntimeError, match="no visible card"):
            local_devices()
        with pytest.raises(RuntimeError, match="no visible card"):
            global_mesh()
    mesh = global_mesh(devices=["cpu"] * 3)
    assert mesh.devices.size == 3 and mesh.ranks is None


def test_init_distributed_needs_every_address_part():
    from denormalized_tpu_torch.parallel.distributed import init_distributed

    with pytest.raises(ValueError, match="coordinator_address, num_processes"):
        init_distributed(num_processes=2)
