"""A fault of the JAX package's partial recovery and the port's repair
(ROADMAP §C): a survivor whose ingest already ended has sent its EOS and
closed its edges, so no later send fails and redials a reborn peer — the
reborn worker waits forever for that edge and the JAX coordinator, fed by
heartbeats, never times out.  The port's coordinator tells survivors of a
rejoin and each replays its edge's buffered tail; and a sender's
tear-heal counts a reborn receiver's frames from the head of the buffer
replayed to it, where the JAX package counts from frame 0 and resends
frames the receiver already holds."""

import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from denormalized_tpu_torch.cluster import ClusterSpec, run_cluster
from denormalized_tpu_torch.cluster import exchange as texchange
from denormalized_tpu_torch.cluster import framing as tframing
from denormalized_tpu_torch.cluster.reader import read_cluster
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TD
from denormalized_tpu_torch.common.schema import Field as TF
from denormalized_tpu_torch.common.schema import Schema as TS

from denormalized_tpu.cluster import exchange as jexchange
from denormalized_tpu.cluster import framing as jframing
from denormalized_tpu.common.errors import SourceError as JSourceError
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JD
from denormalized_tpu.common.schema import Field as JF
from denormalized_tpu.common.schema import Schema as JS

REPO = Path(__file__).resolve().parents[1]
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS_DIR)

import torch_cluster_jobs as tj  # noqa: E402

#: worker 1 (partition 1) streams unpaced and ends at once; worker 0
#: (partition 0) is paced, and is SIGKILLed at the first barrier after a
#: commit, long after worker 1 sent its EOS
ARGS = {"partitions": 2, "batches": 10, "rows": 48, "keys": 11,
        "batch_span_ms": 250, "window_ms": 1000, "pace_s": 0.0,
        "pace_skew_s": 0.2}
KILL = [{"worker": 0, "when": "inflight", "min_commits": 1}]


def test_reborn_worker_gets_a_finished_peers_tail(tmp_path):
    result = run_cluster(ClusterSpec(
        workdir=str(tmp_path), n_workers=2,
        job="torch_cluster_jobs:windowed_job",
        job_args=dict(ARGS, engine={"device": "cpu"}),
        sys_path=[TESTS_DIR], liveness_timeout_s=120.0, max_restarts=0,
        checkpoint_interval_s=0.3,
    ), kill_plan=KILL)
    assert result["status"] == "done"
    assert result["restarts"] == 0
    assert [r["worker"] for r in result["recoveries"]] == [0]
    rows = sorted(tj.canonical_row(r)
                  for r in read_cluster(result["segments"])["rows"])
    tj.assert_rows_match(rows, tj.numpy_oracle(ARGS))


def test_jax_cluster_wedges_on_the_same_schedule(tmp_path):
    """The JAX coordinator on the same job and kill: still running after
    25 s (a healthy run takes under 10 s on this job)."""
    code = f"""
import sys
sys.path.insert(0, {TESTS_DIR!r})
from denormalized_tpu.cluster import ClusterSpec, run_cluster
r = run_cluster(ClusterSpec(
    workdir={str(tmp_path)!r}, n_workers=2,
    job="cluster_jobs:windowed_job", job_args={ARGS!r},
    sys_path=[{TESTS_DIR!r}], liveness_timeout_s=120.0, max_restarts=0,
    checkpoint_interval_s=0.3), kill_plan={KILL!r})
print("finished", r["status"])
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=25)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        state = (tmp_path / "meta" / "cluster_state.json").read_text()
        assert '"recovering"' not in state  # the respawn rejoined ...
        assert (tmp_path / "meta" / "commits.jsonl").exists()
        return  # ... and the run wedged, as documented
    raise AssertionError(f"the JAX cluster finished: {out} {err[-2000:]}")


def _schema(mod_s, mod_f, mod_d):
    return mod_s([mod_f("k", mod_d.INT64), mod_f("v", mod_d.FLOAT64)])


def _tear_heal_after_rebirth(exchange, framing, batch_cls, schema, tmp_path):
    """A partial sender streams 3 data frames, barrier 1 and 2 more; the
    commit of epoch 1 prunes its buffer; the receiver is reborn and gets
    the buffered tail by a fresh replay; then the edge tears and the
    sender redials the same receiver → the rows that receiver ledgers for
    the sender's partition (each batch holds 10 rows), or the error."""
    batch = batch_cls(schema, [np.arange(10), np.ones(10)])
    path = str(tmp_path / f"{exchange is texchange}.sock")
    srv = exchange.ExchangeServer(0, 2, path, schema, partial=True)
    cli = exchange.ExchangeClient(1, 0, path, partial=True)
    cli.connect()
    for i in range(3):
        cli.send(framing.encode_data(batch, i, part=1), "data")
    cli.send(framing.encode_barrier(1), "barrier", 1)
    for i in range(2):
        cli.send(framing.encode_data(batch, 10 + i, part=1), "data")
    cli.note_commit(1)
    srv.stop()
    os.unlink(path)
    cli.close()
    reborn = exchange.ExchangeServer(0, 2, path, schema, partial=True,
                                     last_commit=1)
    edge = reborn.edges[1]
    try:
        cli._dial_and_resume(5.0, reconnect=True)  # fresh replay: 2 frames
        _wait(lambda: edge.frames_seen == 2)
        cli.close()  # the edge tears
        _wait(lambda: edge.conn is None)
        cli._dial_and_resume(5.0, reconnect=True)  # tear-heal
        _wait(lambda: edge.conn is not None)
        cli.send(framing.encode_eos(), "eos")
        _wait(lambda: edge.conn is None)  # the receive loop read the eos
        return edge.part_counts.get(1, 0)
    except (JSourceError, texchange.SourceError) as e:
        return str(e)
    finally:
        cli.close()
        reborn.stop()


def _wait(cond, timeout=5.0):
    ev = threading.Event()
    for _ in range(int(timeout / 0.01)):
        if cond():
            return
        ev.wait(0.01)
    raise AssertionError("timed out")


def test_tear_heal_after_a_rebirth_replays_nothing_twice(tmp_path):
    port = _tear_heal_after_rebirth(
        texchange, tframing, TBatch, _schema(TS, TF, TD), tmp_path)
    jax = _tear_heal_after_rebirth(
        jexchange, jframing, JBatch, _schema(JS, JF, JD), tmp_path)
    assert port == 20  # the two post-barrier batches, once
    assert "cannot tear-heal" in jax  # refused: the reference's fault


def _receiver_dies_mid_replay(exchange, framing, batch_cls, schema, tmp_path):
    """A partial sender holds 8 buffered frames of 256 KB (past the
    socket's buffers); its reborn receiver answers the hello as a fresh
    receiver and dies while the tail is written; the next incarnation
    listens on the same path → the frames it got, or the error."""
    batch = batch_cls(schema, [np.arange(16_384), np.ones(16_384)])
    path = str(tmp_path / f"m{exchange is texchange}.sock")
    cli = exchange.ExchangeClient(1, 0, path, partial=True)
    for i in range(8):
        cli._buffer("data", None, framing.encode_data(batch, i, part=1))
    cli._sent_idx = 8
    box = {}

    def receivers():
        lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        lst.bind(path)
        lst.listen(1)
        conn, _ = lst.accept()
        framing.read_frame(conn)  # the hello
        conn.sendall(framing.encode_resume(-1, 0, 0, {}))
        conn.close()  # dies with the replay unread
        lst.close()
        os.unlink(path)
        box["srv"] = exchange.ExchangeServer(0, 2, path, schema,
                                             partial=True)

    th = threading.Thread(target=receivers, daemon=True)
    th.start()
    try:
        cli._dial_and_resume(10.0, reconnect=True)
        th.join(10)
        edge = box["srv"].edges[1]
        _wait(lambda: edge.frames_seen == 8)
        return edge.frames_seen
    except OSError as e:
        return repr(e)
    finally:
        cli.close()
        th.join(10)
        if "srv" in box:
            box["srv"].stop()


def test_a_receiver_dying_mid_replay_is_redialled(tmp_path):
    """The port's redial retries a replay whose receiver died: the next
    incarnation gets the whole buffered tail.  The JAX client lets the
    broken pipe out, which kills a survivor's ingest (a SIGKILLed respawn
    in phase 47 took a healthy peer with it)."""
    port = _receiver_dies_mid_replay(
        texchange, tframing, TBatch, _schema(TS, TF, TD), tmp_path)
    jax = _receiver_dies_mid_replay(
        jexchange, jframing, JBatch, _schema(JS, JF, JD), tmp_path)
    assert port == 8
    assert "Broken pipe" in jax or "reset" in jax, jax
