"""Partial recovery in a port cluster: one worker dies, its peers keep
streaming, and the union of every segment's clipped output equals the
numpy oracle exactly once with ZERO full-cluster restarts
(``max_restarts=0`` turns any full restart into a StateError).  Covered:
a SIGKILL while a barrier aligns (the in-flight epoch aborted, its number
never reused), a second worker dying during the first one's rejoin, a
fault plan tearing one exchange frame with reconnect latency on the
redial, and a crash storm escalating to the full-cluster fallback, as a
peer dying right after a rejoin at the same epoch does.  The
cluster doctor gives the same verdicts as the JAX package's on the same
coordinator state."""

import json
import os
import sys

import pytest

from denormalized_tpu_torch.cluster import ClusterSpec, run_cluster
from denormalized_tpu_torch.cluster.reader import read_cluster
from denormalized_tpu_torch.common.errors import StateError
from denormalized_tpu_torch.obs.doctor import clusterdoc

from denormalized_tpu.obs.doctor import clusterdoc as jclusterdoc

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS_DIR)

import torch_cluster_jobs as tj  # noqa: E402

JOB_ARGS = {
    "partitions": 4,
    "batches": 10,
    "rows": 48,
    "keys": 11,
    "batch_span_ms": 250,
    "window_ms": 1000,
    "pace_s": 0.2,  # ~2 s of stream: commits land before the kills do
    "engine": {"device": "cpu"},
}


def _spec(tmp_path, n_workers=2, **kw) -> ClusterSpec:
    kw.setdefault("max_restarts", 0)  # any full restart = hard failure
    kw.setdefault("checkpoint_interval_s", 0.3)
    return ClusterSpec(
        workdir=str(tmp_path),
        n_workers=n_workers,
        job="torch_cluster_jobs:windowed_job",
        job_args=JOB_ARGS,
        sys_path=[TESTS_DIR],
        liveness_timeout_s=180.0,
        **kw,
    )


@pytest.fixture(scope="module")
def oracle():
    return tj.numpy_oracle(JOB_ARGS)


def _assert_exact(result, oracle):
    got = read_cluster(result["segments"])
    rows = sorted(tj.canonical_row(r) for r in got["rows"])
    tj.assert_rows_match(rows, oracle)


def test_partial_recovery_kill_mid_barrier(tmp_path, oracle):
    result = run_cluster(
        _spec(tmp_path, 3),
        kill_plan=[{"worker": 1, "when": "inflight", "min_commits": 1}],
    )
    assert result["status"] == "done"
    assert result["restarts"] == 0  # survivors never restarted
    assert result["worker_restarts"] >= 1
    assert result["aborted_epochs"]
    assert not set(result["aborted_epochs"]) & set(result["commits"])
    assert [r["worker"] for r in result["recoveries"]] == [1]
    assert all(r["ms"] > 0 for r in result["recoveries"])
    partials = [s for s in result["segments"] if s.get("partial")]
    assert partials and all(s["worker"] == 1 for s in partials)
    assert all(s["restored"] >= 1 for s in partials)
    # the respawn reports its own device too
    assert result["workers"]["1"]["device"] == "cpu"
    state = json.load(open(tmp_path / "meta" / "cluster_state.json"))
    assert state["workers"]["1"]["gen"] >= 1
    assert state["workers"]["0"]["gen"] == state["workers"]["2"]["gen"] == 0
    _assert_exact(result, oracle)


def test_second_worker_dies_during_first_rejoin(tmp_path, oracle):
    result = run_cluster(
        _spec(tmp_path),
        kill_plan=[
            {"worker": 0, "when": "inflight", "min_commits": 1},
            {"worker": 1, "when": "recovering", "of": 0},
        ],
    )
    assert result["status"] == "done"
    assert result["restarts"] == 0
    assert result["worker_restarts"] >= 2
    assert {r["worker"] for r in result["recoveries"]} == {0, 1}
    _assert_exact(result, oracle)


def test_peer_dies_right_after_a_rejoin_at_the_same_epoch(tmp_path, oracle):
    """Worker 1 dies and rejoins restored at epoch C, skipping the rows
    worker 0 already held from its first incarnation; worker 0 dies at
    once, before another commit.  Its restore at C lacks those rows and
    worker 1 never sent them, so no replay can cover them: the run takes
    the full restart and stays exactly once (the JAX package replays
    without them; a missing mark at C makes it fall back first)."""
    result = run_cluster(
        _spec(tmp_path, max_restarts=1),
        kill_plan=[
            {"worker": 1, "when": "inflight", "min_commits": 1},
            {"worker": 0, "when": "recovered", "of": 1},
        ],
    )
    assert result["status"] == "done"
    # the precondition, held by construction: worker 1's respawn took its
    # dedup ledger from worker 0 before reporting its rejoin, and no
    # barrier was issued between the two deaths, so worker 0 died at the
    # epoch worker 1 restored from
    first, second = result["kills"]
    assert (first["worker"], second["worker"]) == (1, 0)
    assert first["committed"] == second["committed"] is not None
    assert result["restarts"] == 1
    assert any("never sent" in c for c in result["crashes"])
    _assert_exact(result, oracle)


def test_torn_exchange_frame_with_reconnect_latency(tmp_path, oracle):
    """One torn ``exchange.send`` on worker 1's outbound edge kills that
    sender (fail-stop per worker) once the first epoch has committed (its
    ~25th send of ~40); the respawn rejoins while the peer redials with
    injected latency on every reconnect attempt; the output stays exactly
    once."""
    plan = {"seed": 5, "rules": [
        {"site": "exchange.send", "kind": "torn", "key_substr": "1->",
         "after": 24, "times": 1},
        {"site": "exchange.reconnect", "kind": "latency", "ms": 20},
    ]}
    result = run_cluster(_spec(tmp_path, fault_plan=plan))
    assert result["status"] == "done"
    assert result["restarts"] == 0
    assert result["worker_restarts"] >= 1
    assert any("torn" in c for c in result["crashes"])
    _assert_exact(result, oracle)


def test_crash_storm_escalates_to_the_full_restart(tmp_path):
    with pytest.raises(StateError, match="restart budget"):
        run_cluster(
            _spec(tmp_path, worker_max_restarts=1, restart_heal_s=600.0),
            kill_plan=[
                {"worker": 1, "when": "inflight", "min_commits": 1},
                {"worker": 1, "when": "recovered", "of": 1},
            ],
        )


def test_cluster_doctor_verdicts_equal_the_reference(tmp_path):
    state = {
        "n_workers": 3,
        "committed_epoch": 9,
        "worker_max_restarts": 3,
        "workers": {
            "0": {"gen": 0, "last_ack_epoch": 9, "state": "up"},
            "1": {"gen": 1, "last_ack_epoch": 7, "state": "recovering"},
            "2": {"gen": 3, "last_ack_epoch": 5, "state": "up"},
        },
    }
    v = clusterdoc.verdicts(state, edges_down={"0": 1})
    assert v == jclusterdoc.verdicts(state, edges_down={"0": 1})
    assert {x["kind"] for x in v} == {
        "recovering-worker", "degraded-edge", "restart-storm", "stale-ack"}
    sevs = [x["severity"] for x in v]
    assert sevs == sorted(sevs, reverse=True)
    os.makedirs(tmp_path / "meta")
    (tmp_path / "meta" / "cluster_state.json").write_text(json.dumps(state))
    snap = clusterdoc.cluster_snapshot(str(tmp_path))
    ref = jclusterdoc.cluster_snapshot(str(tmp_path))
    assert {k: snap[k] for k in ("state", "verdicts", "rules")} == {
        k: ref[k] for k in ("state", "verdicts", "rules")}
    assert clusterdoc.cluster_snapshot(str(tmp_path / "none"))["verdicts"] \
        == []
