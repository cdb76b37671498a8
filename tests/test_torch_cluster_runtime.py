"""End to end: a port cluster of n = 1, 2 and 3 worker processes over the
exchange emits the same row set as the JAX package's cluster on the same
seeded job, as the port's single-process run and as the numpy oracle;
counts, min and max exactly, sums exactly (integer readings), the mean to
f32 rounding.  Then the same through an aligned-checkpoint kill and
restore at the same n, and through a supervised full-cluster restart after
a worker's SIGKILL.  Workers run with ``engine: {"device": "cpu"}``; each
reports its device and kernel launch counters at EOS."""

import os
import sys

import pytest

from denormalized_tpu_torch.cluster import ClusterSpec, run_cluster
from denormalized_tpu_torch.cluster.reader import read_cluster

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
}
CPU = {"engine": {"device": "cpu"}}


def _spec(tmp_path, n_workers, job_args, **kw) -> ClusterSpec:
    return ClusterSpec(
        workdir=str(tmp_path),
        n_workers=n_workers,
        job="torch_cluster_jobs:windowed_job",
        job_args=dict(job_args, **CPU),
        sys_path=[TESTS_DIR],
        liveness_timeout_s=180.0,
        **kw,
    )


def _rows(result):
    got = read_cluster(result["segments"])
    return sorted(tj.canonical_row(r) for r in got["rows"]), got


@pytest.fixture(scope="module")
def oracle():
    numpy_rows = tj.numpy_oracle(JOB_ARGS)
    tj.assert_rows_match(tj.oracle_rows(dict(JOB_ARGS, **CPU)), numpy_rows)
    return numpy_rows


@pytest.mark.parametrize("n", [1, 2, 3])
def test_port_cluster_equals_jax_cluster_and_oracles(tmp_path, oracle, n):
    from denormalized_tpu.cluster import ClusterSpec as JSpec
    from denormalized_tpu.cluster import run_cluster as jrun

    port = run_cluster(_spec(tmp_path / "port", n, JOB_ARGS))
    assert port["status"] == "done"
    rows, got = _rows(port)
    assert got["done_files"] == n and got["clipped"] == 0
    tj.assert_rows_match(rows, oracle)
    # every worker ran its keyed half on the CPU and emitted its keys
    assert sorted(port["workers"]) == [str(w) for w in range(n)]
    assert {m["device"] for m in port["workers"].values()} == {"cpu"}
    assert all(v > 0 for v in port["rows_per_worker"].values())
    assert port["rows_in_total"] == 4 * 10 * 48
    assert sorted(port["startup_s"]) == [str(w) for w in range(n)]
    jax = jrun(JSpec(
        workdir=str(tmp_path / "jax"), n_workers=n,
        job="cluster_jobs:windowed_job", job_args=dict(JOB_ARGS),
        sys_path=[TESTS_DIR], liveness_timeout_s=180.0,
    ))
    assert jax["status"] == "done"
    jrows = sorted(tj.canonical_row(r)
                   for r in read_cluster(jax["segments"])["rows"])
    tj.assert_rows_match(rows, jrows)
    # the same hash map: each worker slot emits the same keys
    assert port["rows_per_worker"] == jax["rows_per_worker"]


def test_kill_restore_same_n_exactly_once(tmp_path, oracle):
    args = dict(JOB_ARGS, pace_s=0.05)
    spec = _spec(tmp_path, 2, args, checkpoint_interval_s=0.3,
                 max_restarts=0)
    phase1 = run_cluster(spec, kill_after_commits=1)
    assert phase1["status"] == "killed" and len(phase1["commits"]) >= 1
    phase2 = run_cluster(spec)
    assert phase2["status"] == "done"
    rows, got = _rows(phase2)
    assert got["done_files"] >= 2
    tj.assert_rows_match(rows, oracle)


def test_worker_death_triggers_full_restart(tmp_path, oracle):
    spec = _spec(tmp_path, 2, dict(JOB_ARGS, pace_s=0.05),
                 checkpoint_interval_s=0.3, max_restarts=2,
                 partial_recovery=False)
    result = run_cluster(spec, kill_worker_after_s=1.5, kill_worker_id=1)
    assert result["status"] == "done"
    assert result["restarts"] >= 1 and result["killed_workers"] >= 1
    rows, _ = _rows(result)
    tj.assert_rows_match(rows, oracle)
