"""Rescale-on-restore in the port: a cluster cut checkpointed at n = 3 and
SIGKILLed restores at n = 2, and the clipped union of both segments equals
the numpy oracle exactly once.  The port also restores, at n = 3 and
rescaled to n = 2, a cut that the JAX package's cluster wrote (its
coordinator, its workers, its stores); and the re-bucketing helpers build
the same snapshot as the JAX package's from the same contributions, but
for the cells no contribution covers (ROADMAP §C)."""

import os
import shutil
import sys

import numpy as np
import pytest

from denormalized_tpu_torch.cluster import ClusterSpec, run_cluster
from denormalized_tpu_torch.cluster import rescale as trescale
from denormalized_tpu_torch.cluster.reader import read_cluster
from denormalized_tpu_torch.common.errors import StateError

from denormalized_tpu.cluster import rescale as jrescale

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
    "pace_s": 0.2,
}


def _spec(workdir, n, job, **args) -> ClusterSpec:
    return ClusterSpec(
        workdir=str(workdir), n_workers=n, job=job,
        job_args=dict(JOB_ARGS, **args), sys_path=[TESTS_DIR],
        liveness_timeout_s=240.0, max_restarts=0, checkpoint_interval_s=0.3,
    )


def _port_spec(workdir, n, **args):
    return _spec(workdir, n, "torch_cluster_jobs:windowed_job",
                 engine={"device": "cpu"}, **args)


@pytest.fixture(scope="module")
def oracle():
    return tj.numpy_oracle(JOB_ARGS)


def _restore_at(workdir, n, oracle, **args):
    result = run_cluster(_port_spec(workdir, n, **args))
    assert result["status"] == "done"
    # the cut landed mid-stream: the restored run re-emitted windows
    assert result["rows_total"] > 0
    got = read_cluster(result["segments"])
    tj.assert_rows_match(sorted(tj.canonical_row(r) for r in got["rows"]),
                         oracle)
    return result


def test_rescale_three_to_two_exactly_once(tmp_path):
    """A feed of 8 windows over 16 keys (half the cells' minima above 0),
    cut after the second commit: windows the cut never saw open in ring
    slots the rescale built, so a min or max there must start from the
    plane's empty value (zeros fail this test)."""
    longer = {"batches": 32, "pace_s": 0.1, "keys": 16}
    phase1 = run_cluster(_port_spec(tmp_path, 3, **longer),
                         kill_after_commits=2)
    assert phase1["status"] == "killed" and phase1["commits"]
    result = _restore_at(tmp_path, 2,
                         tj.numpy_oracle(dict(JOB_ARGS, **longer)), **longer)
    assert sorted(result["workers"]) == ["0", "1"]
    assert os.path.isdir(tmp_path / "state" / "v1" / "worker_1")


def test_port_restores_and_rescales_a_jax_cluster_store(tmp_path, oracle):
    from denormalized_tpu.cluster import run_cluster as jrun

    jax_dir = tmp_path / "jax"
    phase1 = jrun(_spec(jax_dir, 3, "cluster_jobs:windowed_job"),
                  kill_after_commits=2)
    assert phase1["status"] == "killed" and phase1["commits"]
    same_n = tmp_path / "same_n"
    shutil.copytree(jax_dir, same_n,
                    ignore=shutil.ignore_patterns("*.sock"))
    _restore_at(same_n, 3, oracle)  # the JAX stores, read as they are
    _restore_at(jax_dir, 2, oracle)  # re-bucketed by the port


def _contribution(mod, seed, keys, first, last, w=16):
    rng = np.random.default_rng(seed)
    g = len(keys)
    meta = {
        "window_slots": w, "first_open": first, "max_win_seen": last,
        "watermark_ms": 1000 * first, "group_capacity": 128,
        "var_shift": {"0": 1.5}, "any_nulls_seen": False,
        "interner": {"columns": [list(keys)],
                     "rows": [(i,) for i in range(g)]},
    }
    arrays = {
        "count": rng.integers(1, 9, (w, 128)).astype(np.float32),
        "sum_0": rng.normal(size=(w, 128)).astype(np.float32),
        "min_0": rng.normal(size=(w, 128)).astype(np.float32),
    }
    spill = {first - 1: {label: a[(first - 1) % w][:g].copy()
                         for label, a in arrays.items()}}
    return mod._WindowContribution(meta, arrays, spill)


def test_target_snapshot_matches_the_reference_where_covered():
    """The same contributions re-bucket to the same interner, meta and
    covered cells in both packages.  Cells no contribution covers hold
    the plane's empty value in the port (+inf for min, -inf for max) and
    zero in the JAX package — the reference's fault (ROADMAP §C): a min
    or max later folded into such a cell reads 0."""
    keys_a = [f"s{i:04d}" for i in range(0, 40, 2)]
    keys_b = [f"s{i:04d}" for i in range(1, 40, 2)]
    built = {}
    for name, mod in (("port", trescale), ("jax", jrescale)):
        ca = _contribution(mod, 1, keys_a, 5, 9)
        cb = _contribution(mod, 2, keys_b, 6, 12)
        cols_a = mod._typed_key_columns(ca.key_tuples, ["obj"])
        cols_b = mod._typed_key_columns(cb.key_tuples, ["obj"])
        ba = trescale.bucket_rows(cols_a, 2)
        bb = trescale.bucket_rows(cols_b, 2)
        built[name] = [
            mod._build_target_snapshot(
                [(ca, np.nonzero(ba == t)[0]), (cb, np.nonzero(bb == t)[0])],
                7)
            for t in range(2)
        ]
    for (tm, ta), (jm, ja) in zip(built["port"], built["jax"]):
        assert tm == jm
        assert list(ta) == list(ja)
        for label in ta:
            # contributed cells are nonzero (see _contribution)
            covered = ja[label] != 0
            assert covered.any() and (~covered).any()
            np.testing.assert_array_equal(ta[label][covered],
                                          ja[label][covered])
            assert (ta[label][~covered] == trescale._identity(label)).all()
        assert np.isposinf(ta["min_0"][ja["min_0"] == 0]).all()


def test_var_shift_merge_and_divergence_like_the_reference():
    a = _contribution(trescale, 1, ["a"], 1, 2)
    b = _contribution(trescale, 2, ["b"], 1, 2)
    assert trescale._merge_var_shift([a, b]) == {"0": 1.5}
    b.meta["var_shift"] = {"0": 2.5}
    with pytest.raises(StateError, match="pivots diverge"):
        trescale._merge_var_shift([a, b])
    ja = _contribution(jrescale, 1, ["a"], 1, 2)
    jb = _contribution(jrescale, 2, ["b"], 1, 2)
    jb.meta["var_shift"] = {"0": 2.5}
    with pytest.raises(Exception, match="pivots diverge"):
        jrescale._merge_var_shift([ja, jb])
