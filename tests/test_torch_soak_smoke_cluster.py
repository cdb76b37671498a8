"""The port's cluster soak (``tools/torch_soak.py --pipeline cluster``) on
the CPU: the twin of ``tools/soak.py --pipeline cluster``'s smoke (both
cells, every gate of the JAX tool plus a kill after a committed epoch and
every worker's last generation on the job's device), its oracle held to
the JAX package's, the gates' arithmetic on synthetic coordinator
results, and the parent's and workers' isolation from JAX."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))

from torch_soak_run import REPO, run_soak  # noqa: E402

from tools import torch_soak  # noqa: E402

#: the JAX cluster smoke's settings: 210 batches a partition, 6 partitions
#: over 3 workers (~21 s of stream a worker, its two partitions in turn),
#: the victim killed 4.2 s after the last ready line
CLUSTER_SMOKE = ["--minutes", "0.35"]


def test_torch_soak_cluster_smoke(tmp_path):
    """Both cells over 3 CPU workers (one torch thread each): the clipped
    union exactly once against the oracle, the torn frame fired, a kill
    after a committed epoch, at least 2 full restarts in ``full_restart``,
    only the victim respawned in ``partial``, with its recovery timed."""
    r = run_soak(tmp_path, "cluster", CLUSTER_SMOKE, timeout=480)
    assert r["ok"] and r["parent_foreign_modules"] == [], r
    assert set(r["cells"]) == {"full_restart", "partial"}
    for mode, c in r["cells"].items():
        assert c["gates"] and all(c["gates"].values()), (mode, c["gates"])
        assert c["status"] == "done", c
        assert c["oracle_windows"] > 0, c
        assert c["emitted_windows_kept"] == c["oracle_windows"], c
        assert (c["lost"], c["spurious"], c["duplicate_emissions"]) == (
            0, 0, 0), c
        assert c["sigkills"] >= 1 and c["exchange_faults_fired"] >= 1, c
        assert any(k["committed"] and k["worker"] == 2
                   and k["after_ready_s"] >= c["kill_delay_s"]
                   for k in c["kills"]), c["kills"]
        assert sorted(c["workers"]) == ["0", "1", "2"], c["workers"]
        assert all(w["device"] == "cpu" for w in c["workers"].values())
        assert len(c["startups"]) >= 3 and all(
            s["s"] > 0 for s in c["startups"]), c["startups"]
        assert c["worker_probes"] >= 3 and c["worker_foreign_modules"] == []
        assert c["wall_s"] < 240, c
    full, part = r["cells"]["full_restart"], r["cells"]["partial"]
    assert full["restarts"] >= 2, full
    assert part["restarts"] == 0 and part["worker_restarts"] >= 1, part
    assert part["partial_segments"] and all(
        s["worker"] == 2 and s["restored"] >= 1
        for s in part["partial_segments"]), part["partial_segments"]
    assert any(rec["worker"] == 2 and rec["ms"] > 0
               for rec in part["recoveries"]), part["recoveries"]
    assert part["recovery_ms_histogram"]["count"] >= 1, part


def test_torch_cluster_oracle_matches_the_jax_package():
    """The port's ``benchjob.oracle_rows`` over the soak cell's job (20
    batches a partition, unpaced) equals the JAX package's: windows, keys
    and counts exact, sums, minima and maxima within rtol 1e-5."""
    from denormalized_tpu.cluster import benchjob as jbench
    from denormalized_tpu_torch.cluster import benchjob as tbench

    args = torch_soak.cluster_job_args(types.SimpleNamespace(
        cluster_partitions=6, minutes=0.0, batch_rows=4096, device="cpu"))
    assert (args["batches"], args["rows"], args["keys"]) == (20, 1024, 97)
    args["pace_s"] = 0.0
    port = tbench.oracle_rows(args, string_keys=True)
    jax_args = {k: v for k, v in args.items() if k != "engine"}
    want = jbench.oracle_rows(jax_args, string_keys=True)
    assert len(port) == len(want) > 0
    assert [r[:4] for r in port] == [r[:4] for r in want]
    np.testing.assert_allclose(np.array([r[4:] for r in port]),
                               np.array([r[4:] for r in want]), rtol=1e-5)


def _cell(**kw) -> dict:
    """A synthetic cell that holds every gate of the partial cell."""
    cell = {
        "status": "done", "lost": 0, "spurious": 0, "duplicate_emissions": 0,
        "sigkills": 1, "exchange_faults_fired": 1,
        "kills": [{"worker": 2, "committed": 3, "after_ready_s": 4.2}],
        "workers": {str(w): {"device": "cuda:0", "dense_window_launches": 40}
                    for w in range(3)},
        "worker_probes": 3, "worker_foreign_modules": [],
        "restarts": 0, "worker_restarts": 2,
        "partial_segments": [{"worker": 2, "restored": 1},
                             {"worker": 2, "restored": 3}],
        "recoveries": [{"worker": 2, "ms": 9000.0},
                       {"worker": 2, "ms": 8000.0}],
        "recovery_ms_histogram": {"count": 2},
    }
    cell.update(kw)
    return cell


def _failed(cell, partial=True, device="cuda") -> list:
    gates = torch_soak.cluster_gates(cell, partial=partial, victim=2, n=3,
                                     device=device)
    return sorted(k for k, v in gates.items() if not v)


def test_cluster_gates_on_synthetic_results():
    """A kill before any commit fails the added gate alone; a survivor's
    partial segment fails the partial cell; a worker off the card, or one
    on it with no dense launch, fails the card gate; the full-restart cell
    needs two restarts."""
    assert _failed(_cell()) == []
    before = _cell(kills=[{"worker": 2, "committed": None,
                           "after_ready_s": 4.2}])
    assert _failed(before) == ["kill_after_commit"]
    assert _failed(dict(before, restarts=2), partial=False) == [
        "kill_after_commit"]
    survivor = _cell(partial_segments=[{"worker": 2, "restored": 1},
                                       {"worker": 0, "restored": 1}])
    assert _failed(survivor) == ["partial_only_victim"]
    assert _failed(_cell(restarts=1)) == ["no_full_restart"]
    assert _failed(_cell(restarts=1), partial=False) == ["restarts"]
    off = _cell()
    off["workers"]["1"] = {"device": "cpu", "dense_window_launches": 0}
    assert _failed(off) == ["card"]
    idle = _cell()
    idle["workers"]["2"] = {"device": "cuda:0", "dense_window_launches": 0}
    assert _failed(idle) == ["card"]
    cpu = _cell(workers={str(w): {"device": "cpu", "dense_window_launches": 0}
                         for w in range(3)})
    assert _failed(cpu, device="cpu") == []
    assert _failed(_cell(exchange_faults_fired=0, sigkills=0)) == [
        "killed", "torn_frame_fired"]
    assert _failed(_cell(worker_foreign_modules=["jax"])) == [
        "worker_modules"]


def test_cluster_soak_holds_no_jax(tmp_path):
    """A parent that runs the soak's job over 2 CPU workers ends with
    neither ``jax`` nor ``denormalized_tpu`` in ``sys.modules``, and so
    does every worker (the job's exit probe)."""
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from tools import torch_soak
from denormalized_tpu_torch.cluster import ClusterSpec, run_cluster
args = dict(partitions=2, batches=4, rows=64, keys=97, batch_span_ms=250,
            window_ms=1000, pace_s=0.0, engine={{"device": "cpu"}},
            probe={str(tmp_path / "probe")!r})
res = run_cluster(ClusterSpec(
    workdir={str(tmp_path / "w")!r}, n_workers=2,
    job="tools.torch_soak:cluster_soak_job", job_args=args,
    sys_path=[{str(REPO)!r}], liveness_timeout_s=120.0))
print(json.dumps({{"status": res["status"],
                   "foreign": torch_soak._foreign_modules()}}))
"""
    env = dict(os.environ, DENORMALIZED_WORKER_TORCH_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"status": "done", "foreign": []}, out
    probes = sorted(tmp_path.glob("probe.*"))
    assert len(probes) == 2
    assert all(json.loads(p.read_text()) == [] for p in probes)


def test_reader_clips_everything_before_a_restart_from_no_commit(tmp_path):
    """A full restart before the first cluster commit (restored None)
    re-emits every window: the reader drops all of the earlier
    generation's tagged rows, and clips past a restore epoch as before."""
    from denormalized_tpu_torch.cluster.reader import read_cluster

    def seg(gen, restored, rows):
        path = tmp_path / f"g{gen}.jsonl"
        path.write_text("".join(json.dumps(o) + "\n" for o in (
            [{"event": "restored", "epoch": restored or 0}] + rows)))
        return {"gen": gen, "restored": restored, "files": [str(path)]}

    segs = [seg(0, None, [{"w": 0, "ep": 1}, {"w": 1, "ep": 1}]),
            seg(1, None, [{"w": 0, "ep": 1}, {"w": 1, "ep": 2},
                          {"w": 2, "ep": 3}]),
            seg(2, 2, [{"w": 2, "ep": 3}, {"w": 3, "ep": 4}])]
    got = read_cluster(segs)
    assert sorted(o["w"] for o in got["rows"]) == [0, 1, 2, 3]
    assert got["clipped"] == 3
