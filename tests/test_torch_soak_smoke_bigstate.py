"""The port's cold-tier soak (``tools/torch_soak.py --pipeline bigstate``)
on the CPU: the twin of ``tools/soak.py --pipeline bigstate``'s smoke
(every gate, a kill after a committed epoch with spilled state at the
cut), its unbudgeted sessions held to the JAX tool's, the gates'
arithmetic on synthetic lines, and the child's isolation from JAX."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))

from torch_soak_run import REPO, SOAK, run_soak  # noqa: E402

from tools import soak as S  # noqa: E402
from tools import torch_soak  # noqa: E402

#: the JAX bigstate smoke's settings; kills 5 s after each child's ready
#: line, past the first commit (~2 s in) and its spill copy
BIGSTATE_SMOKE = ["--keys", "200000", "--wave-keys", "20000", "--ckpt-s",
                  "2", "--kill-every", "5"]


def test_torch_soak_bigstate_smoke(tmp_path):
    """200,000 open sessions: the unbudgeted reference run, then the same
    feed under a fifth of its working set with the spill-site faults
    armed and SIGKILLs: every session byte-identical, the cold tier used
    and bounded, the RSS saving and the net ratio, every fault rule fired,
    a kill after a commit with spilled state at the cut."""
    r = run_soak(tmp_path, "bigstate", BIGSTATE_SMOKE)
    print(json.dumps({k: r[k] for k in (
        "rss_ratio_net", "rss_saved_mb", "rss_saved_required_mb")}
        | {"cuts": r["budgeted"]["cuts"]}))
    assert r["gates"] and all(r["gates"].values()), r["gates"]
    bud = r["budgeted"]
    assert r["reference"]["sessions"] == r["sessions_expected"] == (
        200_000 + 10 * torch_soak.BIGSTATE_WAVE_ROWS)
    assert bud["sessions"] == r["sessions_expected"], r
    assert (r["sessions_lost"], r["sessions_spurious"],
            r["sessions_mismatched"]) == (0, 0, 0), r
    assert bud["kills"] >= 1 and any(
        c["committed_epoch"] and c["spilled_bytes"] > 0
        for c in bud["cuts"]), bud["cuts"]
    assert bud["spill"]["spill_blocks_total"] > 0, bud["spill"]
    assert bud["evictable_state_bytes_max"] <= 1.25 * r["budget_bytes"]
    assert r["rss_saved_mb"] >= r["rss_saved_required_mb"], r
    assert r["rss_ratio_net"] <= torch_soak.BIGSTATE_RSS_RATIO_MAX, r
    assert r["chaos_spill"]["required_rules_fired"] == sorted(
        S.BIGSTATE_REQUIRED_RULES), r["chaos_spill"]
    assert r["child_foreign_modules"] == [], r
    gates = r["device_gates"]
    assert gates["memory"]["ok"] and gates["launches"]["ok"], gates
    assert len(r["segments"]) == 1 + bud["kills"] + 1, r["segments"]
    for s in r["segments"]:
        assert s["device_name"] == "cpu", s
        assert s["startup"]["imports_s"] is not None, s
        assert s["device_samples"] >= 1 and s["rss_ready_kb"] > 0, s


def _child_env(tmp_path, tag, keys, wave):
    a_batches = -(-keys // 4096)
    return dict(
        os.environ, JAX_PLATFORMS="cpu", SOAK_PIPELINE="bigstate",
        SOAK_BS_KEYS=str(keys), SOAK_BS_WAVE=str(wave), SOAK_BS_BUDGET="0",
        SOAK_BATCH_ROWS="4096", SOAK_PACE="200000",
        SOAK_TOTAL_BATCHES=str(a_batches + -(-keys // wave)),
        SOAK_CKPT_DIR=str(tmp_path / f"ck_{tag}"), SOAK_T0=str(S.T0),
        SOAK_OUT=str(tmp_path / f"{tag}.jsonl"), SOAK_DEVICE="cpu",
        SOAK_TORCH_THREADS="1")


def test_torch_bigstate_sessions_match_the_jax_package(tmp_path):
    """Both tools' unbudgeted bigstate children over 20,000 keys in waves
    of 2,000: the same sessions, counts, bounds, min and max exact, the
    average within rtol 1e-5."""
    procs = [subprocess.Popen(
        [sys.executable, str(tool), "--child"],
        env=_child_env(tmp_path, tag, 20_000, 2_000), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for tag, tool in (("jax", REPO / "tools" / "soak.py"),
                          ("port", SOAK))]
    for p in procs:
        _out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    jax_w, _d, jax_done, _m, _c = S.read_emissions([tmp_path / "jax.jsonl"])
    port_w, dupes, port_done, _m, _c = S.read_emissions(
        [tmp_path / "port.jsonl"])
    assert jax_done and port_done and dupes == 0
    assert len(jax_w) == 20_000 + 10 * torch_soak.BIGSTATE_WAVE_ROWS
    assert set(port_w) == set(jax_w)
    keys = sorted(jax_w)
    want = np.array([jax_w[k][0][0] for k in keys], dtype=np.float64)
    got = np.array([port_w[k][0][0] for k in keys], dtype=np.float64)
    # (count, min, max, avg, ws, we)
    exact = [0, 1, 2, 4, 5]
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-5)


def _state(t, epoch, spilled):
    return {"event": "state", "t": t, "bytes": 1000, "evictable": 100,
            "live_keys": 10, "spilled_bytes": spilled, "spilled_keys":
            spilled // 100, "spilled_blocks": int(spilled > 0),
            "committed_epoch": epoch}


def test_bigstate_gates_net_ratio_and_cuts(tmp_path):
    """The net RSS ratio passes a run whose raw ratio fails on the fixed
    RSS both runs hold; a kill before any commit, or after one with
    nothing spilled, is not a cut with spilled state; the saving and the
    other gates read the runs' numbers."""
    side = tmp_path / "seg.jsonl.state"
    lines = [{"event": "ready", "t": 100.0, "rss_kb": 4_900_000},
             _state(101.0, None, 5000), _state(102.0, 7, 0),
             _state(103.0, 7, 4000), _state(104.0, 8, 6000)]
    side.write_text("".join(json.dumps(o) + "\n" for o in lines)
                    + '{"event": "state", "t": 10')  # a torn tail
    before_commit = torch_soak.bigstate_cut(side, 101.5, lines[0])
    assert before_commit["committed_epoch"] is None
    assert before_commit["spilled_bytes"] == 5000
    assert before_commit["after_ready_s"] == 1.5
    nothing_spilled = torch_soak.bigstate_cut(side, 102.9, lines[0])
    assert (nothing_spilled["committed_epoch"],
            nothing_spilled["spilled_bytes"]) == (7, 0)
    good = torch_soak.bigstate_cut(side, 103.5, lines[0])
    assert (good["committed_epoch"], good["spilled_bytes"]) == (7, 4000)
    assert good["state_line_age_s"] == 0.5

    def seg(ready, peak):
        return {"rss_ready_kb": ready, "rss_max_kb": peak,
                "rss_net_max_kb": peak - ready}

    # a card child's ~4.9 GB before its first batch: raw 0.981, net 0.75
    ref = torch_soak.bigstate_rss([seg(4_900_000, 5_300_000)])
    bud = torch_soak.bigstate_rss([seg(4_900_100, 5_200_000),
                                   seg(4_899_900, 5_124_900)])
    assert bud == {"raw_max_kb": 5_200_000, "net_max_kb": 299_900,
                   "ready_kb": [4_900_100, 4_899_900]}
    assert bud["raw_max_kb"] / ref["raw_max_kb"] > 0.9

    def gates(cuts, bud_rss, working_set=200 << 20):
        return torch_soak.bigstate_gates(
            keys=1000, waves=2, working_set=working_set, budget=40 << 20,
            chaos_spill=True,
            ref={"aborted": None, "done": True, "rss": ref,
                 "sessions": 1000 + 2 * torch_soak.BIGSTATE_WAVE_ROWS},
            bud={"aborted": None, "done": True, "rss": bud_rss,
                 "lost": 0, "spurious": 0, "mismatched": 0, "cuts": cuts,
                 "spill": {"spill_blocks_total": 3},
                 "evictable_max": 50 << 20,
                 "fired_rules": {r: 1 for r in S.BIGSTATE_REQUIRED_RULES}})

    g = gates([before_commit, good], bud)
    assert all(g.values()), g
    g = gates([before_commit, nothing_spilled], bud)
    assert not g["kill_after_commit_with_spill"]
    assert [k for k, v in g.items() if not v] == [
        "kill_after_commit_with_spill"]
    assert not gates([], bud)["kills"]
    # a saving under 35% of the working set fails on its own
    g = gates([good], bud, working_set=400 << 20)
    assert [k for k, v in g.items() if not v] == ["rss_saved"]
    # net RSS above 0.9 of the reference's fails though the raw peaks
    # (5,200,000 against 5,300,000 kB) pass the saving
    worse = torch_soak.bigstate_rss([seg(4_800_000, 5_200_000)])
    g = gates([good], worse)
    assert [k for k, v in g.items() if not v] == ["rss_net_ratio"]


def test_bigstate_child_holds_no_jax(tmp_path):
    """The port's bigstate child ends with neither ``jax`` nor
    ``denormalized_tpu`` in ``sys.modules`` (its done line)."""
    env = _child_env(tmp_path, "port", 4_000, 1_000)
    proc = subprocess.run([sys.executable, str(SOAK), "--child"], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    done = [json.loads(line) for line in
            open(tmp_path / "port.jsonl.state")
            if '"done"' in line]
    assert len(done) == 1 and done[0]["foreign_modules"] == []
    assert S.read_emissions([tmp_path / "port.jsonl"])[2]



def _mem(rss, anon, arena, in_use, free, mmap, table, keys, lsm, ckpt):
    return {"rss_kb": rss, "anon_kb": anon, "private_dirty_kb": anon,
            "arena_kb": arena, "in_use_kb": in_use, "free_held_kb": free,
            "mmap_kb": mmap, "table_bytes": table, "interner_keys": keys,
            "interner_est_bytes": keys * 64, "lsm_keys": lsm,
            "ckpt_doc_bytes": ckpt}


def test_bigstate_owner_split_from_state_lines(tmp_path):
    """A segment's owner split: the state line nearest its RSS peak, each
    field's growth above the ready line's, its live and spilled keys; no
    split without a ready record or a state line; the segments' RSS and
    the gates read as before with the split beside them."""
    base = {"rss_kb": 4_900_000, "anon_kb": 150_000,
            "private_dirty_kb": 150_000, "arena_kb": 90_000,
            "in_use_kb": 88_000, "free_held_kb": 2_000, "mmap_kb": 4_000}
    ready = {"event": "ready", "t": 100.0, "rss_kb": 4_900_000, "mem": base}
    lines = [ready]
    for i, (keys, spilled, rss) in enumerate(
            ((40_000, 30_000, 4_930_000), (160_000, 150_000, 4_990_000),
             (120_000, 110_000, 4_985_000))):
        st = _state(101.0 + i, 7, spilled * 80)
        st.update(live_keys=keys, spilled_keys=spilled, mem=_mem(
            rss, 150_000 + rss - 4_900_000, 100_000 + i, 95_000, 5_000 + i,
            24_000, 6_000_000, keys, 40 + i, 10_000 * (i + 1)))
        lines.append(st)
    side = tmp_path / "seg.jsonl.state"
    side.write_text("".join(json.dumps(o) + "\n" for o in lines))
    own = torch_soak.bigstate_owners(side, ready, 102.3)
    assert own["peak_after_ready_s"] == 2.3
    assert own["line_after_ready_s"] == 2.0
    assert (own["live_keys"], own["spilled_keys"]) == (160_000, 150_000)
    assert set(own["at_line"]) == set(torch_soak.BIGSTATE_OWNER_FIELDS)
    assert own["at_line"]["interner_keys"] == 160_000
    assert own["at_line"]["ckpt_doc_bytes"] == 20_000
    assert own["above_ready_kb"] == {
        "rss_kb": 90_000, "anon_kb": 90_000, "private_dirty_kb": 90_000,
        "arena_kb": 10_001, "in_use_kb": 7_000, "free_held_kb": 3_001,
        "mmap_kb": 20_000}
    assert torch_soak.bigstate_owners(side, None, 102.3) is None
    assert torch_soak.bigstate_owners(
        side, {k: v for k, v in ready.items() if k != "mem"}, 102.3) is None
    bare = tmp_path / "bare.jsonl.state"
    bare.write_text(json.dumps(ready) + "\n")
    assert torch_soak.bigstate_owners(bare, ready, 102.3) is None

    def seg(ready_kb, peak):
        return {"rss_ready_kb": ready_kb, "rss_max_kb": peak,
                "rss_net_max_kb": peak - ready_kb, "owners": own}

    ref = torch_soak.bigstate_rss([seg(4_900_000, 5_010_000)])
    bud = torch_soak.bigstate_rss([seg(4_900_000, 4_990_000)])
    assert (ref["net_max_kb"], bud["net_max_kb"]) == (110_000, 90_000)
    def gates(working_set):
        return torch_soak.bigstate_gates(
            keys=1000, waves=2, working_set=working_set, budget=6 << 20,
            chaos_spill=True,
            ref={"aborted": None, "done": True, "rss": ref,
                 "sessions": 1000 + 2 * torch_soak.BIGSTATE_WAVE_ROWS},
            bud={"aborted": None, "done": True, "rss": bud, "lost": 0,
                 "spurious": 0, "mismatched": 0,
                 "cuts": [_state(103.0, 7, 4000)],
                 "spill": {"spill_blocks_total": 3},
                 "evictable_max": 1 << 20,
                 "fired_rules": {r: 1 for r in S.BIGSTATE_REQUIRED_RULES}})

    # net 90,000 / 110,000 = 0.818 <= 0.9; 20,000 kB saved >= 35% of a
    # 29 MiB working set (10.2 MiB), < 35% of 80 MiB (28 MiB)
    assert all(gates(29 << 20).values())
    assert [k for k, v in gates(80 << 20).items() if not v] == ["rss_saved"]


def test_bigstate_child_state_lines_carry_the_owner_split(tmp_path):
    """A budgeted bigstate child on the CPU writes the owner split into
    its ready line (the process's pages and heap) and every state line
    (plus the table, the interner, the LSM index and the last checkpoint
    document)."""
    env = _child_env(tmp_path, "port", 100_000, 10_000)
    env.update(SOAK_BS_BUDGET="3000000", SOAK_CKPT_S="0.5")
    proc = subprocess.run([sys.executable, str(SOAK), "--child"], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in open(tmp_path / "port.jsonl.state")
             if line.strip().endswith("}")]
    ready = [o for o in lines if o["event"] == "ready"]
    assert len(ready) == 1
    assert {"rss_kb", "anon_kb", "arena_kb", "in_use_kb",
            "free_held_kb"} <= set(ready[0]["mem"])
    states = [o for o in lines if o["event"] == "state"]
    assert states
    for o in states:
        assert set(torch_soak.BIGSTATE_OWNER_FIELDS) <= set(o["mem"]), o
        assert o["mem"]["interner_est_bytes"] == (
            o["mem"]["interner_keys"] * 64)
        assert o["mem"]["table_bytes"] > 0
        assert o["mem"]["lsm_keys"] is not None
