"""The port's soak (tools/torch_soak.py) on the CPU: twins of
tests/test_soak_smoke.py for the window pipelines (tumbling and sliding
over the soak's paced source, tumbling over a Kafka topic of the port's
mock broker), the child's isolation from JAX, its refusal to run without a
card, and the device gates' arithmetic.  The soak's tests are spread over
three files (this one, ``_join`` and ``_host``) so that each takes about
two minutes."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))

from torch_soak_run import REPO, SMOKE, SOAK, assert_golden, run_soak  # noqa: E402


@pytest.mark.parametrize("pipeline", ["simple", "sliding", "kafka"])
def test_torch_soak_smoke(tmp_path, pipeline):
    """A ~20 s feed SIGKILLed every 8 s and restored: zero windows lost,
    spurious or mismatched against the JAX soak's golden, EOS seen, every
    recovery under 30 s, the child free of ``jax`` and
    ``denormalized_tpu`` at its exit line."""
    assert_golden(run_soak(tmp_path, pipeline, SMOKE))


def test_child_without_a_card_exits_nonzero(tmp_path):
    """``--device cuda`` on a host without CUDA: the child exits non-zero
    and writes no window, rather than fall back to the CPU."""
    out = tmp_path / "emit.jsonl"
    env = dict(os.environ, SOAK_DEVICE="cuda", SOAK_PIPELINE="simple",
               SOAK_BATCH_ROWS="4096", SOAK_PACE="150000",
               SOAK_TOTAL_BATCHES="10", SOAK_CKPT_DIR=str(tmp_path / "ck"),
               SOAK_OUT=str(out))
    proc = subprocess.run([sys.executable, str(SOAK), "--child"], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not out.exists() or '"ws"' not in out.read_text()


def _records(tmp_path, alloc_at, launches, t0=1000.0, n=100):
    """A segment file with a ready line and ``n`` one-second device lines
    (``alloc_at(i)`` bytes at second i)."""
    import json

    p = tmp_path / "seg.jsonl"
    with open(p, "w") as f:
        f.write(json.dumps({"event": "ready", "device_name": "card",
                            "imports_s": 1.0, "cuda_ready_s": 2.0,
                            "kernels_loaded_s": 2.5}) + "\n")
        for i in range(n):
            f.write(json.dumps({
                "event": "device", "t": t0 + i, "alloc": alloc_at(i),
                "reserved": 2 * alloc_at(i), "max_alloc": alloc_at(i),
                "rss_kb": 1000, "launches": launches}) + "\n")
        f.write('{"event": "device", "t": 10')  # a torn tail (SIGKILL)
    return p


def test_device_gates_hold_a_flat_run_and_refuse_a_leak(tmp_path):
    """The memory gate: a segment run 90 s past its first emission with
    flat device memory passes, one leaking 1 MiB a second over a 64 MiB
    ring fails; a short segment is not gated.  The launch gate: a restored
    segment that launches another set of kernels than the first fails."""
    from tools import torch_soak

    mib = 1 << 20
    dense = {"dense_window": 5, "merge_partials": 0, "compact_slot": 0}
    flat = torch_soak.segment_device_report(
        _records(tmp_path, lambda i: 64 * mib + (i % 3) * 4096, dense),
        1005.0, [(1005.0 + i, 2000 + i) for i in range(80)])
    assert flat["mem_gate"]["applies"] and flat["mem_gate"]["ok"]
    assert flat["device_mem"]["at_first_emit"]["alloc"] == 64 * mib + 8192
    assert flat["rss_kb"]["slope_kb_per_s"] == pytest.approx(1.0)
    assert flat["startup"] == {"imports_s": 1.0, "cuda_ready_s": 2.0,
                               "kernels_loaded_s": 2.5}
    leak = torch_soak.segment_device_report(
        _records(tmp_path, lambda i: 64 * mib + i * mib, dense), 1005.0, [])
    assert leak["mem_gate"]["applies"] and not leak["mem_gate"]["ok"]
    assert leak["device_mem"]["alloc_slope_bytes_per_s"] == pytest.approx(mib)
    short = torch_soak.segment_device_report(
        _records(tmp_path, lambda i: i * mib, dense, n=40), 1005.0, [])
    assert not short["mem_gate"]["applies"]

    segs = [dict(segment=i + 1, **rep) for i, rep in
            enumerate([flat, flat, short])]
    g = torch_soak.device_gates(segs)
    assert g["memory"]["segments_gated"] == 2 and g["memory"]["ok"]
    assert g["launches"]["ok"]
    other = dict(short, launches={**dense, "compact_slot": 1})
    g = torch_soak.device_gates(segs[:2] + [dict(segment=3, **other)])
    assert not g["launches"]["ok"]
    assert g["launches"]["restored_differing"] == [3]
    g = torch_soak.device_gates(segs[:1] + [dict(segment=2, **leak)])
    assert not g["memory"]["ok"] and g["launches"]["ok"]
