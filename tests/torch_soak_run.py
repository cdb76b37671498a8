"""Runs ``tools/torch_soak.py`` on the CPU for the port's soak smoke tests
(``tests/test_torch_soak_smoke*.py``) and holds a report to the gates the
JAX package's soak smoke tests hold (``tests/test_soak_smoke.py``)."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOAK = REPO / "tools" / "torch_soak.py"

#: the JAX smoke settings: a ~20 s feed with SIGKILLs every 8 s
SMOKE = ["--minutes", "0.35", "--kill-every", "8", "--pace", "150000"]
#: the query-dense and join-dense smoke settings
DENSE_SMOKE = ["--minutes", "0.5", "--kill-every", "8", "--pace", "40000",
               "--batch-rows", "2048"]


def run_soak(tmp_path, pipeline, args, timeout=240) -> dict:
    """One soak on the CPU → its JSON report (asserting the parent's exit
    code only after the report is read, so a failure shows the report).
    Each child takes one torch thread: several soaks share the host, and
    a thread a core each made them oversubscribe it."""
    out = tmp_path / "soak.json"
    sel = ["--chaos"] if pipeline == "chaos" else ["--pipeline", pipeline]
    proc = subprocess.run(
        [sys.executable, str(SOAK), *sel, "--device", "cpu",
         "--torch-threads", "1", *args, "--out", str(out)],
        capture_output=True, text=True, timeout=timeout,
    )
    assert out.exists(), proc.stderr[-2000:]
    r = json.loads(out.read_text())
    assert proc.returncode == 0, (
        {k: v for k, v in r.items() if k != "segments"}, proc.stderr[-1200:])
    return r


def assert_common(r: dict) -> None:
    """The gates every pipeline shares: no abort, EOS, a kill, prompt
    recoveries, a child free of JAX, and both device gates."""
    assert r["aborted"] is None, r
    assert r["eos_done_seen"], r
    assert r["kills"] >= 1, r
    for t in r["recovery_first_emit_s"]:
        assert t < 30, r
    assert r["child_foreign_modules"] == [], r
    gates = r["device_gates"]
    assert gates["memory"]["ok"] and gates["launches"]["ok"], gates
    assert len(r["segments"]) == r["kills"] + 1, r
    for s in r["segments"]:
        assert s["device_name"] == "cpu", s
        assert s["startup"]["imports_s"] is not None, s
        assert s["device_samples"] >= 1, s
    assert r["ok"], r


def assert_golden(r: dict) -> None:
    """The JAX soak smoke's window gates."""
    assert_common(r)
    assert r["windows_lost"] == 0, r
    assert r["windows_spurious"] == 0, r
    assert r["windows_mismatched"] == 0, r
    assert r["emitted_windows"] == r["golden_windows"] > 0, r


def assert_dense(r: dict, key: str, min_backfilled: int) -> None:
    """The JAX query-dense / join-dense soak smoke's gates."""
    assert_common(r)
    d = r[key]
    assert d["oracle_rc"] == 0, d
    assert d["oracle_windows"] > 0, d
    assert d["failures"] == 0, d
    assert d["queries_silent"] == [], d
    assert d["backfill_missing"] == [], d
    assert d["backfilled_joiners"] >= min_backfilled, d
    assert d["max_builds_per_segment"] == 1, d
