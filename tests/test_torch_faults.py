"""The port's completed fault plan against the JAX package's: the same plan
and seed fire at the same calls, tear at the same byte and log the same
events in both packages (prob, after, times, key_substr, site globs, the
latency kind, the torn kind), over every site the JAX package has,
the six cluster sites included; unknown sites and kinds are refused alike;
``DENORMALIZED_FAULT_PLAN`` arms a child process; and a firing counts in
``dnz_fault_injections_total`` and lands on the span stream."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from denormalized_tpu_torch import obs as tobs
from denormalized_tpu_torch.common.errors import SourceError as TSourceError
from denormalized_tpu_torch.common.errors import StateError as TStateError
from denormalized_tpu_torch.runtime import faults as tfaults

from denormalized_tpu.common.errors import SourceError as JSourceError
from denormalized_tpu.common.errors import StateError as JStateError
from denormalized_tpu.runtime import faults as jfaults

REPO = Path(__file__).resolve().parents[1]
CLUSTER_SITES = ("exchange.connect", "exchange.send", "exchange.recv",
                 "exchange.reconnect", "cluster.rejoin", "cluster.replay")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    tfaults.disarm()
    jfaults.disarm()


def _spec(seed: int) -> dict:
    return {
        "seed": seed,
        "rules": [
            {"site": "kafka.fetch", "kind": "error", "prob": 0.1,
             "times": 5, "message": "recv: flap"},
            {"site": "lsm.put", "kind": "torn", "key_substr": "@",
             "prob": 0.5, "times": 3},
            {"site": "exchange.*", "kind": "torn", "prob": 0.3,
             "after": 4, "times": 4, "name": "tear-edges"},
            {"site": "exchange.reconnect", "kind": "latency", "ms": 0.5,
             "prob": 0.5},
            {"site": "cluster.rejoin", "kind": "error", "after": 2,
             "times": 1},
            {"site": "*", "kind": "error", "prob": 0.02, "error": "state"},
        ],
    }


def _drive(mod, errors, plan, n=240):
    """A fixed call sequence over every site → (results, event log): each
    call's outcome is its returned payload, or its error class and text."""
    out = []
    sites = sorted(mod.SITES)
    for i in range(n):
        site = sites[i % len(sites)]
        payload = bytes(range(i % 200 + 17)) if i % 3 else None
        key = f"w{i % 4}@{i}" if i % 2 else f"edge{i % 5}"
        try:
            got = plan.on(site, key=key, payload=payload)
            out.append(("ok", site, got))
        except errors as e:
            out.append((type(e).__name__, site, str(e)))
    return out, plan.event_log()


@pytest.mark.parametrize("seed", [0, 7, 99, 2024])
def test_same_plan_and_seed_fire_alike_in_both_packages(seed):
    t_out, t_log = _drive(tfaults, (TSourceError, TStateError),
                          tfaults.FaultPlan(_spec(seed)))
    j_out, j_log = _drive(jfaults, (JSourceError, JStateError),
                          jfaults.FaultPlan(json.dumps(_spec(seed))))
    assert t_log and t_log == j_log
    assert t_out == j_out
    kinds = {e["kind"] for e in t_log}
    assert {"error", "torn"} <= kinds


def test_sites_match_the_reference():
    assert set(tfaults.SITES) == set(jfaults.SITES)
    assert set(CLUSTER_SITES) <= set(tfaults.SITES)
    for site, cls in tfaults.SITES.items():
        assert cls.__name__ == jfaults.SITES[site].__name__, site


def test_schedule_times_after_and_heal():
    plan = tfaults.FaultPlan({"rules": [
        {"site": "exchange.send", "kind": "error", "after": 2, "times": 2}]})
    outcomes = []
    for _ in range(6):
        try:
            plan.on("exchange.send", key="0->1")
            outcomes.append("ok")
        except TSourceError:
            outcomes.append("err")
    assert outcomes == ["ok", "ok", "err", "err", "ok", "ok"]


def test_torn_cut_is_seeded_and_keeps_budget_without_payload():
    def cut(mod, seed):
        plan = mod.FaultPlan({"seed": seed, "rules": [
            {"site": "exchange.send", "kind": "torn", "times": 1}]})
        assert plan.on("exchange.send", key="e") is None  # no payload
        frame = bytes(1000)
        return len(plan.on("exchange.send", key="e", payload=frame))

    cuts = {cut(tfaults, s) for s in range(6)}
    assert cuts == {cut(jfaults, s) for s in range(6)}
    assert len(cuts) > 1 and max(cuts) < 1000  # seeded, not the half


def test_latency_kind_sleeps():
    plan = tfaults.arm({"rules": [
        {"site": "exchange.reconnect", "kind": "latency", "ms": 30}]})
    t0 = time.perf_counter()
    assert tfaults.inject("exchange.reconnect", key="0->1") is None
    assert time.perf_counter() - t0 >= 0.025
    assert plan.event_log()[0]["ms"] == 30


@pytest.mark.parametrize("rule, match", [
    ({"site": "lsm.putt"}, "matches no known site"),
    ({"site": "exchang.*"}, "matches no known site"),
    ({"site": "lsm.put", "kind": "explode"}, "unknown kind"),
])
def test_bad_rules_refused_alike(rule, match):
    with pytest.raises(ValueError, match=match):
        tfaults.FaultPlan({"rules": [rule]})
    with pytest.raises(ValueError, match=match):
        jfaults.FaultPlan({"rules": [rule]})


def test_error_class_by_site_and_override():
    plan = tfaults.FaultPlan({"rules": [
        {"site": "cluster.rejoin", "kind": "error", "times": 1},
        {"site": "exchange.recv", "kind": "error", "error": "state",
         "times": 1}]})
    with pytest.raises(TStateError):
        plan.on("cluster.rejoin")
    with pytest.raises(TStateError):
        plan.on("exchange.recv")
    assert tfaults.inject("exchange.recv") is None  # unarmed: identity


def test_firing_counts_and_lands_on_the_span_stream():
    reg = tobs.MetricsRegistry(enabled=True)
    rec = tobs.enable_span_recording()
    try:
        with tobs.bound_registry(reg):
            plan = tfaults.FaultPlan({"rules": [
                {"site": "exchange.connect", "kind": "error", "times": 2}]})
            for _ in range(3):
                try:
                    plan.on("exchange.connect", key="0->1")
                except TSourceError:
                    pass
        names = [e[2] for e in rec.events()]
    finally:
        tobs.disable_span_recording()
    assert reg.snapshot() == {
        'dnz_fault_injections_total{site="exchange.connect"}': 2}
    assert names.count("fault.exchange.connect") == 2


def test_env_arming_in_a_child(tmp_path):
    plan = {"seed": 3, "rules": [
        {"site": "exchange.send", "kind": "torn", "times": 1}]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    code = (
        "from denormalized_tpu_torch.runtime import faults\n"
        "assert faults.armed()\n"
        "p = faults.inject('exchange.send', key='e', payload=bytes(500))\n"
        "print(len(p))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO),
               DENORMALIZED_FAULT_PLAN=f"@{path}")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = len(jfaults.FaultPlan(plan).on("exchange.send", key="e",
                                          payload=bytes(500)))
    assert int(out.stdout.strip()) == want
    env["DENORMALIZED_FAULT_PLAN"] = "{not json"
    bad = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0
    assert "DENORMALIZED_FAULT_PLAN is set but unusable" in bad.stderr
