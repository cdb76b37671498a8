"""Cluster doctor pass — per-worker recovery state + health verdicts.

Counterpart of ``denormalized_tpu/obs/doctor/clusterdoc.py``.

The coordinator (cluster/coordinator.py) maintains
``meta/cluster_state.json`` as its supervision state machine moves:
per-worker incarnation number (``gen``), last acked epoch, and whether
the worker is up / mid-rejoin / at EOS, plus the cluster commit
frontier and every aborted epoch.  This module turns that snapshot into
the same contract the state observatory ships (statedoc.py): RANKED
verdicts (severity desc) with the rule text included verbatim in every
payload, so a dashboard never has to guess what a verdict means.

Stdlib-only on the read path — soak parents and external tooling load
it against a workdir without importing the engine."""

from __future__ import annotations

import json
import os
import time

#: verdict rules, shipped verbatim in every cluster payload
CLUSTER_VERDICT_RULES = (
    "recovering-worker: a worker is mid-rejoin (respawned, not yet "
    "ready) — barriers are held and its exchange edges are buffering; "
    "escalates to the full-cluster fallback if the rejoin exceeds "
    "rejoin_timeout_s; "
    "degraded-edge: an exchange edge touches a recovering or silent "
    "worker (or a worker reports nonzero dnz_exchange_edges_down) — "
    "senders buffer-or-backpressure and redial with bounded backoff; "
    "restart-storm: one worker's incarnation number reached the "
    "per-worker budget (worker_max_restarts={cap}) without a healing "
    "interval — its next death escalates to a full-cluster restart; "
    "stale-ack: an up worker's last acked epoch lags the cluster "
    "commit frontier by >= {stale} epochs — it is alive but falling "
    "behind the barrier cadence."
)

STALE_ACK_EPOCHS = 3


def rules_text(worker_max_restarts: int = 3) -> str:
    return CLUSTER_VERDICT_RULES.format(
        cap=worker_max_restarts, stale=STALE_ACK_EPOCHS
    )


def verdicts(state: dict, edges_down: dict | None = None) -> list[dict]:
    """Ranked health verdicts over one coordinator state snapshot.

    ``edges_down`` optionally maps worker-id strings to that worker's
    current ``dnz_exchange_edges_down`` gauge reading (from the merged
    obs JSONL) — degraded edges are otherwise inferred from recovery
    state alone."""
    out: list[dict] = []
    workers = state.get("workers", {})
    n = int(state.get("n_workers") or len(workers))
    committed = int(state.get("committed_epoch") or 0)
    cap = int(state.get("worker_max_restarts") or 3)
    for wid, w in sorted(workers.items(), key=lambda kv: kv[0]):
        gen = int(w.get("gen") or 0)
        st = w.get("state")
        if st == "recovering":
            out.append({
                "kind": "recovering-worker",
                "worker": wid,
                "severity": 0.8,
                "gen": gen,
                "detail": (
                    f"worker {wid} is mid-rejoin (incarnation {gen}); "
                    f"peers keep streaming but barriers are held and "
                    f"{2 * max(0, n - 1)} exchange edges are degraded "
                    "until it reports ready"
                ),
            })
            out.append({
                "kind": "degraded-edge",
                "worker": wid,
                "severity": 0.6,
                "edges": 2 * max(0, n - 1),
                "detail": (
                    f"every edge into or out of worker {wid} is "
                    "buffering-or-down while it rejoins — senders hold "
                    "frames since the last cluster commit and redial "
                    "with bounded backoff"
                ),
            })
        if gen >= cap > 0:
            out.append({
                "kind": "restart-storm",
                "worker": wid,
                "severity": 1.0,
                "gen": gen,
                "detail": (
                    f"worker {wid} burned its whole per-worker restart "
                    f"budget (incarnation {gen} of cap {cap}) without "
                    "healing — the next death falls back to a "
                    "full-cluster restart"
                ),
            })
        last_ack = w.get("last_ack_epoch")
        if (
            st == "up"
            and last_ack is not None
            and committed - int(last_ack) >= STALE_ACK_EPOCHS
        ):
            out.append({
                "kind": "stale-ack",
                "worker": wid,
                "severity": round(
                    min(1.0, (committed - int(last_ack)) / 10.0), 4
                ),
                "last_ack_epoch": int(last_ack),
                "committed_epoch": committed,
                "detail": (
                    f"worker {wid} last acked epoch {last_ack} while "
                    f"the cluster frontier is {committed} — alive but "
                    "behind the barrier cadence"
                ),
            })
    for wid, down in sorted((edges_down or {}).items()):
        if int(down) > 0:
            out.append({
                "kind": "degraded-edge",
                "worker": str(wid),
                "severity": 0.6,
                "edges": int(down),
                "detail": (
                    f"worker {wid} reports {int(down)} inbound "
                    "exchange edge(s) down "
                    "(dnz_exchange_edges_down) — a peer is dead, "
                    "mid-rejoin, or its last frame tore"
                ),
            })
    out.sort(key=lambda v: -v["severity"])
    return out


def cluster_snapshot(
    workdir: str, edges_down: dict | None = None
) -> dict:
    """The full cluster-doctor payload for one coordinator workdir."""
    path = os.path.join(workdir, "meta", "cluster_state.json")
    try:
        with open(path) as f:
            state = json.load(f)
    except (FileNotFoundError, ValueError):
        state = {}
    cap = int(state.get("worker_max_restarts") or 3)
    return {
        "t": time.time(),
        "state": state,
        "verdicts": verdicts(state, edges_down),
        "rules": rules_text(cap),
    }
