"""Cluster job specification — the JSON contract between coordinator and
worker processes.

Counterpart of ``denormalized_tpu/cluster/spec.py`` (the same fields and
JSON).

A **job** is a named factory ``module:function`` the worker imports and
calls with ``job_args``; it returns a dict::

    {"source":  Source,                       # the FULL source (all partitions)
     "pipeline": fn(DataStream) -> DataStream,  # the keyed query
     "engine":  {EngineConfig overrides, optional}}

No pickling anywhere: the factory is resolved by name inside each worker
process, so jobs compose exactly like soak/bench child pipelines do
(tools/soak.py child_main).  ``sys_path`` entries let tests point
workers at job modules that live outside the installed package.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import asdict, dataclass, field


@dataclass
class ClusterSpec:
    """Everything a cluster run needs, JSON-serializable."""

    workdir: str  # sockets, per-worker stores, outputs, obs JSONL
    n_workers: int
    job: str  # "module:function"
    job_args: dict = field(default_factory=dict)
    sys_path: list = field(default_factory=list)
    # checkpointing: barrier cadence (None = only coordinator-triggered
    # barriers via Coordinator.trigger_barrier / none at all)
    checkpoint_interval_s: float | None = None
    # emission sink: "jsonl" (full epoch-tagged rows, the exactly-once
    # soak/test protocol) or "count" (rows counted, bench mode)
    sink: str = "jsonl"
    # supervision: full-cluster restarts allowed before giving up.
    # Budgets bound failure RATE, not lifetime: every restart opens a
    # per-scope streak, and a crash-free ``restart_heal_s`` interval
    # refunds the streak's tokens (the prefetch supervisor's
    # streak+refund pattern, one level up) — so a days-long stream with
    # occasional healed deaths never converges to a guaranteed kill,
    # while a crash-storm still exhausts the budget promptly.
    max_restarts: int = 3
    # partial recovery: a dead worker (with checkpointing on and at
    # least one cluster commit) is respawned ALONE, pinned to the last
    # committed epoch, while surviving workers keep streaming; falls
    # back to the full-cluster restart when ineligible or when the
    # rejoin exceeds its budget (docs/cluster.md#failure-matrix)
    partial_recovery: bool = True
    # single-worker respawns tolerated per worker within one heal
    # interval before that worker's failures escalate to the
    # full-cluster path (which spends ``max_restarts`` tokens)
    worker_max_restarts: int = 3
    # crash-free seconds after which restart streaks heal and their
    # tokens are refunded (per worker AND cluster-global)
    restart_heal_s: float = 30.0
    # seconds a respawned worker gets to finish the rejoin handshake
    # (ready event with echoed partition subset) before the
    # coordinator abandons partial recovery for the full restart
    rejoin_timeout_s: float = 60.0
    # sender-side replay buffer cap per edge (frames retained since the
    # last cluster-committed barrier); overflow evicts oldest and
    # forces the full-cluster fallback if a replay would have needed
    # the evicted frames
    replay_buffer_bytes: int = 64 << 20
    # seconds with no worker liveness signal before the run is declared
    # wedged (workers heartbeat on epoch acks and EOS)
    liveness_timeout_s: float = 120.0
    # obs: per-worker JSONL metrics snapshots (merged by
    # ``python -m denormalized_tpu_torch.obs.readers merge``)
    metrics_jsonl: bool = False
    # fault plan JSON armed in every worker (DENORMALIZED_FAULT_PLAN)
    fault_plan: dict | None = None
    # arm the fault plan in the FIRST worker generation only: a
    # "times: 1" rule re-arms from zero in every respawned incarnation,
    # which would re-fire forever and burn the restart budget — the
    # soak wants one injected fault, then a clean recovery
    fault_plan_once: bool = True

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        return cls(**json.loads(text))


def resolve_job(spec: ClusterSpec) -> dict:
    """Import and call the job factory (inside the worker process)."""
    import sys

    for p in spec.sys_path:
        if p not in sys.path:
            sys.path.insert(0, p)
    mod_name, _, fn_name = spec.job.partition(":")
    if not fn_name:
        raise ValueError(
            f"job {spec.job!r} must be 'module:function'"
        )
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name)
    job = fn(dict(spec.job_args))
    if "source" not in job or "pipeline" not in job:
        raise ValueError(
            f"job factory {spec.job!r} must return a dict with "
            "'source' and 'pipeline'"
        )
    return job
