"""Deterministic, seedable fault injection at the I/O boundaries.

Counterpart of ``denormalized_tpu/runtime/faults.py``: the same plan
grammar, the same sites, and the same seeded decisions, so one plan with
one seed fires at the same calls and tears at the same byte in either
package.  A process-global :class:`FaultPlan` is threaded through named
**injection sites**::

    kafka.fetch         KafkaClient fetch           (raises SourceError)
    kafka.produce       KafkaClient produce         (raises SourceError)
    decode              decoder output, per rowful  (raises SourceError)
                        batch, both decode paths
    sink.write          KafkaSinkWriter.write       (raises SourceError)
    lsm.put             LsmStore.put                (StateError / torn value)
    lsm.get             LsmStore.get                (raises StateError)
    lsm.flush           LsmStore.flush              (raises StateError)
    checkpoint.commit   CheckpointCoordinator.commit(raises StateError)
    lsm.spill_put       SpillController.put_block   (StateError / torn value)
    lsm.spill_get       SpillController.get_block   (raises StateError)
    spill.manifest      SpillController.write_manifest (StateError / torn)
    exchange.connect    ExchangeClient.connect      (raises SourceError)
    exchange.send       ExchangeClient.send         (SourceError / torn frame)
    exchange.recv       exchange server recv loop   (raises SourceError)
    exchange.reconnect  ExchangeClient redial of a  (raises SourceError)
                        down edge, per attempt
    cluster.rejoin      respawned worker's rejoin   (raises StateError)
                        handshake, before ready
    cluster.replay      buffered-frame replay on a  (SourceError / torn frame)
                        fresh exchange connection

Each site calls :func:`inject` (optionally passing the key/payload being
written).  With no plan armed ``inject`` is one attribute check and an
immediate return.

## Plan grammar

A plan is JSON (or the equivalent dict through :func:`arm`)::

    {"seed": 1234,
     "rules": [
       {"site": "kafka.fetch", "kind": "error", "prob": 0.02, "times": 6,
        "message": "recv: injected broker flap"},
       {"site": "lsm.put", "kind": "torn", "key_substr": "@", "times": 2},
       {"site": "exchange.*", "kind": "latency", "ms": 5, "prob": 0.01}
     ]}

Rule fields:

- ``site``: exact site name, a ``prefix.*`` glob, or ``*`` (all sites).
- ``kind``: ``error`` (raise), ``latency`` (sleep ``ms`` milliseconds), or
  ``torn`` (truncate the payload at a seeded cut point; only at sites
  that pass a payload).
- ``times``: fire at most N times (omitted/null = unlimited).
- ``after``: skip the first K *matching* calls before becoming eligible.
- ``prob``: per-call firing probability (default 1.0), drawn from the
  rule's own RNG seeded by ``(seed, rule index)``, so the decision for
  matching call #k does not depend on which thread made the call.
- ``key_substr``: only match calls whose ``key`` contains this substring.
- ``message``: error text.  It steers where a Kafka fault lands: a
  transport marker (``recv:``, ``send:``, ``connect``...) routes a
  ``kafka.fetch`` error into the reader's reconnect path, ``fetch error
  1`` into its offset-out-of-range reset, and any other text (the
  default) escapes the reader and crashes its prefetch worker, which the
  supervisor of ``runtime/prefetch.py`` restarts.
- ``error``: ``"source"`` or ``"state"`` to override the site's error
  class.

The first rule that fires wins the call (rules are evaluated in plan
order); a rule that matches but does not fire still advances its
``after`` counter.  Every firing is appended to the plan's event log
(:meth:`FaultPlan.event_log`), counted in ``dnz_fault_injections_total``
by site, and put on the span stream as an instant event.

Arming: :func:`arm` (API) or the ``DENORMALIZED_FAULT_PLAN`` environment
variable (inline JSON, or ``@/path/to/plan.json``), read once at import,
which is how child processes receive a plan.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

from denormalized_tpu_torch.common.errors import SourceError, StateError

#: known sites, and the error class each raises by default
SITES = {
    "kafka.fetch": SourceError,
    "kafka.produce": SourceError,
    "decode": SourceError,
    "sink.write": SourceError,
    "lsm.put": StateError,
    "lsm.get": StateError,
    "lsm.flush": StateError,
    "checkpoint.commit": StateError,
    "lsm.spill_put": StateError,
    "lsm.spill_get": StateError,
    "spill.manifest": StateError,
    "exchange.connect": SourceError,
    "exchange.send": SourceError,
    "exchange.recv": SourceError,
    "exchange.reconnect": SourceError,
    "cluster.rejoin": StateError,
    "cluster.replay": SourceError,
}

#: where each site's ``inject`` call lives (module relative to this
#: package) and what the boundary is.  Machine-checked both ways by
#: the lint (DNZ-F002): a site registered here with no inject call in its
#: declared module — or renamed at the call site — fails the lint gate
#: instead of arming vacuous chaos plans.  The fault-site table in
#: ``docs/port.md`` is generated from this registry
#: (``python -m tools.torch_lint --fault-site-table``).
SITE_MODULES = {
    "kafka.fetch": ("sources/kafka.py", "`KafkaClient` fetch (every wire fetch)"),
    "kafka.produce": ("sources/kafka.py", "`KafkaClient.produce`"),
    "decode": ("sources/kafka.py", "decoder output, once per rowful batch, both decode paths"),
    "sink.write": ("sources/kafka.py", "`KafkaSinkWriter.write`"),
    "lsm.put": ("state/lsm.py", "`LsmStore.put` (supports torn values)"),
    "lsm.get": ("state/lsm.py", "`LsmStore.get`"),
    "lsm.flush": ("state/lsm.py", "`LsmStore.flush`"),
    "checkpoint.commit": ("state/checkpoint.py", "`CheckpointCoordinator.commit`"),
    "lsm.spill_put": (
        "state/tiering.py",
        "`SpillController.put_block` — cold-state block eviction to the "
        "LSM tier (supports torn values)",
    ),
    "lsm.spill_get": (
        "state/tiering.py",
        "`SpillController.get_block` — reload-on-touch of a spilled block",
    ),
    "spill.manifest": (
        "state/tiering.py",
        "`SpillController.write_manifest` — per-node live-block manifest "
        "write (supports torn values)",
    ),
    "exchange.connect": (
        "cluster/exchange.py",
        "`ExchangeClient.connect` — worker-to-worker exchange socket "
        "establishment (cluster runtime)",
    ),
    "exchange.send": (
        "cluster/exchange.py",
        "`ExchangeClient.send` — one framed exchange message on the "
        "wire (supports torn frames: the truncated frame is written, "
        "the receiver's CRC/length check detects the tear)",
    ),
    "exchange.recv": (
        "cluster/exchange.py",
        "exchange server receive loop, once per inbound frame",
    ),
    "exchange.reconnect": (
        "cluster/exchange.py",
        "`ExchangeClient` redial of a down edge during partial "
        "recovery, once per backoff attempt",
    ),
    "cluster.rejoin": (
        "cluster/worker.py",
        "respawned worker's rejoin handshake (generation > 0), before "
        "it reports ready to the coordinator",
    ),
    "cluster.replay": (
        "cluster/exchange.py",
        "replay of sender-buffered frames on a freshly resumed "
        "exchange connection (supports torn frames: the receiver's "
        "CRC check detects the tear and the edge redials)",
    ),
}

_KINDS = ("error", "latency", "torn")


class FaultRule:
    """One rule's match predicate + seeded decision state (thread-safe
    under the owning plan's lock)."""

    def __init__(self, spec: dict, index: int, seed: int):
        self.index = index
        self.name = spec.get("name")  # optional label, echoed in events
        self.site = spec.get("site", "*")
        # a typo'd site ("lsm.putt", "kafk.*") would arm fine, match
        # nothing, and let a chaos run report green without ever
        # injecting the fault — reject at arm time instead
        if self.site != "*":
            if self.site.endswith(".*"):
                prefix = self.site[:-1]
                known = any(s.startswith(prefix) for s in SITES)
            else:
                known = self.site in SITES
            if not known:
                raise ValueError(
                    f"fault rule {index}: site {self.site!r} matches no "
                    f"known site (expected '*' or one of {sorted(SITES)})"
                )
        self.kind = spec.get("kind", "error")
        if self.kind not in _KINDS:
            raise ValueError(
                f"fault rule {index}: unknown kind {self.kind!r} "
                f"(expected one of {_KINDS})"
            )
        times = spec.get("times")
        self.times = None if times is None else int(times)
        self.after = int(spec.get("after", 0))
        self.prob = float(spec.get("prob", 1.0))
        self.key_substr = spec.get("key_substr")
        self.message = spec.get("message")
        self.error = spec.get("error")
        self.ms = float(spec.get("ms", 0.0))
        # decision RNG: a pure function of (seed, rule index) — the k-th
        # matching call's draw is identical across runs and across the
        # thread interleavings that produced it
        self._rng = random.Random(int(seed) * 1_000_003 + index)
        self.hits = 0  # matching calls seen
        self.fired = 0  # times this rule actually fired

    def matches(self, site: str, key: str | None) -> bool:
        if self.site != "*" and self.site != site:
            if not (self.site.endswith(".*")
                    and site.startswith(self.site[:-1])):
                return False
        if self.key_substr is not None:
            if key is None or self.key_substr not in key:
                return False
        return True

    def decide(self) -> bool:
        """Advance this rule's deterministic counters for one matching
        call; True when the rule fires."""
        self.hits += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.hits <= self.after:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        self.fired += 1
        return True

    def error_class(self, site: str):
        if self.error == "source":
            return SourceError
        if self.error == "state":
            return StateError
        cls = SITES.get(site)
        if cls is not None:
            return cls
        head = site.split(".", 1)[0]
        return StateError if head in ("lsm", "checkpoint", "state") \
            else SourceError


class FaultPlan:
    """A seeded set of rules plus the log of everything they did."""

    def __init__(self, spec: dict | str):
        if isinstance(spec, str):
            spec = json.loads(spec)
        self.seed = int(spec.get("seed", 0))
        self.rules = [
            FaultRule(r, i, self.seed)
            for i, r in enumerate(spec.get("rules", []))
        ]
        self.events: list[dict] = []
        self._lock = threading.Lock()
        # per-site registry counters, bound lazily on first firing (a
        # plan can be armed before the obs registry is configured)
        self._obs_counters: dict[str, object] = {}

    # -- the one entry point every site goes through ---------------------
    def on(self, site: str, key: str | None = None, payload=None):
        """Apply the plan to one call at ``site``; returns the (possibly
        torn) payload, raises the rule's error class, or sleeps."""
        sleep_s = 0.0
        raise_exc = None
        fired_event = None
        with self._lock:
            for rule in self.rules:
                if not rule.matches(site, key):
                    continue
                if rule.kind == "torn" and not payload:
                    # nothing to tear at a payload-less call: leave the
                    # rule's budget (times/after/RNG) untouched for a
                    # call that carries bytes — consuming it here would
                    # log a vacuous "fired" while the planned tear
                    # silently never happens
                    continue
                if not rule.decide():
                    continue
                event = {
                    "site": site,
                    "rule": rule.index,
                    "kind": rule.kind,
                    "hit": rule.hits,
                    "fire": rule.fired,
                }
                if rule.name:
                    event["name"] = rule.name
                if rule.kind == "latency":
                    sleep_s = rule.ms / 1000.0
                    event["ms"] = rule.ms
                elif rule.kind == "torn":
                    # payload is non-empty: payload-less calls were
                    # filtered before decide()
                    keep = rule._rng.randrange(0, len(payload))
                    event["torn_to"] = keep
                    event["torn_from"] = len(payload)
                    if key is not None:
                        event["key"] = key
                    payload = payload[:keep]
                else:  # error
                    msg = rule.message or f"injected fault at {site}"
                    event["message"] = msg
                    raise_exc = rule.error_class(site)(msg)
                self.events.append(event)
                fired_event = event
                break  # first firing rule wins the call
        if fired_event is not None:
            # outside the plan lock: fault events ride the SAME metric +
            # span streams as everything else (counter per site for the
            # Prometheus/JSONL timeline, an instant event in the trace)
            self._record_obs(site, fired_event)
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if raise_exc is not None:
            raise raise_exc
        return payload

    def _record_obs(self, site: str, event: dict) -> None:
        from denormalized_tpu_torch import obs

        c = self._obs_counters.get(site)
        if c is None:
            c = obs.counter("dnz_fault_injections_total", site=site)
            self._obs_counters[site] = c
        c.add(1)
        rec = obs.spans.recorder()
        if rec is not None:
            rec.instant(f"fault.{site}", dict(event))

    def event_log(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self.events]

    def fired_sites(self) -> dict[str, int]:
        """Per-site count of fired injections (observability/asserts)."""
        out: dict[str, int] = {}
        with self._lock:
            for e in self.events:
                out[e["site"]] = out.get(e["site"], 0) + 1
        return out


# -- process-global plan --------------------------------------------------

_PLAN: FaultPlan | None = None


def arm(plan: FaultPlan | dict | str) -> FaultPlan:
    """Install a process-global plan (replacing any previous one)."""
    global _PLAN
    if not isinstance(plan, FaultPlan):
        plan = FaultPlan(plan)
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def plan() -> FaultPlan | None:
    return _PLAN


def armed() -> bool:
    return _PLAN is not None


def inject(site: str, key: str | None = None, payload=None):
    """Site hook: no-op (returns ``payload`` unchanged) unless a plan is
    armed.  Sites sit at I/O-operation granularity — one call per fetch,
    produce, state op, or commit — never per row."""
    p = _PLAN
    if p is None:
        return payload
    return p.on(site, key=key, payload=payload)


# env arming at import: how child processes (SIGKILL harnesses, cluster
# workers) receive the plan without API plumbing
_env_plan = os.environ.get("DENORMALIZED_FAULT_PLAN")
if _env_plan:
    try:
        if _env_plan.startswith("@"):
            with open(_env_plan[1:]) as _f:
                _env_plan = _f.read()
        arm(_env_plan)
    except Exception as _e:
        # this runs at engine import — a stale/malformed value must name
        # its source, not surface as a bare JSONDecodeError deep inside
        # an unrelated import chain
        raise RuntimeError(
            f"DENORMALIZED_FAULT_PLAN is set but unusable "
            f"({_env_plan[:80]!r}): {_e}"
        ) from _e
del _env_plan
