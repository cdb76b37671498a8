"""Fault injection at the Kafka, decode and state I/O boundaries.

Counterpart of ``denormalized_tpu/runtime/faults.py`` with the sites the
port has.  A process-global :class:`FaultPlan` is threaded through named
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

Each site calls :func:`inject` (optionally passing the key/payload being
written).  With no plan armed ``inject`` is one attribute check and an
immediate return.

A plan is a dict given to :func:`arm`::

    {"rules": [
       {"site": "lsm.put", "kind": "torn", "key_substr": "@", "times": 2},
       {"site": "checkpoint.commit", "kind": "error", "times": 2}
    ]}

Rule fields: ``site`` (one of the names above), ``kind``
(``error``: raise the site's error class, or ``torn``: the payload cut to
its first half), ``times`` (fire at most N times), ``after`` (skip the
first K matching calls), ``key_substr`` (match only keys holding it) and
``message`` (the error's text).  The first rule that fires wins the call.

The message steers where a Kafka fault lands, as in the JAX package: a
transport marker (``recv:``, ``send:``, ``connect``...) routes a
``kafka.fetch`` error into the reader's reconnect path, ``fetch error 1``
into its offset-out-of-range reset, and any other text (the default)
escapes the reader and crashes its prefetch worker, which the supervisor
of ``runtime/prefetch.py`` restarts.
"""

from __future__ import annotations

import threading

from denormalized_tpu_torch.common.errors import SourceError, StateError

#: the port's injection sites, and the error class each raises
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
}

_KINDS = ("error", "torn")


class FaultRule:
    """One rule's match predicate and firing count (thread-safe under the
    owning plan's lock)."""

    def __init__(self, spec: dict, index: int):
        self.site = spec.get("site")
        # a typo'd site ("lsm.putt") would arm fine, match nothing, and
        # let a test pass without ever injecting the fault — reject it
        if self.site not in SITES:
            raise ValueError(
                f"fault rule {index}: site {self.site!r} is not one of "
                f"{sorted(SITES)}"
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
        self.key_substr = spec.get("key_substr")
        self.message = spec.get("message")
        self.hits = 0  # matching calls seen
        self.fired = 0  # times this rule actually fired

    def matches(self, site: str, key: str | None) -> bool:
        if self.site != site:
            return False
        return self.key_substr is None or (
            key is not None and self.key_substr in key
        )

    def fire(self) -> bool:
        """Count one matching call; True (and counted) once the first
        ``after`` calls are past, unless the rule has fired ``times``
        times."""
        self.hits += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.hits <= self.after:
            return False
        self.fired += 1
        return True


class FaultPlan:
    """A set of rules, applied in order at every injection site."""

    def __init__(self, spec: dict):
        self.rules = [
            FaultRule(r, i) for i, r in enumerate(spec.get("rules", []))
        ]
        self._lock = threading.Lock()

    def on(self, site: str, key: str | None = None, payload=None):
        """Apply the plan to one call at ``site``; returns the (possibly
        torn) payload or raises the site's error class."""
        with self._lock:
            for rule in self.rules:
                if not rule.matches(site, key):
                    continue
                if rule.kind == "torn" and not payload:
                    # nothing to tear at a payload-less call: keep the
                    # rule's budget for a call that carries bytes
                    continue
                if not rule.fire():
                    continue
                if rule.kind == "torn":
                    return payload[: len(payload) // 2]
                raise SITES[site](rule.message or f"injected fault at {site}")
        return payload


# -- process-global plan --------------------------------------------------

_PLAN: FaultPlan | None = None


def arm(spec: dict) -> FaultPlan:
    """Install a process-global plan (replacing any previous one)."""
    global _PLAN
    _PLAN = FaultPlan(spec)
    return _PLAN


def disarm() -> None:
    global _PLAN
    _PLAN = None


def armed() -> bool:
    return _PLAN is not None


def inject(site: str, key: str | None = None, payload=None):
    """Site hook: no-op (returns ``payload`` unchanged) unless a plan is
    armed.  Sites sit at I/O-operation granularity — one call per fetch,
    produce, decoded batch, state op or commit — never per row."""
    p = _PLAN
    if p is None:
        return payload
    return p.on(site, key=key, payload=payload)
