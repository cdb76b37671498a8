"""Multi-query runtime: N concurrently registered queries, one ingest —
counterpart of ``denormalized_tpu/runtime/multi_query.py``.

Production traffic is many concurrent windowed queries over the same
topics (per-user dashboards, alerting rules), not one pipeline.  This
runtime takes a batch of registered queries, runs the sharing pass
(planner/sharing.py), and executes each share group through ONE
physical pipeline: one SourceExec (one fetch+decode pass), one shared
interner, one :class:`SliceWindowExec` with a
:class:`~denormalized_tpu_torch.physical.slice_exec.SliceSubscriber` per
query — emissions fan out to per-query sinks by subscriber tag.
Unshareable queries (UDAFs, sessions, different filters, cost-rejected
slide sets) fall back to the normal single-query executor, unchanged —
on the card, through the device window and its kernels.

Checkpointing rides the existing epoch-consistent protocol
(``runtime/executor.py::_attach_checkpointing``): the shared group takes
ONE snapshot per epoch (slice partials + interner + every subscriber's
emission cursor) under the same in-band marker alignment and coordinator
commit the single-query executor uses; restore resumes every subscriber
exactly at its own cursor.

Each shared group builds and runs under its query-scoped registry
(``obs.bound_registry``), starts the exporters its config opts into
(``obs.start_exporters``) and files one doctor handle per subscriber
(``doctor.register_shared``), whose ids the report's ``query_ids`` carry.
"""

from __future__ import annotations

import threading
from typing import Callable

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.physical.base import EndOfStream, ExecOperator, Marker
from denormalized_tpu_torch.physical.slice_exec import (
    SliceSubscriber,
    SliceWindowExec,
    SubscriberBatch,
)
from denormalized_tpu_torch.planner import predicates as pr
from denormalized_tpu_torch.planner.sharing import (
    ShareGroup,
    classify,
    detect_sharing,
)


def _find_shared_join(op):
    """First StreamingJoinExec under the shared root's child subtree
    (None when the group windows a join-free input) — the operator
    whose measured build/probe/gather cost the doctor attributes across
    subscribers instead of 1/N."""
    from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec

    stack = [op]
    while stack:
        cur = stack.pop()
        if isinstance(cur, StreamingJoinExec):
            return cur
        stack.extend(cur.children)
    return None


def build_shared_root(
    ctx, group: ShareGroup, labels: list[str] | None = None
) -> ExecOperator:
    """Build the shared physical pipeline for one share group: the
    common input subtree planned once (the BASE member's — weakest —
    filter included), topped by a tagged SliceWindowExec with one
    subscriber per member query; members with a strictly stronger
    predicate carry it as a residual the operator re-applies."""
    from denormalized_tpu_torch.planner.planner import Planner

    child = Planner(ctx.config).create_physical_plan(group.input_plan)
    subs = [
        SliceSubscriber(
            w.aggr_exprs,
            w.length_ms,
            w.slide_ms or w.length_ms,
            tag=k,
            label=labels[k] if labels else None,
            filter_expr=(
                group.filters[k] if k < len(group.filters) else None
            ),
            filter_sig=(
                group.filter_sigs[k] if k < len(group.filter_sigs) else ""
            ),
        )
        for k, w in enumerate(group.windows)
    ]
    root = SliceWindowExec(
        child,
        group.windows[0].group_exprs,
        subs,
        tagged=True,
        emit_on_close=ctx.config.emit_on_close,
        unit_ms=ctx.config.slice_unit_ms,
        sort_lane=ctx.config.slice_sort_lane,
    )
    join = _find_shared_join(child)
    if join is not None:
        # a shared join feeds this group: turn on its stage timers and
        # hand the slice operator its measured cost so shared_fractions
        # apportions join time by kept-rows share, not 1/N
        join.enable_shared_attribution()
        root._upstream_cost_fn = join.shared_cost_ms
    return root


def drive_shared(
    root: ExecOperator,
    sinks: list[Callable[[RecordBatch], None]],
    coord=None,
) -> None:
    """Pump one shared pipeline to completion, routing each tagged
    emission to its subscriber's sink and committing drained epochs —
    the share-group analog of the executor's drive loop."""
    for item in root.run():
        if isinstance(item, SubscriberBatch):
            sinks[item.tag](item.batch)
        elif isinstance(item, Marker) and coord is not None:
            coord.commit(item.epoch)
        elif isinstance(item, EndOfStream):
            break


class SharedPipeline:
    """Live multi-query serving over ONE shared slice pipeline: a
    thread-safe registry of subscriber queries that can join and leave
    MID-STREAM, without restarting the shared operator or cold-starting
    an independent pipeline per query.

    Built from an initial batch of queries that must form one share
    group (``detect_sharing``), it exposes:

    - :meth:`register` — queue a new query; it attaches at a slice
      boundary on the operator thread and WARMS from the slice store's
      retained partials (windows the gcd slices already cover backfill
      immediately, exact from the query's first exact window — see
      docs/multi_query.md for the exactness contract);
    - :meth:`deregister` — queue a leave; the cursor detaches at a
      slice boundary and partials no survivor needs are pruned.

    Both accept ``when_ts``, an event-time threshold: the op fires at
    the first batch whose min timestamp reaches it.  Event-time
    scheduling makes a registration schedule REPLAYABLE — after a
    kill/restore, re-issuing the same requests lands every join/leave
    at the same stream position, and subscribers present in the
    restored checkpoint adopt their snapshotted cursor instead of
    backfilling (tags are assigned sequentially and deterministically).

    A registering query must share the pipeline's source+keys and carry
    a filter the group's base predicate already admits (identical, or
    implied under subsumption) — the live ingest cannot widen.
    """

    def __init__(
        self,
        ctx,
        queries,
        *,
        labels: list[str] | None = None,
        checkpoint: bool | None = None,
    ) -> None:
        from denormalized_tpu_torch import obs
        from denormalized_tpu_torch.runtime import executor

        if not queries:
            raise PlanError("SharedPipeline needs at least one query")
        self._ctx = ctx
        self._checkpoint = checkpoint
        plans = [ds._plan for ds, _sink in queries]
        groups = detect_sharing(
            plans, subsumption=ctx.config.mq_subsumption
        )
        shared = [g for g in groups if g.shared]
        if len(queries) > 1 and (
            len(shared) != 1 or len(shared[0].members) != len(queries)
        ):
            reasons = "; ".join(
                g.reason or "?" for g in groups if not g.shared
            )
            raise PlanError(
                "initial queries do not form one share group: " + reasons
            )
        group = shared[0] if shared else _singleton_group(plans[0])
        self._group = group
        key0, entry0 = classify(plans[group.members[0]])
        self._key = key0
        self._base_sig = (
            group.base_sig if group.base_sig is not None
            else entry0.filter_sig
        )
        base_entry = entry0
        for i in group.members:
            _k, e = classify(plans[i])
            if e.filter_sig == self._base_sig:
                base_entry = e
                break
        self._base_cons = base_entry.cons
        self._lock = threading.Lock()
        # per-tag planning facts (preds, cons, filter_sig): the base
        # re-derivation on deregister needs every live member's full
        # predicate to find the survivors' weakest
        self._member_facts: dict[int, tuple] = {}
        for k, i in enumerate(group.members):
            _k2, e = classify(plans[i])
            self._member_facts[k] = (e.preds, e.cons, e.filter_sig)
        # tags for initial members are their member index; live joiners
        # continue the sequence (deterministic across a replay)
        self._sinks: dict[int, Callable] = {
            k: queries[i][1] for k, i in enumerate(group.members)
        }
        self._next_tag = len(group.members)
        self._labels = labels or [f"member{i}" for i in group.members]
        self._reg = executor._resolve_registry(ctx)
        with obs.bound_registry(self._reg):
            self._root: SliceWindowExec = build_shared_root(
                ctx, group, self._labels
            )
        self._root.on_detach = self._on_detach

    @property
    def root(self) -> SliceWindowExec:
        return self._root

    def register(
        self,
        ds,
        sink: Callable[[RecordBatch], None],
        *,
        label: str | None = None,
        when_ts: int | None = None,
    ) -> int:
        """Queue a live subscription (any thread); returns the tag its
        emissions carry.  Validates shareability up front so a bad
        query is rejected HERE, not on the operator thread mid-drive."""
        key, entry = classify(ds._plan)
        if key is None:
            raise PlanError(f"query cannot join a shared pipeline: {entry}")
        if key != self._key:
            raise PlanError(
                "query does not share the pipeline's source, projection "
                "and group keys"
            )
        w = entry.window
        length = int(w.length_ms)
        slide = int(w.slide_ms) if w.slide_ms else length
        unit = self._root.unit_ms
        if length % unit or slide % unit:
            raise PlanError(
                f"window {length}ms/{slide}ms does not tile the shared "
                f"group's {unit}ms slices"
            )
        with self._lock:
            # predicate gate and membership insert are one atomic step:
            # _on_detach re-derives the base from the surviving members
            # under this same lock, so checking against a base the
            # detach hook is about to replace cannot admit a widening
            # query (TOCTOU otherwise)
            if entry.filter_sig != self._base_sig and not pr.implies(
                entry.cons, self._base_cons
            ):
                raise PlanError(
                    "query filter is not implied by the shared pipeline's "
                    "base predicate — the live ingest cannot widen; run it "
                    "as an independent pipeline"
                )
            base_sig = self._base_sig
            tag = self._next_tag
            self._next_tag += 1
            self._sinks[tag] = sink
            self._member_facts[tag] = (
                entry.preds, entry.cons, entry.filter_sig
            )
        sub = SliceSubscriber(
            w.aggr_exprs,
            length,
            slide,
            tag=tag,
            label=label if label is not None else f"live{tag}",
            filter_expr=(
                None if entry.filter_sig == base_sig
                else pr.conjoin(entry.preds)
            ),
            filter_sig=entry.filter_sig,
        )
        self._root.request_attach(sub, when_ts)
        return tag

    def deregister(self, tag: int, *, when_ts: int | None = None) -> None:
        """Queue a live unsubscription (any thread)."""
        self._root.request_detach(tag, when_ts)

    def _on_detach(self, tag: int) -> None:
        """Operator-thread hook, fired inside the slice boundary that
        detached ``tag``.  When the departed member held the group's
        BASE (weakest) predicate, the shared ingest would otherwise
        keep admitting rows only that member could reach, forever —
        correct but wasteful.  Re-derive the base from the survivors:
        their weakest member's predicate (``predicates.weakest``)
        becomes the new ingest filter — every survivor's full predicate
        implies it, so the residual re-filters stay exact — and the
        registration gate tightens to the new base (the live ingest
        still cannot widen).  Pairwise-incomparable survivors keep the
        old, wider predicate: no single survivor predicate admits every
        row the others need.  Replayed detaches of already-departed
        tags are no-ops."""
        with self._lock:
            facts = self._member_facts.pop(tag, None)
            if facts is None or facts[2] != self._base_sig:
                return
            if not self._member_facts:
                return
            tags = sorted(self._member_facts)
            if any(
                self._member_facts[t][2] == self._base_sig for t in tags
            ):
                return  # another live member still holds the base
            idx = pr.weakest([self._member_facts[t][1] for t in tags])
            if idx is None:
                return
            preds, cons, sig = self._member_facts[tags[idx]]
            self._base_sig = sig
            self._base_cons = cons
            self._root.set_ingest_pred(pr.conjoin(preds))

    def run(self) -> None:
        """Drive the shared pipeline to EndOfStream on the calling
        thread, routing tagged emissions (including attach-time
        backfills) to each subscriber's sink."""
        from denormalized_tpu_torch import obs
        from denormalized_tpu_torch.obs import doctor
        from denormalized_tpu_torch.runtime import executor

        ctx = self._ctx
        orch = exporters = None
        handles: list = []
        with obs.bound_registry(self._reg):
            try:
                orch, coord = executor._attach_checkpointing(
                    self._root, ctx, self._checkpoint
                )
                ctx._checkpointing = (coord, orch)  # last_checkpointing()
                exporters = obs.start_exporters(
                    ctx.config, registry=self._reg
                )
                ctx._last_exporters = exporters
                handles = doctor.register_shared(
                    self._root, len(self._group.members),
                    config=ctx.config, registry=self._reg,
                    labels=self._labels,
                )
                for item in self._root.run():
                    if isinstance(item, SubscriberBatch):
                        with self._lock:
                            sink = self._sinks.get(item.tag)
                        if sink is not None:
                            sink(item.batch)
                    elif isinstance(item, Marker) and coord is not None:
                        coord.commit(item.epoch)
                    elif isinstance(item, EndOfStream):
                        break
            finally:
                if orch is not None:
                    orch.stop()
                for h in handles:
                    h.finish()
                if exporters is not None:
                    exporters.stop()


def _singleton_group(plan) -> ShareGroup:
    """A one-member ShareGroup for a SharedPipeline started with a
    single query (it still runs the slice operator in tagged mode so
    live joiners can attach)."""
    key, entry = classify(plan)
    if key is None:
        raise PlanError(f"query cannot seed a shared pipeline: {entry}")
    w = entry.window
    slide = int(w.slide_ms) if w.slide_ms else int(w.length_ms)
    import math

    return ShareGroup(
        [0],
        shared=True,
        windows=[w],
        input_plan=w.input,
        unit_ms=math.gcd(int(w.length_ms), slide),
        filters=[None],
        filter_sigs=[entry.filter_sig],
        base_sig=entry.filter_sig,
    )


def run_queries(
    ctx,
    queries,
    *,
    sharing: bool = True,
    checkpoint: bool | None = None,
) -> dict:
    """Execute a batch of concurrently registered queries.

    ``queries`` is a list of ``(DataStream, sink_fn)`` pairs; each
    sink_fn receives that query's emitted RecordBatches in order.
    Returns a planning/execution report::

        {"queries": N,
         "groups": [{"members": [...], "shared": bool,
                     "unit_ms": g | None, "reason": str | None,
                     "query_ids": [doctor ids] | None}, ...],
         "shared_queries": n, "independent_queries": m}

    With ``sharing=False`` every query runs through the normal
    single-query executor (the A/B baseline).

    Execution contract: groups run SEQUENTIALLY in first-member order,
    each drained to EndOfStream before the next starts — so this entry
    point serves bounded (replay/batch) feeds.  With an unbounded
    source, the first group never ends and later groups never run:
    drive each group on its own thread/process instead (one
    build_shared_root + drive_shared per group), the same rule as any
    two concurrent queries today."""
    from denormalized_tpu_torch import obs
    from denormalized_tpu_torch.obs import doctor
    from denormalized_tpu_torch.physical.simple_execs import CallbackSink
    from denormalized_tpu_torch.runtime import executor

    plans = [ds._plan for ds, _sink in queries]
    if sharing:
        groups = detect_sharing(
            plans, subsumption=ctx.config.mq_subsumption
        )
    else:
        groups = [
            ShareGroup([i], shared=False, reason="sharing disabled")
            for i in range(len(queries))
        ]
    report = {
        "queries": len(queries),
        "groups": [],
        "shared_queries": 0,
        "independent_queries": 0,
    }
    for group in groups:
        entry = {
            "members": list(group.members),
            "shared": group.shared,
            "unit_ms": group.unit_ms,
            "reason": group.reason,
            "query_ids": None,
        }
        if not group.shared:
            report["independent_queries"] += len(group.members)
            for i in group.members:
                ds, sink = queries[i]
                ds._execute(CallbackSink(sink), checkpoint=checkpoint)
            report["groups"].append(entry)
            continue
        report["shared_queries"] += len(group.members)
        sinks = [queries[i][1] for i in group.members]
        labels = [f"member{i}" for i in group.members]
        reg = executor._resolve_registry(ctx)
        orch = exporters = None
        handles: list = []
        with obs.bound_registry(reg):
            root = build_shared_root(ctx, group, labels)
            ctx._last_physical = root  # post-run metrics access
            try:
                orch, coord = executor._attach_checkpointing(
                    root, ctx, checkpoint
                )
                ctx._checkpointing = (coord, orch)
                exporters = obs.start_exporters(ctx.config, registry=reg)
                ctx._last_exporters = exporters
                handles = doctor.register_shared(
                    root, len(group.members),
                    config=ctx.config, registry=reg, labels=labels,
                )
                entry["query_ids"] = [h.query_id for h in handles]
                drive_shared(root, sinks, coord)
            finally:
                if orch is not None:
                    orch.stop()
                for h in handles:
                    h.finish()
                if exporters is not None:
                    exporters.stop()
        report["groups"].append(entry)
    return report
