"""Cross-query sharing pass: which concurrently registered window
queries can fold from ONE shared slice store — counterpart of
``denormalized_tpu/planner/sharing.py`` (host code, the same rules, the
same groups and reasons).

The Factor-Windows rewrite rules (PAPERS.md), applied conservatively:
a set of queries shares one ingest + slice store iff

1. they read the SAME upstream subtree below their filters — same
   source object, same projections (structural signature, source
   compared by identity: two scans of one registered Source are one
   feed, two different Source objects are two feeds even if their
   contents agree), and for stream-stream joins the same join
   signature (kind, equi keys, band predicate, join filter, both side
   subtrees — ONE ``StreamingJoinExec`` then feeds the whole group) —
   and their filter predicates either match exactly
   or nest under predicate subsumption: a query whose filter provably
   IMPLIES another member's filter (planner/predicates.py) joins that
   member's group, which then ingests+interns once under the WEAKEST
   member predicate while the slice operator re-applies each stronger
   member's own full predicate as a vectorized residual mask;
2. they group by the SAME key expressions (the slice store is keyed by
   the shared interner's dense gids);
3. every aggregate folds from slice partials (builtin count / sum /
   min / max / avg / variance family — UDAFs hold opaque per-window
   accumulator state and cannot fold);
4. the common slice width ``g = gcd over members of (length, slide)``
   keeps every member's fold fan-in ``length/g`` under a cost bound —
   the cost-based half of the rewrite: two queries at 60s/7ms and
   60s/1000ms would share a 1ms slice and pay a 60000-way fold per
   window, slower than running them independently.

Filters only participate in subsumption when they sit directly under
the window (``Filter* → (Project|Scan)…``) — a filter buried below a
projection keeps exact-signature matching, because its predicate reads
pre-projection columns the residual mask could no longer see.

Queries that fail any rule fall back to independent plans (the
negative-path contract tests pin this).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field

from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.physical.slice_exec import FOLDABLE_KINDS
from denormalized_tpu_torch.planner import predicates as pr

#: cost guard: maximum slice partials one window fold may combine.
#: Past this, the fold itself dominates and independent plans win.
MAX_SLICES_PER_WINDOW = 4096


_OPAQUE = itertools.count()


def input_signature(node: lp.LogicalPlan) -> str:
    """Structural signature of a window's upstream subtree.  Scans key
    on SOURCE IDENTITY; filters/projections on expression reprs; joins
    key on (kind, equi-key pairs, band, join filter) plus BOTH side
    signatures recursively — two windows over structurally identical
    joins of the same sources run ONE ``StreamingJoinExec`` whose
    output fans into the shared slice store.  Any other shape (nested
    windows, UDFs) is opaque — NEVER shared, so the opaque token is
    unique per call (two windows over the same unreviewed subtree must
    not silently share a pipeline)."""
    if isinstance(node, lp.Scan):
        return f"scan#{id(node.source)}"
    if isinstance(node, lp.Filter):
        return f"filter[{node.predicate!r}]({input_signature(node.input)})"
    if isinstance(node, lp.Project):
        exprs = ",".join(repr(e) for e in node.exprs)
        return f"project[{exprs}]({input_signature(node.input)})"
    if isinstance(node, lp.Join):
        keys = ",".join(
            f"{l}={r}" for l, r in zip(node.left_keys, node.right_keys)
        )
        parts = [node.kind.value, keys]
        if node.band is not None:
            b = node.band
            parts.append(
                f"band[{b.left_expr!r};{b.right_expr!r};"
                f"{b.lower_ms};{b.upper_ms}]"
            )
        if node.filter is not None:
            parts.append(f"filter[{node.filter!r}]")
        return (
            f"join[{';'.join(parts)}]"
            f"({input_signature(node.left)})({input_signature(node.right)})"
        )
    return f"opaque#{next(_OPAQUE)}"


def split_filter_chain(node: lp.LogicalPlan):
    """Peel the ``Filter*`` prefix directly under a window → (predicate
    list, remaining skeleton node)."""
    preds = []
    while isinstance(node, lp.Filter):
        preds.append(node.predicate)
        node = node.input
    return preds, node


@dataclass
class _Entry:
    """One shareable window query's planning facts."""

    window: lp.LogicalPlan
    preds: list  # lifted filter predicates (conjunctive)
    cons: pr.Constraints
    filter_sig: str


def classify(plan: lp.LogicalPlan):
    """→ ``(bucket_key, _Entry)`` when ``plan`` is a shareable window
    query, else ``(None, reason)``.  The bucket key carries the
    filter-free skeleton — members of one bucket may still split into
    several groups by predicate implication."""
    if not isinstance(plan, lp.StreamingWindow):
        return None, f"top node is {type(plan).__name__}, not a window"
    if plan.window_type is lp.WindowType.SESSION:
        return None, "session windows hold per-key gap state (no slices)"
    bad = [a.kind for a in plan.aggr_exprs if a.kind not in FOLDABLE_KINDS]
    if bad:
        return None, f"aggregate kind(s) {bad} do not fold from slices"
    group_sig = tuple(repr(g) for g in plan.group_exprs)
    preds, skeleton = split_filter_chain(plan.input)
    entry = _Entry(
        window=plan,
        preds=preds,
        cons=pr.analyze(preds),
        filter_sig=pr.predicate_signature(preds),
    )
    return (input_signature(skeleton), group_sig), entry


@dataclass
class ShareGroup:
    """One planning decision: either a shared slice plan over
    ``members`` (≥ 2 queries, ``shared=True``) or an independent
    fallback (singleton, or a documented rejection ``reason``).

    For a shared group, ``input_plan`` is the BASE member's full input
    (its filter chain included — the weakest predicate in the group),
    ``filters[k]`` is member k's residual predicate the slice operator
    re-applies per row (None when the member's predicate is already
    the base predicate — no re-filter), and ``filter_sigs[k]`` the
    member's full-predicate signature (checkpoint identity)."""

    members: list[int]
    shared: bool
    windows: list = field(default_factory=list)
    input_plan: lp.LogicalPlan | None = None
    unit_ms: int | None = None
    reason: str | None = None
    filters: list = field(default_factory=list)
    filter_sigs: list = field(default_factory=list)
    base_sig: str | None = None


@dataclass
class _Proto:
    """Greedy group under construction: ``base`` is the weakest member
    seen so far (every member's predicate implies it — base-widening
    preserves the invariant by transitivity)."""

    base: _Entry
    members: list  # [(index, _Entry)]


def detect_sharing(
    plans: list[lp.LogicalPlan],
    max_slices_per_window: int = MAX_SLICES_PER_WINDOW,
    subsumption: bool = True,
) -> list[ShareGroup]:
    """Partition query plans into shared groups + independent
    fallbacks.  Order inside a group follows registration order, and
    every input index appears in exactly one group.  With
    ``subsumption=False`` only textually identical predicates share
    (the pre-subsumption behavior — the A/B control)."""
    buckets: dict = {}
    singles: list[ShareGroup] = []
    for i, plan in enumerate(plans):
        key, entry_or_reason = classify(plan)
        if key is None:
            singles.append(
                ShareGroup([i], shared=False, reason=entry_or_reason)
            )
            continue
        buckets.setdefault(key, []).append((i, entry_or_reason))
    groups: list[ShareGroup] = []
    for _key, members in buckets.items():
        protos: list[_Proto] = []
        for i, e in members:
            placed = False
            for pg in protos:
                if e.filter_sig == pg.base.filter_sig:
                    pg.members.append((i, e))
                    placed = True
                    break
                if not subsumption:
                    continue
                if pr.implies(e.cons, pg.base.cons):
                    # e is at least as strong as the base: its rows are
                    # a subset of what the group already ingests
                    pg.members.append((i, e))
                    placed = True
                    break
                if pr.implies(pg.base.cons, e.cons):
                    # e is strictly weaker: widen the group's ingest to
                    # e's predicate — every existing member implies the
                    # old base, which implies e (transitivity)
                    pg.base = e
                    pg.members.append((i, e))
                    placed = True
                    break
            if not placed:
                protos.append(_Proto(base=e, members=[(i, e)]))
        for pg in protos:
            if len(pg.members) == 1:
                i, _e = pg.members[0]
                groups.append(
                    ShareGroup([i], shared=False, reason="no co-registered "
                               "query shares this source+filter+keys")
                )
                continue
            g = 0
            for _i, e in pg.members:
                w = e.window
                slide = int(w.slide_ms) if w.slide_ms else int(w.length_ms)
                g = math.gcd(g, math.gcd(int(w.length_ms), slide))
            worst = max(
                int(e.window.length_ms) // g for _i, e in pg.members
            )
            if worst > max_slices_per_window:
                # cost-based rejection: the gcd slice is so fine that
                # folds dominate — run the members independently
                for i, _e in pg.members:
                    groups.append(
                        ShareGroup(
                            [i], shared=False,
                            reason=(
                                f"gcd slice {g}ms gives a {worst}-way fold "
                                f"(> {max_slices_per_window}) — independent "
                                "plans are cheaper"
                            ),
                        )
                    )
                continue
            base = pg.base
            groups.append(
                ShareGroup(
                    [i for i, _e in pg.members],
                    shared=True,
                    windows=[e.window for _i, e in pg.members],
                    input_plan=base.window.input,
                    unit_ms=g,
                    filters=[
                        None if e.filter_sig == base.filter_sig
                        else pr.conjoin(e.preds)
                        for _i, e in pg.members
                    ],
                    filter_sigs=[e.filter_sig for _i, e in pg.members],
                    base_sig=base.filter_sig,
                )
            )
    # deterministic output order: by first member index
    out = groups + singles
    out.sort(key=lambda grp: grp.members[0])
    return out
