"""Conservative predicate-implication checker for subsumption sharing —
counterpart of ``denormalized_tpu/planner/predicates.py`` (host code, the
same rules, so both packages group the same queries).

The sharing pass (planner/sharing.py) groups queries whose filters are
*not* textually identical when one filter provably implies another: a
query filtering ``v > 1`` can fold from a group ingesting under
``v > 0`` because every row it wants survives the weaker predicate —
the group ingests+interns ONCE under the weakest member predicate and
the slice operator re-applies each member's own full predicate as a
vectorized residual mask (physical/slice_exec.py).

Implication here is deliberately syntactic and conservative — the
classic conjunct-containment fragment, not a theorem prover:

- a predicate is split on ``and`` into conjuncts;
- conjuncts of shape ``col <op> literal`` (op ∈ ==, <, <=, >, >=) and
  ``in_list(col, lit, ...)`` are *constrained*: per-column interval
  and/or finite value-set bounds;
- every other conjunct (``or``, ``!=``, arithmetic, scalar functions,
  is_null, cross-column compares) is *opaque* and must match by exact
  repr on both sides;
- ``implies(P, Q)`` holds iff Q's opaque conjuncts are a subset of
  P's, and per column Q's bounds contain P's (interval containment,
  value-set containment, or P's finite set inside Q's interval).

NaN/null semantics make containment safe without special cases: a
comparison against NaN or a null cell evaluates false (numpy
elementwise semantics, identical to FilterExec), so a constrained
conjunct rejects NaN/null rows on BOTH sides of an implication — the
row sets still nest.  A NaN *literal* bound never constrains anything
(``v > nan`` is empty) and is kept opaque instead.  Anything the
checker cannot see through falls back to exact-match sharing, pinned
by the negative tests in tests/test_subsumption.py (and their port
twins in tests/test_torch_subsumption.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from denormalized_tpu_torch.logical.expr import (
    BinaryExpr,
    Column,
    Expr,
    Literal,
    ScalarFunctionExpr,
)

_NEG_INF = object()  # below every value, any type
_POS_INF = object()  # above every value, any type

_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


@dataclass(frozen=True)
class Interval:
    """One column's range bound: (lo, hi) with per-end strictness.
    Ends are literal values of whatever ordered type the column holds
    (numbers, strings) or the +/-inf sentinels."""

    lo: object = _NEG_INF
    lo_strict: bool = False
    hi: object = _POS_INF
    hi_strict: bool = False


def _lt(a, b) -> bool | None:
    """a < b, or None when the values are not comparable (mixed types,
    NaN) — callers treat None as 'cannot prove'."""
    if a is _NEG_INF or b is _POS_INF:
        return not (a is _NEG_INF and b is _NEG_INF) and not (
            a is _POS_INF and b is _POS_INF
        )
    if a is _POS_INF or b is _NEG_INF:
        return False
    try:
        return bool(a < b)
    except TypeError:
        return None


def _interval_contains(outer: Interval, inner: Interval) -> bool:
    """Every value satisfying ``inner`` also satisfies ``outer``."""
    # lower end: outer.lo must be <= inner.lo (strictness-aware)
    if outer.lo is not _NEG_INF:
        c = _lt(outer.lo, inner.lo)
        if c is None:
            return False
        if not c:  # outer.lo >= inner.lo
            eq = (
                inner.lo is not _NEG_INF
                and _lt(inner.lo, outer.lo) is False
            )
            if not eq:
                return False
            if outer.lo_strict and not inner.lo_strict:
                return False
    if outer.hi is not _POS_INF:
        c = _lt(inner.hi, outer.hi)
        if c is None:
            return False
        if not c:  # inner.hi >= outer.hi
            eq = (
                inner.hi is not _POS_INF
                and _lt(outer.hi, inner.hi) is False
            )
            if not eq:
                return False
            if outer.hi_strict and not inner.hi_strict:
                return False
    return True


def _value_in(v, iv: Interval) -> bool:
    """Literal ``v`` provably inside interval ``iv``."""
    if iv.lo is not _NEG_INF:
        c = _lt(iv.lo, v)
        if c is None:
            return False
        if not c and (iv.lo_strict or _lt(v, iv.lo) is not False):
            return False
    if iv.hi is not _POS_INF:
        c = _lt(v, iv.hi)
        if c is None:
            return False
        if not c and (iv.hi_strict or _lt(iv.hi, v) is not False):
            return False
    return True


def _intersect(a: Interval, b: Interval) -> Interval:
    lo, los = a.lo, a.lo_strict
    if b.lo is not _NEG_INF and (
        lo is _NEG_INF or _lt(lo, b.lo) or (
            _lt(b.lo, lo) is False and b.lo_strict
        )
    ):
        lo, los = b.lo, b.lo_strict
    hi, his = a.hi, a.hi_strict
    if b.hi is not _POS_INF and (
        hi is _POS_INF or _lt(b.hi, hi) or (
            _lt(hi, b.hi) is False and b.hi_strict
        )
    ):
        hi, his = b.hi, b.hi_strict
    return Interval(lo, los, hi, his)


@dataclass
class Constraints:
    """The analyzable content of one conjunctive predicate."""

    intervals: dict[str, Interval] = field(default_factory=dict)
    sets: dict[str, frozenset] = field(default_factory=dict)
    opaque: frozenset = frozenset()

    @property
    def constrained_columns(self) -> set[str]:
        return set(self.intervals) | set(self.sets)


def split_conjuncts(pred: Expr | None) -> list[Expr]:
    """Flatten nested ``and`` nodes into a conjunct list."""
    if pred is None:
        return []
    if isinstance(pred, BinaryExpr) and pred.op == "and":
        return split_conjuncts(pred.left) + split_conjuncts(pred.right)
    return [pred]


def _is_bad_literal(v) -> bool:
    try:
        return isinstance(v, float) and math.isnan(v)
    except TypeError:  # pragma: no cover
        return True


def analyze(preds: list[Expr]) -> Constraints:
    """Classify every conjunct of the given predicate list (an implicit
    AND) into interval / set / opaque constraints."""
    cons = Constraints()
    opaque: set[str] = set()
    for pred in preds:
        for c in split_conjuncts(pred):
            if not _absorb(c, cons):
                opaque.add(repr(c))
    cons.opaque = frozenset(opaque)
    return cons


def _absorb(conj: Expr, cons: Constraints) -> bool:
    """Try to fold one conjunct into ``cons``; False → opaque."""
    if isinstance(conj, BinaryExpr) and conj.op in ("==", "<", "<=", ">", ">="):
        op = conj.op
        left, right = conj.left, conj.right
        if isinstance(left, Literal) and isinstance(right, Column):
            left, right = right, left
            op = _FLIP.get(op, op)
        if not (isinstance(left, Column) and isinstance(right, Literal)):
            return False
        v = right.value
        if _is_bad_literal(v):
            return False
        name = left.name
        if op == "==":
            s = cons.sets.get(name, frozenset({v}))
            cons.sets[name] = s & {v} if name in cons.sets else frozenset({v})
            return True
        iv = {
            "<": Interval(hi=v, hi_strict=True),
            "<=": Interval(hi=v),
            ">": Interval(lo=v, lo_strict=True),
            ">=": Interval(lo=v),
        }[op]
        prev = cons.intervals.get(name)
        cons.intervals[name] = iv if prev is None else _intersect(prev, iv)
        return True
    if (
        isinstance(conj, ScalarFunctionExpr)
        and conj.fname == "in_list"
        and len(conj.args) >= 2
        and isinstance(conj.args[0], Column)
        and all(isinstance(a, Literal) for a in conj.args[1:])
    ):
        vals = [a.value for a in conj.args[1:]]
        if any(_is_bad_literal(v) for v in vals):
            return False
        name = conj.args[0].name
        s = frozenset(vals)
        cons.sets[name] = (
            cons.sets[name] & s if name in cons.sets else s
        )
        return True
    return False


def implies(p: Constraints, q: Constraints) -> bool:
    """Every row satisfying ``p`` provably satisfies ``q``."""
    if not q.opaque <= p.opaque:
        return False
    for name, q_set in q.sets.items():
        p_set = p.sets.get(name)
        if p_set is None or not p_set <= q_set:
            return False
    for name, q_iv in q.intervals.items():
        p_iv = p.intervals.get(name)
        if p_iv is not None and _interval_contains(q_iv, p_iv):
            continue
        p_set = p.sets.get(name)
        if p_set is not None and all(_value_in(v, q_iv) for v in p_set):
            continue
        return False
    return True


def weakest(cands: list[Constraints]) -> int | None:
    """Index of the member every OTHER member provably implies — the
    subsumption-lattice bottom of the given set — or None when no
    single member is weakest (incomparable survivors).  Used to
    re-derive the shared ingest predicate after the base member of a
    live group deregisters (runtime/multi_query.py): the survivors'
    weakest predicate becomes the new ingest filter, and rows only the
    departed base could reach stop being ingested.  First match wins
    for determinism when several members tie."""
    for i, c in enumerate(cands):
        if all(implies(o, c) for j, o in enumerate(cands) if j != i):
            return i
    return None


def predicate_signature(preds: list[Expr]) -> str:
    """Stable textual identity of a full (conjunctive) predicate list —
    the per-subscriber filter signature checkpoints carry."""
    return "&".join(sorted(repr(c) for p in preds for c in split_conjuncts(p)))


def conjoin(preds: list[Expr]) -> Expr | None:
    """Re-assemble a filter-node chain's predicates into one AND
    expression (None for an empty chain)."""
    if not preds:
        return None
    out = preds[0]
    for p in preds[1:]:
        out = BinaryExpr("and", out, p)
    return out
