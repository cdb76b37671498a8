"""Logical plan optimizer — counterpart of
``denormalized_tpu/logical/optimizer.py`` over the port's plan algebra
(scan, project, filter, window, join, sink) and expression tree.

The rules are the JAX package's, so both packages build the same physical
plan for a query — the DFS node ids that key its checkpoints included:

- :class:`ProjectionPruning` — narrow every Project to the outputs read
  above it, and push the pruning into each Scan's source
  (``Source.with_projection``: the Kafka source's JSON decode skips the
  pruned fields), or put a narrow Project above the Scan; a join
  keeps every column its band's expressions read, each on its own side;
- :class:`FilterPushdown` — evaluate a filter below the projection above
  it, and fuse adjacent filters into one conjunction, but never push an
  IsNull check (a mask check on a column would become a value check on a
  computed expression) or duplicate a UDF call;
- :class:`MergeProjects` — collapse stacked projections where that
  duplicates no work, and never inline a UDF.

Rules run to a bounded fixpoint.
"""

from __future__ import annotations

from typing import Callable

from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.logical.expr import (
    AliasExpr,
    BinaryExpr,
    CaseExpr,
    CastExpr,
    Column,
    Expr,
    FieldAccessExpr,
    IsNullExpr,
    Literal,
    NotExpr,
    ScalarFunctionExpr,
    ScalarUDFExpr,
    substitute_columns,
)


def map_children(
    node: lp.LogicalPlan, fn: Callable[[lp.LogicalPlan], lp.LogicalPlan]
) -> lp.LogicalPlan:
    """Rebuild ``node`` with ``fn`` applied to each child."""
    if isinstance(node, lp.Sink):
        return lp.Sink(fn(node.input), node.sink)
    if isinstance(node, lp.Project):
        return lp.Project(fn(node.input), node.exprs)
    if isinstance(node, lp.Filter):
        return lp.Filter(fn(node.input), node.predicate)
    if isinstance(node, lp.StreamingWindow):
        return lp.StreamingWindow(
            fn(node.input),
            node.group_exprs,
            node.aggr_exprs,
            node.window_type,
            node.length_ms,
            node.slide_ms,
        )
    if isinstance(node, lp.Join):
        return lp.Join(
            fn(node.left),
            fn(node.right),
            node.kind,
            node.left_keys,
            node.right_keys,
            node.filter,
            node.band,
        )
    return node


def _expr_nodes(e: Expr):
    """Yield every node of an expression tree."""
    yield e
    if isinstance(e, BinaryExpr):
        yield from _expr_nodes(e.left)
        yield from _expr_nodes(e.right)
    elif isinstance(
        e, (NotExpr, IsNullExpr, AliasExpr, CastExpr, FieldAccessExpr)
    ):
        yield from _expr_nodes(e.inner)
    elif isinstance(e, (ScalarFunctionExpr, ScalarUDFExpr)):
        for a in e.args:
            yield from _expr_nodes(a)
    elif isinstance(e, CaseExpr):
        if e.base is not None:
            yield from _expr_nodes(e.base)
        for c, r in e.branches:
            yield from _expr_nodes(c)
            yield from _expr_nodes(r)
        if e.otherwise is not None:
            yield from _expr_nodes(e.otherwise)


def _contains(e: Expr, cls) -> bool:
    return any(isinstance(n, cls) for n in _expr_nodes(e))


def _is_trivial(e: Expr) -> bool:
    """Inlining this duplicates no meaningful work."""
    while isinstance(e, AliasExpr):
        e = e.inner
    return isinstance(e, (Column, Literal))


class ProjectionPruning:
    """Narrow every projection to the columns the plan actually reads."""

    def rewrite(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        return self._walk(plan, None)

    def _walk(
        self, node: lp.LogicalPlan, required: set[str] | None
    ) -> lp.LogicalPlan:
        # required=None means "every column" (top of plan / sinks)
        if isinstance(node, lp.Sink):
            return lp.Sink(self._walk(node.input, None), node.sink)
        if isinstance(node, lp.Project):
            exprs = node.exprs
            if required is not None:
                kept = [
                    e
                    for e in exprs
                    if e.name in required
                    or e.name == CANONICAL_TIMESTAMP_COLUMN
                ]
                if kept:
                    exprs = kept
            need: set[str] = set()
            for e in exprs:
                need |= e.columns_referenced()
            return lp.Project(self._walk(node.input, need), exprs)
        if isinstance(node, lp.Filter):
            if required is None:
                return lp.Filter(self._walk(node.input, None), node.predicate)
            need = set(node.predicate.columns_referenced())
            return lp.Filter(
                self._walk(node.input, need | required), node.predicate
            )
        if isinstance(node, lp.StreamingWindow):
            need = set()
            for g in node.group_exprs:
                need |= g.columns_referenced()
            for a in node.aggr_exprs:
                if a.kind == "udaf" and a.udaf is not None:
                    for arg in a.udaf.args:
                        need |= arg.columns_referenced()
                elif a.arg is not None:
                    need |= a.arg.columns_referenced()
            return lp.StreamingWindow(
                self._walk(node.input, need),
                node.group_exprs,
                node.aggr_exprs,
                node.window_type,
                node.length_ms,
                node.slide_ms,
            )
        if isinstance(node, lp.Join):
            lnames = set(node.left.schema.names)
            rnames = set(node.right.schema.names)
            if required is None:
                lneed = rneed = None
            else:
                base = set(required)
                base |= set(node.left_keys) | set(node.right_keys)
                lneed = {n for n in base if n in lnames}
                rneed = {n for n in base if n in rnames}
                if node.filter is not None:
                    for n in node.filter.columns_referenced():
                        (lneed if n in lnames else rneed).add(n)
                if node.band is not None:
                    # band expressions evaluate against their own side's
                    # input: keep those columns, though they may never
                    # reach the output
                    lneed |= node.band.left_expr.columns_referenced()
                    rneed |= node.band.right_expr.columns_referenced()
            return lp.Join(
                self._walk(node.left, lneed),
                self._walk(node.right, rneed),
                node.kind,
                node.left_keys,
                node.right_keys,
                node.filter,
                node.band,
            )
        if isinstance(node, lp.Scan):
            if required is None:
                return node
            keep = [
                f.name
                for f in node.schema
                if f.name in required or f.name == CANONICAL_TIMESTAMP_COLUMN
            ]
            if len(keep) == len(node.schema):
                return node  # nothing to prune
            # best case: the reader itself declines to DECODE the pruned
            # columns (JSON sources); a pushed source may still carry its
            # timestamp column, narrowed by a Project here
            pushed = node.source.with_projection(set(keep))
            if pushed is not None:
                scan = lp.Scan(node.table_name, pushed, pushed.schema)
                extra = set(pushed.schema.names) - set(keep)
                if extra - {CANONICAL_TIMESTAMP_COLUMN}:
                    return lp.Project(
                        scan,
                        [Column(n) for n in pushed.schema.names if n in keep],
                    )
                return scan
            return lp.Project(node, [Column(n) for n in keep])
        return map_children(node, lambda c: self._walk(c, None))


class MergeProjects:
    """Project(Project(x)) → Project(x) when the merged projection is at
    most ``_GROWTH_BOUND`` times the size of the two it replaces."""

    _GROWTH_BOUND = 2.0

    def rewrite(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        node = map_children(plan, self.rewrite)
        if isinstance(node, lp.Project) and isinstance(node.input, lp.Project):
            inner = node.input
            mapping = self._mapping(inner)
            if self._udf_inlined(node, mapping):
                return node  # UDFs may be expensive or non-deterministic
            merged = [
                self._realias(substitute_columns(e, mapping), e)
                for e in node.exprs
            ]
            before = self._size(node.exprs) + self._size(inner.exprs)
            if self._size(merged) > self._GROWTH_BOUND * before:
                return node
            return self.rewrite(lp.Project(inner.input, merged))
        return node

    @staticmethod
    def _mapping(p: lp.Project) -> dict[str, Expr]:
        return {f.name: e for f, e in zip(p.schema, p.exprs)}

    @staticmethod
    def _size(exprs) -> int:
        return sum(sum(1 for _ in _expr_nodes(e)) for e in exprs)

    @staticmethod
    def _udf_inlined(outer: lp.Project, mapping: dict[str, Expr]) -> bool:
        for e in outer.exprs:
            for n in _expr_nodes(e):
                if isinstance(n, Column):
                    inner_e = mapping.get(n.name)
                    if (
                        inner_e is not None
                        and not _is_trivial(inner_e)
                        and _contains(inner_e, ScalarUDFExpr)
                    ):
                        return True
        return False

    @staticmethod
    def _realias(sub: Expr, original: Expr) -> Expr:
        # keep the outer projection's output names stable
        want = original.name
        return sub if sub.name == want else AliasExpr(sub, want)


class FilterPushdown:
    """Filter(Project(x)) → Project(Filter'(x)); Filter(Filter(x)) → one
    conjunctive Filter."""

    def rewrite(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        node = map_children(plan, self.rewrite)
        if isinstance(node, lp.Filter):
            child = node.input
            if isinstance(child, lp.Filter):
                return self.rewrite(
                    lp.Filter(
                        child.input,
                        BinaryExpr("and", child.predicate, node.predicate),
                    )
                )
            if isinstance(child, lp.Project):
                mapping = MergeProjects._mapping(child)
                refs = node.predicate.columns_referenced()
                if not all(
                    n in mapping or child.input.schema.has(n) for n in refs
                ):
                    return node
                if _contains(node.predicate, IsNullExpr):
                    return node
                pred = substitute_columns(node.predicate, mapping)
                if _contains(pred, ScalarUDFExpr):
                    return node
                return self.rewrite(
                    lp.Project(lp.Filter(child.input, pred), child.exprs)
                )
        return node


# MergeProjects runs last, so each pass ends with stacked projections
# collapsed (ProjectionPruning re-wraps scans every pass)
DEFAULT_RULES = (ProjectionPruning(), FilterPushdown(), MergeProjects())
_MAX_PASSES = 5


def optimize(plan: lp.LogicalPlan, enabled: bool = True) -> lp.LogicalPlan:
    """Run the rules to a bounded fixpoint; ``enabled=False``
    (``EngineConfig.optimizer``) returns the plan untouched."""
    if not enabled:
        return plan
    prev = None
    for _ in range(_MAX_PASSES):
        for rule in DEFAULT_RULES:
            plan = rule.rewrite(plan)
        shape = plan.display()
        if shape == prev:
            break
        prev = shape
    return plan
