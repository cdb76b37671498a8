"""Aggregate function constructors.

Counterpart of ``denormalized_tpu/api/functions.py``, trimmed to the
aggregates the device ring finalizes (count/sum/min/max/avg) plus ``col``
and ``lit``.  The variance family, scalar functions, CASE and UDF/UDAF
factories are not ported yet.
"""

from __future__ import annotations

from denormalized_tpu_torch.logical.expr import AggregateExpr, Expr, col, lit

__all__ = ["count", "sum", "min", "max", "avg", "col", "lit"]


def _e(expr: Expr | str) -> Expr:
    return col(expr) if isinstance(expr, str) else expr


def count(expr: Expr | str | None = None) -> AggregateExpr:
    return AggregateExpr("count", _e(expr) if expr is not None else None)


def sum(expr: Expr | str) -> AggregateExpr:  # noqa: A001 - mirrors SQL name
    return AggregateExpr("sum", _e(expr))


def min(expr: Expr | str) -> AggregateExpr:  # noqa: A001
    return AggregateExpr("min", _e(expr))


def max(expr: Expr | str) -> AggregateExpr:  # noqa: A001
    return AggregateExpr("max", _e(expr))


def avg(expr: Expr | str) -> AggregateExpr:
    return AggregateExpr("avg", _e(expr))
