"""Aggregate / scalar function constructors.

Counterpart of ``denormalized_tpu/api/functions.py``: the public surface
mirroring datafusion-python's ``functions`` module as the reference
re-exports it (py-denormalized/python/denormalized/datafusion/functions.py):
string/math/date/conditional/array/struct scalar functions injected from
the registry (:mod:`denormalized_tpu_torch.logical.scalar_functions`),
CASE, ranking and offset window functions, ``in_list``, ``order_by`` and
scalar UDFs, and the aggregates the device ring accumulates
(count/sum/min/max/avg, with ``count_star`` and ``mean``, and the variance
family: ``stddev``, ``stddev_pop``, ``var``, ``var_pop`` and the aliases
``stddev_samp``, ``var_samp``, ``var_sample``).

``__all__`` lists the JAX package's names.  The aggregates the port cannot
run yet — every UDAF- or sketch-backed one (median, array_agg,
approx_distinct, corr, bit_and, ``udaf``, ...) — exist by the same names
and raise a ``PlanError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import Callable

from denormalized_tpu_torch.common.schema import DataType
from denormalized_tpu_torch.logical.expr import (
    AggregateExpr,
    CaseBuilder,
    Expr,
    ScalarFunctionExpr,
    ScalarUDFExpr,
    col,
    lit,
    unported_aggregate,
)
from denormalized_tpu_torch.logical.scalar_functions import REGISTRY, lookup

__all__ = [  # noqa: F822 - scalar names are injected below
    "count", "count_star", "sum", "min", "max", "avg", "mean",
    "stddev", "stddev_samp", "stddev_pop", "var", "var_samp", "var_sample",
    "var_pop",
    "median", "approx_median", "array_agg", "first_value", "last_value",
    "nth_value", "string_agg",
    "approx_distinct", "approx_top_k", "count_distinct", "percentile_cont",
    "approx_percentile_cont", "approx_percentile_cont_with_weight",
    "bit_and", "bit_or", "bit_xor", "bool_and", "bool_or",
    "corr", "covar", "covar_pop", "covar_samp",
    "regr_avgx", "regr_avgy", "regr_count", "regr_intercept", "regr_r2",
    "regr_slope", "regr_sxx", "regr_sxy", "regr_syy",
    "case", "when", "udf", "udaf", "col", "lit",
    "alias", "order_by", "in_list",
    "window", "lead", "lag", "row_number", "rank", "dense_rank",
    "percent_rank", "cume_dist", "ntile",
] + sorted(REGISTRY)


def _e(expr: Expr | str) -> Expr:
    return col(expr) if isinstance(expr, str) else expr


# -- aggregates ----------------------------------------------------------


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


def count_star() -> AggregateExpr:
    """COUNT(*) (reference functions.py:371)."""
    return count(None)


def mean(expr: Expr | str) -> AggregateExpr:
    """Alias of :func:`avg` (reference functions.py:1760)."""
    return avg(expr)


def stddev(expr: Expr | str) -> AggregateExpr:
    """Sample standard deviation (decomposes onto the device ring)."""
    return AggregateExpr("stddev", _e(expr))


def stddev_samp(expr: Expr | str) -> AggregateExpr:
    return AggregateExpr("stddev", _e(expr))


def stddev_pop(expr: Expr | str) -> AggregateExpr:
    return AggregateExpr("stddev_pop", _e(expr))


def var(expr: Expr | str) -> AggregateExpr:
    """Sample variance (DataFusion ``var``/``var_samp``)."""
    return AggregateExpr("var", _e(expr))


def var_samp(expr: Expr | str) -> AggregateExpr:
    return AggregateExpr("var", _e(expr))


def var_sample(expr: Expr | str) -> AggregateExpr:
    """Alias of :func:`var` (reference functions.py:1893)."""
    return var(expr)


def var_pop(expr: Expr | str) -> AggregateExpr:
    return AggregateExpr("var_pop", _e(expr))


def _unported(name: str, kind: str | None = None):
    """A constructor the port has by name but cannot run yet: calling it
    raises the ``PlanError`` that names its ROADMAP item."""
    kind = kind or name

    def make(*args, **kwargs) -> AggregateExpr:
        raise unported_aggregate(kind)

    make.__name__ = name
    make.__doc__ = (
        f"{name} aggregate — not ported yet: raises PlanError naming the "
        f"ROADMAP item that brings it."
    )
    return make


# UDAF- and sketch-backed aggregates (the JAX package's host accumulator
# frame path)
median = _unported("median")
approx_median = _unported("approx_median")
array_agg = _unported("array_agg")
first_value = _unported("first_value")
last_value = _unported("last_value")
nth_value = _unported("nth_value")
string_agg = _unported("string_agg")
approx_distinct = _unported("approx_distinct")
approx_top_k = _unported("approx_top_k")
count_distinct = _unported("count_distinct")
percentile_cont = _unported("percentile_cont")
approx_percentile_cont = _unported("approx_percentile_cont")
approx_percentile_cont_with_weight = _unported(
    "approx_percentile_cont_with_weight"
)
bit_and = _unported("bit_and")
bit_or = _unported("bit_or")
bit_xor = _unported("bit_xor")
bool_and = _unported("bool_and")
bool_or = _unported("bool_or")
corr = _unported("corr")
covar = _unported("covar")
covar_pop = _unported("covar_pop")
covar_samp = _unported("covar_samp")
regr_avgx = _unported("regr_avgx")
regr_avgy = _unported("regr_avgy")
regr_count = _unported("regr_count")
regr_intercept = _unported("regr_intercept")
regr_r2 = _unported("regr_r2")
regr_slope = _unported("regr_slope")
regr_sxx = _unported("regr_sxx")
regr_sxy = _unported("regr_sxy")
regr_syy = _unported("regr_syy")


# -- CASE ----------------------------------------------------------------


def case(expr: Expr | str) -> CaseBuilder:
    """Simple CASE: ``case(col('x')).when(1, 'one').otherwise('other')``."""
    return CaseBuilder(_e(expr))


def when(cond, result) -> CaseBuilder:
    """Searched CASE: ``when(col('x') > 0, 'pos').otherwise('neg')``."""
    return CaseBuilder(None).when(cond, result)


# -- scalar functions (registry-driven) ----------------------------------


def _scalar_constructor(fname: str):
    spec = lookup(fname)

    def make(*args) -> Expr:
        lo = spec.min_args
        hi = spec.max_args if spec.max_args is not None else spec.min_args
        if not (lo <= len(args) <= hi):
            from denormalized_tpu_torch.common.errors import PlanError

            want = str(lo) if lo == hi else f"{lo}..{hi}"
            raise PlanError(
                f"{fname}() takes {want} argument(s), got {len(args)}"
            )
        # string-arg convention: the FIRST argument names a column, later
        # string arguments are literals (`replace("name", "from", "to")`);
        # unit-taking date functions treat every string as a literal
        # (`date_trunc("minute", col("ts"))`).  Pass col()/lit() explicitly
        # to override.
        exprs = tuple(
            col(a)
            if isinstance(a, str) and i == 0 and fname not in _ALL_STR_LITERAL
            else _wrap_arg(a)
            for i, a in enumerate(args)
        )
        return ScalarFunctionExpr(fname, exprs)

    make.__name__ = fname
    make.__doc__ = (
        f"Scalar function ``{fname}`` (datafusion parity).  A bare string "
        "as the first argument is a column name; later bare strings are "
        "literals."
    )
    return make


def _wrap_arg(a) -> Expr:
    from denormalized_tpu_torch.logical.expr import _wrap

    return _wrap(a)


# functions whose FIRST string argument is a literal (unit name), not a
# column reference
_ALL_STR_LITERAL = {
    "date_trunc", "date_part", "datetrunc", "datepart", "extract", "chr",
    "named_struct",
}

for _fname in REGISTRY:
    globals()[_fname] = _scalar_constructor(_fname)
del _fname

# -- explicit overrides of registry-generated constructors ---------------
# (defined AFTER the injection loop so these richer signatures win)

_registry_in_list = globals()["in_list"]
_registry_array_sort = globals()["array_sort"]
_registry_named_struct = globals()["named_struct"]


def in_list(arg: Expr | str, values: list, negated: bool = False) -> Expr:
    """Membership test (reference functions.py:323): ``values`` is a
    python list of expressions/literals; ``negated=True`` gives NOT IN."""
    e = _registry_in_list(arg, *[_wrap_arg(v) for v in values])
    return ~e if negated else e


def array_sort(
    array: Expr | str, descending: bool = False, null_first: bool = False
) -> Expr:
    """Sort list elements (reference functions.py:1401 — python bool
    flags, converted to literals for the row-wise kernel)."""
    return _registry_array_sort(array, lit(bool(descending)), lit(bool(null_first)))


list_sort = array_sort


def named_struct(*args) -> Expr:
    """STRUCT with named fields.  Accepts the reference's list-of-pairs
    form ``named_struct([("a", e1), ("b", e2)])`` (functions.py:1059) or
    flat ``named_struct("a", e1, "b", e2)``."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        flat: list = []
        for name, value in args[0]:
            flat.extend([name, value])
        args = tuple(flat)
    return _registry_named_struct(*args)


def alias(expr: Expr | str, name: str) -> Expr:
    """Function form of ``expr.alias(name)`` (reference functions.py:361)."""
    return _e(expr).alias(name)


def order_by(
    expr: Expr | str, ascending: bool = True, nulls_first: bool = True
):
    """Sort specification (reference functions.py:356) — consumed by
    order-aware aggregate options and ``DataStream.sort`` on bounded
    collects."""
    from denormalized_tpu_torch.logical.expr import SortExpr

    return SortExpr(_e(expr), ascending, nulls_first)


# -- ranking / offset window functions -----------------------------------


def _win(wname, args=(), partition_by=None, order_by=None, params=()):
    from denormalized_tpu_torch.logical.expr import SortExpr, WindowFunctionExpr

    def _sort(x):
        if isinstance(x, SortExpr):
            return x
        return SortExpr(_e(x))

    return WindowFunctionExpr(
        wname,
        tuple(_e(a) for a in args),
        tuple(_e(p) for p in (partition_by or ())),
        tuple(_sort(s) for s in (order_by or ())),
        params,
    )


def window(name, args, partition_by=None, order_by=None, window_frame=None):
    """Window function by name (reference functions.py:405).  Custom
    window frames are not supported — the ranking/offset family ignores
    frames in DataFusion too."""
    if window_frame is not None:
        from denormalized_tpu_torch.common.errors import PlanError

        raise PlanError(
            "custom window frames are not supported; the ranking/offset "
            "window functions operate over the whole partition"
        )
    name = name.lower()
    if name in ("lead", "lag"):
        a = list(args)
        shift = a[1] if len(a) > 1 else 1
        default = a[2] if len(a) > 2 else None
        return _win(name, a[:1], partition_by, order_by,
                    (int(getattr(shift, "value", shift)),
                     getattr(default, "value", default)))
    if name == "ntile":
        n = args[0] if args else 1
        return _win(name, (), partition_by, order_by,
                    (int(getattr(n, "value", n)),))
    if name in ("row_number", "rank", "dense_rank", "percent_rank",
                "cume_dist"):
        return _win(name, (), partition_by, order_by)
    from denormalized_tpu_torch.common.errors import PlanError

    raise PlanError(f"unknown window function {name!r}")


def lead(arg, shift_offset: int = 1, default_value=None,
         partition_by=None, order_by=None):
    """Value from the row ``shift_offset`` AFTER the current one in the
    partition (reference functions.py:2292)."""
    return _win("lead", (arg,), partition_by, order_by,
                (shift_offset, default_value))


def lag(arg, shift_offset: int = 1, default_value=None,
        partition_by=None, order_by=None):
    """Value from the row ``shift_offset`` BEFORE the current one in the
    partition (reference functions.py:2347)."""
    return _win("lag", (arg,), partition_by, order_by,
                (shift_offset, default_value))


def row_number(partition_by=None, order_by=None):
    """1-based row number within the partition (reference :2399)."""
    return _win("row_number", (), partition_by, order_by)


def rank(partition_by=None, order_by=None):
    """Olympic-medal rank with gaps after ties (reference :2435)."""
    return _win("rank", (), partition_by, order_by)


def dense_rank(partition_by=None, order_by=None):
    """Rank without gaps after ties (reference :2476)."""
    return _win("dense_rank", (), partition_by, order_by)


def percent_rank(partition_by=None, order_by=None):
    """(rank - 1) / (rows - 1) (reference :2500)."""
    return _win("percent_rank", (), partition_by, order_by)


def cume_dist(partition_by=None, order_by=None):
    """Cumulative distribution: rows with key <= current / rows."""
    return _win("cume_dist", (), partition_by, order_by)


def ntile(arg, partition_by=None, order_by=None):
    """Bucket number 1..N over the partition (reference :2560)."""
    n = int(getattr(arg, "value", arg))
    return _win("ntile", (), partition_by, order_by, (n,))


def udf(fn: Callable, return_type: DataType, name: str | None = None):
    """Scalar UDF over vectorized columns (reference udf_example.rs:22-60,
    py udf.py)."""

    name = name or getattr(fn, "__name__", "udf")

    def make(*args: Expr | str) -> Expr:
        exprs = tuple(col(a) if isinstance(a, str) else a for a in args)
        return ScalarUDFExpr(fn, exprs, name, return_type)

    return make


def udaf(accumulator_cls, return_type: DataType, name: str | None = None):
    """User-defined aggregate — not ported yet: raises the ``PlanError``
    that names ROADMAP §A item 6 (the UDAF executor)."""
    raise unported_aggregate("udaf")
