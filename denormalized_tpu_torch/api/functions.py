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

``__all__`` lists the JAX package's names.  The aggregates that cannot
decompose onto the ring — median, array_agg, first/last/nth_value,
string_agg, count_distinct, percentile_cont, the bit/bool family, corr,
covar and the regr_* family, and user accumulators (``udaf``) — run in the
host accumulator operator (``physical/udaf_exec.py``) through the
accumulators of :mod:`denormalized_tpu_torch.api.builtin_accumulators`;
the approximate kinds (approx_distinct, approx_median, approx_top_k,
approx_percentile_cont) carry their exact accumulator, which the planner
lowers them to.
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


def _builtin_udaf(acc_cls, return_type: DataType, name: str):
    from denormalized_tpu_torch.api.udaf import UDAF

    def make(expr: Expr | str) -> AggregateExpr:
        e = _e(expr)
        u = UDAF(acc_cls, (e,), return_type, name)
        return AggregateExpr("udaf", e, None, u)

    make.__name__ = name
    make.__doc__ = f"{name} aggregate (host accumulator frame path)."
    return make


def _builtin_accs():
    from denormalized_tpu_torch.api import builtin_accumulators as b

    return b


def array_agg(expr: Expr | str) -> AggregateExpr:
    """Collect values into a list per group-window; checkpoints through
    accumulator state (reference serializable_accumulator.rs:10-68)."""
    b = _builtin_accs()
    return _builtin_udaf(b.ArrayAggAccumulator, DataType.LIST, "array_agg")(expr)


def median(expr: Expr | str) -> AggregateExpr:
    b = _builtin_accs()
    return _builtin_udaf(b.MedianAccumulator, DataType.FLOAT64, "median")(expr)


def approx_median(expr: Expr | str) -> AggregateExpr:
    """Approximate median: a first-class mergeable quantile sketch on
    the multi-query slice path (documented rank-error bound, O(1) state
    per group — ops/sketches.py KllSpec); lowers to the exact
    MedianAccumulator on every other path."""
    from denormalized_tpu_torch.api.udaf import UDAF

    b = _builtin_accs()
    e = _e(expr)
    u = UDAF(b.MedianAccumulator, (e,), DataType.FLOAT64, "approx_median")
    return AggregateExpr("approx_median", e, None, u)


def first_value(expr: Expr | str) -> AggregateExpr:
    """First value in arrival order; result type follows the argument."""
    b = _builtin_accs()
    return _builtin_udaf(b.FirstValueAccumulator, None, "first_value")(expr)


def last_value(expr: Expr | str) -> AggregateExpr:
    """Last value in arrival order; result type follows the argument."""
    b = _builtin_accs()
    return _builtin_udaf(b.LastValueAccumulator, None, "last_value")(expr)


def approx_distinct(expr: Expr | str) -> AggregateExpr:
    """HyperLogLog distinct count (~1.6% error, mergeable sketch state).

    First-class on the multi-query slice path: a vectorized (G, 4096)
    int8 register plane per slice unit, shared across concurrent
    queries, byte-identical through kill/restore (stable blake2b /
    splitmix64 hashing).  Lowers to the accumulator-frame HLL shim on
    every other path."""
    from denormalized_tpu_torch.api.udaf import UDAF

    b = _builtin_accs()
    e = _e(expr)
    u = UDAF(
        b.ApproxDistinctAccumulator, (e,), DataType.INT64, "approx_distinct"
    )
    return AggregateExpr("approx_distinct", e, None, u)


def approx_top_k(expr: Expr | str, k: int = 10) -> AggregateExpr:
    """Top-k most frequent values as ``[value, count]`` pairs,
    count-descending — Space-Saving planes on the multi-query slice
    path (``count - err <= true <= count`` per reported value, O(k)
    state per group); exact dict counting on the fallback path."""
    from denormalized_tpu_torch.api.udaf import UDAF

    b = _builtin_accs()
    e = _e(expr)
    k = int(k)

    class _Bound(b.ApproxTopKAccumulator):
        def __init__(self):
            super().__init__(k)

    _Bound.__name__ = f"ApproxTopK[{k}]"
    u = UDAF(_Bound, (e,), DataType.LIST, f"approx_top_k_{k}")
    return AggregateExpr("approx_top_k", e, None, u, (k,))


def count_distinct(expr: Expr | str) -> AggregateExpr:
    """Exact distinct count (DataFusion ``count(distinct x)``)."""
    b = _builtin_accs()
    return _builtin_udaf(
        b.CountDistinctAccumulator, DataType.INT64, "count_distinct"
    )(expr)


def percentile_cont(expr: Expr | str, q: float) -> AggregateExpr:
    """Exact continuous percentile with linear interpolation (covers
    DataFusion's approx_percentile_cont use cases exactly)."""
    b = _builtin_accs()

    class _Bound(b.PercentileContAccumulator):
        def __init__(self):
            super().__init__(q)

    _Bound.__name__ = f"PercentileCont[{q}]"
    return _builtin_udaf(
        _Bound, DataType.FLOAT64, f"percentile_cont_{q}"
    )(expr)


def approx_percentile_cont(expr: Expr | str, q: float) -> AggregateExpr:
    """Approximate continuous percentile: compactor quantile sketch on
    the multi-query slice path (self-reported rank-error bound, O(1)
    state per group); lowers to the exact interpolating
    :func:`percentile_cont` accumulator on every other path."""
    from denormalized_tpu_torch.api.udaf import UDAF

    b = _builtin_accs()

    class _Bound(b.PercentileContAccumulator):
        def __init__(self):
            super().__init__(q)

    _Bound.__name__ = f"PercentileCont[{q}]"
    e = _e(expr)
    u = UDAF(_Bound, (e,), DataType.FLOAT64, f"percentile_cont_{q}")
    return AggregateExpr(
        "approx_percentile_cont", e, None, u, (float(q),)
    )


def approx_percentile_cont_with_weight(
    expr: Expr | str, weight: Expr | str, q: float
) -> AggregateExpr:
    """Weighted continuous percentile (reference functions.py
    approx_percentile_cont_with_weight; exact here)."""
    b = _builtin_accs()

    class _Bound(b.WeightedPercentileAccumulator):
        def __init__(self):
            super().__init__(q)

    _Bound.__name__ = f"WeightedPercentile[{q}]"
    from denormalized_tpu_torch.api.udaf import UDAF

    e, w = _e(expr), _e(weight)
    u = UDAF(_Bound, (e, w), DataType.FLOAT64, f"percentile_weight_{q}")
    return AggregateExpr("udaf", e, None, u)


def string_agg(expr: Expr | str, delimiter: str = ",") -> AggregateExpr:
    """Concatenate values with a delimiter (reference ``string_agg``)."""
    b = _builtin_accs()

    class _Bound(b.StringAggAccumulator):
        def __init__(self):
            super().__init__(delimiter)

    _Bound.__name__ = f"StringAgg[{delimiter!r}]"
    return _builtin_udaf(_Bound, DataType.STRING, "string_agg")(expr)


def nth_value(expr: Expr | str, n: int) -> AggregateExpr:
    """N-th value in arrival order, 1-based (reference ``nth_value``)."""
    b = _builtin_accs()

    class _Bound(b.NthValueAccumulator):
        def __init__(self):
            super().__init__(n)

    _Bound.__name__ = f"NthValue[{n}]"
    return _builtin_udaf(_Bound, None, f"nth_value_{n}")(expr)


def _bool_bit_agg(acc_attr: str, name: str, rt: DataType):
    def make(expr: Expr | str) -> AggregateExpr:
        b = _builtin_accs()
        return _builtin_udaf(getattr(b, acc_attr), rt, name)(expr)

    make.__name__ = name
    make.__doc__ = f"{name} aggregate (reference functions.py exports it)."
    return make


bit_and = _bool_bit_agg("BitAndAccumulator", "bit_and", DataType.INT64)
bit_or = _bool_bit_agg("BitOrAccumulator", "bit_or", DataType.INT64)
bit_xor = _bool_bit_agg("BitXorAccumulator", "bit_xor", DataType.INT64)
bool_and = _bool_bit_agg("BoolAndAccumulator", "bool_and", DataType.BOOL)
bool_or = _bool_bit_agg("BoolOrAccumulator", "bool_or", DataType.BOOL)


def _bivariate(stat: str, rt: DataType = DataType.FLOAT64):
    """Two-column aggregate over shared sufficient statistics (reference
    functions.py:1658-2066 corr/covar/regr_* — DataFusion's argument
    order ``(value_y, value_x)``)."""

    def make(value_y: Expr | str, value_x: Expr | str) -> AggregateExpr:
        b = _builtin_accs()

        class _Bound(b.TwoColStatsAccumulator):
            pass

        _Bound.stat = stat
        _Bound.__name__ = f"TwoColStats[{stat}]"
        from denormalized_tpu_torch.api.udaf import UDAF

        ey, ex = _e(value_y), _e(value_x)
        u = UDAF(_Bound, (ey, ex), rt, stat)
        return AggregateExpr("udaf", ey, None, u)

    make.__name__ = stat
    make.__doc__ = (
        f"{stat}(value_y, value_x) bivariate aggregate "
        "(sufficient-statistics decomposition, mergeable for checkpoints)."
    )
    return make


corr = _bivariate("corr")
covar = _bivariate("covar")
covar_pop = _bivariate("covar_pop")
covar_samp = _bivariate("covar_samp")
regr_avgx = _bivariate("regr_avgx")
regr_avgy = _bivariate("regr_avgy")
regr_count = _bivariate("regr_count", DataType.INT64)
regr_intercept = _bivariate("regr_intercept")
regr_r2 = _bivariate("regr_r2")
regr_slope = _bivariate("regr_slope")
regr_sxx = _bivariate("regr_sxx")
regr_sxy = _bivariate("regr_sxy")
regr_syy = _bivariate("regr_syy")


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
    """User-defined aggregate: ``accumulator_cls`` subclasses
    :class:`denormalized_tpu_torch.api.udaf.Accumulator` (reference
    py-denormalized python/denormalized/datafusion/udf.py Accumulator +
    python/examples/udaf_example.py)."""
    from denormalized_tpu_torch.api.udaf import UDAF

    name = name or getattr(accumulator_cls, "__name__", "udaf")

    def make(*args: Expr | str) -> AggregateExpr:
        exprs = [col(a) if isinstance(a, str) else a for a in args]
        u = UDAF(accumulator_cls, tuple(exprs), return_type, name)
        return AggregateExpr("udaf", exprs[0] if exprs else None, None, u)

    return make
