"""Expression tree: columns, literals, arithmetic/comparison ops, aliases,
and aggregate calls.

Counterpart of ``denormalized_tpu/logical/expr.py``, trimmed to what the
window job needs: ``Column``, ``Literal``, ``AliasExpr``, the arithmetic and
comparison ``BinaryExpr`` (``.filter(col("avg") > 45.0)``), ``AggregateExpr``
for count/sum/min/max/avg, and ``column_validity``.  Evaluation is host-side
vectorized numpy over a ``RecordBatch``; the device evaluator of the JAX
package (``eval_jax``) is not ported yet.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from denormalized_tpu_torch.common.errors import PlanError, SchemaError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema

_BIN_NUMPY: dict[str, Callable] = {
    "+": operator.add,
    "-": operator.sub,
    "*": operator.mul,
    "/": operator.truediv,
    "%": operator.mod,
    "==": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
    "and": np.logical_and,
    "or": np.logical_or,
}

_CMP = {"==", "!=", "<", "<=", ">", ">="}
_BOOL = {"and", "or"}


class Expr:
    """Base expression node; its operator methods mirror datafusion-python's
    Expr."""

    # -- operator sugar --------------------------------------------------
    def __add__(self, other):
        return BinaryExpr("+", self, _wrap(other))

    def __radd__(self, other):
        return BinaryExpr("+", _wrap(other), self)

    def __sub__(self, other):
        return BinaryExpr("-", self, _wrap(other))

    def __rsub__(self, other):
        return BinaryExpr("-", _wrap(other), self)

    def __mul__(self, other):
        return BinaryExpr("*", self, _wrap(other))

    def __rmul__(self, other):
        return BinaryExpr("*", _wrap(other), self)

    def __truediv__(self, other):
        return BinaryExpr("/", self, _wrap(other))

    def __rtruediv__(self, other):
        return BinaryExpr("/", _wrap(other), self)

    def __mod__(self, other):
        return BinaryExpr("%", self, _wrap(other))

    def __eq__(self, other):  # type: ignore[override]
        return BinaryExpr("==", self, _wrap(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinaryExpr("!=", self, _wrap(other))

    def __lt__(self, other):
        return BinaryExpr("<", self, _wrap(other))

    def __le__(self, other):
        return BinaryExpr("<=", self, _wrap(other))

    def __gt__(self, other):
        return BinaryExpr(">", self, _wrap(other))

    def __ge__(self, other):
        return BinaryExpr(">=", self, _wrap(other))

    def __and__(self, other):
        return BinaryExpr("and", self, _wrap(other))

    def __or__(self, other):
        return BinaryExpr("or", self, _wrap(other))

    def __hash__(self):
        return hash(repr(self))

    def alias(self, name: str) -> "Expr":
        return AliasExpr(self, name)

    # -- interface -------------------------------------------------------
    @property
    def name(self) -> str:
        """Output column name."""
        raise NotImplementedError

    def out_field(self, schema: Schema) -> Field:
        raise NotImplementedError

    def eval(self, batch: RecordBatch) -> np.ndarray:
        """Vectorized host evaluation → one array of batch.num_rows."""
        raise NotImplementedError

    def columns_referenced(self) -> set[str]:
        raise NotImplementedError


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else Literal(v)


@dataclass(frozen=True, eq=False)
class Column(Expr):
    _name: str

    @property
    def name(self) -> str:
        return self._name

    def out_field(self, schema: Schema) -> Field:
        return schema.field(self._name)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        return batch.column(self._name)

    def columns_referenced(self) -> set[str]:
        return {self._name}

    def __repr__(self):
        return f"col({self._name!r})"


@dataclass(frozen=True, eq=False)
class Literal(Expr):
    value: Any

    @property
    def name(self) -> str:
        return f"lit({self.value})"

    def out_field(self, schema: Schema) -> Field:
        return Field(self.name, _literal_dtype(self.value), nullable=False)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        dt = _literal_dtype(self.value).to_numpy()
        return np.full(batch.num_rows, self.value, dtype=dt)

    def columns_referenced(self) -> set[str]:
        return set()

    def __repr__(self):
        return f"lit({self.value!r})"


def _literal_dtype(v) -> DataType:
    if isinstance(v, bool):
        return DataType.BOOL
    if isinstance(v, (int, np.integer)):
        return DataType.INT64
    if isinstance(v, (float, np.floating)):
        return DataType.FLOAT64
    if isinstance(v, str):
        return DataType.STRING
    raise PlanError(f"unsupported literal {v!r}")


@dataclass(frozen=True, eq=False)
class BinaryExpr(Expr):
    op: str
    left: Expr
    right: Expr

    @property
    def name(self) -> str:
        return f"{self.left.name} {self.op} {self.right.name}"

    def out_field(self, schema: Schema) -> Field:
        if self.op in _CMP or self.op in _BOOL:
            return Field(self.name, DataType.BOOL)
        lf = self.left.out_field(schema)
        rf = self.right.out_field(schema)
        return Field(self.name, _promote(lf.dtype, rf.dtype, self.op))

    def eval(self, batch: RecordBatch) -> np.ndarray:
        l = self.left.eval(batch)
        r = self.right.eval(batch)
        l_obj = getattr(l, "dtype", None) == object
        r_obj = getattr(r, "dtype", None) == object
        if self.op in _CMP and (l_obj or r_obj):
            # object lanes carry strings and/or nullable cells: any
            # comparison against a null (None) cell is FALSE
            valid = None
            for side, is_obj in ((l, l_obj), (r, r_obj)):
                if not is_obj:
                    continue
                m = np.not_equal(side, None).astype(bool)
                valid = m if valid is None else (valid & m)
            if bool(valid.all()):
                return _BIN_NUMPY[self.op](l, r).astype(bool)
            lv = l[valid] if np.shape(l) == valid.shape else l
            rv = r[valid] if np.shape(r) == valid.shape else r
            out = np.zeros(valid.shape, dtype=bool)
            out[valid] = _BIN_NUMPY[self.op](lv, rv).astype(bool)
            return out
        return _BIN_NUMPY[self.op](l, r)

    def columns_referenced(self) -> set[str]:
        return self.left.columns_referenced() | self.right.columns_referenced()

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


def _promote(a: DataType, b: DataType, op: str) -> DataType:
    if op == "/":
        return DataType.FLOAT64
    order = [
        DataType.BOOL,
        DataType.INT32,
        DataType.INT64,
        DataType.TIMESTAMP_MS,
        DataType.FLOAT32,
        DataType.FLOAT64,
    ]
    if a in order and b in order:
        return order[max(order.index(a), order.index(b))]
    if DataType.STRING in (a, b):
        return DataType.STRING
    raise SchemaError(f"cannot promote {a} and {b}")


@dataclass(frozen=True, eq=False)
class AliasExpr(Expr):
    inner: Expr
    _name: str

    @property
    def name(self) -> str:
        return self._name

    def out_field(self, schema: Schema) -> Field:
        f = self.inner.out_field(schema)
        return Field(self._name, f.dtype, f.nullable, f.children)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        return self.inner.eval(batch)

    def columns_referenced(self) -> set[str]:
        return self.inner.columns_referenced()

    def __repr__(self):
        return f"{self.inner!r}.alias({self._name!r})"


# -- aggregates ---------------------------------------------------------

AGG_KINDS = ("count", "sum", "min", "max", "avg")


@dataclass(frozen=True, eq=False)
class AggregateExpr(Expr):
    """An aggregate call inside window(): count/sum/min/max/avg."""

    kind: str  # one of AGG_KINDS
    arg: Expr | None  # None for count(*)
    _alias: str | None = None

    def __post_init__(self):
        if self.kind not in AGG_KINDS:
            raise PlanError(
                f"aggregate {self.kind!r} not yet ported to "
                f"denormalized_tpu_torch (ported: {', '.join(AGG_KINDS)})"
            )

    @property
    def name(self) -> str:
        if self._alias:
            return self._alias
        argname = self.arg.name if self.arg is not None else "*"
        return f"{self.kind}({argname})"

    def alias(self, name: str) -> "AggregateExpr":
        return AggregateExpr(self.kind, self.arg, name)

    def out_field(self, schema: Schema) -> Field:
        if self.kind == "count":
            return Field(self.name, DataType.INT64, nullable=False)
        if self.kind == "avg":
            return Field(self.name, DataType.FLOAT64)
        f = self.arg.out_field(schema)
        if self.kind == "sum":
            if f.dtype in (DataType.INT32, DataType.INT64, DataType.BOOL):
                return Field(self.name, DataType.INT64)
            return Field(self.name, DataType.FLOAT64)
        return Field(self.name, f.dtype)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        raise PlanError("aggregate expression outside window()")

    def columns_referenced(self) -> set[str]:
        return self.arg.columns_referenced() if self.arg is not None else set()

    def __repr__(self):
        return self.name


def column_validity(e: Expr, batch: RecordBatch) -> np.ndarray | None:
    """Row validity of an expression's output: the AND of the null masks of
    every column it reads.  None = all valid."""
    m = None
    refs = (e.name,) if isinstance(e, Column) else e.columns_referenced()
    for ref in refs:
        rm = batch.mask(ref) if batch.schema.has(ref) else None
        if rm is not None:
            m = rm if m is None else (m & rm)
    return m


# -- public constructors (mirror datafusion-python functions module) -----


def col(name: str) -> Expr:
    return Column(name)


def lit(value) -> Expr:
    return Literal(value)
