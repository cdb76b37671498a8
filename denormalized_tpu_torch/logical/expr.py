"""Expression tree: columns, literals, arithmetic/comparison/boolean ops,
struct-field access, casts, scalar and window functions, CASE, UDFs,
aliases, and aggregate calls.

Counterpart of ``denormalized_tpu/logical/expr.py``.  Two evaluators exist:

- :meth:`Expr.eval` — host-side vectorized numpy over a ``RecordBatch``
  (projections, filters, join keys, string work): the path that runs;
- :meth:`Expr.eval_torch` — the same tree traced over a dict of column →
  ``torch.Tensor``, computed on the tensors' own device (the JAX package's
  ``eval_jax``).  It raises where ``eval_jax`` raises: a function with no
  device form, a cast to a host-only type.

A batch column is a numpy array or an Arrow-layout ``Column``
(``common/columns.py``): the columnar fast paths read a ``StringColumn``'s
or ``NestedColumn``'s buffers, and every other node materializes it
through ``as_numpy``, as the JAX package does.  Aggregates are the ones the
device ring finalizes (count/sum/min/max/avg); the others raise a
``PlanError`` that names the ROADMAP item bringing them.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from denormalized_tpu_torch.common.columns import as_numpy
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

    def __invert__(self):
        return NotExpr(self)

    def __hash__(self):
        return hash(repr(self))

    def alias(self, name: str) -> "Expr":
        return AliasExpr(self, name)

    def field(self, name: str) -> "Expr":
        """Struct-field access: ``col('gps').field('speed')``."""
        return FieldAccessExpr(self, name)

    def cast(self, dtype: DataType) -> "Expr":
        return CastExpr(self, dtype)

    def is_null(self) -> "Expr":
        return IsNullExpr(self, negate=False)

    def is_not_null(self) -> "Expr":
        return IsNullExpr(self, negate=True)

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

    def eval_torch(self, cols: dict[str, Any]):
        """Trace over a dict of column -> tensor, on the tensors' device."""
        raise NotImplementedError

    def columns_referenced(self) -> set[str]:
        raise NotImplementedError


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else Literal(v)


def _as_tensor(v, device=None):
    """A traced value as a tensor: a python scalar (a literal) becomes a
    0-d tensor on ``device`` (the other operand's), which takes part in
    type promotion as jax's weakly typed scalars do."""
    import torch

    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=device)


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

    def eval_torch(self, cols: dict[str, Any]):
        if self._name not in cols:
            raise SchemaError(f"column {self._name!r} not on device")
        return cols[self._name]

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

    def eval_torch(self, cols: dict[str, Any]):
        return self.value

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
        l = as_numpy(self.left.eval(batch))
        r = as_numpy(self.right.eval(batch))
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

    def eval_torch(self, cols: dict[str, Any]):
        import torch

        l = self.left.eval_torch(cols)
        r = self.right.eval_torch(cols)
        # a literal operand follows the other operand onto its device
        l = _as_tensor(l, r.device if isinstance(r, torch.Tensor) else None)
        if self.op in _BOOL:
            r = _as_tensor(r, l.device)  # logical ops take tensors only
        fn = {
            # remainder, not fmod: the result takes the divisor's sign, as
            # jnp.mod's does
            "+": torch.add, "-": torch.sub, "*": torch.mul,
            "/": torch.true_divide, "%": torch.remainder,
            "==": torch.eq, "!=": torch.ne,
            "<": torch.lt, "<=": torch.le,
            ">": torch.gt, ">=": torch.ge,
            "and": torch.logical_and, "or": torch.logical_or,
        }[self.op]
        return fn(l, r)

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
class NotExpr(Expr):
    inner: Expr

    @property
    def name(self) -> str:
        return f"NOT {self.inner.name}"

    def out_field(self, schema: Schema) -> Field:
        return Field(self.name, DataType.BOOL)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        return np.logical_not(self.inner.eval(batch))

    def eval_torch(self, cols):
        import torch

        return torch.logical_not(_as_tensor(self.inner.eval_torch(cols)))

    def columns_referenced(self) -> set[str]:
        return self.inner.columns_referenced()

    def __repr__(self):
        return f"(~{self.inner!r})"


@dataclass(frozen=True, eq=False)
class IsNullExpr(Expr):
    inner: Expr
    negate: bool

    @property
    def name(self) -> str:
        return f"{self.inner.name} IS {'NOT ' if self.negate else ''}NULL"

    def out_field(self, schema: Schema) -> Field:
        return Field(self.name, DataType.BOOL)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        from denormalized_tpu_torch.common.columns import Column as _ColData

        if isinstance(self.inner, Column):
            m = batch.mask(self.inner.name)
            null = (
                np.zeros(batch.num_rows, dtype=bool) if m is None else ~m
            )
            v = batch.column(self.inner.name)
            if isinstance(v, _ColData):
                # columnar string/nested columns carry nulls as validity
                # — read it directly, no row materialization
                validity = getattr(v, "validity", None)
                if validity is not None:
                    null = null | ~validity
            elif v.dtype == object:
                # string/derived columns carry nulls as None VALUES (scalar
                # functions propagate None without materializing a mask) —
                # both representations are null
                null = null | np.fromiter(
                    (x is None for x in v), dtype=bool, count=len(v)
                )
        else:
            v = self.inner.eval(batch)
            if isinstance(v, _ColData):
                validity = getattr(v, "validity", None)
                null = (
                    ~validity if validity is not None
                    else np.zeros(len(v), bool)
                )
            else:
                null = (
                    np.array([x is None for x in v])
                    if v.dtype == object
                    else np.isnan(v) if v.dtype.kind == "f" else np.zeros(len(v), bool)
                )
        return ~null if self.negate else null

    def columns_referenced(self) -> set[str]:
        return self.inner.columns_referenced()


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

    def eval_torch(self, cols):
        return self.inner.eval_torch(cols)

    def columns_referenced(self) -> set[str]:
        return self.inner.columns_referenced()

    def __repr__(self):
        return f"{self.inner!r}.alias({self._name!r})"


@dataclass(frozen=True)
class SortExpr:
    """Sort specification (the reference's ``order_by`` export,
    py-denormalized functions.py:356 → datafusion SortExpr): not itself a
    value expression — consumed by order-aware options (e.g. sorting a
    bounded ``collect``)."""

    expr: "Expr"
    ascending: bool = True
    nulls_first: bool = True

    def __repr__(self):
        d = "asc" if self.ascending else "desc"
        nf = "nulls_first" if self.nulls_first else "nulls_last"
        return f"{self.expr!r}.sort({d}, {nf})"


@dataclass(frozen=True, eq=False)
class WindowFunctionExpr(Expr):
    """Ranking / offset window function (the reference exports
    datafusion's lead/lag/row_number/rank/dense_rank/percent_rank/
    cume_dist/ntile, functions.py:2292-2560).

    Evaluation scope is the RecordBatch being projected: exact SQL
    semantics on bounded ``collect()`` results (which coalesce to one
    batch); on an unbounded stream the frame is each arrival batch —
    windowed aggregation is the streaming-native tool there."""

    wname: str
    args: tuple[Expr, ...] = ()
    partition_by: tuple[Expr, ...] = ()
    order_by: tuple["SortExpr", ...] = ()
    params: tuple = ()

    @property
    def name(self) -> str:
        inner = ", ".join(a.name for a in self.args)
        return f"{self.wname}({inner})"

    def out_field(self, schema: Schema) -> Field:
        if self.wname in ("lead", "lag"):
            f0 = self.args[0].out_field(schema)
            return Field(self.name, f0.dtype, True, f0.children)
        if self.wname in ("row_number", "rank", "dense_rank", "ntile"):
            return Field(self.name, DataType.INT64)
        if self.wname in ("percent_rank", "cume_dist"):
            return Field(self.name, DataType.FLOAT64)
        raise PlanError(f"unknown window function {self.wname!r}")

    def columns_referenced(self) -> set[str]:
        s: set[str] = set()
        for e in self.args + self.partition_by:
            s |= e.columns_referenced()
        for sx in self.order_by:
            s |= sx.expr.columns_referenced()
        return s

    def _order_index(self, batch: RecordBatch) -> tuple[np.ndarray, list]:
        """Row order within the batch under order_by (stable; repeated
        sorts from the least-significant key honor per-key direction and
        null placement), plus the composite order-key tuples for tie
        detection."""
        n = batch.num_rows
        idx = list(range(n))
        keycols = []
        for sx in self.order_by:
            vals = np.atleast_1d(sx.expr.eval(batch)).tolist()
            keycols.append(vals)
        for sx, vals in reversed(list(zip(self.order_by, keycols))):
            def k(i, vals=vals, sx=sx):
                v = vals[i]
                isnull = v is None or (isinstance(v, float) and v != v)
                # nulls get an extreme bucket; direction-aware so that
                # reverse=True keeps nulls where nulls_first asks
                null_rank = 0 if (sx.nulls_first != (not sx.ascending)) else 2
                return (null_rank if isnull else 1, _SortKey(v, isnull))

            idx.sort(key=k, reverse=not sx.ascending)
        keys = [
            tuple(vals[i] for vals in keycols) for i in range(n)
        ]
        return np.asarray(idx, np.int64), keys

    def _partition_ids(self, batch: RecordBatch, n: int) -> np.ndarray:
        """Dense partition ids via the group interner (the session/window
        operators' keying trick): numeric key columns dedupe through
        np.unique, string columns through the native PyObject interner —
        no per-row tuple construction.  Columns holding non-string objects
        fall back to the legacy Python path (the interner's ``str()``
        normalization could merge keys raw tuples would keep distinct)."""
        if not self.partition_by:
            return np.zeros(n, dtype=np.int32)
        from denormalized_tpu_torch.ops.interner import GroupInterner

        pcols = []
        for e in self.partition_by:
            v = np.atleast_1d(e.eval(batch))
            if v.dtype.kind == "f" and np.isnan(v).any():
                # comparator-path semantics: NaN != NaN, so every NaN key
                # is its OWN partition — np.unique would merge them
                raise _WindowFallback
            if v.dtype.kind not in "ifbuM" and not all(
                isinstance(x, str) or x is None for x in v.tolist()
            ):
                raise _WindowFallback
            pcols.append(v)
        return GroupInterner(len(pcols)).intern(pcols)

    def _order_keys_vec(
        self, batch: RecordBatch, n: int
    ) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """Per order-by column: an int64 ascending-composite sort key
        (null bucket ∘ direction-adjusted dense rank from sorted-unique)
        and a tie id.  Tie semantics preserved from the comparator path:
        None ties with None, float NaN never ties (each NaN is its own
        rank group).  Non-comparable (mixed-type) columns raise
        ``_WindowFallback``."""
        keys: list[np.ndarray] = []
        ties: list[np.ndarray] = []
        for sx in self.order_by:
            vals = np.atleast_1d(sx.expr.eval(batch))
            kind = vals.dtype.kind
            nan_rows = None
            if kind in "iub":
                null = np.zeros(n, dtype=bool)
            elif kind == "f":
                null = np.isnan(vals)
                nan_rows = np.nonzero(null)[0]
            elif kind == "M":
                null = np.isnat(vals)
            else:
                lst = vals.tolist()
                none_mask = np.fromiter(
                    (v is None for v in lst), dtype=bool, count=n
                )
                nan_mask = np.fromiter(
                    (isinstance(v, float) and v != v for v in lst),
                    dtype=bool,
                    count=n,
                )
                null = none_mask | nan_mask
                nan_rows = np.nonzero(nan_mask)[0]
            nn = ~null
            try:
                uniq, inv = np.unique(vals[nn], return_inverse=True)
            except TypeError:
                raise _WindowFallback from None
            nv = len(uniq)
            r = np.zeros(n, dtype=np.int64)
            r[nn] = inv if sx.ascending else (nv - 1) - inv
            # final null placement follows nulls_first regardless of
            # direction (matching the comparator path's null_rank logic)
            bucket = np.where(null, 0 if sx.nulls_first else 2, 1)
            keys.append(bucket.astype(np.int64) * (nv + 1) + r)
            tie = np.full(n, -1, dtype=np.int64)  # -1: the shared None tie
            tie[nn] = inv
            if nan_rows is not None and len(nan_rows):
                tie[nan_rows] = -2 - nan_rows  # NaN: unique per row
            ties.append(tie)
        return keys, ties

    def eval(self, batch: RecordBatch) -> np.ndarray:
        n = batch.num_rows
        try:
            pids = self._partition_ids(batch, n)
            okeys, oties = self._order_keys_vec(batch, n)
        except _WindowFallback:
            return self._eval_python(batch)
        # one stable lexsort: partition primary, order-by keys within —
        # ties keep arrival order, exactly like the stable comparator sort
        sidx = np.lexsort(tuple(reversed(okeys)) + (pids,))
        ps = pids[sidx]
        pstart = np.empty(n, dtype=bool)
        pstart[:1] = True
        pstart[1:] = ps[1:] != ps[:-1]
        newk = pstart.copy()  # order-key change OR partition change
        for t in oties:
            tt = t[sidx]
            newk[1:] |= tt[1:] != tt[:-1]
        pb = np.nonzero(pstart)[0]
        plens = np.diff(np.append(pb, n))
        base = np.repeat(pb, plens)  # partition start per sorted position
        karr = np.repeat(plens, plens)  # partition size per sorted position
        j = np.arange(n) - base  # 0-based position within partition
        w = self.wname
        if w == "row_number":
            res = j + 1
        elif w == "rank":
            res = (
                np.maximum.accumulate(np.where(newk, np.arange(n), 0))
                - base
                + 1
            )
        elif w == "dense_rank":
            c = np.cumsum(newk)
            res = c - np.repeat(c[pb] - 1, plens)
        elif w == "percent_rank":
            rank = (
                np.maximum.accumulate(np.where(newk, np.arange(n), 0))
                - base
                + 1
            )
            res = np.where(
                karr > 1, (rank - 1) / np.maximum(karr - 1, 1), 0.0
            )
        elif w == "cume_dist":
            tb = np.nonzero(newk)[0]
            tlens = np.diff(np.append(tb, n))
            tie_last = np.repeat(tb + tlens - 1, tlens)
            res = (tie_last - base + 1) / karr
        elif w == "ntile":
            # SQL NTILE: the first (k mod n) buckets hold ceil(k/n) rows,
            # the rest floor(k/n) — consecutive bucket ids even when
            # rows < buckets
            nb = int(self.params[0])
            big = karr // nb + 1
            r_big = karr % nb
            small = np.maximum(karr // nb, 1)  # guarded: branch unused at k<nb
            res = np.where(
                j < r_big * big,
                j // big + 1,
                r_big + (j - r_big * big) // small + 1,
            )
        elif w in ("lead", "lag"):
            offset, default = self.params
            shift = offset if w == "lead" else -offset
            vals = np.atleast_1d(self.args[0].eval(batch))
            vs = vals[sidx]
            src = j + shift
            ok = (src >= 0) & (src < karr)
            res = np.empty(n, dtype=object)
            res[:] = default
            res[ok] = vs[(np.arange(n) + shift)[ok]]
        else:
            raise PlanError(f"unknown window function {w!r}")
        out = np.empty(n, dtype=object)
        out[sidx] = res
        # densify numeric results
        try:
            tight = np.asarray(out.tolist())
            if tight.dtype.kind in "ifb":
                return tight
        except (ValueError, TypeError):
            pass
        return out

    def _eval_python(self, batch: RecordBatch) -> np.ndarray:
        """Comparator-based fallback for order/partition columns numpy
        cannot sort (mixed non-comparable objects) — the pre-vectorization
        implementation, kept verbatim."""
        n = batch.num_rows
        # partition ids
        if self.partition_by:
            pcols = [
                np.atleast_1d(e.eval(batch)).tolist()
                for e in self.partition_by
            ]
            pkeys = [tuple(c[i] for c in pcols) for i in range(n)]
        else:
            pkeys = [()] * n
        order_idx, okeys = (
            self._order_index(batch)
            if self.order_by
            else (np.arange(n, dtype=np.int64), [()] * n)
        )
        # group ordered rows by partition
        parts: dict = {}
        for pos in order_idx.tolist():
            parts.setdefault(pkeys[pos], []).append(pos)
        out = np.empty(n, dtype=object)
        for rows in parts.values():
            self._eval_partition(rows, okeys, batch, out)
        # densify numeric results
        try:
            tight = np.asarray(out.tolist())
            if tight.dtype.kind in "ifb":
                return tight
        except (ValueError, TypeError):
            pass
        return out

    def _eval_partition(self, rows, okeys, batch, out) -> None:
        k = len(rows)
        w = self.wname
        if w == "row_number":
            for j, r in enumerate(rows):
                out[r] = j + 1
            return
        if w in ("rank", "dense_rank", "percent_rank", "cume_dist"):
            rank = 0
            dense = 0
            ranks = np.empty(k, np.int64)
            for j, r in enumerate(rows):
                if j == 0 or okeys[r] != okeys[rows[j - 1]]:
                    rank = j + 1
                    dense += 1
                ranks[j] = dense if w == "dense_rank" else rank
            if w in ("rank", "dense_rank"):
                for j, r in enumerate(rows):
                    out[r] = int(ranks[j])
                return
            if w == "percent_rank":
                for j, r in enumerate(rows):
                    out[r] = 0.0 if k <= 1 else (ranks[j] - 1) / (k - 1)
                return
            # cume_dist: fraction of rows with key <= current
            last_of_key = {}
            for j, r in enumerate(rows):
                last_of_key[okeys[r]] = j
            for j, r in enumerate(rows):
                out[r] = (last_of_key[okeys[r]] + 1) / k
            return
        if w == "ntile":
            # SQL NTILE: the first (k mod n) buckets hold ceil(k/n) rows,
            # the rest floor(k/n) — consecutive bucket ids even when
            # rows < buckets
            n_buckets = int(self.params[0])
            big = k // n_buckets + 1
            r_big = k % n_buckets
            for j, r in enumerate(rows):
                if j < r_big * big:
                    out[r] = j // big + 1
                else:
                    out[r] = r_big + (j - r_big * big) // (k // n_buckets) + 1
            return
        if w in ("lead", "lag"):
            offset, default = self.params
            vals = np.atleast_1d(self.args[0].eval(batch))
            shift = offset if w == "lead" else -offset
            for j, r in enumerate(rows):
                src = j + shift
                out[r] = (
                    _scalarize(vals[rows[src]])
                    if 0 <= src < k
                    else default
                )
            return
        raise PlanError(f"unknown window function {w!r}")

    def __repr__(self):
        return self.name


class _WindowFallback(Exception):
    """Signal: this batch's keys need the comparator-based Python path."""


class _SortKey:
    """Total-order wrapper: mixed / non-comparable values fall back to
    string comparison instead of raising mid-projection."""

    __slots__ = ("v", "isnull")

    def __init__(self, v, isnull):
        self.v = v
        self.isnull = isnull

    def __lt__(self, other):
        if self.isnull or other.isnull:
            return False  # null bucket already separated by the tuple
        try:
            return self.v < other.v
        except TypeError:
            return str(self.v) < str(other.v)

    def __eq__(self, other):
        return self.v == other.v


def _scalarize(v):
    return v.item() if isinstance(v, np.generic) else v


@dataclass(frozen=True, eq=False)
class FieldAccessExpr(Expr):
    inner: Expr
    field_name: str

    @property
    def name(self) -> str:
        return f"{self.inner.name}.{self.field_name}"

    def out_field(self, schema: Schema) -> Field:
        f = self.inner.out_field(schema)
        if f.dtype is not DataType.STRUCT:
            raise SchemaError(f"{f.name!r} is not a struct")
        for c in f.children:
            if c.name == self.field_name:
                return Field(self.name, c.dtype, c.nullable, c.children)
        raise SchemaError(f"struct {f.name!r} has no field {self.field_name!r}")

    def eval(self, batch: RecordBatch) -> np.ndarray:
        from denormalized_tpu_torch.common.columns import (
            NestedColumn,
            PrimitiveColumn,
        )

        structs = self.inner.eval(batch)
        if (
            isinstance(structs, NestedColumn)
            and structs.kind == "struct"
            and structs.validity is None
        ):
            # shredded access: the child column IS the answer — no row
            # materialization.  (A null parent struct must surface None
            # for every child, which only the row path models; the
            # all-present case — the normal one — stays columnar.)
            for f, child in zip(structs.field.children, structs.children):
                if f.name == self.field_name:
                    if isinstance(child, PrimitiveColumn):
                        if child.validity is not None:
                            return child.as_object()
                        # densified exactly like the tight path below
                        return (
                            child.values.view(np.bool_)
                            if child.kind == "bool" else child.values
                        )
                    return child
        structs = as_numpy(structs)  # object array of dicts
        out = np.empty(len(structs), dtype=object)
        for i, s in enumerate(structs):
            out[i] = None if s is None else s.get(self.field_name)
        # densify numerics
        try:
            tight = np.asarray(out.tolist())
            if tight.dtype.kind in "ifb":
                return tight
        except (ValueError, TypeError):
            pass
        return out

    def columns_referenced(self) -> set[str]:
        return self.inner.columns_referenced()

    def __repr__(self):
        return f"{self.inner!r}.field({self.field_name!r})"


@dataclass(frozen=True, eq=False)
class CastExpr(Expr):
    inner: Expr
    dtype: DataType

    @property
    def name(self) -> str:
        return self.inner.name

    def out_field(self, schema: Schema) -> Field:
        f = self.inner.out_field(schema)
        return Field(f.name, self.dtype, f.nullable)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        from denormalized_tpu_torch.common.columns import StringColumn

        v = self.inner.eval(batch)
        if self.dtype is DataType.STRING:
            if isinstance(v, StringColumn) and v.validity is None:
                # already columnar strings with no nulls: identity cast
                # (null slots cast to the string 'None', as in the JAX
                # package, so they take the materializing path below)
                return v
            return np.array([str(x) for x in as_numpy(v)], dtype=object)
        return np.asarray(v).astype(self.dtype.to_numpy())

    def eval_torch(self, cols):
        import torch

        tdt = {
            # device numerics stay 32-bit, as the JAX package's device
            # evaluator keeps them with x64 off
            DataType.INT32: torch.int32,
            DataType.INT64: torch.int32,
            DataType.FLOAT32: torch.float32,
            DataType.FLOAT64: torch.float32,
            DataType.BOOL: torch.bool,
        }.get(self.dtype)
        if tdt is None:
            raise PlanError(f"cannot cast to {self.dtype} on device")
        return _as_tensor(self.inner.eval_torch(cols)).to(tdt)

    def columns_referenced(self) -> set[str]:
        return self.inner.columns_referenced()


@dataclass(frozen=True, eq=False)
class ScalarFunctionExpr(Expr):
    """Built-in scalar function call (registry:
    :mod:`denormalized_tpu_torch.logical.scalar_functions` — the equivalent of the
    datafusion function library the reference re-exports,
    py-denormalized/python/denormalized/datafusion/functions.py)."""

    fname: str
    args: tuple[Expr, ...]

    def _fn(self):
        from denormalized_tpu_torch.logical import scalar_functions as sf

        return sf.lookup(self.fname)

    @property
    def name(self) -> str:
        return f"{self.fname}({', '.join(a.name for a in self.args)})"

    def out_field(self, schema: Schema) -> Field:
        ot = self._fn().out_type
        if ot == "same":
            if not self.args:
                raise PlanError(f"{self.fname} needs arguments")
            f0 = self.args[0].out_field(schema)
            return Field(self.name, f0.dtype)
        if callable(ot) and not isinstance(ot, DataType):
            # computed output type: LIST/STRUCT functions derive element /
            # child fields from their argument fields
            f = ot(tuple(a.out_field(schema) for a in self.args))
            return Field(self.name, f.dtype, f.nullable, f.children)
        return Field(self.name, ot)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        fn = self._fn()
        # domain errors (sqrt(-x), log(0)) follow SQL NaN/NULL semantics —
        # no warnings
        with np.errstate(invalid="ignore", divide="ignore"):
            if fn.rowwise_nullary:
                # per-row zero-arg functions (random, uuid) need the row
                # count — a broadcast scalar would repeat one draw
                out = fn.np_fn(batch.num_rows)
            else:
                out = fn.np_fn(
                    *[as_numpy(a.eval(batch)) for a in self.args]
                )
        if not isinstance(out, np.ndarray):
            out = np.asarray(out)
        if out.ndim == 0:  # zero-arg / scalar result → broadcast
            out = np.full(batch.num_rows, out.item())
        return out

    def eval_torch(self, cols: dict[str, Any]):
        fn = self._fn()
        if fn.torch_fn is None:
            raise PlanError(f"{self.fname} is host-only (no device lowering)")
        return fn.torch_fn(*[a.eval_torch(cols) for a in self.args])

    def columns_referenced(self) -> set[str]:
        s: set[str] = set()
        for a in self.args:
            s |= a.columns_referenced()
        return s

    def __repr__(self):
        return f"{self.fname}({', '.join(map(repr, self.args))})"


@dataclass(frozen=True, eq=False)
class CaseExpr(Expr):
    """SQL CASE.  ``base`` None → searched form (WHEN <bool-cond> THEN r);
    otherwise the simple form (WHEN base == value THEN r)."""

    base: Expr | None
    branches: tuple[tuple[Expr, Expr], ...]
    otherwise: Expr | None

    @property
    def name(self) -> str:
        return "case(" + ", ".join(
            f"{c.name}->{r.name}" for c, r in self.branches
        ) + ")"

    def out_field(self, schema: Schema) -> Field:
        dt = self.branches[0][1].out_field(schema).dtype
        for _, r in self.branches[1:]:
            dt = _promote(dt, r.out_field(schema).dtype, "case")
        if self.otherwise is not None:
            dt = _promote(dt, self.otherwise.out_field(schema).dtype, "case")
        return Field(self.name, dt)

    def _conds(self, batch):
        for c, _ in self.branches:
            if self.base is not None:
                yield BinaryExpr("==", self.base, c).eval(batch)
            else:
                yield np.asarray(c.eval(batch), dtype=bool)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        conds = list(self._conds(batch))
        results = [np.asarray(r.eval(batch)) for _, r in self.branches]
        is_obj = any(r.dtype == object for r in results)
        if self.otherwise is not None:
            default = np.asarray(self.otherwise.eval(batch))
            is_obj = is_obj or default.dtype == object
        else:
            default = None
        n = batch.num_rows
        if is_obj:
            out = np.empty(n, dtype=object)
            out[:] = None
            taken = np.zeros(n, dtype=bool)
            for cond, res in zip(conds, results):
                pick = cond & ~taken
                out[pick] = res[pick] if res.ndim else res.item()
                taken |= cond
            if default is not None:
                rest = ~taken
                out[rest] = (
                    default[rest] if default.ndim else default.item()
                )
            return out
        if default is None:
            default = np.full(n, np.nan)
        return np.select(conds, results, default)

    def eval_torch(self, cols: dict[str, Any]):
        import torch

        if self.otherwise is not None:
            out = self.otherwise.eval_torch(cols)
        else:
            out = float("nan")
        for c, r in reversed(self.branches):
            if self.base is not None:
                cond = BinaryExpr("==", self.base, c).eval_torch(cols)
            else:
                cond = c.eval_torch(cols)
            out = torch.where(_as_tensor(cond), r.eval_torch(cols), out)
        return out

    def columns_referenced(self) -> set[str]:
        s: set[str] = set()
        if self.base is not None:
            s |= self.base.columns_referenced()
        for c, r in self.branches:
            s |= c.columns_referenced() | r.columns_referenced()
        if self.otherwise is not None:
            s |= self.otherwise.columns_referenced()
        return s

    def __repr__(self):
        return self.name


class CaseBuilder:
    """Fluent CASE builder (datafusion-python `case(...)`/`when(...)`)."""

    def __init__(self, base: Expr | None = None):
        self._base = base
        self._branches: list[tuple[Expr, Expr]] = []

    def when(self, cond, result) -> "CaseBuilder":
        self._branches.append((_wrap(cond), _wrap(result)))
        return self

    def otherwise(self, value) -> CaseExpr:
        if not self._branches:
            raise PlanError("CASE needs at least one WHEN branch")
        return CaseExpr(self._base, tuple(self._branches), _wrap(value))

    def end(self) -> CaseExpr:
        if not self._branches:
            raise PlanError("CASE needs at least one WHEN branch")
        return CaseExpr(self._base, tuple(self._branches), None)


@dataclass(frozen=True, eq=False)
class ScalarUDFExpr(Expr):
    """User-defined scalar function over numpy columns (reference:
    udf_example.rs + py udf.py)."""

    fn: Callable
    args: tuple[Expr, ...]
    _name: str
    dtype: DataType

    @property
    def name(self) -> str:
        return self._name

    def out_field(self, schema: Schema) -> Field:
        return Field(self._name, self.dtype)

    def eval(self, batch: RecordBatch) -> np.ndarray:
        # the UDF boundary: user code sees plain numpy columns
        return np.asarray(
            self.fn(*[as_numpy(a.eval(batch)) for a in self.args])
        )

    def eval_torch(self, cols):
        return self.fn(*[a.eval_torch(cols) for a in self.args])

    def columns_referenced(self) -> set[str]:
        s: set[str] = set()
        for a in self.args:
            s |= a.columns_referenced()
        return s

    def __repr__(self):
        return f"{self._name}({', '.join(map(repr, self.args))})"


# -- aggregates ---------------------------------------------------------

AGG_KINDS = (
    "count", "sum", "min", "max", "avg",
    # variance family: decomposes into sum/count/sum-of-squares components
    # over pivot-shifted value columns in the device ring
    "stddev", "stddev_pop", "var", "var_pop",
)
VAR_KINDS = ("stddev", "stddev_pop", "var", "var_pop")


def unported_aggregate(kind: str) -> PlanError:
    """The refusal for an aggregate the port cannot run yet, naming the
    ROADMAP item that brings it: every UDAF-backed or sketch-backed
    aggregate comes with the UDAF executor (§A item 6)."""
    return PlanError(
        f"aggregate {kind!r} not yet ported to denormalized_tpu_torch: it "
        f"comes with ROADMAP §A item 6, the UDAF executor (ported: "
        f"{', '.join(AGG_KINDS)})"
    )


@dataclass(frozen=True, eq=False)
class AggregateExpr(Expr):
    """An aggregate call inside window(): count/sum/min/max/avg or the
    variance family."""

    kind: str  # one of AGG_KINDS
    arg: Expr | None  # None for count(*)
    _alias: str | None = None

    def __post_init__(self):
        if self.kind not in AGG_KINDS:
            raise unported_aggregate(self.kind)

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
        if self.kind == "avg" or self.kind in VAR_KINDS:
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


def substitute_columns(e: Expr, mapping: dict[str, Expr]) -> Expr:
    """Rewrite ``e`` with every Column reference replaced by its mapped
    expression (used by the optimizer to merge stacked projections and push
    filters beneath them).  Nodes are immutable, so untouched subtrees are
    reused as-is."""
    if isinstance(e, Column):
        return mapping.get(e.name, e)
    if isinstance(e, Literal):
        return e
    if isinstance(e, BinaryExpr):
        return BinaryExpr(
            e.op,
            substitute_columns(e.left, mapping),
            substitute_columns(e.right, mapping),
        )
    if isinstance(e, NotExpr):
        return NotExpr(substitute_columns(e.inner, mapping))
    if isinstance(e, IsNullExpr):
        return IsNullExpr(substitute_columns(e.inner, mapping), e.negate)
    if isinstance(e, AliasExpr):
        return AliasExpr(substitute_columns(e.inner, mapping), e._name)
    if isinstance(e, FieldAccessExpr):
        return FieldAccessExpr(
            substitute_columns(e.inner, mapping), e.field_name
        )
    if isinstance(e, CastExpr):
        return CastExpr(substitute_columns(e.inner, mapping), e.dtype)
    if isinstance(e, ScalarFunctionExpr):
        return ScalarFunctionExpr(
            e.fname,
            tuple(substitute_columns(a, mapping) for a in e.args),
        )
    if isinstance(e, ScalarUDFExpr):
        return ScalarUDFExpr(
            e.fn,
            tuple(substitute_columns(a, mapping) for a in e.args),
            e._name,
            e.dtype,
        )
    if isinstance(e, CaseExpr):
        return CaseExpr(
            substitute_columns(e.base, mapping) if e.base is not None else None,
            tuple(
                (
                    substitute_columns(c, mapping),
                    substitute_columns(r, mapping),
                )
                for c, r in e.branches
            ),
            substitute_columns(e.otherwise, mapping)
            if e.otherwise is not None
            else None,
        )
    raise PlanError(f"cannot substitute through {type(e).__name__}")


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
