"""LIST / STRUCT scalar function family.

Counterpart of ``denormalized_tpu/logical/array_functions.py``.  The
reference re-exports datafusion's array manipulation library to Python
users (py-denormalized/python/denormalized/datafusion/functions.py:1029-1502
— ``make_array``, ``array_append`` … ``flatten``, each with a ``list_*``
alias).  This module is the host-side equivalent over first-class LIST
columns: a LIST column is an object ndarray whose slots are python lists
(or None for SQL NULL), and the element type — when known — rides in the
schema as ``Field(children=(element_field,))``.

Everything here is host-only by design: ragged per-row lists have no
static shape, so they stay off the device the same way strings do (they
are projection/emission payload, not aggregation state).  Semantics follow
DataFusion: 1-based indexing, NULL propagation on NULL list arguments,
``array_position`` returning NULL when absent.
"""

from __future__ import annotations

import numpy as np

from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.schema import DataType, Field
from denormalized_tpu_torch.logical.expr import _scalarize

_I64 = DataType.INT64
_STR = DataType.STRING
_BOOL = DataType.BOOL


# -- value plumbing ------------------------------------------------------


def _as_list(x):
    """Normalize one cell to a python list (None stays None)."""
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _cells(*arrays):
    """Iterate rows across argument arrays with length-1 broadcast (the
    convention literals arrive in)."""
    cols = [np.atleast_1d(np.asarray(a, dtype=object)) for a in arrays]
    n = max(len(c) for c in cols)
    for i in range(n):
        yield [_scalarize(c[i] if len(c) > 1 else c[0]) for c in cols]


def _rowwise(fn, n_out_type=object):
    """Build an np_fn applying ``fn`` per row; None list arg → None out
    is each fn's own responsibility (most want NULL propagation)."""

    def run(*arrays):
        rows = list(_cells(*arrays))
        out = np.empty(len(rows), dtype=n_out_type)
        for i, vals in enumerate(rows):
            out[i] = fn(*vals)
        return out

    return run


# -- output-type helpers (computed Field from argument fields) -----------


def _elem_field(list_field: Field) -> Field:
    if list_field.children:
        return list_field.children[0]
    return Field("item", _STR)


def _ot_list_of(element_dtype_from: int):
    """LIST whose element type is argument ``element_dtype_from``'s type."""

    def ot(arg_fields):
        if not arg_fields:
            return Field("", DataType.LIST, children=(Field("item", _STR),))
        f = arg_fields[min(element_dtype_from, len(arg_fields) - 1)]
        return Field("", DataType.LIST, children=(Field("item", f.dtype),))

    return ot


def _ot_list_i64(_arg_fields):
    """LIST<INT64> regardless of input (positions, dims)."""
    return Field("", DataType.LIST, children=(Field("item", _I64),))


def _ot_list_passthrough(idx: int = 0):
    """LIST with the same element type as the LIST argument at ``idx``."""

    def ot(arg_fields):
        if len(arg_fields) > idx and arg_fields[idx].dtype is DataType.LIST:
            return arg_fields[idx]
        return Field("", DataType.LIST, children=(Field("item", _STR),))

    return ot


def _ot_element(idx: int = 0):
    """The element type of the LIST argument at ``idx``."""

    def ot(arg_fields):
        if len(arg_fields) > idx and arg_fields[idx].dtype is DataType.LIST:
            return _elem_field(arg_fields[idx])
        return Field("", _STR)

    return ot


def _ot_struct(arg_fields):
    """STRUCT for ``struct(*cols)``: children c0..cN of the arg types."""
    return Field(
        "",
        DataType.STRUCT,
        children=tuple(
            Field(f"c{i}", f.dtype) for i, f in enumerate(arg_fields)
        ),
    )


def _ot_named_struct(arg_fields):
    """STRUCT for ``named_struct(name0, v0, ...)``: names come from the
    literal name arguments, types from the value arguments."""
    kids = []
    for i in range(0, len(arg_fields) - 1, 2):
        # the name is a literal; its *value* is not visible here, so the
        # child is named positionally and refined at eval time — schema
        # consumers see the value TYPES, which is what matters for layout
        kids.append(Field(f"f{i // 2}", arg_fields[i + 1].dtype))
    return Field("", DataType.STRUCT, children=tuple(kids))


# -- constructors --------------------------------------------------------


def _make_array(*arrays):
    rows = list(_cells(*arrays))
    out = np.empty(len(rows), dtype=object)
    for i, vals in enumerate(rows):
        out[i] = list(vals)
    return out


def _range(*arrays):
    def one(start, stop=None, step=1):
        if stop is None:
            start, stop = 0, start
        if start is None or stop is None or step in (None, 0):
            return None
        return list(range(int(start), int(stop), int(step)))

    return _rowwise(one)(*arrays)


def _struct(*arrays):
    rows = list(_cells(*arrays))
    out = np.empty(len(rows), dtype=object)
    for i, vals in enumerate(rows):
        out[i] = {f"c{j}": v for j, v in enumerate(vals)}
    return out


def _named_struct(*arrays):
    rows = list(_cells(*arrays))
    out = np.empty(len(rows), dtype=object)
    for i, vals in enumerate(rows):
        if len(vals) % 2:
            raise PlanError(
                "named_struct takes name/value pairs (odd argument count)"
            )
        out[i] = {
            str(vals[j]): vals[j + 1] for j in range(0, len(vals), 2)
        }
    return out


# -- per-row list ops ----------------------------------------------------


def _null_prop(fn):
    """First argument is the list; None → None."""

    def run(arr, *rest):
        a = _as_list(arr)
        return None if a is None else fn(a, *rest)

    return run


def _eq(a, b):
    # NaN-insensitive equality would surprise; match python/DF semantics
    return a == b


def _array_position(a, el, start=1):
    start = 1 if start is None else int(start)
    for i in range(max(start - 1, 0), len(a)):
        if _eq(a[i], el):
            return i + 1
    return None


def _array_slice(a, begin, end, stride=None):
    # DataFusion: 1-based inclusive begin..end; negative indexes from the
    # end; stride defaults to 1
    n = len(a)
    if begin is None or end is None:
        return None
    begin = int(begin)
    end = int(end)
    if begin < 0:
        begin = n + begin + 1
    if end < 0:
        end = n + end + 1
    begin = max(begin, 1)
    end = min(end, n)
    step = 1 if stride is None else int(stride)
    if step == 0:
        return None
    if step > 0:
        return a[begin - 1 : end : step]
    return a[begin - 1 : None if end <= 1 else end - 2 : step]


def _array_sort(a, descending=False, nulls_first=False):
    desc = _truthy(descending)
    nf = _truthy(nulls_first)
    nulls = [v for v in a if v is None]
    rest = sorted((v for v in a if v is not None), reverse=desc)
    return nulls + rest if nf else rest + nulls


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v.lower() in ("true", "t", "1", "yes", "desc")
    return bool(v)


def _array_to_string(arr, delim, null_str=None):
    a = _as_list(arr)
    if a is None or delim is None:
        return None
    parts = []
    for v in a:
        if isinstance(v, (list, tuple)):  # nested lists flatten (DF)
            inner = _array_to_string(v, delim, null_str)
            if inner:
                parts.append(inner)
        elif v is None:
            if null_str is not None:
                parts.append(str(null_str))
        else:
            parts.append(_fmt_el(v))
    return str(delim).join(parts)


def _fmt_el(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _dedup(a):
    seen = []
    for v in a:
        if not any(_eq(v, s) for s in seen):
            seen.append(v)
    return seen


def _resize(a, size, fill=None):
    if size is None:
        return None
    size = int(size)
    return a[:size] + [fill] * max(0, size - len(a))


def _remove_n(a, el, n):
    out = []
    left = int(n)
    for v in a:
        if left > 0 and _eq(v, el):
            left -= 1
            continue
        out.append(v)
    return out


def _replace_n(a, f, t, n):
    out = []
    left = int(n)
    for v in a:
        if left > 0 and _eq(v, f):
            out.append(t)
            left -= 1
        else:
            out.append(v)
    return out


def _flatten(a):
    out = []
    for v in a:
        if isinstance(v, (list, tuple, np.ndarray)):
            out.extend(_as_list(v))
        else:
            out.append(v)
    return out


def _array_concat(*arrays):
    def one(*lists):
        out = []
        for x in lists:
            a = _as_list(x)
            if a is None:
                return None
            out.extend(a)
        return out

    return _rowwise(one)(*arrays)


def _ndims(v):
    d = 0
    while isinstance(v, (list, tuple, np.ndarray)):
        d += 1
        v = v[0] if len(v) else None
    return d


def _regexp_match(*arrays):
    """Postgres/DataFusion regexp_match: capture groups of the FIRST
    match as a LIST of strings (the whole match when the pattern has no
    groups); NULL when no match."""
    from denormalized_tpu_torch.logical.scalar_functions import _regex

    def one(s, pattern, flags=""):
        if s is None or pattern is None:
            return None
        m = _regex(pattern, flags or "").search(s)
        if m is None:
            return None
        return list(m.groups()) if m.groups() else [m.group(0)]

    return _rowwise(one)(*arrays)


def _build() -> dict:
    from denormalized_tpu_torch.logical.scalar_functions import ScalarFn

    def F(np_fn, out_type, min_args=1, max_args=None):
        return ScalarFn(np_fn, out_type, None, min_args, max_args)

    fns: dict[str, ScalarFn] = {
        "make_array": F(_make_array, _ot_list_of(0), 0, 64),
        "array": F(_make_array, _ot_list_of(0), 0, 64),
        "range": F(_range, _ot_list_of(0), 1, 3),
        "struct": F(_struct, _ot_struct, 1, 64),
        "named_struct": F(_named_struct, _ot_named_struct, 2, 64),
        "regexp_match": F(
            _regexp_match,
            lambda _f: Field("", DataType.LIST,
                             children=(Field("item", _STR),)),
            2, 3,
        ),
        "flatten": F(
            _rowwise(_null_prop(_flatten)), _ot_list_passthrough(), 1
        ),
        "array_concat": F(_array_concat, _ot_list_passthrough(), 1, 64),
        "array_append": F(
            _rowwise(_null_prop(lambda a, el: a + [el])),
            _ot_list_passthrough(), 2,
        ),
        "array_prepend": F(
            _rowwise(lambda el, arr: (
                None if _as_list(arr) is None else [el] + _as_list(arr)
            )),
            _ot_list_passthrough(1), 2,
        ),
        "array_pop_back": F(
            _rowwise(_null_prop(lambda a: a[:-1])), _ot_list_passthrough(), 1
        ),
        "array_pop_front": F(
            _rowwise(_null_prop(lambda a: a[1:])), _ot_list_passthrough(), 1
        ),
        "array_dims": F(
            _rowwise(_null_prop(
                lambda a: _dims_of(a)
            )),
            _ot_list_i64, 1,
        ),
        "array_ndims": F(
            _rowwise(lambda arr: (
                None if _as_list(arr) is None else _ndims(_as_list(arr))
            )),
            _I64, 1,
        ),
        "array_distinct": F(
            _rowwise(_null_prop(_dedup)), _ot_list_passthrough(), 1
        ),
        "array_element": F(
            _rowwise(lambda arr, n: _element(arr, n)), _ot_element(), 2
        ),
        "array_length": F(
            _rowwise(lambda arr: (
                None if _as_list(arr) is None else len(_as_list(arr))
            )),
            _I64, 1, 2,
        ),
        "array_has": F(
            _rowwise(lambda arr, el: (
                None if _as_list(arr) is None
                else any(_eq(v, el) for v in _as_list(arr))
            )),
            _BOOL, 2,
        ),
        "array_has_all": F(
            _rowwise(lambda arr, sub: _has_all(arr, sub)), _BOOL, 2
        ),
        "array_has_any": F(
            _rowwise(lambda arr, other: _has_any(arr, other)), _BOOL, 2
        ),
        "array_position": F(
            _rowwise(_null_prop(_array_position)), _I64, 2, 3
        ),
        "array_positions": F(
            _rowwise(_null_prop(lambda a, el: [
                i + 1 for i, v in enumerate(a) if _eq(v, el)
            ])),
            _ot_list_i64, 2,
        ),
        "array_remove": F(
            _rowwise(_null_prop(lambda a, el: _remove_n(a, el, 1))),
            _ot_list_passthrough(), 2,
        ),
        "array_remove_n": F(
            _rowwise(_null_prop(_remove_n)), _ot_list_passthrough(), 3
        ),
        "array_remove_all": F(
            _rowwise(_null_prop(
                lambda a, el: [v for v in a if not _eq(v, el)]
            )),
            _ot_list_passthrough(), 2,
        ),
        "array_repeat": F(
            _rowwise(lambda el, n: (
                None if n is None else [el] * max(int(n), 0)
            )),
            _ot_list_of(0), 2,
        ),
        "array_replace": F(
            _rowwise(_null_prop(lambda a, f, t: _replace_n(a, f, t, 1))),
            _ot_list_passthrough(), 3,
        ),
        "array_replace_n": F(
            _rowwise(_null_prop(_replace_n)), _ot_list_passthrough(), 4
        ),
        "array_replace_all": F(
            _rowwise(_null_prop(
                lambda a, f, t: [t if _eq(v, f) else v for v in a]
            )),
            _ot_list_passthrough(), 3,
        ),
        "array_resize": F(
            _rowwise(_null_prop(_resize)), _ot_list_passthrough(), 2, 3
        ),
        "array_slice": F(
            _rowwise(_null_prop(_array_slice)), _ot_list_passthrough(), 3, 4
        ),
        "array_sort": F(
            _rowwise(_null_prop(_array_sort)), _ot_list_passthrough(), 1, 3
        ),
        "array_to_string": F(_rowwise(_array_to_string), _STR, 2, 3),
        "array_intersect": F(
            _rowwise(lambda a, b: _set_op(a, b, "intersect")),
            _ot_list_passthrough(), 2,
        ),
        "array_union": F(
            _rowwise(lambda a, b: _set_op(a, b, "union")),
            _ot_list_passthrough(), 2,
        ),
        "array_except": F(
            _rowwise(lambda a, b: _set_op(a, b, "except")),
            _ot_list_passthrough(), 2,
        ),
    }
    # the list_* namespace is a straight aliasing of array_* (reference
    # functions.py list_append:1096 etc.)
    aliases = {
        "list_append": "array_append",
        "list_push_back": "array_append",
        "array_push_back": "array_append",
        "list_prepend": "array_prepend",
        "list_push_front": "array_prepend",
        "array_push_front": "array_prepend",
        "array_cat": "array_concat",
        "list_cat": "array_concat",
        "list_concat": "array_concat",
        "list_dims": "array_dims",
        "list_distinct": "array_distinct",
        "list_element": "array_element",
        "array_extract": "array_element",
        "list_extract": "array_element",
        "list_indexof": "array_position",
        "array_indexof": "array_position",
        "list_position": "array_position",
        "list_positions": "array_positions",
        "list_join": "array_to_string",
        "array_join": "array_to_string",
        "list_to_string": "array_to_string",
        "list_length": "array_length",
        "list_ndims": "array_ndims",
        "list_pop_back": "array_pop_back",
        "list_pop_front": "array_pop_front",
        "list_remove": "array_remove",
        "list_remove_n": "array_remove_n",
        "list_remove_all": "array_remove_all",
        "list_replace": "array_replace",
        "list_replace_n": "array_replace_n",
        "list_replace_all": "array_replace_all",
        "list_resize": "array_resize",
        "list_slice": "array_slice",
        "list_sort": "array_sort",
        "list_intersect": "array_intersect",
        "list_union": "array_union",
        "list_except": "array_except",
        "list_has": "array_has",
        "list_has_all": "array_has_all",
        "list_has_any": "array_has_any",
    }
    for alias, target in aliases.items():
        fns[alias] = fns[target]
    return fns


def _dims_of(a):
    dims = []
    v = a
    while isinstance(v, (list, tuple, np.ndarray)):
        dims.append(len(v))
        v = v[0] if len(v) else None
    return dims


def _element(arr, n):
    a = _as_list(arr)
    if a is None or n is None:
        return None
    i = int(n)
    if i < 0:
        i = len(a) + i + 1
    if not 1 <= i <= len(a):
        return None
    return a[i - 1]


def _has_all(arr, sub):
    a, s = _as_list(arr), _as_list(sub)
    if a is None or s is None:
        return None
    return all(any(_eq(v, x) for v in a) for x in s)


def _has_any(arr, other):
    a, o = _as_list(arr), _as_list(other)
    if a is None or o is None:
        return None
    return any(any(_eq(v, x) for v in a) for x in o)


def _set_op(a, b, op):
    la, lb = _as_list(a), _as_list(b)
    if la is None or lb is None:
        return None
    if op == "intersect":
        return _dedup([v for v in la if any(_eq(v, x) for x in lb)])
    if op == "union":
        return _dedup(la + lb)
    return _dedup([v for v in la if not any(_eq(v, x) for x in lb)])


ARRAY_FNS = _build()
