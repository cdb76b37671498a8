"""Arrow-style column representations: strings and nested values stay
columnar from parser buffer to operator, exchange frame, and spill block.

The reference keeps data in Arrow ``RecordBatch``es end to end; until this
module the reproduction was columnar only for flat numeric columns —
strings lived as numpy object arrays of Python ``str`` and nested
STRUCT/LIST values were shredded by the native parsers and then
reassembled into Python dict rows just so operators could carry them.
These classes carry the shredded form directly inside
``RecordBatch.columns`` (alongside plain ndarrays):

- :class:`StringColumn` — Arrow string layout: ``int64`` offsets (n+1)
  into one contiguous UTF-8 byte buffer, plus an optional validity mask.
- :class:`NestedColumn` — a shredded STRUCT/LIST tree: typed child
  columns (``PrimitiveColumn`` leaves at the parser's natural width,
  ``StringColumn`` string leaves, nested ``NestedColumn``s) plus
  Arrow-style list offsets.

Python rows materialize ONLY at user-facing boundaries (sinks, UDFs,
``to_pydict``, pyarrow interop) via the cached :meth:`Column.as_object`
— which every legacy numpy call site reaches automatically through
``__array__``/``tolist``, so operators migrate incrementally.  The
materialization itself reuses the C row assembler
(``native/pyassemble.cpp``) when it builds, and the generated
dict-literal comprehension fallback otherwise — the same machinery the
decode hot path used to run once per INGESTED row now runs once per
EMITTED row.

Ownership/lifetime: a column OWNS its buffers.  Parser-backed columns
are built from one bulk copy of the parser's arena (the parser's buffers
are invalidated by the next ``parse``/``clear``), so a column never
aliases memory it does not control.

Copy of ``denormalized_tpu/common/columns.py``, always columnar (the JAX
package's default; its ``DENORMALIZED_COLUMNAR_STRINGS`` switch is not
carried over).
"""

from __future__ import annotations

import ctypes

import numpy as np

from denormalized_tpu_torch.common.errors import SchemaError
from denormalized_tpu_torch.common.schema import DataType, Field


def as_numpy(col) -> np.ndarray:
    """ndarray view of a batch column: plain ndarrays pass through,
    Column instances materialize (cached).  The ONE conversion helper
    every legacy consumer funnels through."""
    if isinstance(col, Column):
        return col.as_object()
    return col


def as_key_column(v):
    """Interner-ready key column: Column instances pass through (the
    offsets+bytes intern lane), everything else normalizes through
    ``np.asarray`` (numeric keys keep their exact-value path)."""
    return v if isinstance(v, Column) else np.asarray(v)


class Column:
    """Base for non-ndarray batch columns.

    Implements enough of the ndarray surface (``shape``, ``dtype``,
    ``__len__``, ``__getitem__``, ``__iter__``, ``tolist``,
    ``__array__``) that legacy operators keep working — numpy call sites
    silently fall back to the cached object-array materialization, while
    migrated consumers (interner, exchange codec, spill codec) test
    ``isinstance(col, Column)`` first and stay on the buffers."""

    __slots__ = ()

    # -- ndarray-compatible surface --------------------------------------
    @property
    def shape(self) -> tuple:
        return (len(self),)

    @property
    def dtype(self) -> np.dtype:
        # object dtype: legacy `col.dtype == object` dispatch routes
        # Column instances down the (correct, slower) object lanes
        return np.dtype(object)

    def __array__(self, dtype=None, copy=None):
        arr = self.as_object()
        if dtype is not None and np.dtype(dtype) != np.dtype(object):
            return arr.astype(dtype)
        return arr

    def __iter__(self):
        return iter(self.as_object())

    def tolist(self) -> list:
        return self.as_object().tolist()

    def __len__(self) -> int:
        raise NotImplementedError

    def as_object(self) -> np.ndarray:
        """Materialize Python values (cached): the ONLY place rows may be
        built from the shredded buffers."""
        raise NotImplementedError

    @property
    def nbytes(self) -> int:
        """Exact buffer bytes (accounting; no materialization)."""
        raise NotImplementedError

    def take(self, indices: np.ndarray) -> "Column":
        raise NotImplementedError

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            i = int(key)
            n = len(self)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(f"index {key} out of range for {n} rows")
            return self._get_one(i)
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step == 1:
                return self.slice(start, stop - start)
            return self.take(np.arange(start, stop, step))
        key = np.asarray(key)
        if key.dtype == bool:
            return self.take(np.flatnonzero(key))
        return self.take(key)

    def slice(self, start: int, length: int) -> "Column":
        return self.take(np.arange(start, start + length))

    def _get_one(self, i: int):
        raise NotImplementedError


class StringColumn(Column):
    """Arrow-layout string column: ``offsets`` (int64, n+1) into ``data``
    (uint8, contiguous UTF-8), optional ``validity`` (bool, n; None =
    all valid).  Invalid slots materialize as ``None`` — the same
    convention as the object-array path."""

    __slots__ = ("offsets", "data", "validity", "_obj")

    def __init__(
        self,
        offsets: np.ndarray,
        data: np.ndarray,
        validity: np.ndarray | None = None,
    ) -> None:
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.data = np.asarray(data, dtype=np.uint8)
        self.validity = validity
        self._obj: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.offsets) - 1

    @property
    def nbytes(self) -> int:
        n = self.offsets.nbytes + self.data.nbytes
        if self.validity is not None:
            n += self.validity.nbytes
        return n

    def _get_one(self, i: int):
        if self.validity is not None and not self.validity[i]:
            return None
        o = self.offsets
        return bytes(self.data[o[i]: o[i + 1]]).decode(errors="replace")

    def as_object(self) -> np.ndarray:
        if self._obj is not None:
            return self._obj
        n = len(self)
        out = np.empty(n, dtype=object)
        raw = self.data.tobytes()
        offs = self.offsets.tolist()
        for i in range(n):
            out[i] = raw[offs[i]: offs[i + 1]].decode(errors="replace")
        if self.validity is not None and not self.validity.all():
            out[~self.validity] = None
        self._obj = out
        return out

    def take(self, indices: np.ndarray) -> "StringColumn":
        idx = np.asarray(indices, dtype=np.int64)
        o = self.offsets
        lens = o[1:] - o[:-1]
        nl = lens[idx]
        noffs = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(nl, out=noffs[1:])
        total = int(noffs[-1])
        if total:
            starts = o[:-1][idx]
            # gather positions: each row's byte range, flattened
            pos = (
                np.repeat(starts - noffs[:-1], nl)
                + np.arange(total, dtype=np.int64)
            )
            data = self.data[pos]
        else:
            data = np.empty(0, dtype=np.uint8)
        v = self.validity[idx] if self.validity is not None else None
        return StringColumn(noffs, data, v)

    def slice(self, start: int, length: int) -> "StringColumn":
        stop = start + length
        o = self.offsets[start: stop + 1]
        data = self.data[int(o[0]): int(o[-1])]
        v = self.validity[start:stop] if self.validity is not None else None
        return StringColumn(o - o[0], data, v)

    @staticmethod
    def concat(cols: list["StringColumn"]) -> "StringColumn":
        datas = [c.data for c in cols]
        data = (
            np.concatenate(datas) if datas else np.empty(0, dtype=np.uint8)
        )
        n_total = sum(len(c) for c in cols)
        offs = np.empty(n_total + 1, dtype=np.int64)
        offs[0] = 0
        pos, base = 1, 0
        for c in cols:  # per-COLUMN sweep (chunk count), vectorized inside
            k = len(c)
            offs[pos: pos + k] = c.offsets[1:] + base
            base += int(c.offsets[-1])
            pos += k
        if any(c.validity is not None for c in cols):
            validity = np.concatenate(
                [
                    c.validity
                    if c.validity is not None
                    else np.ones(len(c), dtype=bool)
                    for c in cols
                ]
            )
        else:
            validity = None
        return StringColumn(offs, data, validity)

    @staticmethod
    def from_objects(arr) -> "StringColumn | None":
        """Build from an object array of str/None, or return None when a
        value is neither (bytes, dicts, mixed) — the caller keeps the
        legacy lane for those."""
        vals = arr.tolist() if isinstance(arr, np.ndarray) else list(arr)
        parts: list[bytes] = []
        validity = np.ones(len(vals), dtype=bool)
        any_null = False
        for i, v in enumerate(vals):
            if v is None:
                validity[i] = False
                any_null = True
                parts.append(b"")
            elif isinstance(v, str):
                parts.append(v.encode())
            else:
                return None
        offs = np.zeros(len(vals) + 1, dtype=np.int64)
        np.cumsum([len(p) for p in parts], out=offs[1:])
        data = np.frombuffer(b"".join(parts), dtype=np.uint8)
        return StringColumn(offs, data, validity if any_null else None)

    def __repr__(self) -> str:
        return f"StringColumn({len(self)} rows, {self.data.nbytes}B)"


#: assembly type codes, matching pyassemble.cpp's node types
_PRIM_CODE = {"i64": 0, "f64": 1, "bool": 2}
_PRIM_DTYPE = {"i64": np.int64, "f64": np.float64, "bool": np.uint8}


class PrimitiveColumn(Column):
    """Typed leaf inside a :class:`NestedColumn`: values at the parser's
    natural width (int64 / float64 / uint8-bool — declared-INT32 leaves
    are already saturated at i32 bounds when the column is built), plus
    per-entry validity.  Only ever a child of a nested column; top-level
    numeric columns stay plain ndarrays."""

    __slots__ = ("kind", "values", "validity", "_obj")

    def __init__(self, kind: str, values: np.ndarray,
                 validity: np.ndarray | None = None) -> None:
        self.kind = kind  # 'i64' | 'f64' | 'bool'
        self.values = np.asarray(values, dtype=_PRIM_DTYPE[kind])
        self.validity = validity
        self._obj: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.values)

    @property
    def nbytes(self) -> int:
        n = self.values.nbytes
        if self.validity is not None:
            n += self.validity.nbytes
        return n

    def _pylist(self) -> list:
        vals = (
            self.values.view(np.bool_).tolist()
            if self.kind == "bool"
            else self.values.tolist()
        )
        if self.validity is not None and not self.validity.all():
            for i in np.flatnonzero(~self.validity):
                vals[i] = None
        return vals

    def _get_one(self, i: int):
        if self.validity is not None and not self.validity[i]:
            return None
        v = self.values[i]
        return bool(v) if self.kind == "bool" else v.item()

    def as_object(self) -> np.ndarray:
        if self._obj is None:
            out = np.empty(len(self), dtype=object)
            out[:] = self._pylist()
            self._obj = out
        return self._obj

    def take(self, indices: np.ndarray) -> "PrimitiveColumn":
        idx = np.asarray(indices, dtype=np.int64)
        return PrimitiveColumn(
            self.kind,
            self.values[idx],
            self.validity[idx] if self.validity is not None else None,
        )

    @staticmethod
    def concat(cols: list["PrimitiveColumn"]) -> "PrimitiveColumn":
        kind = cols[0].kind
        values = np.concatenate([c.values for c in cols])
        if any(c.validity is not None for c in cols):
            validity = np.concatenate(
                [
                    c.validity
                    if c.validity is not None
                    else np.ones(len(c), dtype=bool)
                    for c in cols
                ]
            )
        else:
            validity = None
        return PrimitiveColumn(kind, values, validity)


class NestedColumn(Column):
    """Shredded STRUCT/LIST column.

    ``kind='struct'``: ``children`` holds one column per declared child
    field (order = ``field.children`` order); ``validity`` is struct
    presence.  ``kind='list'``: ``children`` holds the single ELEMENT
    column (len = total elements), ``offsets`` (int64, n+1) gives each
    row's element range, ``validity`` is list presence.  Rows
    materialize as the same dicts / lists / None the pyassemble decode
    path produced — :meth:`as_object` IS that path, run lazily."""

    __slots__ = ("field", "kind", "length", "validity", "children",
                 "offsets", "_obj", "_builders")

    def __init__(
        self,
        field: Field,
        kind: str,
        length: int,
        children: list,
        validity: np.ndarray | None = None,
        offsets: np.ndarray | None = None,
    ) -> None:
        self.field = field
        self.kind = kind  # 'struct' | 'list'
        self.length = int(length)
        self.children = children
        self.validity = validity
        self.offsets = (
            np.asarray(offsets, dtype=np.int64) if offsets is not None
            else None
        )
        self._obj: np.ndarray | None = None
        self._builders: dict | None = None

    def __len__(self) -> int:
        return self.length

    @property
    def nbytes(self) -> int:
        n = sum(c.nbytes for c in self.children)
        if self.validity is not None:
            n += self.validity.nbytes
        if self.offsets is not None:
            n += self.offsets.nbytes
        return n

    def _get_one(self, i: int):
        return self.as_object()[i]

    def as_object(self) -> np.ndarray:
        if self._obj is not None:
            return self._obj
        n = len(self)
        out = np.empty(n, dtype=object)
        if n:
            fn = _pyassemble()
            vals = (
                _assemble_rows_c(self, fn) if fn is not None
                else _assemble_rows_py(self)
            )
            out[:] = vals
        self._obj = out
        return out

    def take(self, indices: np.ndarray) -> "NestedColumn":
        idx = np.asarray(indices, dtype=np.int64)
        v = self.validity[idx] if self.validity is not None else None
        if self.kind == "struct":
            return NestedColumn(
                self.field, "struct", len(idx),
                [c.take(idx) for c in self.children], v,
            )
        o = self.offsets
        lens = o[1:] - o[:-1]
        nl = lens[idx]
        noffs = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(nl, out=noffs[1:])
        total = int(noffs[-1])
        if total:
            pos = (
                np.repeat(o[:-1][idx] - noffs[:-1], nl)
                + np.arange(total, dtype=np.int64)
            )
            elem = self.children[0].take(pos)
        else:
            elem = self.children[0].take(
                np.empty(0, dtype=np.int64)
            )
        return NestedColumn(
            self.field, "list", len(idx), [elem], v, noffs
        )

    @staticmethod
    def concat(cols: list["NestedColumn"]) -> "NestedColumn":
        first = cols[0]
        if any(c.validity is not None for c in cols):
            validity = np.concatenate(
                [
                    c.validity
                    if c.validity is not None
                    else np.ones(len(c), dtype=bool)
                    for c in cols
                ]
            )
        else:
            validity = None
        n = sum(len(c) for c in cols)
        if first.kind == "struct":
            children = [
                concat_columns([c.children[i] for c in cols])
                for i in range(len(first.children))
            ]
            return NestedColumn(first.field, "struct", n, children, validity)
        offs = np.empty(n + 1, dtype=np.int64)
        offs[0] = 0
        pos, base = 1, 0
        for c in cols:
            k = len(c)
            offs[pos: pos + k] = c.offsets[1:] + base
            base += int(c.offsets[-1])
            pos += k
        elem = concat_columns([c.children[0] for c in cols])
        return NestedColumn(first.field, "list", n, [elem], validity, offs)

    def __repr__(self) -> str:
        return (
            f"NestedColumn({self.kind} {self.field.name!r}, "
            f"{self.length} rows)"
        )


def concat_columns(cols: list):
    """Concat a list of same-shape columns (all Column subclass or all
    ndarray).  Mixed representations (a legacy object chunk next to a
    columnar one) materialize — correctness over layout."""
    if all(isinstance(c, StringColumn) for c in cols):
        return StringColumn.concat(cols)
    if all(isinstance(c, PrimitiveColumn) for c in cols):
        return PrimitiveColumn.concat(cols)
    if all(isinstance(c, NestedColumn) for c in cols):
        return NestedColumn.concat(cols)
    return np.concatenate([as_numpy(c) for c in cols])


# -- row assembly (sink/UDF boundary) -------------------------------------

_PA_SENTINEL = object()
_pa_fn = _PA_SENTINEL  # resolved on first use; None = unavailable


def _pyassemble():
    """The C row assembler (native/pyassemble.cpp), or None when it can't
    build here (no compiler / no Python headers — the generated-
    comprehension fallback then does the reassembly).  Loaded via PyDLL:
    the assembler manipulates Python objects and must hold the GIL."""
    global _pa_fn
    if _pa_fn is not _PA_SENTINEL:
        return _pa_fn
    import sysconfig

    from denormalized_tpu_torch.native.build import NativeBuildError, load

    try:
        inc = sysconfig.get_paths()["include"]
        pylib = load("pyassemble", (f"-I{inc}",), pydll=True)
    except (NativeBuildError, OSError) as e:
        from denormalized_tpu_torch.runtime.tracing import logger

        logger.warning(
            "pyassemble (C row assembler) unavailable (%s: %s) — nested "
            "reassembly uses the generated-comprehension path",
            type(e).__name__, e,
        )
        _pa_fn = None
        return _pa_fn
    fn = pylib.pa_rows
    fn.restype = ctypes.py_object
    fn.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_uint64,
    ]
    _pa_fn = fn
    return _pa_fn


def _valid_ptr(validity: np.ndarray | None):
    """ctypes arg for a validity array: NULL when all-valid so the C
    walker skips the per-value presence load entirely."""
    if validity is None:
        return None
    if validity.all():
        return None
    return ctypes.c_void_p(validity.ctypes.data)


def _assemble_rows_c(col: NestedColumn, fn) -> list:
    """One nested column's Python rows via pa_rows: flatten the column
    tree into the parallel node arrays, handing it the column's OWN
    buffers — string leaves pre-materialize per COLUMN (cached on the
    leaf), everything else is read straight off the typed buffers."""
    types: list[int] = []
    parents: list[int] = []
    names: list[bytes] = []
    datas: list = []
    valids: list = []
    offs: list = []
    keep: list = []  # arrays that must outlive the call

    def add(node, name: str, parent: int) -> None:
        idx = len(types)
        types.append(0)
        parents.append(parent)
        names.append(name.encode())
        datas.append(None)
        valids.append(None)
        offs.append(None)
        if isinstance(node, NestedColumn):
            if node.kind == "struct":
                types[idx] = 4
                valids[idx] = _valid_ptr(node.validity)
                for f, c in zip(node.field.children, node.children):
                    add(c, f.name, idx)
            else:
                types[idx] = 5
                valids[idx] = _valid_ptr(node.validity)
                offsets = node.offsets
                keep.append(offsets)
                offs[idx] = ctypes.c_void_p(offsets.ctypes.data)
                add(node.children[0], "item", idx)
        elif isinstance(node, StringColumn):
            types[idx] = 3
            arr = node.as_object()  # cached; Nones already placed
            keep.append(arr)
            datas[idx] = ctypes.c_void_p(arr.ctypes.data)
        else:  # PrimitiveColumn
            types[idx] = _PRIM_CODE[node.kind]
            datas[idx] = ctypes.c_void_p(node.values.ctypes.data)
            valids[idx] = _valid_ptr(node.validity)

    add(col, col.field.name, -1)
    nn = len(types)
    rows = fn(
        nn,
        (ctypes.c_int * nn)(*types),
        (ctypes.c_int * nn)(*parents),
        (ctypes.c_char_p * nn)(*names),
        (ctypes.c_void_p * nn)(*datas),
        (ctypes.c_void_p * nn)(*valids),
        (ctypes.c_void_p * nn)(*offs),
        len(col),
    )
    del keep
    return rows


def _compile_fused_builder(expr: str, nargs: int):
    """Compile a row builder that assembles one struct column's python
    rows in a SINGLE comprehension: ``expr`` is a nested dict LITERAL
    over loop variables a0..aN (one per leaf/list value list, plus one
    per non-all-present sub-struct presence list), so a whole struct
    subtree materializes in one zip pass with no intermediate per-child
    lists.  Field names are embedded via repr (arbitrary key strings are
    safe); argument names are synthesized."""
    args = ", ".join(f"A{i}" for i in range(nargs))
    unpack = ", ".join(f"a{i}" for i in range(nargs))
    # `for a0 in zip(A0)` would bind the 1-TUPLE, not the element
    loop = (
        f"for {unpack} in zip({args})" if nargs > 1 else "for a0 in A0"
    )
    src = f"def _b({args}):\n    return [{expr} {loop}]\n"
    ns: dict = {}
    exec(src, ns)  # noqa: S102 — schema-derived, keys repr-escaped
    return ns["_b"]


def _assemble_rows_py(col) -> list:
    """Python-fallback assembly (no pyassemble): struct subtrees fuse
    into one generated dict-literal comprehension (builders cached per
    which-sub-structs-were-all-present key), lists reassemble by offset
    slicing — a few list comprehensions per column, never per-row
    ``json.loads``."""
    if isinstance(col, (PrimitiveColumn,)):
        return col._pylist()
    if isinstance(col, StringColumn):
        return col.as_object().tolist()
    if col.kind == "list":
        valid = col.validity
        offs = col.offsets.tolist()
        elems = _assemble_rows_py(col.children[0])
        if valid is None:
            return [
                elems[offs[i]: offs[i + 1]] for i in range(len(col))
            ]
        return [
            elems[offs[i]: offs[i + 1]] if v else None
            for i, v in enumerate(valid.tolist())
        ]
    # struct: fuse the subtree into one comprehension
    n = len(col)
    atoms: list = []
    key: list[bool] = []

    def gen(node: NestedColumn) -> str:
        pres = node.validity
        all_present = pres is None or bool(pres.all())
        parts = []
        for f, c in zip(node.field.children, node.children):
            if isinstance(c, NestedColumn) and c.kind == "struct":
                cexpr = gen(c)
            else:
                ai = len(atoms)
                atoms.append(_assemble_rows_py(c))
                cexpr = f"a{ai}"
            parts.append(f"{f.name!r}: {cexpr}")
        literal = "{" + ", ".join(parts) + "}"
        if all_present:
            key.append(True)
            return literal
        key.append(False)
        pi = len(atoms)
        atoms.append(pres.tolist())
        return f"({literal} if a{pi} else None)"

    if not col.field.children:
        pres = col.validity
        if pres is None:
            return [dict() for _ in range(n)]
        return [dict() if p else None for p in pres.tolist()]
    expr = gen(col)
    if col._builders is None:
        col._builders = {}
    builder = col._builders.get(tuple(key))
    if builder is None:
        builder = _compile_fused_builder(expr, len(atoms))
        col._builders[tuple(key)] = builder
    return builder(*atoms)


# -- spec/buffer codec (exchange frames, spill blocks, snapshots) ---------
#
# One codec for every binary carrier: ``column_spec_and_buffers`` flattens
# a column into a JSON-safe spec plus an ordered list of raw ndarray
# buffers (depth-first), ``column_from_spec`` rebuilds it.  The exchange
# lane ships the buffers as frame sub-buffers; the spill/checkpoint lane
# stores them as named pack_snapshot arrays.  No pickle, no JSON value
# lists — string columns travel as raw offsets+bytes.


def field_to_spec(f: Field) -> dict:
    spec: dict = {"n": f.name, "t": f.dtype.value}
    if f.children:
        spec["c"] = [field_to_spec(c) for c in f.children]
    return spec


def field_from_spec(spec: dict) -> Field:
    return Field(
        spec["n"],
        DataType(spec["t"]),
        children=tuple(field_from_spec(c) for c in spec.get("c", ())),
    )


def column_spec_and_buffers(col) -> tuple[dict, list[np.ndarray]]:
    bufs: list[np.ndarray] = []

    def walk(node) -> dict:
        if isinstance(node, StringColumn):
            spec = {"k": "str", "v": node.validity is not None}
            bufs.append(node.offsets)
            bufs.append(node.data)
            if node.validity is not None:
                bufs.append(np.asarray(node.validity, dtype=bool))
            return spec
        if isinstance(node, PrimitiveColumn):
            spec = {
                "k": "prim", "p": node.kind,
                "v": node.validity is not None,
            }
            bufs.append(node.values)
            if node.validity is not None:
                bufs.append(np.asarray(node.validity, dtype=bool))
            return spec
        if isinstance(node, NestedColumn):
            spec = {
                "k": node.kind,
                "len": len(node),
                "v": node.validity is not None,
                "f": field_to_spec(node.field),
            }
            if node.validity is not None:
                bufs.append(np.asarray(node.validity, dtype=bool))
            if node.kind == "list":
                bufs.append(node.offsets)
            spec["ch"] = [walk(c) for c in node.children]
            return spec
        raise SchemaError(f"not a codec-able column: {type(node).__name__}")

    return walk(col), bufs


def column_from_spec(spec: dict, bufs) -> Column:
    """Rebuild a column from its spec + buffer iterator (the inverse of
    :func:`column_spec_and_buffers`; ``bufs`` yields ndarrays in the
    same depth-first order)."""

    def walk(s: dict):
        k = s["k"]
        if k == "str":
            offsets = next(bufs)
            data = next(bufs)
            validity = (
                np.asarray(next(bufs), dtype=bool) if s["v"] else None
            )
            return StringColumn(offsets, data, validity)
        if k == "prim":
            values = next(bufs)
            validity = (
                np.asarray(next(bufs), dtype=bool) if s["v"] else None
            )
            return PrimitiveColumn(s["p"], values, validity)
        validity = np.asarray(next(bufs), dtype=bool) if s["v"] else None
        offsets = next(bufs) if k == "list" else None
        children = [walk(c) for c in s["ch"]]
        return NestedColumn(
            field_from_spec(s["f"]), k, s["len"], children, validity,
            offsets,
        )

    bufs = iter(bufs)
    return walk(spec)


def column_to_arrays(
    col, prefix: str, arrays: dict[str, np.ndarray]
) -> dict:
    """Named-array carrier (spill blocks / checkpoint snapshots): the
    buffers land in ``arrays`` as ``{prefix}{i}``; returns the JSON-safe
    spec to store in the blob meta."""
    spec, bufs = column_spec_and_buffers(col)
    for i, b in enumerate(bufs):
        arrays[f"{prefix}{i}"] = b
    return {"spec": spec, "nbufs": len(bufs)}

def column_from_arrays(
    entry: dict, prefix: str, arrays: dict[str, np.ndarray]
) -> Column:
    bufs = [arrays[f"{prefix}{i}"] for i in range(int(entry["nbufs"]))]
    return column_from_spec(entry["spec"], iter(bufs))
