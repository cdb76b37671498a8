"""Shared ctypes plumbing for the native columnar parsers (JSON, Avro).

Both C++ parsers expose the same column-oriented ABI behind a prefix
(``jp_`` / ``ap_``): create/destroy/clear/parse/error/nrows plus per-column
getters.  This module owns the signature setup and the parse/extract loop so
the two wrappers can't drift (e.g. null-mask materialization or the
``errors='replace'`` string decode — invalid bytes become U+FFFD so a weird
payload can never crash the reader — live in exactly one place).

Nested schemas (the reference's arrow-json/avro readers handle nested
structs/lists natively — decoders/json.rs:11-49, decoders/avro.rs:11-54)
ride the SHREDDED node-tree ABI: the C++ side parses nested values into
typed leaf columns plus struct-presence bytes and Arrow-style list
(offsets, values, elem-validity) triples; :class:`NodeDesc` mirrors that
tree here, and ``_extract_tree`` snapshots the leaves into Arrow-style
columns (``common/columns.py``) — no per-row ``json.loads``, no DOM.

Copy of ``denormalized_tpu/formats/_native_parser_base.py``, always
columnar: string columns leave the parser as ``StringColumn`` and nested
ones as ``NestedColumn``, so the JAX package's object-array extraction
(its ``DENORMALIZED_COLUMNAR_STRINGS=0`` lane: the dictionary-coded
string decode and the row reassembly at decode time) is not carried
over.  Rows materialize at the sink boundary (``Column.as_object``)."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field as dc_field

import numpy as np

from denormalized_tpu_torch.common.columns import (
    NestedColumn,
    PrimitiveColumn,
    StringColumn,
)
from denormalized_tpu_torch.common.errors import FormatError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema


def configure_lib(lib, prefix: str, create_argtypes: list) -> None:
    """Set ctypes signatures for one parser library (idempotent)."""
    flag = f"_{prefix}_configured"
    if getattr(lib, flag, False):
        return
    g = lambda name: getattr(lib, f"{prefix}_{name}")  # noqa: E731
    g("create").restype = ctypes.c_void_p
    g("create").argtypes = create_argtypes
    g("parse").restype = ctypes.c_int
    g("parse").argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,  # bytes or a raw pointer into a native buffer
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
    ]
    g("error").restype = ctypes.c_char_p
    g("error").argtypes = [ctypes.c_void_p]
    g("nrows").restype = ctypes.c_uint64
    g("nrows").argtypes = [ctypes.c_void_p]
    for fn, restype in (
        ("col_i64", ctypes.POINTER(ctypes.c_int64)),
        ("col_f64", ctypes.POINTER(ctypes.c_double)),
        ("col_bool", ctypes.POINTER(ctypes.c_uint8)),
        ("col_valid", ctypes.POINTER(ctypes.c_uint8)),
        ("col_str_offsets", ctypes.POINTER(ctypes.c_uint64)),
    ):
        g(fn).restype = restype
        g(fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
    g("col_str_bytes").restype = ctypes.POINTER(ctypes.c_uint8)
    g("col_str_bytes").argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    # node-tree (nested) accessors — present on parsers that support the
    # shredded ABI; probed once
    setattr(
        lib, f"_{prefix}_has_tree", hasattr(lib, f"{prefix}_col_list_offsets")
    )
    if getattr(lib, f"_{prefix}_has_tree"):
        g("col_list_offsets").restype = ctypes.POINTER(ctypes.c_uint64)
        g("col_list_offsets").argtypes = [ctypes.c_void_p, ctypes.c_int]
        g("col_list_evalid").restype = ctypes.POINTER(ctypes.c_uint8)
        g("col_list_evalid").argtypes = [ctypes.c_void_p, ctypes.c_int]
        g("col_list_nelems").restype = ctypes.c_uint64
        g("col_list_nelems").argtypes = [ctypes.c_void_p, ctypes.c_int]
    g("clear").argtypes = [ctypes.c_void_p]
    g("destroy").argtypes = [ctypes.c_void_p]
    setattr(lib, flag, True)


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1

# natural storage dtype per nested-leaf kind on the columnar path (bool
# stays u8 — pyassemble's type-2 reads bytes)
_PRIM_NP = {"i64": np.int64, "f64": np.float64, "bool": np.uint8}


@dataclass
class NodeDesc:
    """One node of the shredded schema tree, mirroring the C++ side.

    ``kind``: 'i64' | 'f64' | 'bool' | 'str' | 'struct' | 'list'.
    For packed scalar lists, ``elem_kind`` is the scalar element kind;
    generic lists (struct/list elements) leave it None and carry the
    element subtree as the single entry of ``children``."""

    idx: int
    field: Field
    kind: str
    children: list = dc_field(default_factory=list)
    elem_kind: str | None = None




class ColumnarNativeParser:
    """Base wrapper: subclasses set ``_libref``, ``_h``, ``_prefix``,
    ``schema`` and ``_kinds`` ('i64'|'f64'|'bool'|'str' per column)."""

    schema: Schema
    _kinds: list[str]
    _prefix: str

    def _fn(self, name: str):
        return getattr(self._libref, f"{self._prefix}_{name}")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._fn("destroy")(h)
            self._h = None

    def parse(self, rows: list[bytes]) -> RecordBatch:
        n = len(rows)
        if n == 0:
            return RecordBatch.empty(self.schema)
        data = b"".join(rows)
        offsets = np.zeros(n + 1, dtype=np.uint64)
        offsets[1:] = np.cumsum([len(r) for r in rows], dtype=np.uint64)
        return self.parse_ptr(
            data, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n
        )

    def parse_ptr(self, data, offsets_ptr, n: int) -> RecordBatch:
        """Zero-copy entry: ``data`` may be a bytes object OR a raw ctypes
        pointer into another native component's buffer (e.g. the Kafka
        client's fetch arena) — payload bytes never become Python
        objects."""
        self._fn("clear")(self._h)
        rc = self._fn("parse")(self._h, data, offsets_ptr, n)
        if rc != 0:
            raise FormatError(self._fn("error")(self._h).decode())
        tree = getattr(self, "_tree", None)
        if tree is not None:
            return self._extract_tree(tree, n)
        cols, masks = [], []
        for ci, f in enumerate(self.schema):
            if self._kinds[ci] == "str":
                # zero-copy handoff: offsets+bytes snapshot into a
                # StringColumn (one bulk memcpy off the parser arena),
                # no per-row str materialization on the decode path
                col = self._snapshot_string(ci, n)
                cols.append(col)
                masks.append(col.validity)
                continue
            arr, valid = self._scalar_arrays(
                ci, self._kinds[ci], n, f.dtype.to_numpy()
            )
            cols.append(arr)
            masks.append(None if valid.all() else valid)
        return RecordBatch(self.schema, cols, masks)

    def _scalar_arrays(self, ci: int, kind: str, count: int, np_dtype):
        """(values, validity) for one scalar node: ``ci`` is the C-side
        node index, ``count`` the entry count (nrows for row-level nodes,
        nelems for list elements)."""
        valid = np.ctypeslib.as_array(
            self._fn("col_valid")(self._h, ci), shape=(count,)
        ).astype(bool) if count else np.ones(0, dtype=bool)
        return self._scalar_values(ci, kind, count, np_dtype), valid

    def _scalar_values(self, ci: int, kind: str, count: int, np_dtype):
        """Numeric/bool values of one scalar node (strings leave the
        parser as ``StringColumn`` snapshots instead)."""
        if count == 0:
            return np.empty(0, dtype=np_dtype)
        if kind == "i64":
            vals = np.ctypeslib.as_array(
                self._fn("col_i64")(self._h, ci), shape=(count,)
            )
            if np.dtype(np_dtype).itemsize < 8:
                # narrowing (INT32 columns): saturate like the i64 parse
                # itself does — astype alone would WRAP out-of-range values
                info = np.iinfo(np_dtype)
                vals = np.clip(vals, info.min, info.max)
            return vals.astype(np_dtype, copy=True)
        if kind == "f64":
            # narrowing to f32 overflows out-of-range values to +-inf —
            # the same result the Python fallback's element assignment
            # produces; the RuntimeWarning is expected, not actionable
            with np.errstate(over="ignore"):
                return np.ctypeslib.as_array(
                    self._fn("col_f64")(self._h, ci), shape=(count,)
                ).astype(np_dtype, copy=True)
        # bool
        return np.ctypeslib.as_array(
            self._fn("col_bool")(self._h, ci), shape=(count,)
        ).astype(bool)

    # -- columnar (zero-copy) snapshots ----------------------------------
    # One bulk copy per buffer off the parser arena into column-owned
    # ndarrays (the parser's buffers die at the next parse/clear); rows
    # materialize lazily at the sink/UDF boundary via Column.as_object.

    def _snapshot_valid(self, idx: int, count: int) -> np.ndarray | None:
        """Copied bool validity for node ``idx``, or None when all-valid."""
        if count == 0:
            return None
        valid = np.ctypeslib.as_array(
            self._fn("col_valid")(self._h, idx), shape=(count,)
        ).astype(bool)
        return None if valid.all() else valid

    def _snapshot_string(
        self, idx: int, count: int, validity: np.ndarray | None = None,
        own_valid: bool = True,
    ) -> StringColumn:
        """StringColumn snapshot of node ``idx``'s offsets+bytes vectors
        (also used for packed str list ELEMENTS, whose validity comes
        from the list node's evalid — pass it via ``validity``)."""
        if count == 0:
            return StringColumn(
                np.zeros(1, dtype=np.int64), np.empty(0, dtype=np.uint8)
            )
        if own_valid:
            validity = self._snapshot_valid(idx, count)
        nb = ctypes.c_uint64()
        bptr = self._fn("col_str_bytes")(self._h, idx, ctypes.byref(nb))
        data = (
            np.frombuffer(ctypes.string_at(bptr, nb.value), dtype=np.uint8)
            if nb.value else np.empty(0, dtype=np.uint8)
        )
        offs = np.ctypeslib.as_array(
            self._fn("col_str_offsets")(self._h, idx), shape=(count + 1,)
        ).astype(np.int64)
        return StringColumn(offs, data, validity)

    def _snapshot_scalar(
        self, idx: int, kind: str, count: int, field: Field | None,
        validity: np.ndarray | None,
    ):
        """PrimitiveColumn/StringColumn snapshot of one scalar node at
        the parser's natural width; declared-INT32 leaves saturate at
        i32 bounds here (the one place the declared width is enforced,
        same as the legacy extraction)."""
        if kind == "str":
            return self._snapshot_string(
                idx, count, validity, own_valid=False
            )
        if count == 0:
            return PrimitiveColumn(
                kind, np.empty(0, dtype=_PRIM_NP[kind]), None
            )
        if kind == "i64":
            view = np.ctypeslib.as_array(
                self._fn("col_i64")(self._h, idx), shape=(count,)
            )
            if field is not None and field.dtype is DataType.INT32:
                vals = np.clip(view, _I32_MIN, _I32_MAX)
            else:
                vals = view.copy()
        elif kind == "f64":
            vals = np.ctypeslib.as_array(
                self._fn("col_f64")(self._h, idx), shape=(count,)
            ).copy()
        else:  # bool, stored u8 (pyassemble type-2 reads bytes)
            vals = np.ctypeslib.as_array(
                self._fn("col_bool")(self._h, idx), shape=(count,)
            ).copy()
        return PrimitiveColumn(kind, vals, validity)

    def _snapshot_node(self, nd: "NodeDesc", count: int):
        """Column snapshot of one shredded node subtree."""
        validity = self._snapshot_valid(nd.idx, count)
        if nd.kind == "struct":
            children = [
                self._snapshot_node(c, count) for c in nd.children
            ]
            return NestedColumn(
                nd.field, "struct", count, children, validity
            )
        if nd.kind == "list":
            offs = (
                np.ctypeslib.as_array(
                    self._fn("col_list_offsets")(self._h, nd.idx),
                    shape=(count + 1,),
                ).astype(np.int64)
                if count else np.zeros(1, dtype=np.int64)
            )
            ne = (
                int(self._fn("col_list_nelems")(self._h, nd.idx))
                if count else 0
            )
            if nd.elem_kind is not None:
                # packed scalar elements: values live in the list node's
                # own vectors, element validity in evalid
                evalid = None
                if ne:
                    ev = np.ctypeslib.as_array(
                        self._fn("col_list_evalid")(self._h, nd.idx),
                        shape=(ne,),
                    ).astype(bool)
                    evalid = None if ev.all() else ev
                efield = (
                    nd.field.children[0] if nd.field.children else None
                )
                elem = self._snapshot_scalar(
                    nd.idx, nd.elem_kind, ne, efield, evalid
                )
            else:
                elem = self._snapshot_node(nd.children[0], ne)
            return NestedColumn(
                nd.field, "list", count, [elem], validity, offs
            )
        return self._snapshot_scalar(
            nd.idx, nd.kind, count, nd.field, validity
        )

    # -- nested (shredded) extraction ------------------------------------

    def _extract_tree(self, tree: list, n: int) -> RecordBatch:
        cols, masks = [], []
        for nd in tree:
            if nd.kind in ("struct", "list"):
                col = self._snapshot_node(nd, n)
                cols.append(col)
                masks.append(col.validity)
            elif nd.kind == "str":
                col = self._snapshot_string(nd.idx, n)
                cols.append(col)
                masks.append(col.validity)
            else:
                # top-level scalar leaves stay plain ndarrays at the
                # DECLARED dtype, exactly like the flat column path
                arr, valid = self._scalar_arrays(
                    nd.idx, nd.kind, n, nd.field.dtype.to_numpy()
                )
                cols.append(arr)
                masks.append(None if valid.all() else valid)
        return RecordBatch(self.schema, cols, masks)
