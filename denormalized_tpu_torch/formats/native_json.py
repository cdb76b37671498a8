"""ctypes wrapper over the native one-pass JSON → columnar parser (shared
plumbing in :mod:`denormalized_tpu_torch.formats._native_parser_base`).
Copy of ``denormalized_tpu/formats/native_json.py``; the parser
(``native/json_parser.cpp``) is the JAX package's, unchanged.

Flat schemas use the historical column ABI; nested schemas (structs to
any depth, lists of scalars, lists of structs, lists of lists — the full
shape set the reference's arrow-json reader handles natively,
decoders/json.rs:11-49) use the shredded node-tree ABI
(``jp_create_tree``).  Only dynamic-map structs (no declared children)
raise :class:`FormatError`, which routes the decoder to the Python
fallback."""

from __future__ import annotations

import ctypes

from denormalized_tpu_torch.common.errors import FormatError
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.formats._native_parser_base import (
    ColumnarNativeParser,
    NodeDesc,
    configure_lib,
)
from denormalized_tpu_torch.native.build import load

_TYPE_CODE = {
    DataType.INT64: 0,
    DataType.TIMESTAMP_MS: 0,
    DataType.INT32: 0,
    DataType.FLOAT64: 1,
    DataType.FLOAT32: 1,
    DataType.BOOL: 2,
    DataType.STRING: 3,
}
_OUT_KIND = {0: "i64", 1: "f64", 2: "bool", 3: "str"}


def _lib():
    lib = load("json_parser")
    configure_lib(
        lib,
        "jp",
        [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int),
        ],
    )
    if not getattr(lib, "_jp_tree_configured", False):
        lib.jp_create_tree.restype = ctypes.c_void_p
        lib.jp_create_tree.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib._jp_tree_configured = True
    return lib


def build_node_tree(schema: Schema):
    """Flatten a (possibly nested) schema into the parallel arrays the
    ``jp_create_tree`` ABI takes, plus the :class:`NodeDesc` tree used for
    extraction.  Scalar-element lists use the packed type-5 layout
    (elements in the list node's own vectors); lists of structs / lists
    of lists become type-6 generic lists whose single child node is the
    element subtree.  Raises :class:`FormatError` only for childless
    structs — dynamic maps stay on the Python fallback."""
    names: list[bytes] = []
    types: list[int] = []
    etypes: list[int] = []
    parents: list[int] = []

    def add(f: Field, parent: int) -> NodeDesc:
        idx = len(names)
        names.append(f.name.encode())
        parents.append(parent)
        if f.dtype in _TYPE_CODE:
            code = _TYPE_CODE[f.dtype]
            types.append(code)
            etypes.append(-1)
            return NodeDesc(idx, f, _OUT_KIND[code])
        if f.dtype is DataType.STRUCT:
            if not f.children:
                raise FormatError(
                    f"native parser cannot shred dynamic-map struct "
                    f"{f.name!r} (no declared children)"
                )
            types.append(4)
            etypes.append(-1)
            nd = NodeDesc(idx, f, "struct")
            for c in f.children:
                nd.children.append(add(c, idx))
            return nd
        if f.dtype is DataType.LIST:
            if len(f.children) != 1:
                raise FormatError(
                    f"native parser cannot shred list {f.name!r} "
                    f"(exactly one declared element required)"
                )
            elem = f.children[0]
            if elem.dtype in _TYPE_CODE:
                ecode = _TYPE_CODE[elem.dtype]
                types.append(5)
                etypes.append(ecode)
                return NodeDesc(idx, f, "list", elem_kind=_OUT_KIND[ecode])
            # list of structs / list of lists: generic list node, element
            # subtree as the single child
            types.append(6)
            etypes.append(-1)
            nd = NodeDesc(idx, f, "list")
            nd.children.append(add(elem, idx))
            return nd
        raise FormatError(f"native parser cannot handle {f.dtype}")

    tree = [add(f, -1) for f in schema]
    return names, types, etypes, parents, tree


class NativeJsonParser(ColumnarNativeParser):
    _prefix = "jp"

    def __init__(self, schema: Schema):
        self.schema = schema
        self._libref = _lib()
        if all(f.dtype in _TYPE_CODE for f in schema):
            # flat schema: historical column ABI (node i = column i)
            self._tree = None
            self._kinds = [_OUT_KIND[_TYPE_CODE[f.dtype]] for f in schema]
            names = (ctypes.c_char_p * len(schema))(
                *[f.name.encode() for f in schema]
            )
            types = (ctypes.c_int * len(schema))(
                *[_TYPE_CODE[f.dtype] for f in schema]
            )
            self._h = self._libref.jp_create(len(schema), names, types)
            return
        names, types, etypes, parents, tree = build_node_tree(schema)
        n = len(names)
        self._tree = tree
        self._kinds = []  # unused on the tree path
        self._h = self._libref.jp_create_tree(
            n,
            (ctypes.c_char_p * n)(*names),
            (ctypes.c_int * n)(*types),
            (ctypes.c_int * n)(*etypes),
            (ctypes.c_int * n)(*parents),
        )
