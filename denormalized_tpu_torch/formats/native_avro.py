"""ctypes wrapper over the native one-pass Avro-binary → columnar parser.

Copy of ``denormalized_tpu/formats/native_avro.py``; the parser
(``native/avro_parser.cpp``) is the JAX package's, unchanged, built into
``_build/`` at first use.  The port's parser base is always columnar, so
the node tree's leaves leave the parser as ``StringColumn``s and
``NestedColumn``s, as the JSON parser's do.  Same shape as
:mod:`denormalized_tpu_torch.formats.native_json` (shared plumbing in
:mod:`denormalized_tpu_torch.formats._native_parser_base`): ``parse_ptr``
accepts either bytes or a raw pointer into another native component's
buffer (the Kafka fetch arena), so payload bytes never become Python
objects on the hot path.  Reference capability: the Rust-native Avro
decode at crates/core/src/formats/decoders/avro.rs:11-54.

Flat records of primitives use the historical positional-column ABI;
nested records and arrays (of primitives, records, or arrays — to any
depth) use the schema-tree ABI (``ap_create_tree``), the Avro analog of
the JSON parser's shredded node tree.  Shapes outside that — maps, enums,
fixed, ``bytes`` fields, unions beyond the ``["null", T]`` sugar,
recursive named types — raise :class:`FormatError`, which routes the
decoder to the recursive pure-Python codec.
"""

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

# native type codes (see avro_parser.cpp): base Avro type → code.
# 'bytes' is deliberately absent: the native path would decode it as UTF-8
# text (destroying binary payloads) while the Python fallback returns raw
# bytes — schemas with bytes fields fall back to the Python decoder so the
# column content never depends on whether a compiler was available.
_AVRO_CODE = {
    "int": 0,
    "long": 0,
    "boolean": 2,
    "float": 4,
    "double": 1,
    "string": 3,
}
_OUT_KIND = {0: "i64", 1: "f64", 4: "f64", 2: "bool", 3: "str"}

_STRUCT_CODE = 5
_LIST_CODE = 6


def _lib():
    lib = load("avro_parser")
    configure_lib(
        lib,
        "ap",
        [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ],
    )
    if not getattr(lib, "_ap_tree_configured", False):
        lib.ap_create_tree.restype = ctypes.c_void_p
        lib.ap_create_tree.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib._ap_tree_configured = True
    return lib


def _scalar_code(t) -> int | None:
    """Native scalar code for a resolved Avro type, or None (annotated
    primitives — timestamp-millis longs — count as their base)."""
    base = t.get("type") if isinstance(t, dict) else t
    if not isinstance(base, str):
        return None
    return _AVRO_CODE.get(base)


def build_avro_node_tree(avro_schema, schema: Schema):
    """Flatten a resolved :class:`AvroSchema` into the parallel arrays the
    ``ap_create_tree`` ABI takes, plus the :class:`NodeDesc` tree used
    for extraction.  The engine ``schema`` must align positionally (Avro
    decode is positional — a reordered/subset user schema would silently
    mislabel columns) at EVERY record level.  Raises :class:`FormatError`
    for any shape the native walker does not decode (see module doc)."""
    types: list[int] = []
    nullables: list[int] = []
    parents: list[int] = []

    def add(name: str, t, nullable: bool, field: Field, parent: int) -> NodeDesc:
        if field.name != name:
            raise FormatError(
                f"engine field {field.name!r} does not align positionally "
                f"with Avro field {name!r}"
            )
        if isinstance(t, list):
            # general union (includes ['T', 'null'] order, whose wire
            # branch indices invert the nullable sugar): Python decoder
            raise FormatError(
                f"native Avro parser cannot handle union {t!r}"
            )
        idx = len(types)
        code = _scalar_code(t)
        if code is not None:
            types.append(code)
            nullables.append(1 if nullable else 0)
            parents.append(parent)
            return NodeDesc(idx, field, _OUT_KIND[code])
        if not isinstance(t, dict):
            raise FormatError(f"native Avro parser cannot handle {t!r}")
        kind = t.get("type")
        if kind == "record":
            fields_spec = t["_fields"]
            if (
                field.dtype is not DataType.STRUCT
                or len(field.children) != len(fields_spec)
            ):
                # childless STRUCT = recursive back-reference or a shape
                # mismatch — either way the static tree can't cover it
                raise FormatError(
                    f"engine field {field.name!r} does not match Avro "
                    f"record {t.get('name')!r}"
                )
            types.append(_STRUCT_CODE)
            nullables.append(1 if nullable else 0)
            parents.append(parent)
            nd = NodeDesc(idx, field, "struct")
            for (fname, ftype, fnull), cf in zip(fields_spec, field.children):
                nd.children.append(add(fname, ftype, fnull, cf, idx))
            return nd
        if kind == "array":
            if field.dtype is not DataType.LIST or len(field.children) != 1:
                raise FormatError(
                    f"engine field {field.name!r} does not match Avro array"
                )
            items = t["items"]
            inull = False
            if isinstance(items, list):
                # items-level nullable sugar; only the ['null', T] order
                # maps onto the branch-0-is-null wire walk
                if len(items) == 2 and items[0] == "null":
                    items, inull = items[1], True
                else:
                    raise FormatError(
                        f"native Avro parser cannot handle item union "
                        f"{items!r}"
                    )
            types.append(_LIST_CODE)
            nullables.append(1 if nullable else 0)
            parents.append(parent)
            nd = NodeDesc(idx, field, "list")
            elem = field.children[0]
            nd.children.append(add(elem.name, items, inull, elem, idx))
            return nd
        # maps (dynamic keys), enums, fixed, bytes: Python decoder
        raise FormatError(f"native Avro parser cannot handle {t!r}")

    if len(schema) != len(avro_schema.fields):
        raise FormatError(
            "engine schema does not align positionally with the Avro "
            "declaration"
        )
    tree = [
        add(name, t, nullable, f, -1)
        for (name, t, nullable), f in zip(avro_schema.fields, schema)
    ]
    return types, nullables, parents, tree


class NativeAvroParser(ColumnarNativeParser):
    """One parser per AvroSchema; positional fields, schema-tree driven."""

    _prefix = "ap"

    def __init__(self, avro_schema, schema: Schema):
        # Avro fields are positional: the engine schema MUST align
        # one-to-one with the Avro declaration, or columns would be
        # silently mislabeled (a reordered/subset user schema falls back to
        # the by-name pure-Python decoder instead)
        if len(schema) != len(avro_schema.fields) or any(
            f.name != name
            for f, (name, _, _) in zip(schema, avro_schema.fields)
        ):
            raise FormatError(
                "engine schema does not align positionally with the Avro "
                "declaration"
            )
        self.schema = schema
        self._libref = _lib()
        flat_codes = [
            _scalar_code(t) for _, t, _ in avro_schema.fields
        ]
        if all(c is not None for c in flat_codes):
            # flat record of primitives: historical positional-column ABI
            self._tree = None
            self._kinds = [_OUT_KIND[c] for c in flat_codes]
            nullables = [
                1 if nullable else 0 for _, _, nullable in avro_schema.fields
            ]
            n = len(flat_codes)
            self._h = self._libref.ap_create(
                n,
                (ctypes.c_int * n)(*flat_codes),
                (ctypes.c_int * n)(*nullables),
            )
            return
        types, nullables, parents, tree = build_avro_node_tree(
            avro_schema, schema
        )
        n = len(types)
        self._tree = tree
        self._kinds = []  # unused on the tree path
        self._h = self._libref.ap_create_tree(
            n,
            (ctypes.c_int * n)(*types),
            (ctypes.c_int * n)(*nullables),
            (ctypes.c_int * n)(*parents),
        )
