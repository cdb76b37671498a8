"""Avro binary payloads ⇄ columnar batches.

Copy of ``denormalized_tpu/formats/avro_codec.py`` for the port: the
same schema resolution, zigzag codec, encoder and recursive decoder, with
this package's imports.  As with JSON, the native parser's string columns
leave it as ``StringColumn``s (``common/columns.py``); the Python decode
builds its batch with ``json_codec.rows_to_batch``, as the JSON fallback
does.

Mirror of the reference's Avro pipeline: schema-declaration parsing and
recursive Avro→engine-schema conversion (formats/decoders/utils.rs:14
``to_arrow_schema``, which defers to DataFusion's avro_to_arrow recursive
schema converter), the ``AvroDecoder`` (formats/decoders/avro.rs:11-54),
and the value⇄JSON bridges in utils/arrow_helpers.rs:52-126.  Implemented
from the Avro 1.11 binary spec (zigzag varints, length-prefixed bytes,
union-by-index, block-encoded arrays/maps) — the image ships no avro
library.  An encoder is included so tests can produce real Avro bytes
(the reference tests do the same with apache-avro, decoders/avro.rs:56-159).

Supported (round-4: full recursive coverage):
  - primitives null/boolean/int/long/float/double/string/bytes
  - logical type timestamp-millis / local-timestamp-millis
  - records nested to any depth  → engine STRUCT columns
  - arrays (block-encoded, negative block counts) → engine LIST columns
  - maps with string keys        → engine STRUCT columns (dynamic keys:
    decoded as plain dicts; no per-key child fields)
  - enums → engine STRING (symbol name), fixed → raw bytes
  - named-type references (a record/enum/fixed may be referenced by name,
    including namespace-qualified, after its definition)
  - unions: ``["null", T]`` (either order) is the nullable sugar; general
    multi-branch unions decode by branch index, and convert to an engine
    dtype only when all non-null branches share one engine dtype.

The native one-pass parser (avro_parser.cpp) decodes flat records AND
nested records/arrays (of primitives, records, or arrays, to any depth)
via its schema-tree ABI; :class:`AvroDecoder` routes the remaining shapes
(maps, enums, fixed, bytes fields, general unions, recursive named types)
to this recursive pure-Python decoder — defined fallback, not an error,
and counted in ``decode_fallback_rows`` so it is observable.
"""

from __future__ import annotations

import io
import json
import struct

from denormalized_tpu_torch.common.errors import FormatError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.formats import Decoder, _warn_native_unavailable
from denormalized_tpu_torch.formats.json_codec import rows_to_batch

_PRIMITIVE = {
    "boolean": DataType.BOOL,
    "int": DataType.INT32,
    "long": DataType.INT64,
    "float": DataType.FLOAT32,
    "double": DataType.FLOAT64,
    "string": DataType.STRING,
    "bytes": DataType.STRING,
}

_PRIMITIVE_NAMES = frozenset(
    ("null", "boolean", "int", "long", "float", "double", "string", "bytes")
)


def parse_avro_schema(decl: str | dict) -> "AvroSchema":
    if isinstance(decl, str):
        decl = json.loads(decl)
    return AvroSchema(decl)


def _fullname(decl: dict, enclosing_ns: str | None) -> tuple[str, str | None]:
    """(fullname, namespace) per Avro spec §names."""
    name = decl.get("name")
    if not name:
        raise FormatError(f"named Avro type missing 'name': {decl!r}")
    if "." in name:
        ns, _, short = name.rpartition(".")
        return name, ns
    ns = decl.get("namespace", enclosing_ns)
    return (f"{ns}.{name}" if ns else name), ns


class AvroSchema:
    """Parsed + resolved Avro schema.

    ``self.fields`` is a list of ``(name, resolved_type, nullable)`` for the
    top-level record — the shape the native parser and the encoder consume.
    A *resolved type* is one of:
      - a primitive name string ("long", "string", …)
      - a dict with resolved children: record (fields as the same triple
        list under "_fields"), array ("items" resolved), map ("values"
        resolved), enum, fixed, or a logical-type annotated primitive
      - a list of resolved branches (general union, kept in branch order)
    Named-type references are resolved during parsing; unknown names raise.
    """

    def __init__(self, decl: dict):
        if isinstance(decl, str):
            decl = json.loads(decl)
        if not (isinstance(decl, dict) and decl.get("type") == "record"):
            raise FormatError("top-level Avro schema must be a record")
        self.decl = decl
        self._named: dict[str, object] = {}
        resolved = self._resolve(decl, None)
        self.fields: list[tuple[str, object, bool]] = [
            (n, t, nb) for n, t, nb in resolved["_fields"]
        ]

    # -- schema resolution -------------------------------------------------

    def _resolve(self, t, ns):
        """Recursively resolve an Avro type declaration (see class doc)."""
        if isinstance(t, str):
            if t in _PRIMITIVE_NAMES:
                return t
            # named reference — try qualified then bare
            for key in ((f"{ns}.{t}" if ns and "." not in t else t), t):
                if key in self._named:
                    return self._named[key]
            raise FormatError(f"unknown Avro type name {t!r}")
        if isinstance(t, list):
            branches = [self._resolve(b, ns) for b in t]
            if len(branches) < 2:
                raise FormatError(f"Avro union needs >= 2 branches: {t!r}")
            return branches
        if not isinstance(t, dict):
            raise FormatError(f"invalid Avro type declaration {t!r}")
        kind = t.get("type")
        if kind == "record":
            full, inner_ns = _fullname(t, ns)
            out = {"type": "record", "name": full, "_fields": []}
            # register BEFORE resolving fields so recursive types
            # (linked-list style self references) resolve
            self._named[full] = out
            for f in t.get("fields", ()):
                fname = f.get("name")
                if fname is None:
                    raise FormatError(f"record field missing name: {f!r}")
                ftype, nullable = self._field_type(f["type"], inner_ns)
                out["_fields"].append((fname, ftype, nullable))
            return out
        if kind == "array":
            return {"type": "array", "items": self._resolve(t["items"], ns)}
        if kind == "map":
            return {"type": "map", "values": self._resolve(t["values"], ns)}
        if kind == "enum":
            full, _ = _fullname(t, ns)
            symbols = list(t.get("symbols", ()))
            if not symbols:
                raise FormatError(f"Avro enum {full!r} has no symbols")
            out = {"type": "enum", "name": full, "symbols": symbols}
            self._named[full] = out
            return out
        if kind == "fixed":
            full, _ = _fullname(t, ns)
            out = {"type": "fixed", "name": full, "size": int(t["size"])}
            self._named[full] = out
            return out
        if kind in _PRIMITIVE_NAMES or isinstance(kind, (dict, list)):
            # annotated primitive ({"type": "long", "logicalType": ...})
            # or nested type declaration under "type"
            if isinstance(kind, str):
                keep = {k: v for k, v in t.items() if k != "name"}
                return keep
            return self._resolve(kind, ns)
        raise FormatError(f"unsupported Avro type {t!r}")

    def _field_type(self, t, ns) -> tuple[object, bool]:
        """Resolve a field's type; strip the ``[null, T]`` nullable sugar."""
        resolved = self._resolve(t, ns)
        if isinstance(resolved, list):
            non_null = [b for b in resolved if b != "null"]
            if len(resolved) == 2 and len(non_null) == 1:
                # nullable sugar — but branch ORDER still matters on the
                # wire, so remember whether null was branch 0
                if resolved[0] == "null":
                    return non_null[0], True
                # ['T', 'null']: keep the union so decode maps indices
                # correctly; conversion treats it as nullable T
                return resolved, True
            return resolved, any(b == "null" for b in resolved)
        return resolved, False

    # -- engine schema -----------------------------------------------------

    def to_engine_schema(self) -> Schema:
        """Avro → engine schema (to_arrow_schema, decoders/utils.rs:14)."""
        out = []
        for name, t, nullable in self.fields:
            out.append(_avro_field(name, t, nullable, set()))
        return Schema(out)


def _avro_field(name: str, t, nullable: bool, in_progress: frozenset) -> Field:
    dtype, children = _avro_type_to_dtype(t, in_progress)
    return Field(name, dtype, nullable, children=children)


def _avro_type_to_dtype(t, in_progress=frozenset()) -> tuple[DataType, tuple]:
    """Resolved Avro type → (engine DataType, children Fields).

    ``in_progress`` holds record names on the current conversion path: a
    back-reference (self-referential / mutually recursive types, valid
    Avro) can't expand to a finite static child list, so it degrades to a
    childless STRUCT — the host-only dict column, same treatment as maps.
    """
    if isinstance(t, list):  # general union
        non_null = [b for b in t if b != "null"]
        if not non_null:
            raise FormatError("Avro union of only null is not a column type")
        converted = [_avro_type_to_dtype(b, in_progress) for b in non_null]
        first = converted[0]
        # full (dtype, children) equality: two record branches that are
        # both STRUCT but with different fields have no single column
        # schema — guessing the first branch's children would silently
        # hide the other branch's fields
        if all(c == first for c in converted[1:]):
            return first
        # numeric branches widen to the largest member (float dominates
        # int, 64 dominates 32) — the avro_to_arrow-style promotion
        _RANK = {
            DataType.INT32: 0,
            DataType.INT64: 1,
            DataType.TIMESTAMP_MS: 1,
            DataType.FLOAT32: 2,
            DataType.FLOAT64: 3,
        }
        if all(c[0] in _RANK and not c[1] for c in converted):
            widest = max(converted, key=lambda c: _RANK[c[0]])[0]
            if widest is DataType.FLOAT32 or any(
                c[0] in (DataType.FLOAT32, DataType.FLOAT64)
                for c in converted
            ):
                widest = DataType.FLOAT64
            return widest, ()
        raise FormatError(
            f"Avro union branches map to mixed engine dtypes: {t!r}"
        )
    if isinstance(t, dict):
        kind = t.get("type")
        lt = t.get("logicalType")
        if lt in ("timestamp-millis", "local-timestamp-millis"):
            return DataType.TIMESTAMP_MS, ()
        if kind == "record":
            if t["name"] in in_progress:
                return DataType.STRUCT, ()  # back-reference (see docstring)
            inner = in_progress | {t["name"]}
            children = tuple(
                _avro_field(n, ft, nb, inner) for n, ft, nb in t["_fields"]
            )
            return DataType.STRUCT, children
        if kind == "array":
            item_dtype, item_children = _avro_type_to_dtype(
                t["items"], in_progress
            )
            return DataType.LIST, (
                Field("item", item_dtype, True, children=item_children),
            )
        if kind == "map":
            # dynamic string keys: host-only dict column (engine has no MAP
            # dtype; DataFusion maps these to Map<utf8, T> — our STRUCT with
            # no declared children is the object-column equivalent)
            return DataType.STRUCT, ()
        if kind == "enum":
            return DataType.STRING, ()
        if kind == "fixed":
            return DataType.STRING, ()
        t = kind
    if t in _PRIMITIVE:
        return _PRIMITIVE[t], ()
    raise FormatError(f"unsupported Avro type {t!r}")


# -- binary primitives (Avro spec §binary encoding) -----------------------


def _zigzag_encode(n: int) -> bytes:
    z = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_decode(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        raw = buf.read(1)
        if not raw:
            raise FormatError("truncated Avro varint")
        b = raw[0]
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _read_exact(buf: io.BytesIO, n: int, what: str) -> bytes:
    raw = buf.read(n)
    if len(raw) != n:
        raise FormatError(f"truncated Avro {what}")
    return raw


# -- encoding (tests / sink path) -----------------------------------------


def _union_branch_for(t: list, v) -> int:
    """Pick the union branch to encode ``v`` under (test encoder heuristic:
    null → the null branch, else the first non-null branch)."""
    if v is None:
        for i, b in enumerate(t):
            if b == "null":
                return i
        raise FormatError("null value but union has no null branch")
    for i, b in enumerate(t):
        if b != "null":
            return i
    raise FormatError(f"union {t!r} has no non-null branch")


def encode_value(t, nullable: bool, v, out: bytearray) -> None:
    if isinstance(t, list):  # general union (branch order preserved)
        idx = _union_branch_for(t, v)
        out += _zigzag_encode(idx)
        if t[idx] == "null":
            return
        encode_value(t[idx], False, v, out)
        return
    if nullable:
        if v is None:
            out += _zigzag_encode(0)  # union branch 0 = null
            return
        out += _zigzag_encode(1)
    if v is None:
        raise FormatError("null value for non-nullable Avro field")
    if isinstance(t, dict):
        kind = t.get("type")
        if kind == "record":
            for n, ft, nb in t["_fields"]:
                encode_value(ft, nb, (v or {}).get(n), out)
            return
        if kind == "array":
            items = list(v)
            if items:
                out += _zigzag_encode(len(items))
                for item in items:
                    encode_value(t["items"], False, item, out)
            out += _zigzag_encode(0)
            return
        if kind == "map":
            entries = dict(v)
            if entries:
                out += _zigzag_encode(len(entries))
                for k, mv in entries.items():
                    raw = str(k).encode()
                    out += _zigzag_encode(len(raw))
                    out += raw
                    encode_value(t["values"], False, mv, out)
            out += _zigzag_encode(0)
            return
        if kind == "enum":
            try:
                out += _zigzag_encode(t["symbols"].index(v))
            except ValueError:
                raise FormatError(
                    f"value {v!r} not in enum symbols {t['symbols']}"
                ) from None
            return
        if kind == "fixed":
            raw = bytes(v)
            if len(raw) != t["size"]:
                raise FormatError(
                    f"fixed value of {len(raw)} bytes != size {t['size']}"
                )
            out += raw
            return
        base = kind
    else:
        base = t
    if base == "boolean":
        out.append(1 if v else 0)
    elif base in ("int", "long"):
        out += _zigzag_encode(int(v))
    elif base == "float":
        out += struct.pack("<f", float(v))
    elif base == "double":
        out += struct.pack("<d", float(v))
    elif base in ("string", "bytes"):
        raw = v.encode() if isinstance(v, str) else bytes(v)
        out += _zigzag_encode(len(raw))
        out += raw
    elif base == "null":
        if v is not None:
            raise FormatError("non-null value for Avro null type")
    else:
        raise FormatError(f"unsupported Avro type {t!r}")


# -- decoding --------------------------------------------------------------


def _decode_blocks(buf: io.BytesIO, read_item, what: str):
    """Avro block-encoded sequence: series of counts, 0 terminates; a
    negative count is followed by a byte size (skippable block).

    Counts are capped against the bytes actually remaining in the payload:
    any item of >=1 wire byte makes count <= remaining for valid data, and
    zero-byte items (null / empty-record elements) are allowed a bounded
    slack — without the cap a 5-byte payload declaring 2^30 null items
    would allocate gigabytes off one malicious Kafka message.  The
    per-block cap alone is bypassable by REPEATED blocks of zero-byte
    items, so the record-level cumulative budget (``elem_budget`` on the
    buffer, set by :func:`decode_record`; same formula as the native
    parser) bounds total decoded elements per record too."""
    out = []
    while True:
        count = _zigzag_decode(buf)
        if count == 0:
            return out
        if count < 0:
            count = -count
            _zigzag_decode(buf)  # block byte size — we decode items anyway
        remaining = len(buf.getbuffer()) - buf.tell()
        if count > max(65536, 2 * (remaining + 1)):
            raise FormatError(
                f"Avro {what} block of {count} items exceeds payload "
                f"capacity ({remaining} bytes remain)"
            )
        budget = getattr(buf, "elem_budget", None)
        if budget is not None:
            budget -= count
            if budget < 0:
                raise FormatError(
                    f"Avro {what} blocks exceed the record's cumulative "
                    f"element budget (zero-byte-item bomb)"
                )
            buf.elem_budget = budget
        for _ in range(count):
            out.append(read_item())


def decode_value(t, nullable: bool, buf: io.BytesIO):
    if isinstance(t, list):  # general union: branch by index
        branch = _zigzag_decode(buf)
        if not 0 <= branch < len(t):
            raise FormatError(
                f"invalid union branch {branch} for {len(t)}-branch union"
            )
        b = t[branch]
        if b == "null":
            return None
        return decode_value(b, False, buf)
    if nullable:
        branch = _zigzag_decode(buf)
        if branch == 0:
            return None
        if branch != 1:
            raise FormatError(
                f"invalid union branch {branch} (only ['null', T])"
            )
    if isinstance(t, dict):
        kind = t.get("type")
        if kind == "record":
            return {
                n: decode_value(ft, nb, buf) for n, ft, nb in t["_fields"]
            }
        if kind == "array":
            return _decode_blocks(
                buf, lambda: decode_value(t["items"], False, buf), "array"
            )
        if kind == "map":
            def _entry():
                klen = _zigzag_decode(buf)
                if klen < 0:
                    raise FormatError("negative Avro map-key length")
                k = _read_exact(buf, klen, "map key").decode(errors="replace")
                return k, decode_value(t["values"], False, buf)

            return dict(_decode_blocks(buf, _entry, "map"))
        if kind == "enum":
            idx = _zigzag_decode(buf)
            symbols = t["symbols"]
            if not 0 <= idx < len(symbols):
                raise FormatError(
                    f"Avro enum index {idx} out of range ({len(symbols)})"
                )
            return symbols[idx]
        if kind == "fixed":
            return _read_exact(buf, t["size"], "fixed")
        base = kind
    else:
        base = t
    if base == "boolean":
        return _read_exact(buf, 1, "boolean") == b"\x01"
    if base in ("int", "long"):
        return _zigzag_decode(buf)
    if base == "float":
        return struct.unpack("<f", _read_exact(buf, 4, "float"))[0]
    if base == "double":
        return struct.unpack("<d", _read_exact(buf, 8, "double"))[0]
    if base in ("string", "bytes"):
        n = _zigzag_decode(buf)
        if n < 0:
            raise FormatError("negative Avro string length")
        raw = _read_exact(buf, n, "string")
        # errors='replace' matches the native parser: invalid UTF-8 becomes
        # U+FFFD rather than an exception class the reader's per-record
        # salvage doesn't catch
        return raw.decode(errors="replace") if base == "string" else raw
    if base == "null":
        return None
    raise FormatError(f"unsupported Avro type {t!r}")


def encode_record(schema: AvroSchema, record: dict) -> bytes:
    out = bytearray()
    for name, t, nullable in schema.fields:
        encode_value(t, nullable, record.get(name), out)
    return bytes(out)


class _RecordBuf(io.BytesIO):
    """BytesIO + the record-level cumulative element budget slot (builtin
    BytesIO rejects attribute assignment)."""

    elem_budget: int = 0


def decode_record(schema: AvroSchema, payload: bytes) -> dict:
    buf = _RecordBuf(payload)
    # same cumulative bound as the native parser (avro_parser.cpp
    # ap_parse): decoded array elements per record <= max(64Ki, 4x wire
    # bytes) — callers that build a plain BytesIO (tests, direct
    # decode_value use) simply skip the cumulative check
    buf.elem_budget = max(65536, 4 * len(payload))
    out = {
        name: decode_value(t, nullable, buf)
        for name, t, nullable in schema.fields
    }
    if buf.read(1):
        # same contract as the native parser: trailing bytes after the last
        # field mean a corrupt record or a mismatched schema
        raise FormatError("trailing bytes after Avro record")
    return out


class AvroDecoder(Decoder):
    """Buffer Avro-encoded records; flush one batch.

    Decode is native (C++ one-pass columnar, avro_parser.cpp — mirroring
    the reference's Rust-native path) for flat records AND nested
    records/arrays via the schema-tree ABI; the shapes the native walker
    declines (maps, enums, fixed, bytes fields, general unions, recursive
    named types) route to the recursive pure-Python decoder, which is
    also the no-compiler fallback and the differential-test oracle.
    ``decode_fallback_rows`` counts the rows that actually decoded on the
    Python path, so a schema silently routed there is observable in
    source metrics."""

    def __init__(self, schema: Schema | None, avro_schema, use_native=True):
        if avro_schema is None:
            raise FormatError("Avro decoding requires an Avro schema")
        if not isinstance(avro_schema, AvroSchema):
            avro_schema = parse_avro_schema(avro_schema)
        self.avro_schema = avro_schema
        self.schema = schema or avro_schema.to_engine_schema()
        self._rows: list[bytes] = []
        self._native = None
        self.decode_fallback_rows = 0
        if use_native:
            try:
                from denormalized_tpu_torch.formats.native_avro import (
                    NativeAvroParser,
                )

                self._native = NativeAvroParser(avro_schema, self.schema)
            except Exception as e:  # dnzlint: allow(broad-except) pure-Python decode is the designed fallback (no compiler / unsupported schema shape); the downgrade is logged once and counted in decode_fallback_rows, and test_native_build_gate fails images where the build should work
                _warn_native_unavailable("Avro", e)
                self._native = None

    def push(self, payload: bytes) -> None:
        if payload:
            self._rows.append(payload)

    def flush(self) -> RecordBatch:
        rows, self._rows = self._rows, []
        if self._native is not None:
            return self._native.parse(rows)
        self.decode_fallback_rows += len(rows)
        objs = [decode_record(self.avro_schema, r) for r in rows]
        return rows_to_batch(objs, self.schema)
