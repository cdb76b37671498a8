"""JSON payloads ⇄ columnar batches.

Covers three reference components:
- ``JsonDecoder`` (formats/decoders/json.rs:11-49): buffer payload bytes,
  flush one batch against a target schema;
- JSON schema inference (utils/arrow_helpers.rs:283
  ``infer_arrow_schema_from_json_value`` — nested structs/lists recursed);
- ``JsonRowEncoder`` (utils/row_encoder.rs:5-44): batch → per-row JSON
  byte payloads for sinks.

The decode hot path uses the native C++ columnar parser
(:mod:`denormalized_tpu_torch.formats.native_json`) — flat schemas AND nested
ones (structs to any depth, lists of scalars, lists of structs, lists of
lists) via the shredded node-tree ABI.  Python ``json`` remains only for
dynamic-map structs (no declared children), the one shape with no static
shredding.

Both paths normalize nested struct values to the DECLARED schema shape
(missing children become None, undeclared keys are dropped) — the same
semantics the reference gets from arrow-json's schema-driven reader, and
a precondition for the two decode paths staying bit-identical.
"""

from __future__ import annotations

import json
import math

import numpy as np

from denormalized_tpu_torch.common.errors import FormatError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.formats import Decoder, _warn_native_unavailable


# -- schema inference ----------------------------------------------------


def infer_field(name: str, value) -> Field:
    if isinstance(value, bool):
        return Field(name, DataType.BOOL)
    if isinstance(value, int):
        return Field(name, DataType.INT64)
    if isinstance(value, float):
        return Field(name, DataType.FLOAT64)
    if isinstance(value, str):
        return Field(name, DataType.STRING)
    if value is None:
        return Field(name, DataType.STRING)
    if isinstance(value, dict):
        children = tuple(infer_field(k, v) for k, v in value.items())
        return Field(name, DataType.STRUCT, children=children)
    if isinstance(value, list):
        child = (
            infer_field("item", value[0]) if value else Field("item", DataType.STRING)
        )
        return Field(name, DataType.LIST, children=(child,))
    raise FormatError(f"cannot infer type for {name}={value!r}")


def infer_schema_from_json(sample: str | bytes) -> Schema:
    """Schema from one sample JSON object (the from_topic sample_json path,
    py-denormalized/src/context.rs:64-83)."""
    obj = json.loads(sample)
    if not isinstance(obj, dict):
        raise FormatError("sample JSON must be an object")
    return Schema([infer_field(k, v) for k, v in obj.items()])


# -- decoding ------------------------------------------------------------


class JsonDecoder(Decoder):
    """``decode_fallback_rows`` counts rows that decoded on the Python
    path (native parser unavailable or schema declined) — surfaced
    through source ``metrics()`` so a schema that silently routes to the
    ~30x-slower fallback is observable, never a quiet perf cliff."""

    def __init__(self, schema: Schema, use_native: bool = True):
        self.schema = schema
        self._rows: list[bytes] = []
        self._native = None
        self.decode_fallback_rows = 0
        if use_native:
            try:
                from denormalized_tpu_torch.formats.native_json import NativeJsonParser

                self._native = NativeJsonParser(schema)
            except Exception as e:  # dnzlint: allow(broad-except) pure-Python decode is the designed fallback (no compiler / unsupported schema shape); the downgrade is logged once and counted in decode_fallback_rows, and test_native_build_gate fails images where the build should work
                _warn_native_unavailable("JSON", e)
                self._native = None

    def push(self, payload: bytes) -> None:
        if payload:
            self._rows.append(payload)

    def flush(self) -> RecordBatch:
        rows, self._rows = self._rows, []
        if self._native is not None:
            return self._native.parse(rows)
        self.decode_fallback_rows += len(rows)
        return decode_json_rows(rows, self.schema)


_LEAF_PYTYPES = {
    DataType.INT32: (int,),
    DataType.INT64: (int,),
    DataType.TIMESTAMP_MS: (int,),
    DataType.FLOAT32: (int, float),
    DataType.FLOAT64: (int, float),
    DataType.BOOL: (bool,),
    # bytes: the avro decoder represents avro "bytes" values as python
    # bytes in STRING columns and shares rows_to_batch; json.loads can
    # never produce bytes, so this does not loosen the JSON path
    DataType.STRING: (str, bytes),
}


def _normalize_nested(v, f: Field):
    """Reshape a decoded nested value to the DECLARED field shape: struct
    values keep exactly the schema's children (missing → None, undeclared
    keys dropped), recursively; type-mismatched values (an int where a
    struct is declared, a bool on an int leaf) raise FormatError.  Structs
    with no declared children (dynamic maps) and lists with no declared
    element pass through as-is.  This is exactly what the native shredded
    parser produces — schema-strict like the reference's arrow-json
    reader (decoders/json.rs:11-49) — so downstream code (field access,
    sinks, checkpoints) sees one shape and one failure mode regardless of
    which decode path ran."""
    if v is None:
        return None
    if f.dtype is DataType.STRUCT and f.children:
        if not isinstance(v, dict):
            raise FormatError(
                f"field {f.name!r}: expected an object, got {v!r}"
            )
        return {
            c.name: _normalize_nested(v.get(c.name), c) for c in f.children
        }
    if f.dtype is DataType.LIST and len(f.children) == 1:
        if not isinstance(v, list):
            raise FormatError(
                f"field {f.name!r}: expected an array, got {v!r}"
            )
        c = f.children[0]
        return [_normalize_nested(x, c) for x in v]
    want = _LEAF_PYTYPES.get(f.dtype)
    if want is not None and (
        not isinstance(v, want)
        or (bool not in want and isinstance(v, bool))
    ):
        raise FormatError(
            f"field {f.name!r}: cannot coerce {v!r} to {f.dtype.value}"
        )
    if f.dtype in (DataType.FLOAT32, DataType.FLOAT64):
        # int-typed JSON on a float leaf: the native parser always
        # materializes float — match it, or sink/checkpoint bytes would
        # differ by decode path ('3' vs '3.0')
        return _to_float(v)
    if f.dtype is DataType.INT32:
        # nested leaves live in object columns (no numpy narrowing), so
        # the declared i32 width is enforced here — the same clamp the
        # native extraction applies (_native_parser_base._clamp_nested_ints),
        # and the same bounds flat INT32 columns saturate at
        return _saturate_int(v, _I32_MIN, _I32_MAX)
    if f.dtype in (DataType.INT64, DataType.TIMESTAMP_MS):
        # out-of-int64-range: the native parser keeps strtoll's saturate
        # semantics (json.loads accepts 20-digit ints, so refusing would
        # fail the batch); clamp identically here
        return _saturate_int(v, _I64_MIN, _I64_MAX)
    return v


_I64_MIN, _I64_MAX = -0x8000000000000000, 0x7FFFFFFFFFFFFFFF
_I32_MIN, _I32_MAX = -0x80000000, 0x7FFFFFFF


def _saturate_int(v: int, lo: int, hi: int) -> int:
    """strtoll-style saturation shared by both decode paths (the native
    parser clamps at parse for i64 and at extraction for narrower
    columns; the Python path must clamp identically or the same producer
    stream fails on one host and succeeds on another)."""
    return hi if v > hi else lo if v < lo else v


def _to_float(v) -> float:
    """int/float → float with strtod's overflow semantics: a JSON int too
    large for a double becomes ±inf (the native path's result), never an
    OverflowError escaping the codec's error contract."""
    try:
        return float(v)
    except OverflowError:
        return float("inf") if v > 0 else float("-inf")


def _null_of(dtype: DataType):
    # values behind an invalid mask are unspecified; use 0 (same convention
    # as the native parser) so both decode paths are bit-identical
    return {
        DataType.INT32: 0,
        DataType.INT64: 0,
        DataType.TIMESTAMP_MS: 0,
        DataType.FLOAT32: 0.0,
        DataType.FLOAT64: 0.0,
        DataType.BOOL: False,
    }.get(dtype)


def decode_json_rows(rows: list[bytes], schema: Schema) -> RecordBatch:
    """Pure-Python decode path (nested schemas / fallback)."""
    objs = []
    for r in rows:
        try:
            objs.append(json.loads(r))
        except json.JSONDecodeError as e:
            raise FormatError(f"invalid JSON payload: {e}") from None
    return rows_to_batch(objs, schema)


def rows_to_batch(objs: list[dict], schema: Schema) -> RecordBatch:
    for i, o in enumerate(objs):
        if not isinstance(o, dict):
            raise FormatError(
                f"row {i}: expected a JSON object, got {type(o).__name__}"
            )
    n = len(objs)
    cols, masks = [], []
    for f in schema:
        if f.dtype in (DataType.STRUCT, DataType.LIST, DataType.STRING):
            col = np.empty(n, dtype=object)
            mask = np.ones(n, dtype=bool)
            for i, o in enumerate(objs):
                v = o.get(f.name)
                if v is None:
                    mask[i] = False
                col[i] = _normalize_nested(v, f)
            cols.append(col)
            masks.append(None if mask.all() else mask)
            continue
        npdt = f.dtype.to_numpy()
        col = np.zeros(n, dtype=npdt)
        mask = np.ones(n, dtype=bool)
        null = _null_of(f.dtype)
        want = _LEAF_PYTYPES.get(f.dtype)
        # integer columns saturate wide JSON ints at the DECLARED width,
        # matching the native path (strtoll i64 saturation at parse, clip
        # at narrowing extraction) — numpy assignment alone would raise
        # (int64) or wrap (int32)
        info = np.iinfo(npdt) if npdt.kind == "i" else None
        # f32 columns: out-of-range doubles overflow to +-inf on
        # assignment — same result as the native path's narrowing cast;
        # the RuntimeWarning is expected, not actionable
        with np.errstate(over="ignore"):
            for i, o in enumerate(objs):
                v = o.get(f.name)
                if v is None:
                    mask[i] = False
                    col[i] = null
                    continue
                # same leaf strictness as the native parser and the nested
                # normalizer: a float or bool on an int column (or non-bool
                # on a bool column) fails the batch on BOTH paths — numpy's
                # unsafe-cast assignment would otherwise truncate 1.5 -> 1
                # only on hosts without the native lib
                if want is not None and (
                    not isinstance(v, want)
                    or (bool not in want and isinstance(v, bool))
                ):
                    raise FormatError(
                        f"field {f.name!r}: cannot coerce {v!r} to "
                        f"{f.dtype.value}"
                    )
                if info is not None:
                    v = _saturate_int(v, int(info.min), int(info.max))
                elif npdt.kind == "f" and isinstance(v, int):
                    # ints beyond double range saturate to +-inf like the
                    # native path's strtod overflow
                    v = _to_float(v)
                try:
                    col[i] = v
                except (TypeError, ValueError, OverflowError):
                    # 1e200 into f32 is fine (inf); exotic objects are not
                    raise FormatError(
                        f"field {f.name!r}: cannot coerce {v!r} to "
                        f"{f.dtype.value}"
                    ) from None
        cols.append(col)
        masks.append(None if mask.all() else mask)
    return RecordBatch(schema, cols, masks)


# -- encoding (sink side) ------------------------------------------------


class JsonRowEncoder:
    """RecordBatch → per-row JSON byte payloads (utils/row_encoder.rs).

    Column-major preparation: each column converts to a plain-Python value
    list ONCE (``tolist`` is one C call; NaN→None and mask→None patch in
    bulk), then rows assemble by zipping the prepared lists — the per-row
    work is exactly one dict build + ``json.dumps``, with no per-row column
    lookups, mask probes, or numpy-scalar unboxing.  Measurable on
    high-fanout kafka sink emission."""

    def encode(self, batch: RecordBatch) -> list[bytes]:
        user = batch.select(batch.schema.without_internal().names)
        names = user.schema.names
        pycols: list[list] = []
        for j in range(len(names)):
            c = user.columns[j]
            kind = getattr(c.dtype, "kind", "O")
            if c.dtype == object:
                vals = [_jsonify(v) for v in c.tolist()]
            elif kind == "f":
                vals = c.tolist()
                if np.isnan(c).any():
                    vals = [None if v != v else v for v in vals]
            else:
                # int/bool tolist() already yields native Python scalars
                vals = c.tolist()
            m = user.masks[j]
            if m is not None:
                vals = [
                    v if ok else None for v, ok in zip(vals, m.tolist())
                ]
            pycols.append(vals)
        dumps = json.dumps
        return [
            dumps(dict(zip(names, row))).encode()
            for row in zip(*pycols)
        ] if pycols else [b"{}"] * user.num_rows


def _jsonify(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        f = float(v)
        return None if math.isnan(f) else f
    if isinstance(v, np.bool_):
        return bool(v)
    return v
