"""The port's JSON formats (``denormalized_tpu_torch/formats/``) against the
JAX package's: the JSON cases of tests/test_formats.py (flat and nested
decode on the native and Python paths, invalid payloads, schema
inference, the row encoder) and tests/test_decode_differential.py's seeded
fuzz (its own generator), each payload decoded by the port on both paths
and by the JAX package, with equal batches (values and masks) or the same
failure.  Avro's twins are in tests/test_torch_avro.py."""

import json
import math

import numpy as np
import pytest

import test_decode_differential as tdd
from denormalized_tpu.common.errors import FormatError as JFormatError
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.formats.json_codec import JsonDecoder as JDecoder
from denormalized_tpu.formats.json_codec import JsonRowEncoder as JEncoder
from denormalized_tpu.formats.json_codec import (
    infer_schema_from_json as j_infer,
)
import denormalized_tpu_torch as tt
from denormalized_tpu_torch.common import columns as tcols
from denormalized_tpu_torch.common.errors import (
    FormatError,
    PlanError,
    SourceError,
)
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.formats import StreamEncoding, make_decoder
from denormalized_tpu_torch.formats.json_codec import (
    JsonDecoder,
    JsonRowEncoder,
    infer_schema_from_json,
)
from denormalized_tpu_torch.formats.native_json import NativeJsonParser


def to_port_field(f) -> Field:
    return Field(f.name, DataType(f.dtype.value), f.nullable,
                 tuple(to_port_field(c) for c in f.children))


def to_port_schema(js: JSchema) -> Schema:
    return Schema([to_port_field(f) for f in js])


def _canon(v):
    """Comparable form of a decoded value: NaN as a marker, nested values
    recursed."""
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_canon(x) for x in v]
    return v


def _batch_view(b):
    return {
        f.name: (
            [_canon(v) for v in tcols.as_numpy(c).tolist()],
            None if m is None else np.asarray(m, bool).tolist(),
        )
        for f, c, m in zip(b.schema, b.columns, b.masks)
    }


def _jflat() -> JSchema:
    """FLAT in the JAX package's schema classes."""
    from denormalized_tpu.common.schema import DataType as JD
    from denormalized_tpu.common.schema import Field as JF

    return JSchema([JF(f.name, JD(f.dtype.value), f.nullable) for f in FLAT])


def _decode(dec, rows):
    try:
        for r in rows:
            dec.push(r)
        return _batch_view(dec.flush()), None
    except (FormatError, JFormatError) as e:
        return None, type(e).__name__


def _all_paths(jschema, rows):
    """(port native, port python, jax native) results of one decode."""
    tschema = to_port_schema(jschema)
    nat = JsonDecoder(tschema, use_native=True)
    assert isinstance(nat._native, NativeJsonParser), "native parser missing"
    return (
        _decode(nat, rows),
        _decode(JsonDecoder(tschema, use_native=False), rows),
        _decode(JDecoder(jschema, use_native=True), rows),
    )


FLAT = Schema([
    Field("occurred_at_ms", DataType.INT64, nullable=False),
    Field("sensor_name", DataType.STRING, nullable=False),
    Field("reading", DataType.FLOAT64),
    Field("flag", DataType.BOOL),
])
RIDE = json.dumps({
    "driver_id": "abc", "occurred_at_ms": 1,
    "imu_measurement": {"timestamp_ms": 2,
                        "gps": {"latitude": 1.1, "longitude": 2.2}},
    "tags": ["a", "b"], "trips": [{"id": 1, "km": 2.5}],
})

CASES = {
    "flat_roundtrip": ("flat", [
        b'{"occurred_at_ms": 123, "sensor_name": "a", "reading": 1.5, "flag": true}',
        b'{"occurred_at_ms": 124, "sensor_name": "b\\u00e9ta", "reading": null, "flag": false}',
        b'{"sensor_name": "c", "occurred_at_ms": 125, "reading": -2e3, "flag": true, "extra": {"x": 1}}',
    ]),
    "flat_many": ("flat", [json.dumps({
        "occurred_at_ms": i, "sensor_name": f"s{i % 7}",
        "reading": i * 0.5 if i % 3 else None, "flag": bool(i % 2),
    }).encode() for i in range(200)]),
    "flat_invalid": ("flat", [b'{"occurred_at_ms": not-json}']),
    "flat_non_object": ("flat", [b'[1, 2, 3]']),
    "flat_missing_and_unknown_keys": ("flat", [
        b'{"occurred_at_ms": 1}', b'{"zz": 1, "sensor_name": "q"}',
        b'{"occurred_at_ms": 3, "sensor_name": "r", "yy": [1, {"a": 2}]}',
    ]),
    "flat_extremes": ("flat", [
        b'{"occurred_at_ms": 9223372036854775807, "reading": 1e308}',
        b'{"occurred_at_ms": -9223372036854775808, "reading": -1e-320}',
        b'{"occurred_at_ms": 99999999999999999999, "reading": 5}',
        b'{"occurred_at_ms": 1.5e3, "reading": 0}',
    ]),
    "flat_surrogates": ("flat", [
        b'{"sensor_name": "\\ud83d\\ude00 x", "occurred_at_ms": 1}',
        b'{"sensor_name": "dup", "sensor_name": "second", "occurred_at_ms": 2}',
    ]),
    "nested_rideshare": ("ride", [RIDE.encode(), json.dumps({
        "driver_id": None, "occurred_at_ms": 5, "imu_measurement": None,
        "tags": [], "trips": [{"id": 2}, {"km": 1.0}],
    }).encode()]),
    "nested_invalid": ("ride", [b'{"imu_measurement": {"gps": [1, 2]}}']),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_json_cases_match_the_jax_package(case):
    which, rows = CASES[case]
    jschema = j_infer(RIDE) if which == "ride" else _jflat()
    (nat, enat), (py, epy), (jax, ejax) = _all_paths(jschema, rows)
    assert enat == epy == ejax, (enat, epy, ejax)
    assert nat == py == jax
    if case == "flat_roundtrip":
        assert nat["sensor_name"] == (["a", "béta", "c"], None)
        assert nat["reading"][1] == [True, False, True]
    if case.endswith("invalid") or case == "flat_non_object":
        assert enat == "FormatError"


def test_parser_string_columns_are_columnar():
    dec = JsonDecoder(FLAT)
    dec.push(b'{"occurred_at_ms": 1, "sensor_name": "a", "reading": 2}')
    b = dec.flush()
    assert isinstance(b.column("sensor_name"), tcols.StringColumn)
    assert dec.decode_fallback_rows == 0
    dec = JsonDecoder(to_port_schema(j_infer(RIDE)))
    dec.push(RIDE.encode())
    b = dec.flush()
    assert isinstance(b.column("imu_measurement"), tcols.NestedColumn)
    assert isinstance(b.column("driver_id"), tcols.StringColumn)


def test_schema_inference_matches_the_jax_package():
    def shape(s):
        return [(f.name, f.dtype.value, shape(f.children)) for f in s]

    assert shape(infer_schema_from_json(RIDE)) == shape(j_infer(RIDE))
    with pytest.raises(FormatError):
        infer_schema_from_json("[1]")


def test_row_encoder_matches_the_jax_package():
    from denormalized_tpu.common.record_batch import RecordBatch as JRB

    cols = [np.array([1, 2], dtype=np.int64), np.array(["x", "y"], dtype=object),
            np.array([0.5, 0.0]), np.array([True, False])]
    masks = [None, None, np.array([True, False]), None]
    want = JEncoder().encode(JRB(_jflat(), cols, masks))
    got = JsonRowEncoder().encode(RecordBatch(FLAT, cols, masks))
    assert got == want
    # a columnar string column encodes to the same bytes
    sc = tcols.StringColumn.from_objects(cols[1])
    assert JsonRowEncoder().encode(
        RecordBatch(FLAT, [cols[0], sc, cols[2], cols[3]], masks)) == want
    assert json.loads(got[1])["reading"] is None


@pytest.mark.parametrize("seed", range(24))
def test_differential_json_decode(seed):
    """tests/test_decode_differential.py's per-row fuzz, each row through
    the port's native and Python paths and the JAX package."""
    rng = np.random.default_rng(1000 + seed)
    schema = tdd._rand_schema(rng)
    for _ in range(60):
        row = [tdd._row_json(rng, schema)]
        (nat, enat), (py, epy), (jax, ejax) = _all_paths(schema, row)
        assert enat == epy == ejax, (seed, row, enat, epy, ejax)
        assert nat == py == jax, (seed, row)


@pytest.mark.parametrize("seed", range(8))
def test_differential_json_decode_batched(seed):
    rng = np.random.default_rng(2000 + seed)
    schema = tdd._rand_schema(rng)
    proto = tdd._row_json(rng, schema)
    rows = [proto] * 8 + [tdd._row_json(rng, schema) for _ in range(40)]
    good = [r for r in rows
            if _decode(JDecoder(schema, use_native=False), [r])[1] is None]
    (nat, enat), (py, epy), (jax, ejax) = _all_paths(schema, good)
    assert enat is None and epy is None and ejax is None
    assert nat == py == jax


def test_avro_raises_naming_its_roadmap_item():
    """Avro is ported: what raises now are the JAX package's argument
    checks (no Avro schema, a schema= beside avro_schema=, avro_schema=
    with another encoding), with the JAX package's error types.  (The
    name dates from when the port refused Avro naming its ROADMAP item;
    it is kept so that the test stays one test across that change.)"""
    assert StreamEncoding.from_str("AVRO") is StreamEncoding.AVRO
    with pytest.raises(FormatError, match="requires an Avro schema"):
        make_decoder(StreamEncoding.AVRO, FLAT)
    with pytest.raises(FormatError):
        StreamEncoding.from_str("csv")
    ctx = tt.Context(tt.EngineConfig(device="cpu"))
    with pytest.raises(SourceError, match="needs topic and schema"):
        ctx.from_topic("t", encoding="avro", bootstrap_servers="localhost:1")
    with pytest.raises(PlanError, match="conflicts with encoding"):
        ctx.from_topic("t", avro_schema={"type": "record", "name": "x",
                                         "fields": []},
                       bootstrap_servers="localhost:1")
    with pytest.raises(PlanError, match="not both"):
        ctx.from_topic("t", encoding="avro", schema=FLAT,
                       avro_schema={"type": "record", "name": "x",
                                    "fields": []},
                       bootstrap_servers="localhost:1")
