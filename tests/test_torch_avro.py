"""The port's Avro formats (``denormalized_tpu_torch/formats/avro_codec.py``,
``formats/native_avro.py`` over ``native/avro_parser.cpp``) against the JAX
package's: the Avro twins of tests/test_formats.py, of
tests/test_decode_differential.py's two Avro fuzzers and of
tests/test_kafka.py's two Avro topic pipelines (over the port's mock
broker), each payload decoded by the port on its native and Python paths
and by the JAX package on its own, with equal columns: strings, validity
and integers exact, floats bit for bit (a decode adds no arithmetic).
Also chip_smoke.py's numpy Avro encoder against ``encode_record``, byte
for byte."""

import io
import struct
import threading
import time

import numpy as np
import pytest

import test_decode_differential as tdd
from denormalized_tpu.common import columns as jcols
from denormalized_tpu.common.errors import FormatError as JFormatError
from denormalized_tpu.formats import avro_codec as jac
import denormalized_tpu_torch as tt
from denormalized_tpu_torch.api import functions as F
from denormalized_tpu_torch.common import columns as tcols
from denormalized_tpu_torch.common.constants import WINDOW_START_COLUMN
from denormalized_tpu_torch.common.errors import FormatError
from denormalized_tpu_torch.common.schema import DataType
from denormalized_tpu_torch.formats import avro_codec as tac
from denormalized_tpu_torch.formats.native_avro import NativeAvroParser
from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker


def _canon(v):
    """Comparable form of one decoded value: a float as its 8 bytes (bit
    for bit: -0.0, NaN and inf kept apart), nested values recursed."""
    if isinstance(v, (float, np.floating)):
        return ("f", struct.pack("<d", float(v)).hex())
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _view(batch, as_numpy):
    """{column: (values, validity)} of a decoded batch; values masked out
    by the validity are left out (the packages may fill them apart)."""
    out = {}
    for f, c, m in zip(batch.schema, batch.columns, batch.masks):
        vals = as_numpy(c).tolist()
        valid = (np.ones(len(vals), bool) if m is None
                 else np.asarray(m, bool)).tolist()
        out[f.name] = ([_canon(v) if ok else None
                        for v, ok in zip(vals, valid)], valid)
    return out


def _decode(dec, payloads, as_numpy):
    try:
        for p in payloads:
            dec.push(p)
        return _view(dec.flush(), as_numpy), None
    except (FormatError, JFormatError) as e:
        return None, type(e).__name__


def _three_ways(decl, payloads, port_native=True):
    """(port native, port python, JAX) decodes of the same payloads; the
    JAX package takes its own default path."""
    tsch = tac.parse_avro_schema(decl)
    nat = tac.AvroDecoder(None, tsch, use_native=True)
    if port_native:
        assert isinstance(nat._native, NativeAvroParser), "native missing"
    return (
        _decode(nat, payloads, tcols.as_numpy),
        _decode(tac.AvroDecoder(None, tsch, use_native=False), payloads,
                tcols.as_numpy),
        _decode(jac.AvroDecoder(None, jac.parse_avro_schema(decl)),
                payloads, jcols.as_numpy),
    )


AVRO_DECL = {
    "type": "record",
    "name": "Measurement",
    "fields": [
        {"name": "occurred_at_ms",
         "type": {"type": "long", "logicalType": "timestamp-millis"}},
        {"name": "sensor_name", "type": "string"},
        {"name": "reading", "type": ["null", "double"]},
        {"name": "count", "type": "int"},
        {"name": "ok", "type": "boolean"},
    ],
}


def _encode(decl, records):
    """The records encoded by both packages' writers, which must agree."""
    ts, js = tac.parse_avro_schema(decl), jac.parse_avro_schema(decl)
    out = [tac.encode_record(ts, r) for r in records]
    assert out == [jac.encode_record(js, r) for r in records]
    return out


def test_avro_roundtrip():
    """Twin of tests/test_formats.py:156."""
    schema = tac.parse_avro_schema(AVRO_DECL)
    engine = schema.to_engine_schema()
    assert engine.field("occurred_at_ms").dtype is DataType.TIMESTAMP_MS
    assert engine.field("reading").dtype is DataType.FLOAT64
    assert [(f.name, f.dtype.value, f.nullable) for f in engine] == [
        (f.name, f.dtype.value, f.nullable)
        for f in jac.parse_avro_schema(AVRO_DECL).to_engine_schema()]
    records = [
        {"occurred_at_ms": 1000, "sensor_name": "a", "reading": 1.25,
         "count": -3, "ok": True},
        {"occurred_at_ms": 2000, "sensor_name": "日本語", "reading": None,
         "count": 7, "ok": False},
    ]
    payloads = _encode(AVRO_DECL, records)
    (nat, en), (py, ep), (jax, ej) = _three_ways(AVRO_DECL, payloads)
    assert en is None and ep is None and ej is None
    assert nat == py == jax
    assert nat["sensor_name"][0] == ["a", "日本語"]
    assert nat["count"][0] == [-3, 7]
    assert nat["ok"][0] == [True, False]
    assert nat["reading"][1] == [True, False]
    batch = tac.AvroDecoder(None, schema)
    for p in payloads:
        batch.push(p)
    b = batch.flush()
    assert isinstance(b.column("sensor_name"), tcols.StringColumn)


def test_avro_native_matches_python_decoder():
    """Twin of tests/test_formats.py:178: randomized flat records (nulls,
    unicode, zigzag extremes, float32 widening) through the port's native
    and Python paths and the JAX package, bit for bit."""
    decl = {
        "type": "record", "name": "R",
        "fields": [
            {"name": "ts",
             "type": {"type": "long", "logicalType": "timestamp-millis"}},
            {"name": "s", "type": "string"},
            {"name": "d", "type": ["null", "double"]},
            {"name": "f", "type": "float"},
            {"name": "nf", "type": ["null", "float"]},
            {"name": "i", "type": ["null", "int"]},
            {"name": "b", "type": "boolean"},
        ],
    }
    rng = np.random.default_rng(0)
    records = [{
        "ts": int(rng.integers(-(2**62), 2**62)),
        "s": ["", "héllo", "日本", "x" * int(rng.integers(0, 50))][i % 4],
        "d": None if i % 5 == 0 else float(rng.normal(0, 1e9)),
        "f": float(np.float32(rng.normal(0, 10))),
        "nf": None if i % 3 == 0 else float(np.float32(i)),
        "i": None if i % 7 == 0 else int(rng.integers(-(2**31), 2**31)),
        "b": bool(i % 2),
    } for i in range(300)]
    (nat, en), (py, ep), (jax, ej) = _three_ways(decl, _encode(decl, records))
    assert en is None and ep is None and ej is None
    assert nat == py == jax


@pytest.mark.parametrize("use_native", [True, False])
def test_avro_rejects_corrupt_records(use_native):
    """Twin of tests/test_formats.py:237: truncation and trailing garbage
    fail on both paths, as in the JAX package."""
    schema = tac.parse_avro_schema(AVRO_DECL)
    good = tac.encode_record(schema, {
        "occurred_at_ms": 1, "sensor_name": "a", "reading": 1.0,
        "count": 1, "ok": True})
    dec = tac.AvroDecoder(None, schema, use_native=use_native)
    jdec = jac.AvroDecoder(None, jac.parse_avro_schema(AVRO_DECL),
                           use_native=use_native)
    assert (dec._native is not None) == use_native
    for bad in (good[:-1], good + b"\x00", good[1:]):
        for d in (dec, jdec):
            d.push(bad)
            with pytest.raises((FormatError, JFormatError)):
                d.flush()


def test_avro_bytes_schema_uses_python_fallback():
    """Twin of tests/test_formats.py:254: a ``bytes`` field keeps the
    decode on the Python path and returns raw bytes."""
    decl = {"type": "record", "name": "B",
            "fields": [{"name": "p", "type": "bytes"},
                       {"name": "n", "type": "long"}]}
    s = tac.parse_avro_schema(decl)
    dec = tac.AvroDecoder(None, s)
    assert dec._native is None
    payloads = _encode(decl, [{"p": b"\x80\x81", "n": 5}])
    dec.push(payloads[0])
    b = dec.flush()
    assert b.column("p")[0] == b"\x80\x81"
    assert int(b.column("n")[0]) == 5
    (_, en), (py, ep), (jax, ej) = _three_ways(decl, payloads,
                                               port_native=False)
    assert ep is None and ej is None and py == jax
    assert dec.decode_fallback_rows == 1


def test_avro_union_null_second_branch_order_preserved():
    """Twin of tests/test_formats.py:283: ``['T', 'null']`` keeps branch 0
    for T on the wire."""
    decl = {"type": "record", "name": "R",
            "fields": [{"name": "x", "type": ["long", "null"]}]}
    sch = tac.parse_avro_schema(decl)
    assert sch.fields[0][2]
    assert tac.decode_record(sch, tac.encode_record(sch, {"x": 7}))["x"] == 7
    assert tac.decode_record(
        sch, tac.encode_record(sch, {"x": None}))["x"] is None
    assert _encode(decl, [{"x": 7}, {"x": None}]) == [b"\x00\x0e", b"\x02"]


NESTED_AVRO_DECL = {
    "type": "record",
    "name": "rides.Trip",
    "fields": [
        {"name": "occurred_at_ms",
         "type": {"type": "long", "logicalType": "timestamp-millis"}},
        {"name": "driver", "type": {
            "type": "record", "name": "Driver",
            "fields": [
                {"name": "id", "type": "string"},
                {"name": "location", "type": {
                    "type": "record", "name": "GeoPoint",
                    "fields": [
                        {"name": "lat", "type": "double"},
                        {"name": "lng", "type": "double"},
                    ]}},
            ]}},
        {"name": "destination", "type": ["null", "GeoPoint"]},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "fares", "type": {"type": "map", "values": "double"}},
        {"name": "status", "type": {
            "type": "enum", "name": "Status",
            "symbols": ["REQUESTED", "ACTIVE", "DONE"]}},
        {"name": "token", "type": {"type": "fixed", "name": "Tok", "size": 4}},
        {"name": "fare_or_note", "type": ["null", "double", "float"]},
    ],
}

NESTED_RECORDS = [
    {"occurred_at_ms": 1000,
     "driver": {"id": "d1", "location": {"lat": 37.77, "lng": -122.4}},
     "destination": {"lat": 40.7, "lng": -74.0}, "tags": ["airport", "pool"],
     "fares": {"base": 5.0, "tip": 1.5}, "status": "ACTIVE",
     "token": b"\x01\x02\x03\x04", "fare_or_note": 12.5},
    {"occurred_at_ms": 2000,
     "driver": {"id": "d2", "location": {"lat": 0.0, "lng": 0.0}},
     "destination": None, "tags": [], "fares": {}, "status": "DONE",
     "token": b"\xff\xff\xff\xff", "fare_or_note": None},
]


def test_avro_nested_roundtrip():
    """Twin of tests/test_formats.py:335: nested records, named refs,
    arrays, maps, enums, fixed and a 3-branch union; the engine schema,
    the record round trip and the (Python-path) batch equal the JAX
    package's."""
    schema = tac.parse_avro_schema(NESTED_AVRO_DECL)
    engine = schema.to_engine_schema()

    def shape(fields):
        return [(f.name, f.dtype.value, f.nullable, shape(f.children))
                for f in fields]

    assert shape(engine) == shape(
        jac.parse_avro_schema(NESTED_AVRO_DECL).to_engine_schema())
    assert engine.field("fare_or_note").dtype is DataType.FLOAT64
    payloads = _encode(NESTED_AVRO_DECL, NESTED_RECORDS)
    for r, p in zip(NESTED_RECORDS, payloads):
        assert tac.decode_record(schema, p) == r
    dec = tac.AvroDecoder(None, schema)
    assert dec._native is None
    (_, _), (py, ep), (jax, ej) = _three_ways(
        NESTED_AVRO_DECL, payloads, port_native=False)
    assert ep is None and ej is None and py == jax
    assert py["status"][0] == ["ACTIVE", "DONE"]
    assert py["destination"][1] == [True, False]


def test_avro_array_negative_block_count():
    """Twin of tests/test_formats.py:399."""
    decl = {"type": "record", "name": "R",
            "fields": [{"name": "xs", "type": {"type": "array",
                                               "items": "long"}}]}
    payload = b"".join(tac._zigzag_encode(v) for v in (-2, 2, 7, 9, 0))
    assert payload == b"".join(jac._zigzag_encode(v) for v in (-2, 2, 7, 9, 0))
    assert tac.decode_record(tac.parse_avro_schema(decl), payload)["xs"] == [
        7, 9]
    (nat, _), (py, _), (jax, _) = _three_ways(decl, [payload])
    assert nat == py == jax


def test_avro_recursive_named_type():
    """Twin of tests/test_formats.py:423: a self-referential record
    resolves, decodes and converts (the back-reference a childless
    STRUCT)."""
    decl = {"type": "record", "name": "Node",
            "fields": [{"name": "v", "type": "long"},
                       {"name": "next", "type": ["null", "Node"]}]}
    schema = tac.parse_avro_schema(decl)
    rec = {"v": 1, "next": {"v": 2, "next": {"v": 3, "next": None}}}
    payloads = _encode(decl, [rec])
    assert tac.decode_record(schema, payloads[0]) == rec
    nxt = schema.to_engine_schema().field("next")
    assert nxt.dtype is DataType.STRUCT
    assert [c.name for c in nxt.children] == ["v", "next"]
    assert nxt.children[1].children == ()
    (_, _), (py, ep), (jax, ej) = _three_ways(decl, payloads,
                                              port_native=False)
    assert ep is None and ej is None and py == jax


@pytest.mark.parametrize("decl", [
    {"type": "record", "name": "R", "fields": [{"name": "x", "type": [
        {"type": "record", "name": "A",
         "fields": [{"name": "a", "type": "long"}]},
        {"type": "record", "name": "B",
         "fields": [{"name": "b", "type": "string"}]}]}]},
    {"type": "record", "name": "R",
     "fields": [{"name": "x", "type": ["null", "string", "long"]}]},
], ids=["distinct_records", "mixed_dtypes"])
def test_avro_union_rejected(decl):
    """Twins of tests/test_formats.py:453 (two record branches) and :492
    (string and long branches): no single column type, in both
    packages."""
    with pytest.raises(FormatError, match="mixed"):
        tac.parse_avro_schema(decl).to_engine_schema()
    with pytest.raises(JFormatError, match="mixed"):
        jac.parse_avro_schema(decl).to_engine_schema()


def test_avro_block_count_bomb_rejected():
    """Twin of tests/test_formats.py:472."""
    decl = {"type": "record", "name": "R",
            "fields": [{"name": "xs", "type": {"type": "array",
                                               "items": "null"}}]}
    payload = tac._zigzag_encode(1 << 25) + tac._zigzag_encode(0)
    with pytest.raises(FormatError, match="capacity"):
        tac.decode_record(tac.parse_avro_schema(decl), payload)
    with pytest.raises(JFormatError, match="capacity"):
        jac.decode_record(jac.parse_avro_schema(decl), payload)


@pytest.mark.parametrize("v", [0, 1, -1, 63, -64, 2**40, -(2**40), 2**62,
                               -(2**62), 2**63 - 1, -(2**63)])
def test_avro_zigzag_extremes(v):
    """Twin of tests/test_formats.py:506: the same bytes as the JAX
    package's, decoded back."""
    enc = tac._zigzag_encode(v)
    assert enc == jac._zigzag_encode(v)
    assert tac._zigzag_decode(io.BytesIO(enc)) == v


def test_avro_truncated_raises_format_error():
    """Twin of tests/test_formats.py:547."""
    schema = tac.parse_avro_schema(AVRO_DECL)
    full = tac.encode_record(schema, {
        "occurred_at_ms": 1, "sensor_name": "a", "reading": 1.0,
        "count": 1, "ok": True})
    for cut in (1, len(full) // 2, len(full) - 1):
        with pytest.raises(FormatError):
            tac.decode_record(schema, full[:cut])


def test_avro_zero_byte_item_bomb_rejected_both_paths():
    """Twin of tests/test_formats.py:1141: the cumulative element budget on
    both paths; a small array of empty records stays legal."""
    decl = {"type": "record", "name": "B", "fields": [
        {"name": "xs", "type": {"type": "array", "items": {
            "type": "record", "name": "E", "fields": []}}}]}
    sch = tac.parse_avro_schema(decl)
    bomb = b"".join([tac._zigzag_encode(65536)] * 200) + tac._zigzag_encode(0)
    legal = tac._zigzag_encode(3) + tac._zigzag_encode(0)
    for use_native in (True, False):
        dec = tac.AvroDecoder(None, sch, use_native=use_native)
        assert (dec._native is not None) == use_native
        dec.push(bomb)
        with pytest.raises(FormatError):
            dec.flush()
        dec.push(legal)
        col = tcols.as_numpy(dec.flush().column("xs"))
        assert col.tolist() == [[{}, {}, {}]], use_native


# -- the differential fuzzers (tests/test_decode_differential.py) ---------


@pytest.mark.parametrize("seed", range(8))
def test_differential_avro_decode(seed):
    """Twin of tests/test_decode_differential.py:268 (its generator and
    seeds): flat records through the port's two paths and the JAX
    package's native parser, equal bit for bit."""
    rng = np.random.default_rng(3000 + seed)
    fields = []
    for i in range(int(rng.integers(1, 7))):
        t = tdd._AVRO_PRIMS[rng.integers(0, len(tdd._AVRO_PRIMS))]
        nullable = bool(rng.integers(0, 2))
        fields.append({"name": f"f{i}",
                       "type": ["null", t] if nullable else t})
    decl = {"type": "record", "name": "Fuzz", "fields": fields}
    records = []
    for _ in range(80):
        rec = {}
        for f in fields:
            t = f["type"]
            nullable = isinstance(t, list)
            base = t[1] if nullable else t
            rec[f["name"]] = (None if nullable and rng.random() < 0.25
                              else tdd._avro_edge(rng, base))
        records.append(rec)
    has_bytes = any(f["type"] == "bytes" or f["type"] == ["null", "bytes"]
                    for f in fields)
    (nat, en), (py, ep), (jax, ej) = _three_ways(
        decl, _encode(decl, records), port_native=not has_bytes)
    assert en is None and ep is None and ej is None
    assert nat == py == jax


@pytest.mark.parametrize("seed", range(12))
def test_differential_avro_nested_decode(seed):
    """Twin of tests/test_decode_differential.py:366 (its generator and
    seeds): nested records and arrays, nullable at every depth; the port's
    native tree parser engages, and its NestedColumns equal the Python
    path's and the JAX package's values bit for bit."""
    rng = np.random.default_rng(4000 + seed)
    counter = [0]
    fields = []
    has_nested = False
    for i in range(int(rng.integers(2, 6))):
        ft = tdd._rand_avro_type(rng, 2, counter)
        has_nested = has_nested or isinstance(ft, dict)
        if rng.random() < 0.35:
            ft = ["null", ft]
        fields.append({"name": f"f{i}", "type": ft})
    if not has_nested:
        counter[0] += 1
        fields.append({"name": "forced_nested", "type": {
            "type": "record", "name": f"Rec{counter[0]}",
            "fields": [{"name": "x", "type": ["null", "long"]}]}})
    decl = {"type": "record", "name": "NestedFuzz", "fields": fields}
    jsch = jac.parse_avro_schema(decl)
    records = [{name: tdd._rand_avro_value(rng, t, nullable)
                for name, t, nullable in jsch.fields} for _ in range(60)]
    payloads = _encode(decl, records)
    dec = tac.AvroDecoder(None, tac.parse_avro_schema(decl))
    assert dec._native is not None and dec._native._tree is not None
    for p in payloads:
        dec.push(p)
    dec.flush()
    assert dec.decode_fallback_rows == 0
    (nat, en), (py, ep), (jax, ej) = _three_ways(decl, payloads)
    assert en is None and ep is None and ej is None
    assert nat == py == jax


@pytest.mark.parametrize("use_native", [True, False])
def test_seeded_measurements_decode_equal_across_packages(use_native):
    """The same seeded Measurement payloads (the record of phase 29 of
    chip_smoke.py, with nulls) through the port's and the JAX package's
    decoder on the same path: string columns, validity and values
    equal, the readings bit for bit."""
    decl = {"type": "record", "name": "Measurement", "fields": [
        {"name": "occurred_at_ms",
         "type": {"type": "long", "logicalType": "timestamp-millis"}},
        {"name": "sensor_name", "type": "string"},
        {"name": "reading", "type": ["null", "double"]}]}
    rng = np.random.default_rng(29)
    vals = rng.normal(50, 10, 4000)
    records = [{"occurred_at_ms": 1_700_000_000_000 + i,
                "sensor_name": f"sensor_{int(k)}",
                "reading": None if i % 11 == 0 else float(v)}
               for i, (k, v) in enumerate(zip(rng.integers(0, 10, 4000),
                                              vals))]
    payloads = _encode(decl, records)
    port = tac.AvroDecoder(None, tac.parse_avro_schema(decl),
                           use_native=use_native)
    jax = jac.AvroDecoder(None, jac.parse_avro_schema(decl),
                          use_native=use_native)
    assert (port._native is not None) == use_native
    got = _decode(port, payloads, tcols.as_numpy)
    want = _decode(jax, payloads, jcols.as_numpy)
    assert got[1] is None and want[1] is None
    assert got[0] == want[0]
    assert got[0]["reading"][1] == [i % 11 != 0 for i in range(4000)]


def test_chip_smoke_avro_encoder_matches_encode_record():
    """chip_smoke.py's numpy Avro encoder (phase 29) writes, byte for byte,
    the records ``encode_record`` writes, over a few thousand seeded rows
    with extreme event times and signed zeros."""
    import chip_smoke as cs

    rng = np.random.default_rng(7)
    n = 3000
    ts = rng.integers(-(2**62), 2**62, n)
    ts[:5] = [0, 1, -1, 2**63 - 1, -(2**63)]
    kid = rng.integers(0, 10, n)
    val = rng.normal(50, 10, n)
    val[0], val[1] = -0.0, np.inf
    names = [f"sensor_{i}" for i in range(10)]
    data, offs = cs._concat_pieces(cs.avro_pieces(ts, kid, val, names), n)
    raw = data.tobytes()
    sch = tac.parse_avro_schema(cs.MEASUREMENT_AVRO)
    for i in range(n):
        rec = {"occurred_at_ms": int(ts[i]), "sensor_name": names[kid[i]],
               "reading": float(val[i])}
        assert raw[offs[i]:offs[i + 1]] == tac.encode_record(sch, rec), i


# -- the topic pipelines (tests/test_kafka.py) ------------------------------

T0 = 1_700_000_000_000


@pytest.fixture
def broker():
    b = MockKafkaBroker().start()
    yield b
    b.stop()


def _feed(broker, topic, records_of, schema):
    """Five chunks of 40 records, 150 ms apart, as the JAX tests feed."""
    def run():
        for chunk in range(5):
            msgs = [tac.encode_record(schema, records_of(i))
                    for i in range(chunk * 40, (chunk + 1) * 40)]
            broker.produce(topic, 0, msgs, ts_ms=T0 + chunk)
            time.sleep(0.15)

    threading.Thread(target=run, daemon=True).start()


MEASUREMENT = {
    "type": "record", "name": "Measurement",
    "fields": [
        {"name": "occurred_at_ms",
         "type": {"type": "long", "logicalType": "timestamp-millis"}},
        {"name": "sensor_name", "type": "string"},
        {"name": "reading", "type": ["null", "double"]},
    ],
}


def test_avro_from_topic_pipeline(broker):
    """Twin of tests/test_kafka.py:575: from_topic(encoding='avro') decodes
    through the native parser off the fetch arena into the window; every
    closed window's count of non-null readings and sum equal the records'
    own."""
    schema = tac.parse_avro_schema(MEASUREMENT)
    broker.create_topic("avro_t", partitions=1)

    def rec(i):
        return {"occurred_at_ms": T0 + i * 25, "sensor_name": f"s{i % 3}",
                "reading": None if i % 10 == 0 else float(i)}

    _feed(broker, "avro_t", rec, schema)
    ctx = tt.Context(tt.EngineConfig(device="cpu",
                                     source_idle_timeout_ms=400))
    src = ctx.from_topic("avro_t", bootstrap_servers=broker.bootstrap,
                         timestamp_column="occurred_at_ms", encoding="avro",
                         avro_schema=MEASUREMENT)
    probe = ctx.table("avro_t").partitions()[0]
    assert isinstance(probe._decoder, tac.AvroDecoder)
    assert isinstance(probe._decoder._native, NativeAvroParser)
    ds = src.window(["sensor_name"],
                    [F.count(tt.col("reading")).alias("cnt"),
                     F.sum(tt.col("reading")).alias("s")], 1000)
    got: dict = {}
    deadline = time.time() + 20
    it = ds.stream()
    try:
        for batch in it:
            for ws, k, c, s in zip(
                    batch.column(WINDOW_START_COLUMN).tolist(),
                    tcols.as_numpy(batch.column("sensor_name")).tolist(),
                    batch.column("cnt").tolist(),
                    batch.column("s").tolist()):
                got[(ws, k)] = (c, s)
            if sum(c for c, _ in got.values()) >= 108 or \
                    time.time() > deadline:
                break
    finally:
        it.close()
    want: dict = {}
    for i in range(200):
        r = rec(i)
        key = ((r["occurred_at_ms"] // 1000) * 1000, r["sensor_name"])
        c, s = want.get(key, (0, 0.0))
        if r["reading"] is not None:
            c, s = c + 1, s + r["reading"]
        want[key] = (c, s)
    assert sum(c for c, _ in got.values()) >= 108, got
    for key, (c, s) in got.items():
        assert c == want[key][0] and s == pytest.approx(want[key][1]), key


def test_nested_avro_from_topic_pipeline(broker):
    """Twin of tests/test_kafka.py:662: a nested Avro payload (records,
    an array, an enum: the Python decoder) through from_topic, struct
    field accessors and the window."""
    decl = {
        "type": "record", "name": "Trip",
        "fields": [
            {"name": "occurred_at_ms",
             "type": {"type": "long", "logicalType": "timestamp-millis"}},
            {"name": "driver", "type": {
                "type": "record", "name": "Driver",
                "fields": [
                    {"name": "id", "type": "string"},
                    {"name": "gps", "type": {
                        "type": "record", "name": "Gps",
                        "fields": [{"name": "speed", "type": "double"},
                                   {"name": "lat", "type": "double"}]}},
                ]}},
            {"name": "tags", "type": {"type": "array", "items": "string"}},
            {"name": "status", "type": {
                "type": "enum", "name": "Status",
                "symbols": ["REQUESTED", "ACTIVE", "DONE"]}},
        ],
    }
    schema = tac.parse_avro_schema(decl)
    broker.create_topic("trips_avro", partitions=1)
    _feed(broker, "trips_avro", lambda i: {
        "occurred_at_ms": T0 + i * 25,
        "driver": {"id": f"d{i % 3}", "gps": {"speed": float(i % 7),
                                               "lat": 37.0}},
        "tags": ["x"] * (i % 3), "status": "ACTIVE" if i % 2 else "DONE",
    }, schema)
    ctx = tt.Context(tt.EngineConfig(device="cpu",
                                     source_idle_timeout_ms=400))
    src = ctx.from_topic("trips_avro", bootstrap_servers=broker.bootstrap,
                         timestamp_column="occurred_at_ms", encoding="avro",
                         avro_schema=decl)
    probe = ctx.table("trips_avro").partitions()[0]
    assert isinstance(probe._decoder, tac.AvroDecoder)
    assert probe._decoder._native is None
    col = tt.col
    ds = (src.with_column("speed", col("driver").field("gps").field("speed"))
          .with_column("driver_id", col("driver").field("id"))
          .window(["driver_id"],
                  [F.count(col("speed")).alias("cnt"),
                   F.max(col("speed")).alias("top_speed")], 1000))
    counts: dict = {}
    top: dict = {}
    deadline = time.time() + 20
    it = ds.stream()
    try:
        for batch in it:
            for k, c, t in zip(
                    tcols.as_numpy(batch.column("driver_id")).tolist(),
                    batch.column("cnt").tolist(),
                    batch.column("top_speed").tolist()):
                counts[k] = counts.get(k, 0) + int(c)
                top[k] = max(top.get(k, 0.0), float(t))
            if sum(counts.values()) >= 120 or time.time() > deadline:
                break
    finally:
        it.close()
    assert sum(counts.values()) >= 120, counts
    assert set(counts) == {"d0", "d1", "d2"}
    assert max(top.values()) == 6.0, top
