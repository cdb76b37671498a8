"""The port's exchange string lanes against the JAX package's: adversarial
string columns (empty strings, multi-byte UTF-8, null-heavy masks, zero
rows) and a nested column frame to the same bytes in both packages, on
the raw offsets+bytes lane and on the legacy JSON lane
(``DENORMALIZED_EXCHANGE_JSON=1``); both lanes decode to the same batch;
a torn columnar frame is detected; and a StringColumn routes like the same
keys as an object column, in both packages."""

import io

import numpy as np
import pytest

from denormalized_tpu_torch.cluster import framing as tframing
from denormalized_tpu_torch.cluster.hashing import bucket_rows as tbucket
from denormalized_tpu_torch.common import columns as tcols
from denormalized_tpu_torch.common.errors import SourceError
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TD
from denormalized_tpu_torch.common.schema import Field as TF
from denormalized_tpu_torch.common.schema import Schema as TS
from denormalized_tpu_torch.formats.json_codec import JsonRowEncoder

from denormalized_tpu.cluster import framing as jframing
from denormalized_tpu.cluster.hashing import bucket_rows as jbucket
from denormalized_tpu.common import columns as jcols
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JD
from denormalized_tpu.common.schema import Field as JF
from denormalized_tpu.common.schema import Schema as JS

T_SCHEMA = TS([TF("k", TD.STRING), TF("v", TD.INT64)])
J_SCHEMA = JS([JF("k", JD.STRING), JF("v", JD.INT64)])


class _Sock:
    def __init__(self, b: bytes):
        self._b = io.BytesIO(b)

    def recv(self, n):
        return self._b.read(n)


def _roundtrip(frame: bytes, schema):
    payload = tframing.read_frame(_Sock(frame))
    assert payload == frame[tframing._HDR.size:]
    t, decoded, wm, _part = tframing.decode_frame(payload, schema)
    assert t == "data" and wm == 777
    return decoded


def _cases():
    rng = np.random.default_rng(5)
    return {
        "empty_strings": ["" if i % 3 else f"v{i}" for i in range(64)],
        "multibyte_utf8": ["日本語テキスト", "éàü", "😀😀", "mixédバイト", ""] * 10,
        "null_heavy": [None if rng.random() < 0.7 else f"k{i}"
                       for i in range(128)],
        "zero_rows": [],
    }


def _pair(vals, columnar: bool):
    obj = np.empty(len(vals), dtype=object)
    obj[:] = vals
    v = np.arange(len(vals), dtype=np.int64)
    tcol = tcols.StringColumn.from_objects(obj) if columnar else obj
    jcol = jcols.StringColumn.from_objects(obj) if columnar else obj.copy()
    tmask = getattr(tcol, "validity", None) if columnar else (
        tcols.StringColumn.from_objects(obj).validity)
    jmask = getattr(jcol, "validity", None) if columnar else (
        None if tmask is None else tmask.copy())
    return (TBatch(T_SCHEMA, [tcol, v], [tmask, None]),
            JBatch(J_SCHEMA, [jcol, v.copy()], [jmask, None]))


@pytest.mark.parametrize("name,vals", sorted(_cases().items()))
def test_string_frames_equal_on_both_lanes(name, vals, monkeypatch):
    tb, jb = _pair(vals, columnar=True)
    raw = tframing.encode_data(tb, 777)
    assert raw == jframing.encode_data(jb, 777)
    got_raw = _roundtrip(raw, T_SCHEMA)
    assert isinstance(got_raw.columns[0], tcols.StringColumn) or not vals
    monkeypatch.setenv("DENORMALIZED_EXCHANGE_JSON", "1")
    tb_obj, jb_obj = _pair(vals, columnar=False)
    legacy = tframing.encode_data(tb_obj, 777)
    assert legacy == jframing.encode_data(jb_obj, 777)
    got_legacy = _roundtrip(legacy, T_SCHEMA)
    monkeypatch.delenv("DENORMALIZED_EXCHANGE_JSON")
    assert got_raw.to_pydict() == got_legacy.to_pydict() == tb_obj.to_pydict()
    enc = JsonRowEncoder()
    assert enc.encode(got_raw) == enc.encode(got_legacy)


def test_nested_column_frame_equal_and_roundtrips():
    def build(cols, F, S, D):
        sch = S([F("st", D.STRUCT, children=(F("x", D.INT64),
                                             F("s", D.STRING)))])
        prim = cols.PrimitiveColumn(
            "i64", np.arange(5), np.array([True, True, False, True, True]))
        ss = cols.StringColumn.from_objects(
            np.array(["", "日本", None, "d", "e"], dtype=object))
        st = cols.NestedColumn(
            sch.field("st"), "struct", 5, [prim, ss],
            validity=np.array([True, False, True, True, True]))
        return sch, st

    tsch, tst = build(tcols, TF, TS, TD)
    jsch, jst = build(jcols, JF, JS, JD)
    tb = TBatch(tsch, [tst], [tst.validity])
    frame = tframing.encode_data(tb, 777)
    assert frame == jframing.encode_data(JBatch(jsch, [jst], [jst.validity]),
                                         777)
    got = _roundtrip(frame, tsch)
    assert isinstance(got.columns[0], tcols.NestedColumn)
    assert got.to_pydict() == tb.to_pydict()


def test_raw_lane_elides_duplicate_validity():
    vals = [None if i % 3 else f"k{i}" for i in range(512)]
    tb, _ = _pair(vals, columnar=True)
    frame = tframing.encode_data(tb, None)
    col = tb.columns[0]
    detached = TBatch(T_SCHEMA, tb.columns, [col.validity.copy(), None])
    assert len(tframing.encode_data(detached, None)) - len(frame) >= 512 - 16
    _t, got, _wm, _part = tframing.decode_frame(
        frame[tframing._HDR.size:], T_SCHEMA)
    np.testing.assert_array_equal(np.asarray(got.mask("k"), dtype=bool),
                                  col.validity)


def test_torn_columnar_frame_detected():
    tb, _ = _pair(["abc"] * 50, columnar=True)
    frame = bytearray(tframing.encode_data(tb, None))
    frame[-3] ^= 0xFF  # a byte inside the string data buffer
    with pytest.raises(SourceError, match="CRC"):
        tframing.read_frame(_Sock(bytes(frame)))


def test_string_routing_identical_across_lanes_and_packages():
    vals = ["a", "", "日本語", None, "key-123"] * 20
    obj = np.empty(len(vals), dtype=object)
    obj[:] = vals
    want = jbucket([jcols.StringColumn.from_objects(obj)], 4)
    np.testing.assert_array_equal(tbucket([obj], 4), want)
    np.testing.assert_array_equal(
        tbucket([tcols.StringColumn.from_objects(obj)], 4), want)
