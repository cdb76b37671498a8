"""The port's Arrow-style columns (``denormalized_tpu_torch/common/
columns.py``) against the JAX package's: twins of tests/test_columnar.py
(column ops, RecordBatch integration, the offsets+bytes intern lane, the
spec/buffer codec, exact accounting) and of
tests/test_columnar_differential.py (a string-keyed window over the JSON
parser's StringColumn batches emits what the JAX package emits, and what
the port emits over object-array batches)."""

import json

import numpy as np
import pytest

import denormalized_tpu as jx
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.common import columns as jcols
from denormalized_tpu.common.record_batch import RecordBatch as JRB
from denormalized_tpu.common.schema import DataType as JD
from denormalized_tpu.common.schema import Field as JFld
from denormalized_tpu.common.schema import Schema as JS
from denormalized_tpu.formats.json_codec import JsonDecoder as JDec
from denormalized_tpu.formats.json_codec import JsonRowEncoder as JEnc
from denormalized_tpu.sources.memory import MemorySource as JMem
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common import columns as tcols
from denormalized_tpu_torch.common.errors import SchemaError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType as D
from denormalized_tpu_torch.common.schema import Field as F
from denormalized_tpu_torch.common.schema import Schema as S
from denormalized_tpu_torch.formats.json_codec import JsonDecoder, JsonRowEncoder
from denormalized_tpu_torch.sources.memory import MemorySource

PKGS = {
    "jax": (jcols, JFld, JD),
    "torch": (tcols, F, D),
}


def _sc(cols, vals):
    col = cols.StringColumn.from_objects(np.array(vals, dtype=object))
    assert col is not None
    return col


def _nested_struct(pkg):
    cols, Fld, Dt = PKGS[pkg]
    f = Fld("st", Dt.STRUCT, children=(Fld("x", Dt.INT64), Fld("s", Dt.STRING)))
    prim = cols.PrimitiveColumn(
        "i64", np.array([1, 2, 3, 4]), np.array([True, False, True, True])
    )
    return cols.NestedColumn(
        f, "struct", 4, [prim, _sc(cols, ["a", "b", None, "d"])],
        validity=np.array([True, True, False, True]),
    )


def _string_ops(pkg):
    cols = PKGS[pkg][0]
    vals = ["ab", "", "日本語", None, "x" * 300, "tail\x00"]
    col = _sc(cols, vals)
    return [
        col.tolist(), col[2], col[3],
        col.take(np.array([4, 3, 0])).tolist(), col[1:4].tolist(),
        col[np.array([True, False, True, False, False, True])].tolist(),
        cols.StringColumn.concat([col, col.slice(0, 2)]).tolist(),
        col.nbytes, np.asarray(col).dtype == object,
        cols.StringColumn.from_objects(np.array([b"b", "s"], dtype=object)),
    ]


def _nested_ops(pkg):
    cols, Fld, Dt = PKGS[pkg]
    st = _nested_struct(pkg)
    lf = Fld("lst", Dt.LIST, children=(st.field,))
    lc = cols.NestedColumn(
        lf, "list", 3, [st], validity=np.array([True, False, True]),
        offsets=np.array([0, 2, 2, 4]),
    )
    out = [st.tolist(), st.take(np.array([3, 0])).tolist(), lc.tolist(),
           lc.take(np.array([2, 0])).tolist(),
           cols.NestedColumn.concat([lc, lc.take(np.array([0]))]).tolist()]
    for c in (_sc(cols, ["q", None, ""]), st, lc):
        spec, bufs = cols.column_spec_and_buffers(c)
        out.append(spec)
        out.append([b.tobytes() for b in bufs])
        out.append(cols.column_from_spec(spec, iter(bufs)).tolist())
        arrays: dict = {}
        entry = cols.column_to_arrays(c, "c", arrays)
        out.append(cols.column_from_arrays(entry, "c", arrays).tolist())
    return out


@pytest.mark.parametrize("ops", [_string_ops, _nested_ops],
                         ids=["string", "nested"])
def test_column_ops_match_the_jax_package(ops):
    got, want = ops("torch"), ops("jax")
    assert got == want
    if ops is _string_ops:
        assert got[0] == ["ab", "", "日本語", None, "x" * 300, "tail\x00"]
        assert got[-1] is None  # bytes values keep the object lane


def test_concat_empty_and_mixed_representations():
    with pytest.raises(SchemaError, match="empty sequence"):
        RecordBatch.concat([])
    sch = S([F("a", D.INT64), F("s", D.STRING)])
    b = RecordBatch.concat([], schema=sch)
    assert b.num_rows == 0 and b.schema == sch
    sch = S([F("s", D.STRING)])
    b_col = RecordBatch(sch, [_sc(tcols, ["a", None])])
    legacy = np.empty(2, dtype=object)
    legacy[:] = ["c", "d"]
    got = RecordBatch.concat([b_col, RecordBatch(sch, [legacy])])
    assert got.to_pydict() == {"s": ["a", None, "c", "d"]}
    got2 = RecordBatch.concat([b_col, b_col])
    assert isinstance(got2.columns[0], tcols.StringColumn)
    assert got2.to_pydict() == {"s": ["a", None, "a", None]}


def test_to_pydict_and_to_pyarrow_apply_validity():
    pa = pytest.importorskip("pyarrow")  # noqa: F841

    def batch(pkg):
        cols, Fld, Dt = PKGS[pkg]
        RB = JRB if pkg == "jax" else RecordBatch
        Sch = JS if pkg == "jax" else S
        sch = Sch([Fld("a", Dt.INT64), Fld("f", Dt.FLOAT64),
                   Fld("s", Dt.STRING), Fld("t", Dt.BOOL)])
        masks = [np.array([True, False, True]), np.array([False, True, True]),
                 np.array([True, True, False]), np.array([False, False, True])]
        return RB(sch, [np.array([1, 0, 3]), np.array([0.0, 2.5, 3.5]),
                        _sc(cols, ["x", "y", ""]),
                        np.array([False, False, True])], masks)

    b, jb = batch("torch"), batch("jax")
    d = b.to_pydict()
    assert d == jb.to_pydict() == {
        "a": [1, None, 3], "f": [None, 2.5, 3.5], "s": ["x", "y", None],
        "t": [None, None, True],
    }
    assert b.to_pyarrow().to_pylist() == jb.to_pyarrow().to_pylist()


def test_batch_transforms_keep_columnar_columns():
    sch = S([F("s", D.STRING), F("v", D.INT64)])
    col = _sc(tcols, ["a", "b", None, "d", "e"])
    b = RecordBatch(sch, [col, np.arange(5)], [col.validity, None])
    f = b.filter(np.array([True, False, True, True, False]))
    assert isinstance(f.columns[0], tcols.StringColumn)
    assert f.to_pydict() == {"s": ["a", None, "d"], "v": [0, 2, 3]}
    assert b.take(np.array([4, 2])).to_pydict() == {"s": ["e", None], "v": [4, 2]}
    assert b.slice(1, 3).to_pydict() == {"s": ["b", None, "d"], "v": [1, 2, 3]}
    assert b.select(["v"]).schema.names == ["v"]
    m = b.materialized()
    assert m.columns[0].dtype == object and not isinstance(
        m.columns[0], tcols.StringColumn
    )
    assert m.to_pydict() == b.to_pydict()
    # a Column in a batch is kept as it is, not turned into an object array
    assert RecordBatch(sch, [col, np.arange(5)]).columns[0] is col


def test_interner_offsets_lane_matches_the_object_lane_and_the_jax_package():
    from denormalized_tpu.ops.interner import ColumnInterner as JCI
    from denormalized_tpu_torch.ops.interner import ColumnInterner, GroupInterner

    vals = ["a", "b", "a", None, "c", "", "b", "日本", "tail\x00"]
    ci = ColumnInterner()
    ids_col = ci.intern_array(_sc(tcols, vals))
    assert ci.native_calls == 1 and ci.lane.startswith("native")
    ids_obj = ColumnInterner().intern_array(np.array(vals, dtype=object))
    ids_jax = JCI().intern_array(_sc(jcols, vals))
    np.testing.assert_array_equal(ids_col, ids_obj)
    np.testing.assert_array_equal(ids_col, ids_jax)
    # mixing lanes in one interner resolves to the same ids
    np.testing.assert_array_equal(
        ids_col, ci.intern_array(np.array(vals, dtype=object)))
    assert ci.value_of(np.asarray(ids_col[:4])).tolist() == ["a", "b", "a", None]
    g = GroupInterner(1)
    gids = g.intern([_sc(tcols, ["k1", "k2", "k1", None])])
    assert gids[0] == gids[2] and gids[0] != gids[1]
    assert g.keys_of(np.asarray([gids[0], gids[3]]))[0].tolist() == ["k1", None]


def test_string_column_keys_make_no_python_strings(monkeypatch):
    """The columnar lane interns off offsets and bytes: the column is
    never materialized on the way in."""
    from denormalized_tpu_torch.ops.interner import GroupInterner

    col = _sc(tcols, [f"sensor_{i % 7}" for i in range(100)])
    monkeypatch.setattr(tcols.StringColumn, "as_object", lambda self: (
        pytest.fail("a key column was materialized")))
    gids = GroupInterner(1).intern([col])
    assert len(set(gids.tolist())) == 7


def test_rb_nbytes_exact_for_columnar_columns():
    from denormalized_tpu_torch.obs.statewatch import OBJ_CELL_EST_BYTES, rb_nbytes

    col = _sc(tcols, ["abc", "de", None])
    b = RecordBatch(S([F("s", D.STRING)]), [col], [col.validity])
    want = col.nbytes + np.asarray(col.validity, dtype=bool).nbytes
    assert rb_nbytes(b) == want
    assert col._obj is None  # accounting materialized nothing
    col.as_object()
    assert rb_nbytes(b) == want + len(col) * OBJ_CELL_EST_BYTES


def test_as_numpy_passthrough():
    arr = np.arange(3)
    assert tcols.as_numpy(arr) is arr
    out = tcols.as_numpy(_sc(tcols, ["a"]))
    assert out.dtype == object and out.tolist() == ["a"]


# -- twin of tests/test_columnar_differential.py --------------------------

T0 = 1_700_000_000_000


def _payloads(n_batches=10, rows=240, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 500 + rng.integers(0, 500, rows))
        keys = rng.integers(0, 9, rows)
        vals = rng.integers(0, 1 << 16, rows)
        out.append([json.dumps({
            "occurred_at_ms": int(ts[i]),
            "sensor_name": f"sensor-{keys[i]}-日本",
            "reading": int(vals[i]),
        }).encode() for i in range(rows)])
    return out


def _decode(dec, payloads):
    out = []
    for rows in payloads:
        for r in rows:
            dec.push(r)
        out.append(dec.flush())
    return out


def _emissions(pkg, batches):
    if pkg == "jax":
        ctx = jx.Context()
        src, Fn, c = JMem, JF, jx.col
        enc = JEnc()
    else:
        ctx = tt.Context(tt.EngineConfig(device="cpu"))
        src, Fn, c = MemorySource, TF, tt.col
        enc = JsonRowEncoder()
    res = ctx.from_source(
        src.from_batches(batches, timestamp_column="occurred_at_ms"),
        name="columnar_diff_src",
    ).window(
        ["sensor_name"],
        [Fn.count(c("reading")).alias("cnt"), Fn.min(c("reading")).alias("mn"),
         Fn.max(c("reading")).alias("mx")],
        1000,
    ).collect()
    return sorted(enc.encode(res))


def test_string_keyed_window_over_parser_batches_matches_the_jax_package():
    payloads = _payloads()
    tsch = S([F("occurred_at_ms", D.INT64), F("sensor_name", D.STRING),
              F("reading", D.INT64)])
    jsch = JS([JFld("occurred_at_ms", JD.INT64), JFld("sensor_name", JD.STRING),
               JFld("reading", JD.INT64)])
    tb = _decode(JsonDecoder(tsch), payloads)
    jb = _decode(JDec(jsch), payloads)
    assert isinstance(tb[0].column("sensor_name"), tcols.StringColumn)
    for a, b in zip(tb, jb):
        assert a.to_pydict() == b.to_pydict()
    got = _emissions("torch", tb)
    assert got == _emissions("jax", jb)
    # the same rows as object arrays give the same bytes
    assert got == _emissions("torch", [b.materialized() for b in tb])
    assert len(got) > 9
