"""A JAX ring carried into the port continues to the same emissions: run the
JAX package's window operator over the first batches, export its ring
(``(W, G)`` numpy planes keyed by component label) and group interner, load
both into the port's operator, feed each the remaining batches, and compare
what they emit.  Counts and extrema exact, sums/avg to rtol=1e-5."""

import numpy as np
import pytest

from denormalized_tpu.common.constants import CANONICAL_TIMESTAMP_COLUMN as J_TS
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical.expr import AggregateExpr as JAgg
from denormalized_tpu.logical.expr import col as jcol
from denormalized_tpu.logical.plan import WindowType as JWindowType
from denormalized_tpu.physical.base import EOS as J_EOS
from denormalized_tpu.physical.base import ExecOperator as JExec
from denormalized_tpu.physical.window_exec import StreamingWindowExec as JWindow
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN as T_TS
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical.expr import AggregateExpr as TAgg
from denormalized_tpu_torch.logical.expr import col as tcol
from denormalized_tpu_torch.logical.plan import WindowType as TWindowType
from denormalized_tpu_torch.physical.base import EOS as T_EOS
from denormalized_tpu_torch.physical.base import ExecOperator as TExec
from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec as TWindow

# window indices j here sit at 20+ mod 64, so j % 16 != j % 64: a ring
# carried at the wrong W would address the wrong slots
T0 = 1_700_000_004_123
AGGS = ("count", "sum", "min", "max", "avg")


class _Feed:
    """Input operator replaying prepared batches, optionally ending with
    EndOfStream (without it the window keeps its open windows)."""

    def __init__(self, schema, batches, eos):
        self.schema, self._batches, self._eos = schema, batches, eos

    def run(self):
        yield from self._batches
        if self._eos is not None:
            yield self._eos


class JFeed(_Feed, JExec):
    pass


class TFeed(_Feed, TExec):
    pass


def _raw(seed, n_batches=10, n=300):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 350 + rng.integers(0, 350, n)).astype(np.int64)
        names = np.array([f"k{i}" for i in rng.integers(0, 37, n)], dtype=object)
        vals = rng.normal(50, 10, n)
        mask = rng.random(n) > 0.1
        out.append((ts, names, vals, mask))
    return out


def _batches(pkg, raw):
    Schema, Field, DT, Batch, TS = (
        (JSchema, JField, JType, JBatch, J_TS) if pkg == "jax"
        else (TSchema, TField, TType, TBatch, T_TS)
    )
    schema = Schema([
        Field("sensor_name", DT.STRING, nullable=False),
        Field("reading", DT.FLOAT64),
        Field(TS, DT.TIMESTAMP_MS, nullable=False),
    ])
    return schema, [
        Batch(schema, [names, vals, ts], [None, mask, None])
        for ts, names, vals, mask in raw
    ]


def _window(pkg, feed, slide, slots=16):
    if pkg == "jax":
        aggs = [JAgg(k, jcol("reading"), k) for k in AGGS]
        return JWindow(feed, [jcol("sensor_name")], aggs, JWindowType.SLIDING,
                       1000, slide, device_strategy="scatter")
    aggs = [TAgg(k, tcol("reading"), k) for k in AGGS]
    return TWindow(feed, [tcol("sensor_name")], aggs, TWindowType.SLIDING,
                   1000, slide, device="cpu", device_strategy="auto",
                   min_window_slots=slots)


def _rows(items):
    out = {}
    for b in items:
        if not hasattr(b, "num_rows"):
            continue
        for i in range(b.num_rows):
            key = (int(b.column("window_start_time")[i]),
                   b.column("sensor_name")[i])
            out[key] = tuple(float(b.column(k)[i]) for k in AGGS)
    return out


@pytest.mark.parametrize(
    "slide, cut, port_slots",
    [(1000, 3, 16), (1000, 6, 16), (200, 3, 16), (200, 6, 16),
     # a port operator built with another ring size takes the carried W:
     # slots are absolute window index mod W
     (200, 6, 64)],
)
def test_jax_ring_carried_into_the_port(slide, cut, port_slots):
    raw = _raw(slide + cut)
    jschema, jb = _batches("jax", raw)
    tschema, tb = _batches("torch", raw)

    # uninterrupted JAX run: the reference emissions
    full = _rows(_window("jax", JFeed(jschema, jb, J_EOS), slide).run())

    # JAX over the first `cut` batches, stopped without EndOfStream
    head = _window("jax", JFeed(jschema, jb[:cut], None), slide)
    head_rows = _rows(head.run())
    # export: the ring planes, the interner and the window bookkeeping
    host = head._backend.export()
    snap = head._interner.snapshot()

    tail = _window("torch", TFeed(tschema, tb[cut:], T_EOS), slide, port_slots)
    tail.load_state(
        host, snap, head._first_open, head._max_win_seen, head._watermark_ms,
        head._any_nulls_seen,
    )
    tail_rows = _rows(tail.run())
    assert tail.backend.dense_updates > 0  # the port's dense path ran

    assert not set(head_rows) & set(tail_rows)
    carried = {**head_rows, **tail_rows}
    assert set(carried) == set(full)
    for k, want in full.items():
        got = carried[k]
        assert got[0] == want[0], (k, got, want)
        # min/max exact; NaN (a window of only null readings) equals NaN
        np.testing.assert_array_equal(got[2:4], want[2:4], err_msg=str(k))
        np.testing.assert_allclose([got[1], got[4]], [want[1], want[4]],
                                   rtol=1e-5, err_msg=str(k))


# -- the group interner's lanes --------------------------------------------

_KEY_BATCHES = [
    ["a", "b", None, "a\x00\x00", "ü", 7, "7", float("nan"), "nan", "b"],
    ["c", None, "a", 3.5, "None", "\x00", "", "ü", "c\x00", "d"],
    ["d", "e", "a", None, "z" * 40, 7, "e", "", "f", "a"],
]
_NUMERIC_BATCHES = [
    np.array([3.0, np.nan, 1.5, 3.0]), np.array([np.nan, 2.0, 1.5, -0.0]),
]


def _port_interner(lane, monkeypatch):
    from denormalized_tpu_torch.ops import interner as ti

    if lane == "native-bytes":
        # the byte-key lane of the same library (what a machine without the
        # Python headers builds)
        nat = ti.native_interner()
        monkeypatch.setattr(
            ti, "native_interner", lambda: ti._NativeInterner(nat.lib, None)
        )
    elif lane == "dict":
        # the lane a failed native build leaves
        monkeypatch.setattr(ti, "native_interner", lambda: None)
    return ti.ColumnInterner()


@pytest.mark.parametrize("lane", ["native-pyobject", "native-bytes", "dict"])
def test_interner_lanes_match_jax(lane, monkeypatch):
    """Strings, ints, None, NaN and trailing NULs in an object column, a
    numeric column with NaNs, and a JAX interner's values carried in with
    load_values: the port's ids and values equal the JAX package's (native
    interner) on every lane."""
    from denormalized_tpu.ops.interner import ColumnInterner as JColumn

    jcol_, tcol_ = JColumn(), _port_interner(lane, monkeypatch)
    for keys in _KEY_BATCHES:
        arr = np.array(keys, dtype=object)
        assert tcol_.intern_array(arr).tolist() == (
            jcol_.intern_array(arr).tolist())
    assert tcol_.lane == lane
    assert tcol_.native_calls == (0 if lane == "dict" else 3)
    assert len(tcol_) == len(jcol_)
    assert tcol_.all_values() == jcol_.all_values()
    ids = np.arange(len(jcol_))
    assert tcol_.value_of(ids).tolist() == jcol_.value_of(ids).tolist()

    # carried in: a fresh port interner continues the JAX ids
    carried = _port_interner(lane, monkeypatch)
    carried.load_values(jcol_.all_values())
    assert carried.lane == lane
    more = np.array(["new", None, "a", "zz\x00", 9], dtype=object)
    assert carried.intern_array(more).tolist() == (
        jcol_.intern_array(more).tolist())
    assert carried.all_values() == jcol_.all_values()

    jnum, tnum = JColumn(), _port_interner(lane, monkeypatch)
    for arr in _NUMERIC_BATCHES:
        assert tnum.intern_array(arr).tolist() == jnum.intern_array(arr).tolist()
    assert tnum.lane == "dict"
    assert len(tnum) == len(jnum) == 5  # all NaNs one key
