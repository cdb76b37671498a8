"""The port's exchange building blocks against the JAX package's: hash
buckets and partition math bit for bit, frame bytes byte for byte (every
frame type, int, float, bool, object and columnar string keys, masks,
watermarks, provenance), frames decoded across packages, integrity
checks, the plan split and the ``create_exec`` planner hook, and the
edge merger's watermark, barrier, abort and EOS semantics — no worker
processes."""

import io
import queue
import socket
import threading

import numpy as np
import pytest

import denormalized_tpu_torch as tt
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.cluster import framing as tframing
from denormalized_tpu_torch.cluster import hashing as thashing
from denormalized_tpu_torch.cluster.exchange import (
    EdgeMerger,
    EdgeState,
    ExchangeClient,
    ExchangeServer,
)
from denormalized_tpu_torch.cluster.runtime import ExchangeSourceExec
from denormalized_tpu_torch.cluster.split import ExchangeScan, split_keyed
from denormalized_tpu_torch.common.columns import StringColumn as TStringColumn
from denormalized_tpu_torch.common.errors import PlanError, SourceError
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TD
from denormalized_tpu_torch.common.schema import Field as TF_
from denormalized_tpu_torch.common.schema import Schema as TS
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.logical.optimizer import optimize as toptimize
from denormalized_tpu_torch.physical.base import Marker, WatermarkHint
from denormalized_tpu_torch.planner.planner import Planner
from denormalized_tpu_torch.sources.memory import MemorySource as TMemory

from denormalized_tpu.cluster import framing as jframing
from denormalized_tpu.cluster import hashing as jhashing
from denormalized_tpu.common.columns import StringColumn as JStringColumn
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JD
from denormalized_tpu.common.schema import Field as JF
from denormalized_tpu.common.schema import Schema as JS


def _key_columns(seed: int) -> dict:
    """Seeded key columns of every hash lane, as (port, jax) pairs."""
    rng = np.random.default_rng(seed)
    n = 4096
    ints = rng.integers(-(2**40), 2**40, n)
    floats = rng.normal(0, 1e6, n)
    floats[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -1.5, 2.0**60]
    words = np.empty(n, dtype=object)
    words[:] = [
        ("" if i % 17 == 0 else None if i % 29 == 0
         else f"sensor_{v}_é日") for i, v in enumerate(rng.integers(0, 999, n))
    ]
    return {
        "int64": (ints, ints.copy()),
        "int32": (ints.astype(np.int32), ints.astype(np.int32)),
        "float64": (floats, floats.copy()),
        "float32": (floats.astype(np.float32), floats.astype(np.float32)),
        "bool": (ints % 2 == 0, ints % 2 == 0),
        "object": (words, words.copy()),
        "string_column": (TStringColumn.from_objects(words),
                          JStringColumn.from_objects(words)),
    }


@pytest.mark.parametrize("lane", sorted(_key_columns(0)))
@pytest.mark.parametrize("n_buckets", [1, 2, 3, 4, 7])
def test_bucket_rows_bit_identical(lane, n_buckets):
    tcol, jcol = _key_columns(11)[lane]
    t = thashing.bucket_rows([tcol], n_buckets)
    j = jhashing.bucket_rows([jcol], n_buckets)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        thashing.hash_rows([tcol]), jhashing.hash_rows([jcol])
    )


def test_multi_column_hash_and_string_lanes_agree():
    cols = _key_columns(3)
    t = thashing.hash_rows([cols["int64"][0], cols["object"][0],
                            cols["float64"][0]])
    j = jhashing.hash_rows([cols["int64"][1], cols["object"][1],
                            cols["float64"][1]])
    np.testing.assert_array_equal(t, j)
    # a StringColumn hashes like the same keys as an object column
    np.testing.assert_array_equal(
        thashing.hash_rows([cols["string_column"][0]]),
        thashing.hash_rows([cols["object"][0]]),
    )


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_partitions_for_equal(n):
    for w in range(n):
        assert (thashing.partitions_for(w, n, 13)
                == jhashing.partitions_for(w, n, 13))
    with pytest.raises(ValueError):
        thashing.partitions_for(n, n, 13)


# -- frame bytes -------------------------------------------------------------


def _batches(seed: int, n: int = 64):
    """The same rows as a port and a JAX RecordBatch, every column type
    the exchange ships, with a null mask on the reading."""
    rng = np.random.default_rng(seed)
    keys = np.empty(n, dtype=object)
    keys[:] = [f"k{i % 7}" for i in range(n)]
    cols = {
        "k": keys,
        "i": rng.integers(0, 1000, n).astype(np.int64),
        "v": rng.normal(size=n),
        "b": rng.random(n) < 0.5,
        "ts": np.arange(n, dtype=np.int64) + 1_700_000_000_000,
    }
    mask = rng.random(n) < 0.8
    masks = [None, None, mask, None, None]
    t = TBatch(
        TS([TF_("k", TD.STRING), TF_("i", TD.INT64), TF_("v", TD.FLOAT64),
            TF_("b", TD.BOOL), TF_("ts", TD.TIMESTAMP_MS, nullable=False)]),
        list(cols.values()), masks,
    )
    j = JBatch(
        JS([JF("k", JD.STRING), JF("i", JD.INT64), JF("v", JD.FLOAT64),
            JF("b", JD.BOOL), JF("ts", JD.TIMESTAMP_MS, nullable=False)]),
        [c.copy() for c in cols.values()], masks,
    )
    return t, j


@pytest.mark.parametrize("wm, part", [(None, None), (777, None), (5, 3)])
def test_data_frame_bytes_equal(wm, part):
    t, j = _batches(5)
    assert (tframing.encode_data(t, wm, part=part)
            == jframing.encode_data(j, wm, part=part))


def test_columnar_string_frame_bytes_equal():
    t, j = _batches(6)
    words = t.columns[0]
    t = TBatch(t.schema, [TStringColumn.from_objects(words)] + t.columns[1:],
               t.masks)
    j = JBatch(j.schema, [JStringColumn.from_objects(words)] + j.columns[1:],
               j.masks)
    assert tframing.encode_data(t, 9) == jframing.encode_data(j, 9)


def test_control_frame_bytes_equal():
    t, j = tframing, jframing
    assert t.encode_hello(2, 3, 4) == j.encode_hello(2, 3, 4)
    assert (t.encode_resume(1, 17, 5, {0: 3, 4: 9}, True)
            == j.encode_resume(1, 17, 5, {0: 3, 4: 9}, True))
    assert t.encode_wm(123) == j.encode_wm(123)
    assert t.encode_barrier(7) == j.encode_barrier(7)
    assert t.encode_barrier(7, {2: 5}) == j.encode_barrier(7, {2: 5})
    assert t.encode_eos() == j.encode_eos()


def _payload(frame: bytes) -> bytes:
    return frame[tframing._HDR.size:]


def test_frames_decode_across_packages():
    t, j = _batches(7)
    # a JAX frame decodes in the port and a port frame in the JAX package
    kind, got, wm, part = tframing.decode_frame(
        _payload(jframing.encode_data(j, 42, part=1)), t.schema
    )
    assert (kind, wm, part) == ("data", 42, 1)
    assert got.to_pydict() == t.to_pydict()
    kind, back, wm, part = jframing.decode_frame(
        _payload(tframing.encode_data(t, 42, part=1)), j.schema
    )
    assert back.to_pydict() == j.to_pydict()
    np.testing.assert_array_equal(got.masks[2], t.masks[2])
    assert tframing.decode_frame(
        _payload(jframing.encode_barrier(3, {1: 2})), None
    ) == ("barrier", 3, {1: 2})
    assert tframing.decode_frame(
        _payload(jframing.encode_resume(0, 4, 2, {1: 5}, False)), None
    ) == ("resume", 0, 4, 2, {1: 5}, False)


class _Sock:
    def __init__(self, b: bytes):
        self._b = io.BytesIO(b)

    def recv(self, n):
        return self._b.read(n)


def test_torn_and_corrupt_frames_detected():
    t, _ = _batches(8)
    frame = tframing.encode_data(t, None)
    with pytest.raises(SourceError, match="torn"):
        tframing.read_frame(_Sock(frame[:-3]))
    bad = bytearray(tframing.encode_barrier(5))
    bad[-1] ^= 0xFF
    with pytest.raises(SourceError, match="CRC"):
        tframing.read_frame(_Sock(bytes(bad)))
    bad = bytearray(frame)
    bad[0:4] = b"XXXX"
    with pytest.raises(SourceError, match="magic"):
        tframing.read_frame(_Sock(bytes(bad)))
    assert tframing.read_frame(_Sock(b"")) is None


# -- plan split and the planner hook ---------------------------------------


def _ctx():
    return tt.Context(tt.EngineConfig(device="cpu"))


def _mem_ds(ctx, seed=0):
    t, _ = _batches(seed, 16)
    return ctx.from_source(
        TMemory.from_batches([t.select(["k", "v", "ts"])],
                             timestamp_column="ts"),
        name=f"m{seed}",
    )


def _plan(ds):
    return toptimize(tlp.Sink(ds.logical_plan(), None), True)


def test_split_keyed_and_exchange_scan_hook():
    ctx = _ctx()
    ds = _mem_ds(ctx).window([tt.col("k")],
                             [TF.count(tt.col("v")).alias("c")], 1000)
    sq = split_keyed(_plan(ds))
    assert sq.key_columns == ["k"]
    assert sq.exchange_schema.has("k")
    built = []

    def factory():
        built.append(ExchangeSourceExec(sq.exchange_schema, None, 0))
        return built[-1]

    keyed = sq.keyed_builder(ExchangeScan(sq.exchange_schema, factory))
    root = Planner(ctx.config).create_physical_plan(keyed)
    # the planner built the exchange leaf through the node's create_exec
    assert len(built) == 1
    node = root
    while node.children:
        node = node.children[0]
    assert node is built[0]


def test_split_rejects_stateless_computed_keys_and_joins():
    ctx = _ctx()
    with pytest.raises(PlanError, match="keyed operator"):
        split_keyed(_plan(_mem_ds(ctx).filter(tt.col("v") > 0)))
    ds = _mem_ds(ctx).window([tt.col("v") + tt.col("v")],
                             [TF.count(tt.col("v")).alias("c")], 1000)
    with pytest.raises(PlanError, match="column group keys"):
        split_keyed(_plan(ds))
    right = (_mem_ds(ctx, 1).with_column_renamed("v", "v2")
             .with_column_renamed("ts", "ts2"))
    joined = _mem_ds(ctx).join(right, "inner", ["k"], ["k"]).window(
        [tt.col("k")], [TF.count(tt.col("v")).alias("c")], 1000)
    with pytest.raises(PlanError, match="non-join"):
        split_keyed(_plan(joined))


# -- edge merger -------------------------------------------------------------


class _FakeServer:
    def __init__(self, n):
        class _G:
            def set(self, v):
                pass

        self.edges = {i: EdgeState(i, _G()) for i in range(n)}
        self.wake = threading.Event()


def _drain(merger, limit=100):
    out = []
    it = iter(merger)
    for _ in range(limit):
        try:
            out.append(next(it))
        except StopIteration:
            break
    return out


def test_merger_watermark_min_and_barrier_alignment():
    t, _ = _batches(1)
    srv = _FakeServer(2)
    srv.edges[0].queue.put(("data", t, 100))
    srv.edges[1].queue.put(("wm", 50))
    srv.edges[0].queue.put(("eos",))
    srv.edges[1].queue.put(("eos",))
    assert [i[1] for i in _drain(EdgeMerger(srv)) if i[0] == "wm"] == [50]
    early, late = _batches(2)[0], _batches(3)[0]
    srv = _FakeServer(2)
    srv.edges[0].queue.put(("barrier", 9))
    srv.edges[0].queue.put(("data", early, None))
    srv.edges[1].queue.put(("data", late, None))
    srv.edges[1].queue.put(("barrier", 9))
    srv.edges[0].queue.put(("eos",))
    srv.edges[1].queue.put(("eos",))
    items = _drain(EdgeMerger(srv))
    kinds = [i[0] for i in items]
    at = kinds.index("barrier")
    assert [i[1] for i in items[:at] if i[0] == "data"] == [late]
    assert [i[1] for i in items[at:] if i[0] == "data"] == [early]


def test_merger_abort_unwinds_and_eos_satisfies_barrier():
    t, _ = _batches(4)
    srv = _FakeServer(2)
    m = EdgeMerger(srv)
    m.abort_to(9)
    srv.edges[0].queue.put(("barrier", 9))  # aborted: never aligns
    srv.edges[0].queue.put(("data", t, None))
    srv.edges[0].queue.put(("barrier", 10))
    srv.edges[0].queue.put(("eos",))
    srv.edges[1].queue.put(("eos",))
    items = _drain(m)
    assert ("barrier", 9) not in items and ("barrier", 10) in items
    srv = _FakeServer(1)
    srv.edges[0].queue.put(("err", SourceError("boom")))
    with pytest.raises(SourceError, match="boom"):
        _drain(EdgeMerger(srv))
    st = EdgeState(0, type("G", (), {"set": lambda self, v: None})())
    with pytest.raises(queue.Full):
        for _ in range(st.queue.maxsize + 1):
            st.queue.put_nowait(("wm", 1))


def test_exchange_sockets_loopback_and_source_exec(tmp_path):
    """One server and one client in-process over a real unix socket: data,
    watermark, barrier and EOS frames come out of ExchangeSourceExec as
    batches, partition watermark hints, an aligned Marker and the end."""
    t, _ = _batches(9)
    schema = t.schema
    srv = ExchangeServer(0, 2, str(tmp_path / "x0.sock"), schema)
    cli = ExchangeClient(1, 0, str(tmp_path / "x0.sock"))
    try:
        cli.connect()
        cli.send(tframing.encode_data(t, 100, part=1), "data")
        cli.send(tframing.encode_wm(200), "wm")
        cli.send(tframing.encode_barrier(1), "barrier", 1)
        cli.send(tframing.encode_eos(), "eos")
        srv.local_put(("data", t, 150))
        srv.local_put(("barrier", 1))
        srv.local_put(("eos",))
        items = list(ExchangeSourceExec(schema, EdgeMerger(srv), 0).run())
    finally:
        cli.close()
        srv.stop()
    batches = [i for i in items if isinstance(i, TBatch)]
    assert sum(b.num_rows for b in batches) == 2 * t.num_rows
    assert [b.to_pydict() for b in batches] == [t.to_pydict()] * 2
    hints = [i.ts_ms for i in items if isinstance(i, WatermarkHint)
             and not i.is_announcement]
    assert hints and hints[-1] == 150  # min over the two edges
    assert [i.epoch for i in items if isinstance(i, Marker)] == [1]
    assert srv.edges[1].part_counts == {1: t.num_rows}


def test_socketpair_torn_send_detected():
    t, _ = _batches(10)
    frame = tframing.encode_data(t, None)
    a, c = socket.socketpair()
    try:
        a.sendall(frame[: len(frame) - 3])
        a.close()
        with pytest.raises(SourceError, match="torn"):
            tframing.read_frame(c)
    finally:
        c.close()
