"""The session operator's memory past its resident state: its checkpoint
document (``denormalized_tpu_torch/physical/session_exec.py::_snapshot``),
built a chunk of sessions at a time, holds the bytes of ``json.dumps`` over
the whole document, restores the same table, and its transient stays
bounded by the document's bytes plus one chunk's objects, not ~2.5 KB a
resident session; under a state budget its table's arrays follow the
resident sessions after a spill (``SessionTable.shrink_to_fit``), not their
high-water mark."""

import json
import tracemalloc

import numpy as np
import pytest

import denormalized_tpu_torch as tt
from denormalized_tpu_torch.api import functions as F
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import DataType, Field, Schema
from denormalized_tpu_torch.logical import plan as lp
from denormalized_tpu_torch.ops.session_table import SessionTable
from denormalized_tpu_torch.physical import session_exec
from denormalized_tpu_torch.physical.simple_execs import CollectSink
from denormalized_tpu_torch.runtime import executor
from denormalized_tpu_torch.sources.base import attach_canonical_timestamp
from denormalized_tpu_torch.sources.memory import MemorySource
from denormalized_tpu_torch.state import lsm, tiering
from denormalized_tpu_torch.state.checkpoint import (
    get_json,
    jsonable,
    unframe_snapshot,
    wire_checkpointing,
)
from denormalized_tpu_torch.state.orchestrator import Orchestrator

T0 = 1_700_000_000_000
SCHEMA = Schema([Field("ts", DataType.INT64, nullable=False),
                 Field("k", DataType.INT64, nullable=False),
                 Field("v", DataType.FLOAT64)])


def builtin_aggs():
    c = tt.col("v")
    return [F.count(c).alias("count"), F.min(c).alias("min"),
            F.max(c).alias("max"), F.avg(c).alias("average"),
            F.stddev(c).alias("sd")]


def udaf_aggs():
    return builtin_aggs() + [F.array_agg(tt.col("v")).alias("arr")]


def batch(keys, ts, vals):
    return attach_canonical_timestamp(
        RecordBatch(SCHEMA, [np.asarray(ts, np.int64),
                             np.asarray(keys, np.int64),
                             np.asarray(vals, np.float64)]),
        "ts", fallback_ms=T0)


def session_op(path, aggs, gap_ms=10**9, budget=None):
    """A checkpointed session operator (the bigstate soak's shape: int64
    keys, one float column), under ``budget`` bytes with the cold tier,
    and its coordinator, fed by hand."""
    ctx = tt.Context(tt.EngineConfig(
        device="cpu", checkpoint=True, checkpoint_interval_s=9999,
        state_backend_path=str(path), state_budget_bytes=budget))
    ds = ctx.from_source(MemorySource.from_batches(
        [batch([0], [T0], [0.0])], timestamp_column="ts"), name="snap",
    ).session_window(["k"], aggs(), gap_ms)
    root = executor.build_physical(lp.Sink(ds._plan, CollectSink()), ctx)
    if budget:
        tiering.attach_spill(root, ctx)
    coord = wire_checkpointing(root, ctx, Orchestrator(interval_s=9999))
    stack = [root]
    while stack:
        op = stack.pop()
        if isinstance(op, session_exec.SessionWindowExec):
            return op, coord
        stack.extend(op.children)
    raise AssertionError("no session operator in the plan")


def feed(op, n_keys, seed=3, rounds=2):
    """``n_keys`` open sessions, some of several rows, in seeded order."""
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        keys = rng.permutation(n_keys) + 10_000_000_000
        ts = T0 + r * 1000 + rng.integers(0, 1000, n_keys)
        vals = np.round(rng.normal(50.0, 10.0, n_keys), 3)
        list(op._process_batch(batch(keys, ts, vals)))


def whole_document(op, epoch) -> bytes:
    """The document as the operator built it before its chunks: a list
    a resident session, then one ``json.dumps`` of the whole."""
    T = op._table
    live = T.live_slots()
    live = live[np.lexsort((T.gid[live], T.start[live]))]
    key_cols = op._interner.keys_of(T.gid[live])
    sessions = []
    for i, s in enumerate(live.tolist()):
        sessions.append([
            [key_cols[c][i] for c in range(len(key_cols))],
            int(T.start[s]), int(T.last[s]),
            {"count": int(T.row_count[s]),
             "counts": [int(x) for x in T.counts[s]],
             "sums": [float(x) for x in T.sums[s]],
             "mins": [float(x) for x in T.mins[s]],
             "maxs": [float(x) for x in T.maxs[s]],
             "means": [float(x) for x in T.means[s]],
             "m2s": [float(x) for x in T.m2s[s]]},
            [acc.state() for acc in T.accs[s]] if s in T.accs else None,
        ])
    snap = {"epoch": epoch, "watermark": op._watermark, "sessions": sessions}
    if op._tier is not None and op._tier.any_spilled:
        snap["spill_blocks"] = sorted(op._tier._blocks)
    return json.dumps(jsonable(snap)).encode()


def stored(coord, op, epoch) -> bytes:
    ok, payload = unframe_snapshot(
        coord.backend.get(f"{op._ckpt[1]}@{epoch}"))
    assert ok
    return payload


@pytest.mark.parametrize("aggs", [builtin_aggs, udaf_aggs],
                         ids=["builtin", "udaf"])
@pytest.mark.parametrize("n_keys", [0, 1, session_exec.SNAPSHOT_CHUNK,
                                    2 * session_exec.SNAPSHOT_CHUNK + 7])
def test_chunked_document_is_the_whole_document(tmp_path, aggs, n_keys):
    """Across chunk edges (none, one session, exactly one chunk, two and
    a part): the stored document is byte for byte ``json.dumps`` of the
    whole document built a session at a time, and it restores a table
    equal slot for slot that checkpoints the same bytes again."""
    try:
        op, coord = session_op(tmp_path, aggs)
        feed(op, n_keys)
        op._snapshot(7)
        doc = stored(coord, op, 7)
        assert doc == whole_document(op, 7)
        snap = json.loads(doc)
        assert len(snap["sessions"]) == n_keys
        T = op._table
        live = T.live_slots()
        live = live[np.lexsort((T.gid[live], T.start[live]))]
        for entry, s in zip(snap["sessions"], live.tolist()):
            assert entry[1:3] == [int(T.start[s]), int(T.last[s])]
            assert entry[3]["count"] == int(T.row_count[s])
            assert entry[3]["sums"] == [float(x) for x in T.sums[s]]
            assert entry[3]["m2s"] == [float(x) for x in T.m2s[s]]
            assert (entry[4] is None) == (aggs is builtin_aggs)
        coord.commit(7)
        lsm.close_global_state_backend()
        op2, coord2 = session_op(tmp_path, aggs)
        assert get_json(coord2, op2._ckpt[1]) == snap
        T2 = op2._table
        live2 = T2.live_slots()
        live2 = live2[np.lexsort((T2.gid[live2], T2.start[live2]))]
        for name in ("start", "last", "row_count", "counts", "sums",
                     "mins", "maxs", "means", "m2s"):
            np.testing.assert_array_equal(getattr(T2, name)[live2],
                                          getattr(T, name)[live])
        np.testing.assert_array_equal(
            op2._interner.keys_of(T2.gid[live2])[0],
            op._interner.keys_of(T.gid[live])[0])
        op2._snapshot(8)
        assert stored(coord2, op2, 8) == doc.replace(
            b'{"epoch": 7', b'{"epoch": 8', 1)
    finally:
        lsm.close_global_state_backend()


def test_checkpoint_transient_is_bounded(tmp_path):
    """A checkpoint over 50,000 resident sessions allocates at its peak at
    most 4x the document's bytes (the pieces, the framed blob, the
    store's copy) plus one chunk's objects at 2,600 B a session.  The
    per-session lists and dicts of the whole document, and their
    ``jsonable`` copy, took ~2,560 B a session at once: 128 MB here, where
    the bound is ~37 MB."""
    n = 50_000
    try:
        op, coord = session_op(tmp_path, builtin_aggs)
        feed(op, n, rounds=1)
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            op._snapshot(1)
            peak = tracemalloc.get_traced_memory()[1] - before
        finally:
            tracemalloc.stop()
        doc_bytes = op.last_snapshot_bytes
        assert len(json.loads(stored(coord, op, 1))["sessions"]) == n
        bound = 4 * doc_bytes + session_exec.SNAPSHOT_CHUNK * 2600
        assert peak <= bound, (peak, bound, doc_bytes)
    finally:
        lsm.close_global_state_backend()


def _chains(T: SessionTable, gids) -> dict:
    """Every gid's open sessions in chain order, by value."""
    out = {}
    for g in gids:
        slots, _ = T.open_slots_of(np.array([g]))
        out[g] = [(int(T.start[s]), int(T.last[s]), int(T.row_count[s]),
                   T.sums[s].tolist(), T.accs.get(int(s)))
                  for s in slots.tolist()]
    return out


@pytest.mark.parametrize("keep", [0, 1, 100, 1500])
def test_shrink_to_fit_keeps_every_chain_and_accumulator(keep):
    """4,000 sessions over 3,000 gids (4,096 slots), all but ``keep``
    removed: the table shrinks to the least power of two holding twice
    the live slots (at least 1,024) where that halves it, each gid's chain
    reads the same sessions in the same order with their accumulators,
    and new slots follow the live ones."""
    rng = np.random.default_rng(keep)
    T = SessionTable(2)
    T.ensure_gids(3000)
    slots = T.alloc(4000)
    gids = rng.integers(0, 3000, 4000)
    T.start[slots] = rng.integers(0, 10**6, 4000)
    T.last[slots] = T.start[slots] + 5
    T.row_count[slots] = rng.integers(1, 9, 4000)
    T.sums[slots] = rng.normal(size=(4000, 2))
    T.gid[slots] = gids
    T.live[slots] = True
    T.chain(gids.astype(np.int64), slots)
    T.accs = {int(s): [f"acc{int(s)}"] for s in slots[::7].tolist()}
    T.remove_slots(rng.permutation(slots)[keep:])
    before = _chains(T, range(3000))
    T.shrink_to_fit()
    assert len(T) == keep
    assert _chains(T, range(3000)) == before
    if keep > 1024:  # 2 x 1,500 needs all 4,096: nothing to free
        assert len(T.start) == 4096
        return
    assert len(T.start) == max(1024, 1 << max(2 * keep - 1, 1).bit_length())
    assert T.live_slots().tolist() == list(range(keep))
    assert T.alloc(3).tolist() == [keep, keep + 1, keep + 2]


def test_budgeted_table_follows_the_resident_sessions(tmp_path):
    """40,960 keys in 10 batches under a 2 MB budget: the first batches
    stay resident (~14,000 sessions, 16,384 slots), then the interned
    keys' estimate passes the budget and the tier spills all but the
    batch in hand; the table's arrays then hold twice that batch, not the
    high-water mark."""
    try:
        op, _coord = session_op(tmp_path, builtin_aggs, budget=2_000_000)
        rng = np.random.default_rng(5)
        for b in range(10):
            keys = np.arange(b * 4096, (b + 1) * 4096) + 10_000_000_000
            ts = T0 + b * 4096 + np.arange(4096)
            list(op._process_batch(batch(keys, ts, rng.normal(size=4096))))
        T = op._table
        assert op._tier.spilled_keys > 30_000
        assert len(T) <= 4096
        assert len(T.start) <= 8192, (len(T), len(T.start))
    finally:
        lsm.close_global_state_backend()

