"""Skew-adaptive join, JAX package vs the port: twins of
``tests/test_join_adaptive.py``.

The side-state twins drive the JAX package's and the port's
``_HotStore``/``_SideState`` with the same operations and hold the pairs
they produce to the SAME ORDER (probe-major, newest build row first per
probe row) before adaptation, while adapted and after folding.  The
end-to-end twins run a skewed feed through both packages with the policy
live and hold the port's rows to the JAX package's as sorted row sets, and
to the port's own unadapted run."""

from types import SimpleNamespace

import numpy as np

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.constants import CANONICAL_TIMESTAMP_COLUMN as JTS
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical import plan as jlp
from denormalized_tpu.physical import join_exec as jje
from denormalized_tpu.physical.simple_execs import CollectSink as JSink
from denormalized_tpu.runtime import executor as jexec
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN as TTS
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.obs.doctor import actions as tactions
from denormalized_tpu_torch.physical import join_exec as tje
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000
PKGS = ("jax", "torch")


def ns(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        return SimpleNamespace(
            Schema=JSchema, Field=JField, DT=JType, Batch=JBatch,
            Source=JSource, lp=jlp, Sink=JSink, executor=jexec, je=jje,
            TS=JTS, ctx=lambda **kw: jt.Context(JConfig(**kw)),
            side=lambda: jje._SideState(False),
        )
    return SimpleNamespace(
        Schema=TSchema, Field=TField, DT=TType, Batch=TBatch,
        Source=TSource, lp=tlp, Sink=TSink, executor=texec, je=tje,
        TS=TTS, ctx=lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)),
        side=tje._SideState,
    )


# -- _HotStore and _SideState, driven directly: exact order ----------------


def _hot_store_script(p):
    hs = p.je._HotStore()
    hs.adopt(5, np.array([10, 20, 30], dtype=np.int64))
    hs.adopt(9, np.array([40], dtype=np.int64))
    out = [hs.contains(5), hs.contains(9), hs.contains(6), hs.rows_total()]
    hs.append(int(hs.lookup[5]), np.array([50, 60], dtype=np.int64))
    slots = hs.slot_of(np.array([5, 9, 5]))
    pp, bb = hs.probe_pairs(slots, np.arange(3, dtype=np.int64))
    out += [slots.tolist(), pp.tolist(), bb.tolist()]
    out += [hs.remove(9).tolist(), hs.contains(9), hs.nslots, hs.reps()]
    return out


def test_hot_store_adopt_append_remove_probe():
    j, t = (_hot_store_script(ns(pkg)) for pkg in PKGS)
    assert j == t
    assert t[5] == [0, 0, 0, 0, 0, 1, 2, 2, 2, 2, 2]
    assert t[6] == [60, 50, 30, 20, 10, 40, 60, 50, 30, 20, 10]


def _relocation_script(p):
    hs = p.je._HotStore()
    rng = np.random.default_rng(0)
    for gid in range(6):
        hs.adopt(gid, np.arange(gid * 1000, gid * 1000 + 3, dtype=np.int64))
    for step in range(50):
        for gid in range(6):
            hs.append(
                int(hs.lookup[gid]),
                np.arange(10_000 + step * 100 + gid * 10,
                          10_000 + step * 100 + gid * 10 + 7, dtype=np.int64),
            )
        if step % 11 == 0 and step:
            hs.remove(rng.integers(0, 6))
            hs.adopt(
                int(rng.integers(0, 6)) if not hs.contains(
                    int(rng.integers(0, 6))
                ) else 100 + step,
                np.arange(step, step + 2, dtype=np.int64),
            )
    blocks = {}
    for s in range(hs.nslots):
        ln = int(hs.slot_len[s])
        blk = hs.pool[hs.slot_start[s]: hs.slot_start[s] + ln]
        assert (np.diff(blk) > 0).all()  # ascending invariant
        assert int(hs.lookup[hs.slot_gid[s]]) == s
        blocks[int(hs.slot_gid[s])] = blk.tolist()
    return blocks, hs.used, len(hs.pool)


def test_hot_store_relocation_and_compaction():
    j, t = (_relocation_script(ns(pkg)) for pkg in PKGS)
    assert j == t


def _mk_side(p, rows_by_batch):
    side = p.side()
    schema = p.Schema([
        p.Field(p.TS, p.DT.TIMESTAMP_MS, nullable=False),
        p.Field("v", p.DT.INT64),
    ])
    k = 0
    for gids in rows_by_batch:
        g = np.asarray(gids, dtype=np.int32)
        rb = p.Batch(schema, [np.full(len(g), T0, dtype=np.int64),
                              np.arange(k, k + len(g), dtype=np.int64)])
        side.insert(rb, g)
        k += len(g)
    return side


def _probe_script(p):
    batches = [[7, 3, 7, 5], [3, 7, 7], [5, 7, 3, 9]]
    probe = np.array([7, 3, 9, 7, 2, 5], dtype=np.int32)
    side = _mk_side(p, batches)
    runs = [side.probe(probe)]
    side.adapt(7)
    runs.append(side.probe(probe))
    side.adapt(3)
    runs.append(side.probe(probe))
    side.fold(7)
    runs.append(side.probe(probe))
    return [(a.tolist(), b.tolist()) for a, b in runs]


def test_probe_order_identical_across_adapt_and_fold():
    """Cold-only, hot-only and mixed probes: the same pairs in the same
    order before adaptation, while adapted and after folding, in both
    packages."""
    j, t = (_probe_script(ns(pkg)) for pkg in PKGS)
    assert j == t
    base_p, base_b = t[0]
    assert all(r == t[0] for r in t)
    assert (np.diff(base_p) >= 0).all()
    for pi in set(base_p):
        bs = [b for q, b in zip(base_p, base_b) if q == pi]
        assert (np.diff(bs) < 0).all(), bs


def _append_script(p):
    side = _mk_side(p, [[4, 4, 1]])
    side.adapt(4)
    g = np.asarray([4, 1, 4], dtype=np.int32)
    schema = p.Schema([
        p.Field(p.TS, p.DT.TIMESTAMP_MS, nullable=False),
        p.Field("v", p.DT.INT64),
    ])
    side.insert(p.Batch(schema, [np.full(3, T0, dtype=np.int64),
                                 np.arange(3, dtype=np.int64)]), g)
    probe = np.array([4, 1], dtype=np.int32)
    got = side.probe(probe)
    want = _mk_side(p, [[4, 4, 1], [4, 1, 4]]).probe(probe)
    return side.hot.rows_total(), [x.tolist() for x in got], \
        [x.tolist() for x in want]


def test_adapted_inserts_append_to_block_and_keep_order():
    j, t = (_append_script(ns(pkg)) for pkg in PKGS)
    assert j == t
    rows, got, want = t
    assert rows == 4 and got == want


# -- end to end over a skewed feed ------------------------------------------


def _skewed_feed(seed, nb=17, rows=300, hot_share=0.25, keys=30):
    rng = np.random.default_rng(seed)
    t = T0
    out = []
    for _ in range(nb):
        ts = t + np.arange(rows, dtype=np.int64)
        t += rows
        hot = rng.random(rows) < hot_share
        ks = np.where(
            hot, "celebrity", rng.integers(0, keys, rows).astype(str)
        ).astype(object)
        out.append((ts, ks, rng.random(rows)))
    return out


def _join_root(p, adaptive, retention=10**9, **feed_kw):
    ctx = p.ctx(join_adaptive=adaptive, join_adapt_interval_s=0.0,
                join_retention_ms=retention)
    LS = p.Schema([p.Field("ts", p.DT.TIMESTAMP_MS, nullable=False),
                   p.Field("k", p.DT.STRING, nullable=False),
                   p.Field("v", p.DT.FLOAT64)])
    RS = p.Schema([p.Field("ts2", p.DT.TIMESTAMP_MS, nullable=False),
                   p.Field("k2", p.DT.STRING, nullable=False),
                   p.Field("w", p.DT.FLOAT64)])
    L = [p.Batch(LS, list(b)) for b in _skewed_feed(1, **feed_kw)]
    R = [p.Batch(RS, list(b)) for b in _skewed_feed(2, **feed_kw)]
    left = ctx.from_source(p.Source.from_batches(L, timestamp_column="ts"),
                           name="al")
    right = ctx.from_source(p.Source.from_batches(R, timestamp_column="ts2"),
                            name="ar")
    sink = p.Sink()
    ds = left.join(right, "inner", ["k"], ["k2"])
    root = p.executor.build_physical(p.lp.Sink(ds._plan, sink), ctx)
    return root, sink


def _collect(p, adaptive, retention=10**9, reintern_min=None, **feed_kw):
    root, sink = _join_root(p, adaptive, retention, **feed_kw)
    join_op = root.input_op
    if reintern_min is not None:
        join_op._reintern_min = reintern_min
    for _ in root.run():
        pass
    res = sink.result()
    rows = sorted(zip(
        np.asarray(res.column("ts")).tolist(),
        [str(x) for x in np.asarray(res.column("k"), dtype=object)],
        np.asarray(res.column("v")).tolist(),
        np.asarray(res.column("ts2")).tolist(),
        np.asarray(res.column("w")).tolist(),
    ))
    return rows, join_op


def test_adaptive_join_identical_to_static_oracle():
    """The port's policy adapts the celebrity key live, and its output
    equals its own unadapted run and the JAX package's adapted run."""
    p = ns("torch")
    events = []
    orig = tactions.JoinAdaptationPolicy._record

    def rec(self, op, side_id, action, gid, share):
        events.append((action, side_id))
        return orig(self, op, side_id, action, gid, share)

    tactions.JoinAdaptationPolicy._record = rec
    try:
        adapted, op = _collect(p, True)
    finally:
        tactions.JoinAdaptationPolicy._record = orig
    static, _ = _collect(p, False)
    jax_rows, jop = _collect(ns("jax"), True)
    assert ("adapt", 0) in events or ("adapt", 1) in events
    assert op._policy.counts["adapt"] >= 1
    assert adapted == static == jax_rows
    assert len(adapted) > 0


def test_adaptive_join_with_eviction_matches_static():
    """Eviction rebuilds renumber rows while keys are hot.  Pairs at the
    retention edge depend on the pump interleave by design, so the
    interleave-independent core is compared: every pair within half the
    retention, in both layouts and both packages."""
    retention = 1_200

    def core(rows):
        return [r for r in rows if abs(r[0] - r[3]) <= retention // 2]

    a, _ = _collect(ns("torch"), True, retention, nb=14)
    s, _ = _collect(ns("torch"), False, retention, nb=14)
    j, _ = _collect(ns("jax"), True, retention, nb=14)
    assert len(core(a)) > 1000
    assert core(a) == core(s) == core(j)


def test_reintern_keeps_hot_keys():
    """A re-intern renumbers gids; hot blocks survive via representative
    rows and the output stays identical."""
    def core(rows):
        return sorted((r[1], round(r[2], 9), round(r[4], 9))
                      for r in rows if abs(r[0] - r[3]) <= 700)

    kw = dict(retention=1500, reintern_min=64, nb=24, keys=200)
    a, op = _collect(ns("torch"), True, **kw)
    s, _ = _collect(ns("torch"), False, **kw)
    j, _ = _collect(ns("jax"), True, **kw)
    assert len(op._interner) < 30 * 300  # re-keyed (bounded)
    assert core(a) == core(s) == core(j)


def test_state_info_counts_hot_bytes():
    _, op = _collect(ns("torch"), True)
    info = op.state_info()
    assert info["hot_keys"] >= 1
    assert info["hot_bytes"] > 0
    assert info["adaptations"]["total"] >= 1
    assert info["adaptations"]["by_action"]["adapt"] >= 1
    sides = info["sides"]
    assert info["hot_bytes"] == (
        sides["left"]["hot_bytes"] + sides["right"]["hot_bytes"]
    )
    assert info["hot_bytes"] < info["state_bytes"]
    # the retained rows and keys agree with the JAX package's accounting
    _, jop = _collect(ns("jax"), True)
    jinfo = jop.state_info()
    for k in ("slot_live", "live_keys", "interner_keys_total"):
        assert info[k] == jinfo[k], k


def test_policy_adapts_and_keeps_the_output_core():
    """The policy adapts the celebrity on the sketch every batch feeds, and
    the output's interleave-independent core (pairs within half the
    retention) equals the unadapted run's."""
    retention = 400  # the celebrity's pairs grow with the retention
    rows, op = _collect(ns("torch"), True, retention, nb=60)
    assert op._policy.adaptations_total >= 1
    static, _ = _collect(ns("torch"), False, retention, nb=60)

    def core(rs):
        return [r for r in rs if abs(r[0] - r[3]) <= retention // 2]

    assert core(rows) == core(static)


def test_sketches_match_the_jax_package():
    """The port's windowed Space-Saving sketch gives the JAX package's top
    keys, counts, error bounds and total on the same gid stream, across
    decay steps and sampled batches."""
    from denormalized_tpu.obs import statewatch as jsw
    from denormalized_tpu_torch.obs import statewatch as tsw

    rng = np.random.default_rng(5)
    j = jsw.StateWatch("join", decay_every=jsw.JOIN_SKETCH_DECAY_ROWS)
    t = tsw.StateWatch("join", decay_every=tsw.JOIN_SKETCH_DECAY_ROWS)
    for i in range(60):
        n = 20_000 if i % 2 else 3000  # every other batch is sampled
        g = np.where(rng.random(n) < 0.3, 7,
                     rng.integers(0, 5000, n)).astype(np.int32)
        j.update(g)
        t.update(g)
    assert t.sketch.total == j.sketch.total
    assert t.sketch.total < 60 * 11_500  # the decay steps ran
    for a, b in zip(j.sketch.top(64), t.sketch.top(64)):
        assert a.tolist() == b.tolist()
