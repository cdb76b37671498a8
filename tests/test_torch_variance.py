"""The variance family (``stddev``, ``stddev_pop``, ``var``, ``var_pop`` and
the aliases ``stddev_samp``, ``var_samp``, ``var_sample``) in the port's
window operator, held against the JAX package and a numpy float64 oracle.

Each variance argument rides the ring as two value columns, (x − K) and
(x − K)², for a pivot K taken from the first finite value seen; the host
finalizes in f64 (``segment_agg.variance_result``).  Twins of
``tests/test_functions.py:260`` (the family against numpy at the JAX
test's own 2e-2 / 4e-2: f32 moments) and of the windowed half of ``:305``
(epoch-magnitude values, σ = 1000); the port against the JAX package at
rtol=1e-4 on the same seeded batches (both shift by the same K; sums fold
in another order) through the scatter path, the dense kernel's plain
version and ``partial_merge``, tumbling and sliding, with nulls; and a
variance window's snapshot, pivots included, restored across packages.
"""

from __future__ import annotations

import shutil
from types import SimpleNamespace

import numpy as np
import pytest

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical import plan as jlp
from denormalized_tpu.physical.base import Marker as JMarker
from denormalized_tpu.physical.simple_execs import CollectSink as JSink
from denormalized_tpu.runtime import executor as jexec
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu.state import lsm as jlsm
from denormalized_tpu.state.checkpoint import wire_checkpointing as jwire
from denormalized_tpu.state.orchestrator import Orchestrator as JOrch
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.physical.base import Marker as TMarker
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state import lsm as tlsm
from denormalized_tpu_torch.state.checkpoint import wire_checkpointing as twire
from denormalized_tpu_torch.state.orchestrator import Orchestrator as TOrch

T0 = 1_700_000_000_000
KINDS = ("sd", "sdp", "va", "vp")
PORT_STRATEGIES = ("scatter", "auto", "partial_merge")


def api(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        return SimpleNamespace(
            ctx=lambda **kw: jt.Context(JConfig(**kw)), Schema=JSchema,
            Field=JField, DT=JType, Batch=JBatch, Source=JSource, F=JF,
            col=jt.col, lp=jlp, Sink=JSink, executor=jexec, wire=jwire,
            Orch=JOrch, Marker=JMarker, close=jlsm.close_global_state_backend,
        )
    return SimpleNamespace(
        ctx=lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)),
        Schema=TSchema, Field=TField, DT=TType, Batch=TBatch, Source=TSource,
        F=TF, col=tt.col, lp=tlp, Sink=TSink, executor=texec, wire=twire,
        Orch=TOrch, Marker=TMarker, close=tlsm.close_global_state_backend,
    )


def feed(seed, n_batches=6, n=2048, span=500, keys=4, loc=50.0, scale=10.0,
         null_share=0.0):
    """Seeded (ts, key, value, valid) batches: sorted event times over
    ``span`` ms a batch, keys g0.., normal(loc, scale) values, a share of
    them null (their slot holding garbage, which must never count)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * span + rng.integers(0, span, n)).astype(np.int64)
        ks = np.array([f"g{i}" for i in rng.integers(0, keys, n)], dtype=object)
        vs = loc + rng.normal(0.0, scale, n)
        valid = rng.random(n) >= null_share
        vs[~valid] = rng.choice([np.nan, 1e30, -7.0], int((~valid).sum()))
        out.append((ts, ks, vs, valid))
    return out


def batches_of(p, raw):
    schema = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                       p.Field("k", p.DT.STRING, nullable=False),
                       p.Field("v", p.DT.FLOAT64)])
    return [p.Batch(schema, [ts, k, v],
                    None if valid.all() else [None, None, valid])
            for ts, k, v, valid in raw]


def variance_aggs(p):
    c, F = p.col("v"), p.F
    return [F.stddev(c).alias("sd"), F.stddev_pop(c).alias("sdp"),
            F.var(c).alias("va"), F.var_pop(c).alias("vp"),
            F.count(c).alias("n"), F.avg(c).alias("mean")]


def window_job(p, ctx, raw, length=1000, slide=None, aggs=variance_aggs):
    return ctx.from_source(
        p.Source.from_batches(batches_of(p, raw), timestamp_column="ts"),
        name="var_src",
    ).window(["k"], aggs(p), length, slide)


def rows(res, names=("n", "mean") + KINDS) -> dict:
    return {
        (int(ws), str(k)): tuple(float(res.column(c)[i]) for c in names)
        for i, (ws, k) in enumerate(zip(res.column("window_start_time"),
                                         res.column("k")))
    }


def run(pkg, raw, length=1000, slide=None, **cfg):
    p = api(pkg)
    return rows(window_job(p, p.ctx(**cfg), raw, length, slide).collect())


def oracle(raw, length=1000, slide=None) -> dict:
    """(window start, key) → (count, mean, sample sd, pop sd, sample var,
    pop var) in float64 over the valid values."""
    slide = slide or length
    k = -(-length // slide)
    groups: dict = {}
    for ts, ks, vs, valid in raw:
        for t, key, v, ok in zip(ts.tolist(), ks.tolist(), vs.tolist(),
                                 valid.tolist()):
            u, rem = divmod(t, slide)
            for i in range(k):
                if rem < length - i * slide:
                    g = groups.setdefault(((u - i) * slide, key), [])
                    if ok:
                        g.append(v)
    out = {}
    for key, vals in groups.items():
        a = np.asarray(vals, dtype=np.float64)
        n = len(a)
        with np.errstate(invalid="ignore", divide="ignore"):
            out[key] = (
                float(n), a.mean() if n else np.nan,
                np.std(a, ddof=1) if n > 1 else np.nan,
                np.std(a) if n else np.nan,
                np.var(a, ddof=1) if n > 1 else np.nan,
                np.var(a) if n else np.nan,
            )
    return out


def assert_close(got: dict, want: dict, rtol: dict) -> None:
    """Same rows; counts exact; each float column to its rtol (NaN where
    NaN)."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    names = ("n", "mean") + KINDS
    for key, w in want.items():
        g = got[key]
        assert g[0] == w[0], key
        for name, x, y in zip(names[1:], g[1:], w[1:]):
            np.testing.assert_allclose(x, y, rtol=rtol[name], atol=0,
                                       equal_nan=True, err_msg=f"{key} {name}")


NUMPY_RTOL = {"mean": 1e-5, "sd": 2e-2, "sdp": 2e-2, "va": 4e-2, "vp": 4e-2}
JAX_RTOL = {"mean": 1e-5, "sd": 1e-4, "sdp": 1e-4, "va": 1e-4, "vp": 1e-4}


@pytest.fixture(scope="module")
def family_feed():
    raw = feed(3)
    return raw, {s: run("jax", raw, device_strategy=s)
                 for s in ("scatter", "partial_merge")}


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_variance_family_matches_numpy_and_jax(family_feed, strategy):
    """Twin of tests/test_functions.py:260 through each port strategy:
    against numpy at the JAX test's tolerances, against the JAX package's
    scatter and partial_merge runs at rtol=1e-4."""
    raw, jax_rows = family_feed
    got = run("torch", raw, device_strategy=strategy)
    assert len(got) > 4
    assert_close(got, oracle(raw), NUMPY_RTOL)
    for s, want in jax_rows.items():
        assert_close(got, want, JAX_RTOL)


def test_aliases_build_the_sample_kinds():
    c = tt.col("v")
    assert TF.stddev_samp(c).kind == TF.stddev(c).kind == "stddev"
    assert TF.var_samp(c).kind == TF.var_sample(c).kind == "var"
    assert TF.var_pop(c).kind == "var_pop" and TF.stddev_pop(c).kind == "stddev_pop"
    for f in (TF.stddev, TF.stddev_pop, TF.var, TF.var_pop):
        assert f(c).out_field(None).dtype == TType.FLOAT64


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_variance_stable_at_epoch_magnitude(strategy):
    """The windowed half of tests/test_functions.py:305: values ~1.7e12
    with σ = 1000.  The naive s2 − s²/c cancels to 0 at this magnitude;
    the pivot-shifted moments keep the spread on every strategy."""
    raw = feed(7, n_batches=4, keys=1, loc=1.7e12, scale=1000.0)
    p = api("torch")
    res = window_job(p, p.ctx(device_strategy=strategy), raw,
                     aggs=lambda p: [p.F.stddev(p.col("v")).alias("sd")]
                     ).collect()
    assert res.num_rows >= 2
    for sd in res.column("sd").tolist():
        assert 800.0 < sd < 1200.0, f"variance collapsed: {sd}"


@pytest.mark.parametrize("strategy", PORT_STRATEGIES)
def test_sliding_variance_with_nulls(strategy):
    """A 1 s / 250 ms sliding window with a fifth of the values null
    (NaN, 1e30 and -7 behind the mask): the null rows count nowhere, the
    pivot comes from the first VALID finite value, and the rows match
    numpy and the JAX package's partial_merge run."""
    raw = feed(11, n_batches=5, n=1024, keys=3, null_share=0.2)
    got = run("torch", raw, 1000, 250, device_strategy=strategy)
    assert_close(got, oracle(raw, 1000, 250), NUMPY_RTOL)
    assert_close(got, run("jax", raw, 1000, 250,
                          device_strategy="partial_merge"), JAX_RTOL)


def test_variance_helpers_match_the_jax_package():
    """variance_result, variance_from_m2 and chan_merge against the JAX
    package's on seeded moments, shifted by a pivot."""
    from denormalized_tpu.ops import segment_agg as jsa

    rng = np.random.default_rng(2)
    x = rng.normal(1e6, 5.0, (6, 40))
    K = x[0, 0]
    c = np.full(6, 40.0)
    c[0], c[1] = 0.0, 1.0
    s = ((x - K) * (c[:, None] > np.arange(40))).sum(1)
    s2 = (((x - K) ** 2) * (c[:, None] > np.arange(40))).sum(1)
    for kind in ("stddev", "stddev_pop", "var", "var_pop"):
        np.testing.assert_array_equal(
            sa.variance_result(kind, c, s, s2),
            jsa.variance_result(kind, c, s, s2))
        np.testing.assert_array_equal(
            sa.variance_from_m2(kind, c, s2), jsa.variance_from_m2(kind, c, s2))
    a, b = x[2, :17], x[2, 17:]
    got = sa.chan_merge(len(a), a.mean(), ((a - a.mean()) ** 2).sum(),
                        len(b), b.mean(), ((b - b.mean()) ** 2).sum())
    assert got == jsa.chan_merge(len(a), a.mean(), ((a - a.mean()) ** 2).sum(),
                                 len(b), b.mean(), ((b - b.mean()) ** 2).sum())
    assert got[2] == pytest.approx(((x[2] - x[2].mean()) ** 2).sum(), rel=1e-9)
    assert sa.chan_merge(0, 0.0, 0.0, 0, 0.0, 0.0) == (0.0, 0.0, 0.0)


def test_components_and_finals_match_the_jax_package():
    from denormalized_tpu.ops import segment_agg as jsa

    specs = [("stddev", 1, 2), ("avg", 0), ("var_pop", 1, 2), ("min", 0)]
    assert [(c.kind, c.col) for c in sa.components_for(specs)] == [
        (c.kind, c.col) for c in jsa.components_for(specs)]
    assert not sa.finals_possible(tuple(specs))
    assert sa.finals_possible((("avg", 0), ("count", None)))


# -- a variance window's snapshot across packages -------------------------------


def crash_after_commit(p, ctx, ds, at=3):
    root = p.executor.build_physical(p.lp.Sink(ds._plan, p.Sink()), ctx)
    orch = p.Orch(interval_s=9999)
    coord = p.wire(root, ctx, orch)
    it = root.run()
    out, committed = [], False
    for i, item in enumerate(it):
        if isinstance(item, (JBatch, TBatch)):
            out.append(item)
        if i == at:
            orch.trigger_now()
        if isinstance(item, p.Marker):
            coord.commit(item.epoch)
            committed = True
            break
    it.close()
    orch.stop()
    p.close()
    assert committed
    return out


def restore_and_run(p, ctx, ds):
    root = p.executor.build_physical(p.lp.Sink(ds._plan, p.Sink()), ctx)
    orch = p.Orch(interval_s=9999)
    coord = p.wire(root, ctx, orch)
    assert coord.committed_epoch is not None
    window = root
    while type(window).__name__ != "StreamingWindowExec":
        (window,) = window.children
    shift = dict(window._var_shift)
    out = [i for i in root.run() if isinstance(i, (JBatch, TBatch))]
    orch.stop()
    p.close()
    return out, shift


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_variance_snapshot_restores_across_packages(tmp_path, writer):
    """One package crashes a variance window after a committed barrier;
    each package restores a copy of the store.  The restored operator
    holds the writer's pivot (``var_shift``) before its first batch, both
    restored runs emit the same rows (rtol=1e-4), and with the crashed
    run's rows they match the numpy oracle."""
    raw = feed(19, n_batches=24, n=256, span=250, keys=5, loc=1e6, scale=3.0)
    ckpt = dict(checkpoint=True, checkpoint_interval_s=9999, emit_lag_ms=0,
                device_strategy="scatter")
    w = api(writer)
    path = str(tmp_path / "state")
    ctx = w.ctx(state_backend_path=path, **ckpt)
    a = crash_after_commit(w, ctx, window_job(w, ctx, raw))
    copy = str(tmp_path / "state_copy")
    shutil.copytree(path, copy)
    got, shifts = {}, {}
    for pkg, store in (("jax", path), ("torch", copy)):
        p = api(pkg)
        ctx = p.ctx(state_backend_path=store, **ckpt)
        out, shifts[pkg] = restore_and_run(p, ctx, window_job(p, ctx, raw))
        got[pkg] = {}
        for b in out:
            got[pkg].update(rows(b))
    # the pivot is the first value of the stream, under the argument's repr
    assert shifts["jax"] == shifts["torch"]
    assert list(shifts["torch"].values()) == [raw[0][2][0]]
    assert got["jax"] and set(got["jax"]) == set(got["torch"])
    assert_close(got["torch"], got["jax"], JAX_RTOL)
    both = {}
    for b in a:
        both.update(rows(b))
    both.update(got["torch"])
    want = oracle(raw)
    assert_close(both, want, NUMPY_RTOL)
