"""Band (interval) joins and ``join_on``, JAX package vs the port: the same
seeded batches through ``denormalized_tpu`` and ``denormalized_tpu_torch``
(``EngineConfig(device="cpu")``) must emit the same rows, and both must
equal a brute-force nested-loop oracle.

Twins of ``tests/test_join_interval.py`` (:96-278, including the seeded
nested-loop differential at :204 and the retention-edge case at :278, and
band-aware eviction with ``join_band_slack_ms`` set and unset) and of
``tests/test_join.py`` :303, :364 and :389 (expression keys and a residual,
a pure theta join refused, shared key names), plus config 4 as
``examples/stream_join.py --expressions`` writes it, at a small size.

Rows are compared as sorted row sets (two pump threads interleave at
random).  Keys, timestamps and integer values must match exactly; window
averages within rtol=1e-5 (f32 sums in another order).
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

import numpy as np
import pytest

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.errors import PlanError as JPlanError
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical.optimizer import optimize as joptimize
from denormalized_tpu.physical.join_exec import StreamingJoinExec as JJoin
from denormalized_tpu.runtime import pump as jpump
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.common.errors import PlanError as TPlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical.optimizer import optimize as toptimize
from denormalized_tpu_torch.physical.join_exec import StreamingJoinExec as TJoin
from denormalized_tpu_torch.runtime import pump as tpump
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

T0 = 1_700_000_000_000
PKGS = ("jax", "torch")
AVG_RTOL = 1e-5


def ns(pkg: str, **cfg) -> SimpleNamespace:
    cfg.setdefault("join_retention_ms", 10**9)
    cfg.setdefault("join_adaptive", True)
    cfg.setdefault("join_adapt_interval_s", 0.0)
    if pkg == "jax":
        return SimpleNamespace(
            ctx=jt.Context(JConfig(**cfg)), Schema=JSchema, Field=JField,
            DT=JType, Batch=JBatch, Source=JSource, F=JF, col=jt.col,
            lit=jt.lit, PlanError=JPlanError, Join=JJoin, optimize=joptimize,
            pump=jpump,
        )
    return SimpleNamespace(
        ctx=tt.Context(tt.EngineConfig(device="cpu", **cfg)), Schema=TSchema,
        Field=TField, DT=TType, Batch=TBatch, Source=TSource, F=TF,
        col=tt.col, lit=tt.lit, PlanError=TPlanError, Join=TJoin,
        optimize=toptimize, pump=tpump,
    )


def streams(p, L, R, lmask=None, rmask=None):
    """test_join_interval.py's two sources: (ts, k, lv) and (ts2, k2, rv)."""
    def mk(names, rows, masks):
        schema = p.Schema([p.Field(names[0], p.DT.TIMESTAMP_MS, nullable=False),
                           p.Field(names[1], p.DT.STRING, nullable=False),
                           p.Field(names[2], p.DT.INT64)])
        cols = list(zip(*rows)) if rows else [[], [], []]
        return p.Batch(schema, [np.asarray(cols[0], dtype=np.int64),
                                np.asarray(cols[1], dtype=object),
                                np.asarray(cols[2], dtype=np.int64)], masks)

    left = p.ctx.from_source(p.Source.from_batches(
        [mk(("ts", "k", "lv"), b, lmask) for b in L], timestamp_column="ts"),
        name="il")
    right = p.ctx.from_source(p.Source.from_batches(
        [mk(("ts2", "k2", "rv"), b, rmask) for b in R], timestamp_column="ts2"),
        name="ir")
    return left, right


def got(res) -> list[tuple]:
    return sorted(zip(
        np.asarray(res.column("ts")).tolist(),
        [str(x) for x in np.asarray(res.column("k"), dtype=object)],
        np.asarray(res.column("lv")).tolist(),
        np.asarray(res.column("ts2")).tolist(),
        np.asarray(res.column("rv")).tolist(),
    ))


def nested_loop(L_rows, R_rows, lo, hi, l_band=None, r_band=None):
    """Brute-force oracle: all key-equal pairs whose band difference lands
    inclusively in [lo, hi]; a None band value matches nothing."""
    out = []
    for (lts, lk, lv) in L_rows:
        for (rts, rk, rv) in R_rows:
            if lk != rk:
                continue
            bl = lts if l_band is None else l_band((lts, lk, lv))
            br = rts if r_band is None else r_band((rts, rk, rv))
            if bl is None or br is None:
                continue
            d = bl - br
            if lo is not None and d < lo:
                continue
            if hi is not None and d > hi:
                continue
            out.append((lts, lk, lv, rts, rv))
    return sorted(out)


def flat(batches):
    return [r for b in batches for r in b]


def banded(L, R, lo, hi, how="inner", **cfg):
    """The band join through both packages → (jax rows, port rows)."""
    out = []
    for pkg in PKGS:
        p = ns(pkg, **cfg)
        left, right = streams(p, L, R)
        out.append(got(left.join(right, how, ["k"], ["k2"],
                                 band=("ts", "ts2", lo, hi)).collect()))
    return out


def feed(seed, nb=5, n=60, span=2_000, keys=6):
    """Seeded rows, unsorted within and across batches (late rows on both
    sides)."""
    rr = np.random.default_rng(seed)
    return [
        [(int(t), f"k{int(k)}", int(v)) for t, k, v in zip(
            T0 + rr.integers(0, span, n), rr.integers(0, keys, n),
            rr.integers(0, 1000, n))]
        for _ in range(nb)
    ]


# -- band semantics (test_join_interval.py:96-170) --------------------------

BOUNDS = [(-5, 5), (0, 0), (None, 0), (0, None), (-100, 100)]


@pytest.mark.parametrize("lo, hi", BOUNDS, ids=[str(b) for b in BOUNDS])
def test_band_inclusive_bounds_and_one_sided(lo, hi):
    L = [[(T0 + 0, "a", 1), (T0 + 10, "a", 2), (T0 + 20, "b", 3)]]
    R = [[(T0 + 5, "a", 10), (T0 + 10, "a", 20), (T0 + 25, "b", 30)]]
    a, b = banded(L, R, lo, hi)
    assert a == b == nested_loop(flat(L), flat(R), lo, hi)


def test_empty_band_matches_nothing():
    a, b = banded([[(T0, "a", 1)]], [[(T0, "a", 2)]], 10, -10)
    assert a == b == []


def test_band_needs_a_bound():
    for pkg in PKGS:
        p = ns(pkg)
        left, right = streams(p, [[(T0, "a", 1)]], [[(T0, "a", 2)]])
        with pytest.raises(p.PlanError, match="at least one bound"):
            left.join(right, "inner", ["k"], ["k2"],
                      band=("ts", "ts2", None, None)).collect()


def test_band_expression_must_read_its_own_side():
    for pkg in PKGS:
        p = ns(pkg)
        left, right = streams(p, [[(T0, "a", 1)]], [[(T0, "a", 2)]])
        with pytest.raises(p.PlanError, match="not present on the left"):
            left.join(right, "inner", ["k"], ["k2"],
                      band=("ts2", "ts", -1, 1)).collect()


@pytest.mark.parametrize("lo, hi", [(-10**6, 10**6), (None, 10**6)])
def test_null_band_values_never_match(lo, hi):
    L_rows = [(T0, "a", 1), (T0 + 1, "a", 2)]
    R_rows = [(T0, "a", 10), (T0 + 1, "a", 20)]
    lmask = [None, None, np.array([True, False])]   # lv null in row 1
    rmask = [None, None, np.array([False, True])]   # rv null in row 0
    out = []
    for pkg in PKGS:
        p = ns(pkg)
        left, right = streams(p, [L_rows], [R_rows], lmask, rmask)
        out.append(got(left.join(
            right, "inner", ["k"], ["k2"],
            band=(p.col("lv"), p.col("rv"), lo, hi)).collect()))
    want = nested_loop(L_rows, R_rows, lo, hi,
                       l_band=lambda r: r[2] if r[2] != 2 else None,
                       r_band=lambda r: r[2] if r[2] != 10 else None)
    assert out[0] == out[1] == want


def test_join_on_lowers_between_to_band():
    """``l.ts >= r.ts - 50 AND l.ts <= r.ts + 30`` lowers to ONE JoinBand
    that survives the optimizer, with the explicit band API's rows."""
    rng = np.random.default_rng(3)
    L = [[(T0 + int(t), f"k{rng.integers(4)}", int(v))
          for t, v in zip(rng.integers(0, 500, 40), range(40))]]
    R = [[(T0 + int(t), f"k{rng.integers(4)}", int(v))
          for t, v in zip(rng.integers(0, 500, 40), range(40))]]
    out = []
    for pkg in PKGS:
        p = ns(pkg)
        left, right = streams(p, L, R)
        col = p.col
        ds = left.join_on(right, "inner", [
            col("k") == col("k2"),
            col("ts") >= col("ts2") - 50,
            col("ts") <= col("ts2") + 30,
        ])
        band = ds._plan.band
        assert band is not None
        assert band.lower_ms == -50 and band.upper_ms == 30
        opt = p.optimize(ds._plan)
        assert opt.band is not None  # survives the optimizer
        assert "band ts - ts2 in [-50.0, 30.0]" in opt.display()
        out.append(got(ds.collect()))
    want = nested_loop(flat(L), flat(R), -50, 30)
    assert out[0] == out[1] == want
    assert banded(L, R, -50, 30) == [want, want]


CASES = [(-40, 40), (0, 120), (None, 0), (-7, None), (60, 10)]


@pytest.mark.parametrize("seed, lo, hi", [(i, lo, hi) for i, (lo, hi)
                                          in enumerate(CASES)],
                         ids=[str(c) for c in CASES])
def test_band_differential_seeded_nested_loop(seed, lo, hi):
    """Seeded feeds with late rows on both sides, retention effectively
    infinite: both packages equal the nested-loop oracle."""
    Lb, Rb = feed(seed * 2 + 1), feed(seed * 2 + 2)
    a, b = banded(Lb, Rb, lo, hi)
    assert a == b == nested_loop(flat(Lb), flat(Rb), lo, hi)


def test_right_join_band_flips_across_the_swap():
    """right_semi swaps inputs: the band mirrors to ``r - l ∈ [-b, -a]``
    and keeps the pairs the left-side form keeps."""
    Lb, Rb = feed(21, nb=2, n=30), feed(22, nb=2, n=30)
    out = []
    for pkg in PKGS:
        p = ns(pkg)
        left, right = streams(p, Lb, Rb)
        res = left.join(right, "right_semi", ["k"], ["k2"],
                        band=("ts", "ts2", -30, 80)).collect()
        out.append(sorted(zip(res.column("ts2").tolist(),
                              [str(x) for x in res.column("k2")],
                              res.column("rv").tolist())))
    want = sorted({(rts, rk, rv) for (_lts, rk, _lv, rts, rv)
                   in nested_loop(flat(Lb), flat(Rb), -30, 80)})
    assert out[0] == out[1] == want


def sequential_pump(monkeypatch, pump_mod):
    """Deterministic drive: pump threads enqueue strictly in spawn order
    (all of the left source, then all of the right), so eviction timing
    is reproducible."""
    real_put = pump_mod.checked_put
    threads: list[threading.Thread] = []

    def fake_spawn(q, done, items, sentinel, wrap=lambda x: x):
        idx = len(threads)

        def run():
            if idx:
                threads[idx - 1].join()
            try:
                for item in items():
                    if not real_put(q, done, wrap(item)):
                        return
            finally:
                real_put(q, done, sentinel)

        th = threading.Thread(target=run, daemon=True)
        threads.append(th)
        th.start()
        return th

    monkeypatch.setattr(pump_mod, "spawn_pump", fake_spawn)


def ordered_feed(sd, nb, n, step, keys):
    rr = np.random.default_rng(sd)
    t = T0
    out = []
    for _ in range(nb):
        ts = np.sort(t + rr.integers(0, step, n))
        t += step
        ks = rr.integers(0, keys, n)
        out.append([(int(a), f"k{int(k)}", int(v))
                    for a, k, v in zip(ts, ks, rr.integers(0, 100, n))])
    return out


def test_band_at_retention_edge_deterministic(monkeypatch):
    """band width == retention: matches at the retention horizon are
    clipped by whole-batch eviction; under the sequential drive both
    packages equal an oracle that models the eviction schedule."""
    sequential_pump(monkeypatch, jpump)
    sequential_pump(monkeypatch, tpump)
    retention = 400
    Lb, Rb = ordered_feed(1, 6, 50, 200, 4), ordered_feed(2, 6, 50, 200, 4)
    out = banded(Lb, Rb, -retention, retention, join_retention_ms=retention,
                 partition_watermarks=False)
    wmL = max(min(r[0] for r in b) for b in Lb)
    retained = [(b, max(r[0] for r in b)) for b in Lb]
    wmR = None
    want = []
    for rb in Rb:
        for (rts, rk, rv) in rb:
            for lb, _mx in retained:
                for (lts, lk, lv) in lb:
                    if lk == rk and -retention <= lts - rts <= retention:
                        want.append((lts, lk, lv, rts, rv))
        bmin = min(r[0] for r in rb)
        wmR = bmin if wmR is None or bmin > wmR else wmR
        horizon = min(wmL, wmR) - retention
        retained = [(lb, mx) for lb, mx in retained if mx >= horizon]
    assert out[0] == out[1] == sorted(want)
    assert len(want) > 50


def test_outer_join_band_rejected_pairs_emit_unmatched():
    """LEFT join: an equi-hit the band rejects still surfaces as an
    unmatched, null-padded left row at EOS."""
    rows = []
    for pkg in PKGS:
        p = ns(pkg)
        left, right = streams(p, [[(T0, "a", 1), (T0 + 500, "a", 2)]],
                              [[(T0 + 2, "a", 10)]])
        res = left.join(right, "left", ["k"], ["k2"],
                        band=("ts", "ts2", -10, 10)).collect()
        m = res.mask("rv")
        rows.append({int(res.column("lv")[i]): bool(m[i]) if m is not None
                     else True for i in range(res.num_rows)})
    assert rows[0] == rows[1] == {1: True, 2: False}


def find_join(op, cls):
    stack = [op]
    while stack:
        cur = stack.pop()
        if isinstance(cur, cls):
            return cur
        stack.extend(cur.children)
    raise AssertionError("no StreamingJoinExec in plan")


def test_band_eviction_bounds_state_matches_oracle(monkeypatch):
    """At band ≪ retention the same in-order feed with
    ``join_band_slack_ms=0`` and unset emits the oracle's rows in both
    packages; the band-evicting run evicts and keeps a small fraction of
    the state, the unset one evicts nothing."""
    sequential_pump(monkeypatch, jpump)
    sequential_pump(monkeypatch, tpump)
    band = 300
    Lb, Rb = ordered_feed(21, 30, 24, 500, 4), ordered_feed(22, 30, 24, 500, 4)
    want = nested_loop(flat(Lb), flat(Rb), -band, band)
    for slack in (0, None):
        evicted, state = [], []
        for pkg in PKGS:
            p = ns(pkg, join_band_slack_ms=slack, partition_watermarks=False)
            left, right = streams(p, Lb, Rb)
            res = left.join(right, "inner", ["k"], ["k2"],
                            band=("ts", "ts2", -band, band)).collect()
            assert got(res) == want, (pkg, slack)
            j = find_join(p.ctx._last_physical, p.Join)
            evicted.append(j._metrics["evicted"])
            state.append(j.state_info()["state_bytes"])
        assert evicted[0] == evicted[1], (slack, evicted)
        if slack is None:
            assert evicted[1] == 0
            off_bytes = state[1]
        else:
            assert evicted[1] > 0
            on_bytes = state[1]
    assert 0 < on_bytes < 0.3 * off_bytes, (on_bytes, off_bytes)


def test_band_eviction_slack_absorbs_late_rows():
    """Bounded late band values: with slack ≥ the feed's lateness, band
    eviction loses no matches under any interleaving, and still evicts."""
    band, late = 150, 400

    def late_feed(sd, nb=30, n=24):
        rr = np.random.default_rng(sd)
        out = []
        for b in range(nb):
            base = T0 + b * 500
            ts = base + rr.integers(-late, 500, n)
            ts[0] = base
            out.append([(int(a), f"k{int(k)}", int(v)) for a, k, v in zip(
                ts, rr.integers(0, 4, n), rr.integers(0, 100, n))])
        return out

    Lb, Rb = late_feed(31), late_feed(32)
    want = nested_loop(flat(Lb), flat(Rb), -band, band)
    for pkg in PKGS:
        p = ns(pkg, join_band_slack_ms=late)
        left, right = streams(p, Lb, Rb)
        res = left.join(right, "inner", ["k"], ["k2"],
                        band=("ts", "ts2", -band, band)).collect()
        assert got(res) == want, pkg
        assert find_join(p.ctx._last_physical, p.Join)._metrics["evicted"] > 0


def test_banded_side_state_arrays_survive_rebuild():
    """The port's side state keeps per-row band values and per-batch band
    maxima through eviction's rebuild, like the JAX package's."""
    from denormalized_tpu.physical.join_exec import _SideState as JSide
    from denormalized_tpu_torch.physical.join_exec import _SideState as TSide

    rng = np.random.default_rng(4)
    states = []
    for pkg, Side in (("jax", JSide), ("torch", TSide)):
        p = ns(pkg)
        side = Side(with_band=True)
        schema = p.Schema([p.Field(CANONICAL_TIMESTAMP_COLUMN, p.DT.INT64)])
        rng = np.random.default_rng(4)
        for b in range(4):
            n = 16
            vals = rng.normal(0, 100, n)
            vals[rng.integers(0, n, 2)] = np.nan
            batch = p.Batch(schema, [np.arange(n, dtype=np.int64) + b * 100])
            side.insert(batch, rng.integers(0, 5, n).astype(np.int32), vals)
        n = side.count
        keep = side.row_bi[:n] >= 2
        side.rebuild(side.batches[2:], side.batch_max_ts[2:],
                     side.row_gid[:n][keep].copy(),
                     (side.row_bi[:n][keep] - 2).astype(np.int32),
                     side.row_ri[:n][keep].copy(),
                     side.matched[:n][keep].copy(),
                     band=side.row_band[:n][keep].copy())
        states.append((side.batch_band_max, side.band_wm,
                       side.row_band[: side.count].tolist()))
    assert repr(states[0]) == repr(states[1])


# -- join_on (test_join.py:303, :364, :389) ---------------------------------


def reading_batches(p, seed, n_batches, rows=256, keys=4, shift=0.0,
                    ms_per_batch=500):
    rng = np.random.default_rng(seed)
    schema = p.Schema([p.Field("occurred_at_ms", p.DT.INT64, nullable=False),
                       p.Field("sensor_name", p.DT.STRING, nullable=False),
                       p.Field("reading", p.DT.FLOAT64)])
    names = np.array([f"sensor_{i}" for i in range(keys)], dtype=object)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * ms_per_batch
                     + rng.integers(0, ms_per_batch, rows))
        out.append(p.Batch(schema, [ts, names[rng.integers(0, keys, rows)],
                                    rng.normal(50.0, 10.0, rows) + shift]))
    return out


def windowed(p, batches, name, agg):
    return p.ctx.from_source(
        p.Source.from_batches(batches, timestamp_column="occurred_at_ms"),
        name=name,
    ).window(["sensor_name"], [p.F.avg(p.col("reading")).alias(agg)], 1000)


def canon(res, cols):
    rows = []
    for i in range(res.num_rows):
        rows.append(tuple(
            float(res.column(c)[i]) if isinstance(res.column(c)[i], float)
            else res.column(c)[i].item() if hasattr(res.column(c)[i], "item")
            else res.column(c)[i] for c in cols))
    return sorted(rows, key=lambda r: tuple(
        repr(x) for x in r if not isinstance(x, float)))


def assert_same_rows(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float):
                assert np.isclose(x, y, rtol=AVG_RTOL, atol=0), (ra, rb)
            else:
                assert x == y, (ra, rb)


def test_join_on_expression_keys_and_residual():
    """An equi conjunct over expressions becomes a hidden hash key, a
    non-equi conjunct over both sides a residual: same rows in both
    packages, no hidden column in the output, every residual holds."""
    out = []
    for pkg in PKGS:
        p = ns(pkg, join_retention_ms=300_000)
        col, F = p.col, p.F
        left = windowed(p, reading_batches(p, 9, 8), "t2", "avg_t")
        right = (
            windowed(p, reading_batches(p, 10, 8, shift=100.0), "h2", "avg_h")
            .with_column("hs_up", F.upper(col("sensor_name")))
            .with_column_renamed("sensor_name", "hs")
            .with_column_renamed("window_start_time", "hws")
            .with_column_renamed("window_end_time", "hwe")
        )
        joined = left.join_on(right, "inner", [
            F.upper(col("sensor_name")) == col("hs_up"),
            col("window_start_time") == col("hws"),
            col("avg_h") > col("avg_t"),
            col("avg_h") - col("avg_t") < F.lit(200.0),
        ])
        res = joined.collect()
        names = res.schema.names
        assert not [n for n in names if n.startswith("__join_")]
        for i in range(res.num_rows):
            assert str(res.column("sensor_name")[i]).upper() == \
                res.column("hs_up")[i]
            assert res.column("window_start_time")[i] == res.column("hws")[i]
            assert res.column("avg_h")[i] > res.column("avg_t")[i]
        out.append((names, canon(res, names)))
    assert out[0][0] == out[1][0]
    assert len(out[1][1]) > 0
    assert_same_rows(out[0][1], out[1][1])


def test_join_on_rejects_pure_theta():
    for pkg in PKGS:
        p = ns(pkg)
        left = windowed(p, reading_batches(p, 10, 2), "t3", "a")
        right = windowed(p, reading_batches(p, 11, 2), "h3", "b") \
            .with_column_renamed("sensor_name", "hs")
        with pytest.raises(p.PlanError, match="equi conjunct"):
            left.join_on(right, "inner", [p.col("a") < p.col("b")])


def test_join_on_shared_name_columns():
    """``col('k') == col('k')`` over inputs that both carry 'k' stays a
    shared equi-key (emitted once), not a residual."""
    out = []
    for pkg in PKGS:
        p = ns(pkg, join_retention_ms=300_000)
        col = p.col
        left = windowed(p, reading_batches(p, 11, 4), "t4", "avg_t")
        right = windowed(p, reading_batches(p, 12, 4), "h4", "avg_h") \
            .with_column_renamed("window_end_time", "hwe")
        res = left.join_on(right, "inner", [
            col("sensor_name") == col("sensor_name"),
            col("window_start_time") == col("window_start_time"),
        ]).collect()
        names = res.schema.names
        assert names.count("sensor_name") == 1
        out.append((names, canon(res, names)))
    assert out[0][0] == out[1][0]
    assert len(out[1][1]) > 0
    assert_same_rows(out[0][1], out[1][1])


def expressions_query(p, left_batches, right_batches):
    """Config 4 as examples/stream_join.py --expressions writes it."""
    col, F = p.col, p.F
    temperature = p.ctx.from_source(
        p.Source.from_batches(left_batches, timestamp_column="occurred_at_ms"),
        name="temperature",
    ).window([col("sensor_name")],
             [F.avg(col("reading")).alias("average_temperature")], 1000)
    humidity = (
        p.ctx.from_source(
            p.Source.from_batches(right_batches,
                                  timestamp_column="occurred_at_ms"),
            name="humidity",
        )
        .window([col("sensor_name")],
                [F.avg(col("reading")).alias("average_humidity")], 1000)
        .with_column_renamed("sensor_name", "humidity_sensor")
        .with_column_renamed("window_start_time", "humidity_window_start_time")
        .with_column_renamed("window_end_time", "humidity_window_end_time")
    )
    return temperature.join_on(humidity, "inner", [
        F.upper(col("sensor_name")) == F.upper(col("humidity_sensor")),
        col("window_start_time") == col("humidity_window_start_time"),
        col("average_humidity") > col("average_temperature") - F.lit(100.0),
    ])


@pytest.mark.parametrize("strategy", ["auto", "scatter", "partial_merge"])
def test_config4_expressions_query(strategy):
    """The --expressions form of config 4, row for row against the JAX
    package, with the residual dropping some pairs (humidity shifted down
    by 100, so about half the windows fail ``avg_h > avg_t - 100``)."""
    out = []
    for pkg in PKGS:
        cfg = {"join_retention_ms": 300_000}
        if pkg == "torch":
            cfg["device_strategy"] = strategy
        p = ns(pkg, **cfg)
        ds = expressions_query(p, reading_batches(p, 1, 10, keys=5),
                               reading_batches(p, 2, 10, keys=5, shift=-100.0))
        res = ds.collect()
        names = res.schema.names
        out.append((names, canon(res, names)))
    assert out[0][0] == out[1][0]
    assert not [n for n in out[1][0] if n.startswith("__join_")]
    # every window both sides hold (5 keys x 5 s) joins, less the residual
    assert 0 < len(out[1][1]) < 25
    assert_same_rows(out[0][1], out[1][1])


def test_config4_expressions_hidden_keys_survive_pruning():
    """The optimizer keeps the hidden key columns below the join and the
    final projection drops them: same plans in both packages."""
    shapes = []
    for pkg in PKGS:
        p = ns(pkg)
        ds = expressions_query(p, reading_batches(p, 1, 1),
                               reading_batches(p, 2, 1))
        text = p.optimize(ds._plan).display()
        assert "__join_lk_0__" in text and "__join_rk_0__" in text
        shapes.append(text)
    assert shapes[0] == shapes[1]


# -- hypothesis property (the reference's :306) -----------------------------

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - env without hypothesis
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:

    @st.composite
    def band_case(draw):
        nkeys = draw(st.integers(1, 5))
        span = draw(st.integers(1, 1500))

        def rows(n):
            return [(T0 + draw(st.integers(0, span)),
                     f"k{draw(st.integers(0, nkeys - 1))}",
                     draw(st.integers(0, 50))) for _ in range(n)]

        L = [rows(draw(st.integers(1, 25))) for _ in range(draw(st.integers(1, 3)))]
        R = [rows(draw(st.integers(1, 25))) for _ in range(draw(st.integers(1, 3)))]
        lo = draw(st.one_of(st.none(), st.integers(-span, span)))
        hi = draw(st.one_of(st.none(), st.integers(-span, span)))
        if lo is None and hi is None:
            hi = 0
        return L, R, lo, hi

    @settings(max_examples=15, deadline=None)
    @given(band_case())
    def test_band_property_matches_nested_loop_in_both_packages(case):
        L, R, lo, hi = case
        a, b = banded(L, R, lo, hi)
        assert a == b == nested_loop(flat(L), flat(R), lo, hi)
