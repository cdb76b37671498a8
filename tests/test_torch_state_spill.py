"""The cold tier in the port (``state/tiering.py`` and the window, join,
session and UDAF operators' tiers) held against the JAX package's on the
same seeded input.

Twins of ``tests/test_state_spill.py``: every query runs under a tiny
forced budget in both packages, and the port's budgeted rows must equal its
own unbudgeted rows byte for byte (where the JAX test asks that of itself)
and the JAX package's budgeted rows — exactly for the host operators, which
run the same numpy in the same order; for the window ring counts, row sets
and extrema exactly and float32 sums to rtol=1e-5 (the port's ring folds in
torch's order).  The tier's spill and reload counts must be the JAX
package's: both size the budget with the same arithmetic.  Then the
port's own cases: a float64 ring under a budget (its item size taken from
the torch dtype), the ring shrinking after a spill, and a spilled window
checkpoint written by either package and restored by the other.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.api.udaf import Accumulator as JAccumulator
from denormalized_tpu.common.errors import StateError as JStateError
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical import plan as jlp
from denormalized_tpu.physical import base as jbase
from denormalized_tpu.physical import udaf_exec as judaf
from denormalized_tpu.physical.simple_execs import CollectSink as JSink
from denormalized_tpu.physical.window_exec import StreamingWindowExec as JWin
from denormalized_tpu.runtime import executor as jexec
from denormalized_tpu.runtime import faults as jfaults
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu.state import lsm as jlsm
from denormalized_tpu.state import tiering as jtier
from denormalized_tpu.state.checkpoint import CheckpointCoordinator as JCoord
from denormalized_tpu.state.checkpoint import wire_checkpointing as jwire
from denormalized_tpu.state.orchestrator import Orchestrator as JOrch
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.api.udaf import Accumulator as TAccumulator
from denormalized_tpu_torch.common.constants import CANONICAL_TIMESTAMP_COLUMN
from denormalized_tpu_torch.common.errors import StateError
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.physical import base as tbase
from denormalized_tpu_torch.physical import udaf_exec as tudaf
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.physical.window_exec import (
    StreamingWindowExec as TWin,
)
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.runtime import faults as tfaults
from denormalized_tpu_torch.sources.memory import MemorySource as TSource
from denormalized_tpu_torch.state import lsm as tlsm
from denormalized_tpu_torch.state import tiering as ttier
from denormalized_tpu_torch.state.checkpoint import (
    CheckpointCoordinator as TCoord,
)
from denormalized_tpu_torch.state.checkpoint import (
    assign_node_ids,
    get_json,
)
from denormalized_tpu_torch.state.checkpoint import wire_checkpointing as twire
from denormalized_tpu_torch.state.orchestrator import Orchestrator as TOrch
from denormalized_tpu_torch.state.serialization import pack_snapshot

T0 = 1_700_000_000_000
PKGS = ("jax", "torch")


def api(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        return SimpleNamespace(
            ctx=lambda **kw: jt.Context(JConfig(**kw)), Schema=JSchema,
            Field=JField, DT=JType, Batch=JBatch, Source=JSource, F=JF,
            col=jt.col, lp=jlp, Sink=JSink, executor=jexec, wire=jwire,
            Orch=JOrch, base=jbase, close=jlsm.close_global_state_backend,
            lsm=jlsm, tier=jtier, faults=jfaults, Win=JWin, udaf=judaf,
            Coord=JCoord, Accumulator=JAccumulator,
            win_kw=dict(accum_dtype=jnp.float32), StateError=JStateError,
        )
    return SimpleNamespace(
        ctx=lambda **kw: tt.Context(tt.EngineConfig(device="cpu", **kw)),
        Schema=TSchema, Field=TField, DT=TType, Batch=TBatch, Source=TSource,
        F=TF, col=tt.col, lp=tlp, Sink=TSink, executor=texec, wire=twire,
        Orch=TOrch, base=tbase, close=tlsm.close_global_state_backend,
        lsm=tlsm, tier=ttier, faults=tfaults, Win=TWin, udaf=tudaf,
        Coord=TCoord, Accumulator=TAccumulator,
        win_kw=dict(device="cpu"), StateError=StateError,
    )


def schema(p):
    return p.Schema([
        p.Field("ts", p.DT.INT64, nullable=False),
        p.Field("k", p.DT.STRING, nullable=False),
        p.Field("v", p.DT.FLOAT64),
    ])


def rows(batch) -> list[tuple]:
    d = batch.to_pydict()
    names = sorted(d)
    return [tuple(repr(d[n][i]) for n in names) for i in range(batch.num_rows)]


def find(root, cls_name):
    stack = [root]
    while stack:
        cur = stack.pop()
        if type(cur).__name__ == cls_name:
            return cur
        stack.extend(cur.children)
    raise AssertionError(f"{cls_name} not in plan")


def stream_rows(ds) -> list[tuple]:
    out = []
    for b in ds.stream():
        out.extend(rows(b))
    return out


def totals(st: dict) -> tuple:
    return (st["spill_blocks_total"], st["reload_blocks_total"],
            st["spill_bytes_total"], st["reload_bytes_total"])


# -- the session job ---------------------------------------------------------


def session_raw(n_batches=18, n=250, n_keys=400, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 250 + rng.integers(0, 250, n))
        ks = np.asarray(
            [f"sensor_{i}" for i in rng.integers(0, n_keys, n)], object)
        out.append((ts, ks, rng.normal(50, 10, n)))
    return out


def batches(p, raw):
    return [p.Batch(schema(p), [np.asarray(t, np.int64), k, v])
            for t, k, v in raw]


def session_pipeline(p, ctx, raw, gap=300):
    F, c = p.F, p.col
    return ctx.from_source(
        p.Source.from_batches(batches(p, raw), timestamp_column="ts"),
        name="spill_s",
    ).session_window(
        ["k"],
        [F.count(c("v")).alias("count"), F.min(c("v")).alias("min"),
         F.max(c("v")).alias("max"), F.avg(c("v")).alias("average"),
         F.stddev(c("v")).alias("sd")],
        gap,
    )


def budgeted_session(pkg, raw, path, budget, gap=300):
    """The session job under ``budget`` → (rows, state_info)."""
    p = api(pkg)
    ctx = p.ctx(state_backend_path=path, state_budget_bytes=budget)
    try:
        got = stream_rows(session_pipeline(p, ctx, raw, gap))
        info = find(ctx._last_physical, "SessionWindowExec").state_info()
    finally:
        p.close()
    return got, info


def test_session_spill_differential_byte_identical(tmp_path):
    raw = session_raw()
    golden = stream_rows(session_pipeline(api("torch"), api("torch").ctx(),
                                          raw))
    got, info = {}, {}
    for pkg in PKGS:
        got[pkg], info[pkg] = budgeted_session(
            pkg, raw, str(tmp_path / pkg), 20_000)
    assert got["torch"] == golden  # repr tuples: exact floats, ordered
    assert got["torch"] == got["jax"]
    st = info["torch"]["spill"]
    assert st["spill_blocks_total"] > 0, "budget never forced a spill"
    assert info["torch"]["spilled_bytes"] == 0  # all reloaded or closed
    assert totals(st) == totals(info["jax"]["spill"])


# -- the join ------------------------------------------------------------------


def join_raw(seed, n_batches=12, n=120, keys=60):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        ts = np.sort(T0 + b * 400 + rng.integers(0, 400, n))
        ks = np.asarray([f"k{i}" for i in rng.integers(0, keys, n)], object)
        out.append((ts, ks, rng.normal(10, 2, n)))
    return out


def join_sides(p, ctx, l_raw, r_raw):
    ls = p.Schema([p.Field("ts", p.DT.INT64, nullable=False),
                   p.Field("k", p.DT.STRING, nullable=False),
                   p.Field("lv", p.DT.FLOAT64)])
    rs = p.Schema([p.Field("ts2", p.DT.INT64, nullable=False),
                   p.Field("k2", p.DT.STRING, nullable=False),
                   p.Field("rv", p.DT.FLOAT64)])

    def mk(s, raw):
        return [p.Batch(s, [t, k, v]) for t, k, v in raw]

    left = ctx.from_source(
        p.Source.from_batches(mk(ls, l_raw), timestamp_column="ts"), name="L")
    right = ctx.from_source(
        p.Source.from_batches(mk(rs, r_raw), timestamp_column="ts2"), name="R")
    return left, right


@pytest.mark.parametrize("kind", ["inner", "left", "anti"])
def test_join_spill_differential(tmp_path, kind):
    l_raw, r_raw = join_raw(5), join_raw(9)

    def run(pkg, cfg):
        p = api(pkg)
        ctx = p.ctx(**cfg)
        left, right = join_sides(p, ctx, l_raw, r_raw)
        try:
            out = stream_rows(left.join(right, kind, ["k"], ["k2"]))
            info = (find(ctx._last_physical, "StreamingJoinExec").state_info()
                    if cfg else None)
        finally:
            p.close()
        return out, info

    golden, _ = run("torch", {})
    got, info = {}, {}
    for pkg in PKGS:
        got[pkg], info[pkg] = run(pkg, dict(
            state_backend_path=str(tmp_path / pkg), state_budget_bytes=25_000))
    # a threaded two-pump join interleaves nondeterministically: the
    # comparison is the emission multiset
    assert sorted(got["torch"]) == sorted(golden)
    assert sorted(got["torch"]) == sorted(got["jax"])
    assert info["torch"]["spill"]["spill_blocks_total"] > 0
    assert info["jax"]["spill"]["spill_blocks_total"] > 0


# -- the UDAF operator -----------------------------------------------------------


def spread(p):
    class Spread(p.Accumulator):
        def __init__(self):
            self.lo = float("inf")
            self.hi = float("-inf")

        def update(self, values):
            if len(values):
                self.lo = min(self.lo, float(values.min()))
                self.hi = max(self.hi, float(values.max()))

        def merge(self, states):
            self.lo = min(self.lo, states[0])
            self.hi = max(self.hi, states[1])

        def state(self):
            return [self.lo, self.hi]

        def evaluate(self):
            return self.hi - self.lo if self.hi >= self.lo else 0.0

    return p.F.udaf(Spread, p.DT.FLOAT64, "spread")


def udaf_run(pkg, cfg, raw):
    p = api(pkg)
    ctx = p.ctx(**cfg)
    fn = spread(p)
    ds = ctx.from_source(
        p.Source.from_batches(batches(p, raw), timestamp_column="ts"),
        name="u",
    ).window(["k"], [fn(p.col("v")).alias("spread"),
                     p.F.count(p.col("v")).alias("n")], 1000, 500)
    try:
        out = stream_rows(ds)
        info = (find(ctx._last_physical, "UdafWindowExec").state_info()
                if cfg else None)
    finally:
        p.close()
    return out, info


def udaf_raw():
    rng = np.random.default_rng(3)
    out = []
    for b in range(14):
        ts = np.sort(T0 + b * 400 + rng.integers(0, 400, 150))
        ks = np.asarray([f"k{i}" for i in rng.integers(0, 250, 150)], object)
        out.append((ts, ks, rng.normal(10, 2, 150)))
    return out


def test_udaf_spill_differential_ordered(tmp_path):
    raw = udaf_raw()
    golden, _ = udaf_run("torch", {}, raw)
    got, info = {}, {}
    for pkg in PKGS:
        got[pkg], info[pkg] = udaf_run(pkg, dict(
            state_backend_path=str(tmp_path / pkg), state_budget_bytes=40_000),
            raw)
    # STRICT ordered equality: the in-place markers keep frame dict order,
    # so even the row order within each emitted window matches
    assert got["torch"] == golden
    assert got["torch"] == got["jax"]
    assert info["torch"]["spill"]["spill_blocks_total"] > 0
    assert totals(info["torch"]["spill"]) == totals(info["jax"]["spill"])


# -- the window ring -------------------------------------------------------------


def window_items(p, late_burst: bool, lag_ms: int = 6000, step_ms: int = 500):
    """The JAX test's scripted feed: 20 batches of ``step_ms`` of event
    time, partition hints ``lag_ms`` behind the head (a long span of open,
    watermark-deferred windows behind the hot zone), and optionally a
    burst 5 s behind the head at batch 15."""
    in_schema = p.Schema([
        p.Field(CANONICAL_TIMESTAMP_COLUMN, p.DT.TIMESTAMP_MS, nullable=False),
        p.Field("k", p.DT.STRING, nullable=False),
        p.Field("v", p.DT.FLOAT64),
    ])
    rng = np.random.default_rng(4)
    hint = p.base.WatermarkHint
    items = [hint(p.base.WM_ANNOUNCE, kind="partition")]
    for b in range(20):
        base = T0 + b * step_ms
        ts = np.sort(base + rng.integers(0, step_ms, 100))
        ks = np.asarray([f"k{i}" for i in rng.integers(0, 50, 100)], object)
        items.append(p.Batch(in_schema, [ts, ks, rng.normal(5, 1, 100)]))
        items.append(hint(max(T0, base - lag_ms), kind="partition"))
        if late_burst and b == 15:
            lts = np.sort(base - 5000 + rng.integers(0, 300, 30))
            lks = np.asarray(
                [f"k{i}" for i in rng.integers(0, 50, 30)], object)
            items.append(p.Batch(in_schema, [lts, lks, rng.normal(5, 1, 30)]))
    items.append(hint(T0 + 20 * step_ms + 20_000, kind="partition"))
    items.append(p.base.EOS)
    return in_schema, items


def window_op(p, in_schema, items, **kw):
    class Script(p.base.ExecOperator):
        schema = in_schema

        def run(self):
            yield from items

    F, c = p.F, p.col
    return p.Win(
        Script(),
        [c("k")],
        [F.count(c("v")).alias("n"), F.sum(c("v")).alias("s"),
         F.min(c("v")).alias("lo"), F.max(c("v")).alias("hi"),
         F.avg(c("v")).alias("m")],
        jlp.WindowType.TUMBLING if p.Win is JWin else tlp.WindowType.TUMBLING,
        1000, None,
        # spilled windows emit through the HOST finalize: byte identity
        # asks for one path, so the ring's finalize is the host's too
        device_finalize=False,
        **{**p.win_kw, **kw},
    )


def run_window(p, op, ctrl=None, node="0_win") -> list[tuple]:
    if ctrl is not None:
        op.enable_spill(node, ctrl)
    out = []
    for item in op.run():
        if isinstance(item, p.Batch):
            out.extend(rows(item))
    return out


def budgeted_window(pkg, path, late_burst, budget=20_000, **kw):
    p = api(pkg)
    in_schema, items = window_items(p, late_burst)
    store = p.lsm.LsmStore(path)
    try:
        ctrl = p.tier.SpillController(store, budget_bytes=budget)
        op = window_op(p, in_schema, items, **kw)
        got = run_window(p, op, ctrl)
        st = ctrl.spill_stats("0_win")
        ctrl.close()
    finally:
        store.close()
    return got, st, op


def assert_ring_rows(got, want) -> None:
    """Window-ring rows of the two packages: the same (key, window) set,
    counts, extrema and bounds exact, float32 sums and averages to
    rtol=1e-5.  A row is the repr tuple of its columns in name order:
    canonical ts, hi, k, lo, m, n, s, window end, window start."""
    g = {(r[2], r[8]): r for r in got}
    w = {(r[2], r[8]): r for r in want}
    assert set(g) == set(w)
    for key, wr in w.items():
        gr = g[key]
        exact = (0, 1, 3, 5, 7)
        assert [gr[i] for i in exact] == [wr[i] for i in exact], key
        for i in (4, 6):
            assert math.isclose(float(gr[i]), float(wr[i]), rel_tol=1e-5), key


@pytest.mark.parametrize("late_burst", [False, True])
def test_window_spill_differential(tmp_path, late_burst):
    p = api("torch")
    golden = run_window(p, window_op(p, *window_items(p, late_burst)))
    got, st = {}, {}
    for pkg in PKGS:
        got[pkg], st[pkg], _ = budgeted_window(
            pkg, str(tmp_path / pkg), late_burst)
    assert got["torch"] == golden
    assert_ring_rows(got["torch"], got["jax"])
    assert st["torch"]["spill_blocks_total"] > 0
    if late_burst:
        # the burst lands in spilled windows: they reload into the ring
        # (first_open lowers back), not read as late
        assert st["torch"]["reload_blocks_total"] > 0
    assert totals(st["torch"]) == totals(st["jax"])


# -- kill/restore mid-spill + fallback-epoch interaction -------------------------


def drive_with_checkpoint(p, ctx, raw, *, commit_epochs, stop_after):
    """Run the session pipeline driving the orchestrator by hand: trigger
    and commit ``commit_epochs`` barriers spread over the stream, then stop
    hard → (rows emitted before the stop, coordinator, root)."""
    ds = session_pipeline(p, ctx, raw)
    root = p.executor.build_physical(p.lp.Sink(ds._plan, p.Sink()), ctx)
    spill = p.tier.attach_spill(root, ctx)
    orch = p.Orch(interval_s=9999)
    coord = p.wire(root, ctx, orch)
    emitted = []
    committed = items = 0
    it = root.run()
    for item in it:
        if isinstance(item, p.Batch):
            emitted.extend(rows(item))
        if isinstance(item, p.base.Marker):
            coord.commit(item.epoch)
            committed += 1
        items += 1
        if committed < commit_epochs and items % 6 == 0:
            orch.trigger_now()
        if (stop_after is not None and items >= stop_after
                and committed >= commit_epochs):
            break
        if isinstance(item, p.base.EndOfStream):
            break
    it.close()
    if spill is not None:
        spill.close()
    return emitted, coord, root


def keyed(rows_):
    # (key, window start, window end) → row
    return {(r[1], r[6], r[7]): r for r in rows_}


def ckpt_cfg(path, budget=20_000):
    return dict(checkpoint=True, checkpoint_interval_s=9999,
                state_backend_path=path, state_budget_bytes=budget)


def test_session_kill_restore_mid_spill_byte_identical(tmp_path):
    raw = session_raw(n_batches=20, n=220, n_keys=350, seed=11)
    p = api("torch")
    golden = stream_rows(session_pipeline(p, p.ctx(), raw))
    path = str(tmp_path / "lsm")
    try:
        emitted_a, coord_a, root_a = drive_with_checkpoint(
            p, p.ctx(**ckpt_cfg(path)), raw, commit_epochs=1, stop_after=10)
        # the kill must land MID-SPILL: the committed cut references cold
        # blocks
        key = f"session_{assign_node_ids(root_a)[id(find(root_a, 'SessionWindowExec'))]}"
        assert get_json(coord_a, key).get("spill_blocks"), (
            "no spilled state at the cut")
        p.close()
        emitted_b, coord_b, _root_b = drive_with_checkpoint(
            p, p.ctx(**ckpt_cfg(path)), raw, commit_epochs=0, stop_after=None)
        assert coord_b.committed_epoch is not None
    finally:
        p.close()
    union = keyed(emitted_a)
    union.update(keyed(emitted_b))
    assert union == keyed(golden)


def test_fallback_epoch_restores_intact_spill_blocks(tmp_path):
    """Corrupting the NEWEST committed epoch's spilled-block snapshot
    pushes recovery to the previous epoch, whose intact block refs rebuild
    the tier map."""
    raw = session_raw(n_batches=20, n=220, n_keys=350, seed=13)
    p = api("torch")
    golden = stream_rows(session_pipeline(p, p.ctx(), raw))
    path = str(tmp_path / "lsm")
    try:
        emitted_a, coord_a, _ = drive_with_checkpoint(
            p, p.ctx(**ckpt_cfg(path)), raw, commit_epochs=2, stop_after=14)
        newest = coord_a.committed_epoch
        assert newest is not None and len(coord_a.committed_history) >= 2
        backend = tlsm.initialize_global_state_backend(path)
        suffix = f"@{newest}".encode()
        victims = [kb for kb in backend.keys()
                   if kb.endswith(suffix) and b":spill:" in kb] or [
            kb for kb in backend.keys()
            if kb.endswith(suffix) and not kb.startswith(b"manifest@")]
        # a strict prefix of the frame magic = a detected torn blob
        backend.put(victims[0], b"DNZ")
        p.close()
        emitted_b, coord_b, _ = drive_with_checkpoint(
            p, p.ctx(**ckpt_cfg(path)), raw, commit_epochs=0, stop_after=None)
        assert coord_b.restored_from_fallback
        assert coord_b.restored_epoch < newest
    finally:
        p.close()
    union = keyed(emitted_a)
    union.update(keyed(emitted_b))
    assert union == keyed(golden)


# -- reload-on-touch under gid recycling ---------------------------------------


def test_session_reload_under_gid_recycling(tmp_path):
    """Cold keys spill; OTHER keys open and close (their gids recycle to
    brand-new keys); then rows arrive for the spilled keys' names.  The
    tier never releases a spilled key's gid, reloads the right sessions,
    and the emissions equal the unbudgeted run's and the JAX package's."""
    gap = 2000
    rng = np.random.default_rng(5)
    raw = [(np.arange(T0, T0 + 300, dtype=np.int64),
            np.asarray([f"cold_{i}" for i in range(300)], object),
            rng.normal(1, 0.1, 300))]
    t = T0 + 400
    for w in range(6):
        raw.append((np.arange(t, t + 200, dtype=np.int64),
                    np.asarray([f"hot_{w}_{i}" for i in range(200)], object),
                    rng.normal(2, 0.1, 200)))
        t += gap + 400  # the gap passes: the previous wave closes
    raw.append((np.arange(t, t + 150, dtype=np.int64),
                np.asarray([f"cold_{i}" for i in range(150)], object),
                rng.normal(3, 0.1, 150)))
    p = api("torch")
    golden = stream_rows(session_pipeline(p, p.ctx(), raw, gap))
    got, info = {}, {}
    for pkg in PKGS:
        got[pkg], info[pkg] = budgeted_session(
            pkg, raw, str(tmp_path / pkg), 15_000, gap)
    assert got["torch"] == golden
    assert got["torch"] == got["jax"]
    assert info["torch"]["spill"]["spill_blocks_total"] > 0
    assert totals(info["torch"]["spill"]) == totals(info["jax"]["spill"])


# -- graceful degradation + faults -----------------------------------------------


def faulted_session(pkg, raw, path, rule):
    p = api(pkg)
    p.faults.arm({"seed": 1, "rules": [rule]})
    try:
        return budgeted_session(pkg, raw, path, 20_000)
    finally:
        p.faults.disarm()


def test_spill_put_failure_keeps_state_resident(tmp_path):
    """An injected eviction-write failure keeps the chunk resident and the
    output correct — a spill failure degrades, never kills."""
    raw = session_raw(n_batches=12, n=200, n_keys=300, seed=9)
    golden = stream_rows(session_pipeline(api("torch"), api("torch").ctx(),
                                          raw))
    rule = {"site": "lsm.spill_put", "kind": "error",
            "message": "injected spill write failure", "after": 2,
            "times": 3}
    got = {pkg: faulted_session(pkg, raw, str(tmp_path / pkg), rule)
           for pkg in PKGS}
    assert got["torch"][0] == golden
    assert got["torch"][0] == got["jax"][0]
    # the failed puts count no spill in either package
    assert totals(got["torch"][1]["spill"]) == totals(got["jax"][1]["spill"])


def test_spill_get_transient_error_heals(tmp_path):
    raw = session_raw(n_batches=12, n=200, n_keys=300, seed=10)
    golden = stream_rows(session_pipeline(api("torch"), api("torch").ctx(),
                                          raw))
    rule = {"site": "lsm.spill_get", "kind": "error",
            "message": "injected reload flap", "after": 1, "times": 2}
    got = {pkg: faulted_session(pkg, raw, str(tmp_path / pkg), rule)
           for pkg in PKGS}
    assert got["torch"][0] == golden
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1]["spill"]["reload_blocks_total"] > 0


def test_torn_spill_block_fails_epoch_copy(tmp_path):
    """A spill block torn on its way into the LSM FAILS the epoch copy
    (the previous intact epoch stays the recovery point) instead of
    committing a CRC-valid wrapper around corrupt bytes."""
    store = tlsm.LsmStore(str(tmp_path / "lsm"))
    try:
        ctrl = ttier.SpillController(store, budget_bytes=1000)
        ctrl.register("n0", store, lambda: 0)
        tfaults.arm({"rules": [
            {"site": "lsm.spill_put", "kind": "torn", "times": 1}]})
        try:
            blob = pack_snapshot({"x": 1}, {"a": np.arange(100)})
            ctrl.put_block("n0", "b0", blob)  # torn on the way in
        finally:
            tfaults.disarm()

        class FakeCoord:
            def put_snapshot(self, key, epoch, raw):
                raise AssertionError("corrupt block reached the epoch")

        with pytest.raises(StateError, match="integrity"):
            ctrl.copy_block_to_epoch(FakeCoord(), "k", 1, "n0", "b0")
    finally:
        store.close()


def test_spill_manifest_fault_degrades_observability_only(tmp_path):
    """``spill.manifest`` is a registered fault site: a failed manifest
    write logs and leaves the data path alone, as in the JAX package."""
    raw = session_raw(n_batches=12, n=200, n_keys=300, seed=9)
    golden = stream_rows(session_pipeline(api("torch"), api("torch").ctx(),
                                          raw))
    rule = {"site": "spill.manifest", "kind": "error", "times": 4}
    got = {pkg: faulted_session(pkg, raw, str(tmp_path / pkg), rule)
           for pkg in PKGS}
    assert got["torch"][0] == golden == got["jax"][0]
    assert set(tfaults.SITES) >= {"lsm.spill_put", "lsm.spill_get",
                                  "spill.manifest"}


def test_backpressure_gate_engage_release(tmp_path):
    store = tlsm.LsmStore(str(tmp_path / "lsm"))
    try:
        with ttier._GATE_LOCK:
            ttier._GATE_HOLDERS.clear()
        ttier._GATE_ENGAGED = False
        ctrl = ttier.SpillController(store, budget_bytes=1000)
        ctrl.register("n0", store, lambda: 10_000)
        assert not ttier.pressure_engaged()
        ctrl.escalate("n0", 9_000)
        assert ttier.pressure_engaged()
        assert ttier.backpressure_pause(slice_s=0.001)
        ctrl.relax("n0")
        assert not ttier.pressure_engaged()
        assert not ttier.backpressure_pause(slice_s=0.001)
        assert ctrl.spill_stats("n0")["backpressure_engagements"] == 1
        ctrl.check_pressure("n0")  # 10,000 > the 1,250 ceiling
        assert ttier.pressure_engaged()
        ctrl.close()  # teardown releases every hold
        assert not ttier.pressure_engaged()
    finally:
        store.close()


def test_no_budget_no_tier_wired(tmp_path):
    """A budget without a backend and a backend without a budget both
    leave the tier off; state_spill=True without a backend raises."""
    raw = session_raw(n_batches=4, n=50, n_keys=20)
    p = api("torch")
    for cfg in (dict(state_budget_bytes=10_000),
                dict(state_backend_path=str(tmp_path / "lsm")),
                dict(state_budget_bytes=10, state_spill=False,
                     state_backend_path=str(tmp_path / "lsm"))):
        ctx = p.ctx(**cfg)
        stream_rows(session_pipeline(p, ctx, raw))
        assert ctx._last_spill is None, cfg
        assert find(ctx._last_physical, "SessionWindowExec")._tier is None
    p.close()
    with pytest.raises(StateError, match="state_spill"):
        ttier.spill_active(
            tt.EngineConfig(state_budget_bytes=10, state_spill=True))
    cfg = tt.EngineConfig(device="cpu").set(
        "denormalized_config.state_budget_bytes", 123).set(
        "state_spill", True)
    assert (cfg.state_budget_bytes, cfg.state_spill) == (123, True)


def test_budget_wires_every_stateful_operator(tmp_path):
    """EngineConfig(state_budget_bytes=…, state_backend_path=…) wires a
    tier into the window, join, session and UDAF operators, and the
    controller (ctx._last_spill) closes with the job."""
    p = api("torch")
    cfg = dict(state_backend_path=str(tmp_path / "lsm"),
               state_budget_bytes=1 << 30)
    ctx = p.ctx(**cfg)
    left, right = join_sides(p, ctx, join_raw(5, n_batches=3),
                             join_raw(9, n_batches=3))
    lw = left.window(["k"], [p.F.count(p.col("lv")).alias("n")], 1000)
    rw = (right.window(["k2"], [p.F.count(p.col("rv")).alias("m")], 1000)
          .with_column_renamed("window_start_time", "ws2")
          .with_column_renamed("window_end_time", "we2"))
    stream_rows(lw.join(rw, "inner", ["k", "window_start_time"],
                        ["k2", "ws2"]))
    root = ctx._last_physical
    for name in ("StreamingJoinExec", "StreamingWindowExec"):
        assert find(root, name)._tier is not None, name
    assert ctx._last_spill is not None and ctx._last_spill._closed
    ctx = p.ctx(**cfg)
    udaf_ds = ctx.from_source(
        p.Source.from_batches(batches(p, udaf_raw()[:2]),
                              timestamp_column="ts"),
    ).window(["k"], [spread(p)(p.col("v")).alias("s")], 1000)
    stream_rows(udaf_ds)
    assert find(ctx._last_physical, "UdafWindowExec")._tier is not None
    ctx = p.ctx(**cfg)
    stream_rows(session_pipeline(p, ctx, session_raw(n_batches=2)))
    assert find(ctx._last_physical, "SessionWindowExec")._tier is not None
    p.close()


# -- review-found regression pins ------------------------------------------------


def test_join_v1_snapshot_restores_into_budgeted_run(tmp_path):
    """A snapshot taken while NOTHING was spilled (v1 layout) restored into
    a budgeted run re-seeds the tier's per-batch bookkeeping — the first
    budget check must not index past empty touch/est lists."""
    l_raw, r_raw = join_raw(5, n_batches=10, n=80, keys=40), join_raw(
        9, n_batches=10, n=80, keys=40)
    p = api("torch")

    def build():
        # budget far above the working set: the tier attaches but the
        # snapshot stays v1 (nothing spilled at the cut)
        ctx = p.ctx(checkpoint=True, checkpoint_interval_s=9999,
                    state_backend_path=str(tmp_path / "lsm"),
                    state_budget_bytes=1 << 30)
        left, right = join_sides(p, ctx, l_raw, r_raw)
        ds = left.join(right, "inner", ["k"], ["k2"])
        root = p.executor.build_physical(p.lp.Sink(ds._plan, p.Sink()), ctx)
        spill = p.tier.attach_spill(root, ctx)
        orch = p.Orch(interval_s=9999)
        return root, spill, orch, p.wire(root, ctx, orch)

    try:
        root, spill, orch, coord = build()
        committed = False
        it = root.run()
        orch.trigger_now()  # barrier early: both sides still live
        for item in it:
            if isinstance(item, p.base.Marker):
                coord.commit(item.epoch)
                committed = True
                break
        it.close()
        spill.close()
        assert committed, "barrier never aligned before EOS"
        p.close()
        root2, spill2, _orch2, coord2 = build()
        assert coord2.committed_epoch is not None
        n = 0
        for item in root2.run():  # used to IndexError on the 1st batch
            if isinstance(item, p.Batch):
                n += item.num_rows
            if isinstance(item, p.base.EndOfStream):
                break
        spill2.close()
        assert n > 0
    finally:
        p.close()


def last_acc(p):
    class Last(p.Accumulator):
        def __init__(self):
            self.v = 0.0

        def update(self, values):
            if len(values):
                self.v = float(values[-1])

        def merge(self, states):
            self.v = states[0]

        def state(self):
            return [self.v]

        def evaluate(self):
            return self.v

    return p.F.udaf(Last, p.DT.FLOAT64, "last_v")


def udaf_marker_op(p, path):
    """The JAX test's operator: 8 batches of 1,500 keys into 5 s windows,
    a marker at the cut, then EOS; with a 30,000-byte tier and a
    coordinator on ``path`` → (op, store, ctrl, coord)."""
    in_schema = p.Schema([
        p.Field(CANONICAL_TIMESTAMP_COLUMN, p.DT.TIMESTAMP_MS, nullable=False),
        p.Field("k", p.DT.STRING, nullable=False),
        p.Field("v", p.DT.FLOAT64),
    ])
    rng = np.random.default_rng(2)
    items = []
    for b in range(8):
        ts = np.sort(T0 + b * 300 + rng.integers(0, 300, 150))
        ks = np.asarray([f"k{i}" for i in rng.integers(0, 1500, 150)], object)
        items.append(p.Batch(in_schema, [ts, ks, rng.normal(5, 1, 150)]))
    items += [p.base.Marker(1), p.base.EOS]

    class Script(p.base.ExecOperator):
        schema = in_schema

        def run(self):
            yield from items

    store = p.lsm.LsmStore(path)
    ctrl = p.tier.SpillController(store, budget_bytes=30_000)
    coord = p.Coord(store)
    wt = jlp.WindowType if p.Win is JWin else tlp.WindowType
    op = p.udaf.UdafWindowExec(
        Script(), [p.col("k")],
        [last_acc(p)(p.col("v")).alias("lv"),
         p.F.count(p.col("v")).alias("n")],
        wt.TUMBLING, 5000, None,  # frames open across the cut
    )
    op.enable_spill("0_udaf", ctrl)
    op.enable_checkpointing("0", coord, None)
    return op, store, ctrl, coord


def frame_keys(p, op) -> dict:
    return {j: [str(op._interner.keys_of(np.asarray([g]))[0][0]) for g in f]
            for j, f in op._frames.items()}


def test_udaf_restore_preserves_marker_positions(tmp_path):
    """A snapshot taken with spilled markers INTERLEAVED among resident
    groups: after restore the frame dict order (== emission row order) is
    the pre-kill order — markers are recorded in position.  The port's cut
    equals the JAX package's, and each restores the other's."""
    before = {}
    for pkg in PKGS:
        p = api(pkg)
        op, store, ctrl, coord = udaf_marker_op(p, str(tmp_path / pkg))
        for item in op.run():
            if isinstance(item, p.base.Marker):
                coord.commit(item.epoch)
                break
        marks = {j: [f[g] is p.udaf.SPILLED for g in f]
                 for j, f in op._frames.items()}
        assert any(any(m) and not all(m) for m in marks.values()), (
            "cut did not interleave spilled and resident groups")
        before[pkg] = (frame_keys(p, op), marks)
        ctrl.close()
        store.close()
    assert before["torch"] == before["jax"]
    for writer in PKGS:
        for reader in PKGS:
            p = api(reader)
            op, store, ctrl, coord = udaf_marker_op(p, str(tmp_path / writer))
            assert coord.committed_epoch is not None
            assert frame_keys(p, op) == before[writer][0], (writer, reader)
            ctrl.close()
            store.close()


# -- the port's own cases --------------------------------------------------------


def test_float64_ring_under_a_budget_matches_the_jax_package(tmp_path):
    """A float64 ring under a budget: the tier charges each cell the torch
    dtype's 8 bytes, as the JAX package (x64 on) charges its ring, so both
    spill the same windows; the rows equal the port's unbudgeted f64 run
    and the JAX package's budgeted one."""
    p = api("torch")
    golden = run_window(p, window_op(p, *window_items(p, True),
                                     accum_dtype=torch.float64))
    # 16 slots x 4 planes x 128 groups: 65,536 B at 8 B a cell, 32,768 B
    # at 4, and 50 keys x 64 B: a 50,000-byte budget holds the ring only
    # where it is charged half its bytes
    got, st, op = budgeted_window("torch", str(tmp_path / "t"), True,
                                  budget=50_000, accum_dtype=torch.float64)
    assert op._spec.accum_dtype is torch.float64
    with jax.enable_x64(True):
        jgot, jst, _ = budgeted_window("jax", str(tmp_path / "j"), True,
                                       budget=50_000,
                                       accum_dtype=jnp.float64)
    assert got == golden
    assert_ring_rows(got, jgot)
    assert st["spill_blocks_total"] > 0 and st["reload_blocks_total"] > 0
    assert totals(st) == totals(jst)
    # a float32 ring fits the same budget and spills nothing
    _, st32, _ = budgeted_window("torch", str(tmp_path / "t32"), True,
                                 budget=50_000)
    assert st32["spill_blocks_total"] == 0


def test_ring_shrinks_after_a_spill_and_keeps_windows_by_index(tmp_path):
    """A 30 s lag over 2 s batches grows the ring past 16 slots; the
    tier's spill then rebuilds it at a smaller W (``_grow(window_slots=…)``
    run to shrink), laying the resident windows out again by absolute
    index: every row equals the unbudgeted run's, and the JAX package
    grows and shrinks its ring at the same points."""
    p = api("torch")
    in_schema, items = window_items(p, True, lag_ms=30_000, step_ms=2000)
    golden_op = window_op(p, in_schema, items)
    golden = run_window(p, golden_op)
    assert golden_op._spec.window_slots >= 32
    slots = {}
    for pkg in PKGS:
        q = api(pkg)
        q_schema, q_items = window_items(q, True, lag_ms=30_000,
                                         step_ms=2000)
        store = q.lsm.LsmStore(str(tmp_path / pkg))
        try:
            ctrl = q.tier.SpillController(store, budget_bytes=60_000)
            op = window_op(q, q_schema, q_items)
            op.enable_spill("0_win", ctrl)
            resizes = []
            grow = op._grow

            def record(*, window_slots=None, group_capacity=None,
                       _op=op, _grow=grow, _log=resizes):
                w0 = _op._spec.window_slots
                _grow(window_slots=window_slots,
                      group_capacity=group_capacity)
                _log.append((w0, _op._spec.window_slots))

            op._grow = record
            got = run_window(q, op)
            ctrl.close()
        finally:
            store.close()
        slots[pkg] = (resizes, got)
    assert slots["torch"][1] == golden
    assert_ring_rows(slots["torch"][1], slots["jax"][1])
    assert slots["torch"][0] == slots["jax"][0]
    assert any(w1 < w0 for w0, w1 in slots["torch"][0]), slots["torch"][0]


def window_cut(p, path, items, in_schema, cut_at, budget, tier=True):
    """Run the scripted window feed with a coordinator on ``path``: a
    marker after item ``cut_at`` is committed, then the run stops →
    (rows before the cut, the operator)."""
    store = p.lsm.LsmStore(path)
    coord = p.Coord(store)
    ctrl = p.tier.SpillController(store, budget_bytes=budget) if tier else None
    feed = items[:cut_at] + [p.base.Marker(1)] + items[cut_at:]
    op = window_op(p, in_schema, feed)
    if ctrl is not None:
        op.enable_spill("0_win", ctrl)
    op.enable_checkpointing("0", coord, None)
    out = []
    it = op.run()
    for item in it:
        if isinstance(item, p.Batch):
            out.extend(rows(item))
        if isinstance(item, p.base.Marker):
            coord.commit(item.epoch)
            break
    it.close()
    if ctrl is not None:
        ctrl.close()
    store.close()
    return out, op


def window_resume(p, path, items, in_schema, cut_at, budget):
    """Restore from ``path`` (with a tier when ``budget``) and run the
    items after the cut → (rows, the operator)."""
    store = p.lsm.LsmStore(path)
    coord = p.Coord(store)
    ctrl = (p.tier.SpillController(store, budget_bytes=budget)
            if budget else None)
    op = window_op(p, in_schema, [items[0]] + items[cut_at:])
    if ctrl is not None:
        op.enable_spill("0_win", ctrl)
    op.enable_checkpointing("0", coord, None)
    out = run_window(p, op)
    if ctrl is not None:
        ctrl.close()
    store.close()
    return out, op


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("budget", [20_000, None])
def test_spilled_window_checkpoint_crosses_packages(tmp_path, writer, reader,
                                                    budget):
    """A window snapshot holding spilled windows (``spill_windows`` refs,
    their planes committed as epoch blocks) written by either package
    restores in the other — into a budgeted run (the tier map re-arms) and
    into an unbudgeted one (the planes go back into the ring) — and the
    rows before and after the cut are the uninterrupted run's."""
    w, r = api(writer), api(reader)
    w_schema, w_items = window_items(w, True)
    r_schema, r_items = window_items(r, True)
    cut_at = 25  # mid-stream, after the tier spilled
    golden = run_window(r, window_op(r, r_schema, r_items))
    path = str(tmp_path / "lsm")
    before, op_w = window_cut(w, path, w_items, w_schema, cut_at, 20_000)
    assert op_w._tier.any_spilled, "nothing spilled at the cut"
    after, op_r = window_resume(r, path, r_items, r_schema, cut_at, budget)
    if budget is None:
        assert op_r._tier is None
    else:
        assert op_r._tier is not None
    assert_ring_rows(before + after, golden)


def test_reload_writes_only_the_reloaded_slots(tmp_path, monkeypatch):
    """A reload writes the reloaded windows' slots on the ring's device —
    one indexed copy a plane (``write_slots``) — rather than exporting,
    editing and importing the whole ring: every call names distinct slots,
    all of the ring's component planes, and no more windows than came
    back."""
    from denormalized_tpu_torch.parallel import sharded_state

    calls = []
    orig = sharded_state.SingleDeviceWindowState.write_slots

    def write_slots(self, slots, planes):
        calls.append((list(slots), sorted(planes),
                      {k: v.shape for k, v in planes.items()}))
        return orig(self, slots, planes)

    monkeypatch.setattr(sharded_state.SingleDeviceWindowState,
                        "write_slots", write_slots)
    got, st, op = budgeted_window("torch", str(tmp_path / "lsm"), True)
    assert calls, "no reload wrote slots"
    labels = sorted(c.label for c in op._spec.components)
    for slots, names, shapes in calls:
        assert len(slots) == len(set(slots))
        assert names == labels
        assert {sh[0] for sh in shapes.values()} == {len(slots)}
    assert sum(len(c[0]) for c in calls) <= st["reload_blocks_total"]
