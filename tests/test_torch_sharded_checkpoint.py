"""Checkpoints of a sharded ring, and state carried in from the JAX
package's sharded layouts.

A sharded window snapshots merged ``(W, G_total)`` planes — the JAX
package's format — so a snapshot restores into any layout: the twins of
tests/test_checkpoint.py's mesh cases (:217, :759) crash the port's job
after a committed epoch and restore it, and a key-sharded checkpoint at
n = 4 restores into n = 2, into one device and into the partial layouts.
A JAX key-sharded or partial/final ring exported mid-stream loads into the
port's same layout through ``import_`` and both continue to the same
emissions (tests/test_torch_state_carry.py's pattern).  Counts and minima
exact, sums to rtol=1e-4 (f32 sums in another order across the cut), as
the port's checkpoint twins hold them."""

import shutil
import threading

import numpy as np
import pytest

import denormalized_tpu_torch as tt
from denormalized_tpu.parallel import mesh as jmesh
from denormalized_tpu.physical.base import EOS as J_EOS
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.parallel import mesh as tmesh
from denormalized_tpu_torch.physical.base import EOS as T_EOS
from denormalized_tpu_torch.physical.base import Marker as TMarker
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.state import checkpoint as tck
from denormalized_tpu_torch.state import lsm as tlsm
from denormalized_tpu_torch.state.orchestrator import Orchestrator as TOrch
from test_torch_checkpoint import (
    assert_union_matches,
    jax_golden,
    port_batches,
    port_pipeline,
    raw_stream,
    windows_of,
)
from test_torch_join_checkpoint import (
    api,
    assert_windows,
    ckpt,
    crash_after_commit,
    join_windows,
    restore_and_run,
    sensor_raw,
    window_join,
)
from test_torch_state_carry import AGGS, JFeed, TFeed, _batches, _raw, _rows


@pytest.fixture(autouse=True)
def _clean_global_backends():
    yield
    tlsm.close_global_state_backend()
    from denormalized_tpu.state.lsm import close_global_state_backend

    close_global_state_backend()


def _mesh_cfg(layout, n=8):
    if layout == "partial_merge":
        return dict(mesh_devices=n, device_strategy="partial_merge",
                    emit_lag_ms=0)
    return dict(mesh_devices=n, shard_strategy=layout,
                mesh_slices=2 if layout == "two_level" else None,
                device_strategy="scatter")


def _cfg(path, **kw):
    return tt.EngineConfig(device="cpu", checkpoint=path is not None,
                           checkpoint_interval_s=9999,
                           state_backend_path=path, **kw)


def _run_until_commit(state_dir, batches, **kw):
    """Crash right after the first committed epoch (a barrier forced after
    the root's second item) → (emitted, epoch, backend at the crash)."""
    ctx = tt.Context(_cfg(state_dir, **kw))
    root = texec.build_physical(
        tlp.Sink(port_pipeline(ctx, batches)._plan, TSink()), ctx
    )
    orch = TOrch(interval_s=9999)
    coord = tck.wire_checkpointing(root, ctx, orch)
    emitted, epoch, seen = {}, None, 0
    it = root.run()
    for item in it:
        if isinstance(item, TBatch):
            emitted.update(windows_of(item))
        if seen == 1:
            orch.trigger_now()
        if isinstance(item, TMarker):
            coord.commit(item.epoch)
            epoch = item.epoch
            break
        seen += 1
    it.close()  # crash
    orch.stop()
    tlsm.close_global_state_backend()
    return emitted, epoch, root.input_op.backend


def _run_to_end(state_dir, batches, **kw):
    ctx = tt.Context(_cfg(state_dir, **kw))
    res = port_pipeline(ctx, batches).collect()
    tlsm.close_global_state_backend()
    return windows_of(res), ctx.last_checkpointing()[0], ctx._last_physical.input_op


@pytest.mark.parametrize("layout", ["key_sharded", "partial_final", "two_level",
                                    "partial_merge"])
def test_kill_and_restore_sharded(tmp_path, layout):
    """Twin of tests/test_checkpoint.py:217 (and the key-sharded partial
    merge): crash after one committed epoch, restore into the same mesh,
    and the union of both runs is the JAX package's uninterrupted run."""
    raw = raw_stream(31, 10, n=256, n_keys=40)
    batches = port_batches(raw)
    state = str(tmp_path / "state")
    a, epoch, _ = _run_until_commit(state, batches, **_mesh_cfg(layout))
    assert epoch is not None
    b, coord, window = _run_to_end(state, batches, **_mesh_cfg(layout))
    assert coord.restored_epoch == epoch
    golden = jax_golden(raw)
    assert_union_matches(golden, a, b)
    assert len(b) < len(golden)
    assert window.backend.n == 8


def test_key_sharded_checkpoint_restores_into_other_layouts(tmp_path):
    """A key-sharded checkpoint at n = 4 restores into n = 2, into one
    device, and into the partial layouts: every union is the golden."""
    raw = raw_stream(33, 10, n=256, n_keys=300)
    batches = port_batches(raw)
    base = tmp_path / "state4"
    a, epoch, crashed = _run_until_commit(str(base), batches,
                                          **_mesh_cfg("key_sharded", 4))
    assert crashed.n == 4 and crashed.shard_scatter[0] > 0
    golden = jax_golden(raw)
    for name, kw in [("ks2", _mesh_cfg("key_sharded", 2)),
                     ("single", {}),
                     ("pf4", _mesh_cfg("partial_final", 4)),
                     ("tl4", _mesh_cfg("two_level", 4))]:
        copy = tmp_path / name
        shutil.copytree(base, copy)
        b, coord, window = _run_to_end(str(copy), batches, **kw)
        assert coord.restored_epoch == epoch, name
        assert_union_matches(golden, a, b)
        assert window.metrics()["rows_in"] < sum(len(r[0]) for r in raw)


def test_join_kill_and_restore_sharded(tmp_path):
    """Twin of tests/test_checkpoint.py:759's sharded case: two windowed
    streams on an 8-shard mesh joined, killed after a committed aligned
    barrier and restored."""
    t_raw, h_raw = sensor_raw(41, 0), sensor_raw(42, 100)
    jp = api("jax")
    golden = join_windows(
        [window_join(jp, jp.ctx(emit_lag_ms=0), t_raw, h_raw).collect()]
    )
    p = api("torch")
    cfg = dict(mesh_devices=8, emit_lag_ms=0, **ckpt(str(tmp_path / "state")))
    ctx_a = p.ctx(**cfg)
    gate = threading.Event()
    a, _ = crash_after_commit(
        p, ctx_a, window_join(p, ctx_a, t_raw, h_raw, gate=gate),
        after_trigger=gate.set)
    ctx_b = p.ctx(**cfg)
    b, root = restore_and_run(p, ctx_b, window_join(p, ctx_b, t_raw, h_raw))
    got_a, got_b = join_windows(a), join_windows(b)
    both = dict(got_a)
    both.update(got_b)
    assert_windows(both, golden)
    assert len(got_b) < len(golden) or not got_a


def _windows(pkg, feed, layout, slide):
    """A window operator over an 8-device JAX mesh, or a 4-shard port
    mesh on the CPU."""
    from denormalized_tpu.logical.expr import AggregateExpr as JAgg
    from denormalized_tpu.logical.expr import col as jcol
    from denormalized_tpu.logical.plan import WindowType as JWT
    from denormalized_tpu.physical.window_exec import StreamingWindowExec as JW
    from denormalized_tpu_torch.logical.expr import AggregateExpr as TAgg
    from denormalized_tpu_torch.logical.expr import col as tcol
    from denormalized_tpu_torch.logical.plan import WindowType as TWT
    from denormalized_tpu_torch.physical.window_exec import StreamingWindowExec as TW

    if pkg == "jax":
        return JW(feed, [jcol("sensor_name")],
                  [JAgg(k, jcol("reading"), k) for k in AGGS], JWT.SLIDING,
                  1000, slide, mesh=jmesh.make_mesh(8),
                  shard_strategy=layout, device_strategy="scatter")
    return TW(feed, [tcol("sensor_name")],
              [TAgg(k, tcol("reading"), k) for k in AGGS], TWT.SLIDING,
              1000, slide, device="cpu",
              mesh=tmesh.make_mesh(4, devices=["cpu"] * 4),
              shard_strategy=layout)


@pytest.mark.parametrize("layout", ["key_sharded", "partial_final"])
@pytest.mark.parametrize("slide", [1000, 200])
def test_jax_sharded_ring_carried_into_the_port(layout, slide):
    """A JAX sharded ring exported after half the batches (its merged
    ``(W, G)`` planes and interner) loads into the port's same layout; the
    port continues to the JAX package's emissions."""
    raw = _raw(slide + 7)
    jschema, jb = _batches("jax", raw)
    tschema, tb = _batches("torch", raw)
    cut = 5
    full = _rows(_windows("jax", JFeed(jschema, jb, J_EOS), layout, slide).run())
    head = _windows("jax", JFeed(jschema, jb[:cut], None), layout, slide)
    head_rows = _rows(head.run())
    assert head._backend.strategy_name == layout
    tail = _windows("torch", TFeed(tschema, tb[cut:], T_EOS), layout, slide)
    tail.load_state(
        head._backend.export(), head._interner.snapshot(), head._first_open,
        head._max_win_seen, head._watermark_ms, head._any_nulls_seen,
    )
    tail_rows = _rows(tail.run())
    assert tail.backend.strategy_name == layout
    assert tail.backend.shard_scatter == [len(tb) - cut] * 4
    assert not set(head_rows) & set(tail_rows)
    carried = {**head_rows, **tail_rows}
    assert set(carried) == set(full)
    for k, want in full.items():
        got = carried[k]
        assert got[0] == want[0], (k, got, want)
        np.testing.assert_array_equal(got[2:4], want[2:4], err_msg=str(k))
        np.testing.assert_allclose([got[1], got[4]], [want[1], want[4]],
                                   rtol=1e-5, err_msg=str(k))


@pytest.mark.parametrize("layout", ["key_sharded", "partial_final", "two_level",
                                    "partial_merge"])
def test_window_spill_on_a_mesh(tmp_path, layout):
    """The cold tier over a sharded ring (slots read off every shard,
    reloaded through ``write_slots``), both packages on 4 shards: the
    port's rows equal its unsharded, unbudgeted run's and the JAX
    package's sharded budgeted run's, with spills and reloads."""
    from test_torch_state_spill import (
        assert_ring_rows,
        budgeted_window,
        run_window,
        window_items,
        window_op,
    )
    from test_torch_state_spill import api as spill_api

    def kw(pkg):
        if pkg == "torch":
            m = (tmesh.make_mesh_2d(2, 2, devices=["cpu"] * 4)
                 if layout == "two_level"
                 else tmesh.make_mesh(4, devices=["cpu"] * 4))
        else:
            import jax

            m = (jmesh.make_mesh_2d(2, 2, devices=jax.devices()[:4])
                 if layout == "two_level" else jmesh.make_mesh(4))
        if layout == "partial_merge":
            return dict(mesh=m, device_strategy="partial_merge", emit_lag_ms=0)
        return dict(mesh=m, shard_strategy=layout, device_strategy="scatter")

    p = spill_api("torch")
    golden = run_window(p, window_op(p, *window_items(p, True)))
    got, st = {}, {}
    for pkg in ("jax", "torch"):
        got[pkg], st[pkg], op = budgeted_window(
            pkg, str(tmp_path / pkg), True, **kw(pkg))
        assert op._backend.strategy_name.split("/")[0] == layout
    assert_ring_rows(got["torch"], golden)
    assert_ring_rows(got["torch"], got["jax"])
    assert st["torch"]["spill_blocks_total"] > 0
    assert st["torch"]["reload_blocks_total"] > 0
