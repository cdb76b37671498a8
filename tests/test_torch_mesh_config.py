"""``EngineConfig(mesh_devices=…, mesh_slices=…, shard_strategy=…)`` in the
port against the JAX package: the planner picks the same window-state
layout for every strategy, mesh shape and ``device_strategy``, and raises
wherever the JAX package raises.  Also the port's mesh constructors and
its device-list rule: ``device="cuda"`` means every visible card, a named
device holds every shard."""

import numpy as np
import pytest
import torch

import denormalized_tpu as jt
import denormalized_tpu_torch as tt
from denormalized_tpu.api import functions as JF
from denormalized_tpu.api.context import EngineConfig as JConfig
from denormalized_tpu.common.record_batch import RecordBatch as JBatch
from denormalized_tpu.common.schema import DataType as JType
from denormalized_tpu.common.schema import Field as JField
from denormalized_tpu.common.schema import Schema as JSchema
from denormalized_tpu.logical import plan as jlp
from denormalized_tpu.physical.simple_execs import CollectSink as JSink
from denormalized_tpu.runtime import executor as jexec
from denormalized_tpu.sources.memory import MemorySource as JSource
from denormalized_tpu_torch.api import functions as TF
from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.common.record_batch import RecordBatch as TBatch
from denormalized_tpu_torch.common.schema import DataType as TType
from denormalized_tpu_torch.common.schema import Field as TField
from denormalized_tpu_torch.common.schema import Schema as TSchema
from denormalized_tpu_torch.logical import plan as tlp
from denormalized_tpu_torch.parallel import mesh as tmesh
from denormalized_tpu_torch.physical.simple_execs import CollectSink as TSink
from denormalized_tpu_torch.planner.planner import Planner
from denormalized_tpu_torch.runtime import executor as texec
from denormalized_tpu_torch.sources.memory import MemorySource as TSource

# (mesh_devices, mesh_slices): meshes both packages build on 8 devices,
# and the shapes both refuse
SHAPES = [(None, None), (1, None), (2, None), (4, None), (8, None), (3, None),
          (2, 2), (4, 2), (8, 2), (8, 4), (None, 2), (6, 4), (6, 3), (8, 3)]
STRATEGIES = ["auto", "key_sharded", "partial_final", "two_level", "bogus"]
DEVICE_STRATEGIES = ["scatter", "pallas_dense", "auto", "partial_merge"]


def _plan(pkg, min_groups, slide=None, aggs=("count",), slice_windows=False,
          **cfg):
    """The window operator (or the error) each package's planner gives."""
    if pkg == "jax":
        Schema, Field, DT, Batch, Src, F, col = (
            JSchema, JField, JType, JBatch, JSource, JF, jt.col)
        ctx = jt.Context(JConfig(min_group_capacity=min_groups,
                                 slice_windows=slice_windows, **cfg))
        build, Sink, lp = jexec.build_physical, JSink, jlp
    else:
        Schema, Field, DT, Batch, Src, F, col = (
            TSchema, TField, TType, TBatch, TSource, TF, tt.col)
        ctx = tt.Context(tt.EngineConfig(device="cpu", min_group_capacity=min_groups,
                                         slice_windows=slice_windows, **cfg))
        build, Sink, lp = texec.build_physical, TSink, tlp
    schema = Schema([Field("occurred_at_ms", DT.INT64, nullable=False),
                     Field("sensor_name", DT.STRING, nullable=False),
                     Field("reading", DT.FLOAT64)])
    batch = Batch(schema, [np.arange(4, dtype=np.int64),
                           np.array(list("abab"), dtype=object), np.ones(4)])
    ds = ctx.from_source(Src.from_batches([batch],
                                          timestamp_column="occurred_at_ms"))
    ds = ds.window(["sensor_name"],
                   [getattr(F, a)(col("reading")).alias(a) for a in aggs],
                   1000, slide)
    return build(lp.Sink(ds._plan, Sink()), ctx).input_op


def _layout(pkg, min_groups, **cfg):
    try:
        op = _plan(pkg, min_groups, **cfg)
    except (ValueError, PlanError) as e:
        return ("raises", type(e).__name__)
    backend = getattr(op, "_backend", None)
    return type(op).__name__, type(backend).__name__


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_layout_choice_matches_jax(shape, strategy):
    """Same layout (or the same refusal) for every device strategy, below
    and above the 4,096-group line of 'auto'.  One device is the known
    difference: 'auto' there is row shipping in the port (the JAX
    package's rule for a co-located GPU) and host partials on the JAX CPU
    backend."""
    n_dev, n_sl = shape
    for dstrat in DEVICE_STRATEGIES:
        for groups in (128, 8192):
            cfg = dict(mesh_devices=n_dev, mesh_slices=n_sl,
                       shard_strategy=strategy, device_strategy=dstrat)
            want = _layout("jax", groups, **cfg)
            got = _layout("torch", groups, **cfg)
            if (n_dev or 1) == 1 and dstrat == "auto" and got[0] != "raises":
                assert got[1] == "SingleDeviceWindowState"
                assert want[1] == "PartialMergeWindowState"
                continue
            assert got == want, (cfg, groups)


@pytest.mark.parametrize(
    "cfg, match",
    [(dict(mesh_slices=2), "mesh_slices requires mesh_devices"),
     (dict(mesh_devices=6, mesh_slices=4), "must be a multiple of"),
     (dict(mesh_devices=2, mesh_slices=4), "must be a multiple of"),
     (dict(mesh_devices=6, mesh_slices=3), "must be a power of two"),
     (dict(mesh_devices=4, shard_strategy="two_level"), "needs a 2-D mesh"),
     (dict(mesh_devices=4, mesh_slices=2, shard_strategy="key_sharded"),
      "does not fit a 2-D"),
     (dict(mesh_devices=4, mesh_slices=2, device_strategy="partial_merge"),
      "partial_merge composes"),
     (dict(mesh_devices=4, shard_strategy="bogus"), "unknown shard strategy")],
)
def test_engine_config_refusals(cfg, match):
    """Each refusal in both packages, with the JAX package's words."""
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match=match):
            _plan(pkg, 128, **cfg)


def test_key_sharded_refuses_indivisible_capacity():
    from denormalized_tpu_torch.ops import segment_agg as sa
    from denormalized_tpu_torch.parallel.sharded_state import make_sharded_state

    spec = sa.WindowKernelSpec(tuple(sa.components_for([("count", 0)])), 1,
                               16, 384, 1000, 1000)
    with pytest.raises(ValueError, match="not divisible by the mesh size 5"):
        make_sharded_state(spec, "cpu", "scatter",
                           tmesh.make_mesh(5, devices=["cpu"] * 5),
                           "key_sharded")


def test_capacity_rounds_to_the_mesh():
    """G rounds up so every shard is a multiple of 128 lanes."""
    from denormalized_tpu_torch.physical.window_exec import _round_capacity

    assert _round_capacity(100, 1) == 128
    assert _round_capacity(100, 3) == 384
    assert _round_capacity(1025, 8) == 2048
    op = _plan("torch", 128, mesh_devices=3, shard_strategy="key_sharded")
    assert op.backend.group_capacity == 384
    assert op.backend.spec.group_capacity == 128


def test_mesh_routes_keep_the_device_ring():
    """Under a mesh the slice path and native sketches are off, as in the
    JAX package: the window stays the ring operator."""
    for pkg in ("jax", "torch"):
        assert type(_plan(pkg, 128, slice_windows=True)).__name__ == (
            "SliceWindowExec")
        assert type(_plan(pkg, 128, slice_windows=True, mesh_devices=2)
                    ).__name__ == "StreamingWindowExec"


def test_approx_aggregates_lower_under_a_mesh():
    """_route_approx's mesh clause: sketch kinds stay native on the slice
    path only without a mesh."""
    from denormalized_tpu_torch.logical.expr import SKETCH_AGG_KINDS

    def kinds(**cfg):
        ctx = tt.Context(tt.EngineConfig(device="cpu", slice_windows=True,
                                         **cfg))
        schema = TSchema([TField("occurred_at_ms", TType.INT64, nullable=False),
                          TField("sensor_name", TType.STRING, nullable=False),
                          TField("reading", TType.FLOAT64)])
        ds = ctx.from_source(TSource.from_batches(
            [TBatch(schema, [np.arange(2, dtype=np.int64),
                             np.array(["a", "b"], dtype=object), np.ones(2)])],
            timestamp_column="occurred_at_ms",
        )).window(["sensor_name"],
                  [TF.approx_distinct(tt.col("reading")).alias("d")], 1000)
        node = ds._plan
        while not isinstance(node, tlp.StreamingWindow):
            node = node.input
        return [a.kind for a in Planner(ctx.config)._route_approx(node)]

    assert kinds()[0] in SKETCH_AGG_KINDS
    assert kinds(mesh_devices=2) == ["udaf"]


def test_make_mesh_errors_and_shapes():
    m = tmesh.make_mesh(4, devices=["cpu"] * 6)
    assert m.devices.size == 4 and m.axis_names == (tmesh.KEY_AXIS,)
    assert m.shape[tmesh.KEY_AXIS] == 4
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        tmesh.make_mesh(4, devices=["cpu"] * 2)
    m2 = tmesh.make_mesh_2d(2, devices=["cpu"] * 8)
    assert m2.shape == {tmesh.SLICE_AXIS: 2, tmesh.KEY_AXIS: 4}
    assert m2.devices.shape == (2, 4)
    with pytest.raises(ValueError, match="not divisible by 3 slices"):
        tmesh.make_mesh_2d(3, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match=r"need 8 devices \(2x4\), have 6"):
        tmesh.make_mesh_2d(2, 4, devices=["cpu"] * 6)


def test_device_list_rule(monkeypatch):
    """'cuda' without an index is every visible card (more shards than
    cards raises, as the JAX package does); a named device holds every
    shard."""
    assert tmesh.devices_for("cpu", 3) == [torch.device("cpu")] * 3
    assert tmesh.devices_for("cuda:0", 4) == [torch.device("cuda", 0)] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.devices_for("cuda", 4) == [torch.device("cuda", 0),
                                            torch.device("cuda", 1)]
    planner = Planner(tt.EngineConfig(device="cuda", mesh_devices=4))
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        planner._mesh()
    mesh = Planner(tt.EngineConfig(device="cuda", mesh_devices=2))._mesh()
    assert list(mesh.devices.flat) == [torch.device("cuda", 0),
                                       torch.device("cuda", 1)]
    mesh = Planner(tt.EngineConfig(device="cuda:0", mesh_devices=4,
                                   mesh_slices=2))._mesh()
    assert mesh.devices.shape == (2, 2)
    assert set(mesh.devices.flat) == {torch.device("cuda", 0)}


def test_engine_config_fields():
    cfg = tt.EngineConfig()
    assert (cfg.mesh_devices, cfg.mesh_slices, cfg.shard_strategy) == (
        None, None, "auto")
    cfg.set("denormalized_config.mesh_devices", 4)
    assert cfg.mesh_devices == 4
