"""The PyTorch/CUDA port stands alone: it imports neither jax nor anything
of denormalized_tpu, and it never hides the device or the kernel — no CUDA
without device="cpu" raises, a non-CPU tensor never reaches a plain
version, and a failed kernel build raises.  A failed build of the native
HOST code is different: the numpy reducer and the dict interner take over,
logged and counted."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import denormalized_tpu_torch as tt
from denormalized_tpu_torch.common.errors import PlanError
from denormalized_tpu_torch.ops import compact_slot as cs
from denormalized_tpu_torch.ops import cuda_build
from denormalized_tpu_torch.native import build as native_build
from denormalized_tpu_torch.ops import dense_window as dw
from denormalized_tpu_torch.ops import host_partial as hp
from denormalized_tpu_torch.ops import interner as ti
from denormalized_tpu_torch.ops import merge_partials as mp
from denormalized_tpu_torch.ops import segment_agg as sa

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "denormalized_tpu_torch"


# modules of the partial_merge, checkpoint, join, expression, live-source
# and window-option slices,
# named so a rename cannot drop them from the blocked-import check unseen
NEW_MODULES = (
    "denormalized_tpu_torch.logical.scalar_functions",
    "denormalized_tpu_torch.logical.array_functions",
    "denormalized_tpu_torch.api.functions",
    "denormalized_tpu_torch.native.build",
    "denormalized_tpu_torch.ops.host_partial",
    "denormalized_tpu_torch.ops.merge_partials",
    "denormalized_tpu_torch.ops.interner",
    "denormalized_tpu_torch.logical.optimizer",
    "denormalized_tpu_torch.obs",
    "denormalized_tpu_torch.obs.registry",
    "denormalized_tpu_torch.runtime.faults",
    "denormalized_tpu_torch.runtime.tracing",
    "denormalized_tpu_torch.state.channel_manager",
    "denormalized_tpu_torch.state.checkpoint",
    "denormalized_tpu_torch.state.lsm",
    "denormalized_tpu_torch.state.orchestrator",
    "denormalized_tpu_torch.state.serialization",
    "denormalized_tpu_torch.runtime.pump",
    "denormalized_tpu_torch.physical.join_exec",
    "denormalized_tpu_torch.obs.statewatch",
    "denormalized_tpu_torch.obs.doctor.actions",
    "denormalized_tpu_torch.ops.sketches",
    # the live-source slice
    "denormalized_tpu_torch.common.columns",
    "denormalized_tpu_torch.formats",
    "denormalized_tpu_torch.formats.json_codec",
    "denormalized_tpu_torch.formats._native_parser_base",
    "denormalized_tpu_torch.formats.native_json",
    "denormalized_tpu_torch.sources.kafka",
    "denormalized_tpu_torch.runtime.prefetch",
    "denormalized_tpu_torch.state.tiering",
    "denormalized_tpu_torch.testing.mock_kafka",
    # the window options' slice: the compaction kernel's wrapper
    "denormalized_tpu_torch.ops.compact_slot",
    # the API surface slice: Avro, CSV, Feast
    "denormalized_tpu_torch.formats.avro_codec",
    "denormalized_tpu_torch.formats.native_avro",
    "denormalized_tpu_torch.sources.csv",
    "denormalized_tpu_torch.api.feast_data_stream",
    # the UDAF and session slice
    "denormalized_tpu_torch.api.udaf",
    "denormalized_tpu_torch.api.builtin_accumulators",
    "denormalized_tpu_torch.datafusion",
    "denormalized_tpu_torch.physical.udaf_exec",
    "denormalized_tpu_torch.physical.session_exec",
    "denormalized_tpu_torch.physical.session_reference",
    "denormalized_tpu_torch.ops.session_table",
    # the multi-query slice
    "denormalized_tpu_torch.ops.slice_store",
    "denormalized_tpu_torch.planner.predicates",
    "denormalized_tpu_torch.planner.sharing",
    "denormalized_tpu_torch.physical.slice_exec",
    "denormalized_tpu_torch.runtime.multi_query",
    # the observability slice
    "denormalized_tpu_torch.obs.catalog",
    "denormalized_tpu_torch.obs.spans",
    "denormalized_tpu_torch.obs.readers",
    "denormalized_tpu_torch.obs.jsonl",
    "denormalized_tpu_torch.obs.prometheus",
    "denormalized_tpu_torch.obs.doctor",
    "denormalized_tpu_torch.obs.doctor.attribution",
    "denormalized_tpu_torch.obs.doctor.profiler",
    "denormalized_tpu_torch.obs.doctor.lineage",
    "denormalized_tpu_torch.obs.doctor.statedoc",
    "denormalized_tpu_torch.obs.doctor.registry",
    "denormalized_tpu_torch.obs.doctor.http",
    # the cluster slice
    "denormalized_tpu_torch.cluster",
    "denormalized_tpu_torch.cluster.benchjob",
    "denormalized_tpu_torch.cluster.coordinator",
    "denormalized_tpu_torch.cluster.exchange",
    "denormalized_tpu_torch.cluster.framing",
    "denormalized_tpu_torch.cluster.hashing",
    "denormalized_tpu_torch.cluster.reader",
    "denormalized_tpu_torch.cluster.rescale",
    "denormalized_tpu_torch.cluster.runtime",
    "denormalized_tpu_torch.cluster.spec",
    "denormalized_tpu_torch.cluster.split",
    "denormalized_tpu_torch.cluster.worker",
    "denormalized_tpu_torch.obs.doctor.clusterdoc",
    "denormalized_tpu_torch.common.lockwitness",
    # the sharded layouts' slice
    "denormalized_tpu_torch.parallel",
    "denormalized_tpu_torch.parallel.mesh",
    "denormalized_tpu_torch.parallel.distributed",
    "denormalized_tpu_torch.testing.multichip",
)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['denormalized_tpu'] = None\n"
        "import denormalized_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    assert name in sys.modules, name\n"
        # the native host code builds and runs with nothing of jax around
        "import numpy as np\n"
        "from denormalized_tpu_torch.ops import host_partial as hp\n"
        "from denormalized_tpu_torch.ops import segment_agg as sa\n"
        "from denormalized_tpu_torch.ops.interner import GroupInterner\n"
        "spec = sa.WindowKernelSpec(tuple(sa.components_for([('sum', 0)])),"
        " 1, 16, 128, 1000, 1000)\n"
        "st = hp.HostPartialStripe(spec, 128)\n"
        "st.add_batch(np.zeros(4, np.int64), np.zeros(4, np.int32),"
        " np.arange(4, dtype=np.int32), np.ones((4, 1)), None, None)\n"
        "assert st.native_batches == 1, 'native reducer did not run'\n"
        "g = GroupInterner(1)\n"
        "g.intern([np.array(['a', 'b', 'a'], dtype=object)])\n"
        "assert g.lanes[0].startswith('native'), g.lanes\n"
        "import shutil, tempfile\n"
        "from denormalized_tpu_torch.state.lsm import LsmStore\n"
        "d = tempfile.mkdtemp()\n"
        "kv = LsmStore(d)\n"
        "assert kv.is_native, 'the native LSM store did not build'\n"
        "kv.close()\n"
        "shutil.rmtree(d)\n"
        # the live path's native libraries: broker, wire client, parser
        "from denormalized_tpu_torch.testing.mock_kafka import MockKafkaBroker\n"
        "from denormalized_tpu_torch.sources.kafka import KafkaClient\n"
        "from denormalized_tpu_torch.formats.json_codec import JsonDecoder\n"
        "from denormalized_tpu_torch.common.schema import Schema, Field, DataType\n"
        "b = MockKafkaBroker().start()\n"
        "b.create_topic('t', 1)\n"
        "c = KafkaClient(b.bootstrap)\n"
        "c.produce('t', 0, [b'{\"x\": 1}'])\n"
        "dec = JsonDecoder(Schema([Field('x', DataType.INT64)]))\n"
        "assert dec._native is not None, 'the native JSON parser did not build'\n"
        "dec.push(c.fetch('t', 0, 0, max_wait_ms=10)[0][0])\n"
        "assert dec.flush().column('x').tolist() == [1]\n"
        "c.close()\n"
        "b.stop()\n"
        # the compaction kernel's wrapper, on its plain version (CPU)
        "import torch\n"
        "from denormalized_tpu_torch.ops import compact_slot as cs\n"
        "cnt = torch.tensor([0, 2, 0, 1], dtype=torch.int32)\n"
        "n, g, (v,) = cs.compact_slot(cnt, [torch.arange(4.0)])\n"
        "assert int(n) == 2 and g.tolist() == [1, 3] and v.tolist() == [1.0, 3.0]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'denormalized_tpu' or m.startswith('denormalized_tpu.')]\n"
        "assert all(sys.modules[m] is None for m in bad), bad\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_source_scan_finds_no_jax_or_reference_import(path):
    def forbidden(mod: str) -> bool:
        top = mod.split(".")[0]
        return top in ("jax", "jaxlib", "denormalized_tpu")

    tree = ast.parse(path.read_text(), filename=str(path))
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            hits += [a.name for a in node.names if forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and forbidden(node.module):
                hits.append(node.module)
    assert not hits, f"{path}: imports {hits}"


def test_spawned_cluster_worker_holds_no_jax(tmp_path):
    """A port cluster's worker processes (spawned ``python -m
    denormalized_tpu_torch.cluster.worker``) load neither jax nor anything
    of denormalized_tpu: each writes its module list when it exits."""
    import json

    from denormalized_tpu_torch.cluster import ClusterSpec, run_cluster

    tests_dir = str(Path(__file__).resolve().parent)
    probe = tmp_path / "probe"
    result = run_cluster(ClusterSpec(
        workdir=str(tmp_path / "wd"), n_workers=2,
        job="torch_cluster_jobs:isolated_job",
        job_args={"partitions": 2, "batches": 3, "rows": 16, "keys": 5,
                  "probe": str(probe), "engine": {"device": "cpu"}},
        sys_path=[tests_dir], liveness_timeout_s=120.0,
    ))
    assert result["status"] == "done"
    reports = [json.loads(p.read_text())
               for p in tmp_path.glob("probe.*")]
    assert len(reports) == 2
    for r in reports:
        assert r["bad"] == [] and r["n_modules"] > 100


def test_cluster_worker_without_cuda_raises(tmp_path):
    """A worker's device is its job's (EngineConfig's "cuda" by default):
    with no card the worker fails, and nothing retries on the CPU."""
    from denormalized_tpu_torch.cluster import ClusterSpec, run_cluster
    from denormalized_tpu_torch.common.errors import StateError

    tests_dir = str(Path(__file__).resolve().parent)
    with pytest.raises(StateError, match="no CUDA device"):
        run_cluster(ClusterSpec(
            workdir=str(tmp_path), n_workers=1,
            job="torch_cluster_jobs:windowed_job",
            job_args={"partitions": 1, "batches": 2, "rows": 8},
            sys_path=[tests_dir], liveness_timeout_s=60.0, max_restarts=0,
        ))


def test_context_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PlanError, match="device='cpu'"):
        tt.Context()
    with pytest.raises(PlanError):
        tt.Context(tt.EngineConfig(device="cuda:0"))
    # an explicit CPU request is honoured
    assert tt.Context(tt.EngineConfig(device="cpu")).device.type == "cpu"


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(dw, "dense_update_reference", refuse)
    spec, state, args = _dense_args("meta")
    with pytest.raises(ValueError, match="no dense window kernel"):
        dw.dense_update(spec, state, *args, 0, min_win_rel=0)


def _dense_args(device, **bad):
    """A one-column tumbling spec, its ring and a 256-row batch on
    ``device``; ``bad`` replaces batch arrays by name."""
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for([("min", 0), ("avg", 0)])),
        num_value_cols=1, window_slots=16, group_capacity=128,
        length_ms=1000, slide_ms=1000,
    )
    ins = dict(
        values=np.zeros((256, 1), np.float32),
        colvalid=np.ones((256, 1), bool),
        win_rel=np.zeros(256, np.int32),
        rem=np.zeros(256, np.int32),
        gid=np.zeros(256, np.int32),
        row_valid=np.ones(256, bool),
    )
    ins.update(bad)
    args = tuple(torch.from_numpy(a).to(device) for a in ins.values())
    return spec, sa.init_state(spec, device), args


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    cuda_build.load.cache_clear()
    try:
        with pytest.raises(cuda_build.KernelBuildError, match="nvcc not found"):
            cuda_build.load("dense_window")
    finally:
        cuda_build.load.cache_clear()


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(values=np.zeros((256, 1), np.float64)), "values must be"),
        (dict(win_rel=np.zeros(255, np.int32)), "rel"),
        (dict(gid=np.zeros((256, 1), np.int32)), "gid"),
    ],
)
def test_wrapper_checks_dtype_and_shape(bad, match):
    spec, state, args = _dense_args("cpu", **bad)
    with pytest.raises((TypeError, ValueError), match=match):
        dw.dense_update(spec, state, *args, 0, min_win_rel=0)


def _merge_args(device, **bad):
    """A tumbling spec, its ring and a dense lean packed stripe on
    ``device``; ``bad`` replaces the packed matrix or the ring's sum."""
    spec = sa.WindowKernelSpec(
        components=tuple(sa.components_for([("min", 0), ("avg", 0)])),
        num_value_cols=1, window_slots=16, group_capacity=128,
        length_ms=1000, slide_ms=1000,
    )
    state = sa.init_state(spec, device)
    packed = bad.get("packed", torch.zeros((4, 1026), dtype=torch.int32))
    if "sum" in bad:
        state["sum_0"] = bad["sum"]
    return spec, state, packed.to(device)


def test_merge_wrapper_never_takes_the_plain_version_off_cpu(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(sa, "merge_partials_reference", refuse)
    spec, state, packed = _merge_args("meta")
    before = mp.merge_partials_launches
    with pytest.raises(ValueError, match="no merge kernel"):
        mp.merge_partials(spec, 1, 1024, True, True, state, packed)
    assert mp.merge_partials_launches == before


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(packed=torch.zeros((4, 1026), dtype=torch.int64)), "int32"),
        (dict(packed=torch.zeros((4, 1025), dtype=torch.int32)), "a_pad"),
        (dict(packed=torch.zeros((5, 1026), dtype=torch.int32)), "rows"),
        (dict(sum=torch.zeros((16, 64))), "sum_0"),
    ],
)
def test_merge_wrapper_checks_inputs(bad, match):
    spec, state, packed = _merge_args("cpu", **bad)
    with pytest.raises((TypeError, ValueError), match=match):
        mp.merge_partials(spec, 1, 1024, True, True, state, packed)


def test_compact_wrapper_never_takes_the_plain_version_off_cpu(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(cs, "compact_slot_reference", refuse)
    counts = torch.zeros(128, dtype=torch.int32, device="meta")
    before = cs.compact_slot_launches
    with pytest.raises(ValueError, match="no compact_slot kernel"):
        cs.compact_slot(counts, [torch.zeros(128, device="meta")])
    assert cs.compact_slot_launches == before


@pytest.mark.parametrize(
    "counts, planes, match",
    [
        (torch.zeros(128, dtype=torch.int64), [], "int32"),
        (torch.zeros((2, 64), dtype=torch.int32), [], "1-D"),
        (torch.zeros(128, dtype=torch.int32), [torch.zeros(64)], "contiguous"),
        (torch.zeros(128, dtype=torch.int32),
         [torch.zeros(128, dtype=torch.int16)], "4 or 8"),
        (torch.zeros(128, dtype=torch.int32), [torch.zeros(128)] * 65,
         "exceed"),
    ],
)
def test_compact_wrapper_checks_inputs(counts, planes, match):
    with pytest.raises((TypeError, ValueError), match=match):
        cs.compact_slot(counts, planes)


def test_failed_native_build_falls_back_logged(monkeypatch, tmp_path, caplog):
    """No g++: the stripe folds on the numpy lane and the interner on the
    dict lane, each with a warning, and the stripe counts the batch."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_build, "_CACHE", {})

    def no_compiler(cmd, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native_build.subprocess, "run", no_compiler)
    hp._native.cache_clear()
    ti.native_interner.cache_clear()
    try:
        with pytest.raises(native_build.NativeBuildError, match="g\\+\\+"):
            native_build.load("partial_agg")
        caplog.set_level("WARNING")
        spec = sa.WindowKernelSpec(
            components=tuple(sa.components_for([("sum", 0)])),
            num_value_cols=1, window_slots=16, group_capacity=128,
            length_ms=1000, slide_ms=1000,
        )
        st = hp.HostPartialStripe(spec, 128)
        st.add_batch(np.zeros(4, np.int64), np.zeros(4, np.int32),
                     np.arange(4, dtype=np.int32), np.ones((4, 1)), None, None)
        assert (st.native_batches, st.numpy_batches) == (0, 1)
        col = ti.ColumnInterner()
        col.intern_array(np.array(["a", "b"], dtype=object))
        assert col.lane == "dict"
        text = caplog.text
        assert "numpy path" in text and "dict-based interning" in text
    finally:
        hp._native.cache_clear()
        ti.native_interner.cache_clear()
