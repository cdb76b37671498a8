"""The PyTorch/CUDA port stands alone: it imports neither jax nor anything
of denormalized_tpu, and it never hides the device or the kernel — no CUDA
without device="cpu" raises, a non-CPU tensor never reaches the plain
version, and a failed kernel build raises."""

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
from denormalized_tpu_torch.ops import cuda_build
from denormalized_tpu_torch.ops import dense_window as dw

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "denormalized_tpu_torch"


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

    monkeypatch.setattr(dw, "dense_partials_reference", refuse)
    B, G = 256, 128
    args = (
        torch.zeros((B, 1), dtype=torch.float32, device="meta"),
        torch.ones((B, 1), dtype=torch.float32, device="meta"),
        torch.zeros((B, 1), dtype=torch.int32, device="meta"),
        torch.zeros((B,), dtype=torch.int32, device="meta"),
    )
    with pytest.raises(ValueError, match="no dense window kernel"):
        dw.dense_partials(*args, G)


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
        (dict(rel=np.zeros((255, 1), np.int32)), "rel"),
        (dict(gid=np.zeros((256, 1), np.int32)), "gid"),
    ],
)
def test_wrapper_checks_dtype_and_shape(bad, match):
    ins = dict(
        values=np.zeros((256, 1), np.float32),
        colvalid=np.ones((256, 1), np.float32),
        rel=np.zeros((256, 1), np.int32),
        gid=np.zeros(256, np.int32),
    )
    ins.update(bad)
    t = {k: torch.from_numpy(v) for k, v in ins.items()}
    with pytest.raises((TypeError, ValueError), match=match):
        dw.dense_partials(t["values"], t["colvalid"], t["rel"], t["gid"], 128)
