"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, loaded through ``ctypes`` — no PyTorch headers, so a
build takes seconds.  Libraries land in ``denormalized_tpu_torch/_build/``
under a name keyed by the hash of the source, its local includes and the
flags, so an edited source or header rebuilds and an unchanged one loads at
once.  The build runs on first use, from the sources in the checkout only;
:func:`build_all` compiles every source at once with one ``nvcc`` process
per file.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path

from denormalized_tpu_torch.native.build import source_hash

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# held around every build: _start's temp file is named by process id only
_BUILD_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin) — the CUDA kernels need the CUDA toolkit"
    )


def _target(name: str) -> Path:
    """The library's path, keyed by the source, its local includes (so an
    edit to a shared ``csrc/*.cuh`` rebuilds every library using it) and
    the flags."""
    h = source_hash(SRC_DIR / f"{name}.cu", NVCC_FLAGS)
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library is current;
    returns (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, (proc, tmp)


def _finish(name: str, out: Path, pending) -> str:
    """Wait for one nvcc; move its library into place and return its
    output (ptxas register/shared-memory report).  Raises on failure."""
    if pending is None:
        log = out.with_suffix(".log")
        return log.read_text() if log.exists() else ""
    proc, tmp = pending
    text, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{text}"
        )
    out.with_suffix(".log").write_text(text)
    os.replace(tmp, out)  # atomic: a concurrent builder sees old or new
    return text


def sources() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` in parallel (one nvcc each, all started
    together) → {name: nvcc output}."""
    with _BUILD_LOCK:
        # dnzlint: allow(blocking-under-lock) the nvcc runs are why the lock exists: a second thread must wait for the libraries, not race nvcc on the same .so; one build a process, never on a launch
        started = {n: _start(n) for n in sources()}
        return {n: _finish(n, *started[n]) for n in started}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it.  A second thread that
    misses the cache while the first builds waits on the lock, then finds
    the library current and only loads it."""
    with _BUILD_LOCK:
        # dnzlint: allow(blocking-under-lock) build once a process: a thread that misses the cache while another builds waits here, then finds the library current; never on a launch
        out, pending = _start(name)
        _finish(name, out, pending)
        # dnzlint: allow(blocking-under-lock) the library loads under the same lock as its build, so no thread loads a half-written .so
        return ctypes.CDLL(str(out))
