"""Build-on-first-use for the native (C++) host code of the port.

``<name>.cpp`` beside this file compiles with ``g++`` into
``denormalized_tpu_torch/_build/lib<name>-<hash>.so`` and loads through
ctypes.  The hash covers the source, every local quoted include it pulls
in (recursively) and the flags, so an edited source or header rebuilds and
an unchanged one loads at once — the same keying as the CUDA libraries of
``ops/cuda_build.py``.  Nothing is written beside the sources.

Nothing here runs at import time; :func:`load` raises on failure and the
caller decides whether a plain-Python lane takes over.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"

#: the warning surface every native build compiles under (non-fatal: a
#: future compiler's new warning must not take the engine down)
WARN_FLAGS = ("-Wall", "-Wextra", "-Wshadow", "-Wconversion")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_CACHE: dict[tuple, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """g++ is missing or refused a source."""


def source_hash(src: Path, flags: tuple[str, ...]) -> str:
    """Hash of ``src``, the closure of its local quoted includes, and the
    build flags."""

    def closure(path: Path, seen: set) -> bytes:
        if path in seen or not path.exists():
            return b""
        seen.add(path)
        data = path.read_bytes()
        out = data
        for line in data.splitlines():
            line = line.strip().replace(b'#include"', b'#include "')
            if line.startswith(b'#include "'):
                out += closure(path.parent / line.split(b'"')[1].decode(), seen)
        return out

    return hashlib.sha256(
        closure(src, set()) + repr(list(flags)).encode()
    ).hexdigest()[:16]


def build_library(name: str, extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile ``<name>.cpp`` unless its library is current → its path."""
    src = SRC_DIR / f"{name}.cpp"
    flags = CXX_FLAGS + WARN_FLAGS + tuple(extra_flags)
    out = BUILD_DIR / f"lib{name}-{source_hash(src, flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *flags, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeBuildError(f"g++ not found: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native build of {name} failed:\n{proc.stderr[-2000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees old or new
    return out


def load(
    name: str, extra_flags: tuple[str, ...] = (), *, pydll: bool = False
) -> ctypes.CDLL:
    """Build ``<name>.cpp`` if needed and load it.  ``pydll=True`` loads
    through :class:`ctypes.PyDLL` (calls keep the GIL), which a library
    that touches the CPython API needs."""
    key = (name, tuple(extra_flags), pydll)
    with _LOCK:
        if key not in _CACHE:
            so = build_library(name, tuple(extra_flags))
            _CACHE[key] = (ctypes.PyDLL if pydll else ctypes.CDLL)(str(so))
        return _CACHE[key]
