"""Python binding for the native LSM KV store (ctypes; ``native/lsmkv.cpp``
builds with g++ into ``_build/`` at first use).

Counterpart of ``denormalized_tpu/state/lsm.py``: string-keyed
put/get/delete/close with a process-global instance
(``initialize_global_state_backend``), the
same segment format on disk — so each package opens the other's store —
and the same pure-Python engine when no compiler is available (logged, and
counted in :data:`python_engine_stores`) or ``DENORMALIZED_LSM_PY`` is set.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import time
import zlib
from pathlib import Path

from denormalized_tpu_torch import obs
from denormalized_tpu_torch.common.errors import StateError
from denormalized_tpu_torch.runtime import faults
from denormalized_tpu_torch.runtime.tracing import logger

_BUILD_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False
#: stores opened on the pure-Python engine (no native library)
python_engine_stores = 0


def _load_native():
    global _LIB, _LIB_FAILED
    if os.environ.get("DENORMALIZED_LSM_PY"):
        # force the pure-Python engine (chaos soak / tests: its replay
        # accounting and torn-tail handling must be exercisable on boxes
        # where the native build exists)
        return None
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _BUILD_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        from denormalized_tpu_torch.native import build

        try:
            lib = build.load("lsmkv")
            lib.lsm_open.restype = ctypes.c_void_p
            lib.lsm_open.argtypes = [ctypes.c_char_p]
            lib.lsm_put.restype = ctypes.c_int
            lib.lsm_put.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_uint32,
                ctypes.c_char_p,
                ctypes.c_uint32,
            ]
            lib.lsm_delete.restype = ctypes.c_int
            lib.lsm_delete.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_uint32,
            ]
            lib.lsm_get.restype = ctypes.c_int64
            lib.lsm_get.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_uint32,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ]
            lib.lsm_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            lib.lsm_flush.restype = ctypes.c_int
            lib.lsm_flush.argtypes = [ctypes.c_void_p]
            lib.lsm_count.restype = ctypes.c_uint64
            lib.lsm_count.argtypes = [ctypes.c_void_p]
            lib.lsm_keys.restype = ctypes.c_int64
            lib.lsm_keys.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ]
            lib.lsm_compact.restype = ctypes.c_int
            lib.lsm_compact.argtypes = [ctypes.c_void_p]
            lib.lsm_close.argtypes = [ctypes.c_void_p]
            _LIB = lib
        except (build.NativeBuildError, OSError) as e:
            # the pure-Python engine speaks the same format; the fallback
            # is logged, and counted per store in python_engine_stores
            logger.warning(
                "native LSM build/load failed — falling back to the "
                "pure-Python engine (slower, same format): %s",
                str(e)[-600:],
            )
            _LIB_FAILED = True
    return _LIB


class LsmStore:
    """String/bytes-keyed durable KV store."""

    def __init__(self, path: str):
        self.path = str(path)
        # op-latency histograms (falsy no-ops when metrics are disabled,
        # so the timing brackets cost nothing then)
        self._obs_put_ms = obs.histogram("dnz_lsm_op_ms", op="put")
        self._obs_get_ms = obs.histogram("dnz_lsm_op_ms", op="get")
        self._obs_flush_ms = obs.histogram("dnz_lsm_op_ms", op="flush")
        # state observatory: the backend's footprint joins the dnz_state_*
        # families under node="state_backend"; weakref'd, so the registry
        # never pins a closed store
        import weakref

        ref = weakref.ref(self)

        def _disk_bytes():
            st = ref()
            if st is None or st._closed:
                return 0
            total = 0
            try:
                for p in Path(st.path).iterdir():
                    if p.is_file():
                        total += p.stat().st_size
            except OSError:
                return 0
            return total

        def _live_keys():
            st = ref()
            if st is None or st._closed:
                return 0
            return len(st)

        obs.gauge_fn("dnz_state_bytes", _disk_bytes, node="state_backend")
        obs.gauge_fn(
            "dnz_state_live_keys", _live_keys, node="state_backend"
        )
        lib = _load_native()
        if lib is not None:
            self._lib = lib
            self._h = lib.lsm_open(self.path.encode())
            if not self._h:
                raise StateError(f"cannot open state backend at {path!r}")
            self._py = None
        else:
            global python_engine_stores
            python_engine_stores += 1
            self._lib = None
            self._py = _PyLsm(self.path)
        self._closed = False

    def _check_open(self) -> None:
        """Every op checks this FIRST: a put/get/delete/flush on a closed
        native store would hand ctypes a freed handle — a potential
        segfault, not a Python error — so the guard must precede any
        native call."""
        if self._closed:
            raise StateError("state backend closed")

    # -- API (mirrors SlateDBWrapper::{put,get,close}) -------------------
    def put(self, key: str | bytes, value: bytes) -> None:
        self._check_open()
        k = key.encode() if isinstance(key, str) else key
        if faults.armed():  # unarmed path builds no key string
            value = faults.inject(
                "lsm.put", key=k.decode("utf-8", "replace"), payload=value
            )
        t0 = time.perf_counter()
        if self._lib:
            if self._lib.lsm_put(self._h, k, len(k), value, len(value)) != 0:
                raise StateError("put failed")
        else:
            self._py.put(k, value)
        self._obs_put_ms.observe((time.perf_counter() - t0) * 1e3)

    def get(self, key: str | bytes) -> bytes | None:
        self._check_open()
        k = key.encode() if isinstance(key, str) else key
        if faults.armed():  # unarmed path builds no key string
            faults.inject("lsm.get", key=k.decode("utf-8", "replace"))
        t0 = time.perf_counter()
        try:
            if self._lib:
                out = ctypes.POINTER(ctypes.c_uint8)()
                n = self._lib.lsm_get(self._h, k, len(k), ctypes.byref(out))
                if n < 0:
                    return None
                try:
                    return ctypes.string_at(out, n)
                finally:
                    self._lib.lsm_free(out)
            return self._py.get(k)
        finally:
            self._obs_get_ms.observe((time.perf_counter() - t0) * 1e3)

    def delete(self, key: str | bytes) -> None:
        self._check_open()
        k = key.encode() if isinstance(key, str) else key
        if self._lib:
            self._lib.lsm_delete(self._h, k, len(k))
        else:
            self._py.delete(k)

    def keys(self) -> list[bytes]:
        self._check_open()
        if self._lib:
            out = ctypes.POINTER(ctypes.c_uint8)()
            n = self._lib.lsm_keys(self._h, ctypes.byref(out))
            try:
                raw = ctypes.string_at(out, n) if n > 0 else b""
            finally:
                self._lib.lsm_free(out)
            return [k for k in raw.split(b"\n") if k]
        return self._py.keys()

    def __len__(self) -> int:
        self._check_open()
        if self._lib:
            return int(self._lib.lsm_count(self._h))
        return len(self._py.index)

    def flush(self) -> None:
        self._check_open()
        faults.inject("lsm.flush")
        t0 = time.perf_counter()
        if self._lib:
            self._lib.lsm_flush(self._h)
        else:
            self._py.flush()
        self._obs_flush_ms.observe((time.perf_counter() - t0) * 1e3)

    def compact(self) -> None:
        self._check_open()
        if self._lib:
            if self._lib.lsm_compact(self._h) != 0:
                raise StateError("compact failed")
        else:
            self._py.compact()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._lib:
            self._lib.lsm_close(self._h)
        else:
            self._py.close()

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    @property
    def replay_truncated(self) -> int:
        """How many torn segment tails startup replay dropped (0 on the
        native engine, whose replay truncation happens inside lsmkv.cpp
        and is not counted here).  A nonzero value after recovery is the
        signal that a crash landed mid-append — expected after SIGKILL,
        alarming after a clean shutdown."""
        return self._py.replay_truncated if self._py is not None else 0


class _PyLsm:
    """Pure-Python fallback speaking the exact same segment format."""

    _HDR = struct.Struct("<III B")

    def __init__(self, path: str):
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.index: dict[bytes, tuple[int, int, int]] = {}
        #: torn segment tails dropped by startup replay — recovery after a
        #: crash mid-append is EXPECTED to bump this; a silent count was
        #: the old behavior and hid real tears from every operator
        self.replay_truncated = 0
        self._obs_replay_trunc = obs.counter(
            "dnz_lsm_replay_truncated_total"
        )
        segs = sorted(
            int(p.name[4:12]) for p in self.dir.glob("seg-*.log")
        )
        for seg in segs:
            self._replay(seg)
        self.active_seg = (segs[-1] + 1) if segs else 0
        self.active = open(self._seg(self.active_seg), "ab")
        self.active_size = 0

    def _seg(self, n: int) -> Path:
        return self.dir / f"seg-{n:08d}.log"

    def _replay(self, seg: int):
        off = 0
        with open(self._seg(seg), "rb") as f:
            data = f.read()
        torn_at = None
        while off + 13 <= len(data):
            crc, klen, vlen, tomb = self._HDR.unpack_from(data, off)
            end = off + 13 + klen + vlen
            if end > len(data) or zlib.crc32(data[off + 4 : end]) != crc:
                # torn tail: every byte from here on is untrusted (records
                # are not self-synchronizing, so resyncing past a bad CRC
                # could resurrect stale garbage as live records) — keep
                # the truncation semantics, but LOUDLY
                torn_at = off
                break
            key = data[off + 13 : off + 13 + klen]
            if tomb:
                self.index.pop(key, None)
            else:
                self.index[key] = (seg, off + 13 + klen, vlen)
            off = end
        if torn_at is None and off < len(data):
            torn_at = off  # trailing partial header (< 13 bytes)
        if torn_at is not None:
            self.replay_truncated += 1
            self._obs_replay_trunc.add(1)
            logger.warning(
                "lsm %s: segment %d torn at offset %d — dropping %d "
                "trailing byte(s) (crash mid-append; later records, if "
                "any, are unrecoverable)",
                self.dir, seg, torn_at, len(data) - torn_at,
            )

    def _append(self, key: bytes, value: bytes, tomb: int):
        body = self._HDR.pack(0, len(key), len(value), tomb)[4:] + key + value
        rec = struct.pack("<I", zlib.crc32(body)) + body
        self.active.write(rec)
        if tomb:
            self.index.pop(key, None)
        else:
            self.index[key] = (
                self.active_seg,
                self.active_size + 13 + len(key),
                len(value),
            )
        self.active_size += len(rec)

    def put(self, key: bytes, value: bytes):
        self._append(key, value, 0)

    def delete(self, key: bytes):
        self._append(key, b"", 1)

    def get(self, key: bytes) -> bytes | None:
        e = self.index.get(key)
        if e is None:
            return None
        seg, off, vlen = e
        if seg == self.active_seg:
            self.active.flush()
        with open(self._seg(seg), "rb") as f:
            f.seek(off)
            return f.read(vlen)

    def keys(self) -> list[bytes]:
        return sorted(self.index)

    def flush(self):
        self.active.flush()
        os.fsync(self.active.fileno())

    def compact(self):
        new_seg = self.active_seg + 1
        self.active.flush()
        new_index = {}
        size = 0
        with open(self._seg(new_seg), "ab") as nf:
            for key in sorted(self.index):
                val = self.get(key)
                body = (
                    self._HDR.pack(0, len(key), len(val), 0)[4:] + key + val
                )
                rec = struct.pack("<I", zlib.crc32(body)) + body
                nf.write(rec)
                new_index[key] = (new_seg, size + 13 + len(key), len(val))
                size += len(rec)
            nf.flush()
            os.fsync(nf.fileno())
        old = self.active_seg
        self.active.close()
        self.active = open(self._seg(new_seg), "ab")
        self.active_seg = new_seg
        self.active_size = size
        self.index = new_index
        for p in self.dir.glob("seg-*.log"):
            if int(p.name[4:12]) <= old:
                p.unlink()

    def close(self):
        self.flush()
        self.active.close()


# -- process-global instance (mirror of slatedb.rs:9-26) -----------------

_GLOBAL: LsmStore | None = None
_GLOBAL_LOCK = threading.Lock()


def initialize_global_state_backend(path: str) -> LsmStore:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None or _GLOBAL.path != str(path) or _GLOBAL._closed:
            if _GLOBAL is not None and not _GLOBAL._closed:
                # flush + release the previous store before replacing it —
                # silently dropping it would leak the fd and lose its
                # buffered tail records
                _GLOBAL.close()
            _GLOBAL = LsmStore(path)
        return _GLOBAL


def get_global_state_backend() -> LsmStore:
    if _GLOBAL is None:
        raise StateError("state backend not initialized")
    return _GLOBAL


def close_global_state_backend() -> None:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
            _GLOBAL = None
