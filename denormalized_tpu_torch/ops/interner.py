"""Host-side group-key interning: values → dense int32 group ids.

Counterpart of ``denormalized_tpu/ops/interner.py``.  Group keys are
interned to dense indices so accumulators can be flat vectors; the dense id
doubles as the column index into the device-resident ``(windows, groups)``
ring, so interning is the bridge between host strings and device tensors.

A string (object) column takes the native lane of ``native/interner.cpp``:
an open-addressing table that persists across batches, fed either straight
from the Python objects (``intern_pyobjects``, built with
``-DINTERN_HAVE_PYTHON`` where the Python headers exist) or, without the
headers, from a UTF-8 byte buffer with offsets (``intern_offsets``).
Numeric columns, and every column when the native build fails (logged),
take the dict lane.  A column keeps the lane of its first batch.

Ids and value identity are the same on every lane and in both packages —
first-seen order, ``None`` its own key, non-string objects normalized via
``str()``, trailing NULs stripped, all NaNs one key — so a JAX interner's
``all_values()`` carried in through :meth:`ColumnInterner.load_values`
continues with the same ids.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import sysconfig

import numpy as np

_log = logging.getLogger(__name__)

# canonical dict key for float NaN (nan != nan, so NaN itself can never be
# found again in a dict); all NaNs intern to one id
_NAN_KEY = ("__nan__",)

# the native table's key for None (0xFF never occurs in valid UTF-8)
_NULL_KEY = b"\xff"


class _NativeInterner:
    """The loaded native interner: the library and its lane."""

    def __init__(self, lib: ctypes.CDLL, pylib: ctypes.PyDLL | None):
        self.lib = lib
        # PyObject lane (keeps the GIL: called through PyDLL), or None for
        # the byte-key lane
        self.intern_pyobjects = pylib.intern_pyobjects if pylib else None
        self.py_release = pylib.intern_py_release if pylib else None
        self.lane = "native-pyobject" if pylib else "native-bytes"


def _declare(lib: ctypes.CDLL) -> None:
    p, u64, i32p = ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32)
    lib.intern_create.restype = p
    lib.intern_create.argtypes = []
    lib.intern_destroy.restype = None
    lib.intern_destroy.argtypes = [p]
    lib.intern_count.restype = u64
    lib.intern_count.argtypes = [p]
    lib.intern_offsets.restype = None
    lib.intern_offsets.argtypes = [p, p, p, p, u64, i32p]
    lib.intern_keys_range.restype = ctypes.c_int64
    lib.intern_keys_range.argtypes = [
        p, u64, u64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
    ]
    lib.intern_free.restype = None
    lib.intern_free.argtypes = [p]


@functools.cache
def native_interner() -> _NativeInterner | None:
    """Build and load ``native/interner.cpp``: with the PyObject lane where
    the Python headers exist, else the byte-key lane; None (logged) when
    neither builds."""
    from denormalized_tpu_torch.native.build import NativeBuildError, load

    inc = sysconfig.get_paths()["include"]
    if os.path.exists(os.path.join(inc, "Python.h")):
        flags = (f"-I{inc}", "-DINTERN_HAVE_PYTHON")
        try:
            lib = load("interner", flags)
            pylib = load("interner", flags, pydll=True)
        except (NativeBuildError, OSError) as e:
            _log.warning(
                "native interner with the PyObject lane failed to build "
                "(%s: %s) — trying the byte-key lane", type(e).__name__, e,
            )
        else:
            _declare(lib)
            pylib.intern_pyobjects.restype = ctypes.c_int
            pylib.intern_pyobjects.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            pylib.intern_py_release.restype = None
            pylib.intern_py_release.argtypes = [ctypes.c_void_p]
            return _NativeInterner(lib, pylib)
    try:
        lib = load("interner")
    except (NativeBuildError, OSError) as e:
        _log.warning(
            "native interner unavailable (%s: %s) — dict-based interning "
            "takes over (slower at high key cardinality)",
            type(e).__name__, e,
        )
        return None
    _declare(lib)
    return _NativeInterner(lib, None)


def _utf8_offsets(vals: list):
    """Byte-key lane input: the keys' UTF-8 bytes (``str()`` of non-string
    keys, undecodable code points replaced, as the PyObject lane does),
    their u64 offsets, and a validity mask (False = None)."""
    pieces = [
        b"" if v is None
        else (v if isinstance(v, str) else str(v)).encode("utf-8", "replace")
        for v in vals
    ]
    n = len(pieces)
    offsets = np.zeros(n + 1, np.uint64)
    np.cumsum(np.fromiter(map(len, pieces), np.uint64, n), out=offsets[1:])
    valid = np.fromiter((v is not None for v in vals), np.uint8, n)
    data = np.frombuffer(b"".join(pieces) or b"\0", np.uint8)
    return data, offsets, valid


class ColumnInterner:
    """value -> id for one column."""

    def __init__(self) -> None:
        self._to_id: dict = {}
        self._values: list = []
        # True once a numeric key was stored: the object lane's one-pass
        # lookup below is only exact while every stored key is str/None
        self._numeric_keys = False
        self._native = native_interner()
        self._h = self._native.lib.intern_create() if self._native else None
        # True once this column's keys live in the native table (its first
        # string batch); _values then mirrors the table lazily
        self._native_active = False
        self._values_arr: np.ndarray | None = None  # object-array mirror
        #: calls into the native table
        self.native_calls = 0

    def __del__(self):
        if getattr(self, "_h", None):
            if self._native.py_release is not None:
                self._native.py_release(self._h)  # drop the pointer pins
            self._native.lib.intern_destroy(self._h)
            self._h = None

    @property
    def lane(self) -> str:
        """The lane holding this column's keys."""
        return self._native.lane if self._native_active else "dict"

    def __len__(self) -> int:
        if self._native_active:
            return int(self._native.lib.intern_count(self._h))
        return len(self._values)

    def _sync_native_values(self) -> None:
        """Extend the Python value mirror with newly interned keys: one
        bulk call fetching every new key's bytes."""
        lib = self._native.lib
        n_now = int(lib.intern_count(self._h))
        values = self._values
        start = len(values)
        if n_now <= start:
            return
        bptr = ctypes.POINTER(ctypes.c_uint8)()
        optr = ctypes.POINTER(ctypes.c_uint64)()
        n = lib.intern_keys_range(
            self._h, start, n_now, ctypes.byref(bptr), ctypes.byref(optr)
        )
        try:
            offs = np.ctypeslib.as_array(optr, shape=(n + 1,))
            raw = ctypes.string_at(bptr, int(offs[-1])) if offs[-1] else b""
            for i in range(n):
                piece = raw[offs[i]: offs[i + 1]]
                values.append(
                    None if piece == _NULL_KEY
                    else piece.decode("utf-8", errors="replace")
                )
        finally:
            lib.intern_free(bptr)
            lib.intern_free(optr)

    def _intern_native(self, arr: np.ndarray) -> np.ndarray:
        n = len(arr)
        ids = np.empty(n, dtype=np.int32)
        out = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        nat = self._native
        if nat.intern_pyobjects is not None:
            obj = np.ascontiguousarray(
                arr if arr.dtype == object else arr.astype(object)
            )
            if nat.intern_pyobjects(self._h, obj.ctypes.data, n, out) != 0:
                raise RuntimeError("native interning failed")
        else:
            data, offsets, valid = _utf8_offsets(arr.tolist())
            nat.lib.intern_offsets(
                self._h, data.ctypes.data, offsets.ctypes.data,
                valid.ctypes.data, n, out,
            )
        self._native_active = True
        self.native_calls += 1
        return ids

    def intern_array(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        if self._native_active or (
            self._h is not None
            and not self._values
            and arr.dtype.kind not in "ifbM"
        ):
            return self._intern_native(arr)
        if arr.dtype.kind in "ifbM":
            # numeric key column: unique per batch, dict on uniques only
            uniq, inv = np.unique(arr, return_inverse=True)
            self._numeric_keys = True
            ids = np.empty(len(uniq), dtype=np.int32)
            to_id, values = self._to_id, self._values
            for i, v in enumerate(uniq.tolist()):
                key = _NAN_KEY if isinstance(v, float) and v != v else v
                j = to_id.get(key)
                if j is None:
                    j = len(values)
                    to_id[key] = j
                    values.append(v)
                ids[i] = j
            return ids[inv.reshape(-1)]
        vals = arr.tolist()
        if not self._numeric_keys:
            try:
                # steady state: every key already known — one C-level
                # pass.  Keys are stored normalized (str or None), so a raw
                # value that would normalize differently misses here and
                # takes the loop below
                return np.fromiter(
                    map(self._to_id.__getitem__, vals), dtype=np.int32,
                    count=len(vals),
                )
            except (KeyError, TypeError):
                pass
        ids = np.empty(len(vals), dtype=np.int32)
        to_id, values = self._to_id, self._values
        for i, v in enumerate(vals):
            if v is None:
                pass
            elif isinstance(v, str):
                v = v.rstrip("\x00")
            else:
                v = str(v)
            j = to_id.get(v)
            if j is None:
                j = len(values)
                to_id[v] = j
                values.append(v)
            ids[i] = j
        return ids

    def value_of(self, ids: np.ndarray) -> np.ndarray:
        if self._native_active:
            self._sync_native_values()
            if self._values_arr is None or len(self._values_arr) != len(
                self._values
            ):
                self._values_arr = np.empty(len(self._values), dtype=object)
                self._values_arr[:] = self._values
            return self._values_arr[np.asarray(ids)]
        values = self._values
        out = np.empty(len(ids), dtype=object)
        for i, j in enumerate(np.asarray(ids).tolist()):
            out[i] = values[j]
        return out

    def all_values(self) -> list:
        """Every key in id order (what :meth:`load_values` re-seeds from)."""
        if self._native_active:
            self._sync_native_values()
        return list(self._values)

    def load_values(self, vals: list) -> None:
        """Re-seed with an ordered value list (ids must match positions) —
        the way a JAX-package interner's state carries into the port.  A
        string column re-seeds the native table, any other the dict."""
        if (
            self._h is not None
            and not self._native_active
            and not self._values
            and vals
            and all(isinstance(v, str) or v is None for v in vals)
        ):
            ids = self.intern_array(np.array(vals, dtype=object))
            if ids.tolist() != list(range(len(vals))):
                raise ValueError(
                    "carried-in key values are not distinct after "
                    "normalization; their ids cannot be kept"
                )
            return
        if self._native_active:
            raise ValueError("the native table cannot be re-seeded")
        self._values = list(vals)
        self._numeric_keys = not all(
            isinstance(v, str) or v is None for v in self._values
        )
        self._to_id = {
            (_NAN_KEY if isinstance(v, float) and v != v else v): i
            for i, v in enumerate(self._values)
        }


def format_key_tuple(vals) -> str:
    """Canonical display string for one composite key."""
    return (
        str(vals[0]) if len(vals) == 1
        else "(" + ", ".join(str(v) for v in vals) + ")"
    )


def display_keys(interner, gids) -> list:
    """Best-effort display strings for dense gids, None for out-of-range
    ids."""
    gl = np.asarray(gids, dtype=np.int64)
    out: list = [None] * len(gl)
    rows = interner._gid_rows
    ok = [i for i, g in enumerate(gl.tolist()) if 0 <= g < len(rows)]
    if not ok:
        return out
    cols = interner.keys_of(gl[ok])
    for j, i in enumerate(ok):
        out[i] = format_key_tuple([c[j] for c in cols])
    return out


def _dedup_rows(per_col: list[np.ndarray]) -> tuple[list[tuple], np.ndarray]:
    """Composite-key dedup: per-column id arrays → (unique row tuples,
    inverse indices).  2 columns pack into one int64 for a 1-D unique."""
    if len(per_col) == 2:
        packed = (per_col[0].astype(np.int64) << 32) | per_col[1].astype(
            np.int64
        )
        uniq, inv = np.unique(packed, return_inverse=True)
        rows = [(int(p >> 32), int(p & 0xFFFFFFFF)) for p in uniq.tolist()]
    else:
        stacked = np.stack(per_col, axis=1)
        uniq_rows, inv = np.unique(stacked, axis=0, return_inverse=True)
        rows = list(map(tuple, uniq_rows.tolist()))
    return rows, inv.reshape(-1)


class GroupInterner:
    """Composite (multi-column) key -> dense group id.

    Per-column ids are packed row-wise and the row-tuples interned, so the
    reverse map can reconstruct every key column for emission.
    """

    def __init__(self, num_columns: int) -> None:
        self.num_columns = num_columns
        self._col_interners = [ColumnInterner() for _ in range(num_columns)]
        self._tuple_to_gid: dict = {}
        # per group id, the tuple of per-column value ids
        self._gid_rows: list[tuple] = []

    def __len__(self) -> int:
        return len(self._gid_rows)

    @property
    def lanes(self) -> list[str]:
        """The interning lane of each key column."""
        return [it.lane for it in self._col_interners]

    @property
    def native_calls(self) -> int:
        """Calls into the native tables, over all key columns."""
        return sum(it.native_calls for it in self._col_interners)

    def intern(self, key_columns: list[np.ndarray]) -> np.ndarray:
        if len(key_columns) != self.num_columns:
            raise ValueError(
                f"{len(key_columns)} key columns for a "
                f"{self.num_columns}-column interner"
            )
        per_col = [
            it.intern_array(c) for it, c in zip(self._col_interners, key_columns)
        ]
        if self.num_columns == 1:
            # single column: the column interner assigns dense ids in
            # first-seen order, which is exactly the group-id order
            cids = per_col[0]
            n_known = len(self._gid_rows)
            n_now = len(self._col_interners[0])
            if n_now > n_known:
                self._gid_rows.extend(zip(range(n_known, n_now)))
            return cids
        rows, inv = _dedup_rows(per_col)
        gids_for_uniq = np.empty(len(rows), dtype=np.int32)
        for i, row in enumerate(rows):
            g = self._tuple_to_gid.get(row)
            if g is None:
                g = len(self._gid_rows)
                self._tuple_to_gid[row] = g
                self._gid_rows.append(row)
            gids_for_uniq[i] = g
        return gids_for_uniq[inv]

    def keys_of(self, gids: np.ndarray) -> list[np.ndarray]:
        """Reconstruct each key column's values for the given group ids."""
        if self.num_columns == 1:
            return [self._col_interners[0].value_of(gids)]
        rows = np.array([self._gid_rows[g] for g in gids.tolist()], dtype=np.int64)
        if len(gids) == 0:
            rows = rows.reshape(0, self.num_columns)
        return [
            it.value_of(rows[:, c])
            for c, it in enumerate(self._col_interners)
        ]

    @classmethod
    def restore(cls, snap: dict) -> "GroupInterner":
        """Rebuild from a group interner snapshot
        ``{"columns": [values per column], "rows": [per-gid value ids]}`` —
        the layout the JAX package's ``GroupInterner.snapshot()`` writes."""
        g = cls(len(snap["columns"]))
        for it, vals in zip(g._col_interners, snap["columns"]):
            it.load_values(list(vals))
        g._gid_rows = [tuple(r) for r in snap["rows"]]
        g._tuple_to_gid = {r: i for i, r in enumerate(g._gid_rows)}
        return g
