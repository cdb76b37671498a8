"""Host-side group-key interning: values → dense int32 group ids.

Counterpart of ``denormalized_tpu/ops/interner.py`` on its numpy/dict path
only (the native ``interner.cpp`` lane is not ported yet).  Group keys are
interned to dense indices so accumulators can be flat vectors; the dense id
doubles as the column index into the device-resident ``(windows, groups)``
ring, so interning is the bridge between host strings and device tensors.

Ids and value identity follow the JAX package exactly — first-seen order,
``None`` its own key, non-string objects normalized via ``str()``, trailing
NULs stripped, all NaNs one key — so a JAX interner's ``all_values()``
carried in through :meth:`ColumnInterner.load_values` continues with the
same ids.
"""

from __future__ import annotations

import numpy as np

# canonical dict key for float NaN (nan != nan, so NaN itself can never be
# found again in a dict); all NaNs intern to one id
_NAN_KEY = ("__nan__",)


class ColumnInterner:
    """value -> id for one column."""

    def __init__(self) -> None:
        self._to_id: dict = {}
        self._values: list = []
        # True once a numeric key was stored: the object lane's one-pass
        # lookup below is only exact while every stored key is str/None
        self._numeric_keys = False

    def __len__(self) -> int:
        return len(self._values)

    def intern_array(self, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
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
        values = self._values
        out = np.empty(len(ids), dtype=object)
        for i, j in enumerate(np.asarray(ids).tolist()):
            out[i] = values[j]
        return out

    def load_values(self, vals: list) -> None:
        """Re-seed with an ordered value list (ids must match positions) —
        the way a JAX-package interner's state carries into the port."""
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
