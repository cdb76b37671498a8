"""Stable cross-process key hashing + partition assignment.

Counterpart of ``denormalized_tpu/cluster/hashing.py``, bit for bit: a
checkpointed store is shared between the packages, so a cut re-bucketed
by either package puts every key in the same worker.

The ONE hash map of the cluster: exchange routing (which worker owns a
row's group key) and rescale-on-restore (which new worker inherits a
checkpointed group's accumulators) must agree bit-for-bit, across
processes and across engine versions — Python's builtin ``hash`` is
per-process salted and therefore banned here (dnzlint DNZ-H002 keeps it
out of the pinned kernels too).

``hash_rows`` is vectorized for numeric key columns (a splitmix64-style
finalizer over the canonical uint64 reinterpretation); object (string)
columns fall back to a per-row crc32 loop in a separate, deliberately
unpinned helper.
"""

from __future__ import annotations

import zlib

import numpy as np

# splitmix64 finalizer constants (Stafford mix13)
_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_S = np.uint64(33)
_COMBINE = np.uint64(0x9E3779B97F4A7C15)  # golden-ratio increment


def _mix64(x: np.ndarray) -> np.ndarray:
    """Stafford variant-13 finalizer, elementwise over uint64 (wrapping
    multiply is numpy's unsigned semantics — exactly what we want)."""
    x = x ^ (x >> _S)
    x = x * _M1
    x = x ^ (x >> _S)
    x = x * _M2
    x = x ^ (x >> _S)
    return x


def _object_column_u64(col: np.ndarray) -> np.ndarray:
    """Per-row canonical hash of an object (string) column — the slow
    lane, kept OUT of the pinned kernels on purpose: strings have no
    vectorized canonical form, and a crc32 loop at intern-scale rates is
    the honest cost of string group keys over the exchange."""
    out = np.empty(len(col), dtype=np.uint64)
    for i, v in enumerate(col):
        if isinstance(v, bytes):
            b = v
        else:
            b = str(v).encode("utf-8", "surrogatepass")
        out[i] = zlib.crc32(b)
    return out


def _string_column_u64(col) -> np.ndarray:
    """crc32 lane for columnar strings: hashes each row's UTF-8 bytes
    STRAIGHT off the offsets+bytes buffers — per-row crc32 like the
    object lane (and bit-identical to it for the same logical values,
    so rescale across lanes re-buckets identically: a valid UTF-8 str's
    encoded bytes ARE its column bytes, and a null hashes b'None' just
    like the object lane str()s None) — but with no Python str ever
    materialized."""
    out = np.empty(len(col), dtype=np.uint64)
    mv = memoryview(np.ascontiguousarray(col.data))
    offs = col.offsets.tolist()
    valid = col.validity.tolist() if col.validity is not None else None
    for i in range(len(col)):
        if valid is not None and not valid[i]:
            out[i] = zlib.crc32(b"None")
        else:
            out[i] = zlib.crc32(mv[offs[i]: offs[i + 1]])
    return out


def column_u64(col: np.ndarray) -> np.ndarray:
    """Canonical uint64 reinterpretation of one key column.

    ints/bools/timestamps go through int64 (sign-preserving two's
    complement view); floats through float64 bit patterns with -0.0
    normalized to +0.0 so the two equal keys hash identically; object
    columns through the crc32 lane."""
    from denormalized_tpu_torch.common.columns import Column, StringColumn

    if isinstance(col, StringColumn):
        return _string_column_u64(col)
    if isinstance(col, Column):
        # nested key columns: materialize (grouping by a whole struct is
        # a legacy corner, not a hot path)
        col = col.as_object()
    a = np.asarray(col)
    if a.dtype == object:
        return _object_column_u64(a)
    if a.dtype.kind == "f":
        f = a.astype(np.float64, copy=False)
        f = f + 0.0  # -0.0 -> +0.0; NaNs keep their payload bits
        return f.view(np.uint64)
    if a.dtype.kind == "b":
        return a.astype(np.uint64)
    return a.astype(np.int64, copy=False).view(np.uint64)


def hash_rows(key_columns: list) -> np.ndarray:
    """Row-wise stable hash over one or more key columns → uint64.

    The exchange router and the rescale re-bucketer both call this; the
    column list must be the operator's group-key columns in group-expr
    order (order matters — it is part of the hash)."""
    h = np.zeros(len(key_columns[0]), dtype=np.uint64)
    for col in key_columns:  # dnzlint: allow(hot-loop) bounded per-KEY-COLUMN sweep (group-expr arity, typically 1-3), each iteration fully vectorized over rows
        h = _mix64(h + _COMBINE + column_u64(col))
    return h


def bucket_rows(key_columns: list, n_buckets: int) -> np.ndarray:
    """``hash(key) % n_buckets`` per row, as int64 worker indices."""
    return (hash_rows(key_columns) % np.uint64(n_buckets)).astype(np.int64)


def partitions_for(worker: int, n_workers: int, n_partitions: int) -> list[int]:
    """Engine-owned static partition assignment: worker w owns global
    partitions ``{w, w+N, w+2N, ...}`` — the one rule sources, offset
    rescale, and docs all share (docs/cluster.md#partition-assignment)."""
    if not (0 <= worker < n_workers):
        raise ValueError(f"worker {worker} out of range for N={n_workers}")
    return list(range(worker, n_partitions, n_workers))
