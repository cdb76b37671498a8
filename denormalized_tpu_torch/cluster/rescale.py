"""Rescale-on-restore: re-bucket a cluster checkpoint across a changed
worker count.

Counterpart of ``denormalized_tpu/cluster/rescale.py``, over the port's
``state/serialization.py``: a window ring exported from the card is
re-bucketed on the host, and each new worker's restore imports its ring
back onto the engine's device.

Given the cluster-committed epoch E and the old layout (N_old workers,
one LSM store each), this module streams every worker's state blobs and
rewrites them for N_new workers under the SAME epoch:

- **source offsets** remap exactly: reader ``i`` of old worker ``w`` is
  global partition ``w + i*N_old`` (cluster/hashing.partitions_for), so
  the per-partition cursors regroup losslessly under the new
  assignment;
- **windowed-aggregation state** re-buckets per GROUP: each group's
  accumulator planes move whole (hash partitioning means a key's
  accumulators live on exactly one worker, before and after), keyed by
  ``hash_rows(group key) % N_new`` — the same function the exchange
  router applies to live rows, evaluated over the checkpointed
  interner's key tuples coerced back to their original column dtypes;
- **spilled window planes** (the cold tier's blocks referenced by the epoch)
  merge back into the resident ring first — ``first_open`` lowers to
  cover them, exactly like the budget-removed restore path — and the
  restored worker's tier re-evicts under its own budget, rebuilding the
  tier map under the new hash map.

Bit-exactness: accumulators are never re-aggregated, only permuted, so
a rescaled restore emits byte-identical windows to an uninterrupted
run (pinned by tests/test_torch_cluster_rescale.py).  Variance aggregates
carry a per-operator shift pivot that is NOT mergeable across workers
when pivots diverge — that case fails loudly rather than emit subtly
wrong variances.

Non-window keyed state (session/UDAF/join) restores at the same worker
count only; rescaling it is future work (docs/cluster.md#limitations).
"""

from __future__ import annotations

import os

import numpy as np

from denormalized_tpu_torch.common.errors import StateError
from denormalized_tpu_torch.cluster.hashing import bucket_rows, partitions_for


def _identity(label: str) -> float:
    """A ring plane's empty value by its component label (``min_0``,
    ``max_0``, ``count_star``, ``sum_0``...): what ``init_state`` fills."""
    kind = label.split("_", 1)[0]
    return {"min": np.inf, "max": -np.inf}.get(kind, 0)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _interner_key_tuples(snap: dict) -> list[tuple]:
    """GroupInterner snapshot → per-gid key-value tuples."""
    columns = snap["columns"]
    rows = snap["rows"]
    return [
        tuple(columns[c][vid] for c, vid in enumerate(row))
        for row in rows
    ]


def _typed_key_columns(
    key_tuples: list[tuple], key_dtypes: list[str]
) -> list[np.ndarray]:
    """Key tuples → columns coerced back to the dtypes the exchange
    router hashed, so ``hash_rows`` agrees bit-for-bit with routing."""
    cols = []
    for c, dt in enumerate(key_dtypes):
        vals = [k[c] for k in key_tuples]
        if dt == "obj":
            a = np.empty(len(vals), dtype=object)
            a[:] = vals
        else:
            a = np.array(vals, dtype=np.dtype(dt))
        cols.append(a)
    return cols


def _interner_snapshot_from_tuples(key_tuples: list[tuple]) -> dict:
    """Fresh GroupInterner snapshot with gids in list order (first-seen
    per-column value interning, matching GroupInterner semantics)."""
    if not key_tuples:
        return {"columns": [], "rows": []}
    n_cols = len(key_tuples[0])
    col_values: list[list] = [[] for _ in range(n_cols)]
    col_ids: list[dict] = [{} for _ in range(n_cols)]
    rows = []
    for kt in key_tuples:
        row = []
        for c, v in enumerate(kt):
            vid = col_ids[c].get(v)
            if vid is None:
                vid = len(col_values[c])
                col_ids[c][v] = vid
                col_values[c].append(v)
            row.append(vid)
        rows.append(tuple(row))
    return {"columns": col_values, "rows": rows}


class _WindowContribution:
    """One old worker's window state, rebased to absolute window index
    (spilled planes merged resident)."""

    def __init__(self, meta: dict, arrays: dict, spill_planes: dict):
        self.meta = meta
        self.key_tuples = _interner_key_tuples(meta["interner"])
        w = int(meta["window_slots"])
        first = meta["first_open"]
        last = meta["max_win_seen"]
        spill_js = sorted(int(j) for j in spill_planes)
        if spill_js:
            first = min([first] + spill_js) if first is not None \
                else spill_js[0]
        self.first_open = first
        self.max_win_seen = last
        self.watermark_ms = meta.get("watermark_ms")
        # absolute window index -> {label: [G] row vector}
        self.planes: dict[int, dict[str, np.ndarray]] = {}
        if first is not None and last is not None:
            for j in range(first, last + 1):
                self.planes[j] = {
                    label: arr[j % w] for label, arr in arrays.items()
                }
        for j in spill_js:
            self.planes[j] = spill_planes[j]

    @property
    def n_groups(self) -> int:
        return len(self.key_tuples)


def _load_contribution(coord, window_key: str) -> _WindowContribution | None:
    from denormalized_tpu_torch.state.serialization import unpack_snapshot

    blob = coord.get_snapshot(window_key)
    if blob is None:
        return None  # this worker had no keyed snapshot at the epoch
    meta, arrays = unpack_snapshot(blob)
    if meta.get("interner") is None:
        raise StateError(
            "rescale: window snapshot has no group interner (global "
            "aggregate) — nothing to re-bucket; run at the same worker "
            "count"
        )
    spill_planes: dict[int, dict] = {}
    refs = meta.get("spill_windows") or {}
    for j_str, block_id in refs.items():
        raw = coord.get_snapshot(f"{window_key}:spill:{block_id}")
        if raw is None:
            raise StateError(
                f"rescale: epoch references spilled window {j_str} "
                "but its block snapshot is missing"
            )
        _bmeta, block_arrays = unpack_snapshot(raw)
        spill_planes[int(j_str)] = dict(block_arrays)
    return _WindowContribution(meta, arrays, spill_planes)


def _merge_var_shift(contribs: list[_WindowContribution]) -> dict:
    merged: dict = {}
    for c in contribs:
        for k, v in (c.meta.get("var_shift") or {}).items():
            if k in merged and merged[k] != v:
                raise StateError(
                    "rescale: variance shift pivots diverge across "
                    f"workers for aggregate {k!r} — variance state is "
                    "not mergeable under rescale (docs/cluster.md)"
                )
            merged[k] = v
    return merged


def _build_target_snapshot(
    parts: list[tuple[_WindowContribution, np.ndarray]], epoch: int
) -> tuple[dict, dict] | None:
    """Assemble one NEW worker's window snapshot from (contribution,
    kept-gid-indices) pairs.  Returns (meta, arrays) or None when no
    groups land here."""
    total = sum(len(sel) for _c, sel in parts)
    live = [(c, sel) for c, sel in parts if len(sel)]
    if total == 0 or not live:
        return None
    firsts = [c.first_open for c, _s in live if c.first_open is not None]
    lasts = [
        c.max_win_seen for c, _s in live if c.max_win_seen is not None
    ]
    wms = [c.watermark_ms for c, _s in live if c.watermark_ms is not None]
    if not firsts or not lasts:
        # groups interned but every window already emitted at the cut
        # (watermark closed them all): a valid, plane-less snapshot —
        # restore starts pre-first-batch with the interner intact
        first = last = None
        w_new = 16
    else:
        first = min(firsts)
        last = max(lasts)
        span = last - first + 1
        w_new = max(_next_pow2(span + 1), 16)
    g_cap = max(_next_pow2(total), 128)
    labels = {
        label
        for c, _s in live
        for planes in c.planes.values()
        for label in planes
    }
    arrays: dict[str, np.ndarray] = {}
    key_tuples: list[tuple] = []
    offset = 0
    for c, sel in live:
        key_tuples.extend(c.key_tuples[i] for i in sel)
        for j, planes in c.planes.items():
            if first is None or not (first <= j <= last):
                continue
            slot = j % w_new
            # sorted: label order here IS the arrays-dict insertion
            # order, which pack_snapshot serializes — set order would
            # make the rebuilt snapshot bytes hash-seed-dependent
            for label in sorted(labels):
                row = planes.get(label)
                if row is None:
                    continue
                dst = arrays.get(label)
                if dst is None:
                    # every cell no contribution covers — slots of later
                    # windows, groups interned after the restore — holds
                    # the plane's empty value, as a fresh ring does (the
                    # JAX package fills zeros: a min or max folded into
                    # such a cell then reads 0, ROADMAP §C)
                    dst = np.full((w_new, g_cap), _identity(label),
                                  dtype=row.dtype)
                    arrays[label] = dst
                if len(sel) and int(sel.max()) >= row.shape[0]:
                    # a plane captured before these groups existed (e.g.
                    # a spilled block) is implicitly empty for them — pad
                    # so gid positions stay aligned with the selection
                    padded = np.full(int(sel.max()) + 1, _identity(label),
                                     dtype=row.dtype)
                    padded[:row.shape[0]] = row
                    row = padded
                dst[slot, offset:offset + len(sel)] = row[sel]
        offset += len(sel)
    meta = {
        "epoch": epoch,
        "first_open": int(first) if first is not None else None,
        "max_win_seen": int(last) if last is not None else -1,
        "watermark_ms": int(min(wms)) if wms else None,
        "window_slots": int(w_new),
        "group_capacity": int(g_cap),
        "interner": _interner_snapshot_from_tuples(key_tuples),
        "var_shift": _merge_var_shift([c for c, _s in live]),
        "any_nulls_seen": any(
            c.meta.get("any_nulls_seen", True) for c, _s in live
        ),
    }
    return meta, arrays


def rescale_cluster(
    coordinator, manifest: dict, epoch: int, new_n: int, new_version: int
) -> None:
    """Re-bucket the committed cluster cut at ``epoch`` from
    ``manifest['n_workers']`` workers into ``new_n`` fresh stores under
    ``state/v<new_version>/`` — each written as a committed, manifested
    checkpoint at the SAME epoch, so the new workers restore through the
    exact same pinned path an unchanged restart uses."""
    from denormalized_tpu_torch.cluster.worker import PinnedCheckpointCoordinator
    from denormalized_tpu_torch.state.checkpoint import get_json, put_json
    from denormalized_tpu_torch.state.lsm import LsmStore
    from denormalized_tpu_torch.state.serialization import pack_snapshot

    old_n = int(manifest["n_workers"])
    old_version = int(manifest["store_version"])
    n_partitions = int(manifest["n_partitions"])
    state_keys = manifest.get("state_keys") or {}
    offsets_key = state_keys.get("offsets")
    keyed_key = state_keys.get("keyed")
    key_dtypes = manifest.get("key_dtypes") or []
    if keyed_key is not None and not keyed_key.startswith("window_"):
        raise StateError(
            f"rescale: keyed state {keyed_key!r} is not windowed-"
            "aggregation state — session/UDAF/join rescale is not "
            "implemented; restore at the original worker count "
            f"(N={old_n}) instead"
        )

    # -- read the old cut --------------------------------------------------
    global_offsets: dict[int, dict] = {}
    contribs: list[_WindowContribution | None] = []
    stores: list[LsmStore] = []
    try:
        for w in range(old_n):
            store = LsmStore(coordinator.store_dir(old_version, w))
            stores.append(store)
            coord = PinnedCheckpointCoordinator(store, epoch)
            if offsets_key:
                snap = get_json(coord, offsets_key)
                if snap is None:
                    raise StateError(
                        f"rescale: worker {w} has no offsets snapshot "
                        f"at epoch {epoch}"
                    )
                pids = partitions_for(w, old_n, n_partitions)
                parts = snap.get("partitions", [])
                if len(parts) != len(pids):
                    raise StateError(
                        f"rescale: worker {w} offsets cover "
                        f"{len(parts)} partitions, assignment expects "
                        f"{len(pids)}"
                    )
                for pid, s in zip(pids, parts):
                    global_offsets[pid] = s
            contribs.append(
                _load_contribution(coord, keyed_key)
                if keyed_key else None
            )

        # -- bucket groups under the new hash map -------------------------
        assignments: list[list[np.ndarray]] = []  # [old_w][new_t] -> gids
        for c in contribs:
            if c is None or c.n_groups == 0:
                assignments.append(
                    [np.empty(0, dtype=np.int64) for _ in range(new_n)]
                )
                continue
            cols = _typed_key_columns(c.key_tuples, key_dtypes)
            buckets = bucket_rows(cols, new_n)
            assignments.append([
                np.nonzero(buckets == t)[0].astype(np.int64)
                for t in range(new_n)
            ])

        # -- write the new stores -----------------------------------------
        for t in range(new_n):
            store_path = coordinator.store_dir(new_version, t)
            os.makedirs(store_path, exist_ok=True)
            new_store = LsmStore(store_path)
            try:
                new_coord = PinnedCheckpointCoordinator(new_store, None)
                if offsets_key:
                    pids = partitions_for(t, new_n, n_partitions)
                    missing = [p for p in pids if p not in global_offsets]
                    if missing:
                        raise StateError(
                            f"rescale: no offsets for partitions "
                            f"{missing} in the old cut"
                        )
                    put_json(
                        new_coord, offsets_key, epoch,
                        {
                            "epoch": epoch,
                            "partitions": [
                                global_offsets[p] for p in pids
                            ],
                        },
                    )
                if keyed_key:
                    parts = [
                        (c, assignments[w][t])
                        for w, c in enumerate(contribs)
                        if c is not None
                    ]
                    built = _build_target_snapshot(parts, epoch)
                    if built is not None:
                        meta, arrays = built
                        new_coord.put_snapshot(
                            keyed_key, epoch,
                            pack_snapshot(meta, arrays),
                        )
                new_coord.commit(epoch)
            finally:
                new_store.close()
    finally:
        for s in stores:
            s.close()
