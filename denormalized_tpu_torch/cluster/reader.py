"""Read-side of the cluster's exactly-once output protocol — stdlib
only (no engine imports), so soak parents and external tooling can load
it standalone, same contract as obs/readers.py.

Counterpart of ``denormalized_tpu/cluster/reader.py``.

The coordinator records one **segment** per spawn in
``meta/segments.jsonl`` (also returned as ``result["segments"]``): a
FULL record names the restore epoch plus every worker slot's output
file; a PARTIAL record (single-worker recovery) carries ``"worker"``
and only that slot's new file.  Each row line carries ``ep`` — the
in-flight CLUSTER epoch at write time.  Rows a segment emitted beyond
the epoch its successor restored from are the uncommitted suffix that
successor regenerates; the reader discards them (transactional
truncate-on-restore, reader-side — the protocol of the JAX package's
``tools/soak.py``).

The clip boundary is per (segment, slot): a full restart re-emits
EVERY slot's uncommitted suffix, so a full record bounds all earlier
output, while a partial record re-emits only the dead worker's suffix
— survivors' rows must NOT be clipped by a peer's recovery (their
windows beyond the restore epoch were emitted once and never again).
Epochs are cluster-global, so full-record clipping still works across
worker-count changes (rescale re-maps which WORKER re-emits a window,
never which EPOCH covers it); partial records never straddle a rescale
— that path is always a full restart."""

from __future__ import annotations

import json


def _read_file(path: str) -> tuple[list, bool]:
    rows = []
    done = False
    try:
        f = open(path)
    except FileNotFoundError:
        return rows, done
    with f:
        for line in f:
            try:
                o = json.loads(line)
            except ValueError:
                continue  # torn tail (SIGKILL mid-write)
            ev = o.get("event")
            if ev == "done":
                done = True
            elif ev is None:
                rows.append(o)
    return rows, done


def read_cluster(segments: list) -> dict:
    """All segments' outputs → ``{"rows": [...], "clipped": n,
    "done_files": k, "generations": g}``.  ``segments`` is the
    coordinator's ``result["segments"]`` (or the parsed
    ``meta/segments.jsonl``), in generation order."""
    recs = []  # {"restored", "worker"|None, "slots": [(slot, rows)], "emitting", "done"}
    for seg in segments:
        files = seg.get("files", [])
        worker = seg.get("worker")
        if worker is not None:
            slots = [int(worker)]
        else:
            slots = list(range(len(files)))
        slot_rows = []
        done_files = 0
        for slot, path in zip(slots, files):
            r, d = _read_file(path)
            slot_rows.append((slot, r))
            done_files += int(d)
        recs.append({
            "restored": seg.get("restored"),
            "worker": None if worker is None else int(worker),
            "slots": slot_rows,
            "emitting": any(r for _, r in slot_rows),
            "done": done_files,
        })
    kept: list = []
    clipped = 0
    done_files = 0
    for i, rec in enumerate(recs):
        done_files += rec["done"]
        for slot, rows in rec["slots"]:
            # boundary for THIS slot: the restore epoch of the first
            # later emitting segment that re-covers it (any full restart,
            # or this very worker's own partial respawn); a restart from
            # no commit re-covers everything (0) — the JAX reader keeps
            # everything then and duplicates the re-emitted windows.
            # None = nothing after regenerates this slot's output, keep
            # everything
            boundary = None
            for j in range(i + 1, len(recs)):
                nxt = recs[j]
                if nxt["worker"] is not None and nxt["worker"] != slot:
                    continue  # a PEER's recovery never re-emits us
                if nxt["emitting"]:
                    boundary = nxt["restored"] or 0
                    break
            for o in rows:
                ep = o.get("ep")
                if (
                    boundary is not None
                    and ep is not None
                    and ep > boundary
                ):
                    clipped += 1
                    continue
                kept.append(o)
    return {
        "rows": kept,
        "clipped": clipped,
        "done_files": done_files,
        "generations": len(recs),
    }
