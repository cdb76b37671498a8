"""Exchange wire format: length-prefixed, CRC-framed column buffers.

Counterpart of ``denormalized_tpu/cluster/framing.py``: a frame's bytes
equal the JAX package's for the same batch.

The cross-process sibling of the checkpoint blob format
(state/serialization.py + state/checkpoint.py framing): every frame is

::

    [4B magic "DNZX"][u32 payload_len][u32 crc32(payload)][payload]
    payload = [u32 header_len][header JSON utf-8][col buf 0][col buf 1]...

No pickle — frames are decodable across processes and a torn or
bit-flipped frame is DETECTED (magic/length/CRC mismatch raises
``SourceError``) instead of being reassembled into garbage rows.  Data
frames carry raw little-endian column buffers for numeric columns and a
JSON value list for object (string) columns; every data frame also
piggybacks the sender's current watermark so an edge that only ever
receives another worker's keys still advances event time.

Frame types (``"t"`` in the header): ``hello`` (edge identification:
worker id + sender generation + the sender's pinned restore epoch),
``data`` (column buffers + watermark + optional source-partition id),
``wm`` (watermark-only advance), ``barrier`` (checkpoint epoch marker,
in-band), ``eos`` (sender's partitions exhausted), and ``resume`` — the
ONE receiver→sender frame in the protocol, written by the exchange
server right after every hello so a reconnecting sender learns where
the edge stands (frames seen, last committed barrier, rows delivered
per source partition since that barrier).  Sequence numbers are
IMPLICIT: both ends count post-hello frames per sender generation, so
the wire format needs no per-frame counter — a replayed frame keeps
its original position by construction (docs/cluster.md#rejoin).

``encode_data`` / ``decode_data`` are pinned hot paths
(tools/dnzlint/hotpaths.toml): per-column comprehensions only, never
per-row statements.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from denormalized_tpu_torch.common.columns import (
    Column,
    column_from_spec,
    column_spec_and_buffers,
)
from denormalized_tpu_torch.common.errors import SourceError
from denormalized_tpu_torch.common.record_batch import RecordBatch
from denormalized_tpu_torch.common.schema import Schema

MAGIC = b"DNZX"
_HDR = struct.Struct("<4sII")  # magic, payload_len, payload_crc32

#: refuse frames claiming more than this — a corrupt length prefix must
#: not turn into a multi-GB allocation before the CRC check can run
MAX_FRAME_BYTES = 1 << 30


def _frame(payload: bytes) -> bytes:
    return _HDR.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


def _payload(header: dict, bufs: list[bytes]) -> bytes:
    hj = json.dumps(header, separators=(",", ":")).encode()
    return b"".join([struct.pack("<I", len(hj)), hj] + bufs)


def encode_hello(
    worker_id: int, gen: int = 0, restore_epoch: int = 0
) -> bytes:
    """Edge identification.  ``gen`` is the sender's incarnation number
    (bumped by the coordinator at every spawn of that worker, full or
    partial) — the receiver resets its per-edge frame count when it
    sees a new generation.  ``restore_epoch`` is the cluster-committed
    epoch the sender was pinned to at startup (0 = fresh): a reborn
    sender's peers answer with how many rows per partition they already
    received since that barrier, so the replayed stream is deduplicated
    exactly (docs/cluster.md#rejoin)."""
    return _frame(_payload(
        {"t": "hello", "from": int(worker_id), "gen": int(gen),
         "restore": int(restore_epoch)},
        [],
    ))


def encode_resume(
    gen_seen: int,
    frames_seen: int,
    epoch: int,
    counts: dict[int, int],
    counts_ok: bool = True,
) -> bytes:
    """Receiver → sender, written once after every hello.  ``gen_seen``
    is the sender generation the receiver last heard from on this edge
    (-1 = never — fresh receiver or fresh edge), ``frames_seen`` the
    number of post-hello frames it fully processed from that
    generation, ``epoch`` the last cluster-committed barrier it knows,
    and ``counts`` the rows per source partition delivered on this edge
    since that barrier (the reborn-sender dedup ledger).  ``counts_ok``
    is False when the receiver could not attribute rows to partitions
    (unstamped batches) — the sender must then escalate to the
    full-cluster fallback rather than guess."""
    return _frame(_payload(
        {"t": "resume", "gen": int(gen_seen), "seen": int(frames_seen),
         "epoch": int(epoch),
         "counts": {str(k): int(v) for k, v in counts.items()},
         "ok": bool(counts_ok)},
        [],
    ))


def encode_wm(ts_ms: int) -> bytes:
    return _frame(_payload({"t": "wm", "wm": int(ts_ms)}, []))


def encode_barrier(
    epoch: int, skips: dict[int, int] | None = None
) -> bytes:
    """Checkpoint epoch marker.  ``skips`` is the sender's residual
    router-side skip per source partition at the moment the barrier
    entered its stream: a reborn sender that is still draining its
    dedup skip emits barriers at a stream position BEHIND the rows the
    receiver already holds, so the receiver must subtract this residual
    when snapshotting its delivered-rows ledger for the epoch —
    otherwise a second rebirth anchored at this barrier under-skips and
    duplicates rows (docs/cluster.md#rejoin)."""
    hdr: dict = {"t": "barrier", "epoch": int(epoch)}
    if skips:
        hdr["skips"] = {str(k): int(v) for k, v in skips.items()}
    return _frame(_payload(hdr, []))


def encode_eos() -> bytes:
    return _frame(_payload({"t": "eos"}, []))


def _legacy_json_lane() -> bool:
    """``DENORMALIZED_EXCHANGE_JSON=1`` forces string/nested columns onto
    the legacy JSON value-list lane (kept for one PR as the raw lane's
    differential oracle; both lanes decode everywhere)."""
    import os

    return os.environ.get("DENORMALIZED_EXCHANGE_JSON") == "1"


def _col_buf(col: np.ndarray) -> bytes:
    if col.dtype == object:
        return json.dumps(col.tolist()).encode()  # dnzlint: allow(hot-loop) plain OBJECT columns (python-decoded nested values, mixed objects) have no raw-buffer form; columnar StringColumn/NestedColumn ride the raw offsets+bytes sub-frames in _col_spec_bufs instead
    return np.ascontiguousarray(col).tobytes()


def _col_spec_bufs(col) -> tuple[dict, list[bytes]]:
    """(header spec, raw buffers) for one column.  Columnar string/nested
    columns ship their buffers VERBATIM — offsets+bytes sub-frames, no
    JSON, no per-row Python; ndarrays keep the historical single-buffer
    lanes."""
    if isinstance(col, Column) and not _legacy_json_lane():
        spec, arrs = column_spec_and_buffers(col)
        bufs = [np.ascontiguousarray(a).tobytes() for a in arrs]
        return (
            {"dtype": "col", "spec": spec, "nb": [len(b) for b in bufs],
             "nbytes": sum(len(b) for b in bufs)},
            bufs,
        )
    arr = np.asarray(col)
    b = _col_buf(arr)
    return (
        {"dtype": "obj" if arr.dtype == object else arr.dtype.str,
         "nbytes": len(b)},
        [b],
    )


def encode_data(
    batch: RecordBatch, wm_ms: int | None, part: int | None = None
) -> bytes:
    """One RecordBatch → one frame.  Column order is schema order (the
    receiver rebuilds against its own copy of the same schema); masks
    ride as optional bool buffers.  ``part`` is the GLOBAL source
    partition the batch's rows came from (batches never mix
    partitions upstream of the router) — receivers ledger rows per
    (edge, partition) against it so a reborn sender can skip exactly
    the prefix already delivered."""
    specs_bufs = [_col_spec_bufs(c) for c in batch.columns]
    bufs = [b for _, bl in specs_bufs for b in bl]
    # a columnar column already ships its validity inside its own
    # sub-frames — re-shipping the identical batch mask would cost one
    # redundant byte per row per null-bearing column (the decode side
    # rebuilds the mask from the column's validity)
    masks = [
        None
        if m is None or (
            spec["dtype"] == "col"
            and m is getattr(c, "validity", None)
        )
        else m
        for (spec, _), c, m in zip(
            specs_bufs, batch.columns, batch.masks
        )
    ]
    mask_bufs = [
        np.ascontiguousarray(m).tobytes() if m is not None else b""
        for m in masks
    ]
    header = {
        "t": "data",
        "wm": int(wm_ms) if wm_ms is not None else None,
        "rows": int(batch.num_rows),
        "cols": [s for s, _ in specs_bufs],
        "masks": [len(b) if m is not None else None
                  for m, b in zip(masks, mask_bufs)],
    }
    if part is not None:
        header["part"] = int(part)
    return _frame(_payload(header, bufs + [b for b in mask_bufs if b]))


def decode_frame(payload: bytes, schema: Schema) -> tuple:
    """Decode one verified payload → ``(type, ...)`` tuple:

    - ``("hello", worker_id, gen, restore_epoch)``
    - ``("resume", gen_seen, frames_seen, epoch, counts, counts_ok)``
    - ``("data", RecordBatch, wm_ms_or_None, part_or_None)``
    - ``("wm", ts_ms)``
    - ``("barrier", epoch, residual_skips)``
    - ``("eos",)``
    """
    if len(payload) < 4:
        raise SourceError("exchange frame too short for header length")
    (hlen,) = struct.unpack_from("<I", payload, 0)
    if 4 + hlen > len(payload):
        raise SourceError("exchange frame header overruns payload")
    try:
        header = json.loads(payload[4:4 + hlen].decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise SourceError(f"exchange frame header undecodable: {e}") from e
    t = header.get("t")
    if t == "data":
        batch, wm = decode_data(header, payload, hlen, schema)
        part = header.get("part")
        return ("data", batch, wm, int(part) if part is not None else None)
    if t == "wm":
        return ("wm", int(header["wm"]))
    if t == "barrier":
        return (
            "barrier",
            int(header["epoch"]),
            {int(k): int(v)
             for k, v in header.get("skips", {}).items()},
        )
    if t == "eos":
        return ("eos",)
    if t == "hello":
        return (
            "hello",
            int(header["from"]),
            int(header.get("gen", 0)),
            int(header.get("restore", 0)),
        )
    if t == "resume":
        return (
            "resume",
            int(header["gen"]),
            int(header["seen"]),
            int(header["epoch"]),
            {int(k): int(v) for k, v in header.get("counts", {}).items()},
            bool(header.get("ok", True)),
        )
    raise SourceError(f"unknown exchange frame type {t!r}")


def _col_from(buf: bytes, spec: dict, rows: int) -> np.ndarray:
    if spec["dtype"] == "obj":
        vals = json.loads(buf.decode())
        arr = np.empty(rows, dtype=object)
        arr[:] = vals
        return arr
    return np.frombuffer(buf, dtype=np.dtype(spec["dtype"]))


#: buffer dtypes of the raw columnar lane, in column_spec_and_buffers'
#: depth-first order — each spec kind contributes a fixed dtype sequence,
#: reconstructed by _columnar_bufs below
_SPEC_BUF_DTYPES = {
    "str": lambda s: [np.int64, np.uint8] + ([np.bool_] if s["v"] else []),
    "prim": lambda s: [
        {"i64": np.int64, "f64": np.float64, "bool": np.uint8}[s["p"]]
    ] + ([np.bool_] if s["v"] else []),
}


def _spec_buf_dtypes(spec: dict, out: list) -> None:
    k = spec["k"]
    fixed = _SPEC_BUF_DTYPES.get(k)
    if fixed is not None:
        out.extend(fixed(spec))
        return
    if spec["v"]:
        out.append(np.bool_)
    if k == "list":
        out.append(np.int64)
    for c in spec["ch"]:
        _spec_buf_dtypes(c, out)


def _columnar_col_from(spec: dict, payload: bytes, off: int):
    """Rebuild one columnar column from its raw sub-frames (zero-copy
    views over the frame buffer — read-only, like the numeric lane)."""
    dts: list = []
    _spec_buf_dtypes(spec["spec"], dts)
    lens = spec["nb"]
    if len(dts) != len(lens):
        raise SourceError(
            "exchange columnar spec/buffer count mismatch "
            f"({len(dts)} vs {len(lens)})"
        )
    arrs = []
    for dt, n in zip(dts, lens):  # dnzlint: allow(hot-loop) bounded per-BUFFER sweep (spec tree size), never per-row; offsets are sequential
        arrs.append(np.frombuffer(payload[off:off + n], dtype=dt))
        off += n
    return column_from_spec(spec["spec"], iter(arrs)), off


def decode_data(
    header: dict, payload: bytes, hlen: int, schema: Schema
) -> tuple[RecordBatch, int | None]:
    """Data payload → (RecordBatch, piggybacked watermark).  Numeric
    columns are zero-copy views over the frame buffer (read-only —
    operators never mutate input columns); columnar string/nested
    columns rebuild as zero-copy views the same way."""
    rows = int(header["rows"])
    specs = header["cols"]
    if len(specs) != len(schema):
        raise SourceError(
            f"exchange data frame has {len(specs)} columns, schema "
            f"expects {len(schema)}"
        )
    off = 4 + hlen
    cols = []
    for spec in specs:  # dnzlint: allow(hot-loop) bounded per-COLUMN sweep (schema width), never per-row; offsets are sequential so this cannot be a comprehension
        if spec["dtype"] == "col":
            col, off = _columnar_col_from(spec, payload, off)
            cols.append(col)
            continue
        n = int(spec["nbytes"])
        cols.append(_col_from(payload[off:off + n], spec, rows))
        off += n
    masks = []
    for i, mspec in enumerate(header["masks"]):  # dnzlint: allow(hot-loop) same bounded per-column sweep for the optional validity masks
        if mspec is None:
            # columnar columns carry validity in their own sub-frames;
            # surface it as the batch mask (the sender elided the
            # redundant copy)
            masks.append(getattr(cols[i], "validity", None))
        else:
            masks.append(
                np.frombuffer(payload[off:off + mspec], dtype=bool)
            )
            off += mspec
    batch = RecordBatch(schema, cols, masks)
    wm = header.get("wm")
    return batch, int(wm) if wm is not None else None


def read_exact(sock, n: int) -> bytes | None:
    """Read exactly ``n`` bytes from a socket; None on clean EOF at a
    frame boundary (0 bytes read), SourceError on EOF mid-frame (a torn
    frame — the sender died or a fault rule cut it)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            if got == 0:
                return None
            raise SourceError(
                f"exchange connection torn mid-frame ({got}/{n} bytes)"
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(sock) -> bytes | None:
    """Read + verify one frame from a socket → payload bytes, or None on
    clean EOF.  Every integrity violation (bad magic, oversize length,
    CRC mismatch, mid-frame EOF) raises ``SourceError`` — a torn frame
    is dropped WHOLE, so the receiver's per-edge ledgers always cover
    an exact prefix of the sender's stream.  Under partial recovery the
    receiver marks the edge down and awaits reconnect; in fail-stop
    mode the worker dies and the coordinator restarts the cluster from
    the last committed epoch (docs/cluster.md#failure-matrix)."""
    hdr = read_exact(sock, _HDR.size)
    if hdr is None:
        return None
    magic, plen, crc = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise SourceError(f"exchange frame bad magic {magic!r}")
    if plen > MAX_FRAME_BYTES:
        raise SourceError(f"exchange frame length {plen} exceeds cap")
    payload = read_exact(sock, plen)
    if payload is None:
        raise SourceError("exchange connection torn before payload")
    if zlib.crc32(payload) != crc:
        raise SourceError("exchange frame CRC mismatch (torn or corrupt)")
    return payload
