"""Checkpoint payload format.

Counterpart of the reference's ``ArrayContainer`` bincode scheme
(crates/core/src/utils/serialization.rs:130-235: recursive ArrayData ⇄
buffers) and its ScalarValue-JSON serde (accumulators/serialize.rs): one
self-describing binary blob per checkpoint key holding a JSON metadata
header plus raw little-endian array buffers.  No pickle — payloads are
loadable across processes and safe to read from untrusted stores.

Layout:  [u32 header_len][header JSON utf-8][buf 0][buf 1]...
Header: {"meta": <json>, "arrays": [{"name","dtype","shape","nbytes"},...]}

Counterpart of ``denormalized_tpu/state/serialization.py``: the same magic,
version and header, byte for byte, so each package reads the other's
snapshots.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from denormalized_tpu_torch.common.errors import StateError

_MAGIC = b"DTCK"  # denormalized-tpu checkpoint
_VERSION = 1


def pack_snapshot(meta: dict, arrays: dict[str, np.ndarray]) -> bytes:
    entries = []
    bufs = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype == object:
            raise StateError(f"array {name!r} has object dtype; not packable")
        raw = arr.tobytes()
        entries.append(
            {
                "name": name,
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "nbytes": len(raw),
            }
        )
        bufs.append(raw)
    header = json.dumps({"v": _VERSION, "meta": meta, "arrays": entries}).encode()
    out = bytearray()
    out += _MAGIC
    out += struct.pack("<I", len(header))
    out += header
    for b in bufs:
        out += b
    return bytes(out)


def unpack_snapshot(blob: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    if blob[:4] != _MAGIC:
        raise StateError("bad checkpoint magic")
    (hlen,) = struct.unpack_from("<I", blob, 4)
    header = json.loads(blob[8 : 8 + hlen].decode())
    if header.get("v") != _VERSION:
        raise StateError(f"unsupported checkpoint version {header.get('v')}")
    arrays = {}
    off = 8 + hlen
    for e in header["arrays"]:
        n = e["nbytes"]
        arr = np.frombuffer(blob[off : off + n], dtype=np.dtype(e["dtype"]))
        arrays[e["name"]] = arr.reshape(e["shape"]).copy()
        off += n
    return header["meta"], arrays
