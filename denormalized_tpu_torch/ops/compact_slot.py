"""Emission compaction of one ring slot — the wrapper of the hand-written
CUDA kernel ``csrc/compact_slot.cu``.

:func:`compact_slot` moves the active cells (row count > 0) of one ring
slot to the front of a fresh buffer for every component plane at once, in
ascending gid, and counts them on the device: the port of the JAX
package's ``segment_agg._compact_slot``.  ``segment_agg.read_slot_compact``
then reads the count, and moves only a power-of-two prefix of the
compacted buffers to the host.  On a CUDA tensor it launches the kernel or
raises; it takes its plain version :func:`compact_slot_reference` only for
tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

# the kernel's by-value plane table (MAX_PLANES in the source)
MAX_PLANES = 64

#: launches of the CUDA kernel, one a compacted slot (incremented where it
#: launches, and nowhere else — the CPU reference does not count)
compact_slot_launches = 0
_COUNT_LOCK = threading.Lock()


class _Plane(ctypes.Structure):
    """``Plane`` of the source: a slot row, its output buffer, its
    element size."""

    _fields_ = [
        ("src", ctypes.c_void_p),
        ("dst", ctypes.c_void_p),
        ("bytes", ctypes.c_int),
    ]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from denormalized_tpu_torch.ops.cuda_build import load

    lib = load("compact_slot")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.compact_slot_launch.argtypes = [p, i, i, p, p, p, p, p]
    lib.compact_slot_launch.restype = i
    lib.compact_slot_error_string.argtypes = [i]
    lib.compact_slot_error_string.restype = ctypes.c_char_p
    lib.compact_slot_blocks.argtypes = [i]
    lib.compact_slot_blocks.restype = i
    return lib


def compact_slot_reference(
    counts: torch.Tensor, planes: list[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """The plain PyTorch version: ``torch.nonzero`` of the active cells and
    an ``index_select`` of each plane → (active count as a (1,) int32
    tensor, the k active gids as int32, each plane's k values)."""
    gids = torch.nonzero(counts > 0).squeeze(1)
    n = torch.tensor([gids.numel()], dtype=torch.int32, device=counts.device)
    return n, gids.to(torch.int32), [p.index_select(0, gids) for p in planes]


def _check(counts: torch.Tensor, planes: list[torch.Tensor]) -> None:
    """dtype, device, shape and contiguity of the slot's rows."""
    if counts.dtype != torch.int32 or counts.dim() != 1:
        raise TypeError(
            f"counts must be a 1-D int32 tensor, got {counts.dtype} "
            f"{tuple(counts.shape)}"
        )
    if counts.numel() < 1 or counts.numel() >= 2**31:
        raise ValueError(f"G={counts.numel()} outside [1, 2^31)")
    if len(planes) > MAX_PLANES:
        raise ValueError(f"{len(planes)} planes exceed the kernel's "
                         f"{MAX_PLANES}")
    for i, t in enumerate((counts, *planes)):
        if t.device != counts.device:
            raise ValueError(f"plane {i} is on {t.device}, counts on "
                             f"{counts.device}")
        if t.shape != counts.shape or not t.is_contiguous():
            raise ValueError(f"plane {i} must be a contiguous "
                             f"{tuple(counts.shape)}, got {tuple(t.shape)}")
        if t.element_size() not in (4, 8):
            raise TypeError(f"plane {i} has {t.element_size()}-byte "
                            "elements; the kernel copies 4 or 8")


def _launch(counts, planes):
    global compact_slot_launches
    G = counts.numel()
    dev = counts.device
    lib = _lib()
    gids = torch.empty(G, dtype=torch.int32, device=dev)
    n = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.compact_slot_blocks(G), dtype=torch.int32,
                          device=dev)
    outs = [torch.empty_like(p) for p in planes]
    table = (_Plane * max(1, len(planes)))()
    for j, (p, o) in enumerate(zip(planes, outs)):
        table[j] = _Plane(p.data_ptr(), o.data_ptr(), p.element_size())
    rc = lib.compact_slot_launch(
        counts.data_ptr(), G, len(planes), table, gids.data_ptr(),
        n.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        msg = lib.compact_slot_error_string(rc).decode()
        raise RuntimeError(f"compact_slot kernel launch failed: {msg} "
                           f"(code {rc})")
    with _COUNT_LOCK:  # window operators may emit from several threads
        compact_slot_launches += 1
    return n, gids, outs


def compact_slot(
    counts: torch.Tensor, planes: list[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """Compact one slot: ``counts`` is its (G,) int32 row-count row,
    ``planes`` its rows of every component plane (G elements of 4 or 8
    bytes) → (the active count k as a (1,) int32 tensor on the device, the
    gids with the k active ones first in ascending order, each plane's
    values aligned to them).  On the card the buffers hold G entries, of
    which the first k are set; the plain version returns k."""
    _check(counts, planes)
    if counts.device.type == "cpu":
        return compact_slot_reference(counts, planes)
    if counts.device.type != "cuda":
        raise ValueError(f"no compact_slot kernel for {counts.device}")
    return _launch(counts, planes)
