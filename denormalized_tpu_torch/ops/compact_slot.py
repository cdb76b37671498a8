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

The kernel is one launch (a single-pass compaction with decoupled
look-back).  Its scratch — a status word a 1,024-cell tile and a ticket
counter — is allocated zeroed once per (device, G, stream) and never
reset: each call passes its number on that scratch, which tags the status
words (see the source), and the number is handed out and the launch queued
under one lock, so launches reach the stream in call-number order whatever
threads emit.  A call's outputs take one allocation on the card, a byte
arena that holds the count and one (rows, G) block a dtype among the gids
and the planes, a row a plane; so ``segment_agg.read_slot_compact`` moves
each dtype's prefixes to the host in one copy.  The arena's layout and the
plane table's order are computed once per (the planes' dtypes, G).
"""

from __future__ import annotations

import ctypes
import functools
import operator
import threading

import torch

# the kernel's by-value plane table (MAX_PLANES in the source)
MAX_PLANES = 64
# cells a tile (TILE_CELLS in the source) and blocks an SM at most
TILE_CELLS = 1024
BLOCKS_PER_SM = 4
# arena blocks start on 16-byte boundaries
ALIGN = 16
# the status words' call tag has 30 bits: a scratch is replaced before
# its call number reaches 2^30
_MAX_CALLS = (1 << 30) - 1

#: launches of the CUDA kernel, one a compacted slot (incremented where it
#: launches, and nowhere else — the CPU reference does not count)
compact_slot_launches = 0
_COUNT_LOCK = threading.Lock()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from denormalized_tpu_torch.ops.cuda_build import load

    lib = load("compact_slot")
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.compact_slot_launch.argtypes = [p, i, i, i, p, i, p, p, p, p, u64,
                                        i, p]
    lib.compact_slot_launch.restype = i
    lib.compact_slot_error_string.argtypes = [i]
    lib.compact_slot_error_string.restype = ctypes.c_char_p
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


def tiles_of(G: int) -> int:
    """The kernel's 1,024-cell tiles for G cells."""
    return -(-G // TILE_CELLS)


class _Scratch:
    """One (device, G, stream)'s look-back scratch: ``words[0]`` is the
    ticket counter, ``words[1:]`` a status word a tile, zeroed once; and
    the number of calls made on it."""

    def __init__(self, device: torch.device, G: int):
        self.words = torch.zeros(tiles_of(G) + 1, dtype=torch.int64,
                                 device=device)
        self.calls = 0


_SCRATCH: dict[tuple, _Scratch] = {}
# held from a call's number to its launch being queued: calls on one
# scratch must reach its stream in call-number order
_SCRATCH_LOCK = threading.Lock()


def _scratch(device: torch.device, G: int, stream: int) -> tuple[_Scratch,
                                                                  int]:
    """The cached scratch of (device, G, stream) and the next call's
    number on it (1, 2, ...), the caller holding ``_SCRATCH_LOCK``.  A
    scratch whose call tag would overflow is replaced."""
    key = (device, G, stream)
    s = _SCRATCH.get(key)
    if s is None or s.calls >= _MAX_CALLS:
        s = _SCRATCH[key] = _Scratch(device, G)
    s.calls += 1
    return s, s.calls


def _rows_by_dtype(dtypes: tuple) -> dict[torch.dtype, list[int]]:
    """The output rows of each dtype: the plane indices in the caller's
    order, -1 (the gids) first among the int32 ones."""
    rows: dict[torch.dtype, list[int]] = {torch.int32: [-1]}
    for i, dt in enumerate(dtypes):
        rows.setdefault(dt, []).append(i)
    return rows


def _up(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


class Layout:
    """One call's arena for the planes' ``dtypes`` and G cells, and the
    kernel's plane table order.  Byte offsets: the (1,) int32 count at 0,
    and a (rows, G) block a dtype from ``ALIGN`` on, the gids row 0 of
    the int32 block (``groups``: each block's dtype, its offset in
    elements of that dtype, and the plane index of each row, -1 for the
    gids).  ``order`` lists the plane indices in table order, the ``n4``
    4-byte planes first, then the ``n8`` 8-byte ones; ``dst_off`` their
    output rows' byte offsets in that order."""

    def __init__(self, dtypes: tuple, G: int):
        four = [i for i, dt in enumerate(dtypes) if dt.itemsize == 4]
        self.order = four + [i for i, dt in enumerate(dtypes)
                             if dt.itemsize == 8]
        self.n4, self.n8 = len(four), len(self.order) - len(four)
        self.G = G
        off = ALIGN
        self.groups: list[tuple[torch.dtype, int, list[int]]] = []
        row_off: dict[int, int] = {}
        for dt, idx in _rows_by_dtype(dtypes).items():
            row = G * dt.itemsize
            self.groups.append((dt, off // dt.itemsize, idx))
            for r, i in enumerate(idx):
                row_off[i] = off + r * row
            off = _up(off + len(idx) * row)
        self.nbytes = off
        self.gids_off = row_off[-1]
        self.dst_off = [row_off[i] for i in self.order]

    def views(self, arena: torch.Tensor
              ) -> tuple[torch.Tensor, list[tuple[torch.Tensor, list[int]]]]:
        """The count and the (rows, G) blocks of ``arena`` → (n, groups:
        [(the 2-D block, the plane index of each row, -1 for the
        gids)])."""
        G = self.G
        i32 = arena.view(torch.int32)
        return i32[:1], [((i32 if dt == torch.int32 else arena.view(dt)).as_strided(
            (len(idx), G), (G, 1), at), idx) for dt, at, idx in self.groups]


@functools.lru_cache(maxsize=64)
def layout(dtypes: tuple, G: int) -> Layout:
    """The arena layout of (the planes' dtypes, G), computed once."""
    return Layout(dtypes, G)


def alloc_outputs(
    G: int, planes: list[torch.Tensor], device: torch.device
) -> tuple[torch.Tensor, Layout]:
    """A call's one allocation: the byte arena of :func:`layout` on
    ``device`` → (arena, layout)."""
    lay = layout(tuple(p.dtype for p in planes), G)
    return torch.empty(lay.nbytes, dtype=torch.uint8, device=device), lay


def plane_table(planes: list[torch.Tensor], lay: Layout, base: int
                ) -> tuple[ctypes.Array, bool]:
    """The kernel's (src, dst) pointer pairs in table order, each dst its
    plane's row of the arena at ``base`` → (a ctypes uint64 array of
    max(1, planes) pairs, whether every src is 16-B aligned)."""
    src = [planes[i].data_ptr() for i in lay.order]
    flat = [v for s, d in zip(src, lay.dst_off) for v in (s, base + d)]
    flat = flat or [0, 0]  # the kernel reads no pair where there are none
    every = functools.reduce(operator.or_, src, 0)
    return (ctypes.c_uint64 * len(flat))(*flat), every % ALIGN == 0


def split_outputs(
    groups: list[tuple[torch.Tensor, list[int]]], n_planes: int
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The gids row and each plane's row of the groups, in the caller's
    order → (gids, outs)."""
    outs: list = [None] * n_planes
    gids = None
    for buf, idx in groups:
        for i, row in zip(idx, buf.unbind(0)):
            if i < 0:
                gids = row
            else:
                outs[i] = row
    return gids, outs


@functools.cache
def _max_blocks(index: int) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        index).multi_processor_count


def _launch(counts, planes, stream: int, blocks: int):
    """Queue the kernel on ``stream`` → (n, groups)."""
    global compact_slot_launches
    G = counts.numel()
    arena, lay = alloc_outputs(G, planes, counts.device)
    base = arena.data_ptr()
    table, aligned = plane_table(planes, lay, base)
    aligned = aligned and counts.data_ptr() % ALIGN == 0
    lib = _lib()
    dev = counts.device
    with _SCRATCH_LOCK:
        scratch, call = _scratch(dev, G, stream)
        words = scratch.words.data_ptr()
        rc = lib.compact_slot_launch(
            counts.data_ptr(), G, lay.n4, lay.n8, table, int(aligned),
            base + lay.gids_off, base, words + 8, words, call,
            blocks, stream,
        )
        if rc != 0:  # no tickets taken: the call numbers no longer match
            _SCRATCH.pop((dev, G, stream), None)
    if rc != 0:
        msg = lib.compact_slot_error_string(rc).decode()
        raise RuntimeError(f"compact_slot kernel launch failed: {msg} "
                           f"(code {rc})")
    with _COUNT_LOCK:  # window operators may emit from several threads
        compact_slot_launches += 1
    return lay.views(arena)


def compact_slot_groups(
    counts: torch.Tensor, planes: list[torch.Tensor]
) -> tuple[torch.Tensor, list[tuple[torch.Tensor, list[int]]]]:
    """:func:`compact_slot` with its outputs grouped by dtype, for a caller
    that moves them in bulk → (the count, groups as
    :meth:`Layout.views` makes them).  A group's rows hold G entries on
    the card, k for the plain version (the CPU), whose rows are stacked
    into the same layout."""
    _check(counts, planes)
    dev = counts.device
    if dev.type == "cpu":
        n, gids, outs = compact_slot_reference(counts, planes)
        rows = _rows_by_dtype(tuple(p.dtype for p in planes))
        return n, [(torch.stack([gids if i < 0 else outs[i] for i in idx]),
                    idx) for idx in rows.values()]
    if dev.type != "cuda":
        raise ValueError(f"no compact_slot kernel for {dev}")
    return _launch(counts, planes, torch.cuda.current_stream(dev).cuda_stream,
                   min(tiles_of(counts.numel()), _max_blocks(dev.index or 0)))


def compact_slot(
    counts: torch.Tensor, planes: list[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """Compact one slot: ``counts`` is its (G,) int32 row-count row,
    ``planes`` its rows of every component plane (G elements of 4 or 8
    bytes) → (the active count k as a (1,) int32 tensor on the device, the
    gids with the k active ones first in ascending order, each plane's
    values aligned to them).  On the card the buffers hold G entries, of
    which the first k are set; the plain version returns k."""
    n, groups = compact_slot_groups(counts, planes)
    return (n, *split_outputs(groups, len(planes)))
