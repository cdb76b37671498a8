"""The stripe fold of the ``partial_merge`` strategy — the wrapper of the
hand-written CUDA kernels ``csrc/merge_partials.cu``.

:func:`merge_partials` folds one packed host stripe
(``ops/host_partial.py::HostPartialStripe.take_packed``) into the window
ring in place, in ONE launch a merge: the port of the JAX package's
``segment_agg.merge_partials_body``, group shift included.  The launch
takes one of three kernels by the stripe's shape (:func:`merge_branch`),
instantiated for the ring's type: float32 rings, or float64 ones
(``EngineConfig.accum_dtype=torch.float64``).  On a CUDA tensor it launches the kernel or raises; it takes its plain
version (:func:`denormalized_tpu_torch.ops.segment_agg.
merge_partials_reference`) only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import torch

from denormalized_tpu_torch.ops import segment_agg as sa

# the kernel's by-value table of ring planes (MAX_OPS in the source)
MAX_OPS = 64
_OP_KIND = {"count": 0, "sum": 1, "min": 2, "max": 3}
# the source's Mode: the kernel a stripe takes
BRANCHES = {"tumbling": 0, "gather": 1, "scatter": 2}
# launch tables kept per (spec, lean, ring planes); more are dropped
_TABLE_CACHE_SIZE = 64

#: launches of the CUDA kernel (incremented where it launches, and nowhere
#: else — the CPU reference does not count)
merge_partials_launches = 0
_COUNT_LOCK = threading.Lock()
_TABLES: dict[tuple, tuple] = {}
# the source's entry point for each ring type
_LAUNCH = {torch.float32: "merge_partials_launch",
           torch.float64: "merge_partials_launch_f64"}
_TABLES_LOCK = threading.Lock()


class _MergeOp(ctypes.Structure):
    """``MergeOp`` of the source: kind, value plane, ring plane(s)."""

    _fields_ = [
        ("kind", ctypes.c_int),
        ("src", ctypes.c_int),
        ("dst", ctypes.c_void_p),
        ("dst_lo", ctypes.c_void_p),
    ]


def merge_ops(spec: sa.WindowKernelSpec, lean: bool):
    """The fold steps of a packed stripe, in plane order → [(component,
    value plane index)]: a sum reads its hi at the index and its lo at the
    next; under ``lean`` a per-column count reads the row-count plane 0."""
    ops, pi = [], 0
    for comp in spec.components:
        if comp.kind == "sumc":
            continue
        if lean and sa.lean_skippable(comp):
            ops.append((comp, 0))
            continue
        ops.append((comp, pi))
        pi += 2 if comp.kind == "sum" else 1
    return ops, pi


def merge_branch(spec: sa.WindowKernelSpec, dense: bool) -> str:
    """The kernel a stripe takes: ``tumbling`` where a cell feeds one
    window (k = 1: distinct cells land in distinct ring cells, no
    atomics), ``gather`` for a dense stripe with fan-out (a thread a ring
    cell, no atomics), ``scatter`` for a compact one (atomics)."""
    if spec.length_units == 1:
        return "tumbling"
    return "gather" if dense else "scatter"


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from denormalized_tpu_torch.ops.cuda_build import load

    lib = load("merge_partials")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.merge_partials_launch, lib.merge_partials_launch_f64):
        fn.argtypes = [p] + [i] * 10 + [p, p]
        fn.restype = i
    lib.merge_partials_error_string.argtypes = [i]
    lib.merge_partials_error_string.restype = ctypes.c_char_p
    return lib


def _check_packed(spec, SUB, a_pad, lean, dense, packed) -> None:
    """dtype, shape and contiguity of the packed stripe."""
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise TypeError(
            f"packed must be a 2-D int32 tensor, got {packed.dtype} "
            f"{tuple(packed.shape)}"
        )
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if a_pad < 1 or packed.shape[1] != a_pad + 2:
        raise ValueError(
            f"packed {tuple(packed.shape)} does not hold a_pad={a_pad} cells"
        )
    if SUB != (1 if spec.length_ms % spec.slide_ms == 0 else 2):
        raise ValueError(f"SUB={SUB} does not match L={spec.length_ms}, "
                         f"S={spec.slide_ms}")
    if spec.components[0] != sa.ROW_COUNT:
        raise ValueError("the row count must be the first component")
    ops, n_planes = merge_ops(spec, lean)
    if packed.shape[0] != n_planes + (0 if dense else 1):
        raise ValueError(
            f"packed has {packed.shape[0]} rows for {n_planes} value planes "
            f"({'dense' if dense else 'compact'} layout)"
        )
    if len(ops) > MAX_OPS:
        raise ValueError(f"{len(ops)} ring planes exceed the kernel's {MAX_OPS}")


def _check_ring(spec, state, device) -> None:
    """Each ring plane: a contiguous (W, G) of the spec's type on
    ``device``."""
    W, G = spec.window_slots, spec.group_capacity
    for comp in spec.components:
        buf = state[comp.label]
        if buf.device != device or buf.dtype != spec.init_dtype(comp):
            raise ValueError(
                f"ring plane {comp.label} is {buf.dtype} on {buf.device}"
            )
        if buf.shape != (W, G) or not buf.is_contiguous():
            raise ValueError(
                f"ring plane {comp.label} must be a contiguous {(W, G)}"
            )


def _check_shift(spec, G_total: int, g_shift: int) -> None:
    if G_total < 1 or g_shift < 0:
        raise ValueError(f"G_total={G_total}, g_shift={g_shift}: need "
                         "G_total >= 1 and g_shift >= 0")
    if max(G_total, g_shift + spec.group_capacity) >= 2**31:
        raise ValueError(f"G_total={G_total} exceeds the kernel's int32 "
                         "group ids")


def _launch_table(spec, lean, state, device):
    """The kernel's table of ring planes for this ring, validated once and
    kept per (spec, lean, ring plane pointers).  The entry holds weak
    references to the planes it was built from and is used only while the
    ring still holds those same tensors: a ring regrown, restored or
    imported gets a new table."""
    planes = tuple(state[c.label] for c in spec.components)
    key = (spec, lean, device, tuple(t.data_ptr() for t in planes))
    with _TABLES_LOCK:
        hit = _TABLES.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[2], planes)):
        return hit[0], hit[1]
    if spec.accum_dtype not in _LAUNCH:
        raise ValueError(
            f"the merge kernel folds float32 or float64 rings, not "
            f"{spec.accum_dtype}"
        )
    _check_ring(spec, state, device)
    ops, _ = merge_ops(spec, lean)
    table = (_MergeOp * len(ops))()
    for j, (comp, src) in enumerate(ops):
        dst = state[comp.label].data_ptr()
        lo = dst
        if comp.kind == "sum" and spec.compensated:
            lo = state[sa.AggComponent("sumc", comp.col).label].data_ptr()
        table[j] = _MergeOp(_OP_KIND[comp.kind], src, dst,
                            lo if comp.kind == "sum" else None)
    with _TABLES_LOCK:
        if len(_TABLES) >= _TABLE_CACHE_SIZE:
            _TABLES.clear()
        _TABLES[key] = (table, len(ops), tuple(map(weakref.ref, planes)))
    return table, len(ops)


def _launch(spec, SUB, a_pad, lean, dense, state, packed, G_total,
            g_shift) -> None:
    """Launch the stripe's kernel on the current stream: the ring
    ``state`` gains the stripe in place."""
    global merge_partials_launches
    table, n_ops = _launch_table(spec, lean, state, packed.device)
    rc = getattr(_lib(), _LAUNCH[spec.accum_dtype])(
        packed.data_ptr(), BRANCHES[merge_branch(spec, dense)], a_pad,
        int(dense), SUB, spec.length_units, spec.window_slots,
        spec.group_capacity, G_total, g_shift, n_ops, table,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    if rc != 0:
        msg = _lib().merge_partials_error_string(rc).decode()
        raise RuntimeError(f"merge kernel launch failed: {msg} (code {rc})")
    with _COUNT_LOCK:  # two window operators launch from two threads
        merge_partials_launches += 1


def merge_partials(
    spec: sa.WindowKernelSpec,
    SUB: int,
    a_pad: int,
    lean: bool,
    dense: bool,
    state: dict[str, torch.Tensor],
    packed: torch.Tensor,  # int32, (P+1, a_pad+2) compact / (P, a_pad+2) dense
    G_total: int | None = None,
    g_shift: int = 0,
) -> dict[str, torch.Tensor]:
    """Fold the packed stripe into the ring ``state`` in place (see
    :func:`segment_agg.merge_partials_reference` for what it computes).
    The ring holds groups ``[g_shift, g_shift + G)`` of a ``G_total``-wide
    stripe (default: the whole ring, ``G_total = G``, ``g_shift = 0``)."""
    G_total = spec.group_capacity if G_total is None else int(G_total)
    _check_packed(spec, SUB, a_pad, lean, dense, packed)
    _check_shift(spec, G_total, g_shift)
    if packed.device.type == "cpu":
        _check_ring(spec, state, packed.device)
        return sa.merge_partials_reference(
            spec, SUB, a_pad, lean, dense, state, packed, G_total, g_shift
        )
    if packed.device.type != "cuda":
        raise ValueError(f"no merge kernel for {packed.device}")
    _launch(spec, SUB, a_pad, lean, dense, state, packed, G_total, g_shift)
    return state
