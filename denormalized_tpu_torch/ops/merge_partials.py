"""The stripe fold of the ``partial_merge`` strategy — the wrapper of the
hand-written CUDA kernel ``csrc/merge_partials.cu``.

:func:`merge_partials` folds one packed host stripe
(``ops/host_partial.py::HostPartialStripe.take_packed``) into the window
ring in place, in ONE launch a merge: the port of the JAX package's
``segment_agg.merge_partials_body``.  On a CUDA tensor it launches the
kernel or raises; it takes its plain version
(:func:`denormalized_tpu_torch.ops.segment_agg.merge_partials_reference`)
only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from denormalized_tpu_torch.ops import segment_agg as sa

# the kernel's by-value table of ring planes (MAX_OPS in the source)
MAX_OPS = 64
BLOCK_THREADS = 256
_OP_KIND = {"count": 0, "sum": 1, "min": 2, "max": 3}

#: launches of the CUDA kernel (incremented where it launches, and nowhere
#: else — the CPU reference does not count)
merge_partials_launches = 0
_COUNT_LOCK = threading.Lock()


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


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from denormalized_tpu_torch.ops.cuda_build import load

    lib = load("merge_partials")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.merge_partials_launch.argtypes = [p] + [i] * 7 + [p, p]
    lib.merge_partials_launch.restype = i
    lib.merge_partials_error_string.argtypes = [i]
    lib.merge_partials_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(spec, SUB, a_pad, lean, dense, state, packed) -> int:
    """dtype, device, shape and contiguity → the number of value planes."""
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
    W, G = spec.window_slots, spec.group_capacity
    for comp in spec.components:
        buf = state[comp.label]
        if buf.device != packed.device or buf.dtype != spec.init_dtype(comp):
            raise ValueError(
                f"ring plane {comp.label} is {buf.dtype} on {buf.device}"
            )
        if buf.shape != (W, G) or not buf.is_contiguous():
            raise ValueError(
                f"ring plane {comp.label} must be a contiguous {(W, G)}"
            )
    return n_planes


def _launch(spec, SUB, a_pad, dense, state, packed, lean) -> None:
    """Launch the kernel on the current stream: the ring ``state`` gains
    the stripe in place."""
    global merge_partials_launches
    if spec.accum_dtype != torch.float32:
        raise ValueError(
            f"the merge kernel folds float32 rings, not {spec.accum_dtype}"
        )
    ops, _ = merge_ops(spec, lean)
    table = (_MergeOp * len(ops))()
    for j, (comp, src) in enumerate(ops):
        dst = state[comp.label].data_ptr()
        lo = dst
        if comp.kind == "sum" and spec.compensated:
            lo = state[sa.AggComponent("sumc", comp.col).label].data_ptr()
        table[j] = _MergeOp(_OP_KIND[comp.kind], src, dst,
                            lo if comp.kind == "sum" else None)
    rc = _lib().merge_partials_launch(
        packed.data_ptr(), a_pad, int(dense), SUB, spec.length_units,
        spec.window_slots, spec.group_capacity, len(ops), table,
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
) -> dict[str, torch.Tensor]:
    """Fold the packed stripe into the ring ``state`` in place (see
    :func:`segment_agg.merge_partials_reference` for what it computes)."""
    _check_inputs(spec, SUB, a_pad, lean, dense, state, packed)
    if packed.device.type == "cpu":
        return sa.merge_partials_reference(
            spec, SUB, a_pad, lean, dense, state, packed
        )
    if packed.device.type != "cuda":
        raise ValueError(f"no merge kernel for {packed.device}")
    _launch(spec, SUB, a_pad, dense, state, packed, lean)
    return state
