"""Dense low-cardinality window update — counterpart of
``denormalized_tpu/ops/pallas_window.py``.

The default device step (``segment_agg.update_state``) scatters rows into
the ``(W, G)`` ring.  For LOW-cardinality aggregation (the emit_measurements
shape: ≤ 2048 groups) the batch first reduces into per-(slot, group)
partials for the ``K_ACTIVE`` ring slots it touches, and those fold into
the ring with one K-row update per component.

- :func:`dense_partials` is the wrapper of the hand-written CUDA kernel
  ``csrc/dense_window.cu`` (the port of the Pallas ``_kernel``).  On a CUDA
  tensor it launches the kernel or raises; it takes its plain version
  :func:`dense_partials_reference` only for tensors on the CPU.
- :func:`dense_update` builds the ``(B, k)`` relative-slot matrix — the
  whole sliding fan-out in ONE launch — and :func:`merge_partials` folds
  the partials into the ring in place.
"""

from __future__ import annotations

import ctypes

import torch

from denormalized_tpu_torch.ops import segment_agg as sa

# dense-path limits: G beyond this, or batches spanning more ring slots than
# K_ACTIVE, take the scatter path — the JAX package's limits, kept so both
# packages dispatch the same batches
MAX_DENSE_GROUPS = 2048
K_ACTIVE = 8
TILE = 256

# kernel geometry: 256 threads a block, at most 2 blocks a SM on 132 SMs in
# the row dimension (grid-stride beyond that), and a group tile whose five
# shared-memory planes fit 64 KiB (three blocks can share one SM's 227 KB)
BLOCK_THREADS = 256
MAX_BLOCKS_X = 264
SMEM_BUDGET_BYTES = 64 * 1024

#: launches of the CUDA kernel (incremented where it launches, and nowhere
#: else — the CPU reference does not count)
dense_window_launches = 0


def dense_supported(spec: sa.WindowKernelSpec) -> bool:
    """Whether the spec fits the dense path.  G ≤ 2048 and
    length_units ≤ K_ACTIVE = 8, f32 accumulators.  On the card the kernel
    tiles groups so any G within that limit fits shared memory: one tile's
    planes take ``4·K_ACTIVE·(1 + 4V)`` bytes a group (160 B at V=1), and a
    tile holds at most ``SMEM_BUDGET_BYTES`` of them."""
    return (
        spec.group_capacity <= MAX_DENSE_GROUPS
        and spec.length_units <= K_ACTIVE
        and spec.accum_dtype == torch.float32
    )


def group_tile(G: int, V: int) -> int:
    """Groups one block holds in shared memory."""
    per_group = 4 * K_ACTIVE * (1 + 4 * V)
    return max(1, min(G, SMEM_BUDGET_BYTES // per_group))


def _check_inputs(values, colvalid, rel, gid, G):
    dev = values.device
    for name, t, dt in (
        ("values", values, torch.float32),
        ("colvalid", colvalid, torch.float32),
        ("rel", rel, torch.int32),
        ("gid", gid, torch.int32),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, values on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if values.dim() != 2 or colvalid.shape != values.shape:
        raise ValueError(
            f"values {tuple(values.shape)} and colvalid "
            f"{tuple(colvalid.shape)} must both be (B, V)"
        )
    B = values.shape[0]
    if rel.dim() != 2 or rel.shape[0] != B or gid.shape != (B,):
        raise ValueError(
            f"rel {tuple(rel.shape)} must be (B, KREL) and gid "
            f"{tuple(gid.shape)} must be (B,) for B={B}"
        )
    if not 1 <= G <= MAX_DENSE_GROUPS:
        raise ValueError(f"G={G} outside [1, {MAX_DENSE_GROUPS}]")


def _outputs(K: int, V: int, G: int, device):
    """(rowcnt, cnt, sum, min, max) filled with the fold identities."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)  # noqa: E731
    return (
        z(K, G),
        z(K, V, G),
        z(K, V, G),
        torch.full((K, V, G), float("inf"), dtype=torch.float32, device=device),
        torch.full((K, V, G), float("-inf"), dtype=torch.float32, device=device),
    )


def dense_partials(
    values: torch.Tensor,  # (B, V) f32
    colvalid: torch.Tensor,  # (B, V) f32, 1.0 = valid
    rel: torch.Tensor,  # (B, KREL) int32 slot relative to base, -1 = dropped
    gid: torch.Tensor,  # (B,) int32
    G: int,
):
    """→ (rowcnt (K, G), cnt (K, V, G), sum, min, max), all f32, for the
    ``K = K_ACTIVE`` slots relative to the batch's base.  Same function as
    the JAX package's ``_dense_partials``."""
    _check_inputs(values, colvalid, rel, gid, G)
    if values.device.type == "cpu":
        return dense_partials_reference(values, colvalid, rel, gid, G)
    if values.device.type != "cuda":
        raise ValueError(f"no dense window kernel for {values.device}")
    global dense_window_launches
    from denormalized_tpu_torch.ops.cuda_build import load

    lib = load("dense_window")
    B, V = values.shape
    outs = _outputs(K_ACTIVE, V, G, values.device)
    rowcnt, cnt, ssum, smin, smax = outs
    blocks_x = max(1, min(-(-B // BLOCK_THREADS), MAX_BLOCKS_X))
    fn = lib.dense_window_partials
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + (
        [ctypes.c_void_p] * 6
    )
    rc = fn(
        values.data_ptr(), colvalid.data_ptr(), rel.data_ptr(),
        gid.data_ptr(), B, V, rel.shape[1], G, group_tile(G, V), blocks_x,
        cnt.data_ptr(), ssum.data_ptr(), smin.data_ptr(), smax.data_ptr(),
        rowcnt.data_ptr(),
        torch.cuda.current_stream(values.device).cuda_stream,
    )
    if rc != 0:
        lib.dense_window_error_string.restype = ctypes.c_char_p
        lib.dense_window_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(
            "dense window kernel launch failed: "
            f"{lib.dense_window_error_string(rc).decode()} (code {rc})"
        )
    dense_window_launches += 1
    return outs


def dense_partials_reference(values, colvalid, rel, gid, G: int):
    """Plain PyTorch version of :func:`dense_partials` (any device): the
    same partials from ``index_add_`` and ``scatter_reduce_``.  A valid NaN
    makes its min/max cell NaN, as in the kernel and the TPU kernel."""
    B, V = values.shape
    K = K_ACTIVE
    rowcnt, cnt, ssum, smin, smax = (
        t.view(-1) for t in _outputs(K, V, G, values.device)
    )
    nans = torch.zeros(K * V * G, dtype=torch.int32, device=values.device)
    g = gid.long()
    g_ok = (g >= 0) & (g < G)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=values.device)
    for c in range(rel.shape[1]):
        j = rel[:, c].long()
        rows = torch.nonzero(g_ok & (j >= 0) & (j < K)).squeeze(1)
        jj, gg = j[rows], g[rows]
        rowcnt.index_add_(0, jj * G + gg, torch.ones_like(jj, dtype=torch.float32))
        for v in range(V):
            cv = colvalid[rows, v]
            x = values[rows, v]
            sel = cv > 0
            idx = (jj * V + v) * G + gg
            cnt.index_add_(0, idx, cv)
            ssum.index_add_(0, idx, torch.where(sel, x, torch.zeros_like(x)))
            smin.scatter_reduce_(0, idx, torch.where(sel, x, inf), reduce="amin")
            smax.scatter_reduce_(0, idx, torch.where(sel, x, -inf), reduce="amax")
            nans.index_add_(0, idx, (sel & torch.isnan(x)).to(torch.int32))
    has_nan = nans > 0
    smin[has_nan] = float("nan")
    smax[has_nan] = float("nan")
    return (
        rowcnt.view(K, G),
        cnt.view(K, V, G),
        ssum.view(K, V, G),
        smin.view(K, V, G),
        smax.view(K, V, G),
    )


def merge_partials(
    spec: sa.WindowKernelSpec,
    state: dict[str, torch.Tensor],
    partials,
    base_mod: int,
) -> dict[str, torch.Tensor]:
    """Fold the (K, ...) dense partials into ring rows ``(base_mod + j) % W``
    in place — add for counts and sums, min and max for extrema."""
    rowcnt, cnt, ssum, smin, smax = partials
    W = spec.window_slots
    # partial rows j >= W are fold identities (every rel < W), so folding
    # min(K, W) rows keeps the ring rows distinct
    n = min(K_ACTIVE, W)
    rows = (
        base_mod + torch.arange(n, dtype=torch.long, device=rowcnt.device)
    ) % W
    for comp in spec.components:
        buf = state[comp.label]
        if comp.kind == "count":
            upd = rowcnt if comp.col is None else cnt[:, comp.col, :]
            # f32 counts of the kernel → the ring's int32 counts
            buf.index_add_(0, rows, upd[:n].to(buf.dtype))
        elif comp.kind == "sum":
            buf.index_add_(0, rows, ssum[:n, comp.col, :].to(buf.dtype))
        elif comp.kind == "min":
            buf[rows] = torch.minimum(buf[rows], smin[:n, comp.col, :])
        else:
            buf[rows] = torch.maximum(buf[rows], smax[:n, comp.col, :])
    return state


def dense_update(
    spec: sa.WindowKernelSpec,
    state: dict[str, torch.Tensor],
    values: torch.Tensor,  # (B, V) f32
    colvalid: torch.Tensor,  # (B, V) bool
    win_rel: torch.Tensor,  # (B,) int32
    rem: torch.Tensor,  # (B,) int32
    gid: torch.Tensor,  # (B,) int32
    row_valid: torch.Tensor,  # (B,) bool
    base_mod: int,
    *,
    min_win_rel: int,
) -> dict[str, torch.Tensor]:
    """Dense-path equivalent of ``segment_agg.update_state``: per-slot
    partials from the kernel, folded into the ring.

    ``min_win_rel`` is the smallest window index (relative to first_open)
    any row of this batch touches; the kernel works in ``rel - min_win_rel``
    space so K_ACTIVE covers the batch's span.  The caller guarantees the
    span fits (else it uses the scatter path)."""
    k = spec.length_units
    W = spec.window_slots
    rel_cols = []
    for i in range(k):
        wr = win_rel - i
        ok = row_valid & (wr >= 0) & (wr < W)
        if spec.length_ms - i * spec.slide_ms < spec.slide_ms:
            # the i-th window covers only the first L - i·S ms of the row's
            # slide unit
            ok = ok & (rem < spec.length_ms - i * spec.slide_ms)
        rel_cols.append(
            torch.where(ok, wr - min_win_rel, torch.full_like(wr, -1))
        )
    rel = torch.stack(rel_cols, dim=1).to(torch.int32).contiguous()  # (B, k)
    partials = dense_partials(
        values.to(torch.float32).contiguous(),
        colvalid.to(torch.float32).contiguous(),
        rel,
        gid.to(torch.int32).contiguous(),
        spec.group_capacity,
    )
    return merge_partials(spec, state, partials, (base_mod + min_win_rel) % W)
