"""Dense low-cardinality window update — counterpart of
``denormalized_tpu/ops/pallas_window.py``.

The default device step (``segment_agg.update_state``) scatters rows into
the ``(W, G)`` ring.  For LOW-cardinality aggregation (the emit_measurements
shape: ≤ 2048 groups) a batch touching at most ``K_ACTIVE`` ring slots takes
the dense path instead:

- :func:`dense_update` is the wrapper of the hand-written CUDA kernel
  ``csrc/dense_window.cu`` (the port of the Pallas ``_kernel`` together with
  the relative-slot build and ``_merge_partials`` around it): ONE launch
  reads the raw batch and updates the ring in place, the whole sliding
  fan-out included.  On a CUDA tensor it launches the kernel or raises; it
  takes its plain version :func:`dense_update_reference` only for tensors
  on the CPU.
- :func:`dense_update_reference` composes the relative-slot build,
  :func:`dense_partials_reference` (the per-slot partials, as the Pallas
  kernel computes them) and :func:`merge_partials` (the ring fold).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from denormalized_tpu_torch.ops import segment_agg as sa

# dense-path limits: G beyond this, or batches spanning more ring slots than
# K_ACTIVE, take the scatter path — the JAX package's limits, kept so both
# packages dispatch the same batches
MAX_DENSE_GROUPS = 2048
K_ACTIVE = 8
TILE = 256
# value columns the kernel's by-value plane table holds (MAX_COLUMNS in the
# source); the JAX package has no such limit, so only a query aggregating
# more columns than this dispatches differently (to the scatter path)
MAX_DENSE_COLUMNS = 64

# kernel geometry: 256 threads a block (BLOCK_THREADS in the source), and a
# group tile whose shared-memory planes fit 64 KiB, so several blocks share
# one SM's 227 KB
BLOCK_THREADS = 256
SMEM_BUDGET_BYTES = 64 * 1024

# field of each per-value-column component in the kernel's ColumnPlanes
_PLANE_COLUMN = {"count": 0, "sum": 1, "min": 2, "max": 3}

#: launches of the CUDA kernel (incremented where it launches, and nowhere
#: else — the CPU reference does not count)
dense_window_launches = 0


def dense_supported(spec: sa.WindowKernelSpec) -> bool:
    """Whether the spec fits the dense path.  G ≤ 2048,
    length_units ≤ K_ACTIVE = 8, at most MAX_DENSE_COLUMNS value columns,
    f32 accumulators, no compensated sums.  On the card the kernel tiles
    groups so any G within that limit fits shared memory: one tile's planes
    take ``4·K_ACTIVE·(1 + 4V)`` bytes a group (160 B at V=1), and a tile
    holds at most ``SMEM_BUDGET_BYTES`` of them."""
    return (
        spec.group_capacity <= MAX_DENSE_GROUPS
        and spec.length_units <= K_ACTIVE
        and spec.num_value_cols <= MAX_DENSE_COLUMNS
        and spec.accum_dtype == torch.float32
        and not spec.compensated
    )


def group_tile(G: int, V: int) -> int:
    """Groups one block holds in shared memory."""
    per_group = 4 * K_ACTIVE * (1 + 4 * V)
    return max(1, min(G, SMEM_BUDGET_BYTES // per_group))


# -- the CUDA kernel -------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared once."""
    from denormalized_tpu_torch.ops.cuda_build import load

    lib = load("dense_window")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_window_update.argtypes = [p] * 6 + [i] * 11 + [p] * 3
    lib.dense_window_update.restype = i
    lib.dense_window_prepare.argtypes = [i, i, ctypes.POINTER(i),
                                         ctypes.POINTER(i)]
    lib.dense_window_prepare.restype = i
    lib.dense_window_error_string.argtypes = [i]
    lib.dense_window_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().dense_window_error_string(rc).decode()
        raise RuntimeError(f"dense window kernel {what} failed: {msg} (code {rc})")


@functools.cache
def _resident_blocks(device_index: int, V: int, g_tile: int) -> int:
    """Blocks the whole card holds at once for this shared-memory size (SM
    count × the occupancy the compiled kernel allows), after allowing the
    kernel that much dynamic shared memory — once per (device, size)."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _lib().dense_window_prepare(V, g_tile, ctypes.byref(per_sm),
                                         ctypes.byref(sms))
    _raise_on(rc, "set-up")
    if per_sm.value < 1:
        raise RuntimeError(
            f"dense window kernel cannot be resident with V={V}, "
            f"g_tile={g_tile}"
        )
    return per_sm.value * sms.value


def _check_inputs(spec, state, values, colvalid, win_rel, rem, gid, row_valid):
    """dtype, device, shape and contiguity — attribute reads only, no
    tensor reductions."""
    dev = values.device
    if values.dim() != 2:
        raise ValueError(f"values must be (B, V), got {tuple(values.shape)}")
    B, V = values.shape
    if not 1 <= V <= MAX_DENSE_COLUMNS:
        raise ValueError(f"V={V} outside [1, {MAX_DENSE_COLUMNS}]")
    for name, t, dt, shape in (
        ("values", values, torch.float32, (B, V)),
        ("colvalid", colvalid, torch.bool, (B, V)),
        ("win_rel", win_rel, torch.int32, (B,)),
        ("rem", rem, torch.int32, (B,)),
        ("gid", gid, torch.int32, (B,)),
        ("row_valid", row_valid, torch.bool, (B,)),
    ):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, values on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(
                f"{name} {tuple(t.shape)} must be {shape} for B={B}, V={V}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    W, G = spec.window_slots, spec.group_capacity
    if not 1 <= G <= MAX_DENSE_GROUPS:
        raise ValueError(f"G={G} outside [1, {MAX_DENSE_GROUPS}]")
    if spec.length_units > K_ACTIVE:
        raise ValueError(f"length_units={spec.length_units} > {K_ACTIVE}")
    for comp in spec.components:
        buf = state[comp.label]
        if comp.col is not None and comp.col >= V:
            raise ValueError(f"{comp.label}: no value column {comp.col}")
        if buf.device != dev or buf.dtype != spec.init_dtype(comp):
            raise ValueError(
                f"ring plane {comp.label} is {buf.dtype} on {buf.device}"
            )
        if buf.shape != (W, G) or not buf.is_contiguous():
            raise ValueError(
                f"ring plane {comp.label} must be a contiguous {(W, G)}"
            )


def _launch(spec, state, values, colvalid, win_rel, rem, gid, row_valid,
            base_mod: int, min_win_rel: int):
    """Launch the kernel on the current stream: the ring ``state`` gains the
    batch in place.  Row blocks per group tile: the tiles' share of the
    blocks the card holds at once, at most one row a thread (grid-stride
    beyond that)."""
    global dense_window_launches
    B, V = values.shape
    W, G = spec.window_slots, spec.group_capacity
    dev = values.device
    g_tile = group_tile(G, V)
    resident = _resident_blocks(dev.index, V, g_tile)
    tiles = -(-G // g_tile)
    blocks_x = max(1, min(-(-B // BLOCK_THREADS), resident // tiles))
    rowcnt = 0
    # host array of V ColumnPlanes (count, sum, min, max; 0 = absent), which
    # the launcher copies into the kernel's parameters
    table = (ctypes.c_void_p * (4 * V))()
    for comp in spec.components:
        ptr = state[comp.label].data_ptr()
        if comp.col is None:
            rowcnt = ptr
        else:
            table[4 * comp.col + _PLANE_COLUMN[comp.kind]] = ptr
    rc = _lib().dense_window_update(
        values.data_ptr(), colvalid.data_ptr(), win_rel.data_ptr(),
        rem.data_ptr(), gid.data_ptr(), row_valid.data_ptr(),
        B, V, spec.length_units, spec.length_ms, spec.slide_ms, W, G,
        g_tile, min_win_rel, (base_mod + min_win_rel) % W, blocks_x,
        rowcnt, table,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "launch")
    dense_window_launches += 1


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
    """Dense-path equivalent of ``segment_agg.update_state``, updating the
    ring ``state`` in place.

    ``min_win_rel`` is the smallest window index (relative to first_open)
    any row of this batch touches; slots are taken relative to it so
    K_ACTIVE covers the batch's span.  The caller guarantees the span fits
    (else it uses the scatter path)."""
    _check_inputs(spec, state, values, colvalid, win_rel, rem, gid, row_valid)
    if values.device.type == "cpu":
        return dense_update_reference(
            spec, state, values, colvalid, win_rel, rem, gid, row_valid,
            base_mod, min_win_rel=min_win_rel,
        )
    if values.device.type != "cuda":
        raise ValueError(f"no dense window kernel for {values.device}")
    _launch(spec, state, values, colvalid, win_rel, rem, gid, row_valid,
            int(base_mod), int(min_win_rel))
    return state


# -- the plain version -----------------------------------------------------


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


def dense_partials_reference(values, colvalid, rel, gid, G: int):
    """Per-slot partials of a batch, as the JAX package's
    ``_dense_partials`` computes them: → (rowcnt (K, G), cnt (K, V, G), sum,
    min, max), all f32, for the ``K = K_ACTIVE`` slots relative to the
    batch's base.  ``colvalid`` is f32 (1.0 = valid), ``rel`` the (B, KREL)
    relative slots (-1 = dropped).  Plain PyTorch (any device):
    ``index_add_`` and ``scatter_reduce_``.  A valid NaN makes its min/max
    cell NaN, as in the TPU kernel."""
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
            # f32 counts of the partials → the ring's int32 counts
            buf.index_add_(0, rows, upd[:n].to(buf.dtype))
        elif comp.kind == "sum":
            buf.index_add_(0, rows, ssum[:n, comp.col, :].to(buf.dtype))
        elif comp.kind == "min":
            buf[rows] = torch.minimum(buf[rows], smin[:n, comp.col, :])
        else:
            buf[rows] = torch.maximum(buf[rows], smax[:n, comp.col, :])
    return state


def dense_update_reference(
    spec: sa.WindowKernelSpec,
    state: dict[str, torch.Tensor],
    values: torch.Tensor,
    colvalid: torch.Tensor,
    win_rel: torch.Tensor,
    rem: torch.Tensor,
    gid: torch.Tensor,
    row_valid: torch.Tensor,
    base_mod: int,
    *,
    min_win_rel: int,
) -> dict[str, torch.Tensor]:
    """Plain PyTorch version of :func:`dense_update` (any device): the
    ``(B, k)`` relative-slot matrix — the sliding fan-out — then the
    per-slot partials and their fold into the ring, in place."""
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
    partials = dense_partials_reference(
        values.to(torch.float32).contiguous(),
        colvalid.to(torch.float32).contiguous(),
        rel,
        gid.to(torch.int32).contiguous(),
        spec.group_capacity,
    )
    return merge_partials(spec, state, partials, (base_mod + min_win_rel) % W)
