// Stripe fold for Hopper (sm_90a): one launch a merge folds a packed host
// stripe into the window ring in place — the device half of the
// partial_merge strategy.
//
// Replaces denormalized_tpu/ops/segment_agg.py::merge_partials_body
// (:365-456, jitted as merge_partials at :316), a jax.jit program that runs
// k x (components) XLA scatters a merge; in torch that would be 20-30 small
// launches.  The host (ops/host_partial.py, native/partial_agg.cpp) has
// already reduced the rows to per-(slide unit u, sub-bucket s, group g)
// partials and packed them into one int32 matrix, row length a_pad + 2:
//   - compact layout: row 0 holds the flat cell indices ((u*SUB)+s)*G + g
//     (-1 = padding), the value planes follow from row 1;
//   - dense layout: no index row, cell i is flat index i, value planes from
//     row 0, padding cells hold fold-neutral values;
//   - both: u_base_rel (stripe unit 0 relative to first_open) and base_mod
//     (first_open % W) in row 0's two tail slots;
//   - value planes are f32 bitcasts: one per count/min/max component, two
//     per sum (hi, lo); the lean layout leaves out per-column counts, which
//     read the row-count plane instead.
// For each cell and each fan-out f < k, with w = u_base_rel + u - f, the
// cell feeds ring row (base_mod + w) % W, column g, if 0 <= w < W (a window
// outside the ring is dropped, never clamped) and not (SUB == 2 and
// f == k - 1 and s == 1): sub-bucket 1 misses the oldest window.  Counts go
// to the int32 rings as int32, sums add hi then lo (lo goes to the sumc
// plane in compensated mode), min and max fold NaN-safely.
//
// What bounds it on the card.  The bytes: the packed matrix read once plus
// every ring cell the stripe touches, each component read and written (8 B
// a component a cell).  At the emit_measurements shape the stripe is 5
// planes x 1,026 int32 (~20 KB) over ~10-20 live cells, a few hundred
// nanoseconds of bytes: the launch's fixed cost bounds it.  At 100K live
// keys it is ~3 planes x 2^18-2^19 cells plus ~10^5 touched cells x 3
// components, a few MB: there the bytes count.
//
// What the design does about it.
//   - One thread per stripe cell, one launch a merge: the k x (components)
//     scatters of the reference become one pass over the stripe, and the
//     plane pointers travel by value in a __grid_constant__ parameter
//     (OpTable), so a launch needs no device table and no copy.
//   - A cell whose row count is 0 (dense padding, empty cells of the span)
//     carries only fold identities and returns at once: at 10 live keys in
//     a 1,024-cell stripe ~99% of the threads do one load and leave.
//   - Collisions are real (SUB = 2 puts both sub-buckets of a unit in the
//     same window; with k > 1 neighbouring units share windows), so every
//     ring update is an atomic: int32 atomicAdd for counts (exact), f32
//     atomicAdd for sums, and min/max through the NaN-safe int-key folds of
//     ring_fold.cuh (no CAS loop).  Sums are therefore added in an order
//     that varies from run to run: counts, min and max are exact, sums
//     agree to rounding.
//   - No fast-math: the file builds with -O3 only.

#include <cstdint>
#include <cuda_runtime.h>

#include "ring_fold.cuh"

namespace {

constexpr int BLOCK_THREADS = 256;
constexpr int MAX_OPS = 64;

enum OpKind : int { OP_COUNT = 0, OP_SUM = 1, OP_MIN = 2, OP_MAX = 3 };

// One ring plane and the packed value plane that feeds it.
struct MergeOp {
  int kind;       // OpKind
  int src;        // value plane index (sum: hi; lo is the next plane)
  void* dst;      // ring plane: int* for counts, float* otherwise
  float* dst_lo;  // sum only: where lo goes (the sumc plane, or dst)
};

struct OpTable {
  MergeOp op[MAX_OPS];
};

__global__ void __launch_bounds__(BLOCK_THREADS) merge_partials_kernel(
    const int* __restrict__ packed,  // (rows, a_pad + 2) int32
    int a_pad, int dense, int SUB, int k, int W, int G, int n_ops,
    const __grid_constant__ OpTable table) {
  const int i = blockIdx.x * BLOCK_THREADS + threadIdx.x;
  if (i >= a_pad) return;
  const size_t ld = static_cast<size_t>(a_pad) + 2;
  const int* planes = packed + (dense ? 0 : ld);  // value plane p at row p
  // plane 0 is the row count (the wrapper checks it): an empty cell holds
  // only fold identities
  if (planes[i] == 0) return;  // +0.0f is all-zero bits
  int flat = i;
  if (!dense) {
    flat = packed[i];
    if (flat < 0) return;  // padding
  }
  const int u_base_rel = packed[a_pad];
  const int base_mod = packed[a_pad + 1];
  const int g = flat % G;
  const int us = flat / G;
  const int s = us % SUB;
  const int u = us / SUB;
  // fan-outs whose window may take the cell: sub-bucket 1 misses the oldest
  const int k_cell = (SUB == 2 && s != 0) ? k - 1 : k;
  for (int j = 0; j < n_ops; ++j) {
    const MergeOp op = table.op[j];
    const float x = __int_as_float(planes[op.src * ld + i]);
    const float lo =
        op.kind == OP_SUM ? __int_as_float(planes[(op.src + 1) * ld + i]) : 0.f;
    const int key = op.kind == OP_MIN   ? ring_fold::min_key(x)
                    : op.kind == OP_MAX ? ring_fold::max_key(x)
                                        : 0;
    for (int f = 0; f < k_cell; ++f) {
      const long long w = static_cast<long long>(u_base_rel) + u - f;
      if (w < 0 || w >= W) continue;
      const size_t o =
          static_cast<size_t>((base_mod + static_cast<int>(w)) % W) * G + g;
      switch (op.kind) {
        case OP_COUNT:
          atomicAdd(static_cast<int*>(op.dst) + o, static_cast<int>(x));
          break;
        case OP_SUM:
          atomicAdd(static_cast<float*>(op.dst) + o, x);
          atomicAdd(op.dst_lo + o, lo);
          break;
        case OP_MIN:
          ring_fold::fold_min(static_cast<float*>(op.dst) + o, key);
          break;
        default:
          ring_fold::fold_max(static_cast<float*>(op.dst) + o, key);
          break;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on ``stream`` (a cudaStream_t passed as a pointer).  ``ops`` is a
// HOST array of n_ops MergeOp (device pointers), copied into the kernel's
// parameters.  Allocates nothing; returns cudaGetLastError() after the
// launch (0 = success), so a refused launch reaches the caller.
int merge_partials_launch(const int* packed, int a_pad, int dense, int SUB,
                          int k, int W, int G, int n_ops, const void* ops,
                          void* stream) {
  if (n_ops < 1 || n_ops > MAX_OPS || a_pad < 1 || SUB < 1 || SUB > 2 ||
      k < 1 || W < 1 || G < 1) {
    return (int)cudaErrorInvalidValue;
  }
  OpTable table{};
  for (int j = 0; j < n_ops; ++j) {
    table.op[j] = static_cast<const MergeOp*>(ops)[j];
  }
  const int blocks = (a_pad + BLOCK_THREADS - 1) / BLOCK_THREADS;
  merge_partials_kernel<<<blocks, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
      packed, a_pad, dense, SUB, k, W, G, n_ops, table);
  return (int)cudaGetLastError();
}

const char* merge_partials_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
