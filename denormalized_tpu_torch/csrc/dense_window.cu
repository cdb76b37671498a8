// Dense low-cardinality window update for Hopper (sm_90a).
//
// Replaces denormalized_tpu/ops/pallas_window.py::_kernel (launched by
// _dense_partials through pl.pallas_call).  For each row r and each of its
// KREL relative window slots j = rel[r, c] with 0 <= j < K_ACTIVE, and the
// row's group g = gid[r] in [0, G), it accumulates
//   rowcnt[j, g]    += 1
//   cnt[j, v, g]    += colvalid[r, v]
//   sum[j, v, g]    += values[r, v]              where colvalid[r, v] > 0
//   min/max[j, v, g] <- min/max(., values[r, v])  where colvalid[r, v] > 0
// into float32 outputs laid out (K_ACTIVE, V, G) and (K_ACTIVE, G), which
// the caller fills with 0 / +inf / -inf before the launch.  Invalid lanes
// are skipped by a branch (select, never multiply), so a NaN behind a null
// mask cannot reach a sum.  A VALID NaN propagates through min and max, as
// jnp.minimum / jnp.min do in the TPU kernel.  The rel columns of one row
// name distinct slots (the windows a row fans out to are distinct), as the
// TPU kernel also assumes.
//
// What bounds it on the card: the kernel reads B*(8V + 4*KREL + 4) bytes
// (values and colvalid f32, rel and gid int32) once and writes
// K_ACTIVE*G*(1 + 4V)*4 bytes, so it is memory-bound in principle; at the
// low cardinalities it serves (the main path has 10 live groups) the real
// limit is atomic contention on the few hot (slot, group) cells.
//
// Design.  The TPU kernel is a sequential grid carrying a VMEM accumulator
// from tile to tile through one-hot matrix products.  Blocks here run in
// parallel with nothing carried between them:
//   - one thread per row, in a grid-stride loop over B;
//   - each block keeps private (K_ACTIVE, g_tile) partials of rowcnt and of
//     cnt/sum/min/max per value column in dynamic shared memory, and
//     updates them with shared-memory atomics (atomicAdd for counts and
//     sums, a NaN-propagating float min/max built on atomicCAS);
//   - at the end the block folds the cells it touched (rowcnt > 0) into
//     the global outputs with global atomics — untouched cells hold the
//     fold identities and are skipped;
//   - groups are tiled over blockIdx.y so the five planes of a tile fit in
//     shared memory: at G = 2048, V = 1 they need 320 KiB, beyond the
//     227 KB a block may use.  A block skips rows outside its group tile.
//     This keeps the JAX package's limits (G <= 2048, KREL <= 8) and so the
//     same per-batch dense/scatter dispatch.
// Float atomics make the order of the f32 sums vary from run to run:
// counts, min and max are exact, sums agree to rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int K_ACTIVE = 8;

// min(cur, v) with NaN propagation: once a cell holds NaN it stays NaN,
// and a NaN operand makes it NaN.  fminf and the signed-int ordering trick
// both drop NaN, which the TPU kernel's jnp.minimum does not.
__device__ __forceinline__ void atomic_min_nan(float* addr, float v) {
  int* ai = reinterpret_cast<int*>(addr);
  int old = *ai;
  while (true) {
    const float cur = __int_as_float(old);
    if (cur != cur) return;                     // already NaN
    const float nv = (v != v) ? v : fminf(cur, v);
    if (__float_as_int(nv) == old) return;      // nothing to change
    const int seen = atomicCAS(ai, old, __float_as_int(nv));
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_max_nan(float* addr, float v) {
  int* ai = reinterpret_cast<int*>(addr);
  int old = *ai;
  while (true) {
    const float cur = __int_as_float(old);
    if (cur != cur) return;
    const float nv = (v != v) ? v : fmaxf(cur, v);
    if (__float_as_int(nv) == old) return;
    const int seen = atomicCAS(ai, old, __float_as_int(nv));
    if (seen == old) return;
    old = seen;
  }
}

__global__ void dense_window_kernel(
    const float* __restrict__ values,    // (B, V)
    const float* __restrict__ colvalid,  // (B, V), 1.0 = valid
    const int* __restrict__ rel,         // (B, KREL), -1 = dropped
    const int* __restrict__ gid,         // (B,)
    int B, int V, int KREL, int G, int g_tile,
    float* __restrict__ cnt,             // (K_ACTIVE, V, G)
    float* __restrict__ sum,             // (K_ACTIVE, V, G)
    float* __restrict__ mn,              // (K_ACTIVE, V, G)
    float* __restrict__ mx,              // (K_ACTIVE, V, G)
    float* __restrict__ rowcnt) {        // (K_ACTIVE, G)
  extern __shared__ float smem[];
  const int g0 = blockIdx.y * g_tile;
  const int gt = min(g_tile, G - g0);
  const int plane = K_ACTIVE * gt;  // one (slot, group) plane of the tile
  // shared layout: rowcnt[j][g], then cnt/sum/min/max as [v][j][g]
  float* s_row = smem;
  float* s_cnt = s_row + plane;
  float* s_sum = s_cnt + V * plane;
  float* s_min = s_sum + V * plane;
  float* s_max = s_min + V * plane;

  for (int i = threadIdx.x; i < plane * (1 + 2 * V); i += blockDim.x) {
    smem[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < V * plane; i += blockDim.x) {
    s_min[i] = INFINITY;
    s_max[i] = -INFINITY;
  }
  __syncthreads();

  const int stride = gridDim.x * blockDim.x;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < B; r += stride) {
    const int g = gid[r] - g0;
    if (g < 0 || g >= gt) continue;  // another tile's group (or out of range)
    for (int c = 0; c < KREL; ++c) {
      const int j = rel[(size_t)r * KREL + c];
      if (j < 0 || j >= K_ACTIVE) continue;
      const int cell = j * gt + g;
      atomicAdd(&s_row[cell], 1.0f);
      for (int v = 0; v < V; ++v) {
        const float ok = colvalid[(size_t)r * V + v];
        const int vc = v * plane + cell;
        atomicAdd(&s_cnt[vc], ok);
        if (ok > 0.0f) {
          const float x = values[(size_t)r * V + v];
          atomicAdd(&s_sum[vc], x);
          atomic_min_nan(&s_min[vc], x);
          atomic_max_nan(&s_max[vc], x);
        }
      }
    }
  }
  __syncthreads();

  for (int cell = threadIdx.x; cell < plane; cell += blockDim.x) {
    const float rc = s_row[cell];
    if (rc == 0.0f) continue;  // untouched: every plane holds its identity
    const int j = cell / gt;
    const int g = g0 + cell % gt;
    atomicAdd(&rowcnt[(size_t)j * G + g], rc);
    for (int v = 0; v < V; ++v) {
      const int vc = v * plane + cell;
      const float c = s_cnt[vc];
      if (c == 0.0f) continue;  // no valid value: sum 0, min/max identities
      const size_t o = ((size_t)j * V + v) * G + g;
      atomicAdd(&cnt[o], c);
      atomicAdd(&sum[o], s_sum[vc]);
      atomic_min_nan(&mn[o], s_min[vc]);
      atomic_max_nan(&mx[o], s_max[vc]);
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the kernel uses.
int dense_window_smem_bytes(int V, int g_tile) {
  return (int)(sizeof(float) * K_ACTIVE * g_tile * (1 + 4 * V));
}

// Launch on ``stream`` (a cudaStream_t passed as a pointer).  Allocates
// nothing; returns cudaGetLastError() after the launch (0 = success), so a
// refused launch (too much shared memory, bad grid) is reported to the
// caller instead of silently never running.
int dense_window_partials(
    const float* values, const float* colvalid, const int* rel,
    const int* gid, int B, int V, int KREL, int G, int g_tile,
    int blocks_x, float* cnt, float* sum, float* mn, float* mx,
    float* rowcnt, void* stream) {
  const int smem = dense_window_smem_bytes(V, g_tile);
  cudaError_t err = cudaFuncSetAttribute(
      dense_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks_x, (G + g_tile - 1) / g_tile);
  dense_window_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      values, colvalid, rel, gid, B, V, KREL, G, g_tile, cnt, sum, mn, mx,
      rowcnt);
  return (int)cudaGetLastError();
}

const char* dense_window_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
