// Emission compaction for Hopper (sm_90a): the stable move of one ring
// slot's active cells to the front, for every component plane at once.
//
// Replaces denormalized_tpu/ops/segment_agg.py::_compact_slot (:623-642),
// the jax.jit program behind read_slot_compact (:645-679): a stable argsort
// of ~active over one (G,) row of the ring, then a gather of every
// component plane through the permutation.  Only the active prefix is
// needed on the host (read_slot_compact moves a power-of-two prefix of it),
// so this computes the prefix alone: a cell is active when its row count
// is > 0; the k active cells, in ascending gid, land at ranks 0..k-1 of
// the output gid buffer and of every output plane, and k lands in a device
// int.  Entries at ranks >= k are left as they were.
//
// What bounds it on the card: the bytes.  G x 4 B of the row-count plane,
// plus, for each active cell, its gid written (4 B) and its value in every
// plane read and written once (4 or 8 B each).  At config 3's emitted
// window (100K of 131,072 cells active, three planes) that is ~3 MB, about
// a microsecond at 3.35 TB/s; a launch's fixed cost is of that order, so
// the design keeps the launches to two and every access coalesced.
//
// The design.  A block takes ITEMS x 256 consecutive cells, as ITEMS
// chunks of 256 (chunk i, thread t: cell base + i*256 + t), so neighbouring
// threads touch neighbouring cells.
//   1. compact_slot_count_kernel: each block counts its active cells
//      (__syncthreads_count a chunk) into block_counts[b].
//   2. compact_slot_scatter_kernel: each block sums the counts of the
//      blocks before it (one warp, a strided pass and a shuffle reduction:
//      G / 1024 counts, 128 at G = 131,072), then, chunk by chunk, ranks
//      its active cells in order (a warp ballot and popcount for the rank
//      inside the warp, a shared-memory scan of the 8 warps' totals) and
//      writes each active cell's gid and its value in every plane at
//      offset + rank.  The last block writes k.  Planes travel by value in
//      a __grid_constant__ table (as in dense_window.cu), so one pass over
//      the cells serves every plane, 4-byte and 8-byte alike.
// A single pass with decoupled look-back would save the first launch; it
// is later work.  No atomics: the output is a copy, exact and the same
// from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_THREADS = 256;
constexpr int WARPS = BLOCK_THREADS / 32;
constexpr int ITEMS = 4;  // chunks of BLOCK_THREADS cells a block
constexpr int BLOCK_CELLS = ITEMS * BLOCK_THREADS;
constexpr int MAX_PLANES = 64;

// One component plane: the slot's row of the ring and the output buffer,
// both of G elements of ``bytes`` (4 or 8) each.
struct Plane {
  const void* src;
  void* dst;
  int bytes;
};

struct PlaneTable {
  Plane p[MAX_PLANES];
};

__global__ void __launch_bounds__(BLOCK_THREADS)
    compact_slot_count_kernel(const int* __restrict__ counts, int G,
                              int* __restrict__ block_counts) {
  const long long base = static_cast<long long>(blockIdx.x) * BLOCK_CELLS;
  int total = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long c = base + i * BLOCK_THREADS + threadIdx.x;
    const bool active = c < G && __ldg(counts + c) > 0;
    total += __syncthreads_count(active);
  }
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(BLOCK_THREADS) compact_slot_scatter_kernel(
    const int* __restrict__ counts, int G,
    const int* __restrict__ block_counts, int* __restrict__ gids_out,
    int* __restrict__ n_active, int n_planes,
    const __grid_constant__ PlaneTable table) {
  __shared__ int s_warp[WARPS];
  __shared__ int s_offset;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the active cells of every block before this one
  if (warp == 0) {
    int sum = 0;
    for (int b = lane; b < static_cast<int>(blockIdx.x); b += 32) {
      sum += __ldg(block_counts + b);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, d);
    if (lane == 0) s_offset = sum;
  }
  __syncthreads();
  int offset = s_offset;
  const long long base = static_cast<long long>(blockIdx.x) * BLOCK_CELLS;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int i = 0; i < ITEMS; ++i) {
    const long long c = base + i * BLOCK_THREADS + threadIdx.x;
    const bool active = c < G && __ldg(counts + c) > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, active);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    // exclusive scan of the warps' totals, by every thread (8 adds)
    int below = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int t = s_warp[w];
      below += w < warp ? t : 0;
      chunk += t;
    }
    if (active) {
      const int rank = offset + below + __popc(ballot & lanes_below);
      gids_out[rank] = static_cast<int>(c);
      for (int p = 0; p < n_planes; ++p) {
        const Plane& pl = table.p[p];
        if (pl.bytes == 8) {
          static_cast<long long*>(pl.dst)[rank] =
              __ldg(static_cast<const long long*>(pl.src) + c);
        } else {
          static_cast<int*>(pl.dst)[rank] =
              __ldg(static_cast<const int*>(pl.src) + c);
        }
      }
    }
    offset += chunk;
    __syncthreads();  // s_warp is rewritten by the next chunk
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *n_active = offset;
}

}  // namespace

extern "C" {

// Compact one slot of G cells on ``stream`` (a cudaStream_t passed as a
// pointer): ``counts`` is the slot's row-count plane (int32), ``planes`` a
// HOST array of n_planes Plane (device pointers, 4- or 8-byte elements),
// copied into the kernel's parameters; ``gids_out`` takes G int32,
// ``n_active`` one int32 and ``block_counts`` (scratch) one int32 per
// 1,024 cells.  Allocates nothing; returns cudaGetLastError() after the
// launches (0 = success), so a refused launch reaches the caller.
int compact_slot_launch(const int* counts, int G, int n_planes,
                        const void* planes, int* gids_out, int* n_active,
                        int* block_counts, void* stream) {
  if (G < 1 || n_planes < 0 || n_planes > MAX_PLANES) {
    return (int)cudaErrorInvalidValue;
  }
  PlaneTable table{};
  for (int p = 0; p < n_planes; ++p) {
    table.p[p] = static_cast<const Plane*>(planes)[p];
    if (table.p[p].bytes != 4 && table.p[p].bytes != 8) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (G + BLOCK_CELLS - 1) / BLOCK_CELLS;
  compact_slot_count_kernel<<<blocks, BLOCK_THREADS, 0, st>>>(counts, G,
                                                              block_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_slot_scatter_kernel<<<blocks, BLOCK_THREADS, 0, st>>>(
      counts, G, block_counts, gids_out, n_active, n_planes, table);
  return (int)cudaGetLastError();
}

const char* compact_slot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The number of 1,024-cell blocks (and block_counts entries) for G cells.
int compact_slot_blocks(int G) { return (G + BLOCK_CELLS - 1) / BLOCK_CELLS; }

}  // extern "C"
