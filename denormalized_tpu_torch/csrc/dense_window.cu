// Dense low-cardinality window update for Hopper (sm_90a): one launch per
// batch that reads the raw batch and updates the ring in place.
//
// Replaces denormalized_tpu/ops/pallas_window.py::_kernel (:42, launched by
// _dense_partials through pl.pallas_call) and also absorbs the two JAX
// steps around it: the (B, k) relative-slot build of dense_update (:230-237)
// and the ring fold _merge_partials (:176).  For each row r, each fan-out
// i < k and each value column v it applies, with
//   wr = win_rel[r] - i,  j = wr - min_win_rel,  g = gid[r],
// the row only if row_valid[r], 0 <= wr < W, rem[r] < L - i*S where
// L - i*S < S, 0 <= j < K_ACTIVE and 0 <= g < G:
//   ring rowcnt[s, g]  += 1
//   ring cnt_v[s, g]   += colvalid[r, v]
//   ring sum_v[s, g]   += values[r, v]               where colvalid[r, v]
//   ring min/max_v[s, g] <- min/max(., values[r, v])  where colvalid[r, v]
// at ring row s = (base_mod + min_win_rel + j) mod W.  Counts are int32 in
// the ring's int32 planes, sums/min/max float32.  Invalid lanes are skipped
// by a branch (select, never multiply), so a NaN behind a null mask cannot
// reach a sum or an extremum; a VALID NaN makes its cell's sum, min and max
// NaN, as jnp.minimum / jnp.maximum do in the TPU kernel.
//
// What bounds it on the card.  The work is B*k*(1 + 4V) updates; the bytes
// are the batch read once, B*(5V + 9) (values f32, colvalid and row_valid
// u8, win_rel and gid int32), plus B*4 of rem only where some fan-out needs
// it (L % S != 0: otherwise the kernel never loads rem), plus the ring
// cells the batch touches, read and written once.  That is ~1.8 MB at the
// main path's B = 131,072, about half a microsecond at 3.35 TB/s, so the
// bytes bound it in principle.  In practice the traffic does: rows arrive in time
// order with ~10 live keys, so a batch falls in 1-2 ring slots and all
// 131,072 rows land on ~10-20 hot (slot, group) cells.  Per-row atomics
// on those few addresses serialise, and a CAS loop for min/max retries
// under that contention.
//
// What the design does about it.
//   - Warp aggregation.  __match_any_sync groups the lanes of a warp that
//     hit the same (slot, group) cell; the group reduces its rows with
//     __reduce_add_sync (int counts), __reduce_min/max_sync (extrema as int
//     keys) and a shuffle tree over the group's lanes (f32 sum), and its
//     leader lane makes ONE shared-memory update per cell: hot-cell
//     traffic drops ~32x before it reaches an atomic.
//   - Int-key extrema.  Shared min/max cells hold an order-preserving int
//     key of the float (bits for x >= 0, bits ^ 0x7fffffff for x < 0), so
//     they update with the hardware atomicMin/atomicMax, not a CAS loop.  A
//     valid NaN takes the key below every number for min (INT_MIN) and
//     above every number for max (INT_MAX); both keys decode to NaN.  The
//     key order itself records the NaN, so no separate flag plane is
//     needed and a NaN costs no extra atomic.
//   - Fused fold.  Each block keeps private (K_ACTIVE, g_tile) partials in
//     shared memory and folds only the cells it touched straight into the
//     ring: int32 atomicAdd for counts (exact), f32 atomicAdd for sums, and
//     min/max by fire-and-forget int atomics on the float's bits split by
//     its sign (fold_min/fold_max), NaN-propagating, with no CAS loop and
//     no round trip but one read that guards a NaN already in the ring.
//     Cross-block traffic is one update per touched cell per block, not
//     per row.  No partials tensor, no fill, no second launch.
//   - Groups tile over blockIdx.y so one tile's planes fit the shared
//     memory budget (at G = 2048, V = 1 the full planes need 320 KiB,
//     beyond a block's 227 KB); a block skips rows of other tiles.  This
//     keeps the JAX package's limits (G <= 2048, k <= 8) and so its
//     per-batch dense/scatter dispatch.
//
// Shared memory per block: 4 * K_ACTIVE * g_tile * (1 + 4V) bytes: the row
// count plane, then count, sum, min-key and max-key planes per column, one
// int32/f32 word per (slot, group) cell.  The wrapper sizes g_tile so this
// stays within 64 KiB (20 KiB at the main path's G = 128, V = 1), which
// lets several blocks share an SM.
//
// The ring-plane pointers travel by value as a __grid_constant__ kernel
// parameter (PlaneTable: MAX_COLUMNS value columns, 2 KiB of the 4 KiB of
// parameters), so a launch needs no device table and no copy; the dense
// path admits at most MAX_COLUMNS value columns.
//
// Float atomics make the order of the f32 sums vary from run to run:
// counts, min and max are exact, sums agree to rounding (no fixed-order
// cross-block reduction here).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int K_ACTIVE = 8;
constexpr int BLOCK_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_COLUMNS = 64;

// The ring planes of one value column; null = that component is absent.
struct ColumnPlanes {
  int* cnt;
  float* sum;
  float* mn;
  float* mx;
};

struct PlaneTable {
  ColumnPlanes col[MAX_COLUMNS];
};

__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// Inverse of order_key; INT_MIN and INT_MAX decode to NaN.
__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ int min_key(float x) {
  return x != x ? INT_MIN : order_key(x);
}

__device__ __forceinline__ int max_key(float x) {
  return x != x ? INT_MAX : order_key(x);
}

// Fold an extremum, given as its key, into a float ring cell with
// fire-and-forget integer atomics: a float with its sign bit clear orders
// like its bits as a signed int, one with the sign bit set orders in
// reverse like its bits as an unsigned int, so
//   min: sign clear -> atomicMin(int), sign set -> atomicMax(unsigned)
//   max: sign clear -> atomicMax(int), sign set -> atomicMin(unsigned)
// keep min/max over every non-NaN pair of stored and new value.  A NaN is
// stored as the one pattern both of its atomics leave in place: all ones
// for min (-1 as int, the largest unsigned), 0x7fffffff for max (the
// largest int, below every negative float as unsigned).  A NaN that was
// already in the ring before the launch may have another pattern, so the
// cell is read first (past L1) and left alone when it holds a NaN.
__device__ __forceinline__ void fold_min(float* addr, int key) {
  if (isnan(__ldcg(addr))) return;
  if (key == INT_MIN) {
    atomicMax(reinterpret_cast<unsigned*>(addr), 0xffffffffu);
    return;
  }
  const int bits = __float_as_int(key_value(key));
  if (bits >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned*>(addr), static_cast<unsigned>(bits));
  }
}

__device__ __forceinline__ void fold_max(float* addr, int key) {
  if (isnan(__ldcg(addr))) return;
  if (key == INT_MAX) {
    atomicMax(reinterpret_cast<int*>(addr), 0x7fffffff);
    return;
  }
  const int bits = __float_as_int(key_value(key));
  if (bits >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMin(reinterpret_cast<unsigned*>(addr), static_cast<unsigned>(bits));
  }
}

// Sum of x over the lanes of ``peers`` (the calling lane among them), by a
// tree over the lanes' ranks within the group; the total lands on the
// group's lowest lane.  Every lane of ``peers`` must call it.
__device__ __forceinline__ float peer_sum(unsigned peers, float x, int lane) {
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int n = __popc(peers);
  for (int d = 1; d < n; d <<= 1) {
    const int src_rank = rank + d;
    // lane of the peer ranked src_rank (the (src_rank+1)-th set bit)
    const int src =
        src_rank < n ? static_cast<int>(__fns(peers, 0, src_rank + 1)) : lane;
    const float y = __shfl_sync(peers, x, src);
    if ((rank & (2 * d - 1)) == 0 && src_rank < n) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(BLOCK_THREADS) dense_window_update_kernel(
    const float* __restrict__ values,       // (B, V)
    const uint8_t* __restrict__ colvalid,   // (B, V) bool
    const int* __restrict__ win_rel,        // (B,)
    const int* __restrict__ rem,            // (B,)
    const int* __restrict__ gid,            // (B,)
    const uint8_t* __restrict__ row_valid,  // (B,) bool
    int B, int V, int k, int length_ms, int slide_ms, int W, int G,
    int g_tile, int min_win_rel, int ring_base,
    int* __restrict__ ring_rowcnt,             // (W, G) or null
    const __grid_constant__ PlaneTable planes)  // columns 0..V-1
{
  extern __shared__ int smem[];
  const int g0 = blockIdx.y * g_tile;
  const int gt = min(g_tile, G - g0);
  const int plane = K_ACTIVE * gt;  // (slot, group) cells of the tile
  // layout: row count [cell], then per column count, sum, min key and max
  // key as [v][cell]
  int* s_row = smem;
  int* s_cnt = s_row + plane;
  float* s_sum = reinterpret_cast<float*>(s_cnt + V * plane);
  int* s_min = reinterpret_cast<int*>(s_sum + V * plane);
  int* s_max = s_min + V * plane;
  const int key_pos_inf = 0x7f800000;               // order_key(+inf)
  const int key_neg_inf = (int)(0xff800000u ^ 0x7fffffffu);  // order_key(-inf)

  for (int i = threadIdx.x; i < plane * (1 + 2 * V); i += BLOCK_THREADS) {
    smem[i] = 0;  // row count, counts, and sums (+0.0f is all-zero bits)
  }
  for (int i = threadIdx.x; i < V * plane; i += BLOCK_THREADS) {
    s_min[i] = key_pos_inf;
    s_max[i] = key_neg_inf;
  }
  __syncthreads();

  // Warp-uniform grid-stride loop over rows, so every lane reaches the warp
  // intrinsics; lanes past B take no cell.
  const int lane = threadIdx.x & 31;
  // rem decides a row only for a fan-out whose window covers part of the
  // slide unit, L - i*S < S; the smallest such cut is at i = k - 1
  const bool need_rem = length_ms - (k - 1) * slide_ms < slide_ms;
  const long long warps = (long long)gridDim.x * (BLOCK_THREADS / 32);
  for (long long base =
           ((long long)blockIdx.x * (BLOCK_THREADS / 32) + threadIdx.x / 32) *
           32;
       base < B; base += warps * 32) {
    const long long r = base + lane;
    bool row_ok = false;
    int wr0 = 0, rm = 0, g = -1;
    if (r < B) {
      wr0 = win_rel[r];
      rm = need_rem ? rem[r] : 0;
      g = gid[r] - g0;  // also drops gids outside [0, G): they miss every tile
      row_ok = row_valid[r] != 0 && g >= 0 && g < gt;
    }
    for (int i = 0; i < k; ++i) {
      const int wr = wr0 - i;
      const int j = wr - min_win_rel;
      const int cut = length_ms - i * slide_ms;  // window i covers rem < cut
      const bool ok = row_ok && wr >= 0 && wr < W &&
                      (cut >= slide_ms || rm < cut) && j >= 0 && j < K_ACTIVE;
      if (__ballot_sync(FULL_MASK, ok) == 0u) continue;
      const int cell = ok ? j * gt + g : -1;
      const unsigned peers = __match_any_sync(FULL_MASK, cell);
      if (!ok) continue;  // the lanes without a cell form one group: all leave
      const bool leader = (__ffs(peers) - 1) == lane;
      if (leader) atomicAdd(&s_row[cell], __popc(peers));
      for (int v = 0; v < V; ++v) {
        const bool valid = colvalid[r * V + v] != 0;
        const float x = valid ? values[r * V + v] : 0.0f;
        const ColumnPlanes p = planes.col[v];
        const int c = __reduce_add_sync(peers, valid ? 1 : 0);
        if (c == 0) continue;  // uniform over the group
        const int vc = v * plane + cell;
        if (p.sum) {
          const float s = peer_sum(peers, x, lane);
          if (leader) atomicAdd(&s_sum[vc], s);
        }
        if (p.mn) {
          const int km = __reduce_min_sync(peers, valid ? min_key(x) : key_pos_inf);
          if (leader) atomicMin(&s_min[vc], km);
        }
        if (p.mx) {
          const int kx = __reduce_max_sync(peers, valid ? max_key(x) : key_neg_inf);
          if (leader) atomicMax(&s_max[vc], kx);
        }
        if (leader) atomicAdd(&s_cnt[vc], c);
      }
    }
  }
  __syncthreads();

  // Fold the touched cells into the ring; untouched cells hold identities.
  for (int cell = threadIdx.x; cell < plane; cell += BLOCK_THREADS) {
    const int rc = s_row[cell];
    if (rc == 0) continue;
    const int j = cell / gt;
    const int g = g0 + cell % gt;
    const size_t o = (size_t)((ring_base + j) % W) * G + g;
    if (ring_rowcnt) atomicAdd(&ring_rowcnt[o], rc);
    for (int v = 0; v < V; ++v) {
      const int vc = v * plane + cell;
      const int c = s_cnt[vc];
      if (c == 0) continue;  // no valid value: count 0, sum 0, identities
      const ColumnPlanes p = planes.col[v];
      if (p.cnt) atomicAdd(&p.cnt[o], c);
      if (p.sum) atomicAdd(&p.sum[o], s_sum[vc]);
      if (p.mn) fold_min(&p.mn[o], s_min[vc]);
      if (p.mx) fold_max(&p.mx[o], s_max[vc]);
    }
  }
}

// Largest dynamic shared-memory size the kernel has been allowed on each
// device (cudaFuncSetAttribute applies per device and must cover every
// later launch).
int g_smem_allowed[MAX_DEVICES] = {0};

// Bytes of dynamic shared memory one block uses.
int smem_bytes(int V, int g_tile) {
  return (int)(sizeof(int) * K_ACTIVE * g_tile * (1 + 4 * V));
}

}  // namespace

extern "C" {

// Once per (device, shared-memory size), before the first launch: raise the
// kernel's dynamic shared-memory limit on the current device if needed and
// report the resident blocks per SM at that size and the SM count.
// Returns a cudaError_t (0 = success).
int dense_window_prepare(int V, int g_tile, int* blocks_per_sm, int* num_sms) {
  const int smem = smem_bytes(V, g_tile);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > g_smem_allowed[dev]) {
    err = cudaFuncSetAttribute(dense_window_update_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_allowed[dev] = smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, dense_window_update_kernel, BLOCK_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(num_sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// Launch on ``stream`` (a cudaStream_t passed as a pointer).  ``planes``
// is a HOST array of V ColumnPlanes (device pointers, null = absent),
// copied into the kernel's parameters.  Allocates nothing; returns
// cudaGetLastError() after the launch (0 = success), so a refused launch is
// reported to the caller instead of silently never running.
int dense_window_update(
    const float* values, const uint8_t* colvalid, const int* win_rel,
    const int* rem, const int* gid, const uint8_t* row_valid, int B, int V,
    int k, int length_ms, int slide_ms, int W, int G, int g_tile,
    int min_win_rel, int ring_base, int blocks_x, int* ring_rowcnt,
    const void* planes, void* stream) {
  if (V < 1 || V > MAX_COLUMNS) return (int)cudaErrorInvalidValue;
  PlaneTable table{};
  for (int v = 0; v < V; ++v) {
    table.col[v] = static_cast<const ColumnPlanes*>(planes)[v];
  }
  const int smem = smem_bytes(V, g_tile);
  const dim3 grid(blocks_x, (G + g_tile - 1) / g_tile);
  dense_window_update_kernel<<<grid, BLOCK_THREADS, smem,
                               (cudaStream_t)stream>>>(
      values, colvalid, win_rel, rem, gid, row_valid, B, V, k, length_ms,
      slide_ms, W, G, g_tile, min_win_rel, ring_base, ring_rowcnt, table);
  return (int)cudaGetLastError();
}

const char* dense_window_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
