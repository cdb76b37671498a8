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
// window (100K of 131,072 cells active, five planes) that is ~4.5 MB,
// about 1.4 us at 3.35 TB/s; a launch's fixed cost is of that order, so
// the design makes ONE launch and reads the count plane once.
//
// The design: a single-pass stable compaction with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016).
//   - A tile is TILE_CELLS = 1,024 consecutive cells, four a thread, read
//     as one int4 (16 B) a thread, neighbouring threads on neighbouring
//     addresses; a scalar tail covers G not a multiple of 4, and a slot
//     row that is not 16-B aligned takes the scalar loads throughout.
//     At config 3's G = 131,072 that is 128 tiles: one wave on 132 SMs.
//     The grid is at most 4 blocks an SM; a larger G gives each block
//     more tiles, taken in turn.
//   - A block takes its tiles from an atomic ticket counter, so tiles
//     start in ticket order whatever order the scheduler starts blocks
//     in, and a tile only ever waits on tiles already running.
//   - Ranks inside a warp come from four ballots (one per cell of the
//     thread) and popcounts; the 8 warps' totals are scanned in shared
//     memory.  Warp 0 then publishes the tile's aggregate, looks back over
//     its predecessors' status words 32 tiles at a time (one lane a tile)
//     until it meets an inclusive prefix, and publishes its own.  Two
//     barriers a tile.
//   - A status word is 64 bits: a 30-bit call tag, a 2-bit flag
//     (aggregate or inclusive prefix) and a 32-bit count, stored and
//     loaded as one word, so no fence orders a flag against its value.
//     The tag makes the scratch self-resetting: a word of an earlier call
//     reads as "not yet published", so no memset runs between calls.  The
//     ticket counter is never reset either: a call takes exactly
//     tiles + blocks tickets (each block stops on its first ticket past
//     the last tile), so the wrapper passes the call's first ticket.
//     Calls on one scratch must therefore reach its stream in call-number
//     order: the wrapper hands out the number and queues the launch under
//     one lock.  (A memset of the scratch before each launch, in the
//     call's own memory, needs no order and no cache, but measured 0.97 us
//     of device time a call, the kernel's own being ~4-5 us; PERF.md §6.)
//   - The last tile writes k.
//   - Planes travel by value in a __grid_constant__ table, 4-byte planes
//     first, then 8-byte ones: two plain loops, no branch on a plane's
//     width.  An active cell's value is read with the thread's 16-B (or
//     two 16-B, for 8-byte planes) load of its four cells where the rows
//     are aligned, and written at its rank.
// No atomics on the data: the output is a copy, exact and the same from
// run to run.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_THREADS = 256;
constexpr int WARPS = BLOCK_THREADS / 32;
constexpr int CELLS = 4;  // cells a thread: one int4 of the count plane
constexpr int TILE_CELLS = CELLS * BLOCK_THREADS;
constexpr int MAX_PLANES = 64;
constexpr unsigned FULL = 0xffffffffu;

constexpr unsigned long long FLAG_AGGREGATE = 1ull;
constexpr unsigned long long FLAG_PREFIX = 2ull;
constexpr unsigned TAG_BITS = 30;

// One component plane: the slot's row of the ring and the output buffer,
// both of G elements (4 or 8 bytes each, by the plane's place in the table).
struct Plane {
  const void* src;
  void* dst;
};

struct PlaneTable {
  Plane p[MAX_PLANES];
};

__device__ __forceinline__ unsigned long long status_word(
    unsigned tag, unsigned long long flag, unsigned value) {
  return (static_cast<unsigned long long>(tag) << 34) | (flag << 32) | value;
}

__device__ __forceinline__ void publish(unsigned long long* status, int tile,
                                        unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(status + tile) = word;
}

// The exclusive prefix of ``tile`` (> 0), by warp 0 of its block, after it
// published its aggregate: look back over the predecessors' status words,
// a window of 32 tiles at a time (lane l reads tile - 1 - l - 32 r), until
// an inclusive prefix turns up; the counts of the window up to and
// including that prefix are summed.  Tiles below 0 read as prefix 0.
// (A window of 128 tiles, four loads a lane, measured slower on the card:
// a window waits for its slowest tile's aggregate.)
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* status, int tile, unsigned tag, int lane) {
  unsigned exclusive = 0;
  long long j = static_cast<long long>(tile) - 1 - lane;
  while (true) {
    unsigned long long w;
    unsigned flag;
    do {
      w = j >= 0 ? *reinterpret_cast<const volatile unsigned long long*>(
                       status + j)
                 : status_word(tag, FLAG_PREFIX, 0);
      flag = (w >> 34) == tag ? static_cast<unsigned>((w >> 32) & 3ull) : 0u;
    } while (__any_sync(FULL, flag == 0));
    const unsigned prefixes = __ballot_sync(FULL, flag == FLAG_PREFIX);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned v = lane <= stop ? static_cast<unsigned>(w) : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    exclusive += v;
    if (prefixes) return exclusive;
    j -= 32;
  }
}

// A thread's four values of one plane (T is int or long long: the bits of
// 4- or 8-byte elements): one 16-B load (two for 8 bytes) where ``vec``,
// else a load of each active cell.
template <typename T>
__device__ __forceinline__ void load_quad(const T* __restrict__ src,
                                          long long c0, bool vec,
                                          const bool (&a)[CELLS],
                                          T (&v)[CELLS]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(src + c0));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      const longlong2* s = reinterpret_cast<const longlong2*>(src + c0);
      const longlong2 q0 = __ldg(s);
      const longlong2 q1 = __ldg(s + 1);
      v[0] = q0.x;
      v[1] = q0.y;
      v[2] = q1.x;
      v[3] = q1.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CELLS; ++i) v[i] = a[i] ? __ldg(src + c0 + i) : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void copy_plane(const Plane& pl, long long c0,
                                           bool vec, const bool (&a)[CELLS],
                                           const int (&rank)[CELLS]) {
  T v[CELLS];
  load_quad(static_cast<const T*>(pl.src), c0, vec, a, v);
  T* dst = static_cast<T*>(pl.dst);
#pragma unroll
  for (int i = 0; i < CELLS; ++i) {
    if (a[i]) dst[rank[i]] = v[i];
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS) compact_slot_kernel(
    const int* __restrict__ counts, int G, int tiles, int aligned,
    unsigned long long* status,
    unsigned long long* __restrict__ tickets, unsigned long long first_ticket,
    unsigned tag, int* __restrict__ gids_out, int* __restrict__ n_active,
    int n4, int n8, const __grid_constant__ PlaneTable table) {
  __shared__ int s_warp[WARPS];
  __shared__ int s_prefix;
  __shared__ int s_tile[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;

  if (threadIdx.x == 0) {
    s_tile[0] = static_cast<int>(atomicAdd(tickets, 1ull) - first_ticket);
  }
  __syncthreads();
  int tile = s_tile[0];
  // unsigned: a ticket below the call's first reads as past the last tile
  for (int n = 0; static_cast<unsigned>(tile) < static_cast<unsigned>(tiles);
       ++n) {
    // 1. this thread's four cells: one 16-B load where the whole quad is
    //    in the row and the row is aligned, else a scalar load a cell
    const long long c0 = static_cast<long long>(tile) * TILE_CELLS +
                         static_cast<long long>(threadIdx.x) * CELLS;
    const bool vec = aligned && c0 + CELLS <= G;
    bool a[CELLS];
    if (vec) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(counts + c0));
      a[0] = q.x > 0;
      a[1] = q.y > 0;
      a[2] = q.z > 0;
      a[3] = q.w > 0;
    } else {
#pragma unroll
      for (int i = 0; i < CELLS; ++i) {
        a[i] = c0 + i < G && __ldg(counts + c0 + i) > 0;
      }
    }
    // ranks inside the warp: the cells of the lanes below, then own order
    int below = 0, warp_total = 0;
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      const unsigned b = __ballot_sync(FULL, a[i]);
      below += __popc(b & lanes_below);
      warp_total += __popc(b);
    }
    if (lane == 0) s_warp[warp] = warp_total;
    if (threadIdx.x == 0) {  // the next tile's ticket, read after barrier 2
      s_tile[(n + 1) & 1] =
          static_cast<int>(atomicAdd(tickets, 1ull) - first_ticket);
    }
    __syncthreads();  // barrier 1: the warps' totals
    int warp_prefix = 0, aggregate = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int t = s_warp[w];
      warp_prefix += w < warp ? t : 0;
      aggregate += t;
    }
    // 2. warp 0 publishes the aggregate, looks back, publishes the prefix
    if (warp == 0) {
      unsigned exclusive = 0;
      if (tile == 0) {
        if (lane == 0) {
          publish(status, 0, status_word(tag, FLAG_PREFIX, aggregate));
        }
      } else {
        if (lane == 0) {
          publish(status, tile, status_word(tag, FLAG_AGGREGATE, aggregate));
        }
        exclusive = look_back(status, tile, tag, lane);
        if (lane == 0) {
          publish(status, tile,
                  status_word(tag, FLAG_PREFIX, exclusive + aggregate));
        }
      }
      if (lane == 0) {
        s_prefix = static_cast<int>(exclusive);
        if (tile == tiles - 1) {
          *n_active = static_cast<int>(exclusive) + aggregate;
        }
      }
    }
    __syncthreads();  // barrier 2: the tile's prefix, the next ticket
    // 3. scatter the active cells: gid, then every plane
    int rank[CELLS];
    int r = s_prefix + warp_prefix + below;
#pragma unroll
    for (int i = 0; i < CELLS; ++i) {
      rank[i] = r;
      r += a[i] ? 1 : 0;
    }
    if (a[0] | a[1] | a[2] | a[3]) {
#pragma unroll
      for (int i = 0; i < CELLS; ++i) {
        if (a[i]) gids_out[rank[i]] = static_cast<int>(c0 + i);
      }
      for (int p = 0; p < n4; ++p) {
        copy_plane<int>(table.p[p], c0, vec, a, rank);
      }
      for (int p = n4; p < n4 + n8; ++p) {
        copy_plane<long long>(table.p[p], c0, vec, a, rank);
      }
    }
    tile = s_tile[(n + 1) & 1];
  }
}

}  // namespace

extern "C" {

// The number of 1,024-cell tiles for G cells: the status words a call
// needs.
int compact_slot_tiles(int G) { return (G + TILE_CELLS - 1) / TILE_CELLS; }

// Compact one slot of G cells on ``stream`` (a cudaStream_t passed as a
// pointer) in one launch of ``blocks`` blocks (at most the tiles).
// ``counts`` is the slot's row-count plane (int32); ``planes`` a HOST array
// of n4 + n8 (src, dst) device-pointer pairs, the n4 planes of 4-byte
// elements first, copied into the kernel's parameters; ``aligned`` says
// that ``counts`` and every src are 16-B aligned.  ``gids_out`` takes G
// int32, ``n_active`` one int32.  ``status`` holds one 64-bit word a tile
// and ``tickets`` one 64-bit counter, both zeroed once when allocated and
// never reset: ``call`` (1, 2, ... on this scratch, below 2^30) tags the
// status words, and the call's tickets start at (call - 1) x (tiles +
// blocks).  Allocates nothing; returns cudaGetLastError() after the
// launch (0 = success), so a refused launch reaches the caller.
int compact_slot_launch(const int* counts, int G, int n4, int n8,
                        const void* planes, int aligned, int* gids_out,
                        int* n_active, unsigned long long* status,
                        unsigned long long* tickets, unsigned long long call,
                        int blocks, void* stream) {
  const int tiles = compact_slot_tiles(G);
  if (G < 1 || n4 < 0 || n8 < 0 || n4 + n8 > MAX_PLANES || blocks < 1 ||
      blocks > tiles || call < 1 || call >= (1ull << TAG_BITS)) {
    return (int)cudaErrorInvalidValue;
  }
  PlaneTable table{};
  for (int p = 0; p < n4 + n8; ++p) {
    table.p[p] = static_cast<const Plane*>(planes)[p];
  }
  const unsigned long long first =
      (call - 1) * static_cast<unsigned long long>(tiles + blocks);
  compact_slot_kernel<<<blocks, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
      counts, G, tiles, aligned, status, tickets, first,
      static_cast<unsigned>(call), gids_out, n_active, n4, n8, table);
  return (int)cudaGetLastError();
}

const char* compact_slot_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
