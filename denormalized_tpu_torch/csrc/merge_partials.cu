// Stripe fold for Hopper (sm_90a): one launch a merge folds a packed host
// stripe into the window ring in place — the device half of the
// partial_merge strategy.
//
// Replaces denormalized_tpu/ops/segment_agg.py::merge_partials_body
// (:365-456, jitted as merge_partials at :316 and, per key shard, as
// parallel/sharded_state.py::_key_sharded_merge_partials at :696), a
// jax.jit program that runs k x (components) XLA scatters a merge; in torch
// that would be 20-30 small launches.  Every kernel is a template on the
// ring's float type T: float (merge_partials_launch) for the default f32
// rings, double (merge_partials_launch_f64) for EngineConfig.accum_dtype =
// torch.float64, where each stripe value (an f32 bitcast) widens to double
// before it folds, as merge_partials_body's .astype(f64) does.  The host (ops/host_partial.py,
// native/partial_agg.cpp) has already reduced the rows to per-(slide unit u,
// sub-bucket s, group g) partials and packed them into one int32 matrix,
// row length a_pad + 2:
//   - compact layout: row 0 holds the flat cell indices
//     ((u*SUB)+s)*G_total + g (-1 = padding), the value planes follow from
//     row 1;
//   - dense layout: no index row, cell i is flat index i, value planes from
//     row 0, padding cells hold fold-neutral values;
//   - both: u_base_rel (stripe unit 0 relative to first_open) and base_mod
//     (first_open % W) in row 0's two tail slots;
//   - value planes are f32 bitcasts: one per count/min/max component, two
//     per sum (hi, lo); the lean layout leaves out per-column counts, which
//     read the row-count plane instead.
// The ring holds columns [g_shift, g_shift + cap) of a G_total-wide group
// space (one device: G_total = cap, g_shift = 0); a cell whose group falls
// outside is dropped.  For each cell and each fan-out f < k, with
// w = u_base_rel + u - f, the cell feeds ring row (base_mod + w) % W,
// column g - g_shift, if 0 <= w < W (a window outside the ring is dropped,
// never clamped) and not (SUB == 2 and f == k - 1 and s == 1): sub-bucket 1
// misses the oldest window.  Counts go to the int32 rings as int32, sums
// add hi then lo (lo goes to the sumc plane in compensated mode), min and
// max fold NaN-safely.  In an f64 ring the hi + lo pair keeps ~48 bits of
// the host's f64 sum.
//
// What bounds it on the card.  The bytes: the row-count plane of the
// stripe, the other planes of its live cells, plus every ring cell the
// stripe touches, each component read and written.  At the
// emit_measurements shape that is ~20 KB over ~10-20 live cells, a few
// hundred nanoseconds: the launch's fixed cost and the chain of dependent
// memory round trips a live thread waits on bound it.  At 100K live keys it
// is a few MB: there the bytes count.
//
// What the design does about it: three kernels, one a stripe by its shape,
// each issuing every load a thread needs before its first ring write, so a
// live thread waits on two round trips (its stripe cells, then the ring
// cells they address), not on one a (component, fan-out).  A thread folds
// one ring plane (blockIdx.y), so a warp's kind of fold is uniform and a
// thread holds few registers; divisions by G_total and cap are a multiply
// and shifts (FastDiv).  The plane pointers travel by value in a
// __grid_constant__ parameter (OpTable).
//   1. merge_partials_tumbling_kernel (k = 1: every tumbling window).
//      (base_mod + w) mod W is a bijection on [0, W), so distinct stripe
//      cells land in distinct ring cells: no atomics.  A thread takes
//      CELLS = 4 cells interleaved across its warp (lane l: cells l,
//      l + 32, ...), reads each cell's planes and ring cells, folds, and
//      writes each touched ring cell once.  Sums add r + hi, then + lo,
//      as the plain version does, so the ring is the same from run to
//      run.  Four consecutive cells a lane, read with one 16-byte load a
//      plane, ran 18-46% slower on the H100 at config 3's 2^18 cells: a
//      warp's ring loads and stores then spread over four times as many
//      L2 sectors an instruction (PERF.md, section 6).  In the dense
//      layout a thread whose cells all lie outside the ring's shard reads
//      nothing.
//   2. merge_partials_gather_kernel (dense layout, k > 1).
//      Gathers by ring cell instead of scattering from the stripe: one
//      thread a (window, group) of the windows the stripe can reach,
//      (units + k - 1) x cap of them, reads its <= k x SUB stripe cells
//      (coalesced across the warp's groups) and folds them in the plain
//      version's order (f ascending, then s, hi before lo), then writes
//      the ring cell once, and not at all when every contributor is empty.
//      No atomics: deterministic sums.
//   3. merge_partials_scatter_kernel (compact layout, k > 1).
//      Cells that feed one ring cell lie far apart in the sorted index row,
//      so updates stay atomic (int32 atomicAdd for counts, f32 or f64
//      atomicAdd for sums, the NaN-safe int-key folds of ring_fold.cuh,
//      32- or 64-bit, for min and max), but a thread reads its cell's header, index, row count and
//      value planes at once, then the NaN check of every ring cell it will
//      fold an extremum into, before its first atomic.  Sums here are
//      added in an order that varies from run to run.
//   - No fast-math: the file builds with -O3 only.

#include <cuda_runtime.h>

#include "ring_fold.cuh"

namespace {

constexpr int BLOCK_THREADS = 256;
constexpr int MAX_OPS = 64;
// stripe cells a thread of the tumbling kernel takes, interleaved across
// its warp: lane l of a warp's tile of 32 x CELLS cells takes cells l,
// l + 32, ..., so each load and store instruction covers 32 consecutive
// cells
constexpr int CELLS = 4;
// contributors (gather) or fan-outs (scatter) a thread loads at once
constexpr int FAN = 8;

enum OpKind : int { OP_COUNT = 0, OP_SUM = 1, OP_MIN = 2, OP_MAX = 3 };
enum Mode : int { MODE_TUMBLING = 0, MODE_GATHER = 1, MODE_SCATTER = 2 };

// One ring plane and the packed value plane that feeds it.
struct MergeOp {
  int kind;      // OpKind
  int src;       // value plane index (sum: hi; lo is the next plane)
  void* dst;     // ring plane: int* for counts, T* otherwise
  void* dst_lo;  // sum only: where lo goes (the sumc plane, or dst)
};

// A ring value of type T travels through a thread as its bits (Bits), so
// one carrier holds a count (int) or a float value; an f32 ring's carrier
// is the int it always was.
template <class T>
struct Ring;

template <>
struct Ring<float> {
  using Bits = int;
  __device__ __forceinline__ static float val(int b) {
    return __int_as_float(b);
  }
  __device__ __forceinline__ static int bits(float v) {
    return __float_as_int(v);
  }
};

template <>
struct Ring<double> {
  using Bits = long long;
  __device__ __forceinline__ static double val(long long b) {
    return __longlong_as_double(b);
  }
  __device__ __forceinline__ static long long bits(double v) {
    return __double_as_longlong(v);
  }
};

// A ring cell's value as bits: counts from the int32 plane, the rest from
// the T plane.
template <class T>
__device__ __forceinline__ typename Ring<T>::Bits load_ring(const void* plane,
                                                            int kind,
                                                            long long off) {
  using Bits = typename Ring<T>::Bits;
  if (kind == OP_COUNT) return static_cast<const int*>(plane)[off];
  return static_cast<const Bits*>(plane)[off];
}

template <class T>
__device__ __forceinline__ void store_ring(void* plane, int kind,
                                           long long off,
                                           typename Ring<T>::Bits r) {
  using Bits = typename Ring<T>::Bits;
  if (kind == OP_COUNT) {
    static_cast<int*>(plane)[off] = static_cast<int>(r);
  } else {
    static_cast<Bits*>(plane)[off] = r;
  }
}

struct OpTable {
  MergeOp op[MAX_OPS];
};

// Division of an unsigned int n < 2^32 by a fixed divisor d >= 1, as a
// multiply-high and shifts (Granlund and Montgomery): a runtime integer
// division costs ~20 instructions, and a thread divides several cells.
struct FastDiv {
  unsigned m;  // magic multiplier
  int l;       // ceil(log2 d); 0 for d = 1
};

__device__ __forceinline__ unsigned fast_div(unsigned n, const FastDiv& f) {
  if (f.l == 0) return n;
  const unsigned t = __umulhi(n, f.m);
  return (t + ((n - t) >> 1)) >> (f.l - 1);
}

// The stripe's and the ring's shape, by value.
struct Geometry {
  int a_pad;    // stripe cells
  int dense;    // layout: 1 dense, 0 compact
  int SUB;      // sub-buckets a unit
  int k;        // fan-out: windows a slide unit feeds
  int W;        // ring rows
  int cap;      // ring columns
  int G_total;  // group space of the flat index
  int g_shift;  // group of ring column 0
  int units;    // gather: whole units a dense stripe holds
  int sub_shift;  // log2 SUB: SUB is 1 or 2
  FastDiv by_G;   // division by G_total
  FastDiv by_cap; // division by cap
};

// A flat stripe index → (unit-and-sub-bucket us, group of the stripe).
__device__ __forceinline__ void split_flat(const Geometry& geo, int flat,
                                           int& us, int& g_glob) {
  us = static_cast<int>(fast_div(static_cast<unsigned>(flat), geo.by_G));
  g_glob = flat - us * geo.G_total;
}

__device__ __forceinline__ float as_float(int bits) {
  return __int_as_float(bits);
}

// Ring offset of window w_rel and ring column g, or -1 when nothing folds
// there (window outside the ring, group outside the shard).
__device__ __forceinline__ long long ring_offset(const Geometry& geo,
                                                 int base_mod, long long w,
                                                 int g) {
  if (w < 0 || w >= geo.W || g < 0 || g >= geo.cap) return -1;
  int slot = base_mod + static_cast<int>(w);  // both in [0, W)
  if (slot >= geo.W) slot -= geo.W;
  return static_cast<long long>(slot) * geo.cap + g;
}

// One contributor folded into ring values a thread owns (tumbling,
// gather).  r/rl hold the ring value(s) as bits: counts as int, the rest
// as T; a plain sum adds hi, then lo.
template <class T>
__device__ __forceinline__ void fold_value(int kind, bool split,
                                           typename Ring<T>::Bits& r,
                                           typename Ring<T>::Bits& rl,
                                           float x, float lo) {
  using R = Ring<T>;
  switch (kind) {
    case OP_COUNT:
      r += static_cast<int>(x);
      break;
    case OP_SUM:
      if (split) {
        r = R::bits(R::val(r) + static_cast<T>(x));
        rl = R::bits(R::val(rl) + static_cast<T>(lo));
      } else {
        r = R::bits(R::val(r) + static_cast<T>(x) + static_cast<T>(lo));
      }
      break;
    case OP_MIN:
      r = R::bits(ring_fold::min_value(R::val(r), static_cast<T>(x)));
      break;
    default:
      r = R::bits(ring_fold::max_value(R::val(r), static_cast<T>(x)));
      break;
  }
}

// In every kernel blockIdx.y is the ring plane (op): a warp's kind of fold
// is uniform and a thread holds one plane's values.

// The CELLS stripe cells of tumbling thread t.
__device__ __forceinline__ void thread_cells(long long t, int (&cell)[CELLS]) {
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    cell[c] = static_cast<int>((t >> 5) * (32 * CELLS) + c * 32 + (t & 31));
  }
}

// One plane's values of the thread's cells; ``fill`` past the stripe.
__device__ __forceinline__ void load_plane(const int* __restrict__ row,
                                           const int (&cell)[CELLS], int a_pad,
                                           int fill, int (&v)[CELLS]) {
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    v[c] = cell[c] < a_pad ? __ldg(row + cell[c]) : fill;
  }
}

// 1. k = 1: distinct cells, distinct ring cells; no atomics.  A thread
// takes CELLS stripe cells of one op.
template <class T>
__global__ void __launch_bounds__(BLOCK_THREADS)
    merge_partials_tumbling_kernel(const int* __restrict__ packed,
                                   const Geometry geo,
                                   const __grid_constant__ OpTable table) {
  int cell[CELLS];
  thread_cells(
      static_cast<long long>(blockIdx.x) * BLOCK_THREADS + threadIdx.x, cell);
  if (cell[0] >= geo.a_pad) return;
  const MergeOp& op = table.op[blockIdx.y];
  const size_t ld = static_cast<size_t>(geo.a_pad) + 2;
  const int* planes = packed + (geo.dense ? 0 : ld);
  int flat[CELLS];
  if (geo.dense) {
    // cell i is flat index i: cells wholly outside the shard need no load
    bool in_shard = false;
#pragma unroll
    for (int c = 0; c < CELLS; ++c) {
      flat[c] = cell[c] < geo.a_pad ? cell[c] : -1;
      int us, g_glob;
      split_flat(geo, cell[c], us, g_glob);
      in_shard |= flat[c] >= 0 && g_glob >= geo.g_shift &&
                  g_glob < geo.g_shift + geo.cap;
    }
    if (!in_shard) return;
  } else {
    load_plane(packed, cell, geo.a_pad, -1, flat);
  }
  // first round trip: the row counts (plane 0 tells live cells from empty
  // ones and padding), the compact index beside them, the header
  int rc[CELLS];
  load_plane(planes, cell, geo.a_pad, 0, rc);
  const int u_base_rel = __ldg(packed + geo.a_pad);
  const int base_mod = __ldg(packed + geo.a_pad + 1);
  long long off[CELLS];
  bool any = false;
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    off[c] = -1;
    // +0.0f is all-zero bits: an empty cell holds only fold identities
    if (rc[c] == 0 || flat[c] < 0) continue;
    int us, g_glob;
    split_flat(geo, flat[c], us, g_glob);
    // sub-bucket 1 misses the one window
    if ((us & (geo.SUB - 1)) != 0) continue;
    off[c] = ring_offset(geo, base_mod,
                         static_cast<long long>(u_base_rel) +
                             (us >> geo.sub_shift),
                         g_glob - geo.g_shift);
    any |= off[c] >= 0;
  }
  if (!any) return;
  // second round trip: the op's planes and its ring cells, then the folds
  // and one store a ring cell
  using Bits = typename Ring<T>::Bits;
  const bool sum = op.kind == OP_SUM;
  const bool split = sum && op.dst_lo != op.dst;
  int x[CELLS], lo[CELLS];
  Bits r[CELLS], rl[CELLS];
  load_plane(planes + op.src * ld, cell, geo.a_pad, 0, x);
  if (sum) load_plane(planes + (op.src + 1) * ld, cell, geo.a_pad, 0, lo);
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    if (off[c] < 0) continue;
    r[c] = load_ring<T>(op.dst, op.kind, off[c]);
    if (split) rl[c] = load_ring<T>(op.dst_lo, OP_SUM, off[c]);
  }
#pragma unroll
  for (int c = 0; c < CELLS; ++c) {
    if (off[c] < 0) continue;
    fold_value<T>(op.kind, split, r[c], rl[c], as_float(x[c]),
                  sum ? as_float(lo[c]) : 0.f);
    store_ring<T>(op.dst, op.kind, off[c], r[c]);
    if (split) store_ring<T>(op.dst_lo, OP_SUM, off[c], rl[c]);
  }
}

// 2. Dense layout with fan-out: one thread a (window, group) of one op,
// gathering its contributors.
template <class T>
__global__ void __launch_bounds__(BLOCK_THREADS) merge_partials_gather_kernel(
    const int* __restrict__ packed, const Geometry geo,
    const __grid_constant__ OpTable table) {
  const long long t =
      static_cast<long long>(blockIdx.x) * BLOCK_THREADS + threadIdx.x;
  if (t >= static_cast<long long>(geo.units + geo.k - 1) * geo.cap) return;
  // window m - (k - 1) of the stripe's units, ring column g
  const int m = static_cast<int>(
      fast_div(static_cast<unsigned>(t), geo.by_cap));
  const int g = static_cast<int>(t) - m * geo.cap;
  const int g_glob = g + geo.g_shift;
  if (g_glob < 0 || g_glob >= geo.G_total) return;
  const MergeOp& op = table.op[blockIdx.y];
  const size_t ld = static_cast<size_t>(geo.a_pad) + 2;
  const int u_base_rel = __ldg(packed + geo.a_pad);
  const int base_mod = __ldg(packed + geo.a_pad + 1);
  const long long off = ring_offset(
      geo, base_mod, static_cast<long long>(u_base_rel) + m - (geo.k - 1), g);
  if (off < 0) return;
  using Bits = typename Ring<T>::Bits;
  const bool sum = op.kind == OP_SUM;
  const bool split = sum && op.dst_lo != op.dst;
  Bits r = load_ring<T>(op.dst, op.kind, off);
  Bits rl = split ? load_ring<T>(op.dst_lo, OP_SUM, off) : 0;
  bool live = false;
  // contributors in the plain version's order: fan-out f ascending (unit
  // u = m - (k - 1) + f), then sub-bucket s; sub-bucket 1 misses f = k - 1.
  // FAN is even, so a pass holds whole fan-outs.
  const int n_contrib = geo.k * geo.SUB;
  for (int q0 = 0; q0 < n_contrib; q0 += FAN) {
    int rc[FAN], x[FAN], lo[FAN];
#pragma unroll
    for (int qq = 0; qq < FAN; ++qq) {
      const int q = q0 + qq;
      const int f = q >> geo.sub_shift;
      const int s = q & (geo.SUB - 1);
      const int u = m - (geo.k - 1) + f;
      rc[qq] = 0;
      if (q >= n_contrib || u < 0 || u >= geo.units ||
          (geo.SUB == 2 && s == 1 && f == geo.k - 1)) {
        continue;
      }
      const long long cell =
          static_cast<long long>(u * geo.SUB + s) * geo.G_total + g_glob;
      rc[qq] = __ldg(packed + cell);  // dense: plane 0 at row 0
      x[qq] = __ldg(packed + op.src * ld + cell);
      if (sum) lo[qq] = __ldg(packed + (op.src + 1) * ld + cell);
    }
    // +0.0f is all-zero bits: an empty cell holds only fold identities
#pragma unroll
    for (int qq = 0; qq < FAN; ++qq) live |= rc[qq] != 0;
    if (sum && !split) {
      // a fan-out's hi values, then its lo values, as the plain version's
      // two index_add_ calls add them
#pragma unroll
      for (int qq = 0; qq < FAN; ++qq) {
        if ((qq & (geo.SUB - 1)) != 0) continue;  // qq leads its group
        const bool two = geo.SUB == 2 && qq + 1 < FAN;
        T acc = Ring<T>::val(r);
        if (rc[qq] != 0) acc += static_cast<T>(as_float(x[qq]));
        if (two && rc[qq + 1] != 0) acc += static_cast<T>(as_float(x[qq + 1]));
        if (rc[qq] != 0) acc += static_cast<T>(as_float(lo[qq]));
        if (two && rc[qq + 1] != 0) {
          acc += static_cast<T>(as_float(lo[qq + 1]));
        }
        r = Ring<T>::bits(acc);
      }
    } else {
#pragma unroll
      for (int qq = 0; qq < FAN; ++qq) {
        if (rc[qq] == 0) continue;
        fold_value<T>(op.kind, split, r, rl, as_float(x[qq]),
                      sum ? as_float(lo[qq]) : 0.f);
      }
    }
  }
  if (!live) return;  // every contributor empty: the ring cell stays
  store_ring<T>(op.dst, op.kind, off, r);
  if (split) store_ring<T>(op.dst_lo, OP_SUM, off, rl);
}

// 3. Compact layout with fan-out: one thread a stripe cell of one op,
// atomics; every load a thread needs is issued before its first atomic.
template <class T>
__global__ void __launch_bounds__(BLOCK_THREADS) merge_partials_scatter_kernel(
    const int* __restrict__ packed, const Geometry geo,
    const __grid_constant__ OpTable table) {
  const int i = blockIdx.x * BLOCK_THREADS + threadIdx.x;
  if (i >= geo.a_pad) return;
  const MergeOp& op = table.op[blockIdx.y];
  const size_t ld = static_cast<size_t>(geo.a_pad) + 2;
  const int* planes = packed + ld;  // compact: value plane p at row p + 1
  // one round trip: row count, index, header and the op's planes
  const int rc = __ldg(planes + i);
  const int flat = __ldg(packed + i);
  const int u_base_rel = __ldg(packed + geo.a_pad);
  const int base_mod = __ldg(packed + geo.a_pad + 1);
  const float x = as_float(__ldg(planes + op.src * ld + i));
  const float lo = op.kind == OP_SUM
                       ? as_float(__ldg(planes + (op.src + 1) * ld + i))
                       : 0.f;
  if (rc == 0 || flat < 0) return;  // empty or padding
  int us, g_glob;
  split_flat(geo, flat, us, g_glob);
  const int g = g_glob - geo.g_shift;
  if (g < 0 || g >= geo.cap) return;
  const int s = us & (geo.SUB - 1);
  const int u = us >> geo.sub_shift;
  // fan-outs whose window may take the cell: sub-bucket 1 misses the oldest
  const int k_cell = (geo.SUB == 2 && s != 0) ? geo.k - 1 : geo.k;
  const bool extremum = op.kind == OP_MIN || op.kind == OP_MAX;
  for (int f0 = 0; f0 < k_cell; f0 += FAN) {
    long long off[FAN];
    bool nan[FAN];
    // the NaN check of every extremum ring cell, before the first atomic
#pragma unroll
    for (int ff = 0; ff < FAN; ++ff) {
      off[ff] = f0 + ff < k_cell
                    ? ring_offset(geo, base_mod,
                                  static_cast<long long>(u_base_rel) + u -
                                      (f0 + ff),
                                  g)
                    : -1;
      nan[ff] = extremum && off[ff] >= 0 &&
                isnan(__ldcg(static_cast<const T*>(op.dst) + off[ff]));
    }
#pragma unroll
    for (int ff = 0; ff < FAN; ++ff) {
      if (off[ff] < 0 || nan[ff]) continue;
      T* cell = static_cast<T*>(op.dst) + off[ff];
      switch (op.kind) {
        case OP_COUNT:
          atomicAdd(static_cast<int*>(op.dst) + off[ff], static_cast<int>(x));
          break;
        case OP_SUM:
          atomicAdd(cell, static_cast<T>(x));
          atomicAdd(static_cast<T*>(op.dst_lo) + off[ff], static_cast<T>(lo));
          break;
        case OP_MIN:
          ring_fold::atomic_min_key(cell,
                                    ring_fold::min_key(static_cast<T>(x)));
          break;
        default:
          ring_fold::atomic_max_key(cell,
                                    ring_fold::max_key(static_cast<T>(x)));
          break;
      }
    }
  }
}

// The multiplier and shift of FastDiv for d >= 1.
FastDiv fast_div_of(int d) {
  int l = 0;
  while ((1ull << l) < static_cast<unsigned long long>(d)) ++l;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << l) - static_cast<unsigned long long>(d))) /
          static_cast<unsigned long long>(d) +
      1;
  return FastDiv{static_cast<unsigned>(m), l};
}

// Launch on ``stream`` the kernel of ``mode`` for a ring of T (see the
// extern "C" entries below).
template <class T>
int launch(const int* packed, int mode, int a_pad, int dense, int SUB, int k,
           int W, int cap, int G_total, int g_shift, int n_ops,
           const void* ops, void* stream) {
  if (n_ops < 1 || n_ops > MAX_OPS || a_pad < 1 || SUB < 1 || SUB > 2 ||
      k < 1 || W < 1 || cap < 1 || G_total < 1 || g_shift < 0) {
    return (int)cudaErrorInvalidValue;
  }
  OpTable table{};
  for (int j = 0; j < n_ops; ++j) {
    table.op[j] = static_cast<const MergeOp*>(ops)[j];
  }
  const Geometry geo{a_pad, dense, SUB, k, W, cap, G_total, g_shift,
                     static_cast<int>(a_pad / (static_cast<long long>(SUB) *
                                               G_total)),
                     SUB - 1, fast_div_of(G_total),
                     fast_div_of(cap)};
  const cudaStream_t st = (cudaStream_t)stream;
  long long threads;
  switch (mode) {
    case MODE_TUMBLING:
      if (k != 1) return (int)cudaErrorInvalidValue;
      threads = (a_pad + 32LL * CELLS - 1) / (32LL * CELLS) * 32;
      break;
    case MODE_GATHER:
      if (!dense) return (int)cudaErrorInvalidValue;
      threads = static_cast<long long>(geo.units + k - 1) * cap;
      break;
    case MODE_SCATTER:
      if (dense) return (int)cudaErrorInvalidValue;
      threads = a_pad;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  // thread ids and cell indices are ints in the kernels
  if (threads < 1 || threads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long blocks = (threads + BLOCK_THREADS - 1) / BLOCK_THREADS;
  const dim3 grid(static_cast<unsigned>(blocks), n_ops);  // y: the op
  const auto tumbling = merge_partials_tumbling_kernel<T>;
  const auto gather = merge_partials_gather_kernel<T>;
  const auto scatter = merge_partials_scatter_kernel<T>;
  switch (mode) {
    case MODE_TUMBLING:
      tumbling<<<grid, BLOCK_THREADS, 0, st>>>(packed, geo, table);
      break;
    case MODE_GATHER:
      gather<<<grid, BLOCK_THREADS, 0, st>>>(packed, geo, table);
      break;
    default:
      scatter<<<grid, BLOCK_THREADS, 0, st>>>(packed, geo, table);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on ``stream`` (a cudaStream_t passed as a pointer) the kernel of
// ``mode`` (0 tumbling, 1 gather, 2 scatter; the wrapper picks it from the
// stripe's shape) for a float32 ring.  ``ops`` is a HOST array of n_ops
// MergeOp (device pointers), copied into the kernel's parameters.
// Allocates nothing; returns cudaGetLastError() after the launch (0 =
// success), so a refused launch reaches the caller.
int merge_partials_launch(const int* packed, int mode, int a_pad, int dense,
                          int SUB, int k, int W, int cap, int G_total,
                          int g_shift, int n_ops, const void* ops,
                          void* stream) {
  return launch<float>(packed, mode, a_pad, dense, SUB, k, W, cap, G_total,
                       g_shift, n_ops, ops, stream);
}

// The same for a float64 ring (sum, sumc, min and max planes of double;
// counts stay int32).
int merge_partials_launch_f64(const int* packed, int mode, int a_pad,
                              int dense, int SUB, int k, int W, int cap,
                              int G_total, int g_shift, int n_ops,
                              const void* ops, void* stream) {
  return launch<double>(packed, mode, a_pad, dense, SUB, k, W, cap, G_total,
                        g_shift, n_ops, ops, stream);
}

const char* merge_partials_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
