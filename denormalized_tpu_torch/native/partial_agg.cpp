// Host-edge partial window aggregation — the native single-pass reducer
// behind the "partial_merge" device strategy.
//
// Why this exists: a streaming engine feeding an accelerator should ship
// the SMALLEST sufficient statistics across the host->device link, not raw
// rows.  This kernel reduces a decoded batch to per-(slide-unit, sub,
// group) partials (row count; per value column: valid count, sum, min,
// max) in one pass over the rows.  The device then folds the partials into
// its HBM-resident window ring (sliding fan-out included) — the same
// Partial/Final split the reference applies across CPU partitions
// (crates/core/src/planner/streaming_window.rs:133-153), applied across
// the host/accelerator boundary.
//
// The `sub` axis splits each slide unit in two when window length is not a
// multiple of the slide: rows with rem < L - (k-1)*S belong to all k
// overlapping windows (sub 0), the rest to only the first k-1 (sub 1).
// With L % S == 0 every row is sub 0 and SUB == 1.
//
// Accumulation is f64 on host — strictly more precise than the per-row
// f32 device scatter it replaces.

#include <cstdint>
#include <cmath>

extern "C" {

// One pass over n rows.  Arrays are dense C-order:
//   win_rel: (n) int64  — slide-unit index rebased to the stripe window;
//            rows outside [0, U) are skipped (late / overflow, the caller
//            pre-rebased against u_lo)
//   sub:     (n) uint8 or NULL — sub-bucket per row (0/1); NULL = all 0
//   gid:     (n) int32  — dense group ids in [0, G)
//   values:  (n, V) f64 — value matrix (row-major)
//   colvalid:(n, V) uint8 or NULL — per-cell validity; NULL = all valid
// Outputs (all (U * SUB * G) flat, indexed ((u*SUB)+s)*G+g):
//   row_cnt: int64  — rows per cell (count(*))
//   cnt:     (V, U*SUB*G) int64 — valid values per cell per column
//   sum:     (V, U*SUB*G) f64
//   mn:      (V, U*SUB*G) f64 (caller inits to +inf)
//   mx:      (V, U*SUB*G) f64 (caller inits to -inf)
// Returns number of rows folded (excludes skipped).
int64_t partial_window_agg(
    const int64_t* win_rel,
    const uint8_t* sub,
    const int32_t* gid,
    const double* values,
    const uint8_t* colvalid,
    int64_t n,
    int32_t V,
    int32_t U,
    int32_t SUB,
    int32_t G,
    int64_t* row_cnt,
    int64_t* cnt,
    double* sum,
    double* mn,
    double* mx) {
  const int64_t cells = (int64_t)U * SUB * G;
  int64_t folded = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t u = win_rel[i];
    if (u < 0 || u >= U) continue;
    const int32_t g = gid[i];
    if (g < 0 || g >= G) continue;
    const int32_t s = sub ? (int32_t)sub[i] : 0;
    const int64_t cell = ((u * SUB) + s) * G + g;
    ++row_cnt[cell];
    ++folded;
    for (int32_t v = 0; v < V; ++v) {
      if (colvalid && !colvalid[i * V + v]) continue;
      const double x = values[i * V + v];
      const int64_t off = (int64_t)v * cells + cell;
      ++cnt[off];
      sum[off] += x;
      // NaN propagates (parity with the device scatter path and numpy
      // fallback): a plain `x < mn` comparison would silently skip NaN
      if (x != x || x < mn[off]) mn[off] = x;
      if (x != x || x > mx[off]) mx[off] = x;
    }
  }
  return folded;
}

}  // extern "C"
