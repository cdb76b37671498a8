// NaN-safe extremum folds into float ring cells, shared by the kernels of
// csrc/ (dense_window.cu, merge_partials.cu).
//
// An extremum travels as an order-preserving int key of the float: its
// bits for x >= 0, bits ^ 0x7fffffff for x < 0, so keys compare like the
// floats and reduce with the hardware's integer min/max.  A valid NaN takes
// the key below every number for min (INT_MIN) and above every number for
// max (INT_MAX); both keys decode to NaN.
//
// Two kinds of fold: the atomic ones (fold_min/fold_max, and their halves
// without the NaN check for a caller that read the cell earlier) for cells
// that several threads may update in one launch, and the value folds
// (min_value/max_value) for a thread that owns its cell.  Both order -0
// below +0 and keep a NaN already in the cell.
//
// Each has a double twin for float64 rings (merge_partials.cu's f64
// instantiation): 64-bit keys (bits ^ 0x7fff...ffff below zero), LLONG_MIN
// and LLONG_MAX for a NaN, and the same sign-split atomics on 64-bit ints.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace ring_fold {

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
// caller must leave a cell alone that held a NaN when the launch began:
// fold_min/fold_max read it first (past L1); a caller that read it earlier
// calls atomic_min_key/atomic_max_key directly.  No thread of a launch
// writes a number over a NaN that was there when the launch began, so any
// read of the cell during the launch sees that NaN.
__device__ __forceinline__ void atomic_min_key(float* addr, int key) {
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

__device__ __forceinline__ void atomic_max_key(float* addr, int key) {
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

__device__ __forceinline__ void fold_min(float* addr, int key) {
  if (isnan(__ldcg(addr))) return;
  atomic_min_key(addr, key);
}

__device__ __forceinline__ void fold_max(float* addr, int key) {
  if (isnan(__ldcg(addr))) return;
  atomic_max_key(addr, key);
}

// The extremum of a cell's value r and a new value x, for a thread that
// owns the cell: a NaN in r stays, a NaN x replaces a number (its own
// bits), and numbers compare by their order keys (-0 below +0).
__device__ __forceinline__ float min_value(float r, float x) {
  if (isnan(r)) return r;
  if (isnan(x)) return x;
  return order_key(x) < order_key(r) ? x : r;
}

__device__ __forceinline__ float max_value(float r, float x) {
  if (isnan(r)) return r;
  if (isnan(x)) return x;
  return order_key(x) > order_key(r) ? x : r;
}

// -- float64 ring cells ------------------------------------------------------

__device__ __forceinline__ long long order_key(double x) {
  const long long b = __double_as_longlong(x);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

// Inverse of order_key(double); LLONG_MIN and LLONG_MAX decode to NaN.
__device__ __forceinline__ double key_value(long long k) {
  return __longlong_as_double(k >= 0 ? k : k ^ 0x7fffffffffffffffLL);
}

__device__ __forceinline__ long long min_key(double x) {
  return x != x ? LLONG_MIN : order_key(x);
}

__device__ __forceinline__ long long max_key(double x) {
  return x != x ? LLONG_MAX : order_key(x);
}

// The f32 atomic folds' rules on 64 bits: sign clear -> signed atomics,
// sign set -> unsigned atomics the other way; a NaN is stored as all ones
// (min) or 0x7fff...ffff (max).  The caller leaves a cell alone that held
// a NaN when the launch began.
__device__ __forceinline__ void atomic_min_key(double* addr, long long key) {
  if (key == LLONG_MIN) {
    atomicMax(reinterpret_cast<unsigned long long*>(addr),
              0xffffffffffffffffull);
    return;
  }
  const long long bits = __double_as_longlong(key_value(key));
  if (bits >= 0) {
    atomicMin(reinterpret_cast<long long*>(addr), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned long long*>(addr),
              static_cast<unsigned long long>(bits));
  }
}

__device__ __forceinline__ void atomic_max_key(double* addr, long long key) {
  if (key == LLONG_MAX) {
    atomicMax(reinterpret_cast<long long*>(addr), 0x7fffffffffffffffLL);
    return;
  }
  const long long bits = __double_as_longlong(key_value(key));
  if (bits >= 0) {
    atomicMax(reinterpret_cast<long long*>(addr), bits);
  } else {
    atomicMin(reinterpret_cast<unsigned long long*>(addr),
              static_cast<unsigned long long>(bits));
  }
}

__device__ __forceinline__ double min_value(double r, double x) {
  if (isnan(r)) return r;
  if (isnan(x)) return x;
  return order_key(x) < order_key(r) ? x : r;
}

__device__ __forceinline__ double max_value(double r, double x) {
  if (isnan(r)) return r;
  if (isnan(x)) return x;
  return order_key(x) > order_key(r) ? x : r;
}

}  // namespace ring_fold
