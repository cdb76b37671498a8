"""The stripe-fold kernels of ``csrc/merge_partials.cu`` run on the CPU: the
source is compiled for the host with ``g++`` through a shim that gives the
CUDA names it uses a serial meaning (each grid runs block after block,
thread after thread; an atomic is a plain read-modify-write), then launched
through its own ``merge_partials_launch`` on rings and stripes in host
memory.  It holds the kernels' index math, shard filter, fan-out and fold
order against the plain version (``segment_agg.merge_partials_reference``)
on seeded stripes of every layout and branch: the ``tumbling`` and
``gather`` kernels bit for bit (their order of adds is the plain
version's); the ``scatter`` kernel with counts, min and max exact (NaN
where NaN) and sums to rtol=1e-5 (its atomics add in another order on the
card).  What a serial run cannot show (races, the card's compiler) the
card's check shows: ``chip_smoke.py`` phase 7."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from denormalized_tpu_torch.ops import merge_partials as mp
from denormalized_tpu_torch.ops import segment_agg as sa
from denormalized_tpu_torch.ops.cuda_build import SRC_DIR
from denormalized_tpu_torch.ops.host_partial import HostPartialStripe

SHIM = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
using std::isnan;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static dim3 blockIdx, threadIdx;
struct int4 { int x, y, z, w; };
struct int2 { int x, y; };
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline float __int_as_float(int b) {
  float f;
  std::memcpy(&f, &b, 4);
  return f;
}
inline int __float_as_int(float f) {
  int b;
  std::memcpy(&b, &f, 4);
  return b;
}
inline double __longlong_as_double(long long b) {
  double f;
  std::memcpy(&f, &b, 8);
  return f;
}
inline long long __double_as_longlong(double f) {
  long long b;
  std::memcpy(&b, &f, 8);
  return b;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
template <class T> inline T atomicAdd(T* p, T v) {
  const T o = *p;
  *p = o + v;
  return o;
}
template <class T> inline T atomicMin(T* p, T v) {
  const T o = *p;
  if (v < o) *p = v;
  return o;
}
template <class T> inline T atomicMax(T* p, T v) {
  const T o = *p;
  if (v > o) *p = v;
  return o;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
template <class K, class... A>
void host_launch(K kernel, dim3 grid, unsigned block, cudaStream_t,
                 A... args) {
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned b = 0; b < grid.x; ++b)
      for (unsigned t = 0; t < block; ++t) {
        blockIdx = dim3(b, y);
        threadIdx = dim3(t);
        kernel(args...);
      }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """``csrc/merge_partials.cu`` built for the host, its launch function
    declared as the wrapper declares it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("merge_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    shutil.copy(SRC_DIR / "ring_fold.cuh", d)
    src = (SRC_DIR / "merge_partials.cu").read_text()
    src, n = re.subn(r"(\w+)<<<(\w+), (\w+), 0, (\w+)>>>\(",
                     r"host_launch(\1, \2, \3, \4, ", src)
    assert n == 3  # the three kernels' launches
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')
    (d / "merge_host.cpp").write_text(src)
    lib_path = d / "libmerge_host.so"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wall", "-Werror",
         "-Wno-unknown-pragmas", "-Wno-maybe-uninitialized",
         f"-I{d}", "-o", str(lib_path), str(d / "merge_host.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.merge_partials_launch, lib.merge_partials_launch_f64):
        fn.argtypes = [p] + [i] * 10 + [p, p]
        fn.restype = i
    return lib


AGGS = (("count", 0), ("sum", 0), ("min", 0), ("max", 0), ("avg", 1))
# (length, slide): tumbling (k = 1), k = 5, SUB = 2 with k = 3, k = 4,
# SUB = 2 with k = 3 again, and SUB = 2 with k = 1 (a window shorter than
# its slide)
SHAPES = [(1000, 1000), (1000, 200), (500, 200), (1000, 250), (700, 300),
          (200, 1000)]


def _ring(spec, rng, nan_cells: bool):
    """Host planes: 0-4 rows a cell, sums of positive readings, extrema
    where a cell has rows, NaNs in some extremum cells."""
    W, G = spec.window_slots, spec.group_capacity
    counts = rng.integers(0, 5, (W, G)).astype(np.int32)
    host = {}
    for c in spec.components:
        if c.kind == "count":
            host[c.label] = counts.copy()
        elif c.kind == "sum":
            host[c.label] = (counts * rng.normal(50, 10, (W, G))).astype(
                np.float32)
        elif c.kind == "sumc":
            host[c.label] = rng.normal(0, 1e-5, (W, G)).astype(np.float32)
        else:
            fill = np.inf if c.kind == "min" else -np.inf
            host[c.label] = np.where(
                counts > 0, rng.normal(50, 10, (W, G)), fill
            ).astype(np.float32)
    if nan_cells:
        for label in ("min_0", "max_0"):
            host[label][rng.integers(0, W, 6),
                        rng.integers(0, min(G, 8), 6)] = np.nan
    return host


def _case(seed: int, accum=torch.float32):
    """A seeded spec, ring and stripe: window shape, ring size, shard,
    key spread, units (some before the ring, some past it), nulls, valid
    NaNs and compensation all drawn from ``seed``; the ring's float type is
    ``accum``."""
    rng = np.random.default_rng(seed)
    L, S = SHAPES[rng.integers(0, len(SHAPES))]
    W = int(rng.choice([4, 8, 16]))
    cap = int(rng.choice([128, 256, 2048]))
    sharded = rng.random() < 0.4
    G_total = 2 * cap if sharded else cap
    g_shift = int(rng.choice([0, cap])) if sharded else 0
    compensated = bool(rng.random() < 0.3)
    comps = sa.components_for(AGGS)
    if compensated:
        comps = sa.with_compensation(comps)
    spec = sa.WindowKernelSpec(
        components=tuple(comps), num_value_cols=2, window_slots=W,
        group_capacity=cap, length_ms=L, slide_ms=S, compensated=compensated,
        accum_dtype=accum,
    )
    keys = (int(rng.integers(1, G_total + 1)) if rng.random() < 0.5
            else int(rng.integers(1, 20)))
    B = int(rng.integers(50, 4000))
    units = (int(rng.integers(-3, 6))
             + rng.integers(0, int(rng.integers(1, 8)), B)).astype(np.int64)
    rem = rng.integers(0, S, B).astype(np.int32)
    gid = rng.integers(0, keys, B).astype(np.int32)
    vals = rng.normal(50.0, 10.0, (B, 2))
    colvalid = None
    if rng.random() < 0.4:
        colvalid = rng.random((B, 2)) > 0.2
        vals[~colvalid & (rng.random((B, 2)) < 0.5)] = np.nan
    nans = bool(rng.random() < 0.4)
    if nans:
        rows = rng.integers(0, B, 3)
        vals[rows, 0] = np.nan
        if colvalid is not None:
            colvalid[rows, 0] = True
    stripe = HostPartialStripe(spec, G_total)
    stripe.add_batch(units, rem, gid, vals, colvalid, None)
    taken = stripe.take_packed(int(rng.integers(0, W)))
    return spec, stripe.SUB, taken, G_total, g_shift, _ring(spec, rng, nans)


def _host_fold(lib, spec, SUB, taken, G_total, g_shift, host):
    """The kernel of the stripe's branch, run on the CPU → (branch, its
    ring, the plain version's ring)."""
    packed, a_pad, _u, lean, dense = taken
    cpu = torch.device("cpu")
    want = sa.merge_partials_reference(
        spec, SUB, a_pad, lean, dense, sa.import_state(spec, host, cpu),
        torch.from_numpy(packed), G_total, g_shift)
    got = sa.import_state(spec, host, cpu)
    table, n_ops = mp._launch_table(spec, lean, got, cpu)
    branch = mp.merge_branch(spec, dense)
    stripe = torch.from_numpy(packed.copy())
    launch = (lib.merge_partials_launch_f64
              if spec.accum_dtype == torch.float64
              else lib.merge_partials_launch)
    rc = launch(
        stripe.data_ptr(), mp.BRANCHES[branch], a_pad, int(dense), SUB,
        spec.length_units, spec.window_slots, spec.group_capacity, G_total,
        g_shift, n_ops, table, None)
    assert rc == 0
    return branch, got, want


def _assert_rings(spec, branch, got, want, host):
    changed = False
    for c in spec.components:
        a, b = got[c.label].numpy(), want[c.label].numpy()
        changed |= not np.array_equal(a, host[c.label], equal_nan=True)
        if branch != "scatter":  # no atomics: the plain version's adds
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=f"{branch} {c.label}")
        elif c.kind in ("sum", "sumc"):
            np.testing.assert_allclose(
                a, b, rtol=1e-12 if a.dtype == np.float64 else 1e-5, atol=0,
                err_msg=c.label)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c.label)
    return changed


@pytest.mark.parametrize("block", range(8))
def test_kernels_on_the_host_match_the_plain_version(host_lib, block):
    """25 seeded stripes a block; across the blocks every branch, both
    layouts, SUB 1 and 2, sharded and whole rings occur."""
    seen = set()
    for seed in range(25 * block, 25 * (block + 1)):
        spec, SUB, taken, G_total, g_shift, host = _case(seed)
        branch, got, want = _host_fold(host_lib, spec, SUB, taken, G_total,
                                       g_shift, host)
        changed = _assert_rings(spec, branch, got, want, host)
        seen.add((branch, changed))
    assert any(changed for _b, changed in seen)


def test_every_branch_and_layout_is_drawn():
    """The seeds of the test above reach every (branch, layout, SUB)
    combination the wrapper can pick, and shards on both sides."""
    drawn = set()
    for seed in range(200):
        spec, SUB, taken, G_total, g_shift, _host = _case(seed)
        dense = taken[4]
        drawn.add((mp.merge_branch(spec, dense), dense, SUB,
                   G_total != spec.group_capacity))
    for branch, dense in (("tumbling", True), ("tumbling", False),
                          ("gather", True), ("scatter", False)):
        for SUB in (1, 2):
            for sharded in (False, True):
                assert (branch, dense, SUB, sharded) in drawn


@pytest.mark.parametrize("width", [1000, 1023, 129])
def test_stripe_narrower_than_a_warp_tile(host_lib, width):
    """A stripe whose width is no multiple of a warp's tile (32 x 4 cells)
    or of a block: the kernels mask the ragged edge.  The packed matrix is
    a compact stripe cut to ``width`` cells, its header moved along."""
    folded = set()
    for seed in range(40):
        spec, SUB, taken, G_total, g_shift, host = _case(seed)
        packed, a_pad, u, lean, dense = taken
        if dense or int((packed[0, :a_pad] >= 0).sum()) > width:
            continue
        cut = np.concatenate([packed[:, :width], packed[:, a_pad:]], axis=1)
        branch, got, want = _host_fold(
            host_lib, spec, SUB, (np.ascontiguousarray(cut), width, u, lean,
                                  dense), G_total, g_shift, host)
        if _assert_rings(spec, branch, got, want, host):
            folded.add(branch)
    assert folded == {"tumbling", "scatter"}


@pytest.mark.parametrize("block", range(4))
def test_f64_kernels_on_the_host_match_the_plain_version(host_lib, block):
    """The float64 instantiation (``merge_partials_launch_f64``) on 25
    seeded stripes a block: tumbling and gather bit for bit with the plain
    version's f64 ring, scatter with sums to rtol=1e-12 and counts, min and
    max (NaN where NaN) exact; every ring plane but the counts is float64."""
    seen = set()
    for seed in range(25 * block, 25 * (block + 1)):
        spec, SUB, taken, G_total, g_shift, host = _case(seed, torch.float64)
        branch, got, want = _host_fold(host_lib, spec, SUB, taken, G_total,
                                       g_shift, host)
        for c in spec.components:
            assert got[c.label].dtype == (
                torch.int32 if c.kind == "count" else torch.float64)
        changed = _assert_rings(spec, branch, got, want, host)
        seen.add((branch, changed))
    assert any(changed for _b, changed in seen)


def test_f64_ring_keeps_what_an_f32_ring_rounds_away(host_lib):
    """One tumbling stripe of sums far above f32's 24 bits folded into an
    f32 and an f64 ring: the f64 ring holds the host's f64 sum to ~1e-14
    (the stripe's hi + lo pair), the f32 ring only to ~1e-7."""
    rng = np.random.default_rng(5)
    got = {}
    for accum in (torch.float32, torch.float64):
        spec = sa.WindowKernelSpec(
            components=tuple(sa.components_for([("sum", 0)])),
            num_value_cols=1, window_slots=4, group_capacity=128,
            length_ms=1000, slide_ms=1000, accum_dtype=accum)
        stripe = HostPartialStripe(spec, 128)
        vals = rng.normal(1e9, 3.0, (5000, 1)) if not got else vals
        stripe.add_batch(np.zeros(5000, np.int64), np.zeros(5000, np.int32),
                         np.arange(5000, dtype=np.int32) % 7, vals, None,
                         None)
        taken = stripe.take_packed(0)
        host = {c.label: np.zeros((4, 128), np.float32)
                for c in spec.components}
        host["count_star"] = host["count_star"].astype(np.int32)
        branch, ring, _want = _host_fold(host_lib, spec, stripe.SUB, taken,
                                         128, 0, host)
        assert branch == "tumbling"
        got[accum] = ring["sum_0"][0, :7].numpy().astype(np.float64)
    exact = np.array([vals[np.arange(5000) % 7 == g, 0].sum()
                      for g in range(7)])
    assert np.abs(got[torch.float64] / exact - 1).max() < 1e-13
    assert np.abs(got[torch.float32] / exact - 1).max() > 1e-9
