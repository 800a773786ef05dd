// Shared device helpers of the ELL-plan kernels: the (masked) gather + row
// sum of one plan row.
//
// A plan row is K consecutive (src, freq) entries.  A group of `lanes`
// neighbouring threads (a power of two <= 32, so a group never straddles a
// warp) owns one row: lane j reads entries j, j+lanes, ... so a warp's loads
// of src/freq are consecutive addresses, and the group folds its partial
// sums with warp shuffles.  Entries with freq == 0 (plan padding) or an
// inactive source are skipped without touching the weight vector: their
// product is exactly 0 for finite weights, so skipping changes no sum.
#pragma once
#include <cuda_runtime.h>

namespace repro {

// Every lane of the warp must call this (the shuffles use the full mask);
// `live` false contributes zeros.  Returns the group's (delta, seen) on the
// group's lane 0.
__device__ __forceinline__ void ell_row_gather(
    const float* w, const float* active, const int* __restrict__ src,
    const float* __restrict__ freq, long long base, int k, int lane,
    int lanes, bool live, float* delta_out, float* seen_out) {
  float d = 0.f, s = 0.f;
  if (live) {
    for (int j = lane; j < k; j += lanes) {
      const float q = freq[base + j];
      if (q == 0.f) continue;
      const int p = src[base + j];
      const float a = active[p];
      if (a == 0.f) continue;
      d += q * w[p] * a;
      if (q > 0.f) s += a;
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    d += __shfl_down_sync(0xffffffffu, d, off, lanes);
    s += __shfl_down_sync(0xffffffffu, s, off, lanes);
  }
  *delta_out = d;
  *seen_out = s;
}

// The unmasked form: sum_k freq[base + k] * w[src[base + k]] of one plan
// row, with the same lane layout, padding skip and shuffle fold.  Every lane
// of the warp must call it; the group's sum lands on its lane 0.
__device__ __forceinline__ float ell_row_dot(const float* w,
                                             const int* __restrict__ src,
                                             const float* __restrict__ freq,
                                             long long base, int k, int lane,
                                             int lanes, bool live) {
  float d = 0.f;
  if (live) {
    for (int j = lane; j < k; j += lanes) {
      const float q = freq[base + j];
      if (q == 0.f) continue;
      d += q * w[src[base + j]];
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1)
    d += __shfl_down_sync(0xffffffffu, d, off, lanes);
  return d;
}

}  // namespace repro
