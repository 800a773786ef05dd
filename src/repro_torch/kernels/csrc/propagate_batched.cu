// One masked frontier round over the dense ELL plan, for N corpora at once.
//
// Replaces the Pallas TPU kernel ell_propagate_batched_pallas
// (src/repro/kernels/propagate_batched.py, _kernel):
//
//   delta[n, r] = sum_k freq[n,r,k] * w[n, src[n,r,k]] * active[n, src[n,r,k]]
//   seen[n, r]  = sum_k [freq[n,r,k] > 0] * active[n, src[n,r,k]]
//
// Bound on the H100: bytes.  The round reads the whole plan (8 bytes per
// entry: int32 src + float32 freq) once and does two multiply-adds per
// entry, far below the card's ratio of operations to bytes; the gathers of
// w/active hit a vector of R floats per corpus that stays in L2.
//
// Design: a group of lanes = min(32, K rounded down to a power of two)
// threads per (corpus, row) reads the row's K entries as consecutive
// addresses (coalesced), skips padding and inactive sources without
// touching w, and folds with shuffles (ell_common.cuh).  Both outputs come
// out of the same pass, so the plan is read once per round.  The TPU
// kernel's weight-chunk grid axis existed only to fit VMEM and is gone:
// the card gathers straight from device memory / L2.  Values on the engine
// path are integer-valued float32 below 2^24, so any summation order is
// exact and the result equals the plain version bit for bit.
//
// Launch shape: `threads` a block (a multiple of 32 up to 1024; 256 unless
// the autotuner's table says otherwise, kernels/autotune.py).
#include <cuda_runtime.h>

#include "ell_common.cuh"

namespace {

__global__ void ell_propagate_batched_kernel(
    const float* __restrict__ w, const float* __restrict__ active,
    const int* __restrict__ src, const float* __restrict__ freq,
    float* __restrict__ delta, float* __restrict__ seen, int R, int rows,
    int k, int lanes, long long total_rows) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = tid / lanes;          // flat (corpus, row) index
  const int lane = static_cast<int>(tid % lanes);
  const bool live = row < total_rows;
  const long long corpus = live ? row / rows : 0;
  float d, s;
  repro::ell_row_gather(w + corpus * R, active + corpus * R, src, freq,
                        row * k, k, lane, lanes, live, &d, &s);
  if (live && lane == 0) {
    delta[row] = d;
    seen[row] = s;
  }
}

}  // namespace

extern "C" int repro_ell_propagate_batched(
    const void* w, const void* active, const void* src, const void* freq,
    void* delta, void* seen, int n, int R, int rows, int k, int lanes,
    int threads, void* stream) {
  const long long total_rows = static_cast<long long>(n) * rows;
  if (total_rows == 0) return 0;
  if (threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (total_rows * lanes + threads - 1) / threads;
  ell_propagate_batched_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(active),
      static_cast<const int*>(src), static_cast<const float*>(freq),
      static_cast<float*>(delta), static_cast<float*>(seen), R, rows, k,
      lanes, total_rows);
  return static_cast<int>(cudaGetLastError());
}
