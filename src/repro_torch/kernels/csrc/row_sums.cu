// ELL gather row sums of one corpus:
//
//   out[r] = sum_k freq[r, k] * w[src[r, k]]
//
// over a [rows, W] plan (padding: src = 0, freq = 0; W need not be a power
// of two).
//
// Replaces the Pallas TPU kernel ell_row_sums_pallas
// (src/repro/kernels/propagate.py, _kernel).  It is the masked frontier
// round of propagate_batched.cu without the corpus axis, the active gate
// and the seen counter.
//
// Bound on the H100: bytes.  A call reads the whole plan's freq (4 bytes an
// entry, it tells edges from padding), src of the real edges, each gathered
// weight and writes one float a row, for one multiply-add an entry.
//
// Design: a group of lanes = min(32, W rounded down to a power of two)
// threads owns a row and reads its W entries as consecutive addresses
// (coalesced); padding (freq == 0) skips the gather of w; the group folds
// its partial sums with shuffles (ell_common.cuh).  The TPU kernel's
// weight-chunk grid axis existed only to fit VMEM and is gone: the card
// gathers w straight from device memory / L2.  On the engine path every
// value is integer-valued float32 below 2^24, so any summation order gives
// the plain version's result bit for bit.
//
// Launch shape: `threads` a block (a multiple of 32 up to 1024; 256 unless
// the autotuner's table says otherwise, kernels/autotune.py).
#include <cuda_runtime.h>

#include "ell_common.cuh"

namespace {

__global__ void ell_row_sums_kernel(const float* __restrict__ w,
                                    const int* __restrict__ src,
                                    const float* __restrict__ freq,
                                    float* __restrict__ out, long long rows,
                                    int k, int lanes) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = tid / lanes;
  const int lane = static_cast<int>(tid % lanes);
  const bool live = row < rows;
  const float d =
      repro::ell_row_dot(w, src, freq, row * k, k, lane, lanes, live);
  if (live && lane == 0) out[row] = d;
}

}  // namespace

extern "C" int repro_ell_row_sums(const void* w, const void* src,
                                  const void* freq, void* out, int rows,
                                  int k, int lanes, int threads,
                                  void* stream) {
  if (rows == 0) return 0;
  if (threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      (static_cast<long long>(rows) * lanes + threads - 1) / threads;
  ell_row_sums_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int*>(src),
      static_cast<const float*>(freq), static_cast<float*>(out), rows, k,
      lanes);
  return static_cast<int>(cudaGetLastError());
}
