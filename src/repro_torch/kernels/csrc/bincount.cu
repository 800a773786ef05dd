// Weighted histogram: out[b] = sum(vals[ids == b]); ids outside [0, nbins)
// are skipped (-1 is padding).
//
// Replaces the Pallas TPU kernel weighted_bincount_pallas
// (src/repro/kernels/bincount.py, _kernel), which had no atomics and turned
// the scatter into one-hot matmuls on the MXU.  The card has atomics, so
// this is the paper's own form (G-TADOC section IV-C): a grid-stride loop
// of float atomicAdd into the output, which the wrapper zeroes.
//
// Bound on the H100: bytes — 8 bytes read per input element and 4 written
// per bin; atomics to hot bins (frequent words) serialise in L2, which is
// what can hold it above the bound.  Zero values are skipped (their add
// changes nothing), which keeps the padding of the packed word tables off
// the atomics.  All values on the engine path are integer-valued float32
// below 2^24, so the atomics' order cannot change the result.
#include <cuda_runtime.h>

namespace {

__global__ void weighted_bincount_kernel(const int* __restrict__ ids,
                                         const float* __restrict__ vals,
                                         float* __restrict__ out,
                                         long long n, int nbins) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int b = ids[i];
    const float v = vals[i];
    if (b >= 0 && b < nbins && v != 0.f) atomicAdd(out + b, v);
  }
}

}  // namespace

extern "C" int repro_weighted_bincount(const void* ids, const void* vals,
                                       void* out, long long n, int nbins,
                                       void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond that
  weighted_bincount_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(vals),
      static_cast<float*>(out), n, nbins);
  return static_cast<int>(cudaGetLastError());
}
