// One vector-payload round over the dense ELL plan (per-file traversals).
//
// Replaces the Pallas TPU kernel ell_propagate_vector_pallas
// (src/repro/kernels/propagate_vector.py, _kernel):
//
//   delta[n, r, f] = sum_k freq[n,r,k] * active[n, src] * W[n, src, f]
//   seen[n, r]     = sum_k [freq[n,r,k] > 0] * active[n, src]
//
// Bound on the H100: bytes — the rows of W gathered for the active sources
// (F floats each) and the output delta (F floats per row) dominate; the plan
// is read once.
//
// Design: F is the contiguous, coalesced axis.  A block is
// (fl threads over f) x (rows_per_block rows); for one plan entry the fl
// threads of a row read W[n, src, f0:f0+fl] as consecutive addresses, and
// the entry's src/freq is one broadcast load.  Padding and inactive sources
// are skipped before W is touched.  `seen` is accumulated once per row, by
// the row's f-lane 0 on the first f chunk.  The TPU kernel's rule-chunk and
// F-block grid axes existed to fit VMEM and are gone.
#include <cuda_runtime.h>

namespace {

__global__ void ell_propagate_vector_kernel(
    const float* __restrict__ W, const float* __restrict__ active,
    const int* __restrict__ src, const float* __restrict__ freq,
    float* __restrict__ delta, float* __restrict__ seen, int R, int rows,
    int k, int F) {
  const int c = blockIdx.y;
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const float* Wc = W + static_cast<long long>(c) * R * F;
  const float* ac = active + static_cast<long long>(c) * R;
  const long long row = static_cast<long long>(c) * rows + r;
  const long long base = row * k;
  float s = 0.f;
  for (int f0 = 0; f0 < F; f0 += blockDim.x) {
    const int f = f0 + threadIdx.x;
    float d = 0.f;
    for (int j = 0; j < k; ++j) {
      const float q = freq[base + j];
      if (q == 0.f) continue;
      const int p = src[base + j];
      const float a = ac[p];
      if (a == 0.f) continue;
      if (f0 == 0 && q > 0.f) s += a;
      if (f < F) d += q * a * Wc[static_cast<long long>(p) * F + f];
    }
    if (f < F) delta[row * F + f] = d;
  }
  if (threadIdx.x == 0) seen[row] = s;
}

}  // namespace

extern "C" int repro_ell_propagate_vector(
    const void* W, const void* active, const void* src, const void* freq,
    void* delta, void* seen, int n, int R, int rows, int k, int F, int fl,
    void* stream) {
  if (n == 0 || rows == 0) return 0;
  const int rows_per_block = fl >= 256 ? 1 : 256 / fl;
  const dim3 block(fl, rows_per_block);
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block, n);
  ell_propagate_vector_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(active),
      static_cast<const int*>(src), static_cast<const float*>(freq),
      static_cast<float*>(delta), static_cast<float*>(seen), R, rows, k, F);
  return static_cast<int>(cudaGetLastError());
}
