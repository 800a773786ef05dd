// The whole ELL frontier traversal in one launch: one thread block per
// corpus loops over the rounds inside the kernel.
//
// Replaces the Pallas TPU kernel ell_frontier_fused_pallas
// (src/repro/kernels/propagate_fused.py, _kernel).  Each round:
//
//   phase A  (delta, seen) of every row: the masked gather + row sum of
//            propagate_batched.cu, into device-memory scratch;
//   barrier;
//   phase B  w += delta; cur += seen;
//            ready = (cur == in_deg) & ~ever; mask = ready; ever |= ready;
//   barrier that also ORs "any row ready" across the block; the loop stops
//   when nothing became ready, or after max_rounds rounds (the DAG's level
//   count, which is exact).
//
// rounds[n] counts the rounds corpus n executed with a non-empty frontier,
// exactly like the plain version's counter.  The kernel covers every row
// itself (no row-block padding), so there are no padded rows to keep inert
// with in_deg = -1 as the TPU kernel's wrapper must.
//
// Bound on the H100: bytes — every round re-reads the corpus's plan
// (8 bytes per entry) and the state vectors.  The design leaves most of the
// card idle: one block per corpus on N of its 132 SMs, because the rounds
// are dependent and a block barrier is the only synchronisation that needs
// no second launch.  The state (24 bytes per rule) is too large for shared
// memory at the engine's rule counts, so it lives in device memory / L2
// (the TPU kept it in VMEM).  A cluster or cooperative-grid form that
// spreads a corpus over many SMs is later work.
#include <cuda_runtime.h>

#include "ell_common.cuh"

namespace {

__global__ void ell_frontier_fused_kernel(
    const float* __restrict__ w0, const float* __restrict__ in_deg,
    const int* __restrict__ src, const float* __restrict__ freq, float* w,
    float* cur, float* mask, float* ever, float* delta, float* seen,
    int* __restrict__ rounds_out, int R, int k, int lanes, int max_rounds) {
  const long long off = static_cast<long long>(blockIdx.x) * R;
  in_deg += off;
  w0 += off;
  w += off;
  cur += off;
  mask += off;
  ever += off;
  delta += off;
  seen += off;
  const long long plan = off * k;

  int any = 0;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float m0 = in_deg[r] == 0.f ? 1.f : 0.f;
    w[r] = w0[r];
    cur[r] = 0.f;
    mask[r] = m0;
    ever[r] = m0;
    any |= m0 != 0.f;
  }
  int active = __syncthreads_or(any);

  const int groups = blockDim.x / lanes;
  const int group = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  int rounds = 0;
  for (int t = 0; t < max_rounds && active; ++t) {
    ++rounds;
    // phase A: the loop bound is uniform across the block, so every warp
    // reaches the shuffles with all its lanes
    for (int r0 = 0; r0 < R; r0 += groups) {
      const int r = r0 + group;
      float d, s;
      repro::ell_row_gather(w, mask, src, freq,
                            plan + static_cast<long long>(r) * k, k, lane,
                            lanes, r < R, &d, &s);
      if (r < R && lane == 0) {
        delta[r] = d;
        seen[r] = s;
      }
    }
    __syncthreads();
    // phase B: each thread updates only its own rows
    any = 0;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      w[r] += delta[r];
      const float c = cur[r] + seen[r];
      const float ready = (c == in_deg[r] && ever[r] == 0.f) ? 1.f : 0.f;
      cur[r] = c;
      mask[r] = ready;
      ever[r] += ready;
      any |= ready != 0.f;
    }
    active = __syncthreads_or(any);
  }
  if (threadIdx.x == 0) rounds_out[blockIdx.x] = rounds;
}

}  // namespace

extern "C" int repro_ell_frontier_fused(
    const void* w0, const void* in_deg, const void* src, const void* freq,
    void* w, void* scratch, void* rounds, int n, int R, int k, int lanes,
    int max_rounds, void* stream) {
  if (n == 0 || R == 0) return 0;
  // scratch holds five [n, R] float32 planes: cur, mask, ever, delta, seen
  float* sc = static_cast<float*>(scratch);
  const long long plane = static_cast<long long>(n) * R;
  ell_frontier_fused_kernel<<<n, 1024, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w0), static_cast<const float*>(in_deg),
      static_cast<const int*>(src), static_cast<const float*>(freq),
      static_cast<float*>(w), sc, sc + plane, sc + 2 * plane, sc + 3 * plane,
      sc + 4 * plane, static_cast<int*>(rounds), R, k, lanes, max_rounds);
  return static_cast<int>(cudaGetLastError());
}
