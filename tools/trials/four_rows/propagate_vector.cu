// Trial variant of csrc/propagate_vector.cu (same C entry point, same
// results): where the wrapper asks for 8 entries a lane and K is a
// multiple of 16 above 64, each lane reads 16 entries (four 16-byte
// loads) and a warp owns 32 / (K / 16) rows: four rows of K=128 in place
// of two, so the subset's 16,384 rows take 512 blocks, one wave at four
// blocks a SM, and each lane has twice the independent loads in flight.
// tools/kernel_ab.py times it against the kernel it varies.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;          // warps per block

// EPL: plan entries a lane reads per chunk — 8 as two 16-byte loads
// (K % 8 == 0, freq 16-byte aligned), else 1.  VW: W rows gathered and
// delta rows written 16 bytes a lane (F % 4 == 0, W 16-byte aligned; delta
// is allocated aligned).
template <int EPL, bool VW>
__global__ void __launch_bounds__(kWarps * 32)
ell_propagate_vector_kernel(
    const float* __restrict__ W, const float* __restrict__ active,
    const int* __restrict__ src, const float* __restrict__ freq,
    float* __restrict__ delta, float* __restrict__ seen, int R,
    unsigned rows, unsigned total_rows, int k, int F, int G, int L) {
  constexpr int VWN = VW ? 4 : 1;      // W columns per lane and entry
  __shared__ int s_src[kWarps][32 * EPL];
  __shared__ float s_c[kWarps][32 * EPL];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rw = 32 / G;                       // rows of this warp
  const int grp = lane / G, gl = lane % G;     // row pass: row, lane in it
  const int seg = G * EPL;                     // list capacity of a row
  const unsigned lt = (1u << lane) - 1u;       // lanes below this one
  const unsigned row0 = (blockIdx.x * kWarps + warp) * rw;
  if (row0 >= total_rows) return;              // whole warp exits together

  // the row this lane reads in the row pass
  const unsigned my_row = row0 + grp;
  const bool my_valid = my_row < total_rows;
  const float* my_active =
      active + static_cast<long long>(my_valid ? my_row / rows : 0) * R;
  const long long my_base = static_cast<long long>(my_row) * k;
  const unsigned my_gm =
      G == 32 ? kFull : (((1u << G) - 1u) << (grp * G));

  // the gather: `pass` rows at a time, `spr` entry slots of L lanes each
  // per row; this lane serves row `prow` of a pass, slot `ps`, columns
  // from `sub`
  const int slots = 32 / L;
  const int pass = rw < slots ? rw : slots;
  const int spr = slots / pass;
  const int slot = lane / L, sub = lane % L;
  const int prow = slot / spr, ps = slot % spr;
  const int fold = L * spr;                    // a row's lanes, aligned
  const int fw = VWN * L;                      // columns a pass covers
  float s = 0.f;                               // this lane's row's seen

  for (int f0 = 0; f0 < F; f0 += fw) {
    const int f = f0 + sub * VWN;
    float acc[VWN];
#pragma unroll
    for (int v = 0; v < VWN; ++v) acc[v] = 0.f;
    bool gathered = false;                     // uniform over the warp
    for (int k0 = 0; k0 < k; k0 += seg) {
      // 1. row pass: freq, then src of live entries, then active
      float q[EPL];
      const int kk = k0 + gl * EPL;
      if constexpr (EPL >= 8) {
#pragma unroll
        for (int h = 0; h < EPL; h += 4) {
          float4 q4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (my_valid && kk < k)
            q4 = *reinterpret_cast<const float4*>(freq + my_base + kk + h);
          q[h] = q4.x; q[h + 1] = q4.y; q[h + 2] = q4.z; q[h + 3] = q4.w;
        }
      } else {
        q[0] = (my_valid && kk < k) ? freq[my_base + kk] : 0.f;
      }
      int p[EPL];
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        p[j] = q[j] != 0.f ? src[my_base + kk + j] : 0;
      float a[EPL];
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        a[j] = q[j] != 0.f ? my_active[p[j]] : 0.f;
      // 2. compaction of the live, active entries into the shared list
      unsigned bal[EPL];
      int before = 0;
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const bool take = a[j] != 0.f;
        bal[j] = __ballot_sync(kFull, take);
        if (take) {
          const int pos = grp * seg + before + __popc(bal[j] & my_gm & lt);
          s_src[warp][pos] = p[j];
          s_c[warp][pos] = q[j] * a[j];
        }
        before += __popc(bal[j] & my_gm);
        if (f0 == 0 && q[j] > 0.f) s += a[j];
      }
      __syncwarp();
      // 3. gather, `pass` rows at a time, each with its own lanes
      const bool last = k0 + seg >= k;
      for (int i0 = 0; i0 < rw; i0 += pass) {
        const int i = i0 + prow;
        const unsigned row = row0 + i;
        const unsigned gm = G == 32 ? kFull : (((1u << G) - 1u) << (i * G));
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < EPL; ++j) cnt += __popc(bal[j] & gm);
        gathered = __any_sync(kFull, cnt > 0) || gathered;
        if (cnt > 0 && f < F) {
          const float* Wn = W + static_cast<long long>(row / rows) * R * F;
          for (int t = ps; t < cnt; t += spr) {
            const int pe = s_src[warp][i * seg + t];
            const float c = s_c[warp][i * seg + t];
            const float* wp = Wn + static_cast<long long>(pe) * F + f;
            if constexpr (VW) {
              const float4 w4 = *reinterpret_cast<const float4*>(wp);
              acc[0] += c * w4.x;
              acc[1] += c * w4.y;
              acc[2] += c * w4.z;
              acc[3] += c * w4.w;
            } else {
              acc[0] += c * *wp;
            }
          }
        }
        if (last) {
          // fold a row's slots (rows with nothing gathered hold zeros);
          // its slot 0 writes the row's columns
          if (gathered) {
#pragma unroll
            for (int v = 0; v < VWN; ++v)
              for (int off = L; off < fold; off <<= 1)
                acc[v] += __shfl_xor_sync(kFull, acc[v], off);
          }
          if (ps == 0 && f < F && row < total_rows) {
            float* out = delta + static_cast<long long>(row) * F + f;
            if constexpr (VW)
              *reinterpret_cast<float4*>(out) =
                  make_float4(acc[0], acc[1], acc[2], acc[3]);
            else
              *out = acc[0];
          }
#pragma unroll
          for (int v = 0; v < VWN; ++v) acc[v] = 0.f;
          gathered = false;
        }
      }
      __syncwarp();
    }
  }
  // seen: the group's sum over its lanes
  for (int off = G >> 1; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  if (gl == 0 && my_valid) seen[my_row] = s;
}

template <int EPL, bool VW>
cudaError_t launch(const void* W, const void* active, const void* src,
                   const void* freq, void* delta, void* seen, int n, int R,
                   int rows, int k, int F, int G, int L,
                   cudaStream_t stream) {
  const unsigned total = static_cast<unsigned>(n) * rows;
  const unsigned per_block = kWarps * (32 / G);
  const unsigned blocks = (total + per_block - 1) / per_block;
  ell_propagate_vector_kernel<EPL, VW>
      <<<blocks, kWarps * 32, 0, stream>>>(
          static_cast<const float*>(W), static_cast<const float*>(active),
          static_cast<const int*>(src), static_cast<const float*>(freq),
          static_cast<float*>(delta), static_cast<float*>(seen), R, rows,
          total, k, F, G, L);
  return cudaGetLastError();
}

}  // namespace

// epl: the plan entries a lane reads per chunk (8 where the caller found
// K % 8 == 0 and freq 16-byte aligned, else 1); vw: 1 where F % 4 == 0 and
// W is 16-byte aligned; G, L: the lanes a row takes in the row pass and
// the lanes an entry takes in the gather (powers of two <= 32, from the
// wrapper).  N * rows < 2^31.
extern "C" int repro_ell_propagate_vector(
    const void* W, const void* active, const void* src, const void* freq,
    void* delta, void* seen, int n, int R, int rows, int k, int F, int G,
    int L, int epl, int vw, void* stream) {
  if (n == 0 || rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (epl == 8 && k % 16 == 0 && k > 64) {
    int g = 1;
    while (g < k / 16 && g < 32) g <<= 1;
    err = vw ? launch<16, true>(W, active, src, freq, delta, seen, n, R,
                                rows, k, F, g, L, st)
             : launch<16, false>(W, active, src, freq, delta, seen, n, R,
                                 rows, k, F, g, L, st);
  } else if (epl == 8)
    err = vw ? launch<8, true>(W, active, src, freq, delta, seen, n, R, rows,
                               k, F, G, L, st)
             : launch<8, false>(W, active, src, freq, delta, seen, n, R,
                                rows, k, F, G, L, st);
  else
    err = vw ? launch<1, true>(W, active, src, freq, delta, seen, n, R, rows,
                               k, F, G, L, st)
             : launch<1, false>(W, active, src, freq, delta, seen, n, R,
                                rows, k, F, G, L, st);
  return static_cast<int>(err);
}
