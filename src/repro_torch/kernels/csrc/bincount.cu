// Weighted histogram over a batch of rows: out[i * nbins + b] =
// sum(vals[i, t] for ids[i, t] == b); ids outside [0, nbins) are skipped
// (-1 is padding).  The 1-D histogram is the batch of one row.
//
// Replaces the Pallas TPU kernel weighted_bincount_pallas
// (src/repro/kernels/bincount.py, _kernel), which had no atomics and turned
// the scatter into one-hot matmuls on the MXU, and the flat-offset ids the
// JAX package builds before it for a batch.  The card has atomics, so this
// is the paper's own form (G-TADOC section IV-C): float atomicAdd of each
// value into its bin.
//
// Bound on the H100: bytes — each id and value read once and each bin
// written once.  What holds it above that: the word tables are Zipfian, so
// atomics to the hot bins of a row serialise in L2.  Design:
//   - the entry point zeroes the output with cudaMemsetAsync on the
//     caller's stream (no separate fill from the wrapper), then launches one
//     kernel for the whole batch: a block takes 512-element pieces of a
//     row, so no id needs a per-row offset computed outside;
//   - a lane takes two elements a step, 256 apart, so each load
//     instruction of a warp reads 128 (int32) or 256 (int64) contiguous
//     bytes.  On the card this ran no slower than one 8- or 16-byte vector
//     load a lane, and two elements a lane faster than four: each element
//     is one round of the warp aggregation below;
//   - warp aggregation: __match_any_sync groups the lanes that hit the same
//     bin, the group's values are summed with shuffles, and its lowest lane
//     makes the one atomic (one atomic per distinct bin per warp and step);
//   - zero values and ids outside [0, nbins) take no atomic.
// All values on the engine path are integer-valued float32 below 2^24, so
// the order of the additions cannot change the result.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kEPT = 2;                    // elements a thread and step
constexpr int kPiece = kThreads * kEPT;    // elements a block step takes

// Sum `v` over the lanes holding the same `key` and add it into
// row_out[key] once, from the group's lowest lane.  Every lane of the warp
// calls this; a lane with nothing to add passes a key of its own (< 0).
__device__ __forceinline__ void aggregate_add(float* row_out, int key,
                                              float v, int lane) {
  const unsigned peers = __match_any_sync(kFull, key);
  const unsigned most = __reduce_max_sync(kFull, __popc(peers));
  float s = v;
  unsigned others = peers & ~(1u << lane);
  for (unsigned t = 1; t < most; ++t) {
    const int from = others ? __ffs(others) - 1 : lane;
    const float o = __shfl_sync(kFull, v, from);
    if (others) {
      s += o;
      others &= others - 1u;
    }
  }
  if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(row_out + key, s);
}

// A lane's key for one element: the bin, or a negative key of its own
// when the element takes no atomic.
template <typename Id>
__device__ __forceinline__ int bin_key(Id id, float v, int nbins,
                                       int lane) {
  const bool take = id >= 0 && id < static_cast<Id>(nbins) && v != 0.f;
  return take ? static_cast<int>(id) : -1 - lane;
}

template <typename Id>
__global__ void __launch_bounds__(kThreads)
weighted_bincount_kernel(const Id* __restrict__ ids,
                         const float* __restrict__ vals,
                         float* __restrict__ out, long long t_len,
                         long long pieces_per_row, long long pieces,
                         int nbins) {
  const int lane = threadIdx.x & 31;
  for (long long pc = blockIdx.x; pc < pieces; pc += gridDim.x) {
    const long long row = pc / pieces_per_row;
    const long long start = (pc % pieces_per_row) * kPiece;
    const Id* rid = ids + row * t_len;
    const float* rv = vals + row * t_len;
    float* row_out = out + row * static_cast<long long>(nbins);
    Id id[kEPT];
    float v[kEPT];
#pragma unroll
    for (int j = 0; j < kEPT; ++j) {
      const long long e = start + j * kThreads + threadIdx.x;
      const bool in = e < t_len;
      id[j] = in ? rid[e] : Id(-1);
      v[j] = in ? rv[e] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kEPT; ++j)
      aggregate_add(row_out, bin_key(id[j], v[j], nbins, lane), v[j], lane);
  }
}

template <typename Id>
cudaError_t launch(const void* ids, const void* vals, void* out,
                   long long rows, long long t_len, int nbins,
                   cudaStream_t stream) {
  const long long ppr = (t_len + kPiece - 1) / kPiece;
  const long long pieces = rows * ppr;
  long long blocks = pieces;
  if (blocks > 132 * 16) blocks = 132 * 16;     // grid-stride beyond that
  weighted_bincount_kernel<Id>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const Id*>(ids), static_cast<const float*>(vals),
          static_cast<float*>(out), t_len, ppr, pieces, nbins);
  return cudaGetLastError();
}

}  // namespace

// ids: [rows, t_len] int32 (id_bytes 4) or int64 (id_bytes 8); vals:
// [rows, t_len] float32; out: [rows, nbins] float32, zeroed here.
extern "C" int repro_weighted_bincount(const void* ids, const void* vals,
                                       void* out, long long rows,
                                       long long t_len, int nbins,
                                       int id_bytes, void* stream) {
  if (rows == 0 || nbins == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(rows) * nbins * sizeof(float), st);
  if (err != cudaSuccess || t_len == 0) return static_cast<int>(err);
  err = id_bytes == 8
            ? launch<long long>(ids, vals, out, rows, t_len, nbins, st)
            : launch<int>(ids, vals, out, rows, t_len, nbins, st);
  return static_cast<int>(err);
}
