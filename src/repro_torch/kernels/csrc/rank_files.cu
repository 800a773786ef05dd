// Per-word file ranking of the ranked inverted index: for every word v of
// corpus i, the files f < num_files[i] ordered by tv[i, v, f] descending,
// ties to the lower file id, written as the row v of corpus i's
// [vocab_size[i], num_files[i]] file ids (int32) and the counts aligned to
// them (float32).
//
// Replaces no Pallas kernel: the JAX package ranks with jnp.argsort
// (src/repro/core/batch.py), and the port first did the same with torch's
// stable argsort over a transposed [F, V] term vector, one segment of F
// elements a word, each V floats apart, then a gather and a cast.  Here the
// term vector is read in the layout its segment sum writes, [N, V_pad,
// F_pad], where a word's F_pad counts sit next to each other.
//
// Bound on the H100: bytes — each real count read once, each id and count
// written once (no arithmetic on the values, so the output is bit-exact by
// construction).  Design:
//   - each count becomes an unsigned key whose order is the float order
//     (-0.0 equal to +0.0, NaN below every number, as a stable sort of the
//     negated counts places them), and 0 for a lane with no real file;
//   - a file's rank is the count of the word's keys above its own plus the
//     keys equal to it of lower file ids; the lane holding the file then
//     stores its id and count at that rank in the word's output row, so
//     the stores of a word fill one contiguous row;
//   - F_pad <= 32 (rank_files_kernel): a group of G lanes takes one word,
//     G the power of two at or above F_pad, so a warp takes 32 / G words a
//     step and its loads read consecutive words' rows: 32 * 4 contiguous
//     bytes when F_pad is a power of two; padded files (f >=
//     num_files[i]) and lanes past F_pad load nothing.  A lane counts the
//     keys above its own in G __shfl_sync reads and its equal keys of
//     lower file ids in one __match_any_sync; a warp loads kUnroll steps
//     before it ranks any, so that several rows are in flight a warp;
//   - F_pad > 32 (rank_files_wide_kernel): a warp takes one word and ranks
//     its real files 32 at a time; for each such chunk it reads the row
//     again chunk by chunk (from L1 after the first pass) and counts, in
//     32 __shfl_sync reads a chunk, the keys above its own, with the equal
//     keys of an earlier chunk's files counted too, and the equal keys of
//     its own chunk's lower lanes in one __match_any_sync.  That is
//     ceil(F / 32)^2 * 32 shuffles a lane a word: quadratic in the files,
//     as the dense [V, F] answer already bounds F;
//   - the grid is [blocks, corpora]: blockIdx.y picks the corpus (its
//     vocabulary, file count and output offset come in the launch's
//     parameters, up to kMaxCorpora corpora a launch), and the blocks of a
//     corpus stride over its words.
//
// Launch shape: kThreads a block; G is a template argument instantiated
// for 1, 2, 4, 8, 16 and 32.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                 // steps a warp loads at once
constexpr int kMaxCorpora = 128;           // corpora a launch
constexpr long long kMaxBlocks = 132 * 16;  // grid-stride beyond that

struct Corpora {
  long long vocab[kMaxCorpora];            // words to rank, per corpus
  long long out_start[kMaxCorpora];        // first entry of its output
  int num_files[kMaxCorpora];              // real files, per corpus
};

// The count as an unsigned key in the order of the float values; 0 is
// left for lanes with no real file.
__device__ __forceinline__ unsigned order_key(float x) {
  if (x != x) return 1u;                   // NaN ranks after every number
  const unsigned b = __float_as_uint(x + 0.0f);  // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <int G>
__global__ void __launch_bounds__(kThreads)
rank_files_kernel(const float* __restrict__ tv, int* __restrict__ ids,
                  float* __restrict__ counts, long long v_pad, int f_pad,
                  int row0, const Corpora c) {
  constexpr int kWords = 32 / G;           // words a warp takes a step
  const int corpus = blockIdx.y;
  const long long vocab = c.vocab[corpus];
  const int nf = c.num_files[corpus];
  if (nf == 0) return;                     // the whole block leaves
  const int lane = threadIdx.x & 31;
  const int f = lane & (G - 1);
  const int sub = lane / G;
  const unsigned group =
      G == 32 ? kFull : ((1u << (G & 31)) - 1u) << (sub * G);
  const unsigned below = (1u << lane) - 1u;
  const float* rows =
      tv + static_cast<long long>(row0 + corpus) * v_pad * f_pad;
  int* row_ids = ids + c.out_start[corpus];
  float* row_counts = counts + c.out_start[corpus];
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps =
      (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long base = warp * kWords * kUnroll; base < vocab;
       base += warps * kWords * kUnroll) {
    float cnt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + u * kWords + sub;
      cnt[u] = (v < vocab && f < nf) ? rows[v * f_pad + f] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = base + u * kWords + sub;
      const bool real = v < vocab && f < nf;
      const unsigned key = real ? order_key(cnt[u]) : 0u;
      int rank = 0;
#pragma unroll
      for (int j = 0; j < G; ++j)
        rank += __shfl_sync(kFull, key, j, G) > key;
      rank += __popc(__match_any_sync(kFull, key) & group & below);
      if (real) {
        const long long o = v * nf + rank;
        row_ids[o] = f;
        row_counts[o] = cnt[u];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rank_files_wide_kernel(const float* __restrict__ tv, int* __restrict__ ids,
                       float* __restrict__ counts, long long v_pad,
                       int f_pad, int row0, const Corpora c) {
  const int corpus = blockIdx.y;
  const long long vocab = c.vocab[corpus];
  const int nf = c.num_files[corpus];
  if (nf == 0) return;                     // the whole block leaves
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int chunks = (nf + 31) / 32;
  const float* rows =
      tv + static_cast<long long>(row0 + corpus) * v_pad * f_pad;
  int* row_ids = ids + c.out_start[corpus];
  float* row_counts = counts + c.out_start[corpus];
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps =
      (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long v = warp; v < vocab; v += warps) {
    const float* row = rows + v * f_pad;
    for (int own = 0; own < chunks; ++own) {
      const int f = own * 32 + lane;
      const bool real = f < nf;
      const float cnt = real ? row[f] : 0.f;
      const unsigned key = real ? order_key(cnt) : 0u;
      int rank = __popc(__match_any_sync(kFull, key) & below);
      for (int d = 0; d < chunks; ++d) {
        const int g = d * 32 + lane;
        const unsigned other =
            d == own ? key : (g < nf ? order_key(row[g]) : 0u);
        // an earlier chunk's files are lower: its equal keys count too
        // (a real key is at least 1; a lane with no file stores nothing)
        const unsigned above = d < own ? key - 1u : key;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          rank += __shfl_sync(kFull, other, j) > above;
      }
      if (real) {
        const long long o = v * nf + rank;
        row_ids[o] = f;
        row_counts[o] = cnt;
      }
    }
  }
}

// Blocks a corpus for words_per_block words a block, capped so that the
// grid of n corpora stays near kMaxBlocks (the blocks then stride).
dim3 grid_for(long long max_vocab, long long words_per_block, int n) {
  long long bx = (max_vocab + words_per_block - 1) / words_per_block;
  const long long cap = kMaxBlocks / n > 0 ? kMaxBlocks / n : 1;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(n));
}

template <int G>
cudaError_t launch(const float* tv, int* ids, float* counts,
                   long long v_pad, int f_pad, int row0, int n,
                   long long max_vocab, const Corpora& c,
                   cudaStream_t stream) {
  constexpr long long kPerBlock = (kThreads / 32) * (32 / G) * kUnroll;
  rank_files_kernel<G><<<grid_for(max_vocab, kPerBlock, n), kThreads, 0,
                         stream>>>(tv, ids, counts, v_pad, f_pad, row0, c);
  return cudaGetLastError();
}

cudaError_t launch_group(int g, const float* tv, int* ids, float* counts,
                         long long v_pad, int f_pad, int row0, int n,
                         long long max_vocab, const Corpora& c,
                         cudaStream_t st) {
  switch (g) {
    case 1:
      return launch<1>(tv, ids, counts, v_pad, f_pad, row0, n, max_vocab,
                       c, st);
    case 2:
      return launch<2>(tv, ids, counts, v_pad, f_pad, row0, n, max_vocab,
                       c, st);
    case 4:
      return launch<4>(tv, ids, counts, v_pad, f_pad, row0, n, max_vocab,
                       c, st);
    case 8:
      return launch<8>(tv, ids, counts, v_pad, f_pad, row0, n, max_vocab,
                       c, st);
    case 16:
      return launch<16>(tv, ids, counts, v_pad, f_pad, row0, n, max_vocab,
                        c, st);
    case 32:
      return launch<32>(tv, ids, counts, v_pad, f_pad, row0, n, max_vocab,
                        c, st);
    default:
      rank_files_wide_kernel<<<grid_for(max_vocab, kThreads / 32, n),
                               kThreads, 0, st>>>(tv, ids, counts, v_pad,
                                                  f_pad, row0, c);
      return cudaGetLastError();
  }
}

}  // namespace

// tv: [n, v_pad, f_pad] float32, f_pad >= 1; vocab, num_files: host
// arrays of n entries (vocab[i] <= v_pad, num_files[i] <= f_pad); ids,
// counts: sum(vocab[i] * num_files[i]) entries, corpus i's [vocab[i],
// num_files[i]] rows after those of the corpora before it.  One launch for
// each kMaxCorpora corpora.
extern "C" int repro_rank_files(const void* tv, void* ids, void* counts,
                                const long long* vocab,
                                const int* num_files, int n,
                                long long v_pad, int f_pad, void* stream) {
  if (f_pad < 1) return static_cast<int>(cudaErrorInvalidValue);
  int g = 1;                               // past 32: the wide kernel
  while (g < f_pad) g <<= 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long out = 0;
  for (int row0 = 0; row0 < n; row0 += kMaxCorpora) {
    const int m = n - row0 < kMaxCorpora ? n - row0 : kMaxCorpora;
    Corpora c;
    long long max_vocab = 0;
    for (int i = 0; i < m; ++i) {
      c.vocab[i] = vocab[row0 + i];
      c.num_files[i] = num_files[row0 + i];
      c.out_start[i] = out;
      out += c.vocab[i] * c.num_files[i];
      if (c.vocab[i] > max_vocab) max_vocab = c.vocab[i];
    }
    const cudaError_t err = launch_group(
        g, static_cast<const float*>(tv), static_cast<int*>(ids),
        static_cast<float*>(counts), v_pad, f_pad, row0, m, max_vocab, c,
        st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
