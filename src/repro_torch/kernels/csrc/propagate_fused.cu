// The whole ELL frontier traversal of N corpora in one persistent
// cooperative launch that spreads every corpus over every SM of the card.
//
// Replaces the Pallas TPU kernel ell_frontier_fused_pallas
// (src/repro/kernels/propagate_fused.py, _kernel), which keeps the state in
// VMEM and walks (corpus, round, row-block) as a sequential grid.  Here the
// dependent rounds are steps of one grid of co-resident blocks, separated
// by cooperative_groups grid syncs (CUDA 12 needs no -rdc for them):
//
//   phase 0  zero the control words; grid sync.  The one read of the
//            padded [N, R, K] plan: a group of lanes reads a row's `freq`
//            as consecutive 16-byte (or 4-byte) words and records the row's
//            live length (index of its last freq != 0 entry, plus one);
//            rows of at most kThreadRow live entries get their (freq, src)
//            head copied to a 32-byte stash, longer rows go on the warp
//            list (up to kWarpRow entries) or the block list.  Every row's
//            state is set: w = w0, cur = 0, mask = ever = (int(in_deg)
//            == 0), raising flag[0][n] when corpus n has a frontier.  Sync.
//   round t  (while t < max_rounds and some flag[t][n] is set) every row of
//            a still-active corpus gathers over its live entries only,
//            reading the state of round t and writing that of round t + 1
//            (w and mask are double-buffered, so one grid sync a round):
//              d = sum q * w_t[p] * mask_t[p],  s = #{q > 0, mask_t[p] != 0}
//              w_{t+1} = w_t + d;  cur += s;
//              ready = (cur == int(in_deg)) & !ever;  mask_{t+1} = ready;
//              ever |= ready;  a ready row raises flag[t+1][n]
//            Block-list rows are gathered by a block each, warp-list rows
//            by a warp (4 entries a lane), the rest by one thread each from
//            the stash.  Loads are staged (plan entries, then masks, then
//            weights) so each kind is in flight together.  Block 0 counts
//            rounds[n] += flag[t][n].  Grid sync.
//   epilogue corpus n's weights end in buffer rounds[n] & 1; odd ones are
//            copied back into the output (buffer 0).
//
// Why this shape (measured on the H100, PERF.md): real rows are short and
// skewed (mean in-degree ~2.2 against K = 512-1024, the longest rows
// 260-650 entries), so a round is a few microseconds of dependent gathers
// and a grid sync; one thread a short row keeps the whole card busy, and
// the lists keep a long row from being one thread's straggler.  The stash
// keeps the short rows' entries contiguous: read from the plan, each
// round's heads sat in a different DRAM page per row.  Each flag row holds
// a word per corpus, raised once per warp and block (the shared `seen`
// keys), because thousands of stores to one word queue at one L2 slice;
// the flag rows are never reset within a launch, and every block reads
// the same flags after a sync, so the loop bound agrees in every block.
// rounds[n] counts the rounds corpus n ran with a non-empty frontier, as
// the plain version does; a corpus whose frontier emptied skips its rows
// (its further rounds would add 0.0 everywhere).
//
// Bound on the H100: bytes — phase 0 reads all of `freq` once, coalesced,
// across the whole card; the rounds touch the live entries, the stash and
// the [N, R] state, a few MB that stay in the 50 MB L2.
//
// Memory order: w, mask, cur, ever, the live lengths, the stash, the lists,
// the flags and rounds change during the launch and are read by other
// blocks after a grid sync.  They are read with plain (coherent) loads,
// which may use L1 — the sync's fence orders them and keeps hot sources'
// masks and weights in L1 — and never through the read-only path; only
// w0, in_deg, src and freq use __ldg.
//
// Grid: kBlock threads a block, as many blocks as the occupancy API says
// fit on an SM, times the SM count (cached per device and block size) —
// every SM of the card — or fewer when the plan has fewer lane groups of
// rows than that.  kBlock is a template argument instantiated for 128,
// 256, 512 and 1024 (512 unless the autotuner's table says otherwise,
// kernels/autotune.py).
// Limits: scratch is 60 bytes a rule (the 32-byte stash, w buffer 1, two
// masks, cur, ever, live length, a list slot) plus 4 * (2 + (max_rounds +
// 1) * N) bytes of control words, and N * R must stay below 2^31.  The
// TPU's VMEM gate (ELL_FUSED_MAX_RULES = 2^18 rules) is kept only for
// routing parity with the JAX package; this kernel has no such limit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockSizes[] = {128, 256, 512, 1024};
constexpr int kVariants = 4;
constexpr int kThreadRow = 4;          // live entries one thread gathers
constexpr int kWarpRow = 4 * 32;       // ... one warp gathers, 4 a lane
constexpr int kMaxDevices = 64;
static_assert(kThreadRow == 4, "the stash holds a float4 and an int4");

struct FusedArgs {
  const float* w0;       // w0, in_deg, src and freq are read with __ldg
  const float* in_deg;
  const int* src;
  const float* freq;
  float* w;       // output, and weight buffer 0
  float* w1;      // weight buffer 1
  float* mask0;
  float* mask1;
  int* cur;
  int* ever;
  int* live;      // live length of every row
  float4* stash_q;  // the first kThreadRow entries of every row of at
  int4* stash_p;    // most kThreadRow live entries (zero past the end)
  int* lists;     // warp rows from the front, block rows from the back
  int* ctl;       // warp-row count, block-row count, then the flags
  int* rounds;
  int n, R, k, lanes, vec, max_rounds;
};

// A row's own state at the start of a round.
struct RowState {
  float w;
  int cur, ever, ind;
};

__device__ __forceinline__ RowState load_state(const FusedArgs& a,
                                               const float* wc, int row) {
  return {wc[row], a.cur[row], a.ever[row],
          static_cast<int>(__ldg(a.in_deg + row))};
}

// The frontier update of one row after its gather; true when the row
// became ready (its corpus's flag for the next round must then be raised).
__device__ __forceinline__ bool update_row(const FusedArgs& a, int row,
                                           const RowState& st, float* wn,
                                           float* mn, float d, int s) {
  wn[row] = st.w + d;
  const int c = st.cur + s;
  const bool ready = c == st.ind && st.ever == 0;
  a.cur[row] = c;
  mn[row] = ready ? 1.f : 0.f;
  if (ready) a.ever[row] = 1;
  return ready;
}

// Raises flag[corpus] of flag row `slot` once per block: `seen` (shared,
// 64 entries) remembers the (slot, corpus) keys the block has raised.  Many
// rows become ready in a round, and stores from every SM to the same few
// words would queue at one L2 slice.  A lost race between warps only
// repeats a store.
__device__ __forceinline__ void raise_once(int* flag, long long key,
                                           int corpus, long long* seen) {
  long long* e = seen + (corpus & 63);
  if (*e != key) {
    *e = key;
    flag[corpus] = 1;
  }
}

// raise_once for the converged lanes with `raise`, one lane per corpus.
__device__ __forceinline__ void raise_flag(int* flag, long long key,
                                           int corpus, bool raise,
                                           long long* seen) {
  const unsigned want = __ballot_sync(__activemask(), raise);
  if (!raise) return;
  const unsigned peers = __match_any_sync(want, corpus);
  if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
    raise_once(flag, key, corpus, seen);
}

// U entries (q, p) of a row, staged so that all loads of one kind are in
// flight together: plan entries, then the sources' masks, then the active
// sources' weights.  Entries with take[u] false contribute nothing.  The
// sum runs in u order.
template <int U>
__device__ __forceinline__ void gather_staged(const float* wc,
                                              const float* mc, int off,
                                              const float (&q)[U],
                                              const int (&p)[U],
                                              const bool (&take)[U],
                                              float* d, int* s) {
  float m[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    m[u] = (take[u] && q[u] != 0.f) ? mc[off + p[u]] : 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (m[u] == 0.f) continue;
    *d += q[u] * wc[off + p[u]] * m[u];
    if (q[u] > 0.f) ++*s;
  }
}

template <int kBlock>
__global__ void __launch_bounds__(kBlock)
    ell_frontier_fused_kernel(FusedArgs a) {
  constexpr int kWarps = kBlock / 32;
  cg::grid_group grid = cg::this_grid();
  const int rows = a.n * a.R;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  int* warp_count = a.ctl;
  int* block_count = a.ctl + 1;
  int* flags = a.ctl + 2;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int wl = threadIdx.x & 31;

  __shared__ long long seen[64];
  if (threadIdx.x < 64) seen[threadIdx.x] = -1;
  // the counters and flags start at zero (the grid sync also orders the
  // block's `seen` initialisation)
  const long long ctl_len = 2 + static_cast<long long>(a.max_rounds + 1) * a.n;
  for (long long i = tid; i < ctl_len; i += nthreads) a.ctl[i] = 0;
  grid.sync();

  // phase 0: live lengths.  A lane group reads a row's freq once (16 bytes
  // a lane when `vec`), two rows a pass so that more loads are in flight;
  // lane 0 also loads the row's head for the stash, so its src sector is
  // fetched at the same time.  The loop bound is uniform across each warp,
  // so every lane reaches the shuffles.
  {
    const int lanes = a.lanes;
    const int lane = wl % lanes;
    const int per_warp = 32 / lanes;
    const int pass = nwarps * per_warp;
    const int head = a.k < kThreadRow ? a.k : kThreadRow;
    for (int g0 = warp * per_warp; g0 < rows; g0 += 2 * pass) {
      int row[2];
      bool ok[2];
      long long base[2];
      int last[2] = {0, 0};
      float hq[2][kThreadRow] = {};
      int hp[2][kThreadRow] = {};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row[r] = g0 + wl / lanes + r * pass;
        ok[r] = row[r] < rows;
        base[r] = static_cast<long long>(ok[r] ? row[r] : 0) * a.k;
        if (ok[r] && lane == 0) {
#pragma unroll
          for (int u = 0; u < kThreadRow; ++u)
            if (u < head) {
              hq[r][u] = __ldg(a.freq + base[r] + u);
              hp[r][u] = __ldg(a.src + base[r] + u);
            }
        }
      }
      if (a.vec) {
        const int k4 = a.k >> 2;
#pragma unroll 4
        for (int j = lane; j < k4; j += lanes) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (!ok[r]) continue;
            const float4 v =
                __ldg(reinterpret_cast<const float4*>(a.freq + base[r]) + j);
            if (v.w != 0.f)
              last[r] = 4 * j + 4;
            else if (v.z != 0.f)
              last[r] = 4 * j + 3;
            else if (v.y != 0.f)
              last[r] = 4 * j + 2;
            else if (v.x != 0.f)
              last[r] = 4 * j + 1;
          }
        }
      } else {
#pragma unroll 4
        for (int j = lane; j < a.k; j += lanes) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (ok[r] && __ldg(a.freq + base[r] + j) != 0.f) last[r] = j + 1;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        for (int o = lanes >> 1; o > 0; o >>= 1)
          last[r] = max(last[r],
                        __shfl_down_sync(0xffffffffu, last[r], o, lanes));
        if (!ok[r] || lane != 0) continue;
        a.live[row[r]] = last[r];
        if (last[r] <= kThreadRow) {   // freq is 0 past `last`
          a.stash_q[row[r]] =
              make_float4(hq[r][0], hq[r][1], hq[r][2], hq[r][3]);
          a.stash_p[row[r]] = make_int4(hp[r][0], hp[r][1], hp[r][2], hp[r][3]);
        } else if (last[r] > kWarpRow) {
          a.lists[rows - 1 - atomicAdd(block_count, 1)] = row[r];
        } else {
          a.lists[atomicAdd(warp_count, 1)] = row[r];
        }
      }
    }
  }
  // phase 0: the state of round 0
  for (int row = tid; row < rows; row += nthreads) {
    const int m0 = static_cast<int>(__ldg(a.in_deg + row)) == 0;
    a.w[row] = __ldg(a.w0 + row);
    a.mask0[row] = m0 ? 1.f : 0.f;
    a.ever[row] = m0;
    a.cur[row] = 0;
    raise_flag(flags, row / a.R, row / a.R, m0, seen);
  }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.n; i += blockDim.x) a.rounds[i] = 0;
  grid.sync();

  __shared__ float part_d[kWarps];
  __shared__ int part_s[kWarps];
  const int n_warp_rows = *warp_count;
  const int n_block_rows = *block_count;
  for (int t = 0; t < a.max_rounds; ++t) {
    // every block reads the same flags after a grid sync, so the loop
    // bound is the same in every block
    const int* ft = flags + static_cast<long long>(t) * a.n;
    int any = 0;
    for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
      const int f = ft[i];
      any |= f;
      if (blockIdx.x == 0 && f) a.rounds[i] += 1;
    }
    if (!__syncthreads_or(any)) break;
    int* fn = flags + static_cast<long long>(t + 1) * a.n;
    const long long key = static_cast<long long>(t + 1) * a.n;
    const float* wc = (t & 1) ? a.w1 : a.w;
    float* wn = (t & 1) ? a.w : a.w1;
    const float* mc = (t & 1) ? a.mask1 : a.mask0;
    float* mn = (t & 1) ? a.mask0 : a.mask1;

    // the longest rows first, one block each (block-uniform loop)
    for (int i = blockIdx.x; i < n_block_rows; i += gridDim.x) {
      const int row = a.lists[rows - 1 - i];
      const int corpus = row / a.R;
      if (ft[corpus] == 0) continue;
      const RowState st = load_state(a, wc, row);
      const int len = a.live[row];
      const long long base = static_cast<long long>(row) * a.k;
      const int off = corpus * a.R;
      float d = 0.f;
      int s = 0;
      for (int j = threadIdx.x; j < len; j += 2 * kBlock) {
        float q[2];
        int p[2];
        bool take[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = j + u * kBlock;
          take[u] = e < len;
          q[u] = take[u] ? __ldg(a.freq + base + e) : 0.f;
          p[u] = take[u] ? __ldg(a.src + base + e) : 0;
        }
        gather_staged<2>(wc, mc, off, q, p, take, &d, &s);
      }
      for (int o = 16; o > 0; o >>= 1) {
        d += __shfl_down_sync(0xffffffffu, d, o);
        s += __shfl_down_sync(0xffffffffu, s, o);
      }
      if (wl == 0) {
        part_d[threadIdx.x >> 5] = d;
        part_s[threadIdx.x >> 5] = s;
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        d = wl < kWarps ? part_d[wl] : 0.f;
        s = wl < kWarps ? part_s[wl] : 0;
        for (int o = 16; o > 0; o >>= 1) {
          d += __shfl_down_sync(0xffffffffu, d, o);
          s += __shfl_down_sync(0xffffffffu, s, o);
        }
        if (wl == 0 && update_row(a, row, st, wn, mn, d, s))
          raise_once(fn, key + corpus, corpus, seen);
      }
      __syncthreads();
    }
    // rows of kThreadRow + 1 .. kWarpRow entries: one warp each, 4 entries
    // a lane (warp-uniform loop and branch)
    for (int i = warp; i < n_warp_rows; i += nwarps) {
      const int row = a.lists[i];
      const int corpus = row / a.R;
      if (ft[corpus] == 0) continue;
      const RowState st = load_state(a, wc, row);
      const int len = a.live[row];
      const long long base = static_cast<long long>(row) * a.k;
      float q[4];
      int p[4];
      bool take[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = wl + 32 * u;
        take[u] = e < len;
        q[u] = take[u] ? __ldg(a.freq + base + e) : 0.f;
        p[u] = take[u] ? __ldg(a.src + base + e) : 0;
      }
      float d = 0.f;
      int s = 0;
      gather_staged<4>(wc, mc, corpus * a.R, q, p, take, &d, &s);
      for (int o = 16; o > 0; o >>= 1) {
        d += __shfl_down_sync(0xffffffffu, d, o);
        s += __shfl_down_sync(0xffffffffu, s, o);
      }
      if (wl == 0 && update_row(a, row, st, wn, mn, d, s))
        raise_once(fn, key + corpus, corpus, seen);
    }
    // short rows: one thread each, from the stash
    for (int row = tid; row < rows; row += nthreads) {
      const int corpus = row / a.R;
      const int len = a.live[row];
      if (len > kThreadRow || ft[corpus] == 0) continue;
      const RowState st = load_state(a, wc, row);
      const float4 sq = a.stash_q[row];
      const int4 sp = a.stash_p[row];
      const float q[kThreadRow] = {sq.x, sq.y, sq.z, sq.w};
      const int p[kThreadRow] = {sp.x, sp.y, sp.z, sp.w};
      const bool take[kThreadRow] = {true, true, true, true};
      float d = 0.f;
      int s = 0;
      gather_staged<kThreadRow>(wc, mc, corpus * a.R, q, p, take, &d, &s);
      raise_flag(fn, key + corpus, corpus,
                 update_row(a, row, st, wn, mn, d, s), seen);
    }
    grid.sync();
  }

  // epilogue: bring the weights of corpora that ran an odd number of
  // rounds back from buffer 1
  for (int row = tid; row < rows; row += nthreads)
    if (a.rounds[row / a.R] & 1) a.w[row] = a.w1[row];
}

int g_blocks_per_sm[kVariants][kMaxDevices];
int g_sms[kMaxDevices];

template <int kBlock>
const void* kernel_of() {
  return reinterpret_cast<const void*>(ell_frontier_fused_kernel<kBlock>);
}

}  // namespace

// scratch: 16-byte aligned, 15 [n, R] 4-byte planes (the two stashes of 16
// bytes a row, then w1, mask0, mask1, cur, ever, live, lists); ctl:
// 2 + (max_rounds + 1) * n int32 that the kernel zeroes; vec: freq is read
// as float4 (k % 4 == 0, freq 16-byte aligned), lanes counted in float4s;
// grid_out: three host ints that receive the blocks launched, the
// co-resident blocks per SM and the SM count; block: threads a block, 128,
// 256, 512 or 1024.
extern "C" int repro_ell_frontier_fused(
    const void* w0, const void* in_deg, const void* src, const void* freq,
    void* w, void* scratch, void* ctl, void* rounds, int n, int R, int k,
    int lanes, int vec, int max_rounds, int block, void* grid_out,
    void* stream) {
  int variant = -1;
  for (int v = 0; v < kVariants; ++v)
    if (kBlockSizes[v] == block) variant = v;
  if (variant < 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = block == 128   ? kernel_of<128>()
                       : block == 256 ? kernel_of<256>()
                       : block == 512 ? kernel_of<512>()
                                      : kernel_of<1024>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // the cache is filled by whichever host thread launches first (the
  // shards of a sharded pack launch from one thread each): the SM count
  // is published before the block count that marks the entry as filled
  int* per_sm_slot = &g_blocks_per_sm[variant][dev];
  int per_sm = __atomic_load_n(per_sm_slot, __ATOMIC_ACQUIRE);
  if (per_sm == 0) {
    int blocks = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        block, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks <= 0 || sms <= 0)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    __atomic_store_n(&g_sms[dev], sms, __ATOMIC_RELAXED);
    __atomic_store_n(per_sm_slot, blocks, __ATOMIC_RELEASE);
    per_sm = blocks;
  }
  int* grid_info = static_cast<int*>(grid_out);
  grid_info[0] = 0;
  grid_info[1] = per_sm;
  grid_info[2] = g_sms[dev];
  if (n == 0 || R == 0 || k == 0) return 0;
  const long long full = static_cast<long long>(per_sm) * g_sms[dev];
  const long long rows = static_cast<long long>(n) * R;
  const long long want = (rows * lanes + block - 1) / block;
  const int blocks = static_cast<int>(want < full ? want : full);
  float* sc = static_cast<float*>(scratch);
  const long long plane = rows;
  FusedArgs a;
  a.stash_q = reinterpret_cast<float4*>(sc);
  a.stash_p = reinterpret_cast<int4*>(sc + 4 * plane);
  sc += 8 * plane;
  a.w0 = static_cast<const float*>(w0);
  a.in_deg = static_cast<const float*>(in_deg);
  a.src = static_cast<const int*>(src);
  a.freq = static_cast<const float*>(freq);
  a.w = static_cast<float*>(w);
  a.w1 = sc;
  a.mask0 = sc + plane;
  a.mask1 = sc + 2 * plane;
  a.cur = reinterpret_cast<int*>(sc + 3 * plane);
  a.ever = reinterpret_cast<int*>(sc + 4 * plane);
  a.live = reinterpret_cast<int*>(sc + 5 * plane);
  a.lists = reinterpret_cast<int*>(sc + 6 * plane);
  a.ctl = static_cast<int*>(ctl);
  a.rounds = static_cast<int*>(rounds);
  a.n = n;
  a.R = R;
  a.k = k;
  a.lanes = lanes;
  a.vec = vec;
  a.max_rounds = max_rounds;
  void* args[] = {&a};
  grid_info[0] = blocks;
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(block), args, 0,
      static_cast<cudaStream_t>(stream)));
}
