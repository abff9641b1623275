// Radius-threshold candidate selection on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/select.py:55
// (radius_select_kernel, launched by radius_select_pallas): for each row
// of d (B, N), a ladder of 16 rungs τ0·2.25^(l−8) brackets the T-th
// smallest value, 14 bisection steps narrow the bracket, and a last pass
// compacts the survivors d ≤ hi, in ascending index order, into T_pad
// slots, with the exact survivor count of each row.
//
// What bounds it on the H100: each pass streams the (B, N) row block from
// device memory, which at the main path's (64, 1M) is 256 MB, five times
// the L2, so the kernel is bound by the number of passes over d.
//
// What the design does about it: 4 reads of d where a pass per step
// would take 16.  Each bisection step depends only on whether
// count(d ≤ mid) ≥ T, so one pass can resolve 7 steps at once: it builds
// the tree of the 127 mids those steps could take, and each element
// descends it (left where d ≤ the node's mid) into one of 128 leaves.
// With the pass's bracket (lo, hi) and the counts [d ≤ lo, the leaves in
// order, d > hi] scanned into cum, count(d ≤ a node's mid) is cum at its
// left subtree's last leaf, exactly: a finite mid lies inside its
// bracket, so the finite mids order like the tree.  A mid can be +inf
// (when lo + hi overflows), and so can those below it; such a node counts
// every real element, cum's last slot.  With every mid finite, the mids
// in order are the leaves' edges, so an element's leaf is guessed from
// its place in (lo, hi] and checked against the two edges; the descent
// is the fallback.  So the launches are:
//
//   ladder   a 16-bin histogram per element (its first rung, by binary
//            search); the rung counts are its scan; the row's max.
//   pass 0   steps 1–7: the bracket from the ladder counts, the tree, the
//            leaf histogram of the row.  Past the ladder, most of a row
//            of projected distances lies inside the bracket (a rung spans
//            2.25× in d²): this pass does the most work per element.
//   pass 1   steps 8–14: the bracket replayed through pass 0's counts;
//            the row's histogram and each tile's scan.
//   compact  the bracket replayed through both passes gives the final hi
//            and its slot in the tiles' scans; the counts of the tiles
//            before a block place its survivors, which it scatters with
//            warp ballots in ascending index order (the lowest-index
//            tie-break depends on it).
//
// The bracket is never stored: every block replays it from the row's
// counts with the serial float ops (mid = f32(0.5·f32(lo + hi))), so all
// blocks agree without a host sync.  Blocks publish counts with integer
// atomics.  A block takes kChunks chunks of 4,096 elements of one row,
// so that its fixed work (the replay, the tree, the counts it publishes)
// is paid once for 16,384 elements, and it loads the next chunk while it
// works on the current one; the chunk loops stay rolled, so that each
// kernel's code stays small.  Loads are coalesced: each warp load is 32
// consecutive floats.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 512;                 // consecutive elements per warp and chunk
constexpr int kSteps = kPerWarp / 32;         // 32-element steps per warp and chunk
constexpr int kChunk = kWarps * kPerWarp;     // elements a block loads at once
constexpr int kChunks = 4;                    // chunks per block
constexpr int kTile = kChunks * kChunk;       // elements per block
// the TPU kernel's defaults (select.py:181-183), as ref.py's constants
constexpr int kRungs = 16;
constexpr int kIters = 14;
// bisection steps one histogram pass resolves, and the passes
constexpr int kLevels = 7;
constexpr int kPasses = kIters / kLevels;
constexpr int kBins = 1 << kLevels;  // the tree's leaves
constexpr int kSlots = kBins + 2;    // [d ≤ lo, the leaves in order, d > hi]
static_assert(kPasses * kLevels == kIters, "the passes cover the steps");
static_assert(kRungs == 16, "the rung search takes 4 steps");
static_assert(kSteps * kChunks < 256 && kSteps % 8 == 0, "a lane's rung counts fit a byte");
static_assert(kSlots <= kThreads, "a thread per slot");

struct Rungs {
  float v[kRungs];  // f32(2.25^(l − 8)), computed on the host
};

struct SelectArgs {
  const float* d;
  const float* tau0;  // (B,), already clamped at 1e-30
  int B, N, T, T_pad, n_tiles;
  int* ladder;  // (B, kRungs) survivor counts per rung
  int* dmax;    // (B,) bits of max(0, largest real value)
  int* hist;    // (B, kPasses, kSlots) the row's counts per pass
  int* tiles;   // (B, kSlots, n_tiles) each tile's scan of the last pass
  float* out_vals;
  int* out_idx;
  int* out_count;
};

struct Bracket {
  float lo, hi;
};

__device__ __forceinline__ float mid_of(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// The bracket after the ladder pass (select.py:94-106).
__device__ Bracket ladder_bracket(const SelectArgs& a, const Rungs& r, int b) {
  const float tau0 = a.tau0[b];
  const float dmax = __int_as_float(a.dmax[b]);
  const int* lad = a.ladder + static_cast<long long>(b) * kRungs;
  int first = -1;  // smallest rung holding >= T survivors
  for (int l = 0; l < kRungs; ++l) {
    if (lad[l] >= a.T) {
      first = l;
      break;
    }
  }
  // the data max rescues a seed so low the whole ladder undershoots,
  // and one so high that rung 0 overshoots
  float hi = first >= 0 ? __fmul_rn(tau0, r.v[first]) : dmax;
  hi = fminf(hi, dmax);
  float lo = first > 0 ? __fmul_rn(tau0, r.v[first - 1]) : 0.f;
  if (first < 0) lo = __fmul_rn(tau0, r.v[kRungs - 1]);
  lo = fminf(lo, hi);
  return {lo, hi};
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(rt::kFullMask, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The bracket after the ladder and `passes` histogram passes, and the
// leaf the last of them reached (select.py:114-126, kLevels steps a pass).
// Called by all lanes of one warp, which agree on the result; s_cum is
// kSlots ints of shared memory.
__device__ Bracket replay(const SelectArgs& a, const Rungs& r, int b, int passes,
                          int* s_cum, int* leaf) {
  constexpr int kPerLane = (kSlots + 31) / 32;
  const int lane = threadIdx.x & 31;
  Bracket br = ladder_bracket(a, r, b);
  int node = 2 * kBins - 1;  // no pass: as if every step went right
  for (int p = 0; p < passes; ++p) {
    // the inclusive scan of the row's counts of pass p
    const int* h = a.hist + (static_cast<long long>(b) * kPasses + p) * kSlots;
    int loc[kPerLane];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int s = lane * kPerLane + q;
      loc[q] = s < kSlots ? h[s] : 0;
      sum += loc[q];
    }
    int run = warp_inclusive_sum(sum, lane) - sum;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int s = lane * kPerLane + q;
      run += loc[q];
      if (s < kSlots) s_cum[s] = run;
    }
    __syncwarp();
    node = 1;  // heap order: node i has children 2i and 2i + 1
    for (int depth = 0; depth < kLevels; ++depth) {
      const float mid = mid_of(br.lo, br.hi);
      // count(d ≤ mid): cum at the last leaf of the node's left subtree
      const int first_leaf = (node - (1 << depth)) << (kLevels - depth);
      const int c = isinf(mid) ? s_cum[kSlots - 1]
                               : s_cum[first_leaf + (1 << (kLevels - 1 - depth))];
      if (c >= a.T) {
        br.hi = mid;
        node = 2 * node;
      } else {
        br.lo = mid;
        node = 2 * node + 1;
      }
    }
    __syncwarp();  // s_cum is read before the next pass rewrites it
  }
  *leaf = node - kBins;
  return br;
}

// The first element of this warp's part of chunk c of tile j.
__device__ __forceinline__ long long chunk_base(int j, int c, int warp) {
  return static_cast<long long>(j) * kTile + c * kChunk + warp * kPerWarp;
}

// This lane's kSteps elements from `base`, 32 apart: each warp load is
// 32 consecutive floats.  The ragged edge is padding, as on the TPU.
__device__ __forceinline__ void load_chunk(float (&v)[kSteps], const float* row,
                                           long long base, int N) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const long long i = base + it * 32 + lane;
    v[it] = i < N ? row[i] : INFINITY;
  }
}

// The leaf x reaches in the tree of mids (heap order): left where x ≤
// the node's mid.  The rare path (a guess that misses, or a +inf mid),
// so a rolled loop.
__device__ __forceinline__ int leaf_of(float x, const float* mid) {
  int node = 1;
#pragma unroll 1
  for (int k = 0; k < kLevels; ++k) node = 2 * node + (x > mid[node]);
  return node - kBins;
}

// Pass 0: survivor counts of all 16 rungs and the row's data max.
__global__ void __launch_bounds__(kThreads) select_ladder_kernel(SelectArgs a, Rungs r) {
  __shared__ float s_thr[kRungs];
  __shared__ int s_cnt[kRungs];
  __shared__ int s_dmax;
  const int b = blockIdx.y, j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = a.d + static_cast<long long>(b) * a.N;
  float v[kSteps], next[kSteps];
  load_chunk(v, row, chunk_base(j, 0, warp), a.N);
  if (tid < kRungs) {
    s_thr[tid] = __fmul_rn(a.tau0[b], r.v[tid]);
    s_cnt[tid] = 0;
  }
  if (tid == 0) s_dmax = 0;
  __syncthreads();

  // An element's bin is its first rung l with x ≤ thr[l] (thr ascends),
  // by binary search; none where x is above them all.  Nibble l of
  // `fresh` counts this lane's elements of rung l since the last fold;
  // byte k of `even` and `odd` those of rungs 2k and 2k + 1.
  constexpr unsigned long long kNibbles = 0x0F0F0F0F0F0F0F0Full;
  const float t3 = s_thr[3], t7 = s_thr[7], t11 = s_thr[11], t15 = s_thr[15];
  unsigned long long fresh = 0, even = 0, odd = 0;
  float vmax = 0.f;
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) load_chunk(next, row, chunk_base(j, c + 1, warp), a.N);
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const float x = v[it];
      if (c + 1 < kChunks) v[it] = next[it];
      const bool real = x < INFINITY;
      if (real) vmax = fmaxf(vmax, x);
      int l = x <= t7 ? 0 : 8;
      l += x <= (l ? t11 : t3) ? 0 : 4;
      l += x <= s_thr[l + 1] ? 0 : 2;
      l += x <= s_thr[l] ? 0 : 1;  // l holds x, unless l = 15 and x > t15
      if (real && (l < kRungs - 1 || x <= t15)) fresh += 1ull << (4 * l);
      if (it % 8 == 7) {  // a nibble holds 15: fold every 8 elements
        even += fresh & kNibbles;
        odd += (fresh >> 4) & kNibbles;
        fresh = 0;
      }
    }
  }
  int mine = 0;  // the warp's elements of rung `lane` (lanes below kRungs)
#pragma unroll
  for (int l = 0; l < kRungs; ++l) {
    const unsigned long long bytes = l & 1 ? odd : even;
    const unsigned c = __reduce_add_sync(rt::kFullMask,
                                         static_cast<unsigned>(bytes >> (8 * (l >> 1))) & 0xffu);
    if (l == lane) mine = static_cast<int>(c);
  }
  if (lane < kRungs && mine) atomicAdd(&s_cnt[lane], mine);
  vmax = rt::warp_max(vmax);
  // non-negative floats order like their bit patterns
  if (lane == 0) atomicMax(&s_dmax, __float_as_int(vmax));
  __syncthreads();
  if (tid < kRungs) {
    int cum = 0;  // survivors of rung tid: the scan of the bins
    for (int l = 0; l <= tid; ++l) cum += s_cnt[l];
    if (cum) atomicAdd(&a.ladder[static_cast<long long>(b) * kRungs + tid], cum);
  }
  if (tid == 0) atomicMax(&a.dmax[b], s_dmax);
}

// Histogram pass `pass`: bisection steps pass·kLevels + 1 .. (pass + 1)·kLevels.
// The last pass also writes the tile's scan for the compaction.
__global__ void __launch_bounds__(kThreads) select_pass_kernel(SelectArgs a, Rungs r, int pass) {
  __shared__ float s_mid[kBins];  // heap order, nodes 1..kBins − 1
  __shared__ int s_hist[kWarps][kBins];
  __shared__ float s_edge[kBins + 1];  // lo, the mids in order, hi
  __shared__ int s_cum[kSlots];
  __shared__ int s_part[2][kWarps];
  __shared__ int s_scan[kWarps];
  __shared__ float s_lo, s_hi;
  const int b = blockIdx.y, j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = a.d + static_cast<long long>(b) * a.N;
  float v[kSteps], next[kSteps];
  load_chunk(v, row, chunk_base(j, 0, warp), a.N);
  for (int i = tid; i < kWarps * kBins; i += kThreads) (&s_hist[0][0])[i] = 0;
  if (warp == 0) {
    int leaf;
    const Bracket br = replay(a, r, b, pass, s_cum, &leaf);
    if (lane == 0) {
      s_lo = br.lo;
      s_hi = br.hi;
    }
  }
  __syncthreads();
  const float lo = s_lo, hi = s_hi;
  bool finite_mid = true;
  if (tid >= 1 && tid < kBins) {  // node tid's mid: its bracket, cut top down
    const int depth = 31 - __clz(tid);
    float l = lo, h = hi;
    for (int k = depth - 1; k >= 0; --k) {
      const float m = mid_of(l, h);
      if ((tid >> k) & 1) {
        l = m;
      } else {
        h = m;
      }
    }
    const float m = mid_of(l, h);
    s_mid[tid] = m;
    // the node splits leaves (2·o + 1)·2^(6 − depth) − 1 and the next, o its offset
    s_edge[(2 * (tid - (1 << depth)) + 1) << (kLevels - 1 - depth)] = m;
    finite_mid = !isinf(m);
  }
  if (tid == 0) {
    s_edge[0] = lo;
    s_edge[kBins] = hi;
  }
  // with every mid finite, the mids in order ascend, and an element's leaf
  // is the one whose edges hold it: guessed from its place in (lo, hi],
  // checked against the edges, and found by the descent where the guess
  // misses
  const bool ordered = __syncthreads_and(finite_mid);
  const float scale = kBins / (hi - lo);

  // d ≤ lo lies below every mid; d > hi above every finite one; the rest
  // goes to a leaf
  unsigned below = 0, above = 0;
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) load_chunk(next, row, chunk_base(j, c + 1, warp), a.N);
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const float x = v[it];
      if (c + 1 < kChunks) v[it] = next[it];
      if (!(x < INFINITY)) continue;  // padding and NaN are never counted
      if (x <= lo) {
        ++below;
      } else if (x > hi) {
        ++above;
      } else {
        int leaf = min(max(__float2int_rz((x - lo) * scale), 0), kBins - 1);
        if (!(ordered && x > s_edge[leaf] && x <= s_edge[leaf + 1])) leaf = leaf_of(x, s_mid);
        atomicAdd(&s_hist[warp][leaf], 1);
      }
    }
  }
  below = __reduce_add_sync(rt::kFullMask, below);
  above = __reduce_add_sync(rt::kFullMask, above);
  if (lane == 0) {
    s_part[0][warp] = static_cast<int>(below);
    s_part[1][warp] = static_cast<int>(above);
  }
  __syncthreads();

  // thread s owns slot s: [below, the leaves, above]
  int c = 0;
  if (tid == 0 || tid == kSlots - 1) {
    for (int w = 0; w < kWarps; ++w) c += s_part[tid == 0 ? 0 : 1][w];
  } else if (tid < kSlots) {
    for (int w = 0; w < kWarps; ++w) c += s_hist[w][tid - 1];
  }
  if (c) atomicAdd(&a.hist[(static_cast<long long>(b) * kPasses + pass) * kSlots + tid], c);
  if (pass == kPasses - 1) {  // the tile's inclusive scan, slot-major
    const int incl = warp_inclusive_sum(c, lane);
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();
    int run = incl;
    for (int w = 0; w < warp; ++w) run += s_scan[w];
    if (tid < kSlots) {
      a.tiles[(static_cast<long long>(b) * kSlots + tid) * a.n_tiles + j] = run;
    }
  }
}

// Final pass: the final hi and its slot in the tiles' scans, the counts
// of the tiles before this one, then the tile's survivors scattered in
// ascending index order into the first T_pad slots.
__global__ void __launch_bounds__(kThreads) select_compact_kernel(SelectArgs a, Rungs r) {
  __shared__ float s_thr;
  __shared__ int s_slot;
  __shared__ int s_cum[kSlots];
  __shared__ int s_part[2][kWarps];
  __shared__ int s_warp_cnt[2][kWarps];  // by chunk parity: one barrier a chunk
  const int b = blockIdx.y, j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = a.d + static_cast<long long>(b) * a.N;
  float vals[kSteps], next[kSteps];
  load_chunk(vals, row, chunk_base(j, 0, warp), a.N);
  if (warp == 0) {
    int leaf;
    const Bracket br = replay(a, r, b, kPasses, s_cum, &leaf);
    if (lane == 0) {
      s_thr = br.hi;  // the final hi
      // count(d ≤ hi) of a tile: its scan after the last leaf reached,
      // or every real element where hi became +inf
      s_slot = isinf(br.hi) ? kSlots - 1 : leaf + 1;
    }
  }
  __syncthreads();
  const float thr = s_thr;

  // this row's survivors in the tiles before this one, and in all tiles
  const int* tc = a.tiles + (static_cast<long long>(b) * kSlots + s_slot) * a.n_tiles;
  int before = 0, total = 0;
  for (int t = tid; t < a.n_tiles; t += kThreads) {
    const int c = tc[t];
    total += c;
    if (t < j) before += c;
  }
  before = __reduce_add_sync(rt::kFullMask, before);
  total = __reduce_add_sync(rt::kFullMask, total);
  if (lane == 0) {
    s_part[0][warp] = before;
    s_part[1][warp] = total;
  }

  float* ov = a.out_vals + static_cast<long long>(b) * a.T_pad;
  int* oi = a.out_idx + static_cast<long long>(b) * a.T_pad;
  const unsigned lower = (1u << lane) - 1u;
  int start = 0;  // the row's survivors before this chunk
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) load_chunk(next, row, chunk_base(j, c + 1, warp), a.N);
    unsigned keep = 0;  // bit `it`: this lane's element of step `it` survives
    int wcount = 0;
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const bool s = vals[it] < INFINITY && vals[it] <= thr;
      keep |= static_cast<unsigned>(s) << it;
      wcount += __popc(__ballot_sync(rt::kFullMask, s));
    }
    if (lane == 0) s_warp_cnt[c & 1][warp] = wcount;
    __syncthreads();
    if (c == 0) {
      total = 0;
      for (int w = 0; w < kWarps; ++w) {
        start += s_part[0][w];
        total += s_part[1][w];
      }
    }
    int pos = start;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += s_warp_cnt[c & 1][w];
      start += s_warp_cnt[c & 1][w];
    }
    const long long base = chunk_base(j, c, warp);
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const bool s = (keep >> it) & 1u;
      const unsigned m = __ballot_sync(rt::kFullMask, s);
      const int slot = pos + __popc(m & lower);
      if (s && slot < a.T_pad) {  // overflow keeps the first T_pad in index order
        ov[slot] = vals[it];
        oi[slot] = static_cast<int>(base + it * 32 + lane);
      }
      pos += __popc(m);
      if (c + 1 < kChunks) vals[it] = next[it];
    }
  }

  // slots past the row's survivors hold (+inf, −1); the row's blocks share the fill
  for (long long s = min(total, a.T_pad) + static_cast<long long>(j) * kThreads + tid;
       s < a.T_pad; s += static_cast<long long>(a.n_tiles) * kThreads) {
    ov[s] = INFINITY;
    oi[s] = -1;
  }
  if (j == 0 && tid == 0) a.out_count[b] = total;
}

int n_tiles_of(int N) { return (N + kTile - 1) / kTile; }

// scratch ints zeroed before the ladder: ladder, dmax and the row histograms
long long zeroed_ints(int B) { return static_cast<long long>(B) * (kRungs + 1 + kPasses * kSlots); }

}  // namespace

// Scratch ints radius_select_launch needs for (B, N).
extern "C" long long radius_select_scratch_ints(int B, int N) {
  return zeroed_ints(B) + static_cast<long long>(B) * kSlots * n_tiles_of(N);
}

// d (B, N), tau0 (B,) → vals (B, T_pad), idx (B, T_pad), count (B,).
// `rungs` is a host array of 16 floats.  Launches a memset and
// 2 + kPasses kernels on `stream` and returns cudaGetLastError() (or the
// memset's error).
extern "C" int radius_select_launch(const float* d, const float* tau0, const float* rungs,
                                    int B, int N, int T, int T_pad,
                                    float* out_vals, int* out_idx, int* out_count,
                                    int* scratch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SelectArgs a;
  a.d = d;
  a.tau0 = tau0;
  a.B = B;
  a.N = N;
  a.T = T;
  a.T_pad = T_pad;
  a.n_tiles = n_tiles_of(N);
  a.ladder = scratch;
  a.dmax = a.ladder + static_cast<long long>(B) * kRungs;
  a.hist = a.dmax + B;
  a.tiles = scratch + zeroed_ints(B);
  a.out_vals = out_vals;
  a.out_idx = out_idx;
  a.out_count = out_count;
  Rungs r;
  for (int l = 0; l < kRungs; ++l) r.v[l] = rungs[l];
  // the tiles' scans are written whole by the last pass
  const cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int) * zeroed_ints(B), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.n_tiles, B);
  select_ladder_kernel<<<grid, kThreads, 0, st>>>(a, r);
  for (int p = 0; p < kPasses; ++p) select_pass_kernel<<<grid, kThreads, 0, st>>>(a, r, p);
  select_compact_kernel<<<grid, kThreads, 0, st>>>(a, r);
  return static_cast<int>(cudaGetLastError());
}
