// Radius-threshold candidate selection on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/select.py:55
// (radius_select_kernel, launched by radius_select_pallas): for each row
// of d (B, N), a ladder of 16 rungs τ0·2.25^(l−8) brackets the T-th
// smallest value and 14 bisection steps narrow the bracket, as there.
// Where the TPU kernel then compacts every survivor d ≤ hi into T_pad
// slots for a sort to trim, this one finishes the selection itself: it
// writes exactly the row's first T by (value, index), in ascending index
// order, and the exact survivor count count(d ≤ hi) of each row.
//
// What bounds it on the H100: each pass streams the (B, N) row block from
// device memory, which at the main path's (64, 1M) is 256 MB, five times
// the L2, so the kernel is bound by the number of passes over d.
//
// What the design does about it: 4 reads of d where a pass per step
// would take 16, and no sort after them.  Each bisection step depends
// only on whether count(d ≤ mid) ≥ T, so one pass can resolve 7 steps at
// once: it builds the tree of the 127 mids those steps could take, and
// each element descends it (left where d ≤ the node's mid) into one of
// 128 leaves.  With the pass's bracket (lo, hi) and the counts [d ≤ lo,
// the leaves in order, d > hi] scanned into cum, count(d ≤ a node's mid)
// is cum at its left subtree's last leaf, exactly: a finite mid lies
// inside its bracket, so the finite mids order like the tree.  A mid can
// be +inf (when lo + hi overflows), and so can those below it; such a
// node counts every real element, cum's last slot.  With every mid
// finite, the mids in order are the leaves' edges, so an element's leaf
// is guessed from its place in (lo, hi] and checked against the two
// edges; the descent is the fallback.  So the launches are:
//
//   ladder   a 16-bin histogram per element (its first rung, by binary
//            search); the rung counts are its scan; the row's max.
//   pass 0   steps 1–7: the bracket from the ladder counts, the tree, the
//            leaf histogram of the row.  Past the ladder, most of a row
//            of projected distances lies inside the bracket (a rung spans
//            2.25× in d²): this pass does the most work per element.
//   pass 1   steps 8–14: the bracket replayed through pass 0's counts;
//            the row's histogram and each tile's scan; and every element
//            of the pass's bracket, (value, index), staged in shared
//            memory and appended to the row's band buffer, one global
//            atomic a block (one a warp step made a single L2 line of
//            counters the pass's bottleneck).  The row's last block to
//            finish (an atomic ticket) resolves the row, below.
//   compact  each tile's elements of the answer, placed after those of
//            the tiles before it, scattered with warp ballots in
//            ascending index order.
//
// Resolving a row.  After the 14 steps, with (lo, hi] the final bracket,
// every element d ≤ lo is in the answer (c_lo = count(d ≤ lo) < T) and
// the rest of it is the T − c_lo smallest of the band lo < d ≤ hi by
// (value, index): a few tens of elements at the main path's shape, all of
// them in the band buffer, since the final bracket lies inside pass 1's.
// The last block sorts them in shared memory (the buffer's elements
// inside (lo, hi]; there must be exactly count(d ≤ hi) − c_lo of them)
// and takes the T-th smallest key (v*, i*) of the row, the cut: an
// element is in the answer iff d < v* or d = v* with index ≤ i*.  Each
// tile's count of the answer is its scan at the final leaf (d ≤ lo) plus
// the band's picks in it; their exclusive scan places the tiles.  Where
// the band cannot be resolved so (a tie cluster wider than the buffer, a
// tile's staging or the sort, c_lo ≥ T when lo stays 0, the +inf-mid
// cases), the block
// finds the cut over the whole row instead: four radix passes of 8 bits
// over the values' order keys, then one pass in index order for the ties
// at v*, which counts each tile's share.  A row with at most T real
// elements takes them all, padded with (+inf, −1).
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
// the largest final band the row's last block sorts in shared memory, and
// the most elements of the last pass's bracket a block stages there
constexpr int kBandSort = 2048;
static_assert(kPasses * kLevels == kIters, "the passes cover the steps");
static_assert(kPasses == 2, "the launches name pass 0 and pass 1");
static_assert(kRungs == 16, "the rung search takes 4 steps");
static_assert(kSteps * kChunks < 256 && kSteps % 8 == 0, "a lane's rung counts fit a byte");
static_assert(kSlots <= kThreads, "a thread per slot");
static_assert(kThreads == 256 && kTile % kThreads == 0, "a thread per radix digit");

struct Rungs {
  float v[kRungs];  // f32(2.25^(l − 8)), computed on the host
};

struct SelectArgs {
  const float* d;
  const float* tau0;  // (B,), already clamped at 1e-30
  int B, N, T, n_tiles, band_cap;
  int* ladder;      // (B, kRungs) survivor counts per rung
  int* dmax;        // (B,) bits of max(0, largest real value)
  int* hist;        // (B, kPasses, kSlots) the row's counts per pass
  int* ticket;      // (B,) the row's blocks done with the last pass
  int* band_n;      // (B,) elements of the last pass's bracket, buffered or not
  int* band_lost;   // (B,) 1 where a tile's bracket elements overflowed its staging
  int* tiles;       // (B, kSlots, n_tiles) each tile's scan of the last pass
  float* band_val;  // (B, band_cap) the last pass's bracket: values,
  int* band_idx;    //   and indices, in no order
  int* starts;      // (B, n_tiles + 1) the answer's elements before each tile, then all
  int* cut;         // (B, 2) bits of v*, i*
  float* out_vals;
  int* out_idx;
  int* out_count;
  int* out_stats;   // (B, 3) the final band's size, band_n, 1 where the row fell back
};

struct Bracket {
  float lo, hi;
};

// The last pass's shared staging of its tile's bracket elements, which
// the row's last block then sorts the final band in; nothing in the
// other passes.
template <bool kLast>
struct Stage {};
template <>
struct Stage<true> {
  float v[kBandSort];
  int i[kBandSort];
  int n;
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

// The block's exclusive scan of v, and its sum in *total.  Every thread
// calls it; s_warp is kWarps ints of shared memory.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_sum(v, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += s_warp[w];
    sum += s_warp[w];
  }
  __syncthreads();  // s_warp is read before the next call rewrites it
  *total = sum;
  return before + incl - v;
}

// The bracket after the ladder and `passes` histogram passes, and the
// leaf the last of them reached (select.py:114-126, kLevels steps a pass).
// Called by all lanes of one warp, which agree on the result; s_cum is
// kSlots ints of shared memory and ends holding the last pass's scan.
// The counts are read from the L2: the last pass's row's last block reads
// what the row's other blocks of that launch added.
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
      loc[q] = s < kSlots ? __ldcg(h + s) : 0;
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

// A real value's key, unsigned integers ordered as the floats are (−0
// as +0, which compares equal to it), and back.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float from_order_key(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// The cut of row b over the whole row, by one block: the T-th smallest
// real element by (value, index), with count(real) > T.  Four radix
// passes of 8 bits over the order keys give its value v; one pass over
// the tiles in index order, each thread a run of consecutive elements,
// finds the tie at v that ends the answer and writes the row's starts.
// s_digit is kThreads ints of shared memory.
__device__ void cut_by_radix(const SelectArgs& a, int b, int* s_digit, int* s_warp,
                             float* vs, int* is) {
  __shared__ int s_pick, s_rank, s_index;
  const int tid = threadIdx.x;
  const float* row = a.d + static_cast<long long>(b) * a.N;
  unsigned prefix = 0, mask = 0;
  int rank = a.T;  // 1-based, among the keys that match prefix under mask
  for (int shift = 24; shift >= 0; shift -= 8) {
    s_digit[tid] = 0;
    __syncthreads();
#pragma unroll 4
    for (long long i = tid; i < a.N; i += kThreads) {
      const float x = row[i];
      if (x < INFINITY) {  // padding and NaN are never counted
        const unsigned k = order_key(x);
        if ((k & mask) == prefix) atomicAdd(&s_digit[(k >> shift) & 255u], 1);
      }
    }
    __syncthreads();
    const int c = s_digit[tid];
    int total;
    const int before = block_exclusive_scan(c, s_warp, &total);
    if (before < rank && rank <= before + c) {  // the digit that holds the rank-th key
      s_pick = tid;
      s_rank = rank - before;
    }
    __syncthreads();
    prefix |= static_cast<unsigned>(s_pick) << shift;
    mask |= 255u << shift;
    rank = s_rank;
    __syncthreads();  // s_pick and s_rank are read before the next digit rewrites them
  }
  const float v = from_order_key(prefix);
  constexpr int kRun = kTile / kThreads;
  int* st = a.starts + static_cast<long long>(b) * (a.n_tiles + 1);
  int ties = 0, run = 0;  // ties at v, and the answer's elements, in the tiles before
  for (int t = 0; t < a.n_tiles; ++t) {
    const long long s0 = static_cast<long long>(t) * kTile + tid * kRun;
    const long long s1 = min(s0 + kRun, static_cast<long long>(a.N));
    int lt = 0, eq = 0;
    for (long long i = s0; i < s1; ++i) {
      const float x = row[i];
      lt += x < v;
      eq += x == v;
    }
    int tile_ties;
    const int first = ties + block_exclusive_scan(eq, s_warp, &tile_ties);
    if (first < rank && rank <= first + eq) {  // this run holds the last tie taken
      int seen = first;
      for (long long i = s0; i < s1; ++i) {
        if (row[i] == v && ++seen == rank) {
          s_index = static_cast<int>(i);
          break;
        }
      }
    }
    int taken;
    block_exclusive_scan(lt + min(max(rank - first, 0), eq), s_warp, &taken);
    if (tid == 0) st[t] = run;
    run += taken;
    ties += tile_ties;
  }
  if (tid == 0) st[a.n_tiles] = run;
  __syncthreads();
  *vs = v;
  *is = s_index;
}

// Resolves row b after its last pass, by the row's last block: the final
// bracket, the cut (v*, i*), the row's starts, its survivor count and
// its stats.  Every thread of the block calls it; s_bv and s_bi are
// kBandSort slots of shared memory.
__device__ void resolve_row(const SelectArgs& a, const Rungs& r, int b, float* s_bv, int* s_bi) {
  __shared__ int s_cum[kSlots];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile[kThreads];
  __shared__ float s_lo, s_hi;
  __shared__ int s_leaf, s_clo, s_chi, s_real, s_nf;
  enum Mode { kAll, kBand, kRadix };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __threadfence();  // the other blocks' counts and band before this block's reads
  if (warp == 0) {
    int leaf;
    const Bracket br = replay(a, r, b, kPasses, s_cum, &leaf);
    if (lane == 0) {
      s_lo = br.lo;
      s_hi = br.hi;
      s_leaf = leaf;
      s_clo = s_cum[leaf];  // count(d ≤ lo): d ≤ the pass's lo, and the leaves before
      // count(d ≤ hi), or every real element where hi became +inf
      s_chi = s_cum[isinf(br.hi) ? kSlots - 1 : leaf + 1];
      s_real = s_cum[kSlots - 1];
      s_nf = 0;
    }
  }
  __syncthreads();
  const int T = a.T, clo = s_clo, chi = s_chi;
  const int nb = __ldcg(a.band_n + b);
  const bool lost = nb > a.band_cap || __ldcg(a.band_lost + b);
  Mode mode = s_real <= T ? kAll : clo >= T || lost ? kRadix : kBand;
  if (mode == kBand) {  // the final band out of the buffer
    const long long off = static_cast<long long>(b) * a.band_cap;
#pragma unroll 4
    for (int e = tid; e < nb; e += kThreads) {
      const float x = __ldcg(a.band_val + off + e);
      if (x > s_lo && x <= s_hi) {
        const int at = atomicAdd(&s_nf, 1);
        if (at < kBandSort) {
          s_bv[at] = x;
          s_bi[at] = __ldcg(a.band_idx + off + e);
        }
      }
    }
    __syncthreads();
    // the whole band was buffered and fits the sort, or the row falls back
    if (s_nf != chi - clo || s_nf > kBandSort) mode = kRadix;
  }
  float vs = INFINITY;  // the cut where every real element is taken
  int is = -1;
  if (mode == kRadix) {
    cut_by_radix(a, b, s_tile, s_warp, &vs, &is);
  } else {
    const int need = mode == kBand ? T - clo : 0;  // the band's picks
    if (mode == kBand) {
      const int nf = s_nf;
      int len = 1;
      while (len < nf) len <<= 1;
      for (int e = nf + tid; e < len; e += kThreads) {
        s_bv[e] = INFINITY;
        s_bi[e] = INT_MAX;
      }
      __syncthreads();
      rt::sort_pairs<kThreads>(s_bv, s_bi, len);
      vs = s_bv[need - 1];
      is = s_bi[need - 1];
    }
    // a tile's share: its elements ≤ lo (every real one where all are
    // taken), and the picks that lie in it
    const int slot = mode == kBand ? s_leaf : kSlots - 1;
    const int* tc = a.tiles + (static_cast<long long>(b) * kSlots + slot) * a.n_tiles;
    int* st = a.starts + static_cast<long long>(b) * (a.n_tiles + 1);
    int run = 0;
    for (int base = 0; base < a.n_tiles; base += kThreads) {
      s_tile[tid] = 0;
      __syncthreads();
      for (int e = tid; e < need; e += kThreads) {
        const int t = s_bi[e] / kTile - base;
        if (t >= 0 && t < kThreads) atomicAdd(&s_tile[t], 1);
      }
      __syncthreads();
      const int t = base + tid;
      const int c = t < a.n_tiles ? __ldcg(tc + t) + s_tile[tid] : 0;
      int total;
      const int before = block_exclusive_scan(c, s_warp, &total);
      if (t < a.n_tiles) st[t] = run + before;
      run += total;
    }
    if (tid == 0) st[a.n_tiles] = run;
  }
  if (tid == 0) {
    a.cut[2 * b] = __float_as_int(vs);
    a.cut[2 * b + 1] = is;
    a.out_count[b] = chi;
    int* stats = a.out_stats + 3 * static_cast<long long>(b);
    stats[0] = s_real > T ? chi - clo : 0;
    stats[1] = nb;
    stats[2] = mode == kRadix;
  }
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

// Histogram pass kPass: bisection steps kPass·kLevels + 1 .. (kPass + 1)·kLevels.
// The last pass also writes the tile's scan and buffers its bracket's
// elements, and its row's last block resolves the row.
template <int kPass>
__global__ void __launch_bounds__(kThreads, 5) select_pass_kernel(SelectArgs a, Rungs r) {
  constexpr bool kLast = kPass == kPasses - 1;
  __shared__ float s_mid[kBins];  // heap order, nodes 1..kBins − 1
  __shared__ int s_hist[kWarps][kBins];
  __shared__ float s_edge[kBins + 1];  // lo, the mids in order, hi
  __shared__ int s_cum[kSlots];
  __shared__ int s_part[2][kWarps];
  __shared__ int s_scan[kWarps];
  __shared__ float s_lo, s_hi;
  __shared__ int s_last, s_base;
  __shared__ Stage<kLast> s_stage;
  const int b = blockIdx.y, j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = a.d + static_cast<long long>(b) * a.N;
  float v[kSteps], next[kSteps];
  load_chunk(v, row, chunk_base(j, 0, warp), a.N);
  for (int i = tid; i < kWarps * kBins; i += kThreads) (&s_hist[0][0])[i] = 0;
  if constexpr (kLast) {
    if (tid == 0) s_stage.n = 0;
  }
  if (warp == 0) {
    int leaf;
    const Bracket br = replay(a, r, b, kPass, s_cum, &leaf);
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
  // goes to a leaf (and, in the last pass, to the block's staging)
  unsigned below = 0, above = 0;
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) load_chunk(next, row, chunk_base(j, c + 1, warp), a.N);
    const long long base = chunk_base(j, c, warp);
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const float x = v[it];
      if (c + 1 < kChunks) v[it] = next[it];
      if (x < INFINITY) {  // padding and NaN are never counted
        if (x <= lo) {
          ++below;
        } else if (x > hi) {
          ++above;
        } else {
          int leaf = min(max(__float2int_rz((x - lo) * scale), 0), kBins - 1);
          if (!(ordered && x > s_edge[leaf] && x <= s_edge[leaf + 1])) leaf = leaf_of(x, s_mid);
          atomicAdd(&s_hist[warp][leaf], 1);
          if constexpr (kLast) {  // staged for the band buffer
            const int at = atomicAdd(&s_stage.n, 1);
            if (at < kBandSort) {
              s_stage.v[at] = x;
              s_stage.i[at] = static_cast<int>(base + it * 32 + lane);
            }
          }
        }
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
  if (c) atomicAdd(&a.hist[(static_cast<long long>(b) * kPasses + kPass) * kSlots + tid], c);
  if constexpr (kLast) {
    // the tile's inclusive scan, slot-major; the staged bracket elements'
    // place in the row's band buffer, one global atomic a block
    const int incl = warp_inclusive_sum(c, lane);
    if (lane == 31) s_scan[warp] = incl;
    const int staged = s_stage.n;
    if (tid == 0) {
      s_base = atomicAdd(&a.band_n[b], staged);
      if (staged > kBandSort) a.band_lost[b] = 1;
    }
    __syncthreads();
    int run = incl;
    for (int w = 0; w < warp; ++w) run += s_scan[w];
    if (tid < kSlots) {
      a.tiles[(static_cast<long long>(b) * kSlots + tid) * a.n_tiles + j] = run;
    }
    const long long off = static_cast<long long>(b) * a.band_cap + s_base;
    for (int e = tid; e < min(staged, kBandSort) && s_base + e < a.band_cap; e += kThreads) {
      a.band_val[off + e] = s_stage.v[e];
      a.band_idx[off + e] = s_stage.i[e];
    }
    // the row's last block to get here resolves it: the barrier orders the
    // block's writes before thread 0's fence and ticket
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      s_last = atomicAdd(&a.ticket[b], 1) == a.n_tiles - 1;
    }
    __syncthreads();
    if (s_last) resolve_row(a, r, b, s_stage.v, s_stage.i);
  }
}

// Final pass: the tile's elements of the answer, d < v* or d = v* with
// index ≤ i*, scattered in ascending index order after the answer's
// elements of the tiles before it; then the row's slots past its answer
// hold (+inf, −1).
__global__ void __launch_bounds__(kThreads, 4) select_compact_kernel(SelectArgs a) {
  __shared__ int s_warp_cnt[2][kWarps];  // by chunk parity: one barrier a chunk
  const int b = blockIdx.y, j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = a.d + static_cast<long long>(b) * a.N;
  float vals[kSteps], next[kSteps];
  load_chunk(vals, row, chunk_base(j, 0, warp), a.N);
  const float vs = __int_as_float(a.cut[2 * b]);
  // i* as an offset into the tile: elements at v* up to it are taken
  const long long rel = a.cut[2 * b + 1] - static_cast<long long>(j) * kTile;
  const int lim = rel < 0 ? -1 : static_cast<int>(min(rel, static_cast<long long>(kTile)));
  const int* st = a.starts + static_cast<long long>(b) * (a.n_tiles + 1);
  int start = st[j];  // the row's answer before this chunk
  const int total = st[a.n_tiles];

  float* ov = a.out_vals + static_cast<long long>(b) * a.T;
  int* oi = a.out_idx + static_cast<long long>(b) * a.T;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) load_chunk(next, row, chunk_base(j, c + 1, warp), a.N);
    const int local = c * kChunk + warp * kPerWarp + lane;  // this lane's first, in the tile
    unsigned keep = 0;  // bit `it`: this lane's element of step `it` is taken
    int wcount = 0;
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const float x = vals[it];
      const bool s = x < vs || (x == vs && local + it * 32 <= lim);
      keep |= static_cast<unsigned>(s) << it;
      wcount += __popc(__ballot_sync(rt::kFullMask, s));
    }
    if (lane == 0) s_warp_cnt[c & 1][warp] = wcount;
    __syncthreads();
    int pos = start;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += s_warp_cnt[c & 1][w];
      start += s_warp_cnt[c & 1][w];
    }
#pragma unroll
    for (int it = 0; it < kSteps; ++it) {
      const bool s = (keep >> it) & 1u;
      const unsigned m = __ballot_sync(rt::kFullMask, s);
      const int slot = pos + __popc(m & lower);
      if (s && slot < a.T) {
        ov[slot] = vals[it];
        oi[slot] = j * kTile + local + it * 32;
      }
      pos += __popc(m);
      if (c + 1 < kChunks) vals[it] = next[it];
    }
  }

  // slots past the row's answer hold (+inf, −1); the row's blocks share the fill
  for (long long s = total + static_cast<long long>(j) * kThreads + tid; s < a.T;
       s += static_cast<long long>(a.n_tiles) * kThreads) {
    ov[s] = INFINITY;
    oi[s] = -1;
  }
}

int n_tiles_of(int N) { return (N + kTile - 1) / kTile; }

// the band buffer's slots a row: past what the last pass's bracket
// holds on a smooth row (1/128 of a rung: 872–13,267 of the Deep1M
// twin's 1M), short of the whole row
int band_cap_of(int N) { return N < 4096 ? N : max(4096, N / 32); }

// scratch ints zeroed before the ladder: ladder, dmax, the row
// histograms, the tickets, the band counts and the lost flags
long long zeroed_ints(int B) {
  return static_cast<long long>(B) * (kRungs + 1 + kPasses * kSlots + 3);
}

}  // namespace

// Scratch ints radius_select_launch needs for (B, N).
extern "C" long long radius_select_scratch_ints(int B, int N) {
  const long long n_tiles = n_tiles_of(N);
  return zeroed_ints(B) +
         static_cast<long long>(B) * (kSlots * n_tiles + n_tiles + 1 + 2 + 2LL * band_cap_of(N));
}

// d (B, N), tau0 (B,) → vals (B, T), idx (B, T), count (B,), stats (B, 3).
// `rungs` is a host array of 16 floats.  Launches a memset and
// 2 + kPasses kernels on `stream` and returns cudaGetLastError() (or the
// memset's error).
extern "C" int radius_select_launch(const float* d, const float* tau0, const float* rungs,
                                    int B, int N, int T, float* out_vals, int* out_idx,
                                    int* out_count, int* out_stats, int* scratch,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SelectArgs a;
  a.d = d;
  a.tau0 = tau0;
  a.B = B;
  a.N = N;
  a.T = T;
  a.n_tiles = n_tiles_of(N);
  a.band_cap = band_cap_of(N);
  a.ladder = scratch;
  a.dmax = a.ladder + static_cast<long long>(B) * kRungs;
  a.hist = a.dmax + B;
  a.ticket = a.hist + static_cast<long long>(B) * kPasses * kSlots;
  a.band_n = a.ticket + B;
  a.band_lost = a.band_n + B;
  a.tiles = scratch + zeroed_ints(B);
  a.starts = a.tiles + static_cast<long long>(B) * kSlots * a.n_tiles;
  a.cut = a.starts + static_cast<long long>(B) * (a.n_tiles + 1);
  a.band_idx = a.cut + 2LL * B;
  a.band_val = reinterpret_cast<float*>(a.band_idx + static_cast<long long>(B) * a.band_cap);
  a.out_vals = out_vals;
  a.out_idx = out_idx;
  a.out_count = out_count;
  a.out_stats = out_stats;
  Rungs r;
  for (int l = 0; l < kRungs; ++l) r.v[l] = rungs[l];
  // the tiles' scans, the band, the starts and the cut are written whole
  const cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int) * zeroed_ints(B), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.n_tiles, B);
  select_ladder_kernel<<<grid, kThreads, 0, st>>>(a, r);
  select_pass_kernel<0><<<grid, kThreads, 0, st>>>(a, r);
  select_pass_kernel<1><<<grid, kThreads, 0, st>>>(a, r);
  select_compact_kernel<<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
