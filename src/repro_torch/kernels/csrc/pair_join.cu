// Pruned blockwise closest-pair self-join on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pair_join.py:61
// (pair_join_kernel, launched by pair_join_pallas at :247): the top-k ≤ 128
// closest pairs among the rows of x (n, d), sorted by a 1-D projection key.
// The (n, n) pair space is cut into (bN, bN) tiles and walked band by band
// (band b holds the tiles (i, i + b)); a tile is skipped when its key gap
// key[j·bN] − key[last row of block i] is positive and its square exceeds
// thresh2 · ub², ub² being the k-th smallest pair d² so far.  Joined tiles
// compute norm-trick float32 d² = (|xi|² + |xj|²) − 2·xi·xj, clamped at 0,
// for the pairs gj > gi.  The answer is ordered by d², ties to the earlier
// pair in traversal order, and the counters are [pairs_verified,
// tiles_pruned, bands_joined]: the serial sweep's, bit for bit.
//
// What bounds it on the H100: a joined tile does bN²·d multiply-adds on
// 2·bN·d floats, so the join is bound by float32 arithmetic on CUDA cores
// (2·d flops per verified pair).
//
// What the design does about the TPU kernel's serial grid.  There, each
// tile's skip decision reads the ub left by every earlier tile.  Here one
// cooperative launch of co-resident blocks (the occupancy × the SMs) walks
// the whole sweep, in groups of bands, with two grid barriers a group and
// no host read:
//   1. plan (block 0): the group's candidate tiles, those the ub² at the
//      start of the group does not prune, listed in traversal order.  A
//      group takes one band while ub² is +inf (the heap is not full), else
//      bands until it lists kGroupWaves tiles a block (or spans kGroupBands
//      bands); a band with no candidate ends it, and the sweep, since ub
//      only falls.
//   2. tiles (every block): blocks take candidates from an atomic counter.
//      The product runs 8 × 8 pairs a thread, columns staged kChunk at a
//      time by cp.async (16-byte copies where d % 4 == 0 and x is aligned,
//      4-byte ones otherwise), the next chunk in flight while the current
//      one is multiplied.  The tile's own top-k goes by threshold: the
//      k-th smallest of the threads' minimum (d², position) keys bounds the
//      answer (k distinct pairs lie at or below it), only keys at or below
//      it and below the group's first ub² enter a buffer (at most 64·k),
//      and only that buffer is sorted.
//   3. fold (one warp of block 0): replays the group's candidates in order
//      under the running ub², 32 at a time: a ballot finds the first tile
//      that is joined with a best d² below ub²; every tile before it is
//      decided (pruned, or joined with nothing to add) under the same ub²
//      and counted at once; that tile's top-k merges into the heap by rank,
//      heap entries first among equal d², and the scan resumes after it.
//      A tile the plan left out is pruned at any later ub².  ub only falls
//      within a group, so every tile the serial sweep joins was computed in
//      2, and the pairs dropped there (d² ≥ the group's first ub²) could
//      never enter the heap.  A band that joins nothing ends the sweep: the
//      fold counts every later tile as pruned.
// Per pair the arithmetic is fixed whatever the schedule: fmaf over the
// columns in order for the cross term, __fadd_rn(__fmul_rn) in column
// order for the norms, so d² and positions do not depend on how blocks and
// threads share the tiles.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;       // 16 × 16 threads, 8 × 8 pairs each
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;          // largest tile side (ref.PAIR_JOIN_TILE)
constexpr int kChunk = 32;          // d-columns staged at a time
constexpr int kLd = kChunk + 4;     // staged row stride: 16-byte rows, conflict-free float4 reads
constexpr int kStageFloats = 2 * kTile * kLd;  // one chunk of both row blocks
constexpr size_t kSmem = sizeof(float) * 2 * kStageFloats;  // two chunks in flight
constexpr int kMaxK = 128;
constexpr int kBufKeys = 64 * kMaxK;  // 64 keys of each of ≤ k threads
constexpr int kGroupWaves = 8;        // candidate tiles a group lists per block of the grid
constexpr unsigned long long kPad = ~0ull;
static_assert(kBufKeys * sizeof(unsigned long long) <= kSmem, "the key buffer reuses the stage");
// The fold stages kFoldWindow candidates at a time (8 loads a lane in
// flight) in the same shared memory; a group spans at most kGroupBands
// bands, whose candidate counts block 0 keeps; the plan tests kPlanPer
// tiles a thread at a time.
constexpr int kFoldWindow = 256;
constexpr int kGroupBands = 512;
constexpr int kPlanPer = 4;

// the control words at the start of scratch, rewritten by block 0 between
// barriers; from int kSweep on, kSweepLen int64 that describe the sweep
// (the wrapper's sweep=True reads them): the ns block 0 spent in the tile
// phases and in the plan and fold phases, barriers included, the groups,
// the tiles computed, and the merges into the heap
enum Ctrl { kNext, kTotal, kBand0, kBand1, kStop, kUb2, kSweep = 8, kCtrlInts = 64 };
constexpr int kSweepLen = 5;

struct Args {
  const float* x;
  const float* key;
  int n, d, bN, n_ti, k, target;
  double thresh2;
  float* heap_v;
  int* heap_i;
  int* heap_j;
  long long* stats;
  int* ctrl;
  int* cand_i;      // the group's candidate tiles in traversal order: block row i,
  int* cand_b;      //   band b,
  float* cand_gap;  //   key gap
  float* tile_v;    // each candidate's top-k (d², position in the tile)
  int* tile_p;
};

struct Shared {
  unsigned long long min_key[kThreads];
  float norm[2 * kTile];
  float hv[2][kMaxK];  // the pair heap, double-buffered for the merge (block 0)
  int hi[2][kMaxK], hj[2][kMaxK];
  float tv[kMaxK];     // the tile merged into it
  int tp[kMaxK];
  int warp_count[kPlanPer * kWarps];
  int band[kGroupBands];  // candidates of each band of the group (block 0)
  int work, fill, stop;
  float ub2;
  unsigned long long thr;  // the tile's threshold key
};

__device__ __forceinline__ float tile_gap(const float* key, int n, int bN, int i, int j) {
  const int last_i = min(i * bN + (bN - 1), n - 1);  // i·bN < n: no overflow
  return __fsub_rn(key[j * bN], key[last_i]);
}

// The skip test, in double as the reference's host loop does it.  inf·0
// is NaN and compares false, as it does there.
__device__ __forceinline__ bool tile_pruned(float gap, double thresh2, float ub2) {
  if (!(gap > 0.f)) return false;
  const double g = static_cast<double>(gap);
  return __dmul_rn(g, g) > __dmul_rn(thresh2, static_cast<double>(ub2));
}

__device__ __forceinline__ long long valid_pairs(int n, int bN, int i, int j) {
  const long long mi = min(bN, n - i * bN), mj = min(bN, n - j * bN);
  return i == j ? mi * (mi - 1) / 2 : mi * mj;
}

// (d², position) as one key whose unsigned order is (d², position)'s:
// d² ≥ +0 is finite here, so its bits are monotone.
__device__ __forceinline__ unsigned long long pair_key(float dd, int pos) {
  return (static_cast<unsigned long long>(__float_as_uint(dd)) << 32) |
         static_cast<unsigned int>(pos);
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Columns c0 .. c0 + kChunk of the rows of block i (rows 0..mi) and block j
// into stage[2][kTile][kLd], zeros past the rows and past d.
template <bool kVec>
__device__ __forceinline__ void stage_chunk(const float* x, int d, int si, int mi, int sj,
                                            int mj, int c0, float* stage) {
  constexpr int kPer = kVec ? kChunk / 4 : kChunk;  // copies a row of a block takes
#pragma unroll 4
  for (int e = threadIdx.x; e < 2 * kTile * kPer; e += kThreads) {
    const int half = e / (kTile * kPer);
    const int r = (e / kPer) % kTile, q = e % kPer;
    const int col = c0 + (kVec ? 4 * q : q);
    const bool in = r < (half ? mj : mi) && col < d;  // d % 4 == 0: a quad is whole
    const float* src = in ? x + static_cast<long long>((half ? sj : si) + r) * d + col : x;
    float* dst = stage + half * kTile * kLd + r * kLd + (kVec ? 4 * q : q);
    if constexpr (kVec) {
      rt::cp_async16(dst, src, in ? 16 : 0);
    } else {
      rt::cp_async4(dst, src, in ? 4 : 0);
    }
  }
}

// The 32 keys of a warp, one a lane, sorted ascending across the lanes.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long other = __shfl_xor_sync(rt::kFullMask, key, stride);
      const bool up = (lane & size) == 0 || size == 32;
      key = ((lane & stride) == 0) == up ? min(key, other) : max(key, other);
    }
  }
  return key;
}

// Keys of the ascending run[0..32) below x.
__device__ __forceinline__ int count_keys_below(const unsigned long long* run,
                                                unsigned long long x) {
  int lo = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (run[lo + step - 1] < x) lo += step;
  }
  return lo + (run[lo] < x);
}

// Slot r of a tile's top-k: the key's (d², position), (+inf, INT_MAX) for kPad.
__device__ __forceinline__ void write_entry(float* out_v, int* out_p, int r,
                                            unsigned long long key) {
  out_v[r] = key == kPad ? INFINITY : __uint_as_float(static_cast<unsigned>(key >> 32));
  out_p[r] = key == kPad ? INT_MAX : static_cast<int>(key & 0xffffffffull);
}

// Candidate w of the group: its tile's d² under the group's first ub², and
// its top-k (d² ascending, then position row·kTile + col) into
// tile_v / tile_p, (+inf, INT_MAX) past its pairs below ub².
template <bool kVec>
__device__ void join_tile(const Args& a, int w, float ub2, float* smem, Shared& sh) {
  const int i = __ldcg(a.cand_i + w), j = i + __ldcg(a.cand_b + w);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31, warp = tid >> 5;
  const int si = i * a.bN, sj = j * a.bN;
  const int mi = min(a.bN, a.n - si), mj = min(a.bN, a.n - sj);
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  float norm = 0.f;  // |x|² of row tid of block i (tid < kTile) or of block j

  const int chunks = (a.d + kChunk - 1) / kChunk;
  stage_chunk<kVec>(a.x, a.d, si, mi, sj, mj, 0, smem);
  rt::cp_commit();
  for (int c = 0; c < chunks; ++c) {
    rt::cp_wait_all();  // this thread's copies of chunk c have landed
    __syncthreads();  // everyone's have, and everyone is done with chunk c − 1
    if (c + 1 < chunks) {  // into chunk c − 1's stage, in flight while c is multiplied
      stage_chunk<kVec>(a.x, a.d, si, mi, sj, mj, (c + 1) * kChunk,
                        smem + ((c + 1) & 1) * kStageFloats);
      rt::cp_commit();
    }
    const float* sa = smem + (c & 1) * kStageFloats;
    const float* sb = sa + kTile * kLd;
    {
      const float4* row =
          reinterpret_cast<const float4*>((tid < kTile ? sa : sb) + (tid & (kTile - 1)) * kLd);
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        const float4 v = row[q];
        norm = __fadd_rn(norm, __fmul_rn(v.x, v.x));
        norm = __fadd_rn(norm, __fmul_rn(v.y, v.y));
        norm = __fadd_rn(norm, __fmul_rn(v.z, v.z));
        norm = __fadd_rn(norm, __fmul_rn(v.w, v.w));
      }
    }
#pragma unroll 1
    for (int q = 0; q < kChunk / 4; ++q) {
      float4 bv[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        bv[v] = reinterpret_cast<const float4*>(sb + (tx + 16 * v) * kLd)[q];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 av = reinterpret_cast<const float4*>(sa + (ty + 16 * u) * kLd)[q];
#pragma unroll
        for (int v = 0; v < 8; ++v) {  // each sum takes its columns in order
          acc[u][v] = fmaf(av.x, bv[v].x, acc[u][v]);
          acc[u][v] = fmaf(av.y, bv[v].y, acc[u][v]);
          acc[u][v] = fmaf(av.z, bv[v].z, acc[u][v]);
          acc[u][v] = fmaf(av.w, bv[v].w, acc[u][v]);
        }
      }
    }
  }
  sh.norm[tid] = norm;
  if (tid == 0) {
    sh.fill = 0;
    sh.thr = kPad;
  }
  __syncthreads();

  // d² of the pairs that could still enter the heap (+inf elsewhere), and
  // this thread's least key: positions grow with (u, v), so the first
  // least d² holds the least position among its ties
  float least_d = INFINITY;
  int least_p = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int row = ty + 16 * u, col = tx + 16 * v;
      float dd = INFINITY;
      if (row < mi && col < mj && sj + col > si + row) {
        dd = fmaxf(__fsub_rn(__fadd_rn(sh.norm[row], sh.norm[kTile + col]),
                             __fmul_rn(2.f, acc[u][v])), 0.f);
        if (!(dd < ub2)) dd = INFINITY;
      }
      acc[u][v] = dd;
      if (dd < least_d) {
        least_d = dd;
        least_p = row * kTile + col;
      }
    }
  }
  const unsigned long long least = least_d < INFINITY ? pair_key(least_d, least_p) : kPad;
  // the threshold: the k-th smallest of the threads' least keys, found as
  // the key whose rank among the warps' sorted runs is k − 1
  const unsigned long long mine = warp_sort(least);
  sh.min_key[tid] = mine;
  float* out_v = a.tile_v + static_cast<long long>(w) * a.k;
  int* out_p = a.tile_p + static_cast<long long>(w) * a.k;
  if (!__syncthreads_or(least != kPad)) {  // no pair below ub²
    for (int r = tid; r < a.k; r += kThreads) {
      out_v[r] = INFINITY;
      out_p[r] = INT_MAX;
    }
    return;
  }
  if (mine != kPad) {
    int rank = lane;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      if (q != warp) rank += count_keys_below(sh.min_key + 32 * q, mine);
    }
    if (rank == a.k - 1) sh.thr = mine;
  }
  __syncthreads();
  const unsigned long long thr = sh.thr;
  // keys at or below thr, appended one by one: ≤ 64 of each of the ≤ k
  // threads whose least key is at or below thr
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem);
  if (least <= thr) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        if (acc[u][v] < INFINITY) {
          const unsigned long long key =
              pair_key(acc[u][v], (ty + 16 * u) * kTile + tx + 16 * v);
          if (key <= thr) s_key[atomicAdd(&sh.fill, 1)] = key;
        }
      }
    }
  }
  __syncthreads();
  const int cnt = sh.fill;
  if (cnt <= 32) {  // one warp sorts it
    if (warp == 0) {
      const unsigned long long key = warp_sort(lane < cnt ? s_key[lane] : kPad);
      if (lane < a.k) write_entry(out_v, out_p, lane, key);
      for (int r = 32 + lane; r < a.k; r += 32) write_entry(out_v, out_p, r, kPad);
    }
    return;
  }
  int len = 64;
  while (len < cnt || len < a.k) len <<= 1;
  for (int t = cnt + tid; t < len; t += kThreads) s_key[t] = kPad;
  __syncthreads();
  rt::sort_keys<kThreads>(s_key, len);
  for (int r = tid; r < a.k; r += kThreads) write_entry(out_v, out_p, r, s_key[r]);
}

// Entries of the ascending v[0..len) strictly below x / at most x.
__device__ __forceinline__ int count_below(const float* v, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_at_most(const float* v, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge candidate w, tile (i, i + b), into the heap by rank, heap entries
// first among equal d²; one warp, the heap in sh.hv[cur].
__device__ void merge_tile(const Args& a, Shared& sh, int& cur, int w, int i, int b) {
  const int lane = threadIdx.x & 31, k = a.k;
  const long long base = static_cast<long long>(w) * k;
  for (int e = lane; e < k; e += 32) {
    sh.tv[e] = __ldcg(a.tile_v + base + e);
    sh.tp[e] = __ldcg(a.tile_p + base + e);
  }
  __syncwarp();
  const int nxt = cur ^ 1;
  for (int e = lane; e < k; e += 32) {
    const float va = sh.hv[cur][e];
    const int ra = e + count_below(sh.tv, k, va);
    if (ra < k) {
      sh.hv[nxt][ra] = va;
      sh.hi[nxt][ra] = sh.hi[cur][e];
      sh.hj[nxt][ra] = sh.hj[cur][e];
    }
    const float vb = sh.tv[e];
    const int rb = e + count_at_most(sh.hv[cur], k, vb);
    if (rb < k) {
      const int p = sh.tp[e];
      sh.hv[nxt][rb] = vb;
      sh.hi[nxt][rb] = p == INT_MAX ? -1 : i * a.bN + p / kTile;
      sh.hj[nxt][rb] = p == INT_MAX ? -1 : (i + b) * a.bN + p % kTile;
    }
  }
  __syncwarp();
  cur = nxt;
}

// The serial sweep over bands g0 .. g1 − 1 and their `total` candidates,
// replayed by one warp, which stages the candidates (gap, best d², block
// row) kFoldWindow at a time in `win`.  Each lane keeps its share of the
// counters; returns whether the sweep ends.
__device__ bool fold_group(const Args& a, Shared& sh, float* win, int g0, int g1, int total,
                           int& cur, long long& pairs, long long& pruned, long long& bands,
                           long long& merged) {
  const int lane = threadIdx.x & 31, k = a.k;
  float* win_gap = win;
  float* win_best = win + kFoldWindow;
  int* win_row = reinterpret_cast<int*>(win + 2 * kFoldWindow);
  int w0 = 0, win0 = 0, win1 = 0;  // candidates win0 .. win1 are staged
  for (int b = g0; b < g1; ++b) {
    const int nc = sh.band[b - g0];
    if (lane == 0) pruned += (a.n_ti - b) - nc;  // left out by the plan
    int joined = 0;
    for (int c0 = 0; c0 < nc; c0 += 32) {
      if (w0 + c0 + min(32, nc - c0) > win1) {  // past the window: stage the next
        __syncwarp();
        win0 = w0 + c0;
        win1 = min(total, win0 + kFoldWindow);
#pragma unroll
        for (int r = 0; r < kFoldWindow / 32; ++r) {  // all loads in flight at once
          const int e = r * 32 + lane, at = win0 + e;
          if (at < win1) {
            win_gap[e] = __ldcg(a.cand_gap + at);
            win_best[e] = __ldcg(a.tile_v + static_cast<long long>(at) * k);
            win_row[e] = __ldcg(a.cand_i + at);
          }
        }
        __syncwarp();
      }
      const int w = w0 + c0 + lane - win0;
      const bool valid = c0 + lane < nc;
      const float gap = valid ? win_gap[w] : 0.f;
      const float best = valid ? win_best[w] : INFINITY;
      const int i = valid ? win_row[w] : 0;
      const long long vp = valid_pairs(a.n, a.bN, i, i + b);
      int start = 0;  // lanes below start are decided
      for (;;) {  // one pass per merge: ub² is constant within a pass
        const float ub2 = sh.hv[cur][k - 1];
        const bool live = valid && lane >= start;
        const bool pr = live && tile_pruned(gap, a.thresh2, ub2);
        const unsigned merges = __ballot_sync(rt::kFullMask, live && !pr && best < ub2);
        const int last = merges ? __ffs(merges) - 1 : 31;
        const bool decided = live && lane <= last;
        if (decided) {
          if (pr) {
            ++pruned;
          } else {
            pairs += vp;
          }
        }
        joined += __popc(__ballot_sync(rt::kFullMask, decided && !pr));
        if (!merges) break;
        merge_tile(a, sh, cur, w0 + c0 + last, __shfl_sync(rt::kFullMask, i, last), b);
        merged += lane == 0;
        start = last + 1;
      }
    }
    w0 += nc;
    if (joined == 0) {  // every later tile has a wider gap under a ub no larger
      if (lane == 0) {
        const long long rest = a.n_ti - b - 1;
        pruned += rest * (rest + 1) / 2;
      }
      return true;
    }
    if (lane == 0) ++bands;
  }
  return g1 >= a.n_ti;
}

// Block 0: list the candidate tiles of the group that starts at band b
// under ub2, in traversal order, kPlanPer tiles a thread at a time;
// returns the band after the group's last.
__device__ int plan_group(const Args& a, Shared& sh, int b, float ub2, int* total_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = b;
  int total = 0;
  while (b < a.n_ti) {
    const int nt = a.n_ti - b;
    int nc = 0;
    for (int base = 0; base < nt; base += kPlanPer * kThreads) {
      float gap[kPlanPer];
      bool cand[kPlanPer];
      unsigned vote[kPlanPer];
#pragma unroll
      for (int r = 0; r < kPlanPer; ++r) {  // tile base + r·kThreads + tid
        const int i = base + r * kThreads + tid;
        gap[r] = i < nt ? tile_gap(a.key, a.n, a.bN, i, i + b) : 0.f;
        cand[r] = i < nt && !tile_pruned(gap[r], a.thresh2, ub2);
        vote[r] = __ballot_sync(rt::kFullMask, cand[r]);
        if (lane == 0) sh.warp_count[r * kWarps + warp] = __popc(vote[r]);
      }
      __syncthreads();
      int before = 0;  // candidates ahead of this warp's tile in round r
#pragma unroll
      for (int r = 0; r < kPlanPer; ++r) {
        int ahead = before;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          const int c = sh.warp_count[r * kWarps + q];
          ahead += q < warp ? c : 0;
          before += c;
        }
        if (cand[r]) {
          const int at = total + nc + ahead + __popc(vote[r] & ((1u << lane) - 1u));
          a.cand_i[at] = base + r * kThreads + tid;
          a.cand_b[at] = b;
          a.cand_gap[at] = gap[r];
        }
      }
      nc += before;
      __syncthreads();  // warp_count is rewritten next
    }
    if (tid == 0) sh.band[b - b0] = nc;
    total += nc;
    ++b;
    if (nc == 0 || !(ub2 < INFINITY) || total >= a.target || b - b0 == kGroupBands) break;
  }
  *total_out = total;
  return b;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) pair_join_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Shared sh;
  const cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool lead = blockIdx.x == 0;
  int* ctrl = a.ctrl;
  // block 0, warp 0: the heap's current buffer and its share of the counters
  int cur = 0;
  long long pairs = 0, pruned = 0, bands = 0;
  long long t = global_ns(), tile_ns = 0, fold_ns = 0, merged = 0;  // block 0, thread 0
  long long groups = 0, tiles = 0;

  if (lead) {
    for (int e = tid; e < a.k; e += kThreads) {
      sh.hv[0][e] = INFINITY;
      sh.hi[0][e] = -1;
      sh.hj[0][e] = -1;
    }
    int total = 0;
    const int g1 = plan_group(a, sh, 0, INFINITY, &total);
    if (tid == 0) {
      ctrl[kNext] = 0;
      ctrl[kTotal] = total;
      ctrl[kBand0] = 0;
      ctrl[kBand1] = g1;
      ctrl[kStop] = 0;
      ctrl[kUb2] = __float_as_int(INFINITY);
    }
  }
  grid.sync();
  fold_ns += global_ns() - t;
  for (;;) {
    t = global_ns();
    const int total = __ldcg(ctrl + kTotal);
    const float ub2 = __int_as_float(__ldcg(ctrl + kUb2));
    ++groups;
    tiles += total;
    for (;;) {
      __syncthreads();  // every thread has read sh.work
      if (tid == 0) sh.work = atomicAdd(ctrl + kNext, 1);
      __syncthreads();
      const int w = sh.work;
      if (w >= total) break;
      join_tile<kVec>(a, w, ub2, smem, sh);
    }
    grid.sync();
    tile_ns += global_ns() - t;
    t = global_ns();
    if (lead) {
      const int g0 = __ldcg(ctrl + kBand0), g1 = __ldcg(ctrl + kBand1);
      if (warp == 0) {
        const bool stop =
            fold_group(a, sh, smem, g0, g1, total, cur, pairs, pruned, bands, merged);
        if (lane == 0) {
          sh.stop = stop;
          sh.ub2 = sh.hv[cur][a.k - 1];
        }
      }
      __syncthreads();
      int next_total = 0, next_g1 = g1;
      if (!sh.stop) next_g1 = plan_group(a, sh, g1, sh.ub2, &next_total);
      if (tid == 0) {
        ctrl[kNext] = 0;
        ctrl[kTotal] = next_total;
        ctrl[kBand0] = g1;
        ctrl[kBand1] = next_g1;
        ctrl[kStop] = sh.stop;
        ctrl[kUb2] = __float_as_int(sh.ub2);
      }
    }
    grid.sync();
    fold_ns += global_ns() - t;
    if (__ldcg(ctrl + kStop)) break;
  }
  if (lead && warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      pairs += __shfl_xor_sync(rt::kFullMask, pairs, o);
      pruned += __shfl_xor_sync(rt::kFullMask, pruned, o);
      bands += __shfl_xor_sync(rt::kFullMask, bands, o);
    }
    for (int e = lane; e < a.k; e += 32) {
      a.heap_v[e] = sh.hv[cur][e];
      a.heap_i[e] = sh.hi[cur][e];
      a.heap_j[e] = sh.hj[cur][e];
    }
    if (lane == 0) {
      long long* sweep = reinterpret_cast<long long*>(ctrl + kSweep);
      const long long trace[kSweepLen] = {tile_ns, fold_ns, groups, tiles, merged};
      for (int e = 0; e < kSweepLen; ++e) sweep[e] = trace[e];
      a.stats[0] = pairs;
      a.stats[1] = pruned;
      a.stats[2] = bands;
    }
  }
}

// Blocks of pair_join_kernel<kVec> the current device holds at once;
// 0 with the CUDA error in *err where the query fails.
template <bool kVec>
int coresident(cudaError_t* err) {
  static int cache[rt::kMaxDevices] = {0};
  return rt::resident_grid(reinterpret_cast<const void*>(pair_join_kernel<kVec>), kThreads,
                           kSmem, cache, err);
}

size_t align256(size_t v) { return (v + 255) & ~static_cast<size_t>(255); }

// Scratch layout for n_ti tiles a band, a group listing fewer than
// cap = target + n_ti candidates; returns its bytes.
long long scratch_layout(int n_ti, int k, int target, Args* a, char* base) {
  const long long cap = static_cast<long long>(target) + n_ti;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  char* ctrl = take(sizeof(int) * kCtrlInts);
  char* cand_i = take(sizeof(int) * cap);
  char* cand_b = take(sizeof(int) * cap);
  char* cand_gap = take(sizeof(float) * cap);
  char* tile_v = take(sizeof(float) * cap * k);
  char* tile_p = take(sizeof(int) * cap * k);
  if (a != nullptr) {
    a->ctrl = reinterpret_cast<int*>(ctrl);
    a->cand_i = reinterpret_cast<int*>(cand_i);
    a->cand_b = reinterpret_cast<int*>(cand_b);
    a->cand_gap = reinterpret_cast<float*>(cand_gap);
    a->tile_v = reinterpret_cast<float*>(tile_v);
    a->tile_p = reinterpret_cast<int*>(tile_p);
  }
  return static_cast<long long>(off);
}

int group_target(cudaError_t* err) {
  const int grid = max(coresident<true>(err), coresident<false>(err));
  return kGroupWaves * grid;
}

}  // namespace

// Bytes of scratch pair_join_launch needs for n rows in tiles of bN and a
// top-k of k on the current device; −1 where the device query fails.
extern "C" long long pair_join_scratch_bytes(int n, int bN, int k) {
  if (n < 1 || bN < 1 || k < 1) return -1;
  cudaError_t err = cudaSuccess;
  const int target = group_target(&err);
  if (err != cudaSuccess) return -1;
  return scratch_layout((n + bN - 1) / bN, k, target, nullptr, nullptr);
}

// The join of x (n, d), key (n,) sorted ascending, in tiles of bN ≤ 128
// rows: heap_v/heap_i/heap_j (k) the answer, stats (3) the counters, all
// written by the kernel.  One cooperative launch of the co-resident grid
// on `stream`; nothing is read back.  Returns cudaGetLastError() (a
// refused cooperative launch included), or cudaErrorInvalidValue for
// arguments out of range or too little scratch.
extern "C" int pair_join_launch(const float* x, const float* key, int n, int d, int bN, int k,
                                double thresh2, float* heap_v, int* heap_i, int* heap_j,
                                long long* stats, void* scratch, long long scratch_bytes,
                                void* stream) {
  if (n < 1 || d < 1 || bN < 1 || bN > kTile || k < 1 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = cudaSuccess;
  const int grid = vec ? coresident<true>(&err) : coresident<false>(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int target = group_target(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{x, key, n, d, bN, (n + bN - 1) / bN, k, target, thresh2, heap_v, heap_i, heap_j,
         stats};
  if (scratch_layout(a.n_ti, k, target, nullptr, nullptr) > scratch_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scratch_layout(a.n_ti, k, target, &a, static_cast<char*>(scratch));
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      vec ? reinterpret_cast<const void*>(pair_join_kernel<true>)
          : reinterpret_cast<const void*>(pair_join_kernel<false>),
      dim3(grid), dim3(kThreads), params, kSmem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
