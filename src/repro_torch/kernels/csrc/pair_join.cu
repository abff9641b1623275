// Pruned blockwise closest-pair self-join on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pair_join.py:61
// (pair_join_kernel, launched by pair_join_pallas): the top-k closest
// pairs among the rows of x (n, d), sorted by a 1-D projection key.  The
// (n, n) pair space is cut into (bN, bN) tiles and walked band by band
// (band b holds the tiles (i, i + b)); a tile is skipped when its key
// gap key[j·bN] − key[last row of block i] is positive and its square
// exceeds thresh2 · ub², ub² being the k-th smallest pair d² so far.
// Joined tiles compute norm-trick float32 d² = (|xi|² + |xj|²) − 2·xi·xj,
// clamped at 0, for the pairs gj > gi.  The answer is ordered by d², ties
// to the earlier pair in traversal order, and the counters are
// [pairs_verified, tiles_pruned, bands_joined].
//
// What bounds it on the H100: a joined tile does bN²·d multiply-adds on
// 2·bN·d floats, so the join is bound by float32 arithmetic on CUDA cores
// (2·d flops per verified pair); the bytes are the joined tiles' rows.
//
// What the design does about the TPU kernel's serial grid.  There, each
// tile's skip decision reads the ub register left by every earlier tile.
// Here each band takes two launches:
//   1. pair_tiles_kernel, one block per tile of the band, in parallel:
//      a tile the ub² at the start of the band already prunes returns at
//      once; any other computes its d² in shared memory (8×8 outputs per
//      thread, d staged kChunk columns at a time), keeps the pairs below
//      that ub², and sorts them by (d², row-major position) to write its
//      own top-k.
//   2. pair_fold_kernel, one block: replays the band's tiles in order
//      under the running ub², exactly as the serial sweep does.  A tile
//      it prunes counts as pruned; any other adds its pairs to
//      pairs_verified and, if its best d² is below ub², merges its top-k
//      into the heap, heap entries first on ties.  ub only falls within
//      a band, so every tile the serial sweep joins was computed in 1,
//      and the pairs dropped in 1 (d² ≥ the band's first ub²) could never
//      enter the heap.  Answer and counters are those of the serial sweep.
// The key gap of (i, i + b) grows with b and ub never rises, so a band in
// which every tile is pruned ends the sweep: the fold kernel counts every
// later tile as pruned and raises a stop flag that makes the later bands'
// launches return at once.  The wrapper enqueues bands in groups and
// reads the flag between groups.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // tile kernel: 16 × 16 threads, 8 × 8 pairs each
constexpr int kTile = 128;          // largest tile side (ref.PAIR_JOIN_TILE)
constexpr int kChunk = 32;          // d-columns staged in shared memory at a time
constexpr int kStride = kTile + 1;  // padded staged column: conflict-free transposed stores
constexpr int kBuf = 2048;          // (d², position) slots sorted at a time
constexpr int kMaxK = 128;
constexpr int kFoldThreads = kMaxK;
constexpr int kFoldChunk = 2048;    // tiles of a band whose gap and best d² are staged at once

// dynamic shared memory of the tile kernel (floats): the tile's d², then
// either the two staged chunks or the sort buffer, then the row norms
constexpr int kStageFloats = 2 * kChunk * kStride;
static_assert(2 * kBuf <= kStageFloats, "the sort buffer reuses the staging area");
constexpr size_t kTileSmem = sizeof(float) * (kTile * kTile + kStageFloats + 2 * kTile);

__device__ __forceinline__ float tile_gap(const float* key, int n, int bN, int i, int j) {
  const int last_i = min((i + 1) * bN, n) - 1;
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

__device__ __forceinline__ int next_pow2(int v) {
  int p = 2;
  while (p < v) p <<= 1;
  return p;
}

__global__ void __launch_bounds__(kThreads, 2)
pair_tiles_kernel(const float* __restrict__ x, const float* __restrict__ key, int n, int d,
                  int bN, int band, int k, double thresh2, const float* __restrict__ heap_v,
                  const int* __restrict__ stop, float* __restrict__ tile_v,
                  int* __restrict__ tile_p) {
  if (*stop) return;
  const int i = blockIdx.x, j = i + band;
  const float ub2 = heap_v[k - 1];  // the ub² at the start of the band
  if (tile_pruned(tile_gap(key, n, bN, i, j), thresh2, ub2)) return;

  extern __shared__ float smem[];
  float* s_d = smem;                        // kTile × kTile
  float* s_a = smem + kTile * kTile;        // kChunk × kStride, column-major rows of block i
  float* s_b = s_a + kChunk * kStride;      // the same for block j
  float* s_v = s_a;                         // sort buffer, after the product
  int* s_p = reinterpret_cast<int*>(s_a + kBuf);
  float* s_ni = s_a + kStageFloats;
  float* s_nj = s_ni + kTile;
  __shared__ int s_count, s_fill;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int si = i * bN, sj = j * bN;
  const int mi = min(bN, n - si), mj = min(bN, n - sj);
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  float norm = 0.f;  // |x|² of row tid of block i (tid < kTile) or of block j

  for (int c0 = 0; c0 < d; c0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int row = e / kChunk, cc = e % kChunk, col = c0 + cc;
      const bool in_d = col < d;
      s_a[cc * kStride + row] =
          row < mi && in_d ? x[static_cast<long long>(si + row) * d + col] : 0.f;
      s_b[cc * kStride + row] =
          row < mj && in_d ? x[static_cast<long long>(sj + row) * d + col] : 0.f;
    }
    __syncthreads();
    {
      const float* s = tid < kTile ? s_a : s_b;
      const int row = tid & (kTile - 1);
      for (int cc = 0; cc < kChunk; ++cc) {
        const float v = s[cc * kStride + row];
        norm = __fadd_rn(norm, __fmul_rn(v, v));
      }
    }
#pragma unroll 4
    for (int cc = 0; cc < kChunk; ++cc) {
      float a[8], b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = s_a[cc * kStride + ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 8; ++v) b[v] = s_b[cc * kStride + tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();  // the next chunk overwrites the staging area
  }
  if (tid < kTile) {
    s_ni[tid] = norm;
  } else {
    s_nj[tid - kTile] = norm;
  }
  if (tid == 0) {
    s_count = 0;
    s_fill = 0;
  }
  __syncthreads();

  // d² of the pairs that could still enter the heap; +inf elsewhere
  int mine = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int row = ty + 16 * u, col = tx + 16 * v;
      float dd = INFINITY;
      if (row < mi && col < mj && sj + col > si + row) {
        dd = fmaxf(__fsub_rn(__fadd_rn(s_ni[row], s_nj[col]), __fmul_rn(2.f, acc[u][v])), 0.f);
        if (dd < ub2) {
          ++mine;
        } else {
          dd = INFINITY;
        }
      }
      s_d[row * kTile + col] = dd;
    }
  }
  if (mine) atomicAdd(&s_count, mine);
  __syncthreads();
  const int cnt = s_count;
  float* ov = tile_v + static_cast<long long>(i) * k;
  int* op = tile_p + static_cast<long long>(i) * k;
  if (cnt == 0) {
    for (int r = tid; r < k; r += kThreads) {
      ov[r] = INFINITY;
      op[r] = INT_MAX;
    }
    return;
  }

  // the tile's top-k by (d², position): the first k slots of s_v/s_p
  for (int r = tid; r < k; r += kThreads) {
    s_v[r] = INFINITY;
    s_p[r] = INT_MAX;
  }
  const int fresh = kBuf - k;
  if (cnt <= fresh) {  // compact the candidates, sort once
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const float v = s_d[e];
      if (v < INFINITY) {
        const int slot = k + atomicAdd(&s_fill, 1);
        s_v[slot] = v;
        s_p[slot] = e;
      }
    }
    const int len = next_pow2(k + cnt);
    __syncthreads();
    for (int t = k + cnt + tid; t < len; t += kThreads) {
      s_v[t] = INFINITY;
      s_p[t] = INT_MAX;
    }
    __syncthreads();
    rt::sort_pairs<kThreads>(s_v, s_p, len);
  } else {  // too many: a running top-k over windows of the tile
    for (int base = 0; base < kTile * kTile; base += fresh) {
      const int cw = min(fresh, kTile * kTile - base);
      for (int t = tid; t < fresh; t += kThreads) {
        const float v = t < cw ? s_d[base + t] : INFINITY;
        s_v[k + t] = v;
        s_p[k + t] = v < INFINITY ? base + t : INT_MAX;
      }
      __syncthreads();
      rt::sort_pairs<kThreads>(s_v, s_p, kBuf);
    }
  }
  for (int r = tid; r < k; r += kThreads) {
    ov[r] = s_v[r];
    op[r] = s_p[r];
  }
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

__global__ void __launch_bounds__(kFoldThreads)
pair_fold_kernel(const float* __restrict__ key, int n, int bN, int n_ti, int band, int k,
                 double thresh2, const float* __restrict__ tile_v,
                 const int* __restrict__ tile_p, float* __restrict__ heap_v,
                 int* __restrict__ heap_i, int* __restrict__ heap_j,
                 long long* __restrict__ stats, int* __restrict__ stop) {
  if (*stop) return;
  __shared__ float s_hv[2][kMaxK];
  __shared__ int s_hi[2][kMaxK], s_hj[2][kMaxK];
  __shared__ float s_tv[kMaxK];
  __shared__ int s_tp[kMaxK];
  __shared__ float s_gap[kFoldChunk], s_best[kFoldChunk];
  const int tid = threadIdx.x;
  if (tid < k) {
    s_hv[0][tid] = heap_v[tid];
    s_hi[0][tid] = heap_i[tid];
    s_hj[0][tid] = heap_j[tid];
  }
  int cur = 0;
  long long pairs = 0, pruned = 0, joined = 0;  // the same in every thread
  const int nt = n_ti - band;
  for (int t0 = 0; t0 < nt; t0 += kFoldChunk) {
    const int cn = min(kFoldChunk, nt - t0);
    __syncthreads();  // readers of the previous chunk are done
    for (int c = tid; c < cn; c += kFoldThreads) {
      const int i = t0 + c;
      s_gap[c] = tile_gap(key, n, bN, i, i + band);
      // stale where the tile kernel skipped the tile: read only for
      // tiles it joined (see the header)
      s_best[c] = tile_v[static_cast<long long>(i) * k];
    }
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
      const float ub2 = s_hv[cur][k - 1];
      if (tile_pruned(s_gap[c], thresh2, ub2)) {
        ++pruned;
        continue;
      }
      const int i = t0 + c, j = i + band;
      ++joined;
      pairs += valid_pairs(n, bN, i, j);
      if (!(s_best[c] < ub2)) continue;  // the heap wins ties: nothing changes
      if (tid < k) {
        s_tv[tid] = tile_v[static_cast<long long>(i) * k + tid];
        s_tp[tid] = tile_p[static_cast<long long>(i) * k + tid];
      }
      __syncthreads();
      if (tid < k) {  // merge by rank: heap entries first among equal d²
        const int nxt = cur ^ 1;
        const float va = s_hv[cur][tid];
        const int ra = tid + count_below(s_tv, k, va);
        if (ra < k) {
          s_hv[nxt][ra] = va;
          s_hi[nxt][ra] = s_hi[cur][tid];
          s_hj[nxt][ra] = s_hj[cur][tid];
        }
        const float vb = s_tv[tid];
        const int rb = tid + count_at_most(s_hv[cur], k, vb);
        if (rb < k) {
          const int p = s_tp[tid];
          s_hv[nxt][rb] = vb;
          s_hi[nxt][rb] = p == INT_MAX ? -1 : i * bN + p / kTile;
          s_hj[nxt][rb] = p == INT_MAX ? -1 : j * bN + p % kTile;
        }
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  __syncthreads();
  if (tid < k) {
    heap_v[tid] = s_hv[cur][tid];
    heap_i[tid] = s_hi[cur][tid];
    heap_j[tid] = s_hj[cur][tid];
  }
  if (tid == 0) {
    if (joined == 0) {  // every later tile has a wider gap under a ub no larger
      const long long rest = n_ti - band - 1;
      pruned += rest * (rest + 1) / 2;
      *stop = 1;
    }
    stats[0] += pairs;
    stats[1] += pruned;
    stats[2] += joined > 0;
  }
}

}  // namespace

// Bands band0 .. band0 + bands − 1 of the join of x (n, d), key (n,) in
// tiles of bN ≤ 128 rows.  heap_v/heap_i/heap_j (k), stats (3) and stop
// carry the sweep from one call to the next; tile_v/tile_p are scratch
// of n_ti·k entries.  Returns cudaGetLastError().
extern "C" int pair_join_bands_launch(const float* x, const float* key, int n, int d, int bN,
                                      int n_ti, int band0, int bands, int k, double thresh2,
                                      float* heap_v, int* heap_i, int* heap_j,
                                      long long* stats, int* stop, float* tile_v, int* tile_p,
                                      void* stream) {
  if (n < 1 || d < 1 || bN < 1 || bN > kTile || k < 1 || k > kMaxK || band0 < 0 ||
      band0 + bands > n_ti || n_ti != (n + bN - 1) / bN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      pair_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kTileSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int b = band0; b < band0 + bands; ++b) {
    pair_tiles_kernel<<<n_ti - b, kThreads, kTileSmem, st>>>(x, key, n, d, bN, b, k, thresh2,
                                                             heap_v, stop, tile_v, tile_p);
    pair_fold_kernel<<<1, kFoldThreads, 0, st>>>(key, n, bN, n_ti, b, k, thresh2, tile_v,
                                                 tile_p, heap_v, heap_i, heap_j, stats, stop);
  }
  return static_cast<int>(cudaGetLastError());
}
