// Radius-threshold candidate selection on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/select.py:55
// (radius_select_kernel, launched by radius_select_pallas): for each row
// of d (B, N), a ladder of 16 rungs τ0·2.25^(l−8) brackets the T-th
// smallest value, 14 bisection passes narrow the bracket, and a last
// pass compacts the survivors d ≤ hi, in ascending index order, into
// T_pad slots, with the exact survivor count of each row.
//
// What bounds it on the H100: every pass streams the (B, N) row block
// from device memory and does a compare or two per element, so the
// kernel is bound by memory: 16 reads of B·N floats.
//
// What the design does about it.  The TPU kernel carries lo, hi and the
// counts in VMEM across a serial grid and compacts through an SMEM write
// cursor; on the GPU the blocks of a pass run in parallel and in no
// order.  So each pass is one launch over (tiles of N) × B, and blocks
// publish their counts with integer atomics into a small device buffer.
// The bracket is never stored: every block of a pass replays it from the
// ladder counts and the earlier passes' counts with the same float
// operations, so all blocks agree on lo, hi and mid without a host sync
// or an extra launch.  The last bisection pass also records each tile's
// survivor count under both possible final thresholds; the compaction
// pass sums the counts of the tiles before its own (the exclusive scan)
// and scatters its survivors with warp ballots, which keeps ascending
// index order: the lowest-index tie-break depends on it.  Loads are
// coalesced: each warp walks 32 consecutive elements at a time.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 512;                 // consecutive elements per warp
constexpr int kSteps = kPerWarp / 32;         // 32-element steps per warp
constexpr int kTile = kWarps * kPerWarp;      // elements per block
// the TPU kernel's defaults (select.py:181-183), as ref.py's constants
constexpr int kRungs = 16;
constexpr int kIters = 14;

struct Rungs {
  float v[kRungs];  // f32(2.25^(l − 8)), computed on the host
};

struct SelectArgs {
  const float* d;
  const float* tau0;  // (B,), already clamped at 1e-30
  int B, N, T, T_pad, n_tiles;
  int* ladder;  // (B, kRungs) survivor counts per rung
  int* dmax;    // (B,) bits of max(0, largest real value)
  int* bisect;  // (B, kIters) survivor counts per bisection pass
  int* tiles;   // (B, n_tiles, 2) counts of the last pass: d ≤ mid, d ≤ hi
  float* out_vals;
  int* out_idx;
  int* out_count;
};

struct Bracket {
  float lo, hi;
};

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

// The bracket after `passes` bisection passes (select.py:114-126).
__device__ Bracket replay_bracket(const SelectArgs& a, const Rungs& r, int b, int passes) {
  Bracket br = ladder_bracket(a, r, b);
  const int* cnt = a.bisect + static_cast<long long>(b) * kIters;
  for (int p = 0; p < passes; ++p) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(br.lo, br.hi));
    if (cnt[p] >= a.T) {
      br.hi = mid;
    } else {
      br.lo = mid;
    }
  }
  return br;
}

__device__ __forceinline__ float load_elem(const float* row, long long i, int N) {
  return i < N ? row[i] : INFINITY;  // the ragged edge is padding, as on the TPU
}

// Pass 0: survivor counts of all 16 rungs and the row's data max.
__global__ void __launch_bounds__(kThreads) select_ladder_kernel(SelectArgs a, Rungs r) {
  __shared__ float s_thr[kRungs];
  __shared__ int s_cnt[kRungs];
  __shared__ int s_dmax;
  const int b = blockIdx.y, j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < kRungs) {
    s_thr[tid] = __fmul_rn(a.tau0[b], r.v[tid]);
    s_cnt[tid] = 0;
  }
  if (tid == 0) s_dmax = 0;
  __syncthreads();

  const float* row = a.d + static_cast<long long>(b) * a.N;
  const long long base = static_cast<long long>(j) * kTile + warp * kPerWarp;
  int cnt = 0;  // the survivors of rung `lane` (lanes below kRungs)
  float vmax = 0.f;
  for (int it = 0; it < kSteps; ++it) {
    const float v = load_elem(row, base + it * 32 + lane, a.N);
    const bool real = v < INFINITY;
    if (real) vmax = fmaxf(vmax, v);
#pragma unroll
    for (int l = 0; l < kRungs; ++l) {
      const int c = __popc(__ballot_sync(rt::kFullMask, real && v <= s_thr[l]));
      if (l == lane) cnt += c;
    }
  }
  if (lane < kRungs) atomicAdd(&s_cnt[lane], cnt);
  vmax = rt::warp_max(vmax);
  // non-negative floats order like their bit patterns
  if (lane == 0) atomicMax(&s_dmax, __float_as_int(vmax));
  __syncthreads();
  if (tid < kRungs && s_cnt[tid]) {
    atomicAdd(&a.ladder[static_cast<long long>(b) * kRungs + tid], s_cnt[tid]);
  }
  if (tid == 0) atomicMax(&a.dmax[b], s_dmax);
}

// Passes 1..kIters: count d ≤ mid; the last pass also keeps each tile's
// counts under both thresholds the compaction may end up using.
__global__ void __launch_bounds__(kThreads)
select_bisect_kernel(SelectArgs a, Rungs r, int pass) {
  __shared__ float s_mid, s_hi;
  __shared__ int s_part[2][kWarps];
  const int b = blockIdx.y, j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const Bracket br = replay_bracket(a, r, b, pass - 1);
    s_mid = __fmul_rn(0.5f, __fadd_rn(br.lo, br.hi));
    s_hi = br.hi;
  }
  __syncthreads();
  const float mid = s_mid, hi = s_hi;
  const bool last = pass == kIters;
  const float* row = a.d + static_cast<long long>(b) * a.N;
  const long long base = static_cast<long long>(j) * kTile + warp * kPerWarp;
  unsigned cm = 0, ch = 0;
  for (int it = 0; it < kSteps; ++it) {
    const float v = load_elem(row, base + it * 32 + lane, a.N);
    const bool real = v < INFINITY;
    cm += (real && v <= mid);
    ch += (real && v <= hi);
  }
  cm = __reduce_add_sync(rt::kFullMask, cm);
  ch = __reduce_add_sync(rt::kFullMask, ch);
  if (lane == 0) {
    s_part[0][warp] = static_cast<int>(cm);
    s_part[1][warp] = static_cast<int>(ch);
  }
  __syncthreads();
  if (tid == 0) {
    int tm = 0, th = 0;
    for (int w = 0; w < kWarps; ++w) {
      tm += s_part[0][w];
      th += s_part[1][w];
    }
    if (tm) atomicAdd(&a.bisect[static_cast<long long>(b) * kIters + pass - 1], tm);
    if (last) {
      int* t = a.tiles + (static_cast<long long>(b) * a.n_tiles + j) * 2;
      t[0] = tm;
      t[1] = th;
    }
  }
}

// Final pass: exclusive scan over the tiles' counts, then scatter the
// tile's survivors in ascending index order into the first T_pad slots.
__global__ void __launch_bounds__(kThreads) select_compact_kernel(SelectArgs a, Rungs r) {
  __shared__ float s_thr;
  __shared__ int s_slot;
  __shared__ int s_part[2][kWarps];
  __shared__ int s_warp_cnt[kWarps];
  const int b = blockIdx.y, j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const Bracket br = replay_bracket(a, r, b, kIters - 1);
    const float mid = __fmul_rn(0.5f, __fadd_rn(br.lo, br.hi));
    const bool ge = a.bisect[static_cast<long long>(b) * kIters + kIters - 1] >= a.T;
    s_thr = ge ? mid : br.hi;  // the final hi
    s_slot = ge ? 0 : 1;
  }
  __syncthreads();
  const float thr = s_thr;

  // this row's survivors in the tiles before this one, and in all tiles
  const int* tc = a.tiles + static_cast<long long>(b) * a.n_tiles * 2 + s_slot;
  int before = 0, total = 0;
  for (int t = tid; t < a.n_tiles; t += kThreads) {
    const int c = tc[2 * t];
    total += c;
    if (t < j) before += c;
  }
  before = __reduce_add_sync(rt::kFullMask, before);
  total = __reduce_add_sync(rt::kFullMask, total);
  if (lane == 0) {
    s_part[0][warp] = before;
    s_part[1][warp] = total;
  }

  const float* row = a.d + static_cast<long long>(b) * a.N;
  const long long base = static_cast<long long>(j) * kTile + warp * kPerWarp;
  float vals[kSteps];
  unsigned keep = 0;  // bit `it`: this lane's element of step `it` survives
  int wcount = 0;
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    vals[it] = load_elem(row, base + it * 32 + lane, a.N);
    const bool s = vals[it] < INFINITY && vals[it] <= thr;
    keep |= static_cast<unsigned>(s) << it;
    wcount += __popc(__ballot_sync(rt::kFullMask, s));
  }
  if (lane == 0) s_warp_cnt[warp] = wcount;
  __syncthreads();
  int pos = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    pos += s_part[0][w];
    total += s_part[1][w];
  }
  for (int w = 0; w < warp; ++w) pos += s_warp_cnt[w];

  float* ov = a.out_vals + static_cast<long long>(b) * a.T_pad;
  int* oi = a.out_idx + static_cast<long long>(b) * a.T_pad;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const bool s = (keep >> it) & 1u;
    const unsigned m = __ballot_sync(rt::kFullMask, s);
    const int slot = pos + __popc(m & below);
    if (s && slot < a.T_pad) {  // overflow keeps the first T_pad in index order
      ov[slot] = vals[it];
      oi[slot] = static_cast<int>(base + it * 32 + lane);
    }
    pos += __popc(m);
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

}  // namespace

// Scratch ints radius_select_launch needs for (B, N).
extern "C" long long radius_select_scratch_ints(int B, int N) {
  return static_cast<long long>(B) * (kRungs + 1 + kIters + 2LL * n_tiles_of(N));
}

// d (B, N), tau0 (B,) → vals (B, T_pad), idx (B, T_pad), count (B,).
// `rungs` is a host array of 16 floats.  Launches 16 kernels on
// `stream` and returns cudaGetLastError() (or the memset's error).
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
  a.bisect = a.dmax + B;
  a.tiles = a.bisect + static_cast<long long>(B) * kIters;
  a.out_vals = out_vals;
  a.out_idx = out_idx;
  a.out_count = out_count;
  Rungs r;
  for (int l = 0; l < kRungs; ++l) r.v[l] = rungs[l];
  // the tile counts are written whole by the last bisection pass
  const size_t zeroed = sizeof(int) * static_cast<size_t>(B) * (kRungs + 1 + kIters);
  const cudaError_t e = cudaMemsetAsync(scratch, 0, zeroed, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a.n_tiles, B);
  select_ladder_kernel<<<grid, kThreads, 0, st>>>(a, r);
  for (int p = 1; p <= kIters; ++p) select_bisect_kernel<<<grid, kThreads, 0, st>>>(a, r, p);
  select_compact_kernel<<<grid, kThreads, 0, st>>>(a, r);
  return static_cast<int>(cudaGetLastError());
}
