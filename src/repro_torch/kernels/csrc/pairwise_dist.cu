// Pairwise squared Euclidean distances on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pairwise_dist.py:28
// (pairwise_sq_dist_kernel, launched by pairwise_sq_dist_pallas) and the
// per-query (B, N, d) form that src/repro/kernels/ops.py:130-134 vmaps
// over it.
//
// The 2-D form, q (B, d) × x (N, d) → (B, N) = max(|q|² + |x|² − 2·q·x,
// 0), has two regimes on the H100, and a schedule for each, chosen by d in
// the C entry:
//
//  - narrow d ≤ 32 (the estimate step on projected rows, d = m = 15): each
//    entry costs d multiply-adds and 4 bytes of output, so writing the
//    (B, N) output bounds it at large B (256 MB at B = 64, N = 1M) and
//    reading x at small B (60 MB).  pairwise_narrow_kernel: a grid of a
//    few blocks an SM walks tiles of 512 points; each block stages its
//    queries and their |q|² once (64 at a time, norm_trick.cuh), the next
//    tile's x comes in by cp.async while the current one is written, each
//    thread takes 4 consecutive points into registers and writes each
//    query's 4 entries in one 16-byte streaming store.  The tile is staged
//    transposed, column c of the points in row c, so that a thread's 4
//    points are one 16-byte shared read; the copies are 4 bytes each and
//    ask no alignment of x.
//  - wide d > 32 (the stream's delta scan, d = 256): 2·d flops an entry on
//    4·d bytes a point shared by every query, so arithmetic bounds it
//    (64 × 32,768 × 256 is 1.07 GFLOP on 34 MB).  pairwise_wide_kernel: a
//    register-tiled product, a block taking 16·UQ queries × 128 points,
//    each thread UQ × 8 entries (UQ = 1, 2 or 4 by B); features staged 32 at a time by cp.async
//    (16-byte copies where d % 4 == 0 and q and x are aligned, 4-byte ones
//    otherwise), the next chunk in flight while the current one is
//    multiplied; rows 36 floats apart give conflict-free 16-byte reads.
//    Each point is read once per tile of queries.  No tensor cores: the
//    arithmetic is IEEE float32 on CUDA cores.
//
// The arithmetic is fixed whatever the schedule, so both give the same
// bits: |q|², |x|² and the cross term are fmaf chains over the features
// in order, and the entry is __fsub_rn(__fadd_rn(|q|², |x|²), __fmul_rn(2,
// cross)) clamped at 0, as the TPU kernel forms it.
//
// The per-query form (B, d) × (B, N, d) is bound by reading B·N·d floats
// once: pairwise_sq_dist_rows_kernel gives one warp to each (query, row)
// pair, reads the row coalesced and sums (x − q)², the difference form, as
// the reference does for gathered rows.
#include "common.cuh"
#include "norm_trick.cuh"

namespace {

constexpr int kNarrowMax = 32;                   // widest d of the narrow schedule
constexpr int kNarrowThreads = 128;
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kNarrowPts = 4 * kNarrowThreads;   // points a tile, 4 a thread
constexpr int kNarrowLd = kNarrowPts + 4;        // floats a staged feature row

// Dynamic shared memory of pairwise_narrow_kernel<D>: two stages of D
// feature rows, then the staged queries and their norms.
template <int D>
constexpr size_t narrow_smem() {
  return sizeof(float) * (2 * D * kNarrowLd + rt::kNormQ * D + rt::kNormQ);
}

template <int D>  // d rounded up: 8, 16 or 32
__global__ void __launch_bounds__(kNarrowThreads)
pairwise_narrow_kernel(const float* __restrict__ q, const float* __restrict__ x,
                       float* __restrict__ out, int B, int N, int d) {
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem;                          // [2][D][kNarrowLd]
  float* const qs = smem + 2 * D * kNarrowLd;      // [kNormQ][D]
  float* const qn = qs + rt::kNormQ * D;           // [kNormQ]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (N + kNarrowPts - 1) / kNarrowPts;

  // Tile t's points into stage s, transposed: feature c of point r at
  // xs[s][c][r].  A warp copies 32 / D points a step, a lane a feature.
  constexpr int kRowsPerStep = 32 / D;
  const int r_lane = lane / D, c = lane % D;
  auto issue = [&](int t, int s) {
    const long long n0 = static_cast<long long>(t) * kNarrowPts;
    const int rows = static_cast<int>(min(static_cast<long long>(kNarrowPts), N - n0));
    float* dst = xs + (s * D + c) * kNarrowLd;
    if (c < d) {
      for (int r = warp * kRowsPerStep + r_lane; r < rows; r += kNarrowWarps * kRowsPerStep) {
        rt::cp_async4(dst + r, x + (n0 + r) * d + c, 4);
      }
    }
    rt::cp_commit();
  };

  if (B <= rt::kNormQ) rt::stage_queries<D, kNarrowThreads>(q, d, d, 0, B, qs, qn);
  int t = blockIdx.x;
  if (t < tiles) issue(t, 0);
  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    rt::cp_wait_all();  // this thread's copies of tile t have landed
    __syncthreads();    // everyone's have, and everyone is done with the other stage
    if (t + gridDim.x < tiles) issue(t + gridDim.x, (it + 1) & 1);

    // this thread's 4 points: n .. n + 3, zeros past d
    const float* xb = xs + (it & 1) * D * kNarrowLd + 4 * tid;
    float xr[4][D], xn[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float4 v = k < d ? *reinterpret_cast<const float4*>(xb + k * kNarrowLd)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      xr[0][k] = v.x;
      xr[1][k] = v.y;
      xr[2][k] = v.z;
      xr[3][k] = v.w;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int k = 0; k < D; ++k) xn[p] = fmaf(xr[p][k], xr[p][k], xn[p]);
    }
    const long long n = static_cast<long long>(t) * kNarrowPts + 4 * tid;
    const int valid = static_cast<int>(max(0LL, min(4LL, N - n)));
    for (int b0 = 0; b0 < B; b0 += rt::kNormQ) {
      const int nq = min(rt::kNormQ, B - b0);
      if (B > rt::kNormQ) rt::stage_queries<D, kNarrowThreads>(q, d, d, b0, nq, qs, qn);
      if (valid > 0) {
        rt::write_distances<4, D>(xr, xn, qs, qn, nq, out + static_cast<long long>(b0) * N + n,
                                  N, valid);
      }
    }
  }
}

constexpr int kWideThreads = 256;    // 16 × 16: ty takes queries, tx points
constexpr int kWideVP = 8;           // points a thread: tx + 16·v
constexpr int kWidePts = 16 * kWideVP;
constexpr int kChunk = 32;           // features staged at a time
constexpr int kLd = kChunk + 4;      // staged row stride: 16-byte rows, conflict-free float4 reads

template <int UQ>  // queries a thread: a block takes 16·UQ of them
constexpr size_t wide_smem() {
  return sizeof(float) * 2 * (16 * UQ + kWidePts) * kLd;
}

template <int UQ, bool kVec>
__global__ void __launch_bounds__(kWideThreads)
pairwise_wide_kernel(const float* __restrict__ q, const float* __restrict__ x,
                     float* __restrict__ out, int B, int N, int d) {
  constexpr int kQT = 16 * UQ, kRows = kQT + kWidePts, kStage = kRows * kLd;
  extern __shared__ __align__(16) float smem[];  // [2][kRows][kLd]: queries, then points
  __shared__ float norm_s[kRows];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b0 = blockIdx.y * kQT;
  const long long p0 = static_cast<long long>(blockIdx.x) * kWidePts;
  const int mq = min(kQT, B - b0);
  const int mp = static_cast<int>(min(static_cast<long long>(kWidePts), N - p0));

  // features c0 .. c0 + kChunk of the block's queries and points into a
  // stage, zeros past their rows and past d
  auto issue = [&](int c0, float* stage) {
    constexpr int kPer = kVec ? kChunk / 4 : kChunk;  // copies a row takes
#pragma unroll 4
    for (int e = tid; e < kRows * kPer; e += kWideThreads) {
      const int r = e / kPer, k = (e % kPer) * (kVec ? 4 : 1), col = c0 + k;
      const bool is_q = r < kQT;
      const int rr = is_q ? r : r - kQT;
      const bool in = rr < (is_q ? mq : mp) && col < d;  // vec: d % 4 == 0, a quad is whole
      const float* src = !in ? x
                             : is_q ? q + static_cast<long long>(b0 + rr) * d + col
                                    : x + (p0 + rr) * d + col;
      if constexpr (kVec) {
        rt::cp_async16(stage + r * kLd + k, src, in ? 16 : 0);
      } else {
        rt::cp_async4(stage + r * kLd + k, src, in ? 4 : 0);
      }
    }
    rt::cp_commit();
  };

  float acc[UQ][kWideVP];
#pragma unroll
  for (int u = 0; u < UQ; ++u)
#pragma unroll
    for (int v = 0; v < kWideVP; ++v) acc[u][v] = 0.f;
  float norm = 0.f;  // |row|² of staged row tid (tid < kRows)

  const int chunks = (d + kChunk - 1) / kChunk;
  issue(0, smem);
  for (int c = 0; c < chunks; ++c) {
    rt::cp_wait_all();  // this thread's copies of chunk c have landed
    __syncthreads();    // everyone's have, and everyone is done with chunk c − 1
    if (c + 1 < chunks) issue((c + 1) * kChunk, smem + ((c + 1) & 1) * kStage);
    const float* sq = smem + (c & 1) * kStage;
    const float* sx = sq + kQT * kLd;
    if (tid < kRows) {
      const float4* row = reinterpret_cast<const float4*>(sq + tid * kLd);
#pragma unroll
      for (int k4 = 0; k4 < kChunk / 4; ++k4) {
        const float4 v = row[k4];
        norm = fmaf(v.x, v.x, norm);
        norm = fmaf(v.y, v.y, norm);
        norm = fmaf(v.z, v.z, norm);
        norm = fmaf(v.w, v.w, norm);
      }
    }
#pragma unroll 2
    for (int k4 = 0; k4 < kChunk / 4; ++k4) {
      float4 bv[kWideVP];
#pragma unroll
      for (int v = 0; v < kWideVP; ++v) {
        bv[v] = reinterpret_cast<const float4*>(sx + (tx + 16 * v) * kLd)[k4];
      }
#pragma unroll
      for (int u = 0; u < UQ; ++u) {
        const float4 av = reinterpret_cast<const float4*>(sq + (ty + 16 * u) * kLd)[k4];
#pragma unroll
        for (int v = 0; v < kWideVP; ++v) {  // each sum takes its features in order
          acc[u][v] = fmaf(av.x, bv[v].x, acc[u][v]);
          acc[u][v] = fmaf(av.y, bv[v].y, acc[u][v]);
          acc[u][v] = fmaf(av.z, bv[v].z, acc[u][v]);
          acc[u][v] = fmaf(av.w, bv[v].w, acc[u][v]);
        }
      }
    }
  }
  if (tid < kRows) norm_s[tid] = norm;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < UQ; ++u) {
    const int r = ty + 16 * u;
    if (r >= mq) continue;
    float* row = out + static_cast<long long>(b0 + r) * N + p0;
#pragma unroll
    for (int v = 0; v < kWideVP; ++v) {
      const int col = tx + 16 * v;
      if (col < mp) {
        __stcs(row + col, fmaxf(__fsub_rn(__fadd_rn(norm_s[r], norm_s[kQT + col]),
                                          __fmul_rn(2.f, acc[u][v])), 0.f));
      }
    }
  }
}

constexpr int kRowWarps = 8;  // (query, row) pairs per block of the per-query form

__global__ void __launch_bounds__(kRowWarps * 32)
pairwise_sq_dist_rows_kernel(const float* __restrict__ q, const float* __restrict__ x,
                             float* __restrict__ out, int N, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const long long n = static_cast<long long>(blockIdx.x) * kRowWarps + warp;
  if (n >= N) return;
  const float* xr = x + (static_cast<long long>(b) * N + n) * d;
  const float* qr = q + static_cast<long long>(b) * d;
  float s = 0.f;
#pragma unroll 8
  for (int c = lane; c < d; c += 32) {
    const float t = xr[c] - qr[c];
    s += t * t;
  }
  s = rt::warp_sum(s);
  if (lane == 0) out[static_cast<long long>(b) * N + n] = s;
}

template <int D>
int launch_narrow(const float* q, const float* x, float* out, int B, int N, int d,
                  cudaStream_t stream) {
  static int cache[rt::kMaxDevices] = {0};
  cudaError_t err = cudaSuccess;
  const int resident = rt::resident_grid(reinterpret_cast<const void*>(pairwise_narrow_kernel<D>),
                                         kNarrowThreads, narrow_smem<D>(), cache, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + kNarrowPts - 1) / kNarrowPts;
  pairwise_narrow_kernel<D><<<min(tiles, resident), kNarrowThreads, narrow_smem<D>(), stream>>>(
      q, x, out, B, N, d);
  return static_cast<int>(cudaGetLastError());
}

template <int UQ>
int launch_wide(const float* q, const float* x, float* out, int B, int N, int d,
                cudaStream_t stream) {
  static int cache[2][rt::kMaxDevices] = {};  // its shared memory limit, raised once a device
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const auto kernel = vec ? pairwise_wide_kernel<UQ, true> : pairwise_wide_kernel<UQ, false>;
  cudaError_t err = cudaSuccess;
  rt::resident_grid(reinterpret_cast<const void*>(kernel), kWideThreads, wide_smem<UQ>(),
                    cache[vec], &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kWidePts - 1) / kWidePts, (B + 16 * UQ - 1) / (16 * UQ));
  kernel<<<grid, kWideThreads, wide_smem<UQ>(), stream>>>(q, x, out, B, N, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, d), x (N, d) → out (B, N).  Returns cudaGetLastError(), or the
// error of a device query.
extern "C" int pairwise_sq_dist_launch(const float* q, const float* x, float* out,
                                       int B, int N, int d, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 8) return launch_narrow<8>(q, x, out, B, N, d, st);
  if (d <= 16) return launch_narrow<16>(q, x, out, B, N, d, st);
  if (d <= kNarrowMax) return launch_narrow<32>(q, x, out, B, N, d, st);
  if (B <= 16) return launch_wide<1>(q, x, out, B, N, d, st);
  if (B <= 32) return launch_wide<2>(q, x, out, B, N, d, st);
  return launch_wide<4>(q, x, out, B, N, d, st);
}

// q (B, d), x (B, N, d) → out (B, N).  Returns cudaGetLastError().
extern "C" int pairwise_sq_dist_rows_launch(const float* q, const float* x, float* out,
                                            int B, int N, int d, void* stream) {
  const dim3 grid((N + kRowWarps - 1) / kRowWarps, B);
  pairwise_sq_dist_rows_kernel<<<grid, kRowWarps * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(q, x, out, N, d);
  return static_cast<int>(cudaGetLastError());
}
