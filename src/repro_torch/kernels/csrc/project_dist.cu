// Fused LSH projection and projected-space squared distances on Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/project_dist.py:30
// (project_dist_kernel, launched by project_dist_pallas at :86): for x
// (N, d), A (d, m) and projected queries qp (B, m),
// out[b, n] = max(|qp_b|² + |x_n·A|² − 2·qp_b·(x_n·A), 0), without the
// (N, m) projection ever going to device memory.
//
// What bounds it on the H100: each point's d floats are read once and
// used for 2·d·m flops (m = 15: 7.5 flops a byte, under the card's ≈ 20
// float32 flops per byte of bandwidth), and each point gets B output
// floats.  So the kernel is bound by memory: reading x and writing the
// (B, N) output.
//
// What the design does about it.  The TPU kernel keeps a (bN, 128-lane)
// projection tile in VMEM across its d loop and meets the queries in a
// small MXU product.  Here a block takes kCols points, one per thread.  It
// stages x's tile (each warp reads whole 128-byte row segments) and the
// matching rows of A in shared memory, kSlab features at a time, with A
// zero-padded to MP columns: A never has to fit whole, so d = 4096, m = 15
// (245 KB) streams through in 128 slabs.  Each point's MP projected
// coordinates stay in registers.  The projected queries are staged kQ at a
// time in shared memory (64 × 15 floats: 3.8 KB), and every query's row of
// the block's output is one coalesced store.  Like the plain version it
// forms (|qp|² + |p|²) − 2·cross and clamps at 0; __fadd_rn / __fsub_rn /
// __fmul_rn keep nvcc from contracting that into an FMA.
#include "common.cuh"

namespace {

constexpr int kCols = 128;  // points per block, one per thread
constexpr int kWarps = kCols / 32;
constexpr int kSlab = 32;   // features of x and rows of A staged at a time
constexpr int kQ = 64;      // projected queries staged at a time

template <int MP>  // m padded: 16 or 32
__global__ void __launch_bounds__(kCols)
project_dist_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ qp, float* __restrict__ out, int B, int N,
                    int d, int m) {
  __shared__ float xs[kSlab][kCols + 1];
  __shared__ float as[kSlab][MP];
  __shared__ float qs[kQ][MP];
  __shared__ float qn[kQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n0 = static_cast<long long>(blockIdx.x) * kCols;
  const int ncols = static_cast<int>(min(static_cast<long long>(kCols), N - n0));

  // the block's projections x_n·A, one point per thread, in registers
  float p[MP];
#pragma unroll
  for (int j = 0; j < MP; ++j) p[j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kSlab) {
    const int w = min(kSlab, d - k0);
    __syncthreads();  // readers of the previous slab are done
    // unrolled so that each warp keeps several row loads in flight
#pragma unroll 8
    for (int r = warp; r < ncols; r += kWarps) {
      if (lane < w) xs[lane][r] = x[(n0 + r) * d + k0 + lane];
    }
    for (int c = warp; c < kSlab; c += kWarps) {
      if (lane < MP) {
        as[c][lane] = (c < w && lane < m) ? a[static_cast<long long>(k0 + c) * m + lane] : 0.f;
      }
    }
    __syncthreads();
    for (int c = 0; c < w; ++c) {
      const float xv = xs[c][tid];
#pragma unroll
      for (int j = 0; j < MP; ++j) p[j] += xv * as[c][j];
    }
  }
  float pn = 0.f;
#pragma unroll
  for (int j = 0; j < MP; ++j) pn += p[j] * p[j];

  for (int b0 = 0; b0 < B; b0 += kQ) {
    const int nq = min(kQ, B - b0);
    __syncthreads();  // readers of the previous queries are done
    for (int r = warp; r < kQ; r += kWarps) {
      if (lane < MP) {
        qs[r][lane] = (r < nq && lane < m) ? qp[static_cast<long long>(b0 + r) * m + lane] : 0.f;
      }
    }
    __syncthreads();
    if (tid < kQ) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < MP; ++j) s += qs[tid][j] * qs[tid][j];
      qn[tid] = s;
    }
    __syncthreads();
    if (tid < ncols) {
      for (int r = 0; r < nq; ++r) {
        float cross = 0.f;
#pragma unroll
        for (int j = 0; j < MP; ++j) cross += qs[r][j] * p[j];
        const float v = __fsub_rn(__fadd_rn(qn[r], pn), __fmul_rn(2.f, cross));
        out[static_cast<long long>(b0 + r) * N + n0 + tid] = fmaxf(v, 0.f);
      }
    }
  }
}

}  // namespace

// x (N, d), a (d, m), qp (B, m) → out (B, N), m ≤ 32.  Returns
// cudaGetLastError().
extern "C" int project_dist_launch(const float* x, const float* a, const float* qp,
                                   float* out, int B, int N, int d, int m, void* stream) {
  if (m < 1 || m > 32) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kCols - 1) / kCols);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 16) {
    project_dist_kernel<16><<<grid, kCols, 0, st>>>(x, a, qp, out, B, N, d, m);
  } else {
    project_dist_kernel<32><<<grid, kCols, 0, st>>>(x, a, qp, out, B, N, d, m);
  }
  return static_cast<int>(cudaGetLastError());
}
