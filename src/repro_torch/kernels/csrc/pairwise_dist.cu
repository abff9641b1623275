// Pairwise squared Euclidean distances on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pairwise_dist.py:28
// (pairwise_sq_dist_kernel, launched by pairwise_sq_dist_pallas) and the
// per-query (B, N, d) form that src/repro/kernels/ops.py:130-134 vmaps
// over it.
//
// What bounds it on the H100: at the estimate step (B queries against N
// projected points, d = m = 15) each output costs d multiply-adds and a
// 4-byte store, so the (B, N) output dominates the bytes moved and the
// kernel is bound by memory, not by arithmetic.  The per-query form
// reads B·N·d floats once for B·N outputs and is bound by memory too.
//
// What the design does about it: the 2-D kernel gives each thread one
// point (column) and keeps the block's points in shared memory while the
// block walks every query row in groups of kRows, so X is read from
// device memory once and every store is coalesced along N.  The cross
// term is this kernel's own loop.  Like the TPU kernel it forms
// (|q|² + |x|²) − 2·q·x and clamps at 0.  The per-query kernel gives one
// warp to each (query, row) pair, reads the row coalesced and sums
// (x − q)²: the difference form, as the reference does for gathered rows.
#include "common.cuh"

namespace {

constexpr int kCols = 128;  // points per block, one per thread
constexpr int kRows = 8;    // query rows accumulated per pass over the slabs
constexpr int kSlab = 32;   // features staged in shared memory at a time

__global__ void __launch_bounds__(kCols)
pairwise_sq_dist_kernel(const float* __restrict__ q, const float* __restrict__ x,
                        float* __restrict__ out, int B, int N, int d) {
  __shared__ float xs[kSlab][kCols + 1];
  __shared__ float qs[kRows][kSlab];
  __shared__ float qn[kRows];
  const int tid = threadIdx.x;
  const long long n0 = static_cast<long long>(blockIdx.x) * kCols;
  const int ncols = static_cast<int>(min(static_cast<long long>(kCols), N - n0));
  const int nslab = (d + kSlab - 1) / kSlab;
  float xn = 0.f;  // |x|² of this thread's point, summed during the first row group

  for (int b0 = 0; b0 < B; b0 += kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    float qacc = 0.f;  // |q|² of row b0 + tid, for tid < kRows
    for (int s = 0; s < nslab; ++s) {
      const int k0 = s * kSlab;
      const int w = min(kSlab, d - k0);
      __syncthreads();  // readers of the previous slab and of qn are done
      if (nslab > 1 || b0 == 0) {  // a single slab stays resident across row groups
        for (int e = tid; e < ncols * w; e += kCols) {
          const int r = e / w, c = e - r * w;
          xs[c][r] = x[(n0 + r) * d + k0 + c];
        }
      }
      for (int e = tid; e < kRows * w; e += kCols) {
        const int r = e / w, c = e - r * w;
        qs[r][c] = (b0 + r < B) ? q[static_cast<long long>(b0 + r) * d + k0 + c] : 0.f;
      }
      __syncthreads();
      if (tid < kRows) {
        for (int c = 0; c < w; ++c) qacc += qs[tid][c] * qs[tid][c];
      }
      if (b0 == 0) {
        for (int c = 0; c < w; ++c) xn += xs[c][tid] * xs[c][tid];
      }
      for (int c = 0; c < w; ++c) {
        const float xv = xs[c][tid];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += qs[r][c] * xv;
      }
    }
    if (tid < kRows) qn[tid] = qacc;
    __syncthreads();
    if (tid < ncols) {
      const long long n = n0 + tid;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (b0 + r < B) {
          // (qn + xn) − 2·cross, in that order, as the TPU kernel forms it
          const float v = __fsub_rn(__fadd_rn(qn[r], xn), __fmul_rn(2.f, acc[r]));
          out[static_cast<long long>(b0 + r) * N + n] = fmaxf(v, 0.f);
        }
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

}  // namespace

// q (B, d), x (N, d) → out (B, N).  Returns cudaGetLastError().
extern "C" int pairwise_sq_dist_launch(const float* q, const float* x, float* out,
                                       int B, int N, int d, void* stream) {
  const dim3 grid((N + kCols - 1) / kCols);
  pairwise_sq_dist_kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      q, x, out, B, N, d);
  return static_cast<int>(cudaGetLastError());
}

// q (B, d), x (B, N, d) → out (B, N).  Returns cudaGetLastError().
extern "C" int pairwise_sq_dist_rows_launch(const float* q, const float* x, float* out,
                                            int B, int N, int d, void* stream) {
  const dim3 grid((N + kRowWarps - 1) / kRowWarps, B);
  pairwise_sq_dist_rows_kernel<<<grid, kRowWarps * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(q, x, out, N, d);
  return static_cast<int>(cudaGetLastError());
}
