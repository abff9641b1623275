// The output phase shared by the norm-trick distance kernels
// (pairwise_dist.cu's narrow schedule and project_dist.cu): queries staged
// in shared memory, each thread's points in registers, and every (query,
// point) entry formed as max((|q|² + |x|²) − 2·q·x, 0).
//
// The arithmetic is fixed whatever the schedule: |q|², |x|² and the cross
// term are each one fmaf chain over the columns in order, and the result
// is __fsub_rn(__fadd_rn(|q|², |x|²), __fmul_rn(2, cross)), clamped at 0.
// Columns past the real ones are zeros in both operands: fmaf(0, 0, s)
// is s (up to the sign of a zero, which the result never shows), so the
// padding changes no output bit.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace rt {

constexpr int kNormQ = 64;  // queries staged in shared memory at a time

// Queries b0 .. b0 + nq of q (rows ld floats apart, the first w used) into
// qs[kNormQ][D], zeros past w and past nq, and their |q|² into qn[kNormQ].
// Every thread of the block calls it; it starts and ends with a barrier.
template <int D, int kThreads>
__device__ __forceinline__ void stage_queries(const float* __restrict__ q, int ld, int w, int b0,
                                              int nq, float* qs, float* qn) {
  __syncthreads();  // readers of the previous queries are done
  for (int e = threadIdx.x; e < kNormQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    qs[e] = (r < nq && c < w) ? q[static_cast<long long>(b0 + r) * ld + c] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kNormQ; r += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) s = fmaf(qs[r * D + c], qs[r * D + c], s);
    qn[r] = s;
  }
  __syncthreads();
}

// This thread's NP consecutive points, the first `valid` of them real, with
// coordinates xr and squared norms xn, against the nq staged queries:
// row r of the answer goes to out_row + r·N (out_row: the first point's
// entry of the first staged query's row).  A row's NP entries leave in one
// streaming store of 4·NP bytes where its address is so aligned, one by
// one otherwise (N % NP != 0, a misaligned output, the ragged last points).
template <int NP, int D>
__device__ __forceinline__ void write_distances(const float (&xr)[NP][D], const float (&xn)[NP],
                                                const float* qs, const float* qn, int nq,
                                                float* out_row, long long N, int valid) {
  for (int r = 0; r < nq; ++r) {
    float cross[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) cross[p] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(qs + r * D);
#pragma unroll
    for (int c4 = 0; c4 < D / 4; ++c4) {
      const float4 v = q4[c4];  // the same address across the block: a broadcast
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        cross[p] = fmaf(v.x, xr[p][4 * c4], cross[p]);
        cross[p] = fmaf(v.y, xr[p][4 * c4 + 1], cross[p]);
        cross[p] = fmaf(v.z, xr[p][4 * c4 + 2], cross[p]);
        cross[p] = fmaf(v.w, xr[p][4 * c4 + 3], cross[p]);
      }
    }
    float o[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      o[p] = fmaxf(__fsub_rn(__fadd_rn(qn[r], xn[p]), __fmul_rn(2.f, cross[p])), 0.f);
    }
    float* dst = out_row + r * N;
    if (valid == NP && (reinterpret_cast<uintptr_t>(dst) & (4 * NP - 1)) == 0) {
      if constexpr (NP == 4) {
        __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
      } else if constexpr (NP == 2) {
        __stcs(reinterpret_cast<float2*>(dst), make_float2(o[0], o[1]));
      } else {
        __stcs(dst, o[0]);
      }
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (p < valid) __stcs(dst + p, o[p]);
      }
    }
  }
}

}  // namespace rt
