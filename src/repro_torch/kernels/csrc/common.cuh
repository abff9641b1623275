// Helpers shared by the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace rt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// (va, pa) sorts after (vb, pb): by value, then by position.
__device__ __forceinline__ bool after(float va, int pa, float vb, int pb) {
  return va > vb || (va == vb && pa > pb);
}

// Ascending bitonic sort of len (a power of two) (value, position) pairs
// in shared memory by a block of kThreads threads; ends with a barrier.
template <int kThreads>
__device__ __forceinline__ void sort_pairs(float* v, int* p, int len) {
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < len / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const float vi = v[i], vj = v[j];
        const int pi = p[i], pj = p[j];
        if (after(vi, pi, vj, pj) == up) {
          v[i] = vj;
          v[j] = vi;
          p[i] = pj;
          p[j] = pi;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace rt
