// Helpers shared by the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace rt {

constexpr unsigned kFullMask = 0xffffffffu;

// topk.cu reads a row in chunks of 2,048 keys and splits no row into
// pieces shorter than this (the wrapper's topk._SPLIT); the partial keys
// of a row take ⌈N / kTopkSplitMin⌉·k slots at most.
constexpr int kTopkSplitMin = 8192;

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

// The bitonic network over len (a power of two) slots in shared memory,
// walked by a block of kThreads threads: at each step swap(i, j, up) must
// order slots i < j ascending when up, descending otherwise.  Ends with a
// barrier.
template <int kThreads, typename Swap>
__device__ __forceinline__ void bitonic(int len, Swap swap) {
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < len / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        swap(i, i + stride, (i & size) == 0);
      }
      __syncthreads();
    }
  }
}

// Ascending sort of len (value, position) pairs by value, then position.
template <int kThreads>
__device__ __forceinline__ void sort_pairs(float* v, int* p, int len) {
  bitonic<kThreads>(len, [=](int i, int j, bool up) {
    const float vi = v[i], vj = v[j];
    const int pi = p[i], pj = p[j];
    if (after(vi, pi, vj, pj) == up) {
      v[i] = vj;
      v[j] = vi;
      p[i] = pj;
      p[j] = pi;
    }
  });
}

// Ascending sort of len 64-bit keys.
template <int kThreads>
__device__ __forceinline__ void sort_keys(unsigned long long* key, int len) {
  bitonic<kThreads>(len, [=](int i, int j, bool up) {
    const unsigned long long a = key[i], b = key[j];
    if ((a > b) == up) {
      key[i] = b;
      key[j] = a;
    }
  });
}

}  // namespace rt

// The row-wise k smallest of d (B, N) into out_v / out_i (topk.cu), on
// `stream`; part is scratch of B·⌈N / kTopkSplitMin⌉·k keys.  Where ids
// (B, ids_width) is given, out_i answers ids[b, column], or −1 for an
// infinite value, in place of the column.  Returns a cudaError_t.
int rt_topk_launch(const float* d, float* out_v, int* out_i, unsigned long long* part,
                   const int* ids, int ids_width, int B, int N, int k, int S_cap,
                   cudaStream_t stream);
