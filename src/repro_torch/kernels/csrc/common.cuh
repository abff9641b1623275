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

// Asynchronous copies from device to shared memory (cp.async): 16 or 4
// bytes into dst, `bytes` of them read from src and the rest zero-filled
// (0 reads nothing: src need only be a valid address).  The 16-byte form
// wants both addresses 16-byte aligned and bypasses L1.  cp_commit closes
// the thread's copies issued so far into a group; cp_wait_all waits for
// all of its groups.  A barrier after the wait makes every thread's copies
// visible to the block.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

constexpr int kMaxDevices = 64;

// The blocks of `kernel` (threads a block, smem bytes of dynamic shared
// memory, its limit raised to that first) that the current device holds
// at once: blocks an SM × SMs, kept per device in cache[kMaxDevices].
// 0 with the CUDA error in *err where a query fails or no block fits.
inline int resident_grid(const void* kernel, int threads, size_t smem, int* cache,
                         cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int per_sm = 0, sms = 0;
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  if (*err == cudaSuccess) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  if (per_sm * sms < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  if (dev < kMaxDevices) cache[dev] = per_sm * sms;
  return per_sm * sms;
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
