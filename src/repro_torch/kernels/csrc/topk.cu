// Row-wise k smallest entries on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/topk.py:27 (topk_kernel,
// launched by topk_smallest_pallas at :95): the k ≤ 128 smallest entries
// of each row of d (B, N), ascending, ties to the lowest index.  The
// contract is the plain version's (repro_torch/kernels/ref.py,
// topk_smallest: a stable sort), exactly: +inf entries take part like any
// value, NaN sorts after +inf, and −0.0 ties with +0.0.  (The TPU kernel
// seeds its accumulator with (+inf, 0) and answers repeated indices for a
// row with fewer than k finite entries; this kernel answers the sort's.)
//
// What bounds it on the H100: each entry is read once and compared, so the
// kernel is bound by the 4·B·N bytes it reads; at the streaming index's
// shapes (the delta scan, (B, ≤ 32,768), and the fan-out merge, (B, tens))
// it is bound by launch latency instead.
//
// What the design does about it.  The TPU kernel walks the row's tiles
// serially, merging each into a running top-k by k rounds of masked
// argmin.  Here each entry becomes one 64-bit key: the value's bits made
// monotone in the high word and the column in the low word, so a single
// unsigned compare orders by (value, column), the stable sort's order.
// The grid is (S splits of N) × B, sized by the wrapper to one wave of
// resident blocks.  A block keeps its running top-k at the front of a
// kBuf-slot key buffer in shared memory, fills the rest from its split,
// and sorts the smallest power of two that covers the filled slots with
// the bitonic network of common.cuh.  With S > 1 a second launch runs the
// same loop over the S·k partial keys of each row.  The answer's values
// are read back from d at the winning columns: they are the input's bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBuf = 2048;  // keys sorted at a time
constexpr int kMaxK = 128;
constexpr unsigned long long kPad = ~0ull;  // sorts after every real key

// (value, column) as one key whose unsigned order is the stable sort's.
__device__ __forceinline__ unsigned long long topk_key(float v, int col) {
  unsigned int bits = __float_as_uint(v);
  if (bits == 0x80000000u) bits = 0u;  // −0.0 ties with +0.0
  bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  if (v != v) bits = 0xffffffffu;  // NaN after +inf, by column
  return (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned int>(col);
}

// kFromKeys: the input is the (B, M) partial keys of a first launch, else
// the (B, N) values themselves.  kFinal: write the answer (values read
// back from d, columns), else the split's k best keys to part_out.
template <bool kFromKeys, bool kFinal>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ d, const unsigned long long* __restrict__ part_in,
            unsigned long long* __restrict__ part_out, float* __restrict__ out_v,
            int* __restrict__ out_i, int N, int M, int k, int S, int R) {
  __shared__ unsigned long long s_key[kBuf];
  const int b = blockIdx.y, split = blockIdx.x, tid = threadIdx.x;
  const int row_len = kFromKeys ? M : N;
  const int start = split * R;
  const int end = min(start + R, row_len);
  int kept = 0;  // running top-k at the front of s_key
  for (int base = start; base < end;) {
    const int cnt = min(kBuf - kept, end - base);
    for (int t = tid; t < cnt; t += kThreads) {
      const long long at = static_cast<long long>(b) * row_len + base + t;
      if constexpr (kFromKeys) {
        s_key[kept + t] = part_in[at];
      } else {
        s_key[kept + t] = topk_key(d[at], base + t);
      }
    }
    const int filled = kept + cnt;
    int len = 2;
    while (len < filled) len <<= 1;
    for (int t = filled + tid; t < len; t += kThreads) s_key[t] = kPad;
    __syncthreads();
    rt::sort_keys<kThreads>(s_key, len);
    kept = min(k, filled);
    base += cnt;
  }
  for (int i = tid; i < k; i += kThreads) {
    const unsigned long long key = i < kept ? s_key[i] : kPad;
    if constexpr (kFinal) {
      const long long o = static_cast<long long>(b) * k + i;
      if (key == kPad) {  // not reached: the wrapper holds k ≤ N
        out_v[o] = INFINITY;
        out_i[o] = -1;
      } else {
        const int col = static_cast<int>(key & 0xffffffffull);
        out_v[o] = d[static_cast<long long>(b) * N + col];
        out_i[o] = col;
      }
    } else {
      part_out[(static_cast<long long>(b) * S + split) * k + i] = key;
    }
  }
}

}  // namespace

// Blocks of the first launch one SM holds at once (0 if the query fails);
// the wrapper sizes S to one wave.
extern "C" int topk_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, topk_kernel<false, false>,
                                                    kThreads, 0) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

// d (B, N) → out_v (B, k) ascending, out_i (B, k) int32, over S splits of
// each row; part is scratch of B·S·k keys when S > 1.  Returns
// cudaGetLastError().
extern "C" int topk_smallest_launch(const float* d, float* out_v, int* out_i,
                                    unsigned long long* part, int B, int N, int k, int S,
                                    void* stream) {
  if (k < 1 || k > kMaxK || k > N || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = (N + S - 1) / S;
  if (S == 1) {
    topk_kernel<false, true><<<dim3(1, B), kThreads, 0, st>>>(d, nullptr, nullptr, out_v,
                                                               out_i, N, 0, k, 1, R);
  } else {
    topk_kernel<false, false><<<dim3(S, B), kThreads, 0, st>>>(d, nullptr, part, nullptr,
                                                                nullptr, N, 0, k, S, R);
    const int M = S * k;
    topk_kernel<true, true><<<dim3(1, B), kThreads, 0, st>>>(d, part, nullptr, out_v, out_i,
                                                              N, M, k, 1, M);
  }
  return static_cast<int>(cudaGetLastError());
}
