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
// merge shapes, (B, tens), it is bound by launch latency instead.
//
// What the design does about it.  The TPU kernel walks the row's tiles
// serially, merging each into a running top-k by k rounds of masked
// argmin.  Here each entry becomes one 64-bit key: the value's bits made
// monotone in the high word and the column in the low word, so a single
// unsigned compare orders by (value, column), the stable sort's order.
// The grid is (S splits of N) × B, at most one wave of resident blocks,
// no split shorter than kSplitMin.  A block reads its split in chunks of
// kChunk keys, kPer a thread held in registers, and keeps a threshold
// `thr`: no key above it can be among the split's k smallest.  The first
// chunk sets it to the k-th smallest of the threads' minima (k distinct
// keys lie at or below it).  Each key is compared with thr as it is read;
// only keys at or below it go to a shared buffer, through a warp ballot
// and one shared atomic a warp.  The buffer is sorted (the bitonic network
// of common.cuh, over the smallest power of two that covers it) only when
// it could not take another chunk, and at the end of the split; each sort
// keeps the k smallest at the front and lowers thr to the k-th.  On most
// rows nearly every key is dropped by one compare, so the kernel is one
// streaming read of d; a descending row appends every key and sorts a
// buffer every chunk.  With S > 1 a second launch runs the same loop over
// the S·k partial keys of each row.  The answer's values are read back
// from d at the winning columns: they are the input's bits.
//
// rt_topk_launch is also the answer step of verify_topk (verify.cu): it
// maps each winning column through that caller's candidate ids.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                  // keys a thread reads per chunk
constexpr int kChunk = kThreads * kPer;  // 2,048 keys read per step
constexpr int kBuf = 2 * kChunk;         // the shared key buffer
constexpr int kMaxK = 128;
constexpr int kSplitMin = rt::kTopkSplitMin;  // no split shorter
constexpr unsigned long long kPad = ~0ull;  // sorts after every real key
static_assert(kSplitMin == 4 * kChunk, "a split is four chunks");

// (value, column) as one key whose unsigned order is the stable sort's.
__device__ __forceinline__ unsigned long long topk_key(float v, int col) {
  unsigned int bits = __float_as_uint(v);
  if (bits == 0x80000000u) bits = 0u;  // −0.0 ties with +0.0
  bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  if (v != v) bits = 0xffffffffu;  // NaN after +inf, by column
  return (static_cast<unsigned long long>(bits) << 32) | static_cast<unsigned int>(col);
}

// Sort the n keys at the front of s_key, padded to a power of two, and
// return how many of them are kept (the k smallest, at the front).
__device__ __forceinline__ int sort_buffer(unsigned long long* s_key, int n, int k) {
  int len = 2;
  while (len < n) len <<= 1;
  for (int t = n + threadIdx.x; t < len; t += kThreads) s_key[t] = kPad;
  __syncthreads();
  rt::sort_keys<kThreads>(s_key, len);
  return min(k, n);
}

// kFromKeys: the input is the (B, M) partial keys of a first launch, else
// the (B, N) values themselves.  kFinal: write the answer (values read
// back from d; columns, or ids[b, column] where ids is given, −1 for an
// infinite value), else the split's k best keys to part_out.
template <bool kFromKeys, bool kFinal>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ d, const unsigned long long* __restrict__ part_in,
            unsigned long long* __restrict__ part_out, float* __restrict__ out_v,
            int* __restrict__ out_i, const int* __restrict__ ids, int ids_width, int N,
            int M, int k, int S, int R) {
  __shared__ unsigned long long s_key[kBuf];
  __shared__ unsigned long long s_min[kThreads];
  __shared__ int s_n;
  const int b = blockIdx.y, split = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int row_len = kFromKeys ? M : N;
  const long long row = static_cast<long long>(b) * row_len;
  const int start = split * R;
  const int end = min(start + R, row_len);
  if (tid == 0) s_n = 0;
  __syncthreads();
  unsigned long long thr = kPad;
  int kept = 0;  // sorted keys at the front of s_key
  for (int base = start; base < end; base += kChunk) {
    unsigned long long key[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int at = base + j * kThreads + tid;
      if (at >= end) {
        key[j] = kPad;
      } else if constexpr (kFromKeys) {
        key[j] = part_in[row + at];
      } else {
        key[j] = topk_key(d[row + at], at);
      }
    }
    // a first threshold, where the split holds more than a key a thread:
    // the k-th of the threads' minima
    if (base == start && end - start > kThreads) {
      unsigned long long m = key[0];
#pragma unroll
      for (int j = 1; j < kPer; ++j) m = min(m, key[j]);
      s_min[tid] = m;
      __syncthreads();
      rt::sort_keys<kThreads>(s_min, kThreads);
      thr = s_min[k - 1];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool keep = key[j] <= thr && key[j] != kPad;
      const unsigned vote = __ballot_sync(rt::kFullMask, keep);
      if (vote) {  // warp-uniform
        int at = 0;
        if (lane == 0) at = atomicAdd(&s_n, __popc(vote));
        at = __shfl_sync(rt::kFullMask, at, 0);
        if (keep) s_key[at + __popc(vote & ((1u << lane) - 1u))] = key[j];
      }
    }
    __syncthreads();
    const int n = s_n;
    __syncthreads();  // every thread has read s_n before it changes
    if (n > kBuf - kChunk || base + kChunk >= end) {
      kept = sort_buffer(s_key, n, k);
      if (kept == k) thr = s_key[k - 1];
      if (tid == 0) s_n = kept;
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += kThreads) {
    const unsigned long long key = i < kept ? s_key[i] : kPad;
    if constexpr (kFinal) {
      const long long o = static_cast<long long>(b) * k + i;
      if (key == kPad) {  // not reached: the entry holds k ≤ N
        out_v[o] = INFINITY;
        out_i[o] = -1;
      } else {
        const int col = static_cast<int>(key & 0xffffffffull);
        const float v = d[static_cast<long long>(b) * N + col];
        out_v[o] = v;
        if (ids == nullptr) {
          out_i[o] = col;
        } else {
          out_i[o] = (isinf(v) || col >= ids_width)
                         ? -1
                         : ids[static_cast<long long>(b) * ids_width + col];
        }
      }
    } else {
      part_out[(static_cast<long long>(b) * S + split) * k + i] = key;
    }
  }
}

// Blocks of the first launch one wave of the current device holds, asked
// once per device.
int wave_blocks() {
  constexpr int kMaxDevices = 64;
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel<false, false>,
                                                    kThreads, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 1;
  }
  const int wave = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < kMaxDevices) cache[dev] = wave;
  return wave;
}

}  // namespace

int rt_topk_launch(const float* d, float* out_v, int* out_i, unsigned long long* part,
                   const int* ids, int ids_width, int B, int N, int k, int S_cap,
                   cudaStream_t stream) {
  if (k < 1 || k > kMaxK || k > N || B < 0 || B > 65535 || S_cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  int S = min(S_cap, max(1, wave_blocks() / B));
  const int R0 = (N + S - 1) / S;
  const int R = max(R0, min(kSplitMin, N));  // never shorter than the wrapper sized for
  S = (N + R - 1) / R;                       // no empty split
  if (S == 1) {
    topk_kernel<false, true><<<dim3(1, B), kThreads, 0, stream>>>(
        d, nullptr, nullptr, out_v, out_i, ids, ids_width, N, 0, k, 1, N);
  } else {
    topk_kernel<false, false><<<dim3(S, B), kThreads, 0, stream>>>(
        d, nullptr, part, nullptr, nullptr, nullptr, 0, N, 0, k, S, R);
    const int M = S * k;
    topk_kernel<true, true><<<dim3(1, B), kThreads, 0, stream>>>(
        d, part, nullptr, out_v, out_i, ids, ids_width, N, M, k, 1, M);
  }
  return static_cast<int>(cudaGetLastError());
}

// d (B, N) → out_v (B, k) ascending, out_i (B, k) int32.  part is scratch
// of B·S_cap·k keys, S_cap = ⌈N / kSplitMin⌉ (unused when that is 1); the
// entry takes S ≤ S_cap splits to fill one wave.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for k outside [1, min(128,
// N)] or B past the grid's 65,535 rows.
extern "C" int topk_smallest_launch(const float* d, float* out_v, int* out_i,
                                    unsigned long long* part, int B, int N, int k, int S_cap,
                                    void* stream) {
  return rt_topk_launch(d, out_v, out_i, part, nullptr, 0, B, N, k, S_cap,
                        static_cast<cudaStream_t>(stream));
}
