// Asymmetric distances over product-quantized codes on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/adc.py:36 (adc_dist_kernel,
// launched by adc_dist_pallas) and the per-query (B, N, S) form that
// src/repro/kernels/ops.py:160-164 vmaps over it:
//     out[b, n] = Σ_s lut[b, s, codes[n, s]]
// with codes uint8 (N, S) shared by the batch or (B, N, S) per query, and
// lut (B, S, V) float32, V ≤ 256.
//
// What bounds it on the H100: each output reads S code bytes and does S
// table lookups and adds, so at the rerank tier (B·T candidates, S = 16)
// the kernel is bound by memory: the B·T·S code bytes and the B·T·4
// output bytes, the tables being a few KB per query.
//
// What the design does about it.  The TPU kernel turns each lookup into a
// one-hot MXU product because gathers are slow there (adc.py:14-23); on
// Hopper a gather from shared memory is cheap.  A block serves one query
// and kPerThread · kThreads candidates: it stages up to kSlotsPerPass of
// the query's table rows in shared memory (one 256-entry row per slot,
// zero past V, so a code ≥ V adds 0 and never reads out of bounds), and
// each thread reads its candidates' codes as uint8, 16 at a time in one
// vector load where the layout allows it, and adds the S entries in slot
// order from 0, as the plain version does.  Neighbouring threads hold
// neighbouring candidates, so code loads and output stores coalesce.  The
// lookups are data-dependent: 32 lanes hit 32 random entries of one
// 256-entry row, so they conflict on shared-memory banks (about 3-4 ways
// for uniform codes); the kernel does nothing about that yet.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;       // candidates per thread
constexpr int kValues = 256;        // table entries per slot in shared memory
constexpr int kSlotsPerPass = 32;   // slots staged at once: 32 KB of table

// a + the table entries of the four codes packed in word (slot order),
// rows being the first of their four slots' table rows
__device__ __forceinline__ float add_code_bytes(float a, unsigned word, const float* rows) {
#pragma unroll
  for (int byte = 0; byte < 4; ++byte) {
    a = __fadd_rn(a, rows[byte * kValues + ((word >> (8 * byte)) & 0xffu)]);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
adc_dist_kernel(const uint8_t* __restrict__ codes, long long batch_stride,
                const float* __restrict__ lut, float* __restrict__ out, int N, int S,
                int V, bool vec16) {
  __shared__ float s_lut[kSlotsPerPass * kValues];
  const int b = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * kThreads * kPerThread + threadIdx.x;
  const uint8_t* cb = codes + b * batch_stride;
  const float* lb = lut + static_cast<long long>(b) * S * V;
  float acc[kPerThread];
#pragma unroll
  for (int c = 0; c < kPerThread; ++c) acc[c] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kSlotsPerPass) {
    const int sc = min(kSlotsPerPass, S - s0);
    __syncthreads();  // readers of the previous pass are done
    for (int e = threadIdx.x; e < sc * kValues; e += kThreads) {
      const int s = e / kValues, v = e % kValues;
      s_lut[e] = v < V ? lb[static_cast<long long>(s0 + s) * V + v] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const long long n = n0 + static_cast<long long>(c) * kThreads;
      if (n >= N) break;
      const uint8_t* row = cb + n * S + s0;
      float a = acc[c];
      if (vec16) {  // S % 16 == 0 and the codes are 16-byte aligned
        for (int s = 0; s < sc; s += 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(row + s);
          a = add_code_bytes(a, w.x, s_lut + s * kValues);
          a = add_code_bytes(a, w.y, s_lut + (s + 4) * kValues);
          a = add_code_bytes(a, w.z, s_lut + (s + 8) * kValues);
          a = add_code_bytes(a, w.w, s_lut + (s + 12) * kValues);
        }
      } else {
        for (int s = 0; s < sc; ++s) a = __fadd_rn(a, s_lut[s * kValues + row[s]]);
      }
      acc[c] = a;
    }
  }
#pragma unroll
  for (int c = 0; c < kPerThread; ++c) {
    const long long n = n0 + static_cast<long long>(c) * kThreads;
    if (n < N) out[static_cast<long long>(b) * N + n] = acc[c];
  }
}

}  // namespace

// codes (N, S) with batch_stride 0, or (B, N, S) with batch_stride N·S;
// lut (B, S, V) → out (B, N).  Returns cudaGetLastError().
extern "C" int adc_dist_launch(const uint8_t* codes, long long batch_stride, const float* lut,
                               float* out, int B, int N, int S, int V, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || S < 0 || V < 1 || V > kValues) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec16 = S % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const long long per_block = static_cast<long long>(kThreads) * kPerThread;
  const dim3 grid(static_cast<unsigned>((N + per_block - 1) / per_block), B);
  adc_dist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, batch_stride, lut, out, N, S, V, vec16);
  return static_cast<int>(cudaGetLastError());
}
