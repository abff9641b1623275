// Gather-free candidate verification with a top-k answer, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/verify.py:34
// (verify_topk_kernel, launched by verify_topk_pallas): for each query,
// the exact squared distances to its Tc candidate rows of data (n, d),
// ids −1 being padding, and the k ≤ 128 smallest in ascending order,
// ties going to the earliest candidate position.  The (B, Tc, d) tensor
// of gathered rows never exists.
//
// What bounds it on the H100: each candidate row (d floats) is read
// once and used for 3·d flops, so the kernel is bound by memory: the
// B·Tc·d·4 bytes of the rows it gathers.
//
// What the design does about it.  The TPU kernel DMAs one candidate row
// at a time into VMEM and keeps a running top-k across a serial grid;
// here the grid is (S splits of Tc) × B, sized by the wrapper to one
// wave of resident blocks, so a single query's ~10^5 candidates still
// spread over the SMs.  Each warp reads four candidate rows at a time,
// coalesced, so four rows' loads are in flight together, and reduces
// Σ(x − q)² in the difference form, as the CPU reference does (the norm
// trick cancels on near-duplicates).  A block keeps its running top-k in
// shared memory as (d², candidate position) pairs: new distances fill the rest of a
// kBuf-slot buffer, and a bitonic sort on that key brings the k best to
// the front.  A second kernel merges the S partial lists of each query
// the same way and maps positions to ids; an +inf slot answers −1.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBuf = 2048;  // (d², position) slots sorted at a time
constexpr int kMaxK = 128;
constexpr int kRowsInFlight = 4;  // candidate rows each warp reads at once

__global__ void __launch_bounds__(kThreads, 4)
verify_partial_kernel(const float* __restrict__ data, const float* __restrict__ q,
                      const int* __restrict__ cand, float* __restrict__ part_v,
                      int* __restrict__ part_p, int d, int Tc, int k, int S, int R) {
  extern __shared__ float s_q[];  // the query row, d floats
  __shared__ float s_v[kBuf];
  __shared__ int s_p[kBuf];
  const int b = blockIdx.y, split = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < d; i += kThreads) s_q[i] = q[static_cast<long long>(b) * d + i];
  for (int i = tid; i < k; i += kThreads) {
    s_v[i] = INFINITY;
    s_p[i] = INT_MAX;
  }
  __syncthreads();
  const int* crow = cand + static_cast<long long>(b) * Tc;
  const int start = split * R;
  const int end = min(start + R, Tc);
  const int fresh = kBuf - k;  // slots behind the running top-k
  for (int base = start; base < end; base += fresh) {
    const int cnt = min(fresh, end - base);
    // each warp reads kRowsInFlight candidate rows at once: their loads
    // are independent, so their latencies overlap
    for (int t0 = warp * kRowsInFlight; t0 < cnt; t0 += kWarps * kRowsInFlight) {
      const float* xr[kRowsInFlight];
      float s[kRowsInFlight];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const int id = t0 + r < cnt ? crow[base + t0 + r] : -1;  // warp-uniform
        xr[r] = id >= 0 ? data + static_cast<long long>(id) * d : nullptr;
        s[r] = 0.f;
      }
#pragma unroll 4
      for (int c = lane; c < d; c += 32) {
        const float qc = s_q[c];
#pragma unroll
        for (int r = 0; r < kRowsInFlight; ++r) {
          if (xr[r]) {
            const float df = xr[r][c] - qc;
            s[r] += df * df;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const float dist = rt::warp_sum(s[r]);
        if (lane == 0 && t0 + r < cnt) {
          s_v[k + t0 + r] = xr[r] ? dist : INFINITY;
          s_p[k + t0 + r] = base + t0 + r;
        }
      }
    }
    for (int t = k + cnt + tid; t < kBuf; t += kThreads) {
      s_v[t] = INFINITY;
      s_p[t] = INT_MAX;
    }
    __syncthreads();
    rt::sort_pairs<kThreads>(s_v, s_p, kBuf);
  }
  float* ov = part_v + (static_cast<long long>(b) * S + split) * k;
  int* op = part_p + (static_cast<long long>(b) * S + split) * k;
  for (int i = tid; i < k; i += kThreads) {
    ov[i] = s_v[i];
    op[i] = s_p[i];
  }
}

// Merge the S sorted partial lists of each query (M = S·k pairs) and
// answer (d², id); +inf slots and empty slots answer id −1.
__global__ void __launch_bounds__(kThreads)
verify_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_p,
                    const int* __restrict__ cand, float* __restrict__ out_v,
                    int* __restrict__ out_i, int Tc, int k, int M) {
  __shared__ float s_v[kBuf];
  __shared__ int s_p[kBuf];
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int i = tid; i < k; i += kThreads) {
    s_v[i] = INFINITY;
    s_p[i] = INT_MAX;
  }
  const float* pv = part_v + static_cast<long long>(b) * M;
  const int* pp = part_p + static_cast<long long>(b) * M;
  const int fresh = kBuf - k;
  for (int base = 0; base < M; base += fresh) {
    const int cnt = min(fresh, M - base);
    for (int t = tid; t < fresh; t += kThreads) {
      s_v[k + t] = t < cnt ? pv[base + t] : INFINITY;
      s_p[k + t] = t < cnt ? pp[base + t] : INT_MAX;
    }
    __syncthreads();
    rt::sort_pairs<kThreads>(s_v, s_p, kBuf);
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads) {
    const float v = s_v[i];
    const int p = s_p[i];
    out_v[static_cast<long long>(b) * k + i] = v;
    out_i[static_cast<long long>(b) * k + i] =
        (v == INFINITY || p == INT_MAX) ? -1 : cand[static_cast<long long>(b) * Tc + p];
  }
}

}  // namespace

// Blocks of the partial kernel one SM holds at once for rows of d floats
// (0 if the occupancy query fails); the wrapper sizes S to one wave.
extern "C" int verify_topk_blocks_per_sm(int d) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, verify_partial_kernel, kThreads, sizeof(float) * static_cast<size_t>(d)) !=
      cudaSuccess) {
    return 0;
  }
  return blocks;
}

// data (n, d), q (B, d), cand (B, Tc) → out_v (B, k), out_i (B, k).
// part_v / part_p are scratch of B·S·k entries.  Returns cudaGetLastError().
extern "C" int verify_topk_launch(const float* data, const float* q, const int* cand,
                                  float* out_v, int* out_i, float* part_v, int* part_p,
                                  int d, int B, int Tc, int k, int S, void* stream) {
  if (k < 1 || k > kMaxK || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = (Tc + S - 1) / S;
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  verify_partial_kernel<<<dim3(S, B), kThreads, smem, st>>>(data, q, cand, part_v, part_p,
                                                            d, Tc, k, S, R);
  verify_merge_kernel<<<B, kThreads, 0, st>>>(part_v, part_p, cand, out_v, out_i, Tc, k,
                                              S * k);
  return static_cast<int>(cudaGetLastError());
}
