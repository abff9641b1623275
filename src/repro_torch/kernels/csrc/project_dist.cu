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
// floats.  So reading x (1 GB at N = 1M, d = 256) and writing the (B, N)
// output bound it; the projection's 2·d·m flops a point (≈ 0.14 ms of the
// card's FMA rate at that shape) have to hide under the reads.
//
// What the design does about it: a grid of a few blocks an SM, each
// staging A (zero-padded to MP columns) and the projected queries with
// their norms once, walks tiles of 256 points.  A tile's rows come in 32
// features at a time by cp.async (16-byte copies where d % 4 == 0 and x
// is aligned, 4-byte ones otherwise), into a ring of two stages that runs
// on across tiles, so the next chunk is in flight while one is projected
// and while a finished tile's output is written.  A stage holds each row's
// 32 features as 8 16-byte slots, slot k of row r at k ^ ((r / 2) % 8):
// the 8 threads of a shared-memory phase read 8 different banks.  Each
// thread projects two consecutive points, so each broadcast read of A
// serves 2 × 4 multiply-adds; their MP coordinates stay in registers.
// Where A does not fit whole (d·MP floats past 32 KB: d = 4096), each
// stage also carries A's 32 rows of its chunk, so shared memory stays
// bounded at any d.  The output phase is norm_trick.cuh's, the one
// pairwise_dist.cu's narrow schedule runs.
//
// The arithmetic is fixed whatever the schedule: x_n·A[:, j] is an fmaf
// chain over the features in order (zero padding past d adds nothing, as
// in norm_trick.cuh); |p|², |qp|² and the cross term are fmaf chains over
// the MP columns; the entry is __fsub_rn(__fadd_rn(|qp|², |p|²),
// __fmul_rn(2, cross)) clamped at 0.
#include "common.cuh"
#include "norm_trick.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPts = 2 * kThreads;     // points a tile, two a thread
constexpr int kChunk = 32;             // features of a row a stage holds
constexpr int kStageX = kPts * kChunk;
constexpr int kWholeA = 8192;          // floats of A kept whole (32 KB)

// Dynamic shared memory: two stages of x, A (whole, or two stages of its
// chunk rows), then the staged queries and their norms.
template <int MP>
constexpr size_t project_smem() {
  return sizeof(float) * (2 * kStageX + kWholeA + rt::kNormQ * MP + rt::kNormQ);
}

template <int MP>  // m padded: 16 or 32
__global__ void __launch_bounds__(kThreads)
project_dist_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ qp, float* __restrict__ out, int B, int N, int d,
                    int m, bool vec, bool a_whole) {
  extern __shared__ __align__(16) float smem[];
  float* const xs = smem;                    // [2][kPts][kChunk], slots swizzled
  float* const as = xs + 2 * kStageX;        // [d padded][MP], or [2][kChunk][MP]
  float* const qs = as + kWholeA;            // [kNormQ][MP]
  float* const qn = qs + rt::kNormQ * MP;    // [kNormQ]
  const int tid = threadIdx.x;
  const int tiles = (N + kPts - 1) / kPts;
  const int chunks = (d + kChunk - 1) / kChunk;

  // Tile t's features c0 .. c0 + kChunk into stage b: x's rows, zeros past
  // N and past d, and A's rows where A is not whole.
  auto issue = [&](int t, int c0, int b) {
    const long long n0 = static_cast<long long>(t) * kPts;
    const int rows = static_cast<int>(min(static_cast<long long>(kPts), N - n0));
    float* stage = xs + b * kStageX;
    if (vec) {
#pragma unroll 4
      for (int e = tid; e < kPts * (kChunk / 4); e += kThreads) {
        const int r = e >> 3, k = e & 7;
        const bool in = r < rows && c0 + 4 * k < d;  // d % 4 == 0: a quad is whole
        rt::cp_async16(stage + r * kChunk + 4 * (k ^ ((r >> 1) & 7)),
                       in ? x + (n0 + r) * d + c0 + 4 * k : x, in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < kPts * kChunk; e += kThreads) {
        const int r = e >> 5, c = e & 31;
        const bool in = r < rows && c0 + c < d;
        rt::cp_async4(stage + r * kChunk + 4 * ((c >> 2) ^ ((r >> 1) & 7)) + (c & 3),
                      in ? x + (n0 + r) * d + c0 + c : x, in ? 4 : 0);
      }
    }
    if (!a_whole) {
      float* ab = as + b * kChunk * MP;
      for (int e = tid; e < kChunk * MP; e += kThreads) {
        const int c = e / MP, j = e % MP;
        const bool in = c0 + c < d && j < m;
        rt::cp_async4(ab + e, in ? a + static_cast<long long>(c0 + c) * m + j : a, in ? 4 : 0);
      }
    }
    rt::cp_commit();
  };

  if (a_whole) {  // A once, zeros past m and past d
    for (int e = tid; e < chunks * kChunk * MP; e += kThreads) {
      const int c = e / MP, j = e % MP;
      as[e] = (c < d && j < m) ? a[static_cast<long long>(c) * m + j] : 0.f;
    }
  }
  if (B <= rt::kNormQ) rt::stage_queries<MP, kThreads>(qp, m, m, 0, B, qs, qn);

  // the steps (tile, chunk) of this block in order, the next one staged
  // while the current one is projected: tiles blockIdx.x + i·gridDim.x
  float p[2][MP];
  const int swz = tid & 7;  // rows 2·tid and 2·tid + 1: (r / 2) % 8
  int t = blockIdx.x, chunk = 0, nt = t, nchunk = 0, b = 0;
  if (t < tiles) issue(t, 0, 0);
  for (; t < tiles; b ^= 1) {
    rt::cp_wait_all();  // this thread's copies of this step have landed
    __syncthreads();    // everyone's have, and everyone is done with the last step
    if (++nchunk == chunks) {
      nchunk = 0;
      nt += gridDim.x;
    }
    if (nt < tiles) issue(nt, nchunk * kChunk, b ^ 1);
    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < MP; ++j) p[0][j] = p[1][j] = 0.f;
    }
    const float4* x4 = reinterpret_cast<const float4*>(xs + b * kStageX) + 2 * tid * 8;
    const float* ab = a_whole ? as + chunk * kChunk * MP : as + b * kChunk * MP;
#pragma unroll 2
    for (int k = 0; k < kChunk / 4; ++k) {
      const float4 v0 = x4[k ^ swz], v1 = x4[8 + (k ^ swz)];
      const float f0[4] = {v0.x, v0.y, v0.z, v0.w}, f1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // feature 4k + i, in order
        const float4* arow = reinterpret_cast<const float4*>(ab + (4 * k + i) * MP);
#pragma unroll
        for (int j4 = 0; j4 < MP / 4; ++j4) {
          const float4 w = arow[j4];  // the same address across the block: a broadcast
          p[0][4 * j4] = fmaf(f0[i], w.x, p[0][4 * j4]);
          p[0][4 * j4 + 1] = fmaf(f0[i], w.y, p[0][4 * j4 + 1]);
          p[0][4 * j4 + 2] = fmaf(f0[i], w.z, p[0][4 * j4 + 2]);
          p[0][4 * j4 + 3] = fmaf(f0[i], w.w, p[0][4 * j4 + 3]);
          p[1][4 * j4] = fmaf(f1[i], w.x, p[1][4 * j4]);
          p[1][4 * j4 + 1] = fmaf(f1[i], w.y, p[1][4 * j4 + 1]);
          p[1][4 * j4 + 2] = fmaf(f1[i], w.z, p[1][4 * j4 + 2]);
          p[1][4 * j4 + 3] = fmaf(f1[i], w.w, p[1][4 * j4 + 3]);
        }
      }
    }
    if (++chunk < chunks) continue;

    // the tile is projected: its output, while the next step is in flight
    float pn[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      pn[0] = fmaf(p[0][j], p[0][j], pn[0]);
      pn[1] = fmaf(p[1][j], p[1][j], pn[1]);
    }
    const long long n = static_cast<long long>(t) * kPts + 2 * tid;
    const int valid = static_cast<int>(max(0LL, min(2LL, N - n)));
    for (int b0 = 0; b0 < B; b0 += rt::kNormQ) {
      const int nq = min(rt::kNormQ, B - b0);
      if (B > rt::kNormQ) rt::stage_queries<MP, kThreads>(qp, m, m, b0, nq, qs, qn);
      if (valid > 0) {
        rt::write_distances<2, MP>(p, pn, qs, qn, nq, out + static_cast<long long>(b0) * N + n,
                                   N, valid);
      }
    }
    chunk = 0;
    t += gridDim.x;
  }
}

template <int MP>
int launch(const float* x, const float* a, const float* qp, float* out, int B, int N, int d,
           int m, cudaStream_t stream) {
  static int cache[rt::kMaxDevices] = {0};
  cudaError_t err = cudaSuccess;
  const int resident = rt::resident_grid(reinterpret_cast<const void*>(project_dist_kernel<MP>),
                                         kThreads, project_smem<MP>(), cache, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool a_whole = static_cast<long long>((d + kChunk - 1) / kChunk) * kChunk * MP <= kWholeA;
  const int tiles = (N + kPts - 1) / kPts;
  project_dist_kernel<MP><<<min(tiles, resident), kThreads, project_smem<MP>(), stream>>>(
      x, a, qp, out, B, N, d, m, vec, a_whole);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, d), a (d, m), qp (B, m) → out (B, N), m ≤ 32.  Returns
// cudaGetLastError(), or the error of a device query.
extern "C" int project_dist_launch(const float* x, const float* a, const float* qp,
                                   float* out, int B, int N, int d, int m, void* stream) {
  if (m < 1 || m > 32) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 16) return launch<16>(x, a, qp, out, B, N, d, m, st);
  return launch<32>(x, a, qp, out, B, N, d, m, st);
}
