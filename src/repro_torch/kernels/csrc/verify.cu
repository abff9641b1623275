// Gather-free candidate verification with a top-k answer, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/verify.py:34
// (verify_topk_kernel, launched by verify_topk_pallas at :140): for each
// query, the exact squared distances to its Tc candidate rows of data
// (n, d), ids −1 being padding, and the k ≤ 128 smallest in ascending
// order, ties going to the earliest candidate position; slots past a
// query's real candidates answer (+inf, −1).  The (B, Tc, d) tensor of
// gathered rows never exists.
//
// What bounds it on the H100: memory.  The B·Tc candidates of a batch
// name far fewer distinct rows (at B = 64 on the Deep1M twin, 6.19 M
// candidates name 0.97 M rows), and the data is 20× the 50 MB L2, so a
// kernel that reads a row for each (query, candidate) pair reads each row
// from HBM about 6 times.  The one-read bound is the distinct rows' bytes.
//
// What the design does about it: a counting sort of the (query,
// position) entries by row id, so each distinct row is read once per
// group of queries, then the plain version's own answer step.
//   1. count   each entry takes the next rank of its row's count (an
//              atomic) and writes the rank at its place in dist (B, W),
//              W = max(Tc, k); a padding entry (id −1, a position past Tc,
//              an id outside [0, n)) writes +inf there, for good.
//   2. scan    an exclusive scan of the counts, with the number of
//              non-empty rows before each row beside it (one 64-bit sum:
//              count low, non-empty high): tile sums, a one-block scan of
//              them, then each tile's scan writes the row's offset into
//              counts and, for a non-empty row, its id and offset into the
//              compact lists rows / starts.
//   3. scatter each entry b·W + pos goes to its row's offset plus its rank
//              in entries, with no atomics.
//   4. distance d ≤ 512 (verify_dist_kernel): one block an SM; a warp
//              takes 32 consecutive non-empty rows a turn and reads each
//              row once into registers, kPer floats a lane, under an L2
//              evict-first policy, while it sums the previous row's
//              entries: Σ(x − q_b)² in the difference form against the
//              query in shared memory (zero-padded to 32·kPer floats, so no
//              lane tests the width), 8 entries at a time finished by one
//              reduce-scatter; each d² goes to dist[b, pos], over the rank.
//              The queries that fit 64 KB of shared memory form a group.
//              d > 512 (verify_wide_kernel): see below.  Steps 1–4 run
//              once per group.
//   5. answer  rt_topk_launch (topk.cu) on dist: the k smallest by (d²,
//              position), mapped through cand to ids, −1 where d² = +inf.
// This is ref.verify_topk's own sequence with the gather replaced, so the
// ids equal the plain version's by construction.  The distance pass counts
// the rows it read into rows_read.
//
// The wide path (d in (512, 8192]: a kNN-LM datastore keyed on an LM's
// hidden states, d = 4096 for yi-6b; a flat search of GIST's 960).  A row
// no longer fits a warp's registers nor a group's whole queries shared
// memory, and each entry's 4d bytes of query would stream from the L2.
//   Groups by the L2: as many queries as keep G·d·4 bytes within 8 MiB
//     (kGroupFloats), at most 512: at d = 4096 a batch of 64 is one group,
//     so steps 1–3 run once and each distinct row crosses from HBM once.
//   Feature chunks: the group's queries and the rows go through shared
//     memory C floats of the row at a time (C = 256 for G ≤ 64; 128, 64,
//     32 for larger groups, so that G·C fills the 64-KB query buffer).
//     Chunk c's queries load once a block into one of two buffers while
//     chunk c − 1 is summed; an entry's partial d² of the chunk goes to
//     dist[b, pos] (the first chunk writes, the others add), so the
//     queries cross from the L2 once a block and not once an entry.
//   Work by entry: persistent blocks, one an SM, each a run of consecutive
//     non-empty rows balanced by entries + 6·rows (a row's HBM read costs
//     about six entries' sums), walking (chunk, 8,192 floats of its rows)
//     stages through a ring of three.  One producer warp loads each stage
//     by the 1-D TMA (cp.async.bulk, one copy a row chunk, completion on
//     an mbarrier) where d % 4 == 0 and data and q are 16-byte aligned, by
//     4-byte cp.async otherwise, with the stage's entry offsets beside it;
//     eight consumer warps each take an even share of a stage's entries,
//     so a row named once and a row named 64 times both keep every warp
//     busy, and free the slot (a second mbarrier) at their own pace.  L
//     lanes (32, or 16 / 8 for the narrow chunks) sum an entry, 4 floats a
//     lane at a time, the row's floats held in registers while consecutive
//     entries name it, 8 entries finished by one reduce-scatter.
//   Each d² is Σ(x − q)² in float32 on the CUDA cores (no tensor cores:
//     TF32 would move d² and with it ties), in the order: each lane's 4·V
//     floats of the chunk, a butterfly over the L lanes, the chunks in
//     order.  What bounds it at lm_knn's (64, 1,593, 4096) on the H100: not
//     the distinct rows' bytes from HBM (the ring alone streams them in
//     0.12 ms) but the consumers' sums, which never wait for a stage: the
//     issue of each step's shuffles, shared-memory reads (a query's 1 KB
//     chunk an entry) and FMAs.  PERF.md §6 has the traffic model and the
//     figures.
#include "common.cuh"

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxD = 8192;
constexpr int kQueryFloats = 16384;  // queries of one group: 64 KB of shared memory
constexpr int kFlatThreads = 256;    // count and scatter
constexpr int kFlatPer = 4;          // entries a thread takes, their loads in flight together
constexpr int kScanThreads = 256;
constexpr int kScanPer = 8;
constexpr int kTile = kScanThreads * kScanPer;  // counts per scan tile
constexpr int kDistThreads = 1024;  // one block an SM
constexpr int kDistWarps = kDistThreads / 32;
constexpr int kMaxPer = 16;  // row floats a lane holds in registers (d ≤ 512)
// the wide path (d > 32·kMaxPer)
constexpr int kGroupFloats = 1 << 21;  // a group's queries: 8 MiB of the L2
constexpr int kWideMaxGroup = 512;     // so that 32 floats of each fill a query buffer
constexpr int kWideQFloats = 16384;    // one chunk of the group's queries: 64 KB, two buffers
constexpr int kWideStageFloats = 8192;  // one chunk of a stage's rows: 32 KB
constexpr int kWideStages = 3;
constexpr int kWideMaxRows = 96;  // rows a stage holds at most
constexpr int kWideWarps = 8;     // consumers, and one producer warp
constexpr int kWideThreads = 32 * (kWideWarps + 1);
constexpr int kRowEntries = 6;  // a row's HBM read weighs as much as six entries' sums

using u64 = unsigned long long;


__device__ __forceinline__ u64 pack(int count) {
  return static_cast<u64>(count) | (count > 0 ? (1ull << 32) : 0ull);
}

// Exclusive scan over the block of one 64-bit value a thread; *total
// gets the block's sum.  s_warp holds kT / 32 + 1 values.
template <int kT>
__device__ __forceinline__ u64 block_exclusive_scan(u64 v, u64* s_warp, u64* total) {
  constexpr int kW = kT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(rt::kFullMask, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const u64 w = lane < kW ? s_warp[lane] : 0ull;
    u64 wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 y = __shfl_up_sync(rt::kFullMask, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kW) s_warp[lane] = wi - w;
    if (lane == kW - 1) s_warp[kW] = wi;
  }
  __syncthreads();
  *total = s_warp[kW];
  const u64 out = s_warp[warp] + inc - v;
  __syncthreads();  // s_warp is free again
  return out;
}

// 1 and 3.  The entries of query g0 + blockIdx.y at kFlatThreads·kFlatPer
// positions from blockIdx.x's.  kScatter false: count them, and write
// each entry's rank among its row's entries into its place in dist (a
// padding entry writes +inf there, for good); true: place each entry in
// its row's slice at its rank (counts holds the offsets), so the scatter
// takes no atomics.  The distance pass overwrites every rank.  A thread
// issues its loads, then its atomics, then its stores, so their latencies
// overlap.
template <bool kScatter>
__global__ void __launch_bounds__(kFlatThreads)
verify_entries_kernel(const int* __restrict__ cand, int* __restrict__ counts,
                      float* __restrict__ dist, int* __restrict__ entries, int n, int Tc,
                      int W, int g0) {
  const int b = g0 + blockIdx.y;
  const int* crow = cand + static_cast<long long>(b) * Tc;
  int* rank = reinterpret_cast<int*>(dist);
  const int p0 = blockIdx.x * kFlatThreads * kFlatPer + threadIdx.x;
  int id[kFlatPer], r[kFlatPer];
#pragma unroll
  for (int i = 0; i < kFlatPer; ++i) {
    const int pos = p0 + i * kFlatThreads;
    id[i] = pos < Tc ? crow[pos] : -1;
    if (id[i] >= n || pos >= W) id[i] = -1;
    if (kScatter && id[i] >= 0) r[i] = rank[b * W + pos];
  }
#pragma unroll
  for (int i = 0; i < kFlatPer; ++i) {
    if (id[i] >= 0) r[i] = kScatter ? counts[id[i]] + r[i] : atomicAdd(&counts[id[i]], 1);
  }
#pragma unroll
  for (int i = 0; i < kFlatPer; ++i) {
    const int pos = p0 + i * kFlatThreads;
    if (kScatter) {
      if (id[i] >= 0) entries[r[i]] = b * W + pos;
    } else if (pos < W) {
      if (id[i] >= 0) {
        rank[b * W + pos] = r[i];
      } else {
        dist[b * W + pos] = INFINITY;
      }
    }
  }
}

// Each thread's kScanPer counts of a tile, packed (0 past n).
__device__ __forceinline__ void load_counts(const int* counts, int i0, int n,
                                            int (&c)[kScanPer]) {
  if (i0 + kScanPer <= n) {
    const int4 a = *reinterpret_cast<const int4*>(counts + i0);
    const int4 b = *reinterpret_cast<const int4*>(counts + i0 + 4);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  } else {
#pragma unroll
    for (int r = 0; r < kScanPer; ++r) c[r] = i0 + r < n ? counts[i0 + r] : 0;
  }
}

// 2a.  tile_sum[t] = the packed sum of tile t's counts.
__global__ void __launch_bounds__(kScanThreads)
verify_tile_sum_kernel(const int* __restrict__ counts, u64* __restrict__ tile_sum, int n) {
  __shared__ u64 s_warp[kScanThreads / 32 + 1];
  int c[kScanPer];
  load_counts(counts, blockIdx.x * kTile + threadIdx.x * kScanPer, n, c);
  u64 v = 0;
#pragma unroll
  for (int r = 0; r < kScanPer; ++r) v += pack(c[r]);
  u64 total;
  block_exclusive_scan<kScanThreads>(v, s_warp, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// 2b.  One block: tile_sum becomes its exclusive scan; *rows_used gets
// the group's non-empty rows U, and starts[U] the group's entries.
__global__ void __launch_bounds__(1024)
verify_tile_scan_kernel(u64* __restrict__ tile_sum, int tiles, int* __restrict__ starts,
                        int* __restrict__ rows_used) {
  __shared__ u64 s_warp[1024 / 32 + 1];
  u64 carry = 0;
  for (int base = 0; base < tiles; base += 1024) {
    const int t = base + threadIdx.x;
    u64 total;
    const u64 ex = block_exclusive_scan<1024>(t < tiles ? tile_sum[t] : 0ull, s_warp, &total);
    if (t < tiles) tile_sum[t] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    const int U = static_cast<int>(carry >> 32);
    *rows_used = U;
    starts[U] = static_cast<int>(carry & 0xffffffffull);
  }
}

// 2c.  counts[i] becomes row i's offset in entries; a non-empty row's id
// and offset go to rows / starts at its rank among the non-empty rows,
// through shared memory so that the stores are coalesced.
__global__ void __launch_bounds__(kScanThreads)
verify_tile_write_kernel(int* __restrict__ counts, const u64* __restrict__ tile_sum,
                         int* __restrict__ rows, int* __restrict__ starts, int n) {
  __shared__ u64 s_warp[kScanThreads / 32 + 1];
  __shared__ int s_rows[kTile], s_starts[kTile];
  const int i0 = blockIdx.x * kTile + threadIdx.x * kScanPer;
  int c[kScanPer];
  load_counts(counts, i0, n, c);
  u64 v = 0;
#pragma unroll
  for (int r = 0; r < kScanPer; ++r) v += pack(c[r]);
  u64 total;
  const u64 ex = block_exclusive_scan<kScanThreads>(v, s_warp, &total);
  const u64 base = tile_sum[blockIdx.x];
  u64 off = base + ex;
  int local = static_cast<int>(ex >> 32);  // rank among the tile's non-empty rows
  int at[kScanPer];
#pragma unroll
  for (int r = 0; r < kScanPer; ++r) {
    at[r] = static_cast<int>(off & 0xffffffffull);
    if (c[r] > 0) {
      s_rows[local] = i0 + r;
      s_starts[local] = at[r];
      ++local;
    }
    off += pack(c[r]);
  }
  if (i0 + kScanPer <= n) {
    *reinterpret_cast<int4*>(counts + i0) = make_int4(at[0], at[1], at[2], at[3]);
    *reinterpret_cast<int4*>(counts + i0 + 4) = make_int4(at[4], at[5], at[6], at[7]);
  } else {
#pragma unroll
    for (int r = 0; r < kScanPer; ++r) {
      if (i0 + r < n) counts[i0 + r] = at[r];
    }
  }
  __syncthreads();
  const int m = static_cast<int>(total >> 32), j0 = static_cast<int>(base >> 32);
  for (int t = threadIdx.x; t < m; t += kScanThreads) {
    rows[j0 + t] = s_rows[t];
    starts[j0 + t] = s_starts[t];
  }
}

// The sums of 8 entries' lane partials, each over L lanes (a power of two,
// 8 ≤ L ≤ 32; L < 32: each sub-warp of L lanes its own 8 entries) in the
// order of rt::warp_sum (xor L/2, …, 1), by a reduce-scatter: lane l ends
// with the sum of entry 4·bit(l & L/2) + 2·bit(l & L/4) + bit(l & L/8).
// 9 shuffles for 8 sums at L = 32.
template <int L = 32>
__device__ __forceinline__ float reduce_scatter8(const float (&acc)[8], int lane) {
  const bool u4 = lane & (L / 2), u3 = lane & (L / 4), u2 = lane & (L / 8);
  float v4[4], v2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = u4 ? acc[i] : acc[i + 4];
    v4[i] = (u4 ? acc[i + 4] : acc[i]) + __shfl_xor_sync(rt::kFullMask, send, L / 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = u3 ? v4[i] : v4[i + 2];
    v2[i] = (u3 ? v4[i + 2] : v4[i]) + __shfl_xor_sync(rt::kFullMask, send, L / 4);
  }
  const float send = u2 ? v2[0] : v2[1];
  float v = (u2 ? v2[1] : v2[0]) + __shfl_xor_sync(rt::kFullMask, send, L / 8);
#pragma unroll
  for (int o = L / 16; o > 0; o >>= 1) v += __shfl_xor_sync(rt::kFullMask, v, o);
  return v;
}

// kV consecutive floats from p (4·kV-byte aligned) into out.
template <int kV>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (kV == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (kV == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

// The d² of one row's entries [s, e): 32 at a time each lane takes one
// entry's place and query offset (the first 32 are `first`, loaded ahead),
// then 8 entries at a time each lane sums its floats' (x − q)² and a
// reduce-scatter finishes the 8 sums.  The row is x, kPer floats a lane,
// kV consecutive ones in each slab of 32·kV, and a query row is dq =
// 32·kPer floats, zero past d, so (0 − 0)² adds nothing.
template <int kPer>
__device__ __forceinline__ void row_distances(const float (&x)[kPer], const float* s_q,
                                              const int* __restrict__ entries, int s, int e,
                                              int first, float* __restrict__ dist, int dq,
                                              int W, int g0, int lane) {
  constexpr int kV = kPer < 4 ? kPer : 4;
  for (int c0 = s; c0 < e; c0 += 32) {
    const int cnt = min(32, e - c0);
    const int my_e = c0 == s ? first : (lane < cnt ? entries[c0 + lane] : 0);
    const int my_q = lane < cnt ? (my_e / W - g0) * dq : 0;
    for (int t0 = 0; t0 < cnt; t0 += 8) {
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i] = 0.f;
        const float* qs = s_q + __shfl_sync(rt::kFullMask, my_q, (t0 + i) & 31);
        if (t0 + i < cnt) {  // warp-uniform
          float qv[kPer];
#pragma unroll
          for (int v = 0; v < kPer; v += kV) load_vec<kV>(qs + 32 * v + kV * lane, qv + v);
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            const float df = x[v] - qv[v];
            acc[i] += df * df;
          }
        }
      }
      const float sum = reduce_scatter8(acc, lane);
      const int idx = (lane >> 2) & 7;  // the entry reduce_scatter8 left here
      const int ent = __shfl_sync(rt::kFullMask, my_e, (t0 + idx) & 31);
      if ((lane & 3) == 0 && t0 + idx < cnt) dist[ent] = sum;
    }
  }
}

// An L2 policy that evicts first what it tags: the candidate rows, read
// once, so that they do not push dist and entries out of the L2.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// Row x's floats of lane into registers, kV consecutive ones in each slab
// of 32·kV, 0 past d, loaded under `policy`; vec16: one 16-byte load a
// slab (d % 4 == 0 and x 16-byte aligned).
template <int kPer, int kV>
__device__ __forceinline__ void load_row(const float* __restrict__ xr, int d, int lane,
                                         bool vec16, unsigned long long policy,
                                         float (&x)[kPer]) {
#pragma unroll
  for (int v = 0; v < kPer; v += kV) {
    const int c = 32 * v + kV * lane;
    if constexpr (kV == 4) {
      if (vec16) {
        x[v] = x[v + 1] = x[v + 2] = x[v + 3] = 0.f;
        if (c < d) {
          asm("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
              : "=f"(x[v]), "=f"(x[v + 1]), "=f"(x[v + 2]), "=f"(x[v + 3])
              : "l"(xr + c), "l"(policy));
        }
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      float y = 0.f;
      if (c + j < d) {
        asm("ld.global.L2::cache_hint.f32 %0, [%1], %2;\n" : "=f"(y) : "l"(xr + c + j),
            "l"(policy));
      }
      x[v + j] = y;
    }
  }
}

// 4, d ≤ 512.  Persistent warps over the group's U non-empty rows, 32 consecutive
// rows a turn: lane l holds row l's id and slice, loaded a turn ahead.
// A warp holds the row it sums in registers, kPer floats a lane, while the
// next row's floats and first 32 entries load.
template <int kPer>
__global__ void __launch_bounds__(kDistThreads, 1)
verify_dist_kernel(const float* __restrict__ data, const float* __restrict__ q,
                   const int* __restrict__ rows, const int* __restrict__ starts,
                   const int* __restrict__ entries, const int* __restrict__ rows_used,
                   float* __restrict__ dist, int* __restrict__ rows_read, int d, int dq,
                   int W, int g0, int G, bool vec16) {
  extern __shared__ float4 s_mem[];  // the group's G queries, dq floats each
  float* s_q = reinterpret_cast<float*>(s_mem);
  for (int i = threadIdx.x; i < G * dq; i += kDistThreads) {
    const int b = i / dq, c = i - b * dq;
    s_q[i] = c < d ? q[static_cast<long long>(g0 + b) * d + c] : 0.f;
  }
  __syncthreads();
  const int U = *rows_used;
  const int lane = threadIdx.x & 31;
  const int turns = (U + 31) / 32;
  const int stride = gridDim.x * kDistWarps;
  int turn = blockIdx.x * kDistWarps + (threadIdx.x >> 5);
  if (turn >= turns) return;
  // lane's row of turn t: id (−1 past U), start and end of its slice
  auto meta = [&](int t, int& r, int& rs, int& re) {
    const int j = t * 32 + lane;
    r = -1;
    rs = re = 0;
    if (t < turns && j < U) {
      r = rows[j];
      rs = starts[j];
      re = starts[j + 1];
    }
  };
  int r, rs, re, nr, nrs, nre;  // this turn's rows, the next turn's
  meta(turn, r, rs, re);
  meta(turn + stride, nr, nrs, nre);
  // the row u places after this turn's first (u < 64): id, slice
  auto row_at = [&](int u, int& id, int& fs, int& fe) {
    const int l = u & 31;
    const int i0 = __shfl_sync(rt::kFullMask, r, l), i1 = __shfl_sync(rt::kFullMask, nr, l);
    const int s0 = __shfl_sync(rt::kFullMask, rs, l), s1 = __shfl_sync(rt::kFullMask, nrs, l);
    const int e0 = __shfl_sync(rt::kFullMask, re, l), e1 = __shfl_sync(rt::kFullMask, nre, l);
    id = u < 32 ? i0 : i1;
    fs = u < 32 ? s0 : s1;
    fe = u < 32 ? e0 : e1;
  };
  constexpr int kV = kPer < 4 ? kPer : 4;
  const unsigned long long policy = evict_first_policy();
  int id, s0, e0, first = 0, nid, ns, ne, nfirst = 0;
  float x[kPer] = {}, nx[kPer] = {};
  row_at(0, id, s0, e0);
  if (id >= 0) load_row<kPer, kV>(data + static_cast<long long>(id) * d, d, lane, vec16, policy, x);
  if (id >= 0) first = lane < e0 - s0 ? entries[s0 + lane] : 0;
  int read = 0;
  for (int t = 0; id >= 0;) {
    if (++t == 32) {  // the next turn becomes this one
      t = 0;
      turn += stride;
      r = nr;
      rs = nrs;
      re = nre;
      meta(turn + stride, nr, nrs, nre);
    }
    row_at(t, nid, ns, ne);  // the next row, in flight while this one is summed
    if (nid >= 0) {
      load_row<kPer, kV>(data + static_cast<long long>(nid) * d, d, lane, vec16, policy, nx);
      nfirst = lane < ne - ns ? entries[ns + lane] : 0;
    }
    row_distances<kPer>(x, s_q, entries, s0, e0, first, dist, dq, W, g0, lane);
    ++read;
    id = nid;
    s0 = ns;
    e0 = ne;
    first = nfirst;
#pragma unroll
    for (int i = 0; i < kPer; ++i) x[i] = nx[i];
  }
  if (lane == 0) atomicAdd(rows_read, read);
}

// Launch the distance pass for kPer floats a lane, one block an SM, over
// queries [g0, g0 + G) of dq floats each.
template <int kPer>
cudaError_t launch_dist(const float* data, const float* q, const int* rows, const int* starts,
                        const int* entries, const int* rows_used, float* dist, int* rows_read,
                        int d, int dq, int W, int g0, int G, cudaStream_t st) {
  const size_t smem = sizeof(float) * static_cast<size_t>(G) * dq;
  const bool vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(verify_dist_kernel<kPer>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  verify_dist_kernel<kPer><<<sms, kDistThreads, smem, st>>>(
      data, q, rows, starts, entries, rows_used, dist, rows_read, d, dq, W, g0, G, vec16);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// 4, d > 512: the wide path (see the header).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(u64* bar, int parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// The producer warp's copy of nr rows, cols floats each, row r from
// src(r) to dst + r·C: one phase of bar, which also publishes the warp's
// shared-memory stores before it.  vec16: lane 0 asks for the bytes, then
// each lane issues a 1-D TMA copy (cp.async.bulk) a row (16-byte aligned
// source, cols % 4 == 0); bar counts 1 arrival.  Otherwise the lanes copy
// each row's floats with 4-byte cp.async and arrive as theirs land, and
// lane 0 arrives once more; bar counts 33.
template <typename Src>
__device__ __forceinline__ void warp_copy(float* dst, int nr, int cols, int C, Src src,
                                          bool vec16, u64* bar, int lane) {
  __syncwarp();
  if (vec16) {
    const unsigned bytes = 4u * static_cast<unsigned>(cols);
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(bar)),
                   "r"(bytes * nr)
                   : "memory");
    }
    for (int r = lane; r < nr; r += 32) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(dst + r * C)),
          "l"(src(r)), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
    }
  } else {
    for (int r = 0; r < nr; ++r) {
      const float* from = src(r);
      for (int c = lane; c < cols; c += 32) rt::cp_async4(dst + r * C + c, from + c, 4);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
                 : "memory");
    if (lane == 0) mbar_arrive(bar);
  }
}

// One stage's sums for this warp's entries [p0, p1) of the stage's nr rows
// (row r's chunk at s_x + r·C, its entries from s_st[r] to s_st[r + 1];
// query b's chunk at s_q + b·C).  A round of 32 entries: lane l takes
// entry p0 + 32·round + l (its place, loaded a round ahead, the first
// round's in `ent`; its row; its query; its d² so far).  A step: each
// sub-warp of L lanes sums 8 of them, lane sl of a sub-warp floats 4·sl +
// 4·L·u (u < V): the 8 entries' offsets and query floats load first, the
// row's floats stay in registers while consecutive entries name it, and a
// reduce-scatter finishes the 8 sums.  The round ends with each lane
// writing its entry's d² so far.  kTail: the chunk holds cols < C floats.
template <int L, int V, bool kTail>
__device__ __forceinline__ void wide_stage(const float* s_x, const float* s_q, const int* s_st,
                                           int nr, const int* __restrict__ entries, int p0,
                                           int p1, int ent, float* __restrict__ dist, int W,
                                           int g0, int cols, bool first, int lane) {
  constexpr int C = 4 * L * V, kSub = 32 / L;
  const int sub = lane / L, sl = lane % L;
  int row = 0;    // lane's row: its entries' rows only grow
  int xcur = -1;  // the sub-warp's row in xv
  float4 xv[V];
  for (int base = p0; base < p1; base += 32) {
    const int cnt = min(32, p1 - base), p = base + lane;
    const int ent_next = p + 32 < p1 ? entries[p + 32] : 0;
    int pk = 0;
    float prev = 0.f, mine = 0.f;
    if (lane < cnt) {
      if (!first) prev = dist[ent];
      int hi = nr - 1;  // the last row whose entries start at or before p
      while (row < hi) {
        const int mid = (row + hi + 1) >> 1;
        if (s_st[mid] <= p) row = mid; else hi = mid - 1;
      }
      pk = (ent / W - g0) * C | (row * C) << 16;  // query and row offsets
    }
    for (int t0 = 0; t0 < cnt; t0 += 8 * kSub) {  // warp-uniform
      // slots past cnt sum row 0 against query 0 and go unused
      int pko[8];
      float4 qv[8][V];
#pragma unroll
      for (int i = 0; i < 8; ++i) pko[i] = __shfl_sync(rt::kFullMask, pk, (t0 + 8 * sub + i) & 31);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          qv[i][u] = *reinterpret_cast<const float4*>(s_q + (pko[i] & 0xffff) + 4 * sl + 4 * L * u);
        }
      }
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int xo = pko[i] >> 16;
        if (xo != xcur) {  // uniform in a sub-warp
          xcur = xo;
#pragma unroll
          for (int u = 0; u < V; ++u) {
            xv[u] = *reinterpret_cast<const float4*>(s_x + xo + 4 * sl + 4 * L * u);
          }
        }
        acc[i] = 0.f;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int c = 4 * sl + 4 * L * u;
          float d0 = xv[u].x - qv[i][u].x, d1 = xv[u].y - qv[i][u].y, d2 = xv[u].z - qv[i][u].z,
                d3 = xv[u].w - qv[i][u].w;
          if (kTail && c + 4 > cols) {  // floats past the chunk add nothing
            if (c >= cols) d0 = 0.f;
            if (c + 1 >= cols) d1 = 0.f;
            if (c + 2 >= cols) d2 = 0.f;
            d3 = 0.f;
          }
          acc[i] += d0 * d0;
          acc[i] += d1 * d1;
          acc[i] += d2 * d2;
          acc[i] += d3 * d3;
        }
      }
      const float sum = reduce_scatter8<L>(acc, lane);
      // lane t0 + r takes the sum of step entry r = 8·sub' + i, which the
      // lanes sub'·L + i·(L / 8) + {0, …} hold
      const int r = lane - t0;
      const float got = __shfl_sync(rt::kFullMask, sum, ((r >> 3) * L + (r & 7) * (L / 8)) & 31);
      if (r >= 0 && r < 8 * kSub) mine = got;
    }
    if (lane < cnt) dist[ent] = prev + mine;
    ent = ent_next;
  }
}

// Persistent blocks, one an SM: block b takes the non-empty rows j whose
// key starts[j] + kRowEntries·j falls in its share of the group's, and
// walks (chunk, kRows of its rows) stages.  Warp kWideWarps produces: for
// each stage it loads the rows' ids and entry offsets, waits until the
// consumers have left the ring slot (empty), stores them beside it and
// issues the copies (full); a query chunk c + 2 once they have left chunk
// c.  Warps 0 … kWideWarps − 1 consume, each at its own pace: wait for the
// stage (and at a chunk's first stage its queries), sum its share of the
// stage's entries, leave the slot.  Shared memory: two query buffers, the
// ring, its rows' offsets and ids, then the barriers (full, empty, the
// queries').
template <int L, int V>
__global__ void __launch_bounds__(kWideThreads, 1)
verify_wide_kernel(const float* __restrict__ data, const float* __restrict__ q,
                   const int* __restrict__ rows, const int* __restrict__ starts,
                   const int* __restrict__ entries, const int* __restrict__ rows_used,
                   float* __restrict__ dist, int* __restrict__ rows_read, int d, int W, int g0,
                   int G, bool vec16) {
  constexpr int C = 4 * L * V, kS = kWideStages, kSt = kWideMaxRows + 2;
  constexpr int kRows = kWideStageFloats / C < kWideMaxRows ? kWideStageFloats / C : kWideMaxRows;
  constexpr int kPerLane = (kRows + 31) / 32;
  extern __shared__ float4 s_mem[];
  float* s_q = reinterpret_cast<float*>(s_mem);
  float* s_ring = s_q + 2 * kWideQFloats;
  int* s_st = reinterpret_cast<int*>(s_ring + kS * kWideStageFloats);  // [kS][kSt]
  int* s_rid = s_st + kS * kSt;                                         // [kS][kWideMaxRows]
  u64* full = reinterpret_cast<u64*>(s_rid + kS * kWideMaxRows);
  u64* empty = full + kS;
  u64* qfull = empty + kS;
  __shared__ int s_span[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const int U = *rows_used;
    const long long total = starts[U] + static_cast<long long>(kRowEntries) * U;
    for (int e = 0; e < 2; ++e) {  // the first row whose key reaches the block's share
      const long long target = total * (blockIdx.x + e) / gridDim.x;
      int lo = 0, hi = U;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (starts[mid] + static_cast<long long>(kRowEntries) * mid < target) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      s_span[e] = lo;
    }
    for (int i = 0; i < kS; ++i) {
      mbar_init(full + i, vec16 ? 1 : 33);
      mbar_init(empty + i, kWideWarps);
    }
    for (int i = 0; i < 2; ++i) mbar_init(qfull + i, vec16 ? 1 : 33);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int j_lo = s_span[0], j_hi = s_span[1];
  if (j_lo >= j_hi) return;
  const int groups = (j_hi - j_lo + kRows - 1) / kRows;  // stages a chunk
  const int chunks = (d + C - 1) / C, T = chunks * groups;
  if (warp == kWideWarps) {  // the producer
    auto issue_q = [&](int c) {
      const long long c0 = static_cast<long long>(c) * C;
      warp_copy(s_q + (c & 1) * kWideQFloats, G, min(C, d - c * C), C,
                [&](int b) { return q + static_cast<long long>(g0 + b) * d + c0; }, vec16,
                qfull + (c & 1), lane);
    };
    issue_q(0);
    if (chunks > 1) issue_q(1);
    for (int t = 0; t < T + kS; ++t) {
      const int c = t / groups, ja = j_lo + (t - c * groups) * kRows;
      const int nr = t < T ? min(kRows, j_hi - ja) : 0;
      int rid[kPerLane], sv[kPerLane + 1];  // in flight while the slot empties
#pragma unroll
      for (int i = 0; i <= kPerLane; ++i) {
        const int r = lane + 32 * i;
        if (i < kPerLane) rid[i] = r < nr ? rows[ja + r] : 0;
        sv[i] = r <= nr && nr > 0 ? starts[ja + r] : 0;
      }
      if (t >= kS) {  // the consumers have left stage t − kS
        const int done = t - kS;
        mbar_wait(empty + done % kS, (done / kS) & 1);
        if ((done + 1) % groups == 0 && done / groups + 2 < chunks) issue_q(done / groups + 2);
      }
      if (t >= T) continue;
      int* st = s_st + (t % kS) * kSt;
      int* sr = s_rid + (t % kS) * kWideMaxRows;
#pragma unroll
      for (int i = 0; i <= kPerLane; ++i) {
        const int r = lane + 32 * i;
        if (i < kPerLane && r < nr) sr[r] = rid[i];
        if (r <= nr) st[r] = sv[i];
      }
      if (lane == 0) st[kSt - 1] = nr;
      const long long c0 = static_cast<long long>(c) * C;
      __syncwarp();
      warp_copy(s_ring + (t % kS) * kWideStageFloats, nr, min(C, d - c * C), C,
                [&](int r) { return data + static_cast<long long>(sr[r]) * d + c0; }, vec16,
                full + t % kS, lane);
    }
    return;
  }
  for (int t = 0; t < T; ++t) {  // a consumer
    const int c = t / groups, cols = min(C, d - c * C);
    mbar_wait(full + t % kS, (t / kS) & 1);
    if (t % groups == 0) mbar_wait(qfull + (c & 1), (c >> 1) & 1);
    const int* st = s_st + (t % kS) * kSt;
    const int nr = st[kSt - 1], sa = st[0], sb = st[nr];
    const int per = (sb - sa + kWideWarps - 1) / kWideWarps;  // this warp's share
    const int p0 = min(sa + warp * per, sb), p1 = min(p0 + per, sb);
    const int ent = p0 + lane < p1 ? entries[p0 + lane] : 0;
    const float* s_x = s_ring + (t % kS) * kWideStageFloats;
    const float* s_qc = s_q + (c & 1) * kWideQFloats;
    if (cols == C) {
      wide_stage<L, V, false>(s_x, s_qc, st, nr, entries, p0, p1, ent, dist, W, g0, cols,
                              c == 0, lane);
    } else {
      wide_stage<L, V, true>(s_x, s_qc, st, nr, entries, p0, p1, ent, dist, W, g0, cols,
                             c == 0, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + t % kS);
  }
  if (threadIdx.x == 0) atomicAdd(rows_read, j_hi - j_lo);
}

// Floats of a feature chunk for a wide group of G ≤ kWideMaxGroup queries:
// the widest of 256, 128, 64, 32 whose G rows fit a query buffer.
int wide_chunk(int G) {
  const int fit = kWideQFloats / G;
  return fit >= 256 ? 256 : fit >= 128 ? 128 : fit >= 64 ? 64 : 32;
}

template <int L, int V>
cudaError_t launch_wide_at(const float* data, const float* q, const int* rows, const int* starts,
                           const int* entries, const int* rows_used, float* dist,
                           int* rows_read, int d, int W, int g0, int G, cudaStream_t st) {
  constexpr size_t smem =
      sizeof(float) * (2 * kWideQFloats + kWideStages * kWideStageFloats) +
      sizeof(int) * kWideStages * (2 * kWideMaxRows + 2) + sizeof(u64) * (2 * kWideStages + 2);
  static int grid_cache[rt::kMaxDevices];
  cudaError_t err = cudaSuccess;
  const int grid = rt::resident_grid(reinterpret_cast<const void*>(verify_wide_kernel<L, V>),
                                     kWideThreads, smem, grid_cache, &err);
  if (grid == 0) return err;
  const bool vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
  verify_wide_kernel<L, V><<<grid, kWideThreads, smem, st>>>(
      data, q, rows, starts, entries, rows_used, dist, rows_read, d, W, g0, G, vec16);
  return cudaSuccess;
}

// The wide distance pass over queries [g0, g0 + G), chunk floats a chunk.
cudaError_t launch_wide(int chunk, const float* data, const float* q, const int* rows,
                        const int* starts, const int* entries, const int* rows_used,
                        float* dist, int* rows_read, int d, int W, int g0, int G,
                        cudaStream_t st) {
  switch (chunk) {
#define VERIFY_WIDE(L, V) \
  return launch_wide_at<L, V>(data, q, rows, starts, entries, rows_used, dist, rows_read, d, W, g0, G, st)
    case 256: VERIFY_WIDE(32, 2);
    case 128: VERIFY_WIDE(32, 1);
    case 64: VERIFY_WIDE(16, 1);
    default: VERIFY_WIDE(8, 1);
#undef VERIFY_WIDE
  }
}

// The scratch regions, each aligned to 256 bytes.
struct Layout {
  long long dist, entries, counts, rows, starts, tile_sum, rows_used, part, bytes;
  int W, G, tiles, S_cap;
  int per;    // row floats a lane holds: a power of two ≤ kMaxPer, or 0 past 32·kMaxPer
  int dq;     // per > 0: floats of a query row in shared memory
  int chunk;  // per == 0: floats of a feature chunk (wide_chunk)
};

long long align256(long long x) { return (x + 255) & ~255ll; }

bool layout(int n, int d, int B, int Tc, int k, Layout* L) {
  if (n < 0 || d < 1 || d > kMaxD || B < 0 || B > 65535 || Tc < 0 || k < 1 || k > kMaxK) {
    return false;
  }
  L->W = Tc > k ? Tc : k;
  const long long E = static_cast<long long>(B) * L->W;
  if (E > 2147483647ll) return false;
  L->per = 1;
  while (32 * L->per < d && L->per <= kMaxPer) L->per *= 2;
  if (L->per > kMaxPer) L->per = 0;
  int cap;  // queries a group holds
  if (L->per > 0) {
    L->dq = 32 * L->per;
    cap = kQueryFloats / L->dq;
  } else {  // the wide path: the L2 holds the group's queries
    cap = kGroupFloats / d < kWideMaxGroup ? kGroupFloats / d : kWideMaxGroup;
  }
  L->G = B < cap ? B : cap;
  if (L->G < 1) L->G = 1;
  L->chunk = L->per > 0 ? 0 : wide_chunk(L->G);
  const long long ge = static_cast<long long>(L->G) * L->W;  // entries of one group
  const long long u_max = ge < n ? ge : n;
  L->tiles = (n + kTile - 1) / kTile;
  L->S_cap = (L->W + rt::kTopkSplitMin - 1) / rt::kTopkSplitMin;
  long long at = 0;
  L->dist = at;     at = align256(at + 4 * E);
  L->entries = at;  at = align256(at + 4 * ge);
  L->counts = at;   at = align256(at + 4ll * n);
  L->rows = at;     at = align256(at + 4 * u_max);
  L->starts = at;   at = align256(at + 4 * (u_max + 1));
  L->tile_sum = at; at = align256(at + 8ll * L->tiles);
  L->rows_used = at; at = align256(at + 4);
  L->part = at;     at = align256(at + 8 * static_cast<long long>(B) * L->S_cap * k);
  L->bytes = at;
  return true;
}

}  // namespace

// Queries verify_topk_launch verifies at once at width d (a group: up to
// d = 512 its queries fit kQueryFloats of shared memory, past it
// kGroupFloats of the L2, at most kWideMaxGroup), or −1 for d outside
// [1, 8192] or B outside [0, 65535].
extern "C" int verify_topk_group_size(int B, int d) {
  Layout L;
  return layout(0, d, B, 0, 1, &L) ? L.G : -1;
}

// Floats of the wide path's feature chunk at (B, d): 0 up to d = 512, −1
// where verify_topk_group_size is.
extern "C" int verify_topk_chunk(int B, int d) {
  Layout L;
  return layout(0, d, B, 0, 1, &L) ? L.chunk : -1;
}

// Bytes of scratch verify_topk_launch takes for these shapes, or −1 where
// it takes none of them (k outside [1, 128], d outside [1, 8192], B past
// 65,535, B·max(Tc, k) past 2³¹ − 1).
extern "C" long long verify_topk_scratch_bytes(int n, int d, int B, int Tc, int k) {
  Layout L;
  return layout(n, d, B, Tc, k, &L) ? L.bytes : -1;
}

// data (n, d), q (B, d), cand (B, Tc) → out_v (B, k), out_i (B, k);
// *rows_read gets the number of rows the distance passes read.  scratch
// holds verify_topk_scratch_bytes(n, d, B, Tc, k) bytes.  Returns a
// cudaError_t.
extern "C" int verify_topk_launch(const float* data, const float* q, const int* cand,
                                  float* out_v, int* out_i, int* rows_read, char* scratch,
                                  int n, int d, int B, int Tc, int k, void* stream) {
  Layout L;
  if (!layout(n, d, B, Tc, k, &L)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dist = reinterpret_cast<float*>(scratch + L.dist);
  int* entries = reinterpret_cast<int*>(scratch + L.entries);
  int* counts = reinterpret_cast<int*>(scratch + L.counts);
  int* rows = reinterpret_cast<int*>(scratch + L.rows);
  int* starts = reinterpret_cast<int*>(scratch + L.starts);
  u64* tile_sum = reinterpret_cast<u64*>(scratch + L.tile_sum);
  int* rows_used = reinterpret_cast<int*>(scratch + L.rows_used);
  u64* part = reinterpret_cast<u64*>(scratch + L.part);
  cudaError_t err = cudaMemsetAsync(rows_read, 0, sizeof(int), st);
  if (err != cudaSuccess || B == 0) return static_cast<int>(err);
  const int flat_x = (L.W + kFlatThreads * kFlatPer - 1) / (kFlatThreads * kFlatPer);
  for (int g0 = 0; g0 < B; g0 += L.G) {
    const int G = B - g0 < L.G ? B - g0 : L.G;
    if (n > 0 && (err = cudaMemsetAsync(counts, 0, sizeof(int) * static_cast<size_t>(n), st)) !=
                     cudaSuccess) {
      return static_cast<int>(err);
    }
    const dim3 flat(flat_x, G);
    verify_entries_kernel<false><<<flat, kFlatThreads, 0, st>>>(cand, counts, dist, entries, n,
                                                               Tc, L.W, g0);
    if (L.tiles > 0) {
      verify_tile_sum_kernel<<<L.tiles, kScanThreads, 0, st>>>(counts, tile_sum, n);
    }
    verify_tile_scan_kernel<<<1, 1024, 0, st>>>(tile_sum, L.tiles, starts, rows_used);
    if (L.tiles > 0) {
      verify_tile_write_kernel<<<L.tiles, kScanThreads, 0, st>>>(counts, tile_sum, rows,
                                                                  starts, n);
    }
    verify_entries_kernel<true><<<flat, kFlatThreads, 0, st>>>(cand, counts, dist, entries, n,
                                                              Tc, L.W, g0);
    switch (L.per) {
#define VERIFY_DIST(kPer)                                                                     \
  err = launch_dist<kPer>(data, q, rows, starts, entries, rows_used, dist, rows_read, d, L.dq, \
                          L.W, g0, G, st);                                                     \
  break
      case 1: VERIFY_DIST(1);
      case 2: VERIFY_DIST(2);
      case 4: VERIFY_DIST(4);
      case 8: VERIFY_DIST(8);
      case 16: VERIFY_DIST(16);
#undef VERIFY_DIST
      default:
        err = launch_wide(L.chunk, data, q, rows, starts, entries, rows_used, dist, rows_read, d,
                          L.W, g0, G, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return rt_topk_launch(dist, out_v, out_i, part, cand, Tc, B, L.W, k, L.S_cap, st);
}
