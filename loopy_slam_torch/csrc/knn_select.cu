// k-NN candidate selection over the spatial-hash grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_select_kernel` (loopy_slam_tpu/ops/knn.py:231,
// launched through `_select_topk` by pallas_call at knn.py:326) AND the XLA
// work `query` did around it (knn.py:382-411): for each query it computes
// the base cell floor(q / cell_size), the 27 stencil hashes in _OFFSETS27
// order, redirects a probe whose hash an earlier probe already had to the
// always-empty overflow row, reads the candidate rows straight from
// cell_data, keeps the k best packed keys, and writes the final D / I /
// neighbor_num of `query`. The (Q, 27*M*4) candidate temporary that the
// TPU path gathered into HBM never exists, so the caller needs no chunking.
//
// Key: (bits(d2) & ~id_mask) | (s*M + m), an int32 whose order equals the
// float order of d2 (d2 >= 0) with ties broken toward the lower candidate
// id, the same id the Pallas kernel derives from lane >> 2. d2 is summed as
// (dx*dx + dy*dy) + dz*dz with round-to-nearest intrinsics (and the file is
// built with -fmad=false), so every key is bit-equal to the TPU kernel's and
// to the plain PyTorch version (ops/knn.py:_query_plain). The low id bits
// make the keys of one query unique, so its k smallest keys are one set
// whatever order they are visited in: no tie rule is needed anywhere below.
//
// What bounds it on an H100. The function must read the queries, the fill
// count of each touched row and its filled slots, write D, I and
// neighbor_num, and do 8 f32 operations per filled candidate. On the main
// path's maps a query's 27 rows hold ~130-140 filled candidates, so bytes
// bound it (chip_smoke.py's knn_bound): a few microseconds a pool. The
// kernel is far from that. It is a gather whose every step (hash, fill,
// row walk, 16-byte load, distance, insertion, merge) is a short dependent
// chain, and it is bound by instruction throughput and latency, over the
// stencil set-up, the candidate scan and the merge (`chip_smoke.py
// --variants` times copies of this file with each of them cut out).
//
// What the design does:
// 1. Only filled slots are read. cell_fill[h] bounds row h's scan: build,
//    insert and the JAX grids fill a row contiguously from slot 0, and an
//    empty slot (the 1e9 sentinel) can never change an output of `query`
//    (d2 ~ 3e18 maps to D = 1e10, I = 0, the same output as the exhausted
//    key this kernel leaves when it skips the slot). That cuts the loads
//    about 6x at M = 32 and 27x at M = 128, and the time follows the
//    points, not the row depth. A repeated probe gets fill 0 and reads
//    nothing.
// 2. A group of G = 8 lanes per query (kGroup; 16 and 32 were slower at
//    every main-path shape, `chip_smoke.py --variants`). A thread per query
//    left a 30k-query tracking pool at 30k threads, about a tenth of the
//    card's thread slots, each walking its candidates alone; eight lanes
//    give 240k threads and eight loads in flight per query. ~140
//    candidates make ~18 passes of 8 lanes; wider groups leave more of the
//    last pass idle and repeat the set-up and merge on more lanes.
//    Set-up is warp-wide: for each of the warp's 32/G
//    queries, lane s < 27 hashes probe s and reads its fill, a cheap exact
//    test finds whether any two probes share a hash (see below), and a
//    ballot compacts the non-empty rows into shared memory. The group then
//    walks the filled candidates in flat order, lane j taking candidates
//    j, j+G, ...: neighbouring lanes read neighbouring 16-byte slots of a
//    row, and a lane keeps its current row in registers until it passes
//    it. Each lane keeps a sorted top-K of its own keys in registers,
//    updated without a branch (insert_sorted), and the group merges the
//    lanes' lists in k rounds of an xor-shuffle min over their heads
//    (__reduce_min_sync took longer, `chip_smoke.py --variants`).
// 3. Coalesced outputs: lane j writes rank j (and j + G, ...) of D and I;
//    the winners' index bits are re-read from cell_data by their candidate
//    id, so the lists hold keys only.
//
// It relies on L2 (50 MB) for the reuse between queries: cell_fill (0.5 MB
// at 131072 rows) and the rows a pool touches stay resident, and
// neighbouring queries (the samples of one ray) read the same rows. An L2
// flush before a launch costs it little (chip_smoke's cold and warm times).
//
// What Hopper offers and this kernel leaves out: wgmma has no matrix
// product to do here; TMA copies tiles, and these are gathers of ~5 slots
// of 16 bytes; sorting the queries by cell so that a block shares its rows
// in shared memory costs a 200k-key sort per pool, more than the kernel
// itself, and ray order already keeps a ray's samples in neighbouring
// queries (a later option, to be measured against that).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStencil = 27;
constexpr uint32_t kP1 = 73856093u, kP2 = 19349669u, kP3 = 83492791u;
constexpr int32_t kIdxTag = 1 << 30;
constexpr int32_t kExhausted = 0x7fffffff;  // decodes to NaN -> empty
constexpr int kBlock = 128;
constexpr int kGroup = 8;  // lanes per query, a power of two <= 32
constexpr unsigned kFull = 0xffffffffu;

// int32 wrap-around hash, computed in uint32 (no signed overflow)
__device__ __forceinline__ int32_t hash_cell(uint32_t x, uint32_t y,
                                             uint32_t z, uint32_t mask) {
  return (int32_t)(((x * kP1) ^ (y * kP2) ^ (z * kP3)) & mask);
}

// Inserts key into the ascending list best, dropping the largest: entry j
// becomes min(best[j], max(best[j-1], key)). Every entry is independent of
// the others (depth 2, no branch), unlike a bubble pass's chain of K swaps.
template <int K>
__device__ __forceinline__ void insert_sorted(int32_t (&best)[K],
                                              int32_t key) {
#pragma unroll
  for (int j = K - 1; j > 0; --j)
    best[j] = min(best[j], max(best[j - 1], key));
  best[0] = min(best[0], key);
}

// K: register list length (8 or 16, >= k)
template <int K>
__global__ void __launch_bounds__(kBlock)
knn_select_kernel(const float4* __restrict__ cell_data,
                  const int32_t* __restrict__ cell_fill,
                  const float* __restrict__ queries,
                  const float* __restrict__ radius, float radius_scalar,
                  const float* __restrict__ cell_size,
                  float* __restrict__ D, int32_t* __restrict__ I,
                  int32_t* __restrict__ nn, int Q, int table_size, int M,
                  int id_bits, int k) {
  constexpr int G = kGroup;
  constexpr int kGroups = kBlock / G;     // queries per block
  constexpr int kPerWarp = 32 / G;        // queries per warp
  constexpr int kOut = (K + G - 1) / G;   // output ranks per lane
  // per query: the row of each probe (for the winners' index bits), and
  // its non-empty rows in probe order, as (row, first candidate id << 16 |
  // fill); the first id is probe * M < 2^16, the fill <= M < 2^16
  __shared__ int32_t s_row[kGroups][kStencil];
  __shared__ int2 s_info[kGroups][kStencil];

  const int wlane = threadIdx.x & 31;
  const int lane = wlane & (G - 1);
  const int grp = threadIdx.x / G;
  const int q = blockIdx.x * kGroups + grp;
  // a group past the end computes on the last query and writes nothing, so
  // the whole warp stays in the warp-wide steps below
  const bool live = q < Q;
  const int qc = live ? q : Q - 1;
  const unsigned gmask =
      G == 32 ? kFull : (((1u << G) - 1u) << (wlane & ~(G - 1)));

  const float qx = __ldg(queries + 3 * qc), qy = __ldg(queries + 3 * qc + 1),
              qz = __ldg(queries + 3 * qc + 2);
  const float cs = __ldg(cell_size);
  // floor, not truncation; the float -> int conversion saturates like XLA's
  const uint32_t bx = (uint32_t)(int32_t)floorf(__fdiv_rn(qx, cs));
  const uint32_t by = (uint32_t)(int32_t)floorf(__fdiv_rn(qy, cs));
  const uint32_t bz = (uint32_t)(int32_t)floorf(__fdiv_rn(qz, cs));
  const uint32_t tmask = (uint32_t)(table_size - 1);

  // Stencil rows and fills, one query of the warp at a time: lane s < 27
  // hashes probe s; a probe whose hash a lower lane (an earlier probe)
  // also has is redirected to the overflow row with fill 0.
  //
  // __match_any_sync finds the repeats, but on every query it made the
  // tracking pools about 6% slower (`chip_smoke.py --variants`), so an
  // exact and cheap test runs first. With
  // X_i = ((b_x + i - 1) * P1) & mask (Y, Z alike; the mask distributes
  // over xor), probe (i, j, l) hashes to X_i ^ Y_j ^ Z_l, and two probes
  // collide iff the xor of their per-axis differences is 0. Each axis has
  // three differences X_i ^ X_i' (i < i'); lane L < 27 takes difference
  // a, b, c = the base-3 digits of L on the three axes and tests them
  // alone, in pairs and all three together, so the lanes cover every
  // combination. Only a warp with a real repeat (rare in a table much
  // larger than 27^2 rows) pays for the match.
  const int sx = wlane / 9 - 1, sy = (wlane / 3) % 3 - 1, sz = wlane % 3 - 1;
  // difference d of an axis is between offsets lo(d) < hi(d) in {-1,0,1}
  const uint32_t lox = sx == 1 ? 0u : ~0u, hix = sx == -1 ? 0u : 1u;
  const uint32_t loy = sy == 1 ? 0u : ~0u, hiy = sy == -1 ? 0u : 1u;
  const uint32_t loz = sz == 1 ? 0u : ~0u, hiz = sz == -1 ? 0u : 1u;
  int32_t total = 0;  // filled candidates of this lane's query
#pragma unroll
  for (int g = 0; g < kPerWarp; ++g) {
    const uint32_t gx = __shfl_sync(kFull, bx, g * G);
    const uint32_t gy = __shfl_sync(kFull, by, g * G);
    const uint32_t gz = __shfl_sync(kFull, bz, g * G);
    int32_t h = -1 - wlane;  // lanes past the stencil: unique non-hashes
    if (wlane < kStencil)
      h = hash_cell(gx + (uint32_t)sx, gy + (uint32_t)sy, gz + (uint32_t)sz,
                    tmask);
    const uint32_t dx = (((gx + lox) * kP1) ^ ((gx + hix) * kP1)) & tmask;
    const uint32_t dy = (((gy + loy) * kP2) ^ ((gy + hiy) * kP2)) & tmask;
    const uint32_t dz = (((gz + loz) * kP3) ^ ((gz + hiz) * kP3)) & tmask;
    const bool repeat = wlane < kStencil &&
        (dx == 0 || dy == 0 || dz == 0 || dx == dy || dx == dz || dy == dz ||
         dx == (dy ^ dz));
    const unsigned same = __any_sync(kFull, repeat)
                              ? __match_any_sync(kFull, h)
                              : 1u << wlane;
    const bool dup = (same & ((1u << wlane) - 1u)) != 0;
    int32_t f = 0;
    if (wlane < kStencil && !dup) f = min(max(__ldg(cell_fill + h), 0), M);
    // compact the non-empty rows: a ballot gives each its position
    const unsigned filled = __ballot_sync(kFull, f > 0);
    const int gb = (threadIdx.x & ~31) / G + g;  // block-level group
    if (wlane < kStencil) s_row[gb][wlane] = dup ? table_size : h;
    if (f > 0)
      s_info[gb][__popc(filled & ((1u << wlane) - 1u))] =
          make_int2(h, (int)(((uint32_t)(wlane * M) << 16) | (uint32_t)f));
    const int32_t sum = __reduce_add_sync(kFull, f);
    if (wlane / G == g) total = sum;
  }
  __syncwarp();

  const int32_t id_mask = (1 << id_bits) - 1;
  int32_t best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = kExhausted;
  // The filled candidates in flat order, G lanes abreast: lane j takes
  // flat candidates j, j + G, ... The row it is in stays in registers
  // (its slots, first id, and flat range [start, end)) until c passes it.
  const int2* info = s_info[grp];
  int2 inf = info[0];  // not read below when total == 0
  int r = 0, start = 0, end = inf.y & 0xffff;
  const float4* row = cell_data + (size_t)inf.x * (size_t)M;
  int id0 = (unsigned)inf.y >> 16;
  for (int c = lane; c < total; c += G) {
    if (c >= end) {
      do {
        inf = info[++r];
        start = end;
        end += inf.y & 0xffff;
      } while (c >= end);
      row = cell_data + (size_t)inf.x * (size_t)M;
      id0 = (unsigned)inf.y >> 16;
    }
    {
      const int m = c - start;
      const float4 p = __ldg(row + m);
      const int32_t id = id0 + m;
      const float dx = __fsub_rn(p.x, qx);
      const float dy = __fsub_rn(p.y, qy);
      const float dz = __fsub_rn(p.z, qz);
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      int32_t key = (__float_as_int(d2) & ~id_mask) | id;
      insert_sorted<K>(best, key);
    }
  }

  // Merge: rank r is the least head over the group's lanes; the lane that
  // held it pops (keys are unique, so one lane at most, unless exhausted).
  int32_t out[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) out[o] = kExhausted;
#pragma unroll
  for (int rank = 0; rank < K; ++rank) {
    if (rank < k) {
      int32_t least = best[0];
#pragma unroll
      for (int o = G / 2; o > 0; o /= 2)
        least = min(least, __shfl_xor_sync(gmask, least, o, G));
      if (best[0] == least) {
#pragma unroll
        for (int j = 0; j + 1 < K; ++j) best[j] = best[j + 1];
        best[K - 1] = kExhausted;
      }
      if (lane == rank % G) out[rank / G] = least;
    }
  }

  const float rq = radius != nullptr ? __ldg(radius + qc) : radius_scalar;
  const float r2 = __fmul_rn(rq, rq);
  int32_t count = 0;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int j = o * G + lane;
    if (j < k) {
      // D keeps the id bits set: an upper bound on the exact distance
      const float d = __int_as_float(out[o] | id_mask);
      const bool hit = d < 1e10f;  // false for exhausted keys and NaN
      int32_t idx = 0;
      if (hit) {
        const int32_t id = out[o] & id_mask;
        const int probe = id / M;
        const float* slot = reinterpret_cast<const float*>(
            cell_data + (size_t)s_row[grp][probe] * (size_t)M +
            (id - probe * M));
        idx = __float_as_int(__ldg(slot + 3)) & (kIdxTag - 1);
      }
      const float dout = hit ? d : 1e10f;
      if (live) {
        D[(size_t)q * k + j] = dout;
        I[(size_t)q * k + j] = idx;
      }
      count += dout < r2 ? 1 : 0;
    }
  }
  count = __reduce_add_sync(gmask, count);
  if (live && lane == 0) nn[q] = count;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronize, allocates nothing, and returns cudaGetLastError() after the
// launch (0 on success). cell_fill is the grid's (table_size + 1,) int32
// fill counts. radius may be null: then radius_scalar applies to every
// query. cell_size is a device pointer to one float.
extern "C" int knn_select_launch(const void* cell_data, const void* cell_fill,
                                 const void* queries, const void* radius,
                                 float radius_scalar, const void* cell_size,
                                 void* D, void* I, void* nn, int Q,
                                 int table_size, int M, int id_bits, int k,
                                 void* stream) {
  if (Q <= 0) return 0;
  if (k < 1 || k > 16 || M < 1 || id_bits < 1 || id_bits > 16 ||
      table_size < 1 || (table_size & (table_size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int kGroups = kBlock / kGroup;  // queries per block
  const dim3 grid((unsigned)((Q + kGroups - 1) / kGroups));
  cudaStream_t st = (cudaStream_t)stream;
  const float4* cd = (const float4*)cell_data;
  const int32_t* fp = (const int32_t*)cell_fill;
  const float* qp = (const float*)queries;
  const float* rp = (const float*)radius;
  const float* csp = (const float*)cell_size;
  if (k <= 8) {
    knn_select_kernel<8><<<grid, kBlock, 0, st>>>(
        cd, fp, qp, rp, radius_scalar, csp, (float*)D, (int32_t*)I,
        (int32_t*)nn, Q, table_size, M, id_bits, k);
  } else {
    knn_select_kernel<16><<<grid, kBlock, 0, st>>>(
        cd, fp, qp, rp, radius_scalar, csp, (float*)D, (int32_t*)I,
        (int32_t*)nn, Q, table_size, M, id_bits, k);
  }
  return (int)cudaGetLastError();
}
