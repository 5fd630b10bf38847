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
// to the plain PyTorch version (ops/knn.py:_query_plain).
//
// What bounds it on an H100. The function must read the queries once, the
// fill count and the filled slots of each row they touch once (empty slots
// hold the 1e9 sentinel and change no output), write D, I and neighbor_num,
// and do 8 f32 operations per filled candidate (3 sub, 3 mul, 2 add). On
// the main path's maps most slots are empty, so the queries and the outputs
// dominate and bytes bound it, at a few microseconds a pool (chip_smoke.py's
// knn_bound computes it from each run's inputs). This simple design (one
// thread per query, the K best keys held sorted in registers by insertion)
// scans all M slots of its 27 rows, filled or not: 27*M float4 loads a
// query, ~2.8 GB for a mapping pool at M = 32, uncoalesced (neighbouring
// threads read different rows) and served mostly by L2, which holds the
// touched rows. That load traffic sets its time, far above the bound.
// Stopping each row at its cell_fill, then a warp per query with coalesced
// row reads or a block per cell sharing its rows in shared memory, is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStencil = 27;
constexpr uint32_t kP1 = 73856093u, kP2 = 19349669u, kP3 = 83492791u;
constexpr int32_t kIdxTag = 1 << 30;

// int32 wrap-around hash, computed in uint32 (no signed overflow)
__device__ __forceinline__ int32_t hash_cell(uint32_t x, uint32_t y,
                                             uint32_t z, uint32_t mask) {
  return (int32_t)(((x * kP1) ^ (y * kP2) ^ (z * kP3)) & mask);
}

template <int K>
__global__ void __launch_bounds__(128)
knn_select_kernel(const float4* __restrict__ cell_data,
                  const float* __restrict__ queries,
                  const float* __restrict__ radius, float radius_scalar,
                  const float* __restrict__ cell_size,
                  float* __restrict__ D, int32_t* __restrict__ I,
                  int32_t* __restrict__ nn, int Q, int table_size, int M,
                  int id_bits, int k) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const float qx = queries[3 * q], qy = queries[3 * q + 1],
              qz = queries[3 * q + 2];
  const float cs = __ldg(cell_size);
  // floor, not truncation; the float -> int conversion saturates like XLA's
  const uint32_t bx = (uint32_t)(int32_t)floorf(__fdiv_rn(qx, cs));
  const uint32_t by = (uint32_t)(int32_t)floorf(__fdiv_rn(qy, cs));
  const uint32_t bz = (uint32_t)(int32_t)floorf(__fdiv_rn(qz, cs));
  const uint32_t tmask = (uint32_t)(table_size - 1);

  // Stencil rows. h[t] holds either an original hash (< table_size) or the
  // overflow row; comparing against it is the same as comparing against
  // the original hashes, because the first probe of any repeated hash keeps
  // its original value.
  int32_t h[kStencil];
#pragma unroll
  for (int s = 0; s < kStencil; ++s) {
    const int32_t hs = hash_cell(bx + (uint32_t)(s / 9 - 1),
                                 by + (uint32_t)((s / 3) % 3 - 1),
                                 bz + (uint32_t)(s % 3 - 1), tmask);
    bool dup = false;
#pragma unroll
    for (int t = 0; t < s; ++t) dup |= (h[t] == hs);
    h[s] = dup ? table_size : hs;
  }

  const int32_t id_mask = (1 << id_bits) - 1;
  int32_t best_key[K];
  int32_t best_idx[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best_key[j] = 0x7fffffff;  // exhausted marker: decodes to NaN -> empty
    best_idx[j] = 0;
  }

  for (int s = 0; s < kStencil; ++s) {
    const float4* row = cell_data + (size_t)h[s] * (size_t)M;
    const int32_t id0 = s * M;
    for (int m = 0; m < M; ++m) {
      const float4 c = __ldg(row + m);
      const float dx = __fsub_rn(c.x, qx);
      const float dy = __fsub_rn(c.y, qy);
      const float dz = __fsub_rn(c.z, qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      int32_t key = (__float_as_int(d2) & ~id_mask) | (id0 + m);
      if (key < best_key[K - 1]) {
        int32_t idx = __float_as_int(c.w);
        // one bubble pass keeps best_key sorted ascending (static indices,
        // so the arrays stay in registers)
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (key < best_key[j]) {
            const int32_t tk = best_key[j], ti = best_idx[j];
            best_key[j] = key;
            best_idx[j] = idx;
            key = tk;
            idx = ti;
          }
        }
      }
    }
  }

  const float r = radius != nullptr ? radius[q] : radius_scalar;
  const float r2 = __fmul_rn(r, r);
  int32_t count = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {
      // D keeps the id bits set: an upper bound on the exact distance
      const float d = __int_as_float(best_key[j] | id_mask);
      const bool hit = d < 1e10f;  // false for empty slots and NaN
      const float dout = hit ? d : 1e10f;
      D[(size_t)q * k + j] = dout;
      I[(size_t)q * k + j] = hit ? (best_idx[j] & (kIdxTag - 1)) : 0;
      count += dout < r2 ? 1 : 0;
    }
  }
  nn[q] = count;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronize, allocates nothing, and returns cudaGetLastError() after the
// launch (0 on success). radius may be null: then radius_scalar applies to
// every query. cell_size is a device pointer to one float.
extern "C" int knn_select_launch(const void* cell_data, const void* queries,
                                 const void* radius, float radius_scalar,
                                 const void* cell_size, void* D, void* I,
                                 void* nn, int Q, int table_size, int M,
                                 int id_bits, int k, void* stream) {
  if (Q <= 0) return 0;
  if (k < 1 || k > 16 || M < 1 || id_bits < 1 || id_bits > 16 ||
      table_size < 1 || (table_size & (table_size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(128);
  const dim3 grid((unsigned)((Q + 127) / 128));
  cudaStream_t st = (cudaStream_t)stream;
  const float4* cd = (const float4*)cell_data;
  const float* qp = (const float*)queries;
  const float* rp = (const float*)radius;
  const float* csp = (const float*)cell_size;
  if (k <= 8) {
    knn_select_kernel<8><<<grid, block, 0, st>>>(
        cd, qp, rp, radius_scalar, csp, (float*)D, (int32_t*)I,
        (int32_t*)nn, Q, table_size, M, id_bits, k);
  } else {
    knn_select_kernel<16><<<grid, block, 0, st>>>(
        cd, qp, rp, radius_scalar, csp, (float*)D, (int32_t*)I,
        (int32_t*)nn, Q, table_size, M, id_bits, k);
  }
  return (int)cudaGetLastError();
}
