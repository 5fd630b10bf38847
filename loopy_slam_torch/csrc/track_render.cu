// The tracker's render step on its k-NN pool, for Hopper (sm_90a): one
// forward kernel that decodes and composites a pixel batch, and one
// backward kernel that carries the rays' depth and colour gradients back
// to the sample points.
//
// Replaces no TPU kernel. The JAX package leaves this step to XLA, which
// fuses it; the port ran it as ~540 eager PyTorch launches an iteration
// (models/renderer.decode_neighbors + ops/compositing.composite, forward
// and backward to the points), and the card sat idle ~93% of a tracking
// iteration waiting on the host. It was added for host dispatch: two
// launches replace those ~540, and neither reads a device value on the host
// (the plain route's cumprod backward does, and a scalar radius was copied
// to the device a call). models/track_render.py binds them as one
// torch.autograd.Function; its plain version is the composition above.
//
// What the kernels compute, per sample (c = 32, k neighbours):
//   squared distances from the gathered neighbour positions, the empty-slot
//   marker (1e4), inverse-distance weights under the radius mask,
//   has_neighbors = nn >= min_nn_num;
//   geometry: feature interpolation (0.01 * noise where starved), the
//   Fourier embedding sin(2pi p B) (phase summed (t0 + t1) + t2 in f32),
//   the ReLU trunk 93 -> 32 x 5 with fc_c injections and the skip after
//   block 2, the scalar head, -100 where starved;
//   colour: with encode_rel_pos_in_col, per neighbour the rel-pos transform
//   [fourier(rel) || feat] 52 -> 128 -> softplus100 -> 32, then the
//   interpolation; the trunk 40 -> 128 x 5 with softplus100 in the
//   logaddexp form, fc_c, skip; the 3-channel head, soft clamp, sigmoid;
//   per ray: occupancy compositing with its cumulative transmittance.
//
// Numerics: the kernels give the plain version's numbers on the card bit
// for bit (depth, variance, colour and the points' gradient). They have to:
// with bf16 trunks (the default) every trunk input is rounded to bf16, and
// autograd rounds the gradient of each to bf16 too (the backward of
// x.bfloat16().float()). A sum taken in another order lands, now and then,
// on the other side of a rounding boundary and moves a value by a bf16 step
// (2^-8); done a first time this way, the points' gradient came out ~3e-4
// apart from the plain version's (as far as the plain version's own, on the
// CPU, is from it on the card), and the pose gradient ~1e-3 apart, the
// benchmark's whole limit. So every value that feeds a rounding is summed
// as the plain version sums it, as measured on the card:
//   * matrix products as cuBLAS's: products of bf16-rounded operands, added
//     by f32 FMA in order of the inner index from 0 (fmaf, with the library
//     built with -fmad=false so nothing else is fused), then the bias; the
//     (n, 32) x (32, 1) head as its gemv: two halves of 16 apart, then added;
//   * torch's reductions: a sum over the innermost dimension as the reduce
//     kernel's min(last_pow2(n), 32) lanes with four accumulators each and
//     a shuffle tree at halving offsets (torch_inner_sum); over an outer
//     dimension as one thread's four accumulators (torch_strided_sum);
//     cumprod and cumsum as the innermost scan's up- and down-sweep over
//     2 x 16 slots (torch_scan);
//   * torch's elementwise forms: a division by a Python scalar multiplies by
//     its reciprocal (softplus100's / 100, the soft clamp's / 12), 1 / x is
//     a reciprocal, and each backward is autograd's formula op by op (a
//     divisor's gradient -g * ((a / b) / b), the cumprod's reversed cumsum
//     of output * grad over its input, ...), gradients from several uses
//     added in the order autograd adds them.
// No atomics: every output has one writer and every sum a fixed order, so
// the same inputs give the same outputs bit for bit, run after run.
//
// What bounds it on an H100. ~224 kFLOP a sample forward (~397 k with the
// rel-pos transform's k = 8 neighbours), about as much again backward: a
// few GFLOP an iteration, all small matrix products (widths 32-168) over
// 64-sample tiles: f32 FMA issue, not bytes (the pool rows a batch reads
// are a few MB).
//
// What the design does about it:
// 1. A block holds whole rays (64 / S of them, 64 sample slots), so the
//    compositing and its backward need nothing from another block.
// 2. Activations live in shared memory feature-major (a row a feature,
//    the 64 slots contiguous), each layer's weights are staged into shared
//    memory (rounded on the way), and each thread keeps a 4 x 8 (or 2 x 4)
//    register tile of the layer's output: one 16-byte load of
//    activations and two of weights feed 32 FMAs, each output's sum in
//    cuBLAS's order.
// 3. The forward keeps what the backward needs in a per-block workspace
//    (the trunks' and the transform's pre-activations, the transformed
//    neighbour features, the raw and final colours, the occupancies):
//    ~0.5 MB a block with the rel-pos transform. Reading it back costs
//    less than recomputing the forward, and the backward then runs the
//    trunks once, in reverse, on the same tiles.
// 4. The backward's products against W^T read the weights as staged
//    (row = input feature, stride out + 1, so neighbouring threads hit
//    neighbouring banks).
//
// Left out: tensor cores. mma.sync / wgmma would take the bf16 products at
// many times the FMA rate, but they add in their own order and precision,
// which would bring back the bf16 rounding gaps above.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads a block
constexpr int TS = 64;         // sample slots a block
constexpr int MAX_S = 31;      // samples a ray: the compositing scans S + 1
                               // values in 32 slots (torch_scan, cp[32])
constexpr int LDA = TS + 4;    // row stride of the feature-major tiles
constexpr int C = 32;          // feature width (model.c_dim)
constexpr int GE = 93;         // geometry embedding
constexpr int GHD = 32;        // geometry hidden
constexpr int CE = 20;         // colour embedding (sin || cos: 40)
constexpr int CHD = 128;       // colour hidden
constexpr int RE = 10;         // rel-pos embedding (sin || cos: 20)
constexpr int NX = 2 * RE + C; // rel-pos transform input (52)
constexpr int FB = 2 * C + 3;  // floats a pool row: geo || colour || xyz
constexpr float TWO_PI = 6.283185307179586f;

// the decoders' parameters, in models/track_render._weights' order
constexpr int W_GB = 0;
__device__ __forceinline__ constexpr int W_GLW(int i) { return 1 + 2 * i; }
__device__ __forceinline__ constexpr int W_GLB(int i) { return 2 + 2 * i; }
__device__ __forceinline__ constexpr int W_GFW(int i) { return 11 + 2 * i; }
__device__ __forceinline__ constexpr int W_GFB(int i) { return 12 + 2 * i; }
constexpr int W_GOW = 21, W_GOB = 22, W_CB = 23, W_CBR = 24;
__device__ __forceinline__ constexpr int W_CLW(int i) { return 25 + 2 * i; }
__device__ __forceinline__ constexpr int W_CLB(int i) { return 26 + 2 * i; }
__device__ __forceinline__ constexpr int W_CFW(int i) { return 35 + 2 * i; }
__device__ __forceinline__ constexpr int W_CFB(int i) { return 36 + 2 * i; }
constexpr int W_COW = 45, W_COB = 46, W_NW1 = 47, W_NB1 = 48, W_NW2 = 49,
              W_NB2 = 50, NW = 51;

struct Weights {
  const float* p[NW];
};

struct Params {
  const float* pts;      // (R*S, 3)
  const int64_t* pick;   // (R,) pool rows
  const float* D;        // (P, S*K) index distances (>= 1e9: empty slot)
  const float* both;     // (P, S*K, FB) gathered rows
  const int* nn;         // (P, S) neighbour counts
  const float* z;        // (R, S) z-vals
  const float* rq;       // (P,) query radii, or null for rq_scalar
  float rq_scalar;
  const float* noise_g;  // (R*S, C)
  const float* noise_c;  // (R*S, C)
  float* depth;          // (R,)
  float* var;            // (R,)
  float* color;          // (R, 3)
  const float* gd;       // (R,) strided, or null
  long gd_s;
  const float* gc;       // (R, 3) strided, or null
  long gc_s0, gc_s1;
  float* gpts;           // (R*S, 3)
  float* save;           // the forward's workspace, save_floats a block
  long save_block;
  int R, S, K, min_nn, rel, bfg, bfc;
  float coef;
};

// workspace offsets, per block (floats)
constexpr long OFF_OCC = 0;
constexpr long OFF_RGB = TS;
constexpr long OFF_LOG = 4 * TS;
constexpr long OFF_GPRE = 7 * TS;
constexpr long OFF_CPRE = OFF_GPRE + 5L * GHD * TS;
constexpr long OFF_NPRE = OFF_CPRE + 5L * CHD * TS;
__device__ __forceinline__
long off_nout(int K) { return OFF_NPRE + (long)K * CHD * TS; }
long save_floats(int K, int rel) {
  return OFF_NPRE + (rel ? (long)K * (CHD + C) * TS : 0);
}

// the per-slot arrays both kernels share, after the tiles
struct Small {
  float *P, *Dif, *Wt, *R2, *Occ, *Rgb, *Gocc, *Grgb, *Glog, *Gpts, *Gw,
      *Al, *Ex, *Tr, *Ws, *GpG, *GpC;
  int *Has, *NE, *Row;
};
long small_floats(int K) { return (long)(28 + 5 * K) * TS; }
__device__ __forceinline__ Small carve(float* s, int K) {
  Small m;
  m.P = s; s += 3 * TS;
  m.Dif = s; s += 3 * K * TS;
  m.Wt = s; s += K * TS;
  m.R2 = s; s += TS;
  m.Occ = s; s += TS;
  m.Rgb = s; s += 3 * TS;
  m.Gocc = s; s += TS;
  m.Grgb = s; s += 3 * TS;
  m.Glog = m.Grgb;  // the colour-logit gradient overwrites the colour's
  m.Gpts = s; s += 3 * TS;
  m.Gw = s; s += K * TS;
  m.Al = s; s += TS;
  m.Ex = s; s += TS;
  m.Tr = s; s += TS;
  m.Ws = s; s += TS;
  m.GpG = s; s += 3 * TS;
  m.GpC = s; s += 3 * TS;
  m.Has = reinterpret_cast<int*>(s); s += TS;
  m.NE = reinterpret_cast<int*>(s); s += TS;
  m.Row = reinterpret_cast<int*>(s);
  return m;
}
constexpr long FWD_TILES = (long)(NX + CHD + C) * LDA + 168L * CHD + C * CHD;
constexpr long BWD_TILES =
    (long)(CHD + CHD + GE + C + C) * LDA + 128L * (CHD + 1) + C * (CHD + 1);

// torch's .bfloat16(): round to nearest even
__device__ __forceinline__ float bf16r(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return x;
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__
float rnd(float x, int on) { return on ? bf16r(x) : x; }

// torch's CUDA sum over a contiguous run of n values (x[i * stride]): the
// reduce kernel gives it min(last_pow2(n), 32) lanes, lane t adds its
// values t, t + bw, ... from 0 into four accumulators in turn and adds
// those up, and the lanes combine by shuffles at halving offsets.
__device__ __forceinline__
float torch_inner_sum(const float* x, int n, int stride) {
  int bw = 1;
  while (bw * 2 <= n && bw < 32) bw *= 2;
  float v[32];
  for (int t = 0; t < bw; ++t) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int i = 0;
    for (int e = t; e < n; e += bw, ++i) a[i & 3] = a[i & 3] + x[e * stride];
    v[t] = ((a[0] + a[1]) + a[2]) + a[3];
  }
  for (int o = bw / 2; o >= 1; o /= 2)
    for (int t = 0; t < o; ++t) v[t] = v[t] + v[t + o];
  return v[0];
}

// torch's CUDA sum over a strided (not innermost) dimension: one thread
// walks the n values into four accumulators in turn and adds those up.
__device__ __forceinline__
float torch_strided_sum(const float* x, int n, int stride) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int e = 0; e < n; ++e) a[e & 3] = a[e & 3] + x[e * stride];
  return ((a[0] + a[1]) + a[2]) + a[3];
}

// torch's CUDA inclusive scan (cumprod, cumsum) of a row of up to 32
// values, in place: the innermost-dimension scan kernel's up-sweep and
// down-sweep over 2 x 16 slots, the tail padded with the identity.
__device__ __forceinline__ void torch_scan(float* buf, int n, bool mul) {
  for (int i = n; i < 32; ++i) buf[i] = mul ? 1.0f : 0.0f;
  for (int s = 16, d = 1; s >= 1; s >>= 1, d <<= 1)
    for (int t = 0; t < s; ++t) {
      const int off = (2 * t + 1) * d - 1;
      buf[off + d] = mul ? buf[off] * buf[off + d] : buf[off] + buf[off + d];
    }
  for (int s = 2, d = 8; d >= 1; s <<= 1, d >>= 1)
    for (int t = 0; t < s - 1; ++t) {
      const int off = 2 * (t + 1) * d - 1;
      buf[off + d] = mul ? buf[off] * buf[off + d] : buf[off] + buf[off + d];
    }
}

__device__ __forceinline__ float sgnf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// A division by a Python scalar on the card multiplies by its reciprocal.
constexpr float INV100 = 1.0f / 100.0f;
constexpr float INV12 = 1.0f / 12.0f;

// softplus(beta=100) as decoder.softplus100: logaddexp(0, 100x) / 100
__device__ __forceinline__ float softplus100(float x) {
  const float y = 100.0f * x;
  const float m = fmaxf(0.0f, y);
  return (m + log1pf(expf(-fabsf(0.0f - y)))) * INV100;
}
// its backward, as autograd takes it: g / 100 / (1 + exp(0 - 100x)) * 100
__device__ __forceinline__ float softplus100_back(float g, float x) {
  return ((g * INV100) / (1.0f + expf(0.0f - 100.0f * x))) * 100.0f;
}
__device__ __forceinline__
float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }
// renderer.soft_clamp_logits
__device__ __forceinline__ float soft_clamp(float x) {
  const float a = fabsf(x);
  if (a <= 24.0f) return x / (1.0f + a * INV12);
  const float e = fmaxf(a - 24.0f, 0.0f);
  const float dec = (24.0f * e) / (e + 216.0f);
  return sgnf(x) * (8.0f - dec);
}
// the gradient of the logit x from g, the soft clamp's output gradient:
// autograd's op by op (torch.where sends g down one branch; a division's
// divisor takes -g * ((num / den) / den))
__device__ __forceinline__ float soft_clamp_back(float g, float x) {
  const float a = fabsf(x);
  if (a <= 24.0f) {
    const float den = 1.0f + a * INV12;
    const float gx = g / den;
    const float gden = -g * ((x / den) / den);
    return gx + (gden * INV12) * sgnf(x);
  }
  const float ex = fmaxf(a - 24.0f, 0.0f);
  const float num = 24.0f * ex, den = ex + 216.0f;
  const float gdec = -(g * sgnf(x));
  const float gex = (-gdec * ((num / den) / den)) + (gdec / den) * 24.0f;
  return gex * sgnf(x);
}

// The Fourier phase of point q with B (3, ne), column e: (t0 + t1) + t2,
// t_d = (2pi q_d) B_de, as decoder.fourier_embed.
__device__ __forceinline__
float phase(const float* q, const float* B, int ne, int e) {
  const float t0 = (TWO_PI * q[0]) * B[e];
  const float t1 = (TWO_PI * q[1]) * B[ne + e];
  const float t2 = (TWO_PI * q[2]) * B[2 * ne + e];
  return (t0 + t1) + t2;
}

// Rows [0, ne) of dst = sin of the phases of the slots' points (q at
// Q + t * qs), and rows [ne, 2 ne) their cosines when asked.
__device__ __forceinline__
void embed(const float* Q, int qs, const float* B, int ne, bool cosines,
           float* dst, int bf) {
  for (int idx = (int)threadIdx.x; idx < ne * TS; idx += NT) {
    const int e = idx / TS, t = idx - e * TS;
    const float x = phase(Q + t * qs, B, ne, e);
    dst[e * LDA + t] = rnd(sinf(x), bf);
    if (cosines) dst[(ne + e) * LDA + t] = rnd(cosf(x), bf);
  }
}

// The embedding's backward for one slot: gq[d] = (sum_e g_x[e] B[d][e]) 2pi
// with g_x = gE[e] cos(x) (and - gE[ne + e] sin(x) with cosines), the sum
// over e in torch's order (gE: the slot's column of a feature-major tile).
__device__ __forceinline__
void embed_back(const float* q, const float* B, int ne, bool cosines,
                const float* gE, float* gq) {
  float gx[96], pr[96];
  for (int e = 0; e < ne; ++e) {
    const float x = phase(q, B, ne, e);
    float g = gE[e * LDA] * cosf(x);
    if (cosines) g = gE[(ne + e) * LDA] * (-sinf(x)) + g;
    gx[e] = g;
  }
  for (int d = 0; d < 3; ++d) {
    for (int e = 0; e < ne; ++e) pr[e] = gx[e] * B[d * ne + e];
    gq[d] = torch_inner_sum(pr, ne, 1) * TWO_PI;
  }
}

// dst[k * ldd + o] = rows k0 .. k0 + nk of W (row-major, N columns),
// rounded; rows nk .. npad zero.
__device__ __forceinline__
void stage(float* dst, int ldd, const float* W, int N, int k0, int nk,
           int npad, int bf) {
  for (int idx = (int)threadIdx.x; idx < npad * N; idx += NT) {
    const int k = idx / N, o = idx - k * N;
    dst[k * ldd + o] = k < nk ? rnd(W[(long)(k0 + k) * N + o], bf) : 0.0f;
  }
}

// acc[m][4h + j] += sum_k A[k][ty TM + m] W[k][tx 4 + h 4 NTX + j]:
// a layer's product, A feature-major (stride LDA), W staged (stride ldw).
template <int TM, int NTX, int TN4>
__device__ __forceinline__
void gemm(const float* A, const float* W, int K, int ldw,
          float (&acc)[TM][4 * TN4]) {
  const int tid = threadIdx.x;
  const int ty = tid / NTX, tx = tid - ty * NTX;
  const float* a = A + ty * TM;
  const float* w = W + tx * 4;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[TM];
    if constexpr (TM == 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + k * LDA);
      av[0] = v.x; av[1] = v.y; av[2] = v.z; av[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(a + k * LDA);
      av[0] = v.x; av[1] = v.y;
    }
#pragma unroll
    for (int h = 0; h < TN4; ++h) {
      const float4 wv =
          *reinterpret_cast<const float4*>(w + k * ldw + h * 4 * NTX);
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        acc[m][4 * h + 0] = fmaf(av[m], wv.x, acc[m][4 * h + 0]);
        acc[m][4 * h + 1] = fmaf(av[m], wv.y, acc[m][4 * h + 1]);
        acc[m][4 * h + 2] = fmaf(av[m], wv.z, acc[m][4 * h + 2]);
        acc[m][4 * h + 3] = fmaf(av[m], wv.w, acc[m][4 * h + 3]);
      }
    }
  }
}

// acc[m][j] += sum_k G[k][ty 4 + m] W[tx + 16 j][k]: a gradient against
// W^T, G feature-major (stride LDA), W staged by input row (stride ldw).
template <int TNJ>
__device__ __forceinline__
void gemm_t(const float* G, const float* W, int K, int ldw,
            float (&acc)[4][TNJ]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* g = G + ty * 4;
  const float* w = W + tx * ldw;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(g + k * LDA);
#pragma unroll
    for (int j = 0; j < TNJ; ++j) {
      const float wv = w[j * 16 * ldw + k];
      acc[0][j] = fmaf(v.x, wv, acc[0][j]);
      acc[1][j] = fmaf(v.y, wv, acc[1][j]);
      acc[2][j] = fmaf(v.z, wv, acc[2][j]);
      acc[3][j] = fmaf(v.w, wv, acc[3][j]);
    }
  }
}

// Per-slot set-up of both kernels: the slot's pool row and point, its
// neighbours' offsets (neighbour - point), the interpolation weights,
// has_neighbors, the radius^2 and the non-empty slots (bits).
__device__ __forceinline__
void setup_slots(const Params& p, const Small& m, int r0, int nt) {
  const int t = (int)threadIdx.x;
  if (t >= TS) return;
  const int K = p.K, S = p.S;
  float* dif = m.Dif + t * K * 3;
  float* wt = m.Wt + t * K;
  if (t >= nt) {
    for (int k = 0; k < 3 * K; ++k) dif[k] = 0.0f;
    for (int k = 0; k < K; ++k) wt[k] = 0.0f;
    m.P[3 * t] = m.P[3 * t + 1] = m.P[3 * t + 2] = 0.0f;
    m.Has[t] = 0; m.NE[t] = 0; m.Row[t] = 0; m.R2[t] = 0.0f;
    return;
  }
  const int r = r0 + t / S, s = t % S;
  const long gi = (long)r * S + s;
  const long row = p.pick[r];
  const float px = p.pts[3 * gi], py = p.pts[3 * gi + 1],
              pz = p.pts[3 * gi + 2];
  const float rq = p.rq ? p.rq[row] : p.rq_scalar;
  const float r2 = rq * rq;
  const long base = (row * S + s) * K;
  float aw[16];
  int ne = 0;
  for (int k = 0; k < K; ++k) {
    const float* nb = p.both + (base + k) * FB + 2 * C;
    const float dx = nb[0] - px, dy = nb[1] - py, dz = nb[2] - pz;
    dif[3 * k] = dx; dif[3 * k + 1] = dy; dif[3 * k + 2] = dz;
    float d2 = (dx * dx + dz * dz) + dy * dy;  // torch's sum of three
    if (p.D[base + k] < 1e9f) ne |= 1 << k;
    else d2 = 1e4f;
    const float wr = 1.0f / (d2 + 1e-10f);
    const float wm = wr * (d2 <= r2 ? 1.0f : 0.0f);
    wt[k] = wm;
    aw[k] = fabsf(wm);
  }
  const float den = torch_inner_sum(aw, K, 1) + 1e-12f;
  for (int k = 0; k < K; ++k) wt[k] = wt[k] / den;
  m.P[3 * t] = px; m.P[3 * t + 1] = py; m.P[3 * t + 2] = pz;
  m.Has[t] = p.nn[row * S + s] >= p.min_nn;
  m.NE[t] = ne; m.Row[t] = (int)row; m.R2[t] = r2;
}

// dst (C rows, feature-major) = the interpolated features at lane `off`
// of the pool rows (0: geometry, C: colour), or 0.01 * noise where starved.
__device__ __forceinline__
void interp(const Params& p, const Small& m, int r0, int nt, int off,
            const float* noise, float* dst, int bf) {
  const int K = p.K, S = p.S;
  for (int idx = (int)threadIdx.x; idx < TS * C; idx += NT) {
    const int t = idx / C, ch = idx - t * C;
    float v = 0.0f;
    if (t < nt) {
      const int s = t % S;
      if (m.Has[t]) {
        const float* row =
            p.both + ((long)m.Row[t] * S + s) * K * FB + off + ch;
        const float* w = m.Wt + t * K;
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = 0; k < K; ++k) a[k & 3] = a[k & 3] + w[k] * row[k * FB];
        v = ((a[0] + a[1]) + a[2]) + a[3];
      } else {
        v = 0.01f * noise[((long)(r0 + t / S) * S + s) * C + ch];
      }
    }
    dst[ch * LDA + t] = rnd(v, bf);
  }
}

// weights_s = alpha_s T_s (T: the cumulative product of 1 - alpha + 1e-10)
// of a ray's samples into m.Ws, with alpha into m.Al, exp(-coef occ) into
// m.Ex and the cumulative product (S + 1 values, 1 first) into cp.
__device__ __forceinline__
void ray_weights(const Params& p, const Small& m, const float* occ,
                 int t0, float* cp) {
  const int S = p.S;
  const float nco = -p.coef;
  cp[0] = 1.0f;
  for (int s = 0; s < S; ++s) {
    const float e = expf(nco * occ[t0 + s]);
    const float alpha = 1.0f / (1.0f + e);
    m.Al[t0 + s] = alpha;
    m.Ex[t0 + s] = e;
    cp[s + 1] = (1.0f - alpha) + 1e-10f;
  }
  torch_scan(cp, S + 1, true);
  for (int s = 0; s < S; ++s) m.Ws[t0 + s] = m.Al[t0 + s] * cp[s];
}

__device__ __forceinline__
void composite_ray(const Params& p, const Small& m, int r0, int ray) {
  const int S = p.S, r = r0 + ray, t0 = ray * S;
  const float* z = p.z + (long)r * S;
  float cp[32], pr[32];
  ray_weights(p, m, m.Occ, t0, cp);
  const float ws = torch_inner_sum(m.Ws + t0, S, 1) + 1e-10f;
  for (int c = 0; c < 3; ++c) {
    for (int s = 0; s < S; ++s) pr[s] = m.Ws[t0 + s] * m.Rgb[c * TS + t0 + s];
    p.color[3L * r + c] = torch_strided_sum(pr, S, 1) / ws;
  }
  for (int s = 0; s < S; ++s) pr[s] = m.Ws[t0 + s] * z[s];
  const float depth = torch_inner_sum(pr, S, 1) / ws;
  for (int s = 0; s < S; ++s) {
    const float dv = z[s] - depth;
    pr[s] = (m.Ws[t0 + s] * dv) * dv;
  }
  p.depth[r] = depth;
  p.var[r] = torch_inner_sum(pr, S, 1);
}

// The compositing's backward for one ray, as autograd runs it: the
// colours' gradient into m.Grgb and the occupancies' into m.Gocc.
__device__ __forceinline__
void composite_ray_back(const Params& p, const Small& m,
                        const float* save, int r0, int ray) {
  const int S = p.S, r = r0 + ray, t0 = ray * S;
  const float* z = p.z + (long)r * S;
  const float gd = p.gd ? p.gd[r * p.gd_s] : 0.0f;
  float gc[3] = {0.0f, 0.0f, 0.0f};
  if (p.gc)
    for (int c = 0; c < 3; ++c) gc[c] = p.gc[r * p.gc_s0 + c * p.gc_s1];
  float cp[32], pr[32], num[3], t3[3];
  ray_weights(p, m, save + OFF_OCC, t0, cp);
  const float* rgb = save + OFF_RGB;
  const float ws = torch_inner_sum(m.Ws + t0, S, 1) + 1e-10f;
  for (int c = 0; c < 3; ++c) {
    for (int s = 0; s < S; ++s) pr[s] = m.Ws[t0 + s] * rgb[c * TS + t0 + s];
    num[c] = torch_strided_sum(pr, S, 1);
  }
  for (int s = 0; s < S; ++s) pr[s] = m.Ws[t0 + s] * z[s];
  const float numd = torch_inner_sum(pr, S, 1);
  // depth = numd / ws, colour = num / ws (ws broadcast over the channels)
  const float gnd = gd / ws;
  const float gwa = -gd * ((numd / ws) / ws);
  float gnc[3];
  for (int c = 0; c < 3; ++c) {
    gnc[c] = gc[c] / ws;
    t3[c] = -gc[c] * ((num[c] / ws) / ws);
  }
  const float gws = gwa + torch_inner_sum(t3, 3, 1);
  // each weight's gradient: the depth's product, the colour's, the sum's
  float gw[32];
  for (int s = 0; s < S; ++s) {
    for (int c = 0; c < 3; ++c) {
      t3[c] = gnc[c] * rgb[c * TS + t0 + s];
      m.Grgb[c * TS + t0 + s] = gnc[c] * m.Ws[t0 + s];
    }
    gw[s] = (gnd * z[s] + torch_inner_sum(t3, 3, 1)) + gws;
  }
  // weights = alpha * T; T = cumprod([1, q])[:-1]: the cumprod's input
  // gradient is reversed_cumsum(output * grad) / input
  for (int i = 0; i <= S; ++i)
    pr[S - i] = cp[i] * (i < S ? gw[i] * m.Al[t0 + i] : 0.0f);
  torch_scan(pr, S + 1, false);
  for (int s = 0; s < S; ++s) {
    const int t = t0 + s;
    const float q = (1.0f - m.Al[t]) + 1e-10f;
    const float gq = pr[S - (s + 1)] / q;
    const float galpha = gw[s] * cp[s] + (-gq);
    const float al = m.Al[t];
    const float ge = (-galpha) * (al * al);
    m.Gocc[t] = m.Has[t] ? (ge * m.Ex[t]) * (-p.coef) : 0.0f;
  }
}

__global__ void __launch_bounds__(256, 1)
track_render_fwd(const Params p, const Weights w) {
  extern __shared__ __align__(16) float tr_smem[];
  const int tid = (int)threadIdx.x, S = p.S, K = p.K;
  const int rb = TS / S, r0 = (int)blockIdx.x * rb;
  const int nr = min(rb, p.R - r0), nt = nr * S;
  float* sA = tr_smem;                 // activations, 180 rows
  float* sC = sA + (NX + CHD) * LDA;   // interpolated features, 32 rows
  float* sW = sC + C * LDA;            // a layer's weights (168 x 128)
  float* sF = sW + 168 * CHD;          // its fc_c weights (32 x 128)
  const Small m = carve(sF + C * CHD, K);
  float* save = p.save + (long)blockIdx.x * p.save_block;

  setup_slots(p, m, r0, nt);
  __syncthreads();

  // ---- geometry: interpolation, embedding, trunk, head --------------------
  interp(p, m, r0, nt, 0, p.noise_g, sC, p.bfg);
  embed(m.P, 3, w.p[W_GB], GE, false, sA, p.bfg);
  {
    const int in0[5] = {0, GE, GE, 0, GE};
    const int nin[5] = {GE, GHD, GHD, GE + GHD, GHD};
    const int ty = tid / 8, tx = tid % 8;
    for (int i = 0; i < 5; ++i) {
      stage(sW, GHD, w.p[W_GLW(i)], GHD, 0, nin[i], nin[i], p.bfg);
      stage(sF, GHD, w.p[W_GFW(i)], GHD, 0, C, C, p.bfg);
      __syncthreads();
      float acc[2][4] = {}, accf[2][4] = {};
      gemm<2, 8, 1>(sA + in0[i] * LDA, sW, nin[i], GHD, acc);
      gemm<2, 8, 1>(sC, sF, C, GHD, accf);
      __syncthreads();
      const float* b = w.p[W_GLB(i)];
      const float* fb = w.p[W_GFB(i)];
      float* pre_out = save + OFF_GPRE + (long)i * GHD * TS;
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty * 2 + mm, o = tx * 4 + j;
          const float pre = acc[mm][j] + b[o];
          pre_out[o * TS + t] = pre;
          const float h = (pre > 0.0f ? pre : 0.0f) + (accf[mm][j] + fb[o]);
          sA[(GE + o) * LDA + t] = rnd(h, p.bfg);
        }
    }
    __syncthreads();
    if (tid < TS) {
      // the (n, 32) x (32, 1) product sums its two halves apart (cuBLAS)
      const float* ow = w.p[W_GOW];
      float a0 = 0.0f, a1 = 0.0f;
      for (int o = 0; o < GHD / 2; ++o) {
        a0 = fmaf(sA[(GE + o) * LDA + tid], rnd(ow[o], p.bfg), a0);
        a1 = fmaf(sA[(GE + GHD / 2 + o) * LDA + tid],
                  rnd(ow[GHD / 2 + o], p.bfg), a1);
      }
      float occ = (a0 + a1) + w.p[W_GOB][0];
      occ = m.Has[tid] ? occ : -100.0f;
      m.Occ[tid] = occ;
      save[OFF_OCC + tid] = occ;
    }
  }

  // ---- colour: neighbour features -----------------------------------------
  if (p.rel) {
    __syncthreads();
    stage(sW, CHD, w.p[W_NW1], CHD, 0, NX, NX, p.bfc);
    stage(sW + NX * CHD, C, w.p[W_NW2], C, 0, CHD, CHD, p.bfc);
    const float* b1 = w.p[W_NB1];
    const float* b2 = w.p[W_NB2];
    const long nout = off_nout(K);
    float cc[4][2][4] = {};  // the interpolation's four accumulators
    for (int k = 0; k < K; ++k) {
      __syncthreads();
      embed(m.Dif + 3 * k, 3 * K, w.p[W_CBR], RE, true, sA, p.bfc);
      for (int idx = tid; idx < TS * C; idx += NT) {
        const int t = idx / C, ch = idx - t * C;
        float v = 0.0f;
        if (t < nt)
          v = p.both[(((long)m.Row[t] * S + t % S) * K + k) * FB + C + ch];
        sA[(2 * RE + ch) * LDA + t] = rnd(v, p.bfc);
      }
      __syncthreads();
      {
        float acc[4][8] = {};
        gemm<4, 16, 2>(sA, sW, NX, CHD, acc);
        const int ty = tid / 16, tx = tid % 16;
        float* pre_out = save + OFF_NPRE + (long)k * CHD * TS;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int t = ty * 4 + mm, o = tx * 4 + 64 * h + j;
              const float pre = acc[mm][4 * h + j] + b1[o];
              pre_out[o * TS + t] = pre;
              sA[(NX + o) * LDA + t] = rnd(softplus100(pre), p.bfc);
            }
      }
      __syncthreads();
      {
        float acc[2][4] = {};
        gemm<2, 8, 1>(sA + NX * LDA, sW + NX * CHD, CHD, C, acc);
        const int ty = tid / 8, tx = tid % 8;
        float* out = save + nout + (long)k * C * TS;
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = ty * 2 + mm, ch = tx * 4 + j;
            const float v = acc[mm][j] + b2[ch];
            out[ch * TS + t] = v;
            cc[k & 3][mm][j] = cc[k & 3][mm][j] + m.Wt[t * K + k] * v;
          }
      }
    }
    const int ty = tid / 8, tx = tid % 8;
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty * 2 + mm, ch = tx * 4 + j;
        float v = 0.0f;
        if (t < nt)
          v = m.Has[t] ? ((cc[0][mm][j] + cc[1][mm][j]) + cc[2][mm][j]) +
                             cc[3][mm][j]
                       : 0.01f * p.noise_c[((long)r0 * S + t) * C + ch];
        sC[ch * LDA + t] = rnd(v, p.bfc);
      }
  } else {
    interp(p, m, r0, nt, C, p.noise_c, sC, p.bfc);
  }

  // ---- colour: embedding, trunk, head ---------------------------------------
  embed(m.P, 3, w.p[W_CB], CE, true, sA, p.bfc);
  __syncthreads();
  {
    const int in0[5] = {0, 2 * CE, 2 * CE, 0, 2 * CE};
    const int nin[5] = {2 * CE, CHD, CHD, 2 * CE + CHD, CHD};
    const int ty = tid / 16, tx = tid % 16;
    for (int i = 0; i < 5; ++i) {
      stage(sW, CHD, w.p[W_CLW(i)], CHD, 0, nin[i], nin[i], p.bfc);
      stage(sF, CHD, w.p[W_CFW(i)], CHD, 0, C, C, p.bfc);
      __syncthreads();
      float acc[4][8] = {}, accf[4][8] = {};
      gemm<4, 16, 2>(sA + in0[i] * LDA, sW, nin[i], CHD, acc);
      gemm<4, 16, 2>(sC, sF, C, CHD, accf);
      __syncthreads();
      const float* b = w.p[W_CLB(i)];
      const float* fb = w.p[W_CFB(i)];
      float* pre_out = save + OFF_CPRE + (long)i * CHD * TS;
#pragma unroll
      for (int mm = 0; mm < 4; ++mm)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = ty * 4 + mm, o = tx * 4 + 64 * h + j;
            const float pre = acc[mm][4 * h + j] + b[o];
            pre_out[o * TS + t] = pre;
            const float hv =
                softplus100(pre) + (accf[mm][4 * h + j] + fb[o]);
            sA[(2 * CE + o) * LDA + t] = rnd(hv, p.bfc);
          }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 3 * TS; idx += NT) {
    const int c = idx / TS, t = idx - c * TS;
    const float* ow = w.p[W_COW];
    float acc = 0.0f;
    for (int o = 0; o < CHD; ++o)
      acc = fmaf(sA[(2 * CE + o) * LDA + t], rnd(ow[o * 3 + c], p.bfc), acc);
    const float logit = acc + w.p[W_COB][c];
    save[OFF_LOG + c * TS + t] = logit;
    const float rgb = sigmoidf(soft_clamp(logit));
    save[OFF_RGB + c * TS + t] = rgb;
    m.Rgb[c * TS + t] = rgb;
  }
  __syncthreads();

  // ---- compositing, a thread a ray, in torch's order of operations -------
  if (tid < nr) composite_ray(p, m, r0, tid);
}

__global__ void __launch_bounds__(256, 1)
track_render_bwd(const Params p, const Weights w) {
  extern __shared__ __align__(16) float tr_smem[];
  const int tid = (int)threadIdx.x, S = p.S, K = p.K;
  const int rb = TS / S, r0 = (int)blockIdx.x * rb;
  const int nr = min(rb, p.R - r0), nt = nr * S;
  float* gH = tr_smem;        // gradient of a layer's output, 128 rows
  float* gP = gH + CHD * LDA; // ... of its pre-activation, 128 rows
  float* gE = gP + CHD * LDA; // ... of an embedding, 93 rows
  float* gCG = gE + GE * LDA; // ... of the geometry features, 32 rows
  float* gCC = gCG + C * LDA; // ... of the colour features, 32 rows
  float* sWb = gCC + C * LDA; // a layer's weights by input row, 128 x 129
  float* sFb = sWb + 128 * (CHD + 1);  // its fc_c weights, 32 x 129
  const Small m = carve(sFb + C * (CHD + 1), K);
  const float* save = p.save + (long)blockIdx.x * p.save_block;
  const int ty = tid / 16, tx = tid % 16;

  setup_slots(p, m, r0, nt);
  if (tid < TS) {
    m.Gocc[tid] = 0.0f;
    for (int c = 0; c < 3; ++c) {
      m.Grgb[c * TS + tid] = 0.0f;
      m.Gpts[3 * tid + c] = 0.0f;  // the rel-pos offsets' share
    }
  }
  __syncthreads();

  // ---- compositing, backward: a thread a ray ----------------------------
  if (tid < nr) composite_ray_back(p, m, save, r0, tid);
  __syncthreads();
  // the colour logits' gradient: sigmoid, then the soft clamp
  for (int idx = tid; idx < 3 * TS; idx += NT) {
    const float y = save[OFF_RGB + idx];
    m.Glog[idx] = soft_clamp_back((m.Grgb[idx] * (1.0f - y)) * y,
                                  save[OFF_LOG + idx]);
  }

  // ---- geometry trunk, backward ---------------------------------------------
  for (int idx = tid; idx < GHD * TS; idx += NT) {
    const int o = idx / TS, t = idx - o * TS;
    gH[o * LDA + t] =
        rnd(m.Gocc[t] * rnd(w.p[W_GOW][o], p.bfg), p.bfg);
  }
  for (int idx = tid; idx < GE * TS; idx += NT)
    gE[(idx / TS) * LDA + idx % TS] = 0.0f;
  for (int idx = tid; idx < C * TS; idx += NT) {
    gCG[(idx / TS) * LDA + idx % TS] = 0.0f;
    gCC[(idx / TS) * LDA + idx % TS] = 0.0f;
  }
  {
    const int nin[5] = {GE, GHD, GHD, GE + GHD, GHD};
    for (int i = 4; i >= 0; --i) {
      __syncthreads();
      const int npad = i == 0 ? 96 : (i == 3 ? 128 : 32);
      stage(sWb, GHD + 1, w.p[W_GLW(i)], GHD, 0, nin[i], npad, p.bfg);
      stage(sFb, GHD + 1, w.p[W_GFW(i)], GHD, 0, C, C, p.bfg);
      __syncthreads();
      {
        float a[4][2] = {};
        gemm_t<2>(gH, sFb, GHD, GHD + 1, a);
        for (int mm = 0; mm < 4; ++mm)
          for (int j = 0; j < 2; ++j) {
            float& g = gCG[(tx + 16 * j) * LDA + ty * 4 + mm];
            g = g + rnd(a[mm][j], p.bfg);
          }
      }
      const float* pre = save + OFF_GPRE + (long)i * GHD * TS;
      for (int idx = tid; idx < GHD * TS; idx += NT) {
        const int o = idx / TS, t = idx - o * TS;
        gP[o * LDA + t] = pre[o * TS + t] > 0.0f ? gH[o * LDA + t] : 0.0f;
      }
      __syncthreads();
      if (i == 0) {
        float a[4][6] = {};
        gemm_t<6>(gP, sWb, GHD, GHD + 1, a);
        for (int mm = 0; mm < 4; ++mm)
          for (int j = 0; j < 6; ++j) {
            const int col = tx + 16 * j, t = ty * 4 + mm;
            if (col < GE) gE[col * LDA + t] += rnd(a[mm][j], p.bfg);
          }
      } else if (i == 3) {
        float a[4][8] = {};
        gemm_t<8>(gP, sWb, GHD, GHD + 1, a);
        for (int mm = 0; mm < 4; ++mm)
          for (int j = 0; j < 8; ++j) {
            const int col = tx + 16 * j, t = ty * 4 + mm;
            if (col < GE) gE[col * LDA + t] += rnd(a[mm][j], p.bfg);
            else if (col < GE + GHD)
              gH[(col - GE) * LDA + t] = rnd(a[mm][j], p.bfg);
          }
      } else {
        float a[4][2] = {};
        gemm_t<2>(gP, sWb, GHD, GHD + 1, a);
        for (int mm = 0; mm < 4; ++mm)
          for (int j = 0; j < 2; ++j)
            gH[(tx + 16 * j) * LDA + ty * 4 + mm] = rnd(a[mm][j], p.bfg);
      }
    }
  }
  __syncthreads();
  if (tid < nt)
    embed_back(m.P + 3 * tid, w.p[W_GB], GE, false, gE + tid,
               m.GpG + 3 * tid);

  // ---- colour trunk, backward -----------------------------------------------
  for (int idx = tid; idx < CHD * TS; idx += NT) {
    const int o = idx / TS, t = idx - o * TS;
    const float* ow = w.p[W_COW] + o * 3;
    float a = 0.0f;
    for (int c = 0; c < 3; ++c)
      a = fmaf(m.Glog[c * TS + t], rnd(ow[c], p.bfc), a);
    gH[o * LDA + t] = rnd(a, p.bfc);
  }
  __syncthreads();
  for (int idx = tid; idx < 2 * CE * TS; idx += NT)
    gE[(idx / TS) * LDA + idx % TS] = 0.0f;
  for (int i = 4; i >= 0; --i) {
    __syncthreads();
    stage(sFb, CHD + 1, w.p[W_CFW(i)], CHD, 0, C, C, p.bfc);
    if (i == 0)
      stage(sWb, CHD + 1, w.p[W_CLW(0)], CHD, 0, 2 * CE, 48, p.bfc);
    else
      stage(sWb, CHD + 1, w.p[W_CLW(i)], CHD, i == 3 ? 2 * CE : 0, CHD, CHD,
            p.bfc);
    __syncthreads();
    {
      float a[4][2] = {};
      gemm_t<2>(gH, sFb, CHD, CHD + 1, a);
      for (int mm = 0; mm < 4; ++mm)
        for (int j = 0; j < 2; ++j) {
          float& g = gCC[(tx + 16 * j) * LDA + ty * 4 + mm];
          g = g + rnd(a[mm][j], p.bfc);
        }
    }
    const float* pre = save + OFF_CPRE + (long)i * CHD * TS;
    for (int idx = tid; idx < CHD * TS; idx += NT) {
      const int o = idx / TS, t = idx - o * TS;
      gP[o * LDA + t] = softplus100_back(gH[o * LDA + t], pre[o * TS + t]);
    }
    __syncthreads();
    if (i == 0) {
      float a[4][3] = {};
      gemm_t<3>(gP, sWb, CHD, CHD + 1, a);
      for (int mm = 0; mm < 4; ++mm)
        for (int j = 0; j < 3; ++j) {
          const int col = tx + 16 * j, t = ty * 4 + mm;
          if (col < 2 * CE) gE[col * LDA + t] += rnd(a[mm][j], p.bfc);
        }
    } else {
      float a[4][8] = {};
      gemm_t<8>(gP, sWb, CHD, CHD + 1, a);
      for (int mm = 0; mm < 4; ++mm)
        for (int j = 0; j < 8; ++j)
          gH[(tx + 16 * j) * LDA + ty * 4 + mm] = rnd(a[mm][j], p.bfc);
    }
    if (i == 3) {  // the skip: the embedding's rows of W_3
      __syncthreads();
      stage(sWb, CHD + 1, w.p[W_CLW(3)], CHD, 0, 2 * CE, 48, p.bfc);
      __syncthreads();
      float a[4][3] = {};
      gemm_t<3>(gP, sWb, CHD, CHD + 1, a);
      for (int mm = 0; mm < 4; ++mm)
        for (int j = 0; j < 3; ++j) {
          const int col = tx + 16 * j, t = ty * 4 + mm;
          if (col < 2 * CE) gE[col * LDA + t] += rnd(a[mm][j], p.bfc);
        }
    }
  }
  __syncthreads();
  if (tid < nt)
    embed_back(m.P + 3 * tid, w.p[W_CB], CE, true, gE + tid,
               m.GpC + 3 * tid);

  // ---- the interpolation weights' gradient, a thread a (slot, neighbour) ----
  const long nout = off_nout(K);
  for (int idx = tid; idx < TS * K; idx += NT) {
    const int t = idx / K, k = idx - t * K;
    float g = 0.0f;
    if (t < nt && m.Has[t]) {
      const float* row =
          p.both + (((long)m.Row[t] * S + t % S) * K + k) * FB;
      float pr[C];
      for (int ch = 0; ch < C; ++ch) pr[ch] = gCG[ch * LDA + t] * row[ch];
      const float gg = torch_inner_sum(pr, C, 1);
      if (p.rel) {
        const float* f = save + nout + (long)k * C * TS + t;
        for (int ch = 0; ch < C; ++ch) pr[ch] = gCC[ch * LDA + t] * f[ch * TS];
      } else {
        for (int ch = 0; ch < C; ++ch) pr[ch] = gCC[ch * LDA + t] * row[C + ch];
      }
      g = torch_inner_sum(pr, C, 1) + gg;
    }
    m.Gw[t * K + k] = g;
  }

  // ---- the rel-pos transform, backward, a neighbour at a time ---------------
  if (p.rel) {
    __syncthreads();
    stage(sWb, C + 1, w.p[W_NW2], C, 0, CHD, CHD, p.bfc);
    stage(sFb, CHD + 1, w.p[W_NW1], CHD, 0, 2 * RE, 32, p.bfc);
    float racc[4][3] = {};  // the slot's offsets' gradients, summed over k
    for (int k = 0; k < K; ++k) {
      __syncthreads();
      // the transformed features' gradient: weight_k * d(colour features)
      for (int idx = tid; idx < C * TS; idx += NT) {
        const int ch = idx / TS, t = idx - ch * TS;
        gCG[ch * LDA + t] = (t < nt && m.Has[t])
                                ? m.Wt[t * K + k] * gCC[ch * LDA + t]
                                : 0.0f;
      }
      __syncthreads();
      {
        float a[4][8] = {};
        gemm_t<8>(gCG, sWb, C, C + 1, a);
        const float* pre = save + OFF_NPRE + (long)k * CHD * TS;
        for (int mm = 0; mm < 4; ++mm)
          for (int j = 0; j < 8; ++j) {
            const int o = tx + 16 * j, t = ty * 4 + mm;
            gP[o * LDA + t] =
                softplus100_back(rnd(a[mm][j], p.bfc), pre[o * TS + t]);
          }
      }
      __syncthreads();
      {
        float a[4][2] = {};
        gemm_t<2>(gP, sFb, CHD, CHD + 1, a);
        for (int mm = 0; mm < 4; ++mm)
          for (int j = 0; j < 2; ++j) {
            const int col = tx + 16 * j, t = ty * 4 + mm;
            if (col < 2 * RE) gE[col * LDA + t] = rnd(a[mm][j], p.bfc);
          }
      }
      __syncthreads();
      if (tid < nt) {
        float g[3];
        embed_back(m.Dif + (3 * K) * tid + 3 * k, w.p[W_CBR], RE, true,
                   gE + tid, g);
        for (int d = 0; d < 3; ++d) racc[k & 3][d] = racc[k & 3][d] + (-g[d]);
      }
    }
    if (tid < nt)
      for (int d = 0; d < 3; ++d)
        m.Gpts[3 * tid + d] =
            ((racc[0][d] + racc[1][d]) + racc[2][d]) + racc[3][d];
  }
  __syncthreads();

  // ---- the distances' gradient, and the points' ------------------------
  if (tid < nt) {
    const int t = tid;
    const float* dif = m.Dif + t * K * 3;
    const float* gw = m.Gw + t * K;
    const float r2 = m.R2[t];
    const int ne = m.NE[t];
    float wr[16], wm[16], mk[16], pr[16];
    for (int k = 0; k < K; ++k) {
      const float dx = dif[3 * k], dy = dif[3 * k + 1], dz = dif[3 * k + 2];
      float d2 = (dx * dx + dz * dz) + dy * dy;
      if (!((ne >> k) & 1)) d2 = 1e4f;
      wr[k] = 1.0f / (d2 + 1e-10f);
      mk[k] = d2 <= r2 ? 1.0f : 0.0f;
      wm[k] = wr[k] * mk[k];
      pr[k] = fabsf(wm[k]);
    }
    const float den = torch_inner_sum(pr, K, 1) + 1e-12f;
    // w = wm / den: the divisor's gradient, summed over k
    for (int k = 0; k < K; ++k) pr[k] = -gw[k] * ((wm[k] / den) / den);
    const float gden = torch_inner_sum(pr, K, 1);
    float a[4][3] = {};
    for (int k = 0; k < K; ++k) {
      // wm = (1 / (D + 1e-10)) * 1.0 * mask, |wm| summed into den
      const float gwm = gw[k] / den + gden * sgnf(wm[k]);
      const float grc = (gwm * mk[k]) * 1.0f;
      const float gd2 = ((ne >> k) & 1) ? (-grc) * (wr[k] * wr[k]) : 0.0f;
      for (int d = 0; d < 3; ++d) {
        const float gdif = gd2 * dif[3 * k + d] + gd2 * dif[3 * k + d];
        a[k & 3][d] = a[k & 3][d] + (-gdif);
      }
    }
    const long gi = (long)r0 * S + t;
    for (int d = 0; d < 3; ++d) {
      const float gD = ((a[0][d] + a[1][d]) + a[2][d]) + a[3][d];
      // autograd adds the branches in this order: the colour embedding's,
      // the rel-pos offsets', the geometry embedding's, the distances'
      const float gc = p.rel ? m.GpC[3 * t + d] + m.Gpts[3 * t + d]
                             : m.GpC[3 * t + d];
      p.gpts[3 * gi + d] = (gc + m.GpG[3 * t + d]) + gD;
    }
  }
}

size_t fwd_smem(int K) {
  return (FWD_TILES + small_floats(K)) * sizeof(float);
}
size_t bwd_smem(int K) {
  return (BWD_TILES + small_floats(K)) * sizeof(float);
}

int check(int R, int S, int K) {
  if (R < 0 || S < 1 || S > MAX_S || K < 1 || K > 16) return -1;
  return 0;
}

}  // namespace

extern "C" {

long track_render_save_floats(int K, int rel) { return save_floats(K, rel); }

int track_render_forward(const void* const* wp, const float* pts,
                         const int64_t* pick, const float* D,
                         const float* both, const int* nn, const float* z,
                         const float* rq, float rq_scalar,
                         const float* noise_g, const float* noise_c,
                         float* depth, float* var, float* color, float* save,
                         int R, int S, int K, int min_nn, int rel, int bfg,
                         int bfc, float coef, void* stream) {
  if (check(R, S, K)) return -1;
  if (R == 0) return 0;
  Weights w;
  for (int i = 0; i < NW; ++i) w.p[i] = static_cast<const float*>(wp[i]);
  Params p = {};
  p.pts = pts; p.pick = pick; p.D = D; p.both = both; p.nn = nn; p.z = z;
  p.rq = rq; p.rq_scalar = rq_scalar; p.noise_g = noise_g;
  p.noise_c = noise_c; p.depth = depth; p.var = var; p.color = color;
  p.save = save; p.save_block = save_floats(K, rel);
  p.R = R; p.S = S; p.K = K; p.min_nn = min_nn; p.rel = rel; p.bfg = bfg;
  p.bfc = bfc; p.coef = coef;
  const int rb = TS / S;
  const int grid = (R + rb - 1) / rb;
  const size_t smem = fwd_smem(K);
  cudaError_t err = cudaFuncSetAttribute(
      track_render_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  track_render_fwd<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p, w);
  return (int)cudaGetLastError();
}

int track_render_backward(const void* const* wp, const float* pts,
                          const int64_t* pick, const float* D,
                          const float* both, const int* nn, const float* z,
                          const float* rq, float rq_scalar, const float* gd,
                          long gd_s, const float* gc, long gc_s0, long gc_s1,
                          float* save, float* gpts, int R, int S, int K,
                          int min_nn, int rel, int bfg, int bfc, float coef,
                          void* stream) {
  if (check(R, S, K)) return -1;
  if (R == 0) return 0;
  Weights w;
  for (int i = 0; i < NW; ++i) w.p[i] = static_cast<const float*>(wp[i]);
  Params p = {};
  p.pts = pts; p.pick = pick; p.D = D; p.both = both; p.nn = nn; p.z = z;
  p.rq = rq; p.rq_scalar = rq_scalar; p.gd = gd; p.gd_s = gd_s; p.gc = gc;
  p.gc_s0 = gc_s0; p.gc_s1 = gc_s1; p.gpts = gpts; p.save = save;
  p.save_block = save_floats(K, rel);
  p.R = R; p.S = S; p.K = K; p.min_nn = min_nn; p.rel = rel; p.bfg = bfg;
  p.bfc = bfc; p.coef = coef;
  const int rb = TS / S;
  const int grid = (R + rb - 1) / rb;
  const size_t smem = bwd_smem(K);
  cudaError_t err = cudaFuncSetAttribute(
      track_render_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  track_render_bwd<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
