// A frozen copy of the encoder of loopy_slam_torch/csrc/jpeg_huffman.cpp,
// for the benchmark's sequence writer (bench_core/images.py), built with
// g++ at first use and loaded with ctypes. Baseline JPEG (ITU-T T.81)
// encoding that mirrors libjpeg-turbo's compressor (jccolor.c, jcsample.c
// h2v2, jfdctint.c, jcdctmgr.c's reciprocal quantization, jchuff.c with the
// tables it is given). The Python side writes the markers; this function
// sees only the pixels and the tables and writes the scan.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position in an 8x8 block
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// error codes returned to Python
enum {
  kOk = 0,
  kBadTable = -5,      // a Huffman table that overflows its code space
  kNoSpace = -6,       // the encoder's output buffer is too small
};

// jfdctint.c's constants (CONST_BITS 13)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
};

bool build_enc(const uint8_t* bits, const uint8_t* vals, HuffEnc* h) {
  std::memset(h->size, 0, sizeof(h->size));
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      h->code[vals[k]] = static_cast<uint16_t>(code);
      h->size[vals[k]] = static_cast<uint8_t>(l);
    }
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  return true;
}

struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t buf = 0;
  int cnt = 0;
  bool full = false;

  void byte(uint8_t b) {
    if (n + 2 > cap) {
      full = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0x00;
  }
  void put(uint32_t v, int s) {
    buf = (buf << s) | (v & ((1u << s) - 1));
    cnt += s;
    while (cnt >= 8) {
      cnt -= 8;
      byte(static_cast<uint8_t>(buf >> cnt));
    }
  }
  void flush() {  // jchuff.c flush_bits: pad with 1-bits to a byte
    if (cnt) put(0x7F, 8 - cnt);
    buf = 0;
    cnt = 0;
  }
};

// jfdctint.c jpeg_fdct_islow on samples already centered by -128
void fdct_islow(int* d) {
  const int n1 = kConstBits - kPass1Bits;
  for (int r = 0; r < 8; ++r) {
    int* p = d + r * 8;
    const int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    const int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    const int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    const int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    p[2] = static_cast<int>(descale(z1 + tmp13 * F0_765, n1));
    p[6] = static_cast<int>(descale(z1 + tmp12 * (-F1_847), n1));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * F1_175;
    const int64_t t4 = tmp4 * F0_298, t5 = tmp5 * F2_053, t6 = tmp6 * F3_072,
                  t7 = tmp7 * F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(descale(t4 + z1 + z3, n1));
    p[5] = static_cast<int>(descale(t5 + z2 + z4, n1));
    p[3] = static_cast<int>(descale(t6 + z2 + z3, n1));
    p[1] = static_cast<int>(descale(t7 + z1 + z4, n1));
  }
  const int n2 = kConstBits + kPass1Bits;
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    const int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    const int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    const int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    const int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * F0_541;
    p[16] = static_cast<int>(descale(z1 + tmp13 * F0_765, n2));
    p[48] = static_cast<int>(descale(z1 + tmp12 * (-F1_847), n2));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * F1_175;
    const int64_t t4 = tmp4 * F0_298, t5 = tmp5 * F2_053, t6 = tmp6 * F3_072,
                  t7 = tmp7 * F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(descale(t4 + z1 + z3, n2));
    p[40] = static_cast<int>(descale(t5 + z2 + z4, n2));
    p[24] = static_cast<int>(descale(t6 + z2 + z3, n2));
    p[8] = static_cast<int>(descale(t7 + z1 + z4, n2));
  }
}

// jcdctmgr.c compute_reciprocal for a divisor of 8 * q (16-bit DCTELEM)
struct Recip {
  uint32_t recip, corr;
  int shift;
};

Recip reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = static_cast<uint32_t>((uint64_t(1) << r) / divisor);
  const uint32_t fr = static_cast<uint32_t>((uint64_t(1) << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

void encode_block(BitWriter* bw, const int16_t* blk, int* last_dc,
                  const HuffEnc& dc, const HuffEnc& ac) {
  int temp = blk[0] - *last_dc, temp2 = temp;
  *last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  bw->put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw->put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw->put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    const int i = (r << 4) + nbits;
    bw->put(ac.code[i], ac.size[i]);
    bw->put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw->put(ac.code[0], ac.size[0]);
}

}  // namespace

extern "C" {

// Encode an H x W x 3 RGB image as one interleaved baseline scan with 4:2:0
// sampling (Y 2x2, Cb and Cr 1x1), as libjpeg-turbo's compressor does with
// its defaults: q_lum/q_chr are the quantization tables in natural order,
// the Huffman tables are given as code counts and symbols (luminance DC,
// luminance AC, chrominance DC, chrominance AC). Writes the entropy-coded
// segment (with byte stuffing, padded with 1-bits) to out and its length
// to *len. Returns 0 or kNoSpace / kBadTable.
int jpeg_encode(const uint8_t* rgb, int W, int H, const uint16_t* q_lum,
                const uint16_t* q_chr, const uint8_t* bits,
                const uint8_t* vals, uint8_t* out, int64_t cap,
                int64_t* len) {
  HuffEnc tabs[4];
  for (int t = 0; t < 4; ++t)
    if (!build_enc(bits + 16 * t, vals + 256 * t, &tabs[t])) return kBadTable;
  // jccolor.c rgb_ycc_convert, SCALEBITS 16
  auto fix = [](double x) {
    return static_cast<int64_t>(x * 65536.0 + 0.5);
  };
  const int64_t half = int64_t(1) << 15, off = int64_t(128) << 16;
  int64_t tab[8][256];
  for (int i = 0; i < 256; ++i) {
    tab[0][i] = fix(0.29900) * i;
    tab[1][i] = fix(0.58700) * i;
    tab[2][i] = fix(0.11400) * i + half;
    tab[3][i] = -fix(0.16874) * i;
    tab[4][i] = -fix(0.33126) * i;
    tab[5][i] = fix(0.50000) * i + off + half - 1;  // B->Cb and R->Cr
    tab[6][i] = -fix(0.41869) * i;
    tab[7][i] = -fix(0.08131) * i;
  }
  const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
  // component sample planes: Y padded to whole blocks of the image
  // (ceil(W/8)*8, replicated right and down), chroma to whole MCUs
  const int yw = ((W + 7) / 8) * 8, yh = ((H + 7) / 8) * 8;
  const int cw = mcux * 8, ch = mcuy * 8;
  // full-size Y, Cb, Cr with the right edge expanded to 2 * cw columns and
  // the bottom to an even row count (jcprepct.c / jcsample.c)
  const int fw = 2 * cw, fh_rows = H + (H & 1);
  std::vector<uint8_t> Y(static_cast<size_t>(fw) * fh_rows),
      Cb(Y.size()), Cr(Y.size());
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      const uint8_t* p = rgb + (static_cast<int64_t>(y) * W + x) * 3;
      const int r = p[0], g = p[1], b = p[2];
      const size_t i = static_cast<size_t>(y) * fw + x;
      Y[i] = static_cast<uint8_t>((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
      Cb[i] = static_cast<uint8_t>((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
      Cr[i] = static_cast<uint8_t>((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
    }
    for (auto* P : {&Y, &Cb, &Cr}) {
      uint8_t* row = P->data() + static_cast<size_t>(y) * fw;
      for (int x = W; x < fw; ++x) row[x] = row[W - 1];
    }
  }
  for (int y = H; y < fh_rows; ++y)
    for (auto* P : {&Y, &Cb, &Cr})
      std::memcpy(P->data() + static_cast<size_t>(y) * fw,
                  P->data() + static_cast<size_t>(H - 1) * fw, fw);
  // h2v2_downsample with the alternating 1, 2 bias, then the bottom
  // padded to whole chroma blocks by replicating the last row
  const int dh = (H + 1) / 2;
  std::vector<uint8_t> C[2];
  for (int k = 0; k < 2; ++k) {
    const std::vector<uint8_t>& P = k ? Cr : Cb;
    C[k].assign(static_cast<size_t>(cw) * ch, 0);
    for (int y = 0; y < dh; ++y) {
      const uint8_t* r0 = P.data() + static_cast<size_t>(2 * y) * fw;
      const uint8_t* r1 = r0 + fw;
      uint8_t* o = C[k].data() + static_cast<size_t>(y) * cw;
      int bias = 1;
      for (int x = 0; x < cw; ++x) {
        o[x] = static_cast<uint8_t>(
            (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >>
            2);
        bias ^= 3;
      }
    }
    for (int y = dh; y < ch; ++y)
      std::memcpy(C[k].data() + static_cast<size_t>(y) * cw,
                  C[k].data() + static_cast<size_t>(dh - 1) * cw, cw);
  }
  // Y: rows past the image replicate the last row up to whole blocks
  const int ystride = fw;
  std::vector<uint8_t> Yp(static_cast<size_t>(ystride) * yh);
  for (int y = 0; y < yh; ++y)
    std::memcpy(Yp.data() + static_cast<size_t>(y) * ystride,
                Y.data() + static_cast<size_t>(y < H ? y : H - 1) * fw, fw);

  Recip rq[2][64];
  for (int i = 0; i < 64; ++i) {
    rq[0][i] = reciprocal(uint32_t(q_lum[i]) << 3);
    rq[1][i] = reciprocal(uint32_t(q_chr[i]) << 3);
  }
  auto quantize = [&](const uint8_t* src, int stride, const Recip* r,
                      int16_t* blk) {
    int d[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        d[y * 8 + x] = src[static_cast<int64_t>(y) * stride + x] - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; ++i) {
      int t = static_cast<int16_t>(d[i]);
      const bool neg = t < 0;
      if (neg) t = -t;
      uint32_t p = (static_cast<uint32_t>(static_cast<uint16_t>(t)) +
                    r[i].corr) *
                   r[i].recip;
      p >>= r[i].shift;
      t = static_cast<int16_t>(p);
      blk[i] = static_cast<int16_t>(neg ? -t : t);
    }
  };
  BitWriter wr{out, cap};
  int last_dc[3] = {0, 0, 0};
  int16_t blk[64];
  const int ybw = yw / 8, ybh = yh / 8;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      // four luminance blocks; dummy blocks past the image's blocks are
      // zero with the DC of the block before them (jccoefct.c)
      int16_t prev_dc = 0;
      int16_t row_last_dc = 0;
      for (int by = 0; by < 2; ++by) {
        const int row = my * 2 + by;
        for (int bx = 0; bx < 2; ++bx) {
          const int col = mx * 2 + bx;
          if (row < ybh && col < ybw) {
            quantize(Yp.data() + static_cast<int64_t>(row) * 8 * ystride +
                         col * 8,
                     ystride, rq[0], blk);
          } else {
            std::memset(blk, 0, sizeof(blk));
            blk[0] = row < ybh ? prev_dc : row_last_dc;
          }
          prev_dc = blk[0];
          if (row < ybh) row_last_dc = blk[0];
          encode_block(&wr, blk, &last_dc[0], tabs[0], tabs[1]);
        }
      }
      for (int k = 0; k < 2; ++k) {
        quantize(C[k].data() + static_cast<int64_t>(my) * 8 * cw + mx * 8, cw,
                 rq[1], blk);
        encode_block(&wr, blk, &last_dc[1 + k], tabs[2], tabs[3]);
      }
    }
  }
  wr.flush();
  if (wr.full) return kNoSpace;
  *len = wr.n;
  return kOk;
}

}  // extern "C"
