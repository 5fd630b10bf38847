// Baseline JPEG (ITU-T T.81) decoding and encoding for the port's image
// reader and writer (loopy_slam_torch/utils/imageio.py), built with g++ at
// first use and loaded with ctypes. The entropy-coded segment is a bit
// stream that must be walked code by code, so it is decoded here; the rest
// of a decode (dequantization, the integer inverse DCT, chroma upsampling,
// YCbCr->RGB) follows in the same call, in the arithmetic of
// libjpeg-turbo's defaults (jidctint.c "islow", jdsample.c "fancy"
// upsampling, jdcolor.c), so that the pixels equal what OpenCV's imread
// returns. The encoder mirrors libjpeg-turbo's compressor (jccolor.c,
// jcsample.c h2v2, jfdctint.c, jcdctmgr.c's reciprocal quantization,
// jchuff.c with the tables it is given). The Python side parses and writes
// the markers; these functions see only the scan and the tables.

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
  kTruncated = -1,     // the scan ended (marker or end of data) mid-MCU
  kBadCode = -2,       // a bit pattern that is no Huffman code
  kBadRestart = -3,    // the expected RSTn marker is missing
  kBadCoefIndex = -4,  // a run past coefficient 63
  kBadTable = -5,      // a Huffman table that overflows its code space
  kNoSpace = -6,       // the encoder's output buffer is too small
};

// ---------------------------------------------------------------- decoding

struct HuffDec {
  int maxcode[18];   // largest code of each length, -1 if none
  int valoffset[18]; // index into vals of the first code of each length
  uint16_t look[256];  // 8-bit lookahead: (length << 8) | value, 0 = longer
  uint8_t vals[256];
};

bool build_dec(const uint8_t* bits, const uint8_t* vals, HuffDec* h) {
  int code = 0, k = 0;
  std::memset(h->look, 0, sizeof(h->look));
  std::memcpy(h->vals, vals, 256);
  for (int l = 1; l <= 16; ++l) {
    const int n = bits[l - 1];
    h->valoffset[l] = k - code;
    if (n) {
      for (int i = 0; i < n; ++i, ++code, ++k) {
        if (l <= 8) {
          const int shift = 8 - l;
          for (int j = 0; j < (1 << shift); ++j)
            h->look[(code << shift) | j] =
                static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      h->maxcode[l] = code - 1;
      if (code > (1 << l)) return false;
    } else {
      h->maxcode[l] = -1;
    }
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  return k <= 256;
}

struct BitReader {
  const uint8_t* data;
  int64_t len, pos;
  uint64_t buf = 0;
  int cnt = 0;        // valid bits in buf (the high end of the low `cnt`)
  int zeros = 0;      // bits of zero padding in buf past a marker
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      int byte = 0;
      if (!at_marker) {
        if (pos >= len) {
          at_marker = true;
        } else if (data[pos] == 0xFF) {
          if (pos + 1 < len && data[pos + 1] == 0x00) {
            byte = 0xFF;
            pos += 2;
          } else {
            at_marker = true;  // pos stays on the marker
          }
        } else {
          byte = data[pos++];
        }
      }
      if (at_marker) zeros += 8;
      buf = (buf << 8) | static_cast<uint64_t>(byte);
      cnt += 8;
    }
  }
  int peek16() {
    if (cnt < 16) fill();
    return static_cast<int>((buf >> (cnt - 16)) & 0xFFFF);
  }
  void skip(int n) { cnt -= n; }
  int bits(int n) {
    if (n == 0) return 0;
    if (cnt < n) fill();
    cnt -= n;
    return static_cast<int>((buf >> cnt) & ((1u << n) - 1));
  }
  // true when a code read so far ran into the padding past the data
  bool overran() const { return zeros > cnt; }
  // move pos onto the next marker (past a segment's last padding byte and
  // any 0xFF fill bytes), as libjpeg's next_marker does
  void seek_marker() {
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00))
      pos += data[pos] == 0xFF ? 2 : 1;
    while (pos + 1 < len && data[pos] == 0xFF && data[pos + 1] == 0xFF) ++pos;
  }
  void reset() {
    buf = 0;
    cnt = 0;
    zeros = 0;
  }
};

inline int decode_sym(BitReader* br, const HuffDec& h, int* err) {
  const int p = br->peek16();
  const int e = h.look[p >> 8];
  if (e) {
    br->skip(e >> 8);
    return e & 0xFF;
  }
  for (int l = 9; l <= 16; ++l) {
    const int code = p >> (16 - l);
    if (code <= h.maxcode[l]) {
      br->skip(l);
      return h.vals[h.valoffset[l] + code];
    }
  }
  *err = kBadCode;
  return 0;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c's constants (CONST_BITS 13)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: index (x & 1023) of a table that maps
// -512..511 onto clamp(x + 128, 0, 255) and wraps beyond
uint8_t g_idct_limit[1024];
uint8_t g_sample_limit_storage[256 * 3];
const uint8_t* g_sample_limit;  // clamp to 0..255 for -256..511
int g_cr_r[256], g_cb_b[256];
int64_t g_cr_g[256], g_cb_g[256];

void build_tables() {
  for (int v = 0; v < 1024; ++v) {
    const int x = v < 512 ? v : v - 1024;
    const int y = x + 128;
    g_idct_limit[v] = static_cast<uint8_t>(y < 0 ? 0 : (y > 255 ? 255 : y));
  }
  for (int i = 0; i < 768; ++i) {
    const int x = i - 256;
    g_sample_limit_storage[i] =
        static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
  }
  g_sample_limit = g_sample_limit_storage + 256;
  // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
  const int64_t half = int64_t(1) << 15;
  auto fix = [](double x) {
    return static_cast<int64_t>(x * 65536.0 + 0.5);
  };
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    g_cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
    g_cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
    g_cr_g[i] = -fix(0.71414) * x;
    g_cb_g[i] = -fix(0.34414) * x + half;
  }
}

// once per process, safe against concurrent first calls
void init_tables() {
  static const bool done = (build_tables(), true);
  (void)done;
}

// jidctint.c jpeg_idct_islow: dequantize coef (natural order) with q and
// write the 8x8 samples to out (row stride `stride`)
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qp = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int dc = (in[0] * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = in[16] * qp[16], z3 = in[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * (-F1_847);
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = in[0] * qp[0];
    z3 = in[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qp[56];
    tmp1 = in[40] * qp[40];
    tmp2 = in[24] * qp[24];
    tmp3 = in[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + static_cast<int64_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = g_idct_limit[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * (-F1_847);
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = g_idct_limit[descale(tmp10 + tmp3, n) & 1023];
    o[7] = g_idct_limit[descale(tmp10 - tmp3, n) & 1023];
    o[1] = g_idct_limit[descale(tmp11 + tmp2, n) & 1023];
    o[6] = g_idct_limit[descale(tmp11 - tmp2, n) & 1023];
    o[2] = g_idct_limit[descale(tmp12 + tmp1, n) & 1023];
    o[5] = g_idct_limit[descale(tmp12 - tmp1, n) & 1023];
    o[3] = g_idct_limit[descale(tmp13 + tmp0, n) & 1023];
    o[4] = g_idct_limit[descale(tmp13 - tmp0, n) & 1023];
  }
}

// jdsample.c: one component plane (dw x dh valid samples, row stride
// `stride`) upsampled by (fh, fv) in {1, 2} into a W x H plane. The
// image's first and last sample rows and columns are replicated as
// context, as libjpeg's context rows and edge columns do.
void upsample(const uint8_t* in, int stride, int dw, int dh, int fh, int fv,
              uint8_t* out, int W, int H) {
  auto at = [&](int r, int c) -> int {
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    c = c < 0 ? 0 : (c >= dw ? dw - 1 : c);
    return in[static_cast<int64_t>(r) * stride + c];
  };
  const bool fancy = dw > 2;  // libjpeg: plain replication otherwise
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out + static_cast<int64_t>(y) * W;
    if (fh == 1 && fv == 1) {
      std::memcpy(o, in + static_cast<int64_t>(y) * stride, W);
      continue;
    }
    if (!fancy) {
      const int r = y / fv;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(at(r, x / fh));
      continue;
    }
    if (fv == 2) {  // h2v2_fancy_upsample
      const int r = y >> 1;
      const int r1 = (y & 1) ? r + 1 : r - 1;
      for (int x = 0; x < W; ++x) {
        const int c = x >> 1;
        const int c1 = (x & 1) ? c + 1 : c - 1;
        const int cur = at(r, c) * 3 + at(r1, c);
        const int nb = at(r, c1) * 3 + at(r1, c1);
        o[x] = static_cast<uint8_t>((cur * 3 + nb + ((x & 1) ? 7 : 8)) >> 4);
      }
    } else {  // h2v1_fancy_upsample
      for (int x = 0; x < W; ++x) {
        const int c = x >> 1;
        const int c1 = (x & 1) ? c + 1 : c - 1;
        o[x] = static_cast<uint8_t>(
            (at(y, c) * 3 + at(y, c1) + ((x & 1) ? 2 : 1)) >> 2);
      }
    }
  }
}

// ---------------------------------------------------------------- encoding

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

// Decode one baseline scan holding all `ncomp` components (interleaved, or
// one component) into out (H x W x 3 RGB; gray replicated).
//   scan: the bytes after the SOS header to the end of the file
//   hs, vs: sampling factors; q: ncomp x 64 dequantization values in
//   natural order; dc_bits/ac_bits: ncomp x 16 code counts, dc_vals/
//   ac_vals: ncomp x 256 symbols (each component's own tables)
//   restart: the restart interval in MCUs (0 = none)
//   end: receives the offset of the first byte after the scan (a marker)
// Returns 0, or one of the negative error codes above.
int jpeg_decode(const uint8_t* scan, int64_t scan_len, int W, int H,
                int ncomp, const int* hs, const int* vs, const uint16_t* q,
                const uint8_t* dc_bits, const uint8_t* dc_vals,
                const uint8_t* ac_bits, const uint8_t* ac_vals, int restart,
                uint8_t* out, int64_t* end) {
  init_tables();
  std::vector<HuffDec> dc(ncomp), ac(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    if (!build_dec(dc_bits + 16 * c, dc_vals + 256 * c, &dc[c]) ||
        !build_dec(ac_bits + 16 * c, ac_vals + 256 * c, &ac[c]))
      return kBadTable;
  }
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    hmax = hs[c] > hmax ? hs[c] : hmax;
    vmax = vs[c] > vmax ? vs[c] : vmax;
  }
  // block grid of each component: interleaved scans cover whole MCUs, a
  // one-component scan covers the component's own blocks
  const int mcux = ncomp == 1 ? (W + 7) / 8 : (W + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = ncomp == 1 ? (H + 7) / 8 : (H + 8 * vmax - 1) / (8 * vmax);
  std::vector<int> bw(ncomp), bh(ncomp);
  std::vector<std::vector<uint8_t>> planes(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const int h = ncomp == 1 ? 1 : hs[c], v = ncomp == 1 ? 1 : vs[c];
    bw[c] = mcux * h;
    bh[c] = mcuy * v;
    planes[c].assign(static_cast<size_t>(bw[c]) * 8 * bh[c] * 8, 0);
  }
  BitReader br{scan, scan_len, 0};
  std::vector<int> pred(ncomp, 0);
  int16_t blk[64];
  int err = kOk;
  int rst_n = 0;
  const int64_t n_mcu = static_cast<int64_t>(mcux) * mcuy;
  for (int64_t m = 0; m < n_mcu; ++m) {
    if (restart && m && m % restart == 0) {
      br.reset();
      br.at_marker = false;
      br.seek_marker();
      if (br.pos + 1 >= scan_len || scan[br.pos] != 0xFF ||
          scan[br.pos + 1] != 0xD0 + (rst_n & 7))
        return kBadRestart;
      br.pos += 2;
      ++rst_n;
      for (int c = 0; c < ncomp; ++c) pred[c] = 0;
    }
    const int mx = static_cast<int>(m % mcux), my = static_cast<int>(m / mcux);
    for (int c = 0; c < ncomp; ++c) {
      const int h = ncomp == 1 ? 1 : hs[c], v = ncomp == 1 ? 1 : vs[c];
      for (int by = 0; by < v; ++by) {
        for (int bx = 0; bx < h; ++bx) {
          std::memset(blk, 0, sizeof(blk));
          int s = decode_sym(&br, dc[c], &err);
          if (err) return err;
          if (s > 15) return kBadCode;
          if (s) s = extend(br.bits(s), s);
          pred[c] += s;
          blk[0] = static_cast<int16_t>(pred[c]);
          for (int k = 1; k < 64; ++k) {
            const int rs = decode_sym(&br, ac[c], &err);
            if (err) return err;
            const int r = rs >> 4, sz = rs & 15;
            if (sz) {
              k += r;
              if (k > 63) return kBadCoefIndex;
              blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(sz), sz));
            } else {
              if (r != 15) break;
              k += 15;
            }
          }
          if (br.overran()) return kTruncated;
          const int row = my * v + by, col = mx * h + bx;
          const int stride = bw[c] * 8;
          idct_islow(blk, q + 64 * c,
                     planes[c].data() + static_cast<int64_t>(row) * 8 * stride +
                         col * 8,
                     stride);
        }
      }
    }
  }
  br.seek_marker();
  *end = br.pos;
  // upsample to full size, then convert
  std::vector<std::vector<uint8_t>> full(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const int fh = ncomp == 1 ? 1 : hmax / hs[c];
    const int fv = ncomp == 1 ? 1 : vmax / vs[c];
    const int dw = ncomp == 1 ? W : (W * hs[c] + hmax - 1) / hmax;
    const int dh = ncomp == 1 ? H : (H * vs[c] + vmax - 1) / vmax;
    full[c].resize(static_cast<size_t>(W) * H);
    upsample(planes[c].data(), bw[c] * 8, dw, dh, fh, fv, full[c].data(), W,
             H);
  }
  const int64_t n = static_cast<int64_t>(W) * H;
  if (ncomp == 1) {
    for (int64_t i = 0; i < n; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
    return kOk;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int y = full[0][i], cb = full[1][i], cr = full[2][i];
    out[3 * i] = g_sample_limit[y + g_cr_r[cr]];
    out[3 * i + 1] = g_sample_limit[y + static_cast<int>(
                                            (g_cb_g[cb] + g_cr_g[cr]) >> 16)];
    out[3 * i + 2] = g_sample_limit[y + g_cb_b[cb]];
  }
  return kOk;
}

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
