// PNG scanline unfiltering (ISO/IEC 15948, section 9) for the port's PNG
// reader (loopy_slam_torch/utils/imageio.py), built with g++ at first use
// and loaded with ctypes. The Sub, Average and Paeth filters depend on the
// byte one pixel to the left, so each row is a sequential scan: a numpy
// loop over the columns costs about a second a 640x480 frame.

#include <cstdint>
#include <cstdlib>

extern "C" {

// in: H rows of 1 + rowbytes bytes (filter type, then the filtered row),
// as inflated from the IDAT stream. out: H * rowbytes bytes. bpp: bytes
// per complete pixel (1 for 8-bit gray, 2 for 16-bit gray, 3 RGB, 4 RGBA).
// Returns 0, or -(r + 1) for row r whose filter type is not 0..4.
int png_unfilter(const uint8_t* in, uint8_t* out, int H, int rowbytes,
                 int bpp) {
  for (int r = 0; r < H; ++r) {
    const uint8_t* src = in + static_cast<int64_t>(r) * (rowbytes + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* dst = out + static_cast<int64_t>(r) * rowbytes;
    // the row above; the first row's is all zeros
    const uint8_t* up = r ? dst - rowbytes : nullptr;
    switch (type) {
      case 0:
        for (int i = 0; i < rowbytes; ++i) dst[i] = src[i];
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return -(r + 1);
    }
  }
  return 0;
}

}  // extern "C"
