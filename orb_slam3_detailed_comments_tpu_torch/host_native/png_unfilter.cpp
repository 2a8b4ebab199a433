// PNG row unfiltering (PNG specification, section 9: filter types 0-4).
//
// The Sub, Average and Paeth filters predict each byte from the byte one
// pixel to its left in the same row, already unfiltered, so a row is a
// serial recurrence that numpy cannot vectorise. This loop runs it at
// memory speed. The numpy twin is plain.png_unfilter.
//
// A plain C ABI loaded through ctypes, linked into the same library as
// slam_host.cpp.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// in:  height rows of (1 filter byte + stride data bytes), as inflated
// out: height * stride unfiltered bytes
// bpp: bytes per complete pixel, at least 1
// Returns 0, or -(row + 1) for the first row whose filter byte is not 0-4.
int png_unfilter(int height, int stride, int bpp, const uint8_t* in,
                 uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + (size_t)y * (stride + 1);
    const int ftype = src[0];
    ++src;
    uint8_t* row = out + (size_t)y * stride;
    const uint8_t* up = y > 0 ? row - stride : nullptr;
    switch (ftype) {
      case 0:
        std::memcpy(row, src, stride);
        break;
      case 1:
        for (int x = 0; x < stride; ++x)
          row[x] = (uint8_t)(src[x] + (x >= bpp ? row[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < stride; ++x)
          row[x] = (uint8_t)(src[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          row[x] = (uint8_t)(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          row[x] = (uint8_t)(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
