// PNG row unfiltering for utils/png.py (8-bit samples, no interlace).
//
// raw holds h rows of 1 + stride bytes (the filter type, then the
// filtered row); out gets h rows of stride bytes. bpp is the bytes per
// pixel (3 for RGB). The five filters of the PNG specification (None, Sub,
// Up, Average, Paeth), each as a pass along the row, in integer
// arithmetic modulo 256. Average and Paeth read the pixel to the left,
// which this row's pass has just written, so they are sequential along a
// row; that loop is why the unfilter is native code.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

}  // namespace

extern "C" int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride,
                            int bpp, uint8_t* out) {
  // Returns 0, or 1 + the index of the first row with an unknown filter.
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = raw + y * (stride + 1);
    const uint8_t ftype = in[0];
    ++in;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y ? row - stride : nullptr;
    switch (ftype) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) row[i] = in[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          row[i] = (uint8_t)(in[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          row[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          row[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          row[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return (int)(y + 1);
    }
  }
  return 0;
}
