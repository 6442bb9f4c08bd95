// Host PNG row reconstruction (the reverse of the five PNG row filters).
//
// The C++ side of the port's `datasets/imageio.py` decoder. Sub, Average
// and Paeth each depend on the reconstructed byte to their left, so a row
// cannot be vectorised in numpy; this loop runs at memory speed instead.
// `native/__init__.py` builds it with one g++ call into the package's
// `_build/` directory and loads it with ctypes; `imageio.unfilter_np` is
// its plain version, which the tests hold it against.
//
// Layout: `src` holds `height` rows of 1 + `stride` bytes (the filter type
// byte, then the filtered scanline); `dst` receives `height` rows of
// `stride` reconstructed bytes. `bpp` is the bytes per complete pixel
// (at least 1), the distance to the byte "to the left".

#include <cstdint>
#include <cstdlib>

extern "C" {

// Returns 0, or -(row + 1) for a row whose filter type is not 0-4.
int64_t png_unfilter(const uint8_t* src, int64_t height, int64_t stride,
                     int32_t bpp, uint8_t* dst) {
  const uint8_t* prev = nullptr;  // the reconstructed row above
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t ftype = src[0];
    const uint8_t* x = src + 1;
    uint8_t* r = dst;
    switch (ftype) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) r[i] = x[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          r[i] = static_cast<uint8_t>(x[i] + (i >= bpp ? r[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          r[i] = static_cast<uint8_t>(x[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? r[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          r[i] = static_cast<uint8_t>(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? r[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          r[i] = static_cast<uint8_t>(x[i] + pred);
        }
        break;
      default:
        return -(y + 1);
    }
    prev = dst;
    src += 1 + stride;
    dst += stride;
  }
  return 0;
}

}  // extern "C"
