// PNG scanline unfiltering and Adam7 de-interlacing on the host.
//
// The step of a PNG decode between inflating the IDAT stream (Python's zlib)
// and converting the samples to RGB (torch ops on the card or the CPU, in
// data/png.py). Each filtered byte depends on its left, upper and upper-left
// neighbours after they were unfiltered, so the work is sequential along a
// row and from row to row: it stays on the host, one image per call, in
// plain C++ with nothing outside the standard library.
//
// Plain C interface for ctypes (semanticlens_tpu_torch/data/png.py):
//   sl_png_unfilter(in, in_len, out, width, height, bits_per_pixel, interlace) -> status
// `in` holds the inflated scanlines: each row is one filter-type byte and
// ceil(width_of_the_pass · bits_per_pixel / 8) filtered bytes; an interlaced
// image holds Adam7's seven passes one after another (a pass of zero width
// or height has no rows). `out` receives height rows of
// ceil(width · bits_per_pixel / 8) bytes, unfiltered and, for an interlaced
// image, with every pass's pixels at their place in the full image.
// Status: 0 done; 1 a filter type other than 0-4; 2 `in` is shorter than the
// rows need.

#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Adam7: first column and row of each pass, and its column and row steps.
constexpr int kStartX[7] = {0, 4, 0, 2, 0, 1, 0};
constexpr int kStartY[7] = {0, 0, 4, 0, 2, 0, 1};
constexpr int kStepX[7] = {8, 8, 4, 4, 2, 2, 1};
constexpr int kStepY[7] = {8, 8, 8, 4, 4, 2, 2};

size_t row_bytes(int width, int bits_per_pixel) {
  return (static_cast<size_t>(width) * bits_per_pixel + 7) / 8;
}

unsigned char paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<unsigned char>(a);
  return static_cast<unsigned char>(pb <= pc ? b : c);
}

// Unfilters `rows` rows of `n` bytes from `in` into `out` (rows n bytes
// apart); `bpp` is the byte distance of the left neighbour. 0, or 1 for an
// unknown filter type.
int unfilter(const unsigned char* in, unsigned char* out, int rows, size_t n, size_t bpp) {
  const unsigned char* prev = nullptr;
  for (int r = 0; r < rows; ++r) {
    const unsigned char type = in[0];
    const unsigned char* src = in + 1;
    unsigned char* dst = out + static_cast<size_t>(r) * n;
    switch (type) {
      case 0:
        std::memcpy(dst, src, n);
        break;
      case 1:
        for (size_t i = 0; i < n; ++i) dst[i] = src[i] + (i >= bpp ? dst[i - bpp] : 0);
        break;
      case 2:
        for (size_t i = 0; i < n; ++i) dst[i] = src[i] + (prev ? prev[i] : 0);
        break;
      case 3:
        for (size_t i = 0; i < n; ++i) {
          const int left = i >= bpp ? dst[i - bpp] : 0, up = prev ? prev[i] : 0;
          dst[i] = static_cast<unsigned char>(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < n; ++i) {
          const int left = i >= bpp ? dst[i - bpp] : 0, up = prev ? prev[i] : 0;
          const int up_left = (prev && i >= bpp) ? prev[i - bpp] : 0;
          dst[i] = static_cast<unsigned char>(src[i] + paeth(left, up, up_left));
        }
        break;
      default:
        return 1;
    }
    prev = dst;
    in += n + 1;
  }
  return 0;
}

}  // namespace

extern "C" {

int sl_png_unfilter(const unsigned char* in, size_t in_len, unsigned char* out, int width, int height,
                    int bits_per_pixel, int interlace) {
  const size_t bpp = bits_per_pixel >= 8 ? static_cast<size_t>(bits_per_pixel / 8) : 1;
  const size_t stride = row_bytes(width, bits_per_pixel);
  if (!interlace) {
    if (in_len < static_cast<size_t>(height) * (stride + 1)) return 2;
    return unfilter(in, out, height, stride, bpp);
  }
  std::memset(out, 0, static_cast<size_t>(height) * stride);
  std::vector<unsigned char> pass;
  size_t offset = 0;
  for (int p = 0; p < 7; ++p) {
    const int pw = width > kStartX[p] ? (width - kStartX[p] + kStepX[p] - 1) / kStepX[p] : 0;
    const int ph = height > kStartY[p] ? (height - kStartY[p] + kStepY[p] - 1) / kStepY[p] : 0;
    if (pw == 0 || ph == 0) continue;
    const size_t n = row_bytes(pw, bits_per_pixel);
    if (in_len < offset + static_cast<size_t>(ph) * (n + 1)) return 2;
    pass.resize(static_cast<size_t>(ph) * n);
    if (unfilter(in + offset, pass.data(), ph, n, bpp) != 0) return 1;
    offset += static_cast<size_t>(ph) * (n + 1);
    for (int r = 0; r < ph; ++r) {
      const unsigned char* src = pass.data() + static_cast<size_t>(r) * n;
      unsigned char* dst = out + static_cast<size_t>(kStartY[p] + r * kStepY[p]) * stride;
      for (int i = 0; i < pw; ++i) {
        const int x = kStartX[p] + i * kStepX[p];
        if (bits_per_pixel >= 8) {
          std::memcpy(dst + static_cast<size_t>(x) * bpp, src + static_cast<size_t>(i) * bpp, bpp);
        } else {  // 1, 2 or 4 bits, packed from the most significant bit
          const int mask = (1 << bits_per_pixel) - 1;
          const size_t from = static_cast<size_t>(i) * bits_per_pixel, to = static_cast<size_t>(x) * bits_per_pixel;
          const int value = (src[from / 8] >> (8 - bits_per_pixel - static_cast<int>(from % 8))) & mask;
          dst[to / 8] |= static_cast<unsigned char>(value << (8 - bits_per_pixel - static_cast<int>(to % 8)));
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
