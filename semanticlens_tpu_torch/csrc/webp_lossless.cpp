// WebP lossless (VP8L) and ALPH decoding on the host.
//
// The entropy-coded steps of data/webp.py: a VP8L bitstream (RFC 9649) to
// ARGB words, and an ALPH chunk (raw or VP8L-compressed, then unfiltered) to
// alpha bytes. Each prefix code, backward reference and predicted pixel
// depends on the bits and pixels decoded just before it, so the work is
// sequential and stays on the host, one image per call, in plain C++ with
// nothing outside the standard library; the ARGB words reach the device in
// one upload, where data/webp.py reorders their bytes into RGB.
//
// What counts as an error follows libwebp, the decoder behind PIL's WebP
// plugin, so that a file decodes here exactly when PIL decodes it. Its bit
// reader is copied in behaviour (a 64-bit window holding the 8 bytes before
// the read position, refilled four bytes at a time and a byte at a time
// near the end; the stream counts as ended once more bits were consumed
// than it holds, or than 64 for a stream shorter than 8 bytes), as are the
// points where the end of the stream is checked: a main image or a
// transform's sub-image that reads past its end is an error, while the
// palette-only alpha path accepts a last symbol that does, as libwebp's
// DecodeAlphaData does.
//
// Plain C interface for ctypes (semanticlens_tpu_torch/data/webp.py):
//   sl_vp8l_decode(data, len, argb, width, height) -> status
//     `data` holds a VP8L chunk's payload (signature 0x2f, 14-bit sizes,
//     version 0); `argb` receives width·height words 0xAARRGGBB.
//   sl_alph_decode(data, len, alpha, width, height) -> status
//     `data` holds an ALPH chunk's payload; `alpha` receives width·height bytes.
// Status: 0 done; 1 a broken or truncated bitstream; 2 a header other than
// the caller's (size, signature or version).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kMaxCacheBits = 11;
constexpr int kHuffmanTableBits = 8;
constexpr int kLengthsTableBits = 7;
constexpr int kMaxCodeLength = 15;
constexpr int kCodeLengthCodes = 19;
constexpr int kCodeLengthOrder[kCodeLengthCodes] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
constexpr int kCodeLengthExtraBits[3] = {2, 3, 7};
constexpr int kCodeLengthRepeatOffsets[3] = {3, 3, 11};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

// The 120 short distance codes: (dx, dy) of each, as in RFC 9649 section 4.2.2.
constexpr int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1}, {2, 2},  {-2, 2},
    {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},
    {-3, 4}, {4, 3},  {-4, 3}, {5, 0},  {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1}, {4, 6},  {-4, 6}, {6, 4},  {-6, 4},
    {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7},
    {7, 5},  {-7, 5}, {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

struct Failure {};  // a broken bitstream: unwinds to the C entry point

// --------------------------------------------------------------------------
// Bit reader: bits are read from the least significant end of each byte.
// --------------------------------------------------------------------------
struct BitReader {
  const uint8_t* buf = nullptr;
  size_t len = 0, pos = 0;
  uint64_t val = 0;
  int bit_pos = 0;
  bool eos = false;

  void init(const uint8_t* data, size_t n) {
    buf = data;
    len = n;
    val = 0;
    bit_pos = 0;
    eos = false;
    const size_t m = n < 8 ? n : 8;
    for (size_t i = 0; i < m; ++i) val |= static_cast<uint64_t>(data[i]) << (8 * i);
    pos = m;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_end() {
    eos = true;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= static_cast<uint64_t>(buf[pos]) << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  uint32_t prefetch() const { return static_cast<uint32_t>(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
  void fill() {
    if (bit_pos < 32) return;
    if (pos + 8 < len) {  // four bytes at once (libwebp's fast path): the same window as byte by byte
      uint32_t next;
      std::memcpy(&next, buf + pos, 4);  // little-endian host
      val = (val >> 32) | (static_cast<uint64_t>(next) << 32);
      bit_pos -= 32;
      pos += 4;
    } else {
      shift_bytes();
    }
  }
  void skip(int n) { bit_pos += n; }
};

// --------------------------------------------------------------------------
// Prefix codes: a root table indexed by the next `root_bits` bits, and second-
// level tables for longer codes (zlib's layout, as libwebp builds it).
// --------------------------------------------------------------------------
struct HCode {
  uint8_t bits;    // code length, or root bits + second-level table bits for a link
  uint16_t value;  // symbol, or the offset of the second-level table from this entry
};

uint32_t next_key(uint32_t key, int len) {  // the next bit-reversed code of length len
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// Builds the table of `lengths` (n symbols) into `out`. False for a code with
// no symbol, or one that is over-subscribed or incomplete; a code with a
// single used symbol of any length is valid and reads zero bits.
bool build_table(std::vector<HCode>& out, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return false;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  int used = 0;
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 0) {
      sorted[offset[lengths[s]]++] = static_cast<uint16_t>(s);
      ++used;
    }
  }
  const int root_size = 1 << root_bits;
  if (used == 1) {
    out.assign(root_size, HCode{0, sorted[0]});
    return true;
  }
  // Kraft's sum must be exactly one, and no prefix over-subscribed.
  int num_open = 1;
  for (int len = 1; len <= kMaxCodeLength; ++len) {
    num_open = 2 * num_open - count[len];
    if (num_open < 0) return false;
  }
  if (num_open != 0) return false;

  int total = root_size;  // size of the root table plus every second-level table
  {
    int c[kMaxCodeLength + 1];
    std::memcpy(c, count, sizeof(c));
    uint32_t key = 0, low = 0xffffffffu;
    const uint32_t mask = root_size - 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      for (; c[len] > 0; --c[len]) {
        if (len > root_bits && (key & mask) != low) {
          total += 1 << next_table_bits(c, len, root_bits);
          low = key & mask;
        }
        key = next_key(key, len);
      }
    }
  }
  out.assign(total, HCode{0, 0});
  HCode* root = out.data();
  HCode* table = root;
  int table_bits = root_bits, table_size = root_size, symbol = 0;
  uint32_t key = 0, low = 0xffffffffu;
  const uint32_t mask = root_size - 1;
  int step = 2;
  for (int len = 1; len <= root_bits; ++len, step <<= 1) {
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size, HCode{static_cast<uint8_t>(len), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  step = 2;
  for (int len = root_bits + 1; len <= kMaxCodeLength; ++len, step <<= 1) {
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        low = key & mask;
        root[low].bits = static_cast<uint8_t>(table_bits + root_bits);
        root[low].value = static_cast<uint16_t>((table - root) - low);
      }
      replicate(&table[key >> root_bits], step, table_size,
                HCode{static_cast<uint8_t>(len - root_bits), sorted[symbol++]});
      key = next_key(key, len);
    }
  }
  return true;
}

int read_symbol(const HCode* table, BitReader& br) {
  uint32_t v = br.prefetch();
  table += v & ((1u << kHuffmanTableBits) - 1);
  const int nbits = table->bits - kHuffmanTableBits;
  if (nbits > 0) {
    br.skip(kHuffmanTableBits);
    v = br.prefetch();
    table += table->value;
    table += v & ((1u << nbits) - 1);
  }
  br.skip(table->bits);
  return table->value;
}

// --------------------------------------------------------------------------
// Reading the codes of one image
// --------------------------------------------------------------------------
void read_code_lengths(BitReader& br, const int* code_length_code_lengths, int num_symbols, int* lengths) {
  std::vector<HCode> table;
  if (!build_table(table, kLengthsTableBits, code_length_code_lengths, kCodeLengthCodes)) throw Failure{};
  int max_symbol = num_symbols;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * static_cast<int>(br.read(3));
    max_symbol = 2 + static_cast<int>(br.read(length_nbits));
    if (max_symbol > num_symbols) throw Failure{};
  }
  int prev = 8, symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br.fill();
    const HCode& p = table[br.prefetch() & ((1u << kLengthsTableBits) - 1)];
    br.skip(p.bits);
    const int code_len = p.value;
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev = code_len;
    } else {
      const int slot = code_len - 16;
      int repeat = static_cast<int>(br.read(kCodeLengthExtraBits[slot])) + kCodeLengthRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) throw Failure{};
      const int length = code_len == 16 ? prev : 0;
      while (repeat-- > 0) lengths[symbol++] = length;
    }
  }
}

// One prefix code of `alphabet` symbols into `out`; with `out` null it is only validated.
void read_code(BitReader& br, int alphabet, std::vector<HCode>* out) {
  std::vector<int> lengths(alphabet < 256 ? 256 : alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols given directly
    const int num_symbols = static_cast<int>(br.read(1)) + 1;
    const int first_is_8_bits = static_cast<int>(br.read(1));
    lengths[br.read(first_is_8_bits ? 8 : 1)] = 1;
    if (num_symbols == 2) lengths[br.read(8)] = 1;
  } else {
    int code_length_code_lengths[kCodeLengthCodes] = {0};
    const int num_codes = static_cast<int>(br.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i) code_length_code_lengths[kCodeLengthOrder[i]] = static_cast<int>(br.read(3));
    read_code_lengths(br, code_length_code_lengths, alphabet, lengths.data());
  }
  if (br.eos) throw Failure{};
  std::vector<HCode> scratch;
  if (!build_table(out ? *out : scratch, kHuffmanTableBits, lengths.data(), alphabet)) throw Failure{};
}

struct Group {
  std::vector<HCode> codes[5];
  bool single[5];  // the code reads zero bits
};

struct Metadata {
  int cache_bits = 0;
  int meta_bits = 0;            // 0: one group for the whole image
  int meta_width = 0;
  std::vector<uint32_t> meta;   // group of each tile, compacted
  std::vector<Group> groups;
};

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Decoder;
std::vector<uint32_t> decode_sub_image(Decoder& dec, int width, int height);

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct Decoder {
  BitReader br;
  Transform transforms[4];
  int num_transforms = 0;
  unsigned seen = 0;
};

void read_codes(Decoder& dec, Metadata& hdr, int xsize, int ysize, bool allow_meta) {
  BitReader& br = dec.br;
  int num_groups_max = 1;
  std::vector<uint32_t> image;
  if (allow_meta && br.read(1)) {
    hdr.meta_bits = 2 + static_cast<int>(br.read(3));
    hdr.meta_width = subsample(xsize, hdr.meta_bits);
    image = decode_sub_image(dec, hdr.meta_width, subsample(ysize, hdr.meta_bits));
    for (uint32_t& p : image) {
      p = (p >> 8) & 0xffff;
      if (static_cast<int>(p) >= num_groups_max) num_groups_max = static_cast<int>(p) + 1;
    }
  }
  if (br.eos) throw Failure{};
  // Only the groups some tile uses are kept; every group must still be valid.
  std::vector<int> mapping(num_groups_max, -1);
  int used = 0;
  if (image.empty()) {
    mapping[0] = used++;
  } else {
    for (uint32_t& p : image) {
      if (mapping[p] < 0) mapping[p] = used++;
      p = static_cast<uint32_t>(mapping[p]);
    }
  }
  hdr.meta = std::move(image);
  hdr.groups.resize(used);
  const int alphabets[5] = {kNumLiteralCodes + kNumLengthCodes + (hdr.cache_bits ? 1 << hdr.cache_bits : 0),
                            kNumLiteralCodes, kNumLiteralCodes, kNumLiteralCodes, kNumDistanceCodes};
  for (int i = 0; i < num_groups_max; ++i) {
    Group* group = mapping[i] >= 0 ? &hdr.groups[mapping[i]] : nullptr;
    for (int j = 0; j < 5; ++j) {
      read_code(br, alphabets[j], group ? &group->codes[j] : nullptr);
      if (group) group->single[j] = group->codes[j][0].bits == 0;
    }
  }
}

void read_cache_bits(Decoder& dec, Metadata& hdr) {
  if (dec.br.read(1)) {
    hdr.cache_bits = static_cast<int>(dec.br.read(4));
    if (hdr.cache_bits < 1 || hdr.cache_bits > kMaxCacheBits) throw Failure{};
  }
}

int copy_amount(int symbol, BitReader& br) {  // a length or a distance code from its symbol and extra bits
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dist = kDistanceMap[code - 1][1] * xsize + kDistanceMap[code - 1][0];
  return dist >= 1 ? dist : 1;
}

const Group& group_at(const Metadata& hdr, int x, int y) {
  if (hdr.meta_bits == 0) return hdr.groups[0];
  return hdr.groups[hdr.meta[(y >> hdr.meta_bits) * hdr.meta_width + (x >> hdr.meta_bits)]];
}

// The entropy-coded pixels of one image (libwebp's DecodeImageData): an error
// for a reference outside the image or a stream read past its end.
void decode_pixels(Decoder& dec, const Metadata& hdr, uint32_t* data, int width, int height) {
  BitReader& br = dec.br;
  const size_t total = static_cast<size_t>(width) * height;
  const int cache_size = hdr.cache_bits ? 1 << hdr.cache_bits : 0;
  std::vector<uint32_t> cache(cache_size);
  const int cache_shift = 32 - hdr.cache_bits;
  size_t src = 0, cached = 0;
  int col = 0, row = 0;
  auto insert_pending = [&]() {
    for (; cached < src; ++cached) cache[(data[cached] * 0x1e35a7bdu) >> cache_shift] = data[cached];
  };
  const int mask = hdr.meta_bits ? (1 << hdr.meta_bits) - 1 : -1;  // the group changes only at tile columns
  const Group* group = &group_at(hdr, 0, 0);
  while (src < total) {
    if ((col & mask) == 0) group = &group_at(hdr, col, row);
    const Group& g = *group;
    br.fill();
    const int code = read_symbol(g.codes[GREEN].data(), br);
    if (br.at_end()) break;
    if (code < kNumLiteralCodes) {
      const int red = read_symbol(g.codes[RED].data(), br);
      br.fill();
      const int blue = read_symbol(g.codes[BLUE].data(), br);
      const int alpha = read_symbol(g.codes[ALPHA].data(), br);
      if (br.at_end()) break;
      data[src] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
    } else if (code < kNumLiteralCodes + kNumLengthCodes) {
      const int length = copy_amount(code - kNumLiteralCodes, br);
      const int dist_symbol = read_symbol(g.codes[DIST].data(), br);
      br.fill();
      const int dist = plane_distance(width, copy_amount(dist_symbol, br));
      if (br.at_end()) break;
      if (src < static_cast<size_t>(dist) || total - src < static_cast<size_t>(length)) throw Failure{};
      for (int i = 0; i < length; ++i) data[src + i] = data[src + i - dist];
      src += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (src < total && (col & mask)) group = &group_at(hdr, col, row);
      if (cache_size) insert_pending();
      continue;
    } else {
      if (code - (kNumLiteralCodes + kNumLengthCodes) >= cache_size) throw Failure{};
      insert_pending();
      data[src] = cache[code - (kNumLiteralCodes + kNumLengthCodes)];
    }
    ++src;
    if (++col >= width) {
      col = 0;
      ++row;
      if (cache_size) insert_pending();
    }
  }
  if (br.at_end()) throw Failure{};
}

// A transform's sub-image or the entropy image: no transforms, no meta codes.
std::vector<uint32_t> decode_sub_image(Decoder& dec, int width, int height) {
  Metadata hdr;
  read_cache_bits(dec, hdr);
  read_codes(dec, hdr, width, height, false);
  std::vector<uint32_t> data(static_cast<size_t>(width) * height);
  decode_pixels(dec, hdr, data.data(), width, height);
  return data;
}

// Reads the transforms, the colour cache and the codes of the main image
// (libwebp's DecodeImageStream at level 0); returns the coded width.
int read_main_header(Decoder& dec, Metadata& hdr, int width, int height) {
  BitReader& br = dec.br;
  int xsize = width;
  while (br.read(1)) {
    const int type = static_cast<int>(br.read(2));
    if (dec.seen & (1u << type)) throw Failure{};
    dec.seen |= 1u << type;
    Transform& t = dec.transforms[dec.num_transforms++];
    t.type = type;
    t.xsize = xsize;
    t.ysize = height;
    if (type == PREDICTOR || type == CROSS_COLOR) {
      t.bits = static_cast<int>(br.read(3)) + 2;
      t.data = decode_sub_image(dec, subsample(t.xsize, t.bits), subsample(height, t.bits));
    } else if (type == COLOR_INDEXING) {
      const int num_colors = static_cast<int>(br.read(8)) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> colors = decode_sub_image(dec, num_colors, 1);
      // The palette is coded as differences; entries past it are transparent black.
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
      t.data[0] = colors[0];
      for (int i = 1; i < num_colors; ++i) {
        uint32_t sum = 0;
        for (int s = 0; s < 32; s += 8)
          sum |= (((colors[i] >> s) + (t.data[i - 1] >> s)) & 0xffu) << s;
        t.data[i] = sum;
      }
    }
  }
  read_cache_bits(dec, hdr);
  read_codes(dec, hdr, xsize, height, true);
  return xsize;
}

// --------------------------------------------------------------------------
// Inverse transforms
// --------------------------------------------------------------------------
uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= static_cast<uint32_t>(clip255(static_cast<int>((c0 >> s) & 0xff) + static_cast<int>((c1 >> s) & 0xff) -
                                         static_cast<int>((c2 >> s) & 0xff))) << s;
  return out;
}

uint32_t add_subtract_half(uint32_t c0, uint32_t c1) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = static_cast<int>((c0 >> s) & 0xff), b = static_cast<int>((c1 >> s) & 0xff);
    out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}

uint32_t select_pixel(uint32_t top, uint32_t left, uint32_t top_left) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = static_cast<int>((top >> s) & 0xff), b = static_cast<int>((left >> s) & 0xff);
    const int c = static_cast<int>((top_left >> s) & 0xff);
    pa_minus_pb += std::abs(b - c) - std::abs(a - c);
  }
  return pa_minus_pb <= 0 ? top : left;
}

uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t alpha_green = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t red_blue = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (alpha_green & 0xff00ff00u) | (red_blue & 0x00ff00ffu);
}

// The predictor of each mode from the left, top, top-left and top-right
// neighbours (modes 14 and 15 predict as 0, as libwebp treats them).
template <int M>
uint32_t predict(uint32_t L, uint32_t T, uint32_t TL, uint32_t TR) {
  switch (M) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pixel(T, L, TL);
    case 12: return add_subtract_full(L, T, TL);
    case 13: return add_subtract_half(average2(L, T), TL);
    default: return 0xff000000u;
  }
}

// Adds mode M's prediction to row[x] for x in [x, x_end); `top` is the row
// above, whose element past the end is the first pixel of `row` itself.
template <int M>
void predict_run(uint32_t* row, const uint32_t* top, size_t x, size_t x_end) {
  for (; x < x_end; ++x) row[x] = add_pixels(row[x], predict<M>(row[x - 1], top[x], top[x - 1], top[x + 1]));
}

using PredictRun = void (*)(uint32_t*, const uint32_t*, size_t, size_t);
constexpr PredictRun kPredictRuns[16] = {
    predict_run<0>, predict_run<1>, predict_run<2>,  predict_run<3>,  predict_run<4>,  predict_run<5>,
    predict_run<6>, predict_run<7>, predict_run<8>,  predict_run<9>,  predict_run<10>, predict_run<11>,
    predict_run<12>, predict_run<13>, predict_run<0>, predict_run<0>};

void inverse_predictor(const Transform& t, uint32_t* data) {
  const size_t width = t.xsize;
  const int height = t.ysize;
  data[0] = add_pixels(data[0], 0xff000000u);
  for (size_t x = 1; x < width; ++x) data[x] = add_pixels(data[x], data[x - 1]);
  const int tiles_per_row = subsample(t.xsize, t.bits);
  const size_t tile = static_cast<size_t>(1) << t.bits;
  for (int y = 1; y < height; ++y) {
    uint32_t* row = data + y * width;
    const uint32_t* top = row - width;
    row[0] = add_pixels(row[0], top[0]);
    const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles_per_row;
    for (size_t x = 1; x < width;) {
      const size_t x_end = std::min((x & ~(tile - 1)) + tile, width);
      kPredictRuns[(modes[x >> t.bits] >> 8) & 0xf](row, top, x, x_end);
      x = x_end;
    }
  }
}

int color_delta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

void inverse_cross_color(const Transform& t, uint32_t* data) {
  const int tiles_per_row = subsample(t.xsize, t.bits);
  const int tile = 1 << t.bits;
  for (int y = 0; y < t.ysize; ++y) {
    uint32_t* row = data + static_cast<size_t>(y) * t.xsize;
    for (int x0 = 0; x0 < t.xsize; x0 += tile) {
      const uint32_t m = t.data[static_cast<size_t>(y >> t.bits) * tiles_per_row + (x0 >> t.bits)];
      const int8_t green_to_red = static_cast<int8_t>(m & 0xff), green_to_blue = static_cast<int8_t>((m >> 8) & 0xff);
      const int8_t red_to_blue = static_cast<int8_t>((m >> 16) & 0xff);
      for (int x = x0; x < std::min(x0 + tile, t.xsize); ++x) {
        const uint32_t argb = row[x];
        const int8_t green = static_cast<int8_t>(argb >> 8);
        int red = (argb >> 16) & 0xff, blue = argb & 0xff;
        red = (red + color_delta(green_to_red, green)) & 0xff;
        blue = (blue + color_delta(green_to_blue, green) + color_delta(red_to_blue, static_cast<int8_t>(red))) & 0xff;
        row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
      }
    }
  }
}

void inverse_subtract_green(size_t n, uint32_t* data) {
  for (size_t i = 0; i < n; ++i) {
    const uint32_t green = (data[i] >> 8) & 0xff;
    const uint32_t red_blue = ((data[i] & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
    data[i] = (data[i] & 0xff00ff00u) | red_blue;
  }
}

// Colour indexing: packed indices (xsize coded wide) → colours (t.xsize wide).
std::vector<uint32_t> inverse_color_indexing(const Transform& t, const std::vector<uint32_t>& in) {
  const int coded_width = subsample(t.xsize, t.bits);
  const int bits_per_pixel = 8 >> t.bits, per_byte_mask = (1 << t.bits) - 1;
  const uint32_t index_mask = (1u << bits_per_pixel) - 1;
  std::vector<uint32_t> out(static_cast<size_t>(t.xsize) * t.ysize);
  for (int y = 0; y < t.ysize; ++y) {
    const uint32_t* src = in.data() + static_cast<size_t>(y) * coded_width;
    uint32_t* dst = out.data() + static_cast<size_t>(y) * t.xsize;
    uint32_t packed = 0;
    for (int x = 0; x < t.xsize; ++x) {
      if ((x & per_byte_mask) == 0) packed = (*src++ >> 8) & 0xff;
      dst[x] = t.data[packed & index_mask];
      packed >>= bits_per_pixel;
    }
  }
  return out;
}

// Undoes the transforms, last read first, on the coded pixels.
std::vector<uint32_t> inverse_transforms(const Decoder& dec, std::vector<uint32_t> pixels) {
  for (int n = dec.num_transforms - 1; n >= 0; --n) {
    const Transform& t = dec.transforms[n];
    switch (t.type) {
      case PREDICTOR: inverse_predictor(t, pixels.data()); break;
      case CROSS_COLOR: inverse_cross_color(t, pixels.data()); break;
      case SUBTRACT_GREEN: inverse_subtract_green(static_cast<size_t>(t.xsize) * t.ysize, pixels.data()); break;
      default: pixels = inverse_color_indexing(t, pixels); break;
    }
  }
  return pixels;
}

// --------------------------------------------------------------------------
// Alpha
// --------------------------------------------------------------------------
// Palette-only alpha (libwebp's DecodeAlphaData): green symbols and backward
// references into one byte per coded pixel; the end of the stream may be
// reached by the last symbol.
void decode_alpha_indices(Decoder& dec, const Metadata& hdr, uint8_t* data, int width, int height) {
  BitReader& br = dec.br;
  const size_t total = static_cast<size_t>(width) * height;
  size_t pos = 0;
  int col = 0, row = 0;
  while (!br.eos && pos < total) {
    const Group& g = group_at(hdr, col, row);
    br.fill();
    const int code = read_symbol(g.codes[GREEN].data(), br);
    if (code < kNumLiteralCodes) {
      data[pos++] = static_cast<uint8_t>(code);
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < kNumLiteralCodes + kNumLengthCodes) {
      const int length = copy_amount(code - kNumLiteralCodes, br);
      const int dist_symbol = read_symbol(g.codes[DIST].data(), br);
      br.fill();
      const int dist = plane_distance(width, copy_amount(dist_symbol, br));
      if (pos < static_cast<size_t>(dist) || total - pos < static_cast<size_t>(length)) throw Failure{};
      for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
    } else {
      throw Failure{};
    }
    br.eos = br.at_end();
  }
  if (br.at_end() && pos < total) throw Failure{};
}

void unfilter_alpha(int filter, uint8_t* alpha, int width, int height) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    uint8_t* row = alpha + static_cast<size_t>(y) * width;
    if (filter == 1 || (filter != 0 && prev == nullptr)) {  // horizontal; the first row of the others
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < width; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else if (filter == 3) {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < width; ++x) {
        top = prev[x];
        left = static_cast<uint8_t>(row[x] + clip255(left + top - top_left));
        top_left = top;
        row[x] = left;
      }
    }
    prev = row;
  }
}

void decode_alpha(const uint8_t* data, size_t len, uint8_t* alpha, int width, int height) {
  if (len <= 1) throw Failure{};
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre_processing = (data[0] >> 4) & 3;
  const int reserved = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || reserved != 0) throw Failure{};
  const size_t n = static_cast<size_t>(width) * height;
  if (method == 0) {
    if (len - 1 < n) throw Failure{};
    std::memcpy(alpha, data + 1, n);
  } else {
    Decoder dec;
    dec.br.init(data + 1, len - 1);
    Metadata hdr;
    const int xsize = read_main_header(dec, hdr, width, height);
    bool eight_bit = dec.num_transforms == 1 && dec.transforms[0].type == COLOR_INDEXING && hdr.cache_bits == 0;
    for (const Group& g : hdr.groups) eight_bit = eight_bit && g.single[RED] && g.single[BLUE] && g.single[ALPHA];
    std::vector<uint32_t> pixels(static_cast<size_t>(xsize) * height);
    if (eight_bit) {
      std::vector<uint8_t> indices(pixels.size());
      decode_alpha_indices(dec, hdr, indices.data(), xsize, height);
      for (size_t i = 0; i < pixels.size(); ++i) pixels[i] = static_cast<uint32_t>(indices[i]) << 8;
    } else {
      decode_pixels(dec, hdr, pixels.data(), xsize, height);
    }
    pixels = inverse_transforms(dec, std::move(pixels));
    for (size_t i = 0; i < n; ++i) alpha[i] = static_cast<uint8_t>(pixels[i] >> 8);
  }
  unfilter_alpha(filter, alpha, width, height);
}

}  // namespace

extern "C" {

int sl_vp8l_decode(const uint8_t* data, size_t len, uint32_t* argb, int width, int height) {
  try {
    Decoder dec;
    dec.br.init(data, len);
    if (len < 5 || dec.br.read(8) != 0x2f) return 2;
    const int w = static_cast<int>(dec.br.read(14)) + 1, h = static_cast<int>(dec.br.read(14)) + 1;
    dec.br.read(1);  // the alpha hint
    if (dec.br.read(3) != 0 || dec.br.eos || w != width || h != height) return 2;
    Metadata hdr;
    const int xsize = read_main_header(dec, hdr, width, height);
    std::vector<uint32_t> pixels(static_cast<size_t>(xsize) * height);
    decode_pixels(dec, hdr, pixels.data(), xsize, height);
    pixels = inverse_transforms(dec, std::move(pixels));
    std::memcpy(argb, pixels.data(), static_cast<size_t>(width) * height * sizeof(uint32_t));
    return 0;
  } catch (const Failure&) {
    return 1;
  }
}

int sl_alph_decode(const uint8_t* data, size_t len, uint8_t* alpha, int width, int height) {
  try {
    decode_alpha(data, len, alpha, width, height);
    return 0;
  } catch (const Failure&) {
    return 1;
  }
}

}  // extern "C"
