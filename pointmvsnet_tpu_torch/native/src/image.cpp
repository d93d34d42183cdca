// The port's image path, as a plain C interface for ctypes
// (native/__init__.py), built into one library with dataplane.cpp:
//
// - jpeg_scan: the entropy-coded data of one baseline JPEG scan, unstuffed
//   and split at its restart markers, Huffman-decoded and scattered into
//   the coefficient array (dataset/jpeg.py: _entropy_segments, _decode_scan
//   and the scatter in decode_jpeg);
// - jpeg_reconstruct: dequantisation, libjpeg's islow IDCT and range limit,
//   fancy or replicated upsampling and the YCbCr→RGB tables (jpeg.py:
//   _reconstruct);
// - png_unfilter: the five PNG row filters (io.py: _unfilter);
// - resize_linear: the two-tap linear resize of preprocess.py's
//   resize_image(..., "linear"), float32 in numpy's order of operations.
//
// Each gives its Python version's result bit for bit, and fails where it
// raises: the marker parse, the Huffman table specs' lengths and the resize
// taps stay in Python, and a return code below tells the wrapper which of
// the Python path's exceptions to raise. The file is untrusted input: every
// read of the entropy data and every write of a coefficient or a pixel is
// bounds-checked.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// jpeg_scan's return codes (native/__init__.py raises the Python path's
// exception for each):
constexpr int kNoEoi = -1;          // the scan runs to the end of the data
constexpr int kNoCode = -2;         // no Huffman code matches the next bits
constexpr int kPastEnd = -3;        // a read past the bit windows of the data
constexpr int kFewRestarts = -4;    // fewer restart intervals than MCUs need
constexpr int kTooManyCoefs = -5;   // a block with more than 64 coefficients
constexpr int kCoefIndex = -6;      // a coefficient's index outside the array
constexpr int kBadArgs = -7;        // arguments that do not fit together

// A Huffman lookup table entry for the next 16 bits of the stream, as
// jpeg.py's _huffman_lookup makes it: (bits, run, value) packed as
// (value + 16) << 9 | run << 5 | bits, or -1 where no code matches. value > 0:
// the coefficient + 32768 (code and magnitude fit in 16 bits); 0: a symbol of
// size 0; < 0: minus the size of magnitude bits that reach past the 16.
constexpr int32_t kNone = -1;

int32_t pack_entry(int bits, int run, int value) {
  return (static_cast<int32_t>(value + 16) << 9) | (run << 5) | bits;
}

// Canonical codes of (bits[0..15], vals) → 65536 entries. Codes past the
// table's end are dropped, as the Python list keeps them past index 65535,
// where no 16-bit peek reaches.
void build_lookup(const uint8_t* bits, const uint8_t* vals, int32_t* table) {
  std::fill(table, table + 65536, kNone);
  int64_t code = 0;
  int k = 0;
  for (int length = 1; length <= 16; ++length) {
    for (int i = 0; i < bits[length - 1]; ++i) {
      const int sym = vals[k++];
      const int r = sym >> 4, s = sym & 15;
      const int64_t lo = code << (16 - length), n = int64_t{1} << (16 - length);
      for (int64_t j = 0; j < n && lo + j < 65536; ++j) {
        if (s == 0 || length + s > 16) {
          table[lo + j] = pack_entry(length, r, -s);
        } else {
          const int m = static_cast<int>(j >> (16 - length - s));     // the magnitude bits
          const int v = m < (1 << (s - 1)) ? m - ((1 << s) - 1) : m;
          table[lo + j] = pack_entry(length + s, r, v + 32768);
        }
      }
      ++code;
    }
    code <<= 1;
  }
}

inline uint64_t load_be64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return __builtin_bswap64(v);
}

// libjpeg's post-IDCT range limit, indexed by (x & 1023): clamp(x + 128)
// for |x| < 512, libjpeg's wraparound beyond.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
  }
};
const RangeLimit kRangeLimit;

// zigzag index of each natural (row-major) index of an 8×8 block
constexpr int kZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

// One pass of jidctint.c's islow IDCT on 8 values (stride apart), in int64
// as jpeg.py's _idct_1d computes it, descaled by `shift`.
inline void idct_1d(const int64_t* c, int stride, int shift, int64_t* out, int out_stride) {
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  const int64_t c0 = c[0], c1 = c[stride], c2 = c[2 * stride], c3 = c[3 * stride],
                c4 = c[4 * stride], c5 = c[5 * stride], c6 = c[6 * stride], c7 = c[7 * stride];
  int64_t z1 = (c2 + c6) * F0541;
  const int64_t tmp2 = z1 - c6 * F1847, tmp3 = z1 + c2 * F0765;
  const int64_t tmp0 = (c0 + c4) * 8192, tmp1 = (c0 - c4) * 8192;
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  z1 = c7 + c1;
  int64_t z2 = c5 + c3, z3 = c7 + c3, z4 = c5 + c1;
  const int64_t z5 = (z3 + z4) * F1175;
  int64_t t0 = c7 * F0298, t1 = c5 * F2053, t2 = c3 * F3072, t3 = c1 * F1501;
  z1 = z1 * -F0899;
  z2 = z2 * -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int64_t rnd = int64_t{1} << (shift - 1);
  const int64_t r[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
  for (int i = 0; i < 8; ++i) out[i * out_stride] = (r[i] + rnd) >> shift;
}

// A component plane at its downsampled size (dh × dw) → its full size,
// cropped to (h, w), as jpeg.py's _upsample: h2v1, h1v2 and h2v2 "fancy"
// (triangle) upsampling, edges replicated, the horizontal kinds where the
// plane is wider than 2; box replication otherwise.
void upsample(const uint8_t* x, int dh, int dw, int fh, int fv, int h, int w, uint8_t* out) {
  const bool wide = dw > 2;
  auto at = [&](int r, int c) -> int { return x[static_cast<int64_t>(r) * dw + c]; };
  if (fh == 1 && fv == 1) {
    for (int r = 0; r < h; ++r)
      memcpy(out + static_cast<int64_t>(r) * w, x + static_cast<int64_t>(r) * dw, w);
    return;
  }
  // o[2j] = (3·in[j] + in[j−1] + bias0) >> shift, o[2j+1] with in[j+1] and
  // bias1; in's edges replicated; the row cut to w
  auto h2 = [w, dw](const int* in, int bias0, int bias1, int shift, uint8_t* o) {
    for (int j = 0; 2 * j < w; ++j) {
      const int v = 3 * in[j];
      o[2 * j] = static_cast<uint8_t>((v + in[std::max(j - 1, 0)] + bias0) >> shift);
      if (2 * j + 1 < w)
        o[2 * j + 1] = static_cast<uint8_t>((v + in[std::min(j + 1, dw - 1)] + bias1) >> shift);
    }
  };
  std::vector<int> row(dw);
  if (fh == 2 && fv == 1 && wide) {
    for (int r = 0; r < h; ++r) {
      for (int j = 0; j < dw; ++j) row[j] = at(r, j);
      h2(row.data(), 1, 2, 2, out + static_cast<int64_t>(r) * w);
    }
    return;
  }
  if (fh == 1 && fv == 2) {
    for (int r = 0; r < h; ++r) {
      const int i = r >> 1, far = r & 1 ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      for (int c = 0; c < w; ++c)
        out[static_cast<int64_t>(r) * w + c] = static_cast<uint8_t>(
            (3 * at(i, c) + at(far, c) + (r & 1 ? 2 : 1)) >> 2);
    }
    return;
  }
  if (fh == 2 && fv == 2 && wide) {              // row: the vertical column sums
    for (int r = 0; r < h; ++r) {
      const int i = r >> 1, far = r & 1 ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      for (int j = 0; j < dw; ++j) row[j] = 3 * at(i, j) + at(far, j);
      h2(row.data(), 8, 7, 4, out + static_cast<int64_t>(r) * w);
    }
    return;
  }
  for (int r = 0; r < h; ++r)
    for (int c = 0; c < w; ++c)
      out[static_cast<int64_t>(r) * w + c] = x[static_cast<int64_t>(r / fv) * dw + c / fh];
}

// The PNG Paeth predictor without branches: p = a + b − c, and of a, b, c
// the one nearest p, ties to a, then b.
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  const int take_b = -(pb <= pc), take_a = -((pa <= pb) & (pa <= pc));   // masks
  const int bc = (b & take_b) | (c & ~take_b);
  return (a & take_a) | (bc & ~take_a);
}

// One row of w pixels of BPP bytes under a filter that reads the pixel to
// the left (1 Sub, 3 Average, 4 Paeth), the left and upper-left pixels kept
// in registers (a, c: zero left of the first pixel).
template <int BPP, int FILTER>
void left_row(const uint8_t* f, const uint8_t* up, int64_t w, uint8_t* cur) {
  int a[BPP] = {}, c[BPP] = {};
  for (int64_t x = 0; x < w; ++x)
    for (int k = 0; k < BPP; ++k) {
      const int64_t i = x * BPP + k;
      const int b = up[i];
      const int pred = FILTER == 1 ? a[k] : FILTER == 3 ? (a[k] + b) >> 1 : paeth(a[k], b, c[k]);
      a[k] = static_cast<uint8_t>(f[i] + pred);
      c[k] = b;
      cur[i] = static_cast<uint8_t>(a[k]);
    }
}

template <int BPP>
void left_row(int filter, const uint8_t* f, const uint8_t* up, int64_t w, uint8_t* cur) {
  if (filter == 1) left_row<BPP, 1>(f, up, w, cur);
  else if (filter == 3) left_row<BPP, 3>(f, up, w, cur);
  else left_row<BPP, 4>(f, up, w, cur);
}

template <typename Src, typename Dst>
int resize_linear_impl(const Src* src, int64_t sh, int64_t sw, int64_t ch, Dst* dst, int64_t dh,
                       int64_t dw, const int64_t* x0, const int64_t* x1, const float* ax0,
                       const float* ax1, const int64_t* y0, const int64_t* y1, const float* ay0,
                       const float* ay1) {
  for (int64_t j = 0; j < dw; ++j)
    if (x0[j] < 0 || x0[j] >= sw || x1[j] < 0 || x1[j] >= sw) return -1;
  for (int64_t i = 0; i < dh; ++i)
    if (y0[i] < 0 || y0[i] >= sh || y1[i] < 0 || y1[i] >= sh) return -1;
  const int64_t row_len = dw * ch;
  // the row pass of the two source rows the current output row needs
  std::vector<float> rows(2 * row_len);
  int64_t held[2] = {-1, -1};
  auto row = [&](int64_t r, int64_t other) -> const float* {
    for (int s = 0; s < 2; ++s)
      if (held[s] == r) return rows.data() + s * row_len;
    const int s = held[0] == other ? 1 : 0;      // keep the other row this output needs
    held[s] = r;
    float* out = rows.data() + s * row_len;
    const Src* in = src + r * sw * ch;
    for (int64_t j = 0; j < dw; ++j) {
      const Src* p0 = in + x0[j] * ch;
      const Src* p1 = in + x1[j] * ch;
      for (int64_t c = 0; c < ch; ++c) {
        const float a = static_cast<float>(p0[c]) * ax0[j];
        const float b = static_cast<float>(p1[c]) * ax1[j];
        out[j * ch + c] = a + b;
      }
    }
    return out;
  };
  for (int64_t i = 0; i < dh; ++i) {
    const float* r0 = row(y0[i], y1[i]);
    const float* r1 = row(y1[i], y0[i]);
    Dst* out = dst + i * row_len;
    for (int64_t k = 0; k < row_len; ++k) {
      const float a = r0[k] * ay0[i];
      const float b = r1[k] * ay1[i];
      const float v = a + b;
      if constexpr (sizeof(Dst) == 1) {                // round half up, clip
        float t = std::floor(v + 0.5f);
        t = t < 0.0f ? 0.0f : t > 255.0f ? 255.0f : t;
        out[k] = static_cast<Dst>(t);
      } else {
        out[k] = v;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// One sequential scan whose entropy-coded data starts at data[start]:
// unstuffed (0xFF00 → 0xFF, fill bytes dropped) and split at RSTn up to the
// first other marker, whose offset goes to *end. Block i of the stream
// belongs to scan component slots[i] and its coefficients start at flat
// index offsets[i]; n_blocks / n_mcu blocks per MCU. Scan component j
// decodes with lookup tables dc_tab[j] / ac_tab[j] of the n_tables specs in
// specs (16 BITS bytes, then their values) at spec_off[t].
//
// Each coefficient goes to coefs (n_coefs int16, zigzag within a block) as
// the Python path scatters its packed list: p = (index << 16) + value +
// 32768, coefs[p >> 16] = (p & 0xFFFF) − 32768, a negative index counting
// from the end; DC values predicted per component, reset at each restart.
// A decode error wins over an index outside the array (the Python path
// scatters after the whole scan); *err_index takes the first such index.
int jpeg_scan(const uint8_t* data, int64_t len, int64_t start, int64_t n_mcu, int restart,
              const int32_t* slots, const int64_t* offsets, int64_t n_blocks,
              const uint8_t* specs, int64_t specs_len, const int64_t* spec_off, int n_tables,
              const int32_t* dc_tab, const int32_t* ac_tab, int n_slots, int16_t* coefs,
              int64_t n_coefs, int64_t* end, int64_t* err_index) {
  if (start < 0 || n_mcu < 0 || n_blocks < 0 || n_slots <= 0 ||
      (n_mcu ? n_blocks % n_mcu : n_blocks))
    return kBadArgs;
  for (int64_t i = 0; i < n_blocks; ++i)
    if (slots[i] < 0 || slots[i] >= n_slots) return kBadArgs;
  std::vector<int32_t> tables(static_cast<size_t>(n_tables) * 65536);
  for (int t = 0; t < n_tables; ++t) {
    const int64_t o = spec_off[t];
    if (o < 0 || o + 16 > specs_len) return kBadArgs;
    int64_t n = 0;
    for (int b = 0; b < 16; ++b) n += specs[o + b];
    if (o + 16 + n > specs_len) return kBadArgs;
    build_lookup(specs + o, specs + o + 16, tables.data() + static_cast<size_t>(t) * 65536);
  }
  std::vector<const int32_t*> dc(n_slots), ac(n_slots);
  for (int j = 0; j < n_slots; ++j) {
    if (dc_tab[j] < 0 || dc_tab[j] >= n_tables || ac_tab[j] < 0 || ac_tab[j] >= n_tables)
      return kBadArgs;
    dc[j] = tables.data() + static_cast<size_t>(dc_tab[j]) * 65536;
    ac[j] = tables.data() + static_cast<size_t>(ac_tab[j]) * 65536;
  }

  // 1. the entropy-coded segments, unstuffed, back to back
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(std::max<int64_t>(len - start, 0)) + 16);
  std::vector<int64_t> seg_start{0};              // in bits
  int64_t from = start;
  bool ended = false;
  for (int64_t p = start; p < len; ++p) {
    if (data[p] != 0xFF) continue;
    const int nxt = p + 1 < len ? data[p + 1] : -1;
    if (nxt == 0x00) {                            // stuffed 0xFF
      buf.insert(buf.end(), data + from, data + p + 1);
      from = p + 2;
    } else if (nxt == 0xFF) {                     // fill byte before a marker
      buf.insert(buf.end(), data + from, data + p);
      from = p + 1;
    } else if (nxt >= 0xD0 && nxt <= 0xD7) {      // RSTn
      buf.insert(buf.end(), data + from, data + p);
      seg_start.push_back(8 * static_cast<int64_t>(buf.size()));
      from = p + 2;
    } else {
      buf.insert(buf.end(), data + from, data + p);
      *end = p;
      ended = true;
      break;
    }
  }
  if (!ended) return kNoEoi;
  // bit windows exist for p ≤ 8·len + 39 (zeros past the data); a 64-bit
  // load at byte p >> 3 reads 8 bytes, so 16 bytes of zeros follow
  const int64_t last_pos = 8 * static_cast<int64_t>(buf.size()) + 39;
  buf.resize(buf.size() + 16, 0);
  const uint8_t* bytes = buf.data();

  // 2. Huffman decoding
  *err_index = 0;
  bool index_error = false;
  auto put = [&](int64_t packed) {
    int64_t idx = packed >> 16;
    if (idx < -n_coefs || idx >= n_coefs) {
      if (!index_error) *err_index = idx;
      index_error = true;
      return;
    }
    if (idx < 0) idx += n_coefs;
    coefs[idx] = static_cast<int16_t>((packed & 0xFFFF) - 32768);
  };
  const int64_t bpm = n_mcu ? n_blocks / n_mcu : 0;
  std::vector<int64_t> preds(n_slots, 0);
  int64_t pos = 0, i = 0;
  size_t seg = 0;
  uint32_t w = 0;
  auto peek = [&]() -> bool {
    if (pos > last_pos) return false;
    w = static_cast<uint32_t>((load_be64(bytes + (pos >> 3)) << (pos & 7)) >> 32);
    return true;
  };
  for (int64_t m = 0; m < n_mcu; ++m) {
    if (restart && m && m % restart == 0) {
      if (++seg >= seg_start.size()) return kFewRestarts;
      pos = seg_start[seg];
      std::fill(preds.begin(), preds.end(), 0);
    }
    for (int64_t b = 0; b < bpm; ++b, ++i) {
      const int c = slots[i];
      const int64_t base = offsets[i];
      const int32_t* act = ac[c];
      if (!peek()) return kPastEnd;
      int32_t e = dc[c][w >> 16];
      if (e == kNone) return kNoCode;
      int ln = e & 31, val = (e >> 9) - 16;
      if (val > 0) {
        preds[c] += val - 32768;
      } else if (val < 0) {                       // magnitude bits past the peek
        const int s = -val;
        const int v = static_cast<int>((w >> (32 - ln - s)) & ((1u << s) - 1));
        preds[c] += v < (1 << (s - 1)) ? v - ((1 << s) - 1) : v;
        ln += s;
      }
      pos += ln;
      if (preds[c]) put(base * 65536 + preds[c] + 32768);
      int k = 1;
      while (k < 64) {
        if (!peek()) return kPastEnd;
        e = act[w >> 16];
        if (e == kNone) return kNoCode;
        ln = e & 31;
        const int r = (e >> 5) & 15;
        val = (e >> 9) - 16;
        if (val > 0) {
          k += r;
          put((base + k) * 65536 + val);
          ++k;
          pos += ln;
        } else if (val == 0) {
          pos += ln;
          if (r != 15) break;                     // EOB
          k += 16;                                // ZRL: 16 zeros
        } else {
          const int s = -val;
          k += r;
          const int v = static_cast<int>((w >> (32 - ln - s)) & ((1u << s) - 1));
          put((base + k) * 65536 + (v < (1 << (s - 1)) ? v - ((1 << s) - 1) : v) + 32768);
          ++k;
          pos += ln + s;
        }
      }
      if (k > 64) return kTooManyCoefs;
    }
  }
  return index_error ? kCoefIndex : 0;
}

// Coefficients (n_coefs int16, zigzag within a block) → (height, width, 3)
// uint8 RGB. comp holds 7 numbers per component: its first block, the
// padded block grid's width and height, the downsampled plane's width and
// height, and the horizontal and vertical upsampling factors; qt 64
// quantisation steps per component, natural order. mode 0: one grey
// component, replicated; 1: three components taken as RGB; 2: YCbCr with
// jdcolor.c's tables. Returns 0, or -1 for arguments that do not fit.
int jpeg_reconstruct(const int16_t* coefs, int64_t n_coefs, int n_comp, const int32_t* comp,
                     const int32_t* qt, int height, int width, int mode, uint8_t* out) {
  if (height < 0 || width < 0 || (mode == 0) != (n_comp == 1) || (mode != 0 && n_comp != 3) ||
      mode < 0 || mode > 2)
    return -1;
  const int64_t hw = static_cast<int64_t>(height) * width;
  std::vector<uint8_t> full(static_cast<size_t>(n_comp) * hw);
  for (int ci = 0; ci < n_comp; ++ci) {
    const int32_t* cd = comp + 7 * ci;
    const int64_t off = cd[0], bw = cd[1], bh = cd[2];
    const int dw = cd[3], dh = cd[4], fh = cd[5], fv = cd[6];
    if (off < 0 || bw < 0 || bh < 0 || dw < 0 || dh < 0 || fh < 1 || fv < 1 ||
        (off + bw * bh) * 64 > n_coefs || dw > 8 * bw || dh > 8 * bh ||
        static_cast<int64_t>(dw) * fh < width || static_cast<int64_t>(dh) * fv < height)
      return -1;
    const int32_t* q = qt + 64 * ci;
    std::vector<uint8_t> plane(static_cast<size_t>(dh) * dw);
    int64_t blk[64], ws[64], px[64];
    for (int64_t by = 0; by < (dh + 7) / 8; ++by)
      for (int64_t bx = 0; bx < (dw + 7) / 8; ++bx) {
        const int16_t* z = coefs + (off + by * bw + bx) * 64;
        for (int k = 0; k < 64; ++k) blk[k] = static_cast<int64_t>(z[kZigzag[k]]) * q[k];
        // columns, then rows; where the AC terms of a column or row are 0,
        // every output is the DC term's, (c0·2^13 + 2^(shift−1)) >> shift
        for (int v = 0; v < 8; ++v) {
          const int64_t* c = blk + v;
          if (c[8] | c[16] | c[24] | c[32] | c[40] | c[48] | c[56]) {
            idct_1d(c, 8, 11, ws + v, 8);
          } else {
            for (int y = 0; y < 8; ++y) ws[8 * y + v] = c[0] * 4;
          }
        }
        for (int y = 0; y < 8; ++y) {
          const int64_t* c = ws + 8 * y;
          if (c[1] | c[2] | c[3] | c[4] | c[5] | c[6] | c[7]) {
            idct_1d(c, 1, 18, px + 8 * y, 1);
          } else {
            const int64_t dc = (c[0] * 8192 + (int64_t{1} << 17)) >> 18;
            for (int x = 0; x < 8; ++x) px[8 * y + x] = dc;
          }
        }
        const int64_t y1 = std::min<int64_t>(8, dh - 8 * by);
        const int64_t x1 = std::min<int64_t>(8, dw - 8 * bx);
        for (int64_t y = 0; y < y1; ++y)
          for (int64_t x = 0; x < x1; ++x)
            plane[(8 * by + y) * dw + 8 * bx + x] = kRangeLimit.t[px[8 * y + x] & 1023];
      }
    upsample(plane.data(), dh, dw, fh, fv, height, width, full.data() + ci * hw);
  }
  if (mode == 0) {
    for (int64_t p = 0; p < hw; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = full[p];
    return 0;
  }
  const uint8_t *y = full.data(), *cb = y + hw, *cr = cb + hw;
  if (mode == 1) {
    for (int64_t p = 0; p < hw; ++p) {
      out[3 * p] = y[p];
      out[3 * p + 1] = cb[p];
      out[3 * p + 2] = cr[p];
    }
    return 0;
  }
  // jdcolor.c: Cr→R, Cb→B and the G terms, 16 fraction bits
  int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = (91881 * x + 32768) >> 16;
    cb_b[i] = (116130 * x + 32768) >> 16;
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + 32768;
  }
  auto clip = [](int64_t v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (int64_t p = 0; p < hw; ++p) {
    const int64_t l = y[p];
    out[3 * p] = clip(l + cr_r[cr[p]]);
    out[3 * p + 1] = clip(l + ((cb_g[cb[p]] + cr_g[cr[p]]) >> 16));
    out[3 * p + 2] = clip(l + cb_b[cb[p]]);
  }
  return 0;
}

// h rows of 1 + w·bpp bytes (the filter type, then the filtered bytes) →
// (h, w, bpp) uint8, bpp 1-4. Returns -2 for another bpp, and -1, having
// written nothing, where a row's filter type is above 4.
int png_unfilter(const uint8_t* rows, int64_t h, int64_t w, int bpp, uint8_t* out) {
  if (bpp < 1 || bpp > 4) return -2;
  const int64_t n = w * bpp, stride = n + 1;
  for (int64_t r = 0; r < h; ++r)
    if (rows[r * stride] > 4) return -1;
  const std::vector<uint8_t> zeros(n, 0);              // the row above the first
  for (int64_t r = 0; r < h; ++r) {
    const int filter = rows[r * stride];
    const uint8_t* f = rows + r * stride + 1;
    uint8_t* cur = out + r * n;
    const uint8_t* up = r ? cur - n : zeros.data();
    if (filter == 0) {
      memcpy(cur, f, n);
    } else if (filter == 2) {
      for (int64_t i = 0; i < n; ++i) cur[i] = f[i] + up[i];
    } else if (bpp == 1) {
      left_row<1>(filter, f, up, w, cur);
    } else if (bpp == 2) {
      left_row<2>(filter, f, up, w, cur);
    } else if (bpp == 3) {
      left_row<3>(filter, f, up, w, cur);
    } else {
      left_row<4>(filter, f, up, w, cur);
    }
  }
  return 0;
}

// (sh, sw, ch) → (dh, dw, ch), float32 or uint8 in and out (src_u8, dst_u8),
// with the taps of preprocess.py's _linear_taps: destination column j reads
// source columns x0[j], x1[j] with weights ax0[j], ax1[j], rows likewise.
// Rows first, then columns, each product and sum rounded to float32 as numpy
// rounds them (no fused multiply-add: built with -ffp-contract=off); uint8
// out is floor(v + 0.5) clipped to [0, 255]. Returns -1 for a tap outside
// the source.
int resize_linear(const void* src, int src_u8, int64_t sh, int64_t sw, int64_t ch, void* dst,
                  int dst_u8, int64_t dh, int64_t dw, const int64_t* x0, const int64_t* x1,
                  const float* ax0, const float* ax1, const int64_t* y0, const int64_t* y1,
                  const float* ay0, const float* ay1) {
  if (src_u8 && dst_u8)
    return resize_linear_impl(static_cast<const uint8_t*>(src), sh, sw, ch,
                              static_cast<uint8_t*>(dst), dh, dw, x0, x1, ax0, ax1, y0, y1, ay0,
                              ay1);
  if (!src_u8 && !dst_u8)
    return resize_linear_impl(static_cast<const float*>(src), sh, sw, ch, static_cast<float*>(dst),
                              dh, dw, x0, x1, ax0, ax1, y0, y1, ay0, ay1);
  return -1;
}

}  // extern "C"
