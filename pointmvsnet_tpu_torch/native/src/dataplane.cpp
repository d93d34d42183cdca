// The port's host data plane: PFM and MVSNet cam.txt readers, a threaded
// batch PFM reader, per-channel standardisation and a nearest resize, as a
// plain C interface for ctypes (native/__init__.py). Each entry gives the
// JAX package's library (pointmvsnet_tpu/native/src/dataplane.cpp) bit for
// bit, through the same names, arguments and return codes.
//
// Built with -ffp-contract=off and without -march=native (native/__init__.py
// sets the flags): a contracted multiply-add rounds a·b + c once where the
// float64 Python expression rounds the product and then the sum, and a
// library built for one host's instruction set must not reach another host
// through a copied tree. The one fused multiply-add the JAX package's library
// gets from its -march=native build is written out (image_standardize).
//
// Every entry returns 0 on success, or a negative code:
//   -1 no PFM tag, -2 not "Pf"/"PF" (cam: no "extrinsic"/"intrinsic"),
//   -3 bad width (cam: extrinsic), -4 bad height (cam: intrinsic),
//   -5 bad scale, -6 nothing after the scale, -10 cannot open,
//   -11 output size is not the map's, -12 data shorter than the header says.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// The header "Pf|PF  width  height  scale" and the one whitespace byte after
// the scale; '#' comment lines may stand between its fields.
int read_pfm_header(FILE* f, int* w, int* h, int* ch, float* scale) {
  char tag[3] = {0, 0, 0};
  if (fscanf(f, "%2s", tag) != 1) return -1;
  if (tag[0] != 'P' || (tag[1] != 'f' && tag[1] != 'F')) return -2;
  *ch = tag[1] == 'F' ? 3 : 1;
  auto skip_space_and_comments = [f]() {
    int c;
    while ((c = fgetc(f)) != EOF) {
      if (c == '#') {
        while ((c = fgetc(f)) != EOF && c != '\n') {
        }
      } else if (!isspace(c)) {
        ungetc(c, f);
        return;
      }
    }
  };
  skip_space_and_comments();
  if (fscanf(f, "%d", w) != 1 || *w < 0) return -3;
  skip_space_and_comments();
  if (fscanf(f, "%d", h) != 1 || *h < 0) return -4;
  skip_space_and_comments();
  if (fscanf(f, "%f", scale) != 1) return -5;
  if (fgetc(f) == EOF) return -6;
  return 0;
}

class File {
 public:
  explicit File(const char* path) : f_(fopen(path, "rb")) {}
  ~File() {
    if (f_) fclose(f_);
  }
  File(const File&) = delete;
  File& operator=(const File&) = delete;
  FILE* get() const { return f_; }

 private:
  FILE* f_;
};

}  // namespace

extern "C" {

int pfm_shape(const char* path, int* height, int* width, int* channels) {
  File f(path);
  if (!f.get()) return -10;
  float scale;
  return read_pfm_header(f.get(), width, height, channels, &scale);
}

// out holds exactly height·width·channels floats; rows come out top-down
// (the file's are bottom-up: one read, then the rows swapped in place).
int pfm_load(const char* path, float* out, int64_t out_len) {
  File f(path);
  if (!f.get()) return -10;
  int w, h, ch;
  float scale;
  const int rc = read_pfm_header(f.get(), &w, &h, &ch, &scale);
  if (rc != 0) return rc;
  const int64_t row = static_cast<int64_t>(w) * ch;
  const int64_t n = row * h;
  if (out_len != n) return -11;
  if (fread(out, 4, n, f.get()) != static_cast<size_t>(n)) return -12;
  for (int y = 0; y < h / 2; ++y)
    std::swap_ranges(out + y * row, out + (y + 1) * row, out + (h - 1 - y) * row);

  const uint16_t probe = 1;
  const bool host_little = *reinterpret_cast<const uint8_t*>(&probe) == 1;
  if ((scale < 0.0f) != host_little) {          // negative scale: little-endian data
    for (int64_t i = 0; i < n; ++i) {
      uint32_t v;
      memcpy(&v, out + i, 4);
      v = __builtin_bswap32(v);
      memcpy(out + i, &v, 4);
    }
  }
  const float mag = std::fabs(scale);
  if (mag != 0.0f && mag != 1.0f)
    for (int64_t i = 0; i < n; ++i) out[i] *= mag;
  return 0;
}

// n maps of `plane` floats each, read by n_threads threads (0: one per
// hardware thread) that take the next file from an atomic index. paths holds
// n NUL-terminated strings back to back. Returns 0, or a failing map's code.
int pfm_load_batch(const char* paths, int n, int64_t plane, float* out, int n_threads) {
  std::vector<const char*> path(n);
  for (int i = 0; i < n; ++i) {
    path[i] = paths;
    paths += strlen(paths) + 1;
  }
  std::atomic<int> next(0), err(0);
  auto worker = [&]() {
    for (int i; (i = next.fetch_add(1)) < n;) {
      const int rc = pfm_load(path[i], out + i * plane, plane);
      if (rc != 0) err.store(rc);
    }
  };
  int nt = n_threads > 0 ? n_threads : static_cast<int>(std::thread::hardware_concurrency());
  nt = std::max(1, std::min(nt, n));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load();
}

// An MVSNet cam.txt into 32 floats, the (2, 4, 4) layout: the extrinsic, then
// K in rows 0-2 of the second matrix and (depth_min, depth_interval ·
// interval_scale, num_depth, depth_max) in its row 3. The extrinsic and K are
// read with strtof, the depth line with strtod and scaled in double. With
// fewer than 4 numbers on the depth line and num_depth > 0, num_depth fills
// in the count and depth_max = depth_min + (num_depth − 1) · interval, in
// double from the float32 depth_min and interval, rounded once.
int cam_load(const char* path, float* out, double interval_scale, int num_depth) {
  std::string text;
  {
    File f(path);
    if (!f.get()) return -10;
    char buf[4096];
    size_t got;
    while ((got = fread(buf, 1, sizeof(buf), f.get())) > 0) text.append(buf, got);
  }
  memset(out, 0, 32 * sizeof(float));
  const size_t epos = text.find("extrinsic");
  const size_t kpos = text.find("intrinsic");
  if (epos == std::string::npos || kpos == std::string::npos) return -2;

  const char* s = text.c_str() + epos + strlen("extrinsic");
  char* end;
  for (int i = 0; i < 16; ++i, s = end) {
    out[i] = strtof(s, &end);
    if (end == s) return -3;
  }
  s = text.c_str() + kpos + strlen("intrinsic");
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c, s = end) {
      out[16 + r * 4 + c] = strtof(s, &end);
      if (end == s) return -4;
    }
  double depth[4] = {0, 0, 0, 0};
  int nd = 0;
  for (; nd < 4; ++nd, s = end) {
    depth[nd] = strtod(s, &end);
    if (end == s) break;
  }
  float* d = out + 28;
  if (nd >= 1) d[0] = static_cast<float>(depth[0]);
  if (nd >= 2) d[1] = static_cast<float>(depth[1] * interval_scale);
  if (nd >= 4) {
    d[2] = static_cast<float>(depth[2]);
    d[3] = static_cast<float>(depth[3]);
  } else if (num_depth > 0) {
    d[2] = static_cast<float>(num_depth);
    d[3] = static_cast<float>(static_cast<double>(d[0]) +
                              static_cast<double>(num_depth - 1) * static_cast<double>(d[1]));
  }
  return 0;
}

// In place, each channel of an (hw, channels) image: (x − mean) / (std +
// 1e-7f), mean and variance over hw in double, Σx and Σx² accumulated in order.
int image_standardize(float* img, int64_t hw, int channels) {
  for (int c = 0; c < channels; ++c) {
    double sum = 0.0, sq = 0.0;
    for (int64_t i = 0; i < hw; ++i) {
      const double v = img[i * channels + c];
      sum += v;
      sq += v * v;
    }
    const double mean = sum / hw;
    // One rounding for sq/hw − mean², as the JAX package's library gets it:
    // it is built with -march=native, where g++ contracts this line into a
    // fused multiply-add.
    const double var = std::fma(-mean, mean, sq / hw);
    const float stdv = static_cast<float>(std::sqrt(var > 0 ? var : 0)) + 1e-7f;
    const float m = static_cast<float>(mean);
    for (int64_t i = 0; i < hw; ++i) img[i * channels + c] = (img[i * channels + c] - m) / stdv;
  }
  return 0;
}

// (sh, sw, channels) → (dh, dw, channels): destination (y, x) takes source
// (y·sh/dh, x·sw/dw) in integer division, clamped to the last row / column.
int resize_nearest(const float* src, int sh, int sw, float* dst, int dh, int dw, int channels) {
  for (int y = 0; y < dh; ++y) {
    const int sy = std::min(static_cast<int>(static_cast<int64_t>(y) * sh / dh), sh - 1);
    for (int x = 0; x < dw; ++x) {
      const int sx = std::min(static_cast<int>(static_cast<int64_t>(x) * sw / dw), sw - 1);
      memcpy(dst + (static_cast<int64_t>(y) * dw + x) * channels,
             src + (static_cast<int64_t>(sy) * sw + sx) * channels, channels * sizeof(float));
    }
  }
  return 0;
}

}  // extern "C"
