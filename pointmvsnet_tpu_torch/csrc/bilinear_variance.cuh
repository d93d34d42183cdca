// The bilinear variance over views that point_fetch.cu (PointFlow's fetch)
// and plane_sweep.cu (the plane sweep's cost volume) both compute, in the
// composition's f32 order: each source view's four-tap blend (bilinear,
// align_corners, zero outside the image tap by tap, zero where z <= 0), the
// moments over the source views in view order, and with the reference
// view's sample r the variance ((r² + Σ f²)·(1/V)) − ((r + Σ f)·(1/V))².
// Every product and sum is rounded once (__fmul_rn / __fadd_rn /
// __fsub_rn), so nvcc contracts nothing into an FMA.

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int VIEW_GROUP = 4;   // source views whose z and uv are requested together

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// CH elements of T at p (aligned to their size), through the read-only path
template <typename T, int CH>
__device__ __forceinline__ void load_raw(const T* p, T (&v)[CH]) {
  constexpr int BYTES = int(sizeof(T)) * CH;
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int q = 0; q < BYTES / 16; ++q) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + q);
      memcpy(reinterpret_cast<char*>(v) + 16 * q, &r, 16);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(v, &r, 8);
  } else if constexpr (BYTES == 4) {
    const unsigned r = __ldg(reinterpret_cast<const unsigned*>(p));
    memcpy(v, &r, 4);
  } else {
    const unsigned short r = __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(v, &r, 2);
  }
}

template <typename T, int CH>
__device__ __forceinline__ void store_row(T* p, const float (&f)[CH]) {
  constexpr int BYTES = int(sizeof(T)) * CH;
  T v[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) v[i] = from_float<T>(f[i]);
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int q = 0; q < BYTES / 16; ++q) {
      uint4 r;
      memcpy(&r, reinterpret_cast<const char*>(v) + 16 * q, 16);
      reinterpret_cast<uint4*>(p)[q] = r;
    }
  } else if constexpr (BYTES == 8) {
    uint2 r;
    memcpy(&r, v, 8);
    *reinterpret_cast<uint2*>(p) = r;
  } else if constexpr (BYTES == 4) {
    unsigned r;
    memcpy(&r, v, 4);
    *reinterpret_cast<unsigned*>(p) = r;
  } else {
    unsigned short r;
    memcpy(&r, v, 2);
    *reinterpret_cast<unsigned short*>(p) = r;
  }
}

// The blend of one view's four taps at uv (scaled to level l), zero where
// z ≤ 0: bilinear_sample's arithmetic in its order.
template <typename T, int CH>
__device__ __forceinline__ void blend(const T* view, int hl, int wl, int cl, float scale,
                                      float z, float2 uv, float (&f)[CH]) {
#pragma unroll
  for (int i = 0; i < CH; ++i) f[i] = 0.0f;
  if (!(z > 0.0f)) return;
  const float u = __fmul_rn(uv.x, scale), v = __fmul_rn(uv.y, scale);
  const float u0 = floorf(u), v0 = floorf(v);
  const float du = __fsub_rn(u, u0), dv = __fsub_rn(v, v0);
  const float eu = __fsub_rn(1.0f, du), ev = __fsub_rn(1.0f, dv);
  const float w00 = __fmul_rn(eu, ev), w10 = __fmul_rn(du, ev);
  const float w01 = __fmul_rn(eu, dv), w11 = __fmul_rn(du, dv);
  // tap (i0 + a, j0 + b) lies in the image where i0 + a ∈ [0, w − 1] and
  // j0 + b ∈ [0, h − 1]; compared as floats, since u0 and v0 may lie far
  // outside any integer type (a point close to the camera plane)
  const bool x0 = u0 >= 0.0f && u0 <= float(wl - 1);
  const bool x1 = u0 >= -1.0f && u0 <= float(wl - 2);
  const bool y0 = v0 >= 0.0f && v0 <= float(hl - 1);
  const bool y1 = v0 >= -1.0f && v0 <= float(hl - 2);
  const int iu = (x0 || x1) ? int(u0) : 0, iv = (y0 || y1) ? int(v0) : 0;
  T t00[CH], t10[CH], t01[CH], t11[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) t00[i] = t10[i] = t01[i] = t11[i] = T(0.0f);
  const T* row = view + (iv * wl + iu) * cl;
  if (x0 && y0) load_raw<T, CH>(row, t00);
  if (x1 && y0) load_raw<T, CH>(row + cl, t10);
  if (x0 && y1) load_raw<T, CH>(row + wl * cl, t01);
  if (x1 && y1) load_raw<T, CH>(row + (wl + 1) * cl, t11);
#pragma unroll
  for (int i = 0; i < CH; ++i)
    f[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(to_float(t00[i]), w00),
                                         __fmul_rn(to_float(t10[i]), w10)),
                               __fmul_rn(to_float(t01[i]), w01)),
                     __fmul_rn(to_float(t11[i]), w11));
}

// Σ_s f and Σ_s f² (s1, s2) over the S source views of one point: view s's
// map at views + (s + 1)·view_elems (view 0 is the reference), its z and uv
// at z[s·stride] and uv[s·stride]. The z and uv of a group of views are
// requested before any of their taps.
template <typename T, int CH>
__device__ __forceinline__ void source_moments(const T* views, long long view_elems, int hl,
                                               int wl, int cl, float scale, const float* z,
                                               const float2* uv, long long stride, int S,
                                               float (&s1)[CH], float (&s2)[CH]) {
  for (int s0 = 0; s0 < S; s0 += VIEW_GROUP) {
    float zs[VIEW_GROUP];
    float2 uvs[VIEW_GROUP];
#pragma unroll
    for (int j = 0; j < VIEW_GROUP; ++j) {
      if (s0 + j < S) {
        zs[j] = __ldg(z + (s0 + j) * stride);
        uvs[j] = __ldg(uv + (s0 + j) * stride);
      }
    }
#pragma unroll
    for (int j = 0; j < VIEW_GROUP; ++j) {
      if (s0 + j < S) {
        float f[CH];
        blend<T, CH>(views + (long long)(s0 + j + 1) * view_elems, hl, wl, cl, scale, zs[j],
                     uvs[j], f);
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const float sq = __fmul_rn(f[i], f[i]);
          s1[i] = s0 + j == 0 ? f[i] : __fadd_rn(s1[i], f[i]);
          s2[i] = s0 + j == 0 ? sq : __fadd_rn(s2[i], sq);
        }
      }
    }
  }
}

// The variance over the V views from the reference view's sample r (zero
// where its depth is not positive) and the source views' moments.
template <int CH>
__device__ __forceinline__ void view_variance(const float (&r)[CH], const float (&s1)[CH],
                                              const float (&s2)[CH], float inv_v,
                                              float (&o)[CH]) {
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const float mean = __fmul_rn(__fadd_rn(r[i], s1[i]), inv_v);
    const float sq_mean = __fmul_rn(__fadd_rn(__fmul_rn(r[i], r[i]), s2[i]), inv_v);
    o[i] = __fsub_rn(sq_mean, __fmul_rn(mean, mean));
  }
}

}  // namespace
