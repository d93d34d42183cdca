// Masked window max for every window, level count and width the kNN
// produces, for Hopper (sm_90a).
//
// Replaces: pointmvsnet_tpu/ops/pallas/edge.py::_mwm_kernel (launched by
// masked_window_max) at the shapes the tuned kernel (masked_window_max.cu:
// window 5, G ≤ 5, B·⌈F·size/64⌉ ≤ 65535 blocks) does not take: any odd
// window with G·win² ≤ 128 candidates (G up to 14 at window 3, 128 at
// window 1), any F, f32 and bf16.
//
// out[b, p, f] = max of z[b, nbr_s(p), f] over the window candidates s set
// in p's selection mask (bit s = (gc·win + dy)·win + dx of word s / 32),
// nbr_s(g, y, x) = (gc, y + dy − win/2, x + dx − win/2), folded from the
// floor −finfo(f32).max / 2 rounded to the output type, the result where
// no bit is set. The fold is max.NaN, jnp.maximum's: a NaN wins, +0 wins
// over −0, so the result does not depend on the order of the bits and
// equals the plain version bit for bit (NaN payloads aside). Bits that
// point out of the image, or past level G, add nothing.
//
// Bound on this card: bytes. The function reads z and the mask words once
// and writes out once; the maxima are far below the arithmetic peak.
//
// Design: the simple kernel, reading z's rows through L1 / L2 without
// staging them. One thread per (point, piece of the channels): a piece is
// 16 bytes (4 f32 or 8 bf16) where F·size is a multiple of 16 and z and
// out are 16-byte aligned, else one element. Pieces are the fastest index,
// so a warp's loads of one neighbour row coalesce. A thread walks its
// point's set bits one word at a time, lowest first, and folds each
// in-image neighbour's piece in. A grid-stride loop over all B·P·pieces
// (64-bit indices) takes any B and F: the tuned kernel's grid limit
// (B · channel chunks ≤ 65535) does not apply.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;

__device__ __forceinline__ unsigned max_nan32(unsigned a, unsigned b, float) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
  return __float_as_uint(r);
}

__device__ __forceinline__ unsigned max_nan32(unsigned a, unsigned b, __nv_bfloat16) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  const __nv_bfloat162 m = __hmax2_nan(x, y);
  unsigned r;
  memcpy(&r, &m, 4);
  return r;
}

__device__ __forceinline__ float fold(float a, float b) {
  return __uint_as_float(max_nan32(__float_as_uint(a), __float_as_uint(b), 0.f));
}

__device__ __forceinline__ __nv_bfloat16 fold(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hmax_nan(a, b);
}

template <typename T>
__device__ __forceinline__ uint4 fold(uint4 a, uint4 b) {
  return make_uint4(max_nan32(a.x, b.x, T()), max_nan32(a.y, b.y, T()),
                    max_nan32(a.z, b.z, T()), max_nan32(a.w, b.w, T()));
}

template <typename T> __device__ __forceinline__ T floor_value();
template <> __device__ __forceinline__ float floor_value<float>() { return -FLT_MAX * 0.5f; }
template <> __device__ __forceinline__ __nv_bfloat16 floor_value<__nv_bfloat16>() {
  return __float2bfloat16_rn(-FLT_MAX * 0.5f);
}

template <typename T>
__device__ __forceinline__ uint4 floor_piece() {
  const T v = floor_value<T>();
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) e[i] = v;
  return u;
}

// P: the piece a thread folds, T (one element) or uint4 (16 bytes of T)
template <typename T, typename P>
__global__ void __launch_bounds__(THREADS)
masked_window_max_general_kernel(const T* __restrict__ z, const int* __restrict__ mask,
                                 T* __restrict__ out, int G, int H, int W, int F, int win,
                                 long long total) {
  constexpr bool VEC = sizeof(P) == 16;
  constexpr int EPP = sizeof(P) / sizeof(T);     // elements per piece
  const int npieces = F / EPP;
  const int r = win / 2;
  const int nsh = win * win;
  const int nw = (G * nsh + 31) / 32;
  const int last_bits = G * nsh - 32 * (nw - 1);
  const unsigned last_mask = last_bits >= 32 ? ~0u : (1u << last_bits) - 1u;
  const long long hw = (long long)H * W;
  const long long npts = G * hw;
  P acc0;                                        // the floor in every element
  if constexpr (VEC) acc0 = floor_piece<T>();
  else acc0 = floor_value<T>();

  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const int piece = (int)(i % npieces);
    const long long bp = i / npieces;
    const long long b = bp / npts;
    const long long p = bp - b * npts;
    const int g = (int)(p / hw);
    const long long yx = p - g * hw;
    const int y = (int)(yx / W), x = (int)(yx - (long long)(yx / W) * W);
    const T* zb = z + b * npts * F + (long long)piece * EPP;
    P acc = acc0;
    for (int k = 0; k < nw; ++k) {
      unsigned m = (unsigned)mask[(b * nw + k) * npts + p];
      if (k == nw - 1) m &= last_mask;
      while (m) {
        const int s = 32 * k + __ffs(m) - 1;        // the lowest set bit
        m &= m - 1;
        const int gc = s / nsh;
        const int rem = s - gc * nsh;
        const int yc = y + rem / win - r, xc = x + rem % win - r;
        if (yc < 0 || yc >= H || xc < 0 || xc >= W) continue;
        const P v = *reinterpret_cast<const P*>(zb + (gc * hw + (long long)yc * W + xc) * F);
        if constexpr (VEC) acc = fold<T>(acc, v);
        else acc = fold(acc, v);
      }
    }
    *reinterpret_cast<P*>(out + bp * F + (long long)piece * EPP) = acc;
  }
}

template <typename T>
cudaError_t launch(const void* z, const int* mask, void* out, int B, int G, int H, int W,
                   int F, int win, cudaStream_t stream) {
  const bool vec = (F * sizeof(T)) % 16 == 0 && (uintptr_t)z % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const int epp = vec ? 16 / (int)sizeof(T) : 1;
  const long long total = (long long)B * G * H * W * (F / epp);
  if (total == 0) return cudaSuccess;
  const long long blocks = std::min((total + THREADS - 1) / THREADS, MAX_BLOCKS);
  const T* zt = static_cast<const T*>(z);
  T* ot = static_cast<T*>(out);
  if (vec)
    masked_window_max_general_kernel<T, uint4><<<(unsigned)blocks, THREADS, 0, stream>>>(
        zt, mask, ot, G, H, W, F, win, total);
  else
    masked_window_max_general_kernel<T, T><<<(unsigned)blocks, THREADS, 0, stream>>>(
        zt, mask, ot, G, H, W, F, win, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// z (B, G·H·W, F) f32 (is_bf16 = 0) or bf16 (1); mask (B, NW, G, H, W)
// int32 bitplanes, NW = ⌈G·win²/32⌉, odd win, G·win² ≤ 128 → out like z.
// Returns cudaGetLastError().
extern "C" int masked_window_max_general(const void* z, const int* mask, void* out, int B,
                                         int G, int H, int W, int F, int win, int is_bf16,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (win < 1 || win % 2 != 1 || G < 1 || G * win * win > 128 || B < 0 || H < 1 || W < 1 ||
      F < 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(z, mask, out, B, G, H, W, F, win, (cudaStream_t)stream);
  return (int)launch<float>(z, mask, out, B, G, H, W, F, win, (cudaStream_t)stream);
}
