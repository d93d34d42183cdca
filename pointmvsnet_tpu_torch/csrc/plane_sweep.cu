// The plane sweep's variance cost volume, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the sweep to XLA, which
// fuses it. The port's composition (ops/cost_volume.py::plane_sweep_volume
// on the CPU and under autograd: fetch_features, four index_selects a source
// view, each writing a full copy of its rows, the reference view's map
// broadcast over the D hypotheses, the moments and the variance in f32 over
// (B, V−1, D·h·w, C) tensors, then a cast in the U-Net's first conv) was the
// top device operation of every eval forward. This kernel computes the same
// function in one pass:
//
//     f_v(p)    = z_v(p) > 0 ? Σ_taps w_tap · feat_v[tap] : 0   (bilinear,
//                 align_corners, zero outside the image, at uv_v(p))
//     ref(p)    = depth(p) > 0 ? feat_0(pixel of p) : 0
//     out(p, c) = ((ref² + Σ_v f²) · (1/V)) − ((ref + Σ_v f) · (1/V))²
//
// for every hypothesis p = d·h·w + pixel (plane d's depth, or the pixel's
// own d-th depth) and channel c, over the V − 1 source views in order. The
// arithmetic is point_fetch.cu's at one level (bilinear_variance.cuh): every
// product and sum the composition's f32 operation in its order, rounded
// once, and the division by V the product with the f32 reciprocal 1/V. The
// reference sample is view 0's feature read in place. The volume is written
// in the features' dtype, which is the U-Net's, rounded to nearest even as
// Tensor.to rounds, so the f32 volume and the cast pass are gone.
//
// Bound on this card: bytes. The function reads the source views' uv and z
// (12 B a view and hypothesis), the depths and the features once, and
// writes the volume once: about 0.54 GB at CasMVSNet's 1152×864 stage 3
// (D = 8, C = 8, bf16), 0.16 ms at 3.35 TB/s. The source maps (at most
// 32 MB for four views) stay in the 50 MB L2, so the taps are L1 and L2
// traffic.
//
// Design. One thread per (hypothesis, chunk of CH channels), the chunk
// fastest, then the hypotheses in the volume's order: a warp covers
// neighbouring pixels of one plane, so its uv and z loads and its output
// stores are coalesced, and its taps, neighbouring points of the source
// view, share L1 lines. CH is the widest of 8, 4, 2, 1 that divides C and
// keeps the features' rows aligned to the vector (one 16-byte load a tap at
// C = 8 in bf16). As in point_fetch.cu the loads go out early (the depth,
// then the z and uv of four views before any tap), and a thread has at most
// 80 registers. Measured on T&T's coarse sweep and CasMVSNet's three, ms a
// map (PERF.md): six blocks of 128 threads an SM 0.549 and 2.047; three of
// 256 0.571 and 2.108; four of 256 (64 registers) 0.553 and 2.085; two of
// 256 0.657 and 2.654; blocks of 32 pixels by 256 / (32·K) planes 0.597 and
// 2.056 (faster at D = 8 and 32, slower at 48 and 96).

#include "bilinear_variance.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 6;   // blocks an SM: at most 80 registers a thread

struct Params {
  const float* uv;      // (B, V − 1, D·h·w, 2)
  const float* z;       // (B, V − 1, D·h·w)
  const float* depth;   // (B, D) planes, or (B, D, h, w) per pixel
  const void* feats;    // (B, V, h, w, C), view 0 the reference
  void* out;            // (B, D·h·w, C)
  int V, D, h, w, C, K; // K: chunks per hypothesis, C / CH
  int per_pixel;
  float inv_v;          // 1/V rounded to f32
};

template <typename T, int CH>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
plane_sweep_kernel(const __grid_constant__ Params p) {
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  const unsigned hw = (unsigned)p.h * p.w;
  const unsigned npts = (unsigned)p.D * hw;
  if (t >= npts * p.K) return;
  const int k = t % p.K;
  const unsigned pt = t / p.K;               // d·h·w + pixel
  const unsigned pix = pt % hw;
  const int b = blockIdx.y;
  const int S = p.V - 1;
  const long long view_elems = (long long)hw * p.C;
  const T* views = static_cast<const T*>(p.feats) + (long long)b * p.V * view_elems + k * CH;

  // the loads that depend on no other load go out first: the hypothesis
  // depth, and each group's z and uv
  const float* depth = p.per_pixel ? p.depth + (long long)b * npts + pt
                                   : p.depth + (long long)b * p.D + pt / hw;
  const bool ref_on = __ldg(depth) > 0.0f;
  const long long at = (long long)b * S * npts + pt;
  float s1[CH], s2[CH];
  source_moments<T, CH>(views, view_elems, p.h, p.w, p.C, 1.0f, p.z + at,
                        reinterpret_cast<const float2*>(p.uv) + at, npts, S, s1, s2);

  T ref[CH];
  load_raw<T, CH>(views + (long long)pix * p.C, ref);
  float r[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) r[i] = ref_on ? to_float(ref[i]) : 0.0f;
  float o[CH];
  view_variance<CH>(r, s1, s2, p.inv_v, o);
  store_row<T, CH>(static_cast<T*>(p.out) + ((long long)b * npts + pt) * p.C + k * CH, o);
}

template <typename T>
cudaError_t launch_ch(const Params& p, int ch, dim3 grid, cudaStream_t stream) {
  switch (ch) {
    case 8: plane_sweep_kernel<T, 8><<<grid, THREADS, 0, stream>>>(p); break;
    case 4: plane_sweep_kernel<T, 4><<<grid, THREADS, 0, stream>>>(p); break;
    case 2: plane_sweep_kernel<T, 2><<<grid, THREADS, 0, stream>>>(p); break;
    case 1: plane_sweep_kernel<T, 1><<<grid, THREADS, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// uv (B, V−1, D·h·w, 2) f32, z (B, V−1, D·h·w) f32, depth (B, D) f32 planes
// or (B, D, h, w) f32 per pixel (per_pixel), feats (B, V, h, w, C) bf16 or
// f32 (bf16) → out (B, D, h, w, C) in the features' dtype. ch divides C and
// the features' pointer is aligned to ch elements; D·h·w·C/ch < 2^31 and
// h·w·C < 2^31. The wrapper checks all of it. Returns cudaGetLastError().
extern "C" int plane_sweep(const float* uv, const float* z, const float* depth,
                           const void* feats, void* out, int B, int V, int D, int h, int w,
                           int C, int per_pixel, int ch, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (V < 2 || B > 65535 || ch <= 0 || C <= 0 || C % ch) return (int)cudaErrorInvalidValue;
  Params p{};
  p.uv = uv, p.z = z, p.depth = depth, p.feats = feats, p.out = out;
  p.V = V, p.D = D, p.h = h, p.w = w, p.C = C, p.K = C / ch, p.per_pixel = per_pixel;
  p.inv_v = 1.0f / float(V);
  const long long threads = (long long)D * h * w * p.K;
  if (threads >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (threads == 0 || B == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS), (unsigned)B);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_ch<__nv_bfloat16>(p, ch, grid, s) : launch_ch<float>(p, ch, grid, s));
}
