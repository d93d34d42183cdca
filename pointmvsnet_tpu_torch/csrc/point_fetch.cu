// PointFlow's eval feature fetch, fused with the variance over views, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this fetch to XLA, which
// fuses it. The port's composition (ops/sampling.py::point_fetch on the CPU
// and under autograd: fetch_features_perlevel, the reference view's regular
// samples broadcast over the G hypotheses, the moments and the variance)
// made 48 index_selects a flow, each writing a full copy of its rows, and a
// dozen passes over (B, G·N, ΣC) f32 tensors.
// This kernel computes the same function in one pass:
//
//     f_v,l(p)  = valid_v(p) ? Σ_taps w_tap · feat_v,l[tap] : 0   (bilinear,
//                 align_corners, zero outside the image, at uv_v(p) · 2^-l)
//     ref_l(p)  = hyp_depth(p) > 0 ? ref_sample_l(pixel of p) : 0
//     out(p, c) = ((ref² + Σ_v f²) · (1/V)) − ((ref + Σ_v f) · (1/V))²
//
// for every hypothesis point p (g-major, g·n + pixel) and channel c of the
// levels' concatenation (level 0, then 1, ...), over the V − 1 source views
// in order. It is bit-equal to the composition on this card: every product
// and sum is the composition's f32 operation in the composition's order,
// rounded once (__fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts
// nothing into an FMA), and the division by V is PyTorch's CUDA division by
// a host scalar, a product with the f32 reciprocal 1/V. The output is
// written in the levels' dtype, which is the first EdgeConv's, rounded to
// nearest even as Tensor.to rounds, so the f32 tensor and the cast pass
// are gone.
//
// Bound on this card: bytes. The function reads the source views' uv and z,
// the hypothesis depths, the source views' levels and the reference view's
// samples once and writes the output once: about 2.9 GB a map at the
// 1920×1024 Tanks & Temples flow grids (0.9 ms at 3.35 TB/s), about 0.49 GB
// at the 640×512 DTU ones. The arithmetic, ~45 f32 operations per (point,
// channel) at V = 5, lies under that.
//
// Design. One thread per (point, chunk of CH channels of one level), the
// chunk fastest, then the G hypotheses, then the pixel: the threads of a
// pixel's hypotheses sit in neighbouring warps, and their taps, a few
// pixels apart along the epipolar line, hit the same L1 and L2 lines, as do
// the taps of neighbouring pixels. Each thread loads its chunk of each tap
// row as one vector (16 B at CH = 8 in bf16), blends in f32 registers and
// keeps Σf and Σf² there across the views; nothing but the output is
// written. CH is the widest of 8, 4, 2, 1 that divides every level's width
// and keeps every row and pointer aligned to the vector. Rows stay in the
// cache hierarchy rather than in shared memory: a block's taps spread over
// four views and three levels along epipolar lines whose extent depends on
// the cameras, so no fixed tile holds them. The kernel waits on memory, so
// what it does about that is to keep loads in flight: the z and uv of four
// views and the hypothesis depth are requested before any tap, the taps
// stay packed until the blend, and three blocks of 256 threads fit an SM
// (80 registers a thread). Measured on the T&T map's three calls (PERF.md):
// 12.3 ms a map with one load after another, 9.3 with the loads requested
// early, 6.9 with packed taps, 5.1 at three blocks an SM; four blocks (64
// registers) spill and take 5.3, CH = 4 takes 6.7, and pixel tiles ordered
// g-major inside a block gain 3%.

#include "bilinear_variance.cuh"

namespace {

constexpr int MAX_LEVELS = 4;
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;   // blocks an SM: at most 80 registers a thread

struct Params {
  const float* uv;                 // (B, V − 1, G·n, 2)
  const float* z;                  // (B, V − 1, G·n)
  const float* hyp;                // (B, G, n)
  const void* level[MAX_LEVELS];   // (B, V, h_l, w_l, C_l), view 0 the reference
  const float* ref[MAX_LEVELS];    // (B, n, C_l)
  int h[MAX_LEVELS], w[MAX_LEVELS], c[MAX_LEVELS];
  void* out;                       // (B, G·n, ΣC)
  int V, G, n, K, ctot;            // K: chunks per point, ΣC / CH
  float inv_v;                     // 1/V rounded to f32
};

template <typename T, int CH>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
point_fetch_kernel(const __grid_constant__ Params p) {
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= (unsigned)p.n * p.G * p.K) return;
  const int k = t % p.K;
  const int g = (t / p.K) % p.G;
  const int pix = t / p.K / p.G;
  const int b = blockIdx.y;

  int l = 0, co = k * CH;                    // the chunk's level and first channel there
  while (co >= p.c[l]) co -= p.c[l++];
  const int hl = p.h[l], wl = p.w[l], cl = p.c[l];
  const float scale = 1.0f / float(1 << l);  // exact
  const int S = p.V - 1;
  const long long npts = (long long)p.G * p.n;
  const long long pt = (long long)g * p.n + pix;
  const long long view_elems = (long long)hl * wl * cl;
  const T* lv = static_cast<const T*>(p.level[l]) + (long long)b * p.V * view_elems + co;

  // the loads that depend on no other load go out first: the reference
  // sample's mask, and each group's z and uv
  const bool ref_on = __ldg(p.hyp + ((long long)b * p.G + g) * p.n + pix) > 0.0f;
  const long long at = (long long)b * S * npts + pt;
  float s1[CH], s2[CH];
  source_moments<T, CH>(lv, view_elems, hl, wl, cl, scale, p.z + at,
                        reinterpret_cast<const float2*>(p.uv) + at, npts, S, s1, s2);

  float r[CH];
  load_raw<float, CH>(p.ref[l] + ((long long)b * p.n + pix) * cl + co, r);
#pragma unroll
  for (int i = 0; i < CH; ++i) r[i] = ref_on ? r[i] : 0.0f;
  float o[CH];
  view_variance<CH>(r, s1, s2, p.inv_v, o);
  T* out = static_cast<T*>(p.out) + ((long long)b * npts + pt) * p.ctot + k * CH;
  store_row<T, CH>(out, o);
}

template <typename T>
cudaError_t launch_ch(const Params& p, int ch, dim3 grid, cudaStream_t stream) {
  switch (ch) {
    case 8: point_fetch_kernel<T, 8><<<grid, THREADS, 0, stream>>>(p); break;
    case 4: point_fetch_kernel<T, 4><<<grid, THREADS, 0, stream>>>(p); break;
    case 2: point_fetch_kernel<T, 2><<<grid, THREADS, 0, stream>>>(p); break;
    case 1: point_fetch_kernel<T, 1><<<grid, THREADS, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// uv (B, V−1, G·n, 2) f32, z (B, V−1, G·n) f32, hyp (B, G, n) f32; levels[l]
// (B, V, h_l, w_l, C_l) bf16 or f32 (in_bf16), refs[l] (B, n, C_l) f32, dims
// = h_0, w_0, C_0, h_1, ... for n_levels levels → out (B, G·n, ΣC_l) in the
// levels' dtype. ch divides every C_l; every row and
// pointer is aligned to ch elements; G·n·ΣC/ch < 2^31 and h_l·w_l·C_l < 2^31.
// The wrapper checks all of it. Returns cudaGetLastError().
extern "C" int point_fetch(const float* uv, const float* z, const float* hyp,
                           const void* const* levels, const float* const* refs,
                           const int* dims, int n_levels, void* out, int B, int V, int G,
                           int n, int ch, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_levels < 1 || n_levels > MAX_LEVELS || V < 2 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.uv = uv, p.z = z, p.hyp = hyp, p.out = out;
  p.V = V, p.G = G, p.n = n, p.ctot = 0;
  for (int l = 0; l < n_levels; ++l) {
    p.level[l] = levels[l], p.ref[l] = refs[l];
    p.h[l] = dims[3 * l], p.w[l] = dims[3 * l + 1], p.c[l] = dims[3 * l + 2];
    if (p.c[l] <= 0 || p.c[l] % ch) return (int)cudaErrorInvalidValue;
    p.ctot += p.c[l];
  }
  p.K = p.ctot / ch;
  p.inv_v = 1.0f / float(V);
  const long long threads = (long long)n * G * p.K;
  if (threads >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (threads == 0 || B == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS), (unsigned)B);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_ch<__nv_bfloat16>(p, ch, grid, s) : launch_ch<float>(p, ch, grid, s));
}
