// Masked window max for EdgeConv's eval fast path, for Hopper (sm_90a).
//
// Replaces: pointmvsnet_tpu/ops/pallas/edge.py::_mwm_kernel (launched by
// masked_window_max, called from models/edge_conv.py::_fast_masked_max).
// out[b, p, f] = max of z[b, nbr_s(p), f] over the window candidates s set
// in p's selection mask (bit s = gc·25 + dy·5 + dx of word s / 32), where
// nbr_s(g, y, x) = (gc, y + dy − 2, x + dx − 2); −finfo(f32).max / 2
// (rounded to the output type) where no in-image candidate is set, which
// the kNN never produces. Candidates are visited in increasing s and a
// value replaces the running max only when strictly greater, as in the
// plain version, so the two agree bit for bit.
//
// Bound on this card: bytes. The function reads z and the 4 mask words
// once and writes out once: at the 512×640 flow grid (G = 5) about 236 MB
// in bf16 at F = 32 (70 µs at 3.35 TB/s) and 446 MB at F = 64 (133 µs);
// the 16 maxima per output value are far below the arithmetic peak.
//
// Design: one warp per point with lanes over F, so each neighbour row
// (64 B at F = 32 in bf16, 128 B at F = 64) is one coalesced read; 16 rows
// per point instead of the 125-way scan. Reading the rows one after the
// other leaves the warp waiting on one load at a time, so the kernel works
// in two passes: lane l decodes candidate 32·w + l of each mask word (its
// rank among the set bits is a popcount) into the warp's row list in
// shared memory, then the warp loads the listed rows 8 at a time, all 8 in
// flight together, and folds them into the running max in list order
// (= increasing s). Neighbour rows repeat across nearby points, and the
// 5 levels × 5 rows × W working set of neighbouring warps stays in L2. The
// comparison runs in f32 and the stored value is one of the inputs, so
// bf16 is exact. The TPU kernel's roll trick, per-level mask repack and
// f32 upcast served its vector unit and are not needed here. The +c2 /
// ReLU epilogue stays in PyTorch.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 5;
constexpr int R = WIN / 2;
constexpr int NSH = WIN * WIN;
constexpr int WARPS = 8;
constexpr int MAX_CAND = 128;  // 4 mask words

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// NF = values per lane (F ≤ 32·NF)
template <typename T, int NF>
__global__ void __launch_bounds__(WARPS * 32)
masked_window_max_kernel(const T* __restrict__ z, const int* __restrict__ mask,
                         T* __restrict__ out, int B, int G, int H, int W, int F) {
  __shared__ int rows[WARPS][MAX_CAND];  // per warp: selected rows, -1 = outside
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long hw = (long long)H * W;
  const long long npts = G * hw;
  if (warp >= B * npts) return;
  const long long b = warp / npts;
  const long long p = warp - b * npts;
  const long long pix = p % hw;
  const int y = (int)(pix / W);
  const int x = (int)(pix - (long long)y * W);
  const int nw = (G * NSH + 31) / 32;

  // pass 1: the set bits of the mask, in increasing s, as row indices
  int n = 0;
  for (int w = 0; w < nw; ++w) {
    const unsigned word = (unsigned)__ldg(mask + (b * nw + w) * npts + p);
    if ((word >> lane) & 1u) {
      const int s = 32 * w + lane;
      const int gc = s / NSH;
      const int r2 = s - gc * NSH;
      const int yc = y + r2 / WIN - R;
      const int xc = x + r2 % WIN - R;
      const bool inside = gc < G && yc >= 0 && yc < H && xc >= 0 && xc < W;
      rows[wib][n + __popc(word & ((1u << lane) - 1u))] =
          inside ? (int)(gc * hw + (long long)yc * W + xc) : -1;
    }
    n += __popc(word);
  }
  __syncwarp();

  // pass 2: 8 row loads in flight at a time, folded in list order
  const float neg = to_f(from_f<T>(-FLT_MAX * 0.5f));
  float acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j] = neg;
  const T* zb = z + b * npts * F;
  for (int i0 = 0; i0 < n; i0 += 8) {
    float v[8][NF];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i0 + i < n ? rows[wib][i0 + i] : -1;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int f = lane + 32 * j;
        v[i][j] = (r >= 0 && f < F) ? to_f(zb[(long long)r * F + f]) : neg;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
        if (v[i][j] > acc[j]) acc[j] = v[i][j];
  }
  T* orow = out + (b * npts + p) * F;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int f = lane + 32 * j;
    if (f < F) orow[f] = from_f<T>(acc[j]);
  }
}

template <typename T>
void launch(const void* z, const int* mask, void* out, int B, int G, int H, int W,
            int F, cudaStream_t stream) {
  const long long warps = (long long)B * G * H * W;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  const T* zt = static_cast<const T*>(z);
  T* ot = static_cast<T*>(out);
  if (F <= 32)
    masked_window_max_kernel<T, 1><<<blocks, WARPS * 32, 0, stream>>>(zt, mask, ot, B, G, H, W, F);
  else if (F <= 64)
    masked_window_max_kernel<T, 2><<<blocks, WARPS * 32, 0, stream>>>(zt, mask, ot, B, G, H, W, F);
  else
    masked_window_max_kernel<T, 4><<<blocks, WARPS * 32, 0, stream>>>(zt, mask, ot, B, G, H, W, F);
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// z (B, G·H·W, F) f32 (is_bf16 = 0) or bf16 (1), F ≤ 128; mask
// (B, NW, G, H, W) int32 bitplanes → out like z. Returns cudaGetLastError().
extern "C" int masked_window_max(const void* z, const int* mask, void* out, int B,
                                 int G, int H, int W, int F, int is_bf16, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (is_bf16)
    launch<__nv_bfloat16>(z, mask, out, B, G, H, W, F, (cudaStream_t)stream);
  else
    launch<float>(z, mask, out, B, G, H, W, F, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
