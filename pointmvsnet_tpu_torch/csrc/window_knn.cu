// Windowed 3-D kNN with its selection bitmask, for Hopper (sm_90a).
//
// Replaces: pointmvsnet_tpu/ops/pallas/knn.py::_kernel (launched by
// _window_knn_impl through pallas_window_knn_mask). Same result, bit for
// bit: for every hypothesis point (b, g, y, x) of a (G, H, W) grid, the
// K = 16 nearest among the G·5·5 candidates of its 5×5 pixel window over
// all G levels, ranked by the packed key (bits(d²) & ~0x7F) | cand_id with
// cand_id = gc·25 + dy·5 + dx, so ties and sub-quantum differences go to
// the lower id. Out-of-image candidates are never chosen.
//
// Bound on this card: bytes. Per point the function reads 12 B of
// coordinates and writes 64 B of indices and 4 B per mask word; at the
// 512×640 flow grid (G = 5) that is about 151 MB, 45 µs at 3.35 TB/s,
// against about 1.6 GFLOP of f32 distance arithmetic (25 µs at 67 TFLOP/s).
//
// Design: a block owns a 4×32-pixel tile and stages the coordinates of
// all G levels with a 2-pixel halo in shared memory (G·8·36·12 B, 17 KB
// at G = 5), so device memory is read about 2.3 times per coordinate
// instead of 125 times. One thread per query point (g, y, x): the block is
// 32 × 4 × G threads. Each scans the in-image candidates from shared
// memory (lanes stride 3 words: no bank conflicts) and keeps the 16
// smallest keys in a sorted list in registers. It then writes its 16 flat
// indices gc·H·W + yc·W + xc, nearest first, as four 16-byte stores, and
// its mask words, coalesced across the warp. The TPU kernel's
// shifted-view copies and column split do not exist here.
//
// d² = (dx·dx + dy·dy) + dz·dz, in exactly that order and without
// contraction (__fmul_rn / __fadd_rn): an FMA moves d² by an ulp, which can
// flip a key across its 2^-17 quantum and break bit-equality with the plain
// version.

#include <cuda_runtime.h>

namespace {

constexpr int K = 16;
constexpr int WIN = 5;
constexpr int R = WIN / 2;
constexpr int NSH = WIN * WIN;
constexpr int MAX_NW = 4;  // mask words for at most 128 candidates
constexpr int TH = 4;
constexpr int MAX_G = 5;      // G·25 ≤ 128 candidates
constexpr int TW = 32;
constexpr int SH = TH + 2 * R;
constexpr int SW = TW + 2 * R;

__global__ void __launch_bounds__(TH * TW * MAX_G)
window_knn_kernel(const float* __restrict__ pts, int* __restrict__ idx_out,
                  int* __restrict__ mask_out, int G, int H, int W) {
  extern __shared__ float tile[];  // [G][SH][SW][3]
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int gq = threadIdx.z;
  const int tid = (gq * TH + threadIdx.y) * TW + threadIdx.x;
  const int nthreads = TH * TW * G;
  const long long hw = (long long)H * W;
  const long long npts = G * hw;
  const float* pb = pts + (long long)b * npts * 3;

  for (int i = tid; i < G * SH * SW; i += nthreads) {
    const int g = i / (SH * SW);
    const int rem = i - g * (SH * SW);
    const int sy = rem / SW;
    const int sx = rem - sy * SW;
    const int yy = y0 + sy - R;
    const int xx = x0 + sx - R;
    float cx = 0.f, cy = 0.f, cz = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float* p = pb + (g * hw + (long long)yy * W + xx) * 3;
      cx = p[0];
      cy = p[1];
      cz = p[2];
    }
    tile[i * 3 + 0] = cx;
    tile[i * 3 + 1] = cy;
    tile[i * 3 + 2] = cz;
  }
  __syncthreads();

  const int ty = threadIdx.y;
  const int tx = threadIdx.x;
  const int y = y0 + ty;
  const int x = x0 + tx;
  if (y >= H || x >= W) return;
  // in-image part of the window: skipping the rest equals the reference's
  // far sentinel, since a corner still has G·3·3 ≥ 16 candidates
  const int dy_lo = max(0, R - y);
  const int dy_hi = min(WIN - 1, R + (H - 1 - y));
  const int dx_lo = max(0, R - x);
  const int dx_hi = min(WIN - 1, R + (W - 1 - x));
  const int nw = (G * NSH + 31) / 32;

  const float* q = tile + ((gq * SH + ty + R) * SW + tx + R) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  int best[K];
#pragma unroll
  for (int i = 0; i < K; ++i) best[i] = 0x7FFFFFFF;

  for (int gc = 0; gc < G; ++gc) {
    for (int dy = dy_lo; dy <= dy_hi; ++dy) {
      const float* row = tile + ((gc * SH + ty + dy) * SW + tx) * 3;
      for (int dx = dx_lo; dx <= dx_hi; ++dx) {
        const float ex = row[dx * 3 + 0] - qx;
        const float ey = row[dx * 3 + 1] - qy;
        const float ez = row[dx * 3 + 2] - qz;
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                   __fmul_rn(ez, ez));
        const int key = (__float_as_int(d2) & ~0x7F) | (gc * NSH + dy * WIN + dx);
        if (key < best[K - 1]) {
          // insertion into the sorted list; keys are unique per point
#pragma unroll
          for (int i = K - 1; i > 0; --i) {
            const int prev = best[i - 1];
            best[i] = key < prev ? prev : (key < best[i] ? key : best[i]);
          }
          best[0] = key < best[0] ? key : best[0];
        }
      }
    }
  }

  const long long p = gq * hw + (long long)y * W + x;
  int vals[K];
  unsigned words[MAX_NW] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int cid = best[i] & 0x7F;
    const int gc = cid / NSH;
    const int s = cid - gc * NSH;
    const int dy = s / WIN;
    const int dx = s - dy * WIN;
    vals[i] = (int)(gc * hw + (long long)(y + dy - R) * W + (x + dx - R));
#pragma unroll
    for (int w = 0; w < MAX_NW; ++w)
      if ((cid >> 5) == w) words[w] |= 1u << (cid & 31);
  }
  int4* o4 = reinterpret_cast<int4*>(idx_out + ((long long)b * npts + p) * K);
#pragma unroll
  for (int j = 0; j < K / 4; ++j)
    o4[j] = make_int4(vals[4 * j], vals[4 * j + 1], vals[4 * j + 2], vals[4 * j + 3]);
#pragma unroll
  for (int w = 0; w < MAX_NW; ++w)
    if (w < nw) mask_out[((long long)b * nw + w) * npts + p] = (int)words[w];
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// pts (B, G·H·W, 3) f32 → idx (B, G·H·W, 16) int32, mask (B, NW, G, H, W)
// int32 holding the uint32 bitplanes. Returns cudaGetLastError().
extern "C" int window_knn(const float* pts, int* idx, int* mask, int B, int G,
                          int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G > MAX_G) return (int)cudaErrorInvalidValue;
  const dim3 block(TW, TH, G);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const size_t smem = (size_t)G * SH * SW * 3 * sizeof(float);
  window_knn_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(pts, idx, mask, G, H, W);
  return (int)cudaGetLastError();
}
