// Windowed 3-D kNN with its selection bitmask for every (G, k, window) the
// plain version takes, for Hopper (sm_90a).
//
// Replaces: pointmvsnet_tpu/ops/pallas/knn.py::_kernel (launched by
// _window_knn_impl through pallas_window_knn_mask) at the shapes the tuned
// kernel (window_knn.cu: k = 16, window 5, G ≤ 5) does not take: any odd
// window with G·win² ≤ 128 candidates and k ≤ G·(⌊win/2⌋+1)², so that a
// corner pixel still has k candidates in the image. k reaches 128 (window
// 1, G = 128) and 36 at G = 1, window 11.
//
// Same result as the plain version, bit for bit: for every hypothesis
// point (b, g, y, x) of a (G, H, W) grid, the k smallest of the packed keys
// (bits(d²) & ~0x7F) | cand_id over the G·win² candidates of its win×win
// pixel window at all G levels, cand_id = (gc·win + dy)·win + dx, nearest
// first. d² = (dx·dx + dy·dy) + dz·dz with __fmul_rn / __fadd_rn (an FMA
// moves d² by an ulp, which can flip a key across its 2^-17 quantum);
// out-of-image candidates get d² = 1e30, as in the plain version. Keys are
// unique per point (the id sits in the low 7 bits), so the k smallest and
// their order do not depend on the order of the visit. Outputs: the flat
// indices gc·H·W + yc·W + xc, nearest first, and ⌈G·win²/32⌉ int32 words
// of selection bits per point.
//
// Bound on this card: bytes at small k, operations at large k. Per point
// it reads 12 B, writes 4k B of indices and 4 B per mask word, and does 8
// flops per in-image candidate.
//
// Design: the simple kernel. One thread per query point; a block owns a
// tile of TH×32 pixels at all G levels and stages their coordinates with
// a halo of ⌊win/2⌋ pixels in dynamic shared memory as float4 (TH is the
// largest of 8, 4, 2, 1 whose tile fits 48 KB; at G = 128, window 1 even
// TH = 1 needs 64 KB, the opt-in). 256 threads loop over the tile's
// G·TH·32 points; a warp holds 32 pixels of one row and level, so its
// candidate loop is uniform. Each thread keeps a sorted list of the best
// keys: for k ≤ 8 / 16 / 32 a register array of that length (the first k
// of its sorted smallest are the k smallest), updated branch-free by
// new[i] = max(old[i-1], min(old[i], key)); above 32 a list of k keys in
// local memory with insertion. The tuned kernel's batched sorting networks
// and warp votes are not repeated here.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;               // tile columns
constexpr int THREADS = 256;
constexpr int MAX_NW = 4;            // mask words for at most 128 candidates
constexpr int MAX_K = 128;
constexpr int SMEM_FIT = 48 * 1024;  // the tile height is chosen to fit this
constexpr int SMEM_MAX = 64 * 1024;  // G = 128, window 1, TH = 1

// the k smallest keys, sorted ascending, in KM ≥ k registers
template <int KM>
struct RegList {
  int v[KM];
  __device__ __forceinline__ void init(int) {
#pragma unroll
    for (int i = 0; i < KM; ++i) v[i] = INT_MAX;
  }
  __device__ __forceinline__ void insert(int key) {
    if (key >= v[KM - 1]) return;
#pragma unroll
    for (int i = KM - 1; i > 0; --i) v[i] = max(v[i - 1], min(v[i], key));
    v[0] = min(v[0], key);
  }
  template <class Emit>
  __device__ __forceinline__ void emit(int k, Emit f) const {
#pragma unroll
    for (int i = 0; i < KM; ++i)
      if (i < k) f(i, v[i]);
  }
};

// the k smallest keys, sorted ascending, in local memory (k > 32)
struct LocalList {
  int v[MAX_K];
  int k;
  __device__ __forceinline__ void init(int k_) {
    k = k_;
    for (int i = 0; i < k; ++i) v[i] = INT_MAX;
  }
  __device__ __forceinline__ void insert(int key) {
    if (key >= v[k - 1]) return;
    int i = k - 1;
    while (i > 0 && v[i - 1] > key) {
      v[i] = v[i - 1];
      --i;
    }
    v[i] = key;
  }
  template <class Emit>
  __device__ __forceinline__ void emit(int, Emit f) const {
    for (int i = 0; i < k; ++i) f(i, v[i]);
  }
};

template <class List>
__global__ void __launch_bounds__(THREADS)
window_knn_general_kernel(const float* __restrict__ pts, int* __restrict__ idx_out,
                          int* __restrict__ mask_out, int G, int H, int W, int k, int win,
                          int th) {
  extern __shared__ float4 tile[];  // [G][th + 2r][TW + 2r]
  const int r = win / 2;
  const int sh = th + 2 * r, sw = TW + 2 * r;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * TW;
  const long long hw = (long long)H * W;
  const long long npts = G * hw;
  const float* pb = pts + (long long)b * npts * 3;

  for (int i = threadIdx.x; i < G * sh * sw; i += THREADS) {
    const int g = i / (sh * sw);
    const int rem = i - g * (sh * sw);
    const int yy = y0 + rem / sw - r;
    const int xx = x0 + rem % sw - r;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float* p = pb + (g * hw + (long long)yy * W + xx) * 3;
      c = make_float4(p[0], p[1], p[2], 0.f);
    }
    tile[i] = c;
  }
  __syncthreads();

  const int nsh = win * win;
  const int nw = (G * nsh + 31) / 32;
  const int far = __float_as_int(1e30f) & ~0x7F;   // the key of an out-of-image candidate
  for (int qi = threadIdx.x; qi < G * th * TW; qi += THREADS) {
    const int tx = qi % TW;
    const int ty = (qi / TW) % th;
    const int gq = qi / (th * TW);
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const float4 q = tile[(gq * sh + ty + r) * sw + tx + r];
    List best;
    best.init(k);
#pragma unroll 1
    for (int gc = 0; gc < G; ++gc) {
#pragma unroll 1
      for (int dy = 0; dy < win; ++dy) {
        const int yc = y + dy - r;
        const bool row_in = yc >= 0 && yc < H;
        const float4* row = tile + (gc * sh + ty + dy) * sw + tx;
        const int id0 = (gc * win + dy) * win;
#pragma unroll 1
        for (int dx = 0; dx < win; ++dx) {
          const int xc = x + dx - r;
          int key = far | (id0 + dx);
          if (row_in && xc >= 0 && xc < W) {
            const float4 c = row[dx];
            const float ex = __fsub_rn(q.x, c.x), ey = __fsub_rn(q.y, c.y),
                        ez = __fsub_rn(q.z, c.z);
            const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                       __fmul_rn(ez, ez));
            key = (__float_as_int(d2) & ~0x7F) | (id0 + dx);
          }
          best.insert(key);
        }
      }
    }

    const long long p = gq * hw + (long long)y * W + x;
    int* o = idx_out + ((long long)b * npts + p) * k;
    unsigned words[MAX_NW] = {0u, 0u, 0u, 0u};
    best.emit(k, [&](int i, int key) {
      const int cid = key & 0x7F;
      const int gc = cid / nsh;
      const int s = cid - gc * nsh;
      const int dy = s / win;
      const int dx = s - dy * win;
      o[i] = (int)(gc * hw + (long long)(y + dy - r) * W + (x + dx - r));
#pragma unroll
      for (int w = 0; w < MAX_NW; ++w)
        if ((cid >> 5) == w) words[w] |= 1u << (cid & 31);
    });
#pragma unroll
    for (int w = 0; w < MAX_NW; ++w)
      if (w < nw) mask_out[((long long)b * nw + w) * npts + p] = (int)words[w];
  }
}

template <class List>
cudaError_t launch(const float* pts, int* idx, int* mask, int B, int G, int H, int W, int k,
                   int win, cudaStream_t stream) {
  static bool attr_set = false;     // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(window_knn_general_kernel<List>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 SMEM_MAX);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int r = win / 2;
  auto smem_of = [&](int th) {
    return (size_t)G * (th + 2 * r) * (TW + 2 * r) * sizeof(float4);
  };
  int th = 8;
  while (th > 1 && smem_of(th) > SMEM_FIT) th /= 2;
  if (smem_of(th) > SMEM_MAX) return cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + th - 1) / th, B);
  window_knn_general_kernel<List><<<grid, THREADS, smem_of(th), stream>>>(
      pts, idx, mask, G, H, W, k, win, th);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// pts (B, G·H·W, 3) f32 → idx (B, G·H·W, k) int32, mask (B, NW, G, H, W)
// int32 holding the uint32 bitplanes, for odd win, G·win² ≤ 128 and
// 0 ≤ k ≤ G·(win/2 + 1)². Returns cudaGetLastError().
extern "C" int window_knn_general(const float* pts, int* idx, int* mask, int B, int G, int H,
                                  int W, int k, int win, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int r = win / 2;
  if (win < 1 || win % 2 != 1 || G < 1 || G * win * win > 128 || k < 0 ||
      k > G * (r + 1) * (r + 1) || B < 1 || B > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 8) return (int)launch<RegList<8>>(pts, idx, mask, B, G, H, W, k, win, s);
  if (k <= 16) return (int)launch<RegList<16>>(pts, idx, mask, B, G, H, W, k, win, s);
  if (k <= 32) return (int)launch<RegList<32>>(pts, idx, mask, B, G, H, W, k, win, s);
  return (int)launch<LocalList>(pts, idx, mask, B, G, H, W, k, win, s);
}
