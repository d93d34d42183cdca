// Masked window max for EdgeConv's eval fast path, for Hopper (sm_90a),
// at every window, level count and width the kNN produces.
//
// Replaces: pointmvsnet_tpu/ops/pallas/edge.py::_mwm_kernel (launched by
// masked_window_max, called from models/edge_conv.py::_fast_masked_max):
// any odd window with G·win² ≤ 128 candidates (G up to 5 at window 5, 14
// at window 3, 128 at window 1), any B and F, f32 and bf16.
//
// out[b, p, f] = max of z[b, nbr_s(p), f] over the window candidates s set
// in p's selection mask (bit s = (gc·win + dy)·win + dx of word s / 32),
// nbr_s(g, y, x) = (gc, y + dy − win/2, x + dx − win/2), folded from the
// floor −finfo(f32).max / 2 rounded to the output type, the result where
// no bit is set. The fold is max.NaN, jnp.maximum's: a NaN wins, +0 wins
// over −0 in either order (chip_smoke.py's ±0 inputs hold the card to
// that), so the result does not depend on the order of the bits and
// equals the plain version bit for bit (NaN payloads aside: the card
// returns its canonical NaN). Bits that point out of the image, or past
// level G, add nothing.
//
// Bound on this card: bytes. The function reads z and the mask words once
// and writes out once: at the 512×640 flow grid (G = 5) about 236 MB in
// bf16 at F = 32 (70 µs at 3.35 TB/s) and 446 MB at F = 64 (133 µs); the
// maxima are far below the arithmetic peak.
//
// Design. A block owns a tile of TH×32 pixels at all G levels and one
// channel chunk of 64, 32 or 16 bytes (4, 2 or 1 lanes per point). It
// copies the tile's z rows with a halo of win/2 pixels ([G][TH + 2r][32 +
// 2r] rows of one chunk) and the tile's mask words ([NW][G][TH][32]) into
// shared memory with cp.async, one warp per staged row, so that device
// memory sees each z row about (TH + 2r)·(32 + 2r) / (32·TH) times (the
// halo mostly from L2) and each mask word once per chunk, and the selected
// rows of a point come from shared memory. Rows outside the image are
// filled with the floor, so an out-of-image bit needs no test. A 128-entry
// table, built per block for (G, win), maps bit s to its row's offset in
// the window; a group of lanes walks its point's set bits one 32-bit word
// at a time, highest first (no row list), and folds each row in with
// max.NaN on 16-byte pieces (bf16x2 or f32). Where F·size is not a
// multiple of 16 or z / out are not 16-byte aligned, the pieces are staged
// and stored element by element. TH and the chunk come from
// ops/edge.py::staging_plan, which fits the buffer to 227 KB, takes the
// widest chunk that fits (on this card a 32-byte chunk of a 64- or
// 128-byte row took 1.4-2.2x the time of a 64-byte one, a 16-byte chunk
// twice that again: PERF.md §6), then two blocks per SM, then the tile
// that stages the fewest bytes: at the model's G = 5, window 5, F 32 and
// 64, a 4×32 tile and 64-byte chunks. SMEM_PER_BLOCK, the shared memory a
// block may use, comes from ops/_cuda.py's nvcc flags. The grid is one
// dimension of B·chunks·tiles blocks; a block splits its index with 32-bit
// divisions, once. What was tried and lost (PERF.md): one warp per point
// with lanes over F and the mask decoded into a row list (~300
// warp-instructions a point, every row read ~16 times from L1/L2); one
// persistent block per SM copying the next tile while folding this one;
// loading 2 or 4 bits' rows before folding them. The TPU kernel's rolls,
// per-level mask repack and f32 upcast served its vector unit and are not
// needed. The +c2 / ReLU epilogue stays in PyTorch.

#include <cfloat>
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;                 // tile columns: one warp's points of a row
constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_NW = 4;              // mask words for at most 128 candidates
constexpr int TABLE_BYTES = MAX_NW * 32 * (int)sizeof(int);

__device__ __forceinline__ unsigned max_nan(unsigned a, unsigned b, float) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
  return __float_as_uint(r);
}

__device__ __forceinline__ unsigned max_nan(unsigned a, unsigned b, __nv_bfloat16) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  const __nv_bfloat162 m = __hmax2_nan(x, y);
  unsigned r;
  memcpy(&r, &m, 4);
  return r;
}

template <typename T> __device__ __forceinline__ unsigned floor_bits();
template <> __device__ __forceinline__ unsigned floor_bits<float>() {
  return __float_as_uint(-FLT_MAX * 0.5f);
}
template <> __device__ __forceinline__ unsigned floor_bits<__nv_bfloat16>() {
  const __nv_bfloat16 v = __float2bfloat16_rn(-FLT_MAX * 0.5f);
  unsigned short u;
  memcpy(&u, &v, 2);
  return (unsigned)u * 0x10001u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

// PIECES: 16-byte pieces per chunk (lanes per point); lth = log2(TH);
// vec: F·sizeof(T) is a multiple of 16 and z, out are 16-byte aligned
template <typename T, int PIECES>
__global__ void __launch_bounds__(THREADS, 2)
masked_window_max_kernel(const T* __restrict__ z, const int* __restrict__ mask,
                                 T* __restrict__ out, int G, int H, int W, int F, int win,
                                 int lth, int nx, int ny, int nchunk, bool vec) {
  constexpr int EPV = 16 / sizeof(T);            // elements per 16-byte piece
  constexpr int CH = PIECES * EPV;               // elements per chunk
  constexpr int GROUPS = THREADS / PIECES;       // points folded at once
  extern __shared__ uint4 rows[];                // z rows, then the mask words
  __shared__ int row_of[MAX_NW * 32];            // bit s → offset in the window, in uint4

  const int th = 1 << lth;
  const int r = win / 2;
  const int sh = th + 2 * r, sw = TW + 2 * r;
  const int nsh = win * win;
  const int nw = (G * nsh + 31) / 32;
  const int last_bits = G * nsh - 32 * (nw - 1);
  const unsigned last_mask = last_bits >= 32 ? ~0u : (1u << last_bits) - 1u;
  // blockIdx.x = ((b·nchunk + chunk)·ny + tile row)·nx + tile column
  unsigned t = blockIdx.x;
  const int x0 = (int)(t % nx) * TW;
  t /= nx;
  const int y0 = (int)(t % ny) * th;
  t /= ny;
  const int f_chunk = (int)(t % nchunk) * CH;
  const int b = (int)(t / nchunk);
  const long long hw = (long long)H * W;
  const long long npts = G * hw;
  const unsigned neg = floor_bits<T>();
  const uint4 neg4 = make_uint4(neg, neg, neg, neg);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < MAX_NW * 32) {
    const int gc = tid / nsh, s = tid - gc * nsh;
    row_of[tid] = ((gc * sh + s / win) * sw + s % win) * PIECES;
  }
  // the tile's z rows with their halo, one warp per (level, row); the
  // floor outside the image
  const T* zb = z + (long long)b * npts * F + f_chunk;
  const int row_pieces = sw * PIECES;
  for (int row = warp; row < G * sh; row += NWARPS) {
    const int g = row / sh;
    const int yy = y0 + row - g * sh - r;
    const bool row_in = yy >= 0 && yy < H;
    uint4* dst = rows + row * row_pieces;
    for (int c = lane; c < row_pieces; c += 32) {
      const int q = c % PIECES;
      const int xx = x0 + c / PIECES - r;
      if (!row_in || xx < 0 || xx >= W) {
        dst[c] = neg4;
        continue;
      }
      const T* src = zb + (g * hw + (long long)yy * W + xx) * F + q * EPV;
      if (vec) {
        if (f_chunk + q * EPV < F) cp_async16(&dst[c], src);
      } else {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        T* v = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int e = 0; e < EPV; ++e)
          if (f_chunk + q * EPV + e < F) v[e] = src[e];
        dst[c] = u;
      }
    }
  }
  // the tile's mask words, one warp per (word, level, row), 4 bytes each
  // (a row of the tile is not 16-byte aligned in general); words of points
  // outside the image are never read
  unsigned* words = reinterpret_cast<unsigned*>(rows + G * sh * row_pieces);
  const int* mb = mask + (long long)b * nw * npts;
  for (int row = warp; row < nw * G * th; row += NWARPS) {
    const int y = y0 + (row & (th - 1)), x = x0 + lane;
    if (y < H && x < W)
      cp_async4(&words[row * TW + lane], mb + (row >> lth) * hw + (long long)y * W + x);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int q = tid % PIECES;
  const int f0 = f_chunk + q * EPV;
  const int npt = G * th * TW;                   // points of the tile, all levels
  for (int pi = tid / PIECES; pi < npt; pi += GROUPS) {
    const int tx = pi & (TW - 1);
    const int ty = (pi >> 5) & (th - 1);
    const int g = pi >> (5 + lth);
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const uint4* window = rows + (ty * sw + tx) * PIECES + q;
    uint4 acc = neg4;
#pragma unroll
    for (int k = 0; k < MAX_NW; ++k) {
      if (k >= nw) break;
      unsigned m = words[k * npt + pi] & (k == nw - 1 ? last_mask : ~0u);
      while (m) {
        const int s = 31 - __clz(m);                 // the highest set bit
        m ^= 1u << s;
        const uint4 v = window[row_of[32 * k + s]];
        acc.x = max_nan(acc.x, v.x, T());
        acc.y = max_nan(acc.y, v.y, T());
        acc.z = max_nan(acc.z, v.z, T());
        acc.w = max_nan(acc.w, v.w, T());
      }
    }
    T* dst = out + ((long long)b * npts + g * hw + (long long)y * W + x) * F + f0;
    if (vec) {
      if (f0 < F) *reinterpret_cast<uint4*>(dst) = acc;
    } else {
      const T* v = reinterpret_cast<const T*>(&acc);
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        if (f0 + e < F) dst[e] = v[e];
    }
  }
}

template <typename T, int PIECES>
cudaError_t launch(const void* z, const int* mask, void* out, int B, int G, int H, int W,
                   int F, int win, int lth, size_t smem, cudaStream_t stream) {
  static bool attr_set = false;       // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_window_max_kernel<T, PIECES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_PER_BLOCK - TABLE_BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int ch = PIECES * 16 / (int)sizeof(T);
  const long long nchunk = ((long long)F + ch - 1) / ch;
  const long long nx = (W + TW - 1) / TW, ny = (H + (1 << lth) - 1) >> lth;
  const long long blocks = nx * ny * nchunk * B;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = ((long long)F * sizeof(T)) % 16 == 0 && (uintptr_t)z % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  masked_window_max_kernel<T, PIECES><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(z), mask, static_cast<T*>(out), G, H, W, F, win, lth, (int)nx,
      (int)ny, (int)nchunk, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chunk(const void* z, const int* mask, void* out, int B, int G, int H,
                         int W, int F, int win, int lth, int chunk_bytes, size_t smem,
                         cudaStream_t s) {
  if (chunk_bytes == 64)
    return launch<T, 4>(z, mask, out, B, G, H, W, F, win, lth, smem, s);
  if (chunk_bytes == 32)
    return launch<T, 2>(z, mask, out, B, G, H, W, F, win, lth, smem, s);
  return launch<T, 1>(z, mask, out, B, G, H, W, F, win, lth, smem, s);
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// z (B, G·H·W, F) f32 (is_bf16 = 0) or bf16 (1); mask (B, NW, G, H, W)
// int32 bitplanes, NW = ⌈G·win²/32⌉, odd win, G·win² ≤ 128 → out like z.
// tile_rows (1, 2, 4 or 8) and chunk_bytes (16, 32 or 64): the staging
// plan, whose buffer must fit this card's 227 KB. Returns
// cudaGetLastError().
extern "C" int masked_window_max(const void* z, const int* mask, void* out, int B, int G,
                                 int H, int W, int F, int win, int tile_rows, int chunk_bytes,
                                 int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (win < 1 || win % 2 != 1 || G < 1 || G * win * win > 128 || B < 0 || H < 1 || W < 1 ||
      F < 0)
    return (int)cudaErrorInvalidValue;
  int lth = 0;
  while (lth < 3 && (1 << lth) < tile_rows) ++lth;
  if ((1 << lth) != tile_rows || (chunk_bytes != 16 && chunk_bytes != 32 && chunk_bytes != 64))
    return (int)cudaErrorInvalidValue;
  const int r = win / 2, nw = (G * win * win + 31) / 32;
  const size_t smem = (size_t)G * (tile_rows + 2 * r) * (TW + 2 * r) * chunk_bytes +
                      (size_t)nw * G * tile_rows * TW * 4;
  if (smem + TABLE_BYTES > (size_t)SMEM_PER_BLOCK) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return (int)launch_chunk<__nv_bfloat16>(z, mask, out, B, G, H, W, F, win, lth,
                                            chunk_bytes, smem, s);
  return (int)launch_chunk<float>(z, mask, out, B, G, H, W, F, win, lth, chunk_bytes, smem, s);
}
