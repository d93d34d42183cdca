// Masked window max for EdgeConv's eval fast path, for Hopper (sm_90a).
//
// Replaces: pointmvsnet_tpu/ops/pallas/edge.py::_mwm_kernel (launched by
// masked_window_max, called from models/edge_conv.py::_fast_masked_max).
// out[b, p, f] = max of z[b, nbr_s(p), f] over the window candidates s set
// in p's selection mask (bit s = gc·25 + dy·5 + dx of word s / 32), where
// nbr_s(g, y, x) = (gc, y + dy − 2, x + dx − 2), folded from the floor
// −finfo(f32).max / 2 (rounded to the output type), which is the result
// where no bit is set. The fold is jnp.maximum's: a NaN wins, +0 wins over
// −0, and equal values are bit-identical otherwise, so the result does not
// depend on the order of the candidates and equals the plain version bit
// for bit (NaN payloads aside: the card returns its canonical NaN). Bits
// that point outside the image, or at a level ≥ G, add nothing.
//
// Bound on this card: bytes. The function reads z and the mask words once
// and writes out once: at the 512×640 flow grid (G = 5) about 236 MB in
// bf16 at F = 32 (70 µs at 3.35 TB/s) and 446 MB at F = 64 (133 µs); the
// 16 maxima per output value are far below the arithmetic peak.
//
// Design. The first design (one warp per point, lanes over F, the mask
// decoded into a row list) spent ~300 warp-instructions per point and read
// every z row ~16 times from L1/L2. Here a block owns a tile of 4×32
// pixels at all G levels and one 64-byte chunk of the channels (32 bf16 or
// 16 f32; the chunk is in blockIdx.z). It copies the tile's z rows with a
// 2-pixel halo (G·8·36 rows × 64 B = 92 KB at G = 5) and its mask words
// (10 KB) into shared memory with cp.async, so device memory sees each z
// row about 2.25 times (the halo, mostly from L2) and the 16 selected rows
// per point come from shared memory; two blocks fit an SM. Rows outside
// the image are filled with the floor, so an out-of-image bit needs no
// test. Each point gets a group of 4 lanes, one 16-byte piece of the chunk
// each, so a warp folds 8 points at once. A group walks its own set bits
// one 32-bit word at a time, highest bit first (no row list), maps each
// bit to a shared-memory row through a 128-entry table, and folds the row
// in with max.NaN (bf16x2 or f32): 13 instructions per bit. max.NaN on
// this card returns NaN if either input is NaN and +0 for (−0, +0) in
// either order; chip_smoke.py's ±0 inputs hold it to that. Outputs leave
// as 16-byte stores. What was tried and lost (PERF.md): one persistent
// block per SM copying the next tile while folding this one (fewer warps,
// slower), and loading 2 or 4 bits' rows before folding them. The TPU
// kernel's rolls, per-level mask repack and f32 upcast served its vector
// unit and are not needed. The +c2 / ReLU epilogue stays in PyTorch.

#include <cfloat>
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WIN = 5;
constexpr int R = WIN / 2;
constexpr int NSH = WIN * WIN;
constexpr int MAX_G = 5;
constexpr int MAX_NW = 4;              // mask words for at most 128 candidates
constexpr int TH = 4;                  // tile rows
constexpr int TW = 32;                 // tile columns
constexpr int SH = TH + 2 * R;
constexpr int SW = TW + 2 * R;
constexpr int CHUNK_BYTES = 64;        // channels per tile: one 64-byte chunk
constexpr int PIECES = CHUNK_BYTES / 16;  // lanes per point
constexpr int THREADS = 512;
constexpr int GROUPS = THREADS / PIECES;
// shared memory, in uint4: z rows [G][SH][SW][PIECES], then mask words [NW][G][TH][TW]
constexpr int BUF_ROWS = MAX_G * SH * SW * PIECES;
constexpr int BUF_U4 = BUF_ROWS + MAX_NW * MAX_G * TH * TW / 4;
constexpr int SMEM_BYTES = BUF_U4 * 16;   // 102,400: two blocks per SM

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

// start the copies of the tile at (y0, x0), channels from f_chunk, of batch
// b into buf: z rows (16-byte cp.async, or loads and stores where vec is
// false), the floor outside the image, mask words; the caller waits
template <typename T>
__device__ __forceinline__ void stage(uint4* buf, int b, int f_chunk, int y0, int x0,
                                      const T* z, const int* mask, int G, int H, int W,
                                      int F, bool vec, uint4 neg4) {
  constexpr int EPV = 16 / sizeof(T);
  const long long hw = (long long)H * W;
  const long long npts = G * hw;
  const T* zb = z + (long long)b * npts * F;
  for (int i = threadIdx.x; i < G * SH * SW * PIECES; i += THREADS) {
    const int row = i / PIECES;
    const int q = i - row * PIECES;
    const int g = row / (SH * SW);
    const int rem = row - g * (SH * SW);
    const int yy = y0 + rem / SW - R;
    const int xx = x0 + rem % SW - R;
    const int f0 = f_chunk + q * EPV;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) {
      buf[i] = neg4;                             // outside: the floor adds nothing
      continue;
    }
    const T* src = zb + (g * hw + (long long)yy * W + xx) * F + f0;
    if (vec) {
      if (f0 < F) cp_async16(&buf[i], src);
    } else {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      T* v = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        if (f0 + e < F) v[e] = src[e];
      buf[i] = u;
    }
  }
  // the mask words, 4 bytes each (a row of the tile is not 16-byte aligned
  // in general); words of points outside the image are never read
  const int nw = (G * NSH + 31) / 32;
  const int* mb = mask + (long long)b * nw * npts;
  unsigned* words = reinterpret_cast<unsigned*>(buf + BUF_ROWS);
  for (int i = threadIdx.x; i < nw * G * TH * TW; i += THREADS) {
    const int k = i / (G * TH * TW);
    const int rem = i - k * (G * TH * TW);
    const int g = rem / (TH * TW);
    const int y = y0 + (rem / TW) % TH, x = x0 + rem % TW;
    if (y < H && x < W) cp_async4(&words[i], mb + k * npts + g * hw + (long long)y * W + x);
  }
}

// vec: F·sizeof(T) is a multiple of 16 and z, out are 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
masked_window_max_kernel(const T* __restrict__ z, const int* __restrict__ mask,
                         T* __restrict__ out, int G, int H, int W, int F,
                         int nchunk, bool vec) {
  constexpr int EPV = 16 / sizeof(T);            // elements per 16-byte piece
  constexpr int CH = CHUNK_BYTES / sizeof(T);    // elements per chunk
  extern __shared__ uint4 rows[];                // BUF_U4
  __shared__ int row_of[MAX_NW * 32];            // bit s → offset in the window, in uint4

  const int tid = threadIdx.x;
  const long long hw = (long long)H * W;
  const long long npts = G * hw;
  const unsigned neg = floor_bits<T>();
  const uint4 neg4 = make_uint4(neg, neg, neg, neg);
  const int nw = (G * NSH + 31) / 32;
  const int last_bits = G * NSH - 32 * (nw - 1);
  const unsigned last_mask = last_bits >= 32 ? ~0u : (1u << last_bits) - 1u;
  const int q = tid % PIECES;

  if (tid < MAX_NW * 32) {
    const int gc = tid / NSH, r2 = tid - gc * NSH;
    row_of[tid] = ((gc * SH + r2 / WIN) * SW + r2 % WIN) * PIECES;
  }
  const int b = blockIdx.z / nchunk;
  const int f_chunk = (blockIdx.z - b * nchunk) * CH;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  stage(rows, b, f_chunk, y0, x0, z, mask, G, H, W, F, vec, neg4);
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;" ::: "memory");
  __syncthreads();

  const unsigned* words = reinterpret_cast<const unsigned*>(rows + BUF_ROWS);
  const int f0 = f_chunk + q * EPV;
  for (int pi = tid / PIECES; pi < G * TH * TW; pi += GROUPS) {
    const int tx = pi % TW;
    const int ty = (pi / TW) % TH;
    const int g = pi / (TH * TW);
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const uint4* win = rows + (ty * SW + tx) * PIECES + q;
    uint4 acc = neg4;
#pragma unroll
    for (int k = 0; k < MAX_NW; ++k) {
      if (k >= nw) break;
      unsigned m = words[k * (G * TH * TW) + pi] & (k == nw - 1 ? last_mask : ~0u);
      while (m) {
        const int s = 31 - __clz(m);                 // the highest set bit
        m ^= 1u << s;
        const uint4 v = win[row_of[32 * k + s]];
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

template <typename T>
cudaError_t launch(const void* z, const int* mask, void* out, int B, int G, int H, int W,
                   int F, cudaStream_t stream) {
  static bool attr_set = false;       // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_window_max_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int ch = CHUNK_BYTES / (int)sizeof(T);
  const int nchunk = (F + ch - 1) / ch;
  const bool vec = (F * sizeof(T)) % 16 == 0 && (uintptr_t)z % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * nchunk);
  masked_window_max_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(z), mask, static_cast<T*>(out), G, H, W, F, nchunk, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// z (B, G·H·W, F) f32 (is_bf16 = 0) or bf16 (1), G ≤ 5, F ≤ 128; mask
// (B, NW, G, H, W) int32 bitplanes → out like z. Returns cudaGetLastError().
extern "C" int masked_window_max(const void* z, const int* mask, void* out, int B,
                                 int G, int H, int W, int F, int is_bf16, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G > MAX_G || B * ((F * (is_bf16 ? 2 : 4) + CHUNK_BYTES - 1) / CHUNK_BYTES) > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(z, mask, out, B, G, H, W, F, (cudaStream_t)stream);
  return (int)launch<float>(z, mask, out, B, G, H, W, F, (cudaStream_t)stream);
}
