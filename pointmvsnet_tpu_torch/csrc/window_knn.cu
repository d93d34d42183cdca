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
// Design. The first design inserted each candidate into a sorted register
// list under a branch that some lane of the warp took on nearly every one
// of the 125 candidates: ~64 instructions of insertion per candidate. Here
// the expensive step is warp-uniform and branch-free. Keys are unique per
// point (the id sits in the low 7 bits), so the 16 smallest and their
// order do not depend on the order of the visit, and the candidates come
// in batches: the inner 3×3 of each level (nearest level first: own level,
// then ±1, ±2, ...), then the outer 16-pixel ring of each level in the same
// order, so the threshold best[15] tightens early. The own level's inner
// 9 keys, sorted, are the first best list. Every later batch is sorted
// (9 keys: a 25-comparator network; 16 keys: a bitonic network of 80
// compare-exchanges) and merged into the best list by one bitonic merge
// (16 mins and 32 compare-exchanges), unless no lane of the warp has a
// key below its threshold (__any_sync). A block owns a 2×32-pixel tile at
// all G levels (one thread per query point, 64·G threads, 3 blocks per SM;
// a warp = 32 pixels of one row and level, so the level order is
// warp-uniform) and stages the coordinates with a 2-pixel halo in shared
// memory as float4 (G·6·36·16 B, 17 KB at G = 5): one 16-byte load per
// candidate. A block whose tile and halo lie inside the image (most) skips
// the in-image test. It writes its 16 flat indices gc·H·W + yc·W + xc,
// nearest first, as four 16-byte stores, and its mask words, coalesced
// across the warp.
//
// d² = (dx·dx + dy·dy) + dz·dz, in exactly that order and without
// contraction (__fmul_rn / __fadd_rn): an FMA moves d² by an ulp, which can
// flip a key across its 2^-17 quantum and break bit-equality with the plain
// version.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int K = 16;
constexpr int WIN = 5;
constexpr int R = WIN / 2;
constexpr int NSH = WIN * WIN;
constexpr int MAX_NW = 4;     // mask words for at most 128 candidates
constexpr int MAX_G = 5;      // G·25 ≤ 128 candidates
constexpr int TH = 2;
constexpr int TW = 32;
constexpr int SH = TH + 2 * R;
constexpr int SW = TW + 2 * R;
// window position dy·5 + dx of the j-th candidate of the inner 3×3
// (j < 9) and of the outer ring (j < 16: the top row, the sides of rows
// 1-3, the bottom row)
__host__ __device__ constexpr int inner_pos(int j) { return (1 + j / 3) * WIN + 1 + j % 3; }
__host__ __device__ constexpr int outer_pos(int j) {
  return j < 5 ? j : j < 11 ? (1 + (j - 5) / 2) * WIN + (j - 5) % 2 * 4 : j + 9;
}
// the o-th level offset, nearest first: 0, −1, +1, −2, +2, ...
__host__ __device__ constexpr int level_offset(int o) { return o & 1 ? -(o + 1) / 2 : o / 2; }

__device__ __forceinline__ void cas(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// sort 16 keys ascending (bitonic network)
__device__ __forceinline__ void sort16(int (&v)[K]) {
#pragma unroll
  for (int lk = 1; lk <= 4; ++lk)
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int k = 1 << lk, j = 1 << lj;
        const int l = i ^ j;
        if (l > i) {
          if ((i & k) == 0) cas(v[i], v[l]);
          else cas(v[l], v[i]);
        }
      }
}

// sort the first 9 keys ascending (25 compare-exchanges); the pads stay
__device__ __forceinline__ void sort9(int (&v)[K]) {
  cas(v[0], v[1]); cas(v[3], v[4]); cas(v[6], v[7]); cas(v[1], v[2]); cas(v[4], v[5]);
  cas(v[7], v[8]); cas(v[0], v[1]); cas(v[3], v[4]); cas(v[6], v[7]); cas(v[0], v[3]);
  cas(v[3], v[6]); cas(v[0], v[3]); cas(v[1], v[4]); cas(v[4], v[7]); cas(v[1], v[4]);
  cas(v[2], v[5]); cas(v[5], v[8]); cas(v[2], v[5]); cas(v[1], v[3]); cas(v[5], v[7]);
  cas(v[2], v[6]); cas(v[4], v[6]); cas(v[2], v[4]); cas(v[2], v[3]); cas(v[5], v[6]);
}

// best ← the 16 smallest of best ∪ batch, ascending; both sorted ascending
__device__ __forceinline__ void merge16(int (&best)[K], const int (&batch)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) best[i] = min(best[i], batch[K - 1 - i]);  // bitonic
#pragma unroll
  for (int lj = 3; lj >= 0; --lj)
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int l = i ^ (1 << lj);
      if (l > i) cas(best[i], best[l]);
    }
}

// keys of level gc's candidates in the inner 3×3 (9; the slots past them
// stay INT_MAX) or in the outer ring (16); win = the window's corner
template <bool OUTER>
__device__ __forceinline__ void batch_keys(int (&key)[K], const float4* win, float4 q,
                                           int id0, unsigned in_image) {
  constexpr int N = OUTER ? 16 : 9;
#pragma unroll
  for (int j = 0; j < K; ++j) key[j] = INT_MAX;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int s = OUTER ? outer_pos(j) : inner_pos(j);
    const float4 c = win[(s / WIN) * SW + s % WIN];
    const float ex = c.x - q.x, ey = c.y - q.y, ez = c.z - q.z;
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                               __fmul_rn(ez, ez));
    const int k = (__float_as_int(d2) & ~0x7F) | (id0 + s);
    key[j] = (in_image >> s) & 1u ? k : INT_MAX;
  }
}

template <bool OUTER>
__device__ __forceinline__ void fold_batch(int (&best)[K], int (&key)[K]) {
  bool below = false;
#pragma unroll
  for (int j = 0; j < (OUTER ? K : 9); ++j) below |= key[j] < best[K - 1];
  if (!__any_sync(0xffffffffu, below)) return;   // warp-uniform skip
  if (OUTER) sort16(key);
  else sort9(key);
  merge16(best, key);
}

// the 16 nearest candidates of the query q at (y, x) of level gq, as
// sorted keys; EDGE: the window may leave the image (else all of it is in)
template <bool EDGE>
__device__ __forceinline__ void nearest16(int (&best)[K], const float4* tile, float4 q,
                                          int gq, int ty, int tx, int y, int x, int G,
                                          int H, int W) {
  unsigned in_image = (1u << NSH) - 1u;
  if (EDGE) {
    in_image = 0u;
#pragma unroll
    for (int s = 0; s < NSH; ++s) {
      const int yc = y + s / WIN - R, xc = x + s % WIN - R;
      if (yc >= 0 && yc < H && xc >= 0 && xc < W) in_image |= 1u << s;
    }
  }
  int key[K];
  // the own level's inner 3×3 first: sorted, it is the first best list
  batch_keys<false>(key, tile + (gq * SH + ty) * SW + tx, q, gq * NSH, in_image);
  sort9(key);
#pragma unroll
  for (int i = 0; i < K; ++i) best[i] = key[i];
#pragma unroll 1
  for (int o = 1; o < 2 * MAX_G - 1; ++o) {
    const int gc = gq + level_offset(o);
    if (gc < 0 || gc >= G) continue;              // warp-uniform
    batch_keys<false>(key, tile + (gc * SH + ty) * SW + tx, q, gc * NSH, in_image);
    fold_batch<false>(best, key);
  }
#pragma unroll 1
  for (int o = 0; o < 2 * MAX_G - 1; ++o) {
    const int gc = gq + level_offset(o);
    if (gc < 0 || gc >= G) continue;
    batch_keys<true>(key, tile + (gc * SH + ty) * SW + tx, q, gc * NSH, in_image);
    fold_batch<true>(best, key);
  }
}

__global__ void __launch_bounds__(TH * TW * MAX_G, 3)
window_knn_kernel(const float* __restrict__ pts, int* __restrict__ idx_out,
                  int* __restrict__ mask_out, int G, int H, int W) {
  extern __shared__ float4 tile[];  // [G][SH][SW]
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
    const int yy = y0 + rem / SW - R;
    const int xx = x0 + rem % SW - R;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float* p = pb + (g * hw + (long long)yy * W + xx) * 3;
      c = make_float4(p[0], p[1], p[2], 0.f);
    }
    tile[i] = c;
  }
  __syncthreads();

  // threads past the image edge run along (the warp votes together) and
  // store nothing
  const int ty = threadIdx.y;
  const int tx = threadIdx.x;
  const int y = y0 + ty;
  const int x = x0 + tx;
  // out-of-image candidates get the key INT_MAX: that equals the
  // reference's far sentinel, since a corner still has G·3·3 ≥ 16
  // candidates. In a block whose tile and halo lie inside the image
  // (most of them) no candidate needs the test.
  const float4 q = tile[(gq * SH + ty + R) * SW + tx + R];
  int best[K];
  if (y0 >= R && y0 + TH + R <= H && x0 >= R && x0 + TW + R <= W)
    nearest16<false>(best, tile, q, gq, ty, tx, y, x, G, H, W);
  else
    nearest16<true>(best, tile, q, gq, ty, tx, y, x, G, H, W);
  if (y >= H || x >= W) return;

  const int nw = (G * NSH + 31) / 32;
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
  const size_t smem = (size_t)G * SH * SW * sizeof(float4);
  window_knn_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(pts, idx, mask, G, H, W);
  return (int)cudaGetLastError();
}
