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
// out-of-image candidates get d² = 1e30, as in the plain version (a NaN
// point's keys rank after them there too). Keys are unique per point (the
// id sits in the low 7 bits), so the k smallest and their order do not
// depend on the order of the visit. Outputs: the flat indices
// gc·H·W + yc·W + xc, nearest first, and ⌈G·win²/32⌉ int32 words of
// selection bits per point.
//
// Bound on this card: bytes at small k, operations at large k. Per point
// it reads 12 B, writes 4k B of indices and 4 B per mask word, and does 8
// flops per in-image candidate.
//
// Design: the tuned kernel's, for any window and k. The window is a
// template parameter (1, 3, ..., 11), so every candidate's position is a
// constant and the loops unroll; G stays a runtime value. A block owns a
// tile of TH×32 pixels at all G levels (TH from ops/knn.py::tile_rows),
// one thread per query point up to 512 threads (above, the threads loop
// over the tile), and stages their coordinates with a halo of win/2
// pixels in shared memory as float4; a warp holds 32 pixels of one row and
// level. Candidates come nearest first in batches: the 3×3 around
// the pixel at every level (own level, then ±1, ±2, ...), then the 16-pixel
// ring at distance 2 at every level, then the rings at 3, 4 and 5, so the
// k-th best key tightens early. A ring is cut into chunks of the list's
// length, a 3×3 is one chunk; a chunk is skipped by the whole warp unless
// some lane has a key below its k-th best (__any_sync), else sorted (the
// 3×3 by a 25-comparator network, other chunks by a bitonic network) and
// merged into the sorted register list by one bitonic merge. Lists hold 8,
// 16 or 32 keys: the first KM − k are negative sentinels, below every key,
// so the k-th best sits in the last register. Above k = 32 the list lives
// in local memory and takes keys by insertion. A block whose tile and halo
// lie inside the image (most) skips the in-image test. Indices leave as
// 16-byte stores where k is a multiple of 4, mask words coalesced across
// the warp. SMEM_PER_BLOCK, the shared memory a block may use, comes from
// ops/_cuda.py's nvcc flags.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;               // tile columns: one warp's points of a row
constexpr int MAX_THREADS = 512;     // threads per block: G·TH·32, at most this
constexpr int MAX_NW = 4;            // mask words for at most 128 candidates
constexpr int MAX_K = 128;

// batch rho of a win×win window, nearest first: rho = 0 is the 3×3 around
// the centre (the centre alone at window 1), rho ≥ 2 the 8·rho pixels at
// Chebyshev distance rho
__host__ __device__ constexpr int ring_size(int win, int rho) {
  return rho == 0 ? (win == 1 ? 1 : 9) : 8 * rho;
}
// window position dy·win + dx of the j-th candidate of batch rho: the top
// row, the two sides of the rows between, the bottom row
__host__ __device__ constexpr int ring_pos(int win, int rho, int j) {
  const int r = win / 2;
  if (rho == 0) return win == 1 ? 0 : (r - 1 + j / 3) * win + r - 1 + j % 3;
  const int side = 2 * rho + 1;
  if (j < side) return (r - rho) * win + r - rho + j;
  j -= side;
  if (j < 2 * (side - 2)) return (r - rho + 1 + j / 2) * win + r - rho + j % 2 * 2 * rho;
  return (r + rho) * win + r - rho + j - 2 * (side - 2);
}
// the o-th level offset, nearest first: 0, −1, +1, −2, +2, ...
__device__ __forceinline__ int level_offset(int o) { return o & 1 ? -(o + 1) / 2 : o / 2; }

__device__ __forceinline__ void cas(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// sort N = 2^LN keys ascending (bitonic network); keys known to be
// INT_MAX at compile time cost nothing
template <int LN>
__device__ __forceinline__ void bitonic_sort(int (&v)[1 << LN]) {
#pragma unroll
  for (int lk = 1; lk <= LN; ++lk)
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj)
#pragma unroll
      for (int i = 0; i < (1 << LN); ++i) {
        const int l = i ^ (1 << lj);
        if (l > i) {
          if ((i & (1 << lk)) == 0) cas(v[i], v[l]);
          else cas(v[l], v[i]);
        }
      }
}

// sort the first 9 keys ascending (25 compare-exchanges); the rest stay
template <int N>
__device__ __forceinline__ void sort9(int (&v)[N]) {
  cas(v[0], v[1]); cas(v[3], v[4]); cas(v[6], v[7]); cas(v[1], v[2]); cas(v[4], v[5]);
  cas(v[7], v[8]); cas(v[0], v[1]); cas(v[3], v[4]); cas(v[6], v[7]); cas(v[0], v[3]);
  cas(v[3], v[6]); cas(v[0], v[3]); cas(v[1], v[4]); cas(v[4], v[7]); cas(v[1], v[4]);
  cas(v[2], v[5]); cas(v[5], v[8]); cas(v[2], v[5]); cas(v[1], v[3]); cas(v[5], v[7]);
  cas(v[2], v[6]); cas(v[4], v[6]); cas(v[2], v[4]); cas(v[2], v[3]); cas(v[5], v[6]);
}

// the k smallest keys, sorted ascending, in the last k of KM = 2^LN
// registers; the first KM − k hold the sentinels −(KM − k) .. −1, below
// every key (d² ≥ +0), so that the k-th best is always v[KM − 1]. A
// chunk holds KM keys, or the 9 of a 3×3 (NINE).
template <int LN>
struct RegList {
  static constexpr int KM = 1 << LN;
  static constexpr int CH = KM;
  int v[KM];
  __device__ __forceinline__ void init(int k) {
#pragma unroll
    for (int i = 0; i < KM; ++i) v[i] = i < KM - k ? i - (KM - k) : INT_MAX;
  }
  __device__ __forceinline__ int thresh() const { return v[KM - 1]; }
  // v ← the KM smallest of v ∪ c
  template <bool NINE, int CA>
  __device__ __forceinline__ void merge(int (&c)[CA]) {
    if constexpr (NINE) sort9(c);       // at KM = 8 its 9th key drops out
    else bitonic_sort<LN>(c);
#pragma unroll
    for (int i = 0; i < KM; ++i) v[i] = min(v[i], c[KM - 1 - i]);   // bitonic
#pragma unroll
    for (int lj = LN - 1; lj >= 0; --lj)
#pragma unroll
      for (int i = 0; i < KM; ++i) {
        const int l = i ^ (1 << lj);
        if (l > i) cas(v[i], v[l]);
      }
  }
  // the k nearest's indices (decode: candidate id → flat index) to o, int4
  // stores where 4 | k, and their bits to words
  template <class Decode>
  __device__ __forceinline__ void emit(int k, int* o, unsigned (&words)[MAX_NW],
                                       Decode decode) const {
    const int skip = KM - k;
    int vals[KM];
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      const int cid = v[i] & 0x7F;
      vals[i] = decode(cid);
      if (i >= skip) {
#pragma unroll
        for (int w = 0; w < MAX_NW; ++w)
          if ((cid >> 5) == w) words[w] |= 1u << (cid & 31);
      }
    }
    if ((k & 3) == 0) {
#pragma unroll
      for (int j = 0; j < KM / 4; ++j)
        if (4 * j >= skip)
          *reinterpret_cast<int4*>(o + 4 * j - skip) =
              make_int4(vals[4 * j], vals[4 * j + 1], vals[4 * j + 2], vals[4 * j + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < KM; ++i)
        if (i >= skip) o[i - skip] = vals[i];
    }
  }
};

// the k smallest keys, sorted ascending, in local memory (k > 32)
struct LocalList {
  static constexpr int CH = 32;
  int v[MAX_K];
  int k;
  __device__ __forceinline__ void init(int k_) {
    k = k_;
    for (int i = 0; i < k; ++i) v[i] = INT_MAX;
  }
  __device__ __forceinline__ int thresh() const { return v[k - 1]; }
  template <bool NINE, int CA>
  __device__ __forceinline__ void merge(int (&c)[CA]) {
#pragma unroll
    for (int j = 0; j < CA; ++j) {
      const int key = c[j];
      if (key >= v[k - 1]) continue;
      int i = k - 1;
      while (i > 0 && v[i - 1] > key) {
        v[i] = v[i - 1];
        --i;
      }
      v[i] = key;
    }
  }
  template <class Decode>
  __device__ __forceinline__ void emit(int, int* o, unsigned (&words)[MAX_NW],
                                       Decode decode) const {
    for (int i = 0; i < k; ++i) {
      const int cid = v[i] & 0x7F;
      o[i] = decode(cid);
#pragma unroll
      for (int w = 0; w < MAX_NW; ++w)
        if ((cid >> 5) == w) words[w] |= 1u << (cid & 31);
    }
  }
};

// what a thread knows of its query point
struct Query {
  float4 q;
  int gq, ty, tx;
  unsigned rows_in, cols_in;   // bit d: window row / column d lies in the image
};

// fold batch RHO of every level into best, own level first. A key equal to
// INT_MAX (a NaN point's, id 127) is never merged, and a pad INT_MAX
// emitted in its place decodes to the same candidate.
template <int WIN, int RHO, bool EDGE, class List>
__device__ __forceinline__ void fold_batch(List& best, const float4* tile, const Query& p,
                                           int G, int sh) {
  constexpr int SW = TW + 2 * (WIN / 2);
  constexpr int N = ring_size(WIN, RHO);
  // a chunk: the 3×3 whole (sorted by sort9), else List::CH keys
  constexpr bool NINE = N == 9;
  constexpr int CL = NINE ? 9 : List::CH;
  constexpr int CA = CL > List::CH ? CL : List::CH;     // keys and INT_MAX pads
  const int far = __float_as_int(1e30f) & ~0x7F;   // the key of an out-of-image candidate
#pragma unroll 1
  for (int o = 0; o < 2 * G - 1; ++o) {
    const int gc = p.gq + level_offset(o);
    if (gc < 0 || gc >= G) continue;                // warp-uniform
    const float4* window = tile + (gc * sh + p.ty) * SW + p.tx;
    const int id0 = gc * WIN * WIN;
#pragma unroll
    for (int c0 = 0; c0 < N; c0 += CL) {
      int key[CA];
      bool below = false;
      const int t = best.thresh();
#pragma unroll
      for (int j = 0; j < CA; ++j) {
        key[j] = INT_MAX;
        if (j < CL && c0 + j < N) {
          const int s = ring_pos(WIN, RHO, c0 + j);
          const int dy = s / WIN, dx = s % WIN;
          if (EDGE && !((p.rows_in >> dy) & (p.cols_in >> dx) & 1u)) {
            key[j] = far | (id0 + s);
          } else {
            const float4 c = window[dy * SW + dx];
            const float ex = __fsub_rn(p.q.x, c.x), ey = __fsub_rn(p.q.y, c.y),
                        ez = __fsub_rn(p.q.z, c.z);
            const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                       __fmul_rn(ez, ez));
            key[j] = (__float_as_int(d2) & ~0x7F) | (id0 + s);
          }
          below |= key[j] < t;
        }
      }
      if (__any_sync(0xffffffffu, below)) best.template merge<NINE>(key);   // warp-uniform skip
    }
  }
}

template <int WIN, int RHO, bool EDGE, class List>
__device__ __forceinline__ void fold_from(List& best, const float4* tile, const Query& p,
                                          int G, int sh) {
  if constexpr (RHO <= WIN / 2) {
    fold_batch<WIN, RHO, EDGE>(best, tile, p, G, sh);
    fold_from<WIN, RHO == 0 ? 2 : RHO + 1, EDGE>(best, tile, p, G, sh);
  }
}

// lth = log2(TH); blockDim.x = min(G·TH·32, 512), whole warps. The query
// loop steps by blockDim.x over G·TH·32 points, both multiples of 32, so
// each warp's 32 lanes take contiguous query slots and loop the same
// number of times: the warp vote in fold_batch sees every lane.
template <int WIN, class List>
__global__ void __launch_bounds__(MAX_THREADS)
window_knn_general_kernel(const float* __restrict__ pts, int* __restrict__ idx_out,
                          int* __restrict__ mask_out, int G, int H, int W, int k, int lth) {
  constexpr int R = WIN / 2, SW = TW + 2 * R, NSH = WIN * WIN;
  extern __shared__ float4 tile[];  // [G][TH + 2R][SW]
  const int th = 1 << lth, sh = th + 2 * R;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * TW;
  const long long hw = (long long)H * W;
  const long long npts = G * hw;
  const float* pb = pts + (long long)b * npts * 3;
  const int lane = threadIdx.x & 31;

  for (int row = threadIdx.x >> 5; row < G * sh; row += blockDim.x >> 5) {   // a warp per row
    const int g = row / sh;
    const int yy = y0 + row - g * sh - R;
    for (int c = lane; c < SW; c += 32) {
      const int xx = x0 + c - R;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const float* q = pb + (g * hw + (long long)yy * W + xx) * 3;
        v = make_float4(q[0], q[1], q[2], 0.f);
      }
      tile[row * SW + c] = v;
    }
  }
  __syncthreads();

  const bool edge = !(y0 >= R && y0 + th + R <= H && x0 >= R && x0 + TW + R <= W);
  const int nw = (G * NSH + 31) / 32;
  // threads past the image edge run along (the warp votes together) and
  // store nothing
  for (int qi = threadIdx.x; qi < G * th * TW; qi += blockDim.x) {
    Query p;
    p.tx = qi & (TW - 1);
    p.ty = (qi >> 5) & (th - 1);
    p.gq = qi >> (5 + lth);
    const int y = y0 + p.ty, x = x0 + p.tx;
    p.q = tile[(p.gq * sh + p.ty + R) * SW + p.tx + R];
    p.rows_in = p.cols_in = 0u;
#pragma unroll
    for (int d = 0; d < WIN; ++d) {
      if (y + d - R >= 0 && y + d - R < H) p.rows_in |= 1u << d;
      if (x + d - R >= 0 && x + d - R < W) p.cols_in |= 1u << d;
    }
    List best;
    best.init(k);
    if (edge) fold_from<WIN, 0, true>(best, tile, p, G, sh);
    else fold_from<WIN, 0, false>(best, tile, p, G, sh);
    if (y >= H || x >= W) continue;

    const long long pi = p.gq * hw + (long long)y * W + x;
    unsigned words[MAX_NW] = {0u, 0u, 0u, 0u};
    best.emit(k, idx_out + ((long long)b * npts + pi) * k, words, [&](int cid) {
      const int gc = cid / NSH;
      const int s = cid - gc * NSH;
      const int dy = s / WIN;
      return (int)(gc * hw + (long long)(y + dy - R) * W + (x + s - dy * WIN - R));
    });
#pragma unroll
    for (int w = 0; w < MAX_NW; ++w)
      if (w < nw) mask_out[((long long)b * nw + w) * npts + pi] = (int)words[w];
  }
}

template <int WIN, class List>
cudaError_t launch(const float* pts, int* idx, int* mask, int B, int G, int H, int W, int k,
                   int lth, cudaStream_t stream) {
  static bool attr_set = false;     // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(window_knn_general_kernel<WIN, List>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 SMEM_PER_BLOCK);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  constexpr int R = WIN / 2;
  const size_t smem = (size_t)G * ((1 << lth) + 2 * R) * (TW + 2 * R) * sizeof(float4);
  if (smem > (size_t)SMEM_PER_BLOCK) return cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + (1 << lth) - 1) >> lth, B);
  const int threads = G << (5 + lth) < MAX_THREADS ? G << (5 + lth) : MAX_THREADS;
  window_knn_general_kernel<WIN, List><<<grid, threads, smem, stream>>>(pts, idx, mask, G, H,
                                                                         W, k, lth);
  return cudaGetLastError();
}

template <int WIN>
cudaError_t launch_k(const float* pts, int* idx, int* mask, int B, int G, int H, int W, int k,
                     int lth, cudaStream_t s) {
  if (k <= 8) return launch<WIN, RegList<3>>(pts, idx, mask, B, G, H, W, k, lth, s);
  if (k <= 16) return launch<WIN, RegList<4>>(pts, idx, mask, B, G, H, W, k, lth, s);
  if (k <= 32) return launch<WIN, RegList<5>>(pts, idx, mask, B, G, H, W, k, lth, s);
  return launch<WIN, LocalList>(pts, idx, mask, B, G, H, W, k, lth, s);
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// pts (B, G·H·W, 3) f32 → idx (B, G·H·W, k) int32, mask (B, NW, G, H, W)
// int32 holding the uint32 bitplanes, for odd win ≤ 11, G·win² ≤ 128 and
// 0 ≤ k ≤ G·(win/2 + 1)²; tile_rows (1, 2, 4 or 8): the launch plan, whose
// tile must fit this card's 227 KB. Returns cudaGetLastError().
extern "C" int window_knn_general(const float* pts, int* idx, int* mask, int B, int G, int H,
                                  int W, int k, int win, int tile_rows, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int r = win / 2;
  int lth = 0;
  while (lth < 3 && (1 << lth) < tile_rows) ++lth;
  if (win < 1 || win % 2 != 1 || G < 1 || G * win * win > 128 || k < 0 ||
      k > G * (r + 1) * (r + 1) || B < 1 || B > 65535 || H < 1 || W < 1 ||
      (1 << lth) != tile_rows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (win) {
    case 1: return (int)launch_k<1>(pts, idx, mask, B, G, H, W, k, lth, s);
    case 3: return (int)launch_k<3>(pts, idx, mask, B, G, H, W, k, lth, s);
    case 5: return (int)launch_k<5>(pts, idx, mask, B, G, H, W, k, lth, s);
    case 7: return (int)launch_k<7>(pts, idx, mask, B, G, H, W, k, lth, s);
    case 9: return (int)launch_k<9>(pts, idx, mask, B, G, H, W, k, lth, s);
    case 11: return (int)launch_k<11>(pts, idx, mask, B, G, H, W, k, lth, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
