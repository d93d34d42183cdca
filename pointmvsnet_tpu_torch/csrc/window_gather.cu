// Windowed row gather, for Hopper (sm_90a).
//
// Replaces: benchmarks/pallas_gather_probe.py::_mk_pallas (the pallas_call
// that pallas_gather launches with one of the bodies _onehot_body,
// _loop_body or _take_body). All three bodies compute the same function,
// and so does this one kernel:
//
//     out[n, :] = table_p[q[n / 512] · SPAN + rel[n], :]
//
// for a table padded to a multiple of SPAN plus one SPAN, a slab index q per
// 512-row block and window-relative indices rel ∈ [0, 2·SPAN), so each block
// reads from its two-slab window [q·SPAN, (q + 2)·SPAN). The wrapper checks
// the ranges; the kernel trusts them.
//
// Bound on this card: bytes. The function reads each distinct table row it
// needs once, one index per output row and one q per block, and writes the
// rows. The probe's indices repeat: at its default (N = 327,680, W = 128)
// they name 207,474 distinct rows, so (207,474 + N)·W·4 B + N·4 B ≈ 275 MB,
// 0.082 ms at 3.35 TB/s (chip_smoke.py counts it from the run's indices).
// No arithmetic to speak of.
//
// Design: one warp per output row, each lane moving 16 B (a float4) per
// step, so a 512-byte row at W = 128 is one coalesced load and one
// coalesced store. The TPU kernel stages its window in VMEM; here a
// two-slab window is 2·SPAN·W·4 B = 2 MiB at the probe's default, far above
// the 227 KB of shared memory an SM has, so the window lives in the 50 MB
// L2, where neighbouring blocks' coherent indices find it. Staging slabs
// in shared memory (smaller SPAN, TMA) is a later PR's work.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_ROWS = 512;  // rows per q entry, as in the probe
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
window_gather_kernel(const float4* __restrict__ table, const int* __restrict__ q,
                     const int* __restrict__ rel, float4* __restrict__ out,
                     int N, int W4, int span) {
  const long long n = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  const long long row = (long long)__ldg(q + n / BLOCK_ROWS) * span + __ldg(rel + n);
  const float4* src = table + row * W4;
  float4* dst = out + n * W4;
  for (int j = lane; j < W4; j += 32) dst[j] = __ldg(src + j);
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// table_p (R, W) f32 with W % 4 == 0 and 16-byte aligned rows; q (N / 512,)
// int32; rel (N,) int32 → out (N, W) f32. Returns cudaGetLastError().
extern "C" int window_gather(const float* table, const int* q, const int* rel,
                             float* out, int N, int W, int span, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W % 4 != 0 || N % BLOCK_ROWS != 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const long long threads = (long long)N * 32;
  const unsigned blocks = (unsigned)((threads + WARPS * 32 - 1) / (WARPS * 32));
  window_gather_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), q, rel, reinterpret_cast<float4*>(out),
      N, W / 4, span);
  return (int)cudaGetLastError();
}
