// GEMV: y (N,) fp32 = W (N, K) bf16 . x (K,) bf16, fp32 accumulation.
//
// Replaces: src/repro/kernels/gemv.py `gemv` (the Pallas kernel that streams
//   W as (block_n, block_k) tiles, two K halves in flight, into an fp32
//   VMEM accumulator).
// Bound on the H100: bytes.  W is read once (2 N K bytes) for 2 N K
//   operations, one operation per byte, far below the card's bf16 ridge.
//   At the read-out shape (151936 x 1024) W is 311 MB, so the kernel's
//   floor is the device memory rate.
// Design: one warp per output row.  Each lane walks the row with 16-byte
//   loads (8 bf16) that bypass L1 (the row is used once), multiplies with
//   the matching slice of x (small, reused by every warp, read through the
//   read-only cache) and keeps one fp32 accumulator; a 5-step shuffle
//   reduction gives the row's dot product, written by lane 0.  K need not be
//   a power of two: the loop bound is the mask (K = 2816 is 11 vectors per
//   lane).  K must be a multiple of 8 and w, x 16-byte aligned; the wrapper
//   refuses anything else rather than switch to a slower kernel.
//   A (1024, 1024) projection has only 1024 rows = 128 blocks of 8 warps,
//   which fills at most one block per SM of the 132: the small projections
//   leave most of the card idle (kept simple here; split-K comes later).
#include "common.cuh"

namespace {

__global__ void gemv_bf16_kernel(const __nv_bfloat16* __restrict__ w,
                                 const __nv_bfloat16* __restrict__ x,
                                 float* __restrict__ y, int N, int K) {
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const uint4* wr = reinterpret_cast<const uint4*>(w + (size_t)row * K);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const int nvec = K / 8;
  float acc = 0.f;
#pragma unroll 4
  for (int i = lane; i < nvec; i += 32) {
    float wf[8], xf[8];
    repro::bf16x8_to_float(__ldcs(wr + i), wf);
    repro::bf16x8_to_float(__ldg(xv + i), xf);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(wf[j], xf[j], acc);
  }
  acc = repro::warp_sum(acc);
  if (lane == 0) y[row] = acc;
}

}  // namespace

// w (N, K) bf16 row-major, x (K,) bf16, y (N,) fp32; K % 8 == 0 and w, x
// 16-byte aligned (the wrapper checks).
extern "C" cudaError_t repro_gemv_bf16(const void* w, const void* x, void* y,
                                       int N, int K, int warps, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (warps < 1 || warps > 32 || K % 8 != 0) return cudaErrorInvalidValue;
  const int blocks = (N + warps - 1) / warps;
  gemv_bf16_kernel<<<blocks, warps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)w, (const __nv_bfloat16*)x, (float*)y, N, K);
  return cudaGetLastError();
}
