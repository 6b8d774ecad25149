// RMSNorm: out = x * rsqrt(mean(x^2) + eps) * scale, fp32 math, bf16 out.
//
// Replaces: src/repro/kernels/rmsnorm.py `rmsnorm` (the Pallas kernel that
//   normalizes a (bt, d) row tile per grid step).
// Bound on the H100: bytes.  Per row it reads d bf16 values and writes d
//   bf16 values (plus the d fp32 scales, shared by all rows); 4 operations
//   per element are far below the card's ~295 operations per byte of
//   bf16 ridge.
// Design: one block per row; each thread loads its slice of the row with
//   16-byte vector loads into registers (so x is read from device memory
//   exactly once), the sum of squares is reduced with warp shuffles and
//   one shared-memory step across warps, and each thread writes its slice
//   back with one 16-byte store.  A row of d values needs d / 8 vector
//   slots: up to kMaxChunks of them per thread.  At the serving shapes
//   (T = slots, 32 or 1 rows of d = 1024) the grid has at most 32 blocks,
//   so the kernel is bound by launch latency rather than by bytes.
#include "common.cuh"

namespace {

constexpr int kMaxChunks = 4;

__global__ void rmsnorm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                    const float* __restrict__ scale,
                                    __nv_bfloat16* __restrict__ out, int d,
                                    float eps) {
  const int row = blockIdx.x;
  const int nvec = d / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * d);

  float v[kMaxChunks][8];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < nvec) {
      repro::bf16x8_to_float(xr[i], v[c]);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += v[c][j] * v[c][j];
    }
  }

  __shared__ float red[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ss = repro::warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    t = repro::warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(red[0] / (float)d + eps);

#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < nvec) {
      const float4 s0 = reinterpret_cast<const float4*>(scale)[2 * i];
      const float4 s1 = reinterpret_cast<const float4*>(scale)[2 * i + 1];
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        oh[j] = __floats2bfloat162_rn(v[c][2 * j] * r * s[2 * j],
                                      v[c][2 * j + 1] * r * s[2 * j + 1]);
      orow[i] = o;
    }
  }
}

}  // namespace

// x (T, d) bf16, scale (d,) fp32, out (T, d) bf16; d % 8 == 0, 16-byte
// aligned pointers, d / 8 <= threads * kMaxChunks (the wrapper checks).
extern "C" cudaError_t repro_rmsnorm_bf16(const void* x, const void* scale,
                                          void* out, int T, int d, float eps,
                                          int threads, void* stream) {
  if (T <= 0) return cudaSuccess;
  if (d % 8 != 0 || d / 8 > threads * kMaxChunks || threads % 32 != 0 ||
      threads > 1024)
    return cudaErrorInvalidValue;
  rmsnorm_bf16_kernel<<<T, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)scale, (__nv_bfloat16*)out, d,
      eps);
  return cudaGetLastError();
}
