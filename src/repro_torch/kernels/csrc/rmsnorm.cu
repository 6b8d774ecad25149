// RMSNorm: out = x * rsqrt(mean(x^2) + eps) * scale, fp32 math, bf16 out.
//
// Replaces: src/repro/kernels/rmsnorm.py `rmsnorm` (the Pallas kernel that
//   normalizes a (bt, d) row tile per grid step).
// Bound on the H100: bytes.  Per row it reads d bf16 values and writes d
//   bf16 values (plus the d fp32 scales, shared by all rows); 4 operations
//   per element are far below the card's ~295 operations per byte of
//   bf16 ridge.  At the served shapes that is 0.011 us (8 rows of 1024) to
//   0.022 us (8 rows of 2048): the bound is a small fraction of one launch,
//   so what sets the time is the launch and the chain of dependent steps
//   inside the kernel (round trips to memory, barriers).
// Design: a warp a row, launched as a programmatic dependent.
//   - Each lane holds d / 256 16-byte vectors of its row (4 at d = 1024, 8
//     at 2048; lane l takes vectors l, l + 32, ... so that each load of the
//     warp is 512 contiguous bytes) and the two float4 of scales of each,
//     and issues all of these loads before its first multiply: one round
//     trip to memory.  The sum of squares is reduced with warp shuffles
//     only: no shared memory, no __syncthreads.
//   - A block takes `rmsnorm_threads` / 32 rows.  A row wider than 8
//     vectors a lane (d > 2048) takes several warps, each holding a slice
//     of at most 8 vectors a lane; their sums meet in one shared-memory step
//     and each warp adds them in warp order, so the same inputs give the
//     same bits.  Up to 16 warps a row: d <= 32,768.  The wrapper works
//     out the warps a row, the vectors a lane and the rows a block
//     (kernels/rmsnorm.py `rmsnorm_plan`).
//   - The launch carries cudaLaunchAttributeProgrammaticStreamSerialization
//     (cudaLaunchKernelEx), so its blocks may be scheduled while the kernel
//     before it is still running: `griddepcontrol.wait` comes before the
//     first load of x or of the scale (in training the optimizer writes the
//     scale) and before any store (the caching allocator can hand out `out`
//     memory that the kernel before still reads); only index arithmetic
//     comes before it.  After a plain launch of the kernel before, the wait
//     passes straight through.  Once the loads of x are issued it runs
//     `griddepcontrol.launch_dependents`, so that a kernel launched as its
//     own programmatic dependent may start streaming what does not depend
//     on the normalized rows.
//   - The math on each element is the earlier design's: fp32, rsqrtf,
//     x * r * s, rounded to bf16; only the order of the sum of squares is
//     another.
// The earlier design, replaced by this one: one block of `rmsnorm_threads`
//   threads a row, a thread up to 4 vectors, the sum through warp shuffles
//   and a shared-memory step between two __syncthreads, the scales loaded
//   after the reduction (a second round trip), a plain launch.  Device us
//   in one process on an NVIDIA H100 80GB HBM3 at 700 W (CUDA-graph replay,
//   scripts/chip_probe.py --probes rmsnorm --parent), at x (8, 1024),
//   (32, 1024), (1, 1024), (8, 2048), (1, 2048): the earlier design 2.05,
//   2.16, 2.31, 2.42, 2.52; this one 1.95, 2.06, 1.64, 2.00, 1.79.
#include "common.cuh"

namespace {

constexpr int kMaxVecs = 8;   // 16-byte vectors of a row a lane holds

// at most 512 threads a block leaves 128 registers a thread: 8 vectors of x
// and their 16 float4 of scales stay in registers (at 1024 threads ptxas
// spills them)
template <int VPL>
__global__ void __launch_bounds__(512)
    rmsnorm_warp_kernel(const __nv_bfloat16* x, const float* scale,
                        __nv_bfloat16* out, int T, int d, int wpr,
                        float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * ((blockDim.x >> 5) / wpr) + warp / wpr;
  const int first = (warp % wpr) * 32 + lane, stride = wpr * 32;
  const int nvec = d >> 3;
  const bool live = row < T;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (size_t)row * nvec;
  const float4* sv = reinterpret_cast<const float4*>(scale);
  // the kernel before this one (a programmatic launch) has finished and
  // its writes are visible past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  uint4 xv[VPL];
  float4 sa[VPL], sb[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int i = first + v * stride;
    if (live && i < nvec) {
      xv[v] = xr[i];
      sa[v] = sv[2 * i];
      sb[v] = sv[2 * i + 1];
    } else {
      xv[v] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    float f[8];
    repro::bf16x8_to_float(xv[v], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
  }
  ss = repro::warp_sum(ss);
  if (wpr > 1) {
    __shared__ float red[32];
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    const int w0 = warp - warp % wpr;
    ss = 0.f;
    for (int k = 0; k < wpr; ++k) ss += red[w0 + k];
  }
  const float r = rsqrtf(ss / (float)d + eps);
  // x is converted to fp32 again below: without this barrier ptxas keeps
  // the 8 VPL floats of the sum alive with the scales and spills at VPL 8
#pragma unroll
  for (int v = 0; v < VPL; ++v)
    asm volatile("" : "+r"(xv[v].x), "+r"(xv[v].y), "+r"(xv[v].z),
                 "+r"(xv[v].w));

  uint4* orow = reinterpret_cast<uint4*>(out) + (size_t)row * nvec;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int i = first + v * stride;
    if (live && i < nvec) {
      float f[8];
      repro::bf16x8_to_float(xv[v], f);
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
      oh[0] = __floats2bfloat162_rn(f[0] * r * sa[v].x, f[1] * r * sa[v].y);
      oh[1] = __floats2bfloat162_rn(f[2] * r * sa[v].z, f[3] * r * sa[v].w);
      oh[2] = __floats2bfloat162_rn(f[4] * r * sb[v].x, f[5] * r * sb[v].y);
      oh[3] = __floats2bfloat162_rn(f[6] * r * sb[v].z, f[7] * r * sb[v].w);
      orow[i] = o;
    }
  }
}

template <int VPL>
cudaError_t launch(const void* x, const void* scale, void* out, int T, int d,
                   float eps, int wpr, int rows, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + rows - 1) / rows);
  cfg.blockDim = dim3(rows * wpr * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, rmsnorm_warp_kernel<VPL>, (const __nv_bfloat16*)x,
      (const float*)scale, (__nv_bfloat16*)out, T, d, wpr, eps);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// x (T, d) bf16, scale (d,) fp32, out (T, d) bf16; d % 8 == 0, 16-byte
// aligned pointers (the wrapper checks).  ``wpr`` warps a row, ``vpl``
// 16-byte vectors a lane (1, 2, 4 or 8; wpr * 32 * vpl >= d / 8), ``rows``
// rows a block (rows * wpr <= 16): kernels/rmsnorm.py `rmsnorm_plan`.
extern "C" cudaError_t repro_rmsnorm_bf16(const void* x, const void* scale,
                                          void* out, int T, int d, float eps,
                                          int wpr, int vpl, int rows,
                                          void* stream) {
  if (T <= 0) return cudaSuccess;
  if (d <= 0 || d % 8 != 0 || wpr < 1 || rows < 1 || rows * wpr > 16 ||
      (d / 8 + wpr * 32 - 1) / (wpr * 32) > vpl)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vpl) {
    case 1: return launch<1>(x, scale, out, T, d, eps, wpr, rows, s);
    case 2: return launch<2>(x, scale, out, T, d, eps, wpr, rows, s);
    case 4: return launch<4>(x, scale, out, T, d, eps, wpr, rows, s);
    case kMaxVecs:
      return launch<kMaxVecs>(x, scale, out, T, d, eps, wpr, rows, s);
    default: return cudaErrorInvalidValue;
  }
}
