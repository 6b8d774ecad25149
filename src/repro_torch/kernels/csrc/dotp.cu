// DOTP: s (fp32) = x . y over two vectors of n elements, both bf16 or both
// fp32, accumulated in fp32.
//
// Replaces: src/repro/kernels/dotp.py `dotp` (the paper's 2:1 bandwidth-to-
//   compute kernel: a 1-D grid over (rows, 128) tiles, two contiguous
//   half-streams of each operand when streams=2, the scalar partial carried
//   in SMEM scratch across grid steps and each tile reduced as a tree).
// Bound on the H100: bytes.  x and y are read once (2 n bytes each in
//   bf16) for 2 n operations, half an operation per byte, far below the
//   card's ridge; the kernel's floor is 4 n bytes over the device memory
//   rate.  At 2^20 bf16 that is 1.25 us, below the fixed cost of a launch,
//   so what the cross-block sum adds to the first kernel's time is what
//   matters there.
// Design (kernels/dotp.py `dotp_plan` cuts the grid).  Each operand is
//   walked as `streams` contiguous parts side by side (the TROOP (A)
//   intent: each part is its own contiguous stream of 16-byte loads); a
//   block of `threads` takes, per step, VPT vectors of each part per
//   thread, all loaded before any is used, so 2 x streams x VPT loads a
//   thread are in flight; the loads bypass L1 (used once).  Up to a wave of
//   the card every block takes one step, so every thread issues all of its
//   loads before its first FMA; past it the grid strides over the steps.
//   Each thread keeps an fp32 sum in registers (the shadow-buffer intent
//   (C)); the block reduces it with xor shuffles and one shared-memory step
//   (mechanism G) and stores one partial.  The combine is a second kernel
//   of one block, launched as a programmatic dependent (cudaLaunchKernelEx
//   with programmatic stream serialization): each block of the first
//   triggers it (`griddepcontrol.launch_dependents`) once its first step's
//   loads are out, so it is scheduled while they are in flight, and it
//   executes `griddepcontrol.wait`, which returns once the whole first grid
//   has finished and its partials are visible, before it reads a partial.
//   It folds the partials in one fixed order (thread t the float4 groups
//   t, t + threads, ..., then the same block reduction), so two runs on the
//   same inputs give the same bits: no float atomics.  A combine inside the
//   one launch (each block fences its partial and draws a ticket; the last
//   one reads the partials) measured slower at every size from 2^16 to
//   2^27 and every cut, 0.3-2.9 us at the default config (PERF.md,
//   scripts/chip_probe.py --probes dotp).  n must be a multiple of V and x,
//   y 16-byte aligned (the wrapper checks).
#include "common.cuh"

namespace {

using repro::Vec;

// Sum ``v`` over the block (at most 1024 threads, a multiple of 32): xor
// shuffles within each warp, then the warps' sums through shared memory,
// the missing lanes as 0; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = repro::warp_sum(v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = threadIdx.x < nw ? warp_sums[threadIdx.x] : 0.f;
  if (warp == 0) v = repro::warp_sum(v);
  return v;
}

// The partials of ``blocks`` blocks in one fixed order: thread t folds the
// float4 groups t, t + blockDim.x, ... (each group's four in order; a group
// past ``blocks`` only its first ones), all of a round of 8 groups loaded
// from L2 before any is added; then block_sum.  Valid in thread 0.
__device__ __forceinline__ float combine(const float* __restrict__ partial,
                                         int blocks) {
  const float4* p4 = reinterpret_cast<const float4*>(partial);
  const int groups = (blocks + 3) >> 2;
  float s = 0.f;
  for (int g0 = threadIdx.x; g0 < groups; g0 += 8 * blockDim.x) {
    float4 p[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int g = g0 + r * blockDim.x;
      p[r] = g < groups ? __ldcg(p4 + g) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = 4 * (g0 + r * blockDim.x);
      if (i < blocks) s += p[r].x;
      if (i + 1 < blocks) s += p[r].y;
      if (i + 2 < blocks) s += p[r].z;
      if (i + 3 < blocks) s += p[r].w;
    }
  }
  return block_sum(s);
}

// Part s of each operand is vectors [s * part, min((s + 1) * part, nv));
// step c covers vectors [c * chunk, (c + 1) * chunk) of every part, chunk
// = blockDim.x * VPT, vector c * chunk + u * blockDim.x + t to thread t.
template <typename T, int S, int VPT>
__global__ void dotp_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            float* __restrict__ partial, int nv, int part,
                            int steps) {
  constexpr int V = Vec<T>::n;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  const int chunk = blockDim.x * VPT;
  float acc = 0.f;
  for (int c = blockIdx.x; c < steps; c += gridDim.x) {
    uint4 xr[S][VPT], yr[S][VPT];
    bool live[S][VPT];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        const int i = c * chunk + u * blockDim.x + threadIdx.x;
        const int g = s * part + i;
        live[s][u] = i < part && g < nv;
        if (live[s][u]) {
          xr[s][u] = __ldcs(xv + g);
          yr[s][u] = __ldcs(yv + g);
        }
      }
    }
    // the combine may be scheduled once this block's loads are out
    if (c == blockIdx.x)
      asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        if (!live[s][u]) continue;
        float xf[V], yf[V];
        Vec<T>::load(xr[s][u], xf);
        Vec<T>::load(yr[s][u], yf);
#pragma unroll
        for (int j = 0; j < V; ++j) acc = fmaf(xf[j], yf[j], acc);
      }
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// The combine, a programmatic dependent of dotp_kernel: it waits for the
// whole grid and its stores before it reads a partial.
__global__ void dotp_combine_kernel(const float* __restrict__ partial,
                                    int blocks, float* __restrict__ out) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float s = combine(partial, blocks);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T, int S, int VPT>
cudaError_t launch_k(const void* x, const void* y, void* partial, void* out,
                     int nv, int part, int steps, int threads, int blocks,
                     int combine, cudaStream_t s) {
  dotp_kernel<T, S, VPT><<<blocks, threads, 0, s>>>(
      (const T*)x, (const T*)y, (float*)partial, nv, part, steps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(combine);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dotp_combine_kernel, (const float*)partial,
                         blocks, (float*)out);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* y, void* partial, void* out,
                   int n, int streams, int vpt, int threads, int blocks,
                   int combine, void* stream) {
  constexpr int V = Vec<T>::n;
  if (n <= 0 || n % V != 0 || (streams != 1 && streams != 2) ||
      threads < 32 || threads > 1024 || threads % 32 != 0 || blocks < 1 ||
      combine < 32 || combine > 1024 || combine % 32 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nv = n / V;
  const int part = (nv + streams - 1) / streams;
  const int chunk = threads * vpt;
  const int steps = (part + chunk - 1) / chunk;
#define DOTP_CASE(S_, U_)                                                  \
  if (streams == S_ && vpt == U_)                                          \
    return launch_k<T, S_, U_>(x, y, partial, out, nv, part, steps,        \
                               threads, blocks, combine, s);
  DOTP_CASE(1, 1) DOTP_CASE(1, 2) DOTP_CASE(1, 4) DOTP_CASE(1, 8)
  DOTP_CASE(2, 1) DOTP_CASE(2, 2) DOTP_CASE(2, 4) DOTP_CASE(2, 8)
#undef DOTP_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y (n,) 16-byte aligned; partial: fp32 scratch of blocks rounded up to
// a multiple of 4, 16-byte aligned; out (1,) fp32.  bf16: n % 8 == 0;
// fp32: n % 4 == 0.  ``streams`` 1 or 2 parts, ``vpt`` 1, 2, 4 or 8
// vectors of each part a thread and step, ``threads`` a block and
// ``combine`` threads of the combine (each a multiple of 32 up to 1024),
// ``blocks``: kernels/dotp.py `dotp_plan`.
extern "C" cudaError_t repro_dotp_bf16(const void* x, const void* y,
                                       void* partial, void* out, int n,
                                       int streams, int vpt, int threads,
                                       int blocks, int combine,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, y, partial, out, n, streams, vpt, threads,
                               blocks, combine, stream);
}

extern "C" cudaError_t repro_dotp_f32(const void* x, const void* y,
                                      void* partial, void* out, int n,
                                      int streams, int vpt, int threads,
                                      int blocks, int combine, void* stream) {
  return launch<float>(x, y, partial, out, n, streams, vpt, threads, blocks,
                       combine, stream);
}
