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
//   rate.
// Design: no grid carries a sum on this card, so the reduction is two
//   launches.  Stage 1: each operand is walked as `streams` contiguous
//   parts side by side (the TROOP (A) intent: each part is its own
//   contiguous stream of 16-byte loads); a block of block_k / V threads
//   (V = 8 bf16 or 4 fp32 per 16-byte load) takes, per step, `unroll`
//   vectors of each part per thread, all loaded before any is used, so
//   2 x streams x unroll loads a thread are in flight; the x and y loads
//   bypass L1 (used once).  Each thread keeps an fp32 sum in registers
//   (the shadow-buffer intent (C): nothing is written until the end); the
//   block reduces it with warp shuffles and a shared-memory tree
//   (mechanism G) and writes one partial.  The grid strides over the steps
//   with at most what the SMs hold at once.  Stage 2: one block sums the
//   partials in a fixed order (strided per thread, then the same tree), so
//   two runs on the same inputs give the same bits: no float atomics.
//   n must be a multiple of V and x, y 16-byte aligned (the wrapper
//   checks).
#include "common.cuh"

namespace {

using repro::Vec;

// Sum ``v`` over the block (at most 1024 threads): warp shuffles, then the
// warps' sums through shared memory; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = repro::warp_sum(v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  v = threadIdx.x < nw ? warp_sums[threadIdx.x] : 0.f;
  if (warp == 0) v = repro::warp_sum(v);
  return v;
}

// Stage 1.  Part s of each operand is vectors [s * part, min((s + 1) *
// part, nv)); step c covers vectors [c * chunk, (c + 1) * chunk) of every
// part, chunk = blockDim.x * U.
template <typename T, int U>
__global__ void dotp_partial_kernel(const T* __restrict__ x,
                                    const T* __restrict__ y,
                                    float* __restrict__ partial, int nv,
                                    int streams) {
  constexpr int V = Vec<T>::n;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  const int part = (nv + streams - 1) / streams;
  const int chunk = blockDim.x * U;
  const int steps = (part + chunk - 1) / chunk;
  float acc = 0.f;
  for (int c = blockIdx.x; c < steps; c += gridDim.x) {
    uint4 xr[2][U], yr[2][U];
    bool live[2][U];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = c * chunk + u * blockDim.x + threadIdx.x;
        const int g = s * part + i;
        live[s][u] = s < streams && i < part && g < nv;
        if (live[s][u]) {
          xr[s][u] = __ldcs(xv + g);
          yr[s][u] = __ldcs(yv + g);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
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

// Stage 2: one block, the partials in a fixed order.
__global__ void dotp_final_kernel(const float* __restrict__ partial, int n,
                                  float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

template <typename T, int U>
cudaError_t launch_u(const void* x, const void* y, void* partial, void* out,
                     int nv, int streams, int threads, int blocks,
                     cudaStream_t s) {
  dotp_partial_kernel<T, U><<<blocks, threads, 0, s>>>(
      (const T*)x, (const T*)y, (float*)partial, nv, streams);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dotp_final_kernel<<<1, 1024, 0, s>>>((const float*)partial, blocks,
                                       (float*)out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* y, void* partial, void* out,
                   int n, int streams, int unroll, int block_k, int blocks,
                   void* stream) {
  constexpr int V = Vec<T>::n;
  const int threads = block_k / V;
  if (n <= 0 || n % V != 0 || (streams != 1 && streams != 2) ||
      block_k % V != 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || blocks < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nv = n / V;
  switch (unroll) {
    case 1:
      return launch_u<T, 1>(x, y, partial, out, nv, streams, threads, blocks,
                            s);
    case 2:
      return launch_u<T, 2>(x, y, partial, out, nv, streams, threads, blocks,
                            s);
    case 4:
      return launch_u<T, 4>(x, y, partial, out, nv, streams, threads, blocks,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y (n,) 16-byte aligned; partial (blocks,) fp32 scratch; out (1,)
// fp32.  bf16: n % 8 == 0, block_k % 8 == 0; fp32: n % 4 == 0, block_k % 4
// == 0; block_k / V threads a block, a multiple of 32 up to 1024.
extern "C" cudaError_t repro_dotp_bf16(const void* x, const void* y,
                                       void* partial, void* out, int n,
                                       int streams, int unroll, int block_k,
                                       int blocks, void* stream) {
  return launch<__nv_bfloat16>(x, y, partial, out, n, streams, unroll,
                               block_k, blocks, stream);
}

extern "C" cudaError_t repro_dotp_f32(const void* x, const void* y,
                                      void* partial, void* out, int n,
                                      int streams, int unroll, int block_k,
                                      int blocks, void* stream) {
  return launch<float>(x, y, partial, out, n, streams, unroll, block_k,
                       blocks, stream);
}
