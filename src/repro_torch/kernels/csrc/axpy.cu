// AXPY: out = a x + y, computed in fp32 and rounded to y's type; x and y
// both bf16 or both fp32, n elements; a new output (y is not written).
//
// Replaces: src/repro/kernels/axpy.py `axpy` (the paper's 3:1 bandwidth-to-
//   compute kernel: a 1-D grid over (rows, 128) tiles, x and y split into
//   two contiguous halves, four input DMAs in flight, when streams=2).
// Bound on the H100: bytes.  x and y read once and the output written once
//   (6 n bytes in bf16) for 2 n operations: a third of an operation per
//   byte.
// Design: the operands are walked as `streams` contiguous parts side by
//   side (the TROOP (A) intent: each part its own contiguous stream); a
//   block of block_k / V threads (V = 8 bf16 or 4 fp32 per 16-byte load)
//   takes, per step, `unroll` 16-byte vectors of x and of y from each part
//   per thread, all loaded before any is used (2 x streams x unroll loads
//   in flight a thread, bypassing L1: each is used once), and stores the
//   results with 16-byte streaming stores.  The grid strides over the steps
//   with at most what the SMs hold at once.  The arithmetic is one fp32
//   multiply and one fp32 add, each rounded on its own (__fmul_rn /
//   __fadd_rn: written as a * x + y, nvcc would contract it to one fused
//   multiply-add and round once), then one rounding to y's type: the plain
//   version's operations, so the two give the same bits.  n must be a
//   multiple of V and x, y, out 16-byte aligned (the wrapper checks).
#include "common.cuh"

namespace {

// 16-byte vectors of T <-> floats, with the rounding of the output type.
template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    repro::bf16x8_to_float(u, f);
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Io<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    repro::Vec<float>::load(u, f);
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    uint4 u;
    float* o = reinterpret_cast<float*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = f[i];
    return u;
  }
};

// Part s is vectors [s * part, min((s + 1) * part, nv)); step c covers
// vectors [c * chunk, (c + 1) * chunk) of every part, chunk = blockDim.x U.
template <typename T, int U>
__global__ void axpy_kernel(float a, const T* __restrict__ x,
                            const T* __restrict__ y, T* __restrict__ out,
                            int nv, int streams) {
  constexpr int V = Io<T>::n;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const int part = (nv + streams - 1) / streams;
  const int chunk = blockDim.x * U;
  const int steps = (part + chunk - 1) / chunk;
  for (int c = blockIdx.x; c < steps; c += gridDim.x) {
    uint4 xr[2][U], yr[2][U];
    int at[2][U];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = c * chunk + u * blockDim.x + threadIdx.x;
        const int g = s * part + i;
        at[s][u] = (s < streams && i < part && g < nv) ? g : -1;
        if (at[s][u] >= 0) {
          xr[s][u] = __ldcs(xv + g);
          yr[s][u] = __ldcs(yv + g);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (at[s][u] < 0) continue;
        float xf[V], yf[V], of[V];
        Io<T>::load(xr[s][u], xf);
        Io<T>::load(yr[s][u], yf);
#pragma unroll
        for (int j = 0; j < V; ++j) of[j] = __fadd_rn(__fmul_rn(a, xf[j]), yf[j]);
        __stcs(ov + at[s][u], Io<T>::store(of));
      }
    }
  }
}

template <typename T>
cudaError_t launch(float a, const void* x, const void* y, void* out, int n,
                   int streams, int unroll, int block_k, int blocks,
                   void* stream) {
  constexpr int V = Io<T>::n;
  const int threads = block_k / V;
  if (n <= 0) return cudaSuccess;
  if (n % V != 0 || (streams != 1 && streams != 2) || block_k % V != 0 ||
      threads < 32 || threads > 1024 || threads % 32 != 0 || blocks < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nv = n / V;
  switch (unroll) {
    case 1:
      axpy_kernel<T, 1><<<blocks, threads, 0, s>>>(
          a, (const T*)x, (const T*)y, (T*)out, nv, streams);
      break;
    case 2:
      axpy_kernel<T, 2><<<blocks, threads, 0, s>>>(
          a, (const T*)x, (const T*)y, (T*)out, nv, streams);
      break;
    case 4:
      axpy_kernel<T, 4><<<blocks, threads, 0, s>>>(
          a, (const T*)x, (const T*)y, (T*)out, nv, streams);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, y, out (n,) 16-byte aligned.  bf16: n % 8 == 0, block_k % 8 == 0;
// fp32: n % 4 == 0, block_k % 4 == 0; block_k / V threads a block, a
// multiple of 32 up to 1024.
extern "C" cudaError_t repro_axpy_bf16(float a, const void* x, const void* y,
                                       void* out, int n, int streams,
                                       int unroll, int block_k, int blocks,
                                       void* stream) {
  return launch<__nv_bfloat16>(a, x, y, out, n, streams, unroll, block_k,
                               blocks, stream);
}

extern "C" cudaError_t repro_axpy_f32(float a, const void* x, const void* y,
                                      void* out, int n, int streams,
                                      int unroll, int block_k, int blocks,
                                      void* stream) {
  return launch<float>(a, x, y, out, n, streams, unroll, block_k, blocks,
                       stream);
}
