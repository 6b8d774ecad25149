// GEMV: y (N,) fp32 = W (N, K) . x (K,), fp32 accumulation; W and x both
// bf16 (the projections) or both fp32 (the MoE router).  Optionally W is
// one matrix of a stack (E, N, K) picked by a device-resident index.
//
// Replaces: src/repro/kernels/gemv.py `gemv` (the Pallas kernel that streams
//   W as (block_n, block_k) tiles, two K halves in flight, into an fp32
//   VMEM accumulator; it casts any float input to fp32).
// Bound on the H100: bytes.  W is read once (2 N K bytes in bf16, 4 N K in
//   fp32) for 2 N K operations, at most one operation per byte, far below
//   the card's ridge.  At the read-out shape (151936 x 1024 bf16) W is
//   311 MB, so the kernel's floor is the device memory rate; the router
//   (60 x 2048 fp32, 0.49 MB) and the experts (1408 x 2048 bf16, 5.8 MB)
//   are small enough that the launch latency is the floor.
// Design: one warp per output row.  Each lane walks the row with 16-byte
//   loads (8 bf16 or 4 fp32) that bypass L1 (the row is used once),
//   multiplies with the matching slice of x (small, reused by every warp,
//   read through the read-only cache) and keeps one fp32 accumulator; a
//   5-step shuffle reduction gives the row's dot product, written by lane
//   0.  K need not be a power of two: the loop bound is the mask (K = 2816
//   is 11 vectors per lane).  K must be a multiple of the vector (8 bf16,
//   4 fp32) and w, x 16-byte aligned; the wrapper refuses anything else
//   rather than switch to a slower kernel.  With an index (the bf16 routed
//   MoE path, `moe.py:173-185` in the JAX package) every block reads the
//   expert id from device memory itself and offsets W by id * N * K, so
//   the host never reads the router's choice and no expert slice is copied.
//   A (1024, 1024) projection has only 1024 rows = 128 blocks of 8 warps,
//   which fills at most one block per SM of the 132: the small projections
//   leave most of the card idle (kept simple here; split-K comes later).
#include "common.cuh"

namespace {

// One 16-byte vector of T -> floats.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    repro::bf16x8_to_float(u, f);
  }
};

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&u);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

template <typename T>
__global__ void gemv_kernel(const T* __restrict__ w, const T* __restrict__ x,
                            const int* __restrict__ index,
                            float* __restrict__ y, int N, int K) {
  constexpr int V = Vec<T>::n;
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  if (index != nullptr) w += (size_t)__ldg(index) * N * K;
  const uint4* wr = reinterpret_cast<const uint4*>(w + (size_t)row * K);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const int nvec = K / V;
  float acc = 0.f;
#pragma unroll 4
  for (int i = lane; i < nvec; i += 32) {
    float wf[V], xf[V];
    Vec<T>::load(__ldcs(wr + i), wf);
    Vec<T>::load(__ldg(xv + i), xf);
#pragma unroll
    for (int j = 0; j < V; ++j) acc = fmaf(wf[j], xf[j], acc);
  }
  acc = repro::warp_sum(acc);
  if (lane == 0) y[row] = acc;
}

template <typename T>
cudaError_t launch(const void* w, const void* x, const void* index, void* y,
                   int N, int K, int warps, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (warps < 1 || warps > 32 || K % Vec<T>::n != 0)
    return cudaErrorInvalidValue;
  const int blocks = (N + warps - 1) / warps;
  gemv_kernel<T><<<blocks, warps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)w, (const T*)x, (const int*)index, (float*)y, N, K);
  return cudaGetLastError();
}

}  // namespace

// w (N, K) row-major, or a stack (E, N, K) with index -> one int32 expert
// id on the device (null: no stack); x (K,); y (N,) fp32.  bf16: K % 8 ==
// 0; fp32: K % 4 == 0; w, x 16-byte aligned (the wrapper checks).
extern "C" cudaError_t repro_gemv_bf16(const void* w, const void* x,
                                       const void* index, void* y, int N,
                                       int K, int warps, void* stream) {
  return launch<__nv_bfloat16>(w, x, index, y, N, K, warps, stream);
}

extern "C" cudaError_t repro_gemv_f32(const void* w, const void* x,
                                      const void* index, void* y, int N,
                                      int K, int warps, void* stream) {
  return launch<float>(w, x, index, y, N, K, warps, stream);
}
