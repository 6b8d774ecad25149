// GEMV: y (N,) fp32 = W (N, K) . x (K,), fp32 accumulation; W and x both
// bf16 (the projections) or both fp32 (the MoE router).  Optionally W is
// one matrix of a stack (E, N, K) picked by a device-resident index.  A
// batched entry takes B <= 16 rows of x at once (below).
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
//
// Batched entry: Y (B, N) fp32 = xs (B, K) . W^T for B <= 16 rows of bf16
//   xs (replaces src/repro/kernels/ops.py `batched_gemv`, a vmap of the
//   Pallas gemv over the rows, which streams W once per row).  Still bound
//   by the bytes of W: 2 N K + 2 B K + 4 B N bytes for 2 B N K operations,
//   at most B / 2 operations per byte.  Each block first copies xs into
//   shared memory (B K bf16, at most 227 KB), then each warp takes R W rows
//   at a time (4, or 2 for B > 8; 1 when W has too few rows to fill the
//   card that way), reads them once with 16-byte loads and
//   dots them with all B rows of xs, keeping R x B fp32 accumulators in
//   registers, so W's bytes are read once whatever B is, and each xs
//   vector read from shared memory and converted serves R rows.  The blocks
//   stride over the rows (at most what the SMs hold at once), so the copy
//   of xs is paid once a block, not once a row.  For B = 1 each sum is
//   taken in gemv's order.
#include "common.cuh"

namespace {

using repro::Vec;

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

// Each warp takes R rows of W at a time: per 16-byte step it loads the R
// rows' vectors, then converts each row of xs' vector once and uses it for
// all R rows (so the shared-memory reads and conversions of xs are 1 / R
// per W byte).
template <int MAXB, int R>
__global__ void batched_gemv_kernel(const __nv_bfloat16* __restrict__ w,
                                    const __nv_bfloat16* __restrict__ xs,
                                    float* __restrict__ y, int N, int K,
                                    int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xs_s = reinterpret_cast<uint4*>(smem);
  const int nvec = K / 8;
  const uint4* xg = reinterpret_cast<const uint4*>(xs);
  for (int i = threadIdx.x; i < B * nvec; i += blockDim.x) xs_s[i] = xg[i];
  __syncthreads();
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row0 = (blockIdx.x * warps + (threadIdx.x >> 5)) * R; row0 < N;
       row0 += gridDim.x * warps * R) {
    const uint4* wr[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      wr[r] = reinterpret_cast<const uint4*>(
          w + (size_t)min(row0 + r, N - 1) * K);
    float acc[R][MAXB];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < MAXB; ++b) acc[r][b] = 0.f;
    for (int i = lane; i < nvec; i += 32) {
      float wf[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r)
        repro::bf16x8_to_float(__ldcs(wr[r] + i), wf[r]);
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) {
          float xf[8];
          repro::bf16x8_to_float(xs_s[b * nvec + i], xf);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[r][b] = fmaf(wf[r][j], xf[j], acc[r][b]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) {
          const float s = repro::warp_sum(acc[r][b]);
          if (lane == 0 && row0 + r < N) y[(size_t)b * N + row0 + r] = s;
        }
      }
    }
  }
}

// rows of W a warp takes at a time when the rows are many (the
// accumulators are R x MAXB registers); one when they are few, so the grid
// still fills the card
template <int MAXB>
constexpr int kRows = MAXB >= 16 ? 2 : 4;

template <int MAXB, int R>
cudaError_t launch_batched(const void* w, const void* xs, void* y, int N,
                           int K, int B, int warps, int blocks,
                           cudaStream_t stream) {
  const int smem = B * K * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        batched_gemv_kernel<MAXB, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  batched_gemv_kernel<MAXB, R><<<blocks, warps * 32, smem, stream>>>(
      (const __nv_bfloat16*)w, (const __nv_bfloat16*)xs, (float*)y, N, K, B);
  return cudaGetLastError();
}

template <int MAXB>
cudaError_t launch_rows(const void* w, const void* xs, void* y, int N, int K,
                        int B, int warps, int rows, int blocks,
                        cudaStream_t stream) {
  if (rows == 1)
    return launch_batched<MAXB, 1>(w, xs, y, N, K, B, warps, blocks, stream);
  if (rows == kRows<MAXB>)
    return launch_batched<MAXB, kRows<MAXB>>(w, xs, y, N, K, B, warps,
                                             blocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// w (N, K) row-major bf16, xs (B, K) bf16 with 1 <= B <= 16, y (B, N)
// fp32; K % 8 == 0, B K 2 bytes of shared memory at most 227 KB, w and xs
// 16-byte aligned (the wrapper checks); ``rows`` W rows a warp at a time (1,
// or 4 for B <= 8 and 2 above); ``blocks`` stride over the rows.
extern "C" cudaError_t repro_batched_gemv_bf16(const void* w, const void* xs,
                                               void* y, int N, int K, int B,
                                               int warps, int rows,
                                               int blocks, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (warps < 1 || warps > 32 || K % 8 != 0 || B < 1 || B > 16 ||
      blocks < 1 || B * K * 2 > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 1)
    return launch_rows<1>(w, xs, y, N, K, B, warps, rows, blocks, s);
  if (B == 2)
    return launch_rows<2>(w, xs, y, N, K, B, warps, rows, blocks, s);
  if (B <= 4)
    return launch_rows<4>(w, xs, y, N, K, B, warps, rows, blocks, s);
  if (B <= 8)
    return launch_rows<8>(w, xs, y, N, K, B, warps, rows, blocks, s);
  return launch_rows<16>(w, xs, y, N, K, B, warps, rows, blocks, s);
}

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
