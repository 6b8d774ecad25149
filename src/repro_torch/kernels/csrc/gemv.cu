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
//   (60 x 2048 fp32, 0.49 MB), the experts (1408 x 2048 bf16, 5.8 MB) and
//   the (1024, 1024) projections (2 MB) are small enough that the launch
//   and the rounds of device-memory latency a warp waits for set the time.
// Design: `ksplit` warps a row (`gemv_kernel`), a block of `gemv_warps`
//   warps taking warps / ksplit rows.  A row is walked in steps of 64
//   16-byte vectors (8 bf16 or 4 fp32 each; lane l holds vectors l and
//   32 + l of a step), and the row's warps take every ksplit-th step.  A
//   lane issues the loads of two of its steps (4 vectors of W, bypassing
//   L1 since the row is used once, and the matching vectors of x, small
//   and reused by every warp, through the read-only cache) before its first
//   FMA, so a warp whose share of the row is at most two steps waits for
//   device memory once; more loads a lane would cost registers, so fewer
//   warps an SM and fewer bytes in flight at the read-out.  It multiplies in fp32 and keeps one accumulator,
//   vector by vector in the order of K; a 5-step shuffle reduction gives
//   the warp's sum; with ksplit > 1 the row's sums meet in shared memory
//   and its first warp adds them in warp order, so the same inputs give the
//   same bits, with no atomics and no second launch.  The wrapper works out
//   ksplit from (N, K, warps, SMs) (kernels/gemv.py `gemv_ksplit`): it
//   doubles while it divides the block's warps, leaves every warp at least
//   one whole step, and keeps the row warps within 32 an SM.  The
//   read-outs (151936 rows) stay at ksplit 1, whose order of the adds is
//   the one-warp-a-row walk's: their bits do not depend on the split.  The
//   router (60 x 2048 fp32: 8 steps) takes 8 warps a row at 8 warps a
//   block, the (1024, 1024) projections 2.  K need not be a multiple of a
//   step: a vector past K is loaded clamped into the row and not added (K
//   = 2816 is 5.5 steps).  K must be a multiple of the vector (8 bf16, 4
//   fp32) and w, x 16-byte aligned; the wrapper refuses anything else
//   rather than switch to a slower kernel.  With an index (the bf16 routed
//   MoE path, `moe.py:173-185` in the JAX package) every block reads the
//   expert id from device memory itself and offsets W by id * N * K, so
//   the host never reads the router's choice and no expert slice is copied.
//
// Batched entry: Y (B, N) fp32 = xs (B, K) . W^T for B <= 16 rows of bf16
//   xs (replaces src/repro/kernels/ops.py `batched_gemv`, a vmap of the
//   Pallas gemv over the rows, which streams W once per row).  Still bound
//   by the bytes of W: 2 N K + 2 B K + 4 B N bytes for 2 B N K operations,
//   at most B / 2 operations per byte.  So the products go to the tensor
//   cores, and the CUDA cores only move bytes: `mma.sync.m16n8k16` (bf16
//   in, fp32 accumulators) takes W as A, 16 rows by 16 k, and xs as B, its
//   rows as the 8 columns (one n-tile for B <= 8, two up to 16, the unused
//   columns zero); one instruction does the 2,048 multiply-adds that took
//   2,048 FMAs (plus the conversions and the shared loads of xs that kept
//   the SIMT kernel issue-bound at the read-out).  A warp owns a tile of 16
//   W rows and walks K in steps of 64: each lane loads 16 k of its two rows
//   (g = lane / 4 and g + 8) as two 16-byte streaming loads, 8 k at 8 qd
//   and at 32 + 8 qd (qd = lane % 4, so each load of a quad is 64
//   contiguous bytes of a row), and the same k of xs row g through the
//   read-only cache (xs is small and every warp reads it; no block copies
//   it).  A lane's 8 k of a vector sit at the fragment's k positions of two
//   mma (words 0-1 of the vector as one k-step of 16, words 2-3 as
//   another, xs permuted the same way): a dot product does not care about
//   the order of k within a step.  Four steps of loads are in flight before
//   their products.  The warps of a block split K (`ksplit` of them on one
//   tile, each taking every ksplit-th step) when the tiles are too few to
//   fill the card, e.g. (2048, 4096): 128 tiles x 8 warps; their partials meet
//   in shared memory and the first warp adds them in a fixed order, so the
//   same inputs give the same bits, with no atomics and no second launch.
//   A step past K (K % 64 != 0; K % 8 == 0) and rows past N load zeros.
//   B = 1 launches gemv's kernel, so its bits are gemv's.  Knobs: the
//   config's `gemv_warps` is the warps a block (at most 16, the kernel's
//   launch bound); `ksplit` is worked out from the shape by the wrapper
//   (kernels/gemv.py `split_k`).
#include "common.cuh"

namespace {

using repro::mma_bf16;
using repro::Vec;

constexpr int kRowVecs = 2;   // 16-byte loads a lane per step of a row
constexpr int kRowSteps = 2;  // steps whose loads a lane issues at once

// ksplit warps of a block share a row: warp w takes row blockIdx.x *
// (warps / ksplit) + w / ksplit and the steps w % ksplit, w % ksplit +
// ksplit, ... (a step: 64 16-byte vectors, lane l holding vectors l and
// 32 + l of it).  Each lane issues the loads of kRowSteps of its steps
// before the first FMA, and adds vector by vector in the order of K; with
// ksplit 1 that is the order i = l, 32 + l, 64 + l, ... of the
// one-warp-a-row walk.  The warps' sums meet in shared memory and the
// first adds them in warp order.
template <typename T>
__global__ void gemv_kernel(const T* __restrict__ w, const T* __restrict__ x,
                            const int* __restrict__ index,
                            float* __restrict__ y, int N, int K,
                            int ksplit) {
  constexpr int V = Vec<T>::n;
  __shared__ float part[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * ((blockDim.x >> 5) / ksplit) + warp / ksplit;
  const int wk = warp % ksplit;
  const bool live = row < N;
  if (index != nullptr) w += (size_t)__ldg(index) * N * K;
  const int nvec = K / V, steps = (nvec + 63) / 64;
  const uint4* wr =
      reinterpret_cast<const uint4*>(w + (size_t)min(row, N - 1) * K);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  float acc = 0.f;
  for (int s0 = wk; live && s0 < steps; s0 += ksplit * kRowSteps) {
    // vector i of step s: 64 s + 32 v + lane; a step past the row is not
    // loaded, and in the last one a vector past K is clamped into the row,
    // loaded and not added
    uint4 a[kRowSteps][kRowVecs], b[kRowSteps][kRowVecs];
#pragma unroll
    for (int u = 0; u < kRowSteps; ++u)
      if (s0 + u * ksplit < steps) {
#pragma unroll
        for (int v = 0; v < kRowVecs; ++v) {
          const int i =
              min((s0 + u * ksplit) * 64 + 32 * v + lane, nvec - 1);
          a[u][v] = __ldcs(wr + i);
          b[u][v] = __ldg(xv + i);
        }
      }
    // ptxas keeps loads above a warp barrier (it orders memory): without
    // it, it sinks each load to just before its product
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kRowSteps; ++u)
#pragma unroll
      for (int v = 0; v < kRowVecs; ++v)
        if ((s0 + u * ksplit) * 64 + 32 * v + lane < nvec) {
          float wf[V], xf[V];
          Vec<T>::load(a[u][v], wf);
          Vec<T>::load(b[u][v], xf);
#pragma unroll
          for (int j = 0; j < V; ++j) acc = fmaf(wf[j], xf[j], acc);
        }
  }
  acc = repro::warp_sum(acc);
  if (ksplit > 1) {
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (wk != 0 || lane != 0 || !live) return;
    for (int k2 = 1; k2 < ksplit; ++k2) acc += part[warp + k2];
    y[row] = acc;
  } else if (lane == 0 && live) {
    y[row] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* w, const void* x, const void* index, void* y,
                   int N, int K, int warps, int ksplit, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (warps < 1 || warps > 32 || ksplit < 1 || warps % ksplit != 0 ||
      K % Vec<T>::n != 0)
    return cudaErrorInvalidValue;
  const int rows = warps / ksplit;
  gemv_kernel<T><<<(N + rows - 1) / rows, warps * 32, 0,
                   (cudaStream_t)stream>>>((const T*)w, (const T*)x,
                                           (const int*)index, (float*)y, N, K,
                                           ksplit);
  return cudaGetLastError();
}

constexpr int kStep = 64;    // k a warp takes per step: 16 a lane
constexpr int kInFlight = 4;  // steps whose loads are issued together

// NT n-tiles of 8 xs rows; warp w of a block takes tile blockIdx.x * (warps
// / ksplit) + w / ksplit and every ksplit-th step from w % ksplit
template <int NT>
__global__ void __launch_bounds__(512)
    batched_gemv_kernel(const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ xs,
                        float* __restrict__ y, int N, int K, int B,
                        int ksplit) {
  extern __shared__ float part[];  // [warp][16 rows][8 NT columns]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int wk = warp % ksplit;
  const int tile = blockIdx.x * ((blockDim.x >> 5) / ksplit) + warp / ksplit;
  const int row0 = tile * 16 + g, row1 = row0 + 8;
  const bool ok0 = row0 < N, ok1 = row1 < N;
  const int nvec = K / 8, steps = (K + kStep - 1) / kStep;
  const uint4* w0 =
      reinterpret_cast<const uint4*>(w) + (size_t)min(row0, N - 1) * nvec;
  const uint4* w1 =
      reinterpret_cast<const uint4*>(w) + (size_t)min(row1, N - 1) * nvec;
  const uint4* xv[NT];
  bool xok[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    xok[nt] = 8 * nt + g < B;
    xv[nt] = reinterpret_cast<const uint4*>(xs) +
             (size_t)(xok[nt] ? 8 * nt + g : 0) * nvec;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int s0 = wk; s0 < steps; s0 += ksplit * kInFlight) {
    // vector v of a lane: k = 64 step + 32 v + 8 qd.. (a quad's loads are
    // 64 contiguous bytes of a row); clamped into the row, not predicated
    uint4 a[kInFlight][2][2];  // [step][row g, g + 8][vector]
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i =
            min((s0 + u * ksplit) * (kStep / 8) + qd + 4 * v, nvec - 1);
        a[u][0][v] = __ldcs(w0 + i);
        a[u][1][v] = __ldcs(w1 + i);
      }
    // ptxas keeps loads above a warp barrier (it orders memory): without
    // it, it sinks each load to just before its product
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = (s0 + u * ksplit) * (kStep / 8) + qd + 4 * v;
        const bool in = i < nvec;
        const uint4 r0 = in && ok0 ? a[u][0][v] : zero;
        const uint4 r1 = in && ok1 ? a[u][1][v] : zero;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4 xl = __ldg(xv[nt] + min(i, nvec - 1));
          const uint4 x = in && xok[nt] ? xl : zero;
          mma_bf16(acc[nt], r0.x, r1.x, r0.y, r1.y, x.x, x.y);
          mma_bf16(acc[nt], r0.z, r1.z, r0.w, r1.w, x.z, x.w);
        }
      }
  }

  // c[0..1]: row g, columns 8 nt + 2 qd + {0, 1}; c[2..3]: row g + 8
  if (ksplit > 1) {
    constexpr int W = 16 * 8 * NT;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[warp * W + (g + 8 * (e >> 1)) * 8 * NT + 8 * nt + 2 * qd +
             (e & 1)] = acc[nt][e];
    __syncthreads();
    if (wk != 0) return;
    for (int k2 = 1; k2 < ksplit; ++k2)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nt][e] += part[(warp + k2) * W +
                             (g + 8 * (e >> 1)) * 8 * NT + 8 * nt +
                             2 * qd + (e & 1)];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * nt + 2 * qd + e;
      if (n < B) {
        if (ok0) y[(size_t)n * N + row0] = acc[nt][e];
        if (ok1) y[(size_t)n * N + row1] = acc[nt][2 + e];
      }
    }
}

template <int NT>
cudaError_t launch_batched(const void* w, const void* xs, void* y, int N,
                           int K, int B, int warps, int ksplit,
                           cudaStream_t stream) {
  const int per_block = warps / ksplit;
  const int blocks = ((N + 15) / 16 + per_block - 1) / per_block;
  const int smem = ksplit > 1 ? warps * 16 * 8 * NT * 4 : 0;
  batched_gemv_kernel<NT><<<blocks, warps * 32, smem, stream>>>(
      (const __nv_bfloat16*)w, (const __nv_bfloat16*)xs, (float*)y, N, K, B,
      ksplit);
  return cudaGetLastError();
}

}  // namespace

// w (N, K) row-major bf16, xs (B, K) bf16 with 1 <= B <= 16, y (B, N)
// fp32; K % 8 == 0, w and xs 16-byte aligned (the wrapper checks); warps
// 1..16 a block, ``ksplit`` of them (a divisor of warps) on each 16-row
// tile.  B = 1 is gemv (``ksplit`` warps a row, gemv's split).
extern "C" cudaError_t repro_batched_gemv_bf16(const void* w, const void* xs,
                                               void* y, int N, int K, int B,
                                               int warps, int ksplit,
                                               void* stream) {
  if (N <= 0) return cudaSuccess;
  if (warps < 1 || warps > 16 || ksplit < 1 || warps % ksplit != 0 ||
      K % 8 != 0 || B < 1 || B > 16)
    return cudaErrorInvalidValue;
  if (B == 1)
    return launch<__nv_bfloat16>(w, xs, nullptr, y, N, K, warps, ksplit,
                                 stream);
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 8) return launch_batched<1>(w, xs, y, N, K, B, warps, ksplit, s);
  return launch_batched<2>(w, xs, y, N, K, B, warps, ksplit, s);
}

// w (N, K) row-major, or a stack (E, N, K) with index -> one int32 expert
// id on the device (null: no stack); x (K,); y (N,) fp32.  bf16: K % 8 ==
// 0; fp32: K % 4 == 0; w, x 16-byte aligned (the wrapper checks); warps
// 1..32 a block, ``ksplit`` of them (a divisor of warps) on each row.
extern "C" cudaError_t repro_gemv_bf16(const void* w, const void* x,
                                       const void* index, void* y, int N,
                                       int K, int warps, int ksplit,
                                       void* stream) {
  return launch<__nv_bfloat16>(w, x, index, y, N, K, warps, ksplit, stream);
}

extern "C" cudaError_t repro_gemv_f32(const void* w, const void* x,
                                      const void* index, void* y, int N,
                                      int K, int warps, int ksplit,
                                      void* stream) {
  return launch<float>(w, x, index, y, N, K, warps, ksplit, stream);
}
