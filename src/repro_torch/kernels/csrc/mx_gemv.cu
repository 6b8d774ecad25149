// MX GEMV: y (N,) fp32 = x (K,) bf16 . dequant(W), W stored (K, N) = (in,
// out) as MX codes: fp4 e2m1 packed two per byte along K ((K/2, N) uint8,
// even k in the low nibble) or fp8 e4m3 ((K, N)), with one uint8 E8M0 scale
// 2^(s - 127) per 32-row block of a column ((K/32, N)).  The fused SwiGLU
// variant streams a gate and an up weight against the same x and writes
// g * sigmoid(g) * u.  The grouped variant takes a stack of E such weights
// ((E, K | K/2, N) codes, (E, K/32, N) scales), topk rows xs (topk, K) and
// expert ids (topk,) int32 on the device, and writes y[t] = xs[t] .
// dequant(W[ids[t]]) for each row t: the MoE experts' routed projections.
//
// Replaces: src/repro/quant/kernels.py `mx_qgemv` (`_mx_gemv_2d`: (block_k,
//   block_n) code tiles and their E8M0 rows DMA'd in lockstep, nibble
//   unpack + exp2 dequant in VMEM, fp32 accumulator committed at the last
//   K step), `mx_qgemv_swiglu` (`_mx_swiglu_kernel`: the same walk over
//   two weight streams, one x block, the silu-gate epilogue on the
//   committed accumulators) and `grouped_expert_qgemv` (`_grouped_kernel`:
//   a (row, column tile, K step) grid whose code and scale BlockSpecs are
//   indexed by the scalar-prefetched expert ids, so only the selected
//   experts' tiles are DMA'd).
// Bound on the H100: bytes.  The codes are read once (K N / 2 bytes for
//   fp4, K N for fp8) plus K N / 32 scale bytes, for 2 K N operations:
//   ~4 operations per byte, far below the ridge.  At the read-out shape
//   (K = 1024, N = 151936, fp4) that is 83 MB, ~24.9 us at 3.35 TB/s.
//   The grouped variant reads only the topk selected slices: for
//   qwen2-moe-a2.7b's experts (top-4 of 60, 2048 -> 1408 or 1408 -> 2048)
//   4 x 1.53 MB of fp4 codes and scales, ~1.83 us at 3.35 TB/s, which is
//   below the launch latency: the kernel is a latency chain, not a stream.
// Design: the stored layout is contiguous along N, so lanes own columns:
//   a lane owns 16 consecutive columns and reads one 16-byte chunk of a
//   code row per load (a warp reads 512 contiguous bytes of the row), plus
//   one 16-byte chunk of the block's scale row per 32-row block.  A warp
//   takes whole 32-row blocks, sums x_k * code over the block in fp32
//   (fp4 codes decode through a 16-entry table in shared memory, fp8 pairs
//   through the hardware e4m3x2 -> half2 conversion) and adds the block
//   sum times the block's scale to its 16 accumulators.  A block of 8 warps
//   shares one 512-column tile; its warps split the block's K range and
//   merge through shared memory.  x is staged once per block in shared
//   memory as fp32.  When the column tiles alone leave the card's 132 SMs
//   short (N = 1024, 2816: 2 and 6 tiles), the wrapper also splits K over
//   `ksplit` blocks per tile: each writes its partial sums to a workspace
//   and a second kernel adds them in split order and applies the
//   epilogue (deterministic: no atomics).  (A thread-block-cluster
//   reduction through distributed shared memory in place of the second
//   kernel measured no faster at 1024 x 1024 and slower at 2816 x 1024,
//   where a cluster holds at most 8 splits.)  The E8M0 scale is built as
//   the float bits s << 23 (s = 0 is 2^-127, a subnormal).  N must be a
//   multiple of 16 and K of 32 (the wrapper checks).  The grouped variant
//   is the same walk with a third grid axis over the topk rows: each block
//   reads its row's expert id from device memory itself (where the TPU
//   kernel had it scalar-prefetched) and offsets its code and scale
//   pointers by id x (K/pack x N) and id x (K/32 x N); x, y and the split
//   workspace are offset by the row.  The split count counts the rows too
//   (tiles x splits x rows blocks), so four 1408-column rows of 3 tiles
//   (the last one ragged: its lanes past N load nothing) split K 8 ways;
//   the second pass adds the splits in order, as for one row.  Repeated
//   ids are two rows reading the same slice.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int kCols = 16;             // columns per lane: one 16-byte load
constexpr int kTile = 32 * kCols;     // columns per block
constexpr int kWarps = 8;
constexpr int kBlockRows = 32;        // rows of K per E8M0 scale

__constant__ float kFp4[16] = {0.f,  0.5f,  1.f,  1.5f,  2.f,  3.f,
                               4.f,  6.f,   -0.f, -0.5f, -1.f, -1.5f,
                               -2.f, -3.f, -4.f, -6.f};

__device__ __forceinline__ float e8m0(unsigned s) {
  return s ? __int_as_float((int)(s << 23)) : __int_as_float(0x00400000);
}

// Adds x[k] * code(k, j) over the 32 rows of one block to blk[j] for the
// lane's 16 columns; `codes` points at the block's first code row at the
// lane's first column, `xs` at x[block * 32] in shared memory.
template <int BITS>
__device__ __forceinline__ void block_dot(const uint8_t* __restrict__ codes,
                                          size_t row_stride, const float* xs,
                                          const float* fp4, float* blk) {
  constexpr int kRows = BITS == 4 ? kBlockRows / 2 : kBlockRows;
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(
        codes + (size_t)r * row_stride));
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
    if constexpr (BITS == 4) {
      const float x0 = xs[2 * r], x1 = xs[2 * r + 1];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        blk[j] = fmaf(x0, fp4[b[j] & 15], blk[j]);
        blk[j] = fmaf(x1, fp4[b[j] >> 4], blk[j]);
      }
    } else {
      const float x0 = xs[r];
      const __nv_fp8x2_storage_t* p =
          reinterpret_cast<const __nv_fp8x2_storage_t*>(&u);
#pragma unroll
      for (int j = 0; j < kCols / 2; ++j) {
        const float2 w = __half22float2(
            __half2(__nv_cvt_fp8x2_to_halfraw2(p[j], __NV_E4M3)));
        blk[2 * j] = fmaf(x0, w.x, blk[2 * j]);
        blk[2 * j + 1] = fmaf(x0, w.y, blk[2 * j + 1]);
      }
    }
  }
}

// One warp's share of one weight stream: blocks kb0 + warp, + kWarps, ...
// below kb1, accumulated into acc[16].
template <int BITS>
__device__ __forceinline__ void stream_dot(const uint8_t* __restrict__ w,
                                           const uint8_t* __restrict__ s,
                                           const float* xs, const float* fp4,
                                           int N, int col, int kb0, int kb1,
                                           int warp, float* acc) {
  constexpr int kRows = BITS == 4 ? kBlockRows / 2 : kBlockRows;
  for (int kb = kb0 + warp; kb < kb1; kb += kWarps) {
    float blk[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) blk[j] = 0.f;
    block_dot<BITS>(w + (size_t)kb * kRows * N + col, (size_t)N,
                    xs + (kb - kb0) * kBlockRows, fp4, blk);
    const uint4 su = __ldcs(reinterpret_cast<const uint4*>(
        s + (size_t)kb * N + col));
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(&su);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[j] = fmaf(blk[j], e8m0(sb[j]), acc[j]);
  }
}

__device__ __forceinline__ float silu_gate(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// grid (column tiles, ksplit, rows); block kWarps warps.  Block (t, z, r)
// covers columns [t * kTile, (t + 1) * kTile) and the 32-row blocks
// [z * kbs, min((z + 1) * kbs, K / 32)) of row r.  SWIGLU: two streams
// (gate w0, up w1).  ids (grouped, one stream): row r reads the weight
// ids[r] of the stack.  ksplit == 1 writes y (with the epilogue);
// otherwise the partial sums go to work[r][z][N] (and work[r][ksplit +
// z][N] for up).
template <int BITS, bool SWIGLU>
__global__ void __launch_bounds__(kWarps * 32)
    mx_gemv_kernel(const uint8_t* __restrict__ w0,
                   const uint8_t* __restrict__ s0,
                   const uint8_t* __restrict__ w1,
                   const uint8_t* __restrict__ s1,
                   const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                   float* __restrict__ work, const int* __restrict__ ids,
                   int N, int K, int kbs) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float fp4[16];
  const int nkb = K / kBlockRows;
  const int r = blockIdx.z;
  if (ids != nullptr) {
    const size_t e = (size_t)__ldg(ids + r);
    w0 += e * (size_t)(BITS == 4 ? K / 2 : K) * N;
    s0 += e * (size_t)nkb * N;
  }
  x += (size_t)r * K;
  y += (size_t)r * N;
  work += (size_t)r * (SWIGLU ? 2 : 1) * gridDim.y * N;
  const int kb0 = blockIdx.y * kbs, kb1 = min(nkb, kb0 + kbs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * kTile + lane * kCols;
  const int nstreams = SWIGLU ? 2 : 1;
  float* xs = smem;                                     // (kb1-kb0)*32
  float* red = smem + kbs * kBlockRows;                 // [s][warp][kTile]
  if (threadIdx.x < 16) fp4[threadIdx.x] = kFp4[threadIdx.x];
  for (int i = threadIdx.x; i < (kb1 - kb0) * kBlockRows; i += blockDim.x)
    xs[i] = __bfloat162float(x[kb0 * kBlockRows + i]);
  __syncthreads();

  float acc[2][kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[0][j] = acc[1][j] = 0.f;
  if (col < N) {
    stream_dot<BITS>(w0, s0, xs, fp4, N, col, kb0, kb1, warp, acc[0]);
    if constexpr (SWIGLU)
      stream_dot<BITS>(w1, s1, xs, fp4, N, col, kb0, kb1, warp, acc[1]);
  }
  for (int st = 0; st < nstreams; ++st) {
    float4* dst = reinterpret_cast<float4*>(
        red + (st * kWarps + warp) * kTile + lane * kCols);
#pragma unroll
    for (int j = 0; j < kCols / 4; ++j)
      dst[j] = make_float4(acc[st][4 * j], acc[st][4 * j + 1],
                           acc[st][4 * j + 2], acc[st][4 * j + 3]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kTile; c += blockDim.x) {
    const int n = blockIdx.x * kTile + c;
    if (n >= N) continue;
    float v[2] = {0.f, 0.f};
    for (int st = 0; st < nstreams; ++st)
      for (int wi = 0; wi < kWarps; ++wi)
        v[st] += red[(st * kWarps + wi) * kTile + c];
    if (gridDim.y == 1) {
      y[n] = SWIGLU ? silu_gate(v[0], v[1]) : v[0];
    } else {
      work[(size_t)blockIdx.y * N + n] = v[0];
      if constexpr (SWIGLU)
        work[(size_t)(gridDim.y + blockIdx.y) * N + n] = v[1];
    }
  }
}

// y[n] = sum over the ksplit partials (in split order), then the epilogue;
// grid (column blocks, rows).
template <bool SWIGLU>
__global__ void mx_reduce_kernel(const float* __restrict__ work,
                                 float* __restrict__ y, int N, int ksplit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  work += (size_t)blockIdx.y * (SWIGLU ? 2 : 1) * ksplit * N;
  y += (size_t)blockIdx.y * N;
  float g = 0.f, u = 0.f;
  for (int z = 0; z < ksplit; ++z) {
    g += work[(size_t)z * N + n];
    if constexpr (SWIGLU) u += work[(size_t)(ksplit + z) * N + n];
  }
  y[n] = SWIGLU ? silu_gate(g, u) : g;
}

template <int BITS, bool SWIGLU>
cudaError_t launch(const void* w0, const void* s0, const void* w1,
                   const void* s1, const void* x, void* y, void* work,
                   const void* ids, int rows, int N, int K, int ksplit,
                   cudaStream_t stream) {
  const int nkb = K / kBlockRows;
  const int kbs = (nkb + ksplit - 1) / ksplit;
  const int tiles = (N + kTile - 1) / kTile;
  const int smem = (kbs * kBlockRows + (SWIGLU ? 2 : 1) * kWarps * kTile) *
                   (int)sizeof(float);
  auto kern = mx_gemv_kernel<BITS, SWIGLU>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(tiles, ksplit, rows), kWarps * 32, smem, stream>>>(
      (const uint8_t*)w0, (const uint8_t*)s0, (const uint8_t*)w1,
      (const uint8_t*)s1, (const __nv_bfloat16*)x, (float*)y, (float*)work,
      (const int*)ids, N, K, kbs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ksplit == 1) return e;
  mx_reduce_kernel<SWIGLU><<<dim3((N + 255) / 256, rows), 256, 0, stream>>>(
      (const float*)work, (float*)y, N, ksplit);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* w0, const void* s0, const void* w1,
                     const void* s1, const void* x, void* y, void* work,
                     const void* ids, int rows, int N, int K, int bits,
                     int ksplit, bool swiglu, void* stream) {
  if (N <= 0 || rows <= 0) return cudaSuccess;
  const int nkb = K / kBlockRows;
  if (K <= 0 || K % kBlockRows || N % kCols || ksplit < 1 || ksplit > nkb ||
      rows > 65535 || (bits != 4 && bits != 8) || (swiglu && ids))
    return cudaErrorInvalidValue;
  // every split must own at least one block of rows
  if ((ksplit - 1) * ((nkb + ksplit - 1) / ksplit) >= nkb)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 4)
    return swiglu ? launch<4, true>(w0, s0, w1, s1, x, y, work, ids, rows,
                                    N, K, ksplit, s)
                  : launch<4, false>(w0, s0, w1, s1, x, y, work, ids, rows,
                                     N, K, ksplit, s);
  return swiglu ? launch<8, true>(w0, s0, w1, s1, x, y, work, ids, rows, N,
                                  K, ksplit, s)
                : launch<8, false>(w0, s0, w1, s1, x, y, work, ids, rows, N,
                                   K, ksplit, s);
}

}  // namespace

// w (K/2 | K, N) uint8 codes (fp4 packed | fp8 e4m3 bytes); s (K/32, N)
// uint8 E8M0; x (K,) bf16; y (N,) fp32; work (ksplit, N) fp32 when ksplit
// > 1 (else unused).  All 16-byte aligned, N % 16 == 0, K % 32 == 0.
extern "C" cudaError_t repro_mx_gemv(const void* w, const void* s,
                                     const void* x, void* y, void* work,
                                     int N, int K, int bits, int ksplit,
                                     void* stream) {
  return dispatch(w, s, nullptr, nullptr, x, y, work, nullptr, 1, N, K,
                  bits, ksplit, false, stream);
}

// The fused SwiGLU: gate (wg, sg) and up (wu, su) as above, y = silu(x.Wg)
// * (x.Wu); work (2 * ksplit, N) fp32 when ksplit > 1.
extern "C" cudaError_t repro_mx_gemv_swiglu(const void* wg, const void* sg,
                                            const void* wu, const void* su,
                                            const void* x, void* y,
                                            void* work, int N, int K,
                                            int bits, int ksplit,
                                            void* stream) {
  return dispatch(wg, sg, wu, su, x, y, work, nullptr, 1, N, K, bits,
                  ksplit, true, stream);
}

// The grouped expert GEMV: w (E, K/2 | K, N) uint8 codes, s (E, K/32, N)
// uint8 E8M0, xs (rows, K) bf16, ids (rows,) int32 expert ids in [0, E)
// on the device, y (rows, N) fp32; work (rows, ksplit, N) fp32 when ksplit
// > 1.  All 16-byte aligned, N % 16 == 0, K % 32 == 0.
extern "C" cudaError_t repro_mx_gemv_grouped(const void* w, const void* s,
                                             const void* xs, const void* ids,
                                             void* y, void* work, int rows,
                                             int N, int K, int bits,
                                             int ksplit, void* stream) {
  if (ids == nullptr) return cudaErrorInvalidValue;
  return dispatch(w, s, nullptr, nullptr, xs, y, work, ids, rows, N, K,
                  bits, ksplit, false, stream);
}
