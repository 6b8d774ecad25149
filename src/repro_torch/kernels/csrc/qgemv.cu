// Quantized GEMV: Y (B, N) fp32 = xs (B, K) bf16 . dequant(W)^T for
// 1 <= B <= 16 rows of x (B = 1 is the one-row `qgemv`), W stored (N, K)
// as absmax codes: int8 (N, K), or int4 packed two a byte along K
// ((N, K/2) int8, even k in the low nibble), with one fp32 scale per group
// of g codes of a row ((N, K/g)).
//
// Replaces: src/repro/quant/kernels.py `qgemv` and `batched_qgemv`
//   (`_qgemv_2d`: (block_n, block_k) code tiles, their scale blocks and the
//   matching x slice DMA'd in lockstep along K, two K halves in flight when
//   streams = 2, nibble unpack + scale multiply in VMEM (`_dequant_block`),
//   an fp32 accumulator committed at the last K step; the batch rides the
//   lane dimension, so W streams once whatever B is).
// Bound on the H100: bytes.  The codes are read once (N K bytes in int8,
//   N K / 2 in int4) with N K / g fp32 scales, for 2 B N K operations: at
//   most 2 B / (1/2 + 4/g) operations per byte (int4), far below the
//   ridge.  At the read-out shape (151936 x 1024, g = 128) that is 161 MB
//   in int8 (48.1 us at 3.35 TB/s) and 83 MB in int4 (24.9 us).
// Design: gemv.cu's warp-per-row walk with batched_gemv's shared xs.  Each
//   block first copies xs (B K bf16) into shared memory; each warp then
//   takes R rows of W at a time (R = 1, 2 or 4), the warps of the grid
//   striding over the rows, so the copy is paid once a block.  A lane
//   reads 16-byte vectors of its rows (16 int8 codes or 32 int4 codes,
//   loads that bypass L1: each byte is used once) and its groups' scales,
//   decodes the codes without the conversion unit (int8: each byte
//   permuted into the mantissa of 2^23; int4: the low and high nibbles
//   masked apart, each biased by 8, then the same permute; the result is
//   the sign-extended nibble of `(int8_t)(b << 4) >> 4` for the even k and
//   `(int8_t)b >> 4` for the odd k), multiplies each code by its group's
//   scale in fp32 (the JAX `_dequant_block`) and adds its product with x
//   (fp32, fma) to one accumulator per (row, row of xs).  Each code is
//   decoded and scaled once for all B rows of xs, and each xs vector read
//   from shared memory serves the warp's R rows (xs is laid out so that a
//   warp's reads are consecutive 16-byte units; with one row of xs, two
//   accumulators a row halve the fma chain of a vector).  A 5-step shuffle
//   reduction gives each dot product, written by lane 0.  K must hold
//   whole 16-byte vectors (int8: K % 16, int4: K % 32 == 0) and a group
//   whole vectors; the wrapper refuses anything else rather than switch to
//   another kernel.
#include "common.cuh"

namespace {

template <int BITS>
struct Codes;

// 16 int8 codes a vector; chunk c (0..1) is codes 8c .. 8c + 7, times s.
template <>
struct Codes<8> {
  static constexpr int kPerVec = 16;
  __device__ __forceinline__ static void chunk(const uint4& u, int c, float s,
                                               float* w) {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t b = v[2 * c + h] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[4 * h + k] = repro::biased_byte_to_float(b, k) * s;
    }
  }
};

// 32 int4 codes a vector; chunk c (0..3) is word c: byte j holds codes
// 8c + 2j (low nibble) and 8c + 2j + 1 (high nibble).  XOR 0x8 on a nibble
// adds 8 to its two's-complement value, so each masked byte is the code
// + 8, and 2^23 + 8 comes off.
template <>
struct Codes<4> {
  static constexpr int kPerVec = 32;
  __device__ __forceinline__ static void chunk(const uint4& u, int c, float s,
                                               float* w) {
    const uint32_t v = reinterpret_cast<const uint32_t*>(&u)[c] ^ 0x88888888u;
    const uint32_t lo = v & 0x0F0F0F0Fu, hi = (v >> 4) & 0x0F0F0F0Fu;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[2 * j] =
          (__int_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 + j)) -
           8388616.f) * s;
      w[2 * j + 1] =
          (__int_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 + j)) -
           8388616.f) * s;
    }
  }
};

// xs (B, K) bf16 goes to shared memory; warp-row pairs as above.  G groups
// a row (g = K / G codes each).
template <int BITS, int MAXB, int R>
__global__ void qgemv_kernel(const uint8_t* __restrict__ w,
                             const float* __restrict__ scales,
                             const __nv_bfloat16* __restrict__ xs,
                             float* __restrict__ y, int N, int K, int G,
                             int B) {
  constexpr int PV = Codes<BITS>::kPerVec;       // codes a 16-byte vector
  constexpr int CH = PV / 8;                     // 8-code chunks a vector
  extern __shared__ __align__(16) unsigned char smem[];
  // xs in shared memory as [b][chunk c][vector i] of 8 bf16 (one uint4):
  // the lanes of a warp read the same (b, c) of consecutive vectors, so
  // one read touches consecutive 16-byte units (no bank conflicts)
  uint4* xs_s = reinterpret_cast<uint4*>(smem);
  const int kv8 = K / 8;
  const int nvec = K / PV;
  const uint4* xg = reinterpret_cast<const uint4*>(xs);
  for (int u = threadIdx.x; u < B * kv8; u += blockDim.x) {
    const int b = u / kv8, v = u - b * kv8;
    xs_s[(b * CH + v % CH) * nvec + v / CH] = xg[u];
  }
  __syncthreads();
  const int vpg = K / G / PV;                    // vectors a group
  const size_t row_bytes = (size_t)K * BITS / 8;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row0 = (blockIdx.x * warps + (threadIdx.x >> 5)) * R; row0 < N;
       row0 += gridDim.x * warps * R) {
    const uint4* wr[R];
    const float* sr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = min(row0 + r, N - 1);
      wr[r] = reinterpret_cast<const uint4*>(w + (size_t)row * row_bytes);
      sr[r] = scales + (size_t)row * G;
    }
    // one row of xs: two accumulators a row (even and odd chunks), so the
    // fma chain of a vector is half as long
    constexpr int P = MAXB == 1 ? 2 : 1;
    float acc[R][MAXB][P];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int b = 0; b < MAXB; ++b)
#pragma unroll
        for (int h = 0; h < P; ++h) acc[r][b][h] = 0.f;
    for (int i = lane; i < nvec; i += 32) {
      uint4 u[R];
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        u[r] = __ldcs(wr[r] + i);
        s[r] = __ldg(sr[r] + i / vpg);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float wf[R][8];
#pragma unroll
        for (int r = 0; r < R; ++r) Codes<BITS>::chunk(u[r], c, s[r], wf[r]);
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b < B) {
            float xf[8];
            repro::bf16x8_to_float(xs_s[(b * CH + c) * nvec + i], xf);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[r][b][c % P] = fmaf(wf[r][j], xf[j], acc[r][b][c % P]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b < B) {
          float v = acc[r][b][0];
#pragma unroll
          for (int h = 1; h < P; ++h) v += acc[r][b][h];
          v = repro::warp_sum(v);
          if (lane == 0 && row0 + r < N) y[(size_t)b * N + row0 + r] = v;
        }
      }
    }
  }
}

template <int BITS, int MAXB, int R>
cudaError_t launch(const void* w, const void* scales, const void* xs, void* y,
                   int N, int K, int G, int B, int warps, int blocks,
                   cudaStream_t stream) {
  const int smem = B * K * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qgemv_kernel<BITS, MAXB, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  qgemv_kernel<BITS, MAXB, R><<<blocks, warps * 32, smem, stream>>>(
      (const uint8_t*)w, (const float*)scales, (const __nv_bfloat16*)xs,
      (float*)y, N, K, G, B);
  return cudaGetLastError();
}

template <int BITS, int MAXB>
cudaError_t launch_rows(const void* w, const void* scales, const void* xs,
                        void* y, int N, int K, int G, int B, int warps,
                        int rows, int blocks, cudaStream_t stream) {
  if (rows == 1)
    return launch<BITS, MAXB, 1>(w, scales, xs, y, N, K, G, B, warps, blocks,
                                 stream);
  if (rows == 2)
    return launch<BITS, MAXB, 2>(w, scales, xs, y, N, K, G, B, warps, blocks,
                                 stream);
  if (rows == 4)
    return launch<BITS, MAXB, 4>(w, scales, xs, y, N, K, G, B, warps, blocks,
                                 stream);
  return cudaErrorInvalidValue;
}

template <int BITS>
cudaError_t launch_batch(const void* w, const void* scales, const void* xs,
                         void* y, int N, int K, int G, int B, int warps,
                         int rows, int blocks, cudaStream_t s) {
  if (B == 1)
    return launch_rows<BITS, 1>(w, scales, xs, y, N, K, G, B, warps, rows,
                                blocks, s);
  if (B == 2)
    return launch_rows<BITS, 2>(w, scales, xs, y, N, K, G, B, warps, rows,
                                blocks, s);
  if (B <= 4)
    return launch_rows<BITS, 4>(w, scales, xs, y, N, K, G, B, warps, rows,
                                blocks, s);
  if (B <= 8)
    return launch_rows<BITS, 8>(w, scales, xs, y, N, K, G, B, warps, rows,
                                blocks, s);
  return launch_rows<BITS, 16>(w, scales, xs, y, N, K, G, B, warps, rows,
                               blocks, s);
}

}  // namespace

// w (N, K) int8 codes (bits 8) or (N, K/2) packed int4 (bits 4); scales
// (N, G) fp32, G dividing K with K / G a multiple of the vector (16 int8 or
// 32 int4 codes); xs (B, K) bf16, 1 <= B <= 16, B K 2 bytes at most 227
// KB; y (B, N) fp32; w, xs 16-byte aligned (the wrapper checks).  ``rows``
// (1, 2 or 4) W rows a warp at a time; ``blocks`` stride over the rows.
extern "C" cudaError_t repro_qgemv(const void* w, const void* scales,
                                   const void* xs, void* y, int N, int K,
                                   int G, int B, int bits, int warps,
                                   int rows, int blocks, void* stream) {
  if (N <= 0) return cudaSuccess;
  const int pv = bits == 4 ? 32 : 16;
  if ((bits != 4 && bits != 8) || warps < 1 || warps > 32 || B < 1 ||
      B > 16 || blocks < 1 || K <= 0 || K % pv || G < 1 || K % G ||
      (K / G) % pv || B * K * 2 > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 4)
    return launch_batch<4>(w, scales, xs, y, N, K, G, B, warps, rows, blocks,
                           s);
  return launch_batch<8>(w, scales, xs, y, N, K, G, B, warps, rows, blocks,
                         s);
}
