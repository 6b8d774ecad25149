// Quantized GEMV: Y (B, N) fp32 = xs (B, K) bf16 . dequant(W)^T for
// 1 <= B <= 16 rows of x (B = 1 is the one-row `qgemv`), W stored (N, K)
// as absmax codes: int8 (N, K), or int4 packed two a byte along K
// ((N, K/2) int8, even k in the low nibble), with one fp32 scale per group
// of g codes of a row ((N, K/g)).
//
// Replaces: src/repro/quant/kernels.py `qgemv` (:174) and `batched_qgemv`
//   (:191) (`_qgemv_2d`: (block_n, block_k) code tiles, their scale blocks
//   and the matching x slice DMA'd in lockstep along K, two K halves in
//   flight when streams = 2, nibble unpack + scale multiply in VMEM
//   (`_dequant_block`), an fp32 accumulator committed at the last K step;
//   the batch rides the lane dimension, so W streams once whatever B is).
// Bound on the H100: bytes.  The codes are read once (N K bytes in int8,
//   N K / 2 in int4) with N K / g fp32 scales, for 2 B N K operations: at
//   most 2 B / (1/2 + 4/g) operations per byte (int4), far below the
//   ridge.  At the read-out shape (151936 x 1024, g = 128) that is 161 MB
//   in int8 (48.1 us at 3.35 TB/s; 49.4 with 8 rows of x and y) and 83 MB
//   in int4 (24.9 us; 26.1 with 8 rows).
//
// Two kernels, picked by the wrapper's plan (kernels/qgemv.py
// `batched_qgemv_plan`, which says which and why):
//
// The tile walk, 1 <= B <= 16 (`qgemv_mma_kernel`).  The SIMT walk below
//   decodes and scales each code, then spends B fp32 FMAs on it, each after
//   a shared-memory read of xs and a bf16 -> fp32 conversion: at B = 8 that
//   is bound by the instructions it issues, not by bytes.  So the products
//   go to the tensor cores, on the tile structure of gemv.cu's batched
//   kernel: `mma.sync.m16n8k16`, bf16 in, fp32 accumulators, W as A (16
//   rows by 16 k) and xs as B (its rows as the 8 columns: one n-tile for
//   B <= 8, two up to 16).
//   - A warp owns a tile of 16 W rows.  A k-step is one 16-byte streaming
//     load of each of its two rows a lane (rows g = lane / 4 and g + 8, the
//     vector at qd = lane % 4: a quad reads 64 contiguous bytes of a row),
//     so 64 k in int8 and 128 in int4.  A lane walks its steps in rounds:
//     it issues the loads of a round's steps (codes, and the scales of the
//     groups that end in it) before their products.
//   - The codes are decoded in registers, exactly.  int4: the nibbles of
//     k and k + 4 of a word are masked into the low and high halves of a
//     bf16x2 under the magic exponent 0x4300 (128 + n, the nibble biased
//     by 8 with an XOR), and 136 comes off with one __hsub2.  int8: a byte
//     needs 8 significant bits, one more than bf16 keeps behind a 2^7
//     bias, so each byte is permuted into the mantissa of 2^23 (fp32), the
//     bias comes off in fp32, and cvt.rn.bf16x2.f32 packs two (|c| <= 128
//     is exact in bf16).  x stays bf16: the block copies xs into shared
//     memory once, while its warps' first loads of codes are in flight,
//     each row padded by 16 bytes so that a step's reads hit every bank
//     equally often, and a lane reads it in its codes' k order (int4: a
//     byte_perm pairs x[k] with x[k + 4]).
//   - The group scale comes after the group's products: each product c x
//     is exact in fp32, the mma sums a group's into a partial, and s[row,
//     group] x partial is added to the running sum in fp32.  That is
//     (sum c x) s where the JAX `_dequant_block` computes sum (c s) x: the
//     same function, summed in another order.  So a group must hold whole
//     k-steps (g % 64 in int8, g % 128 in int4); the registry's and the
//     smoke's g = 128 does.
//   - Where the tiles are too few to fill the card, the warps of a block
//     split K (`ksplit` of them on one tile, each taking every ksplit-th
//     round): (2048, 4096) has 128 tiles, 8 warps on each.  Their
//     partials meet in shared memory and the first warp adds them in warp
//     order, so the same inputs give the same bits, with no atomics and no
//     second launch.  Rows past N and x rows past B are loaded clamped
//     into the array and never stored (an mma's row and column do not mix).
//   - Knobs: `block_n` / 32 warps a block (at most 8, the kernel's launch
//     bound), `unroll` x 4 k-steps a round (1, 2 or 4); `ksplit` from the
//     shape, and where K is split the round grows (to 8 or 16 steps) as
//     long as every warp keeps one, so that a warp's share of a few tiles
//     is in flight at once.  A walk that loads the next round while the
//     products of this one run took more registers, so fewer warps, and
//     measured slower at the int8 read-out, B = 8, on an NVIDIA H100 80GB
//     HBM3 at 700 W: 76.1 us, against 70.4 for this walk while it still
//     spent a division a step on the group (separate runs).
//   - One row of x (the one-row `qgemv`) is one n-tile with seven dead
//     columns: the x rows past the first are loaded clamped (the block
//     copies one row of xs, every lane reads it), and the idle tensor-core
//     columns cost nothing that shows, as the walk is bound by bytes.  On
//     the H100 (scripts/chip_ab.py pairs with the SIMT walk): the read-out
//     39.4-40.2 us in int4 against 64.4-64.5 (bound 24.85) and 56.7-57.1
//     in int8 against 71.4-71.6 (bound 48.08); (2048, 4096) 5.8-5.9
//     against 6.4 in int4 and 7.2 against 8.0-8.1 in int8.
//
// The SIMT walk, groups narrower than a k-step (`qgemv_kernel`):
//   gemv.cu's warp-per-row walk with batched_gemv's shared xs.  Each block
//   first copies xs (B K bf16) into shared memory; each warp then takes R
//   rows of W at a time (R = `unroll`: 1, 2 or 4), the warps of the grid
//   (`block_n` / 32 a block) striding over the rows, so the copy is paid
//   once a block.  A lane reads 16-byte vectors of its rows (16 int8 codes
//   or 32 int4 codes, loads that bypass L1: each byte is used once) and its
//   groups' scales, decodes the codes without the conversion unit (int8:
//   each byte permuted into the mantissa of 2^23; int4: the low and high
//   nibbles masked apart, each biased by 8, then the same permute; the
//   result is the sign-extended nibble of `(int8_t)(b << 4) >> 4` for the
//   even k and `(int8_t)b >> 4` for the odd k), multiplies each code by its
//   group's scale in fp32 (the JAX `_dequant_block`) and adds its product
//   with x (fp32, fma) to one accumulator per (row, row of xs).  Each code
//   is decoded and scaled once for all B rows of xs, and each xs vector
//   read from shared memory serves the warp's R rows (xs is laid out so
//   that a warp's reads are consecutive 16-byte units; with one row of xs,
//   two accumulators a row halve the fma chain of a vector).  A 5-step
//   shuffle reduction gives each dot product, written by lane 0.
//
// K must hold whole 16-byte vectors (int8: K % 16, int4: K % 32 == 0) and a
// group whole vectors; the wrapper refuses anything else rather than
// switch to another kernel.
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

// ------------------------------------------------------- the tile walk
using repro::mma_bf16;

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A lane's k-step of one W row as the bf16x2 words of the A fragment, and
// the same k of one xs row as the B fragment's: word 2m and 2m + 1 go to
// mma m (k positions 2 qd, 2 qd + 1 and 2 qd + 8, 2 qd + 9 of its 16).
template <int BITS>
struct Tile;

// 16 int8 codes a lane (k 16 qd .. 16 qd + 15 of the step), 4 mma: word c
// of the vector gives words (k 4c, 4c + 1) and (4c + 2, 4c + 3), the order
// of xs's own bf16 pairs
template <>
struct Tile<8> {
  static constexpr int kPerVec = 16, kMma = 4, kXVecs = 2;
  __device__ __forceinline__ static void codes(const uint4& u, uint32_t* a) {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t b = v[c] ^ 0x80808080u;
      a[2 * c] = bf16x2_bits(repro::biased_byte_to_float(b, 0),
                             repro::biased_byte_to_float(b, 1));
      a[2 * c + 1] = bf16x2_bits(repro::biased_byte_to_float(b, 2),
                                 repro::biased_byte_to_float(b, 3));
    }
  }
  __device__ __forceinline__ static void xwords(const uint4* x, uint32_t* b) {
#pragma unroll
    for (int j = 0; j < kXVecs; ++j) {
      b[4 * j] = x[j].x;
      b[4 * j + 1] = x[j].y;
      b[4 * j + 2] = x[j].z;
      b[4 * j + 3] = x[j].w;
    }
  }
};

// 32 int4 codes a lane (k 32 qd .. 32 qd + 31), 8 mma: nibble t of word c
// (k 8c + t) goes to the low half and nibble 4 + t (k 8c + 4 + t) to the
// high half of word 4c + t, as 0x4300 | (n ^ 8) = 136 + code, exact in
// bf16; x pairs the same k with byte_perm
template <>
struct Tile<4> {
  static constexpr int kPerVec = 32, kMma = 8, kXVecs = 4;
  __device__ __forceinline__ static void codes(const uint4& u, uint32_t* a) {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(&u);
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t m = ((v[c] >> (4 * t)) & 0x000F000Fu) ^ 0x43084308u;
        const __nv_bfloat162 h =
            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m), bias);
        a[4 * c + t] = *reinterpret_cast<const uint32_t*>(&h);
      }
  }
  __device__ __forceinline__ static void xwords(const uint4* x, uint32_t* b) {
#pragma unroll
    for (int c = 0; c < kXVecs; ++c) {
      b[4 * c] = __byte_perm(x[c].x, x[c].z, 0x5410);
      b[4 * c + 1] = __byte_perm(x[c].x, x[c].z, 0x7632);
      b[4 * c + 2] = __byte_perm(x[c].y, x[c].w, 0x5410);
      b[4 * c + 3] = __byte_perm(x[c].y, x[c].w, 0x7632);
    }
  }
};

// A round of S k-steps of one warp's two rows: its codes and the scales of
// the groups that end in it (or are cut by its end), loaded together.
template <int S>
struct Round {
  uint4 a[S][2];
  float sc[S][2];
};

// Steps first .. first + S - 1: at which the partial is folded into the
// running sum (a group's last step, or the round's last), with that group's
// index.  One division a round.
template <int S>
struct Flushes {
  bool at[S];
  int grp[S];
  __device__ __forceinline__ Flushes(int first, int gsteps) {
    int grp0 = first / gsteps, left = gsteps - (first - grp0 * gsteps);
#pragma unroll
    for (int u = 0; u < S; ++u) {
      at[u] = left == 1 || u == S - 1;
      grp[u] = grp0;
      if (--left == 0) {
        left = gsteps;
        ++grp0;
      }
    }
  }
};

// A warp's walk over its 16 rows: the row and scale pointers, its x rows
// in shared memory, the running sums and the partial of the group.  The
// methods are inlined, so every member stays in registers.
template <int BITS, int NT, int S>
struct TileWalk {
  using C = Tile<BITS>;
  static constexpr int KS = 4 * C::kPerVec;      // k a step
  // one n-tile: the even and the odd mma of a step sum into two partials,
  // so the chain of dependent mma is half as long
  static constexpr int P = NT == 1 ? 2 : 1;
  const uint4* w0;
  const uint4* w1;
  const float* s0;
  const float* s1;
  const uint4* xv[NT];
  int steps, gsteps;
  float acc[NT][4], prt[NT][P][4];

  __device__ __forceinline__ void load(int first, Round<S>& k) const {
    const Flushes<S> f(first, gsteps);
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int s = first + u;
      if (s < steps) {
        k.a[u][0] = __ldcs(w0 + 4 * s);
        k.a[u][1] = __ldcs(w1 + 4 * s);
        if (f.at[u]) {
          k.sc[u][0] = __ldg(s0 + f.grp[u]);
          k.sc[u][1] = __ldg(s1 + f.grp[u]);
        }
      }
    }
  }

  __device__ __forceinline__ void fold(int first, const Round<S>& k) {
    const Flushes<S> f(first, gsteps);
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int s = first + u;
      if (s < steps) {
        uint32_t a0[2 * C::kMma], a1[2 * C::kMma];
        C::codes(k.a[u][0], a0);
        C::codes(k.a[u][1], a1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint4 xq[C::kXVecs];
#pragma unroll
          for (int j = 0; j < C::kXVecs; ++j)
            xq[j] = xv[nt][s * (KS / 8) + j];
          uint32_t b[2 * C::kMma];
          C::xwords(xq, b);
#pragma unroll
          for (int m = 0; m < C::kMma; ++m)
            mma_bf16(prt[nt][m % P], a0[2 * m], a1[2 * m], a0[2 * m + 1],
                     a1[2 * m + 1], b[2 * m], b[2 * m + 1]);
        }
        if (f.at[u]) {
          // c[0..1]: row g, c[2..3]: row g + 8
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float sum = prt[nt][0][e];
#pragma unroll
              for (int h = 1; h < P; ++h) sum += prt[nt][h][e];
              acc[nt][e] = fmaf(k.sc[u][e >> 1], sum, acc[nt][e]);
#pragma unroll
              for (int h = 0; h < P; ++h) prt[nt][h][e] = 0.f;
            }
        }
      }
    }
  }
};

// NT n-tiles of 8 xs rows, rounds of S k-steps in flight; warp w of a
// block takes tile blockIdx.x * (warps / ksplit) + w / ksplit and the
// rounds w % ksplit, w % ksplit + ksplit, ... (every warp has at least
// one); G groups a row of gsteps steps each.  Shared memory: xs, each row
// padded by one 16-byte unit (so that the 32 lanes' reads of a step, rows
// g and 4 vectors apart, fall on every bank equally often), and after the
// walk the K split's partials over the same bytes.
template <int BITS, int NT, int S>
__global__ void __launch_bounds__(256)
    qgemv_mma_kernel(const uint8_t* __restrict__ w,
                     const float* __restrict__ scales,
                     const __nv_bfloat16* __restrict__ xs,
                     float* __restrict__ y, int N, int K, int G, int B,
                     int ksplit) {
  using Walk = TileWalk<BITS, NT, S>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xs_s = reinterpret_cast<uint4*>(smem);  // [B][K / 8 + 1]
  float* part = reinterpret_cast<float*>(smem);  // [warp][16 rows][8 NT]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int wk = warp % ksplit;
  const int tile = blockIdx.x * ((blockDim.x >> 5) / ksplit) + warp / ksplit;
  const int row0 = tile * 16 + g, row1 = row0 + 8;
  const int r0 = min(row0, N - 1), r1 = min(row1, N - 1);
  const int xrow = K / 8 + 1;                    // 16-byte units a row
  const size_t row_vecs = (size_t)K * BITS / 128;  // 16-byte vectors a row
  Walk t;
  t.w0 = reinterpret_cast<const uint4*>(w) + r0 * row_vecs + qd;
  t.w1 = reinterpret_cast<const uint4*>(w) + r1 * row_vecs + qd;
  t.s0 = scales + (size_t)r0 * G;
  t.s1 = scales + (size_t)r1 * G;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    t.xv[nt] = xs_s + min(8 * nt + g, B - 1) * xrow + qd * Walk::C::kXVecs;
  t.steps = K / Walk::KS;
  t.gsteps = K / G / Walk::KS;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t.acc[nt][e] = 0.f;
#pragma unroll
      for (int h = 0; h < Walk::P; ++h) t.prt[nt][h][e] = 0.f;
    }

  // with the first round's codes in flight, the block copies xs into shared
  // memory (each warp passes here once)
  Round<S> r;
  int first = wk * S;
  t.load(first, r);
  const uint4* xg = reinterpret_cast<const uint4*>(xs);
  for (int u = threadIdx.x; u < B * (K / 8); u += blockDim.x) {
    const int b = u / (K / 8);
    xs_s[b * xrow + u - b * (K / 8)] = __ldg(xg + u);
  }
  __syncthreads();
  while (true) {
    t.fold(first, r);
    if ((first += ksplit * S) >= t.steps) break;
    t.load(first, r);
    // ptxas keeps loads above a warp barrier (it orders memory): without
    // it, it sinks each load to just before its product
    __syncwarp();
  }
  float (&acc)[NT][4] = t.acc;

  // c[0..1]: row g, columns 8 nt + 2 qd + {0, 1}; c[2..3]: row g + 8
  if (ksplit > 1) {
    constexpr int W = 16 * 8 * NT;
    __syncthreads();                 // no warp reads xs past this point
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
        if (row0 < N) y[(size_t)n * N + row0] = acc[nt][e];
        if (row1 < N) y[(size_t)n * N + row1] = acc[nt][2 + e];
      }
    }
}

template <int BITS, int NT, int S>
cudaError_t launch_mma(const void* w, const void* scales, const void* xs,
                       void* y, int N, int K, int G, int B, int warps,
                       int ksplit, int blocks, cudaStream_t stream) {
  const int smem = max(B * (K / 8 + 1) * 16,
                       ksplit > 1 ? warps * 16 * 8 * NT * 4 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        qgemv_mma_kernel<BITS, NT, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  qgemv_mma_kernel<BITS, NT, S><<<blocks, warps * 32, smem, stream>>>(
      (const uint8_t*)w, (const float*)scales, (const __nv_bfloat16*)xs,
      (float*)y, N, K, G, B, ksplit);
  return cudaGetLastError();
}

template <int BITS, int NT>
cudaError_t launch_mma_steps(const void* w, const void* scales,
                             const void* xs, void* y, int N, int K, int G,
                             int B, int warps, int steps, int ksplit,
                             int blocks, cudaStream_t s) {
  if (steps == 4)
    return launch_mma<BITS, NT, 4>(w, scales, xs, y, N, K, G, B, warps,
                                   ksplit, blocks, s);
  if (steps == 8)
    return launch_mma<BITS, NT, 8>(w, scales, xs, y, N, K, G, B, warps,
                                   ksplit, blocks, s);
  if (steps == 16)
    return launch_mma<BITS, NT, 16>(w, scales, xs, y, N, K, G, B, warps,
                                    ksplit, blocks, s);
  return cudaErrorInvalidValue;
}

template <int BITS>
cudaError_t launch_mma_batch(const void* w, const void* scales,
                             const void* xs, void* y, int N, int K, int G,
                             int B, int warps, int steps, int ksplit,
                             int blocks, cudaStream_t s) {
  if (B <= 8)
    return launch_mma_steps<BITS, 1>(w, scales, xs, y, N, K, G, B, warps,
                                     steps, ksplit, blocks, s);
  return launch_mma_steps<BITS, 2>(w, scales, xs, y, N, K, G, B, warps,
                                   steps, ksplit, blocks, s);
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

// The tile walk: w, scales, xs, y as above with 1 <= B <= 16 and a group a
// whole number of k-steps ((K / G) % 64 in int8, % 128 in int4), xs
// padded to B (K / 8 + 1) 16-byte units at most 227 KB; ``warps`` 1..8 a
// block, ``ksplit`` of them (a divisor of warps, each with at least one
// round) on each 16-row tile; ``steps`` k-steps in flight (4, 8 or 16);
// ``blocks`` = the tiles over warps / ksplit (kernels/qgemv.py
// `batched_qgemv_plan`).
extern "C" cudaError_t repro_qgemv_mma(const void* w, const void* scales,
                                       const void* xs, void* y, int N, int K,
                                       int G, int B, int bits, int warps,
                                       int steps, int ksplit, int blocks,
                                       void* stream) {
  if (N <= 0) return cudaSuccess;
  const int ks = bits == 4 ? 128 : 64;
  if ((bits != 4 && bits != 8) || warps < 1 || warps > 8 || ksplit < 1 ||
      warps % ksplit != 0 || B < 1 || B > 16 || K <= 0 || G < 1 ||
      K % G || (K / G) % ks || ksplit * steps > K / ks + steps - 1 ||
      B * (K / 8 + 1) * 16 > 227 * 1024 ||
      blocks * (warps / ksplit) < (N + 15) / 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 4)
    return launch_mma_batch<4>(w, scales, xs, y, N, K, G, B, warps, steps,
                               ksplit, blocks, s);
  return launch_mma_batch<8>(w, scales, xs, y, N, K, G, B, warps, steps,
                             ksplit, blocks, s);
}
