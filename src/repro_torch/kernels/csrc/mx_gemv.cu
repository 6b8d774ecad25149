// MX GEMV: y (N,) fp32 = x (K,) bf16 . dequant(W), W stored (K, N) = (in,
// out) as MX codes: fp4 e2m1 packed two per byte along K ((K/2, N) uint8,
// even k in the low nibble) or fp8 e4m3 ((K, N)), with one uint8 E8M0 scale
// 2^(s - 127) per 32-row block of a column ((K/32, N)).  The fused SwiGLU
// variant streams a gate and an up weight against the same x and writes
// g * sigmoid(g) * u.  The grouped variant takes a stack of E such weights
// ((E, K | K/2, N) codes, (E, K/32, N) scales), rows xs (rows, K) and
// expert ids (rows,) int32 on the device, and writes y[t] = xs[t] .
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
//   (K = 1024, N = 151936, fp4) that is 83 MB, ~24.9 us at 3.35 TB/s.  At
//   the projections the bound is below a launch (1024 -> 1024: 0.55 MB,
//   0.17 us; 5632 -> 2048: 6.1 MB, 1.83 us; the SwiGLU's gate + up at
//   1024 -> 2816: 3.1 MB, 0.92 us, at 2048 -> 5632: 12.3 MB, 3.67 us; the
//   grouped experts, qwen2-moe-a2.7b's top-4 of 60 at 2048 -> 1408 or
//   1408 -> 2048: 4 x 1.53 MB, 1.84 us), so the time there is a chain of
//   latencies: the launch, one trip to device memory, the products, the
//   sums.
// Design: one walk (`mx_walk_kernel`) for all three, in one launch a call.
//   The stored layout is contiguous along N, so lanes own columns: a lane
//   owns 16 columns (8 where N is too small to give half the SMs a
//   16-column tile) and reads a 16- (8-) byte chunk of a code row per
//   load; `lpr` lanes cover a row of the block's tile, the other lanes of
//   the warp and the block's warps the rows under it, a lane a run of
//   `rpl` rows inside one E8M0 block, and a lane issues every code, scale
//   and x load of its run before its first product (x straight from
//   global memory into registers, with the codes).  fp4 codes decode in
//   registers, two at a time: the nibble's exponent and mantissa go to
//   bits 9-11 of a half and its sign to bit 15, which makes the half code
//   x 2^-14 exactly (the e2m1 subnormal 0.5 lands on the half subnormal
//   2^-15), the hardware half -> float conversion gives normal floats, so
//   no product with x loses bits, and the 2^14 goes onto the block sum
//   with the E8M0 factor; no shared-memory table (the table's one lookup
//   a code, 32 lanes a clock an SM, held the read-out at 0.53 of its
//   bound).  fp8 pairs use the hardware e4m3x2 -> half2 conversion.  A
//   lane sums its run in fp32 and adds the run sum times the block's
//   scale to its accumulators.  The sums of a tile's columns meet in the
//   same launch: the row lanes of a warp reduce-scatter through shuffles,
//   each lane keeping a few columns' sums, which go to shared memory, one
//   barrier, then the block adds its warps in order and writes y (through
//   the epilogue): no workspace, no atomics, the same bits twice.  The
//   E8M0 scale is built as the float bits s << 23 (s = 0 is 2^-127, a
//   subnormal).  N must be a multiple of 16 and K of 32 (the wrapper
//   checks).
// The three uses (`Use`), cut by the wrapper's plan (kernels/mx_gemv.py
//   `qgemv_plan`), which counts the x rows and weight streams with the
//   columns wherever it counts lanes for the card:
//   - mx_qgemv: one stream, one row, block t the tile t.  A wide shape
//     (the read-outs) streams: 8 lanes across a row (128 bytes a row
//     segment), 2 warps, 8 rows a lane, K walked in rounds of 64 rows,
//     many blocks an SM covering each other's waits (37.6 us fp4 and 56.5
//     fp8 on the H100, against 40.8 and 71.2 for 16 rows a lane and K in
//     one pass; scripts/chip_probe.py).  A narrow one (the projections)
//     takes all of K in one block of up to 8 warps, the fewest rows a lane
//     that still cover it, in rounds where 16 rows a lane and 8 warps do
//     not.  K is never split over blocks: a thread-block cluster of 2-8
//     blocks a tile, reducing through distributed shared memory, was
//     slower than one block at every smoke shape, by 0.9 us at 1024 x 1024
//     and by 17 us at the fp4 read-out (H100).  Bounded by the latency
//     chain at the projections and by the fp4 decode's instructions at the
//     read-out (0.65 of its bound).
//   - the fused SwiGLU: the gate and the up stream of one tile share a
//     block, so the epilogue g * sigmoid(g) * u is applied where a
//     column's two sums meet, by the thread that writes y.  The block's
//     warps are two groups, the first walking the gate and the second the
//     up weight, each cut as one stream's block (up to 8 warps each, so a
//     lane keeps mx_qgemv's register budget and its 16-row runs); the
//     plan counts both streams' lanes.  Every lane walking both streams at
//     the same rows, in runs of at most 8 rows, was measured and dropped:
//     slower at fp4 (6.45 against 5.89 us at 1024 -> 2816, 12.23 against
//     10.61 at 2048 -> 5632) and within 3% at fp8 (7.59 / 7.50, 18.74 /
//     19.25; scripts/chip_probe.py, H100 80GB HBM3 at 700 W).  One launch
//     where there were two (a split-K walk of 512-column tiles and its
//     reduce): 5.95 us against 20.06 at 1024 -> 2816 (bound 0.92) and
//     10.80 against 20.42 at 2048 -> 5632 (bound 3.67), a latency chain.
//   - the grouped experts: a second grid axis over the x rows; block (t,
//     r) reads its row's expert id from device memory itself (where the
//     TPU kernel had it scalar-prefetched) and offsets its code and scale
//     pointers by id x (K/pack x N) and id x (K/32 x N), x and y by the
//     row; the plan counts the rows' blocks with the tiles.  Repeated ids
//     are two rows reading the same slice.  At N = 1408 the tiles are 16
//     columns (one lane across a row), so no tile is ragged.  At
//     qwen2-moe-a2.7b's experts (top-4, fp4) 6.94 us up and 6.92 down,
//     against 12.73 and 20.76 for the split-K walk before it and 15.10 and
//     14.82 for four mx_qgemv calls (bound 1.84; H100): a latency chain.
//
// Batched variant: Y (B, N) fp32 = xs (B, K) bf16 . dequant(W) for
//   1 <= B <= 16 rows of x against one MX weight.  Replaces
//   src/repro/quant/kernels.py `batched_mx_qgemv` (`_mx_gemv_2d` with the
//   batch on the sublane dimension of the x and output blocks, so the code
//   and scale tiles stream once whatever B is).  Bound: bytes, as above
//   (the same codes and scales, plus B K 2 + 4 B N bytes of xs and Y, for
//   2 B N K operations).  Design: a tile walk on the tensor cores
//   (`mx_mma_kernel`), one launch a call.  A CUDA-core walk (a code decoded
//   through a shared-memory table, scaled, then B fmas, its K split summed
//   by a second kernel) took 208 us at the fp4 read-out, B = 8, 8.0x its
//   bound: bound by the instructions it issued a code.
//   - `mma.sync.m16n8k16`, bf16 in, fp32 accumulators: A = W^T (16 output
//     columns by 16 k), B = xs^T (8 x rows: one n-tile for B <= 8, two up
//     to 16; rows past B loaded clamped and never stored).
//   - A lane (g, q) = (lane / 4, lane % 4) owns CPL columns, g CPL .. of
//     its warp's tile of 8 CPL, and the code rows of k 8q .. 8q + 7 of each
//     32-row E8M0 block: 4 packed fp4 rows or 8 fp8 rows, one CPL-byte load
//     each, so 8 lanes read a whole segment of a row a load.  An A register
//     wants a k pair of one column: in fp4 that is one byte (the even k in
//     the low nibble); in fp8 the same byte of two consecutive rows, paired
//     by prmt.  m-tile j takes columns 2j (rows g) and 2j + 1 (rows g + 8)
//     of every lane's CPL, so the lane's accumulators are its own CPL
//     columns for x rows 2q, 2q + 1, stored as contiguous vectors.  The
//     mma's k order is not the codes': a lane's first k16 step takes rows
//     4q, 4q + 1 (fp4), its second 4q + 2, 4q + 3, and its B fragments are
//     the same k of x, one 16-byte load a block and n-tile.
//   - Codes decoded in registers, exactly, no table in shared memory: the
//     e2m1 magnitudes are exact in bf16, and prmt picks their low and high
//     bytes from two 8-entry tables in constant words, the sign going to
//     bit 15 (`fp4x8_bf16`: 15 integer operations for 8 codes); e4m3 goes
//     through the hardware e4m3x2 -> half2 conversion and half -> float ->
//     bf16.  Every product code x x is exact in fp32.
//   - The E8M0 scale after the block's products: each block's two k16
//     steps sum into a fresh partial (the first mma takes a zero
//     accumulator), and acc += 2^(s - 127) partial, the factor built from
//     the float bits (e8m0()).  That is (sum c x) s where the JAX
//     `_mx_dequant_block` computes sum (c s) x: the same function, summed
//     in another order, as the one-row walk's run sums.
//   - A lane issues a round's code and scale loads (the plan's
//     `round_blocks`: 64 x `unroll` bytes of codes a lane) before its
//     products.  Every
//     instantiation builds without a spill (ptxas: 74-95 registers at
//     unroll 1 and one n-tile, up to 155 at unroll 2 or two n-tiles).
//   - The plan (kernels/mx_gemv.py `batched_plan`): 8 columns a lane
//     (64-column tiles) where those tiles give every SM two, else 2
//     (16-column tiles: 4096 -> 2048 has 32 and 128); K split over the
//     warps of a block while the tiles' warps stay under 64 an SM, their
//     partials added in shared memory in warp order by the tile's first
//     warp: no workspace, no atomics, no second launch, the same bits
//     twice.  16 columns a lane lost at two n-tiles (67.76 us against
//     53.30 at the fp4 read-out, B = 16: twice the accumulators) and tied
//     at one, so it went.
//   On an NVIDIA H100 80GB HBM3 at 700 W (scripts/chip_ab.py, pairs with
//   the CUDA-core walk): the read-out, fp4 at B = 8 47.6-47.7 us against
//   207.2-207.6 (bound 26.1), fp8 59.4-59.8 against 361.3-362.7 (bound
//   49.4), fp4 at B = 16 53.1-53.5 against 714.5-718.5 (bound 27.6); 4096
//   -> 2048 at B = 4 8.65-8.67 against 18.7-18.8 (bound 1.35).
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int kCols = 16;             // columns a lane at most; N % kCols
constexpr int kBlockRows = 32;        // rows of K per E8M0 scale

__device__ __forceinline__ float e8m0(unsigned s) {
  return s ? __int_as_float((int)(s << 23)) : __int_as_float(0x00400000);
}

__device__ __forceinline__ float silu_gate(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

template <int C>
struct Chunk;  // the load type of C bytes
template <>
struct Chunk<16> {
  using T = uint4;
};
template <>
struct Chunk<8> {
  using T = uint2;
};
template <>
struct Chunk<4> {
  using T = unsigned int;
};
template <>
struct Chunk<2> {
  using T = unsigned short;
};

// -------------------------------------------------------------- the walk
// (see the header).  A lane owns COLS columns of one tile and a run of RPL
// code rows inside one E8M0 block; lpr lanes of a warp cover the tile's
// COLS lpr columns of one row, its 32 / lpr row lanes runs one under the
// other, and a group's warps the runs under those.  Block (t, r) covers
// tile t of x row r and all of its rows, for every weight stream.

constexpr int kWalkThreads = 256;     // threads of one group of warps

enum Use { kOne, kSwiglu, kGrouped };

// Weight streams of a use: a group of warps of the block each.
__host__ __device__ constexpr int streams_of(int use) {
  return use == kSwiglu ? 2 : 1;
}

// Two e2m1 nibbles, at bits [SH, SH + 4) of each 16-bit half of w, as the
// floats of their values times 2^-14: placed as the half bits sign << 15 |
// (e1 e0 m) << 9, the exponent field is e and the mantissa's top bit m,
// 2^(e - 15) (1 + m / 2) = code 2^-14 for e >= 1 and the subnormal half m
// 2^-15 = (m / 2) 2^-14 for e = 0.  Exact, and normal once they are floats
// (>= 2^-15), so no product with x loses bits; the 2^14 goes onto the
// block sum.  No table: two shifts, two logic operations and the two
// half -> float conversions for two codes.
template <int SH>
__device__ __forceinline__ float2 fp4_pair(uint32_t w) {
  uint32_t em;
  if constexpr (SH <= 9)
    em = w << (9 - SH);
  else
    em = w >> (SH - 9);
  const uint32_t sg = w << (12 - SH);
  const uint32_t h = (em & 0x0E000E00u) | (sg & 0x80008000u);
  return __half22float2(*reinterpret_cast<const __half2*>(&h));
}

// B bytes of x from p (B-byte aligned) into words; B of 2 fills the low
// half of word 0.  Read-only and cached: every row lane of a warp at the
// same rows reads the same bytes.
template <int B>
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, uint32_t* w) {
  if constexpr (B == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (B == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (B == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < B / 16; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// One lane's run of one weight stream: code rows [row0, row0 + RPL) of
// the COLS columns from col (16, or 8 where the columns are too few to
// give every SM a lane's 16), their E8M0 scales and the run's x, loaded
// (`load`: every load issued before anything waits on one), then summed
// (`add_to`: x_k . code(k, j) over the rows, times the scale, added to
// part[COLS]).  A lane past N or past the rows (the ragged edges) reads row
// 0 of column 0 like the rest, so the warp stays converged, and adds
// nothing.
template <int BITS, int RPL, int COLS>
struct Run {
  using Load = typename Chunk<COLS>::T;                  // COLS bytes
  static constexpr int kSB = BITS == 4 ? kBlockRows / 2 : kBlockRows;
  static constexpr int kXB = (BITS == 4 ? 4 : 2) * RPL;   // bytes of x
  static constexpr int kXW = kXB < 4 ? 1 : kXB / 4;
  static_assert(kSB % RPL == 0, "a run stays inside one E8M0 block");
  Load code[RPL];
  Load su;
  uint32_t xw[kXW];
  bool live;

  __device__ __forceinline__ void load(const uint8_t* __restrict__ w,
                                       const uint8_t* __restrict__ s,
                                       const __nv_bfloat16* __restrict__ x,
                                       int N, int rows, int col, int row0) {
    live = col < N && row0 < rows;
    const int c = live ? col : 0, r0 = live ? row0 : 0;
#pragma unroll
    for (int i = 0; i < RPL; ++i)
      code[i] = __ldcs(reinterpret_cast<const Load*>(
          w + (size_t)(r0 + i) * N + c));
    su = __ldcs(reinterpret_cast<const Load*>(s + (size_t)(r0 / kSB) * N +
                                              c));
    load_x<kXB>(x + (BITS == 4 ? 2 * r0 : r0), xw);
  }

  __device__ __forceinline__ void add_to(float* part) const {
    float blk[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) blk[j] = 0.f;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(&code[i]);
      if constexpr (BITS == 4) {
        // x[2 r], x[2 r + 1]: the low and the high nibbles' k
        const float x0 = bf16_lo(xw[i]), x1 = bf16_hi(xw[i]);
#pragma unroll
        for (int q = 0; q < COLS / 4; ++q) {  // word q: columns 4 q .. + 3
          const float2 lo02 = fp4_pair<0>(cw[q]), hi02 = fp4_pair<4>(cw[q]);
          const float2 lo13 = fp4_pair<8>(cw[q]), hi13 = fp4_pair<12>(cw[q]);
          float* b = blk + 4 * q;
          b[0] = fmaf(x1, hi02.x, fmaf(x0, lo02.x, b[0]));
          b[1] = fmaf(x1, hi13.x, fmaf(x0, lo13.x, b[1]));
          b[2] = fmaf(x1, hi02.y, fmaf(x0, lo02.y, b[2]));
          b[3] = fmaf(x1, hi13.y, fmaf(x0, lo13.y, b[3]));
        }
      } else {
        const float x0 = i % 2 ? bf16_hi(xw[i / 2]) : bf16_lo(xw[i / 2]);
        const __nv_fp8x2_storage_t* p =
            reinterpret_cast<const __nv_fp8x2_storage_t*>(&code[i]);
#pragma unroll
        for (int j = 0; j < COLS / 2; ++j) {
          const float2 f = __half22float2(
              __half2(__nv_cvt_fp8x2_to_halfraw2(p[j], __NV_E4M3)));
          blk[2 * j] = fmaf(x0, f.x, blk[2 * j]);
          blk[2 * j + 1] = fmaf(x0, f.y, blk[2 * j + 1]);
        }
      }
    }
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(&su);
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      if (live)
        part[j] = fmaf(BITS == 4 ? blk[j] * 16384.f : blk[j], e8m0(sb[j]),
                       part[j]);
  }
};

// One level of the warp's reduce-scatter: the lane and its partner at
// offset o hold M sums each of the same columns; the lane whose bit o is
// set keeps the upper half, its partner the lower, each adding the other's
// copy of the half it keeps (so one lane adds each column, in one order).
template <int M>
__device__ __forceinline__ void halve(float* v, int o, int& off) {
  const bool upper = (threadIdx.x & o) != 0;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float send = upper ? v[i] : v[i + M / 2];
    const float keep = upper ? v[i + M / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(repro::kFull, send, o);
  }
  if (upper) off += M / 2;
}

// One warp's sums of a tile's columns, into its row of shared memory
// (`row`: the tile's columns).  part: this lane's COLS columns.  The row
// lanes of one column group reduce-scatter (a level for each row-lane bit
// while the lane holds two sums or more; past that a plain butterfly, of
// which one lane writes), so each lane ends with the sums of a few of the
// group's columns, in a fixed order.
template <int COLS>
__device__ __forceinline__ void scatter(float* part, float* row,
                                        int lpr_log2) {
  const int lpr = 1 << lpr_log2;
  const int lane = threadIdx.x & 31;
  int off = 0, held = COLS, o = lpr, extra = 0;
  if constexpr (COLS == 16)
    if (o < 32) halve<16>(part, o, off), o <<= 1, held >>= 1;
  if (o < 32) halve<8>(part, o, off), o <<= 1, held >>= 1;
  if (o < 32) halve<4>(part, o, off), o <<= 1, held >>= 1;
  if (o < 32) halve<2>(part, o, off), o <<= 1, held >>= 1;
  for (; o < 32; o <<= 1) {
    part[0] += __shfl_xor_sync(repro::kFull, part[0], o);
    extra |= o;
  }
  const bool writes = (lane & extra) == 0;
  const int c0 = (lane & (lpr - 1)) * COLS + off;
#pragma unroll
  for (int i = 0; i < COLS; ++i)
    if (writes && i < held) row[c0 + i] = part[i];
}

// The sum of n warps' rows at p (one column, rows `stride` apart), in warp
// order; eight reads issued before their adds.
__device__ __forceinline__ float warp_sum(const float* p, int stride, int n) {
  float v = 0.f;
  for (int e0 = 0; e0 < n; e0 += 8) {
    float p8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) p8[e] = e0 + e < n ? p[(e0 + e) * stride] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e0 + e < n) v = e0 + e ? v + p8[e] : p8[e];
  }
  return v;
}

// grid (tiles, x rows); block streams_of(USE) groups of 32 lanes a warp,
// group g walking stream g.  A group's warps hold `rounds` bands of the
// tile's rows one under the other; a lane walks its run in each band in
// turn (the other warps of the SM cover the wait: issuing the next band's
// loads first took registers and measured slower).  Then every warp's
// sums go to shared memory, [stream][warp of the group][column], and the
// block adds them in warp order, stream by stream, and writes y through
// the use's epilogue.  kOne and kGrouped read (w, s); kSwiglu's second
// group (w1, s1), the up weight; kGrouped offsets w, s, x and y by its
// row's expert id ids[r] and row r.
template <int BITS, int RPL, int COLS, int USE>
__global__ void __launch_bounds__(kWalkThreads * streams_of(USE),
                                  2 / streams_of(USE))
    mx_walk_kernel(const uint8_t* __restrict__ w,
                   const uint8_t* __restrict__ s,
                   const uint8_t* __restrict__ w1,
                   const uint8_t* __restrict__ s1,
                   const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
                   const int* __restrict__ ids, int N, int rows,
                   int lpr_log2, int rounds) {
  extern __shared__ __align__(16) float wsmem[];
  constexpr int kStreams = streams_of(USE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = (blockDim.x >> 5) / kStreams;     // warps a group
  const int grp = kStreams == 1 ? 0 : warp / gw, gwarp = warp - grp * gw;
  const int rlanes = 32 >> lpr_log2, tile = COLS << lpr_log2;
  const int cl = lane & ((1 << lpr_log2) - 1), rl = lane >> lpr_log2;
  const int col = blockIdx.x * tile + cl * COLS;
  const int band = gw * rlanes * RPL;               // rows of one round
  const int row0 = (gwarp * rlanes + rl) * RPL;
  if constexpr (USE == kGrouped) {
    constexpr int kSB = BITS == 4 ? kBlockRows / 2 : kBlockRows;
    const size_t e = (size_t)__ldg(ids + blockIdx.y);
    w += e * rows * N;
    s += e * (rows / kSB) * N;
    x += (size_t)blockIdx.y * (BITS == 4 ? 2 : 1) * rows;
    y += (size_t)blockIdx.y * N;
  }
  if (grp > 0) w = w1, s = s1;
  float part[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) part[j] = 0.f;
  for (int r = 0; r < rounds; ++r) {
    Run<BITS, RPL, COLS> run;
    run.load(w, s, x, N, rows, col, row0 + r * band);
    __syncwarp();  // keeps ptxas from sinking the loads into the products
    run.add_to(part);
  }
  scatter<COLS>(part, wsmem + (grp * gw + gwarp) * tile, lpr_log2);
  __syncthreads();
  const int base = blockIdx.x * tile;
  for (int c = threadIdx.x; c < tile; c += blockDim.x) {
    float v = warp_sum(wsmem + c, tile, gw);
    if constexpr (USE == kSwiglu)
      v = silu_gate(v, warp_sum(wsmem + gw * tile + c, tile, gw));
    if (base + c < N) y[base + c] = v;
  }
}

// One call of the walk: its pointers (w1, s1 the SwiGLU's up weight, ids
// the grouped experts' ids; null where the use reads none) and its cut.
struct Walk {
  const void *w, *s, *w1, *s1, *x, *ids;
  void* y;
  int N, rows, xrows, lpr_log2, warps, rounds;
};

template <int BITS, int RPL, int COLS, int USE>
cudaError_t launch_walk(const Walk& a, cudaStream_t stream) {
  const int tile = COLS << a.lpr_log2;
  mx_walk_kernel<BITS, RPL, COLS, USE>
      <<<dim3((a.N + tile - 1) / tile, a.xrows),
         32 * a.warps * streams_of(USE),
         streams_of(USE) * a.warps * tile * sizeof(float), stream>>>(
          (const uint8_t*)a.w, (const uint8_t*)a.s, (const uint8_t*)a.w1,
          (const uint8_t*)a.s1, (const __nv_bfloat16*)a.x, (float*)a.y,
          (const int*)a.ids, a.N, a.rows, a.lpr_log2, a.rounds);
  return cudaGetLastError();
}

template <int BITS, int COLS, int USE>
cudaError_t walk_rpl(const Walk& a, int rpl, cudaStream_t st) {
  switch (rpl) {
    case 1:
      return launch_walk<BITS, 1, COLS, USE>(a, st);
    case 2:
      return launch_walk<BITS, 2, COLS, USE>(a, st);
    case 4:
      return launch_walk<BITS, 4, COLS, USE>(a, st);
    case 8:
      return launch_walk<BITS, 8, COLS, USE>(a, st);
    case 16:
      return launch_walk<BITS, 16, COLS, USE>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int USE>
cudaError_t walk(const Walk& a, int bits, int cols, int rpl,
                 cudaStream_t st) {
  if (bits == 4 && cols == 16) return walk_rpl<4, 16, USE>(a, rpl, st);
  if (bits == 4 && cols == 8) return walk_rpl<4, 8, USE>(a, rpl, st);
  if (bits == 8 && cols == 16) return walk_rpl<8, 16, USE>(a, rpl, st);
  if (bits == 8 && cols == 8) return walk_rpl<8, 8, USE>(a, rpl, st);
  return cudaErrorInvalidValue;
}

// The checks common to the walk's uses: K and N as the kernel takes them,
// at most kWalkThreads threads a group, and bands that cover the code
// rows.
bool walk_ok(int N, int K, int bits, int lpr_log2, int warps, int rpl,
             int rounds) {
  const int rows = bits == 4 ? K / 2 : K;
  const long long rpb =
      (long long)warps * (32 >> (lpr_log2 & 31)) * rpl * rounds;
  return K > 0 && K % kBlockRows == 0 && N % kCols == 0 &&
         (bits == 4 || bits == 8) && lpr_log2 >= 0 && lpr_log2 <= 5 &&
         warps >= 1 && 32 * warps <= kWalkThreads && rounds >= 1 &&
         rpb >= rows;
}

// ------------------------------------------------- the batched tile walk
// (see the header).  A warp owns a tile of 8 CPL columns; lane (g, q) =
// (lane / 4, lane % 4) holds the accumulators of columns tile 8 CPL + g CPL
// .. + CPL - 1 for x rows 2q, 2q + 1 of each n-tile, and loads, in every
// 32-row E8M0 block, the CPL code bytes of those columns in the code rows
// of k 8q .. 8q + 7: 4 packed fp4 rows or 8 fp8 rows.

// the e2m1 magnitudes {0, .5, 1, 1.5, 2, 3, 4, 6} as bf16: the low and the
// high bytes, entries 0-3 in the first word and 4-7 in the second
constexpr uint32_t kFp4Lo0 = 0xC0800000u, kFp4Lo1 = 0xC0804000u;
constexpr uint32_t kFp4Hi0 = 0x3F3F3F00u, kFp4Hi1 = 0x40404040u;

// The eight e2m1 codes of w as four bf16x2 words, exactly: word i = {the
// code of byte i's low nibble (the even k), of its high nibble}.  prmt
// takes each byte of a magnitude's bf16 from a table of 8 (the selector
// nibbles masked to 3 bits: prmt's fourth selector bit would replicate a
// byte's sign), the nibbles' signs go to bit 7 of the high bytes, and two
// prmt a word interleave the low and the high bytes: 15 integer operations
// for 8 codes.
__device__ __forceinline__ void fp4x8_bf16(uint32_t w, uint32_t* r) {
  const uint32_t m = w & 0x77777777u, mh = m >> 16, w4 = w << 4;
  const uint32_t lo_a = __byte_perm(kFp4Lo0, kFp4Lo1, m);
  const uint32_t lo_b = __byte_perm(kFp4Lo0, kFp4Lo1, mh);
  // bit 7 of byte j: the sign of nibble j of the low (high) half of w
  const uint32_t hi_a = __byte_perm(kFp4Hi0, kFp4Hi1, m) |
                        (__byte_perm(w4, w, 0x5140) & 0x80808080u);
  const uint32_t hi_b = __byte_perm(kFp4Hi0, kFp4Hi1, mh) |
                        (__byte_perm(w4, w, 0x7362) & 0x80808080u);
  r[0] = __byte_perm(lo_a, hi_a, 0x5140);
  r[1] = __byte_perm(lo_a, hi_a, 0x7362);
  r[2] = __byte_perm(lo_b, hi_b, 0x5140);
  r[3] = __byte_perm(lo_b, hi_b, 0x7362);
}

// Two e4m3 codes (the low 16 bits of p, the lower k in the low byte) as a
// bf16x2 word, exactly: the hardware e4m3x2 -> half2 conversion, then half
// -> float -> bf16 (every e4m3 value is exact in the three).
__device__ __forceinline__ uint32_t fp8x2_bf16(uint32_t p) {
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(p & 0xFFFFu), __NV_E4M3)));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The codes of bytes i of a and b (one column, code rows k and k + 1) as
// four bf16x2 words: word i = {a's byte i, b's byte i}.
__device__ __forceinline__ void fp8x4_bf16(uint32_t a, uint32_t b,
                                           uint32_t* r) {
  const uint32_t p01 = __byte_perm(a, b, 0x5140);
  const uint32_t p23 = __byte_perm(a, b, 0x7362);
  r[0] = fp8x2_bf16(p01);
  r[1] = fp8x2_bf16(p01 >> 16);
  r[2] = fp8x2_bf16(p23);
  r[3] = fp8x2_bf16(p23 >> 16);
}

// 32-bit word t of a load (a 2-byte load is word 0, zero-extended).
template <typename T>
__device__ __forceinline__ uint32_t word_of(const T& v, int t) {
  if constexpr (sizeof(T) < 4)
    return (uint32_t)v;
  else
    return reinterpret_cast<const uint32_t*>(&v)[t];
}

// d = a . b (16 x 8 fp32), no accumulator in: a block's first k16 step.
__device__ __forceinline__ void mma_bf16_first(float* d, uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
}

constexpr int kMmaThreads = 256;      // 8 warps a block at most

// grid: blocks of `warps` warps, ksplit of them on each tile (warp w takes
// tile blockIdx.x (warps / ksplit) + w / ksplit and the rounds w % ksplit,
// w % ksplit + ksplit, ...).  NT n-tiles of 8 x rows (one for B <= 8, two up
// to 16; rows past B loaded clamped, never stored), CPL columns a lane (8
// or 2), RB E8M0 blocks a round.  Shared memory: the K split's partials,
// [warp][NT CPL / 2 x 4][lane].  One block an SM is the bound asked for,
// so that ptxas does not trade registers for occupancy: without it, at
// two n-tiles and 4 blocks a round, it held 128 registers and spilled.
template <int BITS, int NT, int CPL, int RB>
__global__ void __launch_bounds__(kMmaThreads, 1)
    mx_mma_kernel(const uint8_t* __restrict__ w, const uint8_t* __restrict__ s,
                  const __nv_bfloat16* __restrict__ xs, float* __restrict__ y,
                  int N, int K, int B, int ksplit) {
  using Load = typename Chunk<CPL>::T;
  constexpr int kRows = BITS == 4 ? 4 : 8;      // code rows a lane a block
  constexpr int kStride = BITS == 4 ? kBlockRows / 2 : kBlockRows;
  constexpr int MT = CPL / 2;                   // m-tiles a k16 step
  constexpr int kWords = CPL < 4 ? 1 : CPL / 4;
  constexpr int V = NT * MT * 4;                // accumulators a lane
  extern __shared__ __align__(16) float part[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wk = warp % ksplit;
  const int tile = blockIdx.x * ((blockDim.x >> 5) / ksplit) + warp / ksplit;
  const int col = (tile * 8 + g) * CPL;
  const bool live = col < N;
  const int nkb = K / kBlockRows;
  const uint8_t* wl = w + (size_t)(kRows * q) * N + (live ? col : 0);
  const uint8_t* sl = s + (live ? col : 0);
  // x row 8 nt + g, 16-byte unit q: k 8q .. 8q + 7 of block 0
  const uint4* xr[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    xr[nt] = reinterpret_cast<const uint4*>(
                 xs + (size_t)min(8 * nt + g, B - 1) * K) + q;
  float acc[NT][MT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.f;

  for (int first = wk * RB; first < nkb; first += ksplit * RB) {
    Load code[RB][kRows], sc[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int kb = first + u;
      if (kb < nkb) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          code[u][r] = __ldcs(reinterpret_cast<const Load*>(
              wl + ((size_t)kb * kStride + r) * N));
        sc[u] = __ldcs(reinterpret_cast<const Load*>(sl + (size_t)kb * N));
      }
    }
    // ptxas keeps loads above a warp barrier (it orders memory): without
    // it, it sinks each load to just before its products
    __syncwarp();
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int kb = first + u;
      if (kb >= nkb) break;
      // the x rows' bf16 pairs of k 8q .. 8q + 7: words 0, 1 feed the
      // block's first k16 step, 2, 3 its second
      uint4 xv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) xv[nt] = __ldg(xr[nt] + 4 * kb);
#pragma unroll
      for (int t = 0; t < kWords; ++t) {
        // a[step][half][i]: column 4t + i; half 0 the k pair of rows g and
        // g + 8 of the A fragment's first two words, half 1 of its last two
        uint32_t a[2][2][4];
#pragma unroll
        for (int st = 0; st < 2; ++st)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (BITS == 4)
              fp4x8_bf16(word_of(code[u][2 * st + h], t), a[st][h]);
            else
              fp8x4_bf16(word_of(code[u][4 * st + 2 * h], t),
                         word_of(code[u][4 * st + 2 * h + 1], t), a[st][h]);
          }
        const uint32_t sw = word_of(sc[u], t);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * t + jj;
          if (j >= MT) break;
          // 2^(s - 127) of columns 2j and 2j + 1
          float f[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            f[h] = e8m0((sw >> (16 * jj + 8 * h)) & 0xFFu);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float p[4];
            mma_bf16_first(p, a[0][0][2 * jj], a[0][0][2 * jj + 1],
                           a[0][1][2 * jj], a[0][1][2 * jj + 1], xv[nt].x,
                           xv[nt].y);
            repro::mma_bf16(p, a[1][0][2 * jj], a[1][0][2 * jj + 1],
                            a[1][1][2 * jj], a[1][1][2 * jj + 1], xv[nt].z,
                            xv[nt].w);
            // c[0..1]: column 2j, x rows 2q, 2q + 1; c[2..3]: column 2j + 1
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[nt][j][e] = fmaf(f[e >> 1], p[e], acc[nt][j][e]);
          }
        }
      }
    }
  }

  float* flat = &acc[0][0][0];
  if (ksplit > 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) part[(warp * V + v) * 32 + lane] = flat[v];
    __syncthreads();
    if (wk != 0) return;
    for (int k2 = 1; k2 < ksplit; ++k2)
#pragma unroll
      for (int v = 0; v < V; ++v)
        flat[v] += part[((warp + k2) * V + v) * 32 + lane];
  }
  if (!live) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * nt + 2 * q + e;
      if (n >= B) continue;
      float* yr = y + (size_t)n * N + col;
      if constexpr (CPL == 2) {
        *reinterpret_cast<float2*>(yr) =
            make_float2(acc[nt][0][e], acc[nt][0][2 + e]);
      } else {
#pragma unroll
        for (int c4 = 0; c4 < CPL / 4; ++c4)
          reinterpret_cast<float4*>(yr)[c4] =
              make_float4(acc[nt][2 * c4][e], acc[nt][2 * c4][2 + e],
                          acc[nt][2 * c4 + 1][e], acc[nt][2 * c4 + 1][2 + e]);
      }
    }
}

template <int BITS, int NT, int CPL, int RB>
cudaError_t launch_mma(const void* w, const void* s, const void* xs, void* y,
                       int N, int K, int B, int warps, int ksplit, int blocks,
                       cudaStream_t stream) {
  auto kern = mx_mma_kernel<BITS, NT, CPL, RB>;
  const int smem =
      ksplit > 1 ? warps * NT * (CPL / 2) * 4 * 32 * (int)sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<blocks, 32 * warps, smem, stream>>>(
      (const uint8_t*)w, (const uint8_t*)s, (const __nv_bfloat16*)xs,
      (float*)y, N, K, B, ksplit);
  return cudaGetLastError();
}

// The plan's round of `rb` E8M0 blocks (kernels/mx_gemv.py `round_blocks`:
// 64 or 128 bytes of codes a lane) is one of the two each (format, cols)
// is built for.
template <int BITS, int NT>
cudaError_t mma_cut(const void* w, const void* s, const void* xs, void* y,
                    int N, int K, int B, int cols, int warps, int rb,
                    int ksplit, int blocks, cudaStream_t st) {
  constexpr int R8 = BITS == 4 ? 2 : 1, R2 = 4 * R8;   // unroll 1
  if (cols == 8 && rb == R8)
    return launch_mma<BITS, NT, 8, R8>(w, s, xs, y, N, K, B, warps, ksplit,
                                       blocks, st);
  if (cols == 8 && rb == 2 * R8)
    return launch_mma<BITS, NT, 8, 2 * R8>(w, s, xs, y, N, K, B, warps,
                                           ksplit, blocks, st);
  if (cols == 2 && rb == R2)
    return launch_mma<BITS, NT, 2, R2>(w, s, xs, y, N, K, B, warps, ksplit,
                                       blocks, st);
  if (cols == 2 && rb == 2 * R2)
    return launch_mma<BITS, NT, 2, 2 * R2>(w, s, xs, y, N, K, B, warps,
                                           ksplit, blocks, st);
  return cudaErrorInvalidValue;
}

template <int BITS>
cudaError_t mma_batch(const void* w, const void* s, const void* xs, void* y,
                      int N, int K, int B, int cols, int warps, int rb,
                      int ksplit, int blocks, cudaStream_t st) {
  if (B <= 8)
    return mma_cut<BITS, 1>(w, s, xs, y, N, K, B, cols, warps, rb, ksplit,
                            blocks, st);
  return mma_cut<BITS, 2>(w, s, xs, y, N, K, B, cols, warps, rb, ksplit,
                          blocks, st);
}

}  // namespace

// w (K/2 | K, N) uint8 codes (fp4 packed | fp8 e4m3 bytes); s (K/32, N)
// uint8 E8M0; x (K,) bf16; y (N,) fp32.  All 16-byte aligned, N % 16 ==
// 0, K % 32 == 0.  The plan (kernels/mx_gemv.py `qgemv_plan`): `cols`
// columns a lane (8 or 16), tiles of cols << lpr_log2 columns (a block
// each), `warps` warps a block, `rpl` code rows a lane and round (1, 2,
// 4, 8 or 16), `rounds` rounds, which together cover the rows once.
extern "C" cudaError_t repro_mx_qgemv(const void* w, const void* s,
                                      const void* x, void* y, int N, int K,
                                      int bits, int cols, int lpr_log2,
                                      int warps, int rpl, int rounds,
                                      void* stream) {
  if (N <= 0) return cudaSuccess;
  if (!walk_ok(N, K, bits, lpr_log2, warps, rpl, rounds))
    return cudaErrorInvalidValue;
  const Walk a{w, s, nullptr, nullptr, x, nullptr, y,
               N, bits == 4 ? K / 2 : K, 1, lpr_log2, warps, rounds};
  return walk<kOne>(a, bits, cols, rpl, (cudaStream_t)stream);
}

// The fused SwiGLU: gate (wg, sg) and up (wu, su) as above, y = silu(x.Wg)
// * (x.Wu).  The plan as mx_qgemv's, `warps` warps a group, a group of
// warps for each stream.
extern "C" cudaError_t repro_mx_gemv_swiglu(
    const void* wg, const void* sg, const void* wu, const void* su,
    const void* x, void* y, int N, int K, int bits, int cols, int lpr_log2,
    int warps, int rpl, int rounds, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (!walk_ok(N, K, bits, lpr_log2, warps, rpl, rounds))
    return cudaErrorInvalidValue;
  const Walk a{wg, sg, wu, su, x, nullptr, y,
               N, bits == 4 ? K / 2 : K, 1, lpr_log2, warps, rounds};
  return walk<kSwiglu>(a, bits, cols, rpl, (cudaStream_t)stream);
}

// The grouped expert GEMV: w (E, K/2 | K, N) uint8 codes, s (E, K/32, N)
// uint8 E8M0, xs (rows, K) bf16, ids (rows,) int32 expert ids in [0, E)
// on the device, y (rows, N) fp32.  All 16-byte aligned, N % 16 == 0, K %
// 32 == 0.  The plan as mx_qgemv's, for each row: grid (tiles, rows).
extern "C" cudaError_t repro_mx_gemv_grouped(
    const void* w, const void* s, const void* xs, const void* ids, void* y,
    int rows, int N, int K, int bits, int cols, int lpr_log2, int warps,
    int rpl, int rounds, void* stream) {
  if (N <= 0 || rows <= 0) return cudaSuccess;
  if (ids == nullptr || rows > 65535 ||
      !walk_ok(N, K, bits, lpr_log2, warps, rpl, rounds))
    return cudaErrorInvalidValue;
  const Walk a{w, s, nullptr, nullptr, xs, ids, y,
               N, bits == 4 ? K / 2 : K, rows, lpr_log2, warps, rounds};
  return walk<kGrouped>(a, bits, cols, rpl, (cudaStream_t)stream);
}

// The batched MX GEMV: w (K/2 | K, N) uint8 codes, s (K/32, N) uint8 E8M0,
// xs (B, K) bf16 with 1 <= B <= 16, y (B, N) fp32.  All 16-byte aligned,
// N % 16 == 0, K % 32 == 0.  The plan (kernels/mx_gemv.py `batched_plan`):
// `cols` columns a lane (8 or 2: warp tiles of 8 cols), `warps` warps a
// block (1..8), `ksplit` of them on each tile (a divisor of warps),
// `rb` E8M0 blocks a round (`round_blocks`), `blocks` covering the tiles.
extern "C" cudaError_t repro_mx_gemv_batched(const void* w, const void* s,
                                             const void* xs, void* y, int N,
                                             int K, int B, int bits, int cols,
                                             int warps, int rb, int ksplit,
                                             int blocks, void* stream) {
  if (N <= 0) return cudaSuccess;
  if (K <= 0 || K % kBlockRows || N % kCols || B < 1 || B > 16 ||
      (bits != 4 && bits != 8) || (cols != 8 && cols != 2) || warps < 1 ||
      32 * warps > kMmaThreads || ksplit < 1 || warps % ksplit ||
      blocks < 1 ||
      (long long)blocks * (warps / ksplit) * 8 * cols < N)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits == 4)
    return mma_batch<4>(w, s, xs, y, N, K, B, cols, warps, rb, ksplit,
                        blocks, st);
  return mma_batch<8>(w, s, xs, y, N, K, B, cols, warps, rb, ksplit, blocks,
                      st);
}
