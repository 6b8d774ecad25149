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
//   2 B N K operations).  Design: a (K, N) column walk, xs (B rows of the
//   block's K range, fp32) staged in shared memory, and a split over K
//   where the column tiles leave the card short.  A lane owns C columns
//   (16 for B <= 2, fewer as B grows, so the B x C fp32 accumulators stay
//   within 32 registers; `unroll` 2 doubles C where that is still at most
//   16) and reads C bytes of a code row per load.  Per 32-row block it
//   builds its C E8M0 factors once, dequantizes each code once (code x
//   factor, fp32, as the JAX `_mx_dequant` and unlike the one-row walk,
//   which scales block sums; fp4 through a 16-entry table in shared
//   memory) and adds its product with each of the B rows of x (fma) to
//   that row's accumulators, so every code byte is read and decoded once
//   for all B rows.  The warps of a block (4 or 8, `block_n` / 32) split
//   the block's K range and merge through shared memory; the split
//   partials go to a workspace (B, ksplit, N) that `mx_reduce_kernel`
//   adds in split order.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int kCols = 16;             // columns a lane at most; N % kCols
constexpr int kBlockRows = 32;        // rows of K per E8M0 scale

__constant__ float kFp4[16] = {0.f,  0.5f,  1.f,  1.5f,  2.f,  3.f,
                               4.f,  6.f,   -0.f, -0.5f, -1.f, -1.5f,
                               -2.f, -3.f, -4.f, -6.f};

__device__ __forceinline__ float e8m0(unsigned s) {
  return s ? __int_as_float((int)(s << 23)) : __int_as_float(0x00400000);
}

__device__ __forceinline__ float silu_gate(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// y[n] = the sum of the ksplit partials, in split order; grid (column
// blocks, rows).  The batched walk's second pass.
__global__ void mx_reduce_kernel(const float* __restrict__ work,
                                 float* __restrict__ y, int N, int ksplit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  work += (size_t)blockIdx.y * ksplit * N;
  y += (size_t)blockIdx.y * N;
  float v = 0.f;
  for (int z = 0; z < ksplit; ++z) v += work[(size_t)z * N + n];
  y[n] = v;
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

// Columns a lane owns in the batched walk for a batch bucket MAXB and
// `unroll` U: 16 U / MAXB, clamped to [2, 16] (`repro_mx_batched_tile`
// gives the wrapper the tile width this makes).
__host__ __device__ constexpr int batch_cols(int maxb, int u) {
  return 16 * u / maxb > 16 ? 16 : (16 * u / maxb < 2 ? 2 : 16 * u / maxb);
}

// B's bucket: the batch size the batched kernel is compiled for.
constexpr int batch_bucket(int B) {
  return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : B <= 8 ? 8 : 16;
}

// C bytes at p (C-byte aligned), read once (L1 bypassed).
template <int C>
__device__ __forceinline__ void load_bytes(const uint8_t* p, uint8_t* out) {
  using T = typename Chunk<C>::T;
  const T v = __ldcs(reinterpret_cast<const T*>(p));
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
  for (int j = 0; j < C; ++j) out[j] = b[j];
}

// grid (column tiles of 32 C, ksplit); block `warps` warps.  Block (t, z)
// covers the tile's columns and the 32-row blocks [z kbs, min((z + 1) kbs,
// K / 32)) for all B rows of xs.  Shared memory: xs of the block's K range
// [B][kbs * 32] fp32, then the warps' partials [warps][B][tile].
template <int BITS, int MAXB, int U>
__global__ void mx_batched_kernel(const uint8_t* __restrict__ w,
                                  const uint8_t* __restrict__ s,
                                  const __nv_bfloat16* __restrict__ xs,
                                  float* __restrict__ y,
                                  float* __restrict__ work, int N, int K,
                                  int B, int kbs) {
  constexpr int C = batch_cols(MAXB, U);
  constexpr int kTileB = 32 * C;
  constexpr int kRows = BITS == 4 ? kBlockRows / 2 : kBlockRows;
  extern __shared__ __align__(16) float smem[];
  __shared__ float fp4[16];
  const int nkb = K / kBlockRows;
  const int kb0 = blockIdx.y * kbs, kb1 = min(nkb, kb0 + kbs);
  const int nk = (kb1 - kb0) * kBlockRows;
  const int xstride = kbs * kBlockRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int col = blockIdx.x * kTileB + lane * C;
  float* xsh = smem;                                  // [B][xstride]
  float* red = smem + B * xstride;                    // [nw][B][kTileB]
  if (threadIdx.x < 16) fp4[threadIdx.x] = kFp4[threadIdx.x];
  for (int i = threadIdx.x; i < B * nk; i += blockDim.x) {
    const int b = i / nk, k = i - b * nk;
    xsh[b * xstride + k] =
        __bfloat162float(xs[(size_t)b * K + kb0 * kBlockRows + k]);
  }
  __syncthreads();

  float acc[MAXB][C];
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[b][j] = 0.f;
  if (col < N) {
    for (int kb = kb0 + warp; kb < kb1; kb += nw) {
      uint8_t sb[C];
      load_bytes<C>(s + (size_t)kb * N + col, sb);
      float sc[C];
#pragma unroll
      for (int j = 0; j < C; ++j) sc[j] = e8m0(sb[j]);
      const uint8_t* codes = w + (size_t)kb * kRows * N + col;
      const float* xk = xsh + (kb - kb0) * kBlockRows;
#pragma unroll 2
      for (int r = 0; r < kRows; ++r) {
        uint8_t cb[C];
        load_bytes<C>(codes + (size_t)r * N, cb);
        if constexpr (BITS == 4) {
          float lo[C], hi[C];
#pragma unroll
          for (int j = 0; j < C; ++j) {
            lo[j] = fp4[cb[j] & 15] * sc[j];
            hi[j] = fp4[cb[j] >> 4] * sc[j];
          }
#pragma unroll
          for (int b = 0; b < MAXB; ++b) {
            if (b < B) {
              // x[2r], x[2r + 1] in one (broadcast) 8-byte read
              const float2 x01 = *reinterpret_cast<const float2*>(
                  xk + b * xstride + 2 * r);
#pragma unroll
              for (int j = 0; j < C; ++j) {
                acc[b][j] = fmaf(x01.x, lo[j], acc[b][j]);
                acc[b][j] = fmaf(x01.y, hi[j], acc[b][j]);
              }
            }
          }
        } else {
          float wv[C];
#pragma unroll
          for (int j = 0; j < C / 2; ++j) {
            const __nv_fp8x2_storage_t pair = (__nv_fp8x2_storage_t)(
                cb[2 * j] | ((unsigned)cb[2 * j + 1] << 8));
            const float2 f = __half22float2(
                __half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
            wv[2 * j] = f.x * sc[2 * j];
            wv[2 * j + 1] = f.y * sc[2 * j + 1];
          }
#pragma unroll
          for (int b = 0; b < MAXB; ++b) {
            if (b < B) {
              const float x0 = xk[b * xstride + r];
#pragma unroll
              for (int j = 0; j < C; ++j)
                acc[b][j] = fmaf(x0, wv[j], acc[b][j]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b < B) {
#pragma unroll
      for (int j = 0; j < C; ++j)
        red[(warp * B + b) * kTileB + lane * C + j] = acc[b][j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B * kTileB; i += blockDim.x) {
    const int b = i / kTileB, c = i - b * kTileB;
    const int n = blockIdx.x * kTileB + c;
    if (n >= N) continue;
    float v = 0.f;
    for (int wi = 0; wi < nw; ++wi) v += red[(wi * B + b) * kTileB + c];
    if (gridDim.y == 1)
      y[(size_t)b * N + n] = v;
    else
      work[((size_t)b * gridDim.y + blockIdx.y) * N + n] = v;
  }
}

template <int BITS, int MAXB, int U>
cudaError_t launch_batched(const void* w, const void* s, const void* xs,
                           void* y, void* work, int N, int K, int B,
                           int ksplit, int warps, cudaStream_t stream) {
  constexpr int tile = 32 * batch_cols(MAXB, U);
  const int nkb = K / kBlockRows;
  const int kbs = (nkb + ksplit - 1) / ksplit;
  const int smem =
      (B * kbs * kBlockRows + warps * B * tile) * (int)sizeof(float);
  // the static fp4 table (64 bytes) counts against the 48 KB default too
  if (smem + 64 > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = mx_batched_kernel<BITS, MAXB, U>;
  if (smem + 64 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((N + tile - 1) / tile, ksplit), warps * 32, smem, stream>>>(
      (const uint8_t*)w, (const uint8_t*)s, (const __nv_bfloat16*)xs,
      (float*)y, (float*)work, N, K, B, kbs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ksplit == 1) return e;
  mx_reduce_kernel<<<dim3((N + 255) / 256, B), 256, 0, stream>>>(
      (const float*)work, (float*)y, N, ksplit);
  return cudaGetLastError();
}

template <int BITS, int MAXB>
cudaError_t batched_unroll(const void* w, const void* s, const void* xs,
                           void* y, void* work, int N, int K, int B,
                           int ksplit, int warps, int unroll,
                           cudaStream_t stream) {
  if (unroll == 1)
    return launch_batched<BITS, MAXB, 1>(w, s, xs, y, work, N, K, B, ksplit,
                                         warps, stream);
  if (unroll == 2)
    return launch_batched<BITS, MAXB, 2>(w, s, xs, y, work, N, K, B, ksplit,
                                         warps, stream);
  return cudaErrorInvalidValue;
}

template <int BITS>
cudaError_t batched_bucket(const void* w, const void* s, const void* xs,
                           void* y, void* work, int N, int K, int B,
                           int ksplit, int warps, int unroll,
                           cudaStream_t st) {
  if (B == 1)
    return batched_unroll<BITS, 1>(w, s, xs, y, work, N, K, B, ksplit, warps,
                                   unroll, st);
  if (B == 2)
    return batched_unroll<BITS, 2>(w, s, xs, y, work, N, K, B, ksplit, warps,
                                   unroll, st);
  if (B <= 4)
    return batched_unroll<BITS, 4>(w, s, xs, y, work, N, K, B, ksplit, warps,
                                   unroll, st);
  if (B <= 8)
    return batched_unroll<BITS, 8>(w, s, xs, y, work, N, K, B, ksplit, warps,
                                   unroll, st);
  return batched_unroll<BITS, 16>(w, s, xs, y, work, N, K, B, ksplit, warps,
                                  unroll, st);
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
// xs (B, K) bf16 with 1 <= B <= 16, y (B, N) fp32; work (B, ksplit, N)
// fp32 when ksplit > 1.  warps 4 or 8 a block, unroll 1 or 2 (columns a
// lane: batch_cols).  All 16-byte aligned, N % 16 == 0, K % 32 == 0.
extern "C" cudaError_t repro_mx_gemv_batched(const void* w, const void* s,
                                             const void* xs, void* y,
                                             void* work, int N, int K, int B,
                                             int bits, int ksplit, int warps,
                                             int unroll, void* stream) {
  if (N <= 0) return cudaSuccess;
  const int nkb = K / kBlockRows;
  if (K <= 0 || K % kBlockRows || N % kCols || B < 1 || B > 16 ||
      ksplit < 1 || ksplit > nkb || (warps != 4 && warps != 8) ||
      (bits != 4 && bits != 8) || (ksplit > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  if ((ksplit - 1) * ((nkb + ksplit - 1) / ksplit) >= nkb)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits == 4)
    return batched_bucket<4>(w, s, xs, y, work, N, K, B, ksplit, warps,
                             unroll, st);
  return batched_bucket<8>(w, s, xs, y, work, N, K, B, ksplit, warps, unroll,
                           st);
}

// Output columns one block of the batched MX GEMV covers for B rows and
// `unroll` (0 when either is out of range): the wrapper's split-K count
// tiles N by it.
extern "C" int repro_mx_batched_tile(int B, int unroll) {
  if (B < 1 || B > 16 || (unroll != 1 && unroll != 2)) return 0;
  return 32 * batch_cols(batch_bucket(B), unroll);
}
