// Decode attention: one query token per slot attends over the slot's cached
// K/V.  Paged: gathered page by page through its block-table row; bf16
// pools, or int8 pools with bf16 per-(position, KV head) scale pools.
// Dense: a bf16 cache (B, S, KV, hd), returning the unnormalized
// online-softmax partials (acc, m, l) or the normalized output, or an int8
// cache with bf16 per-(position, KV head) scales, normalized.
//
// Replaces: src/repro/kernels/decode_attention.py `paged_decode_attention`
//   (`_paged_decode_attention`: a (slot, page) grid whose page index comes
//   from the scalar-prefetched block table, online-softmax state in VMEM,
//   normalized at the last page) and `paged_decode_attention_int8`
//   (`_paged_decode_attention_int8`: the same walk, each value page and
//   its scale page fetched through the same table entry and dequantized in
//   VMEM, `_block_update_q8`).
// Bound on the H100: bytes.  Each slot streams length x KV x hd x 2 x 2
//   bytes of bf16 K and V (int8: length x KV x (hd + 2) x 2, the scales
//   included) for 4 x H x length x hd operations: about one operation a
//   byte at G = 1 (two for int8), G times that with G query heads a KV
//   head, still far below the bf16 ridge of ~295.
// Design (`paged_decode_mma_kernel`, on the tensor-core core of
//   mma_attention.cuh; <HD, false> for bf16 pages, <HD, true> for int8):
//   the dense decode's grid, one block per (slot, KV head, split, m-tile
//   of 16 query heads).  The G query heads of a KV head are the rows of
//   one mma m-tile, so each page is read once for all of them (a block
//   that walked the heads one after another re-read every row G times).
//   A split takes whole pages of the slot's n = min(length, nblk page)
//   valid positions (PageSplit), so it starts on a page boundary; the
//   wrapper picks the count on the host from the table's capacity, never
//   from ``length`` (no host sync): as many as let one wave of the blocks
//   an SM holds at once fill the card (`wave_splits` over this kernel's
//   occupancy).  At G = 1, where 8 slots of 16 KV heads give 128 blocks
//   already, one split a slot measured slower (15.08 against 9.97 us at
//   the engine's hd 64 on an H100): a block walks its tiles one after
//   another, and the longest slot sets the time.  The
//   block looks its split's block-table entries up once, into shared
//   memory, and maps a position to its pool row from there.  bf16 pages:
//   `decode_warps` warps a block, BN = 16 decode_warps positions a staged
//   tile (a ring of three, cp.async, the whole block), 16 a warp, both
//   products on mma.sync.  int8 pages: each warp stages only its own 16
//   positions of every tile through its own ring (walk_q8, as the int8
//   dense decode): the int8 rows become bf16 exactly, the K scales multiply
//   the scores' columns and the V scales P's, read from the scale pools at
//   the same pool row.  Both split P into three bf16 parts (fold's PSPLIT
//   = 3, one zeroed tensor-core sum a tile): their outputs (a few hundred
//   positions, of order 0.1) are held to the plain version at 2.5e-4 at
//   bf16 hd 128 and int8 hd 64, which no bf16 rounding flip of an output
//   past 1/16 meets, and with two parts (P to ~2^-18) their bf16 outputs
//   missed the rounding of the float64 value ten times as often as the
//   fp32 plain version's do; with three, no more often.  Pages are
//   multiples of 16 rows (16 bf16, 32 int8) and a split starts on a page,
//   so a warp's 16 positions never cross a page.  Every row sees [0, n):
//   no causal limit, and the walk stops at n (the JAX kernels walk every
//   page and mask; masked pages add exact zeros, so both compute the same
//   function).  With one split the block normalizes by max(l, 1e-30) and
//   stores bf16; else each split's (acc, m, l) goes to a workspace and
//   `split_combine_kernel` combines the splits in split order and
//   normalizes, launched as a programmatic dependent (launch_combine) so
//   that its launch overlaps the walk; a combine inside a thread-block
//   cluster measured slower.  A split with no valid position commits acc =
//   0, l = 0, m = -1e30, so an idle slot (length 0) gives 0.  A slot with
//   an all-NULL table row and a stale length (idle or mid-prefill slots in
//   the engine's decode batch) reads page 0 and writes a finite row that
//   nothing reads.

// The dense stats entry replaces src/repro/kernels/decode_attention.py
//   `decode_attention_stats` (a (slot, S-block) grid, two contiguous
//   S-halves streamed side by side when streams=2, each cache block scored
//   for all G query heads of every KV head in one MXU product, (m, l, acc)
//   in VMEM and committed once; `decode_attention` normalizes outside the
//   kernel).
// Bound on the H100: bytes, as above — B x S x KV x hd x 2 x 2 bytes of K
//   and V for 4 x B x H x S x hd operations.
// Design (`decode_mma_kernel`, the tensor-core core of mma_attention.cuh):
//   one block per (slot, KV head, split, m-tile of 16 query heads): the G
//   query heads of a KV head are the rows of one mma m-tile (padded to 16;
//   G > 16 takes more m-tiles over blockIdx.z), so every K/V row of the
//   head is read once for all of them.  S splits into `nsplit` chunks of
//   the slot's valid positions (whole tiles; flash-decoding: the wrapper
//   picks nsplit so that one wave of the blocks an SM holds at once fills
//   the card), and a chunk into `streams`
//   contiguous parts walked side by side (the TROOP (A) intent): a staged
//   tile of BN = block_k / 4 positions holds BN / streams of each part.
//   Each of the block's BN / 16 warps folds 16 positions of every tile
//   (both products on mma.sync), `unroll` sets the ring depth (1: 2
//   stages, else 3), and the warps merge once, in registers and shared
//   memory.  With one split that is the result; else each split's (acc, m,
//   l) goes to a workspace and `split_combine_kernel` combines the splits
//   in a fixed order (log-sum-exp, mechanism G) and commits them
//   unnormalized.  For `decode_attention` whichever of the two writes the
//   result normalizes it and stores bf16, so the normalization costs no
//   launch of its own.  The walk honours `s_offset` (valid positions are
//   [0, max(length - s_offset, 0)) of this shard) and stops there; a row
//   (or a split) with no valid position commits acc = 0, l = 0, m = -1e30,
//   so a combine of such partials gives 0, not NaN (the JAX kernel's
//   all-masked row instead sums exp(0) = 1 per masked position; the two
//   agree wherever a row has a valid position).

// The int8 dense entry replaces src/repro/kernels/decode_attention.py
//   `decode_attention_int8` (the same (slot, S-block) grid over an int8
//   cache (B, S, KV, hd) with per-(position, KV head) bf16 scales (B, S,
//   KV, 1), each value block and its scale block DMA'd side by side,
//   dequantized in fp32 in VMEM and scored for all G heads of every KV
//   head in one MXU product (`_block_update_q8`); normalized outside the
//   kernel).
// Bound on the H100: bytes — B x S x KV x (hd + 2) x 2 bytes of int8 K and
//   V with their scales, for 4 x B x H x S x hd operations (two a byte).
// Design (`decode_q8_mma_kernel`, on the core of mma_attention.cuh): the
//   bf16 entry's grid, splits (`wave_splits` over this kernel's own
//   occupancy), streams and tile of block_k / 4 positions, so every int8
//   K/V row of a KV head is read once for all G query heads, and both
//   products run on mma.sync.  Each warp stages only the 16 positions it
//   folds, through its own cp.async ring of `unroll` + 1 stages (no block
//   barrier in the walk): the int8 rows, and the 4-byte word that holds
//   each row's bf16 K or V scale.  An int8 value is an integer in [-128,
//   127], exact in bf16, so it becomes bf16 with no rounding (byte
//   permutation into fp32, then paired): the V rows into the warp's bf16 V
//   tile, which fold's ldmatrix.trans path reads unchanged, and the K rows
//   straight into B fragments, each lane reading its own quarter of a K
//   row (q's fragments are loaded in the matching order of k, so no bf16 K
//   tile takes shared memory and the blocks an SM holds are not cut by
//   it).  The scales go where they commute: the K scale multiplies its
//   column of the fp32 scores, the V scale its column of P after the row
//   sum took P unscaled (so P V is the product over v8 vs, with P's hi +
//   lo bf16 split as for bf16).  In exact arithmetic that is
//   the JAX function over the fp32-dequantized cache.  Whichever kernel
//   writes last (this one with one split, else `split_combine_kernel`,
//   whose blocks combine the splits of one row each, in split order)
//   normalizes and stores bf16, so no launch of its own normalizes; the
//   empty-row convention is the bf16 entry's (output 0).
#include "mma_attention.cuh"

namespace {

// One block per (slot b and KV head kvh = blockIdx.x, split blockIdx.y,
// m-tile blockIdx.z of 16 of the G query heads), BN / 16 warps.  Split
// ``split`` takes [lo, hi) = [split * chunk, min((split + 1) * chunk, n))
// of the slot's n valid positions, chunk = ceil(ceil(n / BN) / nsplit) BN;
// stream s of the split walks [lo + s * gpart, min(lo + (s + 1) * gpart,
// hi)), gpart = chunk / streams, and row r of a staged tile is position r
// % BNs of stream r / BNs (BNs = BN / streams).  Rows o = b * H + kvh * G +
// h go to ``sink``.
template <int HD, int STAGES>
__global__ void __launch_bounds__(256) decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ length,
    repro::mma::Sink sink, int S, int H, int KV, int s_offset, int streams,
    int BN, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int nsplit = gridDim.y;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2;

  const int n = max(0, min(length[b] - s_offset, S));
  const int chunk = ((n + BN - 1) / BN + nsplit - 1) / nsplit * BN;
  const int lo = blockIdx.y * chunk, hi = min(n, lo + chunk);
  const int BNs = BN / streams, gpart = chunk / streams;
  const int T = hi > lo ? (min(gpart, hi - lo) + BNs - 1) / BNs : 0;

  const int m0 = blockIdx.z * 16;  // the tile's first query head
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  uint32_t qf[HD / 16][4];
  repro::mma::load_q<HD>(qf, qb + (size_t)min(m0 + g, G - 1) * HD,
                         qb + (size_t)min(m0 + g + 8, G - 1) * HD);

  const long long base = (long long)b * S;
  // streams <= 2: row r of a tile is stream r >= BNs
  auto pos_of = [&](int t, int r) {
    const int s = r >= BNs;
    const int p = lo + s * gpart + t * BNs + r - s * BNs;
    return p < min(hi, lo + (s + 1) * gpart) ? p : -1;
  };
  auto row_of = [&](int p) { return (base + p) * KV + kvh; };
  // the warp's 16 positions lie in one stream: every row sees up to the
  // stream's end
  const int r0 = wn * 16, s0 = r0 >= BNs;
  const int lim = min(hi, lo + (s0 + 1) * gpart);
  auto slice = [&](int t, int& pos0, int& lim0, int& lim1) {
    pos0 = lo + s0 * gpart + t * BNs + r0 - s0 * BNs;
    lim0 = lim1 = lim;
  };
  repro::mma::State<HD> st;
  st.init();
  repro::mma::walk<HD, 16, STAGES>(k, v, smem, BN, T, pos_of, row_of, slice,
                                   wn, qf, scale, st);
  repro::mma::merge<HD>(st, smem, blockDim.x >> 5,
                        [&](int row, int d, float a0, float a1, float M,
                            float L) {
    const int h = m0 + row;
    if (h < G)
      sink.put<HD>((size_t)b * H + (size_t)kvh * G + h, d, a0, a1, M, L);
  });
}

template <int HD, int STAGES>
cudaError_t launch_decode_mma(const void* q, const void* k, const void* v,
                              const void* length, repro::mma::Sink sink,
                              int B, int S, int H, int KV, int s_offset,
                              int streams, int BN, int nsplit, float scale,
                              cudaStream_t stream) {
  using Tile = repro::mma::Tile<HD>;
  const int warps = BN / 16;
  const int smem = max(STAGES * Tile::stage_bytes(BN),
                       Tile::merge_bytes(warps));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_mma_kernel<HD, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int G = H / KV;
  decode_mma_kernel<HD, STAGES>
      <<<dim3(B * KV, nsplit, (G + 15) / 16), warps * 32, smem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (const int*)length, sink, S, H, KV,
          s_offset, streams, BN, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  repro::mma::split_combine_kernel<HD><<<B * H, HD, 0, stream>>>(
      sink.part, nsplit, sink.acc, sink.m, sink.l, sink.out);
  return cudaGetLastError();
}

template <int HD>
cudaError_t decode_mma_stages(const void* q, const void* k, const void* v,
                              const void* length, repro::mma::Sink sink,
                              int B, int S, int H, int KV, int s_offset,
                              int streams, int unroll, int BN, int nsplit,
                              float scale, cudaStream_t s) {
  if (unroll == 1)
    return launch_decode_mma<HD, 2>(q, k, v, length, sink, B, S, H, KV,
                                    s_offset, streams, BN, nsplit, scale, s);
  return launch_decode_mma<HD, 3>(q, k, v, length, sink, B, S, H, KV,
                                  s_offset, streams, BN, nsplit, scale, s);
}

// The blocks of decode_mma_kernel<HD, STAGES> that one SM holds at once.
template <int HD, int STAGES>
int decode_mma_occupancy(int BN) {
  using Tile = repro::mma::Tile<HD>;
  const int smem = max(STAGES * Tile::stage_bytes(BN),
                       Tile::merge_bytes(BN / 16));
  if (smem > 227 * 1024) return 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(decode_mma_kernel<HD, STAGES>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, decode_mma_kernel<HD, STAGES>, BN / 16 * 32, smem) !=
      cudaSuccess)
    return 0;
  return n;
}

template <int HD>
int decode_mma_occupancy_stages(int unroll, int BN) {
  return unroll == 1 ? decode_mma_occupancy<HD, 2>(BN)
                     : decode_mma_occupancy<HD, 3>(BN);
}

// Checks the launch parameters of the tensor-core dense decode and picks
// the head-dim instantiation: BN = block_k / 4 positions a stage (16 a
// warp, BN / streams a stream), unroll 1 -> 2 stages, 2 or 4 -> 3.  The
// result goes to ``out`` (bf16, normalized) when it is not null, else to
// acc / m / l.
cudaError_t decode_mma(const void* q, const void* k, const void* v,
                       const void* length, void* acc, void* m, void* l,
                       void* out, void* part, int B, int S, int H, int KV,
                       int hd, int s_offset, int streams, int unroll,
                       int block_k, int nsplit, float scale, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int BN = block_k / 4;
  if (S <= 0 || KV <= 0 || H % KV != 0 || (streams != 1 && streams != 2) ||
      (unroll != 1 && unroll != 2 && unroll != 4) || block_k % 4 != 0 ||
      BN % (16 * streams) != 0 || BN > 128 || nsplit < 1 ||
      (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const repro::mma::Sink sink{(__nv_bfloat16*)out, (float*)acc, (float*)m,
                              (float*)l, (float*)part};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return decode_mma_stages<32>(q, k, v, length, sink, B, S, H, KV,
                                   s_offset, streams, unroll, BN, nsplit,
                                   scale, s);
    case 64:
      return decode_mma_stages<64>(q, k, v, length, sink, B, S, H, KV,
                                   s_offset, streams, unroll, BN, nsplit,
                                   scale, s);
    case 128:
      return decode_mma_stages<128>(q, k, v, length, sink, B, S, H, KV,
                                    s_offset, streams, unroll, BN, nsplit,
                                    scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The int8 cache's kernel: decode_mma_kernel's block, split and stream
// layout (one block per (slot b and KV head kvh = blockIdx.x, split
// blockIdx.y, m-tile blockIdx.z); BN / 16 warps, warp wn folding the
// positions wn 16 .. wn 16 + 15 of every tile of BN), but each warp stages
// its own 16 positions through its own ring (walk_q8) and folds them with
// their scales.  The result goes to ``sink`` normalized (bf16 out) or, with
// more than one split, to its workspace for split_combine_kernel.
template <int HD, int STAGES>
__global__ void __launch_bounds__(256) decode_q8_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ length,
    repro::mma::Sink sink, int S, int H, int KV, int streams, int BN,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int nsplit = gridDim.y;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2;

  const int n = max(0, min(length[b], S));
  const int chunk = ((n + BN - 1) / BN + nsplit - 1) / nsplit * BN;
  const int lo = blockIdx.y * chunk, hi = min(n, lo + chunk);
  const int BNs = BN / streams, gpart = chunk / streams;
  const int T = hi > lo ? (min(gpart, hi - lo) + BNs - 1) / BNs : 0;

  const int m0 = blockIdx.z * 16;  // the tile's first query head
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  uint32_t qf[HD / 16][4];
  repro::mma::load_q<HD, true>(qf, qb + (size_t)min(m0 + g, G - 1) * HD,
                               qb + (size_t)min(m0 + g + 8, G - 1) * HD);

  // the warp's 16 positions of tile t: first + t BNs .. + 15, all in one
  // stream (streams <= 2), which ends at lim
  const int r0 = wn * 16, s0 = r0 >= BNs;
  const int lim = min(hi, lo + (s0 + 1) * gpart);
  const int first = lo + s0 * gpart + r0 - s0 * BNs;
  repro::mma::State<HD> st;
  st.init();
  const long long base = (long long)b * S;
  repro::mma::walk_q8<HD, STAGES>(
      k, v, ks, vs, smem + wn * repro::mma::Tile8<HD>::warp_bytes(STAGES),
      [&](int p) { return (base + p) * KV + kvh; }, first, BNs, lim, T, qf,
      scale, st);
  __syncthreads();  // every warp's ring is free: the merge buffer next
  repro::mma::merge<HD>(st, smem, blockDim.x >> 5,
                        [&](int row, int d, float a0, float a1, float M,
                            float L) {
    const int h = m0 + row;
    if (h < G)
      sink.put<HD>((size_t)b * H + (size_t)kvh * G + h, d, a0, a1, M, L);
  });
}

template <int HD, int STAGES>
int q8_smem(int BN) {
  return max(BN / 16 * repro::mma::Tile8<HD>::warp_bytes(STAGES),
             repro::mma::Tile<HD>::merge_bytes(BN / 16));
}

template <int HD, int STAGES>
cudaError_t launch_q8(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, const void* length,
                      repro::mma::Sink sink, int B, int S, int H, int KV,
                      int streams, int BN, int nsplit, float scale,
                      cudaStream_t stream) {
  const int smem = q8_smem<HD, STAGES>(BN);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_q8_mma_kernel<HD, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int G = H / KV;
  decode_q8_mma_kernel<HD, STAGES>
      <<<dim3(B * KV, nsplit, (G + 15) / 16), BN / 16 * 32, smem, stream>>>(
          (const __nv_bfloat16*)q, (const int8_t*)k, (const int8_t*)v,
          (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs,
          (const int*)length, sink, S, H, KV, streams, BN, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  repro::mma::split_combine_kernel<HD><<<B * H, HD, 0, stream>>>(
      sink.part, nsplit, sink.acc, sink.m, sink.l, sink.out);
  return cudaGetLastError();
}

template <int HD>
cudaError_t q8_stages(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, const void* length,
                      repro::mma::Sink sink, int B, int S, int H, int KV,
                      int streams, int unroll, int BN, int nsplit,
                      float scale, cudaStream_t s) {
  if (unroll == 1)
    return launch_q8<HD, 2>(q, k, ks, v, vs, length, sink, B, S, H, KV,
                            streams, BN, nsplit, scale, s);
  return launch_q8<HD, 3>(q, k, ks, v, vs, length, sink, B, S, H, KV,
                          streams, BN, nsplit, scale, s);
}

// The blocks of decode_q8_mma_kernel<HD, STAGES> that one SM holds at once.
template <int HD, int STAGES>
int q8_occupancy(int BN) {
  const int smem = q8_smem<HD, STAGES>(BN);
  if (smem > 227 * 1024) return 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(decode_q8_mma_kernel<HD, STAGES>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, decode_q8_mma_kernel<HD, STAGES>, BN / 16 * 32, smem) !=
      cudaSuccess)
    return 0;
  return n;
}

template <int HD>
int q8_occupancy_stages(int unroll, int BN) {
  return unroll == 1 ? q8_occupancy<HD, 2>(BN) : q8_occupancy<HD, 3>(BN);
}

// ------------------------------------------------------------------ paged
constexpr int kPagedStages = 3;  // the ring depth of the paged walks

// bytes of the paged kernel's rings (bf16: the block's ring of BN = 16
// warps positions a stage; int8: one ring a warp), and of the merge
// buffer, which reuses them; the split's page list follows
template <int HD, bool Q8>
__host__ __device__ constexpr int paged_ring_bytes(int warps) {
  const int ring =
      Q8 ? warps * repro::mma::Tile8<HD>::warp_bytes(kPagedStages)
         : kPagedStages * repro::mma::Tile<HD>::stage_bytes(16 * warps);
  const int merge = repro::mma::Tile<HD>::merge_bytes(warps);
  return ring > merge ? ring : merge;
}

template <int HD, bool Q8>
constexpr int paged_smem(int warps) {
  return paged_ring_bytes<HD, Q8>(warps) + repro::mma::kMaxPages * 4;
}

// One block per (slot b and KV head kvh = blockIdx.x, split blockIdx.y,
// m-tile blockIdx.z of 16 of the G query heads), ``warps`` warps.  The
// block's split (PageSplit) is [lo, hi), whole pages of the slot's valid
// positions; row r of staged tile t of BN = 16 warps is position lo + t
// BN + r, and warp wn folds rows 16 wn .. 16 wn + 15 of each.  Every row
// sees [lo, hi) of the split: no causal limit.  Q8: int8 pools kp, vp
// with bf16 scale pools ks, vs, each warp staging its own rows (walk_q8);
// else bf16 pools (ks, vs unread).  Rows o = b H + kvh G + h go to
// ``sink``.
template <int HD, bool Q8>
__global__ void __launch_bounds__(256) paged_decode_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kp,
    const void* __restrict__ vp, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ bt,
    const int* __restrict__ length, repro::mma::Sink sink, int H, int KV,
    int page, int nblk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the split combine may be scheduled now: it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int warps = blockDim.x >> 5, BN = 16 * warps;

  const int m0 = blockIdx.z * 16;  // the tile's first query head
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  uint32_t qf[HD / 16][4];
  repro::mma::load_q<HD, Q8>(qf, qb + (size_t)min(m0 + g, G - 1) * HD,
                             qb + (size_t)min(m0 + g + 8, G - 1) * HD);

  const repro::mma::PageSplit sp(length[b], nblk, page);
  const int lo = sp.lo, hi = sp.hi;
  const int T = hi > lo ? (hi - lo + BN - 1) / BN : 0;
  const repro::mma::PageRows row_of = sp.lookup(
      reinterpret_cast<int*>(smem + paged_ring_bytes<HD, Q8>(warps)),
      bt + (size_t)b * nblk, KV, kvh);
  repro::mma::State<HD> st;
  st.init();
  if constexpr (Q8) {
    repro::mma::walk_q8<HD, kPagedStages, 3>(
        static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp), ks,
        vs, smem + wn * repro::mma::Tile8<HD>::warp_bytes(kPagedStages),
        row_of, lo + wn * 16, BN, hi, T, qf, scale, st);
    __syncthreads();  // every warp's ring is free: the merge buffer next
  } else {
    auto pos_of = [&](int t, int r) {
      const int p = lo + t * BN + r;
      return p < hi ? p : -1;
    };
    auto slice = [&](int t, int& pos0, int& lim0, int& lim1) {
      pos0 = lo + t * BN + wn * 16;
      lim0 = lim1 = hi;
    };
    repro::mma::walk<HD, 16, kPagedStages, 3>(
        static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), smem, BN, T, pos_of, row_of,
        slice, wn, qf, scale, st);
  }
  repro::mma::merge<HD>(st, smem, warps,
                        [&](int row, int d, float a0, float a1, float M,
                            float L) {
    const int h = m0 + row;
    if (h < G)
      sink.put<HD>((size_t)b * H + (size_t)kvh * G + h, d, a0, a1, M, L);
  });
}

template <int HD, bool Q8>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const void* ks, const void* vs, const void* bt,
                         const void* length, repro::mma::Sink sink, int B,
                         int H, int KV, int page, int nblk, int warps,
                         int nsplit, float scale, cudaStream_t stream) {
  const int smem = paged_smem<HD, Q8>(warps);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_mma_kernel<HD, Q8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int G = H / KV;
  paged_decode_mma_kernel<HD, Q8>
      <<<dim3(B * KV, nsplit, (G + 15) / 16), warps * 32, smem, stream>>>(
          (const __nv_bfloat16*)q, kp, vp, (const __nv_bfloat16*)ks,
          (const __nv_bfloat16*)vs, (const int*)bt, (const int*)length, sink,
          H, KV, page, nblk, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  return repro::mma::launch_combine<HD>(sink.part, nsplit, B * H, sink.out,
                                        stream);
}

// The blocks of paged_decode_mma_kernel<HD, Q8> that one SM holds at once.
// As the launch (and every occupancy query of these kernels), it sets the
// kernel's dynamic shared-memory limit only past the default 48 KB, so the
// limit never drops below 48 KB: a launch of up to 48 KB, which sets
// nothing, must not find it cut by a query for a smaller block.
template <int HD, bool Q8>
int paged_occupancy(int warps) {
  const int smem = paged_smem<HD, Q8>(warps);
  if (smem > 227 * 1024 ||
      (smem > 48 * 1024 &&
       cudaFuncSetAttribute(paged_decode_mma_kernel<HD, Q8>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem) != cudaSuccess))
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, paged_decode_mma_kernel<HD, Q8>, warps * 32, smem) !=
      cudaSuccess)
    return 0;
  return n;
}

template <bool Q8>
int paged_occupancy_hd(int hd, int warps) {
  if (warps < 1 || warps > 8) return 0;
  switch (hd) {
    case 32:
      return paged_occupancy<32, Q8>(warps);
    case 64:
      return paged_occupancy<64, Q8>(warps);
    case 128:
      return paged_occupancy<128, Q8>(warps);
    default:
      return 0;
  }
}

// Checks the launch parameters of the paged decode and picks the head-dim
// instantiation: ``warps`` warps of 16 positions, nsplit splits of whole
// pages (at most kMaxPages table entries each), ``part`` the splits'
// workspace when nsplit > 1.
template <bool Q8>
cudaError_t paged_decode(const void* q, const void* kp, const void* vp,
                         const void* ks, const void* vs, const void* bt,
                         const void* length, void* out, void* part, int B,
                         int H, int KV, int hd, int page, int nblk,
                         int warps, int nsplit, float scale, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || page <= 0 || nblk <= 0 || warps < 1 ||
      warps > 8 || nsplit < 1 ||
      (nblk + nsplit - 1) / nsplit > repro::mma::kMaxPages ||
      (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const repro::mma::Sink sink{(__nv_bfloat16*)out, nullptr, nullptr, nullptr,
                              (float*)part};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_paged<32, Q8>(q, kp, vp, ks, vs, bt, length, sink, B, H,
                                  KV, page, nblk, warps, nsplit, scale, s);
    case 64:
      return launch_paged<64, Q8>(q, kp, vp, ks, vs, bt, length, sink, B, H,
                                  KV, page, nblk, warps, nsplit, scale, s);
    case 128:
      return launch_paged<128, Q8>(q, kp, vp, ks, vs, bt, length, sink, B,
                                   H, KV, page, nblk, warps, nsplit, scale,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd) bf16; k_pool / v_pool (P, page, KV, hd) bf16; block_tables
// (B, nblk) int32; length (B,) int32; out (B, H, hd) bf16.  hd in {32, 64,
// 128}, H % KV == 0, 16-byte aligned pools (the wrapper checks); warps 1
// to 8 (16 positions each a staged tile); nsplit >= 1 splits of whole
// pages, at most repro_paged_decode_max_pages() table entries each, and
// ``part`` (B H nsplit (hd + 2) fp32 scratch) when nsplit > 1.
extern "C" cudaError_t repro_paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* length, void* out, void* part,
    int B, int H, int KV, int hd, int page, int nblk, int warps, int nsplit,
    float scale, void* stream) {
  return paged_decode<false>(q, k_pool, v_pool, nullptr, nullptr,
                             block_tables, length, out, part, B, H, KV, hd,
                             page, nblk, warps, nsplit, scale, stream);
}

// As above with int8 k_pool / v_pool (P, page, KV, hd) and bf16 k_scales /
// v_scales (P, page, KV, 1).
extern "C" cudaError_t repro_paged_decode_int8(
    const void* q, const void* k_pool, const void* k_scales,
    const void* v_pool, const void* v_scales, const void* block_tables,
    const void* length, void* out, void* part, int B, int H, int KV, int hd,
    int page, int nblk, int warps, int nsplit, float scale, void* stream) {
  return paged_decode<true>(q, k_pool, v_pool, k_scales, v_scales,
                            block_tables, length, out, part, B, H, KV, hd,
                            page, nblk, warps, nsplit, scale, stream);
}

// The blocks of the paged decode (bf16 or int8 pages) at (hd, warps) that
// one SM holds at once (0 for parameters it does not take): the wrapper
// splits the pages so that one wave of blocks fills the card.
extern "C" int repro_paged_decode_bf16_occupancy(int hd, int warps) {
  return paged_occupancy_hd<false>(hd, warps);
}

extern "C" int repro_paged_decode_int8_occupancy(int hd, int warps) {
  return paged_occupancy_hd<true>(hd, warps);
}

// The block-table entries one split of the paged decode takes at most.
extern "C" int repro_paged_decode_max_pages() {
  return repro::mma::kMaxPages;
}

// q (B, H, hd) bf16; k, v (B, S, KV, hd) bf16; length (B,) int32.  Into
// ``out`` (B, H, hd) bf16, normalized, when it is not null; else acc (B,
// KV, G, hd) fp32, m and l (B, KV, G, 1) fp32 (G = H / KV), unnormalized.
// streams 1 or 2, unroll 1, 2 or 4, block_k / 4 a multiple of 16 x streams
// up to 128 (the positions of a staged tile, 16 a warp); nsplit >= 1 chunks
// of the valid positions, ``part`` (B H nsplit (hd + 2) fp32 scratch) when
// nsplit > 1; hd in {32, 64, 128}; 16-byte aligned k, v (the wrapper
// checks).
extern "C" cudaError_t repro_decode_dense_bf16(
    const void* q, const void* k, const void* v, const void* length,
    void* acc, void* m, void* l, void* out, void* part, int B, int S, int H,
    int KV, int hd, int s_offset, int streams, int unroll, int block_k,
    int nsplit, float scale, void* stream) {
  return decode_mma(q, k, v, length, acc, m, l, out, part, B, S, H, KV, hd,
                    s_offset, streams, unroll, block_k, nsplit, scale,
                    stream);
}

// The blocks of the bf16 dense decode at (hd, unroll, block_k) that one SM
// holds at once (0 for parameters it does not take): the wrapper splits S
// so that one wave of blocks fills the card.
extern "C" int repro_decode_dense_bf16_occupancy(int hd, int unroll,
                                                 int block_k) {
  const int BN = block_k / 4;
  if (block_k % 4 != 0 || BN % 16 != 0 || BN > 128 || BN <= 0) return 0;
  switch (hd) {
    case 32:
      return decode_mma_occupancy_stages<32>(unroll, BN);
    case 64:
      return decode_mma_occupancy_stages<64>(unroll, BN);
    case 128:
      return decode_mma_occupancy_stages<128>(unroll, BN);
    default:
      return 0;
  }
}

// q (B, H, hd) bf16; k, v (B, S, KV, hd) int8 with bf16 scales ks, vs (B,
// S, KV, 1); length (B,) int32 -> out (B, H, hd) bf16, normalized.  The
// launch parameters as for repro_decode_dense_bf16 (``part``: B H nsplit
// (hd + 2) fp32 scratch when nsplit > 1); 16-byte aligned k, v (the
// wrapper checks).
extern "C" cudaError_t repro_decode_dense_int8(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, const void* length, void* out, void* part, int B, int S,
    int H, int KV, int hd, int streams, int unroll, int block_k, int nsplit,
    float scale, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int BN = block_k / 4;
  if (S <= 0 || KV <= 0 || H % KV != 0 || (streams != 1 && streams != 2) ||
      (unroll != 1 && unroll != 2 && unroll != 4) || block_k % 4 != 0 ||
      BN % (16 * streams) != 0 || BN > 128 || BN <= 0 || nsplit < 1 ||
      (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const repro::mma::Sink sink{(__nv_bfloat16*)out, nullptr, nullptr, nullptr,
                              (float*)part};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return q8_stages<32>(q, k, ks, v, vs, length, sink, B, S, H, KV,
                           streams, unroll, BN, nsplit, scale, s);
    case 64:
      return q8_stages<64>(q, k, ks, v, vs, length, sink, B, S, H, KV,
                           streams, unroll, BN, nsplit, scale, s);
    case 128:
      return q8_stages<128>(q, k, ks, v, vs, length, sink, B, S, H, KV,
                            streams, unroll, BN, nsplit, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The blocks of the int8 dense decode at (hd, unroll, block_k) that one SM
// holds at once (0 for parameters it does not take).
extern "C" int repro_decode_dense_int8_occupancy(int hd, int unroll,
                                                 int block_k) {
  const int BN = block_k / 4;
  if (block_k % 4 != 0 || BN % 16 != 0 || BN > 128 || BN <= 0) return 0;
  switch (hd) {
    case 32:
      return q8_occupancy_stages<32>(unroll, BN);
    case 64:
      return q8_occupancy_stages<64>(unroll, BN);
    case 128:
      return q8_occupancy_stages<128>(unroll, BN);
    default:
      return 0;
  }
}
