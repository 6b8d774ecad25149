// Decode attention: one query token per slot attends over the slot's cached
// K/V.  Paged: gathered page by page through its block-table row; bf16
// pools, or int8 pools with bf16 per-(position, KV head) scale pools.
// Dense (the stats entry): a bf16 cache (B, S, KV, hd), returning the
// unnormalized online-softmax partials (acc, m, l).
//
// Replaces: src/repro/kernels/decode_attention.py `paged_decode_attention`
//   (`_paged_decode_attention`: a (slot, page) grid whose page index comes
//   from the scalar-prefetched block table, online-softmax state in VMEM,
//   normalized at the last page) and `paged_decode_attention_int8`
//   (`_paged_decode_attention_int8`: the same walk, each value page and
//   its scale page fetched through the same table entry and dequantized in
//   VMEM, `_block_update_q8`).
// Bound on the H100: bytes.  Each slot streams length x KV x hd x 2 x 2
//   bytes of bf16 K and V (int8: length x KV x (hd + 2) x 2) for
//   4 x H x length x hd operations: about one operation per byte (two for
//   int8), far below the bf16 ridge.
// Design (paged_attention.cuh, C = 1): one block per (slot, KV head); the
//   block reads its own block-table row (no scalar prefetch).  Its warps
//   split the slot's positions into 32-position tiles taken in turn; in a
//   tile each lane scores one position (a 16-byte-vector dot product
//   against q in shared memory) while copying that position's V row into
//   the warp's shared-memory staging tile, so a tile's K and V loads are all
//   in flight at once; the warp then updates its fp32 online-softmax state
//   from the staged rows.  int8 rows are 16 values per 16-byte load (an
//   hd = 64 row is 4 loads) and carry one bf16 scale each, read from the
//   scale pool at the same row index and staged beside the V row; K and V
//   are dequantized in fp32 before the dot and the value update, the int8
//   values converted by byte permutation rather than by the 1/8-rate
//   conversion unit.  With the 32-row int8 page a lane tile is exactly one
//   page.  The walk stops at the slot's length (the JAX kernels walk every
//   page and mask; masked pages add exact zeros, so both compute the same
//   function), and the warps' states merge through shared memory.  A slot
//   with an all-NULL table row and a stale length (idle or mid-prefill
//   slots in the engine's decode batch) reads page 0 and writes a garbage
//   row that nothing reads.
//
// The dense stats entry replaces src/repro/kernels/decode_attention.py
//   `decode_attention_stats` (a (slot, S-block) grid, two contiguous
//   S-halves streamed side by side when streams=2, (m, l, acc) in VMEM and
//   committed once; `decode_attention` normalizes outside the kernel).
// Bound on the H100: bytes, as above — B x S x KV x hd x 2 x 2 bytes of K
//   and V for 4 x B x H x S x hd operations.
// Design: the same online-softmax walk (paged_attention.cuh attend_tiles)
//   with a dense index.  The TPU walks a slot's S blocks in order on one
//   core; here one block per (slot, query head) would leave most of the
//   132 SMs idle (64 blocks at B = 4, H = 16), so the grid also splits S
//   into `nsplit` contiguous chunks (flash-decoding; the wrapper picks
//   nsplit from the shape so the grid holds about two blocks an SM).  In a
//   block the warps form `streams` groups, group g walking the g-th
//   contiguous part of the chunk (the TROOP (A) intent: each group streams
//   its own contiguous region), `block_k / 128` warps a group, each with
//   `unroll` 32-position tiles of K and V loads in flight per step
//   (16-byte loads).  The warps' states merge once through shared memory
//   (C); with one split they are the result, else each split's (acc, m, l)
//   goes to a workspace and a second kernel combines the splits in a fixed
//   order (log-sum-exp, mechanism G) and commits them unnormalized.  The
//   G query heads of one KV head are neighbouring blocks, so the second
//   reads its K/V rows from L2.  The walk honours `s_offset` (valid
//   positions are [0, max(length - s_offset, 0)) of this shard) and stops
//   there; a masked score is -1e30, as in the JAX kernel, and a row (or a
//   split) with no valid position commits acc = 0, l = 0, m = -1e30, so a
//   combine of such partials gives 0, not NaN (the JAX kernel's all-masked
//   row instead sums exp(0) = 1 per masked position; the two agree
//   wherever a row has a valid position).
//
// The int8 stats entry replaces src/repro/kernels/decode_attention.py
//   `decode_attention_int8` (the same (slot, S-block) grid over an int8
//   cache (B, S, KV, hd) with per-(position, KV head) bf16 scales (B, S,
//   KV, 1), each value block and its scale block DMA'd side by side and
//   dequantized in VMEM; normalized outside the kernel).
// Bound on the H100: bytes — B x S x KV x (hd + 2) x 2 bytes of int8 K and
//   V with their scales, for 4 x B x H x S x hd operations.
// Design: the dense walk above with int8 rows (16 values a 16-byte load;
//   an hd = 64 row is 4 loads), each row's scale read at the same row
//   index of the scale cache and staged beside its V row, K and V
//   dequantized in fp32 before the dot and the value update (attend_tiles,
//   as for the int8 page pools); the same splits, combine and empty-row
//   convention.
#include "paged_attention.cuh"

namespace {

// One block per (row o = b * H + h, split blockIdx.y): the chunk [split *
// chunk, min((split + 1) * chunk, n)) of slot b's valid positions for
// query head h.  Shared memory: per warp U V-staging tiles, then m[nw],
// l[nw], acc[nw][HD].  With one split the block writes acc / m / l of row
// o; else its partial goes to ``part`` (rows o * nsplit + split of HD + 2
// floats: acc, then m, then l).
// E = int8_t: k, v int8 with bf16 scales ks, vs (B, S, KV, 1).
template <int HD, int U, typename E>
__global__ void dense_stats_kernel(
    const __nv_bfloat16* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ length,
    float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ part, int S, int H,
    int KV, int s_offset, int streams, int chunk, float scale) {
  using Stage = repro::VStage<HD, E>;
  constexpr int DPL = HD / 32;
  const int o = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = o / H, h = o % H;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int per = nw / streams;                 // warps of one group
  const int group = warp / per;
  __shared__ float q_s[HD];
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* v_s = smem + warp * U * Stage::bytes;
  float* pm = reinterpret_cast<float*>(smem + nw * U * Stage::bytes);
  float* pl = pm + nw;
  float* pacc = pm + 2 * nw;

  const int n = max(0, min(length[b] - s_offset, S));
  const int lo = split * chunk;
  const int hi = min(n, lo + chunk);
  // group g walks [lo + g * gpart, min(lo + (g + 1) * gpart, hi)), gpart a
  // multiple of 32
  const int gpart = ((chunk + streams - 1) / streams + 31) / 32 * 32;
  const int begin = lo + group * gpart;
  const int end = min(hi, begin + gpart);
  for (int d = threadIdx.x; d < HD; d += blockDim.x)
    q_s[d] = __bfloat162float(q[(size_t)o * HD + d]);
  __syncthreads();

  float m = repro::kNeg, l = 0.f, acc[DPL];
#pragma unroll
  for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
  repro::attend_tiles<HD, E, U>(
      q_s, v_s, k, v, ks, vs,
      repro::DenseIndex{(long long)b * S, KV, kvh}, begin, end, warp % per,
      per, scale, m, l, acc);
  if (lane == 0) {
    pm[warp] = m;
    pl[warp] = l;
  }
#pragma unroll
  for (int d = 0; d < DPL; ++d) pacc[warp * HD + lane * DPL + d] = acc[d];
  __syncthreads();

  float M = repro::kNeg;
  for (int w = 0; w < nw; ++w) M = fmaxf(M, pm[w]);
  float* a_dst = nsplit == 1 ? acc_out + (size_t)o * HD
                             : part + ((size_t)o * nsplit + split) * (HD + 2);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float A = 0.f;
    for (int w = 0; w < nw; ++w)
      A = fmaf(pacc[w * HD + d], expf(pm[w] - M), A);
    a_dst[d] = A;
  }
  if (threadIdx.x == 0) {
    float L = 0.f;
    for (int w = 0; w < nw; ++w) L = fmaf(pl[w], expf(pm[w] - M), L);
    if (nsplit == 1) {
      m_out[o] = M;
      l_out[o] = L;
    } else {
      a_dst[HD] = M;
      a_dst[HD + 1] = L;
    }
  }
}

// One block of HD threads per row o: the nsplit partials of ``part``
// combined in split order.
template <int HD>
__global__ void dense_combine_kernel(const float* __restrict__ part,
                                     int nsplit, float* __restrict__ acc_out,
                                     float* __restrict__ m_out,
                                     float* __restrict__ l_out) {
  const int o = blockIdx.x, d = threadIdx.x;
  const float* p = part + (size_t)o * nsplit * (HD + 2);
  float M = repro::kNeg;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, p[s * (HD + 2) + HD]);
  float A = 0.f, L = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float* ps = p + s * (HD + 2);
    const float f = expf(ps[HD] - M);
    A = fmaf(ps[d], f, A);
    L = fmaf(ps[HD + 1], f, L);
  }
  acc_out[(size_t)o * HD + d] = A;
  if (d == 0) {
    m_out[o] = M;
    l_out[o] = L;
  }
}

template <int HD, int U, typename E>
cudaError_t launch_dense(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* length,
                         void* acc, void* m, void* l, void* part, int B,
                         int S, int H, int KV, int s_offset, int streams,
                         int warps, int nsplit, float scale,
                         cudaStream_t stream) {
  using Stage = repro::VStage<HD, E>;
  const int smem = warps * (U * Stage::bytes + (int)sizeof(float) * (2 + HD));
  // the static q_s (HD floats) counts against both limits
  if (smem + HD * 4 > 227 * 1024) return cudaErrorInvalidValue;
  if (smem + HD * 4 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_stats_kernel<HD, U, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int chunk = ((S + nsplit - 1) / nsplit + 31) / 32 * 32;
  dense_stats_kernel<HD, U, E><<<dim3(B * H, nsplit), warps * 32, smem,
                                 stream>>>(
      (const __nv_bfloat16*)q, (const E*)k, (const E*)v,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs, (const int*)length,
      (float*)acc, (float*)m, (float*)l, (float*)part, S, H, KV, s_offset,
      streams, chunk, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  dense_combine_kernel<HD><<<B * H, HD, 0, stream>>>(
      (const float*)part, nsplit, (float*)acc, (float*)m, (float*)l);
  return cudaGetLastError();
}

template <int HD, typename E>
cudaError_t dense_unroll(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* length,
                         void* acc, void* m, void* l, void* part, int B,
                         int S, int H, int KV, int s_offset, int streams,
                         int warps, int unroll, int nsplit, float scale,
                         cudaStream_t s) {
  switch (unroll) {
    case 1:
      return launch_dense<HD, 1, E>(q, k, v, ks, vs, length, acc, m, l, part,
                                    B, S, H, KV, s_offset, streams, warps,
                                    nsplit, scale, s);
    case 2:
      return launch_dense<HD, 2, E>(q, k, v, ks, vs, length, acc, m, l, part,
                                    B, S, H, KV, s_offset, streams, warps,
                                    nsplit, scale, s);
    case 4:
      return launch_dense<HD, 4, E>(q, k, v, ks, vs, length, acc, m, l, part,
                                    B, S, H, KV, s_offset, streams, warps,
                                    nsplit, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Checks the launch parameters and picks the head-dim instantiation of the
// dense walk over elements E.
template <typename E>
cudaError_t dense_stats(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* length,
                        void* acc, void* m, void* l, void* part, int B, int S,
                        int H, int KV, int hd, int s_offset, int streams,
                        int unroll, int block_k, int nsplit, float scale,
                        void* stream) {
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || KV <= 0 || H % KV != 0 || (streams != 1 && streams != 2) ||
      block_k < 128 || block_k % 128 != 0 || nsplit < 1 ||
      (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const int warps = streams * (block_k / 128);
  if (warps > 32) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return dense_unroll<32, E>(q, k, v, ks, vs, length, acc, m, l, part, B,
                                 S, H, KV, s_offset, streams, warps, unroll,
                                 nsplit, scale, s);
    case 64:
      return dense_unroll<64, E>(q, k, v, ks, vs, length, acc, m, l, part, B,
                                 S, H, KV, s_offset, streams, warps, unroll,
                                 nsplit, scale, s);
    case 128:
      return dense_unroll<128, E>(q, k, v, ks, vs, length, acc, m, l, part,
                                  B, S, H, KV, s_offset, streams, warps,
                                  unroll, nsplit, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd) bf16; k_pool / v_pool (P, page, KV, hd) bf16; block_tables
// (B, nblk) int32; length (B,) int32; out (B, H, hd) bf16.  hd in {32, 64,
// 128}, H % KV == 0, 16-byte aligned pools (the wrapper checks).
extern "C" cudaError_t repro_paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* length, void* out, int B, int H,
    int KV, int hd, int page, int nblk, int warps, float scale,
    void* stream) {
  return repro::paged_attention<false>(q, k_pool, v_pool, nullptr, nullptr,
                                       block_tables, nullptr, length, out, B,
                                       1, H, KV, hd, page, nblk, warps, scale,
                                       stream);
}

// As above with int8 k_pool / v_pool (P, page, KV, hd) and bf16 k_scales /
// v_scales (P, page, KV, 1).
extern "C" cudaError_t repro_paged_decode_int8(
    const void* q, const void* k_pool, const void* k_scales,
    const void* v_pool, const void* v_scales, const void* block_tables,
    const void* length, void* out, int B, int H, int KV, int hd, int page,
    int nblk, int warps, float scale, void* stream) {
  return repro::paged_attention<false, int8_t>(
      q, k_pool, v_pool, k_scales, v_scales, block_tables, nullptr, length,
      out, B, 1, H, KV, hd, page, nblk, warps, scale, stream);
}

// q (B, H, hd) bf16; k, v (B, S, KV, hd) bf16; length (B,) int32; acc (B,
// KV, G, hd) fp32, m and l (B, KV, G, 1) fp32 (G = H / KV).  streams 1 or 2,
// unroll 1, 2 or 4, block_k a multiple of 128 (block_k / 128 warps a
// stream); nsplit >= 1 chunks of S, ``part`` (B H nsplit (hd + 2) fp32
// scratch) when nsplit > 1; hd in {32, 64, 128}; 16-byte aligned k, v (the
// wrapper checks).
extern "C" cudaError_t repro_decode_stats_bf16(
    const void* q, const void* k, const void* v, const void* length,
    void* acc, void* m, void* l, void* part, int B, int S, int H, int KV,
    int hd, int s_offset, int streams, int unroll, int block_k, int nsplit,
    float scale, void* stream) {
  return dense_stats<__nv_bfloat16>(q, k, v, nullptr, nullptr, length, acc,
                                    m, l, part, B, S, H, KV, hd, s_offset,
                                    streams, unroll, block_k, nsplit, scale,
                                    stream);
}

// As above over an int8 cache: k, v (B, S, KV, hd) int8 and bf16 scales
// ks, vs (B, S, KV, 1).
extern "C" cudaError_t repro_decode_stats_int8(
    const void* q, const void* k, const void* ks, const void* v,
    const void* vs, const void* length, void* acc, void* m, void* l,
    void* part, int B, int S, int H, int KV, int hd, int s_offset,
    int streams, int unroll, int block_k, int nsplit, float scale,
    void* stream) {
  return dense_stats<int8_t>(q, k, v, ks, vs, length, acc, m, l, part, B, S,
                             H, KV, hd, s_offset, streams, unroll, block_k,
                             nsplit, scale, stream);
}
