// Paged decode attention: one query token per slot attends over the slot's
// cached K/V, gathered page by page through its block-table row; bf16
// pools, or int8 pools with bf16 per-(position, KV head) scale pools.
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
#include "paged_attention.cuh"

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
