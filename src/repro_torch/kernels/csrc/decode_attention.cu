// Paged decode attention: one query token per slot attends over the slot's
// cached K/V, gathered page by page through its block-table row.
//
// Replaces: src/repro/kernels/decode_attention.py `paged_decode_attention`
//   (`_paged_decode_attention`: a (slot, page) grid whose page index comes
//   from the scalar-prefetched block table, online-softmax state in VMEM,
//   normalized at the last page).
// Bound on the H100: bytes.  Each slot streams length x KV x hd x 2 x 2
//   bytes of K and V for 4 x H x length x hd operations: about one
//   operation per byte, far below the bf16 ridge.
// Design (paged_attention.cuh, C = 1): one block per (slot, KV head); the
//   block reads its own block-table row (no scalar prefetch).  Its warps
//   split the slot's positions into 32-position tiles taken in turn; in a
//   tile each lane scores one position (a 16-byte-vector dot product
//   against q in shared memory) while copying that position's V row into
//   the warp's shared-memory staging tile, so a tile's K and V loads are all
//   in flight at once; the warp then updates its fp32 online-softmax state
//   from the staged rows.  The walk stops at the slot's length (the JAX
//   kernel walks every page and masks; masked pages add exact zeros, so
//   both compute the same function), and the warps' states merge through
//   shared memory.  A slot with an all-NULL table row and a stale length
//   (idle or mid-prefill slots in the engine's decode batch) reads page 0
//   and writes a garbage row that nothing reads.
#include "paged_attention.cuh"

// q (B, H, hd) bf16; k_pool / v_pool (P, page, KV, hd) bf16; block_tables
// (B, nblk) int32; length (B,) int32; out (B, H, hd) bf16.  hd in {32, 64,
// 128}, H % KV == 0, 16-byte aligned pools (the wrapper checks).
extern "C" cudaError_t repro_paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* length, void* out, int B, int H,
    int KV, int hd, int page, int nblk, int warps, float scale,
    void* stream) {
  return repro::paged_attention<false>(q, k_pool, v_pool, block_tables,
                                       nullptr, length, out, B, 1, H, KV, hd,
                                       page, nblk, warps, scale, stream);
}
