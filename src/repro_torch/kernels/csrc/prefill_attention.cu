// Paged chunked-prefill attention: a slab of C query rows, the first at
// absolute position q_offset, attends causally over the slot's paged K/V
// (its own rows just written, plus any shared prefix pages).
//
// Replaces: src/repro/kernels/prefill_attention.py `prefill_attention_paged`
//   (`_prefill_attention_paged`: the slab rides in VMEM while a (slot, page)
//   grid streams pages through the scalar-prefetched block table; causal
//   mask against the absolute q_offset, positions >= length masked).
// Bound on the H100: bytes.  One slab of C = 32 rows reads up to
//   length x KV x hd x 2 x 2 bytes of K/V for up to 4 x C x H x length x hd
//   operations: ~C operations per byte, below the ~295 per byte of the
//   bf16 tensor-core ridge.  This kernel does its products as fp32 FMAs on
//   the CUDA cores, whose ridge (~20 per byte at 67 TFLOP/s) the slab
//   exceeds, so the design, not the function, caps it at the fp32 rate; the
//   way to the byte bound is mma over the slab, reading each K/V row once
//   per slab.
// Design (paged_attention.cuh): each slab row is its own decode problem.
//   One block per (slab row, KV head), row r seeing positions [0, n),
//   n = min(q_offset + r + 1, length) — exactly what the mask
//   (spos > qpos) | (spos >= length) leaves visible.  The block's warps
//   split those positions into 32-position tiles (one lane per position
//   scores K and stages V in shared memory, so a tile's loads overlap) and
//   merge their online-softmax states.  The C rows read the same pages, so
//   after the first the K/V rows come from L2.  Pad rows (r >= valid) see
//   [0, length) and produce garbage that the caller discards, as in the
//   JAX kernel.
#include "paged_attention.cuh"

// q (B, C, H, hd) bf16; k_pool / v_pool (P, page, KV, hd) bf16;
// block_tables (B, nblk) int32; q_offset, length (B,) int32; out (B, C, H,
// hd) bf16.  hd in {32, 64, 128}, H % KV == 0, 16-byte aligned pools.
extern "C" cudaError_t repro_paged_prefill_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* q_offset, const void* length,
    void* out, int B, int C, int H, int KV, int hd, int page, int nblk,
    int warps, float scale, void* stream) {
  return repro::paged_attention<true>(q, k_pool, v_pool, nullptr, nullptr,
                                      block_tables, q_offset, length, out, B,
                                      C, H, KV, hd, page, nblk, warps, scale,
                                      stream);
}
