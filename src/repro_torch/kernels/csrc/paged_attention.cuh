// Paged attention for one query row per block, shared by the decode kernel
// (one row per slot) and the chunked-prefill kernel (C slab rows per slot,
// each with its own causal limit).
//
// Layout (the JAX package's, serve/kvcache.py): pools (P, page, KV, HD)
// bf16; a slot's block-table row maps logical block j -> physical page.
// Logical position s of the slot lives at pool row
// ((bt[s / page] * page + s % page) * KV + kv_head) * HD.
#pragma once

#include "common.cuh"

namespace repro {

constexpr float kNeg = -1e30f;  // the JAX kernels' mask value (_NEG)

// A warp's V staging tile: 32 positions x one row of HD bf16 values, each
// row padded by 16 bytes so the 8 lanes of a 16-byte store phase land on
// distinct shared-memory banks.
template <int HD>
struct VStage {
  static constexpr int stride = HD + 8;         // bf16 elements per row
  static constexpr int bytes = 32 * stride * 2;
};

// Fold positions [0, n) into (m, l, acc): the warp takes 32-position tiles
// tile0, tile0 + tile_stride, ...; lane t owns position 32 * tile + t: it
// loads that K row and scores it against q (HD fp32 values in shared
// memory), and copies that V row into the warp's staging tile ``v_s`` —
// all of a tile's K and V loads are independent, so they are in flight
// together.  For the value update lane t owns output dims
// [t * HD / 32, (t + 1) * HD / 32) and reads the staged rows from shared
// memory.  Positions >= n are never read, which is the same function as
// the JAX kernels' full masked walk: a masked score is -1e30 and
// contributes an exact zero.
template <int HD>
__device__ __forceinline__ void attend_tiles(
    const float* q_s, __nv_bfloat16* v_s,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ bt_row,
    int page, int KV, int kv_head, int n, int tile0, int tile_stride,
    float scale, float& m, float& l, float* acc) {
  constexpr int DPL = HD / 32;
  constexpr int VS = VStage<HD>::stride;
  const int lane = threadIdx.x & 31;
  for (int tile = tile0; tile * 32 < n; tile += tile_stride) {
    const int pos = tile * 32 + lane;
    const bool live = pos < n;
    float s = kNeg;
    if (live) {
      const int pid = bt_row[pos / page];
      const long long off =
          (((long long)pid * page + pos % page) * KV + kv_head) * HD;
      const uint4* kr = reinterpret_cast<const uint4*>(k_pool + off);
      const uint4* vr = reinterpret_cast<const uint4*>(v_pool + off);
      uint4* vs = reinterpret_cast<uint4*>(v_s + lane * VS);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        vs[c] = vr[c];
        float kf[8];
        bf16x8_to_float(kr[c], kf);
#pragma unroll
        for (int j = 0; j < 8; ++j) dot = fmaf(q_s[c * 8 + j], kf[j], dot);
      }
      s = dot * scale;
    }
    __syncwarp();
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] *= alpha;
    const int cnt = min(32, n - tile * 32);
    for (int t = 0; t < cnt; ++t) {
      const float pt = __shfl_sync(kFull, p, t);
      const __nv_bfloat16* vrow = v_s + t * VS + lane * DPL;
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        acc[d] = fmaf(pt, __bfloat162float(vrow[d]), acc[d]);
    }
    __syncwarp();  // the next tile overwrites v_s
    m = m_new;
  }
}

// One block per (query row, KV head).  Row ``row`` = b * C + r is row r of
// slot b's C query rows (C = 1 for decode).  The row sees positions
// [0, n): n = length[b] for decode; n = min(q_offset[b] + r + 1, length[b])
// for a slab (SLAB), exactly what the mask (spos > qpos) | (spos >= length)
// leaves visible; n is clamped to the table's nblk * page rows.  The
// block's warps take the row's 32-position tiles in turn, each folding its
// own online-softmax state (m, l, acc) in fp32 registers; the partial
// states are merged through shared memory, normalized by max(l, 1e-30) and
// stored as bf16.  The G query heads of one KV head (GQA) are handled one
// after another by the same block, so their K/V rows come from L1/L2 after
// the first head.
template <int HD, bool SLAB>
__global__ void paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ block_tables, const int* __restrict__ q_offset,
    const int* __restrict__ length, __nv_bfloat16* __restrict__ out, int C,
    int H, int KV, int page, int nblk, float scale) {
  constexpr int DPL = HD / 32;
  const int row = blockIdx.x, kvh = blockIdx.y;
  const int b = row / C;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __shared__ float q_s[HD];
  // dynamic: V staging [nw][32][VStage::stride], then m[nw], l[nw],
  // acc[nw][HD]
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* v_s =
      reinterpret_cast<__nv_bfloat16*>(smem) + warp * (VStage<HD>::bytes / 2);
  float* pm = reinterpret_cast<float*>(smem + nw * VStage<HD>::bytes);
  float* pl = pm + nw;
  float* pacc = pm + 2 * nw;

  int n = length[b];
  if constexpr (SLAB) n = min(n, q_offset[b] + row % C + 1);
  n = max(0, min(n, nblk * page));
  const int* bt_row = block_tables + (size_t)b * nblk;
  for (int g = 0; g < G; ++g) {
    const size_t qo = ((size_t)row * H + kvh * G + g) * HD;
    __syncthreads();  // the previous head's merge is done with pm / q_s
    for (int d = threadIdx.x; d < HD; d += blockDim.x)
      q_s[d] = __bfloat162float(q[qo + d]);
    __syncthreads();

    float m = kNeg, l = 0.f, acc[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
    attend_tiles<HD>(q_s, v_s, k_pool, v_pool, bt_row, page, KV, kvh, n,
                     warp, nw, scale, m, l, acc);
    if (lane == 0) {
      pm[warp] = m;
      pl[warp] = l;
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) pacc[warp * HD + lane * DPL + d] = acc[d];
    __syncthreads();

    for (int d = threadIdx.x; d < HD; d += blockDim.x) {
      float M = kNeg;
      for (int w = 0; w < nw; ++w) M = fmaxf(M, pm[w]);
      float L = 0.f, A = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float f = expf(pm[w] - M);
        L = fmaf(pl[w], f, L);
        A = fmaf(pacc[w * HD + d], f, A);
      }
      out[qo + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    }
  }
}

template <int HD, bool SLAB>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const void* bt, const void* q_offset,
                         const void* length, void* out, int rows, int C,
                         int H, int KV, int page, int nblk, int warps,
                         float scale, cudaStream_t stream) {
  const int smem =
      warps * (VStage<HD>::bytes + (int)sizeof(float) * (2 + HD));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<HD, SLAB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_kernel<HD, SLAB>
      <<<dim3(rows, KV), warps * 32, smem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
          (const __nv_bfloat16*)vp, (const int*)bt, (const int*)q_offset,
          (const int*)length, (__nv_bfloat16*)out, C, H, KV, page, nblk,
          scale);
  return cudaGetLastError();
}

// Checks the launch parameters and picks the head-dim instantiation.
// q_offset is read only for a slab (SLAB).
template <bool SLAB>
cudaError_t paged_attention(const void* q, const void* kp, const void* vp,
                            const void* bt, const void* q_offset,
                            const void* length, void* out, int B, int C,
                            int H, int KV, int hd, int page, int nblk,
                            int warps, float scale, void* stream) {
  if (B <= 0 || C <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || page <= 0 || nblk <= 0 || warps < 1 ||
      warps > 32)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = B * C;
  switch (hd) {
    case 32:
      return launch_paged<32, SLAB>(q, kp, vp, bt, q_offset, length, out,
                                    rows, C, H, KV, page, nblk, warps, scale,
                                    s);
    case 64:
      return launch_paged<64, SLAB>(q, kp, vp, bt, q_offset, length, out,
                                    rows, C, H, KV, page, nblk, warps, scale,
                                    s);
    case 128:
      return launch_paged<128, SLAB>(q, kp, vp, bt, q_offset, length, out,
                                     rows, C, H, KV, page, nblk, warps,
                                     scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro
