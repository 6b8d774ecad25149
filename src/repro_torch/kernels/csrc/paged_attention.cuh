// Paged decode attention for one query row per block (one row per slot),
// over bf16 or int8 page pools, through the SIMT online-softmax walk
// attend_tiles.
//
// Layout (the JAX package's, serve/kvcache.py): pools (P, page, KV, HD)
// bf16, or int8 with bf16 scale pools (P, page, KV, 1) addressed by the
// same pool row; a slot's block-table row maps logical block j -> physical
// page.
// Logical position s of the slot lives at pool row
// ((bt[s / page] * page + s % page) * KV + kv_head) * HD.
#pragma once

#include "common.cuh"

namespace repro {

constexpr float kNeg = -1e30f;  // the JAX kernels' mask value (_NEG)

// A warp's V staging tile: 32 positions x one row of HD elements of type E,
// each row padded by 16 bytes so the 8 lanes of a 16-byte store phase land
// on distinct shared-memory banks; int8 rows carry their dequantization
// scales after the tile (one fp32 per position).
template <int HD, typename E>
struct VStage {
  static constexpr bool kInt8 = sizeof(E) == 1;
  static constexpr int stride = HD + 16 / (int)sizeof(E);  // elements
  static constexpr int rows_bytes = 32 * stride * (int)sizeof(E);
  static constexpr int bytes = rows_bytes + (kInt8 ? 32 * 4 : 0);
};

// 16 int8 values of a K row times the row's scale -> floats (the int8
// pools' fp32 dequantization, k8 * ks).
__device__ __forceinline__ void int8x16_to_float(const uint4& u, float* f,
                                                 float scale) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = w[i] ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[4 * i + k] = biased_byte_to_float(b, k) * scale;
  }
}

// The N (1, 2 or 4) int8 values at ``p`` (N-byte aligned) -> floats.
template <int N>
__device__ __forceinline__ void int8xn_to_float(const int8_t* p, float* f) {
  uint32_t w;
  if constexpr (N == 4)
    w = *reinterpret_cast<const uint32_t*>(p);
  else if constexpr (N == 2)
    w = *reinterpret_cast<const uint16_t*>(p);
  else
    w = (uint8_t)*p;
  w ^= 0x80808080u;
#pragma unroll
  for (int k = 0; k < N; ++k) f[k] = biased_byte_to_float(w, k);
}

// A 16-byte copy from device to shared memory that bypasses the registers
// (cp.async, sm_80+): issued now, complete after ``cp_async_wait_all``.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The N (1, 2 or 4) bf16 values at ``p`` (2N-byte aligned) -> floats, in
// one shared-memory load.
template <int N>
__device__ __forceinline__ void bf16xn_to_float(const __nv_bfloat16* p,
                                                float* f) {
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = a.x;
    f[1] = a.y;
  } else {
    f[0] = __bfloat162float(*p);
  }
}

// Where position ``pos`` of the walked cache lives: the pool row (in units
// of HD elements) of that position's K / V vector for one KV head, through
// the slot's block-table row.
struct PagedIndex {
  const int* bt_row;
  int page, KV, kv_head;
  __device__ __forceinline__ long long operator()(int pos) const {
    return ((long long)bt_row[pos / page] * page + pos % page) * KV +
           kv_head;
  }
};

// Fold positions [0, end) into (m, l, acc): the warp takes 32-position
// tiles tile0, tile0 + tile_stride, ...; lane t owns position 32 * tile + t
// of each.  It first starts asynchronous copies (cp.async) of its V row into
// the warp's staging tile ``v_s`` (and, for int8 pools, stores its scale),
// then loads its whole K row into registers at once and scores it against
// q (HD fp32 values in shared memory): every load of a row is in flight
// together, and the V copies overlap the scoring.  Then the tile updates the
// state: for the value update lane t owns output dims [t * HD / 32, (t + 1)
// * HD / 32) and reads the staged rows from shared memory, a lane's dims in
// one load.  Positions >= end are never read, which is the same function as
// the JAX kernels' full masked walk: a masked score is -1e30 and
// contributes an exact zero.  int8 pools (E = int8_t) take a bf16 scale per
// (position, KV head) from ``k_scale`` / ``v_scale`` (P, page, KV, 1) at
// the same pool row, and dequantize K and V in fp32 before the dot and the
// value update.
template <int HD, typename E>
__device__ __forceinline__ void attend_tiles(
    const float* q_s, unsigned char* v_s, const E* __restrict__ k_pool,
    const E* __restrict__ v_pool, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, PagedIndex index, int end,
    int tile0, int tile_stride, float scale, float& m, float& l,
    float* acc) {
  using Stage = VStage<HD, E>;
  constexpr int DPL = HD / 32;
  constexpr int PER16 = 16 / (int)sizeof(E);     // elements per 16 bytes
  const int lane = threadIdx.x & 31;
  constexpr int NV = HD / PER16;                  // 16-byte vectors a row
  for (int tile = tile0; tile * 32 < end; tile += tile_stride) {
    const int pos = tile * 32 + lane;
    const long long row = pos < end ? index(pos) : -1;
    if (row >= 0) {
      E* v_rows = reinterpret_cast<E*>(v_s);
      const uint4* vr = reinterpret_cast<const uint4*>(v_pool + row * HD);
      uint4* vs = reinterpret_cast<uint4*>(v_rows + lane * Stage::stride);
#pragma unroll
      for (int c = 0; c < NV; ++c) cp_async16(vs + c, vr + c);
      if constexpr (Stage::kInt8)
        reinterpret_cast<float*>(v_s + Stage::rows_bytes)[lane] =
            __bfloat162float(v_scale[row]);
    }
    float s = kNeg;
    if (row >= 0) {
      const uint4* kr = reinterpret_cast<const uint4*>(k_pool + row * HD);
      uint4 kv[NV];
#pragma unroll
      for (int c = 0; c < NV; ++c) kv[c] = kr[c];
      float ks = 1.f;
      if constexpr (Stage::kInt8) ks = __bfloat162float(k_scale[row]);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float kf[PER16];
        if constexpr (Stage::kInt8)
          int8x16_to_float(kv[c], kf, ks);
        else
          bf16x8_to_float(kv[c], kf);
#pragma unroll
        for (int j = 0; j < PER16; ++j)
          dot = fmaf(q_s[c * PER16 + j], kf[j], dot);
      }
      s = dot * scale;
    }
    cp_async_wait_all();
    __syncwarp();
    const E* v_rows = reinterpret_cast<const E*>(v_s);
    const float* v_scl =
        reinterpret_cast<const float*>(v_s + Stage::rows_bytes);
    const int base = tile * 32;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = pos < end ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] *= alpha;
    const int cnt = min(32, end - base);
    for (int t = 0; t < cnt; ++t) {
      const float pt = __shfl_sync(kFull, p, t);
      const E* vrow = v_rows + t * Stage::stride + lane * DPL;
      if constexpr (Stage::kInt8) {
        const float vsc = v_scl[t];
        float vf[DPL];
        int8xn_to_float<DPL>(vrow, vf);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[d] = fmaf(pt, vf[d] * vsc, acc[d]);
      } else {
        float vf[DPL];
        bf16xn_to_float<DPL>(vrow, vf);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[d] = fmaf(pt, vf[d], acc[d]);
      }
    }
    m = m_new;
    __syncwarp();  // the next tile overwrites v_s
  }
}

// One block per (slot, KV head).  Slot b's query row sees positions [0,
// n), n = length[b] clamped to the table's nblk * page rows.  The block's
// warps take the row's 32-position tiles in turn, each folding its
// own online-softmax state (m, l, acc) in fp32 registers; the partial
// states are merged through shared memory, normalized by max(l, 1e-30) and
// stored as bf16.  The G query heads of one KV head (GQA) are handled one
// after another by the same block, so their K/V rows come from L1/L2 after
// the first head.
template <int HD, typename E>
__global__ void paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const E* __restrict__ k_pool,
    const E* __restrict__ v_pool, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale,
    const int* __restrict__ block_tables, const int* __restrict__ length,
    __nv_bfloat16* __restrict__ out, int H, int KV, int page, int nblk,
    float scale) {
  constexpr int DPL = HD / 32;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __shared__ float q_s[HD];
  // dynamic: V staging [nw][32][VStage::stride], then m[nw], l[nw],
  // acc[nw][HD]
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* v_s = smem + warp * VStage<HD, E>::bytes;
  float* pm = reinterpret_cast<float*>(smem + nw * VStage<HD, E>::bytes);
  float* pl = pm + nw;
  float* pacc = pm + 2 * nw;

  const int n = max(0, min(length[b], nblk * page));
  const int* bt_row = block_tables + (size_t)b * nblk;
  for (int g = 0; g < G; ++g) {
    const size_t qo = ((size_t)b * H + kvh * G + g) * HD;
    __syncthreads();  // the previous head's merge is done with pm / q_s
    for (int d = threadIdx.x; d < HD; d += blockDim.x)
      q_s[d] = __bfloat162float(q[qo + d]);
    __syncthreads();

    float m = kNeg, l = 0.f, acc[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] = 0.f;
    attend_tiles<HD, E>(q_s, v_s, k_pool, v_pool, k_scale, v_scale,
                        PagedIndex{bt_row, page, KV, kvh}, n, warp, nw,
                        scale, m, l, acc);
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

template <int HD, typename E>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const void* ks, const void* vs, const void* bt,
                         const void* length, void* out, int B, int H, int KV,
                         int page, int nblk, int warps, float scale,
                         cudaStream_t stream) {
  const int smem =
      warps * (VStage<HD, E>::bytes + (int)sizeof(float) * (2 + HD));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<HD, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_kernel<HD, E><<<dim3(B, KV), warps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const E*)kp, (const E*)vp,
      (const __nv_bfloat16*)ks, (const __nv_bfloat16*)vs, (const int*)bt,
      (const int*)length, (__nv_bfloat16*)out, H, KV, page, nblk, scale);
  return cudaGetLastError();
}

// Checks the launch parameters and picks the head-dim instantiation.
// ks / vs (the scale pools) are read only for int8 pools (E = int8_t).
template <typename E = __nv_bfloat16>
cudaError_t paged_attention(const void* q, const void* kp, const void* vp,
                            const void* ks, const void* vs, const void* bt,
                            const void* length, void* out, int B, int H,
                            int KV, int hd, int page, int nblk, int warps,
                            float scale, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || page <= 0 || nblk <= 0 || warps < 1 ||
      warps > 32)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_paged<32, E>(q, kp, vp, ks, vs, bt, length, out, B, H,
                                 KV, page, nblk, warps, scale, s);
    case 64:
      return launch_paged<64, E>(q, kp, vp, ks, vs, bt, length, out, B, H,
                                 KV, page, nblk, warps, scale, s);
    case 128:
      return launch_paged<128, E>(q, kp, vp, ks, vs, bt, length, out, B, H,
                                  KV, page, nblk, warps, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro
