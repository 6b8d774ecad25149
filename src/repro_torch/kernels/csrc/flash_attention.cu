// FLASH ATTENTION: o = softmax(q k^T / sqrt(hd)) v over all S positions
// of the KV head of each query head, causal (position s masked for query t
// when s > t, aligned at the top left) or not; q (B,T,H,hd), k/v
// (B,S,KV,hd), H a multiple of KV, all fp32 or all bf16; o in q's type.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (the
//   paper's GEMM-class control: a grid of (batch, query tile of 128 x
//   unroll positions, KV tile of block_k / 2 positions), the G query heads
//   of each KV head in one block, the online softmax's m, l and acc in VMEM
//   scratch across the KV steps).
// Bound on the H100: operations.  Each (query, position) pair costs 4 hd
//   operations (two dot products of hd) against 2 hd bytes of K and V per
//   position read once, so at T = S = 2048 the work is ~1,000 operations a
//   byte, above the card's ridge for fp32 (67 TFLOP/s, ~20 a byte) and for
//   bf16 (989 TFLOP/s, ~295 a byte).  This kernel computes in fp32 on the
//   CUDA cores (no TF32, no tensor cores), so its floor is the fp32 rate;
//   the tensor-core form (wgmma over bf16 tiles) is later work.
// Design: one block of 256 threads per (batch, tile of BM query rows, KV
//   head), where a row is one (position, head of the group) pair, so the G
//   heads of a KV head read each K/V tile once, as the Pallas block does.
//   The block stages its BM rows of q, then walks the positions in tiles of
//   BN: each K and V tile is converted to fp32 into shared memory once, the
//   BM x BN scores are computed as 16 x 16 threads each holding RM x CN
//   (rows ty*RM.., columns tx + 16 j) with 16-byte shared loads along hd
//   (rows padded by 4 floats, so a quarter warp's loads hit 32 distinct
//   banks), scaled and masked (past S, past the last row, and above the
//   diagonal when causal), and folded into the running max m and sum l of
//   each row (shuffles over the 16 threads of a row); p goes through
//   shared memory into acc (RM x hd/16 per thread, in registers).  m, l
//   and acc stay in registers for the whole walk (the shadow-buffer intent
//   (C)); the output is acc / max(l, 1e-30), written once.  A causal
//   block stops at its last row's position, and the grid runs its tiles
//   last first, so the longest blocks start first.
// Knobs (the JAX space, {unroll: 1, 2} x {block_k: 256, 512}): the Pallas
//   tile is 128 unroll positions x G heads of fp32 accumulators (128 KB at
//   G = 4, hd = 64), more than a block's registers hold, so here `unroll`
//   scales the rows a block, BM = 64 unroll (RM = 4 unroll a thread), and
//   `block_k` the positions a tile, BN = block_k / 8 (32 or 64, CN = BN /
//   16), a quarter of the Pallas tile's block_k / 2.  Shared memory is
//   (BM (hd + 4) + BN (hd + 4) + BN hd + BM (BN + 4)) floats: 42.5 KB at
//   BM = 64, BN = 32, hd = 64, and 165 KB at BM = 128, BN = 64, hd = 128
//   (above 48 KB only after cudaFuncSetAttribute).  hd is 32, 64 or 128.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty (row groups) x tx (columns)
constexpr float kNeg = -1e30f;  // the JAX kernel's running-max start

template <typename T>
__device__ __forceinline__ void store(T* p, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float v) {
  *p = __float2bfloat16(v);
}

template <int HD, int RM, int CN>
constexpr size_t smem_floats() {
  return (size_t)(16 * RM) * (HD + 4) + (size_t)(16 * CN) * (HD + 4) +
         (size_t)(16 * CN) * HD + (size_t)(16 * RM) * (16 * CN + 4);
}

template <typename T, int HD, int RM, int CN>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int T_, int S,
                 int H, int KV, int causal, float scale) {
  constexpr int BM = 16 * RM, BN = 16 * CN, DN = HD / 16;
  constexpr int QS = HD + 4, KS = HD + 4, PS = BN + 4;
  constexpr int V = repro::Vec<T>::n;  // elements per 16-byte load
  constexpr int VPR = HD / V;          // 16-byte loads per row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BM x QS
  float* ks = qs + BM * QS;                     // BN x KS
  float* vs = ks + BN * KS;                     // BN x HD
  float* ps = vs + BN * HD;                     // BM x PS

  const int G = H / KV;
  const int rows = T_ * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;  // last tiles first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // the block's rows of q, in fp32 (rows past the end: zeros)
  for (int e = tid; e < BM * VPR; e += kThreads) {
    const int r = e / VPR, d = (e % VPR) * V;
    const int R = r0 + r;
    float f[V];
    if (R < rows) {
      const int t = R / G, g = R % G;
      const T* src = q + (((size_t)b * T_ + t) * H + kvh * G + g) * HD + d;
      repro::Vec<T>::load(*reinterpret_cast<const uint4*>(src), f);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) qs[r * QS + d + j] = f[j];
  }

  int tq[RM];  // each row's query position (-1: past the end)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int R = r0 + ty * RM + i;
    tq[i] = R < rows ? R / G : -1;
  }
  const int last = (min(r0 + BM, rows) - 1) / G;
  const int send = causal ? min(S, last + 1) : S;

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  for (int s0 = 0; s0 < send; s0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BN * VPR; e += kThreads) {
      const int c = e / VPR, d = (e % VPR) * V;
      const int sp = s0 + c;
      float fk[V], fv[V];
      if (sp < S) {
        const size_t off = (((size_t)b * S + sp) * KV + kvh) * HD + d;
        repro::Vec<T>::load(*reinterpret_cast<const uint4*>(k + off), fk);
        repro::Vec<T>::load(*reinterpret_cast<const uint4*>(v + off), fv);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) fk[j] = fv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ks[c * KS + d + j] = fk[j];
        vs[c * HD + d + j] = fv[j];
      }
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty * RM + i) * QS + d);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * KS + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale, mask, and fold the tile into each row's running max and sum
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int sp = s0 + tx + 16 * j;
        const bool ok = tq[i] >= 0 && sp < S && (!causal || sp <= tq[i]);
        s[i][j] = ok ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(repro::kFull, mx, w));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - mn);  // masked: exp(-inf) = 0
        sum += p;
        ps[(ty * RM + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(repro::kFull, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p v
#pragma unroll 2
    for (int c = 0; c < BN; c += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty * RM + i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DN];
#pragma unroll
        for (int j = 0; j < DN; ++j) vv[j] = vs[(c + cc) * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = cc == 0   ? pv[i].x
                          : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z
                                    : pv[i].w;
#pragma unroll
          for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (tq[i] < 0) continue;
    const int R = r0 + ty * RM + i;
    const int g = R % G;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = o + (((size_t)b * T_ + tq[i]) * H + kvh * G + g) * HD + tx;
#pragma unroll
    for (int j = 0; j < DN; ++j) store<T>(dst + 16 * j, acc[i][j] / den);
  }
}

template <typename T, int HD, int RM, int CN>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o,
                     int B, int T_, int S, int H, int KV, int causal,
                     float scale, cudaStream_t stream) {
  constexpr int BM = 16 * RM;
  const size_t smem = smem_floats<HD, RM, CN>() * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, HD, RM, CN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = T_ * (H / KV);
  const dim3 grid((rows + BM - 1) / BM, KV, B);
  flash_kernel<T, HD, RM, CN><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, T_, S, H, KV, causal,
      scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int T_, int S, int H, int KV, int causal,
                      int unroll, int block_k, float scale,
                      cudaStream_t stream) {
  if (unroll == 1 && block_k == 256)
    return launch_t<T, HD, 4, 2>(q, k, v, o, B, T_, S, H, KV, causal, scale,
                                 stream);
  if (unroll == 1 && block_k == 512)
    return launch_t<T, HD, 4, 4>(q, k, v, o, B, T_, S, H, KV, causal, scale,
                                 stream);
  if (unroll == 2 && block_k == 256)
    return launch_t<T, HD, 8, 2>(q, k, v, o, B, T_, S, H, KV, causal, scale,
                                 stream);
  if (unroll == 2 && block_k == 512)
    return launch_t<T, HD, 8, 4>(q, k, v, o, B, T_, S, H, KV, causal, scale,
                                 stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int T_, int S, int H, int KV, int hd, int causal,
                   int unroll, int block_k, float scale, void* stream) {
  if (B < 1 || T_ < 1 || S < 1 || KV < 1 || H < KV || H % KV != 0 ||
      B > 65535 || KV > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(q, k, v, o, B, T_, S, H, KV, causal, unroll,
                              block_k, scale, s);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, B, T_, S, H, KV, causal, unroll,
                              block_k, scale, s);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, B, T_, S, H, KV, causal, unroll,
                               block_k, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,T,H,hd), k, v (B,S,KV,hd), o (B,T,H,hd), contiguous and 16-byte
// aligned, all fp32 or all bf16; hd 32, 64 or 128; unroll 1 or 2; block_k
// 256 or 512; scale = hd^-0.5.
extern "C" cudaError_t repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int T,
    int S, int H, int KV, int hd, int causal, int unroll, int block_k,
    float scale, void* stream) {
  return launch<float>(q, k, v, o, B, T, S, H, KV, hd, causal, unroll,
                       block_k, scale, stream);
}

extern "C" cudaError_t repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int T,
    int S, int H, int KV, int hd, int causal, int unroll, int block_k,
    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, T, S, H, KV, hd, causal,
                               unroll, block_k, scale, stream);
}
