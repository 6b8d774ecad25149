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
//   bf16 (989 TFLOP/s, ~295 a byte).  The two input types take two kernels:
//
// bf16: the tensor cores (`flash_bf16_kernel`).  One block per (tile of
//   BM = 64 unroll query rows, KV head, batch), where a row is one
//   (position, head of the group) pair, so the G heads of a KV head read
//   each K/V tile once, as the Pallas block does.  The block is `unroll`
//   consumer warpgroups of 64 rows each plus one producer warp:
//   - the producer's lane 0 streams the K and V tiles of BN positions by
//     TMA (a 4-D tensor map over (hd, KV, S, B), so a KV head's rows,
//     strided by KV hd elements, need no copy; positions past S arrive as
//     zeros) into a ring of two stages (three for hd = BN = 128, where they
//     fit without costing an SM a block), each with a "full" mbarrier (the
//     bytes landed) and an "empty" one (every consumer thread is done with
//     it), so the next tiles are in flight while one is multiplied;
//   - meanwhile the consumers write the block's q rows into shared memory
//     (16-byte loads, all issued before the first store: a row is a
//     (position, head) pair, not a tensor-map box) in the 128-byte swizzle
//     (64-byte for hd 32) that TMA gives K and V;
//   - per tile, each consumer warpgroup computes its 64 x BN scores as
//     hd / 16 `wgmma` m64nBNk16 with q and K from shared memory (both
//     K-major) into fp32 registers; masks only a tile that crosses S or the
//     diagonal; keeps the running max m and sum l of its rows in registers
//     (shuffles over the quad that shares a row; exponentials on the
//     special-function unit, `ex2.approx`); converts p to bf16 in
//     registers, which are already the A fragments of the second product,
//     and runs BN / 16 `wgmma` m64nhdk16 with p from registers and V from
//     shared memory as the MN-major B operand (the transpose bit), so V
//     needs no transposed copy and the scores never touch shared memory.
//     l sums the bf16 p that the product uses, so the output is a convex
//     combination of V's rows.
//   A causal block skips the tiles wholly above its last row's position,
//   and the grid runs its row tiles last first across all heads and
//   batches, so the longest blocks start first.  The one numerical change
//   from fp32 math is p in bf16 (the JAX kernel's fp32 dot at default
//   precision on the TPU also runs bf16 passes).  The output is acc / l,
//   written once as bf16.  (Issuing tile j's scores before tile j - 1's p
//   v, so that the softmax overlaps the tensor cores, measured slower on
//   the H100 at every candidate but one: PERF.md §6.)
// fp32: the CUDA cores (`flash_kernel`), fp32 math with no TF32 (the
//   tuner's fp32 bound and the JAX test's 2e-4 ask for it).  One block of
//   256 threads per (batch, tile of BM rows, KV head) as above.  The block
//   stages its BM rows of q, then walks the positions in tiles of BN: each
//   K and V tile is copied into shared memory once, the BM x BN scores are
//   computed as 16 x 16 threads each holding RM x CN (rows ty*RM..,
//   columns tx + 16 j) with 16-byte shared loads along hd (rows padded by 4
//   floats, so a quarter warp's loads hit 32 distinct banks), scaled and
//   masked (past S, past the last row, and above the diagonal when
//   causal), and folded into the running max m and sum l of each row
//   (shuffles over the 16 threads of a row); p goes through shared memory
//   into acc (RM x hd/16 per thread, in registers).  m, l and acc stay in
//   registers for the whole walk (the shadow-buffer intent (C)); the
//   output is acc / max(l, 1e-30), written once.
// Knobs (the JAX space, {unroll: 1, 2} x {block_k: 256, 512}): the Pallas
//   tile is 128 unroll positions x G heads of fp32 accumulators (128 KB at
//   G = 4, hd = 64), more than a block's registers hold, so `unroll` scales
//   the rows a block and `block_k` the positions a tile.  bf16: BM = 64
//   unroll rows (one `wgmma` warpgroup each), BN = block_k / 4 positions
//   (64 or 128, the N of the score product and the K of the second), a
//   shared memory of (BM + 2 BN stages) hd bf16 (224 KB at BM = BN = hd =
//   128, three stages).
//   fp32: BM = 64 unroll (RM = 4 unroll a thread), BN = block_k / 8 (32 or
//   64, CN = BN / 16), a shared memory of (BM (hd + 4) + BN (hd + 4) + BN hd
//   + BM (BN + 4)) floats: 42.5 KB at BM = 64, BN = 32, hd = 64, and 165 KB
//   at BM = 128, BN = 64, hd = 128 (above 48 KB only after
//   cudaFuncSetAttribute).  hd is 32, 64 or 128.
#include <cuda.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

// ------------------------------------------------------------ fp32 (SIMT)
constexpr int kThreads = 256;  // 16 x 16: ty (row groups) x tx (columns)
constexpr float kNeg = -1e30f;  // the JAX kernel's running-max start

template <int HD, int RM, int CN>
constexpr size_t smem_floats() {
  return (size_t)(16 * RM) * (HD + 4) + (size_t)(16 * CN) * (HD + 4) +
         (size_t)(16 * CN) * HD + (size_t)(16 * RM) * (16 * CN + 4);
}

template <int HD, int RM, int CN>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T_,
                 int S, int H, int KV, int causal, float scale) {
  constexpr int BM = 16 * RM, BN = 16 * CN, DN = HD / 16;
  constexpr int QS = HD + 4, KS = HD + 4, PS = BN + 4;
  constexpr int V = repro::Vec<float>::n;  // elements per 16-byte load
  constexpr int VPR = HD / V;              // 16-byte loads per row
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
      const float* src =
          q + (((size_t)b * T_ + t) * H + kvh * G + g) * HD + d;
      repro::Vec<float>::load(*reinterpret_cast<const uint4*>(src), f);
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
        repro::Vec<float>::load(*reinterpret_cast<const uint4*>(k + off), fk);
        repro::Vec<float>::load(*reinterpret_cast<const uint4*>(v + off), fv);
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
    float* dst = o + (((size_t)b * T_ + tq[i]) * H + kvh * G + g) * HD + tx;
#pragma unroll
    for (int j = 0; j < DN; ++j) dst[16 * j] = acc[i][j] / den;
  }
}

template <int HD, int RM, int CN>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o,
                     int B, int T_, int S, int H, int KV, int causal,
                     float scale, cudaStream_t stream) {
  constexpr int BM = 16 * RM;
  const size_t smem = smem_floats<HD, RM, CN>() * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<HD, RM, CN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = T_ * (H / KV);
  const dim3 grid((rows + BM - 1) / BM, KV, B);
  flash_kernel<HD, RM, CN><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, T_, S, H,
      KV, causal, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int T_, int S, int H, int KV, int causal,
                      int unroll, int block_k, float scale,
                      cudaStream_t stream) {
  if (unroll == 1 && block_k == 256)
    return launch_t<HD, 4, 2>(q, k, v, o, B, T_, S, H, KV, causal, scale,
                              stream);
  if (unroll == 1 && block_k == 512)
    return launch_t<HD, 4, 4>(q, k, v, o, B, T_, S, H, KV, causal, scale,
                              stream);
  if (unroll == 2 && block_k == 256)
    return launch_t<HD, 8, 2>(q, k, v, o, B, T_, S, H, KV, causal, scale,
                              stream);
  if (unroll == 2 && block_k == 512)
    return launch_t<HD, 8, 4>(q, k, v, o, B, T_, S, H, KV, causal, scale,
                              stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int T_, int S, int H, int KV, int hd,
                       int causal, int unroll, int block_k, float scale,
                       void* stream) {
  if (B < 1 || T_ < 1 || S < 1 || KV < 1 || H < KV || H % KV != 0 ||
      B > 65535 || KV > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_hd<32>(q, k, v, o, B, T_, S, H, KV, causal, unroll,
                           block_k, scale, s);
    case 64:
      return launch_hd<64>(q, k, v, o, B, T_, S, H, KV, causal, unroll,
                           block_k, scale, s);
    case 128:
      return launch_hd<128>(q, k, v, o, B, T_, S, H, KV, causal, unroll,
                            block_k, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------- bf16 (tensor cores)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// whether the phase of ``bar`` with this parity has completed (the
// instruction itself waits a while before it answers no)
__device__ __forceinline__ bool mbar_done(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for that phase; a wait that outlasts any copy by orders of magnitude
// (a lost arrival) traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int n = 0; !mbar_done(bar, parity); ++n)
    if (n == (1 << 24)) __trap();
}

// one box of the 4-D tensor map (hd, KV, S, B) into shared memory; the
// bytes count against ``bar``'s transaction
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(h), "r"(s), "r"(b),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of a register that a
// wgmma in flight owns across the fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the special-function unit, subnormal results flushed to zero (x
// <= 0 here; exp2f adds a range fix-up around the same instruction)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the 64-bit shared-memory matrix descriptor of wgmma: start address,
// leading and stride byte offsets (16-byte units), swizzle (1: 128 B, 2: 64
// B)
__device__ __forceinline__ uint64_t mdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo, uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// D (64 x 64 fp32) = A (64 x 16) . B (64 x 16)^T (+ D when scale_d), A
// and B bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128 fp32) = A (64 x 16) . B (128 x 16)^T (+ D when scale_d), A
// and B bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss128(float* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 32 fp32) += A (64 x 16) . B (16 x 32), A bf16 in registers,
// B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs32(float* d, const uint32_t* a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64 fp32) += A (64 x 16) . B (16 x 64), A bf16 in registers,
// B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t* a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128 fp32) += A (64 x 16) . B (16 x 128), A bf16 in registers,
// B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs128(float* d, const uint32_t* a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (N == 64)
    wgmma_ss64(d, a, b, scale_d);
  else
    wgmma_ss128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 32)
    wgmma_rs32(d, a, b);
  else if constexpr (N == 64)
    wgmma_rs64(d, a, b);
  else
    wgmma_rs128(d, a, b);
}

// A row of hd bf16 is stored as column blocks of SW bytes (the swizzle
// span: 128, or 64 for hd 32), each block's rows SW bytes apart, its 16-byte
// chunks XOR-swizzled by the row (the layout TMA writes and wgmma reads)
template <int HD>
struct Swz {
  static constexpr int SW = HD >= 64 ? 128 : 64;
  static constexpr int CW = SW / 2;        // elements per column block
  static constexpr int CB = HD / CW;       // column blocks
  static constexpr uint64_t MODE = SW == 128 ? 1 : 2;
  // byte offset of 16-byte chunk c of row r in a tile of ``rows`` rows
  __device__ __forceinline__ static uint32_t at(int r, int c, int rows) {
    const int x = SW == 128 ? (r & 7) : ((r >> 1) & 3);
    return (c / (SW / 16)) * rows * SW + r * SW + (((c % (SW / 16)) ^ x) << 4);
  }
};

template <int HD, int BN, int NWG>
struct Plan {
  static constexpr int BM = 64 * NWG;
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;  // one K or V tile
  static constexpr int THREADS = 128 * NWG + 32;
  // bytes of a block with st stages (+ 1024 for the alignment), and the
  // blocks an SM holds (228 KB, 1 KB of it reserved a block)
  static constexpr int smem(int st) {
    return Q_BYTES + st * 2 * KV_BYTES + 2 * st * 8 + 1024;
  }
  static constexpr int per_sm(int st) { return 233472 / (smem(st) + 1024); }
  // two stages, or three where they fit without costing a block an SM
  static constexpr int STAGES =
      smem(3) <= 232448 && per_sm(3) >= per_sm(2) ? 3 : 2;
  static constexpr int BAR = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = smem(STAGES);
};

template <int HD, int BN, int NWG>
__global__ void __launch_bounds__(Plan<HD, BN, NWG>::THREADS, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __nv_bfloat16* __restrict__ q,
                      __nv_bfloat16* __restrict__ o, int T_, int S, int H,
                      int KV, int causal, float sl2) {
  using P = Plan<HD, BN, NWG>;
  using L = Swz<HD>;
  constexpr int BM = P::BM, ST = P::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the swizzle is a function of the address bits
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, bar = base + P::BAR;
  // stage s: K at kv(s), V at kv(s) + KV_BYTES; full(s), empty(s) barriers
  auto kv = [&](int s) { return base + P::Q_BYTES + s * 2 * P::KV_BYTES; };
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (ST + s); };

  // one block per (row tile, KV head, batch), the row tiles last first
  // over the whole grid, so the longest causal blocks start first
  const int G = H / KV, rows = T_ * G;
  const int tiles = (rows + BM - 1) / BM, hb = gridDim.x / tiles;  // KV B
  const int r0 = (tiles - 1 - (int)blockIdx.x / hb) * BM;
  const int kvh = blockIdx.x % KV, b = blockIdx.x % hb / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int last = (min(r0 + BM, rows) - 1) / G;
  const int send = causal ? min(S, last + 1) : S;
  const int ntiles = (send + BN - 1) / BN;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised

  if (warp == 4 * NWG) {  // the producer warp
    if (lane == 0) {
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(empty(s), ((j / ST) - 1) & 1);
        mbar_expect_tx(full(s), 2 * P::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < L::CB; ++cb) {
          tma_load(kv(s) + cb * BN * L::SW, &tk, full(s), cb * L::CW, kvh,
                   j * BN, b);
          tma_load(kv(s) + P::KV_BYTES + cb * BN * L::SW, &tv, full(s),
                   cb * L::CW, kvh, j * BN, b);
        }
      }
    }
    return;
  }

  // the block's rows of q (rows past the end: zeros) into shared memory,
  // swizzled, while the producer's first tiles are in flight: every load
  // is issued before the first store (the warp barrier keeps ptxas from
  // sinking them), then the consumers meet at a named barrier
  {
    constexpr int CH = BM * (HD / 8), PER = (CH + 128 * NWG - 1) / (128 * NWG);
    uint4 val[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * 128 * NWG, r = e / (HD / 8), c = e % (HD / 8);
      const int R = r0 + r;
      val[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e < CH && R < rows)
        val[i] = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * T_ + R / G) * H + kvh * G + R % G) * HD + c * 8);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * 128 * NWG;
      if (e < CH)
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         sq + L::at(e / (HD / 8), e % (HD / 8), BM)),
                     "r"(val[i].x), "r"(val[i].y), "r"(val[i].z),
                     "r"(val[i].w)
                     : "memory");
    }
    // the generic-proxy writes of q become visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NWG) : "memory");
  }

  // a consumer thread holds rows rl and rl + 8 of its warpgroup's 64, and
  // columns 8 j + 2 (lane % 4) + {0, 1} of every 8-column group
  const int wg = warp >> 2, qd = lane & 3;
  const int rl = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int t0 = (r0 + rl) / G, t1 = (r0 + rl + 8) / G;
  const int tmin = r0 / G;
  const uint32_t qa = sq + wg * 64 * L::SW;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % ST;
    const uint32_t sk = kv(s), sv = sk + P::KV_BYTES;
    mbar_wait(full(s), (j / ST) & 1);

    // scores: q (64 x hd) . K (BN x hd)^T, hd / 16 steps of 16
    float sc[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int cb = kk * 32 / L::SW, off = (kk * 32) % L::SW;
      wgmma_ss<BN>(sc,
                   mdesc(qa + cb * BM * L::SW + off, 16, 8 * L::SW, L::MODE),
                   mdesc(sk + cb * BN * L::SW + off, 16, 8 * L::SW, L::MODE),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs<BN / 2>(sc);

    // mask only a tile that crosses S or the diagonal
    const int s0 = j * BN;
    if (s0 + BN > S || (causal && s0 + BN - 1 > tmin)) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int sp = s0 + 8 * c + 2 * qd + e;
          if (sp >= S || (causal && sp > t0)) sc[4 * c + e] = -CUDART_INF_F;
          if (sp >= S || (causal && sp > t1))
            sc[4 * c + 2 + e] = -CUDART_INF_F;
        }
    }
    float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      x0 = fmaxf(x0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      x1 = fmaxf(x1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(repro::kFull, x0, w));
      x1 = fmaxf(x1, __shfl_xor_sync(repro::kFull, x1, w));
    }
    // m in units of log2: p = 2^(s sl2 - m), sl2 = hd^-0.5 log2(e)
    const float n0 = fmaxf(m0, x0 * sl2), n1 = fmaxf(m1, x1 * sl2);
    const float a0 = fast_exp2(m0 - n0), a1 = fast_exp2(m1 - n1);
    m0 = n0;
    m1 = n1;

    // p in bf16, laid out as the A fragments of the second product:
    // k-step kk takes columns 16 kk.. (c = 2 kk) and 16 kk + 8.. (c = 2 kk
    // + 1) as registers {row rl, row rl + 8} of each
    uint32_t pa[BN / 4];
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const __nv_bfloat162 u = __floats2bfloat162_rn(
          fast_exp2(fmaf(sc[4 * c], sl2, -n0)),
          fast_exp2(fmaf(sc[4 * c + 1], sl2, -n0)));
      const __nv_bfloat162 w = __floats2bfloat162_rn(
          fast_exp2(fmaf(sc[4 * c + 2], sl2, -n1)),
          fast_exp2(fmaf(sc[4 * c + 3], sl2, -n1)));
      y0 += __low2float(u) + __high2float(u);
      y1 += __low2float(w) + __high2float(w);
      pa[2 * c] = *reinterpret_cast<const uint32_t*>(&u);
      pa[2 * c + 1] = *reinterpret_cast<const uint32_t*>(&w);
    }
    l0 = l0 * a0 + y0;
    l1 = l1 * a1 + y1;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      acc[4 * c] *= a0;
      acc[4 * c + 1] *= a0;
      acc[4 * c + 2] *= a1;
      acc[4 * c + 3] *= a1;
    }

    // acc += p (64 x BN) . V (BN x hd), BN / 16 steps of 16 positions
    fence_regs<HD / 2>(acc);
    fence_regs<BN / 4>(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<HD>(acc, pa + 4 * kk,
                   mdesc(sv + kk * 16 * L::SW, BN * L::SW, 8 * L::SW,
                         L::MODE));
    wgmma_commit();
    wgmma_wait();
    fence_regs<HD / 2>(acc);
    mbar_arrive(empty(s));
  }

  // each row's sum over its quad, then acc / l as bf16
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(repro::kFull, l0, w);
    l1 += __shfl_xor_sync(repro::kFull, l1, w);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = r0 + rl + 8 * h;
    if (R >= rows) continue;
    const int t = R / G, g = R % G;
    const float inv = 1.f / fmaxf(h ? l1 : l0, 1e-30f);
    __nv_bfloat16* dst =
        o + (((size_t)b * T_ + t) * H + kvh * G + g) * HD + 2 * qd;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c) = __floats2bfloat162_rn(
          acc[4 * c + 2 * h] * inv, acc[4 * c + 2 * h + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, a cu* entry point reached through the runtime
// (cudaGetDriverEntryPoint), so the libraries need no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    if (e == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of k or v (B, S, KV, hd) bf16: boxes of CW elements of hd
// x 1 head x BN positions x 1 batch, swizzled as Swz<hd>
template <int HD, int BN>
bool kv_map(CUtensorMap* map, const void* p, int B, int S, int KV) {
  using L = Swz<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)KV, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)KV * HD * 2,
                                 (cuuint64_t)S * KV * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::CW, 1, (cuuint32_t)BN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int BN, int NWG>
cudaError_t launch_bf16_t(const void* q, const void* k, const void* v,
                          void* o, int B, int T_, int S, int H, int KV,
                          int causal, float scale, cudaStream_t stream) {
  using P = Plan<HD, BN, NWG>;
  static bool sized = false;  // the shared-memory limit, set once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<HD, BN, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  CUtensorMap tk, tv;
  if (!kv_map<HD, BN>(&tk, k, B, S, KV) || !kv_map<HD, BN>(&tv, v, B, S, KV))
    return cudaErrorInvalidValue;
  const long long blocks =
      (long long)((T_ * (H / KV) + P::BM - 1) / P::BM) * KV * B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  flash_bf16_kernel<HD, BN, NWG><<<grid, P::THREADS, P::SMEM, stream>>>(
      tk, tv, (const __nv_bfloat16*)q, (__nv_bfloat16*)o, T_, S, H, KV,
      causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16_hd(const void* q, const void* k, const void* v,
                           void* o, int B, int T_, int S, int H, int KV,
                           int causal, int unroll, int block_k, float scale,
                           cudaStream_t stream) {
  if (unroll == 1 && block_k == 256)
    return launch_bf16_t<HD, 64, 1>(q, k, v, o, B, T_, S, H, KV, causal,
                                    scale, stream);
  if (unroll == 1 && block_k == 512)
    return launch_bf16_t<HD, 128, 1>(q, k, v, o, B, T_, S, H, KV, causal,
                                     scale, stream);
  if (unroll == 2 && block_k == 256)
    return launch_bf16_t<HD, 64, 2>(q, k, v, o, B, T_, S, H, KV, causal,
                                    scale, stream);
  if (unroll == 2 && block_k == 512)
    return launch_bf16_t<HD, 128, 2>(q, k, v, o, B, T_, S, H, KV, causal,
                                     scale, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int T_, int S, int H, int KV, int hd,
                        int causal, int unroll, int block_k, float scale,
                        void* stream) {
  if (B < 1 || T_ < 1 || S < 1 || KV < 1 || H < KV || H % KV != 0 ||
      B > 65535 || KV > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_bf16_hd<32>(q, k, v, o, B, T_, S, H, KV, causal, unroll,
                                block_k, scale, s);
    case 64:
      return launch_bf16_hd<64>(q, k, v, o, B, T_, S, H, KV, causal, unroll,
                                block_k, scale, s);
    case 128:
      return launch_bf16_hd<128>(q, k, v, o, B, T_, S, H, KV, causal, unroll,
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
  return launch_f32(q, k, v, o, B, T, S, H, KV, hd, causal, unroll, block_k,
                    scale, stream);
}

extern "C" cudaError_t repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int T,
    int S, int H, int KV, int hd, int causal, int unroll, int block_k,
    float scale, void* stream) {
  return launch_bf16(q, k, v, o, B, T, S, H, KV, hd, causal, unroll, block_k,
                     scale, stream);
}
