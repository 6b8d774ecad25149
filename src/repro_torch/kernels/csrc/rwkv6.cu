// WKV6: the RWKV-6 recurrence from a carried-in state,
//   y_t = r_t S_{t-1} + (r_t . (u k_t)) v_t,
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t,
// r, k, v, w (B,T,H,hd) all fp32 or all bf16, u (H,hd) and the state
// (B,H,hd,hd) fp32; y (B,T,H,hd) and the final state fp32.
//
// Replaces: src/repro/kernels/rwkv6.py `wkv6` (the chunked linear-attention
//   form: a grid of (batch x head, chunk of block_n / 8 steps), the hd x hd
//   fp32 state in VMEM scratch across the chunks, and per chunk an
//   inter-chunk, an intra-chunk and a state-update product whose
//   exponentials all take arguments <= 0).  The Pallas kernel zeroes its
//   state at the first chunk; this one starts from state0 (zeros give the
//   Pallas function).
// Bound on the H100: bytes, by the registry's count (r, k, v, w read once,
//   y and the state written once: 105.5 MB, 31.5 us, against 2.01 GFLOP,
//   30.0 us at the fp32 rate, at B = 1, T = 2048, H = 40, hd = 64, fp32).
//   The recurrence is serial in T, so what limits this kernel is how many
//   SMs walk it at once and how fast one SM walks a chunk.
// Design: column j of S, and so y[:, j], depends only on column j of S and
//   on v[:, j]; the decays and the pair scores are shared by every column.
//   So a (batch, head) takes hd / CB blocks, each owning CB columns of S
//   (`wkv6_plan` in kernels/rwkv6.py picks CB: the narrowest slice whose
//   blocks all run in one wave, a block holding an SM; 32 at rwkv6-3b, 80
//   blocks), its hd x CB slice of S in shared memory for the whole
//   sequence (transposed, two buffers), written once at the end.  Every
//   block forms the shared terms of its head itself.  T is walked in
//   chunks of L = block_n / 8 steps (8, 16 or 32, the tuner's knob as in
//   JAX), staged by cp.async two chunks ahead where shared memory allows
//   (rows past T as r = k = v = 0, w = 1, which change nothing).  A block
//   is two groups of 8 warps: while the producers form chunk c's terms
//   into the buffers of c's parity, the consumers take chunk c - 1's
//   outputs and state update from the other buffers; one barrier a chunk
//   hands them over.  The producers, per chunk:
//   1. per (channel, sub-chunk of 4 steps): lw = log(max(w, 1e-30)) (the
//      JAX floor), in log2 units, its inclusive sums lcm inside the
//      sub-chunk and their total; the sums at the sub-chunk boundaries
//      Cb_0 = 0 .. Cb_{L/4} = cm_L;
//   2. per (step, channel), with t in sub-chunk q:
//        rq = r exp(cx - Cb_q),  kq = k exp(Cb_{q+1} - cm),
//      and per (sub-chunk, channel) ec = exp(Cb_q), et = exp(cm_L -
//      Cb_{q+1}), so that rd = rq ec = r exp(cx) and kd = kq et = k
//      exp(cm_L - cm); v transposed;
//   3. the pair scores within each sub-chunk, directly,
//        A[t][s] = sum_i r[t,i] k[s,i] exp(cx[t,i] - cm[s,i]),  s < t,
//      and the bonus A[t][t] = sum_i r[t,i] u[i] k[t,i].
//   The consumers, per chunk:
//   3b. the pair scores across sub-chunks p < q, factored at the boundary
//      b_q of t's sub-chunk: A[t][s] = sum_i (rq[t,i] D_qp[i]) kq[s,i],
//      D_qp = exp(Cb_q - Cb_{p+1}) the decay between the sub-chunks (1 for
//      neighbours): a product of terms formed once per (step, channel),
//      so the exponentials of a chunk grow with L hd, not L^2 hd / 2;
//   4. y[t, j] = rd[t] . S[:, j] + sum_{s <= t} A[t][s] v[s, j];
//   5. S[:, j] <- exp(cm_L) S[:, j] + kd^T v[:, j], into the other buffer.
//   The pair scores are 4 x 4 register tiles over shared memory, each sum
//   split over a few lanes and summed by repro::transpose_reduce; 4 and 5
//   run on the tensor cores as 3xTF32 (each fp32 operand split into two
//   tf32 parts, three mma.sync products: fp32 to ~2^-21, the 2.8e-4 gate
//   held as by fp32 SIMT; plain TF32 keeps too few digits for states of
//   order 1 to 10; faster than fp32 SIMT products at rwkv6-3b's default
//   chunks of 32, PERF.md row 15).  Every exponent is <= 0 before the exp
//   (the sums only fall), as in the JAX kernel: the separable exp(+cm)
//   form overflows in fp32.  The exponentials are ex2.approx of
//   log2-scaled sums; the logarithm is the accurate logf.  Rows in shared
//   memory are padded by 16 bytes, so threads on distinct rows hit
//   distinct banks.  hd is 32, 64 or 128, CB 8, 16 or 32 (at most hd,
//   within the 227 KB of shared memory).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;          // two groups of 8 warps
constexpr int kGroup = kThreads / 2;
constexpr int kSub = 4;                 // steps a sub-chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared; zero-filled where !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// x = hi + lo in two tf32 values: hi is x rounded to its top 19 bits
// (half up in magnitude), lo = x - hi exactly (the tensor cores read its
// top 19 bits), so three tf32 products (hi hi + hi lo + lo hi) give a
// product to ~2^-21; integer ops on the FMA pipe, where cvt.rna.tf32 would
// queue on the special-function units.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8 fp32) += a (16 x 8 tf32, row-major) . b (8 x 8 tf32)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc (16 x 8) += a . b in 3xTF32 for one k-step of 8: a0 .. a3 and b0, b1
// in the mma fragments' places (rows gid, gid + 8; columns tig, tig + 4 of
// a; rows tig, tig + 4 of b).  The three products go to a partial from 0
// that is then added with round-to-nearest, so the tensor cores' own
// rounding of their sums never compounds across k-steps.
__device__ __forceinline__ void mma3_step(float* acc, const float* a,
                                          const float* b) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int x = 0; x < 4; ++x) split_tf32(a[x], ah[x], al[x]);
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, al, bh);
  mma_tf32(part, ah, bl);
  mma_tf32(part, ah, bh);
#pragma unroll
  for (int x = 0; x < 4; ++x) acc[x] += part[x];
}

// Elements of the staged input chunk (r, k, w, v in their own type).
template <typename T>
struct Raw;

template <>
struct Raw<float> {
  static constexpr int pad = 4;         // elements: 16 bytes
  __device__ __forceinline__ static float at(const float* p) { return *p; }
  __device__ __forceinline__ static float4 four(const float* p) {
    return ld4(p);
  }
};

template <>
struct Raw<__nv_bfloat16> {
  static constexpr int pad = 8;
  __device__ __forceinline__ static float at(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static float4 four(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// Lanes a 4 x 4 tile's sum is split over: the most (a power of two, at
// most 32 and at most the sum's quads) that `tiles` tiles leave room for.
__host__ __device__ constexpr int split_for(int tiles, int quads) {
  int ks = 1;
  while (ks < 32 && ks * 2 * tiles <= kGroup && ks * 2 <= quads) ks *= 2;
  return ks;
}

// The shared-memory layout of one block: two staged chunks of r, k, w, v
// (the next one lands while this one is read), then fp32 rows of pitch P;
// what the producers hand to the consumers (rq, kq and the factors that
// make them rd and kd, A, v transposed, exp(cm_L), the boundary sums) in
// two buffers, by the chunk's parity.
template <typename T, int HD, int L, int CB>
struct Layout {
  static constexpr int P = HD + 4;                 // fp32 row
  static constexpr int RP = HD + Raw<T>::pad;      // staged row (elements)
  static constexpr int NSUB = L / kSub;
  static constexpr int AP = L + 4;                 // row of A, of vT
  // a staged chunk: r, k, w (3 x L x RP), then v (L x CB); two of them
  // where they fit beside the fp32 rows, else one
  static constexpr int STAGE = 3 * L * RP + L * CB;
  static constexpr size_t F32 =
      4 * (5 * (size_t)L * P + 2 * L * AP + 2 * CB * AP + 2 * HD +
           4 * NSUB * HD + 2 * CB * P + 2 * (NSUB + 1) * HD + NSUB * HD +
           HD);
  static constexpr int STAGES =
      2 * (size_t)STAGE * sizeof(T) + F32 <= 227 * 1024 ? 2 : 1;
  static constexpr size_t f32 = STAGES * (size_t)STAGE * sizeof(T);
  // fp32 offsets (floats) from f32; a "2 x" array is one buffer a parity
  static constexpr int rq = 0,                     // 2 x L x P
                       kq = rq + 2 * L * P,         // 2 x L x P
                       lcm = kq + 2 * L * P,
                       A = lcm + L * P,             // 2 x L x AP
                       vT = A + 2 * L * AP,         // 2 x CB x AP
                       el = vT + 2 * CB * AP,       // 2 x HD
                       ec = el + 2 * HD,            // 2 x NSUB x HD
                       et = ec + 2 * NSUB * HD,     // 2 x NSUB x HD
                       St = et + 2 * NSUB * HD,     // 2 x CB x P
                       Cb = St + 2 * CB * P,       // 2 x (NSUB + 1) x HD
                       tot = Cb + 2 * (NSUB + 1) * HD,
                       us = tot + NSUB * HD, end = us + HD;
  static_assert(end * sizeof(float) == F32, "the fp32 rows' size");
  static constexpr size_t bytes = f32 + F32;
};

template <typename T, int HD, int L, int CB>
__global__ void __launch_bounds__(kThreads, 1)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ sout, int T_,
                int H) {
  using Lay = Layout<T, HD, L, CB>;
  constexpr int P = Lay::P, RP = Lay::RP, NSUB = Lay::NSUB, AP = Lay::AP;
  constexpr int EV = 16 / sizeof(T);               // elements a 16-byte copy
  constexpr int NIT = (HD * NSUB + kGroup - 1) / kGroup;
  // the pair scores: 4 x 4 tiles, each sum split over KS lanes
  constexpr int NTX = NSUB * (NSUB - 1) / 2;       // sub-chunk pairs p < q
  constexpr int KSX = split_for(NTX, HD / 4);
  constexpr int KSI = split_for(NSUB, HD / 4);     // the sub-chunks' own
  constexpr int MTY = (L + 15) / 16;               // y: 16-row tiles of t
  constexpr int MTS = (CB + 15) / 16;              // S^T: 16-row tiles of j
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* const stage = reinterpret_cast<T*>(base);
  float* F = reinterpret_cast<float*>(base + Lay::f32);
  float* lcm = F + Lay::lcm;
  float* St = F + Lay::St;
  float* tot = F + Lay::tot;
  float* us = F + Lay::us;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * CB, tid = threadIdx.x;
  const bool producer = tid < kGroup;
  const int gt = tid % kGroup;                     // thread in its group
  const size_t sbase = (size_t)bh * HD * HD;
  const int nchunks = (T_ + L - 1) / L;

  // the chunk at t0 into staged buffer `sb` (the producers)
  auto issue = [&](int t0, int sb) {
    const int n = min(L, T_ - t0);
    T* rs = stage + sb * Lay::STAGE;
    constexpr int CPR = HD / EV;
    for (int e = gt; e < 3 * L * CPR; e += kGroup) {
      const int m = e / (L * CPR), t = (e / CPR) % L, c = e % CPR;
      const T* src = m == 0 ? r : (m == 1 ? k : w);
      const bool ok = t < n;
      const size_t off =
          (((size_t)b * T_ + t0 + (ok ? t : 0)) * H + h) * HD + c * EV;
      cp_async16(rs + (m * L + t) * RP + c * EV, src + off, ok);
    }
    constexpr int CPV = CB / EV;
    for (int e = gt; e < L * CPV; e += kGroup) {
      const int t = e / CPV, c = e % CPV;
      const bool ok = t < n;
      const size_t off = (((size_t)b * T_ + t0 + (ok ? t : 0)) * H + h) *
                             HD + j0 + c * EV;
      cp_async16(rs + 3 * L * RP + t * CB + c * EV, v + off, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto producers_sync = [] {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kGroup) : "memory");
  };
  auto consumers_sync = [] {
    asm volatile("bar.sync 2, %0;\n" ::"n"(kGroup) : "memory");
  };

  constexpr int STAGES = Lay::STAGES;
  if (producer) {
    issue(0, 0);
    if (STAGES == 2 && nchunks > 1) issue(L, 1);
  }
  for (int e = tid; e < HD * CB; e += kThreads) {
    const int i = e / CB, j = e % CB;
    St[j * P + i] = s0[sbase + (size_t)i * HD + j0 + j];
  }
  for (int e = tid; e < 2 * L * AP; e += kThreads)
    F[Lay::A + e] = 0.f;                           // s > t stays 0
  if (tid < HD) us[tid] = u[h * HD + tid];
  __syncthreads();

  // Iteration it: the producers (warps 0-7) form chunk it's decays, rows
  // and pair scores into the buffers of its parity while the consumers
  // (warps 8-15) take chunk it - 1's y and state update from the others.
  for (int it = 0; it <= nchunks; ++it) {
    if (producer && it < nchunks) {
      const int t0 = it * L, n = min(L, T_ - t0), buf = it & 1;
      float* rq = F + Lay::rq + buf * L * P;
      float* kq = F + Lay::kq + buf * L * P;
      float* ec = F + Lay::ec + buf * NSUB * HD;
      float* et = F + Lay::et + buf * NSUB * HD;
      float* Cb = F + Lay::Cb + buf * (NSUB + 1) * HD;
      float* A = F + Lay::A + buf * L * AP;
      float* vT = F + Lay::vT + buf * CB * AP;
      float* el = F + Lay::el + buf * HD;
      const T* rr = stage + (STAGES == 2 ? buf : 0) * Lay::STAGE;
      const T* kr = rr + L * RP;
      const T* wr = kr + L * RP;
      const T* vb = wr + L * RP;
      if (STAGES == 2 && it + 1 < nchunks)   // chunk it + 1 may be in flight
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      producers_sync();

      // 1. log2 decays: inclusive sums inside each sub-chunk, its total
      float lc[NIT][kSub];
#pragma unroll
      for (int m = 0; m < NIT; ++m) {
        const int item = gt + m * kGroup;
        if (item < HD * NSUB) {
          const int i = item % HD, q = item / HD;
          float cum = 0.f;
#pragma unroll
          for (int s = 0; s < kSub; ++s) {
            const int t = q * kSub + s;
            const float wv = t < n ? Raw<T>::at(wr + t * RP + i) : 1.f;
            cum += logf(fmaxf(wv, 1e-30f)) * kLog2e;
            lc[m][s] = cum;
          }
          tot[q * HD + i] = cum;
        }
      }
      producers_sync();

      // 2. the factored rows, the decays between sub-chunks, v transposed
#pragma unroll
      for (int m = 0; m < NIT; ++m) {
        const int item = gt + m * kGroup;
        if (item < HD * NSUB) {
          const int i = item % HD, q = item / HD;
          float cbs[NSUB + 1];                        // Cb_0 .. Cb_NSUB
          cbs[0] = 0.f;
#pragma unroll
          for (int p = 0; p < NSUB; ++p)
            cbs[p + 1] = cbs[p] + tot[p * HD + i];
          float cbq = 0.f, cbq1 = 0.f;
#pragma unroll
          for (int p = 0; p < NSUB; ++p)
            if (p == q) cbq = cbs[p], cbq1 = cbs[p + 1];
          Cb[q * HD + i] = cbq;
          if (q == NSUB - 1) Cb[NSUB * HD + i] = cbq1;
          const float run = cbs[NSUB];
          ec[q * HD + i] = ex2(cbq);                  // rd = rq ec
          et[q * HD + i] = ex2(run - cbq1);           // kd = kq et
          const float tq = lc[m][kSub - 1];
#pragma unroll
          for (int s = 0; s < kSub; ++s) {
            const int t = q * kSub + s;
            const float lcx = s ? lc[m][s - 1] : 0.f;
            rq[t * P + i] = Raw<T>::at(rr + t * RP + i) * ex2(lcx);
            kq[t * P + i] =
                Raw<T>::at(kr + t * RP + i) * ex2(tq - lc[m][s]);
            lcm[t * P + i] = lc[m][s];
          }
          if (q == 0) el[i] = ex2(run);
        }
      }
      for (int e = gt; e < L * CB; e += kGroup)
        vT[(e % CB) * AP + e / CB] = Raw<T>::at(vb + e);
      producers_sync();

      // 3. the pair scores within each sub-chunk (the direct form and the
      //    bonus), a 4 x 4 tile each; across them the consumers
      if (gt - gt % 32 < NSUB * KSI) {
        const bool live = gt < NSUB * KSI;
        const int ks = gt % KSI, q = live ? gt / KSI : 0;
        float acc[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) acc[m] = 0.f;
#pragma unroll
        for (int x4 = 0; x4 < HD / 4 / KSI; ++x4) {
          if (!live) break;
          const int i = 4 * (ks + x4 * KSI);
          float4 ra[4], ka[4], ls[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            ra[x] = Raw<T>::four(rr + (4 * q + x) * RP + i);
            ka[x] = Raw<T>::four(kr + (4 * q + x) * RP + i);
            ls[x] = ld4(lcm + (4 * q + x) * P + i);
          }
          const float4 uu = ld4(us + i);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            acc[x * 5] = dot4(mul4(ra[x], uu), ka[x], acc[x * 5]);
#pragma unroll
            for (int z = 0; z < x; ++z) {              // cx[t] = cm[t - 1]
              const float4 e = make_float4(
                  ex2(ls[x - 1].x - ls[z].x), ex2(ls[x - 1].y - ls[z].y),
                  ex2(ls[x - 1].z - ls[z].z), ex2(ls[x - 1].w - ls[z].w));
              acc[x * 4 + z] = dot4(mul4(ra[x], ka[z]), e, acc[x * 4 + z]);
            }
          }
        }
        const int first = repro::transpose_reduce<16, KSI>(acc, ks);
        if (live && repro::reduce_writer<16, KSI>(ks)) {
#pragma unroll
          for (int m = 0; m < (16 / KSI > 0 ? 16 / KSI : 1); ++m) {
            const int e = first + m;
            A[(4 * q + e / 4) * AP + 4 * q + e % 4] = acc[m];
          }
        }
      }
      producers_sync();          // r, k, w, v read for the last time above
      if (STAGES == 2 && it + 2 < nchunks) issue(t0 + 2 * L, buf);
      if (STAGES == 1 && it + 1 < nchunks) issue(t0 + L, 0);
    } else if (!producer && it > 0) {
      const int c = it - 1, t0 = c * L, n = min(L, T_ - t0), buf = c & 1;
      const float* rq = F + Lay::rq + buf * L * P;
      const float* kq = F + Lay::kq + buf * L * P;
      const float* ec = F + Lay::ec + buf * NSUB * HD;
      const float* et = F + Lay::et + buf * NSUB * HD;
      const float* Cb = F + Lay::Cb + buf * (NSUB + 1) * HD;
      float* A = F + Lay::A + buf * L * AP;
      const float* vT = F + Lay::vT + buf * CB * AP;
      const float* el = F + Lay::el + buf * HD;
      const float* Sc = St + (c & 1) * CB * P;
      float* Sn = St + ((c + 1) & 1) * CB * P;

      // 3b. the pair scores across sub-chunks p < q, a 4 x 4 tile each: the
      //     factored product with D_qp = exp(Cb_q - Cb_{p+1}), into A
      if (gt - gt % 32 < NTX * KSX) {
        const bool live = gt < NTX * KSX;
        const int ks = gt % KSX;
        int q = 1, p = live ? gt / KSX : 0;
        while (p >= q) p -= q++;
        float acc[16];
#pragma unroll
        for (int m = 0; m < 16; ++m) acc[m] = 0.f;
#pragma unroll
        for (int x4 = 0; x4 < HD / 4 / KSX; ++x4) {
          if (!live) break;
          const int i = 4 * (ks + x4 * KSX);
          const float4 cq = ld4(Cb + q * HD + i);
          const float4 cp = ld4(Cb + (p + 1) * HD + i);
          const float4 d = make_float4(ex2(cq.x - cp.x), ex2(cq.y - cp.y),
                                       ex2(cq.z - cp.z), ex2(cq.w - cp.w));
          float4 a[4], kk[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            a[x] = mul4(ld4(rq + (4 * q + x) * P + i), d);
            kk[x] = ld4(kq + (4 * p + x) * P + i);
          }
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int z = 0; z < 4; ++z)
              acc[x * 4 + z] = dot4(a[x], kk[z], acc[x * 4 + z]);
        }
        const int first = repro::transpose_reduce<16, KSX>(acc, ks);
        if (live && repro::reduce_writer<16, KSX>(ks)) {
#pragma unroll
          for (int m = 0; m < (16 / KSX > 0 ? 16 / KSX : 1); ++m) {
            const int e = first + m;
            A[(4 * q + e / 4) * AP + 4 * p + e % 4] = acc[m];
          }
        }
      }
      consumers_sync();
      // 4. y[t][j] = rd[t] . S[:, j] + A[t] . v[:, j] on the tensor cores
      //    (3xTF32), a 16 x 8 tile of (t, j) a warp
      const int wc = gt / 32, lane = gt % 32, gid = lane / 4, tig = lane % 4;
      if (wc < MTY * (CB / 8)) {
        const int ra = 16 * (wc / (CB / 8)) + gid, rb = ra + 8;
        const int jn = 8 * (wc % (CB / 8)) + gid;     // the B column
        const bool r1 = rb < L;                       // L = 8: rows 8 .. 15
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const float* ea = ec + (ra / kSub) * HD;      // rd = rq ec
        const float* eb = ec + (r1 ? rb / kSub : 0) * HD;
#pragma unroll 4
        for (int k8 = 0; k8 < HD; k8 += 8) {
          const int k = k8 + tig;
          const float a[4] = {rq[ra * P + k] * ea[k],
                              r1 ? rq[rb * P + k] * eb[k] : 0.f,
                              rq[ra * P + k + 4] * ea[k + 4],
                              r1 ? rq[rb * P + k + 4] * eb[k + 4] : 0.f};
          const float bb[2] = {Sc[jn * P + k], Sc[jn * P + k + 4]};
          mma3_step(acc, a, bb);
        }
#pragma unroll
        for (int k8 = 0; k8 < L; k8 += 8) {
          const float a[4] = {A[ra * AP + k8 + tig],
                              r1 ? A[rb * AP + k8 + tig] : 0.f,
                              A[ra * AP + k8 + tig + 4],
                              r1 ? A[rb * AP + k8 + tig + 4] : 0.f};
          const float bb[2] = {vT[jn * AP + k8 + tig],
                               vT[jn * AP + k8 + tig + 4]};
          mma3_step(acc, a, bb);
        }
        const int j = 8 * (wc % (CB / 8)) + 2 * tig;
        if (ra < n)
          *reinterpret_cast<float2*>(
              y + (((size_t)b * T_ + t0 + ra) * H + h) * HD + j0 + j) =
              make_float2(acc[0], acc[1]);
        if (r1 && rb < n)
          *reinterpret_cast<float2*>(
              y + (((size_t)b * T_ + t0 + rb) * H + h) * HD + j0 + j) =
              make_float2(acc[2], acc[3]);
      }

      // 5. S[:, j] <- exp(cm_L) S[:, j] + kd^T v[:, j] on the tensor cores:
      //    S^T (j, i) = v^T (j, s) . kd (s, i), 16 x 8 tiles, into the
      //    other buffer
      for (int tile = wc; tile < MTS * (HD / 8); tile += kGroup / 32) {
        const int jr0 = 16 * (tile / (HD / 8)) + gid, jr1 = jr0 + 8;
        const int in = 8 * (tile % (HD / 8)) + gid;   // the B column
        const bool r1 = jr1 < CB;                     // CB = 8: rows 8 ..
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k8 = 0; k8 < L; k8 += 8) {
          const float a[4] = {vT[jr0 * AP + k8 + tig],
                              r1 ? vT[jr1 * AP + k8 + tig] : 0.f,
                              vT[jr0 * AP + k8 + tig + 4],
                              r1 ? vT[jr1 * AP + k8 + tig + 4] : 0.f};
          const int sa = k8 + tig, sb = sa + 4;       // kd = kq et
          const float bb[2] = {kq[sa * P + in] * et[(sa / kSub) * HD + in],
                               kq[sb * P + in] * et[(sb / kSub) * HD + in]};
          mma3_step(acc, a, bb);
        }
        const int i = 8 * (tile % (HD / 8)) + 2 * tig;
        Sn[jr0 * P + i] = fmaf(el[i], Sc[jr0 * P + i], acc[0]);
        Sn[jr0 * P + i + 1] = fmaf(el[i + 1], Sc[jr0 * P + i + 1], acc[1]);
        if (r1) {
          Sn[jr1 * P + i] = fmaf(el[i], Sc[jr1 * P + i], acc[2]);
          Sn[jr1 * P + i + 1] =
              fmaf(el[i + 1], Sc[jr1 * P + i + 1], acc[3]);
        }
      }
    }
    __syncthreads();             // chunk it handed over, chunk it - 1 done
  }
  const float* Sf = St + (nchunks & 1) * CB * P;
  for (int e = tid; e < HD * CB; e += kThreads) {
    const int i = e / CB, j = e % CB;
    sout[sbase + (size_t)i * HD + j0 + j] = Sf[j * P + i];
  }
}

template <typename T, int HD, int L, int CB>
cudaError_t launch_t(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* y,
                     void* sout, int B, int T_, int H, cudaStream_t stream) {
  const size_t smem = Layout<T, HD, L, CB>::bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T, HD, L, CB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B * H, HD / CB);
  wkv6_kernel<T, HD, L, CB><<<grid, kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (float*)y, (float*)sout, T_, H);
  return cudaGetLastError();
}

// The kernel instantiated for (hd, chunk, cols), launched
// (cudaErrorInvalidValue where there is none).
template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* sout, int B, int T_, int H, int hd, int chunk,
                   int cols, void* stream) {
  if (B < 1 || T_ < 1 || H < 1 || cols > hd) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define REPRO_WKV6_L(HD, CB)                                              \
  switch (chunk) {                                                        \
    case 8:                                                               \
      return launch_t<T, HD, 8, CB>(r, k, v, w, u, s0, y, sout, B, T_, H, \
                                    st);                                  \
    case 16:                                                              \
      return launch_t<T, HD, 16, CB>(r, k, v, w, u, s0, y, sout, B, T_,   \
                                     H, st);                              \
    case 32:                                                              \
      return launch_t<T, HD, 32, CB>(r, k, v, w, u, s0, y, sout, B, T_,   \
                                     H, st);                              \
    default:                                                              \
      return cudaErrorInvalidValue;                                       \
  }
#define REPRO_WKV6_CB(HD)                                                 \
  switch (cols) {                                                         \
    case 8:                                                               \
      REPRO_WKV6_L(HD, 8)                                                 \
    case 16:                                                              \
      REPRO_WKV6_L(HD, 16)                                                \
    case 32:                                                              \
      REPRO_WKV6_L(HD, 32)                                                \
    default:                                                              \
      return cudaErrorInvalidValue;                                       \
  }
  switch (hd) {
    case 32:
      REPRO_WKV6_CB(32)
    case 64:
      REPRO_WKV6_CB(64)
    case 128:
      REPRO_WKV6_CB(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_WKV6_CB
#undef REPRO_WKV6_L
}

}  // namespace

// r, k, v, w (B,T,H,hd) contiguous, 16-byte aligned, all fp32 or all bf16;
// u (H,hd), state0 and state_out (B,H,hd,hd), y (B,T,H,hd) fp32; hd 32,
// 64 or 128; chunk 8, 16 or 32 steps; cols 8, 16 or 32 columns of the
// state a block (at most hd).
extern "C" cudaError_t repro_wkv6_f32(const void* r, const void* k,
                                      const void* v, const void* w,
                                      const void* u, const void* s0, void* y,
                                      void* sout, int B, int T, int H, int hd,
                                      int chunk, int cols, void* stream) {
  return launch<float>(r, k, v, w, u, s0, y, sout, B, T, H, hd, chunk, cols,
                       stream);
}

extern "C" cudaError_t repro_wkv6_bf16(const void* r, const void* k,
                                       const void* v, const void* w,
                                       const void* u, const void* s0,
                                       void* y, void* sout, int B, int T,
                                       int H, int hd, int chunk, int cols,
                                       void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, B, T, H, hd,
                               chunk, cols, stream);
}

