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
//   The recurrence is serial in T, so what limits
//   this kernel is the B H blocks it can run (40 there: fewer than the
//   132 SMs) and the chunk's shared-memory traffic, not the device memory.
// Design: one block of 256 threads per (batch, head); the state S lives in
//   shared memory for the whole sequence (the shadow-buffer intent (C)) and
//   is written once, at the end.  Per chunk of L = block_n / 8 steps (8, 16
//   or 32, the tuner's knob as in JAX): r, k, v, w are converted to fp32
//   into shared memory (rows past T as r = k = v = 0, w = 1, which change
//   nothing); one thread a channel forms lw = log(max(w, 1e-30)) (the JAX
//   floor: a w that underflowed gives -69.08 in both packages) and the
//   exclusive and inclusive sums cx, cm over the chunk; then
//     rd = r exp(cx), kd = k exp(cm_L - cm)              (exp of <= 0),
//     A[t][s] = sum_i r[t,i] k[s,i] exp(cx[t,i] - cm[s,i])   for s < t,
//     A[t][t] = sum_i r[t,i] u[i] k[t,i]                 (the bonus),
//     y[t] = rd[t] S + sum_{s <= t} A[t][s] v[s],
//     S <- diag(exp(cm_L)) S + kd^T v.
//   Every exponent is <= 0 before the exp (cx[t] <= cm[s] for s < t: the
//   sums only fall): the separable exp(+cm) form overflows in fp32.  The
//   pairs s <= t are enumerated as a triangle over the block's threads;
//   thread (j, g) of the y and state steps takes column j of S and rows t
//   (or i) = g, g + 256 / hd, ...  Shared rows are padded by one float, so
//   threads on distinct rows hit distinct banks.  Shared memory is
//   hd^2 + 6 L (hd + 1) + L hd + L (L + 1) + 2 hd floats: 79 KB at hd =
//   64, L = 32 (after cudaFuncSetAttribute above 48 KB).  hd is 32, 64 or
//   128.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int HD, int L>
constexpr size_t smem_floats() {
  return (size_t)HD * HD + 6 * (size_t)L * (HD + 1) + (size_t)L * HD +
         (size_t)L * (L + 1) + 2 * HD;
}

template <typename T, int HD, int L>
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ y, float* __restrict__ sout, int T_,
                int H) {
  constexpr int P = HD + 1;              // padded row
  constexpr int NG = kThreads / HD;      // row groups of the y/state steps
  constexpr int NTR = L / NG;            // y rows a thread
  constexpr int V = repro::Vec<T>::n;    // elements per 16-byte load
  constexpr int VPR = HD / V;
  constexpr int NPAIR = L * (L + 1) / 2;
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // HD x HD
  float* rr = S + HD * HD;                     // L x P: r
  float* kk = rr + L * P;                      // k
  float* cx = kk + L * P;                      // exclusive sums of lw
  float* cm = cx + L * P;                      // w, then inclusive sums
  float* rd = cm + L * P;                      // r exp(cx)
  float* kd = rd + L * P;                      // k exp(cm_L - cm)
  float* vv = kd + L * P;                      // L x HD: v
  float* A = vv + L * HD;                      // L x (L + 1)
  float* us = A + L * (L + 1);                 // HD: u of this head
  float* cl = us + HD;                         // HD: cm_L

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, j = tid % HD, g = tid / HD;
  const size_t sbase = (size_t)bh * HD * HD;
  for (int e = tid; e < HD * HD; e += kThreads) S[e] = s0[sbase + e];
  if (tid < HD) us[tid] = u[h * HD + tid];

  for (int t0 = 0; t0 < T_; t0 += L) {
    const int n = min(L, T_ - t0);
    // the chunk in fp32 (rows past T: r = k = v = 0, w = 1)
    for (int e = tid; e < L * VPR; e += kThreads) {
      const int t = e / VPR, d = (e % VPR) * V;
      float fr[V], fk[V], fv[V], fw[V];
      if (t < n) {
        const size_t off = (((size_t)b * T_ + t0 + t) * H + h) * HD + d;
        repro::Vec<T>::load(*reinterpret_cast<const uint4*>(r + off), fr);
        repro::Vec<T>::load(*reinterpret_cast<const uint4*>(k + off), fk);
        repro::Vec<T>::load(*reinterpret_cast<const uint4*>(v + off), fv);
        repro::Vec<T>::load(*reinterpret_cast<const uint4*>(w + off), fw);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          fr[q] = fk[q] = fv[q] = 0.f;
          fw[q] = 1.f;
        }
      }
#pragma unroll
      for (int q = 0; q < V; ++q) {
        rr[t * P + d + q] = fr[q];
        kk[t * P + d + q] = fk[q];
        cm[t * P + d + q] = fw[q];
        vv[t * HD + d + q] = fv[q];
      }
    }
    __syncthreads();
    // log-decays and their running sums, one thread a channel
    if (tid < HD) {
      float cum = 0.f;
#pragma unroll 8
      for (int t = 0; t < L; ++t) {
        const float lw = logf(fmaxf(cm[t * P + tid], 1e-30f));
        cx[t * P + tid] = cum;
        cum += lw;
        cm[t * P + tid] = cum;
      }
      cl[tid] = cum;
    }
    __syncthreads();
    for (int e = tid; e < L * HD; e += kThreads) {
      const int t = e / HD, i = e % HD;
      rd[t * P + i] = rr[t * P + i] * expf(cx[t * P + i]);
      kd[t * P + i] = kk[t * P + i] * expf(cl[i] - cm[t * P + i]);
    }
    // the pairs s <= t: pair p is (t, p - t (t + 1) / 2)
    for (int p = tid; p < NPAIR; p += kThreads) {
      int t = (int)((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
      while (t * (t + 1) / 2 > p) --t;
      while ((t + 1) * (t + 2) / 2 <= p) ++t;
      const int s = p - t * (t + 1) / 2;
      const float* rt = rr + t * P;
      const float* ks_ = kk + s * P;
      float acc = 0.f;
      if (s == t) {
#pragma unroll 8
        for (int i = 0; i < HD; ++i) acc = fmaf(rt[i] * us[i], ks_[i], acc);
      } else {
        const float* ct = cx + t * P;
        const float* cs = cm + s * P;
#pragma unroll 8
        for (int i = 0; i < HD; ++i)
          acc = fmaf(rt[i] * ks_[i], expf(ct[i] - cs[i]), acc);
      }
      A[t * (L + 1) + s] = acc;
    }
    __syncthreads();
    // y: the carried state through rd, then the chunk's own pairs
    float ya[NTR];
#pragma unroll
    for (int m = 0; m < NTR; ++m) ya[m] = 0.f;
#pragma unroll 4
    for (int i = 0; i < HD; ++i) {
      const float sv = S[i * HD + j];
#pragma unroll
      for (int m = 0; m < NTR; ++m)
        ya[m] = fmaf(rd[(g + m * NG) * P + i], sv, ya[m]);
    }
#pragma unroll
    for (int m = 0; m < NTR; ++m) {
      const int t = g + m * NG;
      for (int s = 0; s <= t; ++s)
        ya[m] = fmaf(A[t * (L + 1) + s], vv[s * HD + j], ya[m]);
      if (t < n) y[(((size_t)b * T_ + t0 + t) * H + h) * HD + j] = ya[m];
    }
    __syncthreads();  // S was read above and is written below
    for (int i = g; i < HD; i += NG) {
      float upd = 0.f;
#pragma unroll 8
      for (int s = 0; s < L; ++s)
        upd = fmaf(kd[s * P + i], vv[s * HD + j], upd);
      S[i * HD + j] = expf(cl[i]) * S[i * HD + j] + upd;
    }
    __syncthreads();  // the next chunk overwrites kd, vv and cl
  }
  for (int e = tid; e < HD * HD; e += kThreads) sout[sbase + e] = S[e];
}

template <typename T, int HD, int L>
cudaError_t launch_t(const void* r, const void* k, const void* v,
                     const void* w, const void* u, const void* s0, void* y,
                     void* sout, int B, int T_, int H, cudaStream_t stream) {
  const size_t smem = smem_floats<HD, L>() * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T, HD, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  wkv6_kernel<T, HD, L><<<B * H, kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (float*)y, (float*)sout, T_, H);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* s0, void* y,
                      void* sout, int B, int T_, int H, int chunk,
                      cudaStream_t s) {
  switch (chunk) {
    case 8:
      return launch_t<T, HD, 8>(r, k, v, w, u, s0, y, sout, B, T_, H, s);
    case 16:
      return launch_t<T, HD, 16>(r, k, v, w, u, s0, y, sout, B, T_, H, s);
    case 32:
      return launch_t<T, HD, 32>(r, k, v, w, u, s0, y, sout, B, T_, H, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* sout, int B, int T_, int H, int hd, int chunk,
                   void* stream) {
  if (B < 1 || T_ < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(r, k, v, w, u, s0, y, sout, B, T_, H, chunk, s);
    case 64:
      return launch_hd<T, 64>(r, k, v, w, u, s0, y, sout, B, T_, H, chunk, s);
    case 128:
      return launch_hd<T, 128>(r, k, v, w, u, s0, y, sout, B, T_, H, chunk,
                               s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w (B,T,H,hd) contiguous, 16-byte aligned, all fp32 or all bf16;
// u (H,hd), state0 and state_out (B,H,hd,hd), y (B,T,H,hd) fp32; hd 32,
// 64 or 128; chunk 8, 16 or 32 steps.
extern "C" cudaError_t repro_wkv6_f32(const void* r, const void* k,
                                      const void* v, const void* w,
                                      const void* u, const void* s0, void* y,
                                      void* sout, int B, int T, int H, int hd,
                                      int chunk, void* stream) {
  return launch<float>(r, k, v, w, u, s0, y, sout, B, T, H, hd, chunk,
                       stream);
}

extern "C" cudaError_t repro_wkv6_bf16(const void* r, const void* k,
                                       const void* v, const void* w,
                                       const void* u, const void* s0,
                                       void* y, void* sout, int B, int T,
                                       int H, int hd, int chunk,
                                       void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, B, T, H, hd,
                               chunk, stream);
}
