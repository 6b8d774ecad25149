// Fused AdamW: one pass over (p, g, mu, nu) of every tensor of one
// parameter leaf, updating p, mu and nu in place.
//
//   m   = b1 mu + (1 - b1) g                   (fp32)
//   n   = b2 nu + (1 - b2) g g
//   upd = (m / bc1) / (sqrt(n / bc2) + eps)
//   p'  = p - lr (upd + wd p)                  (fp32, stored as p's type)
//
// Replaces: src/repro/kernels/fused_adamw.py `fused_adamw` (the Pallas
//   kernel that streams one leaf as (rows, 128) blocks through `_update`,
//   its seven hyper-parameters in SMEM; `streams=2` feeds each grid step one
//   block from each contiguous half, `_kernel_2s`).
// Bound on the H100: bytes.  Per fp32 element it reads p, g, mu, nu and
//   writes p, mu, nu: 28 bytes for ~12 operations, far below the card's
//   ridge.  A bf16 p and g make it 22 bytes.  qwen1.5-0.5b's 619.6 M fp32
//   masters are 17.35 GB per step: >= 5.18 ms at 3.35 TB/s.
// Design:
//   - One launch per leaf of the JAX parameter tree.  The port keeps every
//     layer's tensor apart (24 per stacked leaf), so the launch takes a
//     table of up to kMaxTensors (p, g, mu, nu, numel) entries; it travels
//     as the kernel's own argument (`__grid_constant__`, no copy to device
//     memory and no host sync), with the prefix sum of each tensor's
//     blocks.  A block finds its tensor by binary search over that sum.
//   - The seven hyper-parameters are read from device memory (lr, b1, b2,
//     eps, wd, bc1, bc2), as the TPU kernel reads them from SMEM: the
//     schedule and the bias corrections are computed on the device from
//     the step counter, and the host never reads them.
//   - 16-byte loads and stores (4 fp32, or 8 bf16 of p and g beside two
//     float4 of mu and nu), neighbouring threads on neighbouring vectors; the
//     elements past the last whole vector go through a scalar tail.
//   - Each block of kThreads threads takes kBlock elements (kBlock / VEC
//     vectors) of one tensor, or with two streams that many from each
//     contiguous half (the TPU kernel's decoupled streams).
//   - The arithmetic is `_update`'s, operation by operation, each rounded
//     on its own (no fused multiply-add), so the kernel gives what its
//     plain PyTorch version gives.
#include "common.cuh"

namespace {

constexpr int kMaxTensors = 32;
constexpr int kThreads = 256;
constexpr int kBlock = 4096;  // elements of one stream per block

struct Table {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  float* mu[kMaxTensors];
  float* nu[kMaxTensors];
  long long numel[kMaxTensors];
  int first_block[kMaxTensors + 1];  // prefix sum of blocks per tensor
  int n;
};

struct Hyper {
  float lr, b1, b2, eps, wd, bc1, bc2, omb1, omb2;
};

// The element type of p and g: VEC elements per 16-byte vector.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  __device__ __forceinline__ static void load(const void* a, long long v,
                                              float* f) {
    const float4 x = reinterpret_cast<const float4*>(a)[v];
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
  __device__ __forceinline__ static void store(void* a, long long v,
                                               const float* f) {
    reinterpret_cast<float4*>(a)[v] = make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ __forceinline__ static float get(const void* a, long long i) {
    return reinterpret_cast<const float*>(a)[i];
  }
  __device__ __forceinline__ static void put(void* a, long long i, float f) {
    reinterpret_cast<float*>(a)[i] = f;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ __forceinline__ static void load(const void* a, long long v,
                                              float* f) {
    repro::bf16x8_to_float(reinterpret_cast<const uint4*>(a)[v], f);
  }
  __device__ __forceinline__ static void store(void* a, long long v,
                                               const float* f) {
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    reinterpret_cast<uint4*>(a)[v] = o;
  }
  __device__ __forceinline__ static float get(const void* a, long long i) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a)[i]);
  }
  __device__ __forceinline__ static void put(void* a, long long i, float f) {
    reinterpret_cast<__nv_bfloat16*>(a)[i] = __float2bfloat16_rn(f);
  }
};

// `_update` on one element, every operation rounded on its own.
__device__ __forceinline__ void adamw(float& p, float g, float& m, float& n,
                                      const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  n = __fadd_rn(__fmul_rn(h.b2, n), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float upd = __fdiv_rn(
      __fdiv_rn(m, h.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(n, h.bc2)), h.eps));
  p = __fsub_rn(p, __fmul_rn(h.lr, __fadd_rn(upd, __fmul_rn(h.wd, p))));
}

// Vectors [lo, hi) of one tensor, strided over the block's threads.
template <typename T>
__device__ __forceinline__ void run(void* p, const void* g, float* mu,
                                    float* nu, long long lo, long long hi,
                                    const Hyper& h) {
  constexpr int V = Elem<T>::VEC;
  for (long long v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    float pf[V], gf[V], mf[V], nf[V];
    Elem<T>::load(p, v, pf);
    Elem<T>::load(g, v, gf);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      Elem<float>::load(mu, v * (V / 4) + q, mf + 4 * q);
      Elem<float>::load(nu, v * (V / 4) + q, nf + 4 * q);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) adamw(pf[j], gf[j], mf[j], nf[j], h);
    Elem<T>::store(p, v, pf);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      Elem<float>::store(mu, v * (V / 4) + q, mf + 4 * q);
      Elem<float>::store(nu, v * (V / 4) + q, nf + 4 * q);
    }
  }
}

template <typename T, int STREAMS>
__global__ void __launch_bounds__(kThreads)
    fused_adamw_kernel(const __grid_constant__ Table tab,
                       const float* __restrict__ hyper) {
  constexpr int V = Elem<T>::VEC;
  constexpr int chunk = kBlock / V;  // vectors of one stream per block
  // the tensor of this block: the last t with first_block[t] <= blockIdx.x
  int lo = 0, hi = tab.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.first_block[mid] <= (int)blockIdx.x)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int t = lo;
  const long long j = (long long)blockIdx.x - tab.first_block[t];

  Hyper h;
  h.lr = hyper[0];
  h.b1 = hyper[1];
  h.b2 = hyper[2];
  h.eps = hyper[3];
  h.wd = hyper[4];
  h.bc1 = hyper[5];
  h.bc2 = hyper[6];
  h.omb1 = __fsub_rn(1.f, h.b1);
  h.omb2 = __fsub_rn(1.f, h.b2);

  void* p = tab.p[t];
  const void* g = tab.g[t];
  float* mu = tab.mu[t];
  float* nu = tab.nu[t];
  const long long numel = tab.numel[t];
  const long long nvec = numel / V;
  if (STREAMS == 1) {
    run<T>(p, g, mu, nu, j * chunk, min((j + 1) * chunk, nvec), h);
  } else {
    const long long half = (nvec + 1) / 2;
    run<T>(p, g, mu, nu, j * chunk, min((j + 1) * chunk, half), h);
    run<T>(p, g, mu, nu, half + j * chunk, min(half + (j + 1) * chunk, nvec),
           h);
  }
  if (j == 0) {  // the elements past the last whole vector
    for (long long i = nvec * V + threadIdx.x; i < numel; i += blockDim.x) {
      float pf = Elem<T>::get(p, i), m = mu[i], n = nu[i];
      adamw(pf, Elem<T>::get(g, i), m, n, h);
      Elem<T>::put(p, i, pf);
      mu[i] = m;
      nu[i] = n;
    }
  }
}

template <typename T>
cudaError_t launch(int n, const long long* entries, const void* hyper,
                   int streams, cudaStream_t stream) {
  constexpr int V = Elem<T>::VEC;
  static_assert(kBlock % V == 0, "a block takes whole vectors");
  if (n < 1 || n > kMaxTensors || (streams != 1 && streams != 2))
    return cudaErrorInvalidValue;
  const int chunk = kBlock / V;
  Table tab;
  tab.n = n;
  long long blocks = 0;
  for (int t = 0; t < n; ++t) {
    const long long* e = entries + 5 * t;
    tab.p[t] = reinterpret_cast<void*>(e[0]);
    tab.g[t] = reinterpret_cast<const void*>(e[1]);
    tab.mu[t] = reinterpret_cast<float*>(e[2]);
    tab.nu[t] = reinterpret_cast<float*>(e[3]);
    tab.numel[t] = e[4];
    const long long nvec = e[4] / V;
    const long long span = streams == 1 ? nvec : (nvec + 1) / 2;
    const long long b = span > 0 ? (span + chunk - 1) / chunk : 1;
    tab.first_block[t] = (int)blocks;
    blocks += b;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  tab.first_block[n] = (int)blocks;
  if (streams == 1)
    fused_adamw_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        tab, (const float*)hyper);
  else
    fused_adamw_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, stream>>>(
        tab, (const float*)hyper);
  return cudaGetLastError();
}

}  // namespace

// entries: n x (p, g, mu, nu, numel) as int64 (the pointers' addresses),
// 1 <= n <= kMaxTensors; dtype 0: fp32 p and g, 1: bf16 p and g; mu, nu
// fp32; every pointer 16-byte aligned (the wrapper checks); hyper (7,) fp32
// on the device: lr, b1, b2, eps, wd, bc1, bc2; streams 1 or 2.
extern "C" cudaError_t repro_fused_adamw(int dtype, int n,
                                         const long long* entries,
                                         const void* hyper, int streams,
                                         void* stream) {
  if (dtype == 0)
    return launch<float>(n, entries, hyper, streams, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(n, entries, hyper, streams,
                                 (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}
