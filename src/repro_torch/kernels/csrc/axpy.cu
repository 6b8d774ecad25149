// AXPY: out = a x + y, computed in fp32 and rounded to y's type; x and y
// both bf16 or both fp32, n elements; a new output (y is not written).
//
// Replaces: src/repro/kernels/axpy.py `axpy` (the paper's 3:1 bandwidth-to-
//   compute kernel: a 1-D grid over (rows, 128) tiles, x and y split into
//   two contiguous halves, four input DMAs in flight, when streams=2).
// Bound on the H100: bytes.  x and y read once and the output written once
//   (6 n bytes in bf16) for 2 n operations: a third of an operation per
//   byte.  At 2^27 bf16 that is 805 MB, 240.4 us at 3.35 TB/s.
// Design: two paths in one kernel, chosen by the wrapper from n.
//   - The stream (n past what 4 waves of the card take at a vector a
//     thread, 2^23 bf16): a stream through shared memory on Hopper's bulk
//     asynchronous copies, so no register holds a byte in flight and a
//     copy costs one instruction per tile instead of one per 16 bytes.
//     The operands are cut into tiles of `tile_v` 16-byte vectors; the
//     whole tiles are walked as `streams` contiguous parts side by side.
//     A block takes `spb` steps (step i: tile i of every part), each tile
//     of each step in a slot of its own in shared memory (an x tile and a
//     y tile under one mbarrier).  One thread of the block issues every
//     copy of the block at once: `cp.async.bulk.shared::cluster.global.
//     mbarrier::complete_tx` of the x and y tiles into a slot, which
//     completes the slot's barrier with the tile's bytes.  The block's
//     threads wait on each barrier in turn, compute each element out of
//     shared memory and write the result over the y tile; after a proxy
//     fence and a block barrier the same thread sends the tile out with
//     one `cp.async.bulk.global.shared::cta` bulk store (one bulk group a
//     step).  The grid is every block the steps take, not a persistent
//     one: 2 blocks an SM walking 125 (one part) or 63 (two parts) steps
//     each, through a ring of slots refilled as their stores had read
//     them, took 302 and 285 us at 2^27 bf16, against 261-263 for one
//     step a block, as the blocks drift apart and spread the access front
//     over memory (H100).  The remainder past the last whole tile
//     (less than one tile) takes the vector path below, while the first
//     tiles are in flight.
//   - The vector path (n that 4 waves take at a vector a thread): no
//     tile; every thread of the grid takes one 16-byte vector of x and of
//     y with streaming loads and stores.  There a block's fixed cost on
//     the stream (the barriers, one issuing thread, the whole tile
//     landing before any product, the store reading shared memory) shows:
//     3.38 against 4.24 us at 2^20 bf16, 14.23 against 17.99 at 2^23; the
//     two even at 2^24 and 2^27 (H100, scripts/chip_probe.py).
// The registry knobs (the JAX TroopConfig's, with its space: streams 1 or
//   2, unroll 1 or 2, block_k 256, 512 or 1024):
//   - `streams`: contiguous parts walked side by side, each tile in
//     slots of its own: TROOP's (A), the decoupled load streams;
//   - `unroll`: the steps a block takes, all in flight at once (a slot a
//     step and part, as many steps as fit in 227 KB);
//   - `block_k`: the 16-byte vectors of a tile (8 block_k bf16 or 4
//     block_k fp32 elements: 4, 8 or 16 KB an operand).
//   The vector path reads none of them.  The wrapper (kernels/axpy.py
//   `axpy_plan`) works all of it out and passes it in; this file checks
//   it.
// Arithmetic: one fp32 multiply and one fp32 add, each rounded on its own
//   (__fmul_rn / __fadd_rn: written as a * x + y, nvcc would contract it
//   to one fused multiply-add and round once), then one rounding to y's
//   type: the plain version's operations, so the two give the same bits.
//   n must be a multiple of V (8 bf16, 4 fp32) and x, y, out 16-byte
//   aligned (the wrapper checks): bulk copies move multiples of 16 bytes
//   between 16-byte aligned addresses.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBarBytes = 128;                // up to 16 mbarriers
constexpr int kMaxSmem = 227 * 1024;

// 16-byte vectors of T <-> floats, with the rounding of the output type.
template <typename T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    repro::bf16x8_to_float(u, f);
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Io<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    repro::Vec<float>::load(u, f);
  }
  __device__ __forceinline__ static uint4 store(const float* f) {
    uint4 u;
    float* o = reinterpret_cast<float*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = f[i];
    return u;
  }
};

template <typename T>
__device__ __forceinline__ uint4 axpy_vec(float a, const uint4& xv,
                                          const uint4& yv) {
  constexpr int V = Io<T>::n;
  float xf[V], yf[V], of[V];
  Io<T>::load(xv, xf);
  Io<T>::load(yv, yf);
#pragma unroll
  for (int j = 0; j < V; ++j) of[j] = __fadd_rn(__fmul_rn(a, xf[j]), yf[j]);
  return Io<T>::store(of);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
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

// a wait that outlasts any copy by orders of magnitude (a lost arrival)
// traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int n = 0; !mbar_done(bar, parity); ++n)
    if (n == (1 << 24)) __trap();
}

// ``bytes`` from global ``src`` into shared ``dst``, counted on ``bar``
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ``bytes`` from shared ``src`` out to global ``dst``, in the open group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// Grid: block b takes `spb` steps from step b spb on, below `per` (step i:
// tile p * per + i of part p, where it is below `tiles`); every thread of
// the grid also takes vectors of [tiles * tile_v, nv), one a thread where
// the grid has threads enough.  Shared memory: the barriers, then slot
// (p, i) of part p and step i at data + (p * spb + i) * 2 * tile bytes:
// its x tile, then its y tile, which the results overwrite before a bulk
// store sends them out.  Each barrier completes one phase (parity 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    axpy_kernel(float a, const T* __restrict__ x, const T* __restrict__ y,
                T* __restrict__ out, int nv, int tile_v, int tiles, int per,
                int streams, int spb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const int tid = threadIdx.x;
  const uint32_t tb = (uint32_t)tile_v * 16u;       // bytes of one tile
  const uint32_t bars = smem_u32(smem), data = bars + kBarBytes;
  uint4* slots = reinterpret_cast<uint4*>(smem + kBarBytes);
  const int step0 = blockIdx.x * spb;
  const int nsteps = max(0, min(spb, per - step0));
  auto slot = [&](int p, int j) { return p * spb + j; };
  auto tile_of = [&](int p, int j) { return p * per + step0 + j; };

  if (tid == 0 && nsteps > 0) {
    for (int i = 0; i < streams * spb; ++i) mbar_init(bars + 8u * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < nsteps; ++j)
      for (int p = 0; p < streams; ++p) {
        if (tile_of(p, j) >= tiles) continue;
        const uint32_t bar = bars + 8u * slot(p, j);
        const uint32_t dst = data + 2u * tb * slot(p, j);
        const size_t v0 = (size_t)tile_of(p, j) * tile_v;
        mbar_expect_tx(bar, 2u * tb);
        bulk_load(dst, xv + v0, tb, bar);
        bulk_load(dst + tb, yv + v0, tb, bar);
      }
  }
  // the vector path: the tail while the first tiles are in flight, or all
  // of n where the plan takes no tile
  for (int v = tiles * tile_v + blockIdx.x * kThreads + tid; v < nv;
       v += gridDim.x * kThreads)
    __stcs(ov + v, axpy_vec<T>(a, __ldcs(xv + v), __ldcs(yv + v)));
  if (nsteps == 0) return;
  __syncthreads();  // the barriers are initialised

  for (int j = 0; j < nsteps; ++j) {
    for (int p = 0; p < streams; ++p) {
      if (tile_of(p, j) >= tiles) continue;
      mbar_wait(bars + 8u * slot(p, j), 0);
      uint4* xs = slots + (size_t)2 * tile_v * slot(p, j);
      uint4* ys = xs + tile_v;
      for (int v = tid; v < tile_v; v += kThreads)
        ys[v] = axpy_vec<T>(a, xs[v], ys[v]);
    }
    // the generic-proxy writes become visible to the bulk copies
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid != 0) continue;
    for (int p = 0; p < streams; ++p)
      if (tile_of(p, j) < tiles)
        bulk_store(ov + (size_t)tile_of(p, j) * tile_v,
                   data + 2u * tb * slot(p, j) + tb, tb);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  // the stores must have read the block's shared memory before it goes
  if (tid == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

int smem_bytes(int tile_v, int streams, int spb, int tiles) {
  return tiles > 0 ? kBarBytes + streams * spb * 2 * tile_v * 16 : 0;
}

template <typename T>
cudaError_t launch(float a, const void* x, const void* y, void* out, int n,
                   int tile_v, int tiles, int per, int streams, int spb,
                   int blocks, void* stream) {
  constexpr int V = Io<T>::n;
  if (n <= 0) return cudaSuccess;
  const int nv = n / V;
  const int smem = smem_bytes(tile_v, streams, spb, tiles);
  if (n % V != 0 || tile_v < 1 || (streams != 1 && streams != 2) ||
      spb < 1 || streams * spb > kBarBytes / 8 || smem > kMaxSmem ||
      blocks < 1 || tiles < 0 || (long long)tiles * tile_v > nv ||
      per < 0 || (long long)per * streams < tiles ||
      (per > 0 && (long long)(per - 1) * streams >= tiles) ||
      (long long)blocks * spb < per)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      axpy_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  axpy_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      a, (const T*)x, (const T*)y, (T*)out, nv, tile_v, tiles, per, streams,
      spb);
  return cudaGetLastError();
}

}  // namespace

// x, y, out (n,) 16-byte aligned; bf16: n % 8 == 0, fp32: n % 4 == 0.
// The plan (kernels/axpy.py `axpy_plan`): tiles of tile_v 16-byte
// vectors, `tiles` whole ones (0: the vector path alone) in `streams`
// parts of `per` tiles (the last part may hold fewer), `spb` steps a
// block, a slot a step and part, `blocks` blocks (blocks * spb >= per).
extern "C" cudaError_t repro_axpy_bf16(float a, const void* x, const void* y,
                                       void* out, int n, int tile_v,
                                       int tiles, int per, int streams,
                                       int spb, int blocks, void* stream) {
  return launch<__nv_bfloat16>(a, x, y, out, n, tile_v, tiles, per, streams,
                               spb, blocks, stream);
}

extern "C" cudaError_t repro_axpy_f32(float a, const void* x, const void* y,
                                      void* out, int n, int tile_v,
                                      int tiles, int per, int streams,
                                      int spb, int blocks, void* stream) {
  return launch<float>(a, x, y, out, n, tile_v, tiles, per, streams, spb,
                       blocks, stream);
}
