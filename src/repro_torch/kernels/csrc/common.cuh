// Helpers shared by the port's kernels: warp reductions (a transpose-reduce
// of many sums over a few lanes among them), bf16 and int8 unpacking,
// 16-byte vector loads and the bf16 tensor-core product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sums each of v[0..N) over G consecutive lanes (G a power of two up to
// 32; g = the lane's index among them) without a shuffle tree per value:
// each round a lane keeps one half of its values and adds its partner's
// copy of that half; once a lane holds one value, plain pairwise sums.
// Returns the index of the first of the max(N / G, 1) sums the lane then
// holds in v[0 ..]; where N < G, the lanes g with reduce_writer<N, G>(g)
// hold each sum once.  Every lane of the warp must call it.
template <int N, int G>
__device__ __forceinline__ int transpose_reduce(float (&v)[N], int g) {
  int first = 0;
  int cnt = N;
#pragma unroll
  for (int o = G / 2; o >= 1; o /= 2) {
    if (cnt >= 2) {
      const bool upper = (g & o) != 0;
      const int half = cnt / 2;
#pragma unroll
      for (int m = 0; m < N / 2; ++m) {
        if (m < half) {
          const float lo = v[m], hi = v[m + half];
          v[m] = (upper ? hi : lo) +
                 __shfl_xor_sync(kFull, upper ? lo : hi, o);
        }
      }
      if (upper) first += half;
      cnt = half;
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], o);
    }
  }
  return first;
}

template <int N, int G>
__device__ __forceinline__ bool reduce_writer(int g) {
  return (g & (G > N ? G / N - 1 : 0)) == 0;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// 8 bf16 values held in one 16-byte load -> 8 floats.
__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// int8 -> fp32 without the conversion unit (I2F issues at 1/8 of the FMA
// rate): byte k of ``biased`` (the int8 word XOR 0x80808080, i.e. each
// value + 128) becomes the low mantissa byte of 2^23, and subtracting
// 2^23 + 128 leaves the value, exactly.
__device__ __forceinline__ float biased_byte_to_float(uint32_t biased,
                                                      int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + k)) -
         8388736.f;
}

// One 16-byte vector of T -> floats: 8 bf16 or 4 fp32.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    bf16x8_to_float(u, f);
  }
};

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const uint4& u, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&u);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

// c (16 x 8 fp32) += a (16 x 16 bf16, row-major) . b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace repro
