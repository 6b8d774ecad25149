// The tensor-core attention core shared by the dense decode
// (decode_attention.cu, `decode_mma_kernel`) and the paged chunked prefill
// (prefill_attention.cu, `prefill_mma_kernel`): a block takes every query
// row that shares one KV head, streams that head's K/V positions through a
// shared-memory ring once, and runs both products on `mma.sync.m16n8k16`
// (bf16 in, fp32 accumulate).
//
// Warps.  A block is WM x WN warps.  Warp (wm, wn) owns the 16 query rows
// 16 wm .. 16 wm + 15 of the block (one m-tile) and the NW positions
// wn NW .. wn NW + NW - 1 of every staged tile of BN = WN NW positions, and
// folds them into its own online-softmax state (m, l, acc) in registers.
// After the walk the WN states of an m-tile merge once through shared
// memory, in warp order.
//
// Products.  S = Q K^T: A is q (16 rows x hd, fragments loaded once from
// device memory), B the staged K rows ([pos][hd] is the "col" B operand,
// read by ldmatrix).  The softmax runs on the C fragments (row max and sum
// over the quad of lanes that share a row).  O += P V: the C fragments of
// two n8 score tiles are the A fragment of one k16 step; V is staged
// [pos][hd] and read by ldmatrix.trans.  P is split into a bf16 high part
// and the bf16 rounding of the rest, and both parts are multiplied: P V is
// then good to ~2^-16 relative, where P in bf16 alone would cost a bf16
// ulp of outputs of order 1 (rows that see few positions).  The kernels are
// bound by bytes (~1 operation a byte against a ridge near 295), so the
// second product costs no time that shows.
//
// Masks.  Each lane holds the limit of its two rows (g and g + 8 of the
// m-tile): positions >= the limit give p = 0 explicitly (a row that has
// seen no valid position has m = -1e30, where exp(s - m) would be 1), and
// their scores are left out of the max.  A warp whose whole slice is below
// every limit of its rows skips the compares; one whose slice is at or
// above every limit skips the slice.
//
// Staging.  cp.async, 16 bytes a lane, into a ring of STAGES tiles; tiles
// t + 1 .. t + STAGES - 1 are in flight while the block waits for tile t
// and multiplies it.  K and V rows are
// padded by 16 bytes, so the 8 row addresses of an ldmatrix phase fall on
// distinct banks.  A position outside the walked range is zero-filled, so a
// masked p = 0 never meets a NaN.  No atomics: the same inputs give the
// same bits on every launch.
#pragma once

#include "paged_attention.cuh"

namespace repro {
namespace mma {

constexpr float kLog2e = 1.4426950408889634f;

// K/V tile row stride in elements: hd + 16 bytes of padding
template <int HD>
struct Tile {
  static constexpr int stride = HD + 8;
  static constexpr int row_bytes = stride * 2;
  // one stage: K then V, BN rows each
  __host__ __device__ static constexpr int stage_bytes(int bn) {
    return 2 * bn * row_bytes;
  }
  // the merge buffer: per warp 16 rows of (m, l), then 16 rows of hd
  // accumulators, merge_stride floats apart (8-byte stores of a warp on
  // distinct banks)
  static constexpr int merge_stride = HD + 8;
  __host__ __device__ static constexpr int merge_bytes(int warps) {
    return warps * 16 * (2 + merge_stride) * 4;
  }
};

// cp.async of 16 bytes, or (bytes == 0) 16 zero bytes without a read
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row-major) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (x in the low half: the lower column), and the
// bf16x2 of what that rounding left
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// A lane's online-softmax state for its two rows (g, g + 8) of one m-tile:
// the running max (scaled scores, replicated over the quad), the lane's
// partial row sums (over its own columns; reduced over the quad once, at
// the end) and the C fragments of the 16 x HD output.
template <int HD>
struct State {
  float m[2], l[2];
  float acc[HD / 8][4];
  __device__ __forceinline__ void init() {
    m[0] = m[1] = kNeg;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
};

// The A fragments of 16 q rows (row g at q_g, row g + 8 at q_g8; bf16, hd
// contiguous, 4-byte aligned), for every k16 step of hd.
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qf)[HD / 16][4],
                                       const __nv_bfloat16* q_g,
                                       const __nv_bfloat16* q_g8) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * qd;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(q_g + c);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(q_g8 + c);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(q_g + c + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(q_g8 + c + 8);
  }
}

// Fold NW staged positions (pos0 .. pos0 + NW - 1; their K rows at k_s, V
// rows at v_s, Tile<HD>::stride apart) into the state of the warp's 16 rows.
// lim0 / lim1: the first position that row g / g + 8 of this lane may not
// see; ``masked`` false promises pos0 + NW <= both for every lane.  ``sc``
// is the score scale (hd^-0.5).
template <int HD, int NW>
__device__ __forceinline__ void fold(const uint32_t (&qf)[HD / 16][4],
                                     const __nv_bfloat16* k_s,
                                     const __nv_bfloat16* v_s, int pos0,
                                     int lim0, int lim1, bool masked,
                                     float sc, State<HD>& st) {
  constexpr int STR = Tile<HD>::stride;
  constexpr int NT = NW / 8;  // n8 score tiles
  const int lane = threadIdx.x & 31, qd = lane & 3;
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  // S = q K^T: one ldmatrix.x4 gives b0, b1 of two k16 steps of one n8 tile
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int kp = 0; kp < HD / 32; ++kp) {
      uint32_t b[4];
      ldmatrix_x4(b, k_s + (nt * 8 + (lane & 7)) * STR + kp * 32 +
                         8 * (lane >> 3));
      mma16816(s[nt], qf[2 * kp], b[0], b[1]);
      mma16816(s[nt], qf[2 * kp + 1], b[2], b[3]);
    }
  // scale, mask, row max over the quad
  float mx0 = st.m[0], mx1 = st.m[1];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[nt][e] * sc;
      if (masked) {
        const int p = pos0 + nt * 8 + 2 * qd + (e & 1);
        if (p >= (e < 2 ? lim0 : lim1)) v = kNeg;
      }
      s[nt][e] = v;
      if (e < 2)
        mx0 = fmaxf(mx0, v);
      else
        mx1 = fmaxf(mx1, v);
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
  }
  const float a0 = exp2f((st.m[0] - mx0) * kLog2e);
  const float a1 = exp2f((st.m[1] - mx1) * kLog2e);
  st.m[0] = mx0;
  st.m[1] = mx1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = e < 2 ? mx0 : mx1;
      bool live = true;
      if (masked) {
        const int p = pos0 + nt * 8 + 2 * qd + (e & 1);
        live = p < (e < 2 ? lim0 : lim1);
      }
      const float p = live ? exp2f((s[nt][e] - m) * kLog2e) : 0.f;
      s[nt][e] = p;
      if (e < 2)
        ls0 += p;
      else
        ls1 += p;
    }
  st.l[0] = st.l[0] * a0 + ls0;
  st.l[1] = st.l[1] * a1 + ls1;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    st.acc[j][0] *= a0;
    st.acc[j][1] *= a0;
    st.acc[j][2] *= a1;
    st.acc[j][3] *= a1;
  }
  // O += P V, P as hi + lo bf16 parts; one ldmatrix.x4.trans gives b0, b1
  // of two n8 tiles of hd
#pragma unroll
  for (int t = 0; t < NW / 16; ++t) {
    uint32_t ph[4], pl[4];
    split_bf16x2(s[2 * t][0], s[2 * t][1], ph[0], pl[0]);
    split_bf16x2(s[2 * t][2], s[2 * t][3], ph[1], pl[1]);
    split_bf16x2(s[2 * t + 1][0], s[2 * t + 1][1], ph[2], pl[2]);
    split_bf16x2(s[2 * t + 1][2], s[2 * t + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int j = 0; j < HD / 8; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_s + (t * 16 + (lane & 7) + 8 * ((lane >> 3) & 1))
                                     * STR + j * 8 + 8 * (lane >> 4));
      mma16816(st.acc[j], ph, b[0], b[1]);
      mma16816(st.acc[j], pl, b[0], b[1]);
      mma16816(st.acc[j + 1], ph, b[2], b[3]);
      mma16816(st.acc[j + 1], pl, b[2], b[3]);
    }
  }
}

// The walk of one block: T tiles of BN = WN NW positions through a ring of
// STAGES stages in ``smem``.  pos_of(t, r): the position of row r of tile t,
// or -1 outside the walked range (zero-filled); row_of(pos): its pool row
// (in units of HD elements) in k / v.  slice(t, pos0, lim0, lim1): this
// warp's first position in tile t and its lane's two row limits.  Every
// thread of the block takes part (the ring is filled by all of them).
template <int HD, int NW, int STAGES, class PosOf, class RowOf, class Slice>
__device__ __forceinline__ void walk(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    unsigned char* smem, int BN, int T, PosOf pos_of, RowOf row_of,
    Slice slice, int wn, const uint32_t (&qf)[HD / 16][4], float sc,
    State<HD>& st) {
  constexpr int STR = Tile<HD>::stride;
  constexpr int PARTS = HD / 8;  // 16-byte pieces of a row
  const int sbytes = Tile<HD>::stage_bytes(BN);
  auto load = [&](int t) {
    __nv_bfloat16* ks =
        reinterpret_cast<__nv_bfloat16*>(smem + (t % STAGES) * sbytes);
    __nv_bfloat16* vs = ks + BN * STR;
#pragma unroll 4
    for (int c = threadIdx.x; c < BN * PARTS; c += blockDim.x) {
      const int r = c / PARTS, part = c % PARTS;
      const int pos = pos_of(t, r);
      const long long off = pos >= 0 ? row_of(pos) * HD + part * 8 : 0;
      const int bytes = pos >= 0 ? 16 : 0;
      cp_async16_zfill(ks + r * STR + part * 8, k + off, bytes);
      cp_async16_zfill(vs + r * STR + part * 8, v + off, bytes);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < T) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    // every warp is done with tile t - 1, whose stage tile t + STAGES - 1
    // takes: it is in flight while this thread waits for tile t
    __syncthreads();
    if (t + STAGES - 1 < T) load(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile t has landed for every thread
    int pos0, lim0, lim1;
    slice(t, pos0, lim0, lim1);
    const bool any = __any_sync(kFull, pos0 < lim0 || pos0 < lim1);
    if (!any) continue;
    const bool masked =
        !__all_sync(kFull, pos0 + NW <= lim0 && pos0 + NW <= lim1);
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(
        smem + (t % STAGES) * sbytes);
    fold<HD, NW>(qf, ks + wn * NW * STR, ks + BN * STR + wn * NW * STR, pos0,
                 lim0, lim1, masked, sc, st);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's memory is the merge buffer next
}

// Merge the WN states of each m-tile (warp w = wm WN + wn) and hand this
// lane's results to ``emit(row, d, a0, a1, M, L)``: the block's row (0 ..
// 16 WM - 1), the even column d (a0, a1: the merged unnormalized outputs of
// columns d, d + 1), the row's merged max M and sum L; only the warps with
// wn = 0 emit.  Every lane of a row computes M = max m_w, L = sum l_w
// exp(m_w - M) (w in order) and its own factor exp(m_w - M) from the
// states' (m, l) in shared memory, scales its accumulators in registers,
// and the warps wn > 0 hand theirs to warp wn = 0 through shared memory,
// which adds them in warp order: the same bits on every launch.  An empty
// row gives M = -1e30, L = 0, A = 0.  ``smem`` holds
// Tile<HD>::merge_bytes(warps) bytes and is free (after walk).
template <int HD, class Emit>
__device__ __forceinline__ void merge(State<HD>& st, unsigned char* smem,
                                      int WN, Emit emit) {
  constexpr int STRF = Tile<HD>::merge_stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  // the quad's partial sums -> the row's
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    st.l[0] += __shfl_xor_sync(kFull, st.l[0], o);
    st.l[1] += __shfl_xor_sync(kFull, st.l[1], o);
  }
  float M[2] = {st.m[0], st.m[1]}, L[2] = {st.l[0], st.l[1]};
  if (WN > 1) {
    float* ml = reinterpret_cast<float*>(smem);  // [warp][16 rows][m, l]
    float* buf = ml + (blockDim.x >> 5) * 32;    // [warp][16 rows][STRF]
    if (qd == 0) {
      ml[(warp * 16 + g) * 2] = st.m[0];
      ml[(warp * 16 + g) * 2 + 1] = st.l[0];
      ml[(warp * 16 + g + 8) * 2] = st.m[1];
      ml[(warp * 16 + g + 8) * 2 + 1] = st.l[1];
    }
    __syncthreads();
    float f[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* r = ml + (wm * WN * 16 + g + 8 * i) * 2;
      float mx = kNeg, l = 0.f;
      for (int w = 0; w < WN; ++w) mx = fmaxf(mx, r[w * 32]);
      for (int w = 0; w < WN; ++w)
        l = fmaf(r[w * 32 + 1], expf(r[w * 32] - mx), l);
      f[i] = expf(st.m[i] - mx);
      M[i] = mx;
      L[i] = l;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      st.acc[j][0] *= f[0];
      st.acc[j][1] *= f[0];
      st.acc[j][2] *= f[1];
      st.acc[j][3] *= f[1];
    }
    if (wn > 0) {
      float* mine = buf + warp * 16 * STRF;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = j * 8 + 2 * qd;
        *reinterpret_cast<float2*>(mine + g * STRF + d) =
            make_float2(st.acc[j][0], st.acc[j][1]);
        *reinterpret_cast<float2*>(mine + (g + 8) * STRF + d) =
            make_float2(st.acc[j][2], st.acc[j][3]);
      }
    }
    __syncthreads();
    if (wn > 0) return;
    for (int w = 1; w < WN; ++w) {
      const float* theirs = buf + (warp + w) * 16 * STRF;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = j * 8 + 2 * qd;
        const float2 a =
            *reinterpret_cast<const float2*>(theirs + g * STRF + d);
        const float2 b =
            *reinterpret_cast<const float2*>(theirs + (g + 8) * STRF + d);
        st.acc[j][0] += a.x;
        st.acc[j][1] += a.y;
        st.acc[j][2] += b.x;
        st.acc[j][3] += b.y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int d = j * 8 + 2 * qd;
    emit(wm * 16 + g, d, st.acc[j][0], st.acc[j][1], M[0], L[0]);
    emit(wm * 16 + g + 8, d, st.acc[j][2], st.acc[j][3], M[1], L[1]);
  }
}

// Where a block leaves a row's merged result (row o of HD outputs):
// normalized by max(L, 1e-30) into the bf16 ``out``, or unnormalized into
// fp32 ``acc`` (and M, L into ``m``, ``l``) — with one split; with more
// (gridDim.y), split blockIdx.y goes to row o * nsplit + split of ``part``
// (HD + 2 floats: acc, m, l) for ``split_combine_kernel``.
struct Sink {
  __nv_bfloat16* out;
  float *acc, *m, *l, *part;
  template <int HD>
  __device__ __forceinline__ void put(size_t o, int d, float a0, float a1,
                                      float M, float L) const {
    const int nsplit = gridDim.y;
    if (nsplit > 1) {
      float* dst = part + (o * nsplit + blockIdx.y) * (HD + 2);
      *reinterpret_cast<float2*>(dst + d) = make_float2(a0, a1);
      if (d == 0) {
        dst[HD] = M;
        dst[HD + 1] = L;
      }
    } else if (out != nullptr) {
      const float inv = 1.f / fmaxf(L, 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(out + o * HD + d) =
          __floats2bfloat162_rn(a0 * inv, a1 * inv);
    } else {
      *reinterpret_cast<float2*>(acc + o * HD + d) = make_float2(a0, a1);
      if (d == 0) {
        m[o] = M;
        l[o] = L;
      }
    }
  }
};

// One block of HD threads per row o: the nsplit partials of ``part``
// combined in split order (log-sum-exp), into ``out`` normalized by
// max(l, 1e-30) (bf16), or into acc / m / l unnormalized when out is null.
template <int HD>
__global__ void split_combine_kernel(const float* __restrict__ part,
                                     int nsplit, float* __restrict__ acc,
                                     float* __restrict__ m,
                                     float* __restrict__ l,
                                     __nv_bfloat16* __restrict__ out) {
  const int o = blockIdx.x, d = threadIdx.x;
  const float* p = part + (size_t)o * nsplit * (HD + 2);
  float M = kNeg;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, p[s * (HD + 2) + HD]);
  float A = 0.f, L = 0.f;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s) {
    const float* ps = p + s * (HD + 2);
    const float f = expf(ps[HD] - M);
    A = fmaf(ps[d], f, A);
    L = fmaf(ps[HD + 1], f, L);
  }
  if (out != nullptr) {
    out[(size_t)o * HD + d] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  } else {
    acc[(size_t)o * HD + d] = A;
    if (d == 0) {
      m[o] = M;
      l[o] = L;
    }
  }
}

}  // namespace mma
}  // namespace repro
