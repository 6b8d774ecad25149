// The tensor-core attention core shared by the dense decodes
// (decode_attention.cu: `decode_mma_kernel` over a bf16 cache,
// `decode_q8_mma_kernel` over an int8 one, through walk_q8), the paged
// decodes (the same file: `paged_decode_mma_kernel`, over bf16 pages, and
// over int8 pages through walk_q8) and the paged chunked prefill
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
// ulp of outputs of order 1 (rows that see few positions); the paged
// decodes split P in three (fold's PSPLIT).  The kernels are bound by bytes
// (~1 operation a byte against a ridge near 295), so the extra products
// cost no time that shows.
//
// Masks.  Each lane holds the limit of its two rows (g and g + 8 of the
// m-tile): positions >= the limit give p = 0 explicitly (a row that has
// seen no valid position has m = -1e30, where exp(s - m) would be 1), and
// their scores are left out of the max.  A warp whose whole slice is below
// every limit of its rows skips the compares; one whose slice is at or
// above every limit skips the slice.
//
// Pages.  A paged kernel's block takes a split of whole pages of its slot
// (PageSplit) and looks the split's block-table entries up once, into
// shared memory; the walks map a position to its pool row through them.
//
// Staging.  cp.async, 16 bytes a lane, into a ring of STAGES tiles; tiles
// t + 1 .. t + STAGES - 1 are in flight while the block waits for tile t
// and multiplies it.  K and V rows are
// padded by 16 bytes, so the 8 row addresses of an ldmatrix phase fall on
// distinct banks.  A position outside the walked range is zero-filled, so a
// masked p = 0 never meets a NaN.  No atomics: the same inputs give the
// same bits on every launch.
#pragma once

#include "common.cuh"

namespace repro {
namespace mma {

constexpr float kNeg = -1e30f;  // the JAX kernels' mask value (_NEG)
constexpr float kLog2e = 1.4426950408889634f;
// block-table entries of one split in shared memory (4096 positions of
// 16-row pages, 8192 of 32-row ones): a longer table takes more splits
constexpr int kMaxPages = 256;

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

// cp.async of 4 bytes (4-byte aligned), or (bytes == 0) 4 zero bytes
// without a read
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// two floats -> three bf16x2 parts, each the bf16 rounding of what the
// parts before it left (each residual is exact in fp32): their sum is x,
// y to ~2^-27 relative
__device__ __forceinline__ void split3_bf16x2(float x, float y, uint32_t& hi,
                                              uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  split_bf16x2(x - hf.x, y - hf.y, mid, lo);
  hi = *reinterpret_cast<const uint32_t*>(&h);
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
// contiguous, 4-byte aligned), for every k16 step of hd.  Q8 (the int8
// cache, whose K fragments a lane builds from its own quarter of a K row):
// step kk of lane quad qd takes the hd columns qd HD / 4 + 4 kk .. + 3, the
// first two as the fragment's columns 2 qd, 2 qd + 1 and the last two as 2
// qd + 8, 2 qd + 9 (a dot product does not care about the order of k, so
// long as q and K agree).
template <int HD, bool Q8 = false>
__device__ __forceinline__ void load_q(uint32_t (&qf)[HD / 16][4],
                                       const __nv_bfloat16* q_g,
                                       const __nv_bfloat16* q_g8) {
  const int qd = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = Q8 ? qd * (HD / 4) + 4 * kk : kk * 16 + 2 * qd;
    const int c8 = Q8 ? c + 2 : c + 8;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(q_g + c);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(q_g8 + c);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(q_g + c8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(q_g8 + c8);
  }
}

// Two int8 values (bytes k, k + 1 of ``biased``, the int8 word XOR
// 0x80808080) -> bf16x2, exactly (|x| <= 128 has 8 significant bits):
// through fp32 by byte permutation, then paired (byte k in the low half).
__device__ __forceinline__ uint32_t biased_pair_to_bf16x2(uint32_t biased,
                                                          int k) {
  const __nv_bfloat162 p =
      __floats2bfloat162_rn(biased_byte_to_float(biased, k),
                            biased_byte_to_float(biased, k + 1));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The int8 cache's per-warp staging (walk_q8): a ring of STAGES stages,
// each the warp's 16 positions of int8 K rows then V rows, row_bytes apart,
// and 32 scale words (the 4-byte aligned word that holds each position's
// bf16 K scale, then its V scale); then the bf16 V tile that fold reads
// (Tile<HD> rows) and the 32 scales as floats.  Rows are padded only at
// hd 128, so that the 16-byte loads of a lane's quarter K rows (two rows a
// phase of 8 lanes) fall on distinct banks.
template <int HD>
struct Tile8 {
  static constexpr int row_bytes = HD == 128 ? HD + 16 : HD;
  static constexpr int stage_bytes = 32 * row_bytes + 32 * 4;
  __host__ __device__ static constexpr int warp_bytes(int stages) {
    return stages * stage_bytes + 16 * Tile<HD>::row_bytes + 32 * 4;
  }
};

// Fold NW staged positions (pos0 .. pos0 + NW - 1; their K rows at k_s, V
// rows at v_s, Tile<HD>::stride apart) into the state of the warp's 16 rows.
// lim0 / lim1: the first position that row g / g + 8 of this lane may not
// see; ``masked`` false promises pos0 + NW <= both for every lane.  ``sc``
// is the score scale (hd^-0.5).  Q8 (the int8 cache): k_s holds the int8 K
// rows (Tile8<HD>::row_bytes apart), and a lane makes the B fragments of
// its row of an n8 tile from its own quarter of that row (load_q's Q8
// order), exactly in bf16; position j's K scale k_sc[j] multiplies column
// j of the scores, and its V scale v_sc[j] column j of P after the row sums
// took P unscaled — in exact arithmetic the products over the dequantized
// rows k8 k_sc and v8 v_sc.  PSPLIT: P V over P's hi + lo bf16 parts (2),
// each added into the running accumulators by mma; or (3) over three
// parts, summed by mma into a zeroed accumulator, smallest part first, and
// that added to the running ones in fp32: no bf16 residual of P (~2^-27
// against ~2^-18) and one truncating tensor-core sum a tile instead of two
// a tile onto the running total.
template <int HD, int NW, bool Q8 = false, int PSPLIT = 2>
__device__ __forceinline__ void fold(const uint32_t (&qf)[HD / 16][4],
                                     const void* k_s,
                                     const __nv_bfloat16* v_s, int pos0,
                                     int lim0, int lim1, bool masked,
                                     float sc, State<HD>& st,
                                     const float* k_sc = nullptr,
                                     const float* v_sc = nullptr) {
  constexpr int STR = Tile<HD>::stride;
  constexpr int NT = NW / 8;  // n8 score tiles
  const int lane = threadIdx.x & 31, qd = lane & 3;
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  if constexpr (Q8) {
    // S = q K^T: word kk of the lane's quarter row holds step kk's 4 k
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const unsigned char* row =
          static_cast<const unsigned char*>(k_s) +
          (nt * 8 + (lane >> 2)) * Tile8<HD>::row_bytes + qd * (HD / 4);
      uint32_t w[HD / 16];
      if constexpr (HD >= 64) {
#pragma unroll
        for (int i = 0; i < HD / 64; ++i)
          *reinterpret_cast<uint4*>(w + 4 * i) =
              reinterpret_cast<const uint4*>(row)[i];
      } else {
        *reinterpret_cast<uint2*>(w) = *reinterpret_cast<const uint2*>(row);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t b = w[kk] ^ 0x80808080u;
        mma16816(s[nt], qf[kk], biased_pair_to_bf16x2(b, 0),
                 biased_pair_to_bf16x2(b, 2));
      }
    }
  } else {
    // S = q K^T: one ldmatrix.x4 gives b0, b1 of two k16 steps of one n8
    // tile
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k_s);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int kp = 0; kp < HD / 32; ++kp) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + (nt * 8 + (lane & 7)) * STR + kp * 32 +
                           8 * (lane >> 3));
        mma16816(s[nt], qf[2 * kp], b[0], b[1]);
        mma16816(s[nt], qf[2 * kp + 1], b[2], b[3]);
      }
  }
  // scale, mask, row max over the quad
  float mx0 = st.m[0], mx1 = st.m[1];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[nt][e] * sc;
      if constexpr (Q8) v *= k_sc[nt * 8 + 2 * qd + (e & 1)];
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
  if constexpr (Q8) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= v_sc[nt * 8 + 2 * qd + (e & 1)];
  }
  // O += P V, P as PSPLIT bf16 parts; one ldmatrix.x4.trans gives b0, b1
  // of two n8 tiles of hd
  if constexpr (PSPLIT == 3) {
#pragma unroll
    for (int t = 0; t < NW / 16; ++t) {
      uint32_t ph[4], pm[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split3_bf16x2(s[2 * t + (i >> 1)][2 * (i & 1)],
                      s[2 * t + (i >> 1)][2 * (i & 1) + 1], ph[i], pm[i],
                      pl[i]);
#pragma unroll
      for (int j = 0; j < HD / 8; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_s + (t * 16 + (lane & 7) +
                                    8 * ((lane >> 3) & 1)) * STR +
                                 j * 8 + 8 * (lane >> 4));
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(c0, pl, b[0], b[1]);
        mma16816(c0, pm, b[0], b[1]);
        mma16816(c0, ph, b[0], b[1]);
        mma16816(c1, pl, b[2], b[3]);
        mma16816(c1, pm, b[2], b[3]);
        mma16816(c1, ph, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st.acc[j][e] += c0[e];
          st.acc[j + 1][e] += c1[e];
        }
      }
    }
    return;
  }
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

// Where a position of a paged split lives: its pool row (in units of HD
// elements) for KV head kvh, through the split's block-table entries in
// shared memory (``pages[i]`` the physical page of logical page p0 + i).
struct PageRows {
  const int* pages;
  int p0, page, KV, kvh;
  __device__ __forceinline__ long long operator()(int pos) const {
    return ((long long)pages[pos / page - p0] * page + pos % page) * KV +
           kvh;
  }
};

// A block's share of one slot's paged K/V: split blockIdx.y of gridDim.y
// takes the positions [lo, hi) of the slot's n valid ones (n = length
// clamped to the table's nblk page rows), in whole pages: ceil(ceil(n /
// page) / nsplit) pages a split, so every split starts on a page boundary.
// A split past n is empty (lo >= hi).
struct PageSplit {
  int lo, hi, page;
  __device__ __forceinline__ PageSplit(int length, int nblk, int page_)
      : page(page_) {
    const int n = max(0, min(length, nblk * page));
    const int chunk =
        ((n + page - 1) / page + (int)gridDim.y - 1) / (int)gridDim.y * page;
    lo = blockIdx.y * chunk;
    hi = min(n, lo + chunk);
  }
  // The split's block-table entries [lo / page, ceil(hi / page)) of the
  // slot's row ``bt_row``, looked up once by the whole block into
  // ``pages`` (shared memory, at most kMaxPages entries: the launch takes
  // enough splits), then a barrier of the block.
  __device__ __forceinline__ PageRows lookup(int* pages, const int* bt_row,
                                             int KV, int kvh) const {
    const int p0 = lo / page;
    const int npg = hi > lo ? (hi - lo + page - 1) / page : 0;
    for (int i = threadIdx.x; i < npg; i += blockDim.x)
      pages[i] = bt_row[p0 + i];
    __syncthreads();
    return {pages, p0, page, KV, kvh};
  }
};

// The walk of one block: T tiles of BN = WN NW positions through a ring of
// STAGES stages in ``smem``.  pos_of(t, r): the position of row r of tile t,
// or -1 outside the walked range (zero-filled); row_of(pos): its pool row
// (in units of HD elements) in k / v.  slice(t, pos0, lim0, lim1): this
// warp's first position in tile t and its lane's two row limits.  Every
// thread of the block takes part (the ring is filled by all of them).
// PSPLIT: fold's split of P.
template <int HD, int NW, int STAGES, int PSPLIT = 2, class PosOf,
          class RowOf, class Slice>
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
    fold<HD, NW, false, PSPLIT>(qf, ks + wn * NW * STR,
                                ks + BN * STR + wn * NW * STR, pos0, lim0,
                                lim1, masked, sc, st);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's memory is the merge buffer next
}

// 8 int8 values -> 8 bf16, exactly.
__device__ __forceinline__ uint4 int8x8_to_bf16x8(uint2 u) {
  const uint32_t x = u.x ^ 0x80808080u, y = u.y ^ 0x80808080u;
  return make_uint4(biased_pair_to_bf16x2(x, 0), biased_pair_to_bf16x2(x, 2),
                    biased_pair_to_bf16x2(y, 0), biased_pair_to_bf16x2(y, 2));
}

// The walk of one warp over an int8 cache with bf16 scales at the same
// rows: T tiles, the warp's 16 positions of tile t being first + t step ..
// + 15, those >= lim zero-filled and masked; row_of(pos) is a position's
// row (the int8 K / V row at k, v + row HD, its scales at ks, vs + row):
// (base + pos) KV + kvh for a dense cache (B, S, KV, HD), the page map for
// a paged one.  Each warp stages only its own positions, through its own
// cp.async ring in ``ws`` (Tile8<HD>::warp_bytes(STAGES) bytes), so no
// barrier of the block is needed: per tile it converts the landed int8 V
// rows to its bf16 V tile (exact) and the scales to floats, and folds the
// tile (fold<HD, 16, true>: K fragments made from the int8 rows in
// registers, the K scales on the score columns, the V scales on P's).  The
// warp stops at the first tile past lim.  Returns with every copy landed;
// the caller syncs the block before reusing the memory.
template <int HD, int STAGES, int PSPLIT = 2, class RowOf>
__device__ __forceinline__ void walk_q8(
    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, unsigned char* ws, RowOf row_of,
    int first, int step, int lim, int T,
    const uint32_t (&qf)[HD / 16][4], float sc, State<HD>& st) {
  using T8 = Tile8<HD>;
  constexpr int STR = Tile<HD>::stride;
  constexpr int CPR = HD / 16;  // 16-byte pieces of an int8 row
  const int lane = threadIdx.x & 31;
  __nv_bfloat16* vb =
      reinterpret_cast<__nv_bfloat16*>(ws + STAGES * T8::stage_bytes);
  float* scf = reinterpret_cast<float*>(vb + 16 * STR);  // K, then V scales
  // lane < 16: the K scale of row lane of tile t, else the V scale of row
  // lane - 16; null past lim
  auto scale_at = [&](int t) -> const __nv_bfloat16* {
    const int pos = first + t * step + (lane & 15);
    return pos < lim ? (lane < 16 ? ks : vs) + row_of(pos) : nullptr;
  };
  auto load = [&](int t) {
    unsigned char* s8 = ws + (t % STAGES) * T8::stage_bytes;
    const int p0 = first + t * step;
#pragma unroll
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int r = c / CPR, part = c % CPR;
      const bool ok = p0 + r < lim;
      const long long off = ok ? row_of(p0 + r) * HD + part * 16 : 0;
      cp_async16_zfill(s8 + r * T8::row_bytes + part * 16, k + off,
                       ok ? 16 : 0);
      cp_async16_zfill(s8 + (16 + r) * T8::row_bytes + part * 16, v + off,
                       ok ? 16 : 0);
    }
    const __nv_bfloat16* sp = scale_at(t);
    const uintptr_t a = reinterpret_cast<uintptr_t>(sp ? sp : ks);
    cp_async4_zfill(s8 + 32 * T8::row_bytes + lane * 4,
                    reinterpret_cast<const void*>(a & ~uintptr_t(3)),
                    sp ? 4 : 0);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < T) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < T; ++t) {
    const int pos0 = first + t * step;
    if (pos0 >= lim) break;  // this and every later tile
    // the warp is done with tile t - 1 (fold), whose stage tile t +
    // STAGES - 1 takes
    __syncwarp();
    if (t + STAGES - 1 < T) load(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // tile t has landed for every lane of the warp
    const unsigned char* s8 = ws + (t % STAGES) * T8::stage_bytes;
#pragma unroll
    for (int c = lane; c < 16 * (HD / 8); c += 32) {
      const int r = c / (HD / 8), part = c % (HD / 8);
      *reinterpret_cast<uint4*>(vb + r * STR + part * 8) =
          int8x8_to_bf16x8(*reinterpret_cast<const uint2*>(
              s8 + (16 + r) * T8::row_bytes + part * 8));
    }
    {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          s8 + 32 * T8::row_bytes + lane * 4);
      const bool upper = (reinterpret_cast<uintptr_t>(scale_at(t)) >> 1) & 1;
      scf[lane] = __uint_as_float((upper ? w >> 16 : w & 0xffffu) << 16);
    }
    __syncwarp();
    fold<HD, 16, true, PSPLIT>(qf, s8, vb, pos0, lim, lim,
                               pos0 + 16 > lim, sc, st, scf, scf + 16);
  }
  cp_async_wait<0>();
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
  // launched as a programmatic dependent of the kernel that writes
  // ``part`` (launch_combine), wait for that grid's results; a plain launch
  // passes straight through
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// Launch split_combine_kernel on ``stream`` as a programmatic dependent of
// the kernel before it (which lets its dependents start early with
// ``griddepcontrol.launch_dependents``): its blocks are scheduled while
// that kernel runs and wait for its results in the kernel, so the launch
// latency of a second graph node overlaps the first.
template <int HD>
cudaError_t launch_combine(const float* part, int nsplit, int rows,
                           __nv_bfloat16* out, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(HD);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, split_combine_kernel<HD>, part, nsplit,
                         (float*)nullptr, (float*)nullptr, (float*)nullptr,
                         out);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace mma
}  // namespace repro
