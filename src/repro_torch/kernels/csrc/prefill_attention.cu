// Paged chunked-prefill attention: a slab of C query rows, the first at
// absolute position q_offset, attends causally over the slot's paged K/V
// (its own rows just written, plus any shared prefix pages).
//
// Replaces: src/repro/kernels/prefill_attention.py `prefill_attention_paged`
//   (`_prefill_attention_paged`: the whole slab (C rows x G heads of every
//   KV head) rides in VMEM while a (slot, page) grid streams each page
//   through it once, via the scalar-prefetched block table; causal mask
//   against the absolute q_offset, positions >= length masked).
// Bound on the H100: bytes.  One slab of C = 32 rows reads up to
//   length x KV x hd x 2 x 2 bytes of K/V for up to 4 x C x H x length x hd
//   operations: ~C G operations per byte, below the ~295 per byte of the
//   bf16 tensor-core ridge as long as each K/V row is read once per slab.
// Design (`prefill_mma_kernel`, the tensor-core core of mma_attention.cuh):
//   one block per (slot, KV head, split, row tile).  Its M rows are the
//   slab's C rows x the G query heads of the KV head (row m = c G + g),
//   WM m-tiles of 16 (more rows tile over blockIdx.z), so each K/V page is
//   read once for all of them; both products run on mma.sync.  Row c sees
//   positions [0, min(q_offset + c + 1, n)), n = length clamped to the
//   table's nblk * page rows — exactly what the mask (spos > qpos) | (spos
//   >= length) leaves visible; only the warps whose slice crosses a row's
//   limit compare positions.  Pad rows (c >= valid) see [0, n) and produce
//   garbage that the caller discards, as in the JAX kernel.  The engine's
//   slab is B = 1 slot over KV = 16 heads, too few blocks for 132 SMs, so
//   the slot's valid pages split over blockIdx.y (whole pages, one wave of
//   the blocks an SM holds at once, at least 256 positions a split); each
//   block looks its pages up in the slot's block-table row once, into
//   shared memory (at most kMaxPages of them: a longer table takes more
//   splits, so shared memory does not grow with the cache length), and
//   walks them in tiles of BN positions (a ring of three, cp.async), its
//   `prefill_warps` warps = WM row-tile warps x WN position warps, which
//   merge once.  With one split the block normalizes
//   by max(l, 1e-30) and stores bf16; else the splits' (acc, m, l) go to a
//   workspace and `split_combine_kernel` combines them in split order and
//   normalizes.
#include "mma_attention.cuh"

namespace {

constexpr int kStages = 3;
using repro::mma::kMaxPages;

// bytes of the ring (and of the merge buffer, which reuses it)
template <int HD>
__host__ __device__ constexpr int ring_bytes(int BN, int warps) {
  return kStages * repro::mma::Tile<HD>::stage_bytes(BN) >
                 repro::mma::Tile<HD>::merge_bytes(warps)
             ? kStages * repro::mma::Tile<HD>::stage_bytes(BN)
             : repro::mma::Tile<HD>::merge_bytes(warps);
}

// dynamic shared memory of a block: the ring, then the split's pages
template <int HD>
constexpr int smem_bytes(int BN, int warps) {
  return ring_bytes<HD>(BN, warps) + kMaxPages * 4;
}

// One block per (slot b and KV head kvh = blockIdx.x, split blockIdx.y,
// row tile blockIdx.z of 16 WM rows).  The block's split (PageSplit) is
// [lo, hi), whole pages of the slot's valid positions; row r of staged
// tile t is position lo + t BN + r.
// Warp w = wm WN + wn takes m-tile wm and positions wn NW .. of each tile.
// Output row o = (b C + c) H + kvh G + g goes to ``sink`` (out, normalized,
// with one split; else ``part``).
template <int HD, int NW>
__global__ void __launch_bounds__(256) prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ bt,
    const int* __restrict__ q_offset, const int* __restrict__ length,
    repro::mma::Sink sink, int C, int H, int KV, int page, int nblk, int WM,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV, R = C * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int WN = (blockDim.x >> 5) / WM, BN = WN * NW;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2;

  const repro::mma::PageSplit sp(length[b], nblk, page);
  const int lo = sp.lo, hi = sp.hi;
  const int T = hi > lo ? (hi - lo + BN - 1) / BN : 0;
  const int off = q_offset[b];

  // this lane's two rows (g, g + 8 of the warp's m-tile): q and limits
  const int m0 = blockIdx.z * 16 * WM + wm * 16;
  int lim[2];
  const __nv_bfloat16* qr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + g + 8 * i;
    const int mc = min(m, R - 1);
    const int c = mc / G;
    qr[i] = q + (((size_t)b * C + c) * H + (size_t)kvh * G + mc % G) * HD;
    lim[i] = m < R ? min(off + c + 1, hi) : hi;
  }
  uint32_t qf[HD / 16][4];
  repro::mma::load_q<HD>(qf, qr[0], qr[1]);

  // the split's pages, in shared memory past the ring
  const repro::mma::PageRows row_of = sp.lookup(
      reinterpret_cast<int*>(smem + ring_bytes<HD>(BN, WM * WN)),
      bt + (size_t)b * nblk, KV, kvh);
  auto pos_of = [&](int t, int r) {
    const int p = lo + t * BN + r;
    return p < hi ? p : -1;
  };
  auto slice = [&](int t, int& pos0, int& lim0, int& lim1) {
    pos0 = lo + t * BN + wn * NW;
    lim0 = lim[0];
    lim1 = lim[1];
  };
  repro::mma::State<HD> st;
  st.init();
  repro::mma::walk<HD, NW, kStages>(kp, vp, smem, BN, T, pos_of, row_of,
                                    slice, wn, qf, scale, st);
  const int z0 = blockIdx.z * 16 * WM;
  repro::mma::merge<HD>(st, smem, WN,
                        [&](int row, int d, float a0, float a1, float M,
                            float L) {
    const int m = z0 + row;
    if (m < R)
      sink.put<HD>(((size_t)b * C + m / G) * H + (size_t)kvh * G + m % G, d,
                   a0, a1, M, L);
  });
}

template <int HD, int NW>
cudaError_t launch_prefill(const void* q, const void* kp, const void* vp,
                           const void* bt, const void* q_offset,
                           const void* length, void* out, void* part, int B,
                           int C, int H, int KV, int page, int nblk,
                           int warps, int WM, int nsplit, float scale,
                           cudaStream_t stream) {
  const int smem = smem_bytes<HD>(warps / WM * NW, warps);
  if (smem > 227 * 1024 || (nblk + nsplit - 1) / nsplit > kMaxPages)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_mma_kernel<HD, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int R = C * (H / KV);
  const int ztiles = (R + 16 * WM - 1) / (16 * WM);
  prefill_mma_kernel<HD, NW>
      <<<dim3(B * KV, nsplit, ztiles), warps * 32, smem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
          (const __nv_bfloat16*)vp, (const int*)bt, (const int*)q_offset,
          (const int*)length,
          repro::mma::Sink{(__nv_bfloat16*)out, nullptr, nullptr, nullptr,
                           (float*)part},
          C, H, KV, page, nblk, WM, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return e;
  repro::mma::split_combine_kernel<HD><<<B * C * H, HD, 0, stream>>>(
      (const float*)part, nsplit, nullptr, nullptr, nullptr,
      (__nv_bfloat16*)out);
  return cudaGetLastError();
}

// NW = BN / WN positions a warp takes of each tile: BN = max(64, 16 WN)
template <int HD>
cudaError_t prefill_nw(const void* q, const void* kp, const void* vp,
                       const void* bt, const void* q_offset,
                       const void* length, void* out, void* part, int B,
                       int C, int H, int KV, int page, int nblk, int warps,
                       int WM, int nsplit, float scale, cudaStream_t s) {
  switch (warps / WM) {
    case 1:
      return launch_prefill<HD, 64>(q, kp, vp, bt, q_offset, length, out,
                                    part, B, C, H, KV, page, nblk, warps, WM,
                                    nsplit, scale, s);
    case 2:
      return launch_prefill<HD, 32>(q, kp, vp, bt, q_offset, length, out,
                                    part, B, C, H, KV, page, nblk, warps, WM,
                                    nsplit, scale, s);
    case 4:
    case 8:
      return launch_prefill<HD, 16>(q, kp, vp, bt, q_offset, length, out,
                                    part, B, C, H, KV, page, nblk, warps, WM,
                                    nsplit, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int HD, int NW>
int prefill_occupancy(int warps, int WM) {
  const int smem = smem_bytes<HD>(warps / WM * NW, warps);
  if (smem > 227 * 1024 ||
      (smem > 48 * 1024 &&
       cudaFuncSetAttribute(prefill_mma_kernel<HD, NW>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem) != cudaSuccess))
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, prefill_mma_kernel<HD, NW>, warps * 32, smem) != cudaSuccess)
    return 0;
  return n;
}

template <int HD>
int prefill_occupancy_nw(int warps, int WM) {
  switch (warps / WM) {
    case 1:
      return prefill_occupancy<HD, 64>(warps, WM);
    case 2:
      return prefill_occupancy<HD, 32>(warps, WM);
    case 4:
    case 8:
      return prefill_occupancy<HD, 16>(warps, WM);
    default:
      return 0;
  }
}

}  // namespace

// The blocks of the paged prefill at (hd, warps, wm) that one SM holds at
// once (0 for parameters it does not take): the wrapper splits the pages so
// that one wave of blocks fills the card.
extern "C" int repro_paged_prefill_bf16_occupancy(int hd, int warps, int wm) {
  if (warps < 1 || warps > 8 || wm < 1 || warps % wm != 0) return 0;
  switch (hd) {
    case 32:
      return prefill_occupancy_nw<32>(warps, wm);
    case 64:
      return prefill_occupancy_nw<64>(warps, wm);
    case 128:
      return prefill_occupancy_nw<128>(warps, wm);
    default:
      return 0;
  }
}

// q (B, C, H, hd) bf16; k_pool / v_pool (P, page, KV, hd) bf16;
// block_tables (B, nblk) int32; q_offset, length (B,) int32; out (B, C, H,
// hd) bf16.  warps = WM x WN (WM row-tile warps; WN in 1, 2, 4, 8, at most
// 8 warps), nsplit >= 1 splits of the valid pages, at most
// repro_paged_prefill_bf16_max_pages() table entries a split, ``part`` (B C
// H nsplit (hd + 2) fp32 scratch) when nsplit > 1.  hd in {32, 64, 128}, H % KV ==
// 0, 16-byte aligned pools (the wrapper checks).
// The block-table entries one split of the paged prefill takes at most.
extern "C" int repro_paged_prefill_bf16_max_pages() { return kMaxPages; }

extern "C" cudaError_t repro_paged_prefill_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* q_offset, const void* length,
    void* out, void* part, int B, int C, int H, int KV, int hd, int page,
    int nblk, int warps, int wm, int nsplit, float scale, void* stream) {
  if (B <= 0 || C <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || page <= 0 || nblk <= 0 || warps < 1 ||
      warps > 8 || wm < 1 || warps % wm != 0 || nsplit < 1 ||
      (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return prefill_nw<32>(q, k_pool, v_pool, block_tables, q_offset,
                            length, out, part, B, C, H, KV, page, nblk,
                            warps, wm, nsplit, scale, s);
    case 64:
      return prefill_nw<64>(q, k_pool, v_pool, block_tables, q_offset,
                            length, out, part, B, C, H, KV, page, nblk,
                            warps, wm, nsplit, scale, s);
    case 128:
      return prefill_nw<128>(q, k_pool, v_pool, block_tables, q_offset,
                             length, out, part, B, C, H, KV, page, nblk,
                             warps, wm, nsplit, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
