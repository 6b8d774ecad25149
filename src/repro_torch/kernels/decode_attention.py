"""Decode attention over bf16 or int8 page pools and over a dense bf16 or
int8 cache: the wrappers of ``csrc/decode_attention.cu``, their launch
counts, their plain versions and their registry entries.

Replace the JAX package's Pallas
``kernels/decode_attention.py:paged_decode_attention``,
``paged_decode_attention_int8``, ``decode_attention_stats``,
``decode_attention`` and ``decode_attention_int8``.  The CUDA kernels are
bound by the K/V bytes they stream; ``csrc/decode_attention.cu`` says how
their design meets that.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.quant.tensor import quantize_kv
from repro_torch.tune.registry import itemsize, meta, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain versions do not count)
launches = 0
int8_launches = 0
dense_launches = 0
dense_int8_launches = 0

# the JAX kernels' mask value (``_NEG``): a masked score, and the running
# max of a row that has seen no valid position
NEG = -1e30

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = {
    "repro_paged_decode_bf16": [_P] * 7 + [_I] * 8 + [_F, _P],
    "repro_paged_decode_int8": [_P] * 9 + [_I] * 8 + [_F, _P],
    "repro_paged_decode_bf16_occupancy": [_I] * 2,
    "repro_paged_decode_int8_occupancy": [_I] * 2,
    "repro_paged_decode_max_pages": [],
    "repro_decode_dense_bf16": [_P] * 9 + [_I] * 10 + [_F, _P],
    "repro_decode_dense_bf16_occupancy": [_I] * 3,
    "repro_decode_dense_int8": [_P] * 8 + [_I] * 9 + [_F, _P],
    "repro_decode_dense_int8_occupancy": [_I] * 3,
}


def plain(q, k_pool, v_pool, block_tables, length):
    """The plain PyTorch version: gather, softmax, output in q.dtype."""
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                      length).to(q.dtype)


def plain_int8(q, k_pool, k_scales, v_pool, v_scales, block_tables, length):
    """The plain PyTorch version: gather, dequantize in fp32, softmax,
    output in q.dtype."""
    return ref.paged_decode_attention_int8(q, k_pool, k_scales, v_pool,
                                           v_scales, block_tables,
                                           length).to(q.dtype)


def check_paged(name, q, k_pool, v_pool, block_tables, *vecs,
                pool_dtype=torch.bfloat16):
    """Shared argument checks of the paged-attention kernels."""
    B, nblk = block_tables.shape
    KV, hd = k_pool.shape[2], k_pool.shape[3]
    H = q.shape[-2]
    dev = q.device
    ok = (q.dtype == torch.bfloat16
          and k_pool.dtype == v_pool.dtype == pool_dtype
          and k_pool.shape == v_pool.shape and q.shape[-1] == hd
          and hd in (32, 64, 128) and H % KV == 0 and q.shape[0] == B
          and block_tables.dtype == torch.int32
          and all(t.device == dev for t in (k_pool, v_pool, block_tables))
          and all(t.is_contiguous()
                  for t in (q, k_pool, v_pool, block_tables))
          and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0
          and all(v.dtype == torch.int32 and v.shape == (B,)
                  and v.device == dev and v.is_contiguous() for v in vecs))
    if not ok:
        raise ValueError(
            f"{name} kernel takes contiguous bf16 q {tuple(q.shape)} and "
            f"{pool_dtype} pools (P, page, KV, hd in 32/64/128) "
            f"{tuple(k_pool.shape)} {k_pool.dtype}, "
            f"int32 block_tables (B, nblk) {tuple(block_tables.shape)} and "
            f"int32 (B,) vectors, all on one device")


def paged_decode_plan(B: int, H: int, KV: int, page: int, nblk: int,
                      cfg: LaunchConfig, resident: int,
                      max_pages: int) -> dict:
    """The launch of the paged decode, bf16 or int8 pages: one block per
    (slot, KV head, split, m-tile of 16 of the G query heads), ``warps`` =
    ``cfg.decode_warps`` warps of 16 positions of each staged tile of
    ``bn``.  The splits are whole pages of a slot's valid positions, at
    most ``pages`` table entries each (``max_pages``: the block's shared
    page list); their count comes from the table's capacity, never from
    the lengths: as many as fill one wave of the ``resident`` blocks the
    card holds at once (``wave_splits``; at G = 1 too, where one split a
    slot measured slower), and at least as many as ``max_pages`` asks."""
    if not 1 <= cfg.decode_warps <= 8:
        raise ValueError(f"paged decode: decode_warps must be 1 to 8; got "
                         f"{cfg.decode_warps}")
    G = H // KV
    mtiles = -(-G // 16)
    nsplit = max(wave_splits(B * KV * mtiles, nblk * page, resident),
                 -(-nblk // max_pages))
    return {"grid": (B * KV, nsplit, mtiles), "nsplit": nsplit,
            "bn": 16 * cfg.decode_warps, "warps": cfg.decode_warps,
            "pages": -(-nblk // nsplit)}


def _paged(name, q, k_pool, v_pool, k_scales, v_scales, block_tables,
           length, cfg):
    """Launch the tensor-core paged decode (int8 pages when the scale
    pools are given) at ``paged_decode_plan``; returns the bf16 output."""
    B, H, hd = q.shape
    page, KV = k_pool.shape[1], k_pool.shape[2]
    nblk = block_tables.shape[1]
    dev = q.device
    int8 = k_scales is not None
    lib = _build.library("decode_attention", _ARGTYPES)
    occupancy = (lib.repro_paged_decode_int8_occupancy if int8 else
                 lib.repro_paged_decode_bf16_occupancy)
    plan = paged_decode_plan(
        B, H, KV, page, nblk, cfg,
        _build.resident(dev, occupancy, hd, cfg.decode_warps),
        lib.repro_paged_decode_max_pages())
    out = torch.empty_like(q)
    part = torch.empty((B * H * plan["nsplit"], hd + 2), dtype=torch.float32,
                       device=dev) if plan["nsplit"] > 1 else None
    pools = ((k_pool, k_scales, v_pool, v_scales) if int8 else
             (k_pool, v_pool))
    fn = lib.repro_paged_decode_int8 if int8 else lib.repro_paged_decode_bf16
    err = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
             block_tables.data_ptr(), length.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), B, H, KV, hd, page,
             nblk, cfg.decode_warps, plan["nsplit"], hd ** -0.5,
             _build.stream_handle(dev))
    _build.check(err, name)
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, length,
                           cfg: LaunchConfig = DEFAULT):
    """Flash-decode over a paged KV cache.

    q (B,H,hd); k_pool/v_pool (P,page,KV,hd); block_tables (B,nblk) int32
    mapping logical block -> physical page; length (B,) int32 valid prefix.
    Returns (B,H,hd) in q.dtype.  The kernel (``paged_decode_plan``) reads
    each page once for all the query heads of a KV head and runs both
    products on the tensor cores; ``cfg.decode_warps`` warps of 16
    positions a block.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    global launches
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, block_tables, length)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    check_paged("paged_decode_attention", q, k_pool, v_pool, block_tables,
                length)
    out = _paged("paged_decode_attention", q, k_pool, v_pool, None, None,
                 block_tables, length, cfg)
    launches += 1
    return out


def paged_decode_attention_int8(q, k_pool, k_scales, v_pool, v_scales,
                                block_tables, length,
                                cfg: LaunchConfig = DEFAULT):
    """Flash-decode over int8 page pools with per-(token, head) scale
    pages.

    q (B,H,hd); k_pool/v_pool (P,page,KV,hd) int8; k_scales/v_scales
    (P,page,KV,1) bf16 at the same page indices; block_tables (B,nblk)
    int32; length (B,) int32.  Returns (B,H,hd) in q.dtype.  The kernel is
    ``paged_decode_attention``'s launch over the int8 pages: each warp
    stages its positions' int8 rows and scales, the codes become bf16
    exactly, and the K and V scales multiply the scores' and P's columns.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    global int8_launches
    if q.device.type == "cpu":
        return plain_int8(q, k_pool, k_scales, v_pool, v_scales,
                          block_tables, length)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_int8: unsupported device "
                         f"{q.device}")
    check_paged("paged_decode_attention_int8", q, k_pool, v_pool,
                block_tables, length, pool_dtype=torch.int8)
    sshape = k_pool.shape[:3] + (1,)
    if not all(s.dtype == torch.bfloat16 and s.shape == sshape
               and s.device == q.device and s.is_contiguous()
               for s in (k_scales, v_scales)):
        raise ValueError(f"paged_decode_attention_int8 kernel takes "
                         f"contiguous bf16 scale pools {sshape}; got "
                         f"{tuple(k_scales.shape)} {k_scales.dtype}")
    out = _paged("paged_decode_attention_int8", q, k_pool, v_pool, k_scales,
                 v_scales, block_tables, length, cfg)
    int8_launches += 1
    return out


# --------------------------------------------------------------------------
# Dense cache: unnormalized partials, then the normalized output
# --------------------------------------------------------------------------
def plain_stats(q, k, v, length, s_offset: int = 0):
    """The plain PyTorch version of ``decode_attention_stats``: fp32 (acc
    (B,KV,G,hd), m (B,KV,G,1), l (B,KV,G,1)); a row with no valid position
    gives acc = 0, l = 0, m = -1e30."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * (hd ** -0.5)
    n = torch.clamp(length.long() - s_offset, min=0)
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            >= n[:, None, None, None])
    s = s.masked_fill(mask, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return acc, m, l


def _normalize(q, acc, l):
    B, H, hd = q.shape
    return (acc / torch.clamp(l, min=1e-30)).reshape(B, H, hd).to(q.dtype)


def plain_dense(q, k, v, length):
    """The plain PyTorch version of ``decode_attention``: (B,H,hd) in
    q.dtype."""
    acc, _, l = plain_stats(q, k, v, length)
    return _normalize(q, acc, l)


def wave_splits(blocks: int, S: int, resident: int) -> int:
    """Splits of the tensor-core kernels' walk over at most S positions:
    as many as let ``blocks`` blocks a split fill one wave of the
    ``resident`` blocks the card holds at once (at least one), each split
    at least 256 positions."""
    return max(1, min(resident // blocks, -(-S // 256)))


def decode_plan(B: int, H: int, KV: int, S: int, cfg: LaunchConfig,
                resident: int) -> dict:
    """The launch of the dense decode, bf16 or int8 cache: one block per
    (slot, KV head, split, m-tile of 16 of the G query heads), ``warps``
    warps of 16 positions of each staged tile of ``bn`` = block_k / 4
    positions, whose ``streams`` contiguous parts of a split are walked
    side by side; ``stages`` the ring depth (the block's, or each warp's
    for int8); ``resident``: the blocks of the kernel the card holds at
    once."""
    G = H // KV
    mtiles = -(-G // 16)
    nsplit = wave_splits(B * KV * mtiles, S, resident)
    bn = cfg.block_k // 4
    return {"grid": (B * KV, nsplit, mtiles), "nsplit": nsplit, "bn": bn,
            "warps": bn // 16, "stages": 2 if cfg.unroll == 1 else 3}


def _dense_bf16(name, q, k, v, length, cfg, s_offset=0, normalized=False):
    """Launch the tensor-core dense decode: fp32 (acc, m, l), or the bf16
    output normalized in the kernel (``normalized``)."""
    global dense_launches
    _check_dense(name, q, k, v, length, torch.bfloat16)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    dev = q.device
    G = H // KV
    if normalized:
        out, stats = torch.empty_like(q), (None, None, None)
    else:
        out = None
        stats = (torch.empty((B, KV, G, hd), dtype=torch.float32, device=dev),
                 torch.empty((B, KV, G, 1), dtype=torch.float32, device=dev),
                 torch.empty((B, KV, G, 1), dtype=torch.float32, device=dev))
    lib = _build.library("decode_attention", _ARGTYPES)
    resident = _build.resident(
        dev, lib.repro_decode_dense_bf16_occupancy, hd, cfg.unroll,
        cfg.block_k)
    nsplit = decode_plan(B, H, KV, S, cfg, resident)["nsplit"]
    part = torch.empty((B * H * nsplit, hd + 2), dtype=torch.float32,
                       device=dev) if nsplit > 1 else None
    err = lib.repro_decode_dense_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        *(None if t is None else t.data_ptr() for t in stats),
        None if out is None else out.data_ptr(),
        None if part is None else part.data_ptr(), B, S, H, KV, hd,
        int(s_offset), cfg.streams, cfg.unroll, cfg.block_k, nsplit,
        hd ** -0.5, _build.stream_handle(dev))
    _build.check(err, name)
    dense_launches += 1
    return out if normalized else stats


def decode_attention_stats(q, k, v, length, cfg: LaunchConfig = DEFAULT,
                           s_offset: int = 0):
    """Flash-decode partials over a dense KV cache: q (B,H,hd); k, v
    (B,S,KV,hd); length (B,) int32, of which the positions [0, max(length
    - s_offset, 0)) of this cache are valid (``s_offset``: where this
    shard of a split-S cache starts).  Returns fp32 (acc (B,KV,G,hd),
    m (B,KV,G,1), l (B,KV,G,1)), unnormalized, for ``lse_combine``.

    The kernel (``decode_plan``) takes one block per (slot, KV head,
    split, m-tile of 16 query heads): the G query heads of a KV head share
    each K/V tile, which is read once, and both products run on the tensor
    cores.  A tile holds ``cfg.block_k / 4`` positions, of ``cfg.streams``
    contiguous parts of the split walked side by side; ``cfg.unroll`` 1
    keeps two tiles in flight, else three.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16 q, k, v, hd in
    32/64/128, H % KV == 0, contiguous) or raises."""
    if q.device.type == "cpu":
        return plain_stats(q, k, v, length, s_offset)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_stats: unsupported device "
                         f"{q.device}")
    return _dense_bf16("decode_attention_stats", q, k, v, length, cfg,
                       s_offset)


def plain_dense_int8(q, k8, k_scale, v8, v_scale, length):
    """The plain PyTorch version of ``decode_attention_int8``: the int8
    cache dequantized in fp32, then ``plain_dense`` ((B,H,hd) in q.dtype;
    a row with no valid position gives 0)."""
    return plain_dense(q, k8.float() * k_scale.float(),
                       v8.float() * v_scale.float(), length)


def _check_dense(name, q, k, v, length, dtype, scales=()):
    B, H, hd = q.shape
    dev = q.device
    sshape = tuple(k.shape[:3]) + (1,)
    if not (q.dtype == torch.bfloat16 and k.dtype == v.dtype == dtype
            and k.dim() == 4 and k.shape == v.shape and k.shape[0] == B
            and k.shape[3] == hd and hd in (32, 64, 128)
            and H % k.shape[2] == 0
            and length.dtype == torch.int32 and length.shape == (B,)
            and all(s.dtype == torch.bfloat16 and s.shape == sshape
                    for s in scales)
            and all(t.device == dev and t.is_contiguous()
                    for t in (q, k, v, length, *scales))
            and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0):
        what = "" if not scales else f" with bf16 scales {sshape}"
        raise ValueError(
            f"{name} kernel takes contiguous bf16 q (B, H, hd), {dtype} k "
            f"and v (B, S, KV, hd in 32/64/128){what} and int32 length "
            f"(B,) on one device; got q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)} {k.dtype}, length {tuple(length.shape)} "
            f"{length.dtype}")


def decode_attention_int8(q, k8, k_scale, v8, v_scale, length,
                          cfg: LaunchConfig = DEFAULT):
    """q (B,H,hd); k8, v8 (B,S,KV,hd) int8 with per-(position, KV head)
    bf16 scales k_scale, v_scale (B,S,KV,1); length (B,) int32 valid
    prefix -> (B,H,hd) in q.dtype; a row with no valid position gives 0.

    The kernel is ``decode_attention``'s tensor-core launch (``decode_plan``,
    the same knobs) over the int8 cache: each warp stages its positions'
    int8 rows and scales, the codes become bf16 exactly, and the K and V
    scales multiply the scores' and P's columns; whichever of its kernel
    and the split combine writes last normalizes.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    global dense_int8_launches
    if q.device.type == "cpu":
        return plain_dense_int8(q, k8, k_scale, v8, v_scale, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: unsupported device "
                         f"{q.device}")
    _check_dense("decode_attention_int8", q, k8, v8, length, torch.int8,
                 (k_scale, v_scale))
    B, H, hd = q.shape
    S, KV = k8.shape[1], k8.shape[2]
    dev = q.device
    lib = _build.library("decode_attention", _ARGTYPES)
    resident = _build.resident(
        dev, lib.repro_decode_dense_int8_occupancy, hd, cfg.unroll,
        cfg.block_k)
    nsplit = decode_plan(B, H, KV, S, cfg, resident)["nsplit"]
    out = torch.empty_like(q)
    part = torch.empty((B * H * nsplit, hd + 2), dtype=torch.float32,
                       device=dev) if nsplit > 1 else None
    err = lib.repro_decode_dense_int8(
        q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
        v_scale.data_ptr(), length.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B, S, H, KV, hd,
        cfg.streams, cfg.unroll, cfg.block_k, nsplit, hd ** -0.5,
        _build.stream_handle(dev))
    _build.check(err, "decode_attention_int8")
    dense_int8_launches += 1
    return out


def decode_attention(q, k, v, length, cfg: LaunchConfig = DEFAULT):
    """q (B,H,hd); k, v (B,S,KV,hd); length (B,) valid prefix -> (B,H,hd)
    in q.dtype: ``decode_attention_stats``'s partials normalized by max(l,
    1e-30) (a row with no valid position gives 0).  The JAX package
    normalizes outside its ``pallas_call``; the CUDA kernel normalizes in
    its last stage, which saves the launches of a separate division.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if q.device.type == "cpu":
        return plain_dense(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _dense_bf16("decode_attention", q, k, v, length, cfg,
                       normalized=True)


# --------------------------------------------------------------------------
# registry entries (the JAX package's cost models and example shapes)
# --------------------------------------------------------------------------
def _example(small: bool = True, device=None):
    B, H, KV, hd, S = (2, 4, 2, 128, 512) if small else (4, 16, 8, 128, 4096)
    q = seeded(0, (B, H, hd), device=device)
    k = seeded(1, (B, S, KV, hd), device=device)
    v = seeded(2, (B, S, KV, hd), device=device)
    length = torch.full((B,), S, dtype=torch.int32, device=q.device)
    return (q, k, v, length), {}


def _int8_example(small: bool = True, device=None):
    """The JAX ``_int8_example``: the dense example's cache through
    ``quantize_kv``."""
    (q, k, v, length), _ = _example(small, device)
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    return (q, k8, ks, v8, vs, length), {}


def _paged_example(small: bool = True, device=None):
    B, H, KV, hd, page, nblk = (2, 4, 2, 128, 16, 4) if small \
        else (4, 16, 8, 128, 16, 16)
    P = 1 + B * nblk
    q = seeded(0, (B, H, hd), device=device)
    k_pool = seeded(1, (P, page, KV, hd), device=device)
    v_pool = seeded(2, (P, page, KV, hd), device=device)
    # permuted tables: physically scattered pages, logically contiguous
    perm = np.random.default_rng(0).permutation(P - 1) + 1
    bt = torch.as_tensor(perm[:B * nblk].reshape(B, nblk).astype(np.int32),
                         device=q.device)
    length = torch.as_tensor(
        np.asarray([max(1, nblk * page - 5 * i) for i in range(B)],
                   np.int32), device=q.device)
    return (q, k_pool, v_pool, bt, length), {}


def _paged_int8_example(small: bool = True, device=None):
    (q, k_pool, v_pool, bt, length), _ = _paged_example(small, device)
    k8, ks = quantize_kv(k_pool)
    v8, vs = quantize_kv(v_pool)
    return (q, k8, ks, v8, vs, bt, length), {}


def _paged_streamed(q, kp, vp, bt, ln):
    """Per-slot page traffic (nblk pages each for k and v), not pool size."""
    view = (q.shape[0], bt.shape[1] * kp.shape[1], kp.shape[2], kp.shape[3])
    return [meta(view, kp.dtype), meta(view, vp.dtype), q, q, bt]


def _paged_int8_streamed(q, kp, ks, vp, vs, bt, ln):
    B, nblk, page, KV, hd = (q.shape[0], bt.shape[1], kp.shape[1],
                             kp.shape[2], kp.shape[3])
    view = (B, nblk * page, KV, hd)
    sview = (B, nblk * page, KV, 1)
    return [meta(view, kp.dtype), meta(view, vp.dtype),
            meta(sview, ks.dtype), meta(sview, vs.dtype), q, q, bt]


#: ``decode_attention`` through the tune registry
decode_attention_tuned = troop_kernel(
    "decode_attention",
    flops=lambda q, k, v, ln: (4.0 * q.shape[0] * q.shape[1]
                               * k.shape[1] * k.shape[3]),
    bytes=lambda q, k, v, ln: (
        k.shape[0] * k.shape[1] * k.shape[2] * k.shape[3]
        * (itemsize(k) + itemsize(v))
        + q.shape[0] * q.shape[1] * q.shape[2] * 2 * itemsize(q)),
    streamed=lambda q, k, v, ln: [k, v, q, q],   # cache + q in + q-like out
    space={"streams": (1, 2), "unroll": (1, 2), "block_k": (256, 512)},
    ref="decode_attention", example=_example)(decode_attention)

#: ``decode_attention_int8`` through the tune registry (the JAX space:
#: one stream)
decode_attention_int8_tuned = troop_kernel(
    "decode_attention_int8",
    flops=lambda q, k8, ks, v8, vs, ln: (4.0 * q.shape[0] * q.shape[1]
                                         * k8.shape[1] * k8.shape[3]),
    # the scale tensors are streamed too (one row per cache row)
    bytes=lambda q, k8, ks, v8, vs, ln: (
        k8.shape[0] * k8.shape[1] * k8.shape[2] * k8.shape[3]
        * (itemsize(k8) + itemsize(v8))
        + k8.shape[0] * k8.shape[1] * k8.shape[2]
        * (itemsize(ks) + itemsize(vs))
        + q.shape[0] * q.shape[1] * q.shape[2] * 2 * itemsize(q)),
    streamed=lambda q, k8, ks, v8, vs, ln: [k8, v8, ks, vs, q, q],
    space={"streams": (1,), "unroll": (1, 2), "block_k": (256, 512)},
    default=LaunchConfig(streams=1), ref="decode_attention_int8",
    example=_int8_example)(decode_attention_int8)

#: ``paged_decode_attention`` through the tune registry
paged_decode_attention_tuned = troop_kernel(
    "paged_decode_attention",
    flops=lambda q, kp, vp, bt, ln: (4.0 * q.shape[0] * q.shape[1]
                                     * bt.shape[1] * kp.shape[1]
                                     * q.shape[2]),
    bytes=lambda q, kp, vp, bt, ln: (
        q.shape[0] * bt.shape[1] * kp.shape[1] * kp.shape[2] * kp.shape[3]
        * (itemsize(kp) + itemsize(vp))
        + q.shape[0] * q.shape[1] * q.shape[2] * 2 * itemsize(q)
        + bt.shape[0] * bt.shape[1] * itemsize(bt)),
    streamed=_paged_streamed,
    space={"decode_warps": (2, 4, 8)},
    ref="paged_decode_attention",
    example=_paged_example)(paged_decode_attention)

#: ``paged_decode_attention_int8`` through the tune registry
paged_decode_attention_int8_tuned = troop_kernel(
    "paged_decode_attention_int8",
    flops=lambda q, kp, ks, vp, vs, bt, ln: (
        4.0 * q.shape[0] * q.shape[1] * bt.shape[1] * kp.shape[1]
        * q.shape[2]),
    # per-slot page traffic at quantized width + scale pages + q io + table
    bytes=lambda q, kp, ks, vp, vs, bt, ln: (
        q.shape[0] * bt.shape[1] * kp.shape[1] * kp.shape[2] * kp.shape[3]
        * (itemsize(kp) + itemsize(vp))
        + q.shape[0] * bt.shape[1] * kp.shape[1] * kp.shape[2]
        * (itemsize(ks) + itemsize(vs))
        + q.shape[0] * q.shape[1] * q.shape[2] * 2 * itemsize(q)
        + bt.shape[0] * bt.shape[1] * itemsize(bt)),
    streamed=_paged_int8_streamed,
    space={"decode_warps": (2, 4, 8)},
    ref="paged_decode_attention_int8",
    example=_paged_int8_example)(paged_decode_attention_int8)
