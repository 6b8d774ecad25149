"""Paged decode attention over bf16 or int8 page pools: the wrappers of
``csrc/decode_attention.cu``, their launch counts and their plain versions.

Replace the JAX package's Pallas
``kernels/decode_attention.py:paged_decode_attention`` and
``paged_decode_attention_int8``.  The CUDA kernels are bound by the K/V
bytes they stream; ``csrc/decode_attention.cu`` says how their design meets
that.
"""
from __future__ import annotations

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: kernel launches so far (the CPU path and the plain versions do not count)
launches = 0
int8_launches = 0

_P, _I, _F = _build.P, _build.I, _build.F
_ARGTYPES = {
    "repro_paged_decode_bf16": [_P] * 6 + [_I] * 7 + [_F, _P],
    "repro_paged_decode_int8": [_P] * 8 + [_I] * 7 + [_F, _P],
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


def paged_decode_attention(q, k_pool, v_pool, block_tables, length,
                           cfg: LaunchConfig = DEFAULT):
    """Flash-decode over a paged KV cache.

    q (B,H,hd); k_pool/v_pool (P,page,KV,hd); block_tables (B,nblk) int32
    mapping logical block -> physical page; length (B,) int32 valid prefix.
    Returns (B,H,hd) in q.dtype.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    global launches
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, block_tables, length)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    check_paged("paged_decode_attention", q, k_pool, v_pool, block_tables,
                length)
    B, H, hd = q.shape
    page, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty_like(q)
    lib = _build.library("decode_attention", _ARGTYPES)
    err = lib.repro_paged_decode_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), length.data_ptr(), out.data_ptr(), B, H, KV,
        hd, page, block_tables.shape[1], cfg.decode_warps, hd ** -0.5,
        _build.stream_handle(q.device))
    _build.check(err, "paged_decode_attention")
    launches += 1
    return out


def paged_decode_attention_int8(q, k_pool, k_scales, v_pool, v_scales,
                                block_tables, length,
                                cfg: LaunchConfig = DEFAULT):
    """Flash-decode over int8 page pools with per-(token, head) scale
    pages.

    q (B,H,hd); k_pool/v_pool (P,page,KV,hd) int8; k_scales/v_scales
    (P,page,KV,1) bf16 at the same page indices; block_tables (B,nblk)
    int32; length (B,) int32.  Returns (B,H,hd) in q.dtype.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
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
    B, H, hd = q.shape
    page, KV = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty_like(q)
    lib = _build.library("decode_attention", _ARGTYPES)
    err = lib.repro_paged_decode_int8(
        q.data_ptr(), k_pool.data_ptr(), k_scales.data_ptr(),
        v_pool.data_ptr(), v_scales.data_ptr(), block_tables.data_ptr(),
        length.data_ptr(), out.data_ptr(), B, H, KV, hd, page,
        block_tables.shape[1], cfg.decode_warps, hd ** -0.5,
        _build.stream_handle(q.device))
    _build.check(err, "paged_decode_attention_int8")
    int8_launches += 1
    return out
