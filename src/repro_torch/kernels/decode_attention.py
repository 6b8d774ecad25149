"""Paged decode attention: the wrapper of ``csrc/decode_attention.cu``, its
launch count and its plain version.

Replaces the JAX package's Pallas
``kernels/decode_attention.py:paged_decode_attention``.  The CUDA kernel is
bound by the K/V bytes it streams; ``csrc/decode_attention.cu`` says how its
design meets that.
"""
from __future__ import annotations

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGTYPES = {"repro_paged_decode_bf16": [
    _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.I,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.F,
    _build.P]}


def plain(q, k_pool, v_pool, block_tables, length):
    """The plain PyTorch version: gather, softmax, output in q.dtype."""
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                      length).to(q.dtype)


def check_paged(name, q, k_pool, v_pool, block_tables, *vecs):
    """Shared argument checks of the two paged-attention kernels."""
    B, nblk = block_tables.shape
    KV, hd = k_pool.shape[2], k_pool.shape[3]
    H = q.shape[-2]
    dev = q.device
    ok = (q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16
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
            f"pools (P, page, KV, hd in 32/64/128) {tuple(k_pool.shape)}, "
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
