"""Plain PyTorch versions of the port's kernels (the ground truth for tests).

Each mirrors its oracle in the JAX package's ``kernels/ref.py`` line for
line: fp32 math, the same masking and the same output dtypes.  A kernel
wrapper runs these on CPU tensors; on the card they are what
``chip_smoke.py`` holds each CUDA kernel against.
"""
from __future__ import annotations

import torch

from repro_torch.quant.tensor import FP8_DTYPE, dequantize_values


def gemv(w, x):
    """w (N,K), x (K,) -> (N,) fp32 accumulation."""
    return torch.mv(w.float(), x.float())


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * scale.float()).to(x.dtype)


def decode_attention(q, k, v, length):
    """q (B,H,hd); k,v (B,S,KV,hd); length (B,) valid prefix. -> (B,H,hd) fp32.

    GQA flash-decode oracle: full softmax over the valid prefix.
    """
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * (hd ** -0.5)
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            >= length.long()[:, None, None, None])
    scores = scores.masked_fill(mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v.float())
    return out.reshape(B, H, hd)


def paged_decode_attention(q, k_pool, v_pool, block_tables, length):
    """Paged flash-decode oracle: gather the block table to the dense
    logical view, then the dense decode_attention oracle."""
    B, nblk = block_tables.shape
    page, KV, hd = k_pool.shape[1:]
    bt = block_tables.long()
    k = k_pool[bt].reshape(B, nblk * page, KV, hd)
    v = v_pool[bt].reshape(B, nblk * page, KV, hd)
    return decode_attention(q, k, v, length)


def paged_decode_attention_int8(q, k_pool, k_scales, v_pool, v_scales,
                                block_tables, length):
    """Quantized paged oracle: gather value AND scale pages through the
    block table, dequantize the logical view in fp32, then the dense
    decode_attention oracle."""
    B, nblk = block_tables.shape
    page, KV, hd = k_pool.shape[1:]
    bt = block_tables.long()
    k = k_pool[bt].float() * k_scales[bt].float()
    v = v_pool[bt].float() * v_scales[bt].float()
    return decode_attention(q, k.reshape(B, nblk * page, KV, hd),
                            v.reshape(B, nblk * page, KV, hd), length)


def _mx_dequant(wq, scales):
    """Stored-layout MX dequant: (K | K/2-packed, N) codes + (K/32, N) E8M0
    -> (K, N) fp32.  fp4 (uint8) vs fp8 (float8_e4m3fn) by dtype."""
    bits = 8 if wq.dtype == FP8_DTYPE else 4
    return dequantize_values(wq, scales, axis=-2, bits=bits, fmt="mx")


def mx_qgemv(wq, scales, x):
    """MX GEMV oracle: x (K,) or (B, K) -> (N,) or (B, N), block-exponent
    dequant then an fp32 product."""
    return x.float() @ _mx_dequant(wq, scales)


def mx_qgemv_swiglu(wg, sg, wu, su, x):
    """Fused MX swiglu oracle: silu(x.Wg) * (x.Wu), all fp32."""
    g = mx_qgemv(wg, sg, x)
    u = mx_qgemv(wu, su, x)
    return g * torch.sigmoid(g) * u


def grouped_expert_qgemv(wq, scales, xs, expert_ids):
    """Grouped MX expert oracle: take the selected experts' codes and
    scales (E8M0 blocks along K), dequantize them in fp32, then one fp32
    product per (row, expert): xs (topk, K), expert_ids (topk,) ->
    (topk, N)."""
    ids = expert_ids.long()
    sel = wq.view(torch.uint8).index_select(0, ids).view(wq.dtype)
    w = _mx_dequant(sel, scales.index_select(0, ids))      # (topk, K, N)
    return torch.einsum("tk,tkn->tn", xs.float(), w)


def prefill_attention_paged(q, k_pool, v_pool, block_tables, q_offset,
                            length):
    """Chunked-prefill paged-attention oracle: gather the block table to
    the dense logical view, then causal softmax attention with the slab's
    absolute query offset (positions >= length masked)."""
    B, C, H, hd = q.shape
    nblk = block_tables.shape[1]
    page, KV = k_pool.shape[1], k_pool.shape[2]
    S = nblk * page
    G = H // KV
    bt = block_tables.long()
    k = k_pool[bt].reshape(B, S, KV, hd).float()
    v = v_pool[bt].reshape(B, S, KV, hd).float()
    qg = q.reshape(B, C, KV, G, hd).float()
    s = torch.einsum("btkgh,bskh->bkgts", qg, k) * (hd ** -0.5)
    ar = torch.arange(max(C, S), device=q.device)
    qpos = q_offset.long()[:, None] + ar[None, :C]              # (B, C)
    spos = ar[None, :S]                                         # (1, S)
    mask = (spos[:, None, :] > qpos[:, :, None]) \
        | (spos[:, None, :] >= length.long()[:, None, None])    # (B, C, S)
    s = s.masked_fill(mask[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)           # fully masked pad rows
    o = torch.einsum("bkgts,bskh->btkgh", p, v)
    return o.reshape(B, C, H, hd)
