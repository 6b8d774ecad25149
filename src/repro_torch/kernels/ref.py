"""Plain PyTorch versions of the port's kernels (the ground truth for tests).

Each mirrors its oracle in the JAX package's ``kernels/ref.py`` line for
line: fp32 math, the same masking and the same output dtypes.  A kernel
wrapper runs these on CPU tensors; on the card they are what
``chip_smoke.py`` holds each CUDA kernel against.
"""
from __future__ import annotations

import torch

from repro_torch.quant.tensor import FP8_DTYPE, dequantize_values


def dotp(x, y):
    """x, y (K,) -> 0-d fp32: the fp32 sum of the fp32 products."""
    return torch.sum(x.float() * y.float())


def axpy(a, x, y):
    """a * x + y in fp32 (a multiply, then an add), in y's dtype."""
    return (a * x.float() + y.float()).to(y.dtype)


def gemv(w, x):
    """w (N,K), x (K,) -> (N,) fp32 accumulation."""
    return torch.mv(w.float(), x.float())


def batched_gemv(w, xs):
    """w (N,K), xs (B,K) -> (B,N): one fp32 gemv per row of xs."""
    return xs.float() @ w.float().t()


def qgemv(wq, scales, x, *, bits: int = 8):
    """Fused-dequant GEMV oracle: grouped dequant along K in fp32, then an
    fp32 product: wq (N, K | K/2-packed), scales (N, K/g), x (K,) or
    (B, K) -> (N,) or (B, N).  ``bits`` is explicit (4 = nibble-packed
    along K), never inferred."""
    w = dequantize_values(wq, scales, axis=-1, bits=bits)
    return x.float() @ w.t()


def batched_qgemv(wq, scales, xs, *, bits: int = 8):
    """xs (B, K) -> (B, N): the same oracle."""
    return qgemv(wq, scales, xs, bits=bits)


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * scale.float()).to(x.dtype)


def fused_adamw(p, g, mu, nu, *, lr, b1, b2, eps, wd, bc1, bc2):
    """One AdamW step: (p', mu', nu'), fp32 math, p' in p.dtype.  The
    hyper-parameters may be Python floats or 0-d fp32 tensors (the kernel's
    plain version passes tensors, so that ``1 - b1`` rounds in fp32 as in
    the kernel)."""
    g = g.float()
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    p32 = p.float()
    p32 = p32 - lr * (upd + wd * p32)
    return p32.to(p.dtype), mu, nu


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


def decode_attention_int8(q, k8, k_scale, v8, v_scale, length):
    """Quantized flash-decode oracle: dequantize the int8 cache (values x
    per-(token, head) scale, fp32), then the dense decode_attention
    oracle."""
    k = k8.float() * k_scale.float()
    v = v8.float() * v_scale.float()
    return decode_attention(q, k, v, length)


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


def batched_mx_qgemv(wq, scales, xs):
    """xs (B, K) -> (B, N): the MX GEMV oracle on every row."""
    return mx_qgemv(wq, scales, xs)


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


def flash_attention(q, k, v, causal=True):
    """q (B,T,H,hd), k/v (B,S,KV,hd) -> (B,T,H,hd) fp32: the full softmax
    over all S positions; with ``causal`` position s is masked for query t
    when s > t (aligned at the top left, as SDPA's ``is_causal``)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, hd).float()
    s = torch.einsum("btkgh,bskh->bkgts", qg, k.float()) * (hd ** -0.5)
    if causal:
        mask = (torch.arange(T, device=q.device)[:, None]
                < torch.arange(S, device=q.device)[None, :])
        s = s.masked_fill(mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskh->btkgh", p, v.float())
    return o.reshape(B, T, H, hd)


def wkv6(r, k, v, w, u, state0):
    """The RWKV-6 recurrence, one fp32 step at a time from ``state0``
    (the JAX package's ``models/rwkv.py:wkv6_scan``).

    r, k, v, w (B,T,H,hd); u (H,hd); state0 (B,H,hd,hd) ->
    (y (B,T,H,hd) fp32, state (B,H,hd,hd) fp32):
    y_t = r_t S_{t-1} + (r_t . (u k_t)) v_t,
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    """
    r, k, v, w = (a.float() for a in (r, k, v, w))
    S = state0.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B,H,hd)
        y = torch.einsum("bhi,bhij->bhj", rt, S)
        y = y + torch.sum(rt * u[None] * kt, -1, keepdim=True) * vt
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
        ys.append(y)
    return torch.stack(ys, dim=1), S


def mamba_scan(x, dt, B, C, A, D, state0):
    """The selective scan, one fp32 step at a time from ``state0`` (the JAX
    package's ``models/mamba.py:_ssm_scan``).

    x, dt (b,T,di); B, C (b,T,ds); A (di,ds) < 0; D (di,); state0
    (b,di,ds) -> (y (b,T,di) fp32, state (b,di,ds) fp32):
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t;  y_t = C_t . h_t + D x_t
    """
    u, dt, B_in, C = (a.float() for a in (x, dt, B, C))
    dA = torch.exp(dt[..., None] * A[None, None])              # (b,T,di,ds)
    dBu = dt[..., None] * B_in[:, :, None, :] * u[..., None]
    h = state0.float()
    ys = []
    for t in range(u.shape[1]):
        h = dA[:, t] * h + dBu[:, t]
        ys.append(torch.einsum("bds,bs->bd", h, C[:, t]))
    y = torch.stack(ys, dim=1) + u * D[None, None]
    return y, h
