"""GQA attention (RoPE, qkv bias) against the paged KV cache.

The port of the paged path of ``repro.models.attention``: the plain
(gathered dense view) path is the reference, and ``use_kernel`` streams the
pools through the paged CUDA kernels instead.  The page pools are updated in
place (``index_put_``): that is what JAX's buffer donation does for the
jitted step, without a second copy of the pools.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import modules as M
from repro_torch.serve.kvcache import NULL_PAGE, PagedKVCache, PageSpec


def attention_init(cfg, *, dtype, generator, device) -> nn.ModuleDict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, generator=generator, device=device)
    return nn.ModuleDict({
        "wq": M.dense_init(d, H * hd, bias=cfg.qkv_bias, **kw),
        "wk": M.dense_init(d, KV * hd, bias=cfg.qkv_bias, **kw),
        "wv": M.dense_init(d, KV * hd, bias=cfg.qkv_bias, **kw),
        "wo": M.dense_init(H * hd, d, bias=False, **kw),
    })


def attend(q, k, v, *, causal: bool, q_offset=0,
           length: Optional[torch.Tensor] = None):
    """q: (B,T,H,hd) k/v: (B,S,KV,hd). GQA via head grouping. fp32 softmax.

    ``q_offset``: absolute position of q[0] (causal masking w/ cache), an
    int or a tensor broadcastable to (B,1,1,T,1).  ``length``: valid prefix
    length of k/v.
    """
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    q = q.reshape(B, T, KV, G, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    spos = torch.arange(S, device=q.device)[None, None, None, None, :]
    mask = torch.zeros((), dtype=torch.bool, device=q.device)
    if causal:
        qpos = q_offset + torch.arange(T, device=q.device)[
            None, None, None, :, None]
        mask = spos > qpos
    if length is not None:
        mask = mask | (spos >= length.long()[:, None, None, None, None])
    scores = scores.masked_fill(mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", probs, v)
    return out.reshape(B, T, H, hd)


def _project_qkv(p, cfg, x, positions, dtype):
    B, T = x.shape[:2]
    hd = cfg.head_dim
    q = M.apply_dense(p["wq"], x, dtype).reshape(B, T, -1, hd)
    k = M.apply_dense(p["wk"], x, dtype).reshape(B, T, -1, hd)
    v = M.apply_dense(p["wv"], x, dtype).reshape(B, T, -1, hd)
    q = M.apply_rope(q, positions, cfg.rope_theta)   # check_supported: rope
    k = M.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def update_paged_cache(pool, new, pos, block_tables):
    """Paged cache write, in place: token ``pos`` of slot ``b`` lands at
    page ``block_tables[b, pos // page]`` row ``pos % page``.

    pool (P, page, KV, hd); new (B, 1, KV, hd); pos (B,); block_tables
    (B, nblk).  JAX drops out-of-range writes (``mode="drop"``), while
    torch raises on an index past the end and wraps a negative one; here a
    position outside [0, nblk * page) is sent to the never-read NULL page
    instead, which needs no host sync."""
    page = pool.shape[1]
    nblk = block_tables.shape[1]
    pos = pos.long()
    ok = (pos >= 0) & (pos < nblk * page)
    blk = torch.clamp(pos // page, 0, nblk - 1)
    pid = torch.gather(block_tables.long(), 1, blk[:, None])[:, 0]
    pid = torch.where(ok, pid, NULL_PAGE)
    row = torch.where(ok, pos % page, 0)
    pool.index_put_((pid, row), new[:, 0].to(pool.dtype))
    return pool


def update_paged_cache_chunk(pool, new, offset, valid, block_tables):
    """Chunked-prefill cache write, in place: row r of slot b lands at page
    ``block_tables[b, (offset+r) // page]`` row ``(offset+r) % page``.

    pool (P, page, KV, hd); new (B, C, KV, hd); offset (B,) absolute
    position of row 0; valid (B,) real rows; block_tables (B, nblk).  Pad
    rows (r >= valid) go to the never-read NULL page (duplicate indices
    there are harmless for that reason), so a partial final slab cannot
    clobber a live page — in particular never a shared prefix page, which
    is only ever mapped at positions < offset."""
    page = pool.shape[1]
    B, C = new.shape[:2]
    r = torch.arange(C, device=new.device)
    pos = offset.long()[:, None] + r[None, :]                   # (B, C)
    blk = torch.clamp(pos // page, 0, block_tables.shape[1] - 1)
    pid = torch.gather(block_tables.long(), 1, blk)             # (B, C)
    pid = torch.where(r[None, :] < valid.long()[:, None], pid, NULL_PAGE)
    rows = new.to(pool.dtype).reshape((B * C,) + new.shape[2:])
    pool.index_put_((pid.reshape(-1), (pos % page).reshape(-1)), rows)
    return pool


def gather_paged_kv(cache: PagedKVCache, block_tables):
    """Dense logical view of a paged cache: (B, nblk*page, KV, hd) — the
    plain path's (and the kernels' oracles') view."""
    B, nblk = block_tables.shape
    page, KV, hd = cache.k_pool.shape[1:]
    bt = block_tables.long()
    k = cache.k_pool[bt].reshape(B, nblk * page, KV, hd)
    v = cache.v_pool[bt].reshape(B, nblk * page, KV, hd)
    return k, v


def apply_attention_decode_paged(p, cfg, x, cache: PagedKVCache, pos,
                                 dtype, block_tables, use_kernel=False):
    """Single-token decode against a paged cache.  ``use_kernel`` attends
    through ``kernels.paged_decode_attention`` (the pool is streamed page by
    page, no dense copy); the default gathers the logical view."""
    assert block_tables is not None, \
        "paged caches need batch['block_tables'] in the decode batch"
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None], dtype)
    update_paged_cache(cache.k_pool, k_new, pos, block_tables)
    update_paged_cache(cache.v_pool, v_new, pos, block_tables)
    length = (pos + 1).to(torch.int32)
    if use_kernel:
        from repro_torch.kernels import ops as KO
        out = KO.paged_decode_attention(
            q[:, 0].contiguous(), cache.k_pool, cache.v_pool,
            block_tables, length)[:, None]
    else:
        k, v = gather_paged_kv(cache, block_tables)
        out = attend(q, k, v, causal=False, length=length)
    out = M.apply_dense(p["wo"], out.reshape(B, 1, -1), dtype)
    return out, cache


def apply_attention_chunk_paged(p, cfg, x, cache: PagedKVCache, offset,
                                valid, dtype, block_tables,
                                use_kernel=False):
    """Chunked-prefill attention against a paged cache (bf16/fp32 pools).

    ``x`` (B, C, d) is one slab of prompt tokens starting at absolute
    position ``offset`` (B,), of which the first ``valid`` (B,) rows are
    real; the slab's KV is written through the block table, then the slab
    attends causally over positions [0, offset + valid) — shared prefix
    pages included.  Returns (out (B, C, d), cache)."""
    assert block_tables is not None, \
        "chunked prefill needs batch['block_tables']"
    B, C = x.shape[:2]
    positions = offset.long()[:, None] + torch.arange(C, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, dtype)
    update_paged_cache_chunk(cache.k_pool, k_new, offset, valid, block_tables)
    update_paged_cache_chunk(cache.v_pool, v_new, offset, valid, block_tables)
    length = (offset + valid).to(torch.int32)
    if use_kernel:
        from repro_torch.kernels import ops as KO
        out = KO.prefill_attention_paged(
            q.contiguous(), cache.k_pool, cache.v_pool, block_tables,
            offset.to(torch.int32), length)
    else:
        k, v = gather_paged_kv(cache, block_tables)
        out = attend(q, k, v, causal=True,
                     q_offset=offset.long()[:, None, None, None, None],
                     length=length)
    out = M.apply_dense(p["wo"], out.reshape(B, C, -1), dtype)
    return out, cache


def init_paged_cache(cfg, spec: PageSpec, dtype, device) -> PagedKVCache:
    """Zeroed page pools for one attention sublayer (shared across slots)."""
    if spec.kv_dtype == "int8":
        raise NotImplementedError("int8 KV pages are not ported yet: ROADMAP "
                                  "queue 1 item 7 (quantization)")
    shape = (spec.num_pages, spec.page_size, cfg.num_kv_heads, cfg.head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))
