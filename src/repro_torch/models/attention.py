"""GQA attention (RoPE, qkv bias, qk-norm): full sequence, and against the
dense per-slot or the paged KV cache.

The port of ``repro.models.attention`` (one device).  Training and the
bucketed prefill attend with ``attend`` over the whole sequence, as the JAX
package does; the prefill also returns the roped K and V as its
``KVCache``.  Decode over a dense ``KVCache`` attends with plain ``attend``
(the JAX package's routing: its dense decode kernels run only through the
tune registry).  On the paged path the plain (gathered dense view) path is
the reference, and ``use_kernel`` streams the pools through the paged CUDA
kernels instead.  The caches (dense, or page pools, bf16 or int8 with
scales) and the int8 engine's ``ChunkStage`` are updated in place
(``index_put_`` / ``index_copy_``): that is what JAX's buffer donation does
for the jitted step, without a second copy of the caches.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models import modules as M
from repro_torch.quant.tensor import dequantize_kv, quantize_kv
from repro_torch.serve.kvcache import (NULL_PAGE, ChunkStage, PagedKVCache,
                                       PageSpec)


class KVCache(NamedTuple):
    """Dense per-slot KV cache of one attention layer; int8 codes with
    per-(token, head) bf16 absmax scales when quantized."""
    k: torch.Tensor                        # (B, S, KV, hd) compute | int8
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # (B, S, KV, 1) bf16 when int8
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def attention_init(cfg, *, dtype, generator, device) -> nn.ModuleDict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, generator=generator, device=device)
    p = nn.ModuleDict({
        "wq": M.dense_init(d, H * hd, bias=cfg.qkv_bias, **kw),
        "wk": M.dense_init(d, KV * hd, bias=cfg.qkv_bias, **kw),
        "wv": M.dense_init(d, KV * hd, bias=cfg.qkv_bias, **kw),
        "wo": M.dense_init(H * hd, d, bias=False, **kw),
    })
    if cfg.qk_norm:
        # unit scales draw nothing: the other leaves' draws do not move
        p["q_norm"] = M.norm_init(hd, device=device)
        p["k_norm"] = M.norm_init(hd, device=device)
    return p


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
    if cfg.qk_norm:        # per head over head_dim, before RoPE
        q = M.apply_norm(p["q_norm"], q, "rmsnorm", cfg.norm_eps)
        k = M.apply_norm(p["k_norm"], k, "rmsnorm", cfg.norm_eps)
    q = M.apply_rope(q, positions, cfg.rope_theta)   # check_supported: rope
    k = M.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attention(p, cfg, x, *, positions, dtype, causal=True,
                    return_kv=False):
    """Full-sequence (training / prefill) self-attention over x (B, T, d);
    ``return_kv`` also returns the roped K and V as a ``KVCache`` (the
    decode cache's rows)."""
    q, k, v = _project_qkv(p, cfg, x, positions, dtype)
    out = attend(q, k, v, causal=causal)
    B, T = x.shape[:2]
    out = M.apply_dense(p["wo"], out.reshape(B, T, -1), dtype)
    if return_kv:
        return out, KVCache(k, v)
    return out


def update_cache(cache_arr, new, pos):
    """Dense cache write, in place: row ``new[b, 0]`` at ``[b, pos[b]]``.

    As in JAX's ``.at[...].set(mode="drop")``, a negative position counts
    from the end and a write that still falls outside [0, S) is dropped.
    Torch would raise on it instead; the port drops it without a host
    sync: that slot writes the row already at a clamped position back
    onto itself, leaving the cache as it was.

    cache_arr (B, S, ...); new (B, 1, ...); pos (B,)."""
    B, S = cache_arr.shape[:2]
    pos = pos.long()
    pos = torch.where(pos < 0, pos + S, pos)
    b = torch.arange(B, device=cache_arr.device)
    idx = torch.clamp(pos, 0, S - 1)
    ok = ((pos >= 0) & (pos < S)).reshape((B,) + (1,) * (new.ndim - 2))
    row = torch.where(ok, new[:, 0].to(cache_arr.dtype), cache_arr[b, idx])
    cache_arr.index_put_((b, idx), row)
    return cache_arr


def _decode_targets(pos, block_tables, page):
    """(page id, row) of each slot's token ``pos`` (B,): page
    ``block_tables[b, pos // page]`` row ``pos % page``.  JAX drops
    out-of-range writes (``mode="drop"``), while torch raises on an index
    past the end and wraps a negative one; here a position outside
    [0, nblk * page) is sent to the NULL page instead, which needs no host
    sync."""
    nblk = block_tables.shape[1]
    pos = pos.long()
    ok = (pos >= 0) & (pos < nblk * page)
    blk = torch.clamp(pos // page, 0, nblk - 1)
    pid = torch.gather(block_tables.long(), 1, blk[:, None])[:, 0]
    return torch.where(ok, pid, NULL_PAGE), torch.where(ok, pos % page, 0)


def _chunk_targets(offset, valid, block_tables, page, C):
    """(page id, row) of each row r of each slot's slab, flattened to
    (B * C,): page ``block_tables[b, (offset+r) // page]`` row
    ``(offset+r) % page``.  Pad rows (r >= valid) go to the NULL page, so a
    partial final slab cannot clobber a live page — in particular never a
    shared prefix page, which is only ever mapped at positions < offset."""
    r = torch.arange(C, device=offset.device)
    pos = offset.long()[:, None] + r[None, :]                   # (B, C)
    blk = torch.clamp(pos // page, 0, block_tables.shape[1] - 1)
    pid = torch.gather(block_tables.long(), 1, blk)             # (B, C)
    pid = torch.where(r[None, :] < valid.long()[:, None], pid, NULL_PAGE)
    return pid.reshape(-1), (pos % page).reshape(-1)


def _paged_writer(pid, row, page):
    """``write(pool, rows)``: ``pool[pid[i], row[i]] = rows[i]`` for every
    i, in place.  Where several rows target one position (pad and idle
    rows sent to the NULL page, which idle decode slots read back), each
    writes the last such row's values: one value whatever order the card
    applies the writes in, and the one a sequential write (the CPU's, and
    the JAX package's scatter there) leaves.  Left to the card, the winner
    changes from run to run, and so, through a MoE whose capacity idle
    rows share with live ones, can a live token's route."""
    key = pid * page + row
    idx = torch.arange(key.shape[0], device=key.device)
    last = torch.where(key[:, None] == key[None, :], idx, -1).amax(dim=1)

    def write(pool, rows):
        pool.index_put_((pid, row), rows[last].to(pool.dtype))
        return pool
    return write


def update_paged_cache(pool, new, pos, block_tables):
    """Paged cache write, in place: token ``pos`` of slot ``b`` lands at
    page ``block_tables[b, pos // page]`` row ``pos % page``
    (``_decode_targets``, ``_paged_writer``).

    pool (P, page, KV, hd); new (B, 1, KV, hd); pos (B,); block_tables
    (B, nblk)."""
    page = pool.shape[1]
    return _paged_writer(*_decode_targets(pos, block_tables, page),
                         page)(pool, new[:, 0])


def update_paged_cache_chunk(pool, new, offset, valid, block_tables):
    """Chunked-prefill cache write, in place: row r of slot b lands at page
    ``block_tables[b, (offset+r) // page]`` row ``(offset+r) % page``
    (``_chunk_targets``, ``_paged_writer``).

    pool (P, page, KV, hd); new (B, C, KV, hd); offset (B,) absolute
    position of row 0; valid (B,) real rows; block_tables (B, nblk)."""
    page = pool.shape[1]
    B, C = new.shape[:2]
    write = _paged_writer(*_chunk_targets(offset, valid, block_tables, page,
                                          C), page)
    return write(pool, new.reshape((B * C,) + new.shape[2:]))


def gather_paged_kv(cache: PagedKVCache, block_tables,
                    dtype=torch.bfloat16):
    """Dense logical view of a paged cache: (B, nblk*page, KV, hd) — the
    plain path's (and the kernels' oracles') view.  int8 pools are
    dequantized through their gathered scale pages, in ``dtype``."""
    B, nblk = block_tables.shape
    page, KV, hd = cache.k_pool.shape[1:]
    bt = block_tables.long()
    k = cache.k_pool[bt].reshape(B, nblk * page, KV, hd)
    v = cache.v_pool[bt].reshape(B, nblk * page, KV, hd)
    if cache.quantized:
        ks = cache.k_scale_pool[bt].reshape(B, nblk * page, KV, 1)
        vs = cache.v_scale_pool[bt].reshape(B, nblk * page, KV, 1)
        return dequantize_kv(k, ks, dtype), dequantize_kv(v, vs, dtype)
    return k, v


def _write_rows(cache: PagedKVCache, k_new, v_new, write):
    """``write(pool, rows)`` for K and V rows (n, KV, hd) — quantized to
    int8 rows plus their scale rows (written through the same table entry)
    for int8 pools."""
    if cache.quantized:
        k8, ks = quantize_kv(k_new)
        v8, vs = quantize_kv(v_new)
        for pool, rows in ((cache.k_pool, k8), (cache.v_pool, v8),
                           (cache.k_scale_pool, ks),
                           (cache.v_scale_pool, vs)):
            write(pool, rows)
    else:
        write(cache.k_pool, k_new)
        write(cache.v_pool, v_new)


def apply_attention_decode(p, cfg, x, cache, pos, dtype, block_tables=None,
                           use_kernel=False):
    """Single-token decode; ``pos`` (B,) the current position.  A paged
    cache goes to ``apply_attention_decode_paged``; a dense ``KVCache``
    (fixed S) takes the token's K/V row at ``pos`` (quantized to codes and
    scales when int8) and attends with plain ``attend`` over
    ``length = pos + 1``, the int8 cache dequantized whole, as the JAX
    package does."""
    if isinstance(cache, PagedKVCache):
        return apply_attention_decode_paged(p, cfg, x, cache, pos, dtype,
                                            block_tables, use_kernel)
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None], dtype)
    if cache.quantized:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        for arr, new in ((cache.k, kq), (cache.v, vq),
                         (cache.k_scale, ks), (cache.v_scale, vs)):
            update_cache(arr, new, pos)
        k = dequantize_kv(cache.k, cache.k_scale, dtype)
        v = dequantize_kv(cache.v, cache.v_scale, dtype)
    else:
        k = update_cache(cache.k, k_new, pos)
        v = update_cache(cache.v, v_new, pos)
    out = attend(q, k, v, causal=False, length=pos + 1)
    out = M.apply_dense(p["wo"], out.reshape(B, 1, -1), dtype)
    return out, cache


def apply_attention_decode_paged(p, cfg, x, cache: PagedKVCache, pos,
                                 dtype, block_tables, use_kernel=False):
    """Single-token decode against a paged cache.  ``use_kernel`` attends
    through ``kernels.paged_decode_attention[_int8]`` (the pool is streamed
    page by page, no dense copy); the default gathers the logical view."""
    assert block_tables is not None, \
        "paged caches need batch['block_tables'] in the decode batch"
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None], dtype)
    page = cache.k_pool.shape[1]
    # one set of targets for the layer's K, V (and scale) writes
    _write_rows(cache, k_new[:, 0], v_new[:, 0], _paged_writer(
        *_decode_targets(pos, block_tables, page), page))
    length = (pos + 1).to(torch.int32)
    if use_kernel:
        from repro_torch.kernels import ops as KO
        if cache.quantized:
            out = KO.paged_decode_attention_int8(
                q[:, 0].contiguous(), cache.k_pool, cache.k_scale_pool,
                cache.v_pool, cache.v_scale_pool, block_tables,
                length, cfg=M.launch_config())[:, None]
        else:
            out = KO.paged_decode_attention(
                q[:, 0].contiguous(), cache.k_pool, cache.v_pool,
                block_tables, length, cfg=M.launch_config())[:, None]
    else:
        k, v = gather_paged_kv(cache, block_tables, dtype)
        out = attend(q, k, v, causal=False, length=length)
    out = M.apply_dense(p["wo"], out.reshape(B, 1, -1), dtype)
    return out, cache


def apply_attention_chunk_paged(p, cfg, x, cache: PagedKVCache, offset,
                                valid, dtype, block_tables,
                                use_kernel=False, stage_base=None):
    """Chunked-prefill attention against a paged cache.

    ``x`` (B, C, d) is one slab of prompt tokens starting at absolute
    position ``offset`` (B,), of which the first ``valid`` (B,) rows are
    real; the slab's KV is written through the block table, then the slab
    attends causally over positions [0, offset + valid) — shared prefix
    pages included.  Over int8 pools the prefill kernel is not used: the
    pages are gathered and dequantized, and the layer's ``ChunkStage``
    (``cache.stage``) overlays this request's own bf16 rows, positions
    [``stage_base``, offset + valid) — rows below ``stage_base`` (a shared
    prefix) predate the request and are read from the pages.  Returns
    (out (B, C, d), cache)."""
    assert block_tables is not None, \
        "chunked prefill needs batch['block_tables']"
    B, C = x.shape[:2]
    positions = offset.long()[:, None] + torch.arange(C, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, dtype)
    page = cache.k_pool.shape[1]
    rows = (B * C,) + k_new.shape[2:]
    _write_rows(cache, k_new.reshape(rows), v_new.reshape(rows),
                _paged_writer(*_chunk_targets(offset, valid, block_tables,
                                              page, C), page))
    length = (offset + valid).to(torch.int32)
    if use_kernel and not cache.quantized:
        from repro_torch.kernels import ops as KO
        out = KO.prefill_attention_paged(
            q.contiguous(), cache.k_pool, cache.v_pool, block_tables,
            offset.to(torch.int32), length, cfg=M.launch_config())
    else:
        k, v = gather_paged_kv(cache, block_tables, dtype)
        stage = cache.stage
        if stage is not None:
            # the whole slab (pad rows too) lands at rows [offset, offset+C)
            # of the one-slot stage, as JAX's dynamic_update_slice puts it
            rows = positions[0]
            stage.k.index_copy_(1, rows, k_new.to(stage.k.dtype))
            stage.v.index_copy_(1, rows, v_new.to(stage.v.dtype))
            S = k.shape[1]
            base = torch.zeros_like(offset) if stage_base is None \
                else stage_base
            spos = torch.arange(S, device=x.device)[None, :]
            use = ((spos >= base.long()[:, None])
                   & (spos < length.long()[:, None]))[:, :, None, None]
            k = torch.where(use, stage.k[:, :S].to(k.dtype), k)
            v = torch.where(use, stage.v[:, :S].to(v.dtype), v)
        out = attend(q, k, v, causal=True,
                     q_offset=offset.long()[:, None, None, None, None],
                     length=length)
    out = M.apply_dense(p["wo"], out.reshape(B, C, -1), dtype)
    return out, cache


def init_cache(cfg, B: int, S: int, dtype, quantized: bool = False,
               device=None) -> KVCache:
    """Zeroed dense per-slot cache (B, S, KV, hd); ``quantized``: int8
    codes plus bf16 scales initialized to one."""
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    if quantized:
        sshape = shape[:-1] + (1,)
        return KVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.ones(sshape, dtype=torch.bfloat16, device=device),
            torch.ones(sshape, dtype=torch.bfloat16, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_paged_cache(cfg, spec: PageSpec, dtype, device) -> PagedKVCache:
    """Zeroed page pools for one attention sublayer (shared across slots).
    ``spec.kv_dtype == "int8"`` allocates int8 value pools plus bf16 scale
    pages (initialized to one) at the same page indices."""
    shape = (spec.num_pages, spec.page_size, cfg.num_kv_heads, cfg.head_dim)
    if spec.kv_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return PagedKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.ones(sshape, dtype=torch.bfloat16, device=device),
            torch.ones(sshape, dtype=torch.bfloat16, device=device))
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def init_chunk_stage(cfg, S: int, device) -> ChunkStage:
    """The one-slot bf16 stage, ``(1, S, KV, hd)`` (``S`` covers the
    gathered view plus a full pad chunk)."""
    shape = (1, S, cfg.num_kv_heads, cfg.head_dim)
    return ChunkStage(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                      torch.zeros(shape, dtype=torch.bfloat16, device=device))
