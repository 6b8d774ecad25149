"""Decoder-LM assembly: per-layer modules, paged caches, the serving steps.

The port of the attention-only, paged part of ``repro.models.transformer``.
The JAX package stacks the layers of a group over a leading axis and runs
them with ``lax.scan``; here every layer is its own entry of an
``nn.ModuleList`` and a Python loop runs them eagerly.  Two entry points:
``chunk_prefill_step`` (one prompt slab) and ``decode_step`` (one token per
slot), both against shared ``PagedKVCache`` pools that they update in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
from torch import nn

from repro_torch.core.device import dtype_of
from repro_torch.models import attention as A
from repro_torch.models import modules as M
from repro_torch.models import moe as MOE
from repro_torch.serve.kvcache import PagedKVCache


@dataclass(frozen=True)
class RuntimeConfig:
    """Static runtime switches: the JAX package's fields that the serving
    path reads (training and MLA switches come with their items)."""
    cache_dtype: str = "bfloat16"  # KV storage name (sets the page granule)
    paged_kernel_decode: bool = False  # paged attention via the CUDA
    #   kernels (no gathered dense view); default: the plain path
    quantize_weights: str = "none"  # none|mx4|fp8: the weight format tag
    #   (build_engine quantizes a native init with quant.quantize_params)
    kv_cache_dtype: str = ""       # "" -> cache_dtype; "int8": int8 page
    #   pools + scale pages

    def kv_dtype(self) -> str:
        """Resolved KV-cache storage dtype (serving alias wins)."""
        return self.kv_cache_dtype or self.cache_dtype

    def validate(self) -> "RuntimeConfig":
        if self.quantize_weights not in ("none", "mx4", "fp8"):
            raise NotImplementedError(
                f"{self.quantize_weights} weights are not ported yet: "
                f"ROADMAP queue 1 item 7 (int8/int4 weights)")
        return self


def check_supported(cfg):
    """The port runs decoder-only stacks of GQA attention with RoPE, RMSNorm
    and a SwiGLU MLP or a qwen2-moe MoE (SwiGLU experts and a shared SwiGLU
    expert behind a sigmoid gate), read out through an untied
    ``lm_head``."""
    why = None
    mo = cfg.moe
    if cfg.encoder_decoder:
        why = "queue 1 item 13 (encoder-decoder)"
    elif cfg.attention != "gqa":
        why = "queue 1 item 13 (MLA)"
    elif mo is not None and not (mo.shared_d_ff and mo.shared_expert_gate):
        why = "queue 1 item 13 (MoE without a gated shared expert)"
    elif any(k not in (("attn", "mlp"), ("attn", "moe"))
             for k in cfg.layer_kinds()):
        why = "queue 1 item 13 (other mixers)"
    elif cfg.frontend != "none":
        why = "queue 1 item 13 (vision frontend)"
    elif cfg.norm != "rmsnorm" or cfg.act != "swiglu" \
            or cfg.pos_emb != "rope":
        why = "queue 1 item 13 (other norms, activations, positions)"
    elif cfg.qk_norm or cfg.tie_embeddings:
        why = "queue 1 item 5 (qk-norm, tied read-out)"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet — ROADMAP {why}")


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_lm(cfg, *, generator: torch.Generator, device) -> nn.ModuleDict:
    """Random parameters with the JAX package's scales: truncated normals
    (fan-in scaled projections and expert stacks, unit-scale embedding),
    unit norm scales, zero biases.  Projection weights are stored (out, in)
    and expert stacks (E, out, in), in the compute dtype; the embedding,
    norm scales, biases and MoE routers stay fp32."""
    check_supported(cfg)
    dtype = dtype_of(cfg.dtype)
    kw = dict(dtype=dtype, generator=generator, device=device)
    layers = nn.ModuleList()
    for _, ffn in cfg.layer_kinds():
        layers.append(nn.ModuleDict({
            "norm1": M.norm_init(cfg.d_model, device=device),
            "mixer": A.attention_init(cfg, **kw),
            "norm2": M.norm_init(cfg.d_model, device=device),
            "ffn": (MOE.moe_init(cfg, **kw) if ffn == "moe"
                    else M.mlp_init(cfg.d_model, cfg.d_ff, **kw)),
        }))
    return nn.ModuleDict({
        "embed": M.embed_init(cfg.vocab_size, cfg.d_model,
                              generator=generator, device=device),
        "layers": layers,
        "final_norm": M.norm_init(cfg.d_model, device=device),
        "lm_head": M.dense_init(cfg.d_model, cfg.vocab_size, bias=False,
                                **kw),
    })


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------
def _use_kernel(rt) -> bool:
    return rt.paged_kernel_decode or M.kernel_routed()


def _apply_ffn(p, cfg, rt, x, dtype):
    """The layer's MLP, or its MoE (a ffn that holds a ``router``); the
    serving steps drop the MoE aux loss, as the JAX decode path does."""
    h = M.apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
    if "router" in p["ffn"]:
        return x + MOE.apply_moe(p["ffn"], cfg, h, dtype=dtype)
    return x + M.apply_mlp(p["ffn"], h, cfg.act, dtype)


def _apply_layer_chunk(p, cfg, rt, x, cache, offset, valid, stage_base,
                       pages, dtype):
    h = M.apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
    o, _ = A.apply_attention_chunk_paged(
        p["mixer"], cfg, h, cache, offset, valid, dtype, block_tables=pages,
        use_kernel=_use_kernel(rt), stage_base=stage_base)
    return _apply_ffn(p, cfg, rt, x + o, dtype)


def _apply_layer_decode(p, cfg, rt, x, cache, pos, pages, dtype):
    h = M.apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
    o, _ = A.apply_attention_decode_paged(
        p["mixer"], cfg, h, cache, pos, dtype, block_tables=pages,
        use_kernel=_use_kernel(rt))
    return _apply_ffn(p, cfg, rt, x + o, dtype)


def readout(p, cfg, x, dtype):
    x = M.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
    return M.apply_dense(p["lm_head"], x, dtype)


# --------------------------------------------------------------------------
# Caches + entry points
# --------------------------------------------------------------------------
def init_caches(cfg, rt, B, S, dtype, page_spec=None, device=None,
                chunk_stage: int = 0) -> List[PagedKVCache]:
    """One ``PagedKVCache`` (page pools shared by every slot) per layer.
    ``B`` and ``S`` size the pools through ``page_spec``; int8 pools come
    with scale pages.  ``chunk_stage`` (the chunked engine's chunk size)
    adds a one-slot bf16 ``ChunkStage`` to each int8 layer, covering the
    gathered view plus a full pad chunk so the staging write never runs
    past its end."""
    paged_int8 = page_spec is not None and page_spec.kv_dtype == "int8"
    if page_spec is None or (rt.kv_dtype() == "int8" and not paged_int8):
        raise NotImplementedError("dense per-slot caches are not ported yet: "
                                  "ROADMAP queue 1 item 6 (bucketed prefill "
                                  "and dense backend)")
    caches = [A.init_paged_cache(cfg, page_spec, dtype, device)
              for _ in range(cfg.num_layers)]
    if chunk_stage > 0 and paged_int8:
        ps = page_spec.page_size
        S_stage = max(-(-S // ps) * ps, S + chunk_stage)
        caches = [c._replace(stage=A.init_chunk_stage(cfg, S_stage, device))
                  for c in caches]
    return caches


@torch.no_grad()
def chunk_prefill_step(params, cfg, rt, batch, caches):
    """One chunked-prefill slab against the shared paged caches.

    batch: tokens (B, C) right-padded; offset (B,) absolute position of
    token 0; valid (B,) real rows; stage_base (B,) first position owned by
    this request (the shared-prefix length; default 0); block_tables
    (B, nblk).  Returns (last-valid-row logits (B, V), caches) — the logits
    row only matters on a prompt's final chunk, where its argmax is the
    first generated token.
    """
    dtype = dtype_of(cfg.dtype)
    offset, valid = batch["offset"], batch["valid"]
    stage_base = batch.get("stage_base", torch.zeros_like(offset))
    pages = batch.get("block_tables")
    x = M.apply_embed(params["embed"], batch["tokens"], dtype)
    for p, cache in zip(params["layers"], caches):
        x = _apply_layer_chunk(p, cfg, rt, x, cache, offset, valid,
                               stage_base, pages, dtype)
    # gather each row's last valid position BEFORE the O(V) read-out
    idx = (valid.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    last = torch.gather(x, 1, idx)
    logits = readout(params, cfg, last, dtype)             # (B, 1, V)
    return logits[:, 0], caches


@torch.no_grad()
def decode_step(params, cfg, rt, batch, caches):
    """batch: tokens (B,1), pos (B,), block_tables (B,nblk).  Returns
    (logits (B,1,V), caches)."""
    dtype = dtype_of(cfg.dtype)
    pos = batch["pos"]
    pages = batch.get("block_tables")
    x = M.apply_embed(params["embed"], batch["tokens"], dtype)
    for p, cache in zip(params["layers"], caches):
        x = _apply_layer_decode(p, cfg, rt, x, cache, pos, pages, dtype)
    return readout(params, cfg, x, dtype), caches
