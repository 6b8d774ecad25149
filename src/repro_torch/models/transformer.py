"""Decoder-LM assembly: per-layer modules, paged caches, the serving steps
and the training forward.

The port of the attention-only part of ``repro.models.transformer``.  The
JAX package stacks the layers of a group over a leading axis and runs them
with ``lax.scan``; here every layer is its own entry of an ``nn.ModuleList``
and a Python loop runs them eagerly.  Four entry points: ``prefill`` (a
bucket of right-padded prompts, returning dense per-slot caches),
``chunk_prefill_step`` (one prompt slab against shared ``PagedKVCache``
pools), ``decode_step`` (one token per slot, against dense ``KVCache``s or
the pools; both updated in place) and ``train_logits`` (the full-sequence
causal forward, with the JAX package's remat modes as activation
checkpoints).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.device import dtype_of
from repro_torch.models import attention as A
from repro_torch.models import modules as M
from repro_torch.models import moe as MOE
from repro_torch.quant.tensor import quantize_kv


@dataclass(frozen=True)
class RuntimeConfig:
    """Static runtime switches: the JAX package's fields that the serving
    and training paths read (MLA and MoE-group switches come with their
    items)."""
    remat: str = "dots"            # none | dots | full (training forward)
    cache_dtype: str = "bfloat16"  # KV storage name (sets the page granule)
    paged_kernel_decode: bool = False  # paged attention via the CUDA
    #   kernels (no gathered dense view); default: the plain path
    quantize_weights: str = "none"  # none|int8|int4|mx4|fp8: the weight
    #   format tag
    #   (build_engine quantizes a native init with quant.quantize_params)
    kv_cache_dtype: str = ""       # "" -> cache_dtype; "int8": int8 page
    #   pools + scale pages
    loss_chunk: int = 0            # 0 = unchunked softmax xent

    def kv_dtype(self) -> str:
        """Resolved KV-cache storage dtype (serving alias wins)."""
        return self.kv_cache_dtype or self.cache_dtype

    def validate(self) -> "RuntimeConfig":
        if self.quantize_weights not in ("none", "int8", "int4", "mx4",
                                         "fp8"):
            raise ValueError(f"quantize_weights must be one of none|int8|"
                             f"int4|mx4|fp8, got {self.quantize_weights!r}")
        if self.remat == "dots_tp":
            raise NotImplementedError(
                "remat='dots_tp' saves tensor-parallel outputs: not ported "
                "yet — ROADMAP queue 1 item 12 (tensor parallel)")
        if self.remat not in ("none", "dots", "full"):
            raise ValueError(f"remat must be none, dots or full; got "
                             f"{self.remat!r}")
        return self


def check_supported(cfg):
    """The port runs decoder-only stacks of GQA attention with RoPE (and,
    where the config asks, qk-norm), RMSNorm and a SwiGLU MLP or a
    qwen2-moe MoE (SwiGLU experts and a shared SwiGLU expert behind a
    sigmoid gate), read out through an untied ``lm_head``."""
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
    elif cfg.tie_embeddings:
        why = "queue 1 item 13 (tied read-out: whisper-base)"
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet — ROADMAP {why}")


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def init_lm(cfg, *, generator: torch.Generator, device,
            dtype=None, quantize=None) -> nn.ModuleDict:
    """Random parameters with the JAX package's scales: truncated normals
    (fan-in scaled projections and expert stacks, unit-scale embedding),
    unit norm scales, zero biases.  Projection weights are stored (out, in)
    and expert stacks (E, out, in), in ``dtype`` (default: the compute
    dtype; fp32 for the training masters); the embedding, norm scales,
    biases and MoE routers stay fp32.  ``quantize`` (a
    ``quant.quantizer``) quantizes each layer and the read-out as soon as
    they are drawn: the same draws and codes as quantizing the whole init
    afterwards, without the raw weights of more than one of them held at
    a time."""
    check_supported(cfg)
    dtype = dtype_of(dtype or cfg.dtype)
    kw = dict(dtype=dtype, generator=generator, device=device)
    post = quantize or (lambda keys, node: node)
    layers = nn.ModuleList()
    for i, (_, ffn) in enumerate(cfg.layer_kinds()):
        layers.append(post(("layers", str(i)), nn.ModuleDict({
            "norm1": M.norm_init(cfg.d_model, device=device),
            "mixer": A.attention_init(cfg, **kw),
            "norm2": M.norm_init(cfg.d_model, device=device),
            "ffn": (MOE.moe_init(cfg, **kw) if ffn == "moe"
                    else M.mlp_init(cfg.d_model, cfg.d_ff, **kw)),
        })))
    return nn.ModuleDict({
        "embed": M.embed_init(cfg.vocab_size, cfg.d_model,
                              generator=generator, device=device),
        "layers": layers,
        "final_norm": M.norm_init(cfg.d_model, device=device),
        "lm_head": post(("lm_head",), M.dense_init(
            cfg.d_model, cfg.vocab_size, bias=False, **kw)),
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
    o, _ = A.apply_attention_decode(
        p["mixer"], cfg, h, cache, pos, dtype, block_tables=pages,
        use_kernel=_use_kernel(rt))
    return _apply_ffn(p, cfg, rt, x + o, dtype)


def readout(p, cfg, x, dtype):
    x = M.apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
    return M.apply_dense(p["lm_head"], x, dtype)


# --------------------------------------------------------------------------
# Training forward
# --------------------------------------------------------------------------
# remat="dots": the JAX package's ``checkpoint_dots`` policy — the outputs
# of matrix products are saved, everything else is recomputed in backward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _apply_layer_train(p, cfg, x, positions, dtype):
    h = M.apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
    x = x + A.apply_attention(p["mixer"], cfg, h, positions=positions,
                              dtype=dtype)
    h = M.apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
    return x + M.apply_mlp(p["ffn"], h, cfg.act, dtype)


def embed_inputs(params, cfg, batch, dtype):
    """Token embeddings (check_supported: RoPE archs, no frontend)."""
    return M.apply_embed(params["embed"], batch["tokens"], dtype)


def run_layers(params, cfg, rt, x, positions, dtype):
    """Every layer in order, each under the ``rt.remat`` checkpoint: none,
    "full" (only the layer's input is kept) or "dots" (matrix-product
    outputs kept, the rest recomputed)."""
    for p in params["layers"]:
        if rt.remat == "none":
            x = _apply_layer_train(p, cfg, x, positions, dtype)
        elif rt.remat == "full":
            x = checkpoint(_apply_layer_train, p, cfg, x, positions, dtype,
                           use_reentrant=False)
        else:
            x = checkpoint(_apply_layer_train, p, cfg, x, positions, dtype,
                           use_reentrant=False,
                           context_fn=functools.partial(
                               create_selective_checkpoint_contexts,
                               _save_dots))
    return x


def check_trainable(cfg):
    if any(ffn == "moe" for _, ffn in cfg.layer_kinds()):
        raise NotImplementedError(
            f"{cfg.name}: MoE training needs the router's aux load-balancing "
            f"loss and routing groups: not ported yet — ROADMAP queue 1 "
            f"item 14 (training stack)")


def train_logits(params, cfg, rt, batch):
    """batch: tokens (B, T).  Returns (logits (B, T, V) in the compute
    dtype, aux), aux the fp32 zero of a dense model."""
    check_trainable(cfg)
    dtype = dtype_of(cfg.dtype)
    x = embed_inputs(params, cfg, batch, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = run_layers(params, cfg, rt, x, positions, dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return readout(params, cfg, x, dtype), aux


# --------------------------------------------------------------------------
# Caches + entry points
# --------------------------------------------------------------------------
def init_caches(cfg, rt, B, S, dtype, page_spec=None, device=None,
                chunk_stage: int = 0) -> List:
    """One decode cache per layer.  With ``page_spec`` a ``PagedKVCache``
    (page pools shared by every slot, sized through the spec; int8 pools
    with scale pages); without it, or when the runtime stores KV in int8
    but the spec's pools are not int8, a dense per-slot ``KVCache``
    (B, S), int8 with scales when ``rt.kv_dtype()`` is ``"int8"``.
    ``chunk_stage`` (the chunked engine's chunk size) adds a one-slot bf16
    ``ChunkStage`` to each int8 paged layer, covering the gathered view
    plus a full pad chunk so the staging write never runs past its end."""
    paged_int8 = page_spec is not None and page_spec.kv_dtype == "int8"
    quant = rt.kv_dtype() == "int8"
    if page_spec is None or (quant and not paged_int8):
        return [A.init_cache(cfg, B, S, dtype, quantized=quant,
                             device=device) for _ in range(cfg.num_layers)]
    caches = [A.init_paged_cache(cfg, page_spec, dtype, device)
              for _ in range(cfg.num_layers)]
    if chunk_stage > 0 and paged_int8:
        ps = page_spec.page_size
        S_stage = max(-(-S // ps) * ps, S + chunk_stage)
        caches = [c._replace(stage=A.init_chunk_stage(cfg, S_stage, device))
                  for c in caches]
    return caches


@torch.no_grad()
def prefill(params, cfg, rt, batch):
    """Full-sequence forward of a bucket of right-padded prompts that also
    returns their decode caches: batch = {tokens (B, T)[, length (B,)]},
    positions ``arange(T)``.  The caches are one dense ``KVCache`` (B, T)
    per layer, the roped K and V in the compute dtype, or their int8 codes
    and scales when ``rt.kv_dtype()`` is ``"int8"``.  Returns (logits
    (B, T, V), caches); with ``length``, each row's position
    ``length - 1`` is gathered before the read-out and the logits are
    (B, V) — the JAX package reads out every position and gathers after
    (a full (8, 1024, 151936) bf16 read-out would be 2.5 GB)."""
    dtype = dtype_of(cfg.dtype)
    x = embed_inputs(params, cfg, batch, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    caches = []
    for p in params["layers"]:
        h = M.apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
        o, kv = A.apply_attention(p["mixer"], cfg, h, positions=positions,
                                  dtype=dtype, return_kv=True)
        if rt.kv_dtype() == "int8":
            (qk, ks), (qv, vs) = quantize_kv(kv.k), quantize_kv(kv.v)
            kv = A.KVCache(qk, qv, ks, vs)
        caches.append(kv)
        x = _apply_ffn(p, cfg, rt, x + o, dtype)
    length = batch.get("length")
    if length is None:
        return readout(params, cfg, x, dtype), caches
    idx = (length.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    last = torch.gather(x, 1, idx)
    return readout(params, cfg, last, dtype)[:, 0], caches


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
    """batch: tokens (B,1), pos (B,)[, block_tables (B,nblk) over paged
    caches].  Returns (logits (B,1,V), caches)."""
    dtype = dtype_of(cfg.dtype)
    pos = batch["pos"]
    pages = batch.get("block_tables")
    x = M.apply_embed(params["embed"], batch["tokens"], dtype)
    for p, cache in zip(params["layers"], caches):
        x = _apply_layer_decode(p, cfg, rt, x, cache, pos, pages, dtype)
    return readout(params, cfg, x, dtype), caches
