"""Configuration dataclasses for models.

A copy of ``repro.configs.base`` (the JAX package's dataclasses): the port
imports nothing of ``repro``, so it keeps its own.  Every architecture is a
frozen, hashable ``ModelConfig``; ``reduced`` gives the tiny same-family
config the CPU tests run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_experts_per_tok: int = 0
    d_ff: int = 0                      # per-expert hidden size
    num_shared_experts: int = 0        # always-on experts (DeepSeek/Qwen-MoE)
    shared_d_ff: int = 0               # total hidden of the shared expert block
    shared_expert_gate: bool = False   # Qwen-MoE sigmoid gate on shared output
    norm_topk_prob: bool = True        # renormalise top-k gate probs
    routed_scaling_factor: float = 1.0
    capacity_factor: float = 1.25      # dispatch capacity (dropped tokens -> 0)
    router_aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0               # 0 => direct q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective-state-space block (Jamba)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                   # 0 => ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 "Finch" time-mix / channel-mix block."""
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    gate_lora: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention flavour ----------------------------------------------
    attention: str = "gqa"             # gqa | mla | none
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"              # rope | learned | sinusoidal | none
    max_position_embeddings: int = 1 << 20

    # --- block pattern ----------------------------------------------------
    # sequence of mixer kinds per layer period ("attn"|"mamba"|"rwkv"); the
    # model tiles this pattern over num_layers.  () == ("attn",).
    block_pattern: Tuple[str, ...] = ()
    # which layers (mod moe_period == moe_offset) use the MoE ffn
    moe: Optional[MoEConfig] = None
    moe_period: int = 1
    moe_offset: int = 0
    first_dense_layers: int = 0        # leading layers forced to dense ffn

    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # --- ffn / norm flavour ----------------------------------------------
    act: str = "swiglu"                # swiglu | gelu | relu_sq
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- encoder-decoder ---------------------------------------------------
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    cross_attention_len: int = 1500    # whisper: encoder frames seen by decoder

    # --- modality frontend (STUB: precomputed embeddings via input_specs) --
    frontend: str = "none"             # none | audio | vision
    frontend_tokens: int = 0           # e.g. 256 vision patches prepended

    # --- numerics ----------------------------------------------------------
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"       # master weights

    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or ("attn",)

    def layer_kinds(self):
        """(mixer, ffn) kind for every layer index."""
        pat = self.pattern()
        out = []
        for i in range(self.num_layers):
            mixer = pat[i % len(pat)]
            if self.moe is not None and i >= self.first_dense_layers and (
                    i % self.moe_period == self.moe_offset):
                ffn = "moe"
            else:
                ffn = "mlp"
            if mixer == "rwkv":
                ffn = "rwkv_cm"        # RWKV channel-mix replaces the MLP
            out.append((mixer, ffn))
        return out


def reduced(cfg: ModelConfig, **over) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes = dict(
        num_layers=min(cfg.num_layers, len(cfg.pattern()) * 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads >= 4 else cfg.num_kv_heads,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_position_embeddings=2048,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8,
            num_experts_per_tok=min(cfg.moe.num_experts_per_tok, 2),
            d_ff=64, shared_d_ff=64 if cfg.moe.shared_d_ff else 0)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                   qk_nope_head_dim=32, qk_rope_head_dim=16,
                                   v_head_dim=32)
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
    if cfg.rwkv is not None:
        changes["rwkv"] = RWKVConfig(head_dim=32, decay_lora=16, mix_lora=8)
        changes["num_heads"] = 4
        changes["head_dim"] = 32
    if cfg.encoder_decoder:
        changes["num_encoder_layers"] = 2
        changes["num_layers"] = 2
        changes["cross_attention_len"] = 64
    if cfg.frontend_tokens:
        changes["frontend_tokens"] = 16
    changes.update(over)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
