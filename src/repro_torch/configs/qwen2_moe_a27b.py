"""qwen2-moe-a2.7b — 60 routed top-4 + 4 shared experts (gated).

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  24L d_model=2048 16H d_ff(moe)=1408
vocab=151936.  A copy of the JAX package's config (the port imports
nothing of ``repro``).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, num_experts_per_tok=4, d_ff=1408,
                  num_shared_experts=4, shared_d_ff=5632,
                  shared_expert_gate=True, norm_topk_prob=True),
    rope_theta=1_000_000.0,
)
