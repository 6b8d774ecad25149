"""qwen3-14b — dense, qk_norm, GQA kv=8.

[hf:Qwen/Qwen3 family; hf]  40L d_model=5120 40H kv=8 d_ff=17408 vocab=151936.
A copy of the JAX package's config (the port imports nothing of
``repro``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
