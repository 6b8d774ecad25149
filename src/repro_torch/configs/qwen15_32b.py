"""qwen1.5-32b — dense, QKV bias, (GQA kv=40 == MHA).

[hf:Qwen/Qwen1.5-0.5B family; hf]  64L d_model=5120 40H d_ff=27392 vocab=152064.
A copy of the JAX package's config (the port imports nothing of
``repro``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
