"""glm4-9b — dense, RoPE, aggressive GQA (kv=2).

[hf:THUDM/glm-4-9b; hf]  40L d_model=4096 32H kv=2 d_ff=13696 vocab=151552.
A copy of the JAX package's config (the port imports nothing of
``repro``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    qkv_bias=True,             # GLM-4 uses add_qkv_bias
    rope_theta=10_000.0,
)
