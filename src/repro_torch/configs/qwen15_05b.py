"""qwen1.5-0.5b — small dense, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf]  24L d_model=1024 16H d_ff=2816 vocab=151936.
Untied read-out (``tie_embeddings`` keeps its default, False).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
