"""Architecture registry of the port: ``--arch <id>`` resolves through here.

Only the architectures whose layers the port runs are registered; the other
ids of the JAX package raise ``NotImplementedError`` naming the ROADMAP item
that brings them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      RWKVConfig, SSMConfig, reduced)

_ARCH_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a27b",
}

# JAX-package arch ids not ported yet -> the ROADMAP queue-1 item that ports
# the layers they need
_NOT_PORTED = {
    "qwen1.5-32b": "queue 1 item 5 (dense archs after qwen1.5-0.5b)",
    "glm4-9b": "queue 1 item 5 (GQA archs)",
    "qwen3-14b": "queue 1 item 5 (GQA archs, qk-norm)",
    "deepseek-v2-lite-16b": "queue 1 item 13 (MLA)",
    "rwkv6-3b": "queue 1 item 13 (other mixers)",
    "jamba-v0.1-52b": "queue 1 item 13 (other mixers)",
    "whisper-base": "queue 1 item 13 (encoder-decoder)",
    "internvl2-76b": "queue 1 item 13 (vision frontend)",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: ROADMAP {_NOT_PORTED[arch]}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig",
           "ARCH_IDS", "get_config", "reduced"]
