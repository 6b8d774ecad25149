"""Launch configuration of the port's CUDA kernels + the layout granule.

The JAX package's ``TroopConfig`` (``repro/core/troop.py``) shapes Pallas
grids for the TPU: two decoupled DMA streams, block sizes that tile the
(8, 128) layout.  On Hopper the same intent is a handful of launch
parameters — threads and warps per block, block sizes, the fused AdamW's
two streams — that the kernel wrappers read from ``LaunchConfig`` (the CUDA
entry points refuse values out of range).
Nothing here is tuned yet: the defaults are the simple first designs each
kernel's source describes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LaunchConfig:
    rmsnorm_threads: int = 128      # one block per row, 8 bf16 per thread
    gemv_warps: int = 8             # one warp per output row
    decode_warps: int = 4           # warps splitting one (slot, KV head)
    prefill_warps: int = 4          # warps splitting one (slab row, KV head)
    adamw_streams: int = 1          # 2: each block takes one chunk from each
    #   contiguous half of a tensor (the JAX kernel's decoupled streams)


DEFAULT = LaunchConfig()


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        if dtype == "int8":
            return 1
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def sublane(dtype) -> int:
    """Second-minor layout granule of a dtype, in rows (16 for 2-byte, 32 for
    1-byte types, else 8).  Page sizes must be multiples of it
    (``PageSpec.validate``) so the page tables stay those of the JAX
    package."""
    return {2: 16, 1: 32}.get(_itemsize(dtype), 8)

