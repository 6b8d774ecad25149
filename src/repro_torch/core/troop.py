"""Launch configuration of the port's CUDA kernels + the layout granule.

The JAX package's ``TroopConfig`` (``repro/core/troop.py``) shapes Pallas
grids for the TPU: two decoupled DMA streams, block sizes that tile the
(8, 128) layout.  On Hopper the same intent is a handful of launch
parameters — threads and warps per block, block sizes, the fused AdamW's
two streams — that the kernel wrappers read from ``LaunchConfig`` (the CUDA
entry points refuse values out of range).  ``dotp``, ``axpy`` and the dense
``decode_attention`` (bf16 and int8) read the JAX package's own knobs, under
its names and with its defaults (``streams``, ``unroll``, ``block_k``;
``block_n`` and ``scrambled_layout`` only feed the tuner's analytic
predictor, as in JAX), so ``repro_torch.tune`` ranks their candidates as the
JAX tuner does.  The quantized GEMVs ``qgemv`` / ``batched_qgemv`` read
``block_n`` (threads a block) and ``unroll`` (W rows a warp on the SIMT
walk; 4 x unroll k-steps in flight on the tile walk), and
``batched_mx_qgemv`` ``block_n`` (warps a block) and ``unroll`` (the E8M0
blocks of a round); their
``streams`` and ``block_k`` feed only the predictor.  The
defaults are the simple first designs each kernel's source describes; an
empty tune cache launches exactly these.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LaunchConfig:
    rmsnorm_threads: int = 128      # threads a block, a warp a row
    gemv_warps: int = 8             # one warp per output row
    decode_warps: int = 4           # paged decode: position warps of a
    #   block, 16 positions each of a staged tile
    prefill_warps: int = 4          # warps of one prefill block (rows x pages)
    adamw_streams: int = 1          # 2: each block takes one chunk from each
    #   contiguous half of a tensor (the JAX kernel's decoupled streams)
    # the JAX TroopConfig's knobs (dotp, axpy, dense decode_attention)
    streams: int = 2                # contiguous halves walked side by side
    unroll: int = 1                 # 16-byte loads in flight per thread
    block_n: int = 256              # threads a block of qgemv,
    #   batched_qgemv and batched_mx_qgemv; elsewhere predictor only
    #   (output-tile rows)
    block_k: int = 512              # elements per block-step of one stream
    scrambled_layout: bool = True   # predictor only (pre-tiled weights)

    def validate(self) -> "LaunchConfig":
        """The JAX ``TroopConfig.validate`` ranges; raises ``ValueError``
        (``enumerate_space`` drops a candidate that fails them)."""
        if self.streams not in (1, 2) or self.unroll not in (1, 2, 4):
            raise ValueError(f"streams must be 1 or 2 and unroll 1, 2 or 4; "
                             f"got {self.streams}, {self.unroll}")
        return self


DEFAULT = LaunchConfig()
# the JAX package's two presets (``repro/core/troop.py``), on the port's
# knobs: one stream and no unrolling, against two streams unrolled twice
BASELINE = LaunchConfig(streams=1, unroll=1, scrambled_layout=False)
TROOP = LaunchConfig(streams=2, unroll=2, scrambled_layout=True)


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

