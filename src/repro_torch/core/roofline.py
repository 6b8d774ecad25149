"""The card's roofline, as ``repro_torch.tune`` scores a kernel against it.

The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): device memory rate, the bf16 tensor-
core rate and the fp32 rate outside the tensor cores.  The names are those
of the JAX package's ``repro/core/roofline.py`` (whose values are a TPU's);
its XLA cost-analysis parsers have no counterpart in the port.
"""
from __future__ import annotations

HBM_BW = 3.35e12            # B/s, device memory
PEAK_FLOPS = 989e12         # bf16 FLOP/s, tensor cores
PEAK_FLOPS_F32 = 67e12      # fp32 FLOP/s, outside the tensor cores
