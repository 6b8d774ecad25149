"""Hand-written CUDA kernels of the port — registry-dispatched entry points.

Importing this package loads every kernel module, which registers each
kernel into ``repro_torch.tune.registry`` under the JAX package's name.
The kernel names exported here are the dispatching wrappers, as in
``repro.kernels``: call one *with* an explicit ``LaunchConfig`` and it
behaves like the raw kernel; call it *without* one and the best tuned
config for (kernel, shapes, dtype, backend) is resolved from the
persistent tune cache (the default config on a miss).  Every name of the
registry is a hand-written CUDA kernel (``wkv6`` is registered as
``"rwkv6"``, the JAX name).  ``batched_gemv``, ``decode_attention_stats``,
``lse_combine`` and ``wkv6_with_state`` are not registered (as in JAX) and
take the default config.  The raw kernels (the ``fused_adamw`` there takes
a whole leaf of tensors), their plain versions (``PLAIN``), the launch
counters and ``build`` are in ``repro_torch.kernels.ops``; the model path
calls those.
"""
from repro_torch.core.troop import BASELINE, TROOP, LaunchConfig
from repro_torch.kernels.ops import (PLAIN, batched_gemv, build,
                                     decode_attention_stats, launch_counts,
                                     lse_combine, reset_launch_counts,
                                     wkv6_with_state)
from repro_torch.kernels.axpy import axpy_tuned as axpy
from repro_torch.kernels.decode_attention import (
    decode_attention_int8_tuned as decode_attention_int8,
    decode_attention_tuned as decode_attention,
    paged_decode_attention_int8_tuned as paged_decode_attention_int8,
    paged_decode_attention_tuned as paged_decode_attention)
from repro_torch.kernels.dotp import dotp_tuned as dotp
from repro_torch.kernels.flash_attention import (
    flash_attention_tuned as flash_attention)
from repro_torch.kernels.fused_adamw import fused_adamw_tuned as fused_adamw
from repro_torch.kernels.gemv import gemv_tuned as gemv
from repro_torch.kernels.mamba_scan import mamba_scan_tuned as mamba_scan
from repro_torch.kernels.mx_gemv import (
    batched_mx_qgemv_tuned as batched_mx_qgemv,
    grouped_expert_qgemv_tuned as grouped_expert_qgemv,
    mx_qgemv_swiglu_tuned as mx_qgemv_swiglu, mx_qgemv_tuned as mx_qgemv)
from repro_torch.kernels.prefill_attention import (
    prefill_attention_paged_tuned as prefill_attention_paged)
from repro_torch.kernels.qgemv import batched_qgemv_tuned as batched_qgemv
from repro_torch.kernels.qgemv import qgemv_tuned as qgemv
from repro_torch.kernels.rmsnorm import rmsnorm_tuned as rmsnorm
from repro_torch.kernels.rwkv6 import wkv6_tuned as wkv6
from repro_torch.tune.cache import get_tuned
from repro_torch.tune.registry import REGISTRY

__all__ = ["gemv", "dotp", "axpy", "rmsnorm", "fused_adamw",
           "decode_attention", "decode_attention_stats",
           "decode_attention_int8", "paged_decode_attention",
           "paged_decode_attention_int8", "prefill_attention_paged",
           "qgemv", "batched_qgemv",
           "mx_qgemv", "batched_mx_qgemv", "mx_qgemv_swiglu",
           "grouped_expert_qgemv",
           "flash_attention", "wkv6", "wkv6_with_state", "mamba_scan",
           "batched_gemv",
           "lse_combine", "BASELINE", "TROOP", "LaunchConfig",
           "get_tuned", "REGISTRY", "PLAIN", "launch_counts",
           "reset_launch_counts", "build"]
