"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""
from repro_torch.kernels.ops import (PLAIN, build, gemv, grouped_expert_qgemv,
                                     launch_counts, mx_qgemv,
                                     mx_qgemv_swiglu, paged_decode_attention,
                                     paged_decode_attention_int8,
                                     prefill_attention_paged,
                                     reset_launch_counts, rmsnorm)

__all__ = ["rmsnorm", "gemv", "paged_decode_attention",
           "prefill_attention_paged", "paged_decode_attention_int8",
           "mx_qgemv", "mx_qgemv_swiglu", "grouped_expert_qgemv", "PLAIN",
           "launch_counts", "reset_launch_counts", "build"]
