"""Public kernel API of the port.

Every function here launches a CUDA kernel written for Hopper on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor; the plain
versions and the oracles are in ``ref.py``.  ``launch_counts`` /
``reset_launch_counts`` read and zero the per-kernel launch counters, which
is how a run shows that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import gemv as _gemv
from repro_torch.kernels import mx_gemv as _mx
from repro_torch.kernels import prefill_attention as _pre
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels.decode_attention import (paged_decode_attention,
                                                  paged_decode_attention_int8)
from repro_torch.kernels.gemv import gemv
from repro_torch.kernels.mx_gemv import (grouped_expert_qgemv, mx_qgemv,
                                         mx_qgemv_swiglu)
from repro_torch.kernels.prefill_attention import prefill_attention_paged
from repro_torch.kernels.rmsnorm import rmsnorm

# kernel name -> (wrapper module, its launch counter, its plain version)
_KERNELS = {
    "rmsnorm": (_rms, "launches", "plain"),
    "gemv": (_gemv, "launches", "plain"),
    "paged_decode_attention": (_dec, "launches", "plain"),
    "prefill_attention_paged": (_pre, "launches", "plain"),
    "paged_decode_attention_int8": (_dec, "int8_launches", "plain_int8"),
    "mx_qgemv": (_mx, "launches", "plain"),
    "mx_qgemv_swiglu": (_mx, "swiglu_launches", "plain_swiglu"),
    "grouped_expert_qgemv": (_mx, "grouped_launches", "plain_grouped"),
}

#: the plain version of each kernel, by name
PLAIN = {name: getattr(mod, fn) for name, (mod, _, fn) in _KERNELS.items()}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr, _) in _KERNELS.items()}


def reset_launch_counts():
    for mod, attr, _ in _KERNELS.values():
        setattr(mod, attr, 0)


def build() -> Dict[str, Dict[str, object]]:
    """Compile every kernel now (normally done at first use); returns the
    per-source build log, empty when the libraries were already built."""
    return _build.build_all()


__all__ = ["rmsnorm", "gemv", "paged_decode_attention",
           "prefill_attention_paged", "paged_decode_attention_int8",
           "mx_qgemv", "mx_qgemv_swiglu", "grouped_expert_qgemv", "PLAIN",
           "launch_counts", "reset_launch_counts", "build"]
