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
from repro_torch.kernels import prefill_attention as _pre
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.gemv import gemv
from repro_torch.kernels.prefill_attention import prefill_attention_paged
from repro_torch.kernels.rmsnorm import rmsnorm

_MODULES = {"rmsnorm": _rms, "gemv": _gemv,
            "paged_decode_attention": _dec,
            "prefill_attention_paged": _pre}

#: the plain version of each kernel, by name
PLAIN = {name: mod.plain for name, mod in _MODULES.items()}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts():
    for mod in _MODULES.values():
        mod.launches = 0


def build() -> Dict[str, Dict[str, object]]:
    """Compile every kernel now (normally done at first use); returns the
    per-source build log, empty when the libraries were already built."""
    return _build.build_all()


__all__ = ["rmsnorm", "gemv", "paged_decode_attention",
           "prefill_attention_paged", "PLAIN", "launch_counts",
           "reset_launch_counts", "build"]
