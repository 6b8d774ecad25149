"""GEMV: the wrapper of ``csrc/gemv.cu``, its launch count and its plain
version.

Replaces the JAX package's Pallas ``kernels/gemv.py:gemv``.  The CUDA kernel
is bound by the bytes of W; ``csrc/gemv.cu`` says how its design meets that.
"""
from __future__ import annotations

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGTYPES = {"repro_gemv_bf16": [_build.P, _build.P, _build.P, _build.I,
                                 _build.I, _build.I, _build.P]}


def plain(w, x):
    """The plain PyTorch version: (N,) fp32."""
    return ref.gemv(w, x)


def gemv(w, x, cfg: LaunchConfig = DEFAULT):
    """w (N, K), x (K,) -> y (N,) fp32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 w and x, contiguous and 16-byte aligned, K a multiple of 8) or
    raises."""
    global launches
    if w.device.type == "cpu":
        return plain(w, x)
    if w.device.type != "cuda":
        raise ValueError(f"gemv: unsupported device {w.device}")
    N, K = w.shape
    if (w.dtype != torch.bfloat16 or x.dtype != torch.bfloat16
            or x.shape != (K,) or x.device != w.device
            or not w.is_contiguous() or not x.is_contiguous()
            or K % 8 or w.data_ptr() % 16 or x.data_ptr() % 16):
        raise ValueError(
            f"gemv kernel takes contiguous, 16-byte aligned bf16 w (N, K) and "
            f"x (K,) on one device with K % 8 == 0; got w {tuple(w.shape)} "
            f"{w.dtype}, x {tuple(x.shape)} {x.dtype}")
    y = torch.empty((N,), dtype=torch.float32, device=w.device)
    lib = _build.library("gemv", _ARGTYPES)
    err = lib.repro_gemv_bf16(w.data_ptr(), x.data_ptr(), y.data_ptr(), N, K,
                              cfg.gemv_warps, _build.stream_handle(w.device))
    _build.check(err, "gemv")
    launches += 1
    return y
