"""RMSNorm: the wrapper of ``csrc/rmsnorm.cu``, its launch count, its plain
version and its registry entry.

Replaces the JAX package's Pallas ``kernels/rmsnorm.py:rmsnorm``.  The CUDA
kernel is bound by bytes (one read and one write of x); ``csrc/rmsnorm.cu``
says how its design meets that.
"""
from __future__ import annotations

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import itemsize, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGTYPES = {"repro_rmsnorm_bf16": [_build.P, _build.P, _build.P, _build.I,
                                    _build.I, _build.F, _build.I, _build.P]}


def plain(x, scale, eps: float = 1e-6):
    """The plain PyTorch version (fp32 math, output in x.dtype)."""
    return ref.rmsnorm(x, scale, eps)


def rmsnorm(x, scale, eps: float = 1e-6, cfg: LaunchConfig = DEFAULT):
    """x (T, d), scale (d,) -> normalized x (dtype preserved).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 x, fp32 scale, contiguous, d a multiple of 8) or raises."""
    global launches
    if x.device.type == "cpu":
        return plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    T, d = x.shape
    threads = cfg.rmsnorm_threads
    while d // 8 > threads * 4 and threads < 1024:
        threads *= 2
    if (x.dtype != torch.bfloat16 or scale.dtype != torch.float32
            or scale.shape != (d,) or scale.device != x.device
            or not x.is_contiguous() or not scale.is_contiguous()
            or d % 8 or d // 8 > threads * 4
            or x.data_ptr() % 16 or scale.data_ptr() % 16):
        raise ValueError(
            f"rmsnorm kernel takes contiguous bf16 x (T, d) with d % 8 == 0 "
            f"and fp32 scale (d,) on one device; got x {tuple(x.shape)} "
            f"{x.dtype}, scale {tuple(scale.shape)} {scale.dtype}")
    out = torch.empty_like(x)
    lib = _build.library("rmsnorm", _ARGTYPES)
    err = lib.repro_rmsnorm_bf16(x.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), T, d, float(eps), threads,
                                 _build.stream_handle(x.device))
    _build.check(err, "rmsnorm")
    launches += 1
    return out


def _example(small: bool = True, device=None):
    T, d = (8, 256) if small else (256, 4096)
    return (seeded(0, (T, d), device=device),
            seeded(1, (d,), torch.float32, device=device)), {}


#: ``rmsnorm`` through the tune registry (the JAX package's cost model)
rmsnorm_tuned = troop_kernel(
    "rmsnorm",
    flops=lambda x, s, *a: 4.0 * x.shape[0] * x.shape[1],
    bytes=lambda x, s, *a: (2 * x.shape[0] * x.shape[1] * itemsize(x)
                            + x.shape[1] * itemsize(s)),
    streamed=lambda x, s, *a: [x, s, x],     # x in, scale, x-shaped out
    space={"rmsnorm_threads": (64, 128, 256)},
    ref="rmsnorm", example=_example)(rmsnorm)
