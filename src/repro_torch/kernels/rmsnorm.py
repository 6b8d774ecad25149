"""RMSNorm: the wrapper of ``csrc/rmsnorm.cu``, its launch count, its plain
version and its registry entry.

Replaces the JAX package's Pallas ``kernels/rmsnorm.py:rmsnorm``.  The CUDA
kernel is bound by bytes (one read and one write of x), but at the served
shapes its bound is a small fraction of a launch; ``csrc/rmsnorm.cu`` says
how its design (a warp a row, one round trip to memory, a programmatic
dependent launch) meets that.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import itemsize, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGTYPES = {"repro_rmsnorm_bf16": [_build.P, _build.P, _build.P, _build.I,
                                    _build.I, _build.F, _build.I, _build.I,
                                    _build.I, _build.P]}
#: 16-byte vectors of a row one lane holds (``kMaxVecs`` in the source)
MAX_VECS = 8
#: warps a block at most (``__launch_bounds__(512)``): d up to 32,768
MAX_ROW_WARPS = 16


class RmsnormPlan(NamedTuple):
    """A launch of ``csrc/rmsnorm.cu``: ``wpr`` warps a row, each lane
    holding up to ``vpl`` 16-byte vectors of it (lane l of the row's warp w
    takes vectors 32 w + l + 32 wpr v), ``rows`` rows a block of
    ``threads`` threads, ``blocks`` blocks."""
    wpr: int
    vpl: int
    rows: int
    threads: int
    blocks: int


def rmsnorm_plan(T: int, d: int, threads: int) -> RmsnormPlan:
    """A warp a row where d fits 8 vectors a lane (d <= 2048), else the
    fewest warps that hold it; ``threads`` / 32 warps a block, so
    ``threads`` / (32 wpr) rows a block (at least one).  Vectors a lane: a
    power of two, the fewest that cover the row."""
    nvec = d // 8
    wpr = max(1, -(-nvec // (32 * MAX_VECS)))
    if d <= 0 or d % 8 or wpr > MAX_ROW_WARPS or threads % 32 or threads < 32:
        raise ValueError(f"rmsnorm: d {d} (a multiple of 8 up to "
                         f"{32 * MAX_ROW_WARPS * MAX_VECS * 8}) or "
                         f"rmsnorm_threads {threads} (a multiple of 32) "
                         f"out of range")
    need = -(-nvec // (32 * wpr))
    vpl = 1
    while vpl < need:
        vpl *= 2
    rows = max(1, min(threads // 32, MAX_ROW_WARPS) // wpr)
    return RmsnormPlan(wpr, vpl, rows, rows * wpr * 32, -(-T // rows))


def plain(x, scale, eps: float = 1e-6):
    """The plain PyTorch version (fp32 math, output in x.dtype)."""
    return ref.rmsnorm(x, scale, eps)


def rmsnorm(x, scale, eps: float = 1e-6, cfg: LaunchConfig = DEFAULT):
    """x (T, d), scale (d,) -> normalized x (dtype preserved).

    The kernel takes a warp a row (several where d > 2048) and
    ``cfg.rmsnorm_threads`` / 32 warps a block (``rmsnorm_plan``), and is
    launched as a programmatic dependent of the kernel before it.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (bf16
    x, fp32 scale, contiguous, d a multiple of 8) or raises."""
    global launches
    if x.device.type == "cpu":
        return plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    T, d = x.shape
    if (x.dtype != torch.bfloat16 or scale.dtype != torch.float32
            or scale.shape != (d,) or scale.device != x.device
            or not x.is_contiguous() or not scale.is_contiguous()
            or d % 8 or x.data_ptr() % 16 or scale.data_ptr() % 16):
        raise ValueError(
            f"rmsnorm kernel takes contiguous bf16 x (T, d) with d % 8 == 0 "
            f"and fp32 scale (d,) on one device; got x {tuple(x.shape)} "
            f"{x.dtype}, scale {tuple(scale.shape)} {scale.dtype}")
    plan = rmsnorm_plan(T, d, cfg.rmsnorm_threads)
    out = torch.empty_like(x)
    lib = _build.library("rmsnorm", _ARGTYPES)
    err = lib.repro_rmsnorm_bf16(x.data_ptr(), scale.data_ptr(),
                                 out.data_ptr(), T, d, float(eps), plan.wpr,
                                 plan.vpl, plan.rows,
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
