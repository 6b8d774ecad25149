"""AXPY: the wrapper of ``csrc/axpy.cu``, its launch count, its plain
version and its registry entry.

Replaces the JAX package's Pallas ``kernels/axpy.py:axpy`` — the paper's
3:1 bandwidth-to-compute kernel.  The CUDA kernel is bound by the bytes of
x, y and the output; ``csrc/axpy.cu`` says how its design meets that and
why it gives its plain version's bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import itemsize, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGS = [_build.F] + [_build.P] * 3 + [_build.I] * 5 + [_build.P]
_ARGTYPES = {"repro_axpy_bf16": _ARGS, "repro_axpy_f32": _ARGS}
# elements per 16-byte load, by dtype
_VEC = {torch.bfloat16: 8, torch.float32: 4}


def plain(a: float, x, y):
    """The plain PyTorch version: a * x + y in fp32 (a multiply and an add,
    each rounded), rounded to y's dtype."""
    return ref.axpy(a, x, y)


def axpy(a: float, x, y, cfg: LaunchConfig = DEFAULT):
    """a (a Python number, taken as fp32), x, y (K,) -> a * x + y, a new
    tensor in y's dtype (y is not written).

    ``cfg.streams`` contiguous parts are walked side by side; a block of
    ``cfg.block_k / V`` threads takes ``cfg.unroll`` 16-byte vectors of
    each part per thread and step (V = 8 bf16 or 4 fp32).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (x and y
    both bf16 with K % 8 == 0 or both fp32 with K % 4 == 0, contiguous
    and 16-byte aligned) or raises."""
    global launches
    if x.device.type == "cpu":
        return plain(a, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"axpy: unsupported device {x.device}")
    vec = _VEC.get(x.dtype)
    n = x.shape[0] if x.dim() == 1 else -1
    if (vec is None or isinstance(a, torch.Tensor) or y.dtype != x.dtype
            or x.dim() != 1 or y.shape != x.shape or y.device != x.device
            or not x.is_contiguous() or not y.is_contiguous() or n % vec
            or x.data_ptr() % 16 or y.data_ptr() % 16):
        raise ValueError(
            f"axpy kernel takes a Python number a and contiguous, 16-byte "
            f"aligned x and y (K,) on one device, both bf16 with K % 8 == 0 "
            f"or both fp32 with K % 4 == 0; got a {type(a).__name__}, x "
            f"{tuple(x.shape)} {x.dtype}, y {tuple(y.shape)} {y.dtype}")
    out = torch.empty_like(y)
    threads = cfg.block_k // vec
    per_step = threads * cfg.unroll                   # vectors of one part
    part = -(-(n // vec) // cfg.streams)
    blocks = max(1, min(-(-part // per_step),
                        _build.resident_blocks(x.device, max(threads, 32))))
    lib = _build.library("axpy", _ARGTYPES)
    fn = lib.repro_axpy_bf16 if x.dtype == torch.bfloat16 \
        else lib.repro_axpy_f32
    err = fn(float(a), x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
             cfg.streams, cfg.unroll, cfg.block_k, blocks,
             _build.stream_handle(x.device))
    _build.check(err, "axpy")
    launches += 1
    return out


def _example(small: bool = True, device=None):
    n = 4096 if small else 1 << 20
    return (1.5, seeded(0, (n,), device=device),
            seeded(1, (n,), device=device)), {}


#: ``axpy`` through the tune registry (the JAX package's cost model)
axpy_tuned = troop_kernel(
    "axpy",
    flops=lambda a, x, y: 2.0 * x.shape[0],
    bytes=lambda a, x, y: x.shape[0] * (itemsize(x) + 2 * itemsize(y)),
    streamed=lambda a, x, y: [x, y, y],      # y read + y-shaped result out
    space={"streams": (1, 2), "unroll": (1, 2),
           "block_k": (256, 512, 1024)},
    ref="axpy", example=_example)(axpy)
