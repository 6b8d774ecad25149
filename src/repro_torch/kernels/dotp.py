"""DOTP: the wrapper of ``csrc/dotp.cu``, its launch count, its plain
version and its registry entry.

Replaces the JAX package's Pallas ``kernels/dotp.py:dotp`` — the paper's
2:1 bandwidth-to-compute kernel.  The CUDA kernel is bound by the bytes of
x and y; ``csrc/dotp.cu`` says how its design meets that and why two runs
give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import itemsize, meta, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGS = [_build.P] * 4 + [_build.I] * 5 + [_build.P]
_ARGTYPES = {"repro_dotp_bf16": _ARGS, "repro_dotp_f32": _ARGS}
# elements per 16-byte load, by dtype
_VEC = {torch.bfloat16: 8, torch.float32: 4}


def plain(x, y):
    """The plain PyTorch version: a 0-d fp32 tensor."""
    return ref.dotp(x, y)


def dotp(x, y, cfg: LaunchConfig = DEFAULT):
    """x, y (K,) -> 0-d fp32 tensor, accumulated in fp32.

    ``cfg.streams`` contiguous parts of each operand are walked side by
    side; a block of ``cfg.block_k / V`` threads takes ``cfg.unroll``
    16-byte vectors of each part per thread and step (V = 8 bf16 or 4
    fp32).  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (x and y both bf16 with K % 8 == 0 or both fp32 with
    K % 4 == 0, contiguous and 16-byte aligned) or raises."""
    global launches
    if x.device.type == "cpu":
        return plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"dotp: unsupported device {x.device}")
    vec = _VEC.get(x.dtype)
    n = x.shape[0] if x.dim() == 1 else -1
    if (vec is None or y.dtype != x.dtype or x.dim() != 1 or y.shape != x.shape
            or y.device != x.device or not x.is_contiguous()
            or not y.is_contiguous() or n % vec or x.data_ptr() % 16
            or y.data_ptr() % 16):
        raise ValueError(
            f"dotp kernel takes contiguous, 16-byte aligned x and y (K,) on "
            f"one device, both bf16 with K % 8 == 0 or both fp32 with "
            f"K % 4 == 0; got x {tuple(x.shape)} {x.dtype}, y "
            f"{tuple(y.shape)} {y.dtype}")
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    threads = cfg.block_k // vec
    per_step = threads * cfg.unroll                   # vectors of one part
    part = -(-(n // vec) // cfg.streams)
    blocks = max(1, min(-(-part // per_step),
                        _build.resident_blocks(x.device, max(threads, 32))))
    partial = torch.empty((blocks,), dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _build.library("dotp", _ARGTYPES)
    fn = lib.repro_dotp_bf16 if x.dtype == torch.bfloat16 \
        else lib.repro_dotp_f32
    err = fn(x.data_ptr(), y.data_ptr(), partial.data_ptr(), out.data_ptr(),
             n, cfg.streams, cfg.unroll, cfg.block_k, blocks,
             _build.stream_handle(x.device))
    _build.check(err, "dotp")
    launches += 1
    return out


def _example(small: bool = True, device=None):
    n = 4096 if small else 1 << 20
    return (seeded(0, (n,), device=device),
            seeded(1, (n,), device=device)), {}


#: ``dotp`` through the tune registry (the JAX package's cost model)
dotp_tuned = troop_kernel(
    "dotp",
    flops=lambda x, y: 2.0 * x.shape[0],
    bytes=lambda x, y: x.shape[0] * (itemsize(x) + itemsize(y)) + 4,
    streamed=lambda x, y: [x, y, meta((1,), torch.float32)],
    space={"streams": (1, 2), "unroll": (1, 2, 4),
           "block_k": (256, 512, 1024)},
    ref="dotp", example=_example)(dotp)
