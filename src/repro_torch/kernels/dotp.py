"""DOTP: the wrapper of ``csrc/dotp.cu``, its launch plan, its launch
count, its plain version and its registry entry.

Replaces the JAX package's Pallas ``kernels/dotp.py:dotp`` — the paper's
2:1 bandwidth-to-compute kernel.  The CUDA kernel is bound by the bytes of
x and y; ``csrc/dotp.cu`` says how its design meets that, with a combine
launched as a programmatic dependent, and why two runs give the same
bits.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import itemsize, meta, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGS = [_build.P] * 4 + [_build.I] * 6 + [_build.P]
_ARGTYPES = {"repro_dotp_bf16": _ARGS, "repro_dotp_f32": _ARGS}
# elements per 16-byte load, by dtype
_VEC = {torch.bfloat16: 8, torch.float32: 4}
#: threads and blocks an SM holds at once
SM_THREADS, SM_BLOCKS = 2048, 32
#: threads of the combine: on the H100, 256 was faster than 1024 at five of
#: six sizes from 2^16 to 2^27 bf16 in two runs, and than 32 at all
#: (PERF.md, scripts/chip_probe.py --probes dotp)
COMBINE = 256


class DotpPlan(NamedTuple):
    """How ``csrc/dotp.cu`` walks two operands of ``nv`` 16-byte vectors
    (``vec`` elements each): ``streams`` contiguous parts of ``part``
    vectors (the last may hold fewer), part s holding vectors [s part,
    min((s + 1) part, nv)); ``steps`` steps of ``chunk`` = ``threads`` x
    ``vpt`` vectors of every part, step c covering [c chunk, (c + 1)
    chunk) of each, vector c chunk + u threads + t to thread t (u < vpt);
    ``blocks`` blocks, block b taking steps b, b + blocks, ...; every
    block's loads of a step are issued before its first FMA.  One block of
    ``combine`` threads, launched as a programmatic dependent, folds the
    ``blocks`` partials."""
    vec: int
    nv: int
    streams: int
    part: int
    threads: int
    vpt: int
    chunk: int
    steps: int
    blocks: int
    combine: int


@functools.lru_cache(maxsize=None)
def dotp_plan(n: int, itemsize: int, cfg: LaunchConfig,
              sms: int) -> DotpPlan:
    """The launch plan of ``dotp`` over n elements of ``itemsize`` bytes
    on ``sms`` SMs: ``cfg.streams`` parts, ``cfg.block_k / vec`` threads a
    block, ``cfg.unroll`` vectors of each part a thread and step.  Where
    the steps fit in one wave of the card (the blocks that its SMs hold at
    once, by threads), one block a step: every thread issues all of its
    loads before its first FMA (2^20 bf16 at every candidate on 132 SMs);
    past that, one wave of blocks strides over the steps."""
    vec = 16 // itemsize
    nv = n // vec
    threads = cfg.block_k // vec
    part = -(-nv // cfg.streams)
    chunk = threads * cfg.unroll
    steps = max(1, -(-part // chunk))
    resident = sms * min(SM_BLOCKS, SM_THREADS // threads)
    return DotpPlan(vec, nv, cfg.streams, part, threads, cfg.unroll, chunk,
                    steps, min(steps, resident), COMBINE)


def plain(x, y):
    """The plain PyTorch version: a 0-d fp32 tensor."""
    return ref.dotp(x, y)


def dotp(x, y, cfg: LaunchConfig = DEFAULT):
    """x, y (K,) -> 0-d fp32 tensor, accumulated in fp32.

    ``cfg.streams`` contiguous parts of each operand are walked side by
    side; a block of ``cfg.block_k / V`` threads takes ``cfg.unroll``
    16-byte vectors of each part per thread and step (V = 8 bf16 or 4
    fp32; ``dotp_plan``), and one block adds the blocks' partials in a
    fixed order.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (x and y both bf16 with K % 8 == 0 or both fp32
    with K % 4 == 0, contiguous and 16-byte aligned) or raises."""
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
    plan = dotp_plan(n, x.element_size(), cfg, _build.sm_count(x.device))
    partial = torch.empty((-(-plan.blocks // 4) * 4,), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _build.library("dotp", _ARGTYPES)
    fn = lib.repro_dotp_bf16 if x.dtype == torch.bfloat16 \
        else lib.repro_dotp_f32
    _build.check(fn(x.data_ptr(), y.data_ptr(), partial.data_ptr(),
                    out.data_ptr(), x.shape[0], plan.streams, plan.vpt,
                    plan.threads, plan.blocks, plan.combine,
                    _build.stream_handle(x.device)), "dotp")
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
