"""AXPY: the wrapper of ``csrc/axpy.cu``, its launch count, its plain
version and its registry entry.

Replaces the JAX package's Pallas ``kernels/axpy.py:axpy`` — the paper's
3:1 bandwidth-to-compute kernel.  The CUDA kernel is bound by the bytes of
x, y and the output; ``csrc/axpy.cu`` says how its design meets that and
why it gives its plain version's bits.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import itemsize, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGS = [_build.F] + [_build.P] * 3 + [_build.I] * 7 + [_build.P]
_ARGTYPES = {"repro_axpy_bf16": _ARGS, "repro_axpy_f32": _ARGS}
# elements per 16-byte load, by dtype
_VEC = {torch.bfloat16: 8, torch.float32: 4}
#: shared memory one block may take (bytes) and what its barriers take
SMEM_LIMIT, BARRIER_BYTES = 227 * 1024, 128
#: threads a block of ``csrc/axpy.cu`` and threads an SM holds at once
THREADS, SM_THREADS = 256, 2048
#: waves of the card (every SM full, a 16-byte vector a thread) up to which
#: ``axpy`` takes the vector path: on the H100 it was faster than the
#: stream from 2^20 to 2^23 bf16 (up to 4 waves) and even with it at 2^24
#: and 2^27 (PERF.md, ``scripts/chip_probe.py``)
VECTOR_WAVES = 4


class AxpyPlan(NamedTuple):
    """How ``csrc/axpy.cu`` walks n elements: tiles of ``tile_v`` 16-byte
    vectors (``vec`` elements each); the ``tiles`` whole ones in ``streams``
    contiguous parts of ``per`` tiles (the last part may hold fewer), part
    p holding tiles [p per, min((p + 1) per, tiles)); ``blocks`` blocks of
    ``spb`` steps each (block b: steps [b spb, (b + 1) spb), step i being
    tile i of every part), each tile of a step in a slot of its own; the
    ``tail`` vectors from ``tiles * tile_v`` on, on the vector path (all
    of them where ``tiles`` is 0); ``smem`` bytes a block."""
    vec: int
    nv: int
    tile_v: int
    tiles: int
    per: int
    streams: int
    spb: int
    blocks: int
    tail: int
    smem: int

    def parts(self):
        """[first, end) tile of each part."""
        return [(p * self.per, min((p + 1) * self.per, self.tiles))
                for p in range(self.streams)]


def vector_plan(n: int, itemsize: int, cfg: LaunchConfig) -> AxpyPlan:
    """The vector path alone: no tile, a 16-byte vector a thread, no knob
    of ``cfg`` read."""
    vec = 16 // itemsize
    nv = n // vec
    return AxpyPlan(vec, nv, cfg.block_k, 0, 0, cfg.streams, 1,
                    max(1, -(-nv // THREADS)), nv, 0)


def stream_plan(n: int, itemsize: int, cfg: LaunchConfig) -> AxpyPlan:
    """The stream: ``cfg.block_k`` 16-byte vectors a tile, ``cfg.streams``
    parts, ``cfg.unroll`` steps a block (as many as fit in a block's shared
    memory, with its barriers: at most 16 slots in all), all in flight at
    once; as many blocks as that takes; the tail on the vector path."""
    vec = 16 // itemsize
    nv = n // vec
    tile_v, streams = cfg.block_k, cfg.streams
    slot = streams * 2 * tile_v * 16
    spb = min(cfg.unroll, (SMEM_LIMIT - BARRIER_BYTES) // slot,
              BARRIER_BYTES // 8 // streams)
    tiles = nv // tile_v
    per = -(-tiles // streams)
    return AxpyPlan(vec, nv, tile_v, tiles, per, streams, spb,
                    max(1, -(-per // spb)), nv - tiles * tile_v,
                    BARRIER_BYTES + spb * slot)


@functools.lru_cache(maxsize=None)
def axpy_plan(n: int, itemsize: int, cfg: LaunchConfig,
              sms: int) -> AxpyPlan:
    """The launch plan of ``axpy`` over n elements of ``itemsize`` bytes on
    ``sms`` SMs: the vector path where ``VECTOR_WAVES`` waves of the card
    take n at a 16-byte vector a thread (up to 2^23 bf16 on 132 SMs), else
    the stream."""
    if n // (16 // itemsize) <= VECTOR_WAVES * sms * SM_THREADS:
        return vector_plan(n, itemsize, cfg)
    return stream_plan(n, itemsize, cfg)


def plain(a: float, x, y):
    """The plain PyTorch version: a * x + y in fp32 (a multiply and an add,
    each rounded), rounded to y's dtype."""
    return ref.axpy(a, x, y)


def axpy(a: float, x, y, cfg: LaunchConfig = DEFAULT):
    """a (a Python number, taken as fp32), x, y (K,) -> a * x + y, a new
    tensor in y's dtype (y is not written).

    Up to ``VECTOR_WAVES`` waves of the card at a 16-byte vector a thread,
    each thread takes a vector; past that, ``cfg.streams`` contiguous parts
    are walked side by side in tiles of ``cfg.block_k`` 16-byte vectors, a
    block taking ``cfg.unroll`` tiles of each part through shared memory
    (``axpy_plan``).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (x and y both bf16 with K % 8 == 0 or both fp32
    with K % 4 == 0, contiguous and 16-byte aligned) or raises."""
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
    return run_plan(a, x, y, axpy_plan(n, x.element_size(), cfg,
                                       _build.sm_count(x.device)))


def run_plan(a: float, x, y, plan: AxpyPlan):
    """``csrc/axpy.cu`` on CUDA x, y as ``axpy`` checked them, walked as
    ``plan`` says; counted in ``launches``."""
    global launches
    out = torch.empty_like(y)
    lib = _build.library("axpy", _ARGTYPES)
    fn = lib.repro_axpy_f32 if x.dtype == torch.float32 \
        else lib.repro_axpy_bf16
    _build.check(fn(float(a), x.data_ptr(), y.data_ptr(), out.data_ptr(),
                    x.shape[0], plan.tile_v, plan.tiles, plan.per,
                    plan.streams, plan.spb, plan.blocks,
                    _build.stream_handle(x.device)), "axpy")
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
    # one part, one step a block, 4 KB tiles (bf16): the fastest candidate
    # of the stream at 2^27 bf16 on the H100 (PERF.md)
    default=LaunchConfig(streams=1, unroll=1, block_k=256),
    ref="axpy", example=_example)(axpy)
