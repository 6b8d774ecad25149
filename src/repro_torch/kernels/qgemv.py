"""The quantized GEMV and its batched form: the wrappers of
``csrc/qgemv.cu``, their launch counts, their plain versions and their
registry entries.

Replace the JAX package's Pallas ``quant/kernels.py:qgemv`` and
``quant/kernels.py:batched_qgemv``.  The weight keeps the JAX kernels'
layout, ``(N, K)`` absmax int8 codes or ``(N, K/2)`` int4 codes packed two a
byte along K, with ``(N, K/g)`` fp32 scales; ``bits`` says which, as in the
JAX package (it is never inferred from the shapes).  These kernels take the
registry's and the tuner's operands: the engine's int weights are stored
``(K, N)`` and dequantize in the graph, as in the JAX package.  The CUDA
kernels are bound by the code and scale bytes; ``csrc/qgemv.cu`` says how
their design meets that: a tile walk on the tensor cores (``mma.sync``),
for groups narrower than a k-step the SIMT walk (``batched_qgemv_plan``
picks, and says why).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.quant.tensor import quantize
from repro_torch.tune.registry import (itemsize, meta, numel, seeded,
                                       troop_kernel)

#: kernel launches so far (the CPU path and the plain versions do not count)
launches = 0
batched_launches = 0

_P, _I = _build.P, _build.I
_ARGTYPES = {"repro_qgemv": [_P] * 4 + [_I] * 8 + [_P],
             "repro_qgemv_mma": [_P] * 4 + [_I] * 9 + [_P]}
#: rows of xs one launch takes
MAX_BATCH = 16
_SMEM = 227 * 1024
#: warps a block of the tile walk (``__launch_bounds__(256)``)
MAX_TILE_WARPS = 8
#: k-steps of a round, per unit of ``unroll``, and at most
STEPS_IN_FLIGHT, MAX_ROUND = 4, 16


def k_step(bits: int) -> int:
    """k of one k-step of the tile walk: a 16-byte vector of codes a lane,
    four lanes across a row (64 int8 codes, 128 int4)."""
    return 4 * (32 if bits == 4 else 16)


class QgemvTilePlan(NamedTuple):
    """How ``batched_qgemv`` launches: ``route`` "tile" (``mma.sync``) or
    "walk" (the SIMT walk) and ``why``.  For the tile walk: ``warps`` a
    block, ``steps`` k-steps a round (their loads in flight together),
    ``ksplit`` warps on one 16-row tile (each taking every ksplit-th
    round), ``tiles`` of 16 rows, ``blocks``; ``kstep`` and ``gsteps``
    (k-steps a group)."""
    route: str
    why: str
    warps: int = 0
    steps: int = 0
    ksplit: int = 0
    tiles: int = 0
    blocks: int = 0
    kstep: int = 0
    gsteps: int = 0

    def rounds(self, K: int, wk: int):
        """The first k-step of each round the ``wk``-th warp of a tile
        walks (the kernel's loop)."""
        return range(wk * self.steps, K // self.kstep,
                     self.ksplit * self.steps)


def batched_qgemv_plan(N: int, K: int, G: int, B: int, bits: int,
                       cfg: LaunchConfig, sms: int) -> QgemvTilePlan:
    """The tile walk for 1 <= B <= 16 where a group (K / G codes) holds
    whole k-steps; the SIMT walk for narrower groups, and where xs with its
    padding (16 bytes a row) passes the shared memory.  One row of x is one
    n-tile with seven dead columns: the walk is bound by bytes, and on the
    H100 it beat the SIMT walk at every smoke row (int4 / int8 read-out
    40.50 / 59.23 us against 64.96 / 70.90, (2048, 4096) 5.95 / 7.60
    against 6.22 / 8.53; PERF.md), so no shape of tiles and K keeps the
    SIMT walk for whole groups.

    Tile walk: ``cfg.block_n`` / 32 warps a block (at most 8), ``cfg.unroll``
    x 4 k-steps a round; ksplit doubles while it divides the warps, each
    warp keeps at least one whole round, and the tiles' warps stay under 16
    an SM.  Where K is split, the round then doubles (up to 16 steps) while
    every warp keeps one, so a warp's share is in flight at once.
    (2048, 4096) int8 at 8 warps: ksplit 8, 8 steps; the read-out: 1, 4."""
    kstep = k_step(bits)
    if (K // G) % kstep:
        return QgemvTilePlan("walk", f"groups of {K // G} codes are "
                             f"narrower than (or not a multiple of) a "
                             f"k-step of {kstep}: the SIMT walk")
    if B * (K // 8 + 1) * 16 > _SMEM:
        return QgemvTilePlan("walk", f"xs of {B} rows of {K} with its "
                             f"padding is past {_SMEM} bytes of shared "
                             f"memory: the SIMT walk")
    warps, steps = cfg.block_n // 32, STEPS_IN_FLIGHT * cfg.unroll
    if cfg.block_n % 32 or not 1 <= warps <= MAX_TILE_WARPS \
            or cfg.unroll not in (1, 2, 4):
        raise ValueError(f"batched_qgemv: block_n {cfg.block_n} (32 "
                         f"threads a warp, up to {MAX_TILE_WARPS} warps on "
                         f"the tile walk) and unroll {cfg.unroll} (x "
                         f"{STEPS_IN_FLIGHT} k-steps a round: 1, 2 or 4) "
                         f"out of range")
    tiles, nsteps, ksplit = -(-N // 16), K // kstep, 1
    while (warps % (2 * ksplit) == 0 and 2 * ksplit * steps <= nsteps
           and tiles * ksplit < 16 * sms):
        ksplit *= 2
    while ksplit > 1 and steps < MAX_ROUND and 2 * ksplit * steps <= nsteps:
        steps *= 2
    rows = "one row of x (seven dead columns)" if B == 1 \
        else f"{B} rows of x"
    return QgemvTilePlan("tile", f"{rows}, groups of {K // G} codes "
                         f"in whole k-steps of {kstep}: mma.sync",
                         warps, steps, ksplit, tiles,
                         -(-tiles // (warps // ksplit)), kstep,
                         K // G // kstep)


def walk_blocks(N: int, K: int, B: int, cfg: LaunchConfig, sms: int):
    """(warps, rows, blocks) of the SIMT walk: ``cfg.block_n`` / 32 warps a
    block, ``cfg.unroll`` W rows a warp, as many blocks as the rows need
    up to what ``sms`` SMs hold at once (threads, and xs in shared
    memory)."""
    warps, rows = cfg.block_n // 32, cfg.unroll
    if not 1 <= warps <= 32 or rows not in (1, 2, 4):
        raise ValueError(f"qgemv: block_n {cfg.block_n} (32 threads a "
                         f"warp, up to 32 warps) and unroll {cfg.unroll} "
                         f"(W rows a warp: 1, 2 or 4) out of range")
    per_sm = max(1, min(2048 // (warps * 32), _SMEM // (B * K * 2)))
    return warps, rows, max(1, min(-(-N // (warps * rows)), sms * per_sm))


def plain(wq, scales, x, *, bits: int = 8):
    """The plain PyTorch version of ``qgemv``: (N,) fp32."""
    return ref.qgemv(wq, scales, x, bits=bits)


def plain_batched(wq, scales, xs, *, bits: int = 8):
    """The plain PyTorch version of ``batched_qgemv``: (B, N) fp32."""
    return ref.batched_qgemv(wq, scales, xs, bits=bits)


def _launch(name, wq, scales, xs, bits, cfg):
    """Y (B, N) fp32 from the kernel, after the checks it needs."""
    N = wq.shape[0] if wq.dim() == 2 else -1
    B, K = xs.shape if xs.dim() == 2 else (-1, -1)
    vec = 32 if bits == 4 else 16
    G = scales.shape[1] if scales.dim() == 2 else -1
    if (bits not in (8, 4) or wq.dtype != torch.int8 or wq.dim() != 2
            or wq.shape[1] != (K // 2 if bits == 4 else K)
            or scales.dtype != torch.float32 or scales.shape != (N, G)
            or xs.dtype != torch.bfloat16 or not 1 <= B <= MAX_BATCH
            or K % vec or G < 1 or K % G or (K // G) % vec
            or B * K * 2 > _SMEM
            or not all(t.device == wq.device and t.is_contiguous()
                       for t in (wq, scales, xs))
            or wq.data_ptr() % 16 or xs.data_ptr() % 16):
        raise ValueError(
            f"{name} kernel takes contiguous, 16-byte aligned int8 codes "
            f"(N, K) (bits=8) or packed int4 (N, K/2) (bits=4), fp32 scales "
            f"(N, G) with whole {vec}-code vectors in each of the G groups, "
            f"and bf16 x with 1 <= rows <= {MAX_BATCH} and rows * K * 2 <= "
            f"{_SMEM} bytes, on one device; got codes {tuple(wq.shape)} "
            f"{wq.dtype}, scales {tuple(scales.shape)} {scales.dtype}, x "
            f"{tuple(xs.shape)} {xs.dtype}, bits {bits}")
    sms = _build.sm_count(wq.device)
    plan = batched_qgemv_plan(N, K, G, B, bits, cfg, sms)
    y = torch.empty((B, N), dtype=torch.float32, device=wq.device)
    lib = _build.library("qgemv", _ARGTYPES)
    if plan.route == "tile":
        err = lib.repro_qgemv_mma(
            wq.data_ptr(), scales.data_ptr(), xs.data_ptr(), y.data_ptr(), N,
            K, G, B, bits, plan.warps, plan.steps, plan.ksplit, plan.blocks,
            _build.stream_handle(wq.device))
        _build.check(err, name)
        return y
    warps, rows, blocks = walk_blocks(N, K, B, cfg, sms)
    err = lib.repro_qgemv(wq.data_ptr(), scales.data_ptr(), xs.data_ptr(),
                          y.data_ptr(), N, K, G, B, bits, warps, rows, blocks,
                          _build.stream_handle(wq.device))
    _build.check(err, name)
    return y


def qgemv(wq, scales, x, cfg: LaunchConfig = DEFAULT, *, bits: int = 8):
    """y (N,) fp32 = dequant(wq, scales) . x for codes wq (N, K) int8
    (``bits=8``) or (N, K/2) packed int4 (``bits=4``), scales (N, K/g) fp32
    and x (K,): ``batched_qgemv``'s kernels at one row, as
    ``batched_qgemv_plan`` routes it (``cfg.block_n`` / 32 warps a block;
    ``cfg.unroll`` x 4 k-steps a round on the tile walk, W rows a warp on
    the SIMT walk).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 x) or raises."""
    global launches
    if wq.device.type == "cpu":
        return plain(wq, scales, x, bits=bits)
    if wq.device.type != "cuda":
        raise ValueError(f"qgemv: unsupported device {wq.device}")
    if x.dim() != 1:
        raise ValueError(f"qgemv kernel takes one row x (K,); got "
                         f"{tuple(x.shape)} (batched_qgemv takes rows)")
    y = _launch("qgemv", wq, scales, x[None], bits, cfg)
    launches += 1
    return y.reshape(-1)


def batched_qgemv(wq, scales, xs, cfg: LaunchConfig = DEFAULT, *,
                  bits: int = 8):
    """Y (B, N) fp32 = xs (B, K) . dequant(wq, scales)^T: ``qgemv`` of every
    row of xs, reading the codes once for all of them.  With groups of
    whole k-steps the products run on the tensor cores
    (``batched_qgemv_plan``: ``cfg.block_n`` / 32 warps a block,
    ``cfg.unroll`` x 4 k-steps a round); otherwise on ``qgemv``'s walk.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 xs, 1 <= B <= 16) or raises."""
    global batched_launches
    if wq.device.type == "cpu":
        return plain_batched(wq, scales, xs, bits=bits)
    if wq.device.type != "cuda":
        raise ValueError(f"batched_qgemv: unsupported device {wq.device}")
    y = _launch("batched_qgemv", wq, scales, xs, bits, cfg)
    batched_launches += 1
    return y


# --------------------------------------------------------------------------
# registry entries (the JAX package's cost models and example shapes)
# --------------------------------------------------------------------------
# the JAX quantized GEMVs' space: ``block_n`` / 32 warps a block, and
# ``unroll`` W rows a warp (the SIMT walk) or 4 x unroll k-steps a round
# (the tile walk), move the CUDA kernels; ``streams`` and ``block_k`` feed
# only the predictor
_QSPACE = {"streams": (1, 2), "unroll": (1, 2),
           "block_n": (128, 256), "block_k": (256, 512)}


def _q_example(small: bool = True, device=None, batch: int = 0,
               bits: int = 8):
    """The JAX ``_example``: (N, K) seeded weights quantized along K in
    groups of 128, x (K,) or xs (batch, K) bf16; ``bits=4`` passes
    ``bits`` as the kernel's keyword."""
    N, K = (128, 512) if small else (2048, 4096)
    qt = quantize(seeded(0, (N, K), torch.float32, device=device), bits=bits,
                  group_size=128, axis=-1)
    x = seeded(1, (batch, K) if batch else (K,), device=device)
    return (qt.values, qt.scales, x), ({} if bits == 8 else {"bits": bits})


def _qgemv_bytes(wq, s, x):
    K = x.shape[-1]
    B = x.shape[0] if len(x.shape) == 2 else 1
    return (numel(wq) * itemsize(wq) + numel(s) * itemsize(s)
            + B * K * itemsize(x) + B * wq.shape[0] * 4)


def _qgemv_streamed(wq, s, x):
    out = (x.shape[0], wq.shape[0]) if len(x.shape) == 2 else (wq.shape[0],)
    return [wq, s, x, meta(out, torch.float32)]


#: the quantized GEMVs through the tune registry
qgemv_tuned = troop_kernel(
    "qgemv",
    flops=lambda wq, s, x: 2.0 * wq.shape[0] * x.shape[0],
    bytes=_qgemv_bytes, streamed=_qgemv_streamed, space=_QSPACE,
    key_kwargs=("bits",), ref="qgemv", example=_q_example)(qgemv)
batched_qgemv_tuned = troop_kernel(
    "batched_qgemv",
    flops=lambda wq, s, xs: 2.0 * xs.shape[0] * wq.shape[0] * xs.shape[1],
    bytes=_qgemv_bytes, streamed=_qgemv_streamed, space=_QSPACE,
    key_kwargs=("bits",), ref="batched_qgemv",
    example=functools.partial(_q_example, batch=4))(batched_qgemv)
