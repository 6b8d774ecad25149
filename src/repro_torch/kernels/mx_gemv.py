"""MX GEMV, its batched form, the fused MX SwiGLU and the grouped MX expert
GEMV: the wrappers of ``csrc/mx_gemv.cu``, their launch counts, their plain
versions and their registry entries.

Replace the JAX package's Pallas ``quant/kernels.py:mx_qgemv``,
``quant/kernels.py:batched_mx_qgemv``, ``quant/kernels.py:mx_qgemv_swiglu``
and ``quant/kernels.py:grouped_expert_qgemv``.  The weights keep the JAX
layout, ``(K | K/2, N)`` codes (fp4 packed along K in uint8, or
float8_e4m3fn) and ``(K/32, N)`` uint8 E8M0 scales, with a leading expert
axis for the grouped kernel.  The CUDA kernels are bound by the code and
scale bytes they read; ``csrc/mx_gemv.cu`` says how their design meets
that.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.quant.tensor import FP8_DTYPE, quantize_mx
from repro_torch.tune.registry import (itemsize, meta, numel, seeded,
                                       troop_kernel)

#: kernel launches so far (the CPU path and the plain versions do not count)
launches = 0
#: ``mx_qgemv``'s launches by shape ("fp4 K->N"), counted with ``launches``
shape_launches: Dict[str, int] = {}
batched_launches = 0
swiglu_launches = 0
grouped_launches = 0

_P, _I = _build.P, _build.I
_ARGTYPES = {
    "repro_mx_qgemv": [_P] * 4 + [_I] * 8 + [_P],
    "repro_mx_gemv_swiglu": [_P] * 6 + [_I] * 8 + [_P],
    "repro_mx_gemv_grouped": [_P] * 5 + [_I] * 9 + [_P],
    "repro_mx_gemv_batched": [_P] * 4 + [_I] * 9 + [_P],
}
#: rows of xs one batched launch takes
MAX_BATCH = 16
#: warps of the batched tile walk an SM past which K is split no further
SPLIT_WARPS = 64
_BLOCK = 32                             # mirrors kBlockRows


def plain(wq, scales, x):
    """The plain PyTorch version: (N,) fp32."""
    return ref.mx_qgemv(wq, scales, x)


def plain_batched(wq, scales, xs):
    """The plain PyTorch version of ``batched_mx_qgemv``: (B, N) fp32."""
    return ref.batched_mx_qgemv(wq, scales, xs)


def plain_swiglu(wg, sg, wu, su, x):
    """The plain PyTorch version: (N,) fp32."""
    return ref.mx_qgemv_swiglu(wg, sg, wu, su, x)


def plain_grouped(wq, scales, xs, ids):
    """The plain PyTorch version: (topk, N) fp32."""
    return ref.grouped_expert_qgemv(wq, scales, xs, ids)


def _check(name, wq, scales, x, stack=False, rows=False):
    """(N, K, bits) of a contiguous, aligned MX weight (or, ``stack``, a
    stack of them and one row of ``x`` per selected weight; ``rows``, rows
    of ``x`` against one weight) the kernel takes."""
    lead = wq.shape[:1] if stack else ()
    N, K = wq.shape[-1], x.shape[-1]
    bits = 8 if wq.dtype == FP8_DTYPE else 4
    ok = (wq.dim() == 2 + stack and wq.dtype in (torch.uint8, FP8_DTYPE)
          and wq.shape[-2] == (K if bits == 8 else K // 2)
          and scales.dtype == torch.uint8
          and scales.shape == lead + (K // _BLOCK, N) and K % _BLOCK == 0
          and N % 16 == 0 and x.dtype == torch.bfloat16
          and x.dim() == 1 + (stack or rows)
          and all(t.device == wq.device and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 for t in (wq, scales, x)))
    if not ok:
        what = "stacked (E, " if stack else "("
        raise ValueError(
            f"{name} kernel takes contiguous, 16-byte aligned MX codes "
            f"{what}K/2 uint8 | K fp8, N), uint8 E8M0 scales {what}K/32, N) "
            f"and bf16 x {'(rows, K)' if stack or rows else '(K,)'} on one "
            f"device "
            f"with K % 32 == 0 and N % 16 == 0; got codes "
            f"{tuple(wq.shape)} {wq.dtype}, scales {tuple(scales.shape)} "
            f"{scales.dtype}, x {tuple(x.shape)} {x.dtype}")
    return N, K, bits


class BatchedPlan(NamedTuple):
    """How ``batched_mx_qgemv``'s tile walk (``csrc/mx_gemv.cu``
    `mx_mma_kernel`) cuts N columns of (K, N) codes for B rows of x, and
    ``why``: warp tiles of 8 ``cols`` columns (``cols`` a lane: 8, or 2
    where the 64-column tiles are few), ``warps`` a block,
    ``ksplit`` of them on each tile (warp wk of a tile taking the rounds
    wk, wk + ksplit, ...), rounds of ``round_blocks`` E8M0 blocks (2
    ``round_blocks`` k16 steps), ``nt`` n-tiles of 8 x rows, ``tiles``,
    ``blocks``."""
    why: str
    cols: int
    warps: int
    round_blocks: int
    ksplit: int
    tiles: int
    blocks: int
    nt: int

    @property
    def tile(self) -> int:
        return 8 * self.cols

    def rounds(self, K: int, wk: int):
        """The first E8M0 block of each round the ``wk``-th warp of a tile
        walks (the kernel's loop)."""
        return range(wk * self.round_blocks, K // _BLOCK,
                     self.ksplit * self.round_blocks)

    def args(self):
        """The C entry point's plan arguments: cols, warps, round_blocks,
        ksplit, blocks."""
        return (self.cols, self.warps, self.round_blocks, self.ksplit,
                self.blocks)


def round_blocks(bits: int, cols: int, unroll: int) -> int:
    """E8M0 blocks a round of the tile walk, the template argument of
    ``csrc/mx_gemv.cu`` `mx_mma_kernel` that the C entry point takes from
    the plan: ``unroll`` x 64 bytes of codes a lane (fp4 2 blocks an
    unroll at 8 columns, 8 at 2; fp8 half as many)."""
    return 16 // cols * unroll // (2 if bits == 8 else 1)


def batched_plan(N: int, K: int, bits: int, B: int, cfg: LaunchConfig,
                 sms: int) -> BatchedPlan:
    """The tile walk's cut for B rows of x against (N, K) MX codes on
    ``sms`` SMs: ``cfg.block_n`` / 32 warps a block (4 or 8), ``cfg.unroll``
    (1 or 2) sizing the rounds (``round_blocks``).  A lane owns 8 columns
    (64-column warp tiles, one 8-byte load a code row) where those tiles
    give every SM two, else 2 (16-column tiles, as the int tile walk's 16
    rows: 4096 -> 2048 has 32 tiles of 64 columns and 128 of 16).
    ``ksplit`` doubles while it divides the warps, every warp keeps a whole
    round, and the tiles' warps stay under ``SPLIT_WARPS`` an SM; the
    split's partials meet in shared memory in warp order (one launch, the
    same bits twice).  One n-tile of 8 x rows for B <= 8, two up to 16.
    On the H100 (``scripts/chip_probe.py``; PERF.md), at 8 warps: the fp4
    read-out 57.75 / 49.25 / 48.06 / 51.27 us at a K split of 1 / 2 / 4 / 8
    for B = 8 (fp8 61.29 / 64.48 / 58.54 / 67.42, B = 16 61.68 / 54.84 /
    53.30 / 59.46), at 2 columns a lane 59.80 (B = 8); 4096 -> 2048 at
    B = 4 8.55 us at 2 columns, 13.36 at 8.  The default config's 8 warps
    are knowingly not the fastest cut at the fp4 read-out, B = 8: 4 warps
    took 42.62 us there against 48.06.  The warps stay ``cfg.block_n`` /
    32, the tuner's knob (block_n 128 is in its space), and the plan does
    not override them."""
    warps, unroll = cfg.block_n // 32, cfg.unroll
    if cfg.block_n % 32 or warps not in (4, 8) or unroll not in (1, 2) \
            or not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batched_mx_qgemv kernel takes 1 <= rows <= "
                         f"{MAX_BATCH}, block_n 128 or 256 and unroll 1 or "
                         f"2; got rows {B}, block_n {cfg.block_n}, unroll "
                         f"{unroll}")
    wide = -(-N // 64)
    cols = 8 if wide >= 2 * sms else 2
    rb = round_blocks(bits, cols, unroll)
    tiles, nkb, ks = -(-N // (8 * cols)), K // _BLOCK, 1
    while (warps % (2 * ks) == 0 and 2 * ks * rb <= nkb
           and tiles * ks < SPLIT_WARPS * sms):
        ks *= 2
    nt = 1 if B <= 8 else 2
    why = (f"{B} rows of x on mma.sync ({nt} n-tile{'s' * (nt > 1)}): "
           + (f"{wide} tiles of 64 columns give every SM two, 8 columns a "
              f"lane" if cols == 8 else
              f"{wide} tiles of 64 columns leave SMs idle, 2 columns a lane "
              f"({tiles} tiles of 16)")
           + f", K split over {ks} warps")
    return BatchedPlan(why, cols, warps, rb, ks, tiles,
                       -(-tiles // (warps // ks)), nt)


class QgemvPlan(NamedTuple):
    """How the one-row walk (``csrc/mx_gemv.cu`` `mx_walk_kernel`) cuts N
    columns by ``rows`` code rows (K/2 fp4, K fp8): ``tiles`` tiles of
    ``cols`` ``lpr`` columns (``lpr`` lanes across a row, ``cols`` columns
    a lane: one 16- or 8-byte load a row), one block a (tile, x row)
    taking all of its rows in ``rounds`` bands of ``band`` rows; in a
    band, each group of ``warps`` warps of 32 / ``lpr`` row lanes, each
    lane a run of ``rpl`` rows inside one E8M0 block (row lane i of warp w:
    rows (w 32 / lpr + i) rpl on from the band's first).  ``xrows`` rows of
    x (the grouped experts), ``streams`` weight streams (the SwiGLU's gate
    and up), a group of warps of the block each."""
    cols: int
    lpr: int
    warps: int
    rpl: int
    rounds: int
    tiles: int
    rows: int
    xrows: int = 1
    streams: int = 1

    @property
    def tile(self) -> int:
        return self.cols * self.lpr

    @property
    def band(self) -> int:
        return self.warps * (32 // self.lpr) * self.rpl

    @property
    def rows_per_block(self) -> int:
        return self.band * self.rounds

    @property
    def block_warps(self) -> int:
        return self.warps * self.streams

    @property
    def blocks(self) -> int:
        return self.tiles * self.xrows

    def args(self):
        """The C entry points' plan arguments: cols, lpr_log2, warps (a
        group), rpl, rounds."""
        return (self.cols, self.lpr.bit_length() - 1, self.warps, self.rpl,
                self.rounds)

    def lane_runs(self):
        """(weight stream, x row, tile, first column, first code row) of
        every lane's run in every round: ``cols`` columns and ``rpl`` rows
        from there, as the kernel walks them; block (tile, x row), group g
        walking stream g."""
        rlanes = 32 // self.lpr
        for xr in range(self.xrows):
            for t in range(self.tiles):
                for g in range(self.streams):
                    for r in range(self.rounds):
                        for w in range(self.warps):
                            for rl in range(rlanes):
                                r0 = (r * self.band
                                      + (w * rlanes + rl) * self.rpl)
                                for cl in range(self.lpr):
                                    yield (g, xr, t,
                                           t * self.tile + self.cols * cl, r0)


#: a bandwidth-bound shape's block: 8 lanes across a row (128 bytes),
#: 2 warps, runs of 8 rows: a band of 64 rows, walked in rounds down K
STREAM_LPR, STREAM_WARPS, STREAM_RPL = 8, 2, 8


@functools.lru_cache(maxsize=None)
def qgemv_plan(N: int, K: int, bits: int, sms: int, xrows: int = 1,
               streams: int = 1) -> QgemvPlan:
    """The one-row walk's cut for (N, K) on ``sms`` SMs, as measured on the
    H100 (PERF.md), for ``xrows`` rows of x and ``streams`` weight streams:
    ``m = xrows streams`` blocks' worth of lanes stand beside each tile's,
    so every count of lanes for the card below counts the columns m
    times.  A shape whose 128-column tiles alone give every SM 4 blocks
    streams: blocks of ``STREAM_WARPS`` warps a group walk a tile's whole
    K in bands of 64 rows, each lane a run of ``STREAM_RPL`` rows a band,
    many blocks an SM covering each other's waits.  Any other shape is a
    chain of latencies: 16 columns a lane where that gives half the SMs a
    lane's columns, else 8 (more SMs at 1024 columns, fewer at 2048); the
    widest tile of 8, 4 or 2 lanes across a row that still gives 16 tiles
    an SM, else one lane; a lane's run of rows, the most (at most 16 loads
    a lane) that still leave lanes for 8 warps an SM, and at least enough
    that one group of at most 8 warps covers all of K in one round; as few
    warps as cover it.  Where the most rows a lane and 8
    warps leave K uncovered, the group walks K in as many such rounds as
    it takes.  One stream of one row (``mx_qgemv``) is cut as before."""
    rows = K // 2 if bits == 4 else K
    m = xrows * streams
    rest = (rows, xrows, streams)
    wide = -(-N // (16 * STREAM_LPR))
    if wide * m >= 4 * sms:
        rpl = STREAM_RPL
        band = STREAM_WARPS * (32 // STREAM_LPR) * rpl
        return QgemvPlan(16, STREAM_LPR, STREAM_WARPS, rpl,
                         -(-rows // band), wide, *rest)
    cols = 16 if 2 * -(-N // 16) * m >= sms else 8
    groups = -(-N // cols) * m
    lpr = next((lanes for lanes in (8, 4, 2)
                if -(-N // (cols * lanes)) * m >= 16 * sms), 1)
    rlanes = 32 // lpr
    rpl = next((r for r in (16, 8, 4, 2)
                if groups * -(-rows // r) >= 8 * 32 * sms), 1)
    rpl = min(16, max(rpl, 1 << (-(-rows // (8 * rlanes)) - 1)
                      .bit_length()))
    least = -(-rows // (8 * rlanes * rpl))   # rounds of 8 warps covering K
    warps = min(8, -(-rows // (least * rlanes * rpl)))
    rounds = -(-rows // (warps * rlanes * rpl))
    return QgemvPlan(cols, lpr, warps, rpl, rounds, -(-N // (cols * lpr)),
                     *rest)


def swiglu_plan(N: int, K: int, bits: int, sms: int) -> QgemvPlan:
    """``mx_qgemv_swiglu``'s cut: the walk over two streams of one row,
    the gate and the up weight each on a group of warps of the block
    (every lane walking both, in runs of at most 8 rows, measured slower
    at fp4: ``csrc/mx_gemv.cu``'s header)."""
    return qgemv_plan(N, K, bits, sms, streams=2)


def grouped_plan(N: int, K: int, bits: int, sms: int,
                 rows: int) -> QgemvPlan:
    """``grouped_expert_qgemv``'s cut: the walk over ``rows`` rows of x,
    one block a (tile, row)."""
    return qgemv_plan(N, K, bits, sms, xrows=rows)


def mx_qgemv(wq, scales, x):
    """y (N,) fp32 = x (K,) . dequant(wq, scales), in one launch cut by
    ``qgemv_plan``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    global launches
    if wq.device.type == "cpu":
        return plain(wq, scales, x)
    if wq.device.type != "cuda":
        raise ValueError(f"mx_qgemv: unsupported device {wq.device}")
    N, K, bits = _check("mx_qgemv", wq, scales, x)
    lib = _build.library("mx_gemv", _ARGTYPES)
    plan = qgemv_plan(N, K, bits, _build.sm_count(wq.device))
    y = torch.empty((N,), dtype=torch.float32, device=wq.device)
    err = lib.repro_mx_qgemv(
        wq.data_ptr(), scales.data_ptr(), x.data_ptr(), y.data_ptr(), N, K,
        bits, *plan.args(), _build.stream_handle(wq.device))
    _build.check(err, "mx_qgemv")
    launches += 1
    key = f"fp{bits} {K}->{N}"
    shape_launches[key] = shape_launches.get(key, 0) + 1
    return y


def batched_mx_qgemv(wq, scales, xs, cfg: LaunchConfig = DEFAULT):
    """Y (B, N) fp32 = xs (B, K) . dequant(wq, scales): ``mx_qgemv`` of
    every row of xs, reading the codes once for all of them, on the tensor
    cores in one launch cut by ``batched_plan`` (``cfg.block_n`` / 32 warps
    a block, 4 or 8; ``cfg.unroll`` 1 or 2 sizes the rounds).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (1 <= B <= 16) or raises."""
    global batched_launches
    if wq.device.type == "cpu":
        return plain_batched(wq, scales, xs)
    if wq.device.type != "cuda":
        raise ValueError(f"batched_mx_qgemv: unsupported device {wq.device}")
    N, K, bits = _check("batched_mx_qgemv", wq, scales, xs, rows=True)
    dev = xs.device
    plan = batched_plan(N, K, bits, xs.shape[0], cfg, _build.sm_count(dev))
    lib = _build.library("mx_gemv", _ARGTYPES)
    y = torch.empty((xs.shape[0], N), dtype=torch.float32, device=dev)
    err = lib.repro_mx_gemv_batched(
        wq.data_ptr(), scales.data_ptr(), xs.data_ptr(), y.data_ptr(), N, K,
        xs.shape[0], bits, *plan.args(), _build.stream_handle(dev))
    _build.check(err, "batched_mx_qgemv")
    batched_launches += 1
    return y


def mx_qgemv_swiglu(wg, sg, wu, su, x):
    """y (N,) fp32 = silu(x . Wg) * (x . Wu), both MX weights of one
    format, in one pass.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    global swiglu_launches
    if wg.device.type == "cpu":
        return plain_swiglu(wg, sg, wu, su, x)
    if wg.device.type != "cuda":
        raise ValueError(f"mx_qgemv_swiglu: unsupported device {wg.device}")
    N, K, bits = _check("mx_qgemv_swiglu", wg, sg, x)
    if _check("mx_qgemv_swiglu", wu, su, x) != (N, K, bits):
        raise ValueError("mx_qgemv_swiglu: gate and up weights differ in "
                         "shape or format")
    dev = x.device
    lib = _build.library("mx_gemv", _ARGTYPES)
    plan = swiglu_plan(N, K, bits, _build.sm_count(dev))
    y = torch.empty((N,), dtype=torch.float32, device=dev)
    err = lib.repro_mx_gemv_swiglu(
        wg.data_ptr(), sg.data_ptr(), wu.data_ptr(), su.data_ptr(),
        x.data_ptr(), y.data_ptr(), N, K, bits, *plan.args(),
        _build.stream_handle(dev))
    _build.check(err, "mx_qgemv_swiglu")
    swiglu_launches += 1
    return y


def grouped_expert_qgemv(wq, scales, xs, ids):
    """y (rows, N) fp32, y[t] = xs[t] . dequant(wq[ids[t]], scales[ids[t]])
    for MX stacks wq (E, K | K/2, N), scales (E, K/32, N), rows xs (rows, K)
    and expert ids (rows,) int32 (in [0, E); repeats allowed).  The ids stay
    on the device: each block of the kernel reads its own.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    global grouped_launches
    if wq.device.type == "cpu":
        return plain_grouped(wq, scales, xs, ids)
    if wq.device.type != "cuda":
        raise ValueError(f"grouped_expert_qgemv: unsupported device "
                         f"{wq.device}")
    N, K, bits = _check("grouped_expert_qgemv", wq, scales, xs, stack=True)
    rows = xs.shape[0]
    if (ids.dtype != torch.int32 or ids.shape != (rows,)
            or ids.device != wq.device or not ids.is_contiguous()):
        raise ValueError(f"grouped_expert_qgemv kernel takes contiguous "
                         f"int32 ids ({rows},) on the weights' device; got "
                         f"{tuple(ids.shape)} {ids.dtype} on {ids.device}")
    dev = xs.device
    plan = grouped_plan(N, K, bits, _build.sm_count(dev), rows)
    y = torch.empty((rows, N), dtype=torch.float32, device=dev)
    lib = _build.library("mx_gemv", _ARGTYPES)
    err = lib.repro_mx_gemv_grouped(
        wq.data_ptr(), scales.data_ptr(), xs.data_ptr(), ids.data_ptr(),
        y.data_ptr(), rows, N, K, bits, *plan.args(),
        _build.stream_handle(dev))
    _build.check(err, "grouped_expert_qgemv")
    grouped_launches += 1
    return y


# --------------------------------------------------------------------------
# registry entries (the JAX package's cost models and example shapes)
# --------------------------------------------------------------------------
def _untuned(fn):
    """``fn`` under the registry's calling convention: it takes a ``cfg``
    and reads no knob of it (the MX kernels cut their walk from the
    shape and the card), so each of their spaces is the one default."""
    @functools.wraps(fn)
    def call(*args, cfg: LaunchConfig = DEFAULT):
        return fn(*args)
    return call


def _mx_weight(seed, shape, elem, device):
    qt = quantize_mx(seeded(seed, shape, torch.float32, device=device),
                     elem=elem, axis=-2)
    return qt.values, qt.scales


def _mx_example(small: bool = True, device=None, elem: str = "fp4",
                batch: int = 0):
    N, K = (128, 512) if small else (2048, 4096)
    wq, s = _mx_weight(0, (K, N), elem, device)
    x = seeded(1, (batch, K) if batch else (K,), device=device)
    return (wq, s, x), {}


def _mx_qgemv_bytes(wq, s, x):
    K = x.shape[-1]
    B = x.shape[0] if len(x.shape) == 2 else 1
    return (numel(wq) * itemsize(wq) + numel(s) * itemsize(s)
            + B * K * itemsize(x) + B * wq.shape[-1] * 4)


def _mx_qgemv_streamed(wq, s, x):
    out = (x.shape[0], wq.shape[-1]) if len(x.shape) == 2 \
        else (wq.shape[-1],)
    return [wq, s, x, meta(out, torch.float32)]


def _mx_swiglu_example(small: bool = True, device=None, elem: str = "fp4"):
    N, K = (128, 512) if small else (2048, 4096)
    wg, sg = _mx_weight(0, (K, N), elem, device)
    wu, su = _mx_weight(1, (K, N), elem, device)
    return (wg, sg, wu, su, seeded(2, (K,), device=device)), {}


def _mx_swiglu_bytes(wg, sg, wu, su, x):
    return (numel(wg) * itemsize(wg) + numel(sg) * itemsize(sg)
            + numel(wu) * itemsize(wu) + numel(su) * itemsize(su)
            + x.shape[-1] * itemsize(x) + wg.shape[-1] * 4)


def _mx_swiglu_streamed(wg, sg, wu, su, x):
    return [wg, sg, wu, su, x, meta((wg.shape[-1],), torch.float32)]


def _grouped_example(small: bool = True, device=None, elem: str = "fp4"):
    E, topk = 4, 2
    N, K = (128, 512) if small else (1408, 2048)
    wq, s = _mx_weight(0, (E, K, N), elem, device)
    xs = seeded(1, (topk, K), device=device)
    ids = torch.as_tensor(np.asarray([1, 3][:topk], np.int32),
                          device=xs.device)
    return (wq, s, xs, ids), {}


def _grouped_bytes(wq, s, xs, ids):
    topk, K = xs.shape
    # gathered traffic: top-k expert slices of the stacked weights/scales,
    # not the whole pool
    return (topk * wq.shape[1] * wq.shape[2] * itemsize(wq)
            + topk * s.shape[1] * s.shape[2] * itemsize(s)
            + topk * K * itemsize(xs) + topk * wq.shape[-1] * 4)


def _grouped_streamed(wq, s, xs, ids):
    topk = xs.shape[0]
    return [meta((topk,) + tuple(wq.shape[1:]), wq.dtype),
            meta((topk,) + tuple(s.shape[1:]), s.dtype),
            xs, meta((topk, wq.shape[-1]), torch.float32)]


#: the MX kernels through the tune registry
mx_qgemv_tuned = troop_kernel(
    "mx_qgemv",
    flops=lambda wq, s, x: 2.0 * wq.shape[-1] * x.shape[-1],
    bytes=_mx_qgemv_bytes, streamed=_mx_qgemv_streamed, space={},
    ref="mx_qgemv", example=_mx_example)(_untuned(mx_qgemv))
batched_mx_qgemv_tuned = troop_kernel(
    "batched_mx_qgemv",
    flops=lambda wq, s, xs: 2.0 * xs.shape[0] * wq.shape[-1] * xs.shape[-1],
    bytes=_mx_qgemv_bytes, streamed=_mx_qgemv_streamed,
    # the JAX quantized GEMVs' space: ``block_n`` / 32 warps a block and
    # ``unroll`` (the loads of a round) move the kernel; ``streams`` and
    # ``block_k`` feed only the predictor
    space={"streams": (1, 2), "unroll": (1, 2), "block_n": (128, 256),
           "block_k": (256, 512)},
    ref="batched_mx_qgemv",
    example=functools.partial(_mx_example, batch=4))(batched_mx_qgemv)
mx_qgemv_swiglu_tuned = troop_kernel(
    "mx_qgemv_swiglu",
    flops=lambda wg, sg, wu, su, x: 4.0 * wg.shape[-1] * x.shape[-1],
    bytes=_mx_swiglu_bytes, streamed=_mx_swiglu_streamed, space={},
    ref="mx_qgemv_swiglu",
    example=_mx_swiglu_example)(_untuned(mx_qgemv_swiglu))
grouped_expert_qgemv_tuned = troop_kernel(
    "grouped_expert_qgemv",
    flops=lambda wq, s, xs, ids: 2.0 * xs.shape[0] * wq.shape[-1]
    * xs.shape[-1],
    bytes=_grouped_bytes, streamed=_grouped_streamed, space={},
    ref="grouped_expert_qgemv",
    example=_grouped_example)(_untuned(grouped_expert_qgemv))
