"""MAMBA SCAN: the wrapper of ``csrc/mamba_scan.cu``, its launch count, its
plain version and its registry entry.

Replaces the JAX package's Pallas ``kernels/mamba_scan.py:mamba_scan``, the
selective scan, an AXPY-class recurrence that streams x, dt, B and C once
and keeps the (channel, d_state) state on chip.  The Pallas kernel zeroes
its state at the first tile and never reads ``state0``; the port's kernel
starts from ``state0``, so the kernel, its plain version (the JAX oracle, a
T-step scan) and the CPU path compute one function, which is the Pallas one
at zero state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import (itemsize, meta, numel, seeded,
                                       troop_kernel)

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGS = [_build.P] * 9 + [_build.I] * 6 + [_build.P]
_ARGTYPES = {"repro_mamba_scan_f32": _ARGS, "repro_mamba_scan_bf16": _ARGS}
#: threads a block (``kThreads`` in ``csrc/mamba_scan.cu``) and d_state
THREADS, DS = 128, 16


class MambaPlan(NamedTuple):
    """A launch of ``csrc/mamba_scan.cu``: ``lanes`` lanes a channel, lane
    g holding states g ``states`` .. (g + 1) ``states`` - 1; ``channels``
    channels a block of ``threads``; a grid of (``col_blocks``, b); T in
    tiles of ``chunk`` steps."""
    lanes: int
    states: int
    channels: int
    threads: int
    col_blocks: int
    blocks: int
    chunk: int


def mamba_plan(b: int, T: int, di: int, chunk: int,
               sms: int = 132) -> MambaPlan:
    """4 lanes of 4 states a channel where a block of 32 channels still
    gives each of the card's ``sms`` SMs a block (b ceil(di / 32) >= sms:
    fewer lanes, so fewer loads and shuffles a state), else 16 lanes of 1
    (the most blocks).  jamba's (1,
    2048, 8192) takes 4 lanes, 256 blocks, 32,768 threads; the registry's
    (2, 512, 512) 16 lanes, 128 blocks.  Each measured the faster split
    at its shape at every tile (PERF.md, row 16)."""
    if b < 1 or b > 65535 or T < 1 or di < 1 or chunk not in (8, 16, 32):
        raise ValueError(f"mamba_scan: b {b}, T {T}, di {di} or chunk "
                         f"{chunk} (8, 16 or 32) out of range")
    lanes = 4 if b * -(-di // (THREADS // 4)) >= sms else 16
    cpb = THREADS // lanes
    return MambaPlan(lanes, DS // lanes, cpb, THREADS, -(-di // cpb),
                     b * -(-di // cpb), chunk)


def plain(x, dt, B, C, A, D, state0):
    """The plain PyTorch version: the fp32 scan from ``state0``."""
    return ref.mamba_scan(x, dt, B, C, A, D, state0)


def mamba_scan(x, dt, B, C, A, D, state0, cfg: LaunchConfig = DEFAULT):
    """x, dt (b,T,di); B, C (b,T,ds); A (di,ds) < 0; D (di,); state0
    (b,di,ds) -> (y (b,T,di) fp32, state (b,di,ds) fp32), from ``state0``.
    The kernel walks T in tiles of ``cfg.block_n // 8`` steps (8, 16 or
    32), the 16 states of a channel over 4 or 16 lanes (``mamba_plan``).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (x, dt, B, C contiguous in one dtype, fp32 or bf16; A, D and
    state0 contiguous fp32; ds = 16) or raises."""
    global launches
    if x.device.type == "cpu":
        return plain(x, dt, B, C, A, D, state0)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {x.device}")
    b, T, di = x.shape if x.dim() == 3 else (0, 0, 0)
    ds = B.shape[-1] if B.dim() == 3 else 0
    ok = (x.dtype in (torch.float32, torch.bfloat16) and ds == 16 and T > 0
          and di > 0 and dt.dtype == B.dtype == C.dtype == x.dtype
          and dt.shape == x.shape and B.shape == C.shape == (b, T, ds)
          and A.dtype == D.dtype == state0.dtype == torch.float32
          and A.shape == (di, ds) and D.shape == (di,)
          and state0.shape == (b, di, ds)
          and all(a.device == x.device and a.is_contiguous()
                  for a in (x, dt, B, C, A, D, state0)))
    if not ok:
        raise ValueError(
            f"mamba_scan kernel takes contiguous x, dt (b, T, di) and B, C "
            f"(b, T, 16) in one dtype (fp32 or bf16), fp32 A (di, 16), D "
            f"(di,) and state0 (b, di, 16) on one device; got x "
            f"{tuple(x.shape)} {x.dtype}, dt {dt.dtype}, B {tuple(B.shape)} "
            f"{B.dtype}, C {C.dtype}, A {tuple(A.shape)} {A.dtype}, D "
            f"{D.dtype}, state0 {tuple(state0.shape)} {state0.dtype}")
    chunk = cfg.block_n // 8
    if cfg.block_n % 8 or chunk not in (8, 16, 32):
        raise ValueError(f"mamba_scan takes block_n 64, 128 or 256 (tiles "
                         f"of 8, 16 or 32 steps); got {cfg.block_n}")
    plan = mamba_plan(b, T, di, chunk, _build.sm_count(x.device))
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    state = torch.empty_like(state0)
    lib = _build.library("mamba_scan", _ARGTYPES)
    fn = lib.repro_mamba_scan_f32 if x.dtype == torch.float32 \
        else lib.repro_mamba_scan_bf16
    err = fn(x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
             A.data_ptr(), D.data_ptr(), state0.data_ptr(), y.data_ptr(),
             state.data_ptr(), b, T, di, ds, chunk, plan.lanes,
             _build.stream_handle(x.device))
    _build.check(err, "mamba_scan")
    launches += 1
    return y, state


def _example(small: bool = True, device=None):
    b, T, di, ds = (1, 64, 128, 16) if small else (2, 512, 512, 16)
    f32 = torch.float32
    x = seeded(0, (b, T, di), f32, device=device)
    dt = torch.nn.functional.softplus(seeded(1, (b, T, di), f32,
                                             device=device))
    B = seeded(2, (b, T, ds), f32, device=device)
    C = seeded(3, (b, T, ds), f32, device=device)
    A = -torch.exp(seeded(4, (di, ds), f32, device=device))
    D = torch.ones((di,), device=x.device)
    s0 = torch.zeros((b, di, ds), device=x.device)
    return (x, dt, B, C, A, D, s0), {}


#: ``mamba_scan`` through the tune registry (the JAX package's cost model)
mamba_scan_tuned = troop_kernel(
    "mamba_scan",
    # per (t, channel): state decay + update + output contraction over ds
    flops=lambda x, dt, B, C, A, D, s0: (6.0 * numel(x) * A.shape[1]),
    bytes=lambda x, dt, B, C, A, D, s0: (
        (2 * numel(x) + numel(B) + numel(C)) * itemsize(x)
        + numel(x) * itemsize(x)            # y out
        + (numel(A) + numel(D) + numel(s0)) * 4),
    streamed=lambda x, dt, B, C, A, D, s0: [
        x, meta(dt.shape, x.dtype),         # x, dt in
        meta(B.shape, x.dtype), meta(C.shape, x.dtype),
        x,                                  # y out (x-shaped)
        meta(A.shape, torch.float32), meta(D.shape, torch.float32),
        meta(s0.shape, torch.float32)],
    space={"block_n": (64, 128, 256)}, ref="mamba_scan",
    example=_example)(mamba_scan)
