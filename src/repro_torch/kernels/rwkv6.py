"""WKV6: the wrapper of ``csrc/rwkv6.cu``, its launch count, its plain
version and its registry entry (``"rwkv6"``, the JAX name).

Replaces the JAX package's Pallas ``kernels/rwkv6.py:wkv6``, the RWKV-6
recurrence in its chunked linear-attention form, an AXPY-class kernel that
streams r, k, v and w once and keeps the hd x hd state on chip.  The Pallas
kernel zeroes its state at the first chunk and never reads ``state0``; the
port's kernel starts from ``state0``, so the kernel, its plain version (the
JAX oracle, a T-step scan) and the CPU path compute one function, which is
the Pallas one at zero state.  ``ops.wkv6_with_state`` keeps the JAX form:
zeros into the kernel, the carried state folded in afterwards.
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

_ARGS = [_build.P] * 8 + [_build.I] * 6 + [_build.P]
_ARGTYPES = {"repro_wkv6_f32": _ARGS, "repro_wkv6_bf16": _ARGS}
#: threads a block (``kThreads``: two groups of 8 warps), steps a sub-chunk
#: (``kSub``), the column slices the kernel is built for (``csrc/rwkv6.cu``)
#: and the shared memory a block may take
THREADS, SUB, COLS, SMEM_LIMIT = 512, 4, (32, 16, 8), 227 * 1024


class Wkv6Plan(NamedTuple):
    """A launch of ``csrc/rwkv6.cu``: ``col_blocks`` = hd / ``cols``
    blocks a (batch, head), block (bh, c) owning columns c cols .. (c + 1)
    cols - 1 of the state and of y; T walked in chunks of ``chunk`` steps,
    their pair scores factored at sub-chunk boundaries every ``sub`` steps;
    ``smem`` bytes of shared memory a block (``Layout::bytes``)."""
    cols: int
    col_blocks: int
    chunk: int
    sub: int
    threads: int
    blocks: int
    smem: int

    @property
    def grid(self):
        """(B H, hd / cols), as the kernel is launched."""
        return (self.blocks // self.col_blocks, self.col_blocks)


def wkv6_smem(hd: int, chunk: int, cols: int, itemsize: int) -> int:
    """Bytes of shared memory a block takes (``Layout<T, HD, L, CB>``):
    the fp32 rows (lcm; two buffers each of rq, kq, the pair scores, v
    transposed, exp(cm_L), the factors that make rq and kq rd and kd, and
    the sums at the sub-chunk boundaries, the producers' hand-over; two of
    the state's slice; the decays between sub-chunks, the sub-chunk totals
    and u), and before them staged chunks of r, k, w (rows padded by 16
    bytes) and v: two where they fit in the 227 KB, else one."""
    P, RP, AP = hd + 4, hd + 16 // itemsize, chunk + 4
    nsub = chunk // SUB
    f32 = 4 * (5 * chunk * P + 2 * chunk * AP + 2 * cols * AP + 2 * hd
               + 4 * nsub * hd + 2 * cols * P + 2 * (nsub + 1) * hd
               + nsub * hd + hd)
    stage = (3 * chunk * RP + chunk * cols) * itemsize
    return f32 + (2 if 2 * stage + f32 <= SMEM_LIMIT else 1) * stage


def wkv6_plan(B: int, T: int, H: int, hd: int, chunk: int, sms: int = 132,
              itemsize: int = 4) -> Wkv6Plan:
    """A block holds one SM (512 threads), so the plan takes the narrowest
    column slice (8, 16, 32) whose B H hd / cols blocks all run in one
    wave of the card's ``sms`` SMs; where none does, the widest that fits
    the shared memory (fewest waves, and fewest blocks forming the same
    decays and pair scores).  rwkv6-3b's (1, 2048, 40, 64) takes 32
    columns, 80 blocks; the registry's (1, 256, 4, 64) 8 columns, 32
    blocks.  At those two shapes and at 20 heads (16 columns) the plan's
    slice measured the fastest of the three at chunks of 32 (PERF.md, row
    15): a wider one leaves SMs idle, a narrower one puts two blocks on an
    SM, which then set the pace."""
    if (hd not in (32, 64, 128) or chunk not in (8, 16, 32) or T < 1
            or B < 1 or H < 1):
        raise ValueError(f"wkv6: hd {hd} (32, 64 or 128), chunk {chunk} "
                         f"(8, 16 or 32) or B, T, H ({B}, {T}, {H}) out of "
                         f"range")
    fit = [c for c in COLS if c <= hd
           and wkv6_smem(hd, chunk, c, itemsize) <= SMEM_LIMIT]
    wave = [c for c in fit if B * H * (hd // c) <= sms]
    cols = min(wave) if wave else max(fit)
    return Wkv6Plan(cols, hd // cols, chunk, SUB, THREADS,
                    B * H * (hd // cols), wkv6_smem(hd, chunk, cols,
                                                    itemsize))


def plain(r, k, v, w, u, state0):
    """The plain PyTorch version: the fp32 scan from ``state0``."""
    return ref.wkv6(r, k, v, w, u, state0)


def wkv6(r, k, v, w, u, state0, cfg: LaunchConfig = DEFAULT):
    """r, k, v, w (B,T,H,hd); u (H,hd); state0 (B,H,hd,hd) -> (y (B,T,H,hd)
    fp32, state (B,H,hd,hd) fp32), from ``state0``.  The kernel walks T in
    chunks of ``cfg.block_n // 8`` steps (8, 16 or 32), hd / cols blocks
    a (batch, head) (``wkv6_plan``).  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (r, k, v, w
    contiguous in one dtype, fp32 or bf16; u and state0 contiguous fp32;
    hd 32, 64 or 128) or raises."""
    global launches
    if r.device.type == "cpu":
        return plain(r, k, v, w, u, state0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    B, T, H, hd = r.shape if r.dim() == 4 else (0, 0, 0, 0)
    ok = (r.dtype in (torch.float32, torch.bfloat16) and hd in (32, 64, 128)
          and T > 0 and all(a.dtype == r.dtype and a.shape == r.shape
                            for a in (k, v, w))
          and u.dtype == state0.dtype == torch.float32
          and u.shape == (H, hd) and state0.shape == (B, H, hd, hd)
          and all(a.device == r.device and a.is_contiguous()
                  and a.data_ptr() % 16 == 0
                  for a in (r, k, v, w, u, state0)))
    if not ok:
        raise ValueError(
            f"wkv6 kernel takes contiguous r, k, v, w (B, T, H, hd in "
            f"32/64/128) in one dtype (fp32 or bf16), fp32 u (H, hd) and "
            f"fp32 state0 (B, H, hd, hd) on one device; got r "
            f"{tuple(r.shape)} {r.dtype}, k {k.dtype}, v {v.dtype}, w "
            f"{w.dtype}, u {tuple(u.shape)} {u.dtype}, state0 "
            f"{tuple(state0.shape)} {state0.dtype}")
    chunk = cfg.block_n // 8
    if cfg.block_n % 8 or chunk not in (8, 16, 32):
        raise ValueError(f"wkv6 takes block_n 64, 128 or 256 (chunks of 8, "
                         f"16 or 32 steps); got {cfg.block_n}")
    plan = wkv6_plan(B, T, H, hd, chunk, _build.sm_count(r.device),
                     r.element_size())
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    state = torch.empty_like(state0)
    lib = _build.library("rwkv6", _ARGTYPES)
    fn = lib.repro_wkv6_f32 if r.dtype == torch.float32 \
        else lib.repro_wkv6_bf16
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), state0.data_ptr(), y.data_ptr(), state.data_ptr(),
             B, T, H, hd, chunk, plan.cols, _build.stream_handle(r.device))
    _build.check(err, "wkv6")
    launches += 1
    return y, state


def _example(small: bool = True, device=None):
    B, T, H, hd = (1, 64, 2, 32) if small else (1, 256, 4, 64)
    f32 = torch.float32
    r, k, v = (seeded(i, (B, T, H, hd), f32, device=device)
               for i in range(3))
    w = torch.exp(-torch.exp(seeded(3, (B, T, H, hd), f32, device=device)))
    u = torch.full((H, hd), 0.5, device=r.device)
    s0 = torch.zeros((B, H, hd, hd), device=r.device)
    return (r, k, v, w, u, s0), {}


#: ``wkv6`` through the tune registry, as ``"rwkv6"`` (the JAX package's
#: name and cost model)
wkv6_tuned = troop_kernel(
    "rwkv6",
    # state update + readout: O(hd) per (t, head, channel) element
    flops=lambda r, k, v, w, u, s0: 6.0 * numel(r) * r.shape[3],
    bytes=lambda r, k, v, w, u, s0: (
        4 * numel(r) * itemsize(r)          # r, k, v, w in
        + numel(r) * 4 + numel(s0) * 4      # y + final state out (fp32)
        + numel(u) * itemsize(u)),
    streamed=lambda r, k, v, w, u, s0: [
        r, meta(k.shape, r.dtype), meta(v.shape, r.dtype),
        meta(w.shape, r.dtype),
        meta(r.shape, torch.float32),       # y out
        meta(s0.shape, torch.float32),      # final state out
        u],
    space={"block_n": (64, 128, 256)}, ref="wkv6", example=_example)(wkv6)
