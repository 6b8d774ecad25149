"""Paged chunked-prefill attention: the wrapper of
``csrc/prefill_attention.cu``, its launch count, its plain version and its
registry entry.

Replaces the JAX package's Pallas
``kernels/prefill_attention.py:prefill_attention_paged``.  The CUDA kernel is
bound by the K/V bytes it streams; ``csrc/prefill_attention.cu`` says how its
design meets that.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import check_paged, wave_splits
from repro_torch.tune.registry import itemsize, meta, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGTYPES = {"repro_paged_prefill_bf16": [_build.P] * 8 + [_build.I] * 10
             + [_build.F, _build.P],
             "repro_paged_prefill_bf16_occupancy": [_build.I] * 3,
             "repro_paged_prefill_bf16_max_pages": []}


def plain(q, k_pool, v_pool, block_tables, q_offset, length):
    """The plain PyTorch version: gather, causal softmax, out in q.dtype."""
    return ref.prefill_attention_paged(q, k_pool, v_pool, block_tables,
                                       q_offset, length).to(q.dtype)


def prefill_layout(C: int, H: int, KV: int, warps: int) -> dict:
    """A block of the kernel: its M rows are 16 ``wm`` of the slab's C x G
    (row, query head) pairs, its ``warps`` warps ``wm`` row-tile warps x
    ``wn`` position warps, each taking ``nw`` positions of every staged
    tile of ``bn``; ``z`` row tiles cover the C x G rows."""
    if warps not in (1, 2, 4, 8):
        raise ValueError(f"prefill_attention_paged: prefill_warps must be 1,"
                         f" 2, 4 or 8; got {warps}")
    mtiles = -(-C * (H // KV) // 16)
    wm = 1
    while wm * 2 <= min(warps, mtiles):
        wm *= 2
    wn = warps // wm
    nw = {1: 64, 2: 32}.get(wn, 16)
    return {"wm": wm, "wn": wn, "nw": nw, "bn": wn * nw,
            "z": -(-mtiles // wm)}


def prefill_plan(B: int, C: int, H: int, KV: int, page: int, nblk: int,
                 warps: int, resident: int, max_pages: int) -> dict:
    """The launch: one block per (slot, KV head, split, row tile) of
    ``prefill_layout``; the splits are whole pages of the slot's valid
    positions, as many as fill one wave of the ``resident`` blocks the card
    holds at once, and at least enough that none takes more than
    ``max_pages`` entries of the block table (the block's shared page
    list)."""
    lay = prefill_layout(C, H, KV, warps)
    nsplit = max(wave_splits(B * KV * lay["z"], nblk * page, resident),
                 -(-nblk // max_pages))
    return {**lay, "grid": (B * KV, nsplit, lay["z"]), "nsplit": nsplit}


def prefill_attention_paged(q, k_pool, v_pool, block_tables, q_offset,
                            length, cfg: LaunchConfig = DEFAULT):
    """Causal chunk attention over a paged KV cache.

    q (B,C,H,hd) — a prefill slab whose row 0 sits at absolute position
    ``q_offset`` (B,); k_pool/v_pool (P,page,KV,hd); block_tables (B,nblk);
    ``length`` (B,) = q_offset + valid rows (positions >= length are
    masked).  Returns (B,C,H,hd) in q.dtype; rows past the valid count are
    garbage and must be discarded by the caller.  The kernel
    (``prefill_plan``) reads each K/V page once for all the slab's rows of a
    KV head and runs both products on the tensor cores; ``cfg.prefill_warps``
    warps a block.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    global launches
    if q.device.type == "cpu":
        return plain(q, k_pool, v_pool, block_tables, q_offset, length)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention_paged: unsupported device "
                         f"{q.device}")
    check_paged("prefill_attention_paged", q, k_pool, v_pool, block_tables,
                q_offset, length)
    B, C, H, hd = q.shape
    page, KV = k_pool.shape[1], k_pool.shape[2]
    nblk = block_tables.shape[1]
    lib = _build.library("prefill_attention", _ARGTYPES)
    lay = prefill_layout(C, H, KV, cfg.prefill_warps)
    resident = _build.resident(
        q.device, lib.repro_paged_prefill_bf16_occupancy, hd,
        cfg.prefill_warps, lay["wm"])
    plan = prefill_plan(B, C, H, KV, page, nblk, cfg.prefill_warps, resident,
                        lib.repro_paged_prefill_bf16_max_pages())
    out = torch.empty_like(q)
    part = torch.empty((B * C * H * plan["nsplit"], hd + 2),
                       dtype=torch.float32, device=q.device) \
        if plan["nsplit"] > 1 else None
    err = lib.repro_paged_prefill_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), q_offset.data_ptr(), length.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), B, C, H,
        KV, hd, page, nblk, cfg.prefill_warps, plan["wm"], plan["nsplit"],
        hd ** -0.5, _build.stream_handle(q.device))
    _build.check(err, "prefill_attention_paged")
    launches += 1
    return out


def _example(small: bool = True, device=None):
    B, C, H, KV, hd, page, nblk = (2, 16, 4, 2, 128, 16, 4) if small \
        else (4, 64, 16, 8, 128, 16, 16)
    P = 1 + B * nblk
    q = seeded(0, (B, C, H, hd), device=device)
    k_pool = seeded(1, (P, page, KV, hd), device=device)
    v_pool = seeded(2, (P, page, KV, hd), device=device)
    perm = np.random.default_rng(0).permutation(P - 1) + 1
    bt = torch.as_tensor(perm[:B * nblk].reshape(B, nblk).astype(np.int32),
                         device=q.device)
    # slab b starts mid-sequence (a prefix-cache hit) and fills to length
    q_offset = torch.as_tensor(np.arange(B, dtype=np.int32) * 7,
                               device=q.device)
    return (q, k_pool, v_pool, bt, q_offset, q_offset + C), {}


def _streamed(q, kp, vp, bt, off, ln):
    """Per-slot page traffic + the slab in/out + the table."""
    view = (q.shape[0], bt.shape[1] * kp.shape[1], kp.shape[2], kp.shape[3])
    return [meta(view, kp.dtype), meta(view, vp.dtype), q, q, bt]


#: ``prefill_attention_paged`` through the tune registry (the JAX
#: package's cost model)
prefill_attention_paged_tuned = troop_kernel(
    "prefill_attention_paged",
    flops=lambda q, kp, vp, bt, off, ln: (
        4.0 * q.shape[0] * q.shape[1] * q.shape[2] * q.shape[3]
        * bt.shape[1] * kp.shape[1]),
    bytes=lambda q, kp, vp, bt, off, ln: (
        q.shape[0] * bt.shape[1] * kp.shape[1] * kp.shape[2] * kp.shape[3]
        * (itemsize(kp) + itemsize(vp))
        + 2 * q.shape[0] * q.shape[1] * q.shape[2] * q.shape[3] * itemsize(q)
        + bt.shape[0] * bt.shape[1] * itemsize(bt)),
    streamed=_streamed,
    space={"prefill_warps": (2, 4, 8)},
    ref="prefill_attention_paged", example=_example)(prefill_attention_paged)
