"""GEMV and the batched GEMV: the wrappers of ``csrc/gemv.cu``, their
launch counts, their plain versions and ``gemv``'s registry entry.

Replace the JAX package's Pallas ``kernels/gemv.py:gemv``, in bf16 (the
projections) and fp32 (the MoE router, which the JAX package applies in
fp32), and ``kernels/ops.py:batched_gemv`` (a vmap of that kernel over a few
rows; not registered with the tuner, as in JAX).  The CUDA kernels are
bound by the bytes of W; ``csrc/gemv.cu`` says how their design meets that.
"""
from __future__ import annotations

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import itemsize, meta, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0
batched_launches = 0

_ARGS = [_build.P] * 4 + [_build.I] * 4 + [_build.P]
_ARGTYPES = {"repro_gemv_bf16": _ARGS, "repro_gemv_f32": _ARGS,
             "repro_batched_gemv_bf16": [_build.P] * 3 + [_build.I] * 5
             + [_build.P]}
#: rows of xs one batched launch takes (two n-tiles of the tensor-core
#: product)
MAX_BATCH = 16
#: warps a block of the batched kernel (``__launch_bounds__(512)``)
MAX_BATCH_WARPS = 16
# k a warp of the batched kernel takes per step, and steps in flight
_STEP, _IN_FLIGHT = 64, 4
# 16-byte vectors of a row in one step of the one-row kernel
_ROW_STEP = 64
# elements per 16-byte load, by dtype
_VEC = {torch.bfloat16: 8, torch.float32: 4}


def plain(w, x, index=None):
    """The plain PyTorch version: (N,) fp32."""
    if index is not None:
        w = w.index_select(0, index.long())[0]
    return ref.gemv(w, x)


def gemv(w, x, index=None, cfg: LaunchConfig = DEFAULT):
    """w (N, K), x (K,) -> y (N,) fp32.  With ``index`` (a one-element
    int32 tensor on w's device), w is a stack (E, N, K) and the product
    takes ``w[index[0]]``, read where it lies: the id is never brought to
    the host.

    The kernel takes ``cfg.gemv_warps`` warps a block, ``gemv_ksplit`` of
    them sharing a row when the rows are too few to fill the card.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (w
    and x both bf16 with K % 8 == 0, or both fp32 with K % 4 == 0,
    contiguous and 16-byte aligned) or raises."""
    global launches
    if w.device.type == "cpu":
        return plain(w, x, index)
    if w.device.type != "cuda":
        raise ValueError(f"gemv: unsupported device {w.device}")
    N, K = w.shape[-2:]
    vec = _VEC.get(w.dtype)
    stacked = index is not None
    if (vec is None or x.dtype != w.dtype or x.shape != (K,)
            or x.device != w.device or w.dim() != 2 + stacked
            or not w.is_contiguous() or not x.is_contiguous()
            or K % vec or w.data_ptr() % 16 or x.data_ptr() % 16
            or (stacked and (index.dtype != torch.int32
                             or index.shape != (1,)
                             or index.device != w.device))):
        raise ValueError(
            f"gemv kernel takes contiguous, 16-byte aligned w (N, K) (or a "
            f"stack (E, N, K) with a (1,) int32 index on its device) and x "
            f"(K,) on one device, both bf16 with K % 8 == 0 or both fp32 "
            f"with K % 4 == 0; got w {tuple(w.shape)} {w.dtype}, x "
            f"{tuple(x.shape)} {x.dtype}"
            + ("" if index is None else f", index {tuple(index.shape)} "
                                        f"{index.dtype}"))
    y = torch.empty((N,), dtype=torch.float32, device=w.device)
    lib = _build.library("gemv", _ARGTYPES)
    fn = lib.repro_gemv_bf16 if w.dtype == torch.bfloat16 \
        else lib.repro_gemv_f32
    err = fn(w.data_ptr(), x.data_ptr(),
             index.data_ptr() if stacked else None, y.data_ptr(), N, K,
             cfg.gemv_warps,
             gemv_ksplit(N, K, vec, cfg.gemv_warps,
                         _build.sm_count(w.device)),
             _build.stream_handle(w.device))
    _build.check(err, "gemv")
    launches += 1
    return y


def plain_batched(w, xs):
    """The plain PyTorch version of ``batched_gemv``: (B, N) fp32."""
    return ref.batched_gemv(w, xs)


def batched_gemv(w, xs, cfg: LaunchConfig = DEFAULT):
    """w (N, K), xs (B, K) -> (B, N) fp32: ``gemv`` of every row of xs,
    reading W once for all of them on the tensor cores (B = 1: gemv's
    kernel and bits).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 w and xs, 1 <= B <= 16, K % 8 == 0, contiguous and 16-byte
    aligned, ``cfg.gemv_warps`` at most 16) or raises."""
    global batched_launches
    if w.device.type == "cpu":
        return plain_batched(w, xs)
    if w.device.type != "cuda":
        raise ValueError(f"batched_gemv: unsupported device {w.device}")
    N, K = w.shape if w.dim() == 2 else (-1, -1)
    B = xs.shape[0] if xs.dim() == 2 else -1
    warps = cfg.gemv_warps
    if (w.dtype != torch.bfloat16 or xs.dtype != w.dtype or w.dim() != 2
            or xs.shape != (B, K) or not 1 <= B <= MAX_BATCH
            or not 1 <= warps <= MAX_BATCH_WARPS or xs.device != w.device
            or not w.is_contiguous() or not xs.is_contiguous() or K % 8
            or w.data_ptr() % 16 or xs.data_ptr() % 16):
        raise ValueError(
            f"batched_gemv kernel takes contiguous, 16-byte aligned bf16 w "
            f"(N, K) and xs (B, K) on one device with K % 8 == 0, 1 <= B <= "
            f"{MAX_BATCH} and at most {MAX_BATCH_WARPS} warps a block; got "
            f"w {tuple(w.shape)} {w.dtype}, xs {tuple(xs.shape)} {xs.dtype}, "
            f"{warps} warps")
    y = torch.empty((B, N), dtype=torch.float32, device=w.device)
    lib = _build.library("gemv", _ARGTYPES)
    sms = _build.sm_count(w.device)
    err = lib.repro_batched_gemv_bf16(
        w.data_ptr(), xs.data_ptr(), y.data_ptr(), N, K, B, warps,
        gemv_ksplit(N, K, 8, warps, sms) if B == 1
        else split_k(N, K, warps, sms),
        _build.stream_handle(w.device))
    _build.check(err, "batched_gemv")
    batched_launches += 1
    return y


def split_k(N: int, K: int, warps: int, sms: int) -> int:
    """Warps of a batched-GEMV block that share one 16-row tile, each taking
    every ksplit-th 64-wide step of K: doubled while the tiles' warps stay
    under 16 an SM, it divides ``warps`` and each warp keeps a full set of
    steps in flight.  (2048, 4096) at 8 warps: 8; the read-out: 1."""
    tiles, steps, ksplit = -(-N // 16), -(-K // _STEP), 1
    while (warps % (2 * ksplit) == 0 and 2 * ksplit * _IN_FLIGHT <= steps
           and tiles * ksplit < 16 * sms):
        ksplit *= 2
    return ksplit


def gemv_ksplit(N: int, K: int, vec: int, warps: int, sms: int) -> int:
    """Warps of a one-row GEMV block that share a row, each taking every
    ksplit-th step of 64 16-byte vectors (``vec`` elements each): doubled
    while it divides ``warps``, every warp keeps at least one whole step,
    and the rows' warps stay within 32 an SM.  At 8 warps on 132 SMs: the
    read-outs 1, the router (60, 2048) fp32 8, (1024, 1024) bf16 2."""
    steps, ksplit = K // vec // _ROW_STEP, 1
    while (warps % (2 * ksplit) == 0 and 2 * ksplit <= steps
           and 2 * ksplit * N <= 32 * sms):
        ksplit *= 2
    return ksplit


def _example(small: bool = True, device=None):
    N, K = (128, 512) if small else (2048, 4096)
    return (seeded(0, (N, K), device=device),
            seeded(1, (K,), device=device)), {}


#: ``gemv`` through the tune registry (the JAX package's cost model)
gemv_tuned = troop_kernel(
    "gemv",
    flops=lambda w, x: 2.0 * w.shape[0] * w.shape[1],
    bytes=lambda w, x: (w.shape[0] * w.shape[1] * itemsize(w)
                        + w.shape[1] * itemsize(x) + w.shape[0] * 4),
    streamed=lambda w, x: [w, x, meta((w.shape[0],), torch.float32)],
    space={"gemv_warps": (4, 8, 16)},
    ref="gemv", example=_example)(gemv)
