"""GEMV: the wrapper of ``csrc/gemv.cu``, its launch count and its plain
version.

Replaces the JAX package's Pallas ``kernels/gemv.py:gemv``, in bf16 (the
projections) and fp32 (the MoE router, which the JAX package applies in
fp32).  The CUDA kernel is bound by the bytes of W; ``csrc/gemv.cu`` says
how its design meets that.
"""
from __future__ import annotations

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGS = [_build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
         _build.I, _build.P]
_ARGTYPES = {"repro_gemv_bf16": _ARGS, "repro_gemv_f32": _ARGS}
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

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (w and x both bf16 with K % 8 == 0, or both fp32 with K % 4 == 0,
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
             cfg.gemv_warps, _build.stream_handle(w.device))
    _build.check(err, "gemv")
    launches += 1
    return y
