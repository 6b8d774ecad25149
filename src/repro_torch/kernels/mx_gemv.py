"""MX GEMV and the fused MX SwiGLU: the wrappers of ``csrc/mx_gemv.cu``,
their launch counts and their plain versions.

Replace the JAX package's Pallas ``quant/kernels.py:mx_qgemv`` and
``quant/kernels.py:mx_qgemv_swiglu``.  The weights keep the JAX layout,
``(K | K/2, N)`` codes (fp4 packed along K in uint8, or float8_e4m3fn) and
``(K/32, N)`` uint8 E8M0 scales.  The CUDA kernels are bound by the code and
scale bytes; ``csrc/mx_gemv.cu`` says how their design meets that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.quant.tensor import FP8_DTYPE

#: kernel launches so far (the CPU path and the plain versions do not count)
launches = 0
swiglu_launches = 0

_P, _I = _build.P, _build.I
_ARGTYPES = {
    "repro_mx_gemv": [_P] * 5 + [_I] * 4 + [_P],
    "repro_mx_gemv_swiglu": [_P] * 7 + [_I] * 4 + [_P],
}
_TILE, _WARPS, _BLOCK = 512, 8, 32      # mirror kTile, kWarps, kBlockRows


def plain(wq, scales, x):
    """The plain PyTorch version: (N,) fp32."""
    return ref.mx_qgemv(wq, scales, x)


def plain_swiglu(wg, sg, wu, su, x):
    """The plain PyTorch version: (N,) fp32."""
    return ref.mx_qgemv_swiglu(wg, sg, wu, su, x)


def _check(name, wq, scales, x):
    """(N, K, bits) of a contiguous, aligned MX weight the kernel takes."""
    N, K = wq.shape[1], x.shape[-1]
    bits = 8 if wq.dtype == FP8_DTYPE else 4
    ok = (wq.dim() == 2 and wq.dtype in (torch.uint8, FP8_DTYPE)
          and wq.shape[0] == (K if bits == 8 else K // 2)
          and scales.dtype == torch.uint8
          and scales.shape == (K // _BLOCK, N) and K % _BLOCK == 0
          and N % 16 == 0 and x.dtype == torch.bfloat16 and x.shape == (K,)
          and all(t.device == wq.device and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 for t in (wq, scales, x)))
    if not ok:
        raise ValueError(
            f"{name} kernel takes contiguous, 16-byte aligned MX codes "
            f"(K/2 uint8 | K fp8, N), uint8 E8M0 scales (K/32, N) and bf16 "
            f"x (K,) on one device with K % 32 == 0 and N % 16 == 0; got "
            f"codes {tuple(wq.shape)} {wq.dtype}, scales "
            f"{tuple(scales.shape)} {scales.dtype}, x {tuple(x.shape)} "
            f"{x.dtype}")
    return N, K, bits


def ksplit(N: int, K: int, sms: int) -> int:
    """Blocks per 512-column tile along K: enough tiles x splits to give
    every SM a block, while each split keeps a 32-row block per warp."""
    nkb = K // _BLOCK
    want = max(1, min(-(-sms // -(-N // _TILE)), nkb // _WARPS))
    per = -(-nkb // want)
    return -(-nkb // per)               # every split owns >= 1 block


def _launch(fn, name, codes_scales, x, N, K, bits):
    dev = x.device
    ks = ksplit(N, K, torch.cuda.get_device_properties(dev)
                .multi_processor_count)
    y = torch.empty((N,), dtype=torch.float32, device=dev)
    # the split partials, one row per split and weight stream
    work = torch.empty((len(codes_scales) // 2 * ks, N) if ks > 1 else (1,),
                       dtype=torch.float32, device=dev)
    err = fn(*(t.data_ptr() for t in codes_scales), x.data_ptr(),
             y.data_ptr(), work.data_ptr(), N, K, bits, ks,
             _build.stream_handle(dev))
    _build.check(err, name)
    return y


def mx_qgemv(wq, scales, x):
    """y (N,) fp32 = x (K,) . dequant(wq, scales).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    global launches
    if wq.device.type == "cpu":
        return plain(wq, scales, x)
    if wq.device.type != "cuda":
        raise ValueError(f"mx_qgemv: unsupported device {wq.device}")
    N, K, bits = _check("mx_qgemv", wq, scales, x)
    lib = _build.library("mx_gemv", _ARGTYPES)
    y = _launch(lib.repro_mx_gemv, "mx_qgemv", (wq, scales), x, N, K, bits)
    launches += 1
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
    lib = _build.library("mx_gemv", _ARGTYPES)
    y = _launch(lib.repro_mx_gemv_swiglu, "mx_qgemv_swiglu",
                (wg, sg, wu, su), x, N, K, bits)
    swiglu_launches += 1
    return y
