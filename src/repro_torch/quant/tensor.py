"""QuantizedTensor and the quantize / dequantize primitives of the port.

A copy of what the port needs from the JAX package's ``quant/tensor.py``
(which imports JAX): absmax int8 quantization (the KV-page layout), MX
microscaling (per-32-row-block E8M0 shared exponents with fp4 e2m1 or fp8
e4m3 element codes) and their inverses.  The codes and scales are the JAX
package's byte for byte: ``floor(log2)`` and ``exp2`` are XLA's CPU
conventions (``repro_torch.core.xla_cpu``; ROADMAP §3 lists the inputs
where they still differ), and ``jnp.digitize(x, bins)`` is
``torch.bucketize(x, bins, right=True)``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.troop import sublane
from repro_torch.core.xla_cpu import exp2, floor_log2

# storage is always int8; MX codes are uint8 (fp4 packs two per byte)
STORAGE_DTYPE = torch.int8

E8M0_BIAS = 127
_MX_EMAX = {"fp4": 2, "fp8": 8}          # floor(log2(max finite element))
_FP4_MAX = 6.0
_FP8_MAX = 448.0
FP8_DTYPE = torch.float8_e4m3fn
# e2m1 magnitude midpoints: bucketize(|v|) -> magnitude code 0..7
_FP4_MIDPOINTS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)
#: e2m1 code -> value (bit 3 sign, bits 2:1 exponent, bit 0 mantissa)
FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
              -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)


def granule() -> int:
    """Layout granule (rows) of the int8 storage dtype: MX blocks and int8
    KV pages tile in multiples of it."""
    return sublane("int8")


# --------------------------------------------------------------------------
# fp4 e2m1 codes and E8M0 scales
# --------------------------------------------------------------------------
def fp4_encode(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 e2m1 codes; magnitudes saturate at 6.0 (round to the
    nearest of the 8 magnitudes)."""
    bins = torch.tensor(_FP4_MIDPOINTS, dtype=torch.float32, device=x.device)
    mag = torch.bucketize(x.float().abs().contiguous(), bins, right=True)
    return (mag + torch.where(x < 0, 8, 0)).to(torch.uint8)


def fp4_decode(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 e2m1 codes -> float: sign * (exp == 0 ? 0.5 * man
    : (1 + 0.5 * man) * 2^(exp - 1)), the values of ``FP4_VALUES``."""
    c = codes.to(torch.int32)
    sign = 1.0 - 2.0 * (c >> 3).float()
    e = ((c >> 1) & 3).float()
    man = (c & 1).float()
    mag = torch.where(e == 0, 0.5 * man, (1.0 + 0.5 * man) * torch.exp2(e - 1))
    return (sign * mag).to(dtype)


def pack_fp4(codes: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack uint8 e2m1 codes two per byte along ``axis`` (even index -> low
    nibble, odd -> high).  The extent must be even."""
    cm = codes.movedim(axis, -1)
    K = cm.shape[-1]
    if K % 2:
        raise ValueError(f"fp4 packing needs an even extent, got {K}")
    pairs = cm.reshape(cm.shape[:-1] + (K // 2, 2)).to(torch.uint8)
    packed = pairs[..., 0] | (pairs[..., 1] << 4)
    return packed.movedim(-1, axis).contiguous()


def unpack_fp4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of ``pack_fp4``: (..., K/2) uint8 -> (..., K) uint8 codes."""
    pm = packed.movedim(axis, -1).to(torch.uint8)
    out = torch.stack([pm & 0x0F, pm >> 4], dim=-1)
    out = out.reshape(pm.shape[:-1] + (2 * pm.shape[-1],))
    return out.movedim(-1, axis).contiguous()


def e8m0_decode(scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 E8M0 biased exponents -> scale factors 2^(s - 127)."""
    return exp2(scales.float() - E8M0_BIAS).to(dtype)


# --------------------------------------------------------------------------
# QuantizedTensor
# --------------------------------------------------------------------------
class QuantizedTensor(nn.Module):
    """Quantized values + per-group scales, the port's ``QuantizedTensor``.

    A module, so that a quantized projection sits in a parameter tree like
    any weight: ``.to(device)`` moves it and ``parameters()`` counts its
    bytes.  ``bits`` / ``group_size`` / ``axis`` (negative) / ``fmt`` are
    those of the JAX class: ``fmt="int"`` holds int8 values and float absmax
    scales; ``fmt="mx"`` holds uint8 E8M0 block exponents and either packed
    fp4 codes (uint8, ``bits=4``) or fp8 e4m3 codes (``bits=8``).  fp8
    codes are kept as their bytes, so a float cast of the tree
    (``Module.float()``) leaves them alone; ``values`` views them back.
    """

    def __init__(self, values: torch.Tensor, scales: torch.Tensor,
                 bits: int = 8, group_size: int = 0, axis: int = -1,
                 fmt: str = "int"):
        super().__init__()
        self.fp8 = values.dtype == FP8_DTYPE
        codes = values.view(torch.uint8) if self.fp8 else values
        self.codes = nn.Parameter(codes, requires_grad=False)
        self.scales = nn.Parameter(scales, requires_grad=False)
        self.bits, self.group_size, self.axis, self.fmt = (bits, group_size,
                                                           axis, fmt)

    @property
    def values(self) -> torch.Tensor:
        return self.codes.view(FP8_DTYPE) if self.fp8 else self.codes

    @property
    def shape(self):
        """Logical (unpacked) shape."""
        s = list(self.codes.shape)
        if self.bits == 4:
            s[self.axis] *= 2
        return tuple(s)

    @property
    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype)

    def extra_repr(self) -> str:
        return (f"shape={self.shape}, bits={self.bits}, group_size="
                f"{self.group_size}, axis={self.axis}, fmt={self.fmt!r}")


def absmax_scales(x: torch.Tensor, *, bits: int = 8, group_size=None,
                  axis: Optional[int] = -1, eps: float = 1e-8):
    """Absmax calibration: per-group max(|x|) / 127 (floored at ``eps``).

    ``axis=None`` -> one scalar scale; otherwise groups of ``group_size``
    along ``axis`` (``None`` or a non-dividing size makes one group per
    row).  Returns (fp32 scales, effective group size)."""
    if bits != 8:
        raise NotImplementedError("int4 is not ported yet: ROADMAP queue 1 "
                                  "item 7 (int8/int4 weights)")
    xf = x.float().abs()
    if axis is None:
        return torch.clamp(xf.max() / 127, min=eps), 0
    ax = axis if axis < 0 else axis - x.dim()
    K = x.shape[ax]
    g = group_size or K
    if K % g:
        g = K
    xm = xf.movedim(ax, -1)
    amax = xm.reshape(xm.shape[:-1] + (K // g, g)).amax(dim=-1)
    return torch.clamp(amax / 127, min=eps).movedim(-1, ax), g


def quantize(x: torch.Tensor, *, bits: int = 8, group_size=None,
             axis: Optional[int] = -1, eps: float = 1e-8,
             scale_dtype=torch.float32) -> QuantizedTensor:
    """Absmax-quantize ``x`` to int8 (clipped to [-127, 127]), rounding
    with the fp32 scales and storing them as ``scale_dtype``."""
    scales, g = absmax_scales(x, bits=bits, group_size=group_size,
                              axis=axis, eps=eps)
    xf = x.float()
    if axis is None:
        q = torch.clamp(torch.round(xf / scales), -127, 127)
        return QuantizedTensor(q.to(STORAGE_DTYPE), scales.to(scale_dtype),
                               8, 0, None)
    ax = axis if axis < 0 else axis - x.dim()
    xm = xf.movedim(ax, -1)
    sm = scales.movedim(ax, -1)
    q = xm.reshape(xm.shape[:-1] + (sm.shape[-1], g)) / sm[..., None]
    q = torch.clamp(torch.round(q), -127, 127).to(STORAGE_DTYPE)
    return QuantizedTensor(q.reshape(xm.shape).movedim(-1, ax).contiguous(),
                           scales.to(scale_dtype), 8, g, ax)


def quantize_mx(x: torch.Tensor, *, elem: str = "fp4", axis: int = -2,
                block: Optional[int] = None) -> QuantizedTensor:
    """MX-quantize ``x``: a shared uint8 E8M0 exponent per block of
    ``granule()`` elements along ``axis`` (a non-dividing extent makes one
    block per row) and fp4 e2m1 (packed two per byte) or fp8 e4m3 codes;
    fp4 falls back to fp8 for an odd extent.  ``axis`` defaults to -2:
    weights are stored (in_dim, out_dim) and reduce over rows."""
    if elem not in ("fp4", "fp8"):
        raise ValueError(f"elem must be fp4|fp8, got {elem}")
    ax = axis if axis < 0 else axis - x.dim()
    K = x.shape[ax]
    g = block or granule()
    if K % g:
        g = K
    if elem == "fp4" and K % 2:
        elem = "fp8"
    xm = x.float().movedim(ax, -1)
    blocks = xm.reshape(xm.shape[:-1] + (K // g, g))
    amax = blocks.abs().amax(dim=-1)
    e = torch.where(amax > 0.0,
                    floor_log2(torch.clamp(amax, min=1e-38)) - _MX_EMAX[elem],
                    -float(E8M0_BIAS))
    e = torch.clamp(e, -E8M0_BIAS, E8M0_BIAS)
    scales = (e + E8M0_BIAS).to(torch.uint8)
    scaled = blocks * exp2(-e)[..., None]
    if elem == "fp4":
        codes = fp4_encode(torch.clamp(scaled, -_FP4_MAX, _FP4_MAX))
        v, bits = pack_fp4(codes.reshape(xm.shape), axis=-1), 4
    else:
        v = torch.clamp(scaled, -_FP8_MAX, _FP8_MAX).reshape(xm.shape) \
            .to(FP8_DTYPE)
        bits = 8
    return QuantizedTensor(v.movedim(-1, ax).contiguous(),
                           scales.movedim(-1, ax).contiguous(), bits, g, ax,
                           "mx")


def dequantize_values(values: torch.Tensor, scales: torch.Tensor, *,
                      axis: Optional[int] = -1, bits: int = 8,
                      fmt: str = "int", dtype=torch.float32) -> torch.Tensor:
    """Values times their group's scale, computed in fp32, returned in
    ``dtype``: the inverse of ``quantize`` / ``quantize_mx`` (up to
    rounding) on the raw (values, scales) pair."""
    if axis is None:
        return (values.float() * scales.float()).to(dtype)
    if fmt == "mx":
        v = fp4_decode(unpack_fp4(values, axis=axis)) if bits == 4 \
            else values.float()
        sm = e8m0_decode(scales.movedim(axis, -1))
    else:
        v = values
        sm = scales.movedim(axis, -1).float()
    vm = v.movedim(axis, -1).float()
    K, n = vm.shape[-1], sm.shape[-1]
    out = (vm.reshape(vm.shape[:-1] + (n, K // n))
           * sm[..., None]).reshape(vm.shape)
    return out.movedim(-1, axis).to(dtype)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """``dequantize_values`` of a ``QuantizedTensor``."""
    return dequantize_values(qt.values, qt.scales, axis=qt.axis,
                             bits=qt.bits, fmt=qt.fmt, dtype=dtype)


def quantize_kv(x: torch.Tensor, scale_dtype=torch.bfloat16):
    """KV layout: (..., hd) -> int8 values + a per-row scale (..., 1) in
    ``scale_dtype``: one absmax group spanning the head dim, so the scale
    rides next to its row in the page pool.  (``quantize`` with one group,
    without building a ``QuantizedTensor`` on the decode path.)"""
    xf = x.float()
    scales = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127, min=1e-8)
    q = torch.clamp(torch.round(xf / scales), -127, 127).to(STORAGE_DTYPE)
    return q, scales.to(scale_dtype)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    """``q * scale`` in ``dtype`` (the JAX package's product order)."""
    return q.to(dtype) * scale.to(dtype)


__all__ = ["QuantizedTensor", "granule", "fp4_encode", "fp4_decode",
           "pack_fp4", "unpack_fp4", "e8m0_decode", "absmax_scales",
           "quantize", "quantize_mx", "dequantize", "dequantize_values",
           "quantize_kv", "dequantize_kv", "FP4_VALUES", "E8M0_BIAS"]
