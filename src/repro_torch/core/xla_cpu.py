"""fp32 ``exp``, ``exp2`` and ``floor(log2)`` as XLA computes them on the CPU.

The port is held to the JAX package's bits on the CPU: MX codes and E8M0
scales byte for byte, MoE router gates and capacity drops exactly.  Where
torch's functions differ from XLA's CPU ones by an ulp, that is enough to
move a code, a scale or a top-k pick, so the port takes these three from
here (ROADMAP §3 lists the inputs where they still differ):

* ``jnp.log2(x)`` is ``log(x) * 1.44269502`` in fp32 (XLA folds the
  division by ``log(2)`` into that multiply); the exact ``floor(log2)``
  differs from it just below some powers of two.
* ``jnp.exp2(n)`` is ``exp(n * 0.693147182)`` in fp32, which is not an exact
  power of two for most integers ``n``.
* ``jnp.exp(x)`` is Cephes' range reduction and degree-5 polynomial, each
  step a fused multiply-add, subnormal results flushed to zero; torch's CPU
  ``exp`` differs from it by an ulp on ~10% of inputs.  On the card
  ``exp`` is ``torch.exp``: nothing holds the card to XLA's CPU bits.

The constants multiply as Python scalars: torch rounds them to fp32 first,
and a function that builds no tensor from host data can be captured in a
CUDA graph.
"""
from __future__ import annotations

import struct

import torch

_LN2 = 0.693147182            # fp32 log(2), the factor of XLA's exp2
_INV_LN2 = 1.44269502         # fp32 1/log(2), the factor of XLA's log2


def _f32(v: float) -> float:
    """``v`` rounded to fp32 (a Python float that torch takes exactly)."""
    return struct.unpack("f", struct.pack("f", v))[0]


_EXP_LO, _EXP_HI = _f32(-88.3762626647949), _f32(88.3762626647950)
_LOG2E, _LN2_HI, _LN2_LO = (_f32(1.44269504088896341), _f32(0.693359375),
                            _f32(-2.12194440e-4))
_EXP_P = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                 8.3334519073e-3, 4.1665795894e-2,
                                 1.6666665459e-1, 5.0000001201e-1))
_FP32_TINY = 1.1754943508222875e-38


def exp2(n: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` of fp32 ``n``."""
    return torch.exp(n.float() * _LN2)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.floor(jnp.log2(x))`` of fp32 ``x``."""
    return torch.floor(torch.log(x) * _INV_LN2)


def _fma(a, b, c):
    """fp32 a * b + c rounded once (the product of two fp32 values is exact
    in float64)."""
    return (a.double() * b + c).float()


def exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of fp32 ``x``: XLA's CPU polynomial on a CPU tensor,
    ``torch.exp`` on the card."""
    if x.device.type != "cpu":
        return torch.exp(x)
    x = x.clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(_fma(x, _LOG2E, 0.5))
    r = _fma(fx, -_LN2_HI, x)
    r = _fma(fx, -_LN2_LO, r)
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    out = y * torch.pow(2.0, fx)
    return torch.where(out < _FP32_TINY, 0.0, out)
