"""Basic layers of the port (plain functions on tensors) + kernel routing.

Parameters live in ``nn.ParameterDict`` / ``nn.ModuleDict`` trees whose keys
are those of the JAX package's parameter dicts (``p["w"]``, ``"b" in p``),
so each function here reads like its counterpart in ``repro.models.modules``.
Projection weights are stored ``(out, in)`` — the transpose of JAX's
``(in, out)`` — already in the compute dtype (``bridge.params_from_numpy``
and ``init_lm`` cast them once), which is the layout both ``F.linear`` and
the routed ``gemv`` read.  An MX-quantized projection is a
``QuantizedTensor`` stored as the JAX package stores it, ``(in, out)``
codes with their E8M0 blocks down the contraction axis, the layout the MX
kernels walk.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.quant.tensor import QuantizedTensor

# --------------------------------------------------------------------------
# Kernel routing
# --------------------------------------------------------------------------
# When enabled, single-row projections and rmsnorms dispatch the port's
# CUDA kernels (``repro_torch.kernels.ops``) and the paged attention layers
# take their kernels too; off, every layer is plain PyTorch.  On a CPU
# tensor a kernel wrapper runs its plain version, so routing on the CPU only
# changes which plain code runs.
_KERNEL_ROUTED = False


# The launch parameters of the routed kernels: the configs a serving
# engine resolved from the tune cache when it was built, set around each of
# its steps (``kernel_launch``); the defaults otherwise.  Read once per
# launch, so the model path makes no tune-cache lookup.
_LAUNCH = DEFAULT


def kernel_routed() -> bool:
    return _KERNEL_ROUTED


def launch_config() -> LaunchConfig:
    """The ``LaunchConfig`` the routed kernels launch with now."""
    return _LAUNCH


@contextlib.contextmanager
def kernel_launch(cfg: LaunchConfig):
    """Launch the routed kernels with ``cfg`` inside the block."""
    global _LAUNCH
    prev = _LAUNCH
    _LAUNCH = cfg
    try:
        yield
    finally:
        _LAUNCH = prev


@contextlib.contextmanager
def kernel_routing(enable: bool = True):
    global _KERNEL_ROUTED
    prev = _KERNEL_ROUTED
    _KERNEL_ROUTED = enable
    try:
        yield
    finally:
        _KERNEL_ROUTED = prev


def _gemv_routable(x, w) -> bool:
    """One output row-vector against a 2-D (N, K) weight."""
    return (w.ndim == 2 and x.ndim >= 1 and x.shape[-1] == w.shape[1]
            and math.prod(x.shape[:-1]) == 1)


def _mx_routable(x, w) -> bool:
    """One row-vector against a 2-D MX-quantized weight whose E8M0 blocks
    run down the contraction axis — the layout ``mx_qgemv`` walks."""
    return (isinstance(w, QuantizedTensor) and w.fmt == "mx"
            and len(w.shape) == 2 and w.axis == -2 and x.ndim >= 1
            and x.shape[-1] == w.shape[0]
            and math.prod(x.shape[:-1]) == 1)


def _routed_gemv(w_nk, x, dtype):
    """Dispatch the gemv kernel on an (N, K) weight; returns (N,) in dtype
    (the kernel's fp32 output cast once, as in the JAX package)."""
    from repro_torch.kernels import ops as KO
    return KO.gemv(w_nk, x.reshape(-1).contiguous(), cfg=_LAUNCH).to(dtype)


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------
def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _normal(shape, scale, generator, device):
    """``scale`` x a standard normal truncated to [-2, 2] (fp32), the
    distribution of the JAX package's initializer (``modules._normal``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def dense_init(in_dim: int, out_dim: int, *, bias: bool, dtype, generator,
               device) -> nn.ParameterDict:
    """W stored (out_dim, in_dim) in ``dtype``, fan-in scaled; fp32 zero
    bias."""
    p = nn.ParameterDict({"w": frozen(_normal(
        (out_dim, in_dim), 1.0 / math.sqrt(in_dim), generator,
        device).to(dtype))})
    if bias:
        p["b"] = frozen(torch.zeros(out_dim, device=device))
    return p


def apply_dense(p, x, dtype=None):
    """The JAX package's order of checks: a routed one-row MX projection
    streams its codes and scales through ``mx_qgemv``; any other quantized
    projection dequantizes in fp32, casts to the compute dtype and runs
    ``x @ w`` (as the JAX package leaves many-row projections to XLA); a
    raw one runs the routed ``gemv`` (one row) or ``F.linear``."""
    w = p["w"]
    quantized = isinstance(w, QuantizedTensor)
    if _KERNEL_ROUTED and quantized and _mx_routable(x, w):
        from repro_torch.kernels import ops as KO
        if dtype is not None:
            x = x.to(dtype)
        y = KO.mx_qgemv(w.values, w.scales,
                        x.reshape(-1).contiguous()).to(dtype or x.dtype)
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y.reshape(x.shape[:-1] + (w.shape[-1],))
    if quantized:
        w = w.dequantize(dtype or x.dtype)                    # (in, out)
        if dtype is not None:
            x = x.to(dtype)
        y = x @ w
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    if _KERNEL_ROUTED and _gemv_routable(x, w):
        y = _routed_gemv(w, x, torch.promote_types(x.dtype, w.dtype))
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y.reshape(x.shape[:-1] + (w.shape[0],))
    y = F.linear(x, w)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embed_init(vocab: int, d: int, *, generator, device) -> nn.ParameterDict:
    return nn.ParameterDict({"table": frozen(
        _normal((vocab, d), 1.0, generator, device))})


def apply_embed(p, ids, dtype):
    """The rows of ``ids`` in ``dtype``.  The JAX package casts the whole
    table and then gathers, so the gradient rows of a repeated id add in
    ``dtype``; a table that takes a gradient does the same here.  Otherwise
    (serving) the rows are gathered first and cast: the same values,
    without a cast of the whole table."""
    table = p["table"]
    if table.requires_grad and torch.is_grad_enabled():
        return F.embedding(ids.long(), table.to(dtype))
    return F.embedding(ids.long(), table).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def norm_init(d: int, *, device) -> nn.ParameterDict:
    return nn.ParameterDict({"scale": frozen(torch.ones(d, device=device))})


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    if kind != "rmsnorm" or "bias" in p:
        raise NotImplementedError(
            f"norm {kind!r} is not ported yet: ROADMAP queue 1 item 13 "
            f"(other mixers and archs)")
    if _KERNEL_ROUTED:
        from repro_torch.kernels import ops as KO
        d = x.shape[-1]
        return KO.rmsnorm(x.reshape(-1, d).contiguous(), p["scale"],
                          eps=eps, cfg=_LAUNCH).reshape(x.shape)
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    x = x * p["scale"]
    return x.to(dtype)


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------
def mlp_init(d: int, d_ff: int, *, dtype, generator,
             device) -> nn.ModuleDict:
    """A SwiGLU MLP (the one activation ported)."""
    kw = dict(bias=False, dtype=dtype, generator=generator, device=device)
    return nn.ModuleDict({"wi_gate": dense_init(d, d_ff, **kw),
                          "wi_up": dense_init(d, d_ff, **kw),
                          "wo": dense_init(d_ff, d, **kw)})


def apply_mlp(p, x, act: str, dtype):
    if act != "swiglu" or "wi_gate" not in p:
        raise NotImplementedError(
            f"activation {act!r} is not ported yet: ROADMAP queue 1 item 13 "
            f"(other mixers and archs)")
    wg, wu = p["wi_gate"]["w"], p["wi_up"]["w"]
    if _KERNEL_ROUTED and _mx_routable(x, wg) and _mx_routable(x, wu) \
            and "b" not in p["wi_gate"] and "b" not in p["wi_up"]:
        # fused MX swiglu: gate + up and the silu-gate epilogue in one pass
        from repro_torch.kernels import ops as KO
        xk = x.to(dtype) if dtype is not None else x
        h = KO.mx_qgemv_swiglu(wg.values, wg.scales, wu.values, wu.scales,
                               xk.reshape(-1).contiguous())
        h = h.to(dtype or x.dtype).reshape(x.shape[:-1] + (wg.shape[-1],))
    else:
        h = F.silu(apply_dense(p["wi_gate"], x, dtype)) * \
            apply_dense(p["wi_up"], x, dtype)
    return apply_dense(p["wo"], h, dtype)


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: broadcastable to (..., T).  The
    split-halves form, computed in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., T, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
