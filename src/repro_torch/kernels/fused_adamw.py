"""Fused AdamW: the wrapper of ``csrc/fused_adamw.cu``, its launch count,
its plain version and its registry entry.

Replaces the JAX package's Pallas ``kernels/fused_adamw.py:fused_adamw``.
The CUDA kernel is bound by bytes (p, g, mu and nu read once, p, mu and nu
written once); ``csrc/fused_adamw.cu`` says how its design meets that.  One
call updates every tensor of one leaf of the JAX parameter tree (the port
keeps a stacked leaf's layers as separate tensors) in place, so a training
step launches the kernel once per JAX leaf.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import (itemsize, meta, numel, seeded,
                                       troop_kernel)

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

#: tensors one launch takes (``kMaxTensors`` in the source); a longer leaf
#: takes one launch per this many
MAX_TENSORS = 32

_ARGTYPES = {"repro_fused_adamw": [_build.I, _build.I, _build.P, _build.P,
                                   _build.I, _build.P]}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


@torch.no_grad()
def plain(params: Sequence[torch.Tensor], grads, mus, nus, hyper):
    """The plain PyTorch version: ``ref.fused_adamw`` on each tensor with
    the seven fp32 hyper-parameters of ``hyper`` (lr, b1, b2, eps, wd, bc1,
    bc2), the results written back in place."""
    lr, b1, b2, eps, wd, bc1, bc2 = hyper.unbind(0)
    for p, g, mu, nu in zip(params, grads, mus, nus):
        p2, mu2, nu2 = ref.fused_adamw(p, g, mu, nu, lr=lr, b1=b1, b2=b2,
                                       eps=eps, wd=wd, bc1=bc1, bc2=bc2)
        p.copy_(p2)
        mu.copy_(mu2)
        nu.copy_(nu2)


def _bad(params, grads, mus, nus, hyper) -> bool:
    dev = params[0].device
    if hyper.device != dev or hyper.dtype != torch.float32 \
            or hyper.shape != (7,) or not hyper.is_contiguous() \
            or hyper.data_ptr() % 16:
        return True
    dt = params[0].dtype
    for p, g, mu, nu in zip(params, grads, mus, nus):
        n = p.numel()
        if (p.dtype != dt or g.dtype != dt or mu.dtype != torch.float32
                or nu.dtype != torch.float32
                or g.numel() != n or mu.numel() != n or nu.numel() != n
                or any(a.device != dev or not a.is_contiguous()
                       or a.data_ptr() % 16 for a in (p, g, mu, nu))):
            return True
    return False


def fused_adamw(params: Sequence[torch.Tensor], grads, mus, nus, hyper,
                cfg: LaunchConfig = DEFAULT):
    """One AdamW step over the tensors of one parameter leaf, in place:
    ``params`` (fp32 or bf16), ``grads`` (as params), ``mus`` and ``nus``
    (fp32), four equally long lists of tensors of equal sizes, and
    ``hyper`` (7,) fp32 on their device (lr, b1, b2, eps, wd, bc1, bc2).

    The parameters' device picks the route: CPU parameters take the plain
    version; CUDA ones launch the kernel (every tensor and ``hyper`` on
    that device, contiguous, 16-byte aligned, p and g of one type) once per
    ``MAX_TENSORS`` tensors, or raise."""
    global launches
    if not (len(params) == len(grads) == len(mus) == len(nus)) \
            or not params:
        raise ValueError(f"fused_adamw takes four equally long, non-empty "
                         f"lists; got {len(params)}, {len(grads)}, "
                         f"{len(mus)}, {len(nus)}")
    dev = params[0].device
    if dev.type == "cpu":
        return plain(params, grads, mus, nus, hyper)
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw: unsupported device {dev}")
    dtype = _DTYPE.get(params[0].dtype)
    if dtype is None or _bad(params, grads, mus, nus, hyper):
        raise ValueError(
            "fused_adamw kernel takes contiguous, 16-byte aligned tensors on "
            "the parameters' device, hyper (7,) fp32 there too: p and g both "
            "fp32 or both bf16, mu and nu fp32, of equal sizes; got "
            + ", ".join(f"{tuple(a.shape)} {a.dtype} {a.device}"
                        for a in (params[0], grads[0], mus[0], nus[0],
                                  hyper)))
    lib = _build.library("fused_adamw", _ARGTYPES)
    stream = _build.stream_handle(dev)
    for i in range(0, len(params), MAX_TENSORS):
        rows = [(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                 p.numel())
                for p, g, mu, nu in zip(params[i:i + MAX_TENSORS],
                                        grads[i:i + MAX_TENSORS],
                                        mus[i:i + MAX_TENSORS],
                                        nus[i:i + MAX_TENSORS])]
        table = (ctypes.c_int64 * (5 * len(rows)))(*(v for r in rows
                                                     for v in r))
        err = lib.repro_fused_adamw(dtype, len(rows), ctypes.addressof(table),
                                    hyper.data_ptr(), cfg.adamw_streams,
                                    stream)
        _build.check(err, "fused_adamw")
        launches += 1


def fused_adamw_leaf(p, g, mu, nu, *, hyper, cfg: LaunchConfig = DEFAULT):
    """One tensor through ``fused_adamw`` in place, the JAX kernel's
    positional arguments (p, g, mu, nu): the registry's calling convention.
    Returns (p, mu, nu), updated."""
    fused_adamw([p], [g], [mu], [nu], hyper, cfg=cfg)
    return p, mu, nu


def _example(small: bool = True, device=None):
    n = 4096 if small else 1 << 20
    p = seeded(0, (n,), torch.float32, device=device)
    g = seeded(1, (n,), torch.float32, device=device)
    hyper = torch.tensor([1e-3, 0.9, 0.95, 1e-8, 0.1, 0.1, 0.1],
                         dtype=torch.float32).to(p.device)
    return (p, g, torch.zeros_like(p), torch.zeros_like(p)), {"hyper": hyper}


#: ``fused_adamw`` through the tune registry (the JAX package's cost model;
#: ``tune.measure`` runs it on copies, never on the caller's state)
fused_adamw_tuned = troop_kernel(
    "fused_adamw",
    flops=lambda p, g, mu, nu: 12.0 * numel(p),
    # one pass: read (p, g, mu, nu), write (p', mu', nu'); moments fp32
    bytes=lambda p, g, mu, nu: numel(p) * (2 * itemsize(p) + itemsize(g)
                                           + 4 * 4),
    streamed=lambda p, g, mu, nu: [p, p, g] + [
        meta(p.shape, torch.float32)] * 4,
    #   p in + p' out + g in + (mu, nu) fp32 in/out
    space={"adamw_streams": (1, 2)},
    ref="fused_adamw", example=_example)(fused_adamw_leaf)
