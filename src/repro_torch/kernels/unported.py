"""The kernels of the JAX registry that the port has not ported yet.

Each is registered under its JAX name with the JAX package's cost model,
streamed operands, space and example shapes, so that the port's registry
holds the JAX registry's names, ``get_tuned`` answers every name with a
default config and the cost models can be audited now.  Calling one (or
tuning it) raises ``NotImplementedError`` naming ROADMAP item 11, which
ports them.
"""
from __future__ import annotations

import torch

from repro_torch.tune.registry import (itemsize, meta, numel, seeded,
                                       troop_kernel)


def _not_ported(name: str, jax_fn: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (the JAX package's {jax_fn}): "
            f"ROADMAP item 11 (the remaining TPU kernels)")
    fn.__name__ = name
    return fn


def _flash_example(small: bool = True, device=None):
    B, T, H, KV, hd, S = (1, 128, 4, 2, 64, 128) if small \
        else (2, 512, 8, 2, 64, 512)
    f32 = torch.float32
    return (seeded(0, (B, T, H, hd), f32, device=device),
            seeded(1, (B, S, KV, hd), f32, device=device),
            seeded(2, (B, S, KV, hd), f32, device=device)), {"causal": True}


def _rwkv6_example(small: bool = True, device=None):
    B, T, H, hd = (1, 64, 2, 32) if small else (1, 256, 4, 64)
    f32 = torch.float32
    r, k, v = (seeded(i, (B, T, H, hd), f32, device=device)
               for i in range(3))
    w = torch.exp(-torch.exp(seeded(3, (B, T, H, hd), f32, device=device)))
    u = torch.full((H, hd), 0.5, device=r.device)
    s0 = torch.zeros((B, H, hd, hd), device=r.device)
    return (r, k, v, w, u, s0), {}


def _mamba_example(small: bool = True, device=None):
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


flash_attention = troop_kernel(
    "flash_attention",
    flops=lambda q, k, v: (4.0 * q.shape[0] * q.shape[1] * k.shape[1]
                           * q.shape[2] * q.shape[3]),
    bytes=lambda q, k, v: (
        2 * q.shape[0] * q.shape[1] * q.shape[2] * q.shape[3] * itemsize(q)
        + k.shape[0] * k.shape[1] * k.shape[2] * k.shape[3]
        * (itemsize(k) + itemsize(v))),
    streamed=lambda q, k, v: [q, q, k, v],   # q in + q-shaped out + cache
    space={"unroll": (1, 2), "block_k": (256, 512)},
    example=_flash_example, key_kwargs=("causal",),
)(_not_ported("flash_attention",
              "kernels/flash_attention.py:84 flash_attention"))

wkv6 = troop_kernel(
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
    space={"block_n": (64, 128, 256)}, example=_rwkv6_example,
)(_not_ported("wkv6", "kernels/rwkv6.py:107 wkv6"))

mamba_scan = troop_kernel(
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
    space={"block_n": (64, 128, 256)}, example=_mamba_example,
)(_not_ported("mamba_scan", "kernels/mamba_scan.py:91 mamba_scan"))
