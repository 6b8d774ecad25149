"""The raw kernel API of the port.

Every kernel function here launches a CUDA kernel written for Hopper on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor; the plain
versions and the oracles are in ``ref.py``; ``lse_combine`` and
``wkv6_with_state`` are plain PyTorch around the kernels, as in the JAX
package's ``kernels/ops.py``.  Each kernel takes its launch
parameters as ``cfg`` (default ``LaunchConfig()``): the model path calls
these with the configs its engine resolved at build, and the tuner times
them.  ``repro_torch.kernels`` exports the registry-dispatching wrappers
of the same kernels (no ``cfg``: the tuned one).  ``launch_counts`` /
``reset_launch_counts`` read and zero the per-kernel launch counters, which
is how a run shows that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import axpy as _axpy
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import dotp as _dotp
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_adamw as _adamw
from repro_torch.kernels import gemv as _gemv
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import mx_gemv as _mx
from repro_torch.kernels import prefill_attention as _pre
from repro_torch.kernels import qgemv as _q
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import rwkv6 as _rwkv6
from repro_torch.kernels.axpy import axpy
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8,
                                                  decode_attention_stats,
                                                  paged_decode_attention,
                                                  paged_decode_attention_int8)
from repro_torch.kernels.dotp import dotp
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_adamw import fused_adamw
from repro_torch.kernels.gemv import batched_gemv, gemv
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.mx_gemv import (batched_mx_qgemv,
                                         grouped_expert_qgemv, mx_qgemv,
                                         mx_qgemv_swiglu)
from repro_torch.kernels.prefill_attention import prefill_attention_paged
from repro_torch.kernels.qgemv import batched_qgemv, qgemv
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rwkv6 import wkv6

# kernel name -> (wrapper module, its launch counter, its plain version)
_KERNELS = {
    "rmsnorm": (_rms, "launches", "plain"),
    "gemv": (_gemv, "launches", "plain"),
    "paged_decode_attention": (_dec, "launches", "plain"),
    "prefill_attention_paged": (_pre, "launches", "plain"),
    "paged_decode_attention_int8": (_dec, "int8_launches", "plain_int8"),
    "mx_qgemv": (_mx, "launches", "plain"),
    "mx_qgemv_swiglu": (_mx, "swiglu_launches", "plain_swiglu"),
    "grouped_expert_qgemv": (_mx, "grouped_launches", "plain_grouped"),
    "fused_adamw": (_adamw, "launches", "plain"),
    "dotp": (_dotp, "launches", "plain"),
    "axpy": (_axpy, "launches", "plain"),
    "batched_gemv": (_gemv, "batched_launches", "plain_batched"),
    "decode_attention": (_dec, "dense_launches", "plain_dense"),
    "qgemv": (_q, "launches", "plain"),
    "batched_qgemv": (_q, "batched_launches", "plain_batched"),
    "batched_mx_qgemv": (_mx, "batched_launches", "plain_batched"),
    "decode_attention_int8": (_dec, "dense_int8_launches",
                              "plain_dense_int8"),
    "flash_attention": (_flash, "launches", "plain"),
    "rwkv6": (_rwkv6, "launches", "plain"),
    "mamba_scan": (_mamba, "launches", "plain"),
}

#: the plain version of each kernel, by name
PLAIN = {name: getattr(mod, fn) for name, (mod, _, fn) in _KERNELS.items()}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr, _) in _KERNELS.items()}


def reset_launch_counts():
    for mod, attr, _ in _KERNELS.values():
        setattr(mod, attr, 0)
    _mx.shape_launches.clear()


def mx_qgemv_launches_by_shape() -> Dict[str, int]:
    """``mx_qgemv``'s launches since the last reset, by "fp4 K->N"."""
    return dict(_mx.shape_launches)


def lse_combine(partials):
    """Combine split-S decode partials [(acc, m, l), ...] -> (B,KV,G,hd)
    fp32: the associative log-sum-exp combine of the JAX package's
    ``kernels/ops.py:lse_combine`` (plain PyTorch; with the cache sharded
    over S each shard's ``decode_attention_stats`` gives one partial).  A
    row no partial saw (l = 0 everywhere) gives 0."""
    acc, m, l = partials[0]
    for acc2, m2, l2 in partials[1:]:
        m_new = torch.maximum(m, m2)
        a1, a2 = torch.exp(m - m_new), torch.exp(m2 - m_new)
        acc = acc * a1 + acc2 * a2
        l = l * a1 + l2 * a2
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def wkv6_with_state(r, k, v, w, u, state0, cfg: LaunchConfig = DEFAULT):
    """WKV6 with a carried-in state, in the JAX package's form
    (``kernels/ops.py:wkv6_with_state``): the kernel from a zero state,
    then the carried state folded in, y_t += (r_t decayed to the sequence
    start) @ state0 by one einsum and state += diag(prod w) state0 (an
    exact, associative split of the recurrence).  The port's ``wkv6``
    itself starts from ``state0`` and gives the same function."""
    y, state = wkv6(r, k, v, w, u, torch.zeros_like(state0), cfg)
    lw = torch.log(torch.clamp(w.float(), min=1e-30))
    cum_x = torch.cumsum(lw, dim=1) - lw                   # exclusive, <= 0
    r_dec = r.float() * torch.exp(cum_x)
    y = y + torch.einsum("bthi,bhij->bthj", r_dec, state0.float())
    decay_all = torch.exp(torch.sum(lw, dim=1))            # (B,H,hd)
    state = state + decay_all[..., None] * state0.float()
    return y, state


def build() -> Dict[str, Dict[str, object]]:
    """Compile every kernel now (normally done at first use); returns the
    per-source build log, empty when the libraries were already built."""
    return _build.build_all()


__all__ = ["rmsnorm", "gemv", "paged_decode_attention",
           "prefill_attention_paged", "paged_decode_attention_int8",
           "mx_qgemv", "mx_qgemv_swiglu", "grouped_expert_qgemv",
           "fused_adamw", "dotp", "axpy", "batched_gemv",
           "decode_attention", "decode_attention_stats", "lse_combine",
           "qgemv", "batched_qgemv", "batched_mx_qgemv",
           "decode_attention_int8", "flash_attention", "wkv6",
           "wkv6_with_state", "mamba_scan",
           "PLAIN", "launch_counts", "reset_launch_counts", "build"]
