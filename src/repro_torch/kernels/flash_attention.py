"""FLASH ATTENTION: the wrapper of ``csrc/flash_attention.cu``, its launch
count, its plain version and its registry entry.

Replaces the JAX package's Pallas ``kernels/flash_attention.py:
flash_attention``, the paper's GEMM-class control kernel: full-sequence
GQA attention with an online softmax, causal or not.  Bound by its
operations, it takes two CUDA kernels: bf16 inputs run on the tensor cores
(``wgmma`` fed by TMA), fp32 inputs in fp32 on the CUDA cores (no TF32);
``csrc/flash_attention.cu`` says how their tiles map the JAX knobs.
"""
from __future__ import annotations

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.tune.registry import itemsize, seeded, troop_kernel

#: kernel launches so far (the CPU path and the plain version do not count)
launches = 0

_ARGS = [_build.P] * 4 + [_build.I] * 9 + [_build.F, _build.P]
_ARGTYPES = {"repro_flash_attention_f32": _ARGS,
             "repro_flash_attention_bf16": _ARGS}


def plain(q, k, v, causal: bool = True):
    """The plain PyTorch version: the fp32 softmax oracle, in q.dtype."""
    return ref.flash_attention(q, k, v, causal).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True,
                    cfg: LaunchConfig = DEFAULT):
    """q (B,T,H,hd), k/v (B,S,KV,hd) -> (B,T,H,hd) in q.dtype; with
    ``causal`` position s is masked for query t when s > t (aligned at the
    top left).  ``cfg.unroll`` (1, 2) sets the query rows a block (bf16:
    64 a ``wgmma`` warpgroup) and ``cfg.block_k`` (256, 512) the positions
    a tile (bf16: block_k / 4; the source note says how).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (q, k, v
    contiguous, all fp32 or all bf16, hd 32, 64 or 128, H a multiple of
    KV) or raises."""
    global launches
    if q.device.type == "cpu":
        return plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    ok = (q.dtype in (torch.float32, torch.bfloat16)
          and k.dtype == v.dtype == q.dtype and q.dim() == k.dim() == 4
          and k.shape == v.shape and k.shape[0] == q.shape[0]
          and k.shape[3] == q.shape[3] and q.shape[3] in (32, 64, 128)
          and q.shape[1] > 0 and k.shape[1] > 0 and k.shape[2] > 0
          and q.shape[2] % k.shape[2] == 0
          and all(t.device == q.device and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 for t in (q, k, v)))
    if not ok:
        raise ValueError(
            f"flash_attention kernel takes contiguous q (B, T, H, hd) and "
            f"k, v (B, S, KV, hd) on one device, all fp32 or all bf16, hd "
            f"32/64/128, H a multiple of KV; got q {tuple(q.shape)} "
            f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
            f"{v.dtype}")
    if cfg.unroll not in (1, 2) or cfg.block_k not in (256, 512):
        raise ValueError(f"flash_attention takes unroll 1 or 2 and block_k "
                         f"256 or 512; got {cfg.unroll}, {cfg.block_k}")
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.library("flash_attention", _ARGTYPES)
    fn = lib.repro_flash_attention_f32 if q.dtype == torch.float32 \
        else lib.repro_flash_attention_bf16
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T,
             S, H, KV, hd, int(bool(causal)), cfg.unroll, cfg.block_k,
             hd ** -0.5, _build.stream_handle(q.device))
    _build.check(err, "flash_attention")
    launches += 1
    return out


def _example(small: bool = True, device=None):
    B, T, H, KV, hd, S = (1, 128, 4, 2, 64, 128) if small \
        else (2, 512, 8, 2, 64, 512)
    f32 = torch.float32
    return (seeded(0, (B, T, H, hd), f32, device=device),
            seeded(1, (B, S, KV, hd), f32, device=device),
            seeded(2, (B, S, KV, hd), f32, device=device)), {"causal": True}


#: ``flash_attention`` through the tune registry (the JAX package's cost
#: model: all T x S scores, causal or not)
flash_attention_tuned = troop_kernel(
    "flash_attention",
    flops=lambda q, k, v: (4.0 * q.shape[0] * q.shape[1] * k.shape[1]
                           * q.shape[2] * q.shape[3]),
    bytes=lambda q, k, v: (
        2 * q.shape[0] * q.shape[1] * q.shape[2] * q.shape[3] * itemsize(q)
        + k.shape[0] * k.shape[1] * k.shape[2] * k.shape[3]
        * (itemsize(k) + itemsize(v))),
    streamed=lambda q, k, v: [q, q, k, v],   # q in + q-shaped out + cache
    space={"unroll": (1, 2), "block_k": (256, 512)},
    ref="flash_attention", example=_example,
    key_kwargs=("causal",))(flash_attention)
