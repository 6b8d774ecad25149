"""Serving steps: ``make_prefill_step`` (bucketed), ``make_chunk_step``,
``make_serve_step`` (greedy or sampled), the stateless sampler, and
``tuned_kernel_configs``.

Each step function ``(batch, caches) -> (next tokens, caches)`` enqueues
the step's work on the device and returns without waiting: the tokens are
a device tensor, read by the engine later.

Temperature sampling draws ``argmax(row / T + g)`` with Gumbel noise ``g``
from a counter-based hash of (seed, slot, position, admission nonce,
vocab index): splitmix64 in int64 torch ops.  It keeps no generator
state, so a CUDA-graph replay and an eager step draw the same bits, on
the card as on the CPU.  The JAX package folds the same four numbers into
a PRNG key and draws ``categorical(row / T)``; its bits cannot be
reproduced in torch, so the two packages' sampled tokens agree in
distribution, not bit for bit.

``tuned_kernel_configs`` resolves the best-known ``LaunchConfig`` of each
decode-path kernel at the serving shapes (from the persistent tune cache,
defaults when untuned), once, when the engine is built; ``launch_config``
folds the ones the engine's path runs into the one ``LaunchConfig`` its
steps launch the kernels with, so a step makes no tune-cache lookup.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.troop import DEFAULT, LaunchConfig


def tuned_kernel_configs(model_cfg, batch_size: int, max_seq: int,
                         dtype=torch.bfloat16, page_size: int = 16,
                         num_pages=None, chunk_size: int = 32
                         ) -> Dict[str, LaunchConfig]:
    """LaunchConfigs for the decode-path kernels at the serving shapes.

    The JAX package's ``serve/step.py:tuned_kernel_configs``, key for key
    and shape for shape: a pure shape-level lookup (``meta`` tensors —
    nothing is allocated) of decode attention over the KV cache (dense and
    paged layouts, bf16 and int8) and of the GEMV-class readout
    projection.  The paged pool geometry comes from ``PageSpec.for_engine``
    — the same formula the engine allocates with — so the key always
    matches the pool the engine will run (pass ``num_pages`` when
    overcommitting).  Every name answers its tuned config from the cache,
    ``qgemv`` (int8 codes of the read-out) and ``decode_attention_int8``
    (the dense int8 cache) included, and its default when untuned; the
    engine's steps launch only the paged path's kernels
    (``launch_config``)."""
    import repro_torch.kernels  # noqa: F401  (populates the tune registry)
    from repro_torch.quant.tensor import granule
    from repro_torch.serve.kvcache import PageSpec
    from repro_torch.tune import get_tuned
    from repro_torch.tune.registry import meta

    i8, i32, f32 = torch.int8, torch.int32, torch.float32
    B, S = batch_size, max_seq
    KV, hd, H = (model_cfg.num_kv_heads, model_cfg.head_dim,
                 model_cfg.num_heads)
    d, V = model_cfg.d_model, model_cfg.vocab_size
    spec = PageSpec.for_engine(B, S, page_size, num_pages, dtype)
    P, nblk = spec.num_pages, spec.blocks_per_slot
    # int8 pages obey the coarser int8 layout granule (32 rows); the scale
    # group of the quantized readout GEMV likewise (mechanism D)
    p8 = -(-page_size // granule()) * granule()
    spec8 = PageSpec.for_engine(B, S, p8, num_pages, "int8")
    P8, nblk8 = spec8.num_pages, spec8.blocks_per_slot
    g = 128 if d % 128 == 0 else d
    return {
        "decode_attention": get_tuned(
            "decode_attention",
            meta((B, H, hd), dtype), meta((B, S, KV, hd), dtype),
            meta((B, S, KV, hd), dtype), meta((B,), i32)),
        "decode_attention_int8": get_tuned(
            "decode_attention_int8",
            meta((B, H, hd), dtype),
            meta((B, S, KV, hd), i8), meta((B, S, KV, 1), torch.bfloat16),
            meta((B, S, KV, hd), i8), meta((B, S, KV, 1), torch.bfloat16),
            meta((B,), i32)),
        "paged_decode_attention": get_tuned(
            "paged_decode_attention",
            meta((B, H, hd), dtype),
            meta((P, page_size, KV, hd), dtype),
            meta((P, page_size, KV, hd), dtype),
            meta((B, nblk), i32), meta((B,), i32)),
        "paged_decode_attention_int8": get_tuned(
            "paged_decode_attention_int8",
            meta((B, H, hd), dtype),
            meta((P8, p8, KV, hd), i8),
            meta((P8, p8, KV, 1), torch.bfloat16),
            meta((P8, p8, KV, hd), i8),
            meta((P8, p8, KV, 1), torch.bfloat16),
            meta((B, nblk8), i32), meta((B,), i32)),
        "prefill_attention_paged": get_tuned(
            "prefill_attention_paged",
            meta((1, chunk_size, H, hd), dtype),
            meta((P, page_size, KV, hd), dtype),
            meta((P, page_size, KV, hd), dtype),
            meta((1, nblk), i32), meta((1,), i32), meta((1,), i32)),
        "gemv": get_tuned("gemv", meta((V, d), dtype), meta((d,), dtype)),
        "qgemv": get_tuned(
            "qgemv", meta((V, d), i8), meta((V, d // g), f32),
            meta((d,), dtype)),
        "rmsnorm": get_tuned("rmsnorm", meta((B, d), dtype),
                             meta((d,), f32)),
    }


def launch_config(configs: Optional[Dict[str, LaunchConfig]],
                  kv_dtype: Optional[str] = None) -> LaunchConfig:
    """The one ``LaunchConfig`` an engine's steps launch with: from each
    kernel of its path (gemv, rmsnorm, the paged decode of its pool type
    and the paged prefill) the knobs that kernel's registry space names,
    taken from ``configs``; every other field at its default.  No configs
    (or an empty cache) gives ``DEFAULT``."""
    if not configs:
        return DEFAULT
    from repro_torch.tune.registry import get
    decode = "paged_decode_attention_int8" if kv_dtype == "int8" \
        else "paged_decode_attention"
    fields = {}
    for name in ("gemv", "rmsnorm", decode, "prefill_attention_paged"):
        for knob in get(name).space:
            fields[knob] = getattr(configs[name], knob)
    return dataclasses.replace(DEFAULT, **fields)


def make_prefill_step(model, launch: LaunchConfig = DEFAULT):
    """Bucketed batched prefill: batch = {tokens (Bp, L) right-padded,
    length (Bp,) valid rows} -> (next_tok (Bp,) int32, prefill caches (one
    dense ``KVCache`` (Bp, L) a layer)).  Each row's last valid position is
    gathered before the read-out (``transformer.prefill``); the token is
    its greedy argmax, at any temperature, as in the JAX package.  Takes
    no caches (``caches`` is ignored: the step's signature is the
    engine's).  The kernels launch with ``launch``."""
    from repro_torch.models import modules as M

    def prefill_step(batch, caches=None):
        with M.kernel_launch(launch):
            logits, caches = model.prefill(batch)           # (Bp, V)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches
    return prefill_step


def make_chunk_step(model, launch: LaunchConfig = DEFAULT):
    """Chunked prefill: one fixed-size token slab against the shared paged
    caches.  batch = {tokens (1, C) right-padded, offset (1,), valid (1,),
    block_tables (1, nblk)} -> (next_tok (1,) int32, caches).  The token is
    the greedy argmax of the last valid row's logits — only meaningful on a
    prompt's final slab.  The kernels launch with ``launch``."""
    from repro_torch.models import modules as M

    def chunk_step(batch, caches):
        with M.kernel_launch(launch):
            logits, caches = model.chunk_step(batch, caches)        # (B, V)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches
    return chunk_step


def _i64(c: int) -> int:
    """A 64-bit constant as the int64 holding the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GAMMA = _i64(0x9E3779B97F4A7C15)
_MUL1 = _i64(0xBF58476D1CE4E5B9)
_MUL2 = _i64(0x94D049BB133111EB)


def _shr(z, s: int):
    """Logical right shift of int64 bits: the arithmetic shift with the
    sign's copies masked off."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z):
    """splitmix64: the output of the generator whose state is ``z``, one
    step on (multiplies wrap modulo 2^64, as in the integer hash)."""
    z = z + _GAMMA
    z = (z ^ _shr(z, 30)) * _MUL1
    z = (z ^ _shr(z, 27)) * _MUL2
    return z ^ _shr(z, 31)


def sample_bits(seed: int, slot, pos, nonce, vocab: int):
    """(B, vocab) int64 random bits of the draw at each row's (slot, pos,
    nonce) (each (B,)) and vocab index, under ``seed``: the row key is
    ``seed``, then slot, position and nonce folded in one at a time, each
    through ``_mix``; the bits of vocab index v are ``_mix(key ^ v)``."""
    key = _mix(torch.full_like(slot, seed, dtype=torch.int64))
    for part in (slot, pos, nonce):
        key = _mix(key ^ part.long())
    v = torch.arange(vocab, dtype=torch.int64, device=key.device)
    return _mix(key[:, None] ^ v[None, :])


def sample(logits, temperature: float, seed: int, pos, nonce=None):
    """One token a row of ``logits`` (B, V) from ``softmax(row /
    temperature)``, by the Gumbel-max trick: ``argmax(row / T -
    log(-log u))`` with ``u`` in (0, 1) from the top 53 bits of
    ``sample_bits`` (row b is slot b).  Stateless: the same (seed, slot,
    pos, nonce) draws the same token."""
    B, V = logits.shape
    slot = torch.arange(B, device=logits.device)
    nonce = torch.zeros_like(pos) if nonce is None else nonce
    bits = sample_bits(seed, slot, pos, nonce, V)
    u = (_shr(bits, 11).double() + 0.5) * 2.0 ** -53
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits.double() / temperature + g, dim=-1)


def make_serve_step(model, *, temperature: float = 0.0, seed: int = 0,
                    troop_configs: Optional[Dict[str, LaunchConfig]] = None,
                    launch: LaunchConfig = DEFAULT):
    """Single-token decode over every slot: batch = {tokens (B, 1), pos
    (B,)[, block_tables (B, nblk)][, sample_nonce (B,)]} -> (next_tok
    (B, 1) int32, caches).  Greedy at ``temperature`` 0; above it each
    slot samples from ``softmax(row / temperature)`` (``sample``, keyed by
    ``seed``, the slot, its position and its admission's nonce).  The
    kernels launch with ``launch``; ``troop_configs`` (from
    ``tuned_kernel_configs``) is attached to the returned step, as in the
    JAX package, for introspection."""
    from repro_torch.models import modules as M

    def serve_step(batch, caches):
        with M.kernel_launch(launch):
            logits, caches = model.decode_step(batch, caches)
        row = logits[:, -1, :]
        if temperature > 0:
            tok = sample(row, temperature, seed, batch["pos"],
                         batch.get("sample_nonce"))
        else:
            tok = torch.argmax(row, dim=-1)
        return tok[:, None].to(torch.int32), caches
    serve_step.troop_configs = troop_configs
    serve_step.launch = launch
    return serve_step
