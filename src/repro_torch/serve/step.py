"""Serving steps: ``make_chunk_step`` / ``make_serve_step`` (greedy).

Each returns a function ``(batch, caches) -> (next tokens, caches)`` that
enqueues the step's work on the device and returns without waiting: the
tokens are a device tensor, read by the engine one cycle later.
"""
from __future__ import annotations

import torch


def make_chunk_step(model):
    """Chunked prefill: one fixed-size token slab against the shared paged
    caches.  batch = {tokens (1, C) right-padded, offset (1,), valid (1,),
    block_tables (1, nblk)} -> (next_tok (1,) int32, caches).  The token is
    the greedy argmax of the last valid row's logits — only meaningful on a
    prompt's final slab."""
    def chunk_step(batch, caches):
        logits, caches = model.chunk_step(batch, caches)            # (B, V)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches
    return chunk_step


def make_serve_step(model, *, temperature: float = 0.0):
    """Greedy single-token decode over every slot: batch = {tokens (B, 1),
    pos (B,), block_tables (B, nblk)} -> (next_tok (B, 1) int32, caches)."""
    if temperature > 0:
        raise NotImplementedError("temperature sampling is not ported yet: "
                                  "ROADMAP queue 1 item 6 (serving engine)")

    def serve_step(batch, caches):
        logits, caches = model.decode_step(batch, caches)
        return torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32), caches
    return serve_step
