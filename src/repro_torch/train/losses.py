"""Loss functions: softmax cross-entropy (optionally chunked + checkpointed).

The port of ``repro.train.losses``.  The chunked variant recomputes each
chunk's logits in the backward pass, so the full (B, T, vocab) logits
tensor is never resident.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def softmax_xent(logits, targets, z_loss: float = 1e-4):
    """logits (B,T,V) any dtype; targets (B,T) int. fp32 math, mean loss."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)


def chunked_softmax_xent(x, readout_fn, targets, chunk: int,
                         z_loss: float = 1e-4):
    """x (B,T,d) final hidden; logits computed chunk by chunk, each chunk
    under an activation checkpoint (the JAX package's ``jax.checkpoint``
    inside a ``scan``)."""
    B, T, _ = x.shape
    if chunk <= 0 or T % chunk:
        return softmax_xent(readout_fn(x), targets, z_loss)

    def one(xc, tc):
        return softmax_xent(readout_fn(xc), tc, z_loss) * (chunk / T)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(T // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(one, x[:, sl], targets[:, sl],
                                   use_reentrant=False)
    return total


def token_accuracy(logits, targets):
    return (torch.argmax(logits, -1) == targets).float().mean()
