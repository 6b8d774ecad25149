"""Optimizers (AdamW / Lion / SGD-m) with a plain PyTorch route and, for
AdamW, a fused route through the hand-written ``fused_adamw`` kernel: the
update is the paper's AXPY-class workload, a streaming pass over
parameter-sized arrays.

The port of ``repro.optim.adamw``.  A parameter "tree" here is an
``nn.Module`` (its named parameters) or a dict from the port's parameter
name to a tensor; the state's moments are dicts under the same names, fp32
and shaped like each parameter.  Unlike the JAX package's pure functions,
``update`` writes the parameters, the moments and the step counter in place
(the arrays JAX would donate) and returns them, so the state stays
consistent whether or not the caller keeps what it returns.  Nothing reads the device on the host: the
step counter, the schedule and the bias corrections stay device tensors.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.kernels import ops as K


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | lion | sgdm
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    fused: bool = False            # AdamW through the fused_adamw kernel


class OptState(NamedTuple):
    step: torch.Tensor                          # int32 0-d, on the device
    mu: Dict[str, torch.Tensor]
    nu: Optional[Dict[str, torch.Tensor]]


def named(tree) -> Dict[str, torch.Tensor]:
    """The parameters of a module, or a name -> tensor dict as it is."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def leaf_groups(names) -> Dict[str, List[str]]:
    """The port's parameter names grouped by the leaf of the JAX tree they
    belong to: a stacked JAX leaf holds every layer's tensor of one name
    (``layers.3.mixer.wq.w`` -> ``layers.*.mixer.wq.w``), so qwen1.5-0.5b's
    291 tensors make the JAX tree's 15 leaves."""
    out: Dict[str, List[str]] = {}
    for n in names:
        out.setdefault(re.sub(r"^layers\.\d+\.", "layers.*.", n), []).append(n)
    return out


def lr_at(cfg: OptConfig, step):
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree):
    """sqrt of the sum of squares of every element, in fp32: per-tensor
    norms (``torch._foreach_norm``, a few launches for all tensors), then
    the norm of those."""
    leaves = [x.float() for x in named(tree).values()]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` in place so that their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(torch.div(torch.full_like(norm, max_norm),
                                  norm + 1e-12), max=1.0)
    torch._foreach_mul_(list(named(grads).values()), scale)
    return grads, norm


def make_optimizer(cfg: OptConfig):
    if cfg.name == "adamw":
        return _AdamW(cfg)
    if cfg.name == "lion":
        return _Lion(cfg)
    if cfg.name == "sgdm":
        return _SGDM(cfg)
    raise KeyError(cfg.name)


def _zeros(params) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named(params).items()}


def _step0(params):
    dev = next(iter(named(params).values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


class _AdamW:
    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, params):
        return OptState(_step0(params), _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        c = self.cfg
        step = state.step.add_(1)
        lr = lr_at(c, step)
        t = step.float()
        bc1 = 1 - c.b1 ** t
        bc2 = 1 - c.b2 ** t
        ps = named(params)

        if c.fused:
            # the kernel's seven fp32 hyper-parameters, in device memory
            hyper = torch.stack(
                [lr, *(torch.full((), v, dtype=torch.float32,
                                  device=lr.device)
                       for v in (c.b1, c.b2, c.eps, c.weight_decay)),
                 bc1, bc2])
            for names in leaf_groups(ps).values():
                K.fused_adamw([ps[n] for n in names],
                              [grads[n] for n in names],
                              [state.mu[n] for n in names],
                              [state.nu[n] for n in names], hyper)
            return params, OptState(step, state.mu, state.nu), lr

        for n, p in ps.items():
            g = grads[n].float()
            mu, nu = state.mu[n], state.nu[n]
            mu_ = c.b1 * mu + (1 - c.b1) * g
            nu_ = c.b2 * nu + (1 - c.b2) * g * g
            upd = (mu_ / bc1) / (torch.sqrt(nu_ / bc2) + c.eps)
            p32 = p.float()
            p32 = p32 - lr * (upd + c.weight_decay * p32)
            p.copy_(p32)
            mu.copy_(mu_)
            nu.copy_(nu_)
        return params, OptState(step, state.mu, state.nu), lr


class _Lion:
    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, params):
        return OptState(_step0(params), _zeros(params), None)

    @torch.no_grad()
    def update(self, grads, state, params):
        c = self.cfg
        step = state.step.add_(1)
        lr = lr_at(c, step)
        for n, p in named(params).items():
            g = grads[n].float()
            mu = state.mu[n]
            u = torch.sign(c.b1 * mu + (1 - c.b1) * g)
            p32 = p.float()
            p32 = p32 - lr * (u + c.weight_decay * p32)
            p.copy_(p32)
            mu.copy_(c.b2 * mu + (1 - c.b2) * g)
        return params, OptState(step, state.mu, None), lr


class _SGDM:
    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, params):
        return OptState(_step0(params), _zeros(params), None)

    @torch.no_grad()
    def update(self, grads, state, params):
        c = self.cfg
        step = state.step.add_(1)
        lr = lr_at(c, step)
        for n, p in named(params).items():
            mu = state.mu[n]
            mu.copy_(c.b1 * mu + grads[n].float())
            p.copy_(p.float() - lr * mu)
        return params, OptState(step, state.mu, None), lr
