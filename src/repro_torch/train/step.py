"""train_step / eval_step builders.

The port of ``repro.train.step``: ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)`` with gradient accumulation over microbatches
(in fp32, the masters' dtype).  Gradients come from autograd into each
master's ``.grad`` and are released after the update; parameters and
moments are updated in place.  A step never reads the device from the
host: the metrics are device tensors, read by the caller when it logs.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import dtype_of
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (OptConfig, clip_by_global_norm,
                                     make_optimizer, named)
from repro_torch.train import losses as L


def make_loss_fn(model, rt):
    def loss_fn(params, batch):
        cfg = model.cfg
        if rt.loss_chunk:
            # chunked xent: run the trunk, then chunk the readout
            T.check_trainable(cfg)
            dtype = dtype_of(cfg.dtype)
            x = T.embed_inputs(params, cfg, batch, dtype)
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
            x = T.run_layers(params, cfg, rt, x, positions, dtype)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            loss = L.chunked_softmax_xent(
                x, lambda xc: T.readout(params, cfg, xc, dtype),
                batch["targets"], rt.loss_chunk)
        else:
            logits, aux = T.train_logits(params, cfg, rt, batch)
            loss = L.softmax_xent(logits, batch["targets"])
        return loss + aux, {"xent": loss, "aux": aux}
    return loss_fn


def make_train_step(model, opt_cfg: OptConfig, *, microbatches: int = 1,
                    compression=None):
    """Returns (train_step, optimizer)."""
    if compression is not None:
        raise NotImplementedError(
            "gradient compression on the data-parallel reduction is not "
            "ported yet — ROADMAP queue 1 item 12 (dist/compression)")
    opt = make_optimizer(opt_cfg)
    loss_fn = make_loss_fn(model, model.rt)

    def compute_grads(params, batch):
        ps = named(params)
        for p in ps.values():
            p.grad = None
        if microbatches <= 1:
            loss, aux = loss_fn(params, batch)
            loss.backward()
            grads = {n: p.grad for n, p in ps.items()}
            return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
                grads
        B = batch["tokens"].shape[0]
        assert B % microbatches == 0
        m = B // microbatches
        total = torch.zeros((), dtype=torch.float32,
                            device=batch["tokens"].device)
        for i in range(microbatches):
            mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, aux = loss_fn(params, mb)
            loss.backward()                 # accumulates into .grad, fp32
            total = total + loss.detach()
        inv = 1.0 / microbatches
        grads = {n: p.grad for n, p in ps.items()}
        torch._foreach_mul_(list(grads.values()), inv)
        return total * inv, {k: v.detach() for k, v in aux.items()}, grads

    def train_step(params, opt_state, batch):
        loss, aux, grads = compute_grads(params, batch)
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state, lr = opt.update(grads, opt_state, params)
        for p in named(params).values():
            p.grad = None
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, **aux}
        return params, opt_state, metrics

    return train_step, opt


def make_eval_step(model):
    loss_fn = make_loss_fn(model, model.rt)

    @torch.no_grad()
    def eval_step(params, batch):
        loss, aux = loss_fn(params, batch)
        return {"loss": loss, **aux}
    return eval_step
