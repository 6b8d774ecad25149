"""The ``Model`` facade and ``build_model``."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.transformer import RuntimeConfig


class Model(nn.Module):
    """A config, its runtime switches and its parameters (``params``, an
    ``nn.ModuleDict`` with the JAX package's keys), with the serving and
    training entry points of the JAX ``Model`` facade.  A ``trainable``
    model holds fp32 masters that require grad (the JAX package's
    ``param_dtype``) and casts them to the compute dtype inside every
    layer; a serving model holds frozen weights cast once.  ``.to(device)``
    moves the parameters."""

    def __init__(self, cfg, rt: RuntimeConfig, params: nn.ModuleDict,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.rt = rt.validate()
        self.params = params
        self.trainable = trainable

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"]["scale"].device

    def with_runtime(self, rt: RuntimeConfig) -> "Model":
        """The same parameters under other runtime switches (e.g. the plain
        path beside the kernel path)."""
        return Model(self.cfg, rt, self.params, self.trainable)

    def init(self, seed: int = 0) -> nn.ModuleDict:
        """Fresh parameters from ``seed`` on the model's device, of the
        kind it holds (fp32 masters that require grad for a trainable
        model), as ``build_model`` makes them."""
        return _init(self.cfg, self.device, seed, self.trainable)

    def train_logits(self, batch):
        """(logits (B, T, V), aux) of the full causal forward."""
        return T.train_logits(self.params, self.cfg, self.rt, batch)

    def decode_step(self, batch, caches):
        return T.decode_step(self.params, self.cfg, self.rt, batch, caches)

    def prefill(self, batch):
        """(logits, dense caches) of a bucket of prompts (see
        transformer.prefill)."""
        return T.prefill(self.params, self.cfg, self.rt, batch)

    def chunk_step(self, batch, caches):
        """One chunked-prefill slab (see transformer.chunk_prefill_step)."""
        return T.chunk_prefill_step(self.params, self.cfg, self.rt, batch,
                                    caches)

    def init_caches(self, B, S, dtype=None, page_spec=None,
                    chunk_stage: int = 0, device=None):
        """The decode caches on the model's device, or on ``device`` (the
        ``meta`` device builds their shapes only)."""
        dtype = dtype or dtype_of(self.cfg.dtype)
        return T.init_caches(self.cfg, self.rt, B, S, dtype,
                             page_spec=page_spec,
                             device=device or self.device,
                             chunk_stage=chunk_stage)


def _init(cfg, dev, seed, trainable, quantize=None) -> nn.ModuleDict:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if not trainable:
        return T.init_lm(cfg, generator=g, device=dev, quantize=quantize)
    T.check_trainable(cfg)
    return T.init_lm(cfg, generator=g, device=dev,
                     dtype=cfg.param_dtype).requires_grad_(True)


def build_model(cfg, rt: RuntimeConfig = RuntimeConfig(), *,
                params: Optional[nn.ModuleDict] = None,
                device: DeviceLike = None, seed: int = 0,
                trainable: bool = False, quantize=None) -> Model:
    """``params`` (e.g. from ``bridge.params_from_numpy``) or a seeded random
    init made on ``device`` — the CUDA card unless ``device="cpu"``.
    ``trainable``: the init makes fp32 masters that require grad (bridged
    ``params`` must be made so: ``params_from_numpy(..., trainable=True)``).
    ``quantize`` (a ``quant.quantizer``): the serving init quantized layer
    by layer as it is drawn (``init_lm``)."""
    dev = resolve_device(device)
    if params is None:
        if quantize is not None and trainable:
            raise ValueError("trainable masters are not quantized")
        params = _init(cfg, dev, seed, trainable, quantize)
    else:
        T.check_supported(cfg)
    return Model(cfg, rt, params, trainable).to(dev)
