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
    ``nn.ModuleDict`` with the JAX package's keys), with the serving entry
    points of the JAX ``Model`` facade.  ``.to(device)`` moves the
    parameters."""

    def __init__(self, cfg, rt: RuntimeConfig, params: nn.ModuleDict):
        super().__init__()
        self.cfg = cfg
        self.rt = rt.validate()
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"]["scale"].device

    def with_runtime(self, rt: RuntimeConfig) -> "Model":
        """The same parameters under other runtime switches (e.g. the plain
        path beside the kernel path)."""
        return Model(self.cfg, rt, self.params)

    def decode_step(self, batch, caches):
        return T.decode_step(self.params, self.cfg, self.rt, batch, caches)

    def chunk_step(self, batch, caches):
        """One chunked-prefill slab (see transformer.chunk_prefill_step)."""
        return T.chunk_prefill_step(self.params, self.cfg, self.rt, batch,
                                    caches)

    def init_caches(self, B, S, dtype=None, page_spec=None,
                    chunk_stage: int = 0):
        dtype = dtype or dtype_of(self.cfg.dtype)
        return T.init_caches(self.cfg, self.rt, B, S, dtype,
                             page_spec=page_spec, device=self.device,
                             chunk_stage=chunk_stage)


def build_model(cfg, rt: RuntimeConfig = RuntimeConfig(), *,
                params: Optional[nn.ModuleDict] = None,
                device: DeviceLike = None, seed: int = 0) -> Model:
    """``params`` (e.g. from ``bridge.params_from_numpy``) or a seeded random
    init made on ``device`` — the CUDA card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if params is None:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = T.init_lm(cfg, generator=g, device=dev)
    else:
        T.check_supported(cfg)
    return Model(cfg, rt, params).to(dev)
