"""Engine construction API: ``EngineConfig`` + ``build_engine``.

``EngineConfig`` is a copy of the JAX package's frozen record of every
scalar engine option, with the same fields and the same ``validate()``
messages, so a config means the same thing in both packages.  The port's
``build_engine`` serves the chunked, paged, greedy path, with bf16 or int8
KV pages and raw, absmax int (``int8`` / ``int4``) or MX (``mx4`` /
``fp8``) weights; an option that needs a part not ported yet raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.device import DeviceLike


@dataclass(frozen=True)
class EngineConfig:
    """Every scalar option of a serving engine, in one frozen record."""
    # scheduler shape
    slots: int = 4
    cache_len: int = 128
    stop_token: int = -1
    metrics_window: int = 4096
    # cache backend geometry
    backend: str = "dense"               # "dense" | "paged"
    page_size: Optional[int] = None      # None -> layout granule default
    num_pages: Optional[int] = None      # None -> full occupancy
    kv_cache_dtype: str = ""             # "" -> model dtype | "int8"
    # prefill strategy
    prefill_batch: Optional[int] = None
    min_bucket: int = 8
    chunked_prefill: bool = False
    chunk_size: int = 32
    chunks_per_step: int = 1
    prefix_cache: bool = False
    # sampling
    temperature: float = 0.0
    seed: int = 0
    # speculative decoding
    draft_arch: Optional[str] = None
    speculate_k: int = 0
    # tensor parallelism / dispatch
    tp: int = 1
    tp_mode: str = "exact"
    async_dispatch: bool = True
    # factory-level (resolved before ServingEngine construction)
    kernel_decode: bool = False
    quantize_weights: str = "none"  # "none" | "int8" | "int4" | "mx4" | "fp8"
    quantize_group_size: int = 128

    def validate(self) -> "EngineConfig":
        """Cross-field coherence; the JAX package's messages."""
        if self.backend not in ("dense", "paged"):
            raise ValueError(f"backend must be 'dense' or 'paged', "
                             f"got {self.backend!r}")
        if self.chunked_prefill and self.backend != "paged":
            raise ValueError("chunked_prefill requires backend='paged' "
                             "(slabs write through block tables)")
        if self.prefix_cache and not self.chunked_prefill:
            raise ValueError("prefix_cache requires chunked_prefill (a "
                             "prefix hit resumes prefill mid-prompt)")
        if self.kernel_decode and self.backend != "paged":
            raise ValueError("kernel_decode requires backend='paged' (the "
                             "kernel reads the page pool + block table)")
        if self.speculate_k < 0:
            raise ValueError("speculate_k must be >= 0")
        if self.speculate_k:
            if not self.chunked_prefill:
                raise ValueError(
                    "speculative decoding requires chunked_prefill (the "
                    "verify pass reuses the chunked slab attention path)")
            if self.tp != 1:
                raise ValueError("speculative decoding is single-device "
                                 "for now (tp must be 1)")
        if self.draft_arch is not None and not self.speculate_k:
            raise ValueError("draft_arch is set but speculate_k == 0 — "
                             "pass speculate_k > 0 to enable speculation")
        if self.tp < 1:
            raise ValueError("tp must be >= 1")
        if self.quantize_weights not in ("none", "int8", "int4",
                                         "mx4", "fp8"):
            raise ValueError(f"quantize_weights must be one of none|int8|"
                             f"int4|mx4|fp8, got {self.quantize_weights!r}")
        if self.quantize_weights in ("int4", "mx4") and self.tp > 1:
            raise ValueError(
                f"{self.quantize_weights} packs row pairs along the "
                f"contraction axis that would straddle the tensor-parallel "
                f"shard boundary; use int8 or fp8 under tp > 1")
        return self

    def check_ported(self) -> "EngineConfig":
        """Raise for the options whose code is not ported yet."""
        not_yet = [
            (self.backend != "paged" or not self.chunked_prefill,
             "the dense backend and bucketed prefill: ROADMAP queue 1 item 6"),
            (self.temperature > 0, "temperature sampling: ROADMAP queue 1 "
                                   "item 6 (serving engine)"),
            (self.speculate_k > 0, "speculation: ROADMAP queue 1 item 9"),
            (self.tp > 1, "tensor parallelism: ROADMAP queue 1 item 12"),
        ]
        for cond, what in not_yet:
            if cond:
                raise NotImplementedError(f"not ported yet — {what}")
        return self


def resolve_page_size(engine_cfg: EngineConfig) -> int:
    """The page size the factory allocates with: the explicit value, else
    the layout granule (32 rows for int8 pools, 16 for bf16)."""
    if engine_cfg.page_size is not None:
        return engine_cfg.page_size
    if engine_cfg.kv_cache_dtype == "int8":
        return 32
    return 16


def build_engine(arch, engine_cfg: EngineConfig, *,
                 device: DeviceLike = None, seed: int = 0,
                 capture: bool = True):
    """The one engine factory: ``(arch, EngineConfig) -> ServingEngine``.

    ``arch`` is a registry id (``"qwen1.5-0.5b"``), a model config object
    (e.g. ``reduced(get_config(...))``), or a prebuilt ``Model`` (its
    parameters and runtime switches then win — e.g. weights bridged from
    the JAX package).  Otherwise the weights are a random init from
    ``seed`` made on ``device`` (the CUDA card unless ``device="cpu"``),
    quantized after the init as the JAX factory does: MX when
    ``quantize_weights`` is ``"mx4"`` or ``"fp8"``, absmax int8 or int4 in
    groups of ``quantize_group_size`` rows when it is ``"int8"`` or
    ``"int4"`` (those dequantize in the graph).  The engine's kernels
    launch with the configs ``serve.step.tuned_kernel_configs`` resolves
    from the tune cache at the engine's shapes
    (``serve_step.troop_configs``); an empty cache gives the defaults.
    The engine runs its steps as captured CUDA graphs; ``capture=False``
    steps eagerly (the counterpart of ``jax.disable_jit()``: a keyword,
    not an ``EngineConfig`` field, since that record mirrors the JAX
    one)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, RuntimeConfig, build_model
    from repro_torch.quant import quantize_params
    from repro_torch.serve.scheduler import ServingEngine
    from repro_torch.serve.step import tuned_kernel_configs

    engine_cfg.validate().check_ported()
    if hasattr(arch, "decode_step"):          # prebuilt Model
        model = arch
    else:
        cfg = get_config(arch) if isinstance(arch, str) else arch
        rt = RuntimeConfig(paged_kernel_decode=engine_cfg.kernel_decode,
                           quantize_weights=engine_cfg.quantize_weights,
                           kv_cache_dtype=engine_cfg.kv_cache_dtype)
        model = build_model(cfg, rt, device=device, seed=seed)
        q = engine_cfg.quantize_weights
        if q in ("mx4", "fp8"):
            model = Model(cfg, rt, quantize_params(model.params, fmt=q))
        elif q != "none":
            model = Model(cfg, rt, quantize_params(
                model.params, bits=8 if q == "int8" else 4,
                group_size=engine_cfg.quantize_group_size))
    # the decode-path kernels' tuned launch parameters, resolved once here
    # (as the JAX factory does); the engine's steps launch with them
    configs = tuned_kernel_configs(
        model.cfg, engine_cfg.slots, engine_cfg.cache_len,
        page_size=resolve_page_size(engine_cfg),
        num_pages=engine_cfg.num_pages, chunk_size=engine_cfg.chunk_size)
    return ServingEngine(model, engine_cfg, troop_configs=configs,
                         capture=capture)
