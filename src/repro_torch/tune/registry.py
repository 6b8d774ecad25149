"""Kernel registry — the tuning subsystem's source of truth.

The port's counterpart of the JAX package's ``repro/tune/registry.py``.
Every kernel of the JAX registry is registered here under the same name
with ``@troop_kernel(name, flops=..., bytes=..., streamed=...)``, the same
cost models, declaring:

  * a roofline cost model (``flops`` / ``bytes`` callables over the call's
    positional arguments — only ``.shape``/``.dtype`` are read, so tensors
    on the ``meta`` device work),
  * its tunable ``LaunchConfig`` space (field name -> candidate values),
  * the name of its oracle in ``repro_torch.kernels.ref`` (resolved lazily),
  * an example-args factory (``example(small, device)``) used by
    ``repro_torch.tune.report``, ``chip_smoke.py`` and the tests.

The decorator returns a *dispatching* wrapper: called with an explicit
``LaunchConfig`` (positionally or as ``cfg=``) it behaves exactly like the
raw kernel; called without one it resolves the best-known config through
``repro_torch.tune.cache.get_tuned`` (the persistent tune cache, falling
back to the spec's default).  The raw kernel stays reachable as ``spec.fn``
so the search never recurses through dispatch.  The model path calls the
raw kernels (``repro_torch.kernels.ops``) with the configs its engine
resolved once at build, and so makes no lookup per launch.

``PROFILER`` is the seam of a dispatch profiler (ROADMAP item 10, not
ported yet): when one is installed every dispatch routes through
``profiler.record(spec, fn, args, kwargs)``; with none the wrapper pays a
single module-attribute check.
"""
from __future__ import annotations

import functools
import importlib
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.troop import DEFAULT, LaunchConfig

# Knob -> candidate values swept when a kernel does not restrict its space
# (the JAX package's DEFAULT_SPACE: streams x unroll x block_n x block_k x
# layout — the paper's §IV axes).
DEFAULT_SPACE: Mapping[str, Tuple] = {
    "streams": (1, 2),
    "unroll": (1, 2),
    "block_n": (128, 256),
    "block_k": (256, 512),
    "scrambled_layout": (False, True),
}

# torch dtype -> the JAX spelling of the cache key (``bf16``, ``f32``, ...)
_SHORT = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
          torch.float64: "f64", torch.int8: "i8", torch.int16: "i16",
          torch.int32: "i32", torch.int64: "i64", torch.uint8: "ui8",
          torch.bool: "bool", torch.float8_e4m3fn: "f8_e4m3fn",
          torch.float8_e5m2: "f8_e5m2"}


def itemsize(a) -> int:
    """Bytes per element; works on any tensor, ``meta`` ones included."""
    return torch.empty((), dtype=a.dtype, device="meta").element_size()


def numel(a) -> int:
    """Element count; works on any tensor, ``meta`` ones included."""
    return int(math.prod(a.shape))


def arg_signature(args: Sequence[Any]) -> str:
    """``f32[128,512],bf16[512]`` — shape/dtype key of the tensor args, in
    the JAX package's spelling.  Non-tensor positional args (variant flags,
    scalar coefficients) key by ``repr`` so different kernel variants never
    share a cache entry."""
    parts = []
    for a in args:
        shape = getattr(a, "shape", None)
        dtype = getattr(a, "dtype", None)
        if shape is None or dtype is None:
            if a is not None and not isinstance(a, LaunchConfig):
                parts.append(repr(a)[:32])
            continue
        name = _SHORT.get(dtype, str(dtype).replace("torch.", ""))
        parts.append(f"{name}[{','.join(str(int(d)) for d in shape)}]")
    return ",".join(parts)


@functools.lru_cache(maxsize=None)
def default_backend() -> str:
    """``cuda:<device name>`` on a host with a card, else ``cpu``: the
    backend part of a cache key (tuned configs of one card never serve
    another)."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name()}"
    return "cpu"


def cache_key(name: str, args: Sequence[Any], backend: Optional[str] = None,
              variant: Optional[Mapping[str, Any]] = None) -> str:
    if backend is None:
        backend = default_backend()
    var = "".join(f"|{k}={repr(variant[k])[:32]}"
                  for k in sorted(variant)) if variant else ""
    return f"{name}|{arg_signature(args)}|{backend}{var}"


def operand_bytes(operands) -> float:
    """Total bytes of a streamed-operand list (tensors, ``meta`` included).

    The audit invariant behind every ``bytes=`` cost model: modeled traffic
    must equal the sum of the operands the kernel actually streams —
    including scale tensors for quantized layouts (tested registry-wide)."""
    return float(sum(numel(o) * itemsize(o) for o in operands))


def meta(shape, dtype) -> torch.Tensor:
    """A shape/dtype placeholder (the counterpart of
    ``jax.ShapeDtypeStruct``) for cost models and ``streamed`` lists."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def seeded(seed: int, shape, dtype=torch.bfloat16, device: DeviceLike = None,
           scale: float = 1.0) -> torch.Tensor:
    """A standard normal tensor (times ``scale``) drawn with numpy from
    ``seed``, in ``dtype`` on ``device`` (the card unless the caller asks
    for the CPU): the inputs of the example factories."""
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(resolve_device(device),
                                                     dtype)


@dataclass(frozen=True)
class KernelSpec:
    name: str
    fn: Callable                      # raw kernel: fn(*args, cfg=..., **kw)
    flops: Callable                   # (*args) -> float (useful FLOPs)
    bytes: Callable                   # (*args) -> float (min HBM traffic)
    space: Mapping[str, Tuple] = field(default_factory=lambda: DEFAULT_SPACE)
    ref: Optional[str] = None         # oracle name in repro_torch.kernels.ref
    example: Optional[Callable] = None  # (small=True, device=...) -> (args,
    #   kwargs)
    default: LaunchConfig = DEFAULT
    key_kwargs: Tuple[str, ...] = ()  # kwargs that select a kernel variant
    streamed: Optional[Callable] = None  # (*args) -> streamed-operand list
    #   (each with .shape/.dtype; sum of nbytes must equal bytes(*args) —
    #   scalar args are excluded by convention)

    def reference(self) -> Optional[Callable]:
        if self.ref is None:
            return None
        mod = importlib.import_module("repro_torch.kernels.ref")
        return getattr(mod, self.ref)

    def heuristic(self, *args) -> LaunchConfig:
        """Untuned fallback: the spec default (``LaunchConfig()``, the
        launch parameters each kernel ran with before it was tuned)."""
        return self.default

    def key(self, *args, backend: Optional[str] = None,
            kwargs: Optional[Mapping[str, Any]] = None) -> str:
        variant = {k: kwargs[k] for k in self.key_kwargs
                   if kwargs and k in kwargs}
        return cache_key(self.name, args, backend, variant)


REGISTRY: Dict[str, KernelSpec] = {}

# Installed dispatch profiler or None.  The dispatch wrapper below reads
# this module global once per call — the disabled path costs exactly one
# attr check and nothing else.
PROFILER: Optional[Any] = None


def install_profiler(profiler) -> None:
    """Route every registry dispatch through ``profiler.record``."""
    global PROFILER
    PROFILER = profiler


def uninstall_profiler(profiler=None) -> None:
    """Remove the installed profiler (no-op if ``profiler`` isn't it)."""
    global PROFILER
    if profiler is None or PROFILER is profiler:
        PROFILER = None


def get(name: str) -> KernelSpec:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(REGISTRY)}"
            " (import repro_torch.kernels to populate the registry)")
    return REGISTRY[name]


def names() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))


def troop_kernel(name: str, *, flops: Callable, bytes: Callable,
                 space: Optional[Mapping[str, Tuple]] = None,
                 ref: Optional[str] = None,
                 example: Optional[Callable] = None,
                 default: Optional[LaunchConfig] = None,
                 key_kwargs: Tuple[str, ...] = (),
                 streamed: Optional[Callable] = None):
    """Register a kernel and return its registry-dispatching wrapper."""
    def deco(fn: Callable) -> Callable:
        spec = KernelSpec(
            name=name, fn=fn, flops=flops, bytes=bytes,
            space=dict(space) if space is not None else dict(DEFAULT_SPACE),
            ref=ref, example=example,
            default=default if default is not None else DEFAULT,
            key_kwargs=tuple(key_kwargs), streamed=streamed)
        REGISTRY[name] = spec

        @functools.wraps(fn)
        def dispatch(*args, **kwargs):
            prof = PROFILER            # one module-attr load when disabled
            if prof is not None:
                return prof.record(spec, fn, args, kwargs)
            if kwargs.get("cfg") is not None or \
                    any(isinstance(a, LaunchConfig) for a in args):
                return fn(*args, **kwargs)
            kwargs.pop("cfg", None)       # cfg=None -> dispatch
            from repro_torch.tune.cache import get_tuned
            return fn(*args, cfg=get_tuned(name, *args, variant_kwargs=kwargs),
                      **kwargs)

        dispatch.spec = spec
        return dispatch
    return deco
