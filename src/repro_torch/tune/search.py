"""Roofline-guided config search: enumerate -> analytic prune -> measure.

The port's counterpart of the JAX package's ``repro/tune/search.py``.  The
paper's tuning loop, mechanized: a kernel is *done* when its runtime equals
the roofline bound, so candidates are scored as fraction-of-roofline

    fraction = t_roofline / t_measured,
    t_roofline = max(bytes / BW, flops / PEAK)

against the H100's published peaks (``core.roofline``; PEAK is the fp32
rate for a kernel whose first tensor argument is fp32, else the bf16
rate), and the search never times a config the analytic model already
ranks as dominated.  The analytic predictor is the JAX one, term for term:

  * stream/decoupling efficiency — for the paper's own kernels (dotp, axpy,
    gemv) the Spatz cycle model (``core.perfmodel``) simulates the mapped
    micro-architecture config; other kernels use the closed-form Fig. 5
    shape (single interface ~55%, decoupled ~96%, unscrambled conflicts cap
    one axis at half throughput);
  * per-step work amortization (unroll x block volume vs fixed per-step
    overhead — §IV-F);
  * layout alignment of the tile shape (§IV-D/E granules).

It reads ``streams``, ``unroll``, ``block_n``, ``block_k`` and
``scrambled_layout``; a kernel whose space holds other knobs (``gemv_warps``,
``adamw_streams``, ...) gets one prediction for all its candidates and is
ranked by measurement alone.  Pruning keeps the top-``keep`` predicted
candidates, so the predicted-best config is *never* discarded (tested).

``measure`` times the raw kernel on the card as device time: the calls
captured in a CUDA graph and replayed between CUDA events, after warm-up,
over copies of the inputs that together exceed twice the 50 MB L2 (so each
call reads its inputs from device memory, not from L2).  It always works
on copies, so a kernel that updates its arguments in place (``fused_adamw``)
never touches the caller's tensors.  On the CPU it times the plain version
(which the wrappers run there) with ``perf_counter``: a host number, useful
only to exercise the loop.
"""
from __future__ import annotations

import functools
import itertools
import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core import perfmodel
from repro_torch.core.roofline import HBM_BW, PEAK_FLOPS, PEAK_FLOPS_F32
from repro_torch.core.troop import LaunchConfig, sublane
from repro_torch.tune import cache as tcache
from repro_torch.tune import registry

# kernels with a micro-program in the Spatz cycle model
_SPATZ_KERNELS = ("dotp", "axpy", "gemv")
# the inputs of one timing are copied until the copies exceed twice the L2
_L2_BYTES = 50_000_000
_MAX_COPIES = 64
# calls per CUDA-graph replay
_INNER = 20


def roofline_bw() -> float:
    """Device memory roofline bytes/s; ``REPRO_TORCH_TUNE_BW`` overrides
    (e.g. a measured host bandwidth when tuning the plain versions on the
    CPU)."""
    return float(os.environ.get("REPRO_TORCH_TUNE_BW", HBM_BW))


def _peak_flops(args: Sequence[Any]) -> float:
    for a in args:
        if isinstance(a, torch.Tensor):
            return PEAK_FLOPS_F32 if a.dtype == torch.float32 else PEAK_FLOPS
    return PEAK_FLOPS


def roofline_time(spec: registry.KernelSpec, args: Sequence[Any]) -> float:
    return max(float(spec.bytes(*args)) / roofline_bw(),
               float(spec.flops(*args)) / _peak_flops(args))


# --------------------------------------------------------------------------
# candidate enumeration
# --------------------------------------------------------------------------
def enumerate_space(spec: registry.KernelSpec,
                    base: Optional[LaunchConfig] = None
                    ) -> List[LaunchConfig]:
    base = base if base is not None else spec.default
    knobs = list(spec.space.items())
    out: List[LaunchConfig] = []
    seen = set()
    for combo in itertools.product(*(vals for _, vals in knobs)):
        cfg = replace(base, **dict(zip((k for k, _ in knobs), combo)))
        try:
            cfg.validate()
        except ValueError:
            continue
        if cfg not in seen:
            seen.add(cfg)
            out.append(cfg)
    return out


# --------------------------------------------------------------------------
# analytic prediction
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=128)
def _spatz_util(kernel: str, streams: int, unroll: int,
                scrambled: bool) -> float:
    """FPU utilization of the mapped Spatz config (cycle-level sim)."""
    troop = streams == 2
    # unrolling/software-pipelining hides the scalar-core strip overhead
    sw = 0 if (troop and unroll >= 2) else max(14 // (streams * unroll), 0)
    cfg = perfmodel.SpatzConfig(
        f"tune_{kernel}_{streams}_{unroll}_{int(scrambled)}",
        mem_beats_per_cycle=2 if troop else 1,
        decoupled=troop, completion_chaining=troop, dynamic_priority=troop,
        scrambling=scrambled, log2_reduction=troop,
        shadow_depth=3, sw_strip_overhead=sw)
    return perfmodel.utilization(kernel, cfg, vl=2048).fpu_util


def _stream_term(spec: registry.KernelSpec, cfg: LaunchConfig) -> float:
    if spec.name in _SPATZ_KERNELS:
        return _spatz_util(spec.name, cfg.streams, cfg.unroll,
                           cfg.scrambled_layout)
    # closed-form Fig. 5 shape for kernels without a Spatz micro-program
    if cfg.streams == 2:
        return 0.96 if cfg.scrambled_layout else 0.72
    return 0.55


def _amortization_term(cfg: LaunchConfig) -> float:
    # fixed per-step cost vs per-step work volume (§IV-F unrolling)
    per_step = float(cfg.block_n) * float(cfg.block_k) * float(cfg.unroll)
    return per_step / (per_step + 8192.0)


def _alignment_term(cfg: LaunchConfig, args: Sequence[Any]) -> float:
    dtype = None
    dims: List[int] = []
    for a in args:
        if getattr(a, "shape", None) is not None and len(a.shape):
            if dtype is None:
                dtype = a.dtype
            dims.append(int(a.shape[-1]))
    score = 1.0
    if cfg.block_n % 128 or cfg.block_k % 128:
        score *= 0.9                  # off-lane tile edge (§IV-D)
    if dtype is not None and cfg.block_n % sublane(dtype):
        score *= 0.95
    # blocks larger than any streamed extent get clamped inside the kernel:
    # harmless but no extra amortization — mild penalty keeps ranks stable
    if dims and cfg.block_k > max(dims) * 4:
        score *= 0.98
    return score


def predict_fraction(spec: registry.KernelSpec, cfg: LaunchConfig,
                     *args) -> float:
    """Analytic fraction-of-roofline for (kernel, config, shapes)."""
    return (_stream_term(spec, cfg) * _amortization_term(cfg)
            * _alignment_term(cfg, args))


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------
@dataclass
class Candidate:
    cfg: LaunchConfig
    predicted: float
    measured_s: Optional[float] = None
    achieved: Optional[float] = None      # fraction-of-roofline, measured
    error: Optional[str] = None


def prune(candidates: List[Candidate], keep: int) -> List[Candidate]:
    """Top-``keep`` by analytic prediction; the predicted-best candidate is
    first and therefore always survives."""
    ranked = sorted(candidates, key=lambda c: -c.predicted)
    return ranked[:max(int(keep), 1)]


def _copies(args: Sequence[Any]) -> List[tuple]:
    """Copies of the tensor arguments (other arguments shared) that
    together exceed twice the L2, at least one."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = max(1, min(_MAX_COPIES, -(-2 * _L2_BYTES // max(nbytes, 1))))
    return [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args) for _ in range(n)]


def _on_card(args: Sequence[Any]) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for a in args)


def measure(spec: registry.KernelSpec, cfg: LaunchConfig,
            args: Sequence[Any], kwargs: Optional[Dict[str, Any]] = None,
            iters: int = 2) -> float:
    """Best-of-``iters`` seconds per call of the raw kernel (after warm-up),
    on copies of ``args``: device time on the card, host time on the CPU."""
    kwargs = kwargs or {}
    sets = _copies(args)
    calls = [functools.partial(spec.fn, *s, cfg=cfg, **kwargs) for s in sets]
    if not _on_card(args):
        calls[0]()                                    # warm
        best = float("inf")
        for i in range(max(iters, 1)):
            t0 = time.perf_counter()
            calls[i % len(calls)]()
            best = min(best, time.perf_counter() - t0)
        return best
    for c in calls[:3]:
        c()                                           # build + warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(_INNER):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(iters, 1)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) * 1e-3 / _INNER)
    return best


# --------------------------------------------------------------------------
# the tune entry point
# --------------------------------------------------------------------------
@dataclass
class TuneResult:
    name: str
    key: str
    best: LaunchConfig
    fraction: float                    # measured fraction-of-roofline
    predicted: float
    measured_s: Optional[float]
    roofline_s: float
    from_cache: bool = False
    timings_run: int = 0               # measure() invocations this call
    candidates: List[Candidate] = field(default_factory=list)

    def as_entry(self) -> Dict[str, Any]:
        return {
            "kernel": self.name,
            "config": tcache.config_to_dict(self.best),
            "fraction_of_roofline": self.fraction,
            "predicted_fraction": self.predicted,
            "measured_s": self.measured_s,
            "roofline_s": self.roofline_s,
            "tuned_at": time.time(),
        }


def tune(name: str, *args, kernel_kwargs: Optional[Dict[str, Any]] = None,
         keep: int = 4, iters: int = 2,
         cache: Optional[tcache.TuneCache] = None,
         force: bool = False, save: bool = True) -> TuneResult:
    """Tune one (kernel, shape, dtype) point end to end.

    Cached results short-circuit (no re-timing) unless ``force=True``.
    ``keep`` survivors of the analytic prune are timed; the winner by
    measured fraction-of-roofline is persisted.  A candidate the kernel
    refuses (``ValueError`` from its wrapper, or a launch the card refuses)
    is recorded as failed.
    """
    spec = registry.get(name)
    c = cache if cache is not None else tcache.default_cache()
    key = spec.key(*args, kwargs=kernel_kwargs)

    if not force:
        entry = c.get(key)
        if entry is not None and "config" in entry:
            return TuneResult(
                name=name, key=key,
                best=tcache.config_from_dict(entry["config"]),
                fraction=entry.get("fraction_of_roofline", 0.0),
                predicted=entry.get("predicted_fraction", 0.0),
                measured_s=entry.get("measured_s"),
                roofline_s=entry.get("roofline_s",
                                     roofline_time(spec, args)),
                from_cache=True, timings_run=0)

    roof = roofline_time(spec, args)
    cands = [Candidate(cfg, predict_fraction(spec, cfg, *args))
             for cfg in enumerate_space(spec)]
    survivors = prune(cands, keep)

    timings = 0
    for cand in survivors:
        try:
            cand.measured_s = measure(spec, cand.cfg, args, kernel_kwargs,
                                      iters=iters)
            cand.achieved = roof / max(cand.measured_s, 1e-12)
            timings += 1
        except (ValueError, RuntimeError) as e:   # infeasible combination
            cand.error = f"{type(e).__name__}: {e}"

    ok = [cand for cand in survivors if cand.measured_s is not None]
    if ok:
        winner = max(ok, key=lambda cand: cand.achieved)
    else:
        winner = survivors[0]               # all failed: keep predicted-best
    res = TuneResult(
        name=name, key=key, best=winner.cfg,
        fraction=winner.achieved or 0.0, predicted=winner.predicted,
        measured_s=winner.measured_s, roofline_s=roof,
        from_cache=False, timings_run=timings, candidates=cands)
    if ok:
        c.put(key, res.as_entry())
        if save:
            c.save()
    return res
