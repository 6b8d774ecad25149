"""repro_torch.tune — roofline-guided autotuning + kernel dispatch.

The port's counterpart of ``repro.tune``, with the same names.  It closes
the paper's loop (a kernel is done only at the roofline) in four pieces:

  registry  — ``@troop_kernel`` decorator; every kernel declares its
              roofline cost model and tunable LaunchConfig space
  search    — enumerate candidates, prune analytically (Spatz cycle model /
              closed-form roofline terms), time survivors on the card,
              score each as fraction-of-roofline
  cache     — JSON-persistent tuned configs keyed kernel|shapes|backend,
              with an in-process LRU (``REPRO_TORCH_TUNE_CACHE`` overrides
              the path)
  dispatch  — ``get_tuned(name, *args)`` picks the cached best config;
              kernels called without an explicit LaunchConfig through
              ``repro_torch.kernels`` route through it automatically

Quickstart::

    from repro_torch import tune
    import repro_torch.kernels as K           # populates the registry
    res = tune.tune("gemv", w, x)             # prune -> time -> cache
    cfg = tune.get_tuned("gemv", w, x)        # cached best (or default)
    y = K.gemv(w, x)                          # launches with that config
"""
from repro_torch.tune.cache import (TuneCache, config_from_dict,
                                    config_to_dict, default_cache, get_tuned,
                                    resolve_path)
from repro_torch.tune.registry import (DEFAULT_SPACE, REGISTRY, KernelSpec,
                                       cache_key, names, troop_kernel)
from repro_torch.tune.search import (Candidate, TuneResult, enumerate_space,
                                     measure, predict_fraction, prune,
                                     roofline_time, tune)

__all__ = [
    "DEFAULT_SPACE", "REGISTRY", "KernelSpec", "cache_key", "names",
    "troop_kernel",
    "TuneCache", "config_from_dict", "config_to_dict", "default_cache",
    "get_tuned", "resolve_path",
    "Candidate", "TuneResult", "enumerate_space", "measure",
    "predict_fraction", "prune", "roofline_time", "tune",
]
