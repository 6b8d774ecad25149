"""Shared cases of the bucketed-engine tests against the JAX engine
(``test_torch_bucketed_engine.py``, ``test_torch_bucketed_archs.py``): the
reduced archs at their group sizes in fp32, one seeded mixed-length trace,
the backends, and the JAX engine's streams and metrics on them.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import RuntimeConfig as JaxRuntimeConfig
from repro.models import build_model as jax_build_model
from repro.models import modules as JM
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import build_engine as jax_build_engine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.models import RuntimeConfig, build_model
from repro_torch.models import modules as TM
from repro_torch.serve import (EngineConfig, Request, bucket_length,
                               build_engine)

#: the head counts each reduced arch keeps: its group size (as
#: test_torch_archs.py)
HEADS = {"qwen1.5-0.5b": {}, "qwen2-moe-a2.7b": {},
         "glm4-9b": dict(num_heads=16, num_kv_heads=1),
         "qwen3-14b": dict(num_heads=10, num_kv_heads=2),
         "qwen1.5-32b": dict(num_heads=4, num_kv_heads=4)}
ENGINE = dict(slots=3, cache_len=96, min_bucket=4)
#: backend name: (EngineConfig fields, the model's KV storage).  "paged
#: int8" prefills int8 caches whose codes the pool takes verbatim; "paged
#: int8 at admit" prefills bf16 caches that the pool quantizes at admission
BACKENDS = {"dense": ({}, ""),
            "dense int8": (dict(kv_cache_dtype="int8"), "int8"),
            "paged": (dict(backend="paged"), ""),
            "paged int8": (dict(backend="paged", kv_cache_dtype="int8"),
                           "int8"),
            "paged int8 at admit": (dict(backend="paged",
                                         kv_cache_dtype="int8"), "")}
SAME = ("engine_cycles", "decode_steps", "tokens_generated",
        "prefill_calls", "prefill_traces", "kv_bytes_streamed", "backend")


def trace():
    """Seven prompts of 3..39 tokens (buckets of 4 to 64): the engine's
    three slots admit groups of up to three, the last group one request
    padded with two rows."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, 500, int(n)).astype(np.int32)
            for n in rng.integers(3, 40, 7)]


def jax_pair(arch, kv):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch),
                                           **HEADS[arch]), dtype="float32")
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat="none",
                                                kv_cache_dtype=kv))
    return jm, JM.unbox(jm.init(jax.random.PRNGKey(0)))


def bridged(arch, jp):
    """The JAX params ``jp`` as the port's fp32 params."""
    tcfg = dataclasses.replace(reduced(get_config(arch), **HEADS[arch]),
                               dtype="float32")
    return params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu", dtype=torch.float32)


def port_model(arch, kv, params):
    tcfg = dataclasses.replace(reduced(get_config(arch), **HEADS[arch]),
                               dtype="float32")
    return build_model(tcfg, RuntimeConfig(kv_cache_dtype=kv), params=params,
                       device="cpu")


def serve(eng, prompts=None, max_new=6, rid0=0):
    reqs = [Request(rid=rid0 + i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(trace() if prompts is None else prompts)]
    for r in reqs:
        eng.submit(r)
    finished = eng.run_until_drained()
    assert len(finished) == len(reqs) and all(r.done for r in reqs)
    return [r.out for r in reqs]


def serve_jax(arch, backends, tune_cache):
    """(per backend: the JAX engine's streams and metrics; the bridged port
    weights of the arch — the seed-0 init, the same for every backend)."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TUNE_CACHE", str(tune_cache))
    try:
        for name in backends:
            over, kv = BACKENDS[name]
            jm, jp = jax_pair(arch, kv)
            eng = jax_build_engine(jm, JaxEngineConfig(**ENGINE, **over),
                                   params=jp)
            reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(trace())]
            for r in reqs:
                eng.submit(r)
            assert len(eng.run_until_drained()) == len(reqs)
            out[name] = ([r.out for r in reqs], eng.metrics())
    finally:
        mp.undo()
    return out, bridged(arch, jp)


def check_engine(arch, backend, routed, jax_out, tp):
    """The port's bucketed engine on ``backend``: the JAX engine's greedy
    streams and counters, one prefill binding a bucket used and one decode
    binding, and (paged) every page back in the pool after drain."""
    want, jm = jax_out[backend]
    over, kv = BACKENDS[backend]
    eng = build_engine(port_model(arch, kv, tp),
                       EngineConfig(**ENGINE, **over))
    with TM.kernel_routing(routed):
        got = serve(eng)
    assert got == want
    m = eng.metrics()
    for k in SAME:
        assert m[k] == jm[k], k
    caps = eng.captures
    assert caps["decode"] == 1 and set(caps["prefill"].values()) == {1}
    assert set(caps["prefill"]) <= {bucket_length(len(p), 4, 96)
                                    for p in trace()}
    if "paged" in backend:
        be = eng.backend
        assert be.allocator.num_free == be.spec.num_pages - 1
        assert m["kv_dtype"] == jm["kv_dtype"] and \
            m["page_size"] == jm["page_size"]
    return eng
