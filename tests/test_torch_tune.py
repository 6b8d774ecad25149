"""The port's tune subsystem (``repro_torch.tune``) against the JAX one.

Mirrors ``tests/test_tune.py`` case for case — registry round-trip,
analytic pruning, cache persistence across a save/load cycle, dispatch
fallback and the no-re-timing guarantee on a cache hit — on the CPU, where
``measure`` times the plain versions.  Beside that: the registry holds the
JAX registry's names, every shared cost model gives the JAX model's
numbers on the same shapes (JAX ``ShapeDtypeStruct`` against torch
``meta`` tensors), the Spatz predictor gives the JAX predictor's numbers,
an engine resolves its configs once when it is built and its steps make no
cache lookup, and every name, the full-sequence attention and the two
scans included, tunes and is read back from the cache.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels  # noqa: E402,F401  (populates the JAX registry)
import repro_torch.kernels as K  # noqa: E402  (populates the port's)
from repro import tune as jtune  # noqa: E402
from repro.core.troop import TroopConfig  # noqa: E402
from repro.tune import search as jsearch  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.core.troop import (BASELINE, DEFAULT, TROOP,  # noqa: E402
                                    LaunchConfig)
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.tune import registry, search  # noqa: E402

# the registry names ported last: the full-sequence attention and the scans
LAST = ("flash_attention", "rwkv6", "mamba_scan")
# the JAX TroopConfig knobs both predictors read
KNOBS = ("streams", "unroll", "block_n", "block_k", "scrambled_layout")


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """Point the default cache at a fresh file (per-path singleton, so no
    global reset is needed)."""
    path = str(tmp_path / "tune_cache.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", path)
    return path


def as_meta(a):
    """A JAX array / ShapeDtypeStruct -> a torch meta tensor of its shape
    and dtype (other arguments pass through)."""
    if not hasattr(a, "shape"):
        return a
    return torch.empty(tuple(a.shape), device="meta",
                       dtype=getattr(torch, jnp.dtype(a.dtype).name))


def port_config(cfg: TroopConfig) -> LaunchConfig:
    return dataclasses.replace(DEFAULT, **{k: getattr(cfg, k) for k in KNOBS})


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
def test_registry_names_equal_the_jax_registry():
    assert tune.names() == jtune.names()
    assert len(tune.names()) == 19   # each a hand-written CUDA kernel


def test_registry_has_every_kernel():
    for name in tune.names():
        spec = tune.REGISTRY[name]
        assert callable(spec.fn)
        assert callable(spec.flops) and callable(spec.bytes)
        assert spec.example is not None, name
        assert spec.space or name.startswith(("mx_", "grouped_")), name
        assert set(spec.space) <= {f.name for f in
                                   dataclasses.fields(LaunchConfig)}, name


@pytest.mark.parametrize("name", jtune.names())
def test_cost_models_equal_jax_on_the_same_shapes(name):
    """flops and bytes of every shared name, at the JAX example's shapes
    (both sizes): the quantized kernels' scale traffic included."""
    jspec, tspec = jtune.REGISTRY[name], tune.REGISTRY[name]
    for small in (True, False):
        args, _ = jspec.example(small=small)
        structs = [jax.ShapeDtypeStruct(a.shape, a.dtype)
                   if hasattr(a, "shape") else a for a in args]
        metas = [as_meta(a) for a in args]
        assert tspec.flops(*metas) == pytest.approx(jspec.flops(*structs))
        assert tspec.bytes(*metas) == pytest.approx(jspec.bytes(*structs))
        assert tune.cache_key(name, metas, backend="b") == \
            jtune.cache_key(name, structs, backend="b")


def test_registry_cost_models_accept_meta_tensors():
    for name in tune.names():
        spec = tune.REGISTRY[name]
        args, _ = spec.example(small=True, device="cpu")
        metas = [torch.empty(a.shape, dtype=a.dtype, device="meta")
                 if isinstance(a, torch.Tensor) else a for a in args]
        assert spec.flops(*metas) > 0, name
        assert spec.bytes(*metas) > 0, name
        assert spec.key(*metas) == spec.key(*args), name


def test_registry_bytes_models_match_streamed_operands():
    """Registry-wide audit: every kernel's modeled traffic equals the sum of
    nbytes of its declared streamed operands."""
    for name in tune.names():
        spec = tune.REGISTRY[name]
        assert spec.streamed is not None, name
        args, _ = spec.example(small=True, device="cpu")
        want = registry.operand_bytes(spec.streamed(*args))
        assert spec.bytes(*args) == pytest.approx(want), name


def test_quantized_bytes_models_count_scale_traffic():
    spec8 = tune.REGISTRY["decode_attention_int8"]
    (q, k8, ks, v8, vs, ln), _ = spec8.example(small=True, device="cpu")
    b8 = spec8.bytes(q, k8, ks, v8, vs, ln)
    values_only = 2 * k8.numel() + q.numel() * 2 * 2
    assert b8 == values_only + 2 * ks.numel() * 2     # + k/v scale streams
    bf = tune.REGISTRY["decode_attention"]
    (qb, kb, vb, lnb), _ = bf.example(small=True, device="cpu")
    assert b8 < 0.6 * bf.bytes(qb, kb, vb, lnb)


def test_arg_signature_uses_the_jax_spelling():
    w = torch.empty((2048, 4096), dtype=torch.bfloat16, device="meta")
    ids = torch.empty((4,), dtype=torch.int32, device="meta")
    codes = torch.empty((8,), dtype=torch.uint8, device="meta")
    assert registry.arg_signature([w, ids, codes, 1.5, None, DEFAULT]) == \
        "bf16[2048,4096],i32[4],ui8[8],1.5"


def test_registry_dispatch_matches_reference(tmp_cache):
    """The public entry point WITHOUT a config routes through get_tuned and
    still computes the right answer."""
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.standard_normal((128, 512)),
                        dtype=torch.float32).bfloat16()
    x = torch.as_tensor(rng.standard_normal(512), dtype=torch.float32
                        ).bfloat16()
    misses = tune.default_cache().misses
    torch.testing.assert_close(K.gemv(w, x), R.gemv(w, x))
    assert tune.default_cache().misses == misses + 1
    xs = torch.as_tensor(rng.standard_normal((8, 256)),
                         dtype=torch.float32).bfloat16()
    s = torch.as_tensor(rng.standard_normal(256), dtype=torch.float32)
    torch.testing.assert_close(K.rmsnorm(xs, s), R.rmsnorm(xs, s))


def test_explicit_config_bypasses_dispatch(tmp_cache):
    """A positional/keyword LaunchConfig takes the raw kernel path (the
    same numerics as spec.fn) and makes no cache lookup."""
    spec = tune.REGISTRY["dotp"]
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(4096), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal(4096), dtype=torch.float32)
    cfg = LaunchConfig(streams=1, unroll=1)
    cache = tune.default_cache()
    before = cache.hits + cache.misses
    assert torch.equal(K.dotp(x, y, cfg), spec.fn(x, y, cfg=cfg))
    assert torch.equal(K.dotp(x, y, cfg=cfg), spec.fn(x, y, cfg=cfg))
    assert cache.hits + cache.misses == before


# --------------------------------------------------------------------------
# search: enumeration + analytic prune
# --------------------------------------------------------------------------
def test_enumerate_space_validates_configs():
    for name in tune.names():
        spec = tune.REGISTRY[name]
        cfgs = tune.enumerate_space(spec)
        assert cfgs, name
        for cfg in cfgs:
            cfg.validate()
        assert len(set(cfgs)) == len(cfgs), f"{name}: duplicate candidates"
    with pytest.raises(ValueError):
        LaunchConfig(unroll=3).validate()


@pytest.mark.parametrize("kernel", ["dotp", "axpy", "gemv"])
def test_spatz_util_equals_jax_over_the_knob_grid(kernel):
    for streams in (1, 2):
        for unroll in (1, 2, 4):
            for scrambled in (False, True):
                assert search._spatz_util(kernel, streams, unroll,
                                          scrambled) == \
                    jsearch._spatz_util(kernel, streams, unroll, scrambled)


@pytest.mark.parametrize("name", ["dotp", "axpy", "decode_attention"])
def test_predictor_ranks_as_the_jax_one(name):
    """The three kernels that take the JAX knobs: the same candidates and
    the same predicted fraction for each, at the same shapes."""
    jspec, tspec = jtune.REGISTRY[name], tune.REGISTRY[name]
    args, _ = jspec.example(small=True)
    structs = [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in args
               if hasattr(a, "shape")]
    metas = [as_meta(a) for a in structs]
    jcands = jtune.enumerate_space(jspec)
    tcands = tune.enumerate_space(tspec)
    assert [port_config(c) for c in jcands] == tcands
    for jc, tc in zip(jcands, tcands):
        assert tune.predict_fraction(tspec, tc, *metas) == pytest.approx(
            jtune.predict_fraction(jspec, jc, *structs), rel=1e-12)


@pytest.mark.parametrize("name", ["gemv", "dotp", "decode_attention"])
@pytest.mark.parametrize("keep", [1, 2, 4])
def test_prune_never_discards_predicted_best(name, keep):
    spec = tune.REGISTRY[name]
    args, _ = spec.example(small=True, device="cpu")
    metas = [torch.empty(a.shape, dtype=a.dtype, device="meta")
             for a in args if isinstance(a, torch.Tensor)]
    cands = [tune.Candidate(cfg, tune.predict_fraction(spec, cfg, *metas))
             for cfg in tune.enumerate_space(spec)]
    best = max(cands, key=lambda c: c.predicted)
    survivors = tune.prune(cands, keep)
    assert len(survivors) == min(keep, len(cands))
    assert best.cfg in [s.cfg for s in survivors]


def test_predictor_prefers_troop_mechanisms():
    """Decoupled streams beat the single interface on the paper's
    memory-bound kernels (the JAX presets on the port's knobs)."""
    for name in ("gemv", "dotp", "axpy"):
        spec = tune.REGISTRY[name]
        args, _ = spec.example(small=True, device="cpu")
        lo = tune.predict_fraction(spec, BASELINE, *args)
        hi = tune.predict_fraction(spec, TROOP, *args)
        assert hi > lo, name


# --------------------------------------------------------------------------
# cache + end-to-end tune -> dispatch
# --------------------------------------------------------------------------
def test_get_tuned_falls_back_on_miss(tmp_cache):
    spec = tune.REGISTRY["gemv"]
    w = torch.empty((64, 256), dtype=torch.bfloat16, device="meta")
    x = torch.empty((256,), dtype=torch.bfloat16, device="meta")
    cfg = tune.get_tuned("gemv", w, x)
    assert cfg == spec.heuristic(w, x) == DEFAULT
    assert tune.default_cache().misses >= 1


@pytest.mark.parametrize("name", tune.names())
def test_get_tuned_answers_every_name(tmp_cache, name):
    args, _ = tune.REGISTRY[name].example(small=True, device="cpu")
    assert isinstance(tune.get_tuned(name, *args), LaunchConfig)


def test_tune_cache_roundtrip_and_no_retiming(tmp_cache):
    spec = tune.REGISTRY["rmsnorm"]
    args, kw = spec.example(small=True, device="cpu")
    res = tune.tune("rmsnorm", *args, kernel_kwargs=kw, keep=2, iters=1)
    assert not res.from_cache and res.timings_run >= 1
    assert res.measured_s is not None and res.fraction > 0

    # second call: resolved from cache, zero timing invocations
    res2 = tune.tune("rmsnorm", *args, kernel_kwargs=kw, keep=2, iters=1)
    assert res2.from_cache and res2.timings_run == 0
    assert res2.best == res.best

    # persisted: a brand-new cache instance reads the same best config
    assert os.path.exists(tmp_cache)
    fresh = tune.TuneCache(tmp_cache)
    assert len(fresh) == 1
    assert tune.get_tuned("rmsnorm", *args, cache=fresh) == res.best

    # dispatch consumes it (shape-only lookup)
    metas = [torch.empty(a.shape, dtype=a.dtype, device="meta")
             for a in args]
    assert tune.get_tuned("rmsnorm", *metas) == res.best


def test_cache_file_is_json_keyed_by_kernel_shape_backend(tmp_cache):
    spec = tune.REGISTRY["rmsnorm"]
    args, kw = spec.example(small=True, device="cpu")
    tune.tune("rmsnorm", *args, kernel_kwargs=kw, keep=1, iters=1)
    with open(tmp_cache) as f:
        data = json.load(f)
    (key,) = data.keys()
    assert key == "rmsnorm|bf16[8,256],f32[256]|cpu"
    assert "config" in data[key] and "fraction_of_roofline" in data[key]


def test_cache_tolerates_corrupt_file(tmp_path):
    p = tmp_path / "broken.json"
    p.write_text("{not json")
    c = tune.TuneCache(str(p))
    assert len(c) == 0
    c.put("k", {"config": tune.config_to_dict(LaunchConfig())})
    c.save()
    assert len(tune.TuneCache(str(p))) == 1


def test_cache_lru_eviction_keeps_disk_contents(tmp_path):
    c = tune.TuneCache(str(tmp_path / "c.json"), capacity=2)
    for i in range(5):
        c.put(f"k{i}", {"config": tune.config_to_dict(LaunchConfig())})
    assert len(c._lru) == 2            # hot view bounded
    assert len(c) == 5                 # disk dict complete
    assert c.get("k0") is not None     # evicted from LRU, still served


def test_config_from_dict_tolerates_unknown_fields():
    d = {**tune.config_to_dict(LaunchConfig(gemv_warps=16)), "retired": 3}
    assert tune.config_from_dict(d) == LaunchConfig(gemv_warps=16)


@pytest.mark.parametrize("name", LAST)
def test_tuning_a_last_ported_name_reads_back_from_the_cache(tmp_cache,
                                                             name):
    """Each of the last three names tunes on the CPU (the plain versions
    timed), persists its winner, and a second call reads it back with no
    timing; the dispatching entry point then launches that winner."""
    args, kw = tune.REGISTRY[name].example(small=True, device="cpu")
    first = tune.tune(name, *args, kernel_kwargs=kw, keep=2, iters=1)
    assert not first.from_cache and first.timings_run == 2
    assert first.fraction > 0 and len(tune.default_cache()) == 1
    again = tune.tune(name, *args, kernel_kwargs=kw)
    assert again.from_cache and again.timings_run == 0
    assert again.best == first.best
    assert tune.get_tuned(name, *args, variant_kwargs=kw) == first.best


def test_measure_never_touches_the_callers_tensors(tmp_cache):
    """fused_adamw updates its arguments in place: the tuner times it on
    copies."""
    spec = tune.REGISTRY["fused_adamw"]
    args, kw = spec.example(small=True, device="cpu")
    before = [a.clone() for a in args]
    res = tune.tune("fused_adamw", *args, kernel_kwargs=kw, keep=2, iters=2)
    assert res.timings_run == 2
    assert all(torch.equal(a, b) for a, b in zip(args, before))


def test_report_tunes_then_reads_the_cache(tmp_cache, tmp_path, capsys):
    from repro_torch.tune import report
    out = tmp_path / "tune.json"
    argv = ["--fast", "--device", "cpu", "--kernels", "dotp,axpy,gemv",
            "--out", str(out)]
    first = report.main(argv)
    second = report.main(argv)
    assert [r["from_cache"] for r in first] == [False] * 3
    assert [r["from_cache"] for r in second] == [True] * 3
    assert all(r["timings_run"] == 0 for r in second)
    assert [r["config"] for r in first] == [r["config"] for r in second]
    assert json.loads(out.read_text())["backend"] == "cpu"
    rows = report.main(["--fast", "--device", "cpu", "--kernels",
                        "nope,flash_attention"])
    err = capsys.readouterr().err
    assert "unknown kernel 'nope'" in err
    assert [r["kernel"] for r in rows] == ["flash_attention"]


# --------------------------------------------------------------------------
# serving: configs resolved once, when the engine is built
# --------------------------------------------------------------------------
def test_tuned_serve_configs(tmp_cache):
    """serve.step resolves the JAX package's keys at the JAX shapes."""
    from repro.configs.qwen15_05b import CONFIG as JCFG
    from repro.serve.step import tuned_kernel_configs as jax_configs
    from repro_torch.configs import get_config
    from repro_torch.serve import tuned_kernel_configs
    cfgs = tuned_kernel_configs(get_config("qwen1.5-0.5b"), batch_size=2,
                                max_seq=128)
    assert set(cfgs) == set(jax_configs(JCFG, batch_size=2, max_seq=128))
    for v in cfgs.values():
        assert isinstance(v, LaunchConfig)


def _engine_cache_key(name, cfg, slots, cache_len):
    """The key under which ``build_engine`` looks ``name`` up."""
    seen = {}
    real = tune.TuneCache.get

    def spy(self, key):
        seen[key.split("|")[0]] = key
        return real(self, key)
    tune.TuneCache.get = spy
    try:
        from repro_torch.serve import tuned_kernel_configs
        tuned_kernel_configs(cfg, slots, cache_len, page_size=16,
                             chunk_size=8)
    finally:
        tune.TuneCache.get = real
    return seen[name]


def _tiny_engine(slots=2):
    """A reduced qwen1.5-0.5b paged engine on the CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.serve import EngineConfig, build_engine
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              dtype="float32")
    ecfg = EngineConfig(slots=slots, cache_len=64, backend="paged",
                        chunked_prefill=True, chunk_size=8)
    return build_engine(cfg, ecfg, device="cpu")


def test_empty_cache_launches_the_defaults(tmp_cache):
    eng = _tiny_engine()
    assert eng.serve_step.launch == DEFAULT
    assert all(c == tune.REGISTRY[n].default
               for n, c in eng.serve_step.troop_configs.items())


def test_engine_launches_with_its_tuned_configs(tmp_cache, monkeypatch):
    """A cached winner at the engine's read-out shape reaches the gemv
    launches of its steps (one slot: every projection is a routed gemv)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import modules as TM
    from repro_torch.serve import Request
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              dtype="float32")
    key = _engine_cache_key("gemv", cfg, 1, 64)
    cache = tune.default_cache()
    won = LaunchConfig(gemv_warps=16)
    cache.put(key, {"config": tune.config_to_dict(won)})
    eng = _tiny_engine(slots=1)
    assert eng.serve_step.troop_configs["gemv"] == won
    assert eng.serve_step.launch == LaunchConfig(gemv_warps=16)
    seen = []
    real = TK.gemv

    def spy(*args, cfg=DEFAULT, **kw):
        seen.append(cfg)
        return real(*args, cfg=cfg, **kw)
    monkeypatch.setattr(TK, "gemv", spy)
    eng.submit(Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32),
                       max_new_tokens=3))
    with TM.kernel_routing():
        eng.run_until_drained()
    assert seen and all(c.gemv_warps == 16 for c in seen)
    assert TM.launch_config() == DEFAULT         # restored after each step


def test_second_decode_step_makes_no_cache_lookup(tmp_cache, monkeypatch):
    """The engine resolves its configs once, at build: a decode step of the
    kernel-routed path asks the tune cache nothing."""
    from repro_torch.models import modules as TM
    from repro_torch.serve import Request
    eng = _tiny_engine()
    calls = []
    real = tune.TuneCache.get

    def spy(self, key):
        calls.append(key)
        return real(self, key)
    monkeypatch.setattr(tune.TuneCache, "get", spy)
    eng.submit(Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=6))
    with TM.kernel_routing():
        while eng.decode_steps < 1:
            eng.step()
        calls.clear()
        while eng.decode_steps < 2:
            eng.step()                       # up to the second decode step
    assert eng.decode_steps == 2 and calls == []
