"""The other dense attention archs (glm4-9b, qwen3-14b, qwen1.5-32b) against
the JAX package, on the CPU.

Each arch runs reduced (2 layers, d 128, head_dim 32), in fp32, with the
head counts overridden so that its group size survives the cut: glm4-9b
16 query heads on 1 KV head (G = 16, as its 32 on 2), qwen3-14b 10 on 2
(G = 5, as its 40 on 8; with qk-norm) and qwen1.5-32b 4 on 4 (MHA, as its
40 on 40).  The same numpy inputs and the JAX package's seed-0 weights,
bridged, go through both packages:

* the configs, the bridge (``q_norm`` / ``k_norm`` included) and the
  port's own init, which draws the same leaves;
* one attention layer's q, k and v after qk-norm and RoPE, routed (the
  JAX package in interpret mode) and unrouted;
* the training forward (``train_logits``);
* the slice as a whole: the chunked + prefix-cache engine emits the JAX
  engine's greedy streams, with raw weights over bf16 pages and with mx4
  weights over int8 pages, routing on and off;
* the kernel dispatches of one one-slot decode step against the JAX
  package's ``decode_step_account``, plus qk-norm's two ``rmsnorm``
  launches a layer, which that account leaves out (and the exact launches
  ``chip_smoke.py`` asserts at full width);
* the engine factory's layer-by-layer quantized init, bit for bit the
  init quantized afterwards, in all four formats;
* the launcher's ``--smoke`` run.

Tolerances: 1e-5 per op and 1e-4 per model step (the same fp32
arithmetic, summed in other orders), as the other port tests; greedy
streams compare exactly.
"""
import collections
import dataclasses
import gc
import importlib.util
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import modules as JM  # noqa: E402
from repro.obs.energy import decode_step_account  # noqa: E402
from repro.quant import params as JQP  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import build_engine as jax_build_engine  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, reduced  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import modules as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.quant import quantize_params, quantizer  # noqa: E402
from repro_torch.quant.tensor import QuantizedTensor  # noqa: E402
from repro_torch.serve import (EngineConfig, PageSpec, Request,  # noqa: E402
                               build_engine)

ROOT = Path(__file__).resolve().parents[1]
#: the head counts each reduced arch keeps: its group size
HEADS = {"glm4-9b": dict(num_heads=16, num_kv_heads=1),
         "qwen3-14b": dict(num_heads=10, num_kv_heads=2),
         "qwen1.5-32b": dict(num_heads=4, num_kv_heads=4)}
ARCHS = sorted(HEADS)
TOL, STEP_TOL = 1e-5, 1e-4


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def jlayer(jp, i):
    """Layer i of the JAX tree (its one group stacks the layers)."""
    return jax.tree.map(lambda v: v[i], jp["groups"][0][0])


def port_cfg(arch, dtype="float32"):
    return dataclasses.replace(reduced(get_config(arch), **HEADS[arch]),
                               dtype=dtype)


@pytest.fixture
def jax_tune_cache(monkeypatch, tmp_path):
    """Routed JAX layers dispatch their Pallas kernels through the tune
    cache: point it at an empty file so the lookup is the heuristic."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, jax cfg, jax model, raw jax params, port cfg, bridged port
    params): the reduced arch at its group size in fp32, JAX's seed-0
    init."""
    arch = request.param
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch),
                                           **HEADS[arch]), dtype="float32")
    tcfg = port_cfg(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.num_heads // tcfg.num_kv_heads == \
        get_config(arch).num_heads // get_config(arch).num_kv_heads
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat="none"))
    jp = JM.unbox(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=torch.float32)
    return arch, jcfg, jm, jp, tcfg, tp


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_jax_config(arch):
    cfg = get_config(arch)
    assert arch in ARCH_IDS
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config(arch))
    TT.check_supported(cfg)
    assert cfg.qk_norm == (arch == "qwen3-14b")


def test_tied_readout_is_still_refused():
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              tie_embeddings=True)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue 1 item 13 .tied read-out"):
        build_model(cfg, device="cpu")


# ------------------------------------------------------------------ bridge
def test_bridge_carries_every_leaf(pair):
    """Every JAX leaf reaches the port, qk-norm's scales as fp32 vectors
    of width head_dim, projections transposed."""
    arch, _, _, jp, tcfg, tp = pair
    for i in range(tcfg.num_layers):
        jl, tl = jlayer(jp, i), tp["layers"][i]
        assert set(tl["mixer"]) == set(jl["mixer"])
        for k in ("q_norm", "k_norm"):
            assert (k in tl["mixer"]) == tcfg.qk_norm
            if tcfg.qk_norm:
                s = tl["mixer"][k]["scale"]
                assert s.dtype == torch.float32
                assert s.shape == (tcfg.head_dim,)
                np.testing.assert_array_equal(
                    s.numpy(), np.asarray(jl["mixer"][k]["scale"]))
        for k in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                tl["mixer"][k]["w"].numpy(),
                np.asarray(jl["mixer"][k]["w"]).T)
            assert ("b" in tl["mixer"][k]) == ("b" in jl["mixer"][k])
    per_layer = len(jax.tree.leaves(jp["groups"]))     # stacked leaves
    top = len(jax.tree.leaves(jp)) - per_layer
    assert len(list(tp.parameters())) == per_layer * tcfg.num_layers + top


def test_port_init_draws_the_bridged_layout(pair):
    """The port's own init makes the bridged tree's names, shapes and
    dtypes (qk-norm's unit scales included)."""
    arch, _, _, _, tcfg, tp = pair
    own = build_model(tcfg, device="cpu", seed=0).params
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in own.named_parameters()}
    assert shapes == {k: (tuple(v.shape), v.dtype)
                      for k, v in tp.named_parameters()}
    if tcfg.qk_norm:
        assert torch.equal(own["layers"][1]["mixer"]["k_norm"]["scale"],
                           torch.ones(tcfg.head_dim))


# ----------------------------------------------------------------- modules
#: the JAX ``gemv`` kernel's default row block (``kernels/gemv.py``)
JAX_GEMV_BLOCK = 256


def jax_qkv(p, cfg, x, pos, routed):
    """The JAX package's q, k, v of one layer (``_project_qkv``).  Its
    routed one-row ``gemv`` writes only whole blocks of rows: a width past
    a multiple of the block (qwen3-14b's cut, 10 heads of 32 = 320 rows)
    leaves the rest unwritten (a fault of the reference, ROADMAP queue 3).
    There the projections run unrouted and qk-norm on the ``rmsnorm``
    kernel, then RoPE, as ``_project_qkv`` orders them."""
    x, pos = jnp.asarray(x), jnp.asarray(pos)
    widths = (cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim)
    if not routed or x.size != cfg.d_model or all(
            n % min(JAX_GEMV_BLOCK, n) == 0 for n in widths):
        return JA._project_qkv(p, cfg, x, x, pos, pos, jnp.float32)
    with JM.kernel_routing(False):
        q, k, v = (JM.apply_dense(p[n], x, jnp.float32).reshape(
            x.shape[:2] + (-1, cfg.head_dim)) for n in ("wq", "wk", "wv"))
    q = JM.apply_norm(p["q_norm"], q, "rmsnorm", cfg.norm_eps)
    k = JM.apply_norm(p["k_norm"], k, "rmsnorm", cfg.norm_eps)
    return (JM.apply_rope(q, pos, cfg.rope_theta),
            JM.apply_rope(k, pos, cfg.rope_theta), v)


@pytest.mark.parametrize("rows,routed", [((1, 1), True), ((1, 1), False),
                                         ((2, 3), True), ((2, 3), False)])
def test_project_qkv_matches_jax(pair, jax_tune_cache, rows, routed):
    """q, k and v of one attention layer after qk-norm and RoPE: one row
    (routed: the gemv and rmsnorm kernels' routes) and 2 x 3 rows, with
    non-unit norm scales."""
    arch, jcfg, _, jp, tcfg, tp = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal(rows + (tcfg.d_model,)).astype(np.float32)
    pos = (np.arange(rows[1])[None, :] + np.array([[5], [40]])[:rows[0]]
           ).astype(np.int32)
    jpar = dict(jlayer(jp, 1)["mixer"])
    tpar = tp["layers"][1]["mixer"]
    if tcfg.qk_norm:
        tpar = torch.nn.ModuleDict(dict(tpar.items()))
        for k in ("q_norm", "k_norm"):
            s = (1 + 0.2 * rng.standard_normal(tcfg.head_dim)).astype(
                np.float32)
            jpar[k] = {"scale": jnp.asarray(s)}
            tpar[k] = torch.nn.ParameterDict({"scale": TM.frozen(t(s))})
    with JM.kernel_routing(routed), TM.kernel_routing(routed):
        want = jax_qkv(jpar, jcfg, x, pos, routed)
        got = TA._project_qkv(tpar, tcfg, t(x), t(pos, torch.int32),
                              torch.float32)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        close(g, w)
    H, KV = tcfg.num_heads, tcfg.num_kv_heads
    assert got[0].shape[2] == H and got[1].shape[2] == KV


def test_train_logits_match_jax(pair):
    arch, _, jm, jp, tcfg, tp = pair
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = jm.train_logits(jp, {"tokens": jnp.asarray(tokens)})
    model = build_model(tcfg, RuntimeConfig(remat="none"), params=tp,
                        device="cpu")
    got, aux = model.train_logits({"tokens": t(tokens, torch.int32)})
    assert got.shape == (2, 12, tcfg.vocab_size) and float(aux) == 0.0
    close(got, want, STEP_TOL)


# ------------------------------------------------------------------- slice
ENGINE = dict(slots=3, cache_len=96, backend="paged", chunked_prefill=True,
              chunk_size=8, prefix_cache=True)
#: the two served formats: (quantize_weights, kv_cache_dtype)
FORMATS = {"raw": ("none", ""), "mx4": ("mx4", "int8")}


def trace():
    """A 40-token system prompt (a full 32-row page + 8 rows, or two and a
    half 16-row pages: later requests copy-on-write a page) ahead of
    24..40-token bodies, then two prompts that share a page and diverge
    inside the second."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, 500, 40)
    prompts = [np.concatenate([sysp, rng.integers(1, 500, int(n))])
               for n in rng.integers(24, 41, 5)]
    base = rng.integers(1, 500, 72)
    b = base.copy()
    b[40] = 7
    prompts += [np.concatenate([base, [37, 2, 3]]),
                np.concatenate([b, [4, 5, 6]])]
    return [p.astype(np.int32) for p in prompts]


@pytest.fixture(scope="module", params=sorted(FORMATS))
def served_jax(request, pair, tmp_path_factory):
    """The JAX engine's streams and metrics for one format, and the port's
    weights in that format (mx4: the JAX package's codes, bridged)."""
    fmt = request.param
    weights, kv = FORMATS[fmt]
    arch, jcfg, _, jp, tcfg, tp = pair
    jw = jp
    if weights != "none":
        jw = JQP.quantize_params(jp, fmt=weights)
        tp = params_from_numpy(jax.tree.map(np.asarray, jw), tcfg,
                               device="cpu", dtype=torch.float32)
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TUNE_CACHE",
              str(tmp_path_factory.mktemp("tune") / "tune.json"))
    try:
        model = jax_build_model(jcfg, JaxRuntimeConfig(
            remat="none", kv_cache_dtype=kv, quantize_weights=weights))
        eng = jax_build_engine(model, JaxEngineConfig(
            **ENGINE, kv_cache_dtype=kv, quantize_weights=weights),
            params=jw)
        reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(trace())]
        for r in reqs:
            eng.submit(r)
        assert len(eng.run_until_drained()) == len(reqs)
    finally:
        mp.undo()
    return fmt, {r.rid: r.out for r in reqs}, eng.metrics(), tp


@pytest.mark.parametrize("routed", [False, True])
def test_engine_token_identical_to_jax(pair, served_jax, routed):
    arch, _, _, _, tcfg, _ = pair
    fmt, want, jm, tp = served_jax
    weights, kv = FORMATS[fmt]
    eng = build_engine(
        build_model(tcfg, RuntimeConfig(quantize_weights=weights,
                                        kv_cache_dtype=kv),
                    params=tp, device="cpu"),
        EngineConfig(**ENGINE, kv_cache_dtype=kv, quantize_weights=weights))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(trace())]
    for r in reqs:
        eng.submit(r)
    with TM.kernel_routing(routed):
        finished = eng.run_until_drained()
    assert len(finished) == len(reqs) and all(r.done for r in reqs)
    assert {r.rid: r.out for r in reqs} == want
    m = eng.metrics()
    assert m["prefix_hits"] >= 1 and m["cow_copies"] >= 1
    for k in ("prefix_hits", "cow_copies", "prefix_shared_tokens",
              "chunk_calls", "decode_steps", "tokens_generated",
              "kv_bytes_streamed", "kv_dtype", "page_size"):
        assert m[k] == jm[k], k
    be = eng.backend
    total = be.spec.num_pages - 1
    assert be.allocator.num_free == total - be.prefix_index.num_pages
    assert all(n == 1 for n in be.allocator._refs.values())
    be.prefix_index.clear()
    assert be.allocator.num_free == total


# ------------------------------------------------------------- launch counts
def account(cfg, fmt, **kw):
    """The kernels of one decode step by the JAX package's account, plus
    qk-norm's two ``rmsnorm`` launches a layer, which it leaves out."""
    weights, kv = FORMATS[fmt]
    if weights != "none":
        kw.update(weights=weights, kv_dtype=kv)
    calls = collections.Counter()
    for e in decode_step_account(cfg, **kw):
        calls[e.kernel] += e.calls
    if cfg.qk_norm:
        calls["rmsnorm"] += 2 * cfg.num_layers
    return dict(calls)


@pytest.fixture
def dispatches(monkeypatch):
    """Counts every call the model path makes to a kernel of
    ``kernels.ops``: on the CPU the wrappers run their plain versions and
    count no launch, so the calls stand in for the launches."""
    calls = collections.Counter()
    for name in TK.launch_counts():
        fn = getattr(TK, name, None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(TK, name, counted)
    return calls


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_one_slot_decode_step_dispatches_the_account(pair, dispatches, fmt):
    """One one-slot decode step of the reduced arch, routed, calls the
    kernels of the JAX account of that step (raw: ``gemv`` per projection
    and the read-out; mx4 + int8 pages: ``mx_qgemv``, the fused SwiGLU and
    the int8 decode), and qk-norm two more ``rmsnorm`` a layer."""
    arch, jcfg, _, _, tcfg, tp = pair
    weights, kv = FORMATS[fmt]
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    rt = RuntimeConfig(paged_kernel_decode=True, quantize_weights=weights,
                       kv_cache_dtype=kv)
    params = build_model(cfg, device="cpu", seed=0).params
    if weights != "none":
        params = quantize_params(params, fmt=weights)
    model = build_model(cfg, rt, params=params, device="cpu")
    page = 32 if kv else 16
    spec = PageSpec.for_engine(1, 64, page, dtype=rt.kv_dtype())
    caches = model.init_caches(1, 64, page_spec=spec)
    bt = torch.arange(1, spec.blocks_per_slot + 1, dtype=torch.int32)[None]
    batch = {"tokens": torch.tensor([[7]], dtype=torch.int32),
             "pos": torch.tensor([9], dtype=torch.int32),
             "block_tables": bt}
    with TM.kernel_routing():
        logits, _ = model.decode_step(batch, caches)
    assert torch.isfinite(logits.float()).all()
    jcfg_bf16 = dataclasses.replace(jcfg, dtype="bfloat16")
    want = account(jcfg_bf16, fmt, slots=1, cache_len=64, page_size=page)
    assert dict(dispatches) == want
    assert want["rmsnorm"] == (4 if cfg.qk_norm else 2) * cfg.num_layers + 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_chip_smoke_launch_gates_match_the_jax_account(arch, fmt):
    """The exact launches ``chip_smoke.py`` asserts for one one-slot decode
    step of each full-width arch are the JAX account's kernels plus
    qk-norm's two ``rmsnorm`` a layer (qwen1.5-32b serves mx4 only)."""
    gates = _chip_smoke().DENSE_DECODE_LAUNCHES[arch]
    if arch == "qwen1.5-32b" and fmt == "raw":
        assert set(gates) == {"mx4"}
        return
    cfg = jax_get_config(arch)
    got = gates["bf16" if fmt == "raw" else fmt]
    assert got == account(cfg, fmt, slots=1, cache_len=1024)
    L = cfg.num_layers
    assert got["rmsnorm"] == (4 if cfg.qk_norm else 2) * L + 1
    proj = "gemv" if fmt == "raw" else "mx_qgemv"
    assert got[proj] == (7 if fmt == "raw" else 5) * L + 1


# ------------------------------------------------------- quantized factory
QUANT = {"int8": dict(bits=8, group_size=64), "int4": dict(bits=4),
         "mx4": dict(fmt="mx4"), "fp8": dict(fmt="fp8")}


def leaves(params):
    """name -> tensor of every parameter and every code / scale array."""
    out = {}
    for name, m in params.named_modules():
        if isinstance(m, QuantizedTensor):
            out[name + ".values"] = m.values
            out[name + ".scales"] = m.scales
    out.update(dict(params.named_parameters()))
    return out


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen1.5-0.5b",
                                  "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("fmt", sorted(QUANT))
def test_layer_by_layer_quantized_init_is_bit_identical(arch, fmt):
    """``init_lm(quantize=quantizer(...))`` gives, leaf for leaf and bit
    for bit, ``quantize_params`` of the whole init from the same seed (so
    the seeded weights of the served archs do not move); the factory
    builds that tree."""
    cfg = reduced(get_config(arch))
    kw = QUANT[fmt]

    def gen():
        g = torch.Generator()
        g.manual_seed(3)
        return g
    whole = quantize_params(TT.init_lm(cfg, generator=gen(), device="cpu"),
                            **kw)
    each = TT.init_lm(cfg, generator=gen(), device="cpu",
                      quantize=quantizer(**kw))
    a, b = leaves(whole), leaves(each)
    assert list(a) == list(b)
    assert sum(isinstance(m, QuantizedTensor) for m in each.modules()) > 0
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(
            a[k].view(torch.uint8) if a[k].dtype == torch.float8_e4m3fn
            else a[k], b[k].view(torch.uint8)
            if b[k].dtype == torch.float8_e4m3fn else b[k]), k
    q = {"int8": "int8", "int4": "int4", "mx4": "mx4", "fp8": "fp8"}[fmt]
    eng = build_engine(cfg, EngineConfig(
        backend="paged", chunked_prefill=True, quantize_weights=q,
        quantize_group_size=kw.get("group_size", 128)), device="cpu", seed=3)
    c = leaves(eng.model.params)
    assert list(c) == list(a)
    for k in a:
        assert torch.equal(a[k].view(torch.uint8) if a[k].dtype ==
                           torch.float8_e4m3fn else a[k],
                           c[k].view(torch.uint8) if c[k].dtype ==
                           torch.float8_e4m3fn else c[k]), k


def test_quantized_init_never_holds_every_raw_layer(monkeypatch):
    """While the factory's init runs, at most one layer's raw projections
    are alive at a time, and none is left after it: the raw init is never
    held whole beside its codes."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-14b")),
                              num_layers=6)
    born = []
    dense_init = TM.dense_init

    def tracked(*a, **kw):
        p = dense_init(*a, **kw)
        born.append(weakref.ref(p["w"]))
        return p
    monkeypatch.setattr(TM, "dense_init", tracked)
    alive = []
    visit = quantizer(fmt="mx4")

    def counted(keys, node):
        gc.collect()
        alive.append(sum(r() is not None for r in born))
        return visit(keys, node)
    TT.init_lm(cfg, generator=torch.Generator(), device="cpu",
               quantize=counted)
    gc.collect()
    assert len(born) == 7 * cfg.num_layers + 1
    assert max(alive) <= 7 and len(alive) == cfg.num_layers + 1
    assert sum(r() is not None for r in born) == 0


def test_default_policy_leaves_qk_norm_raw():
    params = build_model(reduced(get_config("qwen3-14b")), device="cpu",
                         seed=0).params
    q = quantize_params(params, fmt="mx4")
    mixer = q["layers"][0]["mixer"]
    assert isinstance(mixer["wq"]["w"], QuantizedTensor)
    for k in ("q_norm", "k_norm"):
        assert mixer[k]["scale"] is params["layers"][0]["mixer"][k]["scale"]
    jq = JQP.quantize_params(JM.unbox(jax_build_model(
        jax_reduced(jax_get_config("qwen3-14b")),
        JaxRuntimeConfig(remat="none")).init(jax.random.PRNGKey(0))),
        fmt="mx4")
    jmix = jq["groups"][0][0]["mixer"]
    assert not hasattr(jmix["q_norm"]["scale"], "fmt")
    assert hasattr(jmix["wq"]["w"], "fmt")


# ---------------------------------------------------------------- launcher
LAUNCH = [[], ["--quantize-weights", "mx4", "--kv-cache-dtype", "int8"]]


@pytest.mark.parametrize("quant", LAUNCH, ids=["bf16", "mx4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_smoke_on_cpu(capsys, arch, quant):
    """Per layer q/k/v/o and the MLP's three quantize, + lm_head."""
    rc = launcher.main(["--arch", arch, "--smoke", "--chunked-prefill",
                        "--prefix-cache", "--kernel-decode", "--device",
                        "cpu", "--requests", "4", "--max-new", "4", *quant])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 4/4 requests" in out
    if quant:
        assert "quantized 15 weight leaves (mx4)" in out
        assert '"kv_dtype": "int8"' in out and '"page_size": 32' in out
