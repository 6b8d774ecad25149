"""Port MoE (qwen2-moe-a2.7b) against the JAX package, on the CPU.

The same numpy inputs and the same bridged weights of the reduced
qwen2-moe-a2.7b (2 layers, d 128, 8 experts, top-2, a gated shared expert)
go through the JAX package and the port:

* the grouped MX expert GEMV's plain version against the JAX oracle and the
  interpret-mode Pallas kernel, fp4 and fp8, repeated and distinct ids;
* ``_route_group``'s dispatch, valid and gates, bit for bit, including an
  input that overflows capacity;
* ``apply_moe`` on the gather path and the routed path (raw and MX stacks,
  routing on and off);
* ``quantize_params`` on the MoE tree and the bridge's MoE layout;
* one decode step and one chunk step;
* the slice as a whole: the chunked + prefix-cache engine emits the JAX
  engine's greedy streams, with raw weights over bf16 pages and with mx4
  weights over int8 pages, at 3 slots (the 3-row decode takes the gather
  path) and at 1 slot (the one-row decode takes the routed path), with
  routing on and off;
* the per-step launch counts that ``chip_smoke.py`` asserts on the card
  against the JAX package's ``decode_step_account``.

Tolerances: fp32 at rtol=atol=1e-5 per op and 1e-4 per model step (the
same fp32 arithmetic, summed in other orders); the router's softmax is the
JAX package's bit for bit on the CPU (``core.xla_cpu.exp``), so routing
decisions and gates compare exactly.
"""
import collections
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.troop import TroopConfig  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import modules as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.obs.energy import decode_step_account  # noqa: E402
from repro.quant import params as JQP  # noqa: E402
from repro.quant import tensor as JQ  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import build_engine as jax_build_engine  # noqa: E402
from repro.serve.kvcache import PagedKVCache as JaxPagedKVCache  # noqa
from repro.serve.kvcache import PageSpec as JaxPageSpec  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import modules as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.quant import params as TQP  # noqa: E402
from repro_torch.quant import tensor as TQ  # noqa: E402
from repro_torch.serve import (EngineConfig, PagedKVCache,  # noqa: E402
                               Request, build_engine)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-moe-a2.7b"
INTERPRET = TroopConfig(interpret=True)     # explicit: no tune-cache lookup


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def u8(a) -> np.ndarray:
    """The bytes of a code array (fp8 codes viewed as uint8)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8) if a.dtype == TQ.FP8_DTYPE else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def jlayer(jp, i):
    """Layer i of the JAX tree (its one group stacks the layers)."""
    return jax.tree.map(lambda v: v[i], jp["groups"][0][0])


@pytest.fixture
def jax_tune_cache(monkeypatch, tmp_path):
    """Routed JAX layers dispatch their Pallas kernels through the tune
    cache: point it at an empty file so the lookup is the heuristic."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, raw jax params, port cfg, bridged port params):
    reduced qwen2-moe-a2.7b in fp32, JAX's seed-0 init."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert (tcfg.num_layers, tcfg.d_model, tcfg.moe.num_experts,
            tcfg.moe.num_experts_per_tok) == (2, 128, 8, 2)
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat="none"))
    jp = JM.unbox(jm.init(jax.random.PRNGKey(0)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=torch.float32)
    return jcfg, jm, jp, tcfg, tp


@pytest.fixture(scope="module", params=["mx4", "fp8"])
def mx_pair(request, pair):
    """The JAX tree MX-quantized by the JAX package, and bridged."""
    jcfg, jm, jp, tcfg, _ = pair
    jq = JQP.quantize_params(jp, fmt=request.param)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu",
                           dtype=torch.float32)
    return request.param, jq, tq


# ------------------------------------------------------ grouped expert GEMV
@pytest.mark.parametrize("elem", ["fp4", "fp8"])
def test_grouped_expert_qgemv_plain_matches_jax(elem):
    rng = np.random.default_rng(0)
    E, K, N = 4, 128, 64
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    jq = JQ.quantize_mx(jnp.asarray(w), elem=elem, axis=-2)
    tq = TQ.quantize_mx(t(w), elem=elem, axis=-2)
    np.testing.assert_array_equal(u8(tq.values), u8(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    xs = rng.standard_normal((2, K)).astype(np.float32)
    TK.reset_launch_counts()
    for ids in ([0, 0], [1, 3], [3, 2]):
        ia = np.asarray(ids, np.int32)
        got = TK.grouped_expert_qgemv(tq.values, tq.scales, t(xs),
                                      torch.from_numpy(ia))
        assert got.dtype == torch.float32 and got.shape == (2, N)
        args = (jq.values, jq.scales, jnp.asarray(xs), jnp.asarray(ia))
        close(got, JR.grouped_expert_qgemv(*args))
        close(got, JK.grouped_expert_qgemv(*args, cfg=INTERPRET))
    assert TK.launch_counts()["grouped_expert_qgemv"] == 0   # CPU: plain


def test_gemv_of_a_stack_reads_the_indexed_matrix():
    rng = np.random.default_rng(1)
    w = t(rng.standard_normal((5, 16, 32)))
    x = t(rng.standard_normal(32))
    got = TK.gemv(w, x, torch.tensor([3], dtype=torch.int32))
    close(got, JR.gemv(jnp.asarray(w[3].numpy()), jnp.asarray(x.numpy())))


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("n", [1, 8, 32])
@pytest.mark.parametrize("skew", [0.0, 4.0])
def test_route_group_identical_to_jax(pair, n, skew):
    """``skew`` pushes every token toward experts 2 and 5: their picks run
    past capacity and drop in flat (token, slot) order."""
    jcfg, _, _, tcfg, _ = pair
    mo = tcfg.moe
    rng = np.random.default_rng(2 + n)
    lg = rng.standard_normal((n, mo.num_experts)).astype(np.float32) * 2
    lg[:, [2, 5]] += skew
    cap = max(int(n * mo.num_experts_per_tok / mo.num_experts
                  * mo.capacity_factor + 0.5), mo.num_experts_per_tok)
    jd, jv, jgt, _ = JMOE._route_group(None, jnp.asarray(lg), jcfg.moe, cap)
    td, tv, tgt, rows = TMOE._route_group(t(lg), mo, cap)
    assert td.dtype == torch.int32 and tv.dtype == tgt.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jgt))
    # the combine plan: each token's kept picks, in ascending expert order
    kept = int(tv.sum())
    assert int((rows < mo.num_experts * cap).sum()) == kept
    if skew and n > 1:
        assert kept < n * mo.num_experts_per_tok       # capacity overflowed
    for tok in range(n):
        r = rows[tok][rows[tok] < mo.num_experts * cap]
        assert torch.equal(r, torch.sort(r).values)
        e, c = r // cap, r % cap
        assert (td[e, c] == tok).all()


def test_expert_parallel_stacks_raise(pair):
    _, _, _, tcfg, tp = pair
    ffn = tp["layers"][0]["ffn"]
    half = torch.nn.ModuleDict(dict(ffn.items()))
    half["wi_up"] = torch.nn.ParameterDict({"w": ffn["wi_up"]["w"][:4]})
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        TMOE.apply_moe(half, tcfg, torch.zeros(1, 2, tcfg.d_model),
                       dtype=torch.float32)


# ------------------------------------------------------------------- apply
CASES = [((2, 3), False), ((2, 3), True), ((1, 1), False), ((1, 1), True)]


def moe_matches_jax(jffn, tffn, jcfg, tcfg, rows, routed, seed):
    x = np.random.default_rng(seed).standard_normal(
        rows + (tcfg.d_model,)).astype(np.float32)
    with JM.kernel_routing(routed), TM.kernel_routing(routed):
        want, aux = JMOE.apply_moe(jffn, jcfg, jnp.asarray(x),
                                   dtype=jnp.float32)
        got = TMOE.apply_moe(tffn, tcfg, t(x), dtype=torch.float32)
    assert got.shape == tuple(want.shape)
    close(got, want)


@pytest.mark.parametrize("rows,routed", CASES)
def test_apply_moe_raw_matches_jax(pair, jax_tune_cache, rows, routed):
    """(1, 1) routed: the fp32 router gemv and 12 expert gemvs of the
    stacks by device-resident ids; otherwise the gather path (6 rows
    overflow the capacity of 2)."""
    jcfg, _, jp, tcfg, tp = pair
    TK.reset_launch_counts()
    moe_matches_jax(jlayer(jp, 1)["ffn"], tp["layers"][1]["ffn"], jcfg, tcfg,
                    rows, routed, seed=10)
    assert not any(TK.launch_counts().values())         # CPU: plain


@pytest.mark.parametrize("rows,routed", CASES)
def test_apply_moe_mx_matches_jax(pair, mx_pair, jax_tune_cache, rows,
                                  routed):
    """(1, 1) routed: three grouped expert GEMVs, the fused shared SwiGLU,
    its down projection and the raw shared gate; otherwise the stacks
    dequantize in the graph."""
    jcfg, _, _, tcfg, _ = pair
    _, jq, tq = mx_pair
    moe_matches_jax(jlayer(jq, 0)["ffn"], tq["layers"][0]["ffn"], jcfg, tcfg,
                    rows, routed, seed=11)


# ------------------------------------------------------------ weight trees
def quantized_leaves(params):
    return {name: m for name, m in params.named_modules()
            if isinstance(m, TQ.QuantizedTensor)}


def test_quantize_params_on_the_moe_tree(pair, mx_pair):
    _, _, jp, tcfg, tp = pair
    fmt, jq, tq = mx_pair
    mine = TQP.quantize_params(tp, fmt=fmt)
    got, bridged = quantized_leaves(mine), quantized_leaves(tq)
    assert sorted(got) == sorted(bridged)
    assert len(got) == 10 * tcfg.num_layers + 1
    for name, qt in got.items():
        assert qt.shape == bridged[name].shape
        np.testing.assert_array_equal(u8(qt.values), u8(bridged[name].values))
        np.testing.assert_array_equal(qt.scales.numpy(),
                                      bridged[name].scales.numpy())
    ffn = mine["layers"][0]["ffn"]
    assert ffn["wi_up"]["w"].shape == (tcfg.moe.num_experts, tcfg.d_model,
                                       tcfg.moe.d_ff)     # (E, in, out)
    for raw in ("router", "shared_gate"):
        assert isinstance(ffn[raw]["w"], torch.nn.Parameter)
        assert ffn[raw]["w"] is tp["layers"][0]["ffn"][raw]["w"]
    js, ts = JQP.quantized_stats(jq), TQP.quantized_stats(mine)
    for k in ("quantized_bytes", "raw_bytes", "quantized_fp32_bytes"):
        assert ts[k] == js[k], k
    # the JAX tree stacks the layers: one leaf per projection for all of them
    L = tcfg.num_layers
    assert ts["quantized_leaves"] == L * (js["quantized_leaves"] - 1) + 1


def test_bridge_moe_layout(pair):
    _, _, jp, tcfg, tp = pair
    jf = jp["groups"][0][0]["ffn"]
    bf = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=torch.bfloat16)
    for tree, dt in ((tp, torch.float32), (bf, torch.bfloat16)):
        ffn = tree["layers"][1]["ffn"]
        router = ffn["router"]["w"]
        assert router.dtype == torch.float32          # always fp32
        assert router.shape == (tcfg.moe.num_experts, tcfg.d_model)
        np.testing.assert_array_equal(router.numpy(),
                                      np.asarray(jf["router"]["w"][1]).T)
        for k in ("wi_up", "wi_gate", "wo"):
            w = ffn[k]["w"]
            assert w.dtype == dt and w.is_contiguous()
            want = np.asarray(jnp.asarray(jf[k]["w"][1]).astype(
                getattr(jnp, str(dt).split(".")[1])).astype(jnp.float32))
            np.testing.assert_array_equal(w.float().numpy(),
                                          want.transpose(0, 2, 1))
        assert ffn["shared_gate"]["w"].dtype == dt
        assert ffn["shared_gate"]["w"].shape == (1, tcfg.d_model)


def test_init_lm_builds_the_moe_tree(pair):
    _, _, _, tcfg, tp = pair
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    model = build_model(cfg, device="cpu", seed=0)
    ffn = model.params["layers"][0]["ffn"]
    assert ffn["router"]["w"].dtype == torch.float32
    for k in ("wi_up", "wi_gate", "wo", "shared", "shared_gate"):
        assert k in ffn
    assert ffn["wi_up"]["w"].dtype == torch.bfloat16
    for name, p in tp.named_parameters():
        assert model.params.get_parameter(name).shape == p.shape, name


# ------------------------------------------------------------ model steps
def step_caches(rng, jm, tcfg, B, S):
    """Identical random bf16-layout page pools (fp32 here) for both
    packages."""
    spec = JaxPageSpec.for_engine(B, S, 16)
    shape = (tcfg.num_layers, spec.num_pages, 16, tcfg.num_kv_heads,
             tcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jc = jm.init_caches(B, S, page_spec=spec)
    jc[0][0]["mixer"] = JaxPagedKVCache(jnp.asarray(k), jnp.asarray(v))
    tc = [PagedKVCache(t(k[i]), t(v[i])) for i in range(tcfg.num_layers)]
    bt = (rng.permutation(spec.num_pages - 1)[:B * spec.blocks_per_slot]
          + 1).reshape(B, spec.blocks_per_slot).astype(np.int32)
    return jc, tc, bt


@pytest.mark.parametrize("B,routed", [(3, False), (3, True), (1, True)])
def test_decode_step_matches_jax(pair, B, routed):
    """B = 3 with an idle slot, whose garbage row routes and takes capacity
    on both sides; B = 1 routed takes the port's routed path."""
    jcfg, jm, jp, tcfg, tp = pair
    rng = np.random.default_rng(12)
    jc, tc, bt = step_caches(rng, jm, tcfg, B, 64)
    if B > 1:
        bt[-1] = 0
    tokens = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    batch = {"tokens": tokens, "pos": np.asarray([40, 7, 12][:B], np.int32),
             "block_tables": bt}
    want, _ = jm.decode_step(jp, {k: jnp.asarray(v)
                                  for k, v in batch.items()}, jc)
    model = build_model(tcfg, params=tp, device="cpu")
    with TM.kernel_routing(routed):
        got, _ = model.decode_step({k: torch.from_numpy(v)
                                    for k, v in batch.items()}, tc)
    close(got, want, 1e-4)


@pytest.mark.parametrize("routed", [False, True])
def test_chunk_prefill_step_matches_jax(pair, routed):
    """A slab with pad rows, which route and take capacity too."""
    jcfg, jm, jp, tcfg, tp = pair
    rng = np.random.default_rng(13)
    jc, tc, bt = step_caches(rng, jm, tcfg, 1, 64)
    C, off, valid = 8, 19, 6
    tokens = np.zeros((1, C), np.int32)
    tokens[0, :valid] = rng.integers(1, tcfg.vocab_size, valid)
    batch = {"tokens": tokens, "offset": np.asarray([off], np.int32),
             "valid": np.asarray([valid], np.int32), "block_tables": bt}
    want, wc = jm.chunk_step(jp, {k: jnp.asarray(v)
                                  for k, v in batch.items()}, jc)
    model = build_model(tcfg, params=tp, device="cpu")
    with TM.kernel_routing(routed):
        got, _ = model.chunk_step({k: torch.from_numpy(v)
                                   for k, v in batch.items()}, tc)
    close(got, want, 1e-4)
    close(tc[1].k_pool[1:], np.asarray(wc[0][0]["mixer"].k_pool[1])[1:],
          1e-4)


# ------------------------------------------------------------------- slice
ENGINE = dict(cache_len=96, backend="paged", chunked_prefill=True,
              chunk_size=8, prefix_cache=True)
# bf16 pages with raw weights; int8 pages with mx4 weights
FORMATS = {"raw": dict(), "mx4": dict(kv_cache_dtype="int8",
                                      quantize_weights="mx4")}


def trace():
    """``test_torch_serve.py``'s trace: a 20-token system prompt ahead of
    5..30-token bodies, then two prompts that share 40 tokens and diverge
    inside the third 16-row page."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, 500, 20)
    prompts = [np.concatenate([sysp, rng.integers(1, 500, int(n))])
               for n in rng.integers(5, 31, 6)]
    base = rng.integers(1, 500, 48)
    b = base.copy()
    b[40] = 7
    prompts += [np.concatenate([base, [37, 2, 3]]),
                np.concatenate([b, [4, 5, 6]])]
    return [p.astype(np.int32) for p in prompts]


@pytest.fixture(scope="module")
def served_jax(pair, tmp_path_factory):
    """The JAX engine's streams and metrics, per (format, slots), served
    on demand."""
    jcfg, _, jp, _, _ = pair
    done = {}

    def serve(fmt, slots):
        if (fmt, slots) not in done:
            over = FORMATS[fmt]
            params = jp if fmt == "raw" else JQP.quantize_params(jp, fmt=fmt)
            model = jax_build_model(jcfg, JaxRuntimeConfig(
                remat="none", kv_cache_dtype=over.get("kv_cache_dtype", ""),
                quantize_weights=over.get("quantize_weights", "none")))
            eng = jax_build_engine(model, JaxEngineConfig(
                **ENGINE, slots=slots, **over), params=params)
            reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(trace())]
            for r in reqs:
                eng.submit(r)
            assert len(eng.run_until_drained()) == len(reqs)
            done[fmt, slots] = {r.rid: r.out for r in reqs}, eng.metrics()
        return done[fmt, slots]
    return serve


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("slots", [3, 1])
@pytest.mark.parametrize("fmt", ["raw", "mx4"])
def test_moe_engine_token_identical_to_jax(pair, served_jax, fmt, slots,
                                           routed):
    _, _, jp, tcfg, tp = pair
    want, jm = served_jax(fmt, slots)
    over = FORMATS[fmt]
    if fmt == "raw":
        params = tp
    else:
        params = params_from_numpy(
            jax.tree.map(np.asarray, JQP.quantize_params(jp, fmt=fmt)),
            tcfg, device="cpu", dtype=torch.float32)
    eng = build_engine(build_model(tcfg, params=params, device="cpu"),
                       EngineConfig(**ENGINE, slots=slots, **over))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(trace())]
    for r in reqs:
        eng.submit(r)
    with TM.kernel_routing(routed):
        finished = eng.run_until_drained()
    assert len(finished) == len(reqs) and all(r.done for r in reqs)
    assert {r.rid: r.out for r in reqs} == want
    m = eng.metrics()
    assert m["prefix_hits"] >= 1
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


# ------------------------------------------------------- chip_smoke gates
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fmt", ["bf16", "mx4"])
def test_chip_smoke_launch_gates_match_the_jax_account(fmt):
    """The exact launches ``chip_smoke.py`` asserts for one one-slot decode
    step of full-width qwen2-moe-a2.7b are the kernels of the JAX package's
    account of that step."""
    cfg = jax_get_config(ARCH)
    kw = {} if fmt == "bf16" else dict(weights="mx4", kv_dtype="int8")
    account = decode_step_account(cfg, slots=1, cache_len=1024, **kw)
    calls = collections.Counter()
    for e in account:
        name = e.kernel
        if name == "paged_decode_attention" and fmt == "mx4":
            raise AssertionError("int8 pages take the int8 kernel")
        calls[name] += e.calls
    gates = _chip_smoke().MOE_DECODE_LAUNCHES[fmt]
    assert gates == dict(calls)
    if fmt == "bf16":
        assert gates["gemv"] == 505
    else:
        assert gates["grouped_expert_qgemv"] == 72
