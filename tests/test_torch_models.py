"""Port layers and model steps against the JAX package on the same numpy
inputs and the same (bridged) weights, in fp32 on the CPU.

Per module at rtol=atol=1e-5 (the same fp32 arithmetic, summed in another
order); whole decode / chunk steps at 1e-4 (the same, compounded through the
layers of the reduced qwen1.5-0.5b).
"""
import dataclasses

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
from repro.serve.kvcache import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serve.kvcache import PageSpec as JaxPageSpec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import modules as TM  # noqa: E402
from repro_torch.serve.kvcache import NULL_PAGE, PagedKVCache  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, jax params, port cfg, port params): reduced
    qwen1.5-0.5b in fp32, JAX's seed-0 init bridged into the port."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen1.5-0.5b")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat="none"))
    jp = JM.unbox(jm.init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, tcfg, device="cpu", dtype=torch.float32)
    return jcfg, jm, jp, tcfg, tp


@pytest.fixture
def jax_tune_cache(monkeypatch, tmp_path):
    """Routed JAX layers dispatch their Pallas kernels through the tune
    cache: point it at an empty file so the lookup is the heuristic."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))


def j2n(a):
    return np.asarray(a, np.float32)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, j2n(want), rtol=tol, atol=tol)


def layer(jp, i):
    """Layer i of the JAX tree (its one group stacks the layers)."""
    return jax.tree.map(lambda v: v[i], jp["groups"][0][0])


# ------------------------------------------------------------------ bridge
def test_bridge_unstacks_transposes_and_keeps_dtypes(pair):
    jcfg, _, jp, tcfg, tp = pair
    assert len(tp["layers"]) == tcfg.num_layers == 2
    jw = j2n(jp["groups"][0][0]["mixer"]["wq"]["w"][1])          # (in, out)
    np.testing.assert_array_equal(tp["layers"][1]["mixer"]["wq"]["w"].numpy(),
                                  jw.T)
    assert tp["final_norm"]["scale"].dtype == torch.float32
    assert tp["embed"]["table"].dtype == torch.float32
    bf = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=torch.bfloat16)
    assert bf["lm_head"]["w"].dtype == torch.bfloat16
    assert bf["layers"][0]["norm1"]["scale"].dtype == torch.float32
    assert bf["layers"][0]["mixer"]["wq"]["b"].dtype == torch.float32
    # the bridged bf16 weight is JAX's per-call fp32 -> bf16 cast
    want = np.asarray(jp["lm_head"]["w"].astype(jnp.bfloat16)
                      .astype(jnp.float32)).T
    np.testing.assert_array_equal(bf["lm_head"]["w"].float().numpy(), want)


# ----------------------------------------------------------------- modules
@pytest.mark.parametrize("rows,routed", [((1, 1), True), ((1, 1), False),
                                         ((2, 3), False)])
def test_apply_dense_with_bias(pair, jax_tune_cache, rows, routed):
    _, _, jp, tcfg, tp = pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal(rows + (tcfg.d_model,)).astype(np.float32)
    jpar = dict(layer(jp, 0)["mixer"]["wq"])
    jpar["b"] = jnp.asarray(rng.standard_normal(jpar["b"].shape), jnp.float32)
    tpar = torch.nn.ParameterDict({"w": tp["layers"][0]["mixer"]["wq"]["w"],
                                   "b": TM.frozen(t(np.asarray(jpar["b"])))})
    with JM.kernel_routing(routed), TM.kernel_routing(routed):
        want = JM.apply_dense(jpar, jnp.asarray(x), jnp.float32)
        got = TM.apply_dense(tpar, t(x), torch.float32)
    assert got.shape == tuple(want.shape)
    close(got, want)


@pytest.mark.parametrize("routed", [False, True])
def test_apply_norm(pair, jax_tune_cache, routed):
    _, _, jp, tcfg, tp = pair
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(tcfg.d_model)).astype(np.float32)
    with JM.kernel_routing(routed), TM.kernel_routing(routed):
        want = JM.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                             "rmsnorm", tcfg.norm_eps)
        got = TM.apply_norm({"scale": t(scale)}, t(x), "rmsnorm",
                            tcfg.norm_eps)
    close(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embedding_gradient_matches_jax(dtype):
    """The gradient of ``apply_embed`` with respect to an fp32 table, with
    each of 4 ids repeated ~100 times: the JAX package casts the whole
    table and gathers, so a repeated id's gradient rows add in the compute
    dtype; a table that takes a gradient does the same in the port.  The
    two are equal (in bf16 the adds round as in the JAX package, up to
    0.4 from the fp32 sum here), and the forward values are the rows'."""
    rng = np.random.default_rng(0)
    V, d, T = 16, 64, 200
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(0, 4, (2, T)).astype(np.int32)
    w = rng.standard_normal((2, T, d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_loss(tab):
        out = JM.apply_embed({"table": tab}, jnp.asarray(ids), jdt)
        return jnp.sum(out.astype(jnp.float32) * w)
    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(table)))
    tab = torch.tensor(table, requires_grad=True)
    out = TM.apply_embed({"table": tab}, torch.from_numpy(ids), tdt)
    (out.float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tab.grad.numpy(), want)
    with torch.no_grad():                 # serving: rows first, same values
        rows = TM.apply_embed({"table": tab}, torch.from_numpy(ids), tdt)
    assert torch.equal(rows, out)


def test_apply_rope(pair):
    _, _, _, tcfg, _ = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, tcfg.head_dim)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [37, 38, 39, 40, 41]], np.int32)
    want = JM.apply_rope(jnp.asarray(x), jnp.asarray(pos), tcfg.rope_theta)
    close(TM.apply_rope(t(x), torch.from_numpy(pos), tcfg.rope_theta), want)


def test_apply_mlp(pair):
    _, _, jp, tcfg, tp = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    want = JM.apply_mlp(layer(jp, 1)["ffn"], jnp.asarray(x), "swiglu",
                        jnp.float32)
    close(TM.apply_mlp(tp["layers"][1]["ffn"], t(x), "swiglu",
                       torch.float32), want)


def pools(rng, P, page, KV, hd):
    return (rng.standard_normal((P, page, KV, hd)).astype(np.float32),
            rng.standard_normal((P, page, KV, hd)).astype(np.float32))


def test_update_paged_cache_and_out_of_range(pair):
    """In-range rows land where JAX puts them; a position past the table is
    dropped by JAX and parked on the NULL page by the port (page 0 is never
    read as live data), so every other page agrees."""
    rng = np.random.default_rng(4)
    P, page, KV, hd, nblk = 9, 16, 2, 8, 4
    pool, _ = pools(rng, P, page, KV, hd)
    new = rng.standard_normal((3, 1, KV, hd)).astype(np.float32)
    bt = np.asarray([[3, 1, 7, 2], [4, 5, 6, 8], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([17, 63, nblk * page + 5], np.int32)
    want = JA.update_paged_cache(jnp.asarray(pool), jnp.asarray(new),
                                 jnp.asarray(pos), jnp.asarray(bt))
    got = TA.update_paged_cache(t(pool), t(new), torch.from_numpy(pos),
                                torch.from_numpy(bt))
    close(got[1:], np.asarray(want)[1:], 0)


@pytest.mark.parametrize("offset,valid", [([0, 20], [8, 3]), ([5, 33],
                                                              [8, 8])])
def test_update_paged_cache_chunk(pair, offset, valid):
    rng = np.random.default_rng(5)
    P, page, KV, hd, C = 9, 16, 2, 8, 8
    pool, _ = pools(rng, P, page, KV, hd)
    new = rng.standard_normal((2, C, KV, hd)).astype(np.float32)
    bt = np.asarray([[3, 1, 7, 2], [4, 5, 6, 8]], np.int32)
    args = [np.asarray(offset, np.int32), np.asarray(valid, np.int32), bt]
    want = JA.update_paged_cache_chunk(jnp.asarray(pool), jnp.asarray(new),
                                       *map(jnp.asarray, args))
    got = TA.update_paged_cache_chunk(t(pool), t(new),
                                      *map(torch.from_numpy, args))
    # pad rows all land on page 0 (duplicate indices: either write wins)
    close(got[1:], np.asarray(want)[1:], 0)


def attn_setup(rng, tcfg, B, nblk=4, page=16):
    P = 1 + B * nblk
    kp, vp = pools(rng, P, page, tcfg.num_kv_heads, tcfg.head_dim)
    bt = (rng.permutation(P - 1)[:B * nblk] + 1).reshape(B, nblk) \
        .astype(np.int32)
    return kp, vp, bt


@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_attention_decode_paged(pair, use_kernel):
    jcfg, _, jp, tcfg, tp = pair
    rng = np.random.default_rng(6)
    B = 2
    kp, vp, bt = attn_setup(rng, tcfg, B)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    pos = np.asarray([37, 5], np.int32)
    wo, wc = JA.apply_attention_decode_paged(
        layer(jp, 0)["mixer"], jcfg, jnp.asarray(x),
        JaxPagedKVCache(jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(pos),
        jnp.float32, jnp.asarray(bt))
    cache = PagedKVCache(t(kp), t(vp))
    got, _ = TA.apply_attention_decode_paged(
        tp["layers"][0]["mixer"], tcfg, t(x), cache, torch.from_numpy(pos),
        torch.float32, torch.from_numpy(bt), use_kernel=use_kernel)
    close(got, wo)
    close(cache.k_pool, wc.k_pool)
    close(cache.v_pool, wc.v_pool)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_attention_chunk_paged(pair, use_kernel):
    """A slab after a prefix hit (offset > 0) with pad rows; the pad rows'
    outputs are garbage on both sides, so only valid rows compare."""
    jcfg, _, jp, tcfg, tp = pair
    rng = np.random.default_rng(7)
    kp, vp, bt = attn_setup(rng, tcfg, 1)
    C, off, valid = 8, 21, 5
    x = rng.standard_normal((1, C, tcfg.d_model)).astype(np.float32)
    o, v = np.asarray([off], np.int32), np.asarray([valid], np.int32)
    wo, wc, _ = JA.apply_attention_chunk_paged(
        layer(jp, 1)["mixer"], jcfg, jnp.asarray(x),
        JaxPagedKVCache(jnp.asarray(kp), jnp.asarray(vp)), jnp.asarray(o),
        jnp.asarray(v), jnp.zeros((1,), jnp.int32), jnp.float32,
        jnp.asarray(bt))
    cache = PagedKVCache(t(kp), t(vp))
    got, _ = TA.apply_attention_chunk_paged(
        tp["layers"][1]["mixer"], tcfg, t(x), cache, torch.from_numpy(o),
        torch.from_numpy(v), torch.float32, torch.from_numpy(bt),
        use_kernel=use_kernel)
    close(got[:, :valid], np.asarray(wo)[:, :valid])
    close(cache.k_pool[1:], np.asarray(wc.k_pool)[1:])


# ------------------------------------------------------------------- slice
def step_caches(rng, jm, tcfg, B, S):
    """Identical random page pools for both packages (JAX: the stacked
    group tree of init_caches; the port: one PagedKVCache per layer)."""
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


@pytest.mark.parametrize("routed", [False, True])
def test_decode_step_matches_jax(pair, routed):
    jcfg, jm, jp, tcfg, tp = pair
    rng = np.random.default_rng(8)
    B = 3
    jc, tc, bt = step_caches(rng, jm, tcfg, B, 64)
    bt[2] = NULL_PAGE              # an idle slot's garbage row
    tokens = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.asarray([40, 7, 12], np.int32)
    want, _ = jm.decode_step(jp, {"tokens": jnp.asarray(tokens),
                                  "pos": jnp.asarray(pos),
                                  "block_tables": jnp.asarray(bt)}, jc)
    model = build_model(tcfg, params=tp, device="cpu")
    with TM.kernel_routing(routed):
        got, _ = model.decode_step({"tokens": torch.from_numpy(tokens),
                                    "pos": torch.from_numpy(pos),
                                    "block_tables": torch.from_numpy(bt)},
                                   tc)
    close(got[:2], np.asarray(want)[:2], 1e-4)


@pytest.mark.parametrize("routed", [False, True])
def test_chunk_prefill_step_matches_jax(pair, routed):
    jcfg, jm, jp, tcfg, tp = pair
    rng = np.random.default_rng(9)
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
