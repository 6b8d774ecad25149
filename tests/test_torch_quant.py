"""Port quantization against the JAX package, on the CPU.

The same numpy inputs (and the same bridged weights) go through the JAX
package and the port:

* codes and scales of ``fp4_encode`` / ``pack_fp4`` / ``quantize_mx`` (fp4
  and fp8) / ``quantize_kv`` / ``quantize`` are byte-identical, including
  blocks whose absmax sits at or just below a power of two;
* ``quantize_params`` quantizes the same leaves into the same bytes;
* the plain versions of ``mx_qgemv``, ``mx_qgemv_swiglu`` and
  ``paged_decode_attention_int8`` match the JAX oracles and the
  interpret-mode Pallas kernels;
* ``apply_dense`` / ``apply_mlp`` on MX weights, one decode and one chunk
  step over int8 pools (kernel route and plain route) match the JAX ones
  in fp32;
* the slice as a whole: the chunked + prefix-cache engine with int8 KV
  pages and mx4 (or fp8) weights emits the JAX engine's greedy streams.

Tolerances: fp32 at rtol=atol=1e-5 per op and 1e-4 per model step (the same
fp32 arithmetic summed in other orders; the MX dequantization factors are
the JAX package's own, ``exp(n * ln2)``); bf16 outputs at 2e-2 (both sides
round to bf16).
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
from repro.core.troop import TroopConfig  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.models import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import modules as JM  # noqa: E402
from repro.quant import params as JQP  # noqa: E402
from repro.quant import tensor as JQ  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import build_engine as jax_build_engine  # noqa: E402
from repro.serve.kvcache import ChunkStage as JaxChunkStage  # noqa: E402
from repro.serve.kvcache import PagedKVCache as JaxPagedKVCache  # noqa
from repro.serve.kvcache import PageSpec as JaxPageSpec  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import mx_gemv as TMX  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import modules as TM  # noqa: E402
from repro_torch.quant import params as TQP  # noqa: E402
from repro_torch.core import xla_cpu as XC  # noqa: E402
from repro_torch.quant import tensor as TQ  # noqa: E402
from repro_torch.serve import (ChunkStage, EngineConfig,  # noqa: E402
                               PagedKVCache, Request, build_engine)

INTERPRET = TroopConfig(interpret=True)     # explicit: no tune-cache lookup
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def u8(a) -> np.ndarray:
    """The bytes of a code array (fp8 codes viewed as uint8)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def power_of_two_blocks(rng, K, N):
    """(K, N) fp32 weights with blocks of every sort along K: random
    magnitudes over four decades, all-zero blocks, and blocks whose absmax
    is exactly 2^e or 1..5 ulps below it."""
    x = rng.standard_normal((K, N)) * 10.0 ** rng.uniform(-2, 2, (1, N))
    x = x.astype(np.float32)
    col = 0
    for e in range(-12, 13, 3):
        p = np.float32(2.0 ** e)
        for ulps in range(6):
            v = p
            for _ in range(ulps):
                v = np.nextafter(v, np.float32(0))
            blk = (rng.uniform(-1, 1, 32) * 0.9 * v).astype(np.float32)
            blk[rng.integers(32)] = v if col % 2 else -v
            x[32 * (col % (K // 32)):32 * (col % (K // 32)) + 32,
              col % N] = blk
            col += 1
    x[:32, -1] = 0.0
    return x


# ------------------------------------------------------- codes and scales
def test_fp4_encode_decode_and_packing_byte_identical():
    vals = np.concatenate([
        np.asarray(TQ.FP4_VALUES, np.float32),
        np.asarray([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0], np.float32),
        np.nextafter(np.asarray([0.25, 0.75, 2.5, 5.0], np.float32), 0),
        np.random.default_rng(0).uniform(-9, 9, 200).astype(np.float32)])
    vals = np.concatenate([vals, -vals])
    codes = TQ.fp4_encode(t(vals))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(JQ.fp4_encode(jnp.asarray(vals))))
    c = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(TQ.fp4_decode(t(c, torch.uint8)).numpy(),
                                  np.asarray(JQ.fp4_decode(jnp.asarray(c))))
    grid = np.random.default_rng(1).integers(0, 16, (6, 8)).astype(np.uint8)
    for axis in (-1, -2, 0):
        packed = TQ.pack_fp4(t(grid, torch.uint8), axis=axis)
        np.testing.assert_array_equal(
            packed.numpy(),
            np.asarray(JQ.pack_fp4(jnp.asarray(grid), axis=axis)))
        np.testing.assert_array_equal(
            TQ.unpack_fp4(packed, axis=axis).numpy(), grid)


# inputs where torch's fp32 log and XLA's differ by an ulp across an integer
# (ROADMAP §3): (exponent e, ulps below 2^e)
LOG2_DIFFERS = {(94, 13)}
# integer n where exp(n ln2) differs: 2^32 one ulp apart; XLA flushes the
# subnormal results 2^-126 and 2^-127 to zero
EXP2_DIFFERS = {32, -126, -127}


def test_exponent_and_factor_helpers_match_xla_near_powers_of_two():
    """The E8M0 exponent floor(log2 amax) on fp32 values 0..15 ulps below
    and 1..5 ulps above every normal power of two, and the block factors
    exp2(n) at every integer n, equal the JAX package's except at the
    inputs listed above."""
    xs, where = [], []
    for e in range(-125, 128):
        v = np.float32(2.0 ** e)
        for ulps in range(16):
            xs.append(v)
            where.append((e, ulps))
            v = np.nextafter(v, np.float32(0))
        v = np.float32(2.0 ** e)
        for up in range(1, 6):
            v = np.nextafter(v, np.float32(np.inf))
            xs.append(v)
            where.append((e, -up))
    x = np.asarray(xs, np.float32)
    ok = np.isfinite(x)
    want = np.asarray(jnp.floor(jnp.log2(jnp.asarray(x[ok]))))
    got = XC.floor_log2(t(x[ok])).numpy()
    differs = {tuple(w) for w, d in zip(np.asarray(where)[ok].tolist(),
                                        got != want) if d}
    assert differs == LOG2_DIFFERS
    n = np.arange(-127, 128).astype(np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(n)))
    got = XC.exp2(t(n)).numpy()
    assert set(n[got != want].astype(int).tolist()) == EXP2_DIFFERS


@pytest.mark.parametrize("elem", ["fp4", "fp8"])
@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_mx_byte_identical(elem, axis):
    x = power_of_two_blocks(np.random.default_rng(2), 256, 72)
    if axis == -1:
        x = np.ascontiguousarray(x.T)
    want = JQ.quantize_mx(jnp.asarray(x), elem=elem, axis=axis)
    got = TQ.quantize_mx(t(x), elem=elem, axis=axis)
    assert (got.bits, got.group_size, got.axis, got.fmt) == \
        (want.bits, want.group_size, want.axis, want.fmt)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(u8(got.values), u8(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    # the same codes times the same factors exp((s - 127) ln2)
    np.testing.assert_array_equal(TQ.dequantize(got).numpy(),
                                  np.asarray(JQ.dequantize(want)))


def test_quantize_mx_odd_extent_falls_back_to_fp8_and_one_block():
    x = np.random.default_rng(3).standard_normal((45, 16)).astype(np.float32)
    want = JQ.quantize_mx(jnp.asarray(x), elem="fp4")
    got = TQ.quantize_mx(t(x), elem="fp4")
    assert (got.bits, got.group_size) == (want.bits, want.group_size) == \
        (8, 45)
    np.testing.assert_array_equal(u8(got.values), u8(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_byte_identical(dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 32, 4, 64))
         * 10.0 ** rng.uniform(-3, 2, (5, 32, 4, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                                 # eps-floored scale
    x[1, 0, 0, 3] = 2.0 ** -4 * 127                  # scale exactly 2^-4
    jq, js = JQ.quantize_kv(jnp.asarray(x).astype(getattr(jnp, dtype)))
    tq, ts = TQ.quantize_kv(t(x, getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    np.testing.assert_array_equal(
        TQ.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(JQ.dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("group_size,axis", [(None, -1), (64, -2),
                                             (None, None)])
def test_quantize_int8_byte_identical(group_size, axis):
    x = np.random.default_rng(5).standard_normal((128, 48)).astype(np.float32)
    want = JQ.quantize(jnp.asarray(x), bits=8, group_size=group_size,
                       axis=axis)
    got = TQ.quantize(t(x), bits=8, group_size=group_size, axis=axis)
    assert (got.group_size, got.axis) == (want.group_size, want.axis)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(),
                                  np.asarray(want.scales))
    close(TQ.dequantize(got), JQ.dequantize(want), 0)


# ------------------------------------------------------------ weight trees
@pytest.fixture(scope="module")
def jax_pair():
    """Reduced qwen1.5-0.5b in fp32: (jax cfg, jax model, raw jax params,
    port cfg)."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen1.5-0.5b")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                               dtype="float32")
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat="none"))
    jp = JM.unbox(jm.init(jax.random.PRNGKey(0)))
    return jcfg, jm, jp, tcfg


@pytest.fixture(scope="module", params=["mx4", "fp8"])
def mx_pair(request, jax_pair):
    """The JAX tree MX-quantized by the JAX package and bridged."""
    jcfg, jm, jp, tcfg = jax_pair
    jq = JQP.quantize_params(jp, fmt=request.param)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu",
                           dtype=torch.float32)
    return request.param, jcfg, jm, jq, tcfg, tq


def quantized_leaves(params):
    return {name: m for name, m in params.named_modules()
            if isinstance(m, TQ.QuantizedTensor)}


def test_quantize_params_quantizes_the_jax_leaves(mx_pair, jax_pair):
    fmt, _, _, jq, tcfg, tq = mx_pair
    _, _, jp, _ = jax_pair
    raw = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                            dtype=torch.float32)
    mine = TQP.quantize_params(raw, fmt=fmt)
    got, bridged = quantized_leaves(mine), quantized_leaves(tq)
    assert sorted(got) == sorted(bridged)
    assert {n.split(".")[-2] for n in got} == {
        "wq", "wk", "wv", "wo", "wi_gate", "wi_up", "lm_head"}
    for name, qt in got.items():
        np.testing.assert_array_equal(u8(qt.values), u8(bridged[name].values))
        np.testing.assert_array_equal(qt.scales.numpy(),
                                      bridged[name].scales.numpy())
    # the raw leaves are shared, not copied, and left raw
    assert mine["embed"]["table"] is raw["embed"]["table"]
    assert isinstance(raw["lm_head"]["w"], torch.nn.Parameter)
    js, ts = JQP.quantized_stats(jq), TQP.quantized_stats(mine)
    for k in ("quantized_bytes", "raw_bytes", "quantized_fp32_bytes"):
        assert ts[k] == js[k], k
    assert ts["quantized_leaves"] == 7 * tcfg.num_layers + 1


# ------------------------------------------------------- plain vs JAX
@pytest.mark.parametrize("elem", ["fp4", "fp8"])
def test_mx_qgemv_plain_matches_jax(elem):
    rng = np.random.default_rng(6)
    K, N = 512, 128
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    x = rng.standard_normal(K).astype(np.float32)
    jq = JQ.quantize_mx(jnp.asarray(w), elem=elem)
    tq = TQ.quantize_mx(t(w), elem=elem)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), t(x, torch.bfloat16)
    got = TK.mx_qgemv(tq.values, tq.scales, xt)
    assert got.dtype == torch.float32 and got.shape == (N,)
    close(got, JR.mx_qgemv(jq.values, jq.scales, xj))
    close(got, JK.mx_qgemv(jq.values, jq.scales, xj, cfg=INTERPRET))


@pytest.mark.parametrize("elem", ["fp4", "fp8"])
def test_mx_qgemv_swiglu_plain_matches_jax(elem):
    rng = np.random.default_rng(7)
    d, f = 256, 128
    ws = [(rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
          for _ in range(2)]
    x = rng.standard_normal(d).astype(np.float32)
    jg, ju = (JQ.quantize_mx(jnp.asarray(w), elem=elem) for w in ws)
    tg, tu = (TQ.quantize_mx(t(w), elem=elem) for w in ws)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), t(x, torch.bfloat16)
    got = TK.mx_qgemv_swiglu(tg.values, tg.scales, tu.values, tu.scales, xt)
    jargs = (jg.values, jg.scales, ju.values, ju.scales, xj)
    close(got, JR.mx_qgemv_swiglu(*jargs))
    close(got, JK.mx_qgemv_swiglu(*jargs, cfg=INTERPRET))


def int8_paged_case(rng, B, H, KV, hd, page, nblk):
    """q, int8 pools + bf16 scale pages (the JAX quantize_kv of random
    pools) and a permuted block table, as numpy arrays."""
    P = 1 + B * nblk
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    pools = []
    for _ in range(2):
        p = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
        q8, s = JQ.quantize_kv(jnp.asarray(p))
        pools += [np.asarray(q8), np.asarray(s.astype(jnp.float32))]
    bt = (rng.permutation(P - 1)[:B * nblk] + 1).reshape(B, nblk)
    return q, pools, bt.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_int8_plain_matches_jax(dtype):
    rng = np.random.default_rng(8)
    q, (k8, ks, v8, vs), bt = int8_paged_case(rng, 2, 4, 2, 32, 32, 3)
    ln = np.asarray([37, 90], np.int32)          # mid-page end, odd nblk
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    args_j = (jnp.asarray(q).astype(jd), jnp.asarray(k8),
              jnp.asarray(ks).astype(jnp.bfloat16), jnp.asarray(v8),
              jnp.asarray(vs).astype(jnp.bfloat16), jnp.asarray(bt),
              jnp.asarray(ln))
    got = TK.paged_decode_attention_int8(
        t(q, td), t(k8, torch.int8), t(ks, torch.bfloat16),
        t(v8, torch.int8), t(vs, torch.bfloat16), t(bt, torch.int32),
        t(ln, torch.int32))
    assert got.dtype == td and got.shape == q.shape
    close(got, JR.paged_decode_attention_int8(*args_j), TOL[dtype])
    close(got, JK.paged_decode_attention_int8(*args_j, cfg=INTERPRET),
          TOL[dtype])


def test_paged_decode_int8_gqa_plain_matches_jax():
    """G = 5 (qwen3-14b's 40 query heads on 8 KV heads, cut to 10 on 2):
    five query heads share each int8 page and its scales."""
    rng = np.random.default_rng(10)
    q, (k8, ks, v8, vs), bt = int8_paged_case(rng, 2, 10, 2, 32, 32, 3)
    ln = np.asarray([65, 32], np.int32)          # a page and one, a page
    args_j = (jnp.asarray(q), jnp.asarray(k8),
              jnp.asarray(ks).astype(jnp.bfloat16), jnp.asarray(v8),
              jnp.asarray(vs).astype(jnp.bfloat16), jnp.asarray(bt),
              jnp.asarray(ln))
    got = TK.paged_decode_attention_int8(
        t(q), t(k8, torch.int8), t(ks, torch.bfloat16), t(v8, torch.int8),
        t(vs, torch.bfloat16), t(bt, torch.int32), t(ln, torch.int32))
    assert got.shape == (2, 10, 32)
    close(got, JR.paged_decode_attention_int8(*args_j), TOL["float32"])
    close(got, JK.paged_decode_attention_int8(*args_j, cfg=INTERPRET),
          TOL["float32"])


def test_new_wrappers_run_plain_on_cpu_and_do_not_count():
    TK.reset_launch_counts()
    rng = np.random.default_rng(9)
    qt = TQ.quantize_mx(t(rng.standard_normal((64, 32))))
    x = t(rng.standard_normal(64), torch.bfloat16)
    TK.mx_qgemv(qt.values, qt.scales, x)
    TK.mx_qgemv_swiglu(qt.values, qt.scales, qt.values, qt.scales, x)
    assert TK.launch_counts() == {k: 0 for k in TK.launch_counts()}
    meta = torch.empty((32, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TK.mx_qgemv(meta, meta[:2], x.to("meta"))


def test_mx_split_policy_gives_every_split_a_block():
    """``batched_mx_qgemv``'s K split (``batched_plan``): every warp of a
    tile walks at least one round of E8M0 blocks, for one and two
    n-tiles, at both block sizes of the tuner's space."""
    from repro_torch.core.troop import LaunchConfig
    for nkb in range(1, 300):
        for N in (16, 512, 1024, 2816, 151936):
            for sms in (1, 132):
                for B, block_n in ((1, 256), (16, 128)):
                    plan = TMX.batched_plan(N, 32 * nkb, 4, B, LaunchConfig(
                        block_n=block_n), sms)
                    ks, rb = plan.ksplit, plan.round_blocks
                    assert 1 <= ks <= plan.warps and (ks - 1) * rb < nkb
    cfg = LaunchConfig()
    assert TMX.batched_plan(151936, 1024, 4, 8, cfg, 132).ksplit == 4
    assert TMX.batched_plan(1024, 1024, 4, 8, cfg, 132).ksplit == 4
    assert TMX.batched_plan(1024, 2816, 4, 8, cfg, 132).ksplit == 8


# ---------------------------------------------------------------- modules
@pytest.fixture
def jax_tune_cache(monkeypatch, tmp_path):
    """Routed JAX layers dispatch their Pallas kernels through the tune
    cache: point it at an empty file so the lookup is the heuristic."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))


def jlayer(jp, i):
    return jax.tree.map(lambda v: v[i], jp["groups"][0][0])


@pytest.mark.parametrize("rows,routed", [((1, 1), True), ((1, 1), False),
                                         ((2, 3), True)])
def test_apply_dense_mx(mx_pair, jax_tune_cache, rows, routed):
    _, _, _, jq, tcfg, tq = mx_pair
    x = np.random.default_rng(10).standard_normal(
        rows + (tcfg.d_model,)).astype(np.float32)
    for name in ("wq", "wo"):                     # with and without a bias
        with JM.kernel_routing(routed), TM.kernel_routing(routed):
            want = JM.apply_dense(jlayer(jq, 1)["mixer"][name],
                                  jnp.asarray(x), jnp.float32)
            got = TM.apply_dense(tq["layers"][1]["mixer"][name], t(x),
                                 torch.float32)
        assert got.shape == tuple(want.shape)
        close(got, want)


@pytest.mark.parametrize("rows,routed", [((1, 1), True), ((2, 3), True),
                                         ((1, 1), False)])
def test_apply_mlp_mx(mx_pair, jax_tune_cache, rows, routed):
    _, _, _, jq, tcfg, tq = mx_pair
    x = np.random.default_rng(11).standard_normal(
        rows + (tcfg.d_model,)).astype(np.float32)
    with JM.kernel_routing(routed), TM.kernel_routing(routed):
        want = JM.apply_mlp(jlayer(jq, 0)["ffn"], jnp.asarray(x), "swiglu",
                            jnp.float32)
        got = TM.apply_mlp(tq["layers"][0]["ffn"], t(x), "swiglu",
                           torch.float32)
    close(got, want)


# ------------------------------------------------------------ model steps
def int8_step_caches(rng, jm, tcfg, B, S, chunk_stage=0):
    """Identical random int8 pools + scale pages (and stage rows) for both
    packages: JAX's stacked group tree, the port's per-layer leaves."""
    spec = JaxPageSpec.for_engine(B, S, 32, dtype="int8")
    L, KV, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    shape = (L, spec.num_pages, 32, KV, hd)
    k8, v8 = (rng.integers(-127, 128, shape).astype(np.int8)
              for _ in range(2))
    ks, vs = (np.asarray(jnp.asarray(rng.uniform(0.005, 0.05, shape[:-1]
                                                 + (1,)), jnp.bfloat16)
                         .astype(jnp.float32)) for _ in range(2))
    jc = jm.init_caches(B, S, page_spec=spec, chunk_stage=chunk_stage)
    jc[0][0]["mixer"] = JaxPagedKVCache(
        *(jnp.asarray(a) for a in (k8, v8)),
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (ks, vs)))
    stage = None
    if chunk_stage:
        sshape = jc[0][0]["stage"].k.shape
        stage = [np.asarray(jnp.asarray(rng.standard_normal(sshape),
                                        jnp.bfloat16).astype(jnp.float32))
                 for _ in range(2)]
        jc[0][0]["stage"] = JaxChunkStage(
            *(jnp.asarray(a).astype(jnp.bfloat16) for a in stage))
    tc = [PagedKVCache(
        t(k8[i], torch.int8), t(v8[i], torch.int8),
        t(ks[i], torch.bfloat16), t(vs[i], torch.bfloat16),
        None if stage is None else ChunkStage(t(stage[0][i], torch.bfloat16),
                                              t(stage[1][i], torch.bfloat16)))
        for i in range(L)]
    bt = (rng.permutation(spec.num_pages - 1)[:B * spec.blocks_per_slot]
          + 1).reshape(B, spec.blocks_per_slot).astype(np.int32)
    return jc, tc, bt


@pytest.mark.parametrize("B,routed", [(3, False), (3, True), (1, True)])
def test_decode_step_int8_mx_matches_jax(mx_pair, B, routed):
    """B = 3 (one slot idle) runs the many-row dequant projections and, when
    routed, the int8 attention kernel's route; B = 1 routed also takes
    mx_qgemv and mx_qgemv_swiglu."""
    _, jcfg, jm, jq, tcfg, tq = mx_pair
    rng = np.random.default_rng(12)
    jc, tc, bt = int8_step_caches(rng, jm, tcfg, B, 96)
    if B > 1:
        bt[-1] = 0                   # an idle slot's garbage row
    tokens = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.asarray([40, 7, 12][:B], np.int32)
    batch = {"tokens": tokens, "pos": pos, "block_tables": bt}
    want, wc = jm.decode_step(jq, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, jc)
    model = build_model(tcfg, params=tq, device="cpu")
    with TM.kernel_routing(routed):
        got, _ = model.decode_step({k: torch.from_numpy(v)
                                    for k, v in batch.items()}, tc)
    live = B - 1 if B > 1 else 1
    close(got[:live], np.asarray(want)[:live], 1e-4)
    jk = np.asarray(wc[0][0]["mixer"].k_scale_pool[1])
    close(tc[1].k_scale_pool[1:], jk[1:], 1e-2)


@pytest.mark.parametrize("routed", [False, True])
def test_chunk_step_int8_mx_matches_jax(mx_pair, routed):
    """A slab after a 16-token shared prefix (stage_base 16) at offset 19
    with pad rows: the gathered int8 view under the bf16 stage overlay."""
    _, jcfg, jm, jq, tcfg, tq = mx_pair
    rng = np.random.default_rng(13)
    C = 8
    jc, tc, bt = int8_step_caches(rng, jm, tcfg, 1, 96, chunk_stage=C)
    off, valid = 19, 6
    tokens = np.zeros((1, C), np.int32)
    tokens[0, :valid] = rng.integers(1, tcfg.vocab_size, valid)
    batch = {"tokens": tokens, "offset": np.asarray([off], np.int32),
             "valid": np.asarray([valid], np.int32),
             "stage_base": np.asarray([16], np.int32), "block_tables": bt}
    want, wc = jm.chunk_step(jq, {k: jnp.asarray(v)
                                  for k, v in batch.items()}, jc)
    model = build_model(tcfg, params=tq, device="cpu")
    with TM.kernel_routing(routed):
        got, _ = model.chunk_step({k: torch.from_numpy(v)
                                   for k, v in batch.items()}, tc)
    close(got, want, 1e-4)
    close(tc[1].stage.k, np.asarray(wc[0][0]["stage"].k[1]), 2e-2)


# ------------------------------------------------------------------- slice
ENGINE = dict(slots=3, cache_len=96, backend="paged", chunked_prefill=True,
              chunk_size=8, prefix_cache=True, kv_cache_dtype="int8")


def trace():
    """A 40-token system prompt (one full 32-row page + 8 rows: later
    requests copy-on-write the second page) ahead of 24..40-token bodies,
    then two prompts that share a page and diverge inside the second."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, 500, 40)
    prompts = [np.concatenate([sysp, rng.integers(1, 500, int(n))])
               for n in rng.integers(24, 41, 6)]
    base = rng.integers(1, 500, 72)
    b = base.copy()
    b[40] = 7
    prompts += [np.concatenate([base, [37, 2, 3]]),
                np.concatenate([b, [4, 5, 6]])]
    return [p.astype(np.int32) for p in prompts]


@pytest.fixture(scope="module")
def served_jax_int8(mx_pair, tmp_path_factory):
    """The JAX int8-KV + MX engine's streams and metrics."""
    fmt, jcfg, _, jq, _, _ = mx_pair
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TUNE_CACHE",
              str(tmp_path_factory.mktemp("tune") / "tune.json"))
    try:
        model = jax_build_model(jcfg, JaxRuntimeConfig(
            remat="none", kv_cache_dtype="int8", quantize_weights=fmt))
        eng = jax_build_engine(model, JaxEngineConfig(
            **ENGINE, quantize_weights=fmt), params=jq)
        reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(trace())]
        for r in reqs:
            eng.submit(r)
        assert len(eng.run_until_drained()) == len(reqs)
    finally:
        mp.undo()
    assert eng.backend.spec.kv_dtype == "int8"
    return {r.rid: r.out for r in reqs}, eng.metrics()


@pytest.mark.parametrize("routed", [False, True])
def test_int8_mx_engine_token_identical_to_jax(mx_pair, served_jax_int8,
                                               routed):
    fmt, _, _, _, tcfg, tq = mx_pair
    want, jm = served_jax_int8
    eng = build_engine(build_model(tcfg, params=tq, device="cpu"),
                       EngineConfig(**ENGINE, quantize_weights=fmt))
    assert eng.backend.spec.kv_dtype == "int8"
    assert eng.backend.spec.page_size == 32
    assert eng.caches[0].stage is not None
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(trace())]
    for r in reqs:
        eng.submit(r)
    with TM.kernel_routing(routed):
        finished = eng.run_until_drained()
    assert len(finished) == len(reqs) and all(r.done for r in reqs)
    assert {r.rid: r.out for r in reqs} == want
    m = eng.metrics()
    assert m["prefix_hits"] >= 1 and m["cow_copies"] >= 2
    for k in ("prefix_hits", "cow_copies", "prefix_shared_tokens",
              "chunk_calls", "decode_steps", "tokens_generated",
              "kv_bytes_streamed"):
        assert m[k] == jm[k], k
    be = eng.backend
    total = be.spec.num_pages - 1
    assert be.allocator.num_free == total - be.prefix_index.num_pages
    assert all(n == 1 for n in be.allocator._refs.values())
    be.prefix_index.clear()
    assert be.allocator.num_free == total
