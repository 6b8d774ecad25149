"""The port's int8/int4 weights against the JAX package, on the CPU.

The same numpy inputs (and the same bridged weights) go through the JAX
package and the port:

* codes and scales of ``pack_int4`` / ``quantize`` (int8 and int4, axis -1
  and -2, groups of 128 and one group per row) and ``quantize_params(bits=8
  | 4)`` are byte-identical, the odd-K int4 -> int8 fallback and the raw
  MoE expert stacks of the reduced qwen2-moe-a2.7b included; int4 leaves
  cross the bridge unchanged;
* the plain versions of ``qgemv`` / ``batched_qgemv`` (int8 and int4, B in
  1, 2, 4, 8) and ``batched_mx_qgemv`` (fp4 and fp8) match the JAX oracles
  and the interpret-mode Pallas kernels within 1e-5 of sum |w x| per
  output (the same fp32 products summed in other orders);
  ``decode_attention_int8``'s within the tolerance of the paged int8 and
  dense decode tests (1e-5 in fp32, 2e-2 in bf16 outputs), on rows that
  see a key (a row that sees none gives 0 in the port, as row 10's);
* ``apply_dense`` on int weights matches the JAX one (fp32, 1e-5), routed
  or not (int weights dequantize in the graph either way);
* the slice as a whole: the reduced qwen1.5-0.5b engine in fp32 with int8
  or int4 weights, model-dtype or int8 pages and the prefix cache emits
  the JAX engine's greedy streams, and so does a one-slot engine;
* the tuner on the CPU: each of the four new names is tuned into the
  cache and answered from it, and ``tuned_kernel_configs`` returns the
  cached entries of ``qgemv`` and ``decode_attention_int8``.
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
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
import repro_torch.kernels as K  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import modules as TM  # noqa: E402
from repro_torch.quant import params as TQP  # noqa: E402
from repro_torch.quant import tensor as TQ  # noqa: E402
from repro_torch.serve import EngineConfig, Request, build_engine  # noqa

INTERPRET = TroopConfig(interpret=True)     # explicit: no tune-cache lookup


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def close(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def within_dot_bound(got, want, w, x):
    """|got - want| <= 1e-5 sum_k |w_nk x_k| for every output (w (N, K)
    fp32, x (K,) or (B, K))."""
    bound = 1e-5 * (np.abs(np.asarray(x, np.float32))
                    @ np.abs(np.asarray(w, np.float32)).T)
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert np.all(err <= bound), float((err - bound).max())


# ------------------------------------------------------- codes and scales
def test_int4_packing_byte_identical():
    rng = np.random.default_rng(0)
    q = rng.integers(-7, 8, (6, 10)).astype(np.int8)
    for axis in (-1, -2, 0):
        want = np.asarray(JQ.pack_int4(jnp.asarray(q), axis=axis))
        got = TQ.pack_int4(t(q, torch.int8), axis=axis)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            TQ.unpack_int4(got, axis=axis).numpy(), q)
    every = np.arange(-128, 128, dtype=np.int8)[:, None]   # all 256 bytes
    np.testing.assert_array_equal(
        TQ.unpack_int4(t(every, torch.int8), axis=0).numpy(),
        np.asarray(JQ.unpack_int4(jnp.asarray(every), axis=0)))
    with pytest.raises(ValueError, match="even extent"):
        TQ.pack_int4(t(q[:, :3], torch.int8))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("group_size", [128, None])
def test_quantize_int_byte_identical(bits, axis, group_size):
    """Groups of 128 along the axis, or one group per row (``None``)."""
    x = np.random.default_rng(1).standard_normal((256, 384)).astype(
        np.float32) * 10.0 ** np.random.default_rng(2).uniform(-2, 2, 384)
    x = x.astype(np.float32)
    want = JQ.quantize(jnp.asarray(x), bits=bits, group_size=group_size,
                       axis=axis)
    got = TQ.quantize(t(x), bits=bits, group_size=group_size, axis=axis)
    assert (got.bits, got.group_size, got.axis) == \
        (want.bits, want.group_size, want.axis)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(),
                                  np.asarray(want.scales))
    close(TQ.dequantize(got), JQ.dequantize(want), 0)


def test_quantize_rejects_other_bit_widths():
    with pytest.raises(ValueError, match="bits must be 8 or 4"):
        TQ.quantize(torch.ones(4, 32), bits=2)


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


@pytest.fixture(scope="module", params=[8, 4])
def int_pair(request, jax_pair):
    """The JAX tree quantized by the JAX package (int8 or int4, groups of
    128) and bridged."""
    jcfg, jm, jp, tcfg = jax_pair
    jq = JQP.quantize_params(jp, bits=request.param, group_size=128)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu",
                           dtype=torch.float32)
    return request.param, jcfg, jm, jq, tcfg, tq


def quantized_leaves(params):
    return {name: m for name, m in params.named_modules()
            if isinstance(m, TQ.QuantizedTensor)}


def test_quantize_params_int_quantizes_the_jax_leaves(int_pair, jax_pair):
    bits, _, _, jq, tcfg, tq = int_pair
    _, _, jp, _ = jax_pair
    raw = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                            dtype=torch.float32)
    mine = TQP.quantize_params(raw, bits=bits, group_size=128)
    got, bridged = quantized_leaves(mine), quantized_leaves(tq)
    assert sorted(got) == sorted(bridged)
    assert {n.split(".")[-2] for n in got} == {
        "wq", "wk", "wv", "wo", "wi_gate", "wi_up", "lm_head"}
    for name, qt in got.items():
        b = bridged[name]
        assert (qt.bits, qt.group_size, qt.axis, qt.fmt) == \
            (bits, 128, -2, "int") == (b.bits, b.group_size, b.axis, b.fmt)
        np.testing.assert_array_equal(qt.values.numpy(), b.values.numpy())
        np.testing.assert_array_equal(qt.scales.numpy(), b.scales.numpy())
    assert mine["embed"]["table"] is raw["embed"]["table"]
    js, ts = JQP.quantized_stats(jq), TQP.quantized_stats(mine)
    for k in ("quantized_bytes", "raw_bytes", "quantized_fp32_bytes"):
        assert ts[k] == js[k], k
    assert ts["quantized_leaves"] == 7 * tcfg.num_layers + 1


def test_bridge_carries_int4_leaves_unchanged(int_pair):
    """Codes, scales, bits, group and axis of every quantized JAX leaf,
    layer by layer, in the bridged tree."""
    bits, _, _, jq, tcfg, tq = int_pair
    layer = jlayer(jq, 1)
    for name in ("wq", "wo"):
        jw = layer["mixer"][name]["w"]
        tw = tq["layers"][1]["mixer"][name]["w"]
        assert isinstance(tw, TQ.QuantizedTensor)
        assert (tw.bits, tw.group_size, tw.axis, tw.fmt) == \
            (jw.bits, jw.group_size, jw.axis, jw.fmt)
        np.testing.assert_array_equal(tw.values.numpy(),
                                      np.asarray(jw.values))
        np.testing.assert_array_equal(tw.scales.numpy(),
                                      np.asarray(jw.scales))
        close(tw.dequantize(), JQ.dequantize(jw), 0)
    head = tq["lm_head"]["w"]
    assert head.values.shape == (tcfg.d_model // (2 if bits == 4 else 1),
                                 tcfg.vocab_size)
    np.testing.assert_array_equal(head.values.numpy(),
                                  np.asarray(jq["lm_head"]["w"].values))


def test_quantize_params_odd_extent_stays_int8_and_checks_the_group():
    """int4 packs row pairs along the contraction axis: an odd extent stays
    int8 (one group per row), as in the JAX package; a group that is not
    a multiple of the 32-row granule is refused."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((33, 64)).astype(np.float32)       # (in, out)
    jq = JQP.quantize_params({"wq": {"w": jnp.asarray(w)}}, bits=4)
    port = torch.nn.ModuleDict({"wq": torch.nn.ParameterDict(
        {"w": torch.nn.Parameter(t(w.T.copy()), requires_grad=False)})})
    got = TQP.quantize_params(port, bits=4)["wq"]["w"]
    want = jq["wq"]["w"]
    assert got.bits == want.bits == 8
    assert got.group_size == want.group_size == 33
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    with pytest.raises(ValueError, match="granule"):
        TQP.quantize_params(port, bits=8, group_size=48)
    with pytest.raises(AssertionError):
        JQP.quantize_params({"wq": {"w": jnp.asarray(w)}}, group_size=48)


def test_quantize_params_int_keeps_moe_expert_stacks_raw():
    """Reduced qwen2-moe-a2.7b: int weights quantize the attention, the
    shared expert and the read-out, and keep the expert stacks, the router
    and the shared gate raw, byte for byte as the JAX package."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2-moe-a2.7b")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config("qwen2-moe-a2.7b")),
                               dtype="float32")
    jm = jax_build_model(jcfg, JaxRuntimeConfig(remat="none"))
    jp = JM.unbox(jm.init(jax.random.PRNGKey(0)))
    jq = JQP.quantize_params(jp, bits=4)
    raw = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                            dtype=torch.float32)
    bridged = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg,
                                device="cpu", dtype=torch.float32)
    mine = TQP.quantize_params(raw, bits=4)
    got, want = quantized_leaves(mine), quantized_leaves(bridged)
    assert sorted(got) == sorted(want)
    for name, qt in got.items():
        np.testing.assert_array_equal(qt.values.numpy(),
                                      want[name].values.numpy())
        np.testing.assert_array_equal(qt.scales.numpy(),
                                      want[name].scales.numpy())
    ffn = mine["layers"][0]["ffn"]
    for k in ("wi_up", "wi_gate", "wo"):
        assert ffn[k]["w"] is raw["layers"][0]["ffn"][k]["w"]
    assert ffn["router"]["w"] is raw["layers"][0]["ffn"]["router"]["w"]
    assert isinstance(ffn["shared"]["wi_up"]["w"], TQ.QuantizedTensor)
    assert not isinstance(ffn["shared_gate"]["w"], TQ.QuantizedTensor)
    js, ts = JQP.quantized_stats(jq), TQP.quantized_stats(mine)
    for k in ("quantized_bytes", "raw_bytes", "quantized_fp32_bytes"):
        assert ts[k] == js[k], k
    # per layer q/k/v/o and the shared expert's three, then the read-out
    assert ts["quantized_leaves"] == 7 * tcfg.num_layers + 1


# ------------------------------------------------------- plain vs JAX
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B", [0, 1, 2, 4, 8])
def test_qgemv_plain_matches_jax(bits, B):
    """B = 0: the one-row ``qgemv``; else ``batched_qgemv`` of B rows."""
    rng = np.random.default_rng(4 + B)
    N, K = 128, 512
    w = rng.standard_normal((N, K)).astype(np.float32)
    x = rng.standard_normal((B, K) if B else (K,)).astype(np.float32)
    jq = JQ.quantize(jnp.asarray(w), bits=bits, group_size=128, axis=-1)
    tq = TQ.quantize(t(w), bits=bits, group_size=128, axis=-1)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), t(x, torch.bfloat16)
    if B:
        got = TK.batched_qgemv(tq.values, tq.scales, xt, bits=bits)
        kern = JK.batched_qgemv(jq.values, jq.scales, xj, INTERPRET,
                                bits=bits)
        oracle = JR.batched_qgemv(jq.values, jq.scales, xj, bits=bits)
    else:
        got = TK.qgemv(tq.values, tq.scales, xt, bits=bits)
        kern = JK.qgemv(jq.values, jq.scales, xj, INTERPRET, bits=bits)
        oracle = JR.qgemv(jq.values, jq.scales, xj, bits=bits)
    assert got.dtype == torch.float32
    assert got.shape == ((B, N) if B else (N,))
    wd = np.asarray(JQ.dequantize(jq))
    xf = xt.float().numpy()
    within_dot_bound(got.numpy(), oracle, wd, xf)
    within_dot_bound(got.numpy(), kern, wd, xf)


@pytest.mark.parametrize("elem", ["fp4", "fp8"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_batched_mx_qgemv_plain_matches_jax(elem, B):
    rng = np.random.default_rng(14 + B)
    K, N = 512, 256
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    x = rng.standard_normal((B, K)).astype(np.float32)
    jq = JQ.quantize_mx(jnp.asarray(w), elem=elem)
    tq = TQ.quantize_mx(t(w), elem=elem)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), t(x, torch.bfloat16)
    got = TK.batched_mx_qgemv(tq.values, tq.scales, xt)
    assert got.dtype == torch.float32 and got.shape == (B, N)
    wd = np.asarray(JQ.dequantize(jq)).T                     # (N, K)
    xf = xt.float().numpy()
    within_dot_bound(got.numpy(), JR.batched_mx_qgemv(jq.values, jq.scales,
                                                      xj), wd, xf)
    within_dot_bound(got.numpy(), JK.batched_mx_qgemv(
        jq.values, jq.scales, xj, INTERPRET), wd, xf)
    # the rows of the batch are the one-row GEMV's
    close(got[1 % B], TK.mx_qgemv(tq.values, tq.scales, xt[1 % B]), 1e-6)


def dense_int8_case(rng, B, H, KV, hd, S, lengths, dtype):
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    qj = jnp.asarray(q).astype(jdt)
    k8, ks = JQ.quantize_kv(jnp.asarray(k))
    v8, vs = JQ.quantize_kv(jnp.asarray(v))
    ln = np.asarray(lengths, np.int32)
    tdt = getattr(torch, dtype)
    port = (t(np.asarray(qj.astype(jnp.float32)), tdt),
            t(np.asarray(k8), torch.int8),
            t(np.asarray(ks.astype(jnp.float32)), torch.bfloat16),
            t(np.asarray(v8), torch.int8),
            t(np.asarray(vs.astype(jnp.float32)), torch.bfloat16),
            t(ln, torch.int32))
    return (qj, k8, ks, v8, vs, jnp.asarray(ln)), port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,lengths", [(4, 4, [64, 17]), (8, 2, [1, 50]),
                                          (6, 2, [0, 64])])
def test_decode_attention_int8_plain_matches_jax(dtype, H, KV, lengths):
    """G = 1, 4 and 3, full and short lengths; a row with no key (length
    0) gives 0 in the port (row 10's convention) and is left out of the
    comparison."""
    rng = np.random.default_rng(20 + H)
    hd, S = 64, 64
    jargs, targs = dense_int8_case(rng, 2, H, KV, hd, S, lengths, dtype)
    got = TK.decode_attention_int8(*targs)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, H, hd)
    seen = [b for b, n in enumerate(lengths) if n > 0]
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    oracle = np.asarray(JR.decode_attention_int8(*jargs).astype(jnp.float32))
    kern = np.asarray(JK.decode_attention_int8(*jargs, cfg=INTERPRET)
                      .astype(jnp.float32))
    close(got[seen], oracle[seen], tol)
    close(got[seen], kern[seen], tol)
    close(TR.decode_attention_int8(*targs)[seen], oracle[seen], tol)
    for b in set(range(2)) - set(seen):
        assert torch.all(got[b] == 0)


def test_new_wrappers_run_plain_on_cpu_and_do_not_count():
    TK.reset_launch_counts()
    for name in ("qgemv", "batched_qgemv", "batched_mx_qgemv",
                 "decode_attention_int8"):
        args, kw = tune.REGISTRY[name].example(small=True, device="cpu")
        got = getattr(TK, name)(*args, **kw)
        torch.testing.assert_close(got, TK.PLAIN[name](*args, **kw),
                                   rtol=0, atol=0)
    assert not any(TK.launch_counts().values())
    args, kw = tune.REGISTRY["qgemv"].example(small=True, device="cpu",
                                              bits=4)
    assert kw == {"bits": 4} and args[0].shape == (128, 256)


# ---------------------------------------------------------------- modules
def jlayer(jp, i):
    return jax.tree.map(lambda v: v[i], jp["groups"][0][0])


@pytest.mark.parametrize("rows,routed", [((1, 1), True), ((2, 3), False)])
def test_apply_dense_int(int_pair, rows, routed):
    """int weights dequantize in the graph, routed or not: the JAX
    package's ``apply_dense`` (no kernel takes them)."""
    _, _, _, jq, tcfg, tq = int_pair
    x = np.random.default_rng(10).standard_normal(
        rows + (tcfg.d_model,)).astype(np.float32)
    TK.reset_launch_counts()
    for name in ("wq", "wo"):                     # with and without a bias
        with JM.kernel_routing(routed), TM.kernel_routing(routed):
            want = JM.apply_dense(jlayer(jq, 1)["mixer"][name],
                                  jnp.asarray(x), jnp.float32)
            got = TM.apply_dense(tq["layers"][1]["mixer"][name], t(x),
                                 torch.float32)
        assert got.shape == tuple(want.shape)
        close(got, want)
    assert not any(TK.launch_counts().values())


# ------------------------------------------------------------------- slice
ENGINE = dict(slots=3, cache_len=96, backend="paged", chunked_prefill=True,
              chunk_size=8, prefix_cache=True)


def trace(slots=3):
    """A 40-token system prompt ahead of 24..40-token bodies, then two
    prompts that share a page and diverge inside the second (prefix hits
    and copy-on-write at both page sizes).  One slot's pool holds one
    request: the first four prompts, cut to the system prompt and 4
    tokens."""
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, 500, 40)
    prompts = [np.concatenate([sysp, rng.integers(1, 500, int(n))])
               for n in rng.integers(24, 41, 6)]
    base = rng.integers(1, 500, 72)
    b = base.copy()
    b[40] = 7
    prompts += [np.concatenate([base, [37, 2, 3]]),
                np.concatenate([b, [4, 5, 6]])]
    if slots == 1:
        prompts = [p[:44] for p in prompts[:4]]
    return [p.astype(np.int32) for p in prompts]


def engine_kw(bits, kv, slots):
    return dict(ENGINE, slots=slots, kv_cache_dtype=kv,
                quantize_weights=f"int{bits}")


@pytest.fixture(scope="module")
def served_jax(int_pair, tmp_path_factory):
    """The JAX engine's streams and metrics, by (kv dtype, slots)."""
    bits, jcfg, _, jq, _, _ = int_pair
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TUNE_CACHE",
              str(tmp_path_factory.mktemp("tune") / "tune.json"))
    out = {}
    try:
        for kv, slots in (("", 3), ("int8", 3), ("int8", 1)):
            model = jax_build_model(jcfg, JaxRuntimeConfig(
                remat="none", kv_cache_dtype=kv,
                quantize_weights=f"int{bits}"))
            eng = jax_build_engine(model, JaxEngineConfig(
                **engine_kw(bits, kv, slots)), params=jq)
            prompts = trace(slots)
            reqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            assert len(eng.run_until_drained()) == len(reqs)
            out[kv, slots] = {r.rid: r.out for r in reqs}, eng.metrics()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kv,slots,routed", [("", 3, True), ("int8", 3, True),
                                             ("int8", 3, False),
                                             ("int8", 1, True)])
def test_int_engine_token_identical_to_jax(int_pair, served_jax, kv, slots,
                                           routed):
    bits, _, _, _, tcfg, tq = int_pair
    want, jm = served_jax[kv, slots]
    eng = build_engine(build_model(tcfg, params=tq, device="cpu"),
                       EngineConfig(**engine_kw(bits, kv, slots)))
    assert eng.backend.spec.page_size == (32 if kv else 16)
    prompts = trace(slots)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
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
              "kv_bytes_streamed"):
        assert m[k] == jm[k], k
    be = eng.backend
    assert be.allocator.num_free == \
        be.spec.num_pages - 1 - be.prefix_index.num_pages


def test_build_engine_quantizes_int_weights_after_the_init():
    """The factory's own path: a native init quantized with ``bits`` and
    ``quantize_group_size`` (the JAX ``build_engine``), served."""
    tcfg = reduced(get_config("qwen1.5-0.5b"))
    eng = build_engine(tcfg, EngineConfig(**engine_kw(4, "int8", 2),
                                          quantize_group_size=64),
                       device="cpu")
    leaves = quantized_leaves(eng.model.params)
    assert len(leaves) == 7 * tcfg.num_layers + 1
    assert {(q.bits, q.group_size, q.fmt) for q in leaves.values()} == \
        {(4, 64, "int")}
    eng.submit(Request(rid=0, prompt=trace()[0], max_new_tokens=4))
    with TM.kernel_routing():
        assert len(eng.run_until_drained()) == 1


# ------------------------------------------------------------------ tuner
@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "tune_cache.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", path)
    return path


@pytest.mark.parametrize("name,bits", [("qgemv", 8), ("qgemv", 4),
                                       ("batched_qgemv", 8),
                                       ("batched_mx_qgemv", 8),
                                       ("decode_attention_int8", 8)])
def test_tuner_fills_and_reads_the_cache(tmp_cache, name, bits):
    spec = tune.REGISTRY[name]
    if name == "qgemv":
        args, kw = spec.example(small=True, device="cpu", bits=bits)
    else:
        args, kw = spec.example(small=True, device="cpu")
    first = tune.tune(name, *args, kernel_kwargs=kw, keep=2, iters=1)
    assert not first.from_cache and first.timings_run == 2
    assert ("|bits=4" in first.key) == (bits == 4)
    second = tune.tune(name, *args, kernel_kwargs=kw, keep=2, iters=1)
    assert second.from_cache and second.timings_run == 0
    assert second.best == first.best
    assert len(tune.default_cache()) == 1
    # the dispatching entry point takes the cached config
    torch.testing.assert_close(getattr(K, name)(*args, **kw),
                               TK.PLAIN[name](*args, **kw), rtol=0, atol=0)


def test_tuned_serve_configs_answer_qgemv_and_int8_decode(tmp_cache):
    """``tuned_kernel_configs`` returns the cached winners of the engine's
    read-out ``qgemv`` and dense ``decode_attention_int8`` keys."""
    from repro_torch.core.troop import DEFAULT, LaunchConfig
    from repro_torch.serve import tuned_kernel_configs
    from repro_torch.tune.registry import meta
    cfg = get_config("qwen1.5-0.5b")
    B, S = 8, 1024
    V, d = cfg.vocab_size, cfg.d_model
    KV, hd, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    bf = torch.bfloat16
    keys = {
        "qgemv": tune.REGISTRY["qgemv"].key(
            meta((V, d), torch.int8), meta((V, d // 128), torch.float32),
            meta((d,), bf)),
        "decode_attention_int8": tune.REGISTRY["decode_attention_int8"].key(
            meta((B, H, hd), bf), meta((B, S, KV, hd), torch.int8),
            meta((B, S, KV, 1), bf), meta((B, S, KV, hd), torch.int8),
            meta((B, S, KV, 1), bf), meta((B,), torch.int32)),
    }
    won = {"qgemv": LaunchConfig(block_n=128, unroll=2),
           "decode_attention_int8": LaunchConfig(streams=1, unroll=2,
                                                 block_k=256)}
    assert tuned_kernel_configs(cfg, B, S)["qgemv"] == DEFAULT
    cache = tune.default_cache()
    for name, key in keys.items():
        cache.put(key, {"config": tune.config_to_dict(won[name])})
    got = tuned_kernel_configs(cfg, B, S)
    assert got["qgemv"] == won["qgemv"]
    assert got["decode_attention_int8"] == won["decode_attention_int8"]
