"""The bucketed engine's parts against the JAX package, on the CPU.

The port's copies of the JAX package's bucketing and splicing helpers
(``bucket_length``, ``splice_row``, ``slot_axes``), its dense per-slot
cache write (``update_cache``), the full-sequence ``prefill`` that returns
the decode caches and the decode step over dense bf16 and int8 caches, fed
the same numpy inputs as their JAX counterparts (the JAX package's seed-0
weights, bridged, for the model steps).

Tolerances: helpers and cache writes compare exactly (they move values);
``prefill`` and the decode step at 1e-5 per op and 1e-4 per model step
(the same fp32 arithmetic summed in other orders), as
``test_torch_models.py``; int8 codes at one code step and their bf16
scales at 1e-2 relative (one bf16 ulp is 2^-8: an fp32 difference of 1e-7
can round the scale, and with it a code, the other way).
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
from repro.serve import kvcache as JK  # noqa: E402
from repro.serve.step import make_prefill_step as jax_prefill_step  # noqa
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import modules as TM  # noqa: E402
from repro_torch.serve import kvcache as TK  # noqa: E402
from repro_torch.serve.step import make_prefill_step  # noqa: E402

TOL, STEP_TOL = 1e-5, 1e-4
#: the head counts each reduced arch keeps: its group size (as
#: test_torch_archs.py)
HEADS = {"qwen1.5-0.5b": {}, "qwen2-moe-a2.7b": {},
         "glm4-9b": dict(num_heads=16, num_kv_heads=1),
         "qwen3-14b": dict(num_heads=10, num_kv_heads=2),
         "qwen1.5-32b": dict(num_heads=4, num_kv_heads=4)}


def t(a, dtype=None):
    x = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return x if dtype is None else x.to(dtype)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def codes_close(got, want):
    """int8 codes within one step of each other."""
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1


# ------------------------------------------------------------ bucket_length
@pytest.mark.parametrize("min_bucket", [1, 4, 8, 16])
@pytest.mark.parametrize("cap", [None, 8, 100, 1024])
def test_bucket_length_matches_jax(min_bucket, cap):
    got = [TK.bucket_length(n, min_bucket, cap) for n in range(0, 1100)]
    want = [JK.bucket_length(n, min_bucket, cap) for n in range(0, 1100)]
    assert got == want


# ------------------------------------------------------------ splice_row
SPLICES = {
    # name: (dst shape, src shape, row, slot, slots, axis)
    "slot axis 0": ((4, 10, 2, 3), (3, 6, 2, 3), 1, 2, 4, 0),
    "stacked layers": ((2, 4, 10, 2, 3), (2, 3, 6, 2, 3), 2, 0, 4, 1),
    "B=1 heuristic": ((4, 10, 2, 3), (1, 6, 2, 3), 0, 3, 4, None),
    "stacked B=1 heuristic": ((2, 4, 10, 2, 3), (2, 1, 6, 2, 3), 0, 1, 4,
                              None),
    "slot-independent": ((9, 16, 2, 3), (3, 6, 2, 3), 1, 2, 4, -1),
    "scales": ((4, 10, 2, 1), (3, 8, 2, 1), 2, 1, 4, 0),
}


@pytest.mark.parametrize("name", sorted(SPLICES))
def test_splice_row_matches_jax(name):
    dst_shape, src_shape, row, slot, slots, axis = SPLICES[name]
    rng = np.random.default_rng(0)
    dst = rng.standard_normal(dst_shape).astype(np.float32)
    src = rng.standard_normal(src_shape).astype(np.float32)
    if axis == -1:
        want = dst                 # the JAX helper leaves a pool alone
    else:
        want = np.asarray(JK.splice_row(jnp.asarray(dst), jnp.asarray(src),
                                        row, slot, slots, axis=axis))
    got = t(dst.copy())
    out = TK.splice_row(got, t(src), row, slot, slots, axis=axis)
    assert out is got              # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_splice_row_refuses_an_unknown_batch_dim_as_jax():
    dst, src = np.zeros((4, 10, 2)), np.zeros((3, 6, 2))
    with pytest.raises(ValueError, match="cannot locate batch dim"):
        JK.splice_row(jnp.asarray(dst), jnp.asarray(src), 0, 0, 4)
    with pytest.raises(ValueError, match="cannot locate batch dim"):
        TK.splice_row(t(dst), t(src), 0, 0, 4)


# ------------------------------------------------------------- slot_axes
def jax_model(arch="qwen1.5-0.5b", kv=""):
    cfg = dataclasses.replace(jax_reduced(jax_get_config(arch),
                                          **HEADS[arch]), dtype="float32")
    return jax_build_model(cfg, JaxRuntimeConfig(remat="none",
                                                 kv_cache_dtype=kv))


def port_model(arch="qwen1.5-0.5b", kv="", params=None):
    cfg = dataclasses.replace(reduced(get_config(arch), **HEADS[arch]),
                              dtype="float32")
    return build_model(cfg, RuntimeConfig(kv_cache_dtype=kv), params=params,
                       device="cpu")


# (kv dtype, page spec dtype or None, chunk stage); slots == cache_len in
# the last: the JAX package's ambiguous-dims case (tests/test_serve.py)
AXES = {"dense": ("", None, 0, 4, 64), "dense int8": ("int8", None, 0, 4, 64),
        "paged": ("", "bfloat16", 0, 4, 64),
        "paged int8 + stage": ("int8", "int8", 8, 4, 64),
        "ambiguous dense": ("", None, 0, 8, 8),
        "ambiguous dense int8": ("int8", None, 0, 8, 8)}


@pytest.mark.parametrize("case", sorted(AXES))
def test_slot_axes_match_jax(case):
    """Each tensor of each layer's cache: the port's slot axis is JAX's,
    less the JAX package's leading layer axis (it stacks the layers of a
    group; the port keeps a cache a layer); a shared pool and the chunk
    stage are slot-independent (-1).  With ``slots == cache_len`` the axis
    is still the slot's, where a shape heuristic would not know."""
    kv, spec_dtype, stage, slots, S = AXES[case]
    spec = None if spec_dtype is None else JK.PageSpec.for_engine(
        slots, S, 32, None, spec_dtype)
    jm, tm = jax_model(kv=kv), port_model(kv=kv)
    want = jax.tree.leaves(JK.slot_axes(jm, slots, S, page_spec=spec,
                                        chunk_stage=stage))
    tspec = None if spec is None else TK.PageSpec(*dataclasses.astuple(spec))
    got = TK.slot_axes(tm, slots, S, page_spec=tspec, chunk_stage=stage)
    assert len(got) == tm.cfg.num_layers
    per_layer = tuple(a - 1 if a > 0 else a for a in want)
    assert all(layer == per_layer for layer in got)
    assert set(per_layer) == ({-1} if spec is not None else {0})


def test_slot_axes_allocate_nothing(monkeypatch):
    """``slot_axes`` builds the caches on the ``meta`` device only."""
    seen = []
    real = TA.init_cache

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.extend(x.device.type for x in out if x is not None)
        return out
    monkeypatch.setattr(TA, "init_cache", spy)
    TK.slot_axes(port_model(), 4, 64)
    assert seen and set(seen) == {"meta"}


# ----------------------------------------------------------- update_cache
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_update_cache_drops_out_of_range_writes_as_jax(int8):
    """Positions past the end are dropped and a negative one counts from
    the end, as JAX's ``mode="drop"`` scatter: the port pins the same
    rows (row 1 and row 3 here leave the cache as it was)."""
    rng = np.random.default_rng(1)
    dtype = np.int8 if int8 else np.float32
    cache = (rng.integers(-127, 128, (4, 5, 2, 3)) if int8 else
             rng.standard_normal((4, 5, 2, 3))).astype(dtype)
    new = (rng.integers(-127, 128, (4, 1, 2, 3)) if int8 else
           rng.standard_normal((4, 1, 2, 3))).astype(dtype)
    pos = np.asarray([-1, 5, 2, 9], np.int32)
    want = np.asarray(JA.update_cache(jnp.asarray(cache), jnp.asarray(new),
                                      jnp.asarray(pos)))
    got = t(cache.copy())
    TA.update_cache(got, t(new), t(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[[1, 3]], cache[[1, 3]])
    np.testing.assert_array_equal(got.numpy()[0, 4], new[0, 0])


# ------------------------------------------------------------ model steps
@pytest.fixture(scope="module", params=sorted(HEADS))
def pair(request):
    """(arch, JAX model, JAX params, port params): the reduced arch at its
    group size in fp32, JAX's seed-0 init bridged."""
    arch = request.param
    jm = jax_model(arch)
    jp = JM.unbox(jm.init(jax.random.PRNGKey(0)))
    tcfg = port_model(arch).cfg
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu",
                           dtype=torch.float32)
    return arch, jm, jp, tp


def prompts(V, B=3, T=16):
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, V, (B, T)).astype(np.int32)
    length = np.asarray([T, 5, 1][:B], np.int32)
    for b, n in enumerate(length):
        tokens[b, n:] = 0                     # right-padded, as the engine
    return tokens, length


def jax_layer_caches(caches):
    """The JAX prefill / decode caches, one KVCache of stacked leaves."""
    (group,) = caches
    (entry,) = group
    return entry["mixer"]


@pytest.mark.parametrize("kv", ["", "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("routed", [False, True])
def test_prefill_matches_jax(pair, kv, routed):
    """Logits at every position, each layer's K and V (roped; int8 codes
    and scales under an int8 runtime), and the bucketed prefill step's
    tokens, which the port reads out after gathering each row's last
    valid position."""
    arch, _, jp, tp = pair
    jm = jax_model(arch, kv)
    tm = port_model(arch, kv, params=tp)
    tokens, length = prompts(tm.cfg.vocab_size)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    with TM.kernel_routing(routed):
        tl, tc = tm.prefill({"tokens": t(tokens)})
    close(tl, jl, STEP_TOL)
    want = jax_layer_caches(jc)
    assert len(tc) == tm.cfg.num_layers
    for i, c in enumerate(tc):
        assert c.quantized == bool(kv)
        if kv:
            codes_close(c.k, want.k[i])
            codes_close(c.v, want.v[i])
            for got, ref in ((c.k_scale, want.k_scale[i]),
                             (c.v_scale, want.v_scale[i])):
                np.testing.assert_allclose(got.float().numpy(),
                                           np.asarray(ref, np.float32),
                                           rtol=1e-2)
        else:
            close(c.k, want.k[i], STEP_TOL)
            close(c.v, want.v[i], STEP_TOL)
    jtok, _ = jax_prefill_step(jm)(jp, {"tokens": jnp.asarray(tokens),
                                        "length": jnp.asarray(length)})
    with TM.kernel_routing(routed):
        ttok, _ = make_prefill_step(tm)({"tokens": t(tokens),
                                         "length": t(length)})
    assert ttok.tolist() == np.asarray(jtok).tolist()
    # the gather before the read-out: the logits of the last valid rows
    gl, _ = tm.prefill({"tokens": t(tokens), "length": t(length)})
    close(gl, np.asarray(jl)[np.arange(len(length)), length - 1], STEP_TOL)


@pytest.mark.parametrize("kv", ["", "int8"], ids=["bf16", "int8"])
def test_dense_decode_step_matches_jax(pair, kv):
    """One decode step over dense caches filled with the same random rows
    (int8 codes and scales for the int8 cache): the logits, and the K/V
    row each slot writes at its position; the rest of the caches
    untouched."""
    arch, _, jp, tp = pair
    jm = jax_model(arch, kv)
    tm = port_model(arch, kv, params=tp)
    cfg = tm.cfg
    B, S, L = 3, 24, cfg.num_layers
    rng = np.random.default_rng(3)
    shape = (L, B, S, cfg.num_kv_heads, cfg.head_dim)
    if kv:
        leaves = [rng.integers(-127, 128, shape).astype(np.int8)
                  for _ in range(2)]
        # bf16 scales, held as the fp32 values they are
        leaves += [np.asarray(jnp.asarray(
            rng.uniform(0.01, 0.05, shape[:-1] + (1,)),
            jnp.bfloat16).astype(jnp.float32)) for _ in range(2)]
        dtypes = [None, None, torch.bfloat16, torch.bfloat16]
    else:
        leaves = [rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2)]
        dtypes = [None, None]
    jcache = [[{"mixer": JA.KVCache(*[
        jnp.asarray(x, None if d is None else jnp.bfloat16)
        for x, d in zip(leaves, dtypes)])}]]
    tcache = [TA.KVCache(*[t(x[i], d) for x, d in zip(leaves, dtypes)])
              for i in range(L)]
    tokens = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.asarray([0, 7, S - 1], np.int32)
    jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tokens),
                                 "pos": jnp.asarray(pos)}, jcache)
    tl, tc = tm.decode_step({"tokens": t(tokens), "pos": t(pos)}, tcache)
    close(tl, jl, STEP_TOL)
    want = jax_layer_caches(jc)
    b = np.arange(B)
    for i, c in enumerate(tc):
        for j, (got, ref, old) in enumerate(zip(c, want, leaves)):
            ref, old = np.asarray(ref[i]), old[i]
            keep = np.ones((B, S), bool)
            keep[b, pos] = False
            np.testing.assert_array_equal(got.float().numpy()[keep],
                                          old.astype(np.float32)[keep])
            if not kv:
                close(got[b, pos], ref[b, pos], STEP_TOL)
            elif j < 2:
                codes_close(got[b, pos], ref[b, pos])
            else:
                    np.testing.assert_allclose(
                    got[b, pos].float().numpy(),
                    ref[b, pos].astype(np.float32), rtol=1e-2)
