"""The stateless temperature sampler, and the bucketed engine's paths on a
small config, on the CPU.

The sampler (``serve.step.sample``) draws ``argmax(row / T - log(-log u))``
with ``u`` from a splitmix64 hash of (seed, slot, position, nonce, vocab
index) in int64 torch ops.  Its bits must equal a numpy uint64 reference;
its draws must follow ``softmax(row / T)`` (a chi-square test, p >= 1e-3,
over the bins whose expected count is at least 5) and JAX's
``categorical`` on the same row (a two-sample chi-square, p >= 1e-3);
identical slots draw differently, a new nonce changes a draw and the same
(seed, slot, pos, nonce) repeats it.  The JAX package's sampled bits come
from its PRNG and cannot be reproduced in torch: the two packages agree in
distribution, not bit for bit.

The engine, on the JAX package's small serving config
(``tests/test_prefix_cache.py``) with the port's own seed-0 init: the first
token stays greedy at a temperature (both prefill paths), the static
binding and ``capture=False`` give the same tokens, greedy and sampled,
one prefill binding a bucket, the chunked engine's streams equal the
bucketed one's, the two backends agree where a shape heuristic could not
find the slot axis, and the launcher serves the default engine.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import scipy.stats  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve.step import sample_keys  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import RuntimeConfig, build_model  # noqa: E402
from repro_torch.serve import (EngineConfig, Request,  # noqa: E402
                               ServingEngine, build_engine)
from repro_torch.serve.step import (make_serve_step, sample,  # noqa: E402
                                    sample_bits)

P_MIN = 1e-3
N_DRAWS = 1 << 16


def splitmix(z):
    with np.errstate(over="ignore"):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def numpy_bits(seed, slot, pos, nonce, vocab):
    key = splitmix(np.full(len(slot), seed, np.uint64))
    for part in (slot, pos, nonce):
        key = splitmix(key ^ np.asarray(part).astype(np.int64)
                       .astype(np.uint64))
    return splitmix(key[:, None] ^ np.arange(vocab, dtype=np.uint64)[None])


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**62 + 12345])
def test_sample_bits_equal_the_numpy_uint64_reference(seed):
    rng = np.random.default_rng(seed % 2**32)
    slot = np.arange(6)
    pos = rng.integers(0, 2**31 - 1, 6).astype(np.int32)
    nonce = rng.integers(0, 2**31 - 1, 6).astype(np.int32)
    got = sample_bits(seed, torch.from_numpy(slot), torch.from_numpy(pos),
                      torch.from_numpy(nonce), 300)
    want = numpy_bits(seed, slot, pos, nonce, 300)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def fixed_row(V=48, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(V)
                            .astype(np.float32) * 2)


def draws(row, T, n=N_DRAWS, seed=0):
    """``n`` draws from ``row``: slot 0 at positions 0..n-1 (one row each
    in a batch of ``n``: slot b is row b, so every draw has its own key)."""
    return sample(row.expand(n, -1), T, seed,
                  pos=torch.zeros(n, dtype=torch.int32)).numpy()


def chi2_p(counts, expected):
    """p of the chi-square test over the bins expected at least 5 times,
    the rest merged into one bin."""
    keep = expected >= 5
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    if exp[-1] < 5:
        obs, exp = obs[:-1], exp[:-1]
    return scipy.stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue


@pytest.mark.parametrize("T", [0.7, 1.0, 2.0])
def test_sampler_follows_softmax(T):
    row = fixed_row()
    got = draws(row, T)
    p = torch.softmax(row.double() / T, 0).numpy()
    counts = np.bincount(got, minlength=len(p))
    assert chi2_p(counts, p * len(got)) >= P_MIN


def test_sampler_agrees_with_jax_categorical():
    """A two-sample chi-square test of homogeneity between the port's
    draws and JAX's ``categorical(key, row / T)`` under the JAX package's
    per-slot keys, on the same row."""
    row, T, n = fixed_row(), 0.7, 1 << 14
    keys = sample_keys(jnp.zeros((n,), jnp.int32), n, seed=0)
    jd = np.asarray(jax.vmap(lambda k: jax.random.categorical(
        k, jnp.asarray(row.numpy()) / T))(keys))
    td = draws(row, T, n)
    V = len(row)
    table = np.stack([np.bincount(td, minlength=V),
                      np.bincount(jd, minlength=V)])
    expected = table.sum(0) / 2
    keep = expected >= 5
    table = np.concatenate([table[:, keep],
                            table[:, ~keep].sum(1, keepdims=True)], axis=1)
    if table[:, -1].sum() < 10:
        table = table[:, :-1]
    assert scipy.stats.chi2_contingency(table)[1] >= P_MIN


def test_same_key_repeats_and_a_new_nonce_changes_the_draw():
    row = fixed_row(V=512).expand(64, -1)
    pos = torch.arange(64, dtype=torch.int32)
    one = torch.ones(64, dtype=torch.int32)
    a = sample(row, 1.0, 7, pos, one)
    assert torch.equal(a, sample(row, 1.0, 7, pos, one))
    b = sample(row, 1.0, 7, pos, one + 1)
    assert not torch.equal(a, b)
    assert not torch.equal(sample_bits(7, pos.long(), pos, one, 8),
                           sample_bits(7, pos.long(), pos, one + 1, 8))
    assert not torch.equal(a, sample(row, 1.0, 8, pos, one))   # the seed


def small_model(kv="", dtype="bfloat16"):
    """The JAX package's small serving config (tests/test_prefix_cache.py)
    in the port, seed-0 weights of the port's own init."""
    cfg = dataclasses.replace(reduced(
        get_config("qwen1.5-0.5b"), num_layers=2, d_model=64, d_ff=128,
        vocab_size=128, num_heads=2, num_kv_heads=2, head_dim=32),
        dtype=dtype)
    return build_model(cfg, RuntimeConfig(kv_cache_dtype=kv), device="cpu",
                       seed=0)


def test_temperature_sampling_varies_across_identical_slots():
    """Identical rows and identical caches: only the per-slot fold can
    decorrelate them (vocab 128, 8 slots: equal only by collision)."""
    model = small_model(dtype="float32")
    step = make_serve_step(model, temperature=1.0)
    caches = model.init_caches(8, 32)
    tok, _ = step({"tokens": torch.full((8, 1), 5, dtype=torch.int32),
                   "pos": torch.full((8,), 3, dtype=torch.int32)}, caches)
    assert len(set(tok[:, 0].tolist())) > 1


def serve(eng, prompts, max_new=6, rid0=0):
    reqs = [Request(rid=rid0 + i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    finished = eng.run_until_drained()
    assert len(finished) == len(reqs) and all(r.done for r in reqs)
    return [r.out for r in reqs]


MIXED = [np.arange(1, 4 + 3 * i, dtype=np.int32) % 63 + 1 for i in range(6)]


@pytest.mark.parametrize("over", [
    dict(), dict(backend="paged"),
    dict(backend="paged", chunked_prefill=True, chunk_size=8)],
    ids=["dense", "paged", "chunked"])
def test_first_token_is_greedy_at_a_temperature(over):
    """Both prefill paths emit the greedy argmax as the first token at any
    temperature; the decode tokens after it are sampled (they leave the
    greedy streams)."""
    model = small_model()
    base = dict(min_bucket=4, slots=3, cache_len=64, **over)
    greedy = serve(build_engine(model, EngineConfig(**base)), MIXED, 8)
    hot = serve(build_engine(model, EngineConfig(**base, temperature=0.7,
                                                 seed=3)), MIXED, 8)
    assert [g[0] for g in greedy] == [h[0] for h in hot]
    assert greedy != hot


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_static_binding_equals_eager(backend, temperature):
    """The steps bound to static buffers (the card's captured graphs) and
    ``capture=False`` emit the same tokens, greedy and sampled; two
    engines on the same seed sample the same tokens (the sampler keeps no
    state)."""
    model = small_model()
    cfg = EngineConfig(backend=backend, min_bucket=4, slots=3, cache_len=64,
                       temperature=temperature, seed=5)
    runs = [serve(build_engine(model, cfg, capture=c), MIXED, max_new=8)
            for c in (True, False, True)]
    assert runs[0] == runs[1] == runs[2]


def test_one_prefill_binding_per_bucket():
    """6 prompt lengths in 3 buckets (min 4): one prefill binding each (the
    JAX engine's one compile per bucket), none new when the same length
    mix is served again, none with ``capture=False``."""
    model = small_model()
    lengths = [3, 4, 6, 8, 11, 15]
    prompts = [np.arange(1, n + 1, dtype=np.int32) % 63 + 1
               for n in lengths]
    cfg = EngineConfig(backend="paged", min_bucket=4, slots=4, cache_len=64)
    eng = build_engine(model, cfg)
    serve(eng, prompts, max_new=4)
    assert eng.prefill_traces <= 3
    assert set(eng.captures["prefill"].values()) == {1}
    before = eng.captures
    serve(eng, [p % 63 + 1 for p in prompts], max_new=4, rid0=10)
    assert eng.captures == before
    eager = build_engine(model, cfg, capture=False)
    serve(eager, prompts, max_new=4)
    assert eager.captures == {"prefill": {}, "decode": 0}
    assert eager.prefill_traces == 0


@pytest.mark.parametrize("kv", ["", "int8"], ids=["bf16", "int8"])
def test_chunked_matches_bucketed(kv):
    """The chunked engine emits the bucketed engine's streams on a mixed
    trace (bf16 pages; int8 pages, where the chunk stage keeps later slabs
    off the quantized pages), with one chunk binding in all."""
    model = small_model(kv)
    outs = {}
    for chunked in (False, True):
        kv_cfg = dict(page_size=32, kv_cache_dtype="int8") if kv else {}
        eng = ServingEngine(model, EngineConfig(
            backend="paged", chunked_prefill=chunked, min_bucket=4, slots=3,
            cache_len=64, chunk_size=8, **kv_cfg))
        outs[chunked] = serve(eng, MIXED, max_new=6)
        if chunked:
            assert eng.prefill_traces == 1
            m = eng.metrics()
            assert m["chunk_calls"] >= len(MIXED)
            assert 0 < m["chunk_utilization"] <= 1
    assert outs[True] == outs[False]


def test_dense_and_paged_agree_with_ambiguous_dims():
    """``slots == cache_len``: a KV leaf is (B, S, ...) with S == slots,
    which no shape heuristic can split into slot and position; the
    structural ``slot_axes`` can, so both backends agree token for token
    (the JAX package's tests/test_serve.py case)."""
    model = small_model()
    outs = {}
    for backend in ("dense", "paged"):
        eng = build_engine(model, EngineConfig(backend=backend, slots=8,
                                               cache_len=8, min_bucket=4))
        outs[backend] = serve(eng, [np.asarray([3 + i, 14, 15], np.int32)
                                    for i in range(3)], max_new=3)
    assert outs["paged"] == outs["dense"]


@pytest.mark.parametrize("args", [
    ["--backend", "dense"], [], ["--backend", "dense", "--temperature", "0.7"],
    ["--kv-cache-dtype", "int8", "--temperature", "0.7"]],
    ids=["dense", "paged", "dense-sampled", "paged-int8-sampled"])
def test_launcher_serves_the_default_engine(capsys, args):
    """No ``--chunked-prefill``: the bucketed engine, over ``--backend``
    (paged by default, as the JAX launcher)."""
    rc = launcher.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device",
                        "cpu", "--requests", "4", "--max-new", "4", *args])
    out = capsys.readouterr().out
    assert rc == 0 and "served 4/4 requests" in out
    backend = "dense" if "dense" in args else "paged"
    assert f"(backend={backend})" in out
    assert '"prefill_traces": ' in out and "chunk_calls" not in out


@pytest.mark.parametrize("flag", ["--kernel-decode", "--chunked-prefill"])
def test_launcher_refuses_what_the_dense_backend_cannot_do(flag):
    with pytest.raises(SystemExit, match="requires --backend paged"):
        launcher.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device",
                       "cpu", "--backend", "dense", flag])
