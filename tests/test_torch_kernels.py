"""Port kernels: each plain version against the JAX oracle
(``repro.kernels.ref``) and the interpret-mode Pallas kernel on the same
numpy inputs (the CUDA kernels against their plain versions are in
``test_torch_cuda.py``).

Tolerances: fp32 inputs at rtol=atol=1e-5 (the same fp32 arithmetic summed
in another order); bf16 inputs at 2e-2 (both sides round their output to
bf16, whose 8-bit mantissa holds ~3 significant digits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.troop import TroopConfig  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

INTERPRET = TroopConfig(interpret=True)     # explicit: no tune-cache lookup
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def both(a, dtype):
    """One numpy array as (jax array, torch CPU tensor) in ``dtype`` (both
    round fp32 -> bf16 to nearest even)."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def paged_case(rng, B, H, KV, hd, page, nblk):
    """q, pools and a permuted block table (physically scattered pages)."""
    P = 1 + B * nblk
    q = rng.standard_normal((B, H, hd))
    kp = rng.standard_normal((P, page, KV, hd))
    vp = rng.standard_normal((P, page, KV, hd))
    bt = (rng.permutation(P - 1)[:B * nblk] + 1).reshape(B, nblk)
    return q, kp, vp, bt.astype(np.int32)


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("T,d,dtype", [(8, 256, "float32"),
                                       (3, 1024, "bfloat16")])
def test_rmsnorm_plain_matches_jax(T, d, dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal((T, d)), dtype)
    s = 1 + 0.1 * rng.standard_normal(d)
    sj, st = both(s, "float32")
    got = TK.rmsnorm(xt, st)
    assert got.dtype == xt.dtype
    close(got, JR.rmsnorm(xj, sj), dtype)
    close(got, JK.rmsnorm(xj, sj, cfg=INTERPRET), dtype)


# --------------------------------------------------------------------- gemv
@pytest.mark.parametrize("N,K,dtype", [(64, 256, "float32"),
                                       (48, 352, "float32"),   # K not 2^n
                                       (32, 2816, "bfloat16")])
def test_gemv_plain_matches_jax(N, K, dtype):
    rng = np.random.default_rng(1)
    wj, wt = both(rng.standard_normal((N, K)) / np.sqrt(K), dtype)
    xj, xt = both(rng.standard_normal(K), dtype)
    got = TK.gemv(wt, xt)
    assert got.dtype == torch.float32 and got.shape == (N,)
    close(got, JR.gemv(wj, xj), dtype)
    close(got, JK.gemv(wj, xj, cfg=INTERPRET), dtype)


# ------------------------------------------------------- paged decode attn
@pytest.mark.parametrize("B,H,KV,hd,page,nblk,lengths,dtype", [
    (2, 4, 2, 32, 16, 4, [37, 64], "float32"),   # mid-page end, GQA
    (2, 4, 4, 32, 16, 3, [48, 21], "bfloat16"),  # odd nblk: one stream
    (2, 10, 2, 32, 16, 4, [53, 16], "float32"),  # G = 5 (qwen3-14b's)
])
def test_paged_decode_plain_matches_jax(B, H, KV, hd, page, nblk, lengths,
                                        dtype):
    rng = np.random.default_rng(2)
    q, kp, vp, bt = paged_case(rng, B, H, KV, hd, page, nblk)
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (q, kp, vp))
    ln = np.asarray(lengths, np.int32)
    args_j = (qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln))
    got = TK.paged_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                    torch.from_numpy(ln))
    assert got.dtype == qt.dtype and got.shape == (B, H, hd)
    close(got, JR.paged_decode_attention(*args_j), dtype)
    close(got, JK.paged_decode_attention(*args_j, cfg=INTERPRET), dtype)


# ------------------------------------------------------ paged prefill attn
@pytest.mark.parametrize("B,C,H,KV,hd,page,nblk,offsets,valid,dtype", [
    # slot 1 starts mid-sequence (a prefix hit) with a partial final slab
    (2, 8, 4, 2, 32, 16, 4, [0, 7], [8, 5], "float32"),
    (1, 8, 4, 4, 32, 16, 3, [19], [8], "bfloat16"),      # odd nblk
])
def test_prefill_paged_plain_matches_jax(B, C, H, KV, hd, page, nblk,
                                         offsets, valid, dtype):
    rng = np.random.default_rng(3)
    _, kp, vp, bt = paged_case(rng, B, H, KV, hd, page, nblk)
    q = rng.standard_normal((B, C, H, hd))
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (q, kp, vp))
    off = np.asarray(offsets, np.int32)
    ln = off + np.asarray(valid, np.int32)
    args_j = (qj, kj, vj, jnp.asarray(bt), jnp.asarray(off), jnp.asarray(ln))
    got = TK.prefill_attention_paged(qt, kt, vt, torch.from_numpy(bt),
                                     torch.from_numpy(off),
                                     torch.from_numpy(ln))
    assert got.dtype == qt.dtype and got.shape == (B, C, H, hd)
    want_ref = np.asarray(JR.prefill_attention_paged(*args_j), np.float32)
    want_pallas = np.asarray(
        JK.prefill_attention_paged(*args_j, cfg=INTERPRET), np.float32)
    for b in range(B):            # pad rows (r >= valid) are garbage
        v = valid[b]
        close(got[b, :v], want_ref[b, :v], dtype)
        close(got[b, :v], want_pallas[b, :v], dtype)


@pytest.mark.parametrize("H,KV", [(10, 2), (32, 2)])     # G = 5 and 16
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_paged_gqa_plain_matches_jax(H, KV, dtype):
    """The G = 5 (qwen3-14b) and G = 16 (glm4-9b) query heads of a KV head
    over the same pages, two slabs at different offsets (a prefix hit), a
    length that ends mid-page: test_prefill_paged_plain_matches_jax's
    tolerance."""
    rng = np.random.default_rng(11)
    B, C, hd, page, nblk = 2, 8, 32, 16, 4
    _, kp, vp, bt = paged_case(rng, B, H, KV, hd, page, nblk)
    q = rng.standard_normal((B, C, H, hd))
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (q, kp, vp))
    off = np.asarray([0, 37], np.int32)
    valid = [8, 6]
    ln = off + np.asarray(valid, np.int32)               # 8 and 43
    args_j = (qj, kj, vj, jnp.asarray(bt), jnp.asarray(off), jnp.asarray(ln))
    got = TK.prefill_attention_paged(qt, kt, vt, torch.from_numpy(bt),
                                     torch.from_numpy(off),
                                     torch.from_numpy(ln))
    assert got.dtype == qt.dtype and got.shape == (B, C, H, hd)
    want_ref = np.asarray(JR.prefill_attention_paged(*args_j), np.float32)
    want_pallas = np.asarray(
        JK.prefill_attention_paged(*args_j, cfg=INTERPRET), np.float32)
    for b in range(B):            # pad rows (r >= valid) are garbage
        v = valid[b]
        close(got[b, :v], want_ref[b, :v], dtype)
        close(got[b, :v], want_pallas[b, :v], dtype)


# ------------------------------------------------------------ wrapper rules
def test_cpu_wrappers_run_plain_and_do_not_count():
    TK.reset_launch_counts()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 64)).astype(np.float32))
    torch.testing.assert_close(TK.rmsnorm(x, torch.ones(64)),
                               TR.rmsnorm(x, torch.ones(64)))
    TK.gemv(torch.ones(4, 64), x[0])
    assert TK.launch_counts() == {k: 0 for k in TK.launch_counts()}


@pytest.mark.parametrize("name", ["rmsnorm", "gemv"])
def test_wrapper_raises_off_cpu_without_kernel(name):
    """A tensor that is neither on the CPU nor on a CUDA card is refused:
    a wrapper never falls back to the plain version off the CPU."""
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if name == "rmsnorm":
            TK.rmsnorm(x, torch.empty(64, device="meta"))
        else:
            TK.gemv(x, torch.empty(64, device="meta"))


# ------------------------------------------------- the paper's three kernels
STREAMS = [TroopConfig(streams=1, interpret=True),
           TroopConfig(streams=2, interpret=True)]


@pytest.mark.parametrize("cfg", STREAMS, ids=["streams1", "streams2"])
@pytest.mark.parametrize("n,dtype", [(4096, "float32"), (65536, "bfloat16"),
                                     (4096, "bfloat16")])
def test_dotp_plain_matches_jax(n, dtype, cfg):
    """The same fp32 products summed in another order: |delta| within 1e-5
    of sum |x_i y_i|."""
    rng = np.random.default_rng(5)
    (xj, xt), (yj, yt) = (both(rng.standard_normal(n), dtype)
                          for _ in range(2))
    got = TK.dotp(xt, yt)
    assert got.shape == () and got.dtype == torch.float32
    bound = 1e-5 * float((xt.float() * yt.float()).abs().sum())
    for want in (JR.dotp(xj, yj), JK.dotp(xj, yj, cfg)):
        assert abs(float(got) - float(want)) <= bound


def ulps(got, want, scale, dtype):
    """|got - want| in units of the last place of ``dtype`` at ``scale``."""
    g, w, s = (np.asarray(a, np.float64) for a in (got, want, scale))
    eps = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}[dtype]
    spacing = eps * 2.0 ** np.floor(np.log2(np.maximum(np.abs(s), 1e-30)))
    return np.abs(g - w) / spacing


@pytest.mark.parametrize("cfg", STREAMS, ids=["streams1", "streams2"])
@pytest.mark.parametrize("n,dtype", [(4096, "float32"), (65536, "bfloat16")])
def test_axpy_plain_matches_jax(n, dtype, cfg, record_property):
    """Expected bit-equal (one fp32 multiply and one add, then a rounding
    to y's dtype); held to one ulp of the output dtype at the operands'
    scale, max(|a x|, |y|, |a x + y|), with the count of differing elements
    reported: the interpret-mode Pallas kernel contracts the two into one
    fused multiply-add, which differs from two roundings by up to half an
    ulp of a x — many ulps of the result where a x + y cancels."""
    rng = np.random.default_rng(6)
    (xj, xt), (yj, yt) = (both(rng.standard_normal(n), dtype)
                          for _ in range(2))
    got = TK.axpy(1.7, xt, yt)
    assert got.dtype == yt.dtype and got.shape == (n,)
    g = got.float().numpy()
    xf, yf = xt.float().numpy(), yt.float().numpy()
    for name, want in (("ref", JR.axpy(1.7, xj, yj)),
                       ("pallas", JK.axpy(1.7, xj, yj, cfg))):
        w = np.asarray(want, np.float32)
        differing = int(np.sum(g != w))
        record_property(f"differing_{name}", differing)
        scale = np.maximum(np.maximum(np.abs(1.7 * xf), np.abs(yf)),
                           np.abs(w))
        assert ulps(g, w, scale, dtype).max() <= 1, (name, differing)


@pytest.mark.parametrize("B,N,K,dtype", [(3, 64, 256, "float32"),
                                         (8, 48, 352, "float32"),
                                         (16, 32, 2816, "bfloat16")])
def test_batched_gemv_plain_matches_jax(B, N, K, dtype):
    """gemv of every row: test_gemv_plain_matches_jax's tolerance."""
    rng = np.random.default_rng(7)
    wj, wt = both(rng.standard_normal((N, K)) / np.sqrt(K), dtype)
    xj, xt = both(rng.standard_normal((B, K)), dtype)
    got = TK.batched_gemv(wt, xt)
    assert got.dtype == torch.float32 and got.shape == (B, N)
    close(got, JK.batched_gemv(wj, xj, INTERPRET), dtype)
    for b in range(B):
        close(got[b], JR.gemv(wj, xj[b]), dtype)


@pytest.mark.parametrize("N,K,warps,want", [
    (2048, 4096, 8, 8),      # 128 tiles: the 8 warps of a block split K
    (2048, 4096, 16, 16),
    (2048, 4096, 4, 4),
    (151936, 1024, 8, 1),    # the read-out: 9,496 tiles fill the card
    (1000, 1032, 8, 4),      # 17 steps of 64: 4 warps keep 4 steps each
    (64, 5632, 6, 2),        # 2 divides 6 warps, 4 does not
])
def test_batched_gemv_split_k(N, K, warps, want):
    """The warps of a batched-GEMV block that share one 16-row tile on a
    card of 132 SMs: a power of two that divides the block's warps, leaves
    each warp four steps of K in flight, and stops once the tiles' warps
    reach 16 an SM."""
    from repro_torch.kernels.gemv import split_k
    got = split_k(N, K, warps, 132)
    assert got == want and warps % got == 0


@pytest.mark.parametrize("N,K,vec", [
    (151936, 1024, 8), (151936, 2048, 8),    # the two read-outs
    (60, 2048, 4),                            # the MoE router, fp32
    (1024, 1024, 8), (2816, 1024, 8), (1024, 2816, 8), (1408, 2048, 8),
    (2048, 1408, 8), (2048, 5632, 8), (1000, 1032, 8), (33, 100, 4),
    (1, 2048, 8)])
@pytest.mark.parametrize("warps", [4, 8, 16, 6])
def test_gemv_ksplit(N, K, vec, warps):
    """The warps of a one-row GEMV block that share a row on a card of 132
    SMs: 1 at both read-outs (so their order of adds is one warp's), more at
    the router and at (1024, 1024); always a divisor of the block's warps;
    every split keeps at least one whole step of 64 16-byte vectors; the
    rows' warps stay within 32 an SM unless the split is 1."""
    from repro_torch.kernels.gemv import gemv_ksplit
    got = gemv_ksplit(N, K, vec, warps, 132)
    assert got >= 1 and warps % got == 0
    assert got == 1 or (got * 64 * vec <= K and got * N <= 32 * 132)
    if N == 151936:
        assert got == 1
    if (N, K) in ((60, 2048), (1024, 1024)) and warps % 2 == 0:
        assert got > 1
    # the largest such split: doubling it would break one of the rules
    assert (warps % (2 * got) or 2 * got * 64 * vec > K
            or 2 * got * N > 32 * 132)


# ------------------------------------------------- dense decode attention
def dense_case(rng, B, H, KV, hd, S, dtype):
    return [both(rng.standard_normal(shape), dtype)
            for shape in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.mark.parametrize("cfg", STREAMS, ids=["streams1", "streams2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_stats_plain_matches_jax(dtype, cfg):
    """Partials against the interpret-mode Pallas kernel: acc / l / out
    within 1e-5 in fp32 (as the paged decode test in bf16) on the rows that
    see a position; on rows with length <= s_offset m is exactly -1e30 in
    both, and the port's acc and l are 0 (the JAX kernel's masked walk
    sums exp(0) = 1 per masked position there instead)."""
    rng = np.random.default_rng(8)
    B, H, KV, hd, S, off = 4, 8, 2, 32, 256, 64
    (qj, qt), (kj, kt), (vj, vt) = dense_case(rng, B, H, KV, hd, S, dtype)
    ln = np.asarray([off, 20, 150, S + off], np.int32)   # 0, 0, 86, 256
    acc, m, l = TK.decode_attention_stats(qt, kt, vt, torch.from_numpy(ln),
                                          s_offset=off)
    G = H // KV
    assert acc.shape == (B, KV, G, hd) and m.shape == l.shape == (B, KV, G, 1)
    assert all(t.dtype == torch.float32 for t in (acc, m, l))
    jacc, jm, jl = (np.asarray(t, np.float32) for t in JK.decode_attention_stats(
        qj, kj, vj, jnp.asarray(ln), cfg, s_offset=off))
    empty = ln <= off
    assert (m[torch.from_numpy(empty)] == np.float32(-1e30)).all()
    assert (jm[empty] == np.float32(-1e30)).all()
    assert not acc[torch.from_numpy(empty)].any()
    assert not l[torch.from_numpy(empty)].any()
    live = ~empty
    close(m[torch.from_numpy(live)], jm[live], dtype)
    close(l[torch.from_numpy(live)], jl[live], dtype)
    close(acc[torch.from_numpy(live)], jacc[live], dtype)
    out = TK.decode_attention(qt, kt, vt, torch.from_numpy(ln - off))
    assert out.dtype == qt.dtype and out.shape == (B, H, hd)
    assert not out[torch.from_numpy(empty)].float().any()
    jout = np.asarray(JK.decode_attention(qj, kj, vj,
                                          jnp.asarray(ln - off), cfg),
                      np.float32)
    close(out[torch.from_numpy(live)], jout[live], dtype)
    close(out[torch.from_numpy(live)],
          np.asarray(JR.decode_attention(qj, kj, vj, jnp.asarray(ln - off)),
                     np.float32)[live], dtype)


@pytest.mark.parametrize("H,KV", [(10, 2), (32, 2)])     # G = 5 and 16
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_stats_gqa_plain_matches_jax(H, KV, dtype):
    """G = 5 and G = 16 query heads of a KV head, S not a multiple of a
    tile, against the interpret-mode Pallas partials and the JAX oracle:
    test_decode_attention_stats_plain_matches_jax's tolerance and empty-row
    convention."""
    rng = np.random.default_rng(12)
    B, hd, S, off = 3, 32, 200, 40
    (qj, qt), (kj, kt), (vj, vt) = dense_case(rng, B, H, KV, hd, S, dtype)
    ln = np.asarray([off, 117, S + off], np.int32)       # 0, 77, 200 valid
    acc, m, l = TK.decode_attention_stats(qt, kt, vt, torch.from_numpy(ln),
                                          s_offset=off)
    G = H // KV
    assert acc.shape == (B, KV, G, hd) and m.shape == l.shape == (B, KV, G, 1)
    jacc, jm, jl = (np.asarray(t, np.float32) for t in JK.decode_attention_stats(
        qj, kj, vj, jnp.asarray(ln), INTERPRET, s_offset=off))
    assert (m[0] == np.float32(-1e30)).all() and (jm[0] == np.float32(-1e30)).all()
    assert not acc[0].any() and not l[0].any()
    close(m[1:], jm[1:], dtype)
    close(l[1:], jl[1:], dtype)
    close(acc[1:], jacc[1:], dtype)
    out = TK.decode_attention(qt, kt, vt, torch.from_numpy(ln - off))
    assert out.shape == (B, H, hd) and not out[0].float().any()
    close(out[1:], np.asarray(JR.decode_attention(
        qj, kj, vj, jnp.asarray(ln - off)), np.float32)[1:], dtype)


def test_decode_stats_lse_combine_split_s():
    """Two halves through decode_attention_stats and lse_combine equal the
    whole, as tests/test_kernels.py holds the JAX kernel (and a row that
    only the first half sees, and one no half sees, combine to the whole
    and to 0)."""
    rng = np.random.default_rng(9)
    B, H, KV, hd, S = 3, 8, 4, 64, 512
    (qj, qt), (kj, kt), (vj, vt) = dense_case(rng, B, H, KV, hd, S,
                                              "float32")
    ln = np.asarray([200, 512, 0], np.int32)
    lt = torch.from_numpy(ln)
    half = S // 2
    parts = [TK.decode_attention_stats(qt, kt[:, i * half:(i + 1) * half],
                                       vt[:, i * half:(i + 1) * half], lt,
                                       s_offset=i * half) for i in range(2)]
    got = TK.lse_combine(parts).reshape(B, H, hd)
    whole = TK.decode_attention(qt, kt, vt, lt)
    torch.testing.assert_close(got, whole, rtol=2e-4, atol=2e-4)
    want = np.asarray(JR.decode_attention(qj, kj, vj, jnp.asarray(ln)),
                      np.float32)
    close(got[:2], want[:2], "float32")
    assert not got[2].any()                       # 0, not NaN


def test_lse_combine_matches_jax():
    """The combine itself, on the same partials, as JAX's."""
    rng = np.random.default_rng(10)
    parts = []
    for i in range(3):
        acc = rng.standard_normal((2, 2, 3, 16)).astype(np.float32)
        m = rng.standard_normal((2, 2, 3, 1)).astype(np.float32)
        l = rng.random((2, 2, 3, 1)).astype(np.float32) + 0.5
        parts.append((acc, m, l))
    got = TK.lse_combine([tuple(torch.from_numpy(a) for a in p)
                          for p in parts])
    want = JK.lse_combine([tuple(jnp.asarray(a) for a in p) for p in parts])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------- the tensor-core launch plans
@pytest.mark.parametrize("blocks,S,resident,want", [
    (32, 4096, 132, 4),      # kernel_bench's decode, one block an SM
    (128, 1024, 264, 2),     # 8 slots x 16 KV heads, two an SM
    (8, 4096, 132, 16),      # glm4-9b's 2 KV heads: 256 positions a split
    (16, 1024, 264, 4),      # the engine's slab: 1024 / 256
    (300, 4096, 264, 1),     # more blocks than a wave: no split
    (16, 17, 264, 1),        # one short walk
])
def test_wave_splits(blocks, S, resident, want):
    """The tensor-core kernels' splits: one wave of the blocks the card
    holds at once, none shorter than 256 positions, at least one."""
    from repro_torch.kernels.decode_attention import wave_splits
    got = wave_splits(blocks, S, resident)
    assert got == want
    assert got == 1 or got * blocks <= resident


@pytest.mark.parametrize("B,H,KV,S", [(4, 16, 8, 4096), (8, 16, 16, 1024),
                                       (3, 10, 2, 200), (3, 32, 2, 512),
                                       (1, 64, 2, 300)])
def test_decode_plan(B, H, KV, S):
    """The dense decode's launch at every tuner candidate and the tests'
    (1|2, 4, 128): one block per (slot, KV head, split, m-tile of 16 query
    heads), a grid >= 1 in each dimension, BN = block_k / 4 positions a
    tile in BN / 16 warps, as many splits as ``wave_splits`` gives for the
    blocks of one split, and the ring depth ``unroll`` asks for."""
    from repro_torch.core.troop import LaunchConfig
    from repro_torch.kernels.decode_attention import decode_plan, wave_splits
    for streams, unroll, block_k in [(s, u, k) for s in (1, 2)
                                     for u in (1, 2) for k in (256, 512)] + [
            (1, 4, 128), (2, 4, 128)]:
        cfg = LaunchConfig(streams=streams, unroll=unroll, block_k=block_k)
        plan = decode_plan(B, H, KV, S, cfg, 264)
        gx, gy, gz = plan["grid"]
        assert (gx, gz) == (B * KV, -(-(H // KV) // 16))
        assert gy == plan["nsplit"] == wave_splits(gx * gz, S, 264) >= 1
        assert plan["warps"] * 16 == plan["bn"] == block_k // 4
        assert plan["bn"] % (16 * streams) == 0
        assert plan["stages"] == (2 if unroll == 1 else 3)


@pytest.mark.parametrize("B,H,KV,S,want_tiles", [
    (8, 16, 16, 1024, 1),       # the qwen1.5-0.5b engine's dense shape
    (4, 16, 8, 4096, 1),        # kernel_bench's (the registry's example)
    (4, 32, 2, 4096, 1),        # glm4-9b's heads: G = 16, one m-tile
    (3, 10, 2, 300, 1)])        # G = 5, S not a whole tile
@pytest.mark.parametrize("resident", [132, 264, 528])
def test_decode_plan_int8(B, H, KV, S, want_tiles, resident):
    """The int8 dense decode's launch (``decode_plan`` with its own
    kernel's residency) at every candidate of its tuner space: one block
    per (slot, KV head, split, m-tile), as many splits as fill one wave of
    what the card holds (none shorter than 256 positions), block_k / 4
    positions a tile, 16 a warp, and the ring depth ``unroll`` asks for."""
    from repro_torch import tune
    from repro_torch.kernels.decode_attention import decode_plan
    from repro_torch.tune.search import enumerate_space
    spec = tune.REGISTRY["decode_attention_int8"]
    cfgs = list(enumerate_space(spec))
    assert len(cfgs) == 4 and all(c.streams == 1 for c in cfgs)
    for cfg in cfgs:
        plan = decode_plan(B, H, KV, S, cfg, resident)
        gx, gy, gz = plan["grid"]
        assert (gx, gz) == (B * KV, want_tiles)
        assert gy == plan["nsplit"]
        assert gy == max(1, min(resident // (gx * gz), -(-S // 256)))
        assert gy == 1 or gy * gx * gz <= resident
        assert plan["bn"] == cfg.block_k // 4 == 16 * plan["warps"]
        assert plan["stages"] == (2 if cfg.unroll == 1 else 3)


@pytest.mark.parametrize("warps", [2, 4, 8])
@pytest.mark.parametrize("C,H,KV", [(32, 16, 16), (32, 10, 2), (32, 32, 2),
                                    (8, 4, 4), (5, 16, 16)])
def test_prefill_plan(warps, C, H, KV):
    """The paged prefill's block: ``warps`` = row-tile warps x position
    warps, the row tiles cover the slab's C x G rows, a grid >= 1 in each
    dimension, as many splits as fill a wave, and more for a table longer
    than one split's page list."""
    from repro_torch.kernels.decode_attention import wave_splits
    from repro_torch.kernels.prefill_attention import prefill_plan
    plan = prefill_plan(1, C, H, KV, 16, 64, warps, 264, 256)
    gx, gy, gz = plan["grid"]
    assert gx == KV and gy >= 1 and gz >= 1
    assert gy == plan["nsplit"] == wave_splits(gx * gz, 64 * 16, 264)
    long = prefill_plan(1, C, H, KV, 16, 9000, warps, 264, 256)["nsplit"]
    assert long == max(wave_splits(gx * gz, 9000 * 16, 264), 36)
    assert plan["wm"] * plan["wn"] == warps and plan["bn"] % 16 == 0
    assert plan["nw"] * plan["wn"] == plan["bn"] and plan["nw"] % 16 == 0
    assert 16 * plan["wm"] * gz >= C * (H // KV) > 16 * plan["wm"] * (gz - 1)
    with pytest.raises(ValueError, match="prefill_warps"):
        prefill_plan(1, C, H, KV, 16, 64, 3, 264, 256)


def test_resident_asks_each_entry_point_once(monkeypatch):
    """The blocks the card holds at once, per (device, entry point,
    arguments): a ctypes entry point (unhashable) asked once, times the
    SMs."""
    import ctypes
    from repro_torch.kernels import _build
    calls = []
    libc = ctypes.CDLL(None)
    occ = libc.abs
    occ.argtypes, occ.restype = [ctypes.c_int], ctypes.c_int
    monkeypatch.setattr(_build, "_sm_count", lambda index: calls.append(
        index) or 132)
    monkeypatch.setattr(_build, "_RESIDENT", {})
    dev = torch.device("cuda", 0)
    assert _build.resident(dev, occ, -2) == 264
    assert _build.resident(dev, occ, -2) == 264 and calls == [0]
    assert _build.resident(dev, occ, 3) == 396 and calls == [0, 0]


def test_resident_refuses_a_kernel_that_cannot_launch(monkeypatch):
    """An occupancy of 0 (parameters the kernel cannot launch with) raises
    instead of turning into one split, and is asked again next time."""
    import ctypes
    from repro_torch.kernels import _build
    libc = ctypes.CDLL(None)
    occ = libc.abs
    occ.argtypes, occ.restype = [ctypes.c_int], ctypes.c_int
    monkeypatch.setattr(_build, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "_RESIDENT", {})
    dev = torch.device("cuda", 0)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="cannot launch"):
            _build.resident(dev, occ, 0)
    assert _build.resident(dev, occ, 1) == 132
    assert list(_build._RESIDENT.values()) == [132]
