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
