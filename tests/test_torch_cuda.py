"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``cuda`` marker and skips on a host without an
NVIDIA GPU.  The file imports neither JAX nor the JAX package, so it also
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: 2e-2 for rmsnorm and gemv — bf16 inputs and outputs of order 1,
whose 8-bit mantissa holds ~3 significant digits, summed in other orders by
the kernel and the plain version.  4e-3 for the attention kernels (bf16 and
int8 pools) — their outputs are softmax-weighted means of N(0, 1) rows, of
order 0.1, and measured errors against the plain version on the card are
6e-5 to 1e-3.  MX_TOL for the two MX kernels: fp32 outputs of order 1 from
the same dequantized weights (the kernel builds 2^(s-127) exactly, the
plain version as the JAX package does, within ~1e-7 of it), summed in
another order in fp32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.quant.tensor import quantize_kv, quantize_mx  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card")


def bf16(a):
    return torch.as_tensor(np.asarray(a, np.float32)).to("cuda",
                                                         torch.bfloat16)


def i32(a):
    return torch.as_tensor(np.asarray(a, np.int32), device="cuda")


def paged_case(rng, B, H, KV, hd, page, nblk):
    """q, pools and a permuted block table (physically scattered pages)."""
    P = 1 + B * nblk
    q = bf16(rng.standard_normal((B, H, hd)))
    kp = bf16(rng.standard_normal((P, page, KV, hd)))
    vp = bf16(rng.standard_normal((P, page, KV, hd)))
    bt = (rng.permutation(P - 1)[:B * nblk] + 1).reshape(B, nblk)
    return q, kp, vp, i32(bt)


BF16_TOL, ATTN_TOL, MX_TOL = 2e-2, 4e-3, 1e-3


@pytest.fixture(autouse=True)
def _fp32_matmuls_in_full():
    """The plain MX versions are fp32 products: no TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def matches_plain(got, want, tol=BF16_TOL):
    torch.cuda.synchronize()         # a fault during the launch shows here
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("T,d", [(8, 1024), (32, 1024), (1, 1024), (5, 64)])
def test_rmsnorm(T, d):
    rng = np.random.default_rng(5)
    x = bf16(rng.standard_normal((T, d)))
    s = torch.as_tensor(1 + 0.1 * rng.standard_normal(d),
                        dtype=torch.float32, device="cuda")
    before = TK.launch_counts()["rmsnorm"]
    matches_plain(TK.rmsnorm(x, s), TK.PLAIN["rmsnorm"](x, s))
    assert TK.launch_counts()["rmsnorm"] == before + 1


@pytest.mark.parametrize("N,K", [(151936, 1024), (1024, 1024), (2816, 1024),
                                 (1024, 2816),
                                 (33, 2824)])   # ragged rows and vectors
def test_gemv(N, K):
    rng = np.random.default_rng(6)
    w = bf16(rng.standard_normal((N, K)) / np.sqrt(K))
    x = bf16(rng.standard_normal(K))
    matches_plain(TK.gemv(w, x), TK.PLAIN["gemv"](w, x))


@pytest.mark.parametrize("H,KV,hd,nblk,lengths", [
    (16, 16, 64, 64, [424, 40, 1, 17]),    # qwen1.5-0.5b geometry
    (4, 2, 128, 3, [48, 21, 30, 33]),      # GQA (2 heads per KV head), odd nblk
    (4, 4, 32, 5, [80, 79, 64, 2]),
])
def test_paged_decode_attention(H, KV, hd, nblk, lengths):
    rng = np.random.default_rng(7)
    q, kp, vp, bt = paged_case(rng, 4, H, KV, hd, 16, nblk)
    ln = i32(lengths)
    matches_plain(TK.paged_decode_attention(q, kp, vp, bt, ln),
                  TK.PLAIN["paged_decode_attention"](q, kp, vp, bt, ln),
                  ATTN_TOL)


def test_paged_decode_idle_slot_reads_null_page():
    """An idle slot (all-NULL table row, stale length) computes a finite
    garbage row without faulting; the live slot is unaffected."""
    rng = np.random.default_rng(9)
    q, kp, vp, bt = paged_case(rng, 2, 16, 16, 64, 16, 8)
    bt[1] = 0
    ln = i32([100, 77])
    got = TK.paged_decode_attention(q, kp, vp, bt, ln)
    matches_plain(got[:1], TK.PLAIN["paged_decode_attention"](
        q, kp, vp, bt, ln)[:1], ATTN_TOL)
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("offset,valid,hd", [(0, 32, 64), (224, 32, 64),
                                             (7, 5, 64), (40, 32, 128)])
def test_prefill_attention_paged(offset, valid, hd):
    rng = np.random.default_rng(8)
    _, kp, vp, bt = paged_case(rng, 1, 16, 16, hd, 16, 16)
    q = bf16(rng.standard_normal((1, 32, 16, hd)))
    off = i32([offset])
    ln = off + valid
    got = TK.prefill_attention_paged(q, kp, vp, bt, off, ln)
    want = TK.PLAIN["prefill_attention_paged"](q, kp, vp, bt, off, ln)
    matches_plain(got[:, :valid], want[:, :valid],   # pad rows are garbage
                  ATTN_TOL)


def mx_weight(rng, K, N, elem):
    """(codes, scales) of an MX-quantized (K, N) fan-in-scaled weight, on
    the card."""
    qt = quantize_mx(torch.from_numpy(
        (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32))
        .to("cuda"), elem=elem)
    return qt.values, qt.scales


@pytest.mark.parametrize("N,K,elem", [
    (151936, 1024, "fp4"), (151936, 1024, "fp8"),   # the read-out
    (1024, 1024, "fp4"), (1024, 2816, "fp4"),       # q/k/v/o, down
    (1040, 2848, "fp8"),                            # ragged tile, odd split
    (48, 96, "fp4")])                               # one partial tile
def test_mx_qgemv(N, K, elem):
    rng = np.random.default_rng(10)
    wq, s = mx_weight(rng, K, N, elem)
    x = bf16(rng.standard_normal(K))
    before = TK.launch_counts()["mx_qgemv"]
    matches_plain(TK.mx_qgemv(wq, s, x), TK.PLAIN["mx_qgemv"](wq, s, x),
                  MX_TOL)
    assert TK.launch_counts()["mx_qgemv"] == before + 1


@pytest.mark.parametrize("N,K,elem", [(2816, 1024, "fp4"),
                                      (2816, 1024, "fp8"), (48, 96, "fp4")])
def test_mx_qgemv_swiglu(N, K, elem):
    rng = np.random.default_rng(11)
    wg, sg = mx_weight(rng, K, N, elem)
    wu, su = mx_weight(rng, K, N, elem)
    x = bf16(rng.standard_normal(K))
    matches_plain(TK.mx_qgemv_swiglu(wg, sg, wu, su, x),
                  TK.PLAIN["mx_qgemv_swiglu"](wg, sg, wu, su, x), MX_TOL)


def int8_pools(kp, vp):
    k8, ks = quantize_kv(kp.float())
    v8, vs = quantize_kv(vp.float())
    return k8, ks, v8, vs


@pytest.mark.parametrize("H,KV,hd,nblk,lengths", [
    (16, 16, 64, 32, [398, 64, 1, 33]),    # qwen1.5-0.5b geometry, page 32
    (4, 2, 128, 3, [96, 21, 30, 65]),      # GQA, odd nblk
    (4, 4, 32, 5, [160, 159, 31, 2]),
])
def test_paged_decode_attention_int8(H, KV, hd, nblk, lengths):
    rng = np.random.default_rng(12)
    q, kp, vp, bt = paged_case(rng, 4, H, KV, hd, 32, nblk)
    args = (q, *int8_pools(kp, vp), bt, i32(lengths))
    before = TK.launch_counts()["paged_decode_attention_int8"]
    matches_plain(TK.paged_decode_attention_int8(*args),
                  TK.PLAIN["paged_decode_attention_int8"](*args), ATTN_TOL)
    assert TK.launch_counts()["paged_decode_attention_int8"] == before + 1


def test_paged_decode_int8_idle_slot_reads_null_page():
    rng = np.random.default_rng(13)
    q, kp, vp, bt = paged_case(rng, 2, 16, 16, 64, 32, 4)
    bt[1] = 0
    args = (q, *int8_pools(kp, vp), bt, i32([100, 77]))
    got = TK.paged_decode_attention_int8(*args)
    matches_plain(got[:1], TK.PLAIN["paged_decode_attention_int8"](*args)[:1],
                  ATTN_TOL)
    assert torch.isfinite(got.float()).all()


def test_wrapper_raises_instead_of_falling_back():
    x = torch.ones((4, 64), dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        TK.rmsnorm(x, torch.ones(64, device="cuda"))
    w = torch.ones((33, 100), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="K % 8"):     # no slower variant
        TK.gemv(w, torch.ones(100, dtype=torch.bfloat16, device="cuda"))
    xs = torch.ones(1032, dtype=torch.bfloat16, device="cuda")[1:1025]
    with pytest.raises(ValueError, match="aligned"):
        TK.gemv(torch.ones((8, 1024), dtype=torch.bfloat16, device="cuda"), xs)
    rng = np.random.default_rng(14)
    wq, s = mx_weight(rng, 64, 48, "fp4")
    with pytest.raises(ValueError, match="K % 32"):     # x of the wrong K
        TK.mx_qgemv(wq, s, bf16(rng.standard_normal(96)))
    q, kp, vp, bt = paged_case(rng, 1, 4, 4, 32, 32, 2)
    with pytest.raises(ValueError, match="int8"):       # bf16 pools
        TK.paged_decode_attention_int8(q, kp, kp[..., :1], vp, vp[..., :1],
                                       bt, i32([5]))
