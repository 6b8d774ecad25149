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
6e-5 to 1e-3.  MX_TOL for the three MX kernels: fp32 outputs of order 1
from the same dequantized weights (the kernel builds 2^(s-127) exactly, the
plain version as the JAX package does, within ~1e-7 of it), summed in
another order in fp32.  F32_TOL for the fp32 gemv (the MoE router): fp32
inputs and outputs of order 1, summed in another order in fp32.  ADAM_TOL
for the fused AdamW: the kernel rounds each of the plain version's fp32
operations on its own, in the same order, so the two may differ only where
PyTorch's elementwise kernels round otherwise (an fp32 ulp of values of
order 1); a bf16 master keeps ~3 significant digits.  axpy is held to 0
error: it rounds its plain version's fp32 multiply and add each on its own.
dotp at 1e-5 of sum |x_i y_i|: the same fp32 products summed in another
order.  The dense decode partials at ATTN_TOL after normalizing (as the
paged kernels), the running max m at 1e-5 (fp32 dot products summed in
another order), the sum l at 1e-4 relative.  The int8/int4 GEMVs
(``qgemv``, ``batched_qgemv``) and the batched MX GEMV at 1e-5 of sum
|w x| per output: both sides dequantize each code with one fp32 multiply
(the same weights) and sum the same fp32 products in another order.  The
dense int8 decode at ATTN_TOL, as the paged int8 decode.  FLASH_TOL for
``flash_attention`` in fp32 (the JAX package's own tolerance for it: fp32
softmax-weighted means, the kernel's online softmax against the plain
full one) and BF16_TOL where its output is bf16 (rows near t = 0 average
few positions, so outputs reach order 1 to 3).  SCAN_TOL for ``wkv6`` and
``mamba_scan`` (the JAX package's tolerance for them: fp32 states of order
1 to 10 carried over T steps, the plain versions multiplying the decays
step by step, the wkv6 kernel summing their logarithms in chunks).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.core.troop import LaunchConfig  # noqa: E402
from repro_torch.quant.tensor import (quantize, quantize_kv,  # noqa: E402
                                      quantize_mx)

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


BF16_TOL, ATTN_TOL, MX_TOL, F32_TOL = 2e-2, 4e-3, 1e-3, 1e-4
ADAM_TOL = 1e-6
FLASH_TOL, SCAN_TOL = 2e-4, 1e-4


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


RMS_THREADS = (64, 128, 256)          # the tuner's space


def rms_inputs(seed, T, d):
    rng = np.random.default_rng(seed)
    return (bf16(rng.standard_normal((T, d))),
            torch.as_tensor(1 + 0.1 * rng.standard_normal(d),
                            dtype=torch.float32, device="cuda"))


@pytest.mark.parametrize("threads", RMS_THREADS)
@pytest.mark.parametrize("T,d", [(13, 128), (13, 2048), (7, 4096),
                                 (3, 32768)])
def test_rmsnorm_every_width_and_block(T, d, threads):
    """A warp a row up to d = 2048, several warps a row past it (4096: 2,
    32,768: 16), at every ``rmsnorm_threads`` with a ragged last block; a
    second launch gives the same bits."""
    x, s = rms_inputs(6, T, d)
    cfg = LaunchConfig(rmsnorm_threads=threads)
    before = TK.launch_counts()["rmsnorm"]
    got = TK.rmsnorm(x, s, cfg=cfg)
    matches_plain(got, TK.PLAIN["rmsnorm"](x, s))
    assert torch.equal(got, TK.rmsnorm(x, s, cfg=cfg))
    assert TK.launch_counts()["rmsnorm"] == before + 2


@pytest.mark.parametrize("producer", ["add", "matmul"])
@pytest.mark.parametrize("T,d", [(8, 1024), (1, 2048), (4, 4096)])
def test_rmsnorm_in_a_cuda_graph_reads_its_producer(producer, T, d):
    """rmsnorm is launched as a programmatic dependent of the kernel before
    it: captured in a CUDA graph right after a torch op that writes its x
    (the served path's residual add, or a long matmul that keeps writing
    while rmsnorm's blocks are scheduled), each replay on new inputs gives
    the bits of rmsnorm launched on the finished x."""
    rng = np.random.default_rng(7)
    s = torch.as_tensor(1 + 0.1 * rng.standard_normal(d),
                        dtype=torch.float32, device="cuda")
    if producer == "add":
        a, b = bf16(rng.standard_normal((T, d))), bf16(rng.standard_normal(
            (T, d)))

        def make():
            return torch.add(a, b)
    else:
        a = bf16(rng.standard_normal((T, 1 << 15)) / 64)
        b = bf16(rng.standard_normal((1 << 15, d)))

        def make():
            return a @ b
    make(), TK.rmsnorm(make(), s)           # load the library outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = TK.rmsnorm(make(), s)
    for trial in range(3):
        a.copy_(bf16(rng.standard_normal(tuple(a.shape)))
                / (64 if producer == "matmul" else 1))
        graph.replay()
        x = make()
        want = TK.rmsnorm(x, s)
        torch.cuda.synchronize()
        assert torch.equal(out, want), trial
        matches_plain(out, TK.PLAIN["rmsnorm"](x, s))


@pytest.mark.parametrize("N,K", [(151936, 1024), (1024, 1024), (2816, 1024),
                                 (1024, 2816),
                                 (33, 2824)])   # ragged rows and vectors
def test_gemv(N, K):
    rng = np.random.default_rng(6)
    w = bf16(rng.standard_normal((N, K)) / np.sqrt(K))
    x = bf16(rng.standard_normal(K))
    matches_plain(TK.gemv(w, x), TK.PLAIN["gemv"](w, x))


@pytest.mark.parametrize("N,K", [(60, 2048),          # the MoE router
                                 (151936, 1024), (33, 100)])
def test_gemv_f32(N, K):
    rng = np.random.default_rng(15)
    w = torch.as_tensor(rng.standard_normal((N, K)) / np.sqrt(K),
                        dtype=torch.float32, device="cuda")
    x = torch.as_tensor(rng.standard_normal(K), dtype=torch.float32,
                        device="cuda")
    before = TK.launch_counts()["gemv"]
    matches_plain(TK.gemv(w, x), TK.PLAIN["gemv"](w, x), F32_TOL)
    assert TK.launch_counts()["gemv"] == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,K", [(1408, 2048), (2048, 1408)])
def test_gemv_picks_one_matrix_of_a_stack(N, K, dtype):
    """The bf16 routed MoE path: the expert id stays on the device."""
    g = torch.Generator(device="cuda").manual_seed(16)
    w = (torch.randn((6, N, K), device="cuda", generator=g)
         / np.sqrt(K)).to(dtype)
    x = torch.randn(K, device="cuda", generator=g).to(dtype)
    for e in (0, 5, 3):
        ix = i32([e])
        got = TK.gemv(w, x, ix)
        matches_plain(got, TK.PLAIN["gemv"](w[e], x),
                      BF16_TOL if dtype == torch.bfloat16 else F32_TOL)
        matches_plain(got, TK.PLAIN["gemv"](w, x, ix),
                      BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


@pytest.mark.parametrize("warps", [4, 8, 16])
@pytest.mark.parametrize("N,K,dtype,stack", [
    (60, 2048, torch.float32, False),     # the MoE router: 8 steps of K
    (1024, 1024, torch.bfloat16, False),
    (1024, 2816, torch.bfloat16, False),  # 5.5 steps: K not a multiple
    (1408, 2048, torch.bfloat16, True),   # an expert of a stack, by id
    (1000, 1032, torch.bfloat16, False),  # a last step of one vector
    (7, 4100, torch.float32, False),      # rows fewer than a block
    (151936, 1024, torch.bfloat16, False)])  # the read-out: one warp a row
def test_gemv_split_k(N, K, dtype, stack, warps):
    """The one-row gemv at every ``gemv_warps`` of its tuner space, split
    over K where the rows are few (``gemv_ksplit``): against the plain
    version, the same bits on a second launch (the warps of a row meet in
    a fixed order), and ``batched_gemv`` at B = 1 gives gemv's bits."""
    from repro_torch.kernels.gemv import gemv_ksplit
    g = torch.Generator(device="cuda").manual_seed(17)
    w = (torch.randn((3, N, K) if stack else (N, K), device="cuda",
                     generator=g) / np.sqrt(K)).to(dtype)
    x = torch.randn(K, device="cuda", generator=g).to(dtype)
    ix = i32([2]) if stack else None
    cfg = LaunchConfig(gemv_warps=warps)
    split = gemv_ksplit(N, K, 8 if dtype == torch.bfloat16 else 4, warps,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)
    assert (split > 1) == (N < 151936)
    got = TK.gemv(w, x, ix, cfg)
    matches_plain(got, TK.PLAIN["gemv"](w, x, ix),
                  BF16_TOL if dtype == torch.bfloat16 else F32_TOL)
    assert torch.equal(got, TK.gemv(w, x, ix, cfg))
    if dtype == torch.bfloat16 and not stack:
        assert torch.equal(TK.batched_gemv(w, x[None], cfg)[0], got)


@pytest.mark.parametrize("H,KV,hd,nblk,lengths", [
    (16, 16, 64, 64, [424, 40, 1, 17]),    # qwen1.5-0.5b geometry
    (16, 16, 128, 64, [424, 40, 1, 17]),   # qwen2-moe-a2.7b geometry
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


def paged_splits(int8, H, KV, nblk, page, warps, B=4):
    """The splits ``paged_decode_plan`` gives B slots on this card."""
    from repro_torch.kernels import _build
    DA = importlib.import_module("repro_torch.kernels.decode_attention")
    lib = _build.library("decode_attention", DA._ARGTYPES)
    occ = (lib.repro_paged_decode_int8_occupancy if int8 else
           lib.repro_paged_decode_bf16_occupancy)
    return DA.paged_decode_plan(
        B, H, KV, page, nblk, LaunchConfig(decode_warps=warps),
        _build.resident(torch.device("cuda", 0), occ, 128, warps),
        lib.repro_paged_decode_max_pages())["nsplit"]


def check_gqa_decode(name, args, lengths, nsplit):
    """A paged decode at G > 1 over several splits: the rows of live slots
    against the plain version, an idle slot's row exactly 0 (every split
    commits the empty state; the plain softmax over no position is NaN),
    the same bits on a second launch, one launch a call."""
    fn, plain = getattr(TK, name), TK.PLAIN[name]
    assert nsplit > 1
    before = TK.launch_counts()[name]
    got = fn(*args)
    assert TK.launch_counts()[name] == before + 1
    want = plain(*args[:-1])
    live = [b for b, n in enumerate(lengths) if n > 0]
    matches_plain(got[live], want[live], ATTN_TOL)
    assert (got[[b for b, n in enumerate(lengths) if n == 0]] == 0).all()
    assert torch.equal(got, fn(*args))
    assert TK.launch_counts()[name] == before + 2


# hd 128 at grouped-query heads, a table of 1024 rows (more than one split
# of 256), lengths past a split, mid-page and 0: G = 5 (qwen3-14b's 40
# heads on 8), G = 16 (glm4-9b's 32 on 2) and G = 20 (two m-tiles, the
# second of 4 rows)
GQA_PAGED = [(40, 8, [1024, 0, 300, 17]), (32, 2, [1024, 513, 0, 1000]),
             (40, 2, [700, 0, 16, 1023])]


@pytest.mark.parametrize("warps", [2, 4, 8])
@pytest.mark.parametrize("H,KV,lengths", GQA_PAGED)
def test_paged_decode_attention_gqa(H, KV, lengths, warps):
    rng = np.random.default_rng(15)
    q, kp, vp, bt = paged_case(rng, 4, H, KV, 128, 16, 64)
    cfg = LaunchConfig(decode_warps=warps)
    check_gqa_decode("paged_decode_attention", (q, kp, vp, bt, i32(lengths),
                                                cfg), lengths,
                     paged_splits(False, H, KV, 64, 16, warps))


@pytest.mark.parametrize("warps", [2, 4, 8])
@pytest.mark.parametrize("H,KV,lengths", GQA_PAGED)
def test_paged_decode_attention_int8_gqa(H, KV, lengths, warps):
    rng = np.random.default_rng(16)
    q, kp, vp, bt = paged_case(rng, 4, H, KV, 128, 32, 32)
    cfg = LaunchConfig(decode_warps=warps)
    check_gqa_decode("paged_decode_attention_int8",
                     (q, *int8_pools(kp, vp), bt, i32(lengths), cfg),
                     lengths, paged_splits(True, H, KV, 32, 32, warps))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_decode_long_table(int8):
    """A table of 144,000 rows (9,000 bf16 pages, 4,500 int8 ones) at G =
    2: many splits (more than 8, and more than one split's page list
    holds at 16-row pages) meeting in the combine kernel; a length that
    ends mid-page, an idle slot."""
    rng = np.random.default_rng(18)
    page = 32 if int8 else 16
    nblk = 144000 // page
    q, kp, vp, bt = paged_case(rng, 2, 4, 2, 128, page, nblk)
    pools = int8_pools(kp, vp) if int8 else (kp, vp)
    lengths = [nblk * page - 9, 0]
    nsplit = paged_splits(int8, 4, 2, nblk, page, 4, B=2)
    assert nsplit > 8
    check_gqa_decode("paged_decode_attention" + "_int8" * int8,
                     (q, *pools, bt, i32(lengths), LaunchConfig()), lengths,
                     nsplit)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hd", [64, 128])
def test_paged_decode_candidates_in_turn(int8, hd):
    """The tuner's candidates launched in turn, as the tuner and the smoke
    do (4, 2, 4, 8, 4): asking how many blocks of a small one fit must not
    leave the kernel's shared-memory limit below what a launch of a larger
    one asks for; every launch gives the first one's bits."""
    rng = np.random.default_rng(17)
    page = 32 if int8 else 16
    q, kp, vp, bt = paged_case(rng, 8, 16, 16, hd, page, 1024 // page)
    pools = int8_pools(kp, vp) if int8 else (kp, vp)
    name = "paged_decode_attention" + "_int8" * int8
    ln = i32(rng.integers(64, 449, 8))
    first = getattr(TK, name)(q, *pools, bt, ln, LaunchConfig(decode_warps=4))
    for warps in (2, 4, 8, 4):
        got = getattr(TK, name)(q, *pools, bt, ln,
                                LaunchConfig(decode_warps=warps))
        matches_plain(got, first, ATTN_TOL)
        if warps == 4:
            assert torch.equal(got, first)


@pytest.mark.parametrize("warps", [2, 4, 8])
@pytest.mark.parametrize("H,KV,hd,offsets,valid", [
    (16, 16, 64, [0], [32]), (16, 16, 64, [224], [32]),
    (16, 16, 64, [7], [5]), (16, 16, 128, [40], [32]),
    (16, 16, 128, [224], [32]), (16, 16, 128, [7], [5]),
    # G = 5 (qwen3-14b) and G = 16 (glm4-9b): 160 and 512 rows a KV head,
    # beyond one block; two slabs at different offsets (a prefix hit),
    # lengths that end mid-page
    (10, 2, 128, [0, 224], [32, 23]), (32, 2, 128, [401, 7], [23, 32]),
    (32, 2, 64, [40, 0], [5, 32]), (10, 2, 32, [3, 100], [32, 17]),
])
def test_prefill_attention_paged(H, KV, hd, offsets, valid, warps):
    """Every prefill_warps; the same bits on a second launch."""
    rng = np.random.default_rng(8)
    B = len(offsets)
    _, kp, vp, bt = paged_case(rng, B, H, KV, hd, 16, 32)
    q = bf16(rng.standard_normal((B, 32, H, hd)))
    off = i32(offsets)
    ln = off + i32(valid)
    cfg = LaunchConfig(prefill_warps=warps)
    before = TK.launch_counts()["prefill_attention_paged"]
    got = TK.prefill_attention_paged(q, kp, vp, bt, off, ln, cfg)
    assert TK.launch_counts()["prefill_attention_paged"] == before + 1
    want = TK.PLAIN["prefill_attention_paged"](q, kp, vp, bt, off, ln)
    for b, v in enumerate(valid):              # pad rows are garbage
        matches_plain(got[b, :v], want[b, :v], ATTN_TOL)
    assert torch.equal(got, TK.prefill_attention_paged(q, kp, vp, bt, off,
                                                       ln, cfg))


@pytest.mark.parametrize("warps", [2, 4, 8])
def test_prefill_attention_paged_long_table(warps):
    """A table of 9,000 pages (144,000 positions) at hd 128: more splits
    than one wave needs, so that no split's page list outgrows the block's
    shared memory; a slab at the end of a length that ends mid-page."""
    rng = np.random.default_rng(9)
    _, kp, vp, bt = paged_case(rng, 1, 4, 2, 128, 16, 9000)
    q = bf16(rng.standard_normal((1, 8, 4, 128)))
    ln = i32([9000 * 16 - 9])
    off = ln - 8
    cfg = LaunchConfig(prefill_warps=warps)
    got = TK.prefill_attention_paged(q, kp, vp, bt, off, ln, cfg)
    matches_plain(got, TK.PLAIN["prefill_attention_paged"](q, kp, vp, bt,
                                                           off, ln), ATTN_TOL)
    assert torch.equal(got, TK.prefill_attention_paged(q, kp, vp, bt, off,
                                                       ln, cfg))


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
    (48, 96, "fp4"),                                # one partial tile
    (2048, 2048, "fp4"), (2048, 2048, "fp8"),       # qwen2-moe attention
    (2048, 5632, "fp4"), (2048, 5632, "fp8"),       # its shared expert's down
    (16, 1024, "fp4"), (16, 1024, "fp8"),           # one lane's columns
    (1024, 32, "fp4"), (1024, 32, "fp8"),           # one E8M0 block of K
    (64, 16384, "fp4"), (64, 8192, "fp8")])         # K in 2 rounds a block
def test_mx_qgemv(N, K, elem):
    rng = np.random.default_rng(10)
    wq, s = mx_weight(rng, K, N, elem)
    x = bf16(rng.standard_normal(K))
    before = TK.launch_counts()["mx_qgemv"]
    key = f"fp{4 if elem == 'fp4' else 8} {K}->{N}"
    shape_before = TK.mx_qgemv_launches_by_shape().get(key, 0)
    matches_plain(TK.mx_qgemv(wq, s, x), TK.PLAIN["mx_qgemv"](wq, s, x),
                  MX_TOL)
    assert TK.launch_counts()["mx_qgemv"] == before + 1
    assert TK.mx_qgemv_launches_by_shape()[key] == shape_before + 1


@pytest.mark.parametrize("N,K,elem", [
    (151936, 1024, "fp4"), (151936, 1024, "fp8"), (1024, 1024, "fp4"),
    (2048, 5632, "fp4"), (1040, 2848, "fp8"), (16, 32, "fp4"),
    (64, 16384, "fp4")])
def test_mx_qgemv_gives_the_same_bits_twice(N, K, elem):
    """One launch a call (a tile's lanes and warps add in a fixed order in
    one block, no atomics): the same inputs give the same bits."""
    rng = np.random.default_rng(14)
    wq, s = mx_weight(rng, K, N, elem)
    x = bf16(rng.standard_normal(K))
    before = TK.launch_counts()["mx_qgemv"]
    a, b = TK.mx_qgemv(wq, s, x), TK.mx_qgemv(wq, s, x)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert TK.launch_counts()["mx_qgemv"] == before + 2


def device_kernels(fn):
    """(the names of the device kernels one call of ``fn`` launches, from
    ``torch.profiler``'s CUDA events; the calls made), after a first call
    that builds and loads the library.  A window in which the profiler
    recorded no device event at all (its activity buffer came back empty,
    though ``fn`` launches) is profiled again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for calls in range(2, 5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names, calls


def one_walk_launch(fn, counter):
    """``fn`` launches exactly one device kernel a call, the MX walk, and
    adds one to its launch count ``counter`` each time."""
    before = TK.launch_counts()[counter]
    names, calls = device_kernels(fn)
    assert len(names) == 1 and "mx_walk_kernel" in names[0], names
    assert TK.launch_counts()[counter] == before + calls


SWIGLU_CASES = [
    (2816, 1024, "fp4"), (2816, 1024, "fp8"),     # qwen1.5-0.5b's MLP
    (5632, 2048, "fp4"), (5632, 2048, "fp8"),     # qwen2-moe's shared expert
    (40016, 96, "fp4"), (40016, 96, "fp8"),       # ragged 128-column tiles
    (2816, 1408, "fp4"),                          # K short of a band
    (48, 96, "fp4")]                              # one partial tile


@pytest.mark.parametrize("N,K,elem", SWIGLU_CASES)
def test_mx_qgemv_swiglu(N, K, elem):
    """The gate and the up weight in one walk, each stream on its own
    warps: against the plain version, the same bits twice, one device
    kernel a call."""
    rng = np.random.default_rng(11)
    wg, sg = mx_weight(rng, K, N, elem)
    wu, su = mx_weight(rng, K, N, elem)
    x = bf16(rng.standard_normal(K))
    before = TK.launch_counts()["mx_qgemv_swiglu"]
    got = TK.mx_qgemv_swiglu(wg, sg, wu, su, x)
    assert got.shape == (N,) and got.dtype == torch.float32
    matches_plain(got, TK.PLAIN["mx_qgemv_swiglu"](wg, sg, wu, su, x),
                  MX_TOL)
    assert TK.launch_counts()["mx_qgemv_swiglu"] == before + 1
    assert torch.equal(got, TK.mx_qgemv_swiglu(wg, sg, wu, su, x))
    one_walk_launch(lambda: TK.mx_qgemv_swiglu(wg, sg, wu, su, x),
                    "mx_qgemv_swiglu")


def mx_stack(E, K, N, elem, seed):
    """(codes, scales) of an MX-quantized (E, K, N) stack of fan-in-scaled
    expert weights, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qt = quantize_mx(torch.randn((E, K, N), device="cuda", generator=g)
                     / np.sqrt(K), elem=elem, axis=-2)
    return qt.values, qt.scales


@pytest.mark.parametrize("ids", [[7, 0, 59, 31], [12, 12, 3, 12]])
@pytest.mark.parametrize("N,K,elem", [
    (1408, 2048, "fp4"), (2048, 1408, "fp4"),       # up/gate, down (K
    (1408, 2048, "fp8"), (2048, 1408, "fp8"),       # short of a band)
    (16912, 96, "fp4"), (16912, 96, "fp8"),         # a ragged last tile
    (48, 96, "fp4")])                               # one partial tile
def test_grouped_expert_qgemv(N, K, elem, ids):
    """qwen2-moe-a2.7b's experts (60, top-4) and a stack wide enough for
    128-column tiles, the last one ragged; repeated ids read one slice
    twice.  Each row is ``mx_qgemv`` of its expert; the same bits twice;
    one device kernel a call."""
    wq, s = mx_stack(60, K, N, elem, seed=17)
    rng = np.random.default_rng(18)
    xs = bf16(rng.standard_normal((len(ids), K)))
    ix = i32(ids)
    before = TK.launch_counts()["grouped_expert_qgemv"]
    got = TK.grouped_expert_qgemv(wq, s, xs, ix)
    assert got.shape == (len(ids), N) and got.dtype == torch.float32
    matches_plain(got, TK.PLAIN["grouped_expert_qgemv"](wq, s, xs, ix),
                  MX_TOL)
    assert TK.launch_counts()["grouped_expert_qgemv"] == before + 1
    for t, e in enumerate(ids):               # row t is mx_qgemv of expert e
        matches_plain(got[t], TK.PLAIN["mx_qgemv"](wq[e], s[e], xs[t]),
                      MX_TOL)
    assert torch.equal(got, TK.grouped_expert_qgemv(wq, s, xs, ix))
    one_walk_launch(lambda: TK.grouped_expert_qgemv(wq, s, xs, ix),
                    "grouped_expert_qgemv")


def int8_pools(kp, vp):
    k8, ks = quantize_kv(kp.float())
    v8, vs = quantize_kv(vp.float())
    return k8, ks, v8, vs


@pytest.mark.parametrize("H,KV,hd,nblk,lengths", [
    (16, 16, 64, 32, [398, 64, 1, 33]),    # qwen1.5-0.5b geometry, page 32
    (16, 16, 128, 32, [398, 64, 1, 33]),   # qwen2-moe-a2.7b geometry
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
    w32 = torch.ones((8, 102), dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="K % 4"):      # fp32: 4-float loads
        TK.gemv(w32, torch.ones(102, dtype=torch.float32, device="cuda"))
    with pytest.raises(ValueError, match="both bf16"):  # mixed dtypes
        TK.gemv(w32[:, :100].contiguous(),
                torch.ones(100, dtype=torch.bfloat16, device="cuda"))
    ws, ss = mx_stack(4, 64, 48, "fp4", seed=19)
    xs = bf16(rng.standard_normal((2, 64)))
    with pytest.raises(ValueError, match="int32 ids"):  # int64 ids
        TK.grouped_expert_qgemv(ws, ss, xs, i32([1, 3]).long())
    with pytest.raises(ValueError, match="bf16 x"):     # fp32 rows
        TK.grouped_expert_qgemv(ws, ss, xs.float(), i32([1, 3]))
    with pytest.raises(ValueError, match="stacked"):    # one weight, no stack
        TK.grouped_expert_qgemv(ws[0], ss[0], xs, i32([1, 3]))


def adam_leaf(rng, sizes, dtype):
    """One leaf's lists (p, g, mu, nu) and the seven hyper-parameters."""
    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32)).to("cuda", dt)
    ps = [t(rng.standard_normal(n), dtype) for n in sizes]
    gs = [t(0.1 * rng.standard_normal(n), dtype) for n in sizes]
    mus = [t(0.01 * rng.standard_normal(n)) for n in sizes]
    nus = [t(1e-4 * rng.random(n)) for n in sizes]
    hyper = t([1e-3, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3, 1 - 0.95 ** 3])
    return ps, gs, mus, nus, hyper


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes", [[1000], [3, 1, 4097, 5000, 8],
                                   [2816 * 1024 // 16 + 5] * 24])
def test_fused_adamw(streams, dtype, sizes):
    """Odd sizes (scalar tails, tensors smaller than a vector) and a
    24-tensor table (one stacked leaf of qwen1.5-0.5b) in one launch."""
    from repro_torch.core.troop import LaunchConfig
    rng = np.random.default_rng(20)
    ps, gs, mus, nus, hyper = adam_leaf(rng, sizes, dtype)
    want = [[a.clone() for a in xs] for xs in (ps, mus, nus)]
    TK.PLAIN["fused_adamw"](*want[:1], gs, *want[1:], hyper)
    before = TK.launch_counts()["fused_adamw"]
    TK.fused_adamw(ps, gs, mus, nus, hyper,
                   cfg=LaunchConfig(adamw_streams=streams))
    assert TK.launch_counts()["fused_adamw"] == before + 1
    tol = BF16_TOL if dtype == torch.bfloat16 else ADAM_TOL
    for got, exp in zip((ps, mus, nus), want):
        for a, b in zip(got, exp):
            matches_plain(a, b, tol if got is ps else ADAM_TOL)


def test_fused_adamw_splits_a_long_leaf_and_refuses_misalignment():
    rng = np.random.default_rng(21)
    ps, gs, mus, nus, hyper = adam_leaf(rng, [64] * 40, torch.float32)
    before = TK.launch_counts()["fused_adamw"]
    TK.fused_adamw(ps, gs, mus, nus, hyper)
    assert TK.launch_counts()["fused_adamw"] == before + 2     # 32 + 8
    torch.cuda.synchronize()
    view = torch.zeros(65, device="cuda")[1:]
    with pytest.raises(ValueError, match="aligned"):
        TK.fused_adamw([view], [gs[0]], [mus[0]], [nus[0]], hyper)
    with pytest.raises(ValueError, match="both fp32 or both bf16"):
        TK.fused_adamw([ps[0]], [gs[0].to(torch.bfloat16)], [mus[0]],
                       [nus[0]], hyper)


def test_fused_adamw_routes_by_the_parameters_device():
    """CUDA parameters launch the kernel or raise, whatever device the
    hyper-parameters are on: a CPU ``hyper`` is refused, not run through
    the plain version on the card."""
    rng = np.random.default_rng(22)
    ps, gs, mus, nus, hyper = adam_leaf(rng, [1000], torch.float32)
    before = TK.launch_counts()["fused_adamw"]
    with pytest.raises(ValueError, match="hyper"):
        TK.fused_adamw(ps, gs, mus, nus, hyper.cpu())
    assert TK.launch_counts()["fused_adamw"] == before


def test_train_step_makes_no_host_sync():
    """A fused training step of the reduced qwen1.5-0.5b on the card: one
    kernel launch per JAX leaf (15), and nothing that synchronizes the host
    with the device."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train import make_train_step
    cfg = reduced(get_config("qwen1.5-0.5b"))
    model = build_model(cfg, RuntimeConfig(remat="dots"), device="cuda",
                        trainable=True)
    step, opt = make_train_step(model, OptConfig(fused=True))
    state = opt.init(model.params)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4))
    batch = to_device(data.batch_at(0), model.device)
    _, state, _ = step(model.params, state, batch)        # warm up
    batch = to_device(data.batch_at(1), model.device)
    torch.cuda.synchronize()
    before = TK.launch_counts()["fused_adamw"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, state, metrics = step(model.params, state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert TK.launch_counts()["fused_adamw"] == before + 15
    assert int(state.step) == 2 and np.isfinite(float(metrics["loss"]))


# ------------------------------------------------------- the fifth slice
SHAPES = [(1 << 12, 1, 256), (3 * 4096 + 8, 2, 512), (1 << 16, 4, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("n,unroll,block_k", SHAPES)
def test_axpy_gives_the_plain_bits(dtype, streams, n, unroll, block_k):
    from repro_torch.core.troop import LaunchConfig
    rng = np.random.default_rng(30)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(
        "cuda", dtype)
    y = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(
        "cuda", dtype)
    cfg = LaunchConfig(streams=streams, unroll=unroll, block_k=block_k)
    got = TK.axpy(1.7, x, y, cfg=cfg)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, TK.PLAIN["axpy"](1.7, x, y))


def axpy_inputs(seed, n, dtype):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(
        "cuda", dtype) for _ in range(2)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("edge", ["one vector", "one tile + 8",
                                  "many steps a block"])
def test_axpy_stream_edges(dtype, streams, edge):
    """The stream's edges, walked as ``stream_plan`` cuts them whatever n:
    8 elements (no whole tile: the tail alone), one tile + 8 (one step, a
    tail of one vector) at the registry's default tile, and 3 steps a block
    (two parts of 16 KB tiles, or one of 32 KB, at unroll 4: as many as fit
    a block) with a tail; the plain version's bits."""
    from repro_torch.kernels.axpy import run_plan, stream_plan
    vec = 8 if dtype == torch.bfloat16 else 4
    cfg = (LaunchConfig(streams=streams, unroll=4,
                        block_k=2048 if streams == 1 else 1024)
           if edge == "many steps a block" else
           LaunchConfig(streams=streams, unroll=1, block_k=256))
    tile = cfg.block_k * vec
    n = {"one vector": 8, "one tile + 8": tile + 8,
         "many steps a block": 37 * tile + 24}[edge]
    x, y = axpy_inputs(32, n, dtype)
    plan = stream_plan(n, x.element_size(), cfg)
    got = run_plan(1.25, x, y, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, TK.PLAIN["axpy"](1.25, x, y))
    if edge == "many steps a block":
        assert plan.spb == 3 and plan.tail > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("past", [0, 1])
def test_axpy_switches_path_past_four_waves(dtype, past):
    """The card's 4 waves of a 16-byte vector a thread on the vector path,
    and one vector more on the stream (a tail of one vector): the plain
    version's bits, one launch each."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.axpy import SM_THREADS, VECTOR_WAVES, axpy_plan
    vec = 8 if dtype == torch.bfloat16 else 4
    n = (VECTOR_WAVES * _build.sm_count(torch.device("cuda")) * SM_THREADS
         + past) * vec
    x, y = axpy_inputs(34, n, dtype)
    cfg = LaunchConfig(streams=1, unroll=1, block_k=256)
    before = TK.launch_counts()["axpy"]
    got = TK.axpy(0.5, x, y, cfg=cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, TK.PLAIN["axpy"](0.5, x, y))
    assert TK.launch_counts()["axpy"] == before + 1
    assert (axpy_plan(n, x.element_size(), cfg,
                      _build.sm_count(x.device)).tiles > 0) == bool(past)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("streams,unroll,block_k", [
    (s, u, b) for s in (1, 2) for u in (1, 2) for b in (256, 512, 1024)])
def test_axpy_every_candidate_gives_the_plain_bits(dtype, streams, unroll,
                                                   block_k):
    """Every candidate of the tuner's space, both types, at a size past the
    vector path (on a card of up to 144 SMs): the stream, with a tail."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.axpy import axpy_plan
    x, y = axpy_inputs(33, (9 << 20) + 40, dtype)
    cfg = LaunchConfig(streams=streams, unroll=unroll, block_k=block_k)
    got = TK.axpy(-0.75, x, y, cfg=cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, TK.PLAIN["axpy"](-0.75, x, y))
    plan = axpy_plan(x.shape[0], x.element_size(), cfg,
                     _build.sm_count(x.device))
    assert plan.tiles > 0 and plan.tail > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("n,unroll,block_k", SHAPES)
def test_dotp_is_deterministic(dtype, streams, n, unroll, block_k):
    from repro_torch.core.troop import LaunchConfig
    rng = np.random.default_rng(31)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(
        "cuda", dtype)
    y = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32).to(
        "cuda", dtype)
    cfg = LaunchConfig(streams=streams, unroll=unroll, block_k=block_k)
    a, b = TK.dotp(x, y, cfg=cfg), TK.dotp(x, y, cfg=cfg)
    torch.cuda.synchronize()
    assert a.shape == () and a.dtype == torch.float32
    assert torch.equal(a, b)                        # run to run, same bits
    bound = 1e-5 * (x.float() * y.float()).abs().sum().item()
    assert abs(a.item() - TK.PLAIN["dotp"](x, y).item()) <= bound


@pytest.mark.parametrize("streams,unroll,block_k", [
    (s, u, b) for s in (1, 2) for u in (1, 2) for b in (256, 512)]
    + [(1, 4, 128), (2, 4, 128)])
@pytest.mark.parametrize("H,KV,hd,S", [(16, 8, 128, 512), (16, 16, 64, 512),
                                       (4, 2, 32, 512),
                                       # G = 5 and 16, S not a whole tile
                                       (10, 2, 128, 300), (32, 2, 64, 300)])
def test_decode_attention_stats(streams, unroll, block_k, H, KV, hd, S):
    """A row with no valid position (length <= s_offset) gives acc = 0,
    l = 0, m = -1e30; the others match the plain version; every tuner
    candidate; the same bits on a second launch."""
    from repro_torch.core.troop import LaunchConfig
    rng = np.random.default_rng(32)
    B, off = 3, 100
    q = bf16(rng.standard_normal((B, H, hd)))
    k = bf16(rng.standard_normal((B, S, KV, hd)))
    v = bf16(rng.standard_normal((B, S, KV, hd)))
    length = i32([off, 300, S + off])               # 0, 200, S valid
    cfg = LaunchConfig(streams=streams, unroll=unroll, block_k=block_k)
    acc, m, l = TK.decode_attention_stats(q, k, v, length, cfg, s_offset=off)
    want = TK._dec.plain_stats(q, k, v, length, s_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(acc[0], torch.zeros_like(acc[0]))
    assert torch.equal(l[0], torch.zeros_like(l[0]))
    assert (m[0] == -1e30).all()
    torch.testing.assert_close(m[1:], want[1][1:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l[1:], want[2][1:], rtol=1e-4, atol=1e-4)
    norm = (acc / l.clamp(min=1e-30))[1:]
    want_norm = (want[0] / want[2].clamp(min=1e-30))[1:]
    torch.testing.assert_close(norm, want_norm, rtol=ATTN_TOL, atol=ATTN_TOL)
    again = TK.decode_attention_stats(q, k, v, length, cfg, s_offset=off)
    assert all(torch.equal(a, b) for a, b in zip((acc, m, l), again))
    out = TK.decode_attention(q, k, v, length - off, cfg)
    matches_plain(out, TK.PLAIN["decode_attention"](q, k, v, length - off),
                  ATTN_TOL)


def test_tensor_core_attention_raises_instead_of_falling_back():
    """The two tensor-core attention kernels refuse an hd they have no
    instantiation for, and a prefill block of 3 warps."""
    rng = np.random.default_rng(34)
    q = torch.ones((1, 4, 96), dtype=torch.bfloat16, device="cuda")
    kv = torch.ones((1, 64, 2, 96), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="32/64/128"):
        TK.decode_attention(q, kv, kv, i32([64]))
    _, kp, vp, bt = paged_case(rng, 1, 4, 2, 96, 16, 2)
    q4 = torch.ones((1, 8, 4, 96), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="32/64/128"):
        TK.prefill_attention_paged(q4, kp, vp, bt, i32([0]), i32([8]))
    _, kp, vp, bt = paged_case(rng, 1, 4, 2, 64, 16, 2)
    with pytest.raises(ValueError, match="prefill_warps"):
        TK.prefill_attention_paged(q4[..., :64].contiguous(), kp, vp, bt,
                                   i32([0]), i32([8]),
                                   LaunchConfig(prefill_warps=3))


@pytest.mark.parametrize("B", [1, 2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("N,K", [(2048, 4096), (1000, 1024), (64, 5632),
                                 (1000, 1032)])
def test_batched_gemv(B, N, K):
    """Every row of xs against W read once, on the tensor cores: one n-tile
    of 8 rows (B <= 8) or two, N not a multiple of 16, K % 64 == 8 (1032: a
    last step of one 16-byte vector); the same bits on a second launch (the
    split-K partials meet in a fixed order); one row gives gemv's bits (B =
    1 launches gemv's kernel)."""
    rng = np.random.default_rng(33)
    w = bf16(rng.standard_normal((N, K)) / np.sqrt(K))
    xs = bf16(rng.standard_normal((B, K)))
    got = TK.batched_gemv(w, xs)
    assert got.shape == (B, N) and got.dtype == torch.float32
    matches_plain(got, TK.PLAIN["batched_gemv"](w, xs))
    assert torch.equal(got, TK.batched_gemv(w, xs))
    if B == 1:
        assert torch.equal(got[0], TK.gemv(w, xs[0].contiguous()))


def test_new_kernels_raise_instead_of_falling_back():
    x = torch.ones(100, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="K % 8"):
        TK.dotp(x, x)
    with pytest.raises(ValueError, match="Python number"):
        TK.axpy(torch.tensor(1.0, device="cuda"), x[:96], x[:96])
    w = torch.ones((8, 1024), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="B <= 16"):
        TK.batched_gemv(w, torch.ones((17, 1024), dtype=torch.bfloat16,
                                      device="cuda"))
    with pytest.raises(ValueError, match="16 warps"):
        TK.batched_gemv(w, torch.ones((2, 1024), dtype=torch.bfloat16,
                                      device="cuda"),
                        LaunchConfig(gemv_warps=32))
    q = torch.ones((1, 4, 96), dtype=torch.bfloat16, device="cuda")
    kv = torch.ones((1, 64, 2, 96), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="32/64/128"):
        TK.decode_attention_stats(q, kv, kv, i32([64]))


def test_tune_then_cached_on_the_card(tmp_path):
    """tune -> cache -> dispatch on the card: the second call resolves from
    the cache without timing, and the dispatching entry point launches
    with the winner."""
    import repro_torch.kernels as K
    from repro_torch import tune
    cache = tune.TuneCache(str(tmp_path / "cache.json"))
    for name in ("dotp", "axpy", "decode_attention", "gemv"):
        args, kw = tune.REGISTRY[name].example(small=True, device="cuda")
        res = tune.tune(name, *args, kernel_kwargs=kw, keep=2, iters=2,
                        cache=cache)
        assert not res.from_cache and res.timings_run >= 1
        assert 0 < res.fraction <= 1.05, (name, res.fraction)
        again = tune.tune(name, *args, kernel_kwargs=kw, cache=cache)
        assert again.from_cache and again.timings_run == 0
        assert again.best == res.best
        assert tune.get_tuned(name, *args, cache=cache) == res.best
        assert res.key.endswith(f"|cuda:{torch.cuda.get_device_name()}")
    x, y = tune.REGISTRY["dotp"].example(small=True, device="cuda")[0]
    best = tune.get_tuned("dotp", x, y, cache=cache)
    before = TK.launch_counts()["dotp"]
    got = tune.REGISTRY["dotp"].fn(x, y, cfg=best)
    assert torch.equal(K.dotp(x, y, best), got)
    assert TK.launch_counts()["dotp"] == before + 2


def within_dot_bound(got, want, w, xs):
    """|got - want| <= 1e-5 sum_k |w_nk x_k| per output; w (N, K) fp32."""
    torch.cuda.synchronize()
    bound = 1e-5 * (xs.float().abs() @ w.abs().t())
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got).all()
    assert bool((err <= bound.reshape(err.shape)).all()), \
        float((err - bound.reshape(err.shape)).max())


@pytest.mark.parametrize("cfg", [LaunchConfig(),
                                 LaunchConfig(block_n=128, unroll=2),
                                 LaunchConfig(unroll=4)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("N,K,group,B", [
    (151936, 1024, 128, 0),                         # the read-out, one row
    (2048, 4096, 128, 0), (2048, 4096, 128, 4),     # the registry example
    (1000, 1024, 1024, 1), (1000, 1024, 128, 16),   # one group a row
    (33, 2816, 128, 5),                             # ragged rows
    # groups narrower than a k-step (int4 128 codes, int8 64): the SIMT
    # walk, at the read-out (one row), the registry example (B = 4) and
    # ragged rows (int8 groups of 64 are one k-step: the tile walk)
    (151936, 1024, 32, 0), (2048, 4096, 32, 4), (1000, 1024, 64, 3)])
def test_qgemv(N, K, group, B, bits, cfg):
    """B = 0: the one-row ``qgemv``; else ``batched_qgemv``, W read once
    for all B rows; the same bits twice, and at the default config one
    device kernel a call, the one the plan routes to (the tile walk's or
    the SIMT walk's)."""
    g = torch.Generator(device="cuda").manual_seed(40)
    w = torch.randn((N, K), device="cuda", generator=g)
    qt = quantize(w, bits=bits, group_size=group, axis=-1)
    wd = qt.dequantize()
    xs = torch.randn((max(B, 1), K), device="cuda",
                     generator=g).to(torch.bfloat16)
    name = "batched_qgemv" if B else "qgemv"
    before = TK.launch_counts()[name]
    if B:
        got = TK.batched_qgemv(qt.values, qt.scales, xs, cfg, bits=bits)
        want = TK.PLAIN[name](qt.values, qt.scales, xs, bits=bits)
    else:
        got = TK.qgemv(qt.values, qt.scales, xs[0], cfg, bits=bits)
        want = TK.PLAIN[name](qt.values, qt.scales, xs[0], bits=bits)
    assert got.shape == ((B, N) if B else (N,))
    within_dot_bound(got, want, wd, xs)
    assert TK.launch_counts()[name] == before + 1
    if B:
        again = TK.batched_qgemv(qt.values, qt.scales, xs, cfg, bits=bits)
    else:
        again = TK.qgemv(qt.values, qt.scales, xs[0], cfg, bits=bits)
    assert torch.equal(got, again)
    if cfg == LaunchConfig():
        from repro_torch.kernels._build import sm_count
        from repro_torch.kernels.qgemv import batched_qgemv_plan
        plan = batched_qgemv_plan(N, K, K // group, max(B, 1), bits, cfg,
                                  sm_count(torch.device("cuda")))
        kernel = "qgemv_mma_kernel" if plan.route == "tile" else \
            "qgemv_kernel"
        if B:
            one_device_kernel(lambda: TK.batched_qgemv(
                qt.values, qt.scales, xs, cfg, bits=bits), name, kernel)
        else:
            one_device_kernel(lambda: TK.qgemv(
                qt.values, qt.scales, xs[0], cfg, bits=bits), name, kernel)


def one_device_kernel(fn, counter, kernel):
    """``fn`` launches exactly one device kernel a call, ``kernel``, and
    adds one to its launch count ``counter`` each time: one call captured
    in a CUDA graph, whose nodes libcuda's ``cuGraphDebugDotPrint``
    lists (a kernel node's label holds its function's name).  The graph
    holds every launch of the call, where ``torch.profiler`` late in a long
    run often records no device event in three windows running
    (``device_kernels``)."""
    import ctypes
    import os
    import re
    import tempfile
    fn()
    torch.cuda.synchronize()
    before = TK.launch_counts()[counter]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.dot")
        err = ctypes.CDLL("libcuda.so.1").cuGraphDebugDotPrint(
            ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(), 1)
        assert err == 0, err
        with open(path) as f:
            dot = f.read()
    nodes = re.findall(r'"(graph_\d+_node_\d+)"\s*\[', dot)
    assert len(nodes) == 1 and kernel in dot, dot
    assert TK.launch_counts()[counter] == before + 1


QGEMV_SPACE = [LaunchConfig(unroll=u, block_n=n)      # the tuner's knobs
               for u in (1, 2) for n in (128, 256)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B", [2, 3, 8, 9, 16])
@pytest.mark.parametrize("N,K,group", [
    (1000, 1024, 1024),     # one group a row: 16 / 8 k-steps a group
    (1000, 1024, 128),      # the registry's group, ragged last tile
    (33, 2816, 128)])       # ragged rows, K = 2816 (22 groups)
def test_batched_qgemv_tile_walk(N, K, group, B, bits):
    """B >= 2 on the tensor cores (one and two n-tiles, ragged B), at every
    candidate of the tuner's space: within the dot bound of the plain
    version, the same bits twice, one launch counted; one device kernel a
    call, the tile walk's."""
    g = torch.Generator(device="cuda").manual_seed(45)
    qt = quantize(torch.randn((N, K), device="cuda", generator=g), bits=bits,
                  group_size=group, axis=-1)
    xs = torch.randn((B, K), device="cuda", generator=g).to(torch.bfloat16)
    want = TK.PLAIN["batched_qgemv"](qt.values, qt.scales, xs, bits=bits)
    wd = qt.dequantize()
    for cfg in QGEMV_SPACE:
        before = TK.launch_counts()["batched_qgemv"]
        got = TK.batched_qgemv(qt.values, qt.scales, xs, cfg, bits=bits)
        assert got.shape == (B, N) and got.dtype == torch.float32
        within_dot_bound(got, want, wd, xs)
        assert torch.equal(got, TK.batched_qgemv(qt.values, qt.scales, xs,
                                                 cfg, bits=bits)), cfg
        assert TK.launch_counts()["batched_qgemv"] == before + 2
    one_device_kernel(lambda: TK.batched_qgemv(qt.values, qt.scales, xs,
                                               bits=bits),
                      "batched_qgemv", "qgemv_mma_kernel")


@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 9, 16])
@pytest.mark.parametrize("N,K,elem", [
    (151936, 1024, "fp4"), (151936, 1024, "fp8"),   # the read-out
    (2048, 4096, "fp4"), (2048, 4096, "fp8"),       # the registry example
    (1040, 2848, "fp8"), (48, 96, "fp4")])          # ragged tiles
def test_batched_mx_qgemv(N, K, elem, B):
    """The tile walk at every candidate of the tuner's space (8 and 2
    columns a lane, one and two n-tiles, ragged B): within the dot bound of
    the plain version, the same bits twice, one launch counted; its last
    row within MX_TOL of the one-row ``mx_qgemv``; one device kernel a
    call, the tile walk's (no reduce kernel)."""
    rng = np.random.default_rng(41)
    wq, s = mx_weight(rng, K, N, elem)
    xs = bf16(rng.standard_normal((B, K)))
    want = TK.PLAIN["batched_mx_qgemv"](wq, s, xs)
    wd = TR._mx_dequant(wq, s).t()
    for cfg in QGEMV_SPACE:
        before = TK.launch_counts()["batched_mx_qgemv"]
        got = TK.batched_mx_qgemv(wq, s, xs, cfg)
        assert got.shape == (B, N) and got.dtype == torch.float32
        within_dot_bound(got, want, wd, xs)
        assert torch.equal(got, TK.batched_mx_qgemv(wq, s, xs, cfg)), cfg
        assert TK.launch_counts()["batched_mx_qgemv"] == before + 2
    matches_plain(got[B - 1], TK.mx_qgemv(wq, s, xs[B - 1].contiguous()),
                  MX_TOL)
    one_device_kernel(lambda: TK.batched_mx_qgemv(wq, s, xs),
                      "batched_mx_qgemv", "mx_mma_kernel")


@pytest.mark.parametrize("cfg", [
    LaunchConfig(streams=1, unroll=u, block_k=b)   # the tuner's space
    for u in (1, 2) for b in (256, 512)])
@pytest.mark.parametrize("H,KV,hd,S,lengths", [
    (16, 16, 64, 1024, [1024, 700, 1, 33]),   # qwen1.5-0.5b's dense shape
    (16, 8, 128, 4096, [4096, 4096, 2049, 5]),  # kernel_bench's, G = 2
    (6, 2, 32, 96, [0, 96, 50, 31]),          # G = 3, a row with no key
    (10, 2, 128, 300, [300, 0, 129, 17]),     # G = 5, S not a whole tile
    (32, 2, 64, 300, [1, 300, 0, 250]),       # G = 16
    (32, 2, 128, 4096, [4096, 3001, 0, 64])])  # glm4-9b's heads
def test_decode_attention_int8(H, KV, hd, S, lengths, cfg):
    """Every tuner candidate at G = 1, 2, 3, 5 and 16; a row with no valid
    key gives 0 (row 10's convention), in the kernel and in its plain
    version; a second launch gives the same bits."""
    rng = np.random.default_rng(42)
    q = bf16(rng.standard_normal((4, H, hd)))
    k8, ks = quantize_kv(bf16(rng.standard_normal((4, S, KV, hd))))
    v8, vs = quantize_kv(bf16(rng.standard_normal((4, S, KV, hd))))
    args = (q, k8, ks, v8, vs, i32(lengths))
    before = TK.launch_counts()["decode_attention_int8"]
    got = TK.decode_attention_int8(*args, cfg)
    matches_plain(got, TK.PLAIN["decode_attention_int8"](*args), ATTN_TOL)
    assert TK.launch_counts()["decode_attention_int8"] == before + 1
    assert torch.equal(got, TK.decode_attention_int8(*args, cfg))
    for b, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))


def test_int_kernels_raise_instead_of_falling_back():
    g = torch.Generator(device="cuda").manual_seed(43)
    qt = quantize(torch.randn((64, 256), device="cuda", generator=g),
                  bits=4, group_size=128, axis=-1)
    x = torch.ones(256, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="bits"):      # int4 codes as int8
        TK.qgemv(qt.values, qt.scales, x, bits=8)
    with pytest.raises(ValueError, match="bf16 x"):
        TK.qgemv(qt.values, qt.scales, x.float(), bits=4)
    with pytest.raises(ValueError, match="rows <= 16"):
        TK.batched_qgemv(qt.values, qt.scales, x.expand(17, 256).contiguous(),
                         bits=4)
    with pytest.raises(ValueError, match="unroll"):
        TK.qgemv(qt.values, qt.scales, x, LaunchConfig(unroll=3), bits=4)
    wq, s = mx_weight(np.random.default_rng(44), 64, 48, "fp4")
    with pytest.raises(ValueError, match="rows <= 16"):
        TK.batched_mx_qgemv(wq, s, bf16(np.ones((17, 64))))
    q = torch.ones((1, 4, 64), dtype=torch.bfloat16, device="cuda")
    kv = torch.ones((1, 64, 2, 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="int8"):      # a bf16 cache
        TK.decode_attention_int8(q, kv, kv[..., :1], kv, kv[..., :1],
                                 i32([64]))


def test_tune_the_int_kernels_on_the_card(tmp_path):
    """tune -> cache on the card for the four kernels of the int slice,
    int4 included; the knobs the tuner moves reach the kernels."""
    from repro_torch import tune
    cache = tune.TuneCache(str(tmp_path / "cache.json"))
    points = [("qgemv", {}), ("qgemv", {"bits": 4}), ("batched_qgemv", {}),
              ("batched_mx_qgemv", {}), ("decode_attention_int8", {})]
    for name, extra in points:
        args, kw = tune.REGISTRY[name].example(small=True, device="cuda",
                                               **extra)
        res = tune.tune(name, *args, kernel_kwargs=kw, keep=4, iters=2,
                        cache=cache)
        assert not res.from_cache and res.timings_run >= 2, name
        assert not [c.error for c in res.candidates if c.error], name
        assert 0 < res.fraction <= 1.05, (name, res.fraction)
        again = tune.tune(name, *args, kernel_kwargs=kw, cache=cache)
        assert again.from_cache and again.timings_run == 0
        assert again.best == res.best


# ------------------------------------- full-sequence attention and the scans
FLASH_SPACE = [LaunchConfig(unroll=u, block_k=b) for u in (1, 2)
               for b in (256, 512)]
SCAN_SPACE = [LaunchConfig(block_n=n) for n in (64, 128, 256)]


@pytest.mark.parametrize("cfg", FLASH_SPACE,
                         ids=lambda c: f"unroll{c.unroll}_k{c.block_k}")
@pytest.mark.parametrize("B,T,S,H,KV,hd,causal,dtype", [
    (2, 512, 512, 8, 2, 64, True, torch.float32),    # the registry example
    (1, 100, 77, 4, 2, 32, True, torch.float32),     # ragged, T > S
    (2, 65, 65, 3, 3, 64, True, torch.float32),      # G = 1, ragged
    (1, 77, 200, 4, 1, 128, False, torch.bfloat16),  # T < S, not causal
    (1, 130, 130, 32, 2, 128, True, torch.bfloat16),  # G = 16 (glm4-9b)
    (1, 256, 256, 16, 16, 64, True, torch.bfloat16),  # qwen1.5-0.5b heads
    # the tensor-core tiles' edges: hd 32 (the 64-byte swizzle), T and S
    # not multiples of 64 or 128, causal with T > S, G = 5 (qwen3-14b's 40
    # on 8), and a G = 16 walk over many K/V stages
    (1, 96, 96, 4, 2, 32, True, torch.bfloat16),
    (1, 200, 200, 4, 2, 64, True, torch.bfloat16),
    (1, 77, 300, 4, 1, 64, False, torch.bfloat16),
    (1, 100, 77, 4, 2, 64, True, torch.bfloat16),
    (2, 130, 130, 40, 8, 128, True, torch.bfloat16),
    (1, 1024, 1024, 16, 1, 64, True, torch.bfloat16),
])
def test_flash_attention(B, T, S, H, KV, hd, causal, dtype, cfg):
    g = torch.Generator(device="cuda").manual_seed(50)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype)
               for shape in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    before = TK.launch_counts()["flash_attention"]
    got = TK.flash_attention(q, k, v, causal, cfg)
    assert got.dtype == dtype and got.shape == (B, T, H, hd)
    matches_plain(got, TK.PLAIN["flash_attention"](q, k, v, causal),
                  FLASH_TOL if dtype == torch.float32 else BF16_TOL)
    assert TK.launch_counts()["flash_attention"] == before + 1


def wkv6_case(g, B, T, H, hd, dtype, state):
    r, k, v = (torch.randn((B, T, H, hd), device="cuda", generator=g)
               .to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, T, H, hd), device="cuda",
                                         generator=g))).to(dtype)
    u = 0.5 + 0.1 * torch.randn((H, hd), device="cuda", generator=g)
    s0 = (torch.randn((B, H, hd, hd), device="cuda", generator=g) if state
          else torch.zeros((B, H, hd, hd), device="cuda"))
    return r, k, v, w, u, s0


@pytest.mark.parametrize("cfg", SCAN_SPACE, ids=lambda c: f"n{c.block_n}")
@pytest.mark.parametrize("B,T,H,hd,dtype,state", [
    (1, 256, 4, 64, torch.float32, False),    # the registry example
    (2, 77, 3, 32, torch.float32, True),      # ragged T, nonzero state
    (1, 100, 2, 128, torch.bfloat16, True),
    (1, 5, 2, 64, torch.float32, True),       # shorter than one chunk
])
def test_wkv6(B, T, H, hd, dtype, state, cfg):
    g = torch.Generator(device="cuda").manual_seed(51)
    args = wkv6_case(g, B, T, H, hd, dtype, state)
    before = TK.launch_counts()["rwkv6"]
    y, s = TK.wkv6(*args, cfg)
    assert y.dtype == s.dtype == torch.float32
    want_y, want_s = TK.PLAIN["rwkv6"](*args)
    matches_plain(y, want_y, SCAN_TOL)
    matches_plain(s, want_s, SCAN_TOL)
    assert TK.launch_counts()["rwkv6"] == before + 1


def test_wkv6_with_state_on_the_card():
    """Zeros into the kernel and the state folded in (the JAX form) give
    the kernel run from state0."""
    g = torch.Generator(device="cuda").manual_seed(52)
    args = wkv6_case(g, 1, 96, 4, 64, torch.float32, True)
    y, s = TK.wkv6_with_state(*args)
    y2, s2 = TK.wkv6(*args)
    matches_plain(y, y2, SCAN_TOL)
    matches_plain(s, s2, SCAN_TOL)


@pytest.mark.parametrize("cfg", SCAN_SPACE, ids=lambda c: f"n{c.block_n}")
@pytest.mark.parametrize("b,T,di,dtype,state", [
    (2, 512, 512, torch.float32, False),      # the registry example
    (1, 100, 300, torch.float32, True),       # ragged T and channels
    (1, 64, 256, torch.bfloat16, True),
    (1, 3, 128, torch.float32, True),         # shorter than one tile
])
def test_mamba_scan(b, T, di, dtype, state, cfg):
    g = torch.Generator(device="cuda").manual_seed(53)
    x = torch.randn((b, T, di), device="cuda", generator=g).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, T, di), device="cuda", generator=g)).to(dtype)
    B, C = (torch.randn((b, T, 16), device="cuda", generator=g).to(dtype)
            for _ in range(2))
    A = -torch.exp(torch.randn((di, 16), device="cuda", generator=g))
    D = 1 + 0.1 * torch.randn((di,), device="cuda", generator=g)
    s0 = (torch.randn((b, di, 16), device="cuda", generator=g) if state
          else torch.zeros((b, di, 16), device="cuda"))
    before = TK.launch_counts()["mamba_scan"]
    y, s = TK.mamba_scan(x, dt, B, C, A, D, s0, cfg)
    assert y.dtype == s.dtype == torch.float32
    want_y, want_s = TK.PLAIN["mamba_scan"](x, dt, B, C, A, D, s0)
    matches_plain(y, want_y, SCAN_TOL)
    matches_plain(s, want_s, SCAN_TOL)
    assert TK.launch_counts()["mamba_scan"] == before + 1


def mamba_case(g, b, T, di, dtype, state):
    x = torch.randn((b, T, di), device="cuda", generator=g).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, T, di), device="cuda", generator=g)).to(dtype)
    B, C = (torch.randn((b, T, 16), device="cuda", generator=g).to(dtype)
            for _ in range(2))
    A = -torch.exp(torch.randn((di, 16), device="cuda", generator=g))
    D = 1 + 0.1 * torch.randn((di,), device="cuda", generator=g)
    s0 = (torch.randn((b, di, 16), device="cuda", generator=g) if state
          else torch.zeros((b, di, 16), device="cuda"))
    return x, dt, B, C, A, D, s0


def same_bits_twice(fn, *args):
    first = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    return first


@pytest.mark.parametrize("cfg", SCAN_SPACE, ids=lambda c: f"n{c.block_n}")
@pytest.mark.parametrize("dtype,state", [(torch.float32, False),
                                         (torch.float32, True),
                                         (torch.bfloat16, True)])
def test_wkv6_split_over_columns_at_full_width(dtype, state, cfg):
    """rwkv6-3b's 40 heads of 64 over a short T: 2 blocks of 32 columns a
    head (``wkv6_plan``), the same bits twice, one launch a call."""
    from repro_torch.kernels.rwkv6 import wkv6_plan
    assert wkv6_plan(1, 128, 40, 64, cfg.block_n // 8).cols == 32
    g = torch.Generator(device="cuda").manual_seed(54)
    args = wkv6_case(g, 1, 128, 40, 64, dtype, state)
    before = TK.launch_counts()["rwkv6"]
    y, s = same_bits_twice(lambda *a: TK.wkv6(*a, cfg), *args)
    assert TK.launch_counts()["rwkv6"] == before + 2
    want_y, want_s = TK.PLAIN["rwkv6"](*args)
    matches_plain(y, want_y, SCAN_TOL)
    matches_plain(s, want_s, SCAN_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_wkv6_every_column_slice(hd, chunk):
    """Each slice the kernel is built for (8, 16, 32 columns a block) that
    fits the shared memory, called through the C entry point at a ragged T
    from a nonzero state, against the plain version; a slice wider than hd
    or past the shared memory is refused."""
    from repro_torch.kernels import _build
    rw = importlib.import_module("repro_torch.kernels.rwkv6")
    lib = _build.library("rwkv6", rw._ARGTYPES)
    g = torch.Generator(device="cuda").manual_seed(55)
    B, T, H = 1, 45, 3
    args = wkv6_case(g, B, T, H, hd, torch.float32, True)
    want_y, want_s = TK.PLAIN["rwkv6"](*args)
    for cols in (8, 16, 32):
        y = torch.empty((B, T, H, hd), device="cuda")
        s = torch.empty((B, H, hd, hd), device="cuda")
        err = lib.repro_wkv6_f32(
            *(a.data_ptr() for a in args), y.data_ptr(), s.data_ptr(), B, T,
            H, hd, chunk, cols, _build.stream_handle(y.device))
        if cols > hd or rw.wkv6_smem(hd, chunk, cols, 4) > rw.SMEM_LIMIT:
            assert err != 0
            continue
        _build.check(err, "wkv6")
        matches_plain(y, want_y, SCAN_TOL)
        matches_plain(s, want_s, SCAN_TOL)


@pytest.mark.parametrize("cfg", SCAN_SPACE, ids=lambda c: f"n{c.block_n}")
@pytest.mark.parametrize("b,T,di,dtype,state,lanes", [
    (1, 128, 8192, torch.float32, False, 4),   # jamba's width
    (1, 128, 8192, torch.float32, True, 4),
    (1, 128, 8192, torch.bfloat16, True, 4),
    (1, 64, 4232, torch.float32, True, 4),     # a ragged last block of 32
    (1, 37, 200, torch.float32, True, 16),     # 16 lanes, ragged
])
def test_mamba_scan_states_over_lanes(b, T, di, dtype, state, lanes, cfg):
    """The states of a channel over ``mamba_plan``'s lanes at full width
    over a short T and at ragged channel blocks: the same bits twice, one
    launch a call."""
    from repro_torch.kernels.mamba_scan import mamba_plan
    assert mamba_plan(b, T, di, cfg.block_n // 8).lanes == lanes
    g = torch.Generator(device="cuda").manual_seed(56)
    args = mamba_case(g, b, T, di, dtype, state)
    before = TK.launch_counts()["mamba_scan"]
    y, s = same_bits_twice(lambda *a: TK.mamba_scan(*a, cfg), *args)
    assert TK.launch_counts()["mamba_scan"] == before + 2
    want_y, want_s = TK.PLAIN["mamba_scan"](*args)
    matches_plain(y, want_y, SCAN_TOL)
    matches_plain(s, want_s, SCAN_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("lanes", [4, 16])
def test_mamba_scan_either_lane_split(lanes, chunk):
    """Both lane splits through the C entry point on one input (ragged T
    and channels, nonzero state), each against the plain version."""
    from repro_torch.kernels import _build
    mb = importlib.import_module("repro_torch.kernels.mamba_scan")
    lib = _build.library("mamba_scan", mb._ARGTYPES)
    g = torch.Generator(device="cuda").manual_seed(57)
    b, T, di = 2, 45, 300
    args = mamba_case(g, b, T, di, torch.float32, True)
    want_y, want_s = TK.PLAIN["mamba_scan"](*args)
    y = torch.empty((b, T, di), device="cuda")
    s = torch.empty((b, di, 16), device="cuda")
    _build.check(lib.repro_mamba_scan_f32(
        *(a.data_ptr() for a in args), y.data_ptr(), s.data_ptr(), b, T, di,
        16, chunk, lanes, _build.stream_handle(y.device)), "mamba_scan")
    matches_plain(y, want_y, SCAN_TOL)
    matches_plain(s, want_s, SCAN_TOL)


def test_attention_and_scans_raise_instead_of_falling_back():
    f32 = dict(device="cuda", dtype=torch.float32)
    q = torch.ones((1, 8, 4, 64), **f32)
    kv = torch.ones((1, 8, 2, 64), **f32)
    with pytest.raises(ValueError, match="all fp32 or all bf16"):
        TK.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="all fp32 or all bf16"):
        TK.flash_attention(q, kv.bfloat16(), kv.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        TK.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           kv, kv)
    with pytest.raises(ValueError, match="block_k"):
        TK.flash_attention(q, kv, kv, True, LaunchConfig(unroll=4))
    r = torch.ones((1, 8, 2, 64), **f32)
    u, s0 = torch.ones((2, 64), **f32), torch.zeros((1, 2, 64, 64), **f32)
    with pytest.raises(ValueError, match="one dtype"):
        TK.wkv6(r, r, r, r.bfloat16(), u, s0)
    with pytest.raises(ValueError, match="fp32 u"):
        TK.wkv6(r, r, r, r, u.bfloat16(), s0)
    with pytest.raises(ValueError, match="contiguous"):
        TK.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), r, r, r, u,
                s0)
    with pytest.raises(ValueError, match="block_n"):
        TK.wkv6(r, r, r, r, u, s0, LaunchConfig(block_n=512))
    x = torch.ones((1, 8, 32), **f32)
    bc = torch.ones((1, 8, 16), **f32)
    A, D = -torch.ones((32, 16), **f32), torch.ones((32,), **f32)
    h0 = torch.zeros((1, 32, 16), **f32)
    with pytest.raises(ValueError, match="one dtype"):
        TK.mamba_scan(x.half(), x.half(), bc.half(), bc.half(), A, D, h0)
    with pytest.raises(ValueError, match="fp32 A"):
        TK.mamba_scan(x, x, bc, bc, A.bfloat16(), D, h0)
    with pytest.raises(ValueError, match="contiguous"):
        TK.mamba_scan(x, x.transpose(1, 2).contiguous().transpose(1, 2),
                      bc, bc, A, D, h0)
    with pytest.raises(ValueError, match="16"):          # d_state 8
        TK.mamba_scan(x, x, bc[..., :8].contiguous(), bc[..., :8].contiguous(),
                      A[:, :8].contiguous(), D, h0[..., :8].contiguous())


def test_tune_attention_and_scans_on_the_card(tmp_path):
    """tune -> cache on the card for the three names at their small
    registry examples: every candidate launches, every fraction lies in
    (0, 1.05], the second pass comes from the cache."""
    from repro_torch import tune
    cache = tune.TuneCache(str(tmp_path / "cache.json"))
    for name in ("flash_attention", "rwkv6", "mamba_scan"):
        args, kw = tune.REGISTRY[name].example(small=True, device="cuda")
        res = tune.tune(name, *args, kernel_kwargs=kw, keep=4, iters=2,
                        cache=cache)
        assert not res.from_cache and res.timings_run >= 3, name
        assert not [c.error for c in res.candidates if c.error], name
        assert 0 < res.fraction <= 1.05, (name, res.fraction)
        again = tune.tune(name, *args, kernel_kwargs=kw, cache=cache)
        assert again.from_cache and again.timings_run == 0
        assert again.best == res.best


# ------------------------------------------- the serving steps as CUDA graphs
GRAPH_ENGINE = dict(slots=3, cache_len=128, backend="paged",
                    chunked_prefill=True, chunk_size=16, prefix_cache=True,
                    kernel_decode=True)


def graph_model(kv):
    """The reduced qwen1.5-0.5b (2 layers, 4 heads of 32 on 4 KV heads:
    G = 1) in bf16 on the card, seed 0, its paged attention on the
    kernels; ``kv`` "int8" for int8 pages."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import RuntimeConfig, build_model
    return build_model(reduced(get_config("qwen1.5-0.5b")),
                       RuntimeConfig(paged_kernel_decode=True,
                                     kv_cache_dtype=kv),
                       device="cuda", seed=0)


def graph_engine(model, kv, capture=True):
    from repro_torch.serve import EngineConfig, build_engine
    return build_engine(model, EngineConfig(**GRAPH_ENGINE,
                                            kv_cache_dtype=kv),
                        capture=capture)


def graph_requests(eng):
    """Five seeded prompts behind a shared 40-token prefix (prefix hits,
    a copy-on-write), 8 new tokens each, submitted to ``eng``."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(11)
    V = eng.model.cfg.vocab_size
    sysp = rng.integers(1, V, 40)
    reqs = [Request(rid=i, prompt=np.concatenate(
        [sysp, rng.integers(1, V, int(n))]).astype(np.int32),
        max_new_tokens=8) for i, n in enumerate(rng.integers(8, 60, 5))]
    for r in reqs:
        eng.submit(r)
    return reqs


@pytest.mark.parametrize("kv", ["", "int8"], ids=["bf16", "int8"])
def test_engine_graph_against_eager(kv):
    """The engine's captured chunk and decode steps (the whole step, the
    programmatic dependent ``rmsnorm`` after the ops that write its x
    included) emit the eager steps' greedy tokens bit for bit, and the
    launch counters read what the eager launches count: the same kernels
    in the same order.  One capture per step kind."""
    from repro_torch.models import modules as TM
    model = graph_model(kv)
    out = {}
    for capture in (True, False):
        eng = graph_engine(model, kv, capture)
        reqs = graph_requests(eng)
        TK.reset_launch_counts()
        with TM.kernel_routing():
            eng.run_until_drained()
        torch.cuda.synchronize()
        assert all(r.done and len(r.out) == 8 for r in reqs)
        out[capture] = ([r.out for r in reqs], TK.launch_counts(),
                        eng.captures)
    (got, launches, captures), (want, eager, none) = out[True], out[False]
    assert got == want
    assert launches == eager
    decode = "paged_decode_attention_int8" if kv else \
        "paged_decode_attention"
    assert launches["rmsnorm"] and launches[decode] and launches["gemv"]
    assert captures == {"chunk": 1, "decode": 1}
    assert none == {"chunk": 0, "decode": 0}


def test_graph_replay_does_not_sync_the_host():
    """Once captured, a step's ``run`` (pinned host copies, non-blocking
    transfers, the replay) makes no host sync: replays under
    ``set_sync_debug_mode("error")``, after the engine drained, on batches
    whose tables point at the NULL page."""
    from repro_torch.models import modules as TM
    model = graph_model("")
    eng = graph_engine(model, "")
    graph_requests(eng)
    with TM.kernel_routing():
        while eng.decode_graph.out is None:
            eng.step()
        eng.run_until_drained()
        hosts = [(g, {k: np.zeros(tuple(t.shape), np.int32)
                      for k, t in g.inputs.items()})
                 for g in (eng.chunk_graph, eng.decode_graph)]
        hosts[0][1]["valid"][:] = 1        # a slab has a last valid row
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                for g, host in hosts:
                    g.run(host)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eng.captures == {"chunk": 1, "decode": 1}


def test_a_failed_capture_raises_and_never_steps_eagerly():
    """A step the card cannot capture (``.item()`` syncs the host) raises
    from ``run``, every time: after the warm-up and the refused capture
    nothing runs the step eagerly in the replay's place, no output is
    bound and the launch counters are as they were.  The card works on
    after it."""
    from repro_torch.serve.graphs import StepGraph
    calls = []
    x = torch.zeros(4, device="cuda")

    def step(batch, caches):
        calls.append(torch.cuda.is_current_stream_capturing())
        if (batch["tokens"].float().sum() + x.sum()).item() < 0:
            raise AssertionError("unreachable")
        return batch["tokens"] + 1, caches
    g = StepGraph(step, [], torch.device("cuda"))
    before = TK.launch_snapshot()
    for _ in range(2):
        with pytest.raises(RuntimeError):
            g.run({"tokens": np.ones((2, 1), np.int32)})
    assert calls == [False, True, False, True]
    assert g.out is None and g.captures == 0
    assert TK.launch_snapshot() == before
    torch.cuda.synchronize()
    assert torch.equal(x + 1, torch.ones(4, device="cuda"))


def test_duplicate_paged_writes_leave_the_last_row():
    """Rows that target one position of a page pool (the idle slots' and
    pad rows' writes into the NULL page) leave the last such row's values,
    the same bits in every repeat: the sequential write of the CPU and of
    the JAX package's scatter there."""
    from repro_torch.models import attention as TA
    rng = np.random.default_rng(3)
    B, page, KV, hd = 64, 16, 4, 64
    pool = bf16(rng.standard_normal((3, page, KV, hd)))
    new = bf16(rng.standard_normal((B, 1, KV, hd)))
    pos = i32(np.arange(B) % 4)          # 16 rows each into rows 0..3
    tables = i32(np.zeros((B, 2), np.int32))        # all on the NULL page
    want = pool.clone()
    for b in range(B):
        want[0, b % 4] = new[b, 0]
    for _ in range(5):
        got = TA.update_paged_cache(pool.clone(), new, pos, tables)
        assert torch.equal(got, want)
