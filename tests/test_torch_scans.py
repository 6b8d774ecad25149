"""Full-sequence attention and the two recurrences of the port on the CPU:
``flash_attention``, ``wkv6`` (registered as ``rwkv6``), ``wkv6_with_state``
and ``mamba_scan``, each plain version against the JAX oracle
(``repro.kernels.ref``) and the interpret-mode Pallas kernel on the same
numpy inputs (the CUDA kernels against their plain versions are in
``test_torch_cuda.py``).

Tolerances are the JAX package's own tests': 2e-4 for ``flash_attention``
in fp32 (softmax-weighted means of order 0.1 to 1, the same fp32 math in
another order, the Pallas side through an online softmax), 2e-2 where the
output is bf16 (both sides round fp32 to bf16, ~3 significant digits), and
1e-4 for the scans (fp32 states of order 1 to 10, carried over T steps:
the oracles multiply the decays step by step, the Pallas kernels sum their
logarithms in chunks).

The Pallas ``wkv6`` and ``mamba_scan`` zero their state at the first grid
step and never read ``state0``; the port's kernels start from it.  The
tests pin both sides of that: the port equals the Pallas kernels at zero
state and the JAX oracles at any state, and ``wkv6_with_state`` passes
zeros to the kernel and folds the state in afterwards, as the JAX one does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro_torch.kernels as KD  # noqa: E402
from repro.core.troop import TroopConfig  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan  # noqa: E402
from repro_torch.core.troop import LaunchConfig  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_plan  # noqa: E402
from repro_torch.kernels.rwkv6 import wkv6_plan  # noqa: E402

INTERPRET = TroopConfig(interpret=True)     # explicit: no tune-cache lookup
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SCAN_TOL = 1e-4


def both(a, dtype="float32"):
    """One numpy array as (jax array, torch CPU tensor) in ``dtype``."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ flash_attention
@pytest.mark.parametrize("B,T,S,H,KV,hd,causal,dtype", [
    (1, 64, 64, 4, 2, 32, True, "float32"),      # T = S, G = 2
    (2, 32, 64, 4, 4, 32, True, "float32"),      # T < S, G = 1
    (1, 48, 48, 2, 2, 64, False, "float32"),     # not causal
    (1, 64, 64, 8, 2, 32, True, "bfloat16"),     # G = 4 in bf16
    (1, 32, 64, 4, 1, 32, False, "bfloat16"),    # T < S, G = 4, not causal
])
def test_flash_attention_plain_matches_jax(B, T, S, H, KV, hd, causal,
                                           dtype):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.standard_normal(shape), dtype)
        for shape in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    got = TK.flash_attention(qt, kt, vt, causal)
    assert got.dtype == qt.dtype and got.shape == (B, T, H, hd)
    close(got, JR.flash_attention(qj, kj, vj, causal=causal),
          FLASH_TOL[dtype])
    close(got, JK.flash_attention(qj, kj, vj, causal, INTERPRET),
          FLASH_TOL[dtype])


def test_flash_attention_causal_is_top_left_aligned():
    """Query t sees positions 0..t even when S > T (SDPA's is_causal)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 2, 32), (1, 9, 2, 32), (1, 9, 2, 32)))
    got = TK.flash_attention(q, k, v, True)
    for t in range(4):
        want = TK.flash_attention(q[:, t:t + 1], k[:, :t + 1], v[:, :t + 1],
                                  False)
        torch.testing.assert_close(got[:, t:t + 1], want, rtol=1e-6,
                                   atol=1e-6)


# ----------------------------------------------------------------------- wkv6
def wkv6_inputs(rng, B, T, H, hd, state=False):
    r, k, v = (rng.standard_normal((B, T, H, hd)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hd))))
    u = 0.5 + 0.1 * rng.standard_normal((H, hd))
    s0 = (rng.standard_normal((B, H, hd, hd)) if state
          else np.zeros((B, H, hd, hd)))
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,T,H,hd,dtype", [(2, 64, 2, 32, "float32"),
                                            (1, 48, 3, 16, "float32"),
                                            (1, 40, 2, 32, "bfloat16")])
def test_wkv6_plain_matches_jax_at_zero_state(B, T, H, hd, dtype):
    rng = np.random.default_rng(2)
    r, k, v, w, u, s0 = wkv6_inputs(rng, B, T, H, hd)
    jx = [both(a, dtype) for a in (r, k, v, w)] + [both(u), both(s0)]
    y, s = TK.wkv6(*(t for _, t in jx))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, T, H, hd) and s.shape == (B, H, hd, hd)
    args_j = [j for j, _ in jx]
    for want_y, want_s in (JR.wkv6(*args_j),
                           JK.wkv6(*args_j, INTERPRET)):
        close(y, want_y, SCAN_TOL)
        close(s, want_s, SCAN_TOL)


def test_wkv6_starts_from_state0_where_pallas_does_not():
    """The port's wkv6 is the JAX oracle at any state; the Pallas kernel
    ignores state0 (its docstring: it must be zeros)."""
    rng = np.random.default_rng(3)
    r, k, v, w, u, s0 = wkv6_inputs(rng, 1, 32, 2, 32, state=True)
    jx = [both(a) for a in (r, k, v, w, u, s0)]
    args_j = [j for j, _ in jx]
    y, s = TK.wkv6(*(t for _, t in jx))
    want_y, want_s = JR.wkv6(*args_j)
    close(y, want_y, SCAN_TOL)
    close(s, want_s, SCAN_TOL)
    py, ps = JK.wkv6(*args_j, INTERPRET)
    zy, zs = JK.wkv6(*args_j[:5], jnp.zeros_like(args_j[5]), INTERPRET)
    np.testing.assert_array_equal(np.asarray(py), np.asarray(zy))
    np.testing.assert_array_equal(np.asarray(ps), np.asarray(zs))
    assert np.abs(np.asarray(py) - np.asarray(want_y)).max() > 1e-2


def test_wkv6_with_state_matches_jax(monkeypatch):
    """The JAX form: the kernel from zeros, the state folded in after."""
    rng = np.random.default_rng(4)
    r, k, v, w, u, s0 = wkv6_inputs(rng, 2, 48, 2, 32, state=True)
    jx = [both(a) for a in (r, k, v, w, u, s0)]
    args_j, args_t = [j for j, _ in jx], [t for _, t in jx]
    seen = []
    kernel = TK.wkv6

    def spy(*a, **kw):
        seen.append(a[5].clone())
        return kernel(*a, **kw)
    monkeypatch.setattr(TK, "wkv6", spy)
    y, s = TK.wkv6_with_state(*args_t)
    assert len(seen) == 1 and not seen[0].any()
    for want_y, want_s in (JK.wkv6_with_state(*args_j, INTERPRET),
                           JR.wkv6(*args_j)):
        close(y, want_y, SCAN_TOL)
        close(s, want_s, SCAN_TOL)
    # the port's wkv6 from state0 gives the same function
    y2, s2 = kernel(*args_t)
    close(y2, y.numpy(), SCAN_TOL)
    close(s2, s.numpy(), SCAN_TOL)


# ----------------------------------------------------------------- mamba_scan
def mamba_inputs(rng, b, T, di, ds, state=False):
    x = rng.standard_normal((b, T, di))
    dt = np.log1p(np.exp(rng.standard_normal((b, T, di))))     # softplus
    B, C = (rng.standard_normal((b, T, ds)) for _ in range(2))
    A = -np.exp(rng.standard_normal((di, ds)))
    D = 1 + 0.1 * rng.standard_normal(di)
    s0 = (rng.standard_normal((b, di, ds)) if state
          else np.zeros((b, di, ds)))
    return x, dt, B, C, A, D, s0


@pytest.mark.parametrize("b,T,di,dtype", [
    (2, 32, 512, "float32"),      # two Pallas channel blocks of 256
    (1, 40, 128, "float32"),
    (1, 24, 256, "bfloat16"),
])
def test_mamba_scan_plain_matches_jax_at_zero_state(b, T, di, dtype):
    rng = np.random.default_rng(5)
    x, dt, B, C, A, D, s0 = mamba_inputs(rng, b, T, di, 16)
    jx = [both(a, dtype) for a in (x, dt, B, C)] + [both(a)
                                                    for a in (A, D, s0)]
    y, s = TK.mamba_scan(*(t for _, t in jx))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (b, T, di) and s.shape == (b, di, 16)
    args_j = [j for j, _ in jx]
    for want_y, want_s in (JR.mamba_scan(*args_j),
                           jax_mamba_scan(*args_j, INTERPRET)):
        close(y, want_y, SCAN_TOL)
        close(s, want_s, SCAN_TOL)


def test_mamba_scan_starts_from_state0_where_pallas_does_not():
    rng = np.random.default_rng(6)
    x, dt, B, C, A, D, s0 = mamba_inputs(rng, 2, 32, 512, 16, state=True)
    jx = [both(a) for a in (x, dt, B, C, A, D, s0)]
    args_j = [j for j, _ in jx]
    y, s = TK.mamba_scan(*(t for _, t in jx))
    want_y, want_s = JR.mamba_scan(*args_j)
    close(y, want_y, SCAN_TOL)
    close(s, want_s, SCAN_TOL)
    py, _ = jax_mamba_scan(*args_j, INTERPRET)
    zy, _ = jax_mamba_scan(*args_j[:6], jnp.zeros_like(args_j[6]), INTERPRET)
    np.testing.assert_array_equal(np.asarray(py), np.asarray(zy))
    assert np.abs(np.asarray(py) - np.asarray(want_y)).max() > 1e-2


# ------------------------------------ the CUDA kernels' arithmetic, in numpy
# ``csrc/rwkv6.cu`` and ``csrc/mamba_scan.cu`` run only on the card; these
# emulations follow their arithmetic step for step in fp32 (exp2 of
# log2-scaled sums, the sub-chunk factoring, the column slices and lane
# splits of the launch plans, the tile-end reduction order) and are held
# to the JAX oracles at SCAN_TOL.  Every exponent they pass to exp2 is
# recorded and must be <= 0.  Inputs come from explicit numpy seeds.
F32 = np.float32
LOG2E = F32(1.4426950408889634)


class Exp2:
    """exp2 in fp32 that keeps the largest exponent it was given."""

    def __init__(self):
        self.top = -np.inf

    def __call__(self, x):
        x = np.asarray(x, F32)
        if x.size:
            self.top = max(self.top, float(x.max()))
        return np.exp2(x).astype(F32)


def wkv6_emulate(r, k, v, w, u, s0, chunk, ex2):
    """``csrc/rwkv6.cu``'s walk: per block of ``wkv6_plan`` (a (batch,
    head) and a slice of ``cols`` state columns), per chunk of ``chunk``
    steps, the decays in log2 units summed inside sub-chunks of 4, the
    rows factored at the sub-chunk boundaries, the pair scores (within a
    sub-chunk directly, across them as a product with the decay between
    the sub-chunks), then y and the state's slice."""
    r, k, v, w, u, s0 = (np.asarray(a, F32) for a in (r, k, v, w, u, s0))
    B, T, H, hd = r.shape
    plan = wkv6_plan(B, T, H, hd, chunk)
    L, G, nsub = chunk, plan.sub, chunk // plan.sub
    y = np.zeros((B, T, H, hd), F32)
    S = s0.copy()
    for b in range(B):
        for h in range(H):
            for cb in range(plan.col_blocks):
                cols = slice(cb * plan.cols, (cb + 1) * plan.cols)
                St = s0[b, h][:, cols].copy()                 # (hd, cols)
                for t0 in range(0, T, L):
                    n = min(L, T - t0)
                    rr, kk = (np.zeros((L, hd), F32) for _ in range(2))
                    vv = np.zeros((L, plan.cols), F32)
                    rr[:n], kk[:n] = r[b, t0:t0 + n, h], k[b, t0:t0 + n, h]
                    vv[:n] = v[b, t0:t0 + n, h, cols]
                    lw = np.zeros((L, hd), F32)
                    lw[:n] = np.log(np.maximum(w[b, t0:t0 + n, h],
                                               F32(1e-30))) * LOG2E
                    lcm = np.zeros((L, hd), F32)
                    for q in range(nsub):
                        cum = np.zeros(hd, F32)
                        for s in range(G):
                            cum = cum + lw[q * G + s]
                            lcm[q * G + s] = cum
                    tot = lcm[G - 1::G]                       # (nsub, hd)
                    Cb = np.zeros((nsub + 1, hd), F32)        # boundaries
                    for q in range(nsub):
                        Cb[q + 1] = Cb[q] + tot[q]
                    rq, rd, kq, kd = (np.zeros((L, hd), F32)
                                      for _ in range(4))
                    for q in range(nsub):
                        ts = slice(q * G, (q + 1) * G)
                        lcx = np.concatenate([np.zeros((1, hd), F32),
                                              lcm[ts][:-1]])
                        rq[ts] = rr[ts] * ex2(lcx)
                        rd[ts] = rq[ts] * ex2(Cb[q])
                        kq[ts] = kk[ts] * ex2(tot[q] - lcm[ts])
                        kd[ts] = kq[ts] * ex2(Cb[nsub] - Cb[q + 1])
                    A = np.zeros((L, L), F32)
                    for t in range(L):
                        q = t // G
                        for s in range(q * G):                # across
                            p = s // G
                            A[t, s] = np.dot(rq[t] * ex2(Cb[q] - Cb[p + 1]),
                                             kq[s])
                        for s in range(q * G, t):             # within
                            A[t, s] = np.dot(rr[t] * kk[s],
                                             ex2(lcm[t - 1] - lcm[s]))
                        A[t, t] = np.dot(rr[t] * u[h], kk[t])
                    yc = rd @ St + A @ vv
                    y[b, t0:t0 + n, h, cols] = yc[:n]
                    St = ex2(Cb[nsub])[:, None] * St + kd.T @ vv
                S[b, h][:, cols] = St
    return y, S


def mamba_emulate(x, dt, B, C, A, D, s0, chunk, ex2):
    """``csrc/mamba_scan.cu``'s walk: ``mamba_plan``'s lanes a channel,
    each lane's states advanced with exp(dt A) and its partial sums of h C
    kept for a tile, then the transpose-reduce over the channel's lanes at
    the tile's end in the kernel's order (each round a lane keeps one half
    of its sums and adds its partner's copy of that half; past one sum a
    lane, plain pairwise adds), then + x D.  ``ex2`` takes the exponent in
    log2 units (dt A log2(e))."""
    x, dt, B, C, A, D, s0 = (np.asarray(a, F32)
                             for a in (x, dt, B, C, A, D, s0))
    b, T, di = x.shape
    plan = mamba_plan(b, T, di, chunk)
    L, lanes, spl = chunk, plan.lanes, plan.states
    an = A.reshape(di, lanes, spl)                            # (di, g, s)
    h = s0.reshape(b, di, lanes, spl).copy()
    y = np.zeros((b, T, di), F32)
    g = np.arange(lanes)
    for t0 in range(0, T, L):
        n = min(L, T - t0)
        xs, dts = (np.zeros((b, L, di), F32) for _ in range(2))
        bs, cs = (np.zeros((b, L, 16), F32) for _ in range(2))
        xs[:, :n], dts[:, :n] = x[:, t0:t0 + n], dt[:, t0:t0 + n]
        bs[:, :n], cs[:, :n] = B[:, t0:t0 + n], C[:, t0:t0 + n]
        part = np.zeros((b, di, lanes, L), F32)
        for t in range(L):
            dtv = dts[:, t][..., None, None]                  # (b, di, 1, 1)
            dtx = dtv * xs[:, t][..., None, None]
            bv = bs[:, t].reshape(b, 1, lanes, spl)
            cv = cs[:, t].reshape(b, 1, lanes, spl)
            e = ex2(dtv * an[None] * LOG2E)
            acc = np.zeros((b, di, lanes), F32)
            for s in range(spl):
                h[..., s] = e[..., s] * h[..., s] + dtx[..., 0] * bv[..., s]
                acc = acc + h[..., s] * cv[..., s]
            part[..., t] = acc
        first, cnt = np.zeros(lanes, np.int64), L
        o = lanes // 2
        while o >= 1:
            partner = g ^ o
            if cnt >= 2:
                half, upper = cnt // 2, (g & o) != 0
                lo, hi = part[..., :half], part[..., half:cnt]
                keep = np.where(upper[:, None], hi, lo)
                got = np.where(upper[:, None], hi[..., partner, :],
                               lo[..., partner, :])
                part = np.concatenate([keep + got, part[..., half:]], -1)
                first = first + upper * half
                cnt = half
            else:
                part[..., 0] = part[..., 0] + part[..., partner, 0]
            o //= 2
        for lane in range(lanes):
            if lane & max(lanes // L - 1, 0):
                continue                  # its pair's lower lane writes
            for m in range(max(L // lanes, 1)):
                t = first[lane] + m
                if t < n:
                    y[:, t0 + t] = part[:, :, lane, m] + xs[:, t] * D
    return y, h.reshape(b, di, 16)


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("B,T,H,hd,state,w_kind", [
    (1, 64, 2, 64, False, "model"),         # whole chunks, zero state
    (2, 77, 3, 32, True, "model"),          # ragged T, nonzero state
    (1, 40, 1, 128, True, "model"),
    (1, 45, 2, 64, True, "extreme"),        # w in {1e-30, 1} and between
    (1, 37, 1, 32, True, "floor"),          # every w = 1e-30: lw = -69.08
    (1, 36, 1, 32, True, "one"),            # every w = 1: no decay
])
def test_wkv6_kernel_arithmetic_matches_jax(B, T, H, hd, state, w_kind,
                                            chunk):
    """The kernel's chunk walk (numpy, fp32) against the JAX oracle, and
    at zero state against the interpret-mode Pallas kernel; every
    exponent <= 0, every output finite."""
    rng = np.random.default_rng(100 + chunk)
    r, k, v, w, u, s0 = wkv6_inputs(rng, B, T, H, hd, state)
    if w_kind != "model":
        pick = {"extreme": rng.integers(0, 3, w.shape),
                "floor": np.zeros(w.shape, int),
                "one": np.ones(w.shape, int)}[w_kind]
        w = np.choose(pick, [np.full(w.shape, 1e-30), np.ones(w.shape), w])
    ex2 = Exp2()
    y, s = wkv6_emulate(r, k, v, w, u, s0, chunk, ex2)
    assert ex2.top <= 0.0
    assert np.isfinite(y).all() and np.isfinite(s).all()
    args_j = [jnp.asarray(np.asarray(a, np.float32))
              for a in (r, k, v, w, u, s0)]
    want_y, want_s = JR.wkv6(*args_j)
    close(y, want_y, SCAN_TOL)
    close(s, want_s, SCAN_TOL)
    if not state and T % chunk == 0:
        py, ps = JK.wkv6(*args_j, TroopConfig(interpret=True,
                                              block_n=8 * chunk))
        close(y, py, SCAN_TOL)
        close(s, ps, SCAN_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("b,T,di,state", [
    (1, 64, 512, False),      # one lane group of 16 (few blocks)
    (2, 45, 300, True),       # ragged T and channels
    (1, 40, 4224, True),      # 4 lanes of 4 states (132 blocks of 32)
])
def test_mamba_kernel_arithmetic_matches_jax(b, T, di, state, chunk):
    """The kernel's lane split and tile-end reduction (numpy, fp32)
    against the JAX oracle, and at zero state against the interpret-mode
    Pallas kernel; every exponent <= 0."""
    rng = np.random.default_rng(200 + chunk)
    x, dt, B, C, A, D, s0 = mamba_inputs(rng, b, T, di, 16, state)
    ex2 = Exp2()
    y, s = mamba_emulate(x, dt, B, C, A, D, s0, chunk, ex2)
    assert ex2.top <= 0.0
    assert np.isfinite(y).all() and np.isfinite(s).all()
    args_j = [jnp.asarray(np.asarray(a, np.float32))
              for a in (x, dt, B, C, A, D, s0)]
    want_y, want_s = JR.mamba_scan(*args_j)
    close(y, want_y, SCAN_TOL)
    close(s, want_s, SCAN_TOL)
    if not state and di % 256 == 0:
        py, ps = jax_mamba_scan(*args_j, TroopConfig(interpret=True,
                                                     block_n=8 * chunk))
        close(y, py, SCAN_TOL)
        close(s, ps, SCAN_TOL)


def test_mamba_plans_of_the_emulated_shapes():
    """The emulations above reach both lane splits."""
    assert mamba_plan(1, 64, 512, 32).lanes == 16
    assert mamba_plan(1, 40, 4224, 32).lanes == 4


# -------------------------------------------------------------- wrapper rules
def test_dispatching_entry_points_run_plain_on_the_cpu(tmp_path, monkeypatch):
    """Without a config the registry's entry points resolve one (the
    default on an empty cache) and, on CPU tensors, run the plain
    versions; no launch is counted."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "c.json"))
    TK.reset_launch_counts()
    for name, entry in (("flash_attention", KD.flash_attention),
                        ("rwkv6", KD.wkv6), ("mamba_scan", KD.mamba_scan)):
        args, kw = KD.REGISTRY[name].example(small=True, device="cpu")
        got = entry(*args, **kw)
        want = TK.PLAIN[name](*args, **kw)
        for g, w_ in zip(*(o if isinstance(o, tuple) else (o,)
                           for o in (got, want))):
            torch.testing.assert_close(g, w_, rtol=0, atol=0)
    assert TK.launch_counts() == {k: 0 for k in TK.launch_counts()}


@pytest.mark.parametrize("name", ["flash_attention", "rwkv6", "mamba_scan"])
def test_new_wrappers_raise_off_cpu_without_kernel(name):
    """A tensor neither on the CPU nor on a CUDA card is refused: the
    wrappers never fall back to the plain version off the CPU."""
    args, kw = KD.REGISTRY[name].example(small=True, device="cpu")
    metas = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        KD.REGISTRY[name].fn(*metas, cfg=LaunchConfig(), **kw)


def test_plain_scans_take_the_oracles_order_of_operations():
    """The plain versions are the JAX oracles line for line: one step of
    each by hand, from a nonzero state."""
    rng = np.random.default_rng(7)
    r, k, v, w, u, s0 = (torch.from_numpy(a.astype(np.float32)) for a in
                         wkv6_inputs(rng, 1, 1, 1, 4, state=True))
    y, s = TR.wkv6(r, k, v, w, u, s0)
    rt, kt, vt, wt = r[:, 0], k[:, 0], v[:, 0], w[:, 0]
    want_y = (torch.einsum("bhi,bhij->bhj", rt, s0)
              + torch.sum(rt * u[None] * kt, -1, keepdim=True) * vt)
    torch.testing.assert_close(y[:, 0], want_y, rtol=0, atol=0)
    torch.testing.assert_close(
        s, wt[..., None] * s0 + kt[..., None] * vt[..., None, :],
        rtol=0, atol=0)
    x, dt, B, C, A, D, h0 = (torch.from_numpy(a.astype(np.float32)) for a in
                             mamba_inputs(rng, 1, 1, 3, 16, state=True))
    y, h = TR.mamba_scan(x, dt, B, C, A, D, h0)
    want_h = (torch.exp(dt[0, 0, :, None] * A) * h0[0]
              + dt[0, 0, :, None] * B[0, 0][None] * x[0, 0, :, None])
    torch.testing.assert_close(h[0], want_h, rtol=0, atol=0)
    torch.testing.assert_close(
        y[0, 0], want_h @ C[0, 0] + x[0, 0] * D, rtol=1e-6, atol=1e-6)
