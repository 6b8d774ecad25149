#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each one against its plain PyTorch version at the serving shapes and
times it, then serves full-width qwen1.5-0.5b (random weights from seed 0)
through the chunked, paged engine with every kernel on — once with bf16
weights and KV pages, once with mx4 weights and int8 KV pages — and checks
that each path went through its kernels, that the allocator balances and
that the kernel path's logits agree with the plain path's.  Every phase
fails loudly.  It prints the card's ``nvidia-smi`` name and power limit,
one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.  ``--record DIR`` also writes the full record
(``chip_smoke.json``: nvcc/ptxas output, every timing and engine metric)
and the profiler traces of the decode windows (``decode_trace.json.gz``,
``decode_trace_quant.json.gz``) to DIR.
"""
from __future__ import annotations

import argparse
import gzip
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate
# and the bf16 tensor-core rate.  The functions' inputs are bf16, so the
# bound takes that rate, whatever units a kernel happens to compute on.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
# Kernel vs plain version.  rmsnorm and gemv give bf16/fp32 outputs of order
# 1: bf16 keeps ~3 significant digits.  The attention outputs are softmax-
# weighted means of N(0, 1) rows, of order 0.1; their measured errors are
# 6e-5 to 1e-3, and 4e-3 leaves fourfold headroom above the largest.  The
# kernels of the quantized path take fourfold headroom over their first
# measured errors (chip call 4 of PR 12, seeded inputs, which reproduce
# them): the int8-pool decode 6.1e-5 (one bf16 rounding flip; both
# dequantize in fp32) -> 2.5e-4; mx_qgemv 1.2e-6 and mx_qgemv_swiglu 1.4e-6
# (fp32 outputs of order 1 from the same dequantized weights — the kernel
# builds 2^(s - 127) exactly, the plain version as exp((s - 127) ln2) —
# summed in another order) -> 5e-6 and 6e-6.
BF16_TOL = 2e-2
TOL = {"rmsnorm": BF16_TOL, "gemv": BF16_TOL,
       "paged_decode_attention": 4e-3, "prefill_attention_paged": 4e-3,
       "paged_decode_attention_int8": 2.5e-4, "mx_qgemv": 5e-6,
       "mx_qgemv_swiglu": 6e-6}
ROOT = Path(__file__).resolve().parent

REPLACES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:40"),
    "gemv": ("src/repro_torch/kernels/csrc/gemv.cu",
             "src/repro/kernels/gemv.py:87"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:289"),
    "prefill_attention_paged": (
        "src/repro_torch/kernels/csrc/prefill_attention.cu",
        "src/repro/kernels/prefill_attention.py:185"),
    "paged_decode_attention_int8": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:514"),
    "mx_qgemv": ("src/repro_torch/kernels/csrc/mx_gemv.cu",
                 "src/repro/quant/kernels.py:352"),
    "mx_qgemv_swiglu": ("src/repro_torch/kernels/csrc/mx_gemv.cu",
                        "src/repro/quant/kernels.py:428"),
}
# the kernels of each served path: bf16 weights and pages, then mx4 weights
# and int8 pages (whose main path also runs rmsnorm and, at chunk steps,
# the read-out through mx_qgemv)
BF16_PATH = ("rmsnorm", "gemv", "paged_decode_attention",
             "prefill_attention_paged")
QUANT_PATH = ("paged_decode_attention_int8", "mx_qgemv", "mx_qgemv_swiglu")


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float):
    """The least time for the function: bytes moved (each input read once,
    each output written once) over the memory rate, or operations over the
    bf16 peak, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _event_ms(torch, run, reps: int) -> float:
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms(torch, fns, reps: int = 25, inner: int = 20):
    """(device ms, eager ms) per call of ``fns``, each the median over
    ``reps`` CUDA-event windows of ``inner`` calls.  ``fns`` rotates over
    input copies so the inputs come cold from device memory, as in the
    engine.  Device ms replays the calls captured in a CUDA graph, so the
    host's launch cost drops out; eager ms launches them from Python, as
    the engine does today."""
    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(inner):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    device = _event_ms(torch, g.replay, reps) / inner
    del g

    def eager():
        for i in range(inner):
            fns[i % len(fns)]()
    return device, _event_ms(torch, eager, reps) / inner


def timed(torch, kernel, plain, library=None):
    """The timing keys of one kernel row (lists of zero-argument calls;
    ``library`` None: no PyTorch call computes the function)."""
    out = {"library_ms": None, "eager_library_ms": None}
    for key, fns in (("", kernel), ("plain_", plain), ("library_", library)):
        if fns is not None:
            out[key + "ms"], out["eager_" + key + "ms"] = time_ms(torch, fns)
    return out


def copies_for(nbytes: int, cap: int = 64) -> int:
    """Input copies whose total exceeds twice the 50 MB L2."""
    return max(1, min(cap, -(-100_000_000 // max(nbytes, 1))))


# ---------------------------------------------------------------- kernels
def kernels_phase(torch, K, dev, rng):
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.quant.tensor import quantize_kv, quantize_mx

    def t(a, dtype=torch.bfloat16):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    def agree(name, got, want):
        tol = TOL[name.split()[0]]
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        if not ok or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version, max_abs_err {err}")
        return err

    rows = {}

    # rmsnorm at the three row counts of the path: decode (slots = 8),
    # chunk slab (32), one slot (1); d = 1024
    rms = []
    for T in (8, 32, 1):
        d = 1024
        x = t(rng.standard_normal((T, d)))
        s = t(1 + 0.1 * rng.standard_normal(d), torch.float32)
        err = agree(f"rmsnorm T={T}", K.rmsnorm(x, s), K.PLAIN["rmsnorm"](x, s))
        s16 = s.to(torch.bfloat16)
        bms, by = bound_ms(2 * T * d * 2 + d * 4, 4 * T * d)
        rms.append({
            "shape": f"x ({T}, {d}) bf16, scale ({d},) f32",
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            **timed(torch, [lambda: K.rmsnorm(x, s)],
                    [lambda: K.PLAIN["rmsnorm"](x, s)],
                    [lambda: F.rms_norm(x, (d,), s16, 1e-6)])})
    rows["rmsnorm"] = rms

    # gemv at every projection shape of qwen1.5-0.5b; the read-out first
    gem = []
    for N, Kd in ((151936, 1024), (1024, 1024), (2816, 1024), (1024, 2816)):
        n_copies = copies_for(N * Kd * 2)
        ws = [t(rng.standard_normal((N, Kd)) / np.sqrt(Kd))
              for _ in range(n_copies)]
        x = t(rng.standard_normal(Kd))
        err = agree(f"gemv {N}x{Kd}", K.gemv(ws[0], x),
                    K.PLAIN["gemv"](ws[0], x))
        bms, by = bound_ms(N * Kd * 2 + Kd * 2 + N * 4, 2 * N * Kd)
        x2 = x[None]
        gem.append({
            "shape": f"w ({N}, {Kd}) bf16, x ({Kd},) bf16",
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            **timed(torch, [lambda w=w: K.gemv(w, x) for w in ws],
                    [lambda w=w: K.PLAIN["gemv"](w, x) for w in ws],
                    [lambda w=w: F.linear(x2, w) for w in ws])})
        del ws
    rows["gemv"] = gem

    # paged attention at the engine's geometry: 16 heads of 64, pages of
    # 16 rows, cache_len 1024 -> 64 blocks per slot, 8 slots
    H = KV = 16
    hd, page, nblk, slots = 64, 16, 64, 8
    P = slots * nblk + 1
    pool_bytes = 2 * P * page * KV * hd * 2
    n_copies = copies_for(pool_bytes, cap=4)
    pools = [(t(rng.standard_normal((P, page, KV, hd))),
              t(rng.standard_normal((P, page, KV, hd))))
             for _ in range(n_copies)]
    perm = rng.permutation(P - 1) + 1
    bt = torch.as_tensor(perm[:slots * nblk].reshape(slots, nblk)
                         .astype(np.int32), device=dev)
    S = nblk * page

    def dense(kp, vp, b_rows):
        ix = bt[b_rows].long()
        k = kp[ix].reshape(len(b_rows), S, KV, hd).transpose(1, 2)
        v = vp[ix].reshape(len(b_rows), S, KV, hd).transpose(1, 2)
        return k.contiguous(), v.contiguous()

    dec = []
    lens = rng.integers(64, 449, slots).astype(np.int32)
    length = torch.as_tensor(lens, device=dev)
    q = t(rng.standard_normal((slots, H, hd)))
    kp, vp = pools[0]
    err = agree("paged_decode_attention",
                K.paged_decode_attention(q, kp, vp, bt, length),
                K.PLAIN["paged_decode_attention"](q, kp, vp, bt, length))
    # odd nblk, a length that ends mid-page, a stale length past the table
    bt_odd = bt[:, :7].contiguous()
    len_odd = torch.as_tensor(np.asarray([1, 5, 17, 40, 100, 111, 112, 200],
                                         np.int32), device=dev)
    err_edge = agree(
        "paged_decode_attention (odd nblk)",
        K.paged_decode_attention(q, kp, vp, bt_odd, len_odd),
        K.PLAIN["paged_decode_attention"](
            q, kp, vp, bt_odd, torch.clamp(len_odd, max=7 * page)))
    dviews = [dense(kp_, vp_, list(range(slots))) for kp_, vp_ in pools]
    qs = q[:, :, None]
    mask = (torch.arange(S, device=dev)[None, None, None, :]
            < length[:, None, None, None])
    rows_read = int(lens.sum())
    bms, by = bound_ms(rows_read * KV * hd * 4 + slots * H * hd * 4
                       + slots * nblk * 4, 4 * H * hd * rows_read)
    dec.append({
        "shape": f"q ({slots}, {H}, {hd}) bf16, pools ({P}, {page}, {KV}, "
                 f"{hd}) bf16, bt ({slots}, {nblk}), length {lens.tolist()}",
        "max_abs_err": max(err, err_edge), "bound_ms": bms, "bound_by": by,
        **timed(torch,
                [lambda p=p: K.paged_decode_attention(q, p[0], p[1], bt,
                                                      length) for p in pools],
                [lambda p=p: K.PLAIN["paged_decode_attention"](
                    q, p[0], p[1], bt, length) for p in pools],
                [lambda dv=dv: F.scaled_dot_product_attention(
                    qs, dv[0], dv[1], attn_mask=mask) for dv in dviews])})
    rows["paged_decode_attention"] = dec
    del dviews

    pre = []
    C = 32
    for off, valid in ((224, 32), (0, 17), (401, 23)):
        bt1 = bt[:1].contiguous()
        q1 = t(rng.standard_normal((1, C, H, hd)))
        q_off = torch.as_tensor([off], dtype=torch.int32, device=dev)
        ln = torch.as_tensor([off + valid], dtype=torch.int32, device=dev)
        got = K.prefill_attention_paged(q1, kp, vp, bt1, q_off, ln)
        want = K.PLAIN["prefill_attention_paged"](q1, kp, vp, bt1, q_off, ln)
        err = agree(f"prefill_attention_paged off={off}", got[:, :valid],
                    want[:, :valid])         # pad rows are garbage
        dv1 = [dense(kp_, vp_, [0]) for kp_, vp_ in pools]
        q1s = q1.transpose(1, 2)
        spos = torch.arange(S, device=dev)[None, :]
        qpos = off + torch.arange(C, device=dev)[:, None]
        m1 = ((spos <= qpos) & (spos < off + valid))[None, None]
        visible = sum(min(off + r + 1, off + valid) for r in range(C))
        bms, by = bound_ms((off + valid) * KV * hd * 4 + 2 * C * H * hd * 2
                           + nblk * 4, 4 * H * hd * visible)
        pre.append({
            "shape": f"q (1, {C}, {H}, {hd}) bf16, same pools, bt (1, {nblk})"
                     f", q_offset {off}, length {off + valid}",
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            **timed(torch,
                    [lambda p=p: K.prefill_attention_paged(
                        q1, p[0], p[1], bt1, q_off, ln) for p in pools],
                    [lambda p=p: K.PLAIN["prefill_attention_paged"](
                        q1, p[0], p[1], bt1, q_off, ln) for p in pools],
                    [lambda dv=dv: F.scaled_dot_product_attention(
                        q1s, dv[0], dv[1], attn_mask=m1) for dv in dv1])})
    rows["prefill_attention_paged"] = pre

    # paged decode over int8 pools: the same slots and heads at the int8
    # page of 32 rows (cache_len 1024 -> 32 blocks per slot)
    page8, nblk8 = 32, 32
    P8 = slots * nblk8 + 1
    pools8 = []
    for _ in range(copies_for(2 * P8 * page8 * KV * (hd + 2), cap=4)):
        k8, ks = quantize_kv(t(rng.standard_normal((P8, page8, KV, hd))))
        v8, vs = quantize_kv(t(rng.standard_normal((P8, page8, KV, hd))))
        pools8.append((k8, ks, v8, vs))
    perm8 = rng.permutation(P8 - 1) + 1
    bt8 = torch.as_tensor(perm8[:slots * nblk8].reshape(slots, nblk8)
                          .astype(np.int32), device=dev)
    K8 = K.paged_decode_attention_int8
    P8F = K.PLAIN["paged_decode_attention_int8"]
    err = agree("paged_decode_attention_int8", K8(q, *pools8[0], bt8, length),
                P8F(q, *pools8[0], bt8, length))
    len_odd8 = torch.as_tensor(np.asarray([1, 5, 33, 64, 100, 111, 160, 300],
                                          np.int32), device=dev)
    bt8_odd = bt8[:, :5].contiguous()
    err_edge = agree("paged_decode_attention_int8 (odd nblk)",
                     K8(q, *pools8[0], bt8_odd, len_odd8),
                     P8F(q, *pools8[0], bt8_odd,
                         torch.clamp(len_odd8, max=5 * page8)))
    S8 = nblk8 * page8
    dq_views = []
    for k8, ks, v8, vs in pools8:        # the pre-dequantized dense view
        ix = bt8.long()
        k = (k8[ix].float() * ks[ix].float()).to(torch.bfloat16)
        v = (v8[ix].float() * vs[ix].float()).to(torch.bfloat16)
        dq_views.append(tuple(a.reshape(slots, S8, KV, hd).transpose(1, 2)
                              .contiguous() for a in (k, v)))
    mask8 = (torch.arange(S8, device=dev)[None, None, None, :]
             < length[:, None, None, None])
    bms, by = bound_ms(rows_read * KV * (hd + 2) * 2 + slots * H * hd * 4
                       + slots * nblk8 * 4, 4 * H * hd * rows_read)
    rows["paged_decode_attention_int8"] = [{
        "shape": f"q ({slots}, {H}, {hd}) bf16, int8 pools ({P8}, {page8}, "
                 f"{KV}, {hd}) + bf16 scale pages, bt ({slots}, {nblk8}), "
                 f"length {lens.tolist()}",
        "max_abs_err": max(err, err_edge), "bound_ms": bms, "bound_by": by,
        "library": "SDPA on the pre-dequantized bf16 dense view",
        **timed(torch, [lambda p=p: K8(q, *p, bt8, length) for p in pools8],
                [lambda p=p: P8F(q, *p, bt8, length) for p in pools8],
                [lambda dv=dv: F.scaled_dot_product_attention(
                    qs, dv[0], dv[1], attn_mask=mask8) for dv in dq_views])}]
    del pools, pools8, dq_views

    # MX weights at every one-row projection shape of the quantized path:
    # fp4 and fp8 at the read-out, fp4 at q/k/v/o and down; no PyTorch call
    # takes 32-row E8M0 blocks, so the reference is the bf16 gemv kernel of
    # the same (N, K) (rows["gemv"])
    gemv_ms = {r["shape"].split(" bf16")[0]: r["ms"] for r in gem}

    gen = torch.Generator(device=dev).manual_seed(0)

    def mx_weights(K_, N, elem):
        n = copies_for(K_ * N // (2 if elem == "fp4" else 1))
        qts = [quantize_mx(torch.randn((K_, N), device=dev, generator=gen)
                           / np.sqrt(K_), elem=elem) for _ in range(n)]
        return [(qt.values, qt.scales) for qt in qts]

    mx = []
    for (N, Kd), elem in (((151936, 1024), "fp4"), ((151936, 1024), "fp8"),
                          ((1024, 1024), "fp4"), ((1024, 2816), "fp4")):
        ws = mx_weights(Kd, N, elem)
        x = t(rng.standard_normal(Kd))
        err = agree(f"mx_qgemv {elem} {N}x{Kd}", K.mx_qgemv(*ws[0], x),
                    K.PLAIN["mx_qgemv"](*ws[0], x))
        code_bytes = N * Kd // (2 if elem == "fp4" else 1)
        bms, by = bound_ms(code_bytes + N * Kd // 32 + Kd * 2 + N * 4,
                           2 * N * Kd)
        mx.append({
            "shape": f"{elem} codes of W ({Kd}, {N}) + E8M0 ({Kd // 32}, {N})"
                     f", x ({Kd},) bf16",
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            "library": None,
            "bf16_gemv_ms": gemv_ms.get(f"w ({N}, {Kd})"),
            **timed(torch, [lambda w=w: K.mx_qgemv(*w, x) for w in ws],
                    [lambda w=w: K.PLAIN["mx_qgemv"](*w, x) for w in ws])})
        del ws
    rows["mx_qgemv"] = mx

    N, Kd = 2816, 1024                      # gate + up of the MLP
    gs, us = mx_weights(Kd, N, "fp4"), mx_weights(Kd, N, "fp4")
    x = t(rng.standard_normal(Kd))
    err = agree("mx_qgemv_swiglu", K.mx_qgemv_swiglu(*gs[0], *us[0], x),
                K.PLAIN["mx_qgemv_swiglu"](*gs[0], *us[0], x))
    wg8, sg8 = mx_weights(Kd, N, "fp8")[0]
    wu8, su8 = mx_weights(Kd, N, "fp8")[0]
    err8 = agree("mx_qgemv_swiglu fp8", K.mx_qgemv_swiglu(wg8, sg8, wu8, su8,
                                                           x),
                 K.PLAIN["mx_qgemv_swiglu"](wg8, sg8, wu8, su8, x))
    bms, by = bound_ms(2 * (N * Kd // 2 + N * Kd // 32) + Kd * 2 + N * 4,
                       4 * N * Kd)
    ref = gemv_ms.get(f"w ({N}, {Kd})")
    rows["mx_qgemv_swiglu"] = [{
        "shape": f"fp4 gate + up W ({Kd}, {N}) + E8M0, x ({Kd},) bf16",
        "max_abs_err": max(err, err8), "bound_ms": bms, "bound_by": by,
        "library": None, "bf16_gemv_ms": None if ref is None else 2 * ref,
        **timed(torch, [lambda g=g, u=u: K.mx_qgemv_swiglu(*g, *u, x)
                        for g, u in zip(gs, us)],
                [lambda g=g, u=u: K.PLAIN["mx_qgemv_swiglu"](*g, *u, x)
                 for g, u in zip(gs, us)])}]
    torch.cuda.synchronize()
    return rows


# ----------------------------------------------------------------- engine
def make_requests(np, rng, vocab, n, max_new=32):
    """A shared 24-token system prompt + 40..400 seeded tokens each."""
    sysp = rng.integers(1, vocab, 24)
    return [(np.concatenate([sysp, rng.integers(1, vocab, int(
        rng.integers(40, 401)))]).astype(np.int32), max_new)
        for _ in range(n)]


def serve(torch, engine, specs, vocab):
    from repro_torch.serve import Request
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(specs)]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    finished = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(finished) != len(reqs) or not all(r.done for r in reqs):
        raise AssertionError(f"{len(finished)}/{len(reqs)} requests finished")
    for r in reqs:
        if len(r.out) != r.max_new_tokens or not all(
                0 <= t < vocab for t in r.out):
            raise AssertionError(f"request {r.rid}: bad output {r.out}")
    return reqs, wall


def check_balanced(engine):
    """After drain only the prefix index holds pages (one ref each); after
    clearing it every page is free."""
    be = engine.backend
    total = be.spec.num_pages - 1
    held = be.prefix_index.num_pages
    refs = dict(be.allocator._refs)
    if be.allocator.num_free != total - held or any(
            n != 1 for n in refs.values()):
        raise AssertionError(f"allocator unbalanced: {be.allocator.num_free}"
                             f" free of {total}, index holds {held}")
    be.prefix_index.clear()
    if be.allocator.num_free != total:
        raise AssertionError("pages leaked after clearing the prefix index")


def logits_phase(torch, np, K, M, model_k, model_p, dev, rng,
                 kv_dtype="bfloat16"):
    """One chunk step and one decode step on identical caches: the kernel
    path against the plain path, both bf16, and both against the plain path
    in fp32 on the same weights (MX weights dequantize in fp32 there).  The
    two bf16 paths round at different places (the kernels keep fp32
    probabilities and fp32 gemv outputs), and over 24 layers that compounds
    to a few hundredths of the logits' scale, so the criterion is relative
    to the bf16 noise itself: the kernel path must stay within twice the
    plain path's distance from fp32.  int8 caches (``kv_dtype="int8"``) are
    the same bytes in all three runs, scale pages and bf16 chunk stage
    included.  Returns the errors and the launches of each step."""
    import copy
    import dataclasses

    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.serve import ChunkStage, PagedKVCache, PageSpec
    V = model_k.cfg.vocab_size
    model_32 = build_model(
        dataclasses.replace(model_k.cfg, dtype="float32"), RuntimeConfig(),
        params=copy.deepcopy(model_p.params).float(), device=dev)
    int8 = kv_dtype == "int8"
    spec = PageSpec.for_engine(2, 256, 32 if int8 else 16, dtype=kv_dtype)
    nblk = spec.blocks_per_slot
    perm = rng.permutation(spec.num_pages - 1) + 1
    bt = torch.as_tensor(perm[:2 * nblk].reshape(2, nblk).astype(np.int32),
                         device=dev)
    caches_a = model_k.init_caches(2, 256, page_spec=spec,
                                   chunk_stage=32 if int8 else 0)
    prompt = rng.integers(1, V, 45).astype(np.int32)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def tensors(c):
        return [c.k_pool, c.v_pool, c.k_scale_pool, c.v_scale_pool,
                *(c.stage or (None, None))]

    def clone_into(dst, src):
        for d, s in zip(dst, src):
            for a, b in zip(tensors(d), tensors(s)):
                if a is not None:
                    a.copy_(b)            # copy_ casts to dst's dtype

    def copies(caches, dtype):
        """bf16 value pools in ``dtype``; int8 pools, scale pages and the
        bf16 stage as they are."""
        out = []
        for c in caches:
            vd = c.k_pool.dtype if c.quantized else dtype
            out.append(PagedKVCache(
                c.k_pool.to(vd, copy=True), c.v_pool.to(vd, copy=True),
                *(None if a is None else a.clone()
                  for a in (c.k_scale_pool, c.v_scale_pool)),
                None if c.stage is None else ChunkStage(c.stage.k.clone(),
                                                        c.stage.v.clone())))
        return out

    first = {"tokens": i32(prompt[None, :32]), "offset": i32([0]),
             "valid": i32([32]), "block_tables": bt[:1]}
    model_p.chunk_step(first, caches_a)
    caches_b = copies(caches_a, torch.bfloat16)
    caches_32 = copies(caches_a, torch.float32)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :13] = prompt[32:]
    second = {"tokens": i32(toks), "offset": i32([32]), "valid": i32([13]),
              "block_tables": bt[:1]}
    K.reset_launch_counts()
    with M.kernel_routing():
        lk, _ = model_k.chunk_step(second, caches_a)
    torch.cuda.synchronize()
    chunk_launches = K.launch_counts()
    lp, _ = model_p.chunk_step(second, caches_b)
    l32, _ = model_32.chunk_step(second, caches_32)
    out = {"chunk_launches": chunk_launches}

    def compare(name, got, plain, fp32):
        def err(a, b):
            return (a.float() - b.float()).abs().max().item()
        e_kp, e_k32, e_p32 = err(got, plain), err(got, fp32), err(plain, fp32)
        if not torch.isfinite(got.float()).all() or \
                e_k32 > max(2 * e_p32, BF16_TOL):
            raise AssertionError(
                f"{name}: kernel path {e_k32} from fp32, plain bf16 path "
                f"{e_p32} (kernel vs plain {e_kp})")
        out[name] = {"kernel_vs_plain": e_kp, "kernel_vs_fp32": e_k32,
                     "plain_vs_fp32": e_p32,
                     "max_abs_logit": fp32.abs().max().item(),
                     "argmax_equal": bool(
                         (got.argmax(-1) == plain.argmax(-1)).all())}

    compare("chunk_logits", lk, lp, l32)
    # slot 0 decodes position 45; slot 1 is an idle slot (all-NULL table,
    # stale position) whose garbage row nothing reads
    clone_into(caches_b, caches_a)
    clone_into(caches_32, caches_a)
    tok = int(lp.argmax(-1)[0])
    bt2 = torch.stack([bt[0], torch.zeros_like(bt[0])])
    batch = {"tokens": i32([[tok], [0]]), "pos": i32([45, 7]),
             "block_tables": bt2}
    K.reset_launch_counts()
    with M.kernel_routing():
        dk, _ = model_k.decode_step(batch, caches_a)
    torch.cuda.synchronize()
    out["decode_launches"] = K.launch_counts()
    dp, _ = model_p.decode_step(batch, caches_b)
    d32, _ = model_32.decode_step(batch, caches_32)
    compare("decode_logits", dk[:1], dp[:1], d32[:1])
    one = {"tokens": i32([[tok]]), "pos": i32([46]), "block_tables": bt[:1]}
    K.reset_launch_counts()
    with M.kernel_routing():
        model_k.decode_step(one, caches_a)
    torch.cuda.synchronize()
    out["decode_launches_one_slot"] = K.launch_counts()
    return out


def decode_profile(torch, np, M, model_k, ecfg, rng, record,
                   name="decode_trace.json"):
    """Steady decode of 8 slots on the kernel path: host wall of 10 engine
    cycles, then 10 more under ``torch.profiler`` — the device's busy share
    of that window (union of kernel/copy intervals in the trace) and the
    kernels that take the device time."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request, build_engine
    V = model_k.cfg.vocab_size
    eng = build_engine(model_k, dataclasses.replace(ecfg,
                                                    prefix_cache=False))
    for i in range(8):
        eng.submit(Request(rid=i, prompt=rng.integers(1, V, 32).astype(
            np.int32), max_new_tokens=48))
    with M.kernel_routing():
        for _ in range(10):          # one slab each: all 8 decode by now
            eng.step()
        if len(eng._decoding) != 8:
            raise AssertionError("profile window: not every slot decodes")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                eng.step()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        eng.run_until_drained()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / name
        prof.export_chrome_trace(str(path))
        trace = path.read_text()
    if record is not None:              # gzip: the traces are tens of MB
        with gzip.open(record / (name + ".gz"), "wt") as f:
            f.write(trace)
    events = [e for e in json.loads(trace)["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, None
    for a, b in spans:                    # union of device intervals (us)
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"cycles": 10, "wall_s": wall, "profiled_wall_s": wall_prof,
            "device_events": len(events),
            "device_busy_s": busy / 1e6 if events else None,
            "device_busy_share": busy / 1e6 / wall_prof if events else None,
            "top_kernels_us": [(n[:80], d) for n, d in top]}


def engine_phase(torch, dev, rng, record=None):
    import dataclasses

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.models import modules as M
    from repro_torch.serve import EngineConfig, build_engine

    cfg = get_config("qwen1.5-0.5b")
    V = cfg.vocab_size
    t0 = time.perf_counter()
    model_k = build_model(cfg, RuntimeConfig(paged_kernel_decode=True),
                          device=dev, seed=0)
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model_k.parameters())}
    model_p = model_k.with_runtime(RuntimeConfig())
    ecfg = EngineConfig(slots=8, cache_len=1024, backend="paged",
                        chunked_prefill=True, chunk_size=32,
                        prefix_cache=True, kernel_decode=True)
    specs = make_requests(np, rng, V, 16)

    # the main path: kernel routing on, every kernel counted
    eng = build_engine(model_k, ecfg)
    res["kv_pool_bytes"] = sum(2 * c.k_pool.numel() * c.k_pool.element_size()
                               for c in eng.caches)
    K.reset_launch_counts()
    with M.kernel_routing():
        reqs_k, wall = serve(torch, eng, specs, V)
    res["launches"] = K.launch_counts()
    missing = [k for k in BF16_PATH if res["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")
    res["kernel_path"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()

    # the plain path on the same requests: launches nothing
    eng = build_engine(model_p, dataclasses.replace(ecfg,
                                                    kernel_decode=False))
    K.reset_launch_counts()
    reqs_p, wall = serve(torch, eng, specs, V)
    if any(K.launch_counts().values()):
        raise AssertionError(f"plain path launched {K.launch_counts()}")
    res["plain_path"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()
    same = sum(a == b for rk, rp in zip(reqs_k, reqs_p)
               for a, b in zip(rk.out, rp.out))
    total = sum(len(r.out) for r in reqs_k)
    res["token_agreement"] = same / total
    res["identical_streams"] = sum(rk.out == rp.out
                                   for rk, rp in zip(reqs_k, reqs_p))

    # one slot: every projection is a one-row gemv
    eng = build_engine(model_k, dataclasses.replace(ecfg, slots=1))
    K.reset_launch_counts()
    with M.kernel_routing():
        _, wall = serve(torch, eng, specs[:2], V)
    res["launches_one_slot"] = K.launch_counts()
    if not all(res["launches_one_slot"][k] for k in BF16_PATH):
        raise AssertionError(f"one-slot run: {res['launches_one_slot']}")
    res["one_slot"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()

    res.update(logits_phase(torch, np, K, M, model_k, model_p, dev, rng))
    res["decode_profile"] = decode_profile(torch, np, M, model_k, ecfg, rng,
                                            record)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    mk, mp = res["kernel_path"]["metrics"], res["plain_path"]["metrics"]
    log(f"  qwen1.5-0.5b full width: {res['weight_bytes'] / 1e9:.3f} GB "
        f"weights, {res['kv_pool_bytes'] / 1e9:.3f} GB KV pools")
    log(f"  kernel path: {mk['tokens_per_s']:.1f} tok/s, "
        f"{mk['decode_steps_per_s']:.1f} decode steps/s, "
        f"{res['kernel_path']['wall_s']:.2f} s wall, launches "
        f"{res['launches']}")
    log(f"  plain path:  {mp['tokens_per_s']:.1f} tok/s, "
        f"{mp['decode_steps_per_s']:.1f} decode steps/s, "
        f"{res['plain_path']['wall_s']:.2f} s wall")
    log(f"  greedy token agreement kernel vs plain: "
        f"{res['token_agreement']:.4f} ({res['identical_streams']}/16 "
        f"identical streams)")
    log(f"  one slot: launches {res['launches_one_slot']}")
    log(f"  chunk step: logits err {res['chunk_logits']}, launches "
        f"{res['chunk_launches']}")
    log(f"  decode step: logits err {res['decode_logits']}, launches "
        f"{res['decode_launches']} (one slot: "
        f"{res['decode_launches_one_slot']})")
    prof = res["decode_profile"]
    log(f"  steady decode, 8 slots: {prof['wall_s'] / 10 * 1e3:.2f} ms per "
        f"cycle; under the profiler the device is busy "
        f"{prof['device_busy_share']} of the window")
    for name, us in prof["top_kernels_us"][:6]:
        log(f"    {us:10.1f} us  {name}")
    return res


def kv_bytes(caches):
    """Bytes of the KV page pools, scale pages included (the chunk stage
    apart)."""
    return sum(a.numel() * a.element_size() for c in caches
               for a in (c.k_pool, c.v_pool, c.k_scale_pool, c.v_scale_pool)
               if a is not None)


def quant_phase(torch, dev, rng, record=None):
    """The quantized slice: mx4 weights (quantized after the seed-0 init)
    and int8 KV pages through the same engine, kernel path against plain
    path, then one slot (every projection one row: mx_qgemv and the fused
    mx_qgemv_swiglu)."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.models import RuntimeConfig
    from repro_torch.models import modules as M
    from repro_torch.quant import quantized_stats
    from repro_torch.serve import EngineConfig, build_engine

    ecfg = EngineConfig(slots=8, cache_len=1024, backend="paged",
                        chunked_prefill=True, chunk_size=32,
                        prefix_cache=True, kv_cache_dtype="int8",
                        quantize_weights="mx4", kernel_decode=True)
    t0 = time.perf_counter()
    eng = build_engine("qwen1.5-0.5b", ecfg, device=dev, seed=0)
    torch.cuda.synchronize()
    model_k = eng.model
    model_p = model_k.with_runtime(RuntimeConfig(
        quantize_weights="mx4", kv_cache_dtype="int8"))
    V = model_k.cfg.vocab_size
    res = {"init_s": time.perf_counter() - t0,
           "page_size": eng.backend.spec.page_size,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model_k.parameters()),
           "quantized_stats": quantized_stats(model_k.params),
           "kv_pool_bytes": kv_bytes(eng.caches),
           "stage_bytes": sum(2 * c.stage.k.numel() * c.stage.k.element_size()
                              for c in eng.caches)}
    if res["page_size"] != 32 or eng.caches[0].stage is None:
        raise AssertionError("int8 pools need 32-row pages and a stage")
    specs = make_requests(np, rng, V, 16)

    # this slice's path, 8 slots: int8 decode attention every step
    K.reset_launch_counts()
    with M.kernel_routing():
        reqs_k, wall = serve(torch, eng, specs, V)
    res["launches"] = K.launch_counts()
    if res["launches"]["paged_decode_attention_int8"] == 0:
        raise AssertionError(f"the quantized path never launched the int8 "
                             f"decode kernel: {res['launches']}")
    res["kernel_path"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()

    eng = build_engine(model_p, dataclasses.replace(ecfg,
                                                    kernel_decode=False))
    K.reset_launch_counts()
    reqs_p, wall = serve(torch, eng, specs, V)
    if any(K.launch_counts().values()):
        raise AssertionError(f"plain path launched {K.launch_counts()}")
    res["plain_path"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()
    res["token_agreement"] = sum(
        a == b for rk, rp in zip(reqs_k, reqs_p)
        for a, b in zip(rk.out, rp.out)) / sum(len(r.out) for r in reqs_k)
    res["identical_streams"] = sum(rk.out == rp.out
                                   for rk, rp in zip(reqs_k, reqs_p))

    # this slice's path, one slot: every new kernel launches
    eng = build_engine(model_k, dataclasses.replace(ecfg, slots=1))
    K.reset_launch_counts()
    with M.kernel_routing():
        _, wall = serve(torch, eng, specs[:2], V)
    res["launches_one_slot"] = K.launch_counts()
    if not all(res["launches_one_slot"][k] for k in QUANT_PATH):
        raise AssertionError(f"one-slot run: {res['launches_one_slot']}")
    res["one_slot"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()

    res.update(logits_phase(torch, np, K, M, model_k, model_p, dev, rng,
                            kv_dtype="int8"))
    res["decode_profile"] = decode_profile(
        torch, np, M, model_k, ecfg, rng, record, "decode_trace_quant.json")

    mk, mp = res["kernel_path"]["metrics"], res["plain_path"]["metrics"]
    qs = res["quantized_stats"]
    log(f"  qwen1.5-0.5b full width, mx4 weights + int8 KV: "
        f"{res['weight_bytes'] / 1e9:.3f} GB weights ({qs['quantized_leaves']}"
        f" quantized leaves, {qs['quantized_bytes']:,} B, was "
        f"{qs['quantized_fp32_bytes']:,} B fp32; {qs['raw_bytes']:,} B raw), "
        f"{res['kv_pool_bytes'] / 1e9:.3f} GB KV pools with scale pages "
        f"(+ {res['stage_bytes'] / 1e6:.1f} MB bf16 stage)")
    log(f"  kernel path: {mk['tokens_per_s']:.1f} tok/s, "
        f"{mk['decode_steps_per_s']:.1f} decode steps/s, "
        f"{res['kernel_path']['wall_s']:.2f} s wall, launches "
        f"{res['launches']}")
    log(f"  plain path:  {mp['tokens_per_s']:.1f} tok/s, "
        f"{mp['decode_steps_per_s']:.1f} decode steps/s, "
        f"{res['plain_path']['wall_s']:.2f} s wall")
    log(f"  greedy token agreement kernel vs plain: "
        f"{res['token_agreement']:.4f} ({res['identical_streams']}/16 "
        f"identical streams)")
    log(f"  one slot: launches {res['launches_one_slot']}")
    log(f"  chunk step: logits err {res['chunk_logits']}, launches "
        f"{res['chunk_launches']}")
    log(f"  decode step: logits err {res['decode_logits']}, launches "
        f"{res['decode_launches']} (one slot: "
        f"{res['decode_launches_one_slot']})")
    prof = res["decode_profile"]
    log(f"  steady decode, 8 slots: {prof['wall_s'] / 10 * 1e3:.2f} ms host "
        f"wall per cycle; under the profiler the device is busy "
        f"{prof['device_busy_share']} of the window")
    for name, us in prof["top_kernels_us"][:8]:
        log(f"    {us:10.1f} us  {name}")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,engine,quant",
                    help="comma list of kernels,engine,quant (default: all)")
    ap.add_argument("--record", type=Path, default=None, metavar="DIR",
                    help="also write chip_smoke.json and the gzipped "
                         "decode traces to DIR")
    args = ap.parse_args()
    if args.record is not None:
        args.record.mkdir(parents=True, exist_ok=True)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — this run "
                 "needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}"
                 " — run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    t0 = time.perf_counter()
    build_log = K.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(build_log) or 'already built'})")
    record = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build": {k: {"seconds": v["seconds"], "nvcc": v["nvcc"]}
                        for k, v in build_log.items()}}

    rng = np.random.default_rng(0)
    rows = {}
    if "kernels" in phases:
        t1 = time.perf_counter()
        rows = kernels_phase(torch, K, dev, rng)
        log(f"kernels phase: {time.perf_counter() - t1:.1f} s")
        log("  us per call, device (CUDA graph) / eager (Python launch):")

        def us(v):
            return "   none" if v is None else f"{v * 1e3:7.2f}"
        for name, rs in rows.items():
            for r in rs:
                log(f"  {name:27s} kernel {us(r['ms'])}/{us(r['eager_ms'])}"
                    f"  plain {us(r['plain_ms'])}/{us(r['eager_plain_ms'])}"
                    f"  library {us(r['library_ms'])}/"
                    f"{us(r['eager_library_ms'])}  bound "
                    f"{us(r['bound_ms'])} ({r['bound_by']})  err "
                    f"{r['max_abs_err']:.3g}  {r['shape']}"
                    + (f"  [bf16 gemv {us(r['bf16_gemv_ms'])}]"
                       if r.get("bf16_gemv_ms") else ""))
    launches = {name: None for name in REPLACES}
    if "engine" in phases:
        t1 = time.perf_counter()
        eng = engine_phase(torch, dev, rng, args.record)
        log(f"engine phase: {time.perf_counter() - t1:.1f} s")
        launches.update({k: eng["launches"][k] for k in BF16_PATH})
        record["engine"] = eng
    if "quant" in phases:
        t1 = time.perf_counter()
        qeng = quant_phase(torch, dev, rng, args.record)
        log(f"quantized engine phase: {time.perf_counter() - t1:.1f} s")
        # this slice's path: the 8-slot run and the one-slot run
        launches.update({k: qeng["launches"][k]
                         + qeng["launches_one_slot"][k] for k in QUANT_PATH})
        record["quant"] = qeng

    entries = []
    for name, (src, rep) in REPLACES.items():
        rs = rows.get(name, [])
        head = rs[0] if rs else {}
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "eager_ms", "eager_plain_ms", "eager_library_ms")
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "shape": head.get("shape"), "launches": launches[name],
            "tolerance": TOL[name],
            "max_abs_err": max((r["max_abs_err"] for r in rs), default=None),
            "kernel_ms": head.get("ms"),
            **{k: head.get(k) for k in keys}, "by_shape": rs})
    record["kernels"] = entries
    if args.record is not None:
        (args.record / "chip_smoke.json").write_text(json.dumps(record,
                                                                indent=1))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
