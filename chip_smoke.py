#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each one against its plain PyTorch version at the serving shapes and
times it, then serves through the chunked, paged engine with every kernel
on, random weights from seed 0: full-width qwen1.5-0.5b with bf16 weights
and KV pages and with mx4 weights and int8 KV pages, then full-width
qwen2-moe-a2.7b (60 experts, top-4, a gated shared expert) in the same two
formats.  It checks that each path went through its kernels (for the MoE,
the exact launches of a one-slot decode step), that the allocator balances
and that the kernel path's logits agree with the plain path's.  Every phase
fails loudly.  It prints the card's ``nvidia-smi`` name and power limit,
one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.  ``--record DIR`` also writes the full record
(``chip_smoke.json``: nvcc/ptxas output, every timing and engine metric)
and the profiler traces of the decode windows (``decode_trace*.json.gz``)
to DIR.  ``--phases`` runs a subset (kernels, engine, quant, moe).
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate,
# the bf16 tensor-core rate and the fp32 rate outside the tensor cores.  A
# bound takes the rate of the function's input type (bf16 for every kernel
# but the fp32 gemv of the MoE router), whatever units a kernel happens to
# compute on.
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
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
# summed in another order) -> 5e-6 and 6e-6.  The kernel and the
# instantiations that first ran on the card for qwen2-moe-a2.7b take the
# same fourfold headroom over their first measured errors (the first run
# through all of their checks on an NVIDIA H100 80GB HBM3 at 700 W, seeded
# inputs; PERF.md §6): the fp32 gemv of the router 7.2e-7 (fp32 sums in
# another order) -> 3e-6; the grouped expert GEMV 1.9e-6 (as mx_qgemv) ->
# 8e-6; at head_dim 128 the bf16 paged decode 6.1e-5 -> 2.5e-4, the paged
# prefill 9.8e-4 -> 4e-3 and the int8-pool decode 2.0e-3 -> 8e-3 (single
# bf16 rounding flips of outputs of order 0.1 to 0.5).
BF16_TOL = 2e-2
TOL = {"rmsnorm": BF16_TOL, "gemv": BF16_TOL, "gemv_f32": 3e-6,
       "paged_decode_attention": 4e-3, "prefill_attention_paged": 4e-3,
       "paged_decode_attention_int8": 2.5e-4, "mx_qgemv": 5e-6,
       "mx_qgemv_swiglu": 6e-6, "grouped_expert_qgemv": 8e-6,
       "paged_decode_attention hd=128": 2.5e-4,
       "prefill_attention_paged hd=128": 4e-3,
       "paged_decode_attention_int8 hd=128": 8e-3}
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
    "grouped_expert_qgemv": ("src/repro_torch/kernels/csrc/mx_gemv.cu",
                             "src/repro/quant/kernels.py:511"),
}
# the kernels of each served path: bf16 weights and pages, then mx4 weights
# and int8 pages (whose main path also runs rmsnorm and, at chunk steps,
# the read-out through mx_qgemv)
BF16_PATH = ("rmsnorm", "gemv", "paged_decode_attention",
             "prefill_attention_paged")
QUANT_PATH = ("paged_decode_attention_int8", "mx_qgemv", "mx_qgemv_swiglu")
# the MoE paths (qwen2-moe-a2.7b): every kernel of the bf16 path, and of the
# mx4 + int8 path, launches in its one-slot run; the 8-slot runs take the
# gather path for the experts and launch the rest
MOE_PATHS = {
    "bf16": ("rmsnorm", "gemv", "paged_decode_attention",
             "prefill_attention_paged"),
    "mx4": ("rmsnorm", "gemv", "paged_decode_attention_int8", "mx_qgemv",
            "mx_qgemv_swiglu", "grouped_expert_qgemv"),
}
MOE_PATHS_8_SLOTS = {
    "bf16": MOE_PATHS["bf16"],
    "mx4": ("rmsnorm", "paged_decode_attention_int8", "mx_qgemv"),
}
# requests of each qwen1.5-0.5b engine run: few enough that the whole run,
# MoE phases included, stays well inside its time limit (PERF.md §4)
DENSE_REQUESTS = 8
# The MoE logits check replays the kernel path's expert picks in its bf16
# and fp32 references (RoutingPins).  A reference may route a row otherwise
# only at a near tie of its own router: its margin, in router logits, from
# its own k-th pick down to the weakest pinned expert within twice the
# plain bf16 path's distance from fp32 in that step's output logits (the
# bf16 noise of the same step, and the factor of the logits criterion), on
# at most one routed row in ROUTE_FLIP_DIV, plus one.  A fault that moves
# the hidden states routes many rows otherwise, by wide margins.
ROUTE_FLIP_DIV = 8
# layers of the qwen2-moe-a2.7b depth cut whose logits are held against an
# fp32 copy (one of all 24 layers, 57 GB, does not fit beside the bf16 one)
MOE_CUT = 6
# The exact launches of one one-slot decode step of full-width
# qwen2-moe-a2.7b (24 layers): the kernels of the JAX package's account of
# that step (obs/energy.py decode_step_account; tests/test_torch_moe.py
# holds the two equal).  bf16, per layer: 4 attention projections, the fp32
# router, 4 x 3 expert projections, 3 shared-expert projections and the
# shared gate, then the read-out.  mx4 + int8 pages: per layer 3 grouped
# expert calls, 4 + 1 MX projections, the fused shared SwiGLU, the router
# and the raw shared gate, then the MX read-out.
MOE_DECODE_LAUNCHES = {
    "bf16": {"rmsnorm": 49, "gemv": 505, "paged_decode_attention": 24},
    "mx4": {"rmsnorm": 49, "gemv": 48, "mx_qgemv": 121,
            "mx_qgemv_swiglu": 24, "grouped_expert_qgemv": 72,
            "paged_decode_attention_int8": 24},
}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, ops: float, rate: float = BF16_OPS_PER_S):
    """The least time for the function: bytes moved (each input read once,
    each output written once) over the memory rate, or operations over the
    peak ``rate`` of the input type, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / rate
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
def attention_rows(torch, K, F, t, agree, dev, rng, hd):
    """The three paged-attention kernels at the engine's geometry: 16 heads
    of ``hd`` (64: qwen1.5-0.5b, 128: qwen2-moe-a2.7b), 8 slots, cache_len
    1024 -> 64 blocks of 16 bf16 rows or 32 blocks of 32 int8 rows per
    slot."""
    import numpy as np

    from repro_torch.quant.tensor import quantize_kv
    H = KV = 16
    page, nblk, slots = 16, 64, 8
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
    tag = f"hd={hd}"

    def key(name):
        """Gate of the kernel at this head dim (hd 64 keeps its own)."""
        return name if hd == 64 else f"{name} {tag}"

    def dense(kp, vp, b_rows):
        ix = bt[b_rows].long()
        k = kp[ix].reshape(len(b_rows), S, KV, hd).transpose(1, 2)
        v = vp[ix].reshape(len(b_rows), S, KV, hd).transpose(1, 2)
        return k.contiguous(), v.contiguous()

    lens = rng.integers(64, 449, slots).astype(np.int32)
    length = torch.as_tensor(lens, device=dev)
    q = t(rng.standard_normal((slots, H, hd)))
    kp, vp = pools[0]
    err = agree(f"paged_decode_attention {tag}",
                K.paged_decode_attention(q, kp, vp, bt, length),
                K.PLAIN["paged_decode_attention"](q, kp, vp, bt, length),
                key("paged_decode_attention"))
    # odd nblk, a length that ends mid-page, a stale length past the table
    bt_odd = bt[:, :7].contiguous()
    len_odd = torch.as_tensor(np.asarray([1, 5, 17, 40, 100, 111, 112, 200],
                                         np.int32), device=dev)
    err_edge = agree(
        f"paged_decode_attention {tag} (odd nblk)",
        K.paged_decode_attention(q, kp, vp, bt_odd, len_odd),
        K.PLAIN["paged_decode_attention"](
            q, kp, vp, bt_odd, torch.clamp(len_odd, max=7 * page)),
        key("paged_decode_attention"))
    dviews = [dense(kp_, vp_, list(range(slots))) for kp_, vp_ in pools]
    qs = q[:, :, None]
    mask = (torch.arange(S, device=dev)[None, None, None, :]
            < length[:, None, None, None])
    rows_read = int(lens.sum())
    bms, by = bound_ms(rows_read * KV * hd * 4 + slots * H * hd * 4
                       + slots * nblk * 4, 4 * H * hd * rows_read)
    dec = [{
        "shape": f"q ({slots}, {H}, {hd}) bf16, pools ({P}, {page}, {KV}, "
                 f"{hd}) bf16, bt ({slots}, {nblk}), length {lens.tolist()}",
        "max_abs_err": max(err, err_edge), "bound_ms": bms, "bound_by": by,
        "tolerance": TOL[key("paged_decode_attention")],
        **timed(torch,
                [lambda p=p: K.paged_decode_attention(q, p[0], p[1], bt,
                                                      length) for p in pools],
                [lambda p=p: K.PLAIN["paged_decode_attention"](
                    q, p[0], p[1], bt, length) for p in pools],
                [lambda dv=dv: F.scaled_dot_product_attention(
                    qs, dv[0], dv[1], attn_mask=mask) for dv in dviews])}]
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
        err = agree(f"prefill_attention_paged {tag} off={off}",
                    got[:, :valid], want[:, :valid],  # pad rows: garbage
                    key("prefill_attention_paged"))
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
            "tolerance": TOL[key("prefill_attention_paged")],
            **timed(torch,
                    [lambda p=p: K.prefill_attention_paged(
                        q1, p[0], p[1], bt1, q_off, ln) for p in pools],
                    [lambda p=p: K.PLAIN["prefill_attention_paged"](
                        q1, p[0], p[1], bt1, q_off, ln) for p in pools],
                    [lambda dv=dv: F.scaled_dot_product_attention(
                        q1s, dv[0], dv[1], attn_mask=m1) for dv in dv1])})
    del pools

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
    err = agree(f"paged_decode_attention_int8 {tag}",
                K8(q, *pools8[0], bt8, length),
                P8F(q, *pools8[0], bt8, length),
                key("paged_decode_attention_int8"))
    len_odd8 = torch.as_tensor(np.asarray([1, 5, 33, 64, 100, 111, 160, 300],
                                          np.int32), device=dev)
    bt8_odd = bt8[:, :5].contiguous()
    err_edge = agree(f"paged_decode_attention_int8 {tag} (odd nblk)",
                     K8(q, *pools8[0], bt8_odd, len_odd8),
                     P8F(q, *pools8[0], bt8_odd,
                         torch.clamp(len_odd8, max=5 * page8)),
                     key("paged_decode_attention_int8"))
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
    int8 = [{
        "shape": f"q ({slots}, {H}, {hd}) bf16, int8 pools ({P8}, {page8}, "
                 f"{KV}, {hd}) + bf16 scale pages, bt ({slots}, {nblk8}), "
                 f"length {lens.tolist()}",
        "max_abs_err": max(err, err_edge), "bound_ms": bms, "bound_by": by,
        "tolerance": TOL[key("paged_decode_attention_int8")],
        "library": "SDPA on the pre-dequantized bf16 dense view",
        **timed(torch, [lambda p=p: K8(q, *p, bt8, length) for p in pools8],
                [lambda p=p: P8F(q, *p, bt8, length) for p in pools8],
                [lambda dv=dv: F.scaled_dot_product_attention(
                    qs, dv[0], dv[1], attn_mask=mask8) for dv in dq_views])}]
    return dec, pre, int8


def gemv_row(torch, K, F, agree, key, ws, x, experts=None):
    """One gemv row: ``ws`` weight copies, or one stack ``ws[0]`` with the
    ``experts`` (host ids) to rotate over, each read cold from device
    memory; a stack's kernel takes each id as a one-element device
    tensor, as the routed MoE path does."""
    if experts is None:
        pick = [(w, None) for w in ws]
    else:
        pick = [(ws[0], torch.as_tensor([e], dtype=torch.int32,
                                        device=x.device)) for e in experts]
    fns = [lambda w=w, e=e: K.gemv(w, x, e) for w, e in pick]
    plain = [lambda w=w, e=e: K.PLAIN["gemv"](w, x, e) for w, e in pick]
    x2 = x[None]
    lib = ([lambda w=w: F.linear(x2, w) for w in ws] if experts is None else
           [lambda e=e: F.linear(x2, ws[0][e]) for e in experts])
    w0 = ws[0] if experts is None else ws[0][0]
    N, Kd = w0.shape
    w_, e_ = pick[0]
    err = agree(f"{key} {N}x{Kd}", K.gemv(w_, x, e_),
                K.PLAIN["gemv"](w_, x, e_), key)
    item = w0.element_size()
    bms, by = bound_ms(N * Kd * item + Kd * item + N * 4, 2 * N * Kd,
                       F32_OPS_PER_S if item == 4 else BF16_OPS_PER_S)
    what = "fp32" if item == 4 else "bf16"
    return {"shape": (f"w ({N}, {Kd}) {what}, x ({Kd},) {what}"
                      + ("" if experts is None else
                         f", one of {ws[0].shape[0]} experts by a device id")),
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            "tolerance": TOL[key], **timed(torch, fns, plain, lib)}


def kernels_phase(torch, K, dev, rng):
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.quant.tensor import quantize_mx

    def t(a, dtype=torch.bfloat16):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    def agree(name, got, want, key=None):
        tol = TOL[key or name.split()[0]]
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        if not ok or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version, max_abs_err {err}")
        return err

    rows = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(
            dtype)

    # rmsnorm at the row counts of the paths: decode (slots = 8), chunk slab
    # (32), one slot (1); d = 1024 (qwen1.5-0.5b) and 2048 (qwen2-moe)
    rms = []
    for T, d in ((8, 1024), (32, 1024), (1, 1024), (8, 2048), (1, 2048)):
        x = t(rng.standard_normal((T, d)))
        s = t(1 + 0.1 * rng.standard_normal(d), torch.float32)
        err = agree(f"rmsnorm T={T} d={d}", K.rmsnorm(x, s),
                    K.PLAIN["rmsnorm"](x, s))
        s16 = s.to(torch.bfloat16)
        bms, by = bound_ms(2 * T * d * 2 + d * 4, 4 * T * d)
        rms.append({
            "shape": f"x ({T}, {d}) bf16, scale ({d},) f32",
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            "tolerance": TOL["rmsnorm"],
            **timed(torch, [lambda x=x, s=s: K.rmsnorm(x, s)],
                    [lambda x=x, s=s: K.PLAIN["rmsnorm"](x, s)],
                    [lambda x=x, d=d, s16=s16: F.rms_norm(x, (d,), s16,
                                                          1e-6)])})
    rows["rmsnorm"] = rms

    # gemv at every one-row projection shape of both models: qwen1.5-0.5b
    # (the read-out first), then qwen2-moe-a2.7b's read-out, attention,
    # shared expert, shared gate, the fp32 router and the two expert shapes
    # (one expert of a 60-expert stack, picked by a device-resident id)
    gem = []
    for N, Kd in ((151936, 1024), (1024, 1024), (2816, 1024), (1024, 2816),
                  (151936, 2048), (2048, 2048), (5632, 2048), (2048, 5632),
                  (1, 2048)):
        ws = [randn(N, Kd, scale=Kd ** -0.5)
              for _ in range(copies_for(N * Kd * 2))]
        gem.append(gemv_row(torch, K, F, agree, "gemv", ws,
                            t(rng.standard_normal(Kd))))
        del ws
    ws = [randn(60, 2048, scale=2048 ** -0.5, dtype=torch.float32)
          for _ in range(copies_for(60 * 2048 * 4))]
    gem.append(gemv_row(torch, K, F, agree, "gemv_f32", ws,
                        t(rng.standard_normal(2048), torch.float32)))
    del ws
    E, TOPK = 60, 4
    ids_sets = [rng.permutation(E)[:TOPK].astype(np.int32)
                for _ in range(16)]   # 16 x 4 cold expert slices > 2 x L2
    # the distinct experts of the first five sets: > 100 MB of bf16 slices
    cold = list(dict.fromkeys(np.concatenate(ids_sets[:5]).tolist()))
    stacks = {}
    for N, Kd in ((1408, 2048), (2048, 1408)):
        stacks[N, Kd] = randn(E, N, Kd, scale=Kd ** -0.5)
        gem.append(gemv_row(torch, K, F, agree, "gemv", [stacks[N, Kd]],
                            t(rng.standard_normal(Kd)), cold))
    rows["gemv"] = gem

    for hd in (64, 128):
        dec, pre, int8 = attention_rows(torch, K, F, t, agree, dev, rng, hd)
        rows.setdefault("paged_decode_attention", []).extend(dec)
        rows.setdefault("prefill_attention_paged", []).extend(pre)
        rows.setdefault("paged_decode_attention_int8", []).extend(int8)

    # MX weights at every one-row projection shape of the quantized path:
    # fp4 and fp8 at the read-out, fp4 at q/k/v/o and down; no PyTorch call
    # takes 32-row E8M0 blocks, so the reference is the bf16 gemv kernel of
    # the same (N, K) (rows["gemv"])
    gemv_ms = {r["shape"].split(" bf16")[0]: r["ms"] for r in gem
               if "experts" not in r["shape"]}

    def mx_weights(K_, N, elem):
        n = copies_for(K_ * N // (2 if elem == "fp4" else 1))
        qts = [quantize_mx(torch.randn((K_, N), device=dev, generator=gen)
                           / np.sqrt(K_), elem=elem) for _ in range(n)]
        return [(qt.values, qt.scales) for qt in qts]

    mx = []
    for (N, Kd), elem in (((151936, 1024), "fp4"), ((151936, 1024), "fp8"),
                          ((1024, 1024), "fp4"), ((1024, 2816), "fp4"),
                          ((2048, 2048), "fp4"), ((2048, 5632), "fp4")):
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
            "tolerance": TOL["mx_qgemv"], "library": None,
            "bf16_gemv_ms": gemv_ms.get(f"w ({N}, {Kd})"),
            **timed(torch, [lambda w=w: K.mx_qgemv(*w, x) for w in ws],
                    [lambda w=w: K.PLAIN["mx_qgemv"](*w, x) for w in ws])})
        del ws
    rows["mx_qgemv"] = mx

    swi = []
    for N, Kd in ((2816, 1024), (5632, 2048)):     # gate + up of the MLPs
        gs, us = mx_weights(Kd, N, "fp4"), mx_weights(Kd, N, "fp4")
        x = t(rng.standard_normal(Kd))
        err = agree(f"mx_qgemv_swiglu {N}x{Kd}",
                    K.mx_qgemv_swiglu(*gs[0], *us[0], x),
                    K.PLAIN["mx_qgemv_swiglu"](*gs[0], *us[0], x))
        wg8, sg8 = mx_weights(Kd, N, "fp8")[0]
        wu8, su8 = mx_weights(Kd, N, "fp8")[0]
        err8 = agree(f"mx_qgemv_swiglu fp8 {N}x{Kd}",
                     K.mx_qgemv_swiglu(wg8, sg8, wu8, su8, x),
                     K.PLAIN["mx_qgemv_swiglu"](wg8, sg8, wu8, su8, x))
        bms, by = bound_ms(2 * (N * Kd // 2 + N * Kd // 32) + Kd * 2 + N * 4,
                           4 * N * Kd)
        ref = gemv_ms.get(f"w ({N}, {Kd})")
        swi.append({
            "shape": f"fp4 gate + up W ({Kd}, {N}) + E8M0, x ({Kd},) bf16",
            "max_abs_err": max(err, err8), "bound_ms": bms, "bound_by": by,
            "tolerance": TOL["mx_qgemv_swiglu"], "library": None,
            "bf16_gemv_ms": None if ref is None else 2 * ref,
            **timed(torch, [lambda g=g, u=u: K.mx_qgemv_swiglu(*g, *u, x)
                            for g, u in zip(gs, us)],
                    [lambda g=g, u=u: K.PLAIN["mx_qgemv_swiglu"](*g, *u, x)
                     for g, u in zip(gs, us)])})
        del gs, us
    rows["mx_qgemv_swiglu"] = swi

    # grouped MX expert GEMV at qwen2-moe-a2.7b's expert shapes: 60 experts,
    # top-4, distinct and repeated ids; the yardsticks are the same four
    # slices through four mx_qgemv calls and the same shapes through four
    # bf16 gemv calls (no PyTorch call takes E8M0 blocks)
    grp = []
    for (N, Kd), elem in (((1408, 2048), "fp4"), ((2048, 1408), "fp4"),
                          ((1408, 2048), "fp8"), ((2048, 1408), "fp8")):
        qt = quantize_mx(torch.randn((E, Kd, N), device=dev, generator=gen)
                         / np.sqrt(Kd), elem=elem, axis=-2)
        wq, sc = qt.values, qt.scales
        del qt
        xs = t(rng.standard_normal((TOPK, Kd)))
        sets = [torch.as_tensor(s, device=dev) for s in ids_sets]
        repeated = torch.as_tensor(np.asarray([12, 12, 3, 12], np.int32),
                                   device=dev)
        err = max(agree(f"grouped_expert_qgemv {elem} {N}x{Kd}{tail}",
                        K.grouped_expert_qgemv(wq, sc, xs, ids),
                        K.PLAIN["grouped_expert_qgemv"](wq, sc, xs, ids))
                  for tail, ids in (("", sets[0]), (" repeated", repeated)))
        slice_bytes = (Kd // (2 if elem == "fp4" else 1) + Kd // 32) * N
        bms, by = bound_ms(TOPK * slice_bytes + TOPK * Kd * 2
                           + TOPK * N * 4, 2 * TOPK * N * Kd)
        hosts = [s.tolist() for s in ids_sets]
        eids = [[torch.as_tensor([e], dtype=torch.int32, device=dev)
                 for e in h] for h in hosts]
        stack = stacks[N, Kd]
        x0 = xs[0].contiguous()
        four_mx = time_ms(torch, [
            lambda h=h: [K.mx_qgemv(wq[e], sc[e], xs[j])
                         for j, e in enumerate(h)] for h in hosts])
        four_gemv = time_ms(torch, [
            lambda es=es: [K.gemv(stack, x0, e) for e in es] for es in eids])
        grp.append({
            "shape": f"{elem} codes of {E} experts ({Kd}, {N}) + E8M0, "
                     f"xs ({TOPK}, {Kd}) bf16, {TOPK} ids",
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            "tolerance": TOL["grouped_expert_qgemv"], "library": None,
            "four_mx_qgemv_ms": four_mx[0],
            "eager_four_mx_qgemv_ms": four_mx[1],
            "four_bf16_gemv_ms": four_gemv[0],
            "eager_four_bf16_gemv_ms": four_gemv[1],
            **timed(torch,
                    [lambda s=s: K.grouped_expert_qgemv(wq, sc, xs, s)
                     for s in sets],
                    [lambda s=s: K.PLAIN["grouped_expert_qgemv"](wq, sc, xs,
                                                                 s)
                     for s in sets])})
        del wq, sc
    rows["grouped_expert_qgemv"] = grp
    del stacks
    torch.cuda.synchronize()
    return rows


# ----------------------------------------------------------------- engine
def make_requests(np, rng, vocab, n, max_new=32, longest=400):
    """A shared 24-token system prompt + 40..``longest`` seeded tokens
    each."""
    sysp = rng.integers(1, vocab, 24)
    return [(np.concatenate([sysp, rng.integers(1, vocab, int(
        rng.integers(40, longest + 1)))]).astype(np.int32), max_new)
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


class RoutingPins:
    """The MoE expert picks of one run, replayed in others.

    A router whose two candidate experts are nearly tied picks either one
    as bf16 rounding happens to fall, and the other expert gives another
    output: the kernel path and the plain path, each rounding in its own
    places, can each route a token unlike the fp32 run, and the distance
    between their logits then measures that tie, not their arithmetic.  So
    the logits check records the kernel path's picks (``record``) and runs
    the plain bf16 and the fp32 references with the same picks
    (``replay``: each MoE call takes the recorded experts, gated by its own
    router probabilities).  ``routes[name]`` counts, per replayed run, the
    rows routed, the rows whose own top-k differs from the kernel path's,
    and the widest of those rows' own margins (``check`` bounds both)."""

    def __init__(self, torch):
        from repro_torch.models import moe as MOE
        self.torch, self.MOE, self.real = torch, MOE, MOE._top_k
        self.picks, self.routes = [], {}

    @contextlib.contextmanager
    def _patched(self, fn):
        self.MOE._top_k = fn
        try:
            yield
        finally:
            self.MOE._top_k = self.real

    def record(self):
        self.picks, self.routes = [], {}

        def top_k(logits, mo):
            top_p, top_e = self.real(logits, mo)
            self.picks.append(top_e)
            return top_p, top_e
        return self._patched(top_k)

    def replay(self, name):
        torch, picks = self.torch, iter(self.picks)
        tally = self.routes[name] = {"rows": 0, "flips": 0, "max_margin": 0.0}

        def top_k(logits, mo):
            lg = logits.float().reshape(-1, logits.shape[-1])
            _, own = self.real(lg, mo)
            pinned = next(picks).reshape(own.shape)
            flipped = (torch.sort(own, dim=-1).values
                       != torch.sort(pinned, dim=-1).values).any(-1)
            # the reference's own k-th logit down to its weakest pinned one
            margin = (lg.gather(-1, own).amin(-1)
                      - lg.gather(-1, pinned).amin(-1)).clamp(min=0)
            tally["rows"] += lg.shape[0]
            tally["flips"] += int(flipped.sum())
            tally["max_margin"] = max(tally["max_margin"], float(
                torch.where(flipped, margin, 0.0).amax()))
            top_p = self.MOE._softmax(lg).gather(-1, pinned)
            if mo.norm_topk_prob:
                top_p = top_p / top_p.sum(dim=-1, keepdim=True)
            shape = (*logits.shape[:-1], pinned.shape[-1])
            return (top_p * mo.routed_scaling_factor).reshape(shape), \
                pinned.reshape(shape)
        return self._patched(top_k)

    def check(self, step, noise):
        """Every row a reference routed otherwise was a near tie of its own
        router, and such rows are few (``ROUTE_FLIP_DIV``)."""
        for name, t in self.routes.items():
            if t["flips"] > t["rows"] // ROUTE_FLIP_DIV + 1 or \
                    t["max_margin"] > 2 * noise:
                raise AssertionError(
                    f"{step}: the {name} reference routed {t['flips']} of "
                    f"{t['rows']} rows otherwise than the kernel path, by "
                    f"margins up to {t['max_margin']} (a tie is within "
                    f"{2 * noise})")
        return dict(self.routes)


def logits_phase(torch, np, K, M, model_k, model_p, dev, rng,
                 kv_dtype="bfloat16"):
    """One chunk step, one two-slot decode step and one one-slot decode
    step on identical caches: the kernel path against the plain path, both
    bf16, and both against the plain path in fp32 on the same weights (MX
    weights dequantize in fp32 there).  The two bf16 paths round at
    different places (the kernels keep fp32 probabilities and fp32 gemv
    outputs), and over 24 layers that compounds to a few hundredths of the
    logits' scale, so the criterion is relative to the bf16 noise itself:
    the kernel path must stay within twice the plain path's distance from
    fp32.  A MoE model's references route as the kernel path did
    (``RoutingPins``); the one-slot step takes the routed MoE path (router
    and experts through the kernels), the others the gather path.  int8
    caches (``kv_dtype="int8"``) are the same bytes in all three runs, scale
    pages and bf16 chunk stage included.  Returns the errors, the routing
    flips and the launches of each step."""
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
    pins = RoutingPins(torch)
    out = {}

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def three(name, step, batch, rows=slice(None)):
        """``step`` on the kernel path (launches counted), then on the
        plain bf16 and fp32 paths with its expert picks; the logits of
        ``rows`` held to the criterion."""
        K.reset_launch_counts()
        with M.kernel_routing(), pins.record():
            got, _ = getattr(model_k, step)(batch, caches_a)
        torch.cuda.synchronize()
        out[name + "_launches"] = K.launch_counts()
        with pins.replay("plain"):
            plain, _ = getattr(model_p, step)(batch, caches_b)
        with pins.replay("fp32"):
            fp32, _ = getattr(model_32, step)(batch, caches_32)
        got, plain, fp32 = got[rows], plain[rows], fp32[rows]
        e_kp, e_k32, e_p32 = err(got, plain), err(got, fp32), err(plain, fp32)
        if not torch.isfinite(got.float()).all() or \
                e_k32 > max(2 * e_p32, BF16_TOL):
            raise AssertionError(
                f"{name}: kernel path {e_k32} from fp32, plain bf16 path "
                f"{e_p32} (kernel vs plain {e_kp})")
        out[name + "_route_flips"] = pins.check(name, e_p32)
        out[name + "_logits"] = {
            "kernel_vs_plain": e_kp, "kernel_vs_fp32": e_k32,
            "plain_vs_fp32": e_p32, "max_abs_logit": fp32.abs().max().item(),
            "argmax_equal": bool((got.argmax(-1) == plain.argmax(-1)).all())}
        clone_into(caches_b, caches_a)    # the next step starts from the
        clone_into(caches_32, caches_a)   # kernel path's caches
        return plain

    toks = np.zeros((1, 32), np.int32)
    toks[0, :13] = prompt[32:]
    lp = three("chunk", "chunk_step", {
        "tokens": i32(toks), "offset": i32([32]), "valid": i32([13]),
        "block_tables": bt[:1]})
    # slot 0 decodes position 45; slot 1 is an idle slot (all-NULL table,
    # stale position) whose garbage row nothing reads
    tok = int(lp.argmax(-1)[0])
    bt2 = torch.stack([bt[0], torch.zeros_like(bt[0])])
    three("decode", "decode_step", {
        "tokens": i32([[tok], [0]]), "pos": i32([45, 7]),
        "block_tables": bt2}, rows=slice(0, 1))
    three("decode_one_slot", "decode_step", {
        "tokens": i32([[tok]]), "pos": i32([46]), "block_tables": bt[:1]})
    return out


def decode_profile(torch, np, M, model_k, ecfg, rng, record,
                   name="decode_trace.json", cycles=10):
    """Steady decode of 8 slots on the kernel path: host wall of ``cycles``
    engine cycles, then as many more under ``torch.profiler`` — the
    device's busy share of that window (union of kernel/copy intervals in
    the trace) and the kernels that take the device time."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request, build_engine
    V = model_k.cfg.vocab_size
    eng = build_engine(model_k, dataclasses.replace(ecfg,
                                                    prefix_cache=False))
    for i in range(8):              # no slot finishes inside the window
        eng.submit(Request(rid=i, prompt=rng.integers(1, V, 32).astype(
            np.int32), max_new_tokens=18 + 3 * cycles))
    with M.kernel_routing():
        for _ in range(10):          # one slab each: all 8 decode by now
            eng.step()
        if len(eng._decoding) != 8:
            raise AssertionError("profile window: not every slot decodes")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cycles):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(cycles):
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
    return {"cycles": cycles, "wall_s": wall, "profiled_wall_s": wall_prof,
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
    specs = make_requests(np, rng, V, DENSE_REQUESTS)

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
        f"{res['token_agreement']:.4f} ({res['identical_streams']}/"
        f"{len(specs)} "
        f"identical streams)")
    log(f"  one slot: launches {res['launches_one_slot']}")
    log(f"  chunk step: logits err {res['chunk_logits']}, launches "
        f"{res['chunk_launches']}")
    log(f"  decode step: logits err {res['decode_logits']}, launches "
        f"{res['decode_launches']}")
    log(f"  one-slot decode step: logits err "
        f"{res['decode_one_slot_logits']}, launches "
        f"{res['decode_one_slot_launches']}")
    prof = res["decode_profile"]
    per_cycle = prof['wall_s'] / prof['cycles'] * 1e3
    log(f"  steady decode, 8 slots: {per_cycle:.2f} ms host "
        f"wall per cycle; under the profiler the device is busy "
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
    specs = make_requests(np, rng, V, DENSE_REQUESTS)

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
        f"{res['token_agreement']:.4f} ({res['identical_streams']}/"
        f"{len(specs)} "
        f"identical streams)")
    log(f"  one slot: launches {res['launches_one_slot']}")
    log(f"  chunk step: logits err {res['chunk_logits']}, launches "
        f"{res['chunk_launches']}")
    log(f"  decode step: logits err {res['decode_logits']}, launches "
        f"{res['decode_launches']}")
    log(f"  one-slot decode step: logits err "
        f"{res['decode_one_slot_logits']}, launches "
        f"{res['decode_one_slot_launches']}")
    prof = res["decode_profile"]
    per_cycle = prof['wall_s'] / prof['cycles'] * 1e3
    log(f"  steady decode, 8 slots: {per_cycle:.2f} ms host "
        f"wall per cycle; under the profiler the device is busy "
        f"{prof['device_busy_share']} of the window")
    for name, us in prof["top_kernels_us"][:8]:
        log(f"    {us:10.1f} us  {name}")
    return res


def decode_step_launches(torch, np, K, M, model, rng):
    """The launches of one one-slot decode step on the kernel path (after a
    one-slab prefill of 32 seeded tokens on fresh caches)."""
    from repro_torch.serve import PageSpec
    int8 = model.rt.kv_dtype() == "int8"
    page = 32 if int8 else 16
    spec = PageSpec.for_engine(1, 256, page, dtype=model.rt.kv_dtype())
    caches = model.init_caches(1, 256, page_spec=spec,
                               chunk_stage=32 if int8 else 0)
    dev = model.device

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    bt = i32(np.arange(1, spec.blocks_per_slot + 1)[None])
    prompt = rng.integers(1, model.cfg.vocab_size, 32)
    with M.kernel_routing():
        logits, _ = model.chunk_step(
            {"tokens": i32(prompt[None]), "offset": i32([0]),
             "valid": i32([32]), "block_tables": bt}, caches)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        model.decode_step({"tokens": tok, "pos": i32([32]),
                           "block_tables": bt}, caches)
        torch.cuda.synchronize()
    counts = K.launch_counts()
    del caches
    return counts


def moe_phase(torch, dev, rng, fmt, record=None):
    """Full-width qwen2-moe-a2.7b (random weights from seed 0) through the
    chunked, paged engine: ``fmt="bf16"`` (bf16 weights and pages) or
    ``"mx4"`` (mx4 weights, quantized after the init, and int8 pages).  The
    kernel path against the plain path on the same requests, then one slot
    (every one-row MoE takes the routed path: the fp32 router gemv and the
    expert kernels), the exact launches of one one-slot decode step, the
    logits of a depth cut against fp32, and a profiled decode window."""
    import dataclasses

    import numpy as np
    from torch import nn

    from repro_torch import kernels as K
    from repro_torch.models import Model, RuntimeConfig
    from repro_torch.models import modules as M
    from repro_torch.quant import quantized_stats
    from repro_torch.serve import EngineConfig, build_engine

    quant = fmt == "mx4"
    over = (dict(kv_cache_dtype="int8", quantize_weights="mx4") if quant
            else {})
    ecfg = EngineConfig(slots=8, cache_len=1024, backend="paged",
                        chunked_prefill=True, chunk_size=32,
                        prefix_cache=True, kernel_decode=True, **over)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine("qwen2-moe-a2.7b", ecfg, device=dev, seed=0)
    torch.cuda.synchronize()
    model_k = eng.model
    model_p = model_k.with_runtime(RuntimeConfig(**over))
    cfg = model_k.cfg
    V = cfg.vocab_size
    res = {"init_s": time.perf_counter() - t0,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model_k.parameters()),
           "kv_pool_bytes": kv_bytes(eng.caches),
           "page_size": eng.backend.spec.page_size}
    if quant:
        res["quantized_stats"] = quantized_stats(model_k.params)
    # every 8-slot decode and chunk step of the mx4 path dequantizes all 72
    # expert stacks in the graph (~12.5 G codes), ~1 s a step: fewer,
    # shorter requests there
    n_req, max_new = (4, 8) if quant else (8, 16)
    specs = make_requests(np, rng, V, n_req, max_new, longest=200)

    # the main path, 8 slots: the experts take the gather path
    K.reset_launch_counts()
    with M.kernel_routing():
        reqs_k, wall = serve(torch, eng, specs, V)
    res["launches"] = K.launch_counts()
    missing = [k for k in MOE_PATHS_8_SLOTS[fmt] if res["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the {fmt} MoE path never launched {missing}")
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

    # the main path, one slot: the routed MoE, every kernel of the path
    eng = build_engine(model_k, dataclasses.replace(ecfg, slots=1))
    K.reset_launch_counts()
    with M.kernel_routing():
        _, wall = serve(torch, eng, specs[:2], V)
    res["launches_one_slot"] = K.launch_counts()
    missing = [k for k in MOE_PATHS[fmt] if not res["launches_one_slot"][k]]
    if missing:
        raise AssertionError(f"one-slot {fmt} MoE run never launched "
                             f"{missing}: {res['launches_one_slot']}")
    res["one_slot"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()

    # one one-slot decode step launches exactly the JAX account's kernels
    res["decode_step_launches"] = decode_step_launches(torch, np, K, M,
                                                       model_k, rng)
    want = {k: MOE_DECODE_LAUNCHES[fmt].get(k, 0) for k in REPLACES}
    if res["decode_step_launches"] != want:
        raise AssertionError(f"one-slot {fmt} MoE decode step launched "
                             f"{res['decode_step_launches']}, not {want}")

    # logits against fp32 on a depth cut: the first MOE_CUT layers, sharing
    # the weight tensors (an fp32 copy of all 24 does not fit beside them)
    cut = dataclasses.replace(cfg, num_layers=MOE_CUT)
    params = model_k.params
    shallow = nn.ModuleDict({
        "embed": params["embed"],
        "layers": nn.ModuleList(list(params["layers"][:MOE_CUT])),
        "final_norm": params["final_norm"], "lm_head": params["lm_head"]})
    res.update(logits_phase(
        torch, np, K, M, Model(cut, model_k.rt, shallow),
        Model(cut, model_p.rt, shallow), dev, rng,
        kv_dtype="int8" if quant else "bfloat16"))
    del shallow
    torch.cuda.empty_cache()
    res["decode_profile"] = decode_profile(
        torch, np, M, model_k, ecfg, rng, record,
        f"decode_trace_moe_{fmt}.json", cycles=3 if quant else 10)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    mk, mp = res["kernel_path"]["metrics"], res["plain_path"]["metrics"]
    what = "mx4 weights + int8 KV" if quant else "bf16"
    extra = ""
    if quant:
        qs = res["quantized_stats"]
        extra = (f" ({qs['quantized_leaves']} quantized leaves, "
                 f"{qs['quantized_bytes']:,} B, was "
                 f"{qs['quantized_fp32_bytes']:,} B fp32; "
                 f"{qs['raw_bytes']:,} B raw)")
    log(f"  qwen2-moe-a2.7b full width, {what}: "
        f"{res['weight_bytes'] / 1e9:.3f} GB weights{extra}, "
        f"{res['kv_pool_bytes'] / 1e9:.3f} GB KV pools, peak "
        f"{res['max_memory_allocated'] / 1e9:.1f} GB allocated")
    log(f"  kernel path: {mk['tokens_per_s']:.2f} tok/s, "
        f"{mk['decode_steps_per_s']:.2f} decode steps/s, "
        f"{res['kernel_path']['wall_s']:.2f} s wall, launches "
        f"{res['launches']}")
    log(f"  plain path:  {mp['tokens_per_s']:.2f} tok/s, "
        f"{mp['decode_steps_per_s']:.2f} decode steps/s, "
        f"{res['plain_path']['wall_s']:.2f} s wall")
    log(f"  greedy token agreement kernel vs plain: "
        f"{res['token_agreement']:.4f} ({res['identical_streams']}/"
        f"{len(specs)} identical streams)")
    log(f"  one slot: launches {res['launches_one_slot']}")
    log(f"  one one-slot decode step: launches "
        f"{res['decode_step_launches']} (as the JAX account)")
    log(f"  {MOE_CUT}-layer cut, chunk step: logits err "
        f"{res['chunk_logits']}, rows routed otherwise than the kernel path "
        f"{res['chunk_route_flips']}")
    log(f"  {MOE_CUT}-layer cut, decode step: logits err "
        f"{res['decode_logits']}, rows routed otherwise than the kernel "
        f"path {res['decode_route_flips']}")
    log(f"  {MOE_CUT}-layer cut, one-slot decode step (routed MoE): logits "
        f"err {res['decode_one_slot_logits']}, rows routed otherwise than "
        f"the kernel path {res['decode_one_slot_route_flips']}, launches "
        f"{res['decode_one_slot_launches']}")
    prof = res["decode_profile"]
    per_cycle = prof['wall_s'] / prof['cycles'] * 1e3
    log(f"  steady decode, 8 slots: {per_cycle:.2f} ms host wall per cycle; "
        f"under the profiler the device is busy "
        f"{prof['device_busy_share']} of the window")
    for name, us in prof["top_kernels_us"][:8]:
        log(f"    {us:10.1f} us  {name}")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,engine,quant,moe",
                    help="comma list of kernels,engine,quant,moe (default: "
                         "all)")
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
                       if r.get("bf16_gemv_ms") else "")
                    + (f"  [4 x mx_qgemv {us(r['four_mx_qgemv_ms'])}/"
                       f"{us(r['eager_four_mx_qgemv_ms'])}, 4 x bf16 gemv "
                       f"{us(r['four_bf16_gemv_ms'])}/"
                       f"{us(r['eager_four_bf16_gemv_ms'])}]"
                       if "four_mx_qgemv_ms" in r else ""))
    # launches on the main paths: each run with the counts zeroed before it
    # and read after it (the engine's 8-slot run; the quantized, MoE bf16
    # and MoE mx4 paths' 8-slot and one-slot runs)
    runs = {}
    if "engine" in phases:
        t1 = time.perf_counter()
        eng = engine_phase(torch, dev, rng, args.record)
        log(f"engine phase: {time.perf_counter() - t1:.1f} s")
        runs["qwen1.5 bf16"] = eng["launches"]
        record["engine"] = eng
        del eng
    if "quant" in phases:
        t1 = time.perf_counter()
        qeng = quant_phase(torch, dev, rng, args.record)
        log(f"quantized engine phase: {time.perf_counter() - t1:.1f} s")
        runs["qwen1.5 mx4"] = qeng["launches"]
        runs["qwen1.5 mx4 one slot"] = qeng["launches_one_slot"]
        record["quant"] = qeng
        del qeng
    if "moe" in phases:
        for fmt in ("bf16", "mx4"):
            t1 = time.perf_counter()
            moe = moe_phase(torch, dev, rng, fmt, args.record)
            log(f"MoE {fmt} engine phase: {time.perf_counter() - t1:.1f} s")
            runs[f"qwen2-moe {fmt}"] = moe["launches"]
            runs[f"qwen2-moe {fmt} one slot"] = moe["launches_one_slot"]
            record[f"moe_{fmt}"] = moe
            del moe
            torch.cuda.empty_cache()
    launches = {name: (sum(r[name] for r in runs.values()) if runs
                       else None) for name in REPLACES}
    record["launches_by_run"] = runs

    entries = []
    for name, (src, rep) in REPLACES.items():
        rs = rows.get(name, [])
        head = rs[0] if rs else {}
        # the largest error over the shapes, beside that shape's own gate
        worst = max(rs, key=lambda r: r["max_abs_err"] / r["tolerance"],
                    default={})
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "eager_ms", "eager_plain_ms", "eager_library_ms")
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "shape": head.get("shape"), "launches": launches[name],
            "tolerance": worst.get("tolerance", TOL[name]),
            "max_abs_err": worst.get("max_abs_err"),
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
