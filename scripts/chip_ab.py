#!/usr/bin/env python3
"""One side of a paired run on the card: output digests and device times
of kernels, and serving phases of a tree's ``chip_smoke.py``.

Run from the root of a checkout on a machine with an NVIDIA GPU, once per
tree and in turns (parent, change, change, parent), all in one call:

    python3 scripts/chip_ab.py --tree build/parent
    python3 scripts/chip_ab.py --tree .

For the tree at ``--tree`` (its ``src`` and its ``chip_smoke.py``) it
prints the card's ``nvidia-smi`` name and power limit; one line per gemv
shape with a digest of ``gemv(w, x)`` (and, for bf16, of
``batched_gemv(w, x[None])``) on seeded inputs at the default launch
config, so two trees with equal digests at a shape give the same bits
there; one line per ``axpy`` shape (bf16, 2^20 and 2^27), per
``mx_qgemv`` shape of ``chip_smoke.py``'s kernel rows, per fused MX SwiGLU
shape (fp4 gate + up, 1024 -> 2816 and 2048 -> 5632) and grouped MX expert
shape (fp4, 60 experts, top-4, 2048 -> 1408 and 1408 -> 2048, digests of
distinct and of repeated ids), then for each of these SwiGLU and grouped
shapes at fp4 and fp8, over ``ACCURACY_SETS`` fresh seeded input sets, how
many outputs of the kernel miss the smoke's gate against the plain
version, the largest distance, and each side's distance from the float64
value of the function (exact codes and scales, float64 sums: ``mx_fp64``)
with the outputs past the gate against it; per paged decode
shape (``paged_decode_attention`` over bf16 pages of 16 rows and
``paged_decode_attention_int8`` over int8 pages of 32: 8 slots of a 1024-row
table, at G = 1 with 16 heads of 64 and of 128, and at hd 128 at glm4-9b's
heads, 32 on 2 KV heads, and qwen3-14b's, 40 on 8) and per
``decode_attention_int8`` shape of the smoke (full length), each with a
digest of its output and its device time (CUDA-graph replay over input
copies past twice the L2, the smoke's own ``time_ms``) at the default
config; for each paged decode shape also, over its input copies, how
many bf16 outputs of the kernel and of its plain version are not the
rounding of the float64 value (this checkout's ``paged_decode_fp64``), and
how many of the kernel's miss the smoke's gate against the plain version;
then the paged decodes at the engines' G = 1 shapes with every slot at
one length, 0 to 1024, and their device time at each (``--no-paged``
stops after the MX lines); then ``rmsnorm`` at the smoke's five rows (a
digest and the device time) and in the served path's chains, each
captured in one CUDA graph: a residual add that writes x, rmsnorm, then
the next projection (the one-row ``gemv`` (1024, 1024) for one row,
``F.linear`` for 8), beside the same chain without rmsnorm; then ``qgemv``
and ``batched_qgemv`` at the smoke's rows (a digest, the device time and
the eager time, launched from Python)
and, for each batched row over ``ACCURACY_SETS`` fresh input sets, the
outputs past the smoke's gate against the plain version and each side's
distance from the float64 value (``int_fp64``); then ``batched_mx_qgemv``
at the smoke's rows (a digest and the device time) and, over the same
number of fresh input sets, its and the one-row ``qgemv``'s outputs past
the gate and distances from the float64 value; then ``wkv6`` and
``mamba_scan`` at the smoke's scan rows (the registry examples, rwkv6-3b
and jamba from a zero and a nonzero state: digests of y and of the final
state, the device and eager time, the largest distance from the plain
version); then ``dotp`` at 2^20 and 2^27 bf16 and 2^20 fp32 (a digest,
the device and eager time, and ``torch.dot``'s device time) (``--lines``
picks which of these groups of lines to print);
then it runs serving phases of that tree, each from a fresh seed-0 stream
(``--engines``: ``bf16``, the default, runs ``engine_phase``, qwen1.5-0.5b
bf16, and qwen2-moe-a2.7b's bf16 run (``arch_phase``, in older trees
``moe_phase``); ``mx4`` runs
``quant_phase`` for mx4, qwen1.5-0.5b with MX fp4 weights and int8 pages,
whose one-slot run sends every projection through ``mx_qgemv``; ``none``
runs none), and prints, last, one JSON line of their end-to-end numbers:
tok/s and decode steps/s of the 8-slot kernel and plain paths and of the
one-slot run, and the steady decode window's host ms per cycle and device
busy share.  It exits non-zero without a CUDA device.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

GEMV_SHAPES = (((151936, 1024), "bfloat16"),   # qwen1.5-0.5b's read-out
               ((151936, 2048), "bfloat16"),   # qwen2-moe-a2.7b's read-out
               ((60, 2048), "float32"),        # the MoE router
               ((1024, 1024), "bfloat16"),
               ((1408, 2048), "bfloat16"))
AXPY_SIZES = (1 << 20, 1 << 27)
# dotp's rows: (n, dtype)
DOTP_ROWS = ((1 << 20, "bfloat16"), (1 << 27, "bfloat16"),
             (1 << 20, "float32"))
MX_SHAPES = (((151936, 1024), "fp4"), ((151936, 1024), "fp8"),
             ((1024, 1024), "fp4"), ((1024, 2816), "fp4"),
             ((2048, 2048), "fp4"), ((2048, 5632), "fp4"))
# the fused MX SwiGLU's gate + up (N, K), fp4: qwen1.5-0.5b's MLP and
# qwen2-moe-a2.7b's shared expert
SWIGLU_SHAPES = ((2816, 1024), (5632, 2048))
# the grouped MX experts (N, K), fp4: qwen2-moe-a2.7b's up and down, top-4
# rows of a 60-expert stack
GROUPED_SHAPES = ((1408, 2048), (2048, 1408))
GROUPED_E, GROUPED_TOPK = 60, 4
# fresh input sets a shape and format of the MX accuracy lines
ACCURACY_SETS = 8
# the paged decodes: (H, KV, hd) over 8 slots of a 1024-row table
PAGED_SHAPES = ((16, 16, 64), (16, 16, 128),   # the engines, G = 1
                (32, 2, 128), (40, 8, 128))    # glm4-9b's, qwen3-14b's heads
# the G = 1 sweep: every slot at each of these lengths
SWEEP_LENGTHS = (0, 16, 64, 128, 256, 448, 1024)
# rmsnorm at the smoke's rows (T, d), and the chains of the served path: a
# residual add that writes x, rmsnorm, then the next projection of 1024
# columns (the one-row gemv for one slot, F.linear for 8)
RMS_SHAPES = ((8, 1024), (32, 1024), (1, 1024), (8, 2048), (1, 2048))
RMS_CHAINS = ((1, 1024), (8, 1024))
# the int GEMVs at the smoke's rows: ((N, K), bits, rows of x; 0: qgemv)
QGEMV_ROWS = (((151936, 1024), 8, 0), ((151936, 1024), 4, 0),
              ((2048, 4096), 8, 0), ((2048, 4096), 4, 0),
              ((151936, 1024), 8, 8), ((151936, 1024), 4, 8),
              ((151936, 1024), 8, 16), ((2048, 4096), 8, 4))
# batched_mx_qgemv at the smoke's rows: ((N, K), format, rows of x)
MX_BATCHED_ROWS = (((151936, 1024), "fp4", 8), ((151936, 1024), "fp8", 8),
                   ((151936, 1024), "fp4", 16), ((2048, 4096), "fp4", 4))
# the int8 dense decode: (B, H, KV, hd, S), full length
DENSE_INT8_SHAPES = ((8, 16, 16, 64, 1024), (4, 16, 8, 128, 4096),
                     (4, 32, 2, 128, 4096))


def sha(torch, t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def digests(torch, K):
    for (N, Kd), name in GEMV_SHAPES:
        dtype = getattr(torch, name)
        g = torch.Generator(device="cuda").manual_seed(0)
        w = (torch.randn((N, Kd), device="cuda", generator=g)
             / Kd ** 0.5).to(dtype)
        x = torch.randn(Kd, device="cuda", generator=g).to(dtype)
        line = f"gemv ({N}, {Kd}) {name} {sha(torch, K.gemv(w, x))}"
        if dtype == torch.bfloat16:
            line += (f", batched_gemv B=1 "
                     f"{sha(torch, K.batched_gemv(w, x[None]))}")
        print(line, flush=True)


def kernel_lines(torch, K, smoke, referee, paged=True):
    """axpy, the one-row MX walk (mx_qgemv, the fused SwiGLU, the grouped
    experts), the paged decodes and the int8 dense decode (``paged``): a
    digest of each output on seeded inputs and the device us per call over
    input copies, at the default config; ``referee``: this checkout's
    ``chip_smoke.py`` (its float64 paged decode and its gates)."""
    from repro_torch.quant.tensor import quantize_kv, quantize_mx
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in AXPY_SIZES:
        pairs = [tuple(torch.randn(n, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(2))
                 for _ in range(smoke.copies_for(4 * n))]
        ms = smoke.time_ms(torch, [lambda p=p: K.axpy(1.5, *p)
                                   for p in pairs])[0]
        print(f"axpy n={n} bf16 {sha(torch, K.axpy(1.5, *pairs[0]))} "
              f"{ms * 1e3:.2f} us", flush=True)
        del pairs
        torch.cuda.empty_cache()
    for (N, Kd), elem in MX_SHAPES:
        ws = []
        code_bytes = Kd * N // (2 if elem == "fp4" else 1)
        for _ in range(smoke.copies_for(code_bytes)):
            qt = quantize_mx(torch.randn((Kd, N), device="cuda", generator=g)
                             / Kd ** 0.5, elem=elem)
            ws.append((qt.values, qt.scales))
        x = torch.randn(Kd, device="cuda", generator=g).to(torch.bfloat16)
        ms = smoke.time_ms(torch, [lambda w=w: K.mx_qgemv(*w, x)
                                   for w in ws])[0]
        print(f"mx_qgemv {elem} ({N}, {Kd}) "
              f"{sha(torch, K.mx_qgemv(*ws[0], x))} {ms * 1e3:.2f} us",
              flush=True)
        del ws
        torch.cuda.empty_cache()
    for N, Kd in SWIGLU_SHAPES:
        ws = []
        for _ in range(smoke.copies_for(2 * Kd * N // 2)):
            qts = [quantize_mx(torch.randn((Kd, N), device="cuda",
                                           generator=g) / Kd ** 0.5)
                   for _ in range(2)]
            ws.append((qts[0].values, qts[0].scales, qts[1].values,
                       qts[1].scales))
        x = torch.randn(Kd, device="cuda", generator=g).to(torch.bfloat16)
        ms = smoke.time_ms(torch, [lambda w=w: K.mx_qgemv_swiglu(*w, x)
                                   for w in ws])[0]
        print(f"mx_qgemv_swiglu fp4 ({N}, {Kd}) "
              f"{sha(torch, K.mx_qgemv_swiglu(*ws[0], x))} {ms * 1e3:.2f} us",
              flush=True)
        del ws
        torch.cuda.empty_cache()
    for N, Kd in GROUPED_SHAPES:
        qt = quantize_mx(torch.randn((GROUPED_E, Kd, N), device="cuda",
                                     generator=g) / Kd ** 0.5, axis=-2)
        wq, sc = qt.values, qt.scales
        del qt
        xs = torch.randn((GROUPED_TOPK, Kd), device="cuda",
                         generator=g).to(torch.bfloat16)
        sets = [torch.randperm(GROUPED_E, device="cuda", generator=g)[
            :GROUPED_TOPK].to(torch.int32) for _ in range(16)]
        repeated = torch.full((GROUPED_TOPK,), 12, dtype=torch.int32,
                              device="cuda")
        repeated[2] = 3                           # ids 12, 12, 3, 12
        ms = smoke.time_ms(torch, [lambda s=s: K.grouped_expert_qgemv(
            wq, sc, xs, s) for s in sets])[0]
        print(f"grouped_expert_qgemv fp4 ({N}, {Kd}) "
              f"{sha(torch, K.grouped_expert_qgemv(wq, sc, xs, sets[0]))}, "
              f"repeated ids "
              f"{sha(torch, K.grouped_expert_qgemv(wq, sc, xs, repeated))} "
              f"{ms * 1e3:.2f} us", flush=True)
        del wq, sc
        torch.cuda.empty_cache()
    mx_accuracy(torch, K, referee)
    if not paged:
        return

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g).to(
            torch.bfloat16)

    def paged_inputs(H, KV, hd, page):
        nblk = 1024 // page
        P = slots * nblk + 1
        bt = (torch.randperm(P - 1, device="cuda", generator=g)[
            :slots * nblk] + 1).reshape(slots, nblk).to(torch.int32)
        pools = []
        for _ in range(smoke.copies_for(4 * P * page * KV * hd, cap=4)):
            kv = [randn(P, page, KV, hd) for _ in range(2)]
            pools.append(tuple(kv) if page == 16 else
                         (*quantize_kv(kv[0]), *quantize_kv(kv[1])))
        return bt, pools

    def rounding(name, q, pools, bt, length, hd):
        """Outputs off the float64 value's bf16 rounding (kernel, plain),
        the kernel's past the smoke's gate against the plain version, and
        the outputs counted, over the input copies."""
        tol = referee.TOL[name if hd == 64 else f"{name} hd=128"]
        off_k = off_p = past = n = 0
        for p in pools:
            got = getattr(K, name)(q, *p, bt, length).float()
            want = K.PLAIN[name](q, *p, bt, length).float()
            pools_64 = ((p[0], p[2], bt, length, p[1], p[3]) if len(p) == 4
                        else (p[0], p[1], bt, length))
            x = referee.paged_decode_fp64(torch, q, *pools_64).float().to(
                torch.bfloat16).float()
            off_k += int((got != x).sum())
            off_p += int((want != x).sum())
            past += int(((got - want).abs() > tol + tol * want.abs()).sum())
            n += got.numel()
        return (f"off the float64 rounding: kernel {off_k}, plain {off_p}; "
                f"past the gate against plain {past}; of {n}")

    slots = 8
    for H, KV, hd in PAGED_SHAPES:
        q = randn(slots, H, hd)
        length = torch.randint(64, 449, (slots,), device="cuda",
                               generator=g, dtype=torch.int32)
        for name, page in (("paged_decode_attention", 16),
                           ("paged_decode_attention_int8", 32)):
            bt, pools = paged_inputs(H, KV, hd, page)
            fn = getattr(K, name)
            ms = smoke.time_ms(torch, [lambda p=p: fn(q, *p, bt, length)
                                       for p in pools])[0]
            print(f"{name} H={H} KV={KV} hd={hd} "
                  f"{sha(torch, fn(q, *pools[0], bt, length))} "
                  f"{ms * 1e3:.2f} us; "
                  + rounding(name, q, pools, bt, length, hd), flush=True)
            del pools
            torch.cuda.empty_cache()
    for hd in (64, 128):
        q = randn(slots, 16, hd)
        for name, page in (("paged_decode_attention", 16),
                           ("paged_decode_attention_int8", 32)):
            bt, pools = paged_inputs(16, 16, hd, page)
            fn = getattr(K, name)
            us = []
            for n in SWEEP_LENGTHS:
                length = torch.full((slots,), n, dtype=torch.int32,
                                    device="cuda")
                us.append(smoke.time_ms(torch, [
                    lambda p=p: fn(q, *p, bt, length) for p in pools])[0])
            print(f"{name} G=1 hd={hd} us by length: "
                  + ", ".join(f"{n} {t * 1e3:.2f}"
                              for n, t in zip(SWEEP_LENGTHS, us)), flush=True)
            del pools
            torch.cuda.empty_cache()
    for B, H, KV, hd, S in DENSE_INT8_SHAPES:
        q = randn(B, H, hd)
        length = torch.full((B,), S, dtype=torch.int32, device="cuda")
        caches = []
        for _ in range(smoke.copies_for(2 * B * S * KV * (hd + 2), cap=8)):
            caches.append((*quantize_kv(randn(B, S, KV, hd)),
                           *quantize_kv(randn(B, S, KV, hd))))
        ms = smoke.time_ms(torch, [lambda c=c: K.decode_attention_int8(
            q, *c, length) for c in caches])[0]
        print(f"decode_attention_int8 B={B} H={H} KV={KV} hd={hd} S={S} "
              f"{sha(torch, K.decode_attention_int8(q, *caches[0], length))}"
              f" {ms * 1e3:.2f} us", flush=True)
        del caches
        torch.cuda.empty_cache()



def rmsnorm_lines(torch, K, smoke):
    """rmsnorm at the smoke's rows: a digest of the output on seeded inputs
    and the device us per call (20 launches back to back in a CUDA graph);
    then each chain of ``RMS_CHAINS`` captured in one graph, the add
    writing x, rmsnorm, the projection (us per chain), beside the same
    chain without rmsnorm (the projection of a normalized copy)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(T, d):
        return (torch.randn((T, d), device="cuda", generator=g).to(
            torch.bfloat16), 1 + 0.1 * torch.randn(d, device="cuda",
                                                   generator=g))
    for T, d in RMS_SHAPES:
        x, s = inputs(T, d)
        ms = smoke.time_ms(torch, [lambda: K.rmsnorm(x, s)])[0]
        print(f"rmsnorm T={T} d={d} {sha(torch, K.rmsnorm(x, s))} "
              f"{ms * 1e3:.2f} us", flush=True)
    for T, d in RMS_CHAINS:
        a, s = inputs(T, d)
        b = torch.randn((T, d), device="cuda", generator=g).to(
            torch.bfloat16)
        w = (torch.randn((1024, d), device="cuda", generator=g)
             / d ** 0.5).to(torch.bfloat16)
        h0 = K.rmsnorm(torch.add(a, b), s)

        def proj(h):
            return K.gemv(w, h[0]) if T == 1 else F.linear(h, w)

        def chain():
            return proj(K.rmsnorm(torch.add(a, b), s))

        def bare():
            torch.add(a, b)
            return proj(h0)
        label = "gemv" if T == 1 else "F.linear"
        ms = smoke.time_ms(torch, [chain])[0]
        ms0 = smoke.time_ms(torch, [bare])[0]
        print(f"rmsnorm chain T={T} d={d}: add -> rmsnorm -> {label} "
              f"({1024}, {d}) {sha(torch, chain())} {ms * 1e3:.2f} us; "
              f"add -> {label} {ms0 * 1e3:.2f} us", flush=True)


def int_fp64(torch, wq, scales, bits):
    """The float64 value of absmax codes (N, K | K/2 packed int4) and their
    fp32 group scales (N, G), exactly: (N, K)."""
    from repro_torch.quant.tensor import unpack_int4
    v = (unpack_int4(wq, axis=-1) if bits == 4 else wq).double()
    N, Kd = v.shape
    G = scales.shape[1]
    return (v.reshape(N, G, Kd // G) * scales.double()[..., None]).reshape(
        N, Kd)


def qgemv_lines(torch, K, smoke, referee):
    """``qgemv`` and ``batched_qgemv`` at the smoke's rows: a digest of the
    output on seeded inputs and the device and eager us per call over
    input copies past twice the L2, at the default config; then, for each
    batched row, over ``ACCURACY_SETS`` fresh input sets, the outputs past
    the smoke's gate against the plain version and each side's distance
    from the float64 value (``int_fp64``)."""
    from repro_torch.quant.tensor import quantize
    g = torch.Generator(device="cuda").manual_seed(0)

    def weights(gen, N, Kd, bits, n):
        out = []
        for _ in range(n):
            qt = quantize(torch.randn((N, Kd), device="cuda", generator=gen)
                          / Kd ** 0.5, bits=bits, group_size=128, axis=-1)
            out.append((qt.values, qt.scales))
        return out
    for (N, Kd), bits, B in QGEMV_ROWS:
        name = "batched_qgemv" if B else "qgemv"
        fn = getattr(K, name)
        ws = weights(g, N, Kd, bits, smoke.copies_for(N * Kd * bits // 8))
        x = torch.randn((B, Kd) if B else (Kd,), device="cuda",
                        generator=g).to(torch.bfloat16)
        ms, eager = smoke.time_ms(torch, [lambda w=w: fn(*w, x, bits=bits)
                                          for w in ws])
        print(f"{name} int{bits} B={B} ({N}, {Kd}) "
              f"{sha(torch, fn(*ws[0], x, bits=bits))} {ms * 1e3:.2f} us, "
              f"eager {eager * 1e3:.2f} us", flush=True)
        del ws
        torch.cuda.empty_cache()
    for (N, Kd), bits, B in QGEMV_ROWS:
        if not B:
            continue
        pairs = []
        for i in range(ACCURACY_SETS):
            gen = torch.Generator(device="cuda").manual_seed(3000 + i)
            (wq, sc), = weights(gen, N, Kd, bits, 1)
            xs = torch.randn((B, Kd), device="cuda", generator=gen).to(
                torch.bfloat16)
            pairs.append((K.batched_qgemv(wq, sc, xs, bits=bits),
                          K.PLAIN["batched_qgemv"](wq, sc, xs, bits=bits),
                          xs.double() @ int_fp64(torch, wq, sc, bits).t()))
            del wq, sc
        print(f"accuracy batched_qgemv int{bits} B={B} ({N}, {Kd}) over "
              f"{ACCURACY_SETS} input sets: "
              + tally(referee, "batched_qgemv", pairs), flush=True)
        del pairs
        torch.cuda.empty_cache()


def tile_walk_lines(torch, K, smoke, referee):
    """``batched_mx_qgemv`` at the smoke's rows (``MX_BATCHED_ROWS``): a
    digest of the output on seeded inputs and the device us per call over
    input copies past twice the L2, at the default config; then, over
    ``ACCURACY_SETS`` fresh input sets, the outputs past the smoke's gate
    against the plain version and each side's distance from the float64
    value, for each of these rows (``mx_fp64``) and for the one-row
    ``qgemv`` at the smoke's rows (``int_fp64``)."""
    from repro_torch.quant.tensor import quantize, quantize_mx
    g = torch.Generator(device="cuda").manual_seed(0)

    def mx_weight(gen, N, Kd, elem):
        qt = quantize_mx(torch.randn((Kd, N), device="cuda", generator=gen)
                         / Kd ** 0.5, elem=elem)
        return qt.values, qt.scales
    for (N, Kd), elem, B in MX_BATCHED_ROWS:
        ws = [mx_weight(g, N, Kd, elem) for _ in range(smoke.copies_for(
            N * Kd * (4 if elem == "fp4" else 8) // 8))]
        xs = torch.randn((B, Kd), device="cuda", generator=g).to(
            torch.bfloat16)
        ms = smoke.time_ms(torch, [lambda w=w: K.batched_mx_qgemv(*w, xs)
                                   for w in ws])[0]
        print(f"batched_mx_qgemv {elem} B={B} ({N}, {Kd}) "
              f"{sha(torch, K.batched_mx_qgemv(*ws[0], xs))} "
              f"{ms * 1e3:.2f} us", flush=True)
        del ws
        torch.cuda.empty_cache()
    for (N, Kd), elem, B in MX_BATCHED_ROWS:
        pairs = []
        for i in range(ACCURACY_SETS):
            gen = torch.Generator(device="cuda").manual_seed(4000 + i)
            wq, sc = mx_weight(gen, N, Kd, elem)
            xs = torch.randn((B, Kd), device="cuda", generator=gen).to(
                torch.bfloat16)
            pairs.append((K.batched_mx_qgemv(wq, sc, xs),
                          K.PLAIN["batched_mx_qgemv"](wq, sc, xs),
                          xs.double() @ mx_fp64(torch, wq, sc)))
            del wq, sc
        print(f"accuracy batched_mx_qgemv {elem} B={B} ({N}, {Kd}) over "
              f"{ACCURACY_SETS} input sets: "
              + tally(referee, "batched_mx_qgemv", pairs), flush=True)
        del pairs
        torch.cuda.empty_cache()
    for (N, Kd), bits, B in QGEMV_ROWS:
        if B:
            continue
        pairs = []
        for i in range(ACCURACY_SETS):
            gen = torch.Generator(device="cuda").manual_seed(5000 + i)
            qt = quantize(torch.randn((N, Kd), device="cuda", generator=gen)
                          / Kd ** 0.5, bits=bits, group_size=128, axis=-1)
            x = torch.randn(Kd, device="cuda", generator=gen).to(
                torch.bfloat16)
            pairs.append((K.qgemv(qt.values, qt.scales, x, bits=bits),
                          K.PLAIN["qgemv"](qt.values, qt.scales, x,
                                           bits=bits),
                          int_fp64(torch, qt.values, qt.scales, bits)
                          @ x.double()))
            del qt
        print(f"accuracy qgemv int{bits} ({N}, {Kd}) over {ACCURACY_SETS} "
              f"input sets: " + tally(referee, "qgemv", pairs), flush=True)
        del pairs
        torch.cuda.empty_cache()


def mx_fp64(torch, wq, scales):
    """The float64 value of MX codes (..., K/2 | K, N) and their E8M0
    scales (..., K/32, N), exactly: (..., K, N)."""
    from repro_torch.quant.tensor import FP8_DTYPE, fp4_decode, unpack_fp4
    v = (wq.float() if wq.dtype == FP8_DTYPE
         else fp4_decode(unpack_fp4(wq, axis=-2))).double()
    # 2^(s - 127) as float64 bits: biased exponent s - 127 + 1023
    sc = ((scales.long() + 896) << 52).view(torch.float64)
    shape = v.shape
    v = v.reshape(shape[:-2] + (shape[-2] // 32, 32, shape[-1]))
    return (v * sc.unsqueeze(-2)).reshape(shape)


def tally(referee, name, pairs):
    """Over (kernel, plain, float64) output triples: the kernel's outputs
    past the smoke's gate against the plain version, the largest distance,
    and each side's distance from the float64 value with the outputs past
    the gate against it."""
    tol = referee.TOL[name]
    past = past_k = past_p = n = 0
    err = err_k = err_p = 0.0
    for got, want, exact in pairs:
        got, want = got.double(), want.double()

        def off(a, b):
            return int(((a - b).abs() > tol + tol * b.abs()).sum())
        past += off(got, want)
        past_k += off(got, exact)
        past_p += off(want, exact)
        err = max(err, (got - want).abs().max().item())
        err_k = max(err_k, (got - exact).abs().max().item())
        err_p = max(err_p, (want - exact).abs().max().item())
        n += got.numel()
    return (f"past the gate ({tol:g}) against plain {past} of {n}, "
            f"max {err:.3g}; against float64: kernel {past_k}, max "
            f"{err_k:.3g}; plain {past_p}, max {err_p:.3g}")


def mx_accuracy(torch, K, referee):
    """The fused MX SwiGLU and the grouped MX experts at the smoke's
    shapes, fp4 and fp8, over ``ACCURACY_SETS`` fresh input sets made
    from their own seeds: one line each with the kernel's outputs past the
    smoke's gate against the plain version, the largest distance, and the
    kernel's and the plain version's distances from the float64 value
    (``mx_fp64``), with the outputs of each past the gate against it."""
    from repro_torch.quant.tensor import quantize_mx

    def swiglu_64(g, u):
        return g * torch.sigmoid(g) * u

    for elem in ("fp4", "fp8"):
        for N, Kd in SWIGLU_SHAPES:
            pairs = []
            for i in range(ACCURACY_SETS):
                g = torch.Generator(device="cuda").manual_seed(1000 + i)
                ws = [quantize_mx(torch.randn((Kd, N), device="cuda",
                                              generator=g) / Kd ** 0.5,
                                  elem=elem) for _ in range(2)]
                x = torch.randn(Kd, device="cuda", generator=g).to(
                    torch.bfloat16)
                args = (ws[0].values, ws[0].scales, ws[1].values,
                        ws[1].scales, x)
                x64 = x.double()
                pairs.append((K.mx_qgemv_swiglu(*args),
                              K.PLAIN["mx_qgemv_swiglu"](*args),
                              swiglu_64(x64 @ mx_fp64(torch, *args[:2]),
                                        x64 @ mx_fp64(torch, *args[2:4]))))
            print(f"accuracy mx_qgemv_swiglu {elem} ({N}, {Kd}) over "
                  f"{ACCURACY_SETS} input sets: "
                  + tally(referee, "mx_qgemv_swiglu", pairs), flush=True)
            del pairs
        for N, Kd in GROUPED_SHAPES:
            pairs = []
            for i in range(ACCURACY_SETS):
                g = torch.Generator(device="cuda").manual_seed(2000 + i)
                qt = quantize_mx(torch.randn((GROUPED_E, Kd, N),
                                             device="cuda", generator=g)
                                 / Kd ** 0.5, elem=elem, axis=-2)
                xs = torch.randn((GROUPED_TOPK, Kd), device="cuda",
                                 generator=g).to(torch.bfloat16)
                ids = torch.randperm(GROUPED_E, device="cuda", generator=g)[
                    :GROUPED_TOPK].to(torch.int32)
                ix = ids.long()
                w64 = mx_fp64(torch, qt.values.view(torch.uint8)[ix].view(
                    qt.values.dtype), qt.scales[ix])
                pairs.append((
                    K.grouped_expert_qgemv(qt.values, qt.scales, xs, ids),
                    K.PLAIN["grouped_expert_qgemv"](qt.values, qt.scales,
                                                    xs, ids),
                    torch.einsum("tk,tkn->tn", xs.double(), w64)))
                del qt, w64
            print(f"accuracy grouped_expert_qgemv {elem} ({N}, {Kd}) over "
                  f"{ACCURACY_SETS} input sets: "
                  + tally(referee, "grouped_expert_qgemv", pairs), flush=True)
            del pairs
            torch.cuda.empty_cache()


def scan_inputs(torch, name, label, state, g):
    """The smoke's scan rows' inputs: the registry example, or rwkv6-3b's
    time mix / jamba's Mamba layer (fp32, seeded) from a zero or a nonzero
    state."""
    from repro_torch import tune
    dev = torch.device("cuda", 0)
    if label == "registry example":
        return tune.REGISTRY[name].example(small=False, device=dev)[0]

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g)
    if name == "rwkv6":
        B, T, H, hd = 1, 2048, 40, 64
        return (randn(B, T, H, hd), randn(B, T, H, hd), randn(B, T, H, hd),
                torch.exp(-torch.exp(randn(B, T, H, hd))),
                torch.full((H, hd), 0.5, device=dev),
                randn(B, H, hd, hd) if state
                else torch.zeros((B, H, hd, hd), device=dev))
    b, T, di = 1, 2048, 8192
    return (randn(b, T, di), torch.nn.functional.softplus(randn(b, T, di)),
            randn(b, T, 16), randn(b, T, 16), -torch.exp(randn(di, 16)),
            torch.ones((di,), device=dev),
            randn(b, di, 16) if state
            else torch.zeros((b, di, 16), device=dev))


def scan_lines(torch, K, smoke):
    """``wkv6`` and ``mamba_scan`` at the smoke's scan rows (the registry
    examples, rwkv6-3b and jamba from a zero and a nonzero state): digests
    of y and of the final state, the device and eager us per call over
    input copies past twice the L2 at the default config, and the largest
    distance from the plain version (the smoke's gates: 2.8e-4, 1.4e-4)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, fn, shapes in (
            ("rwkv6", K.wkv6, ("registry example", "rwkv6-3b")),
            ("mamba_scan", K.mamba_scan, ("registry example", "jamba"))):
        for label in shapes:
            for state in ((False,) if label == "registry example"
                          else (False, True)):
                args = scan_inputs(torch, name, label, state, g)
                nbytes = sum(a.numel() * a.element_size() for a in args)
                sets = [args] + [tuple(a.clone() for a in args) for _ in
                                 range(smoke.copies_for(nbytes) - 1)]
                ms, eager = smoke.time_ms(torch, [lambda s=s: fn(*s)
                                                  for s in sets])
                got = fn(*args)
                want = K.PLAIN[name](*args)
                err = max((a - b).abs().max().item()
                          for a, b in zip(got, want))
                print(f"{name} {label} {'nonzero' if state else 'zero'} "
                      f"state y {sha(torch, got[0])} state "
                      f"{sha(torch, got[1])} {ms * 1e3:.2f} us, eager "
                      f"{eager * 1e3:.2f} us, max_abs_err {err:.3g}",
                      flush=True)
                del sets, args, got, want
                torch.cuda.empty_cache()


def dotp_lines(torch, K, smoke):
    """``dotp`` at ``DOTP_ROWS`` (seeded inputs, the default config): a
    digest of its output, its device and eager us per call and
    ``torch.dot``'s device us, over input copies past twice the L2."""
    g = torch.Generator(device="cuda").manual_seed(0)
    for n, name in DOTP_ROWS:
        dtype = getattr(torch, name)
        size = torch.empty((), dtype=dtype).element_size()
        pairs = [tuple(torch.randn(n, device="cuda", generator=g).to(dtype)
                       for _ in range(2))
                 for _ in range(smoke.copies_for(2 * n * size))]
        ms, eager = smoke.time_ms(torch, [lambda p=p: K.dotp(*p)
                                          for p in pairs])
        lib = smoke.time_ms(torch, [lambda p=p: torch.dot(*p)
                                    for p in pairs])[0]
        digest = sha(torch, K.dotp(*pairs[0]).reshape(1))
        print(f"dotp n={n} {name} {digest} {ms * 1e3:.2f} us, eager "
              f"{eager * 1e3:.2f} us, torch.dot {lib * 1e3:.2f} us",
              flush=True)
        del pairs
        torch.cuda.empty_cache()


def load_smoke(path):
    spec = importlib.util.spec_from_file_location(f"smoke_{abs(hash(path))}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rates(res):
    """A phase's serving rates; a tree whose engines capture their steps
    also gives its eager run's (``eager_path``, ``eager_`` keys)."""
    out = {}
    for run in ("kernel_path", "eager_path", "plain_path", "one_slot"):
        if run in res:
            m = res[run]["metrics"]
            out[run] = {"tokens_per_s": m["tokens_per_s"],
                        "decode_steps_per_s": m["decode_steps_per_s"]}
    for key, pre in (("decode_profile", ""), ("decode_profile_eager",
                                              "eager_")):
        if key in res:
            prof = res[key]
            out[pre + "host_ms_per_cycle"] = (prof["wall_s"] / prof["cycles"]
                                              * 1e3)
            out[pre + "device_busy_share"] = prof["device_busy_share"]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True,
                    help="root of the tree to run (its src/ and "
                         "chip_smoke.py)")
    ap.add_argument("--no-paged", action="store_true",
                    help="stop after the MX lines: no paged or int8 dense "
                         "decode lines")
    ap.add_argument("--lines",
                    default="gemv,axpy_mx_paged,rmsnorm,qgemv,tile_walks,"
                            "scans,dotp",
                    help="comma list of the kernel lines to print: gemv "
                         "(the gemv digests), axpy_mx_paged (axpy, the MX "
                         "walk and, unless --no-paged, the paged and int8 "
                         "dense decodes), rmsnorm, qgemv, tile_walks "
                         "(batched_mx_qgemv, and both tile walks' accuracy), "
                         "scans (wkv6 and mamba_scan), dotp (default: "
                         "all)")
    ap.add_argument("--engines", choices=("bf16", "mx4", "none"),
                    default="bf16", help="serving phases to run (default: "
                                         "bf16)")
    args = ap.parse_args()
    tree = args.tree.resolve()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_ab: needs an NVIDIA GPU")
    sys.path.insert(0, str(tree / "src"))
    cache = tempfile.TemporaryDirectory()
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(cache.name) / "e.json")
    smoke, referee = (load_smoke(path / "chip_smoke.py") for path in
                      (tree, Path(__file__).resolve().parents[1]))
    from repro_torch.kernels import ops as K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"tree {tree}", flush=True)
    K.build()
    lines = set(args.lines.split(","))
    if "gemv" in lines:
        digests(torch, K)
    if "axpy_mx_paged" in lines:
        kernel_lines(torch, K, smoke, referee, not args.no_paged)
    if "rmsnorm" in lines:
        rmsnorm_lines(torch, K, smoke)
    if "qgemv" in lines:
        qgemv_lines(torch, K, smoke, referee)
    if "tile_walks" in lines:
        tile_walk_lines(torch, K, smoke, referee)
    if "scans" in lines:
        scan_lines(torch, K, smoke)
    if "dotp" in lines:
        dotp_lines(torch, K, smoke)
    out = {}
    if args.engines == "bf16":
        out["qwen1.5 bf16"] = rates(smoke.engine_phase(
            torch, dev, np.random.default_rng(0)))
        rng = np.random.default_rng(0)
        if hasattr(smoke, "arch_phase"):      # the served archs' one phase
            moe = smoke.arch_phase(torch, dev, "moe",
                                   smoke.ARCH_PHASES["moe"].runs[0], rng)
        else:
            moe = smoke.moe_phase(torch, dev, rng, "bf16")
        out["qwen2-moe bf16"] = rates(moe)
    elif args.engines == "mx4":
        out["qwen1.5 mx4"] = rates(smoke.quant_phase(
            torch, dev, np.random.default_rng(0), None, "mx4"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
