#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
checks in their SASS that the kernels built on the tensor cores use them
(``TENSOR_CORE``), holds each one against its plain PyTorch version at
the serving and training shapes and times it (the full-sequence
attention and the two scans, which no model path runs, at the widths of
qwen1.5-0.5b, glm4-9b, rwkv6-3b and jamba, at every candidate of their
tuner spaces), runs the tuner (``repro_torch.tune``) over every registry
name, each a CUDA kernel, on an empty cache of its own, then again from that
cache, and builds an engine that carries the winners, then serves through
the chunked, paged engine (on an empty cache: the default launch
parameters) with every kernel on, random weights from seed 0: full-width
qwen1.5-0.5b with bf16 weights and KV pages, with mx4 weights and int8 KV
pages, with int8 weights and bf16 pages and with int4 weights and int8
pages (int weights dequantize in the graph, as in the JAX package), then
full-width qwen2-moe-a2.7b (60 experts, top-4, a gated shared expert) in
bf16 and in mx4 + int8 pages — each engine's chunk and decode steps
captured once as CUDA graphs and replayed, and each kernel path run again
with eager steps on the same requests (the same greedy tokens bit for bit,
the same launches; host ms per cycle and device busy share of both) —,
then trains full-width qwen1.5-0.5b (fp32
masters, bf16 compute) for a few steps through the fused AdamW kernel,
against a run with the plain optimizer, and checks a failure's restore on a 4-layer cut.  It
checks that each path went through its kernels (for the MoE, the exact
launches of a one-slot decode step; for training, one launch per leaf of
the JAX parameter tree per step), that the allocator balances, that the
kernel path's logits agree with the plain path's and that the loss falls.
Every phase fails loudly.  It prints the card's ``nvidia-smi`` name and
power limit, one JSON line ``{"kernels": [...]}`` and, last, ``{"ok": true,
"device": {...}}``.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.  ``--record DIR`` also writes the full record
(``chip_smoke.json``: nvcc/ptxas output, every timing and engine metric)
and the profiler traces of the decode windows and of two training steps
(``*trace*.json.gz``) to DIR.  ``--phases`` runs a subset (kernels, tune,
engine, quant, moe, train).
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import os
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
# bf16 rounding flips of outputs of order 0.1 to 0.5).  The fused AdamW
# rounds each of its plain version's fp32 operations on its own, in the
# same order: its first measured error (its first run on an NVIDIA H100
# 80GB HBM3 at 700 W, every leaf shape, streams 1 and 2, fp32 and bf16
# masters; PERF.md §6) was 0, and fourfold that is 0 — the kernel must
# give its plain version's bits.  So must axpy: it rounds its plain
# version's fp32 multiply and add each on its own (no fused multiply-add).
# dotp sums the same fp32 products in another order: its gate is 1e-5 of
# sum |x_i y_i| (the row's "tolerance" is that bound, in absolute units).
# The batched gemv has gemv's gate; the dense decode attention the paged
# decode's first gate (bf16 outputs of order 0.1, single rounding flips).
# The int slice's kernels take fourfold headroom over their first measured
# errors (their first run through these checks on an NVIDIA H100 80GB HBM3
# at 700 W, seeded inputs; PERF.md §6): qgemv 9.8e-7 -> 4e-6, batched_qgemv
# 3.3e-6 -> 1.4e-5 and batched_mx_qgemv 7.2e-7 -> 3e-6 (fp32 outputs of
# order 1 from the same dequantized weights, summed in another order), the
# int8 dense decode 1.2e-4 -> 5e-4 (bf16 outputs, single rounding flips).
# qgemv's int4 row at the registry's (2048, 4096), added later, first
# measured 8.3e-7 (under the first 9.8e-7): the same gate holds it.  The
# full-sequence attention and the scans take fourfold headroom over their
# first measured errors, the largest over their shapes and tuner
# candidates (their first run through these checks on an NVIDIA H100 80GB
# HBM3 at 700 W, seeded inputs; PERF.md §6): flash_attention fp32 6.9e-7
# -> 2.8e-6 (fp32 softmax-weighted means, the same sums in another order)
# and bf16 2.0e-3 -> 8e-3 (single bf16 rounding flips of outputs of order
# 0.1 to 1); wkv6 6.9e-5 -> 2.8e-4 and mamba_scan 3.4e-5 -> 1.4e-4 (fp32
# states of order 1 to 10 over 2048 steps: the plain versions multiply the
# decays step by step, the wkv6 kernel sums their logarithms in chunks,
# and the error grows with the chunk).  The bf16 flash attention on the
# tensor cores rounds p to bf16 before its second product: one bf16 ulp of
# outputs of order 1 (7.8e-3), inside the same gate (8e-3 + 8e-3 |x|), and
# SDPA's own error against the plain version is as large (PERF.md §6).
BF16_TOL = 2e-2
TOL = {"rmsnorm": BF16_TOL, "gemv": BF16_TOL, "gemv_f32": 3e-6,
       "paged_decode_attention": 4e-3, "prefill_attention_paged": 4e-3,
       "paged_decode_attention_int8": 2.5e-4, "mx_qgemv": 5e-6,
       "mx_qgemv_swiglu": 6e-6, "grouped_expert_qgemv": 8e-6,
       "paged_decode_attention hd=128": 2.5e-4,
       "prefill_attention_paged hd=128": 4e-3,
       "paged_decode_attention_int8 hd=128": 8e-3,
       "fused_adamw": 0.0, "fused_adamw bf16": 0.0,
       "axpy": 0.0, "dotp": 1e-5, "batched_gemv": BF16_TOL,
       "decode_attention": 4e-3, "qgemv": 4e-6, "batched_qgemv": 1.4e-5,
       "batched_mx_qgemv": 3e-6, "decode_attention_int8": 5e-4,
       "flash_attention": 2.8e-6, "flash_attention bf16": 8e-3,
       "rwkv6": 2.8e-4, "mamba_scan": 1.4e-4}
# The paged decodes' outputs are bf16 of order 0.1, held to the plain
# version at gates as tight as 2.5e-4, which no bf16 rounding flip of an
# output past 1/16 meets: the check asks the kernel to round each such
# output as the plain version does.  Where the plain version's fp32 result
# and the float64 value of the same function (``paged_decode_fp64``) round
# to two neighbouring bf16 values, the plain version's output carries its
# own fp32 error; there an output that misses the gate passes only if it
# is the other neighbour, the one nearer the float64 value, and at most 1
# + n // REF_ROUND_DIV of a check's n outputs may (each is logged and
# counted in its row's ``reference_rounding``).  The glm4-9b row's bf16
# check meets one: the plain version's fp32 output 0.110107421875 sits on
# the tie between 0.10986328125 and 0.1103515625 and rounds up, its
# float64 value 0.110107403777 rounds down, as the kernel does (PERF.md
# §6, PR 22).
REF_ROUND_DIV = 16384
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
    "fused_adamw": ("src/repro_torch/kernels/csrc/fused_adamw.cu",
                    "src/repro/kernels/fused_adamw.py:64"),
    "dotp": ("src/repro_torch/kernels/csrc/dotp.cu",
             "src/repro/kernels/dotp.py:69"),
    "axpy": ("src/repro_torch/kernels/csrc/axpy.cu",
             "src/repro/kernels/axpy.py:52"),
    "batched_gemv": ("src/repro_torch/kernels/csrc/gemv.cu",
                     "src/repro/kernels/ops.py:43"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:96"),
    "qgemv": ("src/repro_torch/kernels/csrc/qgemv.cu",
              "src/repro/quant/kernels.py:174"),
    "batched_qgemv": ("src/repro_torch/kernels/csrc/qgemv.cu",
                      "src/repro/quant/kernels.py:191"),
    "batched_mx_qgemv": ("src/repro_torch/kernels/csrc/mx_gemv.cu",
                         "src/repro/quant/kernels.py:367"),
    "decode_attention_int8": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:354"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:84"),
    "rwkv6": ("src/repro_torch/kernels/csrc/rwkv6.cu",
              "src/repro/kernels/rwkv6.py:107"),
    "mamba_scan": ("src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan.py:91"),
}
# the kernels built on the tensor cores, by library: the functions whose
# SASS (``cuobjdump -sass``) must hold the instruction — the bf16 flash
# attention's wgmma (HGMMA), and the mma.sync (HMMA) of the batched GEMV, the
# bf16 and the int8 dense decode, the paged decode (bf16 and int8 pages),
# the paged prefill and the int and MX tile walks
TENSOR_CORE = {"flash_attention": (("flash_bf16_kernel", "HGMMA"),),
               "gemv": (("batched_gemv_kernel", "HMMA"),),
               "decode_attention": (("decode_mma_kernel", "HMMA"),
                                    ("decode_q8_mma_kernel", "HMMA"),
                                    ("paged_decode_mma_kernel", "HMMA")),
               "prefill_attention": (("prefill_mma_kernel", "HMMA"),),
               "qgemv": (("qgemv_mma_kernel", "HMMA"),),
               "mx_gemv": (("mx_mma_kernel", "HMMA"),)}
# the kernels of the tuner's path (the tune phase): every registry name is
# tuned and then launched through its dispatching entry point, and the
# unregistered batched gemv through its own
TUNE_PATH = ("rmsnorm", "gemv", "paged_decode_attention",
             "prefill_attention_paged", "paged_decode_attention_int8",
             "mx_qgemv", "mx_qgemv_swiglu", "grouped_expert_qgemv",
             "fused_adamw", "dotp", "axpy", "decode_attention",
             "batched_gemv", "qgemv", "batched_qgemv", "batched_mx_qgemv",
             "decode_attention_int8", "flash_attention", "rwkv6",
             "mamba_scan")
# the dispatching entry point of a registry name, where the two differ
ENTRY = {"rwkv6": "wkv6"}
# the kernels whose tuned knobs an engine's steps launch with (bf16 pages;
# ``serve.step.launch_config``): the engine also carries the tuned configs
# of the other decode-path names (dense decode, int8 dense decode, qgemv),
# which its path does not launch
ENGINE_LAUNCHED = ("gemv", "rmsnorm", "paged_decode_attention",
                   "prefill_attention_paged")
# a tuned fraction of the roofline above this is a measuring fault (inputs
# read from L2, or a wrong cost model)
MAX_FRACTION = 1.05
# the kernels of each served path: bf16 weights and pages, then the
# quantized qwen1.5-0.5b runs, each (weights, KV pages, kernels its 8-slot
# run must launch, kernels its one-slot run must launch, kernels it must
# not launch): mx4 + int8 pages (whose main path also runs rmsnorm and,
# at chunk steps, the read-out through mx_qgemv); int8 weights + bf16
# pages and int4 + int8 pages, whose projections, read-out included,
# dequantize in the graph as in the JAX package (over int8 pages the slab
# attends through the gathered view, not the prefill kernel)
BF16_PATH = ("rmsnorm", "gemv", "paged_decode_attention",
             "prefill_attention_paged")
QUANT_PATH = ("paged_decode_attention_int8", "mx_qgemv", "mx_qgemv_swiglu")
INT_NEVER = ("gemv", "mx_qgemv", "mx_qgemv_swiglu", "qgemv",
             "batched_qgemv")
QUANT_RUNS = {
    "mx4": ("mx4", "int8", ("paged_decode_attention_int8",), QUANT_PATH, ()),
    "int8": ("int8", "", BF16_PATH[:1] + BF16_PATH[2:],
             BF16_PATH[:1] + BF16_PATH[2:], INT_NEVER),
    "int4": ("int4", "int8", ("rmsnorm", "paged_decode_attention_int8"),
             ("rmsnorm", "paged_decode_attention_int8"), INT_NEVER),
}
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
# at most one routed row in ROUTE_FLIP_DIV, plus one.  The fp32 reference's
# count leaves out the rows where the plain bf16 path, which launches no
# kernel, routes as the kernel path did: there both bf16 paths tie the
# same way, and the flip is bf16's against fp32, not the kernels' (the
# qwen2-moe mx4 two-slot decode step of ``--phases quant,moe`` meets 3 such
# rows of 12, margins <= 0.0028, on an NVIDIA H100; PERF.md §6).  A fault
# that moves the hidden states routes many rows otherwise than both, by
# wide margins.
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


# Training (qwen1.5-0.5b at full width and depth, fp32 masters, bf16
# compute, remat "dots", the launcher's default batch of 8 x 128 tokens):
# optimizer steps of the fused run and of the plain-optimizer run, the
# leaves of the JAX parameter tree (one fused launch each per step), and
# the depth of the cut that takes an injected failure and its restore.
TRAIN_STEPS = 10
TRAIN_LEAVES = 15
TRAIN_CUT = 4
# The fused run against the plain-optimizer run on the same data, from the
# same init: the two optimizers differ in rounding only (the kernel forms
# 1 - b1 and 1 - b2 in fp32, the plain route from Python floats: ~2e-7 of
# the moments), but Adam normalizes each element's update, so a master
# whose gradient is rounding noise moves by a noise-driven fraction of lr,
# differently in the two runs, and the clipped steps (gradient norms up to
# 17) carry that forward.  Step 1 is the same (same init, same batch);
# the first run through all 10 steps (PERF.md §6) measured 9.4e-3 at
# step 7.  The gate is 1% of the loss's fall over the run (12.3 -> 9.5).
TRAIN_LOSS_TOL = 3e-2
# The restart check holds the resumed run to the uninterrupted one with the
# JAX package's own test tolerance (tests/test_trainer_ft.py).
RESTART_TOL = dict(rtol=1e-5, atol=1e-6)


def log(*a):
    print(*a, flush=True)


def sass_check():
    """HGMMA and HMMA instructions in the SASS of each library of
    ``TENSOR_CORE`` (``cuobjdump`` beside ``nvcc``), and of its kernel's
    instantiations; raises if an instantiation has none of its
    instruction."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = {}
    for lib, kernels in TENSOR_CORE.items():
        sass = subprocess.run(
            [str(tool), "-sass", str(_build.build_dir() / f"lib{lib}.so")],
            capture_output=True, text=True, check=True).stdout
        funcs = sass.split("Function : ")[1:]
        out[lib] = {"HGMMA": sass.count("HGMMA"), "HMMA": sass.count("HMMA"),
                    "kernels": {}}
        for fn, instr in kernels:
            counts = [f.count(instr) for f in funcs
                      if fn in f.split("\n", 1)[0]]
            if not counts or min(counts) == 0:
                raise AssertionError(f"lib{lib}.so: {fn} has an "
                                     f"instantiation without {instr} "
                                     f"(counts {counts})")
            out[lib]["kernels"][fn] = {"instruction": instr,
                                       "per_instantiation": counts}
    return out


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


def timed(torch, kernel, plain, library=None, plain_kw=None, **kw):
    """The timing keys of one kernel row (lists of zero-argument calls;
    ``library`` None: no PyTorch call computes the function; ``kw`` goes to
    ``time_ms``, and ``plain_kw``, where given, instead for the plain
    version)."""
    out = {"library_ms": None, "eager_library_ms": None}
    for key, fns in (("", kernel), ("plain_", plain), ("library_", library)):
        if fns is not None:
            out[key + "ms"], out["eager_" + key + "ms"] = time_ms(
                torch, fns, **(plain_kw if key == "plain_" and plain_kw
                               else kw))
    return out


def paged_decode_fp64(torch, q, k_pool, v_pool, block_tables, length,
                      k_scales=None, v_scales=None):
    """The paged decode's function in float64 (int8 pools dequantized by
    their scales): the referee of ``REF_ROUND_DIV``'s rule."""
    B, H, hd = q.shape
    nblk = block_tables.shape[1]
    page, KV = k_pool.shape[1], k_pool.shape[2]
    ix = block_tables.long()
    k, v = k_pool[ix].double(), v_pool[ix].double()
    if k_scales is not None:
        k, v = k * k_scales[ix].double(), v * v_scales[ix].double()
    S = nblk * page
    k, v = k.reshape(B, S, KV, hd), v.reshape(B, S, KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs",
                     q.double().reshape(B, KV, H // KV, hd), k) * hd ** -0.5
    mask = (torch.arange(S, device=q.device)[None, None, None, :]
            >= length.long()[:, None, None, None])
    p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v).reshape(B, H, hd)


def copies_for(nbytes: int, cap: int = 64) -> int:
    """Input copies whose total exceeds twice the 50 MB L2."""
    return max(1, min(cap, -(-100_000_000 // max(nbytes, 1))))


# ---------------------------------------------------------------- kernels
def candidate_rows(torch, name, call, want, agree, label, key, sets,
                   pick=lambda x: x, exact=None):
    """Every candidate of ``name``'s tuner space: ``pick`` of its output
    held against ``want`` at the gate ``key`` (``exact``: the float64
    referee of ``REF_ROUND_DIV``'s rule), a second launch that must give the
    same bits, and its device time over the input ``sets`` (``call(inputs,
    cfg)``)."""
    from repro_torch import tune
    from repro_torch.tune.search import enumerate_space
    spec = tune.REGISTRY[name]
    out = []
    for cfg in enumerate_space(spec):
        knobs = {k: getattr(cfg, k) for k in spec.space}
        got = call(sets[0], cfg)
        err = agree(f"{name} {label} {knobs}", pick(got), want, key, exact)
        if not torch.equal(got, call(sets[0], cfg)):
            raise AssertionError(f"{name} {label} {knobs}: two launches on "
                                 f"the same inputs differ")
        ms = time_ms(torch, [lambda s=s, c=cfg: call(s, c) for s in sets],
                     reps=CANDIDATE_REPS, inner=CANDIDATE_INNER)[0]
        out.append({"knobs": knobs, "max_abs_err": err, "ms": ms})
    return out


def attention_rows(torch, K, F, t, agree, dev, rng, hd):
    """The three paged-attention kernels at the engine's geometry: 16 heads
    of ``hd`` (64: qwen1.5-0.5b, 128: qwen2-moe-a2.7b), 8 slots, cache_len
    1024 -> 64 blocks of 16 bf16 rows or 32 blocks of 32 int8 rows per
    slot; each kernel at every candidate of its tuner space, and the
    prefill, at hd 128, also at glm4-9b's heads (32 query heads on 2 KV
    heads)."""
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
    want = K.PLAIN["paged_decode_attention"](q, kp, vp, bt, length)
    exact = paged_decode_fp64(torch, q, kp, vp, bt, length)
    rounded0 = agree.reference_rounding
    err = agree(f"paged_decode_attention {tag}",
                K.paged_decode_attention(q, kp, vp, bt, length), want,
                key("paged_decode_attention"), exact)
    # odd nblk, a length that ends mid-page, a stale length past the table
    bt_odd = bt[:, :7].contiguous()
    len_odd = torch.as_tensor(np.asarray([1, 5, 17, 40, 100, 111, 112, 200],
                                         np.int32), device=dev)
    err_edge = agree(
        f"paged_decode_attention {tag} (odd nblk)",
        K.paged_decode_attention(q, kp, vp, bt_odd, len_odd),
        K.PLAIN["paged_decode_attention"](
            q, kp, vp, bt_odd, torch.clamp(len_odd, max=7 * page)),
        key("paged_decode_attention"),
        paged_decode_fp64(torch, q, kp, vp, bt_odd,
                          torch.clamp(len_odd, max=7 * page)))
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
        "candidates": candidate_rows(
            torch, "paged_decode_attention",
            lambda p, c: K.paged_decode_attention(q, p[0], p[1], bt, length,
                                                  c),
            want, agree, tag, key("paged_decode_attention"), pools,
            exact=exact),
        "reference_rounding": agree.reference_rounding - rounded0,
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
    PK = K.PLAIN["prefill_attention_paged"]

    def prefill_row(H_, KV_, pools_, bt1, off, valid, label):
        """One prefill row: one slab of C rows at ``off`` over the pools'
        first table row, every candidate, SDPA (GQA inside) beside it."""
        q1 = t(rng.standard_normal((1, C, H_, hd)))
        q_off = torch.as_tensor([off], dtype=torch.int32, device=dev)
        ln = torch.as_tensor([off + valid], dtype=torch.int32, device=dev)
        kp_, vp_ = pools_[0]
        want = PK(q1, kp_, vp_, bt1, q_off, ln)[:, :valid]  # pad rows: garbage
        cands = candidate_rows(
            torch, "prefill_attention_paged",
            lambda p, c: K.prefill_attention_paged(q1, p[0], p[1], bt1, q_off,
                                                   ln, c),
            want, agree, f"{label} off={off}", key("prefill_attention_paged"),
            pools_, pick=lambda x: x[:, :valid])
        ix = bt1[0].long()
        dv1 = [tuple(a[ix].reshape(1, S, KV_, hd).transpose(1, 2).contiguous()
                     for a in p) for p in pools_]
        q1s = q1.transpose(1, 2)
        spos = torch.arange(S, device=dev)[None, :]
        qpos = off + torch.arange(C, device=dev)[:, None]
        m1 = ((spos <= qpos) & (spos < off + valid))[None, None]
        visible = sum(min(off + r + 1, off + valid) for r in range(C))
        bms, by = bound_ms((off + valid) * KV_ * hd * 4 + 2 * C * H_ * hd * 2
                           + nblk * 4, 4 * H_ * hd * visible)
        return {
            "shape": f"{label}: q (1, {C}, {H_}, {hd}) bf16, pools (P, "
                     f"{page}, {KV_}, {hd}), bt (1, {nblk}), q_offset {off}, "
                     f"length {off + valid}",
            "max_abs_err": max(c["max_abs_err"] for c in cands),
            "bound_ms": bms, "bound_by": by,
            "tolerance": TOL[key("prefill_attention_paged")],
            "library": "scaled_dot_product_attention (mask, enable_gqa)",
            "candidates": cands,
            **timed(torch,
                    [lambda p=p: K.prefill_attention_paged(
                        q1, p[0], p[1], bt1, q_off, ln) for p in pools_],
                    [lambda p=p: PK(q1, p[0], p[1], bt1, q_off, ln)
                     for p in pools_],
                    [lambda dv=dv: F.scaled_dot_product_attention(
                        q1s, dv[0], dv[1], attn_mask=m1,
                        enable_gqa=H_ != KV_) for dv in dv1])}

    for off, valid in ((224, 32), (0, 17), (401, 23)):
        pre.append(prefill_row(H, KV, pools, bt[:1].contiguous(), off, valid,
                               f"{H} heads"))
    del pools
    if hd == 128:
        # glm4-9b's heads: 32 query heads on 2 KV heads, G = 16 (512 rows a
        # KV head in a slab of 32)
        Hg, KVg = 32, 2
        pools_g = [(t(rng.standard_normal((P, page, KVg, hd))),
                    t(rng.standard_normal((P, page, KVg, hd))))
                   for _ in range(copies_for(2 * P * page * KVg * hd * 2))]
        bt_g = torch.as_tensor((rng.permutation(P - 1)[:nblk] + 1)
                               .astype(np.int32)[None], device=dev)
        for off, valid in ((224, 32), (401, 23)):
            pre.append(prefill_row(Hg, KVg, pools_g, bt_g, off, valid,
                                   "glm4-9b heads"))
        del pools_g

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
    want8 = P8F(q, *pools8[0], bt8, length)
    k8, ks, v8, vs = pools8[0]
    exact8 = paged_decode_fp64(torch, q, k8, v8, bt8, length, ks, vs)
    rounded0 = agree.reference_rounding
    err = agree(f"paged_decode_attention_int8 {tag}",
                K8(q, *pools8[0], bt8, length), want8,
                key("paged_decode_attention_int8"), exact8)
    len_odd8 = torch.as_tensor(np.asarray([1, 5, 33, 64, 100, 111, 160, 300],
                                          np.int32), device=dev)
    bt8_odd = bt8[:, :5].contiguous()
    err_edge = agree(f"paged_decode_attention_int8 {tag} (odd nblk)",
                     K8(q, *pools8[0], bt8_odd, len_odd8),
                     P8F(q, *pools8[0], bt8_odd,
                         torch.clamp(len_odd8, max=5 * page8)),
                     key("paged_decode_attention_int8"),
                     paged_decode_fp64(torch, q, k8, v8, bt8_odd,
                                       torch.clamp(len_odd8, max=5 * page8),
                                       ks, vs))
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
        "candidates": candidate_rows(
            torch, "paged_decode_attention_int8",
            lambda p, c: K8(q, *p, bt8, length, c), want8, agree, tag,
            key("paged_decode_attention_int8"), pools8, exact=exact8),
        "reference_rounding": agree.reference_rounding - rounded0,
        **timed(torch, [lambda p=p: K8(q, *p, bt8, length) for p in pools8],
                [lambda p=p: P8F(q, *p, bt8, length) for p in pools8],
                [lambda dv=dv: F.scaled_dot_product_attention(
                    qs, dv[0], dv[1], attn_mask=mask8) for dv in dq_views])}]
    return dec, pre, int8


# the generator of gqa_decode_rows' inputs: its own, so that adding its
# rows moved no other row's inputs
GQA_SEED = 21


def gqa_decode_rows(torch, K, F, t, agree, dev):
    """The engine's two paged decode kernels (bf16 pages of 16 rows, int8
    pages of 32 with bf16 scale pages) at grouped-query heads: 8 slots,
    cache_len 1024, hd 128, at glm4-9b's heads (32 on 2 KV heads, G = 16)
    and qwen3-14b's (40 on 8, G = 5), each at every ``decode_warps`` of
    its tuner space; SDPA with ``enable_gqa`` over the gathered view (for
    int8 the dequantized one) beside each."""
    import numpy as np

    from repro_torch.quant.tensor import quantize_kv
    rng = np.random.default_rng(GQA_SEED)
    slots, hd, S = 8, 128, 1024
    lens = rng.integers(64, 449, slots).astype(np.int32)
    length = torch.as_tensor(lens, device=dev)
    rows_read = int(lens.sum())
    mask = (torch.arange(S, device=dev)[None, None, None, :]
            < length[:, None, None, None])
    out = {"paged_decode_attention": [], "paged_decode_attention_int8": []}
    for label, H, KV in (("glm4-9b", 32, 2), ("qwen3-14b", 40, 8)):
        q = t(rng.standard_normal((slots, H, hd)))
        qs = q[:, :, None]
        for name, page in (("paged_decode_attention", 16),
                           ("paged_decode_attention_int8", 32)):
            int8 = page == 32
            nblk = S // page
            P = slots * nblk + 1
            pools = []
            for _ in range(copies_for(2 * P * page * KV * (hd + 2 * int8)
                                      * (1 if int8 else 2), cap=4)):
                kv = [t(rng.standard_normal((P, page, KV, hd)))
                      for _ in range(2)]
                pools.append(tuple(kv) if not int8 else
                             (*quantize_kv(kv[0]), *quantize_kv(kv[1])))
            bt = torch.as_tensor((rng.permutation(P - 1)[:slots * nblk] + 1)
                                 .reshape(slots, nblk).astype(np.int32),
                                 device=dev)
            fn, plain = getattr(K, name), K.PLAIN[name]
            key = f"{name} hd=128"
            want = plain(q, *pools[0], bt, length)
            p0 = pools[0]
            exact = paged_decode_fp64(
                torch, q, p0[0], p0[-2 if int8 else 1], bt, length,
                *((p0[1], p0[3]) if int8 else ()))
            rounded0 = agree.reference_rounding
            err = agree(f"{name} {label} heads", fn(q, *pools[0], bt, length),
                        want, key, exact)
            ix = bt.long()
            views = []
            for p in pools:
                kv = ((p[0][ix], p[1][ix]) if not int8 else
                      tuple((c[ix].float() * sc[ix].float()).to(
                          torch.bfloat16) for c, sc in (p[:2], p[2:])))
                views.append(tuple(a.reshape(slots, S, KV, hd).transpose(1, 2)
                                   .contiguous() for a in kv))
            row_bytes = KV * (hd + 2) * 2 if int8 else KV * hd * 4
            bms, by = bound_ms(rows_read * row_bytes + slots * H * hd * 4
                               + slots * nblk * 4, 4 * H * hd * rows_read)
            out[name].append({
                "shape": f"{label} heads: q ({slots}, {H}, {hd}) bf16, "
                         + ("int8 pools + bf16 scale pages" if int8 else
                            "bf16 pools")
                         + f" ({P}, {page}, {KV}, {hd}), bt ({slots}, {nblk})"
                         f", length {lens.tolist()}",
                "max_abs_err": err, "bound_ms": bms, "bound_by": by,
                "tolerance": TOL[key],
                "library": "SDPA (length mask, enable_gqa) on the "
                           + ("pre-dequantized bf16 " if int8 else "")
                           + "dense view",
                "candidates": candidate_rows(
                    torch, name,
                    lambda p, c: fn(q, *p, bt, length, c), want, agree,
                    f"{label} heads", key, pools, exact=exact),
                "reference_rounding": agree.reference_rounding - rounded0,
                **timed(torch,
                        [lambda p=p: fn(q, *p, bt, length) for p in pools],
                        [lambda p=p: plain(q, *p, bt, length) for p in pools],
                        [lambda v=v: F.scaled_dot_product_attention(
                            qs, v[0], v[1], attn_mask=mask, enable_gqa=True)
                         for v in views])})
            del pools, views
        torch.cuda.empty_cache()
    return out


def gemv_row(torch, K, F, agree, key, ws, x, experts=None):
    """One gemv row: ``ws`` weight copies, or one stack ``ws[0]`` with the
    ``experts`` (host ids) to rotate over, each read cold from device
    memory; a stack's kernel takes each id as a one-element device
    tensor, as the routed MoE path does.  Every ``gemv_warps`` of the
    tuner's space follows (gate, same bits twice, device µs; F.linear is
    the row's library time)."""
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
    cands = candidate_rows(
        torch, "gemv", lambda p, c: K.gemv(p[0], x, p[1], c),
        K.PLAIN["gemv"](w_, x, e_), agree, f"{N}x{Kd}", key, pick)
    return {"shape": (f"w ({N}, {Kd}) {what}, x ({Kd},) {what}"
                      + ("" if experts is None else
                         f", one of {ws[0].shape[0]} experts by a device id")),
            "max_abs_err": max([err] + [c["max_abs_err"] for c in cands]),
            "bound_ms": bms, "bound_by": by, "tolerance": TOL[key],
            "library": "F.linear", "candidates": cands,
            **timed(torch, fns, plain, lib)}


def adamw_rows(torch, K, dev, gen):
    """The fused AdamW at qwen1.5-0.5b's training leaves, fp32 masters: the
    embedding (one tensor), the stacked MLP and q weights and the stacked
    biases (24 tensors each, one launch).  The kernel against its plain
    version on the same inputs, streams 1 and 2, and bf16 masters at the
    q shape; the yardstick is one ``torch._fused_adamw_`` call on the same
    tensors (decoupled decay p (1 - lr wd) and sqrt(v) / sqrt(bc2) + eps:
    the same function up to rounding)."""
    from repro_torch.core.troop import LaunchConfig
    lr, b1, b2, eps, wd, t = 1e-3, 0.9, 0.95, 1e-8, 0.1, 3
    hyper = torch.tensor([lr, b1, b2, eps, wd, 1 - b1 ** t, 1 - b2 ** t],
                         dtype=torch.float32, device=dev)

    def leaf(sizes, dtype=torch.float32):
        def rnd(n, scale):
            return torch.randn(n, device=dev, generator=gen) * scale
        return ([rnd(n, 1.0).to(dtype) for n in sizes],
                [rnd(n, 0.1).to(dtype) for n in sizes],
                [rnd(n, 0.01) for n in sizes],
                [torch.rand(n, device=dev, generator=gen) * 1e-4
                 for n in sizes])

    def agree(name, args, key, cfg=LaunchConfig()):
        """Kernel and plain version on copies of ``args``: p', mu', nu'."""
        ps, gs, mus, nus = args
        got = [[a.clone() for a in xs] for xs in (ps, mus, nus)]
        want = [[a.clone() for a in xs] for xs in (ps, mus, nus)]
        K.fused_adamw(got[0], gs, got[1], got[2], hyper, cfg=cfg)
        K.PLAIN["fused_adamw"](want[0], gs, want[1], want[2], hyper)
        tol, err = TOL[key], 0.0
        for xs, ys in zip(got, want):
            for a, b in zip(xs, ys):
                a, b = a.float(), b.float()
                err = max(err, (a - b).abs().max().item())
                if not torch.allclose(a, b, rtol=tol, atol=tol) or \
                        not torch.isfinite(a).all():
                    raise AssertionError(
                        f"{name}: kernel disagrees with its plain version, "
                        f"max_abs_err {err}")
        return err

    rows = []
    for what, sizes in (("embedding (151936 x 1024)", [151936 * 1024]),
                        ("stacked MLP 24 x (2816 x 1024)", [2816 * 1024] * 24),
                        ("stacked q 24 x (1024 x 1024)", [1024 * 1024] * 24),
                        ("stacked biases 24 x 1024", [1024] * 24)):
        args = leaf(sizes)
        n = sum(sizes)
        err = agree(f"fused_adamw {what}", args, "fused_adamw")
        err2 = agree(f"fused_adamw {what} streams=2", args, "fused_adamw",
                     LaunchConfig(adamw_streams=2))
        bms, by = bound_ms(28 * n, 12 * n, F32_OPS_PER_S)
        ps, gs, mus, nus = args
        steps = [torch.full((), float(t), device=dev) for _ in ps]
        light = dict(reps=10, inner=5) if n > 1e7 else {}
        row = {"shape": f"{what}: p, g, mu, nu fp32 ({n:,} elements, "
                        f"{len(sizes)} tensor{'s' * (len(sizes) > 1)})",
               "max_abs_err": max(err, err2), "bound_ms": bms,
               "bound_by": by, "tolerance": TOL["fused_adamw"],
               "library": "torch._fused_adamw_",
               **timed(torch, [lambda: K.fused_adamw(*args, hyper)],
                       [lambda: K.PLAIN["fused_adamw"](*args, hyper)],
                       [lambda: torch._fused_adamw_(
                           ps, gs, mus, nus, [], steps, lr=lr, beta1=b1,
                           beta2=b2, weight_decay=wd, eps=eps,
                           amsgrad=False, maximize=False)], **light)}
        row["streams2_ms"] = time_ms(torch, [lambda: K.fused_adamw(
            *args, hyper, cfg=LaunchConfig(adamw_streams=2))], **light)[0]
        if len(sizes) == 24 and sizes[0] == 1024 * 1024:
            row["bf16_max_abs_err"] = agree(
                f"fused_adamw {what} bf16 masters",
                leaf(sizes, torch.bfloat16), "fused_adamw bf16")
        rows.append(row)
        del args, ps, gs, mus, nus
        torch.cuda.empty_cache()
    return rows


def kernels_phase(torch, K, dev, rng):
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.quant.tensor import quantize_mx

    def t(a, dtype=torch.bfloat16):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    def agree(name, got, want, key=None, exact=None):
        """The kernel's output against its plain version at the gate
        ``key``; ``exact`` (bf16 outputs only): the float64 value of the
        function, which decides outputs where the plain version rounds to
        the other bf16 neighbour (``REF_ROUND_DIV``)."""
        tol = TOL[key or name.split()[0]]
        err = (got.float() - want.float()).abs().max().item()
        bad = ~torch.isclose(got.float(), want.float(), rtol=tol, atol=tol)
        if exact is not None and bad.any():
            bits = got.view(torch.int16).int() - want.view(torch.int16).int()
            nearer = ((got.double() - exact).abs()
                      < (want.double() - exact).abs())
            ref = bad & (bits.abs() == 1) & (got.float() * want.float() > 0) \
                & nearer
            n = int(ref.sum())
            if n <= 1 + got.numel() // REF_ROUND_DIV:
                for i in ref.nonzero().tolist()[:4]:
                    i = tuple(i)
                    log(f"  {name}: output {list(i)} plain {want[i].item()} "
                        f"kernel {got[i].item()} float64 "
                        f"{exact[i].item():.12f} (the plain version rounds "
                        f"the other way)")
                agree.reference_rounding += n
                bad &= ~ref
        if bad.any() or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version, max_abs_err {err}")
        return err
    agree.reference_rounding = 0

    rows = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(
            dtype)

    def twice(name, call):
        """``call()``'s output, which a second launch on the same inputs
        must repeat bit for bit."""
        got = call()
        if not torch.equal(got, call()):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 f"differ")
        return got

    # rmsnorm at the row counts of the paths: decode (slots = 8), chunk slab
    # (32), one slot (1); d = 1024 (qwen1.5-0.5b) and 2048 (qwen2-moe)
    from repro_torch.core.troop import LaunchConfig
    from repro_torch.kernels.rmsnorm import rmsnorm_plan
    rms = []
    for T, d in ((8, 1024), (32, 1024), (1, 1024), (8, 2048), (1, 2048)):
        x = t(rng.standard_normal((T, d)))
        s = t(1 + 0.1 * rng.standard_normal(d), torch.float32)
        name = f"rmsnorm T={T} d={d}"
        err = agree(name, twice(name, lambda: K.rmsnorm(x, s)),
                    K.PLAIN["rmsnorm"](x, s))
        s16 = s.to(torch.bfloat16)
        bms, by = bound_ms(2 * T * d * 2 + d * 4, 4 * T * d)
        plan = rmsnorm_plan(T, d, LaunchConfig().rmsnorm_threads)
        rms.append({
            "shape": f"x ({T}, {d}) bf16, scale ({d},) f32",
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            "tolerance": TOL["rmsnorm"],
            "plan": f"{plan.wpr} warp(s) a row, {plan.vpl} vectors a lane, "
                    f"{plan.rows} rows a block, {plan.blocks} blocks",
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
    for name, rs in gqa_decode_rows(torch, K, F, t, agree, dev).items():
        rows[name].extend(rs)

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

    from repro_torch.kernels.mx_gemv import (grouped_plan, qgemv_plan,
                                             swiglu_plan)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
            "plan": qgemv_plan(N, Kd, 4 if elem == "fp4" else 8,
                               sms)._asdict(),
            **timed(torch, [lambda w=w: K.mx_qgemv(*w, x) for w in ws],
                    [lambda w=w: K.PLAIN["mx_qgemv"](*w, x) for w in ws])})
        del ws
    rows["mx_qgemv"] = mx

    swi = []
    for N, Kd in ((2816, 1024), (5632, 2048)):     # gate + up of the MLPs
        gs, us = mx_weights(Kd, N, "fp4"), mx_weights(Kd, N, "fp4")
        x = t(rng.standard_normal(Kd))
        name = f"mx_qgemv_swiglu {N}x{Kd}"
        err = agree(name, twice(name, lambda: K.mx_qgemv_swiglu(
                        *gs[0], *us[0], x)),
                    K.PLAIN["mx_qgemv_swiglu"](*gs[0], *us[0], x))
        wg8, sg8 = mx_weights(Kd, N, "fp8")[0]
        wu8, su8 = mx_weights(Kd, N, "fp8")[0]
        name8 = f"mx_qgemv_swiglu fp8 {N}x{Kd}"
        err8 = agree(name8, twice(name8, lambda: K.mx_qgemv_swiglu(
                         wg8, sg8, wu8, su8, x)),
                     K.PLAIN["mx_qgemv_swiglu"](wg8, sg8, wu8, su8, x))
        bms, by = bound_ms(2 * (N * Kd // 2 + N * Kd // 32) + Kd * 2 + N * 4,
                           4 * N * Kd)
        ref = gemv_ms.get(f"w ({N}, {Kd})")
        swi.append({
            "shape": f"fp4 gate + up W ({Kd}, {N}) + E8M0, x ({Kd},) bf16",
            "max_abs_err": max(err, err8), "bound_ms": bms, "bound_by": by,
            "tolerance": TOL["mx_qgemv_swiglu"], "library": None,
            "bf16_gemv_ms": None if ref is None else 2 * ref,
            "plan": swiglu_plan(N, Kd, 4, sms)._asdict(),
            "plan_fp8": swiglu_plan(N, Kd, 8, sms)._asdict(),
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
                        twice(f"grouped_expert_qgemv {elem} {N}x{Kd}{tail}",
                              lambda ids=ids: K.grouped_expert_qgemv(
                                  wq, sc, xs, ids)),
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
            "plan": grouped_plan(N, Kd, 4 if elem == "fp4" else 8, sms,
                                 TOPK)._asdict(),
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
    rows["fused_adamw"] = adamw_rows(torch, K, dev, gen)
    rows.update(paper_rows(torch, K, F, agree, dev, randn))
    rows.update(int_rows(torch, K, F, agree, dev, gen, rows))
    rows.update(scan_rows(torch, K, F, agree, dev, gen))
    torch.cuda.synchronize()
    return rows


def sdpa_decode(torch, F, q, k, v, mask):
    """The library yardstick of dense decode attention: one
    ``scaled_dot_product_attention`` call on q (B,H,1,hd) and the cache's
    (B,KV,S,hd) views, GQA inside the call, the length as a boolean
    mask."""
    return F.scaled_dot_product_attention(
        q, k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=q.shape[1] != k.shape[2])


def paper_rows(torch, K, F, agree, dev, randn):
    """The kernels of the tuner's slice at their shapes: dotp and axpy at
    the registry's full size (2^20 bf16) and past the L2 (2^27 bf16, 256 MB
    an operand), each from its default config, axpy also at every
    candidate of its tuner space; the batched gemv at
    (2048, 4096) for 1, 2, 4, 8 and 16 rows and at qwen1.5-0.5b's read-out
    (151936, 1024) for 8 and 16 (the yardsticks of batched_qgemv's rows);
    the dense decode attention at kernel_bench's
    (B=4, H=16, KV=8, hd=128, S=4096), qwen1.5-0.5b's 8 slots (H = KV =
    16, hd=64, S=1024) and glm4-9b's heads (B=4, H=32, KV=2, hd=128,
    S=4096), each at every candidate of its tuner space."""
    rows = {"dotp": [], "axpy": [], "batched_gemv": [],
            "decode_attention": []}
    for n in (1 << 20, 1 << 27):
        pairs = [(randn(n), randn(n)) for _ in range(copies_for(4 * n))]
        x, y = pairs[0]
        got, want = K.dotp(x, y), K.PLAIN["dotp"](x, y)
        bound = TOL["dotp"] * (x.float() * y.float()).abs().sum().item()
        err = abs(got.item() - want.item())
        again = K.dotp(x, y)
        if err > bound or not math.isfinite(got.item()) \
                or not torch.equal(got, again):
            raise AssertionError(f"dotp n={n}: kernel disagrees with its "
                                 f"plain version ({err} > {bound}) or with "
                                 f"itself ({got.item()} vs {again.item()})")
        bms, by = bound_ms(4 * n + 4, 2 * n)
        rows["dotp"].append({
            "shape": f"x, y ({n},) bf16", "max_abs_err": err,
            "tolerance": bound, "bound_ms": bms, "bound_by": by,
            "library": "torch.dot",
            **timed(torch, [lambda p=p: K.dotp(*p) for p in pairs],
                    [lambda p=p: K.PLAIN["dotp"](*p) for p in pairs],
                    [lambda p=p: torch.dot(*p) for p in pairs])})
        want = K.PLAIN["axpy"](1.5, x, y)
        err = agree(f"axpy n={n}", K.axpy(1.5, x, y), want)
        cands = candidate_rows(
            torch, "axpy", lambda p, c: K.axpy(1.5, *p, cfg=c), want, agree,
            f"n={n}", "axpy", pairs)
        del want
        bms, by = bound_ms(6 * n, 2 * n)
        rows["axpy"].append({
            "shape": f"a fp32, x, y ({n},) bf16 -> ({n},) bf16",
            "max_abs_err": max([err] + [c["max_abs_err"] for c in cands]),
            "tolerance": TOL["axpy"], "bound_ms": bms, "candidates": cands,
            "bound_by": by, "library": "torch.add(y, x, alpha=a)",
            **timed(torch, [lambda p=p: K.axpy(1.5, *p) for p in pairs],
                    [lambda p=p: K.PLAIN["axpy"](1.5, *p) for p in pairs],
                    [lambda p=p: torch.add(p[1], p[0], alpha=1.5)
                     for p in pairs])})
        del pairs, x, y
        torch.cuda.empty_cache()

    for (N, Kd), B in (((2048, 4096), 1), ((2048, 4096), 2),
                       ((2048, 4096), 4), ((2048, 4096), 8),
                       ((2048, 4096), 16), ((151936, 1024), 8),
                       ((151936, 1024), 16)):
        ws = [randn(N, Kd, scale=Kd ** -0.5)
              for _ in range(copies_for(N * Kd * 2))]
        xs = randn(B, Kd)
        err = agree(f"batched_gemv B={B} {N}x{Kd}", K.batched_gemv(ws[0], xs),
                    K.PLAIN["batched_gemv"](ws[0], xs))
        bms, by = bound_ms(2 * N * Kd + 2 * B * Kd + 4 * B * N, 2 * B * N * Kd)
        rows["batched_gemv"].append({
            "shape": f"w ({N}, {Kd}) bf16, xs ({B}, {Kd}) bf16",
            "max_abs_err": err, "tolerance": TOL["batched_gemv"],
            "bound_ms": bms, "bound_by": by, "library": "F.linear",
            **timed(torch, [lambda w=w: K.batched_gemv(w, xs) for w in ws],
                    [lambda w=w: K.PLAIN["batched_gemv"](w, xs) for w in ws],
                    [lambda w=w: F.linear(xs, w) for w in ws])})
        del ws
        torch.cuda.empty_cache()

    for B, H, KV, hd, S in ((4, 16, 8, 128, 4096), (8, 16, 16, 64, 1024),
                            (4, 32, 2, 128, 4096)):
        caches = [(randn(B, S, KV, hd), randn(B, S, KV, hd))
                  for _ in range(copies_for(4 * B * S * KV * hd))]
        q = randn(B, H, hd)
        length = torch.full((B,), S, dtype=torch.int32, device=dev)
        k, v = caches[0]
        label = f"B={B} H={H} KV={KV} hd={hd} S={S}"
        err = agree(f"decode_attention {label}",
                    K.decode_attention(q, k, v, length),
                    K.PLAIN["decode_attention"](q, k, v, length))
        cands = candidate_rows(
            torch, "decode_attention",
            lambda c_, cfg: K.decode_attention(q, *c_, length, cfg),
            K.PLAIN["decode_attention"](q, k, v, length), agree, label,
            "decode_attention", caches)
        q4 = q[:, :, None]
        mask = (torch.arange(S, device=dev)[None, :]
                < length[:, None])[:, None, None]          # (B, 1, 1, S)
        bms, by = bound_ms(4 * B * S * KV * hd + 4 * B * H * hd,
                           4 * B * H * S * hd)
        rows["decode_attention"].append({
            "shape": f"q ({B}, {H}, {hd}), k/v ({B}, {S}, {KV}, {hd}) bf16, "
                     f"full length",
            "max_abs_err": max([err] + [c["max_abs_err"] for c in cands]),
            "tolerance": TOL["decode_attention"],
            "bound_ms": bms, "bound_by": by,
            "library": "scaled_dot_product_attention (length mask, "
                       "enable_gqa)", "candidates": cands,
            **timed(torch,
                    [lambda c=c: K.decode_attention(q, *c, length)
                     for c in caches],
                    [lambda c=c: K.PLAIN["decode_attention"](q, *c, length)
                     for c in caches],
                    [lambda c=c: sdpa_decode(torch, F, q4, *c, mask)
                     for c in caches])})
        del caches, k, v
        torch.cuda.empty_cache()
    return rows


# the int GEMVs' rows: ((N, K), bits, rows of x (0: the one-row qgemv),
# codes a scale group).  Groups of 128 hold whole k-steps of the tile walk;
# int4 groups of 64 and int8 groups of 32 are narrower than a k-step, so
# those rows run the SIMT walk, one row of x and eight.
INT_ROWS = (((151936, 1024), 8, 0, 128), ((151936, 1024), 4, 0, 128),
            ((2048, 4096), 8, 0, 128), ((2048, 4096), 4, 0, 128),
            ((151936, 1024), 8, 8, 128), ((151936, 1024), 4, 8, 128),
            ((151936, 1024), 8, 16, 128), ((2048, 4096), 8, 4, 128),
            ((151936, 1024), 4, 0, 64), ((151936, 1024), 8, 0, 32),
            ((151936, 1024), 4, 8, 64), ((151936, 1024), 8, 8, 32))


def int_rows(torch, K, F, agree, dev, gen, rows):
    """The kernels of the int slice at their shapes: ``qgemv`` (int8 and
    int4) at the qwen1.5-0.5b read-out (151936, 1024) and at the registry's
    (2048, 4096), the shapes the tune phase tunes; ``batched_qgemv`` at the
    read-out for 8 rows (int8 and int4) and 16 (int8, two n-tiles of the
    tile walk) and the registry's (2048, 4096) for 4, all with groups of
    128 (the tile walk); both at the read-out, one row and eight, with
    groups narrower than a k-step (int4 64, int8 32: the SIMT walk);
    each with its launch plan and route, every row giving the same bits
    twice (``INT_ROWS``); ``batched_mx_qgemv`` at the read-out (1024 ->
    151936) for 8 rows (fp4 and fp8) and 16 (fp4, two n-tiles) and at the
    registry's (4096 -> 2048) for 4, each with its plan, the same bits
    twice;
    ``decode_attention_int8`` at the qwen1.5-0.5b engine's
    dense shape (8 slots x 1024 x 16 KV heads x 64), the registry's (B=4,
    H=16, KV=8, hd=128, S=4096) and glm4-9b's heads (B=4, H=32, KV=2,
    hd=128, S=4096), full length, each at every candidate of its tuner
    space.  Weights are fan-in scaled (outputs of order 1), groups along K
    as ``INT_ROWS`` says.  No PyTorch call takes int8/int4 codes with
    absmax groups or E8M0 blocks: the GEMV
    rows give the bf16 gemv / batched gemv of the same shape instead
    (``rows``); the int8 decode's yardstick is SDPA on the dequantized
    view with a length mask."""
    from repro_torch.quant.tensor import quantize, quantize_kv, quantize_mx
    out = {"qgemv": [], "batched_qgemv": [], "batched_mx_qgemv": [],
           "decode_attention_int8": []}
    gemv_ms = {r["shape"].split(" bf16")[0]: r["ms"] for r in rows["gemv"]
               if "experts" not in r["shape"]}
    bgemv_ms = {r["shape"]: r["ms"] for r in rows["batched_gemv"]}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    from repro_torch.core.troop import LaunchConfig
    from repro_torch.kernels.qgemv import batched_qgemv_plan, walk_blocks
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (N, Kd), bits, B, gs in INT_ROWS:
        code_bytes = N * Kd * bits // 8
        ws = []
        for _ in range(copies_for(code_bytes)):
            qt = quantize(randn(N, Kd, scale=Kd ** -0.5), bits=bits,
                          group_size=gs, axis=-1)
            ws.append((qt.values, qt.scales))
        name = "batched_qgemv" if B else "qgemv"
        x = randn(B, Kd).bfloat16() if B else randn(Kd).bfloat16()
        fn, plain = getattr(K, name), K.PLAIN[name]
        label = f"{name} int{bits} B={B} {N}x{Kd} groups of {gs}"
        got = fn(*ws[0], x, bits=bits)
        if not torch.equal(got, fn(*ws[0], x, bits=bits)):
            raise AssertionError(f"{label}: two launches on the same inputs "
                                 f"differ")
        err = agree(label, got, plain(*ws[0], x, bits=bits))
        plan = batched_qgemv_plan(N, Kd, Kd // gs, max(B, 1), bits,
                                  LaunchConfig(), sms)
        rows_ = max(B, 1)
        bms, by = bound_ms(code_bytes + N * (Kd // gs) * 4
                           + rows_ * Kd * 2 + rows_ * N * 4,
                           2 * rows_ * N * Kd)
        ref = (bgemv_ms.get(f"w ({N}, {Kd}) bf16, xs ({B}, {Kd}) bf16") if B
               else gemv_ms.get(f"w ({N}, {Kd})"))
        out[name].append({
            "shape": f"int{bits} codes of W ({N}, {Kd}) + fp32 scales ({N}, "
                     f"{Kd // gs}), x ({f'{B}, ' if B else ''}{Kd},) bf16",
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            "tolerance": TOL[name], "library": None, "bf16_gemv_ms": ref,
            "route": plan.route,
            "plan": (f"tile walk: {plan.warps} warps, {plan.steps} k-steps "
                     f"a round, ksplit {plan.ksplit}, {plan.blocks} blocks"
                     if plan.route == "tile" else
                     "SIMT walk: {} warps, {} W rows a warp, {} blocks"
                     .format(*walk_blocks(N, Kd, rows_, LaunchConfig(),
                                          sms))),
            **timed(torch, [lambda w=w: fn(*w, x, bits=bits) for w in ws],
                    [lambda w=w: plain(*w, x, bits=bits) for w in ws])})
        del ws
        torch.cuda.empty_cache()

    from repro_torch.kernels.mx_gemv import batched_plan
    for (N, Kd), elem, B in (((151936, 1024), "fp4", 8),
                             ((151936, 1024), "fp8", 8),
                             ((151936, 1024), "fp4", 16),
                             ((2048, 4096), "fp4", 4)):
        bits = 4 if elem == "fp4" else 8
        n = copies_for(Kd * N * bits // 8)
        ws = []
        for _ in range(n):
            qt = quantize_mx(randn(Kd, N, scale=Kd ** -0.5), elem=elem)
            ws.append((qt.values, qt.scales))
        xs = randn(B, Kd).bfloat16()
        fn, plain = K.batched_mx_qgemv, K.PLAIN["batched_mx_qgemv"]
        label = f"batched_mx_qgemv {elem} B={B} {Kd}->{N}"
        got = fn(*ws[0], xs)
        if not torch.equal(got, fn(*ws[0], xs)):
            raise AssertionError(f"{label}: two launches on the same inputs "
                                 f"differ")
        err = agree(label, got, plain(*ws[0], xs))
        plan = batched_plan(N, Kd, bits, B, LaunchConfig(), sms)
        bms, by = bound_ms(Kd * N * bits // 8 + Kd * N // 32 + B * Kd * 2
                           + B * N * 4, 2 * B * N * Kd)
        out["batched_mx_qgemv"].append({
            "shape": f"{elem} codes of W ({Kd}, {N}) + E8M0 ({Kd // 32}, "
                     f"{N}), xs ({B}, {Kd}) bf16",
            "max_abs_err": err, "bound_ms": bms, "bound_by": by,
            "tolerance": TOL["batched_mx_qgemv"], "library": None,
            "plan": (f"tile walk: {plan.cols} columns a lane, {plan.warps} "
                     f"warps, ksplit {plan.ksplit}, {plan.round_blocks} "
                     f"E8M0 blocks a round, {plan.blocks} blocks"),
            "bf16_gemv_ms": bgemv_ms.get(f"w ({N}, {Kd}) bf16, xs ({B}, "
                                         f"{Kd}) bf16"),
            **timed(torch, [lambda w=w: fn(*w, xs) for w in ws],
                    [lambda w=w: plain(*w, xs) for w in ws])})
        del ws
        torch.cuda.empty_cache()

    for B, H, KV, hd, S in ((8, 16, 16, 64, 1024), (4, 16, 8, 128, 4096),
                            (4, 32, 2, 128, 4096)):
        caches = []
        for _ in range(copies_for(2 * B * S * KV * (hd + 2))):
            k8, ks = quantize_kv(randn(B, S, KV, hd).bfloat16())
            v8, vs = quantize_kv(randn(B, S, KV, hd).bfloat16())
            caches.append((k8, ks, v8, vs))
        q = randn(B, H, hd).bfloat16()
        length = torch.full((B,), S, dtype=torch.int32, device=dev)
        fn, plain = K.decode_attention_int8, K.PLAIN["decode_attention_int8"]
        label = f"B={B} H={H} KV={KV} hd={hd} S={S}"
        want = plain(q, *caches[0], length)
        err = agree(f"decode_attention_int8 {label}",
                    fn(q, *caches[0], length), want)
        cands = candidate_rows(
            torch, "decode_attention_int8",
            lambda c_, cfg: fn(q, *c_, length, cfg), want, agree, label,
            "decode_attention_int8", caches)
        dq = [((k8.float() * ks.float()).bfloat16(),
               (v8.float() * vs.float()).bfloat16())
              for k8, ks, v8, vs in caches]
        q4 = q[:, :, None]
        mask = (torch.arange(S, device=dev)[None, :]
                < length[:, None])[:, None, None]
        bms, by = bound_ms(2 * B * S * KV * (hd + 2) + 4 * B * H * hd,
                           4 * B * H * S * hd)
        out["decode_attention_int8"].append({
            "shape": f"q ({B}, {H}, {hd}) bf16, int8 k/v ({B}, {S}, {KV}, "
                     f"{hd}) + bf16 scales, full length",
            "max_abs_err": max([err] + [c["max_abs_err"] for c in cands]),
            "bound_ms": bms, "bound_by": by,
            "tolerance": TOL["decode_attention_int8"],
            "library": "SDPA on the dequantized bf16 view (length mask, "
                       "enable_gqa)", "candidates": cands,
            **timed(torch, [lambda c=c: fn(q, *c, length) for c in caches],
                    [lambda c=c: plain(q, *c, length) for c in caches],
                    [lambda d=d: sdpa_decode(torch, F, q4, *d, mask)
                     for d in dq])})
        del caches, dq
        torch.cuda.empty_cache()
    return out


# the plain versions of the two scans are T-step Python loops (and the
# plain attention materializes every score): each new row times its plain
# version over PLAIN_REPS windows of one call, and each candidate of a
# tuner space over CANDIDATE_REPS windows of CANDIDATE_INNER calls
PLAIN_REPS = 3
CANDIDATE_REPS, CANDIDATE_INNER = 5, 5


def scan_rows(torch, K, F, agree, dev, gen):
    """The full-sequence attention and the two scans, each at its
    registry's full-size example and at the widths of an architecture the
    JAX package built it for, held against its plain version at every
    candidate of its tuner space and timed at each candidate and at the
    default: ``flash_attention`` at the registry's (2, 512, 8, 2, 64, 512)
    fp32, qwen1.5-0.5b's attention (B = 1, T = S = 2048, 16 heads of 64,
    bf16) and glm4-9b's GQA (32 query heads on 2 KV heads of 128, T = S =
    2048, bf16), all causal, against SDPA (``is_causal``,
    ``enable_gqa``; its own error against the plain version beside the
    kernel's); ``wkv6`` at the registry's (1, 256, 4, 64) and
    rwkv6-3b's time mix (B = 1, T = 2048, 40 heads of 64, fp32, w =
    exp(-exp(N(0, 1))), u = 0.5 as the model's init) from a zero and from
    a nonzero state; ``mamba_scan`` at the registry's (2, 512, 512, 16) and
    jamba's Mamba layer (b = 1, T = 2048, d_inner 2 x 4096, d_state 16,
    fp32) from a zero and from a nonzero state; each scan row with the
    default's launch plan (``wkv6_plan``, ``mamba_plan``).  No PyTorch
    call computes either scan.  A causal row's bound counts the unmasked
    scores; the registry's cost model, which counts all T x S, gives
    ``registry_bound_ms`` beside it."""
    from repro_torch import tune
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.mamba_scan import mamba_plan
    from repro_torch.kernels.rwkv6 import wkv6_plan
    from repro_torch.tune.search import enumerate_space
    rows = {"flash_attention": [], "rwkv6": [], "mamba_scan": []}
    sms = sm_count(dev)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def agree_all(label, got, want, key):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return max(agree(label, g, w, key) for g, w in zip(got, want))

    def row(name, label, sets, kw, key, shape, nbytes, ops, rate,
            lib_fns=None, **extra):
        """Every candidate against the plain version, then the timings
        (and, where a PyTorch call computes the function, that call's own
        error against the plain version, recorded only)."""
        spec = tune.REGISTRY[name]
        fn, plain = spec.fn, K.PLAIN[name]
        want = plain(*sets[0], **kw)
        if lib_fns is not None:
            extra["library_max_abs_err"] = (
                lib_fns[0]().float() - want.float()).abs().max().item()
        cands = []
        for cfg in enumerate_space(spec):
            knobs = {k: getattr(cfg, k) for k in spec.space}
            err = agree_all(f"{name} {label} {knobs}",
                            fn(*sets[0], cfg=cfg, **kw), want, key)
            ms = time_ms(torch, [lambda s=s, c=cfg: fn(*s, cfg=c, **kw)
                                 for s in sets], reps=CANDIDATE_REPS,
                         inner=CANDIDATE_INNER)[0]
            cands.append({"knobs": knobs, "max_abs_err": err, "ms": ms})
        bms, by = bound_ms(nbytes, ops, rate)
        rows[name].append({
            "shape": shape, "max_abs_err": max(c["max_abs_err"]
                                               for c in cands),
            "tolerance": TOL[key], "bound_ms": bms, "bound_by": by,
            "candidates": cands, **extra,
            **timed(torch, [lambda s=s: fn(*s, cfg=spec.default, **kw)
                            for s in sets],
                    [lambda s=s: plain(*s, **kw) for s in sets],
                    lib_fns, plain_kw={"reps": PLAIN_REPS, "inner": 1})})

    for label, B, T, H, KV, hd, dtype in (
            ("registry example", 2, 512, 8, 2, 64, torch.float32),
            ("qwen1.5-0.5b", 1, 2048, 16, 16, 64, torch.bfloat16),
            ("glm4-9b", 1, 2048, 32, 2, 128, torch.bfloat16)):
        S, item = T, torch.empty((), dtype=dtype).element_size()
        nbytes = (2 * B * T * H * hd + 2 * B * S * KV * hd) * item
        sets = [(randn(B, T, H, hd, dtype=dtype), randn(B, S, KV, hd,
                                                        dtype=dtype),
                 randn(B, S, KV, hd, dtype=dtype))
                for _ in range(copies_for(nbytes))]
        pairs = sum(min(t + 1, S) for t in range(T))     # unmasked scores
        rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
        key = "flash_attention" + ("" if dtype == torch.float32 else " bf16")
        row("flash_attention", label, sets, {"causal": True}, key,
            f"{label}: q ({B}, {T}, {H}, {hd}), k/v ({B}, {S}, {KV}, {hd}) "
            f"{str(dtype)[6:]}, causal", nbytes, 4.0 * B * H * hd * pairs,
            rate, lib_fns=[lambda s=s: F.scaled_dot_product_attention(
                s[0].transpose(1, 2), s[1].transpose(1, 2),
                s[2].transpose(1, 2), is_causal=True,
                enable_gqa=H != KV).transpose(1, 2) for s in sets],
            library="scaled_dot_product_attention (is_causal, enable_gqa)",
            registry_bound_ms=bound_ms(nbytes, 4.0 * B * T * S * H * hd,
                                       rate)[0])
        del sets
        torch.cuda.empty_cache()

    for label, state in (("registry example", False), ("rwkv6-3b", False),
                         ("rwkv6-3b", True)):
        if label == "registry example":
            args, _ = tune.REGISTRY["rwkv6"].example(small=False, device=dev)
        else:
            B, T, H, hd = 1, 2048, 40, 64
            r, k, v = (randn(B, T, H, hd) for _ in range(3))
            w = torch.exp(-torch.exp(randn(B, T, H, hd)))
            u = torch.full((H, hd), 0.5, device=dev)
            s0 = randn(B, H, hd, hd) if state else \
                torch.zeros((B, H, hd, hd), device=dev)
            args = (r, k, v, w, u, s0)
        r, u, s0 = args[0], args[4], args[5]
        n = r.numel()
        nbytes = 4 * n * r.element_size() + n * 4 + u.numel() * 4 \
            + 2 * s0.numel() * 4
        sets = [args] + [tuple(a.clone() for a in args)
                         for _ in range(copies_for(nbytes) - 1)]
        p = wkv6_plan(*r.shape[:3], r.shape[3],
                      tune.REGISTRY["rwkv6"].default.block_n // 8, sms)
        row("rwkv6", label, sets, {}, "rwkv6",
            f"{label}: r, k, v, w {tuple(r.shape)} fp32, u {tuple(u.shape)},"
            f" {'nonzero' if state else 'zero'} state {tuple(s0.shape)}",
            nbytes, 6.0 * n * r.shape[3], F32_OPS_PER_S, library=None,
            plan=(f"{p.cols} columns a block, {p.col_blocks} blocks a head, "
                  f"{p.blocks} blocks of {p.threads}, {p.smem} B shared, "
                  f"chunks of {p.chunk}, sub-chunks of {p.sub}"))
        del sets, args
        torch.cuda.empty_cache()

    for label, state in (("registry example", False), ("jamba", False),
                         ("jamba", True)):
        if label == "registry example":
            args, _ = tune.REGISTRY["mamba_scan"].example(small=False,
                                                          device=dev)
        else:
            b, T, di, ds = 1, 2048, 2 * 4096, 16
            args = (randn(b, T, di), F.softplus(randn(b, T, di)),
                    randn(b, T, ds), randn(b, T, ds),
                    -torch.exp(randn(di, ds)),
                    torch.ones((di,), device=dev),
                    randn(b, di, ds) if state
                    else torch.zeros((b, di, ds), device=dev))
        x, Bm, A, s0 = args[0], args[2], args[4], args[6]
        n = x.numel()
        nbytes = (2 * n + 2 * Bm.numel()) * x.element_size() + n * 4 \
            + (A.numel() + args[5].numel() + 2 * s0.numel()) * 4
        sets = [args] + [tuple(a.clone() for a in args)
                         for _ in range(copies_for(nbytes) - 1)]
        p = mamba_plan(*x.shape,
                       tune.REGISTRY["mamba_scan"].default.block_n // 8, sms)
        row("mamba_scan", label, sets, {}, "mamba_scan",
            f"{label}: x, dt {tuple(x.shape)}, B, C {tuple(Bm.shape)} fp32, "
            f"A {tuple(A.shape)}, {'nonzero' if state else 'zero'} state "
            f"{tuple(s0.shape)}", nbytes, 6.0 * n * A.shape[1], F32_OPS_PER_S,
            library=None,
            plan=(f"{p.lanes} lanes of {p.states} states a channel, "
                  f"{p.channels} channels a block of {p.threads}, "
                  f"{p.blocks} blocks, tiles of {p.chunk}"))
        del sets, args
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------- tune
# the qwen1.5-0.5b engine of the engine phase, whose decode-path configs
# the tune phase tunes at the engine's own shapes
TUNE_ENGINE = dict(slots=8, cache_len=1024, backend="paged",
                   chunked_prefill=True, chunk_size=32, prefix_cache=True,
                   kernel_decode=True)
# qwen1.5-0.5b's training leaves (fp32 masters), flat: the embedding, the
# stacked MLP and q weights and the stacked biases
ADAMW_LEAVES = {"embedding": 151936 * 1024, "stacked MLP": 24 * 2816 * 1024,
                "stacked q": 24 * 1024 * 1024, "stacked biases": 24 * 1024}


def tune_points(torch, tune, dev):
    """(label, kernel, args, kwargs) of every point the phase tunes: each
    registered kernel at its registry's full-size example; the
    qwen1.5-0.5b engine's decode-path kernels at the shapes its
    ``tuned_kernel_configs`` looks up; the full-sequence attention and the
    two scans at one full-width point each; the fused AdamW at the four
    training leaves."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serve.kvcache import PageSpec
    from repro_torch.tune.registry import seeded

    from repro_torch.quant.tensor import quantize, quantize_kv

    points = []
    for name in TUNE_PATH:
        if name in tune.REGISTRY:
            args, kw = tune.REGISTRY[name].example(small=False, device=dev)
            points.append((f"{name} (registry example)", name, args, kw))
    args, kw = tune.REGISTRY["qgemv"].example(small=False, device=dev, bits=4)
    points.append(("qgemv int4 (registry example)", "qgemv", args, kw))
    cfg = get_config("qwen1.5-0.5b")
    B, S = TUNE_ENGINE["slots"], TUNE_ENGINE["cache_len"]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d, V, C = cfg.d_model, cfg.vocab_size, TUNE_ENGINE["chunk_size"]
    spec = PageSpec.for_engine(B, S, 16)
    P, nblk = spec.num_pages, spec.blocks_per_slot
    pools = (seeded(1, (P, 16, KV, hd), device=dev),
             seeded(2, (P, 16, KV, hd), device=dev))
    rng = np.random.default_rng(3)
    bt = torch.as_tensor((rng.permutation(P - 1)[:B * nblk] + 1).reshape(
        B, nblk).astype(np.int32), device=dev)
    full = torch.full((B,), S, dtype=torch.int32, device=dev)
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    q = seeded(0, (B, H, hd), device=dev)
    engine = "qwen1.5-0.5b engine"
    points += [
        (f"paged_decode_attention ({engine})", "paged_decode_attention",
         (q, *pools, bt, full), {}),
        (f"prefill_attention_paged ({engine}, last slab)",
         "prefill_attention_paged",
         (seeded(4, (1, C, H, hd), device=dev), *pools, bt[:1].contiguous(),
          one * (S - C), one * S), {}),
        (f"gemv ({engine} read-out)", "gemv",
         (seeded(5, (V, d), device=dev, scale=d ** -0.5),
          seeded(6, (d,), device=dev)), {}),
        (f"rmsnorm ({engine})", "rmsnorm",
         (seeded(7, (B, d), device=dev),
          seeded(8, (d,), torch.float32, device=dev)), {}),
        (f"decode_attention ({engine}, dense)", "decode_attention",
         (q, seeded(9, (B, S, KV, hd), device=dev),
          seeded(10, (B, S, KV, hd), device=dev), full), {}),
    ]
    # the int slice's names at the keys the engine's tuned_kernel_configs
    # looks up: int8 codes of the read-out in groups of 128, and the dense
    # decode over an int8 cache
    w = next(a[0] for label, n, a, _ in points
             if n == "gemv" and "engine" in label)
    qt = quantize(w.float(), bits=8, group_size=128, axis=-1)
    k8, ks = quantize_kv(seeded(9, (B, S, KV, hd), device=dev))
    v8, vs = quantize_kv(seeded(10, (B, S, KV, hd), device=dev))
    points += [
        (f"qgemv int8 ({engine} read-out)", "qgemv",
         (qt.values, qt.scales, seeded(6, (d,), device=dev)), {}),
        (f"decode_attention_int8 ({engine}, dense)", "decode_attention_int8",
         (q, k8, ks, v8, vs, full), {}),
    ]
    del qt
    # the full-sequence attention and the scans at one full-width point
    # each: qwen1.5-0.5b's attention, rwkv6-3b's time mix, jamba's Mamba
    # layer (the kernels phase's shapes)
    f32 = torch.float32
    x = seeded(20, (1, 2048, 2 * 4096), f32, device=dev)
    points += [
        ("flash_attention (qwen1.5-0.5b attention, T = S = 2048)",
         "flash_attention",
         (seeded(12, (1, 2048, H, hd), device=dev),
          seeded(13, (1, 2048, KV, hd), device=dev),
          seeded(14, (1, 2048, KV, hd), device=dev)), {"causal": True}),
        ("rwkv6 (rwkv6-3b time mix, T = 2048)", "rwkv6",
         (*(seeded(15 + i, (1, 2048, 40, 64), f32, device=dev)
            for i in range(3)),
          torch.exp(-torch.exp(seeded(18, (1, 2048, 40, 64), f32,
                                      device=dev))),
          torch.full((40, 64), 0.5, device=dev),
          torch.zeros((1, 40, 64, 64), device=dev)), {}),
        ("mamba_scan (jamba Mamba layer, T = 2048)", "mamba_scan",
         (x, torch.nn.functional.softplus(
             seeded(24, (1, 2048, 2 * 4096), f32, device=dev)),
          seeded(21, (1, 2048, 16), f32, device=dev),
          seeded(22, (1, 2048, 16), f32, device=dev),
          -torch.exp(seeded(23, (2 * 4096, 16), f32, device=dev)),
          torch.ones((2 * 4096,), device=dev),
          torch.zeros((1, 2 * 4096, 16), device=dev)), {}),
    ]
    hyper = torch.tensor([1e-3, 0.9, 0.95, 1e-8, 0.1, 0.1, 0.1],
                         dtype=torch.float32).to(dev)
    for leaf, n in ADAMW_LEAVES.items():
        p = seeded(11, (n,), torch.float32, device=dev)
        g = seeded(12, (n,), torch.float32, device=dev, scale=0.1)
        points.append((f"fused_adamw ({leaf} leaf, {n:,} fp32)",
                       "fused_adamw",
                       (p, g, torch.zeros_like(p), torch.zeros_like(p)),
                       {"hyper": hyper}))
    return points


def tune_phase(torch, dev):
    """The tuner's path (``repro_torch.tune``) on a cache of its own that
    starts empty: tune every point of ``tune_points`` (enumerate -> analytic
    prune -> device time of the survivors -> cache), launch each kernel
    once through its dispatching entry point (no config: the tuned one)
    and the batched gemv through its own, then tune every point again —
    each must now come from the cache, with no timing, and the same
    winner; no fraction of the roofline may exceed MAX_FRACTION.  Then
    build the qwen1.5-0.5b paged engine on that cache and check that it
    carries the winners of its shapes.  The counts are zeroed before the
    first pass and read after the dispatches: the tuner's path."""
    import dataclasses
    import os

    import repro_torch.kernels as KD
    from repro_torch import tune
    from repro_torch.kernels import ops as K
    from repro_torch.serve import EngineConfig, build_engine

    prev = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(tmp) / "tune.json")
        try:
            cache = tune.default_cache()
            if len(cache):
                raise AssertionError("the tune phase's cache is not empty")
            points = tune_points(torch, tune, dev)
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            first = [tune.tune(name, *args, kernel_kwargs=kw, keep=4,
                               iters=3, cache=cache)
                     for _, name, args, kw in points]
            tune_s = time.perf_counter() - t0
            for _, name, args, kw in points:
                getattr(KD, ENTRY.get(name, name))(*args, **kw)
            w = next(args[0] for _, name, args, _ in points if name == "gemv")
            KD.batched_gemv(w, torch.ones((8, w.shape[1]), dtype=w.dtype,
                                          device=dev))
            torch.cuda.synchronize()
            launches = K.launch_counts()
            mx_shapes = K.mx_qgemv_launches_by_shape()
            t0 = time.perf_counter()
            second = [tune.tune(name, *args, kernel_kwargs=kw, cache=cache)
                      for _, name, args, kw in points]
            cached_s = time.perf_counter() - t0
            rows = []
            for (label, name, _, _), a, b in zip(points, first, second):
                spec = tune.REGISTRY[name]
                knobs = {k: getattr(a.best, k) for k in spec.space}
                rows.append({
                    "point": label, "kernel": name, "key": a.key,
                    "winner": knobs, "predicted": a.predicted,
                    "fraction": a.fraction, "measured_us":
                        None if a.measured_s is None else a.measured_s * 1e6,
                    "roofline_us": a.roofline_s * 1e6,
                    "timings_run": a.timings_run,
                    "cached": {"from_cache": b.from_cache,
                               "timings_run": b.timings_run,
                               "same_winner": b.best == a.best},
                    "candidates": [
                        {"knobs": {k: getattr(c.cfg, k) for k in spec.space},
                         "predicted": c.predicted, "measured_s": c.measured_s,
                         "fraction": c.achieved, "error": c.error}
                        for c in a.candidates]})
                if a.from_cache or a.timings_run < 1 or a.measured_s is None:
                    raise AssertionError(f"{label}: nothing was timed "
                                         f"({a.timings_run} timings)")
                if not (b.from_cache and b.timings_run == 0
                        and b.best == a.best):
                    raise AssertionError(f"{label}: the second pass did not "
                                         f"come from the cache: {b}")
                if not 0 < a.fraction <= MAX_FRACTION:
                    raise AssertionError(f"{label}: fraction of the roofline"
                                         f" {a.fraction} outside (0, "
                                         f"{MAX_FRACTION}]")
            missing = [k for k in TUNE_PATH if launches[k] == 0]
            if missing:
                raise AssertionError(f"the tuner's path never launched "
                                     f"{missing}")
            eng = build_engine("qwen1.5-0.5b", EngineConfig(**TUNE_ENGINE),
                               device=dev)
            carried = eng.serve_step.troop_configs
            checked = {}
            for (label, name, _, _), a, row in zip(points, first, rows):
                if "engine" in label:
                    if carried[name] != a.best:
                        raise AssertionError(
                            f"the engine carries {carried[name]} for {name},"
                            f" not the tuned {a.best}")
                    checked[name] = row["winner"]
            launch = dataclasses.asdict(eng.serve_step.launch)
            for name, knobs in checked.items():
                if name in ENGINE_LAUNCHED and any(
                        launch[k] != v for k, v in knobs.items()):
                    raise AssertionError(f"the engine launches {launch}, "
                                         f"not {name}'s winner {knobs}")
            del eng
            torch.cuda.empty_cache()
        finally:
            if prev is None:
                os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
            else:
                os.environ["REPRO_TORCH_TUNE_CACHE"] = prev
    return {"rows": rows, "launches": launches,
            "mx_qgemv_by_shape": mx_shapes, "tune_s": tune_s,
            "cached_s": cached_s, "engine_configs": checked,
            "engine_launch": launch}


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


def one_slot(res):
    """The one-slot run's rates (its decode steps take every projection
    through the one-row gemv)."""
    m = res["one_slot"]["metrics"]
    return (f"{m['tokens_per_s']:.2f} tok/s, {m['decode_steps_per_s']:.2f} "
            f"decode steps/s, {res['one_slot']['wall_s']:.2f} s wall")


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


#: the bindings of a served engine: its chunk and its decode step, each
#: captured once as a CUDA graph (``ServingEngine.captures``)
STEP_CAPTURES = {"chunk": 1, "decode": 1}


def check_captures(eng, what):
    if eng.captures != STEP_CAPTURES:
        raise AssertionError(f"{what}: the engine captured {eng.captures}, "
                             f"not {STEP_CAPTURES}")


def eager_path(torch, K, M, model, ecfg, specs, V, graph_reqs,
               graph_launches):
    """The kernel path's 8-slot run again, its steps launched eagerly
    (``capture=False``) on the same requests: the graph run's greedy tokens
    bit for bit (the same kernels in the same order) and its launch counts
    (each replay adds what its capture recorded)."""
    from repro_torch.serve import build_engine
    eng = build_engine(model, ecfg, capture=False)
    K.reset_launch_counts()
    with M.kernel_routing():
        reqs, wall = serve(torch, eng, specs, V)
    launches = K.launch_counts()
    differ = [g.rid for g, e in zip(graph_reqs, reqs) if g.out != e.out]
    if differ:
        raise AssertionError(f"graph and eager greedy tokens differ in "
                             f"requests {differ}")
    if launches != graph_launches:
        raise AssertionError(f"the graph run launched {graph_launches}, the "
                             f"eager run {launches}")
    if any(eng.captures.values()):
        raise AssertionError(f"the eager engine captured {eng.captures}")
    res = {"wall_s": wall, "metrics": eng.metrics(),
           "identical_streams": len(reqs)}
    check_balanced(eng)
    return res


def profiles(torch, np, M, model_k, ecfg, rng, record, name, cycles=10):
    """``decode_profile`` of the graph path, then of the eager path."""
    return {"decode_profile": decode_profile(
                torch, np, M, model_k, ecfg, rng, record, name, cycles),
            "decode_profile_eager": decode_profile(
                torch, np, M, model_k, ecfg, rng, record, name, cycles,
                capture=False)}


def log_graph_vs_eager(res, top=6):
    """The graph-against-eager lines of a served path: tokens, captures,
    then for each host ms per 8-slot cycle, device busy share, decode
    steps/s and tok/s; then the graph window's top kernels."""
    n = res["eager_path"]["identical_streams"]
    log(f"  graph vs eager, kernel path: greedy tokens identical ({n}/{n} "
        f"streams), launches equal; captures per engine {res['captures']} "
        f"({res['kernel_path']['metrics']['capture_s']:.2f} s of warm-up "
        f"and capture in the graph run)")
    for what, path, prof in (
            ("graph", "kernel_path", "decode_profile"),
            ("eager", "eager_path", "decode_profile_eager")):
        m, p = res[path]["metrics"], res[prof]
        steady = m["tokens_generated"] / (m["prefill_s"] + m["decode_s"]
                                          - m["capture_s"])
        log(f"    {what}: {p['host_ms_per_cycle']:.2f} ms host per 8-slot "
            f"cycle, device busy {p['device_busy_share']:.4f} of the window "
            f"({p['device_events']} device events, "
            f"{p['empty_windows']} empty windows), "
            f"{m['decode_steps_per_s']:.2f} decode steps/s, "
            f"{m['tokens_per_s']:.2f} tok/s ({steady:.2f} without the "
            f"capture; {res[path]['wall_s']:.2f} s wall)")
    for name, us in res["decode_profile"]["top_kernels_us"][:top]:
        log(f"    {us:10.1f} us  {name}")


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
        tally = self.routes[name] = {"rows": 0, "flips": 0, "max_margin": 0.0,
                                     "by_row": []}

        def top_k(logits, mo):
            lg = logits.float().reshape(-1, logits.shape[-1])
            _, own = self.real(lg, mo)
            pinned = next(picks).reshape(own.shape)
            flipped = (torch.sort(own, dim=-1).values
                       != torch.sort(pinned, dim=-1).values).any(-1)
            # the reference's own k-th logit down to its weakest pinned one
            margin = (lg.gather(-1, own).amin(-1)
                      - lg.gather(-1, pinned).amin(-1)).clamp(min=0)
            # per (MoE call, row): the kernel path's picks, this
            # reference's own, its margin and its own k-th logit's lead
            # over the next
            top = lg.topk(own.shape[-1] + 1, dim=-1).values
            gap = top[:, -2] - top[:, -1]
            for r in range(lg.shape[0]):
                tally["by_row"].append({
                    "call": len(tally["by_row"]) // lg.shape[0], "row": r,
                    "kernel": sorted(pinned[r].tolist()),
                    "own": sorted(own[r].tolist()),
                    "margin": float(margin[r]), "gap": float(gap[r])})
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
        router, and such rows are few (``ROUTE_FLIP_DIV``); the fp32
        reference's rows where the plain bf16 path routes as the kernel
        path did are the bf16 model's own ties and are not counted."""
        names = list(self.routes)
        by = [self.routes[n]["by_row"] for n in names]
        if len(by[0]) <= 16:
            for rs in zip(*by):
                log(f"    {step} MoE call {rs[0]['call']} row {rs[0]['row']}:"
                    f" kernel path {rs[0]['kernel']}" + "".join(
                        f", {n} {r['own']} (margin {r['margin']:.6g}, gap "
                        f"{r['gap']:.6g})"
                        for n, r in zip(names, rs)))
        plain = self.routes["plain"]["by_row"]
        for name, t in self.routes.items():
            t["counted"] = t["flips"]
            if name != "plain":
                assert len(t["by_row"]) == len(plain)
                t["counted"] = sum(r["own"] != r["kernel"]
                                   and p["own"] != r["kernel"]
                                   for r, p in zip(t["by_row"], plain))
            if t["counted"] > t["rows"] // ROUTE_FLIP_DIV + 1 or \
                    t["max_margin"] > 2 * noise:
                raise AssertionError(
                    f"{step}: the {name} reference routed {t['flips']} of "
                    f"{t['rows']} rows otherwise than the kernel path "
                    f"({t['counted']} where the plain bf16 path routes as "
                    f"the kernel path did not), by margins up to "
                    f"{t['max_margin']} (a tie is within {2 * noise})")
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
                   name="decode_trace.json", cycles=10, capture=True):
    """Steady decode of 8 slots on the kernel path, its steps captured as
    CUDA graphs (``capture=False``: launched eagerly): host wall of
    ``cycles`` engine cycles, then as many more under ``torch.profiler`` —
    the device's busy share of that window (union of kernel/copy intervals
    in the trace) and the kernels that take the device time.  A window in
    which the profiler recorded no device event (seen late in long
    processes) is profiled once more; a second empty window fails.  With ``record``, the graph windows' traces are
    written there."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request, build_engine
    V = model_k.cfg.vocab_size
    eng = build_engine(model_k, dataclasses.replace(ecfg, prefix_cache=False),
                       capture=capture)
    # no slot finishes inside the windows; the requests are left unfinished
    for i in range(8):
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
        empty = 0
        while True:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(cycles):
                    eng.step()
                torch.cuda.synchronize()
                wall_prof = time.perf_counter() - t0
            busy, by_name, n = trace_stats(prof, record if capture else None,
                                           name if capture else "")
            if n:
                break
            empty += 1
            if empty == 2:
                raise AssertionError(f"two profiled windows of {name} "
                                     f"(capture={capture}) hold no device "
                                     f"event")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"capture": capture, "captures": eng.captures, "cycles": cycles,
            "wall_s": wall, "host_ms_per_cycle": wall / cycles * 1e3,
            "profiled_wall_s": wall_prof, "device_events": n,
            "empty_windows": empty,
            "device_busy_s": busy / 1e6,
            "device_busy_share": busy / 1e6 / wall_prof,
            "top_kernels_us": [(n_[:80], d) for n_, d in top]}


def trace_stats(prof, record, name):
    """(device busy us — the union of kernel/copy intervals —, device us
    by kernel name, device events) of a ``torch.profiler`` window; with
    ``record``, the trace goes there gzipped (traces are tens of MB)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / (name or "trace.json")
        prof.export_chrome_trace(str(path))
        trace = path.read_text()
    if record is not None:
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
    return busy, by_name, len(events)


#: kinds of device work in a training step, by kernel name (first match)
KERNEL_KINDS = (
    ("optimizer (fused_adamw)", ("fused_adamw",)),
    ("matmuls", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("copies and casts", ("copy", "memcpy", "memset")),
    ("multi-tensor (norm, clip)", ("multi_tensor_apply",)),
    ("reductions and softmax", ("reduce", "softmax", "norm")),
)


def by_kind(by_name):
    """Device us by kind of kernel (``KERNEL_KINDS``; the rest is
    elementwise and other)."""
    out = {k: 0.0 for k, _ in KERNEL_KINDS}
    out["elementwise and other"] = 0.0
    for name, us in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(w in low for w in keys)),
                    "elementwise and other")
        out[kind] += us
    return out


def engine_phase(torch, dev, rng, record=None):
    import dataclasses

    import numpy as np

    from repro_torch.kernels import ops as K
    from repro_torch.configs import get_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.models import modules as M
    from repro_torch.serve import EngineConfig, build_engine

    cfg = get_config("qwen1.5-0.5b")
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
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

    # the main path: kernel routing on, the steps captured as CUDA graphs,
    # every kernel counted
    eng = build_engine(model_k, ecfg)
    res["kv_pool_bytes"] = sum(2 * c.k_pool.numel() * c.k_pool.element_size()
                               for c in eng.caches)
    K.reset_launch_counts()
    with M.kernel_routing():
        reqs_k, wall = serve(torch, eng, specs, V)
    res["launches"] = K.launch_counts()
    res["mx_qgemv_by_shape"] = K.mx_qgemv_launches_by_shape()
    missing = [k for k in BF16_PATH if res["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")
    res["kernel_path"] = {"wall_s": wall, "metrics": eng.metrics()}
    res["captures"] = eng.captures
    check_captures(eng, "kernel path")
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
    check_captures(eng, "plain path")
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()
    res["eager_path"] = eager_path(torch, K, M, model_k, ecfg, specs, V,
                                   reqs_k, res["launches"])
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
    res["mx_qgemv_by_shape_one_slot"] = K.mx_qgemv_launches_by_shape()
    if not all(res["launches_one_slot"][k] for k in BF16_PATH):
        raise AssertionError(f"one-slot run: {res['launches_one_slot']}")
    res["one_slot"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_captures(eng, "one-slot run")
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()

    res.update(logits_phase(torch, np, K, M, model_k, model_p, dev, rng))
    res.update(profiles(torch, np, M, model_k, ecfg, rng, record,
                        "decode_trace.json"))
    res["embed_us"] = embed_us(torch, M, model_k, dev, ecfg.slots)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    mk, mp = res["kernel_path"]["metrics"], res["plain_path"]["metrics"]
    log(f"  qwen1.5-0.5b full width: {res['weight_bytes'] / 1e9:.3f} GB "
        f"weights, {res['kv_pool_bytes'] / 1e9:.3f} GB KV pools, peak "
        f"{res['max_memory_allocated'] / 1e9:.2f} GB allocated")
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
    log(f"  one slot: {one_slot(res)}, launches {res['launches_one_slot']}")
    log(f"  chunk step: logits err {res['chunk_logits']}, launches "
        f"{res['chunk_launches']}")
    log(f"  decode step: logits err {res['decode_logits']}, launches "
        f"{res['decode_launches']}")
    log(f"  one-slot decode step: logits err "
        f"{res['decode_one_slot_logits']}, launches "
        f"{res['decode_one_slot_launches']}")
    log_graph_vs_eager(res)
    log(f"  embedding of one decode step's {ecfg.slots} ids, device us: "
        f"{res['embed_us']}")
    return res


def embed_us(torch, M, model, dev, slots):
    """Device us of one decode step's embedding (``slots`` ids) from the
    fp32 table: as the serving path does it (gather the rows, then cast)
    and as the JAX package does it (cast the whole table, then gather)."""
    import torch.nn.functional as F

    p = model.params["embed"]
    ids = torch.randint(0, p["table"].shape[0], (slots, 1), device=dev)
    with torch.no_grad():
        gather_cast = time_ms(
            torch, [lambda: M.apply_embed(p, ids, torch.bfloat16)])[0]
        cast_gather = time_ms(
            torch, [lambda: F.embedding(ids, p["table"].bfloat16())],
            reps=10, inner=4)[0]
    return {"gather_then_cast": gather_cast * 1e3,
            "cast_then_gather": cast_gather * 1e3}


def kv_bytes(caches):
    """Bytes of the KV page pools, scale pages included (the chunk stage
    apart)."""
    return sum(a.numel() * a.element_size() for c in caches
               for a in (c.k_pool, c.v_pool, c.k_scale_pool, c.v_scale_pool)
               if a is not None)


def quant_phase(torch, dev, rng, record=None, fmt="mx4"):
    """A quantized qwen1.5-0.5b slice (``QUANT_RUNS[fmt]``: weights
    quantized after the seed-0 init, and the pool type) through the same
    engine, kernel path against plain path, then one slot (every
    projection one row: for mx4 mx_qgemv and the fused mx_qgemv_swiglu;
    int weights dequantize in the graph at any row count)."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import ops as K
    from repro_torch.models import RuntimeConfig
    from repro_torch.models import modules as M
    from repro_torch.quant import quantized_stats
    from repro_torch.serve import EngineConfig, build_engine

    weights, kv, path8, path1, never = QUANT_RUNS[fmt]
    ecfg = EngineConfig(slots=8, cache_len=1024, backend="paged",
                        chunked_prefill=True, chunk_size=32,
                        prefix_cache=True, kv_cache_dtype=kv,
                        quantize_weights=weights, kernel_decode=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine("qwen1.5-0.5b", ecfg, device=dev, seed=0)
    torch.cuda.synchronize()
    model_k = eng.model
    model_p = model_k.with_runtime(RuntimeConfig(
        quantize_weights=weights, kv_cache_dtype=kv))
    V = model_k.cfg.vocab_size
    res = {"format": f"{weights} weights, {kv or 'bf16'} pages",
           "init_s": time.perf_counter() - t0,
           "page_size": eng.backend.spec.page_size,
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model_k.parameters()),
           "quantized_stats": quantized_stats(model_k.params),
           "kv_pool_bytes": kv_bytes(eng.caches),
           "stage_bytes": sum(2 * c.stage.k.numel() * c.stage.k.element_size()
                              for c in eng.caches if c.stage is not None)}
    if kv == "int8" and (res["page_size"] != 32
                         or eng.caches[0].stage is None):
        raise AssertionError("int8 pools need 32-row pages and a stage")

    def check_path(name, launches, want):
        missing = [k for k in want if launches[k] == 0]
        extra = [k for k in never if launches[k]]
        if missing or extra:
            raise AssertionError(f"{fmt} {name}: never launched {missing}, "
                                 f"launched {extra}: {launches}")
    specs = make_requests(np, rng, V, DENSE_REQUESTS)

    # this slice's path, 8 slots
    K.reset_launch_counts()
    with M.kernel_routing():
        reqs_k, wall = serve(torch, eng, specs, V)
    res["launches"] = K.launch_counts()
    res["mx_qgemv_by_shape"] = K.mx_qgemv_launches_by_shape()
    check_path("8-slot run", res["launches"], path8)
    res["kernel_path"] = {"wall_s": wall, "metrics": eng.metrics()}
    res["captures"] = eng.captures
    check_captures(eng, f"{fmt} kernel path")
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
    check_captures(eng, f"{fmt} plain path")
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()
    res["eager_path"] = eager_path(torch, K, M, model_k, ecfg, specs, V,
                                   reqs_k, res["launches"])
    torch.cuda.empty_cache()
    res["token_agreement"] = sum(
        a == b for rk, rp in zip(reqs_k, reqs_p)
        for a, b in zip(rk.out, rp.out)) / sum(len(r.out) for r in reqs_k)
    res["identical_streams"] = sum(rk.out == rp.out
                                   for rk, rp in zip(reqs_k, reqs_p))

    # this slice's path, one slot
    eng = build_engine(model_k, dataclasses.replace(ecfg, slots=1))
    K.reset_launch_counts()
    with M.kernel_routing():
        _, wall = serve(torch, eng, specs[:2], V)
    res["launches_one_slot"] = K.launch_counts()
    res["mx_qgemv_by_shape_one_slot"] = K.mx_qgemv_launches_by_shape()
    check_path("one-slot run", res["launches_one_slot"], path1)
    res["one_slot"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_captures(eng, f"{fmt} one-slot run")
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()

    res.update(logits_phase(torch, np, K, M, model_k, model_p, dev, rng,
                            kv_dtype=kv or "bfloat16"))
    res.update(profiles(torch, np, M, model_k, ecfg, rng, record,
                        "decode_trace_quant.json" if fmt == "mx4"
                        else f"decode_trace_{fmt}.json"))
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()

    mk, mp = res["kernel_path"]["metrics"], res["plain_path"]["metrics"]
    qs = res["quantized_stats"]
    log(f"  qwen1.5-0.5b full width, {res['format']}: "
        f"{res['weight_bytes'] / 1e9:.3f} GB weights ({qs['quantized_leaves']}"
        f" quantized leaves, {qs['quantized_bytes']:,} B, was "
        f"{qs['quantized_fp32_bytes']:,} B fp32; {qs['raw_bytes']:,} B raw), "
        f"{res['kv_pool_bytes'] / 1e9:.3f} GB KV pools"
        + (f" with scale pages (+ {res['stage_bytes'] / 1e6:.1f} MB bf16 "
           f"stage)" if kv else "")
        + f", peak {res['max_memory_allocated'] / 1e9:.2f} GB allocated")
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
    log(f"  one slot: {one_slot(res)}, launches {res['launches_one_slot']}")
    log(f"  chunk step: logits err {res['chunk_logits']}, launches "
        f"{res['chunk_launches']}")
    log(f"  decode step: logits err {res['decode_logits']}, launches "
        f"{res['decode_launches']}")
    log(f"  one-slot decode step: logits err "
        f"{res['decode_one_slot_logits']}, launches "
        f"{res['decode_one_slot_launches']}")
    log_graph_vs_eager(res, top=8)
    return res


def decode_step_launches(torch, np, K, M, model, rng):
    """The launches of one one-slot decode step on the kernel path (after a
    one-slab prefill of 32 seeded tokens on fresh caches): launched
    eagerly, and replayed from a captured ``StepGraph`` (both write the
    same KV row)."""
    from repro_torch.serve import PageSpec
    from repro_torch.serve.graphs import StepGraph
    int8 = model.rt.kv_dtype() == "int8"
    page = 32 if int8 else 16
    spec = PageSpec.for_engine(1, 256, page, dtype=model.rt.kv_dtype())
    caches = model.init_caches(1, 256, page_spec=spec,
                               chunk_stage=32 if int8 else 0)
    dev = model.device

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    bt = np.arange(1, spec.blocks_per_slot + 1, dtype=np.int32)[None]
    prompt = rng.integers(1, model.cfg.vocab_size, 32)
    counts = {}
    with M.kernel_routing():
        logits, _ = model.chunk_step(
            {"tokens": i32(prompt[None]), "offset": i32([0]),
             "valid": i32([32]), "block_tables": i32(bt)}, caches)
        tok = logits.argmax(-1)[:, None].to(torch.int32).cpu().numpy()
        host = {"tokens": tok, "pos": np.asarray([32], np.int32),
                "block_tables": bt}
        K.reset_launch_counts()
        model.decode_step({k: i32(a) for k, a in host.items()}, caches)
        torch.cuda.synchronize()
        counts["eager"] = K.launch_counts()
        graph = StepGraph(model.decode_step, caches, dev)
        K.reset_launch_counts()
        graph.run(host)
        torch.cuda.synchronize()
        counts["graph"] = K.launch_counts()
    del graph, caches
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

    from repro_torch.kernels import ops as K
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
    # shorter requests there (prompts of 40..96 tokens after the shared 24,
    # cut from 40..200 to keep the whole run near 600 s with the int runs)
    n_req, max_new, longest = (4, 8, 96) if quant else (8, 16, 200)
    specs = make_requests(np, rng, V, n_req, max_new, longest=longest)

    # the main path, 8 slots: the experts take the gather path
    K.reset_launch_counts()
    with M.kernel_routing():
        reqs_k, wall = serve(torch, eng, specs, V)
    res["launches"] = K.launch_counts()
    res["mx_qgemv_by_shape"] = K.mx_qgemv_launches_by_shape()
    missing = [k for k in MOE_PATHS_8_SLOTS[fmt] if res["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the {fmt} MoE path never launched {missing}")
    res["kernel_path"] = {"wall_s": wall, "metrics": eng.metrics()}
    res["captures"] = eng.captures
    check_captures(eng, f"MoE {fmt} kernel path")
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
    check_captures(eng, f"MoE {fmt} plain path")
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()
    res["eager_path"] = eager_path(torch, K, M, model_k, ecfg, specs, V,
                                   reqs_k, res["launches"])
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
    res["mx_qgemv_by_shape_one_slot"] = K.mx_qgemv_launches_by_shape()
    missing = [k for k in MOE_PATHS[fmt] if not res["launches_one_slot"][k]]
    if missing:
        raise AssertionError(f"one-slot {fmt} MoE run never launched "
                             f"{missing}: {res['launches_one_slot']}")
    res["one_slot"] = {"wall_s": wall, "metrics": eng.metrics()}
    check_captures(eng, f"MoE {fmt} one-slot run")
    check_balanced(eng)
    del eng
    torch.cuda.empty_cache()

    # one one-slot decode step launches exactly the JAX account's kernels,
    # eager and replayed
    res["decode_step_launches"] = decode_step_launches(torch, np, K, M,
                                                       model_k, rng)
    want = {k: MOE_DECODE_LAUNCHES[fmt].get(k, 0) for k in REPLACES}
    for how, got in res["decode_step_launches"].items():
        if got != want:
            raise AssertionError(f"one-slot {fmt} MoE decode step ({how}) "
                                 f"launched {got}, not {want}")

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
    res.update(profiles(torch, np, M, model_k, ecfg, rng, record,
                        f"decode_trace_moe_{fmt}.json",
                        cycles=3 if quant else 10))
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
    log(f"  one slot: {one_slot(res)}, launches {res['launches_one_slot']}")
    log(f"  one one-slot decode step: launches "
        f"{res['decode_step_launches']['graph']}, eager and replayed (as "
        f"the JAX account)")
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
    log_graph_vs_eager(res, top=8)
    return res


# ------------------------------------------------------------------ train
def train_phase(torch, dev, rng, record=None):
    """Full-width, full-depth qwen1.5-0.5b through ``Trainer.run()``: the
    fused run (the main path, every launch counted), the same steps with
    the plain optimizer, the step's host and device time (and a check that
    a step never synchronizes the host), a profiled window, then an
    injected failure and its restore on a ``TRAIN_CUT``-layer cut against
    an uninterrupted run of the cut."""
    import dataclasses
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops as K
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.ft import FailureInjector
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.train import Trainer, TrainerConfig, make_train_step
    from repro_torch.optim import OptConfig

    cfg = get_config("qwen1.5-0.5b")
    rt = RuntimeConfig(remat="dots")
    B, T = 8, 128
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=T,
                          global_batch=B)
    ckpt_root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt_root.mkdir(parents=True)
    res = {"disk_free_bytes": shutil.disk_usage(ckpt_root).free}

    def opt(fused):
        return OptConfig(fused=fused, lr=1e-3, warmup_steps=2)

    def run(model, fused, name, total=TRAIN_STEPS, fail_at=(),
            ckpt_every=10 ** 9):
        """One ``Trainer.run()`` (metrics of every step; checkpoints every
        ``ckpt_every`` steps and at the end, keep 1, removed after)."""
        tcfg = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                             ckpt_dir=str(ckpt_root / name), ckpt_keep=1,
                             log_every=1)
        tr = Trainer(model, opt(fused), data_cfg, tcfg,
                     failure_injector=FailureInjector(fail_at=set(fail_at)))
        t0 = time.perf_counter()
        _, state, hist = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shutil.rmtree(ckpt_root / name)
        by_step = {h["step"]: h for h in hist}   # a step run again after
        #   a restore keeps its last metrics
        if list(by_step) != list(range(1, total + 1)) or \
                int(state.step) != total:
            raise AssertionError(f"{name}: steps {[h['step'] for h in hist]}"
                                 f", optimizer step {int(state.step)}")
        losses = [h["loss"] for h in by_step.values()]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: losses {losses}")
        return {"losses": losses, "wall_s": wall,
                "grad_norms": [h["grad_norm"] for h in by_step.values()],
                "steps_run": [h["step"] for h in hist],
                "restarts_fired": sorted(tr.injector.fired)}

    t0 = time.perf_counter()
    model = build_model(cfg, rt, device=dev, seed=0, trainable=True)
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["master_elements"] = sum(p.numel() for p in model.parameters())
    res["master_tensors"] = len(list(model.parameters()))

    # the main path: the fused run, every launch counted
    K.reset_launch_counts()
    res["fused"] = run(model, True, "fused")
    res["launches"] = K.launch_counts()
    res["mx_qgemv_by_shape"] = K.mx_qgemv_launches_by_shape()
    want = {k: TRAIN_LEAVES * TRAIN_STEPS if k == "fused_adamw" else 0
            for k in res["launches"]}
    if res["launches"] != want:
        raise AssertionError(f"training launched {res['launches']}, want "
                             f"{want}")
    lf = res["fused"]["losses"]
    if not lf[-1] < lf[0]:
        raise AssertionError(f"the loss did not fall: {lf}")

    # the same steps with the plain optimizer: no kernel, the same losses
    K.reset_launch_counts()
    res["plain"] = run(model, False, "plain")
    if any(K.launch_counts().values()):
        raise AssertionError(f"plain optimizer launched {K.launch_counts()}")
    res["loss_max_abs_diff"] = max(
        abs(a - b) for a, b in zip(lf, res["plain"]["losses"]))
    if res["loss_max_abs_diff"] > TRAIN_LOSS_TOL:
        raise AssertionError(
            f"fused vs plain optimizer losses differ by "
            f"{res['loss_max_abs_diff']} > {TRAIN_LOSS_TOL}: {lf} vs "
            f"{res['plain']['losses']}")

    # a step's time: steps launched back to back, no host sync inside one
    step_fn, opt_ = make_train_step(model, opt(True))
    params, state = model.params, opt_.init(model.params)
    data = SyntheticLM(data_cfg)
    batches = [to_device(data.batch_at(i), dev) for i in range(8)]
    for b in batches[:2]:
        params, state, _ = step_fn(params, state, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a host sync raises here
    try:
        params, state, _ = step_fn(params, state, batches[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    for b in batches[3:3 + n]:
        params, state, metrics = step_fn(params, state, b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res["ms_per_step"] = wall / n * 1e3
    res["tokens_per_s"] = B * T * n / wall
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    # the other remat modes on the same parameters and state: where the
    # host time of a step goes
    res["ms_per_step_by_remat"] = {"dots": res["ms_per_step"]}
    for remat in ("none", "full"):
        fn, _ = make_train_step(model.with_runtime(RuntimeConfig(
            remat=remat)), opt(True))
        params, state, _ = fn(params, state, batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[3:3 + n]:
            params, state, _ = fn(params, state, b)
        torch.cuda.synchronize()
        res["ms_per_step_by_remat"][remat] = (time.perf_counter()
                                              - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[:2]:
            params, state, _ = step_fn(params, state, b)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    busy, by_name, nev = trace_stats(prof, record, "train_trace.json")
    if not nev:
        raise AssertionError("the profiled training steps show no device "
                             "time")
    adamw_us = sum(d for k, d in by_name.items() if "fused_adamw" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    bms, _ = bound_ms(28 * res["master_elements"], 0)
    # the host side of the window: the operations with the most self time
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    res["profile"] = {
        "steps": 2, "profiled_wall_s": wall_prof, "device_events": nev,
        "device_busy_s": busy / 1e6,
        "device_busy_share": busy / 1e6 / wall_prof,
        "device_ms_per_step": sum(by_name.values()) / 2e3,
        "device_events_per_step": nev / 2,
        "device_ms_per_step_by_kind": {
            k: us / 2e3 for k, us in by_kind(by_name).items()},
        "optimizer_device_ms_per_step": adamw_us / 2e3,
        "optimizer_share_of_busy": adamw_us / busy,
        "optimizer_bound_ms": bms,
        "top_kernels_us": [(k[:80], d) for k, d in top],
        "host_top_self_ms": [(e.key[:80], e.count,
                              e.self_cpu_time_total / 1e3)
                             for e in host[:8]]}
    del model, params, state, step_fn, opt_, batches
    torch.cuda.empty_cache()

    # an injected failure and its restore, on a cut of the depth
    cut = build_model(dataclasses.replace(cfg, num_layers=TRAIN_CUT), rt,
                      device=dev, seed=0, trainable=True)
    res["cut_checkpoint_bytes"] = 3 * 4 * sum(p.numel()
                                              for p in cut.parameters())
    res["cut_whole"] = run(cut, True, "cut_whole", total=4)
    whole = {k: v.detach().clone() for k, v in cut.params.named_parameters()}
    res["cut_failed"] = run(cut, True, "cut_failed", total=4, fail_at=(3,),
                            ckpt_every=2)
    if res["cut_failed"]["restarts_fired"] != [3]:
        raise AssertionError(f"injected failure: {res['cut_failed']}")
    diff = 0.0
    for k, v in cut.params.named_parameters():
        diff = max(diff, (v.detach() - whole[k]).abs().max().item())
        if not torch.allclose(v.detach(), whole[k], **RESTART_TOL):
            raise AssertionError(f"restored run differs from the "
                                 f"uninterrupted one at {k}")
    res["restart_param_max_abs_diff"] = diff
    res["restart_loss_max_abs_diff"] = max(
        abs(a - b) for a, b in zip(res["cut_whole"]["losses"],
                                   res["cut_failed"]["losses"]))
    if res["restart_loss_max_abs_diff"] > RESTART_TOL["rtol"] * max(
            res["cut_whole"]["losses"]):
        raise AssertionError(f"restored run's losses differ: {res}")
    del cut, whole
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()

    log(f"  qwen1.5-0.5b training, {cfg.num_layers} layers, remat dots, "
        f"batch {B} x {T}: "
        f"{res['master_elements']:,} fp32 masters in "
        f"{res['master_tensors']} tensors ({TRAIN_LEAVES} JAX leaves)")
    log(f"  fused AdamW: losses {[round(x, 4) for x in lf]}, "
        f"{res['fused']['wall_s']:.2f} s wall (one final checkpoint), "
        f"launches {res['launches']['fused_adamw']}")
    log(f"  plain AdamW: losses "
        f"{[round(x, 4) for x in res['plain']['losses']]}; max |diff| "
        f"{res['loss_max_abs_diff']:.3g} (tolerance {TRAIN_LOSS_TOL})")
    prof_ = res["profile"]
    log(f"  step: {res['ms_per_step']:.2f} ms host wall (remat none / full: "
        f"{res['ms_per_step_by_remat']['none']:.2f} / "
        f"{res['ms_per_step_by_remat']['full']:.2f}), "
        f"{res['tokens_per_s']:.0f} tok/s, peak "
        f"{res['max_memory_allocated'] / 1e9:.2f} GB; profiled: device "
        f"busy {prof_['device_busy_share']:.3f} of the window, optimizer "
        f"{prof_['optimizer_device_ms_per_step']:.3f} ms per step "
        f"(bound {prof_['optimizer_bound_ms']:.3f} ms), "
        f"{prof_['optimizer_share_of_busy']:.3f} of device busy time")
    log(f"  device per step: {prof_['device_ms_per_step']:.3f} ms in "
        f"{prof_['device_events_per_step']:.0f} kernels and copies; "
        + ", ".join(f"{k} {ms:.3f}" for k, ms in
                     prof_["device_ms_per_step_by_kind"].items()))
    for name, us in prof_["top_kernels_us"][:8]:
        log(f"    {us:10.1f} us  {name}")
    log("  host, most self time in the profiled window (ms, calls):")
    for name, count, ms in prof_["host_top_self_ms"]:
        log(f"    {ms:10.2f} ms {count:7d}  {name}")
    log(f"  restart ({TRAIN_CUT} of 24 layers, "
        f"{res['cut_checkpoint_bytes'] / 1e9:.2f} GB per checkpoint): "
        f"failure at step 3 restored from step 2; params max |diff| "
        f"{res['restart_param_max_abs_diff']:.3g}, losses max |diff| "
        f"{res['restart_loss_max_abs_diff']:.3g}")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,tune,engine,quant,moe,train",
                    help="comma list of kernels,tune,engine,quant,moe,train "
                         "(default: all)")
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
    # every engine of the run reads a tune cache that stays empty, so its
    # kernels launch with the defaults; the tune phase uses one of its own
    cache_dir = tempfile.TemporaryDirectory()
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(cache_dir.name)
                                               / "empty.json")
    import numpy as np
    from repro_torch.kernels import ops as K

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
    sass = sass_check()
    record["sass"] = sass
    log("tensor-core instructions (cuobjdump -sass): " + "; ".join(
        f"lib{lib}.so HGMMA {c['HGMMA']} HMMA {c['HMMA']} (" + ", ".join(
            f"{k['instruction']} in each of {len(k['per_instantiation'])} "
            f"{fn}" for fn, k in c["kernels"].items()) + ")"
        for lib, c in sass.items()))

    rng = np.random.default_rng(0)
    rows, phase_s = {}, {}
    if "kernels" in phases:
        t1 = time.perf_counter()
        rows = kernels_phase(torch, K, dev, rng)
        phase_s["kernels"] = time.perf_counter() - t1
        log(f"kernels phase: {phase_s['kernels']:.1f} s")
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
                    + (f"  [plan {r['plan']}]" if "plan" in r else "")
                    + (f"  [streams=2 {us(r['streams2_ms'])}]"
                       if "streams2_ms" in r else "")
                    + (f"  [4 x mx_qgemv {us(r['four_mx_qgemv_ms'])}/"
                       f"{us(r['eager_four_mx_qgemv_ms'])}, 4 x bf16 gemv "
                       f"{us(r['four_bf16_gemv_ms'])}/"
                       f"{us(r['eager_four_bf16_gemv_ms'])}]"
                       if "four_mx_qgemv_ms" in r else "")
                    + (f"  [registry bound {us(r['registry_bound_ms'])}]"
                       if "registry_bound_ms" in r else "")
                    + (f"  [library err {r['library_max_abs_err']:.3g}]"
                       if "library_max_abs_err" in r else ""))
                for c in r.get("candidates", ()):
                    log(f"      {c['knobs']}  {us(c['ms'])}  err "
                        f"{c['max_abs_err']:.3g}")
    # launches on the main paths: each run with the counts zeroed before it
    # and read after it (the tuner's path; the engine's 8-slot run; the
    # quantized, MoE bf16 and MoE mx4 paths' 8-slot and one-slot runs; the
    # fused training run); mx_qgemv's also by shape
    runs, mx_shapes = {}, {}
    if "tune" in phases:
        t1 = time.perf_counter()
        tn = tune_phase(torch, dev)
        phase_s["tune"] = time.perf_counter() - t1
        log(f"tune phase: {phase_s['tune']:.1f} s (tuning "
            f"{tn['tune_s']:.1f} s, the same points from the cache "
            f"{tn['cached_s'] * 1e3:.1f} ms)")
        for r in tn["rows"]:
            meas = r["measured_us"]
            log(f"  {r['point']:58s} winner {r['winner'] or '(no knobs)'}  "
                f"predicted {r['predicted']:.3f}  fraction "
                f"{r['fraction']:.4f}  {meas:.2f} us (bound "
                f"{r['roofline_us']:.2f})  timings_run {r['timings_run']}"
                f"  cached {r['cached']['from_cache']} "
                f"(timings_run {r['cached']['timings_run']})")
        log(f"  engine launches with {tn['engine_launch']}")
        runs["tune"] = tn["launches"]
        mx_shapes["tune"] = tn["mx_qgemv_by_shape"]
        record["tune"] = tn
        del tn
        torch.cuda.empty_cache()
    if "engine" in phases:
        t1 = time.perf_counter()
        eng = engine_phase(torch, dev, rng, args.record)
        phase_s["engine"] = time.perf_counter() - t1
        log(f"engine phase: {phase_s['engine']:.1f} s")
        runs["qwen1.5 bf16"] = eng["launches"]
        mx_shapes["qwen1.5 bf16"] = eng["mx_qgemv_by_shape"]
        mx_shapes["qwen1.5 bf16 one slot"] = \
            eng["mx_qgemv_by_shape_one_slot"]
        record["engine"] = eng
        del eng
    if "quant" in phases:
        for fmt in QUANT_RUNS:
            t1 = time.perf_counter()
            qeng = quant_phase(torch, dev, rng, args.record, fmt)
            phase_s[f"quant {fmt}"] = time.perf_counter() - t1
            log(f"quantized engine phase ({qeng['format']}): "
                f"{phase_s[f'quant {fmt}']:.1f} s")
            runs[f"qwen1.5 {fmt}"] = qeng["launches"]
            runs[f"qwen1.5 {fmt} one slot"] = qeng["launches_one_slot"]
            mx_shapes[f"qwen1.5 {fmt}"] = qeng["mx_qgemv_by_shape"]
            mx_shapes[f"qwen1.5 {fmt} one slot"] = \
                qeng["mx_qgemv_by_shape_one_slot"]
            record["quant" if fmt == "mx4" else f"quant_{fmt}"] = qeng
            del qeng
            torch.cuda.empty_cache()
    if "moe" in phases:
        for fmt in ("bf16", "mx4"):
            t1 = time.perf_counter()
            moe = moe_phase(torch, dev, rng, fmt, args.record)
            phase_s[f"moe {fmt}"] = time.perf_counter() - t1
            log(f"MoE {fmt} engine phase: {phase_s[f'moe {fmt}']:.1f} s")
            runs[f"qwen2-moe {fmt}"] = moe["launches"]
            runs[f"qwen2-moe {fmt} one slot"] = moe["launches_one_slot"]
            mx_shapes[f"qwen2-moe {fmt}"] = moe["mx_qgemv_by_shape"]
            mx_shapes[f"qwen2-moe {fmt} one slot"] = \
                moe["mx_qgemv_by_shape_one_slot"]
            record[f"moe_{fmt}"] = moe
            del moe
            torch.cuda.empty_cache()
    if "train" in phases:
        t1 = time.perf_counter()
        tr = train_phase(torch, dev, rng, args.record)
        phase_s["train"] = time.perf_counter() - t1
        log(f"train phase: {phase_s['train']:.1f} s")
        runs["qwen1.5 train"] = tr["launches"]
        mx_shapes["qwen1.5 train"] = tr["mx_qgemv_by_shape"]
        record["train"] = tr
        del tr
    launches = {name: (sum(r[name] for r in runs.values()) if runs
                       else None) for name in REPLACES}
    record["launches_by_run"] = runs
    by_shape = {}
    for counts in mx_shapes.values():
        for shape, n in counts.items():
            by_shape[shape] = by_shape.get(shape, 0) + n
    record["mx_qgemv_launches_by_shape"] = {"by_run": mx_shapes,
                                            "total": by_shape}
    if runs:
        log(f"mx_qgemv launches by shape (K->N), over the runs: {by_shape}")
    record["phase_s"] = phase_s

    entries = []
    for name, (src, rep) in REPLACES.items():
        rs = rows.get(name, [])
        head = rs[0] if rs else {}
        # the largest error over the shapes, beside that shape's own gate
        worst = max(rs, key=lambda r: (r["max_abs_err"] / r["tolerance"]
                                       if r["tolerance"] else
                                       math.inf if r["max_abs_err"] else 0),
                    default={})
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "eager_ms", "eager_plain_ms", "eager_library_ms")
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "shape": head.get("shape"), "launches": launches[name],
            "tolerance": worst.get("tolerance", TOL[name]),
            "max_abs_err": worst.get("max_abs_err"),
            "kernel_ms": head.get("ms"),
            **{k: head.get(k) for k in keys}, "by_shape": rs,
            **({"launches_by_shape": by_shape} if name == "mx_qgemv"
               else {})})
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
