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
``mx_qgemv`` shape of ``chip_smoke.py``'s kernel rows, per paged decode
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
one length, 0 to 1024, and their device time at each;
then it runs serving phases of that tree, each from a fresh seed-0 stream
(``--engines``: ``bf16``, the default, runs ``engine_phase``, qwen1.5-0.5b
bf16, and ``moe_phase`` for bf16, qwen2-moe-a2.7b; ``mx4`` runs
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
MX_SHAPES = (((151936, 1024), "fp4"), ((151936, 1024), "fp8"),
             ((1024, 1024), "fp4"), ((1024, 2816), "fp4"),
             ((2048, 2048), "fp4"), ((2048, 5632), "fp4"))
# the paged decodes: (H, KV, hd) over 8 slots of a 1024-row table
PAGED_SHAPES = ((16, 16, 64), (16, 16, 128),   # the engines, G = 1
                (32, 2, 128), (40, 8, 128))    # glm4-9b's, qwen3-14b's heads
# the G = 1 sweep: every slot at each of these lengths
SWEEP_LENGTHS = (0, 16, 64, 128, 256, 448, 1024)
# the int8 dense decode: (B, H, KV, hd, S), full length
DENSE_INT8_SHAPES = ((8, 16, 16, 64, 1024), (4, 16, 8, 128, 4096),
                     (4, 32, 2, 128, 4096))


def digests(torch, K):
    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
    for (N, Kd), name in GEMV_SHAPES:
        dtype = getattr(torch, name)
        g = torch.Generator(device="cuda").manual_seed(0)
        w = (torch.randn((N, Kd), device="cuda", generator=g)
             / Kd ** 0.5).to(dtype)
        x = torch.randn(Kd, device="cuda", generator=g).to(dtype)
        line = f"gemv ({N}, {Kd}) {name} {sha(K.gemv(w, x))}"
        if dtype == torch.bfloat16:
            line += f", batched_gemv B=1 {sha(K.batched_gemv(w, x[None]))}"
        print(line, flush=True)


def kernel_lines(torch, K, smoke, referee):
    """axpy, mx_qgemv, the paged decodes and the int8 dense decode: a
    digest of each output on seeded inputs and the device us per call over
    input copies, at the default config; ``referee``: this checkout's
    ``chip_smoke.py`` (its float64 paged decode and its gates)."""
    from repro_torch.quant.tensor import quantize_kv, quantize_mx

    def sha(t):
        return hashlib.sha256(t.view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()[:16]
    g = torch.Generator(device="cuda").manual_seed(0)
    for n in AXPY_SIZES:
        pairs = [tuple(torch.randn(n, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(2))
                 for _ in range(smoke.copies_for(4 * n))]
        ms = smoke.time_ms(torch, [lambda p=p: K.axpy(1.5, *p)
                                   for p in pairs])[0]
        print(f"axpy n={n} bf16 {sha(K.axpy(1.5, *pairs[0]))} "
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
        print(f"mx_qgemv {elem} ({N}, {Kd}) {sha(K.mx_qgemv(*ws[0], x))} "
              f"{ms * 1e3:.2f} us", flush=True)
        del ws
        torch.cuda.empty_cache()

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
                  f"{sha(fn(q, *pools[0], bt, length))} {ms * 1e3:.2f} us; "
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
              f"{sha(K.decode_attention_int8(q, *caches[0], length))} "
              f"{ms * 1e3:.2f} us", flush=True)
        del caches
        torch.cuda.empty_cache()


def load_smoke(path):
    spec = importlib.util.spec_from_file_location(f"smoke_{abs(hash(path))}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rates(res):
    out = {}
    for run in ("kernel_path", "plain_path", "one_slot"):
        m = res[run]["metrics"]
        out[run] = {"tokens_per_s": m["tokens_per_s"],
                    "decode_steps_per_s": m["decode_steps_per_s"]}
    prof = res["decode_profile"]
    out["host_ms_per_cycle"] = prof["wall_s"] / prof["cycles"] * 1e3
    out["device_busy_share"] = prof["device_busy_share"]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True,
                    help="root of the tree to run (its src/ and "
                         "chip_smoke.py)")
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
    digests(torch, K)
    kernel_lines(torch, K, smoke, referee)
    out = {}
    if args.engines == "bf16":
        out["qwen1.5 bf16"] = rates(smoke.engine_phase(
            torch, dev, np.random.default_rng(0)))
        out["qwen2-moe bf16"] = rates(smoke.moe_phase(
            torch, dev, np.random.default_rng(0), "bf16"))
    elif args.engines == "mx4":
        out["qwen1.5 mx4"] = rates(smoke.quant_phase(
            torch, dev, np.random.default_rng(0), None, "mx4"))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
