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
there; one line per ``axpy`` shape (bf16, 2^20 and 2^27) and per
``mx_qgemv`` shape of ``chip_smoke.py``'s kernel rows, each with a digest
of its output and its device time (CUDA-graph replay over input copies
past twice the L2, the smoke's own ``time_ms``) at the default config;
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


def kernel_lines(torch, K, smoke):
    """axpy and mx_qgemv: a digest of each output on seeded inputs and the
    device us per call over input copies, at the default config."""
    from repro_torch.quant.tensor import quantize_mx

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
    spec = importlib.util.spec_from_file_location("smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
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
    kernel_lines(torch, K, smoke)
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
