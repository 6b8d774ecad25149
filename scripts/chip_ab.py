#!/usr/bin/env python3
"""One side of a paired run on the card: the one-row ``gemv``'s output
digests and the bf16 serving phases of a tree's ``chip_smoke.py``.

Run from the root of a checkout on a machine with an NVIDIA GPU, once per
tree and in turns (parent, change, change, parent), all in one call:

    python3 scripts/chip_ab.py --tree build/parent
    python3 scripts/chip_ab.py --tree .

For the tree at ``--tree`` (its ``src`` and its ``chip_smoke.py``) it
prints the card's ``nvidia-smi`` name and power limit; one line per gemv
shape with a digest of ``gemv(w, x)`` (and, for bf16, of
``batched_gemv(w, x[None])``) on seeded inputs at the default launch
config, so two trees with equal digests at a shape give the same bits
there; then it runs that tree's ``engine_phase`` (qwen1.5-0.5b, bf16) and
``moe_phase`` for bf16 (qwen2-moe-a2.7b), each from a fresh seed-0
stream, and prints, last, one JSON line of their end-to-end numbers: tok/s
and decode steps/s of the 8-slot kernel and plain paths and of the
one-slot run (every projection a one-row gemv), and the steady decode
window's host ms per cycle and device busy share.  It exits non-zero
without a CUDA device.
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
    tree = ap.parse_args().tree.resolve()
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
    eng = smoke.engine_phase(torch, dev, np.random.default_rng(0))
    moe = smoke.moe_phase(torch, dev, np.random.default_rng(0), "bf16")
    print(json.dumps({"qwen1.5 bf16": rates(eng),
                      "qwen2-moe bf16": rates(moe)}))


if __name__ == "__main__":
    main()
