#!/usr/bin/env python3
"""Serve the same requests several times on one card and compare the
greedy tokens of the runs.

    python3 scripts/chip_repeat.py [--tree DIR] [--layers N] [--runs N]

For the tree at ``--tree`` (its ``src``; default: this checkout) it builds
qwen2-moe-a2.7b at full width, cut to ``--layers`` layers, with bf16
weights (seed 0) and pages, and serves 8 seeded requests (a shared 24-token
prompt + 40..200 tokens, 16 new each; 8 slots, chunks of 32, the prefix
cache, every kernel routed) ``--runs`` times with eager steps and, where
the tree's engine captures its steps as CUDA graphs, ``--runs`` times
through them.  It prints, for each run, which requests gave the first
eager run's tokens.  A MoE's idle decode slots take expert capacity that
live rows share, so a run-to-run difference in what idle rows read (the
NULL page) can reach the live tokens.
"""
import argparse
import dataclasses
import inspect
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve()
                    .parents[1], help="root of the tree to run (its src/)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_repeat: needs an NVIDIA GPU")
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.models import modules as M
    from repro_torch.serve import EngineConfig, Request, build_engine

    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              num_layers=args.layers)
    model = build_model(cfg, RuntimeConfig(paged_kernel_decode=True),
                        device="cuda", seed=0)
    ecfg = EngineConfig(slots=8, cache_len=1024, backend="paged",
                        chunked_prefill=True, chunk_size=32,
                        prefix_cache=True, kernel_decode=True)
    rng = np.random.default_rng(0)
    sysp = rng.integers(1, cfg.vocab_size, 24)
    prompts = [np.concatenate([sysp, rng.integers(
        1, cfg.vocab_size, int(rng.integers(40, 201)))]).astype(np.int32)
        for _ in range(8)]
    graphs = "capture" in inspect.signature(build_engine).parameters

    def serve(capture):
        kw = {"capture": capture} if graphs else {}
        eng = build_engine(model, ecfg, **kw)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        with M.kernel_routing():
            eng.run_until_drained()
        torch.cuda.synchronize()
        return [r.out for r in reqs]

    first = serve(False)
    print(f"tree {args.tree}: qwen2-moe-a2.7b, {args.layers} layers, "
          f"{torch.cuda.get_device_name(0)}; requests equal to the first "
          f"eager run's tokens, 1 each:", flush=True)
    for capture in ((False, True) if graphs else (False,)):
        for i in range(args.runs):
            got = serve(capture)
            print(f"  {'graph' if capture else 'eager'} run {i + 1}: "
                  f"{[int(a == b) for a, b in zip(got, first)]}",
                  flush=True)


if __name__ == "__main__":
    main()
