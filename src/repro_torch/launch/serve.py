"""Serving launcher of the port.

    python -m repro_torch.launch.serve \\
        --arch qwen1.5-0.5b|qwen2-moe-a2.7b|glm4-9b|qwen3-14b|qwen1.5-32b \\
        [--backend dense|paged] [--chunked-prefill] [--prefix-cache] \\
        [--kernel-decode] [--temperature T] \\
        [--quantize-weights int8|int4|mx4|fp8] [--quantize-group-size G] \\
        [--kv-cache-dtype int8] [--smoke] [--device cpu]

Serves a seeded trace of requests and prints the engine metrics: through
the bucketed engine (the default: prompts padded to power-of-2 buckets and
prefilled together) over the ``--backend`` caches (``paged``, the default,
or ``dense`` per-slot caches), or with ``--chunked-prefill`` through the
chunked, paged one.  ``--temperature`` samples the decode tokens (the first
token stays greedy).  ``--kernel-decode`` routes norms, one-row
projections and the paged attention through the CUDA kernels (on the CPU
their plain versions run).  ``--quantize-weights`` quantizes the
projections as the random init draws them, layer by layer: absmax int8
/ int4 in groups of ``--quantize-group-size`` rows (dequantized in the
graph, as the JAX package does), or MX (through the MX kernels);
``--kv-cache-dtype int8`` stores the KV pages in int8 with scale pages
(32-row pages by default).
``--smoke`` uses the reduced config.  The default device is the CUDA card;
without one the launcher exits with an error unless ``--device cpu`` is
given.
"""
import argparse
import contextlib
import json


def main(argv=None):
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (tiny widths, 2 layers)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--backend", choices=("dense", "paged"),
                    default="paged")
    ap.add_argument("--kernel-decode", action="store_true",
                    help="route rmsnorm, one-row projections and the paged "
                         "attention through the CUDA kernels (requires "
                         "--backend paged)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="prefill as fixed-size token slabs interleaved with "
                         "decode (requires --backend paged)")
    ap.add_argument("--chunk-size", type=int, default=32)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt-prefix KV pages across requests "
                         "(requires --chunked-prefill)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per page (default: the layout granule — "
                         "16 for bf16 pools, 32 for --kv-cache-dtype int8)")
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--quantize-weights",
                    choices=("none", "int8", "int4", "mx4", "fp8"),
                    default="none",
                    help="int8|int4: absmax-quantize the projection weights "
                         "(fp32 scales per group of --quantize-group-size "
                         "rows; MoE expert stacks stay raw); mx4|fp8: "
                         "MX-quantize them and the MoE expert stacks (E8M0 "
                         "32-row block exponents, fp4 or fp8 codes); "
                         "embeddings, norms, biases and MoE routers stay raw")
    ap.add_argument("--quantize-group-size", type=int, default=128,
                    help="scale group along K for --quantize-weights "
                         "int8|int4 (multiple of the 32-row layout granule)")
    ap.add_argument("--kv-cache-dtype", choices=("model", "int8"),
                    default="model",
                    help="int8: int8 page pools + bf16 scale pages under "
                         "--backend paged; per-slot int8 caches under "
                         "--backend dense")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.device import resolve_device
    from repro_torch.models import modules as M
    from repro_torch.quant import quantized_stats
    from repro_torch.serve import EngineConfig, Request, build_engine

    if args.kernel_decode and args.backend != "paged":
        raise SystemExit("--kernel-decode requires --backend paged "
                         "(the kernel reads the page pool + block table)")
    if args.chunked_prefill and args.backend != "paged":
        raise SystemExit("--chunked-prefill requires --backend paged "
                         "(slabs write through block tables)")
    if args.prefix_cache and not args.chunked_prefill:
        raise SystemExit("--prefix-cache requires --chunked-prefill (a "
                         "prefix hit resumes prefill mid-prompt)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    engine_cfg = EngineConfig(
        slots=args.slots, cache_len=args.cache_len, backend=args.backend,
        page_size=args.page_size, num_pages=args.num_pages,
        chunked_prefill=args.chunked_prefill, chunk_size=args.chunk_size,
        prefix_cache=args.prefix_cache, temperature=args.temperature,
        seed=args.seed,
        kernel_decode=args.kernel_decode,
        kv_cache_dtype="int8" if args.kv_cache_dtype == "int8" else "",
        quantize_weights=args.quantize_weights,
        quantize_group_size=args.quantize_group_size).validate()
    engine = build_engine(cfg, engine_cfg, device=device, seed=args.seed)
    if args.quantize_weights != "none":
        qs = quantized_stats(engine.model.params)
        print(f"quantized {qs['quantized_leaves']} weight leaves "
              f"({args.quantize_weights}): {qs['quantized_bytes']:,} B "
              f"(was {qs['quantized_fp32_bytes']:,} B fp32); "
              f"{qs['raw_bytes']:,} B left raw")
        if args.quantize_weights in ("int8", "int4"):
            print("int weights dequantize in the graph (no qgemv dispatch; "
                  "as in the JAX package)")
    rng = np.random.default_rng(args.seed)
    top = min(cfg.vocab_size, 1000)
    system_prompt = rng.integers(1, top, 24) if args.prefix_cache else None
    for i in range(args.requests):
        prompt = rng.integers(1, top, int(rng.integers(4, 16)))
        if system_prompt is not None:       # shared header: exercise reuse
            prompt = np.concatenate([system_prompt, prompt])
        engine.submit(Request(rid=i, prompt=prompt.astype(np.int32),
                              max_new_tokens=args.max_new))
    routing = (M.kernel_routing() if args.kernel_decode
               else contextlib.nullcontext())
    with routing:
        finished = engine.run_until_drained()
    m = engine.metrics()
    print(f"served {len(finished)}/{args.requests} requests in "
          f"{engine.steps} engine cycles on {device} "
          f"(backend={engine.backend.name})")
    print(json.dumps(m, indent=1, default=str))
    return 0 if len(finished) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
