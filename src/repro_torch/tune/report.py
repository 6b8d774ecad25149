"""Per-kernel roofline-tuning report: a table, and JSON where asked.

The port's counterpart of the JAX package's ``benchmarks/tune_report.py``.
Runs the tune subsystem end to end for each registered kernel: enumerate
its ``LaunchConfig`` space, prune analytically, time the survivors, and
report each kernel's best config with its fraction-of-roofline score.  A
second identical invocation resolves every kernel from the persistent
cache without re-timing.

    python -m repro_torch.tune.report --fast              # on the card
    REPRO_TORCH_TUNE_CACHE=/tmp/c.json \\
        python -m repro_torch.tune.report --fast --device cpu

On the card the times are device times (CUDA-graph replay) and the
fractions are against the H100's published peaks.  With ``--device cpu``
the plain PyTorch versions are timed on the host: the tune -> cache ->
dispatch loop runs for real, but the times and fractions say nothing of
the card.  Without ``--kernels`` it tunes all 19 registry names, each a
hand-written CUDA kernel on the card (with ``--fast``: gemv, dotp, axpy
and rmsnorm); ``--kernels a,b`` takes a subset, e.g. the full-sequence
attention and the two scans:

    REPRO_TORCH_TUNE_CACHE=/tmp/c.json python -m repro_torch.tune.report \\
        --fast --device cpu --kernels flash_attention,rwkv6,mamba_scan

``--fast`` takes the registry's small example shapes, 2 survivors and 1
timing a candidate; ``--out PATH`` also writes the rows as JSON to PATH.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

FAST_KERNELS = ("gemv", "dotp", "axpy", "rmsnorm")


def _knobs(spec, cfg) -> str:
    return " ".join(f"{k}={getattr(cfg, k)}" for k in spec.space) or \
        "(no knobs)"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="small shapes, keep=2, iters=1 (smoke)")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated subset (default: the fast four "
                         "with --fast, else all 19 registry names)")
    ap.add_argument("--keep", type=int, default=None,
                    help="survivors of the analytic prune per kernel")
    ap.add_argument("--iters", type=int, default=None,
                    help="timings per survivor")
    ap.add_argument("--force", action="store_true",
                    help="retune even when cached")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the rows as JSON to PATH")
    args = ap.parse_args(argv)

    import repro_torch.kernels  # noqa: F401  (populates the registry)
    from repro_torch import tune
    from repro_torch.core.device import resolve_device
    from repro_torch.tune.registry import default_backend
    from repro_torch.tune.search import roofline_bw

    device = resolve_device(args.device)
    keep = args.keep if args.keep is not None else (2 if args.fast else 4)
    iters = args.iters if args.iters is not None else (1 if args.fast else 3)
    if args.kernels:
        names = tuple(k.strip() for k in args.kernels.split(",") if k.strip())
    else:
        names = FAST_KERNELS if args.fast else tune.names()

    cache = tune.default_cache()
    rows = []
    for name in names:
        if name not in tune.REGISTRY:
            print(f"-- unknown kernel {name!r}; registered: "
                  f"{', '.join(tune.names())}", file=sys.stderr)
            continue
        spec = tune.REGISTRY[name]
        kargs, kkw = spec.example(small=args.fast, device=device)
        t0 = time.perf_counter()
        res = tune.tune(name, *kargs, kernel_kwargs=kkw, keep=keep,
                        iters=iters, cache=cache, force=args.force)
        rows.append({
            "kernel": name,
            "key": res.key,
            "config": tune.config_to_dict(res.best),
            "knobs": _knobs(spec, res.best),
            "fraction_of_roofline": res.fraction,
            "predicted_fraction": res.predicted,
            "measured_us": (res.measured_s or 0.0) * 1e6,
            "roofline_us": res.roofline_s * 1e6,
            "from_cache": res.from_cache,
            "timings_run": res.timings_run,
            "tune_wall_s": time.perf_counter() - t0,
        })

    hdr = (f"{'kernel':<28}{'best config':<36}{'frac-roofline':>14}"
           f"{'predicted':>10}{'meas_us':>11}{'roof_us':>10}{'cached':>8}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['kernel']:<28}{r['knobs']:<36}"
              f"{r['fraction_of_roofline']:>14.4g}"
              f"{r['predicted_fraction']:>10.3f}"
              f"{r['measured_us']:>11.2f}{r['roofline_us']:>10.3f}"
              f"{str(r['from_cache']):>8}")
    print(f"\nbackend {default_backend()}, {len(rows)} kernels, cache "
          f"{cache.path}")
    if args.out:
        payload = {"backend": default_backend(), "device": str(device),
                   "roofline_bytes_per_s": roofline_bw(),
                   "cache_path": cache.path, "kernels": rows}
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
