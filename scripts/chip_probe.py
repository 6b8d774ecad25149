#!/usr/bin/env python3
"""Launch-plan probes of ``axpy`` and the one-row ``mx_qgemv`` walk on the
card: the device time of each plan the wrappers choose beside the plans
they do not, called through the kernels' C entry points.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/chip_probe.py [--out FILE]

It prints the card's ``nvidia-smi`` name and power limit, then one line
per probe, each device us per call from ``chip_smoke.py``'s ``time_ms``
(CUDA-graph replay over input copies past twice the L2):

- ``axpy`` bf16 from 2^20 to 2^24 elements and at 2^27:
  ``torch.add(y, x, alpha=a)``, the wrapper's plan at the default config,
  and both of the kernel's paths forced: the vector path (a 16-byte
  vector a thread, no tile) and the stream (tiles through shared memory
  by bulk copy, the default knobs); each held to the plain version's
  bits.  The wrapper takes the vector path up to 4 waves of the card at
  a vector a thread (2^23 bf16 on 132 SMs);
- ``mx_qgemv`` at the six shapes of ``chip_smoke.py``'s rows: the bf16
  one-row ``gemv`` at the same (N, K), the wrapper's plan, and for the
  read-outs the first cut tried (4 lanes across a row, 16 rows a lane, K
  in one pass where 8 warps cover it); each held to the plain version
  (5e-6, the smoke's gate).

It exits non-zero without a CUDA device.
"""
import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MX_SHAPES = (((151936, 1024), 4), ((151936, 1024), 8), ((1024, 1024), 4),
             ((1024, 2816), 4), ((2048, 2048), 4), ((2048, 5632), 4))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the probes as JSON to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_probe: needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch import tune
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as K
    from repro_torch.quant.tensor import quantize_mx
    ax = importlib.import_module("repro_torch.kernels.axpy")
    mx = importlib.import_module("repro_torch.kernels.mx_gemv")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    K.build()
    sms = _build.sm_count(dev)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []

    def us(fns):
        return smoke.time_ms(torch, fns)[0] * 1e3

    def line(**row):
        out.append(row)
        print("  ".join(f"{k} {v:.2f}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in row.items()), flush=True)

    cfg = tune.REGISTRY["axpy"].default
    for n in [1 << e for e in (20, 21, 22, 23, 24, 27)]:
        pairs = [tuple(torch.randn(n, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(2))
                 for _ in range(smoke.copies_for(4 * n))]
        want = K.PLAIN["axpy"](1.5, *pairs[0])
        line(kernel="axpy", n=n, plan="torch.add", us=us(
            [lambda p=p: torch.add(p[1], p[0], alpha=1.5) for p in pairs]))
        line(kernel="axpy", n=n, plan="the wrapper's",
             bits=torch.equal(K.axpy(1.5, *pairs[0]), want),
             us=us([lambda p=p: K.axpy(1.5, *p) for p in pairs]))
        plans = {"vector path": ax.vector_plan(n, 2, cfg),
                 "stream": ax.stream_plan(n, 2, cfg)}
        for label, plan in plans.items():
            same = torch.equal(ax.run_plan(1.5, *pairs[0], plan), want)
            line(kernel="axpy", n=n, plan=label, tiles=plan.tiles,
                 blocks=plan.blocks, bits=same,
                 us=us([lambda p=p, q=plan: ax.run_plan(1.5, *p, q)
                        for p in pairs]))
        del pairs, want
        torch.cuda.empty_cache()

    mxlib = _build.library("mx_gemv", mx._ARGTYPES)
    for (N, Kd), bits in MX_SHAPES:
        elem = "fp4" if bits == 4 else "fp8"
        ws = []
        for _ in range(smoke.copies_for(Kd * N // (2 if bits == 4 else 1))):
            qt = quantize_mx(torch.randn((Kd, N), device="cuda", generator=g)
                             / Kd ** 0.5, elem=elem)
            ws.append((qt.values, qt.scales))
        x = torch.randn(Kd, device="cuda", generator=g).to(torch.bfloat16)
        bw = [torch.randn((N, Kd), device="cuda", generator=g)
              .to(torch.bfloat16) for _ in range(smoke.copies_for(2 * N * Kd))]
        shape = f"{elem} {N}x{Kd}"
        line(kernel="mx_qgemv", shape=shape, plan="bf16 gemv",
             us=us([lambda w=w: K.gemv(w, x) for w in bw]))
        del bw
        want = K.PLAIN["mx_qgemv"](*ws[0], x)
        y = torch.empty(N, device="cuda")
        base = mx.qgemv_plan(N, Kd, bits, sms)
        plans = [("the wrapper's", base)]
        if base.rounds > 1:           # 16 rows a lane, K in one pass
            warps = min(8, -(-base.rows // (8 * 16)))
            plans.append(("one pass", base._replace(
                lpr=4, rpl=16, warps=warps, tiles=-(-N // 64),
                rounds=-(-base.rows // (warps * 8 * 16)))))
        for label, p in plans:
            def call(w, p=p):
                _build.check(mxlib.repro_mx_qgemv(
                    w[0].data_ptr(), w[1].data_ptr(), x.data_ptr(),
                    y.data_ptr(), N, Kd, bits, p.cols, p.lpr.bit_length() - 1,
                    p.warps, p.rpl, p.rounds,
                    _build.stream_handle(dev)), "mx_qgemv probe")
            call(ws[0])
            err = (y - want).abs().max().item()
            line(kernel="mx_qgemv", shape=shape, plan=label,
                 cut=f"cols {p.cols} lpr {p.lpr} warps {p.warps} rpl "
                     f"{p.rpl} rounds {p.rounds}",
                 err=err, ok=err <= 5e-6,
                 us=us([lambda w=w: call(w) for w in ws]))
        del ws, want, y
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
