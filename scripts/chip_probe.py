#!/usr/bin/env python3
"""Launch-plan probes of ``axpy``, the one-row MX walk (``mx_qgemv``, the
fused SwiGLU), the paged decodes, ``rmsnorm``, ``batched_qgemv``,
``batched_mx_qgemv``, ``wkv6``, ``mamba_scan`` and ``dotp`` on the card:
the device time of each plan the wrappers choose beside the plans they
do not, called through the kernels' C entry points; and the host's cost
of a one-row ``qgemv`` call on each of its routes.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/chip_probe.py [--out FILE] \
        [--probes axpy,mx_qgemv,mx_swiglu,paged,rmsnorm,qgemv,mx_batched,
                  qgemv_host,scans,dotp] \
        [--parent DIR]

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
  (5e-6, the smoke's gate);
- ``mx_swiglu``: the fused MX SwiGLU at the smoke's gate + up shapes
  (1024 -> 2816 and 2048 -> 5632, fp4 and fp8): two ``mx_qgemv`` calls
  and the wrapper's cut (each stream on its own group of warps), held to
  the plain version at the smoke's gate (6e-6 absolute and relative);
- the paged decodes (bf16 pages of 16 rows, int8 pages of 32) over 8
  slots of a 1024-row table with lengths 64 to 448, at G = 1 (16 heads of
  64 and of 128: the engines) and at hd 128 at G = 5 and 16, at every
  ``decode_warps``: one split against ``wave_splits`` over the kernel's
  occupancy (the splits the plan takes at G > 1), each held to the plain
  version at the smoke's gate; a split count past one adds the combine
  launch;
- ``rmsnorm`` at the smoke's five rows: ``F.rms_norm``, this tree's
  kernel (the wrapper's cut, then the row over 2 and 4 warps), and, with
  ``--parent DIR`` (a checkout of another commit, e.g. the parent
  unpacked under ``build/ab/``), that tree's ``csrc/rmsnorm.cu`` built
  with the same ``nvcc`` flags into ``DIR/build/probe/`` and called
  through its C entry point with the block-a-row design's arguments
  ``(x, scale, out, T, d, eps, threads, stream)`` at 128 threads; each
  held to the plain version at the smoke's gate;
- ``qgemv``: ``batched_qgemv``'s tile walk at the smoke's batched rows
  (and int4 at (2048, 4096)) and at one row of x (the smoke's ``qgemv``
  rows, beside the SIMT walk), every cut of warps a block (4, 8), k-steps
  in flight (4, 8, 16) and K split the kernel takes, the wrapper's
  marked, each held to the plain version at the smoke's gate;
- ``mx_batched``: ``batched_mx_qgemv``'s tile walk at the smoke's rows
  (``MX_BATCHED_ROWS``), every cut of columns a lane (8, 2), warps a
  block, ``unroll`` and K split, the wrapper's marked, each held to the
  plain version at the smoke's gate;
- ``qgemv_host``: the host's us a one-row ``qgemv`` call on the tile walk
  and on the SIMT walk at (2048, 4096), int8 and int4 (wall time of
  launches from Python, the routes interleaved);
- ``scans``: ``wkv6`` at the registry's (1, 256, 4, 64), at 20 heads
  and at rwkv6-3b's time mix with every column slice (8, 16, 32 columns
  a block) and chunk, this tree's kernel beside a variant built into
  ``build/probe/`` whose y and state update are fp32 SIMT products in
  place of 3xTF32 ``mma.sync`` (with its ptxas registers and spills), and
  ``mamba_scan`` at the registry's (2, 512, 512) and at jamba's Mamba
  layer with both lane splits (4 lanes of 4 states, 16 of 1) and every
  tile; the wrappers' plans marked, each held to the plain version at
  the smoke's gate.

It exits non-zero without a CUDA device.
"""
import argparse
import ctypes
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MX_SHAPES = (((151936, 1024), 4), ((151936, 1024), 8), ((1024, 1024), 4),
             ((1024, 2816), 4), ((2048, 2048), 4), ((2048, 5632), 4))
# the host probe: launches a window, windows a route
HOST_CALLS, HOST_WINDOWS = 200, 30
SWIGLU_SHAPES = (((2816, 1024), 4), ((2816, 1024), 8), ((5632, 2048), 4),
                 ((5632, 2048), 8))
# batched_mx_qgemv at the smoke's rows: ((N, K), format, rows of x)
MX_BATCHED_ROWS = (((151936, 1024), "fp4", 8), ((151936, 1024), "fp8", 8),
                   ((151936, 1024), "fp4", 16), ((2048, 4096), "fp4", 4))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the probes as JSON to this file")
    ap.add_argument("--probes", default="axpy,mx_qgemv,mx_swiglu,paged,"
                    "rmsnorm,qgemv,mx_batched,qgemv_host,scans,dotp",
                    help="comma list of the probes to run (default: all)")
    ap.add_argument("--parent", type=Path, default=None, metavar="DIR",
                    help="a checkout whose csrc/rmsnorm.cu (the block-a-row "
                         "design) the rmsnorm probe times beside this one")
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

    probes = set(args.probes.split(","))
    cfg = tune.REGISTRY["axpy"].default
    for n in [1 << e for e in (20, 21, 22, 23, 24, 27)] * ("axpy" in probes):
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
    for (N, Kd), bits in MX_SHAPES * ("mx_qgemv" in probes):
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
                    y.data_ptr(), N, Kd, bits, *p.args(),
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
    for (N, Kd), bits in SWIGLU_SHAPES * ("mx_swiglu" in probes):
        elem = "fp4" if bits == 4 else "fp8"
        ws = []
        for _ in range(smoke.copies_for(2 * Kd * N // (2 if bits == 4
                                                       else 1))):
            qts = [quantize_mx(torch.randn((Kd, N), device="cuda",
                                           generator=g) / Kd ** 0.5,
                               elem=elem) for _ in range(2)]
            ws.append(tuple(t for q in qts for t in (q.values, q.scales)))
        x = torch.randn(Kd, device="cuda", generator=g).to(torch.bfloat16)
        want = K.PLAIN["mx_qgemv_swiglu"](*ws[0], x)
        y = torch.empty(N, device="cuda")
        shape = f"{elem} {N}x{Kd}"
        line(kernel="mx_qgemv_swiglu", shape=shape, plan="2 x mx_qgemv",
             us=us([lambda w=w: (K.mx_qgemv(*w[:2], x), K.mx_qgemv(*w[2:], x))
                    for w in ws]))
        p = mx.swiglu_plan(N, Kd, bits, sms)

        def call(w):
            _build.check(mxlib.repro_mx_gemv_swiglu(
                *(t.data_ptr() for t in w), x.data_ptr(), y.data_ptr(),
                N, Kd, bits, *p.args(), _build.stream_handle(dev)),
                "mx_qgemv_swiglu probe")
        call(ws[0])
        err = (y - want).abs().max().item()
        line(kernel="mx_qgemv_swiglu", shape=shape, plan="the wrapper's",
             cut=f"cols {p.cols} lpr {p.lpr} warps {p.warps} (a group) "
                 f"rpl {p.rpl} rounds {p.rounds}",
             err=err, ok=bool(torch.isclose(y, want, rtol=6e-6,
                                            atol=6e-6).all()),
             us=us([lambda w=w: call(w) for w in ws]))
        del ws, want, y
        torch.cuda.empty_cache()
    if "paged" in probes:
        paged_probes(torch, smoke, K, g, us, line)
    if "rmsnorm" in probes:
        rmsnorm_probes(torch, smoke, K, g, us, line, args.parent)
    if "qgemv" in probes:
        qgemv_probes(torch, smoke, K, g, us, line)
    if "mx_batched" in probes:
        mx_batched_probes(torch, smoke, K, g, us, line)
    if "qgemv_host" in probes:
        qgemv_host_probes(torch, K, g, line)
    if "scans" in probes:
        scan_probes(torch, smoke, K, g, us, line)
    if "dotp" in probes:
        dotp_probes(torch, smoke, K, g, us, line)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


def paged_probes(torch, smoke, K, g, us, line):
    """The paged decodes at one split and at ``wave_splits``'s count."""
    from repro_torch.core.troop import LaunchConfig
    from repro_torch.kernels import _build
    DA = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.quant.tensor import quantize_kv
    lib = _build.library("decode_attention", DA._ARGTYPES)
    dev = torch.device("cuda", 0)
    slots = 8

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g).to(
            torch.bfloat16)

    for H, KV, hd in ((16, 16, 64), (16, 16, 128), (40, 8, 128),
                      (32, 2, 128)):
        q = randn(slots, H, hd)
        length = torch.randint(64, 449, (slots,), device="cuda", generator=g,
                               dtype=torch.int32)
        G = H // KV
        for int8, page in ((False, 16), (True, 32)):
            name = "paged_decode_attention" + "_int8" * int8
            nblk = 1024 // page
            P = slots * nblk + 1
            bt = (torch.randperm(P - 1, device="cuda", generator=g)[
                :slots * nblk] + 1).reshape(slots, nblk).to(torch.int32)
            pools = []
            for _ in range(smoke.copies_for(4 * P * page * KV * hd, cap=4)):
                kv = [randn(P, page, KV, hd) for _ in range(2)]
                pools.append(tuple(kv) if not int8 else
                             (*quantize_kv(kv[0]), *quantize_kv(kv[1])))
            want = K.PLAIN[name](q, *pools[0], bt, length)
            key = name if hd == 64 else f"{name} hd=128"
            fn = lib.repro_paged_decode_int8 if int8 else \
                lib.repro_paged_decode_bf16
            occ = lib.repro_paged_decode_int8_occupancy if int8 else \
                lib.repro_paged_decode_bf16_occupancy
            out = torch.empty_like(q)
            for warps in (2, 4, 8):
                resident = _build.resident(dev, occ, hd, warps)
                wave = DA.wave_splits(slots * KV * -(-G // 16), nblk * page,
                                      resident)
                plan = DA.paged_decode_plan(
                    slots, H, KV, page, nblk, LaunchConfig(decode_warps=warps),
                    resident, lib.repro_paged_decode_max_pages())
                for nsplit in sorted({1, wave}):
                    part = torch.empty((slots * H * nsplit, hd + 2),
                                       device="cuda")

                    def call(p, nsplit=nsplit, part=part, warps=warps):
                        _build.check(fn(
                            q.data_ptr(), *(t.data_ptr() for t in p),
                            bt.data_ptr(), length.data_ptr(), out.data_ptr(),
                            part.data_ptr(), slots, H, KV, hd, page, nblk,
                            warps, nsplit, hd ** -0.5,
                            _build.stream_handle(dev)), "paged probe")
                    call(pools[0])
                    err = (out.float() - want.float()).abs().max().item()
                    line(kernel=name, shape=f"H={H} KV={KV} hd={hd}",
                         warps=warps, nsplit=nsplit,
                         plan=nsplit == plan["nsplit"], err=err,
                         ok=err <= smoke.TOL[key],
                         us=us([lambda p=p: call(p) for p in pools]))
            del pools, want
            torch.cuda.empty_cache()


def rmsnorm_probes(torch, smoke, K, g, us, line, parent):
    """rmsnorm at the smoke's rows: ``F.rms_norm``, this tree's kernel and
    ``parent``'s (where given)."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import rmsnorm_plan
    rms = importlib.import_module("repro_torch.kernels.rmsnorm")
    lib = _build.library("rmsnorm", rms._ARGTYPES)
    old = None
    if parent is not None:
        src = parent.resolve() / "src" / "repro_torch" / "kernels" / "csrc"
        out = parent.resolve() / "build" / "probe"
        out.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(out / "librmsnorm.so"), str(src / "rmsnorm.cu")],
                       check=True, capture_output=True)
        old = ctypes.CDLL(str(out / "librmsnorm.so")).repro_rmsnorm_bf16
        old.argtypes = [_build.P] * 3 + [_build.I] * 2 + [_build.F,
                                                         _build.I, _build.P]
        old.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    for T, d in ((8, 1024), (32, 1024), (1, 1024), (8, 2048), (1, 2048)):
        x = torch.randn((T, d), device="cuda", generator=g).to(torch.bfloat16)
        s = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
        s16 = s.to(torch.bfloat16)
        want = K.PLAIN["rmsnorm"](x, s).float()
        tol = smoke.TOL["rmsnorm"]
        shape = f"({T}, {d})"
        line(kernel="rmsnorm", shape=shape, plan="F.rms_norm",
             us=us([lambda: F.rms_norm(x, (d,), s16, 1e-6)]))
        p = rmsnorm_plan(T, d, 128)
        err = (K.rmsnorm(x, s).float() - want).abs().max().item()
        line(kernel="rmsnorm", shape=shape, plan="a warp a row (this tree)",
             cut=f"wpr {p.wpr} vpl {p.vpl} rows {p.rows} blocks {p.blocks}",
             err=err, ok=err <= tol, us=us([lambda: K.rmsnorm(x, s)]))
        y = torch.empty_like(x)
        for wpr in (2, 4):              # the row over more warps
            vpl = max(1, d // 8 // (32 * wpr))
            rows = max(1, 4 // wpr)

            def cut(wpr=wpr, vpl=vpl, rows=rows):
                _build.check(lib.repro_rmsnorm_bf16(
                    x.data_ptr(), s.data_ptr(), y.data_ptr(), T, d, 1e-6,
                    wpr, vpl, rows, _build.stream_handle(dev)),
                    "rmsnorm probe")
            cut()
            err = (y.float() - want).abs().max().item()
            line(kernel="rmsnorm", shape=shape, plan="warps a row",
                 cut=f"wpr {wpr} vpl {vpl} rows {rows}", err=err,
                 ok=err <= tol, us=us([cut]))
        if old is None:
            continue
        y = torch.empty_like(x)

        def call():
            _build.check(old(x.data_ptr(), s.data_ptr(), y.data_ptr(), T, d,
                             1e-6, 128, _build.stream_handle(dev)),
                         "rmsnorm probe")
        call()
        err = (y.float() - want).abs().max().item()
        line(kernel="rmsnorm", shape=shape,
             plan=f"a block a row ({parent.name})", err=err, ok=err <= tol,
             us=us([call]))


def qgemv_probes(torch, smoke, K, g, us, line):
    """``batched_qgemv``'s tile walk at the smoke's rows: every cut of
    warps a block (4, 8), k-steps in flight (4, 8, 16) and K split the
    kernel takes, the wrapper's marked, each held to the plain version at
    the smoke's gate."""
    from repro_torch.core.troop import LaunchConfig
    from repro_torch.kernels import _build
    from repro_torch.quant.tensor import quantize
    Q = importlib.import_module("repro_torch.kernels.qgemv")
    lib = _build.library("qgemv", Q._ARGTYPES)
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(dev)
    for (N, Kd), bits, B in (((151936, 1024), 8, 8), ((151936, 1024), 4, 8),
                             ((151936, 1024), 8, 16), ((2048, 4096), 8, 4),
                             ((2048, 4096), 4, 4), ((151936, 1024), 8, 1),
                             ((151936, 1024), 4, 1), ((2048, 4096), 8, 1),
                             ((2048, 4096), 4, 1)):
        ws = []
        for _ in range(smoke.copies_for(N * Kd * bits // 8)):
            qt = quantize(torch.randn((N, Kd), device="cuda", generator=g)
                          / Kd ** 0.5, bits=bits, group_size=128, axis=-1)
            ws.append((qt.values, qt.scales))
        xs = torch.randn((B, Kd), device="cuda", generator=g).to(
            torch.bfloat16)
        want = K.PLAIN["batched_qgemv"](*ws[0], xs, bits=bits)
        base = Q.batched_qgemv_plan(N, Kd, Kd // 128, B, bits, LaunchConfig(),
                                    sms)
        y = torch.empty((B, N), device="cuda")
        tiles, nsteps = -(-N // 16), Kd // Q.k_step(bits)
        shape = f"int{bits} B={B} {N}x{Kd}"
        if B == 1:
            # the SIMT walk at the default config, as the wrapper cuts it
            cut = Q.walk_blocks(N, Kd, 1, LaunchConfig(), sms)

            def walk(w):
                _build.check(lib.repro_qgemv(
                    w[0].data_ptr(), w[1].data_ptr(), xs.data_ptr(),
                    y.data_ptr(), N, Kd, Kd // 128, 1, bits, *cut,
                    _build.stream_handle(dev)), "qgemv probe")
            walk(ws[0])
            line(kernel="qgemv", shape=shape, route="SIMT walk",
                 plan=base.route == "walk",
                 ok=bool(torch.isclose(y, want, rtol=4e-6, atol=4e-6).all()),
                 us=us([lambda w=w: walk(w) for w in ws]))
        for warps in (4, 8):
            for steps in (4, 8, 16):
                for ksplit in (1, 2, 4, 8):
                    if warps % ksplit or (ksplit - 1) * steps >= nsteps:
                        continue
                    blocks = -(-tiles // (warps // ksplit))

                    def call(w, a=(warps, steps, ksplit, blocks)):
                        _build.check(lib.repro_qgemv_mma(
                            w[0].data_ptr(), w[1].data_ptr(), xs.data_ptr(),
                            y.data_ptr(), N, Kd, Kd // 128, B, bits, *a,
                            _build.stream_handle(dev)), "qgemv probe")
                    call(ws[0])
                    tol = 1.4e-5 if B > 1 else 4e-6
                    ok = bool(torch.isclose(y, want, rtol=tol,
                                            atol=tol).all())
                    line(kernel="batched_qgemv", shape=shape, warps=warps,
                         steps=steps, ksplit=ksplit,
                         plan=(warps, steps, ksplit) == (
                             base.warps, base.steps, base.ksplit),
                         ok=ok, us=us([lambda w=w: call(w) for w in ws]))
        del ws, want
        torch.cuda.empty_cache()


def qgemv_host_probes(torch, K, g, line):
    """The host's cost of one ``qgemv`` call on each route at (2048,
    4096), where a call's device time (6-9 us) is below it: wall us a
    call over windows of ``HOST_CALLS`` launches from Python and one
    synchronize, the routes' windows interleaved ``HOST_WINDOWS`` times,
    the least and the median window.  Groups of 128 take the tile walk;
    int8 groups of 32 and int4 groups of 64 the SIMT walk."""
    import statistics
    import time
    from repro_torch.quant.tensor import quantize
    calls = {}
    for bits in (8, 4):
        for gs in (128, 32 if bits == 8 else 64):
            qt = quantize(torch.randn((2048, 4096), device="cuda",
                                      generator=g) / 64, bits=bits,
                          group_size=gs, axis=-1)
            x = torch.randn(4096, device="cuda", generator=g).to(
                torch.bfloat16)
            route = "tile walk" if gs == 128 else "SIMT walk"
            calls[(bits, gs, route)] = (
                lambda q=qt, x=x, b=bits: K.qgemv(q.values, q.scales, x,
                                                  bits=b))
    walls = {key: [] for key in calls}
    for fn in calls.values():
        for _ in range(HOST_CALLS):
            fn()
    torch.cuda.synchronize()
    for _ in range(HOST_WINDOWS):
        for key, fn in calls.items():
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            torch.cuda.synchronize()
            walls[key].append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    for (bits, gs, route), w in walls.items():
        line(kernel="qgemv host", shape=f"int{bits} B=1 2048x4096",
             groups=gs, route=route, min_us=min(w),
             median_us=statistics.median(w))


def mx_batched_probes(torch, smoke, K, g, us, line):
    """``batched_mx_qgemv``'s tile walk at the smoke's rows: every cut of
    columns a lane (8, 2), warps a block (4, 8), ``unroll`` (1, 2) and K
    split the kernel takes, the wrapper's marked, each held to the plain
    version at the smoke's gate."""
    from repro_torch.core.troop import LaunchConfig
    from repro_torch.kernels import _build
    from repro_torch.quant.tensor import quantize_mx
    mx = importlib.import_module("repro_torch.kernels.mx_gemv")
    lib = _build.library("mx_gemv", mx._ARGTYPES)
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(dev)
    for (N, Kd), elem, B in MX_BATCHED_ROWS:
        bits = 4 if elem == "fp4" else 8
        ws = []
        for _ in range(smoke.copies_for(Kd * N * bits // 8)):
            qt = quantize_mx(torch.randn((Kd, N), device="cuda", generator=g)
                             / Kd ** 0.5, elem=elem)
            ws.append((qt.values, qt.scales))
        xs = torch.randn((B, Kd), device="cuda", generator=g).to(
            torch.bfloat16)
        want = K.PLAIN["batched_mx_qgemv"](*ws[0], xs)
        base = mx.batched_plan(N, Kd, bits, B, LaunchConfig(), sms)
        y = torch.empty((B, N), device="cuda")
        shape = f"{elem} B={B} {Kd}->{N}"
        for cols in (8, 2):
            tiles = -(-N // (8 * cols))
            for warps in (4, 8):
                for unroll in (1, 2):
                    rb = mx.round_blocks(bits, cols, unroll)
                    for ksplit in (1, 2, 4, 8):
                        if warps % ksplit or (ksplit - 1) * rb >= Kd // 32:
                            continue
                        a = (cols, warps, rb, ksplit,
                             -(-tiles // (warps // ksplit)))

                        def call(w, a=a):
                            _build.check(lib.repro_mx_gemv_batched(
                                w[0].data_ptr(), w[1].data_ptr(),
                                xs.data_ptr(), y.data_ptr(), N, Kd, B, bits,
                                *a, _build.stream_handle(dev)),
                                "batched_mx_qgemv probe")
                        call(ws[0])
                        ok = bool(torch.isclose(y, want, rtol=3e-6,
                                                atol=3e-6).all())
                        line(kernel="batched_mx_qgemv", shape=shape,
                             cols=cols, warps=warps, unroll=unroll,
                             ksplit=ksplit, plan=a == base.args(), ok=ok,
                             us=us([lambda w=w: call(w) for w in ws]))
        del ws, want
        torch.cuda.empty_cache()


# wkv6's steps 4 and 5 (y and the state update) as fp32 SIMT products, 2 x 2
# outputs of y and 2 x 4 of the state a consumer thread, in place of the
# 3xTF32 tensor-core tiles of csrc/rwkv6.cu: the probe's variant of the
# kernel, built from a copy of the source
WKV6_SIMT = """\
      // 4. y[t][j] = rd[t] . S[:, j] + A[t] . v[:, j], 2 x 2 a thread
      for (int e = gt; e < (L / 2) * (CB / 2); e += kGroup) {
        const int t = 2 * (e / (CB / 2)), j = 2 * (e % (CB / 2));
        const float* ea = ec + (t / kSub) * HD;       // t, t + 1: one sub
        float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
        for (int k = 0; k < HD; k += 4) {
          const float4 ee = ld4(ea + k);
          const float4 r0 = mul4(ld4(rq + t * P + k), ee);
          const float4 r1 = mul4(ld4(rq + (t + 1) * P + k), ee);
          const float4 s0 = ld4(Sc + j * P + k), s1 = ld4(Sc + (j + 1) * P + k);
          a00 = dot4(r0, s0, a00), a01 = dot4(r0, s1, a01);
          a10 = dot4(r1, s0, a10), a11 = dot4(r1, s1, a11);
        }
        for (int s = 0; s < L; s += 4) {
          const float4 x0 = ld4(A + t * AP + s), x1 = ld4(A + (t + 1) * AP + s);
          const float4 v0 = ld4(vT + j * AP + s), v1 = ld4(vT + (j + 1) * AP + s);
          a00 = dot4(x0, v0, a00), a01 = dot4(x0, v1, a01);
          a10 = dot4(x1, v0, a10), a11 = dot4(x1, v1, a11);
        }
        float* yo = y + (((size_t)b * T_ + t0 + t) * H + h) * HD + j0 + j;
        if (t < n) *reinterpret_cast<float2*>(yo) = make_float2(a00, a01);
        if (t + 1 < n)
          *reinterpret_cast<float2*>(yo + (size_t)H * HD) =
              make_float2(a10, a11);
      }
      // 5. S[:, j] <- exp(cm_L) S[:, j] + kd^T v[:, j], 2 x 4 a thread
      for (int e = gt; e < (CB / 2) * (HD / 4); e += kGroup) {
        const int j = 2 * (e / (HD / 4)), i = 4 * (e % (HD / 4));
        float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
        for (int s = 0; s < L; s += 4) {
          const float4 v0 = ld4(vT + j * AP + s), v1 = ld4(vT + (j + 1) * AP + s);
          const float4 ee = ld4(et + (s / kSub) * HD + i);
          const float va[4] = {v0.x, v0.y, v0.z, v0.w};
          const float vb[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float4 kd = mul4(ld4(kq + (s + x) * P + i), ee);
            a0 = make_float4(fmaf(va[x], kd.x, a0.x), fmaf(va[x], kd.y, a0.y),
                             fmaf(va[x], kd.z, a0.z), fmaf(va[x], kd.w, a0.w));
            a1 = make_float4(fmaf(vb[x], kd.x, a1.x), fmaf(vb[x], kd.y, a1.y),
                             fmaf(vb[x], kd.z, a1.z), fmaf(vb[x], kd.w, a1.w));
          }
        }
        const float4 l = ld4(el + i);
        const float4 c0 = ld4(Sc + j * P + i), c1 = ld4(Sc + (j + 1) * P + i);
        *reinterpret_cast<float4*>(Sn + j * P + i) = make_float4(
            fmaf(l.x, c0.x, a0.x), fmaf(l.y, c0.y, a0.y),
            fmaf(l.z, c0.z, a0.z), fmaf(l.w, c0.w, a0.w));
        *reinterpret_cast<float4*>(Sn + (j + 1) * P + i) = make_float4(
            fmaf(l.x, c1.x, a1.x), fmaf(l.y, c1.y, a1.y),
            fmaf(l.z, c1.z, a1.z), fmaf(l.w, c1.w, a1.w));
      }
"""
# (name, (B, T, H, hd)) and (name, (b, T, di)) of the scans probe
WKV6_SHAPES = (("registry", (1, 256, 4, 64)), ("20 heads", (1, 2048, 20, 64)),
               ("rwkv6-3b", (1, 2048, 40, 64)))
MAMBA_SHAPES = (("registry", (2, 512, 512)), ("jamba", (1, 2048, 8192)))


def wkv6_simt_source(src: str) -> str:
    """``src`` (``csrc/rwkv6.cu``) with steps 4 and 5 as ``WKV6_SIMT``."""
    start = "      // 4. y[t][j] = rd[t] . S[:, j] + A[t] . v[:, j] on"
    end = "    }\n    __syncthreads();             // chunk it handed over"
    assert src.count(start) == 1 and src.count(end) == 1, "anchors moved"
    return src[:src.index(start)] + WKV6_SIMT + src[src.index(end):]


def ptxas_of(report: str, mangled: str) -> str:
    """Registers and spills ptxas reported for the entry ``mangled``."""
    block = report.split(f"Compiling entry function '{mangled}")[1]
    block = block.split("Compiling entry function")[0]
    return " ".join(ln.strip() for ln in block.splitlines()
                    if "registers" in ln or "spill" in ln)


def scan_probes(torch, smoke, K, g, us, line):
    """``wkv6`` at ``WKV6_SHAPES`` (fp32, zero state) with every column
    slice (8, 16, 32 columns a block) and chunk, this tree's kernel beside
    its variant with fp32 SIMT products for y and the state
    (``WKV6_SIMT``, built into ``build/probe/``), and ``mamba_scan`` at
    ``MAMBA_SHAPES`` with both lane splits (4 lanes of 4 states, 16 of 1)
    and every tile, through the C entry points; the wrappers' plans
    marked, each held to the plain version at the smoke's gate (2.8e-4,
    1.4e-4)."""
    from repro_torch.kernels import _build
    mb = importlib.import_module("repro_torch.kernels.mamba_scan")
    rw = importlib.import_module("repro_torch.kernels.rwkv6")
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(dev)
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rwkv6_simt.cu").write_text(
        wkv6_simt_source((_build.CSRC / "rwkv6.cu").read_text()))
    build = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(out / "librwkv6_simt.so"), str(out / "rwkv6_simt.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"tensor cores": _build.library("rwkv6", rw._ARGTYPES)}

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g)
    for shape, (B, T, H, hd) in WKV6_SHAPES:
        args = (randn(B, T, H, hd), randn(B, T, H, hd), randn(B, T, H, hd),
                torch.exp(-torch.exp(randn(B, T, H, hd))),
                torch.full((H, hd), 0.5, device=dev),
                torch.zeros((B, H, hd, hd), device=dev))
        sets = [args] + [tuple(a.clone() for a in args)
                         for _ in range(smoke.copies_for(
                             sum(a.numel() * 4 for a in args)) - 1)]
        want = K.PLAIN["rwkv6"](*args)
        y = torch.empty((B, T, H, hd), device="cuda")
        st = torch.empty((B, H, hd, hd), device="cuda")
        if build is not None:
            report, _ = build.communicate()
            rc, build = build.returncode, None
            entries = [e.split("'")[0] for e in report.split(
                "Compiling entry function '")[1:]]
            main = next((e for e in entries
                         if "wkv6_kernelIfLi64ELi32ELi32EE" in e), None)
            line(kernel="wkv6 SIMT build", rc=rc,
                 entry="<float, 64, 32, 32>",
                 ptxas=ptxas_of(report, main) if main else report[-2000:])
            if rc == 0:
                simt = ctypes.CDLL(str(out / "librwkv6_simt.so"))
                simt.repro_wkv6_f32.argtypes = rw._ARGTYPES["repro_wkv6_f32"]
                simt.repro_wkv6_f32.restype = ctypes.c_int
                libs["SIMT"] = simt
        for chunk in (8, 16, 32):
            base = rw.wkv6_plan(B, T, H, hd, chunk, sms)
            for cols in (8, 16, 32):
                for products, lib in libs.items():
                    def call(a, chunk=chunk, cols=cols, lib=lib):
                        _build.check(lib.repro_wkv6_f32(
                            *(t.data_ptr() for t in a), y.data_ptr(),
                            st.data_ptr(), B, T, H, hd, chunk, cols,
                            _build.stream_handle(dev)), "wkv6 probe")
                    call(args)
                    err = max((y - want[0]).abs().max().item(),
                              (st - want[1]).abs().max().item())
                    line(kernel="wkv6", shape=shape, chunk=chunk, cols=cols,
                         products=products, blocks=B * H * hd // cols,
                         plan=cols == base.cols, err=err, ok=err <= 2.8e-4,
                         us=us([lambda a=a: call(a) for a in sets]))
        del sets, args, want, y, st
        torch.cuda.empty_cache()
    lib = _build.library("mamba_scan", mb._ARGTYPES)
    for shape, (b, T, di) in MAMBA_SHAPES:
        args = (randn(b, T, di),
                torch.nn.functional.softplus(randn(b, T, di)),
                randn(b, T, 16), randn(b, T, 16), -torch.exp(randn(di, 16)),
                torch.ones((di,), device=dev),
                torch.zeros((b, di, 16), device=dev))
        sets = [args] + [tuple(a.clone() for a in args)
                         for _ in range(smoke.copies_for(
                             sum(a.numel() * 4 for a in args)) - 1)]
        want = K.PLAIN["mamba_scan"](*args)
        y = torch.empty((b, T, di), device="cuda")
        st = torch.empty((b, di, 16), device="cuda")
        for chunk in (8, 16, 32):
            base = mb.mamba_plan(b, T, di, chunk, sms)
            for lanes in (4, 16):
                def call(a, chunk=chunk, lanes=lanes):
                    _build.check(lib.repro_mamba_scan_f32(
                        *(t.data_ptr() for t in a), y.data_ptr(),
                        st.data_ptr(), b, T, di, 16, chunk, lanes,
                        _build.stream_handle(dev)), "mamba_scan probe")
                call(args)
                err = max((y - want[0]).abs().max().item(),
                          (st - want[1]).abs().max().item())
                line(kernel="mamba_scan", shape=shape, chunk=chunk,
                     lanes=lanes, blocks=b * -(-di // (128 // lanes)),
                     plan=lanes == base.lanes, err=err, ok=err <= 1.4e-4,
                     us=us([lambda a=a: call(a) for a in sets]))
        del sets, args, want, y, st
        torch.cuda.empty_cache()


# dotp's combine in the one launch (in place of the programmatic dependent
# second kernel of csrc/dotp.cu): each block stores its partial, fences it
# and draws a ticket with atomicInc(ticket, blocks - 1), which wraps the
# word back to 0; the block that draws blocks - 1 folds the partials in the
# same fixed order with its own threads.  The probe's variant of the
# kernel, built from a copy of the source; its one ticket word serves the
# probe's one stream.
DOTP_TRIGGER = """\
    // the combine may be scheduled once this block's loads are out
    if (c == blockIdx.x)
      asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");
"""
DOTP_SIGNATURE = """\
template <typename T, int S, int VPT>
__global__ void dotp_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            float* __restrict__ partial, int nv, int part,
                            int steps) {
"""
DOTP_TICKET_SIGNATURE = """\
__device__ unsigned int g_ticket = 0;

template <typename T, int S, int VPT>
__global__ void dotp_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            float* __restrict__ partial,
                            float* __restrict__ out, int nv, int part,
                            int steps) {
"""
DOTP_TICKET_TAIL = """\
  acc = block_sum(acc);
  __shared__ unsigned int drawn;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = acc;
    __threadfence();                  // the partial before the ticket
    drawn = atomicInc(&g_ticket, gridDim.x - 1);
  }
  __syncthreads();
  if (drawn != gridDim.x - 1) return;
  __threadfence();                    // every other block's partial is in
  const float s = combine(partial, gridDim.x);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T, int S, int VPT>
cudaError_t launch_k(const void* x, const void* y, void* partial, void* out,
                     int nv, int part, int steps, int threads, int blocks,
                     int combine, cudaStream_t s) {
  dotp_kernel<T, S, VPT><<<blocks, threads, 0, s>>>(
      (const T*)x, (const T*)y, (float*)partial, (float*)out, nv, part,
      steps);
  return cudaGetLastError();
}

"""
# dotp chained: csrc/dotp.cu with its first kernel also launched as a
# programmatic dependent (of whatever precedes it on the stream), its
# loads after ``griddepcontrol.wait``, and the combine triggering its own
# dependents as it starts, so that back-to-back calls overlap one call's
# combine with the next one's launch
DOTP_CHAIN_WAIT = """\
  float acc = 0.f;
  asm volatile("griddepcontrol.wait;\\n" ::: "memory");
"""
DOTP_CHAIN_TRIGGER = """\
  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\\n" ::: "memory");
  const float s = combine(partial, blocks);
"""
DOTP_CHAIN_LAUNCH = """\
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t first = {};
  first.gridDim = dim3(blocks);
  first.blockDim = dim3(threads);
  first.stream = s;
  first.attrs = &attr;
  first.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &first, dotp_kernel<T, S, VPT>, (const T*)x, (const T*)y,
      (float*)partial, nv, part, steps);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(combine);
  cfg.stream = s;
"""
# the probe's sizes (bf16 elements), the grid cuts of the default config
# and the threads of its combine
DOTP_SIZES = tuple(1 << e for e in (16, 18, 20, 22, 24, 27))
DOTP_VPT = (1, 2, 4, 8)
DOTP_COMBINE = (32, 256, 1024)


def dotp_ticket_source(src: str) -> str:
    """``src`` (``csrc/dotp.cu``) with the combine in the one launch, by
    the last block to draw a ticket (``DOTP_TICKET_*``)."""
    tail0 = "  acc = block_sum(acc);\n  if (threadIdx.x == 0) partial"
    tail1 = "template <typename T>\ncudaError_t launch("
    for anchor in (DOTP_TRIGGER, DOTP_SIGNATURE, tail0, tail1):
        assert src.count(anchor) == 1, "anchors moved"
    src = src.replace(DOTP_TRIGGER, "").replace(DOTP_SIGNATURE,
                                                DOTP_TICKET_SIGNATURE)
    return (src[:src.index(tail0)] + DOTP_TICKET_TAIL
            + src[src.index(tail1):])


def dotp_chain_source(src: str) -> str:
    """``src`` (``csrc/dotp.cu``) with both kernels programmatic
    dependents (``DOTP_CHAIN_*``)."""
    wait = "  float acc = 0.f;\n"
    combine = ("  asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n"
               "  const float s = combine(partial, blocks);\n")
    launch0 = "  dotp_kernel<T, S, VPT><<<blocks, threads, 0, s>>>("
    launch1 = "  cfg.stream = s;\n  cudaLaunchAttribute attr;\n"
    for anchor in (wait, combine, launch0, launch1):
        assert src.count(anchor) == 1, "anchors moved"
    src = src.replace(wait, DOTP_CHAIN_WAIT).replace(combine,
                                                     DOTP_CHAIN_TRIGGER)
    i, j = src.index(launch0), src.index(launch1) + len(launch1)
    return src[:i] + DOTP_CHAIN_LAUNCH + src[j:]


def dotp_probes(torch, smoke, K, g, us, line):
    """``dotp`` (bf16) at ``DOTP_SIZES``: ``torch.dot``; every candidate of
    its tuner space at the wrapper's cut, with this tree's combine (a
    programmatic dependent second kernel) and two variants' (the last
    block's ticket, ``DOTP_TICKET_*``; a chain of programmatic dependents,
    ``DOTP_CHAIN_*``; both built into ``build/probe/``); the default
    config at each ``DOTP_VPT`` and at a half and a quarter of the blocks,
    with all three, and with each ``DOTP_COMBINE`` threads of this tree's;
    each held to the plain version at the smoke's gate (1e-5 of sum |x y|)
    and to its own bits on a second launch."""
    from repro_torch import tune
    from repro_torch.kernels import _build
    from repro_torch.tune.search import enumerate_space
    dp = importlib.import_module("repro_torch.kernels.dotp")
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(dev)
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "dotp.cu").read_text()
    libs = {"dependent": _build.library("dotp", dp._ARGTYPES)}
    for label, name, text in (("last block", "dotp_ticket",
                               dotp_ticket_source(src)),
                              ("chained", "dotp_chain",
                               dotp_chain_source(src))):
        (out / f"{name}.cu").write_text(text)
        rc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        line(kernel=f"dotp {label} build", rc=rc.returncode,
             ptxas=rc.stdout[-1500:] if rc.returncode else "ok")
        if rc.returncode == 0:
            lib = ctypes.CDLL(str(out / f"lib{name}.so"))
            lib.repro_dotp_bf16.argtypes = dp._ARGTYPES["repro_dotp_bf16"]
            lib.repro_dotp_bf16.restype = ctypes.c_int
            libs[label] = lib
    spec = tune.REGISTRY["dotp"]
    default = spec.default
    for n in DOTP_SIZES:
        pairs = [tuple(torch.randn(n, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(2))
                 for _ in range(smoke.copies_for(4 * n))]
        x, y = pairs[0]
        want = K.PLAIN["dotp"](x, y).item()
        gate = smoke.TOL["dotp"] * (x.float() * y.float()).abs().sum().item()
        bound = smoke.bound_ms(4 * n + 4, 2 * n)[0] * 1e3
        line(kernel="dotp", n=n, cut="torch.dot", bound_us=bound,
             us=us([lambda p=p: torch.dot(*p) for p in pairs]))
        base = dp.dotp_plan(n, 2, default, sms)
        cuts = [(f"s{cfg.streams} u{cfg.unroll} k{cfg.block_k}",
                 dp.dotp_plan(n, 2, cfg, sms))
                for cfg in enumerate_space(spec)]
        for vpt in DOTP_VPT:
            plan = dp.dotp_plan(n, 2, dataclasses.replace(default,
                                                          unroll=vpt), sms)
            if plan != base:
                cuts.append(("default, other cut", plan))
        for div in (2, 4):
            cuts.append(("default, other cut",
                         base._replace(blocks=max(1, base.blocks // div))))
        runs = [(knobs, plan, combine, lib) for knobs, plan in cuts
                for combine, lib in libs.items()]
        runs += [("default, other combine", base._replace(combine=t),
                  "dependent", libs["dependent"])
                 for t in DOTP_COMBINE if t != base.combine]
        res = torch.empty((), dtype=torch.float32, device=dev)
        for knobs, plan, combine, lib in runs:
            def call(p, plan=plan, lib=lib):
                part = torch.empty((-(-plan.blocks // 4) * 4,),
                                   dtype=torch.float32, device=dev)
                _build.check(lib.repro_dotp_bf16(
                    p[0].data_ptr(), p[1].data_ptr(), part.data_ptr(),
                    res.data_ptr(), n, plan.streams, plan.vpt, plan.threads,
                    plan.blocks, plan.combine, _build.stream_handle(dev)),
                    "dotp probe")
            call(pairs[0])
            got = res.item()
            call(pairs[0])
            err = abs(got - want)
            folds = plan.threads if combine == "last block" else plan.combine
            line(kernel="dotp", n=n, combine=combine, knobs=knobs,
                 cut=f"threads {plan.threads} vpt {plan.vpt} blocks "
                     f"{plan.blocks} steps {plan.steps} combine {folds}",
                 default=plan == base, err=err,
                 ok=err <= gate and got == res.item(),
                 us=us([lambda p=p: call(p) for p in pairs]))
        del pairs, x, y
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
