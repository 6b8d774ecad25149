"""Training launcher of the port.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b [--steps N] \\
        [--seq T] [--batch B] [--smoke] [--ckpt-dir DIR] [--device cpu]

Trains on the deterministic synthetic stream with the fault-tolerant
``Trainer``: fp32 masters, the compute dtype inside the layers, AdamW
through the fused CUDA kernel (on the CPU its plain version runs),
checkpoints every 20 steps and at the end.  ``--smoke`` uses the reduced
config without remat; the full config checkpoints matmul outputs
(``remat="dots"``).  The default device is the CUDA card; without one the
launcher exits with an error unless ``--device cpu`` is given.
"""
import argparse
import logging
import os
import tempfile


def main(argv=None):
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (tiny widths, 2 layers)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.device import resolve_device
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import RuntimeConfig, build_model
    from repro_torch.optim import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.multi_pod:
        raise NotImplementedError("multi-pod meshes are not ported yet — "
                                  "ROADMAP queue 1 item 12 (tensor parallel)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
        rt = RuntimeConfig(remat="none")
    else:
        rt = RuntimeConfig(remat="dots")

    model = build_model(cfg, rt, device=device, trainable=True)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    trainer = Trainer(model, OptConfig(decay_steps=args.steps, fused=True),
                      data_cfg, TrainerConfig(total_steps=args.steps,
                                              ckpt_dir=args.ckpt_dir))
    _, _, hist = trainer.run()
    print(f"trained {args.steps} steps on {device}")
    print("final:", hist[-1] if hist else "no metrics")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
