"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro/launch/train.py``: trains the chosen architecture's
``.reduced()`` config end to end (synthetic step-indexed data, AdamW with
warmup and cosine decay, remat, checkpoints every ``--save-every`` steps,
auto-resume from the newest one in ``--ckpt``) on ``--device`` (default
``cuda``; ``--device cpu`` runs the plain PyTorch versions on the CPU).

``--full`` trains the full config, on the card only, and only where its
parameters, their gradients (both in the model's type) and the float32 Adam
moments fit in the card's memory; otherwise it refuses with the byte count
(deepseek-v2-236b, for one).  The reference's ``--full`` instead lowers the
full config against a production mesh (its dry run); the port has no
counterpart of that yet.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --full --batch 4 \\
      --seq 1024 --steps 10
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["main", "state_bytes"]

DEFAULT_CKPT_ROOT = Path(__file__).resolve().parents[3] / "build" / "train"


def state_bytes(cfg) -> int:
    """Bytes of parameters and gradients in the model's type and the two
    float32 Adam moments, from the analytic parameter count (vocab padded)."""
    n = cfg.param_count() + 2 * (LM(cfg).vp - cfg.vocab) * cfg.d_model
    width = 2 if cfg.dtype == "bfloat16" else 4
    return n * (2 * width + 8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="train the full config (on the card, where its state fits)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.full:
        cfg = get_config(args.arch)
        need = state_bytes(cfg)
        if device.type != "cuda":
            raise SystemExit(f"[train] --full trains on the card; got --device {args.device}")
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise SystemExit(f"[train] {args.arch} does not fit: parameters, gradients and "
                             f"Adam moments take {need} bytes, the card has {have}")
        model = LM(cfg, remat=True)
    else:
        cfg = get_config(args.arch).reduced()
        model = LM(cfg, remat=True, attn_block=64, loss_chunk=64)
    ckpt = args.ckpt or str(DEFAULT_CKPT_ROOT / args.arch.replace("/", "_"))
    tc = TrainerConfig(batch_size=args.batch, seq_len=args.seq, total_steps=args.steps,
                       save_every=args.save_every, lr=args.lr, grad_accum=args.grad_accum)
    trainer = Trainer(model, ckpt, tc, device=device)
    print(f"[train] {args.arch} ({'full' if args.full else 'reduced'}: "
          f"{cfg.param_count() / 1e6:.1f}M params) on {device} steps={args.steps} ckpt={ckpt}")
    t0 = time.time()
    _, hist = trainer.run()
    if hist:
        print(f"[train] loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              f"in {time.time() - t0:.1f}s; straggler events: {trainer.straggler_events}")
    else:
        print(f"[train] already complete at step {trainer.manager.latest_step()}")
    return hist


if __name__ == "__main__":
    main()
