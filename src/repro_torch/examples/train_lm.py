"""End-to-end training example: the port of ``examples/train_lm.py``.

Trains a ~100M-parameter qwen-style dense decoder (qwen1.5-0.5b shrunk: 8
layers of width 512, 8 heads, a 32000-token vocab) for 200 steps on
synthetic step-indexed data, with AdamW, remat and atomic checkpoints with
auto-resume (stop it halfway and run it again: it continues from the last
checkpoint), and asserts that the loss went down.  ``--device`` defaults to
``cuda``; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["main", "model_config"]

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_lm"


def model_config(d_model: int = 512, layers: int = 8):
    """The example's shrunk qwen-style config (the reference's)."""
    return dataclasses.replace(
        get_config("qwen1.5-0.5b"), n_layers=layers, d_model=d_model, n_heads=8,
        n_kv_heads=8, d_ff=d_model * 3, vocab=32000, head_dim=None, pad_heads_to=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = model_config(args.d_model, args.layers)
    model = LM(cfg, remat=True, attn_block=128, loss_chunk=128)
    print(f"training {cfg.param_count() / 1e6:.0f}M-param LM for {args.steps} steps "
          f"(seq={args.seq}, batch={args.batch}) on {device}")
    tc = TrainerConfig(batch_size=args.batch, seq_len=args.seq, total_steps=args.steps,
                       save_every=max(args.steps // 4, 10), lr=3e-4, warmup=20)
    trainer = Trainer(model, args.ckpt, tc, device=device)
    t0 = time.time()
    _, history = trainer.run()
    dt = time.time() - t0
    if not history:
        print("nothing to do (checkpointed run already finished): "
              f"latest step {trainer.manager.latest_step()}")
        return history
    first, last = history[0], history[-1]
    tok_s = args.batch * args.seq * len(history) / dt
    print(f"steps {first['step']}..{last['step']}: loss {first['loss']:.3f} -> "
          f"{last['loss']:.3f} ({tok_s:.0f} tok/s on {device})")
    print(f"checkpoints: {trainer.manager.steps()} in {args.ckpt}")
    assert last["loss"] < first["loss"], "loss must decrease"
    return history


if __name__ == "__main__":
    main()
