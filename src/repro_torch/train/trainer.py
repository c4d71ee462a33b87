"""The training loop: ``repro/train/trainer.py``.

* **Deterministic, step-indexed data**: :func:`synthetic_batch` is a pure
  function of (seed, step) and gives the reference's batch bit for bit:
  the tokens are ``jax.random.randint`` under ``fold_in(PRNGKey(seed),
  step)`` (two 32-bit draws from the key's split, folded modulo the span,
  on ``core/threefry.py``), the VLM and audio frontends
  ``jax.random.normal`` under ``fold_in(key, 1)``.
* **Auto-resume**: :meth:`Trainer.run` restores the newest checkpoint of
  its directory (``checkpoint/manager.py``) and continues from its step.
* **Checkpoints** every ``save_every`` steps and at the last, saved on a
  thread over a host snapshot, the newest ``keep`` kept.
* **Stragglers**: an EWMA of the step time; a step slower than
  ``straggler_factor`` times it (after step 5) is recorded.

A step is timed on the host clock up to the loss's read-back, which on the
card follows a ``torch.cuda.synchronize()`` (the reference's
``block_until_ready``).  Parameters start from ``model.init`` on a
``torch.Generator`` seeded with 0 on the model's device, or from a state the
caller passes (one carried from the reference by
``bridge.lm_params_from_numpy``, for one).  The model's device is
``device=`` (default ``cuda``; raises without a card).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import threefry
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import adamw_init, linear_warmup_cosine
from repro_torch.train.step import build_train_step

__all__ = ["Trainer", "TrainerConfig", "randint", "synthetic_batch"]

_M32 = 0xFFFFFFFF


def randint(key, shape, minval: int, maxval: int, *, device) -> torch.Tensor:
    """int32 integers in [minval, maxval), as ``jax.random.randint`` draws
    them for int32: bits ``hi`` and ``lo`` from the two keys of
    ``split(key)``, ``((hi % span) · m + lo % span) % span`` with
    ``m = (2^16 % span)² % span``, every product and sum wrapping in uint32
    as JAX's do (for a span above 2^16 the square wraps to 0, so m = 0),
    plus ``minval`` (a span below 1 counts as 1)."""
    span = max(int(maxval) - int(minval), 1)
    k1, k2 = threefry.split(key)
    hi = threefry.random_bits(k1, shape, device=device)
    lo = threefry.random_bits(k2, shape, device=device)
    mult = ((2 ** 16 % span) ** 2 & _M32) % span  # the square wraps in uint32
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return (off % span + int(minval)).to(torch.int32)


def synthetic_batch(model, batch_size: int, seq_len: int, seed: int, step: int,
                    device="cpu") -> dict:
    """The reference's deterministic LM batch of (seed, step) on ``device``:
    ``tokens`` (B, S_text + 1) int32 (S_text is ``seq_len`` less the VLM's
    frontend positions) and, for frontend families, ``frontend`` (B, P, D)
    float32."""
    key = threefry.fold_in(threefry.PRNGKey(seed), step)
    cfg = model.cfg
    s_text = seq_len - cfg.n_frontend_tokens if cfg.family == "vlm" else seq_len
    batch = {"tokens": randint(key, (batch_size, s_text + 1), 0, cfg.vocab, device=device)}
    if cfg.frontend:
        batch["frontend"] = threefry.normal(threefry.fold_in(key, 1),
                                            (batch_size, cfg.n_frontend_tokens, cfg.d_model),
                                            device=device)
    return batch


@dataclass
class TrainerConfig:
    batch_size: int = 8
    seq_len: int = 256
    total_steps: int = 200
    lr: float = 3e-4
    warmup: int = 20
    save_every: int = 50
    keep: int = 3
    seed: int = 0
    grad_accum: int = 1
    straggler_ewma: float = 0.9
    straggler_factor: float = 3.0


@dataclass
class Trainer:
    model: object
    ckpt_dir: str
    config: TrainerConfig = field(default_factory=TrainerConfig)
    batch_fn: Callable | None = None     # (step) -> batch; default synthetic
    device: str | torch.device | None = None

    def __post_init__(self):
        cfg = self.config
        self.device = resolve_device(self.device)
        self.manager = CheckpointManager(self.ckpt_dir, keep=cfg.keep)
        self.step_fn = build_train_step(
            self.model,
            lr_schedule=linear_warmup_cosine(cfg.lr, cfg.warmup, cfg.total_steps),
            grad_accum=cfg.grad_accum,
        )
        self._ewma_dt: float | None = None
        self.straggler_events: list[int] = []

    def init_state(self, generator: torch.Generator | None = None):
        """``(params, AdamW state)`` from ``model.init`` (a generator seeded
        with 0 on the trainer's device by default)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        params = self.model.init(generator)
        return params, adamw_init(params)

    def _batch(self, step: int):
        if self.batch_fn is not None:
            return self.batch_fn(step)
        c = self.config
        return synthetic_batch(self.model, c.batch_size, c.seq_len, c.seed, step, self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, steps: int | None = None, state=None):
        """Train from the newest checkpoint (or fresh, or ``state``); returns
        ``((params, opt), history)``, one ``{"step", "loss", "dt",
        "grad_norm"}`` a step."""
        cfg = self.config
        start_step = 0
        if state is None:
            params, opt = self.init_state()
            restored, meta = self.manager.restore((params, opt), device=self.device)
            if restored is not None:
                params, opt = restored
                start_step = int(meta["step"])
            state = (params, opt)
        params, opt = state

        total = steps if steps is not None else cfg.total_steps
        history = []
        for step in range(start_step, min(start_step + total, cfg.total_steps)):
            t0 = time.perf_counter()
            batch = self._batch(step)
            params, opt, metrics = self.step_fn(
                params, opt, batch, torch.tensor(step, dtype=torch.int32, device=self.device))
            self._sync()
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._track_stragglers(step, dt)
            history.append({"step": step, "loss": loss, "dt": dt,
                            "grad_norm": float(metrics["grad_norm"])})
            if (step + 1) % cfg.save_every == 0 or step + 1 == cfg.total_steps:
                self.manager.save(step + 1, (params, opt), block=False)
        self.manager.wait()
        return (params, opt), history

    def _track_stragglers(self, step: int, dt: float):
        cfg = self.config
        if self._ewma_dt is None:
            self._ewma_dt = dt
            return
        if dt > cfg.straggler_factor * self._ewma_dt and step > 5:
            self.straggler_events.append(step)
        self._ewma_dt = cfg.straggler_ewma * self._ewma_dt + (1 - cfg.straggler_ewma) * dt
