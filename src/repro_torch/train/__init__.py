"""Training: the train step (loss, gradients, clipping, AdamW) and the loop."""
from repro_torch.train.step import build_train_step, init_train_state
from repro_torch.train.trainer import Trainer, TrainerConfig, synthetic_batch

__all__ = ["Trainer", "TrainerConfig", "build_train_step", "init_train_state", "synthetic_batch"]
