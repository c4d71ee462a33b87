"""The training loop and its entry points against the reference, on the CPU.

* ``Trainer``: the reference's ``test_end_to_end_training_with_restart``
  (``tests/test_system.py``: interrupted after 9 steps, resumed from the
  step-8 checkpoint), and the resumed run's steps bitwise the uninterrupted
  run's; three steps from a state carried from the reference against the
  reference's trainer (loss within 1e-5, grad norm within 1e-4 relative, as
  in ``test_torch_train_step.py``).
* The launcher and the example on the CPU; the default device raises
  without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import Trainer, TrainerConfig
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_train_parity import models


def _restart_setup(tmp_path, name):
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = LM(cfg, remat=False, attn_block=64, loss_chunk=32)
    tc = TrainerConfig(batch_size=4, seq_len=64, total_steps=16, save_every=8, lr=1e-3)
    return model, tc, str(tmp_path / name)


def test_end_to_end_training_with_restart(tmp_path):
    model, tc, ckpt = _restart_setup(tmp_path, "run")
    _, hist = Trainer(model, ckpt, tc, device="cpu").run(steps=9)    # past the first checkpoint
    tr2 = Trainer(model, ckpt, tc, device="cpu")                      # simulated preemption
    _, hist2 = tr2.run()
    assert hist2[0]["step"] == 8
    assert hist2[-1]["step"] == 15
    assert np.isfinite([h["loss"] for h in hist2]).all()
    assert tr2.manager.steps() == [8, 16]
    model, tc, ckpt = _restart_setup(tmp_path, "straight")
    _, straight = Trainer(model, ckpt, tc, device="cpu").run()
    assert [h["loss"] for h in straight[8:]] == [h["loss"] for h in hist2]
    assert [h["grad_norm"] for h in straight[:9]] == [h["grad_norm"] for h in hist]


def test_trainer_from_a_reference_state_matches_reference_trainer(tmp_path):
    ref_lm, ref_p, lm, p = models("qwen1.5-0.5b")
    tc = dict(batch_size=2, seq_len=32, total_steps=3, save_every=10, lr=1e-3, warmup=1)
    _, want = RefTrainer(ref_lm, str(tmp_path / "ref"), RefTrainerConfig(**tc)).run(
        state=(ref_p, ref_adamw_init(ref_p)))
    _, got = Trainer(lm, str(tmp_path / "port"), TrainerConfig(**tc), device="cpu").run(
        state=(p, adamw_init(p)))
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"]


def test_launcher_trains_reduced_on_cpu_and_refuses_full_off_the_card(tmp_path):
    from repro_torch.launch import train as launch

    hist = launch.main(["--arch", "zamba2-2.7b", "--steps", "3", "--batch", "2", "--seq", "16",
                        "--device", "cpu", "--ckpt", str(tmp_path), "--save-every", "2"])
    assert [h["step"] for h in hist] == [0, 1, 2] and np.isfinite([h["loss"] for h in hist]).all()
    assert launch.main(["--arch", "zamba2-2.7b", "--steps", "3", "--device", "cpu",
                        "--ckpt", str(tmp_path)]) == []      # resumed at its end
    with pytest.raises(SystemExit, match="on the card"):
        launch.main(["--arch", "qwen1.5-0.5b", "--full", "--device", "cpu"])
    assert launch.state_bytes(get_config("deepseek-v2-236b")) > 80e9 * 30
    assert launch.state_bytes(get_config("qwen1.5-0.5b")) < 10e9


def test_example_trains_and_the_loss_falls(tmp_path):
    """The example's model and trainer at a toy width, where the reference's
    3e-4 does not learn within 40 steps, so the loss-falls check drives
    ``Trainer`` with 3e-3; the example's CLI then resumes that run at its end."""
    from repro_torch.examples import train_lm

    model = LM(train_lm.model_config(32, 1), remat=True, attn_block=128, loss_chunk=128)
    tc = TrainerConfig(batch_size=16, seq_len=16, total_steps=40, save_every=10, lr=3e-3,
                       warmup=20)
    _, hist = Trainer(model, str(tmp_path), tc, device="cpu").run()
    assert len(hist) == 40 and hist[-1]["loss"] < hist[0]["loss"]
    assert train_lm.main(["--steps", "40", "--d-model", "32", "--layers", "1", "--seq", "16",
                          "--batch", "16", "--device", "cpu", "--ckpt", str(tmp_path)]) == []
    want = dataclasses.replace(      # the reference example's config
        ref_get_config("qwen1.5-0.5b"), n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=512 * 3, vocab=32000, head_dim=None, pad_heads_to=1)
    assert dataclasses.asdict(train_lm.model_config()) == dataclasses.asdict(want)


def test_trainer_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        Trainer(LM(get_config("qwen1.5-0.5b").reduced()), str(tmp_path))
