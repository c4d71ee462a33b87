"""Device policy of the PyTorch port.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  A caller
that wants the CPU says so (the tests pass ``device="cpu"``); asking for
CUDA on a machine without a card raises instead of quietly running on the
CPU.  The implementation then follows the tensors: a CUDA tensor goes to the
hand-written kernel, a CPU tensor to its plain PyTorch version.

Numerics are float32 throughout.  TF32 is turned off for matrix products
and convolutions whenever a CUDA device is resolved, so a float32 product
is a float32 product on the card as it is in the reference.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (``None`` = ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA was requested (the default device) but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
