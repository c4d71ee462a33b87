"""Gradient compression: ``repro/optim/compress.py``.

Blockwise symmetric int8 quantization of a tensor (``block`` consecutive
values of its flattened float32 copy share one scale, ``max |x| / 127``,
floored at 1e-12), and error feedback around it: the quantization residual
of a step is carried and added to the next step's gradient.  ``torch.round``
rounds half to even, as ``jnp.round`` does.  The reference wires no caller
to it either: it is the quantizer a compressed cross-pod reduction would
carry.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.optim.adamw import tree_leaves, tree_map

__all__ = ["compress_with_error_feedback", "dequantize_int8", "quantize_int8"]

f32 = torch.float32


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Returns ``(q (n_blocks, block) int8, scales (n_blocks, 1) float32,
    x's shape, pad)``."""
    flat = x.to(f32).reshape(-1)
    pad = (-flat.shape[0]) % block
    blocks = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, tuple(x.shape), pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, orig_shape, pad: int) -> torch.Tensor:
    flat = (q.to(f32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(orig_shape)


def compress_with_error_feedback(grads: Any, ef_state: Any | None,
                                 block: int = 256) -> tuple[Any, Any, torch.Tensor]:
    """Returns ``(new_grads, ef, rel_err)``: the dequantized gradients in
    their types, the float32 residuals to carry, and the relative error
    ``‖new − g‖ / ‖g‖`` (the denominator floored at 1e-30)."""
    if ef_state is None:
        ef_state = tree_map(lambda g: torch.zeros_like(g, dtype=f32), grads)

    def one(g, e):
        target = g.to(f32) + e
        deq = dequantize_int8(*quantize_int8(target, block))
        return deq.to(g.dtype), target - deq

    pairs: list = []
    new_grads = tree_map(lambda g, e: pairs.append(one(g, e)) or pairs[-1][0], grads, ef_state)
    residuals = iter(pair[1] for pair in pairs)
    new_ef = tree_map(lambda _: next(residuals), grads)
    num = den = 0.0
    for a, b in zip(tree_leaves(new_grads), tree_leaves(grads)):
        num = num + torch.sum((a.to(f32) - b.to(f32)) ** 2)
        den = den + torch.sum(b.to(f32) ** 2)
    rel_err = torch.sqrt(num / torch.clamp(torch.as_tensor(den), min=1e-30))
    return new_grads, new_ef, rel_err
