"""Attention in the model layout, routed by device and ``use_kernel``.

Port of ``repro/kernels/flash_attention/ops.py::attention``, which computes
``use_kernel`` and then ignores it; here it is honoured.  A CUDA tensor
goes to the ``flash_attention`` kernel, which reads the ``(B, S, H, D)``
tensors through strided views and the KV head of each query head in place;
when a gradient is being taken through an input, it goes through
``autograd.FlashAttention`` instead (the same forward launch, which also
keeps the row log-sum-exp, and the backward kernels).  A CPU tensor, or
``use_kernel=False``, goes to the plain version, on KV heads expanded by a
repeat as in the reference, and autograd differentiates it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.autograd import FlashAttention
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["attention"]


def attention(
    q: torch.Tensor,   # (B, S, H, D)   — model layout
    k: torch.Tensor,   # (B, S, Hkv, D)
    v: torch.Tensor,   # (B, S, Hkv, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Returns (B, S, H, Dv); ``window`` > 0 is a sliding window."""
    if use_kernel and q.is_cuda and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if use_kernel and q.is_cuda:
        return flash_attention(qt, kt, vt, causal=causal, window=window).transpose(1, 2)
    h, hkv = q.shape[2], k.shape[2]
    if hkv != h:
        kt = kt.repeat_interleave(h // hkv, dim=1)
        vt = vt.repeat_interleave(h // hkv, dim=1)
    return flash_attention_ref(qt, kt, vt, causal=causal, window=window).transpose(1, 2)
