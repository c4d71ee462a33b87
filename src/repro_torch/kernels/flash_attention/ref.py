"""Plain PyTorch version of the flash-attention kernel.

The function of ``repro/kernels/flash_attention/flash_attention.py`` in its
``(B, H, S, D)`` layout, materialised: float32 throughout, the scale
``D^-½`` applied to q before the product (as the kernel does), causal
scores masked to −1e30 with the mask aligned at the top left (query row i
sees keys 0..i, whatever Sk is), the denominator clamped at 1e-30, and the
output cast to q's type.  KV heads are pre-expanded here, as there.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_ref"]

NEG_INF = -1e30
f32 = torch.float32


def flash_attention_ref(
    q: torch.Tensor,   # (B, H, Sq, D)
    k: torch.Tensor,   # (B, H, Sk, D)
    v: torch.Tensor,   # (B, H, Sk, Dv)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """(B, H, Sq, Dv) attention output in q's type."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    s = (q.to(f32) * d ** -0.5) @ k.to(f32).transpose(-1, -2)
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return ((p @ v.to(f32)) / l).to(q.dtype)
