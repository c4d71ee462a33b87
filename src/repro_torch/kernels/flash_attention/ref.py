"""Plain PyTorch version of the flash-attention kernel.

The function of ``repro/kernels/flash_attention/flash_attention.py`` in its
``(B, H, S, D)`` layout, materialised: float32 throughout, the scale
``D^-½`` applied to q before the product (as the kernel does), causal
scores masked to −1e30 with the mask aligned at the top left (query row i
sees keys 0..i, whatever Sk is), and with a window W > 0 the scores of keys
at or below i − W as well (the reference's ``attention_full(window=W)``),
the denominator clamped at 1e-30, and the output cast to q's type.  KV heads are pre-expanded here, as there.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "live_keys"]

NEG_INF = -1e30
f32 = torch.float32


def live_keys(sq: int, sk: int, causal: bool, window: int, device) -> torch.Tensor | None:
    """(Sq, Sk) bool: the keys each query row sees (None: all of them)."""
    if not causal and window <= 0:
        return None
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    keep = kpos <= qpos if causal else torch.ones((sq, sk), dtype=torch.bool, device=device)
    return keep & (kpos > qpos - window) if window > 0 else keep


def flash_attention_ref(
    q: torch.Tensor,   # (B, H, Sq, D)
    k: torch.Tensor,   # (B, H, Sk, D)
    v: torch.Tensor,   # (B, H, Sk, Dv)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """(B, H, Sq, Dv) attention output in q's type."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    s = (q.to(f32) * d ** -0.5) @ k.to(f32).transpose(-1, -2)
    keep = live_keys(sq, sk, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return ((p @ v.to(f32)) / l).to(q.dtype)
