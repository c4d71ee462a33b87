"""Plain PyTorch version of the flash-attention kernel.

The function of ``repro/kernels/flash_attention/flash_attention.py`` in its
``(B, H, S, D)`` layout, materialised: float32 throughout, the scale
``D^-½`` applied to q before the product (as the kernel does), causal
scores masked to −1e30 with the mask aligned at the top left (query row i
sees keys 0..i, whatever Sk is), and with a window W > 0 the scores of keys
at or below i − W as well (the reference's ``attention_full(window=W)``),
the denominator clamped at 1e-30, and the output cast to q's type.  KV heads are pre-expanded here, as there.

``flash_attention_bwd_ref`` is the plain version of the backward kernels
(``csrc/flash_attention_bwd.cu``): the explicit float32 formula
dP = dO·Vᵀ, Δ = rowsum(dO ∘ O), dS = P ∘ (dP − Δ), dQ = scale·dS·K,
dK = scale·dSᵀ·Q, dV = Pᵀ·dO on KV heads that are not expanded (each KV
head's gradients summed over its group).  The tests and ``chip_smoke.py``
hold the kernels to it; no path of the model runs it.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_bwd_ref", "flash_attention_ref", "live_keys"]

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


def flash_attention_bwd_ref(
    q: torch.Tensor,     # (B, H, Sq, D)
    k: torch.Tensor,     # (B, Hkv, Sk, D)
    v: torch.Tensor,     # (B, Hkv, Sk, Dv)
    o: torch.Tensor,     # (B, H, Sq, Dv) the forward's output
    do: torch.Tensor,    # (B, H, Sq, Dv) its gradient
    *,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's type: the module docstring's formula in float32."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d ** -0.5
    qf, dof = q.to(f32), do.to(f32)
    kf = k.to(f32).repeat_interleave(g, dim=1)
    vf = v.to(f32).repeat_interleave(g, dim=1)
    s = (qf * scale) @ kf.transpose(-1, -2)
    keep = live_keys(sq, sk, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    delta = (dof * o.to(f32)).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dq = scale * (ds @ kf)
    dk = scale * (ds.transpose(-1, -2) @ qf)
    dv = p.transpose(-1, -2) @ dof
    dk = dk.reshape(b, hkv, g, sk, d).sum(dim=2)
    dv = dv.reshape(b, hkv, g, sk, -1).sum(dim=2)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
