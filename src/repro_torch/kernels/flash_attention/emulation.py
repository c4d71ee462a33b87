"""The roundings of the bf16 tensor-core ``flash_attention`` kernel, in PyTorch.

The kernel (``kernels/csrc/flash_attention.cu``, path ``sm90``) differs from the plain version (float32 throughout, the scale
applied to q) in three places, which this helper reproduces:

- the scores are the unscaled float32 products q·kᵀ, and the scale enters
  as one float32 factor ``D^-½ · log2(e)`` in ``p = 2^(s·c − m)``;
- the softmax runs online over tiles of ``block_k`` keys: the running max
  ``m`` (in the scaled base-2 domain), the float32 denominator, and the
  accumulator rescaled by ``2^(m_old − m_new)`` at each tile;
- each tile's ``p`` is rounded to bf16 before ``p·v`` (the denominator sums
  the float32 ``p``).

What it does not reproduce is the order of the float32 sums inside the
tensor cores and the 2-ulp error of ``ex2.approx``.  KV heads must be
expanded (``repeat_interleave``) by the caller.  The card tests and
``chip_smoke.py`` hold the kernel to it within one bf16 ulp; the CPU tests
hold it to the plain version and the Pallas kernel.
"""
from __future__ import annotations

import math

import torch

__all__ = ["bf16_path", "key_tile"]

f32 = torch.float32


def key_tile(d: int, dv: int) -> int:
    """The kernel's key tile Bc: 128 keys up to a padded head dim of 128, else 64."""
    return 128 if max(d, dv) <= 128 else 64


def bf16_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              block_k: int) -> torch.Tensor:
    """(B, H, Sq, Dv) in q's type, from (B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, Dv),
    the softmax online over tiles of ``block_k`` keys (the kernel's: :func:`key_tile`)."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    c = torch.tensor(d ** -0.5, dtype=f32) * torch.tensor(math.log2(math.e), dtype=f32)
    c = c.to(q.device)
    s = q.to(f32) @ k.to(f32).transpose(-1, -2)
    if causal:
        keep = torch.arange(sk, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(keep, s, -torch.inf)
    shape = q.shape[:-1]
    m = torch.full(shape, -torch.inf, dtype=f32, device=q.device)
    l = torch.zeros(shape, dtype=f32, device=q.device)
    o = torch.zeros((*shape, v.shape[-1]), dtype=f32, device=q.device)
    for k0 in range(0, sk, block_k):
        st = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, st.amax(dim=-1) * c)
        neg_m = torch.where(m_new == -torch.inf, 0.0, -m_new)
        corr = torch.exp2(m + neg_m)
        p = torch.exp2(torch.addcmul(neg_m[..., None], st, c))
        l = l * corr + p.sum(dim=-1)
        pv = p.to(torch.bfloat16).to(f32) @ v[..., k0:k0 + block_k, :].to(f32)
        o = o * corr[..., None] + pv
        m = m_new
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
