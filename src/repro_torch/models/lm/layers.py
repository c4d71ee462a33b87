"""Transformer layer primitives of the dense LM: ``repro/models/lm/layers.py``.

Functional, as in the reference: params are nested dicts of tensors, layers
are plain functions.  Attention routes by device:

* on the card, ``attention_block`` calls ``kernels/flash_attention/ops.
  attention``, that is the ``flash_attention`` CUDA kernel (or, under
  ``use_kernel=False``, its plain version on the card);
* on the CPU it calls ``attention_full`` or ``attention_blockwise`` by the
  reference's rule (``s > 2·block and s % block == 0``), so that the CPU
  tests compare like with like.

Numerics follow the reference: the model's type (bf16) for parameters,
activations and projections; float32 for norms, rope, softmax logits and
the activation function, each cast back after.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops

__all__ = [
    "attention_block",
    "attention_blockwise",
    "attention_full",
    "attention_qkv",
    "glu_ffn",
    "init_attention",
    "init_ffn",
    "rms_norm",
    "rope",
]

f32 = torch.float32


# --------------------------------------------------------------------------
# Norms / positional
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(f32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w.to(f32)).to(x.dtype)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=f32, device=x.device) / d))
    ang = positions.to(f32)[..., None] * freqs      # (..., S, d/2)
    ang = torch.cat([ang, ang], dim=-1)             # (..., S, d)
    if x.dim() == ang.dim() + 1:                    # head axis present
        ang = ang[..., None, :]
    xf = x.to(f32)
    return (xf * torch.cos(ang) + _rotate_half(xf) * torch.sin(ang)).to(x.dtype)


# --------------------------------------------------------------------------
# Attention cores (the CPU route)
# --------------------------------------------------------------------------
def _expand_kv(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hq, D) by repeating each KV head."""
    hkv = k.shape[-2]
    if hkv == n_q_heads:
        return k
    return k.repeat_interleave(n_q_heads // hkv, dim=-2)


def _mask(qpos, kpos, causal: bool, window: int):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attention_full(
    q: torch.Tensor,           # (B, Sq, H, D)
    k: torch.Tensor,           # (B, Sk, Hkv, D)
    v: torch.Tensor,           # (B, Sk, Hkv, Dv)
    *,
    causal: bool,
    q_offset: int = 0,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Reference attention; materializes (B, H, Sq, Sk). Short-seq path."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    logits = torch.where(_mask(qpos, kpos, causal, window)[None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(f32)).to(q.dtype)


def attention_blockwise(
    q: torch.Tensor,           # (B, Sq, H, D)
    k: torch.Tensor,           # (B, Sk, Hkv, D)
    v: torch.Tensor,           # (B, Sk, Hkv, Dv)
    *,
    causal: bool,
    q_offset: int = 0,
    window: int = 0,
    block: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash-style online-softmax attention over KV blocks (the reference's
    ``lax.scan`` as Python loops); every KV block is visited, the −1e30
    mask zeroing the causal upper triangle."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dv = v.shape[-1]
    if sk % block != 0 or sq % block != 0:
        return attention_full(
            q, k, v, causal=causal, q_offset=q_offset, window=window, scale=scale
        )
    scale = scale if scale is not None else d ** -0.5
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    nq, nk = sq // block, sk // block
    qb = q.reshape(b, nq, block, h, d).permute(1, 0, 3, 2, 4)  # (nq,B,H,bq,d)
    kb = k.reshape(b, nk, block, h, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, block, h, dv).permute(1, 0, 3, 2, 4)
    blocks = []
    for qi in range(nq):
        qt = qb[qi].to(f32) * scale  # (B,H,bq,d)
        qpos = q_offset + qi * block + torch.arange(block, device=q.device)
        m = torch.full((b, h, block), -1e30, dtype=f32, device=q.device)
        l = torch.zeros((b, h, block), dtype=f32, device=q.device)
        acc = torch.zeros((b, h, block, dv), dtype=f32, device=q.device)
        for ki in range(nk):
            s = torch.einsum("bhqd,bhkd->bhqk", qt, kb[ki].to(f32))  # (B,H,bq,bk)
            kpos = ki * block + torch.arange(block, device=q.device)
            s = torch.where(_mask(qpos, kpos, causal, window)[None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb[ki].to(f32))
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        blocks.append(out.transpose(1, 2))  # (B,bq,H,dv)
    return torch.cat(blocks, dim=1).to(q.dtype)


# --------------------------------------------------------------------------
# Standard (GQA) attention block
# --------------------------------------------------------------------------
def _normal(generator, shape, std) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device) * std


def init_attention(generator: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> dict:
    """Attention parameters, with leading axes ``lead`` (``(L,)`` for a stack).

    Drawn from ``generator`` on its device, with the reference's stds; q
    heads zero-padded per KV group to a multiple of ``cfg.pad_heads_to``
    (padded heads have zero ``wq`` and ``wo`` rows, so the model is exact).
    """
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    pad = cfg.pad_heads_to
    hp = ((h + pad - 1) // pad) * pad
    while hp % hkv != 0:  # keep per-group padding equal
        hp += pad
    lead = tuple(lead)
    std = d ** -0.5
    wq = _normal(generator, (*lead, d, hp, hd), std)
    wk = _normal(generator, (*lead, d, hkv, hd), std)
    wv = _normal(generator, (*lead, d, hkv, hd), std)
    wo = _normal(generator, (*lead, hp, hd, d), (h * hd) ** -0.5)
    if hp != h:
        gq, gq_p = h // hkv, hp // hkv
        live = (torch.arange(gq_p, device=wq.device) < gq).to(wq.dtype).repeat(hkv)  # (hp,)
        wq = wq * live[:, None]
        wo = wo * live[:, None, None]
    dev = generator.device
    p = {"wq": wq.to(dtype), "wk": wk.to(dtype), "wv": wv.to(dtype), "wo": wo.to(dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, hp, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((*lead, hkv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((*lead, hkv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((*lead, hd), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((*lead, hd), dtype=dtype, device=dev)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def attention_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions) -> tuple:
    """Project + rope; returns (q, k, v) with shapes (B,S,H*,Dh)."""
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    positions: torch.Tensor | None = None,
    window: int = 0,
    block: int = 1024,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Full-sequence attention (prefill), routed by device (module docstring)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = attention_qkv(p, x, cfg, positions)
    if x.is_cuda:
        if window > 0:
            raise NotImplementedError(
                f"window={window}: sliding-window attention on the card is not ported "
                "(the flash_attention kernel has no window; ROADMAP Queue 1 item 13)"
            )
        o = ops.attention(q, k, v, causal=causal, use_kernel=use_kernel)
    elif s > 2 * block and s % block == 0:
        o = attention_blockwise(q, k, v, causal=causal, window=window, block=block)
    else:
        o = attention_full(q, k, v, causal=causal, window=window)
    h, hd, d = p["wo"].shape
    return o.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, d)


# --------------------------------------------------------------------------
# GLU FFN
# --------------------------------------------------------------------------
def init_ffn(generator: torch.Generator, d: int, f: int, dtype, lead=()) -> dict:
    lead = tuple(lead)
    return {
        "w_gate": _normal(generator, (*lead, d, f), d ** -0.5).to(dtype),
        "w_up": _normal(generator, (*lead, d, f), d ** -0.5).to(dtype),
        "w_down": _normal(generator, (*lead, f, d), f ** -0.5).to(dtype),
    }


def glu_ffn(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    if act == "swiglu":
        g = F.silu(g.to(f32)).to(x.dtype)
    elif act == "geglu":
        g = F.gelu(g.to(f32), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(act)
    return (g * u) @ p["w_down"]
