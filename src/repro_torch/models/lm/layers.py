"""Transformer layer primitives of the LM: ``repro/models/lm/layers.py``.

Functional, as in the reference: params are nested dicts of tensors, layers
are plain functions.  Full-sequence (prefill) attention, GQA and MLA alike,
routes by device:

* on the card it calls ``kernels/flash_attention/ops.attention``, that is
  the ``flash_attention`` CUDA kernel (or, under ``use_kernel=False``, its
  plain version on the card);
* on the CPU it calls ``attention_full`` or ``attention_blockwise`` by the
  reference's rule (``s > 2·block and s % block == 0``), so that the CPU
  tests compare like with like.

Decode attention (``attention_decode``, and MLA's absorbed form in
``mla_block_decode``) is plain PyTorch in float32 on either device, as the
reference computes it in einsums outside any Pallas kernel.  A decode step
writes its key and value into the cache's slot in place.

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
    "attention_block_decode",
    "attention_block_with_kv",
    "attention_blockwise",
    "attention_decode",
    "attention_full",
    "attention_qkv",
    "glu_ffn",
    "init_attention",
    "init_ffn",
    "init_mla",
    "mla_block",
    "mla_block_decode",
    "mla_block_with_cache",
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


def attention_decode(
    q: torch.Tensor,           # (B, 1, H, D)
    k_cache: torch.Tensor,     # (B, S, Hkv, D)
    v_cache: torch.Tensor,     # (B, S, Hkv, Dv)
    pos: int,                  # current position (cache validity)
    *,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """One decode step against a (possibly windowed) KV cache, in float32.

    Query head h reads KV head ``h // (H / Hkv)`` in place: the grouped
    product sums the same terms as the reference's repeat of the KV heads.
    """
    b, _, h, d = q.shape
    s, hkv, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    scale = scale if scale is not None else d ** -0.5
    qg = q.to(f32).reshape(b, 1, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.to(f32)) * scale
    kpos = torch.arange(s, device=q.device)
    valid = kpos <= pos
    if window > 0:
        valid &= kpos > pos - window
    logits = torch.where(valid, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.to(f32))
    return o.reshape(b, 1, h, dv).to(q.dtype)


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


def _attend(q, k, v, *, causal: bool, window: int, block: int, use_kernel: bool,
            scale: float | None = None) -> torch.Tensor:
    """Full-sequence attention routed by device (module docstring).

    On the card the kernel scales by ``D^-½``; ``scale`` may only restate it
    (MLA's ``(nope + rope)^-½`` is q's own ``D^-½``)."""
    s = q.shape[1]
    if q.is_cuda:
        if window > 0:
            raise NotImplementedError(
                f"window={window}: sliding-window attention on the card is not ported "
                "(the flash_attention kernel has no window; ROADMAP Queue 1 item 9)"
            )
        if scale is not None and scale != q.shape[-1] ** -0.5:
            raise ValueError(f"scale {scale}: the flash_attention kernel scales by D^-1/2")
        return ops.attention(q, k, v, causal=causal, use_kernel=use_kernel)
    if s > 2 * block and s % block == 0:
        return attention_blockwise(q, k, v, causal=causal, window=window, block=block,
                                   scale=scale)
    return attention_full(q, k, v, causal=causal, window=window, scale=scale)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    b, s = o.shape[:2]
    h, hd, d = wo.shape
    return o.reshape(b, s, h * hd) @ wo.reshape(h * hd, d)


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
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = attention_qkv(p, x, cfg, positions)
    o = _attend(q, k, v, causal=causal, window=window, block=block, use_kernel=use_kernel)
    return _out(o, p["wo"])


def attention_block_with_kv(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: int = 0,
    block: int = 1024,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill attention that also returns (k, v) for cache population."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = attention_qkv(p, x, cfg, positions)
    o = _attend(q, k, v, causal=causal, window=window, block=block, use_kernel=use_kernel)
    return _out(o, p["wo"]), k, v


def attention_block_decode(
    p: dict,
    x: torch.Tensor,           # (B, 1, D)
    cache_k: torch.Tensor,     # (B, S, Hkv, Dh)
    cache_v: torch.Tensor,
    pos: int,                  # current position
    cfg: ModelConfig,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step: write the cache's slot in place, attend, project.

    Windowed caches are rings (slot ``pos % S``), full caches absolute
    (slot ``pos``).  The mask is ``slot <= pos`` for both: a ring's slot i
    holds a key iff i <= pos on the first lap and always once wrapped, and
    softmax attention does not depend on the order of its keys (rope was
    applied at write time with absolute positions).
    """
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k, v = attention_qkv(p, x, cfg, positions)
    slot = pos % cache_k.shape[1] if window > 0 else pos
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    o = attention_decode(q, cache_k, cache_v, pos, window=0)
    return _out(o, p["wo"]), cache_k, cache_v


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 latent attention)
# --------------------------------------------------------------------------
def init_mla(generator: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> dict:
    """MLA parameters, with leading axes ``lead``, with the reference's stds."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    lead = tuple(lead)
    dev = generator.device
    std = d ** -0.5
    return {
        "wq_a": _normal(generator, (*lead, d, m.q_lora), std).to(dtype),
        "q_norm": torch.ones((*lead, m.q_lora), dtype=dtype, device=dev),
        "wq_b": _normal(generator, (*lead, m.q_lora, h, m.nope_dim + m.rope_dim),
                        m.q_lora ** -0.5).to(dtype),
        "wkv_a": _normal(generator, (*lead, d, m.kv_lora + m.rope_dim), std).to(dtype),
        "kv_norm": torch.ones((*lead, m.kv_lora), dtype=dtype, device=dev),
        "wkv_b": _normal(generator, (*lead, m.kv_lora, h, m.nope_dim + m.v_dim),
                         m.kv_lora ** -0.5).to(dtype),
        "wo": _normal(generator, (*lead, h, m.v_dim, d), (h * m.v_dim) ** -0.5).to(dtype),
    }


def _mla_latent(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    """The latent cache entries of x: (ckv (B, S, kv_lora), k_pe (B, S, rope))."""
    m = cfg.mla
    ckv_full = x @ p["wkv_a"]                      # (B,S,kv_lora+rope)
    ckv = rms_norm(ckv_full[..., : m.kv_lora], p["kv_norm"], cfg.norm_eps)
    k_pe = rope(ckv_full[..., m.kv_lora:], positions, cfg.rope_theta)
    return ckv, k_pe


def _mla_query(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    """(q_nope (B, S, H, nope), q_pe (B, S, H, rope)), q_pe roped."""
    m = cfg.mla
    cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = _project(cq, p["wq_b"])
    return q[..., : m.nope_dim], rope(q[..., m.nope_dim:], positions, cfg.rope_theta)


def _mla_prefill(p, x, cfg, positions, block, use_kernel):
    """MLA, naive-expansion path: (out, ckv, k_pe).

    On the card the attention is one ``flash_attention`` launch with q and k
    of dim nope + rope and v of dim ``v_dim``, a last-axis slice of the
    up-projected latent; the reference's scale ``(nope + rope)^-½`` is q's
    ``D^-½``, which the kernel applies."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_pe = _mla_query(p, x, cfg, positions)
    ckv, k_pe = _mla_latent(p, x, cfg, positions)
    kv = _project(ckv, p["wkv_b"])
    k_nope, v = kv[..., : m.nope_dim], kv[..., m.nope_dim:]
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, m.rope_dim)], dim=-1)
    qq = torch.cat([q_nope, q_pe], dim=-1)
    scale = (m.nope_dim + m.rope_dim) ** -0.5
    o = _attend(qq, k, v, causal=True, window=0, block=block, use_kernel=use_kernel,
                scale=scale)
    return _out(o, p["wo"]), ckv, k_pe


def mla_block(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,
    block: int = 1024,
    use_kernel: bool = True,
) -> torch.Tensor:
    """MLA attention, naive-expansion path (prefill)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _mla_prefill(p, x, cfg, positions, block, use_kernel)[0]


def mla_block_with_cache(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    block: int = 1024,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLA prefill that also returns the latent cache (ckv, k_pe)."""
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return _mla_prefill(p, x, cfg, positions, block, use_kernel)


def mla_block_decode(
    p: dict,
    x: torch.Tensor,            # (B, 1, D)
    cache_ckv: torch.Tensor,    # (B, S, kv_lora)
    cache_kpe: torch.Tensor,    # (B, S, rope_dim)
    pos: int,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLA decode in the absorbed latent form: the per-head K/V
    up-projections fold into the query (``q_lat = q_nope·wkv_k``) and the
    output (``·wkv_v``), so the cache holds kv_lora + rope values a token.
    Writes the step's latent entries into slot ``pos`` in place."""
    m = cfg.mla
    b = x.shape[0]
    positions = torch.full((b, 1), pos, device=x.device)
    q_nope, q_pe = _mla_query(p, x, cfg, positions)   # (B,1,H,nope), (B,1,H,rope)
    ckv_new, kpe_new = _mla_latent(p, x, cfg, positions)
    cache_ckv[:, pos] = ckv_new[:, 0].to(cache_ckv.dtype)
    cache_kpe[:, pos] = kpe_new[:, 0].to(cache_kpe.dtype)

    wkv_k = p["wkv_b"][..., : m.nope_dim]          # (kv_lora, H, nope)
    wkv_v = p["wkv_b"][..., m.nope_dim:]           # (kv_lora, H, v)
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, wkv_k)  # (B,1,H,kv_lora)

    s = cache_ckv.shape[1]
    scale = (m.nope_dim + m.rope_dim) ** -0.5
    ckv_f = cache_ckv.to(f32)
    logits = (
        torch.einsum("bshl,btl->bhst", q_lat.to(f32), ckv_f)
        + torch.einsum("bshr,btr->bhst", q_pe.to(f32), cache_kpe.to(f32))
    ) * scale
    valid = torch.arange(s, device=x.device) <= pos
    logits = torch.where(valid, logits, -1e30)
    pr = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhst,btl->bshl", pr, ckv_f)                 # (B,1,H,l)
    o = torch.einsum("bshl,lhk->bshk", o_lat, wkv_v.to(f32))          # (B,1,H,v)
    return _out(o.to(x.dtype), p["wo"]), cache_ckv, cache_kpe


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
