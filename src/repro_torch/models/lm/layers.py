"""Transformer layer primitives of the LM: ``repro/models/lm/layers.py``.

Functional, as in the reference: params are nested dicts of tensors, layers
are plain functions.  Full-sequence (prefill) attention, GQA, MLA, sliding
windows and the encoder-decoder's cross attention alike, routes by device:

* on the card it calls ``kernels/flash_attention/ops.attention``, that is
  the ``flash_attention`` CUDA kernel, windowed where the reference's
  attention is (or, under ``use_kernel=False``, its plain version on the
  card);
* on the ``meta`` device (the dry run, ``launch/dryrun.py``) it stands for
  that kernel: one operator with its shapes and FLOPs (``launch/cost.py``);
* on the CPU it calls ``attention_full`` or ``attention_blockwise`` by the
  reference's rule (``s > 2·block and s % block == 0``; cross attention is
  always ``attention_full`` there), so that the CPU tests compare like with
  like.

Decode attention (``attention_decode``, and MLA's absorbed form in
``mla_block_decode``) is plain PyTorch in float32 on either device, as the
reference computes it in einsums outside any Pallas kernel.  A decode step
writes its key and value into the cache's slot in place.

Numerics follow the reference: the model's type (bf16) for parameters,
activations and projections; float32 for norms, rope, softmax logits and
the activation function, each cast back after.

Over a mesh of shards (``sharding.py``), :func:`attention_block_shards` and
:func:`glu_ffn_shards` run the attention block and the GLU FFN tensor-
parallel (Megatron): each shard computes its own heads and its own slice of
``d_ff`` with the plain functions above, and the partial sums of ``wo`` and
``w_down`` are all-reduced over "model".  Where the divisibility guard
replicated the weights, each shard computes the whole block and nothing is
reduced.  Where the query heads are split and the KV heads replicated, a
shard's query heads read the KV heads of their own GQA group
(:func:`kv_heads_of`), and the attention kernel sees the shard's own head
counts.  :func:`mla_block_shards` runs MLA so: each shard computes the
latent and the query's low-rank projection from the replicated leaves, and
its own heads of ``wq_b``, ``wkv_b`` and ``wo``.  :func:`cross_attention_shards`
runs the audio decoder's cross attention so, its keys and values from each
shard's copy of the encoder output.  With a cache sink (the cached prefill)
these blocks also hand over their keys and values.  Decode over the mesh
(:func:`attention_block_decode_shards`, :func:`mla_block_decode_shards`,
:func:`cross_attention_decode_shards`) reads a cache whose sequence is split
over "model": the split-K reduce of the section at the end of this module.
Each ``*_shards`` function is also the LM's unsharded block: with no rules
(``rules`` None, tensor leaves, one input in the list) it runs the plain
function once and calls no collective.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops
from repro_torch.models.lm.sharding import locals_of, own_of, split_dim_of
from repro_torch.numerics import rsqrt

__all__ = [
    "attention_block",
    "attention_block_decode",
    "attention_block_decode_shards",
    "attention_block_shards",
    "attention_block_with_kv",
    "attention_blockwise",
    "attention_decode",
    "attention_full",
    "attention_qkv",
    "cross_attention_decode",
    "cross_attention_decode_shards",
    "cross_attention_shards",
    "cross_attention_with_kv",
    "glu_ffn",
    "glu_ffn_shards",
    "init_attention",
    "init_ffn",
    "init_mla",
    "kv_heads_of",
    "mla_block",
    "mla_block_shards",
    "mla_block_decode",
    "mla_block_decode_shards",
    "mla_block_with_cache",
    "rms_norm",
    "rope",
    "shard_dicts",
]

f32 = torch.float32


# --------------------------------------------------------------------------
# Norms / positional
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · w`` in float32, the scale from
    ``numerics.rsqrt``."""
    xf = x.to(f32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * rsqrt(var + eps)) * w.to(f32)).to(x.dtype)


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


def _grouped_logits(q: torch.Tensor, k_cache: torch.Tensor, scale: float | None = None):
    """(B, 1, H, D) queries against (B, S, Hkv, D) keys in float32: the
    (B, Hkv, H / Hkv, 1, S) logits, scaled by ``scale`` (default D^-½)."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.to(f32).reshape(b, 1, hkv, h // hkv, d)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.to(f32)) * scale


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
    b, _, h, _ = q.shape
    s, dv = k_cache.shape[1], v_cache.shape[3]
    logits = _grouped_logits(q, k_cache, scale)
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
    """Full-sequence attention routed by device (module docstring); on the
    CPU ``block=0`` always takes ``attention_full``.

    On the card the kernel scales by ``D^-½``; ``scale`` may only restate it
    (MLA's ``(nope + rope)^-½`` is q's own ``D^-½``)."""
    s = q.shape[1]
    if q.is_meta:  # the dry run's trace of the card: the kernel as one operator
        from repro_torch.launch.cost import meta_attention

        return meta_attention(q, k, v, causal=causal, window=window)
    if q.is_cuda:
        if scale is not None and scale != q.shape[-1] ** -0.5:
            raise ValueError(f"scale {scale}: the flash_attention kernel scales by D^-1/2")
        return ops.attention(q, k, v, causal=causal, window=window, use_kernel=use_kernel)
    if block and s > 2 * block and s % block == 0:
        return attention_blockwise(q, k, v, causal=causal, window=window, block=block,
                                   scale=scale)
    return attention_full(q, k, v, causal=causal, window=window, scale=scale)


def _read_heads(k, v, kv_heads) -> tuple:
    """k and v narrowed to the KV heads ``kv_heads`` (all where None)."""
    if kv_heads is None:
        return k, v
    return (_select_heads(k, kv_heads, -2).contiguous(),
            _select_heads(v, kv_heads, -2).contiguous())


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
    return attention_block_with_kv(p, x, cfg, causal=causal, positions=positions, window=window,
                                   block=block, use_kernel=use_kernel)[0]


def attention_block_with_kv(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    positions: torch.Tensor | None = None,
    window: int = 0,
    block: int = 1024,
    use_kernel: bool = True,
    kv_heads=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill attention that also returns (k, v) for cache population;
    ``kv_heads`` (a slice or index of ``p``'s KV heads) are the ones the
    query heads read, where ``p`` holds more (:func:`attention_block_shards`)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = attention_qkv(p, x, cfg, positions)
    o = _attend(q, *_read_heads(k, v, kv_heads), causal=causal, window=window, block=block,
                use_kernel=use_kernel)
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


def cross_attention_with_kv(
    p: dict,
    x: torch.Tensor,           # (B, S, D) decoder states
    enc_out: torch.Tensor,     # (B, S_enc, D) encoder output
    *,
    use_kernel: bool = True,
    kv_heads=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``LM._cross_attention`` (projections without bias,
    norm or rope; no mask), also returning the encoder-side (k, v) that the
    reference's prefill computes again for its cross cache; ``kv_heads`` as
    in :func:`attention_block_with_kv`."""
    q = _project(x, p["wq"])
    k = _project(enc_out, p["wk"])
    v = _project(enc_out, p["wv"])
    o = _attend(q, *_read_heads(k, v, kv_heads), causal=False, window=0, block=0,
                use_kernel=use_kernel)
    return _out(o, p["wo"]), k, v


def cross_attention_decode(p: dict, x: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor) -> torch.Tensor:
    """One decode position (B, 1, D) against the cross cache (B, S_enc, Hkv, hd)."""
    o = attention_decode(_project(x, p["wq"]), ck, cv, ck.shape[1] - 1)
    return _out(o, p["wo"])


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
    """MLA, naive-expansion path: (out, ckv, k_pe), over the heads that
    ``p``'s ``wq_b``, ``wkv_b`` and ``wo`` hold.

    On the card the attention is one ``flash_attention`` launch with q and k
    of dim nope + rope and v of dim ``v_dim``, a last-axis slice of the
    up-projected latent; the reference's scale ``(nope + rope)^-½`` is q's
    ``D^-½``, which the kernel applies."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_pe = _mla_query(p, x, cfg, positions)
    ckv, k_pe = _mla_latent(p, x, cfg, positions)
    kv = _project(ckv, p["wkv_b"])
    h = kv.shape[2]  # the heads of p (a shard's own, over a mesh)
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

    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, p["wkv_b"][..., : m.nope_dim])  # (B,1,H,l)

    s = cache_ckv.shape[1]
    ckv_f = cache_ckv.to(f32)
    logits = _mla_logits(q_lat, q_pe, ckv_f, cache_kpe, cfg)
    valid = torch.arange(s, device=x.device) <= pos
    logits = torch.where(valid, logits, -1e30)
    pr = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhst,btl->bshl", pr, ckv_f)                 # (B,1,H,l)
    return _mla_value_out(p, o_lat, x.dtype, cfg), cache_ckv, cache_kpe


def _mla_logits(q_lat, q_pe, ckv_f, kpe, cfg: ModelConfig) -> torch.Tensor:
    """The absorbed decode's float32 logits (B, H, 1, S) of the latent
    queries ``q_lat`` (B, 1, H, kv_lora) and ``q_pe`` (B, 1, H, rope)
    against the cached ``ckv_f`` (float32) and ``kpe``."""
    m = cfg.mla
    return (torch.einsum("bshl,btl->bhst", q_lat.to(f32), ckv_f)
            + torch.einsum("bshr,btr->bhst", q_pe.to(f32), kpe.to(f32))
            ) * (m.nope_dim + m.rope_dim) ** -0.5


def _mla_value_out(p: dict, o_lat: torch.Tensor, dtype, cfg: ModelConfig) -> torch.Tensor:
    """The latent output (B, 1, H, kv_lora) through ``p``'s heads' value-up
    projection (``wkv_v``) and ``wo``."""
    o = torch.einsum("bshl,lhk->bshk", o_lat, p["wkv_b"][..., cfg.mla.nope_dim:].to(f32))
    return _out(o.to(dtype), p["wo"])


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


# --------------------------------------------------------------------------
# Over a mesh of shards (tensor parallel), or one shard (no rules)
# --------------------------------------------------------------------------
def kv_heads_of(first: int, n: int, group: int):
    """The KV heads that the query heads ``first .. first + n - 1`` read under
    GQA with ``group`` query heads a KV head: a slice where they cover whole
    groups or lie in one, else one KV head index a query head."""
    if n % group == 0 and first % group == 0:
        return slice(first // group, (first + n) // group)
    if group % n == 0 and first % n == 0:
        return slice(first // group, first // group + 1)
    return torch.arange(first, first + n) // group


def _select_heads(w: torch.Tensor, heads, dim: int) -> torch.Tensor:
    if isinstance(heads, slice):
        return w.narrow(dim % w.dim(), heads.start, heads.stop - heads.start)
    return w.index_select(dim, heads.to(w.device))


def shard_dicts(p: dict) -> list:
    """One dict of leaves a shard, in the mesh's order, from a dict of
    ``sharding.Sharded`` leaves (each shard's tensors, ``locals_of``); ``[p]``
    for a dict of tensors (one shard)."""
    leaves = {name: locals_of(leaf) for name, leaf in p.items()}
    n = len(next(iter(leaves.values())))
    return [{name: blocks[i] for name, blocks in leaves.items()} for i in range(n)]


def _kv_layout(rules, p: dict) -> tuple[bool, bool, list]:
    """Whether ``p``'s query heads and KV heads are split over "model", and
    each shard's KV heads, in the whole leaf's numbering, that its query heads
    read: its own block where the KV heads are split; where the guard
    replicated them, those of its query heads' GQA groups
    (:func:`kv_heads_of`); all of them (None) where the query heads are
    whole, and on the one shard of no rules."""
    if rules is None:
        return False, False, [None]
    mesh, tp_axis = rules.mesh, rules.tp_axis
    q_split = p["wq"].split_dim() is not None
    kv_split = p["wk"].split_dim() is not None
    hp, hkv = p["wq"].shape[-2], p["wk"].shape[-2]
    tp = mesh.axis_size(tp_axis)
    h_loc, kv_loc = (hp // tp if q_split else hp), (hkv // tp if kv_split else hkv)
    heads = []
    for coord in mesh.coords:
        i = mesh.axis_index(coord, tp_axis)
        if kv_split:
            heads.append(slice(i * kv_loc, (i + 1) * kv_loc))
        elif q_split:
            heads.append(kv_heads_of(i * h_loc, h_loc, hp // hkv))
        else:
            heads.append(None)
    return q_split, kv_split, heads


def _head_locals(rules, p: dict, *, whole_kv: bool = False) -> tuple[list, bool, list | None]:
    """Each shard's attention leaves (one dict a shard) from ``p``'s
    ``sharding.Sharded`` leaves: its own query heads, and its own KV heads
    where they are split, else the KV heads that its query heads read (the
    guard replicated them); whether the query heads are split; and where
    ``whole_kv`` keeps every replicated KV head in the leaves (a cache stores
    them all), the heads that each shard's query heads read among them
    (None where the leaves hold just those).  With no rules: ``[p]``."""
    if rules is None:
        return [p], False, None
    q_split, kv_split, heads = _kv_layout(rules, p)
    narrow = q_split and not kv_split
    locs = shard_dicts(p)
    if narrow and not whole_kv:
        for loc, sel in zip(locs, heads):
            for name, dim in (("wk", -2), ("wv", -2), ("bk", 0), ("bv", 0)):
                if name in loc:
                    loc[name] = _select_heads(loc[name], sel, dim)
    return locs, q_split, (heads if narrow and whole_kv else None)


def _reduce_heads(rules, outs: list, split: bool) -> list:
    """The ``wo`` (or ``w_down``) partial sums all-reduced over "model" where
    the heads (or ``d_ff``) are ``split``; else each shard's whole output."""
    if not split:
        return outs
    from repro_torch.models.lm.collectives import all_reduce_sum

    return all_reduce_sum(outs, rules.mesh, rules.tp_axis)


def attention_block_shards(rules, p: dict, hs: list, cfg: ModelConfig, *, causal: bool = True,
                           window: int = 0, block: int = 1024, use_kernel: bool = True,
                           sink=None) -> list:
    """:func:`attention_block` over the shards of ``rules.mesh``: ``p`` holds
    ``sharding.Sharded`` leaves, ``hs`` one input a shard; returns one output a
    shard, all-reduced over "model" where the heads are split.  With no rules
    (``rules`` None, ``p`` tensors, ``hs`` one input) it is the one shard.

    With a cache ``sink`` (the cached prefill, ``cache.CacheSink``) each
    shard also hands it its keys and values: its own KV heads where they are
    split (re-split over the sequence there), else every KV head, projected
    from the replicated weights (the attention reads its group's among
    them)."""
    locs, q_split, sel = _head_locals(rules, p, whole_kv=sink is not None)
    outs, ks, vs = [], [], []
    for n, (loc, h) in enumerate(zip(locs, hs)):
        o, k, v = attention_block_with_kv(loc, h, cfg, causal=causal, window=window,
                                          block=block, use_kernel=use_kernel,
                                          kv_heads=None if sel is None else sel[n])
        outs.append(o)
        ks.append(k)
        vs.append(v)
    if sink is not None:
        kv_split = split_dim_of(p["wk"]) is not None
        sink.put_seq("k", ks, heads_split=kv_split)
        sink.put_seq("v", vs, heads_split=kv_split)
    return _reduce_heads(rules, outs, q_split)


def cross_attention_shards(rules, p: dict, hs: list, enc_outs: list, *,
                           use_kernel: bool = True, sink=None) -> list:
    """:func:`cross_attention_with_kv` over the shards of ``rules.mesh`` (or
    the one shard of no rules): each shard's query heads from its decoder
    states ``hs``, their keys and values from its copy of the encoder output
    ``enc_outs`` (replicated over "model"), one non-causal attention a shard
    at its head count, and the ``wo`` partial sums all-reduced over "model"
    where the heads are split.  A cache ``sink`` gets the encoder-side keys
    and values (``ck``, ``cv``, replicated: gathered over the heads and rows
    that the shards split)."""
    locs, q_split, sel = _head_locals(rules, p, whole_kv=sink is not None)
    outs, ks, vs = [], [], []
    for n, (loc, h, e) in enumerate(zip(locs, hs, enc_outs)):
        o, k, v = cross_attention_with_kv(loc, h, e, use_kernel=use_kernel,
                                          kv_heads=None if sel is None else sel[n])
        outs.append(o)
        ks.append(k)
        vs.append(v)
    if sink is not None:
        kv_split = split_dim_of(p["wk"]) is not None
        sink.put_whole("ck", ks, heads_split=kv_split)
        sink.put_whole("cv", vs, heads_split=kv_split)
    return _reduce_heads(rules, outs, q_split)


def glu_ffn_shards(rules, p: dict, hs: list, act: str) -> list:
    """:func:`glu_ffn` over the shards of ``rules.mesh`` (or the one shard of
    no rules): each shard its slice of ``d_ff``, the ``w_down`` partial sums
    all-reduced over "model"."""
    outs = [glu_ffn(loc, h, act) for loc, h in zip(shard_dicts(p), hs)]
    return _reduce_heads(rules, outs, split_dim_of(p["w_down"]) is not None)


def mla_block_shards(rules, p: dict, hs: list, cfg: ModelConfig, *, block: int = 1024,
                     use_kernel: bool = True, sink=None) -> list:
    """:func:`mla_block` over the shards of ``rules.mesh`` (or the one shard
    of no rules): each shard its own heads of ``wq_b``, ``wkv_b`` and ``wo``
    (one attention launch at the shard's head count), the ``wo`` partial
    sums all-reduced over "model" where the heads are split.  A cache
    ``sink`` gets the latent ``ckv`` and ``kpe``, which every shard computes
    whole from the replicated ``wkv_a``."""
    outs, ckvs, kpes = [], [], []
    for loc, h in zip(shard_dicts(p), hs):
        if sink is None:
            outs.append(mla_block(loc, h, cfg, block=block, use_kernel=use_kernel))
            continue
        o, ckv, kpe = mla_block_with_cache(loc, h, cfg, block=block, use_kernel=use_kernel)
        outs.append(o)
        ckvs.append(ckv)
        kpes.append(kpe)
    if sink is not None:
        sink.put_seq("ckv", ckvs, heads_split=False)
        sink.put_seq("kpe", kpes, heads_split=False)
    return _reduce_heads(rules, outs, split_dim_of(p["wo"]) is not None)


# --------------------------------------------------------------------------
# Decode over a mesh of shards: the cached sequence split over "model"
# --------------------------------------------------------------------------
# The cache (``sharding.cache_pspecs``) holds each shard's block of the
# sequence for every head, so a decode step is the reference's split-K
# (FlashDecoding) reduction: the step's queries (and its key and value) are
# all-gathered over "model", tiny at one token; the shard whose block holds
# the step's slot writes the key and value there; every shard computes the
# softmax of all heads over its own slots in float32 (the slots after ``pos``
# at the finite −1e30), its output against its values, its maximum and its
# Σexp; an all-reduce of the maxima gives each partial its weight
# ``Σexp · exp(max − global max)``, an all-reduce of those the total, and an
# all-reduce of the weighted outputs the result.  A shard with no live slot
# yet weighs exactly 0.  Where the sequence is one block (no rules, or a
# model axis of one) one shard's softmax is the whole softmax: each shard
# runs the unsharded step on its rows and no combine is made.  Each shard
# keeps its own heads' block of the result for its rows of ``wo``,
# all-reduced as in the prefill.
def _seq_whole(rules) -> bool:
    """Whether every shard holds the whole cached sequence."""
    return rules is None or rules.tp == 1


def _write_slot(blocks: list, offsets: list, slot: int, new: list) -> None:
    """Each shard's ``new`` (B_loc, ...) into its cache block (B_loc, S_loc,
    ...) at ``slot`` of the whole sequence, by the shard whose block holds
    the slot (``offsets``: each block's first slot)."""
    for blk, off, x in zip(blocks, offsets, new):
        if off <= slot < off + blk.shape[1]:
            blk[:, slot - off] = x.to(blk.dtype)


def _global_max(rules, ms: list) -> list:
    """The partials' maxima over "model"."""
    from repro_torch.models.lm.collectives import all_reduce_max

    return all_reduce_max(ms, rules.mesh, rules.tp_axis)


def _split_k_sum(rules, parts: list) -> list:
    """The partials' weights, or weighted outputs, summed over "model"."""
    from repro_torch.models.lm.collectives import all_reduce_sum

    return all_reduce_sum(parts, rules.mesh, rules.tp_axis)


def _partial(logits: torch.Tensor, first: int, pos: int, values: torch.Tensor, eq: str) -> tuple:
    """One shard's partial over its slots ``first ..`` (the last dim of
    ``logits``): (max, Σexp, the softmax's output against ``values`` by the
    einsum ``eq``), the slots after ``pos`` masked."""
    slots = first + torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(slots <= pos, logits, -1e30)
    m = logits.amax(dim=-1)
    total = torch.exp(logits - m[..., None]).sum(dim=-1)
    return m, total, torch.einsum(eq, torch.softmax(logits, dim=-1), values)


def _split_k_combine(rules, partials: list, align) -> list:
    """FlashDecoding's reduce over "model" of one (max, Σexp, output)
    partial a shard: the outputs weighted by ``Σexp · exp(max − global
    max)`` over the weights' total (``align`` moves a weight to the output's
    layout) and summed."""
    ms = _global_max(rules, [m for m, _, _ in partials])
    ws = [t * torch.exp(m_loc - m) for (m_loc, t, _), m in zip(partials, ms)]
    totals = _split_k_sum(rules, ws)
    return _split_k_sum(rules, [o * align(w / t) for (_, _, o), w, t in zip(partials, ws, totals)])


def _own_heads(rules, o: list, h_loc: int, q_split: bool) -> list:
    """Each shard's block of ``h_loc`` heads (dim 2) of a whole-head output."""
    if not q_split:
        return o
    mesh = rules.mesh
    return [x.narrow(2, mesh.axis_index(c, rules.tp_axis) * h_loc, h_loc)
            for x, c in zip(o, mesh.coords)]


def attention_block_decode_shards(rules, p: dict, hs: list, cache_k, cache_v, pos: int,
                                  cfg: ModelConfig, *, window: int = 0) -> list:
    """:func:`attention_block_decode` over the shards of ``rules.mesh``:
    ``hs`` one (B_loc, 1, D) input a shard; ``cache_k``, ``cache_v`` one
    layer's ``sharding.Sharded`` (B, S, Hkv, hd) leaves, S split over
    "model", written in place (slot ``pos``, or ``pos % S`` for a
    ``window``'s ring).  The split-K reduce above; where the guard
    replicated the KV heads, every shard computes the step's KV heads from
    the replicated weights.  With no rules (tensors, one input) it is
    :func:`attention_block_decode`'s step."""
    locs, q_split, _ = _head_locals(rules, p, whole_kv=True)
    if _seq_whole(rules):
        outs = [attention_block_decode(loc, h, kc, vc, pos, cfg, window=window)[0]
                for loc, h, kc, vc in zip(locs, hs, own_of(cache_k), own_of(cache_v))]
        return _reduce_heads(rules, outs, q_split)
    from repro_torch.models.lm.collectives import all_gather

    mesh, tp_axis = rules.mesh, rules.tp_axis
    qs, kvs = [], []
    for loc, h in zip(locs, hs):
        positions = torch.full((h.shape[0], 1), pos, device=h.device)
        q, k, v = attention_qkv(loc, h, cfg, positions)
        qs.append(q)
        kvs.append(torch.stack([k[:, 0], v[:, 0]]))       # (2, B_loc, Hkv_loc, hd)
    h_loc = qs[0].shape[2]
    if q_split:
        qs = all_gather(qs, mesh, tp_axis, dim=2)
    if p["wk"].split_dim() is not None:
        kvs = all_gather(kvs, mesh, tp_axis, dim=2)
    kb, vb = cache_k.own(), cache_v.own()
    offs = cache_k.offsets(1)
    slot = pos % cache_k.shape[1] if window > 0 else pos
    _write_slot(kb, offs, slot, [kv[0] for kv in kvs])
    _write_slot(vb, offs, slot, [kv[1] for kv in kvs])
    partials = [_partial(_grouped_logits(q, kc), off, pos, vc.to(f32), "bhgqk,bkhd->bqhgd")
                for q, kc, vc, off in zip(qs, kb, vb, offs)]
    outs = []
    # a weight (B, Hkv, g, 1) against an output (B, 1, Hkv, g, dv)
    for o, q in zip(_split_k_combine(rules, partials, lambda w: w.permute(0, 3, 1, 2)[..., None]),
                    qs):
        b, _, h, _ = q.shape
        outs.append(o.reshape(b, 1, h, -1).to(q.dtype))
    outs = [_out(o, loc["wo"]) for o, loc in zip(_own_heads(rules, outs, h_loc, q_split), locs)]
    return _reduce_heads(rules, outs, q_split)


def mla_block_decode_shards(rules, p: dict, hs: list, cache_ckv, cache_kpe, pos: int,
                            cfg: ModelConfig) -> list:
    """:func:`mla_block_decode` over the shards of ``rules.mesh``, the latent
    ``cache_ckv`` (B, S, kv_lora) and ``cache_kpe`` (B, S, rope) split over
    "model" along S.  Each shard forms its heads' absorbed queries
    (``q_nope · wkv_k``) and ``q_pe``, all-gathered over "model"; every shard
    computes the step's latent entries from the replicated ``wkv_a`` and the
    owner of slot ``pos`` writes them; the split-K reduce gives every head's
    latent output, of which each shard applies its heads' value-up
    projection and rows of ``wo``, all-reduced over "model".  With no rules
    it is :func:`mla_block_decode`'s step."""
    locs = shard_dicts(p)
    q_split = split_dim_of(p["wq_b"]) is not None
    if _seq_whole(rules):
        outs = [mla_block_decode(loc, h, ckv, kpe, pos, cfg)[0]
                for loc, h, ckv, kpe in zip(locs, hs, own_of(cache_ckv), own_of(cache_kpe))]
        return _reduce_heads(rules, outs, q_split)
    from repro_torch.models.lm.collectives import all_gather

    mesh, tp_axis = rules.mesh, rules.tp_axis
    m = cfg.mla
    qs, latents = [], []
    for loc, h in zip(locs, hs):
        positions = torch.full((h.shape[0], 1), pos, device=h.device)
        q_nope, q_pe = _mla_query(loc, h, cfg, positions)      # (B,1,H_loc,nope), (B,1,H_loc,rope)
        q_lat = torch.einsum("bshk,lhk->bshl", q_nope, loc["wkv_b"][..., : m.nope_dim])
        qs.append(torch.cat([q_lat.to(f32), q_pe.to(f32)], dim=-1))
        latents.append(_mla_latent(loc, h, cfg, positions))
    h_loc = qs[0].shape[2]
    if q_split:
        qs = all_gather(qs, mesh, tp_axis, dim=2)
    cb, kb = cache_ckv.own(), cache_kpe.own()
    offs = cache_ckv.offsets(1)
    _write_slot(cb, offs, pos, [c[:, 0] for c, _ in latents])
    _write_slot(kb, offs, pos, [k[:, 0] for _, k in latents])
    partials = []
    for q, ckv, kpe, off in zip(qs, cb, kb, offs):
        ckv_f = ckv.to(f32)
        logits = _mla_logits(q[..., : m.kv_lora], q[..., m.kv_lora:], ckv_f, kpe, cfg)
        partials.append(_partial(logits, off, pos, ckv_f, "bhst,btl->bshl"))
    # a weight (B, H, 1) against an output (B, 1, H, kv_lora)
    o_lat = _split_k_combine(rules, partials, lambda w: w.transpose(1, 2)[..., None])
    outs = [_mla_value_out(loc, o, h.dtype, cfg)
            for o, loc, h in zip(_own_heads(rules, o_lat, h_loc, q_split), locs, hs)]
    return _reduce_heads(rules, outs, q_split)


def cross_attention_decode_shards(rules, p: dict, hs: list, ck, cv, batch_split: bool) -> list:
    """:func:`cross_attention_decode` over the shards of ``rules.mesh`` (or
    the one shard of no rules), the cross cache ``ck``, ``cv`` (B, S_enc,
    Hkv, hd) replicated: each shard's query heads against the KV heads they
    read, on its rows (where the batch is split over the data axes), the
    ``wo`` partial sums all-reduced over "model" where the heads are split."""
    locs, q_split, _ = _head_locals(rules, p, whole_kv=True)
    _, _, heads = _kv_layout(rules, p)
    outs = []
    for n, (loc, h, kc, vc, sel) in enumerate(zip(locs, hs, own_of(ck), own_of(cv), heads)):
        b = h.shape[0]
        if batch_split and kc.shape[0] != b:
            row = rules.mesh.axis_index(rules.mesh.coords[n], rules.axis("batch")) * b
            kc, vc = kc.narrow(0, row, b), vc.narrow(0, row, b)
        outs.append(cross_attention_decode(loc, h, *_read_heads(kc, vc, sel)))
    return _reduce_heads(rules, outs, q_split)
