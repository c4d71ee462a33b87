"""Serving state: ``repro/models/lm/cache.py`` for the dense, VLM and MoE families.

Cache layouts (a leading layer axis, ``dense0`` first):

* dense / vlm / moe : {"k","v": (L, B, S, Hkv, hd), "pos"}
* deepseek (MLA)    : {"ckv": (L, B, S, kv_lora), "kpe": (L, B, S, rope), "pos"}

``pos`` is a Python int: decode runs eagerly, so the capacity guard reads
it without a synchronisation.  ``decode_step`` writes each layer's slot
``pos`` in place and returns the same dict with ``pos + 1``; prefill
writes each layer's keys and values straight into a cache of ``max_seq``
positions.  The SSM, hybrid and audio caches are not ported (ROADMAP
Queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm.layers import (
    attention_block_decode,
    attention_block_with_kv,
    mla_block_decode,
    mla_block_with_cache,
    rms_norm,
)

__all__ = ["DECODE_RESERVE", "build_prefill_cache", "decode_step", "init_cache"]

# Decode slots reserved past the prefill length when the caller does not pass
# an explicit ``max_seq``.  Positions past ``pos`` are masked in attention, so
# the zero padding never leaks into logits.
DECODE_RESERVE = 64


def _leaves(model) -> dict:
    """Cache leaf -> per-token shape after (L, B, S)."""
    cfg = model.cfg
    if cfg.mla:
        return {"ckv": (cfg.mla.kv_lora,), "kpe": (cfg.mla.rope_dim,)}
    shape = (cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": shape, "v": shape}


def init_cache(model, batch: int, max_seq: int, device=None) -> dict:
    """An empty cache of ``max_seq`` positions on ``device`` (default the card)."""
    dev = resolve_device(device)
    n_layers = model.cfg.n_layers
    cache = {name: torch.zeros((n_layers, batch, max_seq, *shape), dtype=model.dtype,
                               device=dev)
             for name, shape in _leaves(model).items()}
    cache["pos"] = 0
    return cache


# ==========================================================================
# prefill
# ==========================================================================
def _cache_len(s: int, max_seq: int | None) -> int:
    """The reference's ``_pad_seq`` length: ``max_seq`` (default s +
    ``DECODE_RESERVE``), never below the prefill length s."""
    target = s + DECODE_RESERVE if max_seq is None else max_seq
    return max(s, target)


def build_prefill_cache(model, params, tokens, frontend=None, max_seq=None):
    """Run the full-sequence forward, returning (last logits, decode cache).

    ``max_seq`` bounds the total sequence (prefill + decode steps) the cache
    can hold; defaults to ``prefill_len + DECODE_RESERVE``.  The VLM prepends
    ``frontend @ frontend_adapter`` to the token embeddings.
    """
    cfg = model.cfg
    b = tokens.shape[0]
    x = model.embed(params, tokens)
    if cfg.family == "vlm" and frontend is not None:
        fe = frontend.to(model.dtype) @ params["frontend_adapter"]
        x = torch.cat([fe, x], dim=1)
    s = x.shape[1]
    cache = init_cache(model, b, _cache_len(s, max_seq), x.device)
    names = list(_leaves(model))
    for i, bp in enumerate(model.layers(params)):
        x, extra = _prefill_attn_ffn(model, bp, x)
        for name, val in zip(names, extra):
            cache[name][i, :, :s] = val
    cache["pos"] = s
    h_last = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return model.logits_last(params, h_last), cache


def _prefill_attn_ffn(model, bp, x):
    cfg = model.cfg
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if cfg.mla:
        a, c1, c2 = mla_block_with_cache(bp["attn"], h, cfg, block=model.attn_block,
                                         use_kernel=model.use_kernel)
    else:
        a, c1, c2 = attention_block_with_kv(bp["attn"], h, cfg, block=model.attn_block,
                                            use_kernel=model.use_kernel)
    x = x + a
    return x + model._ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps)), (c1, c2)


# ==========================================================================
# decode step
# ==========================================================================
def _check_cache_capacity(pos: int, limit: int) -> None:
    """Refuse writes past the cache's sequence capacity."""
    if pos >= limit:
        raise ValueError(
            f"KV cache exhausted: decode position {pos} >= capacity {limit}; "
            f"re-prefill with a larger max_seq (see cache.DECODE_RESERVE)"
        )


def decode_step(model, params, cache, tokens):
    """tokens (B, 1) -> (logits (B, Vp), the cache updated in place)."""
    cfg = model.cfg
    pos = cache["pos"]
    names = list(_leaves(model))
    _check_cache_capacity(pos, cache[names[0]].shape[2])
    x = model.embed(params, tokens)
    for i, bp in enumerate(model.layers(params)):
        x = _decode_attn_ffn(model, bp, x, *(cache[name][i] for name in names), pos)
    cache["pos"] = pos + 1
    h_last = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return model.logits_last(params, h_last), cache


def _decode_attn_ffn(model, bp, x, c1, c2, pos):
    cfg = model.cfg
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if cfg.mla:
        a, _, _ = mla_block_decode(bp["attn"], h, c1, c2, pos, cfg)
    else:
        a, _, _ = attention_block_decode(bp["attn"], h, c1, c2, pos, cfg)
    x = x + a
    return x + model._ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps))
