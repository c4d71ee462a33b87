"""Serving state: ``repro/models/lm/cache.py``, all six families.

Cache layouts (leading stacked-layer axes first):

* dense / vlm / moe : {"k","v": (L, B, S, Hkv, hd), "pos"}
* deepseek (MLA)    : {"ckv": (L, B, S, kv_lora), "kpe": (L, B, S, rope), "pos"}
* hybrid (zamba2)   : {"conv": (G, per, B, K-1, C), "ssm": (G, per, B, H, N, P)
                       float32, "k","v": (G, B, W, Hkv, hd), "pos"}: a ring of
                       W slots for the shared attention block
* ssm (xlstm)       : {"mC": (G, M, B, H, P, P), "mn", "mm", "sc", "sn", "sm",
                       "sh", "pos"}, float32
* audio (seamless)  : {"k","v": self-attention, "ck","cv": (L, B, S_enc, Hkv,
                       hd), "pos"}

``pos`` is a Python int: decode runs eagerly, so the capacity guard reads
it without a synchronisation.  The guard covers the absolute-slot caches
(dense, VLM, MoE, audio) only, as in the reference: the hybrid's ring wraps
and the xLSTM's state is O(1).  ``decode_step`` writes each layer's slot or
state in place and returns the same dict with ``pos + 1``; prefill writes
each layer's keys, values and states straight into the cache.

The hybrid's ring is the reference's, quirks included: prefill sizes it to
``w = min(sliding_window or S, S)`` and keeps the last w keys, and decode
writes slot ``pos % w``.  So below the window (S < W) the first decode
step overwrites position 0, and past it with S % W ≠ 0 the slots are
misaligned with ``pos % W``; ``init_cache`` sizes its ring by ``max_seq``
instead (ROADMAP Queue 3).

Over a mesh of shards (under ``sharding.use_rules``, with the parameters of
``sharding.shard_params``) the cache is a dict of ``sharding.Sharded`` leaves
placed leaf for leaf by ``cache_pspecs`` (the batch on the data axes where
it divides, the cached sequence of every k, v, ``ckv`` and ``kpe`` on
"model", the SSM and conv states split as the spec says, ``ck``, ``cv``
whole) and the Python int ``pos``; ``sharding.gather_cache`` gives the
layout above again.  ``init_cache`` places an empty one; the cached prefill
is the model's own forward over the mesh (``LM._forward_shards``) with a
:class:`CacheSink`, to which each block hands its keys, values or final
states; :func:`decode_step` runs the blocks' decode over the shards
(``layers.attention_block_decode_shards`` and its MLA and cross-attention
siblings, the split-K reduce over "model"; ``ssm.*_decode_shards``).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import ssm as ssm_lib
from repro_torch.models.lm.collectives import all_gather, all_to_all
from repro_torch.models.lm.layers import (
    attention_block_decode,
    attention_block_decode_shards,
    attention_block_with_kv,
    cross_attention_decode,
    cross_attention_decode_shards,
    cross_attention_with_kv,
    glu_ffn,
    glu_ffn_shards,
    mla_block_decode,
    mla_block_decode_shards,
    mla_block_with_cache,
    rms_norm,
)
from repro_torch.models.lm.model import stacked
from repro_torch.models.lm.sharding import Sharded, active_rules, empty_cache, split_batch

__all__ = ["DECODE_RESERVE", "CacheSink", "build_prefill_cache", "decode_step", "init_cache"]

f32 = torch.float32
# Decode slots reserved past the prefill length when the caller does not pass
# an explicit ``max_seq``.  Positions past ``pos`` are masked in attention, so
# the zero padding never leaks into logits.
DECODE_RESERVE = 64


def _leaves(model, batch: int, max_seq: int) -> dict:
    """Cache leaf -> (shape, type, fill) of an empty cache (the reference's
    ``init_cache``)."""
    cfg, dt = model.cfg, model.dtype
    fam = cfg.family
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    if fam == "hybrid":
        s = cfg.ssm
        per = cfg.attn_every
        g = cfg.n_layers // per
        di = s.expand * cfg.d_model
        w = min(cfg.sliding_window or max_seq, max_seq)
        return {"conv": ((g, per, batch, s.d_conv - 1, di + 2 * s.d_state), dt, 0.0),
                "ssm": ((g, per, batch, di // s.head_dim, s.d_state, s.head_dim), f32, 0.0),
                "k": ((g, batch, w, *kv), dt, 0.0), "v": ((g, batch, w, *kv), dt, 0.0)}
    if fam == "ssm":
        s = cfg.ssm
        g, m = cfg.n_layers // s.slstm_every, s.slstm_every - 1
        h, d = cfg.n_heads, cfg.d_model
        p_dim = s.expand * d // h
        return {"mC": ((g, m, batch, h, p_dim, p_dim), f32, 0.0),
                "mn": ((g, m, batch, h, p_dim), f32, 0.0),
                "mm": ((g, m, batch, h), f32, -1e30),
                "sc": ((g, batch, d), f32, 0.0), "sn": ((g, batch, d), f32, 0.0),
                "sm": ((g, batch, d), f32, -1e30), "sh": ((g, batch, d), f32, 0.0)}
    n_layers = cfg.n_layers
    if cfg.mla:
        per_token = {"ckv": (cfg.mla.kv_lora,), "kpe": (cfg.mla.rope_dim,)}
    else:
        per_token = {"k": kv, "v": kv}
    leaves = {name: ((n_layers, batch, max_seq, *shape), dt, 0.0)
              for name, shape in per_token.items()}
    if fam == "audio":
        enc = (n_layers, batch, cfg.n_frontend_tokens, *kv)
        leaves.update(ck=(enc, dt, 0.0), cv=(enc, dt, 0.0))
    return leaves


def init_cache(model, batch: int, max_seq: int, device=None) -> dict:
    """An empty cache of ``max_seq`` positions on ``device`` (default the
    card); under sharding rules placed on their mesh's devices instead
    (``device`` unused)."""
    rules = active_rules()
    if rules is not None:
        cache = empty_cache(rules, _leaves(model, batch, max_seq), batch)
        cache["pos"] = 0
        return cache
    dev = resolve_device(device)
    cache = {name: torch.full(shape, fill, dtype=dtype, device=dev)
             for name, (shape, dtype, fill) in _leaves(model, batch, max_seq).items()}
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

    ``max_seq`` bounds the total sequence (prefill + decode steps) that an
    absolute-slot cache can hold; defaults to ``prefill_len +
    DECODE_RESERVE``.  The VLM prepends ``frontend @ frontend_adapter`` to
    the token embeddings; the audio family encodes ``frontend`` and
    attends to it.  The SSM and hybrid families ignore ``max_seq``.  Under
    sharding rules the forward runs over their mesh and the cache is placed
    by ``cache_pspecs`` (:func:`_prefill_shards`).
    """
    rules = active_rules()
    if rules is not None:
        return _prefill_shards(model, rules, params, tokens, frontend, max_seq)
    cfg = model.cfg
    x = model.embed(params, tokens)
    if cfg.family == "vlm" and frontend is not None:
        fe = frontend.to(model.dtype) @ params["frontend_adapter"]
        x = torch.cat([fe, x], dim=1)
    prefill = {"ssm": _prefill_ssm, "hybrid": _prefill_hybrid, "audio": _prefill_audio}.get(
        cfg.family, _prefill_attn)
    x, cache = prefill(model, params, x, frontend, max_seq)
    cache["pos"] = x.shape[1]
    h_last = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return model.logits_last(params, h_last), cache


def _prefill_attn(model, params, x, frontend, max_seq):
    b, s = x.shape[:2]
    cache = init_cache(model, b, _cache_len(s, max_seq), x.device)
    names = [n for n in cache if n != "pos"]
    for i, bp in enumerate(model.layers(params)):
        x, extra = _prefill_attn_ffn(model, bp, x)
        for name, val in zip(names, extra):
            cache[name][i, :, :s] = val
    return x, cache


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


def _shared_block(model, shared, x, attend):
    """The hybrid's shared attention + FFN block; ``attend(h)`` gives the
    attention's (out, k, v)."""
    cfg = model.cfg
    a, k, v = attend(rms_norm(x, shared["ln1"], cfg.norm_eps))
    x = x + a
    return x + glu_ffn(shared["ffn"], rms_norm(x, shared["ln2"], cfg.norm_eps), cfg.act), k, v


def _prefill_hybrid(model, params, x, frontend, max_seq):
    cfg = model.cfg
    eps = cfg.norm_eps
    b, s = x.shape[:2]
    # the reference's ring: the last w keys, w = min(window or s, s) (module docstring)
    w = min(cfg.sliding_window or s, s)
    cache = {name: torch.empty(shape, dtype=dtype, device=x.device)
             for name, (shape, dtype, _) in _leaves(model, b, w).items()}
    shared = params["shared_block"]
    attend = lambda h: attention_block_with_kv(  # noqa: E731
        shared["attn"], h, cfg, window=cfg.sliding_window, block=model.attn_block,
        use_kernel=model.use_kernel)
    for g, (mamba, _) in enumerate(model.groups(params)):
        for j, mp in enumerate(stacked(mamba)):
            out, ssm_state, conv_tail = ssm_lib.mamba2_block(
                mp["cell"], rms_norm(x, mp["ln"], eps), cfg, return_state=True)
            x = x + out
            cache["ssm"][g, j] = ssm_state
            cache["conv"][g, j] = conv_tail
        x, k, v = _shared_block(model, shared, x, attend)
        cache["k"][g] = k[:, -w:]
        cache["v"][g] = v[:, -w:]
    return x, cache


def _prefill_ssm(model, params, x, frontend, max_seq):
    cfg = model.cfg
    eps = cfg.norm_eps
    cache = {name: torch.empty(shape, dtype=dtype, device=x.device)
             for name, (shape, dtype, _) in _leaves(model, x.shape[0], x.shape[1]).items()}
    for g, (mlstm, slstm) in enumerate(model.groups(params)):
        for j, mp in enumerate(stacked(mlstm)):
            out, state = ssm_lib.mlstm_block(mp["cell"], rms_norm(x, mp["ln"], eps), cfg,
                                             return_state=True)
            x = x + out
            for name, val in zip(("mC", "mn", "mm"), state):
                cache[name][g, j] = val
        out, state = ssm_lib.slstm_block(slstm["cell"], rms_norm(x, slstm["ln"], eps), cfg,
                                         return_state=True)
        x = x + out
        for name, val in zip(("sc", "sn", "sm", "sh"), state):
            cache[name][g] = val
    return x, cache


def _prefill_audio(model, params, x, frontend, max_seq):
    cfg = model.cfg
    eps = cfg.norm_eps
    b, s = x.shape[:2]
    enc_out = model._encode(params, frontend)
    cache = init_cache(model, b, _cache_len(s, max_seq), x.device)
    enc_shape = (cfg.n_layers, *enc_out.shape[:2], *cache["ck"].shape[3:])
    cache["ck"], cache["cv"] = (torch.empty(enc_shape, dtype=model.dtype, device=x.device)
                                for _ in range(2))
    for i, bp in enumerate(stacked(params["dec_blocks"])):
        a, k, v = attention_block_with_kv(bp["self_attn"], rms_norm(x, bp["ln1"], eps), cfg,
                                          block=model.attn_block, use_kernel=model.use_kernel)
        x = x + a
        a, ck, cv = cross_attention_with_kv(bp["cross_attn"], rms_norm(x, bp["ln_x"], eps),
                                            enc_out, use_kernel=model.use_kernel)
        x = x + a
        x = x + glu_ffn(bp["ffn"], rms_norm(x, bp["ln2"], eps), cfg.act)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        cache["ck"][i] = ck
        cache["cv"][i] = cv
    return x, cache


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
    """tokens (B, 1) -> (logits (B, Vp), the cache updated in place); under
    sharding rules over their mesh, on a placed cache (module docstring)."""
    cfg = model.cfg
    pos = cache["pos"]
    fam = cfg.family
    if fam not in ("ssm", "hybrid"):
        # the global capacity: a placed leaf's shape is the whole leaf's
        _check_cache_capacity(pos, cache["ckv" if cfg.mla else "k"].shape[2])
    rules = active_rules()
    if rules is not None:
        return _decode_shards(model, rules, params, cache, tokens, pos)
    x = model.embed(params, tokens)
    step = {"ssm": _decode_ssm, "hybrid": _decode_hybrid, "audio": _decode_audio}.get(
        fam, _decode_attn)
    x = step(model, params, cache, x, pos)
    cache["pos"] = pos + 1
    h_last = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return model.logits_last(params, h_last), cache


def _decode_attn(model, params, cache, x, pos):
    cfg = model.cfg
    c1, c2 = ("ckv", "kpe") if cfg.mla else ("k", "v")
    for i, bp in enumerate(model.layers(params)):
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        if cfg.mla:
            a, _, _ = mla_block_decode(bp["attn"], h, cache[c1][i], cache[c2][i], pos, cfg)
        else:
            a, _, _ = attention_block_decode(bp["attn"], h, cache[c1][i], cache[c2][i], pos, cfg)
        x = x + a
        x = x + model._ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps))
    return x


def _decode_hybrid(model, params, cache, x, pos):
    cfg = model.cfg
    eps = cfg.norm_eps
    shared = params["shared_block"]
    w = cache["k"].shape[2]
    for g, (mamba, _) in enumerate(model.groups(params)):
        for j, mp in enumerate(stacked(mamba)):
            out, conv, ssm_state = ssm_lib.mamba2_decode(
                mp["cell"], rms_norm(x, mp["ln"], eps), cache["conv"][g, j], cache["ssm"][g, j],
                cfg)
            x = x + out
            cache["conv"][g, j] = conv
            cache["ssm"][g, j] = ssm_state
        attend = lambda h, g=g: attention_block_decode(  # noqa: E731
            shared["attn"], h, cache["k"][g], cache["v"][g], pos, cfg, window=w)
        x, _, _ = _shared_block(model, shared, x, attend)
    return x


def _decode_ssm(model, params, cache, x, pos):
    cfg = model.cfg
    eps = cfg.norm_eps
    for g, (mlstm, slstm) in enumerate(model.groups(params)):
        for j, mp in enumerate(stacked(mlstm)):
            state = tuple(cache[name][g, j] for name in ("mC", "mn", "mm"))
            out, state = ssm_lib.mlstm_decode(mp["cell"], rms_norm(x, mp["ln"], eps), state, cfg)
            x = x + out
            for name, val in zip(("mC", "mn", "mm"), state):
                cache[name][g, j] = val
        state = tuple(cache[name][g] for name in ("sc", "sn", "sm", "sh"))
        out, state = ssm_lib.slstm_decode(slstm["cell"], rms_norm(x, slstm["ln"], eps), state,
                                          cfg)
        x = x + out
        for name, val in zip(("sc", "sn", "sm", "sh"), state):
            cache[name][g] = val
    return x


def _decode_audio(model, params, cache, x, pos):
    cfg = model.cfg
    eps = cfg.norm_eps
    for i, bp in enumerate(stacked(params["dec_blocks"])):
        a, _, _ = attention_block_decode(bp["self_attn"], rms_norm(x, bp["ln1"], eps),
                                         cache["k"][i], cache["v"][i], pos, cfg)
        x = x + a
        x = x + cross_attention_decode(bp["cross_attn"], rms_norm(x, bp["ln_x"], eps),
                                       cache["ck"][i], cache["cv"][i])
        x = x + glu_ffn(bp["ffn"], rms_norm(x, bp["ln2"], eps), cfg.act)
    return x


# ==========================================================================
# over a mesh of shards
# ==========================================================================
class CacheSink:
    """Where the blocks of the sharded prefill (``LM._forward_shards``) leave
    their keys, values and final states, one tensor a shard: it lays each out
    in ``cache`` (``sharding.Sharded`` leaves placed by ``cache_pspecs``) at
    the layer that :meth:`at` names.  Each block is written by its home shard
    (a block that several shards share gets the same values from each)."""

    def __init__(self, rules, cache: dict, batch_split: bool, layer: tuple = ()):
        self.rules, self.cache, self.batch_split, self.layer = rules, cache, batch_split, layer

    def at(self, *layer) -> "CacheSink":
        """The sink for the leaves' layer ``layer`` (their leading indices)."""
        return CacheSink(self.rules, self.cache, self.batch_split, layer)

    def _leaf(self, name: str) -> Sharded:
        leaf = self.cache[name]
        for i in self.layer:
            leaf = leaf[i]
        return leaf

    @staticmethod
    def _write(leaf: Sharded, xs: list) -> None:
        for blk, home, x in zip(leaf.own(), leaf.homes(), xs):
            if tuple(x.shape) != tuple(blk.shape):
                raise ValueError(f"a block of shape {tuple(x.shape)} for the cache's "
                                 f"{tuple(blk.shape)} (spec {leaf.spec})")
            if home:
                blk.copy_(x)

    def put(self, name: str, xs: list) -> None:
        """Each shard's block of ``name``, already in the cache's layout."""
        self._write(self._leaf(name), xs)

    def put_cut(self, name: str, xs: list) -> None:
        """Each shard's whole tensor of ``name`` (its rows): the block of the
        dim that the leaf splits over "model" is cut out."""
        leaf = self._leaf(name)
        d = leaf.split_dim()
        if d is not None:
            size = leaf.shape[d] // leaf.grid[d]
            xs = [x.narrow(d, off, size) for x, off in zip(xs, leaf.offsets(d))]
        self._write(leaf, xs)

    def put_seq(self, name: str, xs: list, *, heads_split: bool) -> None:
        """Each shard's (B_loc, S, ...) keys of ``name`` for its rows: the last
        positions that the leaf's sequence holds (the hybrid's ring keeps the
        last w), zero-padded to its capacity, as ``_cache_len`` pads; where
        ``heads_split`` (a shard holds its block of the KV heads) re-split
        from heads to sequence blocks by one all-to-all over "model", else
        (every head on every shard) cut to the shard's sequence block."""
        leaf = self._leaf(name)
        cap = leaf.shape[1]
        xs = [x[:, -cap:] for x in xs]
        if xs[0].shape[1] < cap:
            xs = [torch.cat([x, x.new_zeros((x.shape[0], cap - x.shape[1], *x.shape[2:]))], dim=1)
                  for x in xs]
        if heads_split:
            xs = all_to_all(xs, self.rules.mesh, self.rules.tp_axis, split_dim=1, concat_dim=2)
            self._write(leaf, xs)
        else:
            self.put_cut(name, xs)

    def put_whole(self, name: str, xs: list, *, heads_split: bool) -> None:
        """A replicated leaf (the audio's cross cache) from each shard's KV
        heads of its rows: gathered over "model" where the heads are split
        and over the data axes where the rows are."""
        rules = self.rules
        if heads_split:
            xs = all_gather(xs, rules.mesh, rules.tp_axis, dim=2)
        if self.batch_split and rules.dp() > 1:
            xs = all_gather(xs, rules.mesh, rules.axis("batch"), dim=0)
        self._write(self._leaf(name), xs)


def _prefill_shards(model, rules, params, tokens, frontend, max_seq):
    """The cached prefill over the mesh of ``rules``: an empty placed cache
    of the unsharded prefill's sizes, filled by the forward's blocks through
    a :class:`CacheSink`; returns (last logits (B, Vp), cache)."""
    cfg = model.cfg
    fam = cfg.family
    b, s = tokens.shape
    if fam == "vlm" and frontend is not None:
        s += frontend.shape[1]
    if fam == "hybrid":
        leaves = _leaves(model, b, min(cfg.sliding_window or s, s))
    elif fam == "ssm":
        leaves = _leaves(model, b, s)
    else:
        leaves = _leaves(model, b, _cache_len(s, max_seq))
    if fam == "audio":
        shape, dt, fill = leaves["ck"]
        enc = (*shape[:2], frontend.shape[1], *shape[3:])
        leaves.update(ck=(enc, dt, fill), cv=(enc, dt, fill))
    cache = empty_cache(rules, leaves, b)
    batch_split = b % rules.dp() == 0
    xs = model._embed_shards(rules, params["embed"], split_batch(rules, tokens))
    hs = model._forward_shards(rules, params, xs, frontend, batch_split,
                               sink=CacheSink(rules, cache, batch_split))
    cache["pos"] = s
    return model._last_logits_shards(rules, params, hs, batch_split), cache


def _decode_shards(model, rules, params, cache, tokens, pos):
    bad = [name for name, leaf in cache.items() if name != "pos" and not isinstance(leaf, Sharded)]
    if bad:
        raise TypeError(f"decode_step under sharding rules takes a placed cache "
                        f"(sharding.shard_cache or init_cache under the rules); {bad} are not")
    batch_split = tokens.shape[0] % rules.dp() == 0
    xs = model._embed_shards(rules, params["embed"], split_batch(rules, tokens))
    step = {"ssm": _decode_ssm_shards, "hybrid": _decode_hybrid_shards,
            "audio": _decode_audio_shards}.get(model.cfg.family, _decode_attn_shards)
    xs = step(model, rules, params, cache, xs, pos, batch_split)
    cache["pos"] = pos + 1
    return model._last_logits_shards(rules, params, xs, batch_split), cache


def _residual(xs: list, ys: list) -> list:
    return [x + y for x, y in zip(xs, ys)]


def _decode_attn_shards(model, rules, params, cache, xs, pos, batch_split):
    cfg = model.cfg
    for i, bp in enumerate(model.layers(params)):
        hs = model._norm_shards(xs, bp["ln1"])
        if cfg.mla:
            a = mla_block_decode_shards(rules, bp["attn"], hs, cache["ckv"][i], cache["kpe"][i],
                                        pos, cfg)
        else:
            a = attention_block_decode_shards(rules, bp["attn"], hs, cache["k"][i],
                                              cache["v"][i], pos, cfg)
        xs = model._ffn_shards(rules, bp, _residual(xs, a), batch_split)
    return xs


def _decode_hybrid_shards(model, rules, params, cache, xs, pos, batch_split):
    cfg = model.cfg
    shared = params["shared_block"]
    w = cache["k"].shape[2]
    for g, (mamba, _) in enumerate(model.groups(params)):
        for j, mp in enumerate(stacked(mamba)):
            xs = _residual(xs, ssm_lib.mamba2_decode_shards(
                rules, mp["cell"], model._norm_shards(xs, mp["ln"]), cache["conv"][g][j],
                cache["ssm"][g][j], cfg))
        a = attention_block_decode_shards(rules, shared["attn"],
                                          model._norm_shards(xs, shared["ln1"]), cache["k"][g],
                                          cache["v"][g], pos, cfg, window=w)
        xs = model._ffn_shards(rules, shared, _residual(xs, a), batch_split)
    return xs


def _decode_ssm_shards(model, rules, params, cache, xs, pos, batch_split):
    cfg = model.cfg
    for g, (mlstm, slstm) in enumerate(model.groups(params)):
        for j, mp in enumerate(stacked(mlstm)):
            state = tuple(cache[name][g][j] for name in ("mC", "mn", "mm"))
            xs = _residual(xs, ssm_lib.mlstm_decode_shards(
                rules, mp["cell"], model._norm_shards(xs, mp["ln"]), state, cfg))
        state = tuple(cache[name][g] for name in ("sc", "sn", "sm", "sh"))
        xs = _residual(xs, ssm_lib.slstm_decode_shards(
            rules, slstm["cell"], model._norm_shards(xs, slstm["ln"]), state, cfg))
    return xs


def _decode_audio_shards(model, rules, params, cache, xs, pos, batch_split):
    cfg = model.cfg
    for i, bp in enumerate(stacked(params["dec_blocks"])):
        xs = _residual(xs, attention_block_decode_shards(
            rules, bp["self_attn"], model._norm_shards(xs, bp["ln1"]), cache["k"][i],
            cache["v"][i], pos, cfg))
        xs = _residual(xs, cross_attention_decode_shards(
            rules, bp["cross_attn"], model._norm_shards(xs, bp["ln_x"]), cache["ck"][i],
            cache["cv"][i], batch_split))
        xs = _residual(xs, glu_ffn_shards(rules, bp["ffn"], model._norm_shards(xs, bp["ln2"]),
                                          cfg.act))
    return xs
