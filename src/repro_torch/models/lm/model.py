"""LM assembly: ``repro/models/lm/model.py`` for the dense, VLM and MoE families.

Parameters are plain nested dicts of tensors with the reference's tree:
``embed``, ``unembed``, ``final_norm``, ``frontend_adapter`` (VLM),
``dense0`` (a list of unstacked blocks: DeepSeek's leading dense-FFN layer)
and ``blocks``, whose leaves stack the layers on a leading ``(L, …)`` axis
(``blocks.{ln1, ln2, attn.{wq, wk, wv, wo, bq, bk, bv, q_norm, k_norm} |
attn.{wq_a, q_norm, wq_b, wkv_a, kv_norm, wkv_b, wo} (MLA), ffn.{w_gate,
w_up, w_down} | moe.{router, w_gate, w_up, w_down, shared}}``).
``_backbone`` runs ``dense0`` then a Python loop over ``blocks`` in place
of the reference's ``lax.scan``.  Serving (``prefill``, ``decode_step``,
``init_cache``) is in ``cache.py``.

The SSM, hybrid and audio families and the training losses are not ported
(ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import cache as cache_lib
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm.layers import (
    attention_block,
    glu_ffn,
    init_attention,
    init_ffn,
    init_mla,
    mla_block,
    rms_norm,
)

__all__ = ["FAMILIES", "LM"]

f32 = torch.float32
FAMILIES = ("dense", "vlm", "moe")


def _padded_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {key: _layer(val, i) for key, val in tree.items()}
    return tree[i]


class LM:
    """Functional LM of the dense, VLM and MoE families; params are plain
    nested dicts of tensors.

    ``moe_backend`` is ``"einsum"`` (the reference's default) or
    ``"sorted"``.  ``use_kernel=False`` sends prefill attention on the card
    to the plain version of the ``flash_attention`` kernel (for comparison
    only); on the CPU the attention is always the reference's plain route.
    """

    def __init__(self, cfg: ModelConfig, *, moe_backend: str = "einsum",
                 attn_block: int = 1024, use_kernel: bool = True):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.arch_id}: family {cfg.family!r} is not ported; the port runs the "
                f"{', '.join(FAMILIES)} families (ROADMAP Queue 1 item 9)"
            )
        if moe_backend not in ("einsum", "sorted"):
            raise ValueError(f"moe_backend {moe_backend!r}: choose einsum or sorted")
        self.cfg = cfg
        self.moe_backend = moe_backend
        self.attn_block = attn_block
        self.use_kernel = use_kernel
        self.vp = _padded_vocab(cfg.vocab)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    # ------------------------------------------------------------------ init
    def _init_attn_ffn_block(self, generator, use_moe: bool, lead=()) -> dict:
        cfg, dt = self.cfg, self.dtype
        d = cfg.d_model
        dev = generator.device
        blk = {"ln1": torch.ones((*lead, d), dtype=dt, device=dev),
               "ln2": torch.ones((*lead, d), dtype=dt, device=dev)}
        init = init_mla if cfg.mla else init_attention
        blk["attn"] = init(generator, cfg, dt, lead=lead)
        if use_moe:
            blk["moe"] = moe_lib.init_moe(generator, d, cfg.moe, dt, lead=lead)
        else:
            blk["ffn"] = init_ffn(generator, d, cfg.d_ff, dt, lead=lead)
        return blk

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on ``generator``'s device, with the reference's
        tree and stds: embed 0.02, unembed d^-½, norms one, biases zero."""
        cfg, dt = self.cfg, self.dtype
        d = cfg.d_model
        dev = generator.device
        embed = torch.randn((self.vp, d), generator=generator, device=dev) * 0.02
        unembed = torch.randn((d, self.vp), generator=generator, device=dev) * d ** -0.5
        params = {
            "embed": embed.to(dt),
            "unembed": unembed.to(dt),
            "final_norm": torch.ones((d,), dtype=dt, device=dev),
        }
        del embed, unembed
        if cfg.frontend:
            adapter = torch.randn((d, d), generator=generator, device=dev) * d ** -0.5
            params["frontend_adapter"] = adapter.to(dt)
        n_scan = cfg.n_layers - cfg.dense_layers
        params["blocks"] = self._init_attn_ffn_block(generator, cfg.family == "moe",
                                                     lead=(n_scan,))
        if cfg.dense_layers:
            params["dense0"] = [self._init_attn_ffn_block(generator, False)
                                for _ in range(cfg.dense_layers)]
        return params

    # --------------------------------------------------------------- forward
    def _ffn(self, bp, h):
        if "moe" in bp:
            return moe_lib.moe_ffn(bp["moe"], h, self.cfg.moe, self.moe_backend)
        return glu_ffn(bp["ffn"], h, self.cfg.act)

    def _apply_attn_ffn(self, bp, x, *, causal=True, window=0):
        cfg = self.cfg
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        if cfg.mla:
            a = mla_block(bp["attn"], h, cfg, block=self.attn_block, use_kernel=self.use_kernel)
        else:
            a = attention_block(bp["attn"], h, cfg, causal=causal, window=window,
                                block=self.attn_block, use_kernel=self.use_kernel)
        x = x + a
        return x + self._ffn(bp, rms_norm(x, bp["ln2"], cfg.norm_eps))

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids -> (B, S, D) embeddings in the model's type."""
        return params["embed"][torch.clamp(tokens, 0, self.vp - 1)].to(self.dtype)

    def layers(self, params):
        """Every attention + FFN block in order: ``dense0``, then ``blocks``."""
        yield from params.get("dense0", [])
        blocks = params["blocks"]
        for i in range(blocks["ln1"].shape[0]):
            yield _layer(blocks, i)

    def _backbone(self, params, x):
        """Full-sequence forward through all blocks.  x: (B, S, D)."""
        for bp in self.layers(params):
            x = self._apply_attn_ffn(bp, x)
        return x

    def logits_last(self, params, h_last):
        """h_last: (B, D) -> (B, Vp) f32 logits (vocab padded masked)."""
        logits = (h_last @ params["unembed"]).to(f32)
        live = torch.arange(self.vp, device=logits.device)[None, :] < self.cfg.vocab
        return torch.where(live, logits, -1e30)

    # --------------------------------------------------------------- serving
    def prefill(self, params, tokens, frontend=None, max_seq=None):
        """Returns (last-position logits (B, Vp), populated cache).

        The cache reserves decode headroom up to ``max_seq`` total positions
        (default: prefill length + ``cache.DECODE_RESERVE``)."""
        return cache_lib.build_prefill_cache(self, params, tokens, frontend, max_seq)

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) -> (logits (B, Vp), the cache, updated in place)."""
        return cache_lib.decode_step(self, params, cache, tokens)

    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        return cache_lib.init_cache(self, batch, max_seq, device)
