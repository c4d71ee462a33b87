"""The dense LM's forward pass: ``repro/models/lm/model.py`` for ``family == "dense"``.

Parameters are plain nested dicts of tensors with the reference's tree:
``embed``, ``unembed``, ``final_norm`` and ``blocks``, whose leaves stack
the layers on a leading ``(L, …)`` axis (``blocks.{ln1, ln2, attn.{wq, wk,
wv, wo, bq, bk, bv}, ffn.{w_gate, w_up, w_down}}``).  ``_backbone`` runs a
Python loop over the layers in place of the reference's ``lax.scan``.

The other families (MoE, MLA, SSM, hybrid, audio, VLM), the KV cache
(prefill / decode) and the training losses are not ported (ROADMAP Queue 1
item 13).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm.layers import (
    attention_block,
    glu_ffn,
    init_attention,
    init_ffn,
    rms_norm,
)

__all__ = ["LM"]

f32 = torch.float32


def _padded_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {key: _layer(val, i) for key, val in tree.items()}
    return tree[i]


class LM:
    """Functional dense LM; params are plain nested dicts of tensors.

    ``use_kernel=False`` sends attention on the card to the plain version of
    the ``flash_attention`` kernel (for comparison only); on the CPU the
    attention is always the reference's plain route.
    """

    def __init__(self, cfg: ModelConfig, *, attn_block: int = 1024, use_kernel: bool = True):
        if cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None:
            raise NotImplementedError(
                f"{cfg.arch_id}: family {cfg.family!r} is not ported; the port runs the dense "
                "family's forward only (ROADMAP Queue 1 item 13)"
            )
        self.cfg = cfg
        self.attn_block = attn_block
        self.use_kernel = use_kernel
        self.vp = _padded_vocab(cfg.vocab)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on ``generator``'s device, with the reference's
        stds: embed 0.02, unembed d^-½, norms one, biases zero."""
        cfg, dt = self.cfg, self.dtype
        d, n_layers = cfg.d_model, cfg.n_layers
        dev = generator.device
        embed = torch.randn((self.vp, d), generator=generator, device=dev) * 0.02
        unembed = torch.randn((d, self.vp), generator=generator, device=dev) * d ** -0.5
        return {
            "embed": embed.to(dt),
            "unembed": unembed.to(dt),
            "final_norm": torch.ones((d,), dtype=dt, device=dev),
            "blocks": {
                "ln1": torch.ones((n_layers, d), dtype=dt, device=dev),
                "ln2": torch.ones((n_layers, d), dtype=dt, device=dev),
                "attn": init_attention(generator, cfg, dt, lead=(n_layers,)),
                "ffn": init_ffn(generator, d, cfg.d_ff, dt, lead=(n_layers,)),
            },
        }

    def _apply_attn_ffn(self, bp, x, *, causal=True, window=0):
        cfg = self.cfg
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        x = x + attention_block(bp["attn"], h, cfg, causal=causal, window=window,
                                block=self.attn_block, use_kernel=self.use_kernel)
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        return x + glu_ffn(bp["ffn"], h, cfg.act)

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids -> (B, S, D) embeddings in the model's type."""
        return params["embed"][torch.clamp(tokens, 0, self.vp - 1)].to(self.dtype)

    def _backbone(self, params, x):
        """Full-sequence forward through all blocks.  x: (B, S, D)."""
        blocks = params["blocks"]
        for i in range(blocks["ln1"].shape[0]):
            x = self._apply_attn_ffn(_layer(blocks, i), x)
        return x

    def logits_last(self, params, h_last):
        """h_last: (B, D) -> (B, Vp) f32 logits (vocab padded masked)."""
        logits = (h_last @ params["unembed"]).to(f32)
        live = torch.arange(self.vp, device=logits.device)[None, :] < self.cfg.vocab
        return torch.where(live, logits, -1e30)
