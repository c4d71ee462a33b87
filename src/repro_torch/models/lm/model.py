"""LM assembly: ``repro/models/lm/model.py``, all six families.

Parameters are plain nested dicts of tensors with the reference's tree:
``embed``, ``unembed``, ``final_norm``, ``frontend_adapter`` (VLM, audio)
and by family

* dense / vlm / moe: ``dense0`` (a list of unstacked blocks: DeepSeek's
  leading dense-FFN layer) and ``blocks``, whose leaves stack the layers on
  a leading ``(L, …)`` axis (``blocks.{ln1, ln2, attn.{wq, wk, wv, wo, bq,
  bk, bv, q_norm, k_norm} | attn.{wq_a, q_norm, wq_b, wkv_a, kv_norm, wkv_b,
  wo} (MLA), ffn.{w_gate, w_up, w_down} | moe.{router, w_gate, w_up, w_down,
  shared}}``);
* ssm (xlstm): ``mlstm.{ln, cell}`` stacked (G, 7, …) and ``slstm.{ln,
  cell}`` stacked (G, …): G groups of seven mLSTM blocks and one sLSTM;
* hybrid (zamba2): ``mamba.{ln, cell}`` stacked (G, 6, …) and one
  ``shared_block`` (attention + FFN) applied after every group, with the
  config's sliding window;
* audio (seamless): ``enc_blocks`` (bidirectional attention + FFN, stacked),
  ``enc_norm`` and ``dec_blocks.{ln1, self_attn, ln_x, cross_attn, ln2,
  ffn}`` stacked.

Python loops over the stacked layers take the place of the reference's
``lax.scan``.  Serving (``prefill``, ``decode_step``, ``init_cache``) is in
``cache.py``.  The training losses are not ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm import ssm as ssm_lib
from repro_torch.models.lm.layers import (
    attention_block,
    cross_attention_with_kv,
    glu_ffn,
    init_attention,
    init_ffn,
    init_mla,
    mla_block,
    rms_norm,
)

__all__ = ["FAMILIES", "LM"]

f32 = torch.float32
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _padded_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def _layer(tree, i: int):
    """Layer ``i`` of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {key: _layer(val, i) for key, val in tree.items()}
    return tree[i]


def _depth(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def stacked(tree):
    """The layers of a tree of stacked leaves, in order (its leading axis)."""
    return (_layer(tree, i) for i in range(_depth(tree)))


class LM:
    """Functional LM of the six families; params are plain nested dicts of
    tensors.

    ``moe_backend`` is ``"einsum"`` (the reference's default) or
    ``"sorted"``.  ``use_kernel=False`` sends prefill attention on the card
    to the plain version of the ``flash_attention`` kernel (for comparison
    only); on the CPU the attention is always the reference's plain route.
    """

    def __init__(self, cfg: ModelConfig, *, moe_backend: str = "einsum",
                 attn_block: int = 1024, use_kernel: bool = True):
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.arch_id}: unknown family {cfg.family!r}; "
                             f"known: {', '.join(FAMILIES)}")
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

    def _init_cross_block(self, generator, lead=()) -> dict:
        cfg, dt = self.cfg, self.dtype
        dev = generator.device
        ones = lambda: torch.ones((*lead, cfg.d_model), dtype=dt, device=dev)  # noqa: E731
        return {
            "ln1": ones(),
            "self_attn": init_attention(generator, cfg, dt, lead=lead),
            "ln_x": ones(),
            "cross_attn": init_attention(generator, cfg, dt, lead=lead),
            "ln2": ones(),
            "ffn": init_ffn(generator, cfg.d_model, cfg.d_ff, dt, lead=lead),
        }

    def _init_family(self, generator) -> dict:
        """The family's own trees (module docstring)."""
        cfg, dt = self.cfg, self.dtype
        d = cfg.d_model
        dev = generator.device
        fam = cfg.family
        if fam == "ssm":
            per = cfg.ssm.slstm_every
            g, m = cfg.n_layers // per, per - 1
            return {
                "mlstm": {"ln": torch.ones((g, m, d), dtype=dt, device=dev),
                          "cell": ssm_lib.init_mlstm(generator, cfg, dt, lead=(g, m))},
                "slstm": {"ln": torch.ones((g, d), dtype=dt, device=dev),
                          "cell": ssm_lib.init_slstm(generator, cfg, dt, lead=(g,))},
            }
        if fam == "hybrid":
            per = cfg.attn_every
            g = cfg.n_layers // per
            return {
                "mamba": {"ln": torch.ones((g, per, d), dtype=dt, device=dev),
                          "cell": ssm_lib.init_mamba2(generator, cfg, dt, lead=(g, per))},
                "shared_block": self._init_attn_ffn_block(generator, False),
            }
        if fam == "audio":
            return {
                "enc_blocks": self._init_attn_ffn_block(generator, False,
                                                        lead=(cfg.enc_layers,)),
                "dec_blocks": self._init_cross_block(generator, lead=(cfg.n_layers,)),
                "enc_norm": torch.ones((d,), dtype=dt, device=dev),
            }
        params = {"blocks": self._init_attn_ffn_block(generator, fam == "moe",
                                                      lead=(cfg.n_layers - cfg.dense_layers,))}
        if cfg.dense_layers:
            params["dense0"] = [self._init_attn_ffn_block(generator, False)
                                for _ in range(cfg.dense_layers)]
        return params

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters on ``generator``'s device, with the reference's
        tree, stds and types: embed 0.02, unembed d^-½, norms one, biases
        zero, the float32 leaves of the MoE router and the SSM cells
        float32."""
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
        params.update(self._init_family(generator))
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
        yield from stacked(params["blocks"])

    def groups(self, params):
        """The SSM and hybrid families' groups in order: (the group's stacked
        blocks ``mlstm`` / ``mamba``, its one sLSTM block, or None)."""
        if self.cfg.family == "ssm":
            return zip(stacked(params["mlstm"]), stacked(params["slstm"]))
        return ((gp, None) for gp in stacked(params["mamba"]))

    def _backbone(self, params, x):
        """Full-sequence forward through all blocks.  x: (B, S, D)."""
        cfg = self.cfg
        eps = cfg.norm_eps
        if cfg.family == "ssm":
            for mlstm, slstm in self.groups(params):
                for mp in stacked(mlstm):
                    x = x + ssm_lib.mlstm_block(mp["cell"], rms_norm(x, mp["ln"], eps), cfg)
                x = x + ssm_lib.slstm_block(slstm["cell"], rms_norm(x, slstm["ln"], eps), cfg)
            return x
        if cfg.family == "hybrid":
            for mamba, _ in self.groups(params):
                for mp in stacked(mamba):
                    x = x + ssm_lib.mamba2_block(mp["cell"], rms_norm(x, mp["ln"], eps), cfg)
                x = self._apply_attn_ffn(params["shared_block"], x, window=cfg.sliding_window)
            return x
        for bp in self.layers(params):
            x = self._apply_attn_ffn(bp, x)
        return x

    # ------------------------------------------------------- encoder-decoder
    def _encode(self, params, frontend):
        """Audio encoder over stub frame embeddings: (B, S_enc, D)."""
        x = frontend.to(self.dtype) @ params["frontend_adapter"]
        for bp in stacked(params["enc_blocks"]):
            x = self._apply_attn_ffn(bp, x, causal=False)
        return rms_norm(x, params["enc_norm"], self.cfg.norm_eps)

    def _cross_attention(self, p, x, enc_out):
        return cross_attention_with_kv(p, x, enc_out, use_kernel=self.use_kernel)[0]

    def _apply_cross_block(self, bp, x, enc_out):
        cfg = self.cfg
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        x = x + attention_block(bp["self_attn"], h, cfg, causal=True, block=self.attn_block,
                                use_kernel=self.use_kernel)
        h = rms_norm(x, bp["ln_x"], cfg.norm_eps)
        x = x + self._cross_attention(bp["cross_attn"], h, enc_out)
        return x + glu_ffn(bp["ffn"], rms_norm(x, bp["ln2"], cfg.norm_eps), cfg.act)

    def _decoder(self, params, x, enc_out):
        for bp in stacked(params["dec_blocks"]):
            x = self._apply_cross_block(bp, x, enc_out)
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
        from repro_torch.models.lm.cache import build_prefill_cache

        return build_prefill_cache(self, params, tokens, frontend, max_seq)

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) -> (logits (B, Vp), the cache, updated in place)."""
        from repro_torch.models.lm.cache import decode_step

        return decode_step(self, params, cache, tokens)

    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        from repro_torch.models.lm.cache import init_cache

        return init_cache(self, batch, max_seq, device)
