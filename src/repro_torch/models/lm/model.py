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
``cache.py``.

Training: :meth:`LM.train_loss` is the reference's next-token loss for all
six families (the VLM's frontend positions dropped from the loss, the audio
family through encoder and decoder), its softmax cross-entropy streamed over
sequence chunks of at most ``loss_chunk`` positions (:meth:`LM._chunked_xent`,
the reference's single-host branch: ``(B, S, V)`` logits never exist at
once).  ``remat=True`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant) where the reference's
``_maybe_remat`` applies ``jax.checkpoint``, at the reference's sites only;
it changes memory, not numbers.  On the card the attention's gradient
is the ``flash_attention`` backward kernels (``kernels/flash_attention/
autograd.py``).

One forward, as in the reference: :meth:`LM.train_loss`,
:meth:`LM.prefill_logits`, the cached :meth:`LM.prefill` and
:meth:`LM.decode_step` run the same body with or without sharding rules.
The residual stream is a list of one tensor a shard.  Under
``sharding.use_rules(rules)``, with the parameters of
``sharding.shard_params``, all six families run over ``rules.mesh``: the
embedding is looked up in each shard's vocabulary rows and summed over
"model", each block runs tensor-parallel (``layers.attention_block_shards``
or ``layers.mla_block_shards``, ``layers.glu_ffn_shards`` or
``moe.moe_ffn_shards``, DeepSeek's ``dense0`` first;
``ssm.mlstm_block_shards`` and ``ssm.slstm_block_shards``,
``ssm.mamba2_block_shards`` and the hybrid's windowed shared block; the
audio encoder over the replicated frontend, and
``layers.cross_attention_shards``).  With no rules the leaves are tensors
and the list holds one: each block is its one-shard case, the unsharded
block, and no collective runs.  Only the loss head has the reference's two
branches: :meth:`LM._chunked_xent` with no rules, and under rules the
vocab-sharded :func:`_sharded_chunk_xent`: local logits a shard and chunk,
the max over "model" with its gradient stopped, the sum of exponentials and
the gold logit summed over "model", the loss and ``correct`` summed over
"data".  The cached prefill is the same forward (:meth:`LM._forward`) with
a cache sink (``cache.CacheSink``) to which each block hands its keys,
values or final states, placed leaf for leaf by ``sharding.cache_pspecs``
under rules; :meth:`LM.init_cache` places an empty cache so, and
:meth:`LM.decode_step` decodes on it, the attention's reduction over the
cached sequence split over "model" (``cache.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm import ssm as ssm_lib
from repro_torch.models.lm.collectives import (
    all_reduce_max,
    all_reduce_sum,
    all_to_all,
)
from repro_torch.models.lm.layers import (
    attention_block_shards,
    cross_attention_shards,
    glu_ffn_shards,
    init_attention,
    init_ffn,
    init_mla,
    mla_block_shards,
    rms_norm,
)
from repro_torch.models.lm.sharding import active_rules, locals_of, split_batch, split_dim_of

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


class _OnMeta(TorchFunctionMode):
    """Every tensor that a call creates with a ``device`` goes to ``meta``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


def _loss_chunk(s: int, loss_chunk: int) -> int:
    """The largest divisor of s not above ``loss_chunk``."""
    c = min(loss_chunk, s)
    while s % c != 0:
        c -= 1
    return c


def _unembed_vocab_blocks(rules, w) -> tuple[list, list, bool]:
    """Each shard's (D, V_loc) block of the unembedding, its first vocabulary
    id, and whether the vocabulary is split.  The rules split the (D, V) leaf
    over its rows (their ``embed$`` pattern matches ``unembed`` first); the
    loss wants it split over the vocabulary, as the reference's ``shard_map``
    in_specs ``P(None, 'model')`` re-shard it: an all-to-all over "model"."""
    mesh = rules.mesh
    blocks = w.locals()
    if w.split_dim() == 0:
        blocks = all_to_all(blocks, mesh, rules.tp_axis, split_dim=1, concat_dim=0)
    v_loc = blocks[0].shape[1]
    offsets = [mesh.axis_index(c, rules.tp_axis) * v_loc for c in mesh.coords]
    return blocks, offsets, v_loc != w.shape[1]


def _sharded_chunk_xent(rules, vp: int, vocab: int, n_chunks: int, batch_split: bool = True):
    """Returns fn(h, w, labels, mask) -> (loss_sum, correct): the reference's
    vocab-sharded streaming softmax cross-entropy.  ``h`` (B_loc, S, D),
    ``labels`` (B_loc, S) and ``mask`` (B_loc, S) are lists of one tensor a
    shard, ``w`` is the unembedding's ``Sharded`` leaf (D, V), re-split over
    the vocabulary (:func:`_unembed_vocab_blocks`).  A chunk's logits are
    local, (B_loc, c, V_loc) a shard; the sums over the vocabulary are
    all-reduced over "model" and the results over "data" (where
    ``batch_split``: the shards of a data group hold their own rows).  The scalars returned are on the first shard's device.
    """
    mesh, tp_axis = rules.mesh, rules.tp_axis
    dp = rules.axis("batch")

    def fn(h, w, labels, mask):
        ws, offs, split = _unembed_vocab_blocks(rules, w)
        reduce_tp = (lambda xs: all_reduce_sum(xs, mesh, tp_axis)) if split else list
        s = h[0].shape[1]
        c = s // n_chunks
        loss = [0.0] * mesh.size
        correct = [0.0] * mesh.size
        for c0 in range(0, s, c):
            logits = []
            for n in range(mesh.size):
                lg = (h[n][:, c0:c0 + c] @ ws[n]).to(f32)               # (B_loc, c, V_loc)
                ids = offs[n] + torch.arange(lg.shape[-1], device=lg.device)
                logits.append(torch.where(ids < vocab, lg, -1e30))
            # the max with its gradient stopped keeps d lse / d logits == softmax
            mx_loc = [lg.detach().amax(dim=-1) for lg in logits]
            mx = all_reduce_max(mx_loc, mesh, tp_axis) if split else mx_loc
            z = reduce_tp([torch.sum(torch.exp(lg - m[..., None]), dim=-1)
                           for lg, m in zip(logits, mx)])
            gold = []
            for n, lg in enumerate(logits):
                local = labels[n][:, c0:c0 + c] - offs[n]
                held = (local >= 0) & (local < lg.shape[-1])
                g = lg.gather(-1, local.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
                gold.append(torch.where(held, g, 0.0))
            gold = reduce_tp(gold)
            for n in range(mesh.size):
                mm = mask[n][:, c0:c0 + c]
                lse = torch.log(z[n]) + mx[n]
                loss[n] = loss[n] + torch.sum((lse - gold[n]) * mm)
                with torch.no_grad():
                    correct[n] = correct[n] + torch.sum((gold[n] >= mx[n]).to(f32) * mm)
        if dp is not None and batch_split and mesh.axis_size(dp) > 1:
            loss = all_reduce_sum(loss, mesh, dp)
            correct = all_reduce_sum(correct, mesh, dp, backward=None)
        return loss[0], correct[0]

    return fn


class LM:
    """Functional LM of the six families; params are plain nested dicts of
    tensors.

    ``moe_backend`` is ``"einsum"`` (the reference's default) or
    ``"sorted"``.  ``use_kernel=False`` sends prefill attention on the card
    to the plain version of the ``flash_attention`` kernel (for comparison
    only); on the CPU the attention is always the reference's plain route.
    ``remat`` and ``loss_chunk`` are the reference's (module docstring).
    """

    def __init__(self, cfg: ModelConfig, *, moe_backend: str = "einsum",
                 attn_block: int = 1024, use_kernel: bool = True, remat: bool = True,
                 loss_chunk: int = 512):
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.arch_id}: unknown family {cfg.family!r}; "
                             f"known: {', '.join(FAMILIES)}")
        if moe_backend not in ("einsum", "sorted"):
            raise ValueError(f"moe_backend {moe_backend!r}: choose einsum or sorted")
        self.cfg = cfg
        self.moe_backend = moe_backend
        self.attn_block = attn_block
        self.use_kernel = use_kernel
        self.remat = remat
        self.loss_chunk = loss_chunk
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

    def init_shapes(self) -> dict:
        """The parameters' tree on the ``meta`` device: shapes and types, no
        storage (the reference's ``init_shapes``; the dry run's entry point)."""
        with _OnMeta():
            return self.init(torch.Generator())

    # --------------------------------------------------------------- forward
    # One forward serves both: under sharding rules the residual stream is a
    # list of one tensor a shard and the leaves are ``sharding.Sharded``; with
    # none it is a list of one tensor and the leaves are tensors (one shard),
    # and no collective runs (module docstring).
    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids -> (B, S, D) embeddings in the model's type."""
        return self._embed(None, params["embed"], [tokens])[0]

    def _embed(self, rules, leaf, ids: list) -> list:
        """The embedding of each shard's token ids: each shard looks up the
        vocabulary rows it holds, zeroes the rest, and the shards are summed
        over "model" (where the vocabulary is split)."""
        split = split_dim_of(leaf) == 0
        out = []
        for n, (tok, w) in enumerate(zip(ids, locals_of(leaf))):
            tok = torch.clamp(tok, 0, self.vp - 1)
            if split:
                local = tok - leaf.offsets(0)[n]
                held = (local >= 0) & (local < w.shape[0])
                e = torch.where(held[..., None],
                                F.embedding(local.clamp(0, w.shape[0] - 1), w), 0)
            else:
                e = F.embedding(tok, w)
            out.append(e.to(self.dtype))
        return all_reduce_sum(out, rules.mesh, rules.tp_axis, backward=None) if split else out

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

    def _maybe_remat(self, fn):
        """``fn`` recomputed in the backward pass under ``remat`` (the
        reference's ``_maybe_remat``), for the calls through which a
        gradient is being taken: a tensor argument, or a tensor in a list
        argument (one a shard), requires one."""
        if not self.remat:
            return fn

        def run(*args, **kwargs):
            tensors = (t for a in args for t in (a if isinstance(a, list) else [a]))
            if torch.is_grad_enabled() and any(torch.is_tensor(t) and t.requires_grad
                                               for t in tensors):
                return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                                  **kwargs)
            return fn(*args, **kwargs)

        return run

    def _norm(self, xs: list, leaf) -> list:
        return [rms_norm(x, w, self.cfg.norm_eps) for x, w in zip(xs, locals_of(leaf))]

    def _ffn(self, rules, bp, xs: list, batch_split: bool) -> list:
        """``xs`` plus the block's MoE or dense FFN of its second norm, each
        tensor-parallel."""
        hs = self._norm(xs, bp["ln2"])
        if "moe" in bp:
            f = moe_lib.moe_ffn_shards(rules, bp["moe"], hs, self.cfg.moe, self.moe_backend,
                                       batch_split=batch_split)
        else:
            f = glu_ffn_shards(rules, bp["ffn"], hs, self.cfg.act)
        return [x + y for x, y in zip(xs, f)]

    def _apply_attn_ffn(self, rules, bp, xs: list, batch_split: bool = True, causal: bool = True,
                        window: int = 0, sink=None) -> list:
        """An attention + FFN block: MLA or GQA attention, the MoE or the
        dense FFN, each tensor-parallel; the attention hands a cache ``sink``
        its keys and values."""
        cfg = self.cfg
        hs = self._norm(xs, bp["ln1"])
        if cfg.mla:
            a = mla_block_shards(rules, bp["attn"], hs, cfg, block=self.attn_block,
                                 use_kernel=self.use_kernel, sink=sink)
        else:
            a = attention_block_shards(rules, bp["attn"], hs, cfg, causal=causal, window=window,
                                       block=self.attn_block, use_kernel=self.use_kernel,
                                       sink=sink)
        return self._ffn(rules, bp, [x + y for x, y in zip(xs, a)], batch_split)

    def _mlstm_body(self, rules, mp, xs: list, sink=None) -> list:
        ys = ssm_lib.mlstm_block_shards(rules, mp["cell"], self._norm(xs, mp["ln"]), self.cfg,
                                        sink=sink)
        return [x + y for x, y in zip(xs, ys)]

    def _mamba_body(self, rules, mp, xs: list, sink=None) -> list:
        ys = ssm_lib.mamba2_block_shards(rules, mp["cell"], self._norm(xs, mp["ln"]), self.cfg,
                                         sink=sink)
        return [x + y for x, y in zip(xs, ys)]

    def _backbone(self, params, x, batch_split: bool = True, sink=None):
        """Full-sequence forward through all blocks, family by family.  x:
        (B, S, D), returned so; or one (B_loc, S, D) tensor a shard, the
        list returned.  Under ``remat`` at the reference's sites only: each
        mLSTM and Mamba2 body and each stacked attention + FFN block, never
        the sLSTM, the hybrid's shared block or ``dense0``.  ``batch_split``:
        each shard holds its data shard's rows (else every row; the MoE's
        capacity follows it).  A cache ``sink`` (the cached prefill) is
        handed to each block at its layer of the cache."""
        rules, cfg = active_rules(), self.cfg
        xs = x if isinstance(x, list) else [x]
        at = sink.at if sink is not None else lambda *layer: None
        if cfg.family == "ssm":
            m_body = self._maybe_remat(self._mlstm_body)
            for g, (mlstm, slstm) in enumerate(self.groups(params)):
                for j, mp in enumerate(stacked(mlstm)):
                    xs = m_body(rules, mp, xs, sink=at(g, j))
                ys = ssm_lib.slstm_block_shards(rules, slstm["cell"], self._norm(xs, slstm["ln"]),
                                                cfg, sink=at(g))
                xs = [x + y for x, y in zip(xs, ys)]
        elif cfg.family == "hybrid":
            m_body = self._maybe_remat(self._mamba_body)
            for g, (mamba, _) in enumerate(self.groups(params)):
                for j, mp in enumerate(stacked(mamba)):
                    xs = m_body(rules, mp, xs, sink=at(g, j))
                xs = self._apply_attn_ffn(rules, params["shared_block"], xs, batch_split,
                                          window=cfg.sliding_window, sink=at(g))
        else:
            dense0 = params.get("dense0", [])
            for i, bp in enumerate(dense0):
                xs = self._apply_attn_ffn(rules, bp, xs, batch_split, sink=at(i))
            body = self._maybe_remat(self._apply_attn_ffn)
            for i, bp in enumerate(stacked(params["blocks"]), start=len(dense0)):
                xs = body(rules, bp, xs, batch_split, sink=at(i))
        return xs if isinstance(x, list) else xs[0]

    # ------------------------------------------------------- encoder-decoder
    def _encode(self, params, frontend, batch_split: bool = True):
        """Audio encoder over stub frame embeddings (B, S_enc, D), or one a
        shard: the frontend adapter (replicated), then each bidirectional
        block (recomputed under ``remat``).  Under rules each shard's copy of
        the encoder output is whole over "model"."""
        rules = active_rules()
        fes = frontend if isinstance(frontend, list) else [frontend]
        xs = [fe.to(self.dtype) @ a for fe, a in zip(fes, locals_of(params["frontend_adapter"]))]
        body = self._maybe_remat(self._apply_attn_ffn)
        for bp in stacked(params["enc_blocks"]):
            xs = body(rules, bp, xs, batch_split, False)
        xs = self._norm(xs, params["enc_norm"])
        return xs if isinstance(frontend, list) else xs[0]

    def _apply_cross_block(self, rules, bp, xs: list, enc_outs: list, sink=None) -> list:
        cfg = self.cfg
        a = attention_block_shards(rules, bp["self_attn"], self._norm(xs, bp["ln1"]), cfg,
                                   causal=True, block=self.attn_block, use_kernel=self.use_kernel,
                                   sink=sink)
        xs = [x + y for x, y in zip(xs, a)]
        a = cross_attention_shards(rules, bp["cross_attn"], self._norm(xs, bp["ln_x"]), enc_outs,
                                   use_kernel=self.use_kernel, sink=sink)
        xs = [x + y for x, y in zip(xs, a)]
        f = glu_ffn_shards(rules, bp["ffn"], self._norm(xs, bp["ln2"]), cfg.act)
        return [x + y for x, y in zip(xs, f)]

    def _decoder(self, params, x, enc_out, sink=None):
        """The audio decoder over ``enc_out``: x (B, S, D) and enc_out
        (B, S_enc, D), or one of each a shard; each block recomputed under
        ``remat``; a cache ``sink`` at each layer."""
        rules = active_rules()
        xs = x if isinstance(x, list) else [x]
        enc_outs = enc_out if isinstance(enc_out, list) else [enc_out]
        body = self._maybe_remat(self._apply_cross_block)
        for i, bp in enumerate(stacked(params["dec_blocks"])):
            xs = body(rules, bp, xs, enc_outs, sink=None if sink is None else sink.at(i))
        return xs if isinstance(x, list) else xs[0]

    def _forward(self, params, xs: list, frontend, batch_split: bool, sink=None) -> list:
        """The embedded tokens ``xs`` (one a shard) through the model: the
        audio family's encoder over ``frontend`` and its decoder, else the
        backbone (the VLM's ``frontend``, where given, before the tokens).
        With a cache ``sink`` this is the cached prefill (``cache.py``)."""
        rules = active_rules()
        if self.cfg.family == "audio":
            enc = self._encode(params, split_batch(rules, frontend), batch_split)
            return self._decoder(params, xs, enc, sink)
        if self.cfg.family == "vlm" and frontend is not None:
            adapter = locals_of(params["frontend_adapter"])
            xs = [torch.cat([fe.to(self.dtype) @ a, x], dim=1)
                  for fe, a, x in zip(split_batch(rules, frontend), adapter, xs)]
        return self._backbone(params, xs, batch_split, sink)

    def logits_last(self, params, h_last):
        """h_last: (B, D) -> (B, Vp) f32 logits (vocab padded masked).  Under
        sharding rules ``h_last`` is a list of one (B_loc, D) state a shard,
        and so are the logits: the rules split the unembedding over its
        rows, so each shard's partial logits are all-reduced over "model"."""
        rules = active_rules()
        w = params["unembed"]
        hs = h_last if isinstance(h_last, list) else [h_last]
        split = split_dim_of(w) == 0
        outs = []
        for n, (h, wn) in enumerate(zip(hs, locals_of(w))):
            if split:
                h = h.narrow(-1, w.offsets(0)[n], wn.shape[0])
            outs.append((h @ wn).to(f32))
        if split:
            outs = all_reduce_sum(outs, rules.mesh, rules.tp_axis)
        live = torch.arange(self.vp, device=outs[0].device) < self.cfg.vocab
        outs = [torch.where(live.to(o.device), o, -1e30) for o in outs]
        return outs if isinstance(h_last, list) else outs[0]

    def _last_logits(self, params, hs: list, batch_split: bool) -> torch.Tensor:
        """The last position's logits (B, Vp) of one (B_loc, S, D) state a
        shard, the rows of the data groups gathered on the first shard's
        device."""
        rules = active_rules()
        outs = self.logits_last(params, self._norm([h[:, -1] for h in hs], params["final_norm"]))
        if rules is None or not batch_split:  # every shard holds every row
            return outs[0]
        mesh = rules.mesh
        rows: dict = {}  # one shard of each data group, in data order
        for n, coord in enumerate(mesh.coords):
            rows.setdefault(mesh.axis_index(coord, rules.axis("batch")), outs[n])
        return torch.cat([rows[d].to(mesh.devices[0]) for d in sorted(rows)], dim=0)

    # ---------------------------------------------------------------- losses
    def _xent_chunk(self, hh, w, ll, mm):
        """One chunk's (loss sum, correct count): hh (B, c, D), ll and mm (B, c)."""
        logits = (hh @ w).to(f32)                              # (B, c, Vp)
        live = torch.arange(self.vp, device=logits.device) < self.cfg.vocab
        logits = torch.where(live, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, ll[..., None])[..., 0]
        loss = torch.sum((lse - gold) * mm)
        with torch.no_grad():
            correct = torch.sum((gold >= logits.amax(dim=-1)).to(f32) * mm)
        return loss, correct

    def _chunked_xent(self, params, h, labels, mask):
        """Streaming softmax cross-entropy over sequence chunks: the
        reference's single-host branch.  h: (B, S, D); labels (B, S) int;
        mask (B, S) float32.  The chunk is the largest divisor of S not above
        ``loss_chunk``; padded vocab columns are −1e30.  Returns (mean loss
        over the masked positions, {"acc", "tokens"})."""
        b, s, d = h.shape
        c = _loss_chunk(s, self.loss_chunk)
        w = params["unembed"]
        loss_sum = torch.zeros((), dtype=f32, device=h.device)
        correct = torch.zeros((), dtype=f32, device=h.device)
        for c0 in range(0, s, c):
            loss, corr = self._xent_chunk(h[:, c0:c0 + c], w, labels[:, c0:c0 + c],
                                          mask[:, c0:c0 + c])
            loss_sum = loss_sum + loss
            correct = correct + corr
        denom = torch.clamp(mask.sum(), min=1.0)
        return loss_sum / denom, {"acc": correct / denom, "tokens": denom}

    def train_loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """batch: {"tokens": (B, S+1) [, "frontend": (B, P, D)]} -> (loss, metrics).

        Labels below 0 are masked out of the loss.  With no rules the head
        is :meth:`_chunked_xent`; under sharding rules ``params`` is
        ``shard_params``' tree, the forward runs over the mesh and the head
        is the vocab-sharded :func:`_sharded_chunk_xent` (module
        docstring), the reference's two branches."""
        rules, cfg = active_rules(), self.cfg
        tokens = batch["tokens"]
        toks = split_batch(rules, tokens)
        labels = [t[:, 1:] for t in toks]
        masks = [(lab >= 0).to(f32) for lab in labels]
        labels = [torch.clamp(lab, min=0).to(torch.int64) for lab in labels]
        batch_split = rules is None or tokens.shape[0] % rules.dp() == 0
        xs = self._embed(rules, params["embed"], [t[:, :-1] for t in toks])
        hs = self._forward(params, xs, batch["frontend"] if cfg.frontend else None, batch_split)
        if cfg.family == "vlm":
            hs = [h[:, cfg.n_frontend_tokens:] for h in hs]  # loss only over text positions
        hs = self._norm(hs, params["final_norm"])
        if rules is None:
            return self._chunked_xent(params, hs[0], labels[0], masks[0])
        denom = torch.clamp((tokens[:, 1:] >= 0).to(f32).sum(), min=1.0)
        s = hs[0].shape[1]
        n_chunks = s // _loss_chunk(s, self.loss_chunk)
        loss_sum, correct = _sharded_chunk_xent(rules, self.vp, cfg.vocab, n_chunks, batch_split)(
            hs, params["unembed"], labels, masks)
        denom = denom.to(loss_sum.device)
        return loss_sum / denom, {"acc": correct / denom, "tokens": denom}

    # --------------------------------------------------------------- serving
    def prefill(self, params, tokens, frontend=None, max_seq=None):
        """Returns (last-position logits (B, Vp), populated cache).

        The cache reserves decode headroom up to ``max_seq`` total positions
        (default: prefill length + ``cache.DECODE_RESERVE``).  Under sharding
        rules over the mesh, the cache placed by ``cache_pspecs``."""
        from repro_torch.models.lm.cache import build_prefill_cache

        return build_prefill_cache(self, params, tokens, frontend, max_seq)

    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) -> (logits (B, Vp), the cache, updated in place);
        under sharding rules over the mesh, on a placed cache."""
        from repro_torch.models.lm.cache import decode_step

        return decode_step(self, params, cache, tokens)

    def prefill_logits(self, params, tokens, frontend=None) -> torch.Tensor:
        """The last position's logits (B, Vp) of a prefill, without its cache;
        under sharding rules over the mesh."""
        rules = active_rules()
        batch_split = rules is None or tokens.shape[0] % rules.dp() == 0
        xs = self._embed(rules, params["embed"], split_batch(rules, tokens))
        return self._last_logits(params, self._forward(params, xs, frontend, batch_split),
                                 batch_split)

    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        """An empty cache; under sharding rules placed on their mesh."""
        from repro_torch.models.lm.cache import init_cache

        return init_cache(self, batch, max_seq, device)
