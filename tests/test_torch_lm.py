"""The port's dense LM against the JAX reference's, on the CPU.

Layers (``rms_norm``, ``rope``, ``glu_ffn``, ``attention_qkv``) and the
whole ``_backbone`` and ``logits_last`` of ``qwen1.5-0.5b``'s reduced
config (4 layers, d 128, 4 query heads on 2 KV heads: GQA).  The JAX
parameters come from ``LM.init(PRNGKey(0))`` with every bias and norm
weight overwritten by seeded numpy noise (``init`` leaves them zero and
one, which would hide a dropped bias or norm), carried across with
``bridge.lm_params_from_numpy``; tokens are the same numpy array.  Both
attention branches of the CPU route are held: ``attention_full`` (S = 48)
and ``attention_blockwise`` (``attn_block=16``, S = 64).

Errors are measured as max |port − reference| over max |reference|.
float32: within 1e-4.  bf16: within 3e-2; a run measured 1.4e-2 on the
backbone and 9.5e-3 on the logits (2 bf16 ulps at the largest activation,
8.8): XLA and PyTorch round bf16 products and sums at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.lm import LM as RefLM
from repro.models.lm import layers as ref_layers
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from repro_torch.models.lm import layers

REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# leaf -> (centre, spread) of the noise that replaces it
NOISY = {"bq": (0.0, 0.5), "bk": (0.0, 0.5), "bv": (0.0, 0.5),
         "ln1": (1.0, 0.3), "ln2": (1.0, 0.3), "final_norm": (1.0, 0.3)}


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def _cfgs(dtype):
    return (dataclasses.replace(ref_get_config("qwen1.5-0.5b").reduced(), dtype=dtype),
            dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), dtype=dtype))


def test_config_is_the_references():
    for want, got in ((ref_get_config("qwen1.5-0.5b"), get_config("qwen1.5-0.5b")),
                      _cfgs("bfloat16")):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.resolved_head_dim == want.resolved_head_dim
    for arch in ("xlstm-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2"):
        ref_get_config(arch)
        with pytest.raises(KeyError, match="not ported"):
            get_config(arch)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 48, 4, 32)).astype(np.float32)
    w = rng.normal(1, 0.3, (32,)).astype(np.float32)
    pos = np.arange(48)[None, :]
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel_err(got, ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))) < 1e-6
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    assert _rel_err(got, ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)) < 1e-5


def test_glu_ffn_and_attention_qkv_match_reference():
    ref_cfg, cfg = _cfgs("float32")
    rng = np.random.default_rng(1)
    ffn = {n: rng.normal(0, 0.1, s).astype(np.float32) for n, s in
           (("w_gate", (128, 256)), ("w_up", (128, 256)), ("w_down", (256, 128)))}
    x = rng.normal(0, 1, (2, 48, 128)).astype(np.float32)
    for act in ("swiglu", "geglu"):
        want = ref_layers.glu_ffn({n: jnp.asarray(a) for n, a in ffn.items()}, jnp.asarray(x), act)
        got = layers.glu_ffn({n: torch.from_numpy(a) for n, a in ffn.items()},
                             torch.from_numpy(x), act)
        assert _rel_err(got, want) < 1e-5, act
    attn = {n: rng.normal(0, 0.1, s).astype(np.float32) for n, s in
            (("wq", (128, 4, 32)), ("wk", (128, 2, 32)), ("wv", (128, 2, 32)),
             ("bq", (4, 32)), ("bk", (2, 32)), ("bv", (2, 32)))}
    pos = np.arange(48)[None, :]
    want = ref_layers.attention_qkv({n: jnp.asarray(a) for n, a in attn.items()},
                                    jnp.asarray(x), ref_cfg, jnp.asarray(pos))
    got = layers.attention_qkv({n: torch.from_numpy(a) for n, a in attn.items()},
                               torch.from_numpy(x), cfg, torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) < 1e-5


def _noisy_numpy(tree, rng, name=""):
    """The tree as float32 numpy, biases and norm weights replaced by noise."""
    if isinstance(tree, dict):
        return {k: _noisy_numpy(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree.astype(jnp.float32))
    if name in NOISY:
        a = rng.normal(*NOISY[name], a.shape).astype(np.float32)
    return a


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    ref_cfg, cfg = _cfgs(request.param)
    ref_lm = RefLM(ref_cfg, remat=False)
    params = _noisy_numpy(ref_lm.init(jax.random.PRNGKey(0)), np.random.default_rng(1))
    assert all(np.abs(params["blocks"]["attn"][b]).min() > 0 for b in ("bq", "bk", "bv"))
    ref_params = jax.tree.map(lambda a: jnp.asarray(a).astype(ref_lm.dtype), params)
    return request.param, ref_cfg, ref_params, cfg, lm_params_from_numpy(params, LM(cfg).dtype)


@pytest.mark.parametrize("seq,attn_block,branch", [
    (48, 1024, "attention_full"),
    (64, 16, "attention_blockwise"),
])
def test_backbone_and_logits_match_reference(models, seq, attn_block, branch, monkeypatch):
    dtype, ref_cfg, ref_params, cfg, params = models
    calls = []
    monkeypatch.setattr(layers, branch, _counting(getattr(layers, branch), calls))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, seq))
    ref_lm = RefLM(ref_cfg, remat=False, attn_block=attn_block)
    x = ref_params["embed"][jnp.asarray(tokens)].astype(ref_lm.dtype)
    want_h = jax.jit(ref_lm._backbone)(ref_params, x)
    want_logits = ref_lm.logits_last(ref_params, want_h[:, -1])

    lm = LM(cfg, attn_block=attn_block)
    h = lm._backbone(params, lm.embed(params, torch.from_numpy(tokens)))
    logits = lm.logits_last(params, h[:, -1])
    assert len(calls) == cfg.n_layers
    assert h.dtype == lm.dtype and h.shape == (2, seq, cfg.d_model)
    assert _rel_err(h, want_h) < REL_TOL[dtype]
    assert logits.dtype == torch.float32 and logits.shape == (2, lm.vp)
    live = slice(0, cfg.vocab)
    assert _rel_err(logits[:, live], want_logits[:, live]) < REL_TOL[dtype]
    assert bool((logits[:, cfg.vocab:] == -1e30).all())


def _counting(fn, calls):
    def wrapped(*args, **kwargs):
        calls.append(fn.__name__)
        return fn(*args, **kwargs)
    return wrapped


def test_init_has_the_references_tree_and_scales():
    _, cfg = _cfgs("bfloat16")
    ref_lm = RefLM(_cfgs("bfloat16")[0], remat=False)
    want = jax.eval_shape(ref_lm.init, jax.random.PRNGKey(0))
    got = LM(cfg).init(torch.Generator().manual_seed(0))
    flat_w = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(want)}

    def walk(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{path}['{k}']")
        else:
            yield path, t

    flat_g = dict(walk(got))
    assert set(flat_g) == set(flat_w)
    for path, t in flat_g.items():
        assert tuple(t.shape) == flat_w[path].shape, path
        assert t.dtype == torch.bfloat16, path
    assert abs(float(got["embed"].float().std()) - 0.02) < 1e-3
    assert abs(float(got["unembed"].float().std()) - 128 ** -0.5) < 3e-3
    assert bool((got["blocks"]["ln1"] == 1).all()) and bool((got["blocks"]["attn"]["bq"] == 0).all())


def test_other_families_raise():
    """The SSM, hybrid and audio families (xlstm-1.3b, zamba2-2.7b,
    seamless-m4t-large-v2) are not ported."""
    for arch in ("xlstm-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2"):
        family = ref_get_config(arch).family
        cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), family=family)
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            LM(cfg)
