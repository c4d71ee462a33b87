"""LM serving for the SSM, hybrid and audio families against the JAX reference, on the CPU.

``LM.init``, ``init_cache``, ``prefill`` and ``decode_step`` of xlstm-1.3b
(``ssm``: groups of mLSTM blocks and one sLSTM), zamba2-2.7b (``hybrid``:
Mamba2 groups and one shared attention block with a sliding window) and
seamless-m4t-large-v2 (``audio``: an encoder over frontend frames and a
decoder with cross attention) at their reduced configs.

The parameters come from the port's ``LM.init`` in float32 (whose tree,
shapes and types are checked against the reference's) with the leaves that
``init`` leaves at 0 or 1 overwritten by seeded numpy noise (``NOISY``),
handed to the reference as arrays of the types its ``init`` gives and to
the port by ``bridge.lm_params_from_numpy``; tokens and frontends are the
same numpy arrays.  Errors are max |port − reference| over max
|reference|: float32 within 1e-4, bf16 within 3e-2.  The reference is
compiled without XLA's excess precision (``xla_allow_excess_precision=
False``), so that its bf16 values are rounded where its program rounds
them, as the port's are: with it, XLA's own jitted and op-by-op xLSTM
prefills differ by 0.11 on the sLSTM state.

Decode is teacher-forced.  In float32 the port's decode runs on its own
cache; in bf16 each step starts from the reference's cache of the step
before, carried across: a step from the same state is bitwise the
reference's on the xLSTM, whose exponential gating carries one bf16
rounding of the prefill (1 ulp a block) to 3.9e-2 on the logits after two
chained steps.

The hybrid's window ring is held at S = 40, 96 and 128 around its window of
64 (``attn_block=32``: S = 96 and 128 take the reference's blockwise
attention with the window): the port copies the reference's ring, both of
its quirks included (``models/lm/cache.py``), so ``decode(prefill(t[:S]),
t[S])`` is as far from ``prefill(t[:S+1])`` in the port as in the
reference.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.lm import LM as RefLM
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("xlstm-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2")
REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
STRICT = {"xla_allow_excess_precision": False}
# leaf -> (centre, spread) of the noise that replaces it
NOISY = {"dt_bias": (0.5, 0.5), "a_log": (0.0, 0.5), "d_skip": (1.0, 0.5), "conv_b": (0.0, 0.3),
         "b_i": (0.0, 0.5), "b_f": (3.0, 0.5), "out_norm": (1.0, 0.3), "ln": (1.0, 0.3),
         "ln1": (1.0, 0.3), "ln2": (1.0, 0.3), "ln_x": (1.0, 0.3), "final_norm": (1.0, 0.3),
         "enc_norm": (1.0, 0.3)}
B, S, N_DECODE = 2, 40, 3


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel_err(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, (*path, k))
    else:
        yield path, tree


def _noisy_numpy(tree, rng):
    """The tree as float32 numpy, the ``NOISY`` leaves replaced by noise
    (sLSTM's ``b`` too: the forget gate's third of it is 3 at init)."""
    out = {}
    for path, t in _walk(tree):
        a = t.float().numpy()
        name = path[-1]
        if name in NOISY or path[-3:] == ("slstm", "cell", "b"):
            centre, spread = NOISY.get(name, (0.0, 0.5))
            a = (a if name == "b" else centre) + rng.normal(0, spread, a.shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = a.astype(np.float32)
    return out


def _to_ref(tree, shapes):
    """Numpy tree -> the reference's arrays, in the types its ``init`` gives."""
    if isinstance(tree, dict):
        return {k: _to_ref(v, shapes[k]) for k, v in tree.items()}
    return jnp.asarray(tree).astype(shapes.dtype)


@functools.cache
def _compiled(fn, treedef, avals):
    return jax.jit(fn).lower(*jax.tree.unflatten(treedef, avals)).compile(STRICT)


def strict(fn, *args):
    """``fn(*args)`` jitted, compiled without excess precision (once per
    function and argument shapes)."""
    leaves, treedef = jax.tree.flatten(args)
    avals = tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in leaves)
    return _compiled(fn, treedef, avals)(*args)


@functools.cache
def _float32_params(arch):
    _, cfg = _cfgs(arch, "float32")
    return _noisy_numpy(LM(cfg).init(torch.Generator().manual_seed(0)), np.random.default_rng(1))


@functools.cache
def _models(arch, dtype, attn_block=64):
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref_lm = RefLM(ref_cfg, remat=False, attn_block=attn_block)
    lm = LM(cfg, attn_block=attn_block)
    params = _float32_params(arch)
    shapes = jax.eval_shape(ref_lm.init, jax.random.PRNGKey(0))
    return ref_lm, _to_ref(params, shapes), lm, lm_params_from_numpy(params, lm.dtype)


def _inputs(cfg, seed, b=B, s=S):
    """Tokens (b, s) and, for the audio family, frontend frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s))
    fe = (rng.normal(0, 1, (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
          if cfg.frontend else None)
    return tokens, fe


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port_cache(ref_cache, lm):
    """The reference's cache as the port's (a copy: decode writes in place)."""
    out = {name: torch.from_numpy(np.array(val.astype(jnp.float32)))
           .to(torch.float32 if val.dtype == jnp.float32 else lm.dtype)
           for name, val in ref_cache.items() if name != "pos"}
    out["pos"] = int(ref_cache["pos"])
    return out


def _check_step(lm, logits, cache, ref_logits, ref_cache, tol, what):
    vocab = lm.cfg.vocab
    assert logits.dtype == torch.float32 and logits.shape == (B, lm.vp)
    assert _rel_err(logits[:, :vocab], ref_logits[:, :vocab]) < tol, what
    assert bool((logits[:, vocab:] == -1e30).all())
    assert set(cache) == set(ref_cache)
    assert cache["pos"] == int(ref_cache["pos"]), what
    for name in cache:
        if name != "pos":
            assert str(cache[name].dtype).removeprefix("torch.") == str(ref_cache[name].dtype)
            assert _rel_err(cache[name], ref_cache[name]) < tol, (what, name)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_are_the_references(arch):
    want, got = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.sub_quadratic == want.sub_quadratic
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_references_tree_and_types(arch):
    """Every leaf's path, shape and type, in bf16 (the gate and decay
    leaves float32), and the stds and fills of ``init``."""
    ref_cfg, cfg = _cfgs(arch, "bfloat16")
    want = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(RefLM(ref_cfg, remat=False).init, jax.random.PRNGKey(0))))
    got = LM(cfg).init(torch.Generator().manual_seed(0))
    flat = {"".join(f"['{k}']" for k in path): t for path, t in _walk(got)}
    assert set(flat) == set(want)
    for path, t in flat.items():
        assert tuple(t.shape) == want[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == str(want[path].dtype), path
    if cfg.family == "ssm":
        cell = got["slstm"]["cell"]
        assert bool((cell["b"][:, 2 * cfg.d_model:3 * cfg.d_model] == 3).all())
        assert bool((got["mlstm"]["cell"]["b_f"] == 3).all())
        assert abs(float(cell["r"].std()) - (cfg.d_model // cfg.n_heads) ** -0.5) < 2e-2
    elif cfg.family == "hybrid":
        cell = got["mamba"]["cell"]
        assert bool((cell["d_skip"] == 1).all()) and not cell["a_log"].any()
        assert abs(float(cell["conv_w"].float().std()) - 0.1) < 5e-3
    else:
        assert bool((got["dec_blocks"]["ln_x"] == 1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_keeps_the_references_types(arch):
    """The reference's own bf16 ``init``, bridged, keeps every leaf's type
    (``bridge.FLOAT32_LEAVES``, matched by path: sLSTM's bare ``w``, ``r``
    and ``b`` are float32, no other ``w`` or ``b`` is)."""
    ref_cfg, _ = _cfgs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, jax.jit(RefLM(ref_cfg, remat=False).init)(
        jax.random.PRNGKey(0)))
    got = lm_params_from_numpy(tree, torch.bfloat16)
    want = dict(_walk(tree))
    for path, t in _walk(got):
        assert str(t.dtype).removeprefix("torch.") == want[path].dtype.name, path
        np.testing.assert_array_equal(t.float().numpy(), want[path].astype(np.float32))


# ------------------------------------------------------------------ cache
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_is_the_references(arch):
    ref_lm, _, lm, _ = _models(arch, "bfloat16")
    want = ref_lm.init_cache(B, 80)
    got = lm.init_cache(B, 80, "cpu")
    assert set(got) == set(want) and got["pos"] == int(want["pos"]) == 0
    for name in got:
        if name != "pos":
            assert tuple(got[name].shape) == want[name].shape, name
            assert str(got[name].dtype).removeprefix("torch.") == str(want[name].dtype), name
            np.testing.assert_array_equal(_np(got[name]), _np(want[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits and every cache leaf, then three teacher-forced
    decode steps (bf16: each from the reference's cache, module docstring)."""
    ref_lm, ref_params, lm, params = _models(arch, dtype)
    tol = REL_TOL[dtype]
    tokens, fe = _inputs(lm.cfg, seed=2)
    steps = np.random.default_rng(3).integers(0, lm.cfg.vocab, (N_DECODE, B, 1))
    ref_logits, ref_cache = strict(ref_lm.prefill, ref_params, _j(tokens), _j(fe))
    logits, cache = lm.prefill(params, _t(tokens), _t(fe))
    assert cache["pos"] == S
    _check_step(lm, logits, cache, ref_logits, ref_cache, tol, "prefill")
    for i, tok in enumerate(steps):
        if dtype == "bfloat16":
            cache = _port_cache(ref_cache, lm)
        ref_logits, ref_cache = strict(ref_lm.decode_step, ref_params, ref_cache, jnp.asarray(tok))
        logits, cache = lm.decode_step(params, cache, torch.from_numpy(tok))
        _check_step(lm, logits, cache, ref_logits, ref_cache, tol, f"decode step {i}")
    assert cache["pos"] == S + N_DECODE


@pytest.mark.parametrize("s", [40, 96, 128])
def test_hybrid_window_ring_is_the_references(s):
    """zamba2's shared attention over a window of 64 (float32): prefill and
    decode of t[S] match the reference, ring size ``min(64, S)`` and slot
    ``pos % ring`` included, and so does their gap to ``prefill(t[:S+1])``
    (the reference's ring quirks: position 0 evicted below the window,
    slots misaligned at S % 64 != 0, exact at S = 128)."""
    ref_lm, ref_params, lm, params = _models("zamba2-2.7b", "float32", attn_block=32)
    assert lm.cfg.sliding_window == 64
    tokens, _ = _inputs(lm.cfg, seed=7, s=s + 1)
    ref_logits, ref_cache = strict(ref_lm.prefill, ref_params, _j(tokens[:, :s]))
    logits, cache = lm.prefill(params, _t(tokens[:, :s]))
    assert cache["k"].shape[2] == min(64, s)
    _check_step(lm, logits, cache, ref_logits, ref_cache, 1e-4, "prefill")
    ref_step, ref_cache = strict(ref_lm.decode_step, ref_params, ref_cache,
                                 jnp.asarray(tokens[:, s:]))
    step, cache = lm.decode_step(params, cache, _t(tokens[:, s:]))
    _check_step(lm, step, cache, ref_step, ref_cache, 1e-4, "decode")
    ref_full, _ = strict(ref_lm.prefill, ref_params, _j(tokens))
    full, _ = lm.prefill(params, _t(tokens))
    vocab = lm.cfg.vocab
    ref_gap = float(jnp.abs(ref_step - ref_full)[:, :vocab].max())
    gap = float((step - full)[:, :vocab].abs().max())
    assert abs(gap - ref_gap) <= 1e-4 * float(jnp.abs(ref_full[:, :vocab]).max())
    assert (ref_gap < 1e-3) == (s == 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_guard_only_on_absolute_slots(arch):
    """The audio family's self-attention cache refuses a decode past
    ``max_seq``; the hybrid's ring and the xLSTM's state take any number."""
    _, _, lm, params = _models(arch, "float32")
    tokens, fe = _inputs(lm.cfg, seed=4, s=16)
    _, cache = lm.prefill(params, _t(tokens), _t(fe), max_seq=17)
    lm.decode_step(params, cache, _t(tokens[:, :1]))
    if lm.cfg.family == "audio":
        with pytest.raises(ValueError, match="KV cache exhausted"):
            lm.decode_step(params, cache, _t(tokens[:, :1]))
    else:
        for _ in range(3):
            _, cache = lm.decode_step(params, cache, _t(tokens[:, :1]))
        assert cache["pos"] == 20


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(t[:-1]), t[-1]) matches prefill(t), with the reference
    test's tolerance (bf16, S = 64)."""
    _, _, lm, params = _models(arch, "bfloat16")
    tokens, fe = _inputs(lm.cfg, seed=5, s=64)
    full, _ = lm.prefill(params, _t(tokens), _t(fe))
    _, cache = lm.prefill(params, _t(tokens[:, :-1]), _t(fe))
    step, _ = lm.decode_step(params, cache, _t(tokens[:, -1:]))
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=5e-2, atol=5e-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_sequence_forward_matches_reference(arch):
    """``_backbone`` (SSM, hybrid) and ``_decoder(_encode(frontend))``
    (audio), the reference's full-sequence forwards, in float32."""
    ref_lm, ref_params, lm, params = _models(arch, "float32")
    tokens, fe = _inputs(lm.cfg, seed=8)
    x = lm.embed(params, _t(tokens))
    ref_x = jnp.asarray(x.numpy())
    if lm.cfg.family == "audio":
        want = strict(lambda p, h, f: ref_lm._decoder(p, h, ref_lm._encode(p, f)), ref_params,
                      ref_x, _j(fe))
        got = lm._decoder(params, x, lm._encode(params, _t(fe)))
    else:
        want = strict(ref_lm._backbone, ref_params, ref_x)
        got = lm._backbone(params, x)
    assert got.shape == (B, S, lm.cfg.d_model)
    assert _rel_err(got, want) < REL_TOL["float32"]
