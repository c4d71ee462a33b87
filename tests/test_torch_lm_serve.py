"""LM serving in the port against the JAX reference, on the CPU.

``LM.prefill`` / ``decode_step`` / ``init_cache`` for the seven ported
architectures (``dense``: qwen1.5-0.5b, qwen3-8b, qwen3-14b, gemma-7b;
``vlm``: internvl2-1b; ``moe``: granite-moe-1b-a400m and deepseek-v2-236b
with MLA and a leading dense layer) at their reduced configs (4 layers,
d 128), and the layers under them: ``attention_decode`` (with and without a
window), MLA's block, with-cache and absorbed decode, both MoE dispatch
backends with a capacity that drops tokens, and zero-padded query heads.

The parameters come from the port's ``LM.init`` in float32 (whose tree,
shapes and types are checked against the reference's) with every bias and
norm weight overwritten by seeded numpy noise (``init`` leaves them zero
and one, which would hide a dropped bias or norm), handed to the reference
as arrays of its type and to the port by ``bridge.lm_params_from_numpy``; tokens and frontends are the same numpy
arrays.  Errors are max |port − reference| over max |reference|: within
1e-4 in float32 and 3e-2 in bf16.  Decode is teacher-forced (both sides
take the same tokens), so a near-tie in an argmax cannot fork them.

In bf16 the MoE cases route by a fixed table (``_table_router``, patched
into both packages' ``moe._router``): expert ``(t % 3 + j) % E`` for the
j-th choice of flat token t, a skew that overflows some queues, with the
gates the softmax gives those experts.  A top-k choice within a bf16
rounding of a tie goes either way, and the two packages round bf16
products in different places: the reference's own jitted and op-by-op
prefills of granite differ by 0.35 on the cache that way.  The float32
cases keep the learned router and match the reference's choices and
drops exactly, as do the MoE layer tests.
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
from repro.models.lm import layers as ref_layers
from repro.models.lm import moe as ref_moe
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.lm import LM, cache as cache_lib, layers, moe
from repro_torch.models.lm.moe import dropless
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)

REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
NEW_ARCHS = ("qwen3-8b", "qwen3-14b", "gemma-7b", "internvl2-1b", "granite-moe-1b-a400m",
             "deepseek-v2-236b")
# leaf -> (centre, spread) of the noise that replaces it
NOISY = {"bq": (0.0, 0.5), "bk": (0.0, 0.5), "bv": (0.0, 0.5),
         "ln1": (1.0, 0.3), "ln2": (1.0, 0.3), "final_norm": (1.0, 0.3),
         "q_norm": (1.0, 0.3), "k_norm": (1.0, 0.3), "kv_norm": (1.0, 0.3)}
B, S, N_DECODE = 2, 32, 3


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


def _noisy_numpy(tree, rng, name=""):
    """The tree as float32 numpy, biases and norm weights replaced by noise."""
    if isinstance(tree, dict):
        return {k: _noisy_numpy(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_noisy_numpy(v, rng, name) for v in tree]
    a = np.asarray(tree, np.float32)
    if name in NOISY:
        a = rng.normal(*NOISY[name], a.shape).astype(np.float32)
    return a


def _to_ref(tree, dtype, name=""):
    """Numpy tree -> the reference's arrays: the model's type, the router float32."""
    if isinstance(tree, dict):
        return {k: _to_ref(v, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_ref(v, dtype, name) for v in tree]
    return jnp.asarray(tree).astype(jnp.float32 if name == "router" else dtype)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


@functools.cache
def _float32_params(arch):
    """One float32 parameter tree an arch for both packages and both types:
    the port's ``init`` (the reference's tree and stds, checked below),
    biases and norm weights noised."""
    _, cfg = _cfgs(arch, "float32")
    tree = _numpy_tree(LM(cfg).init(torch.Generator().manual_seed(0)))
    return _noisy_numpy(tree, np.random.default_rng(1))


@functools.cache
def _models(arch, dtype):
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref_lm, lm = RefLM(ref_cfg, remat=False, attn_block=64), LM(cfg, attn_block=64)
    params = _float32_params(arch)
    return ref_lm, _to_ref(params, ref_lm.dtype), lm, lm_params_from_numpy(params, lm.dtype)


def _inputs(cfg, seed, b=B, s=S):
    """Tokens (b, s) and, for the VLM, a frontend (b, n_frontend_tokens, d)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s))
    fe = (rng.normal(0, 1, (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
          if cfg.frontend else None)
    return tokens, fe


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _table(t: int, cfg):
    """Expert ``(t % 3 + j) % E`` for the j-th choice of flat token t."""
    return (np.arange(t)[:, None] % 3 + np.arange(cfg.top_k)[None, :]) % cfg.n_experts


def _ref_table_router(p, x_flat, cfg):
    """The reference's ``_router`` on the fixed table (gates renormalised)."""
    probs = jax.nn.softmax(x_flat.astype(jnp.float32) @ p["router"], axis=-1)
    idx = jnp.asarray(_table(x_flat.shape[0], cfg))
    gates = jnp.take_along_axis(probs, idx, axis=-1)
    return gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9), idx


def _table_router(p, x_flat, cfg):
    """The port's ``_router`` on the fixed table (gates renormalised)."""
    probs = torch.softmax(x_flat.to(torch.float32) @ p["router"], dim=-1)
    idx = torch.from_numpy(_table(x_flat.shape[0], cfg))
    gates = torch.gather(probs, -1, idx)
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), idx


@pytest.fixture
def routing(monkeypatch):
    """Route both packages' MoE by the fixed table, when called."""
    def use_table():
        monkeypatch.setattr(ref_moe, "_router", _ref_table_router)
        monkeypatch.setattr(moe, "_router", _table_router)
    return use_table


def _check_step(lm, logits, cache, ref_logits, ref_cache, tol, what):
    vocab = lm.cfg.vocab
    assert logits.dtype == torch.float32 and logits.shape == (B, lm.vp)
    assert _rel_err(logits[:, :vocab], ref_logits[:, :vocab]) < tol, what
    assert bool((logits[:, vocab:] == -1e30).all())
    assert set(cache) == set(ref_cache)
    assert cache["pos"] == int(ref_cache["pos"]), what
    for name in cache:
        if name != "pos":
            assert cache[name].dtype == lm.dtype
            assert _rel_err(cache[name], ref_cache[name]) < tol, (what, name)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_and_param_count_are_the_references(arch):
    want, got = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got.resolved_head_dim == want.resolved_head_dim
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_has_the_references_tree(arch):
    ref_cfg, cfg = _cfgs(arch, "bfloat16")
    want = jax.eval_shape(RefLM(ref_cfg, remat=False).init, jax.random.PRNGKey(0))
    got = LM(cfg).init(torch.Generator().manual_seed(0))
    flat_w = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(want)}

    def walk(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{path}['{k}']")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from walk(v, f"{path}[{i}]")
        else:
            yield path, t

    flat_g = dict(walk(got))
    assert set(flat_g) == set(flat_w)
    for path, t in flat_g.items():
        assert tuple(t.shape) == flat_w[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == str(flat_w[path].dtype), path


# ------------------------------------------------------------------ cache
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_is_the_references(arch):
    ref_lm, _, lm, _ = _models(arch, "bfloat16")
    want = ref_lm.init_cache(B, 40)
    got = lm.init_cache(B, 40, "cpu")
    assert set(got) == set(want) and got["pos"] == int(want["pos"]) == 0
    for name in got:
        if name != "pos":
            assert tuple(got[name].shape) == want[name].shape, name
            assert got[name].dtype == lm.dtype and want[name].dtype == ref_lm.dtype
            assert not got[name].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch, dtype, routing):
    """Prefill logits and cache, then three teacher-forced decode steps."""
    ref_lm, ref_params, lm, params = _models(arch, dtype)
    if lm.cfg.moe and dtype == "bfloat16":
        routing()
    tol = REL_TOL[dtype]
    tokens, fe = _inputs(lm.cfg, seed=2)
    steps = np.random.default_rng(3).integers(0, lm.cfg.vocab, (N_DECODE, B, 1))
    ref_logits, ref_cache = jax.jit(ref_lm.prefill)(ref_params, _j(tokens), _j(fe))
    logits, cache = lm.prefill(params, _t(tokens), _t(fe))
    n_pos = S + (lm.cfg.n_frontend_tokens if fe is not None else 0)
    assert cache["pos"] == n_pos
    _check_step(lm, logits, cache, ref_logits, ref_cache, tol, "prefill")
    ref_decode = jax.jit(ref_lm.decode_step)
    for i, tok in enumerate(steps):
        ref_logits, ref_cache = ref_decode(ref_params, ref_cache, jnp.asarray(tok))
        logits, cache = lm.decode_step(params, cache, torch.from_numpy(tok))
        _check_step(lm, logits, cache, ref_logits, ref_cache, tol, f"decode step {i}")
    assert cache["pos"] == n_pos + N_DECODE


def _steps_until_guard(prefill, decode, tokens, max_seq):
    """Decode steps that succeed after ``prefill(tokens, max_seq)`` before
    the capacity guard raises (None: four succeed)."""
    _, cache = prefill(tokens, max_seq=max_seq)
    for n in range(4):
        try:
            _, cache = decode(cache, tokens[:, :1])
        except ValueError as e:
            assert "KV cache exhausted" in str(e)
            return n
    return None


@functools.cache
def _reference_guard_steps(max_seq):
    """The reference's steps for a 16-token prompt (qwen1.5-0.5b, eager
    decode: under jit the reference skips its guard)."""
    ref_lm, ref_params, lm, _ = _models("qwen1.5-0.5b", "float32")
    tokens, _ = _inputs(lm.cfg, seed=4, s=16)
    prefill = jax.jit(ref_lm.prefill, static_argnames="max_seq")
    return _steps_until_guard(functools.partial(prefill, ref_params),
                              functools.partial(ref_lm.decode_step, ref_params),
                              jnp.asarray(tokens), max_seq)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_capacity_guard_raises_at_the_references_positions(arch):
    """A cache of no, two and (max_seq below the prompt) no decode slots."""
    _, _, lm, params = _models(arch, "float32")
    tokens, fe = _inputs(lm.cfg, seed=4, s=16)
    n_front = lm.cfg.n_frontend_tokens if fe is not None else 0
    prefill = functools.partial(lm.prefill, params, frontend=_t(fe))
    for max_seq in (16, 18, 12):
        got = _steps_until_guard(prefill, functools.partial(lm.decode_step, params),
                                 torch.from_numpy(tokens), max_seq + n_front)
        assert got == _reference_guard_steps(max_seq) == max(max_seq - 16, 0), max_seq


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(t[:-1]), t[-1]) matches prefill(t), with the reference
    test's tolerance (bf16).  MoE runs dropless here (``DROPLESS``): an
    expert's capacity follows the token count, so the partial prefill, the
    decode step and the full prefill drop different (token, k)'s, in the
    reference as in the port."""
    _, _, lm, params = _models(arch, "bfloat16")
    if lm.cfg.moe:
        lm = LM(dropless(lm.cfg), attn_block=64)
    tokens, fe = _inputs(lm.cfg, seed=5)
    full, _ = lm.prefill(params, _t(tokens), _t(fe))
    _, cache = lm.prefill(params, _t(tokens[:, :-1]), _t(fe))
    step, _ = lm.decode_step(params, cache, _t(tokens[:, -1:]))
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=5e-2, atol=5e-1)


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("window", [0, 12])
def test_attention_decode_matches_reference(window):
    rng = np.random.default_rng(6)
    q = rng.normal(0, 1, (2, 1, 4, 32)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 40, 2, 32)).astype(np.float32) for _ in range(2))
    for pos in (0, 17, 39):
        want = ref_layers.attention_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(pos), window=window)
        got = layers.attention_decode(*map(torch.from_numpy, (q, k, v)), pos, window=window)
        assert _rel_err(got, want) < 1e-5, pos


def test_windowed_decode_writes_the_ring_slot():
    """``attention_block_decode`` with a window writes slot pos % S in place."""
    _, cfg = _cfgs("qwen1.5-0.5b", "float32")
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    p = {n: t[0] for n, t in params["blocks"]["attn"].items()}
    ref_p = {n: jnp.asarray(t.numpy()) for n, t in p.items()}
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.normal(0, 1, (2, 8, 2, 32)).astype(np.float32) for _ in range(2))
    want = ref_layers.attention_block_decode(ref_p, jnp.asarray(x), jnp.asarray(ck),
                                             jnp.asarray(cv), jnp.asarray(11), _cfgs(
                                                 "qwen1.5-0.5b", "float32")[0], window=8)
    kt, vt = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = layers.attention_block_decode(p, torch.from_numpy(x), kt, vt, 11, cfg, window=8)
    assert got[1] is kt and got[2] is vt
    for g, w in zip(got, want):
        assert _rel_err(g, w) < 1e-5
    assert not np.array_equal(kt[:, 3].numpy(), ck[:, 3])
    np.testing.assert_array_equal(np.delete(kt.numpy(), 3, axis=1), np.delete(ck, 3, axis=1))


@pytest.fixture(scope="module")
def mla():
    ref_cfg, cfg = _cfgs("deepseek-v2-236b", "float32")
    rng = np.random.default_rng(8)
    p = _noisy_numpy(_numpy_tree(layers.init_mla(torch.Generator().manual_seed(3), cfg,
                                                 torch.float32)), rng)
    x = rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, p, x


@pytest.mark.parametrize("part", ["block", "with_cache", "decode"])
def test_mla_matches_reference(mla, part):
    ref_cfg, cfg, p, x = mla
    ref_p = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    if part == "block":
        pos = np.arange(3, 27)[None, :]
        want = [jax.jit(functools.partial(ref_layers.mla_block, cfg=ref_cfg))(
            ref_p, jnp.asarray(x), positions=jnp.asarray(pos))]
        got = [layers.mla_block(tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos))]
    elif part == "with_cache":
        want = jax.jit(functools.partial(ref_layers.mla_block_with_cache, cfg=ref_cfg))(
            ref_p, jnp.asarray(x))
        got = layers.mla_block_with_cache(tp, torch.from_numpy(x), cfg)
    else:
        m = cfg.mla
        rng = np.random.default_rng(9)
        ckv = rng.normal(0, 1, (2, 30, m.kv_lora)).astype(np.float32)
        kpe = rng.normal(0, 1, (2, 30, m.rope_dim)).astype(np.float32)
        want = jax.jit(functools.partial(ref_layers.mla_block_decode, cfg=ref_cfg))(
            ref_p, jnp.asarray(x[:, :1]), jnp.asarray(ckv), jnp.asarray(kpe), jnp.asarray(21))
        got = layers.mla_block_decode(tp, torch.from_numpy(x[:, :1]), torch.from_numpy(ckv),
                                      torch.from_numpy(kpe), 21, cfg)
    for g, w in zip(got, want):
        assert _rel_err(g, w) < 1e-5


def _queues(idx: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """First come, first served in (token, k) order: kept (T, K) bool."""
    count = np.zeros(n_experts, np.int64)
    kept = np.zeros(idx.shape, bool)
    for t in range(idx.shape[0]):
        for j in range(idx.shape[1]):
            kept[t, j] = count[idx[t, j]] < cap
            count[idx[t, j]] += 1
    return kept


@pytest.mark.parametrize("backend", ["einsum", "sorted"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v2-236b"])
def test_moe_matches_reference_and_drops_the_same_tokens(arch, backend):
    """A capacity factor of 0.5 drops (token, k)'s; the port drops the ones a
    first-come queue over the reference's own top-k drops, and its output
    matches the reference's (deepseek: with its two shared experts)."""
    ref_cfg, cfg = _cfgs(arch, "float32")
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=0.5, group_size=32)
    ref_mcfg = dataclasses.replace(ref_cfg.moe, capacity_factor=0.5, group_size=32)
    rng = np.random.default_rng(10)
    p = _noisy_numpy(_numpy_tree(moe.init_moe(torch.Generator().manual_seed(4), cfg.d_model,
                                              mcfg, torch.float32)), rng)
    x = rng.normal(0, 1, (2, 48, cfg.d_model)).astype(np.float32)
    ref_p = jax.tree.map(jnp.asarray, p)
    tp = lm_params_from_numpy(p, torch.float32)
    want = jax.jit(functools.partial(ref_moe.moe_ffn, cfg=ref_mcfg, backend=backend))(
        ref_p, jnp.asarray(x))
    got = moe.moe_ffn(tp, torch.from_numpy(x), mcfg, backend)
    assert _rel_err(got, want) < 1e-5

    flat = x.reshape(-1, cfg.d_model)
    _, ref_idx = jax.jit(functools.partial(ref_moe._router, cfg=ref_mcfg))(
        ref_p, jnp.asarray(flat))
    _, idx = moe._router(tp, torch.from_numpy(flat), mcfg)
    ref_idx = np.asarray(ref_idx)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    t, k, e = flat.shape[0], mcfg.top_k, mcfg.n_experts
    if backend == "einsum":
        g = mcfg.group_size
        cap = moe.capacity(g, mcfg)
        want_kept = np.concatenate([_queues(ref_idx[i:i + g], e, cap) for i in range(0, t, g)])
        _, within = moe.einsum_queues(idx.reshape(t // g, g, k), e, cap)
        kept = within.any(-1).reshape(t, k).numpy()
    else:
        cap = moe.capacity(t, mcfg)
        want_kept = _queues(ref_idx, e, cap)
        order, _, keep = moe.sorted_queues(idx, e, cap)
        kept = np.zeros(t * k, bool)
        kept[order.numpy()] = keep.numpy()
        kept = kept.reshape(t, k)
    assert 0 < (~want_kept).sum() < want_kept.size
    np.testing.assert_array_equal(kept, want_kept)


def test_sorted_backend_is_bitwise_run_to_run():
    _, cfg = _cfgs("granite-moe-1b-a400m", "bfloat16")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model, cfg.moe, torch.bfloat16)
    x = torch.randn((2, 48, cfg.d_model), generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16)
    a, b = (moe.moe_ffn_sorted(p, x, cfg.moe) for _ in range(2))
    assert torch.equal(a, b)
    err = _rel_err(a, moe.moe_ffn_einsum(p, x, dataclasses.replace(cfg.moe, group_size=96)))
    assert err < 3e-2


def test_padded_heads_exactness():
    """Zero-padded q heads do not change the output, and init zeroes
    exactly the per-group pad slots (``tests/test_lm_archs.py``'s test)."""
    _, cfg = _cfgs("qwen3-14b", "float32")  # 4 heads, 2 kv heads (gq = 2)
    cfg_nopad = dataclasses.replace(cfg, pad_heads_to=1)
    p = layers.init_attention(torch.Generator().manual_seed(0), cfg_nopad, torch.float32)
    d, h, hd = p["wq"].shape
    idx = torch.tensor([0, 1, 4, 5])
    wq = torch.zeros((d, 8, hd))
    wq[:, idx] = p["wq"]
    wo = torch.zeros((8, hd, d))
    wo[idx] = p["wo"]
    p_pad = dict(p, wq=wq, wo=wo)
    x = torch.randn((1, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out_nopad = layers.attention_block(p, x, cfg_nopad, block=64)
    out_pad = layers.attention_block(p_pad, x, cfg_nopad, block=64)
    torch.testing.assert_close(out_pad, out_nopad, rtol=1e-4, atol=1e-4)
    cfg_pad = dataclasses.replace(cfg, pad_heads_to=8)
    p2 = layers.init_attention(torch.Generator().manual_seed(0), cfg_pad, torch.float32)
    assert p2["wq"].shape[1] == 8
    pads = torch.tensor([2, 3, 6, 7])
    assert not p2["wq"][:, pads].any() and not p2["wo"][pads].any()
    assert p2["wq"][:, idx].abs().min() > 0


# ----------------------------------------------------------------- bridge
def test_bridge_takes_lists_and_keeps_the_router_float32():
    ref_cfg, _ = _cfgs("deepseek-v2-236b", "bfloat16")
    tree = jax.tree.map(np.asarray, jax.jit(RefLM(ref_cfg, remat=False).init)(
        jax.random.PRNGKey(0)))
    assert tree["blocks"]["moe"]["router"].dtype == np.float32
    assert tree["embed"].dtype.name == "bfloat16"
    got = lm_params_from_numpy(tree, torch.bfloat16)
    assert isinstance(got["dense0"], list) and len(got["dense0"]) == 1
    assert got["dense0"][0]["ffn"]["w_up"].dtype == torch.bfloat16
    assert got["blocks"]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(got["blocks"]["moe"]["router"].numpy(),
                                  tree["blocks"]["moe"]["router"])
    assert got["blocks"]["moe"]["shared"]["w_down"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))
    f32 = lm_params_from_numpy(tree, torch.float32)
    assert f32["blocks"]["attn"]["wkv_b"].dtype == torch.float32
    assert cache_lib.DECODE_RESERVE == 64
