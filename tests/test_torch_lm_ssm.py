"""The port's state-space and recurrent blocks against the JAX reference's, on the CPU.

``models/lm/ssm.py``: Mamba2 (``mamba2_block`` with its final state and
conv tail, ``mamba2_decode``), mLSTM (``mlstm_block``, ``mlstm_decode``)
and sLSTM (``slstm_block``, ``slstm_decode``) at the reduced configs of
zamba2-2.7b and xlstm-1.3b, each block's chunked (or scanned) prefill
against its own token-by-token decode, and ``_fit_chunk``, which falls to
chunk 1 at a prime length.  The parameters are the reference's ``init``
with the leaves that it leaves at 0 or 1 (``dt_bias``, ``a_log``,
``d_skip``, ``conv_b``, ``b_i``, ``b_f``, ``b``, ``out_norm``) overwritten
by seeded numpy noise, carried across by ``bridge.lm_params_from_numpy``
in the reference's types (float32 gate and decay leaves whatever the
model's type); inputs are the same numpy arrays.

Errors are max |port − reference| over max |reference|: float32 within
1e-4, bf16 within 3e-2.  The reference is compiled without XLA's excess
precision (``xla_allow_excess_precision=False``), so that its bf16 values
are rounded where its program rounds them, as the port's are.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.lm import ssm as ref_ssm
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models.lm import ssm
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)

REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
STRICT = {"xla_allow_excess_precision": False}
# leaf -> (centre, spread) of the noise that replaces it
NOISY = {"dt_bias": (0.5, 0.5), "a_log": (0.0, 0.5), "d_skip": (1.0, 0.5), "conv_b": (0.0, 0.3),
         "b_i": (0.0, 0.5), "b_f": (3.0, 0.5), "b": (0.0, 0.5), "out_norm": (1.0, 0.3)}
# block kind -> (config, tree key, reference init)
KINDS = {"mamba": ("zamba2-2.7b", ref_ssm.init_mamba2),
         "mlstm": ("xlstm-1.3b", ref_ssm.init_mlstm),
         "slstm": ("xlstm-1.3b", ref_ssm.init_slstm)}
B = 2


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel_err(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


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
def _block(kind, dtype):
    """(reference config, reference params, port config, port params)."""
    arch, init = KINDS[kind]
    ref_cfg, cfg = _cfgs(arch, dtype)
    ref_dtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    shapes = jax.eval_shape(functools.partial(init, cfg=ref_cfg, dtype=ref_dtype),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tree = {name: (rng.normal(*NOISY[name], a.shape) if name in NOISY else np.asarray(a))
            .astype(np.float32)
            for name, a in init(jax.random.PRNGKey(0), ref_cfg, jnp.float32).items()}
    ref_p = {name: jnp.asarray(a).astype(shapes[name].dtype) for name, a in tree.items()}
    port = lm_params_from_numpy({kind: {"cell": tree}}, torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)[kind]["cell"]
    for name, t in port.items():
        assert str(t.dtype).removeprefix("torch.") == str(shapes[name].dtype), name
    return ref_cfg, ref_p, cfg, port


def _x(cfg, dtype, length, seed=2):
    x = np.random.default_rng(seed).normal(0, 1, (B, length, cfg.d_model)).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("length", [64, 37, 1])
def test_fit_chunk_matches_reference(length):
    for chunk in (1, 8, 32, 256):
        assert ssm._fit_chunk(length, chunk) == ref_ssm._fit_chunk(length, chunk)
    assert ssm._fit_chunk(37, 32) == 1


@pytest.mark.parametrize("length", [64, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_block_and_state_match_reference(kind, dtype, length):
    """Each block over a prompt (64: two chunks of 32; 37: a prime, chunk
    1), with the state that decode continues from."""
    ref_cfg, ref_p, cfg, p = _block(kind, dtype)
    jx, tx = _x(cfg, dtype, length)
    name = {"mamba": "mamba2_block"}.get(kind, f"{kind}_block")
    want = strict(functools.partial(getattr(ref_ssm, name), cfg=ref_cfg, return_state=True),
                  ref_p, jx)
    got = getattr(ssm, name)(p, tx, cfg, return_state=True)
    tol = REL_TOL[dtype]
    assert got[0].dtype == tx.dtype
    assert _rel_err(got[0], want[0]) < tol
    if kind == "mamba":
        states, ref_states = got[1:], want[1:]
    else:
        states, ref_states = got[1], want[1]
    assert len(states) == len(ref_states)
    for g, w in zip(states, ref_states):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert _rel_err(g, w) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_matches_reference(kind, dtype):
    """Three decode steps from the state the reference's block leaves after
    24 positions, each from the reference's own previous state."""
    ref_cfg, ref_p, cfg, p = _block(kind, dtype)
    jx, _ = _x(cfg, dtype, 24, seed=5)
    block = {"mamba": ref_ssm.mamba2_block}.get(kind) or getattr(ref_ssm, f"{kind}_block")
    out = strict(functools.partial(block, cfg=ref_cfg, return_state=True), ref_p, jx)
    state = (out[2], out[1]) if kind == "mamba" else out[1]
    steps_j, steps_t = _x(cfg, dtype, 3, seed=6)
    decode = {"mamba": "mamba2_decode"}.get(kind, f"{kind}_decode")
    ref_decode = functools.partial(getattr(ref_ssm, decode), cfg=ref_cfg)
    tol = REL_TOL[dtype]
    for t in range(3):
        port_state = tuple(torch.from_numpy(np.array(s.astype(jnp.float32))).to(
            torch.float32 if s.dtype == jnp.float32 else steps_t.dtype) for s in state)
        if kind == "mamba":
            want = strict(ref_decode, ref_p, steps_j[:, t:t + 1], *state)
            got = ssm.mamba2_decode(p, steps_t[:, t:t + 1], *port_state, cfg)
            got_out, got_state, want_out, state = got[0], got[1:], want[0], want[1:]
        else:
            want = strict(ref_decode, ref_p, steps_j[:, t:t + 1], state)
            got_out, got_state = getattr(ssm, decode)(p, steps_t[:, t:t + 1], port_state, cfg)
            want_out, state = want
        assert got_out.shape == (B, 1, cfg.d_model) and got_out.dtype == steps_t.dtype
        assert _rel_err(got_out, want_out) < tol, t
        for g, w in zip(got_state, state):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            assert _rel_err(g, w) < tol, t


@pytest.mark.parametrize("kind,tol", [("mamba", 2e-3), ("mlstm", 3e-3), ("slstm", 1e-5)])
def test_chunked_equals_recurrent(kind, tol):
    """The port's prefill block equals its own decode, token by token, from
    the empty state (float32; the reference test's tolerances for Mamba2
    and mLSTM; the sLSTM runs the same loop in both)."""
    _, _, cfg, p = _block(kind, "float32")
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 0.1, (1, 32, cfg.d_model))
                         .astype(np.float32))
    s = cfg.ssm
    if kind == "mamba":
        full = ssm.mamba2_block(p, x, cfg)
        di = s.expand * cfg.d_model
        state = (torch.zeros((1, s.d_conv - 1, di + 2 * s.d_state)),
                 torch.zeros((1, di // s.head_dim, s.d_state, s.head_dim)))
        step = lambda xt, st: (lambda o, c, h: (o, (c, h)))(  # noqa: E731
            *ssm.mamba2_decode(p, xt, *st, cfg))
    elif kind == "mlstm":
        full = ssm.mlstm_block(p, x, cfg)
        h, pd = cfg.n_heads, s.expand * cfg.d_model // cfg.n_heads
        state = (torch.zeros((1, h, pd, pd)), torch.zeros((1, h, pd)), torch.full((1, h), -1e30))
        step = lambda xt, st: ssm.mlstm_decode(p, xt, st, cfg)  # noqa: E731
    else:
        full = ssm.slstm_block(p, x, cfg)
        d = cfg.d_model
        state = (torch.zeros((1, d)), torch.zeros((1, d)), torch.full((1, d), -1e30),
                 torch.zeros((1, d)))
        step = lambda xt, st: ssm.slstm_decode(p, xt, st, cfg)  # noqa: E731
    outs = []
    for t in range(x.shape[1]):
        o, state = step(x[:, t:t + 1], state)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=tol, atol=tol)


def test_softplus_is_jaxs():
    """``logaddexp(x, 0)``, also past 20 where torch's softplus returns x."""
    x = np.linspace(-40, 40, 161).astype(np.float32)
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=0)
