"""The gradient of ``flash_attention`` on the CPU: the plain backward against
JAX's autodiff of the reference's attention, and the autograd wiring.

``ref.flash_attention_bwd_ref`` (the plain version of the backward kernels:
dS = P ∘ (dO·Vᵀ − Δ), dQ = scale·dS·K, dK = scale·dSᵀ·Q, dV = Pᵀ·dO, KV heads
summed over their group) against ``jax.vjp`` of the reference's
``attention_full`` and ``attention_blockwise`` for causal, windowed,
bidirectional, cross (Sq ≠ Sk), GQA and D ≠ Dv attention, in float32:
each gradient within 1e-5 · its max |reference| (float32 summation order).
Also the wrapper (``backward.flash_attention_bwd``, its plain version on a
CPU tensor), ``ops.attention``'s CPU route under autograd (the plain
forward differentiated) and ``autograd.FlashAttention``'s layout and
argument handling, its kernel launches replaced by the plain versions
(the kernels themselves run only on the card: ``tests/test_torch_cuda.py``).
And ``emulation.bf16_backward``, the roundings of the bf16 tensor-core
backward kernels in PyTorch, against the plain backward and ``jax.vjp``
(which the card tests hold the kernels to in turn).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm.layers import attention_blockwise, attention_full
from repro_torch.kernels.flash_attention import autograd as fa_autograd
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
from repro_torch.kernels.flash_attention.emulation import (
    BWD_BLOCK_KEYS,
    BWD_INSTANCES,
    bf16_backward,
    bwd_tiles,
)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
    live_keys,
)
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)

REL_TOL = 1e-5
# name: (b, h, hkv, sq, sk, d, dv, causal, window, blockwise block or 0)
CASES = {
    "causal": (2, 4, 4, 48, 48, 16, 16, True, 0, 0),
    "gqa": (2, 4, 2, 48, 48, 16, 16, True, 0, 0),
    "d_ne_dv": (2, 4, 2, 48, 48, 24, 16, True, 0, 0),
    "window": (1, 4, 1, 40, 40, 16, 16, True, 12, 0),
    "bidirectional": (2, 4, 4, 40, 40, 16, 16, False, 0, 0),
    "cross": (2, 4, 4, 12, 40, 16, 16, False, 0, 0),
    "blockwise_causal": (1, 4, 2, 128, 128, 16, 8, True, 0, 32),
    "blockwise_window": (1, 4, 4, 128, 128, 16, 16, True, 40, 32),
}


def _inputs(case, seed=0):
    b, h, hkv, sq, sk, d, dv, *_ = case
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, dv)).astype(np.float32),
            rng.normal(size=(b, sq, h, dv)).astype(np.float32))


def _t(a):
    """Model layout (B, S, H, D) numpy -> the kernel layout (B, H, S, D)."""
    return torch.from_numpy(a).transpose(1, 2)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", CASES)
def test_plain_backward_matches_jax_vjp_of_reference(name):
    case = CASES[name]
    causal, window, block = case[7:]
    q, k, v, do = _inputs(case)
    if block:
        f = lambda q, k, v: attention_blockwise(q, k, v, causal=causal, window=window,  # noqa
                                                block=block)
    else:
        f = lambda q, k, v: attention_full(q, k, v, causal=causal, window=window)  # noqa: E731
    o, vjp = jax.vjp(f, q, k, v)
    want = vjp(jnp.asarray(do))
    got = flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(np.array(o)), _t(do),
                                  causal=causal, window=window)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert _rel(g.transpose(1, 2).numpy(), w) < REL_TOL, what


@pytest.mark.parametrize("name", ["gqa", "window", "cross"])
def test_wrapper_on_cpu_is_the_plain_backward(name):
    case = CASES[name]
    causal, window = case[7:9]
    q, k, v, do = (_t(a) for a in _inputs(case, seed=1))
    hkv = k.shape[1]
    rep = q.shape[1] // hkv
    o = flash_attention_ref(q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
                            causal=causal, window=window)
    lse = torch.zeros(q.shape[:3])
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    want = flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["gqa", "window", "cross", "d_ne_dv"])
def test_ops_attention_cpu_gradient_is_the_plain_backward(name):
    """``ops.attention`` on the CPU under autograd: the plain forward,
    differentiated, equals the plain backward's formula."""
    case = CASES[name]
    causal, window = case[7:9]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case, seed=2))
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = ops.attention(q, k, v, causal=causal, window=window)
    grads = torch.autograd.grad(o, (q, k, v), do)
    want = flash_attention_bwd_ref(*(t.detach().transpose(1, 2) for t in (q, k, v, o)),
                                   do.transpose(1, 2), causal=causal, window=window)
    for g, w in zip(grads, want):
        assert _rel(g.numpy(), w.transpose(1, 2).numpy()) < REL_TOL


def _plain_forward(q, k, v, *, causal, window, return_lse):
    """The forward kernel's contract on the CPU: out in q's memory order and
    the row log-sum-exp."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.repeat_interleave(rep, 1)
    out = torch.empty((q.shape[0], q.shape[2], q.shape[1], v.shape[3]),
                      dtype=q.dtype).transpose(1, 2)
    out.copy_(flash_attention_ref(q, kf.to(q.dtype), vf, causal=causal, window=window))
    s = (q.float() * q.shape[-1] ** -0.5) @ kf.transpose(-1, -2)
    keep = live_keys(q.shape[2], k.shape[2], causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, -torch.inf)
    assert return_lse
    return out, torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["gqa", "window", "cross", "d_ne_dv"])
def test_autograd_function_wiring(name, dtype, monkeypatch):
    """``FlashAttention`` in the model layout: the forward's output, the
    saved tensors and the upstream gradient (a float32 loss over a bf16
    output included) reach the backward in the kernel layout, in q's type,
    in the right order; the gradients come back in the model layout."""
    seen = {}

    def bwd(q, k, v, out, lse, dout, *, causal, window):
        seen.update(q=q.shape, out=out.shape, lse=lse.shape, dout=(dout.shape, dout.dtype))
        return flash_attention_bwd(q, k, v, out, lse, dout, causal=causal, window=window)

    monkeypatch.setattr(fa_autograd, "flash_attention", _plain_forward)
    monkeypatch.setattr(fa_autograd, "flash_attention_bwd", bwd)
    case = CASES[name]
    causal, window = case[7:9]
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(case, seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = fa_autograd.FlashAttention.apply(*leaves, causal, window)
    assert o.shape == (*q.shape[:3], v.shape[3]) and o.dtype == dtype
    (o.float() * do.float()).sum().backward()
    b, sq, h, _ = q.shape
    assert seen["q"] == (b, h, sq, q.shape[3]) and seen["lse"] == (b, h, sq)
    assert seen["dout"] == ((b, h, sq, v.shape[3]), dtype)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ops.attention(*ref_leaves, causal=causal, window=window)
    (want.float() * do.float()).sum().backward()
    # bf16: the two forwards round p·v and the output alike but sum in another order
    tol = REL_TOL if dtype == torch.float32 else 2e-2
    for got, ref in zip(leaves, ref_leaves):
        assert got.grad.shape == got.shape and got.grad.dtype == dtype
        assert _rel(got.grad.float().numpy(), ref.grad.float().numpy()) < tol


# the bf16 kernels' tolerance against the plain backward on the card
# (tests/test_torch_cuda.py, chip_smoke.py): max |Δ| over max |plain|
BWD_TOL_BF16 = 1e-2
# name: (b, h, hkv, sq, sk, d, dv, causal, window), each across the kernels'
# tiles (64-key blocks, 32- or 64-row query tiles, 32- or 64-key dQ tiles)
EMU_CASES = {
    "causal": (2, 4, 4, 80, 80, 64, 64, True, 0),
    "gqa": (1, 4, 2, 100, 100, 32, 32, True, 0),
    "d_ne_dv": (1, 2, 2, 70, 70, 192, 128, True, 0),      # MLA's: dK and dV in two roles
    "window": (1, 2, 1, 150, 150, 80, 80, True, 40),      # zamba2's head dim, GQA
    "cross": (2, 2, 2, 20, 90, 64, 64, False, 0),
    "head_dim_256": (1, 2, 2, 70, 70, 256, 256, True, 0),
    "head_dim_128": (1, 2, 2, 90, 90, 128, 128, False, 0),  # 32-row tiles, shared
}


def _emulation_inputs(case, seed):
    """bf16-representable inputs (as float32 tensors, kernel layout), the
    plain forward's output rounded to bf16 and the exact row log-sum-exp."""
    b, h, hkv, sq, sk, d, dv, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(torch.bfloat16).float().transpose(1, 2)
                   for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, dv), (b, sq, h, dv)))
    rep = h // hkv
    kr = k.repeat_interleave(rep, 1)
    o = flash_attention_ref(q, kr, v.repeat_interleave(rep, 1), causal=causal,
                            window=window).to(torch.bfloat16).float()
    s = (q * d ** -0.5) @ kr.transpose(-1, -2)
    keep = live_keys(sq, sk, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, -torch.inf)
    return q, k, v, o, do, torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("name", EMU_CASES)
def test_bf16_emulation_matches_plain_and_jax_vjp(name):
    """The bf16 kernels' roundings (P and dS to bf16 before the products,
    the exp2 domain, the kernels' tile order) move each gradient, before
    its final rounding, within half of the card tolerance of the plain
    backward and of ``jax.vjp`` of the reference's ``attention_full``
    (measured: 0.001-0.003); rounded to bf16 as the kernels store them,
    within the card tolerance of the plain backward in bf16 (the final
    rounding adds up to one bf16 ulp, 2^-7 of the largest gradient)."""
    case = EMU_CASES[name]
    causal, window = case[7:]
    q, k, v, o, do, lse = _emulation_inputs(case, seed=5)
    # float32 in: the emulation rounds P and dS but not its outputs
    got = bf16_backward(q, k, v, o, do, lse, causal=causal, window=window)
    plain = flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    f = lambda q, k, v: attention_full(q, k, v, causal=causal, window=window)  # noqa: E731
    _, vjp = jax.vjp(f, *(jnp.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.transpose(1, 2).numpy()))
    for g, pl, w, what in zip(got, plain, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == pl.shape, what
        assert _rel(g.numpy(), pl.numpy()) < 0.5 * BWD_TOL_BF16, what
        assert _rel(g.transpose(1, 2).numpy(), w) < 0.5 * BWD_TOL_BF16, what
    # bf16 in and out, as the kernels run
    b16 = [t.to(torch.bfloat16) for t in (q, k, v, o, do)]
    got16 = bf16_backward(*b16, lse, causal=causal, window=window)
    plain16 = flash_attention_bwd_ref(*b16, causal=causal, window=window)
    for g, pl, what in zip(got16, plain16, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16, what
        assert _rel(g.float().numpy(), pl.float().numpy()) < BWD_TOL_BF16, what


def test_bf16_emulation_rounds_p_and_ds():
    """The emulation's roundings are there: against a copy of the plain
    backward that rounds nothing but its outputs it differs, and with P and
    dS exact in bf16 (keys of one row's equal scores, dO zero past a
    column) it agrees with the plain backward to float32 summation order."""
    case = EMU_CASES["causal"]
    q, k, v, o, do, lse = _emulation_inputs(case, seed=6)
    got = bf16_backward(q, k, v, o, do, lse, causal=True)
    plain = flash_attention_bwd_ref(q, k, v, o, do, causal=True)
    assert all(not torch.equal(g, pl) for g, pl in zip(got, plain))
    # one query row, one key: P = 1 exactly, dS = dP − Δ = 0 up to rounding
    q1, k1, v1, do1 = (t[:, :1, :1] for t in (q, k, v, do))
    o1 = v1.clone()
    lse1 = (q1 * 64 ** -0.5 * k1).sum(-1)
    got1 = bf16_backward(q1, k1, v1, o1, do1, lse1, causal=True)
    plain1 = flash_attention_bwd_ref(q1, k1, v1, o1, do1, causal=True)
    torch.testing.assert_close(got1[2], plain1[2], rtol=0, atol=0)
    assert float(got1[0].abs().max()) < 1e-5 and float(got1[1].abs().max()) < 1e-5


@pytest.mark.parametrize("d,dv,dn,dvn,block_k,block_q,roles", [
    (64, 64, 64, 64, 64, 64, False),        # qwen1.5-0.5b, seamless
    (80, 80, 80, 80, 64, 64, False),        # zamba2: N = 80 exactly
    (128, 128, 128, 128, 64, 32, False),    # qwen3-8b
    (192, 128, 192, 128, 64, 64, True),     # MLA
    (256, 256, 256, 256, 32, 32, True),     # gemma
    (40, 24, 64, 64, 64, 64, False),        # padded up
    (96, 96, 128, 128, 64, 32, False),
    (130, 64, 192, 128, 64, 64, True),
])
def test_bwd_tiles_table(d, dv, dn, dvn, block_k, block_q, roles):
    """The kernels' instance table as the emulation mirrors it: the training
    path's head dims take accumulators of their exact width."""
    assert bwd_tiles(d, dv) == dict(dn=dn, dvn=dvn, block_k=block_k, block_q=block_q,
                                    roles=roles)


def test_bwd_tiles_are_the_kernels():
    """The emulation's table is the kernel source's: the instances its
    dispatch launches, in order, and the tile rules of its ``Cfg``."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
           / "flash_attention_bwd.cu").read_text()
    dispatch = src[src.index("cudaError_t dispatch(const Problem& a"):]
    found = [tuple(map(int, m)) for m in re.findall(r"launch_dq<(\d+), (\d+)>", dispatch)]
    assert tuple(found) == BWD_INSTANCES
    for rule in ("kBc = DN / 2 <= 96 ? 64 : 32", "kRoles = DN + DVN > 256",
                 "kAcc = kRoles ? (DN > DVN ? DN : DVN) / 2 : (DN + DVN) / 2",
                 "kBr = kAcc <= 96 ? 64 : 32", f"kBlockKeys = {BWD_BLOCK_KEYS};"):
        assert rule in src, rule
