"""The SSM, hybrid and audio families tensor-parallel (xlstm-1.3b's mLSTM and
sLSTM; zamba2-2.7b's Mamba2 and its windowed shared block;
seamless-m4t-large-v2's encoder, decoder and cross attention) against the
reference's unsharded program, on simulated meshes of CPU shards.

The three configs at ``.reduced()`` size in float32, on the weights of
``torch_train_parity``, bridged from the same numpy arrays as the
reference's; GSPMD computes the unsharded function on any mesh, which is
what the port is held to.  Meshes (1, 2), (1, 4), (1, 8), (2, 2) and (2, 2)
with FSDP (``fsdp_min_elems=1``), B = 4.  At this size they cover:

* xlstm (H = 4, P = 64; sLSTM ``up`` of 170 units): the mLSTM on whole heads
  at tp 2 and 4 and a head's P split over two shards at tp 8 (q, k and v
  all-gathered); ``up`` and ``down`` split at tp 2 and replicated by the
  guard at tp 4 and 8; the sLSTM scan on every shard;
* zamba2 (16 Mamba2 heads, ``in_proj`` of 560 columns): ``in_proj`` split
  at every tp and all-gathered, the RMS norm over the whole inner width;
  one case at S = 96, where the shared block's window of 64 binds;
* seamless (4 heads on 2 KV heads): KV heads split at tp 2 and replicated
  at tp 4 and 8, in self and cross attention.

Checked:

* ``train_loss`` within 1e-5 relative, ``acc`` and ``tokens`` equal; every
  gradient leaf, gathered, within 1e-4 · max |g_ref| of ``jax.value_and_grad``,
  the replicated leaves (``conv_w``, ``a_log``, ``dt_bias``, ``d_skip``,
  ``w_i``, ``w_f``, ``r``, ``b``, ``out_norm``) included;
* one ``build_train_step`` against the reference's jitted step (loss 1e-5,
  grad norm 1e-4 relative, the parameters after within 2 · lr);
* the prefill's last logits within 1e-5 relative to their largest magnitude;
* a (1, 1) mesh gives the unsharded port's loss and logits within 1e-6;
* with the serving tests' wide ``dt_bias`` / ``a_log`` noise, Mamba2's
  gradient is NaN where a chunk's decay overflows (the reference's own,
  ROADMAP Queue 3): the sharded port's NaNs lie at the unsharded port's;
  at init, at the full config's chunk of 256 positions (the reduced
  widths), both packages' gradients are NaN at the same elements, as
  full-width zamba2's is on the card (``chip_smoke.py`` phase 20);
* planted faults fail (``torch_tp_probes``, shared with ``chip_smoke.py``
  phase 20): Mamba2's norm over the shard's slice alone, the mLSTM at tp 8
  without the gather (a head's P split inside the cell), and a replicated
  leaf's gradient summed over "model";
* in float64 (``torch_tp_probes.float64_port``, as ``chip_smoke.py`` phase
  20 holds xlstm's 8-layer group): xlstm's sharded gradients within 1e-4
  of the unsharded port's and far closer than its float32 run's, the
  planted mLSTM faults beyond.

The cached ``prefill`` and ``decode_step`` over the mesh:
``test_torch_tensor_parallel_decode.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import LM as RefLM
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.train.step import build_train_step as ref_build_train_step
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_lm_mesh, simulated_devices
from repro_torch.models.lm import LM, collectives
from repro_torch.models.lm.sharding import ShardingRules, gather_params, shard_params, use_rules
from repro_torch.optim.adamw import adamw_init, tree_map
from repro_torch.train import build_train_step
from repro_torch.train.step import loss_and_grads
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_tp_probes import float64_port, planted
from torch_train_parity import (
    batch,
    cfgs,
    grad_errors,
    models,
    noisy_numpy,
    port_loss_and_grads,
    ref_loss_and_grads,
    to_numpy,
    to_ref,
    walk,
)

ARCHS = ("xlstm-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2")
MESHES = {"1x2": ((1, 2), False), "1x4": ((1, 4), False), "1x8": ((1, 8), False),
          "2x2": ((2, 2), False), "2x2_fsdp": ((2, 2), True)}
CASES = [(a, m) for a in ARCHS for m in MESHES] + [("zamba2-2.7b", "1x4_window")]
REPLICATED = {"xlstm-1.3b": ("w_i", "w_f", "r", "b", "out_norm"),
              "zamba2-2.7b": ("conv_w", "a_log", "dt_bias", "d_skip", "out_norm"),
              "seamless-m4t-large-v2": ("enc_norm", "ln_x")}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
UNSHARDED_RTOL = 1e-6
LR = 1e-3
B = 4
S_WINDOW, BLOCK_WINDOW = 96, 32  # zamba2's reduced window of 64 binds at 96 positions


def _mesh(name):
    return MESHES[name.removesuffix("_window")]


def _rules(cfg, name):
    dims, fsdp = _mesh(name)
    mesh = make_lm_mesh(dims, devices=simulated_devices(dims[0] * dims[1], "cpu"))
    return ShardingRules(mesh, cfg, fsdp=fsdp, fsdp_min_elems=1)


def _kw(name):
    return dict(attn_block=BLOCK_WINDOW) if name.endswith("_window") else {}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _prompt(b):
    tb = _torch_batch(b)
    return tb["tokens"][:, :-1].clamp(min=0), tb.get("frontend")


_REF: dict = {}


def _reference(arch, window=False):
    """The reference's loss, gradients, one step and prefill logits (once a case)."""
    key = (arch, window)
    if key not in _REF:
        ref_lm, ref_p, lm, _ = models(arch, **(dict(attn_block=BLOCK_WINDOW) if window else {}))
        bt = batch(lm, seed=7, step=1, b=B, **(dict(s=S_WINDOW) if window else {}))
        loss, metrics, grads = ref_loss_and_grads(ref_lm, ref_p, bt)
        step = jax.jit(ref_build_train_step(ref_lm, lr_schedule=lambda s: jnp.float32(LR)))
        new_p, _, out = step(ref_p, ref_adamw_init(ref_p),
                             {k: jnp.asarray(v) for k, v in bt.items()},
                             jnp.asarray(0, jnp.int32))
        fe = bt.get("frontend")
        logits = ref_lm.prefill(ref_p, jnp.asarray(bt["tokens"][:, :-1].clip(0)),
                                None if fe is None else jnp.asarray(fe))[0]
        _REF[key] = dict(batch=bt, loss=float(loss), acc=float(metrics["acc"]),
                         tokens=float(metrics["tokens"]), grads=grads,
                         step=dict(loss=float(out["loss"]), grad_norm=float(out["grad_norm"])),
                         params=dict(walk(jax.tree.map(to_numpy, new_p))),
                         logits=to_numpy(logits))
    return _REF[key]


def _sharded_loss_and_grads(arch, mesh_name):
    _, _, lm, params = models(arch, **_kw(mesh_name))
    ref = _reference(arch, mesh_name.endswith("_window"))
    rules = _rules(lm.cfg, mesh_name)
    with use_rules(rules):
        loss, metrics, grads = loss_and_grads(lm, shard_params(rules, params),
                                              _torch_batch(ref["batch"]))
    return ref, loss, metrics, dict(walk(gather_params(grads)))


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_sharded_loss_and_every_gradient_match_reference(arch, mesh_name):
    ref, loss, metrics, grads = _sharded_loss_and_grads(arch, mesh_name)
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert float(metrics["acc"]) == ref["acc"]
    assert float(metrics["tokens"]) == ref["tokens"]
    errs = grad_errors(grads, ref["grads"])
    bad = {p: e for p, e in errs.items() if not e <= GRAD_TOL}
    assert not bad, bad
    names = {p[-1] for p in errs}
    assert set(REPLICATED[arch]) <= names, names


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_sharded_train_step_matches_reference(arch, mesh_name):
    _, _, lm, params = models(arch, **_kw(mesh_name))
    ref = _reference(arch, mesh_name.endswith("_window"))
    rules = _rules(lm.cfg, mesh_name)
    placed = shard_params(rules, params)
    step = build_train_step(lm, lr_schedule=lambda s: torch.tensor(LR))
    collectives.reset_stats()
    with use_rules(rules):
        new, opt, out = step(placed, adamw_init(placed), _torch_batch(ref["batch"]), 0)
    assert abs(float(out["loss"]) - ref["step"]["loss"]) <= LOSS_RTOL * ref["step"]["loss"]
    assert abs(float(out["grad_norm"]) - ref["step"]["grad_norm"]) <= (
        GRAD_TOL * ref["step"]["grad_norm"])
    assert int(opt.step) == 1
    for path, t in walk(gather_params(new)):
        assert np.abs(to_numpy(t) - ref["params"][path]).max() <= 2 * LR, path
    counts = collectives.STATS.per_op_count
    assert counts.get("all-reduce", 0) > 0
    if arch != "seamless-m4t-large-v2":  # in_proj's products, mLSTM heads at tp 8, sLSTM's input
        assert counts.get("all-gather", 0) > 0


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_sharded_prefill_logits_match_reference(arch, mesh_name):
    _, _, lm, params = models(arch, **_kw(mesh_name))
    ref = _reference(arch, mesh_name.endswith("_window"))
    rules = _rules(lm.cfg, mesh_name)
    with use_rules(rules), torch.no_grad():
        logits = lm.prefill_logits(shard_params(rules, params), *_prompt(ref["batch"]))
    want = ref["logits"]
    assert tuple(logits.shape) == want.shape
    live = want > -1e29
    np.testing.assert_array_equal(logits.numpy() > -1e29, live)
    err = np.abs(logits.numpy()[live] - want[live]).max() / np.abs(want[live]).max()
    assert err <= LOSS_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_one_shard_mesh_is_the_unsharded_port(arch):
    _, _, lm, params = models(arch)
    b = _reference(arch)["batch"]
    mesh = make_lm_mesh((1, 1), devices=simulated_devices(1, "cpu"))
    rules = ShardingRules(mesh, lm.cfg)
    placed = shard_params(rules, params)
    with torch.no_grad():
        want_loss, _ = lm.train_loss(params, _torch_batch(b))
        want = lm.prefill_logits(params, *_prompt(b))
        with use_rules(rules):
            loss, _ = lm.train_loss(placed, _torch_batch(b))
            logits = lm.prefill_logits(placed, *_prompt(b))
    assert abs(float(loss) - float(want_loss)) <= UNSHARDED_RTOL * abs(float(want_loss))
    live = want > -1e29
    assert torch.equal(logits > -1e29, live)
    assert float((logits[live] - want[live]).abs().max() / want[live].abs().max()) <= UNSHARDED_RTOL


def test_sharded_mamba2_nans_lie_at_the_unsharded_ports():
    _, _, lm, params = models("zamba2-2.7b", wide=True)
    b = _torch_batch(batch(lm, seed=4, step=2))
    want_loss, _, want = loss_and_grads(lm, params, b)
    want = dict(walk(want))
    rules = _rules(lm.cfg, "1x4")
    with use_rules(rules):
        loss, _, got = loss_and_grads(lm, shard_params(rules, params), b)
    got = dict(walk(gather_params(got)))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    n_nan = 0
    for path, w in want.items():
        g = got[path]
        np.testing.assert_array_equal(torch.isnan(g).numpy(), torch.isnan(w).numpy(),
                                      err_msg=str(path))
        n_nan += int(torch.isnan(w).sum())
        fin = ~torch.isnan(w)
        if fin.any():
            scale = max(float(w[fin].abs().max()), 1e-30)
            assert float((g[fin] - w[fin]).abs().max()) / scale <= GRAD_TOL, path
    assert n_nan > 0


def test_full_chunk_mamba2_gradient_at_init_is_nan_in_both_packages():
    """zamba2 at the full config's chunk (256) and its init (``dt_bias`` =
    ``a_log`` = 0): a chunk's Σ dt·|a| passes 88 and its masked decay
    overflows, so both packages' gradients are NaN at the same elements."""
    chunk = get_config("zamba2-2.7b").ssm.chunk
    ref_cfg, cfg = (dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, chunk=chunk))
                    for c in cfgs("zamba2-2.7b"))
    kw = dict(remat=False, attn_block=64, loss_chunk=64)
    ref_lm, lm = RefLM(ref_cfg, **kw), LM(cfg, **kw)
    params = noisy_numpy(lm.init(torch.Generator().manual_seed(0)), np.random.default_rng(1), {})
    ref_params = to_ref(params, jax.eval_shape(ref_lm.init, jax.random.PRNGKey(0)))
    b = batch(lm, seed=4, step=2, b=1, s=chunk)
    want_loss, _, want = ref_loss_and_grads(ref_lm, ref_params, b)
    loss, _, got = port_loss_and_grads(lm, lm_params_from_numpy(params, lm.dtype), b)
    assert np.isfinite(float(want_loss))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    n_nan = 0
    for path, w in want.items():
        np.testing.assert_array_equal(np.isnan(to_numpy(got[path])), np.isnan(w),
                                      err_msg=str(path))
        n_nan += int(np.isnan(w).sum())
    assert n_nan > 0


# ------------------------------------------------------------ planted faults
FAULTS = {
    "mamba2_norm_over_own_slice": ("zamba2-2.7b", "1x4", "norm_over_own_slice"),
    "mlstm_p_split_without_gather": ("xlstm-1.3b", "1x8", "p_split_without_gather"),
    "replicated_grad_summed_over_model": ("zamba2-2.7b", "1x4", "replicated_grad_summed"),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail(fault):
    arch, mesh_name, which = FAULTS[fault]
    with planted(which):
        ref, loss, _, grads = _sharded_loss_and_grads(arch, mesh_name)
    errs = grad_errors(grads, ref["grads"])
    if fault == "replicated_grad_summed_over_model":  # the forward is untouched
        assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
        assert all(errs[p] > GRAD_TOL for p in errs if p[-1] in ("conv_w", "a_log", "d_skip"))
    else:
        assert abs(float(loss) - ref["loss"]) > LOSS_RTOL * abs(ref["loss"])
    assert max(errs.values()) > GRAD_TOL


@pytest.mark.parametrize("mesh_name,fault", [("1x4", "norm_over_own_slice"),
                                             ("1x8", "p_split_without_gather")])
def test_float64_shards_match_the_float64_unsharded_port(mesh_name, fault):
    arch = "xlstm-1.3b"
    _, _, lm, params = models(arch)
    b = _torch_batch(_reference(arch)["batch"])
    _, _, g32 = loss_and_grads(lm, params, b)
    params = tree_map(lambda t: t.double(), params)
    rules = _rules(lm.cfg, mesh_name)
    with float64_port(lm):
        _, _, want = loss_and_grads(lm, params, b)
        with use_rules(rules):
            _, _, got = loss_and_grads(lm, shard_params(rules, params), b)
            with planted(fault):
                _, _, bad = loss_and_grads(lm, shard_params(rules, params), b)
    assert lm.dtype == torch.float32
    want, got, bad = dict(walk(want)), dict(walk(gather_params(got))), dict(walk(gather_params(bad)))
    assert all(g.dtype == torch.float64 for g in (*want.values(), *got.values()))

    def far(grads):
        return max(float((grads[p].double() - w).abs().max() / w.abs().max())
                   for p, w in want.items())

    # float64 resolves far below float32's rounding: the shards' layout is held
    # there, and the planted faults lie far beyond the bound
    assert far(got) <= GRAD_TOL and far(got) < far(dict(walk(g32))) / 100
    assert far(bad) > GRAD_TOL
