"""The tensor-parallel loss, gradients and train step against the reference,
on simulated meshes of CPU shards.

Four configs of the dense and VLM families at ``.reduced()`` size in float32
(qwen3-8b, qwen1.5-0.5b, gemma-7b, internvl2-1b), on the weights of
``torch_train_parity`` (norms and biases noisy), bridged from the same numpy
arrays as the reference's; meshes (1, 2), (1, 4), (1, 8), (2, 2) and (2, 2)
with FSDP (``fsdp_min_elems=1``, so that every leaf with a free divisible dim
is split over "data" and gathered before its block runs).  These reduced
configs have 4 query heads and 2 KV heads (``pad_heads_to=1``), so:
(1, 2) splits both; (1, 4) splits the query heads and replicates the KV heads
(each shard reads its group's KV head); (1, 8) replicates both (the guard),
and nothing is reduced.  The unembedding is split over its rows by the rules
and re-split over the vocabulary for the loss.

* ``train_loss`` under the rules against the reference's unsharded
  ``train_loss`` within 1e-5 relative, ``acc`` and ``tokens`` equal; every
  gradient leaf, gathered, within 1e-4 · max |g_ref| of ``jax.value_and_grad``;
* one ``build_train_step`` against the reference's jitted step: loss within
  1e-5, grad norm within 1e-4 relative (``test_torch_train_step.py``'s
  bounds), the parameters after within 2 · lr;
* the prefill's last logits under the rules against the reference's
  ``prefill`` within 1e-5 relative to their largest magnitude;
* planted faults must fail: one shard's partial dropped from the
  all-reduces, and KV heads taken from the shard's first group;
* ``_sharded_chunk_xent`` on a simulated (2, 2) mesh against the reference's
  own on a (2, 2) mesh of forced CPU devices (a subprocess).

The other families: ``test_torch_tensor_parallel_moe.py`` and
``test_torch_tensor_parallel_ssm.py``; the cached prefill and decode over
the mesh: ``test_torch_tensor_parallel_decode.py``.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.train.step import build_train_step as ref_build_train_step
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_lm_mesh, simulated_devices
from repro_torch.models.lm import LM, collectives, layers
from repro_torch.models.lm import model as model_lib
from repro_torch.models.lm.sharding import (
    ShardingRules,
    _cut,
    gather_params,
    shard_params,
    split_batch,
    use_rules,
)
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import build_train_step
from repro_torch.train.step import loss_and_grads
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_train_parity import batch, grad_errors, models, ref_loss_and_grads, to_numpy, walk

ARCHS = ("qwen3-8b", "qwen1.5-0.5b", "gemma-7b", "internvl2-1b")
MESHES = {"1x2": ((1, 2), False), "1x4": ((1, 4), False), "1x8": ((1, 8), False),
          "2x2": ((2, 2), False), "2x2_fsdp": ((2, 2), True)}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-3
B = 4


def _rules(cfg, name):
    dims, fsdp = MESHES[name]
    mesh = make_lm_mesh(dims, devices=simulated_devices(dims[0] * dims[1], "cpu"))
    return ShardingRules(mesh, cfg, fsdp=fsdp, fsdp_min_elems=1)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


_REF: dict = {}


def _reference(arch):
    """The reference's loss, gradients, one step and prefill logits (once an arch)."""
    if arch not in _REF:
        ref_lm, ref_p, lm, p = models(arch)
        b = batch(lm, seed=7, step=1, b=B)
        loss, metrics, grads = ref_loss_and_grads(ref_lm, ref_p, b)
        step = jax.jit(ref_build_train_step(ref_lm, lr_schedule=lambda s: jnp.float32(LR)))
        new_p, _, out = step(ref_p, ref_adamw_init(ref_p), {k: jnp.asarray(v) for k, v in b.items()},
                             jnp.asarray(0, jnp.int32))
        fe = b.get("frontend")
        logits = ref_lm.prefill(ref_p, jnp.asarray(b["tokens"][:, :-1].clip(0)),
                                None if fe is None else jnp.asarray(fe))[0]
        _REF[arch] = dict(batch=b, loss=float(loss), acc=float(metrics["acc"]),
                          tokens=float(metrics["tokens"]), grads=grads,
                          step=dict(loss=float(out["loss"]), grad_norm=float(out["grad_norm"])),
                          params=dict(walk(jax.tree.map(to_numpy, new_p))),
                          logits=to_numpy(logits))
    return _REF[arch]


def _sharded_loss_and_grads(arch, mesh_name):
    _, _, lm, params = models(arch)
    ref = _reference(arch)
    rules = _rules(lm.cfg, mesh_name)
    with use_rules(rules):
        loss, metrics, grads = loss_and_grads(lm, shard_params(rules, params),
                                              _torch_batch(ref["batch"]))
    return ref, loss, metrics, dict(walk(gather_params(grads)))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_every_gradient_match_reference(arch, mesh_name):
    ref, loss, metrics, grads = _sharded_loss_and_grads(arch, mesh_name)
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert float(metrics["acc"]) == ref["acc"]
    assert float(metrics["tokens"]) == ref["tokens"]
    errs = grad_errors(grads, ref["grads"])
    bad = {p: e for p, e in errs.items() if not e <= GRAD_TOL}
    assert not bad, bad


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_reference(arch, mesh_name):
    _, _, lm, params = models(arch)
    ref = _reference(arch)
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
    # the moments are placed as the parameters are
    for (path, m), (_, p) in zip(_leaves(opt.mu), _leaves(new)):
        assert m.spec == p.spec and len(m.blocks) == len(p.blocks), path
    dims, _ = MESHES[mesh_name]
    if dims[1] > 1:  # the model axis's all-reduces were counted
        assert collectives.STATS.per_op_count.get("all-reduce", 0) > 0


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


@pytest.mark.parametrize("mesh_name", ["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_logits_match_reference(arch, mesh_name):
    _, _, lm, params = models(arch)
    ref = _reference(arch)
    b = ref["batch"]
    rules = _rules(lm.cfg, mesh_name)
    tokens = torch.from_numpy(b["tokens"][:, :-1].clip(0))
    fe = torch.from_numpy(b["frontend"]) if "frontend" in b else None
    with use_rules(rules), torch.no_grad():
        logits = lm.prefill_logits(shard_params(rules, params), tokens, fe)
    want = ref["logits"]
    assert tuple(logits.shape) == want.shape
    live = want > -1e29
    np.testing.assert_array_equal(logits.numpy() > -1e29, live)
    err = np.abs(logits.numpy()[live] - want[live]).max() / np.abs(want[live]).max()
    assert err <= LOSS_RTOL


def _drop_last_partial(real):
    def faulty(xs, mesh, axis, **kw):
        xs = list(xs)
        xs[-1] = torch.zeros_like(xs[-1])
        return real(xs, mesh, axis, **kw)

    return faulty


@pytest.mark.parametrize("fault", ["dropped_partial", "kv_from_first_group"])
def test_planted_faults_fail(monkeypatch, fault):
    arch, mesh_name = "qwen3-8b", "1x4"
    if fault == "dropped_partial":
        monkeypatch.setattr(collectives, "all_reduce_sum",
                            _drop_last_partial(collectives.all_reduce_sum))
    else:
        monkeypatch.setattr(layers, "kv_heads_of",
                            lambda first, n, group: slice(0, max(n // group, 1)))
    ref, loss, _, grads = _sharded_loss_and_grads(arch, mesh_name)
    assert abs(float(loss) - ref["loss"]) > LOSS_RTOL * abs(ref["loss"])
    assert max(grad_errors(grads, ref["grads"]).values()) > GRAD_TOL


# ---------------------------------------------- the loss against the reference's
# own vocab-sharded branch, on a (2, 2) mesh of forced CPU devices
XENT = dict(b=4, s=32, d=16, vp=512, vocab=500, n_chunks=2)

_XENT_WORKER = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models.lm.model import _sharded_chunk_xent
from repro.models.lm.sharding import ShardingRules
kw = json.loads(sys.argv[1])
rng = np.random.default_rng(kw["seed"])
h = rng.normal(size=(kw["b"], kw["s"], kw["d"])).astype(np.float32)
w = rng.normal(size=(kw["d"], kw["vp"])).astype(np.float32)
labels = rng.integers(0, kw["vocab"], size=(kw["b"], kw["s"])).astype(np.int32)
mask = (rng.random((kw["b"], kw["s"])) > 0.1).astype(np.float32)
mesh = jax.make_mesh((2, 2), ("data", "model"))
rules = ShardingRules(mesh, get_config("qwen3-8b").reduced())
fn = jax.jit(_sharded_chunk_xent(rules, kw["vp"], kw["vocab"], kw["n_chunks"]))
loss, correct = fn(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), jnp.asarray(mask))
print(json.dumps({"loss": float(loss), "correct": float(correct), "devices": len(jax.devices())}))
"""


def _xent_inputs(seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(XENT["b"], XENT["s"], XENT["d"])).astype(np.float32)
    w = rng.normal(size=(XENT["d"], XENT["vp"])).astype(np.float32)
    labels = rng.integers(0, XENT["vocab"], size=(XENT["b"], XENT["s"])).astype(np.int32)
    mask = (rng.random((XENT["b"], XENT["s"])) > 0.1).astype(np.float32)
    return h, w, labels, mask


def test_sharded_chunk_xent_matches_reference_on_a_2x2_cpu_mesh():
    from repro.launch.mesh import forced_host_devices_env

    seed = 11
    proc = subprocess.run([sys.executable, "-c", _XENT_WORKER, json.dumps(dict(XENT, seed=seed))],
                          env=forced_host_devices_env(4), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert want["devices"] == 4
    h, w, labels, mask = (torch.from_numpy(a) for a in _xent_inputs(seed))
    cfg = get_config("qwen3-8b").reduced()
    rules = _rules(cfg, "2x2")
    fn = model_lib._sharded_chunk_xent(rules, XENT["vp"], XENT["vocab"], XENT["n_chunks"])
    # the unembedding as the rules place it (rows over "model") and over the vocabulary
    for spec in (("model", None), (None, "model")):
        loss, correct = fn(split_batch(rules, h), _cut(w, spec, rules.mesh, "model"),
                           split_batch(rules, labels.long()), split_batch(rules, mask))
        assert abs(float(loss) - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), spec
        assert float(correct) == want["correct"], spec
