"""The MoE family tensor-parallel (granite-moe-1b-a400m; deepseek-v2-236b
with MLA, a leading dense layer and shared experts) against the reference's
unsharded program, on simulated meshes of CPU shards.

Both configs at ``.reduced()`` size in float32 (8 experts, top-2, groups of
64 tokens, ``d_ff_expert`` 64; deepseek's 4 MLA heads, ``dense0`` and a
shared FFN of width 128), on the weights of ``torch_train_parity``, bridged
from the same numpy arrays as the reference's.  Under the reference's rules
every shard holds every expert and a slice of each expert's hidden width
(the dense-FFN patterns match the expert leaves first), so the MoE runs as a
Megatron FFN inside each expert and one all-reduce over "model" sums its
partials; GSPMD computes the unsharded function on any mesh, which is what
the port is held to.  Meshes (1, 2), (1, 4), (1, 8) (MLA's 4 heads
replicated by the divisibility guard), (2, 2), (2, 2) with FSDP
(``fsdp_min_elems=1``), and (2, 2) at B = 2, where the one einsum group of
64 tokens straddles the two data shards; B = 4 elsewhere.  The einsum
backend runs on every mesh, the sorted one on (1, 4) and (2, 2), where its
capacity is the whole batch's and each data shard's queues start after the
earlier shard's choices.

* ``train_loss`` within 1e-5 relative, ``acc`` and ``tokens`` equal; every
  gradient leaf, gathered, within 1e-4 · max |g_ref| of ``jax.value_and_grad``;
* one ``build_train_step`` against the reference's jitted step (loss 1e-5,
  grad norm 1e-4 relative, the parameters after within 2 · lr);
* the prefill's last logits within 1e-5 relative to their largest magnitude;
* in every case some (token, k) is dropped by capacity, so that capacity
  is tested;
* planted faults fail: one shard's partial dropped from the MoE all-reduce,
  queue offsets ignored (each data shard queues as if it were first), local
  capacity (each data shard queues against its own capacity and groups), MLA
  heads of the wrong shard, and ``dense0`` skipped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.train.step import build_train_step as ref_build_train_step
from repro_torch.launch.mesh import make_lm_mesh, simulated_devices
from repro_torch.models.lm import collectives, layers
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm.sharding import ShardingRules, gather_params, shard_params, use_rules
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import build_train_step
from repro_torch.train.step import loss_and_grads
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_train_parity import batch, grad_errors, models, ref_loss_and_grads, to_numpy, walk

ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-236b")
# name -> (dims, fsdp, global batch)
MESHES = {"1x2": ((1, 2), False, 4), "1x4": ((1, 4), False, 4), "1x8": ((1, 8), False, 4),
          "2x2": ((2, 2), False, 4), "2x2_fsdp": ((2, 2), True, 4),
          "2x2_straddle": ((2, 2), False, 2)}
SORTED_MESHES = ("1x4", "2x2")
CASES = ([(a, "einsum", m) for a in ARCHS for m in MESHES]
         + [(a, "sorted", m) for a in ARCHS for m in SORTED_MESHES])
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-3


def _rules(cfg, name):
    dims, fsdp, _ = MESHES[name]
    mesh = make_lm_mesh(dims, devices=simulated_devices(dims[0] * dims[1], "cpu"))
    return ShardingRules(mesh, cfg, fsdp=fsdp, fsdp_min_elems=1)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


_REF: dict = {}


def _reference(arch, backend, b):
    """The reference's loss, gradients, one step and prefill logits (once a case)."""
    key = (arch, backend, b)
    if key not in _REF:
        ref_lm, ref_p, lm, _ = models(arch, moe_backend=backend)
        bt = batch(lm, seed=7, step=1, b=b)
        loss, metrics, grads = ref_loss_and_grads(ref_lm, ref_p, bt)
        step = jax.jit(ref_build_train_step(ref_lm, lr_schedule=lambda s: jnp.float32(LR)))
        new_p, _, out = step(ref_p, ref_adamw_init(ref_p),
                             {k: jnp.asarray(v) for k, v in bt.items()},
                             jnp.asarray(0, jnp.int32))
        logits = ref_lm.prefill(ref_p, jnp.asarray(bt["tokens"][:, :-1].clip(0)))[0]
        _REF[key] = dict(batch=bt, loss=float(loss), acc=float(metrics["acc"]),
                         tokens=float(metrics["tokens"]), grads=grads,
                         step=dict(loss=float(out["loss"]), grad_norm=float(out["grad_norm"])),
                         params=dict(walk(jax.tree.map(to_numpy, new_p))),
                         logits=to_numpy(logits))
    return _REF[key]


class _Drops:
    """Counts the (token, k) choices that the sharded dispatch queued and the
    ones it kept, through ``einsum_queues`` and ``sorted_queues``."""

    def __init__(self, monkeypatch):
        self.chosen = self.kept = 0
        real_e, real_s = moe_lib.einsum_queues, moe_lib.sorted_queues

        def einsum_queues(idx, n_experts, cap, offset=None):
            pos, within = real_e(idx, n_experts, cap, offset)
            self.chosen += int((idx >= 0).sum())
            self.kept += int(within.sum())
            return pos, within

        def sorted_queues(idx, n_experts, cap, offset=None):
            order, slot, keep = real_s(idx, n_experts, cap, offset)
            self.chosen += keep.numel()
            self.kept += int(keep.sum())
            return order, slot, keep

        monkeypatch.setattr(moe_lib, "einsum_queues", einsum_queues)
        monkeypatch.setattr(moe_lib, "sorted_queues", sorted_queues)


def _sharded_loss_and_grads(arch, backend, mesh_name, params_fn=None):
    _, _, lm, params = models(arch, moe_backend=backend)
    ref = _reference(arch, backend, MESHES[mesh_name][2])
    rules = _rules(lm.cfg, mesh_name)
    placed = shard_params(rules, params)
    if params_fn is not None:
        placed = params_fn(placed)
    with use_rules(rules):
        loss, metrics, grads = loss_and_grads(lm, placed, _torch_batch(ref["batch"]))
    return ref, loss, metrics, dict(walk(gather_params(grads)))


@pytest.mark.parametrize("arch,backend,mesh_name", CASES)
def test_sharded_loss_and_every_gradient_match_reference(monkeypatch, arch, backend, mesh_name):
    drops = _Drops(monkeypatch)
    ref, loss, metrics, grads = _sharded_loss_and_grads(arch, backend, mesh_name)
    assert abs(float(loss) - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert float(metrics["acc"]) == ref["acc"]
    assert float(metrics["tokens"]) == ref["tokens"]
    errs = grad_errors(grads, ref["grads"])
    bad = {p: e for p, e in errs.items() if not e <= GRAD_TOL}
    assert not bad, bad
    if arch == "deepseek-v2-236b":  # the leading dense layer is there and trained
        assert any(p[0] == "dense0" for p in grads)
    assert 0 < drops.kept < drops.chosen, (drops.kept, drops.chosen)


@pytest.mark.parametrize("arch,backend,mesh_name", CASES)
def test_sharded_train_step_matches_reference(arch, backend, mesh_name):
    _, _, lm, params = models(arch, moe_backend=backend)
    ref = _reference(arch, backend, MESHES[mesh_name][2])
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
    dims, _, _ = MESHES[mesh_name]
    if dims[1] > 1:  # the model axis's all-reduces were counted
        assert collectives.STATS.per_op_count.get("all-reduce", 0) > 0
    straddles = mesh_name == "2x2_straddle" or (backend == "sorted" and dims[0] > 1)
    if straddles:  # the per-expert counts went over the data axis
        assert collectives.STATS.per_op_count.get("all-gather", 0) > 0


@pytest.mark.parametrize("arch,backend,mesh_name", CASES)
def test_sharded_prefill_logits_match_reference(monkeypatch, arch, backend, mesh_name):
    drops = _Drops(monkeypatch)
    _, _, lm, params = models(arch, moe_backend=backend)
    ref = _reference(arch, backend, MESHES[mesh_name][2])
    rules = _rules(lm.cfg, mesh_name)
    tokens = torch.from_numpy(ref["batch"]["tokens"][:, :-1].clip(0))
    with use_rules(rules), torch.no_grad():
        logits = lm.prefill_logits(shard_params(rules, params), tokens)
    want = ref["logits"]
    assert tuple(logits.shape) == want.shape
    live = want > -1e29
    np.testing.assert_array_equal(logits.numpy() > -1e29, live)
    err = np.abs(logits.numpy()[live] - want[live]).max() / np.abs(want[live]).max()
    assert err <= LOSS_RTOL
    assert 0 < drops.kept < drops.chosen, (drops.kept, drops.chosen)


def _moe_partial_dropped(monkeypatch):
    """The last shard's partial dropped from the MoE layers' all-reduce only."""
    real_sum, real_moe = collectives.all_reduce_sum, moe_lib.moe_ffn_shards

    def faulty_sum(xs, mesh, axis, **kw):
        xs = list(xs)
        xs[-1] = torch.zeros_like(xs[-1])
        return real_sum(xs, mesh, axis, **kw)

    def moe_ffn_shards(*args, **kw):
        monkeypatch.setattr(collectives, "all_reduce_sum", faulty_sum)
        try:
            return real_moe(*args, **kw)
        finally:
            monkeypatch.setattr(collectives, "all_reduce_sum", real_sum)

    monkeypatch.setattr(moe_lib, "moe_ffn_shards", moe_ffn_shards)


def _offsets_ignored(monkeypatch):
    """Every data shard queues its tokens as if no earlier shard had any."""
    monkeypatch.setattr(moe_lib, "_earlier_counts",
                        lambda rules, counts: [torch.zeros_like(c) for c in counts])


def _local_capacity(monkeypatch):
    """Every data shard queues its tokens against its own capacity (and its
    own einsum groups), as if it held the whole batch."""
    for name in ("_einsum_shards", "_sorted_shards"):
        real = getattr(moe_lib, name)
        monkeypatch.setattr(moe_lib, name,
                            lambda rules, leaves, hs, cfg, batch_split, real=real:
                            real(rules, leaves, hs, cfg, False))


def _mla_heads_of_first_shard(monkeypatch, tp):
    """Every shard of a layer up-projects with the first shard's heads."""
    real, calls = layers.mla_block, []

    def mla_block(p, x, cfg, **kw):
        if len(calls) % tp == 0:
            first = {n: p[n] for n in ("wq_b", "wkv_b")}
        else:
            first = calls[-1]
        calls.append(first)
        return real(dict(p, **first), x, cfg, **kw)

    monkeypatch.setattr(layers, "mla_block", mla_block)


FAULTS = {
    "moe_partial_dropped": ("granite-moe-1b-a400m", "einsum", "1x4"),
    "offsets_ignored_sorted": ("granite-moe-1b-a400m", "sorted", "2x2"),
    "offsets_ignored_straddle": ("deepseek-v2-236b", "einsum", "2x2_straddle"),
    "local_capacity_sorted": ("granite-moe-1b-a400m", "sorted", "2x2"),
    "local_capacity_straddle": ("deepseek-v2-236b", "einsum", "2x2_straddle"),
    "mla_heads_of_first_shard": ("deepseek-v2-236b", "einsum", "1x2"),
    "dense0_skipped": ("deepseek-v2-236b", "einsum", "1x2"),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail(monkeypatch, fault):
    arch, backend, mesh_name = FAULTS[fault]
    params_fn = None
    if fault == "moe_partial_dropped":
        _moe_partial_dropped(monkeypatch)
    elif fault.startswith("offsets_ignored"):
        _offsets_ignored(monkeypatch)
    elif fault.startswith("local_capacity"):
        _local_capacity(monkeypatch)
    elif fault == "mla_heads_of_first_shard":
        _mla_heads_of_first_shard(monkeypatch, MESHES[mesh_name][0][1])
    else:
        def params_fn(placed):
            return {k: v for k, v in placed.items() if k != "dense0"}
    ref, loss, _, grads = _sharded_loss_and_grads(arch, backend, mesh_name, params_fn)
    assert abs(float(loss) - ref["loss"]) > LOSS_RTOL * abs(ref["loss"])
    if fault != "dense0_skipped":  # (skipped, the dense layer has no gradient to compare)
        assert max(grad_errors(grads, ref["grads"]).values()) > GRAD_TOL
