"""LM decode over a mesh of shards: the cached prefill, ``init_cache`` and
``decode_step`` under the sharding rules against the reference's unsharded
``prefill`` and ``decode_step``, on simulated meshes of CPU shards.

All ten configs at ``.reduced()`` size in float32, on the weights of
``torch_train_parity``, bridged from the same numpy arrays as the
reference's.  Meshes (1, 2), (1, 4) and (2, 2) at B = 2, and (2, 2) at B = 1,
whose batch does not divide the data axis (``long_500k``'s single stream:
``cache_pspecs`` then puts the batch on no axis).  A cached prefill of 32
tokens (the VLM's 8 frontend positions before them; the audio decoder over
8 frames), then 4 teacher-forced decode steps.  The cache is placed leaf for
leaf by ``cache_pspecs``: the cached sequence of every k, v, ``ckv`` and
``kpe`` split over "model" (each decode step's attention a split-K reduce),
the SSM and conv states split as the spec says, ``ck``, ``cv`` whole.

* every step's logits within 1e-5 relative to their largest magnitude, and
  every cache leaf, gathered (``sharding.gather_cache``), within 1e-5 of the
  reference's leaf after the last step; xlstm, whose float32 rounding the
  sLSTM's exponential gating amplifies past 1e-5 (its unsharded port alone
  lies 1.07e-5 from the reference on ``sc`` at B = 1), against the float64
  unsharded port instead (``test_sharded_prefill_and_decode_match_reference``);
* xlstm in float64 (``torch_tp_probes.float64_port``): the sharded decode
  within 1e-10 of the unsharded port on every mesh, and the planted faults
  beyond that bound;
* a (1, 1) mesh gives the unsharded port's logits and cache within 1e-6;
* each placed block has exactly the local shape that the reference's own
  ``cache_pspecs`` implies on that mesh;
* the first decode step after a prompt shorter than one shard's block of
  the sequence (every shard but the first empty) is right;
* zamba2 at S = 96, where its window of 64 binds, the ring holds the last 64
  keys and decode wraps it;
* ``_cut`` raises on a split that does not divide, and so does a prefill
  whose cache capacity does not divide over "model"; the capacity guard
  reads the whole cache's capacity; a whole cache is refused under rules;
* the three planted faults of ``torch_tp_probes`` fail the bound: the
  split-K combine with each shard's own maximum, a shard's partial dropped,
  and the new key written by every shard;
* qwen3-8b on a (2, 2) mesh against the reference executing its own
  sharded decode: ``decode_step`` jitted with ``cache_pspecs``' shardings on
  a (2, 2) mesh of forced CPU devices (a subprocess).
"""
import contextlib
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import sharding as ref_sharding
from repro_torch.configs import ARCH_IDS
from repro_torch.launch.mesh import make_lm_mesh, simulated_devices
from repro_torch.models.lm.sharding import (
    Sharded,
    ShardingRules,
    _cut,
    gather_cache,
    shard_cache,
    shard_params,
    use_rules,
)
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.optim.adamw import tree_map
from torch_tp_probes import float64_port, planted
from torch_train_parity import float32_params, models, to_numpy, walk

# name -> (mesh, global batch)
MESHES = {"1x2": ((1, 2), 2), "1x4": ((1, 4), 2), "2x2": ((2, 2), 2), "2x2_b1": ((2, 2), 1)}
S, N_DECODE = 32, 4
REL_TOL = 1e-5
UNSHARDED_TOL = 1e-6
# the float64 port against itself: sharded and unsharded agree to ~1e-14
F64_TOL = 1e-10
# the reference's float32 decode against the float64 port (the families
# test's bound), for the configs whose float32 rounding passes REL_TOL
F32_TO_F64_TOL = 1e-4
FLOAT64_YARDSTICK = ("xlstm-1.3b",)
S_WINDOW = 96            # zamba2's reduced window of 64 binds: the ring wraps


def _rules(cfg, dims):
    mesh = make_lm_mesh(dims, devices=simulated_devices(dims[0] * dims[1], "cpu"))
    return ShardingRules(mesh, cfg)


def _inputs(cfg, b, s, seed=3):
    """Tokens (b, s + N_DECODE) and, for the VLM and audio families, frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, s + N_DECODE))
    fe = (rng.normal(size=(b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
          if cfg.frontend else None)
    return tokens, fe


_REF: dict = {}


def _reference(arch, b, s=S, max_seq=None):
    """The reference's unsharded prefill and teacher-forced decode steps:
    (logits of each step, the cache after the last), numpy."""
    key = (arch, b, s, max_seq)
    if key not in _REF:
        ref_lm, ref_p, lm, _ = models(arch)
        tokens, fe = _inputs(lm.cfg, b, s)
        logits, cache = jax.jit(ref_lm.prefill, static_argnums=3)(
            ref_p, jnp.asarray(tokens[:, :s]), None if fe is None else jnp.asarray(fe), max_seq)
        out = [to_numpy(logits)]
        step = jax.jit(ref_lm.decode_step)
        for i in range(N_DECODE):
            logits, cache = step(ref_p, cache, jnp.asarray(tokens[:, s + i:s + i + 1]))
            out.append(to_numpy(logits))
        _REF[key] = (out, {k: to_numpy(v) for k, v in cache.items() if k != "pos"},
                     int(cache["pos"]))
    return _REF[key]


def _port(lm, params, tokens, fe, s, max_seq=None):
    """The port's prefill and decode steps on ``params`` (placed ones under
    the active rules): (logits of each step, the cache after the last)."""
    tokens = torch.from_numpy(tokens)
    fe = None if fe is None else torch.from_numpy(fe)
    with torch.no_grad():
        logits, cache = lm.prefill(params, tokens[:, :s], fe, max_seq)
        out = [logits]
        for i in range(N_DECODE):
            logits, cache = lm.decode_step(params, cache, tokens[:, s + i:s + i + 1])
            out.append(logits)
    return out, cache


def _sharded(arch, dims, b, s=S, max_seq=None):
    _, _, lm, params = models(arch)
    rules = _rules(lm.cfg, dims)
    tokens, fe = _inputs(lm.cfg, b, s)
    with use_rules(rules):
        logits, cache = _port(lm, shard_params(rules, params), tokens, fe, s, max_seq)
    return lm, rules, logits, cache


def _float64(arch, dims, b, fault=None):
    """The port in float64 on the float64 weights: unsharded, and sharded
    on ``dims`` (None: not run) with ``fault`` planted: (logits, cache) each."""
    _, _, lm, params = models(arch)
    params = tree_map(lambda t: t.double(), params)
    tokens, fe = _inputs(lm.cfg, b, S)
    fe = None if fe is None else fe.astype(np.float64)
    with float64_port(lm):
        whole = _port(lm, params, tokens, fe, S)
        if dims is None:
            return whole, None
        rules = _rules(lm.cfg, dims)
        with use_rules(rules), (planted(fault) if fault else contextlib.nullcontext()):
            return whole, _port(lm, shard_params(rules, params), tokens, fe, S)


_YARD: dict = {}


def _yardstick(arch, b):
    """The float64 unsharded port's logits and cache, in ``_errors``' form."""
    if (arch, b) not in _YARD:
        logits, cache = _float64(arch, None, b)[0]
        assert logits[0].dtype == torch.float64
        _YARD[(arch, b)] = ([t.numpy() for t in logits],
                            {k: v.numpy() for k, v in cache.items() if k != "pos"}, cache["pos"])
    return _YARD[(arch, b)]


def _logits_err(got: torch.Tensor, want: np.ndarray) -> float:
    got = got.numpy()
    assert got.shape == want.shape
    live = want > -1e29
    np.testing.assert_array_equal(got > -1e29, live)
    return float(np.abs(got[live] - want[live]).max() / np.abs(want[live]).max())


def _leaf_err(got: torch.Tensor, want: np.ndarray) -> float:
    got = to_numpy(got)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _errors(logits, cache, ref) -> tuple[list, dict]:
    want_logits, want_cache, want_pos = ref
    whole = gather_cache(cache)
    assert whole["pos"] == want_pos
    assert set(whole) - {"pos"} == set(want_cache)
    return ([_logits_err(g, w) for g, w in zip(logits, want_logits)],
            {name: _leaf_err(whole[name], want) for name, want in want_cache.items()})


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharded_prefill_and_decode_match_reference(arch, mesh_name):
    """Against the reference within ``REL_TOL``.  xlstm's float32 rounding,
    amplified by the sLSTM's exponential gating over 36 steps, puts the
    unsharded port alone 1.07e-5 from the reference (``sc``, B = 1), and
    the sharded one 1.12e-5 (logits, 1 × 4): both round at float32's grain
    in the transcendentals, in different directions.  So xlstm is held to
    the float64 unsharded port, which does not round at that grain: (a) the
    reference's float32 run within ``F32_TO_F64_TOL`` of it, step by step
    and leaf by leaf, and (b) the port's float32 sharded run no farther
    from it than twice the reference's own distance, or ``REL_TOL``.
    Measured on the four meshes: the reference 8.3e-7-7.4e-6 (logits
    1.6e-6-6.7e-6), the sharded port 9.8e-7-9.9e-6, at most 1.8× the
    reference's distance, step by step and leaf by leaf."""
    dims, b = MESHES[mesh_name]
    lm, rules, logits, cache = _sharded(arch, dims, b)
    if arch in FLOAT64_YARDSTICK:
        want = _yardstick(arch, b)
        ref_logits, ref_cache, ref_pos = _reference(arch, b)
        ref_steps, ref_leaves = _errors([torch.tensor(x) for x in ref_logits],
                                        {"pos": ref_pos, **{k: torch.tensor(v)
                                                            for k, v in ref_cache.items()}}, want)
        assert max(ref_steps) <= F32_TO_F64_TOL, ref_steps
        assert max(ref_leaves.values()) <= F32_TO_F64_TOL, ref_leaves
        steps, leaves = _errors(logits, cache, want)
        assert all(e <= max(2 * r, REL_TOL) for e, r in zip(steps, ref_steps)), (steps, ref_steps)
        assert all(leaves[k] <= max(2 * ref_leaves[k], REL_TOL) for k in leaves), (
            leaves, ref_leaves)
    else:
        steps, leaves = _errors(logits, cache, _reference(arch, b))
        assert max(steps) <= REL_TOL, steps
        assert max(leaves.values()) <= REL_TOL, leaves
    # every leaf on the mesh, its cached sequence split over "model"
    assert all(isinstance(leaf, Sharded) for name, leaf in cache.items() if name != "pos")
    for name in ("k", "ckv"):
        if name in cache:
            assert cache[name].split_dim() == 2 and cache[name].grid[2] == dims[1]
            assert cache[name].grid[1] == (dims[0] if b % dims[0] == 0 else 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_shard_mesh_is_the_unsharded_port(arch):
    _, _, lm, params = models(arch)
    tokens, fe = _inputs(lm.cfg, 2, S)
    want_logits, want_cache = _port(lm, params, tokens, fe, S)
    got_logits, got_cache = _sharded(arch, (1, 1), 2)[2:]
    for got, want in zip(got_logits, want_logits):
        live = want > -1e29
        assert torch.equal(got > -1e29, live)
        assert float((got[live] - want[live]).abs().max() / want[live].abs().max()) <= UNSHARDED_TOL
    got_cache = gather_cache(got_cache)
    assert got_cache["pos"] == want_cache["pos"]
    for name, want in want_cache.items():
        if name != "pos":
            err = (got_cache[name] - want).abs().max() / want.abs().max().clamp(min=1e-30)
            assert got_cache[name].dtype == want.dtype and float(err) <= UNSHARDED_TOL, name


class _FakeMesh:
    def __init__(self, dims):
        self.shape = {"data": dims[0], "model": dims[1]}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placed_blocks_have_the_reference_cache_pspecs_local_shapes(arch, mesh_name):
    """``init_cache`` under the rules: each block's shape is the reference's
    leaf over the mesh axes that its own ``cache_pspecs`` gives the leaf."""
    dims, b = MESHES[mesh_name]
    ref_lm, _, lm, _ = models(arch)
    max_seq = 64
    shapes = jax.eval_shape(lambda: ref_lm.init_cache(b, max_seq))
    specs = ref_sharding.cache_pspecs(
        ref_sharding.ShardingRules(_FakeMesh(dims), ref_lm.cfg), shapes, b)
    rules = _rules(lm.cfg, dims)
    with use_rules(rules):
        cache = lm.init_cache(b, max_seq)
    assert cache["pos"] == 0 and set(cache) == set(shapes)
    for name, leaf in cache.items():
        if name == "pos":
            continue
        spec = tuple(specs[name]) + (None,) * (len(shapes[name].shape) - len(specs[name]))
        local = tuple(n // (1 if a is None else rules.mesh.axis_size(a))
                      for n, a in zip(shapes[name].shape, spec))
        assert leaf.spec == spec and tuple(leaf.shape) == shapes[name].shape, name
        assert all(tuple(blk.shape) == local for blk in leaf.own()), (name, local)
        assert str(leaf.blocks[0].dtype).removeprefix("torch.") == str(shapes[name].dtype)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-236b", "seamless-m4t-large-v2"])
def test_first_step_after_a_prompt_shorter_than_a_block(arch):
    """A 4-token prompt in a 64-slot cache over 4 shards of 16 slots: every
    shard but the first holds no key yet, so its partial must add 0."""
    s, max_seq = 4, 64
    lm, rules, logits, cache = _sharded(arch, (1, 4), 2, s=s, max_seq=max_seq)
    steps, leaves = _errors(logits, cache, _reference(arch, 2, s=s, max_seq=max_seq))
    assert max(steps) <= REL_TOL, steps
    assert max(leaves.values()) <= REL_TOL, leaves
    # the placed cache after the steps: the keys end at slot s + N_DECODE - 1 < 16
    blocks = cache["ckv" if lm.cfg.mla else "k"].own()
    per_slot = blocks[0].abs().transpose(0, 2).reshape(blocks[0].shape[2], -1).sum(dim=1)
    assert bool(per_slot[: s + N_DECODE].gt(0).all()) and bool((per_slot[s + N_DECODE:] == 0).all())
    assert all(bool((blk == 0).all()) for blk in blocks[1:])


@pytest.mark.parametrize("mesh_name", ["1x4", "2x2"])
def test_zamba2_ring_wraps_over_the_shards(mesh_name):
    dims, b = MESHES[mesh_name]
    lm, _, logits, cache = _sharded("zamba2-2.7b", dims, b, s=S_WINDOW)
    assert lm.cfg.sliding_window == 64 and cache["k"].shape[2] == 64
    steps, leaves = _errors(logits, cache, _reference("zamba2-2.7b", b, s=S_WINDOW))
    assert max(steps) <= REL_TOL, steps
    assert max(leaves.values()) <= REL_TOL, leaves


def test_cut_raises_on_a_split_that_does_not_divide():
    mesh = make_lm_mesh((1, 4), devices=simulated_devices(4, "cpu"))
    with pytest.raises(ValueError, match=r"\(6, 5\).*'model'"):
        _cut(torch.zeros((6, 5)), ("model", None), mesh, "model")
    # a cache of 98 slots over 4 shards: the prefill refuses to place it
    _, _, lm, params = models("qwen3-8b")
    rules = _rules(lm.cfg, (1, 4))
    tokens, _ = _inputs(lm.cfg, 2, S)
    with use_rules(rules), pytest.raises(ValueError, match="98"):
        lm.prefill(shard_params(rules, params), torch.from_numpy(tokens[:, :S]), None, 98)


def test_capacity_guard_and_a_whole_cache_under_rules():
    _, _, lm, params = models("qwen3-8b")
    rules = _rules(lm.cfg, (1, 4))
    tokens, _ = _inputs(lm.cfg, 2, S)
    tokens = torch.from_numpy(tokens)
    placed = shard_params(rules, params)
    with use_rules(rules), torch.no_grad():
        _, cache = lm.prefill(placed, tokens[:, :S], None, S + 4)
        with pytest.raises(TypeError, match="placed cache"):
            lm.decode_step(placed, gather_cache(cache), tokens[:, S:S + 1])
        for i in range(4):  # the whole cache's 36 slots, 9 a shard
            _, cache = lm.decode_step(placed, cache, tokens[:, S + i:S + i + 1])
        with pytest.raises(ValueError, match="capacity 36"):
            lm.decode_step(placed, cache, tokens[:, :1])
    # a whole cache placed by shard_cache decodes as the placed prefill's own
    with torch.no_grad():
        whole = lm.prefill(params, tokens[:, :S])[1]
    with use_rules(rules), torch.no_grad():
        want, _ = lm.decode_step(placed, shard_cache(rules, whole), tokens[:, S:S + 1])
    got = _port(lm, params, tokens.numpy(), None, S)[0][1]
    assert float((want - got).abs()[:, :lm.cfg.vocab].max() / got[:, :lm.cfg.vocab].abs().max()
                 ) <= REL_TOL


# ------------------------------------------------------------ planted faults
@pytest.mark.parametrize("fault", ["split_k_own_max", "split_k_dropped_partial",
                                   "new_key_on_every_shard"])
def test_planted_faults_fail(fault):
    """qwen3-8b on (1, 4) in a cache of 40 slots, 10 a shard: the decode
    steps' slots 32-35 lie in the last shard's block, so a key written by
    every shard lands on live slots of the others."""
    max_seq = 40
    ref = _reference("qwen3-8b", 2, max_seq=max_seq)
    steps, leaves = _errors(*_sharded("qwen3-8b", (1, 4), 2, max_seq=max_seq)[2:], ref)
    assert max(steps) <= REL_TOL and max(leaves.values()) <= REL_TOL
    with planted(fault):
        steps, leaves = _errors(*_sharded("qwen3-8b", (1, 4), 2, max_seq=max_seq)[2:], ref)
    assert steps[0] <= REL_TOL  # the prefill is untouched
    assert not max(steps[1:]) <= REL_TOL, steps
    if fault == "new_key_on_every_shard":
        assert not max(leaves.values()) <= REL_TOL, leaves


def _f64_errors(got, want) -> float:
    """The largest relative distance of ``got``'s logits and gathered cache
    leaves from ``want``'s, in float64 (``_errors`` rounds leaves to float32)."""
    (got_logits, got_cache), (want_logits, want_cache) = got, want
    got_cache = gather_cache(got_cache)
    assert got_cache["pos"] == want_cache["pos"] and set(got_cache) == set(want_cache)
    for g, w in zip(got_logits, want_logits):  # the padded vocabulary's -1e30 excluded
        assert torch.equal(g > -1e29, w > -1e29)
    pairs = [*((g[w > -1e29], w[w > -1e29]) for g, w in zip(got_logits, want_logits)),
             *((got_cache[k], w) for k, w in want_cache.items() if k != "pos")]
    assert all(g.dtype == w.dtype == torch.float64 for g, w in pairs)
    return max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-300)) for g, w in pairs)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_xlstm_float64_sharded_decode_matches_the_float64_unsharded_port(mesh_name):
    """In float64 the shards' layout is held far below float32's rounding:
    measured 1.1e-14-1.9e-14 on the four meshes, against a bound of 1e-10,
    10^5 times below the float32 gaps to the reference (1.0e-5-1.1e-5); a
    state block written to the next shard's lies at 1.47-1.66."""
    dims, b = MESHES[mesh_name]
    whole, sharded = _float64("xlstm-1.3b", dims, b)
    assert _f64_errors(sharded, whole) <= F64_TOL
    assert F64_TOL * 100 <= 1.02e-5 / 100  # the bound, against the smallest float32 gap
    _, bad = _float64("xlstm-1.3b", dims, b, "state_blocks_rotated")
    assert _f64_errors(bad, whole) > 1e3 * F64_TOL


@pytest.mark.parametrize("fault", ["split_k_own_max", "split_k_dropped_partial",
                                   "new_key_on_every_shard"])
def test_planted_decode_faults_lie_beyond_the_float64_bound(fault):
    """The three split-K faults reach no xlstm layer (it has no attention),
    so they are planted in the same float64 run of zamba2, whose shared
    attention block decodes over the split cache: clean within ``F64_TOL``,
    each fault beyond it by far (clean 1.5e-15; faults 0.135, 0.182, 1.24)."""
    dims, b = MESHES["1x4"]
    whole, sharded = _float64("zamba2-2.7b", dims, b)
    assert _f64_errors(sharded, whole) <= F64_TOL
    _, bad = _float64("zamba2-2.7b", dims, b, fault)
    assert _f64_errors(bad, whole) > 1e3 * F64_TOL


# ------------------------- against the reference's own sharded decode (2 x 2)
_DECODE_WORKER = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models.lm import LM
from repro.models.lm.sharding import (ShardingRules, batch_pspec, cache_pspecs, param_pspecs,
                                      use_rules)
kw = json.loads(sys.argv[1])
data = np.load(kw["inputs"])
params = {}
for key in data.files:
    if key.startswith("p/"):
        node = params
        *path, leaf = key[2:].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(data[key])
tokens, s = data["tokens"], kw["s"]
cfg = dataclasses.replace(get_config(kw["arch"]).reduced(), dtype="float32")
lm = LM(cfg, remat=False, attn_block=64, loss_chunk=16)
# GSPMD's automatic axes (jax.make_mesh's explicit ones refuse the decode's
# dynamic_update_slice of a sequence-sharded cache)
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
rules = ShardingRules(mesh, cfg)
logits, cache = jax.jit(lm.prefill)(params, jnp.asarray(tokens[:, :s]))
out = {"logits0": np.asarray(logits)}
with use_rules(rules):
    named = lambda tree: jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree)
    c_sh = named(cache_pspecs(rules, cache, tokens.shape[0]))
    b_sh = NamedSharding(mesh, batch_pspec(rules, "decode", tokens.shape[0])["tokens"])
    step = jax.jit(lm.decode_step, in_shardings=(named(param_pspecs(rules, params)), c_sh, b_sh),
                   out_shardings=(NamedSharding(mesh, P()), c_sh))
    cache = jax.device_put(cache, c_sh)
    for i in range(kw["steps"]):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, s + i:s + i + 1]))
        out[f"logits{i + 1}"] = np.asarray(logits)
for name, leaf in cache.items():
    out[f"cache/{name}"] = np.asarray(leaf)
np.savez(kw["out"], **out)
print(json.dumps({"devices": len(jax.devices()), "k_spec": str(cache["k"].sharding.spec),
                  "k_shards": len(cache["k"].addressable_shards)}))
"""


def test_sharded_decode_matches_reference_on_a_2x2_cpu_mesh(tmp_path):
    from repro.launch.mesh import forced_host_devices_env

    arch, b = "qwen3-8b", 2
    _, _, lm, params = models(arch)
    tokens, _ = _inputs(lm.cfg, b, S)
    flat = {"p/" + "/".join(path): a for path, a in walk(float32_params(arch))}
    np.savez(tmp_path / "inputs.npz", tokens=tokens, **flat)
    kw = dict(arch=arch, s=S, steps=N_DECODE, inputs=str(tmp_path / "inputs.npz"),
              out=str(tmp_path / "out.npz"))
    proc = subprocess.run([sys.executable, "-c", _DECODE_WORKER, json.dumps(kw)],
                          env=forced_host_devices_env(4), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    # the reference's cache really was split: batch over "data", sequence over "model"
    assert info["devices"] == 4 and info["k_shards"] == 4
    assert info["k_spec"] == str(jax.sharding.PartitionSpec(None, "data", "model", None, None))
    got = np.load(tmp_path / "out.npz")
    want = ([got[f"logits{i}"] for i in range(N_DECODE + 1)],
            {k.removeprefix("cache/"): got[k] for k in got.files
             if k.startswith("cache/") and k != "cache/pos"},
            int(got["cache/pos"]))
    steps, leaves = _errors(*_sharded(arch, (2, 2), b)[2:], want)
    assert max(steps) <= REL_TOL, steps
    assert max(leaves.values()) <= REL_TOL, leaves
