"""The port's tensor-parallel rules against the reference's ``sharding.py``.

Mesh-free, as the reference's own ``test_sharding_and_dryrun.py``: the rules
only read a mesh's axis sizes, so both packages are given the same fake
meshes.  Every spec is compared as a tuple (the reference's ``PartitionSpec``
and the port's ``PSpec`` hold the same entries):

* ``cells()``: the 40 (arch × shape) cells, the 8 full-attention
  ``long_500k`` ones skipped with the reference's reason;
* ``param_pspecs`` leaf by leaf for the ten configs at ``.reduced()`` and at
  full width on a (1, 1) mesh, and on fake (1, 2), (2, 4) and (16, 16)
  meshes with and without FSDP (``_match_spec``'s divisibility guard and
  FSDP's pick of the largest free divisible dim; granite's 8 KV heads on a
  16-way model axis replicated);
* ``batch_pspec`` and ``cache_pspecs`` over every leaf of ``init_cache``,
  with a batch that divides by the data-parallel size and one that does not;
* ``input_specs`` of every applicable cell, shapes and types;
* ``shard_params`` followed by ``gather_params``, bitwise the identity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_get_config
from repro.models.lm import LM as RefLM
from repro.models.lm import sharding as ref_sharding
from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.launch.mesh import make_lm_mesh, make_production_mesh, simulated_devices
from repro_torch.models.lm import LM
from repro_torch.models.lm import sharding
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)


class FakeMesh:
    def __init__(self, dims, axes=("data", "model")):
        self.shape = dict(zip(axes, dims))


MESHES = [(1, 2), (2, 4), (16, 16)]


def _specs_by_path(tree, path=()):
    """(path, spec as a tuple) of a spec tree, either package's."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _specs_by_path(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _specs_by_path(v, (*path, i))
    else:
        yield path, tuple(tree)


def _rules(dims, cfg, ref_cfg, **kw):
    mesh = FakeMesh(dims)
    return (ref_sharding.ShardingRules(mesh, ref_cfg, **kw),
            sharding.ShardingRules(mesh, cfg, **kw))


def _cfgs(arch, reduced):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    return (ref_cfg.reduced(), cfg.reduced()) if reduced else (ref_cfg, cfg)


def _shapes(arch, reduced):
    ref_cfg, cfg = _cfgs(arch, reduced)
    return RefLM(ref_cfg).init_shapes(), LM(cfg).init_shapes()


def _assert_same_specs(ref_specs, specs):
    want, got = dict(_specs_by_path(ref_specs)), dict(_specs_by_path(specs))
    assert set(got) == set(want)
    bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
    assert not bad, bad


def test_cell_applicability_matrix():
    cs = cells()
    assert cs == ref_cells()
    assert len(cs) == 40 and ARCH_IDS == REF_ARCH_IDS and list(SHAPES) == list(REF_SHAPES)
    skipped = [(a, s, why) for a, s, ok, why in cs if not ok]
    assert len(skipped) == 8
    assert all(s == "long_500k" and "not sub-quadratic" in why for _, s, why in skipped)
    assert sorted(a for a, s, ok, _ in cs if ok and s == "long_500k") == [
        "xlstm-1.3b", "zamba2-2.7b"]
    for name, shape in SHAPES.items():
        ref = REF_SHAPES[name]
        assert (shape.kind, shape.seq_len, shape.global_batch) == (
            ref.kind, ref.seq_len, ref.global_batch)
        r, rr = shape.reduced(), ref.reduced()
        assert (r.seq_len, r.global_batch) == (rr.seq_len, rr.global_batch)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference_on_one_device(arch, reduced):
    ref_cfg, cfg = _cfgs(arch, reduced)
    ref_shapes, shapes = _shapes(arch, reduced)
    mesh = make_lm_mesh((1, 1), devices=["meta"])
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref_specs = ref_sharding.param_pspecs(ref_sharding.ShardingRules(ref_mesh, ref_cfg), ref_shapes)
    specs = sharding.param_pspecs(sharding.ShardingRules(mesh, cfg), shapes)
    _assert_same_specs(ref_specs, specs)
    # the leaves' shapes are the reference's too
    ref_leaves = dict(_specs_by_path(jax.tree.map(lambda s: s.shape, ref_shapes,
                                                  is_leaf=lambda x: hasattr(x, "shape"))))
    got = dict(_specs_by_path(shapes_tree(shapes)))
    assert got == ref_leaves


def shapes_tree(tree):
    if isinstance(tree, dict):
        return {k: shapes_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [shapes_tree(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_match_spec_matches_reference_on_fake_meshes(dims, fsdp):
    for arch in ARCH_IDS:
        for reduced in (False, True):
            ref_cfg, cfg = _cfgs(arch, reduced)
            ref_shapes, shapes = _shapes(arch, reduced)
            ref_rules, rules = _rules(dims, cfg, ref_cfg, fsdp=fsdp,
                                      fsdp_min_elems=1 << 20 if not reduced else 1 << 10)
            _assert_same_specs(ref_sharding.param_pspecs(ref_rules, ref_shapes),
                               sharding.param_pspecs(rules, shapes))


def test_divisibility_guard_replicates_granite_kv_heads():
    cfg = get_config("granite-moe-1b-a400m")
    _, rules = _rules((16, 16), cfg, ref_get_config("granite-moe-1b-a400m"))
    assert sharding._match_spec("/blocks/attn/wk", (24, 1024, 8, 64), rules) == (
        None, None, None, None)
    assert sharding._match_spec("/blocks/attn/wq", (24, 1024, 16, 64), rules) == (
        None, None, "model", None)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_batch_and_cache_pspecs_match_reference(dims):
    for arch in ARCH_IDS:
        ref_cfg, cfg = _cfgs(arch, True)
        ref_rules, rules = _rules(dims, cfg, ref_cfg)
        ref_lm, lm = RefLM(ref_cfg), LM(cfg)
        for batch in (dims[0] * 2, 3):  # divides by the data-parallel size, and not
            for kind in ("train", "prefill", "decode"):
                want = ref_sharding.batch_pspec(ref_rules, kind, batch)
                got = sharding.batch_pspec(rules, kind, batch)
                assert {k: tuple(v) for k, v in got.items()} == {
                    k: tuple(v) for k, v in want.items()}
            ref_cache = jax.eval_shape(lambda: ref_lm.init_cache(batch, 40))
            cache = lm.init_cache(batch, 40, "meta")
            want = dict(_specs_by_path(ref_sharding.cache_pspecs(ref_rules, ref_cache, batch)))
            got = dict(_specs_by_path(sharding.cache_pspecs(rules, cache, batch)))
            assert got == want, arch
            # the leaves themselves agree in shape
            assert {k: tuple(v.shape) for k, v in cache.items() if k != "pos"} == {
                k: tuple(v.shape) for k, v in ref_cache.items() if k != "pos"}


def test_input_specs_match_reference_for_every_cell(monkeypatch):
    import os

    # importing the reference's dry run sets XLA_FLAGS for its own process
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.dryrun import input_specs as ref_input_specs
    from repro_torch.launch.dryrun import input_specs

    n = 0
    for arch, shape_name, ok, _ in cells():
        if not ok:
            continue
        want = ref_input_specs(arch, shape_name)
        got = input_specs(arch, shape_name)
        assert set(got) == set(want) and "tokens" in got
        for name, w in want.items():
            g = got[name]
            assert g.device.type == "meta"
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).removeprefix("torch.") == str(jnp.dtype(w.dtype))
        n += 1
    assert n == 32


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("dims", [(1, 4), (2, 2), (2, 4)], ids=lambda d: f"{d[0]}x{d[1]}")
def test_shard_then_gather_is_the_identity(dims, fsdp):
    for arch in ("qwen3-8b", "qwen1.5-0.5b", "gemma-7b", "internvl2-1b", "deepseek-v2-236b",
                 "zamba2-2.7b"):
        cfg = get_config(arch).reduced()
        params = LM(cfg).init(torch.Generator().manual_seed(3))
        mesh = make_lm_mesh(dims, devices=simulated_devices(dims[0] * dims[1], "cpu"))
        rules = sharding.ShardingRules(mesh, cfg, fsdp=fsdp, fsdp_min_elems=1)
        placed = sharding.shard_params(rules, params)
        back = sharding.gather_params(placed)
        n_split = 0
        for (path, a), (_, b) in zip(_walk(params), _walk(back)):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b), path
        for path, leaf in _walk(placed):
            assert leaf.shape == _get(params, path).shape
            blocks = len(leaf.blocks)
            n_split += blocks > 1
            # every block stored once, all of one size
            assert len({tuple(b.shape) for b in leaf.blocks}) == 1
            assert sum(b.numel() for b in leaf.blocks) == leaf.shape.numel()
        assert n_split > 0, arch


@pytest.mark.parametrize("dims", [(2, 2), (4, 2)], ids=["2x2", "4x2"])
def test_locals_are_model_blocks_with_fsdp_dims_gathered(dims):
    from repro_torch.models.lm import collectives

    cfg = get_config("qwen3-8b").reduced()
    params = LM(cfg).init(torch.Generator().manual_seed(4))
    mesh = make_lm_mesh(dims, devices=simulated_devices(dims[0] * dims[1], "cpu"))
    rules = sharding.ShardingRules(mesh, cfg, fsdp=True, fsdp_min_elems=1)
    leaf = sharding.shard_params(rules, params)["blocks"]["ffn"]["w_gate"]  # (L, D, F)
    assert leaf.spec == (None, "data", "model"), leaf.spec
    full, tp = leaf.full(), mesh.shape["model"]
    collectives.reset_stats()
    xs = leaf.locals()
    f_loc = full.shape[-1] // tp
    for n, (coord, x) in enumerate(zip(mesh.coords, xs)):
        j = mesh.axis_index(coord, "model")
        assert torch.equal(x, full[..., j * f_loc:(j + 1) * f_loc]), n
    g = dims[0]
    assert collectives.STATS.per_op_count == {"all-gather": 1}
    assert collectives.STATS.link_bytes == collectives.nbytes(xs[0]) * (g - 1) / g


def test_production_mesh_is_meta_shards():
    mesh = make_production_mesh()
    assert mesh.size == 256 and mesh.shape == {"data": 16, "model": 16}
    assert {d.type for d in mesh.devices} == {"meta"}
    multi = make_production_mesh(multi_pod=True)
    assert multi.size == 512 and multi.axis_names == ("pod", "data", "model")
    rules = sharding.ShardingRules(multi, get_config("qwen3-8b"), dp_axes=("pod", "data"))
    assert rules.dp() == 32 and rules.tp == 16
    assert rules.axis("batch") == ("pod", "data")


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, (*path, i))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_constrain_is_a_no_op_with_and_without_rules():
    x = [torch.ones(2)]
    assert sharding.constrain(x, "batch", None, None) is x
    rules = sharding.ShardingRules(FakeMesh((1, 2)), get_config("qwen3-8b"))
    with sharding.use_rules(rules):
        assert sharding.active_rules() is rules
        assert sharding.constrain(x, "batch", None, None) is x
    assert sharding.active_rules() is None
    np.testing.assert_array_equal(x[0].numpy(), np.ones(2))
