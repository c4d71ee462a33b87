"""The port's checkpoints (``checkpoint/manager.py``), on the CPU.

The reference's ``tests/test_checkpoint.py`` case by case (round trip,
no ``.tmp`` left, crc corruption caught, retention, restore of the newest,
restore onto a device in place of its elastic ``shardings=``, a missing
leaf, a shape mismatch), then what the port adds: bf16 leaves bitwise, keys
spelled as the reference spells them, a checkpoint the reference writes
(``(params, AdamWState)`` of an LM, zstd-compressed here, where
``zstandard`` imports) restored bitwise into the port's tree, a zstd blob
without ``zstandard`` refused with the leaf's name, and an async save that
holds the state as it was when ``save`` returned.
"""
import builtins
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten_with_paths as ref_flatten
from repro.checkpoint.manager import save_pytree as ref_save
from repro.configs import get_config as ref_get_config
from repro.models.lm import LM as RefLM
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    flatten_with_paths,
    load_pytree,
    save_pytree,
)
from repro_torch.optim.adamw import AdamWState, adamw_init


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()]).numpy()


@pytest.fixture
def tree():
    g = torch.Generator().manual_seed(0)
    return {
        "a": torch.randn((16, 8), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32),
                   "c": torch.ones((3,), dtype=torch.bfloat16)},
    }


def _assert_same(got, want):
    for (ka, a), (kb, b) in zip(flatten_with_paths(got), flatten_with_paths(want)):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape, ka
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_roundtrip_exact(tmp_path, tree):
    path = str(tmp_path / "x.ckpt")
    save_pytree(tree, path, {"step": 7})
    loaded, meta = load_pytree(path, tree)
    assert meta["step"] == 7
    _assert_same(loaded, tree)


def test_no_tmp_left_behind(tmp_path, tree):
    save_pytree(tree, str(tmp_path / "x.ckpt"))
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_crc_detects_corruption(tmp_path, tree):
    path = str(tmp_path / "x.ckpt")
    save_pytree(tree, path)
    with open(path, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\x00\x00\x00\x01")
    with pytest.raises(Exception):
        load_pytree(path, tree)


def test_retention_gc(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, tree)
    assert mgr.steps() == [30, 40]
    assert mgr.latest_step() == 40
    assert not any(f.endswith(".trash") for f in os.listdir(tmp_path))


def test_restore_latest(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    t2 = {"a": tree["a"] * 2, "nested": tree["nested"]}
    mgr.save(1, tree)
    mgr.save(2, t2)
    loaded, meta = mgr.restore(tree)
    assert meta["step"] == 2
    np.testing.assert_array_equal(loaded["a"].numpy(), t2["a"].numpy())


def test_restore_onto_a_device(tmp_path, tree):
    """The reference's elastic path restores against new shardings; the
    port's takes ``device=`` and each leaf lands there in its target type."""
    path = str(tmp_path / "x.ckpt")
    save_pytree(tree, path)
    loaded, _ = load_pytree(path, tree, device=torch.device("cpu"))
    _assert_same(loaded, tree)
    assert all(t.device.type == "cpu" for _, t in flatten_with_paths(loaded))


def test_missing_leaf_raises(tmp_path, tree):
    path = str(tmp_path / "x.ckpt")
    save_pytree({"a": tree["a"]}, path)
    with pytest.raises(KeyError):
        load_pytree(path, tree)


def test_shape_mismatch_raises(tmp_path, tree):
    path = str(tmp_path / "x.ckpt")
    save_pytree(tree, path)
    bad = dict(tree, a=torch.zeros((4, 4)))
    with pytest.raises(ValueError):
        load_pytree(path, bad)


# ------------------------------------------------------------ the port's own
def test_bf16_leaves_roundtrip_bitwise(tmp_path):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((64, 33), generator=g).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40]).to(torch.bfloat16)
    tree = {"w": x, "m": [x.float(), x[:2]]}
    path = str(tmp_path / "x.ckpt")
    save_pytree(tree, path)
    raw, _ = load_pytree(path)
    assert raw["w"].dtype == torch.bfloat16
    loaded, _ = load_pytree(path, tree)
    _assert_same(loaded, tree)


@functools.cache
def _ref_lm_state():
    cfg = ref_get_config("deepseek-v2-236b").reduced()
    params = RefLM(cfg, remat=False).init(jax.random.PRNGKey(0))
    opt = ref_adamw_init(params)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       mu=jax.tree.map(lambda x: x + 0.5, opt.mu),
                       nu=jax.tree.map(lambda x: x + 0.25, opt.nu))
    return params, opt


def test_keys_are_spelled_as_the_references():
    params, opt = _ref_lm_state()
    port = lm_params_from_numpy(jax.tree.map(np.asarray, params), torch.bfloat16)
    want = [k for k, _ in ref_flatten((params, opt))]
    assert [k for k, _ in flatten_with_paths((port, adamw_init(port)))] == want
    assert "1/.step" in want and "0/dense0/0/ln1" in want


def test_reference_checkpoint_restores_bitwise(tmp_path):
    """A ``(params, AdamWState)`` checkpoint of the reference's bf16 LM
    (DeepSeek's reduced config: the ``dense0`` list, MLA, the float32
    router) restored into the port's tree, every leaf bitwise."""
    params, opt = _ref_lm_state()
    path = str(tmp_path / "ref.ckpt")
    ref_save((params, opt), path, {"step": 3})
    port = lm_params_from_numpy(jax.tree.map(np.asarray, params), torch.bfloat16)
    (p, o), meta = load_pytree(path, (port, adamw_init(port)))
    assert meta == {"step": 3} and isinstance(o, AdamWState) and int(o.step) == 7
    flat = dict(flatten_with_paths((p, o)))
    for key, want in ref_flatten((params, opt)):
        got, want = flat[key], np.asarray(want)
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, key
        np.testing.assert_array_equal(_bits(got), want.view(_bits(got).dtype), err_msg=key)


def test_zstd_blob_without_zstandard_names_the_leaf(tmp_path, monkeypatch):
    params, opt = _ref_lm_state()
    path = str(tmp_path / "ref.ckpt")
    ref_save({"embed": params["embed"]}, path)
    real_import = builtins.__import__

    def no_zstd(name, *args, **kw):
        if name == "zstandard":
            raise ImportError("no zstandard")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_zstd)
    with open(path, "rb") as f:
        data = f.read()
    assert b"\x28\xb5\x2f\xfd" in data
    with pytest.raises(RuntimeError, match="'embed'.*zstd"):
        load_pytree(path)


def test_async_save_snapshots_before_returning(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    want = {"a": tree["a"].clone(), "nested": dict(tree["nested"])}
    mgr.save(5, tree, block=False)
    tree["a"].mul_(-3.0)          # the train loop moves on while the file is written
    mgr.wait()
    loaded, meta = mgr.restore(tree)
    assert meta["step"] == 5
    np.testing.assert_array_equal(loaded["a"].numpy(), want["a"].numpy())


def test_scalar_empty_and_strided_leaves_roundtrip(tmp_path):
    """A 0-d step counter, an empty leaf and a transposed (non-contiguous)
    view, as an optimizer state and a sliced tree can hold them."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tree = {"step": torch.tensor(7, dtype=torch.int32), "empty": torch.zeros((0, 3)),
            "t": x.T, "half": x.to(torch.bfloat16)[:, ::2]}
    path = str(tmp_path / "x.ckpt")
    save_pytree(tree, path)
    loaded, _ = load_pytree(path, tree)
    for key, want in tree.items():
        got = loaded[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert torch.equal(got, want), key
