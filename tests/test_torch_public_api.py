"""The port's public API against the reference's, name for name, and the
reference's last public functions held to the port's on the CPU.

* Completeness: an ``ast`` walk over every ``src/repro/**.py`` (neither
  package is imported for it).  Each reference module has a module at the
  same path under ``src/repro_torch/``, or is a module that the port covers
  under another name (``MODULES_ELSEWHERE``).  In each module with a
  counterpart, every public top-level function or class, and every public
  method of a public class, exists in the port's module (a method may come
  from a base class, resolved in the port's module or the port module it
  is imported from), but for the JAX mechanisms of ``JAX_ONLY``.  Both
  allow-lists must stay needed: an entry the port now has fails the test.
* ``core/qmc.py``: ``sobol_sequence`` bitwise the reference's with
  ``shift_half`` both ways and bitwise ``scipy.stats.qmc.Sobol(d,
  scramble=False)`` without it; ``normal_qmc_samples`` with and without a
  key (the shift bitwise, the normals within one float32 ulp, the share of
  points that differ stated); ``discrepancy_proxy`` to 1e-12; both grids
  default to the card and raise without one.
* The tree classifiers' ``predict_proba``, bridged from the reference's
  fitted forests, within 1e-6 of the reference's.
* ``kernels/sampled_agg/ops.estimates_from_moments`` within 1e-6 of the
  reference's, eager and jitted, counts of 0 and 1 and whole groups
  included.
* ``Pipeline.n_features`` of all eight pipelines and ``planner.PlanState``.
"""
from __future__ import annotations

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import qmc as scipy_qmc

from repro.core import planner as ref_planner
from repro.core import qmc as ref_qmc
from repro.data.synthetic import make_pipeline as ref_make_pipeline
from repro.kernels.sampled_agg import ops as ref_ops
from repro.models.tabular.trees import GradientBoosting as RefGBM
from repro.models.tabular.trees import RandomForest as RefRF
from repro_torch import core as port_core
from repro_torch import numerics
from repro_torch.bridge import model_from_numpy
from repro_torch.core import planner, qmc, threefry
from repro_torch.data.synthetic import PIPELINE_NAMES
from repro_torch.data.synthetic import make_pipeline as port_make_pipeline
from repro_torch.kernels.sampled_agg import ops
from test_torch_bridge import TINY, model_to_numpy

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

# Reference modules the port covers under another name (ROADMAP Queue 1):
# module -> the port's counterpart.
MODULES_ELSEWHERE = {
    "analysis/jaxpr_lint.py": "analysis/program_lint.py",  # the program linter on aten ops
    "analysis/hlo_lint.py": "analysis/program_lint.py",
    "launch/hlo_cost.py": "launch/cost.py",                # FLOPs and bytes from the dispatch
    "launch/hlo_stats.py": "launch/cost.py",
    "kernels/sobol/ref.py": "core/qmc.py",                 # its oracle is core/qmc.sobol_uint32
}
# Public names of the reference that are JAX mechanisms: (module, name) ->
# the port's counterpart, recorded rather than copied.
JAX_ONLY = {
    # an XLA flag that forces host devices in a forked process
    ("launch/mesh.py", "forced_host_devices_env"): "launch/mesh.py::simulated_devices",
    # a jax.sharding.NamedSharding of a leaf
    ("models/lm/sharding.py", "ShardingRules.sharding"):
        "models/lm/sharding.py::shard_params / Sharded",
}


# ---------------------------------------------------------------- completeness
def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _bound_names(tree: ast.Module) -> set:
    """Names a module binds at its top level: definitions, assignments and
    imports."""
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


def _public_api(tree: ast.Module) -> list:
    """Public top-level functions and classes, and ``Class.method`` for the
    public methods of each public class."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{m}" for m in _methods(node) if not m.startswith("_")]
    return out


def _methods(cls: ast.ClassDef) -> set:
    return {n.name for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _port_module(rel: str) -> ast.Module | None:
    path = PORT / rel
    return _parse(path) if path.exists() else None


def _class_methods(tree: ast.Module, name: str, seen=()) -> set | None:
    """Methods of class ``name`` of a port module with those of its bases,
    each base resolved in the module or in the port module it is imported
    from; None where the module has no such class."""
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    if name not in classes:
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("repro_torch."):
                for alias in node.names:
                    if (alias.asname or alias.name) == name and (node.module, name) not in seen:
                        rel = node.module.removeprefix("repro_torch.").replace(".", "/")
                        other = _port_module(rel + ".py") or _port_module(rel + "/__init__.py")
                        if other is not None:
                            return _class_methods(other, alias.name, (*seen, (node.module, name)))
        return None
    out = set(_methods(classes[name]))
    for base in classes[name].bases:
        if isinstance(base, ast.Name) and base.id != name:
            out |= _class_methods(tree, base.id, seen) or set()
    return out


def _missing() -> tuple[dict, set]:
    """(reference module -> its public names the port lacks; reference
    modules with no port module)."""
    missing, no_module = {}, set()
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        port = _port_module(rel)
        if port is None:
            no_module.add(rel)
            continue
        names = _bound_names(port)
        lacking = []
        for name in _public_api(_parse(path)):
            cls, _, method = name.partition(".")
            if not method:
                if name not in names:
                    lacking.append(name)
                continue
            methods = _class_methods(port, cls)
            if methods is not None and method not in methods:
                lacking.append(name)
        if lacking:
            missing[rel] = lacking
    return missing, no_module


def test_every_reference_module_has_a_port_counterpart():
    _, no_module = _missing()
    assert no_module == set(MODULES_ELSEWHERE), no_module ^ set(MODULES_ELSEWHERE)
    for rel, there in MODULES_ELSEWHERE.items():
        assert (REF / rel).exists() and (PORT / there).exists(), (rel, there)


def test_the_port_has_every_public_name_of_the_reference():
    missing, _ = _missing()
    lacking = {(rel, name) for rel, names in missing.items() for name in names}
    assert lacking == set(JAX_ONLY), lacking ^ set(JAX_ONLY)
    for (rel, name), there in JAX_ONLY.items():
        module, _, attr = there.partition("::")
        names = _bound_names(_parse(PORT / module))
        assert all(a.strip() in names for a in attr.split("/")), (name, there)


def test_the_walk_sees_a_method_inherited_within_the_port_module():
    """``RandomForest.predict_proba`` resolves through the class itself, and
    its ``_raw`` through its base ``TreeModel``."""
    tree = _parse(PORT / "models/tabular/trees.py")
    methods = _class_methods(tree, "RandomForest")
    assert {"predict", "predict_raw", "predict_proba", "_raw"} <= methods
    assert "predict_proba" not in _methods(
        next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "TreeModel"))


# ------------------------------------------------------------------ core/qmc
GRIDS = [(1, 1, 0), (64, 5, 0), (100, 21, 7), (257, 13, 1000), (1000, 18, 0), (33, 21, 65536)]


@pytest.mark.parametrize("n,dim,skip", GRIDS)
@pytest.mark.parametrize("shift_half", [True, False])
def test_sobol_sequence_is_the_references_bitwise(n, dim, skip, shift_half):
    want = np.asarray(ref_qmc.sobol_sequence(n, dim, skip, shift_half=shift_half))
    got = qmc.sobol_sequence(n, dim, skip, shift_half=shift_half, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n, dim)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,dim,skip", GRIDS)
def test_unshifted_sobol_sequence_is_scipys(n, dim, skip):
    engine = scipy_qmc.Sobol(dim, scramble=False, bits=32)
    if skip:
        engine.fast_forward(skip)
    want = engine.random(n).astype(np.float32)
    got = port_core.sobol_sequence(n, dim, skip, shift_half=False, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got − want| in float32 ulps (same-signed values)."""
    assert (np.sign(got) == np.sign(want)).all()
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


# (n, dim, seed or None for no key, skip, the most ulps a normal may differ
# by, the largest share of points that may differ).  Φ⁻¹ (Cephes, as in JAX)
# takes two logs: the port rounds them correctly (``qmc._log``), XLA's CPU log
# is not correctly rounded, and a one-ulp log moves Φ⁻¹ in its middle
# branch (|x| ≈ 1.2-2) by up to 4 ulps.  Measured: turbofan's unkeyed
# (1000, 18) grid 36 points of 18000 (0.2%), one ulp each; keyed or skipped
# grids 0.34-0.78% of points, up to 4 ulps (up to 6 at (65536, 64)).
NORMAL_CASES = [(1000, 18, None, 0, 1, 0.003), (1000, 18, 3, 0, 4, 0.01),
                (256, 21, 7, 5, 4, 0.01), (4096, 4, None, 1, 4, 0.01)]


@pytest.mark.parametrize("n,dim,seed,skip,max_ulps,max_share", NORMAL_CASES)
def test_normal_qmc_samples_match_the_reference(n, dim, seed, skip, max_ulps, max_share):
    ref_key = None if seed is None else jax.random.PRNGKey(seed)
    key = None if seed is None else threefry.PRNGKey(seed)
    want = np.asarray(ref_qmc.normal_qmc_samples(n, dim, ref_key, skip))
    got = port_core.normal_qmc_samples(n, dim, key, skip, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (n, dim) and np.isfinite(got).all()
    ulps = _ulps(got, want)
    share = float((ulps > 0).mean())
    print(f"normal_qmc_samples {n}x{dim} key={seed} skip={skip}: {share:.4f} of points "
          f"differ, by at most {ulps.max()} ulps")
    assert ulps.max() <= max_ulps and share <= max_share, (ulps.max(), share)
    # the cause: with XLA's float32 log polynomial in Φ⁻¹, bitwise the reference's
    real = qmc._log
    qmc._log = numerics.log
    try:
        same = port_core.normal_qmc_samples(n, dim, key, skip, device="cpu").numpy()
    finally:
        qmc._log = real
    np.testing.assert_array_equal(same, want)
    if seed is not None:  # the digital shift itself, bitwise
        ref_pts = np.asarray(ref_qmc.digital_shift(ref_key, ref_qmc.sobol_uint32(n, dim, skip)))
        pts = qmc.digital_shift(key, qmc.sobol_uint32(n, dim, skip)).numpy()
        np.testing.assert_array_equal(pts, ref_pts.astype(np.int64))


def test_discrepancy_proxy_matches_the_reference():
    rng = np.random.default_rng(4)
    for pts in (np.asarray(ref_qmc.sobol_sequence(256, 4)), rng.uniform(size=(200, 7)),
                rng.uniform(size=(50, 1))):
        want = ref_qmc.discrepancy_proxy(pts)
        assert abs(qmc.discrepancy_proxy(pts) - want) <= 1e-12
        assert abs(qmc.discrepancy_proxy(torch.from_numpy(pts)) - want) <= 1e-12
    sobol = port_core.sobol_sequence(256, 4, device="cpu")
    assert port_core.discrepancy_proxy(sobol) < 0.3 * qmc.discrepancy_proxy(
        rng.uniform(size=(256, 4)))


def test_qmc_grids_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (port_core.sobol_sequence, port_core.normal_qmc_samples):
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            fn(8, 2)
        assert fn(8, 2, device="cpu").device.type == "cpu"


# --------------------------------------------------------------- tree models
@pytest.fixture(scope="module")
def classification_data():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(600, 6)).astype(np.float32)
    y = ((x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * rng.normal(size=600)) > 0).astype(np.float32)
    return x[:400], y[:400], x[400:]


@pytest.mark.parametrize("kind", ["rf", "gbm"])
def test_tree_classifiers_predict_proba_match_the_reference(kind, classification_data):
    x, y, x_test = classification_data
    ref = (RefRF(n_trees=12, max_depth=5, task="classification", seed=1) if kind == "rf"
           else RefGBM(n_trees=15, max_depth=4, task="classification", seed=1)).fit(x, y)
    model = model_from_numpy(model_to_numpy(ref))
    want = np.asarray(ref.predict_proba(jnp.asarray(x_test)))
    for use_kernel in (True, False):   # the kernel's plain version on the CPU either way
        got = model.predict_proba(torch.from_numpy(x_test), use_kernel=use_kernel).numpy()
        assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6
    assert (want > 0).any() and (want < 1).any()
    assert ((got >= 0) & (got <= 1)).all()
    # the probabilities and the class labels agree
    labels = model.predict(torch.from_numpy(x_test)).numpy()
    np.testing.assert_array_equal(labels, (got > 0.5).astype(np.int32))


# ----------------------------------------------------------- sampled_agg ops
def _moments_case():
    rng = np.random.default_rng(9)
    k = 3000
    count = rng.integers(0, 80, k).astype(np.float32)
    count[:6] = [0, 1, 0, 1, 2, 5]
    samples = [rng.normal(rng.uniform(-5, 5), rng.uniform(0.1, 3), int(c)) for c in count]
    m = np.stack([count, [s.sum() for s in samples], [(s * s).sum() for s in samples],
                  [(s ** 3).sum() for s in samples]], axis=1).astype(np.float32)
    n = (count + rng.integers(0, 50, k)).astype(np.int32)
    n[2:5] = count[2:5].astype(np.int32)            # whole groups: n == count (0, 1, 2)
    n[50:80] = count[50:80].astype(np.int32)
    return m, n


def test_estimates_from_moments_match_the_reference():
    """Within 1e-6 of the reference's function as XLA compiles it, which
    contracts its ``m₂/count − mean²`` into one FMA, as the port computes it:
    the mean and the variance bitwise.  (Run op by op, the reference rounds
    that difference twice; where the two nearly cancel, as at a count of 1,
    the standard error, its square root, then differs at ~1e-4.)"""
    m, n = _moments_case()
    got = ops.estimates_from_moments(torch.from_numpy(m), torch.from_numpy(n))
    want = jax.jit(ref_ops.estimates_from_moments)(jnp.asarray(m), jnp.asarray(n))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-6 * max(1.0, np.abs(w).max())
    for g, w in zip(got[:2], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(g.dtype == torch.float32 for g in got)
    mean, var, se = (t.numpy() for t in got)
    assert mean[0] == 0 and var[0] == 0 and se[0] == 0                 # no sample
    assert abs(var[1]) <= 1e-6 * m[1, 2]                 # one sample: rounding alone
    whole = n == m[:, 0]
    assert (se[whole] == 0).all()                                      # no sampling error
    assert "estimates_from_moments" in ops.__all__


# ------------------------------------------------------- pipeline and planner
@pytest.mark.parametrize("name", PIPELINE_NAMES)
def test_n_features_of_every_pipeline(name):
    tiny = dict(TINY, n_train_groups=40)
    want = ref_make_pipeline(name, **tiny).pipeline
    got = port_make_pipeline(name, **tiny, device="cpu").pipeline
    assert got.n_features == want.n_features == len(got.agg_features) + len(got.exact_features)
    assert got.k == want.k


def test_plan_state_is_the_references_named_tuple():
    assert planner.PlanState._fields == ref_planner.PlanState._fields == ("z", "n")
    assert "PlanState" in planner.__all__
    z, n = torch.tensor([2, 3], dtype=torch.int32), torch.tensor([10, 12], dtype=torch.int32)
    state = planner.PlanState(z, n)
    assert state.z is z and state.n is n and tuple(state) == (z, n)
    assert torch.equal(planner.next_plan(state.z, torch.tensor([0, 1], dtype=torch.int32),
                                         torch.tensor(4, dtype=torch.int32), state.n),
                       torch.tensor([2, 7], dtype=torch.int32))
