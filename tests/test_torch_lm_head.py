"""The LM-head pipeline of the port against the JAX reference, on the CPU.

* The MLP head: its initial weights bit-equal to the reference's (the port
  draws them with its JAX-exact threefry); one and two AdamW steps within
  1e-6; ``fit`` over the example's 10 epochs within 1e-5 on every weight
  and prediction (a run measured 1.1e-6 and 4.8e-7: autograd and XLA
  round the gradients differently, and Adam carries that through 30
  steps).
* The scenario of ``examples/serve_lm_head.py`` at reduced size (the
  reduced ``qwen1.5-0.5b``, 4 users of 2000 events, m = 128, m_sobol = 32):
  the JAX side is the reference example's code at that size.  The port's
  ``build`` must draw the same store, scaler, head data and requests from
  the shared numpy stream; its backbone, given the reference's weights,
  must give the reference's pooled states within bf16's 3e-2 (as in
  ``test_torch_lm.py``).  Fed the same pooled state and the same head
  weights, the port's executor must give the reference's z-plans and
  iteration counts, and y_hat and prob within 1e-4, at the example's
  δ = 0.25 and at a tight δ where the planner loop runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.executor_fused import build_fused_executor as ref_build_fused_executor
from repro.data.store import ColumnStore as RefColumnStore
from repro.data.store import build_table as ref_build_table
from repro.models.lm import LM as RefLM
from repro.models.tabular.mlp import MLP as RefMLP
from repro.models.tabular.mlp import _init_params as ref_init_params
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro_torch.bridge import lm_params_from_numpy, mlp_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import threefry
from repro_torch.data.store import bucket_size
from repro_torch.examples.serve_lm_head import (
    AGG_IDS,
    COLUMNS,
    build,
    draw_requests,
    make_executor,
    pooled_state,
    serve,
)
from repro_torch.models.tabular.mlp import MLP, _init_params
from repro_torch.optim.adamw import adamw_init, adamw_update

CPU = torch.device("cpu")
N_USERS, N_EVENTS, N_REQ = 4, 2000, 4
QMC = dict(m=128, m_sobol=32)
FIT_TOL = 1e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_mlp_init_is_bit_equal_to_reference():
    sizes = (131, 32, 1)
    want = ref_init_params(jax.random.PRNGKey(1), sizes)
    got = _init_params(threefry.PRNGKey(1), sizes, CPU)
    for a, b in zip(want, got):
        for n in ("w", "b"):
            assert b[n].dtype == torch.float32
            np.testing.assert_array_equal(b[n].numpy(), np.asarray(a[n]))


def test_adamw_steps_match_reference():
    rng = np.random.default_rng(0)
    params = [{"w": rng.normal(0, 1, (7, 5)).astype(np.float32),
               "b": rng.normal(0, 1, (5,)).astype(np.float32)}]
    grads = [[{n: rng.normal(0, 0.1, a.shape).astype(np.float32) for n, a in params[0].items()}]
             for _ in range(2)]
    to_t = lambda tree: [{n: torch.from_numpy(a) for n, a in d.items()} for d in tree]  # noqa: E731
    rp, ro = jax.tree.map(jnp.asarray, params), ref_adamw_init(jax.tree.map(jnp.asarray, params))
    pp, po = to_t(params), adamw_init(to_t(params))
    for g in grads:
        rp, ro = ref_adamw_update(jax.tree.map(jnp.asarray, g), ro, rp, 3e-3, weight_decay=1e-4)
        pp, po = adamw_update(to_t(g), po, pp, 3e-3, weight_decay=1e-4)
        assert int(po.step) == int(ro.step)
        for want, got in ((rp, pp), (ro.mu, po.mu), (ro.nu, po.nu)):
            for n in ("w", "b"):
                np.testing.assert_allclose(got[0][n].numpy(), np.asarray(want[0][n]),
                                           rtol=1e-6, atol=1e-6)


def _head_data(rng, d, k=3):
    """The example's head training data."""
    Xh = np.concatenate(
        [rng.normal(0, 0.05, (2000, d)), rng.normal(0, 1, (2000, k))], axis=1
    ).astype(np.float32)
    yh = 2.0 * Xh[:, d] - 0.5 * Xh[:, d + 1] + Xh[:, d + 2] + 0.05 * Xh[:, :8].sum(1)
    return Xh, yh


def test_mlp_fit_matches_reference():
    Xh, yh = _head_data(np.random.default_rng(5), 128)
    ref = RefMLP(hidden=(32,), task="regression", epochs=10, seed=1).fit(Xh, yh)
    port = MLP(hidden=(32,), task="regression", epochs=10, seed=1, device="cpu").fit(Xh, yh)
    for a, b in zip(ref.params, port.params):
        for n in ("w", "b"):
            np.testing.assert_allclose(b[n].numpy(), np.asarray(a[n]), rtol=0, atol=FIT_TOL)
    np.testing.assert_allclose(port.predict(torch.from_numpy(Xh)).numpy(),
                               np.asarray(ref.predict(jnp.asarray(Xh))), rtol=0, atol=FIT_TOL)


def _reference_scenario(G, R):
    """``examples/serve_lm_head.py``'s set-up at G users × R events."""
    rng = np.random.default_rng(0)
    gid = np.repeat(np.arange(G), R)
    engage = rng.normal(rng.normal(0, 1, G)[gid], 1.0)
    dwell = np.abs(rng.normal(3.0, 1.0, G)[gid] + rng.normal(0, 0.5, G * R))
    clicked = (rng.random(G * R) < rng.uniform(0.05, 0.4, G)[gid]).astype(np.float32)
    store = RefColumnStore().add(
        "events", ref_build_table({"engage": engage, "dwell": dwell, "click": clicked}, gid)
    )
    cfg = ref_get_config("qwen1.5-0.5b").reduced()
    lm = RefLM(cfg, remat=False, attn_block=64, loss_chunk=32)
    params = lm.init(jax.random.PRNGKey(0))

    @jax.jit
    def pooled(tokens):
        x = params["embed"][jnp.clip(tokens, 0, lm.vp - 1)].astype(lm.dtype)
        return lm._backbone(params, x).mean(axis=1).astype(jnp.float32)

    pop = np.stack(
        [[store["events"].full_values(c, g).mean() if c != "click"
          else store["events"].full_values(c, g).sum() for g in range(G)] for c in COLUMNS],
        axis=1,
    )
    agg_mean = jnp.asarray(pop.mean(0), jnp.float32)
    agg_std = jnp.asarray(np.maximum(pop.std(0), 1e-6), jnp.float32)
    d = cfg.d_model
    head = RefMLP(hidden=(32,), task="regression", epochs=10, seed=1)
    head.fit(*_head_data(rng, d))

    def model_fn(agg_rows, backbone_vec):
        m = agg_rows.shape[0]
        scaled = (agg_rows - agg_mean[None, :]) / agg_std[None, :]
        full = jnp.concatenate([jnp.broadcast_to(backbone_vec[None, :], (m, d)), scaled], 1)
        return head.predict(full)

    fused = ref_build_fused_executor(model_fn, k=3, task="regression", tau=0.95, **QMC)
    requests = []
    for _ in range(N_REQ):
        user = int(rng.integers(0, G))
        requests.append((user, rng.integers(0, cfg.vocab, (1, 48))))
    return dict(store=store, params=params, pooled=pooled, pop=pop, head=head, fused=fused,
                requests=requests, agg_mean=agg_mean, agg_std=agg_std)


@pytest.fixture(scope="module")
def scenarios():
    ref = _reference_scenario(N_USERS, N_EVENTS)
    port = build(get_config("qwen1.5-0.5b").reduced(), "cpu", n_users=N_USERS,
                 n_events=N_EVENTS)
    return ref, port, draw_requests(port, N_REQ)


def test_build_draws_the_reference_scenario(scenarios):
    ref, port, requests = scenarios
    rt, pt = ref["store"]["events"], port.store["events"]
    assert (np.asarray(rt.perm) == pt.perm).all()
    for c in COLUMNS:
        assert (rt.columns[c] == pt.columns[c]).all(), c
    np.testing.assert_array_equal(port.agg_mean.numpy(), np.asarray(ref["agg_mean"]))
    np.testing.assert_array_equal(port.agg_std.numpy(), np.asarray(ref["agg_std"]))
    for (ru, rtok), (pu, ptok) in zip(ref["requests"], requests):
        assert ru == pu and (rtok == ptok).all()
    for a, b in zip(ref["head"].params, port.head.params):
        for n in ("w", "b"):
            np.testing.assert_allclose(b[n].numpy(), np.asarray(a[n]), rtol=0, atol=FIT_TOL)


def test_pooled_state_matches_reference(scenarios, monkeypatch):
    ref, port, requests = scenarios
    monkeypatch.setattr(port, "params", lm_params_from_numpy(_np(ref["params"]), torch.bfloat16))
    for _, tokens in requests:
        want = np.asarray(ref["pooled"](jnp.asarray(tokens, jnp.int32))[0])
        got = pooled_state(port, tokens)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 3e-2


@pytest.mark.parametrize("delta", [0.25, 0.01])
def test_executor_plans_match_reference_on_the_same_state(scenarios, delta, monkeypatch):
    ref, port, requests = scenarios
    monkeypatch.setattr(port.head, "params", mlp_params_from_numpy(_np(ref["head"].params)))
    states = [ref["pooled"](jnp.asarray(tokens, jnp.int32))[0] for _, tokens in requests]
    outs = serve(port, make_executor(port, **QMC), requests, delta=delta,
                 states=[torch.from_numpy(np.array(s)) for s in states])
    cap = bucket_size(N_EVENTS)
    agg_ids = jnp.asarray(AGG_IDS, jnp.int32)
    iters = []
    for (user, _), state, got in zip(requests, states, outs):
        bufs, n = ref["store"].request_buffers([("events", c, user) for c in COLUMNS], cap)
        want = ref["fused"](bufs, n, agg_ids, jnp.asarray(delta, jnp.float32), state)
        assert got["iters"] == int(want.iters)
        np.testing.assert_array_equal(got["z"], np.asarray(want.z))
        assert got["samples_used"] == int(want.samples_used)
        assert abs(got["y_hat"] - float(want.y_hat)) <= 1e-4 * max(1.0, abs(got["y_hat"]))
        assert abs(got["prob"] - float(want.prob)) <= 1e-4
        iters.append(got["iters"])
    if delta < 0.25:
        assert max(iters) > 0
