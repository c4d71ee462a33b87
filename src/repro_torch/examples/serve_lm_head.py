"""Biathlon on an LM pipeline, in PyTorch: the port of ``examples/serve_lm_head.py``.

Scenario: a click-through scorer.  The request's prompt runs ONCE through
a qwen1.5-0.5b backbone (random weights from a seeded ``torch.Generator``)
whose last hidden state is mean-pooled; three user-history aggregates over
a large event log — ``avg(engage)``, ``avg(dwell)`` and ``count(click)`` —
are approximated by the fused Biathlon executor and feed a small MLP head
together with the pooled state.  Uncertainty propagates through the head
only (m QMC evaluations of the MLP), the pooled state riding along as the
executor's ``exact`` input.

The event log (40 users × 50 000 events), the store, the population scaler,
the head's training data and the requests are drawn from
``np.random.default_rng(0)`` in the reference's order, so the port builds
the reference's scenario.  On the card the backbone's attention runs the
``flash_attention`` kernel (one launch per layer per request) and the
executor its AFC and Sobol kernels.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm_head [--device cpu]
"""
from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.executor_fused import build_fused_executor
from repro_torch.data.store import ColumnStore, bucket_size, build_table
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.models.tabular import MLP

__all__ = ["AGG_IDS", "COLUMNS", "LMHeadScenario", "build", "draw_requests", "make_executor",
           "pooled_state", "serve"]

f32 = torch.float32
AGG_IDS = (0, 0, 2)  # avg(engage), avg(dwell), count(click)
COLUMNS = ("engage", "dwell", "click")
ATTN_BLOCK = 64
PROMPT_LEN = 48
LM_SEED = 0  # the backbone's random weights


@dataclass
class LMHeadScenario:
    cfg: ModelConfig
    device: torch.device
    store: ColumnStore
    params: dict               # the backbone's parameters
    head: MLP
    agg_mean: torch.Tensor     # (k,) population scaler of the aggregates
    agg_std: torch.Tensor
    rng: np.random.Generator   # the scenario's stream, positioned at the requests
    n_users: int
    n_events: int


def build(cfg: ModelConfig, device=None, *, n_users: int = 40,
          n_events: int = 50000) -> LMHeadScenario:
    """The event store, the backbone (random weights), the scaler and the fitted head."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    G, R = n_users, n_events
    gid = np.repeat(np.arange(G), R)
    engage = rng.normal(rng.normal(0, 1, G)[gid], 1.0)
    dwell = np.abs(rng.normal(3.0, 1.0, G)[gid] + rng.normal(0, 0.5, G * R))
    clicked = (rng.random(G * R) < rng.uniform(0.05, 0.4, G)[gid]).astype(np.float32)
    store = ColumnStore().add(
        "events", build_table({"engage": engage, "dwell": dwell, "click": clicked}, gid)
    )
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(LM_SEED))

    # feature scaler from population statistics: the head takes standardized aggregates
    events = store["events"]
    pop = np.stack(
        [[events.full_values(c, g).mean() if c != "click" else events.full_values(c, g).sum()
          for g in range(G)] for c in COLUMNS],
        axis=1,
    )  # (G, k)

    # head: MLP over [backbone_state; scaled agg features]
    d, k = cfg.d_model, len(AGG_IDS)
    head = MLP(hidden=(32,), task="regression", epochs=10, seed=1, device=dev)
    Xh = np.concatenate(
        [rng.normal(0, 0.05, (2000, d)), rng.normal(0, 1, (2000, k))], axis=1
    ).astype(np.float32)
    yh = 2.0 * Xh[:, d] - 0.5 * Xh[:, d + 1] + Xh[:, d + 2] + 0.05 * Xh[:, :8].sum(1)
    head.fit(Xh, yh)
    return LMHeadScenario(
        cfg=cfg, device=dev, store=store, params=params, head=head,
        agg_mean=torch.tensor(pop.mean(0), dtype=f32, device=dev),
        agg_std=torch.tensor(np.maximum(pop.std(0), 1e-6), dtype=f32, device=dev),
        rng=rng, n_users=G, n_events=R,
    )


def draw_requests(sc: LMHeadScenario, n: int = 6) -> list:
    """``n`` requests ``(user, tokens (1, PROMPT_LEN))`` from the scenario's stream."""
    out = []
    for _ in range(n):
        user = int(sc.rng.integers(0, sc.n_users))
        out.append((user, sc.rng.integers(0, sc.cfg.vocab, (1, PROMPT_LEN))))
    return out


@torch.no_grad()
def pooled_state(sc: LMHeadScenario, tokens, *, use_kernel: bool = True) -> torch.Tensor:
    """(d,) float32 mean of the backbone's last hidden state over the prompt."""
    lm = LM(sc.cfg, attn_block=ATTN_BLOCK, use_kernel=use_kernel)
    x = lm.embed(sc.params, torch.as_tensor(tokens, dtype=torch.int64, device=sc.device))
    h = lm._backbone(sc.params, x)
    # the reference's bf16 mean: summed in float32, rounded to the model's type
    return h.to(f32).mean(dim=1).to(h.dtype).to(f32)[0]


def make_executor(sc: LMHeadScenario, *, m: int = 400, m_sobol: int = 96,
                  use_kernel: bool = True):
    """The fused executor over the head, as the reference builds it."""
    d = sc.cfg.d_model

    def model_fn(agg_rows, backbone_vec):
        scaled = (agg_rows - sc.agg_mean[None, :]) / sc.agg_std[None, :]
        full = torch.cat([backbone_vec.expand(agg_rows.shape[0], d), scaled], dim=1)
        return sc.head.predict(full)

    return build_fused_executor(model_fn, k=len(AGG_IDS), task="regression", m=m,
                                m_sobol=m_sobol, tau=0.95, device=sc.device,
                                use_kernel=use_kernel)


@torch.no_grad()
def serve(sc: LMHeadScenario, executor, requests, *, delta: float = 0.25,
          use_kernel: bool = True, states=None) -> list[dict]:
    """Serve ``requests``; per request its pooled state, result and latency.

    ``states`` feeds given pooled states to the executor instead of running
    the backbone (to hold two executors to one input).
    """
    agg_ids = torch.tensor(AGG_IDS, dtype=torch.int32, device=sc.device)
    cap = bucket_size(sc.n_events)  # 65536 at 50 000 events, the reference's cap
    outs = []
    for i, (user, tokens) in enumerate(requests):
        t0 = time.perf_counter()
        state = (pooled_state(sc, tokens, use_kernel=use_kernel) if states is None
                 else states[i])
        bufs, n = sc.store.request_buffers([("events", c, user) for c in COLUMNS], cap,
                                           sc.device)
        res = executor(bufs, n, agg_ids, delta, state)
        y_hat, prob = float(res.y_hat), float(res.prob)
        latency = time.perf_counter() - t0
        used = int(res.samples_used)
        outs.append(dict(user=user, state=state, y_hat=y_hat, prob=prob, iters=res.iters,
                         z=res.z.cpu().numpy(), samples_used=used,
                         frac=used / float(n.sum()), latency=latency))
    return outs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sc = build(get_config("qwen1.5-0.5b").reduced(), args.device)
    executor = make_executor(sc)
    print("serving 6 requests (backbone runs once; Biathlon approximates the "
          "history aggregates feeding the head):")
    outs = serve(sc, executor, draw_requests(sc, 6))
    for o in outs:
        print(f"  user {o['user']:>3}: score={o['y_hat']:7.3f} prob={o['prob']:.3f} "
              f"iters={o['iters']} frac={o['frac']:.3f} t={o['latency'] * 1e3:.1f}ms")
    print(f"p50 {statistics.median(o['latency'] for o in outs) * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
