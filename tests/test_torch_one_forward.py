"""The LM's one forward, on the CPU: with no sharding rules active,
``train_loss``, the cached ``prefill`` and ``decode_step`` run the mesh form
of the forward as its one-shard case.

For each of the ten configs at ``.reduced()`` size (their own bf16), the aten
operators that one call dispatches, counted under a ``TorchDispatchMode``,
are no more than those of the forward's earlier unsharded copy, pinned
below, plus those that two later numerics repairs add (``ADDED``), and no
collective is called (``collectives.STATS`` records nothing,
and its counter is never reached).  The setting: ``LM(cfg, attn_block=64,
loss_chunk=16)`` on ``init``'s weights from seed 0, B = 2, S = 32 tokens
(the VLM's 8 frontend positions before them, the audio decoder over 8
frames); ``train_loss`` with every floating-point leaf requiring its
gradient (so ``remat`` recomputes at its sites), the forward only; the
first ``decode_step`` after the prefill.
"""
from __future__ import annotations

import collections
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.lm import LM, collectives

B, S = 2, 32
ENTRIES = ("train_loss", "prefill", "decode_step")

# (train_loss, prefill, decode_step) operators of the forward before it was
# merged into one body (the unsharded copies of model.py and cache.py),
# counted in this setting at commit 5c40f32 with this file's counter.
EARLIER = {
    "deepseek-v2-236b": (1139, 1102, 1194),
    "granite-moe-1b-a400m": (1101, 1069, 1007),
    "qwen3-14b": (789, 757, 703),
    "qwen1.5-0.5b": (733, 701, 647),
    "gemma-7b": (709, 677, 623),
    "qwen3-8b": (789, 757, 703),
    "xlstm-1.3b": (1800, 1622, 449),
    "zamba2-2.7b": (1085, 1065, 753),
    "internvl2-1b": (739, 706, 647),
    "seamless-m4t-large-v2": (1371, 1358, 891),
}


# (train_loss, prefill, decode_step) operators added since: each RMS norm's
# scale is ``numerics.rsqrt``, a reciprocal and a root where ``torch.rsqrt``
# was one operator (every config), and xlstm's mLSTM gate products are
# ``ssm._gate_product``'s four partial products (a copy, views, four
# products, three adds) where ``x @ w`` was one, except at one row.
# Counted as this tree's operators less those at commit f5aecbc.
ADDED = {
    "deepseek-v2-236b": (22, 17, 17),
    "granite-moe-1b-a400m": (10, 9, 9),
    "qwen3-14b": (18, 17, 17),
    "qwen1.5-0.5b": (10, 9, 9),
    "gemma-7b": (10, 9, 9),
    "qwen3-8b": (18, 17, 17),
    "xlstm-1.3b": (120, 117, 81),
    "zamba2-2.7b": (18, 13, 13),
    "internvl2-1b": (10, 9, 9),
    "seamless-m4t-large-v2": (20, 18, 13),
}


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@functools.cache
def _counts(arch: str) -> dict:
    """entry -> (operators, collective calls, STATS after the call)."""
    cfg = get_config(arch).reduced()
    lm = LM(cfg, attn_block=64, loss_chunk=16)
    g = torch.Generator().manual_seed(0)
    params = lm.init(g)
    tokens = torch.randint(0, cfg.vocab, (B, S + 2), generator=g)
    fe = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model), generator=g) if cfg.frontend else None
    batch = {"tokens": tokens[:, :S + 1], **({"frontend": fe} if fe is not None else {})}
    prompt, step = tokens[:, :S], tokens[:, S:S + 1]
    leaves = [t for t in _leaves(params) if t.is_floating_point()]
    calls = collections.Counter()
    real = collectives._count

    def spy(kind, t, group):
        calls[kind] += 1
        return real(kind, t, group)

    out = {}
    collectives._count = spy
    try:
        for entry in ENTRIES:
            collectives.reset_stats()
            calls.clear()
            with _OpCount() as c:
                if entry == "train_loss":
                    for t in leaves:
                        t.requires_grad_(True)
                    lm.train_loss(params, batch)
                    for t in leaves:
                        t.requires_grad_(False)
                elif entry == "prefill":
                    with torch.no_grad():
                        _, cache = lm.prefill(params, prompt, fe)
                else:
                    with torch.no_grad():
                        lm.decode_step(params, cache, step)
            out[entry] = (c.n, sum(calls.values()), collectives.STATS.as_dict())
    finally:
        collectives._count = real
        collectives.reset_stats()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_shard_forward_issues_no_more_operators(arch, entry):
    n, calls, stats = _counts(arch)[entry]
    i = ENTRIES.index(entry)
    assert n <= EARLIER[arch][i] + ADDED[arch][i], (arch, entry, n)
    assert calls == 0, (arch, entry, calls)
    assert stats == {"per_op_bytes": {}, "per_op_count": {}, "link_bytes": 0.0}
