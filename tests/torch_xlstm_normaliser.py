"""Where xlstm's 8-layer float32 group leaves its float64 run on the card:
the mLSTM normaliser's branches.

``chip_smoke.py`` phase 20(a) holds xlstm-1.3b's group of seven mLSTM blocks
and one sLSTM (B = 2, S = 256, weights from seed 40) on meshes (1, 2),
(1, 4) and (1, 8) against the unsharded port, within ``FAM_REORDER_FACTOR``
times the unsharded port's own gap when its weights move one ulp.  This
probe runs the same group unsharded in float64, unsharded in float32 and on
each mesh in float32, and records at every position of every chunk which
branch the mLSTM normaliser ``max(|nᵀq|, e^−m)`` took, and the float64 run's
relative margin between the two there.  For each float32 run it prints the
positions whose branch differs from the float64 run's and the run's largest
gradient leaf distance from the float64 run; then the same run again with
every normaliser held to the float64 run's branch.  Run on a card, from the
repository root::

    PYTHONPATH=src:.:tests python3 tests/torch_xlstm_normaliser.py

``--reduced`` runs the reduced config on the CPU instead (the probe's own
check).
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import sys

import torch

import chip_smoke
from repro_torch.launch.mesh import simulated_devices
from repro_torch.models.lm import LM
from repro_torch.models.lm import ssm as ssm_lib
from repro_torch.models.lm.sharding import gather_params, shard_params, use_rules
from repro_torch.optim.adamw import tree_map
from repro_torch.train import synthetic_batch
from repro_torch.train.step import loss_and_grads
from torch_tp_probes import float64_port

N_HEADS = 4
LINE = "        hden = torch.maximum(den.abs(), torch.exp(-m_i))   # (B,H,Q)\n"


class Normaliser:
    """Stands in for the normaliser: records each call's branch (``|nᵀq| ≥
    e^−m``) and margin, or takes the branches it is given, in call order."""

    def __init__(self, forced=None):
        self.masks, self.margins, self.forced = [], [], forced

    def __call__(self, den, m_i):
        a, e = den.abs(), torch.exp(-m_i)
        self.masks.append((a >= e).detach())
        if self.forced is not None:
            return torch.where(self.forced[len(self.masks) - 1].to(a.device), a, e)
        self.margins.append(((a - e) / torch.maximum(a, e)).detach())
        return torch.maximum(a, e)


@contextlib.contextmanager
def hooked(normaliser):
    """``ssm._mlstm_chunked`` with its normaliser line calling ``normaliser``."""
    real = ssm_lib._mlstm_chunked
    src = inspect.getsource(real)
    assert src.count(LINE) == 1, "the normaliser line moved"
    exec(compile(src.replace(LINE, "        hden = _NORMALISER(den, m_i)\n"),
                 ssm_lib.__file__, "exec"), ssm_lib.__dict__)
    ssm_lib._NORMALISER = normaliser
    try:
        yield normaliser
    finally:
        ssm_lib._mlstm_chunked = real
        del ssm_lib._NORMALISER


def whole(masks: list, tp: int, chunks: int) -> list:
    """A sharded run's masks (layer, shard, chunk order; each shard its
    covering heads) in the unsharded run's layout (layer, chunk; all heads):
    the first shard of each head's."""
    n_layers = len(masks) // (tp * chunks)
    return [torch.cat([masks[(layer * tp + n) * chunks + c]
                       for n in range(0, tp, max(1, tp // N_HEADS))], dim=1)
            for layer in range(n_layers) for c in range(chunks)]


def split(masks: list, tp: int, chunks: int) -> list:
    """The unsharded run's masks in a sharded run's call order."""
    h = max(1, N_HEADS // tp)
    n_layers = len(masks) // chunks
    return [masks[layer * chunks + c][:, (n * N_HEADS // tp):(n * N_HEADS // tp) + h]
            for layer in range(n_layers) for n in range(tp) for c in range(chunks)]


def main(reduced: bool = False) -> None:
    """Phase 20(a)'s case on the card; ``reduced``: the reduced config on the
    CPU (B = 2, S = 64), a check of the probe's bookkeeping."""
    arch, changes, b, s, meshes = chip_smoke.FAM_PROBE["xlstm-1.3b"]
    if reduced:
        dev, card = torch.device("cpu"), "cpu"
        cfg = dataclasses.replace(chip_smoke.family_cfg(arch, {}).reduced(), dtype="float32")
        s = 2 * cfg.ssm.chunk
    else:
        dev, card = torch.device("cuda"), chip_smoke.card_line()
        cfg = chip_smoke.family_cfg(arch, changes, "float32")
    lm = LM(cfg, remat=False, loss_chunk=s)
    params = lm.init(torch.Generator(device=dev).manual_seed(40))
    batch = synthetic_batch(lm, b, s, 40, 0, device=dev)
    chunks = s // cfg.ssm.chunk

    with hooked(Normaliser()) as rec64, float64_port(lm):
        _, _, g = loss_and_grads(lm, tree_map(lambda t: t.double(), params), batch)
    g64 = chip_smoke.tp_leaves(g)
    del g

    def run(tp, placed, forced=None):
        with hooked(Normaliser(forced)) as rec:
            if tp == 1:
                _, _, grads = loss_and_grads(lm, placed, batch)
            else:
                with use_rules(rules):
                    _, _, grads = loss_and_grads(lm, placed, batch)
                grads = gather_params(grads)
        far = chip_smoke.far_from((None, g64), None, chip_smoke.tp_leaves(grads))
        return rec, far

    print(json.dumps({"card": card, "positions": sum(m.numel() for m in rec64.masks),
                      "float64_branch_den": sum(int(m.sum()) for m in rec64.masks),
                      "float64_smallest_margins": sorted(
                          float(x) for x in torch.cat([t.abs().flatten() for t in
                                                       rec64.margins]).topk(5, largest=False)[0]
                      )}), flush=True)
    for name, dims in {"unsharded": (1, 1), **meshes}.items():
        tp = dims[1]
        if tp == 1:
            placed = params
        else:
            rules = chip_smoke.tp_rules(cfg, dims, simulated_devices(tp, dev))
            placed = shard_params(rules, params)
        rec, far = run(tp, placed)
        got = rec.masks if tp == 1 else whole(rec.masks, tp, chunks)
        flips = []
        for i, (m32, m64) in enumerate(zip(got, rec64.masks)):
            for idx in (m32 != m64).nonzero().tolist():
                flips.append(dict(layer=i // chunks, chunk=i % chunks, at=idx,
                                  float64_margin=float(rec64.margins[i][tuple(idx)]),
                                  float64_takes_den=bool(m64[tuple(idx)])))
        forced = rec64.masks if tp == 1 else split(rec64.masks, tp, chunks)
        _, far_forced = run(tp, placed, forced)
        top = sorted(far["leaves"], key=far["leaves"].get, reverse=True)[:3]
        print(json.dumps({"run": name, "branch_flips": len(flips), "flips": flips[:8],
                          "grad_from_float64": far["grads"],
                          "worst_leaves": {p: far["leaves"][p] for p in top},
                          "grad_from_float64_with_float64_branches": far_forced["grads"],
                          "card": card}), flush=True)
        del placed


if __name__ == "__main__":
    main(reduced="--reduced" in sys.argv)
