#!/usr/bin/env python3
"""Hold one checkout's LM forward against another's, on the CPU.

    PYTHONPATH=src python3 lm_forward_ab.py dump OUT.pt
    PYTHONPATH=OTHER/src python3 lm_forward_ab.py dump OTHER.pt
    python3 lm_forward_ab.py compare OTHER.pt OUT.pt

``dump`` runs the ten configs of ``repro_torch.configs`` at ``.reduced()``
size, in float32 and in bfloat16, with no sharding rules: ``train_loss``
(``remat=True``, two loss chunks) and the gradient of every floating-point
leaf, a cached ``prefill`` of B = 2, S = 32 (the VLM's 8 frontend positions
before them, the audio decoder over 8 frames) and its every cache leaf, then
4 teacher-forced ``decode_step`` calls and the cache after them; zamba2 also
at S = 96, where its window of 64 binds.  The weights are ``LM.init``'s from
seed 0 with the leaves that ``init`` leaves at 0 or 1 (norms, biases, the
SSM cells' gates and decays) moved by seeded noise.  It also counts the aten
operators of each call under a ``TorchDispatchMode``.  ``compare`` prints,
for every config and entry point, whether the two dumps agree bitwise, else
the largest gap, and the two operator counts; it exits 1 where a result
differs in shape or NaN pattern.

    PYTHONPATH=src python3 lm_forward_ab.py decode-launches ARCH [REPEATS]

on a card: ARCH at full width (bf16, seeded weights), a 1 × 1024 prefill,
then REPEATS (default 3) B = 1 decode steps, each under ``torch.profiler``
after a warm-up step; prints a JSON line a step with the host's kernel
launch and copy calls by API (``chip_smoke.LAUNCH_CALLS``), the device's
kernel and copy rows (rows with device time and no host time, as
``chip_smoke.decode_profile`` counts them) and their counts by name, and
the host's aten operators.  The prefill's
attention takes the plain path (``use_kernel=False``): a decode step runs
none of the port's kernels, so nothing is built.

    PYTHONPATH=src python3 lm_forward_ab.py prefill-launches ARCH

on a card: the same count for one 2 × 1024 cached prefill of ARCH at full
width (bf16, seeded weights, the kernels built first), after a warm-up one.

    PYTHONPATH=src python3 lm_forward_ab.py walls [ARCH ...]

on a card: phase 15's and 16's timings (``chip_smoke.lm_timings`` for
qwen3-8b and granite-moe-1b-a400m, ``chip_smoke.family_timings`` for
zamba2-2.7b at 2 × 1024, seamless-m4t-large-v2 at 2 × 256 and xlstm-1.3b at
2 × 1024), the kernels built first, one model on the card at a time (only
the ARCHs named, if any); run it with each checkout's ``src`` in turns to
compare two trees on one card.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

S, N_DECODE, B = 32, 4, 2
NOISY = {"ln", "ln1", "ln2", "ln_x", "final_norm", "enc_norm", "q_norm", "k_norm", "kv_norm",
         "out_norm", "bq", "bk", "bv", "conv_b", "d_skip", "b_i", "b_f", "b"}
NARROW = {"dt_bias", "a_log"}  # Mamba2's decay: wide noise overflows a chunk's exp


class OpCount(TorchDispatchMode):
    """Counts the aten operators dispatched while active, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, (*path, i))
    else:
        yield path, tree


def params_for(lm, seed: int = 0) -> dict:
    """``lm.init``'s weights from ``seed``, the flat leaves moved by noise."""
    g = torch.Generator().manual_seed(seed)
    params = lm.init(g)
    for path, leaf in _walk(params):
        if path[-1] in NOISY or path[-1] in NARROW:
            spread = 0.1 if path[-1] in NARROW else 0.3
            noise = torch.randn(leaf.shape, generator=g) * spread
            leaf.copy_((leaf.float() + noise).to(leaf.dtype))
    return params


def inputs(cfg, s: int, seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, s + 1 + N_DECODE), generator=g)
    fe = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model), generator=g) if cfg.frontend else None
    return tokens, fe


def run(arch: str, dtype: str, s: int = S) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    lm = LM(cfg, attn_block=64, loss_chunk=16)
    params = params_for(lm)
    tokens, fe = inputs(cfg, s)
    out: dict = {"ops": {}}
    leaves = [(p, t) for p, t in _walk(params) if t.is_floating_point()]
    for _, t in leaves:
        t.requires_grad_(True)
    batch = {"tokens": tokens[:, :s + 1]}
    if fe is not None:
        batch["frontend"] = fe
    with OpCount() as c:
        loss, metrics = lm.train_loss(params, batch)
    out["ops"]["train_loss"] = c.ops
    grads = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True)
    out["train_loss"] = {"loss": loss.detach(), "acc": metrics["acc"]}
    out["grads"] = {"/".join(map(str, p)): (g if g is None else g.detach())
                    for (p, _), g in zip(leaves, grads)}
    for _, t in leaves:
        t.requires_grad_(False)
    prompt = tokens[:, :s]
    with torch.no_grad():
        with OpCount() as c:
            logits, cache = lm.prefill(params, prompt, fe)
        out["ops"]["prefill"] = c.ops
        out["prefill"] = {"logits": logits, **{f"cache/{k}": v.clone() for k, v in cache.items()
                                               if k != "pos"}}
        out["prefill"]["pos"] = torch.tensor(cache["pos"])
        steps = {}
        for i in range(N_DECODE):
            tok = tokens[:, s + i:s + i + 1]
            with OpCount() as c:
                logits, cache = lm.decode_step(params, cache, tok)
            if i == 0:
                out["ops"]["decode_step"] = c.ops
            steps[f"logits{i}"] = logits
        out["decode"] = {**steps, **{f"cache/{k}": v for k, v in cache.items() if k != "pos"}}
        out["decode"]["pos"] = torch.tensor(cache["pos"])
    return out


def dump(path: str) -> None:
    from repro_torch.configs import ARCH_IDS

    torch.manual_seed(0)
    torch.set_num_threads(1)
    res = {}
    for dtype in ("float32", "bfloat16"):
        for arch in ARCH_IDS:
            res[f"{arch}/{dtype}"] = run(arch, dtype)
            print(f"dumped {arch} {dtype}", flush=True)
        res[f"zamba2-2.7b/{dtype}/S96"] = run("zamba2-2.7b", dtype, 96)
    torch.save(res, path)


def _gap(a, b) -> tuple[str, float]:
    if a is None or b is None:
        return ("same" if a is None and b is None else "one None"), 0.0
    if a.shape != b.shape or a.dtype != b.dtype:
        return f"shape/type {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}", float("inf")
    if torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                             and torch.equal(a.nan_to_num(), b.nan_to_num())):
        return "bitwise", 0.0
    if a.is_floating_point() and not torch.equal(a.isnan(), b.isnan()):
        return "NaN pattern differs", float("inf")
    d = (a.double() - b.double()).abs().nan_to_num().max().item()
    return "differs", d


def compare(path_a: str, path_b: str) -> int:
    a, b = torch.load(path_a), torch.load(path_b)
    bad = 0
    for case in a:
        for part in ("train_loss", "grads", "prefill", "decode"):
            worst, kinds = 0.0, collections.Counter()
            for name, x in a[case][part].items():
                kind, d = _gap(x, b[case][part][name])
                kinds[kind] += 1
                worst = max(worst, d)
                if d == float("inf"):
                    bad += 1
                    print(f"  {case} {part} {name}: {kind}")
            print(f"{case:32s} {part:10s} {dict(kinds)} max gap {worst:.3e}")
        for entry, ops in a[case]["ops"].items():
            n_a, n_b = sum(ops.values()), sum(b[case]["ops"][entry].values())
            extra = {k: v - ops.get(k, 0) for k, v in b[case]["ops"][entry].items()
                     if v > ops.get(k, 0)}
            more = f" more: {extra}" if extra else ""
            print(f"{case:32s} ops {entry:12s} {n_a} -> {n_b}{more}")
    return 1 if bad else 0


def _profiled_launches(fn) -> dict:
    """The kernel launch and copy calls of one ``fn()`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    device = {e.key: e.count for e in rows
              if e.self_cpu_time_total == 0.0 and e.self_device_time_total > 0.0}
    host = {e.key: e.count for e in rows if e.key.startswith(chip_smoke.LAUNCH_CALLS)}
    aten = sum(e.count for e in rows if e.key.startswith("aten::")
               and e.self_cpu_time_total > 0.0)
    return {"device_rows": sum(device.values()), "host_calls": host, "host_operators": aten,
            "device_by_name": device}


def _card() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def decode_launches(arch: str, repeats: int = 3) -> None:
    import json

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    if not torch.cuda.is_available():
        sys.exit("decode-launches needs a card")
    card = _card()
    dev = torch.device("cuda")
    cfg = get_config(arch)
    lm = LM(cfg, use_kernel=False)
    g = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(g)
    tokens = torch.randint(0, cfg.vocab, (1, 1024 + repeats + 1), device=dev, generator=g)
    with torch.no_grad():
        _, cache = lm.prefill(params, tokens[:, :1024], max_seq=1024 + 64)
        lm.decode_step(params, cache, tokens[:, 1024:1025])
        for i in range(repeats):
            tok = tokens[:, 1025 + i:1026 + i]
            rec = _profiled_launches(lambda: lm.decode_step(params, cache, tok))
            print(json.dumps({"arch": arch, "step": i, **rec, "card": card}), flush=True)


def prefill_launches(arch: str) -> None:
    import json

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.lm import LM

    if not torch.cuda.is_available():
        sys.exit("prefill-launches needs a card")
    card = _card()
    build.build_all()
    dev = torch.device("cuda")
    cfg = get_config(arch)
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    tokens, _, fe = chip_smoke.family_inputs(cfg, dev, 2, 1024, seed=11)
    with torch.no_grad():
        lm.prefill(params, tokens, fe)
        rec = _profiled_launches(lambda: lm.prefill(params, tokens, fe))
    print(json.dumps({"arch": arch, "prefill": [2, 1024], **rec, "card": card}), flush=True)


def walls(archs=()) -> None:
    import gc

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.lm import LM

    if not torch.cuda.is_available():
        sys.exit("walls needs a card")
    card = _card()
    build.build_all()
    dev = torch.device("cuda")
    cases = [("qwen3-8b", None), ("granite-moe-1b-a400m", None), ("zamba2-2.7b", 1024),
             ("seamless-m4t-large-v2", 256), ("xlstm-1.3b", 1024)]
    with torch.no_grad():
        for arch, s in cases:
            if archs and arch not in archs:
                continue
            cfg = get_config(arch)
            params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
            if s is None:
                chip_smoke.lm_timings(cfg, params, card)
            else:
                tokens, _, fe = chip_smoke.family_inputs(cfg, dev, 2, s, seed=11)
                LM(cfg).prefill(params, tokens, fe)  # warm-up, as phase 16's case runs before
                chip_smoke.family_timings(cfg, params, s, card)
            del params
            gc.collect()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))  # chip_smoke, beside this script
    if len(sys.argv) == 3 and sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    elif len(sys.argv) >= 2 and sys.argv[1] == "walls":
        walls(sys.argv[2:])
    elif len(sys.argv) == 3 and sys.argv[1] == "prefill-launches":
        prefill_launches(sys.argv[2])
    elif len(sys.argv) in (3, 4) and sys.argv[1] == "decode-launches":
        decode_launches(sys.argv[2], *map(int, sys.argv[3:]))
    else:
        sys.exit(__doc__)
