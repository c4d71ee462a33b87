#!/usr/bin/env python3
"""Time this checkout's bf16 ``flash_attention`` kernel against another build.

    PYTHONPATH=src python3 flash_attention_ab.py OTHER.cu

``OTHER.cu`` is another version of ``src/repro_torch/kernels/csrc/
flash_attention.cu`` with the same C entry point (``flash_attention_launch``
and its arguments), for example the file at a parent commit.  It is built
with the port's nvcc command into ``build/repro_torch/ab-other.so``; both
libraries are called through the wrapper's own launch code
(``flash_attention.launch_with``), so only the loaded library differs.  On
one card both kernels run in turns (other, this, this, other) at (1, 16,
4096, 64) and (1, 16, 4096, 128) causal prefills, the LM-head prompt (1, 16,
48, 64) and (1, 16, 512, 256), beside ``F.scaled_dot_product_attention``,
each held to the plain version with the card tests' bf16 tolerance.  Device
times per call come from CUDA-graph replay (``chip_smoke.time_ms``).  Prints
the card, one line a shape, and a JSON object of every time as the last line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke

ROOT = Path(__file__).resolve().parent


def main(other: Path) -> int:
    if not torch.cuda.is_available():
        print("flash_attention_ab: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    print(chip_smoke.card_line(), flush=True)
    build.build_all()
    so = build.BUILD_DIR / "ab-other.so"
    subprocess.run(build.compile_command(other, so), check=True, capture_output=True)
    other_fn = fa.bind(ctypes.CDLL(str(so)))
    entries = {"other": lambda: other_fn, "this": fa._fn}

    gen = torch.Generator().manual_seed(0)
    results = {}
    for shape in [(1, 16, 4096, 64), (1, 16, 4096, 128), (1, 16, 48, 64), (1, 16, 512, 256)]:
        q, k, v = (torch.randn(shape, generator=gen).to("cuda", torch.bfloat16) for _ in range(3))
        want = flash_attention_ref(q, k, v, causal=True).float()
        reps = 20 if shape[2] < 1024 else 5
        times = {}
        for turn, name in enumerate(("other", "this", "this", "other")):
            run = lambda: fa.launch_with(entries[name], q, k, v, causal=True)  # noqa: E731
            times[f"{name}_{turn}"] = chip_smoke.time_ms(run, reps)[0]
            chip_smoke.require(torch.allclose(run().float(), want, **chip_smoke.ATTN_TOL[q.dtype]),
                               f"{name} kernel differs from the plain version at {shape}")
        times["sdpa"] = chip_smoke.time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), reps)[0]
        results["x".join(map(str, shape))] = times
        print(f"{shape}: " + " ".join(f"{n}={t:.5f}" for n, t in times.items()), flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(Path(sys.argv[1]).resolve()))
