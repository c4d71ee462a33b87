"""Biathlon in PyTorch: the port of ``src/repro`` to PyTorch and CUDA.

The JAX package ``repro`` stays the reference; this package imports nothing
from it and nothing of JAX.  Module names follow the reference
(``configs/``, ``core/``, ``data/``, ``examples/``, ``kernels/``,
``models/``, ``optim/``, ``serving/``), so each
module's counterpart is found at the same path.  Every TPU kernel on the
ported path is a CUDA kernel for Hopper under ``kernels/csrc/``, built with
``nvcc`` at first use (``kernels/build.py``) and held against its plain
PyTorch version, which is also what runs on the CPU.

It serves one request at a time end to end,
``serving.server.BiathlonServer(mode="fused")``, for pipelines with
parametric (AVG/SUM/COUNT/VAR/STD) and holistic (MEDIAN/QUANTILE)
aggregates: ``turbofan`` and ``sensor_health``.  It also serves the LM-head
pipeline, ``examples.serve_lm_head``: a dense LM backbone
(``models/lm``, ``configs``: ``qwen1.5-0.5b``) whose pooled state feeds an
MLP head (``models/tabular/mlp.py``, trained with ``optim.adamw``) beside
three Biathlon-approximated aggregates; on the card its attention runs the
``flash_attention`` kernel.  The LM serves (prefill, decode, the KV cache:
``models/lm/cache.py``) the dense, VLM and MoE families of seven configs,
MLA included.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
