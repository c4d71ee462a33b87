"""Biathlon in PyTorch: the port of ``src/repro`` to PyTorch and CUDA.

The JAX package ``repro`` stays the reference; this package imports nothing
from it and nothing of JAX.  Module names follow the reference
(``core/``, ``data/``, ``kernels/``, ``models/``, ``serving/``), so each
module's counterpart is found at the same path.  Every TPU kernel on the
ported path is a CUDA kernel for Hopper under ``kernels/csrc/``, built with
``nvcc`` at first use (``kernels/build.py``) and held against its plain
PyTorch version, which is also what runs on the CPU.

It serves one request at a time end to end,
``serving.server.BiathlonServer(mode="fused")``, for pipelines with
parametric (AVG/SUM/COUNT/VAR/STD) and holistic (MEDIAN/QUANTILE)
aggregates: ``turbofan`` and ``sensor_health``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
