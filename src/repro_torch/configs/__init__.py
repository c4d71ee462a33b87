"""Architecture registry of the port: the configs it can run.

The same ten architectures, in the same order, as the reference's
``repro/configs/__init__.py``: the ``dense``, ``vlm``, ``moe`` (MLA
included), ``ssm`` (xlstm-1.3b), ``hybrid`` (zamba2-2.7b) and ``audio``
(seamless-m4t-large-v2) families; ``cells()`` lists the dry run's
(arch × shape) cells as the reference's does.
"""
from repro_torch.configs.base import (
    SHAPES,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    ShapeConfig,
    SSMConfig,
    cell_applicable,
)

_MODULES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-14b": "qwen3_14b",
    "qwen1.5-0.5b": "qwen15_0_5b",
    "gemma-7b": "gemma_7b",
    "qwen3-8b": "qwen3_8b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-1b": "internvl2_1b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    import importlib

    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def cells():
    """All applicable (arch, shape) dry-run cells with skip reasons."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = cell_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out


__all__ = ["ARCH_IDS", "SHAPES", "MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig",
           "ShapeConfig", "cell_applicable", "cells", "get_config"]
