"""Architecture registry of the port: the configs it can run.

The same ten architectures, in the same order, as the reference's
``repro/configs/__init__.py``: the ``dense``, ``vlm``, ``moe`` (MLA
included), ``ssm`` (xlstm-1.3b), ``hybrid`` (zamba2-2.7b) and ``audio``
(seamless-m4t-large-v2) families.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, SSMConfig

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


__all__ = ["ARCH_IDS", "MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig", "get_config"]
