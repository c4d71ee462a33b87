"""Architecture registry of the port: the configs it can run.

The reference registers ten architectures (``repro/configs/__init__.py``);
the port runs the dense family's forward only, so it lists
``qwen1.5-0.5b`` alone.  The other nine are ROADMAP Queue 1 item 13.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, SSMConfig

_MODULES = {
    "qwen1.5-0.5b": "qwen15_0_5b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    import importlib

    if arch_id not in _MODULES:
        raise KeyError(
            f"arch {arch_id!r} is not ported (ROADMAP Queue 1 item 13); known: {ARCH_IDS}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


__all__ = ["ARCH_IDS", "MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig", "get_config"]
