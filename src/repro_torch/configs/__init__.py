"""Architecture config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The port serves the dense GQA family; ``qwen2.5-32b`` is the one
registered architecture.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ServingConfig
from repro_torch.configs import qwen2_5_32b

_MODULES = {
    "qwen2.5-32b": qwen2_5_32b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch_id].CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch_id].reduced()


__all__ = ["ModelConfig", "ServingConfig", "ARCH_IDS", "get_config",
           "get_reduced"]
