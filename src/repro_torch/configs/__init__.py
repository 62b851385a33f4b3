"""Architecture config registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

The port serves the dense GQA family (``qwen2.5-32b``) and the
encoder-decoder family (``seamless-m4t-medium``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ServingConfig
from repro_torch.configs import qwen2_5_32b, seamless_m4t_medium

_MODULES = {
    "qwen2.5-32b": qwen2_5_32b,
    "seamless-m4t-medium": seamless_m4t_medium,
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


def with_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` cut to ``n_layers`` layers; an encoder-decoder config is cut
    to ``n_layers`` encoder and ``n_layers`` decoder layers."""
    if cfg.family == "encdec":
        return cfg.replace(n_layers=n_layers, enc_layers=n_layers,
                           dec_layers=n_layers)
    return cfg.replace(n_layers=n_layers)


__all__ = ["ModelConfig", "ServingConfig", "ARCH_IDS", "get_config",
           "get_reduced", "with_depth"]
