"""One engine-construction factory (counterpart of
``repro/serving/factory.py``).

``build(...)`` returns a list holding one engine (the port serves one
single-device lane). ``arch`` is ``"qwen2.5-32b"`` (dense) or
``"seamless-m4t-medium"`` (encoder-decoder). ``cfg=`` passes a full
configuration (for example ``with_depth(get_config("qwen2.5-32b"), 8)``);
without it the reduced config of ``arch`` is used, as in the reference.
``device=`` defaults to ``"cuda"``. Engine fields (``prefill_chunk``,
``kv_dtype``, ...) pass through to :class:`EngineConfig`.

Params are cached per (arch, seed, device) for the reduced config:
``init_params`` from the same seed is deterministic, so sharing the cache
keeps memory flat. Full configs are never cached (tens of GB).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs import get_reduced
from repro_torch.core.engine import EngineConfig, KVRMEngine
from repro_torch.kernels import runtime
from repro_torch.models import registry

_PARAM_CACHE = {}


def cached_params(arch: str, seed: int = 0, device="cuda"):
    dev = runtime.resolve_device(device)
    key = (arch, seed, str(dev))
    if key not in _PARAM_CACHE:
        _PARAM_CACHE[key] = registry.init_params(get_reduced(arch), seed=seed,
                                                 device=dev)
    return _PARAM_CACHE[key]


def build(arch: str = "qwen2.5-32b", *, mode: str = "paged_merge",
          batch: int = 8, max_seq: int = 256, near_window: Optional[int] = None,
          block_tokens: int = 8, pool_budget: float = 1.0, seed: int = 0,
          cfg=None, params=None, device="cuda", **engine_kw):
    """Build engine lanes (a one-engine list). Remaining ``engine_kw`` pass
    through to :class:`EngineConfig`."""
    dev = runtime.resolve_device(device)
    if cfg is None:
        cfg = get_reduced(arch)
        if params is None:
            params = cached_params(arch, seed, dev)
    elif params is None:
        params = registry.init_params(cfg, seed=seed, device=dev)
    return [KVRMEngine(cfg, params, EngineConfig(
        mode=mode, batch=batch, max_seq=max_seq, near_window=near_window,
        block_tokens=block_tokens, pool_budget_frac=pool_budget, **engine_kw),
        device=dev)]
