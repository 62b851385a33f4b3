"""Model registry (dense subset): the uniform init / decode-step /
prefill-chunk API the engine calls, plus decode-pool geometry.

Counterpart of ``repro/models/registry.py``. The port has the dense GQA
family with bf16 KV pools; other families and narrow KV dtypes raise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer

_FAMILIES = ("dense", "vlm")


def _module(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense GQA family "
            f"only (ROADMAP queue 1, item 11 brings the others)")
    return transformer


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    return _module(cfg).init_params(cfg, seed=seed, device=device)


def decode_step(params, cfg: ModelConfig, tokens, pools, descr):
    return _module(cfg).decode_step(params, cfg, tokens, pools, descr)


def prefill_chunk(params, cfg: ModelConfig, pools, descr):
    return _module(cfg).prefill_chunk(params, cfg, pools, descr)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    return cfg.family in _FAMILIES


def uses_paged_kv(cfg: ModelConfig) -> bool:
    return cfg.family != "ssm"


def _check_kv_dtype(kv_dtype: str) -> None:
    if kv_dtype != "bf16":
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r}: the port stores bf16 KV only (ROADMAP "
            f"queue 1, item 6f brings the quantized tier)")


def decode_pool_shapes(cfg: ModelConfig, *, batch: int, num_blocks: int,
                       block_tokens: int, max_chunks: int = 0,
                       kv_dtype: str = "bf16"
                       ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """name -> (shape, dtype) of every decode-state buffer. Block 0 is
    scratch (never allocated by the pager). ``max_chunks > 0`` adds the
    far-view summary pools far_k/far_v: (L, B, max_chunks, KV, hd)."""
    _module(cfg)
    _check_kv_dtype(kv_dtype)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shape = (L, num_blocks, block_tokens, KV, hd)
    shapes = {"k": (shape, cm.DTYPE), "v": (shape, cm.DTYPE)}
    if max_chunks:
        far = (L, batch, max_chunks, KV, hd)
        shapes["far_k"] = (far, cm.DTYPE)
        shapes["far_v"] = (far, cm.DTYPE)
    return shapes


def init_decode_pools(cfg: ModelConfig, *, device, **kw):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in decode_pool_shapes(cfg, **kw).items()}


def paged_payload_bytes_per_token(cfg: ModelConfig,
                                  kv_dtype: str = "bf16") -> int:
    """Bytes/token/layer moved through the paged pool (bf16 storage)."""
    _check_kv_dtype(kv_dtype)
    return cfg.kv_width * 2


def n_paged_layers(cfg: ModelConfig) -> int:
    _module(cfg)
    return cfg.n_layers
