"""Model registry: the uniform init / decode-step / prefill-chunk API the
engine calls, plus decode-pool geometry.

Counterpart of ``repro/models/registry.py``. The port has the dense GQA
family (dense, vlm), with bf16 or quantized (fp8_e4m3, int8) KV pools, and
the encoder-decoder family (encdec) with bf16 KV pools; other families
raise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import encdec, transformer

_FAMILY = {"dense": transformer, "vlm": transformer, "encdec": encdec}


def _module(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense GQA and the "
            f"encoder-decoder families (ROADMAP queue 1, item 11 brings the "
            f"others)")
    return _FAMILY[cfg.family]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    return _module(cfg).init_params(cfg, seed=seed, device=device)


def decode_step(params, cfg: ModelConfig, tokens, pools, descr):
    return _module(cfg).decode_step(params, cfg, tokens, pools, descr)


def prefill_chunk(params, cfg: ModelConfig, pools, descr):
    return _module(cfg).prefill_chunk(params, cfg, pools, descr)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Families with the fixed-shape chunked prompt-ingestion executor
    (DESIGN.md §3); encdec prompts ride the decode step, as in the
    reference."""
    return cfg.family in ("dense", "vlm")


def uses_paged_kv(cfg: ModelConfig) -> bool:
    return cfg.family != "ssm"


# quantized KV-block storage tier (DESIGN.md §10): kv_dtype -> storage dtype.
# Narrow dtypes add sibling per-(layer, block, kv-head) f32 scale pools that
# the pager moves in lockstep with their data blocks (same block index).
KV_DTYPES = {"bf16": cm.DTYPE,
             "fp8_e4m3": torch.float8_e4m3fn,
             "int8": torch.int8}


def kv_storage_dtype(kv_dtype: str) -> torch.dtype:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; "
                         f"one of {sorted(KV_DTYPES)}")
    return KV_DTYPES[kv_dtype]


def quant_decode_error(cfg: ModelConfig, kv_dtype: str):
    """Why this config can NOT store KV quantized (None = compatible).
    Only the GQA-paged dense/vlm families have the quantizing write path
    and the dequantizing attention (DESIGN.md §10)."""
    if kv_dtype == "bf16":
        return None
    if kv_dtype not in KV_DTYPES:
        return f"unknown kv_dtype {kv_dtype!r}; one of {sorted(KV_DTYPES)}"
    if cfg.family not in ("dense", "vlm"):
        return (f"kv_dtype={kv_dtype!r} requires a GQA-paged family "
                f"(dense/vlm), not {cfg.family!r}")
    return None


def decode_pool_shapes(cfg: ModelConfig, *, batch: int, num_blocks: int,
                       block_tokens: int, max_chunks: int = 0,
                       enc_len: int = 0, kv_dtype: str = "bf16"
                       ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """name -> (shape, dtype) of every decode-state buffer. Block 0 is
    scratch (never allocated by the pager). ``max_chunks > 0`` adds the
    far-view summary pools far_k/far_v: (L, B, max_chunks, KV, hd).
    ``kv_dtype`` other than ``"bf16"`` stores k/v narrow, with the f32
    scale pools k_scale/v_scale: (L, num_blocks, KV). The encdec family
    pages its decoder's self-attention K/V (dec_layers) and holds the
    immutable cross K/V, (dec_layers, B, enc_len, KV, hd), with each slot's
    valid encoder length ``enc_len`` (B,) int32."""
    _module(cfg)
    err = quant_decode_error(cfg, kv_dtype)
    if err is not None:
        raise ValueError(err)
    L, KV, hd = n_paged_layers(cfg), cfg.n_kv_heads, cfg.head_dim
    shape = (L, num_blocks, block_tokens, KV, hd)
    store = kv_storage_dtype(kv_dtype)
    shapes = {"k": (shape, store), "v": (shape, store)}
    if kv_dtype != "bf16":
        # sibling physical resource: indexed by the same block id, so
        # alias/COW move data and scale chains together (§10)
        shapes["k_scale"] = ((L, num_blocks, KV), torch.float32)
        shapes["v_scale"] = ((L, num_blocks, KV), torch.float32)
    if cfg.family == "encdec":
        cross = (L, batch, enc_len, KV, hd)
        shapes["cross_k"] = (cross, cm.DTYPE)
        shapes["cross_v"] = (cross, cm.DTYPE)
        shapes["enc_len"] = ((batch,), torch.int32)
        return shapes
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
    """Bytes/token/layer moved through the paged pool (storage width of
    ``kv_dtype``; the per-block scale overhead is accounted separately —
    ``KVRMEngine.scale_bytes_per_block``, DESIGN.md §10)."""
    return cfg.kv_width * kv_storage_dtype(kv_dtype).itemsize


def n_paged_layers(cfg: ModelConfig) -> int:
    _module(cfg)
    if cfg.family == "encdec":
        return cfg.dec_layers
    return cfg.n_layers
