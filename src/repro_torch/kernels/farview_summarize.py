"""Far-view chunk summarization: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``repro/kernels/farview_summarize.py`` (the Pallas
``_sum_kernel``). The kernel (``csrc/farview_summarize.cu``) computes
``ref.farview_summarize_ref`` for a layer's K and V pools in one launch:
per slot, the f32 mean of the first ``n_tokens`` rows of one completed
chunk's blocks, cast to the pool's type, or zeros where ``do_summarize``
is 0.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. Nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref, runtime

NAME = "farview_summarize"
THREADS = 128
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_argtypes_set = False

# the plain version of the same function (CPU path, and the card's yardstick)
plain = ref.farview_summarize_ref


def _lib():
    global _argtypes_set
    lib = runtime.load(NAME)
    if not _argtypes_set:
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.farview_summarize_bf16, lib.farview_summarize_f32):
            fn.argtypes = [P] * 7 + [I] * 5 + [P]
            fn.restype = I
        _argtypes_set = True
    return lib


def _check(pool_k, pool_v, chunk_blocks, n_tokens, do_summarize):
    if pool_k.dim() < 3:
        raise ValueError(f"pools must be (P, BT, ...payload), got "
                         f"{tuple(pool_k.shape)}")
    if pool_k.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, not {pool_k.dtype}")
    if pool_v.shape != pool_k.shape or pool_v.dtype != pool_k.dtype:
        raise ValueError("pool_k and pool_v must share shape and dtype")
    if chunk_blocks.dim() != 2:
        raise ValueError("chunk_blocks must be (B, CB)")
    B = chunk_blocks.shape[0]
    for name, x in (("chunk_blocks", chunk_blocks), ("n_tokens", n_tokens),
                    ("do_summarize", do_summarize)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x is not chunk_blocks and tuple(x.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(x.shape)}")
    for x in (pool_k, pool_v, chunk_blocks, n_tokens, do_summarize):
        if x.device != pool_k.device:
            raise ValueError(f"operand on {x.device}, pool on {pool_k.device}")
        if not x.is_contiguous():
            raise ValueError("operands must be contiguous")


def farview_summarize(pool_k, pool_v, chunk_blocks, n_tokens, do_summarize):
    """pool_k/pool_v: (P, BT, ...payload); chunk_blocks: (B, CB) int32;
    n_tokens/do_summarize: (B,) int32. Returns ``(summary_k, summary_v)``,
    each (B, ...payload) in the pools' dtype."""
    if pool_k.device.type == "cpu":
        return (plain(pool_k, chunk_blocks, n_tokens, do_summarize),
                plain(pool_v, chunk_blocks, n_tokens, do_summarize))
    if pool_k.device.type != "cuda":
        raise ValueError(f"no kernel for device {pool_k.device}")
    _check(pool_k, pool_v, chunk_blocks, n_tokens, do_summarize)
    P, BT = pool_k.shape[:2]
    width = math.prod(pool_k.shape[2:])
    B, CB = chunk_blocks.shape
    out_k = torch.empty((B,) + tuple(pool_k.shape[2:]), dtype=pool_k.dtype,
                        device=pool_k.device)
    out_v = torch.empty_like(out_k)
    lib = _lib()
    fn = (lib.farview_summarize_bf16 if pool_k.dtype == torch.bfloat16
          else lib.farview_summarize_f32)
    p = runtime.ptr
    status = fn(p(pool_k), p(pool_v), p(chunk_blocks), p(n_tokens),
                p(do_summarize), p(out_k), p(out_v), B, CB, BT, width,
                THREADS, runtime.stream_ptr(pool_k.device))
    runtime.check_status(NAME, status)
    runtime.count_launch(NAME)
    return out_k, out_v
