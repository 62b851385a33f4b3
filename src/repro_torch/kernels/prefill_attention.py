"""Prefill attention: the wrappers of two CUDA kernels and their plain
PyTorch versions.

Counterpart of ``repro/kernels/prefill_attention.py``, which holds two
Pallas kernels:

* ``_chunk_kernel`` — chunked paged-prefill attention. The JAX engine
  vmaps a per-slot kernel over the slots; here one launch
  (``csrc/chunked_prefill.cu``) covers every slot of the fixed-shape chunk
  step, and idle slots (``n_valid == 0``) write zeros and read nothing.
  With the quantized tier the pools hold fp8_e4m3 or int8 codes, scaled
  per (physical block, kv head) by ``k_scale``/``v_scale`` as they load
  (the ``quant=True`` branch). With bf16 q the kernel runs on the tensor
  cores (``mma.sync`` tiles fed by a ``cp.async`` ring gathered row by row
  through the block table, any BT; narrow codes widened to bf16 in shared
  memory, the scales applied in f32) for hd a multiple of 16 up to 256
  and 16-byte aligned operands; it rounds p to bf16 before P·V, as the
  plain version rounds p to the pool's dtype. With f32 q it runs on CUDA
  cores.
* ``_prefill_kernel`` — dense full-sequence GQA flash attention with
  optional causal and window masks (``csrc/prefill_flash.cu``): the
  encoder's attention. Its plain version is what the reference's
  ``gqa_full`` computes (``attention_dense``, ``attention_blocked`` above
  S 1024). In bf16 the kernel runs on the tensor cores (``mma.sync``
  tiles fed by a ``cp.async`` ring, ``csrc/mma_tile.cuh``) for hd a
  multiple of 16 up to 256; it keeps the scores in f32 as
  ``_prefill_kernel`` does, where ``attention_dense`` rounds them to bf16,
  and rounds p to bf16 before P·V as ``attention_dense`` does. In f32 it
  runs on CUDA cores.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. Nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref, runtime
from repro_torch.kernels.paged_attention import (QUANT_DTYPES, _check_quant,
                                                 entry)

NAME = "chunked_prefill"
QUANT = NAME + "_quant"          # launch counter of the quantized branch
THREADS = 256
BLOCK_M = 64                     # query rows (chunk token, grouped head) per block
MAX_SMEM = 227 * 1024
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_argtypes_set = False

plain = ref.chunked_prefill_attention_batched_ref


def _lib():
    global _argtypes_set
    lib = runtime.load(NAME)
    if not _argtypes_set:
        P, I = ctypes.c_void_p, ctypes.c_int
        for q in _DTYPES:
            for pool in (q, *QUANT_DTYPES):
                fn = entry(lib, NAME, q, pool)
                fn.argtypes = [P] * 12 + [I] * 9 + [ctypes.c_float, I, I, P]
                fn.restype = I
        lib.chunked_prefill_smem_bytes.argtypes = [I, I, I]
        lib.chunked_prefill_smem_bytes.restype = ctypes.c_size_t
        lib.chunked_prefill_mma_smem_bytes.argtypes = [I, I]
        lib.chunked_prefill_mma_smem_bytes.restype = ctypes.c_size_t
        _argtypes_set = True
    return lib


def _check(q, pool_k, pool_v, cur_k, cur_v, block_table, window_base,
           start_pos, n_valid, k_scale=None, v_scale=None):
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError(f"q must be (B,C,H,hd) and pools (P,BT,KV,hd); got "
                         f"{tuple(q.shape)} / {tuple(pool_k.shape)}")
    B, C, H, hd = q.shape
    P, BT, KV, hd2 = pool_k.shape
    if hd2 != hd or pool_v.shape != pool_k.shape:
        raise ValueError("pool_k/pool_v must be (P, BT, KV, hd) with q's hd")
    if H % KV:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {KV}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, not {q.dtype}")
    _check_quant(q, pool_k, pool_v, k_scale, v_scale)
    for name, x, shape in (("cur_k", cur_k, (B, C, KV, hd)),
                           ("cur_v", cur_v, (B, C, KV, hd))):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError("block_table must be (B, NB)")
    for name, x in (("block_table", block_table), ("window_base", window_base),
                    ("start_pos", start_pos), ("n_valid", n_valid)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x is not block_table and tuple(x.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(x.shape)}")
    for name, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("cur_k", cur_k), ("cur_v", cur_v),
                    ("block_table", block_table), ("window_base", window_base),
                    ("start_pos", start_pos), ("n_valid", n_valid)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd > 256 or BT > 256:
        raise ValueError(f"kernel takes hd <= 256 and BT <= 256 "
                         f"(got hd={hd}, BT={BT})")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel: 16-wide k-steps, 16-byte cp.async rows
        if hd % 16:
            raise ValueError(f"bf16 kernel takes hd a multiple of 16 up to "
                             f"256 (got {hd})")
        for name, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                        ("cur_k", cur_k), ("cur_v", cur_v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")


def chunked_prefill_attention(q, pool_k, pool_v, cur_k, cur_v, block_table,
                              window_base, start_pos, n_valid, *,
                              near_window: int, k_scale=None, v_scale=None,
                              skip_extent: bool = True) -> torch.Tensor:
    """q: (B, C, H, hd); pool_k/pool_v: (P, BT, KV, hd) in q's dtype, or
    fp8_e4m3 / int8 codes with k_scale/v_scale (P, KV) f32; cur_k/cur_v:
    (B, C, KV, hd); block_table: (B, NB) int32; window_base, start_pos,
    n_valid: (B,) int32. Returns (B, C, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return plain(q, pool_k, pool_v, cur_k, cur_v, block_table,
                     window_base, start_pos, n_valid, near_window=near_window,
                     k_scale=k_scale, v_scale=v_scale,
                     skip_extent=skip_extent)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, pool_k, pool_v, cur_k, cur_v, block_table, window_base,
           start_pos, n_valid, k_scale, v_scale)
    B, C, H, hd = q.shape
    P, BT, KV, _ = pool_k.shape
    NB = block_table.shape[1]
    lib = _lib()
    quant = pool_k.dtype in QUANT_DTYPES
    smem = (lib.chunked_prefill_mma_smem_bytes(hd, int(quant))
            if q.dtype == torch.bfloat16
            else lib.chunked_prefill_smem_bytes(BLOCK_M, hd, BT))
    if smem > MAX_SMEM:
        raise ValueError(f"shape needs {smem} B of shared memory "
                         f"(> {MAX_SMEM}): hd={hd} BT={BT}")
    out = torch.empty_like(q)
    fn = entry(lib, NAME, q.dtype, pool_k.dtype)
    p = runtime.ptr
    status = fn(p(q), p(pool_k), p(pool_v), p(cur_k), p(cur_v), p(k_scale),
                p(v_scale), p(block_table), p(window_base), p(start_pos),
                p(n_valid), p(out), B, C, H, KV, hd, BT, NB, int(near_window),
                int(bool(skip_extent)), 1.0 / math.sqrt(hd), BLOCK_M, THREADS,
                runtime.stream_ptr(q.device))
    runtime.check_status(NAME, status)
    runtime.count_launch(NAME)
    if quant:
        runtime.count_launch(QUANT)
    return out


# ---------------------------------------------------------------------------
# dense prefill attention (the encoder; `_prefill_kernel`)
# ---------------------------------------------------------------------------

FLASH = "prefill_flash"
FLASH_BLOCK_M = 64               # query rows (token, grouped head) per block
FLASH_KEY_TILES = (64, 32, 16)   # f32 key tile: the largest whose smem fits
MMA_KEYS = 64                    # bf16 key tile (two stages of K and of V)
MMA_PAD = 8                      # bf16 elements added to each smem row
MMA_THREADS = 128                # 4 warps of 16 query rows
MAX_GRID_Z = 65535
_flash_argtypes_set = False


def prefill_plain(q, k, v, *, causal=True, window=None):
    """What the reference's ``gqa_full`` computes: ``attention_dense``, or
    ``attention_blocked`` above S 1024 (as ``ops.prefill_attention`` of
    the reference switches)."""
    from repro_torch.models.common import attention_blocked, attention_dense
    if q.shape[1] > 1024:
        return attention_blocked(q, k, v, causal=causal, window=window)
    return attention_dense(q, k, v, causal=causal, window=window)


def mma_smem_bytes(hd: int) -> int:
    """Shared memory of the bf16 kernel: the Q tile and two stages each of
    K and V, bf16 rows padded by ``MMA_PAD`` (the source's
    ``prefill_flash_mma_smem_bytes``)."""
    return (FLASH_BLOCK_M + 4 * MMA_KEYS) * (hd + MMA_PAD) * 2


def mma_launch(B: int, S: int, H: int, KV: int, hd: int):
    """(grid, threads, shared-memory bytes) of the bf16 kernel at this
    shape; raises where the grid or the shared memory does not fit."""
    z = -(-S * (H // KV) // FLASH_BLOCK_M)
    if z > MAX_GRID_Z:
        raise ValueError(f"S * n_rep = {S * (H // KV)} exceeds the grid")
    smem = mma_smem_bytes(hd)
    if smem > MAX_SMEM:
        raise ValueError(f"hd={hd} needs {smem} B of shared memory "
                         f"(> {MAX_SMEM})")
    return (B, KV, z), MMA_THREADS, smem


def _flash_lib():
    global _flash_argtypes_set
    lib = runtime.load(FLASH)
    if not _flash_argtypes_set:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.prefill_flash_bf16.argtypes = ([P] * 4 + [I] * 7
                                           + [ctypes.c_float, P])
        lib.prefill_flash_f32.argtypes = ([P] * 4 + [I] * 7
                                          + [ctypes.c_float, I, I, I, P])
        for fn in (lib.prefill_flash_bf16, lib.prefill_flash_f32):
            fn.restype = I
        lib.prefill_flash_smem_bytes.argtypes = [I, I, I]
        lib.prefill_flash_smem_bytes.restype = ctypes.c_size_t
        lib.prefill_flash_mma_smem_bytes.argtypes = [I]
        lib.prefill_flash_mma_smem_bytes.restype = ctypes.c_size_t
        _flash_argtypes_set = True
    return lib


def _check_window(window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _check_dense(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B,S,H,hd) and k/v (B,S,KV,hd); got "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, hd) or v.shape != k.shape:
        raise ValueError(f"k/v must be ({B}, {S}, KV, {hd}); got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if S < 1 or B < 1 or H % KV:
        raise ValueError(f"need B, S >= 1 and n_heads {H} a multiple of "
                         f"n_kv_heads {KV}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, not {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd > 256:
        raise ValueError(f"kernel takes hd <= 256 (got {hd})")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel: 16-wide k-steps, 16-byte cp.async rows
        if hd % 16:
            raise ValueError(f"bf16 kernel takes hd a multiple of 16 up to "
                             f"256 (got {hd})")
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    if -(-S * (H // KV) // FLASH_BLOCK_M) > MAX_GRID_Z:
        raise ValueError(f"S * n_rep = {S * (H // KV)} exceeds the grid")


def prefill_attention(q, k, v, *, causal: bool = True, window=None
                      ) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) -> (B, S, H, hd) in q's dtype.
    ``window`` (None or >= 1): key j is visible to query i only if
    j > i - window."""
    _check_window(window)
    if q.device.type == "cpu":
        return prefill_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_dense(q, k, v)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        mma_launch(B, S, H, KV, hd)      # raises where the launch cannot fit
    lib = _flash_lib()
    out = torch.empty_like(q)
    p = runtime.ptr
    args = (p(q), p(k), p(v), p(out), B, S, H, KV, hd, int(bool(causal)),
            int(window or 0), 1.0 / math.sqrt(hd))
    if bf16:
        status = lib.prefill_flash_bf16(*args, runtime.stream_ptr(q.device))
    else:
        kt = next((t for t in FLASH_KEY_TILES
                   if lib.prefill_flash_smem_bytes(FLASH_BLOCK_M, hd, t)
                   <= MAX_SMEM), None)
        if kt is None:
            raise ValueError(f"no key tile fits {MAX_SMEM} B of shared "
                             f"memory at hd={hd}")
        status = lib.prefill_flash_f32(*args, FLASH_BLOCK_M, kt, THREADS,
                                       runtime.stream_ptr(q.device))
    runtime.check_status(FLASH, status)
    runtime.count_launch(FLASH)
    return out
