"""Paged near-window decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``repro/kernels/paged_attention.py`` (the Pallas
``_decode_kernel``). The kernel (``csrc/paged_decode.cu``) computes
``ref.paged_decode_attention_ref`` with ``cur_k``/``cur_v`` — the
engine's decode path, where the pool is read-only inside the layer loop
and the current token is attended explicitly — and, in ``mode="full"``,
the far view (``far_k``/``far_v``/``far_table``/``far_valid``) in the same
softmax, returning ``(out, far_util)`` as the reference does.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. Nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref, runtime

NAME = "paged_decode"
THREADS = 128
MAX_SMEM = 227 * 1024            # H100 dynamic shared memory per block
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
_argtypes_set = False

# the plain version of the same function (CPU path, and the card's yardstick)
plain = ref.paged_decode_attention_ref


def _lib():
    global _argtypes_set
    lib = runtime.load(NAME)
    if not _argtypes_set:
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.paged_decode_bf16, lib.paged_decode_f32):
            fn.argtypes = [P] * 15 + [I] * 10 + [ctypes.c_float, I, P]
            fn.restype = I
        lib.paged_decode_smem_bytes.argtypes = [I, I, I, I]
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        _argtypes_set = True
    return lib


def _check(q, pool_k, pool_v, block_table, window_base, seq_lens,
           slot_active, cur_k, cur_v, far_k=None, far_v=None, far_table=None,
           far_valid=None):
    if q.dim() != 3 or pool_k.dim() != 4:
        raise ValueError(f"q must be (B,H,hd) and pools (P,BT,KV,hd); got "
                         f"{tuple(q.shape)} / {tuple(pool_k.shape)}")
    B, H, hd = q.shape
    P, BT, KV, hd2 = pool_k.shape
    if hd2 != hd or pool_v.shape != pool_k.shape:
        raise ValueError("pool_k/pool_v must be (P, BT, KV, hd) with q's hd")
    if H % KV:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {KV}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bf16 or f32, not {q.dtype}")
    for name, x, shape in (("pool_k", pool_k, None), ("pool_v", pool_v, None),
                           ("cur_k", cur_k, (B, KV, hd)),
                           ("cur_v", cur_v, (B, KV, hd))):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B:
        raise ValueError("block_table must be (B, NB)")
    for name, x in (("block_table", block_table), ("window_base", window_base),
                    ("seq_lens", seq_lens), ("slot_active", slot_active)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x is not block_table and tuple(x.shape) != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(x.shape)}")
    for name, x in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("cur_k", cur_k), ("cur_v", cur_v),
                    ("block_table", block_table), ("window_base", window_base),
                    ("seq_lens", seq_lens), ("slot_active", slot_active)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd > 256 or BT > 256:
        raise ValueError(f"kernel takes hd <= 256 and BT <= 256 "
                         f"(got hd={hd}, BT={BT})")
    far = (far_k, far_v, far_table, far_valid)
    if all(x is None for x in far):
        return
    if any(x is None for x in far):
        raise ValueError("far_k, far_v, far_table and far_valid go together")
    if far_k.dim() != 4 or far_k.shape[0] != B or far_k.shape[2:] != (KV, hd):
        raise ValueError(f"far_k must be (B, MAXC, KV, hd) = ({B}, MAXC, {KV},"
                         f" {hd}), got {tuple(far_k.shape)}")
    if far_v.shape != far_k.shape:
        raise ValueError("far_v must have far_k's shape")
    if far_table.dim() != 2 or far_table.shape[0] != B \
            or far_valid.shape != far_table.shape:
        raise ValueError("far_table and far_valid must be (B, CAP)")
    for name, x in (("far_k", far_k), ("far_v", far_v),
                    ("far_table", far_table), ("far_valid", far_valid)):
        want = q.dtype if name in ("far_k", "far_v") else torch.int32
        if x.dtype != want:
            raise TypeError(f"{name} is {x.dtype}, must be {want}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_decode_attention(q, pool_k, pool_v, block_table, window_base,
                           seq_lens, slot_active, *, near_window: int,
                           cur_k, cur_v, far_k=None, far_v=None,
                           far_table=None, far_valid=None,
                           skip_extent: bool = True):
    """q: (B, H, hd); pool_k/pool_v: (P, BT, KV, hd); block_table: (B, NB)
    int32; window_base/seq_lens/slot_active: (B,) int32; cur_k/cur_v:
    (B, KV, hd); far view (optional, all four or none): far_k/far_v
    (B, MAXC, KV, hd), far_table/far_valid (B, CAP) int32. Returns
    (B, H, hd) in q's dtype; with the far view ``(out, far_util)``,
    far_util (B, CAP) f32."""
    far = dict(far_k=far_k, far_v=far_v, far_table=far_table,
               far_valid=far_valid)
    if q.device.type == "cpu":
        return plain(q, pool_k, pool_v, block_table, window_base, seq_lens,
                     slot_active, near_window=near_window, cur_k=cur_k,
                     cur_v=cur_v, skip_extent=skip_extent, **far)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, pool_k, pool_v, block_table, window_base, seq_lens,
           slot_active, cur_k, cur_v, **far)
    B, H, hd = q.shape
    P, BT, KV, _ = pool_k.shape
    NB = block_table.shape[1]
    MAXC, CAP = (0, 0) if far_k is None else (far_k.shape[1],
                                              far_table.shape[1])
    lib = _lib()
    smem = lib.paged_decode_smem_bytes(H // KV, hd, BT, CAP)
    if smem > MAX_SMEM:
        raise ValueError(f"shape needs {smem} B of shared memory "
                         f"(> {MAX_SMEM}): n_rep={H // KV} hd={hd} BT={BT} "
                         f"CAP={CAP}")
    out = torch.empty_like(q)
    # per-(slot, kv head) partials, summed below in a fixed order
    util = (None if far_k is None else
            torch.empty(B, KV, CAP, dtype=torch.float32, device=q.device))
    fn = (lib.paged_decode_bf16 if q.dtype == torch.bfloat16
          else lib.paged_decode_f32)
    p = runtime.ptr
    status = fn(p(q), p(pool_k), p(pool_v), p(block_table), p(window_base),
                p(seq_lens), p(slot_active), p(cur_k), p(cur_v), p(far_k),
                p(far_v), p(far_table), p(far_valid), p(out), p(util),
                B, H, KV, hd, BT, NB, MAXC, CAP, int(near_window),
                int(bool(skip_extent)), 1.0 / math.sqrt(hd), THREADS,
                runtime.stream_ptr(q.device))
    runtime.check_status(NAME, status)
    runtime.count_launch(NAME)
    if util is None:
        return out
    return out, util.sum(dim=1)
