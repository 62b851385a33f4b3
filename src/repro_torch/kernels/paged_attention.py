"""Paged near-window decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``repro/kernels/paged_attention.py`` (the Pallas
``_decode_kernel``). The kernel (``csrc/paged_decode.cu``) computes
``ref.paged_decode_attention_ref`` with ``cur_k``/``cur_v`` — the
engine's decode path, where the pool is read-only inside the layer loop
and the current token is attended explicitly — and, in ``mode="full"``,
the far view (``far_k``/``far_v``/``far_table``/``far_valid``) in the same
softmax, returning ``(out, far_util)`` as the reference does. With the
quantized tier (DESIGN.md §10) the pools hold fp8_e4m3 or int8 codes and
``k_scale``/``v_scale`` (P, KV) f32 scale each physical block's codes as
the kernel loads them (the ``quant=True`` branch of ``_decode_kernel``).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. Nothing falls back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref, runtime

NAME = "paged_decode"
QUANT = NAME + "_quant"          # launch counter of the quantized branch
THREADS = 128
MAX_SMEM = 227 * 1024            # H100 dynamic shared memory per block
_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# narrow pool dtypes of the quantized tier -> C symbol suffix
QUANT_DTYPES = {torch.float8_e4m3fn: "fp8", torch.int8: "int8"}
_argtypes_set = False

# the plain version of the same function (CPU path, and the card's yardstick)
plain = ref.paged_decode_attention_ref


def entry(lib, name: str, q_dtype, pool_dtype):
    """The C entry of kernel ``name`` for (q dtype, pool dtype):
    ``{name}_{bf16|f32}``, with ``_{fp8|int8}`` for a quantized pool."""
    suffix = (f"_{QUANT_DTYPES[pool_dtype]}" if pool_dtype in QUANT_DTYPES
              else "")
    return getattr(lib, f"{name}_{_DTYPES[q_dtype]}{suffix}")


def _lib():
    global _argtypes_set
    lib = runtime.load(NAME)
    if not _argtypes_set:
        P, I = ctypes.c_void_p, ctypes.c_int
        for q in _DTYPES:
            for pool in (q, *QUANT_DTYPES):
                fn = entry(lib, NAME, q, pool)
                fn.argtypes = [P] * 17 + [I] * 10 + [ctypes.c_float, I, P]
                fn.restype = I
        lib.paged_decode_smem_bytes.argtypes = [I, I, I, I]
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        _argtypes_set = True
    return lib


def _check_quant(q, pool_k, pool_v, k_scale, v_scale, far: bool = False):
    """A pool in q's dtype takes no scales; a narrow pool (fp8_e4m3 or
    int8) takes k_scale/v_scale (P, KV) f32 and no far view."""
    P, KV = pool_k.shape[0], pool_k.shape[2]
    if pool_v.dtype != pool_k.dtype:
        raise TypeError(f"pool_v is {pool_v.dtype}, pool_k {pool_k.dtype}")
    if pool_k.dtype not in QUANT_DTYPES:
        if pool_k.dtype != q.dtype:
            raise TypeError(f"pool_k is {pool_k.dtype}, q is {q.dtype}")
        if k_scale is not None or v_scale is not None:
            raise ValueError(f"k_scale/v_scale go with a quantized pool "
                             f"({sorted(map(str, QUANT_DTYPES))}), not "
                             f"{pool_k.dtype}")
        return
    if far:
        raise ValueError("far view and the quantized KV tier are exclusive "
                         "(DESIGN.md §10)")
    if k_scale is None or v_scale is None:
        raise ValueError(f"a {pool_k.dtype} pool needs k_scale and v_scale")
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        if x.dtype != torch.float32 or tuple(x.shape) != (P, KV):
            raise ValueError(f"{name} must be ({P}, {KV}) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(q, pool_k, pool_v, block_table, window_base, seq_lens,
           slot_active, cur_k, cur_v, far_k=None, far_v=None, far_table=None,
           far_valid=None, k_scale=None, v_scale=None):
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
    _check_quant(q, pool_k, pool_v, k_scale, v_scale,
                 far=far_k is not None)
    for name, x, shape in (("cur_k", cur_k, (B, KV, hd)),
                           ("cur_v", cur_v, (B, KV, hd))):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if tuple(x.shape) != shape:
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
                           k_scale=None, v_scale=None,
                           skip_extent: bool = True):
    """q: (B, H, hd); pool_k/pool_v: (P, BT, KV, hd) in q's dtype, or
    fp8_e4m3 / int8 codes with k_scale/v_scale (P, KV) f32; block_table:
    (B, NB) int32; window_base/seq_lens/slot_active: (B,) int32;
    cur_k/cur_v: (B, KV, hd); far view (optional, all four or none, not
    with a quantized pool): far_k/far_v (B, MAXC, KV, hd),
    far_table/far_valid (B, CAP) int32. Returns (B, H, hd) in q's dtype;
    with the far view ``(out, far_util)``, far_util (B, CAP) f32."""
    far = dict(far_k=far_k, far_v=far_v, far_table=far_table,
               far_valid=far_valid)
    scales = dict(k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return plain(q, pool_k, pool_v, block_table, window_base, seq_lens,
                     slot_active, near_window=near_window, cur_k=cur_k,
                     cur_v=cur_v, skip_extent=skip_extent, **far, **scales)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, pool_k, pool_v, block_table, window_base, seq_lens,
           slot_active, cur_k, cur_v, **far, **scales)
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
    fn = entry(lib, NAME, q.dtype, pool_k.dtype)
    p = runtime.ptr
    status = fn(p(q), p(pool_k), p(pool_v), p(block_table), p(window_base),
                p(seq_lens), p(slot_active), p(cur_k), p(cur_v), p(k_scale),
                p(v_scale), p(far_k), p(far_v), p(far_table), p(far_valid),
                p(out), p(util),
                B, H, KV, hd, BT, NB, MAXC, CAP, int(near_window),
                int(bool(skip_extent)), 1.0 / math.sqrt(hd), THREADS,
                runtime.stream_ptr(q.device))
    runtime.check_status(NAME, status)
    runtime.count_launch(NAME)
    if pool_k.dtype in QUANT_DTYPES:
        runtime.count_launch(QUANT)
    if util is None:
        return out
    return out, util.sum(dim=1)
