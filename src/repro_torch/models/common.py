"""Shared model building blocks (plain functions on tensors).

Counterpart of ``repro/models/common.py`` for the dense GQA family:
params are nested dicts of tensors (per-layer dicts in a list instead of
stacked arrays), compute dtype bf16, f32 for norms, rope and projection
accumulation.
"""
from __future__ import annotations

import torch

DTYPE = torch.bfloat16


def set_matmul_precision() -> None:
    """Keep card matmuls at full f32 accumulation with one rounding at the
    end — parity with ``common.dense``'s ``preferred_element_type=f32``
    followed by a single cast (src/repro/models/common.py:45-57). TF32
    inputs, or bf16 partial sums that cuBLAS may otherwise reduce in
    reduced precision, would each move logits enough to flip greedy argmax
    at near-ties."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def dense(p, x):
    """x @ w (+ b): f32 accumulation, one rounding to x's dtype. On the
    card cuBLAS accumulates a bf16 product in f32 and rounds once (with
    the flags of :func:`set_matmul_precision`); on the CPU the product is
    taken in f32 explicitly."""
    w = p["w"]
    if x.is_cuda:
        y = torch.matmul(x, w)
    else:
        y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device)
                  ** (ar / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). 'half'
    pairing (i, i + hd/2), the reference's default."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                       # (hd/2,)
    ang = positions[..., None].float() * inv                    # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p, x, act: str):
    if act != "swiglu":
        raise NotImplementedError(f"mlp_act {act!r}: the port's dense slice "
                                  f"has swiglu only")
    return dense(p["down"], silu(dense(p["gate"], x)) * dense(p["up"], x))


def silu(x):
    """x * sigmoid(x) with jax.nn.silu's op sequence (negate, exp, add 1,
    reciprocal, multiply), each op rounded to x's dtype: bitwise equal to the
    reference in bf16, where one fused f32 silu differs in ~40% of
    elements by one ulp."""
    return x * (1 / (1 + torch.exp(-x)))


def gqa_qkv(p, cfg, x, positions):
    """Project + rope. x: (B, S, d) -> q: (B, S, H, hd), k/v: (B, S, KV, hd)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(p["wq"], x).reshape(b, s, h, hd)
    k = dense(p["wk"], x).reshape(b, s, kv, hd)
    v = dense(p["wv"], x).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v
