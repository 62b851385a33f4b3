"""Shared model building blocks (plain functions on tensors).

Counterpart of ``repro/models/common.py`` for the dense GQA and the
encoder-decoder families: params are nested dicts of tensors (per-layer
dicts in a list instead of stacked arrays), compute dtype bf16, f32 for
norms, rope, softmax and projection accumulation.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import ops

DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# param init (the reference's distributions; torch draws its own numbers)
# ---------------------------------------------------------------------------

def randn(gen, shape, scale, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(DTYPE)


def dense_init(gen, d_in, d_out, device, bias=False):
    """N(0, 1/d_in) weight, zero bias."""
    p = {"w": randn(gen, (d_in, d_out), d_in ** -0.5, device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=DTYPE, device=device)
    return p


def norm_init(dim, device):
    return {"scale": torch.ones(dim, dtype=DTYPE, device=device)}


def gqa_init(gen, cfg, device):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d, h * hd, device, cfg.qkv_bias),
         "wk": dense_init(gen, d, kv * hd, device, cfg.qkv_bias),
         "wv": dense_init(gen, d, kv * hd, device, cfg.qkv_bias),
         "wo": dense_init(gen, h * hd, d, device)}
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, device)
        p["k_norm"] = norm_init(hd, device)
    return p


def mlp_init(gen, cfg, device):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"gate": dense_init(gen, d, f, device),
                "up": dense_init(gen, d, f, device),
                "down": dense_init(gen, f, d, device)}
    return {"up": dense_init(gen, d, f, device),
            "down": dense_init(gen, f, d, device)}


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
    if act == "swiglu":
        return dense(p["down"], silu(dense(p["gate"], x)) * dense(p["up"], x))
    if act != "gelu":
        raise NotImplementedError(f"mlp_act {act!r}: the port has swiglu and "
                                  f"gelu")
    return dense(p["down"], gelu(dense(p["up"], x)))


def silu(x):
    """x * sigmoid(x) with jax.nn.silu's op sequence (negate, exp, add 1,
    reciprocal, multiply), each op rounded to x's dtype: bitwise equal to the
    reference in bf16, where one fused f32 silu differs in ~40% of
    elements by one ulp."""
    return x * (1 / (1 + torch.exp(-x)))


@functools.lru_cache(maxsize=None)
def _gelu_consts(dtype):
    """jax.nn.gelu's constants as it applies them to an array of ``dtype``:
    sqrt(2/pi) cast to the dtype, and the weakly typed 0.044715, 0.5 and
    1.0 rounded to it (bf16: 0.044677734375 and 0.796875)."""
    r = lambda v: float(torch.tensor(v, dtype=torch.float32).to(dtype))
    return r(0.044715), r(math.sqrt(2 / math.pi))


def gelu(x):
    """jax.nn.gelu's default tanh form, op for op, each op rounded to x's
    dtype with the constants rounded as jax rounds them: bitwise equal to
    the reference in bf16, where one f32 gelu rounded once differs in ~40%
    of elements by one ulp."""
    c3, c = _gelu_consts(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + c3 * (x * (x * x))))))


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


def gqa_full(p, cfg, x, positions, *, causal=True, window=None):
    """Full-sequence GQA attention (the encoder; train / prefill). The
    attention goes through ``ops.prefill_attention``: the CUDA kernel on
    the card, :func:`attention_dense` / :func:`attention_blocked` on the
    CPU."""
    b, s, _ = x.shape
    q, k, v = gqa_qkv(p, cfg, x, positions)
    o = ops.prefill_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window)
    return dense(p["wo"], o.reshape(b, s, cfg.n_heads * cfg.head_dim))


# ---------------------------------------------------------------------------
# full-sequence attention: the plain versions of the dense prefill kernel
# ---------------------------------------------------------------------------

def repeat_kv(x, n_rep: int):
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd)."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def einsum_round(eq, a, b):
    """``einsum`` of two same-dtype operands, f32 accumulation and one
    rounding to their dtype (jnp.einsum on bf16 arrays). cuBLAS does this
    on the card; on the CPU the product is taken in f32 explicitly."""
    if a.is_cuda:
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.float(), b.float()).to(a.dtype)


def _softmax(x):
    """jax.nn.softmax over the last axis: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def attention_dense(q, k, v, *, causal: bool, window: Optional[int] = None,
                    q_offset: int = 0):
    """Unblocked reference attention. q: (B, Sq, H, hd); k/v: (B, Sk, KV,
    hd). Scores are rounded to q's dtype by their einsum before the f32
    softmax, as in the reference."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    k = repeat_kv(k, h // kvh)
    v = repeat_kv(v, h // kvh)
    scores = einsum_round("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~mask[None, None], -math.inf)
    p = _softmax(scores)
    vd = v.shape[-1]
    return einsum_round("bhqk,bkhd->bqhd", p.to(v.dtype), v).reshape(
        b, sq, h, vd)


def attention_blocked(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_block: int = 512,
                      kv_block: int = 512):
    """Flash-style blocked attention with online softmax (the reference's
    two ``lax.scan`` loops as Python loops). q: (B, Sq, H, hd); k, v:
    (B, Sk, KV, hd). Falls back to :func:`attention_dense` when a length
    is not a multiple of its block."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    n_rep = h // kvh
    if sq % q_block or sk % kv_block:
        return attention_dense(q, k, v, causal=causal, window=window)
    nq, nk = sq // q_block, sk // kv_block
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qr = q.reshape(b, nq, q_block, h, hd).permute(1, 0, 3, 2, 4)      # (nq,B,H,qb,hd)
    kr = k.reshape(b, nk, kv_block, kvh, hd).permute(1, 0, 3, 2, 4)   # (nk,B,KV,kb,hd)
    vr = v.reshape(b, nk, kv_block, kvh, vd).permute(1, 0, 3, 2, 4)
    zero = torch.zeros((), device=dev)
    outs = []
    for iq in range(nq):
        qpos = iq * q_block + torch.arange(q_block, device=dev)
        qg = qr[iq].reshape(b, kvh, n_rep, q_block, hd)
        acc = torch.zeros((b, kvh, n_rep, q_block, vd), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, kvh, n_rep, q_block), -math.inf, device=dev)
        l = torch.zeros((b, kvh, n_rep, q_block), device=dev)
        for ik in range(nk):
            ki, vi = kr[ik], vr[ik]
            kpos = ik * kv_block + torch.arange(kv_block, device=dev)
            # scores in f32 (the reference's default SCORE_DTYPE)
            s = einsum_round("bknqd,bkcd->bknqc", qg, ki).float() * scale
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isinf(m_new), zero, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isinf(m_new)[..., None], zero, p)
            corr = torch.exp(torch.where(torch.isinf(m), zero, m) - m_safe)
            corr = torch.where(torch.isinf(m), zero, corr)
            l = l * corr + p.sum(dim=-1)
            pv = einsum_round("bknqc,bkcd->bknqd", p.to(vi.dtype), vi).float()
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-20)).to(q.dtype))
    # each (B, KV, n_rep, qb, vd) -> (B, Sq, H, vd)
    out = torch.stack(outs)                               # (nq, B, KV, n_rep, qb, vd)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, vd)
