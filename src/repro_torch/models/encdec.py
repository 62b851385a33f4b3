"""Encoder-decoder transformer backbone (seamless-m4t-medium): the encoder,
the cross-attention K/V and the decode step of the KV-RM engine.

Counterpart of ``repro/models/encdec.py``. The audio frontend is a stub:
the encoder consumes precomputed frame embeddings (B, S_enc, d). The
decoder's self-attention KV is paged by KV-RM (the CUDA paged decode
kernel on the card); the cross-attention KV is computed once per request
at admission and is immutable (DESIGN.md §4). The encoder's attention is
the dense prefill kernel (``ops.prefill_attention``, non-causal).

Not ported here: the far view (the reference's decode step never reads
it) and the teacher-forced ``decode_full`` / ``forward`` (training, ROADMAP
queue 1, item 13).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm


def init_params(cfg: ModelConfig, *, seed: int, device) -> dict:
    """Random weights from ``seed`` with an explicit ``torch.Generator`` on
    ``device``, in the reference's init distributions and tree layout
    (per-layer dicts in ``enc_layers`` / ``dec_layers``)."""
    cm.set_matmul_precision()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d = cfg.d_model
    params = {"embed": cm.randn(gen, (cfg.vocab_size, d), 0.02, device),
              "enc_layers": [], "dec_layers": []}
    for _ in range(cfg.enc_layers):
        params["enc_layers"].append({
            "ln1": cm.norm_init(d, device), "attn": cm.gqa_init(gen, cfg, device),
            "ln2": cm.norm_init(d, device), "mlp": cm.mlp_init(gen, cfg, device)})
    params["enc_ln"] = cm.norm_init(d, device)
    for _ in range(cfg.dec_layers):
        params["dec_layers"].append({
            "ln1": cm.norm_init(d, device),
            "self_attn": cm.gqa_init(gen, cfg, device),
            "ln_x": cm.norm_init(d, device),
            "cross_attn": cm.gqa_init(gen, cfg, device),
            "ln2": cm.norm_init(d, device), "mlp": cm.mlp_init(gen, cfg, device)})
    params["ln_f"] = cm.norm_init(d, device)
    params["lm_head"] = cm.dense_init(gen, d, cfg.vocab_size, device)
    return params


def encode(params, cfg: ModelConfig, enc_embeds):
    """enc_embeds: (B, S_enc, d) precomputed frame embeddings -> (B, S_enc,
    d). Rope at positions 0..S_enc-1, non-causal attention."""
    B, S, _ = enc_embeds.shape
    x = enc_embeds.to(cm.DTYPE)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for layer in params["enc_layers"]:
        h = cm.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        x = x + cm.gqa_full(layer["attn"], cfg, h, positions, causal=False)
        h = cm.rmsnorm(layer["ln2"], x, cfg.norm_eps)
        x = x + cm.mlp_apply(layer["mlp"], h, cfg.mlp_act)
    return cm.rmsnorm(params["enc_ln"], x, cfg.norm_eps)


def cross_kv(params, cfg: ModelConfig, enc_out):
    """Per-decoder-layer cross K/V, no rope: (L, B, S_enc, KV, hd) each."""
    B, S, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    ks, vs = [], []
    for layer in params["dec_layers"]:
        ks.append(cm.dense(layer["cross_attn"]["wk"], enc_out).reshape(
            B, S, kv, hd))
        vs.append(cm.dense(layer["cross_attn"]["wv"], enc_out).reshape(
            B, S, kv, hd))
    return torch.stack(ks), torch.stack(vs)


def _cross_attention(cfg: ModelConfig, qx, ck, cv, enc_len):
    """qx: (B, 1, H, hd); ck/cv: (B, Se, KV, hd) one layer's immutable
    encoder K/V; enc_len: (B,) valid rows. The reference's safe softmax:
    masked scores -inf, the max reset to 0 where it is infinite, and
    p / max(sum, 1e-20) — a slot with enc_len 0 attends to nothing."""
    Se = ck.shape[1]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    mask_len = torch.arange(Se, device=ck.device)[None, :] < enc_len.long()[:, None]
    kx = torch.where(mask_len[:, :, None, None], ck, torch.zeros_like(ck))
    sc = cm.einsum_round("bqhd,bkhd->bhqk", qx, cm.repeat_kv(kx, n_rep)
                         ).float() * (cfg.head_dim ** -0.5)
    neg = torch.full_like(sc, -float("inf"))
    sc = torch.where(mask_len[:, None, None, :], sc, neg)
    mx = sc.amax(dim=-1, keepdim=True)
    mx = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
    pe = torch.where(torch.isinf(sc), torch.zeros_like(sc), torch.exp(sc - mx))
    pr = pe / torch.clamp(pe.sum(dim=-1, keepdim=True), min=1e-20)
    return cm.einsum_round("bhqk,bkhd->bqhd", pr.to(cv.dtype),
                           cm.repeat_kv(cv, n_rep))


def decode_step(params, cfg: ModelConfig, tokens, pools, descr):
    """One fixed-shape decode step. pools: k/v (L, P, BT, KV, hd) paged
    decoder self-attention (read-only in the layer loop, written once after
    it, in place); cross_k/cross_v (L, B, Se, KV, hd) immutable; enc_len
    (B,) valid encoder length. Returns (logits (B, V), pools, None)."""
    B = tokens.shape[0]
    sv = cfg.serving
    H, hd = cfg.n_heads, cfg.head_dim
    x = params["embed"][tokens.long()]                          # (B, d)
    enc_len = pools["enc_len"]
    ks, vs = [], []
    for li, layer in enumerate(params["dec_layers"]):
        h = cm.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        q, k, v = cm.gqa_qkv(layer["self_attn"], cfg, h[:, None, :],
                             descr.seq_lens[:, None])
        q, k, v = (t[:, 0].contiguous() for t in (q, k, v))
        o = ops.paged_decode_attention(
            q, pools["k"][li], pools["v"][li], descr.block_table,
            descr.window_base, descr.seq_lens, descr.slot_active,
            near_window=sv.near_window, cur_k=k, cur_v=v,
            skip_extent=sv.skip_extent)
        x = x + cm.dense(layer["self_attn"]["wo"], o.reshape(B, -1))
        # cross attention over the immutable encoder KV
        h = cm.rmsnorm(layer["ln_x"], x, cfg.norm_eps)
        qx = cm.dense(layer["cross_attn"]["wq"], h).reshape(B, 1, H, hd)
        ox = _cross_attention(cfg, qx, pools["cross_k"][li],
                              pools["cross_v"][li], enc_len)
        x = x + cm.dense(layer["cross_attn"]["wo"], ox.reshape(B, -1))
        h = cm.rmsnorm(layer["ln2"], x, cfg.norm_eps)
        x = x + cm.mlp_apply(layer["mlp"], h, cfg.mlp_act)
        ks.append(k)
        vs.append(v)
    ops.pool_write_stacked(pools["k"], torch.stack(ks), descr.write_block,
                           descr.write_offset, descr.slot_active)
    ops.pool_write_stacked(pools["v"], torch.stack(vs), descr.write_block,
                           descr.write_offset, descr.slot_active)
    x = cm.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return cm.dense(params["lm_head"], x), pools, None
