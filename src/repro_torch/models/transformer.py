"""Dense decoder-only transformer (qwen2.5 backbone): the decode step and
the chunked prefill step of the KV-RM engine.

Counterpart of ``repro/models/transformer.py``. The JAX ``lax.scan`` over
stacked layers becomes a Python loop over per-layer dicts, and the vmap of
the per-slot chunk kernel over the slots becomes one batched launch. As in
the reference, the KV pools are READ-ONLY inside the layer loop: each
layer's new K/V is attended explicitly (``cur_k``/``cur_v``) and the whole
step's K/V is scattered into the pools once after the loop (in place).
In ``mode="full"`` each layer first summarizes a completed far-view chunk
into its far pools (in place, gated per slot) and attends the far view.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm


def _randn(gen, shape, scale, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(cm.DTYPE)


def _dense_init(gen, d_in, d_out, device, bias=False):
    p = {"w": _randn(gen, (d_in, d_out), d_in ** -0.5, device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=cm.DTYPE, device=device)
    return p


def _norm_init(dim, device):
    return {"scale": torch.ones(dim, dtype=cm.DTYPE, device=device)}


def init_params(cfg: ModelConfig, *, seed: int, device) -> dict:
    """Random weights from ``seed`` with an explicit ``torch.Generator`` on
    ``device`` (the reference's init distributions: N(0, 0.02) embedding,
    N(0, 1/d_in) projections, zero biases, unit norm scales). torch and
    jax draw different numbers from one seed; parity tests convert the
    reference's weights instead (``convert.params_from_reference``)."""
    cm.set_matmul_precision()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = {"embed": _randn(gen, (cfg.vocab_size, d), 0.02, device),
              "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": _norm_init(d, device),
            "attn": {"wq": _dense_init(gen, d, h * hd, device, cfg.qkv_bias),
                     "wk": _dense_init(gen, d, kv * hd, device, cfg.qkv_bias),
                     "wv": _dense_init(gen, d, kv * hd, device, cfg.qkv_bias),
                     "wo": _dense_init(gen, h * hd, d, device)},
            "ln2": _norm_init(d, device),
            "mlp": {"gate": _dense_init(gen, d, cfg.d_ff, device),
                    "up": _dense_init(gen, d, cfg.d_ff, device),
                    "down": _dense_init(gen, cfg.d_ff, d, device)},
        })
    params["ln_f"] = _norm_init(d, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(gen, d, cfg.vocab_size, device)
    return params


def logits_head(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].T)
    return cm.dense(params["lm_head"], x)


# ---------------------------------------------------------------------------
# chunked prefill step (prompt ingestion; DESIGN.md §3)
# ---------------------------------------------------------------------------

def prefill_chunk(params, cfg: ModelConfig, pools, descr):
    """Ingest one C-token prompt chunk PER SLOT. descr: a
    PrefillChunkDescriptor of int32 tensors (B / C / NB fixed; idle slots
    carry n_valid = 0). Writes each chunk's K/V into the pools (in place)
    and returns them. No logits: the final prompt token always goes
    through the decode step."""
    sv = cfg.serving
    B, C = descr.tokens.shape
    x = params["embed"][descr.tokens.long()]                    # (B, C, d)
    positions = descr.start_pos[:, None] + torch.arange(
        C, device=x.device, dtype=torch.int32)[None]            # (B, C)
    ks, vs = [], []
    for li, layer in enumerate(params["layers"]):
        h = cm.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        q, k, v = cm.gqa_qkv(layer["attn"], cfg, h, positions)
        k, v = k.contiguous(), v.contiguous()
        o = ops.chunked_prefill_attention(
            q.contiguous(), pools["k"][li], pools["v"][li], k, v,
            descr.block_table, descr.window_base, descr.start_pos,
            descr.n_valid, near_window=sv.near_window,
            skip_extent=sv.skip_extent)                         # (B, C, H, hd)
        x = x + cm.dense(layer["attn"]["wo"], o.reshape(B, C, -1))
        h = cm.rmsnorm(layer["ln2"], x, cfg.norm_eps)
        x = x + cm.mlp_apply(layer["mlp"], h, cfg.mlp_act)
        ks.append(k)
        vs.append(v)
    ops.pool_write_chunk(pools["k"], torch.stack(ks), descr.write_block,
                         descr.write_offset, descr.n_valid)
    ops.pool_write_chunk(pools["v"], torch.stack(vs), descr.write_block,
                         descr.write_offset, descr.n_valid)
    return pools


# ---------------------------------------------------------------------------
# paged decode step (KV-RM path)
# ---------------------------------------------------------------------------

def decode_step(params, cfg: ModelConfig, tokens, pools, descr):
    """One fixed-shape decode step under the KV-RM contract.

    tokens: (B,) int32 current tokens. pools: dict with k, v:
    (L, P, BT, KV, hd); with the far view (``mode="full"``) also far_k,
    far_v: (L, B, MAXC, KV, hd). descr: FrameDescriptor of int32 tensors.
    Returns (logits (B, V), pools, far_util) — the pools updated in place;
    far_util (B, CAP) f32 is the far entries' attention mass averaged over
    layers, None without the far view."""
    B = tokens.shape[0]
    sv = cfg.serving
    farview = "far_k" in pools
    x = params["embed"][tokens.long()]                          # (B, d)
    if farview:
        rows = torch.arange(B, device=x.device)
        widx = descr.far_write_idx.long()
        gate = (descr.far_do_summarize > 0)[:, None, None]
    ks, vs = [], []
    fu = None
    for li, layer in enumerate(params["layers"]):
        h = cm.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        q, k, v = cm.gqa_qkv(layer["attn"], cfg, h[:, None, :],
                             descr.seq_lens[:, None])
        q, k, v = (t[:, 0].contiguous() for t in (q, k, v))   # (B,H,hd)/(B,KV,hd)
        far = {}
        if farview:
            # summarize the chunk that completed this step (gated inside the
            # kernel) from the pools as they were before this step's write:
            # the host TRIMmed its blocks in this step's frame, and a later
            # slot may have RESERVED one of them for the post-loop write
            fk, fv = pools["far_k"][li], pools["far_v"][li]
            sk, svv = ops.farview_summarize(
                pools["k"][li], pools["v"][li], descr.far_chunk_blocks,
                descr.far_chunk_tokens, descr.far_do_summarize)
            fk[rows, widx] = torch.where(gate, sk, fk[rows, widx])
            fv[rows, widx] = torch.where(gate, svv, fv[rows, widx])
            far = dict(far_k=fk, far_v=fv, far_table=descr.far_table,
                       far_valid=descr.far_valid)
        o = ops.paged_decode_attention(
            q, pools["k"][li], pools["v"][li], descr.block_table,
            descr.window_base, descr.seq_lens, descr.slot_active,
            near_window=sv.near_window, cur_k=k, cur_v=v,
            skip_extent=sv.skip_extent, **far)
        if farview:
            o, futil = o
            fu = futil if fu is None else fu + futil
        x = x + cm.dense(layer["attn"]["wo"], o.reshape(B, -1))
        h = cm.rmsnorm(layer["ln2"], x, cfg.norm_eps)
        x = x + cm.mlp_apply(layer["mlp"], h, cfg.mlp_act)
        ks.append(k)
        vs.append(v)
    ops.pool_write_stacked(pools["k"], torch.stack(ks), descr.write_block,
                           descr.write_offset, descr.slot_active)
    ops.pool_write_stacked(pools["v"], torch.stack(vs), descr.write_block,
                           descr.write_offset, descr.slot_active)
    x = cm.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if fu is not None:
        fu = fu / cfg.n_layers
    return logits_head(params, cfg, x), pools, fu
