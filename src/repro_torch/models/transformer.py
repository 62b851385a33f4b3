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
With the quantized tier (pools ``k_scale``/``v_scale`` present, DESIGN.md
§10) attention dequantizes each layer's narrow pools through their scale
pools, and the post-loop write quantizes at commit, data and scale pools
together.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm


def init_params(cfg: ModelConfig, *, seed: int, device) -> dict:
    """Random weights from ``seed`` with an explicit ``torch.Generator`` on
    ``device`` (the reference's init distributions: N(0, 0.02) embedding,
    N(0, 1/d_in) projections, zero biases, unit norm scales). torch and
    jax draw different numbers from one seed; parity tests convert the
    reference's weights instead (``convert.params_from_reference``)."""
    cm.set_matmul_precision()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d = cfg.d_model
    params = {"embed": cm.randn(gen, (cfg.vocab_size, d), 0.02, device),
              "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": cm.norm_init(d, device),
            "attn": cm.gqa_init(gen, cfg, device),
            "ln2": cm.norm_init(d, device),
            "mlp": cm.mlp_init(gen, cfg, device),
        })
    params["ln_f"] = cm.norm_init(d, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(gen, d, cfg.vocab_size, device)
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
    quant = "k_scale" in pools                  # narrow KV tier (§10)
    ks, vs = [], []
    for li, layer in enumerate(params["layers"]):
        h = cm.rmsnorm(layer["ln1"], x, cfg.norm_eps)
        q, k, v = cm.gqa_qkv(layer["attn"], cfg, h, positions)
        k, v = k.contiguous(), v.contiguous()
        o = ops.chunked_prefill_attention(
            q.contiguous(), pools["k"][li], pools["v"][li], k, v,
            descr.block_table, descr.window_base, descr.start_pos,
            descr.n_valid, near_window=sv.near_window,
            skip_extent=sv.skip_extent,
            **_layer_scales(pools, li))                  # (B, C, H, hd)
        x = x + cm.dense(layer["attn"]["wo"], o.reshape(B, C, -1))
        h = cm.rmsnorm(layer["ln2"], x, cfg.norm_eps)
        x = x + cm.mlp_apply(layer["mlp"], h, cfg.mlp_act)
        ks.append(k)
        vs.append(v)
    for name, vals in (("k", ks), ("v", vs)):
        if quant:   # quantize at commit: data and scale pools together
            ops.quant_pool_write_chunk(
                pools[name], pools[name + "_scale"], torch.stack(vals),
                descr.write_block, descr.write_offset, descr.n_valid)
        else:
            ops.pool_write_chunk(pools[name], torch.stack(vals),
                                 descr.write_block, descr.write_offset,
                                 descr.n_valid)
    return pools


def _layer_scales(pools, li: int) -> dict:
    """Layer ``li``'s dequantize scales, (P, KV) each (empty without the
    quantized tier)."""
    if "k_scale" not in pools:
        return {}
    return dict(k_scale=pools["k_scale"][li], v_scale=pools["v_scale"][li])


# ---------------------------------------------------------------------------
# paged decode step (KV-RM path)
# ---------------------------------------------------------------------------

def decode_step(params, cfg: ModelConfig, tokens, pools, descr):
    """One fixed-shape decode step under the KV-RM contract.

    tokens: (B,) int32 current tokens. pools: dict with k, v:
    (L, P, BT, KV, hd); with the far view (``mode="full"``) also far_k,
    far_v: (L, B, MAXC, KV, hd); with the quantized tier k, v narrow and
    k_scale, v_scale: (L, P, KV) f32. descr: FrameDescriptor of int32
    tensors.
    Returns (logits (B, V), pools, far_util) — the pools updated in place;
    far_util (B, CAP) f32 is the far entries' attention mass averaged over
    layers, None without the far view."""
    B = tokens.shape[0]
    sv = cfg.serving
    farview = "far_k" in pools
    quant = "k_scale" in pools                  # narrow KV tier (§10)
    assert not (farview and quant), \
        "far view and the quantized KV tier are exclusive (DESIGN.md §10)"
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
            skip_extent=sv.skip_extent, **far,
            **_layer_scales(pools, li))
        if farview:
            o, futil = o
            fu = futil if fu is None else fu + futil
        x = x + cm.dense(layer["attn"]["wo"], o.reshape(B, -1))
        h = cm.rmsnorm(layer["ln2"], x, cfg.norm_eps)
        x = x + cm.mlp_apply(layer["mlp"], h, cfg.mlp_act)
        ks.append(k)
        vs.append(v)
    for name, vals in (("k", ks), ("v", vs)):
        if quant:   # quantize at commit: data and scale pools together
            ops.quant_pool_write_stacked(
                pools[name], pools[name + "_scale"], torch.stack(vals),
                descr.write_block, descr.write_offset, descr.slot_active)
        else:
            ops.pool_write_stacked(pools[name], torch.stack(vals),
                                   descr.write_block, descr.write_offset,
                                   descr.slot_active)
    x = cm.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if fu is not None:
        fu = fu / cfg.n_layers
    return logits_head(params, cfg, x), pools, fu
