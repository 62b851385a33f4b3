"""Plain PyTorch versions of the kernels on the serving path.

Counterpart of ``repro/kernels/ref.py``, line for line where the port has
the feature: the same masks, the same -inf handling, the same casts
(including ``p.to(win_v.dtype)`` before P·V). They are the semantic ground
truth for the CUDA kernels (``csrc/``): the CPU runs them, and
``chip_smoke.py`` holds each kernel against them on the card.

Pool writes update the pool IN PLACE (JAX returns a new array): the pool
is the engine's largest buffer, and the write touches B (or B·C) rows.

Narrow pools (the quantized tier, DESIGN.md §10) are gathered, selected
and scattered as raw bytes (a ``uint8`` view of an fp8 pool), so only the
two casts, f32 -> code and code -> f32, touch the narrow type.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


# ---------------------------------------------------------------------------
# active block extents (work-skipping decode, DESIGN.md §12)
# ---------------------------------------------------------------------------

def active_block_extent(window_base, seq_lens, slot_active, *,
                        near_window: int, nb: int, bt: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot half-open window-block extent [lo, hi) of unmasked decode
    work; retired slots get an empty extent. (B,) ints -> int32 (lo, hi)
    clipped to [0, nb]."""
    window_base = window_base.long()
    seq_lens = seq_lens.long()
    lo_pos = torch.clamp(seq_lens + 1 - near_window, min=0)
    lo = _floordiv(lo_pos - window_base, bt)
    hi = _floordiv(seq_lens - window_base, bt) + 1
    act = slot_active > 0
    zero = torch.zeros_like(lo)
    lo = torch.clamp(torch.where(act, lo, zero), 0, nb).to(torch.int32)
    hi = torch.clamp(torch.where(act, hi, zero), 0, nb).to(torch.int32)
    return lo, torch.maximum(hi, lo)


def chunk_block_extent(window_base, start_pos, *, near_window: int, nb: int,
                       bt: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill-chunk twin of :func:`active_block_extent`: a pool block is
    touched by any chunk row iff it holds a position in
    ``[max(0, start_pos - near_window + 1), start_pos - 1]``."""
    window_base = window_base.long()
    start_pos = start_pos.long()
    has_ctx = start_pos > window_base
    lo_pos = torch.clamp(start_pos - near_window + 1, min=0)
    lo = _floordiv(lo_pos - window_base, bt)
    zero = torch.zeros_like(lo)
    hi = torch.where(has_ctx, _floordiv(start_pos - 1 - window_base, bt) + 1,
                     zero)
    lo = torch.clamp(torch.where(has_ctx, lo, zero), 0, nb).to(torch.int32)
    hi = torch.clamp(hi, 0, nb).to(torch.int32)
    return lo, torch.maximum(hi, lo)


# ---------------------------------------------------------------------------
# pool writes (this step's K/V -> reserved block slots), in place
# ---------------------------------------------------------------------------

def pool_write_stacked_ref(pool, vals, write_block, write_offset, active):
    """Scatter one token per slot across ALL layers at once (post layer
    loop). pool: (L, P, BT, ...payload); vals: (L, B, ...payload);
    write_block/offset/active: (B,). Inactive slots are redirected to
    scratch block 0 and write back its current value."""
    act = active > 0
    blk = torch.where(act, write_block, 0).long()
    off = torch.where(act, write_offset, 0).long()
    mask = act.view((1, -1) + (1,) * (vals.dim() - 2))
    cur = pool[:, blk, off]
    pool[:, blk, off] = torch.where(mask, vals.to(pool.dtype), cur)
    return pool


def pool_write_chunk_ref(pool, vals, write_block, write_offset, n_valid):
    """Scatter a batched prefill chunk's tokens (ALL layers) into the pool.
    pool: (L, P, BT, ...payload); vals: (L, B, C, ...payload);
    write_block/write_offset: (B, C); n_valid: (B,). Tokens beyond a slot's
    n_valid are padding and are redirected to scratch block 0."""
    B, C = write_block.shape
    ar = torch.arange(C, device=write_block.device)
    valid = (ar[None, :] < n_valid[:, None]).reshape(B * C)
    blk = torch.where(valid, write_block.reshape(B * C), 0).long()
    off = torch.where(valid, write_offset.reshape(B * C), 0).long()
    vals = vals.reshape(vals.shape[0], B * C, *vals.shape[3:])
    mask = valid.view((1, -1) + (1,) * (vals.dim() - 2))
    cur = pool[:, blk, off]
    pool[:, blk, off] = torch.where(mask, vals.to(pool.dtype), cur)
    return pool


# ---------------------------------------------------------------------------
# quantized KV-block tier (DESIGN.md §10): absmax codes, f32 block scales
# ---------------------------------------------------------------------------

def quant_range(dtype) -> float:
    """Symmetric representable range of a narrow KV storage dtype."""
    if dtype == torch.int8:
        return 127.0
    if dtype == torch.float8_e4m3fn:
        return 448.0
    raise ValueError(f"not a quantized KV dtype: {dtype}")


def _bits(pool: torch.Tensor) -> torch.Tensor:
    """The pool's codes as an integer tensor of the same bytes (a view)."""
    return pool.view(torch.uint8) if pool.dtype == torch.float8_e4m3fn \
        else pool


def _codes_f32(bits: torch.Tensor, dtype) -> torch.Tensor:
    return bits.view(dtype).float()


def _quant_cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """f32 -> narrow storage codes, returned as :func:`_bits` would give
    them. Clipped first: float8_e4m3fn overflows to nan in the reference
    (torch would saturate), so the clip is what makes both agree; ints
    round half to even, as ``jnp.round``."""
    qmax = quant_range(dtype)
    x = torch.clamp(x, -qmax, qmax)
    if dtype == torch.int8:
        x = torch.round(x)
    q = x.to(dtype)
    return q.view(torch.uint8) if dtype == torch.float8_e4m3fn else q


def dequant_gathered(win, scale):
    """Dequantize a gathered window: win (..., BT, KV, hd) narrow codes,
    scale (..., KV) f32 -> f32. Operates on the GATHERED window only —
    never on the whole pool."""
    return win.float() * scale[..., None, :, None]


def gather_dequant(pool, scale, table):
    """``dequant_gathered(pool[table], scale[table])``, with the gather on
    the pool's bytes."""
    tbl = table.long()
    return dequant_gathered(_bits(pool)[tbl].view(pool.dtype), scale[tbl])


def quant_pool_write_stacked_ref(pool, scale, vals, write_block, write_offset,
                                 active):
    """Quantizing variant of :func:`pool_write_stacked_ref` (one token per
    slot, all layers), in place: fold the token's per-head absmax into the
    block scale, requantize the block's existing rows if the scale grew,
    then store the token at the new scale.

    pool: (L, P, BT, KV, hd) narrow; scale: (L, P, KV) f32; vals: (L, B, KV,
    hd) full precision; write_block/offset/active: (B,). Returns (pool,
    scale). Inactive slots are redirected to scratch block 0 and write
    back its current values, so every duplicate index carries one value."""
    L = pool.shape[0]
    qmax = quant_range(pool.dtype)
    bits = _bits(pool)
    mask = active > 0                                       # (B,)
    blk = torch.where(mask, write_block, 0).long()
    off = torch.where(mask, write_offset, 0).long()
    l_idx = torch.arange(L, device=pool.device)[:, None]
    v32 = vals.float()
    amax = v32.abs().amax(dim=-1)                           # (L, B, KV)
    prev_raw = scale[l_idx, blk[None, :]]                   # (L, B, KV)
    prev = torch.where((off == 0)[None, :, None], 0.0, prev_raw)
    new_scale = torch.maximum(prev, amax / qmax)
    # requantize the written blocks' existing rows to the grown scale
    # (ratio 1 is a lossless roundtrip; ratio 0 zeroes a recycled block)
    ratio = prev / torch.clamp(new_scale, min=1e-12)        # (L, B, KV)
    rows_cur = bits[l_idx, blk[None, :]]                    # (L, B, BT, KV, hd)
    rows_q = _quant_cast(_codes_f32(rows_cur, pool.dtype)
                         * ratio[:, :, None, :, None], pool.dtype)
    bits[l_idx, blk[None, :]] = torch.where(
        mask[None, :, None, None, None], rows_q, rows_cur)
    qtok = _quant_cast(v32 / torch.clamp(new_scale, min=1e-12)[..., None],
                       pool.dtype)                          # (L, B, KV, hd)
    cur_tok = bits[l_idx, blk[None, :], off[None, :]]
    bits[l_idx, blk[None, :], off[None, :]] = torch.where(
        mask[None, :, None, None], qtok, cur_tok)
    scale[l_idx, blk[None, :]] = torch.where(mask[None, :, None], new_scale,
                                             prev_raw)
    return pool, scale


def quant_pool_write_chunk_ref(pool, scale, vals, write_block, write_offset,
                               n_valid):
    """Quantizing variant of :func:`pool_write_chunk_ref` (a batched prefill
    chunk, all layers), in place, in the reference's three phases:

    1. reset the scales of blocks that START inside this chunk (a token at
       offset 0: scatter-min against 0, exact since scales are >= 0) and
       fold every chunk token's absmax into its block scale (scatter-max);
    2. requantize the pre-chunk rows of each written block to its final
       scale — only the block's first chunk token does it (offset 0, or
       the slot's first chunk token: a chunk appends a consecutive offset
       run); every other token is redirected to scratch block 0 and writes
       back its current rows;
    3. store each chunk token at its block's final scale.

    Every duplicate index of a scatter carries one value (or the min/max
    commutes), so the order a device applies them in does not matter.
    pool: (L, P, BT, KV, hd) narrow; scale: (L, P, KV) f32 (contiguous);
    vals: (L, B, C, KV, hd); write_block/write_offset: (B, C); n_valid:
    (B,). Returns (pool, scale)."""
    L, P, BT, KV, hd = pool.shape
    B, C = write_block.shape
    N = B * C
    dev = pool.device
    qmax = quant_range(pool.dtype)
    bits = _bits(pool)
    ar = torch.arange(C, device=dev)
    valid = (ar[None, :] < n_valid[:, None]).reshape(N)
    blk = torch.where(valid, write_block.reshape(N), 0).long()
    off = torch.where(valid, write_offset.reshape(N), 0).long()
    l_idx = torch.arange(L, device=dev)[:, None]
    v32 = vals.reshape(L, N, KV, hd).float()
    amax = v32.abs().amax(dim=-1)                           # (L, N, KV)
    prev_raw = scale[l_idx, blk[None, :]]                   # (L, N, KV)
    fresh = valid & (off == 0)
    first = valid & ((off == 0) | (torch.arange(N, device=dev) % C == 0))
    prev = torch.where(fresh[None, :, None], 0.0, prev_raw)
    # phase 1: reset fresh blocks, then fold the absmax
    flat = scale.view(L * P, KV)
    idx = (l_idx * P + blk[None, :]).reshape(L * N, 1).expand(L * N, KV)
    src = torch.full_like(prev_raw, math.inf).masked_fill(
        fresh[None, :, None], 0.0)
    flat.scatter_reduce_(0, idx, src.reshape(L * N, KV), reduce="amin",
                         include_self=True)
    src = torch.where(valid[None, :, None], amax / qmax, 0.0)
    flat.scatter_reduce_(0, idx, src.reshape(L * N, KV), reduce="amax",
                         include_self=True)
    new_scale = scale[l_idx, blk[None, :]]                  # (L, N, KV) final
    # phase 2: requantize pre-chunk rows (a fresh block's ratio is 0,
    # zeroing recycled contents)
    ratio = prev / torch.clamp(new_scale, min=1e-12)
    blk_first = torch.where(first, blk, 0)
    rows_cur = bits[l_idx, blk_first[None, :]]              # (L, N, BT, KV, hd)
    rows_q = _quant_cast(_codes_f32(rows_cur, pool.dtype)
                         * ratio[:, :, None, :, None], pool.dtype)
    bits[l_idx, blk_first[None, :]] = torch.where(
        first[None, :, None, None, None], rows_q, rows_cur)
    # phase 3: store the chunk tokens at the final block scales
    qtok = _quant_cast(v32 / torch.clamp(new_scale, min=1e-12)[..., None],
                       pool.dtype)
    cur_tok = bits[l_idx, blk[None, :], off[None, :]]
    bits[l_idx, blk[None, :], off[None, :]] = torch.where(
        valid[None, :, None, None], qtok, cur_tok)
    return pool, scale


# ---------------------------------------------------------------------------
# paged decode attention (near window + current token + far view) — GQA
# ---------------------------------------------------------------------------

def paged_decode_attention_ref(q, pool_k, pool_v, block_table, window_base,
                               seq_lens, slot_active, *, near_window: int,
                               cur_k=None, cur_v=None, far_k=None, far_v=None,
                               far_table=None, far_valid=None,
                               k_scale=None, v_scale=None,
                               skip_extent: bool = False):
    """q: (B, H, hd); pool_k/pool_v: (P, BT, KV, hd) (pre-write: the pool is
    read-only inside the layer loop); block_table: (B, NB); window_base,
    seq_lens (position of the CURRENT token), slot_active: (B,);
    cur_k/cur_v: (B, KV, hd) the current token, attended explicitly.

    Far view (``mode="full"``): far_k/far_v (B, MAXC, KV, hd) summary pools,
    far_table/far_valid (B, CAP). The CAP selected summaries join the same
    softmax as the near window and the current token.

    Quantized tier: k_scale/v_scale (P, KV) f32 dequantize the narrow
    pools' GATHERED window blocks, each by the scale of its physical block
    (the far view and the quantized tier are exclusive, DESIGN.md §10).

    Returns (B, H, hd) without the far view; with it ``(out, far_util)``,
    far_util (B, CAP) f32 being each far entry's normalised probability
    summed over all H query heads. Retired slots are zero."""
    B, H, hd = q.shape
    P, BT, KV, _ = pool_k.shape
    NB = block_table.shape[1]
    W = NB * BT
    assert H % KV == 0, (H, KV)
    n_rep = H // KV
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    if k_scale is not None:
        assert far_k is None, \
            "far view and the quantized KV tier are exclusive (§10)"
        win_k = gather_dequant(pool_k, k_scale, block_table).reshape(
            B, W, KV, hd)
        win_v = gather_dequant(pool_v, v_scale, block_table).reshape(
            B, W, KV, hd)
    else:
        tbl = block_table.long()
        win_k = pool_k[tbl].reshape(B, W, KV, hd)
        win_v = pool_v[tbl].reshape(B, W, KV, hd)

    pos = window_base.long()[:, None] + torch.arange(W, device=dev)[None, :]
    t = seq_lens.long()[:, None]
    upper = (pos < t) if cur_k is not None else (pos <= t)
    valid = upper & (pos > t - near_window) & (pos >= 0)
    valid &= (slot_active > 0)[:, None]
    if skip_extent:
        ext_lo, ext_hi = active_block_extent(
            window_base, seq_lens, slot_active,
            near_window=near_window, nb=NB, bt=BT)
        bi = torch.arange(NB, dtype=torch.int32, device=dev)
        blk_ok = (bi[None, :] >= ext_lo[:, None]) & (bi[None, :] < ext_hi[:, None])
        valid &= torch.repeat_interleave(blk_ok, BT, dim=1)

    qg = q.reshape(B, KV, n_rep, hd).float()
    s_near = torch.einsum("bkrd,bwkd->bkrw", qg, win_k.float()) * scale
    s_near = s_near.masked_fill(~valid[:, None, None, :], -math.inf)
    if cur_k is not None:
        s_cur = torch.einsum("bkrd,bkd->bkr", qg,
                             cur_k.to(q.dtype).float())[..., None] * scale
        s_cur = s_cur.masked_fill(~(slot_active > 0)[:, None, None, None],
                                  -math.inf)
        s_near = torch.cat([s_near, s_cur], dim=-1)

    CAP = 0
    if far_k is not None:
        CAP = far_table.shape[1]
        idx = far_table.long()[:, :, None, None].expand(B, CAP, KV, hd)
        fk = torch.gather(far_k, 1, idx)
        fv = torch.gather(far_v, 1, idx)
        s_far = torch.einsum("bkrd,bckd->bkrc", qg, fk.float()) * scale
        fmask = (far_valid > 0) & (slot_active > 0)[:, None]
        s_far = s_far.masked_fill(~fmask[:, None, None, :], -math.inf)
        s_all = torch.cat([s_far, s_near], dim=-1)
    else:
        s_all = s_near

    m = s_all.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s_all - m)
    p = torch.where(torch.isinf(s_all), torch.zeros_like(p), p)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    p = p / denom

    p_far, p = p[..., :CAP], p[..., CAP:]
    if cur_k is not None:
        p_win, p_cur = p[..., :-1], p[..., -1]
        ctx = torch.einsum("bkrw,bwkd->bkrd",
                           p_win.to(win_v.dtype).float(), win_v.float())
        ctx = ctx + p_cur[..., None] * cur_v[:, :, None, :].float()
    else:
        ctx = torch.einsum("bkrw,bwkd->bkrd", p.to(win_v.dtype).float(),
                           win_v.float())
    if CAP:
        ctx = ctx + torch.einsum("bkrc,bckd->bkrd",
                                 p_far.to(fv.dtype).float(), fv.float())
    out = ctx.reshape(B, H, hd).to(q.dtype)
    out = torch.where((slot_active > 0)[:, None, None], out,
                      torch.zeros_like(out))
    if far_k is None:
        return out
    return out, p_far.sum(dim=(1, 2))


# ---------------------------------------------------------------------------
# chunked prefill attention (paged context + in-chunk causal) — GQA
# ---------------------------------------------------------------------------

def chunked_prefill_attention_batched_ref(q, pool_k, pool_v, cur_k, cur_v,
                                          block_table, window_base, start_pos,
                                          n_valid, *, near_window: int,
                                          k_scale=None, v_scale=None,
                                          skip_extent: bool = False
                                          ) -> torch.Tensor:
    """Every slot's C-token prompt chunk at once. q: (B, C, H, hd);
    pool_k/pool_v: (P, BT, KV, hd) (context BEFORE the chunk);
    cur_k/cur_v: (B, C, KV, hd); block_table: (B, NB); window_base,
    start_pos, n_valid: (B,). Query i of slot b (position start + i)
    attends pool context [max(0, pos_i + 1 - W), start) plus the chunk
    causally (j <= i, within W, j < n_valid). Rows >= n_valid are zero.
    k_scale/v_scale (P, KV) f32 dequantize narrow pools' gathered blocks."""
    B, C, H, hd = q.shape
    P, BT, KV, _ = pool_k.shape
    NB = block_table.shape[1]
    Wn = NB * BT
    n_rep = H // KV
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    if k_scale is not None:
        win_k = gather_dequant(pool_k, k_scale, block_table).reshape(
            B, Wn, KV, hd)
        win_v = gather_dequant(pool_v, v_scale, block_table).reshape(
            B, Wn, KV, hd)
    else:
        tbl = block_table.long()
        win_k = pool_k[tbl].reshape(B, Wn, KV, hd)
        win_v = pool_v[tbl].reshape(B, Wn, KV, hd)

    start = start_pos.long()
    qpos = start[:, None] + torch.arange(C, device=dev)[None, :]        # (B, C)
    pos_w = window_base.long()[:, None] + torch.arange(Wn, device=dev)[None]
    valid_w = ((pos_w[:, None, :] < start[:, None, None])
               & (pos_w[:, None, :] > qpos[:, :, None] - near_window)
               & (pos_w[:, None, :] >= 0))                              # (B, C, Wn)
    if skip_extent:
        ext_lo, ext_hi = chunk_block_extent(
            window_base, start_pos, near_window=near_window, nb=NB, bt=BT)
        bi = torch.arange(NB, dtype=torch.int32, device=dev)
        blk_ok = (bi[None, :] >= ext_lo[:, None]) & (bi[None, :] < ext_hi[:, None])
        valid_w &= torch.repeat_interleave(blk_ok, BT, dim=1)[:, None, :]

    qg = q.reshape(B, C, KV, n_rep, hd).float()
    s_w = torch.einsum("bckrd,bwkd->bckrw", qg, win_k.float()) * scale
    s_w = s_w.masked_fill(~valid_w[:, :, None, None, :], -math.inf)

    ij = torch.arange(C, device=dev)
    valid_c = ((ij[None, None, :] <= ij[None, :, None])
               & (qpos[:, None, :] > qpos[:, :, None] - near_window)
               & (ij[None, None, :] < n_valid.long()[:, None, None]))    # (B, C, C)
    s_c = torch.einsum("bckrd,bjkd->bckrj", qg,
                       cur_k.to(q.dtype).float()) * scale
    s_c = s_c.masked_fill(~valid_c[:, :, None, None, :], -math.inf)

    s_all = torch.cat([s_w, s_c], dim=-1)
    m = s_all.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s_all - m)
    p = torch.where(torch.isinf(s_all), torch.zeros_like(p), p)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)

    p_w, p_c = p[..., :Wn], p[..., Wn:]
    ctx = (torch.einsum("bckrw,bwkd->bckrd", p_w.to(win_v.dtype).float(),
                        win_v.float())
           + torch.einsum("bckrj,bjkd->bckrd", p_c.to(cur_v.dtype).float(),
                          cur_v.float()))
    out = ctx.reshape(B, C, H, hd).to(q.dtype)
    row_ok = (ij[None, :] < n_valid.long()[:, None])[:, :, None, None]
    return torch.where(row_ok, out, torch.zeros_like(out))


def chunked_prefill_attention_ref(q, pool_k, pool_v, cur_k, cur_v,
                                  block_table, window_base, start_pos,
                                  n_valid, *, near_window: int,
                                  k_scale=None, v_scale=None,
                                  skip_extent: bool = False) -> torch.Tensor:
    """One slot's chunk, the reference's signature: q (C, H, hd),
    cur_k/cur_v (C, KV, hd), block_table (NB,), scalar window_base,
    start_pos, n_valid. Returns (C, H, hd)."""
    as1 = lambda x: torch.as_tensor(x, device=q.device).reshape(1)
    return chunked_prefill_attention_batched_ref(
        q[None], pool_k, pool_v, cur_k[None], cur_v[None], block_table[None],
        as1(window_base), as1(start_pos), as1(n_valid),
        near_window=near_window, k_scale=k_scale, v_scale=v_scale,
        skip_extent=skip_extent)[0]


# ---------------------------------------------------------------------------
# far-view summarization (uniform aggregation over one sv_chunk)
# ---------------------------------------------------------------------------

def farview_summarize_ref(pool, chunk_blocks, n_tokens, do_summarize):
    """Mean-pool one completed chunk per slot.

    pool: (P, BT, ...payload); chunk_blocks: (B, CB) block ids of the chunk;
    n_tokens: (B,) valid token count (normally sv_chunk); do_summarize: (B,)
    0/1 gate. Returns (B, ...payload) f32 means cast to the pool's dtype
    (zeros where gated off)."""
    B, CB = chunk_blocks.shape
    BT = pool.shape[1]
    ones = (1,) * (pool.dim() - 2)
    toks = pool[chunk_blocks.long()].reshape(B, CB * BT, *pool.shape[2:])
    toks = toks.float()
    idx = torch.arange(CB * BT, device=pool.device)
    mask = (idx[None, :] < n_tokens.long()[:, None]).float()
    s = (toks * mask.reshape(B, CB * BT, *ones)).sum(dim=1)
    s = s / torch.clamp(n_tokens.long(), min=1).float().reshape(B, *ones)
    gate = (do_summarize > 0).reshape(B, *ones)
    return torch.where(gate, s, torch.zeros_like(s)).to(pool.dtype)


# ---------------------------------------------------------------------------
# prefill attention oracle (dense, optional causal and window) — GQA
# ---------------------------------------------------------------------------

def prefill_attention_ref(q, k, v, *, causal=True, window=None):
    from repro_torch.models.common import attention_dense
    return attention_dense(q, k, v, causal=causal, window=window)
