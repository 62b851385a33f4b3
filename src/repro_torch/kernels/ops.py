"""Dispatch layer over kernel implementations.

Counterpart of ``repro/kernels/ops.py``. ``impl`` selects:

  * ``'kernel'`` (default) — the kernel wrappers: a CUDA tensor launches
    the hand-written CUDA kernel, a CPU tensor takes its plain version;
  * ``'plain'`` — the plain PyTorch version on any device (``chip_smoke.py``
    runs the engine this way on the card to hold the kernels against it).

The default changes only through :func:`set_default_impl`; no environment
variable selects it. Models call these entry points and stay ignorant of
paging internals.
"""
from __future__ import annotations

from repro_torch.kernels import (farview_summarize as fvs, paged_attention,
                                prefill_attention as pfa, ref)

IMPLS = ("kernel", "plain")
_DEFAULT_IMPL = "kernel"


def set_default_impl(impl: str) -> None:
    global _DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    _DEFAULT_IMPL = impl


def get_default_impl() -> str:
    return _DEFAULT_IMPL


# ---------------------------------------------------------------------------
# pool writes: plain tensor scatters (the reference has no kernel for them)

def pool_write_stacked(pool, vals, write_block, write_offset, active):
    return ref.pool_write_stacked_ref(pool, vals, write_block, write_offset,
                                      active)


def pool_write_chunk(pool, vals, write_block, write_offset, n_valid):
    return ref.pool_write_chunk_ref(pool, vals, write_block, write_offset,
                                    n_valid)


def quant_pool_write_stacked(pool, scale, vals, write_block, write_offset,
                             active):
    """Quantize-at-commit write for the decode step (DESIGN.md §10): the
    narrow pool and its per-block per-head scale pool, updated together in
    place."""
    return ref.quant_pool_write_stacked_ref(pool, scale, vals, write_block,
                                            write_offset, active)


def quant_pool_write_chunk(pool, scale, vals, write_block, write_offset,
                           n_valid):
    """Quantize-at-commit write for the chunked prefill step (§10)."""
    return ref.quant_pool_write_chunk_ref(pool, scale, vals, write_block,
                                          write_offset, n_valid)


# ---------------------------------------------------------------------------

def paged_decode_attention(q, pool_k, pool_v, block_table, window_base,
                           seq_lens, slot_active, *, near_window, cur_k,
                           cur_v, far_k=None, far_v=None, far_table=None,
                           far_valid=None, k_scale=None, v_scale=None,
                           skip_extent=False, impl: str | None = None):
    """Returns (B, H, hd); with the far view (``far_*`` given) ``(out,
    far_util)``, as ``ref.paged_decode_attention_ref``. Narrow pools come
    with their scales ``k_scale``/``v_scale`` (P, KV)."""
    impl = impl or _DEFAULT_IMPL
    fn = (paged_attention.plain if impl == "plain"
          else paged_attention.paged_decode_attention)
    return fn(q, pool_k, pool_v, block_table, window_base, seq_lens,
              slot_active, near_window=near_window, cur_k=cur_k, cur_v=cur_v,
              far_k=far_k, far_v=far_v, far_table=far_table,
              far_valid=far_valid, k_scale=k_scale, v_scale=v_scale,
              skip_extent=skip_extent)


def chunked_prefill_attention(q, pool_k, pool_v, cur_k, cur_v, block_table,
                              window_base, start_pos, n_valid, *,
                              near_window, k_scale=None, v_scale=None,
                              skip_extent=False, impl: str | None = None):
    """Every slot's prompt-chunk attention in one call: paged pre-chunk
    context + in-chunk causal (the chunked prefill executor's core;
    DESIGN.md §3). q: (B, C, H, hd); narrow pools come with their scales."""
    impl = impl or _DEFAULT_IMPL
    fn = pfa.plain if impl == "plain" else pfa.chunked_prefill_attention
    return fn(q, pool_k, pool_v, cur_k, cur_v, block_table, window_base,
              start_pos, n_valid, near_window=near_window, k_scale=k_scale,
              v_scale=v_scale, skip_extent=skip_extent)


def prefill_attention(q, k, v, *, causal=True, window=None,
                      impl: str | None = None):
    """Dense full-sequence GQA attention (the encoder's): q (B, S, H, hd),
    k/v (B, S, KV, hd), optional causal and window masks."""
    impl = impl or _DEFAULT_IMPL
    if impl == "plain":
        pfa._check_window(window)
        return pfa.prefill_plain(q, k, v, causal=causal, window=window)
    return pfa.prefill_attention(q, k, v, causal=causal, window=window)


def farview_summarize(pool_k, pool_v, chunk_blocks, n_tokens, do_summarize,
                      impl: str | None = None):
    """A layer's K and V far-view summaries, ``(sk, sv)``: the mean of one
    completed chunk per slot, zeros where gated off; one kernel launch."""
    impl = impl or _DEFAULT_IMPL
    if impl == "plain":
        return (fvs.plain(pool_k, chunk_blocks, n_tokens, do_summarize),
                fvs.plain(pool_v, chunk_blocks, n_tokens, do_summarize))
    return fvs.farview_summarize(pool_k, pool_v, chunk_blocks, n_tokens,
                                 do_summarize)
