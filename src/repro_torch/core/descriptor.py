"""FrameDescriptor — the single per-step committed descriptor (paper §4.2).

The device consumes exactly one committed descriptor per decode step. The host
expresses all runtime variability (EOS churn, admission, window slide, far-view
selection) as *mapping edits* that the pager seals with one ``Frame`` commit;
the result is this fixed-shape tuple of int32 arrays. Step shapes never
change.

Granularity (paper's BLOCKALIGN): the pager allocates in *page blocks* of
``block_pages`` contiguous pages. The kernel-visible near-window table is a
block table, so each kernel loop step moves one burst-friendly block
(~tau bytes) instead of a fragmented page (DESIGN.md §2).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


# host side: numpy views into the flat commit buffer; device side: torch
# views into one int32 tensor (``unflatten_descriptor``)
Array = object


class FrameDescriptor(NamedTuple):
    """Fixed-shape, device-consumed view of one decode step.

    B = engine batch width (fixed), NB = near-window blocks (fixed),
    CAP = far-view cap (fixed), MT = max transport trains (fixed).
    All integer arrays are int32.
    """
    # --- near window (block granularity) ---
    block_table: Array     # (B, NB)  physical block ids, oldest->newest
    window_base: Array     # (B,)     absolute pos of block_table[:,0] token 0
    seq_lens: Array        # (B,)     logical length BEFORE this step's token
    slot_active: Array     # (B,)     1 if slot serves a live request
    # --- this step's KV write ---
    write_block: Array     # (B,)     physical block receiving the new K/V
    write_offset: Array    # (B,)     token offset within that block
    # --- merged transport trains (transport stats) ---
    train_start: Array     # (B, MT)  physical start block of each train
    train_len: Array       # (B, MT)  blocks per train (0 = unused)
    train_dst: Array       # (B, MT)  destination block offset in window
    # --- far view (optional policy; zero-filled when disabled) ---
    far_table: Array       # (B, CAP) chunk indices into per-slot far pool
    far_valid: Array       # (B, CAP) 1 if entry holds a real summary
    # far-view chunk summarization for THIS step (sealed in the same commit)
    far_chunk_blocks: Array  # (B, CB) blocks of the just-completed chunk
    far_chunk_tokens: Array  # (B,)    valid tokens in that chunk
    far_do_summarize: Array  # (B,)    1 if a chunk completed this step
    far_write_idx: Array     # (B,)    far-pool slot receiving the summary
    # --- commit metadata ---
    epoch: Array           # ()       frame epoch counter (single commit audit)

    @property
    def batch(self) -> int:
        return self.block_table.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.block_table.shape[1]


# ---------------------------------------------------------------------------
# flat descriptor packing (pipelined hot path; DESIGN.md §3)
# ---------------------------------------------------------------------------
# The engine assembles the descriptor in ONE persistent flat int32 buffer:
# every FrameDescriptor field is a numpy VIEW into it, so per-slot edits land
# in the flat buffer directly and the per-step host->device transfer is a
# single copy instead of one per field. The device step unpacks it with
# static slices (views, no copies). Field order is the NamedTuple order;
# ``epoch`` is a (1,) view host-side and a 0-d view device-side.

def _descriptor_layout(batch: int, n_blocks: int, cap: int, max_trains: int,
                       chunk_blocks: int):
    B = batch
    shapes = [
        ("block_table", (B, n_blocks)), ("window_base", (B,)),
        ("seq_lens", (B,)), ("slot_active", (B,)),
        ("write_block", (B,)), ("write_offset", (B,)),
        ("train_start", (B, max_trains)), ("train_len", (B, max_trains)),
        ("train_dst", (B, max_trains)),
        ("far_table", (B, cap)), ("far_valid", (B, cap)),
        ("far_chunk_blocks", (B, chunk_blocks)), ("far_chunk_tokens", (B,)),
        ("far_do_summarize", (B,)), ("far_write_idx", (B,)),
        ("epoch", ()),
    ]
    layout = []
    off = 0
    for name, shp in shapes:
        n = int(np.prod(shp)) if shp else 1
        layout.append((name, shp, off, off + n))
        off += n
    return layout, off


def descriptor_flat_size(batch: int, n_blocks: int, cap: int, max_trains: int,
                         chunk_blocks: int = 1) -> int:
    return _descriptor_layout(batch, n_blocks, cap, max_trains,
                              chunk_blocks)[1]


# host->device control plane appended AFTER the flat descriptor words in the
# engine's single per-step commit buffer (DESIGN.md §3/§13): three (B,) int32
# rows — host prompt tokens, the feed_sampled mask selecting device-side
# token feedback, and the per-slot request id the sampler folds into its
# per-step PRNG keys (rng meta: key = fold_in(fold_in(seed, rid), seq_len)).
# ONE host->device copy moves descriptor + control rows together.
N_CONTROL_ROWS = 3


def control_plane_size(batch: int) -> int:
    """Flat int32 words the engine appends after the descriptor."""
    return N_CONTROL_ROWS * batch


class ControlPlane(NamedTuple):
    """Numpy views of the three per-slot control rows inside the engine's
    flat commit buffer (host assembly side). Unpacks positionally in the
    row order the compiled step slices them back out."""
    host_tokens: np.ndarray      # (B,) prompt token fed where feed == 0
    feed_sampled: np.ndarray     # (B,) 1 = take the device-side feedback
    rids: np.ndarray             # (B,) request id (sampler PRNG meta, §13)


def control_plane_views(flat: np.ndarray, batch: int, *,
                        offset: int) -> ControlPlane:
    """ControlPlane of numpy VIEWS into ``flat`` starting at ``offset``
    (the descriptor words precede the control rows in the commit buffer)."""
    B = batch
    assert flat.dtype == np.int32 and flat.size >= offset + N_CONTROL_ROWS * B
    return ControlPlane(
        host_tokens=flat[offset:offset + B],
        feed_sampled=flat[offset + B:offset + 2 * B],
        rids=flat[offset + 2 * B:offset + 3 * B])


def refresh_control_row(cp: ControlPlane, slot: int, *, rid: int = 0) -> None:
    """Incremental control-row refresh for ONE slot that changes owner
    mid-pipeline (step-level admission, DESIGN.md §15).

    A slot freed by EOS retirement / cancel / preemption and refilled on
    the very next step flips exactly these three words: the rid row must
    carry the NEW owner before its first dispatch (the sampler folds it
    into every per-step PRNG key, so a stale rid would silently decode
    the predecessor's stream), and the token/feed words reset so the
    first step re-seeds from the host prompt rather than the
    predecessor's device-side feedback chain. Everything else in the
    committed descriptor is rebuilt per step or owned by the pager's
    frame edits — slot ownership changes never touch it."""
    cp.host_tokens[slot] = 0
    cp.feed_sampled[slot] = 0
    cp.rids[slot] = rid


def flat_descriptor_views(flat: np.ndarray, batch: int, n_blocks: int,
                          cap: int, max_trains: int,
                          chunk_blocks: int = 1) -> "FrameDescriptor":
    """FrameDescriptor of numpy VIEWS into ``flat`` (host assembly side)."""
    layout, total = _descriptor_layout(batch, n_blocks, cap, max_trains,
                                       chunk_blocks)
    assert flat.shape == (total,) and flat.dtype == np.int32
    fields = {}
    for name, shp, lo, hi in layout:
        v = flat[lo:hi]
        fields[name] = v.reshape(shp) if shp else v   # epoch: (1,) view
    return FrameDescriptor(**fields)


def unflatten_descriptor(flat: Array, batch: int, n_blocks: int,
                         cap: int, max_trains: int,
                         chunk_blocks: int = 1) -> "FrameDescriptor":
    """Device-side unpack: FrameDescriptor of torch views into ONE int32
    tensor (the committed flat buffer after its single host->device copy);
    static slices, no copies."""
    assert flat.dtype == torch.int32 and flat.dim() == 1
    layout, _ = _descriptor_layout(batch, n_blocks, cap, max_trains,
                                   chunk_blocks)
    fields = {}
    for name, shp, lo, hi in layout:
        v = flat[lo:hi]
        fields[name] = v.reshape(shp) if shp else v[0]
    return FrameDescriptor(**fields)


class PrefillChunkDescriptor(NamedTuple):
    """Fixed-shape view of one batched prompt-ingestion step (§3).

    B = engine batch width, C = chunk width, NB = near-window blocks — all
    fixed, same table geometry as the decode descriptor. Every slot row is
    processed every call (ONE dispatch per engine step, like the decode
    step); slots with nothing to ingest carry ``n_valid = 0`` and are fully
    masked. A P-token prompt is ingested in ceil((P-1)/C) chunks — the
    final prompt token always goes through the decode step so sampled-token
    semantics match the token-at-a-time path exactly. Chunks need not be
    block-aligned (aliased prefixes start mid-block): each chunk token
    carries its own (write_block, write_offset) pair; invalid (padded)
    tokens point at the scratch block 0. All integer arrays are int32.
    """
    tokens: Array          # (B, C)  prompt token ids (zero-padded)
    start_pos: Array       # (B,)    absolute position of tokens[b, 0]
    n_valid: Array         # (B,)    valid tokens in this chunk (<= C)
    block_table: Array     # (B, NB) window blocks covering [wb, start)
    window_base: Array     # (B,)    absolute pos of table[b,0] token 0
    write_block: Array     # (B, C)  physical block receiving token KV
    write_offset: Array    # (B, C)  token offset within that block


def _chunk_layout(batch: int, chunk: int, n_blocks: int):
    B = batch
    shapes = [("tokens", (B, chunk)), ("start_pos", (B,)), ("n_valid", (B,)),
              ("block_table", (B, n_blocks)), ("window_base", (B,)),
              ("write_block", (B, chunk)), ("write_offset", (B, chunk))]
    layout = []
    off = 0
    for name, shp in shapes:
        n = int(np.prod(shp))
        layout.append((name, shp, off, off + n))
        off += n
    return layout, off


def chunk_flat_size(batch: int, chunk: int, n_blocks: int) -> int:
    return _chunk_layout(batch, chunk, n_blocks)[1]


def flat_chunk_views(flat: np.ndarray, batch: int, chunk: int,
                     n_blocks: int) -> PrefillChunkDescriptor:
    """PrefillChunkDescriptor of numpy views into ``flat`` (host side)."""
    layout, total = _chunk_layout(batch, chunk, n_blocks)
    assert flat.shape == (total,) and flat.dtype == np.int32
    return PrefillChunkDescriptor(**{
        name: flat[lo:hi].reshape(shp) for name, shp, lo, hi in layout})


def unflatten_chunk_descriptor(flat: Array, batch: int, chunk: int,
                               n_blocks: int) -> PrefillChunkDescriptor:
    """Device-side unpack: torch views into one int32 tensor."""
    assert flat.dtype == torch.int32 and flat.dim() == 1
    layout, _ = _chunk_layout(batch, chunk, n_blocks)
    return PrefillChunkDescriptor(**{
        name: flat[lo:hi].reshape(shp) for name, shp, lo, hi in layout})


def active_block_extents(window_base, seq_lens, slot_active, *,
                         near_window: int, nb: int, bt: int):
    """Host-side (numpy) per-slot active window-block extents [lo, hi).

    The canonical descriptor-side derivation of the work-skipping kernel's
    trip counts (DESIGN.md §12): block i of slot b holds positions
    ``wb + i*bt .. wb + (i+1)*bt - 1``; only blocks intersecting
    ``(t - near_window, t] ∩ [0, inf)`` carry unmasked work, and retired
    slots (``slot_active == 0``) carry none. Must stay in lockstep with
    ``kernels/ref.py active_block_extent`` (the torch twin; the CUDA decode
    kernel derives the same extent in-kernel) — tests/test_kernel_skip.py asserts agreement.
    The engine's ``kernel_blocks_{total,skipped}`` audit counters integrate
    ``nb - (hi - lo)`` over participating slot-steps.

    Inputs are (B,) int arrays (descriptor views); returns int32 (lo, hi).
    """
    window_base = np.asarray(window_base, np.int64)
    seq_lens = np.asarray(seq_lens, np.int64)
    act = np.asarray(slot_active) > 0
    lo_pos = np.maximum(0, seq_lens + 1 - near_window)
    lo = (lo_pos - window_base) // bt
    hi = (seq_lens - window_base) // bt + 1
    lo = np.clip(np.where(act, lo, 0), 0, nb).astype(np.int32)
    hi = np.clip(np.where(act, hi, 0), 0, nb).astype(np.int32)
    return lo, np.maximum(hi, lo)
