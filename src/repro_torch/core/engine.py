"""KVRMEngine — fixed-shape decode serving under the descriptor transport
interface (paper §4), plus the static-arena baseline on the SAME executor.

Counterpart of ``repro/core/engine.py`` for the main path:

  * modes ``arena``, ``paged`` and ``paged_merge`` (one executor);
  * the synchronous step (``pipeline_depth=0``): per-slot descriptor
    assembly, one commit, one device step, one blocking readback;
  * legacy greedy decode with budget EOS;
  * step-level (continuous) admission, and the round-based baseline;
  * the chunked prefill executor (``prefill_chunk = C > 0``);
  * ``mode="full"``: the bounded far view (paper §4.4, DESIGN.md §5) —
    completed sv_chunks are summarized on the device and TRIMmed, and
    decode attends up to ``farview_cap`` summaries chosen by the host's
    utility EMA (``core/farview.py``). Prompts ride the decode step (the
    chunked prefill executor is off in this mode, as in the reference).

One step runs scheduler admission, then the pager's RESERVE/ALIAS/TRIM/
FRAME, then the merge-staged transport, and commits ONE flat int32 buffer
(descriptor + control rows) with ONE host->device copy; the device step
reads it through views (``unflatten_descriptor``). The paged attention
inside the step runs the hand-written CUDA kernels on the card
(``kernels/csrc``); the engine counts their launches in ``audit()``.

Features of the reference that the port does not have yet raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.descriptor import (active_block_extents,
                                         chunk_flat_size, control_plane_size,
                                         control_plane_views,
                                         descriptor_flat_size,
                                         flat_chunk_views,
                                         flat_descriptor_views,
                                         refresh_control_row,
                                         unflatten_chunk_descriptor,
                                         unflatten_descriptor)
from repro_torch.core.farview import FarViewPolicy
from repro_torch.core.pager import BlockPager
from repro_torch.core.scheduler import Request, Scheduler
from repro_torch.core.transport import MergeStagedTransport
from repro_torch.kernels import runtime
from repro_torch.models import registry

MODES = ("arena", "paged", "paged_merge", "full")


@dataclass
class EngineConfig:
    mode: str = "paged_merge"
    batch: int = 8                   # fixed slot width B
    max_seq: int = 512               # worst-case sequence length
    near_window: Optional[int] = None   # W* (kernel width); None = max_seq (dense)
    block_tokens: int = 16           # BLOCKALIGN quantum (tokens)
    pool_budget_frac: float = 1.0    # paged pool size vs worst case
    farview_cap: int = 16
    sv_chunk: int = 64
    span_blocks: int = 4             # placement span (BLOCKALIGN granularity)
    greedy: bool = True              # True = legacy argmax decode with pure
    #                                  budget-EOS (the only mode ported)
    # --- sampling knobs (greedy=False only) ---
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    sample_seed: int = 0
    debug_logits: bool = False       # capture per-step logits (tests only)
    # --- host/device overlap + chunked prefill (DESIGN.md §3) ---
    pipeline_depth: int = 0          # 0 = synchronous loop (the one ported;
    #                                  the default returns to 1 with depth >= 1)
    prefill_chunk: int = 0           # tokens per prefill-executor call (0 = off)
    # --- SPMD decode (DESIGN.md §4) ---
    mesh: Optional[object] = None
    # --- host KV tier + preemption-aware scheduling (DESIGN.md §8) ---
    host_pool_blocks: int = 0
    kv_oversubscribe: float = 1.0
    swap_high_watermark: float = 0.92
    swap_low_watermark: float = 0.80
    admit_watermark: float = 0.85
    # --- automatic shared-prefix KV reuse (radix prefix cache, §9) ---
    prefix_cache: bool = False
    prefix_cache_blocks: int = 0
    # --- quantized KV-block storage tier (DESIGN.md §10) ---
    kv_dtype: str = "bf16"
    # --- async movement engine (DESIGN.md §11) ---
    async_movement: bool = True
    # --- work-skipping kernels (DESIGN.md §12) ---
    kernel_skip_extent: bool = True  # per-slot active-extent loop bounds in
    #                                  the decode/prefill kernels; False =
    #                                  walk every window block (A/B)
    # --- step-level (continuous) batching (DESIGN.md §15) ---
    continuous_batching: bool = True


@dataclass
class StepMetrics:
    wall: float = 0.0
    host: float = 0.0                # control-plane time (submit+frame)
    frame_commit: float = 0.0
    dma_groups: int = 0
    active: int = 0
    emitted: int = 0


def _farview_conflict(ecfg: EngineConfig) -> Optional[str]:
    """The reference's ValueError for a feature ``mode="full"`` excludes
    (its words: summaries are stored full-width and are slot-indexed state
    that neither a swap nor a block alias carries)."""
    if ecfg.mode != "full":
        return None
    if ecfg.kv_dtype != "bf16":
        return ("kv_dtype != 'bf16' requires mode != 'full' "
                "(far-view summaries are stored full-width)")
    if ecfg.host_pool_blocks > 0 or ecfg.kv_oversubscribe > 1.0:
        return ("host KV tier requires a block-paged family "
                "(dense/vlm/moe) and mode != 'full'")
    if ecfg.prefix_cache:
        return ("prefix cache requires a paged mode (not 'arena' or "
                "'full') and a block-paged family (dense/vlm/moe)")
    return None


def _not_ported(ecfg: EngineConfig) -> Optional[str]:
    """Why this EngineConfig needs a feature the port does not have yet."""
    if ecfg.pipeline_depth >= 1:
        return ("pipeline_depth >= 1 (ROADMAP queue 1, item 6b: pipelined "
                "dispatch captured as a CUDA graph)")
    if not ecfg.greedy:
        return ("greedy=False (ROADMAP queue 1, items 5 and 6h: on-device "
                "sampling with detected EOS)")
    if ecfg.kv_dtype != "bf16":
        return f"kv_dtype={ecfg.kv_dtype!r} (ROADMAP queue 1, item 6f)"
    if ecfg.host_pool_blocks > 0 or ecfg.kv_oversubscribe > 1.0:
        return "a host KV tier (ROADMAP queue 1, item 6d)"
    if ecfg.prefix_cache:
        return "prefix_cache (ROADMAP queue 1, item 6e)"
    if ecfg.mesh is not None:
        return "mesh (ROADMAP queue 1, item 12)"
    return None


class KVRMEngine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *,
                 device=None):
        if ecfg.mode not in MODES:
            raise ValueError(f"mode {ecfg.mode!r} not in {MODES}")
        conflict = _farview_conflict(ecfg)
        if conflict is not None:
            raise ValueError(conflict)
        why = _not_ported(ecfg)
        if why is not None:
            raise NotImplementedError(f"the PyTorch port does not have {why}")
        self.device = runtime.resolve_device(device)
        self._host_tensors: Dict[int, torch.Tensor] = {}
        self.cfg = cfg
        self.params = params
        self.e = ecfg

        bt = ecfg.block_tokens
        self.bt = bt
        self.W = ecfg.near_window or ecfg.max_seq
        self.NB = -(-self.W // bt) + 1
        self.MT = self.NB + 1
        self.blocks_per_seq = -(-ecfg.max_seq // bt) + 1
        worst = ecfg.batch * self.blocks_per_seq
        if ecfg.mode == "arena":
            self.num_blocks = worst + 1
        else:
            # no host tier: every slot's near window stays device-resident
            floor = self.NB * ecfg.batch
            self.num_blocks = max(floor,
                                  int(worst * ecfg.pool_budget_frac)) + 1

        # per-layer payload bytes (transport accounting uses the real model)
        self.bytes_per_token = registry.paged_payload_bytes_per_token(
            cfg, ecfg.kv_dtype)
        self.block_bytes = bt * self.bytes_per_token
        self.farview = ecfg.mode == "full"
        self.cap = ecfg.farview_cap if self.farview else 1
        self.max_chunks = (-(-max(1, ecfg.max_seq - self.W) // ecfg.sv_chunk)
                           + 1 if self.farview else 0)
        self.chunk_blocks = max(1, ecfg.sv_chunk // bt)

        # --- device state ---
        self.pools = registry.init_decode_pools(
            cfg, batch=ecfg.batch, num_blocks=self.num_blocks,
            block_tokens=bt, max_chunks=self.max_chunks,
            kv_dtype=ecfg.kv_dtype, device=self.device)

        # --- host control plane ---
        self.sched = Scheduler(ecfg.batch)
        self.pager = (BlockPager(self.num_blocks, bt, self.block_bytes,
                                 span_blocks=ecfg.span_blocks,
                                 host_pool_blocks=0)
                      if ecfg.mode != "arena" else None)
        self.transport = MergeStagedTransport(
            block_bytes=self.block_bytes,
            merge_threshold_bytes=cfg.serving.merge_threshold_bytes,
            max_hold_steps=cfg.serving.max_hold_steps, max_trains=self.MT,
            dense_block_bytes=self.block_bytes)
        self.fv = (FarViewPolicy(ecfg.batch, self.max_chunks, self.cap,
                                 ecfg.sv_chunk, bt) if self.farview else None)
        self._rid_to_sid: Dict[int, int] = {}
        self._cow_pairs_step: List = []            # COW tail copies to run
        self._cow_origin: Dict[int, int] = {}      # this round: dst -> src

        # arena bookkeeping: slot -> fixed block range
        self._arena_base = [1 + i * self.blocks_per_seq for i in range(ecfg.batch)]
        self._slot_len = np.zeros(ecfg.batch, np.int64)   # tokens in cache
        self._slot_sid = -np.ones(ecfg.batch, np.int64)
        self._last_token = np.zeros(ecfg.batch, np.int64)

        # the model sees the engine's window and skip policy through its
        # serving config (as the reference's cfg_dec)
        self._cfg_dec = cfg.replace(serving=cfg.serving.__class__(
            page_size=cfg.serving.page_size, near_window=self.W,
            farview_cap=self.cap, sv_chunk=ecfg.sv_chunk,
            merge_threshold_bytes=cfg.serving.merge_threshold_bytes,
            max_hold_steps=cfg.serving.max_hold_steps,
            enable_farview=self.farview,
            skip_extent=ecfg.kernel_skip_extent))

        self.continuous_admits = 0
        self.slot_idle_steps_saved = 0
        self._mid_round = np.zeros(ecfg.batch, bool)

        B, NB, CAP, MT, CB = (ecfg.batch, self.NB, self.cap, self.MT,
                              self.chunk_blocks)
        self._flat_descr_size = descriptor_flat_size(B, NB, CAP, MT, CB)
        D = self._flat_descr_size
        self.debug_logits: List[np.ndarray] = []

        # --- chunked prefill executor (second fixed-shape step) ---
        self._chunked = (ecfg.prefill_chunk > 0
                         and registry.supports_chunked_prefill(cfg)
                         and not self.farview)
        self.chunk = int(ecfg.prefill_chunk) if self._chunked else 0
        if self._chunked:
            self._cflat = self._host_buffer(chunk_flat_size(B, self.chunk,
                                                            self.NB))
            self._cdescr = flat_chunk_views(self._cflat, B, self.chunk,
                                            self.NB)
        # below this many remaining prompt tokens, ingestion rides the decode
        # step instead (zero marginal steps while other slots decode).
        # Capped at a few blocks so an oversized C never disables chunking.
        self._chunk_min = (max(self.bt, min(self.chunk // 2, 4 * self.bt))
                           if self._chunked else 0)
        self._chunk_steps = 0            # slot-chunks ingested
        self._chunk_dispatches = 0       # chunk-step launches (all slots)
        self._chunk_wait = 0.0

        self._kernel_blocks_total = 0
        self._kernel_blocks_skipped = 0
        # hand-written kernel launches by this engine's device steps
        self._decode_launches = 0
        self._chunk_launches = 0
        self._farview_launches = 0

        # --- persistent flat commit buffer: descriptor + control rows.
        # numpy views into ONE (pinned, on the card) host buffer; one
        # host->device copy per step
        self._flat = self._host_buffer(D + control_plane_size(ecfg.batch))
        self._pdescr = flat_descriptor_views(self._flat[:D], B, NB, CAP, MT, CB)
        self._cp = control_plane_views(self._flat, B, offset=D)
        self._tokens_buf = self._cp.host_tokens
        self._merging = ecfg.mode != "paged"

        # metrics
        self.metrics: List[StepMetrics] = []
        self.frames_committed = 0
        self.steps_run = 0
        self.peak_reserved_kv = 0
        self.peak_active_kv = 0
        self.cum_wall = 0.0

    # ------------------------------------------------------------------
    def _host_buffer(self, n: int) -> np.ndarray:
        """A flat int32 host buffer (numpy view of a tensor), page-locked
        when the step runs on the card: one DMA per step, no staging copy."""
        t = torch.zeros(n, dtype=torch.int32)
        if self.device.type == "cuda":
            t = t.pin_memory()
        buf = t.numpy()
        self._host_tensors[id(buf)] = t
        return buf

    def _to_device(self, buf: np.ndarray) -> torch.Tensor:
        """Copy a committed host buffer to the device (a copy on the CPU
        too: the host buffer is edited again next step)."""
        return self._host_tensors[id(buf)].to(self.device, copy=True)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if getattr(req, "stop_tokens", ()):
            raise ValueError(
                "per-request stop_tokens require sampled decode "
                "(greedy=False); legacy greedy mode is budget-EOS only.")
        self.sched.submit(req)

    # ------------------------------------------------------------------
    def _admit(self, now: float) -> None:
        """Step-level admission gate (DESIGN.md §15): with continuous
        batching every call admits into the slots freed since the last
        step; the round-based baseline holds the scheduler at a barrier
        until the current round has fully drained."""
        if not self.e.continuous_batching and self.sched.active_slots():
            self.sched.admit(now, hold=True)
            return
        self._admit_into_free_slots(now)

    def _admit_into_free_slots(self, now: float) -> None:
        mid_round = bool(self.sched.active_slots())
        for slot, req, sid in self.sched.admit(now):
            refresh_control_row(self._cp, slot, rid=req.rid)
            if mid_round:
                self.continuous_admits += 1
                self._mid_round[slot] = True
            self._slot_len[slot] = 0
            self._last_token[slot] = int(req.prompt[0]) if len(req.prompt) else 0
            if self.pager is not None:
                self.pager.open_session(sid)
                self._slot_sid[slot] = sid
                if req.prefix_of is not None and req.prefix_len >= self.bt:
                    # legacy explicit hint path (trace-provided prefix_of)
                    src_sid = self._rid_to_sid.get(req.prefix_of)
                    if src_sid is not None and src_sid in self.pager.sessions \
                            and self._alias_src_resident(src_sid,
                                                         req.prefix_len):
                        self.pager.alias(src_sid, sid, req.prefix_len)
                        self._capture_cow(sid)
                        self._slot_len[slot] = self.pager.sessions[sid].length
                        req.prompt_pos = int(self._slot_len[slot])
                self._rid_to_sid[req.rid] = sid
            if self.fv is not None:
                self.fv.reset_slot(slot)
        if self._cow_pairs_step:
            # materialize this admit round's COW tails: one batched copy
            pairs, self._cow_pairs_step = self._cow_pairs_step, []
            self._cow_origin.clear()
            self.transport.account_cow(pairs)
            self._cow_copy(pairs)

    def _capture_cow(self, sid: int) -> None:
        """Queue a fresh alias's COW tail copy for this admit round (chained
        same-round aliases copy from the transitive origin block)."""
        cp = self.pager.sessions[sid].cow_pending
        if cp is not None:
            src, dst = cp
            src = self._cow_origin.get(src, src)
            self._cow_origin[dst] = src
            self._cow_pairs_step.append((src, dst))

    def _cow_copy(self, pairs) -> None:
        """Whole-block COW tail copies, all layers, in place."""
        src = torch.tensor([p[0] for p in pairs], device=self.device)
        dst = torch.tensor([p[1] for p in pairs], device=self.device)
        for k in ("k", "v"):
            self.pools[k][:, dst] = self.pools[k][:, src]

    def _alias_src_resident(self, src_sid: int, prefix_len: int) -> bool:
        """The alias source must have COMMITTED the shared prefix (a source
        admitted in the same step has written nothing yet)."""
        s = self.pager.sessions[src_sid]
        nb = prefix_len // self.bt + (1 if prefix_len % self.bt else 0)
        return (s.length >= prefix_len and len(s.blocks) >= nb
                and all(b > 0 for b in s.blocks[:nb]))

    # ------------------------------------------------------------------
    def _window_blocks(self, slot: int) -> (List[int], int):
        """Physical blocks covering the near window + window_base (tokens)."""
        t = int(self._slot_len[slot])              # position of current token
        lo = max(0, t + 1 - self.W)
        wb = (lo // self.bt) * self.bt
        if self.e.mode == "arena":
            base = self._arena_base[slot]
            first = wb // self.bt
            return [base + first + i for i in range(self.NB)], wb
        sid = int(self._slot_sid[slot])
        s = self.pager.sessions[sid]
        first_local = self._first_window_local(s, t)
        wb = (first_local + s.trimmed_prefix_blocks) * self.bt
        blocks = s.blocks[first_local:first_local + self.NB]
        assert all(b > 0 for b in blocks), \
            f"unallocated block in window: sid={sid} {blocks}"
        return blocks + [0] * (self.NB - len(blocks)), wb

    def _first_window_local(self, s, t: int) -> int:
        """Local block index where the near window starts for a session at
        logical length t (same math as _window_blocks)."""
        wb = (max(0, t + 1 - self.W) // self.bt) * self.bt
        wb = max(wb, s.trimmed_prefix_blocks * self.bt)
        return wb // self.bt - s.trimmed_prefix_blocks

    # ------------------------------------------------------------------
    def _farview_step(self, slot: int, t: int, descr) -> None:
        """Far-view policy for one slot/step: summarize + TRIM a completed
        chunk (sealed in this step's commit) and select the far table."""
        sid = int(self._slot_sid[slot])
        s = self.pager.sessions[sid]
        n_done = int(self.fv.n_chunks[slot])
        chunk_end = (n_done + 1) * self.e.sv_chunk
        if t + 1 - self.W >= chunk_end:
            first_local = (n_done * self.e.sv_chunk) // self.bt \
                - s.trimmed_prefix_blocks
            cb = s.blocks[first_local:first_local + self.chunk_blocks]
            descr.far_chunk_blocks[slot, :len(cb)] = cb
            descr.far_chunk_tokens[slot] = self.e.sv_chunk
            descr.far_do_summarize[slot] = 1
            descr.far_write_idx[slot] = self.fv.on_chunk_summarized(slot)
            # TRIM the summarized blocks (bounded budget); the device step
            # reads them before its post-loop pool write
            self.pager.trim(sid, prefix_blocks=first_local + self.chunk_blocks)
        tbl, val = self.fv.select(slot)
        descr.far_table[slot] = tbl
        descr.far_valid[slot] = val

    # ------------------------------------------------------------------
    def _retire_slot(self, slot: int) -> None:
        """EOS retirement: return the slot + its blocks, clear caches."""
        req = self.sched.requests[self.sched.slots[slot].rid]
        req.finish_wall = self.cum_wall
        if not req.finish_reason:
            req.finish_reason = "budget"
        self.sched.retire(slot)
        if self.pager is not None:
            self.pager.trim(int(self._slot_sid[slot]), close=True)
            self._slot_sid[slot] = -1
        self._slot_len[slot] = 0
        self._mid_round[slot] = False
        refresh_control_row(self._cp, slot, rid=0)

    # ------------------------------------------------------------------
    def _prefill_chunks(self) -> None:
        """Ingest up to ``prefill_chunk`` prompt tokens per prefilling slot
        through the batched chunked prefill executor: ONE dispatch per
        engine step covering every slot with chunk work (idle slot rows are
        masked by n_valid=0). Reservations are sealed by THIS step's single
        frame commit."""
        C = self.chunk
        cd = self._cdescr
        self._chunk_wait = 0.0
        any_chunk = False
        for slot in self.sched.active_slots():
            if self.sched.chunk_remaining(slot) < self._chunk_min:
                continue
            if not any_chunk:
                cd.n_valid[:] = 0
                any_chunk = True
            toks = self.sched.consume_prompt_chunk(slot, C)
            n = len(toks)
            t0 = int(self._slot_len[slot])
            if self.e.mode == "arena":
                base = self._arena_base[slot]
                idx = t0 + np.arange(n)
                wblk = (base + idx // self.bt).astype(np.int32)
                woff = (idx % self.bt).astype(np.int32)
            else:
                sid = int(self._slot_sid[slot])
                self.pager.reserve(sid, n)
                wblk, woff = self.pager.append_tokens(sid, n)
            # context = the near window as seen by the chunk's FIRST query;
            # later queries only need a suffix of it (masked in-kernel)
            blocks, wb = self._window_blocks(slot)
            cd.tokens[slot, :n] = toks
            cd.tokens[slot, n:] = 0
            cd.start_pos[slot] = t0
            cd.n_valid[slot] = n
            cd.block_table[slot] = blocks
            cd.window_base[slot] = wb
            cd.write_block[slot, :n] = wblk
            cd.write_block[slot, n:] = 0
            cd.write_offset[slot, :n] = woff
            cd.write_offset[slot, n:] = 0
            self._slot_len[slot] += n
            self._chunk_steps += 1
        if any_chunk:
            td = time.perf_counter()
            cdescr = unflatten_chunk_descriptor(
                self._to_device(self._cflat), self.e.batch, C, self.NB)
            before = runtime.LAUNCHES["chunked_prefill"]
            self.pools = registry.prefill_chunk(self.params, self._cfg_dec,
                                                self.pools, cdescr)
            self._chunk_launches += runtime.LAUNCHES["chunked_prefill"] - before
            self._chunk_dispatches += 1
            self._chunk_wait = time.perf_counter() - td

    # ------------------------------------------------------------------
    def step(self, now: float = float("inf")) -> StepMetrics:
        return self._step_sync(now)

    def _account_kernel_blocks(self, window_base, seq_lens, slot_active):
        """Integrate the decode kernel's walked-vs-skipped window blocks over
        this step's participating slots (descriptor-side host math, the
        same extent the kernel derives)."""
        n = len(window_base)
        if n == 0:
            return
        self._kernel_blocks_total += self.NB * n
        if self.e.kernel_skip_extent:
            lo, hi = active_block_extents(
                window_base, seq_lens, slot_active,
                near_window=self.W, nb=self.NB, bt=self.bt)
            self._kernel_blocks_skipped += int((self.NB - (hi - lo)).sum())

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _step_sync(self, now: float) -> StepMetrics:
        """Synchronous step: per-slot descriptor assembly, one commit, one
        blocking readback (the reference's pipeline_depth=0 path)."""
        t0 = time.perf_counter()
        m = StepMetrics()
        self.sched.step_idx = self.steps_run

        self._admit(now)
        if self._chunked:
            self._prefill_chunks()
        active = self.sched.active_slots()
        m.active = len(active)

        B = self.e.batch
        D = self._flat_descr_size
        self._flat[:D] = 0               # a fresh (empty) descriptor
        descr = self._pdescr
        tokens = self._tokens_buf
        tokens[:] = 0

        parts = []                       # slots participating in this step
        for slot in active:
            req = self.sched.request_at(slot)
            if req is None:
                continue
            if self._chunked and \
                    self.sched.chunk_remaining(slot) >= self._chunk_min:
                continue                 # still mid-chunk: no decode this step
            parts.append(slot)
            tokens[slot] = self.sched.next_token(slot, int(self._last_token[slot]))
            t = int(self._slot_len[slot])
            descr.seq_lens[slot] = t
            descr.slot_active[slot] = 1

            # ---- Stage: BLOCKALIGN reservation (prefetch-1 lookahead)
            if self.e.mode == "arena":
                base = self._arena_base[slot]
                bi, off = divmod(t, self.bt)
                descr.write_block[slot] = base + bi
                descr.write_offset[slot] = off
            else:
                sid = int(self._slot_sid[slot])
                self.pager.reserve(sid, 2)        # this token + lookahead
                blk, off = self.pager.append_token(sid)
                descr.write_block[slot] = blk
                descr.write_offset[slot] = off

            # ---- far-view: chunk completion -> summarize + trim
            if self.fv is not None:
                self._farview_step(slot, t, descr)

            # ---- window table + Reduce (train merging)
            blocks, wb = self._window_blocks(slot)
            descr.block_table[slot, :len(blocks)] = blocks
            descr.window_base[slot] = wb
            trains, groups = self.transport.reduce(
                blocks, far_blocks=int(descr.far_valid[slot].sum() > 0),
                merging=self._merging)
            self.transport.fill_train_arrays(
                trains, descr.train_start, descr.train_len, descr.train_dst,
                slot)
            m.dma_groups += groups

        if parts:
            self._account_kernel_blocks(descr.window_base[parts],
                                        descr.seq_lens[parts],
                                        descr.slot_active[parts])
            self.slot_idle_steps_saved += int(self._mid_round[parts].sum())

        # ---- Frame: single atomic commit
        tf0 = time.perf_counter()
        if self.pager is not None:
            frame = self.pager.frame()
            descr.epoch[...] = frame["epoch"]
            self.frames_committed += 1
        else:
            descr.epoch[...] = self.steps_run + 1
        m.frame_commit = time.perf_counter() - tf0

        flat = self._to_device(self._flat)        # ONE host->device copy
        ddescr = unflatten_descriptor(flat[:D], B, self.NB, self.cap, self.MT,
                                      self.chunk_blocks)
        dtokens = flat[D:D + B]
        m.host = max(0.0, time.perf_counter() - t0 - self._chunk_wait)

        # ---- device: one step, fixed shapes
        self.transport.note_dispatch_overlap()
        before = dict(runtime.LAUNCHES)
        logits, self.pools, fu = registry.decode_step(
            self.params, self._cfg_dec, dtokens, self.pools, ddescr)
        self._decode_launches += runtime.LAUNCHES["paged_decode"] \
            - before["paged_decode"]
        self._farview_launches += runtime.LAUNCHES["farview_summarize"] \
            - before["farview_summarize"]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if fu is None:
            nxt = nxt.cpu().numpy()
        else:
            # ONE blocking readback: the tokens and the far utility (its f32
            # bits carried as int32)
            back = torch.cat([nxt, fu.view(torch.int32).reshape(-1)]
                             ).cpu().numpy()
            nxt, fu = back[:B], back[B:].view(np.float32).reshape(B, self.cap)
        lg = None
        if self.e.debug_logits:
            lg = logits.float().cpu().numpy()
            self.debug_logits.append(lg)

        # ---- post: bookkeeping, EOS retirement (burst-safe)
        for slot in parts:
            self._slot_len[slot] += 1
            if self.sched.is_prefilling(slot):
                continue
            self._last_token[slot] = int(nxt[slot])
            req_s = self.sched.request_at(slot)
            if req_s is not None and req_s.first_token_step < 0:
                req_s.ttft_wall = self.cum_wall
            if lg is not None:
                if not hasattr(req_s, "logit_trace"):
                    req_s.logit_trace = []
                req_s.logit_trace.append(lg[slot])
            done = self.sched.record_output(slot, int(nxt[slot]))
            m.emitted += 1
            if done:
                self._retire_slot(slot)
        if self.fv is not None:
            self.fv.observe_utility(fu, descr.far_table)

        self.steps_run += 1
        m.wall = time.perf_counter() - t0
        self.cum_wall += m.wall
        self.peak_reserved_kv = max(self.peak_reserved_kv, self.reserved_kv_bytes())
        self.peak_active_kv = max(self.peak_active_kv, self.active_kv_bytes())
        self.metrics.append(m)
        return m

    def flush(self) -> None:
        """The synchronous step reads back every token it dispatches: there
        is no pipeline to drain."""

    # ------------------------------------------------------------------
    def run(self, max_steps: int = 10_000, now_fn=None) -> None:
        while (self.sched.waiting or self.sched.preempted
               or self.sched.active_slots()) and self.steps_run < max_steps:
            self.step(now=now_fn() if now_fn else float("inf"))
        self.flush()

    # ------------------------------------------------------------------
    # audits & metrics
    # ------------------------------------------------------------------
    def audit(self) -> dict:
        """The reference's ``audit()`` keys for the features the port has,
        plus the hand-written kernels' launch counts."""
        steps = [m for m in self.metrics if m.active > 0]
        walls = np.array([m.wall for m in steps]) if steps else np.zeros(1)
        hosts = np.array([m.host for m in steps]) if steps else np.zeros(1)
        commits = np.array([m.frame_commit for m in steps]) if steps else np.zeros(1)
        st = self.transport.stats
        return {
            "mode": self.e.mode,
            "steps": len(steps),
            "pipeline_depth": 0,
            "prefill_chunk": self.chunk,
            "prefill_chunks_run": self._chunk_steps,
            "single_commit_per_step": (self.pager is None
                                       or self.frames_committed == self.steps_run),
            "frames_committed": self.frames_committed,
            "submit_share": float(hosts.sum() / max(walls.sum(), 1e-12)),
            "frame_commit_us": float(commits.mean() * 1e6),
            "dma_groups_per_step": st.groups_per_step,
            "avg_dma_bytes": st.avg_group_bytes,
            "unmerged_groups_per_step": st.unmerged_groups_per_step,
            "train_overflows": st.train_overflows,
            "reserved_kv_bytes": self.reserved_kv_bytes(),
            "active_kv_bytes": self.active_kv_bytes(),
            "peak_reserved_kv": self.peak_reserved_kv,
            "peak_active_kv": self.peak_active_kv,
            "kernel_skip_extent": bool(self.e.kernel_skip_extent),
            "kernel_blocks_total": self._kernel_blocks_total,
            "kernel_blocks_skipped": self._kernel_blocks_skipped,
            "greedy": bool(self.e.greedy),
            "admit_blocked_no_slot": self.sched.admit_blocked["no_slot"],
            "admit_blocked_kv_watermark":
                self.sched.admit_blocked["kv_watermark"],
            "continuous_batching": bool(self.e.continuous_batching),
            "continuous_admits": self.continuous_admits,
            "slot_idle_steps_saved": self.slot_idle_steps_saved,
            "admit_blocked_round_barrier":
                self.sched.admit_blocked["round_barrier"],
            "cow_copies": st.cow_blocks,
            "cow_groups": st.cow_groups,
            "cow_bytes": st.cow_bytes,
            "kv_dtype": self.e.kv_dtype,
            "decode_kernel_launches": self._decode_launches,
            "chunk_kernel_launches": self._chunk_launches,
            "farview_kernel_launches": self._farview_launches,
        }

    def reserved_kv_bytes(self) -> int:
        n_layers = max(1, registry.n_paged_layers(self.cfg))
        if self.e.mode == "arena":
            return (self.num_blocks - 1) * self.block_bytes * n_layers
        return self.pager.reserved_bytes() * n_layers

    def active_kv_bytes(self) -> int:
        n_layers = max(1, registry.n_paged_layers(self.cfg))
        if self.e.mode == "arena":
            return int(self._slot_len.sum()) * self.bytes_per_token * n_layers
        return self.pager.active_tokens() * self.bytes_per_token * n_layers

    def latency_stats(self, skip: int = 3) -> dict:
        active = [m for m in self.metrics if m.active > 0]
        walls = np.array([m.wall for m in active[skip:]])
        if walls.size == 0:
            walls = np.array([m.wall for m in active]) if active else np.zeros(1)
        q = lambda p: float(np.percentile(walls * 1e3, p))
        return {"p50_ms": q(50), "p95_ms": q(95), "p99_ms": q(99),
                "p999_ms": q(99.9), "mean_ms": float(walls.mean() * 1e3),
                "max_ms": float(walls.max() * 1e3)}

    def throughput(self, skip: int = 3) -> float:
        steps = [m for m in self.metrics if m.active > 0][skip:]
        if not steps:
            steps = [m for m in self.metrics if m.active > 0]
        tok = sum(m.emitted for m in steps)
        wall = sum(m.wall for m in steps)
        return tok / max(wall, 1e-12)
