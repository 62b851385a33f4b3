"""Merge-staged descriptor transport (paper §4.3, Algorithm 1).

Three phases per step:
  Shift  — advance the near-window view, apply alias/COW/EOS edits (pager).
  Stage  — BLOCKALIGN the lookahead set S_{t+1}, materialize page descriptors,
           prefetch-1 (next block reserved adjacent to the tail).
  Reduce — greedily merge adjacent descriptors into trains until the size
           threshold tau (~128 KiB) or the age cutoff delta, then emit a
           near-window train (and, when enabled, one far-view train).

On TPU the emitted trains are the HBM->VMEM copy schedule consumed by the
Pallas kernel (train_start/train_len/train_dst in the FrameDescriptor); the
same structures give the DMA statistics the paper audits (groups per step,
average merged transfer size).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class TransportStats:
    steps: int = 0
    total_groups: int = 0
    total_bytes: int = 0
    max_groups: int = 0
    unmerged_groups: int = 0      # what the group count would be w/o merging
    held_descriptors: int = 0     # staged but deferred (age < delta)
    train_overflows: int = 0      # slots whose trains exceeded MT (stress)
    # --- host-tier swap traffic (DESIGN.md §8): swaps ride the same
    # large-copy discipline as window trains — coalesced into groups
    # contiguous in BOTH source and destination coordinates ---
    swap_groups: int = 0          # merged host<->device copy groups
    swap_unmerged: int = 0        # blocks moved (group count w/o merging)
    swap_out_bytes: int = 0       # device -> host
    swap_in_bytes: int = 0        # host -> device
    # --- COW tail copies (prefix aliasing, DESIGN.md §9): device-side
    # block copies materializing the partial tail of an aliased prefix —
    # their own group kind so prefix-reuse traffic is auditable apart
    # from window trains and swaps ---
    cow_groups: int = 0           # merged copy groups executed
    cow_blocks: int = 0           # blocks copied (1 per unaligned alias)
    cow_bytes: int = 0
    # --- quantized KV tier (DESIGN.md §10): bytes every accounted block
    # movement (window trains, swaps, COW copies) saved vs full bf16
    # width; 0 when the pools store bf16 ---
    quant_bytes_saved: int = 0
    # --- async movement engine (DESIGN.md §11): deferred swap-out
    # readbacks ride a per-transfer fence table; these witness that the
    # overlap actually happened (all zero when async_movement is off) ---
    overlap_steps: int = 0        # steps dispatched with >= 1 fence pending
    deferred_readbacks: int = 0   # swap-out transfers synchronized lazily
    staging_reuse_bytes: int = 0  # bytes staged through reused host buffers

    @property
    def groups_per_step(self) -> float:
        return self.total_groups / max(1, self.steps)

    @property
    def avg_group_bytes(self) -> float:
        return self.total_bytes / max(1, self.total_groups)

    @property
    def unmerged_groups_per_step(self) -> float:
        return self.unmerged_groups / max(1, self.steps)

    @property
    def swap_bytes(self) -> int:
        return self.swap_out_bytes + self.swap_in_bytes

    @property
    def avg_swap_group_blocks(self) -> float:
        return self.swap_unmerged / max(1, self.swap_groups)


@dataclass
class StagedDescriptor:
    block: int
    dst: int          # destination window slot (block index in window)
    age: int = 0      # steps held


def merge_swap_pairs(pairs: Sequence[Tuple[int, int]]
                     ) -> List[Tuple[int, int, int]]:
    """Coalesce (src_block, dst_block) swap copy pairs into maximal
    (src_start, dst_start, len) groups contiguous in BOTH coordinates —
    the same large-copy discipline as window trains (§2), applied to
    host<->device swap traffic (DESIGN.md §8). Pair order is preserved:
    the pager emits swap pairs oldest-block-first and allocates host slots
    lowest-first, so both sides are usually long runs."""
    groups: List[Tuple[int, int, int]] = []
    i, n = 0, len(pairs)
    while i < n:
        s0, d0 = pairs[i]
        ln = 1
        while (i + ln < n and pairs[i + ln][0] == s0 + ln
               and pairs[i + ln][1] == d0 + ln):
            ln += 1
        groups.append((s0, d0, ln))
        i += ln
    return groups


def merge_runs(blocks: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Greedy merge of a window block list into (start, len, dst) trains.
    A train is a maximal physically-contiguous run in window order."""
    trains: List[Tuple[int, int, int]] = []
    i = 0
    n = len(blocks)
    while i < n:
        start = blocks[i]
        dst = i
        ln = 1
        while i + ln < n and blocks[i + ln] == start + ln:
            ln += 1
        trains.append((start, ln, dst))
        i += ln
    return trains


class MergeStagedTransport:
    def __init__(self, *, block_bytes: int, merge_threshold_bytes: int,
                 max_hold_steps: int, max_trains: int,
                 dense_block_bytes: int = 0):
        self.block_bytes = block_bytes
        # bf16-width cost of the same block (quantized tier, DESIGN.md §10):
        # every accounted block movement adds the difference to
        # ``quant_bytes_saved``; defaults to block_bytes (no savings)
        self.dense_block_bytes = max(dense_block_bytes, block_bytes)
        self.tau = merge_threshold_bytes
        self.delta = max_hold_steps
        self.max_trains = max_trains
        self.stats = TransportStats()
        self._staged: List[StagedDescriptor] = []
        # per-transfer fence table (async movement, DESIGN.md §11):
        # fence id -> opaque payload (the engine parks its un-synchronized
        # device gathers here). Insertion-ordered: drains are FIFO so a
        # host slot freed and reallocated between two transfers takes the
        # LATER transfer's bytes, exactly like the synchronous schedule.
        self._fences: dict = {}
        self._next_fence = 0

    def _account_quant_saving(self, n_blocks: int) -> None:
        self.stats.quant_bytes_saved += (
            n_blocks * (self.dense_block_bytes - self.block_bytes))

    # -- Stage -----------------------------------------------------------
    def stage(self, descriptors: List[StagedDescriptor]) -> None:
        for d in descriptors:
            self._staged.append(d)
        self.stats.held_descriptors += len(descriptors)

    # -- per-transfer fences (async movement engine, DESIGN.md §11) ------
    def fence_issue(self, payload) -> int:
        """Park one issued-but-unsynchronized transfer. The payload is
        engine-owned (device gather handles + destination host slots);
        the transport only tracks ordering and the audit counters."""
        fid = self._next_fence
        self._next_fence += 1
        self._fences[fid] = payload
        return fid

    def fence_drain_all(self) -> List:
        """Take every pending transfer, FIFO. Each drained fence is by
        construction a readback that happened LATER than its issue point,
        so the count lands in ``deferred_readbacks``."""
        if not self._fences:
            return []
        payloads = list(self._fences.values())
        self._fences.clear()
        self.stats.deferred_readbacks += len(payloads)
        return payloads

    def fences_pending(self) -> int:
        return len(self._fences)

    def note_dispatch_overlap(self) -> None:
        """Engine hook at device-dispatch time: a step issued while >= 1
        swap-out fence is still pending means the transfer is genuinely
        overlapping compute (the latency-hiding audit)."""
        if self._fences:
            self.stats.overlap_steps += 1

    def account_staging_reuse(self, nbytes: int) -> None:
        self.stats.staging_reuse_bytes += int(nbytes)

    # -- swap groups (host tier, DESIGN.md §8) ---------------------------
    def account_swap(self, pairs: Sequence[Tuple[int, int]], *,
                     direction: str) -> List[Tuple[int, int, int]]:
        """Coalesce one swap transfer's copy pairs into merged groups and
        fold them into the transport audit. ``direction`` is 'out'
        (device -> host) or 'in' (host -> device). Returns the merged
        (src_start, dst_start, len) groups — the copy program the engine
        executes as ONE gather/scatter per swap event."""
        assert direction in ("out", "in")
        groups = merge_swap_pairs(pairs)
        nbytes = len(pairs) * self.block_bytes
        self.stats.swap_groups += len(groups)
        self.stats.swap_unmerged += len(pairs)
        if direction == "out":
            self.stats.swap_out_bytes += nbytes
        else:
            self.stats.swap_in_bytes += nbytes
        self._account_quant_saving(len(pairs))
        return groups

    # -- COW tail copies (prefix cache, DESIGN.md §9) --------------------
    def account_cow(self, pairs: Sequence[Tuple[int, int]]) -> None:
        """Fold one admit round's COW tail copies ((src_block, dst_block),
        device -> device) into the audit as their own group kind. The
        engine executes the pairs as ONE batched padded copy per pool key;
        ``cow_groups`` additionally records how many contiguous-in-both-
        coordinates runs the pairs form (same layout-quality audit basis
        as ``swap_groups``), not a separately executed schedule."""
        self.stats.cow_groups += len(merge_swap_pairs(list(pairs)))
        self.stats.cow_blocks += len(pairs)
        self.stats.cow_bytes += len(pairs) * self.block_bytes
        self._account_quant_saving(len(pairs))

    # -- Reduce ----------------------------------------------------------
    def reduce(self, window_blocks: Sequence[int], *,
               far_blocks: int = 0, merging: bool = True
               ) -> Tuple[List[Tuple[int, int, int]], int]:
        """Merge one slot's window into trains. Returns (trains, n_groups).

        merging=False models the unmerged path (one group per block) for the
        paper's with/without-descriptor-merging comparison.
        """
        blocks = [b for b in window_blocks if b > 0]
        # fold staged descriptors whose age exceeded delta or that are
        # adjacent to the window tail (merge into the tail train)
        ready = []
        still = []
        for d in self._staged:
            d.age += 1
            if d.age >= self.delta or (blocks and d.block == blocks[-1] + 1):
                ready.append(d)
            else:
                still.append(d)
        self._staged = still
        self.stats.held_descriptors -= len(ready)
        blocks = blocks + [d.block for d in ready]

        trains = self.merge_slot(blocks, merging=merging)

        groups = len(trains) + (1 if far_blocks else 0)
        self.stats.steps += 1
        self.stats.total_groups += groups
        self.stats.max_groups = max(self.stats.max_groups, groups)
        self.stats.total_bytes += (len(blocks) * self.block_bytes
                                   + far_blocks * self.block_bytes)
        self.stats.unmerged_groups += len(blocks) + far_blocks
        self._account_quant_saving(len(blocks) + far_blocks)
        return trains, groups

    def merge_slot(self, blocks: Sequence[int], *, merging: bool = True
                   ) -> List[Tuple[int, int, int]]:
        """Pure train merge for one slot's window blocks — no stats, no staged
        descriptor aging. The engine's window-block cache calls this only when
        a slot's window actually changed (admit/trim/alias/reserve/slide) and
        accounts the cached result each step via ``account_batch``."""
        if merging:
            trains = merge_runs(blocks)
            # split over-tau trains so each group stays a burst-sized DMA;
            # tau is a threshold, not a cap — modest overshoot is expected
            # (paper: ~132 KiB average vs 128 KiB threshold)
            max_blocks = max(1, (2 * self.tau) // self.block_bytes)
            out = []
            for s, ln, dst in trains:
                while ln > max_blocks:
                    out.append((s, max_blocks, dst))
                    s, ln, dst = s + max_blocks, ln - max_blocks, dst + max_blocks
                out.append((s, ln, dst))
            return out
        return [(b, 1, i) for i, b in enumerate(blocks)]

    # -- batched Reduce (vectorized descriptor assembly) -----------------
    def reduce_batch(self, blocks_per_row: List[Sequence[int]], *,
                     merging: bool = True) -> List[List[Tuple[int, int, int]]]:
        """Merge many slots' windows at once (no stats side effects).

        Staged descriptors are a per-slot aging mechanism and are not folded
        here; callers that stage() must use the per-slot reduce() path."""
        return [self.merge_slot(b, merging=merging) for b in blocks_per_row]

    def account_batch(self, n_blocks, n_groups, far_flags) -> None:
        """Accumulate one engine step's per-slot DMA stats (numpy vectors over
        the ACTIVE slots). Matches reduce()'s accounting exactly: one stats
        'step' per active slot per engine step."""
        n_blocks = np.asarray(n_blocks, np.int64)
        n_groups = np.asarray(n_groups, np.int64)
        far_flags = np.asarray(far_flags, np.int64)
        if n_blocks.size == 0:
            return
        groups = n_groups + far_flags
        self.stats.steps += int(n_blocks.size)
        self.stats.total_groups += int(groups.sum())
        self.stats.max_groups = max(self.stats.max_groups, int(groups.max()))
        self.stats.total_bytes += int((n_blocks + far_flags).sum()) * self.block_bytes
        self.stats.unmerged_groups += int((n_blocks + far_flags).sum())
        self._account_quant_saving(int((n_blocks + far_flags).sum()))

    def unaccount_slot(self, n_blocks: int, n_groups: int,
                       far_flag: int = 0) -> None:
        """Reverse ONE slot-step of ``account_batch`` (lagged-EOS overshoot
        reconcile, DESIGN.md §13): a pipelined dispatch accounted this
        slot's window DMA before the readback revealed the request had
        already stopped, so subtract exactly what that dispatch added.
        ``max_groups`` is a monotone high-water mark and is left alone."""
        blocks = int(n_blocks) + int(far_flag)
        self.stats.steps -= 1
        self.stats.total_groups -= int(n_groups) + int(far_flag)
        self.stats.total_bytes -= blocks * self.block_bytes
        self.stats.unmerged_groups -= blocks
        self._account_quant_saving(-blocks)

    def fill_train_arrays(self, trains: List[Tuple[int, int, int]],
                          train_start: np.ndarray, train_len: np.ndarray,
                          train_dst: np.ndarray, row: int) -> None:
        """Write one slot's trains into the descriptor arrays (fixed MT).

        Overflow (more trains than MT — only possible under stress, e.g. many
        staged folds or adversarial fragmentation): the first MT-1 trains are
        emitted normally and the last slot becomes an explicit DEGENERATE
        sentinel ``train_start = -1`` whose ``train_len`` is the total block
        count of the folded remainder. The remainder trains are generally not
        physically contiguous, so no single (start, len) copy describes them;
        the sentinel tells the device to fall back to per-block gather via
        ``block_table`` for those window positions (``train_dst`` marks the
        first such position). Coverage accounting (sum of train_len) is
        preserved and the event is counted in ``TransportStats``."""
        mt = train_start.shape[1]
        train_len[row, :] = 0
        if len(trains) <= mt:
            for j, (s, ln, dst) in enumerate(trains):
                train_start[row, j] = s
                train_len[row, j] = ln
                train_dst[row, j] = dst
            return
        for j, (s, ln, dst) in enumerate(trains[:mt - 1]):
            train_start[row, j] = s
            train_len[row, j] = ln
            train_dst[row, j] = dst
        rest = trains[mt - 1:]
        train_start[row, mt - 1] = -1            # degenerate-schedule sentinel
        train_len[row, mt - 1] = sum(t[1] for t in rest)
        train_dst[row, mt - 1] = rest[0][2]
        self.stats.train_overflows += 1

    def fill_train_arrays_batch(self, trains_per_row, train_start, train_len,
                                train_dst, rows) -> None:
        """Write several slots' trains at once (rows aligned with trains)."""
        for row, trains in zip(rows, trains_per_row):
            self.fill_train_arrays(trains, train_start, train_len, train_dst,
                                   row)
