"""KV pager — RESERVE / ALIAS / TRIM / FRAME over page-aligned blocks (§4.2).

Host-side control plane. Physical KV memory is virtualized as page-aligned
*blocks* (BLOCKALIGN granularity: ``block_tokens`` tokens, sized ~tau bytes so
one block is a burst-friendly transfer quantum). Per-session view descriptors
map logical token ranges onto physical blocks; the device always sees the same
fixed-shape window while the host remaps which logical tokens occupy it.

Verbs:
  * reserve(sid, n_tokens)  — allocate block-aligned spans; O(1) via
    size-partitioned free runs + tail-adjacency placement hints (lookahead
    placement keeps a session's blocks physically contiguous -> long trains).
  * alias(src, dst, n_tok)  — copy-on-write prefix sharing (refcounts; the
    partial tail block is marked for a device-side COW copy).
  * alias_blocks(dst, blocks, n_tok) — alias() from an explicit committed
    block chain (the §9 prefix cache's hit path); both raise the typed
    SwapRefused over a host-resident prefix.
  * retain_block / release_block — external (non-session) references: the
    prefix cache (DESIGN.md §9) keeps committed prompt blocks alive past
    their session's EOS; external refs refuse swap like COW shares.
  * trim(sid, ...)          — reclaim EOS / cold blocks to the free pool.
  * frame()                 — seal all edits for step t into ONE atomic
    descriptor commit (shadow -> active double buffer, epoch counter;
    linearizable + idempotent under retries; O(|delta_t|) per step).
  * swap_out / swap_in      — host-tier residency (DESIGN.md §8): move
    cold or preempted blocks into a host backing pool and back. A
    session's ``blocks`` list encodes per-block residency by sign:
    entry >= 1 is a DEVICE block id, entry <= -1 is host slot
    ``-(entry + 1)``. The compiled executor must never observe a
    host-resident block; ``_window_blocks``/descriptor assembly only read
    window-range entries, which swap_in restores to device first.

Block 0 is scratch (never allocated): inactive slots' writes land there.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# session-level residency state machine (DESIGN.md §8, §11):
#   DEVICE --swap_out_session--> [IN_FLIGHT_OUT --swap_out_commit-->] HOST
#      ^                                                               |
#      |                                                       swap_in_begin
#      +------------------swap_in_commit-------------- IN_FLIGHT <-----+
# (swap_out_cold keeps the session DEVICE: only below-window blocks move.
# IN_FLIGHT_OUT is the §11 async-movement fence state: the device->host
# gather was ISSUED but not yet synchronized — the blocks are already
# host-entries in the block list, but the host slots hold no bytes until
# the engine drains the transfer's fence and calls swap_out_commit.
# swap_in_begin refuses the state, so a resume forces the drain first.)
RES_DEVICE = "device"
RES_HOST = "host"
RES_IN_FLIGHT = "in_flight"
RES_IN_FLIGHT_OUT = "in_flight_out"


def host_slot_of(entry: int) -> int:
    """Decode a sign-encoded host-resident block entry."""
    assert entry < 0
    return -(entry + 1)


def host_entry_of(slot: int) -> int:
    return -(slot + 1)


@dataclass
class Session:
    sid: int
    blocks: List[int] = field(default_factory=list)   # logical order
    length: int = 0                                   # tokens written
    shared_prefix_blocks: int = 0                     # aliased (COW) prefix
    cow_pending: Optional[Tuple[int, int]] = None     # (src, dst) tail copy
    trimmed_prefix_blocks: int = 0                    # far-view: summarized+trimmed
    swap_state: str = RES_DEVICE                      # DESIGN.md §8 state machine
    # provenance stack of recent reserves' takes — (newb, [(start, want,
    # length, class_idx)]) — so a lagged-EOS reconcile (§13) can undo each
    # overshoot allocation POSITIONALLY (newest first) and leave the free
    # structure byte-identical to the timeline that never reserved
    reserve_provenance: List[Tuple] = field(default_factory=list)

    def device_blocks(self) -> List[int]:
        return [b for b in self.blocks if b > 0]

    def host_slots(self) -> List[int]:
        return [host_slot_of(b) for b in self.blocks if b < 0]


class FrameError(RuntimeError):
    pass


class SwapError(RuntimeError):
    """Swap refused (COW-shared blocks, wrong residency state)."""


class SwapRefused(SwapError):
    """An operation needed device-resident blocks but found host-resident
    ones (e.g. alias() over a cold-swapped prefix). Callers either pick a
    different source or swap the prefix in first — this is a policy
    decision, not a crash, hence a typed error instead of an assert."""


class BlockPager:
    def __init__(self, num_blocks: int, block_tokens: int,
                 bytes_per_block: int = 0, size_classes=(32, 8, 2, 1),
                 span_blocks: int = 4, host_pool_blocks: int = 0):
        assert num_blocks > 1
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.bytes_per_block = bytes_per_block
        # host backing tier (DESIGN.md §8): a fixed pool of host block slots
        # that absorbs swapped-out device blocks; 0 disables the tier
        self.host_pool_blocks = host_pool_blocks
        self._host_free: List[int] = list(range(host_pool_blocks))
        self.host_used = 0
        self.host_peak = 0
        self._swap_in_pairs: Dict[int, List[Tuple[int, int]]] = {}
        # lookahead placement granularity: sessions grow in spans of
        # `span_blocks` contiguous blocks so interleaved growth stays
        # burst-friendly (paper: BLOCKALIGN(S_{t+1}) + placement planning)
        self.span_blocks = max(1, span_blocks)
        self.size_classes = tuple(sorted(size_classes, reverse=True))
        # free runs: run_start -> run_len ; reverse index block -> run_start
        self._run_len: Dict[int, int] = {}
        self._run_of: Dict[int, int] = {}
        self._free_by_class: Dict[int, List[int]] = {c: [] for c in self.size_classes}
        self._take_log: Optional[List[Tuple]] = None  # reserve provenance
        self._insert_run(1, num_blocks - 1)           # block 0 = scratch
        self.refcount = np.zeros(num_blocks, np.int32)
        self.sessions: Dict[int, Session] = {}
        # external (non-session) references: the prefix cache retains
        # committed immutable blocks so they survive their session's EOS.
        # refcount counts session owners + external retains; invariants
        # check both (DESIGN.md §9)
        self.external_refs: Dict[int, int] = {}
        # frame double buffer
        self.epoch = 0
        self._edit_log: List[Tuple] = []              # edits staged this frame
        self._committed_edit_count = 0
        self._last_frame: Optional[dict] = None
        # stats
        self.stats = {"reserve_ops": 0, "trim_ops": 0, "alias_ops": 0,
                      "frames": 0, "blocks_allocated": 0, "blocks_freed": 0,
                      "swap_out_blocks": 0, "swap_in_blocks": 0,
                      "swap_out_ops": 0, "swap_in_ops": 0,
                      "swap_refusals": 0}

    # ------------------------------------------------------------------
    # free-run bookkeeping (size-partitioned, O(1) amortized)
    # ------------------------------------------------------------------
    def _class_of(self, n: int) -> int:
        for c in self.size_classes:
            if n >= c:
                return c
        return self.size_classes[-1]

    def _insert_run(self, start: int, length: int) -> None:
        if length <= 0:
            return
        # coalesce with left/right neighbours
        left = self._run_of.get(start - 1)
        if left is not None:
            llen = self._run_len.pop(left)
            self._remove_from_class(left, llen)
            start, length = left, llen + length
        right_start = start + length
        if right_start in self._run_len:
            rlen = self._run_len.pop(right_start)
            self._remove_from_class(right_start, rlen)
            for b in range(right_start, right_start + rlen):
                self._run_of.pop(b, None)
            length += rlen
        self._run_len[start] = length
        for b in range(start, start + length):
            self._run_of[b] = start
        self._free_by_class[self._class_of(length)].append(start)

    def _remove_from_class(self, start: int, length: int) -> None:
        cls = self._class_of(length)
        try:
            self._free_by_class[cls].remove(start)
        except ValueError:
            pass

    def _take_run(self, start: int, want: int) -> List[int]:
        """Take `want` blocks from the head of run `start`."""
        length = self._run_len.pop(start)
        cls = self._class_of(length)
        try:
            idx = self._free_by_class[cls].index(start)
            self._free_by_class[cls].pop(idx)
        except ValueError:
            idx = None
        for b in range(start, start + length):
            self._run_of.pop(b, None)
        taken = list(range(start, start + want))
        if length > want:
            self._insert_run(start + want, length - want)
        if self._take_log is not None:
            self._take_log.append((start, want, length, idx))
        return taken

    def _alloc_blocks(self, n: int, hint: Optional[int] = None) -> List[int]:
        out: List[int] = []
        # placement: extend at hint (tail adjacency) for burst-friendly trains
        if hint is not None and (hint + 1) in self._run_of:
            start = self._run_of[hint + 1]
            if start == hint + 1:
                run = self._run_len[start]
                take = min(run, n)
                out += self._take_run(start, take)
        while len(out) < n:
            need = n - len(out)
            chosen = None
            for c in self.size_classes:          # largest class first
                if self._free_by_class[c]:
                    chosen = self._free_by_class[c][-1]
                    break
            if chosen is None:
                # rollback the partial take: callers may catch MemoryError
                # and retry after relieving pressure (DESIGN.md §8), so the
                # blocks taken so far must return to the free list or the
                # pool bleeds one run per failed reservation
                for b in out:
                    self._insert_run(b, 1)
                raise MemoryError(
                    f"KV pool exhausted: want {need} more blocks, "
                    f"{self.free_blocks()} free")
            run = self._run_len[chosen]
            out += self._take_run(chosen, min(run, need))
        self.refcount[out] += 1
        self.stats["blocks_allocated"] += len(out)
        return out

    def _free_block(self, b: int) -> None:
        self.refcount[b] -= 1
        assert self.refcount[b] >= 0
        if self.refcount[b] == 0:
            self._insert_run(b, 1)
            self.stats["blocks_freed"] += 1

    def _free_entry(self, e: int) -> None:
        """Free one session block entry, device- or host-resident."""
        if e > 0:
            self._free_block(e)
        else:
            self._host_free_slot(host_slot_of(e))

    # ------------------------------------------------------------------
    # host pool slot bookkeeping
    # ------------------------------------------------------------------
    def _host_alloc(self, n: int) -> List[int]:
        """Take n host slots, lowest-first (keeps swap groups mergeable:
        the free list is sorted, so consecutive takes are usually
        physically contiguous host slots)."""
        if n > len(self._host_free):
            raise MemoryError(
                f"host KV pool exhausted: want {n} slots, "
                f"{len(self._host_free)} free of {self.host_pool_blocks}")
        taken, self._host_free = self._host_free[:n], self._host_free[n:]
        self.host_used += n
        self.host_peak = max(self.host_peak, self.host_used)
        return taken

    def _host_free_slot(self, h: int) -> None:
        bisect.insort(self._host_free, h)
        self.host_used -= 1

    def host_free_blocks(self) -> int:
        return len(self._host_free)

    # ------------------------------------------------------------------
    # verbs
    # ------------------------------------------------------------------
    def open_session(self, sid: int) -> Session:
        assert sid not in self.sessions
        s = Session(sid)
        self.sessions[sid] = s
        return s

    def reserve(self, sid: int, n_tokens: int) -> List[int]:
        """Ensure capacity for n_tokens more tokens; BLOCKALIGN'd."""
        s = self.sessions[sid]
        cap = len(s.blocks) * self.block_tokens
        local_len = s.length - s.trimmed_prefix_blocks * self.block_tokens
        need_tokens = local_len + n_tokens - cap
        if need_tokens <= 0:
            return []
        nb = -(-need_tokens // self.block_tokens)
        hint = s.blocks[-1] if s.blocks else None
        # placement: grow in spans when possible; fall back to exact size
        # under memory pressure so spans never cause spurious OOM
        want = max(nb, self.span_blocks)
        if want > nb and self.free_blocks() < want + self.span_blocks:
            want = nb
        self._take_log = []
        try:
            newb = self._alloc_blocks(want, hint=hint)
            s.reserve_provenance.append((tuple(newb), self._take_log))
            del s.reserve_provenance[:-4]    # bounded: > max pipeline depth
        finally:
            self._take_log = None
        s.blocks += newb
        self._edit_log.append(("reserve", sid, tuple(newb)))
        self.stats["reserve_ops"] += 1
        return newb

    def reconcile_overshoot(self, sid: int, newb: List[int],
                            n_tokens: int = 1) -> None:
        """Reverse ONE dispatched-but-scrubbed emission (lagged-EOS
        reconcile, DESIGN.md §13): under pipelining the host learns of a
        detected stop token ``depth`` dispatches late, and the overshot
        steps already ran ``reserve`` + ``append_token`` for tokens that
        will never be read. Roll the session back exactly: undo the length
        accounting and return the blocks that overshoot's reserve took
        (``newb``, possibly [] when capacity already existed — reserve's
        early return increments nothing, so neither does this). Stats are
        reversed rather than double-counted so a depth-d run's pager audit
        is byte-identical to the depth-0 run of the same trace. Tail decode
        blocks are never shared (COW aliases cover prompt prefixes only)
        and never cold-swapped (the append tail stays device-resident), so
        popping them is safe even though a frame already committed them —
        the committed descriptor only ever pointed one WRITE at them, and
        that write is the one being scrubbed."""
        s = self.sessions[sid]
        assert s.swap_state == RES_DEVICE, \
            f"overshoot reconcile on non-resident sid={sid}"
        s.length -= n_tokens
        assert s.length >= 0
        if newb:
            assert s.blocks[-len(newb):] == list(newb), \
                f"overshoot blocks not at tail: sid={sid} {newb}"
            for b in reversed(newb):
                assert b > 0 and self.refcount[b] == 1, \
                    f"overshoot block {b} shared (refcount "\
                    f"{self.refcount[b]})"
                s.blocks.pop()
                self.refcount[b] -= 1
            takes = None
            if s.reserve_provenance and \
                    s.reserve_provenance[-1][0] == tuple(newb):
                takes = s.reserve_provenance.pop()[1]
            if not self._undo_takes(takes, newb):
                # free structure disturbed since the reserve (another slot
                # allocated in between) — positional identity is already
                # gone; return the blocks through the normal coalescing
                # path so the pool stays leak-free
                for b in reversed(newb):
                    self._insert_run(b, 1)
            # exact reversal of the overshoot's reserve: the allocation and
            # op counters net to the timeline that never reserved
            self.stats["blocks_allocated"] -= len(newb)
            self.stats["reserve_ops"] -= 1
        self._edit_log.append(("reconcile", sid, tuple(newb)))

    def _undo_takes(self, takes, newb: List[int]) -> bool:
        """Positionally invert one reserve's ``_take_run`` sequence so the
        free structure (runs AND class-list order — allocation picks
        ``[-1]``, so order decides future placement) ends byte-identical to
        the never-reserved timeline. Returns False without mutating when
        the provenance no longer matches — e.g. a remainder run was
        consumed or coalesced by an interleaved allocation — in which case
        the caller falls back to plain frees (the documented §13 limit:
        placement identity holds for uncontended overshoot windows)."""
        if takes is None or sum(t[1] for t in takes) != len(newb):
            return False
        got = [b for st_, w, _, _ in takes for b in range(st_, st_ + w)]
        if got != list(newb):
            return False
        for st_, w, length, idx in takes:
            if idx is None:
                return False
            if length > w and self._run_len.get(st_ + w) != length - w:
                return False
            if length == w and any(b in self._run_of
                                   for b in range(st_, st_ + w)):
                return False
        for st_, w, length, idx in reversed(takes):
            if length > w:
                rem = st_ + w
                self._run_len.pop(rem)
                self._remove_from_class(rem, length - w)
                for b in range(rem, rem + length - w):
                    self._run_of.pop(b, None)
            self._run_len[st_] = length
            for b in range(st_, st_ + length):
                self._run_of[b] = st_
            self._free_by_class[self._class_of(length)].insert(idx, st_)
        return True

    def alias(self, src_sid: int, dst_sid: int, n_tokens: int) -> None:
        """Share the first n_tokens of src with dst (COW). Raises
        ``SwapRefused`` when the source prefix (including the partial-tail
        copy source) is host-resident — the caller must either swap the
        source in first or forfeit the share and prefill."""
        src = self.sessions[src_sid]
        nb = -(-n_tokens // self.block_tokens)
        self.alias_blocks(dst_sid, src.blocks[:nb], n_tokens)

    def alias_blocks(self, dst_sid: int, blocks: List[int],
                     n_tokens: int) -> None:
        """Share the first n_tokens stored in an explicit committed block
        chain with a fresh session (COW). This is alias() decoupled from a
        source SESSION: the prefix cache (DESIGN.md §9) holds block chains
        of retired sessions via ``retain_block``, and new admissions alias
        straight from the index. ``blocks`` must cover n_tokens (the block
        holding the partial tail included, when n_tokens is unaligned)."""
        dst = self.sessions[dst_sid]
        assert dst.length == 0 and not dst.blocks, "alias onto fresh session"
        nb_full = n_tokens // self.block_tokens
        rem = n_tokens % self.block_tokens
        need = nb_full + (1 if rem else 0)
        assert len(blocks) >= need, \
            f"alias chain too short: {len(blocks)} blocks for {n_tokens} tokens"
        if not all(b > 0 for b in blocks[:need]):
            raise SwapRefused(
                f"cannot alias a host-resident prefix (dst={dst_sid}, "
                f"n_tokens={n_tokens}): swap it in first")
        shared = blocks[:nb_full]
        own = None
        if rem:
            # partial tail: dst gets its own block; device must copy its
            # contents (COW). Allocate BEFORE touching dst so an exhausted
            # pool leaves the fresh session untouched (atomic failure —
            # callers fall back to a plain prefill).
            own = self._alloc_blocks(1, hint=shared[-1] if shared else None)
        self.refcount[shared] += 1
        dst.blocks = list(shared)
        dst.shared_prefix_blocks = nb_full
        dst.length = nb_full * self.block_tokens
        if rem:
            dst.blocks.append(own[0])
            dst.cow_pending = (blocks[nb_full], own[0])
            dst.length = n_tokens
        self._edit_log.append(("alias", dst_sid, tuple(blocks[:need]), n_tokens))
        self.stats["alias_ops"] += 1

    # ------------------------------------------------------------------
    # external block references (prefix cache, DESIGN.md §9)
    # ------------------------------------------------------------------
    def retain_block(self, b: int) -> None:
        """Take an external (non-session) reference on a committed block so
        it survives its owning session's trim/close. External refs make a
        block ineligible for swap exactly like a COW share (refcount > 1)."""
        assert 0 < b < self.num_blocks and self.refcount[b] > 0, \
            f"retain of dead block {b}"
        self.refcount[b] += 1
        self.external_refs[b] = self.external_refs.get(b, 0) + 1

    def release_block(self, b: int) -> None:
        """Drop one external reference; frees the block when it was the
        last owner (session- or cache-side)."""
        n = self.external_refs.get(b, 0)
        assert n > 0, f"release of unretained block {b}"
        if n == 1:
            del self.external_refs[b]
        else:
            self.external_refs[b] = n - 1
        self._free_block(b)

    def trim(self, sid: int, *, close: bool = False,
             prefix_blocks: int = 0) -> List[int]:
        """Reclaim blocks. close=True frees everything (EOS);
        prefix_blocks frees summarized far-history blocks (bounded-budget)."""
        s = self.sessions[sid]
        freed: List[int] = []
        if close:
            for b in s.blocks:
                self._free_entry(b)
            freed = s.blocks
            s.blocks = []
            del self.sessions[sid]
        elif prefix_blocks:
            take = s.blocks[:prefix_blocks]
            for b in take:
                self._free_entry(b)
            freed = take
            s.blocks = s.blocks[prefix_blocks:]
            s.trimmed_prefix_blocks += prefix_blocks
            s.shared_prefix_blocks = max(0, s.shared_prefix_blocks - prefix_blocks)
        if freed:
            self._edit_log.append(("trim", sid, tuple(freed)))
            self.stats["trim_ops"] += 1
        return freed

    def append_token(self, sid: int) -> Tuple[int, int]:
        """Account one token write; returns (physical_block, offset).
        Caller must have reserved capacity."""
        s = self.sessions[sid]
        local = s.length - s.trimmed_prefix_blocks * self.block_tokens
        bi, off = divmod(local, self.block_tokens)
        assert bi < len(s.blocks), f"no capacity: sid={sid} len={s.length}"
        s.length += 1
        blk = s.blocks[bi]
        assert blk > 0, \
            f"write targets host-resident block: sid={sid} entry={blk}"
        return blk, off

    def append_tokens(self, sid: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Account n token writes at once (chunked prefill); returns
        (blocks (n,), offsets (n,)) int32 arrays. Caller must have reserved
        capacity for all n tokens."""
        s = self.sessions[sid]
        bt = self.block_tokens
        local = s.length - s.trimmed_prefix_blocks * bt
        idx = local + np.arange(n)
        bi, off = np.divmod(idx, bt)
        assert n == 0 or bi[-1] < len(s.blocks), \
            f"no capacity: sid={sid} len={s.length} n={n}"
        blocks = np.asarray(s.blocks, np.int32)[bi]
        s.length += n
        assert n == 0 or (blocks > 0).all(), \
            f"write targets host-resident block: sid={sid}"
        return blocks.astype(np.int32), off.astype(np.int32)

    # ------------------------------------------------------------------
    # host-tier swap verbs (DESIGN.md §8)
    # ------------------------------------------------------------------
    def blocks_needed(self, sid: int, n_tokens: int) -> int:
        """Device blocks a reserve(sid, n_tokens) would allocate (exact-fit
        math; span placement may take more when the pool is comfortable)."""
        s = self.sessions[sid]
        cap = len(s.blocks) * self.block_tokens
        local_len = s.length - s.trimmed_prefix_blocks * self.block_tokens
        need_tokens = local_len + n_tokens - cap
        return max(0, -(-need_tokens // self.block_tokens))

    def swap_eligible(self, sid: int) -> bool:
        """A session can move to the host tier only if it shares no block
        with another session: every device block has refcount 1 and no COW
        tail copy is pending. Aliased (COW) blocks are REFUSED — swapping
        one side would either tear the share or need a copy-split; the
        engine must pick another victim."""
        s = self.sessions[sid]
        if s.cow_pending is not None or s.swap_state != RES_DEVICE:
            return False
        dev = s.device_blocks()
        return all(self.refcount[b] == 1 for b in dev)

    def swap_out_cold(self, sid: int, keep_from_local: int
                      ) -> List[Tuple[int, int]]:
        """Move the session's blocks BELOW logical index ``keep_from_local``
        (i.e. strictly below the near window) to the host tier, coldest
        (oldest) first. Shared (refcount > 1) and already-host blocks are
        skipped. The session stays DEVICE-resident: its window never
        references the moved blocks again (the window only advances), so the
        executor-residency invariant holds with no swap-in path needed.
        Returns (device_block, host_slot) copy pairs for the transport."""
        s = self.sessions[sid]
        if s.swap_state != RES_DEVICE:
            raise SwapError(f"sid={sid} not device-resident")
        # never move the append tail: only FULL blocks strictly below the
        # current write position are cold, whatever the caller asked for
        local = s.length - s.trimmed_prefix_blocks * self.block_tokens
        limit = min(keep_from_local, local // self.block_tokens, len(s.blocks))
        pairs: List[Tuple[int, int]] = []
        for i in range(limit):
            b = s.blocks[i]
            if b < 0 or self.refcount[b] != 1:
                continue
            h = self._host_alloc(1)[0]
            pairs.append((b, h))
            s.blocks[i] = host_entry_of(h)
            self._free_block(b)
        if pairs:
            self.stats["swap_out_blocks"] += len(pairs)
            self.stats["swap_out_ops"] += 1
            self._edit_log.append(("swap_out", sid,
                                   tuple(p[0] for p in pairs)))
        return pairs

    def swap_out_session(self, sid: int, *, deferred: bool = False
                         ) -> Optional[List[Tuple[int, int]]]:
        """Preemption swap-out: move ALL the session's device blocks to the
        host tier and mark it HOST-resident — or, with ``deferred=True``
        (async movement, DESIGN.md §11), IN_FLIGHT_OUT: the caller issued
        the device->host gather but has not synchronized it, and must call
        ``swap_out_commit`` once the fence drains. Returns (device_block,
        host_slot) copy pairs, or None if the session is REFUSED (COW-shared
        blocks — the caller must pick another victim)."""
        if not self.swap_eligible(sid):
            self.stats["swap_refusals"] += 1
            return None
        s = self.sessions[sid]
        dev_idx = [i for i, b in enumerate(s.blocks) if b > 0]
        hosts = self._host_alloc(len(dev_idx))
        pairs = []
        for i, h in zip(dev_idx, hosts):
            b = s.blocks[i]
            pairs.append((b, h))
            s.blocks[i] = host_entry_of(h)
            self._free_block(b)
        # a deferred transfer with nothing to move has no fence to wait on
        s.swap_state = RES_IN_FLIGHT_OUT if (deferred and pairs) else RES_HOST
        s.shared_prefix_blocks = 0
        self.stats["swap_out_blocks"] += len(pairs)
        self.stats["swap_out_ops"] += 1
        self._edit_log.append(("swap_out", sid, tuple(p[0] for p in pairs)))
        return pairs

    def swap_out_commit(self, sid: int) -> None:
        """Async-movement fence release (DESIGN.md §11): the deferred
        device->host readback landed — the host slots now hold real bytes,
        so the session becomes plain HOST-resident and swap_in_begin may
        run. Sessions can be closed while IN_FLIGHT_OUT (their data is
        never read); a vanished sid is therefore not an error."""
        s = self.sessions.get(sid)
        if s is None:
            return
        if s.swap_state != RES_IN_FLIGHT_OUT:
            raise SwapError(f"sid={sid} not in-flight-out")
        s.swap_state = RES_HOST

    def swap_in_begin(self, sid: int, from_local: int
                      ) -> List[Tuple[int, int]]:
        """Resume phase 1: allocate device blocks for every host-resident
        entry at logical index >= ``from_local`` (the resumed window + tail)
        and mark the session IN_FLIGHT. Blocks strictly below the window
        stay host-resident (the window never retreats). Returns (host_slot,
        device_block) copy pairs; raises MemoryError when the device pool
        cannot hold the working set (caller must gate admission first)."""
        s = self.sessions[sid]
        if s.swap_state != RES_HOST:
            raise SwapError(f"sid={sid} not host-resident")
        # the append tail must come back whatever the caller asked for:
        # cap from_local at the current write position's block
        local = s.length - s.trimmed_prefix_blocks * self.block_tokens
        from_local = min(from_local, local // self.block_tokens)
        idx = [i for i in range(from_local, len(s.blocks)) if s.blocks[i] < 0]
        pairs: List[Tuple[int, int]] = []
        if idx:
            newb = self._alloc_blocks(len(idx))
            for i, b in zip(idx, newb):
                pairs.append((host_slot_of(s.blocks[i]), b))
                s.blocks[i] = b
        s.swap_state = RES_IN_FLIGHT
        self._swap_in_pairs[sid] = pairs
        return pairs

    def swap_in_commit(self, sid: int) -> None:
        """Resume phase 2: the copies landed on device — release the host
        slots and mark the session DEVICE-resident again."""
        s = self.sessions[sid]
        if s.swap_state != RES_IN_FLIGHT:
            raise SwapError(f"sid={sid} not in-flight")
        pairs = self._swap_in_pairs.pop(sid, [])
        for h, _ in pairs:
            self._host_free_slot(h)
        s.swap_state = RES_DEVICE
        self.stats["swap_in_blocks"] += len(pairs)
        self.stats["swap_in_ops"] += 1
        self._edit_log.append(("swap_in", sid, tuple(p[1] for p in pairs)))

    # ------------------------------------------------------------------
    # frame commit (shadow -> active, epoch, idempotent)
    # ------------------------------------------------------------------
    def frame(self) -> dict:
        """Seal this step's edits into one committed frame. Calling frame()
        again with no new edits returns the SAME committed frame (idempotent
        retry semantics)."""
        if self._last_frame is not None and \
           len(self._edit_log) == self._committed_edit_count:
            return self._last_frame              # retry: identical commit
        # shadow build: snapshot of session views
        shadow = {
            "epoch": self.epoch + 1,
            "edits": list(self._edit_log[self._committed_edit_count:]),
            "views": {sid: (tuple(s.blocks), s.length, s.trimmed_prefix_blocks,
                            s.cow_pending)
                      for sid, s in self.sessions.items()},
        }
        # atomic swap
        self.epoch += 1
        self._committed_edit_count = len(self._edit_log)
        self._last_frame = shadow
        self.stats["frames"] += 1
        for s in self.sessions.values():
            s.cow_pending = None                 # consumed by this frame
        return shadow

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------
    def free_blocks(self) -> int:
        return int(sum(self._run_len.values()))

    def reserved_blocks(self) -> int:
        return self.num_blocks - 1 - self.free_blocks()

    def reserved_bytes(self) -> int:
        return self.reserved_blocks() * self.bytes_per_block

    def active_tokens(self) -> int:
        return sum(s.length - s.trimmed_prefix_blocks * self.block_tokens
                   for s in self.sessions.values())

    def check_invariants(self) -> None:
        """Property-test hook: refcounts/ownership/free-list consistency,
        plus host-tier slot accounting (DESIGN.md §8)."""
        owned = {}
        host_owned: List[int] = []
        for sid, s in self.sessions.items():
            for i, b in enumerate(s.blocks):
                if b < 0:
                    host_owned.append(host_slot_of(b))
                    continue
                owned.setdefault(b, []).append(sid)
                assert 0 < b < self.num_blocks
            if s.swap_state in (RES_HOST, RES_IN_FLIGHT_OUT):
                assert not s.device_blocks(), \
                    f"host-resident sid={sid} still owns device blocks"
        for b, ext in self.external_refs.items():
            assert ext > 0 and 0 < b < self.num_blocks
            owned.setdefault(b, [])
        for b, owners in owned.items():
            want = len(owners) + self.external_refs.get(b, 0)
            assert self.refcount[b] == want, \
                f"block {b}: refcount {self.refcount[b]} != owners {owners} " \
                f"+ ext {self.external_refs.get(b, 0)}"
            assert b not in self._run_of, f"block {b} owned AND free"
        total_free = self.free_blocks()
        ref_live = int((self.refcount[1:] > 0).sum())
        assert ref_live + total_free == self.num_blocks - 1, \
            f"leak: live {ref_live} + free {total_free} != {self.num_blocks - 1}"
        # host tier: owned slots are unique, in range, disjoint from the
        # free list, and the used counter matches ownership exactly
        assert len(host_owned) == len(set(host_owned)), \
            f"host slot double-owned: {sorted(host_owned)}"
        assert all(0 <= h < self.host_pool_blocks for h in host_owned)
        assert not set(host_owned) & set(self._host_free), "host slot owned AND free"
        assert self.host_used == len(host_owned), \
            f"host leak: used {self.host_used} != owned {len(host_owned)}"
        assert self.host_used + len(self._host_free) == self.host_pool_blocks
