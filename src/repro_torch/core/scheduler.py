"""Continuous-batching scheduler for the fixed-width decode engine.

Slots are the fixed batch rows of the compiled decode step. The scheduler
admits waiting requests into free slots, retires EOS bursts, and proposes the
lookahead set S_{t+1} (slots whose next token crosses a block boundary) that
the pager BLOCKALIGNs and reserves with tail-adjacent placement (prefetch-1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # int32 token ids
    gen_len: int                     # max tokens to generate (budget cap)
    arrival: float = 0.0             # for trace replay
    prefix_of: Optional[int] = None  # rid whose prompt prefix this shares
    prefix_len: int = 0
    # data-dependent EOS (DESIGN.md §13): any generated token in this set
    # ends the request. Only meaningful with sampled decode (greedy=False);
    # an empty set keeps the legacy pure-budget semantics bit-exact.
    stop_tokens: tuple = ()
    # runtime
    generated: List[int] = field(default_factory=list)
    prompt_pos: int = 0              # tokens of prompt already consumed
    start_step: int = -1
    finish_step: int = -1
    first_token_step: int = -1
    # structural emission count, stamped at DISPATCH time. In legacy greedy
    # mode EOS is the gen_len budget, so retirement is host-predictable from
    # this counter alone; in sampled mode EOS is data-dependent and ALL
    # retirement happens at readback, where overshot dispatches are scrubbed
    # back out of this counter (DESIGN.md §13). Token VALUES land in
    # ``generated`` at readback, ``pipeline_depth`` steps later (DESIGN.md §3)
    emitted: int = 0
    eos_hit: bool = False            # a stop token ended this request
    finish_reason: str = ""          # "stop" | "budget" (set at retirement)
    # --- preemption / host-tier resume (DESIGN.md §8) ---
    swap_sid: int = -1               # pager session holding swapped-out KV
    resume_len: int = 0              # tokens in cache at preemption
    resume_last_token: int = 0       # host token mirror for the resume step
    preempt_count: int = 0
    # worst-case device blocks the admission watermark charged for this
    # request (DESIGN.md §8/§9). Stamped by the engine's kv_ok gate so
    # retirement releases EXACTLY what admission committed — with prefix
    # aliasing (§9) the charge is reduced by the shared blocks, which a
    # recompute at retire time could no longer reproduce (the cache may
    # have changed since).
    committed_blocks: int = 0


@dataclass
class SlotState:
    rid: int = -1                    # -1 = free
    sid: int = -1                    # pager session


class AdmissionPolicy:
    """Pluggable admission ORDERING (DESIGN.md §14): ``order`` returns the
    sequence in which the waiting queue is considered this admit round —
    head-of-line blocking then applies in that order. The default identity
    policy preserves the seed FIFO semantics bit-for-bit; the serving
    gateway installs an SLO-priority policy. Only the fresh-admission
    queue is reordered: preempted resumes keep their no-overtaking FIFO
    (a resume's working set shrinks only when others finish)."""

    def order(self, waiting: List["Request"], now: float) -> List["Request"]:
        return waiting


class Scheduler:
    def __init__(self, n_slots: int, policy: Optional[AdmissionPolicy] = None):
        self.n_slots = n_slots
        self.slots = [SlotState() for _ in range(n_slots)]
        self.waiting: List[Request] = []
        self.preempted: List[Request] = []   # resume-priority queue (§8)
        self.requests: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.policy = policy
        self._next_sid = 0
        self.step_idx = 0
        # admission-stall counters: one count per admit() call whose queue
        # head was arrived but could not be placed, keyed by why — lets
        # operators split compute-bound (no_slot) from memory-bound
        # (kv_watermark) queueing in serve.py's audit. "round_barrier"
        # counts admit() calls held by round-based batching (an arrived
        # request existed but the engine's --no-continuous-batching
        # barrier kept every free slot idle, DESIGN.md §15) — identically
        # 0 under step-level (continuous) admission.
        self.admit_blocked = {"no_slot": 0, "kv_watermark": 0,
                              "round_barrier": 0}

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.requests[req.rid] = req
        self.waiting.append(req)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.rid < 0]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.rid >= 0]

    def admit(self, now: float = float("inf"), kv_ok=None,
              hold: bool = False) -> List[tuple]:
        """Admit waiting requests (arrival <= now) into free slots.
        Returns [(slot, request, sid)] admissions.

        This is the STEP-LEVEL admission primitive (DESIGN.md §15): the
        engine calls it at the top of every decode step, so a slot freed
        by EOS retirement, cancel or preemption is refilled on the very
        next step. ``hold=True`` is the round-based baseline's barrier:
        nothing is admitted, but an arrived request held back by the
        barrier counts one ``admit_blocked['round_barrier']`` stall so
        the A/B cost is auditable.

        Preempted requests resume FIRST (FIFO within the preempted queue)
        and reuse their swapped-out pager session (``req.swap_sid``); fresh
        requests behind a blocked resume wait with it (no overtaking — a
        resume's working set shrinks only when others finish, so letting
        fresh admissions in front would starve it).

        ``kv_ok(req, is_resume)``, when given, is the KV watermark gate
        (DESIGN.md §8): a request that has a slot available but fails the
        gate is counted in ``admit_blocked['kv_watermark']``; a request
        with no free slot counts in ``admit_blocked['no_slot']``.

        An installed ``self.policy`` (§14) reorders the FRESH queue's
        consideration order; with the default identity policy the walk —
        and every counter — is bit-identical to the seed FIFO."""
        if hold:
            if any(r.arrival <= now for r in self.preempted) \
                    or any(r.arrival <= now for r in self.waiting):
                self.admit_blocked["round_barrier"] += 1
            return []
        out = []
        free = self.free_slots()
        blocked = False
        for queue, is_resume in ((self.preempted, True), (self.waiting, False)):
            view = queue if (is_resume or self.policy is None) \
                else self.policy.order(queue, now)
            taken = set()
            for req in view:
                if blocked or req.arrival > now:
                    continue
                if not free:
                    self.admit_blocked["no_slot"] += 1
                    blocked = True
                    continue
                if kv_ok is not None and not kv_ok(req, is_resume):
                    self.admit_blocked["kv_watermark"] += 1
                    blocked = True
                    continue
                slot = free.pop(0)
                if is_resume:
                    sid = req.swap_sid
                else:
                    sid = self._next_sid
                    self._next_sid += 1
                    req.start_step = self.step_idx
                self.slots[slot] = SlotState(rid=req.rid, sid=sid)
                out.append((slot, req, sid))
                taken.add(id(req))
            if taken:
                queue[:] = [r for r in queue if id(r) not in taken]
        return out

    def preempt(self, slot: int) -> Request:
        """Evict a live request from its slot into the resume queue
        (DESIGN.md §8). The caller (engine) swaps its KV to the host tier
        first and stamps ``swap_sid`` / ``resume_len`` /
        ``resume_last_token``; generation state (prompt_pos, emitted,
        generated) rides on the Request itself, so resume needs no
        recompute."""
        st = self.slots[slot]
        req = self.requests[st.rid]
        req.preempt_count += 1
        self.preempted.append(req)
        self.slots[slot] = SlotState()
        return req

    def retire(self, slot: int) -> Request:
        st = self.slots[slot]
        req = self.requests[st.rid]
        req.finish_step = self.step_idx
        self.finished.append(req)
        self.slots[slot] = SlotState()
        return req

    def request_at(self, slot: int) -> Optional[Request]:
        st = self.slots[slot]
        return self.requests.get(st.rid) if st.rid >= 0 else None

    def next_token(self, slot: int, last_sampled: int) -> int:
        """Token to feed this step: prompt token while prefilling, else the
        previously sampled token."""
        req = self.request_at(slot)
        if req.prompt_pos < len(req.prompt):
            tok = int(req.prompt[req.prompt_pos])
            req.prompt_pos += 1
            return tok
        return last_sampled

    def is_prefilling(self, slot: int) -> bool:
        req = self.request_at(slot)
        return req is not None and req.prompt_pos < len(req.prompt)

    def chunk_remaining(self, slot: int) -> int:
        """Prompt tokens available for chunked ingestion — everything except
        the LAST prompt token, which always goes through the decode step."""
        req = self.request_at(slot)
        if req is None:
            return 0
        return max(0, len(req.prompt) - 1 - req.prompt_pos)

    def consume_prompt_chunk(self, slot: int, max_tokens: int) -> np.ndarray:
        """Take up to max_tokens prompt tokens for the prefill executor."""
        req = self.request_at(slot)
        n = min(max_tokens, self.chunk_remaining(slot))
        toks = np.asarray(req.prompt[req.prompt_pos:req.prompt_pos + n],
                          np.int32)
        req.prompt_pos += n
        return toks

    def note_emit(self, slot: int) -> bool:
        """Account one decode emission structurally (at dispatch time); True
        if the request hits its gen_len budget with this token. The token
        value itself is appended to ``generated`` at readback. Sampled mode
        ignores the return value — detected-EOS retirement is readback-side
        (DESIGN.md §13) and the engine scrubs any budget overshoot there."""
        req = self.request_at(slot)
        if req.first_token_step < 0:
            req.first_token_step = self.step_idx
        req.emitted += 1
        return req.emitted >= req.gen_len

    def record_output(self, slot: int, token: int) -> bool:
        """Record a generated token; True if the request hit EOS — a
        per-request stop token (data-dependent, DESIGN.md §13) or the
        gen_len budget cap."""
        req = self.request_at(slot)
        if req.first_token_step < 0:
            req.first_token_step = self.step_idx
        req.generated.append(token)
        req.emitted = len(req.generated)
        if req.stop_tokens and token in req.stop_tokens:
            req.eos_hit = True
            req.finish_reason = "stop"
            return True
        if len(req.generated) >= req.gen_len:
            req.finish_reason = "budget"
            return True
        return False
