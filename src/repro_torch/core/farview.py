"""Far-view summarization policy (paper §4.4) — optional bounded-budget view.

Host-side policy state: per-slot EMA of aggregated attention utility per far
chunk (fed back from the device's far_util output each step), used to select
up to ``cap`` representative chunks for the next frame. Chunk summaries are
built on-device by uniform aggregation (kernels farview_summarize) when the
near window slides past a chunk boundary; the underlying blocks are then
TRIMmed, so reserved memory stays O(W* + cap) per session.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class FarViewState:
    max_chunks: int
    cap: int
    ema_decay: float = 0.9
    n_chunks: np.ndarray = None          # (B,) summaries written per slot
    ema: np.ndarray = None               # (B, max_chunks) utility scores

    def __post_init__(self):
        pass


class FarViewPolicy:
    def __init__(self, batch: int, max_chunks: int, cap: int,
                 sv_chunk: int, block_tokens: int, ema_decay: float = 0.9):
        assert sv_chunk % block_tokens == 0, "sv_chunk must be BLOCKALIGN'd"
        self.batch = batch
        self.max_chunks = max_chunks
        self.cap = cap
        self.sv_chunk = sv_chunk
        self.block_tokens = block_tokens
        self.chunk_blocks = sv_chunk // block_tokens
        self.ema_decay = ema_decay
        self.n_chunks = np.zeros(batch, np.int32)
        self.ema = np.zeros((batch, max_chunks), np.float32)

    def reset_slot(self, row: int) -> None:
        self.n_chunks[row] = 0
        self.ema[row] = 0.0

    def observe_utility(self, far_util: np.ndarray, far_table: np.ndarray) -> None:
        """far_util: (B, cap) attention mass per SELECTED entry from the
        device; scatter back into per-chunk EMA scores."""
        d = self.ema_decay
        for b in range(self.batch):
            sel = far_table[b]
            self.ema[b] *= d
            np.add.at(self.ema[b], sel, (1 - d) * far_util[b])

    def select(self, row: int) -> np.ndarray:
        """Top-cap chunks by EMA for one slot -> (cap,) indices (+valid via
        n_chunks). Falls back to most-recent-first for unscored chunks."""
        n = int(self.n_chunks[row])
        cap = self.cap
        table = np.zeros(cap, np.int32)
        valid = np.zeros(cap, np.int32)
        if n == 0:
            return table, valid
        if n <= cap:
            table[:n] = np.arange(n)
            valid[:n] = 1
            return table, valid
        scores = self.ema[row, :n].copy()
        # recency prior: never starve recent chunks that haven't been scored
        scores += 1e-6 * np.arange(n)
        top = np.argpartition(scores, -cap)[-cap:]
        top.sort()
        table[:] = top
        valid[:] = 1
        return table, valid

    def on_chunk_summarized(self, row: int) -> int:
        """Account a new summary; returns the far-pool slot it was written to."""
        idx = int(self.n_chunks[row])
        if idx >= self.max_chunks:
            # budget exhausted: recycle the lowest-utility slot
            idx = int(np.argmin(self.ema[row]))
            self.ema[row, idx] = 0.0
            return idx
        self.n_chunks[row] += 1
        return idx
