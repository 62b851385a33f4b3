"""Production-trace-like workload generators (paper Table 1 / §5.1-5.2).

The Azure LLM inference trace itself is not available offline; this module
synthesizes replay windows matching the paper's reported heterogeneity:
  * generated length: heavy-tailed, p50/p90/p99 ~ 96/384/1024
  * bursty arrivals: top-10% windows hold ~31% of arrivals
  * EOS completions arrive in bursts (follows from length mixture + bursts)
Scaling: benches run a scaled-down token budget; the SHAPE of the mixture is
what the workloads preserve (scale knob `token_scale`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.core.scheduler import Request


@dataclass(frozen=True)
class TraceConfig:
    n_requests: int = 64
    vocab: int = 256
    prompt_mean: int = 32
    token_scale: float = 1.0       # scales lengths down for CPU benches
    burstiness: float = 3.0        # arrival concentration knob
    window_s: float = 60.0
    seed: int = 0
    shared_prefix_frac: float = 0.0
    shared_prefix_len: int = 16
    n_prefixes: int = 4            # distinct system prompts (shared_prefix_*)
    gen_mean: int = 32             # shared-prefix family: mean decode length
    # stop-token family (DESIGN.md §13): per-request stop sets drawn from
    # the low-id band the sampler actually emits, so detected-EOS
    # retirement fires well before the gen_len budget cap
    stop_tokens: tuple = ()        # explicit stop set (all requests)
    n_stop_tokens: int = 4         # drawn per trace when stop_tokens empty


def _heavy_tail_lengths(rng, n, scale):
    """Lognormal mixture calibrated to p50/p90/p99 ~= 96/384/1024."""
    base = rng.lognormal(mean=np.log(96), sigma=1.05, size=n)
    lens = np.clip(base, 4, 2048) * scale
    return np.maximum(1, lens.astype(np.int64))


# ---------------------------------------------------------------------------
# open-loop arrival processes (serving gateway, DESIGN.md §14)
# ---------------------------------------------------------------------------

def poisson_arrivals(n: int, window_s: float, rng) -> np.ndarray:
    """Memoryless open-loop arrivals: n exponential inter-arrival gaps
    with mean window_s / n (so the window holds the whole trace in
    expectation), cumulatively summed."""
    gaps = rng.exponential(window_s / max(1, n), size=n)
    return np.cumsum(gaps)


def bursty_arrivals(n: int, window_s: float, burstiness: float,
                    rng) -> np.ndarray:
    """Concentrated arrivals matching the Azure-trace heterogeneity (top
    10% of windows hold ~31% of arrivals): Pareto-weighted window counts,
    uniform placement within each window. Factored out of
    ``azure_like_replay`` so the gateway's open-loop client and the
    closed-loop replay share one arrival process."""
    nw = 20
    w = rng.pareto(burstiness / 2, size=nw) + 0.1
    w = w / w.sum()
    counts = rng.multinomial(n, w)
    arrivals = []
    for wi, c in enumerate(counts):
        lo = window_s * wi / nw
        hi = window_s * (wi + 1) / nw
        arrivals += list(rng.uniform(lo, hi, size=c))
    return np.sort(np.array(arrivals))[:n]


def assign_arrivals(reqs: List[Request], kind: str, cfg: TraceConfig) -> None:
    """Reassign a workload's arrivals in place: ``kind`` is 'poisson' or
    'bursty' (serve.py --arrival); the generator draws from a seed offset
    so arrival randomness is independent of the length mixture."""
    rng = np.random.default_rng(cfg.seed + 7)
    if kind == "poisson":
        arr = poisson_arrivals(len(reqs), cfg.window_s, rng)
    elif kind == "bursty":
        arr = bursty_arrivals(len(reqs), cfg.window_s, cfg.burstiness, rng)
    else:
        raise ValueError(f"unknown arrival process {kind!r}")
    for r, a in zip(reqs, arr):
        r.arrival = float(a)


def mixed_length_workload(cfg: TraceConfig) -> List[Request]:
    """Controlled mixed-length decode (paper Fig. 4c-d): all arrive at t=0."""
    rng = np.random.default_rng(cfg.seed)
    gen = _heavy_tail_lengths(rng, cfg.n_requests, cfg.token_scale)
    plen = np.maximum(1, rng.poisson(cfg.prompt_mean * cfg.token_scale,
                                     cfg.n_requests))
    reqs = []
    for i in range(cfg.n_requests):
        prompt = rng.integers(0, cfg.vocab, size=int(plen[i])).astype(np.int32)
        r = Request(rid=i, prompt=prompt, gen_len=int(gen[i]), arrival=0.0)
        if cfg.shared_prefix_frac and i > 0 and rng.random() < cfg.shared_prefix_frac:
            r.prefix_of = 0
            r.prefix_len = min(cfg.shared_prefix_len, len(reqs[0].prompt))
            r.prompt = np.concatenate([reqs[0].prompt[:r.prefix_len], prompt])
        reqs.append(r)
    return reqs


def predictable_workload(cfg: TraceConfig) -> List[Request]:
    """Homogeneous regime (paper Table 4): narrow spread, steady width."""
    rng = np.random.default_rng(cfg.seed)
    gl = max(2, int(64 * cfg.token_scale))
    pl = max(1, int(cfg.prompt_mean * cfg.token_scale))
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, size=pl).astype(np.int32),
                    gen_len=gl + int(rng.integers(0, 3)), arrival=0.0)
            for i in range(cfg.n_requests)]


def azure_like_replay(cfg: TraceConfig) -> List[Request]:
    """Bursty replay window (paper Fig. 4a-b, Table 1): heavy-tailed lengths
    + concentrated arrivals."""
    rng = np.random.default_rng(cfg.seed)
    gen = _heavy_tail_lengths(rng, cfg.n_requests, cfg.token_scale)
    plen = np.maximum(1, rng.poisson(cfg.prompt_mean * cfg.token_scale,
                                     cfg.n_requests))
    # bursty arrivals: Pareto-weighted window concentration (shared with
    # the gateway's open-loop client via bursty_arrivals)
    arrivals = bursty_arrivals(cfg.n_requests, cfg.window_s,
                               cfg.burstiness, rng)
    reqs = []
    for i in range(cfg.n_requests):
        prompt = rng.integers(0, cfg.vocab, size=int(plen[i])).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, gen_len=int(gen[i]),
                            arrival=float(arrivals[i])))
    return reqs


def shared_prefix_workload(cfg: TraceConfig) -> List[Request]:
    """Multi-turn / shared-system-prompt traffic (DESIGN.md §9): requests
    draw one of ``n_prefixes`` distinct system prompts of
    ``shared_prefix_len`` tokens and append a short unique user suffix
    (Poisson around ``prompt_mean``); generation lengths are modest
    (chat turns, Poisson around ``gen_mean``). No ``prefix_of`` hints are
    set — the sharing is implicit in the token streams, exactly what the
    engine's radix prefix cache discovers on its own. Arrivals are spread
    uniformly over ``window_s`` so later requests can hit prefixes
    committed by earlier ones (a t=0 burst would all miss a cold cache)."""
    rng = np.random.default_rng(cfg.seed)
    prefixes = [rng.integers(0, cfg.vocab, size=cfg.shared_prefix_len)
                .astype(np.int32) for _ in range(max(1, cfg.n_prefixes))]
    arrivals = np.sort(rng.uniform(0, cfg.window_s, size=cfg.n_requests))
    reqs = []
    for i in range(cfg.n_requests):
        pfx = prefixes[int(rng.integers(len(prefixes)))]
        suffix = rng.integers(
            0, cfg.vocab,
            size=max(1, int(rng.poisson(cfg.prompt_mean * cfg.token_scale)))
        ).astype(np.int32)
        gen = max(2, int(rng.poisson(cfg.gen_mean * cfg.token_scale)))
        reqs.append(Request(rid=i, prompt=np.concatenate([pfx, suffix]),
                            gen_len=gen, arrival=float(arrivals[i])))
    return reqs


def stop_token_workload(cfg: TraceConfig) -> List[Request]:
    """Variable-length decode driven by detected EOS (DESIGN.md §13): every
    request carries a stop set, and the gen_len budget is only a cap — the
    ACTUAL lengths are decided on-device by the sampled token stream, which
    is exactly the data-dependent heterogeneity the paper's static-graph
    retirement path has to absorb. The stop set is shared across the trace
    (one tokenizer's EOS ids) and drawn from the vocab unless pinned via
    ``cfg.stop_tokens``; budgets are heavy-tailed so budget-capped and
    stop-retired requests mix. Requires sampled decode (greedy=False) —
    the engine rejects stop sets in legacy mode."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.stop_tokens:
        stops = tuple(int(t) for t in cfg.stop_tokens)
    else:
        stops = tuple(sorted(int(t) for t in rng.choice(
            cfg.vocab, size=min(cfg.n_stop_tokens, cfg.vocab),
            replace=False)))
    gen = _heavy_tail_lengths(rng, cfg.n_requests, cfg.token_scale)
    plen = np.maximum(1, rng.poisson(cfg.prompt_mean * cfg.token_scale,
                                     cfg.n_requests))
    reqs = []
    for i in range(cfg.n_requests):
        prompt = rng.integers(0, cfg.vocab, size=int(plen[i])).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, gen_len=int(gen[i]),
                            arrival=0.0, stop_tokens=stops))
    return reqs


def trace_summary(reqs: List[Request]) -> dict:
    """Table-1-style heterogeneity summary."""
    gen = np.array([r.gen_len for r in reqs], float)
    arr = np.array([r.arrival for r in reqs], float)
    qs = np.percentile(gen, [50, 90, 99])
    hist, _ = np.histogram(arr, bins=20)
    top = np.sort(hist)[::-1]
    top10_share = top[:max(1, len(top) // 10)].sum() / max(1, hist.sum())
    return {"gen_p50": qs[0], "gen_p90": qs[1], "gen_p99": qs[2],
            "arrival_top10_share": float(top10_share),
            "n": len(reqs)}
