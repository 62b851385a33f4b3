"""Serving launcher: run a workload through the KV-RM engine (or the
static-arena baseline) on one card and print throughput / tail latency /
memory / transport / invariant audits.

Counterpart of ``repro/launch/serve.py`` for the flags the port has:

    python -m repro_torch.launch.serve --device cuda --full-width \\
        --n-layers 8 --requests 16 --max-seq 1024 --near-window 512 \\
        --block-tokens 16 --prefill-chunk 64

``--mode full`` adds the far view (``EngineConfig.farview_cap`` and
``sv_chunk`` at their defaults). ``--full-width`` serves the
architecture's published widths (random weights from ``--seed``), cut in
depth to ``--n-layers``; without it the reduced config runs. ``--device cpu`` runs the plain PyTorch path on the
CPU. ``--prompt-len LO:HI`` / ``--gen-len LO:HI`` replace the mixed
workload's lengths with uniform draws from a seeded numpy generator.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.scheduler import Request
from repro_torch.data import traces
from repro_torch.serving.factory import build


def run_lanes(engines: list, reqs, *, max_steps: int = 100_000,
              now_fn=None) -> dict:
    """Submit the trace, step the engine(s) until it drains, and aggregate
    the audits. ``aggregate_tok_s`` skips the first round of steps (warm-up:
    first kernel loads, allocator growth); ``wall_tok_s`` is end to end."""
    for i, r in enumerate(reqs):
        engines[i % len(engines)].submit(r)
    t0 = time.perf_counter()
    t_warm = t0
    warm_tok = 0
    steps = 0
    while steps < max_steps:
        busy = False
        for eng in engines:
            if eng.sched.waiting or eng.sched.preempted \
                    or eng.sched.active_slots():
                eng.step(now=now_fn() if now_fn else float("inf"))
                busy = True
        if steps == 0:
            t_warm = time.perf_counter()
            warm_tok = sum(m.emitted for e in engines for m in e.metrics)
        steps += 1
        if not busy:
            break
    for eng in engines:
        eng.flush()
    end = time.perf_counter()

    tok = sum(sum(len(r.generated) for r in e.sched.finished) for e in engines)
    emitted = sum(m.emitted for e in engines for m in e.metrics)
    return {
        "lanes": len(engines),
        "finished": sum(len(e.sched.finished) for e in engines),
        "tokens": tok,
        "aggregate_tok_s": (emitted - warm_tok) / max(end - t_warm, 1e-12),
        "wall_tok_s": tok / max(end - t0, 1e-12),
        "per_lane_tok_s": [e.throughput() for e in engines],
        "audit": engines[0].audit(),
        "latency": engines[0].latency_stats(),
    }


def _range(text: str):
    lo, hi = (int(x) for x in text.split(":"))
    if not 1 <= lo <= hi:
        raise argparse.ArgumentTypeError(f"want LO:HI with 1 <= LO <= HI, "
                                         f"got {text!r}")
    return lo, hi


def uniform_lengths(reqs, prompt_len, gen_len, vocab: int, seed: int):
    """Redraw a workload's prompt and generation lengths uniformly from
    ``[lo, hi]`` (a seeded numpy generator), keeping rids and arrivals."""
    rng = np.random.default_rng(seed)
    out = []
    for r in reqs:
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1)) \
            if prompt_len else len(r.prompt)
        glen = int(rng.integers(gen_len[0], gen_len[1] + 1)) \
            if gen_len else r.gen_len
        out.append(Request(rid=r.rid, arrival=r.arrival, gen_len=glen,
                           prompt=rng.integers(0, vocab, size=plen)
                           .astype(np.int32)))
    return out


def make_workload(n_requests: int, vocab: int, *, seed: int = 0,
                  prompt_len=None, gen_len=None):
    """The ``mixed`` workload of ``--workload mixed`` (all arrive at t=0;
    lengths at the reference launcher's default token scale 0.25), with
    optional uniform length ranges."""
    tcfg = traces.TraceConfig(n_requests=n_requests, vocab=vocab,
                              token_scale=0.25, seed=seed)
    reqs = traces.mixed_length_workload(tcfg)
    if prompt_len or gen_len:
        reqs = uniform_lengths(reqs, prompt_len, gen_len, vocab, seed)
    return reqs


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b")
    ap.add_argument("--mode", default="paged_merge",
                    choices=["arena", "paged", "paged_merge", "full"],
                    help="'full' adds the bounded far view (summaries of "
                         "completed sv_chunks; prompts then ride the decode "
                         "step)")
    ap.add_argument("--workload", default="mixed", choices=["mixed"])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--near-window", type=int, default=None,
                    help="near-window width W (tokens); default max_seq")
    ap.add_argument("--block-tokens", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="tokens per chunked-prefill step (0 = prompts go "
                         "token at a time through the decode step)")
    ap.add_argument("--prompt-len", type=_range, default=None,
                    help="LO:HI uniform prompt lengths (overrides the mix)")
    ap.add_argument("--gen-len", type=_range, default=None,
                    help="LO:HI uniform generation lengths")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of the trace")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--full-width", action="store_true",
                    help="the architecture's published widths (random "
                         "weights) instead of the reduced config")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    return ap


def main(argv=None, *, return_engines: bool = False):
    args = build_arg_parser().parse_args(argv)
    cfg = None
    if args.full_width or args.n_layers is not None:
        cfg = get_config(args.arch) if args.full_width \
            else get_reduced(args.arch)
        if args.n_layers is not None:
            cfg = cfg.replace(n_layers=args.n_layers)
    engines = build(args.arch, mode=args.mode, batch=args.batch,
                    max_seq=args.max_seq, near_window=args.near_window,
                    block_tokens=args.block_tokens,
                    prefill_chunk=args.prefill_chunk, seed=args.seed,
                    cfg=cfg, device=args.device)
    eng = engines[0]
    reqs = make_workload(args.requests, eng.cfg.vocab_size, seed=args.seed,
                         prompt_len=args.prompt_len, gen_len=args.gen_len)
    print("workload:", traces.trace_summary(reqs))

    if eng.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(eng.device)
    out = run_lanes(engines, reqs)
    out["throughput_tok_s"] = out["aggregate_tok_s"]
    out["device"] = (torch.cuda.get_device_name(eng.device)
                     if eng.device.type == "cuda" else "cpu")
    out["n_layers"] = eng.cfg.n_layers
    out["d_model"] = eng.cfg.d_model
    if eng.device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            eng.device)

    for k, v in out.items():
        print(f"{k}: {v}")
    if return_engines:
        return out, engines
    return out


if __name__ == "__main__":
    main()
