#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # every phase, one card

Phases, in order; any failure raises and the script exits non-zero:

1. device  — a CUDA card is present; print its name and power limit.
2. build   — compile every kernel of the main path from ``kernels/csrc``
             with nvcc for sm_90a, one process per source, timed.
3. kernels — on the card, each kernel against its plain PyTorch version at
             the parity shapes and at full qwen2.5-32b width, in bf16
             (atol = rtol = 2e-2: the plain version rounds p to bf16 before
             P·V as the reference does, the kernel keeps f32) and f32
             (atol 1e-4); skip-extent on and off bitwise equal; CUDA-event
             times of the kernel, the plain version and one PyTorch
             library call (``scaled_dot_product_attention`` on the gathered
             window, a yardstick the port never calls), beside the bound.
4. serve   — ``repro_torch.launch.serve.main`` at full qwen2.5-32b width
             (8 layers by default), paged_merge, 16 mixed requests; every
             request finishes, one frame commit per step, the pager leaks
             nothing, and the launch counters (zeroed just before) equal
             steps x layers and chunk dispatches x layers.
5. parity  — the same trace at full width with 2 layers, through the
             kernels and through the plain versions: per-rid token streams
             agree up to a near-tie (plain top-2 logit margin < 5e-2 at the
             first difference), the plain run launches no kernel, and
             steps / frames / pager stats equal a CPU run of the reduced
             config on the same lengths.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and per-type
# arithmetic rates used for each kernel's bound
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

ARCH = "qwen2.5-32b"
SERVE = dict(batch=8, max_seq=1024, near_window=512, block_tokens=16,
             prefill_chunk=64, requests=16, prompt_len=(32, 600),
             gen_len=(16, 128), seed=0)
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),
       "float32": dict(atol=1e-4, rtol=0.0)}
TIE_MARGIN = 5e-2
# kernel vs plain logits on identical inputs (full width, 2 layers): bf16
# logits near |5| have an ulp of 3.1e-2, and the plain version's bf16
# rounding of p moves attention outputs by up to the 2e-2 kernel tolerance
LOGIT_TOL = 0.25


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def window_base_of(t, W, BT):
    return (max(0, t + 1 - W) // BT) * BT


def decode_inputs(torch, dev, dtype, *, B, H, KV, hd, BT, NB, P, seq_lens,
                  active, seed):
    """Engine-shaped decode operands: each active slot's window table holds
    distinct physical blocks covering [wb, t]; unused entries are block 0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    W = (NB - 1) * BT
    perm = torch.randperm(P - 1, generator=g) + 1
    table = torch.zeros(B, NB, dtype=torch.int32)
    wbs = []
    used = 0
    for b, t in enumerate(seq_lens):
        wb = window_base_of(t, W, BT)
        wbs.append(wb)
        n = min(NB, (t - wb) // BT + 1)
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    rn = lambda *s: torch.randn(*s, generator=g).to(dtype)
    d = dict(q=rn(B, H, hd), pool_k=rn(P, BT, KV, hd), pool_v=rn(P, BT, KV, hd),
             block_table=table,
             window_base=torch.tensor(wbs, dtype=torch.int32),
             seq_lens=torch.tensor(seq_lens, dtype=torch.int32),
             slot_active=torch.tensor(active, dtype=torch.int32),
             cur_k=rn(B, KV, hd), cur_v=rn(B, KV, hd))
    d = {k: v.to(dev) for k, v in d.items()}
    return d, W


def chunk_inputs(torch, dev, dtype, *, B, C, H, KV, hd, BT, NB, P,
                 start_pos, n_valid, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    W = (NB - 1) * BT
    perm = torch.randperm(P - 1, generator=g) + 1
    table = torch.zeros(B, NB, dtype=torch.int32)
    wbs = []
    used = 0
    for b, s in enumerate(start_pos):
        wb = window_base_of(s, W, BT)
        wbs.append(wb)
        n = min(NB, (s + C - 1 - wb) // BT + 1)
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    rn = lambda *s: torch.randn(*s, generator=g).to(dtype)
    d = dict(q=rn(B, C, H, hd), pool_k=rn(P, BT, KV, hd),
             pool_v=rn(P, BT, KV, hd), cur_k=rn(B, C, KV, hd),
             cur_v=rn(B, C, KV, hd), block_table=table,
             window_base=torch.tensor(wbs, dtype=torch.int32),
             start_pos=torch.tensor(start_pos, dtype=torch.int32),
             n_valid=torch.tensor(n_valid, dtype=torch.int32))
    d = {k: v.to(dev) for k, v in d.items()}
    return d, W


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_decode(torch, pa, dev, dtype, shape, seed):
    d, W = decode_inputs(torch, dev, dtype, seed=seed, **shape)
    args = [d[k] for k in ("q", "pool_k", "pool_v", "block_table",
                           "window_base", "seq_lens", "slot_active")]
    kw = dict(near_window=W, cur_k=d["cur_k"], cur_v=d["cur_v"])
    on = pa.paged_decode_attention(*args, skip_extent=True, **kw)
    off = pa.paged_decode_attention(*args, skip_extent=False, **kw)
    want = pa.plain(*args, skip_extent=True, **kw)
    torch.cuda.synchronize()
    if not torch.equal(on, off):
        raise AssertionError(f"paged_decode skip on != off ({dtype}, {shape})")
    err = (on.float() - want.float()).abs().max().item()
    if not torch.allclose(on.float(), want.float(), **TOL[str(dtype)[6:]]):
        raise AssertionError(f"paged_decode vs plain: max abs err {err} "
                             f"({dtype}, {shape})")
    return d, W, err


def check_chunk(torch, pfa, dev, dtype, shape, seed):
    d, W = chunk_inputs(torch, dev, dtype, seed=seed, **shape)
    args = [d[k] for k in ("q", "pool_k", "pool_v", "cur_k", "cur_v",
                           "block_table", "window_base", "start_pos",
                           "n_valid")]
    on = pfa.chunked_prefill_attention(*args, near_window=W, skip_extent=True)
    off = pfa.chunked_prefill_attention(*args, near_window=W,
                                        skip_extent=False)
    want = pfa.plain(*args, near_window=W, skip_extent=True)
    torch.cuda.synchronize()
    if not torch.equal(on, off):
        raise AssertionError(f"chunked_prefill skip on != off ({dtype}, "
                             f"{shape})")
    err = (on.float() - want.float()).abs().max().item()
    if not torch.allclose(on.float(), want.float(), **TOL[str(dtype)[6:]]):
        raise AssertionError(f"chunked_prefill vs plain: max abs err {err} "
                             f"({dtype}, {shape})")
    return d, W, err


def decode_work(d, W, BT, elem):
    """Bytes the decode function must move (each input once: q, the window
    blocks in each active slot's extent, the current token, the output) and
    its flops (QK and PV over each active slot's valid keys)."""
    B, H, hd = d["q"].shape
    KV = d["pool_k"].shape[2]
    NB = d["block_table"].shape[1]
    byts = 2 * B * H * hd * elem + 2 * B * KV * hd * elem
    flops = 0
    for b in range(B):
        if int(d["slot_active"][b]) <= 0:
            continue
        t, wb = int(d["seq_lens"][b]), int(d["window_base"][b])
        lo_pos = max(0, t + 1 - W)
        lo = min(max((lo_pos - wb) // BT, 0), NB)
        hi = max(min(max((t - wb) // BT + 1, 0), NB), lo)
        byts += (hi - lo) * BT * KV * hd * 2 * elem + (hi - lo) * 4
        n_keys = t - lo_pos + 1               # (t - W, t) plus the current token
        flops += 4 * H * hd * n_keys
    return byts, flops


def chunk_work(d, W, BT, elem):
    B, C, H, hd = d["q"].shape
    KV = d["pool_k"].shape[2]
    NB = d["block_table"].shape[1]
    byts = 0
    flops = 0
    for b in range(B):
        nv = int(d["n_valid"][b])
        if nv <= 0:
            continue
        s, wb = int(d["start_pos"][b]), int(d["window_base"][b])
        byts += 2 * nv * H * hd * elem + 2 * nv * KV * hd * elem
        if s > wb:
            lo = min(max((max(0, s - W + 1) - wb) // BT, 0), NB)
            hi = max(min(max((s - 1 - wb) // BT + 1, 0), NB), lo)
            byts += (hi - lo) * BT * KV * hd * 2 * elem + (hi - lo) * 4
        for c in range(nv):
            p = s + c
            ctx = max(0, s - max(0, p - W + 1))       # pool keys before s
            own = min(c + 1, W)                       # chunk keys, causal
            flops += 4 * H * hd * (ctx + own)
    return byts, flops


def sdpa_decode(torch, d, W):
    """One library call on the gathered window (+ the current token)."""
    import torch.nn.functional as F
    B, H, hd = d["q"].shape
    P, BT, KV, _ = d["pool_k"].shape
    n_rep = H // KV
    tbl = d["block_table"].long()
    Wt = tbl.shape[1] * BT
    k = torch.cat([d["pool_k"][tbl].reshape(B, Wt, KV, hd),
                   d["cur_k"][:, None]], 1).permute(0, 2, 1, 3)
    v = torch.cat([d["pool_v"][tbl].reshape(B, Wt, KV, hd),
                   d["cur_v"][:, None]], 1).permute(0, 2, 1, 3)
    k = k.repeat_interleave(n_rep, 1).contiguous()
    v = v.repeat_interleave(n_rep, 1).contiguous()
    pos = d["window_base"].long()[:, None] + torch.arange(Wt, device=k.device)
    t = d["seq_lens"].long()[:, None]
    m = (pos < t) & (pos > t - W) & (pos >= 0)
    m = torch.cat([m, torch.ones_like(m[:, :1])], 1)[:, None, None, :]
    q = d["q"][:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)


def sdpa_chunk(torch, d, W):
    import torch.nn.functional as F
    B, C, H, hd = d["q"].shape
    P, BT, KV, _ = d["pool_k"].shape
    n_rep = H // KV
    tbl = d["block_table"].long()
    Wt = tbl.shape[1] * BT
    dev = d["q"].device
    k = torch.cat([d["pool_k"][tbl].reshape(B, Wt, KV, hd), d["cur_k"]], 1)
    v = torch.cat([d["pool_v"][tbl].reshape(B, Wt, KV, hd), d["cur_v"]], 1)
    k = k.permute(0, 2, 1, 3).repeat_interleave(n_rep, 1).contiguous()
    v = v.permute(0, 2, 1, 3).repeat_interleave(n_rep, 1).contiguous()
    s = d["start_pos"].long()[:, None]
    qpos = s + torch.arange(C, device=dev)[None]                 # (B, C)
    pos = d["window_base"].long()[:, None] + torch.arange(Wt, device=dev)
    mw = ((pos[:, None, :] < s[:, :, None]) & (pos[:, None, :] >= 0)
          & (pos[:, None, :] > qpos[:, :, None] - W))
    ij = torch.arange(C, device=dev)
    mc = ((ij[None, None, :] <= ij[None, :, None])
          & (ij[None, None, :] < d["n_valid"].long()[:, None, None])
          & (qpos[:, None, :] > qpos[:, :, None] - W))
    m = torch.cat([mw, mc], 2)[:, None]
    q = d["q"].permute(0, 2, 1, 3).contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)


def phase_kernels(torch):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import prefill_attention as pfa
    dev = torch.device("cuda")
    # parity shapes (reduced qwen2.5-32b, block_tokens 8) and the main
    # path's shapes (full width, W 512, BT 16, NB 33, the engine's pool)
    dec_shapes = {
        "parity": dict(B=4, H=4, KV=2, hd=16, BT=8, NB=3, P=40,
                       seq_lens=[0, 9, 23, 5], active=[1, 1, 1, 0]),
        "full": dict(B=8, H=40, KV=8, hd=128, BT=16, NB=33, P=521,
                     seq_lens=[0, 37, 300, 511, 512, 700, 1000, 64],
                     active=[1, 1, 1, 1, 1, 1, 0, 0]),
    }
    chk_shapes = {
        "parity": dict(B=4, C=8, H=4, KV=2, hd=16, BT=8, NB=3, P=40,
                       start_pos=[0, 8, 13, 30], n_valid=[8, 5, 8, 0]),
        "full": dict(B=8, C=64, H=40, KV=8, hd=128, BT=16, NB=33, P=521,
                     start_pos=[0, 64, 300, 512, 600, 900, 128, 0],
                     n_valid=[64, 64, 30, 64, 17, 64, 0, 1]),
    }
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, shp in dec_shapes.items():
            d, W, err = check_decode(torch, pa, dev, dtype, shp, seed=1)
            log(f"paged_decode {name} {dtype}: max_abs_err {err:.3e}; "
                f"skip on == off bitwise")
            if name == "full" and dtype == torch.bfloat16:
                res["paged_decode"] = (d, W, err, shp["BT"])
        for name, shp in chk_shapes.items():
            d, W, err = check_chunk(torch, pfa, dev, dtype, shp, seed=2)
            log(f"chunked_prefill {name} {dtype}: max_abs_err {err:.3e}; "
                f"skip on == off bitwise")
            if name == "full" and dtype == torch.bfloat16:
                res["chunked_prefill"] = (d, W, err, shp["BT"])

    rows = {}
    d, W, err, BT = res["paged_decode"]
    args = [d[k] for k in ("q", "pool_k", "pool_v", "block_table",
                           "window_base", "seq_lens", "slot_active")]
    kw = dict(near_window=W, cur_k=d["cur_k"], cur_v=d["cur_v"],
              skip_extent=True)
    byts, flops = decode_work(d, W, BT, 2)
    rows["paged_decode"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_attention.py:80",
        max_abs_err=err,
        ms=time_ms(torch, lambda: pa.paged_decode_attention(*args, **kw)),
        plain_ms=time_ms(torch, lambda: pa.plain(*args, **kw)),
        library_ms=time_ms(torch, sdpa_decode(torch, d, W)),
        **bound(byts, flops, "bfloat16"))
    d, W, err, BT = res["chunked_prefill"]
    args = [d[k] for k in ("q", "pool_k", "pool_v", "cur_k", "cur_v",
                           "block_table", "window_base", "start_pos",
                           "n_valid")]
    byts, flops = chunk_work(d, W, BT, 2)
    rows["chunked_prefill"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chunked_prefill.cu",
        replaces="src/repro/kernels/prefill_attention.py:78",
        max_abs_err=err,
        ms=time_ms(torch, lambda: pfa.chunked_prefill_attention(
            *args, near_window=W, skip_extent=True)),
        plain_ms=time_ms(torch, lambda: pfa.plain(
            *args, near_window=W, skip_extent=True)),
        library_ms=time_ms(torch, sdpa_chunk(torch, d, W)),
        **bound(byts, flops, "bfloat16"))
    for k, r in rows.items():
        log(f"{k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, sdpa "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")
    return rows


def bound(byts, flops, dtype):
    t_bytes = byts / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=byts, flops=flops)


# ---------------------------------------------------------------------------
# phases 4 and 5: the engine
# ---------------------------------------------------------------------------

def serve_argv(n_layers, device="cuda", full_width=True):
    s = SERVE
    return ["--arch", ARCH, "--mode", "paged_merge", "--workload", "mixed",
            "--requests", str(s["requests"]), "--batch", str(s["batch"]),
            "--max-seq", str(s["max_seq"]),
            "--near-window", str(s["near_window"]),
            "--block-tokens", str(s["block_tokens"]),
            "--prefill-chunk", str(s["prefill_chunk"]),
            "--prompt-len", "%d:%d" % s["prompt_len"],
            "--gen-len", "%d:%d" % s["gen_len"],
            "--seed", str(s["seed"]), "--device", device,
            "--n-layers", str(n_layers)] + (["--full-width"] if full_width
                                            else [])


def check_engine(eng, n_requests):
    a = eng.audit()
    L = eng.cfg.n_layers
    fin = eng.sched.finished
    assert len(fin) == n_requests, f"{len(fin)} of {n_requests} finished"
    assert all(len(r.generated) == r.gen_len for r in fin)
    V = eng.cfg.vocab_size
    assert all(0 <= t < V for r in fin for t in r.generated)
    assert a["single_commit_per_step"], a
    eng.pager.check_invariants()
    assert eng.pager.reserved_blocks() == 0, "leaked pager blocks"
    return a, L


def phase_serve(torch, n_layers, device="cuda", full_width=True):
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve
    runtime.reset_launches()
    out, engines = serve.main(serve_argv(n_layers, device, full_width),
                              return_engines=True)
    launches = dict(runtime.LAUNCHES)
    eng = engines[0]
    a, L = check_engine(eng, SERVE["requests"])
    assert a["decode_kernel_launches"] == eng.steps_run * L, a
    assert a["chunk_kernel_launches"] == eng._chunk_dispatches * L, a
    assert launches["paged_decode"] == eng.steps_run * L, launches
    assert launches["chunked_prefill"] == eng._chunk_dispatches * L, launches
    assert eng._chunk_dispatches > 0 and a["kernel_blocks_skipped"] > 0
    lat = out["latency"]
    summary = dict(
        tokens_s=out["throughput_tok_s"], wall_tok_s=out["wall_tok_s"],
        step_p50_ms=lat["p50_ms"], step_p99_ms=lat["p99_ms"],
        steps=eng.steps_run, chunk_dispatches=eng._chunk_dispatches,
        tokens=out["tokens"], n_layers=L,
        peak_reserved_kv_bytes=a["peak_reserved_kv"],
        max_memory_allocated=out.get("max_memory_allocated"),
        pager_stats=dict(eng.pager.stats))
    log("serve:", json.dumps(summary))
    del engines, eng
    return launches, summary


def phase_parity(torch, n_layers=2, device="cuda", full_width=True):
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import ops, runtime
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.serving.factory import build
    s = SERVE
    cfg = (get_config(ARCH) if full_width else get_reduced(ARCH)).replace(
        n_layers=n_layers)
    params = registry.init_params(cfg, seed=s["seed"], device=device)
    ekw = dict(mode="paged_merge", batch=s["batch"], max_seq=s["max_seq"],
               near_window=s["near_window"], block_tokens=s["block_tokens"],
               prefill_chunk=s["prefill_chunk"])

    def trace():
        return serve.make_workload(s["requests"], cfg.vocab_size,
                                   seed=s["seed"], prompt_len=s["prompt_len"],
                                   gen_len=s["gen_len"])

    runs = {}
    for impl in ("kernel", "plain"):
        ops.set_default_impl(impl)
        runtime.reset_launches()
        eng = build(ARCH, cfg=cfg, params=params, device=device,
                    debug_logits=True, **ekw)[0]
        serve.run_lanes([eng], trace())
        check_engine(eng, s["requests"])
        runs[impl] = (eng, dict(runtime.LAUNCHES))
    ops.set_default_impl("kernel")
    k_eng, k_launch = runs["kernel"]
    p_eng, p_launch = runs["plain"]
    if device == "cuda":
        assert k_launch["paged_decode"] == k_eng.steps_run * n_layers, k_launch
    assert p_launch == {k: 0 for k in p_launch}, p_launch

    for eng in (k_eng, p_eng):
        assert all(np.isfinite(lg).all() for lg in eng.debug_logits)
    kreq = {r.rid: r for r in k_eng.sched.finished}
    preq = {r.rid: r for r in p_eng.sched.finished}
    ties = 0
    first_diff = []
    logit_diff = 0.0
    n_cmp = 0
    for rid, kr in kreq.items():
        pr = preq[rid]
        toks, ptoks = list(kr.generated), list(pr.generated)
        i = next((j for j, (a, b) in enumerate(zip(toks, ptoks)) if a != b),
                 len(toks))
        # up to and including its first differing token a request saw the
        # same inputs in both runs: its logits differ only by the kernels
        for j in range(min(i + 1, len(toks))):
            logit_diff = max(logit_diff, float(np.abs(
                kr.logit_trace[j] - pr.logit_trace[j]).max()))
            n_cmp += 1
        if i == len(toks):
            continue
        top2 = np.sort(pr.logit_trace[i])[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE_MARGIN, (
            f"rid {rid}: kernel and plain streams differ at token {i} where "
            f"the plain top-2 margin is {margin} >= {TIE_MARGIN}")
        ties += 1
        first_diff.append(i)
    assert logit_diff < LOGIT_TOL, (
        f"kernel vs plain logits differ by {logit_diff} on identical inputs")

    # the control plane depends on lengths only: a CPU run of the reduced
    # config over the same lengths must commit the same frames
    cpu = build(ARCH, device="cpu", **ekw)[0]
    reqs = trace()
    for r in reqs:
        r.prompt = r.prompt % cpu.cfg.vocab_size
    serve.run_lanes([cpu], reqs)
    for eng in (k_eng, p_eng):
        assert eng.steps_run == cpu.steps_run, (eng.steps_run, cpu.steps_run)
        assert eng.frames_committed == cpu.frames_committed
        assert eng.pager.stats == cpu.pager.stats, (eng.pager.stats,
                                                     cpu.pager.stats)
    out = dict(steps=k_eng.steps_run, rids=len(kreq),
               streams_identical=len(kreq) - ties, tie_divergences=ties,
               first_diff_token_index=sorted(first_diff),
               logits_compared=n_cmp, logits_max_abs_diff=logit_diff,
               pager_stats_equal_cpu=True)
    log("parity:", json.dumps(out))
    return out


def phase_profile(torch, n_layers, out_path=None):
    """torch.profiler over the serve phase's trace, every step after the
    first (warm-up) until the engine drains: device busy share and kernel
    time by category. Not in the default phases; ``out_path`` receives the
    summary and the profiler's table of the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving.factory import build
    s = SERVE
    cfg = get_config(ARCH).replace(n_layers=n_layers)
    eng = build(ARCH, cfg=cfg, seed=s["seed"], device="cuda", mode="paged_merge",
                batch=s["batch"], max_seq=s["max_seq"],
                near_window=s["near_window"], block_tokens=s["block_tokens"],
                prefill_chunk=s["prefill_chunk"])[0]
    for r in serve.make_workload(s["requests"], cfg.vocab_size, seed=s["seed"],
                                 prompt_len=s["prompt_len"],
                                 gen_len=s["gen_len"]):
        eng.submit(r)
    eng.step()
    torch.cuda.synchronize()
    step0, chunk0 = eng.steps_run, eng._chunk_dispatches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while eng.sched.waiting or eng.sched.active_slots():
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -1.0
    for a, b in spans:                       # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    cats = {}
    for e in kernels:
        n = e.name.lower()
        cat = ("paged_decode kernel" if "paged_decode" in n else
               "chunked_prefill kernel" if "chunked_prefill" in n else
               "matmul (cuBLAS)" if any(k in n for k in (
                   "nvjet", "splitkreduce", "gemm", "gemv", "xmma", "cutlass"))
               else "memcpy" if "memcpy" in n else "other (elementwise etc.)")
        t, c = cats.get(cat, (0.0, 0))
        cats[cat] = (t + (e.time_range.end - e.time_range.start), c + 1)
    out = dict(steps=eng.steps_run - step0,
               chunk_dispatches=eng._chunk_dispatches - chunk0,
               n_layers=n_layers, wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
               idle_share=1 - busy / wall_us,
               by_category_ms={k: v[0] / 1e3 for k, v in sorted(cats.items())},
               launches_by_category={k: v[1] for k, v in sorted(cats.items())})
    log("profile:", json.dumps(out))
    if out_path:
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40)
        path = Path(out_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1) + "\n\n" + table)
    return out


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-layers", type=int, default=8,
                    help="depth of the full-width serve phase (64 = all)")
    ap.add_argument("--phases", default="build,kernels,serve,parity",
                    help="comma-separated subset (the device phase always "
                         "runs); 'profile' adds a torch.profiler pass")
    ap.add_argument("--profile-out", default=None,
                    help="file for the profile phase's kernel table")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False")
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import runtime

    t_all = time.perf_counter()
    smi = nvidia_smi_line()
    log("card:", smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])

    if "build" in phases:
        t0 = time.perf_counter()
        logs = runtime.build()
        log(f"build: {time.perf_counter() - t0:.1f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line.lower():
                    log(f"  {name}: {line.strip()}")

    rows = phase_kernels(torch) if "kernels" in phases else {}
    launches = {}
    if "serve" in phases:
        launches, _ = phase_serve(torch, args.n_layers)
        missing = [k for k, n in launches.items() if n <= 0]
        assert not missing, f"kernels never launched on the main path: {missing}"
    if "parity" in phases:
        phase_parity(torch)
    if "profile" in phases:
        phase_profile(torch, args.n_layers, args.profile_out)

    kernels = []
    for name, r in rows.items():
        kernels.append({"name": name, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": launches.get(name, 0),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
