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
             (atol 1e-4); the decode kernel also with the far view (its
             far_util within 1e-4), the summarize kernel within one bf16
             ulp / 1e-5 in f32; skip-extent on and off bitwise equal, a far
             view with every entry masked bitwise equal to none, far_util
             equal from run to run; CUDA-event times of the kernel, the
             plain version and one PyTorch library call (a yardstick the
             port never calls: ``scaled_dot_product_attention`` on the
             gathered window (+ far entries), ``torch.mean`` over the
             gathered chunk), beside the bound.
3b. decode_skew — the card's counterpart of bench_decode_skew.py's kernel
             section at qwen2.5-32b decode width (B 8, H 40, KV 8, hd 128,
             BT 16, W 512, NB 33, tail-adjacent tables, window base 0):
             uniform, bimodal and trace lengths (one slot retired in each;
             one more case on permuted tables) in bf16, f32 and fp8_e4m3 /
             int8 pools, through the pool-only form (the current token in
             the pool): the double-buffered kernel (``prefetch_depth=1``,
             the port of ``_decode_kernel_db``) with ``dma`` on and off and
             the pool-only ``_decode_kernel`` port, skip on and off, run
             twice: all bitwise equal; against the plain version within
             the kernels phase's tolerances (2e-2 for narrow pools); the
             retired slot zero. Launches counted per dtype (zeroed just
             before that dtype's run), then each variant's time beside the
             active blocks' byte bound, the plain version and SDPA on the
             gathered window, printed as one JSON line.
4. serve   — ``repro_torch.launch.serve.main`` at full qwen2.5-32b width
             (8 layers by default), paged_merge, 16 mixed requests; every
             request finishes, one frame commit per step, the pager leaks
             nothing, and the launch counters (zeroed just before) equal
             steps x layers and chunk dispatches x layers.
5. serve_full — the same trace through ``--mode full`` (near window 256,
             sv_chunk 64, farview_cap 16, so max_chunks 13): the same
             checks, summaries written and their blocks trimmed, the
             chunked prefill executor off, the summarize and decode
             launches each equal to steps x layers, and a peak of reserved
             KV below the paged_merge phase's on the same trace.
6. parity  — the serve trace at full width with 2 layers, through the
             kernels and through the plain versions: per-rid token streams
             agree up to a near-tie (plain top-2 logit margin < 5e-2 at the
             first difference), the plain run launches no kernel, and
             steps / frames / pager stats equal a CPU run of the reduced
             config on the same lengths.
7. parity_full — the same in ``mode="full"`` (streams may part where the
             plain top-2 margin is below ``TIE_MARGIN_FULL``), each slot's
             far utility per step agrees while its request's inputs are
             identical, and the far tables equal the CPU run's.
8. serve_encdec — seamless-m4t-medium at its published widths and full
             depth (12 encoder + 12 decoder layers), paged_merge: 16
             requests of S_enc 64-1000 frames, decoder prompts 4-32 and
             generations 16-128; every request finishes, one commit per
             step, no leaked block, the dense prefill kernel launched
             admissions x 12 times and the decode kernel steps x 12.
9. parity_encdec — the serve_encdec trace at full width with 2 + 2
             layers, through the kernels and through the plain versions:
             encoder outputs and the cross pools within ``ENC_ULPS``,
             logits within ``LOGIT_TOL`` on identical inputs, streams part
             only below ``TIE_MARGIN_ENCDEC``; steps, frames and pager
             stats equal a CPU run of the reduced config.
10. serve_quant — the serve trace with ``--kv-dtype fp8_e4m3`` and again
             with ``int8`` (the quantized KV tier): serve's checks, the
             quantized branches of both paged kernels launched steps x
             layers and chunk dispatches x layers, and a peak of reserved
             KV of the same blocks as serve's at the narrow block size.
11. parity_quant — the serve trace at full width with 2 layers and each
             narrow dtype, the kernel path and the plain path stepped in
             lockstep: after every step, layer 0's codes and scales of each
             block written by a request whose tokens agree in both runs are
             bitwise equal, logits within ``LOGIT_TOL``, streams part only
             below ``TIE_MARGIN``; steps, frames and pager stats equal a
             CPU run.

The kernels phase holds the quantized branches (fp8_e4m3 and int8 pools
with per-(block, kv head) scales) against their plain versions with the
same tolerances, run == run and skip on == off bitwise; their library
yardstick is SDPA over the window already dequantized (the dequantize
excluded).

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
# a device spin of ~0.1 s at the H100's 1.98 GHz boost clock: longer than
# the host needs to enqueue one timing's launches
SPIN_CYCLES = 200_000_000
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

ARCH = "qwen2.5-32b"
ENCDEC = "seamless-m4t-medium"
SERVE = dict(batch=8, max_seq=1024, near_window=512, block_tokens=16,
             prefill_chunk=64, requests=16, prompt_len=(32, 600),
             gen_len=(16, 128), seed=0)
TOL = {"bfloat16": dict(atol=2e-2, rtol=2e-2),
       "float32": dict(atol=1e-4, rtol=0.0)}
# mode="full": the serve trace with a 256-token near window (sv_chunk 64 and
# farview_cap 16 are EngineConfig's defaults)
SERVE_FULL = dict(SERVE, near_window=256)
# seamless-m4t-medium: speech-to-text translation, one utterance of S_enc
# frames encoded once per request, a short target-language prefix and a
# sentence-length output; prompts ride the decode step (no chunked prefill
# for encdec)
SERVE_ENCDEC = dict(batch=8, max_seq=1024, near_window=512, block_tokens=16,
                    requests=16, enc_len=(64, 1000), prompt_len=(4, 32),
                    gen_len=(16, 128), seed=0)
# summaries: one bf16 ulp, or a 64-term f32 sum taken in another order
SUM_TOL = {"float32": 1e-5}
# far_util (f32 sums of probabilities the kernel and the plain version
# compute from the same scores)
UTIL_TOL = 1e-4
TIE_MARGIN = 5e-2
# kernel vs plain logits on identical inputs (full width, 2 layers): bf16
# logits near |5| have an ulp of 3.1e-2, and the plain version's bf16
# rounding of p moves attention outputs by up to the 2e-2 kernel tolerance
LOGIT_TOL = 0.25
# mode="full" feeds every prompt token through the decode step, one at a
# time, so each path's K/V history holds its own bf16 roundings of every
# prompt token (chunked prefill writes them 64 at a time in paged_merge).
# Two logits that each round up to two bf16 ulps apart at magnitudes in
# [4, 8) (ulp 0.03125) can swap order within a margin of 0.125
TIE_MARGIN_FULL = 0.125
# per-step far utility of one slot, kernel vs plain, while its request's
# inputs are identical: a sum over 40 heads of probabilities whose queries
# passed through attention outputs that differ within the kernel tolerance
# (1.8e-4 measured on an H100)
FAR_UTIL_STEP_TOL = 1e-2
# encdec, kernel vs plain path: the kernel keeps the encoder's attention
# scores in f32 where the plain version rounds them (and p) to bf16, so
# each encoder layer's output may round a few ulps apart and the cross K/V
# carry those roundings. Held in bf16 ulps of each token row's scale (max
# |x| over d_model, or over all heads of K or V)
ENC_ULPS = 8
# decoder logits on identical decoder inputs differ through those cross
# K/V; streams may part where the plain top-2 margin is below this
TIE_MARGIN_ENCDEC = 0.125
# the quantized KV tier: the narrow storage dtypes
KV_DTYPES = ("fp8_e4m3", "int8")
# decode_skew: bench_decode_skew.py's kernel geometry at qwen2.5-32b decode
# width (NB = W / BT + 1 window blocks, P = B NB + 1 pool blocks); the q
# dtypes, and the narrow pools (under bf16 q)
SKEW = dict(B=8, H=40, KV=8, hd=128, BT=16, W=512)
SKEW_KINDS = ("bfloat16", "float32") + KV_DTYPES


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
    """Device time per call: the timed launches queue up behind a spin of
    the card (``torch.cuda._sleep``) before the first event, so a call
    whose host-side launch costs more than its device work (a small kernel
    behind a Python wrapper) is timed by its device work, not by the
    host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def quantize_pool(torch, pool, kv_dtype):
    """A (P, BT, KV, hd) pool as the quantized tier stores it: narrow codes
    and (P, KV) f32 scales, each block's absmax over its rows per kv
    head mapped to the dtype's range (ref.quant_range)."""
    from repro_torch.kernels import ref
    dt = {"fp8_e4m3": torch.float8_e4m3fn, "int8": torch.int8}[kv_dtype]
    qmax = ref.quant_range(dt)
    x = pool.float()
    scale = (x.abs().amax(dim=(1, 3)) / qmax).contiguous()
    x = torch.clamp(x / scale.clamp_min(1e-12)[:, None, :, None], -qmax, qmax)
    if dt == torch.int8:
        x = torch.round(x)
    return x.to(dt).contiguous(), scale


def quant_inputs(torch, d, kv_dtype):
    """``d`` with its pools replaced by narrow codes, plus their scales."""
    d = dict(d)
    d["pool_k"], d["k_scale"] = quantize_pool(torch, d["pool_k"], kv_dtype)
    d["pool_v"], d["v_scale"] = quantize_pool(torch, d["pool_v"], kv_dtype)
    return d


def dequantized(torch, d, dtype):
    """``d`` with the quantized pools dequantized into ``dtype`` (the
    library yardstick's inputs: the dequantize is not timed)."""
    out = dict(d)
    for n in ("k", "v"):
        out["pool_" + n] = (d["pool_" + n].float()
                            * d[n + "_scale"][:, None, :, None]).to(dtype)
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_decode(torch, pa, dev, dtype, shape, seed, kv_dtype=None):
    """The decode kernel against its plain version (with ``kv_dtype``: its
    quantized branch, on the same inputs quantized); skip on == off and
    run == run bitwise."""
    d, W = decode_inputs(torch, dev, dtype, seed=seed, **shape)
    kw = dict(near_window=W, cur_k=d["cur_k"], cur_v=d["cur_v"])
    if kv_dtype is not None:
        d = quant_inputs(torch, d, kv_dtype)
        kw.update(k_scale=d["k_scale"], v_scale=d["v_scale"])
    args = [d[k] for k in ("q", "pool_k", "pool_v", "block_table",
                           "window_base", "seq_lens", "slot_active")]
    on = pa.paged_decode_attention(*args, skip_extent=True, **kw)
    off = pa.paged_decode_attention(*args, skip_extent=False, **kw)
    again = pa.paged_decode_attention(*args, skip_extent=True, **kw)
    want = pa.plain(*args, skip_extent=True, **kw)
    torch.cuda.synchronize()
    tag = f"({kv_dtype or 'same-type pool'}, {dtype}, {shape})"
    if not torch.equal(on, off):
        raise AssertionError(f"paged_decode skip on != off {tag}")
    if not torch.equal(on, again):
        raise AssertionError(f"paged_decode: two runs differ {tag}")
    if not torch.isfinite(on).all():
        raise AssertionError(f"paged_decode: non-finite output {tag}")
    err = (on.float() - want.float()).abs().max().item()
    if not torch.allclose(on.float(), want.float(), **TOL[str(dtype)[6:]]):
        raise AssertionError(f"paged_decode vs plain: max abs err {err} "
                             f"{tag}")
    return d, W, err


def check_chunk(torch, pfa, dev, dtype, shape, seed, kv_dtype=None):
    """The chunk kernel against its plain version (with ``kv_dtype``: its
    quantized branch); skip on == off and run == run bitwise."""
    d, W = chunk_inputs(torch, dev, dtype, seed=seed, **shape)
    kw = dict(near_window=W)
    if kv_dtype is not None:
        d = quant_inputs(torch, d, kv_dtype)
        kw.update(k_scale=d["k_scale"], v_scale=d["v_scale"])
    args = [d[k] for k in ("q", "pool_k", "pool_v", "cur_k", "cur_v",
                           "block_table", "window_base", "start_pos",
                           "n_valid")]
    on = pfa.chunked_prefill_attention(*args, skip_extent=True, **kw)
    off = pfa.chunked_prefill_attention(*args, skip_extent=False, **kw)
    again = pfa.chunked_prefill_attention(*args, skip_extent=True, **kw)
    want = pfa.plain(*args, skip_extent=True, **kw)
    torch.cuda.synchronize()
    tag = f"({kv_dtype or 'same-type pool'}, {dtype}, {shape})"
    if not torch.equal(on, off):
        raise AssertionError(f"chunked_prefill skip on != off {tag}")
    if not torch.equal(on, again):
        raise AssertionError(f"chunked_prefill: two runs differ {tag}")
    if not torch.isfinite(on).all():
        raise AssertionError(f"chunked_prefill: non-finite output {tag}")
    err = (on.float() - want.float()).abs().max().item()
    if not torch.allclose(on.float(), want.float(), **TOL[str(dtype)[6:]]):
        raise AssertionError(f"chunked_prefill vs plain: max abs err {err} "
                             f"{tag}")
    return d, W, err


def far_inputs(torch, dev, dtype, *, B, KV, hd, MAXC, CAP, n_chunks, seed):
    """Far pools and the table the host policy selects for slots holding
    n_chunks summaries: arange(n) when n <= CAP, else CAP of them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    table = torch.zeros(B, CAP, dtype=torch.int32)
    valid = torch.zeros(B, CAP, dtype=torch.int32)
    for b, n in enumerate(n_chunks):
        if n <= CAP:
            table[b, :n] = torch.arange(n, dtype=torch.int32)
            valid[b, :n] = 1
        else:
            table[b] = torch.randperm(n, generator=g)[:CAP].sort().values
            valid[b] = 1
    rn = lambda *s: torch.randn(*s, generator=g).to(dtype)
    d = dict(far_k=rn(B, MAXC, KV, hd), far_v=rn(B, MAXC, KV, hd),
             far_table=table, far_valid=valid)
    return {k: v.to(dev) for k, v in d.items()}


def check_decode_far(torch, pa, dev, dtype, shape, far_shape, seed):
    d, W = decode_inputs(torch, dev, dtype, seed=seed, **shape)
    f = far_inputs(torch, dev, dtype, B=shape["B"], KV=shape["KV"],
                   hd=shape["hd"], seed=seed + 1, **far_shape)
    args = [d[k] for k in ("q", "pool_k", "pool_v", "block_table",
                           "window_base", "seq_lens", "slot_active")]
    kw = dict(near_window=W, cur_k=d["cur_k"], cur_v=d["cur_v"])
    on, u_on = pa.paged_decode_attention(*args, skip_extent=True, **kw, **f)
    off, u_off = pa.paged_decode_attention(*args, skip_extent=False, **kw,
                                           **f)
    again, u_again = pa.paged_decode_attention(*args, skip_extent=True, **kw,
                                               **f)
    masked = dict(f, far_valid=torch.zeros_like(f["far_valid"]))
    none, u_none = pa.paged_decode_attention(*args, skip_extent=True, **kw,
                                             **masked)
    base = pa.paged_decode_attention(*args, skip_extent=True, **kw)
    want, u_want = pa.plain(*args, skip_extent=True, **kw, **f)
    torch.cuda.synchronize()
    tag = f"({dtype}, {shape}, {far_shape})"
    if not (torch.equal(on, off) and torch.equal(u_on, u_off)):
        raise AssertionError(f"paged_decode far view: skip on != off {tag}")
    if not (torch.equal(on, again) and torch.equal(u_on, u_again)):
        raise AssertionError(f"paged_decode far view: two runs differ {tag}")
    if not torch.equal(none, base) or u_none.any():
        raise AssertionError(f"paged_decode: an all-masked far view is not "
                             f"a bitwise no-op {tag}")
    err = (on.float() - want.float()).abs().max().item()
    uerr = (u_on - u_want).abs().max().item()
    if not torch.allclose(on.float(), want.float(), **TOL[str(dtype)[6:]]):
        raise AssertionError(f"paged_decode far view vs plain: max abs err "
                             f"{err} {tag}")
    if not uerr <= UTIL_TOL:
        raise AssertionError(f"far_util vs plain: max abs err {uerr} {tag}")
    if not u_on.sum() > 0:
        raise AssertionError(f"far_util is all zero {tag}")
    return d, f, W, max(err, uerr)


def summarize_inputs(torch, dev, dtype, *, P, BT, KV, hd, B, CB, n_tokens,
                     gate, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    blocks = (torch.randperm(P - 1, generator=g)[:B * CB] + 1).reshape(B, CB)
    rn = lambda *s: torch.randn(*s, generator=g).to(dtype)
    d = dict(pool_k=rn(P, BT, KV, hd), pool_v=rn(P, BT, KV, hd),
             chunk_blocks=blocks.to(torch.int32),
             n_tokens=torch.tensor(n_tokens, dtype=torch.int32),
             do_summarize=torch.tensor(gate, dtype=torch.int32))
    return {k: v.to(dev) for k, v in d.items()}


def check_summarize(torch, fvs, dev, dtype, shape, seed):
    d = summarize_inputs(torch, dev, dtype, seed=seed, **shape)
    meta = [d[k] for k in ("chunk_blocks", "n_tokens", "do_summarize")]
    sk, sv = fvs.farview_summarize(d["pool_k"], d["pool_v"], *meta)
    again = fvs.farview_summarize(d["pool_k"], d["pool_v"], *meta)
    wk, wv = fvs.plain(d["pool_k"], *meta), fvs.plain(d["pool_v"], *meta)
    torch.cuda.synchronize()
    tag = f"({dtype}, {shape})"
    if not (torch.equal(sk, again[0]) and torch.equal(sv, again[1])):
        raise AssertionError(f"farview_summarize: two runs differ {tag}")
    off = d["do_summarize"] <= 0
    if sk[off].any() or sv[off].any():
        raise AssertionError(f"farview_summarize: a gated-off slot is not 0 "
                             f"{tag}")
    err = 0.0
    for got, want in ((sk, wk), (sv, wv)):
        diff = (got.float() - want.float()).abs()
        err = max(err, diff.max().item())
        if dtype == torch.bfloat16:      # one bf16 ulp of the larger value
            mag = torch.maximum(got.float().abs(), want.float().abs())
            ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
            ok = bool((diff <= torch.where(mag > 0, ulp, 0)).all())
        else:
            ok = diff.max().item() <= SUM_TOL["float32"]
        if not ok:
            raise AssertionError(f"farview_summarize vs plain: max abs err "
                                 f"{err} {tag}")
    return d, err


def block_bytes(d, BT):
    """Bytes of one walked window block of a kernel's inputs: its K and V
    rows of every kv head, its table entry and, for a quantized pool, its
    k and v scales (one f32 per kv head each) and one dequantize multiply
    per element (the second value)."""
    KV, hd = d["pool_k"].shape[2:]
    pool_elem = d["pool_k"].element_size()
    byts = BT * KV * hd * 2 * pool_elem + 4
    if "k_scale" in d:
        return byts + 2 * KV * 4, 2 * BT * KV * hd
    return byts, 0


def decode_work(d, W, BT, elem, cur=True):
    """Bytes the decode function must move (each input once: q, the window
    blocks in each active slot's extent, the current token unless ``cur``
    is False (the pool-only form), the output) and its flops (QK and PV
    over each active slot's valid keys; the dequantize of each walked block
    of a quantized pool)."""
    B, H, hd = d["q"].shape
    KV = d["pool_k"].shape[2]
    NB = d["block_table"].shape[1]
    per_block, deq = block_bytes(d, BT)
    byts = 2 * B * H * hd * elem + (2 * B * KV * hd * elem if cur else 0)
    flops = 0
    for b in range(B):
        if int(d["slot_active"][b]) <= 0:
            continue
        t, wb = int(d["seq_lens"][b]), int(d["window_base"][b])
        lo_pos = max(0, t + 1 - W)
        lo = min(max((lo_pos - wb) // BT, 0), NB)
        hi = max(min(max((t - wb) // BT + 1, 0), NB), lo)
        byts += (hi - lo) * per_block
        n_keys = t - lo_pos + 1               # (t - W, t] with the current token
        flops += 4 * H * hd * n_keys + (hi - lo) * deq
    return byts, flops


def chunk_work(d, W, BT, elem):
    B, C, H, hd = d["q"].shape
    KV = d["pool_k"].shape[2]
    NB = d["block_table"].shape[1]
    per_block, deq = block_bytes(d, BT)
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
            byts += (hi - lo) * per_block
            flops += (hi - lo) * deq
        for c in range(nv):
            p = s + c
            ctx = max(0, s - max(0, p - W + 1))       # pool keys before s
            own = min(c + 1, W)                       # chunk keys, causal
            flops += 4 * H * hd * (ctx + own)
    return byts, flops


def decode_far_work(d, f, W, BT, elem):
    """decode_work plus the far view: each active slot's valid far rows (K
    and V of every kv head), the table and validity, far_util; QK and PV
    over those rows."""
    byts, flops = decode_work(d, W, BT, elem)
    B, H, hd = d["q"].shape
    KV = d["pool_k"].shape[2]
    CAP = f["far_table"].shape[1]
    byts += 2 * B * CAP * 4 + B * CAP * 4
    for b in range(B):
        if int(d["slot_active"][b]) <= 0:
            continue
        n = int(f["far_valid"][b].sum())
        byts += n * KV * hd * 2 * elem
        flops += 4 * H * hd * n
    return byts, flops


def summarize_work(d, elem):
    """Both pools' rows of each gated slot's chunk once, both summaries
    written once; one add per row value and one divide per output."""
    P, BT, KV, hd = d["pool_k"].shape
    B, CB = d["chunk_blocks"].shape
    width = KV * hd
    byts = 2 * B * width * elem + B * CB * 4 + 2 * B * 4
    flops = 2 * B * width
    for b in range(B):
        if int(d["do_summarize"][b]) > 0:
            rows = min(max(int(d["n_tokens"][b]), 0), CB * BT)
            byts += 2 * rows * width * elem
            flops += 2 * rows * width
    return byts, flops


def sdpa_decode(torch, d, W, cur=True):
    """One library call on the gathered window (+ the current token; with
    ``cur`` False the pool-only form's window, up to and with t)."""
    import torch.nn.functional as F
    B, H, hd = d["q"].shape
    P, BT, KV, _ = d["pool_k"].shape
    n_rep = H // KV
    tbl = d["block_table"].long()
    Wt = tbl.shape[1] * BT
    k = d["pool_k"][tbl].reshape(B, Wt, KV, hd)
    v = d["pool_v"][tbl].reshape(B, Wt, KV, hd)
    if cur:
        k = torch.cat([k, d["cur_k"][:, None]], 1)
        v = torch.cat([v, d["cur_v"][:, None]], 1)
    k = k.permute(0, 2, 1, 3).repeat_interleave(n_rep, 1).contiguous()
    v = v.permute(0, 2, 1, 3).repeat_interleave(n_rep, 1).contiguous()
    pos = d["window_base"].long()[:, None] + torch.arange(Wt, device=k.device)
    t = d["seq_lens"].long()[:, None]
    m = ((pos < t) if cur else (pos <= t)) & (pos > t - W) & (pos >= 0)
    if cur:
        m = torch.cat([m, torch.ones_like(m[:, :1])], 1)
    m = m[:, None, None, :]
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


def sdpa_decode_far(torch, d, f, W):
    """One library call on the gathered far entries + window + current
    token (the far view's yardstick; nothing on the main path calls it)."""
    import torch.nn.functional as F
    B, H, hd = d["q"].shape
    P, BT, KV, _ = d["pool_k"].shape
    n_rep = H // KV
    tbl = d["block_table"].long()
    Wt = tbl.shape[1] * BT
    idx = f["far_table"].long()[:, :, None, None].expand(-1, -1, KV, hd)
    fk = torch.gather(f["far_k"], 1, idx)
    fv = torch.gather(f["far_v"], 1, idx)
    k = torch.cat([fk, d["pool_k"][tbl].reshape(B, Wt, KV, hd),
                   d["cur_k"][:, None]], 1).permute(0, 2, 1, 3)
    v = torch.cat([fv, d["pool_v"][tbl].reshape(B, Wt, KV, hd),
                   d["cur_v"][:, None]], 1).permute(0, 2, 1, 3)
    k = k.repeat_interleave(n_rep, 1).contiguous()
    v = v.repeat_interleave(n_rep, 1).contiguous()
    pos = d["window_base"].long()[:, None] + torch.arange(Wt, device=k.device)
    t = d["seq_lens"].long()[:, None]
    m = (pos < t) & (pos > t - W) & (pos >= 0)
    m = torch.cat([f["far_valid"] > 0, m, torch.ones_like(m[:, :1])], 1)
    m = m[:, None, None, :]
    q = d["q"][:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)


def mean_summarize(torch, d):
    """``torch.mean`` over each gated slot's pre-gathered chunk, K and V."""
    B, CB = d["chunk_blocks"].shape
    P, BT, KV, hd = d["pool_k"].shape
    on = (d["do_summarize"] > 0).nonzero().flatten()
    tbl = d["chunk_blocks"][on].long()
    gk = d["pool_k"][tbl].reshape(len(on), CB * BT, KV, hd)
    gv = d["pool_v"][tbl].reshape(len(on), CB * BT, KV, hd)
    return lambda: (torch.mean(gk, dim=1), torch.mean(gv, dim=1))


def dense_inputs(torch, dev, dtype, *, B, S, H, KV, hd, seed, **_):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g).to(dtype).to(dev)
    return dict(q=rn(B, S, H, hd), k=rn(B, S, KV, hd), v=rn(B, S, KV, hd))


def check_dense(torch, pfa, dev, dtype, shape, seed):
    """The dense prefill kernel against its plain version; two runs
    bitwise equal."""
    d = dense_inputs(torch, dev, dtype, seed=seed, **shape)
    kw = dict(causal=shape["causal"], window=shape["window"])
    got = pfa.prefill_attention(d["q"], d["k"], d["v"], **kw)
    again = pfa.prefill_attention(d["q"], d["k"], d["v"], **kw)
    want = pfa.prefill_plain(d["q"], d["k"], d["v"], **kw)
    torch.cuda.synchronize()
    tag = f"({dtype}, {shape})"
    if not torch.equal(got, again):
        raise AssertionError(f"prefill_flash: two runs differ {tag}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"prefill_flash: non-finite output {tag}")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[str(dtype)[6:]]):
        raise AssertionError(f"prefill_flash vs plain: max abs err {err} "
                             f"{tag}")
    return d, err


def dense_work(d, causal, window, elem):
    """q, k, v read once and the output written once; QK and PV flops over
    the (query, key) pairs the masks leave."""
    B, S, H, hd = d["q"].shape
    KV = d["k"].shape[2]
    byts = 2 * B * S * H * hd * elem + 2 * B * S * KV * hd * elem
    pairs = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return byts, 4 * B * H * hd * pairs


def sdpa_dense(torch, d, causal, window):
    """One library call on the same q, k, v (k/v repeated per query head
    beforehand; a boolean mask for the window)."""
    import torch.nn.functional as F
    H, KV = d["q"].shape[2], d["k"].shape[2]
    q = d["q"].permute(0, 2, 1, 3).contiguous()
    k = d["k"].permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    v = d["v"].permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    if not window:
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
    S = q.shape[2]
    i = torch.arange(S, device=q.device)
    m = i[None, :] > i[:, None] - window
    if causal:
        m &= i[None, :] <= i[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)


def phase_kernels(torch):
    from repro_torch.kernels import farview_summarize as fvs
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
        # seamless-m4t-medium's decoder in serve_encdec: hd 64, n_rep 1,
        # the same pool; decoder sequences reach 32 + 128 tokens
        "encdec": dict(B=8, H=16, KV=16, hd=64, BT=16, NB=33, P=521,
                       seq_lens=[0, 5, 31, 64, 100, 130, 159, 20],
                       active=[1, 1, 1, 1, 1, 1, 1, 0]),
    }
    # the dense prefill kernel: the encoder's shape (seamless-m4t-medium, the
    # longest utterance of serve_encdec), qwen2.5-32b width with GQA, causal
    # and a window, and small ragged shapes (n_rep 2, masks either way)
    dense_shapes = {
        "encoder": dict(B=1, S=1000, H=16, KV=16, hd=64, causal=False,
                        window=None),
        "gqa": dict(B=1, S=1024, H=40, KV=8, hd=128, causal=True,
                    window=512),
        "parity_causal": dict(B=2, S=37, H=4, KV=2, hd=16, causal=True,
                              window=5),
        "parity_window": dict(B=2, S=37, H=4, KV=2, hd=16, causal=False,
                              window=7),
    }
    chk_shapes = {
        "parity": dict(B=4, C=8, H=4, KV=2, hd=16, BT=8, NB=3, P=40,
                       start_pos=[0, 8, 13, 30], n_valid=[8, 5, 8, 0]),
        "full": dict(B=8, C=64, H=40, KV=8, hd=128, BT=16, NB=33, P=521,
                     start_pos=[0, 64, 300, 512, 600, 900, 128, 0],
                     n_valid=[64, 64, 30, 64, 17, 64, 0, 1]),
    }
    # the far view at the parity shapes (cap 4 below 5 and 7 summaries) and
    # at serve_full's (max_chunks 13, cap 16, mixed fill)
    far_shapes = {
        "parity": dict(MAXC=7, CAP=4, n_chunks=[0, 5, 2, 7]),
        "full": dict(MAXC=13, CAP=16, n_chunks=[0, 3, 13, 7, 13, 1, 0, 0]),
    }
    # serve_full's pool (521 blocks of 16 tokens, KV 8 x hd 128), sv_chunk
    # 64 = 4 blocks, three slots completing a chunk in the same step
    sum_shapes = {
        "parity": dict(P=40, BT=8, KV=2, hd=16, B=4, CB=2,
                       n_tokens=[16, 0, 11, 16], gate=[1, 0, 1, 1]),
        "full": dict(P=521, BT=16, KV=8, hd=128, B=8, CB=4,
                     n_tokens=[64, 0, 0, 64, 64, 0, 0, 0],
                     gate=[1, 0, 0, 1, 1, 0, 0, 0]),
    }
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, far_shp in far_shapes.items():
            shp = dec_shapes[name]
            d, f, W, err = check_decode_far(torch, pa, dev, dtype, shp,
                                            far_shp, seed=3)
            log(f"paged_decode far view {name} {dtype}: max_abs_err "
                f"{err:.3e}; skip on == off, run == run, all-masked far "
                f"view == none, bitwise")
            if name == "full" and dtype == torch.bfloat16:
                res["paged_decode_far"] = (d, f, W, err, shp["BT"])
        for name, shp in sum_shapes.items():
            d, err = check_summarize(torch, fvs, dev, dtype, shp, seed=4)
            log(f"farview_summarize {name} {dtype}: max_abs_err {err:.3e}")
            if name == "full" and dtype == torch.bfloat16:
                res["farview_summarize"] = (d, err)
        for name, shp in dec_shapes.items():
            d, W, err = check_decode(torch, pa, dev, dtype, shp, seed=1)
            log(f"paged_decode {name} {dtype}: max_abs_err {err:.3e}; "
                f"skip on == off, run == run, bitwise")
            if name in ("full", "encdec") and dtype == torch.bfloat16:
                key = "paged_decode" + ("_encdec" if name == "encdec" else "")
                res[key] = (d, W, err, shp["BT"])
        for name, shp in chk_shapes.items():
            d, W, err = check_chunk(torch, pfa, dev, dtype, shp, seed=2)
            log(f"chunked_prefill {name} {dtype}: max_abs_err {err:.3e}; "
                f"skip on == off, run == run, bitwise")
            if name == "full" and dtype == torch.bfloat16:
                res["chunked_prefill"] = (d, W, err, shp["BT"])
        for name, shp in dense_shapes.items():
            d, err = check_dense(torch, pfa, dev, dtype, shp, seed=5)
            log(f"prefill_flash {name} {dtype}: max_abs_err {err:.3e}; run "
                f"== run bitwise")
            if name in ("encoder", "gqa") and dtype == torch.bfloat16:
                key = "prefill_flash" + ("_gqa" if name == "gqa" else "")
                res[key] = (d, shp, err)
        # the quantized branches: qwen's decode and chunk shapes with
        # narrow pools (the encdec family has no quantized tier)
        for kvd in KV_DTYPES:
            for name in ("parity", "full"):
                d, W, err = check_decode(torch, pa, dev, dtype,
                                         dec_shapes[name], seed=6,
                                         kv_dtype=kvd)
                log(f"paged_decode {kvd} {name} {dtype}: max_abs_err "
                    f"{err:.3e}; skip on == off, run == run, bitwise")
                if name == "full" and dtype == torch.bfloat16:
                    res[f"paged_decode_{kvd}"] = (d, W, err,
                                                  dec_shapes[name]["BT"])
                d, W, err = check_chunk(torch, pfa, dev, dtype,
                                        chk_shapes[name], seed=7,
                                        kv_dtype=kvd)
                log(f"chunked_prefill {kvd} {name} {dtype}: max_abs_err "
                    f"{err:.3e}; skip on == off, run == run, bitwise")
                if name == "full" and dtype == torch.bfloat16:
                    res[f"chunked_prefill_{kvd}"] = (d, W, err,
                                                     chk_shapes[name]["BT"])

    rows = {}
    decode_keys = ["paged_decode", "paged_decode_encdec"]
    chunk_keys = ["chunked_prefill"]
    for kvd in KV_DTYPES:
        decode_keys.append(f"paged_decode_{kvd}")
        chunk_keys.append(f"chunked_prefill_{kvd}")
    for key in decode_keys:
        d, W, err, BT = res[key]
        args = [d[k] for k in ("q", "pool_k", "pool_v", "block_table",
                               "window_base", "seq_lens", "slot_active")]
        kw = dict(near_window=W, cur_k=d["cur_k"], cur_v=d["cur_v"],
                  skip_extent=True)
        if "k_scale" in d:
            kw.update(k_scale=d["k_scale"], v_scale=d["v_scale"])
        lib = dequantized(torch, d, d["q"].dtype) if "k_scale" in d else d
        byts, flops = decode_work(d, W, BT, 2)
        rows[key] = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/paged_decode.cu",
            replaces="src/repro/kernels/paged_attention.py:80",
            max_abs_err=err,
            ms=time_ms(torch, lambda: pa.paged_decode_attention(*args, **kw)),
            plain_ms=time_ms(torch, lambda: pa.plain(*args, **kw)),
            library_ms=time_ms(torch, sdpa_decode(torch, lib, W)),
            **bound(byts, flops, "bfloat16"))
    for key in chunk_keys:
        d, W, err, BT = res[key]
        args = [d[k] for k in ("q", "pool_k", "pool_v", "cur_k", "cur_v",
                               "block_table", "window_base", "start_pos",
                               "n_valid")]
        kw = dict(near_window=W, skip_extent=True)
        if "k_scale" in d:
            kw.update(k_scale=d["k_scale"], v_scale=d["v_scale"])
        lib = dequantized(torch, d, d["q"].dtype) if "k_scale" in d else d
        byts, flops = chunk_work(d, W, BT, 2)
        rows[key] = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/chunked_prefill.cu",
            replaces="src/repro/kernels/prefill_attention.py:78",
            max_abs_err=err,
            ms=time_ms(torch, lambda: pfa.chunked_prefill_attention(
                *args, **kw)),
            plain_ms=time_ms(torch, lambda: pfa.plain(*args, **kw)),
            library_ms=time_ms(torch, sdpa_chunk(torch, lib, W)),
            **bound(byts, flops, "bfloat16"))
    d, f, W, err, BT = res["paged_decode_far"]
    args = [d[k] for k in ("q", "pool_k", "pool_v", "block_table",
                           "window_base", "seq_lens", "slot_active")]
    kw = dict(near_window=W, cur_k=d["cur_k"], cur_v=d["cur_v"],
              skip_extent=True, **f)
    byts, flops = decode_far_work(d, f, W, BT, 2)
    rows["paged_decode_far"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_attention.py:80",
        max_abs_err=err,
        ms=time_ms(torch, lambda: pa.paged_decode_attention(*args, **kw)),
        plain_ms=time_ms(torch, lambda: pa.plain(*args, **kw)),
        library_ms=time_ms(torch, sdpa_decode_far(torch, d, f, W)),
        **bound(byts, flops, "bfloat16"))
    d, err = res["farview_summarize"]
    meta = [d[k] for k in ("chunk_blocks", "n_tokens", "do_summarize")]
    byts, flops = summarize_work(d, 2)
    rows["farview_summarize"] = dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/farview_summarize.cu",
        replaces="src/repro/kernels/farview_summarize.py:20",
        max_abs_err=err,
        ms=time_ms(torch, lambda: fvs.farview_summarize(
            d["pool_k"], d["pool_v"], *meta)),
        plain_ms=time_ms(torch, lambda: (fvs.plain(d["pool_k"], *meta),
                                         fvs.plain(d["pool_v"], *meta))),
        library_ms=time_ms(torch, mean_summarize(torch, d)),
        **bound(byts, flops, "float32"))
    for key in ("prefill_flash", "prefill_flash_gqa"):
        d, shp, err = res[key]
        kw = dict(causal=shp["causal"], window=shp["window"])
        byts, flops = dense_work(d, elem=2, **kw)
        rows[key] = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/prefill_flash.cu",
            replaces="src/repro/kernels/prefill_attention.py:35",
            max_abs_err=err,
            ms=time_ms(torch, lambda: pfa.prefill_attention(
                d["q"], d["k"], d["v"], **kw)),
            plain_ms=time_ms(torch, lambda: pfa.prefill_plain(
                d["q"], d["k"], d["v"], **kw)),
            library_ms=time_ms(torch, sdpa_dense(torch, d, **kw)),
            **bound(byts, flops, "bfloat16"))
    for k, r in rows.items():
        lib = ("library (SDPA on the dequantized window, dequantize "
               "excluded)" if k.endswith(KV_DTYPES) else "library")
        log(f"{k}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, {lib} "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} by "
            f"{r['bound_by']})")
    return rows


def bound(byts, flops, dtype):
    t_bytes = byts / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=byts, flops=flops)


# ---------------------------------------------------------------------------
# phase 3b: decode_skew, the double-buffered decode kernel's A/B
# ---------------------------------------------------------------------------

def skew_lengths(B, W, BT):
    """bench_decode_skew.py's lengths, by name (numpy seed 3)."""
    rng = np.random.default_rng(3)
    return {"uniform": np.full(B, W - 1),
            "bimodal": np.array([W - 1] + [BT + 15] * (B - 1)),
            "trace": np.clip(rng.gamma(2.0, W / 8.0, size=B), 16, W - 1)}


def skew_inputs(torch, dev, kind, lens, *, seed, permuted=False):
    """Pool-only decode operands at SKEW: window base 0, tail-adjacent
    tables (``permuted``: distinct random blocks), the last slot retired.
    ``kind`` is the q dtype, or a narrow pool dtype under bf16 q (the
    pools quantized per (block, kv head))."""
    B, H, KV, hd, BT, W = (SKEW[k] for k in ("B", "H", "KV", "hd", "BT", "W"))
    NB = W // BT + 1
    P = B * NB + 1
    g = torch.Generator(device="cpu").manual_seed(seed)
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    if permuted:
        table = (torch.randperm(P - 1, generator=g)[:B * NB] + 1).view(B, NB)
    else:
        table = 1 + torch.arange(B)[:, None] * NB + torch.arange(NB)[None, :]
    active = torch.ones(B, dtype=torch.int32)
    active[-1] = 0
    rn = lambda *s: torch.randn(*s, generator=g).to(dtype)
    d = dict(q=rn(B, H, hd), pool_k=rn(P, BT, KV, hd),
             pool_v=rn(P, BT, KV, hd), block_table=table.to(torch.int32),
             window_base=torch.zeros(B, dtype=torch.int32),
             seq_lens=torch.from_numpy(lens.astype(np.int32)),
             slot_active=active)
    d = {k: v.to(dev) for k, v in d.items()}
    if kind in KV_DTYPES:
        d = quant_inputs(torch, d, kind)
    return d, W


# the A/B's variants: (kernel, dma, skip_extent)
SKEW_VARIANTS = [("db", True, True), ("db", True, False), ("db", False, True),
                 ("db", False, False), ("nodb", None, True),
                 ("nodb", None, False)]


def skew_calls(pa, d, W):
    """One call per variant: the double-buffered kernel (prefetch_depth=1)
    with async copies and with synchronous loads, and the pool-only
    non-db kernel, each with skip on and off."""
    args = [d[k] for k in ("q", "pool_k", "pool_v", "block_table",
                           "window_base", "seq_lens", "slot_active")]
    kw = dict(near_window=W)
    if "k_scale" in d:
        kw.update(k_scale=d["k_scale"], v_scale=d["v_scale"])

    def call(kernel, dma, skip):
        return lambda: pa.paged_decode_attention(
            *args, prefetch_depth=int(kernel == "db"), dma=dma,
            skip_extent=skip, **kw)
    return {v: call(*v) for v in SKEW_VARIANTS}, args, kw


def bits(torch, x):
    """A float tensor's bits as integers (bitwise comparisons)."""
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def phase_decode_skew(torch):
    """Returns (kernel rows, launches) for the kernels line; prints the
    A/B's JSON line."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref, runtime
    dev = torch.device("cuda")
    B, BT, W = SKEW["B"], SKEW["BT"], SKEW["W"]
    NB = W // BT + 1
    lengths = skew_lengths(B, W, BT)
    rows, launches, entries = {}, {}, []
    for kind in SKEW_KINDS:
        cases = [(name, *skew_inputs(torch, dev, kind, lens, seed=8))
                 for name, lens in lengths.items()]
        cases.append(("trace_permuted", *skew_inputs(
            torch, dev, kind, lengths["trace"], seed=9, permuted=True)))
        # the A/B itself, with the counts zeroed just before and read
        # just after
        runtime.reset_launches()
        outs = []
        for name, d, W_ in cases:
            calls, _, _ = skew_calls(pa, d, W_)
            o = {v: fn() for v, fn in calls.items()}
            o["again"] = calls[SKEW_VARIANTS[0]]()
            outs.append(o)
        torch.cuda.synchronize()
        lm = dict(runtime.LAUNCHES)
        n = len(cases)
        assert lm["paged_decode_db"] == 5 * n and lm["paged_decode"] == 2 * n, \
            f"decode_skew {kind}: launches {lm}"
        key = "paged_decode_db" + ("" if kind == "bfloat16" else f"_{kind}")
        launches[key] = lm["paged_decode_db"]
        tol = TOL["float32" if kind == "float32" else "bfloat16"]
        for (name, d, W_), o in zip(cases, outs):
            tag = f"decode_skew {kind} {name}"
            first = o[SKEW_VARIANTS[0]]
            for v, out in o.items():
                if not torch.equal(bits(torch, out), bits(torch, first)):
                    raise AssertionError(f"{tag}: {v} != {SKEW_VARIANTS[0]} "
                                         f"bitwise")
            if not torch.isfinite(first).all():
                raise AssertionError(f"{tag}: non-finite output")
            if first[-1].any():
                raise AssertionError(f"{tag}: the retired slot is not zero")
            calls, args, kw = skew_calls(pa, d, W_)
            want = pa.plain(*args, skip_extent=True, **kw)
            err = (first.float() - want.float()).abs().max().item()
            if not torch.allclose(first.float(), want.float(), **tol):
                raise AssertionError(f"{tag} vs plain: max abs err {err}")
            if name.endswith("permuted"):
                log(f"{tag}: max_abs_err {err:.3e}; every variant bitwise "
                    f"equal, retired slot zero")
                continue
            elem = d["q"].element_size()
            byts, flops = decode_work(d, W_, BT, elem, cur=False)
            b_ = bound(byts, flops,
                       "float32" if kind == "float32" else "bfloat16")
            lib = dequantized(torch, d, d["q"].dtype) if "k_scale" in d else d
            lo, hi = ref.active_block_extent(
                d["window_base"], d["seq_lens"], d["slot_active"],
                near_window=W_, nb=NB, bt=BT)
            e = dict(kind=kind, lengths=name, max_abs_err=err,
                     active_blocks=int((hi - lo).sum()), padded_blocks=B * NB,
                     db_ms=time_ms(torch, calls[("db", True, True)]),
                     db_noskip_ms=time_ms(torch, calls[("db", True, False)]),
                     db_sync_ms=time_ms(torch, calls[("db", False, True)]),
                     nodb_ms=time_ms(torch, calls[("nodb", None, True)]),
                     nodb_noskip_ms=time_ms(torch,
                                            calls[("nodb", None, False)]),
                     plain_ms=time_ms(torch, lambda: pa.plain(
                         *args, skip_extent=True, **kw)),
                     sdpa_ms=time_ms(torch, sdpa_decode(torch, lib, W_,
                                                        cur=False)),
                     bound_ms=b_["bound_ms"], bound_by=b_["bound_by"])
            entries.append(e)
            log(f"{tag}: db {e['db_ms']:.4f} ms (skip off "
                f"{e['db_noskip_ms']:.4f}, sync loads {e['db_sync_ms']:.4f})"
                f", non-db {e['nodb_ms']:.4f} (skip off "
                f"{e['nodb_noskip_ms']:.4f}), plain {e['plain_ms']:.4f}, "
                f"SDPA {e['sdpa_ms']:.4f}, bound {e['bound_ms']:.5f}; "
                f"{e['active_blocks']} of {e['padded_blocks']} blocks; "
                f"max_abs_err {err:.3e}; bitwise equal")
            if name == "bimodal" and kind != "float32":
                rows[key] = dict(
                    route="cuda",
                    source="src/repro_torch/kernels/csrc/paged_decode.cu",
                    replaces="src/repro/kernels/paged_attention.py:131",
                    max_abs_err=err, ms=e["db_ms"], plain_ms=e["plain_ms"],
                    library_ms=e["sdpa_ms"], **b_)
    log(json.dumps({"decode_skew": entries, "launches": launches,
                    "card": nvidia_smi_line()}))
    return rows, launches


# ---------------------------------------------------------------------------
# phases 4 and 5: the engine
# ---------------------------------------------------------------------------

def serve_argv(n_layers, device="cuda", full_width=True, mode="paged_merge",
               kv_dtype="bf16"):
    s = SERVE_FULL if mode == "full" else SERVE
    return ["--arch", ARCH, "--mode", mode, "--kv-dtype", kv_dtype,
            "--workload", "mixed",
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
        step_p50_ms=lat["p50_ms"], step_p95_ms=lat["p95_ms"],
        step_p99_ms=lat["p99_ms"],
        steps=eng.steps_run, chunk_dispatches=eng._chunk_dispatches,
        tokens=out["tokens"], n_layers=L,
        peak_reserved_kv_bytes=a["peak_reserved_kv"],
        max_memory_allocated=out.get("max_memory_allocated"),
        pager_stats=dict(eng.pager.stats))
    log("serve:", json.dumps(summary))
    del engines, eng
    return launches, summary


def phase_serve_full(torch, n_layers, merge_peak=None, device="cuda",
                     full_width=True):
    """The serve trace in mode="full"; ``merge_peak`` is the paged_merge
    phase's peak reserved KV on the same trace."""
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve
    runtime.reset_launches()
    out, engines = serve.main(serve_argv(n_layers, device, full_width,
                                         mode="full"), return_engines=True)
    launches = dict(runtime.LAUNCHES)
    eng = engines[0]
    a, L = check_engine(eng, SERVE_FULL["requests"])
    assert (eng.cap, eng.max_chunks, eng.W) == (16, 13, 256), (
        eng.cap, eng.max_chunks, eng.W)
    # chunked prefill is off in full mode, whatever --prefill-chunk says
    assert a["prefill_chunk"] == 0 and a["chunk_kernel_launches"] == 0, a
    assert launches["chunked_prefill"] == 0, launches
    # summaries were written and their blocks trimmed (beyond the one
    # close-trim per retired request)
    assert int(eng.fv.n_chunks.sum()) > 0, eng.fv.n_chunks
    trims = eng.pager.stats["trim_ops"]
    assert trims > SERVE_FULL["requests"], eng.pager.stats
    steps = eng.steps_run
    if device == "cuda":
        assert a["decode_kernel_launches"] == steps * L, a
        assert a["farview_kernel_launches"] == steps * L, a
        assert launches["paged_decode"] == steps * L, launches
        assert launches["farview_summarize"] == steps * L, launches
    peak = a["peak_reserved_kv"]
    if merge_peak is not None:
        assert peak < merge_peak, (peak, merge_peak)
    lat = out["latency"]
    summary = dict(
        tokens_s=out["throughput_tok_s"], wall_tok_s=out["wall_tok_s"],
        step_p50_ms=lat["p50_ms"], step_p95_ms=lat["p95_ms"],
        step_p99_ms=lat["p99_ms"], steps=steps, tokens=out["tokens"],
        n_layers=L, peak_reserved_kv_bytes=peak,
        paged_merge_peak_reserved_kv_bytes=merge_peak,
        max_memory_allocated=out.get("max_memory_allocated"),
        summary_trims=trims - SERVE_FULL["requests"],
        pager_stats=dict(eng.pager.stats))
    log("serve_full:", json.dumps(summary))
    del engines, eng
    return launches, summary


def phase_serve_quant(torch, n_layers, kv_dtype, merge_peak=None,
                      device="cuda", full_width=True):
    """The serve trace with the quantized KV tier; ``merge_peak`` is the
    bf16 serve phase's peak reserved KV on the same trace."""
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve
    runtime.reset_launches()
    out, engines = serve.main(serve_argv(n_layers, device, full_width,
                                         kv_dtype=kv_dtype),
                              return_engines=True)
    launches = dict(runtime.LAUNCHES)
    eng = engines[0]
    a, L = check_engine(eng, SERVE["requests"])
    assert a["kv_dtype"] == kv_dtype and "k_scale" in eng.pools, a
    assert a["quant_bytes_saved"] > 0, a
    steps, chunks = eng.steps_run, eng._chunk_dispatches
    assert chunks > 0 and a["kernel_blocks_skipped"] > 0, a
    if device == "cuda":
        assert a["decode_kernel_launches"] == steps * L, a
        assert a["chunk_kernel_launches"] == chunks * L, a
        assert launches["paged_decode"] == launches["paged_decode_quant"] \
            == steps * L, launches
        assert launches["chunked_prefill"] \
            == launches["chunked_prefill_quant"] == chunks * L, launches
    peak = a["peak_reserved_kv"]
    dense_block = eng._dense_block_bytes
    if merge_peak is not None:
        # the control plane depends on lengths only: the same blocks are
        # reserved, each at the narrow block size (codes and scales)
        assert peak * dense_block == merge_peak * eng.block_bytes, (
            peak, merge_peak, eng.block_bytes, dense_block)
    lat = out["latency"]
    summary = dict(
        kv_dtype=kv_dtype, tokens_s=out["throughput_tok_s"],
        wall_tok_s=out["wall_tok_s"], step_p50_ms=lat["p50_ms"],
        step_p95_ms=lat["p95_ms"], step_p99_ms=lat["p99_ms"], steps=steps,
        chunk_dispatches=chunks, tokens=out["tokens"], n_layers=L,
        block_bytes=eng.block_bytes, dense_block_bytes=dense_block,
        peak_reserved_kv_bytes=peak,
        serve_peak_reserved_kv_bytes=merge_peak,
        peak_ratio=(peak / merge_peak if merge_peak else None),
        quant_bytes_saved=a["quant_bytes_saved"],
        quant_scale_bytes=a["quant_scale_bytes"],
        max_memory_allocated=out.get("max_memory_allocated"),
        launches_paged_decode_quant=launches["paged_decode_quant"],
        launches_chunked_prefill_quant=launches["chunked_prefill_quant"],
        pager_stats=dict(eng.pager.stats))
    log("serve_quant:", json.dumps(summary))
    del engines, eng
    return launches, summary


def agreeing_blocks(engs):
    """Physical blocks holding the written tokens of every active request
    whose tokens so far are the same in both runs (the same block ids in
    both: the control plane depends on lengths only). A block's codes and
    scales depend only on its own tokens, whose layer-0 K/V both paths
    compute with the same torch ops."""
    k, p = engs["kernel"], engs["plain"]
    out = []
    for slot in k.sched.active_slots():
        rk, rp = k.sched.request_at(slot), p.sched.request_at(slot)
        if rk is None or rp is None or rk.rid != rp.rid \
                or list(rk.generated) != list(rp.generated):
            continue
        sid = int(k._slot_sid[slot])
        n = -(-int(k._slot_len[slot]) // k.bt)
        blocks = k.pager.sessions[sid].blocks[:n]
        assert blocks == p.pager.sessions[int(p._slot_sid[slot])].blocks[:n]
        out += blocks
    return out


def layer0_bits(torch, pools, blocks):
    """Layer 0's K/V codes (as integers) and scales of ``blocks``."""
    idx = torch.tensor(blocks, dtype=torch.long, device=pools["k"].device)
    out = []
    for n in ("k", "v", "k_scale", "v_scale"):
        x = pools[n][0]
        if x.dtype == torch.float8_e4m3fn:
            x = x.view(torch.uint8)
        out.append(x[idx])
    return out


def phase_parity_quant(torch, kv_dtype, n_layers=2, device="cuda",
                       full_width=True):
    """The serve trace with a narrow KV dtype at full width and
    ``n_layers``: the kernel path and the plain path stepped in lockstep.
    After each step, the layer-0 codes and scales of every block written
    by a request whose tokens agree in both runs must be bitwise equal
    (:func:`agreeing_blocks`); logits within LOGIT_TOL on identical inputs,
    streams part only below TIE_MARGIN; steps, frames and pager stats
    equal a CPU run of the reduced config."""
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
               prefill_chunk=s["prefill_chunk"], kv_dtype=kv_dtype)

    def trace():
        return serve.make_workload(s["requests"], cfg.vocab_size,
                                   seed=s["seed"], prompt_len=s["prompt_len"],
                                   gen_len=s["gen_len"])

    engs = {}
    for impl in ("kernel", "plain"):
        engs[impl] = build(ARCH, cfg=cfg, params=params, device=device,
                           debug_logits=True, **ekw)[0]
        for r in trace():
            engs[impl].submit(r)
    runtime.reset_launches()
    k_launch = {k: 0 for k in runtime.LAUNCHES}
    blocks_compared = 0
    busy = lambda e: bool(e.sched.waiting or e.sched.active_slots())
    while busy(engs["kernel"]) or busy(engs["plain"]):
        for impl, eng in engs.items():
            ops.set_default_impl(impl)
            before = dict(runtime.LAUNCHES)
            if busy(eng):
                eng.step()
            if impl == "plain":
                assert runtime.LAUNCHES == before, "the plain path launched"
            else:
                for k in k_launch:
                    k_launch[k] += runtime.LAUNCHES[k] - before[k]
        ops.set_default_impl("kernel")
        blocks = agreeing_blocks(engs)
        if blocks:
            for a, b in zip(layer0_bits(torch, engs["kernel"].pools, blocks),
                            layer0_bits(torch, engs["plain"].pools, blocks)):
                assert torch.equal(a, b), (
                    f"layer 0 codes or scales differ after step "
                    f"{engs['kernel'].steps_run} ({kv_dtype})")
            blocks_compared += len(blocks)
    k_eng, p_eng = engs["kernel"], engs["plain"]
    for eng in (k_eng, p_eng):
        check_engine(eng, s["requests"])
        assert all(np.isfinite(lg).all() for lg in eng.debug_logits)
    if device == "cuda":
        assert k_launch["paged_decode_quant"] == k_eng.steps_run * n_layers
        assert k_launch["chunked_prefill_quant"] \
            == k_eng._chunk_dispatches * n_layers, k_launch
    kreq = {r.rid: r for r in k_eng.sched.finished}
    preq = {r.rid: r for r in p_eng.sched.finished}
    first_diff, margins = [], []
    logit_diff, n_cmp = 0.0, 0
    for rid, kr in kreq.items():
        pr = preq[rid]
        toks, ptoks = list(kr.generated), list(pr.generated)
        i = next((j for j, (a, b) in enumerate(zip(toks, ptoks)) if a != b),
                 len(toks))
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
        margins.append(margin)
        first_diff.append(i)
    assert logit_diff < LOGIT_TOL, (
        f"kernel vs plain logits differ by {logit_diff} on identical inputs")

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
    out = dict(kv_dtype=kv_dtype, steps=k_eng.steps_run, rids=len(kreq),
               streams_identical=len(kreq) - len(first_diff),
               first_diff_token_index=sorted(first_diff),
               max_parting_margin=max(margins, default=None),
               logits_compared=n_cmp, logits_max_abs_diff=logit_diff,
               layer0_blocks_bitwise=blocks_compared,
               pager_stats_equal_cpu=True)
    log("parity_quant:", json.dumps(out))
    del k_eng, p_eng, engs, params
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def record_far(eng):
    """Log the far policy of ``eng``: each selection (step, slot, rid,
    tokens generated so far, summaries, table, validity) and each step's
    far utility readback."""
    log_ = {"select": [], "util": []}
    select, observe = eng.fv.select, eng.fv.observe_utility

    def rec_select(row):
        tbl, val = select(row)
        req = eng.sched.request_at(row)
        log_["select"].append((eng.steps_run, row, req.rid,
                               len(req.generated), int(eng.fv.n_chunks[row]),
                               tbl.tolist(), val.tolist()))
        return tbl, val

    def rec_observe(far_util, far_table):
        log_["util"].append(np.array(far_util, np.float32))
        observe(far_util, far_table)

    eng.fv.select, eng.fv.observe_utility = rec_select, rec_observe
    return log_


def phase_parity(torch, mode="paged_merge", n_layers=2, device="cuda",
                 full_width=True):
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import ops, runtime
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.serving.factory import build
    s = SERVE_FULL if mode == "full" else SERVE
    far = mode == "full"
    cfg = (get_config(ARCH) if full_width else get_reduced(ARCH)).replace(
        n_layers=n_layers)
    params = registry.init_params(cfg, seed=s["seed"], device=device)
    ekw = dict(mode=mode, batch=s["batch"], max_seq=s["max_seq"],
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
        fl = record_far(eng) if far else None
        serve.run_lanes([eng], trace())
        check_engine(eng, s["requests"])
        runs[impl] = (eng, dict(runtime.LAUNCHES), fl)
    ops.set_default_impl("kernel")
    k_eng, k_launch, k_far = runs["kernel"]
    p_eng, p_launch, p_far = runs["plain"]
    if device == "cuda":
        assert k_launch["paged_decode"] == k_eng.steps_run * n_layers, k_launch
        if far:
            assert k_launch["farview_summarize"] == \
                k_eng.steps_run * n_layers, k_launch
    assert p_launch == {k: 0 for k in p_launch}, p_launch

    for eng in (k_eng, p_eng):
        assert all(np.isfinite(lg).all() for lg in eng.debug_logits)
    kreq = {r.rid: r for r in k_eng.sched.finished}
    preq = {r.rid: r for r in p_eng.sched.finished}
    ties = 0
    first_diff = []
    margins = []
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
        limit = TIE_MARGIN_FULL if far else TIE_MARGIN
        assert margin < limit, (
            f"rid {rid}: kernel and plain streams differ at token {i} where "
            f"the plain top-2 margin is {margin} >= {limit}")
        margins.append(margin)
        ties += 1
        first_diff.append(i)
    assert logit_diff < LOGIT_TOL, (
        f"kernel vs plain logits differ by {logit_diff} on identical inputs")
    util_diff, n_util = 0.0, 0
    if far:
        # the policy saw the same slots and summaries at every step; each
        # slot's far utility agrees while its request's inputs are the same
        assert [x[:5] for x in k_far["select"]] == \
            [x[:5] for x in p_far["select"]]
        first = {rid: next((j for j, (a, b) in enumerate(zip(
            kreq[rid].generated, preq[rid].generated)) if a != b),
            len(kreq[rid].generated)) for rid in kreq}
        for step, row, rid, n_gen, *_ in k_far["select"]:
            if n_gen > first[rid]:
                continue
            util_diff = max(util_diff, float(np.abs(
                k_far["util"][step][row] - p_far["util"][step][row]).max()))
            n_util += 1
        assert util_diff < FAR_UTIL_STEP_TOL, (
            f"kernel vs plain far utility differs by {util_diff}")
        assert sum(float(u.sum()) for u in k_far["util"]) > 0

    # the control plane depends on lengths only: a CPU run of the reduced
    # config over the same lengths must commit the same frames
    cpu = build(ARCH, device="cpu", **ekw)[0]
    c_far = record_far(cpu) if far else None
    reqs = trace()
    for r in reqs:
        r.prompt = r.prompt % cpu.cfg.vocab_size
    serve.run_lanes([cpu], reqs)
    for eng in (k_eng, p_eng):
        assert eng.steps_run == cpu.steps_run, (eng.steps_run, cpu.steps_run)
        assert eng.frames_committed == cpu.frames_committed
        assert eng.pager.stats == cpu.pager.stats, (eng.pager.stats,
                                                     cpu.pager.stats)
    if far:   # cap >= max_chunks: the far tables depend on lengths only
        assert k_far["select"] == c_far["select"]
    out = dict(mode=mode, steps=k_eng.steps_run, rids=len(kreq),
               streams_identical=len(kreq) - ties, tie_divergences=ties,
               first_diff_token_index=sorted(first_diff),
               max_parting_margin=max(margins, default=None),
               logits_compared=n_cmp, logits_max_abs_diff=logit_diff,
               pager_stats_equal_cpu=True)
    if far:
        out.update(far_util_compared=n_util, far_util_max_abs_diff=util_diff,
                   far_tables_equal_cpu=True,
                   trim_ops=k_eng.pager.stats["trim_ops"])
    log("parity_full:" if far else "parity:", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 8 and 9: the encoder-decoder family
# ---------------------------------------------------------------------------

def encdec_trace(d_model, vocab):
    """serve_encdec's requests, all from SERVE_ENCDEC's seed: the mixed
    workload redrawn with uniform decoder prompt and generation lengths,
    and per request S_enc uniform frame embeddings of width ``d_model``
    (N(0, 1), as the engine's default frames)."""
    from repro_torch.launch import serve
    s = SERVE_ENCDEC
    reqs = serve.make_workload(s["requests"], vocab, seed=s["seed"],
                               prompt_len=s["prompt_len"],
                               gen_len=s["gen_len"])
    rng = np.random.default_rng(s["seed"])
    lo, hi = s["enc_len"]
    for r in reqs:
        se = int(rng.integers(lo, hi + 1))
        r.enc_embeds = rng.standard_normal((1, se, d_model)).astype(
            np.float32)
    return reqs


def encdec_engine(cfg, params, device, **kw):
    from repro_torch.serving.factory import build
    s = SERVE_ENCDEC
    return build(ENCDEC, cfg=cfg, params=params, seed=s["seed"],
                 device=device, mode="paged_merge", batch=s["batch"],
                 max_seq=s["max_seq"], near_window=s["near_window"],
                 block_tokens=s["block_tokens"], **kw)[0]


def check_encdec_launches(eng, launches):
    """Launch counters of one run (zeroed just before it): the dense prefill
    kernel once per encoder layer per admission, the decode kernel once per
    decoder layer per step, no chunked prefill."""
    a = eng.audit()
    cfg = eng.cfg
    assert eng.encodes_run == SERVE_ENCDEC["requests"], eng.encodes_run
    assert launches["prefill_flash"] == eng.encodes_run * cfg.enc_layers, \
        launches
    assert launches["paged_decode"] == eng.steps_run * cfg.dec_layers, \
        launches
    assert launches["chunked_prefill"] == launches["farview_summarize"] == 0
    assert a["prefill_kernel_launches"] == launches["prefill_flash"], a
    assert a["decode_kernel_launches"] == launches["paged_decode"], a
    return a


def phase_serve_encdec(torch):
    """seamless-m4t-medium at its published widths and full depth."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve
    from repro_torch.models import registry
    cfg = get_config(ENCDEC)
    assert (cfg.enc_layers, cfg.dec_layers, cfg.d_model) == (12, 12, 1024)
    params = registry.init_params(cfg, seed=SERVE_ENCDEC["seed"],
                                  device="cuda")
    n_params = n_elements(params)
    eng = encdec_engine(cfg, params, "cuda")
    reqs = encdec_trace(cfg.d_model, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launches()
    out = serve.run_lanes([eng], reqs)
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    a, _ = check_engine(eng, SERVE_ENCDEC["requests"])
    check_encdec_launches(eng, launches)
    assert a["prefill_chunk"] == 0, a
    lat = out["latency"]
    summary = dict(
        arch=ENCDEC, params=n_params, enc_layers=cfg.enc_layers,
        dec_layers=cfg.dec_layers,
        tokens_s=out["aggregate_tok_s"], wall_tok_s=out["wall_tok_s"],
        step_p50_ms=lat["p50_ms"], step_p95_ms=lat["p95_ms"],
        step_p99_ms=lat["p99_ms"], steps=eng.steps_run, tokens=out["tokens"],
        encodes=eng.encodes_run,
        enc_frames=sum(r.enc_embeds.shape[1] for r in reqs),
        launches_prefill_flash=launches["prefill_flash"],
        launches_paged_decode=launches["paged_decode"],
        submit_share=a["submit_share"],
        peak_reserved_kv_bytes=a["peak_reserved_kv"],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        pager_stats=dict(eng.pager.stats))
    log("serve_encdec:", json.dumps(summary))
    del eng, params
    torch.cuda.empty_cache()
    return launches, summary


def n_elements(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_elements(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_elements(v) for v in tree)
    return tree.numel()


def max_row_ulps(torch, got, want):
    """max over elements of |got - want| in bf16 ulps of the element's row
    scale (max |x| over the last axis of either)."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).amax(dim=-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    return float(((g - w).abs() / ulp).max())


def phase_parity_encdec(torch, n_layers=2, device="cuda", full_width=True):
    """The serve_encdec trace at full width, ``n_layers`` encoder and
    decoder layers, through the kernels and through the plain versions
    (``device="cpu"``, ``full_width=False``: a rehearsal on the CPU, where
    both paths are the plain one)."""
    from repro_torch.configs import get_config, get_reduced, with_depth
    from repro_torch.kernels import ops, runtime
    from repro_torch.launch import serve
    from repro_torch.models import encdec, registry
    s = SERVE_ENCDEC
    cfg = with_depth(get_config(ENCDEC) if full_width else get_reduced(ENCDEC),
                     n_layers)
    params = registry.init_params(cfg, seed=s["seed"], device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    # the encoder executor on identical inputs: each request's encoder
    # output and cross K/V through the kernel and through the plain path
    enc_ulps = 0.0
    for r in encdec_trace(cfg.d_model, cfg.vocab_size):
        e = torch.as_tensor(r.enc_embeds, device=device)
        outs = {}
        for impl in ("kernel", "plain"):
            ops.set_default_impl(impl)
            o = encdec.encode(params, cfg, e)
            outs[impl] = (o, *encdec.cross_kv(params, cfg, o))
        ops.set_default_impl("kernel")
        sync()
        for got, want in zip(outs["kernel"], outs["plain"]):
            assert torch.isfinite(got).all()
            if got.dim() == 5:           # cross K/V: a token's row over heads
                got, want = got.flatten(-2), want.flatten(-2)
            enc_ulps = max(enc_ulps, max_row_ulps(torch, got, want))
    log(f"parity_encdec: encoder output / cross K,V kernel vs plain: "
        f"{enc_ulps:.2f} row-scale bf16 ulps")
    assert enc_ulps <= ENC_ULPS, (enc_ulps, ENC_ULPS)

    runs = {}
    for impl in ("kernel", "plain"):
        ops.set_default_impl(impl)
        runtime.reset_launches()
        eng = encdec_engine(cfg, params, device, debug_logits=True)
        serve.run_lanes([eng], encdec_trace(cfg.d_model, cfg.vocab_size))
        sync()
        check_engine(eng, s["requests"])
        runs[impl] = (eng, dict(runtime.LAUNCHES))
    ops.set_default_impl("kernel")
    k_eng, k_launch = runs["kernel"]
    p_eng, p_launch = runs["plain"]
    if device == "cuda":
        check_encdec_launches(k_eng, k_launch)
    assert p_launch == {k: 0 for k in p_launch}, p_launch
    # the same requests sit in the same slots at the end of both runs
    assert torch.equal(k_eng.pools["enc_len"], p_eng.pools["enc_len"])
    pool_ulps = max(max_row_ulps(torch, k_eng.pools[n].flatten(-2),
                                 p_eng.pools[n].flatten(-2))
                    for n in ("cross_k", "cross_v"))
    assert pool_ulps <= ENC_ULPS, (pool_ulps, ENC_ULPS)

    for eng in (k_eng, p_eng):
        assert all(np.isfinite(lg).all() for lg in eng.debug_logits)
    kreq = {r.rid: r for r in k_eng.sched.finished}
    preq = {r.rid: r for r in p_eng.sched.finished}
    first_diff, margins = [], []
    logit_diff, n_cmp = 0.0, 0
    for rid, kr in kreq.items():
        pr = preq[rid]
        toks, ptoks = list(kr.generated), list(pr.generated)
        i = next((j for j, (a, b) in enumerate(zip(toks, ptoks)) if a != b),
                 len(toks))
        for j in range(min(i + 1, len(toks))):
            logit_diff = max(logit_diff, float(np.abs(
                kr.logit_trace[j] - pr.logit_trace[j]).max()))
            n_cmp += 1
        if i == len(toks):
            continue
        top2 = np.sort(pr.logit_trace[i])[-2:]
        margins.append(float(top2[1] - top2[0]))
        first_diff.append(i)
    out = dict(steps=k_eng.steps_run, rids=len(kreq),
               streams_identical=len(kreq) - len(first_diff),
               first_diff_token_index=sorted(first_diff),
               max_parting_margin=max(margins, default=None),
               logits_compared=n_cmp, logits_max_abs_diff=logit_diff,
               encoder_max_row_ulps=enc_ulps, cross_pool_max_row_ulps=pool_ulps)
    log("parity_encdec:", json.dumps(out))
    assert logit_diff < LOGIT_TOL, (
        f"kernel vs plain logits differ by {logit_diff} on identical inputs")
    for m in margins:
        assert m < TIE_MARGIN_ENCDEC, (
            f"kernel and plain streams part where the plain top-2 margin is "
            f"{m} >= {TIE_MARGIN_ENCDEC}")

    # the control plane depends on lengths only: a CPU run of the reduced
    # config over the same lengths (prompt, generation, S_enc) must commit
    # the same frames
    rcfg = get_reduced(ENCDEC)
    cpu = encdec_engine(rcfg, registry.init_params(rcfg, seed=s["seed"],
                                                   device="cpu"), "cpu")
    reqs = encdec_trace(rcfg.d_model, rcfg.vocab_size)
    for r in reqs:
        r.prompt = r.prompt % rcfg.vocab_size
    serve.run_lanes([cpu], reqs)
    for eng in (k_eng, p_eng):
        assert eng.steps_run == cpu.steps_run, (eng.steps_run, cpu.steps_run)
        assert eng.frames_committed == cpu.frames_committed
        assert eng.pager.stats == cpu.pager.stats, (eng.pager.stats,
                                                     cpu.pager.stats)
        assert eng.encodes_run == cpu.encodes_run
    out.update(pager_stats_equal_cpu=True)
    log("parity_encdec: steps, frames and pager stats equal the CPU run")
    del k_eng, p_eng, params
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_profile(torch, n_layers, out_path=None, arch=ARCH):
    """torch.profiler over the serve phase's trace (``arch=ENCDEC``: the
    serve_encdec trace at full depth), every step after the first
    (warm-up) until the engine drains: device busy share and kernel time
    by category. Not in the default phases; ``out_path`` receives the
    summary and the profiler's table of the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.serving.factory import build
    if arch == ENCDEC:
        cfg = get_config(ENCDEC)
        eng = encdec_engine(cfg, registry.init_params(
            cfg, seed=SERVE_ENCDEC["seed"], device="cuda"), "cuda")
        reqs = encdec_trace(cfg.d_model, cfg.vocab_size)
        n_layers = cfg.dec_layers
    else:
        s = SERVE
        cfg = get_config(ARCH).replace(n_layers=n_layers)
        eng = build(ARCH, cfg=cfg, seed=s["seed"], device="cuda",
                    mode="paged_merge", batch=s["batch"],
                    max_seq=s["max_seq"], near_window=s["near_window"],
                    block_tokens=s["block_tokens"],
                    prefill_chunk=s["prefill_chunk"])[0]
        reqs = serve.make_workload(s["requests"], cfg.vocab_size,
                                   seed=s["seed"], prompt_len=s["prompt_len"],
                                   gen_len=s["gen_len"])
    for r in reqs:
        eng.submit(r)
    eng.step()
    torch.cuda.synchronize()
    step0, chunk0, enc0 = eng.steps_run, eng._chunk_dispatches, eng.encodes_run
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
               "prefill_flash kernel (encoder)" if "prefill_flash" in n else
               "matmul (cuBLAS)" if any(k in n for k in (
                   "nvjet", "splitkreduce", "gemm", "gemv", "xmma", "cutlass"))
               else "memcpy" if "memcpy" in n else "other (elementwise etc.)")
        t, c = cats.get(cat, (0.0, 0))
        cats[cat] = (t + (e.time_range.end - e.time_range.start), c + 1)
    out = dict(arch=arch, steps=eng.steps_run - step0,
               chunk_dispatches=eng._chunk_dispatches - chunk0,
               encodes=eng.encodes_run - enc0,
               n_layers=n_layers, wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
               idle_share=1 - busy / wall_us,
               by_category_ms={k: v[0] / 1e3 for k, v in sorted(cats.items())},
               launches_by_category={k: v[1] for k, v in sorted(cats.items())})
    log("profile:", json.dumps(out))
    if out_path and arch == ENCDEC:
        p = Path(out_path)
        out_path = p.with_name(f"{p.stem}_encdec{p.suffix}")
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
    ap.add_argument("--phases",
                    default="build,kernels,decode_skew,serve,serve_full,parity,"
                            "parity_full,serve_encdec,parity_encdec,"
                            "serve_quant,parity_quant",
                    help="comma-separated subset (the device phase always "
                         "runs); 'profile' and 'profile_encdec' add a "
                         "torch.profiler pass over serve's and serve_encdec's "
                         "traces")
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
    # kernel JSON row -> launches on the path that drives it, each path
    # with the counters zeroed just before it and read just after
    launches = {}
    if "decode_skew" in phases:
        skew_rows, skew_launches = phase_decode_skew(torch)
        rows.update(skew_rows)
        launches.update(skew_launches)
    merge_peak = None
    if "serve" in phases:
        lm, summary = phase_serve(torch, args.n_layers)
        launches["paged_decode"] = lm["paged_decode"]
        launches["chunked_prefill"] = lm["chunked_prefill"]
        merge_peak = summary["peak_reserved_kv_bytes"]
        missing = [k for k in ("paged_decode", "chunked_prefill")
                   if lm[k] <= 0]
        assert not missing, f"kernels never launched by serve: {missing}"
    if "serve_full" in phases:
        lf, _ = phase_serve_full(torch, args.n_layers, merge_peak)
        launches["paged_decode_far"] = lf["paged_decode"]
        launches["farview_summarize"] = lf["farview_summarize"]
        missing = [k for k in ("paged_decode", "farview_summarize")
                   if lf[k] <= 0]
        assert not missing, f"kernels never launched by serve_full: {missing}"
    if "serve_encdec" in phases:
        le, _ = phase_serve_encdec(torch)
        launches["paged_decode_encdec"] = le["paged_decode"]
        launches["prefill_flash"] = le["prefill_flash"]
        # the same kernel at the qwen-width check shape (not on this path)
        launches["prefill_flash_gqa"] = le["prefill_flash"]
        missing = [k for k in ("paged_decode", "prefill_flash") if le[k] <= 0]
        assert not missing, f"kernels never launched by serve_encdec: {missing}"
    if "serve_quant" in phases:
        for kvd in KV_DTYPES:
            lq, _ = phase_serve_quant(torch, args.n_layers, kvd, merge_peak)
            launches[f"paged_decode_{kvd}"] = lq["paged_decode_quant"]
            launches[f"chunked_prefill_{kvd}"] = lq["chunked_prefill_quant"]
            missing = [k for k in ("paged_decode_quant",
                                   "chunked_prefill_quant") if lq[k] <= 0]
            assert not missing, (f"quantized branches never launched by "
                                 f"serve_quant ({kvd}): {missing}")
    if {"serve", "serve_full", "serve_encdec"} <= phases:
        missing = [k for k in runtime.SOURCES
                   if not any(launches.get(r, 0) > 0
                              for r in (k, k + "_far", k + "_encdec"))]
        assert not missing, f"kernels never launched on the main path: {missing}"
    if "parity" in phases:
        phase_parity(torch)
    if "parity_full" in phases:
        phase_parity(torch, mode="full")
    if "parity_encdec" in phases:
        phase_parity_encdec(torch)
    if "parity_quant" in phases:
        for kvd in KV_DTYPES:
            phase_parity_quant(torch, kvd)
    if "profile" in phases:
        phase_profile(torch, args.n_layers, args.profile_out)
    if "profile_encdec" in phases:
        phase_profile(torch, args.n_layers, args.profile_out, arch=ENCDEC)

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
