"""The port's quantized KV-block tier (DESIGN.md §10: fp8_e4m3 and int8
pools with f32 scales per (layer, block, kv head)) against the JAX
reference, on the CPU at reduced size.

Held exactly: the quantizing pool writes (codes and scales bitwise, for
fresh blocks, growing scales that requantize, inactive slots and chunks
across a block edge), pool shapes and byte accounting, the guards' error
text, and an engine run per (dtype, chunked prefill on/off) against a LIVE
JAX engine at ``pipeline_depth=0`` (steps, pager stats, transport stats
including ``quant_bytes_saved``, frames and audit keys). Within 1e-5 (f32):
the plain dequantizing attention against the reference's and against the
Pallas kernels in interpret mode with ``quant=True``. The model steps:
layer 0's codes and scales bitwise, deeper layers' dequantized K/V within
one code step plus ``DEEP_ULPS`` bf16 ulps of each row's absmax (their bf16
inputs already differ by that much, see tests/test_torch_model.py), logits
within ``LOGIT_ULPS`` bf16 ulps of each row's scale, the rule of
tests/test_torch_farview.py (on these descriptors the same step with bf16
pools already differs by 0.037, two ulps of logits in [2, 4)). Token
streams follow the tie-margin rule of tests/test_torch_engine.py, with a
wider margin for fp8_e4m3 (``TIE_MARGIN``).

Every global the tests touch (torch's thread count and default dtype, both
packages' default kernel impl) is restored when the module ends, and the
JAX oracle runs at depth 0 only: its depth-1 runs are not steady on the
CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.core import descriptor as jdesc  # noqa: E402
from repro.core.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.core.engine import KVRMEngine as JEngine  # noqa: E402
from repro.core.scheduler import Request as JRequest  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import paged_decode_attention_pallas  # noqa: E402
from repro.kernels.prefill_attention import chunked_prefill_attention_pallas  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import descriptor as tdesc  # noqa: E402
from repro_torch.core.engine import EngineConfig, KVRMEngine  # noqa: E402
from repro_torch.core.scheduler import Request  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import prefill_attention as pfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.convert import (params_from_reference,  # noqa: E402
                                        pools_from_reference)

KV_DTYPES = ("fp8_e4m3", "int8")
JDT = {"fp8_e4m3": jnp.float8_e4m3fn, "int8": jnp.int8}
TDT = {"fp8_e4m3": torch.float8_e4m3fn, "int8": torch.int8}
ATTN_TOL = 1e-5
LOGIT_ULPS = 4
DEEP_ULPS = 4
# one code step at the top of the range, as a fraction of the row absmax:
# int8 codes step by 1 of 127; e4m3 codes in [256, 448] step by 32
CODE_STEP = {"fp8_e4m3": 32 / 448, "int8": 1 / 127}
# streams may part where the reference's top-2 margin is below this (the
# rule of tests/test_torch_engine.py). fp8_e4m3 codes step by up to 1/8 of
# their value, so a one-ulp difference in a deeper layer's bf16 K or V can
# move a code by a whole step: on identical inputs the two sides' logits
# then differ by up to 0.078 (prefix trace), against 0.055 with bf16 pools
# and 0.048 with int8 codes; 0.125 is two bf16 ulps of logits in [4, 8)
TIE_MARGIN = {"int8": 5e-2, "fp8_e4m3": 0.125}
LENS = [(5, 6), (17, 4), (3, 8), (33, 5), (9, 7), (21, 3),
        (4, 5), (6, 5), (8, 5)]
BASE = dict(batch=4, max_seq=64, block_tokens=8, pipeline_depth=0)
# audit keys the port shares with the reference that are not wall-clock
SHARED_AUDIT = ("mode", "steps", "prefill_chunk", "prefill_chunks_run",
                "single_commit_per_step", "frames_committed",
                "dma_groups_per_step", "avg_dma_bytes",
                "unmerged_groups_per_step", "train_overflows",
                "reserved_kv_bytes", "active_kv_bytes", "peak_reserved_kv",
                "peak_active_kv", "kernel_skip_extent", "kernel_blocks_total",
                "kernel_blocks_skipped", "greedy", "continuous_admits",
                "slot_idle_steps_saved", "cow_copies", "cow_groups",
                "cow_bytes", "kv_dtype", "quant_bytes_saved",
                "quant_scale_bytes")


@pytest.fixture(scope="module", autouse=True)
def _restore_globals():
    """One intra-op thread (xdist workers running the reference suite share
    the cores); every global restored when the module ends."""
    threads, dtype = torch.get_num_threads(), torch.get_default_dtype()
    jimpl, timpl = jops.get_default_impl(), tops.get_default_impl()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    torch.set_default_dtype(dtype)
    jops.set_default_impl(jimpl)
    tops.set_default_impl(timpl)


# ---------------------------------------------------------------------------
# helpers: the same bits on both sides
# ---------------------------------------------------------------------------

def _bits(x):
    """Codes as integers (fp8 through its uint8 bits), numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            x = x.view(torch.uint8)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _assert_logits_close(got, want):
    """Within LOGIT_ULPS bf16 ulps of each row's max |logit|."""
    g, w = _f32(got), _f32(want)
    mag = np.maximum(np.abs(g), np.abs(w)).max(axis=-1, keepdims=True)
    row_ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(g - w) <= LOGIT_ULPS * row_ulp).all(), \
        np.abs(g - w).max()


def _narrow_pair(codes_f32, kvd):
    """f32 values already on the dtype's grid -> (jnp codes, torch codes)."""
    j = jnp.asarray(codes_f32).astype(JDT[kvd])
    return j, pools_from_reference({"x": np.asarray(j)})["x"]


def _random_codes(rng, shape, kvd):
    """Codes over the whole range of the dtype (f32 values on its grid)."""
    if kvd == "int8":
        return rng.integers(-127, 128, size=shape).astype(np.float32)
    x = np.clip(rng.standard_normal(shape) * 96, -448, 448).astype(np.float32)
    return np.asarray(x.astype(ml_dtypes.float8_e4m3fn), np.float32)


# ---------------------------------------------------------------------------
# registry: pool geometry and byte accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvd", ("bf16",) + KV_DTYPES)
def test_pool_shapes_and_bytes_match_reference(kvd):
    jcfg, tcfg = jget_reduced("qwen2.5-32b"), get_reduced("qwen2.5-32b")
    kw = dict(batch=4, num_blocks=21, block_tokens=8, kv_dtype=kvd)
    js = jreg.decode_pool_shapes(jcfg, **kw)
    ts = treg.decode_pool_shapes(tcfg, **kw)
    assert sorted(js) == sorted(ts)
    for name, (shape, dtype) in ts.items():
        assert tuple(js[name].shape) == tuple(shape), name
        assert jnp.dtype(js[name].dtype).itemsize == dtype.itemsize, name
    assert ("k_scale" in ts) == (kvd != "bf16")
    assert treg.paged_payload_bytes_per_token(tcfg, kvd) \
        == jreg.paged_payload_bytes_per_token(jcfg, kvd)
    for arch in ("qwen2.5-32b", "seamless-m4t-medium"):
        assert treg.quant_decode_error(get_reduced(arch), kvd) \
            == jreg.quant_decode_error(jget_reduced(arch), kvd)
    assert treg.quant_decode_error(tcfg, "int4") \
        == jreg.quant_decode_error(jcfg, "int4")


def test_pools_from_reference_keep_every_bit():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((3, 5, 4)).astype(np.float32) * 50
    ref = {"fp8": jnp.asarray(np.clip(f, -448, 448)).astype(jnp.float8_e4m3fn),
           "int8": jnp.asarray(np.round(np.clip(f, -127, 127))).astype(jnp.int8),
           "bf16": jnp.asarray(f).astype(jnp.bfloat16),
           "f32": jnp.asarray(f), "i32": jnp.arange(7, dtype=jnp.int32)}
    got = pools_from_reference(jax.tree.map(np.asarray, ref))
    want = {"fp8": torch.float8_e4m3fn, "int8": torch.int8,
            "bf16": torch.bfloat16, "f32": torch.float32, "i32": torch.int32}
    for k, dt in want.items():
        assert got[k].dtype == dt, k
        if k == "bf16":
            np.testing.assert_array_equal(_f32(got[k]), _f32(ref[k]))
        else:
            np.testing.assert_array_equal(_bits(got[k]), _bits(ref[k]))


# ---------------------------------------------------------------------------
# the quantizing pool writes: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_quant_cast_clips_and_rounds_like_reference(kvd):
    """Out-of-range values clip to the dtype's range before the cast (the
    reference's fp8 cast would give nan, torch's would saturate), and int8
    rounds half to even."""
    x = np.array([-1e4, -500.0, -448.5, -127.5, -2.5, -0.5, 0.0, 0.5, 1.5,
                  2.5, 126.5, 127.49, 200.0, 449.0, 3e4], np.float32)
    want = jref._quant_cast(jnp.asarray(x), JDT[kvd])
    got = tref._quant_cast(torch.from_numpy(x), TDT[kvd])
    np.testing.assert_array_equal(got.numpy(), _bits(want))
    assert np.isfinite(np.asarray(want, np.float32)).all()


def _write_sequence():
    """Stacked writes: slots 0-2 fill blocks 1-3 (slot 2 inactive at steps
    0 and 3), then move on at offset 0 into blocks 2, 3, 1, which hold
    another slot's rows (a recycled block is reset); magnitudes grow with
    the step, so appends raise the scale and requantize. Chunks (after the
    first three stacked steps): slot 0 appends to its partly filled block
    and crosses two block edges, slot 1 crosses one, slot 2 starts a new
    request at offset 0 of its recycled block 3; then slot 1 idles."""
    rng = np.random.default_rng(0)
    L, P, BT, KV, hd, B, C = 2, 16, 4, 2, 8, 3, 6
    stacked = []
    for step in range(7):
        act = np.array([1, 1, step % 3 != 0], np.int32)
        blk = np.array([1, 2, 3] if step < BT else [2, 3, 1], np.int32)
        off = np.full(B, step % BT, np.int32)
        vals = rng.standard_normal((L, B, KV, hd)) * (1 + 2 * step)
        stacked.append((vals.astype(np.float32), blk, off, act))
    chunks = []
    for slots in ([[(1, 3), (7, 0), (7, 1), (7, 2), (7, 3), (10, 0)],
                   [(2, 3), (8, 0), (8, 1)],
                   [(3, 0), (3, 1), (3, 2), (3, 3), (11, 0)]],
                  [[(10, 1), (10, 2), (10, 3), (12, 0), (12, 1), (12, 2)],
                   [],
                   [(11, 1), (11, 2), (11, 3), (13, 0), (13, 1), (13, 2)]]):
        wb = np.zeros((B, C), np.int32)
        wo = np.zeros((B, C), np.int32)
        nv = np.array([len(x) for x in slots], np.int32)
        for b, toks in enumerate(slots):
            for c, (blk, off) in enumerate(toks):
                wb[b, c], wo[b, c] = blk, off
        vals = rng.standard_normal((L, B, C, KV, hd)) * (1 + len(chunks))
        chunks.append((vals.astype(np.float32), wb, wo, nv))
    return (L, P, BT, KV, hd), stacked, chunks


@pytest.mark.parametrize("kvd", KV_DTYPES)
@pytest.mark.parametrize("kind", ["stacked", "chunk"])
def test_quant_writes_bitwise_equal_reference(kvd, kind):
    (L, P, BT, KV, hd), stacked, chunks = _write_sequence()
    jp = jnp.zeros((L, P, BT, KV, hd), JDT[kvd])
    js = jnp.zeros((L, P, KV), jnp.float32)
    tp = torch.zeros((L, P, BT, KV, hd), dtype=TDT[kvd])
    ts = torch.zeros((L, P, KV))
    steps = stacked if kind == "stacked" else stacked[:3] + chunks
    for i, (vals, blk, off, act) in enumerate(steps):
        jv = jnp.asarray(vals).astype(jnp.bfloat16)
        tv = torch.from_numpy(vals).to(torch.bfloat16)
        fn = "quant_pool_write_stacked" if vals.ndim == 4 \
            else "quant_pool_write_chunk"
        jp, js = getattr(jops, fn)(jp, js, jv, jnp.asarray(blk),
                                   jnp.asarray(off), jnp.asarray(act))
        out = getattr(tops, fn)(tp, ts, tv, torch.from_numpy(blk),
                                torch.from_numpy(off), torch.from_numpy(act))
        assert out[0] is tp and out[1] is ts           # in place
        np.testing.assert_array_equal(_bits(tp), _bits(jp), err_msg=f"{i}")
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js),
                                      err_msg=f"{i}")
    assert (ts.numpy() > 0).any() and _bits(tp).any()


# ---------------------------------------------------------------------------
# the dequantizing attention: plain vs reference vs Pallas interpret
# ---------------------------------------------------------------------------

def _quant_attn_case(kvd, seed=0):
    """Narrow pools with per-(block, kv head) scales, f32 queries; slot 3
    retired, the others' windows at engine window bases."""
    rng = np.random.default_rng(seed)
    B, H, KV, hd, BT, NB, P = 4, 4, 2, 16, 8, 3, 20
    W = (NB - 1) * BT
    seq = np.array([3, 11, 17, 9], np.int32)
    wb = ((np.maximum(0, seq + 1 - W) // BT) * BT).astype(np.int32)
    act = np.array([1, 1, 1, 0], np.int32)
    tbl = np.stack([rng.permutation(np.arange(1, P))[:NB]
                    for _ in range(B)]).astype(np.int32)
    kq, tk = _narrow_pair(_random_codes(rng, (P, BT, KV, hd), kvd), kvd)
    vq, tv = _narrow_pair(_random_codes(rng, (P, BT, KV, hd), kvd), kvd)
    sc = rng.uniform(1e-3, 2e-2, size=(2, P, KV)).astype(np.float32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dense = dict(q=f(B, H, hd), cur_k=f(B, KV, hd), cur_v=f(B, KV, hd),
                 k_scale=sc[0], v_scale=sc[1], block_table=tbl,
                 window_base=wb, seq_lens=seq, slot_active=act)
    j = {k: jnp.asarray(v) for k, v in dense.items()}
    t = {k: torch.from_numpy(v) for k, v in dense.items()}
    j.update(pool_k=kq, pool_v=vq)
    t.update(pool_k=tk, pool_v=tv)
    return j, t, W


DEC = ("q", "pool_k", "pool_v", "block_table", "window_base", "seq_lens",
       "slot_active")


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_plain_quant_decode_matches_reference_and_pallas(kvd):
    j, t, W = _quant_attn_case(kvd)
    jsc = dict(k_scale=j["k_scale"], v_scale=j["v_scale"])
    tsc = dict(k_scale=t["k_scale"], v_scale=t["v_scale"])
    # the engine's form: the current token attended explicitly
    for skip in (True, False):
        got = tref.paged_decode_attention_ref(
            *[t[k] for k in DEC], near_window=W, cur_k=t["cur_k"],
            cur_v=t["cur_v"], skip_extent=skip, **tsc)
        want, _ = jref.paged_decode_attention_ref(
            *[j[k] for k in DEC], near_window=W, cur_k=j["cur_k"],
            cur_v=j["cur_v"], skip_extent=skip, **jsc)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=ATTN_TOL,
                                   rtol=0)
        # the wrapper on a CPU tensor is the plain version
        via = pa.paged_decode_attention(
            *[t[k] for k in DEC], near_window=W, cur_k=t["cur_k"],
            cur_v=t["cur_v"], skip_extent=skip, **tsc)
        assert torch.equal(via, got)
    # the Pallas kernel's form (quant=True branch): no current token
    got = tref.paged_decode_attention_ref(*[t[k] for k in DEC],
                                          near_window=W, **tsc)
    pallas, _ = paged_decode_attention_pallas(*[j[k] for k in DEC],
                                              near_window=W, **jsc)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_plain_quant_chunk_matches_reference_and_pallas(kvd):
    j, t, W = _quant_attn_case(kvd, seed=1)
    rng = np.random.default_rng(2)
    C, H, KV, hd = 8, 4, 2, 16
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    qc, ck, cv = f(C, H, hd), f(C, KV, hd), f(C, KV, hd)
    for start, nv in ((17, 6), (9, 8), (0, 5)):
        wb = int(max(0, start + 1 - W) // 8 * 8)
        jargs = (jnp.asarray(qc), j["pool_k"], j["pool_v"], jnp.asarray(ck),
                 jnp.asarray(cv), j["block_table"][0], jnp.int32(wb),
                 jnp.int32(start), jnp.int32(nv))
        targs = (torch.from_numpy(qc), t["pool_k"], t["pool_v"],
                 torch.from_numpy(ck), torch.from_numpy(cv),
                 t["block_table"][0], wb, start, nv)
        jsc = dict(k_scale=j["k_scale"], v_scale=j["v_scale"])
        tsc = dict(k_scale=t["k_scale"], v_scale=t["v_scale"])
        got = tref.chunked_prefill_attention_ref(*targs, near_window=W, **tsc)
        want = jref.chunked_prefill_attention_ref(*jargs, near_window=W, **jsc)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=ATTN_TOL,
                                   rtol=0)
        noskip = tref.chunked_prefill_attention_ref(
            *targs, near_window=W, skip_extent=True, **tsc)
        assert torch.equal(noskip, got)
        if start == 17:
            pallas = chunked_prefill_attention_pallas(*jargs, near_window=W,
                                                      **jsc)
            np.testing.assert_allclose(_f32(got), _f32(pallas),
                                       atol=ATTN_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the wrappers: a narrow pool on the card launches the quantized branch or
# raises; nothing falls back to the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["no_scales", "scale_dtype", "scale_shape",
                                  "far_view", "mixed_pools",
                                  "scales_on_bf16"])
def test_quant_wrappers_reject_what_the_kernels_do_not_take(case):
    _, t, W = _quant_attn_case("int8")
    d = {k: t[k] for k in DEC}
    d["q"] = d["q"].to(torch.bfloat16)
    cur = dict(cur_k=t["cur_k"].to(torch.bfloat16),
               cur_v=t["cur_v"].to(torch.bfloat16))
    sc = dict(k_scale=t["k_scale"], v_scale=t["v_scale"])
    far = {}
    if case == "no_scales":
        sc = {}
    elif case == "scale_dtype":
        sc["k_scale"] = sc["k_scale"].double()
    elif case == "scale_shape":
        sc["v_scale"] = sc["v_scale"][:, :1].contiguous()
    elif case == "far_view":
        B, KV, hd = 4, 2, 16
        far = dict(far_k=torch.zeros(B, 3, KV, hd, dtype=torch.bfloat16),
                   far_v=torch.zeros(B, 3, KV, hd, dtype=torch.bfloat16),
                   far_table=torch.zeros(B, 2, dtype=torch.int32),
                   far_valid=torch.zeros(B, 2, dtype=torch.int32))
    elif case == "mixed_pools":
        d["pool_v"] = d["pool_v"].view(torch.uint8).view(torch.float8_e4m3fn)
    elif case == "scales_on_bf16":
        d["pool_k"] = d["pool_k"].to(torch.bfloat16)
        d["pool_v"] = d["pool_v"].to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        pa._check(*d.values(), **cur, **far, **sc)
    # the untouched operands pass the decode and the chunk checks
    ok = {k: t[k] for k in DEC}
    ok["q"] = d["q"]
    pa._check(*ok.values(), **cur, k_scale=t["k_scale"],
              v_scale=t["v_scale"])
    B, C, H, KV, hd = 4, 8, 4, 2, 16
    chunk = [torch.zeros(B, C, H, hd, dtype=torch.bfloat16), t["pool_k"],
             t["pool_v"], torch.zeros(B, C, KV, hd, dtype=torch.bfloat16),
             torch.zeros(B, C, KV, hd, dtype=torch.bfloat16),
             t["block_table"], t["window_base"], t["seq_lens"],
             t["slot_active"]]
    pfa._check(*chunk, t["k_scale"], t["v_scale"])
    if case in ("no_scales", "scale_dtype", "scale_shape", "scales_on_bf16"):
        chunk[1], chunk[2] = d["pool_k"], d["pool_v"]
        with pytest.raises((TypeError, ValueError)):
            pfa._check(*chunk, sc.get("k_scale"), sc.get("v_scale"))


def test_quant_wrappers_never_fall_back_off_the_cpu(monkeypatch):
    """A device that is not the CPU gets the kernel or an error: with the
    plain versions made to fail, a call on the meta device raises the
    wrappers' own error (the card's path begins after this device test)."""
    _, t, W = _quant_attn_case("fp8_e4m3")

    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(pa, "plain", boom)
    monkeypatch.setattr(pfa, "plain", boom)
    m = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pa.paged_decode_attention(
            *[m[k] for k in DEC], near_window=W, cur_k=m["cur_k"],
            cur_v=m["cur_v"], k_scale=m["k_scale"], v_scale=m["v_scale"])
    q = torch.zeros(4, 8, 4, 16, device="meta")
    kv = torch.zeros(4, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pfa.chunked_prefill_attention(
            q, m["pool_k"], m["pool_v"], kv, kv, m["block_table"],
            m["window_base"], m["seq_lens"], m["slot_active"], near_window=W,
            k_scale=m["k_scale"], v_scale=m["v_scale"])


# ---------------------------------------------------------------------------
# the model steps: registry.decode_step / prefill_chunk vs the reference's
# ---------------------------------------------------------------------------

MB, MBT, MNB, MC = 4, 8, 3, 8
MW = (MNB - 1) * MBT
MP = 1 + MB * (MNB + 2)


@pytest.fixture(scope="module")
def models():
    jcfg = jget_reduced("qwen2.5-32b")
    jcfg = jcfg.replace(serving=jcfg.serving.__class__(near_window=MW))
    tcfg = get_reduced("qwen2.5-32b")
    tcfg = tcfg.replace(serving=tcfg.serving.__class__(near_window=MW))
    jparams = jreg.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _quant_pools(seed, cfg, kvd):
    """Engine-like narrow pools: codes and scales of earlier tokens (a few
    blocks' scales 0, as after a reset)."""
    rng = np.random.default_rng(seed)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    codes = {n: _random_codes(rng, (L, MP, MBT, KV, hd), kvd) for n in "kv"}
    sc = rng.uniform(1e-3, 3e-2, size=(2, L, MP, KV)).astype(np.float32)
    sc[:, :, ::5] = 0.0
    jp = {"k": jnp.asarray(codes["k"]).astype(JDT[kvd]),
          "v": jnp.asarray(codes["v"]).astype(JDT[kvd]),
          "k_scale": jnp.asarray(sc[0]), "v_scale": jnp.asarray(sc[1])}
    return jp, pools_from_reference(jax.tree.map(np.asarray, jp))


def _deq(pools, name):
    codes = _f32(pools[name])
    return codes * _f32(pools[name + "_scale"])[:, :, None, :, None]


def _assert_quant_pools_close(got, want, written, kvd):
    """written: (P, BT) mask of the token slots the step wrote. Untouched
    blocks bitwise; the written blocks' codes and scales bitwise in layer 0
    and within one code step plus DEEP_ULPS bf16 ulps of the row absmax in
    deeper layers (a written block's earlier rows are requantized too)."""
    blocks = written.any(axis=1)
    for n in ("k", "v"):
        gb, wb_ = _bits(got[n]), _bits(want[n])
        np.testing.assert_array_equal(gb[:, ~blocks], wb_[:, ~blocks])
        np.testing.assert_array_equal(gb[0], wb_[0])
        gs, ws = _f32(got[n + "_scale"]), _f32(want[n + "_scale"])
        np.testing.assert_array_equal(gs[:, ~blocks], ws[:, ~blocks])
        np.testing.assert_array_equal(gs[0], ws[0])
        g, w = _deq(got, n)[1:, blocks], _deq(want, n)[1:, blocks]
        amax = np.maximum(np.abs(g), np.abs(w)).max(axis=-1, keepdims=True)
        tol = (CODE_STEP[kvd] + DEEP_ULPS * 2.0 ** -7) * amax
        assert (np.abs(g - w) <= tol).all(), \
            f"{n}: deeper layers' K/V differ by {np.abs(g - w).max()}"


def _descriptors(fields):
    MT, CB, CAP = MNB + 1, 1, 1
    D = jdesc.descriptor_flat_size(MB, MNB, CAP, MT, CB)
    tflat = np.zeros(D, np.int32)
    tv = tdesc.flat_descriptor_views(tflat, MB, MNB, CAP, MT, CB)
    for name, a in fields.items():
        getattr(tv, name)[...] = a
    jd = jdesc.unflatten_descriptor(jnp.asarray(tflat), MB, MNB, CAP, MT, CB)
    td = tdesc.unflatten_descriptor(torch.from_numpy(tflat), MB, MNB, CAP,
                                    MT, CB)
    return jd, td


def _decode_fields(seed):
    """Slot 0 writes a fresh block (offset 0), slots 1-2 append (the scale
    may grow and requantize), slot 3 idle."""
    rng = np.random.default_rng(seed)
    t = np.array([8, 5, 20, 11], np.int32)
    act = np.array([1, 1, 1, 0], np.int32)
    wb = ((np.maximum(0, t + 1 - MW) // MBT) * MBT).astype(np.int32)
    blocks = rng.permutation(np.arange(1, MP))[:MB * MNB].reshape(MB, MNB)
    wblk = blocks[np.arange(MB), (t - wb) // MBT]
    return dict(block_table=blocks.astype(np.int32), window_base=wb,
                seq_lens=t, slot_active=act, write_block=wblk.astype(np.int32),
                write_offset=(t % MBT).astype(np.int32))


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_decode_step_and_prefill_chunk_match_reference(models, kvd):
    jcfg, jparams, tcfg, tparams = models
    # decode
    f = _decode_fields(0)
    jd, td = _descriptors(f)
    tokens = np.array([7, 100, 255, 3], np.int32)
    jpools, tpools = _quant_pools(1, jcfg, kvd)
    jlog, jpools, _ = jreg.decode_step(jparams, jcfg, jnp.asarray(tokens),
                                       jpools, jd)
    tlog, tpools, fu = treg.decode_step(tparams, tcfg,
                                        torch.from_numpy(tokens), tpools, td)
    assert fu is None and tpools["k"].dtype == TDT[kvd]
    _assert_logits_close(tlog, jlog)
    written = np.zeros((MP, MBT), bool)
    act = f["slot_active"] > 0
    written[f["write_block"][act], f["write_offset"][act]] = True
    _assert_quant_pools_close(tpools, jpools, written, kvd)

    # a prefill chunk: slot 0 from position 0, slot 1 across a block edge,
    # slot 2 a full chunk mid-window, slot 3 idle
    rng = np.random.default_rng(2)
    start = np.array([0, 5, 13, 30], np.int32)
    nv = np.array([MC, 6, MC, 0], np.int32)
    wb = ((np.maximum(0, start + 1 - MW) // MBT) * MBT).astype(np.int32)
    blocks = rng.permutation(np.arange(1, MP))[:MB * (MNB + 2)].reshape(
        MB, MNB + 2).astype(np.int32)
    pos = start[:, None] + np.arange(MC)[None]
    local = (pos - wb[:, None]) // MBT
    wblk = np.take_along_axis(blocks, np.minimum(local, MNB + 1), 1)
    wblk = np.where(np.arange(MC)[None] < nv[:, None], wblk, 0).astype(
        np.int32)
    woff = np.where(wblk > 0, pos % MBT, 0).astype(np.int32)
    fields = dict(tokens=rng.integers(0, 256, size=(MB, MC)).astype(np.int32),
                  start_pos=start, n_valid=nv, block_table=blocks[:, :MNB],
                  window_base=wb, write_block=wblk, write_offset=woff)
    flat = np.zeros(tdesc.chunk_flat_size(MB, MC, MNB), np.int32)
    views = tdesc.flat_chunk_views(flat, MB, MC, MNB)
    for name, a in fields.items():
        getattr(views, name)[...] = a
    tcd = tdesc.unflatten_chunk_descriptor(torch.from_numpy(flat), MB, MC,
                                           MNB)
    jcd = jdesc.PrefillChunkDescriptor(**{k: jnp.asarray(v)
                                          for k, v in fields.items()})
    jpools, tpools = _quant_pools(3, jcfg, kvd)
    jpools = jreg.prefill_chunk(jparams, jcfg, jpools, jcd)
    tpools = treg.prefill_chunk(tparams, tcfg, tpools, tcd)
    written = np.zeros((MP, MBT), bool)
    ok = np.arange(MC)[None] < nv[:, None]
    written[wblk[ok], woff[ok]] = True
    _assert_quant_pools_close(tpools, jpools, written, kvd)


def test_qk_norm_init_and_decode_step_match_reference():
    """``qk_norm=True`` (as qwen3 has): the port's init carries q_norm and
    k_norm, and a decode step on the reference's weights (norm scales
    drawn away from 1 so they matter) matches the reference's."""
    jcfg = jget_reduced("qwen2.5-32b").replace(qk_norm=True)
    jcfg = jcfg.replace(serving=jcfg.serving.__class__(near_window=MW))
    tcfg = get_reduced("qwen2.5-32b").replace(qk_norm=True)
    tcfg = tcfg.replace(serving=tcfg.serving.__class__(near_window=MW))
    own = treg.init_params(tcfg, seed=0, device="cpu")
    hd = tcfg.head_dim
    for layer in own["layers"]:
        for n in ("q_norm", "k_norm"):
            assert layer["attn"][n]["scale"].shape == (hd,)
            assert torch.equal(layer["attn"][n]["scale"],
                               torch.ones(hd, dtype=torch.bfloat16))
    jparams = jax.tree.map(np.asarray,
                           jreg.init_params(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(4)
    for n in ("q_norm", "k_norm"):
        s = jparams["layers"]["attn"][n]["scale"]
        jparams["layers"]["attn"][n]["scale"] = np.asarray(
            jnp.asarray(rng.uniform(0.5, 1.5, s.shape)).astype(s.dtype))
    tparams = params_from_reference(jparams)
    jparams = jax.tree.map(jnp.asarray, jparams)
    f = _decode_fields(1)
    f["seq_lens"] = np.array([3, 5, 20, 11], np.int32)
    f["write_offset"] = (f["seq_lens"] % MBT).astype(np.int32)
    wb = f["window_base"]
    f["write_block"] = f["block_table"][np.arange(MB),
                                        (f["seq_lens"] - wb) // MBT]
    jd, td = _descriptors(f)
    tokens = np.array([1, 17, 200, 9], np.int32)
    rng = np.random.default_rng(6)
    shape = (tcfg.n_layers, MP, MBT, tcfg.n_kv_heads, hd)
    kv = {n: rng.standard_normal(shape).astype(np.float32) for n in "kv"}
    jpools = {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in kv.items()}
    tpools = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in kv.items()}
    jlog, _, _ = jreg.decode_step(jparams, jcfg, jnp.asarray(tokens), jpools,
                                  jd)
    tlog, _, _ = treg.decode_step(tparams, tcfg, torch.from_numpy(tokens),
                                  tpools, td)
    _assert_logits_close(tlog, jlog)


# ---------------------------------------------------------------------------
# the engine: a live JAX run at depth 0 per (dtype, chunked prefill)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jget_reduced("qwen2.5-32b")
    jparams = jreg.init_params(jax.random.PRNGKey(7), jcfg)
    return (jcfg, jparams, get_reduced("qwen2.5-32b"),
            params_from_reference(jax.tree.map(np.asarray, jparams)))


def _trace(vocab):
    """[(prompt, gen_len, request kwargs)] of the legacy trace."""
    rng = np.random.default_rng(1)
    return [(rng.integers(0, vocab, size=p).astype(np.int32), g, {})
            for p, g in LENS]


def _prefix_hint_trace(vocab):
    """A long-lived source (rid 0) and later requests that name it with the
    legacy ``prefix_of`` hint, sharing one full block plus an unaligned
    tail (a COW tail copy of codes and scales) or two full blocks."""
    rng = np.random.default_rng(2)
    tok = lambda n: rng.integers(0, vocab, size=n).astype(np.int32)
    src = tok(40)
    trace = [(src, 8, {})] + [(tok(16), 4, {}) for _ in range(3)]
    for share in (12, 16, 12, 16):
        trace.append((np.concatenate([src[:share], tok(6)]), 4,
                      dict(prefix_of=0, prefix_len=share)))
    return trace


def _run_port(tcfg, tparams, trace=_trace, **kw):
    eng = KVRMEngine(tcfg, tparams, EngineConfig(**{**BASE, **kw}),
                     device="cpu")
    for rid, (p, g, rkw) in enumerate(trace(tcfg.vocab_size)):
        eng.submit(Request(rid=rid, prompt=p.copy(), gen_len=g, **rkw))
    eng.run(max_steps=500)
    return eng


@pytest.fixture(scope="module")
def reference_runs(weights):
    """The JAX engine's run of the legacy trace, once per configuration."""
    jcfg, jparams, _, _ = weights
    runs = {}

    def get(trace=_trace, **kw):
        key = (trace.__name__,) + tuple(sorted(kw.items()))
        if key not in runs:
            eng = JEngine(jcfg, jparams,
                          JEngineConfig(debug_logits=True, **{**BASE, **kw}))
            for rid, (p, g, rkw) in enumerate(trace(jcfg.vocab_size)):
                eng.submit(JRequest(rid=rid, prompt=p, gen_len=g, **rkw))
            eng.run(max_steps=500)
            runs[key] = eng
        return runs[key]

    return get


def _assert_parity(jeng, teng, kvd):
    assert teng.pools["k"].dtype == TDT[kvd]
    assert teng.steps_run == jeng.steps_run
    assert teng.frames_committed == jeng.frames_committed
    assert teng.pager.stats == jeng.pager.stats
    teng.pager.check_invariants()
    assert teng.pager.reserved_blocks() == 0
    assert dataclasses.asdict(teng.transport.stats) \
        == dataclasses.asdict(jeng.transport.stats)
    ja, ta = jeng.audit(), teng.audit()
    for k in SHARED_AUDIT:
        assert ta[k] == ja[k], (k, ta[k], ja[k])
    assert ta["quant_bytes_saved"] > 0 and ta["kv_dtype"] == kvd
    assert ta["decode_kernel_launches"] == ta["chunk_kernel_launches"] == 0
    jfin = {r.rid: r for r in jeng.sched.finished}
    tfin = {r.rid: r for r in teng.sched.finished}
    assert sorted(jfin) == sorted(tfin) == list(range(len(jeng.sched.requests)))
    exact = 0
    for rid, jr in jfin.items():
        got, want = list(tfin[rid].generated), list(map(int, jr.generated))
        assert len(got) == len(want) == jr.gen_len
        if got == want:
            exact += 1
            continue
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        top2 = np.sort(np.asarray(jr.logit_trace[i], np.float32))[-2:]
        assert top2[1] - top2[0] < TIE_MARGIN[kvd], (
            f"rid {rid}: token {i} differs ({got[i]} vs {want[i]}) where the "
            f"reference's top-2 margin is {top2[1] - top2[0]}")
    assert exact >= len(jfin) - 2, f"only {exact} of {len(jfin)} streams exact"


@pytest.mark.parametrize("kvd", KV_DTYPES)
@pytest.mark.parametrize("chunk", [0, 8], ids=["chunk0", "chunk8"])
def test_engine_matches_live_reference_at_depth_0(weights, reference_runs,
                                                  kvd, chunk):
    _, _, tcfg, tparams = weights
    jeng = reference_runs(kv_dtype=kvd, prefill_chunk=chunk)
    teng = _run_port(tcfg, tparams, kv_dtype=kvd, prefill_chunk=chunk)
    _assert_parity(jeng, teng, kvd)


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_prefix_alias_and_cow_copy_scales_match_live_reference(
        weights, reference_runs, kvd):
    """Aliased blocks share codes and scales; a COW tail copy moves both
    (the engine's block-indexed pools)."""
    _, _, tcfg, tparams = weights
    jeng = reference_runs(trace=_prefix_hint_trace, kv_dtype=kvd)
    teng = _run_port(tcfg, tparams, trace=_prefix_hint_trace, kv_dtype=kvd)
    _assert_parity(jeng, teng, kvd)
    assert teng.pager.stats["alias_ops"] > 0 and teng.audit()["cow_copies"] > 0
    assert teng._block_pool_keys == ["k", "v", "k_scale", "v_scale"]


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_port_identities_skip_and_modes(weights, kvd):
    """Inside the port: skip-extent on and off give the same streams, pools
    and scales bitwise; paged and arena serve the same streams as
    paged_merge (the same tokens sit in the same block positions, only the
    physical block ids differ)."""
    _, _, tcfg, tparams = weights
    kw = dict(kv_dtype=kvd, prefill_chunk=8)
    on = _run_port(tcfg, tparams, **kw)
    off = _run_port(tcfg, tparams, kernel_skip_extent=False, **kw)
    streams = lambda e: {r.rid: list(r.generated) for r in e.sched.finished}
    assert streams(on) == streams(off)
    for n in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bits(on.pools[n]), _bits(off.pools[n]))
    assert on.audit()["kernel_blocks_skipped"] > 0
    assert off.audit()["kernel_blocks_skipped"] == 0
    for mode in ("paged", "arena"):
        eng = _run_port(tcfg, tparams, mode=mode, **kw)
        assert streams(eng) == streams(on), mode
        assert eng.audit()["quant_scale_bytes"] > 0
        if eng.pager is not None:
            assert eng.pager.reserved_blocks() == 0


@pytest.mark.parametrize("case", ["full_mode", "encdec"])
def test_quant_guards_raise_the_reference_error(case):
    """The reference's ValueError, word for word."""
    kvd = "int8"
    if case == "full_mode":
        jcfg, tcfg = jget_reduced("qwen2.5-32b"), get_reduced("qwen2.5-32b")
        ekw = dict(BASE, mode="full", kv_dtype=kvd)
    else:
        jcfg = jget_reduced("seamless-m4t-medium")
        tcfg = get_reduced("seamless-m4t-medium")
        ekw = dict(BASE, kv_dtype=kvd)
    with pytest.raises(ValueError) as want:
        JEngine(jcfg, None, JEngineConfig(**ekw))
    with pytest.raises(ValueError) as got:
        KVRMEngine(tcfg, None, EngineConfig(**ekw), device="cpu")
    assert str(got.value) == str(want.value)
    assert "kv_dtype" in str(got.value)


@pytest.mark.parametrize("kvd", KV_DTYPES)
def test_launcher_serves_the_quantized_tier_on_the_cpu(kvd):
    """``serve --kv-dtype`` through ``serving.factory.build``: narrow pools
    and scale pools, every request finishes, nothing leaks, and the same
    blocks are reserved as with bf16, each at the narrow block size."""
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--requests", "6", "--max-seq", "64",
            "--batch", "4", "--prefill-chunk", "8", "--gen-len", "4:12"]
    out, engines = serve.main(argv + ["--kv-dtype", kvd],
                              return_engines=True)
    base, bengines = serve.main(argv, return_engines=True)
    eng, beng = engines[0], bengines[0]
    assert out["finished"] == 6 and out["audit"]["kv_dtype"] == kvd
    assert eng.pools["k"].dtype == TDT[kvd] and "v_scale" in eng.pools
    assert eng.pager.reserved_blocks() == 0
    assert eng.pager.stats == beng.pager.stats
    assert out["audit"]["peak_reserved_kv"] * beng.block_bytes \
        == base["audit"]["peak_reserved_kv"] * eng.block_bytes
