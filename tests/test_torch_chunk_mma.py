"""The chunk kernel's bf16 tensor-core path, as far as the CPU reaches it.

The CUDA kernel (``csrc/chunked_prefill.cu``, ``chunked_prefill_mma_kernel``)
runs only on the card, where ``chip_smoke.py --phases build,kernels`` holds
it against its plain version (a sweep of head sizes, block sizes and n_rep
with bf16, fp8_e4m3 and int8 pools). Here:

* the wrapper's operand rules (``_check``): with bf16 q it takes hd a
  multiple of 16 and 16-byte aligned q, pools, ``cur_k`` and ``cur_v``;
  with f32 q any hd and block size it took before (hd 8, BT 8 and 24);
* the plain version at qwen2.5-32b's head layout (H 40, KV 8, hd 128,
  BT 16) against the JAX reference: ``chunked_prefill_attention_pallas``
  in interpret mode and ``ref.chunked_prefill_attention_ref``, slot by
  slot. The existing tests hold it at hd 16 and 32 only. f32 within 1e-5
  (summation order); bf16 within 2e-2 (the plain version rounds p to bf16
  before P.V, the Pallas kernel keeps it in f32; both round the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.prefill_attention import chunked_prefill_attention_pallas  # noqa: E402
from repro_torch.kernels import prefill_attention as pfa  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARGS = ("q", "pool_k", "pool_v", "cur_k", "cur_v", "block_table",
        "window_base", "start_pos", "n_valid")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (xdist workers share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, *, B, C, H, KV, hd, BT, NB, P):
    """numpy inputs of one fixed-shape chunk step: slot 0 at start_pos 0,
    the last slot idle (n_valid 0), window bases from the engine's rule,
    distinct physical blocks per slot."""
    rng = np.random.default_rng(seed)
    W = (NB - 1) * BT
    start = rng.integers(0, 3 * W, size=B).astype(np.int32)
    start[0] = 0
    wb = ((np.maximum(0, start + 1 - W) // BT) * BT).astype(np.int32)
    nv = rng.integers(1, C + 1, size=B).astype(np.int32)
    nv[-1] = 0
    tbl = np.stack([rng.permutation(np.arange(1, P))[:NB]
                    for _ in range(B)]).astype(np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(q=f(B, C, H, hd), pool_k=f(P, BT, KV, hd),
                pool_v=f(P, BT, KV, hd), cur_k=f(B, C, KV, hd),
                cur_v=f(B, C, KV, hd), block_table=tbl, window_base=wb,
                start_pos=start, n_valid=nv), W


def _torch(arrs, dtype):
    return {k: torch.from_numpy(v).to(TDT[dtype]) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in arrs.items()}


SMALL = dict(B=2, C=8, H=4, KV=2, hd=16, BT=8, NB=3, P=12)


def test_bf16_head_size_not_a_multiple_of_16_raises():
    t = _torch(_case(0, **dict(SMALL, hd=24))[0], "bfloat16")
    with pytest.raises(ValueError, match="hd"):
        pfa._check(*[t[k] for k in ARGS])


def _misaligned(x):
    """x's values in a contiguous tensor one element past 16-byte
    alignment (a storage offset)."""
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("name,pool", [("q", None), ("pool_k", "int8"),
                                       ("cur_v", None)])
def test_bf16_misaligned_operand_raises(name, pool):
    t = _torch(_case(1, **SMALL)[0], "bfloat16")
    scales = {}
    if pool == "int8":
        for n in ("pool_k", "pool_v"):
            t[n] = torch.clamp(torch.round(t[n].float() * 40), -127,
                               127).to(torch.int8)
        P, KV = t["pool_k"].shape[0], t["pool_k"].shape[2]
        scales = dict(k_scale=torch.full((P, KV), 0.025),
                      v_scale=torch.full((P, KV), 0.025))
    pfa._check(*[t[k] for k in ARGS], **scales)      # aligned: accepted
    t[name] = _misaligned(t[name])
    assert t[name].is_contiguous() and t[name].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        pfa._check(*[t[k] for k in ARGS], **scales)


@pytest.mark.parametrize("BT", [8, 24])
def test_f32_operands_it_took_before_still_pass(BT):
    t = _torch(_case(2, **dict(SMALL, hd=8, BT=BT))[0], "float32")
    pfa._check(*[t[k] for k in ARGS])
    t["q"] = _misaligned(t["q"])                       # no alignment rule
    pfa._check(*[t[k] for k in ARGS])


# qwen2.5-32b's head layout at a small batch and chunk
QWEN = dict(B=2, C=16, H=40, KV=8, hd=128, BT=16, NB=3, P=12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_at_qwen_heads(dtype):
    arrs, W = _case(3, **QWEN)
    t = _torch(arrs, dtype)
    j = {k: jnp.asarray(v).astype(JDT[dtype]) if v.dtype == np.float32
         else jnp.asarray(v) for k, v in arrs.items()}
    got = pfa.chunked_prefill_attention(*[t[k] for k in ARGS],
                                        near_window=W, skip_extent=True)
    assert got.shape == (QWEN["B"], QWEN["C"], QWEN["H"], QWEN["hd"])
    assert got.dtype == TDT[dtype]
    tol = 1e-5 if dtype == "float32" else 2e-2
    for b in range(QWEN["B"]):
        sl = lambda k: j[k] if k in ("pool_k", "pool_v") else j[k][b]
        g = got[b].float().numpy()
        want = chunked_prefill_attention_pallas(
            *[sl(k) for k in ARGS], near_window=W, skip_extent=True,
            interpret=True)
        np.testing.assert_allclose(g, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
        want = jref.chunked_prefill_attention_ref(
            *[sl(k) for k in ARGS], near_window=W, skip_extent=True)
        np.testing.assert_allclose(g, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    assert not got[-1].any()                             # n_valid = 0 -> 0
