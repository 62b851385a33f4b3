"""The dense prefill kernel's bf16 tensor-core path, as far as the CPU
reaches it.

The CUDA kernel (``csrc/prefill_flash.cu``, ``prefill_flash_mma_kernel``)
runs only on the card, where ``chip_smoke.py --phases build,kernels``
holds it against its plain version. Here:

* the wrapper's operand rules (``_check_dense``): the bf16 kernel takes hd
  a multiple of 16 up to 256, the f32 kernel any hd up to 256;
* the wrapper's launch configuration (``mma_launch``), pure Python: grid,
  threads and shared memory at the encoder's and at qwen2.5-32b's shapes;
* the plain version at the kernel's real head shapes (hd 64 with n_rep 1,
  the encoder's; H 40, KV 8, hd 128, qwen2.5-32b's) against the JAX
  reference: ``prefill_attention_pallas`` in interpret mode (q_blk = k_blk
  = 16) and ``ref.prefill_attention_ref``. Tolerances as in
  ``test_torch_kernels.py``: against the Pallas kernel, which keeps f32
  scores, f32 within 1e-5 and bf16 within 2e-2 (the plain version rounds
  scores and p to bf16); against ``prefill_attention_ref``
  (``attention_dense``, the same roundings), f32 within 1e-5 and bf16
  within the same 2e-2. Not one bf16 ulp of the value, as at hd 16 in
  ``test_torch_kernels.py``: at qwen's shape the scores agree bitwise and
  the two frameworks' f32 softmax differs in last bits, so one p of 40,960
  rounds to bf16 one ulp apart; a few outputs that cancel to small values
  then differ by up to 27 ulps of the value (2e-3 absolute, one bf16 ulp
  of the terms). From the same p, P.V agrees within 2.4e-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.prefill_attention import prefill_attention_pallas  # noqa: E402
from repro_torch.kernels import prefill_attention as pfa  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_SMEM = 227 * 1024


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (xdist workers share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(dtype, *, B=1, S=4, H=4, KV=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(TDT[dtype]) for s in ((B, S, H, hd), (B, S, KV, hd),
                                      (B, S, KV, hd))]


@pytest.mark.parametrize("dtype,hd,ok", [
    ("bfloat16", 24, False),      # not a multiple of 16
    ("bfloat16", 272, False),     # above 256
    ("bfloat16", 16, True), ("bfloat16", 64, True), ("bfloat16", 128, True),
    ("float32", 24, True),        # the f32 kernel takes any hd up to 256
])
def test_check_dense_head_dims(dtype, hd, ok):
    q, k, v = _qkv(dtype, hd=hd)
    if ok:
        pfa._check_dense(q, k, v)
    else:
        with pytest.raises(ValueError, match="hd"):
            pfa._check_dense(q, k, v)


@pytest.mark.parametrize("shape,grid", [
    # seamless-m4t-medium's encoder at its longest utterance
    (dict(B=1, S=1000, H=16, KV=16, hd=64), (1, 16, 16)),
    # qwen2.5-32b width: S 1024 x n_rep 5 = 5120 rows of kv head g
    (dict(B=1, S=1024, H=40, KV=8, hd=128), (1, 8, 80)),
])
def test_mma_launch_configuration(shape, grid):
    got_grid, threads, smem = pfa.mma_launch(**shape)
    assert got_grid == grid and threads == 128
    assert smem == pfa.mma_smem_bytes(shape["hd"]) <= MAX_SMEM


def test_mma_launch_rejects_what_does_not_fit():
    pfa.mma_launch(1, 65535 * 64, 4, 4, 64)            # the last z that fits
    with pytest.raises(ValueError, match="grid"):
        pfa.mma_launch(1, 65535 * 64 + 1, 4, 4, 64)
    with pytest.raises(ValueError, match="grid"):      # S * n_rep counts
        pfa.mma_launch(1, 65535 * 16 + 1, 8, 2, 64)
    assert pfa.mma_smem_bytes(256) <= MAX_SMEM         # every hd it takes
    with pytest.raises(ValueError, match="shared memory"):
        pfa.mma_launch(1, 64, 4, 4, 1024)


# the kernel's real head shapes at S 32 (two 16-token Pallas tiles):
# the encoder's (non-causal) and qwen2.5-32b's (GQA, causal, window)
REAL_SHAPES = {
    "encoder": dict(B=1, S=32, H=16, KV=16, hd=64, causal=False,
                    window=None),
    "qwen": dict(B=1, S=32, H=40, KV=8, hd=128, causal=True, window=17),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(REAL_SHAPES))
def test_plain_matches_reference_at_real_head_shapes(name, dtype):
    shp = dict(REAL_SHAPES[name])
    causal, window = shp.pop("causal"), shp.pop("window")
    rng = np.random.default_rng(50)
    B, S, H, KV, hd = (shp[k] for k in ("B", "S", "H", "KV", "hd"))
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    q, k, v = (torch.from_numpy(a).to(TDT[dtype]) for a in arrs)
    jq, jk, jv = (jnp.asarray(a).astype(JDT[dtype]) for a in arrs)

    got = pfa.prefill_attention(q, k, v, causal=causal, window=window)
    assert got.shape == (B, S, H, hd) and got.dtype == TDT[dtype]
    g = got.float().numpy()

    tol = 1e-5 if dtype == "float32" else 2e-2
    want = prefill_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    q_blk=16, k_blk=16, interpret=True)
    np.testing.assert_allclose(g, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    w = np.asarray(jref.prefill_attention_ref(jq, jk, jv, causal=causal,
                                              window=window), np.float32)
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol)
