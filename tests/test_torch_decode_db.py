"""The double-buffered decode form (``prefetch_depth=1``, the port of the
Pallas ``_decode_kernel_db``) against the JAX reference, on the CPU.

On the CPU the port's wrapper runs its plain version: the pool-only form
(the current token already in the pool, ``pos <= t``), which is what the
CUDA double-buffered kernel computes on the card (held bitwise there
against the pool-only ``_decode_kernel`` port by ``chip_smoke.py``'s
decode_skew phase). Here it is held against
``paged_decode_attention_pallas(..., prefetch_depth=1)`` in interpret mode,
at the shapes of the reference's own skip tests, with the same inputs drawn
from numpy seeds on both sides.

Tolerances: 1e-5 in f32 (summation order only), 2e-2 in bf16 (the plain
version rounds p to bf16 before P.V as the reference's ref does, the Pallas
kernel keeps f32), 1e-5 for int8 / fp8_e4m3 pools with f32 queries (the
reference's own bound for its quantized skip test).

Only kernel-level JAX calls at tiny shapes run here (no engine); the one
torch global touched (the intra-op thread count) is restored when the
module ends.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.paged_attention import paged_decode_attention_pallas  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.models.convert import pools_from_reference  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
QUANT_TOL = 1e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DEC = ("q", "pool_k", "pool_v", "block_table", "window_base", "seq_lens",
       "slot_active")
# (B, H, KV, hd, BT, NB) of the reference's skip parity test
SHAPES = {"gqa": (4, 4, 2, 32, 8, 4), "mha": (3, 8, 8, 64, 16, 3),
          "wide_gqa": (2, 16, 2, 64, 8, 5)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (xdist workers running the reference suite share
    the cores), restored when the module ends."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _skewed(seed, B, H, KV, hd, BT, NB, dtype="float32"):
    """The reference's skewed decode case: one deep slot, short tails, a
    retired last slot when B > 2, window base 0, permuted tables. Returns
    (jax inputs, torch inputs, W)."""
    rng = np.random.default_rng(seed)
    P = NB * B + 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dense = dict(q=f(B, H, hd), pool_k=f(P, BT, KV, hd),
                 pool_v=f(P, BT, KV, hd))
    seq = rng.integers(1, BT + 2, size=B).astype(np.int32)
    seq[0] = NB * BT - 1
    act = np.ones(B, np.int32)
    if B > 2:
        act[-1] = 0
    ints = dict(block_table=np.stack([rng.permutation(np.arange(1, P))[:NB]
                                      for _ in range(B)]).astype(np.int32),
                window_base=np.zeros(B, np.int32), seq_lens=seq,
                slot_active=act)
    j = {k: jnp.asarray(v).astype(JDT[dtype]) for k, v in dense.items()}
    t = {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in dense.items()}
    for k, v in ints.items():
        j[k], t[k] = jnp.asarray(v), torch.from_numpy(v)
    return j, t, NB * BT


# every shape in f32 with dma=None (the async copy) and dma=False
# (synchronous loads), skip on and off; the first shape in bf16 too
PARITY = [(s, "float32", dma, skip) for s in SHAPES
          for dma in (None, False) for skip in (True, False)]
PARITY += [("gqa", "bfloat16", None, skip) for skip in (True, False)]


@pytest.mark.parametrize("shape,dtype,dma,skip", PARITY,
                         ids=[f"{s}-{d}-dma{m}-skip{k}"
                              for s, d, m, k in PARITY])
def test_pool_only_form_matches_pallas_db(shape, dtype, dma, skip):
    j, t, W = _skewed(0, *SHAPES[shape], dtype=dtype)
    want, _ = paged_decode_attention_pallas(
        *[j[k] for k in DEC], near_window=W, skip_extent=skip,
        prefetch_depth=1, dma=dma, interpret=True)
    got = pa.paged_decode_attention(*[t[k] for k in DEC], near_window=W,
                                    skip_extent=skip, prefetch_depth=1,
                                    dma=dma)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # the CPU's double-buffered form is the plain pool-only version
    assert torch.equal(got, pa.plain(*[t[k] for k in DEC], near_window=W,
                                     skip_extent=skip))


def _codes(rng, shape, kvd):
    """Codes over the dtype's range, as (jnp codes, torch codes)."""
    if kvd == "int8":
        x = rng.integers(-127, 128, size=shape).astype(np.float32)
    else:
        x = np.clip(rng.standard_normal(shape) * 96, -448, 448)
        x = np.asarray(x.astype(ml_dtypes.float8_e4m3fn), np.float32)
    jx = jnp.asarray(x).astype(JDT[kvd])
    return jx, pools_from_reference({"x": np.asarray(jx)})["x"]


@pytest.mark.parametrize("kvd", ["int8", "fp8_e4m3"])
def test_quant_pool_only_form_matches_pallas_db(kvd):
    """The reference's quantized skip case: narrow pools with (P, KV) f32
    scales, f32 queries."""
    P, BT, KV, hd, B, H, NB = 20, 8, 2, 32, 3, 4, 4
    rng = np.random.default_rng(3)
    jk, tk = _codes(rng, (P, BT, KV, hd), kvd)
    jv, tv = _codes(rng, (P, BT, KV, hd), kvd)
    dense = dict(q=rng.standard_normal((B, H, hd)).astype(np.float32),
                 k_scale=rng.uniform(0.005, 0.02, (P, KV)).astype(np.float32),
                 v_scale=rng.uniform(0.005, 0.02, (P, KV)).astype(np.float32),
                 block_table=np.stack([rng.permutation(np.arange(1, P))[:NB]
                                       for _ in range(B)]).astype(np.int32),
                 window_base=np.zeros(B, np.int32),
                 seq_lens=np.array([NB * BT - 1, 3, 9], np.int32),
                 slot_active=np.ones(B, np.int32))
    j = {k: jnp.asarray(v) for k, v in dense.items()}
    t = {k: torch.from_numpy(v) for k, v in dense.items()}
    j.update(pool_k=jk, pool_v=jv)
    t.update(pool_k=tk, pool_v=tv)
    W = NB * BT
    want, _ = paged_decode_attention_pallas(
        *[j[k] for k in DEC], near_window=W, k_scale=j["k_scale"],
        v_scale=j["v_scale"], prefetch_depth=1, interpret=True)
    got = pa.paged_decode_attention(
        *[t[k] for k in DEC], near_window=W, k_scale=t["k_scale"],
        v_scale=t["v_scale"], prefetch_depth=1)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=QUANT_TOL,
                               rtol=QUANT_TOL)


@pytest.mark.parametrize("skip", [True, False])
def test_db_form_on_cpu_equals_pool_only_form_and_zeroes_retired(skip):
    """prefetch_depth 1 (dma on or off) and 0 without cur_k are one
    function; the retired slot is zero, the active ones are not."""
    _, t, W = _skewed(1, *SHAPES["gqa"], dtype="bfloat16")
    args = [t[k] for k in DEC]
    outs = [pa.paged_decode_attention(*args, near_window=W,
                                      skip_extent=skip, prefetch_depth=1,
                                      dma=dma) for dma in (None, True, False)]
    outs.append(pa.paged_decode_attention(*args, near_window=W,
                                          skip_extent=skip))
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    assert not outs[0][-1].any()                      # retired slot
    assert all(outs[0][b].any() for b in range(outs[0].shape[0] - 1))


@pytest.mark.parametrize("case", ["cur_k", "far_view", "stage_row",
                                  "pool_align", "depth"])
def test_prefetch_depth_1_rejects_what_the_db_kernel_does_not_take(case):
    """Raised on every device, before the CPU's plain path: the engine's
    form (cur_k/cur_v), the far view, and -- with dma -- a stage row that
    is not a multiple of 16 B or a pool that is not 16-byte aligned (with
    dma=False the same operands run)."""
    _, t, W = _skewed(2, *SHAPES["gqa"])
    d = {k: t[k] for k in DEC}
    B, H, hd = d["q"].shape
    P, BT, KV, _ = d["pool_k"].shape
    kw = dict(near_window=W, prefetch_depth=1)
    runs_without_dma = False
    if case == "cur_k":
        kw.update(cur_k=torch.zeros(B, KV, hd), cur_v=torch.zeros(B, KV, hd))
    elif case == "far_view":
        kw.update(far_k=torch.zeros(B, 3, KV, hd),
                  far_v=torch.zeros(B, 3, KV, hd),
                  far_table=torch.zeros(B, 2, dtype=torch.int32),
                  far_valid=torch.ones(B, 2, dtype=torch.int32))
    elif case == "stage_row":                   # hd 2 x 4 B = 8 B rows
        d["q"] = d["q"][..., :2].contiguous()
        d["pool_k"] = d["pool_k"][..., :2].contiguous()
        d["pool_v"] = d["pool_v"][..., :2].contiguous()
        runs_without_dma = True
    elif case == "pool_align":                  # data 4 B past alignment
        buf = torch.zeros(d["pool_v"].numel() + 1)
        buf[1:] = d["pool_v"].reshape(-1)
        d["pool_v"] = buf[1:].view(d["pool_v"].shape)
        assert d["pool_v"].is_contiguous() and d["pool_v"].data_ptr() % 16
        runs_without_dma = True
    elif case == "depth":
        kw["prefetch_depth"] = 2
    with pytest.raises(ValueError):
        pa.paged_decode_attention(*d.values(), **kw)
    if runs_without_dma:
        out = pa.paged_decode_attention(*d.values(), dma=False, **kw)
        assert out.shape == d["q"].shape
