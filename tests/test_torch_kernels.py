"""The port's attention kernels' plain versions against the JAX reference.

Every input is drawn from a numpy seed and handed to both sides. The port's
plain PyTorch versions (what the CUDA kernels are held against on the card)
are compared with the JAX Pallas kernels in interpret mode (without the
current token, the only form the Pallas decode kernel has) and with
``repro.kernels.ref`` (with ``cur_k``/``cur_v``, the engine's decode path).

Tolerances: 1e-4 in f32 (summation order only), 2e-2 in bf16 (bf16
rounding of p and of the output). Extents and pool writes are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: these runs are small, and xdist workers running the
# reference suite beside them share the cores
torch.set_num_threads(1)
import jax.numpy as jnp  # noqa: E402

from repro.core.descriptor import active_block_extents as np_extents  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import paged_decode_attention_pallas  # noqa: E402
from repro.kernels.prefill_attention import chunked_prefill_attention_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import prefill_attention as pfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype=None):
    """numpy array -> (jnp array, torch tensor) holding the same values."""
    if dtype is None:
        return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    a32 = np.asarray(a, np.float32)
    return (jnp.asarray(a32).astype(JDT[dtype]),
            torch.from_numpy(a32).to(TDT[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _decode_case(seed, *, B, H, KV, hd, BT, NB, P, dtype):
    """Engine-shaped decode inputs: window_base from the engine's formula,
    distinct physical blocks per slot, one retired slot."""
    rng = np.random.default_rng(seed)
    W = (NB - 1) * BT
    seq = rng.integers(0, 3 * W, size=B).astype(np.int32)
    seq[0] = rng.integers(0, BT)                         # a young slot
    wb = ((np.maximum(0, seq + 1 - W) // BT) * BT).astype(np.int32)
    act = np.ones(B, np.int32)
    act[-1] = 0
    tbl = np.stack([rng.permutation(np.arange(1, P))[:NB]
                    for _ in range(B)]).astype(np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrs = dict(q=f(B, H, hd), pool_k=f(P, BT, KV, hd), pool_v=f(P, BT, KV, hd),
                cur_k=f(B, KV, hd), cur_v=f(B, KV, hd))
    j = {k: _pair(v, dtype)[0] for k, v in arrs.items()}
    t = {k: _pair(v, dtype)[1] for k, v in arrs.items()}
    for k, v in dict(block_table=tbl, window_base=wb, seq_lens=seq,
                     slot_active=act).items():
        j[k], t[k] = _pair(v)
    return j, t, W


DEC_ARGS = ("q", "pool_k", "pool_v", "block_table", "window_base", "seq_lens",
            "slot_active")
DEC_SHAPES = [dict(B=4, H=4, KV=2, hd=16, BT=8, NB=3, P=24),
              dict(B=3, H=10, KV=2, hd=32, BT=16, NB=5, P=20)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("shape", DEC_SHAPES, ids=["parity", "n_rep5"])
def test_decode_plain_matches_pallas_interpret(dtype, skip, shape):
    j, t, W = _decode_case(0, dtype=dtype, **shape)
    want, _ = paged_decode_attention_pallas(
        *[j[k] for k in DEC_ARGS], near_window=W, skip_extent=skip,
        interpret=True)
    got = pa.plain(*[t[k] for k in DEC_ARGS], near_window=W,
                   skip_extent=skip)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("shape", DEC_SHAPES, ids=["parity", "n_rep5"])
def test_decode_with_current_token_matches_ref(dtype, skip, shape):
    j, t, W = _decode_case(1, dtype=dtype, **shape)
    want, _ = jref.paged_decode_attention_ref(
        *[j[k] for k in DEC_ARGS], near_window=W, cur_k=j["cur_k"],
        cur_v=j["cur_v"], skip_extent=skip)
    # the kernel wrapper on CPU tensors takes the plain version
    got = pa.paged_decode_attention(
        *[t[k] for k in DEC_ARGS], near_window=W, cur_k=t["cur_k"],
        cur_v=t["cur_v"], skip_extent=skip)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert not _f32(got)[-1].any()                       # retired slot -> 0


def _chunk_case(seed, *, B, C, H, KV, hd, BT, NB, P, dtype):
    rng = np.random.default_rng(seed)
    W = (NB - 1) * BT
    start = rng.integers(0, 3 * W, size=B).astype(np.int32)
    start[0] = 0
    wb = ((np.maximum(0, start + 1 - W) // BT) * BT).astype(np.int32)
    nv = rng.integers(1, C + 1, size=B).astype(np.int32)
    nv[-1] = 0                                           # idle slot row
    tbl = np.stack([rng.permutation(np.arange(1, P))[:NB]
                    for _ in range(B)]).astype(np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrs = dict(q=f(B, C, H, hd), pool_k=f(P, BT, KV, hd),
                pool_v=f(P, BT, KV, hd), cur_k=f(B, C, KV, hd),
                cur_v=f(B, C, KV, hd))
    j = {k: _pair(v, dtype)[0] for k, v in arrs.items()}
    t = {k: _pair(v, dtype)[1] for k, v in arrs.items()}
    for k, v in dict(block_table=tbl, window_base=wb, start_pos=start,
                     n_valid=nv).items():
        j[k], t[k] = _pair(v)
    return j, t, W


CHUNK_ARGS = ("q", "pool_k", "pool_v", "cur_k", "cur_v", "block_table",
              "window_base", "start_pos", "n_valid")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [True, False])
def test_chunk_plain_matches_pallas_interpret(dtype, skip):
    shape = dict(B=3, C=8, H=4, KV=2, hd=16, BT=8, NB=3, P=24)
    j, t, W = _chunk_case(2, dtype=dtype, **shape)
    got = pfa.chunked_prefill_attention(*[t[k] for k in CHUNK_ARGS],
                                        near_window=W, skip_extent=skip)
    for b in range(shape["B"]):
        want = chunked_prefill_attention_pallas(
            j["q"][b], j["pool_k"], j["pool_v"], j["cur_k"][b], j["cur_v"][b],
            j["block_table"][b], j["window_base"][b], j["start_pos"][b],
            j["n_valid"][b], near_window=W, skip_extent=skip, interpret=True)
        np.testing.assert_allclose(_f32(got[b]), _f32(want), atol=TOL[dtype],
                                   rtol=TOL[dtype])
    assert not _f32(got[-1]).any()                       # n_valid = 0 -> 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_single_slot_signature_matches_ref(dtype):
    shape = dict(B=2, C=16, H=10, KV=2, hd=32, BT=16, NB=3, P=12)
    j, t, W = _chunk_case(3, dtype=dtype, **shape)
    for b in range(shape["B"]):
        sl = lambda d, k: d[k][b] if k not in ("pool_k", "pool_v") else d[k]
        want = jref.chunked_prefill_attention_ref(
            *[sl(j, k) for k in CHUNK_ARGS], near_window=W, skip_extent=True)
        got = tref.chunked_prefill_attention_ref(
            *[sl(t, k) for k in CHUNK_ARGS], near_window=W, skip_extent=True)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype],
                                   rtol=TOL[dtype])


def test_extents_match_reference_exactly():
    rng = np.random.default_rng(4)
    for W, nb, bt in [(16, 3, 8), (512, 33, 16), (40, 6, 8)]:
        t = rng.integers(0, 4 * W, size=64).astype(np.int32)
        wb = ((np.maximum(0, t + 1 - W) // bt) * bt).astype(np.int32)
        wb[::7] = np.maximum(0, wb[::7] - bt)            # stale bases too
        act = (rng.random(64) > 0.2).astype(np.int32)
        jl, jh = jref.active_block_extent(jnp.asarray(wb), jnp.asarray(t),
                                          jnp.asarray(act), near_window=W,
                                          nb=nb, bt=bt)
        tl, th = tref.active_block_extent(torch.from_numpy(wb),
                                          torch.from_numpy(t),
                                          torch.from_numpy(act),
                                          near_window=W, nb=nb, bt=bt)
        nl, nh = np_extents(wb, t, act, near_window=W, nb=nb, bt=bt)
        for a, b, c in ((jl, tl, nl), (jh, th, nh)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
            np.testing.assert_array_equal(np.asarray(a), c)
            assert b.dtype == torch.int32
        jl, jh = jref.chunk_block_extent(jnp.asarray(wb), jnp.asarray(t),
                                         near_window=W, nb=nb, bt=bt)
        tl, th = tref.chunk_block_extent(torch.from_numpy(wb),
                                         torch.from_numpy(t),
                                         near_window=W, nb=nb, bt=bt)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())


def test_pool_writes_match_reference_exactly():
    rng = np.random.default_rng(5)
    L, P, BT, KV, hd, B, C = 2, 10, 4, 2, 8, 3, 5
    pool = rng.standard_normal((L, P, BT, KV, hd)).astype(np.float32)
    jp, tp = _pair(pool, "bfloat16")
    vals = rng.standard_normal((L, B, KV, hd)).astype(np.float32)
    blk = np.array([3, 5, 7], np.int32)
    off = np.array([0, 2, 3], np.int32)
    act = np.array([1, 0, 1], np.int32)
    want = jref.pool_write_stacked_ref(jp, _pair(vals, "bfloat16")[0],
                                       jnp.asarray(blk), jnp.asarray(off),
                                       jnp.asarray(act))
    got = tref.pool_write_stacked_ref(tp.clone(), _pair(vals, "bfloat16")[1],
                                      torch.from_numpy(blk),
                                      torch.from_numpy(off),
                                      torch.from_numpy(act))
    np.testing.assert_array_equal(_f32(got), _f32(want))

    cvals = rng.standard_normal((L, B, C, KV, hd)).astype(np.float32)
    wblk = rng.integers(1, P, size=(B, C)).astype(np.int32)
    woff = np.tile(np.arange(C, dtype=np.int32) % BT, (B, 1))
    wblk[0] = 2                                           # no duplicate targets
    wblk[1] = 4
    wblk[2] = 6
    wblk[:, 4] += 1
    nv = np.array([5, 2, 0], np.int32)
    want = jref.pool_write_chunk_ref(jp, _pair(cvals, "bfloat16")[0],
                                     jnp.asarray(wblk), jnp.asarray(woff),
                                     jnp.asarray(nv))
    got = tref.pool_write_chunk_ref(tp.clone(), _pair(cvals, "bfloat16")[1],
                                    torch.from_numpy(wblk),
                                    torch.from_numpy(woff),
                                    torch.from_numpy(nv))
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_ops_dispatch_plain_and_kernel_agree_on_cpu():
    """On CPU tensors the kernel wrapper takes the plain version, so both
    impls agree bitwise; the impl switch takes only its two values."""
    j, t, W = _decode_case(6, dtype="bfloat16", **DEC_SHAPES[0])
    kw = dict(near_window=W, cur_k=t["cur_k"], cur_v=t["cur_v"],
              skip_extent=True)
    a = ops.paged_decode_attention(*[t[k] for k in DEC_ARGS], impl="kernel",
                                   **kw)
    b = ops.paged_decode_attention(*[t[k] for k in DEC_ARGS], impl="plain",
                                   **kw)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        ops.set_default_impl("jnp")
    assert ops.get_default_impl() == "kernel"


@pytest.mark.parametrize("case", ["dtype", "cur_shape", "table_dtype",
                                  "noncontig", "heads"])
def test_kernel_wrappers_reject_operands_the_kernels_do_not_take(case):
    """The operand checks the CUDA wrappers run before a launch (exercised
    here on CPU tensors; on the card the same checks guard the pointers)."""
    j, t, W = _decode_case(7, dtype="bfloat16", **DEC_SHAPES[0])
    d = {k: t[k] for k in DEC_ARGS + ("cur_k", "cur_v")}
    jc, tc, _ = _chunk_case(8, dtype="bfloat16", B=2, C=8, H=4, KV=2, hd=16,
                            BT=8, NB=3, P=24)
    c = {k: tc[k] for k in CHUNK_ARGS}
    if case == "dtype":
        d["q"], c["q"] = d["q"].half(), c["q"].half()
    elif case == "cur_shape":
        d["cur_k"], c["cur_k"] = d["cur_k"][:, :1], c["cur_k"][:, :4]
    elif case == "table_dtype":
        d["block_table"] = d["block_table"].long()
        c["block_table"] = c["block_table"].long()
    elif case == "noncontig":
        d["pool_k"] = d["pool_k"].transpose(1, 2).contiguous().transpose(1, 2)
        c["pool_k"] = c["pool_k"].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "heads":
        d["q"], c["q"] = d["q"][:, :3].contiguous(), c["q"][:, :, :3].contiguous()
    with pytest.raises((TypeError, ValueError)):
        pa._check(*[d[k] for k in DEC_ARGS + ("cur_k", "cur_v")])
    with pytest.raises((TypeError, ValueError)):
        pfa._check(*[c[k] for k in CHUNK_ARGS])
    # the untouched operands pass
    pa._check(*[t[k] for k in DEC_ARGS + ("cur_k", "cur_v")])
    pfa._check(*[tc[k] for k in CHUNK_ARGS])


# ---------------------------------------------------------------------------
# far view (mode="full"): chunk summarization and far-view decode attention
# ---------------------------------------------------------------------------

from repro.kernels.farview_summarize import farview_summarize_pallas  # noqa: E402
from repro_torch.kernels import farview_summarize as fvs  # noqa: E402


def _bf16_ulp(mag):
    return np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30)))
                                     - 7), 0.0)


def _summarize_case(seed, payload, dtype):
    """The reference test's geometry (P 12, BT 8, B 3, CB 2): a full chunk,
    a partial one (12 of 16 rows) and a gated-off slot."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((12, 8) + payload).astype(np.float32)
    jp, tp = _pair(pool, dtype)
    j, t = {"pool": jp}, {"pool": tp}
    for k, v in dict(chunk_blocks=np.array([[1, 2], [3, 4], [5, 6]], np.int32),
                     n_tokens=np.array([16, 12, 16], np.int32),
                     do_summarize=np.array([1, 1, 0], np.int32)).items():
        j[k], t[k] = _pair(v)
    return j, t


SUM_ARGS = ("pool", "chunk_blocks", "n_tokens", "do_summarize")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("payload", [(4, 16), (64,), (2, 8, 4)],
                         ids=["4x16", "64", "2x8x4"])
def test_farview_summarize_plain_matches_ref_and_pallas(dtype, payload):
    """f32: within 1e-6 (summation order only); bf16: within one bf16 ulp
    of the value (an f32 sum in another order can round to the neighbour)."""
    j, t = _summarize_case(9, payload, dtype)
    meta = [t[k] for k in SUM_ARGS[1:]]
    got, got_v = fvs.farview_summarize(t["pool"], t["pool"] * 2, *meta)
    assert got.dtype == TDT[dtype] and got.shape == (3,) + payload
    for want in (jref.farview_summarize_ref(*[j[k] for k in SUM_ARGS]),
                 farview_summarize_pallas(*[j[k] for k in SUM_ARGS],
                                          interpret=True)):
        g, w = _f32(got), _f32(want)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        else:
            diff = np.abs(g - w)
            assert (diff <= _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))).all()
    assert not _f32(got)[2].any()                         # gated off -> 0
    assert torch.equal(got_v, fvs.plain(t["pool"] * 2, *meta))


def _far_case(seed, *, B, KV, hd, MAXC, CAP, dtype):
    """Far pools and a far table with distinct entries per slot; slot 1
    has every entry invalid, slot 2 some."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    tbl = np.stack([rng.permutation(MAXC)[:CAP] for _ in range(B)]).astype(
        np.int32)
    val = np.ones((B, CAP), np.int32)
    val[1] = 0
    val[2, ::2] = 0
    j, t = {}, {}
    for k, v in dict(far_k=f(B, MAXC, KV, hd), far_v=f(B, MAXC, KV, hd)).items():
        j[k], t[k] = _pair(v, dtype)
    for k, v in dict(far_table=tbl, far_valid=val).items():
        j[k], t[k] = _pair(v)
    return j, t


FAR_ARGS = ("far_k", "far_v", "far_table", "far_valid")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("shape", DEC_SHAPES, ids=["parity", "n_rep5"])
def test_decode_with_far_view_matches_ref(dtype, skip, shape):
    """out and far_util against ``ref.paged_decode_attention_ref`` with the
    current token and the far view: 1e-5 in f32 (summation order only),
    the bf16 tolerance above in bf16."""
    j, t, W = _decode_case(10, dtype=dtype, **shape)
    jf, tf = _far_case(11, B=shape["B"], KV=shape["KV"], hd=shape["hd"],
                       MAXC=7, CAP=5, dtype=dtype)
    want, want_u = jref.paged_decode_attention_ref(
        *[j[k] for k in DEC_ARGS], near_window=W, cur_k=j["cur_k"],
        cur_v=j["cur_v"], skip_extent=skip, **{k: jf[k] for k in FAR_ARGS})
    got, got_u = pa.paged_decode_attention(
        *[t[k] for k in DEC_ARGS], near_window=W, cur_k=t["cur_k"],
        cur_v=t["cur_v"], skip_extent=skip, **{k: tf[k] for k in FAR_ARGS})
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    assert got.dtype == TDT[dtype] and got_u.dtype == torch.float32
    assert got_u.shape == (shape["B"], 5)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got_u), _f32(want_u), atol=tol, rtol=tol)
    u = _f32(got_u)
    assert not u[1].any() and not u[2, ::2].any()        # masked entries
    assert not u[-1].any() and not _f32(got)[-1].any()   # retired slot
    assert u[0].sum() > 0
    # all far entries masked: the output without the far view (bitwise in
    # the kernel, checked on the card; here within summation order)
    tf["far_valid"] = torch.zeros_like(tf["far_valid"])
    none, u0 = pa.paged_decode_attention(
        *[t[k] for k in DEC_ARGS], near_window=W, cur_k=t["cur_k"],
        cur_v=t["cur_v"], skip_extent=skip, **{k: tf[k] for k in FAR_ARGS})
    base = pa.paged_decode_attention(
        *[t[k] for k in DEC_ARGS], near_window=W, cur_k=t["cur_k"],
        cur_v=t["cur_v"], skip_extent=skip)
    np.testing.assert_allclose(_f32(none), _f32(base), atol=tol, rtol=tol)
    assert not u0.any()


@pytest.mark.parametrize("case", ["missing", "table_dtype", "far_shape",
                                  "valid_shape"])
def test_far_operands_the_kernels_do_not_take_are_rejected(case):
    j, t, W = _decode_case(12, dtype="bfloat16", **DEC_SHAPES[0])
    jf, tf = _far_case(13, B=4, KV=2, hd=16, MAXC=6, CAP=3, dtype="bfloat16")
    d = [t[k] for k in DEC_ARGS + ("cur_k", "cur_v")]
    far = {k: tf[k] for k in FAR_ARGS}
    pa._check(*d, **far)                                  # as built: fine
    if case == "missing":
        far["far_v"] = None
    elif case == "table_dtype":
        far["far_table"] = far["far_table"].long()
    elif case == "far_shape":
        far["far_k"] = far["far_k"][:, :, :1].contiguous()
    elif case == "valid_shape":
        far["far_valid"] = far["far_valid"][:, :2].contiguous()
    with pytest.raises((TypeError, ValueError)):
        pa._check(*d, **far)
    j, t = _summarize_case(14, (4, 16), "bfloat16")
    s = [t[k] for k in SUM_ARGS]
    fvs._check(s[0], s[0], *s[1:])
    with pytest.raises((TypeError, ValueError)):
        fvs._check(s[0], s[0].float(), *s[1:])
    with pytest.raises((TypeError, ValueError)):
        fvs._check(s[0], s[0], s[1].long(), *s[2:])


def test_ops_dispatch_far_view_plain_and_kernel_agree_on_cpu():
    j, t, W = _decode_case(15, dtype="bfloat16", **DEC_SHAPES[0])
    jf, tf = _far_case(16, B=4, KV=2, hd=16, MAXC=6, CAP=3, dtype="bfloat16")
    kw = dict(near_window=W, cur_k=t["cur_k"], cur_v=t["cur_v"],
              skip_extent=True, **{k: tf[k] for k in FAR_ARGS})
    a, au = ops.paged_decode_attention(*[t[k] for k in DEC_ARGS],
                                       impl="kernel", **kw)
    b, bu = ops.paged_decode_attention(*[t[k] for k in DEC_ARGS],
                                       impl="plain", **kw)
    assert torch.equal(a, b) and torch.equal(au, bu)
    j, t = _summarize_case(17, (2, 8, 4), "bfloat16")
    s = [t[k] for k in SUM_ARGS]
    ka, kb = ops.farview_summarize(s[0], -s[0], *s[1:], impl="kernel")
    pa_, pb = ops.farview_summarize(s[0], -s[0], *s[1:], impl="plain")
    assert torch.equal(ka, pa_) and torch.equal(kb, pb)


# ---------------------------------------------------------------------------
# dense prefill attention (the encoder's; `_prefill_kernel`)
# ---------------------------------------------------------------------------

from repro.kernels.prefill_attention import prefill_attention_pallas  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402


def _dense_case(seed, *, B, S, H, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrs = dict(q=f(B, S, H, hd), k=f(B, S, KV, hd), v=f(B, S, KV, hd))
    return ({k: _pair(v, dtype)[0] for k, v in arrs.items()},
            {k: _pair(v, dtype)[1] for k, v in arrs.items()})


# (causal, window): the encoder's non-causal case, causal, and causal and
# non-causal with a sliding window
MASKS = [(False, None), (True, None), (True, 5), (False, 7)]
MASK_IDS = ["full", "causal", "causal-w5", "w7"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_prefill_plain_matches_pallas_interpret_and_ref(dtype, n_rep, mask):
    """S a multiple of the Pallas block (48 = 3 x 16, so the TPU kernel
    walks a 3 x 3 grid of tiles). Against the Pallas kernel, which keeps
    f32 scores: f32 within 1e-5, bf16 within the bf16 tolerance above
    (the plain version rounds scores and p to bf16). Against
    ``ref.prefill_attention_ref`` (``attention_dense``, the same roundings):
    f32 within 1e-5, bf16 within one bf16 ulp of the value."""
    causal, window = mask
    j, t = _dense_case(20 + n_rep, B=2, S=48, H=4, KV=4 // n_rep, hd=16,
                       dtype=dtype)
    got = ops.prefill_attention(t["q"], t["k"], t["v"], causal=causal,
                                window=window)
    assert got.shape == (2, 48, 4, 16) and got.dtype == TDT[dtype]
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    want = prefill_attention_pallas(j["q"], j["k"], j["v"], causal=causal,
                                    window=window, q_blk=16, k_blk=16,
                                    interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    want = jref.prefill_attention_ref(j["q"], j["k"], j["v"], causal=causal,
                                      window=window)
    g, w = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    else:
        assert (np.abs(g - w) <= _bf16_ulp(np.maximum(np.abs(g),
                                                      np.abs(w)))).all()
    assert torch.equal(got, tref.prefill_attention_ref(
        t["q"], t["k"], t["v"], causal=causal, window=window))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 13, 37])
def test_prefill_plain_ragged_lengths_match_ref(dtype, S):
    """Encoder lengths are arbitrary (the Pallas wrapper asserts S % blk ==
    0; the CUDA kernel and its plain version take any S >= 1)."""
    for causal, window in MASKS:
        j, t = _dense_case(S, B=1, S=S, H=6, KV=3, hd=16, dtype=dtype)
        got = ops.prefill_attention(t["q"], t["k"], t["v"], causal=causal,
                                    window=window, impl="plain")
        want = jref.prefill_attention_ref(j["q"], j["k"], j["v"],
                                          causal=causal, window=window)
        g, w = _f32(got), _f32(want)
        assert np.isfinite(g).all()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        else:
            assert (np.abs(g - w) <= _bf16_ulp(np.maximum(np.abs(g),
                                                          np.abs(w)))).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", MASKS[:3], ids=MASK_IDS[:3])
def test_attention_blocked_matches_reference(dtype, mask):
    """The blocked online-softmax form (``gqa_full`` above S 1024) at small
    blocks, against the reference's ``attention_blocked``: f32 within 1e-5,
    bf16 within the bf16 tolerance (sums in another order round p to bf16
    apart). A length that is not a multiple of the block falls back to
    ``attention_dense`` on both sides."""
    causal, window = mask
    j, t = _dense_case(30, B=2, S=32, H=4, KV=2, hd=16, dtype=dtype)
    kw = dict(causal=causal, window=window, q_block=8, kv_block=16)
    got = tcm.attention_blocked(t["q"], t["k"], t["v"], **kw)
    want = jcm.attention_blocked(j["q"], j["k"], j["v"], **kw)
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    kw["q_block"] = 12                                   # 32 % 12 != 0
    assert torch.equal(tcm.attention_blocked(t["q"], t["k"], t["v"], **kw),
                       tcm.attention_dense(t["q"], t["k"], t["v"],
                                           causal=causal, window=window))


def test_prefill_wrapper_rejects_what_the_kernel_does_not_take():
    j, t = _dense_case(40, B=1, S=8, H=4, KV=2, hd=16, dtype="bfloat16")
    q, k, v = t["q"], t["k"], t["v"]
    pfa._check_dense(q, k, v)                              # as built: fine
    for bad in ((q.half(), k, v), (q, k.float(), v),
                (q, k[:, :4].contiguous(), v),
                (q[:, :, :3].contiguous(), k, v),
                (q.transpose(1, 2).contiguous().transpose(1, 2), k, v),
                (q, k[..., :8].contiguous(), v[..., :8].contiguous())):
        with pytest.raises((TypeError, ValueError)):
            pfa._check_dense(*bad)
    for impl in ("kernel", "plain"):
        with pytest.raises(ValueError, match="window"):
            ops.prefill_attention(q, k, v, window=0, impl=impl)
    # on CPU tensors the kernel wrapper takes the plain version: bitwise
    a = ops.prefill_attention(q, k, v, causal=True, window=3, impl="kernel")
    b = ops.prefill_attention(q, k, v, causal=True, window=3, impl="plain")
    assert torch.equal(a, b)
