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
