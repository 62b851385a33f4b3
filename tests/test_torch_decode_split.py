"""The split-KV decode kernel's host side, as far as the CPU reaches it.

The kernels (``csrc/paged_decode.cu``: ``paged_decode_split_kernel`` and
``paged_decode_combine_kernel``, bf16 q in the engine form without the far
view) run only on the card, where ``chip_smoke.py --phases build,kernels``
holds them against the plain version. Here, with torch and the port only:

* ``split_count``: the splits come from the shapes and the SM count alone
  (no length enters), leave no split empty, and give at least two CTAs per
  SM of an H100 (132 SMs) at the main path's decode shape;
* the plain model of the two kernels (``split_partials`` then
  ``combine_plain``: per-split f32 partials folded in order, the current
  token last) against the plain version ``ref.paged_decode_attention_ref``
  with bf16, fp8_e4m3 and int8 pools, splits left empty by the extent,
  retired slots and ``seq_lens`` 0. f32 within 1e-5 (summation order);
  bf16 within 2e-2, chip_smoke's ``TOL`` (the plain version rounds p to
  bf16 for a bf16 pool; both round the output to bf16). Skip on == off
  bitwise;
* the wrapper's rules: a bf16 hd the kernel is not built for raises.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

H100_SMS = 132
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
POOLS = (None, torch.float8_e4m3fn, torch.int8)
# (B, KV, n_rep, hd, BT, NB): qwen2.5-32b's head layout at a short window,
# seamless-m4t-medium's (n_rep 1, hd 64), a 32-token block size
SHAPES = {"qwen": (4, 2, 5, 32, 8, 9), "seamless": (3, 4, 1, 64, 16, 5),
          "bt32": (3, 2, 2, 16, 32, 4)}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (xdist workers share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, dtype, pool_dtype, *, B, KV, n_rep, hd, BT, NB):
    """One decode step: slot 0 at seq_lens 0, the last slot retired, a slot
    whose window ends early (later splits empty), window bases from the
    engine's rule, distinct physical blocks per slot."""
    rng = np.random.default_rng(seed)
    H, W, P = KV * n_rep, (NB - 1) * BT, B * NB + 1
    t = rng.integers(1, 3 * W, size=B)
    t[0], t[1] = 0, BT + 3
    wb = (np.maximum(0, t + 1 - W) // BT) * BT
    act = np.ones(B, np.int32)
    act[-1] = 0
    tbl = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    d = dict(q=f(B, H, hd).to(dtype), pool_k=f(P, BT, KV, hd),
             pool_v=f(P, BT, KV, hd),
             block_table=torch.from_numpy(tbl.astype(np.int32)),
             window_base=torch.from_numpy(wb.astype(np.int32)),
             seq_lens=torch.from_numpy(t.astype(np.int32)),
             slot_active=torch.from_numpy(act))
    kw = dict(near_window=W, cur_k=f(B, KV, hd).to(dtype),
              cur_v=f(B, KV, hd).to(dtype))
    if pool_dtype is None:
        d["pool_k"], d["pool_v"] = d["pool_k"].to(dtype), d["pool_v"].to(dtype)
    else:   # per-(block, kv head) absmax scales, as the quantized tier
        qmax = ref.quant_range(pool_dtype)
        for n in ("k", "v"):
            x = d["pool_" + n]
            sc = x.abs().amax(dim=(1, 3)) / qmax
            x = torch.clamp(x / sc[:, None, :, None], -qmax, qmax)
            x = torch.round(x) if pool_dtype == torch.int8 else x
            d["pool_" + n], kw[n + "_scale"] = x.to(pool_dtype), sc
    return [d[k] for k in ("q", "pool_k", "pool_v", "block_table",
                           "window_base", "seq_lens", "slot_active")], kw


def _model(args, kw, *, skip_extent, splits):
    part = {k: kw.get(k) for k in ("k_scale", "v_scale")}
    work = pa.split_partials(*args, near_window=kw["near_window"],
                             splits=splits, skip_extent=skip_extent, **part)
    return pa.combine_plain(work, args[0], kw["cur_k"], kw["cur_v"], args[6],
                            splits=splits)


@pytest.mark.parametrize("shape", [
    dict(B=8, KV=8, n_rep=5, NB=33, BT=16, hd=128),   # qwen2.5-32b, serve
    dict(B=8, KV=16, n_rep=1, NB=33, BT=16, hd=64),   # seamless-m4t-medium
    dict(B=4, KV=2, n_rep=2, NB=3, BT=8, hd=16),      # chip_smoke's parity
    dict(B=1, KV=8, n_rep=5, NB=65, BT=16, hd=128),   # one slot, W 1024
    dict(B=2, KV=2, n_rep=20, NB=9, BT=32, hd=256),   # two row groups
], ids=["qwen", "seamless", "parity", "one_slot", "nrep20"])
def test_split_count_from_shapes(shape):
    assert set(inspect.signature(pa.split_count).parameters) == {
        "B", "KV", "n_rep", "NB", "BT", "hd", "n_sm"}
    S, nbs = pa.split_count(n_sm=H100_SMS, **shape)
    NB = shape["NB"]
    assert 1 <= S <= NB and nbs == -(-NB // S)
    assert (S - 1) * nbs < NB <= S * nbs          # no split left empty
    ctas = shape["B"] * shape["KV"] * -(-shape["n_rep"] // pa.SPLIT_ROWS)
    if shape["B"] == 8 and shape["NB"] == 33:
        assert ctas * S >= 2 * H100_SMS, (S, ctas)  # two CTAs per SM
    assert S <= max(1, -(-NB * shape["BT"] // pa.SPLIT_KEYS))


@pytest.mark.parametrize("pool", POOLS, ids=["bf16", "fp8_e4m3", "int8"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_split_model_matches_plain(name, pool):
    B, KV, n_rep, hd, BT, NB = SHAPES[name]
    shp = dict(B=B, KV=KV, n_rep=n_rep, hd=hd, BT=BT, NB=NB)
    S, _ = pa.split_count(n_sm=H100_SMS, **shp)
    for dtype in (torch.float32, torch.bfloat16):
        args, kw = _case(3, dtype, pool, **shp)
        want = pa.plain(*args, skip_extent=True, **kw)
        for splits in sorted({1, S, NB}):
            got = _model(args, kw, skip_extent=True, splits=splits)
            assert got.dtype == dtype
            assert torch.allclose(got.float(), want.float(), **TOL[dtype]), \
                (name, pool, dtype, splits,
                 (got.float() - want.float()).abs().max().item())
            assert not got[-1].any()                 # the retired slot


@pytest.mark.parametrize("pool", POOLS, ids=["bf16", "fp8_e4m3", "int8"])
def test_split_model_skip_on_equals_off(pool):
    B, KV, n_rep, hd, BT, NB = SHAPES["qwen"]
    args, kw = _case(5, torch.bfloat16, pool, B=B, KV=KV, n_rep=n_rep, hd=hd,
                     BT=BT, NB=NB)
    S, _ = pa.split_count(B, KV, n_rep, NB, BT, hd, H100_SMS)
    on = _model(args, kw, skip_extent=True, splits=S)
    off = _model(args, kw, skip_extent=False, splits=S)
    assert torch.equal(on, off)


def test_combine_wrapper_on_cpu_is_its_plain_version():
    B, KV, n_rep, hd, BT, NB = SHAPES["seamless"]
    args, kw = _case(7, torch.bfloat16, None, B=B, KV=KV, n_rep=n_rep, hd=hd,
                     BT=BT, NB=NB)
    work = pa.split_partials(*args, near_window=kw["near_window"], splits=3)
    got = pa.paged_decode_combine(work, args[0], kw["cur_k"], kw["cur_v"],
                                  args[6], splits=3)
    want = pa.combine_plain(work, args[0], kw["cur_k"], kw["cur_v"], args[6],
                            splits=3)
    assert torch.equal(got, want)
    assert work.numel() == B * KV * n_rep * 3 * (hd + 2)


@pytest.mark.parametrize("hd", [8, 24, 100, 264, 512])
def test_split_rejects_head_size(hd):
    with pytest.raises(ValueError, match="multiple of 16"):
        pa.check_split_hd(hd)
    with pytest.raises(ValueError, match="multiple of 16"):
        pa.split_count(8, 8, 5, 33, 16, hd, H100_SMS)
